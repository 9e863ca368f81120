"""Ring attention (K7): exact attention over a sequence sharded on a mesh
axis, from the port's flash kernels and a CUDA merge kernel.

K7 replaces ``paddle_tpu/pallas/ring_attention.py`` ``_ring_fwd_impl``
(:70) and ``_ring_vjp_bwd`` (:101), which have no ``pallas_call`` of their
own: each ring step runs the flash forward (K1, via ``_chunk_fwd`` :35)
and folds its partial into the running one with ``_merge`` (:43).  Here
each step runs the port's K1 (:func:`~.flash_attention.flash_attention_fwd`)
and, backward, K2 (:func:`~.flash_attention.flash_attention_bwd`; the
reference runs the plain ``_flash_bwd_jax`` there, :115), and the merge is
the CUDA kernel ``paddle_tpu_torch/csrc/ring_attention.cu``.  CPU tensors
take the plain versions of all three.

The schedule is the reference's.  Rank ``my`` of ``n`` keeps its query
shard; at ring step ``s`` it holds the K/V shard of ``src = (my - s) % n``,
and the K/V shards move from rank i to rank (i + 1) % n between steps
(``perm``, :73, :83-84).  Backward, ``delta = rowsum(do * o)`` is computed
once (:109); float32 dq, dk and dv accumulators take each step's
gradients, and dk and dv travel the ring with their K/V shard, arriving
home after the n-th rotation (:118-126); the results are cast to the
input dtype (:134).  A rotation is ``tensor.to(next rank's device,
non_blocking=True)``: a peer copy between distinct cards, and no copy at all
where the mesh names one device more than once (virtual ranks, see
:mod:`paddle_tpu_torch.parallel.mesh`).  The ranks' steps are issued one
after another from this process.  Across processes (``span``, a
``distributed.xproc.ProcessSpan``: a mesh after ``init_parallel_env``) a
process runs its own ranks' steps only, and a rotation between ranks of two
processes is an ``isend`` / ``irecv`` pair over the process group, staged
through host memory (the reference's ``ppermute`` across hosts); K1, K2 and
the merge kernel still run at every ring step.

Causal attention (tq == tk): the reference adds a per-step bias
(``_causal_bias`` :57-61) that has three cases, which map onto the kernels'
``causal`` flag:

- ``src < my``: nothing masked (``causal=False``);
- ``src == my``: the top-left causal mask, which is K1's and K2's
  ``causal=True`` when tq == tk;
- ``src > my``: every score masked; the partial merges with weight 0 and
  its gradients are 0.

Two shortcuts, both exact (they give the values the reference's steps
give, not approximations of them):

1. the first partial of a rank is taken as its running (o, lse): the merge
   with the empty initial partial ``(0, NEG_INF)`` (:88-91) has weights 0
   and 1 and returns the partial unchanged;
2. causal ``src > my`` steps are skipped: the fully masked partial has
   ``lse <= NEG_INF / 2``, so the merge gives it weight 0 and returns the
   running partial unchanged, and its gradients are exactly 0.

Besides, the last rotation of the K/V shards (after the last step) is not
made: the reference's result of it is unused.  So a ring op launches, per
call, n² K1 forwards and n² K2 backwards and n(n - 1) merges without a
mask, and n(n + 1)/2 of each kernel and n(n - 1)/2 merges causal
(:func:`expected_launches`).

- :func:`ring_merge` / :func:`ring_merge_reference`: the merge kernel's
  wrapper (counted per dtype, :func:`launch_count`; ``out=`` takes the
  result, ``(o1, lse1)`` itself for an in-place merge) and its plain
  version.  The ring's kernel steps merge in place into each rank's
  running partial, so a merge allocates nothing; the plain ring returns
  new tensors.
- :func:`ring_attention_fwd` / :func:`ring_attention_bwd`: the ring over
  ``[bh, T, d]`` tensors and a list of rank devices of the tensors' device
  type (no hidden move to another device); with ``plain=True`` the same
  schedule runs through the plain versions (the ring's reference).  On
  the card a head dim that is not a multiple of 8 is zero-padded once per
  ring op, not once per step (K1/K2's rule, ``padded_head_dim``).
- :class:`RingAttention`: the ``autograd.Function``; :func:`ring_attention`
  the ``[b, h, T, d]`` entry over a mesh axis.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence

import torch

from . import flash_attention as fa
from ._launches import LaunchCounts

NEG_INF = fa.NEG_INF

#: the partials' dtypes the merge kernel takes, by their code in its entry
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LAUNCHES = LaunchCounts("ring_merge")
_count = _LAUNCHES.count


def launch_count(kernel: str = "ring_merge",
                 dtype: Optional[str] = None) -> int:
    """Launches of the merge kernel on ``dtype`` partials ("float32" or
    "bfloat16"; None: both) since the last :func:`reset_launch_count`."""
    return _LAUNCHES.get(kernel, dtype)


def reset_launch_count() -> None:
    _LAUNCHES.reset()


def expected_launches(n: int, causal: bool) -> Dict[str, int]:
    """Kernel launches of one ring forward + backward over ``n`` ranks."""
    if causal:
        steps, merges = n * (n + 1) // 2, n * (n - 1) // 2
    else:
        steps, merges = n * n, n * (n - 1)
    return {"flash_attn_fwd": steps, "flash_attn_bwd": steps,
            "ring_merge": merges}


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------

def ring_merge_reference(o1, lse1, o2, lse2):
    """Plain version of the merge: ``_merge`` (ring_attention.py:43-54)
    over ``o [bh, tq, d]`` (float32 or bf16) and float32 ``lse [bh, tq]``;
    each weight is cast to o's dtype before it multiplies."""
    half = NEG_INF / 2
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(m <= half, torch.zeros_like(m), m)
    w1 = torch.where(lse1 <= half, torch.zeros_like(lse1),
                     torch.exp(lse1 - m_safe))
    w2 = torch.where(lse2 <= half, torch.zeros_like(lse2),
                     torch.exp(lse2 - m_safe))
    den = w1 + w2
    den_safe = torch.where(den == 0.0, torch.ones_like(den), den)
    o = (o1 * (w1 / den_safe)[..., None].to(o1.dtype)
         + o2 * (w2 / den_safe)[..., None].to(o2.dtype))
    lse = torch.where(den == 0.0, torch.full_like(den, NEG_INF),
                      m_safe + torch.log(den_safe))
    return o, lse


def _check_merge(o1, lse1, o2, lse2):
    if o1.dtype not in DTYPES:
        raise TypeError(f"ring_merge: o must be float32 or bfloat16, got "
                        f"{o1.dtype}")
    if o1.dim() != 3 or o2.shape != o1.shape or o2.dtype != o1.dtype:
        raise ValueError(f"ring_merge: o1 {tuple(o1.shape)} {o1.dtype} and "
                         f"o2 {tuple(o2.shape)} {o2.dtype} must be one "
                         "[bh, tq, d] shape and dtype")
    for name, t in (("lse1", lse1), ("lse2", lse2)):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(o1.shape[:2]):
            raise ValueError(f"ring_merge: {name} must be float32 "
                             f"{tuple(o1.shape[:2])}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for name, t in (("o1", o1), ("lse1", lse1), ("o2", o2), ("lse2", lse2)):
        if not t.is_contiguous():
            raise ValueError(f"ring_merge: {name} must be contiguous")
        if t.device != o1.device:
            raise ValueError(f"ring_merge: {name} on {t.device}, o1 on "
                             f"{o1.device}")


def _overlaps(a, b) -> bool:
    """Whether the memory of ``a`` and ``b`` overlaps (both contiguous)."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def _check_out(out, o1, lse1, o2, lse2):
    """``out = (o, lse)`` takes the merge: o like o1 and lse like lse1,
    contiguous on o1's device; o may be o1 itself and lse lse1 (an
    in-place merge), and otherwise neither overlaps any input or the
    other."""
    o, lse = out
    for name, t, like in (("o", o, o1), ("lse", lse, lse1)):
        if (t.dtype != like.dtype or t.shape != like.shape
                or t.device != like.device or not t.is_contiguous()):
            raise ValueError(f"ring_merge: out {name} must be a contiguous "
                             f"{tuple(like.shape)} {like.dtype} tensor on "
                             f"{like.device}")
    if _overlaps(o, lse):
        raise ValueError("ring_merge: out o and lse overlap")
    for name, t, own in (("o", o, o1), ("lse", lse, lse1)):
        for other in (o1, lse1, o2, lse2):
            in_place = other is own and t.data_ptr() == own.data_ptr()
            if _overlaps(t, other) and not in_place:
                raise ValueError(f"ring_merge: out {name} may be "
                                 f"{'o1' if name == 'o' else 'lse1'} itself "
                                 "but must overlap no other input")


def ring_merge(o1, lse1, o2, lse2, out=None):
    """``(o, lse)``: the partials ``(o1, lse1)`` and ``(o2, lse2)`` merged
    by their logsumexps, into new tensors or into ``out``, an ``(o, lse)``
    pair (``(o1, lse1)`` itself merges in place; see :func:`_check_out`),
    which is returned.  Launches the merge kernel on the current stream
    for CUDA tensors; CPU tensors take the plain version, copied into
    ``out`` where given."""
    _check_merge(o1, lse1, o2, lse2)
    if out is not None and not (out[0] is o1 and out[1] is lse1):
        _check_out(out, o1, lse1, o2, lse2)
    if o1.device.type == "cpu":
        o, lse = ring_merge_reference(o1, lse1, o2, lse2)
        if out is None:
            return o, lse
        out[0].copy_(o)
        out[1].copy_(lse)
        return out
    if o1.device.type != "cuda":
        raise ValueError(f"ring_merge: no kernel for device {o1.device}")
    bh, tq, d = o1.shape
    o, lse = (torch.empty_like(o1), torch.empty_like(lse1)) if out is None \
        else out
    with torch.cuda.device(o1.device):
        stream = torch.cuda.current_stream(o1.device).cuda_stream
        err = _entry()(o1.data_ptr(), lse1.data_ptr(), o2.data_ptr(),
                       lse2.data_ptr(), o.data_ptr(), lse.data_ptr(),
                       bh * tq, d, DTYPES[o1.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ring_merge kernel launch failed: CUDA error "
                           f"{err}")
    _count("ring_merge", o1.dtype)
    return o, lse


_entry_fn = []


def _entry():
    if not _entry_fn:
        from . import _build
        fn = _build.load("ring_attention").paddle_tpu_torch_ring_merge
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry_fn.append(fn)
    return _entry_fn[0]


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def _rotate(shards: List[torch.Tensor], devices,
            span=None) -> List[torch.Tensor]:
    """Every shard one rank on: rank i's goes to rank (i + 1) % n (over a
    span of processes, this process's ranks' shards only)."""
    n = len(devices)
    if span is not None and span.multi:
        return span.rotate(shards, devices[span.local[0]])
    return [shards[(i - 1) % n].to(devices[i], non_blocking=True)
            for i in range(n)]


def _mine(span, my: int) -> bool:
    return span is None or span.is_local(my)


def _steps(n: int, causal: bool):
    """``(s, [(my, mask), ...])`` for every ring step ``s``: the ranks that
    run a kernel at that step and the kernels' ``causal`` flag for each
    (my, src) pair; causal ``src > my`` pairs are fully masked and left
    out."""
    for s in range(n):
        ranks = []
        for my in range(n):
            src = (my - s) % n
            if not (causal and src > my):
                ranks.append((my, causal and src == my))
        yield s, ranks


def _fwd_shards(qs, ks, vs, devices, causal, sm_scale, fwd, merge,
                span=None):
    n = len(devices)
    o_run: List[Optional[torch.Tensor]] = [None] * n
    lse_run: List[Optional[torch.Tensor]] = [None] * n
    kc, vc = list(ks), list(vs)
    for s, ranks in _steps(n, causal):
        if s:                                  # the ring moves on
            kc, vc = _rotate(kc, devices, span), _rotate(vc, devices, span)
        for my, mask in ranks:
            if not _mine(span, my):
                continue
            o_p, lse_p = fwd(qs[my], kc[my], vc[my], None, mask, sm_scale)
            if o_run[my] is None:              # merge with (0, NEG_INF)
                o_run[my], lse_run[my] = o_p, lse_p
            else:
                o_run[my], lse_run[my] = merge(o_run[my], lse_run[my], o_p,
                                               lse_p)
    return o_run, lse_run


def _bwd_shards(qs, ks, vs, os_, lses, dos, devices, causal, sm_scale, bwd,
                span=None):
    n = len(devices)
    # loop-invariant across ring steps (ring_attention.py:109)
    deltas = [None if do is None else torch.sum(do.float() * o.float(),
                                                 dim=-1)
              for do, o in zip(dos, os_)]
    dq, dk, dv = ([None if x is None else
                   torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                   for x in xs] for xs in (qs, ks, vs))
    kc, vc = list(ks), list(vs)
    for s, ranks in _steps(n, causal):
        if s:
            kc, vc = _rotate(kc, devices, span), _rotate(vc, devices, span)
        for my, mask in ranks:
            if not _mine(span, my):
                continue
            dq_p, dk_p, dv_p = bwd(qs[my], kc[my], vc[my], os_[my],
                                   lses[my], dos[my], mask, sm_scale,
                                   deltas[my])
            dq[my] += dq_p.float()
            dk[my] += dk_p.float()
            dv[my] += dv_p.float()
        # the dk/dv accumulators travel the ring with their K/V shard and
        # are home after the n-th rotation
        dk, dv = _rotate(dk, devices, span), _rotate(dv, devices, span)
    dtype = next(x for x in qs if x is not None).dtype
    return tuple([None if x is None else x.to(dtype) for x in g]
                 for g in (dq, dk, dv))


def _plain_bwd(q, k, v, o, lse, do, causal, sm_scale, delta):
    return fa.flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                            causal, sm_scale, delta)[:3]


def _merge_in_place(o_run, lse_run, o_p, lse_p):
    """The merge kernel writing into the running partial's own buffers: a
    rank's running partial is K1's output of its first step or the previous
    merge's, so the ring owns it, and no merge allocates."""
    return ring_merge(o_run, lse_run, o_p, lse_p, out=(o_run, lse_run))


def _step_fns(plain: bool):
    """The per-step (forward, backward, merge): the kernels (the merge in
    place), or with ``plain`` their plain versions (new tensors)."""
    if plain:
        return (fa.flash_attention_reference, _plain_bwd,
                ring_merge_reference)
    return fa.flash_attention_fwd, fa.flash_attention_bwd, _merge_in_place


def _shard(x: torch.Tensor, devices, span=None) -> List[torch.Tensor]:
    """``x [bh, T, ...]`` cut into len(devices) equal T shards, shard i on
    devices[i].  Over a span of processes ``x`` is this process's block
    (its ranks' shards, in rank order) and the others' entries are
    None."""
    n = len(devices)
    if span is not None and span.multi:
        t = x.shape[1] // len(span.local)
        out: List[Optional[torch.Tensor]] = [None] * n
        for j, r in enumerate(span.local):
            out[r] = x[:, j * t:(j + 1) * t].contiguous().to(
                devices[r], non_blocking=True)
        return out
    t = x.shape[1] // n
    return [x[:, i * t:(i + 1) * t].contiguous().to(devices[i],
                                                      non_blocking=True)
            for i in range(n)]


def _gather(shards: Sequence[torch.Tensor], device) -> torch.Tensor:
    return torch.cat([x.to(device) for x in shards if x is not None], dim=1)


def _check_ring(q, k, v, devices, span=None):
    n = len(devices) if span is None or not span.multi else len(span.local)
    if n < 1:
        raise ValueError("ring attention needs at least one rank")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be one "
                         "[bh, T, d] shape (self-attention)")
    if q.shape[1] % n:
        raise ValueError(f"ring attention: T = {q.shape[1]} is not "
                         f"divisible by the {n} ranks of the ring here")
    # no hidden move: CUDA tensors ring over cards, CPU tensors over CPUs
    others = sorted({torch.device(d).type for d in devices} - {q.device.type})
    if others:
        raise ValueError(f"ring attention: q is on {q.device} but the ring's "
                         f"ranks name {others} devices; the mesh must hold "
                         f"{q.device.type} devices only")


def _head_dim(q, plain):
    """The head dim the ring's steps run at: on the card the kernels'
    (:func:`~.flash_attention.padded_head_dim`: q, k, v, o and do are
    zero-padded once per ring op, not once per step), else q's own."""
    d = q.shape[-1]
    if plain or q.device.type == "cpu":
        return d
    return fa.padded_head_dim("ring attention", d)


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
        else float(sm_scale)


def ring_attention_fwd(q, k, v, devices, causal: bool = False,
                       sm_scale: Optional[float] = None,
                       plain: bool = False, span=None):
    """``(o [bh, T, d], lse [bh, T])`` of ring attention over ``q, k, v
    [bh, T, d]`` (one dtype, float32 or bf16), T sharded over the ranks
    ``devices`` (rank i holds shard i; a device may repeat, and every one
    is of q's device type).  K1 and the merge kernel on CUDA shards, their
    plain versions on CPU shards, or on any device with ``plain`` (the
    ring's plain version: the same schedule); the results are gathered on
    q's device.  Over a ``span`` of processes q, k, v and the results are
    this process's block of T (its ranks' shards, in rank order), and
    every process of the ring calls it."""
    _check_ring(q, k, v, devices, span)
    fwd, _, merge = _step_fns(plain)
    scale, d, dp = _scale(q, sm_scale), q.shape[-1], _head_dim(q, plain)
    os_, lses = _fwd_shards(*(_shard(fa.pad_head_dim(x, dp), devices, span)
                              for x in (q, k, v)), devices, bool(causal),
                            scale, fwd, merge, span)
    o = _gather(os_, q.device)
    return (o if dp == d else o[..., :d].contiguous()), \
        _gather(lses, q.device)


def ring_attention_bwd(q, k, v, o, lse, do, devices, causal: bool = False,
                       sm_scale: Optional[float] = None,
                       plain: bool = False, span=None):
    """``(dq, dk, dv)`` of ring attention, from the forward's ``o`` and
    ``lse`` and the output gradient ``do`` (K2 on CUDA shards; its plain
    version on CPU shards, or with ``plain``); over a ``span`` of
    processes every tensor is this process's block of T."""
    _check_ring(q, k, v, devices, span)
    _, bwd, _ = _step_fns(plain)
    scale, d, dp = _scale(q, sm_scale), q.shape[-1], _head_dim(q, plain)
    pad = [fa.pad_head_dim(x, dp) for x in (q, k, v, o)]
    dqs, dks, dvs = _bwd_shards(
        *(_shard(x, devices, span)
          for x in pad + [lse, fa.pad_head_dim(do, dp)]),
        devices, bool(causal), scale, bwd, span)
    grads = (_gather(dqs, q.device), _gather(dks, k.device),
             _gather(dvs, v.device))
    return grads if dp == d else tuple(g[..., :d].contiguous()
                                       for g in grads)


class RingAttention(torch.autograd.Function):
    """``o [bh, T, d]`` by the ring over ``devices``: the forward keeps
    (q, k, v, o, lse), as ``_ring_vjp_fwd`` does (:96-98), and the backward
    runs the ring backward on them (no forward recompute)."""

    @staticmethod
    def forward(ctx, q, k, v, devices, causal, sm_scale):
        o, lse = ring_attention_fwd(q, k, v, devices, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.devices, ctx.causal, ctx.sm_scale = devices, causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return ring_attention_bwd(q, k, v, o, lse, do.to(o.dtype),
                                  ctx.devices, ctx.causal,
                                  ctx.sm_scale) + (None, None, None)


def _block(x: torch.Tensor, span) -> torch.Tensor:
    """This process's block of T of a whole ``[bh, T, ...]`` tensor: its
    ranks' shards, which are consecutive on the ring."""
    t = x.shape[1] // span.n
    lo, hi = span.local[0], span.local[-1] + 1
    if span.local != list(range(lo, hi)):
        raise ValueError(f"ring attention: this process's ranks "
                         f"{span.local} are not consecutive on the ring")
    return x[:, lo * t:hi * t].contiguous()


def _join(blocks: Sequence[torch.Tensor], span) -> List[torch.Tensor]:
    """The whole tensor from every process's block (on this one's
    device): the blocks are exchanged and joined in rank order."""
    got = span.exchange({span.local[0]: list(blocks)}, blocks[0].device)
    firsts = sorted({span.procs.index(p) for p in set(span.procs)})
    return [torch.cat([got[r][j] for r in firsts], dim=1)
            for j in range(len(blocks))]


class RingAttentionAcross(torch.autograd.Function):
    """:class:`RingAttention` over a ring whose ranks span processes:
    every process holds the whole q, k, v, runs its own ranks' ring steps
    on its block of T, and the blocks of o (and backward, of dq, dk, dv)
    are exchanged so that each process gets them whole."""

    @staticmethod
    def forward(ctx, q, k, v, devices, causal, sm_scale, span):
        blocks = [_block(x, span) for x in (q, k, v)]
        o, lse = ring_attention_fwd(*blocks, devices, causal, sm_scale,
                                    span=span)
        ctx.save_for_backward(*blocks, o, lse)
        ctx.devices, ctx.causal, ctx.sm_scale = devices, causal, sm_scale
        ctx.span = span
        return _join([o], span)[0]

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = ring_attention_bwd(q, k, v, o, lse,
                                   _block(do.to(o.dtype), ctx.span),
                                   ctx.devices, ctx.causal, ctx.sm_scale,
                                   span=ctx.span)
        return tuple(_join(grads, ctx.span)) + (None,) * 4


def ring_attention(q, k, v, mesh, axis_name: str = "sp",
                   causal: bool = False, sm_scale: Optional[float] = None):
    """Ring attention over ``[b, h, T, d]`` (``paddle_tpu``'s
    ``ring_attention``, :140-155, with the ``shard_map`` of the op around
    it): T is cut into the ``axis_name`` axis's n equal shards, shard i
    on the axis's device i, the ring runs, and o is gathered on q's device.
    Raises when T is not divisible by n, and when the axis names a device
    of another type than q's (no hidden move).  The mesh's other axes hold
    replicas of this computation; the ring of their first position runs.
    On a mesh that spans processes each runs its own ranks' steps
    (:class:`RingAttentionAcross`)."""
    from ..distributed.xproc import span_of
    devices = tuple(mesh.axis_devices(axis_name))
    span = span_of(mesh, axis_name)
    b, h, t, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must share "
                         "one shape")
    qc, kc, vc = (x.reshape(b * h, t, d).contiguous() for x in (q, k, v))
    if span.multi:
        o = RingAttentionAcross.apply(qc, kc, vc, devices, bool(causal),
                                      _scale(q, sm_scale), span)
    else:
        o = RingAttention.apply(qc, kc, vc, devices, bool(causal),
                                _scale(q, sm_scale))
    return o.reshape(b, h, t, d)
