"""Flash attention forward (K1) and backward (K2): hand-written CUDA kernels
and their plain versions.

K1 replaces the Pallas TPU kernel ``paddle_tpu/pallas/flash_attention.py``
``_flash_fwd_pallas`` (:179, ``pl.pallas_call`` at :227, body ``_fwd_kernel``
:114), K2 ``_flash_bwd_pallas`` (:499: the combined kernel :446 and the
split kernels :515).  Both dtypes (:data:`DTYPES`) run the Hopper sources
``csrc/flash_attn_fwd_sm90.cu`` and ``csrc/flash_attn_bwd_sm90.cu``: TMA
copies into a ring of shared-memory stages with mbarriers, a producer
warpgroup and consumer warpgroups, bf16 ``wgmma`` with float32 sums, and
the FA2 backward in two passes (dK/dV, then dQ), no atomics.

- bf16 (AMP): S and dP are exact bf16 products; P and dS, float32 values,
  each go into the tensor cores as three bf16 terms (hi + mid + lo), which
  hold them exactly, so the kernels compute the float32 formula up to the
  order of the sums.
- float32: a split pass writes q, k, v (and do) as three bf16 term planes
  each into scratch the wrapper allocates, and every product is issued as
  the six bf16 term products of weight 2^-16 and above: float32-exact
  products on the tensor cores (up to ~2^-24 of the sum of the terms'
  magnitudes, below float32's rounding).

Each source's header says what bounds it on an H100.

- :func:`flash_attention_fwd` / :func:`flash_attention_bwd` are the
  wrappers over contiguous ``[bh, T, d]`` tensors of one dtype, float32 or
  bf16 (AMP), at any head dim d > 0 as the reference takes.  On the card
  the kernels run d up to :data:`MAX_HEAD_DIM` (128), a d that is not a
  multiple of 8 on zero-padded copies (exact: zero columns add nothing to
  q·kᵀ or p·v; ``sm_scale`` comes from the true d); above 128 they raise
  (their tiles' shared memory).  The kernels load that dtype and store o,
  dq, dk, dv in it, each rounded once from a float32 sum; lse and delta
  are float32.  A CUDA
  tensor launches the kernel's form for its dtype or raises; a CPU tensor
  takes the plain version.  Each counts its launches per dtype
  (:func:`launch_count`) under one name, ``flash_attn_fwd`` or
  ``flash_attn_bwd``; the float32 form's split pass is part of its
  launch.
- :func:`flash_attention_reference` is K1's plain version, the math of
  ``paddle_tpu``'s ``_flash_fwd_jax``: masked scores are ``NEG_INF``
  (-1e30), causal masking is end-aligned (``q + Tk - Tq >= k``), and a row
  whose scores are all ``-inf`` gives ``o = 0, lse = m`` (``l == 0`` is
  read as 1).
- :func:`flash_attention_bwd_reference` is K2's plain version, the math of
  ``_flash_bwd_jax`` (:641), which also gives the bias gradient.
- :func:`flash_attention` is the ``[b, h, T, d]`` entry the
  ``flash_attention`` op calls; it broadcasts the bias as the reference
  does, and differentiates through :class:`FlashAttention` (K1 forward, K2
  backward; with a bias, the plain backward, as the reference does).
- :func:`mha_reference` is the O(T^2) oracle of the reference.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._launches import LaunchCounts

NEG_INF = -1e30

#: query rows a consumer warpgroup of K1 and K2 takes, and keys a K/V tile
#: of their float32 form; the attention-ceiling tool takes its skeletons'
#: blocks from them
BLOCK_Q = BLOCK_K = 64

#: the operand dtypes the kernels take, and the (forward, backward)
#: libraries of ``kernels/_build.py`` that take each
DTYPES = {torch.float32: ("flash_attn_fwd_sm90", "flash_attn_bwd_sm90"),
          torch.bfloat16: ("flash_attn_fwd_sm90", "flash_attn_bwd_sm90")}

_LAUNCHES = LaunchCounts("flash_attn_fwd", "flash_attn_bwd")
_count = _LAUNCHES.count


def launch_count(kernel: str = "flash_attn_fwd",
                 dtype: Optional[str] = None) -> int:
    """Launches of ``kernel`` (``flash_attn_fwd`` or ``flash_attn_bwd``)
    on ``dtype`` operands ("float32" or "bfloat16"; None: both) since the
    last :func:`reset_launch_count`."""
    return _LAUNCHES.get(kernel, dtype)


def reset_launch_count() -> None:
    _LAUNCHES.reset()


def mha_reference(q, k, v, bias=None, causal=False, sm_scale=None):
    """O(T^2) reference attention over ``[b, h, T, d]`` (``paddle_tpu``'s
    ``mha_reference``, flash_attention.py:37-51)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool,
                          device=s.device).tril(tk - tq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_reference(q, k, v, bias=None, causal=False,
                              sm_scale=None) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Plain version of the kernel: ``(o [bh,Tq,d], lse [bh,Tq])``.

    The dense form of the online softmax: the running max starts at
    ``NEG_INF``, so ``m = max(NEG_INF, rowmax(s))``; ``sm_scale`` is folded
    into q, as the kernel does."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = torch.matmul(q.float() * sm_scale, k.float().transpose(1, 2))
    if bias is not None:
        s = s + bias.float()
    if causal:
        qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        ki = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(qi < ki, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.matmul(p, v.float()) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def _check(q, k, v, bias, what="flash_attention_fwd", rows=()):
    if q.dtype not in DTYPES:
        raise TypeError(f"{what}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(rows):
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, q {q.dtype}: "
                            "the operands must share one dtype")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"[bh, T, d] tensor")
        if t.device != q.device:
            raise ValueError(f"{what}: q, k, v on different devices")
    bh, tq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if d == 0 or tq == 0 or k.shape[1] == 0:
        raise ValueError(f"flash_attention_fwd: head dim {d} and T must be "
                         "positive")
    if bias is not None:
        tk = k.shape[1]
        if (bias.dtype != torch.float32 or not bias.is_contiguous()
                or bias.dim() != 3 or bias.shape[0] not in (1, bh)
                or tuple(bias.shape[1:]) != (tq, tk)
                or bias.device != q.device):
            raise ValueError(
                f"flash_attention_fwd: bias must be a contiguous float32 "
                f"[1|{bh}, {tq}, {tk}] tensor, got {tuple(bias.shape)} "
                f"{bias.dtype}")


def flash_attention_fwd(q, k, v, bias: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        sm_scale: Optional[float] = None):
    """``(o, lse)`` for contiguous ``q [bh,Tq,d]``, ``k/v [bh,Tk,d]`` (one
    dtype, float32 or bf16; o in it, lse float32) and an optional additive
    float32 ``bias [1|bh, Tq, Tk]``, at any head dim d > 0.  Launches the
    CUDA kernel on the current stream for CUDA tensors (d up to
    :data:`MAX_HEAD_DIM`; a d that is not a multiple of 8 runs on
    zero-padded copies, :func:`padded_head_dim`); CPU tensors take the
    plain version."""
    _check(q, k, v, bias)
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device "
                         f"{q.device}")
    dp = padded_head_dim("flash_attention_fwd", d)
    o, lse = _launch(*(pad_head_dim(x, dp) for x in (q, k, v)), bias,
                     bool(causal), float(sm_scale))
    return (o if dp == d else o[..., :d].contiguous()), lse


#: the largest head dim the kernels take on the card
MAX_HEAD_DIM = 128


def padded_head_dim(what, d):
    """The head dim the kernels run at for a true head dim ``d``: d rounded
    up to a multiple of 8.  The padding is exact: zero columns add nothing
    to q·kᵀ or to p·v, and the caller's ``sm_scale`` comes from the true d.
    Raises above :data:`MAX_HEAD_DIM`."""
    if d > MAX_HEAD_DIM:
        raise ValueError(
            f"{what}: head dim {d} is above {MAX_HEAD_DIM}, the largest the "
            "Hopper kernels take: their tiles hold whole head-dim rows of q, "
            "k and v in shared memory, and at d <= 128 they already take "
            "193-198 KB of the 227 KB a block may use")
    return -(-d // 8) * 8


def pad_head_dim(x, dp):
    """``x [..., d]`` zero-padded to ``dp`` columns (a new contiguous
    tensor, so it starts on 16 bytes as TMA needs), or ``x`` at d == dp."""
    d = x.shape[-1]
    return x if d == dp else torch.nn.functional.pad(x, (0, dp - d))


def _aligned(what, *tensors):
    """The bf16 kernels read q, k, v (and do) by TMA, which needs 16-byte
    aligned bases (float32 operands reach TMA through the term planes,
    scratch the wrapper allocates)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: bf16 operands must start on a 16-byte "
                         "boundary (the kernel reads them by TMA)")


def _planes(q, *others):
    """Scratch for the three bf16 term planes of each float32 operand
    (``q`` and each of ``others``), None for bf16 operands."""
    if q.dtype != torch.float32:
        return None
    n = sum(t.numel() for t in (q,) + others)
    return torch.empty(3 * n, dtype=torch.bfloat16, device=q.device)


def _launch(q, k, v, bias, causal, sm_scale):
    if q.dtype == torch.bfloat16:
        _aligned("flash_attention_fwd", q, k, v)
    fn = _entry(DTYPES[q.dtype][0])
    bh, tq, d = q.shape
    tk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    planes = _planes(q, k, v)
    bias_stride = 0
    if bias is not None and bias.shape[0] == bh and bh > 1:
        bias_stride = tq * tk
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 o.data_ptr(), lse.data_ptr(),
                 planes.data_ptr() if planes is not None else None,
                 bh, tq, tk, d, bias_stride, sm_scale, int(causal),
                 int(planes is not None), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed: CUDA "
                           f"error {err}")
    _count("flash_attn_fwd", q.dtype)
    return o, lse


_entry_fns = {}


def _entry(library):
    """The C entry point of ``library`` (a value of :data:`DTYPES`), which
    takes both dtypes (its ``f32`` argument says which)."""
    fn = _entry_fns.get(library)
    if fn is None:
        from . import _build
        fn = getattr(_build.load(library), f"paddle_tpu_torch_{library}")
        if library.startswith("flash_attn_fwd"):
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
                ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
                ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry_fns[library] = fn
    return fn


def sm90_shared_bytes(d: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The dynamic shared memory a block of each kernel takes at head dim
    ``d`` for ``dtype`` operands: ``{"fwd", "bwd_dkdv", "bwd_dq"}`` in
    bytes, as the sources lay it out (``ptxas -v`` reports static shared
    memory only).  Builds the libraries at first use."""
    from . import _build
    fwd = getattr(_build.load("flash_attn_fwd_sm90"),
                  "paddle_tpu_torch_flash_attn_fwd_sm90_smem")
    bwd = getattr(_build.load("flash_attn_bwd_sm90"),
                  "paddle_tpu_torch_flash_attn_bwd_sm90_smem")
    fwd.argtypes, bwd.argtypes = [ctypes.c_int] * 2, [ctypes.c_int] * 3
    fwd.restype = bwd.restype = ctypes.c_int
    f32 = int(dtype == torch.float32)
    return {"fwd": fwd(d, f32), "bwd_dkdv": bwd(d, 0, f32),
            "bwd_dq": bwd(d, 1, f32)}


# ---------------------------------------------------------------------------
# K2: the backward
# ---------------------------------------------------------------------------

def flash_attention_bwd_reference(q, k, v, o, lse, do, bias=None,
                                  causal=False, sm_scale=None, delta=None):
    """Plain version of the backward: ``(dq, dk, dv, dbias)``, the math of
    ``paddle_tpu``'s ``_flash_bwd_jax`` (flash_attention.py:641) in one
    dense pass.  P is rebuilt from the saved ``lse`` and is 0 wherever the
    score is ``<= NEG_INF / 2`` (masked), so a row with no live key gets
    zero gradients; ``delta = rowsum(do * o)`` in float32 (or the given
    ``delta``); ``sm_scale`` is folded into q.  ``dbias`` is ``[1|bh, Tq, Tk]`` like the bias (summed
    over bh for a shared plane), None without a bias."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    if delta is None:
        delta = torch.sum(do32 * o.float(), dim=-1)
    s = torch.matmul(q32 * sm_scale, k32.transpose(1, 2))
    if bias is not None:
        s = s + bias.float()
    if causal:
        qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        ki = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(qi < ki, NEG_INF)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - lse[..., None]))
    dv = torch.matmul(p.transpose(1, 2), do32)
    dp = torch.matmul(do32, v32.transpose(1, 2))
    ds = p * (dp - delta[..., None])
    dq = sm_scale * torch.matmul(ds, k32)
    dk = sm_scale * torch.matmul(ds.transpose(1, 2), q32)
    dbias = None
    if bias is not None:
        dbias = ds if bias.shape[0] == bh else ds.sum(dim=0, keepdim=True)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        delta: Optional[torch.Tensor] = None):
    """``(dq, dk, dv)`` for the contiguous ``q [bh,Tq,d]``, ``k/v
    [bh,Tk,d]``, the forward's ``o [bh,Tq,d]`` and float32 ``lse
    [bh,Tq]``, and the output gradient ``do [bh,Tq,d]`` (q, k, v, o and do
    of one dtype, float32 or bf16; the gradients in it, accumulated in
    float32 and rounded once), at any head dim d > 0.
    Launches the CUDA kernel on the current stream for CUDA tensors (d up
    to :data:`MAX_HEAD_DIM`, zero-padded to a multiple of 8 as the forward
    does); CPU tensors take the plain version.  (No bias: with one, the
    backward is the plain version on any device, as in the reference.)
    ``delta``, a contiguous float32 ``[bh, Tq]`` tensor, is ``rowsum(do *
    o)`` computed by the caller (ring attention computes it once for all
    its steps); the kernel then skips its own delta pass."""
    what = "flash_attention_bwd"
    _check(q, k, v, None, what, (("o", o), ("do", do)))
    bh, tq, d = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{what}: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if (lse.dtype != torch.float32 or not lse.is_contiguous()
            or tuple(lse.shape) != (bh, tq) or lse.device != q.device):
        raise ValueError(f"{what}: lse must be a contiguous float32 "
                         f"[{bh}, {tq}] tensor, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if delta is not None and (
            delta.dtype != torch.float32 or not delta.is_contiguous()
            or tuple(delta.shape) != (bh, tq) or delta.device != q.device):
        raise ValueError(f"{what}: delta must be a contiguous float32 "
                         f"[{bh}, {tq}] tensor, got {tuple(delta.shape)} "
                         f"{delta.dtype}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                             causal, sm_scale, delta)[:3]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    dp = padded_head_dim(what, d)
    grads = _launch_bwd(*(pad_head_dim(x, dp) for x in (q, k, v, o)), lse,
                        pad_head_dim(do, dp), causal, sm_scale, delta)
    return grads if dp == d else tuple(g[..., :d].contiguous()
                                       for g in grads)


def _launch_bwd(q, k, v, o, lse, do, causal, sm_scale, delta):
    what = "flash_attention_bwd"
    bh, tq, d = q.shape
    if q.dtype == torch.bfloat16:
        _aligned(what, q, k, v, do)
    fn = _entry(DTYPES[q.dtype][1])
    tk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    planes = _planes(q, k, v, do)
    delta_ready = delta is not None
    if not delta_ready:
        delta = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 planes.data_ptr() if planes is not None else None,
                 bh, tq, tk, d, float(sm_scale), int(bool(causal)),
                 int(delta_ready), int(planes is not None), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd kernel launch failed: CUDA "
                           f"error {err}")
    _count("flash_attn_bwd", q.dtype)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``o`` over ``[bh, T, d]``: K1 forward saving ``(q, k, v, o, lse)``,
    K2 backward.  With a bias the backward is the plain version on any
    device and also gives the bias gradient (the reference routes a bias
    to ``_flash_bwd_jax``, not to its kernel: flash_attention.py:754-760)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, bias, causal, sm_scale)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if bias is None:
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                             ctx.sm_scale)
            return dq, dk, dv, None, None, None
        dq, dk, dv, dbias = flash_attention_bwd_reference(
            q, k, v, o, lse, do, bias, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, dbias, None, None


def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None):
    """Fused attention over ``[b, h, T, d]`` (the reference's
    ``flash_attention``, flash_attention.py:782).  ``bias`` is ``[Tq,
    Tk]``, ``[1, 1, Tq, Tk]`` (kept as one plane) or ``[b|1, h|1, Tq, Tk]``
    (materialized to ``b*h`` planes)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    qc = q.reshape(b * h, tq, d).contiguous()
    kc = k.reshape(b * h, tk, d).contiguous()
    vc = v.reshape(b * h, tk, d).contiguous()
    bc = None
    if bias is not None:
        if bias.dim() == 2:
            bias = bias[None, None]
        if bias.shape[0] == 1 and bias.shape[1] == 1:
            bc = bias.reshape(1, tq, tk)
        else:
            bc = bias.expand(b, h, tq, tk).reshape(b * h, tq, tk)
        bc = bc.float().contiguous()
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    o = FlashAttention.apply(qc, kc, vc, bc, bool(causal), float(sm_scale))
    return o.reshape(b, h, tq, d)
