"""Attention skeletons (K8): the float32 flash-attention kernels' matrix
products with the softmax taken out; hand-written CUDA kernels for Hopper
and their plain versions.

K8 replaces the Pallas TPU kernels of ``tools/attn_shape_ceiling.py``:
``_fwd_skeleton`` (:38, ``pl.pallas_call`` at :64) and ``_bwd_skeleton``
(:78, ``pl.pallas_call`` at :120).  Its source is ``paddle_tpu_torch/csrc/
attn_skeleton_sm90.cu``, whose header gives the design.  For float32
``q, k, v, do [bh, T, d]``:

    forward:  o = (q·kᵀ)·v                          (no scale, mask, softmax)
    backward: s = q·kᵀ, dp = do·vᵀ, ds = s * dp
              dq = ds·k
              dkp[b, i] = ds_iᵀ·q_i,  dvp[b, i] = s_iᵀ·do_i

with ``_i`` the i-th block of ``block_q`` query rows, so the partials are
``[bh, T / block_q, T, d]``, as the TPU's combined backward writes them.

A skeleton is K1's or K2's work less the softmax, in K1/K2's float32
arithmetic: a split pass writes each operand as three bf16 term planes
(part of the launch, as it is of K1's and K2's), TMA feeds them to a
producer warpgroup's ring of stages, and every float32 product is issued as
six bf16 ``wgmma`` term products in two chains from zero, joined by float32
adds.  The forward is K1's float32 design without the softmax; the
backward is the reference's combined kernel, one pass of five products a
(64-key, 64-query) tile pair, no atomics.  So operations at the rate of
float32-exact products on the tensor cores (989 / 6 TFLOP/s on an H100)
bound both, and "real kernel / skeleton" in ``tools/attn_shape_ceiling.py``
measures the softmax's share.

The contract: T a multiple of 64; ``block_q`` and ``block_k`` multiples of
64 dividing T (``block_q`` sets the backward's partials; the forward runs
its own 128-row tiles, and ``block_k`` changes no result: both are checked
for the interface's sake);
0 < d <= 128 (a d that is not a multiple of 8 runs on zero-padded copies,
exact: zero columns add nothing to any product); float32 only.

- :func:`attn_skeleton_fwd` / :func:`attn_skeleton_bwd` are the wrappers.
  A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
  version.  Each counts its launches (:func:`launch_count`).
- :func:`attn_skeleton_fwd_plain` / :func:`attn_skeleton_bwd_plain` are
  the plain versions.
- :func:`shared_bytes` is the dynamic shared memory a block of each kernel
  takes, as the source lays it out (no build needed).
"""

from __future__ import annotations

import ctypes

import torch

from . import flash_attention as fa
from ._launches import LaunchCounts

#: rows of the kernels' tiles; block sizes are multiples of it
TILE = 64
#: the shared memory a block may use on an H100 (227 KB)
MAX_SHARED_BYTES = 232448

_LAUNCHES = LaunchCounts("attn_skeleton_fwd", "attn_skeleton_bwd")


def launch_count(kernel: str = "attn_skeleton_fwd") -> int:
    """Launches of ``kernel`` (``attn_skeleton_fwd`` or
    ``attn_skeleton_bwd``) since the last :func:`reset_launch_count`."""
    return _LAUNCHES.get(kernel)


def reset_launch_count() -> None:
    _LAUNCHES.reset()


def attn_skeleton_fwd_plain(q, k, v):
    """Plain version of the forward skeleton: ``(q·kᵀ)·v``."""
    return torch.matmul(torch.matmul(q, k.transpose(1, 2)), v)


def attn_skeleton_bwd_plain(q, k, v, do, block_q):
    """Plain version of the backward skeleton: ``(dq, dkp, dvp)``."""
    bh, t, d = q.shape
    nq = t // block_q
    s = torch.matmul(q, k.transpose(1, 2))
    ds = s * torch.matmul(do, v.transpose(1, 2))
    dq = torch.matmul(ds, k)
    dkp = torch.matmul(ds.view(bh, nq, block_q, t).transpose(2, 3),
                       q.view(bh, nq, block_q, d))
    dvp = torch.matmul(s.view(bh, nq, block_q, t).transpose(2, 3),
                       do.view(bh, nq, block_q, d))
    return dq, dkp, dvp


def shared_bytes(d: int, block_q: int = TILE) -> dict:
    """The dynamic shared memory a block takes at head dim ``d`` (padded to
    64 or 128 in shared memory): ``{"fwd", "bwd"}`` in bytes, the backward
    for ``block_q`` (its layout for 64 and for larger blocks differ), as
    ``csrc/attn_skeleton_sm90.cu`` lays them out (``FwdLayout``,
    ``BwdLayout``; its ``paddle_tpu_torch_attn_skeleton_smem`` gives the
    same numbers on the card).  Each plane of a 64-row tile is 64 x D bf16;
    a float32 tile is three planes.  Barriers and the 1024-byte alignment
    add 1088 bytes."""
    big = 64 if d <= 64 else 128
    plane = TILE * big * 2
    tile = 3 * plane                      # a float32 64-row tile's planes
    slack = 64 + 1024
    # forward: q's planes of 128 rows, stages of K's and V's planes
    fwd_stages = 2 if big == 64 else 1
    fwd = 2 * tile + fwd_stages * 2 * tile + slack
    # backward: two resident tiles (q and do, or K and V), stages of two
    # tiles, and a 64 x 64 staging tile of dS's three planes a consumer
    staging = 3 * TILE * TILE * 2
    if block_q == TILE:
        consumers = 2 if big == 64 else 1
        stages = consumers
    else:
        consumers, stages = 1, (2 if big == 64 else 1)
    bwd = 2 * tile + stages * 2 * tile + consumers * staging + slack
    return {"fwd": fwd, "bwd": bwd}


def _check(what, tensors, block_q, block_k):
    q = tensors[0][1]
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"[bh, T, d] tensor")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} on {t.device}"
                             f" differs from q {tuple(q.shape)} on "
                             f"{q.device}")
    bh, t, d = q.shape
    if bh == 0 or not 0 < d <= 128:
        raise ValueError(f"{what}: need bh > 0 and 0 < d <= 128, got "
                         f"{tuple(q.shape)}")
    for name, b in (("block_q", block_q), ("block_k", block_k)):
        if b <= 0 or b % TILE or t % b:
            raise ValueError(f"{what}: {name}={b} must be a multiple of "
                             f"{TILE} dividing T={t}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {q.device}")


def attn_skeleton_fwd(q, k, v, block_q=TILE, block_k=TILE):
    """``o = (q·kᵀ)·v`` for contiguous float32 ``q, k, v [bh, T, d]``.
    Launches K8's forward on the current stream for CUDA tensors; CPU
    tensors take the plain version."""
    _check("attn_skeleton_fwd", (("q", q), ("k", k), ("v", v)), block_q,
           block_k)
    if q.device.type == "cpu":
        return attn_skeleton_fwd_plain(q, k, v)
    bh, t, d = q.shape
    dp = fa.padded_head_dim("attn_skeleton_fwd", d)
    q, k, v = (fa.pad_head_dim(x, dp) for x in (q, k, v))
    o = torch.empty_like(q)
    planes = torch.empty(3 * 3 * q.numel(), dtype=torch.bfloat16,
                         device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry("fwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), planes.data_ptr(), bh, t, dp,
                            stream)
    if err != 0:
        raise RuntimeError(f"attn_skeleton_fwd kernel launch failed: CUDA "
                           f"error {err}")
    _LAUNCHES.count("attn_skeleton_fwd", q.dtype)
    return o if dp == d else o[..., :d].contiguous()


def attn_skeleton_bwd(q, k, v, do, block_q=TILE, block_k=TILE):
    """``(dq [bh, T, d], dkp, dvp [bh, T / block_q, T, d])`` for contiguous
    float32 ``q, k, v, do [bh, T, d]``.  Launches K8's backward on the
    current stream for CUDA tensors; CPU tensors take the plain version."""
    _check("attn_skeleton_bwd", (("q", q), ("k", k), ("v", v), ("do", do)),
           block_q, block_k)
    if q.device.type == "cpu":
        return attn_skeleton_bwd_plain(q, k, v, do, block_q)
    bh, t, d = q.shape
    dp = fa.padded_head_dim("attn_skeleton_bwd", d)
    q, k, v, do = (fa.pad_head_dim(x, dp) for x in (q, k, v, do))
    dq = torch.empty_like(q)
    dkp = torch.empty((bh, t // block_q, t, dp), dtype=torch.float32,
                      device=q.device)
    dvp = torch.empty_like(dkp)
    planes = torch.empty(3 * 4 * q.numel(), dtype=torch.bfloat16,
                         device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry("bwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), dq.data_ptr(), dkp.data_ptr(),
                            dvp.data_ptr(), planes.data_ptr(), bh, t, dp,
                            block_q, stream)
    if err != 0:
        raise RuntimeError(f"attn_skeleton_bwd kernel launch failed: CUDA "
                           f"error {err}")
    _LAUNCHES.count("attn_skeleton_bwd", q.dtype)
    if dp != d:
        dq, dkp, dvp = (x[..., :d].contiguous() for x in (dq, dkp, dvp))
    return dq, dkp, dvp


_entry_fns = {}


def _entry(which):
    fn = _entry_fns.get(which)
    if fn is None:
        from . import _build
        lib = _build.load("attn_skeleton")
        if which == "fwd":
            fn = lib.paddle_tpu_torch_attn_skeleton_fwd
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
        else:
            fn = lib.paddle_tpu_torch_attn_skeleton_bwd
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry_fns[which] = fn
    return fn
