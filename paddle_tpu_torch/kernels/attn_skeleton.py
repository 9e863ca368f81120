"""Attention skeletons (K8): the flash-attention kernels' matrix products
with the softmax taken out; hand-written CUDA kernels and their plain
versions.

K8 replaces the Pallas TPU kernels of ``tools/attn_shape_ceiling.py``:
``_fwd_skeleton`` (:38, ``pl.pallas_call`` at :64) and ``_bwd_skeleton``
(:78, ``pl.pallas_call`` at :120).  Its source is ``paddle_tpu_torch/csrc/
attn_skeleton.cu``, whose header says what bounds it on an H100.  For
float32 ``q, k, v, do [bh, T, d]``:

    forward:  o = (q·kᵀ)·v                          (no scale, mask, softmax)
    backward: s = q·kᵀ, dp = do·vᵀ, ds = s * dp
              dq = ds·k
              dkp[b, i] = ds_iᵀ·q_i,  dvp[b, i] = s_iᵀ·do_i

with ``_i`` the i-th block of ``block_q`` query rows, so the partials are
``[bh, T / block_q, T, d]``, as the TPU's combined backward writes them.
The kernels keep the 64 x 64 tiles, thread layout and float32 CUDA-core
arithmetic of K1's and K2's first design, so "real kernel / skeleton"
measured that design's softmax and bookkeeping, not another GEMM; K1 and K2
now run their products on the tensor cores (float32 as bf16 term products),
which puts them below their skeletons.  ``block_q`` and ``block_k`` must be
multiples of 64 dividing T (the kernels' tiles are 64 rows; ``block_k``
changes no result and is checked for the interface's sake); d is at most
128.

- :func:`attn_skeleton_fwd` / :func:`attn_skeleton_bwd` are the wrappers.
  A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
  version.  Each counts its launches (:func:`launch_count`).
- :func:`attn_skeleton_fwd_plain` / :func:`attn_skeleton_bwd_plain` are
  the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from ._launches import LaunchCounts

#: rows of the kernels' tiles; block sizes are multiples of it
TILE = 64

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
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry("fwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), bh, t, d, stream)
    if err != 0:
        raise RuntimeError(f"attn_skeleton_fwd kernel launch failed: CUDA "
                           f"error {err}")
    _LAUNCHES.count("attn_skeleton_fwd", q.dtype)
    return o


def attn_skeleton_bwd(q, k, v, do, block_q=TILE, block_k=TILE):
    """``(dq [bh, T, d], dkp, dvp [bh, T / block_q, T, d])`` for contiguous
    float32 ``q, k, v, do [bh, T, d]``.  Launches K8's backward on the
    current stream for CUDA tensors; CPU tensors take the plain version."""
    _check("attn_skeleton_bwd", (("q", q), ("k", k), ("v", v), ("do", do)),
           block_q, block_k)
    if q.device.type == "cpu":
        return attn_skeleton_bwd_plain(q, k, v, do, block_q)
    bh, t, d = q.shape
    dq = torch.empty_like(q)
    dkp = torch.empty((bh, t // block_q, t, d), dtype=torch.float32,
                      device=q.device)
    dvp = torch.empty_like(dkp)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry("bwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), dq.data_ptr(), dkp.data_ptr(),
                            dvp.data_ptr(), bh, t, d, block_q, stream)
    if err != 0:
        raise RuntimeError(f"attn_skeleton_bwd kernel launch failed: CUDA "
                           f"error {err}")
    _LAUNCHES.count("attn_skeleton_bwd", q.dtype)
    return dq, dkp, dvp


_entry_fns = {}


def _entry(which):
    fn = _entry_fns.get(which)
    if fn is None:
        from . import _build
        lib = _build.load("attn_skeleton")
        if which == "fwd":
            fn = lib.paddle_tpu_torch_attn_skeleton_fwd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
        else:
            fn = lib.paddle_tpu_torch_attn_skeleton_bwd
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry_fns[which] = fn
    return fn
