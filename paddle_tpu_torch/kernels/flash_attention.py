"""Flash attention forward (K1) and backward (K2): hand-written CUDA kernels
and their plain versions.

K1 replaces the Pallas TPU kernel ``paddle_tpu/pallas/flash_attention.py``
``_flash_fwd_pallas`` (:179, ``pl.pallas_call`` at :227, body ``_fwd_kernel``
:114); its source is ``paddle_tpu_torch/csrc/flash_attn_fwd.cu`` (float32 on
the CUDA cores, one block per (bh, 64-row q tile), causal tiles above the
diagonal skipped).  K2 replaces ``_flash_bwd_pallas`` (:499: the combined
kernel :446 and the split kernels :515); its source is
``csrc/flash_attn_bwd.cu`` (the FA2 backward in two passes, dK/dV then dQ,
no atomics).  Each source's header says what bounds it on an H100.

- :func:`flash_attention_fwd` / :func:`flash_attention_bwd` are the
  wrappers over contiguous float32 ``[bh, T, d]`` tensors.  A CUDA tensor
  launches the kernel or raises; a CPU tensor takes the plain version.
  Each counts its launches (:func:`launch_count`).
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
import threading
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

#: query rows and keys per tile of K1 and K2 (``BQ``/``BK`` in the CUDA
#: sources); the attention-ceiling tool takes its skeletons' blocks from
#: them
BLOCK_Q = BLOCK_K = 64

_count_lock = threading.Lock()
_launches = {"flash_attn_fwd": 0, "flash_attn_bwd": 0}  # guarded-by: _count_lock


def launch_count(kernel: str = "flash_attn_fwd") -> int:
    """Launches of ``kernel`` (``flash_attn_fwd`` or ``flash_attn_bwd``)
    since the last :func:`reset_launch_count`."""
    with _count_lock:
        return _launches[kernel]


def reset_launch_count() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


def _count(kernel: str) -> None:
    with _count_lock:
        _launches[kernel] += 1


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
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(rows):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"[bh, T, d] tensor")
        if t.device != q.device:
            raise ValueError(f"{what}: q, k, v on different devices")
    bh, tq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if d % 8 or d > 128 or tq == 0 or k.shape[1] == 0:
        raise ValueError(f"flash_attention_fwd: head dim {d} must be a "
                         "multiple of 8 and at most 128, with T > 0")
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
    """``(o, lse)`` for float32 contiguous ``q [bh,Tq,d]``, ``k/v
    [bh,Tk,d]`` and an optional additive ``bias [1|bh, Tq, Tk]``; d is a
    multiple of 8 up to 128.  Launches the CUDA kernel on the current
    stream for CUDA tensors; CPU tensors take the plain version."""
    _check(q, k, v, bias)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device "
                         f"{q.device}")
    return _launch(q, k, v, bias, bool(causal), float(sm_scale))


def _launch(q, k, v, bias, causal, sm_scale):
    fn = _entry()
    bh, tq, d = q.shape
    tk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    bias_stride = 0
    if bias is not None and bias.shape[0] == bh and bh > 1:
        bias_stride = tq * tk
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 o.data_ptr(), lse.data_ptr(), bh, tq, tk, d, bias_stride,
                 sm_scale, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed: CUDA "
                           f"error {err}")
    _count("flash_attn_fwd")
    return o, lse


_entry_fns = {}


def _entry(kernel="flash_attn_fwd"):
    fn = _entry_fns.get(kernel)
    if fn is None:
        from . import _build
        lib = _build.load(kernel)
        if kernel == "flash_attn_fwd":
            fn = lib.paddle_tpu_torch_flash_attn_fwd_f32
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
                ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p]
        else:
            fn = lib.paddle_tpu_torch_flash_attn_bwd_f32
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry_fns[kernel] = fn
    return fn


# ---------------------------------------------------------------------------
# K2: the backward
# ---------------------------------------------------------------------------

def flash_attention_bwd_reference(q, k, v, o, lse, do, bias=None,
                                  causal=False, sm_scale=None):
    """Plain version of the backward: ``(dq, dk, dv, dbias)``, the math of
    ``paddle_tpu``'s ``_flash_bwd_jax`` (flash_attention.py:641) in one
    dense pass.  P is rebuilt from the saved ``lse`` and is 0 wherever the
    score is ``<= NEG_INF / 2`` (masked), so a row with no live key gets
    zero gradients; ``delta = rowsum(do * o)`` in float32; ``sm_scale`` is
    folded into q.  ``dbias`` is ``[1|bh, Tq, Tk]`` like the bias (summed
    over bh for a shared plane), None without a bias."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
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
                        sm_scale: Optional[float] = None):
    """``(dq, dk, dv)`` for the float32 contiguous ``q [bh,Tq,d]``, ``k/v
    [bh,Tk,d]``, the forward's ``o [bh,Tq,d]`` and ``lse [bh,Tq]``, and the
    output gradient ``do [bh,Tq,d]``; d is a multiple of 8 up to 128.
    Launches the CUDA kernel on the current stream for CUDA tensors; CPU
    tensors take the plain version.  (No bias: with one, the backward is
    the plain version on any device, as in the reference.)"""
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
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                             causal, sm_scale)[:3]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    fn = _entry("flash_attn_bwd")
    tk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, tq, tk, d,
                 float(sm_scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd kernel launch failed: CUDA "
                           f"error {err}")
    _count("flash_attn_bwd")
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
