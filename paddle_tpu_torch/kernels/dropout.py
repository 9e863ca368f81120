"""Dropout on a replayable Philox stream: a hand-written CUDA kernel and its
plain version.

The kernel replaces no Pallas kernel: the JAX package draws and applies its
dropout mask in jnp (``paddle_tpu/ops/nn_ops.py:647-709``) from XLA's
``rbg`` bits, which only XLA computes.  The port draws its own bits from a
counter-based Philox4x32-10, keyed by the run's seed, with the op's tag (or
the run's counter) in the counter: a stream is a pure function of (seed,
tag), so an op and its gradient regenerate the same mask and none is
stored.  Its source is ``paddle_tpu_torch/csrc/dropout.cu``, whose header
says what bounds it on an H100.  For ``x [...]`` of float32 or bf16:

    byte_i = byte i % 16 of Philox4x32-10((i // 16, word2, word3), seed)
    keep_i = byte_i >= threshold
    out_i  = x_i * scale if keep_i else 0      (scale in x's dtype)

with the reference's quantization ``threshold = max(1, round(p * 256))``
for ``p > 0`` (:func:`threshold`).  Given a stored mask, ``keep`` is the
mask instead (the gradient of an untagged dropout).

- :func:`tagged_stream` / :func:`counter_stream` name a stream: the op's
  tag or the run's counter, in disjoint counter words (the reference keeps
  its two streams apart with a ``0x5EED`` fold, ``executor.py:735-742``).
- :func:`philox_bytes` is the plain version's single source of bits, the
  Philox in torch int64 arithmetic (16-bit halves, so no product
  overflows), on any device.
- :func:`dropout_fwd` is the wrapper: a CUDA tensor launches the kernel or
  raises; a CPU tensor takes the plain version (:func:`dropout_plain`).  It
  counts its launches by x's dtype (:func:`launch_count`).
- :func:`dropout` differentiates through :class:`Dropout`, whose backward
  runs the same stream on the output gradient (no mask saved).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ._launches import LaunchCounts

#: x's dtypes, by their code in the C entry point
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LAUNCHES = LaunchCounts("dropout")
_count = _LAUNCHES.count

#: the third counter word of each stream kind: a tagged stream and the
#: run's counter stream never share a counter block
TAGGED, COUNTER = 0x5EED0001, 0x5EED0002

_U32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


class Stream(NamedTuple):
    """A Philox stream: the key (the run's 64-bit seed) and the counter's
    two high words (the tag or the counter, and the stream's kind)."""
    seed: int
    word2: int
    word3: int


def tagged_stream(seed: int, tag: int) -> Stream:
    return Stream(int(seed) & 0xFFFFFFFFFFFFFFFF, int(tag) & _U32, TAGGED)


def counter_stream(seed: int, counter: int) -> Stream:
    return Stream(int(seed) & 0xFFFFFFFFFFFFFFFF, int(counter) & _U32,
                  COUNTER)


def threshold(p: float) -> int:
    """The byte threshold of drop probability ``p``: resolution 1/256,
    with a floor of 1 for a nonzero ``p`` (``nn_ops.py:660-665``)."""
    return max(1, int(round(float(p) * 256.0))) if p > 0 else 0


def rounded_scale(scale: float, dtype: torch.dtype) -> float:
    """``scale`` as x's dtype holds it: the reference multiplies by a
    Python float, which JAX rounds to the array's dtype (float32, then
    bf16) before the product."""
    return float(torch.tensor(float(scale), dtype=torch.float32).to(dtype))


def launch_count(kernel: str = "dropout",
                 dtype: Optional[str] = None) -> int:
    """Launches of the dropout kernel on x of ``dtype`` ("float32" or
    "bfloat16"; None: both) since the last :func:`reset_launch_count`."""
    return _LAUNCHES.get(kernel, dtype)


def reset_launch_count() -> None:
    _LAUNCHES.reset()


def _mulhilo(m: int, c: torch.Tensor):
    """(high, low) 32-bit words of ``m * c`` for uint32 values held in
    int64: c split into 16-bit halves, so each product stays below 2^48."""
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    lo = (a + ((b & 0xFFFF) << 16)) & _U32
    hi = ((a >> 16) + b) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of int64 tensors holding uint32 counter words, with
    the key ``(k0, k1)``; returns the four output words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bytes(stream: Stream, shape, device) -> torch.Tensor:
    """The stream's first ``prod(shape)`` bytes as uint8 of ``shape``:
    byte i is byte i % 16 (little-endian) of the Philox output at counter
    i // 16.  The plain version's one source of bits."""
    n = 1
    for d in shape:
        n *= int(d)
    g = torch.arange((n + 15) // 16, dtype=torch.int64, device=device)
    words = philox4x32_10(g & _U32, g >> 32, torch.full_like(g, stream.word2),
                          torch.full_like(g, stream.word3),
                          stream.seed & _U32, stream.seed >> 32)
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=device)
    b = (torch.stack(words, 1).unsqueeze(-1) >> shifts) & 0xFF
    return b.reshape(-1)[:n].to(torch.uint8).reshape(tuple(shape))


def dropout_plain(x, stream: Optional[Stream], thresh: int, scale: float,
                  mask_in=None, want_mask=False):
    """Plain version of the kernel: ``(out, mask or None)``."""
    if mask_in is not None:
        keep = mask_in != 0
    else:
        keep = philox_bytes(stream, x.shape, x.device).to(torch.int32) \
            >= thresh
    s = torch.tensor(rounded_scale(scale, x.dtype), dtype=x.dtype,
                     device=x.device)
    out = torch.where(keep, x * s, torch.zeros((), dtype=x.dtype,
                                               device=x.device))
    return out, (keep.to(torch.uint8) if want_mask else None)


def _check(x, mask_in, thresh):
    if x.dtype not in DTYPES:
        raise TypeError(f"dropout: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if not 0 <= thresh <= 256:
        raise ValueError(f"dropout: threshold {thresh} outside [0, 256]")
    if mask_in is not None and (mask_in.dtype != torch.uint8 or
                                mask_in.shape != x.shape or
                                mask_in.device != x.device):
        raise ValueError(f"dropout: the mask must be uint8 {tuple(x.shape)} "
                         f"on {x.device}, got {mask_in.dtype} "
                         f"{tuple(mask_in.shape)} on {mask_in.device}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"dropout: no kernel for device {x.device}")


def dropout_fwd(x, stream: Optional[Stream], thresh: int, scale: float,
                mask_in=None, want_mask=False):
    """``(out, mask)`` for ``x`` of float32 or bf16: ``out`` in x's dtype,
    ``mask`` uint8 of x's shape where ``want_mask`` (else None).  ``keep``
    comes from ``stream`` and ``thresh``, or from ``mask_in`` where given.
    Launches the kernel on the current stream for a CUDA tensor; a CPU
    tensor takes the plain version, a meta tensor gives empty outputs."""
    _check(x, mask_in, thresh)
    if x.device.type == "meta":
        return torch.empty_like(x), (torch.empty(x.shape, dtype=torch.uint8,
                                                 device=x.device)
                                     if want_mask else None)
    if x.device.type == "cpu":
        return dropout_plain(x, stream, thresh, scale, mask_in, want_mask)
    x = x.contiguous()
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device) \
        if want_mask else None
    if x.numel():
        mask_in = mask_in.contiguous() if mask_in is not None else None
        st = stream or Stream(0, 0, 0)
        with torch.cuda.device(x.device):
            cs = torch.cuda.current_stream(x.device).cuda_stream
            err = _entry()(x.data_ptr(), out.data_ptr(),
                           mask.data_ptr() if mask is not None else None,
                           mask_in.data_ptr() if mask_in is not None
                           else None, x.numel(), st.seed, st.word2,
                           st.word3, thresh, rounded_scale(scale, x.dtype),
                           DTYPES[x.dtype], cs)
        if err != 0:
            raise RuntimeError(f"dropout kernel launch failed: CUDA error "
                               f"{err}")
        _count("dropout", x.dtype)
    return out, mask


_entries = {}


def _entry():
    if not _entries:
        from . import _build
        fn = _build.load("dropout").paddle_tpu_torch_dropout
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_ulonglong,
                       ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _entries["dropout"] = fn
    return _entries["dropout"]


class Dropout(torch.autograd.Function):
    """The kernel on x; its backward is the kernel on the output gradient
    with the same stream, threshold and scale: the mask is regenerated,
    not saved (the reference's tagged dropout, ``fused_ops.py:94-112``).
    With ``want_mask`` it gives ``(out, mask)``, the mask not
    differentiable."""

    @staticmethod
    def forward(ctx, x, stream, thresh, scale, want_mask=False):
        ctx.args = (stream, thresh, scale)
        out, mask = dropout_fwd(x, stream, thresh, scale,
                                want_mask=want_mask)
        if mask is None:
            return out
        ctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    def backward(ctx, g, *_):
        return dropout_fwd(g, *ctx.args)[0], None, None, None, None


def dropout(x, stream: Stream, thresh: int, scale: float,
            want_mask: bool = False):
    """``keep ? x * scale : 0`` on the stream, differentiable; with
    ``want_mask``, ``(out, mask)``."""
    return Dropout.apply(x, stream, thresh, scale, want_mask)
