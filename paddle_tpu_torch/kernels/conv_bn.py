"""1x1 convolution with batch-norm statistics (K3): a hand-written CUDA
kernel and its plain version.

K3 replaces the Pallas TPU kernel ``paddle_tpu/pallas/conv_bn.py``
``conv1x1_stats_nchw`` (:143, ``pl.pallas_call`` at :160, body
``_nchw_kernel`` :122); its source is ``paddle_tpu_torch/csrc/
conv1x1_stats.cu``, whose header says what bounds it on an H100.  For
``x [N, Cin, P]`` (an NCHW activation with P = H·W) and ``w [Cout, Cin]``:

    y[n, co, p] = Σ_ci bf16(w[co, ci]) · bf16(x[n, ci, p])   (f32 sums)
    s[co] = Σ_{n,p} y[n, co, p],   s2[co] = Σ_{n,p} y[n, co, p]²

The operands are rounded to bfloat16 and the products summed in float32,
as the TPU kernel does (``conv_bn.py:128-131``); y keeps x's dtype and the
statistics come from the float32 sums.

- :func:`conv1x1_stats_fwd` is the wrapper over contiguous float32
  tensors.  A CUDA tensor launches the kernel or raises; a CPU tensor takes
  the plain version.  It counts its launches (:func:`launch_count`).
- :func:`conv1x1_stats_plain` is the plain version.
- :func:`conv1x1_stats` differentiates through :class:`Conv1x1Stats`: K3
  forward, and the reference's backward (``conv_bn.py:192-202``) in
  PyTorch — the TPU kernel has no backward kernel either.
"""

from __future__ import annotations

import ctypes
import threading

import torch

_count_lock = threading.Lock()
_launches = {"conv1x1_stats": 0}  # guarded-by: _count_lock


def launch_count(kernel: str = "conv1x1_stats") -> int:
    """Launches of K3 since the last :func:`reset_launch_count`."""
    with _count_lock:
        return _launches[kernel]


def reset_launch_count() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


def _count(kernel: str) -> None:
    with _count_lock:
        _launches[kernel] += 1


def conv1x1_stats_plain(x, w):
    """Plain version of K3: ``(y, s, s2)`` with bf16-rounded operands
    multiplied and summed in float32."""
    xb = x.to(torch.bfloat16).float()
    wb = w.to(torch.bfloat16).float()
    y = torch.einsum("oc,ncp->nop", wb, xb)
    s = torch.sum(y, dim=(0, 2))
    s2 = torch.sum(y * y, dim=(0, 2))
    return y.to(x.dtype), s, s2


def _check(x, w):
    what = "conv1x1_stats"
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"{what}: x must be [N, Cin, P] and w [Cout, Cin], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"{what}: x and w on different devices")
    if min(x.shape) == 0 or w.shape[0] == 0:
        raise ValueError(f"{what}: empty operand {tuple(x.shape)} "
                         f"{tuple(w.shape)}")


#: pixels per column tile of the kernel (its grid runs over the N*P
#: pixels of all images; each tile writes one row of partial sums)
COLS = 128


def conv1x1_stats_fwd(x, w):
    """``(y [N, Cout, P], s [Cout], s2 [Cout])`` for contiguous float32
    ``x [N, Cin, P]`` and ``w [Cout, Cin]``.  Launches the CUDA kernel on
    the current stream for CUDA tensors; CPU tensors take the plain
    version."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv1x1_stats_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv1x1_stats: no kernel for device {x.device}")
    fn = _entry()
    n, cin, p = x.shape
    cout = w.shape[0]
    y = torch.empty((n, cout, p), dtype=torch.float32, device=x.device)
    rows = -(-(n * p) // COLS)
    part = torch.empty((2, rows, cout), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
                 stats.data_ptr(), n, cin, cout, p, stream)
    if err != 0:
        raise RuntimeError(f"conv1x1_stats kernel launch failed: CUDA "
                           f"error {err}")
    _count("conv1x1_stats")
    return y, stats[0], stats[1]


_entry_fn = []


def _entry():
    if not _entry_fn:
        from . import _build
        fn = _build.load("conv1x1_stats").paddle_tpu_torch_conv1x1_stats_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry_fn.append(fn)
    return _entry_fn[0]


class Conv1x1Stats(torch.autograd.Function):
    """``(y, s, s2)``: K3 forward saving ``(x, w, y)``; the backward is
    the reference's VJP in the same N·C·P layout:
    ``dy_eff = dy + ds + 2·y·ds2``, ``dx = wᵀ·dy_eff``,
    ``dw = Σ_{n,p} dy_eff·x``."""

    @staticmethod
    def forward(ctx, x, w):
        y, s, s2 = conv1x1_stats_fwd(x, w)
        ctx.save_for_backward(x, w, y)
        return y, s, s2

    @staticmethod
    def backward(ctx, dy, ds, ds2):
        x, w, y = ctx.saved_tensors
        dy_eff = (dy.float() + ds[None, :, None]
                  + 2.0 * y.float() * ds2[None, :, None])
        dy_b = dy_eff.to(x.dtype)
        dx = torch.einsum("nop,oc->ncp", dy_b, w.to(dy_b.dtype))
        dw = torch.einsum("nop,ncp->oc", dy_b, x)
        return dx.to(x.dtype), dw.to(w.dtype)


def conv1x1_stats(x, w):
    """Differentiable ``(y, s, s2)`` over ``x [N, Cin, P]``, ``w [Cout,
    Cin]`` (the reference's ``conv1x1_stats``, ``conv_bn.py:178``)."""
    return Conv1x1Stats.apply(x.contiguous(), w.contiguous())
