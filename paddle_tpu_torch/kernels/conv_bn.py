"""1x1 convolution with batch-norm statistics (K3), and matmul with the
producer's batch-norm folded in and batch-norm statistics (K6): hand-written
CUDA kernels and their plain versions.

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

K6 replaces ``matmul_bn_stats`` (:58, ``pl.pallas_call`` at :100, body
``_kernel`` :31); its source is ``paddle_tpu_torch/csrc/
matmul_bn_stats.cu``.  For ``x [M, K]`` and ``w [K, N]`` (float32 or
bfloat16 each) and the producer's optional statistics ``(mu, inv, g, b)``,
each ``[K]``:

    a = (x - mu) * inv * g + b        (only with the statistics)
    a = max(a, 0)                     (only with ``relu``; independent)
    y = Σ_k bf16(a) · bf16(w)         (float32 sums; y in x's dtype)
    s = Σ_m y,   s2 = Σ_m y²          (of the float32 sums)

- :func:`matmul_bn_stats_fwd` is the wrapper, with the reference's shape
  rule (an M above 1024 needs a dividing block of at least 8 rows, so
  M % 8 == 0) checked before any launch.  A CUDA tensor launches the kernel
  or raises; a CPU tensor takes the plain version.  It counts its launches
  under ``matmul_bn_stats``.
- :func:`matmul_bn_stats_plain` is the plain version.
- :func:`mm_stats` differentiates through :class:`MmStats`: K6 with no
  statistics and no relu forward, and the reference's ``_mm_stats_bwd``
  (:231-239) in PyTorch.
"""

from __future__ import annotations

import ctypes
import threading

import torch

_count_lock = threading.Lock()
_launches = {"conv1x1_stats": 0,
             "matmul_bn_stats": 0}  # guarded-by: _count_lock


def launch_count(kernel: str = "conv1x1_stats") -> int:
    """Launches of ``kernel`` (``conv1x1_stats``, K3, or
    ``matmul_bn_stats``, K6) since the last :func:`reset_launch_count`."""
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


# ---------------------------------------------------------------------------
# K6: matmul with the producer's batch-norm folded in, and statistics
# ---------------------------------------------------------------------------

_MM_DTYPES = (torch.float32, torch.bfloat16)


def matmul_bn_stats_plain(x, w, producer_stats=None, relu=True):
    """Plain version of K6: ``(y, s, s2)``, the prologue in float32 as four
    separate operations, bf16-rounded operands multiplied and summed in
    float32."""
    a = x.float()
    if producer_stats is not None:
        mu, inv, g, b = (p.reshape(-1).float() for p in producer_stats)
        a = (a - mu) * inv * g + b
    if relu:
        a = torch.relu(a)
    y = torch.matmul(a.to(torch.bfloat16).float(),
                     w.to(torch.bfloat16).float())
    return y.to(x.dtype), y.sum(dim=0), (y * y).sum(dim=0)


def _check_mm(x, w, producer_stats):
    """Raises on what K6 does not take; returns the statistics stacked as a
    contiguous float32 ``[4, K]`` tensor, or None."""
    what = "matmul_bn_stats"
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in _MM_DTYPES:
            raise TypeError(f"{what}: {name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] or \
            min(x.shape + w.shape) == 0:
        raise ValueError(f"{what}: x must be [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"{what}: x on {x.device}, w on {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {x.device}")
    m, k = x.shape
    # the reference halves a 1024-row block until it divides M and refuses
    # to pad (padded rows would reach the statistics through the prologue)
    if m > 1024 and m % 8:
        raise ValueError(f"no dividing block_m for M={m}")
    if producer_stats is None:
        return None
    if len(producer_stats) != 4:
        raise ValueError(f"{what}: producer_stats must be (mu, inv, gamma, "
                         f"beta), got {len(producer_stats)} tensors")
    for p in producer_stats:
        if p.numel() != k or p.device != x.device or \
                not p.dtype.is_floating_point:
            raise ValueError(f"{what}: each producer statistic must hold "
                             f"K={k} floats on {x.device}, got "
                             f"{tuple(p.shape)} {p.dtype} on {p.device}")
    return torch.stack([p.reshape(-1).float() for p in producer_stats])


def matmul_bn_stats_fwd(x, w, producer_stats=None, relu=True):
    """``(y [M, N], s [N], s2 [N])`` for contiguous ``x [M, K]`` and ``w [K,
    N]`` (float32 or bfloat16 each; y in x's dtype), the producer's
    statistics ``(mu, inv, g, b)`` (each ``[K]``) folded into the read when
    given, and a relu after them when ``relu``.  Launches K6 on the current
    stream for CUDA tensors; CPU tensors take the plain version."""
    stats = _check_mm(x, w, producer_stats)
    if x.device.type == "cpu":
        return matmul_bn_stats_plain(x, w, producer_stats, relu)
    fn, rows = _mm_entry()
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = torch.empty((2, rows(m), n), dtype=torch.float32, device=x.device)
    out = torch.empty((2, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(),
                 stats.data_ptr() if stats is not None else None,
                 y.data_ptr(), part.data_ptr(), out.data_ptr(), m, k, n,
                 int(x.dtype == torch.bfloat16),
                 int(w.dtype == torch.bfloat16), int(bool(relu)), stream)
    if err != 0:
        raise RuntimeError(f"matmul_bn_stats kernel launch failed: CUDA "
                           f"error {err}")
    _count("matmul_bn_stats")
    return y, out[0], out[1]


_mm_entry_fns = []


def _mm_entry():
    if not _mm_entry_fns:
        from . import _build
        lib = _build.load("matmul_bn_stats")
        fn = lib.paddle_tpu_torch_matmul_bn_stats
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rows = lib.paddle_tpu_torch_matmul_bn_stats_rows
        rows.argtypes = [ctypes.c_int]
        rows.restype = ctypes.c_longlong
        _mm_entry_fns.extend((fn, rows))
    return _mm_entry_fns


class MmStats(torch.autograd.Function):
    """``(y, s, s2)`` with ``y = x @ w``: K6 forward (no statistics, no
    relu) saving ``(x, w, y)``; the backward is the reference's
    ``_mm_stats_bwd``: ``dy_eff = dy + ds + 2·y·ds2`` in float32, cast to
    x's dtype, ``dx = dy_eff @ wᵀ`` and ``dw = xᵀ @ dy_eff`` (with JAX's
    type promotion where x and w differ)."""

    @staticmethod
    def forward(ctx, x, w):
        y, s, s2 = matmul_bn_stats_fwd(x, w, None, relu=False)
        ctx.save_for_backward(x, w, y)
        return y, s, s2

    @staticmethod
    def backward(ctx, dy, ds, ds2):
        x, w, y = ctx.saved_tensors
        dy_eff = dy.float() + ds[None, :] + 2.0 * y.float() * ds2[None, :]
        dy_b = dy_eff.to(x.dtype)
        cx = torch.promote_types(dy_b.dtype, w.dtype)
        dx = dy_b.to(cx) @ w.t().to(cx)
        dw = (x.t() @ dy_b).to(w.dtype)
        return dx.to(x.dtype), dw


def mm_stats(x, w):
    """Differentiable ``(y, s, s2)`` with ``y = x @ w`` over ``x [M, K]``,
    ``w [K, N]`` (the reference's ``mm_stats``, ``conv_bn.py:214``)."""
    return MmStats.apply(x.contiguous(), w.contiguous())
