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

- :func:`conv1x1_stats_fwd` is the wrapper over contiguous float32 or bf16
  tensors (under AMP a bf16 x and the float32 master w).  Both dtypes run
  on the Hopper GEMM core (``csrc/sm90_gemm.cuh``: TMA and ``wgmma``),
  which reads x where it lies at every ResNet-50 shape and writes y
  itself: a bf16 x as B (:func:`bf16_operand` says when it takes a padded
  copy); a float32 x as A, rounded to bf16 in the registers of its
  fragments, by TMA where a row is whole 16-byte chunks and from bulk-
  copied slabs at P <= 64 (:func:`f32_route`, :func:`f32_operand`).  A
  CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
  version.  It counts its launches by x's dtype (:func:`launch_count`).
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
  (on the GEMM core: x by TMA in its own type, A built in registers where
  the prologue or a float32 x needs it; :func:`mm_operand` says when x is
  copied first) or raises; a CPU tensor takes the plain version.  It
  counts its launches under ``matmul_bn_stats``.
- :func:`matmul_bn_stats_plain` is the plain version.
- :func:`mm_stats` differentiates through :class:`MmStats`: K6 with no
  statistics and no relu forward, and the reference's ``_mm_stats_bwd``
  (:231-239) in PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._launches import LaunchCounts

_DTYPES = (torch.float32, torch.bfloat16)

_LAUNCHES = LaunchCounts("conv1x1_stats", "matmul_bn_stats")
_count = _LAUNCHES.count


def launch_count(kernel: str = "conv1x1_stats",
                 dtype: Optional[str] = None) -> int:
    """Launches of ``kernel`` (``conv1x1_stats``, K3, or
    ``matmul_bn_stats``, K6) with x of ``dtype`` ("float32" or "bfloat16";
    None: both) since the last :func:`reset_launch_count`."""
    return _LAUNCHES.get(kernel, dtype)


def reset_launch_count() -> None:
    _LAUNCHES.reset()


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
        if t.dtype not in _DTYPES:
            raise TypeError(f"{what}: {name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
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


def conv1x1_stats_fwd(x, w):
    """``(y [N, Cout, P], s [Cout], s2 [Cout])`` for contiguous ``x [N,
    Cin, P]`` and ``w [Cout, Cin]``, each float32 or bf16 (y in x's dtype,
    s and s2 float32).  Launches the CUDA kernel on the current stream for
    CUDA tensors; CPU tensors take the plain version."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv1x1_stats_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv1x1_stats: no kernel for device {x.device}")
    if x.dtype == torch.bfloat16:
        return _launch_bf16(x, w)
    return _launch_f32(x, w)


#: the widest image (pixels) the float32 form reads from bulk-copied slabs,
#: two images a 128-row tile; a wider one is read by TMA.  The wrapper
#: names the route to the kernel, whose slab buffers hold this many pixels
#: (``f32k::SLAB_MAX_P``)
SLAB_MAX_P = 64


def f32_route(p):
    """How the float32 form reads an image of ``p`` pixels: ``"slab"``
    (one bulk copy of each image's channel slab a stage, two images a
    tile) up to :data:`SLAB_MAX_P` pixels, else ``"TMA"`` (boxes of 32
    pixels x 64 channels of a 3-d tensor map)."""
    return "slab" if p <= SLAB_MAX_P else "TMA"


def f32_operand(x):
    """x as the float32 form reads it: a 16-byte aligned base, and image
    rows of whole 16-byte chunks (``P % 4 == 0``, TMA) or, at
    ``P <= SLAB_MAX_P``, image slabs of whole 16-byte chunks
    (``Cin * P % 4 == 0``).  ResNet-50's x is all of that as it lies;
    another x is copied with zero pixels (TMA), or zero channels (slab),
    appended."""
    n, cin, p = x.shape
    pad_c = pad_p = 0
    if f32_route(p) == "slab":
        pad_c = -cin % 4 if cin * p % 4 else 0
    else:
        pad_p = -p % 4
    if pad_c or pad_p or x.data_ptr() % 16:
        x = torch.nn.functional.pad(x, (0, pad_p, 0, pad_c))
    return x


def _launch_f32(x, w):
    """The float32 form (float32 x and y, float32 or bf16 w) on the Hopper
    GEMM core, x's fragments rounded to bf16 in registers."""
    fn, part_rows = _entry_f32()
    n, cin, p = x.shape
    cout = w.shape[0]
    xk = f32_operand(x)
    cx, px = xk.shape[1], xk.shape[2]
    slab = int(f32_route(p) == "slab")
    y = torch.empty((n, cout, p), dtype=x.dtype, device=x.device)
    wcopy = torch.empty((cout * (-(-cin // 8) * 8),), dtype=torch.bfloat16,
                        device=x.device)
    part = torch.empty((2, part_rows(n, p, cout, slab), cout),
                       dtype=torch.float32, device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xk.data_ptr(), w.data_ptr(), y.data_ptr(), wcopy.data_ptr(),
                 part.data_ptr(), stats.data_ptr(), n, cin, cx, cout, p, px,
                 slab, int(w.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"conv1x1_stats kernel launch failed: CUDA "
                           f"error {err}")
    _count("conv1x1_stats", x.dtype)
    return y, stats[0], stats[1]


#: the widest image row (pixels) the bf16 form lays out of a raw slab; a
#: wider row must be whole 16-byte chunks, for TMA
GATHER_MAX_P = 256


def bf16_operand(x):
    """x as the bf16 form reads it: channels a multiple of 8, a 16-byte
    aligned base, and image rows of whole 16-byte chunks (TMA) or of at most
    :data:`GATHER_MAX_P` pixels (laid out from raw slabs).  ResNet-50's x
    is all of that as it lies; another x is copied with zero channels, and
    zero pixels past a wide ragged row, appended."""
    n, cin, p = x.shape
    pad_c = -cin % 8
    pad_p = -p % 8 if p > GATHER_MAX_P else 0
    if pad_c or pad_p or x.data_ptr() % 16:
        x = torch.nn.functional.pad(x, (0, pad_p, 0, pad_c))
    return x


def _launch_bf16(x, w):
    """The bf16 form (bf16 x and y, float32 or bf16 w) on the Hopper GEMM
    core (``csrc/sm90_gemm.cuh``)."""
    fn, part_rows = _entry_bf16()
    n, cin, p = x.shape
    cout = w.shape[0]
    xk = bf16_operand(x)
    cx, px = xk.shape[1], xk.shape[2]
    y = torch.empty((n, cout, p), dtype=x.dtype, device=x.device)
    wcopy = torch.empty((cout * (-(-cin // 8) * 8),), dtype=torch.bfloat16,
                        device=x.device)
    part = torch.empty((2, part_rows(n, cin, p, px, cout), cout),
                       dtype=torch.float32, device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xk.data_ptr(), w.data_ptr(), y.data_ptr(), wcopy.data_ptr(),
                 part.data_ptr(), stats.data_ptr(), n, cin, cx, cout, p, px,
                 int(w.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"conv1x1_stats bf16 kernel launch failed: CUDA "
                           f"error {err}")
    _count("conv1x1_stats", x.dtype)
    return y, stats[0], stats[1]


_entry_f32_fns = []


def _entry_f32():
    if not _entry_f32_fns:
        from . import _build
        lib = _build.load("conv1x1_stats")
        fn = lib.paddle_tpu_torch_conv1x1_stats
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rows = lib.paddle_tpu_torch_conv1x1_stats_rows
        rows.argtypes = [ctypes.c_int] * 4
        rows.restype = ctypes.c_longlong
        _entry_f32_fns.extend((fn, rows))
    return _entry_f32_fns


_entry_bf16_fns = []


def _entry_bf16():
    if not _entry_bf16_fns:
        from . import _build
        lib = _build.load("conv1x1_stats")
        fn = lib.paddle_tpu_torch_conv1x1_stats_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rows = lib.paddle_tpu_torch_conv1x1_stats_bf16_rows
        rows.argtypes = [ctypes.c_int] * 5
        rows.restype = ctypes.c_longlong
        _entry_bf16_fns.extend((fn, rows))
    return _entry_bf16_fns


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

_MM_DTYPES = _DTYPES


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


def mm_operand(x):
    """x as K6 reads it: a 16-byte aligned base and rows of whole 16-byte
    chunks (K a multiple of 8 in bf16, of 4 in float32), the rule of the
    TMA map that loads it in its own type.  The tool's x is all of that as
    it lies; another x is copied with zero columns appended (the kernel
    zeroes columns past K after the prologue, so they add nothing)."""
    pad = -x.shape[1] % (16 // x.element_size())
    if pad or x.data_ptr() % 16:
        x = torch.nn.functional.pad(x, (0, pad))
    return x


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
    xk = mm_operand(x)
    # the statistics as K (mu, inv, g, b) quadruples: a stage's k in one
    # bulk copy
    pk = stats.t().contiguous() if stats is not None else None
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    wcopy = torch.empty((k * (-(-n // 8) * 8),), dtype=torch.bfloat16,
                        device=x.device)
    part = torch.empty((2, rows(m, n), n), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((2, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xk.data_ptr(), w.data_ptr(),
                 pk.data_ptr() if pk is not None else None,
                 y.data_ptr(), wcopy.data_ptr(), part.data_ptr(),
                 out.data_ptr(), m, k, xk.shape[1], n,
                 int(x.dtype == torch.bfloat16),
                 int(w.dtype == torch.bfloat16), int(bool(relu)), stream)
    if err != 0:
        raise RuntimeError(f"matmul_bn_stats kernel launch failed: CUDA "
                           f"error {err}")
    _count("matmul_bn_stats", x.dtype)
    return y, out[0], out[1]


_mm_entry_fns = []


def _mm_entry():
    if not _mm_entry_fns:
        from . import _build
        lib = _build.load("matmul_bn_stats")
        fn = lib.paddle_tpu_torch_matmul_bn_stats
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rows = lib.paddle_tpu_torch_matmul_bn_stats_rows
        rows.argtypes = [ctypes.c_int] * 2
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
