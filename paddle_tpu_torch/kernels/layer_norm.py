"""LayerNorm over the last dim (K4): hand-written CUDA kernels and their
plain versions.

K4 replaces the Pallas TPU kernels ``paddle_tpu/pallas/layer_norm.py``
``_fwd_pallas`` (:92, ``pl.pallas_call`` at :97, body ``_fwd_kernel`` :44)
and ``_bwd_pallas`` (:111, call :117, body ``_bwd_kernel`` :54); its source
is ``paddle_tpu_torch/csrc/layer_norm.cu``, whose header says what bounds it
on an H100.  For ``x [rows, d]`` in float32 or bf16 (AMP) and float32
``scale``, ``bias [d]``:

    m = mean(x), var = max(mean(x²) - m², 0), rstd = rsqrt(var + eps)
    y = (x - m) · rstd · scale + bias

and the backward ``dx = rstd·(g - mean(g) - x̂·mean(g·x̂))`` with
``g = dy·scale``, ``dscale = Σ_rows dy·x̂``, ``dbias = Σ_rows dy``.  The
statistics, dscale and dbias are float32; y and dx are in x's dtype
(``:106, :131``).

- :func:`layer_norm_fwd` / :func:`layer_norm_bwd` are the wrappers over
  contiguous tensors (x, y, dy and dx of one dtype, float32 or bf16; the
  kernels read and write bf16 themselves).  A CUDA tensor launches the
  kernel or raises; a CPU tensor takes the plain version.  Each counts its
  launches per dtype (:func:`launch_count`).
- :func:`layer_norm_fwd_plain` / :func:`layer_norm_bwd_plain` are the plain
  versions, the reference's ``_ln_ref`` (:34) and the math of
  ``_fused_ln_bwd`` (:154).
- :func:`fused_layer_norm` is the reference's entry (:178): differentiable
  through :class:`LayerNorm`, whose backward launches K4's backward (the
  reference's ``_fused_ln`` custom VJP, :143-175).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._launches import LaunchCounts

#: the row dtypes the kernels take, by their code in the C entry points
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LAUNCHES = LaunchCounts("layer_norm_fwd", "layer_norm_bwd")
_count = _LAUNCHES.count

#: the widest row the kernels hold in registers (8 warps x 4 slots of 4)
MAX_D = 4096
#: the widest row the backward's one-warp-a-row form takes, by row dtype
#: (``RowForm`` in the source: the widest ptxas holds without spills)
ROW_MAX_D = {torch.float32: 768, torch.bfloat16: 1024}
#: that form's grid: at most this many clusters (of 8 blocks of 8 warps, at
#: least a row a warp), one partial row each
ROW_CLUSTERS = {torch.float32: 12, torch.bfloat16: 12}
ROWS_PER_CLUSTER = 8 * 8
#: the wider rows' multi-warp backward: at most this many blocks, one
#: partial row each
WIDE_BLOCKS = 512


def launch_count(kernel: str = "layer_norm_fwd",
                 dtype: Optional[str] = None) -> int:
    """Launches of ``kernel`` (``layer_norm_fwd`` or ``layer_norm_bwd``)
    on rows of ``dtype`` ("float32" or "bfloat16"; None: both) since the
    last :func:`reset_launch_count`."""
    return _LAUNCHES.get(kernel, dtype)


def reset_launch_count() -> None:
    _LAUNCHES.reset()


def _stats(xf, eps):
    m = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - m * m
    return m, torch.rsqrt(torch.clamp(var, min=0.0) + eps)


def layer_norm_fwd_plain(x, scale, bias, eps):
    """Plain version of K4's forward: float32 statistics, y in x's dtype."""
    xf = x.float()
    m, rstd = _stats(xf, eps)
    y = (xf - m) * rstd * scale.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_bwd_plain(x, scale, dy, eps):
    """Plain version of K4's backward: ``(dx, dscale, dbias)``, the
    statistics recomputed from x; dscale and dbias in float32."""
    xf, dyf = x.float(), dy.float()
    m, rstd = _stats(xf, eps)
    xhat = (xf - m) * rstd
    g = dyf * scale.float()
    c1 = g.mean(dim=-1, keepdim=True)
    c2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (g - c1 - xhat * c2)).to(x.dtype)
    return dx, (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def _check_width(what, d):
    if d > MAX_D:
        raise ValueError(f"{what}: d = {d} exceeds the kernel's {MAX_D}")


def partial_rows(rows: int, d: int, dtype: torch.dtype) -> int:
    """The partial rows of dscale and dbias K4's backward writes for ``x
    [rows, d]`` of ``dtype`` (its scratch is ``[2, partial_rows, d]``
    float32): up to :data:`ROW_MAX_D`, one a cluster of the one-warp-a-row
    form; wider, one a block of the multi-warp form (``wpr`` warps a row,
    8 / wpr rows a block).  The rule of the source's
    ``paddle_tpu_torch_layer_norm_partial_rows``, which refuses a launch
    given another count.  Raises for a d the kernels do not take."""
    _check_width("layer_norm_bwd", d)
    if rows <= 0 or d <= 0:
        raise ValueError(f"layer_norm_bwd: rows {rows} and d {d} must be "
                         "positive")
    if d <= ROW_MAX_D[dtype]:
        return min(ROW_CLUSTERS[dtype], -(-rows // ROWS_PER_CLUSTER))
    wpr = next(w for w in (1, 2, 4, 8) if -(-d // 4) <= 32 * w * 4)
    return min(WIDE_BLOCKS, -(-rows // (8 // wpr)))


def _check(what, x, vectors):
    if x.dtype not in DTYPES:
        raise TypeError(f"{what}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    for name, t in (("x", x),) + vectors:
        want = x.dtype if name == "dy" else (
            torch.float32 if name != "x" else x.dtype)
        if t.dtype != want:
            raise TypeError(f"{what}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.dim() != 2 or min(x.shape) == 0:
        raise ValueError(f"{what}: x must be a non-empty [rows, d], got "
                         f"{tuple(x.shape)}")
    d = x.shape[1]
    for name, t in vectors:
        want = (d,) if name != "dy" else tuple(x.shape)
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} must be {want}, got "
                             f"{tuple(t.shape)}")
    if x.device.type == "cuda":
        _check_width(what, d)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {x.device}")


def layer_norm_fwd(x, scale, bias, eps):
    """``y [rows, d]`` in x's dtype for contiguous ``x [rows, d]`` (float32
    or bf16) and float32 ``scale``, ``bias [d]``.  Launches K4's forward on
    the current stream for CUDA tensors; CPU tensors take the plain
    version."""
    _check("layer_norm_fwd", x, (("scale", scale), ("bias", bias)))
    if x.device.type == "cpu":
        return layer_norm_fwd_plain(x, scale, bias, eps)
    rows, d = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry("fwd")(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                            y.data_ptr(), rows, d, float(eps),
                            DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"layer_norm_fwd kernel launch failed: CUDA "
                           f"error {err}")
    _count("layer_norm_fwd", x.dtype)
    return y


def layer_norm_bwd(x, scale, dy, eps):
    """``(dx [rows, d], dscale [d], dbias [d])`` for contiguous ``x``,
    ``dy [rows, d]`` (one dtype, float32 or bf16; dx in it) and float32
    ``scale [d]``; dscale and dbias are float32.  Launches K4's backward
    (two kernels: the row pass with column partials, one row a cluster of
    the one-warp-a-row form or a block of the multi-warp form, then the
    partials added in a fixed order; :func:`partial_rows`) for CUDA
    tensors; CPU tensors take the plain version."""
    _check("layer_norm_bwd", x, (("scale", scale), ("dy", dy)))
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, scale, dy, eps)
    rows, d = x.shape
    prow = partial_rows(rows, d, x.dtype)
    dx = torch.empty_like(x)
    part = torch.empty((2, prow, d), dtype=torch.float32, device=x.device)
    grads = torch.empty((2, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry("bwd")(x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                            dx.data_ptr(), part.data_ptr(), prow,
                            grads.data_ptr(), rows, d, float(eps),
                            DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"layer_norm_bwd kernel launch failed: CUDA "
                           f"error {err}")
    _count("layer_norm_bwd", x.dtype)
    return dx, grads[0], grads[1]


_entries = {}


def _entry(which):
    if not _entries:
        from . import _build
        lib = _build.load("layer_norm")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name, fn, args in (
                ("fwd", lib.paddle_tpu_torch_layer_norm_fwd,
                 [p] * 4 + [i, i, f, i, p]),
                ("bwd", lib.paddle_tpu_torch_layer_norm_bwd,
                 [p] * 5 + [i, p, i, i, f, i, p]),
                ("partial_rows", lib.paddle_tpu_torch_layer_norm_partial_rows,
                 [i, i, i])):
            fn.argtypes = args
            fn.restype = ctypes.c_int
            _entries[name] = fn
    return _entries[which]


class LayerNorm(torch.autograd.Function):
    """K4's forward, saving ``(x, scale)``; the backward launches K4's
    backward, which recomputes the statistics (``_fused_ln``,
    ``layer_norm.py:143-175``)."""

    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x2, scale)
        return layer_norm_fwd(x2, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x2, scale = ctx.saved_tensors
        dx, ds, db = layer_norm_bwd(x2, scale, dy.contiguous(), ctx.eps)
        return dx, ds.to(scale.dtype), db.to(scale.dtype), None


def fused_layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last dim of ``x [..., d]`` with float32
    statistics; ``scale``, ``bias``: ``[d]``.  Differentiable."""
    d = x.shape[-1]
    y2 = LayerNorm.apply(x.reshape(-1, d).contiguous(), scale.contiguous(),
                         bias.contiguous(), float(eps))
    return y2.reshape(x.shape)
