"""Dense layer with its epilogue, ``act(x @ w + b)`` (K5): a hand-written
CUDA kernel and its plain version.

K5 replaces the Pallas TPU kernel ``paddle_tpu/pallas/dense_epilogue.py``
``_mba_fwd_impl`` (:69, ``pl.pallas_call`` at :82, body ``_kernel`` :40);
its source is ``paddle_tpu_torch/csrc/dense_epilogue.cu``, on the Hopper
GEMM core ``csrc/sm90_gemm.cuh`` (TMA and ``wgmma``), whose headers say
what bounds it on an H100.  For ``x [M, K]``, ``w [K, N]`` (each
float32 or bf16; under AMP both bf16) and a float32 ``b [N]``:

    y = act(Σ_k bf16(x)·bf16(w) + b)      (float32 sums, y in x's dtype)

with act one of "" (none), "relu" and "gelu" (erf, or tanh with
``approximate``), as the TPU kernel computes it (``:43-49``).

- :func:`dense_act_fwd` is the wrapper over contiguous tensors; y is in
  x's dtype (the kernel reads bf16 operands where they lie and writes bf16
  y itself).  A CUDA tensor launches the kernel or raises; a CPU tensor
  takes the plain version.  It counts its launches by x's dtype
  (:func:`launch_count`).
- :func:`dense_act_plain` is the plain version.
- :func:`dense_act` differentiates through :class:`DenseAct`: K5 forward,
  and the reference's backward (``_mba_bwd``, :101-117) in PyTorch: the
  pre-activation recomputed from bf16 products, the activation's
  derivative, then ``dx``, ``dw`` and ``db`` in x's dtype.  The JAX package
  computes that backward outside any Pallas kernel, so there is no
  backward kernel to port.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ._launches import LaunchCounts

_DTYPES = (torch.float32, torch.bfloat16)

_LAUNCHES = LaunchCounts("dense_epilogue")
_count = _LAUNCHES.count

#: activation name -> the kernel's code (gelu's tanh form is code 3)
ACTS = {"": 0, "relu": 1, "gelu": 2}


def launch_count(kernel: str = "dense_epilogue",
                 dtype: Optional[str] = None) -> int:
    """Launches of K5 with x of ``dtype`` ("float32" or "bfloat16"; None:
    both) since the last :func:`reset_launch_count`."""
    return _LAUNCHES.get(kernel, dtype)


def reset_launch_count() -> None:
    _LAUNCHES.reset()


def _act(y, act, approximate):
    if act == "relu":
        return torch.relu(y)
    if act == "gelu":
        return F.gelu(y, approximate="tanh" if approximate else "none")
    return y


def dense_act_plain(x, w, b, act="", approximate=False):
    """Plain version of K5: bf16-rounded operands multiplied and summed in
    float32, then the bias and the activation."""
    xb = x.to(torch.bfloat16).float()
    wb = w.to(torch.bfloat16).float()
    return _act(xb @ wb + b.float(), act, approximate).to(x.dtype)


def _check(x, w, b, act):
    what = "dense_act"
    if act not in ACTS:
        raise ValueError(f"{what}: activation {act!r} not in {sorted(ACTS)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype not in (_DTYPES if name != "b" else (torch.float32,)):
            raise TypeError(f"{what}: {name} must be float32"
                            f"{' or bfloat16' if name != 'b' else ''}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] or \
            tuple(b.shape) != (w.shape[1],) or min(x.shape + w.shape) == 0:
        raise ValueError(f"{what}: x must be [M, K], w [K, N] and b [N], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {x.device}")


def dense_act_fwd(x, w, b, act="", approximate=False):
    """``act(x @ w + b)`` ``[M, N]`` in x's dtype for contiguous ``x [M,
    K]``, ``w [K, N]`` (each float32 or bf16) and float32 ``b [N]``.
    Launches K5 on the current stream for CUDA tensors; CPU tensors take
    the plain version."""
    _check(x, w, b, act)
    if x.device.type == "cpu":
        return dense_act_plain(x, w, b, act, approximate)
    fwd, scratch_elems = _entry()
    m, k = x.shape
    n = w.shape[1]
    code = 3 if act == "gelu" and approximate else ACTS[act]
    xb, wb = int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    scratch = torch.empty(
        (scratch_elems(x.data_ptr(), w.data_ptr(), m, k, n, xb, wb),),
        dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                  scratch.data_ptr(), m, k, n, code, xb, wb, stream)
    if err != 0:
        raise RuntimeError(f"dense_act kernel launch failed: CUDA error "
                           f"{err}")
    _count("dense_epilogue", x.dtype)
    return y


_entry_fns = []


def _entry():
    if not _entry_fns:
        from . import _build
        lib = _build.load("dense_epilogue")
        fwd = lib.paddle_tpu_torch_dense_act
        fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        scratch = lib.paddle_tpu_torch_dense_act_scratch
        scratch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
        scratch.restype = ctypes.c_longlong
        _entry_fns.extend((fwd, scratch))
    return _entry_fns


class DenseAct(torch.autograd.Function):
    """K5 forward saving ``(x, w, b)``; the backward is the reference's
    ``_mba_bwd``: recompute the pre-activation from bf16 products (a
    bfloat16 product, as ``x.astype(bf16) @ w.astype(bf16)`` gives), take
    the activation's derivative in float32, then
    ``dx = dpre @ wᵀ``, ``dw = xᵀ @ dpre`` in x's dtype, ``db = Σ dpre``."""

    @staticmethod
    def forward(ctx, x, w, b, act, approximate):
        ctx.act, ctx.approximate = act, approximate
        ctx.save_for_backward(x, w, b)
        return dense_act_fwd(x, w, b, act, approximate)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        pre = torch.matmul(x.to(torch.bfloat16),
                           w.to(torch.bfloat16)).float() + b.float()
        dyf = dy.float()
        if ctx.act:
            with torch.enable_grad():
                p = pre.detach().requires_grad_(True)
                dpre, = torch.autograd.grad(
                    _act(p, ctx.act, ctx.approximate), p, dyf)
        else:
            dpre = dyf
        dpre_b = dpre.to(x.dtype)
        dx = dpre_b @ w.t().to(dpre_b.dtype)
        dw = x.t() @ dpre_b
        db = dpre.sum(dim=0)
        return (dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype), None, None)


def dense_act(x, w, b, act="", approximate=False):
    """Differentiable ``act(x @ w + b)`` over ``x [M, K]``, ``w [K, N]``,
    ``b [N]`` (the reference's ``matmul_bias_act``,
    ``dense_epilogue.py:52``)."""
    return DenseAct.apply(x.contiguous(), w.contiguous(), b.contiguous(),
                          act, bool(approximate))
