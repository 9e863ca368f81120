"""Shared helpers for op lowerings (the port's ``paddle_tpu/ops/common.py``)."""

from __future__ import annotations

import numpy as np
import torch


def X(ins, slot, i=0, default=None):
    """Fetch the i-th input of a slot, tolerating absent/empty slots."""
    v = ins.get(slot)
    if not v or i >= len(v) or v[i] is None:
        return default
    return v[i]


def XS(ins, slot):
    return [a for a in ins.get(slot, []) if a is not None]


def broadcast_to_x(x, y, axis=-1):
    """Fluid elementwise broadcast: y's shape is a contiguous slice of x's
    starting at ``axis`` (ref ``operators/elementwise/elementwise_op_function.h``)."""
    if y.dim() == 0 or y.shape == x.shape:
        return y
    if axis == -1:
        axis = x.dim() - y.dim()
    trail = x.dim() - axis - y.dim()
    if trail < 0:
        return y
    return y.reshape((1,) * axis + tuple(y.shape) + (1,) * trail)


def canon_dtype(name) -> torch.dtype:
    """torch dtype for a declared dtype name.  Unlike the reference, which
    runs with x64 off and narrows int64/float64 to 32 bits, the port keeps
    64-bit types: ids stay int64 (results agree for values inside the
    int32 range)."""
    return getattr(torch, np.dtype(name).name if name != "bfloat16"
                   else "bfloat16")


def host_values(x, what):
    """The values of a tensor input the lowering needs as Python numbers (a
    shape, a range bound).  Shape inference runs on meta tensors, which
    hold no value: there this raises, and the op's outputs stay unshaped
    until it runs (the reference's ``static_int`` contract)."""
    if x.device.type == "meta":
        raise TypeError(f"{what} is read from a tensor; its value is only "
                        "known at run time")
    return x.reshape(-1).tolist()


def static_int(x, what, default=None):
    """An integer read from an optional one-element tensor input (the
    reference's ``static_int``): ``default`` when absent, and it raises
    during shape inference."""
    if x is None:
        return default
    return int(host_values(x, what)[0])


def canon_axis(axis, ndim):
    return axis + ndim if axis < 0 else axis


def reduce_axes(dim, ndim, reduce_all):
    """The axes a ``reduce_*`` op reduces (the reference's ``reduce_axes``)."""
    if reduce_all or dim is None:
        return tuple(range(ndim))
    if isinstance(dim, int):
        dim = [dim]
    return tuple(canon_axis(d, ndim) for d in dim)
