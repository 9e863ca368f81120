"""Tensor creation / manipulation op lowerings (the subset of
``paddle_tpu/ops/tensor_ops.py`` the serving and training slices run).

Reference kernels: ``operators/fill_constant_op.cc``, ``uniform_random_op.cc``,
``gaussian_random_op.cc``, ``truncated_gaussian_random_op.cc``,
``increment_op.cc``, ``top_k_op.cc``, ``split_op.cc``, ``reshape_op.cc``
(reshape2), ``transpose_op.cc``, ``unsqueeze_op.cc``, ``flatten_op.cc``
(flatten2), ``concat_op.cc``, ``scale_op.cc``,
``lookup_table_op.cc``, ``range_op.cc``, ``expand_op.cc``, ``slice_op.cc``,
``sum_op.cc`` (the grad fan-in of ``append_backward``), ``assign_op.cc``,
``assign_value_op.cc``, ``gather_op.cc``.  Shape-only ops return views where torch
can; a consumer that needs contiguous memory asks for it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.registry import register_op
from .common import X, XS, canon_dtype, host_values, static_int


@register_op("fill_constant", no_grad=True)
def _fill_constant(ctx, ins, attrs):
    shape = attrs.get("shape", [])
    shape_t = X(ins, "ShapeTensor")
    if shape_t is not None:
        shape = [int(s) for s in host_values(shape_t,
                                             "fill_constant ShapeTensor")]
    dtype = canon_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(tuple(shape), attrs.get("value", 0.0),
                               dtype=dtype, device=ctx.device)]}


@register_op("uniform_random", no_grad=True, stateful_rng=True)
def _uniform_random(ctx, ins, attrs):
    """U[min, max) from the run's generator.  Draws differ from the
    reference's jax keys; range and shape agree."""
    shape = tuple(attrs.get("shape", []))
    dtype = canon_dtype(attrs.get("dtype", "float32"))
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = torch.rand(shape, generator=ctx.generator, device=ctx.device,
                     dtype=torch.float32)
    return {"Out": [(out * (hi - lo) + lo).to(dtype)]}


@register_op("gaussian_random", no_grad=True, stateful_rng=True)
def _gaussian_random(ctx, ins, attrs):
    """N(mean, std²) from the run's generator.  Draws differ from the
    reference's jax keys; shape, dtype and distribution agree."""
    shape = tuple(attrs.get("shape", []))
    dtype = canon_dtype(attrs.get("dtype", "float32"))
    out = torch.randn(shape, generator=ctx.generator, device=ctx.device,
                      dtype=torch.float32)
    out = out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": [out.to(dtype)]}


@register_op("truncated_gaussian_random", no_grad=True, stateful_rng=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    """N(mean, std²) truncated at two standard deviations (ref
    ``tensor_ops.py:58-65``), by the inverse normal CDF of a uniform draw
    from the run's generator between the CDF's values at -2 and 2.  Draws
    differ from the reference's jax keys; shape, dtype, bounds and
    distribution agree."""
    shape = tuple(attrs.get("shape", []))
    dtype = canon_dtype(attrs.get("dtype", "float32"))
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=ctx.generator, device=ctx.device,
                   dtype=torch.float32)
    z = (torch.erfinv(lo + (hi - lo) * u) * math.sqrt(2.0)).clamp_(-2.0, 2.0)
    out = z * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": [out.to(dtype)]}


@register_op("increment")
def _increment(ctx, ins, attrs):
    """x + step in x's dtype (ref ``tensor_ops.py:428``)."""
    x = X(ins, "X")
    return {"Out": [x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype,
                                     device=x.device)]}


@register_op("top_k", no_grad=True)
def _top_k(ctx, ins, attrs):
    """The k largest values along the last axis and their int64 indices
    (ref ``tensor_ops.py:476``); ties keep the lower index first."""
    x = X(ins, "X")
    k = attrs.get("k", 1)
    kt = X(ins, "K")
    if kt is not None:
        k = static_int(kt, "top_k K")
    # a stable descending sort, as lax.top_k orders ties (torch.topk
    # leaves their order unspecified)
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


@register_op("cast")
def _cast(ctx, ins, attrs):
    return {"Out": [X(ins, "X").to(canon_dtype(attrs["out_dtype"]))]}


@register_op("split")
def _split(ctx, ins, attrs):
    x = X(ins, "X")
    axis = attrs.get("axis", 0)
    num = attrs.get("num", 0)
    sections = attrs.get("sections", [])
    if sections:
        outs = torch.split(x, list(sections), dim=axis)
    else:
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {axis} of size {x.shape[axis]} "
                             f"does not divide into {num} equal parts")
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(outs)}


def _resolve_shape(x, shape):
    shape = list(shape)
    numel = int(np.prod(x.shape)) if x.dim() else 1
    for i, s in enumerate(shape):
        if s == 0:               # fluid: 0 means copy input dim
            shape[i] = x.shape[i]
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = numel // known
    return tuple(shape)


def _xshape(x):
    # the reference's XShape output: a zero-size tensor recording x's shape
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_op("reshape2")
def _reshape2(ctx, ins, attrs):
    x = X(ins, "X")
    st = X(ins, "ShapeTensor")
    if st is None:
        st = X(ins, "Shape")
    shape = attrs.get("shape", [])
    if st is not None:
        shape = [int(s) for s in host_values(st, "reshape2 ShapeTensor")]
    return {"Out": [x.reshape(_resolve_shape(x, shape))],
            "XShape": [_xshape(x)]}


@register_op("unsqueeze2")
def _unsqueeze2(ctx, ins, attrs):
    x = X(ins, "X")
    out = x
    for a in sorted(attrs.get("axes", [])):
        out = out.unsqueeze(a)
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("transpose2")
def _transpose2(ctx, ins, attrs):
    x = X(ins, "X")
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [_xshape(x)]}


@register_op("flatten2")
def _flatten2(ctx, ins, attrs):
    """[prod(shape[:axis]), prod(shape[axis:])] (ref ``tensor_ops.py:159``)."""
    x = X(ins, "X")
    axis = attrs.get("axis", 1)
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return {"Out": [x.reshape(lead, -1)], "XShape": [_xshape(x)]}


register_op("flatten", _flatten2)


@register_op("concat")
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(XS(ins, "X"), dim=attrs.get("axis", 0))]}


@register_op("scale")
def _scale(ctx, ins, attrs):
    x = X(ins, "X")
    s = attrs.get("scale", 1.0)
    st = X(ins, "ScaleTensor")
    if st is not None:
        s = st
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        out = x * s + b
    else:
        out = (x + b) * s
    return {"Out": [out.to(x.dtype)]}


def gather_rows(w, ids, padding_idx=-1):
    """The rows of ``w`` at ``ids`` (a trailing dim of 1 squeezed), with the
    reference's ``jnp.take`` semantics: ids in [-V, 0) wrap, ids outside
    [-V, V) give NaN rows, the ``padding_idx`` row reads zeros.  Ids come
    from requests: an index past the table must not reach the gather, where
    the card would fault."""
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    n = w.shape[0]
    valid = (ids >= -n) & (ids < n)
    out = w[torch.where(valid, ids.remainder(n), torch.zeros_like(ids))]
    # in place on the fresh gather: masked_fill would copy it first
    out.masked_fill_(~valid[..., None], float("nan"))
    if padding_idx is not None and padding_idx != -1:
        out.masked_fill_((ids == padding_idx)[..., None], 0.0)
    return out


@register_op("lookup_table")
def _lookup_table(ctx, ins, attrs):
    return {"Out": [gather_rows(X(ins, "W"), X(ins, "Ids"),
                                attrs.get("padding_idx", -1))]}


# the dygraph ``Embedding``'s op (ref ``tensor_ops.py:300``)
register_op("lookup_table_v2", _lookup_table)


@register_op("range", no_grad=True)
def _range(ctx, ins, attrs):
    def bound(slot, default):
        t = X(ins, slot)
        if t is None:
            return attrs.get(slot.lower(), default)
        return float(host_values(t, f"range {slot}")[0])
    s, e, st = bound("Start", 0), bound("End", None), bound("Step", 1)
    dtype = canon_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.arange(s, e, st, dtype=dtype, device=ctx.device)]}


@register_op("expand")
def _expand(ctx, ins, attrs):
    x = X(ins, "X")
    times = list(attrs["expand_times"])
    if len(times) < x.dim():      # np.tile pads the repeats with leading 1s
        times = [1] * (x.dim() - len(times)) + times
    return {"Out": [x.repeat(*times)]}


@register_op("slice")
def _slice(ctx, ins, attrs):
    x = X(ins, "Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, max(e, s))
    out = x[tuple(idx)]
    for a in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out.squeeze(a)
    return {"Out": [out]}


@register_op("sum")
def _sum(ctx, ins, attrs):
    xs = XS(ins, "X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("assign")
def _assign(ctx, ins, attrs):
    return {"Out": [X(ins, "X")]}


@register_op("assign_value", no_grad=True)
def _assign_value(ctx, ins, attrs):
    """A constant from the op's attrs (ref ``tensor_ops.py:200``)."""
    return {"Out": [torch.tensor(
        attrs["values"], dtype=canon_dtype(attrs.get("dtype", "float32")),
        device=ctx.device).reshape(tuple(attrs["shape"]))]}


@register_op("gather")
def _gather(ctx, ins, attrs):
    """``jnp.take(x, index, axis)`` (ref ``tensor_ops.py:242``): an index
    of shape [n, 1] is squeezed; indices in [-n, 0) wrap, and outside
    [-n, n) give NaN (float x), as :func:`gather_rows`.  Its gradient is
    the generic autograd one (a scatter-add)."""
    x, idx = X(ins, "X"), X(ins, "Index")
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    axis = attrs.get("axis", 0)
    axis = axis + x.dim() if axis < 0 else axis
    n = x.shape[axis]
    valid = (idx >= -n) & (idx < n)
    safe = torch.where(valid, idx.remainder(n), torch.zeros_like(idx))
    out = torch.index_select(x, axis, safe.reshape(-1)).reshape(
        tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))
    if x.is_floating_point():
        out = out.masked_fill(~valid.reshape(
            (1,) * axis + tuple(idx.shape) + (1,) * (x.dim() - axis - 1)),
            float("nan"))
    return {"Out": [out]}


# -- the shape ops the recurrent and decoding layers build with (ref
# tensor_ops.py:132-183, 411, 539) -------------------------------------------

@register_op("squeeze2")
def _squeeze2(ctx, ins, attrs):
    """The listed axes of size 1 dropped (all of size 1 when none are
    listed), as ``jnp.squeeze`` (ref ``tensor_ops.py:132``)."""
    x = X(ins, "X")
    axes = attrs.get("axes", [])
    if axes:
        keep = [a + x.dim() if a < 0 else a for a in axes]
        keep = [a for a in keep if x.shape[a] == 1]
        shape = [d for i, d in enumerate(x.shape) if i not in keep]
    else:
        shape = [d for d in x.shape if d != 1]
    return {"Out": [x.reshape(shape)], "XShape": [_xshape(x)]}


register_op("squeeze", _squeeze2)
register_op("unsqueeze", _unsqueeze2)
register_op("transpose", _transpose2)


@register_op("stack")
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(XS(ins, "X"), dim=attrs.get("axis", 0))]}


@register_op("reverse")
def _reverse(ctx, ins, attrs):
    return {"Out": [torch.flip(X(ins, "X"), dims=list(attrs["axis"]))]}


@register_op("fill_constant_batch_size_like", no_grad=True)
def _fill_constant_batch_size_like(ctx, ins, attrs):
    """A constant whose ``output_dim_idx`` dim is the ``input_dim_idx`` dim
    of ``Input`` (ref ``tensor_ops.py:539``)."""
    ref = X(ins, "Input")
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return {"Out": [torch.full(tuple(shape), attrs.get("value", 0.0),
                               dtype=canon_dtype(attrs["dtype"]),
                               device=ref.device)]}


@register_op("fill_any_like", no_grad=True)
def _fill_any_like(ctx, ins, attrs):
    """X's shape filled with ``value``, in ``dtype`` or X's (ref
    ``tensor_ops.py:34``)."""
    x = X(ins, "X")
    dtype = attrs.get("dtype", None)
    d = x.dtype if dtype in (None, -1) else canon_dtype(dtype)
    return {"Out": [torch.full(tuple(x.shape), attrs.get("value", 0.0),
                               dtype=d, device=x.device)]}
