"""Reduction op lowerings (``paddle_tpu/ops/reduce_ops.py``; ref
``operators/reduce_ops/``).  A reduction over no axes (a 0-d input) returns
the input, as ``jnp.sum`` does."""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from .common import X, reduce_axes


def _reduce(fn, x, axes, keep):
    if not axes:
        return x
    return fn(x, dim=axes, keepdim=keep)


def _amax(x, dim, keepdim):
    return torch.amax(x, dim=dim, keepdim=keepdim)


def _amin(x, dim, keepdim):
    return torch.amin(x, dim=dim, keepdim=keepdim)


def _prod(x, dim, keepdim):
    for a in sorted(dim, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim)
    return x


def _all(x, dim, keepdim):
    return torch.all(x, dim=dim, keepdim=keepdim)


def _any(x, dim, keepdim):
    return torch.any(x, dim=dim, keepdim=keepdim)


_REDUCE = {
    "reduce_sum": torch.sum,
    "reduce_mean": torch.mean,
    "reduce_max": _amax,
    "reduce_min": _amin,
    "reduce_prod": _prod,
}


def _make_reduce(name, fn, no_grad=False):
    def lower(ctx, ins, attrs):
        x = X(ins, "X")
        axes = reduce_axes(attrs.get("dim"), x.dim(),
                           attrs.get("reduce_all", False))
        return {"Out": [_reduce(fn, x, axes, attrs.get("keep_dim", False))]}
    register_op(name, lower, no_grad=no_grad)


for _n, _f in _REDUCE.items():
    _make_reduce(_n, _f)
_make_reduce("reduce_all", _all, no_grad=True)
_make_reduce("reduce_any", _any, no_grad=True)


@register_op("mean")
def _mean(ctx, ins, attrs):
    """The mean of all elements, a 0-d tensor (ref ``reduce_ops.py:52``)."""
    return {"Out": [torch.mean(X(ins, "X"))]}
