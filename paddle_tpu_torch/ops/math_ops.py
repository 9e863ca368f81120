"""Math op lowerings: elementwise binaries, activations, mul/matmul,
comparisons and the gradient-clipping ops (the subset of
``paddle_tpu/ops/math_ops.py`` the serving and training slices run).

Reference kernels: ``operators/elementwise/``, ``operators/activation_op.cc``,
``operators/mul_op.cc``, ``operators/matmul_op.cc``,
``operators/controlflow/compare_op.cc``, ``operators/clip_op.cc``.  The products go to
``torch.matmul``: float32 stays float32 on the card (TF32 off, the port's
precision policy).
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.registry import register_op
from .common import X, broadcast_to_x

# -- elementwise binary (ref operators/elementwise/*.cc) ---------------------

_ELEMENTWISE = {
    "elementwise_add": torch.add,
    "elementwise_sub": torch.sub,
    "elementwise_mul": torch.mul,
    "elementwise_div": torch.div,
    "elementwise_pow": torch.pow,
    "elementwise_min": torch.minimum,
    "elementwise_max": torch.maximum,
    # the sign of the divisor, as jnp.mod (Python's %)
    "elementwise_mod": torch.remainder,
}


def _make_elementwise(name, fn):
    def lower(ctx, ins, attrs):
        x, y = X(ins, "X"), X(ins, "Y")
        y = broadcast_to_x(x, y, attrs.get("axis", -1))
        return {"Out": [fn(x, y)]}
    register_op(name, lower)


for _n, _f in _ELEMENTWISE.items():
    _make_elementwise(_n, _f)


# -- activations (ref operators/activation_op.h table) -----------------------

def _make_activation(name, fn):
    def lower(ctx, ins, attrs):
        return {"Out": [fn(X(ins, "X"))]}
    register_op(name, lower)


_make_activation("relu", torch.relu)
_make_activation("sign", torch.sign)
_make_activation("sqrt", torch.sqrt)
_make_activation("sigmoid", torch.sigmoid)
_make_activation("square", torch.square)
_make_activation("tanh", torch.tanh)
_make_activation("log", torch.log)


@register_op("gelu")
def _gelu(ctx, ins, attrs):
    """Exact erf form by default, tanh form under ``approximate``."""
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [torch.nn.functional.gelu(X(ins, "X"), approximate=approx)]}


@register_op("prelu")
def _prelu(ctx, ins, attrs):
    """ref ``math_ops.py:194``: ``alpha`` one scalar (``all``), one a
    channel (``channel``) or one an element of a sample (``element``)."""
    x, alpha = X(ins, "X"), X(ins, "Alpha")
    mode = attrs.get("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "all":
        alpha = alpha.reshape(())
    return {"Out": [torch.where(x >= 0, x, alpha * x)]}


# -- matmul family -----------------------------------------------------------

@register_op("mul")
def _mul(ctx, ins, attrs):
    """ref operators/mul_op.cc: flatten X to 2-D at x_num_col_dims, ditto Y."""
    x, y = X(ins, "X"), X(ins, "Y")
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xnc])), -1)
    y2 = y.reshape(int(np.prod(ys[:ync])), -1)
    return {"Out": [torch.matmul(x2, y2).reshape(xs[:xnc] + ys[ync:])]}


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    x, y = X(ins, "X"), X(ins, "Y")
    tx, ty = attrs.get("transpose_X", False), attrs.get("transpose_Y", False)
    alpha = attrs.get("alpha", 1.0)
    if x.dim() == 1:
        x = x[None, :]
    if y.dim() == 1:
        y = y[:, None]
    if tx:
        x = x.transpose(-1, -2)
    if ty:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    """ref ``math_ops.py:280``: ``out[b, o] = x[b] W[o] y[b]^T + bias[o]``."""
    x, y, w = X(ins, "X"), X(ins, "Y"), X(ins, "Weight")
    bias = X(ins, "Bias")
    out = torch.einsum("bi,oij,bj->bo", x, w, y)
    if bias is not None:
        out = out + bias
    return {"Out": [out]}


# -- comparisons (no gradient) -----------------------------------------------

_COMPARE = {
    "less_than": torch.lt, "less_equal": torch.le,
    "greater_than": torch.gt, "greater_equal": torch.ge,
    "equal": torch.eq, "not_equal": torch.ne,
}


def _make_compare(name, fn):
    def lower(ctx, ins, attrs):
        x, y = X(ins, "X"), X(ins, "Y")
        y = broadcast_to_x(x, y, attrs.get("axis", -1))
        return {"Out": [fn(x, y)]}
    register_op(name, lower, no_grad=True)


for _n, _f in _COMPARE.items():
    _make_compare(_n, _f)


# -- logical ops (ref operators/controlflow/logical_op.cc) -------------------

def _make_logical(name, fn):
    def lower(ctx, ins, attrs):
        return {"Out": [fn(X(ins, "X"), X(ins, "Y"))]}
    register_op(name, lower, no_grad=True)


for _n, _f in (("logical_and", torch.logical_and),
               ("logical_or", torch.logical_or),
               ("logical_xor", torch.logical_xor)):
    _make_logical(_n, _f)

register_op("logical_not",
            lambda ctx, ins, attrs: {"Out": [torch.logical_not(X(ins, "X"))]},
            no_grad=True)


@register_op("is_empty", no_grad=True)
def _is_empty(ctx, ins, attrs):
    """Whether X has no element (ref ``math_ops.py:340``): read off its
    shape, so no value is read."""
    x = X(ins, "X")
    return {"Out": [torch.tensor(x.numel() == 0, device=x.device)]}


# -- gradient clipping (ref operators/clip_op.cc, clip_by_norm_op.cc) --------

@register_op("clip")
def _clip(ctx, ins, attrs):
    return {"Out": [torch.clamp(X(ins, "X"), attrs["min"], attrs["max"])]}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    x = X(ins, "X")
    mn = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": [torch.where(norm > mn, x * (mn / norm), x)]}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(torch.square(X(ins, "X"))).reshape(1)]}
