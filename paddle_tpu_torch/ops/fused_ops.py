"""The fused ops the graph-fusion pass rewrites to (``analysis/fusion.py``;
the port's ``paddle_tpu/ops/fused_ops.py``).

Both are exact compositions of the unfused lowerings they replace (the same
torch calls in the same order), so a fused program trains like the unfused
one on the default path.  The hand-written kernels engage only where the
fusion autotuner measured them faster for the shape at hand (the
``use_pallas`` attr, the reference's name):

- ``fused_dense_act`` runs K5 (``kernels/dense_epilogue.py``) when the
  activation is one the kernel takes ("", relu, gelu) and M is one the TPU
  kernel could tile (M <= 512 or M % 8 == 0, ``dense_epilogue.py:74-81``);
- ``fused_embedding_layer_norm`` runs K4 (``kernels/layer_norm.py``) when
  it normalizes the last dim and both Scale and Bias are present.

These shape rules are decided before any launch.  The reference instead
wraps both kernel calls in ``try/except Exception`` and falls back to the
composition (``fused_ops.py:72-78, 150-155``); the port never catches a
kernel's error.  ``fused_dense_act``'s tagged-dropout tail runs the dropout
kernel (``kernels/dropout.py``) on the tag's stream, after K5 or after the
torch product, whichever the op took.

AMP: the unfused chain casts per op (``amp.cast_ins``: the matmul always
to bf16, the adds, the activation and LayerNorm's X only for activations
of rank 3 or more).  One blanket cast over a fused op would change the
numbers of 2-D activations, so these ops are in no AMP list and apply the
per-stage policy themselves (:func:`_amp_pair`, the reference's
``fused_ops.py:34``).  Under AMP the kernels get bf16 operands: K5 bf16 x
and w, K4 a bf16 x.

Gradients flow through the generic grad op's autograd of these lowerings;
K5's and K4's ``autograd.Function`` s supply their own backward.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.registry import register_op
from ..kernels import dense_epilogue, layer_norm
from ..kernels import dropout as dropout_k
from .common import X, XS, broadcast_to_x
from .nn_ops import dropout_infer, dropout_scale
from .tensor_ops import gather_rows


def _amp_pair(ctx, *arrs):
    """bf16 copies of a value group under AMP (the fused analog of one
    ``amp.cast_ins`` call); the values themselves otherwise."""
    if not ctx.amp:
        return arrs
    return [a.to(torch.bfloat16) if a is not None and a.dtype in (
        torch.float32, torch.float16) else a for a in arrs]


def _k5_tiles(m: int) -> bool:
    """Whether the TPU kernel could tile M rows: a block of min(512, M)
    rows halved until it divides M, down to 8 (``dense_epilogue.py:74``)."""
    return m <= 512 or m % 8 == 0


@register_op("fused_dense_act", stateful_rng=True)
def _fused_dense_act(ctx, ins, attrs):
    """mul/matmul + elementwise_add(bias) + gelu/relu [+ tagged dropout] in
    one op (pattern ``dense_epilogue``).  Under AMP the matmul always runs in bf16 and the
    bias and activation in bf16 only for outputs of rank 3 or more (the
    reference's ``fused_ops.py:58-90``); K5 writes x's dtype, bf16."""
    x, w, b = X(ins, "X"), X(ins, "W"), X(ins, "Bias")
    x, w = _amp_pair(ctx, x, w)
    xnc = int(attrs.get("x_num_col_dims", 1))
    act = attrs.get("act", "") or ""
    approximate = bool(attrs.get("approximate", False))
    xs, ws = tuple(x.shape), tuple(w.shape)
    if xnc >= 0:                         # mul semantics
        x2 = x.reshape(int(np.prod(xs[:xnc])), -1)
        w2 = w.reshape(ws[0], -1)
        out_shape = xs[:xnc] + ws[1:]
    else:                                # matmul semantics (no transpose)
        x2 = x.reshape(int(np.prod(xs[:-1])), xs[-1])
        w2 = w
        out_shape = xs[:-1] + ws[1:]
    if attrs.get("use_pallas") and act in dense_epilogue.ACTS and \
            _k5_tiles(x2.shape[0]):
        out = dense_epilogue.dense_act(x2, w2, b, act, approximate)
    else:
        out = torch.matmul(x2, w2)
        if len(out_shape) >= 3:
            out, b = _amp_pair(ctx, out, b)
        out = out + broadcast_to_x(out, b, int(attrs.get("bias_axis", -1))
                                   if len(out_shape) == out.dim() else -1)
        if act == "gelu":
            out = F.gelu(out, approximate="tanh" if approximate else "none")
        elif act == "relu":
            out = torch.relu(out)
    out = out.reshape(out_shape)
    tag = int(attrs.get("seed", 0))
    if tag:
        # the tagged dropout tail (fused_ops.py:94-112): the dropout op's
        # stream, so the mask is the unfused op's; its backward runs the
        # kernel on the output gradient
        if attrs.get("is_test", False):
            out = dropout_infer(out, attrs)
        else:
            out = dropout_k.dropout(
                out, ctx.rng_tagged(tag),
                dropout_k.threshold(attrs.get("dropout_prob", 0.5)),
                dropout_scale(attrs))
    return {"Out": [out]}


@register_op("fused_embedding_layer_norm")
def _fused_embedding_layer_norm(ctx, ins, attrs):
    """lookup_table [+ elementwise_adds] + layer_norm in one op (pattern
    ``embedding_layer_norm``): the row gather, the adds and the
    normalization.  Mean and Variance always come from the two-pass
    (Welford) variance, as in the reference, not from K4's one-pass
    statistics.  Under AMP the adds and LayerNorm's X are cast to bf16 for
    activations of rank 3 or more (the reference's ``fused_ops.py:134-142``);
    K4 then takes bf16 x."""
    w, ids = X(ins, "W"), X(ins, "Ids")
    scale, bias = X(ins, "Scale"), X(ins, "Bias")
    x = gather_rows(w, ids, attrs.get("padding_idx", -1))
    for a in XS(ins, "Addends"):
        if x.dim() >= 3 or a.dim() >= 3:
            x, a = _amp_pair(ctx, x, a)
        x = x + broadcast_to_x(x, a, -1)
    if x.dim() >= 3:
        x, = _amp_pair(ctx, x)
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    lead = tuple(x.shape[:begin])
    x2 = x.reshape(int(np.prod(lead)), -1)
    xf = x2.float()
    if attrs.get("use_pallas") and begin == x.dim() - 1 and \
            scale is not None and bias is not None:
        # the two-pass (Welford) variance and the mean in one reduction
        v, m = torch.var_mean(xf, dim=1, unbiased=False, keepdim=True)
        y = layer_norm.fused_layer_norm(x2, scale, bias, eps)
    else:                                # the layer_norm lowering
        m = xf.mean(dim=1, keepdim=True)
        v = xf.var(dim=1, unbiased=False, keepdim=True)
        y = (x2 - m.to(x2.dtype)) * torch.rsqrt(v + eps).to(x2.dtype)
        if scale is not None:
            y = y * scale.to(y.dtype).reshape(1, -1)
        if bias is not None:
            y = y + bias.to(y.dtype).reshape(1, -1)
    return {"Out": [y.reshape(x.shape).to(x.dtype)],
            "Mean": [m.reshape(lead)], "Variance": [v.reshape(lead)]}
