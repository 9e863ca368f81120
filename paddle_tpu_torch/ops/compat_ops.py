"""The fused ops the inference passes rewrite to (the port's part of
``paddle_tpu/ops/compat_ops.py``): ``conv2d_fusion`` (:846) and the
serving canonicalizations ``fusion_squared_mat_sub`` (:610),
``fusion_repeated_fc_relu`` (:622) and ``fusion_transpose_flatten_concat``
(:699), and three types the dygraph layers trace: ``sequence_conv``
(:381), ``conv3d_transpose`` (:826) and ``spectral_norm`` (:863).

The reference computes each as a composition of its plain lowerings, with
no Pallas kernel (``compat_ops.py:599-604``), and so does the port: the
products go to ``torch.matmul`` and the convolution to the port's
``conv2d`` lowering (cuDNN on the card).  The recurrent and sequence fused
ops (``fusion_gru``, ``fusion_lstm``, ``fused_embedding_fc_lstm``,
``fusion_seqconv_eltadd_relu``, ``fusion_seqpool_concat``) wait for their
base op types.
"""

from __future__ import annotations

import torch

from ..framework.registry import get_op_info, register_op
from .common import X, XS

_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}


@register_op("conv2d_fusion")
def _conv2d_fusion(ctx, ins, attrs):
    """ref fused/conv2d_fusion_op.cc: conv + bias + (residual) + act."""
    out = get_op_info("conv2d").lower(ctx, ins, attrs)["Output"][0]
    b = X(ins, "Bias")
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    res = X(ins, "ResidualData")
    if res is not None:
        out = out + res
    act = attrs.get("activation", "relu")
    if act and act != "identity":
        if act not in _ACTS:
            raise NotImplementedError(f"conv2d_fusion activation {act!r}")
        out = _ACTS[act](out)
    return {"Output": [out]}


@register_op("fusion_squared_mat_sub")
def _fusion_squared_mat_sub(ctx, ins, attrs):
    """ref fused/fusion_squared_mat_sub_op.cc:
    out = scalar · ((XY)² − X²Y²)."""
    x, y = X(ins, "X"), X(ins, "Y")
    xy = torch.matmul(x, y)
    x2y2 = torch.matmul(torch.square(x), torch.square(y))
    out = attrs.get("scalar", 1.0) * (torch.square(xy) - x2y2)
    return {"SquaredXY": [torch.square(xy)], "SquaredX": [torch.square(x)],
            "SquaredY": [torch.square(y)], "Out": [out]}


@register_op("fusion_repeated_fc_relu")
def _fusion_repeated_fc_relu(ctx, ins, attrs):
    """ref fused/fusion_repeated_fc_relu_op.cc: a chain of fc + relu."""
    x = X(ins, "X")
    ws, bs = XS(ins, "W"), XS(ins, "Bias")
    outs = []
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = torch.matmul(x.reshape(x.shape[0], -1), w) + b.reshape(1, -1)
        if i < len(ws) - 1:
            x = torch.relu(x)
        outs.append(x)
    return {"ReluOut": outs[:-1], "Out": [torch.relu(outs[-1])]}


@register_op("fusion_transpose_flatten_concat")
def _fusion_transpose_flatten_concat(ctx, ins, attrs):
    """ref fused/fusion_transpose_flatten_concat_op.cc."""
    perm = attrs.get("trans_axis", [0, 2, 3, 1])
    axis = attrs.get("concat_axis", 1)
    flat = [x.permute(*perm).reshape(x.shape[0], -1) for x in XS(ins, "X")]
    return {"Out": [torch.cat(flat, dim=axis if axis < 2 else 1)]}


# -- the sequence and conv stragglers the dygraph layers trace ---------------

@register_op("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """ref ``compat_ops.py:381`` (operators/sequence_conv_op.cc): a window
    of ``contextLength`` rows from ``contextStart`` on, zero past either
    end, projected by ``Filter``.  Dense ``[b, t, d]`` input."""
    x, w = X(ins, "X"), X(ins, "Filter")
    # both attr spellings exist in the reference (op proto snake_case,
    # Python layer camelCase)
    clen = attrs.get("contextLength", attrs.get("context_length", 3))
    cstart = attrs.get("contextStart",
                       attrs.get("context_start", -(clen // 2)))
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    cols = []
    for o in range(clen):
        shift = cstart + o
        keep = ((pos + shift >= 0) & (pos + shift < t)).to(x.dtype)
        cols.append(torch.roll(x, -shift, dims=1) * keep[None, :, None])
    return {"Out": [torch.cat(cols, dim=-1) @ w]}


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    """ref ``compat_ops.py:826`` (operators/conv_transpose_op.cc, 3-D)."""
    from .nn_ops import conv_transpose_nd
    x, w = X(ins, "Input"), X(ins, "Filter")
    out = conv_transpose_nd(x, w, list(attrs.get("strides", [1, 1, 1])),
                            list(attrs.get("paddings", [0, 0, 0])),
                            list(attrs.get("dilations", [1, 1, 1])),
                            attrs.get("groups", 1) or 1, 3)
    return {"Output": [out]}


@register_op("spectral_norm")
def _spectral_norm(ctx, ins, attrs):
    """ref ``compat_ops.py:863`` (operators/spectral_norm_op.cc): the
    weight over its largest singular value, estimated by power iteration
    from the stored ``U`` / ``V``; the gradient runs through the
    iteration, as the reference's does."""
    w, u, v = X(ins, "Weight"), X(ins, "U"), X(ins, "V")
    dim = attrs.get("dim", 0)
    eps = attrs.get("eps", 1e-12)
    perm = [dim] + [i for i in range(w.dim()) if i != dim]
    mat = w.permute(perm).reshape(w.shape[dim], -1)
    u = u.reshape(-1)
    for _ in range(max(attrs.get("power_iters", 1), 0)):
        v = mat.T @ u
        v = v / (torch.linalg.norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.norm(u) + eps)
    sigma = u.reshape(-1) @ mat @ v.reshape(-1)
    return {"Out": [w / sigma]}
