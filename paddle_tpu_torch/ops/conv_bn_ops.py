"""The fused train-time conv(1x1) + batch_norm op, the rewrite target of
the graph-fusion pass (``analysis/fusion.py``; the port's
``paddle_tpu/ops/conv_bn_ops.py``).

``fused_conv1x1_bn`` computes exactly what conv2d (1x1, bias-free) →
batch_norm (train) [→ relu] computes: the same Y, MeanOut, VarianceOut,
SavedMean and SavedVariance (as 1/sqrt(var + eps)), the same running-stat
updates.  On the card the 1x1 conv and the BN sums come from one kernel,
K3 (``kernels/conv_bn.py``), with bf16 operands as on the TPU (under AMP x
arrives in bf16 and y leaves in bf16); on the host the reference's own
formula runs (an einsum, in bf16 under AMP as conv2d's white-listed cast
gives it, else in float32, then float32 sums).
Gradients flow through the generic grad op's autograd of this lowering.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from ..kernels import conv_bn
from .common import X


@register_op("fused_conv1x1_bn")
def _fused_conv1x1_bn(ctx, ins, attrs):
    x = X(ins, "X")                       # [N, C, H, W]
    filt = X(ins, "Filter")               # [Cout, Cin, 1, 1]
    scale, bias = X(ins, "Scale"), X(ins, "Bias")
    mean, var = X(ins, "Mean"), X(ins, "Variance")
    momentum = attrs.get("momentum", 0.9)
    eps = attrs.get("epsilon", 1e-5)
    act = attrs.get("act", "") or ""
    stride = attrs.get("stride", 1)
    use_global = attrs.get("use_global_stats", False) or \
        attrs.get("is_test", False)

    cout, cin = filt.shape[0], filt.shape[1]
    if stride > 1:
        # the strided shortcut: the kernel takes the pixels it reads as a
        # contiguous copy (reshape below)
        x = x[:, :, ::stride, ::stride]
    nb, _, h, w = x.shape
    m = nb * h * w
    w2 = filt.reshape(cout, cin)
    xf = x.reshape(nb, cin, h * w)

    if use_global:
        # frozen: BN folded into the weights, no statistics pass
        inv = torch.rsqrt(var + eps)
        wf = (w2 * (inv * scale)[:, None]).to(w2.dtype)
        y = torch.einsum("oc,ncp->nop", wf, xf)
        y = y + (bias - mean * inv * scale).to(y.dtype)[None, :, None]
        saved_m, saved_v = mean, torch.rsqrt(var + eps)
        mean_out, var_out = mean, var
    else:
        if xf.device.type == "cuda":
            y_raw, s, s2 = conv_bn.conv1x1_stats(xf, w2)      # K3
        else:
            # the reference's host formula (conv_bn_ops.py:59-73): the
            # product in bf16 under AMP (conv2d is white-listed), else in
            # float32; float32 sums
            mm_w, mm_x = w2, xf
            if ctx.amp:
                mm_w, mm_x = w2.to(torch.bfloat16), xf.to(torch.bfloat16)
            y_raw = torch.einsum("oc,ncp->nop", mm_w, mm_x)
            yf = y_raw.float()
            s = torch.sum(yf, dim=(0, 2))
            s2 = torch.sum(torch.square(yf), dim=(0, 2))
        mu = s / m
        v = torch.clamp(s2 / m - torch.square(mu), min=0.0)
        inv = torch.rsqrt(v + eps)
        a = inv * scale
        b = bias - mu * a
        y = y_raw * a.to(y_raw.dtype)[None, :, None] \
            + b.to(y_raw.dtype)[None, :, None]
        saved_m, saved_v = mu, torch.rsqrt(v + eps)
        mean_out = mean * momentum + mu * (1 - momentum)
        var_out = var * momentum + v * (1 - momentum)
    if act == "relu":
        y = torch.relu(y)
    return {"Y": [y.reshape(nb, cout, h, w)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [saved_m],
            "SavedVariance": [saved_v]}
