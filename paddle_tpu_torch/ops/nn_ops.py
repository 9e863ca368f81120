"""Conv, pooling, normalization, softmax, loss and dropout lowerings (the
subset of ``paddle_tpu/ops/nn_ops.py`` the serving, training, ResNet and
dygraph slices run).

Convs lower to ``torch.nn.functional.conv2d`` (cuDNN on the card, TF32 off
under the port's float32 policy), as the reference leaves them to
``lax.conv_general_dilated``; data stays NCHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..framework.core import grad_var_name
from ..framework.registry import register_op
from ..kernels import dropout as dropout_k
from .common import X, broadcast_to_x


# ---------------------------------------------------------------------------
# conv and pooling
# ---------------------------------------------------------------------------

def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


@register_op("conv2d")
def _conv2d(ctx, ins, attrs):
    """ref ``nn_ops.py:39``: NCHW input, OIHW filter, symmetric padding."""
    x, w = X(ins, "Input"), X(ins, "Filter")
    out = F.conv2d(x, w.to(x.dtype), stride=_pair(attrs.get("strides", 1)),
                   padding=_pair(attrs.get("paddings", 0)),
                   dilation=_pair(attrs.get("dilations", 1)),
                   groups=attrs.get("groups", 1) or 1)
    return {"Output": [out]}


@register_op("conv3d")
def _conv3d(ctx, ins, attrs):
    """ref ``nn_ops.py:65``: NCDHW input, OIDHW filter."""
    x, w = X(ins, "Input"), X(ins, "Filter")
    out = F.conv3d(x, w.to(x.dtype), stride=_pair(attrs.get("strides", 1), 3),
                   padding=_pair(attrs.get("paddings", 0), 3),
                   dilation=_pair(attrs.get("dilations", 1), 3),
                   groups=attrs.get("groups", 1) or 1)
    return {"Output": [out]}


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def conv_transpose_nd(x, w, strides, pads, dils, groups, nd):
    """The transposed convolution (the vjp of the forward conv with
    respect to its input, ref ``nn_ops.py:79-98``); ``w`` is
    ``[in, out / groups, k...]``, the fluid filter layout and torch's."""
    return _CONV_T[nd](x, w.to(x.dtype), stride=list(strides),
                       padding=list(pads), dilation=list(dils),
                       groups=groups)


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    """ref ``nn_ops.py:101``."""
    x, w = X(ins, "Input"), X(ins, "Filter")
    out = conv_transpose_nd(x, w, _pair(attrs.get("strides", 1)),
                            _pair(attrs.get("paddings", 0)),
                            _pair(attrs.get("dilations", 1)),
                            attrs.get("groups", 1) or 1, 2)
    return {"Output": [out]}


def _pool_extra(dim, k, s, p, ceil_mode):
    """ceil_mode: the extra right/bottom padding that makes the window
    count ceil (ref ``math/pooling.cc`` output-size arithmetic)."""
    if not ceil_mode:
        return 0
    out_ceil = -(-(dim + 2 * p - k) // s) + 1
    return max(0, (out_ceil - 1) * s + k - dim - 2 * p)


def _pool2d_impl(x, ksize, strides, pads, pooling_type, global_pooling,
                 adaptive, exclusive, ceil_mode=False):
    """ref ``nn_ops.py:117``: max pooling pads with -inf; average pooling
    divides by the window size, or with ``exclusive`` by the number of
    unpadded elements in the window."""
    n, c, h, w = x.shape
    if global_pooling or (adaptive and tuple(ksize) == (1, 1)):
        if pooling_type == "max":
            return torch.amax(x, dim=(2, 3), keepdim=True)
        return torch.mean(x, dim=(2, 3), keepdim=True)
    if adaptive:
        oh, ow = ksize
        if h % oh or w % ow:
            raise NotImplementedError("adaptive pool needs divisible sizes")
        xr = x.reshape(n, c, oh, h // oh, ow, w // ow)
        if pooling_type == "max":
            return torch.amax(xr, dim=(3, 5))
        return torch.mean(xr, dim=(3, 5))
    kh, kw = ksize
    sh, sw = strides
    ph, pw = pads
    eh = _pool_extra(h, kh, sh, ph, ceil_mode)
    ew = _pool_extra(w, kw, sw, pw, ceil_mode)
    k, s = (kh, kw), (sh, sw)
    if pooling_type == "max":
        if not (eh or ew) and 2 * ph <= kh and 2 * pw <= kw:
            # torch pads max pooling with -inf itself
            return F.max_pool2d(x, k, s, padding=(ph, pw))
        low = float("-inf") if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        xp = F.pad(x, (pw, pw + ew, ph, ph + eh), value=low)
        return F.max_pool2d(xp, k, s)
    if not (eh or ew) and 2 * ph <= kh and 2 * pw <= kw:
        return F.avg_pool2d(x, k, s, padding=(ph, pw),
                            count_include_pad=not exclusive)
    xp = F.pad(x, (pw, pw + ew, ph, ph + eh))
    summed = F.avg_pool2d(xp, k, s, divisor_override=1)
    if exclusive and (ph or pw or eh or ew):
        ones = F.pad(torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device),
                     (pw, pw + ew, ph, ph + eh))
        return summed / F.avg_pool2d(ones, k, s, divisor_override=1)
    return summed / (kh * kw)


@register_op("pool2d")
def _pool2d(ctx, ins, attrs):
    out = _pool2d_impl(
        X(ins, "X"), _pair(attrs.get("ksize", [1, 1])),
        _pair(attrs.get("strides", [1, 1])),
        _pair(attrs.get("paddings", [0, 0])),
        attrs.get("pooling_type", "max"),
        attrs.get("global_pooling", False),
        attrs.get("adaptive", False),
        attrs.get("exclusive", True),
        attrs.get("ceil_mode", False))
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------

def _bn_axes(layout, ndim):
    if layout == "NHWC":
        return tuple(range(ndim - 1)), (1,) * (ndim - 1) + (-1,)
    return (0,) + tuple(range(2, ndim)), (1, -1) + (1,) * (ndim - 2)


def _batch_norm_lower(ctx, ins, attrs):
    """ref ``nn_ops.py:208``.  Training statistics are one-pass, E[x] and
    E[x²] in float32 with the variance clamped at 0; the running statistics
    update with ``momentum``; the normalize is one multiply-add in the
    input's dtype; ``SavedVariance`` holds 1/sqrt(var + eps)."""
    x = X(ins, "X")
    scale, bias = X(ins, "Scale"), X(ins, "Bias")
    mean, var = X(ins, "Mean"), X(ins, "Variance")
    momentum = attrs.get("momentum", 0.9)
    eps = attrs.get("epsilon", 1e-5)
    axes, bshape = _bn_axes(attrs.get("data_layout", "NCHW"), x.dim())
    if attrs.get("use_global_stats", False) or attrs.get("is_test", False):
        m, v = mean, var
        saved_m, saved_v = mean, var
        mean_out, var_out = mean, var
    else:
        xf = x.float()
        m = torch.mean(xf, dim=axes)
        v = torch.clamp(torch.mean(torch.square(xf), dim=axes) - m * m,
                        min=0.0)
        saved_m, saved_v = m, v
        mean_out = mean * momentum + m * (1 - momentum)
        var_out = var * momentum + v * (1 - momentum)
    inv = torch.rsqrt(v + eps)
    a = inv * scale
    b = bias - m * a
    y = x * a.to(x.dtype).reshape(bshape) + b.to(x.dtype).reshape(bshape)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [saved_m],
            "SavedVariance": [torch.rsqrt(saved_v + eps)]}


def _batch_norm_grad_maker(op, block, no_grad_set):
    """The reference's desc (``nn_ops.py:251``): gradients flow through Y
    to X, Scale and Bias; the running statistics are state, not inputs of
    the gradient (a frozen BN reads them as constants)."""
    g_inputs = {"X$X": op.input("X"), "X$Scale": op.input("Scale"),
                "X$Bias": op.input("Bias"),
                "OG$Y": [grad_var_name(n) for n in op.output("Y")]}
    if op.attrs.get("use_global_stats", False) or \
            op.attrs.get("is_test", False):
        g_inputs["X$Mean"] = op.input("Mean")
        g_inputs["X$Variance"] = op.input("Variance")
    g_outputs = {
        "IG$X": [grad_var_name(n) if n not in no_grad_set else ""
                 for n in op.input("X")],
        "IG$Scale": [grad_var_name(n) for n in op.input("Scale")],
        "IG$Bias": [grad_var_name(n) for n in op.input("Bias")]}
    return [{"type": "batch_norm_explicit_grad", "inputs": g_inputs,
             "outputs": g_outputs, "attrs": dict(op.attrs)}]


register_op("batch_norm", _batch_norm_lower,
            grad_maker=_batch_norm_grad_maker)


@register_op("batch_norm_explicit_grad")
def _batch_norm_explicit_grad(ctx, ins, attrs):
    """ref ``nn_ops.py:277``: ``torch.autograd`` through a recomputed
    normalize.  Training statistics here are two-pass (the biased
    variance), as the reference's ``jnp.var`` is; the forward's are
    one-pass."""
    x, scale, bias = X(ins, "X$X"), X(ins, "X$Scale"), X(ins, "X$Bias")
    gy = X(ins, "OG$Y")
    use_global = attrs.get("use_global_stats", False) or \
        attrs.get("is_test", False)
    eps = attrs.get("epsilon", 1e-5)
    axes, bshape = _bn_axes(attrs.get("data_layout", "NCHW"), x.dim())
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, scale, bias)]
        x_, s_, b_ = leaves
        if use_global:
            m, v = X(ins, "X$Mean"), X(ins, "X$Variance")
        else:
            xf = x_.float()
            m = torch.mean(xf, dim=axes)
            v = torch.var(xf, dim=axes, unbiased=False)
        inv = torch.rsqrt(v + eps)
        a = inv * s_
        b = b_ - m * a
        y = x_ * a.to(x_.dtype).reshape(bshape) \
            + b.to(x_.dtype).reshape(bshape)
        gx, gs, gb = torch.autograd.grad(y, leaves, gy.to(y.dtype))
    return {"IG$X": [gx], "IG$Scale": [gs], "IG$Bias": [gb]}


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """Statistics in float32 with the two-pass variance, then the affine
    in the input's dtype — the reference lowering (nn_ops.py:310-337)."""
    x = X(ins, "X")
    scale, bias = X(ins, "Scale"), X(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    lead = tuple(x.shape[:begin])
    x2 = x.reshape(int(np.prod(lead)), -1)
    xf = x2.float()
    m = xf.mean(dim=1, keepdim=True)
    v = xf.var(dim=1, unbiased=False, keepdim=True)
    inv = torch.rsqrt(v + eps)
    y = (x2 - m.to(x2.dtype)) * inv.to(x2.dtype)
    if scale is not None:
        y = y * scale.to(y.dtype).reshape(1, -1)
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(1, -1)
    return {"Y": [y.reshape(x.shape).to(x.dtype)],
            "Mean": [m.reshape(lead)], "Variance": [v.reshape(lead)]}


@register_op("group_norm")
def _group_norm(ctx, ins, attrs):
    """ref ``nn_ops.py:340``: NCHW; statistics over each group's channels
    and positions in float32 (the two-pass variance), the affine after."""
    x = X(ins, "X")
    scale, bias = X(ins, "Scale"), X(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    groups = attrs.get("groups", 1)
    n, c = x.shape[:2]
    spatial = tuple(x.shape[2:])
    xg = x.float().reshape(n, groups, -1)
    m = xg.mean(dim=2, keepdim=True)
    v = xg.var(dim=2, unbiased=False, keepdim=True)
    y = ((xg - m) * torch.rsqrt(v + eps)).reshape((n, c) + spatial)
    bshape = (1, c) + (1,) * len(spatial)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return {"Y": [y.to(x.dtype)], "Mean": [m.reshape(n, groups)],
            "Variance": [v.reshape(n, groups)]}


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    x = X(ins, "X")
    out = torch.softmax(x.float(), dim=attrs.get("axis", -1))
    return {"Out": [out.to(x.dtype)]}


def _swce_lower(ctx, ins, attrs):
    """ref ``nn_ops.py:419``: softmax and its cross entropy in one op;
    hard labels may carry a trailing 1 on ``axis``, and a label equal to
    ``ignore_index`` (when >= 0) gives a zero loss."""
    logits, label = X(ins, "Logits"), X(ins, "Label")
    axis = attrs.get("axis", -1)
    ignore_index = attrs.get("ignore_index", -100)
    log_sm = logits - torch.logsumexp(logits, dim=axis, keepdim=True)
    sm = torch.exp(log_sm)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * log_sm, dim=axis, keepdim=True)
    else:
        li = label
        if li.dim() == logits.dim() and li.shape[axis] == 1:
            li = li.squeeze(axis)
        idx = li.unsqueeze(axis).long()
        if ignore_index >= 0:
            idx = torch.where(idx == ignore_index, torch.zeros_like(idx), idx)
        loss = -torch.gather(log_sm, axis, idx)
        if ignore_index >= 0:
            loss = torch.where(li.unsqueeze(axis) != ignore_index, loss,
                               torch.zeros_like(loss))
    return {"Softmax": [sm], "Loss": [loss]}


def _swce_grad_maker(op, block, no_grad_set):
    """grad = softmax - onehot(label): no forward rerun (ref
    ``operators/softmax_with_cross_entropy_op.cc`` grad kernel)."""
    g_inputs = {"Softmax": op.output("Softmax"), "Label": op.input("Label"),
                "LossGrad": [grad_var_name(n) for n in op.output("Loss")]}
    g_outputs = {"LogitsGrad": [grad_var_name(n) for n in op.input("Logits")]}
    return [{"type": "softmax_with_cross_entropy_grad", "inputs": g_inputs,
             "outputs": g_outputs, "attrs": dict(op.attrs)}]


register_op("softmax_with_cross_entropy", _swce_lower,
            grad_maker=_swce_grad_maker)


@register_op("softmax_with_cross_entropy_grad")
def _swce_grad(ctx, ins, attrs):
    sm, label, gloss = X(ins, "Softmax"), X(ins, "Label"), X(ins, "LossGrad")
    axis = attrs.get("axis", -1)
    if attrs.get("soft_label", False):
        return {"LogitsGrad": [(sm - label) * gloss]}
    li = label
    if li.dim() == sm.dim() and li.shape[axis] == 1:
        li = li.squeeze(axis)
    idx = li.unsqueeze(axis).long()
    ignore_index = attrs.get("ignore_index", -100)
    # one_hot of an index outside [0, n) is all zeros, as jax.nn.one_hot
    valid = (idx >= 0) & (idx < sm.shape[axis])
    onehot = torch.zeros_like(sm).scatter(
        axis, torch.where(valid, idx, torch.zeros_like(idx)),
        valid.to(sm.dtype))
    glogits = (sm - onehot) * gloss
    if ignore_index >= 0:
        glogits = torch.where(li.unsqueeze(axis) != ignore_index, glogits,
                              torch.zeros_like(glogits))
    return {"LogitsGrad": [glogits]}


@register_op("sigmoid_cross_entropy_with_logits")
def _sce_logits(ctx, ins, attrs):
    """ref ``paddle_tpu/ops/nn_ops.py:497``: max(x, 0) - x·label +
    log1p(exp(-|x|)) elementwise; elements whose label is ``ignore_index``
    are 0, and ``normalize`` divides by the count of the others (at least
    1)."""
    x, label = X(ins, "X"), X(ins, "Label")
    ignore_index = attrs.get("ignore_index", -100)
    loss = torch.clamp(x, min=0) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    mask = label != ignore_index
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if attrs.get("normalize", False):
        loss = loss / torch.clamp(mask.to(x.dtype).sum(), min=1.0)
    return {"Out": [loss]}


@register_op("square_error_cost")
def _square_error_cost(ctx, ins, attrs):
    """ref ``paddle_tpu/ops/nn_ops.py:509``: (x - y)^2 elementwise."""
    return {"Out": [torch.square(X(ins, "X") - X(ins, "Y"))]}


@register_op("cross_entropy")
def _cross_entropy(ctx, ins, attrs):
    """ref ``nn_ops.py:475``: X holds probabilities; the loss is
    -log(p[label] + 1e-12), or -Σ label·log(p + 1e-12) with soft labels."""
    x, label = X(ins, "X"), X(ins, "Label")
    ignore_index = attrs.get("ignore_index", -100)
    eps = 1e-12
    if attrs.get("soft_label", False):
        return {"Y": [-torch.sum(label * torch.log(x + eps), dim=-1,
                                 keepdim=True)]}
    li = label
    if li.dim() == x.dim() and li.shape[-1] == 1:
        li = li[..., 0]
    picked = torch.gather(x, -1, li[..., None].long())
    loss = -torch.log(picked + eps)
    if ignore_index >= 0:
        loss = torch.where(li[..., None] != ignore_index, loss,
                           torch.zeros_like(loss))
    return {"Y": [loss]}


def _lm_head_chunk(x, w, b, label, ignore):
    """One chunk of ``fused_lm_head_ce``: the reference's bf16 head
    (operands cast to bf16, the product rounded to bf16, then f32), a
    logsumexp whose max carries no gradient, and the picked logit."""
    logits = (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
    if b is not None:
        logits = logits + b.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[:, 0]
    skip = label == ignore
    safe = torch.where(skip, torch.zeros_like(label), label)
    picked = logits.gather(-1, safe[:, None].long())[:, 0]
    return torch.where(skip, torch.zeros_like(lse), lse - picked)


def _infer_lm_head_ce(op, block):
    x = block.var(op.input("X")[0])
    loss = block.var(op.output("Loss")[0])
    if x.shape is not None:
        loss.shape = tuple(x.shape[:-1]) + (1,)
    loss.dtype = "float32"


@register_op("fused_lm_head_ce", infer=_infer_lm_head_ce)
def _fused_lm_head_ce(ctx, ins, attrs):
    """LM head projection + softmax cross-entropy over chunks of
    ``chunk_size`` tokens (ref ``nn_ops.py:925``): the ``[tokens, vocab]``
    logits never exist.  When a gradient will be taken, each chunk runs
    under ``torch.utils.checkpoint``, so the backward recomputes its
    logits as the reference's ``jax.checkpoint`` does and training memory
    stays O(chunk * vocab); autograd derives the backward through the same
    bf16 casts, so its rounding follows the reference's."""
    x, w, b = X(ins, "X"), X(ins, "W"), X(ins, "Bias")
    label = X(ins, "Label")
    ignore = attrs.get("ignore_index", -100)
    chunk = int(attrs.get("chunk_size", 1024))
    lead = tuple(x.shape[:-1])
    n = int(np.prod(lead))
    x2 = x.reshape(n, x.shape[-1])
    l1 = label.reshape(n)
    remat = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, b))
    losses = []
    for s in range(0, n, chunk):
        args = (x2[s:s + chunk], w, b, l1[s:s + chunk], ignore)
        losses.append(checkpoint(_lm_head_chunk, *args, use_reentrant=False)
                      if remat else _lm_head_chunk(*args))
    return {"Loss": [torch.cat(losses).reshape(lead + (1,))]}


_UNARY = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
          "gelu": F.gelu}


@register_op("fc")
def _fc(ctx, ins, attrs):
    """The fc that ``fc_fuse_pass`` makes (ref ``nn_ops.py:887``,
    ``operators/fc_op.cc``): Input flattened at in_num_col_dims, times W,
    plus Bias, then the activation.  Its gelu is the tanh form, as the
    reference's ``jax.nn.gelu`` default, where the ``gelu`` op is exact."""
    x, w, b = X(ins, "Input"), X(ins, "W"), X(ins, "Bias")
    ncd = attrs.get("in_num_col_dims", 1)
    lead = tuple(x.shape[:ncd])
    out = torch.matmul(x.reshape(int(np.prod(lead)), -1), w)
    if b is not None:
        out = out + b.reshape(1, -1)
    act = attrs.get("activation_type", "")
    if act == "gelu":
        out = F.gelu(out, approximate="tanh")
    elif act:
        if act not in _UNARY:
            raise NotImplementedError(f"fc activation {act!r}")
        out = _UNARY[act](out)
    return {"Out": [out.reshape(lead + (w.shape[1],))]}


@register_op("fused_elemwise_activation")
def _fused_elemwise_activation(ctx, ins, attrs):
    """ref ``operators/fused/fused_elemwise_activation_op.cc``, the target of
    ``fuse_elewise_add_act_pass`` (``paddle_tpu/ops/nn_ops.py:904``):
    ``functor_list`` is [binary, unary], applied as unary(binary(x, y))."""
    x, y = X(ins, "X"), X(ins, "Y")
    binary, unary = attrs["functor_list"]
    if binary != "elementwise_add":
        raise NotImplementedError(f"fused functor {binary}")
    out = x + broadcast_to_x(x, y, attrs.get("axis", -1))
    if unary == "scale":
        s, b = attrs.get("scale", 1.0), attrs.get("bias", 0.0)
        out = out * s + b if attrs.get("bias_after_scale", True) \
            else (out + b) * s
    elif unary in _UNARY:
        out = _UNARY[unary](out)
    else:
        raise NotImplementedError(f"fused functor {unary}")
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# dropout (ref nn_ops.py:643-709): the mask drawn and applied by the dropout
# kernel (kernels/dropout.py) on a Philox stream; a tagged op's grad
# regenerates the mask from its tag, an untagged op's grad reads ``Mask``
# ---------------------------------------------------------------------------

def dropout_scale(attrs) -> float:
    """The factor kept elements take, forward and backward: 1 / (1 - p)
    for ``upscale_in_train`` (p < 1), else 1 (at p = 1 nothing is kept)."""
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    return 1.0 / (1.0 - p) if impl == "upscale_in_train" and p < 1.0 \
        else 1.0


def dropout_infer(x, attrs):
    """The ``is_test`` output: x scaled by 1 - p for
    ``downgrade_in_infer``, x itself for ``upscale_in_train``; the factor
    rounded to x's dtype, as the reference's product rounds it."""
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("dropout_implementation",
                 "downgrade_in_infer") != "downgrade_in_infer":
        return x
    return x * torch.tensor(dropout_k.rounded_scale(1.0 - p, x.dtype),
                            dtype=x.dtype, device=x.device)


def _dropout_lower(ctx, ins, attrs):
    x = X(ins, "X")
    if attrs.get("is_test", False):
        return {"Out": [dropout_infer(x, attrs)],
                "Mask": [torch.ones(x.shape, dtype=torch.uint8,
                                    device=x.device)]}
    thresh = dropout_k.threshold(attrs.get("dropout_prob", 0.5))
    tag = int(attrs.get("seed", 0))
    # through the autograd Function: a loop's gradient replays its body
    # under torch.autograd (ops/control_flow_ops.py), and the kernel's own
    # output carries no gradient
    if tag:
        # the grad op regenerates the mask: none is written
        out = dropout_k.dropout(x, ctx.rng_tagged(tag), thresh,
                                dropout_scale(attrs))
        return {"Out": [out]}
    out, mask = dropout_k.dropout(x, ctx.rng(), thresh, dropout_scale(attrs),
                                  want_mask=True)
    return {"Out": [out], "Mask": [mask]}


def _dropout_grad_maker(op, block, no_grad_set):
    """ref ``nn_ops.py:685``: an untagged op's grad reads its ``Mask``, the
    only way to replay it."""
    g_inputs = {"OutGrad": [grad_var_name(n) for n in op.output("Out")]}
    if not op.attrs.get("seed", 0):
        g_inputs["Mask"] = op.output("Mask")
    g_outputs = {"XGrad": [grad_var_name(n) for n in op.input("X")]}
    return [{"type": "dropout_grad", "inputs": g_inputs,
             "outputs": g_outputs, "attrs": dict(op.attrs)}]


register_op("dropout", _dropout_lower, grad_maker=_dropout_grad_maker,
            stateful_rng=True)


@register_op("dropout_grad", stateful_rng=True)
def _dropout_grad(ctx, ins, attrs):
    gout = X(ins, "OutGrad")
    if attrs.get("is_test", False):
        # the is_test forward is x (or x * (1 - p)): its gradient
        return {"XGrad": [dropout_infer(gout, attrs)]}
    tag = int(attrs.get("seed", 0))
    if tag:
        stream, thresh, mask = ctx.rng_tagged(tag), dropout_k.threshold(
            attrs.get("dropout_prob", 0.5)), None
    else:
        stream, thresh, mask = None, 0, X(ins, "Mask")
    gx, _ = dropout_k.dropout_fwd(gout, stream, thresh, dropout_scale(attrs),
                                  mask_in=mask)
    return {"XGrad": [gx]}
