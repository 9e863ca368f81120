"""Normalization, softmax and loss lowerings (the subset of
``paddle_tpu/ops/nn_ops.py`` the serving and training slices run)."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..framework.core import grad_var_name
from ..framework.registry import register_op
from .common import X


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
