"""Mixture-of-experts ops: the capability behind the mesh's ``ep`` axis (the
port of ``paddle_tpu/ops/moe_ops.py``; the 2019 reference has no MoE).  The
design is GShard / Switch Transformer's: top-1 gating, dense capacity-
factor dispatch (one-hot products, static shapes), the experts' FFN as one
batched product over the expert dim.  Its gradient is the generic one
(autograd of this lowering).  Under a mesh with an ``ep`` axis the expert
weights are split over ``ep`` and the SPMD lowering runs the op as
``spmd_switch_ffn`` (``parallel.spmd``), whose dispatch and return are
all-to-alls over ``ep``.

The reference computes these products with ``jnp.einsum`` outside any
Pallas kernel; here they are ``torch.einsum`` s, and no CUDA kernel runs.
"""

from __future__ import annotations

import math

import torch

from ..framework.registry import register_op
from .common import X


def capacity(tokens: int, experts: int, factor: float) -> int:
    """Each expert's buffer rows: ``max(1, ceil(factor * tokens / E))``."""
    return int(max(1, math.ceil(factor * tokens / experts)))


def gating(xt, gw):
    """Top-1 routing in float32: ``(probs [S, E], gate [S], idx [S])``; the
    argmax takes the first maximum, as ``jnp.argmax`` does."""
    probs = torch.softmax(xt.float() @ gw.float(), dim=-1)
    idx = probs.argmax(dim=-1)
    gate = probs.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    return probs, gate, idx


def dispatch_mask(idx, experts: int, cap: int, dtype, offset=None):
    """``[S, E, C]``: token s at its position in its expert's buffer.  The
    position counts the earlier tokens that chose the same expert (plus
    ``offset[e]`` tokens before these, when given); a token past the
    capacity, like any other expert's column, gets an all-zero row (where
    ``jax.nn.one_hot`` gives zeros and ``torch.nn.functional.one_hot``
    would raise)."""
    onehot = torch.nn.functional.one_hot(idx, experts).to(torch.int64)
    pos = torch.cumsum(onehot, dim=0)
    if offset is not None:
        pos = pos + offset.to(pos.dtype)
    pos = pos * onehot - 1
    keep = (pos >= 0) & (pos < cap)
    out = torch.zeros(idx.shape[0], experts, cap, dtype=dtype,
                      device=idx.device)
    return out.scatter_(2, torch.where(keep, pos, 0).unsqueeze(-1),
                        keep.to(dtype).unsqueeze(-1)), onehot


def expert_ffn(xe, w1, b1, w2, b2, act: str):
    """The experts' FFN on their buffers ``[E, C, d]``: one batched product
    over E each way; gelu is the tanh form (``jax.nn.gelu``'s default)."""
    h = torch.einsum("ecd,edf->ecf", xe, w1.to(xe.dtype)) \
        + b1.to(xe.dtype)[:, None, :]
    h = torch.nn.functional.gelu(h, approximate="tanh") if act == "gelu" \
        else torch.relu(h)
    return torch.einsum("ecf,efd->ecd", h, w2.to(xe.dtype)) \
        + b2.to(xe.dtype)[:, None, :]


@register_op("switch_ffn")
def _switch_ffn(ctx, ins, attrs):
    """Switch-Transformer FFN: ``y = combine(expert_ffn(dispatch(x)))``.

    Inputs: X [B, T, d], GateW [d, E], W1 [E, d, f], B1 [E, f], W2 [E, f,
    d], B2 [E, d].  Outputs: Out [B, T, d] and AuxLoss [] (the load-
    balancing loss ``E * sum_e fraction_e * mean prob_e``).  A token past
    its expert's capacity is dropped: it contributes zero."""
    x, gw = X(ins, "X"), X(ins, "GateW")
    w1, b1 = X(ins, "W1"), X(ins, "B1")
    w2, b2 = X(ins, "W2"), X(ins, "B2")
    B, T, d = x.shape
    E = gw.shape[-1]
    S = B * T
    cap = capacity(S, E, float(attrs.get("capacity_factor", 1.25)))
    xt = x.reshape(S, d)
    probs, gate, idx = gating(xt, gw)
    dispatch, onehot = dispatch_mask(idx, E, cap, x.dtype)
    xe = torch.einsum("sec,sd->ecd", dispatch, xt)
    ye = expert_ffn(xe, w1, b1, w2, b2, attrs.get("act", "relu"))
    combine = dispatch * gate.to(x.dtype)[:, None, None]
    y = torch.einsum("sec,ecd->sd", combine, ye)
    aux = (onehot.float().mean(dim=0) * probs.mean(dim=0)).sum() * E
    return {"Out": [y.reshape(B, T, d)], "AuxLoss": [aux]}
