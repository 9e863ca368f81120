"""Optimizer op lowerings (the subset of ``paddle_tpu/ops/optimizer_ops.py``
the training slice runs; ref ``operators/optimizers/``).

Each optimizer op returns the new values of its parameter and accumulators;
the executor writes them back to the scope after the run.  They build new
tensors rather than update in place, so no tensor that a saved autograd
graph still holds is ever changed.  All are ``no_grad`` (they sit after the
grad ops).
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from .common import X, XS


def _lr(ins):
    lr = X(ins, "LearningRate")
    return lr.reshape(()) if lr is not None and lr.dim() else lr


@register_op("sgd", no_grad=True)
def _sgd(ctx, ins, attrs):
    p, g = X(ins, "Param"), X(ins, "Grad")
    return {"ParamOut": [(p - _lr(ins) * g).to(p.dtype)]}


@register_op("momentum", no_grad=True)
def _momentum(ctx, ins, attrs):
    p, g, v = X(ins, "Param"), X(ins, "Grad"), X(ins, "Velocity")
    lr = _lr(ins)
    mu = attrs.get("mu", 0.9)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": [p_new.to(p.dtype)], "VelocityOut": [v_new]}


def _adam_update(p, g, m1, m2, b1p, b2p, lr, attrs):
    """ref ``operators/optimizers/adam_op.h`` AdamFunctor."""
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    return p - lr_t * m1n / (torch.sqrt(m2n) + eps), m1n, m2n


@register_op("adam", no_grad=True)
def _adam(ctx, ins, attrs):
    p, g = X(ins, "Param"), X(ins, "Grad")
    b1p, b2p = X(ins, "Beta1Pow"), X(ins, "Beta2Pow")
    p_new, m1n, m2n = _adam_update(p, g, X(ins, "Moment1"), X(ins, "Moment2"),
                                   b1p.reshape(()), b2p.reshape(()),
                                   _lr(ins), attrs)
    return {"ParamOut": [p_new.to(p.dtype)],
            "Moment1Out": [m1n], "Moment2Out": [m2n],
            "Beta1PowOut": [b1p * attrs.get("beta1", 0.9)],
            "Beta2PowOut": [b2p * attrs.get("beta2", 0.999)]}


@register_op("fused_adam", no_grad=True)
def _fused_adam(ctx, ins, attrs):
    """All the group's params in ONE update over their flattened
    concatenation, with one shared beta-pow pair (ref ``optimizer_ops.py:78``
    — identical semantics to per-param ``adam``)."""
    ps, gs = XS(ins, "Param"), XS(ins, "Grad")
    m1s, m2s = XS(ins, "Moment1"), XS(ins, "Moment2")
    b1p = X(ins, "Beta1Pow").reshape(())
    b2p = X(ins, "Beta2Pow").reshape(())

    def flat(xs):
        return torch.cat([x.reshape(-1).float() for x in xs])

    pn, m1n, m2n = _adam_update(flat(ps), flat(gs), flat(m1s), flat(m2s),
                                b1p, b2p, _lr(ins), attrs)

    def unflat(v, like):
        outs, off = [], 0
        for x in like:
            n = x.numel()
            outs.append(v[off:off + n].reshape(x.shape).to(x.dtype))
            off += n
        return outs

    return {"ParamOut": unflat(pn, ps),
            "Moment1Out": unflat(m1n, m1s),
            "Moment2Out": unflat(m2n, m2s),
            "Beta1PowOut": [(b1p * attrs.get("beta1", 0.9)).reshape(1)],
            "Beta2PowOut": [(b2p * attrs.get("beta2", 0.999)).reshape(1)]}
