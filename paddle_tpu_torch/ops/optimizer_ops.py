"""Optimizer op lowerings (the port's ``paddle_tpu/ops/optimizer_ops.py``;
ref ``operators/optimizers/``).

Each optimizer op returns the new values of its parameter and accumulators;
the executor writes them back to the scope after the run.  They build new
tensors rather than update in place, so no tensor that a saved autograd
graph still holds is ever changed.  All are ``no_grad`` (they sit after the
grad ops).  No lowering reads a value back to the host: the norms of
``lars_momentum`` and ``lamb`` and the window test of
``average_accumulates`` stay tensors, chosen between with ``torch.where``.
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


@register_op("lars_momentum", no_grad=True)
def _lars_momentum(ctx, ins, attrs):
    """ref ``optimizer_ops.py:42-54``: momentum at a layer-wise rate."""
    p, g, v = X(ins, "Param"), X(ins, "Grad"), X(ins, "Velocity")
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 1e-3)
    decay = attrs.get("lars_weight_decay", 5e-4)
    pn = torch.sqrt(torch.sum(torch.square(p)))
    gn = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = _lr(ins) * coeff * pn / (gn + decay * pn + 1e-9)
    v_new = mu * v + local_lr * (g + decay * p)
    return {"ParamOut": [(p - v_new).to(p.dtype)], "VelocityOut": [v_new]}


@register_op("adamw", no_grad=True)
def _adamw(ctx, ins, attrs):
    """ref ``optimizer_ops.py:128``: Adam, then the decoupled decay of the
    old parameter."""
    p = X(ins, "Param")
    outs = _adam(ctx, ins, attrs)
    outs["ParamOut"] = [(outs["ParamOut"][0] - _lr(ins) *
                         attrs.get("coeff", 0.01) * p).to(p.dtype)]
    return outs


@register_op("adamax", no_grad=True)
def _adamax(ctx, ins, attrs):
    """ref ``optimizer_ops.py:138``; the optimizer scales ``Beta1Pow`` after
    the update (``AdamaxOptimizer._finish_update``)."""
    p, g = X(ins, "Param"), X(ins, "Grad")
    m, inf = X(ins, "Moment"), X(ins, "InfNorm")
    b1p = X(ins, "Beta1Pow").reshape(())
    b1 = attrs.get("beta1", 0.9)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(attrs.get("beta2", 0.999) * inf, torch.abs(g))
    p_new = p - (_lr(ins) / (1 - b1p)) * (
        m_new / (inf_new + attrs.get("epsilon", 1e-8)))
    return {"ParamOut": [p_new.to(p.dtype)], "MomentOut": [m_new],
            "InfNormOut": [inf_new]}


@register_op("adagrad", no_grad=True)
def _adagrad(ctx, ins, attrs):
    """ref ``optimizer_ops.py:154``."""
    p, g, mom = X(ins, "Param"), X(ins, "Grad"), X(ins, "Moment")
    m_new = mom + torch.square(g)
    p_new = p - _lr(ins) * g / (torch.sqrt(m_new) +
                                attrs.get("epsilon", 1e-6))
    return {"ParamOut": [p_new.to(p.dtype)], "MomentOut": [m_new]}


@register_op("decayed_adagrad", no_grad=True)
def _decayed_adagrad(ctx, ins, attrs):
    """ref ``optimizer_ops.py:164``."""
    p, g, mom = X(ins, "Param"), X(ins, "Grad"), X(ins, "Moment")
    decay = attrs.get("decay", 0.95)
    m_new = decay * mom + (1 - decay) * torch.square(g)
    p_new = p - _lr(ins) * g / (torch.sqrt(m_new) +
                                attrs.get("epsilon", 1e-6))
    return {"ParamOut": [p_new.to(p.dtype)], "MomentOut": [m_new]}


@register_op("adadelta", no_grad=True)
def _adadelta(ctx, ins, attrs):
    """ref ``optimizer_ops.py:175`` (no learning rate)."""
    p, g = X(ins, "Param"), X(ins, "Grad")
    avg_sq, avg_upd = X(ins, "AvgSquaredGrad"), X(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    sq_new = rho * avg_sq + (1 - rho) * torch.square(g)
    upd = -torch.sqrt((avg_upd + eps) / (sq_new + eps)) * g
    upd_new = rho * avg_upd + (1 - rho) * torch.square(upd)
    return {"ParamOut": [(p + upd).to(p.dtype)],
            "AvgSquaredGradOut": [sq_new], "AvgSquaredUpdateOut": [upd_new]}


@register_op("rmsprop", no_grad=True)
def _rmsprop(ctx, ins, attrs):
    """ref ``optimizer_ops.py:188``, centered (``MeanGrad``) or not."""
    p, g = X(ins, "Param"), X(ins, "Grad")
    ms, mom = X(ins, "MeanSquare"), X(ins, "Moment")
    mg = X(ins, "MeanGrad")
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    outs = {}
    if attrs.get("centered", False) and mg is not None:
        mg_new = rho * mg + (1 - rho) * g
        denom = ms_new - torch.square(mg_new) + eps
        outs["MeanGradOut"] = [mg_new]
    else:
        denom = ms_new + eps
    mom_new = attrs.get("momentum", 0.0) * mom + \
        _lr(ins) * g * torch.rsqrt(denom)
    outs.update({"ParamOut": [(p - mom_new).to(p.dtype)],
                 "MomentOut": [mom_new], "MeanSquareOut": [ms_new]})
    return outs


@register_op("ftrl", no_grad=True)
def _ftrl(ctx, ins, attrs):
    """ref ``optimizer_ops.py:212``, both ``lr_power`` branches."""
    p, g = X(ins, "Param"), X(ins, "Grad")
    sq_acc, lin_acc = X(ins, "SquaredAccumulator"), X(ins, "LinearAccumulator")
    lr = _lr(ins)
    l1 = attrs.get("l1", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_sq = sq_acc + torch.square(g)
    if power == -0.5:
        root_new, root_old = torch.sqrt(new_sq), torch.sqrt(sq_acc)
    else:
        root_new, root_old = torch.pow(new_sq, -power), \
            torch.pow(sq_acc, -power)
    new_lin = lin_acc + g - (root_new - root_old) / lr * p
    denom = root_new / lr + 2 * attrs.get("l2", 0.0)
    p_new = (torch.clamp(new_lin, -l1, l1) - new_lin) / denom
    return {"ParamOut": [p_new.to(p.dtype)],
            "SquaredAccumOut": [new_sq], "LinearAccumOut": [new_lin]}


@register_op("lamb", no_grad=True)
def _lamb(ctx, ins, attrs):
    """ref ``optimizer_ops.py:236-258`` (``lamb_op.h``): the Adam direction
    plus decay, scaled by the trust ratio ||p|| / ||r||, or 1 when either
    norm is zero."""
    p, g = X(ins, "Param"), X(ins, "Grad")
    m1, m2 = X(ins, "Moment1"), X(ins, "Moment2")
    b1p, b2p = X(ins, "Beta1Pow"), X(ins, "Beta2Pow")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    mhat = m1n / (1 - b1p.reshape(()))
    vhat = m2n / (1 - b2p.reshape(()))
    r = mhat / (torch.sqrt(vhat) + attrs.get("epsilon", 1e-6)) + \
        attrs.get("weight_decay", 0.01) * p
    pn = torch.sqrt(torch.sum(torch.square(p.float())))
    rn = torch.sqrt(torch.sum(torch.square(r.float())))
    trust = torch.where((pn > 0) & (rn > 0), pn / rn, torch.ones_like(pn))
    p_new = p - _lr(ins) * trust * r
    return {"ParamOut": [p_new.to(p.dtype)],
            "Moment1Out": [m1n], "Moment2Out": [m2n],
            "Beta1PowOut": [b1p * b1], "Beta2PowOut": [b2p * b2]}


def _proximal(prox, step, attrs):
    """Soft-threshold by ``step * l1``, shrink by ``1 + step * l2``."""
    return torch.sign(prox) * torch.clamp(
        torch.abs(prox) - step * attrs.get("l1", 0.0), min=0.0) / (
        1 + step * attrs.get("l2", 0.0))


@register_op("proximal_gd", no_grad=True)
def _proximal_gd(ctx, ins, attrs):
    """ref ``optimizer_ops.py:261``."""
    p, g = X(ins, "Param"), X(ins, "Grad")
    lr = _lr(ins)
    return {"ParamOut": [_proximal(p - lr * g, lr, attrs).to(p.dtype)]}


@register_op("proximal_adagrad", no_grad=True)
def _proximal_adagrad(ctx, ins, attrs):
    """ref ``optimizer_ops.py:272``."""
    p, g, mom = X(ins, "Param"), X(ins, "Grad"), X(ins, "Moment")
    m_new = mom + torch.square(g)
    eff_lr = _lr(ins) / torch.sqrt(m_new)
    return {"ParamOut": [_proximal(p - eff_lr * g, eff_lr, attrs)
                         .to(p.dtype)], "MomentOut": [m_new]}


@register_op("average_accumulates", no_grad=True)
def _average_accumulates(ctx, ins, attrs):
    """ref ``optimizer_ops.py:292-316``: ModelAverage's running sums; the
    window rolls over on the card, by ``torch.where``."""
    param = X(ins, "param")
    in_sum1, in_sum2 = X(ins, "in_sum_1"), X(ins, "in_sum_2")
    in_sum3 = X(ins, "in_sum_3")
    in_num = X(ins, "in_num_accumulates")
    in_old = X(ins, "in_old_num_accumulates")
    max_avg = attrs.get("max_average_window", 10000)
    num = in_num + 1
    upd = X(ins, "in_num_updates") + 1
    sum1 = in_sum1 + param
    window = torch.clamp(torch.clamp(
        attrs.get("average_window", 0.15) * upd.float(), max=float(max_avg)),
        min=float(attrs.get("min_average_window", 10000)))
    roll = num.float() >= window
    out_sum2 = torch.where(roll, in_sum2 + sum1, in_sum2)
    out_sum1 = torch.where(roll, torch.zeros_like(sum1), sum1)
    out_old = torch.where(roll, num, in_old)
    out_num = torch.where(roll, torch.zeros_like(num), num)
    out_sum3 = torch.where(out_old + out_num > max_avg, out_sum1 + out_sum2,
                           in_sum3)
    return {"out_sum_1": [out_sum1], "out_sum_2": [out_sum2],
            "out_sum_3": [out_sum3], "out_num_accumulates": [out_num],
            "out_old_num_accumulates": [out_old], "out_num_updates": [upd]}
