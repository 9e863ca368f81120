"""Deep Gradient Compression (the port of ``paddle_tpu/parallel/dgc.py``;
ref ``details/sparse_all_reduce_op_handle.cc``, ``operators/dgc_op.cc``,
``DGCMomentumOptimizer`` optimizer.py:809).

Per rank and per gradient (Lin et al., the algorithm of the reference's
external DGC library):

    u = m*u + g                    # local momentum correction
    v = v + u                      # local gradient accumulation
    (idx, vals) = top_k(|v|, k)    # k = numel*(1-sparsity)
    sync: allgather (idx, vals) over the ranks, scatter-add, 1/n
    u, v zeroed at the chosen idx  # the rest stays local until it grows

Before ``rampup_begin_step`` the op is a dense mean-gradient momentum step
(the reference's single dense-to-sparse switch, ``lax.cond`` on the step
counter).  The port computes both phases and picks one per element with
``torch.where`` on the counter, so no lowering reads a value back to the
host.  ``dgc_allreduce`` is a collective op (``collective=True``): its
lowering takes every rank's inputs, gathers the chosen pairs in rank order
on rank 0's device, scatter-adds them there (``index_put_`` with
``accumulate``) and hands each rank its own copy.  Top-k is
``torch.topk``; the reference uses ``lax.top_k``, outside any Pallas
kernel.

The parameter update is then ``p -= lr * out`` (``dgc_momentum``):
momentum already lives in u.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..distributed.collective_ops import hand_out, reduce_in_rank_order
from ..distributed.transpiler import OPTIMIZE_OPS, Collective
from ..framework.registry import register_op
from ..ops.common import X


def topk_count(numel: int, sparsity: float) -> int:
    """k of a gradient of ``numel`` elements: the pairs each rank sends."""
    return max(1, int(round(numel * (1.0 - sparsity))))


def _phases(m, nesterov, gf, u, v, mean_g, k):
    """(dense, sparse) results of one rank: (out, u, v) each; the sparse
    out is the rank's chosen (idx, vals), summed by the caller."""
    u_d = m * u + mean_g
    dense = (mean_g + m * u_d if nesterov else u_d, u_d, v)
    u_s = m * (u + gf) if nesterov else m * u + gf
    v_s = v + (u_s + gf if nesterov else u_s)
    idx = torch.topk(v_s.abs(), k).indices
    sparse = ((idx, v_s[idx]), u_s.index_fill(0, idx, 0.0),
              v_s.index_fill(0, idx, 0.0))
    return dense, sparse


@register_op("dgc_allreduce", no_grad=True, collective=True)
def _dgc_allreduce(ctxs, ins_list, attrs):
    m = attrs.get("mu", 0.9)
    nesterov = bool(attrs.get("use_nesterov", False))
    sparsity = float(attrs.get("sparsity", 0.999))
    rampup = int(attrs.get("rampup_begin_step", 0))
    n = len(ins_list)
    gs = [X(ins, "X") for ins in ins_list]
    g0 = gs[0]
    numel = int(np.prod(g0.shape))
    k = topk_count(numel, sparsity)
    dev0 = g0.device
    gfs = [g.reshape(-1).float() for g in gs]
    mean_g = (reduce_in_rank_order(gfs) / n if n > 1 else gfs[0])
    per_rank = []
    for gf, ins in zip(gfs, ins_list):
        per_rank.append(_phases(
            m, nesterov, gf, X(ins, "U").reshape(-1),
            X(ins, "V").reshape(-1), mean_g.to(gf.device), k))
    idx = torch.cat([s[0][0].to(dev0) for _, s in per_rank])
    vals = torch.cat([s[0][1].to(dev0) for _, s in per_rank])
    summed = torch.zeros(numel, dtype=torch.float32, device=dev0)
    summed.index_put_((idx,), vals, accumulate=True)
    if n > 1:
        summed = summed / n
    sparse_outs = hand_out(summed, gs)
    outs = []
    for r, (ins, (dense, sparse)) in enumerate(zip(ins_list, per_rank)):
        step = X(ins, "Step")
        chosen = [sparse_outs[r], sparse[1], sparse[2]]
        if rampup > 0:
            on = step.reshape(()) >= rampup
            chosen = [torch.where(on, s, d) for s, d in zip(chosen, dense)]
        out, u_out, v_out = chosen
        outs.append({"Out": [out.reshape(gs[r].shape).to(gs[r].dtype)],
                     "UOut": [u_out], "VOut": [v_out],
                     "StepOut": [(step + 1.0).to(step.dtype)]})
    return outs


@register_op("dgc_momentum", no_grad=True)
def _dgc_momentum(ctx, ins, attrs):
    """ref dgc_momentum_op.cc: momentum is folded into the DGC u buffer, so
    the update is plain SGD on the compressed, corrected gradient."""
    p, g = X(ins, "Param"), X(ins, "Grad")
    lr = X(ins, "LearningRate")
    out = {"ParamOut": [p - lr.reshape(()) * g]}
    vel = X(ins, "Velocity")
    if vel is not None:
        out["VelocityOut"] = [vel]
    return out


@register_op("dgc_clip_by_norm", no_grad=True)
def _dgc_clip_by_norm(ctx, ins, attrs):
    """ref dgc_clip_by_norm_op.cc: a local grad-norm clip before
    compression, the threshold over sqrt(nranks) (each rank holds 1/n of
    the batch, so its norms run smaller)."""
    x = X(ins, "X")
    nranks = int(getattr(ctx, "nranks", 1))
    max_norm = attrs.get("max_norm", 1.0) / math.sqrt(float(nranks))
    norm = torch.sqrt(torch.sum(torch.square(x.float())))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {"Out": [(x * scale).to(x.dtype)]}


class DGCGradAllReduce(Collective):
    """Transpiler: rewrite DGC-tagged momentum ops into ``dgc_allreduce`` +
    ``dgc_momentum``; the remaining gradients get the standard scale +
    ``c_allreduce_sum`` (ref build_strategy's SparseAllReduceOpHandle
    beside the plain AllReduceOpHandle)."""

    def transpile(self, startup_program=None, main_program=None, **kw):
        from ..framework import core
        self._startup = startup_program or core.default_startup_program()
        return super().transpile(startup_program, main_program, **kw)

    def _state_var(self, main_block, startup_block, name, shape, value=0.0):
        main_block.create_var(name=name, shape=shape, dtype="float32",
                              persistable=True)
        startup_block.create_var(name=name, shape=shape, dtype="float32",
                                 persistable=True)
        startup_block.append_op(
            "fill_constant", outputs={"Out": [name]},
            attrs={"shape": list(shape), "dtype": "float32",
                   "value": float(value)})

    def _transpile_main(self, main):
        block = main.global_block()
        sblock = self._startup.global_block()
        dgc_ops = []
        plain_grads = []
        first_opt = None
        for i, op in enumerate(block.ops):
            if op.type == "momentum" and op.attrs.get("dgc"):
                if first_opt is None:
                    first_opt = i
                dgc_ops.append(op)
            elif op.type in OPTIMIZE_OPS:
                if first_opt is None:
                    first_opt = i
                for g in op.input("Grad"):
                    if g and g not in plain_grads:
                        plain_grads.append(g)
        if first_opt is None:
            return
        at = first_opt
        for op in dgc_ops:
            g = op.input("Grad")[0]
            p = op.input("Param")[0]
            numel = int(np.prod(block.var(p).shape))
            u_n, v_n, s_n = (g + "@DGC_U", g + "@DGC_V", g + "@DGC_STEP")
            self._state_var(block, sblock, u_n, (numel,))
            self._state_var(block, sblock, v_n, (numel,))
            self._state_var(block, sblock, s_n, (1,))
            clip = op.attrs.get("local_grad_clip_norm")
            if clip is not None:
                block.insert_op(
                    at, "dgc_clip_by_norm",
                    inputs={"X": [g]}, outputs={"Out": [g]},
                    attrs={"max_norm": float(clip), "ring_id": 0})
                at += 1
            block.insert_op(
                at, "dgc_allreduce",
                inputs={"X": [g], "U": [u_n], "V": [v_n], "Step": [s_n]},
                outputs={"Out": [g], "UOut": [u_n], "VOut": [v_n],
                         "StepOut": [s_n]},
                attrs={"mu": op.attrs.get("mu", 0.9),
                       "use_nesterov": op.attrs.get("use_nesterov", False),
                       "sparsity": op.attrs.get("sparsity", 0.999),
                       "rampup_begin_step":
                       op.attrs.get("rampup_begin_step", 0),
                       "ring_id": 0})
            at += 1
            op.type = "dgc_momentum"
        self._append_dense_allreduce(block, at, plain_grads)
