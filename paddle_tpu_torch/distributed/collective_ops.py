"""``c_*`` collective ops (the port of
``paddle_tpu/distributed/collective_ops.py``; ref ``operators/collective/``).

The reference lowers each op to an XLA collective over a mesh axis inside
the executor's collective ``shard_map``.  The port's executor runs the
block rank by rank (``framework/executor.py``, collective mode), so a
collective op sees every rank's input at once: it is registered with
``collective=True`` and its lowering takes the list of per-rank inputs and
returns the list of per-rank outputs.  A transpiled program's op reduces
over all the collective mode's ranks (``ring_id`` selects the ``dp`` ring,
one axis, as in the reference); an op with a ``mesh_axis`` attr (what the
SPMD lowering of ``parallel/spmd.py`` emits) reduces within each ring of
that axis of a 2-D mesh (:func:`rank_groups`).

- A reduction runs in rank order on the ring's first device, as XLA's CPU
  allreduce sums (``torch`` sums, 16-bit floats accumulated in float32,
  maxima, minima; ``c_allreduce_prod`` gathers then multiplies, as the
  reference's ``_pprod``); then each rank gets its own tensor on its own
  device, and no rank's output aliases another's.  ``scale`` multiplies
  the sum (a mean over the ring); ``contrib="first"`` sums the ring's first
  rank's tensor with zeros from the others.
- ``c_broadcast`` hands out the root's value, ``c_allgather`` concatenates
  on ``axis`` (dim 0 by default), ``c_reducescatter`` gives rank r the r-th
  ``axis`` tile of the sum; with ``flat`` both work on the flattened
  tensor, padded to the ring (the SPMD lowering's gradient halves).
- ``c_alltoall`` (the SPMD lowering's) turns a dim split into contiguous
  blocks over the ring into the layout whose split into ``sections`` equal
  parts gives each rank its block of every part, or back (``inverse``).
- ``c_split`` keeps the rank's slice of dim 0, or of ``axis`` over
  ``mesh_axis`` (no traffic: a per-rank op reading the rank's coordinates).
- Over a group of one (outside collective mode) every op is the identity.
- ``c_sync_calc_stream`` / ``c_sync_comm_stream`` are the identity (one
  stream orders the ranks' work), and the ring bootstrap ops
  (``c_gen_nccl_id``, ``c_comm_init``, ``c_comm_init_all``,
  ``gen_nccl_id``) do nothing.

Gradients: each differentiable group op has a group VJP that sees every
rank's output gradient, the transposes the reference's ``shard_map``
(``check_vma=False``) gives: ``psum``'s is ``psum``, ``all_gather``'s
``psum_scatter`` and back, the broadcast's the sum of every rank's
gradient on the root.  ``c_allreduce_max`` / ``_min`` have none, as
``lax.pmax`` has no differentiation rule.  ``sync_batch_norm`` (ref
``ops/compat_ops.py:534-575``) normalizes with the batch moments of every
rank of the ring, forward and backward.  The reductions are plain ``torch``
calls: the reference computes them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import List

import numpy as np

import torch

from ..framework.registry import register_op
from ..ops.common import X

#: the op types registered here (the reference's 14)
COLLECTIVE_OP_TYPES = (
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_broadcast", "c_allgather", "c_reducescatter",
    "c_split", "c_sync_calc_stream", "c_sync_comm_stream",
    "c_gen_nccl_id", "c_comm_init", "c_comm_init_all", "gen_nccl_id")


def rank_groups(ctxs, attrs) -> List[List[int]]:
    """The rings an op reduces within: those of its ``mesh_axis`` over the
    ranks' mesh, else one ring of every rank."""
    axis = attrs.get("mesh_axis")
    mesh = getattr(ctxs[0], "mesh", None) if ctxs else None
    if not axis or mesh is None:
        return [list(range(len(ctxs)))]
    from ..parallel.mesh import axis_groups
    return axis_groups(mesh, axis)


def _per_group(fn):
    """A group lowering applying ``fn(xs, attrs) -> outs`` to each ring."""
    def lower(ctxs, ins_list, attrs):
        outs = [None] * len(ins_list)
        for g in rank_groups(ctxs, attrs):
            xs = [X(ins_list[r], "X") for r in g]
            got = xs if len(g) == 1 else fn(xs, attrs)
            for r, v in zip(g, got):
                outs[r] = {"Out": [v]}
        return outs
    return lower


def hand_out(value: torch.Tensor, like: List[torch.Tensor]) -> list:
    """``value`` (fresh, on rank 0's device) for every rank: rank 0 keeps
    it, each other rank gets its own copy on its own device."""
    return [value if r == 0 else value.to(x.device, copy=True)
            for r, x in enumerate(like)]


def reduce_in_rank_order(xs: List[torch.Tensor], op=torch.add):
    """``op`` over the ranks' tensors in rank order, on rank 0's device,
    into a fresh tensor.  A sum of 16-bit floats accumulates in float32
    and rounds once, as XLA's allreduce does."""
    dev, dtype = xs[0].device, xs[0].dtype
    wide = op is torch.add and dtype in (torch.bfloat16, torch.float16)
    acc = op(xs[0].to(dev, torch.float32) if wide else xs[0],
             xs[1].to(dev, torch.float32 if wide else dtype))
    for x in xs[2:]:
        acc = op(acc, x.to(dev, acc.dtype), out=acc)
    return acc.to(dtype) if wide else acc


def _allreduce(kind):
    fn = {"sum": torch.add, "max": torch.maximum,
          "min": torch.minimum}.get(kind)

    def reduce(xs, attrs):
        if kind == "prod":
            dev = xs[0].device
            acc = torch.stack([x.to(dev) for x in xs]).prod(0)
        else:
            if attrs.get("contrib") == "first":
                xs = [xs[0]] + [torch.zeros_like(x) for x in xs[1:]]
            acc = reduce_in_rank_order(xs, fn)
        if attrs.get("scale") is not None:
            acc = acc * attrs["scale"]
        return hand_out(acc, xs)
    return _per_group(reduce)


def _broadcast(xs, attrs):
    root = int(attrs.get("root", 0) or 0)
    return [xs[root] if r == root else xs[root].to(x.device, copy=True)
            for r, x in enumerate(xs)]


def _allgather(xs, attrs):
    dev = xs[0].device
    if attrs.get("flat"):
        return hand_out(torch.cat([x.to(dev).reshape(-1) for x in xs]), xs)
    return hand_out(torch.cat([x.to(dev) for x in xs],
                              int(attrs.get("axis", 0) or 0)), xs)


def _reducescatter(xs, attrs):
    n = len(xs)
    if attrs.get("flat"):
        m = -(-xs[0].numel() // n)
        pad = m * n - xs[0].numel()
        xs = [torch.nn.functional.pad(x.reshape(-1), (0, pad)) for x in xs]
        acc = reduce_in_rank_order(xs)
        return [acc[r * m:(r + 1) * m].to(x.device, copy=True)
                for r, x in enumerate(xs)]
    d = int(attrs.get("axis", 0) or 0)
    acc = reduce_in_rank_order(xs)
    m = acc.shape[d] // n
    return [acc.narrow(d, r * m, m).to(x.device, copy=True)
            for r, x in enumerate(xs)]


def _alltoall(xs, attrs):
    """Contiguous blocks of dim ``axis`` over the ring <-> each rank's block
    of every one of ``sections`` equal parts (``inverse`` goes back)."""
    n, k = len(xs), int(attrs["sections"])
    d = int(attrs.get("axis", 0)) % xs[0].dim()
    dev = xs[0].device
    full = torch.cat([x.to(dev) for x in xs], d)
    g = full.shape[d]
    lead, tail = full.shape[:d], full.shape[d + 1:]
    if attrs.get("inverse"):
        # the input's block r holds part j's r-th piece at its j-th place
        parts = full.reshape(*lead, n, k, g // (n * k), *tail)
        full = parts.transpose(d, d + 1).reshape(full.shape)
        return [full.narrow(d, r * (g // n), g // n).to(x.device,
                                                        copy=True)
                for r, x in enumerate(xs)]
    parts = full.reshape(*lead, k, n, g // (n * k), *tail)
    return [parts.select(d + 1, r).reshape(*lead, g // n, *tail)
            .to(x.device, copy=True) for r, x in enumerate(xs)]


register_op("c_allreduce_sum", _allreduce("sum"), collective=True,
            grad=lambda: _vjp_allreduce_sum)
register_op("c_allreduce_max", _allreduce("max"), collective=True)
register_op("c_allreduce_min", _allreduce("min"), collective=True)
register_op("c_allreduce_prod", _allreduce("prod"), collective=True,
            grad=lambda: _vjp_allreduce_prod)
register_op("c_broadcast", _per_group(_broadcast), collective=True,
            grad=lambda: _vjp_broadcast)
register_op("c_allgather", _per_group(_allgather), collective=True,
            grad=lambda: _vjp_allgather)
register_op("c_reducescatter", _per_group(_reducescatter), collective=True,
            grad=lambda: _vjp_reducescatter)
register_op("c_alltoall", _per_group(_alltoall), collective=True,
            no_grad=True)


# -- group VJPs: every rank's output gradient in, every rank's input
# gradient out (an absent output gradient is a zero cotangent) -----------

def _vjp(fn):
    def lower(ctxs, ins_list, attrs):
        outs = [None] * len(ins_list)
        for g in rank_groups(ctxs, attrs):
            xs = [ins_list[r]["X$X"][0] for r in g]
            dys = [ins_list[r].get("OG$Out", [None])[0] for r in g]
            given = [dy for dy in dys if dy is not None]
            if not given:
                got = [torch.zeros_like(x) for x in xs]
            else:
                dys = [torch.zeros_like(given[0], device=x.device)
                       if dy is None else dy for x, dy in zip(xs, dys)]
                got = fn(xs, dys, attrs)
            for r, v in zip(g, got):
                outs[r] = {"IG$X": [v]}
        return outs
    return lower


def _sum_dys(xs, dys, attrs):
    return hand_out(reduce_in_rank_order(dys), xs) if len(xs) > 1 \
        else [dys[0]]


def _allgather_t(xs, dys, attrs):
    if len(xs) == 1:
        return [dys[0]]
    return _reducescatter(dys, attrs)


def _reducescatter_t(xs, dys, attrs):
    if len(xs) == 1:
        return [dys[0]]
    return _allgather(dys, attrs)


def _broadcast_t(xs, dys, attrs):
    root = int(attrs.get("root", 0) or 0)
    if len(xs) == 1:
        return [dys[0]]
    total = reduce_in_rank_order(dys)
    return [total.to(x.device, copy=True) if r == root
            else torch.zeros_like(x) for r, x in enumerate(xs)]


def _prod_t(xs, dys, attrs):
    if len(xs) == 1:
        return [dys[0]]
    dev = xs[0].device
    stack = torch.stack([x.to(dev) for x in xs])
    total = reduce_in_rank_order(dys)
    out = []
    for r, x in enumerate(xs):
        others = torch.cat([stack[:r], stack[r + 1:]]).prod(0)
        out.append((total * others).to(x.device))
    return out


_vjp_allreduce_sum = _vjp(_sum_dys)
_vjp_allgather = _vjp(_allgather_t)
_vjp_reducescatter = _vjp(_reducescatter_t)
_vjp_broadcast = _vjp(_broadcast_t)
_vjp_allreduce_prod = _vjp(_prod_t)


@register_op("c_split")
def _c_split(ctx, ins, attrs):
    """Each rank keeps its slice of dim 0 (the inverse of c_allgather), or
    of ``axis`` over ``mesh_axis`` by its coordinate there."""
    x = X(ins, "X")
    axis_name = attrs.get("mesh_axis")
    mesh = getattr(ctx, "mesh", None)
    if axis_name:
        if mesh is None or axis_name not in mesh.axis_names:
            return {"Out": [x]}
        n = int(mesh.shape[axis_name])
        r = int(ctx.coords[axis_name])
    else:
        n, r = int(getattr(ctx, "nranks", 1)), int(getattr(ctx, "rank", 0))
    if n == 1:
        return {"Out": [x]}
    d = int(attrs.get("axis", 0) or 0)
    m = x.shape[d] // n
    return {"Out": [x.narrow(d, r * m, m).clone()]}


@register_op("spmd_alias")
def _spmd_alias(ctx, ins, attrs):
    """The SPMD lowering's adjoint of a forward all-reduce: the complete
    gradient passes as it is."""
    return {"Out": [X(ins, "X")]}


def _identity(ctx, ins, attrs):
    x = X(ins, "X")
    return {"Out": [x]} if x is not None else {}


register_op("c_sync_calc_stream", _identity)
register_op("c_sync_comm_stream", _identity)


def _noop(ctx, ins, attrs):
    return {}


# ring bootstrap: the process group's rendezvous replaces the reference's
# RPC ncclUniqueId exchange (gen_nccl_id_op.cc); with virtual ranks in one
# process there is nothing to exchange
for _t in ("c_gen_nccl_id", "c_comm_init", "c_comm_init_all",
           "gen_nccl_id"):
    register_op(_t, _noop, no_grad=True)


# -- sync_batch_norm (ref ops/compat_ops.py:534-575) -------------------------

def _sync_bn_forward(xs, scales, biases, means, variances, attrs):
    """Batch norm of every rank of a ring with the ring's batch moments
    (sums over the ranks in rank order), differentiable; one output dict
    a rank."""
    from ..ops.nn_ops import _bn_axes
    eps = float(attrs.get("epsilon", 1e-5))
    momentum = float(attrs.get("momentum", 0.9))
    layout = attrs.get("data_layout", "NCHW")
    is_test = attrs.get("is_test", False) or \
        attrs.get("use_global_stats", False)
    axes, bshape = _bn_axes(layout, xs[0].dim())
    dev = xs[0].device
    outs = []
    if is_test:
        stats = [(mu, var, mu, var) for mu, var in zip(means, variances)]
    else:
        xf = [x.float() for x in xs]
        cnt = float(sum(int(np.prod([x.shape[a] for a in axes]))
                        for x in xs))
        s1 = s2 = None
        for x in xf:            # in rank order, differentiable
            a, b = x.sum(axes).to(dev), x.square().sum(axes).to(dev)
            s1 = a if s1 is None else s1 + a
            s2 = b if s2 is None else s2 + b
        m = s1 / cnt
        v = s2 / cnt - m.square()
        stats = []
        for mu, var in zip(means, variances):
            d = mu.device
            stats.append((m.to(d), v.to(d),
                          mu * momentum + m.to(d) * (1 - momentum),
                          var * momentum + v.to(d) * (1 - momentum)))
    for x, sc, b, (m, v, mo, vo) in zip(xs, scales, biases, stats):
        inv = torch.rsqrt(v.reshape(bshape) + eps)
        y = (x.float() - m.reshape(bshape)) * inv * sc.reshape(bshape) + \
            b.reshape(bshape)
        outs.append({"Y": [y.to(x.dtype)], "MeanOut": [mo],
                     "VarianceOut": [vo], "SavedMean": [m],
                     "SavedVariance": [torch.rsqrt(v + eps)]})
    return outs


def _sync_bn(ctxs, ins_list, attrs):
    outs = [None] * len(ins_list)
    for g in rank_groups(ctxs, attrs):
        got = _sync_bn_forward(
            *[[ins_list[r][s][0] for r in g]
              for s in ("X", "Scale", "Bias", "Mean", "Variance")], attrs)
        for r, o in zip(g, got):
            outs[r] = o
    return outs


def _sync_bn_vjp(ctxs, ins_list, attrs):
    """The gradient through the ring's moments: autograd over every rank's
    inputs at once (the reference's psum transposes to a psum)."""
    outs = [None] * len(ins_list)
    for g in rank_groups(ctxs, attrs):
        leaves = {s: [ins_list[r]["X$" + s][0].detach().requires_grad_(
            True) for r in g] for s in ("X", "Scale", "Bias")}
        stats = {s: [ins_list[r]["X$" + s][0] for r in g]
                 for s in ("Mean", "Variance")}
        with torch.enable_grad():
            got = _sync_bn_forward(leaves["X"], leaves["Scale"],
                                   leaves["Bias"], stats["Mean"],
                                   stats["Variance"], attrs)
            ys, dys = [], []
            for r, o in zip(g, got):
                dy = ins_list[r].get("OG$Y", [None])[0]
                if dy is not None:
                    ys.append(o["Y"][0])
                    dys.append(dy.to(o["Y"][0].dtype))
            wrt = leaves["X"] + leaves["Scale"] + leaves["Bias"]
            grads = torch.autograd.grad(ys, wrt, dys, allow_unused=True) \
                if ys else [None] * len(wrt)
        n = len(g)
        grads = [torch.zeros_like(t) if d is None else d
                 for t, d in zip(wrt, grads)]
        for j, r in enumerate(g):
            outs[r] = {"IG$X": [grads[j]], "IG$Scale": [grads[n + j]],
                       "IG$Bias": [grads[2 * n + j]],
                       "IG$Mean": [None], "IG$Variance": [None]}
    return outs


register_op("sync_batch_norm", _sync_bn, collective=True,
            grad=lambda: _sync_bn_vjp)
