"""``c_*`` collective ops (the port of
``paddle_tpu/distributed/collective_ops.py``; ref ``operators/collective/``).

The reference lowers each op to an XLA collective over a mesh axis inside
the executor's collective ``shard_map``.  The port's executor runs the
block rank by rank (``framework/executor.py``, collective mode), so a
collective op sees every rank's input at once: it is registered with
``collective=True`` and its lowering takes the list of per-rank inputs and
returns the list of per-rank outputs.  ``ring_id`` selects the ring, which
is the collective mode's ``dp`` axis (one axis, as in the reference).

- A reduction runs in rank order on rank 0's device, as XLA's CPU
  allreduce sums (``torch`` sums, 16-bit floats accumulated in float32,
  maxima, minima; ``c_allreduce_prod`` gathers then multiplies, as the
  reference's ``_pprod``); then each rank gets its own tensor on its own
  device, and no rank's output aliases another's.
- ``c_broadcast`` hands out the root's value, ``c_allgather`` concatenates
  on dim 0, ``c_reducescatter`` gives rank r the r-th dim-0 tile of the sum.
- ``c_split`` keeps the rank's slice of dim 0 (no traffic: a per-rank op
  reading ``ctx.rank`` / ``ctx.nranks``).
- Over a group of one (outside collective mode) every op is the identity.
- ``c_sync_calc_stream`` / ``c_sync_comm_stream`` are the identity (one
  stream orders the ranks' work), and the ring bootstrap ops
  (``c_gen_nccl_id``, ``c_comm_init``, ``c_comm_init_all``,
  ``gen_nccl_id``) do nothing.

No collective has a gradient yet: an autograd graph that would
differentiate one raises ``NotImplementedError`` (``registry.
collective_grad_error``); collectives with gradients come with the GSPMD
slice.  The reductions are plain ``torch`` calls: the reference computes
them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import List

import torch

from ..framework.registry import register_op
from ..ops.common import X

#: the op types registered here (the reference's 14)
COLLECTIVE_OP_TYPES = (
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_broadcast", "c_allgather", "c_reducescatter",
    "c_split", "c_sync_calc_stream", "c_sync_comm_stream",
    "c_gen_nccl_id", "c_comm_init", "c_comm_init_all", "gen_nccl_id")


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


def _outs(vals):
    return [{"Out": [v]} for v in vals]


def _allreduce(kind):
    fn = {"sum": torch.add, "max": torch.maximum,
          "min": torch.minimum}.get(kind)

    def lower(ctxs, ins_list, attrs):
        xs = [X(ins, "X") for ins in ins_list]
        if len(xs) == 1:
            return _outs(xs)
        if kind == "prod":
            dev = xs[0].device
            acc = torch.stack([x.to(dev) for x in xs]).prod(0)
        else:
            acc = reduce_in_rank_order(xs, fn)
        return _outs(hand_out(acc, xs))
    return lower


for _kind in ("sum", "max", "min", "prod"):
    register_op(f"c_allreduce_{_kind}", _allreduce(_kind), collective=True)


@register_op("c_broadcast", collective=True)
def _c_broadcast(ctxs, ins_list, attrs):
    xs = [X(ins, "X") for ins in ins_list]
    if len(xs) == 1:
        return _outs(xs)
    root = int(attrs.get("root", 0) or 0)
    return _outs([xs[root] if r == root else xs[root].to(x.device,
                                                         copy=True)
                  for r, x in enumerate(xs)])


@register_op("c_allgather", collective=True)
def _c_allgather(ctxs, ins_list, attrs):
    xs = [X(ins, "X") for ins in ins_list]
    if len(xs) == 1:
        return _outs(xs)
    dev = xs[0].device
    return _outs(hand_out(torch.cat([x.to(dev) for x in xs], 0), xs))


@register_op("c_reducescatter", collective=True)
def _c_reducescatter(ctxs, ins_list, attrs):
    xs = [X(ins, "X") for ins in ins_list]
    n = len(xs)
    if n == 1:
        return _outs(xs)
    acc = reduce_in_rank_order(xs)
    m = acc.shape[0] // n
    return _outs([acc[r * m:(r + 1) * m].to(x.device, copy=True)
                  for r, x in enumerate(xs)])


@register_op("c_split")
def _c_split(ctx, ins, attrs):
    """Each rank keeps its slice of dim 0 (the inverse of c_allgather)."""
    x = X(ins, "X")
    n = int(getattr(ctx, "nranks", 1))
    if n == 1:
        return {"Out": [x]}
    m = x.shape[0] // n
    r = int(ctx.rank)
    return {"Out": [x[r * m:(r + 1) * m].clone()]}


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
