"""SPMD over a mesh of ranks: the port's counterpart of what ``jax.sharding``
and XLA's SPMD partitioner do for ``paddle_tpu``'s GSPMD path.

Values
------
:class:`Sharding` is a mesh and a spec (a mesh axis or None per dim);
:class:`ShardedValue` is a global tensor held as one local ``torch.Tensor``
a rank, each on its rank's device (a rank's slice of every dim its spec
shards; a copy on every rank of the rest).  A partitioned program's scope
holds its sharded parameters and ZeRO-1 optimizer state as
``ShardedValue`` s between steps; ``numpy()`` gathers one.

The lowering
------------
:func:`lower_program` rewrites a partitioned program (the partition stamp
of ``parallel.partitioner``, or the ``dist_spec`` s of
``CompiledProgram.with_distributed``) into ONE per-rank program that every
rank of the mesh runs on its local shards, and the executor's collective
mode runs it segment by segment, rank by rank (``framework/executor.py``).
The sharding plan (``analysis.sharding.plan_sharding``) is the contract:
every edge of it becomes one collective op on the ring of its mesh axis
(``parallel.mesh.axis_groups``) at the op the edge names, carrying the
edge's index and payload, which the executor counts when the op runs.

- forward edges sit after their producer: a row-parallel matmul's partial
  sum (``partial_sum``) is all-reduced; a constraint gathers a var whose
  natural layout is sharded (``c_allgather``); the QKV pack's ``split``
  edge is a ``c_alltoall`` into the layout whose local split gives each
  rank its heads; a vocab-sharded ``lookup_table`` masks the ids outside
  the rank's rows and all-reduces (``vocab_embed``); a vocab-sharded
  ``softmax_with_cross_entropy`` reduces its max, its sum of exponentials
  and its label logit over the ring (``vocab_ce``: the plan prices the
  last as a backward edge, the loss needs it in the forward);
- backward edges sit after the grad op that makes the partial gradient:
  a column-parallel matmul's dX is all-reduced (``grad_partial``; where
  the program wants no dX, as for a feed, the grad op makes it anyway and
  the edge reduces it); the embedding's backward edge is an all-reduce to
  which only the ring's first rank contributes, which leaves the
  complete gradient exact;
- dp gradient sync around each optimizer op: an all-reduce
  (``grad_sync``), or ZeRO-1's reduce-scatter of the gradient, the update
  of the rank's accumulator shard and the all-gather of the parameter
  (``zero1_grad`` / ``zero1_param``; a parameter whose accumulators cannot
  take ``dp`` on dim 0 reduce-scatters and all-gathers its flattened
  gradient, and updates replicated).

A layer_norm or softmax over a dim split over a ring (``norm_stats`` /
``softmax_stats``) is one group op summing each row's statistics over the
ring; a loss reduction over a split dim (``loss_reduce``) sums its partial
over the ring.

Adjoints: a constraint all-gather's is a slice (its output gradient is
complete on every rank), a forward all-reduce's an alias.  The gathers of
the q, k, v sections after the pack's all-to-all make the sections'
gradients complete on every rank, so the pack's gradient is the rank's
slice of their concatenation: the backward runs no all-to-all.  Traffic
the plan does not price is counted apart, under
``paddle_tpu_gspmd_unplanned_bytes_total{reason}``: the dp sums of batch
reductions (a loss's sums and means, which the plan leaves out as the
reference's does: ``batch_reduce``), and the backward of reshards whose
adjoint moves data (the inverse all-to-all of a pack whose sections stay
split: ``reshard_bwd``; the ring statistics of a split layer_norm or
softmax: ``norm_stats_bwd`` / ``softmax_stats_bwd``; the gather of the
whole operand's gradient after a join took its block: ``join_bwd``; the
reduce-scatter of a column-parallel matmul's partial dX after a one-sided
contraction gathered X: ``gather_bwd``).

Every other op runs unchanged on its local shards: an op consuming a
dp-sharded var must keep dim 0 a batch dim (:data:`_ROW_LOCAL`).  A layout
the lowering cannot run raises, naming the op, the var, the dim and the
mesh axis: nothing runs replicated or on another device instead.  Not
lowered yet (ROADMAP): sub-blocks, dropout above 0, AMP, ``gather`` edges
and constraint all-to-alls.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import monitor as _monitor
from ..distributed.transpiler import OPTIMIZE_OPS
from ..framework.core import Operator, Program, Variable, grad_var_name
from ..framework.registry import register_op
from ..ops.common import X
from .mesh import Mesh, mesh_axis_sizes, rank_coords

__all__ = ["Sharding", "ShardedValue", "SpmdLayout", "lower_program",
           "UNPLANNED_BYTES_CTR"]

#: collective traffic a partitioned step moves beyond its reshard plan
UNPLANNED_BYTES_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_gspmd_unplanned_bytes_total",
    "payload bytes of SPMD collectives that are no reshard-plan edge: "
    "dp sums of batch reductions, backward reshards", ("reason",))

_ROADMAP = "ROADMAP Queue 1 item 3 (i)"


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------

def _pad_spec(spec, rank: int) -> tuple:
    spec = tuple(spec or ())
    return (spec + (None,) * rank)[:rank]


class Sharding:
    """A spec over a mesh: ``spec[d]`` is the mesh axis dim ``d`` is split
    over, or None (replicated).  A rank's slice of a sharded dim is the
    block at its coordinate on that axis."""

    def __init__(self, mesh: Mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec or ())

    def shard_shape(self, shape) -> tuple:
        sizes = mesh_axis_sizes(self.mesh)
        out = []
        for d, a in zip(shape, _pad_spec(self.spec, len(shape))):
            n = sizes.get(a, 1) if a else 1
            if d % n:
                raise ValueError(f"dim of size {d} does not divide mesh "
                                 f"axis {a!r} of size {n}")
            out.append(d // n)
        return tuple(out)

    def rank_index(self, rank: int, shape) -> tuple:
        """The slices of rank ``rank``'s block of a global ``shape``."""
        coords = rank_coords(self.mesh, rank)
        local = self.shard_shape(shape)
        return tuple(
            slice(coords[a] * n, (coords[a] + 1) * n) if a else slice(None)
            for n, a in zip(local, _pad_spec(self.spec, len(shape))))

    def __eq__(self, other):
        return isinstance(other, Sharding) and other.mesh is self.mesh \
            and _pad_spec(other.spec, 8) == _pad_spec(self.spec, 8)

    def __hash__(self):
        return hash((id(self.mesh), _pad_spec(self.spec, 8)))

    def __repr__(self):
        return f"Sharding({self.spec}, mesh={self.mesh.shape})"


class ShardedValue:
    """A global tensor of ``shape`` and ``dtype`` held as ``locals_[r]``, the
    block of rank ``r`` under ``sharding``, on rank ``r``'s device.  On a
    mesh that spans processes a process holds its own ranks' blocks (the
    others are None), and :meth:`to_global` is a collective: every process
    must call it."""

    def __init__(self, shape, dtype, sharding: Sharding,
                 locals_: Sequence[torch.Tensor]):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.sharding = sharding
        self.locals = list(locals_)

    @classmethod
    def from_global(cls, t: torch.Tensor, sharding: Sharding):
        """Split ``t`` by ``sharding`` onto the mesh's devices (a copy a
        rank)."""
        devs = list(sharding.mesh.devices.flat)
        locs = []
        for r, d in enumerate(devs):
            piece = t[sharding.rank_index(r, t.shape)]
            locs.append(piece.to(d, copy=True).contiguous())
        return cls(t.shape, t.dtype, sharding, locs)

    def local(self, rank: int) -> torch.Tensor:
        return self.locals[rank]

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    def to_global(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (the first held block's by
        default); over several processes the blocks are exchanged first."""
        locs = self.locals
        device = device or next(t for t in locs if t is not None).device
        if any(t is None for t in locs):
            from ..distributed.xproc import span_of
            span = span_of(self.sharding.mesh)
            got = span.exchange({r: [locs[r]] for r in span.local},
                                torch.device(device))
            locs = [g[0] for g in got]
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for r, t in enumerate(locs):
            idx = self.sharding.rank_index(r, self.shape)
            key = tuple((s.start, s.stop) for s in idx)
            if key not in seen:
                seen.add(key)
                out[idx] = t.to(device)
        return out

    def numpy(self) -> np.ndarray:
        t = self.to_global(torch.device("cpu"))
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    @property
    def local_nbytes(self) -> int:
        t = next(t for t in self.locals if t is not None)
        return int(t.numel()) * int(t.element_size())

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * int(next(t for t in self.locals
                            if t is not None).element_size())

    def __repr__(self):
        return (f"ShardedValue(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, ranks={len(self.locals)})")


# ---------------------------------------------------------------------------
# per-rank op lowerings the lowering emits
# ---------------------------------------------------------------------------

def _axis_pos(ctx, axis: str) -> Tuple[int, int]:
    """(coordinate, size) of ``ctx``'s rank on mesh ``axis``."""
    mesh = getattr(ctx, "mesh", None)
    if mesh is None or axis not in mesh.axis_names:
        return 0, 1
    return int(ctx.coords[axis]), int(mesh_axis_sizes(mesh)[axis])


@register_op("spmd_vocab_lookup")
def _vocab_lookup(ctx, ins, attrs):
    """``lookup_table`` on the rank's rows of a vocab-sharded table: an id
    outside them gives a zero row, so the ring's sum is the lookup."""
    w, ids = X(ins, "W"), X(ins, "Ids")
    pos, _ = _axis_pos(ctx, attrs["mesh_axis"])
    rows = w.shape[0]
    ids = ids.long()
    if ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    local = ids - pos * rows
    pad = int(attrs.get("padding_idx", -1))
    keep = (local >= 0) & (local < rows)
    if pad >= 0:
        keep = keep & (ids != pad)
    out = torch.nn.functional.embedding(
        torch.where(keep, local, torch.zeros_like(local)), w)
    return {"Out": [out * keep.unsqueeze(-1).to(out.dtype)]}


@register_op("spmd_vocab_softmax_ce_grad")
def _vocab_ce_grad(ctx, ins, attrs):
    """``softmax_with_cross_entropy_grad`` on the rank's vocab block: the
    one-hot of a label outside its ``rows`` is zero there; a label equal
    to ``ignore_index`` (>= 0) gives a zero gradient."""
    sm, label, gloss = X(ins, "Softmax"), X(ins, "Label"), X(ins, "LossGrad")
    pos, _ = _axis_pos(ctx, attrs["mesh_axis"])
    li = label.long()
    if li.dim() == sm.dim() and li.shape[-1] == 1:
        li = li.squeeze(-1)
    local = (li - pos * int(attrs["rows"])).unsqueeze(-1)
    valid = (local >= 0) & (local < sm.shape[-1])
    onehot = torch.zeros_like(sm).scatter(
        -1, torch.where(valid, local, torch.zeros_like(local)),
        valid.to(sm.dtype))
    glogits = (sm - onehot) * gloss
    ignore = int(attrs.get("ignore_index", -100))
    if ignore >= 0:
        glogits = torch.where(li.unsqueeze(-1) != ignore, glogits,
                              torch.zeros_like(glogits))
    return {"LogitsGrad": [glogits]}


def _vocab_ce_groups(ctxs, ins_list, attrs):
    from ..distributed.collective_ops import rank_groups
    outs = [None] * len(ctxs)
    axis = int(attrs.get("axis", -1))
    for group in rank_groups(ctxs, attrs):
        dev = ins_list[group[0]]["Logits"][0].device
        logits = [ins_list[r]["Logits"][0].float() for r in group]
        rows = logits[0].shape[axis]
        m = torch.stack([lg.amax(axis, keepdim=True).to(dev)
                         for lg in logits]).amax(0)
        s = None
        for lg in logits:
            e = torch.exp(lg - m.to(lg.device)).sum(axis, keepdim=True)
            s = e.to(dev) if s is None else s + e.to(dev)
        picked = None
        for j, (r, lg) in enumerate(zip(group, logits)):
            label = ins_list[r]["Label"][0].long()
            if label.dim() == lg.dim() and label.shape[axis] == 1:
                label = label.squeeze(axis)
            local = (label - j * rows).unsqueeze(axis)
            keep = (local >= 0) & (local < rows)
            val = torch.gather(lg, axis, torch.where(
                keep, local, torch.zeros_like(local))) * keep.to(lg.dtype)
            picked = val.to(dev) if picked is None else picked + val.to(dev)
        loss = m + torch.log(s) - picked
        ignore = int(attrs.get("ignore_index", -100))
        if ignore >= 0:
            lab = ins_list[group[0]]["Label"][0]
            if lab.dim() == loss.dim() - 1:
                lab = lab.unsqueeze(axis)
            loss = torch.where(lab.to(dev) != ignore, loss,
                               torch.zeros_like(loss))
        for r, lg in zip(group, logits):
            d = lg.device
            sm = torch.exp(lg - m.to(d)) / s.to(d)
            dtype = ins_list[r]["Logits"][0].dtype
            outs[r] = {"Softmax": [sm.to(dtype)],
                       "Loss": [loss.to(d, dtype, copy=True)]}
    return outs


register_op("spmd_vocab_softmax_ce", _vocab_ce_groups, collective=True)


def _ring_sum(ts, dev):
    """Rank-order sum of a ring's tensors on ``dev``, differentiable."""
    acc = None
    for t in ts:
        acc = t.to(dev) if acc is None else acc + t.to(dev)
    return acc


def _ring_layer_norm(ins, attrs):
    """``layer_norm`` of a ring whose normalized dim is split over it:
    each row's mean, then its sum of squared deviations, summed over the
    ring (the two statistics a row of the plan's ``norm_stats`` edge);
    the rank's block of the affine.  One output dict a rank."""
    xs = [X(i, "X") for i in ins]
    eps = float(attrs.get("epsilon", 1e-5))
    begin = int(attrs.get("begin_norm_axis", 1))
    dev = xs[0].device
    lead = tuple(xs[0].shape[:begin])
    x2 = [x.reshape(int(np.prod(lead)), -1).float() for x in xs]
    n = float(sum(x.shape[1] for x in x2))
    m = _ring_sum([x.sum(1, keepdim=True) for x in x2], dev) / n
    v = _ring_sum([(x - m.to(x.device)).square().sum(1, keepdim=True)
                   for x in x2], dev) / n
    inv = torch.rsqrt(v + eps)
    outs = []
    for j, (i, x, xf) in enumerate(zip(ins, xs, x2)):
        d = x.device
        y = (xf - m.to(d)) * inv.to(d)
        w = xf.shape[1]
        scale, bias = X(i, "Scale"), X(i, "Bias")
        if scale is not None:
            scale = scale.reshape(-1)
            if scale.numel() != w:          # whole: the rank's block
                scale = scale[j * w:(j + 1) * w]
            y = y * scale.float().reshape(1, -1)
        if bias is not None:
            bias = bias.reshape(-1)
            if bias.numel() != w:
                bias = bias[j * w:(j + 1) * w]
            y = y + bias.float().reshape(1, -1)
        outs.append({"Y": [y.reshape(x.shape).to(x.dtype)],
                     "Mean": [m.to(d).reshape(lead)],
                     "Variance": [v.to(d).reshape(lead)]})
    return outs


def _ring_softmax(ins, attrs):
    """``softmax`` over a dim split over the ring: the ring's max (no
    gradient: a stabilizer) and sum of exponentials, a row each (the
    plan's ``softmax_stats`` edge)."""
    xs = [X(i, "X").float() for i in ins]
    axis = int(attrs.get("axis", -1))
    dev = xs[0].device
    m = torch.stack([x.amax(axis, keepdim=True).to(dev)
                     for x in xs]).amax(0).detach()
    es = [torch.exp(x - m.to(x.device)) for x in xs]
    s = _ring_sum([e.sum(axis, keepdim=True) for e in es], dev)
    return [{"Out": [(e / s.to(e.device)).to(X(i, "X").dtype)]}
            for i, e in zip(ins, es)]


def _ln_whole(slot, t, ins, attrs):
    """A layer_norm's scale or bias held whole where its input's normalized
    dims are split: every rank uses its block of the same tensor."""
    x = ins["X$X"][0]
    width = int(np.prod(x.shape[int(attrs.get("begin_norm_axis", 1)):]))
    return slot in ("Scale", "Bias") and t.numel() != width


def _ring_op(fwd, whole=None):
    """A group lowering running ``fwd(ins of a ring, attrs)`` on each
    ring, and its VJP: ``fwd`` again under autograd over every rank's
    inputs at once, so the gradient runs through the ring's sums.  An
    input ``whole(slot, tensor, ins, attrs)`` marks as held whole on every
    rank
    is one leaf for the ring, whose gradient (the sum of the ranks')
    every rank gets."""
    from ..distributed.collective_ops import rank_groups

    def lower(ctxs, ins_list, attrs):
        outs = [None] * len(ins_list)
        for g in rank_groups(ctxs, attrs):
            for r, o in zip(g, fwd([ins_list[r] for r in g], attrs)):
                outs[r] = o
        return outs

    def vjp(ctxs, ins_list, attrs):
        outs = [None] * len(ins_list)
        for g in rank_groups(ctxs, attrs):
            per = [{s[2:]: [v.detach().requires_grad_(True)
                            if v is not None and v.is_floating_point()
                            else v for v in vals]
                    for s, vals in ins_list[r].items() if s.startswith("X$")}
                   for r in g]
            shared = set()
            for slot, vals in list(per[0].items()):
                if whole and vals and vals[0] is not None and \
                        whole(slot, vals[0], ins_list[g[0]], attrs):
                    shared.add(slot)
                    for d in per[1:]:
                        d[slot] = [vals[0].to(d[slot][0].device)
                                   if d[slot][0] is not None else None]
            with torch.enable_grad():
                got = fwd(per, attrs)
                ys, dys = [], []
                for r, o in zip(g, got):
                    for slot, vals in o.items():
                        for v, dy in zip(vals, ins_list[r].get(
                                "OG$" + slot) or []):
                            if dy is not None and v.requires_grad:
                                ys.append(v)
                                dys.append(dy.to(v.dtype))
                wrt = [(j, slot, k, t) for j, d in enumerate(per)
                       for slot, vals in d.items()
                       for k, t in enumerate(vals)
                       if t is not None and t.requires_grad]
                grads = torch.autograd.grad(
                    ys, [w[3] for w in wrt], dys, allow_unused=True) \
                    if ys else [None] * len(wrt)
            res = [{"IG$" + s: [None] * len(v) for s, v in d.items()}
                   for d in per]
            for (j, slot, k, t), gr in zip(wrt, grads):
                res[j]["IG$" + slot][k] = torch.zeros_like(t) \
                    if gr is None else gr
            for slot in shared:
                g0 = res[0]["IG$" + slot][0]
                for j, d in enumerate(res[1:], 1):
                    d["IG$" + slot] = [g0.to(per[j]["X"][0].device,
                                             copy=True)]
            for r, o in zip(g, res):
                outs[r] = o
        return outs
    return lower, vjp


_ln_lower, _ln_vjp = _ring_op(_ring_layer_norm, _ln_whole)
register_op("spmd_layer_norm", _ln_lower, collective=True,
            grad=lambda: _ln_vjp)
_sm_lower, _sm_vjp = _ring_op(_ring_softmax)
register_op("spmd_softmax", _sm_lower, collective=True,
            grad=lambda: _sm_vjp)


@register_op("spmd_unflatten", no_grad=True)
def _unflatten(ctx, ins, attrs):
    """A flat (padded) vector back in the shape of ``Like``."""
    like = X(ins, "Like")
    return {"Out": [X(ins, "X")[:like.numel()].reshape(like.shape)]}


# ---------------------------------------------------------------------------
# the lowering
# ---------------------------------------------------------------------------

#: op types that treat dim 0 as a batch dim (with the axis checks of
#: :meth:`_Lowering.check_row_local`): they run unchanged on a rank's rows
_ROW_LOCAL = frozenset((
    "lookup_table", "lookup_table_v2", "elementwise_add", "elementwise_sub",
    "elementwise_mul", "elementwise_div", "elementwise_max",
    "elementwise_min", "elementwise_pow", "relu", "gelu", "tanh",
    "sigmoid", "exp", "log", "sqrt", "square", "abs", "sign", "scale",
    "cast", "assign", "softmax", "layer_norm", "mul", "matmul",
    "matmul_v2", "reshape", "reshape2", "transpose", "transpose2", "split",
    "concat", "unsqueeze", "unsqueeze2", "squeeze", "squeeze2",
    "flash_attention", "cross_entropy", "softmax_with_cross_entropy",
    "fused_lm_head_ce", "greater_than", "less_than", "greater_equal",
    "less_equal", "equal", "not_equal", "slice", "dropout", "sum", "clip",
    "pow", "leaky_relu", "square_error_cost", "fill_zeros_like",
    "fill_constant_batch_size_like", "conv2d", "depthwise_conv2d",
    "pool2d", "flatten", "flatten2",
))

_BATCH_REDUCE = frozenset(("mean", "reduce_sum", "reduce_mean"))

#: edge reasons the lowering runs (the rest raise NotImplementedError)
_LOWERED = frozenset((
    "partial_sum", "grad_partial", "vocab_embed", "vocab_ce", "constraint",
    "split", "spec_mismatch", "loss_reduce", "norm_stats", "softmax_stats",
    "grad_sync", "zero1_grad", "zero1_param",
))


@dataclass
class SpmdLayout:
    """What the executor needs to run a lowered program: the per-rank
    program, the mesh, each scope persistable's layout between steps
    (``scope_specs``, None = replicated), each feed's layout, and each
    fetch's layout and the per-rank var that holds it."""

    program: Program
    mesh: Mesh
    plan: Any
    scope_specs: Dict[str, Optional[tuple]]
    feed_specs: Dict[str, Optional[tuple]]
    #: fetch name -> (per-rank var, spec of its global value)
    fetches: Dict[str, Tuple[str, Optional[tuple]]]
    global_shapes: Dict[str, tuple]
    #: collective ops in the per-rank program
    n_collectives: int = 0
    devices: List[torch.device] = field(default_factory=list)

    def sharding(self, spec) -> Sharding:
        return Sharding(self.mesh, spec)

    def split_feeds(self, feed, to_device, ranks=None) -> list:
        """Each rank's feeds, sliced by their layout (a batch the dp axis
        does not divide raises); with ``ranks``, those ranks' only (the
        others' entries are None)."""
        n = len(self.devices)
        ranks = range(n) if ranks is None else ranks
        envs: list = [None] * n
        for r in ranks:
            envs[r] = {}
        sizes = mesh_axis_sizes(self.mesh)
        for name, v in feed.items():
            t = to_device(v)
            spec = _pad_spec(self.feed_specs.get(name), t.dim())
            for d, a in enumerate(spec):
                if a and t.shape[d] % sizes[a]:
                    raise ValueError(
                        f"SPMD: feed {name!r} has {t.shape[d]} on dim {d}, "
                        f"which mesh axis {a!r} of size {sizes[a]} does "
                        "not divide")
            sh = self.sharding(spec)
            for r in ranks:
                envs[r][name] = t[sh.rank_index(r, t.shape)].to(
                    self.devices[r])
        return envs

    def reader(self, scope, read_global, rank: int):
        """Rank ``rank``'s reader of the scope: a persistable's local block
        under its layout (sliced from a global tensor, or re-sliced from a
        ``ShardedValue`` of another layout, once a step)."""
        dev = self.devices[rank]
        cache: Dict[str, torch.Tensor] = {}

        def read(name):
            if name in cache:
                return cache[name]
            want = self.scope_specs.get(name)
            v = scope.find_var(name)
            if isinstance(v, ShardedValue):
                if any(want or ()) and \
                        _pad_spec(v.spec, len(v.shape)) == \
                        _pad_spec(want, len(v.shape)):
                    out = v.local(rank)
                else:
                    g = v.to_global(dev)
                    out = g[self.sharding(want).rank_index(rank, g.shape)] \
                        if any(want or ()) else g
            else:
                g = read_global(name)
                if any(want or ()):
                    out = g[self.sharding(want).rank_index(rank, g.shape)]
                    out = out.to(dev, copy=True).contiguous()
                else:
                    out = g if g.device == dev else g.to(dev)
            cache[name] = out
            return out
        return read

    def assemble(self, name: str, vals: List[Optional[torch.Tensor]]):
        """The scope value of persistable ``name`` from every rank's (None
        for a rank another process runs)."""
        spec = self.scope_specs.get(name)
        mine = next(v for v in vals if v is not None)
        if not any(spec or ()):
            return mine
        shape = self.global_shapes[name]
        return ShardedValue(shape, mine.dtype, self.sharding(spec), vals)

    def gather(self, name: str, vals: List[torch.Tensor]) -> torch.Tensor:
        """A fetch's global value from every rank's local one."""
        _, spec = self.fetches[name]
        if not any(spec or ()):
            return vals[0]
        sh = self.sharding(spec)
        shape = list(vals[0].shape)
        sizes = mesh_axis_sizes(self.mesh)
        for d, a in enumerate(_pad_spec(spec, len(shape))):
            if a:
                shape[d] *= sizes[a]
        return ShardedValue(shape, vals[0].dtype, sh, vals).to_global()


class _Rec:
    """How forward op ``i`` was lowered, for its grad op."""

    def __init__(self):
        self.type = None            # forward op type in the lowered program
        self.attrs = None           # its attrs there
        self.in_map: Dict[str, str] = {}     # input -> gathered copy
        self.in_adj: Dict[str, tuple] = {}   # input -> adjoint (type, attrs)
        self.out_map: Dict[str, str] = {}    # output -> local pre-collective
        self.out_adj: Dict[str, tuple] = {}  # output -> adjoint (type, attrs)
        self.label_shift: Optional[tuple] = None


_ELTWISE_BINARY = frozenset((
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow"))

#: ops whose local lowering is valid whatever their inputs' model-axis
#: shards (they act element by element or only move dims)
_SHARD_FREE = frozenset((
    "relu", "gelu", "tanh", "sigmoid", "exp", "log", "sqrt", "square",
    "abs", "sign", "scale", "cast", "assign", "clip", "pow", "leaky_relu",
    "dropout", "reshape", "reshape2", "transpose", "transpose2", "concat",
    "sum", "fill_zeros_like"))


class _Lowering:
    def __init__(self, program: Program, plan, mesh: Mesh, zero_stage: int,
                 fetch_names, batch: int):
        self.src = program
        self.block = program.global_block()
        self.plan = plan
        self.mesh = mesh
        self.sizes = mesh_axis_sizes(mesh)
        self.dp = "dp" if self.sizes.get("dp", 1) > 1 else None
        self.zero_stage = int(zero_stage)
        self.fetch_names = tuple(fetch_names)
        self.batch = int(batch)
        self.out = program.clone()
        self.qblock = self.out.global_block()
        self.ops: List[Operator] = []
        self.spec: Dict[str, Optional[tuple]] = {}
        self.recs: Dict[int, _Rec] = {}
        self.edges_at: Dict[int, List[int]] = {}
        self.param_edges: Dict[str, List[int]] = {}
        self.done_edges: List[int] = []
        self.fetch_alias: Dict[str, str] = {}
        self.n_coll = 0
        self._fresh = 0
        for k, e in enumerate(plan.edges):
            if e.reason not in _LOWERED:
                raise NotImplementedError(
                    f"SPMD lowering: the sharding plan's {e.reason!r} edge "
                    f"({e.kind} of {e.var!r} over {e.mesh_axis!r} at op "
                    f"{e.op_type!r} #{e.op_index}) is not lowered yet "
                    f"({_ROADMAP})")
            if e.op_index is None:
                self.param_edges.setdefault(e.var, []).append(k)
            else:
                self.edges_at.setdefault(e.op_index, []).append(k)
        self.produced = {n for op in self.block.ops
                         for n in op.output_arg_names() if n}

    # -- helpers ------------------------------------------------------------
    def rank(self, name) -> Optional[int]:
        name = name.split("@spmd.")[0] if name else name
        if not name or not self.block.has_var(name):
            return None
        shape = self.block.var(name).shape
        return None if shape is None else len(shape)

    def gshape(self, name) -> Optional[tuple]:
        """The global shape of ``name`` (of its source var for a var the
        lowering made), the batch in place of -1."""
        name = name.split("@spmd.")[0] if name else name
        if not name or not self.block.has_var(name):
            return None
        shape = self.block.var(name).shape
        if shape is None:
            return None
        return tuple(self.batch if d in (-1, None) else int(d)
                     for d in shape)

    def get_spec(self, name) -> Optional[tuple]:
        s = self.spec.get(name)
        return s if s is not None and any(s) else None

    def fresh(self, like: str, tag: str) -> str:
        self._fresh += 1
        name = f"{like}@spmd.{tag}{self._fresh}"
        src = self.qblock.var(like) if like and \
            self.qblock.has_var(like) else None
        self.qblock.vars[name] = Variable(
            self.qblock, name,
            dtype=src.dtype if src is not None else "float32")
        return name

    def emit(self, type, inputs, outputs, attrs=None):
        op = Operator(None, type, None, None, attrs or {})
        op.block = self.qblock
        op.inputs = {k: list(v) for k, v in inputs.items()}
        op.outputs = {k: list(v) for k, v in outputs.items()}
        self.ops.append(op)
        return op

    def coll(self, type, x, out, ring, edges=(), **attrs):
        """One collective op over the rings of mesh axis ``ring`` carrying
        plan ``edges`` (their payload counts when it runs)."""
        a = {"mesh_axis": ring}
        a.update(attrs)
        if edges:
            a["edges"] = list(edges)
            a["payload_bytes"] = int(sum(self.plan.edges[k].payload_bytes
                                         for k in edges))
            self.done_edges.extend(edges)
        self.n_coll += 1
        return self.emit(type, {"X": [x]}, {"Out": [out]}, a)

    def unsupported(self, op, i, what):
        raise NotImplementedError(
            f"SPMD lowering: op {op.type!r} #{i} {what} ({_ROADMAP})")

    def take(self, i, reason, var=None, direction=None, kind=None):
        """The plan's not yet lowered edges at op ``i`` matching the
        filters."""
        out = []
        for k in self.edges_at.get(i, []):
            e = self.plan.edges[k]
            if k in self.done_edges:
                continue
            if e.reason == reason and (var is None or e.var == var) and \
                    (direction is None or e.direction == direction) and \
                    (kind is None or e.kind == kind):
                out.append(k)
        return out

    def non_dp(self, name) -> List[Tuple[int, str]]:
        return [(d, a) for d, a in enumerate(self.spec.get(name) or ())
                if a and a != "dp"]

    # -- the walk -----------------------------------------------------------
    def run(self) -> SpmdLayout:
        from ..analysis.sharding import _Pass
        from ..framework.core import Block
        if any(isinstance(v, Block) for op in self.block.ops
               for v in op.attrs.values()):
            raise NotImplementedError(
                f"SPMD lowering: a program with sub-blocks ({_ROADMAP})")
        if self.src._attrs.get("amp"):
            raise NotImplementedError(
                f"SPMD lowering: AMP under GSPMD ({_ROADMAP})")
        self.probe = _Pass(self.src, {}, {}, self.sizes, self.batch, 1e10)
        for name, v in self.block.vars.items():
            if getattr(v, "is_data", False):
                self.spec[name] = self.plan.specs.get(name)
            elif v.persistable:
                self.spec[name] = self.param_spec(name)
        self.scope_specs = {n: self.spec.get(n) for n, v in
                            self.block.vars.items() if v.persistable}
        self.zero_specs = self.zero1_specs()
        self.scope_specs.update(self.zero_specs)
        self.spec.update(self.zero_specs)
        self.grad_of = self.pair_grads()
        self.composites: Dict[int, dict] = {}
        self.skip_grads: set = set()
        self.keep_full: Dict[int, Dict[str, str]] = {}
        self.full_grads: Dict[str, str] = {}
        for i, op in enumerate(self.block.ops):
            t = op.type
            if t in ("feed", "fetch") or i in self.skip_grads:
                continue
            if i in self.grad_of:
                self.lower_grad(i, op, self.grad_of[i])
            elif t in OPTIMIZE_OPS:
                self.lower_optimizer(i, op)
            elif op.attrs.get("op_role") == "backward" or \
                    t.endswith("_grad"):
                self.lower_backward_other(i, op)
            else:
                self.lower_forward(i, op)
            if i in self.fwd_last:
                self.plan_composites()
        missing = sorted(set(range(len(self.plan.edges)))
                         - set(self.done_edges))
        if missing or len(self.done_edges) != len(set(self.done_edges)):
            e = self.plan.edges[missing[0]] if missing else None
            raise RuntimeError(
                "SPMD lowering left sharding-plan edges unrun or ran one "
                f"twice: {len(missing)} unrun, first {e}")
        self.qblock.ops = self.ops
        self.out._bump_version()
        fetches = {}
        for f in self.fetch_names:
            alias = self.fetch_alias.get(f, f)
            fetches[f] = (alias, self.get_spec(alias))
        feeds = {n: self.get_spec(n) for n, v in self.block.vars.items()
                 if getattr(v, "is_data", False)}
        shapes = {n: self.gshape(n) for n in self.scope_specs}
        return SpmdLayout(
            program=self.out, mesh=self.mesh, plan=self.plan,
            scope_specs={n: (tuple(s) if any(s or ()) else None)
                         for n, s in self.scope_specs.items()},
            feed_specs=feeds, fetches=fetches, global_shapes=shapes,
            n_collectives=self.n_coll, devices=list(self.mesh.devices.flat))

    def param_spec(self, name) -> Optional[tuple]:
        v = self.block.var(name)
        s = self.plan.specs.get(name) or getattr(v, "dist_spec", None)
        link = getattr(v, "shard_like", None)
        if not any(s or ()) and link and self.block.has_var(link):
            p = self.block.var(link)
            if tuple(v.shape or ()) == tuple(p.shape or ()):
                s = self.plan.specs.get(link) or p.dist_spec
        return tuple(s) if any(s or ()) else None

    def zero1_specs(self) -> Dict[str, tuple]:
        """ZeRO-1: an accumulator takes ``dp`` on its free, divisible dim 0
        on top of its parameter's spec (ref ``compiler.py:383-432``)."""
        out = {}
        if not (self.zero_stage and self.dp):
            return out
        n = self.sizes["dp"]
        for name, v in self.block.vars.items():
            link = getattr(v, "shard_like", None)
            if not (v.persistable and link and self.block.has_var(link)):
                continue
            shape = tuple(v.shape or ())
            cur = list(_pad_spec(self.spec.get(name), len(shape)))
            if shape and cur[0] is None and shape[0] is not None \
                    and shape[0] > 0 and shape[0] % n == 0:
                cur[0] = "dp"
                out[name] = tuple(cur)
        return out

    def pair_grads(self) -> Dict[int, int]:
        """{grad op index: forward op index} of the generic grad ops, the
        executor's pairing (``executor._Plan``)."""
        from ..framework import registry
        from ..framework.executor import _carries_grads_of, _fwd_key, \
            _grad_key
        fwd_at: Dict[tuple, List[int]] = {}
        out: Dict[int, int] = {}
        first_bwd = None
        for i, op in enumerate(self.block.ops):
            if op.type in ("feed", "fetch"):
                continue
            if registry.is_generic_grad(op) or op.type.endswith("_grad") \
                    or op.attrs.get("op_role") == "backward":
                first_bwd = i if first_bwd is None else first_bwd
            if registry.is_generic_grad(op):
                cands = fwd_at.get(_grad_key(op), [])
                j = next((c for c in reversed(cands) if _carries_grads_of(
                    op, self.block.ops[c])), None)
                if j is not None:
                    cands.remove(j)
                    out[i] = j
                continue
            fwd_at.setdefault(_fwd_key(op), []).append(i)
        self.fwd_to_grad = {j: i for i, j in out.items()}
        # the composites are planned once the forward is lowered
        self.fwd_last = {first_bwd - 1} if first_bwd else set()
        return out

    # -- forward ------------------------------------------------------------
    def natural(self, op, i, layouts=None) -> Dict[str, Optional[tuple]]:
        """The analysis' natural output specs of ``op`` on the current
        input layouts, or on ``layouts`` where given ({input: spec}; the
        analysis' ``_Pass`` without constraints)."""
        p = self.probe
        p.spec = {n: self.spec.get(n) for ns in op.inputs.values()
                  for n in ns if n}
        p.spec.update(layouts or {})
        p.edges, p.diags, p._conflicted = [], [], set()
        nat = {}

        def settle(name, natural, _op, _idx, _path):
            if name:
                r = self.rank(name)
                s = _pad_spec(natural, r if r is not None else
                              len(natural or ()))
                nat[name] = s if any(s) else None
                p.spec[name] = nat[name]
        p.settle = settle
        try:
            p._op(op, i, "0")
        finally:
            del p.settle
        return nat

    def dp_rows(self, op) -> bool:
        return bool(self.dp) and any(
            _pad_spec(self.spec.get(n), 1)[0] == "dp"
            for ns in op.inputs.values() for n in ns if n)

    def check_row_local(self, op, i):
        t = op.type
        if t == "dropout" and float(op.attrs.get("dropout_prob", 0) or 0) \
                > 0 and not op.attrs.get("is_test", False):
            self.unsupported(op, i, "draws a dropout mask: dropout above 0 "
                             "under GSPMD")
        if not self.dp_rows(op):
            return
        if t not in _ROW_LOCAL and t not in _BATCH_REDUCE:
            names = [n for ns in op.inputs.values() for n in ns
                     if n and _pad_spec(self.spec.get(n), 1)[0] == "dp"]
            self.unsupported(op, i, f"consumes {names[0]!r}, sharded on "
                             "dim 0 over 'dp', and does not keep dim 0 a "
                             "batch dim")
        bad = False
        axis = op.attrs.get("axis")
        if t in ("transpose", "transpose2"):
            bad = list(op.attrs.get("axis") or [0])[0] != 0
        elif t in ("split", "concat", "softmax") and axis is not None:
            bad = int(axis) == 0
        elif t in ("slice", "unsqueeze", "unsqueeze2", "squeeze",
                   "squeeze2"):
            bad = 0 in list(op.attrs.get("axes") or [])
        elif t == "layer_norm":
            bad = int(op.attrs.get("begin_norm_axis", 1)) < 1
        elif t in ("reshape", "reshape2"):
            shape = list(op.attrs.get("shape") or [])
            bad = bool(shape) and shape[0] not in (0, -1)
        if bad:
            self.unsupported(op, i, "moves or reduces the batch dim 0, "
                             "which is sharded over 'dp'")

    def keep_dp(self, op, name, nat):
        """dp stays on dim 0 of a row-local op's outputs (the analysis
        settles an unmodelled op's output whole)."""
        r = self.rank(name)
        if not r or not self.dp_rows(op):
            return nat
        s = list(_pad_spec(nat, r))
        if "dp" not in s and s[0] is None:
            s[0] = "dp"
        return tuple(s) if any(s) else None

    def lower_forward(self, i, op):
        t = op.type
        self.check_row_local(op, i)
        rec = _Rec()
        self.recs[i] = rec
        if t in ("lookup_table", "lookup_table_v2") and \
                self.take(i, "vocab_embed"):
            return self.lower_vocab_lookup(i, op, rec)
        if t == "softmax_with_cross_entropy" and self.take(i, "vocab_ce"):
            return self.lower_vocab_ce(i, op, rec)
        if t == "split" and self.take(i, "split"):
            return self.lower_split(i, op, rec)
        if (t == "layer_norm" and self.take(i, "norm_stats")) or \
                (t == "softmax" and self.take(i, "softmax_stats")):
            return self.lower_ring_stats(i, op, rec)
        if t in _BATCH_REDUCE:
            return self.lower_reduce(i, op, rec)
        # inputs gathered before the op: one-sided contractions and
        # unmodelled ops (spec_mismatch), a reshape whose shard lands on no
        # out-dim, a join whose output the plan constrains whole
        gather_in: Dict[str, List[int]] = {}
        ins = set(op.input_arg_names())
        for k in self.take(i, "spec_mismatch") + self.take(
                i, "constraint", kind="all_gather"):
            if self.plan.edges[k].var in ins:
                gather_in.setdefault(self.plan.edges[k].var, []).append(k)
        if t in _ELTWISE_BINARY:
            self.join_gathers(i, op, gather_in)
        for var, ks in gather_in.items():
            ax = self.plan.edges[ks[0]].mesh_axis
            cur = list(self.spec.get(var) or ())
            dims = [d for d, a in enumerate(cur) if a == ax]
            if len(dims) != 1:
                self.unsupported(op, i, f"gathers {var!r} over {ax!r}, "
                                 f"which shards {len(dims)} of its dims")
            g = self.fresh(var, "g")
            self.coll("c_allgather", var, g, ax, edges=ks, axis=dims[0])
            cur[dims[0]] = None
            self.spec[g] = tuple(cur) if any(cur) else None
            rec.in_map[var] = g
            rec.in_adj[var] = ("c_split", {"mesh_axis": ax,
                                           "axis": dims[0]})
            if self.partial_input_grad(op, var, ax):
                # a column-parallel matmul's dX is a partial sum: the
                # gather's adjoint reduces it, which the plan leaves out
                rec.in_adj[var] = ("c_reducescatter", {
                    "mesh_axis": ax, "axis": dims[0],
                    "unplanned": "gather_bwd"})
        lop = Operator(None, t, None, None, dict(op.attrs))
        lop.block = self.qblock
        lop.inputs = {s: [rec.in_map.get(n, n) if n else n for n in ns]
                      for s, ns in op.inputs.items()}
        lop.outputs = {s: list(ns) for s, ns in op.outputs.items()}
        if t in _ELTWISE_BINARY:
            self.join_slices(i, op, lop, rec)
        self.check_local(lop, i)
        nat = self.natural(op, i, {n: self.spec.get(q)
                                   for n, q in rec.in_map.items()})
        if t in ("reshape", "reshape2"):
            lop.attrs["shape"] = self.local_shape(op, i, nat)
        post = []
        for n in op.output_arg_names():
            if n:
                post += self.lower_output(i, op, rec, n,
                                          self.keep_dp(lop, n, nat.get(n)))
        lop.outputs = {s: [rec.out_map.get(n, n) if n else n for n in ns]
                       for s, ns in op.outputs.items()}
        rec.type, rec.attrs = t, dict(lop.attrs)
        self.ops.append(lop)
        for fn in post:
            fn()

    def partial_input_grad(self, op, var, ax) -> bool:
        """Whether ``op``'s gradient of its input ``var`` is a partial sum
        over ``ax``: the X of a matmul whose weight splits its output dim
        over ``ax``."""
        if op.type not in ("mul", "matmul", "matmul_v2") or \
                op.inputs["X"][0] != var:
            return False
        y = op.inputs["Y"][0]
        ys = _pad_spec(self.spec.get(y), self.rank(y) or 0)
        ty = bool(op.attrs.get("transpose_Y"))
        return bool(ys) and ys[-2 if ty else -1] == ax

    def join_gathers(self, i, op, gather_in):
        """An elementwise join whose natural output is sharded where the
        plan constrains it whole gathers its sharded operand before the
        op (the constraint edge moves the same bytes) rather than slicing
        the whole one: its backward then moves nothing."""
        out = op.outputs["Out"][0]
        x, y = op.inputs["X"][0], op.inputs["Y"][0]
        for k in self.take(i, "constraint", var=out, kind="all_gather"):
            ax = self.plan.edges[k].mesh_axis
            side = [v for v in (x, y) if ax in (self.spec.get(v) or ())]
            if len(side) != 1 or self.gshape(side[0]) != self.gshape(out):
                self.unsupported(op, i, f"joins {x!r} and {y!r} where the "
                                 f"plan gathers {out!r} over {ax!r}")
            gather_in.setdefault(side[0], []).append(k)

    def join_slices(self, i, op, lop, rec):
        """An elementwise join of a whole operand with one split over a
        model axis on the same dim, whose output stays split: the whole
        one enters as the rank's block (``c_split``, no traffic).  Its
        gradient is the blocks gathered over the ring, which the plan
        does not price: counted as unplanned (``join_bwd``)."""
        x, y = op.inputs["X"][0], op.inputs["Y"][0]
        xr, yr = self.rank(x) or 0, self.rank(y) or 0
        if xr != yr or self.gshape(x) != self.gshape(y):
            return
        xs = _pad_spec(self.spec.get(rec.in_map.get(x, x)), xr)
        ys = _pad_spec(self.spec.get(rec.in_map.get(y, y)), yr)
        for d in range(xr):
            a, b = xs[d], ys[d]
            if (a is None) == (b is None) or "dp" in (a, b):
                continue
            whole, ax = (x, b) if a is None else (y, a)
            if whole in rec.in_map:
                continue
            blk = self.fresh(whole, "blk")
            self.emit("c_split", {"X": [whole]}, {"Out": [blk]},
                      {"mesh_axis": ax, "axis": d})
            s = list(_pad_spec(self.spec.get(whole), xr))
            s[d] = ax
            self.spec[blk] = tuple(s)
            rec.in_map[whole] = blk
            rec.in_adj[whole] = ("c_allgather", {
                "mesh_axis": ax, "axis": d, "unplanned": "join_bwd"})
            for slot, ns in lop.inputs.items():
                lop.inputs[slot] = [blk if n == whole else n for n in ns]

    def check_local(self, op, i):
        """Whether the op's local lowering is the global op on the ranks'
        blocks: a matmul's contraction sharded on both sides over one
        axis or on neither, elementwise operands alike, no normalization
        over a sharded dim, sharded vars only into ops that can take
        them."""
        t = op.type
        spec = {n: self.spec.get(n) for ns in op.inputs.values()
                for n in ns if n}
        if t in ("mul", "matmul", "matmul_v2"):
            x, y = op.inputs["X"][0], op.inputs["Y"][0]
            xs = _pad_spec(spec.get(x), self.rank(x) or 0)
            ys = _pad_spec(spec.get(y), self.rank(y) or 0)
            if t == "mul":
                k = int(op.attrs.get("x_num_col_dims", 1))
                ky = int(op.attrs.get("y_num_col_dims", 1))
                xc, yc = list(xs[k:]), list(ys[:ky])
                if any(xc[:-1]) or any(yc[:-1]):
                    self.unsupported(op, i, "shards a contraction dim of "
                                     "mul other than X's last")
                xc = xc[-1] if xc else None
                yc = yc[-1] if yc else None
            else:
                tx = bool(op.attrs.get("transpose_X"))
                ty = bool(op.attrs.get("transpose_Y"))
                xc = xs[-2 if tx else -1] if xs else None
                yc = ys[-1 if ty else -2] if len(ys) >= 2 else None
                if not self.block.var(y).persistable and len(ys) >= 2:
                    xb = [a for a in xs[:-2] if a != "dp"]
                    yb = [a for a in ys[:-2] if a != "dp"]
                    if xb != yb or (len(xs) >= 2 and xs[-1 if tx else -2]
                                    not in (None, "dp")) or \
                            ys[-2 if ty else -1]:
                        self.unsupported(op, i, f"multiplies {x!r} {xs} "
                                         f"by {y!r} {ys}")
            if xc != yc:
                self.unsupported(op, i, f"contracts {x!r} (over {xc!r}) "
                                 f"with {y!r} (over {yc!r})")
            return
        if t in _ELTWISE_BINARY:
            x, y = op.inputs["X"][0], op.inputs["Y"][0]
            xr, yr = self.rank(x) or 0, self.rank(y) or 0
            xs = _pad_spec(spec.get(x), xr)
            ys = _pad_spec(spec.get(y), yr)
            axis = int(op.attrs.get("axis", -1))
            off = xr - yr if axis < 0 else axis
            ysh = self.gshape(y) or (0,) * yr
            for d in range(yr):
                a = xs[off + d] if 0 <= off + d < xr else None
                b = ys[d]
                if a == b or (b is None and (a == "dp" or ysh[d] == 1)):
                    continue
                self.unsupported(op, i, f"joins {x!r} {xs} and {y!r} {ys}: "
                                 f"dim {d} of {y!r} is {b!r} against "
                                 f"{a!r}")
            return
        if t == "layer_norm":
            x = op.inputs["X"][0]
            bna = int(op.attrs.get("begin_norm_axis", 1))
            if any(_pad_spec(spec.get(x), self.rank(x) or 0)[bna:]):
                self.unsupported(op, i, f"normalizes {x!r} over a sharded "
                                 "dim (norm_stats)")
            return
        if t == "softmax":
            x = op.inputs["X"][0]
            ax = int(op.attrs.get("axis", -1))
            if _pad_spec(spec.get(x), self.rank(x) or 0)[ax]:
                self.unsupported(op, i, f"normalizes {x!r} over a sharded "
                                 "dim (softmax_stats)")
            return
        if t == "concat":
            axis = int(op.attrs.get("axis", 0))
            for n in op.inputs["X"]:
                r = self.rank(n) or 0
                a = _pad_spec(spec.get(n), r)[axis % r] if r else None
                if a and a != "dp":
                    self.unsupported(op, i, f"concatenates {n!r} on its "
                                     f"dim {axis % r}, split over {a!r}")
            return
        if t in _SHARD_FREE:
            return
        for n, s in spec.items():
            nd = [(d, a) for d, a in enumerate(s or ()) if a and a != "dp"]
            if nd:
                d, a = nd[0]
                self.unsupported(op, i, f"consumes {n!r} sharded on dim {d} "
                                 f"over {a!r}")

    def local_shape(self, op, i, nat):
        shape = list(op.attrs.get("shape") or [])
        out = op.outputs["Out"][0]
        spec = _pad_spec(nat.get(out), len(shape))
        for d, a in enumerate(spec):
            if a and a != "dp" and shape[d] > 0:
                n = self.sizes[a]
                if shape[d] % n:
                    self.unsupported(op, i, f"reshapes dim {d} of {out!r} "
                                     f"to {shape[d]}, which mesh axis "
                                     f"{a!r} of size {n} does not divide")
                shape[d] //= n
        return shape

    def lower_output(self, i, op, rec, n, nat) -> list:
        """Collectives after the op for output ``n`` (a partial sum's
        all-reduce, a constraint's all-gather), as callables to run once
        the local op is emitted; records the local name in
        ``rec.out_map``."""
        part = self.take(i, "partial_sum", var=n)
        cons = self.take(i, "constraint", var=n)
        post = []
        cur = nat
        name = n
        if part:
            ax = self.plan.edges[part[0]].mesh_axis
            src = self.fresh(n, "part")
            dst = self.fresh(n, "sum") if cons else n
            rec.out_map[n] = src
            rec.out_adj[n] = [("spmd_alias", {})]
            post.append(lambda s=src, d=dst, a=ax, ks=part:
                        self.coll("c_allreduce_sum", s, d, a, edges=ks))
            name = dst
        for k in cons:
            e = self.plan.edges[k]
            if e.kind != "all_gather":
                self.unsupported(op, i, f"constrains {n!r} by an "
                                 f"{e.kind}")
            s = list(_pad_spec(cur, self.rank(n) or 0))
            dims = [d for d, a in enumerate(s) if a == e.mesh_axis]
            if len(dims) != 1:
                self.unsupported(op, i, f"gathers {n!r} over "
                                 f"{e.mesh_axis!r}, which shards "
                                 f"{len(dims)} of its dims")
            src = name if name != n else self.fresh(n, "nat")
            if n not in rec.out_map:
                rec.out_map[n] = src
            rec.out_adj.setdefault(n, []).insert(
                0, ("c_split", {"mesh_axis": e.mesh_axis,
                                "axis": dims[0]}))
            post.append(lambda s=src, a=e.mesh_axis, d=dims[0], kk=k:
                        self.coll("c_allgather", s, n, a, edges=[kk],
                                  axis=d))
            s[dims[0]] = None
            cur = tuple(s) if any(s) else None
        self.spec[n] = cur
        self.check_plan(op, i, n)
        return post

    def check_plan(self, op, i, n):
        """The lowered layout of ``n`` is the plan's, dp aside."""
        want = [a if a != "dp" else None
                for a in _pad_spec(self.plan.specs.get(n), 8)]
        have = [a if a != "dp" else None
                for a in _pad_spec(self.spec.get(n), 8)]
        if want != have:
            self.unsupported(op, i, f"leaves {n!r} laid out "
                             f"{self.spec.get(n)} where the sharding plan "
                             f"has {self.plan.specs.get(n)}")

    # -- forward special cases ------------------------------------------------
    def lower_vocab_lookup(self, i, op, rec):
        w, ids = op.inputs["W"][0], op.inputs["Ids"][0]
        out = op.outputs["Out"][0]
        ax = self.spec[w][0]
        fwd = self.take(i, "vocab_embed", direction="fwd")
        bwd = self.take(i, "vocab_embed", direction="bwd")
        attrs = {"mesh_axis": ax,
                 "padding_idx": op.attrs.get("padding_idx", -1)}
        part = self.fresh(out, "part")
        rec.type, rec.attrs = "spmd_vocab_lookup", attrs
        rec.out_map[out] = part
        rec.out_adj[out] = [("c_allreduce_sum",
                             {"mesh_axis": ax, "contrib": "first",
                              "__edges__": bwd})] if bwd else \
            [("spmd_alias", {})]
        self.emit("spmd_vocab_lookup", {"W": [w], "Ids": [ids]},
                  {"Out": [part]}, attrs)
        self.coll("c_allreduce_sum", part, out, ax, edges=fwd)
        self.spec[out] = self.keep_dp(op, out, (None,) * (self.rank(out)
                                                          or 1))
        self.check_plan(op, i, out)

    def lower_vocab_ce(self, i, op, rec):
        logits = op.inputs["Logits"][0]
        ax = (self.spec.get(logits) or (None,))[-1]
        if op.attrs.get("soft_label") or \
                int(op.attrs.get("axis", -1)) not in (
                    -1, (self.rank(logits) or 0) - 1) or not ax:
            self.unsupported(op, i, f"is a vocab-sharded cross entropy "
                             f"({logits!r} {self.spec.get(logits)}) with "
                             "soft labels or over an inner axis")
        ks = self.take(i, "vocab_ce")
        self.done_edges.extend(ks)
        self.n_coll += 1
        self.emit("spmd_vocab_softmax_ce",
                  {"Logits": [logits], "Label": op.inputs["Label"]},
                  dict(op.outputs),
                  {"mesh_axis": ax, "edges": ks, "axis": -1,
                   "ignore_index": op.attrs.get("ignore_index", -100),
                   "payload_bytes": int(sum(
                       self.plan.edges[k].payload_bytes for k in ks))})
        rec.type = "spmd_vocab_softmax_ce"
        rec.label_shift = (ax, self.gshape(logits)[-1] // self.sizes[ax])
        ls = self.spec.get(logits)
        self.spec[op.outputs["Softmax"][0]] = ls
        loss = op.outputs["Loss"][0]
        self.spec[loss] = self.keep_dp(op, loss, None)
        self.check_plan(op, i, loss)

    def lower_split(self, i, op, rec):
        """A split of a sharded dim (the QKV pack): one all-to-all into the
        layout whose local split gives each rank its block of every
        section (the plan's ``split`` edge)."""
        x = op.inputs["X"][0]
        ks = self.take(i, "split")
        ax = self.plan.edges[ks[0]].mesh_axis
        r = self.rank(x)
        d = int(op.attrs.get("axis", 0)) % r
        outs = op.outputs["Out"]
        k = len(outs)
        secs = list(op.attrs.get("sections") or [])
        g = self.gshape(x)[d]
        if (secs and any(s != g // k for s in secs)) or \
                g % (k * self.sizes[ax]) or \
                _pad_spec(self.spec.get(x), r)[d] != ax:
            self.unsupported(op, i, f"splits {x!r} on dim {d} (over {ax!r}) "
                             "into sections the ranks do not divide alike")
        sec = self.fresh(x, "sec")
        self.coll("c_alltoall", x, sec, ax, edges=ks, axis=d, sections=k)
        attrs = dict(op.attrs)
        if secs:
            attrs["sections"] = [s // self.sizes[ax] for s in secs]
        self.emit("split", {"X": [sec]}, dict(op.outputs), attrs)
        rec.type, rec.attrs = "split", attrs
        rec.in_map[x] = sec
        rec.in_adj[x] = ("c_alltoall", {"mesh_axis": ax, "axis": d,
                                        "sections": k, "inverse": True,
                                        "unplanned": "reshard_bwd"})
        self.spec[sec] = self.spec.get(x)
        for n in outs:
            self.spec[n] = self.spec.get(x)
            self.check_plan(op, i, n)
        self.composites[i] = {"x": x, "axis": ax, "dim": d, "outs": outs}

    def lower_ring_stats(self, i, op, rec):
        """A layer_norm / softmax over a dim split over a ring: one group
        op that sums each row's statistics over the ring (the plan's
        ``norm_stats`` / ``softmax_stats`` edge).  Its gradient runs the
        op again under autograd over the ring, whose backward sums two
        statistics a row (layer_norm) or one (softmax) the plan does not
        price: counted as unplanned, at the forward edge's payload or
        half of it."""
        reason = "norm_stats" if op.type == "layer_norm" else \
            "softmax_stats"
        ks = self.take(i, reason)
        x = op.inputs["X"][0]
        axes = {self.plan.edges[k].mesh_axis for k in ks}
        if len(axes) != 1:
            self.unsupported(op, i, f"normalizes {x!r} over dims split "
                             f"over several mesh axes {sorted(axes)}")
        ax = axes.pop()
        payload = int(sum(self.plan.edges[k].payload_bytes for k in ks))
        typ = "spmd_layer_norm" if op.type == "layer_norm" else \
            "spmd_softmax"
        attrs = dict(op.attrs)
        attrs.update({"mesh_axis": ax, "edges": ks,
                      "payload_bytes": payload})
        self.done_edges.extend(ks)
        self.n_coll += 1
        self.emit(typ, dict(op.inputs), dict(op.outputs), attrs)
        rec.type = typ
        rec.attrs = {k: v for k, v in attrs.items()
                     if k not in ("edges", "payload_bytes")}
        rec.attrs.update({"unplanned": reason + "_bwd",
                          "unplanned_payload": payload
                          if op.type == "layer_norm" else payload // 2})
        nat = self.natural(op, i)
        for n in op.output_arg_names():
            if n:
                self.spec[n] = self.keep_dp(op, n, nat.get(n))
                self.check_plan(op, i, n)

    def lower_reduce(self, i, op, rec):
        """``mean`` / ``reduce_sum`` / ``reduce_mean``: the local reduction,
        then a sum over each ring whose shards it reduced, a mean's scaled
        by 1/n: over a model axis the plan's ``loss_reduce`` edge, over dp
        a batch reduction the plan leaves out."""
        x, out = op.inputs["X"][0], op.outputs["Out"][0]
        r = self.rank(x) or 0
        dim = op.attrs.get("dim")
        if op.type == "mean" or op.attrs.get("reduce_all") or dim is None:
            dims = list(range(r))
        else:
            dims = [int(d) % r for d in (dim if isinstance(
                dim, (list, tuple)) else [dim])]
        xs = _pad_spec(self.spec.get(x), r)
        rings = [a for d, a in enumerate(xs) if a and d in dims]
        keep = [None if d in dims else a for d, a in enumerate(xs)]
        out_spec = tuple(keep) if op.attrs.get("keep_dim") else \
            tuple(a for d, a in enumerate(keep) if d not in dims)
        chain = []
        for ax in rings:
            ks = [] if ax == "dp" else self.take(i, "loss_reduce")[:1]
            if ax != "dp" and not ks:
                self.unsupported(op, i, f"reduces {x!r} over {ax!r}, for "
                                 "which the plan has no loss_reduce edge")
            chain.append((ax, ks))
        rec.type, rec.attrs = op.type, dict(op.attrs)
        if not chain:
            self.emit(op.type, dict(op.inputs), dict(op.outputs),
                      dict(op.attrs))
        else:
            name = self.fresh(out, "local")
            rec.out_map[out] = name
            self.emit(op.type, dict(op.inputs), {"Out": [name]},
                      dict(op.attrs))
            scale = 1.0
            for j, (ax, ks) in enumerate(chain):
                dst = out if j == len(chain) - 1 else \
                    self.fresh(out, "red")
                attrs = {}
                if op.type != "reduce_sum":
                    attrs["scale"] = 1.0 / self.sizes[ax]
                    scale *= attrs["scale"]
                if not ks:
                    attrs["unplanned"] = "batch_reduce"
                self.coll("c_allreduce_sum", name, dst, ax, edges=ks,
                          **attrs)
                name = dst
            rec.out_adj[out] = [("scale", {"scale": scale, "bias": 0.0})]
        self.spec[out] = out_spec if any(out_spec) else None

    # -- the QKV composite ------------------------------------------------------
    def plan_composites(self):
        """Once the forward is lowered: a pack split whose every section
        is gathered whole over the split's axis (after at most one
        reshape) has a local backward (module docstring).  Marks the grad
        ops the composite replaces."""
        for fi, c in list(self.composites.items()):
            full = []
            skip, keep = set(), {}
            for o in c["outs"]:
                cons = [j for j, op in enumerate(self.block.ops)
                        if o in op.input_arg_names()]
                if len(cons) != 1 or \
                        self.block.ops[cons[0]].type not in ("reshape2",
                                                            "reshape"):
                    break
                j = cons[0]
                rec = self.recs.get(j)
                rop = self.block.ops[j]
                r_out = rop.outputs["Out"][0]
                gi = self.fwd_to_grad.get(j)
                if rec is None or gi is None:
                    break
                if o in rec.in_map:            # gathered, then reshaped
                    keep.setdefault(gi, {})[o] = None
                    full.append((o, None))
                elif rec.out_map.get(r_out) and not self.get_spec(r_out) \
                        or (self.non_dp(r_out) == [] and r_out in
                            rec.out_map):
                    skip.add(gi)               # reshaped, then gathered
                    full.append((o, r_out))
                else:
                    break
            else:
                c["full"] = full
                c["keep"] = keep
                self.skip_grads |= skip
                for gi, m in keep.items():
                    self.keep_full.setdefault(gi, {}).update(m)
                g = self.fwd_to_grad.get(fi)
                if g is not None:
                    self.skip_grads.add(g)
                    c["grad_op"] = g

    def emit_composite(self, c):
        """The pack's gradient: each section's whole gradient (reshaped
        back to the section's shape), concatenated, the rank's block
        taken."""
        x, ax, d = c["x"], c["axis"], c["dim"]
        parts = []
        for o, r_out in c["full"]:
            if r_out is None:
                parts.append(self.full_grads[o])
                continue
            g = grad_var_name(r_out)
            shaped = self.fresh(o, "gfull")
            shape = [-1] + list(self.gshape(o)[1:])
            self.emit("reshape2", {"X": [g]},
                      {"Out": [shaped], "XShape": [self.fresh(o, "xs")]},
                      {"shape": shape})
            parts.append(shaped)
        cat = self.fresh(x, "gcat")
        self.emit("concat", {"X": parts}, {"Out": [cat]}, {"axis": d})
        self.emit("c_split", {"X": [cat]}, {"Out": [grad_var_name(x)]},
                  {"mesh_axis": ax, "axis": d})
        self.spec[grad_var_name(x)] = self.spec.get(x)

    # -- backward -------------------------------------------------------------
    def lower_grad(self, gi, op, fi):
        """A generic grad op of forward op ``fi``: renamed as its forward
        was, its output gradients made local first (the adjoints of the
        forward's output collectives), its input gradients completed
        after (``grad_partial``) or made local (the adjoint of an input
        gather)."""
        fwd = self.block.ops[fi]
        rec = self.recs.get(fi)
        if rec is None:
            raise RuntimeError(f"SPMD lowering: grad op {op.type!r} #{gi} "
                               f"has no lowered forward #{fi}")
        attrs = dict(op.attrs)
        typ = op.type
        if rec.type and rec.type != fwd.type:
            typ = rec.type + "_grad"
            attrs["__fwd_type__"] = rec.type
        if rec.attrs is not None:
            attrs.update(rec.attrs)
        keep = self.keep_full.get(gi, {})
        ins, outs, pre, post = {}, {}, [], []
        for slot, names in op.inputs.items():
            if slot.startswith("X$"):
                ins[slot] = [rec.in_map.get(n, n) if n else n for n in names]
            elif slot.startswith("OG$"):
                fouts = fwd.outputs.get(slot[3:], [])
                new = []
                for n, og in zip(fouts, names):
                    q = rec.out_map.get(n)
                    if q is None:
                        new.append(og)
                        continue
                    qg = grad_var_name(q)
                    self.ensure_var(qg, n)
                    if og in self.produced:
                        pre.append((og, qg, rec.out_adj[n]))
                    new.append(qg)
                ins[slot] = new
            else:
                ins[slot] = list(names)
        for slot, names in op.outputs.items():
            if not slot.startswith("IG$"):
                outs[slot] = list(names)
                continue
            fins = fwd.inputs.get(slot[3:], [])
            new = []
            for n, ig in zip(fins, names):
                part = self.take(fi, "grad_partial", var=n)
                if n in rec.in_map and ig:
                    full = self.fresh(ig, "full")
                    self.spec[full] = self.spec.get(rec.in_map[n])
                    if n in keep:
                        self.full_grads[n] = full
                    else:
                        post.append((full, ig, [rec.in_adj[n]], []))
                    new.append(full)
                elif part:
                    ax = self.plan.edges[part[0]].mesh_axis
                    src = self.fresh(n, "dpart")
                    dst = ig or self.fresh(n, "dx")
                    post.append((src, dst, [("c_allreduce_sum",
                                             {"mesh_axis": ax})], part))
                    new.append(src)
                else:
                    new.append(ig)
                if ig:
                    self.spec[ig] = self.spec.get(n)
            outs[slot] = new
        for og, qg, chain in pre:
            self.adjoint_chain(chain, og, qg)
        self.emit(typ, ins, outs, attrs)
        for src, dst, chain, ks in post:
            if ks:
                self.coll("c_allreduce_sum", src, dst,
                          chain[0][1]["mesh_axis"], edges=ks)
            else:
                self.adjoint_chain(chain, src, dst)

    def adjoint_chain(self, chain, src, dst):
        """Run the adjoints of an output's collectives, last first."""
        cur = src
        for j, (t, a) in enumerate(chain):
            nxt = dst if j == len(chain) - 1 else self.fresh(src, "adj")
            a = dict(a)
            edges = a.pop("__edges__", None) or ()
            if t in ("c_allreduce_sum", "c_allgather", "c_alltoall",
                     "c_reducescatter"):
                self.coll(t, cur, nxt, a.pop("mesh_axis"), edges=edges,
                          **a)
            else:
                self.emit(t, {"X": [cur]}, {"Out": [nxt]}, a)
            cur = nxt

    def ensure_var(self, name, like):
        if not self.qblock.has_var(name):
            src = self.qblock.var(like) if self.qblock.has_var(like) \
                else None
            self.qblock.vars[name] = Variable(
                self.qblock, name, dtype=src.dtype if src else "float32")

    def lower_backward_other(self, i, op):
        """Backward ops that are no generic grad: the loss gradient's fill,
        gradient sums, hand-written grads (the vocab-sharded cross
        entropy's reads its label in the rank's coordinates), and the
        QKV composite in place of the pack's split grad."""
        t = op.type
        for c in self.composites.values():
            if c.get("grad_op") == i:
                return self.emit_composite(c)
        if t == "softmax_with_cross_entropy_grad":
            sm = op.inputs["Softmax"][0]
            fi = next((j for j, r in self.recs.items() if sm in
                       self.block.ops[j].output_arg_names()), None)
            rec = self.recs.get(fi)
            if rec is not None and rec.label_shift:
                ax, rows = rec.label_shift
                attrs = dict(op.attrs)
                attrs.update({"mesh_axis": ax, "rows": rows})
                self.emit("spmd_vocab_softmax_ce_grad", dict(op.inputs),
                          dict(op.outputs), attrs)
                for n in op.output_arg_names():
                    self.spec[n] = self.spec.get(sm)
                return
        sharded = [n for n in op.input_arg_names() if n and self.non_dp(n)]
        if sharded and t not in ("sum", "scale", "assign"):
            self.unsupported(op, i, f"is a backward op reading the sharded "
                             f"{sharded[0]!r}")
        self.emit(t, dict(op.inputs), dict(op.outputs), dict(op.attrs))
        ins = [n for n in op.input_arg_names() if n]
        for n in op.output_arg_names():
            if n:
                self.spec[n] = self.spec.get(ins[0]) if ins else None

    # -- optimizer: dp gradient sync / ZeRO-1 ----------------------------------
    def lower_optimizer(self, i, op):
        p = op.inputs["Param"][0]
        g = op.inputs["Grad"][0]
        kinds = {self.plan.edges[k].reason: k
                 for k in self.param_edges.pop(p, [])}
        ins = {s: list(v) for s, v in op.inputs.items()}
        outs = {s: list(v) for s, v in op.outputs.items()}
        pspec = self.spec.get(p)
        if "grad_sync" in kinds:
            synced = self.fresh(g, "sync")
            self.coll("c_allreduce_sum", g, synced, "dp",
                      edges=[kinds["grad_sync"]])
            self.spec[synced] = pspec
            self.fetch_alias[g] = synced
            ins["Grad"] = [synced]
            self.emit(op.type, ins, outs, dict(op.attrs))
            return
        if "zero1_grad" not in kinds:
            if self.dp:
                raise RuntimeError(f"SPMD lowering: the plan has no dp "
                                   f"gradient sync for parameter {p!r}")
            self.emit(op.type, ins, outs, dict(op.attrs))
            return
        accs = [n for n in op.input_arg_names() if n in self.zero_specs]
        rs, ag = kinds["zero1_grad"], kinds["zero1_param"]
        if accs:
            # update the rank's dp block of the parameter, gather it back
            gs = self.fresh(g, "rs")
            self.coll("c_reducescatter", g, gs, "dp", edges=[rs], axis=0)
            ps = self.fresh(p, "z")
            self.emit("c_split", {"X": [p]}, {"Out": [ps]},
                      {"mesh_axis": "dp", "axis": 0})
            pn = self.fresh(p, "znew")
            ins["Param"], ins["Grad"] = [ps], [gs]
            outs["ParamOut"] = [pn]
            self.emit(op.type, ins, outs, dict(op.attrs))
            self.coll("c_allgather", pn, p, "dp", edges=[ag], axis=0)
            s = list(_pad_spec(pspec, self.rank(p) or 0))
            s[0] = "dp"
            self.spec[gs] = tuple(s)
            self.fetch_alias[g] = gs
            return
        # accumulators that cannot take dp: the flattened gradient is
        # reduce-scattered and all-gathered (an all-reduce in two halves)
        gs = self.fresh(g, "rs")
        gf = self.fresh(g, "sync")
        flat = self.fresh(g, "flat")
        self.coll("c_reducescatter", g, gs, "dp", edges=[rs], flat=True)
        self.coll("c_allgather", gs, flat, "dp", edges=[ag], flat=True)
        self.emit("spmd_unflatten", {"X": [flat], "Like": [g]},
                  {"Out": [gf]})
        ins["Grad"] = [gf]
        self.emit(op.type, ins, outs, dict(op.attrs))
        self.spec[gf] = pspec
        self.fetch_alias[g] = gf


def lower_program(program: Program, fetch_names, batch: int, mesh: Mesh,
                  plan, zero_stage: int = 0) -> SpmdLayout:
    """The per-rank program of a partitioned ``program`` (module
    docstring) at feed batch ``batch``, run from ``plan``."""
    return _Lowering(program, plan, mesh, zero_stage, fetch_names,
                     batch).run()
