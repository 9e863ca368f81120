"""Static sharding analysis: PartitionSpec propagation and reshard planning
over the Fluid graph (the port of ``paddle_tpu/analysis/sharding.py``).

A forward dataflow walk over the dependency-ordered ``ir`` graph, seeded
from the partition stamp's parameter specs and the dp-sharded feeds,
propagates PartitionSpecs through every op (matmul contraction,
elementwise broadcast join, reshape split/merge, transpose permutation,
sub-block bodies in the enclosing context) and reconciles each produced
spec with the activation constraint the stamp pins: a disagreement is a
reshard the step pays.

Three checks feed the program verifier (``verifier.CHECKS``):

- ``spec_conflict``: two consumers demanding incompatible shardings of one
  var.  One-sided (sharded meets replicated) is an all-gather edge and a
  warning; two different mesh axes for one contraction or dim is an
  error.
- ``shard_divisibility``: dims the partitioner's divisibility guard kept
  replicated, named (var, dim, logical axis, mesh axis).
- ``mesh_axis_overuse``: one spec using a mesh axis twice, an error.

The per-edge **reshard plan** prices every collective through the comms
plane's ring model: partial-sum all-reduces of row-parallel matmuls,
backward dX all-reduces of column-parallel ones, vocab-sharded embedding
and cross-entropy traffic, constraint all-gathers and all-to-alls, dp
gradient sync and ZeRO-1's reduce-scatter + all-gather.  The backward
traffic is modelled from the forward op, as the reference's backward is
``jax.vjp``'s.  Each edge carries ``reason`` (``spec_mismatch`` marks the
unexplained ones).  The edges, their order and ``resh_token`` equal the
reference's on the same program; the port's SPMD lowering
(``parallel/spmd.py``) runs one collective for each edge, at the op the
edge names, and counts its payload when it runs.

The plan is fingerprint-cached, stamped into ``_attrs["verify"]
["sharding"]``, folded into the collective fingerprint as
``#resh=<edges>x<sha8>``, projected onto a ``CommsPlan``
(:func:`runtime_comms_plan`) and read by ``partitioner.choose_rules``.
:func:`check_decode_hostable` is the serving-side gate: the paged KV
cache holds whole heads on one card, so an mp-sharded decode program is
refused naming its specs.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import monitor as _monitor
from ..framework.core import Block, Program
from .verifier import Diagnostic, sub_blocks_of

__all__ = [
    "ReshardEdge", "ShardingPlan", "plan_sharding", "check_decode_hostable",
    "runtime_comms_plan", "stamp_attrs", "clear_cache",
]

#: static per-step GSPMD reshard traffic of the most recently planned
#: partitioned program (logical payload bytes across every edge)
_RESHARD_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_gspmd_reshard_bytes",
    "static per-step reshard-plan payload bytes of the last planned "
    "partitioned program")

#: reshard kind -> per-rank wire fraction of the logical payload (the
#: comms._ALGO_FACTOR ring discipline; all_to_all moves one shard's
#: (n-1)/n over the wire, i.e. (n-1)/n^2 of the global tensor)
_FACTOR = {
    "all_reduce": lambda n: 2.0 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / (n * n),
    "slice": lambda n: 0.0,
}

#: reshard kind -> the explicit-collective op name the runtime byte
#: counter (paddle_tpu_collective_bytes_total) labels its series with
_COLLECTIVE_OP = {
    "all_reduce": "c_allreduce_sum",
    "all_gather": "c_allgather",
    "reduce_scatter": "c_reducescatter",
    "all_to_all": "c_alltoall",
    "slice": "c_split",
}

#: ops whose output keeps the first input's spec (elementwise /
#: layout-preserving); elementwise binaries additionally JOIN specs
_ELTWISE = frozenset((
    "relu", "gelu", "tanh", "sigmoid", "exp", "log", "sqrt", "square",
    "abs", "sign", "scale", "cast", "dropout", "clip", "assign", "pow",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min", "sum",
))

_BINARY = frozenset((
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
))

#: host-side / optimizer ops the forward walk skips outright (their
#: backward traffic is modeled analytically, not re-walked — the grad
#: graph mirrors the forward structurally)
_SKIP = frozenset((
    "feed", "fetch", "fill_constant", "increment", "shape",
    "sgd", "momentum", "adam", "adamw", "adagrad", "decayed_adagrad",
    "rmsprop", "lamb", "lars_momentum", "adamax", "ftrl",
))

_CE_OPS = frozenset((
    "cross_entropy", "softmax_with_cross_entropy", "fused_lm_head_ce",
))

#: edge reasons that are NOT "spec_mismatch": semantically derived
#: traffic the table owner signed up for (the smoke's zero-unexplained
#: gate counts only spec_mismatch edges)
EXPLAINED_REASONS = frozenset((
    "partial_sum", "grad_partial", "vocab_embed", "vocab_ce", "gather",
    "norm_stats", "softmax_stats", "loss_reduce", "constraint", "split",
    "grad_sync", "zero1_grad", "zero1_param",
))


@dataclass(frozen=True)
class ReshardEdge:
    """One GSPMD-induced collective: where, what kind, how many bytes.

    ``payload_bytes`` is the GLOBAL logical tensor size (the comms-plan
    convention); ``wire_bytes`` applies the ring algorithm factor for
    ``kind`` over the ``mesh_axis`` ring.  ``exact=True`` edges are
    dispatched verbatim by the runtime accounting; ``exact=False``
    edges are a band: the bytes depend on how the step implements them."""

    var: str
    kind: str                      # _FACTOR key
    mesh_axis: str
    nranks: int
    payload_bytes: int
    wire_bytes: int
    est_ms: float
    reason: str
    exact: bool = False
    direction: str = "fwd"         # "fwd" | "bwd"
    op_type: Optional[str] = None
    op_index: Optional[int] = None
    src_spec: Optional[tuple] = None
    dst_spec: Optional[tuple] = None
    dtype: str = "float32"
    shape: Tuple[int, ...] = ()

    @property
    def explained(self) -> bool:
        return self.reason != "spec_mismatch"

    @property
    def collective_op(self) -> str:
        return _COLLECTIVE_OP[self.kind]


@dataclass
class ShardingPlan:
    """Propagated specs + priced reshard edges + diagnostics for one
    partitioned program (module docstring)."""

    rules: Optional[str] = None
    mesh_axes: Dict[str, int] = field(default_factory=dict)
    batch_size: int = 1
    zero_stage: int = 0
    link_bw: float = 1e10
    #: final propagated spec per var (params seeded, activations
    #: settled against their stamped constraints)
    specs: Dict[str, tuple] = field(default_factory=dict)
    edges: List[ReshardEdge] = field(default_factory=list)
    diagnostics: List[Diagnostic] = field(default_factory=list)
    payload_bytes: int = 0
    wire_bytes: int = 0
    est_ms: float = 0.0
    compute_ms: float = 0.0
    #: sha1 over (mesh, rules, ordered edge tuples) — the cross-rank
    #: parity token folded into the collective fingerprint
    fingerprint: str = ""

    @property
    def unexplained(self) -> List[ReshardEdge]:
        return [e for e in self.edges if not e.explained]

    @property
    def resh_token(self) -> str:
        """Compact ``<edges>x<sha8>`` token: what the ``#resh=`` suffix
        of the collective fingerprint carries, so a barrier refusal can
        NAME both ranks' reshard plans."""
        return f"{len(self.edges)}x{self.fingerprint[:8]}"

    def report(self) -> str:
        mesh = ",".join(f"{a}:{s}" for a, s in sorted(
            self.mesh_axes.items()))
        lines = [
            f"sharding plan (rules={self.rules}, mesh {mesh}, "
            f"batch={self.batch_size}, zero{self.zero_stage}): "
            f"{len(self.edges)} reshard edge(s) "
            f"({len(self.unexplained)} unexplained), "
            f"{self.payload_bytes / 1e6:.3f} MB payload, "
            f"{self.wire_bytes / 1e6:.3f} MB wire, "
            f"est {self.est_ms:.3f} ms vs {self.compute_ms:.3f} ms "
            f"compute"]
        for e in self.edges:
            tier = "exact" if e.exact else "band"
            lines.append(
                f"  [{e.direction}] {e.kind:<14} @{e.mesh_axis} "
                f"{e.var:<32} {e.payload_bytes / 1e3:10.2f} kB  "
                f"{e.reason} ({tier})")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# spec algebra helpers
# ---------------------------------------------------------------------------

def _norm(spec) -> Optional[tuple]:
    if spec is None:
        return None
    spec = tuple(spec)
    return spec if any(s is not None for s in spec) else None

def _pad(spec, rank: int) -> tuple:
    """A spec tuple of exactly ``rank`` entries (None-filled)."""
    spec = tuple(spec or ())
    if len(spec) < rank:
        spec = spec + (None,) * (rank - len(spec))
    return spec[:rank]


def _dup_axis(spec) -> Optional[str]:
    seen = set()
    for ax in (spec or ()):
        if ax is None:
            continue
        if ax in seen:
            return ax
        seen.add(ax)
    return None


def _shape_of(block: Block, name, batch: int):
    if not name or not block.has_var(name):
        return None, "float32"
    v = block.var(name)
    if v.shape is None:
        return None, str(v.dtype or "float32")
    return tuple(batch if d in (-1, None) else int(d) for d in v.shape), \
        str(v.dtype or "float32")


def _itemsize(dtype) -> int:
    from .comms import _itemsize as _isz
    return _isz(dtype)


def _numel(shape) -> int:
    n = 1
    for d in shape or ():
        n *= max(int(d), 1)
    return n


# ---------------------------------------------------------------------------
# the propagation pass
# ---------------------------------------------------------------------------

class _Pass:
    """One propagation over one program: mutable spec environment plus
    the edge/diagnostic accumulators (sub-blocks share the env — the
    verifier's enclosing-scope-context discipline)."""

    def __init__(self, program, seeds, constraints, axis_sizes,
                 batch_size, link_bw):
        self.program = program
        self.block = program.global_block()
        self.constraints = constraints
        self.axis_sizes = {a: int(s) for a, s in (axis_sizes or {}).items()}
        self.batch = int(batch_size)
        self.link_bw = link_bw
        self.spec: Dict[str, Optional[tuple]] = {}
        self.edges: List[ReshardEdge] = []
        self.diags: List[Diagnostic] = []
        self._conflicted: set = set()
        self.dp = "dp" if self.axis_sizes.get("dp", 0) > 1 else None
        for name, s in (seeds or {}).items():
            self.spec[name] = _norm(s)
        # stamped specs (params + activation constraints) never pass
        # through settle(), so duplicate-axis abuse is checked here
        for name, s in sorted(list((seeds or {}).items())
                              + list((constraints or {}).items())):
            dup = _dup_axis(s)
            if dup is not None and name not in self._conflicted:
                self._conflicted.add(name)
                self.diag(
                    "mesh_axis_overuse", "error",
                    f"spec {tuple(s)} for var {name!r} uses mesh axis "
                    f"{dup!r} on more than one dim — one tensor cannot "
                    "be laid out twice over the same mesh ring",
                    var=name,
                    fix="remap one of the var's logical axes to a "
                        "different mesh axis (or None) in the rule "
                        "table")
        # feeds carry the batch dim on dp (compiler._build_in_shardings
        # feed discipline: leading dim sharded over dp)
        if self.dp:
            for name in self.block.vars:
                v = self.block.var(name)
                if getattr(v, "is_data", False) and v.shape is not None \
                        and len(v.shape) >= 2:
                    self.spec[name] = _norm(
                        (self.dp,) + (None,) * (len(v.shape) - 1))

    # -- pricing ------------------------------------------------------------
    def edge(self, kind, axis, var, reason, *, exact=False, direction="fwd",
             op=None, idx=None, src=None, dst=None, payload=None):
        n = max(self.axis_sizes.get(axis, 1), 1)
        shape, dtype = _shape_of(self.block, var, self.batch)
        if payload is None:
            payload = _numel(shape) * _itemsize(dtype)
        wire = int(payload * _FACTOR[kind](n)) if n > 1 else 0
        self.edges.append(ReshardEdge(
            var=var, kind=kind, mesh_axis=axis, nranks=n,
            payload_bytes=int(payload), wire_bytes=wire,
            est_ms=wire / self.link_bw * 1e3, reason=reason, exact=exact,
            direction=direction, op_type=getattr(op, "type", None),
            op_index=idx, src_spec=src, dst_spec=dst, dtype=dtype,
            shape=tuple(shape or ())))

    def diag(self, check, severity, message, *, op=None, idx=None,
             var=None, fix=None, path=None):
        self.diags.append(Diagnostic(
            check=check, severity=severity, message=message,
            op_type=getattr(op, "type", None), op_index=idx, var=var,
            fix_hint=fix, block=path))

    # -- per-var settlement --------------------------------------------------
    def settle(self, name, natural, op, idx, path):
        """Reconcile the propagated ``natural`` spec of a fresh write
        against the stamped activation constraint (the layout the
        executor pins): a disagreement is a real reshard the step pays,
        priced here and classified ``constraint``.  Duplicate mesh axes
        in the final spec are a ``mesh_axis_overuse`` error."""
        if not name:
            return
        shape, _ = _shape_of(self.block, name, self.batch)
        natural = _norm(_pad(natural, len(shape or natural or ())))
        final = natural
        con = self.constraints.get(name)
        if con is not None and shape is not None \
                and len(con) == len(shape):
            con = _norm(con)
            if natural is not None and con != natural:
                nat = _pad(natural, len(shape))
                cn = _pad(con, len(shape))
                gathered = [a for a, b in zip(nat, cn)
                            if a is not None and a != b]
                kept = {b for b in cn if b is not None}
                for ax in dict.fromkeys(gathered):       # stable order
                    kind = "all_to_all" if ax in kept else "all_gather"
                    self.edge(kind, ax, name, "constraint", op=op,
                              idx=idx, src=natural, dst=con)
            final = con
        dup = _dup_axis(final)
        if dup is not None and name not in self._conflicted:
            self._conflicted.add(name)
            self.diag(
                "mesh_axis_overuse", "error",
                f"spec {final} for var {name!r} uses mesh axis {dup!r} "
                "on more than one dim — one tensor cannot be laid out "
                "twice over the same mesh ring",
                op=op, idx=idx, var=name, path=path,
                fix="remap one of the var's logical axes to a different "
                    "mesh axis (or None) in the rule table")
        self.spec[name] = final

    # -- op walk -------------------------------------------------------------
    def run(self):
        self._walk(self.block, "0")

    def _walk(self, block: Block, path: str):
        for idx, op in enumerate(block.ops):
            t = op.type
            if t in _SKIP or t.endswith("_grad") or t.startswith("c_"):
                continue
            for attr_name, sub in sub_blocks_of(op):
                self._walk(sub, f"{path}/{t}@{idx}/{attr_name}")
            self._op(op, idx, path)

    def _in(self, op, slot):
        names = op.inputs.get(slot, [])
        return names[0] if names else None

    def _out(self, op, *slots):
        for slot in slots:
            names = op.outputs.get(slot, [])
            if names:
                return names[0]
        return None

    def _op(self, op, idx, path):
        t = op.type
        if t in ("lookup_table", "fused_embedding_layer_norm"):
            self._lookup(op, idx, path)
        elif t in ("mul", "matmul", "matmul_v2", "fused_dense_act"):
            # fused_dense_act (fusion pass): X @ W + Bias -> act — the
            # matmul semantics carry; bias/act are layout-preserving
            self._matmul(op, idx, path)
        elif t in ("reshape", "reshape2"):
            self._reshape(op, idx, path)
        elif t in ("transpose", "transpose2"):
            self._transpose(op, idx, path)
        elif t == "layer_norm":
            self._layer_norm(op, idx, path)
        elif t == "softmax":
            self._softmax(op, idx, path)
        elif t in _CE_OPS:
            self._cross_entropy(op, idx, path)
        elif t in ("mean", "reduce_mean", "reduce_sum"):
            self._reduce(op, idx, path)
        elif t == "gather":
            self._gather(op, idx, path)
        elif t == "split":
            self._split(op, idx, path)
        elif t == "concat":
            x = self._in(op, "X")
            self.settle(self._out(op, "Out"), self.spec.get(x), op, idx,
                        path)
        elif t in _ELTWISE:
            self._eltwise(op, idx, path)
        else:
            self._default(op, idx, path)

    def _lookup(self, op, idx, path):
        w, ids = self._in(op, "W"), self._in(op, "Ids")
        out = self._out(op, "Out")
        wspec = _pad(self.spec.get(w), 2)
        ids_spec = self.spec.get(ids)
        oshape, _ = _shape_of(self.block, out, self.batch)
        orank = len(oshape or ()) or (len(_pad(ids_spec, 1)) + 1)
        natural = _pad(ids_spec, orank - 1) + (wspec[1],)
        if wspec[0] is not None:
            # vocab-sharded table: each shard holds a vocab slice, the
            # gathered rows are partial (masked) and all-reduce across
            # the vocab ring forward AND backward (scatter-add of dOut)
            self.edge("all_reduce", wspec[0], out, "vocab_embed", op=op,
                      idx=idx)
            if self._has_backward:
                self.edge("all_reduce", wspec[0], out, "vocab_embed",
                          direction="bwd", op=op, idx=idx)
        self.settle(out, natural, op, idx, path)

    def _matmul(self, op, idx, path):
        x = self._in(op, "X")
        y = self._in(op, "Y") or self._in(op, "W")
        out = self._out(op, "Out")
        xshape, _ = _shape_of(self.block, x, self.batch)
        yshape, _ = _shape_of(self.block, y, self.batch)
        if not xshape or not yshape or not out:
            self.settle(out, None, op, idx, path)
            return
        tx = bool(op.attrs.get("transpose_X"))
        ty = bool(op.attrs.get("transpose_Y"))
        xs = _pad(self.spec.get(x), len(xshape))
        ys = _pad(self.spec.get(y), len(yshape))
        # contraction positions (mul flattens per num_col_dims; its
        # contraction is x's trailing block vs y's leading block —
        # modeled as last-vs-first, the rank-2 common case)
        xc_i = (len(xshape) - 2 if tx else len(xshape) - 1) \
            if len(xshape) >= 2 else 0
        yc_i = (len(yshape) - 1 if ty else len(yshape) - 2) \
            if len(yshape) >= 2 else 0
        yo_i = (len(yshape) - 2 if ty else len(yshape) - 1) \
            if len(yshape) >= 2 else 0
        xc, yc = xs[xc_i], ys[yc_i]
        out_shape, _ = _shape_of(self.block, out, self.batch)
        orank = len(out_shape or ()) or 2
        # batch dims come from x; the last dim from y's out dim
        lead = [s for i, s in enumerate(xs)
                if i != xc_i][:max(orank - 1, 0)]
        natural = list(_pad(tuple(lead), orank - 1)) + [ys[yo_i]]
        if xc is not None and yc is not None:
            if xc == yc:
                # row-parallel: both operands sharded over the
                # contraction — output is a partial sum, all-reduced
                # over the ring in forward
                self.edge("all_reduce", xc, out, "partial_sum", op=op,
                          idx=idx, src=xs, dst=tuple(natural))
            else:
                if x not in self._conflicted:
                    self._conflicted.add(x)
                    self.diag(
                        "spec_conflict", "error",
                        f"matmul contracts {x!r} (sharded {xc!r}) "
                        f"against {y!r} (sharded {yc!r}): two mesh "
                        "axes demanded for one contraction — "
                        "cross-rank-ambiguous, no layout satisfies "
                        "both", op=op, idx=idx, var=x, path=path,
                        fix="align the two operands' contraction axes "
                            "in the rule table (same mesh axis or "
                            "replicate one)")
        elif (xc is None) != (yc is None):
            # one-sided contraction sharding: GSPMD must gather the
            # sharded operand (or re-slice the other — it picks); an
            # implicit reshard edge, surfaced as a spec_conflict
            # warning because the table owner likely did not want it
            sharded_var, ax = (x, xc) if xc is not None else (y, yc)
            self.edge("all_gather", ax, sharded_var, "spec_mismatch",
                      op=op, idx=idx, src=self.spec.get(sharded_var))
            if sharded_var not in self._conflicted:
                self._conflicted.add(sharded_var)
                self.diag(
                    "spec_conflict", "warning",
                    f"matmul contraction of {x!r} x {y!r} is sharded "
                    f"on one side only ({sharded_var!r} over {ax!r}): "
                    "GSPMD inserts an implicit all-gather every step",
                    op=op, idx=idx, var=sharded_var, path=path,
                    fix="shard both contraction operands on the same "
                        "mesh axis, or neither")
        if xc is not None and yc == xc:
            natural[-1] = ys[yo_i]   # psum output: y's out-dim layout
        # Megatron column-parallel backward: dX = dOut @ W^T partials
        # all-reduce over the out-dim ring (the f-operator's g-dual)
        if self._has_backward and ys[yo_i] is not None \
                and yc is None and xc is None:
            self.edge("all_reduce", ys[yo_i], x, "grad_partial",
                      direction="bwd", op=op, idx=idx)
        self.settle(out, tuple(natural), op, idx, path)

    def _reshape(self, op, idx, path):
        x, out = self._in(op, "X"), self._out(op, "Out")
        xshape, _ = _shape_of(self.block, x, self.batch)
        oshape, _ = _shape_of(self.block, out, self.batch)
        xs = self.spec.get(x)
        if xs is None or not xshape or not oshape:
            self.settle(out, None, op, idx, path)
            return
        xs = _pad(xs, len(xshape))
        natural = [None] * len(oshape)
        # greedy split/merge dim matching by running products: a
        # sharded in-dim lands on the FIRST out-dim of its group (the
        # shard boundary falls on the leading factor)
        i = j = 0
        pi = pj = 1
        group_in, group_out = [], []
        while i < len(xshape) or j < len(oshape):
            if pi == pj and (group_in or group_out):
                for gi in group_in:
                    if xs[gi] is not None:
                        tgt = group_out[0] if group_out else None
                        n = self.axis_sizes.get(xs[gi], 1)
                        if tgt is not None and \
                                oshape[tgt] % max(n, 1) == 0:
                            natural[tgt] = xs[gi]
                        else:
                            self.edge("all_gather", xs[gi], x,
                                      "constraint", op=op, idx=idx,
                                      src=xs)
                group_in, group_out = [], []
            if pi <= pj and i < len(xshape):
                group_in.append(i)
                pi *= max(xshape[i], 1)
                i += 1
            elif j < len(oshape):
                group_out.append(j)
                pj *= max(oshape[j], 1)
                j += 1
            else:
                break
        for gi in group_in:
            if xs[gi] is not None and group_out:
                tgt = group_out[0]
                n = self.axis_sizes.get(xs[gi], 1)
                if oshape[tgt] % max(n, 1) == 0:
                    natural[tgt] = xs[gi]
        self.settle(out, tuple(natural), op, idx, path)

    def _transpose(self, op, idx, path):
        x, out = self._in(op, "X"), self._out(op, "Out")
        perm = op.attrs.get("axis") or op.attrs.get("perm") or ()
        xs = self.spec.get(x)
        if xs is None or not perm:
            self.settle(out, xs, op, idx, path)
            return
        xs = _pad(xs, len(perm))
        self.settle(out, tuple(xs[p] for p in perm), op, idx, path)

    def _layer_norm(self, op, idx, path):
        x = self._in(op, "X")
        out = self._out(op, "Y", "Out")
        xs = self.spec.get(x)
        xshape, dtype = _shape_of(self.block, x, self.batch)
        bna = int(op.attrs.get("begin_norm_axis", 1) or 1)
        if xs is not None and xshape:
            xs_p = _pad(xs, len(xshape))
            normed = [a for a in xs_p[bna:] if a is not None]
            for ax in dict.fromkeys(normed):
                # partial mean/var all-reduce: 2 stats per row
                rows = _numel(xshape[:bna])
                self.edge("all_reduce", ax, x, "norm_stats", op=op,
                          idx=idx, payload=2 * rows * _itemsize(dtype))
        self.settle(out, xs, op, idx, path)

    def _softmax(self, op, idx, path):
        x, out = self._in(op, "X"), self._out(op, "Out")
        xs = self.spec.get(x)
        xshape, dtype = _shape_of(self.block, x, self.batch)
        axis = int(op.attrs.get("axis", -1) if op.attrs.get("axis")
                   is not None else -1)
        if xs is not None and xshape:
            xs_p = _pad(xs, len(xshape))
            ax = xs_p[axis]
            if ax is not None:
                rows = _numel(xshape) // max(xshape[axis], 1)
                self.edge("all_reduce", ax, x, "softmax_stats", op=op,
                          idx=idx, payload=2 * rows * _itemsize(dtype))
        self.settle(out, xs, op, idx, path)

    def _cross_entropy(self, op, idx, path):
        slot = "Logits" if "Logits" in op.inputs else "X"
        logits = self._in(op, slot)
        loss = self._out(op, "Loss", "Y", "Out")
        ls = self.spec.get(logits)
        lshape, dtype = _shape_of(self.block, logits, self.batch)
        if ls is not None and lshape:
            ls_p = _pad(ls, len(lshape))
            if ls_p[-1] is not None:
                # vocab-parallel CE: max + sum-exp partials all-reduce
                # over the vocab ring, forward and backward
                rows = _numel(lshape[:-1])
                self.edge("all_reduce", ls_p[-1], logits, "vocab_ce",
                          op=op, idx=idx,
                          payload=2 * rows * _itemsize(dtype))
                if self._has_backward:
                    self.edge("all_reduce", ls_p[-1], logits,
                              "vocab_ce", direction="bwd", op=op,
                              idx=idx,
                              payload=rows * _itemsize(dtype))
            sm = self._out(op, "Softmax")
            if sm:
                self.settle(sm, ls, op, idx, path)
            if loss:
                lshape_out, _ = _shape_of(self.block, loss, self.batch)
                self.settle(
                    loss, _pad(tuple(ls_p[:-1]), len(lshape_out or ())),
                    op, idx, path)
            return
        for o in (self._out(op, "Softmax"), loss):
            if o:
                self.settle(o, ls if o != loss else None, op, idx, path)

    def _reduce(self, op, idx, path):
        x, out = self._in(op, "X"), self._out(op, "Out")
        xs = self.spec.get(x)
        _, dtype = _shape_of(self.block, x, self.batch)
        for ax in dict.fromkeys(a for a in (xs or ()) if a is not None):
            if ax == self.dp:
                continue    # dp partials fold into the batch
                            # reduction's own dp sum (not a reshard)
            self.edge("all_reduce", ax, out or x, "loss_reduce", op=op,
                      idx=idx, payload=_itemsize(dtype))
        self.settle(out, None, op, idx, path)

    def _split(self, op, idx, path):
        x = self._in(op, "X")
        outs = op.outputs.get("Out", [])
        xs = self.spec.get(x)
        xshape, _ = _shape_of(self.block, x, self.batch)
        axis = int(op.attrs.get("axis", 0) or 0)
        if xs is not None and xshape:
            xs_p = _pad(xs, len(xshape))
            ax = xs_p[axis]
            if ax is not None and ax != self.dp:
                # splitting a sharded dim (the QKV pack): section
                # boundaries straddle shard boundaries, the step reshards
                # the pack once per step
                self.edge("all_to_all", ax, x, "split", op=op, idx=idx,
                          src=xs)
        for o in outs:
            natural = xs
            if xs is not None and xshape:
                oshape, _ = _shape_of(self.block, o, self.batch)
                xs_p = list(_pad(xs, len(xshape)))
                n = self.axis_sizes.get(xs_p[axis] or "", 1)
                if xs_p[axis] is not None and oshape \
                        and oshape[axis] % max(n, 1) != 0:
                    xs_p[axis] = None
                natural = tuple(xs_p)
            self.settle(o, natural, op, idx, path)

    def _gather(self, op, idx, path):
        x, index = self._in(op, "X"), self._in(op, "Index")
        out = self._out(op, "Out")
        xs = self.spec.get(x)
        xshape, _ = _shape_of(self.block, x, self.batch)
        xs_p = _pad(xs, len(xshape or ())) if xs is not None else ()
        if xs_p and xs_p[0] is not None:
            # indexing into a sharded leading dim: the rows a shard
            # needs live anywhere on the ring — GSPMD gathers
            self.edge("all_gather", xs_p[0], x, "gather", op=op,
                      idx=idx, src=xs)
        idx_spec = _pad(self.spec.get(index), 1)
        natural = (idx_spec[0],) + tuple(xs_p[1:])
        self.settle(out, natural, op, idx, path)

    def _eltwise(self, op, idx, path):
        x = self._in(op, "X")
        out = self._out(op, "Out")
        xshape, _ = _shape_of(self.block, x, self.batch)
        natural = self.spec.get(x)
        if op.type in _BINARY:
            y = self._in(op, "Y")
            yshape, _ = _shape_of(self.block, y, self.batch)
            ys = self.spec.get(y)
            if ys is not None and xshape is not None \
                    and yshape is not None:
                xs_p = _pad(natural, len(xshape))
                ys_p = _pad(ys, len(yshape))
                rank = max(len(xshape), len(yshape))
                joined = []
                for k in range(1, rank + 1):   # align trailing dims
                    a = xs_p[-k] if k <= len(xs_p) else None
                    b = ys_p[-k] if k <= len(ys_p) else None
                    if a is not None and b is not None and a != b:
                        key = (out or x) + "#join"
                        if key not in self._conflicted:
                            self._conflicted.add(key)
                            self.diag(
                                "spec_conflict", "error",
                                f"{op.type} joins {x!r} ({a!r}) with "
                                f"{y!r} ({b!r}) on the same dim: two "
                                "mesh axes demanded for one var — "
                                "cross-rank-ambiguous",
                                op=op, idx=idx, var=out or x, path=path,
                                fix="shard both operands of the "
                                    "elementwise op identically")
                        joined.append(a)
                    else:
                        joined.append(a if a is not None else b)
                natural = tuple(reversed(joined))
        self.settle(out, natural, op, idx, path)

    def _default(self, op, idx, path):
        """Unmodeled op: output replicated; a sharded (non-dp) input
        is an implicit gather the pass cannot explain."""
        out = self._out(op, "Out", "Y")
        for slot, names in sorted(op.inputs.items()):
            for name in names:
                s = self.spec.get(name)
                axes = [a for a in (s or ())
                        if a is not None and a != self.dp]
                if not axes:
                    continue
                v = self.block.var(name) if self.block.has_var(name) \
                    else None
                if v is not None and getattr(v, "persistable", False):
                    continue
                self.edge("all_gather", axes[0], name, "spec_mismatch",
                          op=op, idx=idx, src=s)
                if name not in self._conflicted:
                    self._conflicted.add(name)
                    self.diag(
                        "spec_conflict", "warning",
                        f"op {op.type!r} consumes {name!r} sharded "
                        f"{s} but has no sharding rule in the static "
                        "pass: modeled as a full all-gather",
                        op=op, idx=idx, var=name, path=path,
                        fix="replicate the producer in the rule table "
                            "or extend analysis.sharding with the op's "
                            "semantics")
        if out:
            self.settle(out, None, op, idx, path)

    # -- analytic gradient-sync traffic --------------------------------------
    @property
    def _has_backward(self) -> bool:
        cached = getattr(self, "_bwd", None)
        if cached is None:
            cached = self._bwd = any(
                o.type.endswith("_grad") for o in self.block.ops)
        return cached

    def grad_sync_edges(self, zero_stage: int):
        """Per-param data-parallel gradient synchronization: replicated
        params all-reduce grad shards over dp (the batch-sharded backward
        leaves each rank a partial sum); ZeRO-1 splits it into a
        reduce-scatter (grads to the owning dp shard) + all-gather
        (updated params back) — same ring bytes, different kinds."""
        if not self._has_backward or not self.dp:
            return
        for name in sorted(self.block.vars):
            v = self.block.var(name)
            if not getattr(v, "is_parameter", False):
                continue
            shape, dtype = _shape_of(self.block, name, self.batch)
            if not shape:
                continue
            nbytes = _numel(shape) * _itemsize(dtype)
            for ax in (self.spec.get(name) or ()):
                if ax is not None:
                    nbytes //= max(self.axis_sizes.get(ax, 1), 1)
            if zero_stage >= 1:
                self.edge("reduce_scatter", self.dp, name, "zero1_grad",
                          direction="bwd", payload=nbytes)
                self.edge("all_gather", self.dp, name, "zero1_param",
                          direction="bwd", payload=nbytes)
            else:
                self.edge("all_reduce", self.dp, name, "grad_sync",
                          direction="bwd", payload=nbytes)


# ---------------------------------------------------------------------------
# entry point + cache
# ---------------------------------------------------------------------------

# (program fingerprint, fetch tuple, batch, zero, layout sha) ->
# ShardingPlan; bounded FIFO — the verifier/comms cache discipline
_CACHE: Dict[tuple, ShardingPlan] = {}  # guarded-by: _CACHE_LOCK
_CACHE_CAP = 128
_CACHE_LOCK = threading.Lock()


def clear_cache() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()


def plan_sharding(program: Program, fetch_names=(), batch_size: int = 1,
                  stamp: Optional[dict] = None, specs=None,
                  axis_sizes=None, rules: Optional[str] = None,
                  zero_stage: Optional[int] = None) \
        -> Optional[ShardingPlan]:
    """Propagate PartitionSpecs and price every reshard edge for one
    partitioned program.  Layout comes from the ``_attrs["partition"]``
    stamp by default; ``choose_rules`` passes candidate ``specs`` (one
    merged {var -> spec} dict — params seed the walk, activations
    become constraints) + ``axis_sizes`` to price tables BEFORE
    stamping.  Returns None for unpartitioned programs.  Cached on
    (program fingerprint, fetch tuple, batch, zero stage, layout)."""
    fetch_names = tuple(
        f.name if hasattr(f, "name") else f for f in (fetch_names or ()))
    dropped = ()
    if specs is None:
        stamp = stamp if stamp is not None else \
            program._attrs.get("partition")
        if not stamp:
            return None
        axis_sizes = dict(stamp.get("mesh_axes") or {}) \
            if axis_sizes is None else dict(axis_sizes)
        seeds = {k: tuple(v) for k, v in
                 (stamp.get("params") or {}).items()}
        constraints = {k: tuple(v) for k, v in
                       (stamp.get("activations") or {}).items()}
        rules = stamp.get("rules") if rules is None else rules
        if zero_stage is None:
            zero_stage = int(stamp.get("zero_stage") or 0)
        dropped = tuple(tuple(d) for d in (stamp.get("dropped") or ()))
    else:
        if axis_sizes is None:
            return None
        axis_sizes = dict(axis_sizes)
        block = program.global_block()
        seeds, constraints = {}, {}
        for k, v in specs.items():
            is_param = block.has_var(k) and \
                getattr(block.var(k), "is_parameter", False)
            (seeds if is_param else constraints)[k] = tuple(v)
    zero_stage = int(zero_stage or 0)
    layout = hashlib.sha1(repr((
        rules, sorted(axis_sizes.items()), sorted(seeds.items()),
        sorted(constraints.items()), dropped)).encode()).hexdigest()
    key = (program.fingerprint(), fetch_names, int(batch_size),
           zero_stage, layout)
    with _CACHE_LOCK:
        cached = _CACHE.get(key)
    if cached is not None:
        return cached
    with _monitor.TRACER.span("sharding.plan", "compile",
                              fetches=len(fetch_names)):
        plan = _plan(program, fetch_names, batch_size, seeds, constraints,
                     axis_sizes, rules, zero_stage, dropped)
    _RESHARD_GAUGE.set(float(plan.payload_bytes))
    with _CACHE_LOCK:
        if key not in _CACHE:
            if len(_CACHE) >= _CACHE_CAP:   # FIFO bound, see _CACHE note
                _CACHE.pop(next(iter(_CACHE)))
            _CACHE[key] = plan
        plan = _CACHE[key]
    return plan


def _plan(program, fetch_names, batch_size, seeds, constraints,
          axis_sizes, rules, zero_stage, dropped) -> ShardingPlan:
    from .comms import device_link_bandwidth
    link_bw = device_link_bandwidth()
    p = _Pass(program, seeds, constraints, axis_sizes, batch_size,
              link_bw)
    for d in dropped:
        var, dim, laxis, maxis, dsize, asize = (tuple(d) + (None,) * 6)[:6]
        p.diag(
            "shard_divisibility", "warning",
            f"dim {dim} of {var!r} (size {dsize}, logical axis "
            f"{laxis!r}) does not divide mesh axis {maxis!r} "
            f"(size {asize}): the partitioner kept it REPLICATED — "
            "the table's sharding silently does not apply here",
            var=var,
            fix=f"pad {var!r} to a multiple of {asize} along dim "
                f"{dim}, or unmap {laxis!r} in the rule table")
    p.run()
    p.grad_sync_edges(zero_stage)
    try:
        from .cost import device_peak_flops, plan_cost
        compute_ms = plan_cost(program, fetch_names,
                               batch_size=batch_size).flops \
            / device_peak_flops() * 1e3
    except Exception:
        compute_ms = 0.0
    edges = p.edges
    # the parity token hashes the TRAFFIC multiset, not var names: a
    # semantics-preserving rewrite (graph fusion renames the anchor
    # vars but moves the same bytes over the same rings) must keep the
    # token stable, or the fusion pass's fingerprint-parity guard would
    # roll back every fusion on a partitioned program
    fp = hashlib.sha1(repr((
        sorted(axis_sizes.items()), rules, zero_stage,
        sorted((e.direction, e.kind, e.mesh_axis, e.nranks,
                e.payload_bytes, e.reason) for e in edges))).encode()
    ).hexdigest()
    return ShardingPlan(
        rules=rules, mesh_axes=dict(axis_sizes),
        batch_size=int(batch_size), zero_stage=zero_stage,
        link_bw=link_bw,
        specs={k: v for k, v in p.spec.items() if v is not None},
        edges=edges, diagnostics=p.diags,
        payload_bytes=sum(e.payload_bytes for e in edges),
        wire_bytes=sum(e.wire_bytes for e in edges),
        est_ms=sum(e.est_ms for e in edges),
        compute_ms=compute_ms, fingerprint=fp)


# ---------------------------------------------------------------------------
# consumers
# ---------------------------------------------------------------------------

def stamp_attrs(plan: Optional[ShardingPlan]) -> Optional[dict]:
    """The machine-readable ``_attrs["verify"]["sharding"]`` payload
    (tools/analyze, the smoke gates, choose_rules auditing)."""
    if plan is None:
        return None
    return {
        "rules": plan.rules,
        "mesh_axes": dict(plan.mesh_axes),
        "zero_stage": plan.zero_stage,
        "n_edges": len(plan.edges),
        "n_unexplained": len(plan.unexplained),
        "payload_bytes": plan.payload_bytes,
        "wire_bytes": plan.wire_bytes,
        "est_ms": round(plan.est_ms, 6),
        "compute_ms": round(plan.compute_ms, 6),
        "fingerprint": plan.fingerprint,
        "resh_token": plan.resh_token,
        "edges": [
            (e.direction, e.kind, e.mesh_axis, e.var, e.payload_bytes,
             e.wire_bytes, e.reason, e.exact) for e in plan.edges],
    }


def as_comms_plan(plan: ShardingPlan):
    """Project a sharding plan onto the ``analysis.comms`` CommsPlan
    shape, so the executor's pre-bound byte-cell accounting, the comms
    monitor's wait/wire decomposition and the ``comm_*`` digest keys all
    work unchanged on partitioned programs (whose user program holds no
    ``c_*`` op for plan_comms to find)."""
    from .comms import CollectiveCost, CommsPlan
    nranks = 1
    for s in plan.mesh_axes.values():
        nranks *= max(int(s), 1)
    collectives = [
        CollectiveCost(
            path="gspmd", pos=i, op=e.collective_op, ring_id=0,
            dtype=e.dtype, shape=tuple(e.shape),
            payload_bytes=e.payload_bytes, wire_bytes=e.wire_bytes,
            est_ms=e.est_ms)
        for i, e in enumerate(plan.edges)]
    return CommsPlan(
        nranks=nranks, link_bw=plan.link_bw,
        batch_size=plan.batch_size, collectives=collectives,
        payload_bytes=plan.payload_bytes, wire_bytes=plan.wire_bytes,
        est_ms=plan.est_ms, compute_ms=plan.compute_ms,
        fingerprint="gspmd:" + plan.fingerprint)


def runtime_comms_plan(program: Program, fetch_names=(),
                       batch_size: int = 1):
    """Executor hook (``_resolve_comms`` fallback): the reshard plan of
    a partitioned program at the REAL feed batch, as a CommsPlan — or
    None when the program is unpartitioned."""
    plan = plan_sharding(program, fetch_names, batch_size=batch_size)
    if plan is None or not plan.edges:
        return None
    return as_comms_plan(plan)


def check_decode_hostable(program: Program, raise_on_violation=True):
    """Serving-side gate: the paged KV cache (``serving.kv_cache``)
    allocates full per-head pages and full unsharded decode params on
    ONE chip (``params_from_scope`` pulls whole arrays by name), so an
    mp-sharded decode-path program cannot be hosted until the
    GSPMD-serving arc lands.  Returns the offending ``(param, spec)``
    list; raises ValueError naming them when ``raise_on_violation``."""
    stamp = program._attrs.get("partition") or {}
    offending = [
        (name, tuple(spec))
        for name, spec in sorted((stamp.get("params") or {}).items())
        if any(ax is not None and ax != "dp" for ax in spec)]
    if offending and raise_on_violation:
        named = ", ".join(f"{n}={s}" for n, s in offending)
        raise ValueError(
            f"decode program is model-parallel sharded (rules="
            f"{stamp.get('rules')!r}): the paged KV cache hosts full "
            f"per-head pages and unsharded params on one chip and "
            f"cannot serve these specs: {named}. Serve a replicated "
            "(or dp-only) program, or gather the params before "
            "building the DecodeEngine.")
    return offending
