"""GSPMD model-parallel partitioner: logical-axis sharding rules (the port
of ``paddle_tpu/parallel/partitioner.py``; the T5X logical-axis-rules
design, arxiv 2203.17189 §D).

1. **Logical axis inference** (:func:`infer_logical_axes`): a walk over the
   dependency-ordered ``framework.ir`` Graph labels every parameter dim
   with a logical axis ("embed", "mlp", "heads", "kv", "vocab") from the
   op types that produce and consume it: a ``lookup_table`` weight is
   ``(vocab, embed)``, a matmul weight fed from an embed-axis activation
   is column-parallel ``(embed, mlp|heads)``, its back projection
   row-parallel ``(mlp|heads, embed)``, and the weight whose output feeds
   a cross-entropy is the ``vocab`` head.
2. **Rule tables** (:class:`LogicalAxisRules`): ``{logical axis -> mesh
   axis}``.  :func:`apply_rules` turns the logical axes into
   ``Variable.dist_spec`` tuples (a dim the mesh axis does not divide
   stays replicated and is recorded as dropped, with one warning) and
   stamps ``program._attrs["partition"]``: the table, the mesh shape, the
   per-parameter specs and the per-activation constraints.
3. **Planner-driven selection** (:func:`choose_rules`): the tables in
   cheapest-traffic-first order; the per-shard static peak
   (``analysis.memory.plan_sharded_memory``) of the first table within
   ``FLAGS_memory_budget_mb`` wins, priced on its reshard plan
   (``analysis.sharding``).

``CompiledProgram.with_gspmd(zero_stage=1)`` adds ZeRO-1 underneath (arxiv
2004.13336): optimizer accumulators take their parameter's spec through
``shard_like`` plus ``dp`` on a free, divisible leading dim.  The stamp,
the specs, the report and the fingerprint equal the reference's on the
same program; the executor then runs the partitioned program as SPMD over
the mesh's ranks (``parallel/spmd.py``).
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import monitor as _monitor

__all__ = [
    "LogicalAxisRules", "DEFAULT_RULE_TABLES", "rule_table",
    "infer_logical_axes", "apply_rules", "choose_rules",
    "partition_program", "partition_fingerprint",
]

#: planner decisions by outcome ("fit" = budget satisfied, "fallback" =
#: nothing fit and the most-sharded table was taken, "no_budget")
_CHOICE_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_gspmd_rule_choices_total",
    "partitioner rule-table selections by planner outcome",
    ("rules", "outcome"))
_SHARD_PEAK_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_gspmd_per_shard_peak_bytes",
    "static per-shard HBM peak of the most recently chosen rule table")


@dataclass(frozen=True)
class LogicalAxisRules:
    """A named ``{logical axis -> mesh axis or None}`` table (t5x
    ``logical_axis_rules`` / ``DEFAULT_RULES``).  ``None``
    keeps the logical axis replicated; axes absent from the table default
    to replicated too."""

    name: str
    rules: Dict[str, Optional[str]] = field(default_factory=dict)

    def mesh_axis(self, logical: Optional[str]) -> Optional[str]:
        if logical is None:
            return None
        return self.rules.get(logical)

    def token(self) -> str:
        return self.name + ":" + ",".join(
            f"{k}={v}" for k, v in sorted(self.rules.items()))


#: candidate tables, CHEAPEST COMMUNICATION FIRST — the planner walks
#: this order and takes the first table whose per-shard peak fits the
#: budget, so ties between fitting tables resolve toward less traffic.
DEFAULT_RULE_TABLES: Tuple[LogicalAxisRules, ...] = (
    # pure DP: params replicated, batch over dp (the with_data_parallel
    # layout, expressed as the empty rule table)
    LogicalAxisRules("replicated", {"batch": "dp"}),
    # Megatron block sharding: attention heads + FFN hidden over mp;
    # embed stays replicated so layer boundaries need no resharding
    LogicalAxisRules("mp_hidden", {
        "batch": "dp", "heads": "mp", "kv": "mp", "mlp": "mp"}),
    # + vocab-sharded embedding/LM head: the biggest params shard too
    # (more allreduce traffic: embedding gather + logits reduction)
    LogicalAxisRules("mp_hidden_vocab", {
        "batch": "dp", "heads": "mp", "kv": "mp", "mlp": "mp",
        "vocab": "mp"}),
)


def rule_table(name_or_rules) -> LogicalAxisRules:
    """Resolve a rule table: a :class:`LogicalAxisRules` passes through,
    a dict becomes an ad-hoc table, a string names a default table."""
    if isinstance(name_or_rules, LogicalAxisRules):
        return name_or_rules
    if isinstance(name_or_rules, dict):
        return LogicalAxisRules("custom", dict(name_or_rules))
    for t in DEFAULT_RULE_TABLES:
        if t.name == name_or_rules:
            return t
    raise ValueError(
        f"unknown rule table {name_or_rules!r}; known: "
        f"{[t.name for t in DEFAULT_RULE_TABLES]} (or pass a "
        "{logical_axis: mesh_axis} dict)")


# ---------------------------------------------------------------------------
# logical-axis inference over the ir Graph
# ---------------------------------------------------------------------------

#: ops that preserve the last-dim logical axis of their first input
_PROPAGATE = frozenset((
    "relu", "gelu", "tanh", "sigmoid", "softmax", "dropout", "scale",
    "layer_norm", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "cast", "sum", "concat", "fused_bias_act",
    "fused_dense_act",
))

#: loss ops whose logits input chain marks the vocab projection
_CE_OPS = frozenset((
    "cross_entropy", "softmax_with_cross_entropy", "fused_lm_head_ce",
))


def _is_param(block, name) -> bool:
    return (name and block.has_var(name)
            and getattr(block.var(name), "is_parameter", False))


def _first(names):
    return names[0] if names else None


def infer_logical_axes(program) -> Dict[str, Tuple[Optional[str], ...]]:
    """Per-parameter logical axis names, one per dim (None = no logical
    identity → always replicated).  Walks ops in the ir Graph's
    dependency order propagating the last-dim logical axis of every
    activation (the cost/int64 analyses' walking discipline)."""
    from ..framework import ir
    block = program.global_block()
    order = ir.Graph(program).topology_sort()

    axes: Dict[str, Tuple[Optional[str], ...]] = {}
    act: Dict[str, Optional[str]] = {}     # var -> last-dim logical axis
    produced_by: Dict[str, object] = {}    # var -> producing op (for CE pass)

    def consumers(name):
        out = []
        for node in order:
            op = node.op
            if any(name in ns for ns in op.inputs.values()):
                out.append(op)
        return out

    # head-split detection: a matmul output whose (activation-chain)
    # consumers include a reshape ADDING a trailing dim is a q/k/v
    # projection — label its out axis "heads" instead of "mlp"
    def _feeds_head_split(name, depth=3):
        if depth <= 0:
            return False
        for op in consumers(name):
            if op.type in ("reshape", "reshape2"):
                shape = op.attrs.get("shape") or ()
                src = _first(op.inputs.get("X", []))
                if (src and block.has_var(src)
                        and block.var(src).shape is not None
                        and len(shape) > len(block.var(src).shape)):
                    return True
            elif op.type in _PROPAGATE:
                out = _first(op.outputs.get("Out", []))
                if out and _feeds_head_split(out, depth - 1):
                    return True
        return False

    for node in order:
        op = node.op
        t = op.type
        if t == "lookup_table":
            w = _first(op.inputs.get("W", []))
            out = _first(op.outputs.get("Out", []))
            if _is_param(block, w):
                axes[w] = ("vocab", "embed")
            if out:
                act[out] = "embed"
                produced_by[out] = op
        elif t in ("mul", "matmul", "matmul_v2"):
            x = _first(op.inputs.get("X", []))
            y = _first(op.inputs.get("Y", []))
            out = _first(op.outputs.get("Out", []))
            if not _is_param(block, y):
                # activation×activation matmul (attention scores): the
                # product's last dim carries no parameter identity
                if out:
                    act[out] = None
                    produced_by[out] = op
                continue
            yshape = tuple(block.var(y).shape or ())
            in_ax = act.get(x, "embed")
            if in_ax in ("mlp", "heads", "kv"):
                out_ax = "embed"               # row-parallel projection
            elif _feeds_head_split(out) if out else False:
                out_ax = "heads"               # q/k/v column projection
            else:
                out_ax = "mlp"                 # FFN column projection
            yaxes = (in_ax, out_ax)
            if op.attrs.get("transpose_Y"):
                yaxes = (out_ax, in_ax)
            if len(yshape) == len(yaxes):
                axes[y] = yaxes
            if out:
                act[out] = out_ax
                produced_by[out] = op
        elif t in _PROPAGATE:
            x = _first(op.inputs.get("X", []))
            out = _first(op.outputs.get("Out", []))
            # a rank-1 parameter on an elementwise op is a bias/scale
            # vector along the activation's last-dim axis
            for slot in ("Y", "Scale", "Bias"):
                p = _first(op.inputs.get(slot, []))
                if _is_param(block, p) and \
                        len(block.var(p).shape or ()) == 1:
                    ax = act.get(x, "embed" if t == "layer_norm" else None)
                    axes.setdefault(p, (ax,))
            if out:
                act[out] = act.get(x)
                produced_by[out] = op
        elif t in ("reshape", "reshape2", "transpose", "transpose2"):
            x = _first(op.inputs.get("X", []))
            out = _first(op.outputs.get("Out", []))
            if out:
                # conservatively drop the label across layout changes —
                # a wrong axis here would constrain activations wrongly
                act[out] = act.get(x) if t.startswith("reshape") else None
                produced_by[out] = op

    # vocab head pass: the matmul feeding a cross-entropy projects onto
    # the vocabulary — relabel its weight's OUT axis (and its bias)
    for node in order:
        op = node.op
        if op.type not in _CE_OPS:
            continue
        slot = "Logits" if "Logits" in op.inputs else "X"
        name = _first(op.inputs.get(slot, []))
        for _ in range(6):              # walk back through the act chain
            src = produced_by.get(name)
            if src is None:
                break
            if src.type in ("mul", "matmul", "matmul_v2"):
                y = _first(src.inputs.get("Y", []))
                if _is_param(block, y) and y in axes:
                    a0, a1 = axes[y]
                    axes[y] = (a0, "vocab") if not \
                        src.attrs.get("transpose_Y") else ("vocab", a1)
                    b = _first(src.outputs.get("Out", []))
                    for bop in consumers(b):
                        if bop.type == "elementwise_add":
                            p = _first(bop.inputs.get("Y", []))
                            if _is_param(block, p):
                                axes[p] = ("vocab",)
                break
            name = _first(src.inputs.get("X", []))
    return axes


# ---------------------------------------------------------------------------
# rule application
# ---------------------------------------------------------------------------

def _spec_for(shape, logical, table: LogicalAxisRules,
              axis_sizes: Dict[str, int], dropped=None, name=None):
    """dist_spec tuple for one var, or None (fully replicated).  A dim
    stays replicated when its logical axis is unmapped, the mesh axis is
    absent/trivial, or the static dim doesn't divide evenly (GSPMD could
    pad, but the memory planner's per-shard arithmetic — and ZeRO-1's
    scope layout — want exact shards).  A non-dividing MAPPED dim is the
    silent-drop case: when ``dropped`` is a list, each such dim appends
    ``(name, dim, logical_axis, mesh_axis, dim_size, axis_size)`` so the
    drop surfaces as a ``shard_divisibility`` diagnostic instead of
    vanishing."""
    spec = []
    for i, (d, ax) in enumerate(zip(shape, logical)):
        m = table.mesh_axis(ax)
        size = axis_sizes.get(m, 0) if m else 0
        if m and size > 1 and isinstance(d, int) and d > 0 \
                and d % size == 0:
            spec.append(m)
        else:
            if dropped is not None and m and size > 1 \
                    and isinstance(d, int) and d > 0:
                dropped.append((name, i, ax, m, int(d), int(size)))
            spec.append(None)
    return tuple(spec) if any(s is not None for s in spec) else None


def apply_rules(program, table, axis_sizes: Dict[str, int],
                logical_axes=None) -> dict:
    """Set ``Variable.dist_spec`` on every inferred parameter per
    ``table`` and stamp ``program._attrs["partition"]`` (table name,
    mesh shape, per-param specs, per-activation sharding constraints).
    Returns the stamp.  Idempotent per (table, mesh)."""
    table = rule_table(table)
    block = program.global_block()
    logical = logical_axes if logical_axes is not None else \
        infer_logical_axes(program)

    params: Dict[str, tuple] = {}
    dropped: List[tuple] = []
    for name, laxes in sorted(logical.items()):
        if not block.has_var(name):
            continue
        v = block.var(name)
        shape = tuple(v.shape or ())
        if len(shape) != len(laxes):
            continue
        spec = _spec_for(shape, laxes, table, axis_sizes,
                         dropped=dropped, name=name)
        v.dist_spec = spec
        if spec is not None:
            params[name] = spec

    # activation constraints: batch dim on dp, last dim per its logical
    # axis — GSPMD would propagate most of these, the explicit
    # constraint pins the layout the planner priced (t5x
    # with_sharding_constraint discipline)
    acts: Dict[str, tuple] = {}
    dp = "dp" if axis_sizes.get("dp", 0) > 1 else None
    act_axis = _activation_axes(program, logical)
    for name, last_ax in act_axis.items():
        if not block.has_var(name):
            continue
        v = block.var(name)
        shape = v.shape
        if v.persistable or getattr(v, "is_data", False) or \
                shape is None or len(shape) < 2:
            continue
        last = table.mesh_axis(last_ax)
        lsize = axis_sizes.get(last, 0) if last else 0
        last_ok = (last and lsize > 1 and isinstance(shape[-1], int)
                   and shape[-1] > 0 and shape[-1] % lsize == 0)
        spec = (dp,) + (None,) * (len(shape) - 2) + \
            (last if last_ok else None,)
        if any(s is not None for s in spec):
            acts[name] = spec

    stamp = {
        "rules": table.name,
        "rules_token": table.token(),
        "mesh_axes": {a: int(s) for a, s in sorted(axis_sizes.items())},
        "params": params,
        "activations": acts,
        # dims the divisibility guard kept replicated even though the
        # table MAPS them — surfaced by the shard_divisibility check
        # (analysis.sharding) instead of dropped silently
        "dropped": dropped,
    }
    program._attrs["partition"] = stamp
    _warn_dropped_dims(stamp)
    return stamp


#: partition fingerprints whose divisibility drops were already warned —
#: once per (table, mesh, specs), not once per re-apply
_DROP_WARNED: set = set()  # guarded-by: _DROP_WARNED_LOCK
_DROP_WARNED_LOCK = threading.Lock()


def _warn_dropped_dims(stamp) -> None:
    """One ``warnings.warn`` per partition fingerprint when the
    divisibility guard dropped mapped dims, formatted through the
    debugger's diagnostic renderer (the verify stamp carries the same
    findings; this warning is the interactive surface)."""
    dropped = stamp.get("dropped")
    if not dropped:
        return
    fp = partition_fingerprint(stamp)
    with _DROP_WARNED_LOCK:
        if fp in _DROP_WARNED:
            return
        _DROP_WARNED.add(fp)
    from .. import debugger
    from ..analysis.verifier import Diagnostic
    diags = [
        Diagnostic(
            check="shard_divisibility", severity="warning",
            message=(
                f"dim {dim} of {name!r} (size {dsize}, logical axis "
                f"{lax!r}) does not divide mesh axis {max_!r} "
                f"(size {asize}): kept REPLICATED"),
            var=name,
            fix_hint=(f"pad {name!r} to a multiple of {asize} along "
                      f"dim {dim}, or unmap {lax!r} in the rule table"))
        for name, dim, lax, max_, dsize, asize in dropped]
    import warnings
    warnings.warn(
        f"GSPMD rule table {stamp.get('rules')!r} silently drops "
        f"{len(dropped)} mapped dim(s):\n"
        + debugger.format_diagnostics(diags), stacklevel=3)


def _activation_axes(program, logical_axes) -> Dict[str, Optional[str]]:
    """Last-dim logical axis per activation var — a second, lighter walk
    sharing :func:`infer_logical_axes`'s propagation rules (returned
    separately so apply_rules can re-run under a different table without
    re-inferring)."""
    from ..framework import ir
    block = program.global_block()
    act: Dict[str, Optional[str]] = {}
    for node in ir.Graph(program).topology_sort():
        op = node.op
        t = op.type
        out = _first(op.outputs.get("Out", []))
        if not out:
            continue
        if t == "lookup_table":
            act[out] = "embed"
        elif t in ("mul", "matmul", "matmul_v2"):
            y = _first(op.inputs.get("Y", []))
            if _is_param(block, y) and y in logical_axes:
                laxes = logical_axes[y]
                act[out] = laxes[0] if op.attrs.get("transpose_Y") \
                    else laxes[-1]
            else:
                act[out] = None
        elif t in _PROPAGATE or t in ("reshape", "reshape2"):
            act[out] = act.get(_first(op.inputs.get("X", [])))
    return act


# ---------------------------------------------------------------------------
# planner-driven table selection
# ---------------------------------------------------------------------------

def _est_comm_ms(program, table: LogicalAxisRules, logical_axes,
                 axis_sizes, batch_size: int) -> float:
    """Analytic per-step GSPMD collective traffic for one rule table —
    the comms plane's ring model applied to the collectives the SPMD lowering
    will insert: a row-parallel (contracting-dim-sharded) matmul
    all-reduces its output partials in forward AND its input grads in
    backward; a column-parallel one all-reduces dX in backward only; a
    vocab-sharded table gathers its lookups.  Coarse by design (the
    planner only needs a consistent ranking), priced at the link peak
    like ``analysis.comms``."""
    from ..analysis.comms import device_link_bandwidth
    block = program.global_block()
    mp = axis_sizes.get("mp", 1)
    if mp <= 1:
        return 0.0
    ring = 2.0 * (mp - 1) / mp
    bw = device_link_bandwidth()
    total = 0.0
    for name, laxes in logical_axes.items():
        if not block.has_var(name):
            continue
        shape = tuple(block.var(name).shape or ())
        if len(shape) != len(laxes) or len(shape) != 2:
            continue
        spec = _spec_for(shape, laxes, table, axis_sizes)
        if spec is None:
            continue
        d_in, d_out = shape
        if laxes == ("vocab", "embed"):
            # sharded embedding: gather fwd + scatter-add bwd of
            # [batch, embed] activations
            total += 2 * batch_size * d_out * 4
            continue
        if spec[0] == "mp":
            total += 2 * batch_size * d_out * 4     # partial-sum psum ×2
        if spec[1] == "mp":
            total += batch_size * d_in * 4          # bwd dX allreduce
    return total * ring / bw * 1e3


def choose_rules(program, axis_sizes: Dict[str, int], fetch_names=(),
                 batch_size: int = 1, candidates=None,
                 budget_mb: Optional[float] = None):
    """Planner-driven rule-table selection (module docstring §3).

    Evaluates every candidate's PER-SHARD static peak
    (``analysis.memory.plan_sharded_memory``) and picks the FIRST —
    i.e. cheapest-communication — table fitting the budget
    (``FLAGS_memory_budget_mb`` unless overridden); among candidates the
    walk cannot separate, the analytic comm-vs-compute verdict ranks
    (compute-bound beats comm-bound, then lower est ms).  With no
    budget, the least-communication table wins outright.  Returns
    ``(LogicalAxisRules, report)`` where ``report`` is the per-candidate
    evaluation (stamped into the partition attrs by
    :func:`partition_program` so the choice is auditable)."""
    from ..analysis.cost import device_peak_flops, plan_cost
    from ..analysis.memory import plan_sharded_memory
    from ..flags import get_flags

    if budget_mb is None:
        budget_mb = float(
            get_flags("FLAGS_memory_budget_mb")["FLAGS_memory_budget_mb"])
    budget = float(budget_mb) * (1 << 20) if budget_mb else None
    cands = [rule_table(c) for c in
             (candidates if candidates is not None else
              DEFAULT_RULE_TABLES)]
    logical = infer_logical_axes(program)
    act_axis = _activation_axes(program, logical)
    block = program.global_block()
    try:
        compute_ms = plan_cost(program, fetch_names,
                               batch_size=batch_size).flops \
            / device_peak_flops() * 1e3
    except Exception:
        compute_ms = 0.0

    report: List[dict] = []
    for table in cands:
        specs: Dict[str, tuple] = {}
        for name, laxes in logical.items():
            if not block.has_var(name):
                continue
            shape = tuple(block.var(name).shape or ())
            if len(shape) != len(laxes):
                continue
            spec = _spec_for(shape, laxes, table, axis_sizes)
            if spec is not None:
                specs[name] = spec
        dp = "dp" if axis_sizes.get("dp", 0) > 1 else None
        for name, last_ax in act_axis.items():
            if name in specs or not block.has_var(name):
                continue
            v = block.var(name)
            shape = v.shape
            if v.persistable or shape is None or len(shape) < 2:
                continue
            last = table.mesh_axis(last_ax)
            lsize = axis_sizes.get(last, 0) if last else 0
            spec = [dp] + [None] * (len(shape) - 1)
            if last and lsize > 1 and isinstance(shape[-1], int) \
                    and shape[-1] > 0 and shape[-1] % lsize == 0:
                spec[-1] = last
            if any(spec):
                specs[name] = tuple(spec)
        plan = plan_sharded_memory(program, fetch_names,
                                   batch_size=batch_size, specs=specs,
                                   axis_sizes=axis_sizes)
        # price the candidate on its REAL per-edge reshard plan
        # (analysis.sharding: every implicit collective the SPMD
        # lowering will insert, ring-priced); the coarse matmul
        # heuristic stays as the fallback when the pass cannot plan
        resh = None
        try:
            from ..analysis.sharding import plan_sharding
            resh = plan_sharding(program, fetch_names,
                                 batch_size=batch_size, specs=specs,
                                 axis_sizes=axis_sizes,
                                 rules=table.name)
        except Exception:
            resh = None
        if resh is not None:
            comm_ms = resh.est_ms
        else:
            comm_ms = _est_comm_ms(program, table, logical, axis_sizes,
                                   batch_size)
        report.append({
            "rules": table.name,
            "per_shard_peak_bytes": int(plan.peak_bytes),
            "per_shard_steady_bytes": int(plan.steady_bytes),
            "fits": bool(budget is None or plan.peak_bytes <= budget),
            "est_comm_ms": round(comm_ms, 4),
            "est_compute_ms": round(compute_ms, 4),
            "bound": "comm" if comm_ms > compute_ms else "compute",
            "sharded_params": len(specs),
            "reshard_edges": None if resh is None else len(resh.edges),
            "reshard_bytes": None if resh is None
            else int(resh.payload_bytes),
            "reshard_wire_bytes": None if resh is None
            else int(resh.wire_bytes),
            "reshard_fingerprint": None if resh is None
            else resh.fingerprint,
        })

    if budget is None:
        chosen, outcome = 0, "no_budget"
    else:
        fits = [i for i, r in enumerate(report) if r["fits"]]
        if fits:
            outcome = "fit"
            # candidate order is cheapest-comm-first; the verdict ranks
            # the survivors so a compute-bound table beats a comm-bound
            # one even when the walk order says otherwise
            chosen = min(fits, key=lambda i: (
                report[i]["bound"] == "comm",
                report[i]["est_comm_ms"], i))
        else:
            # nothing fits: take the smallest per-shard peak — training
            # may still OOM, but this is the best static answer, and the
            # report says so
            chosen = min(range(len(report)),
                         key=lambda i: report[i]["per_shard_peak_bytes"])
            outcome = "fallback"
    for i, r in enumerate(report):
        r["chosen"] = (i == chosen)
    _CHOICE_CTR.inc(1, rules=cands[chosen].name, outcome=outcome)
    _SHARD_PEAK_GAUGE.set(float(report[chosen]["per_shard_peak_bytes"]))
    if _monitor.TRACER.enabled:
        _monitor.TRACER.instant(
            "gspmd.choose_rules", "compile",
            {"outcome": outcome, "report": report,
             "budget_mb": budget_mb})
    return cands[chosen], report


def partition_program(program, axis_sizes: Dict[str, int], rules="auto",
                      fetch_names=(), batch_size: int = 1,
                      budget_mb: Optional[float] = None) -> dict:
    """One-call entry: select (``rules="auto"``) or resolve a rule
    table, apply it to ``program`` and return the partition stamp (with
    the planner report attached under ``"planner"`` when auto)."""
    logical = infer_logical_axes(program)
    if rules == "auto":
        table, rep = choose_rules(program, axis_sizes,
                                  fetch_names=fetch_names,
                                  batch_size=batch_size,
                                  budget_mb=budget_mb)
    else:
        table, rep = rule_table(rules), None
    stamp = apply_rules(program, table, axis_sizes, logical_axes=logical)
    if rep is not None:
        stamp["planner"] = rep
    return stamp


def partition_fingerprint(stamp: Optional[dict]) -> Optional[str]:
    """Deterministic token of one partition stamp: mesh shape + sorted
    per-param PartitionSpecs, suffixed ``#rules=<table>`` so a cross-rank
    refusal NAMES both rule tables (the coordinator's mismatch detail
    prints both fingerprints verbatim)."""
    if not stamp:
        return None
    body = repr((sorted((stamp.get("mesh_axes") or {}).items()),
                 sorted((stamp.get("params") or {}).items()),
                 int(stamp.get("zero_stage") or 0)))
    return (hashlib.sha1(body.encode()).hexdigest()
            + f"#rules={stamp.get('rules')}")
