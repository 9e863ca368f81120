"""Program verifier: static checks over the ``framework.ir`` Graph (the
port's ``paddle_tpu/analysis/verifier.py``).

``CompiledProgram._optimized`` runs it before any pass (``FLAGS_program_
verify``), and the fusion pass runs it before and after its rewrite.  The
checks, with the reference's names, severities and messages:

==================  =========  ==============================================
check               severity   flags
==================  =========  ==============================================
def_before_use      error      op input var not declared in the block
uninitialized_read  warning    declared non-persistable, non-data var read
                               before any op writes it
dangling_fetch      error      fetch target never produced
dangling_feed       warning    declared data var consumed by no op
shape_consistency   warning    a var's recorded shape/dtype disagrees with
                               re-running shape inference over the block
dead_op             warning    op unreachable from the fetch + persistable
                               + side-effect liveness roots
use_after_donate    warning    fetch target is a read-write persistable
int64_feed          (none)     classification: int64 feeds whose consumers
                               do not bound their values
collective_order    error/     collective ops not totally ordered by data
                    warning    dependencies (error when an unordered pair
                               has the same signature)
memory_budget       warning    the batch-1 static peak-memory plan exceeds
                               FLAGS_memory_budget_mb
==================  =========  ==============================================

Results are cached on (program fingerprint, fetch tuple), so a program is
verified once per mutation, and stamp ``program._attrs["verify"]``: the
int64 feed classification, the collective fingerprint (the dependency-
ordered collective sequence and the fetch list, hashed) and the analytic
cost plan (``analysis.cost``) and the static memory plan
(``analysis.memory``, batch 1), whose peak past ``FLAGS_memory_budget_mb``
is a ``memory_budget`` warning.  Not ported yet: the comms and sharding
plans (``verifier.py:810, 830``) and the sharding checks, which need planes
the port lacks; their stamps are ``None``.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

from .. import monitor as _monitor
from ..framework.core import Block, Program

__all__ = [
    "CHECKS", "Diagnostic", "ProgramVerificationError", "VerifyResult",
    "clear_cache", "collective_fingerprint", "verify_or_raise",
    "verify_program",
]

#: every check the port runs, in report order (one counter series each)
CHECKS = (
    "def_before_use", "uninitialized_read", "dangling_fetch",
    "dangling_feed", "shape_consistency", "dead_op", "use_after_donate",
    "int64_feed", "collective_order", "memory_budget",
)

_FINDINGS = _monitor.REGISTRY.counter(
    "paddle_tpu_verifier_findings_total",
    "program-verifier findings by check", ("check",))
_FINDING_CELLS = {c: _FINDINGS.labels(check=c) for c in CHECKS}
_RUNS = _monitor.REGISTRY.counter(
    "paddle_tpu_verifier_runs_total",
    "verify_program calls by fingerprint-cache outcome", ("cache",))
_RUNS_HIT = _RUNS.labels(cache="hit")
_RUNS_MISS = _RUNS.labels(cache="miss")

#: an int64 feed is static-safe when every consumer bounds its valid values
#: below this (every valid index then fits int32)
_INT32_BOUND = 2 ** 31

#: collective ops whose cross-rank launch order must match on every rank
_COLLECTIVE_OPS = frozenset({
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_broadcast", "c_allgather", "c_reducescatter",
    "c_split",
})


class ProgramVerificationError(RuntimeError):
    """Raised by :func:`verify_or_raise` when an error-severity diagnostic
    is present; ``.result`` carries the full :class:`VerifyResult`."""

    def __init__(self, msg: str, result: "VerifyResult"):
        super().__init__(msg)
        self.result = result


@dataclass(frozen=True)
class Diagnostic:
    """One finding: which check, how bad, where, and what to do about it."""

    check: str                 # one of CHECKS (or fusion_reject)
    severity: str              # "error" | "warning"
    message: str
    op_type: Optional[str] = None
    op_index: Optional[int] = None   # program-order index in its block
    var: Optional[str] = None
    fix_hint: Optional[str] = None
    #: block path of a sub-block finding ("0/while@5/1"); None is block 0
    block: Optional[str] = None


@dataclass
class VerifyResult:
    diagnostics: List[Diagnostic] = field(default_factory=list)
    #: int64/uint64 data feeds that still need a runtime range check
    int64_dynamic: FrozenSet[str] = frozenset()
    #: int64/uint64 data feeds proven bounded by every consumer
    int64_static: FrozenSet[str] = frozenset()
    #: sha1 over the dependency-ordered, block-path-stamped collective
    #: sequence and the fetch list (None when no block has a collective)
    collective_fingerprint: Optional[str] = None
    dead_ops: Tuple[int, ...] = ()   # block-0 indices of dead ops
    #: {sub-block idx: (op indices...)} of dead body compute
    dead_subblock_ops: Dict[int, tuple] = field(default_factory=dict)
    #: static memory plan (analysis.memory.MemoryPlan; None if planning
    #: failed — a plan never blocks verification)
    memory_plan: Optional[object] = None
    #: analytic flops/bytes plan (analysis.cost.CostPlan; None if planning
    #: failed)
    cost_plan: Optional[object] = None

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def by_check(self, check: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.check == check]


#: (program fingerprint, fetch tuple) -> VerifyResult, a bounded FIFO: every
#: mutation mints a new fingerprint
_CACHE: Dict[tuple, VerifyResult] = {}  # guarded-by: _CACHE_LOCK
_CACHE_CAP = 256
_CACHE_LOCK = threading.Lock()


def clear_cache() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _is_data(v) -> bool:
    return bool(getattr(v, "is_data", False))


def sub_blocks_of(op) -> List[Tuple[str, Block]]:
    """The Block-valued attrs of one op, sorted by attr name."""
    return sorted(((k, v) for k, v in op.attrs.items()
                   if isinstance(v, Block)), key=lambda kv: kv[0])


def _check_def_before_use(program: Program, diags: List[Diagnostic]):
    """Program-order def-before-use over block 0, then every sub-block in
    its enclosing scope (``verifier.py:233``).  A body read of a var the
    body writes later is loop-carried, not an uninitialized read."""

    def walk(block: Block, written: set, path: str):
        local = set(written)
        body_writes = {n for op in block.ops
                       for n in op.output_arg_names() if n}
        for idx, op in enumerate(block.ops):
            if op.type not in ("feed", "fetch"):
                for slot, names in op.inputs.items():
                    # an output gradient may legally be absent
                    if slot.startswith("OG$"):
                        continue
                    for name in names:
                        if not name or name in local:
                            continue
                        if not block.has_var(name):
                            diags.append(Diagnostic(
                                "def_before_use", "error",
                                f"op input var {name!r} is not declared "
                                "in the block (or an enclosing block) "
                                "and no preceding op produces it",
                                op_type=op.type, op_index=idx, var=name,
                                block=path,
                                fix_hint="declare the var "
                                         "(block.create_var / "
                                         "layers.data) or fix the "
                                         "producing op's output name"))
                            continue
                        v = block.var(name)
                        if v.persistable or _is_data(v) or \
                                v.initializer is not None:
                            continue
                        if block.idx != 0 and name in body_writes:
                            continue       # loop-carried body write
                        diags.append(Diagnostic(
                            "uninitialized_read", "warning",
                            f"var {name!r} is read before any op writes "
                            "it and is neither persistable nor a "
                            "declared data var — it must be fed (or "
                            "pre-seeded in the scope) at every run",
                            op_type=op.type, op_index=idx, var=name,
                            block=path,
                            fix_hint="declare it via layers.data if it "
                                     "is fed, or mark it persistable if "
                                     "it lives in the scope"))
            for _, sub in sub_blocks_of(op):
                walk(sub, local, f"{path}/{op.type}@{idx}/{sub.idx}")
            for name in op.output_arg_names():
                if name:
                    local.add(name)

    walk(program.global_block(), set(), "0")


def _check_feed_fetch(program: Program, fetch_names, diags):
    """Dangling fetches and feeds (``verifier.py:305``)."""
    block = program.global_block()
    written = {n for op in block.ops
               for n in op.output_arg_names() if n}
    for name in fetch_names:
        if name in written:
            continue
        if not block.has_var(name):
            diags.append(Diagnostic(
                "dangling_fetch", "error",
                f"fetch target {name!r} is not a var of the program",
                var=name,
                fix_hint="fetch an existing var (typo?) or rebuild the "
                         "program that defines it"))
        elif not block.var(name).persistable and \
                not _is_data(block.var(name)):
            diags.append(Diagnostic(
                "dangling_fetch", "error",
                f"fetch target {name!r} is declared but no op produces it "
                "and it is not persistable — materialization would fail "
                "at dispatch",
                var=name,
                fix_hint="fetch the op output you meant, or mark the var "
                         "persistable if its value lives in the scope"))
    consumed = {n for b in program.blocks for op in b.ops
                for n in op.input_arg_names() if n}
    for name, v in block.vars.items():
        if _is_data(v) and name not in consumed and name not in fetch_names:
            diags.append(Diagnostic(
                "dangling_feed", "warning",
                f"data var {name!r} is consumed by no op in any block — "
                "its fed value is dropped every step",
                var=name,
                fix_hint="remove the layers.data declaration (and the "
                         "feed) or wire it into the model"))


def _check_shape_consistency(program: Program, diags):
    """Re-run shape inference over a clone of block 0 and compare the
    recorded shapes and dtypes (``verifier.py:346``); only concrete dims
    are compared."""
    from ..framework import registry
    try:
        clone = program.clone()
    except Exception:
        return
    src = program.global_block()
    blk = clone.global_block()
    for idx, op in enumerate(blk.ops):
        if op.type in ("feed", "fetch"):
            continue
        try:
            registry.infer_op(op, blk)
        except Exception:
            continue             # not re-inferable out of build context
        for name in op.output_arg_names():
            if not name or name not in blk.vars or name not in src.vars:
                continue
            iv, sv = blk.vars[name], src.vars[name]
            ishape, sshape = iv.shape, sv.shape
            if ishape is not None and sshape is not None:
                if len(ishape) != len(sshape) or any(
                        a != b for a, b in zip(ishape, sshape)
                        if a not in (-1, None) and b not in (-1, None)):
                    diags.append(Diagnostic(
                        "shape_consistency", "warning",
                        f"var {name!r} records shape {list(sshape)} but "
                        f"inference over op {op.type!r} derives "
                        f"{list(ishape)}",
                        op_type=op.type, op_index=idx, var=name,
                        fix_hint="the shape was mutated after build; "
                                 "rebuild the op (append_op re-infers) "
                                 "instead of patching Variable.shape"))
            if iv.dtype and sv.dtype and iv.dtype != sv.dtype:
                diags.append(Diagnostic(
                    "shape_consistency", "warning",
                    f"var {name!r} records dtype {sv.dtype!r} but "
                    f"inference over op {op.type!r} derives {iv.dtype!r}",
                    op_type=op.type, op_index=idx, var=name,
                    fix_hint="rebuild the op instead of patching "
                             "Variable.dtype"))


def _check_dead_ops(graph, fetch_names, diags):
    """Dead forward compute in block 0 and in sub-blocks
    (``verifier.py:394``); framework-made backward leftovers are removed by
    ``dead_op_eliminate`` but not reported."""
    from ..framework import ir
    dead = ir.dead_op_analysis(graph, protected=frozenset(fetch_names))
    dead_ids = {n.id for n in dead}
    indices = tuple(i for i, n in enumerate(graph.op_nodes)
                    if n.id in dead_ids)
    for i in indices:
        op = graph.op_nodes[i]
        if op.name.endswith("_grad") or \
                op.op.attrs.get("op_role") == "backward":
            continue
        diags.append(Diagnostic(
            "dead_op", "warning",
            f"op {op.name!r} reaches no fetch target, persistable write, "
            "or side-effecting op — its outputs are computed and dropped",
            op_type=op.name, op_index=i,
            fix_hint="fetch its output if you need it; the "
                     "dead_op_eliminate pass removes it otherwise"))
    sub_dead = ir.dead_subblock_op_analysis(
        graph.program, protected=frozenset(fetch_names))
    for blk_idx, sub_indices in sub_dead.items():
        block = graph.program.blocks[blk_idx]
        for i in sub_indices:
            op = block.ops[i]
            if op.type.endswith("_grad") or \
                    op.attrs.get("op_role") == "backward":
                continue
            diags.append(Diagnostic(
                "dead_op", "warning",
                f"op {op.type!r} inside sub-block {blk_idx} reaches no "
                "loop-carried var, fetch target, persistable write, or "
                "side-effecting op — it recomputes a dropped value EVERY "
                "iteration",
                op_type=op.type, op_index=i, block=str(blk_idx),
                fix_hint="carry or fetch its output if you need it; the "
                         "dead_op_eliminate pass prunes it otherwise"))
    return indices, sub_dead


def _check_use_after_donate(program: Program, fetch_names, diags):
    """A fetched read-write persistable (``verifier.py:452``)."""
    block = program.global_block()
    written = {n for b in program.blocks for op in b.ops
               for n in op.output_arg_names() if n}
    rw = {n for n in written
          if block.has_var(n) and block.var(n).persistable}
    for name in fetch_names:
        if name in rw:
            diags.append(Diagnostic(
                "use_after_donate", "warning",
                f"fetch target {name!r} is a read-write persistable: the "
                "executor donates rw buffers to the next step, so every "
                "step must defensively copy this fetch out of the donated "
                "buffer",
                var=name,
                fix_hint="fetch a non-persistable snapshot (e.g. "
                         "layers.assign the value) or read it from the "
                         "scope at a step boundary instead"))


#: value-preserving ops the int64 classification propagates through
_INT64_PASS_OPS = frozenset({
    "reshape", "reshape2", "squeeze", "squeeze2", "unsqueeze",
    "unsqueeze2", "flatten", "flatten2", "slice", "strided_slice",
    "split", "concat", "assign", "transpose", "transpose2",
})


def _classify_int64_feeds(program: Program, fetch_names=()):
    """(static, dynamic) int64/uint64 data feeds (``verifier.py:481``): a
    feed is static when every consumer it reaches through value-preserving
    ops bounds its valid values below 2**31 (an embedding's row count, a
    gather's indexed dim, one_hot's depth) and no alias of it is fetched."""
    block = program.global_block()
    feeds = [v for v in block.vars.values()
             if _is_data(v) and v.dtype in ("int64", "uint64")]
    if not feeds:
        return frozenset(), frozenset()

    def _dim_bounded(name, blk, axis=None):
        shape = blk.var(name).shape if blk.has_var(name) else None
        if not shape:
            return False
        if axis is None:
            dims = shape
        else:
            if not -len(shape) <= axis < len(shape):
                return False
            axis = axis % len(shape)
            dims = shape[axis:axis + 1]
        return bool(dims) and all(
            d is not None and 0 < d < _INT32_BOUND for d in dims)

    def consumer_verdict(op, blk, name) -> str:
        """'safe' (bounded index consumer), 'pass' (value-preserving: judge
        its outputs' consumers), 'ignore' (neither) or 'unsafe'."""
        typ = op.type
        is_grad = typ.endswith("_grad")
        if is_grad:
            # a grad op re-reads the forward's inputs under X$<slot>
            typ = typ[: -len("_grad")]

            def slot(s, _op=op):
                return _op.input("X$" + s) or _op.input(s)
        else:
            def slot(s, _op=op):
                return _op.input(s)
        if typ in ("lookup_table", "lookup_table_v2",
                   "fused_embedding_layer_norm") and name in slot("Ids"):
            w = slot("W")
            return "safe" if w and _dim_bounded(w[0], blk, axis=0) \
                else "unsafe"
        if typ in ("one_hot", "one_hot_v2") and name in slot("X"):
            depth = op.attrs.get("depth")
            return "safe" if depth and int(depth) < _INT32_BOUND \
                else "unsafe"
        if typ == "gather" and name in slot("Index"):
            x = slot("X")
            axis = int(op.attrs.get("axis", 0))
            return "safe" if x and _dim_bounded(x[0], blk, axis=axis) \
                else "unsafe"
        if typ == "gather_nd" and name in slot("Index"):
            x = slot("X")
            return "safe" if x and _dim_bounded(x[0], blk) else "unsafe"
        if typ == "scatter" and name in slot("Ids"):
            x = slot("X")
            return "safe" if x and _dim_bounded(x[0], blk, axis=0) \
                else "unsafe"
        if typ == "scatter_nd_add" and name in slot("Index"):
            x = slot("X")
            return "safe" if x and _dim_bounded(x[0], blk) else "unsafe"
        if typ == "cast" and name in slot("X"):
            outs = op.output_arg_names()
            out_dt = (blk.var(outs[0]).dtype
                      if outs and outs[0] and blk.has_var(outs[0])
                      else None)
            if not (out_dt and "int" in str(out_dt)):
                return "unsafe"
            return "ignore" if is_grad else "pass"
        if typ in _INT64_PASS_OPS:
            return "ignore" if is_grad else "pass"
        return "unsafe"

    consumers: Dict[str, list] = {}
    for b in program.blocks:
        for op in b.ops:
            if op.type in ("feed", "fetch"):
                continue
            for name in op.input_arg_names():
                if name:
                    consumers.setdefault(name, []).append((op, b))
    fetched = frozenset(fetch_names)

    def feed_static(feed_name: str) -> bool:
        seen = {feed_name}
        frontier = [feed_name]
        any_bounded = False
        while frontier:
            name = frontier.pop()
            if name in fetched:
                return False
            for op, blk in consumers.get(name, ()):
                verdict = consumer_verdict(op, blk, name)
                if verdict == "unsafe":
                    return False
                if verdict == "safe":
                    any_bounded = True
                if verdict == "pass":
                    for out in op.output_arg_names():
                        if out and out not in seen:
                            seen.add(out)
                            frontier.append(out)
        return any_bounded

    static, dynamic = set(), set()
    for v in feeds:
        (static if feed_static(v.name) else dynamic).add(v.name)
    return frozenset(static), frozenset(dynamic)


def _collective_signature(op_node, block: Block):
    op = op_node.op
    x = op.input("X")
    shape = dtype = None
    if x and block.has_var(x[0]):
        v = block.var(x[0])
        shape, dtype = v.shape, v.dtype
    return (op.type, op.attrs.get("ring_id", 0), dtype,
            tuple(shape) if shape else None)


def _check_collective_order(program: Program, graph, fetch_names, diags):
    """Dependency-order the collective ops of every block
    (``verifier.py:665``): an unordered pair with the same signature is an
    error (ranks can mispair them), any other unordered pair a warning.
    Returns the fingerprint of the ordered collective sequence and the
    fetch list, or None when the program has no collective."""
    from ..framework import ir
    entries: List[tuple] = []   # (block path, signature), execution order

    def gather(block_graph, path: str):
        block = program.blocks[block_graph.block_idx]
        nodes = [n for n in block_graph.op_nodes
                 if n.name in _COLLECTIVE_OPS]
        if nodes:
            reach: Dict[int, set] = {}
            for n in nodes:
                seen = set()
                stack = [n]
                while stack:
                    cur = stack.pop()
                    for v in cur.outputs:
                        for consumer in v.outputs:
                            if consumer.id not in seen:
                                seen.add(consumer.id)
                                stack.append(consumer)
                reach[n.id] = seen
            unordered, ambiguous = [], []
            for i in range(len(nodes)):
                for j in range(i + 1, len(nodes)):
                    a, b = nodes[i], nodes[j]
                    if b.id in reach[a.id] or a.id in reach[b.id]:
                        continue
                    sig_a = _collective_signature(a, block)
                    sig_b = _collective_signature(b, block)
                    (ambiguous if sig_a == sig_b else unordered).append(
                        (a.name, b.name, sig_a))
            where = "" if path == "0" else f" in sub-block {path!r}"
            if ambiguous:
                a, b, sig = ambiguous[0]
                diags.append(Diagnostic(
                    "collective_order", "error",
                    f"{len(ambiguous)} pair(s) of collective ops share "
                    f"a signature {sig!r} but have no dependency path "
                    f"between them{where} (first pair: {a!r}/{b!r}) — "
                    "ranks can launch them in different orders and "
                    "mispair, deadlocking the gang",
                    op_type=a, block=path,
                    fix_hint="chain them (feed one's output into the "
                             "other's input chain) or give each a "
                             "distinct ring_id"))
            elif unordered:
                diags.append(Diagnostic(
                    "collective_order", "warning",
                    f"{len(unordered)} pair(s) of collective ops have "
                    f"no dependency path between them{where}; their "
                    "launch order is compiler-chosen — verify the "
                    "collective fingerprint matches across ranks before "
                    "entering the gang",
                    op_type=unordered[0][0], block=path,
                    fix_hint="compare program._attrs['verify']"
                             "['collective_fingerprint'] across ranks"))
        order = {n.id: i for i, n in enumerate(
            block_graph.topology_sort())}
        pos = {id(op): i for i, op in enumerate(block.ops)}
        for n in sorted(block_graph.op_nodes,
                        key=lambda n: (order.get(n.id, 0), n.id)):
            if n.name in _COLLECTIVE_OPS:
                entries.append((path, _collective_signature(n, block)))
            subs = sub_blocks_of(n.op)
            if subs:
                idx = pos.get(id(n.op), order.get(n.id, 0))
                for _, sub in subs:
                    gather(ir.Graph(program, sub.idx),
                           f"{path}/{n.name}@{idx}/{sub.idx}")

    gather(graph, "0")
    if not entries and not program._attrs.get("collective"):
        return None
    h = hashlib.sha1()
    for path, sig in entries:
        h.update(repr((path, sig)).encode())
    h.update(repr(tuple(fetch_names)).encode())
    return h.hexdigest()


def _check_memory(program: Program, fetch_names, diags):
    """The static memory plan at batch 1 (``verifier.py:766-795``), a
    per-example lower bound cached on the fingerprint; a
    ``memory_budget`` warning when ``FLAGS_memory_budget_mb`` is set and
    even that bound exceeds it.  A planning failure never blocks
    verification."""
    from . import memory as _memory
    try:
        plan = _memory.plan_memory(program, fetch_names, batch_size=1)
    except Exception:
        return None
    from ..flags import get_flags
    budget_mb = int(get_flags("FLAGS_memory_budget_mb")
                    ["FLAGS_memory_budget_mb"])
    if budget_mb > 0 and plan.peak_bytes > budget_mb << 20:
        top = ", ".join(f"{t} #{p}" for p, t, _, _ in plan.top_ops(3))
        diags.append(Diagnostic(
            "memory_budget", "warning",
            f"static peak-memory estimate {plan.peak_bytes >> 20} MiB "
            f"(batch=1 lower bound) exceeds FLAGS_memory_budget_mb="
            f"{budget_mb}; heaviest ops: {top}",
            op_type=plan.peak_op, op_index=plan.peak_pos,
            fix_hint="shrink the model/batch, enable sharding, or raise "
                     "the budget; see analysis.memory.plan_memory("
                     "...).report() for the full attribution table"))
    return plan


def _check_cost(program: Program, fetch_names):
    """The analytic flops/bytes plan at batch 1 (``verifier.py:797``);
    informational, and a planning failure never blocks verification."""
    from . import cost as _cost
    try:
        return _cost.plan_cost(program, fetch_names, batch_size=1)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _verify_cached(program: Program, fetch_names) -> \
        Tuple[VerifyResult, bool]:
    """(result, fresh): ``fresh`` is True for exactly one caller per cache
    key, so warnings are emitted once."""
    from ..framework import ir
    fetch_names = tuple(
        f.name if hasattr(f, "name") else f for f in (fetch_names or ()))
    # the fetch order is part of the collective fingerprint
    key = (program.fingerprint(), fetch_names)
    with _CACHE_LOCK:
        cached = _CACHE.get(key)
    if cached is not None:
        _RUNS_HIT.inc()
        return cached, False
    _RUNS_MISS.inc()
    result = VerifyResult()
    diags = result.diagnostics
    graph = ir.Graph(program)
    _check_def_before_use(program, diags)
    _check_feed_fetch(program, fetch_names, diags)
    try:
        _check_shape_consistency(program, diags)
    except Exception:            # re-inference must never block verify
        pass
    result.dead_ops, result.dead_subblock_ops = \
        _check_dead_ops(graph, fetch_names, diags)
    _check_use_after_donate(program, fetch_names, diags)
    result.int64_static, result.int64_dynamic = \
        _classify_int64_feeds(program, fetch_names)
    result.collective_fingerprint = _check_collective_order(
        program, graph, fetch_names, diags)
    result.memory_plan = _check_memory(program, fetch_names, diags)
    result.cost_plan = _check_cost(program, fetch_names)
    for d in diags:
        _FINDING_CELLS[d.check].inc()
    if result.int64_dynamic:
        _FINDING_CELLS["int64_feed"].inc(len(result.int64_dynamic))
    plan = result.cost_plan
    mem = result.memory_plan
    program._attrs["verify"] = {
        "int64_dynamic": sorted(result.int64_dynamic),
        "int64_static": sorted(result.int64_static),
        "collective_fingerprint": result.collective_fingerprint,
        "memory": None if mem is None else {
            "peak_bytes": mem.peak_bytes,
            "resident_bytes": mem.resident_bytes,
            "steady_bytes": mem.steady_bytes,
            "peak_op": mem.peak_op,
            "top_ops": [(p, t, b) for p, t, b, _ in mem.top_ops(5)],
        },
        "cost": None if plan is None else {
            "flops": plan.flops, "bytes": plan.bytes,
            "per_class": dict(plan.per_class),
            "intensity": plan.intensity(),
        },
        "comms": None,
        "sharding": None,
    }
    with _CACHE_LOCK:
        fresh = key not in _CACHE
        if fresh:
            if len(_CACHE) >= _CACHE_CAP:
                _CACHE.pop(next(iter(_CACHE)))
            _CACHE[key] = result
        result = _CACHE[key]   # concurrent misses converge on one object
    return result, fresh


def verify_program(program: Program, fetch_names=()) -> VerifyResult:
    """Run every check; cached on (program fingerprint, fetch tuple).  Also
    stamps ``program._attrs["verify"]``, which ``Program.clone`` carries."""
    return _verify_cached(program, fetch_names)[0]


def verify_or_raise(program: Program, fetch_names=()) -> VerifyResult:
    """``verify_program``, then error findings raise
    :class:`ProgramVerificationError` with the formatted report, and
    warnings are emitted once per fresh verification."""
    result, fresh = _verify_cached(program, fetch_names)
    from .. import debugger
    if not result.ok:
        raise ProgramVerificationError(
            "program verification failed:\n"
            + debugger.format_diagnostics(result.diagnostics), result)
    if fresh and result.warnings():
        import warnings
        warnings.warn(
            "program verifier warnings:\n"
            + debugger.format_diagnostics(result.warnings()),
            stacklevel=2)
    return result


def collective_fingerprint(program: Program) -> Optional[str]:
    """The stamped collective fingerprint, verifying if need be."""
    va = program._attrs.get("verify")
    if va is not None and va.get("collective_fingerprint"):
        return va["collective_fingerprint"]
    return verify_program(program).collective_fingerprint
