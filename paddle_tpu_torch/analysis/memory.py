"""Static peak-memory planner: interval liveness over the dependency-
ordered ``framework.ir`` Graph (the port of ``paddle_tpu/analysis/
memory.py``, computing exactly what the reference computes).

MLSys compilers derive memory plans from liveness over the dependency
graph (TVM's static memory planning, arxiv 1802.04799).  The plan models
the reference's lowered step:

- **persistables** (params, optimizer state, BN stats) are resident for
  the whole step; read-write persistables count ONCE (the reference
  donates their buffers; the port's optimizer lowerings write new tensors
  that replace the old ones in the scope at the step's end, which the plan
  does not model: see ``hbm.py``'s drift gauge);
- **feeds** are resident from step start to step end;
- **fetches** pin their buffer from the producing op to end-of-step; a
  fetched rw persistable costs one defensive copy;
- **temporaries** live from their producing op to their last consumer in
  dependency order (the executor frees each after its last reader);
  inplace-pair outputs (``buffer_shared_inplace_pass``) alias their input's
  buffer and cost nothing while extending it;
- **sub-blocks** (while/cond bodies) add their own local-temporary peak
  while the enclosing op runs.

Symbolic (-1/None) dims resolve through ``batch_size`` (default 1, the
verifier's per-example lower bound).  Plans are cached on the program
fingerprint, the verifier's key, so steady-state dispatch never re-plans.
The eager executor also holds each differentiated forward's autograd graph
from the forward op to its grad op, which the plan does not count: the
card's measured peak is above the plan by that much (PERF.md).
``plan_sharded_memory`` is the per-shard plan the GSPMD rule-table planner
prices each candidate table with.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from .. import monitor as _monitor
from ..framework.core import Block, Program

__all__ = ["MemoryPlan", "clear_cache", "plan_memory",
           "plan_sharded_memory"]

#: dtype -> bytes per element (numpy lacks bfloat16)
_ITEMSIZE = {"bfloat16": 2, "float16": 2, "bool": 1}

_PEAK_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_static_hbm_peak_bytes",
    "static memory planner: estimated peak HBM bytes of the most "
    "recently planned program")
_PLAN_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_memory_plans_total",
    "plan_memory calls by fingerprint-cache outcome", ("cache",))
_PLAN_HIT = _PLAN_CTR.labels(cache="hit")
_PLAN_MISS = _PLAN_CTR.labels(cache="miss")


def _itemsize(dtype) -> int:
    d = str(dtype or "float32")
    if d in _ITEMSIZE:
        return _ITEMSIZE[d]
    try:
        return int(np.dtype(d).itemsize)
    except TypeError:
        return 4


def _var_bytes(var, batch_size: int) -> int:
    """Static byte size of one var; symbolic dims (-1/None) resolve to
    ``batch_size``.  Shapeless vars count 0 (scalars count their dtype
    width via the empty product)."""
    if var is None or var.shape is None:
        return 0
    n = 1
    for d in var.shape:
        n *= batch_size if d in (-1, None) else int(d)
    return max(n, 1) * _itemsize(var.dtype)


def _fmt(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} TiB"


@dataclass
class MemoryPlan:
    """Static per-step memory model of one program."""

    #: estimated peak bytes across the dependency-ordered step,
    #: including transient temporaries
    peak_bytes: int = 0
    #: dependency-order position of the peak (len(ops) = end of step)
    peak_pos: int = 0
    #: op type at the peak position ("<end-of-step>" past the last op)
    peak_op: str = "<end-of-step>"
    #: bytes resident across the WHOLE step: persistables (rw counted
    #: once — donated) + staged feeds
    resident_bytes: int = 0
    #: bytes still live at the step boundary: resident + fetch buffers
    #: (+ donation-aliasing fetch copies) — what ``memory.live_bytes``
    #: measures between steps
    steady_bytes: int = 0
    #: per-op live-byte footprint in dependency order:
    #: (pos, op_type, live_bytes_while_running, transient_bytes)
    per_op: List[tuple] = field(default_factory=list)
    #: name -> (def_pos, last_use_pos, bytes) for every counted interval
    intervals: Dict[str, tuple] = field(default_factory=dict)
    #: vars live at the peak, largest first: (name, bytes, kind)
    peak_live: List[tuple] = field(default_factory=list)
    batch_size: int = 1

    def top_ops(self, k: int = 10) -> List[tuple]:
        """The k ops with the largest live-byte footprint while running."""
        return sorted(self.per_op, key=lambda r: -r[2])[:k]

    def attribution(self, k: int = 10):
        """Top-K per-op attribution as verifier ``Diagnostic`` records —
        renderable by ``debugger.format_diagnostics`` (one ``[info]
        hbm_peak`` row per op, largest live footprint first)."""
        from .verifier import Diagnostic
        rows = []
        for pos, op_type, live, transient in self.top_ops(k):
            extra = (f" (+{_fmt(transient)} transient)"
                     if transient else "")
            rows.append(Diagnostic(
                "hbm_peak", "info",
                f"{_fmt(live)} live while this op runs{extra}",
                op_type=op_type, op_index=pos))
        return rows

    def report(self, k: int = 10) -> str:
        """Human-readable plan: headline peak + top-K attribution table
        rendered through ``debugger.format_diagnostics``."""
        from .. import debugger
        head = (f"static HBM plan (batch={self.batch_size}): peak "
                f"{_fmt(self.peak_bytes)} at op #{self.peak_pos} "
                f"({self.peak_op}); resident {_fmt(self.resident_bytes)}"
                f"; steady {_fmt(self.steady_bytes)}")
        lines = [head]
        top = [(n, b, kind) for n, b, kind in self.peak_live[:k]]
        if top:
            lines.append("live at peak: " + ", ".join(
                f"{n} {_fmt(b)} [{kind}]" for n, b, kind in top))
        lines.append(debugger.format_diagnostics(self.attribution(k)))
        return "\n".join(lines)


# (program fingerprint, fetch tuple, batch) -> MemoryPlan; bounded FIFO,
# guarded — same rationale as the verifier cache
_CACHE: Dict[tuple, MemoryPlan] = {}  # guarded-by: _CACHE_LOCK
_CACHE_CAP = 128
_CACHE_LOCK = threading.Lock()


def clear_cache() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()


def _subblock_local_peak(program: Program, block: Block,
                         batch_size: int) -> int:
    """Transient footprint of one while/cond body: the sum-free interval
    peak over its LOCAL vars only (names declared in the sub-block —
    carried/captured vars resolve to the parent and are counted there).
    Nested bodies add their own local peak at their enclosing op."""
    from ..framework.core import Block as _Block
    local = set(block.vars)
    last_use: Dict[str, int] = {}
    def_pos: Dict[str, int] = {}
    nested: Dict[int, int] = {}
    for i, op in enumerate(block.ops):
        for n in op.input_arg_names():
            if n in local:
                last_use[n] = i
        for n in op.output_arg_names():
            if n in local:
                def_pos.setdefault(n, i)
                last_use[n] = max(last_use.get(n, i), i)
        for v in op.attrs.values():
            if isinstance(v, _Block):
                nested[i] = nested.get(i, 0) + _subblock_local_peak(
                    program, v, batch_size)
    # difference-array sweep (same linear form as _plan's main sweep)
    n_ops = len(block.ops)
    delta = [0] * (n_ops + 2)
    for n in local:
        last = last_use.get(n, -1)
        if last < 0:
            continue
        d = min(def_pos.get(n, 0), last)
        delta[d] += _var_bytes(block.vars.get(n), batch_size)
        delta[last + 1] -= _var_bytes(block.vars.get(n), batch_size)
    peak = running = 0
    for i in range(n_ops):
        running += delta[i]
        peak = max(peak, running + nested.get(i, 0))
    return peak


def plan_memory(program: Program, fetch_names=(),
                batch_size: int = 1) -> MemoryPlan:
    """Interval-liveness HBM plan for one program (see module docstring).
    Cached on (program fingerprint, fetch tuple, batch_size)."""
    fetch_names = tuple(
        f.name if hasattr(f, "name") else f for f in (fetch_names or ()))
    key = (program.fingerprint(), fetch_names, int(batch_size))
    with _CACHE_LOCK:
        cached = _CACHE.get(key)
    if cached is not None:
        _PLAN_HIT.inc()
        return cached
    _PLAN_MISS.inc()
    with _monitor.TRACER.span("memory.plan", "compile",
                              fetches=len(fetch_names)):
        plan = _plan(program, fetch_names, int(batch_size))
    _PEAK_GAUGE.set(float(plan.peak_bytes))
    with _CACHE_LOCK:
        if key not in _CACHE:
            if len(_CACHE) >= _CACHE_CAP:
                _CACHE.pop(next(iter(_CACHE)))
            _CACHE[key] = plan
        plan = _CACHE[key]
    return plan


def plan_sharded_memory(program: Program, fetch_names=(),
                        batch_size: int = 1, specs=None,
                        axis_sizes=None) -> MemoryPlan:
    """The per-shard :func:`plan_memory` of the GSPMD rule-table planner
    (ref ``memory.py:235-276``): each var named in ``specs`` ({name ->
    dist_spec}) is charged its slice, its bytes over the product of the
    sizes (``axis_sizes``) of the mesh axes in its spec, rounded up; the
    rest cost their full bytes on every shard.  Cached with the plans,
    the layout in the key."""
    fetch_names = tuple(
        f.name if hasattr(f, "name") else f for f in (fetch_names or ()))
    axis_sizes = dict(axis_sizes or {})
    shard_div: Dict[str, int] = {}
    for name, spec in (specs or {}).items():
        d = 1
        for ax in (spec or ()):
            for a in (ax if isinstance(ax, (tuple, list)) else (ax,)):
                d *= max(int(axis_sizes.get(a, 1) or 1), 1)
        if d > 1:
            shard_div[name] = d
    key = (program.fingerprint(), fetch_names, int(batch_size),
           tuple(sorted(shard_div.items())))
    with _CACHE_LOCK:
        cached = _CACHE.get(key)
    if cached is not None:
        _PLAN_HIT.inc()
        return cached
    _PLAN_MISS.inc()
    with _monitor.TRACER.span("memory.plan_sharded", "compile",
                              fetches=len(fetch_names),
                              sharded=len(shard_div)):
        plan = _plan(program, fetch_names, int(batch_size),
                     shard_div=shard_div)
    with _CACHE_LOCK:
        if key not in _CACHE:
            if len(_CACHE) >= _CACHE_CAP:
                _CACHE.pop(next(iter(_CACHE)))
            _CACHE[key] = plan
        plan = _CACHE[key]
    return plan


def _plan(program: Program, fetch_names: tuple,
          batch_size: int, shard_div=None) -> MemoryPlan:
    from ..framework import ir
    from ..framework.core import Block as _Block
    block = program.global_block()
    graph = ir.Graph(program)
    order = graph.topology_sort()
    pos = {n.id: i for i, n in enumerate(order)}
    n_ops = len(order)
    end = n_ops                      # end-of-step boundary position
    shard_div = shard_div or {}

    def vb(v, name):
        """``_var_bytes``, over the shard count of a sharded var (rounded
        up: a ragged shard is padded)."""
        b = _var_bytes(v, batch_size)
        d = shard_div.get(name, 1)
        return -(-b // d) if d > 1 else b

    fetched = set(fetch_names)
    # rw persistables: donated, so old+new share ONE buffer all step
    written = set()
    for b in program.blocks:
        for op in b.ops:
            written.update(n for n in op.output_arg_names() if n)
    resident = 0
    resident_names = []
    seen = set()
    for b in program.blocks:
        for op in b.ops:
            for name in op.input_arg_names() + op.output_arg_names():
                if not name or name in seen or not block.has_var(name):
                    continue
                seen.add(name)
                v = block.var(name)
                kind = "persist" if v.persistable else (
                    "feed" if getattr(v, "is_data", False) else None)
                if kind is not None:
                    b = vb(v, name)
                    resident += b
                    resident_names.append((name, b, kind))

    # inplace aliases: the pair's output shares the input buffer — count
    # the output's bytes zero and stretch the input's interval instead
    ali_graph = ir.get_pass("buffer_shared_inplace_pass").apply(graph)
    alias_of = {out: src
                for src, out in ali_graph.attrs.get("inplace_pairs", [])}

    def resolve_alias(name, depth=8):
        while name in alias_of and depth > 0:
            name = alias_of[name]
            depth -= 1
        return name

    # temporary intervals over the SSA var nodes (one node per write)
    intervals: Dict[str, List] = {}   # name -> [def, last, bytes, kind]
    sub_extra: Dict[int, int] = {}    # op pos -> sub-block local peak
    for node in order:
        i = pos[node.id]
        for attr in node.op.attrs.values():
            if isinstance(attr, _Block):
                sub_extra[i] = sub_extra.get(i, 0) + _subblock_local_peak(
                    program, attr, batch_size)
    for vnode in graph.all_var_nodes():
        name = vnode.name
        if not name or not block.has_var(name):
            continue
        v = block.var(name)
        if v.persistable or getattr(v, "is_data", False):
            continue                  # counted resident above
        producers = [pos[p.id] for p in vnode.inputs if p.id in pos]
        consumers = [pos[c.id] for c in vnode.outputs if c.id in pos]
        if not producers and not consumers:
            continue
        d = min(producers) if producers else 0
        last = max(consumers) if consumers else d
        if name in fetched:
            last = end               # a fetch pins its buffer past the step
        root = resolve_alias(name)
        entry = intervals.get(name)
        if root != name:
            # the inplace output shares the root's buffer: stretch the
            # root's interval over this reuse instead of counting a
            # second allocation.  A resident root (feed/persistable) is
            # already charged for the whole step — nothing to stretch.
            rv = block.vars.get(root) or (
                block.var(root) if block.has_var(root) else None)
            if rv is not None and (rv.persistable or
                                   getattr(rv, "is_data", False)):
                continue
            rentry = intervals.get(root)
            if rentry is not None:
                rentry[1] = max(rentry[1], last)
            else:
                intervals[root] = [d, last, vb(rv, root)
                                   if rv is not None else 0, "temp"]
            continue
        if entry is not None:
            entry[0] = min(entry[0], d)
            entry[1] = max(entry[1], last)
        else:
            intervals[name] = [d, last, vb(v, name), "temp"]

    # fetched rw persistables cost one defensive copy (the reference
    # executor's donation-aliasing copy), live from step end onward
    copy_bytes = sum(
        vb(block.var(n), n) for n in fetched
        if block.has_var(n) and block.var(n).persistable and n in written)

    # difference-array sweep: O(ops + vars), not O(ops * vars) — this
    # runs inside every fresh verify, so a BERT-sized program must not
    # pay a quadratic Python loop
    delta = [0] * (n_ops + 2)
    for e in intervals.values():
        delta[e[0]] += e[2]
        delta[min(e[1], end) + 1] -= e[2]
    per_op: List[tuple] = []
    peak, peak_pos = resident, end
    running = resident
    for i in range(n_ops + 1):
        running += delta[i]
        transient = sub_extra.get(i, 0)
        total = running + transient + (copy_bytes if i == end else 0)
        if i < n_ops:
            per_op.append((i, order[i].name, total, transient))
        if total >= peak:
            peak, peak_pos = total, i
    steady = resident + copy_bytes + sum(
        e[2] for e in intervals.values() if e[1] >= end)

    plan = MemoryPlan(
        peak_bytes=int(peak), peak_pos=int(peak_pos),
        peak_op=(order[peak_pos].name if peak_pos < n_ops
                 else "<end-of-step>"),
        resident_bytes=int(resident), steady_bytes=int(steady),
        per_op=per_op,
        intervals={n: (e[0], e[1], e[2]) for n, e in intervals.items()},
        batch_size=batch_size)
    live_at_peak = [(n, e[2], "temp") for n, e in intervals.items()
                    if e[0] <= peak_pos <= e[1] and e[2]]
    plan.peak_live = sorted(resident_names + live_at_peak,
                            key=lambda r: -r[1])
    return plan
