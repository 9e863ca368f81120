"""Executor: runs a Program's global block op by op, eagerly, on one device.

The port's counterpart of ``paddle_tpu/framework/executor.py`` (ref
``python/paddle/fluid/executor.py:295`` and ``framework/executor.cc:432``).
Where the reference traces the whole block into one XLA computation, this
executor calls each op's lowering on torch tensors in program order
(``feed``/``fetch`` ops are skipped) and frees every temporary after its
last reader — the reference's eager-deletion GC (``executor.cc:106-141``).

Per (program version, feed names and signatures, fetch list, scope) the
executor builds a *plan* once: the resolved lowerings, the liveness table
and the persistables to write back.  ``dispatch_stats()["traces"]`` counts
plans built — the analog of the reference's compiled-block count, which the
serving plane holds equal to the number of buckets.

Graph fusion: before it builds the plan of a plain Program, the executor
runs ``analysis.fusion.fuse_program`` at the real feed batch (the
reference's plain-Program fusion slot, ``executor.py:1404-1413``) and plans
the program it returns; a ``CompiledProgram`` plans what its
``_optimized`` gives (the verifier, dead-op elimination, the fusion pass,
``fuse_elewise_add_act_pass``).  Either way the pass gets the executor's
device, where the fusion autotuner times its candidates.  The plan key
carries the fusion flags' config token, so a flag flip re-plans.

Training: a synthesized ``*_grad`` op differentiates its forward op with
``torch.autograd`` (``registry.generic_grad_lower``).  Eager torch has no
CSE to merge a recomputed forward with the original, so the plan pairs each
generic grad op with its forward op, from the program alone, and the run
executes that forward op once under ``torch.enable_grad()`` on detached
inputs that require grad; its graph waits in a side table until the grad op
takes it (and frees it).  A grad op is paired by the forward's type and
inputs and by the output gradients it carries: a fused op's grad carries
only ``OG$Y`` of its five outputs.  After ``framework/recompute.py`` a grad
op pairs with the clone of its forward (names compared by source), so the
original runs without a graph and the clone's graph lives from its chain,
just before the segment's backward, to the grad op.  Everything else runs
under ``torch.no_grad()``, the optimizer ops included, and their outputs reach
the scope through the write-back of persistables.

Random ops draw from a ``torch.Generator`` on the executor's device, seeded
per run from ``seed`` or from ``program.random_seed`` and a step counter
(the reference's formula).  Dropout draws from stateless Philox streams
keyed by that seed (``LowerCtx.rng`` / ``rng_tagged``): a tagged stream is
a pure function of (seed, tag), so a grad op regenerates its forward's
mask; a grad op that recomputes a counter-stream forward rewinds the
counter to where the forward drew (``rng_marks``, the reference's
``executor.py:862-869, 897-918``).

AMP: a program that ``amp.decorate(...).minimize`` (or ``amp.enable``)
marked carries ``_attrs["amp"]``; its runs hand every op's inputs through
``amp.cast_ins`` before the lowering (the reference's
``executor.py:859-861``).  A differentiated forward casts after its leaves
are made (``registry.run_forward``), so master-weight gradients come back
float32.

Resilience (``resilience.py``): a run's ops execute under
``WATCHDOG.watch("executor.dispatch")`` with the ``executor.dispatch``
injection site inside, and fetches materialize under
``WATCHDOG.watch("fetch.materialize")`` with ``fetch.materialize`` inside
(``FetchHandle.numpy`` too); a failed run keeps its plan.  Step hooks
(``add_step_hook``) run after every run once the scope holds the step's
outputs, the checkpoint daemon's capture point; on the card each run
records a CUDA event, and ``drain()`` waits for the events still pending,
the preemption guard's barrier before a checkpoint.

Telemetry (ref ``executor.py:105-460, 1625-1900``): every executor keeps
the dispatch ledger ``_DispatchStats`` (13 counters under
``paddle_tpu_executor_*{executor}``: plan cache, runs, fetch modes, the host
time to dispatch and the host-blocked time by cause), folded into
``executor="retired"`` when it dies; ``aggregate_dispatch_stats`` sums the
live ones.  Each run takes a process-global step id (``last_step_id()``)
that the ``executor.dispatch`` and ``fetch.materialize`` spans carry, and
runs its ops inside ``_StepRange``: a ``torch.profiler.record_function``
range ``paddle_tpu.step#<id>`` while a profiler is on (one check
otherwise), which Kineto writes on the GPU lanes as a
``gpu_user_annotation``, plus an NVTX range on the card.  The median of the
last 9 dispatch intervals and the program's analytic flops at the real
batch (``analysis.cost``) give ``paddle_tpu_step_device_ms`` and the live
``paddle_tpu_step_mfu``, and the analytic flops and flop-share gauges
follow the dispatched plan (the measured MFU of a profiler window divides
by them); after each run the sampling profiler's hook
(``profiler.maybe_sample_step``), the step hooks, the HBM accountant's
sample (``hbm.ACCOUNTANT``), then ``FLAGS_benchmark``'s sync or the
in-flight throttle (``FLAGS_executor_max_inflight_steps``, over the runs'
CUDA events).  An OOM out of the ops (``torch.cuda.OutOfMemoryError``, or
the ``memory.oom`` drill site) goes through ``hbm.oom_forensics``, gets
``memory.summary`` appended and is re-raised; a real one drops the plan.

Left out so far: the nan/inf sanitizer, meshes, the numerics and comms
planes.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import amp as _amp
from .. import memory as _memory
from .. import monitor as _monitor
from .. import resilience as _resil
from ..analysis import fusion as _fusion
from ..analysis.device_profile import step_annotation
from ..kernels import dropout as _dropout
from . import registry
from .core import Program, Variable, default_main_program, grad_var_name
from .recompute import dead_barriers, source_name
from .scope import Scope, global_scope


#: executor-wide telemetry families: each executor's ledger is its
#: ``executor=<serial>`` series of these (ref executor.py:43-124)
_THROTTLE_HIST = _monitor.REGISTRY.histogram(
    "paddle_tpu_executor_throttle_wait_us",
    "in-flight throttle: host wait per blocking probe pop (us)")
#: live device-time attribution: the windowed median inter-dispatch
#: interval, and analytic flops/step over (interval x the card's peak)
_STEP_MS_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_step_device_ms",
    "median per-step time (ms) at the dispatch boundary — equals "
    "device step time in a throttled steady-state loop", ("executor",))
_STEP_MFU_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_step_mfu",
    "live model-flops utilization in [0,1]: analytic flops/step "
    "(analysis.cost) over step-time estimate x device peak", ("executor",))
_CLASS_SHARE_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_step_flops_share",
    "analytic flop share by op class of the most recently dispatched "
    "step (conv/matmul/embedding/norm/softmax/attention/...) — the "
    "roofline attribution the fusion arc picks candidates from",
    ("op_class",))
_ANALYTIC_FLOPS_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_analytic_step_flops",
    "analytic flops per step of the most recently dispatched plan")

_HELP = {
    "cache_hits": "dispatches served by the compiled-block cache",
    "cache_misses": "dispatches that missed the compiled-block cache",
    "traces": "full block re-lowerings (trace + jit)",
    "steps_dispatched": "steps handed to the device",
    "lazy_fetch_steps": "steps returning in-flight FetchHandles",
    "eager_fetch_steps": "steps materializing fetches before returning",
    "fetch_materializations": "device->host fetch syncs",
    "throttle_waits": "blocking pops of the in-flight throttle",
    "time_to_dispatch_us": "host us from run() entry to async-dispatch "
                           "return",
    "host_block_us": "total host-blocked-on-device us (all causes)",
    "materialize_block_us": "host-blocked us in fetch materialization",
    "throttle_block_us": "host-blocked us in the in-flight throttle",
    "benchmark_sync_us": "host-blocked us in FLAGS_benchmark per-step "
                         "syncs",
}

_stats_serials = itertools.count()


class _DispatchStats:
    """Per-executor dispatch ledger — the per-step framework tax (ref
    ``executor.py:129-213``).

    Everything the host does per ``run()`` that is not the step's device
    work: plan-cache lookups (hit/miss), plans built (``traces``), the
    host time from ``run()`` entry to the return of the last op's launch
    (``time_to_dispatch_us``: in the eager executor, issuing every op), and
    every point where the host blocks on the card (``host_block_us``, split
    by cause: fetch materialization, the in-flight throttle,
    ``FLAGS_benchmark``'s sync).  Each field is the ``executor=<serial>``
    series of a process-wide counter family, so a metrics export equals
    ``dispatch_stats()`` by construction.
    """

    _INT_FIELDS = ("cache_hits", "cache_misses", "traces",
                   "steps_dispatched", "lazy_fetch_steps",
                   "eager_fetch_steps", "fetch_materializations",
                   "throttle_waits")
    _US_FIELDS = ("time_to_dispatch_us", "host_block_us",
                  "materialize_block_us", "throttle_block_us",
                  "benchmark_sync_us")

    def __init__(self):
        self.serial = next(_stats_serials)
        lbl = {"executor": str(self.serial)}
        self._fams = {
            f: _monitor.REGISTRY.counter(
                "paddle_tpu_executor_" + f, _HELP[f], ("executor",))
            for f in self._INT_FIELDS + self._US_FIELDS}
        self._cells = {f: fam.labels(**lbl)
                       for f, fam in self._fams.items()}
        self._ms_cell = _STEP_MS_GAUGE.labels(**lbl)
        self._mfu_cell = _STEP_MFU_GAUGE.labels(**lbl)

    def set_step_timing(self, step_ms: float, mfu: float):
        self._ms_cell.set(step_ms)
        self._mfu_cell.set(mfu)

    def retire(self):
        """Fold this executor's series into ``executor="retired"`` and drop
        them (a GC finalizer of the owning executor calls it); the live
        cells are rebound to the retired series, so a FetchHandle that
        outlives its executor still counts.  The gauges' series are
        dropped: a dead executor's step time means nothing."""
        src = {"executor": str(self.serial)}
        dst = {"executor": "retired"}
        retired = {f: fam.labels(**dst) for f, fam in self._fams.items()}
        for fam in self._fams.values():
            fam.fold(src, dst)
        self._cells = retired
        _STEP_MS_GAUGE.fold(src, None)
        _STEP_MFU_GAUGE.fold(src, None)

    def reset(self):
        for c in self._cells.values():
            c.reset()

    def incr(self, field: str, n=1):
        self._cells[field].inc(n)

    def block(self, cause_field: str, dt_us: float):
        """Record ``dt_us`` of host-blocked time under a cause."""
        self._cells[cause_field].inc(dt_us)
        self._cells["host_block_us"].inc(dt_us)

    def snapshot(self) -> Dict[str, Any]:
        out = {f: int(self._cells[f].get()) for f in self._INT_FIELDS}
        out.update({f: float(self._cells[f].get())
                    for f in self._US_FIELDS})
        return out


#: live executors, for the profiler's aggregate (weak)
_EXECUTORS: "weakref.WeakSet" = weakref.WeakSet()

#: process-global step ids: every run of any executor takes one, and the
#: same id keys its executor.dispatch span, its device-timeline range and
#: the sampling profiler's window manifest
_GLOBAL_STEPS = itertools.count(1)
_LAST_STEP_ID = 0


def last_step_id() -> int:
    """Process-global id of the most recently dispatched step."""
    return _LAST_STEP_ID


def aggregate_dispatch_stats() -> Dict[str, Any]:
    """Sum the dispatch ledgers of every live Executor (the profiler's
    ``dispatch_stats``), plus an ``executors`` count; process-lifetime
    totals are ``monitor.counter_totals()``."""
    fields = _DispatchStats._INT_FIELDS + _DispatchStats._US_FIELDS
    out: Dict[str, Any] = dict.fromkeys(fields, 0)
    n = 0
    for exe in list(_EXECUTORS):
        snap = exe._stats.snapshot()
        for f in fields:
            out[f] += snap[f]
        n += 1
    out["executors"] = n
    return out


_UNSET = object()


def _maybe_sample_step(step_id: int, step_ms=None) -> None:
    """Memoized trampoline to ``profiler.maybe_sample_step`` (the profiler
    imports this package, so it binds on first use)."""
    global _maybe_sample_step
    from ..profiler import maybe_sample_step
    _maybe_sample_step = maybe_sample_step
    maybe_sample_step(step_id, step_ms)


_hbm_mod = []


def _hbm():
    """Memoized ``paddle_tpu_torch.hbm`` module."""
    if not _hbm_mod:
        from .. import hbm
        _hbm_mod.append(hbm)
    return _hbm_mod[0]


_device_peak_cache: Dict[str, float] = {}


def _device_peak(device: torch.device) -> float:
    """Memoized peak FLOP/s of the executor's device (the MFU
    denominator)."""
    key = str(device)
    if key not in _device_peak_cache:
        from ..analysis.cost import device_peak_flops
        _device_peak_cache[key] = device_peak_flops(device)
    return _device_peak_cache[key]


def _feed_batch(feeds) -> int:
    """Batch size of a feed list: the leading dim of the first shaped feed
    (the convention every planner resolves -1 dims through); 1 when
    nothing is shaped."""
    for f in feeds:
        shape = getattr(f, "shape", None)
        if shape:
            return int(shape[0])
    return 1


def _restamp_memory(program, fetch_names, batch):
    """Re-plan the verifier's batch-1 memory stamp at the real feed batch
    (ref executor.py:333-351), so tools and OOM reports see the step's
    actual footprint; fingerprint-cached, a one-off per plan."""
    va = program._attrs.get("verify")
    if va is None or batch <= 1:
        return
    from ..analysis.memory import plan_memory
    plan = plan_memory(program, fetch_names, batch_size=batch)
    va["memory"] = {
        "peak_bytes": plan.peak_bytes,
        "resident_bytes": plan.resident_bytes,
        "steady_bytes": plan.steady_bytes,
        "peak_op": plan.peak_op,
        "top_ops": [(p, t, b) for p, t, b, _ in plan.top_ops(5)],
        "batch": batch,
    }


def _resolve_cost(plan, feeds, device):
    """Once per plan: the analytic flops a step at the real feed batch and
    the per-class flop shares, and the memory re-stamp (ref
    executor.py:434-469).  (flops, peak FLOP/s, shares) or None — cost
    modeling never breaks a dispatch."""
    try:
        from ..analysis.cost import plan_cost
        program = plan.program
        batch = _feed_batch(feeds)
        try:
            _restamp_memory(program, plan.fetch_names, batch)
        except Exception:
            pass
        cplan = plan_cost(program, plan.fetch_names, batch_size=batch)
        if not cplan.flops:
            return None
        return float(cplan.flops), _device_peak(device), dict(cplan.share())
    except Exception:
        return None


#: the plan whose cost the analytic gauges hold (weak)
_published_cost: List[Any] = [None]


def _publish_cost(plan, cost) -> None:
    """Point ``paddle_tpu_analytic_step_flops`` and
    ``paddle_tpu_step_flops_share`` at the dispatched plan, when it is not
    the one they hold.  The reference sets them when a block compiles, so a
    profiler window over one program read the flops of whichever compiled
    last; the port's gauges follow the dispatch (two compares a step)."""
    held = _published_cost[0]
    if held is not None and held() is plan:
        return
    flops, _peak, share = cost
    for labels, _cell in _CLASS_SHARE_GAUGE.series():
        if labels.get("op_class") not in share:
            _CLASS_SHARE_GAUGE.fold(labels, None)
    for cls, v in share.items():
        _CLASS_SHARE_GAUGE.set(v, op_class=cls)
    _ANALYTIC_FLOPS_GAUGE.set(flops)
    _published_cost[0] = weakref.ref(plan)


def _resolve_hbm_info(plan, feeds):
    """Once per plan: the class name-sets (parameters vs other
    persistables: optimizer state, BN statistics) and the static plan's
    bytes at the real batch, which the HBM accountant joins its samples
    to (ref executor.py:354-390).  None on failure."""
    try:
        program = plan.program
        block = program.global_block()
        params, opt = [], []
        for n in plan.persistables:
            v = block.var(n)
            (params if getattr(v, "is_parameter", False) else opt).append(n)
        mem = (program._attrs.get("verify") or {}).get("memory") or {}
        steady = int(mem.get("steady_bytes", 0) or 0)
        peak = int(mem.get("peak_bytes", 0) or 0)
        batch = int(mem.get("batch", 1) or 1)
        if not steady:
            from ..analysis.memory import plan_memory
            batch = _feed_batch(feeds)
            mplan = plan_memory(program, plan.fetch_names,
                                batch_size=batch)
            steady, peak = int(mplan.steady_bytes), int(mplan.peak_bytes)
        return {"params": frozenset(params), "opt_state": frozenset(opt),
                "plan_steady": steady, "plan_peak": peak,
                "plan_batch": batch}
    except Exception:
        return None


class _StepRange:
    """The step on the device timeline: while a ``torch.profiler`` is on, a
    ``record_function`` range ``paddle_tpu.step#<id>`` (Kineto writes it on
    each GPU stream the step's kernels ran on as a
    ``gpu_user_annotation``); on the card also an NVTX range of that name.
    With no profiler on, the range costs one check."""

    __slots__ = ("_step", "_nvtx", "_rf")

    def __init__(self, device: torch.device, step_id: int):
        self._step = step_id
        self._nvtx = device.type == "cuda"
        self._rf = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(
                step_annotation(self._step))
            self._rf.__enter__()
        if self._nvtx:
            torch.cuda.nvtx.range_push(step_annotation(self._step))
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class LowerCtx:
    """Per-run context handed to op lowerings; ``amp`` is the program's
    bf16 AMP flag."""

    def __init__(self, device: torch.device, seed: int, amp: bool = False):
        self.device = device
        self._seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self._generator = None
        self.amp = bool(amp)
        self._counter = 0
        # output name of a stateful_rng op -> the counter before it ran
        self.rng_marks: Dict[str, int] = {}

    def rng(self) -> _dropout.Stream:
        """A fresh counter stream each call (``executor.py:731-733``)."""
        self._counter += 1
        return _dropout.counter_stream(self._seed, self._counter)

    def rng_tagged(self, tag: int) -> _dropout.Stream:
        """The op tag's stream, independent of the order ops run in: an op
        and its grad op draw the same bits (``executor.py:735-742``); the
        counter word's kind keeps it apart from :meth:`rng`'s streams."""
        return _dropout.tagged_stream(self._seed, tag)

    @property
    def generator(self) -> torch.Generator:
        if self._generator is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(self._seed)
            self._generator = g
        return self._generator


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A fetched tensor on the host.  numpy has no bfloat16, so a bf16
    tensor (an AMP activation) comes back widened to float32, which is
    exact; ``return_numpy=False`` keeps the tensor and its dtype."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class FetchHandle:
    """A fetched tensor still being computed on the card.  ``numpy()``
    waits on the CUDA event recorded on the dispatching stream when the
    run returned, then copies to the host; the wait and the copy count in
    the dispatching executor's ledger (``fetch_materializations``,
    ``materialize_block_us``)."""

    def __init__(self, tensor: torch.Tensor,
                 stats: Optional[_DispatchStats] = None,
                 step_id: Optional[int] = None):
        self.tensor = tensor
        self._stats = stats
        self._step = step_id
        self._event = None
        if tensor.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensor.device))

    def numpy(self) -> np.ndarray:
        t0 = time.perf_counter()
        with _resil.WATCHDOG.watch("fetch.materialize"):
            _resil.maybe_inject("fetch.materialize")
            if self._event is None:
                out = _to_numpy(self.tensor)
            else:
                self._event.synchronize()
                # copy on a side stream: on the dispatching stream the copy
                # would queue behind every batch dispatched after this one
                with torch.cuda.stream(torch.cuda.Stream(self.tensor.device)):
                    out = _to_numpy(self.tensor)
        t1 = time.perf_counter()
        if self._stats is not None:
            self._stats.incr("fetch_materializations")
            self._stats.block("materialize_block_us", (t1 - t0) * 1e6)
        if _monitor.TRACER.enabled:
            _monitor.TRACER.add_complete(
                "fetch.materialize", "fetch", t0, t1,
                None if self._step is None else {"step": self._step})
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def _fwd_key(op) -> tuple:
    """What a forward op and its generic grad op share: the type and the
    input names by slot, each name as its source (``recompute.source_name``:
    a recomputed clone reads ``v@RBAR`` or ``v@RECOMPUTE`` where the grad op
    of the original reads ``v``)."""
    return (op.type,
            tuple(sorted((s, tuple(map(source_name, ns)))
                         for s, ns in op.inputs.items())))


def _grad_key(op) -> tuple:
    return (op.attrs["__fwd_type__"],
            tuple(sorted((s[2:], tuple(map(source_name, ns)))
                         for s, ns in op.inputs.items()
                         if s.startswith("X$"))))


def _carries_grads_of(grad_op, fwd_op) -> bool:
    """Whether each output gradient the grad op carries (``OG$<slot>``) is
    the gradient of ``fwd_op``'s output in that slot (of its source, for a
    recomputed clone's ``v@RECOMPUTE``).  A grad op may carry fewer slots
    than its forward has outputs."""
    for s, ns in grad_op.inputs.items():
        if s.startswith("OG$") and list(ns) != [
                grad_var_name(source_name(n))
                for n in fwd_op.outputs.get(s[3:], [])]:
            return False
    return True


class _Plan:
    """Everything a run of one block needs that does not depend on values.

    ``ops`` holds ``(op, info)``; a generic grad op carries its forward
    op's info.  ``fwd_of`` maps each generic grad op's index to the index of
    the forward op whose graph it takes (None when the block holds no such
    op: the grad op then recomputes its forward); ``wanted`` maps each
    forward op so taken to the input gradients its grad op wants, by
    slot.  In a recomputed program a grad op takes its forward's clone,
    the latest op of that key before it; a barrier nobody reads is left
    out."""

    def __init__(self, program: Program, fetch_names):
        block = program.global_block()
        self.program = program
        self.fetch_names = tuple(fetch_names)
        self.block = block
        # resolved on the plan's first run (cost, memory)
        self.cost_info = _UNSET
        self.hbm_info = _UNSET
        self.amp = bool(program._attrs.get("amp", False))
        self.ops = []
        self.fwd_of: Dict[int, Optional[int]] = {}
        self.wanted: Dict[int, Dict[str, List[bool]]] = {}
        fwd_at: Dict[tuple, List[int]] = {}
        dead = {id(op) for op in dead_barriers(block.ops, fetch_names)}
        for op in block.ops:
            if op.type in ("feed", "fetch") or id(op) in dead:
                continue
            i = len(self.ops)
            if registry.is_generic_grad(op):
                self.ops.append(
                    (op, registry.get_op_info(op.attrs["__fwd_type__"])))
                cands = fwd_at.get(_grad_key(op), [])
                j = next((c for c in reversed(cands)
                          if _carries_grads_of(op, self.ops[c][0])), None)
                self.fwd_of[i] = j
                if j is not None:
                    cands.remove(j)
                    self.wanted[j] = {s[3:]: [bool(n) for n in ns]
                                      for s, ns in op.outputs.items()
                                      if s.startswith("IG$")}
                continue
            self.ops.append((op, registry.get_op_info(op.type)))
            fwd_at.setdefault(_fwd_key(op), []).append(i)
        persistable = {n for n, v in block.vars.items() if v.persistable}
        keep = set(fetch_names) | persistable
        last: Dict[str, int] = {}
        written = set()
        for i, (op, _) in enumerate(self.ops):
            for slot, names in op.inputs.items():
                if self.fwd_of.get(i) is not None and slot.startswith("X$"):
                    continue        # the forward's graph holds what it needs
                for n in names:
                    if n:
                        last[n] = i
            for n in op.output_arg_names():
                if n:
                    written.add(n)
                    last[n] = max(last.get(n, -1), i)
        self.free_after: List[List[str]] = [[] for _ in self.ops]
        for n, i in last.items():
            if n not in keep:
                self.free_after[i].append(n)
        self.persist_out = sorted(written & persistable)
        self.persistables = sorted(persistable & set(last))


def _feed_sig(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    a = np.asarray(x)
    return a.shape, a.dtype.name


def _op_context(block, op) -> str:
    parts = [f"op={op.type!r}"]
    for slot, names in op.inputs.items():
        for n in names:
            shape = block.var(n).shape if n and block.has_var(n) else None
            parts.append(f"in {slot}:{n} shape={shape}")
    parts.append(f"outs={[n for ns in op.outputs.values() for n in ns]}")
    return "\n  ".join(parts)


class Executor:
    """ref ``python/paddle/fluid/executor.py:295`` Executor.

    ``place`` picks the device: ``CUDAPlace(n)`` (the default, ``n = 0``)
    or ``CPUPlace()``.  Without a CUDA device the default raises — a run
    on the host must ask for it."""

    def __init__(self, place=None):
        from ..place import CUDAPlace, checked_device
        self.device = checked_device(place, "Executor")
        self.place = CUDAPlace(0) if place is None else place
        self._lock = threading.Lock()
        self._plans: Dict[Any, _Plan] = {}  # guarded-by: _lock
        self._stats = _DispatchStats()
        self._step_seed = 0  # guarded-by: _lock
        self._step_hooks: List[Any] = []  # guarded-by: _lock
        # an event per dispatched run on the card, not yet seen complete:
        # drain()'s barrier and the in-flight throttle's probes
        self._inflight: collections.deque = \
            collections.deque()  # guarded-by: _lock
        # live device-time attribution: inter-dispatch intervals (median)
        self._last_dispatch_t: Optional[float] = None  # guarded-by: _lock
        self._step_win: collections.deque = \
            collections.deque(maxlen=9)  # guarded-by: _lock
        _EXECUTORS.add(self)
        # the ledger's series fold into executor="retired" when this
        # executor dies (the callback holds only the stats object)
        weakref.finalize(self, _DispatchStats.retire, self._stats)

    def close(self):
        with self._lock:
            self._plans.clear()
            self._inflight.clear()

    # -- step-boundary hooks (ref executor.py:1273-1290) ---------------------
    def add_step_hook(self, fn) -> None:
        """Register ``fn(executor, scope)`` to run after every completed
        ``run()``, once the scope holds the step's outputs (still being
        computed on the card: a hook that needs host values copies on the
        device and waits elsewhere, as the checkpoint daemon does).  Every
        run counts, startup programs included; hooks run on the
        dispatching thread, and a hook's exception fails the run."""
        with self._lock:
            if fn not in self._step_hooks:
                self._step_hooks.append(fn)

    def remove_step_hook(self, fn) -> None:
        with self._lock:
            if fn in self._step_hooks:
                self._step_hooks.remove(fn)

    def drain(self) -> int:
        """Wait until every run dispatched on the card has finished there,
        so the scope's values are computed (ref executor.py:2137-2157).
        Returns the number of runs waited on; on the host, 0."""
        with self._lock:
            pending = list(self._inflight)
            self._inflight.clear()
        waited = 0
        for ev in pending:
            if not ev.query():
                ev.synchronize()
                waited += 1
        return waited

    def _throttle(self, limit: int) -> None:
        """Remember this run's CUDA event and, once more than ``limit``
        runs are in flight, wait for the oldest (ref executor.py:2086-2135;
        each pop past the limit is a counted wait, however short).  With
        ``limit`` 0 nothing waits, and events already complete leave the
        front of the deque (``drain()`` still needs the rest)."""
        if self.device.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        with self._lock:
            self._inflight.append(ev)
            if limit <= 0:
                while len(self._inflight) > 1 and self._inflight[0].query():
                    self._inflight.popleft()
                return
        stats = self._stats
        while True:
            with self._lock:
                if len(self._inflight) <= limit:
                    return
                oldest = self._inflight.popleft()
            tb = time.perf_counter()
            oldest.synchronize()
            tb1 = time.perf_counter()
            stats.incr("throttle_waits")
            stats.block("throttle_block_us", (tb1 - tb) * 1e6)
            _THROTTLE_HIST.observe((tb1 - tb) * 1e6)
            if _monitor.TRACER.enabled:
                _monitor.TRACER.add_complete(
                    "executor.throttle_wait", "dispatch", tb, tb1)

    def _benchmark_sync(self) -> None:
        """``FLAGS_benchmark``: wait for the card after every run, so wall
        timing is attributable; everything queued is then done."""
        tb = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tb1 = time.perf_counter()
        self._stats.block("benchmark_sync_us", (tb1 - tb) * 1e6)
        if _monitor.TRACER.enabled:
            _monitor.TRACER.add_complete(
                "executor.benchmark_sync", "dispatch", tb, tb1)
        with self._lock:
            self._inflight.clear()

    def dispatch_stats(self) -> Dict[str, Any]:
        """This executor's dispatch ledger (``_DispatchStats``) plus the
        runs in flight, the throttle's limit and the plans held
        (``compiled_blocks``, which the serving plane holds equal to the
        bucket count)."""
        from ..flags import get_flags
        out = self._stats.snapshot()
        with self._lock:
            out["steps_in_flight"] = len(self._inflight)
            out["compiled_blocks"] = len(self._plans)
        out["max_in_flight"] = int(get_flags(
            "FLAGS_executor_max_inflight_steps")
            ["FLAGS_executor_max_inflight_steps"])
        return out

    def reset_dispatch_stats(self):
        self._stats.reset()

    def _to_device(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda" and x.device.type == "cpu":
            # pinned and asynchronous: a copy from pageable memory would
            # block this thread until the card has finished all queued work
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True,
            seed: Optional[int] = None):
        """Run the program's global block once.  Returns the fetches as
        numpy arrays, or as :class:`FetchHandle` s with
        ``return_numpy=False`` (the device work may still be running)."""
        t0 = time.perf_counter()
        from ..compiler import CompiledProgram
        from ..flags import get_flags
        compiled = program if isinstance(program, CompiledProgram) else None
        if compiled is not None:
            program = compiled.program
        if program is None:
            program = default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = tuple(f.name if isinstance(f, Variable) else f
                            for f in (fetch_list or []))
        feed_names = tuple(sorted(feed))
        feed_sigs = tuple(_feed_sig(feed[n]) for n in feed_names)
        key = (program.fingerprint(), feed_names, feed_sigs, fetch_names,
               scope._serial, None if compiled is None else compiled._serial,
               _fusion.config_token())
        stats = self._stats
        with self._lock:
            plan = self._plans.get(key)
            fresh = plan is None
            if fresh:
                stats.incr("cache_misses")
                stats.incr("traces")
                feed_shapes = {n: _feed_sig(v)[0] for n, v in feed.items()}
                if compiled is not None:
                    run_prog = compiled._optimized(
                        fetch_names, feed_shapes, device=self.device)
                else:
                    # the plain-Program fusion slot, at the real batch
                    run_prog = _fusion.fuse_program(
                        program, fetch_names, feed_shapes=feed_shapes,
                        device=self.device)
                plan = self._plans[key] = _Plan(run_prog, fetch_names)
            else:
                stats.incr("cache_hits")
            self._step_seed += 1
            step_seed = self._step_seed
        seed_val = seed if seed is not None else (
            program.random_seed * 1000003 + step_seed)
        env = {n: self._to_device(v) for n, v in feed.items()}
        feeds = list(env.values())
        record = fresh and self.device.type == "cuda" and \
            _hbm().plans_enabled()
        if record:
            torch.cuda.synchronize(self.device)
            before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        step_id = next(_GLOBAL_STEPS)
        global _LAST_STEP_ID
        _LAST_STEP_ID = step_id
        # an injected fault or a hang raises around the ops, and the plan
        # stays cached (ref executor.py:1636-1660): a recovered fault must
        # not pay a re-plan
        try:
            with _resil.WATCHDOG.watch("executor.dispatch"), \
                    _StepRange(self.device, step_id), torch.no_grad():
                _resil.maybe_inject("executor.dispatch")
                # the OOM drill: an injected fault here takes the path a
                # real out-of-memory error of the ops below takes
                _resil.maybe_inject("memory.oom")
                run_plan(plan, LowerCtx(self.device, seed_val, plan.amp),
                         env, lambda name: self._read(scope, plan.block,
                                                      name))
        except Exception as e:
            self._raise_with_forensics(e, key, plan, scope, feeds)
        tdisp = time.perf_counter()
        if record:
            torch.cuda.synchronize(self.device)
            _hbm().record_xla_plan(
                ",".join(fetch_names) or "<block>", _hbm()._MeasuredPlan(
                    before, torch.cuda.max_memory_allocated(self.device)))
        stats.incr("steps_dispatched")
        stats.incr("time_to_dispatch_us", (tdisp - t0) * 1e6)
        if _monitor.TRACER.enabled:
            _monitor.TRACER.add_complete("executor.dispatch", "dispatch",
                                         t0, tdisp, {"step": step_id})
        # -- live device-time attribution: resolved once per plan; a step
        # pays a median-window update and two gauge stores, no sync
        cost = plan.cost_info
        if cost is _UNSET:
            cost = plan.cost_info = _resolve_cost(plan, feeds, self.device)
        if cost is not None:
            _publish_cost(plan, cost)
        with self._lock:
            last = self._last_dispatch_t
            self._last_dispatch_t = tdisp
            med = None
            if last is not None and tdisp > last:
                self._step_win.append(tdisp - last)
                med = sorted(self._step_win)[len(self._step_win) // 2]
        if med is not None and cost is not None:
            stats.set_step_timing(med * 1e3, cost[0] / med / cost[1])
        _maybe_sample_step(step_id, med * 1e3 if med is not None else None)
        if plan.persist_out:
            scope.set_vars({n: env[n] for n in plan.persist_out})
        with self._lock:
            hooks = list(self._step_hooks)
        for h in hooks:
            h(self, scope)
        # -- the HBM accountant: one bounded deque append per sampled step;
        # after the hooks, so a checkpoint capture's copies count this step
        acc = _hbm().ACCOUNTANT
        if acc.enabled and step_id % acc.every_n == 0:
            info = plan.hbm_info
            if info is _UNSET:
                info = plan.hbm_info = _resolve_hbm_info(plan, feeds)
            acc.note_step(step_id, scope, info, 0)
        fetches = [env[n] if n in env else self._read(scope, plan.block, n)
                   for n in fetch_names]
        fl = get_flags(["FLAGS_benchmark",
                        "FLAGS_executor_max_inflight_steps"])
        if fl["FLAGS_benchmark"]:
            self._benchmark_sync()
        elif not (return_numpy and fetches):
            # an eager step with fetches waits at its materialization
            # below; lazy steps and fetch-less loops feed the throttle
            self._throttle(int(fl["FLAGS_executor_max_inflight_steps"]))
        if return_numpy:
            stats.incr("eager_fetch_steps")
            tm = time.perf_counter()
            with _resil.WATCHDOG.watch("fetch.materialize"):
                _resil.maybe_inject("fetch.materialize")
                out = [_to_numpy(t) for t in fetches]
            if fetches:
                tm1 = time.perf_counter()
                stats.incr("fetch_materializations", len(fetches))
                stats.block("materialize_block_us", (tm1 - tm) * 1e6)
                if _monitor.TRACER.enabled:
                    _monitor.TRACER.add_complete(
                        "fetch.materialize", "fetch", tm, tm1,
                        {"n": len(fetches), "step": step_id})
                # the fetches are on the host, so every run before is done
                with self._lock:
                    self._inflight.clear()
            return out
        stats.incr("lazy_fetch_steps")
        return [FetchHandle(t, stats, step_id) for t in fetches]

    def _raise_with_forensics(self, e, key, plan, scope, feeds):
        """Re-raise a failed run's error.  An out-of-memory error (a real
        one, ``torch.cuda.OutOfMemoryError`` wrapped by ``run_plan``, or
        the ``memory.oom`` drill) first goes through
        ``hbm.oom_forensics`` (counted, traced, dumped) and gets
        ``memory.summary`` and the dump's path appended (ref
        executor.py:1660-1700); a real one also drops the plan, as the
        reference drops a failed block.  The error is never swallowed."""
        injected_oom = getattr(e, "site", None) == "memory.oom"
        if not (injected_oom or _memory._is_oom_error(e)):
            raise e
        if not injected_oom:
            with self._lock:
                self._plans.pop(key, None)
        dump_path = None
        try:
            dump_path = _hbm().oom_forensics(
                e, scope=scope, program=plan.program,
                fetch_names=plan.fetch_names, batch=_feed_batch(feeds),
                site="injected" if injected_oom else "dispatch")
        except Exception:
            pass
        try:
            report = _memory.summary(scope)
        except Exception:
            report = "(memory summary unavailable)"
        if dump_path:
            report += f"\n\noom forensics dump: {dump_path}"
        if injected_oom:
            # the drill stays an InjectedFault (transient by contract)
            e.args = ((f"{e.args[0]}\n\n{report}" if e.args else report),)
            raise e
        try:
            wrapped = type(e)(f"{e}\n\n{report}")
        except Exception:
            wrapped = RuntimeError(f"{e}\n\n{report}")
        raise wrapped from e

    def _read(self, scope: Scope, block, name: str) -> torch.Tensor:
        v = scope.find_var(name)
        if v is None:
            hint = (" — did you run the startup program?"
                    if block.has_var(name) and block.var(name).persistable
                    else "")
            raise KeyError(f"op input var {name!r} has no value: not fed, "
                           f"not in scope, and not produced by a preceding "
                           f"op{hint}")
        if not (isinstance(v, torch.Tensor) and v.device == self.device):
            # the scope holds tensors on the executor's device
            v = self._to_device(v)
            scope.set_var(name, v)
        return v


def run_plan(plan: _Plan, ctx: LowerCtx, env: Dict[str, Any],
             read: Callable[[str], torch.Tensor]) -> None:
    """Run a block's plan op by op on ``env`` (name -> tensor): each op's
    outputs land in it, and each temporary leaves it after its last
    reader.  ``read(name)`` gives an input that ``env`` lacks (the
    executor reads the scope).  ``Executor.run`` and
    ``framework.function``'s callables run their blocks through it."""
    graphs: Dict[int, registry.Forward] = {}   # kept, by forward op
    try:
        for i, (op, info) in enumerate(plan.ops):
            try:
                outs = _run_op(plan, i, op, info, ctx, env, read, graphs)
            except Exception as e:
                raise RuntimeError(
                    f"{type(e).__name__} while running op {op.type!r}: "
                    f"{e}\n  {_op_context(plan.block, op)}") from e
            for slot, names in op.outputs.items():
                for n, val in zip(names, outs.get(slot, [])):
                    if n and val is not None:
                        env[n] = val.detach()
            for n in plan.free_after[i]:
                env.pop(n, None)
    finally:
        graphs.clear()      # a raised error's traceback must not pin them


def _run_op(plan, i, op, info, ctx, env, read, graphs):
    grad = i in plan.fwd_of
    fwd = plan.fwd_of.get(i)
    ins = {}
    for slot, names in op.inputs.items():
        if fwd is not None and slot.startswith("X$"):
            continue
        vals = []
        for n in names:
            if not n:
                vals.append(None)
            elif n in env:
                vals.append(env[n])
            elif grad and slot.startswith("OG$"):
                vals.append(None)   # an output nobody differentiated
            else:
                vals.append(read(n))
        ins[slot] = vals
    if grad:
        if fwd is None and info.stateful_rng:
            return _replay_grad(op, ctx, ins)
        return registry.generic_grad_lower(
            ctx, ins, op.attrs, graphs.pop(fwd) if fwd is not None
            else None)
    if info.stateful_rng:
        for n in op.output_arg_names():
            if n:
                ctx.rng_marks[n] = ctx._counter
    if i in plan.wanted:
        # casts after making its leaves, when the program is AMP
        graphs[i] = registry.run_forward(info, ctx, ins, op.attrs,
                                         plan.wanted[i])
        return graphs[i][1]
    if ctx.amp:
        ins = _amp.cast_ins(op.type, ins)
    return info.lower(ctx, ins, op.attrs) or {}


def _replay_grad(op, ctx, ins):
    """A generic grad op recomputing a forward that draws random bits:
    the counter rewinds to where the forward drew, so the recompute
    draws the same bits, then comes back (``executor.py:897-918``)."""
    mark = next((ctx.rng_marks[n[:-len("@GRAD")]]
                 for s, ns in op.inputs.items() if s.startswith("OG$")
                 for n in ns if n and n.endswith("@GRAD")
                 and n[:-len("@GRAD")] in ctx.rng_marks), None)
    if mark is None:
        return registry.generic_grad_lower(ctx, ins, op.attrs)
    saved, ctx._counter = ctx._counter, mark
    try:
        return registry.generic_grad_lower(ctx, ins, op.attrs)
    finally:
        ctx._counter = saved
