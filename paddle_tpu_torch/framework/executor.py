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

Numerics (``analysis/numerics.py``, ref ``executor.py:933-1005,
1832-1843``): under ``FLAGS_numerics`` ``sentinel`` or ``full`` the run
hands each value the step wrote to a ``numerics.StepStats`` as it lets go
of it (a temporary after its last reader, the rest at the step's end), which
reduces them in multi-tensor batches into the reference's packed stats
vector; the vector goes to pinned host memory behind the step (a
non-blocking copy and an event) and ``ENGINE.note_step`` decodes it once the
event has completed, so the training thread never waits on it.  Weight
pairs are the read-write persistables before and after the step.  The mode
is part of the plan key, so a flip re-plans.  The ``numerics.poison``
injection site corrupts one float read-write persistable on its way into
the step (ref ``executor.py:1527-1533``), so the step's own statistics show
the NaN.  ``FLAGS_check_nan_inf`` checks every float output of every op
after it runs (one host sync an op) and prints the Fluid op that made a
non-finite value (ref ``executor.py:814-876``).

Memory: an ``elementwise_add`` of a bias into a ``mul`` / ``matmul``
product that dies at the add runs in place when no autograd graph and no
numerics statistics read the product (``_Plan._inplace_adds``), as the
static memory plan and the reference's compiler reuse that buffer; a served
LM head then holds its logits once.

Collective mode (ref ``executor.py:925-1087``): a program the collective
transpilers stamped (``_attrs["collective"] = {"nranks", "rank"}``) runs
over the ``dp`` ranks: the ``dp`` axis of ``parallel.current_mesh()``
(virtual ranks allowed), else the visible cards; fewer devices than ranks
raise.  Batched feeds split on dim 0 (a batch the ranks do not divide
raises), scalar feeds replicate, rank r draws from ``seed + r * 1000003``.
The plan is cut into segments at its collective ops (``OpInfo.
collective``): each segment runs for rank 0, then rank 1, ..., then the
collective's group lowering runs over every rank, so one rank's activations
and autograd graphs are alive at a time (a GradAllReduce program's first
collective follows the backward).  Every rank reads the scope's one value
of each persistable, and no rank's write reaches the scope before the step
ends: there the trainable parameters come from rank 0
(``verify_replicas`` compares every rank's bit for bit), other floating
read-write persistables become the mean over ranks and integer ones the
maximum, save those every rank computes alike (``_Plan.
_rank_invariant``: an Adam moment of an all-reduced gradient), whose mean
is each rank's value.  Fetches come back stacked per rank (``f[None]``
over ``dp``), numerics statistics as one row a rank, and the dispatch
ledger counts one step a run.  The plan key carries the collective stamp
and the ranks' devices.  A collective's grad op is its group VJP
(``registry.collective_grad_info``), a collective of its own.  The comms
plane (ref ``executor.py:406-432, 1553-1566, 1718-1740``, under
``FLAGS_comms_telemetry``): ``collective.launch`` fires before each
collective step; after one that did not fail the step counts in
``paddle_tpu_collective_launches_total{kind="shard_map_step"}``, the plan's
byte cells are bumped, and from a plan's second step on the step's record
(the collective segment's two marks, CUDA events on the card) goes to
``analysis.comms.MONITOR`` off the training thread.

SPMD mode (ref ``executor.py:954-960, 1395, 1543-1566, 1718``): a
``CompiledProgram`` configured by ``with_data_parallel`` /
``with_distributed`` / ``with_gspmd`` runs its optimized program through
``parallel.spmd.lower_program`` (once a plan) into a per-rank program over
the compiled program's mesh (virtual ranks allowed), which runs like a
collective program over every rank of the mesh.  Feeds are split by their
layouts, the scope's persistables are read as each rank's block (a global
tensor sliced, a ``parallel.spmd.ShardedValue`` taken), the step writes
back replicated values from rank 0 and sharded ones as ``ShardedValue`` s,
and fetches come back global (gathered).  Each lowered collective counts
its sharding-plan edges' payload in ``paddle_tpu_collective_bytes_total``
when it runs; collectives outside the plan count in
``paddle_tpu_gspmd_unplanned_bytes_total{reason}``.  Numerics statistics
are not taken in SPMD mode yet (ROADMAP): a partitioned run under
``FLAGS_numerics`` raises.

Several processes (ref ``executor.py:2262-2345``): after
``distributed.init_parallel_env`` the ranks of a mesh span processes
(``parallel.mesh``; with no dp mesh a collective program runs one rank a
process's card).  A process runs its own ranks' segments only and feeds
its own batch (in SPMD mode its block of each split feed dim, joined
across the processes before the layout's split); each collective op and
the step's end exchange the ranks' tensors through ``distributed.xproc``,
so every process holds what one process of virtual ranks would: the same
bits, fetches global on every process.  ``FLAGS_gang_step_barrier``
clears the gang coordinator's fingerprint barrier before each collective
step (``GangFingerprintError`` before dispatch), and the comms plane's
gate posts each step's arrival to the coordinator for the straggler wait
(telemetry that never fails a step).

The reference's donation aliasing check has nothing to guard: the eager
step donates no buffer.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import amp as _amp
from .. import memory as _memory
from .. import monitor as _monitor
from .. import resilience as _resil
from ..analysis import fusion as _fusion
from ..analysis import numerics as _numerics
from ..analysis.device_profile import step_annotation
from ..distributed import xproc as _xproc
from ..kernels import dropout as _dropout
from . import registry
from .core import (Program, Variable, default_main_program, grad_var_name,
                   sub_block_io)
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
#: collective steps, under the reference's label (ref executor.py:61-64,218)
_COLLECTIVE_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_collective_launches_total",
    "host-launched collectives by kind (a collective-mode step counts "
    "once under kind=shard_map_step)", ("kind",))
_COLL_STEP = _COLLECTIVE_CTR.labels(kind="shard_map_step")
_COLL_BARRIER = _COLLECTIVE_CTR.labels(kind="step_barrier")
#: collectives whose output is one value on every rank of their ring
_REPLICATING = ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
                "c_allreduce_prod", "c_broadcast", "c_allgather")

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


def _resolve_comms(plan, feeds, nranks):
    """Once per collective plan: the static comms plan at the real feed
    batch and its bound byte-counter cells (ref executor.py:406-432).
    ``(plan, cells)`` or None; comms modeling never breaks a dispatch."""
    try:
        from ..analysis import comms
        if plan.spmd is not None:
            # a partitioned program: its reshard plan projected, one cell
            # an edge (ref executor.py:417-425)
            from ..analysis.sharding import as_comms_plan
            cplan = as_comms_plan(plan.spmd.plan)
            return cplan, comms.bound_byte_cells(cplan)
        cplan = comms.plan_comms(plan.program, plan.fetch_names,
                                 batch_size=_feed_batch(feeds),
                                 nranks=nranks)
        if cplan is None:
            return None
        return cplan, comms.bound_byte_cells(cplan)
    except Exception:
        return None


def _mark(device: torch.device):
    """A point on the rank's timeline: a recorded CUDA event on the card,
    the host clock elsewhere (the host runs the ops as it launches them)."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return time.perf_counter()


def _sync_state(vals: List[torch.Tensor]) -> torch.Tensor:
    """A non-parameter read-write persistable's value after a collective
    step (ref executor.py:1031-1068): the mean over the ranks for floating
    types, summed in float64 so that equal values come back exactly; the
    maximum for the rest (counters advance alike).  On rank 0's device."""
    if len(vals) == 1:
        return vals[0]
    dev = vals[0].device
    if vals[0].is_floating_point():
        acc = vals[0].to(torch.float64)
        for v in vals[1:]:
            acc += v.to(dev, torch.float64)
        return (acc / len(vals)).to(vals[0].dtype)
    out = vals[0]
    for v in vals[1:]:
        out = torch.maximum(out, v.to(dev))
    return out


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
    bf16 AMP flag, ``rank`` / ``nranks`` the rank a collective-mode run
    runs for and the ranks of its ``dp`` axis (0 / 1 otherwise); in SPMD
    mode ``mesh`` is the ranks' mesh and ``coords`` the rank's coordinate
    on each of its axes."""

    def __init__(self, device: torch.device, seed: int, amp: bool = False,
                 rank: int = 0, nranks: int = 1, mesh=None, coords=None):
        self.device = device
        self.mesh = mesh
        self.coords = coords or {}
        self._seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self._generator = None
        self.amp = bool(amp)
        self.rank = rank
        self.nranks = nranks
        self._counter = 0
        # output name of a stateful_rng op -> the counter before it ran;
        # ("loop", sub-block idx) -> (counter, generator state) where a
        # loop began (ops/control_flow_ops.py)
        self.rng_marks: Dict[Any, Any] = {}

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
        self.comms_info = _UNSET
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
                info = registry.get_op_info(op.attrs["__fwd_type__"])
                if info.collective:
                    # a group VJP over every rank: no graph to pair with
                    self.ops.append((op, registry.collective_grad_info(
                        info, op.type)))
                    continue
                self.ops.append((op, info))
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
            info = registry.get_op_info(op.type)
            self.ops.append((op, info))
            if not info.collective:
                fwd_at.setdefault(_fwd_key(op), []).append(i)
        persistable = {n for n, v in block.vars.items() if v.persistable}
        persistable_float = {n for n in persistable
                             if "float" in str(block.vars[n].dtype)}
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
            # a name read or written only inside a sub-block (a body nested
            # in a body included) lives until the op that owns the block
            for n in sub_block_io(op):
                last[n] = max(last.get(n, -1), i)
            for n in op.output_arg_names():
                if n:
                    written.add(n)
                    last[n] = max(last.get(n, -1), i)
        self.free_after: List[List[str]] = [[] for _ in self.ops]
        for n, i in last.items():
            if n not in keep:
                self.free_after[i].append(n)
        self.persist_out = sorted(written & persistable)
        # SPMD mode: the lowering's layouts (parallel.spmd.SpmdLayout)
        self.spmd = None
        self.persistables = sorted(persistable & set(last))
        # collective mode: the collective ops the schedule cuts the plan
        # at, and the trainable parameters every rank updates alike
        self.collective_at = [i for i, (_, info) in enumerate(self.ops)
                              if info.collective]
        self.trainable_out = frozenset(
            n for n in self.persist_out
            if block.vars[n].is_parameter and block.vars[n].trainable)
        self.rank_invariant = self._rank_invariant(persistable)
        self.inplace_add = self._inplace_adds(keep)
        # every name an op of the step writes (the numerics plane's
        # ``written``), and the float read-write persistables the step
        # also reads, in order (the ``numerics.poison`` drill's targets)
        self.written = frozenset(written)
        read = set()
        for op, _ in self.ops:
            for ns in op.inputs.values():
                read.update(n for n in ns if n)
        self.poison_targets = [n for n in self.persist_out
                               if n in read and n in persistable_float]

    def _rank_invariant(self, persistable) -> frozenset:
        """Collective mode: the names every rank computes alike, so that
        their step-end mean over the ranks is each rank's own value and
        needs no exchange (an Adam moment of an all-reduced gradient).
        The scope's persistables as the step starts, the outputs of the
        collectives that hand every rank one value, and what an op makes
        of such names alone; a random op, another collective (a split, a
        reduce-scatter, a group VJP) or an op over a sub-block makes its
        outputs rank-dependent."""
        inv = set(persistable)
        for op, info in self.ops:
            if op.type in _REPLICATING and not op.attrs.get("mesh_axis"):
                same = True
            elif info.collective or info.stateful_rng or \
                    op.type == "c_split" or "sub_block" in op.attrs:
                same = False
            else:
                same = all(n in inv for ns in op.inputs.values()
                           for n in ns if n)
            for n in op.output_arg_names():
                if n:
                    (inv.add if same else inv.discard)(n)
        return frozenset(inv)

    def _inplace_adds(self, keep) -> frozenset:
        """The ``elementwise_add`` ops that may add into their X: X is the
        fresh product of a ``mul`` / ``matmul`` and dies at the add, and
        neither op's autograd graph is kept.  Running them in place keeps
        one output buffer where the static memory plan counts one (the
        reference's compiler reuses the dying buffer the same way); out of
        place, a served LM head holds its [B, T, vocab] logits twice."""
        producer: Dict[str, int] = {}
        out = set()
        for i, (op, _) in enumerate(self.ops):
            if (op.type == "elementwise_add" and i not in self.fwd_of
                    and i not in self.wanted):
                x = op.inputs.get("X", [None])[0]
                j = producer.get(x)
                if (x and x not in keep and x in self.free_after[i]
                        and j is not None and j not in self.wanted
                        and self.ops[j][0].type in ("mul", "matmul")):
                    out.add(i)
            for n in op.output_arg_names():
                if n:
                    producer[n] = i
        return frozenset(out)


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
        # collective mode: compare every rank's trainable parameters bit
        # for bit at the end of each step (one host sync a parameter) and
        # raise on a difference; the last step's count in replica_report
        self.verify_replicas = False
        self.replica_report: Optional[Dict[str, Any]] = None
        # the gang's socket client (resolved at the first collective step),
        # the step barrier's count, and the comm gate's failure latch
        self._gang = _UNSET
        self._barrier_step = 0
        self._comm_gate_fails = 0
        self._comm_gate_off = False
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
        # a pserver program is a blocking host loop, not a block of ops
        # (ref executor.py:1396-1403, listen_and_serv_op.cc RunImpl)
        lsv = next((op for op in program.global_block().ops
                    if op.type == "listen_and_serv"), None)
        if lsv is not None:
            from ..distributed import ps as _ps
            return _ps.run_pserver(lsv, scope)
        feed = feed or {}
        fetch_names = tuple(f.name if isinstance(f, Variable) else f
                            for f in (fetch_list or []))
        feed_names = tuple(sorted(feed))
        feed_sigs = tuple(_feed_sig(feed[n]) for n in feed_names)
        num_mode = _numerics.mode()
        check_nan = bool(get_flags("FLAGS_check_nan_inf")
                         ["FLAGS_check_nan_inf"])
        # collective mode: the transpiler's stamp and the ranks' devices
        # key the plan too (neither is in the program's fingerprint), so a
        # plan built for one rank count never runs another
        spmd_mesh = getattr(compiled, "_mesh", None)
        coll = None if spmd_mesh is not None else \
            program._attrs.get("collective")
        span = None
        if spmd_mesh is not None:
            devices = self._spmd_devices(spmd_mesh)
            span = _xproc.span_of(spmd_mesh)
            if num_mode != "off":
                raise NotImplementedError(
                    "FLAGS_numerics statistics of a partitioned (SPMD) "
                    "program are not taken yet (ROADMAP Queue 1 item 3 "
                    "(i)); set FLAGS_numerics to 'off'")
        else:
            devices, span = self._collective_devices(coll) if coll \
                else (None, None)
        coll_tok = None if devices is None else (
            tuple(sorted((coll or {}).items())), tuple(map(str, devices)))
        key = (program.fingerprint(), feed_names, feed_sigs, fetch_names,
               scope._serial, None if compiled is None else compiled._serial,
               _fusion.config_token(), num_mode, check_nan, coll_tok)
        stats = self._stats
        with self._lock:
            plan = self._plans.get(key)
            fresh = plan is None
            if fresh:
                stats.incr("cache_misses")
                stats.incr("traces")
                feed_shapes = {n: _feed_sig(v)[0] for n, v in feed.items()}
                if spmd_mesh is not None:
                    layout = compiled._lower(fetch_names, feed_shapes,
                                             device=self.device)
                    run_prog = layout.program
                elif compiled is not None:
                    run_prog = compiled._optimized(
                        fetch_names, feed_shapes, device=self.device)
                else:
                    # the plain-Program fusion slot, at the real batch
                    run_prog = _fusion.fuse_program(
                        program, fetch_names, feed_shapes=feed_shapes,
                        device=self.device)
                if spmd_mesh is not None:
                    plan = _Plan(run_prog, [layout.fetches[f][0]
                                            for f in fetch_names])
                    plan.spmd = layout
                else:
                    plan = _Plan(run_prog, fetch_names)
                self._plans[key] = plan
            else:
                stats.incr("cache_hits")
            self._step_seed += 1
            step_seed = self._step_seed
        seed_val = seed if seed is not None else (
            program.random_seed * 1000003 + step_seed)
        if devices is None:
            env = {n: self._to_device(v) for n, v in feed.items()}
            feeds = list(env.values())
        else:
            ranks = plan.spmd.split_feeds(
                self._global_feed(feed, plan.spmd, span), self._to_device,
                span.local) if plan.spmd is not None else \
                self._split_feeds(feed, devices, span.local)
            feeds = list(feed.values())
            # the gang's step barrier refuses a diverged program before
            # any collective (ref executor.py:1552); the drill site and
            # the comms plane's launch record precede the collective step
            # (ref executor.py:1553-1566)
            self._maybe_step_barrier(plan)
            _resil.maybe_inject("collective.launch")
            comms_note = self._comms_prelaunch(plan, feeds, len(devices))
        num = rw_in = None
        if devices is None and num_mode != "off":
            num = _numerics.StepStats(
                num_mode, plan.written, feed_names, plan.persist_out,
                plan.program._attrs.get("numerics"))
            if num_mode == "full":
                rw_in = [scope.find_var(n) for n in plan.persist_out]
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
                if devices is not None:
                    state, fetched, num, segment, moved = \
                        self._run_collective(
                            plan, devices, ranks, scope, seed_val, num_mode,
                            check_nan, feed_names, span)
                else:
                    read = functools.partial(self._read, scope, plan.block)
                    self._maybe_poison(plan, scope, env, read)
                    run_plan(plan, LowerCtx(self.device, seed_val, plan.amp),
                             env, read, observe=num, check_nan=check_nan)
                    state = fetched = env
                if devices is None and num is not None:
                    for n in plan.written:
                        if n in env:
                            num.offer(n, env[n])
                    layout, packed = num.finish(
                        plan.persist_out, rw_in or (),
                        [env.get(n) for n in plan.persist_out],
                        device=self.device, force=True)
                    num = (layout, _numerics.StatsCopy(packed))
        except Exception as e:
            self._raise_with_forensics(e, key, plan, scope, feeds)
        tdisp = time.perf_counter()
        if record:
            torch.cuda.synchronize(self.device)
            _hbm().record_xla_plan(
                ",".join(fetch_names) or "<block>", _hbm()._MeasuredPlan(
                    before, torch.cuda.max_memory_allocated(self.device)))
        if devices is not None:
            self._comms_account(comms_note, step_id, segment, fresh, tdisp,
                                moved, plan.spmd is not None)
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
        if num is not None:
            # in flight: the engine decodes the frame once its copy's
            # event has completed, so this never waits on the card
            _numerics.ENGINE.note_step(step_id, num[1], num[0])
        if plan.persist_out:
            scope.set_vars({n: state[n] for n in plan.persist_out})
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
        fetches = [fetched[n] if n in fetched
                   else self._read(scope, plan.block, n)
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

    def _maybe_poison(self, plan, scope, env, read) -> None:
        """The ``numerics.poison`` drill (ref executor.py:1527-1533): when
        the site fires, the first float read-write persistable the step
        reads enters it multiplied by NaN, as an overflow inside the step
        would leave it; the step's own statistics then show it.  ``env``
        and ``read`` are the rank's (in collective mode, the last rank's
        only)."""
        try:
            _resil.maybe_inject("numerics.poison")
        except _resil.InjectedFault:
            for n in plan.poison_targets:
                v = scope.find_var(n)
                if isinstance(v, torch.Tensor) and v.dim() >= 1:
                    env[n] = read(n) * float("nan")
                    return

    # -- collective mode (ref executor.py:1010-1087) -------------------------
    def _collective_devices(self, coll):
        """The devices of a collective program's ranks and the processes
        that run them (a ``distributed.xproc.ProcessSpan``): the ``dp``
        axis of the current mesh (virtual ranks allowed), else the visible
        cards, or every process's card after ``init_parallel_env``.  Fewer
        devices than ``nranks`` raise (ref executor.py:1025-1028): there
        is no fallback to fewer ranks."""
        from ..distributed.env import is_multiprocess
        from ..parallel.mesh import current_mesh, data_parallel_mesh
        mesh = current_mesh()
        if (mesh is None or "dp" not in mesh.axis_names) and \
                is_multiprocess():
            mesh = data_parallel_mesh()
        if mesh is not None and "dp" in mesh.axis_names:
            devs, where = mesh.axis_devices("dp"), "the current mesh's dp axis"
            span = _xproc.span_of(mesh, "dp")
        else:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())] \
                if torch.cuda.is_available() else []
            where = "the visible CUDA devices"
            span = None
        nranks = int(coll.get("nranks", 0) or 0) or len(devs)
        if not 1 <= nranks <= len(devs):
            raise ValueError(
                f"collective mode needs {nranks} devices, have {len(devs)} "
                f"({where}); set a dp mesh (parallel.set_mesh(make_mesh("
                f"{{'dp': {nranks}}}, devices)))")
        devs = devs[:nranks]
        if any(d.type != self.device.type for d in devs):
            raise ValueError(f"collective mode: the ranks' devices "
                             f"{devs} are not of this executor's device "
                             f"type ({self.device})")
        span = _xproc.ProcessSpan(span.procs[:nranks]) if span is not None \
            else _xproc.ProcessSpan([_xproc.process_index()] * nranks)
        return devs, span

    def _spmd_devices(self, mesh) -> List[torch.device]:
        """The ranks of an SPMD program: its mesh's devices in flat order,
        of this executor's device type (no fallback to another)."""
        devs = [torch.device(d) for d in mesh.devices.flat]
        if any(d.type != self.device.type for d in devs):
            raise ValueError(f"SPMD mode: the mesh's devices {devs} are not "
                             f"of this executor's device type "
                             f"({self.device})")
        return devs

    def _split_feeds(self, feed, devices, local) -> List[Optional[Dict]]:
        """Each rank's feeds: a batched feed split on dim 0, a scalar one
        replicated (ref executor.py:1071-1072).  Over several processes a
        process's feed is its own ranks' batch (``local``, the ranks it
        runs; another process's entries are None).  A batch the ranks do
        not divide raises."""
        n = len(local)
        envs: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(devices)
        for r in local:
            envs[r] = {}
        for name, v in feed.items():
            t = self._to_device(v)
            if t.dim() == 0:
                for r in local:
                    envs[r][name] = t.to(devices[r])
                continue
            if t.shape[0] % n:
                raise ValueError(
                    f"collective mode: feed {name!r} has batch "
                    f"{t.shape[0]}, which {n} ranks do not divide")
            m = t.shape[0] // n
            for i, r in enumerate(local):
                envs[r][name] = t[i * m:(i + 1) * m].to(devices[r])
        return envs

    def _global_feed(self, feed, layout, span) -> Dict[str, Any]:
        """SPMD over several processes: each process feeds its block of a
        feed's split dim (its half of the batch over a dp axis that spans
        two processes, ref ``_to_global_arrays``); the global feed is the
        processes' blocks joined on that dim, in process order.  A
        replicated feed is every process's own."""
        if not span.multi:
            return feed
        names = [n for n in sorted(feed)
                 if any(layout.feed_specs.get(n) or ())]
        mine = {span.local[0]: [self._to_device(feed[n]) for n in names]}
        got = span.exchange(mine, self.device)
        firsts = sorted({span.procs.index(p) for p in set(span.procs)})
        out = dict(feed)
        for j, n in enumerate(names):
            spec = layout.feed_specs[n]
            d = next(i for i, a in enumerate(spec) if a)
            out[n] = torch.cat([got[r][j] for r in firsts], d)
        return out

    def _rank_reader(self, scope, block, device):
        """A rank's reader of the scope: the one value of a persistable,
        on the rank's device (copied once a step for a rank on another
        device).  Nothing a rank writes reaches the scope before the
        step ends, so no rank reads another's update."""
        copies: Dict[str, torch.Tensor] = {}

        def read(name):
            v = self._read(scope, block, name)
            if v.device == device:
                return v
            if name not in copies:
                copies[name] = v.to(device)
            return copies[name]
        return read

    def _run_collective(self, plan, devices, envs, scope, seed_val,
                        num_mode, check_nan, feed_names, span):
        """One collective step over the ranks of ``devices``.  The plan is
        cut into segments at its collective ops: each segment runs for rank
        0, then rank 1, ..., then the collective runs over all ranks, so
        one rank's activations and autograd graphs are alive at a time.
        Rank r draws from ``seed + r * 1000003`` (mod 2**32, ref
        executor.py:1046-1048).  At the end the trainable parameters come
        from rank 0 and the other read-write persistables are synced
        (:func:`_sync_state`); the fetches come back stacked per rank, in
        the reference's shapes.

        Over several processes (``span``, a ``distributed.xproc.
        ProcessSpan``) a process runs its own ranks' segments only; each
        collective op and the step's end exchange the ranks' tensors
        between the processes, and the lowering runs over every rank on
        this process's device, so every process holds what one process of
        virtual ranks would (ref ``process_allgather``, executor.py:
        2262-2280: fetches come back global everywhere).

        Returns (state, fetched, numerics, segment, moved): the
        persistables to write, the fetches, the stacked numerics frame,
        the collective segment's two timeline marks (None without a
        collective op) and the lowered collectives' plan edges."""
        n = len(devices)
        local = span.local
        here = self.device
        devs = [d if span.is_local(r) else here
                for r, d in enumerate(devices)]
        layout = plan.spmd
        if layout is not None:
            from ..parallel.mesh import rank_coords
            ctxs = [LowerCtx(d, (seed_val + r * 1000003) & 0xFFFFFFFF,
                             plan.amp, rank=r, nranks=n, mesh=layout.mesh,
                             coords=rank_coords(layout.mesh, r))
                    for r, d in enumerate(devs)]
            read_global = functools.partial(self._read, scope, plan.block)
            reads = [layout.reader(scope, read_global, r)
                     if span.is_local(r) else None for r in range(n)]
        else:
            ctxs = [LowerCtx(d, (seed_val + r * 1000003) & 0xFFFFFFFF,
                             plan.amp, rank=r, nranks=n)
                    for r, d in enumerate(devs)]
            reads = [self._rank_reader(scope, plan.block, d)
                     if span.is_local(r) else None
                     for r, d in enumerate(devs)]
        stats = [None] * n
        if num_mode != "off":
            for r in local:
                stats[r] = _numerics.StepStats(
                    num_mode, plan.written, feed_names, plan.persist_out,
                    plan.program._attrs.get("numerics"))
        rw_in = [scope.find_var(k) for k in plan.persist_out] \
            if num_mode == "full" else ()
        self._maybe_poison(plan, scope, envs[local[-1]], reads[local[-1]])
        graphs: List[Dict[int, registry.Forward]] = [{} for _ in devices]
        cuts = plan.collective_at
        marks = []
        moved: List[tuple] = []
        try:
            lo = 0
            for c in cuts + [len(plan.ops)]:
                for r in local:
                    _run_ops(plan, lo, c, ctxs[r], envs[r], reads[r],
                             graphs[r], stats[r], check_nan)
                if c == len(plan.ops):
                    break
                if c == cuts[0]:
                    marks.append(_mark(here))
                _run_collective_op(plan, c, ctxs, envs, reads, stats,
                                   check_nan, moved, span)
                if c == cuts[-1]:
                    marks.append(_mark(here))
                lo = c + 1
        finally:
            for g in graphs:
                g.clear()
        # the step's end: what every rank must see of every other
        verify = self.verify_replicas
        # the non-parameter state the ranks may hold apart is averaged;
        # what every rank computes alike is its own mean
        synced = [k for k in plan.persist_out
                  if layout is None and k not in plan.trainable_out and
                  k not in plan.rank_invariant]
        checked = [k for k in plan.persist_out if verify and
                   k in plan.trainable_out and
                   (layout is None or not any(layout.scope_specs.get(k)
                                              or ()))]
        fetch_keys = list(layout.fetches.values()) if layout is not None \
            else [(k, None) for k in plan.fetch_names]
        packed: Dict[int, Any] = {}
        layout_ = None
        for r in local:
            if stats[r] is None:
                break
            env = envs[r]
            for k in plan.written:
                if k in env:
                    stats[r].offer(k, env[k])
            layout_, packed[r] = stats[r].finish(
                plan.persist_out, rw_in,
                [env.get(k) for k in plan.persist_out], device=devs[r],
                force=True)
        mine = {r: ([envs[r][k] for k in synced] +
                    [envs[r][k] for k in checked] +
                    [envs[r][k] if k in envs[r] else reads[r](k)
                     for k, _ in fetch_keys] +
                    ([packed[r]] if packed else []))
                for r in local}
        every = span.exchange(mine, here)
        ns, nc = len(synced), len(checked)
        num = None
        if packed:
            # one row a rank: the frame adds counts, maxes absmax
            num = (layout_, _numerics.StatsCopy(torch.stack(
                [every[r][-1].to(here) for r in range(n)])))
        state = {}
        for j, k in enumerate(synced):
            state[k] = _sync_state([every[r][j] for r in range(n)])
        mismatched = [k for j, k in enumerate(checked) if not all(
            torch.equal(every[0][ns + j], every[r][ns + j].to(
                every[0][ns + j].device)) for r in range(1, n))]
        first = local[0]
        for k in plan.persist_out:
            if k in state:
                continue
            if layout is not None:
                state[k] = layout.assemble(
                    k, [envs[r][k] if span.is_local(r) else None
                        for r in range(n)])
            else:
                state[k] = envs[first][k]
        if verify:
            self.replica_report = {"tensors": len(plan.trainable_out),
                                   "ranks": n, "mismatched": mismatched}
            if mismatched:
                raise RuntimeError(
                    f"collective mode: the ranks' trainable parameters "
                    f"differ after the step: {mismatched}")
        fetched = {}
        for j, (f, (k, _)) in enumerate(zip(
                layout.fetches if layout is not None else plan.fetch_names,
                fetch_keys)):
            vals = [every[r][ns + nc + j] for r in range(n)]
            if layout is not None:
                fetched[f] = layout.gather(f, [v.to(here) for v in vals])
            else:
                fetched[f] = torch.cat([v[None].to(here) for v in vals])
        return state, fetched, num, (tuple(marks) if marks else None), \
            moved

    def _maybe_step_barrier(self, plan) -> None:
        """``FLAGS_gang_step_barrier`` (ref executor.py:1932-1985): every
        collective step first clears the gang coordinator's step barrier
        with the program's collective fingerprint (socket backend), so a
        rank whose program diverged refuses with ``GangFingerprintError``
        before any collective, and a dead rank refuses with
        ``GangDegradedError`` within the barrier's timeout."""
        from ..flags import get_flags
        fl = get_flags(["FLAGS_gang_step_barrier",
                        "FLAGS_gang_step_barrier_timeout_s"])
        if not fl["FLAGS_gang_step_barrier"]:
            return
        gang = self._resolve_gang()
        if gang is None:
            return
        fp = getattr(plan, "gang_fingerprint", _UNSET)
        if fp is _UNSET:
            try:
                from ..analysis.verifier import collective_fingerprint
                fp = collective_fingerprint(plan.program)
            except Exception:
                fp = None
            plan.gang_fingerprint = fp
        self._barrier_step += 1
        gang.step_barrier(
            self._barrier_step, fingerprint=fp,
            timeout_s=float(fl["FLAGS_gang_step_barrier_timeout_s"]))
        _COLL_BARRIER.inc()

    def _resolve_gang(self):
        """This process's socket gang client, or None (no launcher
        environment, the file backend, one rank).  An unreachable
        coordinator raises (``GangRendezvous.from_env``)."""
        gang = self._gang
        if gang is _UNSET:
            try:
                from ..distributed.env import GangRendezvous
                gang = GangRendezvous.from_env()
            except ConnectionError:
                raise
            except Exception:
                gang = None
            if gang is not None and not hasattr(gang, "step_barrier"):
                gang = None         # the file backend has no liveness plane
            self._gang = gang
        return gang

    def _comms_prelaunch(self, plan, feeds, nranks):
        """``FLAGS_comms_telemetry``: the plan's comms plan and byte cells
        (resolved once per plan), the launch time and the comm gate's
        straggler wait (:meth:`_comm_gate_wait`), or None.  Never raises:
        telemetry must not fail a step."""
        from ..flags import get_flags
        try:
            if not get_flags("FLAGS_comms_telemetry")[
                    "FLAGS_comms_telemetry"]:
                return None
            info = plan.comms_info
            if info is _UNSET:
                info = plan.comms_info = _resolve_comms(plan, feeds, nranks)
            if info is None:
                return None
            wait_ms = self._comm_gate_wait()
            return info[0], info[1], time.perf_counter(), wait_ms
        except Exception:
            return None

    def _comm_gate_wait(self) -> Optional[float]:
        """The pre-collective timestamp exchange (ref executor.py:
        1991-2080): post this rank's arrival to the coordinator's
        ``comm_gate`` and wait (at most ``FLAGS_comms_gate_timeout_s``)
        for every live peer's; returns the straggler wait in ms, or None
        without a socket gang.  Telemetry only: it never fails a step,
        and it disarms itself after 3 failures in a row."""
        if self._comm_gate_off:
            return None
        from ..analysis import comms as _comms_mod
        try:
            gang = self._resolve_gang()
        except ConnectionError:
            self._comm_gate_off = True
            _comms_mod.COMMS_GATE_CTR.inc(1, outcome="disabled")
            return None
        if gang is None or not hasattr(gang, "comm_gate"):
            return None
        from ..flags import get_flags
        timeout_s = float(get_flags("FLAGS_comms_gate_timeout_s")
                          ["FLAGS_comms_gate_timeout_s"])
        # wall-clock arrivals compared across processes: exact on one
        # host; across hosts only as good as the clocks' sync
        t_arrive = time.time()
        t0 = time.perf_counter()
        try:
            resp = gang.comm_gate(t_arrive, timeout_s=timeout_s)
        except Exception:
            self._note_gate_failure("error")
            return None
        ts = {int(r): float(t) for r, t in (resp.get("ts") or {}).items()}
        released = bool(resp.get("released"))
        if not released and time.perf_counter() - t0 >= 0.8 * timeout_s:
            # a timeout-scale partial view is a stall the gate paid
            self._note_gate_failure("timeout")
            return None
        _comms_mod.COMMS_GATE_CTR.inc(
            1, outcome="released" if released else "partial")
        self._comm_gate_fails = 0
        if not ts:
            return None
        return max(0.0, (max(ts.values()) - t_arrive) * 1e3)

    def _note_gate_failure(self, kind: str) -> None:
        """Count a comm-gate failure toward the 3-strike latch."""
        from ..analysis import comms as _comms_mod
        _comms_mod.COMMS_GATE_CTR.inc(1, outcome=kind)
        self._comm_gate_fails += 1
        if self._comm_gate_fails >= 3:
            self._comm_gate_off = True
            warnings.warn(
                "comms telemetry: the pre-collective timestamp gate failed "
                f"3 times in a row (last: {kind}); disabling it for this "
                "executor (the wait reads 0, the wire time is measured)")
            _comms_mod.COMMS_GATE_CTR.inc(1, outcome="disabled")

    def _comms_account(self, note, step_id, segment, fresh, tdisp,
                       moved=(), spmd=False):
        """After a collective step that did not fail (ref
        executor.py:1718-1740): count the step, bump the byte cells, and
        hand the record to the comms monitor (off this thread), except for
        a plan's first step, as the reference skips a compiling call.  In
        SPMD mode the cells are the sharding plan's edges, bumped by the
        collectives that ran (``moved``); collectives outside the plan
        count under ``paddle_tpu_gspmd_unplanned_bytes_total``."""
        _COLL_STEP.inc()
        if note is None:
            return
        cplan, cells, t_launch, wait_ms = note
        try:
            if spmd:
                from ..parallel.spmd import UNPLANNED_BYTES_CTR
                for edges, reason, nbytes in moved:
                    for k in edges:
                        cell, payload = cells[k]
                        cell.inc(payload)
                    if reason:
                        UNPLANNED_BYTES_CTR.inc(nbytes, reason=reason)
            else:
                for cell, payload in cells:
                    cell.inc(payload)
            if not fresh:
                probe = segment[1] if segment is not None and \
                    hasattr(segment[1], "synchronize") else None
                from ..analysis import comms
                comms.MONITOR.note_launch(step_id, probe, cplan, t_launch,
                                          tdisp, wait_ms, segment)
        except Exception:
            pass     # telemetry must never fail a step

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
             read: Callable[[str], torch.Tensor], observe=None,
             check_nan: bool = False) -> None:
    """Run a block's plan op by op on ``env`` (name -> tensor): each op's
    outputs land in it, and each temporary leaves it after its last
    reader, handed to ``observe.offer`` first when the numerics plane
    watches the step.  ``read(name)`` gives an input that ``env`` lacks
    (the executor reads the scope).  ``check_nan`` is
    ``FLAGS_check_nan_inf``.  ``Executor.run`` and ``framework.function``'s
    callables run their blocks through it."""
    graphs: Dict[int, registry.Forward] = {}   # kept, by forward op
    try:
        _run_ops(plan, 0, len(plan.ops), ctx, env, read, graphs, observe,
                 check_nan)
    finally:
        graphs.clear()      # a raised error's traceback must not pin them


def _op_error(plan, op, e) -> RuntimeError:
    return RuntimeError(f"{type(e).__name__} while running op {op.type!r}: "
                        f"{e}\n  {_op_context(plan.block, op)}")


def _run_ops(plan: _Plan, lo: int, hi: int, ctx: LowerCtx, env, read,
             graphs, observe, check_nan) -> None:
    """Run ``plan.ops[lo:hi]`` for one rank (:func:`run_plan`); ``graphs``
    holds the rank's kept forward graphs across calls."""
    for i in range(lo, hi):
        op, info = plan.ops[i]
        try:
            if i in plan.inplace_add and observe is None:
                outs = _add_in_place(op, ctx, env, read)
            else:
                outs = None
            if outs is None:
                outs = _run_op(plan, i, op, info, ctx, env, read, graphs)
        except Exception as e:
            raise _op_error(plan, op, e) from e
        _take_outputs(plan, i, op, outs, env, observe, check_nan)


def _run_collective_op(plan, i, ctxs, envs, reads, stats, check_nan,
                       moved=None, span=None):
    """Collective op ``i`` over every rank at once: its group lowering
    takes the ranks' inputs and gives each rank its outputs.  Over several
    processes (``span``) the ranks' inputs are exchanged first, the
    lowering runs over all of them here, and this process keeps its own
    ranks' outputs.  An op the SPMD lowering emitted appends to ``moved``
    the sharding-plan edges it ran, or its reason and bytes when it is
    outside the plan."""
    op, info = plan.ops[i]
    local = span.local if span is not None else range(len(envs))
    mine = {}
    for r in local:
        env, read = envs[r], reads[r]
        # an output gradient nobody made is a zero cotangent (None)
        ins = {slot: [None if not n else env[n] if n in env else
                      None if slot.startswith("OG$") else read(n)
                      for n in names]
               for slot, names in op.inputs.items()}
        mine[r] = _amp.cast_ins(op.type, ins) if plan.amp else ins
    if span is not None and span.multi:
        slots = sorted(op.inputs)
        every = span.exchange(
            {r: [t for s in slots for t in ins[s]] for r, ins in mine.items()},
            ctxs[local[0]].device)
        ins_list = []
        for flat in every:
            it = iter(flat)
            ins_list.append({s: [next(it) for _ in op.inputs[s]]
                             for s in slots})
    else:
        ins_list = [mine[r] for r in local]
    try:
        outs_list = info.lower(ctxs, ins_list, op.attrs)
    except Exception as e:
        raise _op_error(plan, op, e) from e
    if moved is not None and ("edges" in op.attrs
                              or "unplanned" in op.attrs):
        nbytes = int(op.attrs.get("unplanned_payload") or 0)
        if op.attrs.get("unplanned") and not nbytes:
            # the logical payload: one rank's input a ring
            from ..parallel.mesh import mesh_axis_sizes
            ring = mesh_axis_sizes(ctxs[0].mesh).get(
                op.attrs.get("mesh_axis"), 1) if ctxs[0].mesh else 1
            xs = [ins["X"][0] for ins in ins_list if ins.get("X")]
            nbytes = sum(int(x.numel()) * x.element_size()
                         for x in xs) // max(ring, 1)
        moved.append((op.attrs.get("edges") or (),
                      op.attrs.get("unplanned"), nbytes))
    for r in local:
        _take_outputs(plan, i, op, outs_list[r], envs[r], stats[r], check_nan)


def _take_outputs(plan, i, op, outs, env, observe, check_nan) -> None:
    """Op ``i``'s outputs into ``env``, then its last-read temporaries out
    of it (handed to ``observe`` first)."""
    if check_nan and i not in plan.fwd_of:
        _sanitize_outputs(op, outs)
    for slot, names in op.outputs.items():
        for n, val in zip(names, outs.get(slot, [])):
            if n and val is not None:
                env[n] = val.detach()
    for n in plan.free_after[i]:
        v = env.pop(n, None)
        if observe is not None and v is not None:
            observe.offer(n, v)


def _add_in_place(op, ctx, env, read):
    """An ``elementwise_add`` of :meth:`_Plan._inplace_adds` into its dying
    X, or None when this run's operands do not allow it (AMP casts, a type
    promotion, a Y that broadcasts X itself).  Skipped while the numerics
    plane watches the step: its statistics read X's value when X dies."""
    from ..ops.common import broadcast_to_x
    if ctx.amp:
        return None
    x = env[op.inputs["X"][0]]
    yn = op.inputs["Y"][0]
    y = env[yn] if yn in env else read(yn)
    y = broadcast_to_x(x, y, op.attrs.get("axis", -1))
    if (torch.result_type(x, y) != x.dtype or x.device != y.device
            or torch.broadcast_shapes(x.shape, y.shape) != x.shape):
        return None
    return {"Out": [x.add_(y)]}


def _sanitize_outputs(op, outs) -> None:
    """``FLAGS_check_nan_inf`` (ref executor.py:814-832): name the Fluid op
    whose float output holds a non-finite value.  Each check reads one
    flag back to the host, so it waits for the op; a hit is printed and
    the step goes on, as the reference's debug print does."""
    for slot, vals in outs.items():
        for j, v in enumerate(vals):
            if not (isinstance(v, torch.Tensor) and v.is_floating_point()):
                continue
            if not bool(torch.isfinite(v).all()):
                print(f"FLAGS_check_nan_inf: non-finite value in output "
                      f"{slot}[{j}] of op {op.type}", flush=True)


def _run_op(plan, i, op, info, ctx, env, read, graphs):
    if info.raw:
        return _run_raw(ctx, plan.block, op, info, ExecState(
            {}, lambda n: env[n] if n in env else read(n)))
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
    return registry.lower_one(info, ctx, ins, op.attrs) or {}


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


# ---------------------------------------------------------------------------
# sub-blocks: the raw ops of control flow (ref executor.py:790, 854)
# ---------------------------------------------------------------------------

class ExecState:
    """What a raw op's lowering reads and writes: ``values`` (name ->
    tensor) over ``fallback(name)``, which gives a name ``values`` lacks
    (the enclosing block's state, or the scope) or raises ``KeyError``.
    A sub-block runs over a state of its own whose fallback is its
    parent's, so its writes stay in it until the op that owns the block
    hands its outputs on."""

    def __init__(self, values: Dict[str, Any],
                 fallback: Optional[Callable[[str], Any]] = None):
        self.values = values
        self.fallback = fallback

    def get(self, name: str):
        """The value of ``name``, or None when no state holds it."""
        if not name:
            return None
        if name in self.values:
            return self.values[name]
        if self.fallback is None:
            return None
        try:
            return self.fallback(name)
        except KeyError:
            return None

    def lookup(self, name: str):
        """The value of ``name`` (None for an empty name, an absent
        optional input); raises ``KeyError`` when no state holds it."""
        if not name:
            return None
        if name in self.values:
            return self.values[name]
        if self.fallback is None:
            raise KeyError(f"op input var {name!r} has no value: not fed, "
                           f"not in scope, and not produced by a preceding "
                           f"op")
        return self.fallback(name)

    def write(self, name: str, value) -> None:
        if name:
            self.values[name] = value


def _run_raw(ctx, block, op, info, state: ExecState):
    """A raw op over ``state``: its outputs by slot, as a lowering's."""
    info.lower(ctx, block, op, state)
    return {slot: [state.values.get(n) if n else None for n in names]
            for slot, names in op.outputs.items()}


def _floating(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def _check_differentiable(op, ins, outs) -> None:
    """A body replayed under ``torch.autograd``: an op that takes a value
    needing a gradient and gives floating outputs none of which carries
    one (a kernel launched outside autograd) would cut the gradient to
    zero quietly, so it raises, naming the op (as the dygraph tape does)."""
    if not any(_floating(v) and v.requires_grad
               for vs in ins.values() for v in vs):
        return
    fl = [v for vs in outs.values() for v in vs if _floating(v)]
    if fl and not any(v.requires_grad for v in fl):
        raise NotImplementedError(
            f"op {op.type!r}: autograd cannot differentiate its lowering "
            f"(its outputs carry no gradient), so a gradient through the "
            f"loop that holds it cannot be taken")


def run_block(ctx: LowerCtx, block, state: ExecState) -> None:
    """Run every op of a sub-block over ``state``, eagerly, in program
    order: a raw op on the state itself, any other through its lowering
    (under the program's AMP casts).  Nothing is freed and no graph is
    kept: a sub-block's temporaries live in ``state`` until the op that
    owns the block drops it, and a gradient through the block replays it
    under ``torch.autograd`` (``ops/control_flow_ops.py``), where an op
    that autograd cannot differentiate raises."""
    for op in block.ops:
        if op.type in ("feed", "fetch"):
            continue
        try:
            info = registry.get_op_info(op.type)
            if info.raw:
                info.lower(ctx, block, op, state)
                continue
            ins = {slot: [state.lookup(n) for n in names]
                   for slot, names in op.inputs.items()}
            if ctx.amp:
                ins = _amp.cast_ins(op.type, ins)
            outs = registry.lower_one(info, ctx, ins, op.attrs) or {}
            if torch.is_grad_enabled() and not info.no_grad:
                _check_differentiable(op, ins, outs)
        except Exception as e:
            if getattr(e, "_sub_block_op", False):
                raise
            err = RuntimeError(f"{type(e).__name__} while running op "
                               f"{op.type!r} of block {block.idx}: {e}\n  "
                               f"{_op_context(block, op)}")
            err._sub_block_op = True
            raise err from e
        for slot, names in op.outputs.items():
            for n, v in zip(names, outs.get(slot, [])):
                if n and v is not None:
                    state.write(n, v)
