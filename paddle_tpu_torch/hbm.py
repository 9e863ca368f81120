"""Runtime card-memory observability plane (the port of
``paddle_tpu/hbm.py``), the live companion of the static planner in
``analysis/memory.py``:

- :class:`HBMAccountant` — a per-step sampler fed by the executor at its
  step boundary.  The training thread pays one bounded deque append; a
  daemon worker samples the live bytes off the thread, joins them to the
  static plan of the dispatched program, and publishes the
  ``paddle_tpu_hbm_{live,peak,budget,headroom}_bytes`` gauges, a windowed
  peak, a plan-vs-measured drift gauge and a per-class attribution
  (params / optimizer state / activations / in-flight step bytes /
  checkpoint-capture copies / serving KV pages).  A headroom regression
  past ``FLAGS_hbm_headroom_regress_frac`` opens a profiler window.
- **OOM forensics** (:func:`oom_forensics`) — on a
  ``torch.cuda.OutOfMemoryError`` out of a step (and the ``memory.oom``
  drill site): the static plan's live set at the peak op, the top tensors
  with sizes and lifetimes, the budget / plan / measured / requested
  arithmetic, the residency summary and the serving census; counted in
  ``paddle_tpu_oom_total{site}``, traced as a ``memory.oom`` instant, and
  a profiler window (``trigger:"oom"``) when a sample dir is set.
- **One reader** — :func:`measure_live_bytes` (``memory.live_bytes``:
  ``torch.cuda.memory_allocated`` on the card).  ``record_xla_plan`` keeps
  the reference's name: the port has no XLA executable, so it records the
  allocator's measured peak over a plan's first run
  (``FLAGS_hbm_record_plans``).

Not ported: the gang digest keys (``hbm``/``hdrm``), which wait for the
gang.
"""

from __future__ import annotations

import collections
import os
import re
import tempfile
import threading
import time
import weakref
from typing import Any, List, Optional

from . import memory as _memory
from . import monitor as _monitor
from .analysis.memory import _fmt

__all__ = [
    "HBMAccountant", "ACCOUNTANT", "measure_live_bytes", "budget_bytes",
    "oom_forensics", "record_xla_plan", "plans_enabled",
    "set_ckpt_capture_bytes", "register_kv_pool", "register_census",
    "serving_census", "OOM_RISK_HEADROOM_FRAC",
]

# ---------------------------------------------------------------------------
# metric families
# ---------------------------------------------------------------------------

HBM_LIVE_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_hbm_live_bytes",
    "measured live device bytes at the most recent sampled step "
    "boundary (the runtime counterpart of the static planner's "
    "steady_bytes)")
HBM_PEAK_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_hbm_peak_bytes",
    "windowed peak watermark of the live-bytes samples (max over the "
    "last FLAGS_hbm_window samples) — the number to compare against "
    "the budget when deciding if a spike was close")
HBM_BUDGET_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_hbm_budget_bytes",
    "the HBM budget in force: FLAGS_memory_budget_mb when set, else "
    "the device allocator's bytes_limit where the backend exposes one "
    "(0 = no budget known; headroom is then unpublished)")
HBM_HEADROOM_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_hbm_headroom_bytes",
    "budget - live at the most recent sample (published only while a "
    "budget is known) — the measured admission signal the GSPMD "
    "sharding chooser and the serving width admission consume")
HBM_DRIFT_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_hbm_plan_drift",
    "measured live bytes over the static plan's steady_bytes for the "
    "most recently dispatched program (1.0 = the planner models the "
    "step exactly; sustained drift means unmodeled residency — a leak, "
    "a foreign allocator, or a planner gap)")
HBM_CLASS_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_hbm_class_bytes",
    "live-byte attribution by class at the most recent sample: "
    "params / opt_state (non-parameter persistables: moments, BN "
    "stats) / activations (unattributed remainder: temps, fetch "
    "buffers, XLA scratch) / lazy_fetch (in-flight throttle probes) / "
    "ckpt_capture (checkpoint snapshot copies in flight) / kv_pages "
    "(serving paged-KV pools)", ("cls",))
OOM_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_oom_total",
    "RESOURCE_EXHAUSTED events that went through OOM forensics, by "
    "site ('dispatch' = a real OOM out of a dispatched/compiling step, "
    "'injected' = the memory.oom fault drill)", ("site",))
HBM_SAMPLES_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_hbm_samples_total",
    "accountant samples by outcome ('ok' published, 'dropped' shed "
    "under backlog — gauges skip a beat, nothing blocks, 'error' the "
    "sample itself failed)", ("outcome",))
_SAMPLE_OK = HBM_SAMPLES_CTR.labels(outcome="ok")
_SAMPLE_DROPPED = HBM_SAMPLES_CTR.labels(outcome="dropped")
_SAMPLE_ERROR = HBM_SAMPLES_CTR.labels(outcome="error")

#: gangtop flags a rank <-- OOM-RISK when its measured headroom fraction
#: (hdrm / budget) falls under this (mirrored in tools/gangtop.py, which
#: must not import paddle_tpu)
OOM_RISK_HEADROOM_FRAC = 0.10

_CLASSES = ("params", "opt_state", "activations", "lazy_fetch",
            "ckpt_capture", "kv_pages")
_CLASS_CELLS = {c: HBM_CLASS_GAUGE.labels(cls=c) for c in _CLASSES}


# ---------------------------------------------------------------------------
# the one measured-bytes reader
# ---------------------------------------------------------------------------

def measure_live_bytes() -> int:
    """The one measured live-bytes reader (``memory.live_bytes``) of the
    accountant, the forensics dump and the smoke's prints."""
    return _memory.live_bytes()


def budget_bytes() -> int:
    """The budget in force: ``FLAGS_memory_budget_mb`` when set, else the
    card's total memory (``bytes_limit``; the host gives 0).  0 = no
    budget known."""
    from .flags import get_flags
    mb = int(get_flags("FLAGS_memory_budget_mb")["FLAGS_memory_budget_mb"])
    if mb > 0:
        return mb << 20
    stats = _memory.device_memory_stats()
    return int(stats.get("bytes_limit", 0) or 0)


# ---------------------------------------------------------------------------
# external contributors: checkpoint capture, serving KV pools, census fns
# ---------------------------------------------------------------------------

#: device bytes currently held by in-flight checkpoint-capture copies
#: (resilience.CheckpointDaemon.capture sets it, _save clears it) — a
#: capture-window live-bytes spike is attributed to ckpt_capture instead
#: of reading as a leak.  Plain float: single writer (the capturing
#: thread), torn reads impossible under the GIL.
_ckpt_capture_bytes = 0.0


def set_ckpt_capture_bytes(n: float) -> None:
    """Report the device bytes of checkpoint-snapshot copies currently
    in flight (0 when the daemon has materialized them to host)."""
    global _ckpt_capture_bytes
    _ckpt_capture_bytes = float(max(n, 0.0))
    _CLASS_CELLS["ckpt_capture"].set(_ckpt_capture_bytes)


#: live PagedKVCache pools (weak — a dead engine must not be kept alive
#: by its telemetry); the sampler attributes their device bytes to the
#: kv_pages class
_kv_pools: "weakref.WeakSet" = weakref.WeakSet()


def register_kv_pool(cache) -> None:
    """Register a serving ``PagedKVCache`` whose pool bytes the sampler
    attributes to the ``kv_pages`` class."""
    _kv_pools.add(cache)


def _kv_pool_bytes() -> int:
    total = 0
    for cache in list(_kv_pools):
        try:
            if not cache.buffers_alive():
                continue
            total += int(cache.pool_bytes())
        except Exception:
            continue
    return total


#: weak refs to serving ``statusz``-style callables — the forensics dump
#: folds their memory census (bucket widths, KV page occupancy) in when
#: a server is live at OOM time
_census_fns: List[Any] = []


def register_census(fn) -> None:
    """Register a bound method (weakly) returning a status dict; the OOM
    forensics dump includes every live registrant's snapshot."""
    try:
        ref = weakref.WeakMethod(fn)
    except TypeError:
        ref = weakref.ref(fn)
    _census_fns.append(ref)


def serving_census() -> List[dict]:
    """Snapshots from every live registered census callable (dead refs
    pruned); [] when no serving stack is up."""
    out, live = [], []
    for ref in _census_fns:
        fn = ref()
        if fn is None:
            continue
        live.append(ref)
        try:
            out.append(fn())
        except Exception:
            continue
    _census_fns[:] = live
    return out


# ---------------------------------------------------------------------------
# the accountant
# ---------------------------------------------------------------------------

class HBMAccountant:
    """Off-thread per-step HBM sampler (the CommsMonitor discipline).

    The executor hands every sampled step boundary a record (step id, a
    strong scope ref, the block's class name-sets + static-plan bytes,
    and the in-flight probe bytes); a daemon worker samples live device
    bytes, attributes them, and publishes the gauges — the training
    thread never blocks on the measurement.  The queue is bounded: under
    backlog the OLDEST record is shed (counted) — a skipped gauge beat,
    never a stalled step.
    """

    MAX_PENDING = 4

    def __init__(self):
        self._cv = threading.Condition()
        self._pending: collections.deque = collections.deque()  # guarded-by: _cv
        self._inflight = 0                                      # guarded-by: _cv
        self._thread: Optional[threading.Thread] = None         # guarded-by: _cv
        #: fast-path gates, written only by configure()
        self.enabled = True
        self.every_n = 1
        self.window = 16
        self.regress_frac = 0.0
        self._live_win: collections.deque = collections.deque(
            maxlen=16)                                          # guarded-by: _cv
        self._best_headroom: Optional[float] = None             # guarded-by: _cv
        self._headroom_obs = 0                                  # guarded-by: _cv
        self._regress_armed = True                              # guarded-by: _cv
        #: wall clock of the last gauge publish — metrics_digest drops
        #: the hbm/hdrm keys once this goes stale (the comms-plane
        #: frozen-median discipline)
        self.last_publish_wall = 0.0
        #: (live, headroom_or_None) of the last publish, for digest reads
        self.last_sample: Optional[tuple] = None

    #: samples the regression baseline ignores (warmup arrays, compile
    #: scratch) before the best-headroom watermark is trusted
    _REGRESS_WARMUP = 4

    def configure(self, enabled: bool, every_n: int, window: int,
                  regress_frac: float) -> None:
        with self._cv:
            self.every_n = max(int(every_n), 1)
            self.window = max(int(window), 1)
            if self._live_win.maxlen != self.window:
                self._live_win = collections.deque(self._live_win,
                                                   maxlen=self.window)
            self.regress_frac = max(float(regress_frac), 0.0)
            self._best_headroom = None
            self._headroom_obs = 0
            self._regress_armed = True
            # set LAST: the armed fast path must observe a fully
            # configured accountant
            self.enabled = bool(enabled)

    def _ensure_thread_locked(self):  # guarded-by-caller: _cv
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="pt-hbm-accountant")
            self._thread.start()

    # -- producer side (the executor's step boundary) ------------------------
    def note_step(self, step_id: int, scope, info: Optional[dict],
                  inflight_bytes: int = 0) -> None:
        """Queue one step boundary for off-thread sampling.  ``info`` is
        the executor's per-compiled-block resolution ({params,
        opt_state} name sets + the static plan's steady/peak bytes at
        the real batch), or None for foreign/unplanned programs."""
        with self._cv:
            self._ensure_thread_locked()
            if len(self._pending) >= self.MAX_PENDING:
                self._pending.popleft()
                _SAMPLE_DROPPED.inc()
            self._pending.append((step_id, scope, info,
                                  int(inflight_bytes)))
            self._cv.notify()

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Block until every queued sample is published (tests, bench,
        smoke teardown).  Returns False on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._pending or self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 0.1))
        return True

    # -- worker side ---------------------------------------------------------
    def _loop(self):
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                rec = self._pending.popleft()
                self._inflight += 1
            try:
                self._sample(*rec)
                _SAMPLE_OK.inc()
            except Exception:
                _SAMPLE_ERROR.inc()   # telemetry must never kill the worker
            finally:
                # drop the record BEFORE parking on the cv: it holds a
                # strong scope ref, and a retained last-note scope would
                # keep a dead workload's arrays (and their device bytes)
                # alive until the next sample arrived
                rec = None
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _sample(self, step_id: int, scope, info: Optional[dict],
                inflight_bytes: int):
        live = measure_live_bytes()
        # -- attribution: named scope arrays by class, external
        # contributors, remainder = activations/temps ---------------------
        params = opt = 0
        if info is not None and scope is not None:
            for name in info.get("params", ()):
                params += _scope_nbytes(scope, name)
            for name in info.get("opt_state", ()):
                opt += _scope_nbytes(scope, name)
        kv = _kv_pool_bytes()
        ckpt = int(_ckpt_capture_bytes)
        acts = max(live - params - opt - kv - ckpt - inflight_bytes, 0)
        _CLASS_CELLS["params"].set(float(params))
        _CLASS_CELLS["opt_state"].set(float(opt))
        _CLASS_CELLS["activations"].set(float(acts))
        _CLASS_CELLS["lazy_fetch"].set(float(inflight_bytes))
        _CLASS_CELLS["kv_pages"].set(float(kv))
        # ckpt_capture is set by its reporter (set_ckpt_capture_bytes)

        budget = budget_bytes()
        headroom = None
        if budget > 0:
            headroom = float(budget - live)
            HBM_BUDGET_GAUGE.set(float(budget))
            HBM_HEADROOM_GAUGE.set(headroom)
        else:
            # budget cleared mid-run: a frozen last headroom would feed
            # a scraper a bogus admission signal — 0 budget = unknown,
            # and the headroom series drops (its help-text contract)
            HBM_BUDGET_GAUGE.set(0.0)
            HBM_HEADROOM_GAUGE.fold({}, None)
        drift = None
        plan_steady = int((info or {}).get("plan_steady", 0))
        if plan_steady > 0:
            drift = live / plan_steady
            HBM_DRIFT_GAUGE.set(drift)
        HBM_LIVE_GAUGE.set(float(live))
        with self._cv:
            self._live_win.append(float(live))
            peak = max(self._live_win)
            trigger = self._observe_headroom_locked(headroom)
        HBM_PEAK_GAUGE.set(peak)
        self.last_sample = (int(live), headroom)
        self.last_publish_wall = time.time()
        tracer = _monitor.TRACER
        if tracer.enabled:
            tracer.counter("hbm.live_bytes", float(live), cat="memory")
            args = {"step": int(step_id), "live": int(live),
                    "peak": int(peak), "params": int(params),
                    "opt_state": int(opt), "activations": int(acts),
                    "lazy_fetch": int(inflight_bytes),
                    "ckpt_capture": ckpt, "kv_pages": int(kv)}
            if headroom is not None:
                args["headroom"] = int(headroom)
            if drift is not None:
                args["drift"] = round(drift, 4)
            tracer.instant("hbm.sample", "memory", args)
        if trigger:
            if tracer.enabled:
                tracer.instant(
                    "memory.headroom_regress", "memory",
                    {"step": int(step_id), "headroom": int(headroom),
                     "best": int(self._best_headroom or 0)})
            from .profiler import SAMPLER
            SAMPLER.trigger_window(step_id, trigger="hbm_regress")

    def _observe_headroom_locked(self, headroom) -> bool:  # guarded-by-caller: _cv
        """Track the best (largest) headroom seen and decide whether the
        regression trigger fires — the FLAGS_profile_sample_regress_frac
        pattern applied to memory: a capture window opens the sample the
        measured headroom shrinks by the configured fraction under the
        best, re-arming only after it recovers half-way back."""
        if self.regress_frac <= 0 or headroom is None or headroom <= 0:
            return False
        self._headroom_obs += 1
        if self._best_headroom is None or headroom > self._best_headroom:
            self._best_headroom = float(headroom)
        if self._headroom_obs < self._REGRESS_WARMUP:
            return False
        threshold = self._best_headroom * (1.0 - self.regress_frac)
        if headroom <= threshold:
            if self._regress_armed:
                self._regress_armed = False
                return True
            return False
        if headroom >= self._best_headroom * (1.0 - self.regress_frac / 2.0):
            self._regress_armed = True    # recovered: re-arm
        return False


def _scope_nbytes(scope, name: str) -> int:
    try:
        v = scope.find_var(name)
        return per_device_nbytes(v)
    except Exception:
        return 0


def per_device_nbytes(v) -> int:
    """Bytes one card holds for a value: a tensor's ``numel x
    element_size`` (the port shards nothing yet), a numpy array's
    ``nbytes``."""
    numel = getattr(v, "numel", None)
    if callable(numel):
        return int(numel()) * int(v.element_size())
    return int(getattr(v, "nbytes", 0) or 0)


#: process-wide accountant — the executor's step boundary feeds it
ACCOUNTANT = HBMAccountant()


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

#: XLA's phrasings ("Out of memory allocating 123 bytes", "... while
#: trying to allocate 1.21G") and PyTorch's ("Tried to allocate 2.00 GiB")
_REQ_RE = re.compile(
    r"allocat(?:ing|e)\s+([0-9][0-9.]*)\s*([KMGT]i?B?|bytes|B)?",
    re.IGNORECASE)
_UNIT = {"": 1, "b": 1, "bytes": 1,
         "k": 1 << 10, "kb": 1 << 10, "kib": 1 << 10,
         "m": 1 << 20, "mb": 1 << 20, "mib": 1 << 20,
         "g": 1 << 30, "gb": 1 << 30, "gib": 1 << 30,
         "t": 1 << 40, "tb": 1 << 40, "tib": 1 << 40}


def parse_requested_bytes(msg: str) -> int:
    """Best-effort requested bytes out of an OOM message (PyTorch's
    "Tried to allocate 2.00 GiB" or the reference's XLA forms); 0 when the
    message carries no allocation size."""
    m = _REQ_RE.search(msg or "")
    if not m:
        return 0
    try:
        return int(float(m.group(1)) *
                   _UNIT.get((m.group(2) or "").lower(), 1))
    except (TypeError, ValueError):
        return 0


def oom_forensics(error: BaseException, scope=None, program=None,
                  fetch_names=(), batch: int = 1,
                  site: str = "dispatch", top_n: int = 10) -> str:
    """Write an OOM forensics dump (watchdog-dump style) and fire the
    observability side effects: ``paddle_tpu_oom_total{site}``, a
    ``memory.oom`` trace instant, and a profiler capture window with
    ``trigger:"oom"``.  Returns the dump file path.

    The dump's arithmetic section is self-consistent by construction —
    every derived line restates the operands it was computed from, so a
    reader (or the CI smoke) can re-add them."""
    OOM_CTR.inc(1, site=site)
    measured = 0
    try:
        measured = measure_live_bytes()
    except Exception:
        pass
    requested = parse_requested_bytes(str(error))
    budget = 0
    try:
        budget = budget_bytes()
    except Exception:
        pass
    plan = None
    if program is not None:
        try:
            from .analysis.memory import plan_memory
            plan = plan_memory(program, tuple(fetch_names),
                               batch_size=max(int(batch), 1))
        except Exception:
            plan = None

    lines = ["=== hbm oom forensics ===",
             f"site: {site}",
             f"pid: {os.getpid()}",
             f"time: {time.strftime('%Y-%m-%dT%H:%M:%S')}",
             f"error: {(str(error).splitlines() or [''])[0][:400]}",
             "",
             "--- budget arithmetic (bytes) ---",
             f"budget_bytes: {budget}",
             f"plan_peak_bytes: {plan.peak_bytes if plan else 0}",
             f"measured_bytes: {measured}",
             f"requested_bytes: {requested}",
             f"measured_plus_requested: {measured + requested}",
             f"deficit_bytes: {measured + requested - budget}",
             f"# measured ({_fmt(measured)}) + requested "
             f"({_fmt(requested)}) = {_fmt(measured + requested)} vs "
             f"budget {_fmt(budget)}",
             ""]
    if plan is not None:
        lines.append(f"--- static plan (batch={plan.batch_size}) ---")
        lines.append(
            f"peak {_fmt(plan.peak_bytes)} at op #{plan.peak_pos} "
            f"({plan.peak_op}); resident {_fmt(plan.resident_bytes)}; "
            f"steady {_fmt(plan.steady_bytes)}")
        lines.append(f"--- top {top_n} tensors live at the peak op "
                     "(name, bytes, kind, lifetime [def..last op]) ---")
        for name, nbytes, kind in plan.peak_live[:top_n]:
            iv = plan.intervals.get(name)
            life = (f"[{iv[0]}..{iv[1]}]" if iv is not None
                    else "[resident whole step]")
            lines.append(f"  {_fmt(nbytes):>12s}  {kind:<8s} {life:<24s} "
                         f"{name}")
        lines.append("")
    lines.append("--- residency summary ---")
    try:
        lines.append(_memory.summary(scope) if scope is not None
                     else _memory.summary())
    except Exception as e:      # the dump must never fail the dumper
        lines.append(f"<summary unavailable: {e}>")
    census = serving_census()
    if census:
        import json
        lines.append("")
        lines.append("--- serving memory census ---")
        for snap in census:
            try:
                lines.append(json.dumps(snap, indent=1, sort_keys=True,
                                        default=str))
            except Exception:
                lines.append(repr(snap))
    lines.append("")

    from .flags import get_flags
    d = get_flags("FLAGS_oom_dump_dir")["FLAGS_oom_dump_dir"] or \
        get_flags("FLAGS_watchdog_dump_dir")["FLAGS_watchdog_dump_dir"] \
        or tempfile.gettempdir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(
        d, f"paddle_tpu_oom_{os.getpid()}_{int(time.time() * 1e3)}.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        f.flush()
        os.fsync(f.fileno())

    if _monitor.TRACER.enabled:
        _monitor.TRACER.instant(
            "memory.oom", "memory",
            {"site": site, "dump": path, "budget": budget,
             "measured": measured, "requested": requested,
             "plan_peak": plan.peak_bytes if plan else 0})
    try:
        # capture window only when the sampler has a configured home —
        # an unconfigured run must not sprout pt_profile_samples/ in the
        # cwd just because an OOM surfaced
        if get_flags("FLAGS_profile_sample_dir")[
                "FLAGS_profile_sample_dir"]:
            from .profiler import SAMPLER
            SAMPLER.trigger_window(trigger="oom")
    except Exception:
        pass
    return path


# ---------------------------------------------------------------------------
# measured plans (the reference's XLA-plan one-shot, under its name)
# ---------------------------------------------------------------------------

XLA_PLAN_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_hbm_xla_plan_peak_bytes",
    "measured peak (arguments + temps) of the most recently recorded "
    "plan's first run (FLAGS_hbm_record_plans / PADDLE_TPU_RECORD_HBM)")


class _MeasuredPlan:
    """A plan's first run on the card under the reference's
    ``memory_analysis`` names: arguments = the bytes allocated when the run
    began, temps = the allocator's peak above them during the run."""

    def __init__(self, before: int, peak: int):
        self.argument_size_in_bytes = int(before)
        self.temp_size_in_bytes = max(int(peak) - int(before), 0)


def plans_enabled() -> bool:
    """True when plans' first runs should be recorded:
    ``FLAGS_hbm_record_plans`` or the ``PADDLE_TPU_RECORD_HBM`` env var
    (the reference's alias)."""
    if os.environ.get("PADDLE_TPU_RECORD_HBM"):
        return True
    from .flags import get_flags
    return bool(get_flags("FLAGS_hbm_record_plans")
                ["FLAGS_hbm_record_plans"])


def record_xla_plan(tag: str, ma) -> dict:
    """Record one plan's measured memory analysis (``_MeasuredPlan``, or
    any object with the reference's ``*_size_in_bytes`` attributes) into
    the shared store (``memory.hbm_plans()``) and publish its peak."""
    tag = _memory.record_hbm_plan(tag, ma)
    entry = _memory.hbm_plans().get(tag)
    if entry:
        XLA_PLAN_GAUGE.set(float(entry["peak_bytes"]))
    if _monitor.TRACER.enabled:
        _monitor.TRACER.instant(
            "hbm.xla_plan", "memory",
            {"tag": tag[:64], **({k: entry[k] for k in entry}
                                 if entry else {})})
    return entry or {}
