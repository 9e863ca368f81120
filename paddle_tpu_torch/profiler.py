"""Profiler API (the port of ``paddle_tpu/profiler.py``; ref
``python/paddle/fluid/profiler.py`` and ``platform/profiler.h:81,166``
RecordEvent/EnableProfiler).

Host-side timing keeps the reference's pure-Python store (thread-local
open events, one list of closed ones, chrome-trace export on the step
tracer's epoch axis).  Device-side profiling is ``torch.profiler`` with
the CPU and CUDA activities: Kineto writes one chrome trace where each
kernel, copy and memset sits on its GPU stream lane, and the executor's
``paddle_tpu.step#<id>`` range (``framework/executor.py``) sits on the same
lanes as a ``gpu_user_annotation`` around the kernels its step launched, so
``analysis/device_profile.py`` joins kernels to steps on the device clock.

:class:`SamplingProfiler` opens such a trace for a few steps every N
executor dispatches (``FLAGS_profile_sample_*``): ``window_<step>/trace.
json.gz`` under a bounded rotating directory, a ``manifest.json`` of the
windows' ``[start, end)`` step ranges, and after each window the
``summary.json`` of ``device_profile.summarize_and_publish``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
import time
from typing import Optional

__all__ = [
    "start_profiler", "stop_profiler", "reset_profiler", "profiler_report",
    "chrome_trace", "RecordEvent", "record_event", "profiler",
    "dispatch_stats", "device_profiler", "SamplingProfiler", "SAMPLER",
    "maybe_sample_step", "last_window_error", "TRACE_FILE",
]

#: the Kineto trace a device profile writes into its directory
TRACE_FILE = "trace.json.gz"

_py_events = []          # closed events: (name, tid, start_ns, end_ns)
_py_open = threading.local()
_py_enabled = False

#: wall/monotonic anchor pair, so RecordEvent timestamps (monotonic) land on
#: the step tracer's epoch-aligned axis in one merged chrome trace
_WALL0 = time.time()
_MONO0 = time.monotonic_ns()


def _mono_ns_to_epoch_us(t_ns: int) -> float:
    return (_WALL0 + (t_ns - _MONO0) / 1e9) * 1e6


def is_profiler_enabled() -> bool:
    return _py_enabled


def start_profiler(state: str = "All", tracer_option: str = "Default"):
    """ref profiler.py start_profiler: ``state`` and ``tracer_option`` are
    accepted for parity; host events are recorded, the device is profiled
    by :func:`device_profiler`."""
    global _py_enabled
    _py_enabled = True


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None):
    """ref profiler.py stop_profiler: prints the aggregate table and
    optionally writes a chrome trace; returns the report."""
    global _py_enabled
    report = profiler_report()
    if profile_path:
        chrome_trace(profile_path)
    _py_enabled = False
    _print_report(report, sorted_key)
    return report


def reset_profiler():
    global _py_events
    _py_events = []


def profiler_report() -> dict:
    """{event name: {calls, total_us, min_us, max_us}}."""
    agg = {}
    for name, tid, s, e in _py_events:
        a = agg.setdefault(name, {"calls": 0, "total_us": 0.0,
                                  "min_us": float("inf"), "max_us": 0.0})
        d = (e - s) / 1000.0
        a["calls"] += 1
        a["total_us"] += d
        a["min_us"] = min(a["min_us"], d)
        a["max_us"] = max(a["max_us"], d)
    return agg


def chrome_trace(path: str) -> bool:
    """Write chrome://tracing JSON (ref tools/timeline.py output): the
    RecordEvent events and the step tracer's spans (``monitor.TRACER``:
    dispatch, fetch materialization, checkpoint, ...) on one epoch-aligned
    timeline."""
    from . import monitor as _monitor
    events = [{"name": n, "ph": "X", "pid": os.getpid(), "tid": t,
               "ts": _mono_ns_to_epoch_us(s), "dur": (e - s) / 1000.0}
              for n, t, s, e in _py_events]
    events.extend(_monitor.TRACER.chrome_events())
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return True


def _print_report(report: dict, sorted_key: Optional[str]):
    if not report:
        return
    key = {"calls": lambda kv: -kv[1]["calls"],
           "total": lambda kv: -kv[1]["total_us"],
           "max": lambda kv: -kv[1]["max_us"],
           "min": lambda kv: kv[1]["min_us"]}.get(
               sorted_key or "total", lambda kv: -kv[1]["total_us"])
    rows = sorted(report.items(), key=key)
    print(f"{'Event':<40}{'Calls':>8}{'Total(us)':>14}"
          f"{'Min(us)':>12}{'Max(us)':>12}{'Ave(us)':>12}")
    for name, a in rows:
        print(f"{name:<40}{a['calls']:>8}{a['total_us']:>14.1f}"
              f"{a['min_us']:>12.1f}{a['max_us']:>12.1f}"
              f"{a['total_us'] / max(a['calls'], 1):>12.1f}")


class RecordEvent:
    """RAII/context event marker (ref platform/profiler.h:81)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rec = _py_enabled
        if self._rec:
            stack = getattr(_py_open, "stack", None)
            if stack is None:
                stack = _py_open.stack = []
            stack.append((self.name, time.monotonic_ns()))
        return self

    def __exit__(self, *exc):
        if self._rec:
            name, start = _py_open.stack.pop()
            _py_events.append((name, threading.get_ident() & 0xffffff,
                               start, time.monotonic_ns()))
        return False


record_event = RecordEvent


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             profile_path: Optional[str] = None):
    """``with fluid.profiler.profiler(...):`` (ref profiler.py:profiler)."""
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def dispatch_stats() -> dict:
    """The executors' dispatch ledger summed over every live executor
    (``framework.executor.aggregate_dispatch_stats``) plus an
    ``executors`` count: plan cache hits and misses, runs, the host time
    to dispatch and the host-blocked time by cause."""
    from .framework import executor as _executor
    return _executor.aggregate_dispatch_stats()


# ---------------------------------------------------------------------------
# device profiles: torch.profiler (Kineto)
# ---------------------------------------------------------------------------

def _kineto_profile():
    """A ``torch.profiler.profile`` over the CPU and, when a card is
    present, the CUDA activities."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _sync_cuda() -> None:
    """Wait for the card's queued work, so the trace holds every kernel the
    profiled steps launched."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_profiler(logdir: str):
    """Profile the card with ``torch.profiler`` (the CUPTI device tracer
    under Kineto) and write the chrome trace ``<logdir>/trace.json.gz``
    (chrome://tracing, Perfetto, or ``device_profile.parse_trace``)."""
    prof = _kineto_profile()
    prof.start()
    try:
        yield prof
    finally:
        _sync_cuda()
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


# ---------------------------------------------------------------------------
# sampling profiler: periodic windows for long runs
# ---------------------------------------------------------------------------

class SamplingProfiler:
    """Periodic ``torch.profiler`` windows, driven by the executor's
    per-dispatch step ids (ref ``profiler.py:245-503``).

    Every ``every_n`` steps a window opens (a profiler started at the end
    of that step's dispatch) and closes ``window_steps`` dispatches later,
    its trace exported to ``window_<step>/trace.json.gz``.  At most
    ``max_windows`` are kept, oldest deleted first, and ``manifest.json``
    maps each kept window to its ``[start, end)`` step range, wall times
    and ``trigger``, so a trace maps back to the step ids on the
    executor's spans and device annotations.  Closing a window waits for
    the card (the trace must hold the last step's kernels).

    The hot path is two compares when disabled.  A capture error never
    fails the step: it counts in ``paddle_tpu_profile_windows_total
    {outcome="error"}`` and the window's directory is deleted.

    **Regression trigger** (``FLAGS_profile_sample_regress_frac``): the
    executor feeds its windowed-median dispatch interval into
    :meth:`on_step`; when it regresses by the fraction over the best median
    seen (after a warm-up of 8 medians), a window opens at once, and the
    trigger re-arms only after the median recovers to within half the
    threshold.
    """

    #: medians observed before the regression baseline is trusted
    _REGRESS_WARMUP = 8

    def __init__(self):
        self._mu = threading.Lock()
        self.every_n = 0                 # fast-path guard (int compare)
        self.regress_frac = 0.0          # fast-path guard (float compare)
        self.window_steps = 4            # guarded-by: _mu
        self.base_dir = ""               # guarded-by: _mu
        self.max_windows = 8             # guarded-by: _mu
        self._active = None              # guarded-by: _mu  (window dict)
        self._atexit_armed = False       # guarded-by: _mu
        self._best_med = None            # guarded-by: _mu
        self._med_obs = 0                # guarded-by: _mu
        self._regress_armed = True       # guarded-by: _mu

    def configure(self, every_n: int, window_steps: int, base_dir: str,
                  max_windows: int, regress_frac: float = 0.0) -> None:
        with self._mu:
            self.window_steps = max(int(window_steps), 1)
            self.base_dir = str(base_dir) or "pt_profile_samples"
            self.max_windows = max(int(max_windows), 1)
            if not self._atexit_armed and (int(every_n) > 0 or
                                           float(regress_frac) > 0):
                self._arm_atexit_locked()
            self._best_med = None
            self._med_obs = 0
            self._regress_armed = True
            # set last: the armed fast path must see a configured sampler
            self.regress_frac = float(regress_frac)
            self.every_n = int(every_n)

    def _arm_atexit_locked(self):  # guarded-by-caller: _mu
        import atexit
        atexit.register(self.close)
        self._atexit_armed = True

    # -- step hook (called by the executor after each dispatch) --------------
    def on_step(self, step_id: int, step_ms=None) -> None:
        if self.every_n <= 0 and self.regress_frac <= 0 and \
                self._active is None:
            return
        with self._mu:
            act = self._active
            if act is not None:
                if step_id - act["opened_at"] >= self.window_steps:
                    # the window ran through step_id: [start, step_id + 1)
                    self._finish_locked(act, step_id + 1)
                else:
                    act["last_step"] = step_id
                self._observe_median_locked(step_ms)
                return
            if self._observe_median_locked(step_ms):
                self._open_locked(step_id, trigger="regress")
                return
            if self.every_n > 0 and step_id % self.every_n == 0:
                self._open_locked(step_id)

    def _observe_median_locked(self, step_ms) -> bool:  # guarded-by-caller: _mu
        """Track the best median; True when the regression trigger fires
        (only while no window is active)."""
        if self.regress_frac <= 0 or step_ms is None or step_ms <= 0:
            return False
        self._med_obs += 1
        if self._best_med is None or step_ms < self._best_med:
            self._best_med = float(step_ms)
        if self._med_obs < self._REGRESS_WARMUP:
            return False
        threshold = self._best_med * (1.0 + self.regress_frac)
        if step_ms >= threshold:
            if self._regress_armed and self._active is None:
                self._regress_armed = False
                return True
            return False
        if step_ms <= self._best_med * (1.0 + self.regress_frac / 2.0):
            self._regress_armed = True    # recovered: re-arm
        return False

    def trigger_window(self, step_id=None, trigger: str = "anomaly") -> bool:
        """Open a window now (no-op while one is active), stamped with
        ``trigger`` in the manifest: the OOM path's and the HBM headroom
        trigger's entry point.  It closes ``window_steps`` dispatches
        later even with periodic sampling off.  True iff a window
        opened."""
        with self._mu:
            if self._active is not None:
                return False
            if not self.base_dir:
                self.base_dir = "pt_profile_samples"
            if not self._atexit_armed:
                self._arm_atexit_locked()
            self._open_locked(int(step_id or 0), trigger=trigger)
            return self._active is not None

    def close(self) -> None:
        """Finish any open window (process exit, reconfigure).  A window
        that saw no step is abandoned and its directory deleted."""
        with self._mu:
            act = self._active
            if act is None:
                return
            if "last_step" in act:
                self._finish_locked(act, act["last_step"] + 1)
                return
            self._active = None
            try:
                act["prof"].stop()
            except Exception as e:
                _note_window_error(e)
            _window_ctr("empty")
            shutil.rmtree(act["dir"], ignore_errors=True)

    # -- window lifecycle (all hold _mu) -------------------------------------
    def _open_locked(self, step_id: int,
                     trigger: str = "periodic"):  # guarded-by-caller: _mu
        wdir = os.path.join(self.base_dir, f"window_{step_id:08d}")
        try:
            os.makedirs(wdir, exist_ok=True)
            prof = _kineto_profile()
            prof.start()
        except Exception as e:
            _window_ctr("error")
            _note_window_error(e)
            # an unmanifested directory is invisible to rotation
            shutil.rmtree(wdir, ignore_errors=True)
            return
        # this hook runs at the END of step_id's dispatch: the first step
        # the window observes is step_id + 1 (the manifest's start)
        self._active = {"dir": wdir, "start_step": int(step_id) + 1,
                        "opened_at": int(step_id),
                        "wall_start": time.time(),
                        "trigger": trigger, "prof": prof}
        from . import monitor as _monitor
        if _monitor.TRACER.enabled:
            _monitor.TRACER.instant("profile.window_start", "profile",
                                    {"step": int(step_id), "dir": wdir,
                                     "trigger": trigger})

    def _finish_locked(self, act, end_step: int):  # guarded-by-caller: _mu
        self._active = None
        try:
            _sync_cuda()
            act["prof"].stop()
            act["prof"].export_chrome_trace(
                os.path.join(act["dir"], TRACE_FILE))
        except Exception as e:
            _window_ctr("error")
            _note_window_error(e)
            # the partial capture never reaches the manifest
            shutil.rmtree(act["dir"], ignore_errors=True)
            return
        act["end_step"] = int(end_step)
        act["wall_end"] = time.time()
        _window_ctr("ok")
        from . import monitor as _monitor
        if _monitor.TRACER.enabled:
            _monitor.TRACER.instant(
                "profile.window_stop", "profile",
                {"step": int(end_step), "dir": act["dir"]})
        try:
            self._rotate_and_manifest_locked(act)
        except OSError:
            pass          # a full disk must not fail the training step
        # post-close attribution: <window>/summary.json and the measured
        # gauges; best-effort, it warns and skips on a malformed capture
        try:
            from .analysis import device_profile
            device_profile.summarize_and_publish(act["dir"])
        except Exception as e:
            _note_window_error(e)

    def _rotate_and_manifest_locked(self, act):  # guarded-by-caller: _mu
        path = os.path.join(self.base_dir, "manifest.json")
        manifest = {"windows": []}
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            pass
        windows = [w for w in manifest.get("windows", [])
                   if isinstance(w, dict)]
        windows.append({k: act[k] for k in
                        ("dir", "start_step", "end_step",
                         "wall_start", "wall_end", "trigger")
                        if k in act})
        # one entry per window dir (newest wins), and none for a dir that
        # no longer exists
        by_dir = {}
        for w in windows:
            d = w.get("dir", "")
            prev = by_dir.get(d)
            if prev is None or w.get("wall_end", 0.0) >= \
                    prev.get("wall_end", 0.0):
                by_dir[d] = w
        windows = [w for d, w in by_dir.items()
                   if d == act.get("dir") or os.path.isdir(d)]
        windows.sort(key=lambda w: w.get("start_step", 0))
        while len(windows) > self.max_windows:
            victim = windows.pop(0)
            shutil.rmtree(victim.get("dir", ""), ignore_errors=True)
        manifest["windows"] = windows
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, path)


def _window_ctr(outcome: str):
    from . import monitor as _monitor
    _monitor.REGISTRY.counter(
        "paddle_tpu_profile_windows_total",
        "sampling-profiler capture windows by outcome",
        ("outcome",)).inc(1, outcome=outcome)


_last_window_error = []


def _note_window_error(e: BaseException):
    """Remember the last capture failure (``last_window_error()``)."""
    _last_window_error[:] = [repr(e)]


def last_window_error():
    return _last_window_error[0] if _last_window_error else None


SAMPLER = SamplingProfiler()


def maybe_sample_step(step_id: int, step_ms=None) -> None:
    """The executor's per-dispatch hook: two compares when sampling is off
    (the default), window bookkeeping at boundaries when on.  ``step_ms``
    is the executor's windowed-median dispatch interval (the regression
    trigger's signal)."""
    SAMPLER.on_step(step_id, step_ms)
