"""Runtime metrics: the metrics core of ``paddle_tpu/monitor.py``
(:63-372).

Counters, gauges and fixed-bucket histograms with labels, kept in one process-wide
registry (``REGISTRY``) under the reference's metric names, so a scrape of
either package reads the same families:

- ``paddle_tpu_fusion_candidates_total{pattern,verdict}`` and
  ``paddle_tpu_fusion_autotune_total{cache}`` (``analysis/fusion.py``);
- ``paddle_tpu_verifier_findings_total{check}`` and
  ``paddle_tpu_verifier_runs_total{cache}`` (``analysis/verifier.py``);
- ``paddle_tpu_compiler_optimize_total{cache}`` and
  ``paddle_tpu_compiler_pass_ms{pass}`` (``compiler.py``);
- ``paddle_tpu_amp_scale`` and ``paddle_tpu_amp_skipped_steps_total``
  (``amp.py``);
- the decode server's families: the load gauges and the generated-token
  counter declared here (ref :873-890), the per-tenant KV-page plane
  (ref :913-929), and beside their writers
  ``paddle_tpu_serving_batch_occupancy{mode}``,
  ``paddle_tpu_serving_batches_total{bucket}``,
  ``paddle_tpu_serving_faults_absorbed_total`` (``serving/scheduler.py``),
  ``paddle_tpu_serving_kv_pages_in_use`` and
  ``paddle_tpu_serving_kv_page_events_total{event}``
  (``serving/kv_cache.py``), and ``paddle_tpu_fault_injected_total{site}``
  (``resilience.py``).

A hot path resolves its label series once (``.labels(...)``) and keeps the
cell: a bump is then one lock and one add.

The step tracer (ref :987-1211): ``TRACER`` keeps a bounded ring of
chrome-trace events (``span``, ``instant``, ``add_complete``, ``counter``)
that the resilience layer writes every recovery action to and the
watchdog's dump reads; ``export(dir)`` writes ``metrics.json``,
``metrics.prom`` and ``trace.json``.  ``FLAGS_telemetry`` gates the
recording, ``FLAGS_telemetry_max_events`` sizes the ring and
``FLAGS_telemetry_export_path`` exports at process exit.

Not ported yet: the digests, the series retirement on tenant eviction, the
per-phase latency histogram and the SLO families, and the batch server's
telemetry.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "StepTracer", "TRACER", "span", "export", "telemetry_snapshot",
           "counter_totals", "enable_export_on_exit",
           "disable_export_on_exit"]

#: default microsecond buckets (the reference's)
DEFAULT_BUCKETS_US = (50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 25000.0, 50000.0, 100000.0, 250000.0,
                      500000.0, 1e6, 5e6, 30e6)


class _Cell:
    """One labeled series of a counter or a gauge: a lock and a number."""

    __slots__ = ("_mu", "_v")

    def __init__(self):
        self._mu = threading.Lock()
        self._v = 0  # guarded-by: _mu

    def inc(self, n=1):
        with self._mu:
            self._v += n

    def set(self, v):
        with self._mu:
            self._v = v

    def get(self):
        with self._mu:
            return self._v

    def reset(self):
        with self._mu:
            self._v = 0


class _HistCell:
    """One labeled series of a fixed-bucket histogram."""

    __slots__ = ("_mu", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self._mu = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # guarded-by: _mu  (+Inf last)
        self.sum = 0.0  # guarded-by: _mu
        self.count = 0  # guarded-by: _mu

    def observe(self, v: float):
        with self._mu:
            i = next((i for i, b in enumerate(self.buckets) if v <= b),
                     len(self.buckets))
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def snapshot(self):
        with self._mu:
            return list(self.counts), self.sum, self.count

    def reset(self):
        with self._mu:
            self.counts = [0] * (len(self.buckets) + 1)
            self.sum = 0.0
            self.count = 0


class _Metric:
    """A named family of labeled series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._mu = threading.Lock()
        self._series: Dict[Tuple[str, ...], Any] = {}  # guarded-by: _mu

    def _new_cell(self):
        return _Cell()

    def labels(self, **kv):
        """The (memoized) cell of one label-value combination."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} expects labels {self.labelnames}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._mu:
            cell = self._series.get(key)
            if cell is None:
                cell = self._series[key] = self._new_cell()
            return cell

    def series(self) -> List[Tuple[Dict[str, str], Any]]:
        with self._mu:
            items = list(self._series.items())
        return [(dict(zip(self.labelnames, key)), cell)
                for key, cell in items]

    def fold(self, src: Dict[str, str], dst: Optional[Dict[str, str]]):
        """Retire the ``src`` series: add its value into ``dst`` (made on
        demand) and drop it (ref :174-196), so a fresh-executor-per-request
        loop does not grow the registry while ``counter_totals()`` stays
        exact.  ``dst=None`` only drops it (a dead instance's gauge)."""
        skey = tuple(str(src[n]) for n in self.labelnames)
        with self._mu:
            cell = self._series.pop(skey, None)
        if cell is None or dst is None:
            return
        dcell = self.labels(**dst)
        if isinstance(cell, _HistCell):
            counts, s, c = cell.snapshot()
            with dcell._mu:
                for i, n in enumerate(counts):
                    dcell.counts[i] += n
                dcell.sum += s
                dcell.count += c
        else:
            dcell.inc(cell.get())


class Counter(_Metric):
    kind = "counter"

    def inc(self, n=1, **labels):
        self.labels(**labels).inc(n)

    def value(self, **labels):
        return self.labels(**labels).get()


class Gauge(_Metric):
    """A value that is set (ref ``paddle_tpu/monitor.py:211``)."""

    kind = "gauge"

    def set(self, v, **labels):
        self.labels(**labels).set(v)

    def inc(self, n=1, **labels):
        self.labels(**labels).inc(n)

    def value(self, **labels):
        return self.labels(**labels).get()


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS_US):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _new_cell(self):
        return _HistCell(self.buckets)

    def observe(self, v: float, **labels):
        self.labels(**labels).observe(v)


class MetricsRegistry:
    """Get-or-create metric families by name."""

    def __init__(self):
        self._mu = threading.Lock()
        self._metrics: "collections.OrderedDict[str, _Metric]" = \
            collections.OrderedDict()  # guarded-by: _mu

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._mu:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, **kw)
                return m
        if not isinstance(m, cls) or tuple(labelnames) != m.labelnames:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.labelnames}")
        if "buckets" in kw and tuple(
                sorted(float(b) for b in kw["buckets"])) != m.buckets:
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{m.buckets}")
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets: Sequence[float] = DEFAULT_BUCKETS_US) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name) -> Optional[_Metric]:
        with self._mu:
            return self._metrics.get(name)

    def collect(self) -> List[Dict[str, Any]]:
        """Every family as a JSON-able dict (ref :285-302)."""
        with self._mu:
            metrics = list(self._metrics.values())
        out = []
        for m in metrics:
            series = []
            for labels, cell in m.series():
                if isinstance(cell, _HistCell):
                    counts, s, c = cell.snapshot()
                    series.append({"labels": labels,
                                   "buckets": list(m.buckets),
                                   "counts": counts, "sum": s, "count": c})
                else:
                    series.append({"labels": labels, "value": cell.get()})
            out.append({"name": m.name, "type": m.kind, "help": m.help,
                        "series": series})
        return out

    def to_json(self, indent=None) -> str:
        return json.dumps({"metrics": self.collect()}, indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for m in self.collect():
            if m["help"]:
                lines.append(f"# HELP {m['name']} "
                             f"{_escape_help(m['help'])}")
            lines.append(f"# TYPE {m['name']} {m['type']}")
            for s in m["series"]:
                lbl = _fmt_labels(s["labels"])
                if m["type"] != "histogram":
                    lines.append(f"{m['name']}{lbl} "
                                 f"{_fmt_float(s['value'])}")
                    continue
                cum = 0
                for b, c in zip(s["buckets"], s["counts"]):
                    cum += c
                    lines.append(f"{m['name']}_bucket"
                                 f"{_fmt_labels(s['labels'], le=_fmt_float(b))}"
                                 f" {cum}")
                cum += s["counts"][-1]
                lines.append(f"{m['name']}_bucket"
                             f"{_fmt_labels(s['labels'], le='+Inf')} {cum}")
                lines.append(f"{m['name']}_sum{lbl} {_fmt_float(s['sum'])}")
                lines.append(f"{m['name']}_count{lbl} {s['count']}")
        return "\n".join(lines) + "\n"


def _fmt_float(v) -> str:
    if isinstance(v, str):
        return v
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(labels: Dict[str, str], **extra) -> str:
    items = list(labels.items()) + list(extra.items())
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(str(v))}"'
                          for k, v in items) + "}"


#: the process-wide registry
REGISTRY = MetricsRegistry()


# -- the decode server's load gauges (ref paddle_tpu/monitor.py:873-890) ----

SERVING_LAST_OCC_GAUGE = REGISTRY.gauge(
    "paddle_tpu_serving_last_batch_occupancy",
    "occupancy (real requests) of the most recently dispatched serving "
    "batch / decode iteration — the instantaneous load form of the "
    "paddle_tpu_serving_batch_occupancy histogram, carried in the gang "
    "heartbeat digest as 'occ'")
SERVING_FREE_SLOTS_GAUGE = REGISTRY.gauge(
    "paddle_tpu_serving_free_decode_slots",
    "KV decode slots currently unoccupied (digest key 'slots'; 0 = the "
    "decode batch is full and new requests queue)")
SERVING_TPS_GAUGE = REGISTRY.gauge(
    "paddle_tpu_serving_tokens_per_s",
    "decode throughput: generated tokens per second over a short "
    "trailing window (digest key 'tps')")
SERVING_TOKENS_CTR = REGISTRY.counter(
    "paddle_tpu_serving_generated_tokens_total",
    "tokens generated by the decode loop (prefill consumption excluded)")

# -- the per-tenant KV-page plane (ref paddle_tpu/monitor.py:913-929) -------

SERVING_KV_TENANT_PAGES = REGISTRY.gauge(
    "paddle_tpu_serving_kv_tenant_pages",
    "KV-cache pages currently owned by the tenant's in-flight decode "
    "requests — the per-tenant occupancy slice of "
    "paddle_tpu_serving_kv_pages_in_use", ("tenant",))
SERVING_KV_TENANT_FRAG = REGISTRY.gauge(
    "paddle_tpu_serving_kv_tenant_frag",
    "internal fragmentation of the tenant's KV pages in [0,1]: "
    "1 - written_tokens / (pages * page_len) — reserved-but-unwritten "
    "tail capacity (worst-case admission reservations inflate it early "
    "in a request's life)", ("tenant",))
SERVING_KV_TENANT_ALLOC_CTR = REGISTRY.counter(
    "paddle_tpu_serving_kv_tenant_pages_total",
    "KV pages RESERVED for the tenant's requests at admission, "
    "cumulative (folds to tenant=\"retired\" on eviction so "
    "counter_totals() stays exact across tenant churn)", ("tenant",))


# -- the step tracer (ref paddle_tpu/monitor.py:987-1211) --------------------

class StepTracer:
    """Bounded ring of chrome-trace events.

    Events are kept as tuples (ph, name, cat, tid, t_start, dur, args) with
    ``perf_counter`` timestamps; chrome dicts are built only at export.
    ``enabled`` is a plain bool, so a hot path guards with one attribute
    load.  The ring keeps the most recent ``max_events``.
    """

    def __init__(self, max_events: int = 200_000):
        self._emu = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=max_events)  # guarded-by: _emu
        # perf_counter for durations, the wall clock as the anchor that
        # lets traces of several processes share one axis
        self._perf0 = time.perf_counter()
        self._wall0 = time.time()
        self._tnames: Dict[int, str] = {}
        self.enabled = True

    def _tid(self) -> int:
        tid = threading.get_ident() & 0xffffff
        if tid not in self._tnames:
            self._tnames[tid] = threading.current_thread().name
        return tid

    def add_complete(self, name: str, cat: str, t_start: float,
                     t_end: float, args: Optional[dict] = None):
        """Record a complete span [t_start, t_end] (perf_counter s)."""
        if not self.enabled:
            return
        with self._emu:
            self._events.append(("X", name, cat, self._tid(), t_start,
                                 t_end - t_start, args))

    def instant(self, name: str, cat: str = "",
                args: Optional[dict] = None):
        if not self.enabled:
            return
        with self._emu:
            self._events.append(("i", name, cat, self._tid(),
                                 time.perf_counter(), 0.0, args))

    def counter(self, name: str, value: float, cat: str = ""):
        """A chrome counter track."""
        if not self.enabled:
            return
        with self._emu:
            self._events.append(("C", name, cat, self._tid(),
                                 time.perf_counter(), 0.0,
                                 {"value": value}))

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **args):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_complete(name, cat, t0, time.perf_counter(),
                              args or None)

    def set_capacity(self, max_events: int):
        with self._emu:
            self._events = collections.deque(self._events,
                                             maxlen=int(max_events))

    def clear(self):
        with self._emu:
            self._events.clear()

    def __len__(self):
        with self._emu:
            return len(self._events)

    def _ts_us(self, t_perf: float) -> float:
        return (self._wall0 + (t_perf - self._perf0)) * 1e6

    def chrome_events(self) -> List[Dict[str, Any]]:
        """chrome://tracing event dicts, after process and thread name
        rows."""
        pid = os.getpid()
        out: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"paddle_tpu:{pid}"}}]
        for tid, tname in sorted(self._tnames.items()):
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
        with self._emu:
            events = list(self._events)
        for ph, name, cat, tid, t0, dur, args in events:
            ev: Dict[str, Any] = {"name": name, "ph": ph, "pid": pid,
                                  "tid": tid,
                                  "ts": round(self._ts_us(t0), 3)}
            if cat:
                ev["cat"] = cat
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            if ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            out.append(ev)
        return out


TRACER = StepTracer()


def span(name: str, cat: str = "", **args):
    """``with monitor.span("executor.dispatch", "dispatch"): ...``"""
    return TRACER.span(name, cat, **args)


def telemetry_snapshot() -> Dict[str, float]:
    """The registry flattened to {series key: value}; a histogram gives
    ``<name>_sum`` and ``<name>_count`` per series."""
    flat: Dict[str, float] = {}
    for m in REGISTRY.collect():
        for s in m["series"]:
            key = m["name"] + _fmt_labels(s["labels"])
            if m["type"] == "histogram":
                flat[key + "_sum"] = s["sum"]
                flat[key + "_count"] = s["count"]
            else:
                flat[key] = s["value"]
    return flat


def counter_totals() -> Dict[str, float]:
    """Per-family totals summed over the label series."""
    out: Dict[str, float] = {}
    for m in REGISTRY.collect():
        if m["type"] == "histogram":
            out[m["name"] + "_sum"] = sum(s["sum"] for s in m["series"])
            out[m["name"] + "_count"] = sum(
                s["count"] for s in m["series"])
        else:
            out[m["name"]] = sum(s["value"] for s in m["series"])
    return out


def export(dirpath: str, trace: bool = True) -> Dict[str, str]:
    """Write ``metrics.json``, ``metrics.prom`` and (when ``trace``)
    ``trace.json`` under ``dirpath``; returns {kind: path}.  The trace goes
    through ``profiler.chrome_trace``: the profiler's RecordEvent events
    and the tracer's spans on one timeline."""
    os.makedirs(dirpath, exist_ok=True)
    paths = {}
    p = os.path.join(dirpath, "metrics.json")
    with open(p, "w") as f:
        f.write(REGISTRY.to_json(indent=1))
    paths["json"] = p
    p = os.path.join(dirpath, "metrics.prom")
    with open(p, "w") as f:
        f.write(REGISTRY.to_prometheus())
    paths["prom"] = p
    if trace:
        from . import profiler
        p = os.path.join(dirpath, "trace.json")
        profiler.chrome_trace(p)
        paths["trace"] = p
    return paths


_export_at_exit: List[str] = []


def enable_export_on_exit(dirpath: str):
    """``FLAGS_telemetry_export_path``: export once at process exit."""
    if not _export_at_exit:
        import atexit
        atexit.register(_exit_export)
    _export_at_exit[:] = [dirpath]


def disable_export_on_exit():
    """Disarm an enabled at-exit export (the flag set back to "")."""
    _export_at_exit[:] = []


def _exit_export():
    if _export_at_exit:
        try:
            export(_export_at_exit[0])
        except Exception:       # telemetry must not break the exit
            pass


def _sync_from_flags():
    try:
        from .flags import get_flags
        fl = get_flags(["FLAGS_telemetry", "FLAGS_telemetry_max_events",
                        "FLAGS_telemetry_export_path"])
    except Exception:           # flags mid-bootstrap: side effects re-sync
        return
    TRACER.enabled = bool(fl["FLAGS_telemetry"])
    if int(fl["FLAGS_telemetry_max_events"]) != TRACER._events.maxlen:
        TRACER.set_capacity(int(fl["FLAGS_telemetry_max_events"]))
    if fl["FLAGS_telemetry_export_path"]:
        enable_export_on_exit(str(fl["FLAGS_telemetry_export_path"]))


_sync_from_flags()
