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
- the servers' families: the per-tenant request counters, queue gauge,
  latency and per-phase latency histograms declared here (ref :833-871),
  the load gauges and the generated-token counter (ref :873-890), the SLO
  plane's burn, breached and breach-event series (ref :891-907), the
  per-tenant KV-page plane (ref :913-929), all retired together on tenant
  eviction (``retire_tenant_series``), and beside their writers
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

The heartbeat digest (ref :405-830): ``metrics_digest()`` is a compact,
byte-capped (``DIGEST_MAX_BYTES``, ``capped_digest``) snapshot of this
process's health under the reference's keys: ``step_ms``, ``mfu``,
``mfu_m``, ``queue``, ``steps``, ``inflight``, the serving load ``srv_q`` /
``occ`` / ``slots`` / ``tps`` (while a serving loop woke within
``FLAGS_fleet_digest_ttl_s``), the numerics plane's ``gnorm`` / ``nanf``,
and the HBM accountant's ``hbm`` / ``hdrm``.  A ``ReplicaEndpoint`` sends
its load keys with every reply.  The fleet families (ref :520-590): the
router's re-route ledger and per-replica state, the failover histogram
(observed by the router's re-routed requests), and the autoscaler's decision counter, target, live size, shed switch and width
shrinks.

Not ported yet: the ``comm_ms`` / ``comm_wait`` / ``comm_bw`` digest keys
(they come with ``analysis/comms.py``), and the ``paddle_tpu_gang_*`` and
``paddle_tpu_coordinator_*`` families with the coordinator that folds the
digests (ROADMAP Queue 1 items 2-3).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "StepTracer", "TRACER", "span", "export", "telemetry_snapshot",
           "counter_totals", "enable_export_on_exit",
           "disable_export_on_exit", "retire_tenant_series",
           "metrics_digest", "capped_digest", "DIGEST_MAX_BYTES"]

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


# -- the request server's per-tenant families (ref paddle_tpu/monitor.py:
# 833-871): the tenant plane, the schedulers and retire_tenant_series below
# all touch them, and tenant churn retires through retire_tenant_series

SERVING_REQ_CTR = REGISTRY.counter(
    "paddle_tpu_serving_requests_total",
    "requests ADMITTED into the serving queue, per tenant", ("tenant",))
SERVING_DONE_CTR = REGISTRY.counter(
    "paddle_tpu_serving_completed_total",
    "requests completed (future resolved with a result), per tenant",
    ("tenant",))
SERVING_FAIL_CTR = REGISTRY.counter(
    "paddle_tpu_serving_failed_total",
    "requests failed (future resolved with an error), per tenant",
    ("tenant",))
SERVING_REJECT_CTR = REGISTRY.counter(
    "paddle_tpu_serving_rejected_total",
    "requests refused at admission, per tenant and reason "
    "(quota / draining / too_long)", ("tenant", "reason"))
SERVING_QUEUE_GAUGE = REGISTRY.gauge(
    "paddle_tpu_serving_queue_depth",
    "requests currently queued + in flight, per tenant", ("tenant",))
SERVING_LAT_HIST = REGISTRY.histogram(
    "paddle_tpu_serving_latency_ms",
    "end-to-end request latency (submit -> future resolved), ms, per "
    "tenant", ("tenant",),
    buckets=(1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
             1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 120000.0))
SERVING_PHASE_HIST = REGISTRY.histogram(
    "paddle_tpu_serving_phase_ms",
    "per-request phase latency (ms) of the serving pipeline by phase "
    "(admit / queue_wait / batch_wait / dispatch / decode / "
    "materialize), tenant and bucket (bucket='decode' for the KV decode "
    "loop) — phases partition submit->resolve, so their sum is the "
    "request's end-to-end latency and p99 decomposes by phase",
    ("phase", "tenant", "bucket"),
    buckets=(0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
             500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0))

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


# -- the SLO plane's per-tenant series (ref paddle_tpu/monitor.py:891-907) ---

SLO_BURN_GAUGE = REGISTRY.gauge(
    "paddle_tpu_slo_burn_rate",
    "per-tenant SLO error-budget burn rate, by window ('fast' / "
    "'slow'): (bad-event fraction in the window) / (1 - objective) — "
    "1.0 means the budget is consumed exactly at the rate the SLO "
    "allows, a sustained burn above the threshold on BOTH windows is a "
    "breach", ("tenant", "window"))
SLO_BREACHED_GAUGE = REGISTRY.gauge(
    "paddle_tpu_slo_breached",
    "1 while the tenant's SLO is in breach (multi-window burn rate over "
    "threshold; clears with hysteresis at threshold/2 on the fast "
    "window)", ("tenant",))
SLO_BREACH_CTR = REGISTRY.counter(
    "paddle_tpu_slo_breach_total",
    "SLO breach EVENTS per tenant (each breach->recovery cycle counts "
    "once; the instant is also recorded in the trace ring as "
    "'slo.breach')", ("tenant",))


def retire_tenant_series(tenant) -> None:
    """Registry hygiene for tenant eviction (ref monitor.py:931-965): the
    tenant's counter and histogram series fold into ``tenant="retired"``
    (``counter_totals()`` stays exact) and its gauges drop (a departed
    tenant has no queue, no pages and no burn)."""
    src = {"tenant": str(tenant)}
    dst = {"tenant": "retired"}
    SERVING_REQ_CTR.fold(src, dst)
    SERVING_DONE_CTR.fold(src, dst)
    SERVING_FAIL_CTR.fold(src, dst)
    SERVING_LAT_HIST.fold(src, dst)
    for labels, _cell in SERVING_REJECT_CTR.series():
        if labels.get("tenant") == str(tenant):
            SERVING_REJECT_CTR.fold(
                labels, {"tenant": "retired",
                         "reason": labels.get("reason", "")})
    for labels, _cell in SERVING_PHASE_HIST.series():
        if labels.get("tenant") == str(tenant):
            SERVING_PHASE_HIST.fold(labels, dict(labels, tenant="retired"))
    SERVING_QUEUE_GAUGE.fold(src, None)
    SERVING_KV_TENANT_ALLOC_CTR.fold(src, dst)
    SERVING_KV_TENANT_PAGES.fold(src, None)
    SERVING_KV_TENANT_FRAG.fold(src, None)
    SLO_BREACH_CTR.fold(src, dst)
    SLO_BREACHED_GAUGE.fold(src, None)
    for labels, _cell in SLO_BURN_GAUGE.series():
        if labels.get("tenant") == str(tenant):
            SLO_BURN_GAUGE.fold(labels, None)


# -- the serving fleet and its autoscaler (ref paddle_tpu/monitor.py:520-590)

FLEET_REROUTE_CTR = REGISTRY.counter(
    "paddle_tpu_fleet_reroutes_total",
    "requests the FleetRouter moved off their placed replica, by reason "
    "(drain = the replica refused admission while draining; dead = the "
    "forward hit a transport error; circuit = the replica's breaker was "
    "open at placement; error = the replica failed the request "
    "non-transiently) — the chaos-drill ledger: completed requests = "
    "first-try successes + exactly these", ("reason",))
FLEET_REPLICA_STATE = REGISTRY.gauge(
    "paddle_tpu_fleet_replica_state",
    "router's placement view of each replica: 0=up 1=draining 2=dead "
    "3=stale (load digest older than FLAGS_fleet_digest_ttl_s — held "
    "out of least-loaded placement until it proves liveness again)",
    ("replica",))
FLEET_FAILOVER_HIST = REGISTRY.histogram(
    "paddle_tpu_fleet_failover_ms",
    "wall ms from a forward/coordinator failure to the request landing "
    "on a healthy target (router reroutes and gang-client coordinator "
    "failovers both observe here) — the p99 the chaos gate bounds",
    buckets=(1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
             2500.0, 5000.0, 15000.0, 60000.0))
FLEET_SCALE_CTR = REGISTRY.counter(
    "paddle_tpu_fleet_scale_total",
    "autoscaler scale decisions, by direction and reason (up/burn_queue "
    "= sustained SLO burn + queue pressure raised the target; up/death "
    "= a dead replica is being replaced to restore the target; "
    "up/oom = a replica that kept breaching headroom after its bucket "
    "shrink is being respawned fresh; down/idle = sustained idle "
    "drained-and-retired one) — counted once per decision, never per "
    "spawn attempt", ("dir", "reason"))
FLEET_TARGET_GAUGE = REGISTRY.gauge(
    "paddle_tpu_fleet_target_replicas",
    "the autoscaler's current target fleet size (clamped to "
    "[FLAGS_fleet_min_replicas, FLAGS_fleet_max_replicas])")
FLEET_SIZE_GAUGE = REGISTRY.gauge(
    "paddle_tpu_fleet_live_replicas",
    "replicas the router currently counts as placeable (up or stale — "
    "draining and dead replicas are out); TGT vs SIZE is the gangtop "
    "footer")
FLEET_SHED_GAUGE = REGISTRY.gauge(
    "paddle_tpu_fleet_shedding",
    "1 while the autoscaler has engaged fleet-wide admission shedding "
    "(SLO breach sustained past FLAGS_fleet_shed_after_ticks with a "
    "spawn in flight or the fleet at max), else 0")
FLEET_SHRINK_CTR = REGISTRY.counter(
    "paddle_tpu_fleet_width_shrinks_total",
    "bucket-width shrink control ops the autoscaler sent to replicas "
    "reporting HBM headroom under FLAGS_fleet_oom_headroom_frac (the "
    "degradation ladder's first rung; the replica is named in the "
    "autoscaler.shrink trace instant)")


# -- the heartbeat digest (ref paddle_tpu/monitor.py:405-830) ----------------

#: a digest's serialized size cap: ``capped_digest`` drops keys to fit
DIGEST_MAX_BYTES = 512

_PKG = __name__.rpartition(".")[0]


def _newest_executor_value(name: str):
    """The value of the newest live executor's series of ``name`` (the
    highest ``executor`` serial; the "retired" fold is skipped)."""
    fam = REGISTRY.get(name)
    if fam is None:
        return None
    best, best_serial = None, -1
    for labels, cell in fam.series():
        try:
            serial = int(labels.get("executor", -1))
        except (TypeError, ValueError):
            continue
        if serial > best_serial:
            best_serial, best = serial, cell.get()
    return best


def _last_cell(name: str):
    fam = REGISTRY.get(name)
    if fam is None:
        return None
    cells = [cell.get() for _, cell in fam.series()]
    return cells[-1] if cells else None


def metrics_digest() -> Dict[str, Any]:
    """Compact snapshot of this process's health (ref :594-736): the newest
    executor's step-time estimate and live MFU, the measured MFU while a
    profiler window published recently, dataloader queue depth, steps
    dispatched and steps in flight, the serving load while a serving loop
    is alive, the numerics plane's global gradient norm and non-finite
    count, and the HBM accountant's live bytes and headroom.  Reads a few
    families, never a whole collect."""
    digest: Dict[str, Any] = {}
    ms = _newest_executor_value("paddle_tpu_step_device_ms")
    if ms is not None:
        digest["step_ms"] = round(float(ms), 3)
    mfu = _newest_executor_value("paddle_tpu_step_mfu")
    if mfu is not None:
        digest["mfu"] = round(float(mfu), 5)
    if _measured_mfu_fresh():
        fam = REGISTRY.get("paddle_tpu_step_mfu_measured")
        if fam is not None:
            v = fam.value()
            if v:
                digest["mfu_m"] = round(float(v), 5)
    qd = REGISTRY.get("paddle_tpu_dataloader_queue_depth")
    if qd is not None:
        vals = [cell.get() for labels, cell in qd.series()
                if labels.get("pipeline") != "retired"]
        if vals:
            digest["queue"] = float(sum(vals))
    steps_fam = REGISTRY.get("paddle_tpu_executor_steps_dispatched")
    if steps_fam is not None:
        total = sum(cell.get() for _, cell in steps_fam.series())
        if total:
            digest["steps"] = int(total)
    exe_mod = sys.modules.get(_PKG + ".framework.executor")
    if exe_mod is not None:
        try:
            digest["inflight"] = int(sum(
                len(e._inflight) for e in list(exe_mod._EXECUTORS)))
        except Exception:
            pass
    # the serving load, only while a serving loop proves it is alive: a
    # wedged scheduler's last report would read as an idle replica
    if _serving_digest_fresh():
        sq = REGISTRY.get("paddle_tpu_serving_queue_depth")
        if sq is not None:
            vals = [cell.get() for labels, cell in sq.series()
                    if labels.get("tenant") != "retired"]
            if vals:
                digest["srv_q"] = float(sum(vals))
        for key, fam_name in (
                ("occ", "paddle_tpu_serving_last_batch_occupancy"),
                ("slots", "paddle_tpu_serving_free_decode_slots"),
                ("tps", "paddle_tpu_serving_tokens_per_s")):
            v = _last_cell(fam_name)
            if v is not None:
                digest[key] = round(float(v), 3)
    # the numerics plane: nanf rides whenever gnorm does
    gn = _last_cell("paddle_tpu_numerics_global_grad_norm")
    if gn is not None:
        digest["gnorm"] = round(float(gn), 4)
        nf = REGISTRY.get("paddle_tpu_numerics_nonfinite_total")
        if nf is not None:
            digest["nanf"] = int(sum(cell.get() for _, cell in nf.series()))
    # the HBM accountant: hdrm only while a budget is known
    if _hbm_digest_fresh():
        mod = sys.modules.get(_PKG + ".hbm")
        sample = getattr(mod.ACCOUNTANT, "last_sample", None) \
            if mod is not None else None
        if sample is not None:
            live, headroom = sample
            digest["hbm"] = int(live)
            if headroom is not None:
                digest["hdrm"] = int(headroom)
    return digest


#: how long the hbm/hdrm keys outlive the accountant's last publish
_HBM_DIGEST_TTL_S = 120.0

#: mfu_m's freshness window: profiler windows are sparse by design
_MFU_MEASURED_TTL_S = 600.0


def _hbm_digest_fresh() -> bool:
    mod = sys.modules.get(_PKG + ".hbm")
    if mod is None:
        return False
    last = getattr(mod.ACCOUNTANT, "last_publish_wall", 0.0)
    return bool(last) and time.time() - last <= _HBM_DIGEST_TTL_S


def _measured_mfu_fresh() -> bool:
    mod = sys.modules.get(_PKG + ".analysis.device_profile")
    if mod is None:
        return False
    last = getattr(mod, "last_publish_wall", 0.0)
    return bool(last) and time.time() - last <= _MFU_MEASURED_TTL_S


def _serving_digest_fresh() -> bool:
    """The serving keys ride only while a serving loop (batcher dispatch
    or decode iteration) woke within ``FLAGS_fleet_digest_ttl_s``:
    liveness, not traffic, so an idle healthy replica keeps reporting."""
    mod = sys.modules.get(_PKG + ".serving.scheduler")
    if mod is None:
        return False
    last = getattr(mod, "last_alive_wall", 0.0)
    try:
        from .flags import get_flags
        ttl = float(get_flags("FLAGS_fleet_digest_ttl_s")
                    ["FLAGS_fleet_digest_ttl_s"])
    except Exception:
        ttl = 10.0
    return bool(last) and time.time() - last <= ttl


#: the digest's keys, most important first: ``capped_digest`` drops from
#: the end of this list, and drops keys not on it before any that are
#: (the reference's order, the comms keys included)
_DIGEST_PRIORITY = ("step_ms", "comm_wait", "nanf", "gnorm", "hbm",
                    "hdrm", "mfu", "mfu_m", "comm_ms", "comm_bw",
                    "srv_q", "queue", "inflight", "occ", "slots", "tps",
                    "steps")


def capped_digest(digest: Dict[str, Any],
                  max_bytes: int = DIGEST_MAX_BYTES) -> Dict[str, Any]:
    """Drop keys until the sorted-key JSON fits ``max_bytes``: unknown
    extras first (reverse-sorted), then known keys from least to most
    important; ``step_ms`` goes last."""
    d = dict(digest)
    while d and len(json.dumps(d, sort_keys=True)) > max_bytes:
        extras = sorted((k for k in d if k not in _DIGEST_PRIORITY),
                        reverse=True)
        if extras:
            d.pop(extras[0])
        else:
            d.pop(next(k for k in reversed(_DIGEST_PRIORITY) if k in d))
    return d


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
