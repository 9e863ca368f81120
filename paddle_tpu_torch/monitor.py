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
cell: a bump is then one lock and one add.  Not ported yet: the step tracer
and its spans, the digests, the exporters, the series retirement on tenant
eviction, the per-phase latency histogram and the SLO families, and the
batch server's telemetry.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY"]

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
