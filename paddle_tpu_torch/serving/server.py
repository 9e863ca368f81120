"""Multi-tenant inference servers: tenant plane, SLO plane and graceful
drain (the port of ``paddle_tpu/serving/server.py``).

Two servers share one admission plane (:class:`_ServerBase`):
:class:`InferenceServer` serves request/response models through bucketized
continuous batching, :class:`DecodeServer` generates tokens through the
paged-KV decode engine.  Admission is per tenant: an outstanding quota
(``tenant_quota``, or a tenant's own from ``set_quota``) is enforced at
submit, and a draining server rejects new work while it finishes everything
admitted.  Every tenant has a request counter, a queue-depth gauge and a
latency histogram in ``monitor``; ``TenantPlane.evict`` retires them
(``monitor.retire_tenant_series``) and bumps the tenant's generation, so a
request admitted before the eviction accounts to ``tenant="retired"``.

The SLO plane (``serving/slo.py``): with ``FLAGS_serving_slo`` set, every
resolved request feeds a ``BurnRateEvaluator`` that a small thread
evaluates every ``FLAGS_serving_slo_eval_interval_s``; ``statusz()["slo"]``
is its state, and ``FLAGS_serving_slo_shed`` refuses a breached tenant's
new work.  ``enable_http`` serves ``/metrics``, ``/healthz`` and
``/statusz`` (``serving/httpd.py``); ``serve_until_terminated`` blocks
until SIGTERM or SIGINT (whose handlers only set an event), then drains and
returns 0 when nothing was dropped.  Both servers report the memory budget
(``FLAGS_memory_budget_mb``) in ``statusz()["memory"]``, under which
:class:`InferenceServer` admits each bucket's batch width
(``shrink_widths`` halves them), and register ``statusz`` with the OOM
forensics' census when they start.
"""

from __future__ import annotations

import signal
import threading
import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from .. import monitor as _monitor
from .bucketing import BucketPlan, parse_buckets
from .scheduler import (ContinuousBatcher, DecodeScheduler, Request,
                        ServingFuture)


class AdmissionError(RuntimeError):
    """A request refused at admission (quota / draining / too long)."""


class TenantPlane:
    """Per-tenant admission and telemetry bookkeeping (ref server.py:34-146):
    outstanding (queued + in-flight) requests per tenant against its quota
    (0 = unlimited), its monitor series, and counts of rejected submits
    (:attr:`rejected`, by (tenant, reason))."""

    def __init__(self, default_quota: int = 0, on_evict=None):
        self._mu = threading.Lock()
        self._on_evict = on_evict    # eviction hook (the SLO plane's forget)
        self._outstanding: Dict[str, int] = {}  # guarded-by: _mu
        self._quotas: Dict[str, int] = {}  # guarded-by: _mu
        self._evicted: set = set()  # guarded-by: _mu
        # incarnation counter, bumped on evict: a request carries the
        # generation it was admitted under, so a straggler from before an
        # eviction neither shrinks the re-admitted tenant's count nor
        # re-mints its folded series
        self._gen: Dict[str, int] = {}  # guarded-by: _mu
        self._default_quota = int(default_quota)
        #: (tenant, reason) -> rejected submits
        self.rejected: Dict[tuple, int] = {}  # guarded-by: _mu

    def generation(self, tenant: str) -> int:
        with self._mu:
            return self._gen.get(str(tenant), 0)

    def is_current(self, tenant: str, gen: Optional[int]) -> bool:
        """True while the request's incarnation is live: the tenant is not
        evicted and (when the request carries one) its admission generation
        is the current one."""
        tenant = str(tenant)
        with self._mu:
            if tenant in self._evicted:
                return False
            return gen is None or gen == self._gen.get(tenant, 0)

    def set_quota(self, tenant: str, quota: int) -> None:
        with self._mu:
            self._quotas[str(tenant)] = int(quota)

    def try_admit(self, tenant: str) -> bool:
        """Reserve one outstanding unit; False when over quota (the caller
        counts the rejection)."""
        tenant = str(tenant)
        with self._mu:
            quota = self._quotas.get(tenant, self._default_quota)
            cur = self._outstanding.get(tenant, 0)
            if quota > 0 and cur >= quota:
                return False
            self._outstanding[tenant] = cur + 1
            depth = cur + 1
            # a fresh submit is a new incarnation: it may mint series again
            self._evicted.discard(tenant)
        _monitor.SERVING_REQ_CTR.inc(1, tenant=tenant)
        _monitor.SERVING_QUEUE_GAUGE.set(depth, tenant=tenant)
        return True

    def _account(self, tenant: str, gen: Optional[int]) -> tuple:
        """(label to account under, depth or None): a request of an evicted
        tenant, or of an earlier incarnation, lands in the "retired" series
        and leaves the new incarnation's count alone."""
        with self._mu:
            stale = gen is not None and gen != self._gen.get(tenant, 0)
            if tenant in self._evicted or stale:
                return "retired", None
            depth = max(0, self._outstanding.get(tenant, 1) - 1)
            self._outstanding[tenant] = depth
            return tenant, depth

    def complete(self, tenant: str, latency_ms: float,
                 gen: Optional[int] = None) -> None:
        label, depth = self._account(str(tenant), gen)
        _monitor.SERVING_DONE_CTR.inc(1, tenant=label)
        _monitor.SERVING_LAT_HIST.observe(latency_ms, tenant=label)
        if depth is not None:
            _monitor.SERVING_QUEUE_GAUGE.set(depth, tenant=label)

    def fail(self, tenant: str, gen: Optional[int] = None) -> None:
        label, depth = self._account(str(tenant), gen)
        _monitor.SERVING_FAIL_CTR.inc(1, tenant=label)
        if depth is not None:
            _monitor.SERVING_QUEUE_GAUGE.set(depth, tenant=label)

    def reject(self, tenant: str, reason: str) -> None:
        tenant = str(tenant)
        with self._mu:
            if tenant in self._evicted:
                tenant = "retired"
            key = (tenant, reason)
            self.rejected[key] = self.rejected.get(key, 0) + 1
        _monitor.SERVING_REJECT_CTR.inc(1, tenant=tenant, reason=reason)

    def snapshot(self) -> Dict[str, int]:
        """Per-tenant outstanding (queued + in-flight) counts."""
        with self._mu:
            return {t: n for t, n in self._outstanding.items()
                    if t not in self._evicted}

    def evict(self, tenant: str) -> None:
        """Drop the tenant and retire its registry series (counters fold
        into ``tenant="retired"``, totals exact).  Its in-flight requests
        finish normally and account to "retired"."""
        tenant = str(tenant)
        with self._mu:
            self._outstanding.pop(tenant, None)
            self._quotas.pop(tenant, None)
            self._evicted.add(tenant)
            self._gen[tenant] = self._gen.get(tenant, 0) + 1
        _monitor.retire_tenant_series(tenant)
        if self._on_evict is not None:
            self._on_evict(tenant)

    def outstanding(self, tenant: str) -> int:
        with self._mu:
            return self._outstanding.get(str(tenant), 0)


def _failed(msg: str) -> ServingFuture:
    """A future already failed with :class:`AdmissionError`."""
    f = ServingFuture()
    f._fail(AdmissionError(msg))
    return f


class _ServerBase:
    """Admission, completion, the SLO loop, the scrape endpoint, drain,
    signals and stop, shared by both servers (ref server.py:149-351)."""

    def __init__(self, tenant_quota: Optional[int] = None):
        from ..flags import get_flags
        from .slo import BurnRateEvaluator
        fl = get_flags(["FLAGS_serving_slo_shed",
                        "FLAGS_serving_slo_eval_interval_s"])
        self.tenants = TenantPlane(int(tenant_quota or 0),
                                   on_evict=self._forget_slo)
        self._draining = threading.Event()
        self._started = False
        self._old_handlers: Dict[int, Any] = {}
        self._sched = None       # set by the subclass
        #: the per-tenant burn-rate state machine; None = SLO plane off
        self.slo = BurnRateEvaluator.from_flags()
        self._slo_shed = bool(fl["FLAGS_serving_slo_shed"])
        self._slo_interval = float(fl["FLAGS_serving_slo_eval_interval_s"])
        self._slo_stop = threading.Event()
        self._slo_thread: Optional[threading.Thread] = None
        self._slo_eval_warned = False
        self._http = None        # MetricsHTTPServer (enable_http)

    def _forget_slo(self, tenant: str) -> None:
        """Tenant-eviction hook: the evaluator stops tracking the tenant, or
        its next tick would re-mint the series just retired."""
        if self.slo is not None:
            self.slo.forget(tenant)

    def _slo_eval_safe(self) -> None:
        """One evaluator tick.  The loop outlives an evaluator bug, but not
        silently: the first failure warns with the error, since stale
        breach-free gauges during an outage mislead."""
        try:
            self.slo.evaluate()
        except Exception as e:
            if not self._slo_eval_warned:
                self._slo_eval_warned = True
                warnings.warn(
                    "serving SLO evaluator failed — burn/breach gauges "
                    f"are stale until it recovers: {e!r}")

    # -- admission -----------------------------------------------------------
    def _admit(self, tenant: str) -> Optional[str]:
        """None = admitted (one outstanding unit reserved); otherwise the
        rejection reason (already counted)."""
        if self._draining.is_set():
            self.tenants.reject(tenant, "draining")
            return "draining"
        if (self._slo_shed and self.slo is not None
                and self.slo.in_breach(tenant)):
            # shed on burn: new work would only deepen the breach
            self.tenants.reject(tenant, "slo_shed")
            return "slo_shed"
        if not self.tenants.try_admit(tenant):
            self.tenants.reject(tenant, "quota")
            return "quota"
        return None

    def _refuse(self, tenant: str, reason: str, msg: str) -> ServingFuture:
        """Count a rejection under ``reason`` and return its failed
        future."""
        self.tenants.reject(tenant, reason)
        return _failed(msg)

    def _enqueue(self, req: Request) -> ServingFuture:
        req.admit_gen = self.tenants.generation(req.tenant)
        if not self._sched.enqueue(req):
            # enqueue raced stop(): nothing will ever service the queue
            self._on_fail(req, AdmissionError("server stopped"))
        return req.future

    def _on_complete(self, req: Request, result, latency_ms: float):
        req.future._resolve(result)
        self.tenants.complete(req.tenant, latency_ms, gen=req.admit_gen)
        # a request resolving after its tenant's eviction must not
        # un-forget the tenant in the SLO plane
        if self.slo is not None \
                and self.tenants.is_current(req.tenant, req.admit_gen):
            self.slo.record(req.tenant, ok=True, latency_ms=latency_ms)

    def _on_fail(self, req: Request, err: BaseException):
        req.future._fail(err)
        self.tenants.fail(req.tenant, gen=req.admit_gen)
        if self.slo is not None \
                and self.tenants.is_current(req.tenant, req.admit_gen):
            self.slo.record(req.tenant, ok=False)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if not self._started:
            self._sched.start()
            self._started = True
            # OOM forensics census: a dump includes this server's memory
            # section (weakly registered: it never keeps a server alive)
            from .. import hbm as _hbm
            _hbm.register_census(self.statusz)
        if self.slo is not None and self._slo_thread is None:
            self._slo_stop.clear()
            self._slo_thread = threading.Thread(
                target=self._slo_loop, name="serving-slo", daemon=True)
            self._slo_thread.start()
        return self

    def _slo_loop(self) -> None:
        while not self._slo_stop.wait(self._slo_interval):
            self._slo_eval_safe()

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Stop admitting and block until every in-flight request has
        resolved.  True when nothing was dropped."""
        self._draining.set()
        return self._sched.drain(timeout_s)

    def stop(self) -> None:
        self._draining.set()
        self._sched.stop()
        self._slo_stop.set()
        if self._slo_thread is not None:
            self._slo_thread.join(timeout=2.0)
            self._slo_thread = None      # start() can relaunch it
        if self.slo is not None:
            self._slo_eval_safe()          # the final state for an export
        if self._http is not None:
            self._http.stop()
            self._http = None

    def queue_depth(self) -> int:
        return self._sched.queue_depth()

    # -- the scrape endpoint -------------------------------------------------
    def _health(self):
        draining = self._draining.is_set()
        return (not draining, "draining" if draining else "ok")

    def statusz(self) -> Dict[str, Any]:
        """Operational snapshot for ``/statusz`` (subclasses extend)."""
        return {"draining": self._draining.is_set(),
                "queue_depth": self.queue_depth(),
                "tenants": self.tenants.snapshot(),
                "slo": self.slo.state() if self.slo is not None else None}

    def enable_http(self, port: Optional[int] = None,
                    host: Optional[str] = None):
        """Start this server's ``/metrics`` ``/healthz`` ``/statusz``
        endpoint (idempotent).  ``port=None`` reads ``FLAGS_metrics_port``,
        whose default 0 means disabled: the call then returns None.  An
        explicit ``port=0`` binds an ephemeral port (read ``.port``).
        ``host=None`` reads ``FLAGS_metrics_host``."""
        if self._http is not None:
            return self._http
        from ..flags import get_flags
        if port is None:
            port = int(get_flags("FLAGS_metrics_port")
                       ["FLAGS_metrics_port"])
            if port <= 0:
                return None
        if host is None:
            host = str(get_flags("FLAGS_metrics_host")
                       ["FLAGS_metrics_host"])
        from .httpd import MetricsHTTPServer
        self._http = MetricsHTTPServer(
            port=int(port), host=host, health_fn=self._health,
            status_fn=self.statusz).start()
        return self._http

    # -- SIGTERM graceful drain ----------------------------------------------
    def install_signal_handlers(
            self, signals: Sequence[int] = (signal.SIGTERM,
                                            signal.SIGINT)) -> None:
        for s in signals:
            self._old_handlers[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        # only an Event.set: taking a metric or tracer lock while
        # interrupting the main thread's own critical section could
        # deadlock at the moment the drain must run
        self._draining.set()

    def serve_until_terminated(self, poll_s: float = 0.05,
                               drain_timeout_s: float = 60.0) -> int:
        """Block until SIGTERM or SIGINT, then drain and return the exit
        code (0 = no in-flight request dropped).  With
        ``FLAGS_metrics_port`` set the scrape endpoint runs meanwhile, and
        ``/healthz`` answers 503 from the moment draining starts."""
        self.install_signal_handlers()
        from ..flags import get_flags
        if self._http is None and int(
                get_flags("FLAGS_metrics_port")["FLAGS_metrics_port"]) > 0:
            self.enable_http()
        try:
            while not self._draining.is_set():
                time.sleep(poll_s)
            ok = self.drain(drain_timeout_s)
        finally:
            for s, h in self._old_handlers.items():
                signal.signal(s, h)
            self._old_handlers.clear()
            self.stop()
        return 0 if ok else 1


class InferenceServer(_ServerBase):
    """Bucketized continuous-batching server for request/response models.

    ``program_factory(seq_len) -> (program, feed_names, fetch_names)``
    materializes the model at one bucket length (each bucket is its own
    program, all sharing one scope of parameters).  The executor builds one
    plan per bucket, so ``compile_stats()["traces"]`` equals the bucket
    count, never the number of distinct request shapes.  Without an
    ``executor`` the server runs on ``Executor()``, i.e. ``cuda:0``.
    Defaults are the reference's flag defaults: ``max_batch`` 8,
    ``batch_wait_ms`` 2, no tenant quota, buckets powers of two from 8 to
    ``max_seq`` (512), ``max_retries`` ``FLAGS_serving_max_retries`` (a
    batch whose dispatch raised a transient fault is re-dispatched that
    many times), ``memory_budget_mb`` ``FLAGS_memory_budget_mb`` (each
    bucket's width halves until its static peak plan fits it).
    """

    def __init__(self, program_factory: Callable[[int], tuple], scope,
                 buckets=None, max_batch: Optional[int] = None,
                 max_seq: Optional[int] = None, executor=None,
                 tenant_quota: Optional[int] = None,
                 batch_wait_ms: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 memory_budget_mb: Optional[int] = None):
        from ..framework.executor import Executor
        from ..flags import get_flags
        if memory_budget_mb is None:
            memory_budget_mb = get_flags("FLAGS_memory_budget_mb")[
                "FLAGS_memory_budget_mb"]
        if buckets is None:
            buckets = parse_buckets("", max_len=int(max_seq or 512))
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.scope = scope
        self.executor = executor or Executor()
        super().__init__(tenant_quota)
        self.plan = BucketPlan(self.buckets, program_factory,
                               int(max_batch or 8),
                               memory_budget_mb=int(memory_budget_mb))
        if max_retries is None:
            max_retries = get_flags("FLAGS_serving_max_retries")[
                "FLAGS_serving_max_retries"]
        self._sched = ContinuousBatcher(
            self.executor, scope, self.plan,
            on_complete=self._on_complete, on_fail=self._on_fail,
            max_retries=max_retries,
            batch_wait_ms=2.0 if batch_wait_ms is None else batch_wait_ms)

    def warmup(self, buckets=None) -> int:
        """Run each bucket once with a dummy full-width batch, so every
        bucket's program and plan exist before traffic.  Returns the number
        of buckets warmed."""
        n = 0
        for b in (buckets or self.buckets):
            compiled, feed_names, fetch_names, width = self.plan.plan(b)
            block = compiled.program.global_block()
            feed = {}
            for name in feed_names:
                var = block.var(name)
                shape = [width] + [b if d == -1 or d is None else int(d)
                                   for d in (var.shape or ())[1:]]
                # the DECLARED dtype: the plan key includes the feed
                # signature, so a warmup in another dtype would build a
                # plan no real request uses
                feed[name] = np.zeros(shape, np.dtype(str(var.dtype)))
            self.executor.run(compiled, feed=feed,
                              fetch_list=list(fetch_names),
                              scope=self.scope, return_numpy=True)
            n += 1
        return n

    def submit(self, tenant: str, feeds: Dict[str, Any],
               seq_len: Optional[int] = None) -> ServingFuture:
        """Queue one request (per-example feeds, NO batch dim) and return
        its future.  Rejected requests get a future already failed with
        :class:`AdmissionError`.  ``seq_len`` overrides the TRIM length of
        the fetches; the bucket is always chosen to fit every feed."""
        t0 = time.perf_counter()
        feeds = {k: np.asarray(v) for k, v in feeds.items()}
        longest = max((a.shape[0] for a in feeds.values() if a.ndim),
                      default=0)
        n = int(seq_len) if seq_len is not None else longest
        bucket = self.plan.bucket_for(max(n, longest))
        if bucket is None:
            return self._refuse(
                tenant, "too_long",
                f"request length {max(n, longest)} exceeds the largest "
                f"bucket {self.buckets[-1]}")
        reason = self._admit(tenant)
        if reason is not None:
            return _failed(f"tenant {tenant!r} rejected ({reason})")
        req = Request(tenant, feeds=feeds, seq_len=n, bucket=bucket)
        # the admit phase starts at submit's entry, so the phase chain
        # partitions the whole measured latency
        req.t_submit = req.tm["submit"] = t0
        return self._enqueue(req)

    def compile_stats(self) -> Dict[str, int]:
        st = self.executor.dispatch_stats()
        return {"traces": int(st["traces"]),
                "compiled_blocks": int(st["compiled_blocks"]),
                "buckets": len(self.buckets)}

    def batch_log(self):
        """Per-batch records of the scheduler (see
        :meth:`ContinuousBatcher.batch_log`)."""
        return self._sched.batch_log()

    def alive_stats(self, reset: bool = False):
        """Batches on the card at once (see
        :meth:`ContinuousBatcher.alive_stats`)."""
        return self._sched.alive_stats(reset)

    def shrink_widths(self) -> Dict[int, int]:
        """Halve every built bucket's admitted batch width (ref
        server.py:470, the fleet's degradation rung); the next batch of a
        bucket runs at its new width."""
        return self.plan.shrink_widths()

    def statusz(self) -> Dict[str, Any]:
        out = super().statusz()
        out["buckets"] = {str(b): self.plan.width_of(b)
                          for b in self.buckets}
        out["compile"] = self.compile_stats()
        # memory section: the budget in force and each built bucket's
        # admitted width and static peak at that width (a cold bucket
        # reports None: statusz never triggers a build)
        out["memory"] = {
            "budget_mb": int(self.plan._budget),
            "per_bucket": {
                str(b): {"width": self.plan.width_of(b),
                         "static_peak_bytes": self.plan.static_peak_of(b)}
                for b in self.buckets},
        }
        occ = _monitor.REGISTRY.get("paddle_tpu_serving_batch_occupancy")
        if occ is not None:
            tot_sum = tot_n = 0.0
            for labels, cell in occ.series():
                if labels.get("mode") != "batch":
                    continue    # a coexisting decode loop's iterations
                _counts, s, c = cell.snapshot()
                tot_sum += s
                tot_n += c
            if tot_n:
                out["mean_occupancy"] = round(tot_sum / tot_n, 3)
        return out


class DecodeServer(_ServerBase):
    """Continuous-batching token-generation server (GPT causal LM).

    Wraps a :class:`~paddle_tpu_torch.serving.kv_cache.DecodeEngine`:
    requests carry a prompt + ``max_new_tokens``; the decode loop admits
    them into KV slots, prefills and generates through ONE step (on the
    card, one captured CUDA graph), and frees the paged cache on completion
    — slot reuse across requests with ``trace_count`` flat.  A transient
    step fault is retried up to ``max_retries`` times
    (``FLAGS_serving_max_retries`` by default)."""

    def __init__(self, engine, tenant_quota: Optional[int] = None,
                 max_retries: Optional[int] = None):
        from ..flags import get_flags
        super().__init__(tenant_quota)
        if max_retries is None:
            max_retries = get_flags("FLAGS_serving_max_retries")[
                "FLAGS_serving_max_retries"]
        self.engine = engine
        self._sched = DecodeScheduler(
            engine, on_complete=self._on_complete, on_fail=self._on_fail,
            max_retries=int(max_retries))

    def submit(self, tenant: str, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> ServingFuture:
        """Queue one generation request; its future resolves to the
        generated token ids (int32, EOS included when hit).  An empty
        prompt, or a prompt plus ``max_new_tokens`` past the engine's
        context window, is refused (counted as ``too_long``)."""
        t0 = time.perf_counter()
        prompt = np.asarray(prompt).ravel()
        if prompt.size == 0:
            return self._refuse(tenant, "too_long", "empty prompt")
        if prompt.size + int(max_new_tokens) > self.engine.max_seq:
            return self._refuse(
                tenant, "too_long",
                f"prompt {prompt.size} + max_new_tokens {max_new_tokens} "
                f"exceeds the engine context window {self.engine.max_seq}")
        reason = self._admit(tenant)
        if reason is not None:
            return _failed(f"tenant {tenant!r} rejected ({reason})")
        req = Request(tenant, prompt=prompt,
                      max_new_tokens=int(max_new_tokens), eos_id=eos_id)
        req.t_submit = req.tm["submit"] = t0
        return self._enqueue(req)

    def compile_stats(self) -> Dict[str, int]:
        return {"traces": int(self.engine.trace_count),
                "kv_pages_in_use": self.engine.cache.pages_in_use()}

    def iter_log(self):
        """Per-iteration records of the decode loop (see
        :meth:`DecodeScheduler.iter_log`)."""
        return self._sched.iter_log()

    def statusz(self) -> Dict[str, Any]:
        out = super().statusz()
        out["slots"] = {"total": self.engine.max_slots,
                        "free": self._sched.free_slots()}
        out["kv_pages_in_use"] = self.engine.cache.pages_in_use()
        out["tokens_per_s"] = float(_monitor.SERVING_TPS_GAUGE.value())
        # memory section: the budget in force and the KV pool census with
        # per-tenant page occupancy and internal fragmentation
        from ..flags import get_flags
        cache = self.engine.cache
        out["memory"] = {
            "budget_mb": int(get_flags("FLAGS_memory_budget_mb")
                             ["FLAGS_memory_budget_mb"]),
            "kv": {"page_len": int(self.engine.page_len),
                   "pages_total": int(cache.n_pages),
                   "pages_in_use": int(cache.pages_in_use()),
                   "pool_bytes": int(cache.pool_bytes()),
                   "per_tenant": self._sched.kv_census()},
        }
        return out
