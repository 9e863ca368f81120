"""Multi-tenant inference servers: tenant plane + graceful drain (the port's
``paddle_tpu/serving/server.py``).

Two servers share one admission plane (:class:`_ServerBase`):
:class:`InferenceServer` serves request/response models through bucketized
continuous batching, :class:`DecodeServer` generates tokens through the
paged-KV decode engine.  Admission is per tenant: an outstanding quota
(``tenant_quota``) is enforced at submit, and a draining server rejects new
work while it finishes everything admitted.  Rejections are counted in
:attr:`TenantPlane.rejected`.  Not ported yet (ROADMAP): the per-tenant
quota overrides, tenant generations and eviction, the monitor series of
the tenant plane, the SLO evaluator (``statusz()["slo"]`` is None), the
HTTP surface, the signal handlers and ``serve_until_terminated``.  Both
servers report the memory budget (``FLAGS_memory_budget_mb``) in
``statusz()["memory"]``, under which :class:`InferenceServer` admits each
bucket's batch width, and register ``statusz`` with the OOM forensics'
census when they start.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from .. import monitor as _monitor
from .bucketing import BucketPlan, parse_buckets
from .scheduler import (ContinuousBatcher, DecodeScheduler, Request,
                        ServingFuture)


class AdmissionError(RuntimeError):
    """A request refused at admission (quota / draining / too long)."""


class TenantPlane:
    """Per-tenant admission bookkeeping: outstanding (queued + in-flight)
    requests per tenant against one quota (0 = unlimited), and counts of
    rejected submits."""

    def __init__(self, quota: int = 0):
        self._mu = threading.Lock()
        self._outstanding: Dict[str, int] = {}  # guarded-by: _mu
        #: (tenant, reason) -> rejected submits
        self.rejected: Dict[tuple, int] = {}  # guarded-by: _mu
        self._quota = int(quota)

    def try_admit(self, tenant: str) -> bool:
        """Reserve one outstanding unit; False when over quota."""
        tenant = str(tenant)
        with self._mu:
            cur = self._outstanding.get(tenant, 0)
            if self._quota > 0 and cur >= self._quota:
                return False
            self._outstanding[tenant] = cur + 1
        return True

    def release(self, tenant: str) -> None:
        """One admitted request resolved (completed or failed)."""
        tenant = str(tenant)
        with self._mu:
            self._outstanding[tenant] = max(
                0, self._outstanding.get(tenant, 1) - 1)

    def reject(self, tenant: str, reason: str) -> None:
        with self._mu:
            key = (str(tenant), reason)
            self.rejected[key] = self.rejected.get(key, 0) + 1

    def snapshot(self) -> Dict[str, int]:
        """Per-tenant outstanding (queued + in-flight) counts."""
        with self._mu:
            return dict(self._outstanding)

    def outstanding(self, tenant: str) -> int:
        with self._mu:
            return self._outstanding.get(str(tenant), 0)


def _failed(msg: str) -> ServingFuture:
    """A future already failed with :class:`AdmissionError`."""
    f = ServingFuture()
    f._fail(AdmissionError(msg))
    return f


class _ServerBase:
    """Admission, completion, drain and stop, shared by both servers."""

    def __init__(self, tenant_quota: Optional[int] = None):
        self.tenants = TenantPlane(int(tenant_quota or 0))
        self._draining = threading.Event()
        self._started = False
        self._sched = None       # set by the subclass

    # -- admission -----------------------------------------------------------
    def _admit(self, tenant: str) -> Optional[str]:
        """None = admitted (one outstanding unit reserved); otherwise the
        rejection reason (already counted)."""
        if self._draining.is_set():
            self.tenants.reject(tenant, "draining")
            return "draining"
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
        if not self._sched.enqueue(req):
            # enqueue raced stop(): nothing will ever service the queue
            self._on_fail(req, AdmissionError("server stopped"))
        return req.future

    def _on_complete(self, req: Request, result, latency_ms: float):
        req.future._resolve(result)
        self.tenants.release(req.tenant)

    def _on_fail(self, req: Request, err: BaseException):
        req.future._fail(err)
        self.tenants.release(req.tenant)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if not self._started:
            self._sched.start()
            self._started = True
            # OOM forensics census: a dump includes this server's memory
            # section (weakly registered: it never keeps a server alive)
            from .. import hbm as _hbm
            _hbm.register_census(self.statusz)
        return self

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Stop admitting and block until every in-flight request has
        resolved.  True when nothing was dropped."""
        self._draining.set()
        return self._sched.drain(timeout_s)

    def stop(self) -> None:
        self._draining.set()
        self._sched.stop()

    def queue_depth(self) -> int:
        return self._sched.queue_depth()

    def statusz(self) -> Dict[str, Any]:
        """Operational snapshot (subclasses extend).  ``slo`` is None: the
        SLO plane is not ported."""
        return {"draining": self._draining.is_set(),
                "queue_depth": self.queue_depth(),
                "tenants": self.tenants.snapshot(),
                "slo": None}


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
        req.t_submit = t0
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
        req.t_submit = t0
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
