"""Continuous-batching schedulers (the port of
``paddle_tpu/serving/scheduler.py``).  Two execution loops, one admission
contract:

- :class:`ContinuousBatcher` (stateless request/response models): an
  admission queue drained by a scheduler thread that coalesces queued
  requests into the widest same-bucket batch available (waiting at most
  ``batch_wait_ms`` for stragglers), pads the batch to the bucket's fixed
  (width, seq) shape, and dispatches through ``Executor.run(...,
  return_numpy=False)``: the run returns once the batch's kernels are
  queued on the card, so host assembly of the next batch overlaps the
  device work of this one.  A separate completion thread materializes the
  fetches (each ``FetchHandle`` waits on the CUDA event recorded at
  dispatch), slices each request's rows back out with the bucket padding
  trimmed, and resolves the futures.  The dispatch runs under
  ``WATCHDOG.watch("serving.batch_dispatch")`` with that injection site
  inside; a transient fault re-dispatches up to ``FLAGS_serving_max_retries``
  times (``paddle_tpu_serving_faults_absorbed_total``, a
  ``serving.fault_absorbed`` tracer instant); any other error, or an
  exhausted budget, fails the batch.

- :class:`DecodeScheduler` (GPT token generation): drives the
  :class:`~paddle_tpu_torch.serving.kv_cache.DecodeEngine` — each iteration
  runs ONE step (on the card, one replay of the captured graph) over the
  fixed slot batch; requests join a free slot (prefill consumes prompt
  tokens one per iteration through the same step), leave on EOS/max-tokens
  (pages freed), and the batch composition changes every iteration with
  nothing rebuilt.  A transient step fault (``FLAGS_fault_inject`` fires,
  errors tagged by ``resilience.mark_transient``) is ABSORBED: the step
  re-runs up to ``FLAGS_serving_max_retries`` times before its requests
  fail — counted in ``paddle_tpu_serving_faults_absorbed_total``.

The decode step runs under ``WATCHDOG.watch("serving.decode_step")``, and
each iteration is a ``serving.decode_iter`` tracer span.  Under
``FLAGS_numerics`` the decode loop scans each iteration's logits, already
on the host, for non-finite values (``numerics.note_nonfinite``, class
``logits``).

Request tracing (ref ``scheduler.py:44-111, 430-460``): every request gets
a trace id, and when it resolves its phase spans (``serving.admit``,
``queue_wait``, ``batch_wait``, ``dispatch``, ``materialize``; the decode
loop's ``decode`` in place of the batch phases) partition submit to
resolve, each tagged with the trace id, tenant and bucket, and land in the
tracer ring and ``paddle_tpu_serving_phase_ms``.  The dispatch span carries
the executor's step id, the batch width, occupancy and padding.  Both
loops stamp ``last_alive_wall`` whenever they wake.

Run-ahead: the batcher dispatches up to :data:`MAX_QUEUED_BATCHES` batches
beyond the one the completion thread is materializing, so up to three
batches' fetches can be alive on the card at once; ``alive_stats()`` reports
the batches from the start of their dispatch until they resolve, and the
most seen at once.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .. import monitor as _monitor
from ..framework.executor import last_step_id
from .bucketing import PAD_TOKENS_CTR

OCCUPANCY_HIST = _monitor.REGISTRY.histogram(
    "paddle_tpu_serving_batch_occupancy",
    "real requests per dispatched batch/decode iteration (mean > 1 == "
    "continuous batching is actually coalescing), by mode: 'batch' for "
    "the coalescing batcher, 'decode' for the KV decode loop — a "
    "process running both must not blend them in per-server views",
    labelnames=("mode",),
    buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 64.0))
BATCHES_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_serving_batches_total",
    "dispatched serving batches / decode iterations, by bucket "
    "(bucket='decode' for the KV-cache loop)", ("bucket",))
FAULTS_ABSORBED_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_serving_faults_absorbed_total",
    "transient dispatch faults absorbed by a batch re-dispatch "
    "(requests completed anyway)")

#: decode iterations kept by ``DecodeScheduler.iter_log``
ITER_LOG_LEN = 65536

#: dispatched batches waiting for the completion thread, beyond the one it
#: is materializing.  Each holds its fetches on the card (2 GB of logits for
#: a bucket-2048 GPT batch) until it is copied out, so the scheduler stops
#: dispatching here instead of running ahead of the copies.
MAX_QUEUED_BATCHES = 2

#: wall clock of the most recent scheduler-loop wake (batcher dispatch or
#: decode iteration): the serving plane's liveness, not traffic — idle loops
#: keep touching it on their bounded waits, a loop wedged in a dispatch stops
last_alive_wall = 0.0


def _touch_alive() -> None:
    global last_alive_wall
    last_alive_wall = time.time()


#: per-process request trace ids: every span of a request's life carries it
_TRACE_IDS = itertools.count(1)


def _emit_request_trace(req: "Request", phases, e2e_ms: float,
                        bucket=None, extra=None) -> None:
    """Emit the request's phase spans, each tagged with its trace id, tenant
    and bucket, into the tracer ring and the per-phase latency histogram.
    ``phases`` is an ordered list of (name, t0, t1) ``perf_counter``
    boundaries that partition submit -> resolve, so the phases sum to the
    measured end-to-end latency; ``extra`` maps a phase name to extra span
    args."""
    bucket = str(req.bucket if bucket is None else bucket)
    tenant = str(req.tenant)
    tracer = _monitor.TRACER
    for name, t0, t1 in phases:
        if t0 is None or t1 is None or t1 < t0:
            continue
        _monitor.SERVING_PHASE_HIST.observe(
            (t1 - t0) * 1e3, phase=name, tenant=tenant, bucket=bucket)
        if tracer.enabled:
            args = {"trace": req.trace_id, "tenant": tenant,
                    "bucket": bucket}
            if name == "materialize":
                # the last span carries the measured e2e, so a reader can
                # check the phase sum against it
                args["e2e_ms"] = round(e2e_ms, 3)
            if extra and name in extra:
                args.update(extra[name])
            tracer.add_complete("serving." + name, "serving", t0, t1,
                                args)


class ServingFuture:
    """Resolution handle for one request (threading.Event based)."""

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def _resolve(self, result) -> None:
        self._result = result
        self._ev.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("serving request still in flight")
        if self._error is not None:
            raise self._error
        return self._result


class Request:
    """One admitted request: per-example feeds (no batch dim), or a decode
    prompt with its generation limits, + future."""

    __slots__ = ("tenant", "feeds", "seq_len", "bucket", "future",
                 "t_submit", "prompt", "max_new_tokens", "eos_id",
                 "admit_gen", "trace_id", "tm")

    def __init__(self, tenant: str, feeds: Optional[Dict[str, Any]] = None,
                 seq_len: int = 0, bucket: int = 0,
                 prompt=None, max_new_tokens: int = 0,
                 eos_id: Optional[int] = None):
        self.tenant = tenant
        self.feeds = feeds
        self.seq_len = seq_len
        self.bucket = bucket
        self.future = ServingFuture()
        self.t_submit = time.perf_counter()
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.admit_gen = 0   # the tenant's incarnation at admission
        self.trace_id = next(_TRACE_IDS)
        # phase boundaries (perf_counter), written along the request's
        # handoffs (submit -> scheduler -> completion thread), each through
        # a lock, so a reader sees the marks of every finished phase
        self.tm: Dict[str, float] = {"submit": self.t_submit}


class ContinuousBatcher:
    """Bucket-coalescing scheduler + completion pipeline (batch mode)."""

    def __init__(self, executor, scope, bucket_plan, on_complete, on_fail,
                 max_retries: int = 1, batch_wait_ms: float = 0.0):
        self._exe = executor
        self._scope = scope
        self._plan = bucket_plan
        self._on_complete = on_complete      # (request, result, latency_ms)
        self._on_fail = on_fail              # (request, exception)
        self._max_retries = int(max_retries)
        self._wait_s = max(0.0, float(batch_wait_ms)) / 1e3
        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()  # guarded-by: _cv
        self._pending = 0          # admitted, not yet resolved  # guarded-by: _cv
        self._stop = False         # guarded-by: _cv
        self._done_cv = threading.Condition()
        self._done_q: collections.deque = collections.deque()  # guarded-by: _done_cv
        self._done_stop = False    # guarded-by: _done_cv
        self._log_mu = threading.Lock()
        self._log: List[dict] = []  # guarded-by: _log_mu
        self._threads: List[threading.Thread] = []
        # batches dispatched and not yet resolved, and the most at once
        self._alive = 0             # guarded-by: _done_cv
        self._max_alive = 0         # guarded-by: _done_cv

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        for name, fn in (("serving-scheduler", self._schedule_loop),
                         ("serving-completion", self._complete_loop)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """Stop accepting work; both threads exit after finishing what is
        already queued/in flight (the scheduler drains the queue, then its
        exit releases the completion thread — never the reverse, so a
        dispatched batch's futures always resolve)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(10.0)

    def enqueue(self, req: Request) -> bool:
        """False when the scheduler has been stopped — nothing would ever
        pop the queue, so the caller must fail the request instead of
        stranding its future (enqueue racing stop())."""
        with self._cv:
            if self._stop:
                return False
            req.tm["enq"] = time.perf_counter()
            self._queue.append(req)
            self._pending += 1
            self._cv.notify()
        return True

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def alive_stats(self, reset: bool = False) -> Dict[str, int]:
        """``alive``: batches whose dispatch has started and that have not
        resolved yet (the one being dispatched, those waiting for the
        completion thread and the one it is materializing), each holding
        its step's memory or its fetches on the card; ``max_alive``: the
        most at once since the last reset.  ``reset`` restarts
        ``max_alive`` at the current count."""
        with self._done_cv:
            out = {"alive": self._alive, "max_alive": self._max_alive}
            if reset:
                self._max_alive = self._alive
        return out

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Block until every admitted request has resolved (completed or
        failed).  False on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._pending > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.1))
        return True

    def batch_log(self) -> List[dict]:
        """One record per completed batch: bucket, width, occupancy,
        ``dispatch_ms`` (host time to queue the batch's work) and
        ``latency_ms`` (dispatch start to fetches on the host)."""
        with self._log_mu:
            return list(self._log)

    # -- scheduler thread ----------------------------------------------------
    def _take_batch(self) -> Optional[List[Request]]:
        """Pop the widest same-bucket batch available, coalescing-wait up
        to the window for stragglers; None on stop with an empty queue."""
        with self._cv:
            while not self._queue and not self._stop:
                _touch_alive()
                self._cv.wait(0.1)
            _touch_alive()
            if not self._queue:
                return None
            bucket = self._queue[0].bucket
        # resolve the bucket plan OUTSIDE the queue lock: a cold bucket
        # builds its program here, and submitters must not block behind
        # it.  Only this thread pops, so the peeked head stays.  A factory
        # error fails that bucket's queued requests, not this thread.
        try:
            width = self._plan.plan(bucket)[3]
        except Exception as e:
            with self._cv:
                bad = self._pop_bucket_locked(bucket, len(self._queue))
            self._fail_batch(bad, e)
            return []
        with self._cv:
            deadline = time.monotonic() + self._wait_s
            batch = self._pop_bucket_locked(bucket, width)
            while len(batch) < width and not self._stop:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
                batch.extend(
                    self._pop_bucket_locked(bucket, width - len(batch)))
            return batch

    def _pop_bucket_locked(self, bucket: int, n: int) -> List[Request]:
        # guarded-by-caller: _cv
        out: List[Request] = []
        if n <= 0:
            return out
        now = time.perf_counter()
        keep: collections.deque = collections.deque()
        while self._queue:
            r = self._queue.popleft()
            if r.bucket == bucket and len(out) < n:
                r.tm["pop"] = now        # queue_wait ends here
                out.append(r)
            else:
                keep.append(r)
        self._queue.extend(keep)
        return out

    def _schedule_loop(self) -> None:
        try:
            self._schedule_loop_inner()
        finally:
            # the completion thread exits only AFTER this thread, so it
            # drains everything the scheduler ever appended
            with self._done_cv:
                self._done_stop = True
                self._done_cv.notify_all()

    def _wait_for_completion_room(self) -> None:
        # requests keep queueing (and coalescing) while this waits
        with self._done_cv:
            while len(self._done_q) >= MAX_QUEUED_BATCHES:
                self._done_cv.wait(0.1)

    def _schedule_loop_inner(self) -> None:
        while True:
            self._wait_for_completion_room()
            batch = self._take_batch()
            if batch is None:
                return
            if not batch:
                continue             # bucket-plan failure already handled
            bucket = batch[0].bucket
            try:
                compiled, feed_names, fetch_names, width = \
                    self._plan.plan(bucket)
                feed = self._assemble(batch, bucket, feed_names, width,
                                      compiled.program)
            except Exception as e:
                # a malformed request fails ITS batch and never this
                # thread: a dead scheduler would strand every later
                # request's future
                self._fail_batch(batch, e)
                continue
            PAD_TOKENS_CTR.inc(width - len(batch))
            # a batch is alive on the card from its dispatch's start (its
            # step allocates as it is issued) until it resolves
            with self._done_cv:
                self._alive += 1
                self._max_alive = max(self._max_alive, self._alive)
                alive = self._alive
            t_d0 = time.perf_counter()
            handles = self._dispatch(compiled, feed, fetch_names, batch)
            t_d1 = time.perf_counter()
            BATCHES_CTR.inc(1, bucket=str(bucket))
            OCCUPANCY_HIST.observe(float(len(batch)), mode="batch")
            _monitor.SERVING_LAST_OCC_GAUGE.set(float(len(batch)))
            if handles is None:
                self._resolved()
                continue
            # this thread dispatched the executor's latest step, so its id
            # names the batch's step (the executor.dispatch span's)
            meta = {"bucket": bucket, "width": width,
                    "occupancy": len(batch), "t_d0": t_d0, "t_d1": t_d1,
                    "step": last_step_id(), "alive": alive}
            with self._done_cv:
                self._done_q.append((batch, handles, meta))
                self._done_cv.notify()
            # the completion thread owns the batch now: a reference kept
            # here would hold its fetches on the card through the next
            # batch's step, beyond what alive_stats() counts
            del handles, feed

    @staticmethod
    def _assemble(batch, bucket, feed_names, width, program):
        """Padded fixed-shape batch feed from the requests' per-example
        arrays.  The bucket program's declared var shapes say which feeds
        carry the sequence axis: only feeds declared at the bucket length
        are padded; fixed-length feeds stack as-is."""
        from .bucketing import pad_to_bucket
        block = program.global_block()
        feed = {}
        for name in feed_names:
            declared = tuple(block.var(name).shape or ()) \
                if block.has_var(name) else ()
            is_seq = len(declared) > 1 and declared[1] == bucket
            rows = [pad_to_bucket(r.feeds[name], bucket) if is_seq
                    else np.asarray(r.feeds[name]) for r in batch]
            a = np.stack(rows)
            if len(batch) < width:           # fixed-shape dummy rows
                a = np.pad(a, [(0, width - len(batch))] +
                           [(0, 0)] * (a.ndim - 1))
            feed[name] = a
        return feed

    def _dispatch(self, compiled, feed, fetch_names, batch):
        """Run the batch; a transient fault re-dispatches up to the retry
        budget, anything else (or an exhausted budget) fails the batch's
        futures and returns None."""
        from .. import resilience as _resil
        attempt = 0
        while True:
            try:
                # a dispatch hung past FLAGS_watchdog_timeout_s raises
                # HungStepError here: not transient, so it fails the batch
                with _resil.WATCHDOG.watch("serving.batch_dispatch"):
                    _resil.maybe_inject("serving.batch_dispatch")
                    return self._exe.run(
                        compiled, feed=feed, fetch_list=list(fetch_names),
                        scope=self._scope, return_numpy=False)
            except Exception as e:
                if _resil.is_transient(e) and attempt < self._max_retries:
                    attempt += 1
                    FAULTS_ABSORBED_CTR.inc()
                    if _monitor.TRACER.enabled:
                        _monitor.TRACER.instant(
                            "serving.fault_absorbed", "serving",
                            {"attempt": attempt, "error": repr(e)[:120]})
                    continue
                self._fail_batch(batch, e)
                return None

    def _fail_batch(self, batch, err) -> None:
        for r in batch:
            self._on_fail(r, err)
        with self._cv:
            self._pending -= len(batch)
            self._cv.notify_all()

    # -- completion thread ---------------------------------------------------
    def _complete_loop(self) -> None:
        while True:
            with self._done_cv:
                while not self._done_q:
                    if self._done_stop:
                        return
                    self._done_cv.wait(0.1)
                batch, handles, meta = self._done_q.popleft()
                self._done_cv.notify_all()     # room for the scheduler
            bucket = meta["bucket"]
            try:
                # materialize AND slice before resolving anything: a
                # failure here (a device error surfacing at the sync)
                # fails the whole batch instead of killing this thread
                outs = [np.asarray(h) for h in handles]
                results = []
                for i, r in enumerate(batch):
                    result = []
                    for a in outs:
                        row = a[i]
                        if (row.ndim >= 1 and row.shape[0] == bucket
                                and r.seq_len != bucket):
                            row = row[:r.seq_len]  # trim bucket padding
                        result.append(row)
                    results.append(result)
            except Exception as e:
                del handles
                self._fail_batch(batch, e)
                self._resolved()
                continue
            now = time.perf_counter()
            with self._log_mu:
                self._log.append({
                    "bucket": bucket, "width": meta["width"],
                    "occupancy": meta["occupancy"],
                    "alive_at_dispatch": meta["alive"],
                    "dispatch_ms": (meta["t_d1"] - meta["t_d0"]) * 1e3,
                    "latency_ms": (now - meta["t_d0"]) * 1e3})
            pad = meta["width"] - meta["occupancy"]
            dispatch_args = {
                "step": meta["step"], "width": meta["width"],
                "occupancy": meta["occupancy"], "pad_rows": pad,
                "pad_frac": round(pad / float(meta["width"]), 4)}
            for r, result in zip(batch, results):
                e2e_ms = (now - r.t_submit) * 1e3
                _emit_request_trace(r, (
                    ("admit", r.tm.get("submit"), r.tm.get("enq")),
                    ("queue_wait", r.tm.get("enq"), r.tm.get("pop")),
                    ("batch_wait", r.tm.get("pop"), meta["t_d0"]),
                    ("dispatch", meta["t_d0"], meta["t_d1"]),
                    ("materialize", meta["t_d1"], now),
                ), e2e_ms, extra={"dispatch": dispatch_args})
                self._on_complete(r, result, e2e_ms)
            with self._cv:
                self._pending -= len(batch)
                self._cv.notify_all()
            # release the batch's fetches before waiting for the next one
            del handles, outs, results
            self._resolved()

    def _resolved(self) -> None:
        """A dispatched batch resolved (completed or failed)."""
        with self._done_cv:
            self._alive -= 1


class _SlotState:
    __slots__ = ("req", "tokens", "pos", "generated", "iters")

    def __init__(self, req: Request):
        self.req = req
        self.tokens: List[int] = [int(t) for t in np.asarray(
            req.prompt).ravel()]
        self.pos = 0
        self.generated: List[int] = []
        self.iters = 0          # decode iterations this request rode


class DecodeScheduler:
    """Continuous-batching loop over the paged-KV decode engine.

    One thread, one step built once: every iteration admits queued
    requests into free slots, feeds each active slot its current token
    (prompt token during prefill, previous argmax during generation), and
    retires slots whose request hit EOS / max_new_tokens — freeing their
    pages for the next request with ``trace_count`` flat."""

    def __init__(self, engine, on_complete, on_fail,
                 max_retries: int = 1):
        self._engine = engine
        self._on_complete = on_complete
        self._on_fail = on_fail
        self._max_retries = int(max_retries)
        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()  # guarded-by: _cv
        self._pending = 0   # guarded-by: _cv
        self._stop = False  # guarded-by: _cv
        self._slots: List[Optional[_SlotState]] = \
            [None] * engine.max_slots
        self._thread: Optional[threading.Thread] = None
        self._iter = 0      # decode-loop iterations (loop thread only)
        #: trailing (t, n_generated) window for the tokens/s gauge —
        #: touched only by the decode thread
        self._tok_win: collections.deque = collections.deque()
        #: per-tenant KV-page ownership — admits happen in _admit_locked
        #: and releases in _retire/_run_step, all on the decode thread, so
        #: no lock; statusz readers go through kv_census(), which snapshots
        #: the slot list
        self._tenant_pages: Dict[str, int] = {}
        #: one record per decode iteration (the newest ITER_LOG_LEN)
        self._log_mu = threading.Lock()
        self._iter_log: collections.deque = collections.deque(
            maxlen=ITER_LOG_LEN)  # guarded-by: _log_mu

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="serving-decode", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop accepting work; the loop exits once every admitted request
        has resolved."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(10.0)

    def enqueue(self, req: Request) -> bool:
        """False when the decode loop has been stopped (see
        :meth:`ContinuousBatcher.enqueue`)."""
        with self._cv:
            if self._stop:
                return False
            req.tm["enq"] = time.perf_counter()
            self._queue.append(req)
            self._pending += 1
            self._cv.notify()
        return True

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def drain(self, timeout_s: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._pending > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.1))
        return True

    def iter_log(self) -> List[dict]:
        """One record per decode iteration: ``occupancy`` (slots stepped),
        ``step_ms`` (host clock around the engine's step, the logits on
        the host included) and ``iter_ms`` (the loop's whole iteration:
        admission, page growth, the step, the argmaxes, retirements)."""
        with self._log_mu:
            return list(self._iter_log)

    def free_slots(self) -> int:
        return sum(1 for st in list(self._slots) if st is None)

    # -- decode loop ---------------------------------------------------------
    def _admit_locked(self) -> None:
        # guarded-by-caller: _cv
        for s, state in enumerate(self._slots):
            if state is not None or not self._queue:
                continue
            req = self._queue[0]
            # reserve the request's WORST-CASE pages now: admission is the
            # only safe wait point (completions run on this same thread, so
            # a mid-flight page stall could never resolve)
            need = -(-(int(np.asarray(req.prompt).size)
                       + req.max_new_tokens) // self._engine.page_len)
            if not self._engine.reserve_slot(s, max(1, need)):
                break               # pool exhausted: wait for completions
            self._queue.popleft()
            req.tm["slot"] = time.perf_counter()   # queue_wait ends
            self._slots[s] = _SlotState(req)
            self._kv_account(req.tenant,
                             len(self._engine.cache.pages_of(s)),
                             reserved=True)

    def _loop(self) -> None:
        eng = self._engine
        S = eng.max_slots
        while True:
            _touch_alive()
            t_l0 = time.perf_counter()
            with self._cv:
                self._admit_locked()
                active_slots = [s for s in range(S)
                                if self._slots[s] is not None]
                if not active_slots:
                    if self._stop:
                        return
                    self._cv.wait(0.1)
                    continue
            ids = np.zeros(S, np.int32)
            pos = np.zeros(S, np.int32)
            active = np.zeros(S, bool)
            stepped = []
            for s in active_slots:
                st = self._slots[s]
                # the page covering this position must exist BEFORE the
                # step writes into it; an exhausted pool parks the slot for
                # this iteration (completions will free pages)
                if not eng.ensure_page(s, st.pos):
                    continue
                ids[s] = st.tokens[st.pos]
                pos[s] = st.pos
                active[s] = True
                stepped.append(s)
            if not stepped:
                time.sleep(0.001)
                continue
            _monitor.SERVING_FREE_SLOTS_GAUGE.set(
                float(S - len(active_slots)))
            self._iter += 1
            t_i0 = time.perf_counter()
            logits = self._run_step(ids, pos, active, stepped)
            t_i1 = time.perf_counter()
            if _monitor.TRACER.enabled:
                _monitor.TRACER.add_complete(
                    "serving.decode_iter", "serving", t_i0, t_i1,
                    {"iter": self._iter, "occupancy": len(stepped)})
            if logits is None:
                continue
            self._logits_sentinel(logits, stepped)
            BATCHES_CTR.inc(1, bucket="decode")
            OCCUPANCY_HIST.observe(float(len(stepped)), mode="decode")
            _monitor.SERVING_LAST_OCC_GAUGE.set(float(len(stepped)))
            now = time.perf_counter()
            n_gen = 0
            for s in stepped:
                st = self._slots[s]
                st.pos += 1
                st.iters += 1
                if st.pos < len(st.tokens):
                    continue                   # prefill: next prompt token
                nxt = int(np.argmax(logits[s]))
                st.tokens.append(nxt)
                st.generated.append(nxt)
                n_gen += 1
                done = (len(st.generated) >= st.req.max_new_tokens
                        or (st.req.eos_id is not None
                            and nxt == st.req.eos_id)
                        or st.pos + 1 >= eng.max_seq)
                if done:
                    self._retire(s, st, now)
            self._update_token_rate(now, n_gen)
            rec = {"occupancy": len(stepped),
                   "step_ms": (t_i1 - t_i0) * 1e3,
                   "iter_ms": (time.perf_counter() - t_l0) * 1e3}
            with self._log_mu:
                self._iter_log.append(rec)

    def _run_step(self, ids, pos, active, stepped):
        from .. import resilience as _resil
        attempt = 0
        while True:
            try:
                # a hung decode iteration dumps stacks and fails its
                # requests (HungStepError is not transient)
                with _resil.WATCHDOG.watch("serving.decode_step"):
                    _resil.maybe_inject("serving.decode_step")
                    return self._engine.run_iteration(ids, pos, active)
            except Exception as e:
                # retry only while the pools survived the failure (the
                # port's in-place pools always do; the reference's donated
                # ones do not when the step died inside the device call)
                alive = self._engine.cache.buffers_alive()
                if (alive and _resil.is_transient(e)
                        and attempt < self._max_retries):
                    attempt += 1
                    FAULTS_ABSORBED_CTR.inc()
                    continue
                # every active slot's cached prefix rides those pools — all
                # of them are lost, not just this iteration's set
                failed = [s for s in range(len(self._slots))
                          if self._slots[s] is not None] \
                    if not alive else list(stepped)
                for s in failed:
                    st = self._slots[s]
                    self._kv_account(
                        st.req.tenant,
                        -len(self._engine.cache.pages_of(s)))
                    self._engine.release_slot(s)
                    self._slots[s] = None
                    self._on_fail(st.req, e)
                if not alive:
                    self._engine.cache.reinit_pools()
                with self._cv:
                    self._pending -= len(failed)
                    self._cv.notify_all()
                return None

    def _logits_sentinel(self, logits, stepped) -> None:
        """The decode path's numerics sentinel (ref scheduler.py:663-682):
        under ``FLAGS_numerics`` a non-finite logit means the model or KV
        state is poisoned and every argmax after it is garbage; count it
        under class ``logits`` with one anomaly record an episode.  The
        logits are on the host already, so the scan waits on nothing."""
        from ..analysis import numerics as _numerics
        if _numerics.mode() == "off":
            return
        sub = logits[stepped] if len(stepped) < logits.shape[0] else logits
        bad = int(sub.size - np.count_nonzero(np.isfinite(sub)))
        _numerics.note_nonfinite(
            "logits", bad, step=self._iter,
            detail={"slots": list(map(int, stepped))} if bad else None)

    def _kv_account(self, tenant, delta: int, reserved: bool = False) -> None:
        """Per-tenant KV-page bookkeeping (decode thread only): the
        occupancy gauge tracks pages currently owned by the tenant's
        requests, and each admission's reservation bumps the cumulative
        counter."""
        tenant = str(tenant)
        total = max(self._tenant_pages.get(tenant, 0) + int(delta), 0)
        self._tenant_pages[tenant] = total
        _monitor.SERVING_KV_TENANT_PAGES.set(float(total), tenant=tenant)
        if total == 0:
            # no pages -> no fragmentation: the frag gauge is otherwise
            # written only by kv_census() scrapes and would freeze at the
            # last in-flight value after the tenant's requests retire
            _monitor.SERVING_KV_TENANT_FRAG.set(0.0, tenant=tenant)
        if reserved and delta > 0:
            _monitor.SERVING_KV_TENANT_ALLOC_CTR.inc(int(delta),
                                                     tenant=tenant)

    def kv_census(self) -> Dict[str, dict]:
        """Per-tenant KV-page occupancy + internal fragmentation (the
        statusz memory section): for every in-flight request, pages owned
        vs positions actually written — ``frag = 1 - written / (pages *
        page_len)`` is the reserved-but-unwritten tail.  Also refreshes the
        per-tenant fragmentation gauge.  Reads a snapshot of the slot list,
        so a concurrent decode iteration costs at most a stale row."""
        page_len = int(self._engine.page_len)
        census: Dict[str, dict] = {}
        for s, st in enumerate(list(self._slots)):
            if st is None:
                continue
            t = str(st.req.tenant)
            row = census.setdefault(
                t, {"pages": 0, "written_tokens": 0, "requests": 0})
            row["pages"] += len(self._engine.cache.pages_of(s))
            row["written_tokens"] += int(st.pos)
            row["requests"] += 1
        for t, row in census.items():
            cap = row["pages"] * page_len
            row["frag"] = round(1.0 - row["written_tokens"] / cap,
                                4) if cap else 0.0
            _monitor.SERVING_KV_TENANT_FRAG.set(row["frag"], tenant=t)
        return census

    def _update_token_rate(self, now: float, n_gen: int,
                           window_s: float = 5.0) -> None:
        """Windowed generated-tokens/s into the tokens/s gauge (decode
        thread only — no lock)."""
        if n_gen:
            _monitor.SERVING_TOKENS_CTR.inc(n_gen)
        win = self._tok_win
        win.append((now, n_gen))
        while win and now - win[0][0] > window_s:
            win.popleft()
        # a lone sample after an idle gap carries no rate information:
        # floor its span at 1 s so the first token back doesn't publish a
        # phantom 1000 tok/s spike
        span = max(now - win[0][0], 1.0 if len(win) == 1 else 1e-3)
        _monitor.SERVING_TPS_GAUGE.set(
            round(sum(n for _, n in win) / span, 3))

    def _retire(self, s, st, now) -> None:
        self._kv_account(st.req.tenant,
                         -len(self._engine.cache.pages_of(s)))
        self._engine.release_slot(s)
        self._slots[s] = None
        out = np.asarray(st.generated, np.int32)
        done_t = time.perf_counter()
        e2e_ms = (done_t - st.req.t_submit) * 1e3
        tm = st.req.tm
        _emit_request_trace(st.req, (
            ("admit", tm.get("submit"), tm.get("enq")),
            ("queue_wait", tm.get("enq"), tm.get("slot")),
            ("decode", tm.get("slot"), now),
            ("materialize", now, done_t),
        ), e2e_ms, bucket="decode",
            extra={"decode": {"iters": st.iters,
                              "generated": len(st.generated)}})
        _monitor.SERVING_FREE_SLOTS_GAUGE.set(float(sum(
            1 for x in self._slots if x is None)))
        self._on_complete(st.req, out, e2e_ms)
        with self._cv:
            self._pending -= 1
            self._cv.notify_all()
