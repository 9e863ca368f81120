"""Fault-tolerant training: the port of ``paddle_tpu/resilience.py``.

- **Fault injection** (``FLAGS_fault_inject="site:spec[;site:spec...]"``):
  deterministic, flag-driven hooks at the executor's dispatch
  (``executor.dispatch``) and fetch (``fetch.materialize``), checkpoint
  writes (``checkpoint.write``), the decode step and the batch server's
  dispatch.  Spec grammar (comma-joined keys)::

      executor.dispatch:every=3     # every 3rd call raises
      checkpoint.write:once@2       # exactly the 2nd call (also once@step2)
      fetch.materialize:p=0.1,seed=7   # Bernoulli, deterministic stream
      checkpoint.write:times=2      # the first 2 calls
      executor.dispatch:once,hang=30   # hang instead of raise

  An injected fault raises :class:`InjectedFault` (transient by contract)
  and bumps ``paddle_tpu_fault_injected_total{site=...}``; hang mode sleeps
  in small Python-level steps, so the watchdog can interrupt it.
- **Taxonomy**: :func:`mark_transient` tags an exception as retryable and
  :func:`is_transient` reads the tag.
- **Retry engine**: :func:`retry_call` runs a callable under a
  :class:`RetryPolicy` (exponential backoff with a deterministic jitter,
  capped by an optional deadline); each retry bumps
  ``paddle_tpu_retry_attempts_total{site}`` and is a ``retry.backoff``
  tracer span, an exhausted budget bumps
  ``paddle_tpu_retry_giveups_total{site}``.  :class:`CircuitBreaker`
  fails calls fast after a give-up until a half-open probe succeeds.
- **Hung-step watchdog** (``FLAGS_watchdog_timeout_s``): the executor's
  dispatch and fetch run under ``WATCHDOG.watch(site)``; a section past
  its deadline gets every thread's stack, the metrics and the telemetry
  ring dumped to ``FLAGS_watchdog_dump_dir`` and :class:`HungStepError`
  raised in the hung thread.  On the card a dispatch only queues kernels,
  so a hung kernel shows at ``fetch.materialize``, inside a CUDA
  synchronize, where the async raise cannot land: there the
  ``faulthandler`` dump and ``FLAGS_watchdog_escalate=abort`` act.
- **Checkpoints off the training thread** (:class:`CheckpointDaemon`):
  device copies at a step boundary, serialized and committed by a daemon
  thread; :class:`PreemptionGuard` drains at SIGTERM/SIGINT and writes an
  emergency checkpoint at the last complete step; :func:`resume_or_init`
  restarts a loop from the latest one.

The port trains one process: a gang (``gang=``, or ``PADDLE_GANG_DIR`` /
``PADDLE_GANG_COORD`` with ``PADDLE_TRAINERS_NUM`` > 1) raises
``NotImplementedError`` in the daemon, the guard and ``resume_or_init``
(the gang path is ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import os
import random
import re
import signal
import sys
import tempfile
import threading
import time
import traceback
import warnings
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import monitor as _monitor

__all__ = [
    "InjectedFault", "HungStepError", "CircuitOpenError",
    "is_transient", "mark_transient",
    "FaultSpec", "parse_fault_inject", "configure", "maybe_inject",
    "release_hangs", "KNOWN_SITES",
    "backoff_schedule", "RetryPolicy", "retry_call", "CircuitBreaker",
    "CheckpointDaemon", "PreemptionGuard", "resume_or_init",
    "Watchdog", "WATCHDOG", "dump_state",
]

_FAULT_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_fault_injected_total",
    "faults fired by the FLAGS_fault_inject framework", ("site",))
_RETRY_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_retry_attempts_total",
    "retries performed after a transient failure (first attempts do not "
    "count — a clean run exports 0)", ("site",))
_GIVEUP_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_retry_giveups_total",
    "operations abandoned after exhausting their retry/deadline budget",
    ("site",))
_WATCHDOG_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_watchdog_fired_total",
    "hung-step watchdog expirations (each writes a stack+telemetry dump)",
    ("site",))
_PREEMPT_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_preemption_signals_total",
    "SIGTERM/SIGINT deliveries observed by a PreemptionGuard", ("signal",))
_CIRCUIT_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_retry_circuit_open_total",
    "calls failed fast by an open circuit breaker (no RPC attempted, no "
    "backoff paid)", ("site",))
#: live breaker state per named breaker: 0 closed, 1 half_open (a probe
#: was claimed), 2 open
BREAKER_STATE = {"closed": 0, "half_open": 1, "open": 2}
_BREAKER_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_circuit_breaker_state",
    "live circuit-breaker state per named breaker (PS: per endpoint): "
    "0=closed, 1=half_open (a probe call was claimed), 2=open (a "
    "cooled-down breaker stays 2 until some call claims the probe)",
    ("endpoint",))


class InjectedFault(RuntimeError):
    """A deterministic fault fired by ``FLAGS_fault_inject`` — transient by
    contract, so a site with a retry budget absorbs it."""

    pt_transient = True

    def __init__(self, site: str, call_n: int, spec: str):
        super().__init__(
            f"injected fault at {site!r} (call #{call_n}, spec {spec!r})")
        self.site = site
        self.call_n = call_n


class HungStepError(RuntimeError):
    """Raised by the watchdog when a watched section exceeds
    ``FLAGS_watchdog_timeout_s``.  Never retried: the hang has used the
    deadline, and the dump file is the diagnosis."""


class CircuitOpenError(RuntimeError):
    """Raised, without a call, while a circuit breaker is open.  Not
    transient: the half-open probe re-tests the endpoint instead."""

    def __init__(self, name: str, remaining_s: float):
        super().__init__(
            f"circuit breaker for {name!r} is open "
            f"({remaining_s:.2f}s of FLAGS_rpc_circuit_break_secs "
            "cool-down remaining); failing fast")
        self.name = name
        self.remaining_s = remaining_s


def mark_transient(e: BaseException) -> BaseException:
    """Tag an exception as transient, so :func:`is_transient` callers
    retry it."""
    e.pt_transient = True
    return e


def is_transient(e: BaseException) -> bool:
    return bool(getattr(e, "pt_transient", False))


#: the reference's hook sites (a documented contract: parsing warns on an
#: unknown site rather than failing).  The port calls ``maybe_inject`` at
#: ``executor.dispatch``, ``fetch.materialize``, ``checkpoint.write``,
#: ``serving.decode_step`` and ``serving.batch_dispatch``.
KNOWN_SITES = (
    "ps.put", "ps.get", "ps.push_dense", "ps.push_sparse", "ps.get_rows",
    "ps.put_typed", "ps.get_typed", "ps.push_typed",
    "dataloader.produce", "compile", "executor.dispatch",
    "fetch.materialize", "checkpoint.write", "serving.decode_step",
    "collective.launch", "numerics.poison", "memory.oom",
    "serving.batch_dispatch", "router.forward", "coordinator.frame",
    "replica.heartbeat", "autoscaler.decide", "autoscaler.spawn",
    "autoscaler.retire",
)

_ONCE_RE = re.compile(r"^once(?:@(?:step)?(\d+))?$")


class FaultSpec:
    """One site's parsed injection spec and its thread-safe call counter."""

    def __init__(self, site: str, raw: str, every: int = 0, at: int = 0,
                 times: int = 0, p: float = 0.0, seed: int = 0,
                 mode: str = "raise", hang_s: float = 3600.0):
        self.site = site
        self.raw = raw
        self.every = every
        self.at = at
        self.times = times
        self.p = p
        self.seed = seed
        self.mode = mode
        self.hang_s = hang_s
        self._mu = threading.Lock()
        self._count = 0  # guarded-by: _mu
        self._rng = random.Random(seed) if p > 0 else None

    def fire(self):
        """Advance the call counter; -> (should_fire, call_number)."""
        with self._mu:
            self._count += 1
            n = self._count
            hit = ((self.every and n % self.every == 0)
                   or (self.at and n == self.at)
                   or (self.times and n <= self.times)
                   or (self._rng is not None
                       and self._rng.random() < self.p))
        return bool(hit), n

    def __repr__(self):
        return f"FaultSpec({self.site}:{self.raw})"


def parse_fault_inject(value: str) -> Dict[str, FaultSpec]:
    """Parse ``FLAGS_fault_inject`` into {site: FaultSpec}.  Raises
    ``ValueError`` on a malformed entry, so ``set_flags`` refuses a typo'd
    spec up front instead of silently never injecting."""
    specs: Dict[str, FaultSpec] = {}
    for entry in (value or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if ":" not in entry:
            raise ValueError(
                f"fault-inject entry {entry!r} is not 'site:spec'")
        site, _, body = entry.partition(":")
        site = site.strip()
        if site not in KNOWN_SITES:
            warnings.warn(
                f"fault-inject site {site!r} is not a built-in hook "
                f"(known: {', '.join(KNOWN_SITES)}); it will only fire "
                "if something calls maybe_inject() with that name")
        kw: Dict[str, Any] = {}
        for tok in body.split(","):
            tok = tok.strip()
            if not tok:
                continue
            m = _ONCE_RE.match(tok)
            if m:
                kw["at"] = int(m.group(1)) if m.group(1) else 1
                continue
            if tok == "hang":
                kw["mode"] = "hang"
                continue
            if "=" not in tok:
                raise ValueError(
                    f"fault-inject token {tok!r} in {entry!r} not understood"
                    " (expected every=N, once[@N], times=N, p=F, seed=N,"
                    " or hang[=SECS])")
            k, _, v = tok.partition("=")
            k = k.strip()
            if k in ("every", "times", "seed"):
                kw[k] = int(v)
            elif k == "p":
                kw["p"] = float(v)
            elif k == "hang":
                kw["mode"] = "hang"
                kw["hang_s"] = float(v)
            else:
                raise ValueError(
                    f"unknown fault-inject key {k!r} in {entry!r}")
        if not (kw.get("every") or kw.get("at") or kw.get("times")
                or kw.get("p")):
            raise ValueError(
                f"fault-inject entry {entry!r} has no trigger "
                "(every=/once/times=/p=)")
        if kw.get("every", 0) < 0 or kw.get("times", 0) < 0 or \
                not (0.0 <= kw.get("p", 0.0) <= 1.0):
            raise ValueError(f"fault-inject entry {entry!r} out of range")
        specs[site] = FaultSpec(site, body, **kw)
    return specs


#: the live spec table, replaced wholesale by configure(); maybe_inject's
#: fast path is one dict probe against an (almost always) empty dict
_SPECS: Dict[str, FaultSpec] = {}

#: releasing this event wakes every injected hang (test teardown)
_HANG_RELEASE = threading.Event()


def configure(value: str) -> None:
    """(Re)load the injection table from a ``FLAGS_fault_inject`` string
    (setting the flag calls this)."""
    global _SPECS
    _SPECS = parse_fault_inject(value)
    _HANG_RELEASE.clear()


def release_hangs() -> None:
    """Wake every injected hang in progress."""
    _HANG_RELEASE.set()


def _hang(secs: float) -> None:
    # small Python-level sleeps: the watchdog's async raise lands at a
    # bytecode boundary, so this "hung step" is interruptible
    end = time.monotonic() + secs
    while time.monotonic() < end and not _HANG_RELEASE.is_set():
        time.sleep(0.02)


def maybe_inject(site: str) -> None:
    """Injection hook: a no-op unless ``FLAGS_fault_inject`` names
    ``site``; then, on the calls its spec picks, raises
    :class:`InjectedFault` or (``hang`` mode) sleeps."""
    spec = _SPECS.get(site)
    if spec is None:
        return
    hit, n = spec.fire()
    if not hit:
        return
    _FAULT_CTR.inc(1, site=site)
    if _monitor.TRACER.enabled:
        _monitor.TRACER.instant("fault.injected", "resilience",
                                {"site": site, "call": n,
                                 "mode": spec.mode})
    if spec.mode == "hang":
        _hang(spec.hang_s)
        return
    raise InjectedFault(site, n, spec.raw)


# -- retry engine (ref :395-507) ---------------------------------------------

def backoff_schedule(attempts: int, base_delay_s: float = 0.05,
                     multiplier: float = 2.0, max_delay_s: float = 2.0,
                     jitter: float = 0.1, seed: int = 0) -> List[float]:
    """The (attempts - 1) sleeps between tries: exponential growth capped
    at ``max_delay_s``, times a jitter in ``[1 - jitter, 1 + jitter]``
    drawn from ``random.Random(seed)``.  The same arguments give the same
    schedule."""
    if attempts <= 1:
        return []
    rng = random.Random(seed)
    out = []
    d = float(base_delay_s)
    for _ in range(attempts - 1):
        j = 1.0 + jitter * (2.0 * rng.random() - 1.0)
        out.append(min(d, max_delay_s) * j)
        d *= multiplier
    return out


class RetryPolicy:
    """Backoff and budget for one call site.

    ``max_attempts`` counts every try (1 = no retry); ``deadline_s`` caps
    the whole operation: a retry whose sleep would cross it is abandoned.
    ``seed=None`` derives a seed from the site name, so two runs back off
    alike."""

    def __init__(self, max_attempts: int = 3, base_delay_s: float = 0.05,
                 multiplier: float = 2.0, max_delay_s: float = 2.0,
                 jitter: float = 0.1, deadline_s: Optional[float] = None,
                 seed: Optional[int] = None):
        self.max_attempts = max(int(max_attempts), 1)
        self.base_delay_s = base_delay_s
        self.multiplier = multiplier
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.deadline_s = deadline_s
        self.seed = seed

    def schedule(self, site: str = "") -> List[float]:
        seed = self.seed if self.seed is not None else \
            zlib.crc32(site.encode())
        return backoff_schedule(self.max_attempts, self.base_delay_s,
                                self.multiplier, self.max_delay_s,
                                self.jitter, seed)

    @classmethod
    def from_flags(cls, site: str) -> "RetryPolicy":
        """PS sites (``ps.*``) take ``FLAGS_rpc_retry_times`` (retries
        after the first attempt) and ``FLAGS_rpc_deadline`` (ms); other
        sites 3 attempts."""
        from .flags import get_flags
        if site.startswith("ps."):
            fl = get_flags(["FLAGS_rpc_retry_times", "FLAGS_rpc_deadline"])
            return cls(max_attempts=1 + int(fl["FLAGS_rpc_retry_times"]),
                       deadline_s=float(fl["FLAGS_rpc_deadline"]) / 1000.0)
        return cls(max_attempts=3)


def retry_call(site: str, fn: Callable, *args,
               policy: Optional[RetryPolicy] = None,
               retryable: Optional[Callable[[BaseException], bool]] = None,
               **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``policy`` (default:
    ``RetryPolicy.from_flags(site)``).  ``retryable`` picks the exceptions
    that earn a retry (default :func:`is_transient`); :class:`HungStepError`,
    ``KeyboardInterrupt`` and ``SystemExit`` never do."""
    policy = policy or RetryPolicy.from_flags(site)
    check = retryable or is_transient
    delays = None                # built at the first failure
    deadline = (time.monotonic() + policy.deadline_s
                if policy.deadline_s else None)
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except (KeyboardInterrupt, SystemExit, HungStepError):
            raise
        except Exception as e:
            attempt += 1
            if not check(e):
                raise
            if attempt >= policy.max_attempts:
                _GIVEUP_CTR.inc(1, site=site)
                raise
            if delays is None:
                delays = policy.schedule(site)
            delay = delays[attempt - 1]
            if deadline is not None and \
                    time.monotonic() + delay > deadline:
                _GIVEUP_CTR.inc(1, site=site)
                raise RuntimeError(
                    f"{site}: retry deadline exceeded after {attempt} "
                    f"attempt(s) (policy deadline "
                    f"{policy.deadline_s}s): {e}") from e
            _RETRY_CTR.inc(1, site=site)
            with _monitor.TRACER.span("retry.backoff", "resilience",
                                      site=site, attempt=attempt,
                                      delay_s=round(delay, 4)):
                time.sleep(delay)


# -- circuit breaker (ref :510-610) ------------------------------------------

class CircuitBreaker:
    """Closed → open → half-open breaker around a flaky endpoint.

    A retry give-up opens it (:meth:`record_giveup`); while open,
    :meth:`check` raises :class:`CircuitOpenError` without a call.  After
    ``FLAGS_rpc_circuit_break_secs`` of cool-down one call is let through
    as the probe: its success closes the breaker, its give-up re-opens it.
    ``cooldown_s=None`` reads the flag at each check; 0 disables the
    breaker.  A named breaker publishes its state in
    ``paddle_tpu_circuit_breaker_state{endpoint}``; each rejection bumps
    ``paddle_tpu_retry_circuit_open_total{site}``."""

    def __init__(self, name: str = "", cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self._cooldown = cooldown_s
        self._clock = clock
        self._mu = threading.Lock()
        self._opened_at: Optional[float] = None  # guarded-by: _mu
        self._probing = False  # guarded-by: _mu
        self._state_cell = (_BREAKER_GAUGE.labels(endpoint=name)
                            if name else None)
        self._publish("closed")

    def _publish(self, state: str) -> None:
        if self._state_cell is not None:
            self._state_cell.set(BREAKER_STATE[state])

    def cooldown_s(self) -> float:
        if self._cooldown is not None:
            return float(self._cooldown)
        from .flags import get_flags
        return float(get_flags("FLAGS_rpc_circuit_break_secs")
                     ["FLAGS_rpc_circuit_break_secs"])

    @property
    def state(self) -> str:
        """``closed``, ``open`` or ``half_open`` (cooled down: the next
        check claims the probe)."""
        cd = self.cooldown_s()
        with self._mu:
            if self._opened_at is None or cd <= 0:
                return "closed"
            if self._probing or \
                    self._clock() - self._opened_at >= cd:
                return "half_open"
            return "open"

    def check(self, site: str = "") -> None:
        """Gate one call: nothing when closed or disabled; claims the
        probe when cooled down; else raises :class:`CircuitOpenError`."""
        cd = self.cooldown_s()
        if cd <= 0:
            return
        with self._mu:
            if self._opened_at is None:
                return
            elapsed = self._clock() - self._opened_at
            if not self._probing and elapsed >= cd:
                self._probing = True        # this caller is the probe
                self._publish("half_open")
                return
            remaining = max(cd - elapsed, 0.0)
        label = site or self.name or "<unnamed>"
        _CIRCUIT_CTR.inc(1, site=label)
        if _monitor.TRACER.enabled:
            _monitor.TRACER.instant(
                "retry.circuit_open", "resilience",
                {"site": label, "breaker": self.name,
                 "remaining_s": round(remaining, 3)})
        raise CircuitOpenError(self.name or label, remaining)

    def record_success(self) -> None:
        with self._mu:
            self._opened_at = None
            self._probing = False
            self._publish("closed")

    def record_giveup(self) -> None:
        with self._mu:
            self._opened_at = self._clock()
            self._probing = False
            self._publish("open")


# -- hung-step watchdog (ref :613-851) ---------------------------------------

def dump_state(reason: str, site: str = "") -> str:
    """Write every thread's Python stack, the metric totals and the last
    200 tracer events to ``FLAGS_watchdog_dump_dir`` (default: the
    system's temp directory) as ``paddle_tpu_watchdog_<pid>_<ms>.txt``;
    returns the path.  Sections: ``=== watchdog dump ===``, one
    ``--- thread <name> (<ident>) ---`` per thread, ``--- metrics ---``
    and ``--- trace (last 200 events) ---``."""
    from .flags import get_flags
    d = get_flags("FLAGS_watchdog_dump_dir")["FLAGS_watchdog_dump_dir"] \
        or tempfile.gettempdir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(
        d, f"paddle_tpu_watchdog_{os.getpid()}_{int(time.time()*1e3)}.txt")
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = ["=== watchdog dump ===",
             f"reason: {reason}",
             f"site: {site or '<unknown>'}",
             f"pid: {os.getpid()}",
             f"time: {time.strftime('%Y-%m-%dT%H:%M:%S')}",
             ""]
    for tid, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(tid, '?')} ({tid}) ---")
        lines.extend(ln.rstrip("\n")
                     for ln in traceback.format_stack(frame))
        lines.append("")
    lines.append("--- metrics ---")
    try:
        lines.append(json.dumps(_monitor.counter_totals(), indent=1,
                                sort_keys=True))
    except Exception as e:        # the dump must never fail the dumper
        lines.append(f"<metrics unavailable: {e}>")
    lines.append("")
    lines.append("--- trace (last 200 events) ---")
    try:
        lines.append(json.dumps(_monitor.TRACER.chrome_events()[-200:]))
    except Exception as e:
        lines.append(f"<trace unavailable: {e}>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return path


def _async_raise(tid: int, exc_type) -> None:
    """Deliver (``exc_type=None``: withdraw) an async exception in the
    thread ``tid``; it lands at that thread's next bytecode boundary."""
    ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(tid),
        ctypes.py_object(exc_type) if exc_type is not None else None)


class Watchdog:
    """Deadline supervisor for watched sections.  One daemon thread tracks
    every active :meth:`watch`; at a deadline it writes a
    :func:`dump_state` file, bumps ``paddle_tpu_watchdog_fired_total
    {site}`` and async-raises :class:`HungStepError` in the hung thread.
    ``timeout_s <= 0`` (the default) disables it: ``watch()`` is then one
    float compare.

    A thread inside a C call (a CUDA synchronize) takes the async raise
    only when it returns.  So every armed watch also schedules
    ``faulthandler.dump_traceback_later`` (its C-level thread dumps every
    stack without the interpreter lock), and with
    ``FLAGS_watchdog_escalate=abort`` a watch still registered a grace
    window past its deadline SIGABRTs the process."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._watches: Dict[int, dict] = {}  # guarded-by: _cv
        self._ids = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self.timeout_s = 0.0
        #: "" or "abort" (FLAGS_watchdog_escalate)
        self.escalate = ""

    def set_timeout(self, secs: float) -> None:
        with self._cv:
            self.timeout_s = float(secs)
            self._cv.notify()

    def _abort_grace(self) -> float:
        """How long past its deadline a fired watch may stay before the
        abort tier."""
        return max(1.0, min(self.timeout_s, 10.0))

    def _fh_rearm_locked(self) -> None:
        """(Re)arm faulthandler's timer to the earliest unfired deadline,
        or cancel it when none is left."""
        import faulthandler
        deadlines = [e["deadline"] for e in self._watches.values()
                     if not e["fired"]]
        try:
            if not deadlines:
                faulthandler.cancel_dump_traceback_later()
            else:
                faulthandler.dump_traceback_later(
                    max(min(deadlines) - time.monotonic(), 0.05),
                    exit=False)
        except Exception:     # faulthandler unavailable: the Python-level
            pass              # dump still works

    @contextlib.contextmanager
    def watch(self, site: str):
        t = self.timeout_s
        if t <= 0:
            yield
            return
        now = time.monotonic()
        entry = {"tid": threading.get_ident(), "site": site,
                 "deadline": now + t, "timeout": t,
                 "abort_at": now + t + self._abort_grace(),
                 "fired": False, "dump": None}
        with self._cv:
            wid = next(self._ids)
            self._watches[wid] = entry
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="pt-watchdog")
                self._thread.start()
            self._fh_rearm_locked()
            self._cv.notify()
        delivered = False
        try:
            yield
        except HungStepError as he:
            delivered = True
            if entry["fired"]:
                raise HungStepError(self._msg(entry)) from he
            raise
        finally:
            with self._cv:
                self._watches.pop(wid, None)
                self._fh_rearm_locked()
            if entry["fired"] and not delivered:
                # the call ended after the deadline fired but before the
                # async raise landed: withdraw it, or it detonates later
                _async_raise(entry["tid"], None)
        if entry["fired"]:
            raise HungStepError(self._msg(entry))

    @staticmethod
    def _msg(entry: dict) -> str:
        where = entry["dump"] or \
            "<dump still writing — check FLAGS_watchdog_dump_dir>"
        return (f"step hung: {entry['site']!r} exceeded "
                f"FLAGS_watchdog_timeout_s={entry['timeout']}s; thread "
                f"stacks + telemetry dumped to {where}")

    def _abort(self, entry: dict) -> None:
        """The async raise never landed (a hang inside C): dump every
        stack through faulthandler and SIGABRT the process."""
        import faulthandler
        sys.stderr.write(
            f"paddle_tpu watchdog: {entry['site']!r} still hung "
            f"{self._abort_grace():.1f}s past its "
            f"{entry['timeout']}s deadline (async raise never landed — "
            "C-level hang); FLAGS_watchdog_escalate=abort -> SIGABRT\n")
        sys.stderr.flush()
        try:
            faulthandler.dump_traceback(all_threads=True)
        except Exception:
            pass
        entry["abort_at"] = float("inf")   # a handled SIGABRT: no spin
        os.kill(os.getpid(), signal.SIGABRT)

    def _loop(self):
        while True:
            abort_entry = None
            with self._cv:
                now = time.monotonic()
                pending = [(w, e) for w, e in self._watches.items()
                           if not e["fired"]]
                expired = [(w, e) for w, e in pending
                           if e["deadline"] <= now]
                for _, e in expired:
                    e["fired"] = True
                if not expired:
                    fired = [e for e in self._watches.values()
                             if e["fired"]]
                    if self.escalate == "abort":
                        abort_entry = next(
                            (e for e in fired if e["abort_at"] <= now),
                            None)
                    if abort_entry is None:
                        deadlines = [e["deadline"] for _, e in pending]
                        if self.escalate == "abort":
                            deadlines += [e["abort_at"] for e in fired]
                        nxt = min(deadlines, default=now + 5.0)
                        self._cv.wait(timeout=max(nxt - now, 0.02))
                        continue
            if abort_entry is not None:
                self._abort(abort_entry)
                continue
            for wid, e in expired:    # I/O outside the lock
                try:
                    e["dump"] = dump_state(
                        f"watched section exceeded {e['timeout']}s",
                        site=e["site"])
                except Exception:
                    e["dump"] = "<dump failed>"
                _WATCHDOG_CTR.inc(1, site=e["site"])
                if _monitor.TRACER.enabled:
                    _monitor.TRACER.instant(
                        "watchdog.fired", "resilience",
                        {"site": e["site"], "dump": e["dump"]})
                with self._cv:
                    # raise only while the watch is registered: a call
                    # that returned during the dump raises in watch()
                    if wid in self._watches:
                        _async_raise(e["tid"], HungStepError)


WATCHDOG = Watchdog()


# -- gangs: not ported ---------------------------------------------------------

def _refuse_gang(gang, who: str) -> None:
    """The port trains one process.  Raise where the reference would run
    a gang: ``gang`` given, or ``PADDLE_GANG_DIR`` / ``PADDLE_GANG_COORD``
    set with ``PADDLE_TRAINERS_NUM`` > 1 (``GangRendezvous.from_env``)."""
    named = (int(os.getenv("PADDLE_TRAINERS_NUM", "1")) > 1
             and (os.getenv("PADDLE_GANG_COORD")
                  or os.getenv("PADDLE_GANG_DIR")))
    if gang is not None or named:
        raise NotImplementedError(
            f"{who}: gang checkpointing (GangRendezvous, the COMMITTED "
            "manifest) is not ported yet (ROADMAP Queue 1 item 3); the "
            "port trains one process")


# -- background checkpoint daemon (ref :869-1318) ----------------------------

def _report_capture_bytes(n: int) -> None:
    """Attribute the in-flight capture copies' card bytes to the HBM
    accountant's ``ckpt_capture`` class (ref resilience.py:858-866);
    best-effort, telemetry never touches the checkpoint path."""
    try:
        from . import hbm as _hbm
        _hbm.set_ckpt_capture_bytes(n)
    except Exception:
        pass


class CheckpointDaemon:
    """Checkpoints taken off the training thread.

    - **capture** (training thread, at a step boundary): the persistables
      on the card are copied on the current stream into one flat buffer a
      dtype (``torch.cat``: queued, no host wait) and one CUDA event is
      recorded after the copies; a host tensor is cloned.  The copy is
      needed: most lowerings rebind their outputs, but some write in place
      (the decode pools' ``index_put_``), so a bare reference could tear
      under the next step.
    - **serialize and commit** (daemon thread): a side stream waits on the
      capture's event and copies each flat buffer into a pinned host
      buffer the daemon keeps (``record_stream`` keeps the device buffer's
      memory from reuse until then); views of it go to
      ``checkpoint.save_arrays`` and ``checkpoint.commit`` (write, fsync).
      ``start()`` pins those host buffers when the scope already holds the
      state: pinning takes about a second for 1.6 GB and holds up the
      training thread's launches meanwhile, better before the loop than in
      its first save.

    With ``FLAGS_checkpoint_capture_chunk_mb`` > 0 the capture copies in
    groups of at most that many MiB and queues each group's copy to fresh
    pinned host memory on the current stream before the next group, so the
    extra card bytes stay within a chunk (the stream orders the reuse of a
    group's memory after its copy to the host); still no host wait.

    Cadence: ``FLAGS_checkpoint_interval_steps`` and/or
    ``FLAGS_checkpoint_interval_secs`` (the arguments override), checked
    at step boundaries and counted from the checkpoint's latest step (the
    anchor), so a resumed run keeps its phase.  Only the latest pending
    capture is kept when the writer falls behind.
    ``FLAGS_checkpoint_cadence_stretch_frac`` stretches the interval to
    the observed save time (``paddle_tpu_checkpoint_cadence_stretched_
    total``).

    ::

        daemon = CheckpointDaemon(ckpt, interval_steps=100).start()
        with PreemptionGuard(ckpt, executor=exe, daemon=daemon) as g:
            for step in range(start, total):
                exe.run(...)
                g.completed_step(step + 1)

    or ``daemon.attach(exe)`` after the startup program: every completed
    ``run()`` is then a step.

    The capture's card copies are reported to the HBM accountant's
    ``ckpt_capture`` class while they exist (``hbm.set_ckpt_capture_bytes``).
    Not ported yet: the numerics quarantine gate (``analysis/numerics.py``;
    :meth:`_quarantined` returns False, as the reference does at
    ``FLAGS_numerics`` "off", its default) and the gang announce (Queue 1
    item 3).
    """

    def __init__(self, checkpoint, program=None, scope=None,
                 interval_steps: Optional[int] = None,
                 interval_secs: Optional[float] = None,
                 gang=None, capture_chunk_mb: Optional[int] = None,
                 cadence_stretch_frac: Optional[float] = None):
        from .flags import get_flags
        _refuse_gang(gang, "CheckpointDaemon")
        fl = get_flags(["FLAGS_checkpoint_interval_steps",
                        "FLAGS_checkpoint_interval_secs",
                        "FLAGS_checkpoint_capture_chunk_mb",
                        "FLAGS_checkpoint_cadence_stretch_frac"])
        self.checkpoint = checkpoint
        self.program = program
        self.scope = scope
        self.interval_steps = (
            int(fl["FLAGS_checkpoint_interval_steps"])
            if interval_steps is None else int(interval_steps))
        self.interval_secs = (
            float(fl["FLAGS_checkpoint_interval_secs"])
            if interval_secs is None else float(interval_secs))
        self.capture_chunk_mb = (
            int(fl["FLAGS_checkpoint_capture_chunk_mb"])
            if capture_chunk_mb is None else int(capture_chunk_mb))
        self.cadence_stretch_frac = (
            float(fl["FLAGS_checkpoint_cadence_stretch_frac"])
            if cadence_stretch_frac is None
            else float(cadence_stretch_frac))
        self._mu = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        # (step, state, kind, event)
        self._pending: Optional[tuple] = None  # guarded-by: _mu
        # the anchor: a resumed run continues the cadence of the run it
        # resumes (the checkpoint's latest step), a fresh one starts at 0
        anchor = 0
        latest = getattr(checkpoint, "latest_step", None)
        if latest is not None:
            anchor = int(latest() or 0)
        self._last_capture_step = anchor
        self._last_capture_t = time.monotonic()
        self._last_committed: Optional[int] = None  # guarded-by: _mu
        self._last_save_s = 0.0  # guarded-by: _mu
        self._stretch_noted = False     # training thread only
        self._thread: Optional[threading.Thread] = None
        self._hooked: list = []
        self._auto_step = anchor
        # pinned host buffers by (dtype, elements), reused by every save
        # (a save's write is committed before the next one starts)
        self._host_bufs: Dict[tuple, Any] = {}
        self.error: Optional[BaseException] = None

    # -- wiring ---------------------------------------------------------------
    def start(self) -> "CheckpointDaemon":
        if self._thread is None or not self._thread.is_alive():
            self._reserve_host()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="pt-ckpt-daemon")
            self._thread.start()
        return self

    def _pinned(self, dtype, numel: int):
        import torch
        buf = self._host_bufs.get((dtype, numel))
        if buf is None:
            buf = self._host_bufs[(dtype, numel)] = torch.empty(
                numel, dtype=dtype, pin_memory=True)
        return buf

    def _reserve_host(self) -> None:
        """Pin the host buffers of the state the scope holds on the card
        now, as a capture would group it (numel a dtype)."""
        import torch
        from .framework.core import default_main_program
        from .framework.scope import global_scope
        from .io import get_program_persistable_vars
        if self.capture_chunk_mb:
            return                # chunks take fresh pinned memory
        scope = self.scope or global_scope()
        numel: Dict[Any, int] = {}
        for v in get_program_persistable_vars(self.program
                                              or default_main_program()):
            val = scope.find_var(v.name)
            if isinstance(val, torch.Tensor) and val.is_cuda:
                numel[val.dtype] = numel.get(val.dtype, 0) + val.numel()
        for dtype, n in numel.items():
            self._pinned(dtype, n)

    def attach(self, executor) -> "CheckpointDaemon":
        """Drive the cadence from ``executor``'s step-boundary hook: each
        completed ``run()`` counts as one step."""
        executor.add_step_hook(self._executor_hook)
        self._hooked.append(executor)
        return self

    def detach(self) -> None:
        for exe in self._hooked:
            exe.remove_step_hook(self._executor_hook)
        self._hooked.clear()

    def _executor_hook(self, executor, scope) -> None:
        self._auto_step += 1
        self.step_completed(self._auto_step, scope=scope)

    # -- training-thread side -------------------------------------------------
    def due(self, step: int) -> bool:
        base = bool(
            (self.interval_steps
             and step - self._last_capture_step >= self.interval_steps)
            or (self.interval_secs
                and time.monotonic() - self._last_capture_t
                >= self.interval_secs))
        if not base:
            return False
        if self.cadence_stretch_frac > 0:
            with self._mu:
                last_save_s = self._last_save_s
            if last_save_s > 0:
                need = last_save_s / self.cadence_stretch_frac
                if time.monotonic() - self._last_capture_t < need:
                    if not self._stretch_noted:
                        self._stretch_noted = True
                        from . import checkpoint as _ckpt
                        _ckpt.STRETCH_CTR.inc()
                        if _monitor.TRACER.enabled:
                            _monitor.TRACER.instant(
                                "checkpoint.cadence_stretched",
                                "checkpoint",
                                {"step": int(step),
                                 "save_s": round(last_save_s, 3),
                                 "stretched_to_s": round(need, 3)})
                    return False
        return True

    def step_completed(self, step: int, scope=None) -> bool:
        """Step-boundary notification: one compare off-cadence, a capture
        on it; True iff a capture was taken.  Re-raises a failure the
        daemon hit in the background."""
        self.check()
        step = int(step)
        if not self.due(step):
            return False
        return self.capture(step, scope=scope)

    @staticmethod
    def _quarantined(step: int, kind: str) -> bool:
        """The numerics quarantine gate.  ``analysis/numerics.py`` is not
        ported, and the reference's gate holds nothing at its default
        ``FLAGS_numerics`` "off": no capture is held."""
        return False

    def capture(self, step: int, scope=None, kind: str = "daemon") -> bool:
        """Snapshot every persistable of the program at a step boundary
        (see the class docstring); returns False when the quarantine held
        the capture."""
        import torch
        from .framework.core import default_main_program
        from .framework.scope import global_scope
        from .io import get_program_persistable_vars
        if self._quarantined(step, kind):
            return False
        t0 = time.perf_counter()
        program = self.program or default_main_program()
        scope = scope or self.scope or global_scope()
        chunk_bytes = int(self.capture_chunk_mb) << 20
        state: Dict[str, Any] = {}
        on_card: Dict[tuple, list] = {}    # (device, dtype) -> [(name, t)]
        group: List[tuple] = []
        group_bytes = 0
        chunks = 0
        device = None

        def _flush_group():
            nonlocal group, group_bytes, chunks
            for name, copy in group:
                host = torch.empty(copy.shape, dtype=copy.dtype,
                                   pin_memory=True)
                host.copy_(copy, non_blocking=True)
                state[name] = host
            if group:
                chunks += 1
            group = []
            group_bytes = 0
            _report_capture_bytes(0)

        for v in get_program_persistable_vars(program):
            val = scope.find_var(v.name)
            if val is None:
                raise RuntimeError(
                    f"persistable var {v.name!r} has no value in the "
                    "scope; did you run the startup program before "
                    "enabling the checkpoint daemon?")
            if isinstance(val, torch.Tensor) and val.is_cuda:
                device = val.device
                if not chunk_bytes:   # copied below, a flat buffer a dtype
                    on_card.setdefault((device, val.dtype), []).append(
                        (v.name, val.detach()))
                    continue
                nbytes = val.numel() * val.element_size()
                if group and group_bytes + nbytes > chunk_bytes:
                    _flush_group()
                group.append((v.name, val.detach().clone()))
                group_bytes += nbytes
                _report_capture_bytes(group_bytes)
            elif isinstance(val, torch.Tensor):
                state[v.name] = val.detach().clone()
            else:
                state[v.name] = np.array(val, copy=True)
        _flush_group()
        # (flat device buffer, [(name, shape)]) a dtype
        flats = [(torch.cat([t.reshape(-1) for _, t in items]),
                  [(n, tuple(t.shape)) for n, t in items])
                 for items in on_card.values()]
        if flats:
            _report_capture_bytes(sum(f.numel() * f.element_size()
                                      for f, _ in flats))
        event = None
        if device is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        with self._mu:
            self._pending = (int(step), state, kind, event, flats)
            self._last_capture_step = int(step)
            self._last_capture_t = time.monotonic()
        self._stretch_noted = False
        if _monitor.TRACER.enabled:
            args = {"step": int(step), "kind": kind}
            if chunk_bytes:
                args["chunks"] = chunks
                args["chunk_mb"] = int(self.capture_chunk_mb)
            _monitor.TRACER.add_complete(
                "checkpoint.capture", "checkpoint", t0,
                time.perf_counter(), args)
        self._wake.set()
        return True

    # -- daemon-thread side ---------------------------------------------------
    def _loop(self) -> None:
        while True:
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            self._drain_pending()
            if self._stop.is_set():
                return

    def _drain_pending(self) -> None:
        while True:
            with self._mu:
                pending, self._pending = self._pending, None
            if pending is None:
                return
            try:
                self._save(*pending)
            except BaseException as e:  # surfaced at the next
                self.error = e          # step_completed() / stop()

    def _to_host(self, state: Dict[str, Any], event,
                 flats: List[tuple]) -> Dict[str, Any]:
        """The capture's values on the host.  Each flat device buffer goes
        to the daemon's pinned buffer on a side stream that first waits for
        the capture's event; this thread then waits for that stream alone.
        The values are views of the pinned buffers."""
        import torch
        host = dict(state)
        if not flats:
            if event is not None:
                event.synchronize()    # a chunked capture's host copies
            return host
        side = torch.cuda.Stream(flats[0][0].device)
        side.wait_event(event)
        with torch.cuda.stream(side):
            for flat, layout in flats:
                buf = self._pinned(flat.dtype, flat.numel())
                buf.copy_(flat, non_blocking=True)
                # the buffer's memory is not reused before this stream read it
                flat.record_stream(side)
                sizes = [int(np.prod(shape)) for _, shape in layout]
                for (name, shape), part in zip(layout, buf.split(sizes)):
                    host[name] = part.view(shape)
        flats.clear()
        side.synchronize()
        return host

    def _save(self, step: int, state: Dict[str, Any], kind: str,
              event=None, flats: Optional[List[tuple]] = None) -> None:
        t0 = time.monotonic()
        t_p0 = time.perf_counter()
        host = self._to_host(state, event, flats or [])
        # the capture's card copies are gone now
        _report_capture_bytes(0)
        t_p1 = time.perf_counter()
        if not self.checkpoint.save_arrays(step, host, force=True,
                                           kind=kind):
            return
        # durable (written, fsynced) before it counts as committed
        if hasattr(self.checkpoint, "commit"):
            self.checkpoint.commit(kind="rank")
        elif hasattr(self.checkpoint, "wait_until_finished"):
            self.checkpoint.wait_until_finished()
        with self._mu:
            self._last_committed = int(step)
            self._last_save_s = time.monotonic() - t0
        if _monitor.TRACER.enabled:
            _monitor.TRACER.add_complete(
                "checkpoint.persist", "checkpoint", t_p0,
                time.perf_counter(),
                {"step": int(step), "kind": kind,
                 "host_copy_ms": round((t_p1 - t_p0) * 1e3, 3)})
            _monitor.TRACER.instant(
                "checkpoint.committed", "checkpoint",
                {"step": int(step), "kind": kind})

    # -- teardown -------------------------------------------------------------
    @property
    def last_committed(self) -> Optional[int]:
        with self._mu:
            return self._last_committed

    def wait_committed(self, step: int, timeout_s: float = 60.0,
                       poll_s: float = 0.005) -> bool:
        """Block until ``step`` is the last committed step; re-raises a
        background failure; False on timeout."""
        deadline = time.monotonic() + float(timeout_s)
        while True:
            self.check()
            if self.last_committed == int(step):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    def check(self) -> None:
        """Re-raise a background save failure on the caller."""
        if self.error is not None:
            e, self.error = self.error, None
            raise RuntimeError(
                "checkpoint daemon failed in the background") from e

    def stop(self, final_step: Optional[int] = None,
             scope=None) -> Optional[int]:
        """Stop the daemon.  With ``final_step`` (the emergency path): a
        step already committed or in flight is only committed; any other
        is captured now and flushed.  Returns the last committed step."""
        if final_step is not None:
            final_step = int(final_step)
            with self._mu:
                pending_step = (self._pending[0]
                                if self._pending is not None else None)
                committed = self._last_committed
            if committed != final_step and pending_step != final_step:
                self.capture(final_step, scope=scope, kind="emergency")
        self._stop.set()
        self._wake.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        else:
            self._drain_pending()     # never started: drain here
        self.detach()
        self.check()
        return self.last_committed


# -- preemption guard and resume (ref :1320-1630) ----------------------------

class PreemptionGuard:
    """SIGTERM/SIGINT drain for a training loop.

    ::

        ckpt = CheckpointManager(ckpt_dir)
        start = resume_or_init(ckpt, exe, startup_program=startup,
                               main_program=main)
        with PreemptionGuard(ckpt, executor=exe, program=main) as guard:
            for step in range(start, total_steps):
                exe.run(main, feed=batch(step), fetch_list=[loss])
                guard.completed_step(step + 1)
                if guard.preempted:
                    break
        # exit after a signal: drain the executor, checkpoint the last
        # complete step, export telemetry, SystemExit(exit_code)

    The handler only sets a flag; the loop polls ``guard.preempted`` at
    step boundaries, and everything irreversible happens on the exit path.
    Handlers need the main thread; elsewhere :meth:`trigger` still works.
    """

    def __init__(self, checkpoint=None, executor=None, program=None,
                 scope=None, signals=(signal.SIGTERM, signal.SIGINT),
                 export_dir: Optional[str] = None,
                 exit_on_preempt: bool = True, exit_code: int = 0,
                 daemon: Optional[CheckpointDaemon] = None,
                 gang=None):
        _refuse_gang(gang, "PreemptionGuard")
        self.checkpoint = checkpoint
        self.executor = executor
        self.program = program
        self.scope = scope
        self.signals = tuple(signals)
        self.export_dir = export_dir
        self.exit_on_preempt = exit_on_preempt
        self.exit_code = exit_code
        self.daemon = daemon
        if daemon is not None and checkpoint is None:
            self.checkpoint = daemon.checkpoint
        self._preempted = threading.Event()
        self._signum = signal.SIGTERM
        self._noted = False
        self._last_step: Optional[int] = None
        self._old: Dict[int, Any] = {}

    def _handler(self, signum, frame):
        self.trigger(signum)

    def trigger(self, signum: int = signal.SIGTERM) -> None:
        """Record a preemption request (the handler's body).  Lock-free on
        purpose: it interrupts the main thread's own frame, which may hold
        a tracer or metric lock; the counter and the trace instant come
        later, on the exit path (:meth:`_note_signal`)."""
        self._signum = signum
        self._preempted.set()

    def _note_signal(self) -> None:
        if self._noted or not self._preempted.is_set():
            return
        self._noted = True
        signum = self._signum
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        _PREEMPT_CTR.inc(1, signal=name)
        if _monitor.TRACER.enabled:
            _monitor.TRACER.instant("preemption.signal", "resilience",
                                    {"signal": int(signum)})

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    def completed_step(self, step: int) -> None:
        """``step`` steps are complete: the emergency checkpoint saves at
        this index, and the daemon gets its step-boundary call."""
        self._last_step = int(step)
        if self.daemon is not None:
            self.daemon.step_completed(step, scope=self.scope)

    def drain(self) -> None:
        """Wait until every dispatched step has finished on the device."""
        if self.executor is not None and hasattr(self.executor, "drain"):
            with _monitor.TRACER.span("preemption.drain", "resilience"):
                self.executor.drain()

    def emergency_checkpoint(self) -> Optional[int]:
        """Drain, then make the last complete step durable; returns the
        step (None without a manager or a completed step).  With a daemon
        this commits its in-flight save (``stop(final_step=)``)."""
        self.drain()
        if self._last_step is None or \
                (self.checkpoint is None and self.daemon is None):
            return None
        step = self._last_step
        with _monitor.TRACER.span("preemption.checkpoint", "resilience",
                                  step=step):
            if self.daemon is not None:
                durable = self.daemon.stop(final_step=step,
                                           scope=self.scope)
            else:
                self.checkpoint.save(step, program=self.program,
                                     scope=self.scope, force=True,
                                     kind="emergency")
                durable = self.checkpoint.commit(kind="rank")
        if durable != step:
            warnings.warn(
                f"emergency checkpoint at step {step} is not the durable "
                f"latest ({durable})")
        return step

    def __enter__(self):
        for s in self.signals:
            try:
                self._old[s] = signal.signal(s, self._handler)
            except ValueError:      # not the main thread
                warnings.warn(
                    "PreemptionGuard: cannot install signal handlers "
                    "outside the main thread; use guard.trigger()")
                break
        return self

    def __exit__(self, et, ev, tb):
        try:
            # our handlers stay installed here: a second SIGTERM during
            # the drain only re-sets the flag
            if et is None and self.preempted:
                self.emergency_checkpoint()
                if self.export_dir:
                    try:
                        _monitor.export(self.export_dir)
                    except Exception:   # telemetry must not block the exit
                        pass
        finally:
            for s, old in self._old.items():
                try:
                    signal.signal(s, old)
                except ValueError:
                    pass
            self._old.clear()
            self._note_signal()
        if et is None and self.preempted and self.exit_on_preempt:
            raise SystemExit(self.exit_code)
        return False


def resume_or_init(checkpoint, executor, startup_program=None,
                   main_program=None, scope=None, gang=None) -> int:
    """Run the startup program, then restore the latest checkpoint when
    there is one (onto the executor's device).  Returns the number of
    complete steps, the index the loop resumes at::

        start = resume_or_init(ckpt, exe, startup_program=startup,
                               main_program=main)
        for step in range(start, total_steps):
            ...

    A gang (``gang=``, or the launcher's environment naming one) raises
    ``NotImplementedError``: the gang manifest is not ported."""
    from .framework.core import default_startup_program
    _refuse_gang(gang, "resume_or_init")
    startup = startup_program or default_startup_program()
    executor.run(startup, scope=scope)
    step = checkpoint.latest_step()
    if step is None:
        return 0
    checkpoint.restore(step, program=main_program, scope=scope)
    _onto_device(executor, main_program, scope)
    if _monitor.TRACER.enabled:
        _monitor.TRACER.instant("preemption.resume", "resilience",
                                {"step": int(step)})
    return int(step)


def _onto_device(executor, program, scope) -> None:
    """Move the restored persistables to the executor's device now (the
    first run would, value by value), so that a checkpoint daemon started
    next finds the state where training keeps it."""
    import torch
    from .framework.core import default_main_program
    from .framework.scope import global_scope
    from .io import get_program_persistable_vars
    device = getattr(executor, "device", None)
    if device is None:
        return
    scope = scope or global_scope()
    for v in get_program_persistable_vars(program
                                          or default_main_program()):
        val = scope.find_var(v.name)
        if isinstance(val, torch.Tensor) and val.device != device:
            scope.set_var(v.name, val.to(device))


def _sync_from_flags():
    try:
        from .flags import get_flags
        fl = get_flags(["FLAGS_fault_inject", "FLAGS_watchdog_timeout_s",
                        "FLAGS_watchdog_escalate"])
    except Exception:           # flags mid-bootstrap: side effects re-sync
        return
    if fl["FLAGS_fault_inject"]:
        configure(str(fl["FLAGS_fault_inject"]))
    WATCHDOG.set_timeout(float(fl["FLAGS_watchdog_timeout_s"]))
    WATCHDOG.escalate = str(fl["FLAGS_watchdog_escalate"])


_sync_from_flags()
