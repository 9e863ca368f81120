"""Per-tenant SLO objectives and multi-window burn-rate evaluation (the
port of ``paddle_tpu/serving/slo.py``, which imports nothing of JAX; the
port keeps its own copy).

``FLAGS_serving_slo`` declares objectives per tenant, e.g.::

    tenantA:p99_ms=250,avail=99.9;tenantB:avail=99;*:p99_ms=500

- ``p99_ms`` — latency objective: a completed request slower than this
  is a BAD event (the "99" is the objective percentile: with no explicit
  ``avail``, the good-fraction objective defaults to 99.0%).
- ``avail`` — good-fraction objective in percent; a failed request is
  always bad.  The error budget is ``1 - avail/100``.
- ``*`` — default target for any tenant without an explicit entry.

Burn rate is the SRE multi-window form: over each of a FAST and a SLOW
trailing window, ``burn = bad_fraction / budget`` — 1.0 consumes the
budget exactly at the allowed rate.  A tenant is IN BREACH when the burn
exceeds ``FLAGS_serving_slo_burn_threshold`` on BOTH windows (the slow
window keeps a blip from paging; the fast window keeps a real fire from
waiting), and RECOVERS with hysteresis when the fast-window burn falls
under half the threshold.  Breach and recovery are recorded as trace
instants (``slo.breach`` / ``slo.recover``) and the live state feeds the
``paddle_tpu_slo_burn_rate{tenant,window}`` / ``paddle_tpu_slo_breached``
gauges plus the optional shed-on-burn admission mode
(``FLAGS_serving_slo_shed``).

Zero-traffic tenants burn nothing: an empty window is burn 0, never a
breach (an idle tenant's SLO is trivially met).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import monitor as _monitor

__all__ = ["SLOTarget", "parse_slo", "BurnRateEvaluator"]

#: events kept per tenant at most — a bound against a window so long or
#: traffic so hot that the ring outgrows memory (oldest dropped; the
#: burn math then sees a shorter effective window, never a crash)
MAX_EVENTS_PER_TENANT = 100_000


class SLOTarget:
    """One tenant's objectives (latency and/or availability)."""

    __slots__ = ("p99_ms", "avail")

    def __init__(self, p99_ms: Optional[float] = None,
                 avail: Optional[float] = None):
        self.p99_ms = None if p99_ms is None else float(p99_ms)
        # the good-fraction objective: explicit avail, else the "99" of
        # p99 — a pure latency target budgets 1% of requests over it
        self.avail = float(avail) if avail is not None else 99.0

    @property
    def budget(self) -> float:
        """Allowed bad-event fraction (floored: avail=100 would make
        any single bad event an infinite burn — clamp keeps it finite
        and still enormous)."""
        return max(1.0 - self.avail / 100.0, 1e-9)

    def is_bad(self, ok: bool, latency_ms: float) -> bool:
        if not ok:
            return True
        return self.p99_ms is not None and latency_ms > self.p99_ms

    def as_dict(self) -> Dict[str, Any]:
        return {"p99_ms": self.p99_ms, "avail": self.avail}


def parse_slo(spec: str) -> Dict[str, SLOTarget]:
    """``FLAGS_serving_slo`` grammar (see module docstring); raises
    ``ValueError`` on unknown keys / malformed numbers."""
    targets: Dict[str, SLOTarget] = {}
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        tenant, sep, body = entry.partition(":")
        tenant = tenant.strip()
        if not sep or not tenant:
            raise ValueError(
                f"bad SLO entry {entry!r}: expected 'tenant:key=val[,...]'")
        kv: Dict[str, float] = {}
        for tok in body.split(","):
            tok = tok.strip()
            if not tok:
                continue
            k, sep2, v = tok.partition("=")
            k = k.strip()
            if not sep2 or k not in ("p99_ms", "avail"):
                raise ValueError(
                    f"bad SLO entry {entry!r}: unknown key {k!r} "
                    "(expected p99_ms= and/or avail=)")
            try:
                kv[k] = float(v)
            except ValueError:
                raise ValueError(
                    f"bad SLO entry {entry!r}: {k}={v!r} is not a number")
        if not kv:
            raise ValueError(f"bad SLO entry {entry!r}: no objectives")
        if "avail" in kv and not (0.0 < kv["avail"] <= 100.0):
            raise ValueError(
                f"bad SLO entry {entry!r}: avail must be in (0, 100]")
        if "p99_ms" in kv and kv["p99_ms"] <= 0:
            raise ValueError(
                f"bad SLO entry {entry!r}: p99_ms must be > 0")
        targets[tenant] = SLOTarget(kv.get("p99_ms"), kv.get("avail"))
    return targets


class BurnRateEvaluator:
    """Per-tenant burn-rate state machine over a bounded event ring.

    ``record()`` is the serving hot-path hook (one lock + append);
    ``evaluate()`` recomputes both windows' burn rates, publishes the
    gauges, and advances the breach/recovery state machine.  The server
    runs ``evaluate`` on a small daemon thread; tests drive it directly
    with an injected clock.
    """

    def __init__(self, targets: Dict[str, SLOTarget],
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 600.0,
                 threshold: float = 10.0,
                 hysteresis: float = 0.5,
                 clock=time.monotonic):
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError(
                "SLO windows must satisfy 0 < fast <= slow "
                f"(got fast={fast_window_s}, slow={slow_window_s})")
        self.targets = dict(targets)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.threshold = float(threshold)
        self.hysteresis = float(hysteresis)
        self._clock = clock
        self._mu = threading.Lock()
        #: tenant -> deque[(t, bad)] trailing events  # guarded-by: _mu
        self._events: Dict[str, collections.deque] = {}
        self._breached: Dict[str, bool] = {}  # guarded-by: _mu
        self._last_burn: Dict[str, Tuple[float, float]] = {}  # guarded-by: _mu
        #: evicted tenants with an EXPLICIT spec entry: the declared-
        #: tenant loop must not re-mint their retired gauge series; new
        #: traffic (a re-admission) resumes reporting  # guarded-by: _mu
        self._forgotten: set = set()

    def _target(self, tenant: str) -> Optional[SLOTarget]:
        return self.targets.get(str(tenant), self.targets.get("*"))

    @staticmethod
    def _fold_tenant_gauges(tenant: str) -> None:
        """Drop every SLO gauge series of a tenant that stopped being
        tracked — the single place a new per-tenant SLO series must be
        added so eviction and idle-drop can't diverge."""
        for window in ("fast", "slow"):
            _monitor.SLO_BURN_GAUGE.fold(
                {"tenant": tenant, "window": window}, None)
        _monitor.SLO_BREACHED_GAUGE.fold({"tenant": tenant}, None)

    # -- hot path ------------------------------------------------------------
    def record(self, tenant: str, ok: bool, latency_ms: float = 0.0,
               now: Optional[float] = None) -> None:
        """One served-request outcome.  Tenants with no target (and no
        ``*`` default) are not tracked — recording them is free."""
        target = self._target(tenant)
        if target is None:
            return
        now = self._clock() if now is None else now
        bad = target.is_bad(ok, latency_ms)
        with self._mu:
            self._forgotten.discard(str(tenant))
            ring = self._events.get(str(tenant))
            if ring is None:
                ring = self._events[str(tenant)] = collections.deque(
                    maxlen=MAX_EVENTS_PER_TENANT)
            ring.append((now, 1 if bad else 0))

    def forget(self, tenant: str) -> None:
        """Stop tracking an evicted tenant.  The eviction path retires
        the tenant's registry series (``monitor.retire_tenant_series``);
        without this, the next ``evaluate()`` tick would re-mint the
        just-dropped SLO gauge series and the event/breach maps would
        grow without bound under tenant churn."""
        with self._mu:
            self._events.pop(str(tenant), None)
            self._breached.pop(str(tenant), None)
            self._last_burn.pop(str(tenant), None)
            if str(tenant) in self.targets:
                self._forgotten.add(str(tenant))
            # fold the gauge series HERE, under the same lock the
            # evaluator publishes under: an evaluate() tick that raced
            # the eviction (computed its publish set before retire_
            # tenant_series dropped the series) re-mints them — this
            # fold, serialized after that publish, takes them down again
            self._fold_tenant_gauges(str(tenant))

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Recompute burn rates for every tracked tenant, publish the
        gauges, fire breach/recovery transitions; returns the per-tenant
        state (what ``/statusz`` and the smoke read)."""
        now = self._clock() if now is None else now
        fast_cut = now - self.fast_window_s
        slow_cut = now - self.slow_window_s
        out: Dict[str, dict] = {}
        transitions: List[Tuple[str, str, float, float]] = []
        dropped: List[str] = []
        # one pass under the lock: prune, count both windows in a single
        # reversed scan (no ring snapshots — a near-full 100k ring would
        # otherwise stall the completion hot path's record() every tick),
        # and decide+commit transitions against the LIVE _breached state
        # (two concurrent evaluate() calls must fire ONE breach event)
        with self._mu:
            burns: Dict[str, Tuple[float, float]] = {}
            for tenant in list(self._events):
                ring = self._events[tenant]
                while ring and now - ring[0][0] > self.slow_window_s:
                    ring.popleft()
                if not ring and tenant not in self.targets \
                        and not self._breached.get(tenant, False):
                    # wildcard-matched tenant fully idle past the slow
                    # window: stop tracking it and drop its gauge series
                    # (bounds the evaluator AND the registry under tenant
                    # churn; a breached tenant first recovers — the
                    # recover instant must fire — then drops next tick)
                    del self._events[tenant]
                    self._breached.pop(tenant, None)
                    self._last_burn.pop(tenant, None)
                    dropped.append(tenant)
                    continue
                target = self._target(tenant)
                if target is None:
                    continue
                ft = fb = st = sb = 0
                for t, b in reversed(ring):
                    if t <= slow_cut:
                        break       # ring is time-ordered: done
                    st += 1
                    sb += b
                    if t > fast_cut:
                        ft += 1
                        fb += b
                burns[tenant] = ((fb / ft) / target.budget if ft else 0.0,
                                 (sb / st) / target.budget if st else 0.0)
            # declared tenants with no traffic yet still report (burn 0)
            # — except evicted ones, whose retired series must stay down
            for t in self.targets:
                if t != "*" and t not in burns and t not in self._forgotten:
                    burns[t] = (0.0, 0.0)
            for tenant, (fast, slow) in burns.items():
                breached = self._breached.get(tenant, False)
                if not breached and fast >= self.threshold \
                        and slow >= self.threshold:
                    breached = True
                    transitions.append((tenant, "breach", fast, slow))
                elif breached and fast <= self.threshold * self.hysteresis:
                    breached = False
                    transitions.append((tenant, "recover", fast, slow))
                self._breached[tenant] = breached
                self._last_burn[tenant] = (fast, slow)
                out[tenant] = {"burn_fast": fast, "burn_slow": slow,
                               "breached": breached,
                               "target": self._target(tenant).as_dict()}
            # publish while STILL holding _mu: forget() folds the
            # tenant's gauge series under this same lock, so an evict
            # racing this tick either lands before the publish (tenant
            # already absent from out) or after it (its fold takes the
            # just-published series down) — never a resurrected series
            for tenant in dropped:
                self._fold_tenant_gauges(tenant)
            for tenant, state in out.items():
                _monitor.SLO_BURN_GAUGE.set(round(state["burn_fast"], 4),
                                            tenant=tenant, window="fast")
                _monitor.SLO_BURN_GAUGE.set(round(state["burn_slow"], 4),
                                            tenant=tenant, window="slow")
                _monitor.SLO_BREACHED_GAUGE.set(
                    1 if state["breached"] else 0, tenant=tenant)
            for tenant, kind, fast, slow in transitions:
                if kind == "breach":
                    _monitor.SLO_BREACH_CTR.inc(1, tenant=tenant)
                if _monitor.TRACER.enabled:
                    _monitor.TRACER.instant(
                        f"slo.{kind}", "slo",
                        {"tenant": tenant, "burn_fast": round(fast, 3),
                         "burn_slow": round(slow, 3),
                         "threshold": self.threshold})
        return out

    def in_breach(self, tenant: str) -> bool:
        with self._mu:
            return self._breached.get(str(tenant), False)

    def state(self) -> Dict[str, dict]:
        """Last evaluated view for ``/statusz`` (no recompute: the
        evaluator thread owns the cadence)."""
        with self._mu:
            return {t: {"burn_fast": fs[0], "burn_slow": fs[1],
                        "breached": self._breached.get(t, False),
                        "target": (self._target(t).as_dict()
                                   if self._target(t) else None)}
                    for t, fs in self._last_burn.items()}

    @classmethod
    def from_flags(cls) -> Optional["BurnRateEvaluator"]:
        """Build from ``FLAGS_serving_slo*``; None when no objectives
        are declared (the serving SLO plane is then fully off)."""
        from ..flags import get_flags
        fl = get_flags(["FLAGS_serving_slo",
                        "FLAGS_serving_slo_fast_window_s",
                        "FLAGS_serving_slo_slow_window_s",
                        "FLAGS_serving_slo_burn_threshold"])
        targets = parse_slo(str(fl["FLAGS_serving_slo"]))
        if not targets:
            return None
        return cls(targets,
                   fast_window_s=float(
                       fl["FLAGS_serving_slo_fast_window_s"]),
                   slow_window_s=float(
                       fl["FLAGS_serving_slo_slow_window_s"]),
                   threshold=float(
                       fl["FLAGS_serving_slo_burn_threshold"]))
