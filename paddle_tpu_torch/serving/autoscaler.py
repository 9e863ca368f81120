"""The fleet autoscaler: the control loop over a serving fleet (the port of
``paddle_tpu/serving/autoscaler.py``).

Hosted beside a :class:`~paddle_tpu_torch.serving.fleet.FleetRouter`, the
controller reads the replicas' load reports (``srv_q``, and ``hbm`` /
``hdrm`` for memory headroom) and the router's fleet-wide SLO burn rate,
and every ``FLAGS_fleet_scale_eval_interval_s`` drives three actuators:

**Spawn and retire.**  Sustained queue pressure with both burn windows
breached raises the target (up to ``FLAGS_fleet_max_replicas``) and spawns
a replica; sustained idle lowers it (down to ``FLAGS_fleet_min_replicas``)
and retires one, always through the replica's drain (SIGTERM, the replica
finishes its work, exits), never a kill.  A replica the router declares
dead is replaced.  Hysteresis (``FLAGS_fleet_scale_{up,down}_ticks``) and a
cooldown (``FLAGS_fleet_scale_cooldown_s``) keep it from flapping; each
decision is one count in ``paddle_tpu_fleet_scale_total{dir,reason}`` (a
spawn retried after a failure is not counted again) and one trace instant.

**Shed or scale.**  With ``FLAGS_serving_slo_shed`` on, admission shedding
engages after ``FLAGS_fleet_shed_after_ticks`` breached ticks, and only
while a spawn is in flight (or backing off) or the fleet is at its maximum;
it releases when the breach clears.

**Degradation ladder.**  A replica reporting headroom under
``FLAGS_fleet_oom_headroom_frac`` first gets a ``control`` op that halves
its bucket widths; still at risk ``FLAGS_fleet_shrink_grace_ticks`` ticks
later, it is drained and respawned.

A fault in the decide path (the ``autoscaler.decide`` site) skips that
tick whole; a failed spawn backs off ``FLAGS_fleet_spawn_backoff_s``;
nothing propagates out of the loop thread.  ``attach_to(obj)`` puts the
controller's status into ``obj.attach_status_section``: the gang
coordinator offers that, and it is not ported yet (ROADMAP Queue 1 item
3), so no object of this package has one.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .. import monitor as _monitor
from .. import resilience as _resil

__all__ = ["AutoscalerPolicy", "Decision", "FleetAutoscaler"]

log = logging.getLogger("paddle_tpu")

#: replica states that count toward the fleet's live size (draining and
#: dead replicas are already out of placement)
_LIVE_STATES = ("up", "stale")


def _instant(name: str, args: Dict[str, Any]) -> None:
    if _monitor.TRACER.enabled:
        _monitor.TRACER.instant(name, "autoscaler", args)


class Decision:
    """One tick's verdict from :class:`AutoscalerPolicy` — pure data the
    :class:`FleetAutoscaler` actuates."""

    __slots__ = ("spawn", "spawn_reason", "retire", "shed", "shrink",
                 "respawn", "count")

    def __init__(self, spawn: bool = False, spawn_reason: str = "",
                 retire: Optional[str] = None,
                 shed: Optional[bool] = None,
                 shrink: Optional[List[str]] = None,
                 respawn: Optional[List[str]] = None,
                 count: Optional[List[tuple]] = None):
        self.spawn = bool(spawn)          # initiate one replica spawn
        self.spawn_reason = spawn_reason  # trace label for the spawn
        self.retire = retire              # addr to drain-and-retire
        self.shed = shed                  # new shed state (None = keep)
        self.shrink = list(shrink or ())  # addrs to send shrink_width
        self.respawn = list(respawn or ())  # addrs to drain + respawn
        #: (dir, reason) pairs to count in fleet_scale_total — exactly
        #: the decisions made THIS tick, never retries of older ones
        self.count = list(count or ())

    def __repr__(self):
        return (f"Decision(spawn={self.spawn}/{self.spawn_reason!r}, "
                f"retire={self.retire!r}, shed={self.shed}, "
                f"shrink={self.shrink}, respawn={self.respawn}, "
                f"count={self.count})")


class AutoscalerPolicy:
    """The decision table, isolated from threads/sockets/clocks so the
    unit tests drive it tick by tick with synthetic signals.

    ``decide(sig)`` consumes one signal snapshot::

        {"replicas": {addr: {"state": str, "srv_q": float,
                             "hdrm_frac": float|None, "fresh": bool}},
         "breached": bool,          # fleet SLO burn, both windows
         "qps": float,              # fleet completion rate (req/s)
         "spawn_inflight": bool,    # spawn worker alive OR backing off
         "retire_inflight": bool}

    and returns a :class:`Decision`.  NOT thread-safe by itself: the
    FleetAutoscaler serializes ``decide()`` and ``status`` reads under
    its own lock.
    """

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 queue_high: float = 4.0, idle_qps: float = 0.5,
                 up_ticks: int = 2, down_ticks: int = 5,
                 cooldown_ticks: int = 15, shed_after_ticks: int = 2,
                 oom_frac: float = 0.10, shrink_grace_ticks: int = 3,
                 shed_enabled: bool = False,
                 initial_target: Optional[int] = None):
        self.min = max(1, int(min_replicas))
        self.max = max(self.min, int(max_replicas))
        self.queue_high = float(queue_high)
        self.idle_qps = float(idle_qps)
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.shed_after_ticks = max(1, int(shed_after_ticks))
        self.oom_frac = float(oom_frac)
        self.shrink_grace_ticks = max(1, int(shrink_grace_ticks))
        self.shed_enabled = bool(shed_enabled)
        tgt = self.min if initial_target is None else int(initial_target)
        self.target = min(self.max, max(self.min, tgt))
        self.shed_on = False
        self.last: Dict[str, Any] = {"action": "none", "reason": ""}
        self._up = 0                  # consecutive scale-up-worthy ticks
        self._down = 0                # consecutive idle ticks
        self._breach_ticks = 0        # consecutive breached ticks
        self._cooldown = 0            # ticks of scale freeze remaining
        self._shrunk: set = set()     # replicas already sent a shrink
        self._risk: Dict[str, int] = {}   # post-shrink at-risk ticks
        self._dead_seen: set = set()  # dead replicas already counted
        self._surplus_counted = False  # current surplus episode counted

    @property
    def cooldown(self) -> int:
        return self._cooldown

    @classmethod
    def from_flags(cls, initial_target: Optional[int] = None,
                   interval_s: Optional[float] = None
                   ) -> "AutoscalerPolicy":
        from ..flags import get_flags
        fl = get_flags([
            "FLAGS_fleet_min_replicas", "FLAGS_fleet_max_replicas",
            "FLAGS_fleet_scale_eval_interval_s",
            "FLAGS_fleet_scale_up_ticks", "FLAGS_fleet_scale_down_ticks",
            "FLAGS_fleet_scale_cooldown_s", "FLAGS_fleet_queue_high",
            "FLAGS_fleet_idle_qps", "FLAGS_fleet_shed_after_ticks",
            "FLAGS_fleet_oom_headroom_frac",
            "FLAGS_fleet_shrink_grace_ticks", "FLAGS_serving_slo_shed"])
        dt = float(interval_s if interval_s is not None
                   else fl["FLAGS_fleet_scale_eval_interval_s"])
        # the cooldown flag is seconds; the policy thinks in ticks
        cooldown_ticks = int(round(
            float(fl["FLAGS_fleet_scale_cooldown_s"]) / max(dt, 1e-9)))
        return cls(
            min_replicas=int(fl["FLAGS_fleet_min_replicas"]),
            max_replicas=int(fl["FLAGS_fleet_max_replicas"]),
            queue_high=float(fl["FLAGS_fleet_queue_high"]),
            idle_qps=float(fl["FLAGS_fleet_idle_qps"]),
            up_ticks=int(fl["FLAGS_fleet_scale_up_ticks"]),
            down_ticks=int(fl["FLAGS_fleet_scale_down_ticks"]),
            cooldown_ticks=cooldown_ticks,
            shed_after_ticks=int(fl["FLAGS_fleet_shed_after_ticks"]),
            oom_frac=float(fl["FLAGS_fleet_oom_headroom_frac"]),
            shrink_grace_ticks=int(fl["FLAGS_fleet_shrink_grace_ticks"]),
            shed_enabled=bool(fl["FLAGS_serving_slo_shed"]),
            initial_target=initial_target)

    # -- the decision table --------------------------------------------------
    def decide(self, sig: Dict[str, Any]) -> Decision:
        reps: Dict[str, dict] = sig.get("replicas") or {}
        live = [a for a, r in reps.items()
                if r.get("state") in _LIVE_STATES]
        nlive = len(live)
        count: List[tuple] = []

        # forget ladder/death state for replicas no longer in the table
        known = set(reps)
        self._shrunk &= known
        for a in list(self._risk):
            if a not in known:
                del self._risk[a]
        self._dead_seen &= known

        if self._cooldown > 0:
            self._cooldown -= 1

        # 1) degradation ladder — per-replica, LOCAL action first
        shrink: List[str] = []
        respawn: List[str] = []
        for a in live:
            frac = reps[a].get("hdrm_frac")
            at_risk = frac is not None and frac < self.oom_frac
            if not at_risk:
                self._risk.pop(a, None)
                continue
            if a not in self._shrunk:
                self._shrunk.add(a)
                self._risk[a] = 0
                shrink.append(a)
            else:
                n = self._risk.get(a, 0) + 1
                self._risk[a] = n
                if n >= self.shrink_grace_ticks:
                    # the shrink did not clear the risk: last rung —
                    # drain this replica and respawn it fresh
                    respawn.append(a)
                    self._shrunk.discard(a)
                    self._risk.pop(a, None)
                    count.append(("up", "oom"))

        qs = [float(reps[a].get("srv_q", 0.0)) for a in live]
        mean_q = (sum(qs) / len(qs)) if qs else 0.0
        breached = bool(sig.get("breached"))

        # 2) scale-up hysteresis: burn + queue pressure, sustained
        if breached and mean_q >= self.queue_high:
            self._up += 1
        else:
            self._up = 0
        bumped = False
        if self._up >= self.up_ticks and self._cooldown == 0 \
                and self.target < self.max:
            self.target += 1
            self._cooldown = self.cooldown_ticks
            self._up = 0
            bumped = True
            count.append(("up", "burn_queue"))

        # 3) scale-down hysteresis: no breach, empty queues, idle rate
        per_rep_qps = float(sig.get("qps", 0.0)) / max(nlive, 1)
        idle = (not breached) and mean_q <= 1e-9 \
            and per_rep_qps < self.idle_qps
        if idle:
            self._down += 1
        else:
            self._down = 0
        lowered = False
        if self._down >= self.down_ticks and self._cooldown == 0 \
                and self.target > self.min:
            self.target -= 1
            self._cooldown = self.cooldown_ticks
            self._down = 0
            lowered = True
            count.append(("down", "idle"))

        # 4) death repair: every NEWLY dead replica is one counted
        # decision; the reconcile below spawns the replacement.  The
        # dead entry stays in the router table (the prober keeps
        # knocking — a replica that was merely partitioned rejoins, and
        # the resulting surplus retires gracefully below).
        for a, r in reps.items():
            if r.get("state") == "dead" and a not in self._dead_seen:
                self._dead_seen.add(a)
                if nlive < self.target:
                    count.append(("up", "death"))
            elif r.get("state") in _LIVE_STATES:
                self._dead_seen.discard(a)

        # 5) reconcile live size against the target
        spawn, spawn_reason = False, ""
        retire: Optional[str] = None
        if nlive <= self.target:
            self._surplus_counted = False
        if nlive < self.target and not sig.get("spawn_inflight") \
                and not respawn:
            spawn = True
            spawn_reason = "burn_queue" if bumped else \
                ("death" if self._dead_seen else "repair")
        elif nlive > self.target and not sig.get("retire_inflight") \
                and not respawn:
            # retire the least-loaded fresh replica (prefer fresh: its
            # in-flight picture is trustworthy).  A surplus without a
            # target change (a revived dead replica) counts once per
            # episode — the decision, not each tick the drain takes
            pool = sorted(
                live, key=lambda a: (not reps[a].get("fresh"),
                                     float(reps[a].get("srv_q", 0.0))))
            if pool:
                retire = pool[0]
                if not lowered and not self._surplus_counted:
                    count.append(("down", "surplus"))
                self._surplus_counted = True

        # 6) shed-vs-scale arbitration
        if breached:
            self._breach_ticks += 1
        else:
            self._breach_ticks = 0
        at_max = self.target >= self.max
        want_shed = (self.shed_enabled and breached
                     and self._breach_ticks >= self.shed_after_ticks
                     and (bool(sig.get("spawn_inflight")) or spawn
                          or at_max))
        shed = None if want_shed == self.shed_on else want_shed
        self.shed_on = want_shed

        if bumped:
            self.last = {"action": "scale_up", "reason": "burn_queue"}
        elif lowered:
            self.last = {"action": "scale_down", "reason": "idle"}
        elif respawn:
            self.last = {"action": "respawn", "reason": "oom"}
        elif spawn:
            self.last = {"action": "spawn", "reason": spawn_reason}
        elif retire:
            self.last = {"action": "retire", "reason": "surplus"}
        elif shrink:
            self.last = {"action": "shrink", "reason": "oom_headroom"}
        return Decision(spawn=spawn, spawn_reason=spawn_reason,
                        retire=retire, shed=shed, shrink=shrink,
                        respawn=respawn, count=count)


class FleetAutoscaler:
    """The loop host: reads signals off a
    :class:`~paddle_tpu_torch.serving.fleet.FleetRouter`, runs the
    :class:`AutoscalerPolicy`, and actuates through two injected
    callables so the same controller drives subprocess replicas
    (``paddle_tpu_torch/tools/fleet_smoke.py``) or test stubs:

    * ``spawn_fn() -> addr`` — start one replica, block until it is
      ready, return its ``host:port`` (runs on a worker thread — the
      control loop keeps ticking, which is what lets shedding engage
      while the spawn warms up);
    * ``retire_fn(addr)`` — drain-then-stop the replica at ``addr``
      (SIGTERM + wait; NEVER a kill), block until it exited.

    ``tick()`` is public and takes an optional ``now`` so tests drive
    the loop deterministically without the thread.
    """

    def __init__(self, router, spawn_fn: Callable[[], str],
                 retire_fn: Callable[[str], Any],
                 policy: Optional[AutoscalerPolicy] = None,
                 interval_s: Optional[float] = None,
                 clock=time.monotonic):
        from ..flags import get_flags
        fl = get_flags(["FLAGS_fleet_scale_eval_interval_s",
                        "FLAGS_fleet_spawn_backoff_s"])
        self.router = router
        self._spawn_fn = spawn_fn
        self._retire_fn = retire_fn
        self.interval_s = float(
            interval_s if interval_s is not None
            else fl["FLAGS_fleet_scale_eval_interval_s"])
        self._backoff_s = float(fl["FLAGS_fleet_spawn_backoff_s"])
        self._clock = clock
        live0 = sum(1 for r in router.replica_view().values()
                    if r.get("state") in _LIVE_STATES)
        self.policy = policy or AutoscalerPolicy.from_flags(
            initial_target=max(live0, 1), interval_s=self.interval_s)
        self._mu = threading.Lock()
        # policy state is mutated only through decide()/status() calls
        # made under _mu — the policy object itself stays lock-free
        self._spawn_thread: Optional[threading.Thread] = None  # guarded-by: _mu
        self._retire_thread: Optional[threading.Thread] = None  # guarded-by: _mu
        self._backoff_until = 0.0     # guarded-by: _mu
        self._spawn_failures = 0      # guarded-by: _mu
        self._last_size = live0       # guarded-by: _mu
        self._ticks = 0               # guarded-by: _mu
        self._qps_mark: Optional[tuple] = None  # guarded-by: _mu
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetAutoscaler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="pt-autoscaler")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        with self._mu:
            workers = [self._spawn_thread, self._retire_thread]
        for t in workers:
            if t is not None:
                t.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:
                # the controller must outlive any single bad tick —
                # a dead autoscaler is a silently static fleet
                log.warning("autoscaler tick failed: %r", e)
                _instant("autoscaler.tick_error", {"error": repr(e)[:200]})

    # -- one control tick ----------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Run one decide→actuate cycle; returns the status snapshot.
        An injected ``autoscaler.decide`` fault skips the tick whole —
        half a decision must never actuate."""
        now = self._clock() if now is None else now
        try:
            _resil.maybe_inject("autoscaler.decide")
        except _resil.InjectedFault as e:
            _instant("autoscaler.tick_skipped", {"error": repr(e)[:200]})
            return self.status()

        breached = False
        if getattr(self.router, "slo", None) is not None:
            try:
                st = self.router.slo.evaluate()
                breached = any(v.get("breached") for v in st.values())
            except Exception as e:   # the SLO plane must not kill ticks
                _instant("autoscaler.slo_error", {"error": repr(e)[:200]})

        view = self.router.replica_view()
        snap = self.router.snapshot()
        reps: Dict[str, dict] = {}
        for a, r in view.items():
            load = r.get("load") or {}
            hdrm_frac = None
            hbm, hd = load.get("hbm"), load.get("hdrm")
            if hbm is not None and hd is not None and (hbm + hd) > 0:
                hdrm_frac = float(hd) / (float(hbm) + float(hd))
            reps[a] = {"state": r.get("state"),
                       "fresh": bool(r.get("fresh")),
                       "srv_q": float(load.get("srv_q", 0.0)),
                       "hdrm_frac": hdrm_frac}
        completed = int(snap.get("completed", 0))
        with self._mu:
            spawning = (self._spawn_thread is not None
                        and self._spawn_thread.is_alive())
            retiring = (self._retire_thread is not None
                        and self._retire_thread.is_alive())
            # a failed spawn's backoff window COUNTS as in-flight: it
            # gates the retry and keeps shedding engaged (the re-shed
            # contract for injected spawn failures)
            spawn_inflight = spawning or now < self._backoff_until
            mark, self._qps_mark = self._qps_mark, (now, completed)
        qps = 0.0
        if mark is not None and now > mark[0]:
            qps = max(0.0, (completed - mark[1]) / (now - mark[0]))

        sig = {"replicas": reps, "breached": breached, "qps": qps,
               "spawn_inflight": spawn_inflight,
               "retire_inflight": retiring}
        nlive = sum(1 for r in reps.values()
                    if r.get("state") in _LIVE_STATES)
        with self._mu:
            decision = self.policy.decide(sig)
            self._last_size = nlive
            self._ticks += 1
            target, shed_on = self.policy.target, self.policy.shed_on

        for dir_, reason in decision.count:
            _monitor.FLEET_SCALE_CTR.inc(1, dir=dir_, reason=reason)
            _instant("autoscaler.scale",
                     {"dir": dir_, "reason": reason, "target": target,
                      "size": nlive})
        if decision.shed is not None:
            self.router.set_shedding(decision.shed)
            _instant("autoscaler.shed",
                     {"on": decision.shed, "target": target,
                      "size": nlive})
        for addr in decision.shrink:
            self._shrink_replica(addr)
        for addr in decision.respawn:
            self._start_retire(addr, respawn=True)
        if decision.retire is not None and not decision.respawn:
            self._start_retire(decision.retire, respawn=False)
        if decision.spawn and not decision.respawn:
            self._start_spawn(decision.spawn_reason)

        _monitor.FLEET_TARGET_GAUGE.set(float(target))
        _monitor.FLEET_SIZE_GAUGE.set(float(nlive))
        _monitor.FLEET_SHED_GAUGE.set(1.0 if shed_on else 0.0)
        return self.status()

    # -- actuators -----------------------------------------------------------
    def _shrink_replica(self, addr: str) -> None:
        """Ladder rung 1: the per-replica bucket-width shrink control
        op.  An ``unsupported`` reply (no bucket plan to shrink) is
        fine: the policy's post-shrink grace counter keeps running, so
        a still-at-risk replica escalates to drain-and-respawn."""
        try:
            resp = self.router.control(addr, "shrink_width")
        except Exception as e:
            _instant("autoscaler.shrink_failed",
                     {"replica": addr, "error": repr(e)[:200]})
            return
        if resp.get("ok"):
            _monitor.FLEET_SHRINK_CTR.inc(1)
            _instant("autoscaler.shrink",
                     {"replica": addr, "widths": resp.get("widths")})
        else:
            _instant("autoscaler.shrink_refused",
                     {"replica": addr, "error": resp.get("error")})

    def _start_spawn(self, reason: str) -> None:
        with self._mu:
            if self._spawn_thread is not None \
                    and self._spawn_thread.is_alive():
                return
            t = threading.Thread(target=self._spawn_body, args=(reason,),
                                 daemon=True, name="pt-autoscaler-spawn")
            self._spawn_thread = t
        t.start()

    def _spawn_body(self, reason: str) -> None:
        try:
            _resil.maybe_inject("autoscaler.spawn")
            addr = self._spawn_fn()
            self.router.add_replica(str(addr))
            _instant("autoscaler.spawned",
                     {"replica": str(addr), "reason": reason})
        except Exception as e:
            # back off — the next ticks see spawn_inflight (backoff
            # window) so shedding stays engaged while the breach lasts,
            # and the retry waits out the backoff.  The controller loop
            # itself never sees this exception.
            with self._mu:
                self._spawn_failures += 1
                self._backoff_until = self._clock() + self._backoff_s
            _instant("autoscaler.spawn_failed",
                     {"reason": reason, "error": repr(e)[:200],
                      "backoff_s": self._backoff_s})

    def _start_retire(self, addr: str, respawn: bool) -> None:
        with self._mu:
            if self._retire_thread is not None \
                    and self._retire_thread.is_alive():
                return
            t = threading.Thread(target=self._retire_body,
                                 args=(addr, respawn), daemon=True,
                                 name="pt-autoscaler-retire")
            self._retire_thread = t
        # hold the replica out of placement NOW — the drain refusals
        # would get there too, but only after a client bounced off it
        self.router._mark_draining(addr)
        t.start()

    def _retire_body(self, addr: str, respawn: bool) -> None:
        try:
            _resil.maybe_inject("autoscaler.retire")
        except _resil.InjectedFault as e:
            # the replica was never SIGTERM'd: its next reply reports
            # draining=False and the router restores it to "up" —
            # the aborted retire self-heals
            _instant("autoscaler.retire_skipped",
                     {"replica": addr, "error": repr(e)[:200]})
            return
        try:
            self._retire_fn(addr)
            self.router.remove_replica(addr)
            _instant("autoscaler.retired",
                     {"replica": addr, "respawn": respawn})
        except Exception as e:
            _instant("autoscaler.retire_failed",
                     {"replica": addr, "error": repr(e)[:200]})
            return
        if respawn:
            # ladder's last rung, second half: replace the drained
            # replica with a fresh one (fresh process = fresh card memory)
            self._spawn_body("oom")

    # -- status --------------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """The controller's operational snapshot: target, bounds, live
        size, shed state, cooldown, spawn state and the last decision."""
        with self._mu:
            pol = self.policy
            spawning = (self._spawn_thread is not None
                        and self._spawn_thread.is_alive())
            return {"target": pol.target, "min": pol.min,
                    "max": pol.max, "size": self._last_size,
                    "shedding": pol.shed_on,
                    "cooldown_ticks": pol.cooldown,
                    "spawn_inflight": spawning,
                    "spawn_failures": self._spawn_failures,
                    "ticks": self._ticks, "last": dict(pol.last)}

    def attach_to(self, obj) -> None:
        """Publish :meth:`status` as the ``autoscaler`` section of any
        object with an ``attach_status_section(name, fn)`` method (the
        gang coordinator's status plane, once it is ported)."""
        obj.attach_status_section("autoscaler", self.status)
