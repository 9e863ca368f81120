"""The port's fleet autoscaler against the JAX package's, on the CPU.

- The reference's coordinator-free autoscaler tests
  (``tests/test_autoscaler.py``), run on the port: the decision table
  (scale-up on sustained burn and queue, no scale-up on either alone,
  cooldown, max and min clamps, idle retire of the least-loaded fresh
  replica, death repair counted once, a surplus retired once an episode,
  shed only while a spawn is in flight or at max and only with the flag,
  the headroom ladder shrinking locally first and resetting on recovery),
  ``shrink_widths`` on a bucket plan, the fleet flags' validation,
  ``from_flags``' seconds to ticks, the fault sites, and the loop host over
  a stub router (spawn failure backs off and retries without a recount,
  injected decide / spawn / retire faults, shed and the ladder actuated
  through the router, a raising tick survived).  Left out, as they need the
  gang coordinator or the launcher (ROADMAP Queue 1 item 3): the status
  section on a coordinator, gangtop's footer and the two standby-placement
  tests; the slow subprocess drill is ``test_torch_fleet.py``'s.
- Parity: 20 seeds x 200 ticks of random signals through both
  ``AutoscalerPolicy.decide``s, every ``Decision`` field, the target, the
  shed state, the cooldown and ``policy.last`` equal tick by tick; and
  ``from_flags`` over the same flag values gives the same policy.
"""

import time

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.serving.autoscaler import AutoscalerPolicy as RefPolicy
from paddle_tpu_torch import monitor, resilience
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.serving.autoscaler import (AutoscalerPolicy,
                                                 FleetAutoscaler)
from paddle_tpu_torch.serving.bucketing import BucketPlan
from _port_fixtures import collect_garbage_after_module  # noqa: F401


def _ctr(counter, **labels):
    try:
        return float(counter.value(**labels))
    except Exception:
        return 0.0


def _sig(reps, breached=False, qps=0.0, spawn_inflight=False,
         retire_inflight=False):
    return {"replicas": reps, "breached": breached, "qps": qps,
            "spawn_inflight": spawn_inflight,
            "retire_inflight": retire_inflight}


def _rep(state="up", q=0.0, hdrm=None, fresh=True):
    return {"state": state, "srv_q": q, "hdrm_frac": hdrm,
            "fresh": fresh}


# ---------------------------------------------------------------------------
# decision table: spawn/retire target-size policy
# ---------------------------------------------------------------------------

def test_scale_up_on_sustained_burn_and_queue():
    p = AutoscalerPolicy(min_replicas=1, max_replicas=2, queue_high=4.0,
                         up_ticks=2, initial_target=1)
    sig = _sig({"a": _rep(q=10.0)}, breached=True, qps=50.0)
    d1 = p.decide(sig)
    assert not d1.spawn and p.target == 1 and not d1.count  # hysteresis
    d2 = p.decide(sig)
    assert p.target == 2 and d2.spawn and d2.spawn_reason == "burn_queue"
    assert d2.count == [("up", "burn_queue")]


def test_no_scale_up_without_queue_pressure_or_breach():
    p = AutoscalerPolicy(min_replicas=1, max_replicas=4, queue_high=4.0,
                         up_ticks=1, initial_target=1)
    for _ in range(5):      # breached but queues empty: latency blip,
        p.decide(_sig({"a": _rep(q=0.0)}, breached=True))   # not load
    assert p.target == 1
    for _ in range(5):      # deep queues but objective met: batching
        p.decide(_sig({"a": _rep(q=50.0)}, breached=False))  # absorbs it
    assert p.target == 1


def test_cooldown_blocks_back_to_back_bumps():
    p = AutoscalerPolicy(min_replicas=1, max_replicas=4, queue_high=1.0,
                         up_ticks=1, cooldown_ticks=3, initial_target=1)
    pressure = _sig({"a": _rep(q=9.0)}, breached=True, qps=50.0)
    assert p.decide(pressure).count == [("up", "burn_queue")]
    counts = []
    for _ in range(2):      # sustained pressure inside the cooldown
        counts += p.decide(pressure).count
    assert p.target == 2 and counts == []
    assert p.decide(pressure).count == [("up", "burn_queue")]
    assert p.target == 3    # cooldown expired: the next bump lands


def test_max_clamp_pins_the_target():
    p = AutoscalerPolicy(min_replicas=1, max_replicas=2, queue_high=1.0,
                         up_ticks=1, cooldown_ticks=0, initial_target=2)
    for _ in range(5):
        d = p.decide(_sig({"a": _rep(q=9.0), "b": _rep(q=9.0)},
                          breached=True, qps=50.0))
        assert not d.count and not d.spawn
    assert p.target == 2


def test_scale_down_on_sustained_idle_and_min_clamp():
    p = AutoscalerPolicy(min_replicas=1, max_replicas=4, down_ticks=3,
                         idle_qps=0.5, cooldown_ticks=0,
                         initial_target=2)
    two = {"a": _rep(), "b": _rep()}
    busy = _sig(two, qps=10.0)          # empty queues but real traffic:
    for _ in range(5):                  # NOT idle — qps guards the down
        assert not p.decide(busy).count
    assert p.target == 2
    idle = _sig(two, qps=0.0)
    counts = []
    for _ in range(3):
        counts += p.decide(idle).count
    assert p.target == 1 and counts == [("down", "idle")]
    one = _sig({"a": _rep()}, qps=0.0)
    for _ in range(6):                  # min clamp: never below 1
        assert not p.decide(one).count
    assert p.target == 1


def test_idle_retire_prefers_least_loaded_fresh_replica():
    p = AutoscalerPolicy(min_replicas=1, max_replicas=4, down_ticks=1,
                         cooldown_ticks=0, initial_target=2)
    reps = {"a": _rep(q=0.0, fresh=False), "b": _rep(q=0.0)}
    d = p.decide(_sig(reps, qps=0.0))
    assert d.retire == "b"              # fresh beats stale-but-idle


def test_death_repair_counts_once_and_never_recounts():
    p = AutoscalerPolicy(min_replicas=1, max_replicas=4,
                         initial_target=2)
    reps = {"a": _rep(state="dead"), "b": _rep()}
    d1 = p.decide(_sig(reps, qps=10.0))
    assert d1.count == [("up", "death")]
    assert d1.spawn and d1.spawn_reason == "death"
    # spawn in flight (or backing off after a failure): the SAME dead
    # replica must not recount, and no second spawn is initiated
    for _ in range(4):
        d = p.decide(_sig(reps, qps=10.0, spawn_inflight=True))
        assert not d.count and not d.spawn


def test_surplus_retires_once_per_episode():
    """A revived dead replica makes live > target: ONE counted decision
    per episode, even while the drain's actuation lags over ticks."""
    p = AutoscalerPolicy(min_replicas=1, max_replicas=4,
                         initial_target=2)
    three = {"a": _rep(), "b": _rep(), "c": _rep(q=1.0)}
    d1 = p.decide(_sig(three, qps=10.0))
    assert d1.retire in ("a", "b")
    assert d1.count == [("down", "surplus")]
    d2 = p.decide(_sig(three, qps=10.0, retire_inflight=True))
    assert d2.retire is None and not d2.count
    d3 = p.decide(_sig(three, qps=10.0))    # actuation lag: still 3 live
    assert d3.retire is not None and not d3.count   # no recount
    # episode ends (live == target), a NEW surplus counts again
    p.decide(_sig({"a": _rep(), "b": _rep()}, qps=10.0))
    d4 = p.decide(_sig(three, qps=10.0))
    assert d4.count == [("down", "surplus")]


def test_initial_target_clamped_into_bounds():
    assert AutoscalerPolicy(min_replicas=2, max_replicas=4,
                            initial_target=99).target == 4
    assert AutoscalerPolicy(min_replicas=2, max_replicas=4,
                            initial_target=0).target == 2


# ---------------------------------------------------------------------------
# decision table: shed-vs-scale arbitration
# ---------------------------------------------------------------------------

def test_shed_engages_only_while_spawn_inflight_or_at_max():
    p = AutoscalerPolicy(min_replicas=1, max_replicas=4, queue_high=99.0,
                         shed_after_ticks=2, shed_enabled=True,
                         initial_target=1)
    breach = _sig({"a": _rep(q=0.5)}, breached=True, qps=10.0)
    assert p.decide(breach).shed is None        # tick 1: under the gate
    assert p.decide(breach).shed is None        # sustained, but no spawn
    assert not p.shed_on                        # is in flight: scale-up
    d = p.decide(_sig({"a": _rep(q=0.5)}, breached=True, qps=10.0,
                      spawn_inflight=True))
    assert d.shed is True and p.shed_on
    # breach clears (the new replica absorbed it): shed releases
    d2 = p.decide(_sig({"a": _rep(), "b": _rep()}, qps=10.0))
    assert d2.shed is False and not p.shed_on


def test_shed_at_max_without_spawn():
    p = AutoscalerPolicy(min_replicas=1, max_replicas=1, queue_high=99.0,
                         shed_after_ticks=1, shed_enabled=True,
                         initial_target=1)
    d = p.decide(_sig({"a": _rep(q=9.0)}, breached=True, qps=10.0))
    assert d.shed is True       # pinned at max: shedding is all there is


def test_shed_requires_the_flag():
    p = AutoscalerPolicy(min_replicas=1, max_replicas=1,
                         shed_after_ticks=1, shed_enabled=False,
                         initial_target=1)
    for _ in range(5):
        assert p.decide(_sig({"a": _rep(q=9.0)}, breached=True,
                             spawn_inflight=True)).shed is None
    assert not p.shed_on


# ---------------------------------------------------------------------------
# decision table: degradation ladder
# ---------------------------------------------------------------------------

def test_headroom_shrinks_locally_before_any_global_action():
    p = AutoscalerPolicy(min_replicas=1, max_replicas=4, oom_frac=0.10,
                         shrink_grace_ticks=3, initial_target=2)
    reps = {"a": _rep(hdrm=0.05), "b": _rep(hdrm=0.5)}
    d1 = p.decide(_sig(reps, qps=10.0))
    assert d1.shrink == ["a"] and not d1.respawn    # local rung first
    assert not d1.spawn and not d1.count
    d2 = p.decide(_sig(reps, qps=10.0))             # grace ticks run
    d3 = p.decide(_sig(reps, qps=10.0))
    assert not d2.respawn and not d3.respawn
    d4 = p.decide(_sig(reps, qps=10.0))             # still at risk:
    assert d4.respawn == ["a"]                      # last rung fires
    assert d4.count == [("up", "oom")]
    assert not d4.spawn         # the respawn IS the spawn (worker pair)


def test_headroom_recovery_resets_the_ladder():
    p = AutoscalerPolicy(min_replicas=1, max_replicas=4, oom_frac=0.10,
                         shrink_grace_ticks=2, initial_target=1)
    assert p.decide(_sig({"a": _rep(hdrm=0.05)},
                         qps=10.0)).shrink == ["a"]
    d = p.decide(_sig({"a": _rep(hdrm=0.4)}, qps=10.0))  # shrink worked
    assert not d.respawn and not d.count
    for _ in range(4):          # healthy headroom: the grace counter
        d = p.decide(_sig({"a": _rep(hdrm=0.4)}, qps=10.0))   # is gone
        assert not d.respawn


def test_shrink_widths_halves_built_buckets_only():
    bp = BucketPlan((8, 16), lambda b: None, max_batch=4)
    with bp._mu:                # built entry, injected like the router
        bp._plans[8] = ("prog", ["x"], ["y"], 4)   # tests poke _reps
    assert bp.shrink_widths() == {8: 2}
    assert bp.width_of(8) == 2
    assert bp.width_of(16) is None      # cold bucket untouched
    assert bp.shrink_widths() == {8: 1}
    assert bp.shrink_widths() == {8: 1}             # floor 1, no flap


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------

def test_fleet_size_bounds_validated_as_a_pair():
    with pytest.raises(ValueError):
        set_flags({"FLAGS_fleet_min_replicas": 5,
                   "FLAGS_fleet_max_replicas": 2})
    with pytest.raises(ValueError):
        set_flags({"FLAGS_fleet_scale_eval_interval_s": 0})
    with pytest.raises(ValueError):
        set_flags({"FLAGS_fleet_oom_headroom_frac": 1.5})
    try:                        # a consistent combined update applies
        set_flags({"FLAGS_fleet_min_replicas": 2,
                   "FLAGS_fleet_max_replicas": 3})
    finally:
        set_flags({"FLAGS_fleet_min_replicas": 1,
                   "FLAGS_fleet_max_replicas": 4})


def test_policy_from_flags_converts_cooldown_seconds_to_ticks():
    set_flags({"FLAGS_fleet_scale_cooldown_s": 3.0,
               "FLAGS_serving_slo_shed": True})
    try:
        p = AutoscalerPolicy.from_flags(interval_s=0.5)
        assert p.cooldown_ticks == 6 and p.shed_enabled
    finally:
        set_flags({"FLAGS_fleet_scale_cooldown_s": 30.0,
                   "FLAGS_serving_slo_shed": False})


def test_autoscaler_fault_sites_registered():
    for site in ("autoscaler.decide", "autoscaler.spawn",
                 "autoscaler.retire"):
        assert site in resilience.KNOWN_SITES, site


# ---------------------------------------------------------------------------
# loop host: FleetAutoscaler over a stub router
# ---------------------------------------------------------------------------

class _StubRouter:
    """Duck-typed FleetRouter surface the controller touches."""

    def __init__(self, addrs=("a:1",)):
        self.slo = None
        self.reps = {a: {"state": "up", "load": {"srv_q": 0.0},
                         "fresh": True} for a in addrs}
        self.shed_calls = []
        self.draining = []
        self.removed = []
        self.added = []
        self.control_calls = []

    def replica_view(self):
        return {a: dict(r) for a, r in self.reps.items()}

    def snapshot(self):
        return {"completed": 0}

    def set_shedding(self, on):
        self.shed_calls.append(bool(on))

    def add_replica(self, addr):
        self.added.append(addr)
        self.reps[addr] = {"state": "up", "load": {"srv_q": 0.0},
                           "fresh": True}

    def remove_replica(self, addr):
        self.removed.append(addr)
        self.reps.pop(addr, None)

    def _mark_draining(self, addr):
        self.draining.append(addr)
        self.reps[addr]["state"] = "draining"

    def control(self, addr, cmd, timeout_s=5.0):
        self.control_calls.append((addr, cmd))
        return {"ok": True, "widths": {"32": 2}}


class _StubSLO:
    def __init__(self):
        self.breached = False

    def evaluate(self, now=None):
        return {"*": {"breached": self.breached}}

    def record(self, *a, **kw):
        pass


def _join_workers(sc):
    for t in (sc._spawn_thread, sc._retire_thread):
        if t is not None:
            t.join(timeout=5.0)


def test_spawn_failure_backs_off_then_retries_without_recount():
    router = _StubRouter()
    now = [0.0]
    calls = []

    def spawn():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("boom")
        return "b:2"

    pol = AutoscalerPolicy(min_replicas=2, max_replicas=2,
                           initial_target=2)
    sc = FleetAutoscaler(router, spawn, lambda a: None, policy=pol,
                         interval_s=0.25, clock=lambda: now[0])
    sc.tick(now=0.0)                    # deficit: spawn -> injected fail
    _join_workers(sc)
    assert len(calls) == 1 and sc.status()["spawn_failures"] == 1
    sc.tick(now=1.0)                    # inside the backoff window:
    _join_workers(sc)                   # spawn_inflight gates the retry
    assert len(calls) == 1
    assert sc.status()["spawn_inflight"] is False or len(calls) == 1
    now[0] = 60.0                       # backoff lapsed (default 10s)
    sc.tick(now=60.0)
    _join_workers(sc)
    assert len(calls) == 2 and router.added == ["b:2"]
    assert sc.status()["spawn_failures"] == 1


def test_injected_decide_fault_skips_the_tick_whole():
    router = _StubRouter()
    pol = AutoscalerPolicy(min_replicas=2, max_replicas=2,
                           initial_target=2)     # a deficit is pending
    spawned = []
    sc = FleetAutoscaler(router, lambda: spawned.append(1) or "b:2",
                         lambda a: None, policy=pol, interval_s=0.25)
    set_flags({"FLAGS_fault_inject": "autoscaler.decide:once"})
    try:
        st = sc.tick(now=0.0)           # fault: no half-decision
    finally:
        set_flags({"FLAGS_fault_inject": ""})
    _join_workers(sc)
    assert not spawned and st["ticks"] == 0
    sc.tick(now=0.5)                    # next tick actuates normally
    _join_workers(sc)
    assert spawned and router.added == ["b:2"]


def test_injected_spawn_fault_backs_off_and_never_crashes():
    router = _StubRouter()
    pol = AutoscalerPolicy(min_replicas=2, max_replicas=2,
                           initial_target=2)
    spawned = []
    sc = FleetAutoscaler(router, lambda: spawned.append(1) or "b:2",
                         lambda a: None, policy=pol, interval_s=0.25)
    set_flags({"FLAGS_fault_inject": "autoscaler.spawn:once"})
    try:
        sc.tick(now=0.0)
        _join_workers(sc)
    finally:
        set_flags({"FLAGS_fault_inject": ""})
    assert not spawned                  # fault fired before spawn_fn
    assert sc.status()["spawn_failures"] == 1
    assert not router.added


def test_injected_retire_fault_leaves_replica_to_self_heal():
    router = _StubRouter(addrs=("a:1", "b:2", "c:3"))
    retired = []
    pol = AutoscalerPolicy(min_replicas=1, max_replicas=4,
                           initial_target=2)     # surplus: retire one
    sc = FleetAutoscaler(router, lambda: "x:9", retired.append,
                         policy=pol, interval_s=0.25)
    set_flags({"FLAGS_fault_inject": "autoscaler.retire:once"})
    try:
        sc.tick(now=0.0)
        _join_workers(sc)
    finally:
        set_flags({"FLAGS_fault_inject": ""})
    # marked draining before the worker (held out of placement), but the
    # fault aborted BEFORE the SIGTERM: never retired, never removed —
    # its next reply reports draining=False and the router restores it
    assert len(router.draining) == 1
    assert not retired and not router.removed


def test_tick_shed_actuates_through_the_router():
    router = _StubRouter()
    router.slo = _StubSLO()
    pol = AutoscalerPolicy(min_replicas=1, max_replicas=1,
                           shed_after_ticks=1, shed_enabled=True,
                           initial_target=1)     # pinned at max
    sc = FleetAutoscaler(router, lambda: "x:9", lambda a: None,
                         policy=pol, interval_s=0.25)
    router.slo.breached = True
    sc.tick(now=0.0)
    assert router.shed_calls == [True]
    router.slo.breached = False
    sc.tick(now=0.5)
    assert router.shed_calls == [True, False]


def test_tick_runs_the_ladder_through_the_control_op():
    router = _StubRouter()
    router.reps["a:1"]["load"] = {"srv_q": 0.0, "hbm": 95.0,
                                  "hdrm": 5.0}   # 5% headroom: at risk
    shrink0 = _ctr(monitor.FLEET_SHRINK_CTR)
    pol = AutoscalerPolicy(min_replicas=1, max_replicas=4,
                           oom_frac=0.10, initial_target=1)
    sc = FleetAutoscaler(router, lambda: "x:9", lambda a: None,
                         policy=pol, interval_s=0.25)
    sc.tick(now=0.0)
    assert router.control_calls == [("a:1", "shrink_width")]
    assert _ctr(monitor.FLEET_SHRINK_CTR) - shrink0 == 1


def test_controller_loop_survives_a_raising_tick():
    router = _StubRouter()

    def bad_view():
        raise RuntimeError("router exploded")

    pol = AutoscalerPolicy(initial_target=1)
    sc = FleetAutoscaler(router, lambda: "x:9", lambda a: None,
                         policy=pol, interval_s=0.05)
    router.replica_view = bad_view
    with sc:                            # loop thread absorbs the error
        time.sleep(0.2)
        assert sc._thread.is_alive()


# ---------------------------------------------------------------------------
# parity with the reference's policy
# ---------------------------------------------------------------------------

_STATES = ("up", "up", "up", "stale", "draining", "dead")


def _random_policy_args(rng):
    lo = int(rng.randint(1, 3))
    return dict(min_replicas=lo, max_replicas=lo + int(rng.randint(0, 4)),
                queue_high=float(rng.choice([1.0, 2.0, 4.0])),
                idle_qps=float(rng.choice([0.5, 2.0])),
                up_ticks=int(rng.randint(1, 4)),
                down_ticks=int(rng.randint(1, 6)),
                cooldown_ticks=int(rng.randint(0, 6)),
                shed_after_ticks=int(rng.randint(1, 4)),
                oom_frac=float(rng.choice([0.05, 0.1, 0.2])),
                shrink_grace_ticks=int(rng.randint(1, 4)),
                shed_enabled=bool(rng.rand() < 0.7),
                initial_target=int(rng.randint(0, 6)))


def _random_signals(rng, ticks):
    """Signals that persist a few ticks (so hysteresis and cooldowns
    engage): replicas come and go, change state, report queues and
    headroom; the breach, rate and in-flight bits flip now and then."""
    addrs = [f"r{i}:1" for i in range(6)]
    reps = {a: {"state": "up", "srv_q": 0.0, "hdrm_frac": None,
                "fresh": True} for a in addrs[:2]}
    breached, qps, spawning, retiring = False, 0.0, False, False
    for _ in range(ticks):
        if rng.rand() < 0.1:
            a = addrs[rng.randint(len(addrs))]
            if a in reps:
                del reps[a]
            else:
                reps[a] = {"state": "up", "srv_q": 0.0, "hdrm_frac": None,
                           "fresh": True}
        for r in reps.values():
            if rng.rand() < 0.1:
                r["state"] = _STATES[rng.randint(len(_STATES))]
            if rng.rand() < 0.3:
                r["srv_q"] = float(rng.choice([0.0, 0.0, 1.0, 3.0, 9.0]))
            if rng.rand() < 0.1:
                r["hdrm_frac"] = (None if rng.rand() < 0.4
                                  else float(rng.rand() * 0.3))
            if rng.rand() < 0.1:
                r["fresh"] = bool(rng.rand() < 0.8)
        if rng.rand() < 0.15:
            breached = not breached
        if rng.rand() < 0.2:
            qps = float(rng.choice([0.0, 0.0, 0.3, 5.0, 50.0]))
        if rng.rand() < 0.15:
            spawning = not spawning
        if rng.rand() < 0.15:
            retiring = not retiring
        yield {"replicas": {a: dict(r) for a, r in reps.items()},
               "breached": breached, "qps": qps,
               "spawn_inflight": spawning, "retire_inflight": retiring}


def _decision(d):
    return {k: getattr(d, k) for k in ("spawn", "spawn_reason", "retire",
                                       "shed", "shrink", "respawn",
                                       "count")}


@pytest.mark.parametrize("seed", range(20))
def test_decide_matches_reference_tick_by_tick(seed):
    rng = np.random.RandomState(seed)
    kw = _random_policy_args(rng)
    ref, port = RefPolicy(**kw), AutoscalerPolicy(**kw)
    assert port.target == ref.target
    actions = set()
    for tick, sig in enumerate(_random_signals(rng, 200)):
        want, got = ref.decide(sig), port.decide(sig)
        assert _decision(got) == _decision(want), (tick, sig)
        assert (port.target, port.shed_on, port.cooldown, port.last) == \
            (ref.target, ref.shed_on, ref.cooldown, ref.last), tick
        actions.add(port.last["action"])
    assert len(actions) >= 3          # the run exercised the table


_FLAG_CASES = [
    {"FLAGS_fleet_min_replicas": 2, "FLAGS_fleet_max_replicas": 6,
     "FLAGS_fleet_scale_eval_interval_s": 0.5,
     "FLAGS_fleet_scale_up_ticks": 3, "FLAGS_fleet_scale_down_ticks": 7,
     "FLAGS_fleet_scale_cooldown_s": 4.6, "FLAGS_fleet_queue_high": 2.5,
     "FLAGS_fleet_idle_qps": 0.25, "FLAGS_fleet_shed_after_ticks": 4,
     "FLAGS_fleet_oom_headroom_frac": 0.15,
     "FLAGS_fleet_shrink_grace_ticks": 2, "FLAGS_serving_slo_shed": True},
    {"FLAGS_fleet_scale_eval_interval_s": 3.0,
     "FLAGS_fleet_scale_cooldown_s": 0.0},
    {},
]


@pytest.mark.parametrize("case", range(len(_FLAG_CASES)))
@pytest.mark.parametrize("interval_s", [None, 0.25])
def test_from_flags_matches_reference(case, interval_s):
    names = sorted(set().union(*_FLAG_CASES))
    saved = pt.get_flags(names)
    try:
        set_flags(_FLAG_CASES[case])
        pt.set_flags(_FLAG_CASES[case])
        ref = RefPolicy.from_flags(initial_target=3, interval_s=interval_s)
        port = AutoscalerPolicy.from_flags(initial_target=3,
                                           interval_s=interval_s)
        keys = ("min", "max", "queue_high", "idle_qps", "up_ticks",
                "down_ticks", "cooldown_ticks", "shed_after_ticks",
                "oom_frac", "shrink_grace_ticks", "shed_enabled", "target")
        assert {k: getattr(port, k) for k in keys} == \
            {k: getattr(ref, k) for k in keys}
    finally:
        set_flags(saved)
        pt.set_flags(saved)


def test_fleet_flags_defaults_equal_reference():
    names = ["FLAGS_fleet_route_policy", "FLAGS_fleet_digest_ttl_s",
             "FLAGS_fleet_min_replicas", "FLAGS_fleet_max_replicas",
             "FLAGS_fleet_scale_eval_interval_s",
             "FLAGS_fleet_scale_up_ticks", "FLAGS_fleet_scale_down_ticks",
             "FLAGS_fleet_scale_cooldown_s", "FLAGS_fleet_queue_high",
             "FLAGS_fleet_idle_qps", "FLAGS_fleet_shed_after_ticks",
             "FLAGS_fleet_oom_headroom_frac",
             "FLAGS_fleet_shrink_grace_ticks", "FLAGS_fleet_spawn_backoff_s"]
    from paddle_tpu import flags as ref_flags
    from paddle_tpu_torch import flags as port_flags
    assert {n: port_flags._DEFAULTS[n] for n in names} == \
        {n: ref_flags._DEFAULTS[n] for n in names}
    for bad in ({"FLAGS_fleet_route_policy": "random"},
                {"FLAGS_fleet_digest_ttl_s": 0},
                {"FLAGS_fleet_queue_high": -1},
                {"FLAGS_fleet_scale_up_ticks": 0}):
        with pytest.raises(ValueError):
            set_flags(bad)
        with pytest.raises(ValueError):
            pt.set_flags(bad)
