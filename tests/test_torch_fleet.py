"""The port's serving fleet against the JAX package's, on the CPU.

- The reference's coordinator-free fleet tests (``tests/test_fleet.py``),
  run on the port: least-loaded and round-robin placement, the digest TTL,
  draining and dead replicas held out, the serving digest's freshness gate,
  the fault sites, an end-to-end request with its ledger, re-routes around
  a dead and a draining replica, the fleet-wide quota, and a loud failure
  when every replica is gone (stub servers, real sockets).
- Placement parity: seeded sequences of replies with load reports, deaths,
  drains and clock jumps past the TTL, fed to the reference's
  ``FleetRouter`` and the port's (stub addresses, no socket), pick the same
  replica at every step and leave the same table.
- The frame protocol: the port's ``send_frame`` writes the reference's
  bytes, each side reads the other's frames, both refuse a frame over the
  16 MiB cap.
- A tiny GPT served by two port ``InferenceServer``s behind in-process
  endpoints returns over the router the reference ``InferenceServer``'s
  logits for the same weights (within the serving tests' 1e-4), also while
  one endpoint stops mid-stream (no failure, a ``dead`` re-route, the
  ledger exact).
- The chaos drills through ``paddle_tpu_torch/tools/fleet_smoke.py`` (replica
  processes, tiny width, the host) are ``slow``, as the reference's are,
  save the ``coord`` scenario (a primary coordinator SIGKILLed under load,
  the standby promoted).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.distributed import coordinator as ref_coord
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.models import transformer as RT
from paddle_tpu.serving import fleet as ref_fleet
from paddle_tpu.serving import InferenceServer as RefInferenceServer
from paddle_tpu_torch import flags, monitor, resilience
from paddle_tpu_torch.distributed import coordinator as coord
from paddle_tpu_torch.framework import core, scope as scope_mod, unique_name
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving.fleet import (FleetError, FleetRouter,
                                            ReplicaEndpoint)
from paddle_tpu_torch.serving.server import AdmissionError
from _port_fixtures import collect_garbage_after_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "paddle_tpu_torch", "tools", "fleet_smoke.py")
CFG = dict(vocab_size=48, d_model=16, n_layer=2, n_head=2, d_inner=32,
           max_pos=64, dropout=0.0)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)      # test_torch_serving.py's


@pytest.fixture(autouse=True)
def _isolation():
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope_mod._scope_stack.append(scope_mod.Scope())
    with unique_name.guard():
        yield
    flags.set_flags({"FLAGS_fault_inject": "",
                     "FLAGS_rpc_circuit_break_secs": 0.0})
    pt.set_flags({"FLAGS_rpc_circuit_break_secs": 0.0})
    scope_mod._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


# -- a stub serving server: the endpoint/router contract, no executor ---------

class _Future:
    def __init__(self, value=None, err=None, delay_s=0.0):
        self._value, self._err, self._delay = value, err, delay_s

    def result(self, timeout=None):
        if self._delay:
            time.sleep(self._delay)
        if self._err is not None:
            raise self._err
        return self._value


class StubServer:
    """submit / queue_depth / _draining: what ReplicaEndpoint touches."""

    def __init__(self, delay_s=0.0):
        self._draining = threading.Event()
        self.delay_s = delay_s
        self.served = 0

    def queue_depth(self):
        return 0

    def submit(self, tenant, feeds, seq_len=None, **kw):
        if self._draining.is_set():
            return _Future(err=AdmissionError(
                f"tenant {tenant!r} rejected (draining)"))
        self.served += 1
        return _Future(value=[np.asarray([[float(self.served)]])],
                       delay_s=self.delay_s)


def _fleet(n=2, **router_kw):
    eps = [ReplicaEndpoint(StubServer(), replica_id=f"r{i}").start()
           for i in range(n)]
    router_kw.setdefault("digest_ttl_s", 0.5)
    return eps, FleetRouter([e.address for e in eps], **router_kw)


def _fresh(router):
    now = time.monotonic()
    with router._mu:
        for rep in router._reps.values():
            rep["last_seen"] = now


# -- the reference's tests, on the port ---------------------------------------

def test_least_loaded_placement_prefers_smallest_queue():
    eps, router = _fleet(3)
    try:
        now = time.monotonic()
        with router._mu:
            for i, (addr, rep) in enumerate(router._reps.items()):
                rep["last_seen"] = now
                rep["load"] = {"srv_q": float(3 - i)}  # last is least
        assert router._place() == list(router._reps)[-1]
    finally:
        for e in eps:
            e.stop()


def test_round_robin_rotates_over_fresh_replicas():
    eps, router = _fleet(3, policy="round_robin")
    try:
        _fresh(router)
        assert {router._place() for _ in range(6)} == set(router._reps)
    finally:
        for e in eps:
            e.stop()


def test_digest_ttl_ages_replica_out_of_placement():
    eps, router = _fleet(2, digest_ttl_s=0.2)
    try:
        now = time.monotonic()
        addrs = list(router._reps)
        with router._mu:
            # replica 0: an attractive but stale report; 1: fresh, busier
            router._reps[addrs[0]]["last_seen"] = now - 1.0
            router._reps[addrs[0]]["load"] = {"srv_q": 0.0}
            router._reps[addrs[1]]["last_seen"] = now
            router._reps[addrs[1]]["load"] = {"srv_q": 50.0}
        assert router._place() == addrs[1]
        with router._mu:
            assert router._reps[addrs[0]]["state"] == "stale"
        # nothing fresh: a stale (not draining or dead) replica is tried
        with router._mu:
            router._reps[addrs[1]]["last_seen"] = now - 1.0
        assert router._place() in addrs
    finally:
        for e in eps:
            e.stop()


def test_draining_and_dead_replicas_excluded():
    eps, router = _fleet(3)
    try:
        _fresh(router)
        addrs = list(router._reps)
        with router._mu:
            router._set_state_locked(addrs[0], "draining")
            router._set_state_locked(addrs[1], "dead")
        for _ in range(4):
            assert router._place() == addrs[2]
        assert monitor.FLEET_REPLICA_STATE.value(replica=addrs[1]) == 2.0
    finally:
        for e in eps:
            e.stop()


def test_serving_digest_freshness_gate():
    import paddle_tpu_torch.serving.scheduler as sched
    old = sched.last_alive_wall
    try:
        sched.last_alive_wall = time.time()
        assert monitor._serving_digest_fresh()
        sched.last_alive_wall = time.time() - 1e4
        assert not monitor._serving_digest_fresh()
        assert "srv_q" not in monitor.metrics_digest()
        sched.last_alive_wall = 0.0
        assert not monitor._serving_digest_fresh()
    finally:
        sched.last_alive_wall = old


def test_new_fault_sites_registered():
    for site in ("serving.batch_dispatch", "router.forward",
                 "coordinator.frame", "replica.heartbeat"):
        assert site in resilience.KNOWN_SITES, site


def test_router_infer_end_to_end_and_ledger():
    eps, router = _fleet(2)
    router.start()
    try:
        out = router.infer("acme", {"x": [1.0, 2.0]})
        assert np.asarray(out[0]).shape == (1, 1)
        for _ in range(5):
            router.infer("acme", {"x": [0.5]})
        snap = router.snapshot()
        assert snap["admitted"] == snap["completed"] == 6
        assert snap["failed"] == snap["rejected"] == 0
    finally:
        router.stop()
        for e in eps:
            e.stop()


def test_router_reroutes_around_dead_replica():
    eps, router = _fleet(2)
    try:
        _fresh(router)
        dead0 = monitor.FLEET_REROUTE_CTR.value(reason="dead")
        eps[0].stop()
        for i in range(6):
            router.infer("acme", {"x": [float(i)]})
        snap = router.snapshot()
        assert snap["completed"] == 6 and snap["failed"] == 0
        assert snap["replicas"][eps[0].address]["state"] == "dead"
        assert monitor.FLEET_REROUTE_CTR.value(reason="dead") > dead0
    finally:
        router.stop()
        for e in eps:
            e.stop()


def test_router_reroutes_around_draining_replica():
    eps, router = _fleet(2, policy="round_robin")
    try:
        _fresh(router)
        drain0 = monitor.FLEET_REROUTE_CTR.value(reason="drain")
        eps[0].server._draining.set()   # the SIGTERM path
        for i in range(6):
            router.infer("acme", {"x": [float(i)]})
        snap = router.snapshot()
        assert snap["completed"] == 6 and snap["failed"] == 0
        assert snap["replicas"][eps[0].address]["state"] == "draining"
        assert monitor.FLEET_REROUTE_CTR.value(reason="drain") > drain0
    finally:
        router.stop()
        for e in eps:
            e.stop()


def test_router_fleet_wide_quota():
    eps, router = _fleet(2, tenant_quota=1)
    try:
        for e in eps:
            e.server.delay_s = 0.5
        _fresh(router)
        results = []

        def go():
            try:
                router.infer("acme", {"x": [1.0]})
                results.append("ok")
            except AdmissionError:
                results.append("quota")
        threads = [threading.Thread(target=go) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results.count("ok") >= 1
        assert results.count("quota") >= 1   # one bound, fleet-wide
    finally:
        router.stop()
        for e in eps:
            e.stop()


def _failovers():
    return monitor.FLEET_FAILOVER_HIST.labels().snapshot()[2]


def test_injected_router_forward_reroutes_once_as_dead():
    """``router.forward:once`` tears one forward: that request re-routes
    once as ``dead``, lands on the other replica and observes the failover
    histogram once; the ledger stays exact."""
    eps, router = _fleet(2)
    try:
        _fresh(router)
        dead0 = monitor.FLEET_REROUTE_CTR.value(reason="dead")
        fault0 = resilience._FAULT_CTR.value(site="router.forward")
        failovers0 = _failovers()
        flags.set_flags({"FLAGS_fault_inject": "router.forward:once"})
        for i in range(4):
            router.infer("acme", {"x": [float(i)]})
        assert monitor.FLEET_REROUTE_CTR.value(reason="dead") - dead0 == 1
        assert resilience._FAULT_CTR.value(site="router.forward") - \
            fault0 == 1
        assert _failovers() - failovers0 == 1
        snap = router.snapshot()
        assert snap["admitted"] == snap["completed"] == 4
        assert snap["failed"] == snap["rejected"] == 0
        assert [r["state"] for r in snap["replicas"].values()].count(
            "dead") == 1
        assert sum(e.server.served for e in eps) == 4
    finally:
        router.stop()
        for e in eps:
            e.stop()


def test_router_fails_loud_when_whole_fleet_dead():
    eps, router = _fleet(2, request_timeout_s=1.5)
    try:
        for e in eps:
            e.stop()
        with pytest.raises(FleetError):
            router.infer("acme", {"x": [1.0]})
        snap = router.snapshot()
        assert snap["failed"] == 1 and snap["completed"] == 0
    finally:
        router.stop()


# -- placement parity with the reference's router -----------------------------

class _Clock:
    """A ``time`` stand-in for both fleet modules: ``monotonic`` is ours."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def _drive(ref, port, rng, steps, ttl):
    addrs = list(port._reps)
    for step in range(steps):
        op = rng.randint(6)
        a = addrs[rng.randint(len(addrs))]
        if op <= 1:
            resp = {"ok": True, "draining": bool(rng.rand() < 0.1),
                    "load": {"srv_q": float(rng.randint(4))}}
            ref._note_reply(a, resp)
            port._note_reply(a, resp)
        elif op == 2 and rng.rand() < 0.5:
            ref._mark_dead(a)
            port._mark_dead(a)
        elif op == 2:
            ref._mark_draining(a)
            port._mark_draining(a)
        elif op == 3:
            _CLOCK.now += float(rng.rand()) * 1.5 * ttl
        excl = [x for x in addrs if rng.rand() < 0.15]
        got = (ref._place(exclude=excl), port._place(exclude=excl))
        assert got[0] == got[1], (step, got)
        assert ref._rr == port._rr
        assert {k: (r["state"], r["load"], r["last_seen"])
                for k, r in ref._reps.items()} == \
            {k: (r["state"], r["load"], r["last_seen"])
             for k, r in port._reps.items()}, step


_CLOCK = _Clock()


@pytest.mark.parametrize("policy", ["least_loaded", "round_robin"])
@pytest.mark.parametrize("seed", range(4))
def test_placement_matches_reference_step_by_step(monkeypatch, policy, seed):
    monkeypatch.setattr(ref_fleet, "time", _CLOCK)
    monkeypatch.setattr(fleet, "time", _CLOCK)
    # an open breaker holds a dead replica out until a reply closes it
    flags.set_flags({"FLAGS_rpc_circuit_break_secs": 1000.0})
    pt.set_flags({"FLAGS_rpc_circuit_break_secs": 1000.0})
    rng = np.random.RandomState(seed)
    addrs = [f"10.0.0.{i}:{7000 + i}" for i in range(2 + seed % 3)]
    ttl = 2.0
    ref = ref_fleet.FleetRouter(addrs, policy=policy, digest_ttl_s=ttl)
    port = FleetRouter(addrs, policy=policy, digest_ttl_s=ttl)
    _drive(ref, port, rng, 200, ttl)
    assert ref.snapshot()["replicas"].keys() == \
        port.snapshot()["replicas"].keys()


# -- the frame protocol -------------------------------------------------------

class _Wire:
    """A socket stand-in recording what is sent and replaying it."""

    def __init__(self, data=b""):
        self.sent = bytearray()
        self._rx = bytes(data)

    def sendall(self, b):
        self.sent += b

    def recv(self, n):
        out, self._rx = self._rx[:n], self._rx[n:]
        return out


_FRAMES = [{"op": "infer", "tenant": "t", "seq_len": None,
            "feeds": {"src_ids": {"data": [[1, 2, 3]], "dtype": "int64"}}},
           {"ok": True, "outputs": [[[0.1, -2.5e-8, 3.0]]],
            "load": {"srv_q": 2.0, "occ": 3.0}, "draining": False,
            "replica": "réplica-7"},
           [1, "two", None, 3.25], {"z": {"b": 1, "a": [True, False]}}]


@pytest.mark.parametrize("obj", _FRAMES, ids=range(len(_FRAMES)))
def test_frame_bytes_equal_reference(obj):
    mine, theirs = _Wire(), _Wire()
    coord.send_frame(mine, obj)
    ref_coord.send_frame(theirs, obj)
    assert bytes(mine.sent) == bytes(theirs.sent)
    assert coord.recv_frame(_Wire(theirs.sent)) == obj
    assert ref_coord.recv_frame(_Wire(mine.sent)) == obj


def test_frames_over_the_cap_refused_by_both():
    assert coord.MAX_FRAME_BYTES == ref_coord.MAX_FRAME_BYTES == 16 << 20
    big = {"x": "a" * coord.MAX_FRAME_BYTES}
    for mod in (coord, ref_coord):
        w = _Wire()
        with pytest.raises(ValueError, match="exceeds"):
            mod.send_frame(w, big)
        assert not w.sent                  # nothing went out
        hdr = (coord.MAX_FRAME_BYTES + 1).to_bytes(4, "big")
        with pytest.raises(ValueError, match="over the"):
            mod.recv_frame(_Wire(hdr))
        with pytest.raises(ConnectionError):
            mod.recv_frame(_Wire(b"\x00\x00"))


def test_frames_cross_a_real_socket_both_ways():
    a, b = socket.socketpair()
    try:
        coord.send_frame(a, _FRAMES[1])
        assert ref_coord.recv_frame(b) == _FRAMES[1]
        ref_coord.send_frame(b, _FRAMES[0])
        assert coord.recv_frame(a) == _FRAMES[0]
    finally:
        a.close()
        b.close()


# -- a tiny GPT over the router, against the reference's server ---------------

def _port_factory(seq):
    prog, startup = core.Program(), core.Program()
    with core.program_guard(prog, startup):
        _, logits = T.build_gpt_serving(T.BertConfig(**CFG), seq,
                                        attn_impl="flash")
    return prog, ["src_ids"], [logits.name]


def _ref_factory(seq):
    prog, startup = RefProgram(), RefProgram()
    with ref_guard(prog, startup):
        _, logits = RT.build_gpt_serving(RT.BertConfig(**CFG), seq,
                                         attn_impl="flash")
    return prog, ["src_ids"], [logits.name]


@pytest.fixture(scope="module")
def weights():
    startup = RefProgram()
    with ref_guard(RefProgram(), startup):
        RT.build_gpt_serving(RT.BertConfig(**CFG), 8, attn_impl="flash")
    ref_scope = RefScope()
    RefExecutor().run(startup, scope=ref_scope, seed=17)
    return {v.name: np.asarray(ref_scope.find_var(v.name))
            for v in startup.global_block().vars.values()}


def _requests():
    rng = np.random.RandomState(9)
    return [("acme" if i % 2 else "globex",
             rng.randint(1, CFG["vocab_size"],
                         (int(rng.randint(2, 17)),)).astype(np.int64))
            for i in range(8)]


def test_tiny_gpt_over_the_router_matches_reference_server(weights):
    reqs = _requests()
    ref_scope = RefScope()
    for n, a in weights.items():
        ref_scope.set_var(n, jnp.asarray(a))
    rsrv = RefInferenceServer(_ref_factory, ref_scope, buckets=(8, 16),
                              max_batch=4, batch_wait_ms=2.0)
    rsrv.start()
    want = [rsrv.submit(t, {"src_ids": ids}).result(timeout=120)[0]
            for t, ids in reqs]
    rsrv.drain(60)
    rsrv.stop()

    srvs, eps = [], []
    for i in range(2):
        srv = ptt.serving.InferenceServer(
            _port_factory, ptt.io.params_from_numpy(scope_mod.Scope(),
                                                    weights),
            buckets=(8, 16), max_batch=4, batch_wait_ms=2.0,
            executor=ptt.Executor(ptt.CPUPlace()))
        srvs.append(srv.start())
        eps.append(ReplicaEndpoint(srv, replica_id=f"gpt{i}").start())
    router = FleetRouter([e.address for e in eps], digest_ttl_s=5.0)
    dead0 = monitor.FLEET_REROUTE_CTR.value(reason="dead")
    try:
        _fresh(router)
        for (t, ids), w in zip(reqs, want):
            got = np.asarray(router.infer(t, {"src_ids": ids})[0])
            assert got.shape == (len(ids), CFG["vocab_size"])
            np.testing.assert_allclose(got, w, **LOGITS_TOL)
        assert all(len(s.batch_log()) for s in srvs)   # both served
        # the same requests from 4 clients while one endpoint stops
        got, errors, mu = {}, [], threading.Lock()

        def client(k):
            for i in range(k, len(reqs), 4):
                try:
                    out = router.infer(reqs[i][0], {"src_ids": reqs[i][1]})
                    with mu:
                        got[i] = np.asarray(out[0])
                except Exception as e:
                    with mu:
                        errors.append(repr(e))
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for th in threads:
            th.start()
        eps[0].stop()
        for th in threads:
            th.join()
        assert not errors
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[i], w, **LOGITS_TOL)
        snap = router.snapshot()
        assert snap["admitted"] == snap["completed"] == 2 * len(reqs)
        assert snap["failed"] == snap["rejected"] == 0
        assert snap["replicas"][eps[0].address]["state"] == "dead"
        assert monitor.FLEET_REROUTE_CTR.value(reason="dead") > dead0
    finally:
        router.stop()
        for e in eps:
            e.stop()
        for s in srvs:
            s.stop()


def test_endpoint_reports_load_and_control_ops():
    srv = ptt.serving.InferenceServer(
        _port_factory, scope_mod.Scope(), buckets=(8,), max_batch=2,
        executor=ptt.Executor(ptt.CPUPlace()))
    ep = ReplicaEndpoint(srv, replica_id="ctl").start()
    router = FleetRouter([ep.address], digest_ttl_s=5.0)
    try:
        resp = router.control(ep.address, "shrink_width")
        assert resp["ok"] and resp["widths"] == {}   # no bucket built yet
        assert resp["replica"] == "ctl" and resp["draining"] is False
        assert resp["load"]["srv_q"] == 0.0
        bad = router.control(ep.address, "explode")
        assert not bad["ok"] and bad["error"] == "unknown_cmd"
        # a decode-less server has no plan: "unsupported"
        stub = ReplicaEndpoint(StubServer(), replica_id="stub").start()
        try:
            r = router._call(stub.address, {"op": "control",
                                            "cmd": "shrink_width"}, 5.0)
            assert r["error"] == "unsupported"
            r = router._call(stub.address, {"op": "nope"}, 5.0)
            assert r["error"] == "unknown_op"
        finally:
            stub.stop()
    finally:
        ep.stop()
        srv.stop()


# -- the chaos drills (slow, as the reference's) ------------------------------

def _run_smoke(*args):
    return subprocess.run([sys.executable, SMOKE, "--cpu", *args],
                          timeout=1500,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)


def _result(r):
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("FLEET RESULT ")][-1]
    return json.loads(line[len("FLEET RESULT "):])["scenarios"]


@pytest.mark.slow
def test_sigterm_drain_under_load_zero_failures():
    r = _run_smoke("--scenario", "drain")
    assert r.returncode == 0, r.stdout[-4000:]
    assert "fleet drain OK" in r.stdout
    assert _result(r)["drain"]["drained_rc"] == 0


@pytest.mark.slow
def test_replica_sigkill_mid_request_zero_failures():
    r = _run_smoke("--scenario", "kill")
    assert r.returncode == 0, r.stdout[-4000:]
    assert "fleet kill OK" in r.stdout


@pytest.mark.slow
def test_scale_drill_spike_kill_idle():
    r = _run_smoke("--scenario", "scale")
    assert r.returncode == 0, r.stdout[-4000:]
    assert "fleet scale OK" in r.stdout


@pytest.mark.slow
def test_full_runs_the_injected_variants():
    r = _run_smoke("--full")
    assert r.returncode == 0, r.stdout[-4000:]
    scen = _result(r)
    assert set(scen) == {"drain", "kill", "coord", "scale", "kill+inject",
                         "coord+inject", "scale+inject", "scale+coord"}
    assert scen["scale+inject"]["scale_up"] == 1
    assert scen["coord+inject"]["epoch"] >= 1
    assert scen["scale+coord"]["epoch"] >= 1


@pytest.mark.slow
def test_bench_prints_its_numbers_line():
    r = _run_smoke("--bench")
    assert r.returncode == 0, r.stdout[-4000:]
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("FLEET BENCH ")][-1]
    bench = json.loads(line[len("FLEET BENCH "):])
    assert bench["replicas"] == 2 and bench["aggregate_qps"] > 0


def test_coordinator_scenarios_name_their_queue():
    """The ``coord`` scenario runs: the primary coordinator SIGKILLed
    mid-commit-loop, the standby promoted, no request and no commit
    lost, the manifest never torn."""
    r = _run_smoke("--scenario", "coord")
    assert r.returncode == 0, r.stdout[-4000:]
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("FLEET RESULT ")][-1]
    coord = json.loads(line[len("FLEET RESULT "):])["scenarios"]["coord"]
    assert coord["epoch"] >= 1 and coord["published"] > 0
    assert coord["manifest"] >= coord["published"] - 1
    assert [c["rc"] for c in coord["children"]] == [0, 0]


def test_fleet_smoke_weights_need_their_expected_logits(capsys):
    from paddle_tpu_torch.tools import fleet_smoke
    for argv in (["--weights", "w"], ["--expect", "e.npy"]):
        with pytest.raises(SystemExit):
            fleet_smoke.main(["--cpu", *argv])
    assert "--weights and --expect go together" in capsys.readouterr().err


def test_fleet_smoke_probe_holds_replicas_to_the_expected_logits(
        monkeypatch):
    """The drill's probe: each replica's logits against the in-process
    server's; a replica that answers otherwise fails the drill."""
    from paddle_tpu_torch.tools import fleet_smoke
    eps = [ReplicaEndpoint(StubServer(), replica_id=f"r{i}").start()
           for i in range(2)]
    try:
        addrs = [e.address for e in eps]
        monkeypatch.setitem(fleet_smoke._CFG, "width", "tiny")
        monkeypatch.setitem(fleet_smoke._CFG, "expect",
                            np.asarray([[1.0]], np.float32))
        fleet_smoke._probe_against_expected(addrs, "probe")
        # each stub now answers 2.0
        with pytest.raises(AssertionError, match="in-process server"):
            fleet_smoke._probe_against_expected(addrs, "probe")
    finally:
        for e in eps:
            e.stop()
