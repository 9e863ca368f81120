"""The port's gang coordinator (``paddle_tpu_torch/distributed/
coordinator.py``) on the CPU: a counterpart of each of
``tests/test_coordinator.py``'s tests of framing, liveness, fingerprints,
backend parity with the file rendezvous, the metrics digests and gangtop
(:47-525, :737-1141; its executor step-barrier tests and the elastic drill
are ``tests/test_torch_gang.py``'s), run against the port's classes, and
the two packages' coordinators and clients against each other: a port
``GangClient`` drives a reference ``GangCoordinator`` and a reference
client a port coordinator, and the same request sequence gets the same
responses (time fields masked).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed.coordinator import GangClient as RefClient
from paddle_tpu.distributed.coordinator import \
    GangCoordinator as RefCoordinator
from paddle_tpu.distributed.coordinator import \
    GangDegradedError as RefDegradedError
from paddle_tpu.distributed.coordinator import \
    GangFingerprintError as RefFingerprintError
from paddle_tpu_torch import monitor
from paddle_tpu_torch.distributed.coordinator import (GangClient,
                                                      GangCoordinator,
                                                      GangDegradedError,
                                                      GangFingerprintError,
                                                      recv_frame, send_frame)
from paddle_tpu_torch.distributed.env import GangRendezvous
from _port_fixtures import collect_garbage_after_module  # noqa: F401

def _totals():
    return monitor.counter_totals()


def _delta(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def test_frame_round_trip_and_caps():
    a, b = socket.socketpair()
    try:
        msg = {"op": "hello", "rank": 3, "blob": "x" * 4096,
               "nested": {"steps": [1, 2, 3]}}
        send_frame(a, msg)
        assert recv_frame(b) == msg
        # an oversized length prefix is a protocol error, not a 2 GiB
        # allocation
        b.sendall((1 << 30).to_bytes(4, "big"))
        with pytest.raises(ValueError, match="cap"):
            recv_frame(a)
        # a closed peer reads as ConnectionError (not a hang / garbage)
        a.close()
        with pytest.raises(ConnectionError):
            recv_frame(b)
    finally:
        b.close()


def test_oversized_send_refused():
    a, b = socket.socketpair()
    try:
        with pytest.raises(ValueError, match="cap"):
            send_frame(a, {"blob": "x" * (17 << 20)})
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# liveness plane
# ---------------------------------------------------------------------------

def _gang(world=2, timeout=0.6, hb=0.1):
    coord = GangCoordinator(world_size=world,
                            heartbeat_timeout_s=timeout).start()
    clients = [GangClient(coord.address, rank=r, world_size=world,
                          heartbeat_interval_s=hb)
               .connect().start_heartbeat() for r in range(world)]
    return coord, clients


def test_heartbeat_timeout_declares_dead_then_rejoin(monkeypatch):
    before = _totals()
    coord, (c0, c1) = _gang()
    try:
        deadline = time.monotonic() + 5
        while coord.address and time.monotonic() < deadline:
            if c0.status()["status"] == "ok":
                break
            time.sleep(0.02)
        assert c0.status()["status"] == "ok"
        assert not c0.degraded
        # stop rank 1's heartbeats WITHOUT a goodbye (a SIGKILL says
        # nothing): after the timeout the coordinator must declare it
        # dead and degrade the gang
        c1.close(goodbye=False)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not c0.degraded:
            time.sleep(0.02)
        assert c0.degraded
        assert c0.dead_ranks == [1]
        # parking with the rank still dead times out honestly
        assert c0.wait_ready(timeout_s=0.3) is False
        # a new process for rank 1 (the launcher's respawn) re-admits it
        c1b = GangClient(coord.address, rank=1, world_size=2,
                         heartbeat_interval_s=0.1)
        c1b.connect().start_heartbeat()
        try:
            assert c0.wait_ready(timeout_s=5) is True
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and c0.degraded:
                time.sleep(0.02)
            assert not c0.degraded
            st = c0.status()
            assert st["ranks"]["1"]["deaths"] == 1
            assert st["ranks"]["1"]["joins"] == 2
        finally:
            c1b.close()
    finally:
        c0.close()
        c1.close()
        coord.stop()
    after = _totals()
    assert _delta(before, after, "paddle_tpu_gang_rank_deaths_total") == 1
    assert _delta(before, after, "paddle_tpu_gang_rejoins_total") == 1
    assert _delta(before, after, "paddle_tpu_gang_heartbeats_total") > 0


def test_barrier_refuses_on_dead_rank_instead_of_hanging():
    coord, (c0, c1) = _gang()
    try:
        c1.close(goodbye=False)         # rank 1 goes silent (SIGKILL)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not c0.degraded:
            time.sleep(0.02)
        # the survivor's barrier is REFUSED with the dead ranks named —
        # the alternative is a silent hang inside a collective
        with pytest.raises(GangDegradedError) as ei:
            c0.step_barrier(7, "fp", timeout_s=5)
        assert ei.value.dead == [1]
    finally:
        c0.close()
        coord.stop()


def test_clean_goodbye_is_a_departure_not_a_death():
    """A rank that finishes its steps and exits cleanly says goodbye:
    the gang must NOT degrade (its peers keep training; parking for a
    respawn that will never come is the bug this op exists to avoid)."""
    before = _totals()
    coord, (c0, c1) = _gang()
    try:
        c1.close()                      # orderly departure (goodbye)
        time.sleep(0.8)                 # > the 0.6 s heartbeat timeout
        assert not c0.degraded
        assert c0.dead_ranks == []
        st = c0.status()
        assert st["status"] == "ok"
        assert st["ranks"]["1"]["finished"] is True
        # the departed rank's peers never park: wait_ready is immediate
        assert c0.wait_ready(timeout_s=1.0) is True
    finally:
        c0.close()
        coord.stop()
    after = _totals()
    assert _delta(before, after, "paddle_tpu_gang_rank_deaths_total") == 0


def test_heartbeat_progress_never_satisfies_commit_barriers():
    """The manifest must commit only on DURABLE announcements: a rank's
    heartbeat carries the step it is TRAINING — exactly the step it has
    not saved — so letting it satisfy wait_commit/commit_latest would
    re-introduce the torn-save the gang protocol exists to refuse."""
    coord, (c0, c1) = _gang(timeout=30)
    try:
        c0.set_progress(step=8)
        c1.set_progress(step=8)
        deadline = time.monotonic() + 5     # heartbeats delivered
        while time.monotonic() < deadline:
            st = c0.status()["ranks"]
            if all(st.get(str(r), {}).get("cur_step") == 8
                   for r in (0, 1)):
                break
            time.sleep(0.02)
        # both ranks' hearts say 8, but only step 4 is durably announced
        c0.announce(4)
        c1.announce(4)
        assert c0.wait_commit(8, timeout_s=0.4) is False
        assert c0.committed_step() is None
        assert c0.commit_latest() == 4
        assert c0.wait_commit(4, timeout_s=1.0) is True
    finally:
        c0.close()
        c1.close()
        coord.stop()


def test_guard_goodbye_on_clean_exit_only():
    """The PreemptionGuard says goodbye on a CLEAN exit of the guarded
    block; an exception propagating through it must NOT — a crashed
    rank is a death the liveness plane should see (the launcher
    respawns it), not an orderly departure."""
    from paddle_tpu_torch.resilience import PreemptionGuard

    class FakeGang:
        goodbyes = 0

        def goodbye(self):
            self.goodbyes += 1

    g = FakeGang()
    with PreemptionGuard(gang=g, exit_on_preempt=False):
        pass
    assert g.goodbyes == 1
    g2 = FakeGang()
    with pytest.raises(ValueError):
        with PreemptionGuard(gang=g2, exit_on_preempt=False):
            raise ValueError("rank crashed")
    assert g2.goodbyes == 0


def test_announce_does_not_resurrect_a_departed_rank():
    """A departed rank's trailing announce (the daemon's final commit
    lands after the guard's goodbye) must update the durable record
    WITHOUT re-admitting the rank — only a hello does that."""
    coord, (c0, c1) = _gang(timeout=30)
    try:
        c1.announce(2)
        c1.goodbye()
        c1.announce(4)                   # trailing durable record
        st = c0.status()
        assert st["ranks"]["1"]["finished"] is True
        assert st["ranks"]["1"]["steps"] == [4]
        assert not c0.degraded
        c0.announce(4)
        assert c0.commit_latest() == 4   # the record still counts
    finally:
        c0.close()
        c1.close()
        coord.stop()


def test_rejoin_clears_stale_durable_record():
    """A respawned rank prunes its torn steps BEFORE re-announcing, so
    the coordinator must drop its pre-death announcement at the rejoin
    hello — a leader intersecting against the stale list could commit a
    manifest step the rank no longer holds on disk."""
    coord, (c0, c1) = _gang()
    try:
        c1.announce(6, steps=[2, 4, 6])
        c1.close(goodbye=False)             # SIGKILL
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not c0.degraded:
            time.sleep(0.02)
        # respawn: hello clears the stale record...
        c1b = GangClient(coord.address, rank=1, world_size=2,
                         heartbeat_interval_s=0.1)
        c1b.connect().start_heartbeat()
        try:
            c0.announce(6, steps=[2, 4, 6])
            # ...so the leader CANNOT commit 6 off the dead rank's list
            assert c0.commit_latest() is None
            # the respawned rank's post-prune re-announce re-enables it
            c1b.announce(4, steps=[2, 4])
            assert c0.commit_latest() == 4
        finally:
            c1b.close()
    finally:
        c0.close()
        coord.stop()


def test_barrier_refuses_immediately_on_departed_rank():
    """A peer that said goodbye can never arrive: the barrier must
    refuse NOW with the real reason, not stall the full timeout and
    mis-diagnose a slow rank."""
    coord, (c0, c1) = _gang(timeout=30)
    try:
        c1.close()                       # orderly departure
        t0 = time.monotonic()
        with pytest.raises(GangDegradedError, match="departed"):
            c0.step_barrier(3, "fp", timeout_s=30)
        assert time.monotonic() - t0 < 5
    finally:
        c0.close()
        coord.stop()


def test_coordinator_restart_same_object():
    coord = GangCoordinator(world_size=1, heartbeat_timeout_s=30).start()
    c = GangClient(coord.address, rank=0, world_size=1).connect()
    c.publish(3)
    c.close(goodbye=False)
    coord.stop()
    coord.start()                        # same object, same port
    c2 = GangClient(coord.address, rank=0, world_size=1).connect()
    try:
        assert c2.status()["ok"]
    finally:
        c2.close()
        coord.stop()


# ---------------------------------------------------------------------------
# collective-fingerprint exchange
# ---------------------------------------------------------------------------

def test_step_barrier_fingerprint_mismatch_names_both_ranks():
    before = _totals()
    coord, (c0, c1) = _gang()
    errs = {}

    def arrive(c, fp):
        try:
            c.step_barrier(3, fp, timeout_s=10)
        except Exception as e:       # noqa: BLE001 — recorded for assert
            errs[c.rank] = e
    try:
        t0 = threading.Thread(target=arrive, args=(c0, "sha1:aaaa"),
                              daemon=True)
        t0.start()
        time.sleep(0.15)             # rank 0 is parked at the barrier
        arrive(c1, "sha1:bbbb")
        t0.join(5)
        assert set(errs) == {0, 1}
        for e in errs.values():
            assert isinstance(e, GangFingerprintError)
            msg = str(e)
            assert "rank 0" in msg and "rank 1" in msg
            assert "sha1:aaaa" in msg and "sha1:bbbb" in msg
    finally:
        c0.close()
        c1.close()
        coord.stop()
    after = _totals()
    assert _delta(before, after,
                  "paddle_tpu_gang_fingerprint_mismatch_total") >= 1


def test_step_barrier_releases_on_matching_fingerprints():
    coord, (c0, c1) = _gang()
    try:
        done = []
        t = threading.Thread(
            target=lambda: done.append(c0.step_barrier(5, "sha1:same")),
            daemon=True)
        t.start()
        c1.step_barrier(5, "sha1:same", timeout_s=5)
        t.join(5)
        assert not t.is_alive()
        # a missing fingerprint (rank without collectives verified yet)
        # does not poison the comparison
        t = threading.Thread(
            target=lambda: done.append(c0.step_barrier(6, None)),
            daemon=True)
        t.start()
        c1.step_barrier(6, "sha1:same", timeout_s=5)
        t.join(5)
        assert not t.is_alive()
    finally:
        c0.close()
        c1.close()
        coord.stop()


def test_heartbeat_fingerprint_mismatch_latches_into_check():
    coord, (c0, c1) = _gang()
    try:
        c0.set_progress(step=1, fingerprint="sha1:aaaa")
        c1.set_progress(step=1, fingerprint="sha1:bbbb")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            try:
                c0.check()
            except GangFingerprintError:
                break
            time.sleep(0.02)
        with pytest.raises(GangFingerprintError, match="rank 0.*rank 1"):
            c0.check()
    finally:
        c0.close()
        c1.close()
        coord.stop()


# ---------------------------------------------------------------------------
# GangRendezvous protocol parity: file backend vs socket backend
# ---------------------------------------------------------------------------

@pytest.fixture(params=["file", "socket"])
def rendezvous_pair(request, tmp_path):
    """(g0, g1, cleanup) — the same two-rank rendezvous over either
    backend, so one test body asserts protocol parity."""
    if request.param == "file":
        g0 = GangRendezvous(str(tmp_path), rank=0, world_size=2)
        g1 = GangRendezvous(str(tmp_path), rank=1, world_size=2)
        yield g0, g1
        return
    coord = GangCoordinator(world_size=2, heartbeat_timeout_s=30).start()
    g0 = GangClient(coord.address, rank=0, world_size=2).connect()
    g1 = GangClient(coord.address, rank=1, world_size=2).connect()
    yield g0, g1
    g0.close()
    g1.close()
    coord.stop()


def test_rendezvous_protocol_parity(rendezvous_pair):
    """The exact sequence test_gang_rendezvous_announce_and_commit runs
    on the file backend must behave identically over the socket."""
    g0, g1 = rendezvous_pair
    assert g0.is_leader and not g1.is_leader
    assert g0.committed_step() is None
    g0.announce(4, steps=[2, 4])
    assert g0.commit_latest() is None            # rank 1 not announced
    g1.announce(4, steps=[4])
    assert g0.commit_latest() == 4
    assert g1.committed_step() == 4
    assert g0.commit_latest() is None            # no advance, no re-publish
    g0.announce(6, steps=[2, 4, 6])
    assert g0.commit_latest() is None            # rank 1 lacks 6
    g1.announce(6, steps=[4, 6])
    assert g0.commit_latest() == 6
    # blocking emergency barrier: strict equality on the latest step
    g1.announce(8, steps=[4, 6, 8])
    assert not g0.wait_commit(8, timeout_s=0.2)  # rank 0 itself is at 6
    g0.announce(8, steps=[6, 8])
    assert g0.wait_commit(8, timeout_s=2.0)
    assert g1.committed_step() == 8
    assert g1.wait_manifest(8, timeout_s=1.0)
    assert not g1.wait_manifest(9, timeout_s=0.2)
    anns = g0.peer_announcements()
    assert set(anns) == {0, 1}
    assert anns[1]["steps"] == [4, 6, 8]
    with pytest.raises(RuntimeError, match="only rank 0"):
        g1.publish(9)
    with pytest.raises(RuntimeError, match="leader"):
        g1.wait_commit(9, timeout_s=0.1)


def test_manifest_persists_across_coordinator_restart(tmp_path):
    """With manifest_dir set, a committed step survives a full
    coordinator (= launcher) restart — the same torn-save refusal a
    shared-FS manifest gives, without ranks needing the FS."""
    coord = GangCoordinator(world_size=2, heartbeat_timeout_s=30,
                            manifest_dir=str(tmp_path)).start()
    g0 = GangClient(coord.address, rank=0, world_size=2).connect()
    g0.publish(12)
    assert g0.committed_step() == 12
    g0.close()
    coord.stop()
    coord2 = GangCoordinator(world_size=2, heartbeat_timeout_s=30,
                             manifest_dir=str(tmp_path)).start()
    g0b = GangClient(coord2.address, rank=0, world_size=2).connect()
    try:
        assert g0b.committed_step() == 12
        # and the file is the SAME manifest the file backend writes
        file_gang = GangRendezvous(str(tmp_path), rank=0, world_size=2)
        assert file_gang.committed_step() == 12
    finally:
        g0b.close()
        coord2.stop()


def test_from_env_selects_backend(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    # no coord, no dir -> no gang
    monkeypatch.delenv("PADDLE_GANG_COORD", raising=False)
    monkeypatch.delenv("PADDLE_GANG_DIR", raising=False)
    assert GangRendezvous.from_env() is None
    # dir only -> file backend
    monkeypatch.setenv("PADDLE_GANG_DIR", str(tmp_path / "gang"))
    g = GangRendezvous.from_env()
    assert isinstance(g, GangRendezvous) and g.backend == "file"
    # coord env -> socket backend (heartbeat running)
    coord = GangCoordinator(world_size=2, heartbeat_timeout_s=30).start()
    monkeypatch.setenv("PADDLE_GANG_COORD", coord.address)
    try:
        g = GangRendezvous.from_env()
        assert isinstance(g, GangClient) and g.backend == "socket"
        assert g._hb_thread is not None and g._hb_thread.is_alive()
        g.close()
    finally:
        coord.stop()
    # unreachable coordinator -> ERROR, never a silent per-rank
    # fallback (one rank on the file plane while peers heartbeat reads
    # as a death and parks the whole gang)
    monkeypatch.setenv("PADDLE_GANG_COORD", "127.0.0.1:1")
    with pytest.raises(ConnectionError, match="refusing to silently"):
        GangRendezvous.from_env()
    # single-rank -> no gang regardless
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    assert GangRendezvous.from_env() is None


# ---------------------------------------------------------------------------
# elastic recovery end to end: SIGKILL a rank under the real launcher
# ---------------------------------------------------------------------------

def _losses(text):
    vals = {}
    for line in text.splitlines():
        if line.startswith("STEP "):
            _, i, _, v = line.split()
            vals[int(i)] = float(v)
    return vals


def _free_port_base():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_subblock_fingerprint_round_trips_through_heartbeat():
    """Acceptance: a while-body collective's block-path-stamped
    fingerprint rides the heartbeat exchange — the coordinator stores
    it per rank, and two ranks diverging ONLY inside the loop body
    latch a mismatch every client can see via check()."""
    from paddle_tpu_torch.framework.core import Program

    def body_prog(chained):
        prog = Program()
        blk = prog.global_block()
        acc = blk.create_var(name="hb_acc", shape=(4,), dtype="float32")
        cond = blk.create_var(name="hb_c", shape=(1,), dtype="bool")
        blk.append_op("fill_constant", outputs={"Out": [acc]},
                      attrs={"shape": [4], "dtype": "float32",
                             "value": 0.0})
        blk.append_op("fill_constant", outputs={"Out": [cond]},
                      attrs={"shape": [1], "dtype": "bool", "value": 1.0})
        sub = prog._create_block()
        sub.create_var(name="hb_a", shape=(4,), dtype="float32")
        sub.append_op("c_allreduce_sum", inputs={"X": ["hb_acc"]},
                      outputs={"Out": ["hb_a"]}, attrs={"ring_id": 0})
        if chained:
            sub.append_op("c_allreduce_max", inputs={"X": ["hb_a"]},
                          outputs={"Out": ["hb_acc"]},
                          attrs={"ring_id": 0})
        else:
            sub.append_op("assign", inputs={"X": ["hb_a"]},
                          outputs={"Out": ["hb_acc"]})
        prog._rollback()
        blk.append_op("while",
                      inputs={"Condition": ["hb_c"], "X": ["hb_acc"]},
                      outputs={"Out": ["hb_acc"]},
                      attrs={"sub_block": sub,
                             "carried_vars": ["hb_acc", "hb_c"],
                             "cond_var": "hb_c"})
        return prog

    from paddle_tpu_torch.analysis.verifier import collective_fingerprint
    fp0 = collective_fingerprint(body_prog(True))
    fp1 = collective_fingerprint(body_prog(False))
    assert fp0 and fp1 and fp0 != fp1     # body-only divergence visible
    coord = GangCoordinator(world_size=2, heartbeat_timeout_s=60).start()
    try:
        c0 = GangClient(coord.address, rank=0, world_size=2).connect()
        c1 = GangClient(coord.address, rank=1, world_size=2).connect()
        c0._rpc({"op": "heartbeat", "fingerprint": fp0})
        # round trip: the coordinator's status echoes the exact value
        st = c0.status()
        assert st["ranks"]["0"]["fingerprint"] == fp0
        c0.check()                        # single report: no mismatch
        c1._rpc({"op": "heartbeat", "fingerprint": fp1})
        resp = c0._rpc({"op": "heartbeat", "fingerprint": fp0})
        c0._absorb_view(resp)
        with pytest.raises(GangFingerprintError) as ei:
            c0.check()
        assert fp0[:8] in str(ei.value) or "rank 0" in str(ei.value)
        c0.close(goodbye=False)
        c1.close(goodbye=False)
    finally:
        coord.stop()


def test_step_barrier_repairs_after_elastic_respawn():
    """Barriers pair by server-side arrival order,
    and a rejoin resets every rank's sequence — a respawned rank whose
    local barrier count restarted must still pair with a survivor that
    kept counting (client step values are diagnostics only)."""
    coord = GangCoordinator(world_size=2, heartbeat_timeout_s=60).start()
    try:
        c0 = GangClient(coord.address, rank=0, world_size=2).connect()
        c1 = GangClient(coord.address, rank=1, world_size=2).connect()
        # a few pre-death barriers advance rank 0's server sequence
        for step in (1, 2):
            t = threading.Thread(
                target=lambda s=step: c1.step_barrier(s, "fp"),
                daemon=True)
            t.start()
            c0.step_barrier(step, "fp", timeout_s=10)
            t.join(timeout=10)
        # rank 1 dies (declared dead) and respawns with a FRESH local
        # barrier count
        with coord._cv:
            coord._ranks[1]["alive"] = False
            coord._ranks[1]["deaths"] += 1
        c1b = GangClient(coord.address, rank=1, world_size=2).connect()
        # survivor arrives with its CONTINUED count (step 3), respawn
        # with its restarted count (step 1): they must still pair
        done = []

        def respawned():
            c1b.step_barrier(1, "fp", timeout_s=15)
            done.append(True)

        t = threading.Thread(target=respawned, daemon=True)
        t.start()
        c0.step_barrier(3, "fp", timeout_s=15)   # would deadlock before
        t.join(timeout=15)
        assert done == [True]
        c0.close(goodbye=False)
        c1b.close(goodbye=False)
    finally:
        coord.stop()


# ---------------------------------------------------------------------------
# heartbeat metrics digests (the gang observability plane)
# ---------------------------------------------------------------------------

def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_digest_rides_heartbeat_into_status_and_rank_series():
    coord, (c0, c1) = _gang(timeout=30)
    try:
        c0.set_digest({"step_ms": 100.0, "mfu": 0.41, "queue": 2,
                       "inflight": 2})
        c1.set_digest({"step_ms": 160.0, "mfu": 0.30, "queue": 0,
                       "inflight": 1})
        c0.set_progress(step=12)
        c1.set_progress(step=9)

        def both_digests():
            ranks = c0.status()["ranks"]
            return ((ranks.get("0", {}).get("digest") or {})
                    .get("step_ms") == 100.0 and
                    (ranks.get("1", {}).get("digest") or {})
                    .get("step_ms") == 160.0)
        assert _wait_for(both_digests)
        st = c0.status()
        assert st["ranks"]["0"]["digest"]["mfu"] == 0.41
        # per-rank registry series on the coordinator host
        assert monitor.GANG_RANK_STEP_MS.value(rank="0") == 100.0
        assert monitor.GANG_RANK_STEP_MS.value(rank="1") == 160.0
        assert monitor.GANG_RANK_MFU.value(rank="1") == 0.30
        assert monitor.GANG_RANK_INFLIGHT.value(rank="0") == 2
        assert monitor.GANG_DIGEST_CTR.value(rank="0") >= 1
    finally:
        c0.close()
        c1.close()
        coord.stop()


def test_digest_key_disappearance_drops_rank_series():
    # a serving gauge frozen at its last value reads as live load to a
    # router doing least-loaded placement — when a live rank's digest
    # stops carrying a key (server stopped, or shed under the byte
    # cap), the coordinator must DROP that rank's series, not hold it
    coord, (c0, c1) = _gang(timeout=30)
    try:
        c0.set_digest({"step_ms": 100.0, "tps": 55.0, "slots": 3})
        assert _wait_for(
            lambda: monitor.GANG_RANK_TPS.value(rank="0") == 55.0
            and monitor.GANG_RANK_FREE_SLOTS.value(rank="0") == 3)
        c0.set_digest({"step_ms": 100.0})   # serving stopped

        def serving_series_gone():
            tps = monitor.REGISTRY.get("paddle_tpu_gang_rank_tokens_per_s")
            slots = monitor.REGISTRY.get(
                "paddle_tpu_gang_rank_free_decode_slots")
            return (not any(l.get("rank") == "0" for l, _ in tps.series())
                    and not any(l.get("rank") == "0"
                                for l, _ in slots.series()))
        assert _wait_for(serving_series_gone)
        # the training key the digest still carries stays published
        assert monitor.GANG_RANK_STEP_MS.value(rank="0") == 100.0
    finally:
        c0.close()
        c1.close()
        coord.stop()


def test_gang_skew_and_straggler_gauge_math():
    coord, (c0, c1) = _gang(timeout=30)
    try:
        c0.set_digest({"step_ms": 100.0})
        c1.set_digest({"step_ms": 160.0})
        c0.set_progress(step=12)
        c1.set_progress(step=9)
        # both ranks' digests + cur_steps must have landed before the
        # aggregates are meaningful (the beats arrive independently)
        assert _wait_for(
            lambda: monitor.GANG_RANK_STEP_MS.value(rank="0") == 100.0
            and monitor.GANG_RANK_STEP_MS.value(rank="1") == 160.0
            and monitor.GANG_STEP_TIME_SKEW_GAUGE.value() == 60.0
            and monitor.GANG_STEP_SKEW_GAUGE.value() == 3)
        # step skew = max-min cur_step over live ranks; straggler names
        # the slowest step-time estimate; time skew is its throughput form
        assert monitor.GANG_STRAGGLER_GAUGE.value() == 1
        assert monitor.GANG_STRAGGLER_MS_GAUGE.value() == 160.0
        # the straggler flips when the other rank slows down
        c1.set_digest({"step_ms": 50.0})
        assert _wait_for(
            lambda: monitor.GANG_STRAGGLER_GAUGE.value() == 0
            and monitor.GANG_STRAGGLER_MS_GAUGE.value() == 100.0)
    finally:
        c0.close()
        c1.close()
        coord.stop()


def test_digest_byte_cap_client_truncates_server_caps():
    # client side: capped_digest drops keys deterministically until the
    # serialized form fits
    big = {f"k{i:03d}": 1.0 for i in range(200)}
    capped = monitor.capped_digest(big)
    assert len(json.dumps(capped, sort_keys=True)) <= \
        monitor.DIGEST_MAX_BYTES
    assert capped and set(capped) < set(big)
    # server side: an OVERSIZED digest in a hand-rolled beat is CAPPED
    # with the same priority-ordered key dropping (counted) instead of
    # refused outright — the high-priority keys (step_ms, nanf) must
    # survive, the beat always refreshes liveness
    before = _totals()
    coord = GangCoordinator(world_size=1, heartbeat_timeout_s=30).start()
    try:
        s = socket.create_connection(
            ("127.0.0.1", coord.port), timeout=5)
        try:
            send_frame(s, {"op": "heartbeat", "rank": 0, "step": 7,
                           "digest": {"step_ms": 12.5, "nanf": 3,
                                      **{f"blob{i:03d}": 1.0
                                         for i in range(200)}}})
            resp = recv_frame(s)
            assert resp["ok"]
        finally:
            s.close()
        st = coord._ranks[0]
        assert st["digest"] is not None       # capped, not refused
        assert st["digest"]["step_ms"] == 12.5
        assert st["digest"]["nanf"] == 3
        assert len(json.dumps(st["digest"], sort_keys=True)) <= \
            monitor.DIGEST_MAX_BYTES
        assert st["cur_step"] == 7            # the beat still landed
        # the capped digest still feeds the per-rank gauges
        assert monitor.GANG_RANK_STEP_MS.value(rank="0") == 12.5
        assert monitor.GANG_RANK_NANF.value(rank="0") == 3
        after = _totals()
        assert _delta(before, after,
                      "paddle_tpu_gang_digest_oversize_total") == 1
    finally:
        coord.stop()


def test_digestless_old_client_beats_stay_compatible():
    """A beat WITHOUT the digest field (an old client) must work exactly
    as before: liveness refreshes, fingerprints exchange, no digest
    machinery fires."""
    before = _totals()
    coord = GangCoordinator(world_size=1, heartbeat_timeout_s=30).start()
    try:
        s = socket.create_connection(
            ("127.0.0.1", coord.port), timeout=5)
        try:
            send_frame(s, {"op": "heartbeat", "rank": 0, "step": 3,
                           "fingerprint": "fp"})
            resp = recv_frame(s)
            assert resp["ok"] and resp["status"] in ("ok", "forming")
        finally:
            s.close()
        e = coord._ranks[0]
        assert e["alive"] and e["cur_step"] == 3
        assert e["fingerprint"] == "fp"
        assert e["digest"] is None
        after = _totals()
        assert _delta(before, after,
                      "paddle_tpu_gang_digests_total") == 0
        assert _delta(before, after,
                      "paddle_tpu_gang_digest_oversize_total") == 0
    finally:
        coord.stop()


def test_dead_rank_digest_folds_into_retired_series():
    before = _totals()
    coord, (c0, c1) = _gang()                 # 0.6 s heartbeat timeout
    try:
        c0.set_digest({"step_ms": 100.0})
        c1.set_digest({"step_ms": 160.0})
        assert _wait_for(
            lambda: monitor.GANG_DIGEST_CTR.value(rank="1") >= 1)
        c1.close(goodbye=False)               # SIGKILL-style silence
        assert _wait_for(lambda: c0.degraded)
        # the liveness loop retires the dead rank's series within one
        # poll interval: gauges drop, the digest counter folds into
        # rank="retired" with process totals intact
        assert _wait_for(lambda: {"rank": "1"} not in [
            lbl for lbl, _ in monitor.GANG_RANK_STEP_MS.series()])
        assert monitor.GANG_DIGEST_CTR.value(rank="retired") >= 1
        # degraded-aware aggregates RESET with one live rank left: a
        # skew/straggler gauge frozen at its pre-death value would keep
        # an alert firing against the healthy survivor forever
        assert _wait_for(
            lambda: monitor.GANG_STRAGGLER_GAUGE.value() == -1)
        assert monitor.GANG_STEP_TIME_SKEW_GAUGE.value() == 0
        assert monitor.GANG_STEP_SKEW_GAUGE.value() == 0
        after = _totals()
        assert _delta(before, after,
                      "paddle_tpu_gang_digests_total") >= 2
    finally:
        c0.close()
        c1.close()
        coord.stop()


def test_gangtop_once_renders_table(tmp_path):
    coord, (c0, c1) = _gang(timeout=30)
    try:
        c0.set_digest({"step_ms": 100.0, "mfu": 0.41})
        c1.set_digest({"step_ms": 160.0, "mfu": 0.30})
        c0.set_progress(step=12)
        c1.set_progress(step=9)
        assert _wait_for(lambda: (c0.status()["ranks"].get("1", {})
                                  .get("digest") or {}).get("step_ms"))
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.tools.gangtop",
             "--coord", coord.address, "--once"],
            capture_output=True, text=True, timeout=120, env=env, cwd=repo)
        assert r.returncode == 0, r.stderr[-500:]
        assert "straggler" in r.stdout        # rank 1 flagged
        assert "step_skew=3" in r.stdout
        for token in ("RANK", "STEP_MS", "MFU%"):
            assert token in r.stdout
    finally:
        c0.close()
        c1.close()
        coord.stop()


def test_capped_digest_sheds_extras_before_step_ms():
    """The byte cap must shed unknown extras first and step_ms LAST —
    it is the input the whole straggler plane runs on."""
    big = {"step_ms": 123.0, "mfu": 0.4, "steps": 10}
    big.update({f"extra{i:03d}": 1.0 for i in range(200)})
    capped = monitor.capped_digest(big)
    assert len(json.dumps(capped, sort_keys=True)) <= \
        monitor.DIGEST_MAX_BYTES
    assert capped["step_ms"] == 123.0
    assert capped["mfu"] == 0.4
    # tiny cap: only the most important keys survive, step_ms last
    tiny = monitor.capped_digest(big, max_bytes=20)
    assert list(tiny) == ["step_ms"]


def test_digestless_beat_clears_stored_digest():
    """A rank whose executor retired stops producing digests; its beat
    then omits the field and the coordinator must CLEAR the stale one
    so skew/straggler math drops the rank."""
    coord = GangCoordinator(world_size=1, heartbeat_timeout_s=30).start()
    try:
        s = socket.create_connection(
            ("127.0.0.1", coord.port), timeout=5)
        try:
            send_frame(s, {"op": "heartbeat", "rank": 0,
                           "digest": {"step_ms": 99.0}})
            assert recv_frame(s)["ok"]
            assert coord._ranks[0]["digest"] == {"step_ms": 99.0}
            send_frame(s, {"op": "heartbeat", "rank": 0})  # no digest
            assert recv_frame(s)["ok"]
            assert coord._ranks[0]["digest"] is None
        finally:
            s.close()
    finally:
        coord.stop()


def test_status_aggregates_match_gauges():
    """The status payload carries the SAME aggregates the gauges
    publish (one computation — gangtop can never disagree with
    paddle_tpu_gang_straggler_rank)."""
    coord, (c0, c1) = _gang(timeout=30)
    try:
        c0.set_digest({"step_ms": 100.0})
        c1.set_digest({"step_ms": 160.0})
        c0.set_progress(step=12)
        c1.set_progress(step=9)

        # wait for the FULLY-converged state, not just the straggler
        # flag: rank 1's digest alone already names it straggler while
        # rank 0's step=12 beat may still be in flight under suite
        # load — sampling at that instant reads a stale step skew
        def _converged():
            agg = c0.status().get("aggregates") or {}
            return (agg.get("straggler") == 1
                    and agg.get("step_skew") == 3
                    and agg.get("straggler_step_ms") == 160.0
                    and agg.get("step_time_skew_ms") == 60.0)
        assert _wait_for(_converged, timeout=15.0)
        agg = c0.status()["aggregates"]
        assert monitor.GANG_STRAGGLER_GAUGE.value() == agg["straggler"]
        assert monitor.GANG_STEP_SKEW_GAUGE.value() == agg["step_skew"]
    finally:
        c0.close()
        c1.close()
        coord.stop()


# ---------------------------------------------------------------------------
# the two packages against each other: one wire protocol
# ---------------------------------------------------------------------------

_MASKED = ("age_s", "pid", "time")


def _mask(x):
    """A response with its clock- and process-dependent fields masked."""
    if isinstance(x, dict):
        return {k: "*" if k in _MASKED else _mask(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_mask(v) for v in x]
    return x


def _sequence(coord_cls, client_cls, tmp):
    """One request sequence (hello, heartbeat, announce, commit, publish,
    a released barrier, a fingerprint refusal, a departure, status) and
    every response or error it got."""
    coord = coord_cls(world_size=2, heartbeat_timeout_s=30,
                      manifest_dir=str(tmp)).start()
    out = []
    try:
        c0 = client_cls(coord.address, rank=0, world_size=2).connect()
        c1 = client_cls(coord.address, rank=1, world_size=2).connect()
        out.append(c0._rpc({"op": "heartbeat", "step": 3,
                            "fingerprint": "fpA"}))
        out.append(c1._rpc({"op": "heartbeat", "step": 2,
                            "fingerprint": "fpA"}))
        c0.announce(4, steps=[2, 4])
        out.append(c0.commit_latest())              # rank 1 not announced
        c1.announce(4, steps=[4])
        out.append(c0.commit_latest())
        out.append(c1.committed_step())
        c0.publish(6)
        out.append([c0.committed_step(), c1.wait_manifest(6, 1.0)])
        out.append(c0.peer_announcements())

        def barrier(client, step, fp, got):
            try:
                got.append(client.step_barrier(step, fp, timeout_s=10))
            except (GangFingerprintError, RefFingerprintError,
                    GangDegradedError, RefDegradedError) as e:
                got.append(f"{type(e).__name__}: {e}")

        for step, fps in ((1, ("fp", "fp")), (2, ("fpA", "fpB"))):
            got0, got1 = [], []
            t = threading.Thread(target=barrier,
                                 args=(c1, step, fps[1], got1))
            t.start()
            barrier(c0, step, fps[0], got0)
            t.join(timeout=15)
            out.append([got0, got1])
        c1.goodbye()
        out.append(_mask(c0.status()))
        c0.close(goodbye=False)
        c1.close(goodbye=False)
    finally:
        coord.stop()
    return out


def test_port_and_reference_interoperate_in_both_directions(tmp_path):
    """A port client against a reference coordinator and a reference
    client against a port coordinator get the same responses, and the
    same as either package against itself."""
    runs = {}
    for name, coord_cls, client_cls in (
            ("ref-port", RefCoordinator, GangClient),
            ("port-ref", GangCoordinator, RefClient),
            ("port-port", GangCoordinator, GangClient),
            ("ref-ref", RefCoordinator, RefClient)):
        d = tmp_path / name
        d.mkdir()
        runs[name] = _sequence(coord_cls, client_cls, d)
        assert open(d / "MANIFEST").read().startswith("COMMITTED 6\n")
    want = runs["ref-ref"]
    assert want[3] == 4 and want[5] == [6, True]
    assert want[7][0] == [None] and "fingerprint" in want[8][0][0].lower()
    for name, got in runs.items():
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True), name


def test_the_frame_codec_is_byte_equal_to_the_references():
    from paddle_tpu.distributed import coordinator as ref
    msg = {"op": "announce", "rank": 1, "steps": [2, 4], "x": "é" * 3}
    for send in (send_frame, ref.send_frame):
        a, b = socket.socketpair()
        try:
            send(a, msg)
            raw = b.recv(1 << 16)
        finally:
            a.close()
            b.close()
        assert raw == len(json.dumps(msg, sort_keys=True).encode()
                          ).to_bytes(4, "big") + \
            json.dumps(msg, sort_keys=True).encode()
