"""Gang checkpoints, elastic respawn and the executor's gang hooks in the
port, on the CPU.

- the ``COMMITTED`` manifest round trip, byte-equal to the reference's
  ``format_manifest`` apart from its time; the file ``GangRendezvous``'s
  announce / commit sequence giving the reference's answers;
- ``resume_or_init`` under a gang: a step newer than the manifest is a
  torn save, pruned and refused, and the committed step restored bit for
  bit; no manifest at all cold-starts (ref ``tests/test_resilience.py:
  927-1040``);
- the kill-mid-emergency-save drill (ref :1039-1176) and the elastic kill
  -9 drill through the port's launcher (ref ``tests/test_coordinator.py:
  526-640``), both with ``paddle_tpu_torch/tools/gang_runner.py``: loss
  trajectories equal an uninterrupted child's bit for bit;
- the executor's ``FLAGS_gang_step_barrier`` (ref ``tests/
  test_coordinator.py:643-736``): a fingerprint mismatch refuses the step
  before dispatch, matching fingerprints release it, the flag off makes
  no round trip;
- the comm gate (ref ``tests/test_comms.py:223-307``): the coordinator's
  timestamp exchange, a partial view on a departed peer, the straggler
  net of comm wait, and the executor's gate, which never fails a step;
- a dead rank ends the barrier, the commit and the manifest wait within
  their timeouts, never in a hang.

Every subprocess pins torch's thread pools to 1 (the runners do), so
children are held to each other bit for bit.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu.distributed import env as ref_env
from paddle_tpu_torch import flags, layers, monitor
from paddle_tpu_torch import resilience as res
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.distributed.coordinator import (GangClient,
                                                      GangCoordinator,
                                                      GangDegradedError,
                                                      GangFingerprintError)
from paddle_tpu_torch.distributed.env import GangRendezvous
from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                        scope_guard, unique_name)
from paddle_tpu_torch.parallel import make_mesh, set_mesh
from paddle_tpu_torch.tools import gang_smoke
from _port_fixtures import collect_garbage_after_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = gang_smoke.RUNNER
CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("PADDLE_GANG_COORD", "PADDLE_GANG_DIR", "PADDLE_TRAINER_ID",
              "PADDLE_TRAINERS_NUM"):
        monkeypatch.delenv(k, raising=False)
    with unique_name.guard():
        yield
    set_mesh(None)
    flags.set_flags({"FLAGS_gang_step_barrier": False})


def _totals():
    return monitor.counter_totals()


def _delta(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


def _losses(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("STEP "):
            _, i, _, v = line.split()
            out[int(i)] = v
    return out


# ---------------------------------------------------------------------------
# the manifest and the file rendezvous
# ---------------------------------------------------------------------------

def test_manifest_format_round_trip_and_rejects_garbage():
    body, ref = env.format_manifest(17, 4), ref_env.format_manifest(17, 4)
    assert env.parse_manifest(body) == ref_env.parse_manifest(body) == 17
    mask = re.compile(r'"time": "[^"]*"')
    assert mask.sub("T", body) == mask.sub("T", ref)
    assert body.splitlines()[0] == "COMMITTED 17"
    assert env.parse_manifest("COMMITTED 0\n") == 0
    for bad in ("", "COMMITTED", "COMMITTED x", "COMITTED 3",
                "COMMITTED 3 4", "COMMITTED -1", "step 3"):
        with pytest.raises(ValueError):
            env.parse_manifest(bad)
        with pytest.raises(ValueError):
            ref_env.parse_manifest(bad)


def _announce_and_commit(mod, d):
    g0 = mod.GangRendezvous(str(d), rank=0, world_size=2)
    g1 = mod.GangRendezvous(str(d), rank=1, world_size=2)
    out = [g0.is_leader, g1.is_leader, g0.committed_step()]
    g0.announce(4, steps=[2, 4])
    out.append(g0.commit_latest())
    g1.announce(4, steps=[4])
    out += [g0.commit_latest(), g1.committed_step(), g0.commit_latest()]
    g0.announce(6, steps=[2, 4, 6])
    out.append(g0.commit_latest())
    g1.announce(6, steps=[4, 6])
    out.append(g0.commit_latest())
    g1.announce(8, steps=[4, 6, 8])
    out.append(g0.wait_commit(8, timeout_s=0.2))
    g0.announce(8, steps=[6, 8])
    out += [g0.wait_commit(8, timeout_s=0.2), g1.committed_step(),
            g0.peer_announcements()]
    with pytest.raises(RuntimeError):
        g1.publish(9)
    with open(g0.manifest_path, "w") as f:
        f.write("garbage\n")
    with pytest.warns(UserWarning, match="corrupt"):
        out.append(g0.committed_step())
    return out


def test_gang_rendezvous_announce_and_commit(tmp_path):
    got = _announce_and_commit(env, tmp_path / "port")
    want = _announce_and_commit(ref_env, tmp_path / "ref")
    assert got == want
    assert got[:10] == [True, False, None, None, 4, 4, None, None, 6, False]
    # each rank's announcement file is the reference's but for the pid
    a = open(tmp_path / "port" / "rank_1").read()
    b = open(tmp_path / "ref" / "rank_1").read()
    assert re.sub(r'"pid": \d+', "", a) == re.sub(r'"pid": \d+', "", b)


def _tiny_regression(tmp_path):
    x = layers.data("x", shape=[4], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    pred = layers.fc(x, size=1, param_attr=ptt.ParamAttr(name="tr_w"))
    loss = layers.mean(layers.square_error_cost(pred, y))
    ptt.optimizer.SGD(0.1).minimize(loss)
    return loss


def test_resume_or_init_refuses_torn_checkpoint(tmp_path):
    """Checkpoints newer than the gang manifest are pruned and the
    committed step restored bit for bit; with no manifest at all the run
    cold-starts (its first save is not refused by a stale latest)."""
    before = _totals()
    with program_guard(Program(), Program()), scope_guard(Scope()):
        loss = _tiny_regression(tmp_path)
        exe = ptt.Executor(CPU)
        exe.run(ptt.default_startup_program())
        ckpt = CheckpointManager(str(tmp_path / "run"), max_to_keep=10)
        rng = np.random.RandomState(0)
        committed_w = None
        for step in range(1, 5):
            xv = rng.rand(4, 4).astype(np.float32)
            exe.run(feed={"x": xv, "y": xv.sum(1, keepdims=True)},
                    fetch_list=[loss])
            ckpt.save(step, force=True)
            if step == 2:
                ckpt.wait_until_finished()
                committed_w = np.asarray(
                    ptt.global_scope().find_var("tr_w")).copy()
        ckpt.commit()
        gang = GangRendezvous(str(tmp_path / "gang"), rank=0, world_size=2)
        gang.publish(2)
        with pytest.warns(UserWarning, match="torn"):
            start = res.resume_or_init(
                ckpt, exe, main_program=ptt.default_main_program(),
                gang=gang)
        assert start == 2
        assert ckpt.all_steps() == [1, 2]
        np.testing.assert_array_equal(
            np.asarray(ptt.global_scope().find_var("tr_w")), committed_w)
        assert gang.peer_announcements()[0]["steps"] == [1, 2]
        assert ckpt.save(3, force=True)
        ckpt.commit()
        gang2 = GangRendezvous(str(tmp_path / "gang2"), rank=0,
                               world_size=2)
        with pytest.warns(UserWarning, match="no gang COMMITTED"):
            assert res.resume_or_init(
                ckpt, exe, main_program=ptt.default_main_program(),
                gang=gang2) == 0
        assert ckpt.all_steps() == []
        assert ckpt.save(1, force=True)
        ckpt.close()
    after = _totals()
    assert _delta(before, after,
                  "paddle_tpu_checkpoint_torn_rejects_total") == 2


def test_daemon_announces_and_the_leader_commits(tmp_path):
    """The daemon announces each durable save; the leader publishes the
    newest step every rank holds (here one rank of a world of one)."""
    with program_guard(Program(), Program()), scope_guard(Scope()):
        loss = _tiny_regression(tmp_path)
        exe = ptt.Executor(CPU)
        exe.run(ptt.default_startup_program())
        ckpt = CheckpointManager(str(tmp_path / "c"), max_to_keep=10)
        gang = GangRendezvous(str(tmp_path / "g"), rank=0, world_size=1)
        daemon = res.CheckpointDaemon(ckpt, interval_steps=2,
                                      interval_secs=0, gang=gang).start()
        xv = np.ones((4, 4), np.float32)
        for step in range(4):
            exe.run(feed={"x": xv, "y": xv.sum(1, keepdims=True)},
                    fetch_list=[loss])
            daemon.step_completed(step + 1)
            if step in (1, 3):
                assert daemon.wait_committed(step + 1)
        daemon.stop()
        ckpt.close()
    assert gang.committed_step() == 4
    assert gang.peer_announcements()[0]["steps"] == [2, 4]


# ---------------------------------------------------------------------------
# the drills through subprocesses
# ---------------------------------------------------------------------------

def test_gang_kill_one_rank_mid_emergency_save_rejects_torn_step(
        tmp_path):
    """Two file-backend ranks train under gang daemons; both get SIGTERM
    and rank 1 is SIGKILLed inside its (hanging) emergency save.  The
    manifest stays at the last step the whole gang committed; a rerun
    resumes both ranks there, refuses rank 0's newer emergency save, and
    reproduces the uninterrupted losses bit for bit."""
    total = 30
    gang_dir = tmp_path / "gang"
    base_env = gang_smoke.gang_env()

    def rank_env(rank, **extra):
        e = dict(base_env)
        e.update({"PADDLE_TRAINER_ID": str(rank),
                  "PADDLE_TRAINERS_NUM": "2",
                  "PADDLE_GANG_DIR": str(gang_dir),
                  "GANG_CKPT_INTERVAL": "2" if rank == 0 else "4",
                  # both ranks stop only at steps that are not multiples
                  # of 4: the emergency step is then not one rank 1's
                  # cadence announced
                  "GANG_AVOID_MULTIPLE": "4",
                  "FLAGS_gang_commit_timeout_s": "3"})
        e.update(extra)
        return e

    base = subprocess.Popen(
        [sys.executable, RUNNER, str(tmp_path / "base_ckpt"), str(total),
         str(tmp_path / "pb")], env=dict(base_env, PADDLE_TRAINERS_NUM="1"),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    ckpt_root = tmp_path / "ckpt"
    progress = [tmp_path / "p0.r0", tmp_path / "p1.r1"]
    procs = [subprocess.Popen(
        [sys.executable, RUNNER, str(ckpt_root), str(total),
         str(tmp_path / f"p{r}"), "0.12"],
        env=rank_env(r, **({"GANG_EMERGENCY_HANG": "1"} if r else {})),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]
    gang = GangRendezvous(str(gang_dir), rank=0, world_size=2)
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline:
        done = [len(p.read_text().splitlines()) if p.exists() else 0
                for p in progress]
        if min(done) >= 8 and gang.committed_step() is not None:
            break
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.05)
    assert all(p.poll() is None for p in procs), \
        "a rank finished before it was preempted"
    for p in procs:
        p.send_signal(signal.SIGTERM)
    time.sleep(1.5)               # rank 1 now hangs in its emergency save
    procs[1].kill()
    out0 = procs[0].communicate(timeout=180)[0]
    procs[1].communicate(timeout=60)
    assert procs[0].returncode == 0, out0[-3000:]
    assert procs[1].returncode == -signal.SIGKILL
    part0 = _losses(out0)
    k0 = len(part0)
    assert 0 < k0 < total
    committed = gang.committed_step()
    assert committed is not None and committed % 4 == 0 and committed < k0
    resumed, resumed_at = [], []
    for rank in range(2):
        expect = gang.committed_step()
        r = subprocess.run(
            [sys.executable, RUNNER, str(ckpt_root), str(total),
             str(tmp_path / f"pr{rank}")], env=rank_env(rank), cwd=REPO,
            capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        at = int(re.search(r"RESUMED_AT (\d+)", r.stdout).group(1))
        assert at == expect
        resumed.append(r.stdout)
        resumed_at.append(at)
    assert resumed_at[0] == committed
    assert int(re.search(r"TORN_REJECTS (\d+)", resumed[0]).group(1)) == 1
    want = _losses(base.communicate(timeout=300)[0])
    assert sorted(want) == list(range(total))
    combined = dict(part0)
    combined.update(_losses(resumed[0]))
    assert [combined[i] for i in range(total)] == \
        [want[i] for i in range(total)]
    tail = _losses(resumed[1])
    assert [tail[i] for i in range(resumed_at[1], total)] == \
        [want[i] for i in range(resumed_at[1], total)]


def test_elastic_rank_kill9_respawn_exact_loss_parity():
    """Through the port's launcher: rank 1 SIGKILLs itself, the
    coordinator the launcher hosts declares it dead, rank 0 drains and
    parks, ``--max_restarts`` respawns rank 1 from the gang manifest, and
    both ranks' losses equal an uninterrupted child's bit for bit."""
    out = gang_smoke.drill("linreg", cpu=True, total=16, kill_step=5)
    assert 0 < out["resumed_at"] <= 5
    assert out["rank1"][-1]["start"] == out["resumed_at"]
    assert len(out["losses"]) == 16


# ---------------------------------------------------------------------------
# the executor's step barrier (FLAGS_gang_step_barrier)
# ---------------------------------------------------------------------------

def _collective_barrier_prog():
    prog = Program()
    blk = prog.global_block()
    x = blk.create_var(name="gsb_x", shape=(-1, 4), dtype="float32")
    x.is_data = True
    blk.create_var(name="gsb_out", shape=(-1, 4), dtype="float32")
    blk.append_op("c_allreduce_sum", inputs={"X": ["gsb_x"]},
                  outputs={"Out": ["gsb_out"]}, attrs={"ring_id": 0})
    prog._attrs["collective"] = {"nranks": 1, "rank": 0}
    set_mesh(make_mesh({"dp": 1}, [CPU.device]))
    return prog


def _barrier_env(monkeypatch, coord):
    monkeypatch.setenv("PADDLE_GANG_COORD", coord.address)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.delenv("PADDLE_GANG_DIR", raising=False)
    flags.set_flags({"FLAGS_gang_step_barrier": True,
                     "FLAGS_gang_step_barrier_timeout_s": 30.0})


def test_executor_step_barrier_refuses_mismatch_before_dispatch(
        monkeypatch):
    coord = GangCoordinator(world_size=2, heartbeat_timeout_s=60).start()
    try:
        _barrier_env(monkeypatch, coord)
        prog = _collective_barrier_prog()
        exe = ptt.Executor(CPU)
        peer = GangClient(coord.address, rank=1, world_size=2).connect()
        peer_err = []

        def rank1():
            try:
                peer.step_barrier(1, "sha1:divergent-peer", timeout_s=30)
            except GangFingerprintError as e:
                peer_err.append(e)

        t = threading.Thread(target=rank1, daemon=True)
        t.start()
        before = exe.dispatch_stats()["steps_dispatched"]
        with pytest.raises(GangFingerprintError) as ei:
            exe.run(prog, feed={"gsb_x": np.ones((2, 4), np.float32)},
                    fetch_list=["gsb_out"])
        t.join(timeout=30)
        assert "rank 0" in str(ei.value) and "rank 1" in str(ei.value)
        assert exe.dispatch_stats()["steps_dispatched"] == before
        assert peer_err
        peer.close(goodbye=False)
        exe._gang.close(goodbye=False)
    finally:
        coord.stop()


def test_executor_step_barrier_releases_on_matching_fingerprints(
        monkeypatch):
    from paddle_tpu_torch.analysis.verifier import collective_fingerprint
    coord = GangCoordinator(world_size=2, heartbeat_timeout_s=60).start()
    try:
        _barrier_env(monkeypatch, coord)
        prog = _collective_barrier_prog()
        exe = ptt.Executor(CPU)
        peer = GangClient(coord.address, rank=1, world_size=2).connect()
        done = []
        feed = {"gsb_x": np.ones((2, 4), np.float32)}
        fp = collective_fingerprint(prog)
        assert fp

        def rank1():
            for step in (1, 2):
                peer.step_barrier(step, fp, timeout_s=30)
                done.append(step)

        t = threading.Thread(target=rank1, daemon=True)
        t.start()
        fam = monitor.REGISTRY.get("paddle_tpu_collective_launches_total")
        before = fam.value(kind="step_barrier")
        for _ in range(2):
            out, = exe.run(prog, feed=feed, fetch_list=["gsb_out"])
            np.testing.assert_array_equal(np.asarray(out).reshape(2, 4),
                                          feed["gsb_x"])
        t.join(timeout=30)
        assert done == [1, 2]
        assert fam.value(kind="step_barrier") - before == 2
        peer.close(goodbye=False)
        exe._gang.close(goodbye=False)
    finally:
        coord.stop()


def test_step_barrier_flag_off_no_coordinator_roundtrip():
    prog = _collective_barrier_prog()
    exe = ptt.Executor(CPU)
    fam = monitor.REGISTRY.get("paddle_tpu_collective_launches_total")
    before = fam.value(kind="step_barrier")
    exe.run(prog, feed={"gsb_x": np.ones((2, 4), np.float32)},
            fetch_list=["gsb_out"])
    assert fam.value(kind="step_barrier") == before
    assert exe._gang is None            # resolved once: no gang here


# ---------------------------------------------------------------------------
# a dead rank ends every wait
# ---------------------------------------------------------------------------

def test_barrier_commit_and_manifest_waits_end_on_a_dead_rank():
    coord = GangCoordinator(world_size=2, heartbeat_timeout_s=0.6).start()
    c0 = GangClient(coord.address, rank=0, world_size=2,
                    heartbeat_interval_s=0.1).connect().start_heartbeat()
    c1 = GangClient(coord.address, rank=1, world_size=2,
                    heartbeat_interval_s=0.1).connect().start_heartbeat()
    try:
        c1.close(goodbye=False)                  # silent: a SIGKILL
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not c0.degraded:
            time.sleep(0.02)
        assert c0.degraded and c0.dead_ranks == [1]
        t0 = time.monotonic()
        with pytest.raises(GangDegradedError):
            c0.step_barrier(1, "fp", timeout_s=5)
        c0.announce(2, steps=[2])
        assert c0.wait_commit(2, timeout_s=1.0) is False
        assert c0.wait_manifest(2, timeout_s=0.5) is False
        assert c0.wait_ready(timeout_s=0.3) is False
        assert time.monotonic() - t0 < 8
    finally:
        c0.close(goodbye=False)
        coord.stop()


# ---------------------------------------------------------------------------
# the comm gate
# ---------------------------------------------------------------------------

def test_comm_gate_measures_peer_arrival_skew():
    coord = GangCoordinator(world_size=2, heartbeat_timeout_s=30).start()
    c0 = GangClient(coord.address, rank=0, world_size=2).connect()
    c1 = GangClient(coord.address, rank=1, world_size=2).connect()
    try:
        out = {}

        def late_rank():
            time.sleep(0.2)
            out[1] = c1.comm_gate(time.time(), timeout_s=10)

        t = threading.Thread(target=late_rank)
        t0 = time.time()
        t.start()
        out[0] = c0.comm_gate(t0, timeout_s=10)
        t.join()
        for r in (0, 1):
            assert out[r]["released"] is True
            assert set(out[r]["ts"]) == {"0", "1"}
        assert 0.1 < out[0]["ts"]["1"] - out[0]["ts"]["0"] < 5.0

        def next_gate():
            out["n1"] = c1.comm_gate(time.time(), timeout_s=10)
        t2 = threading.Thread(target=next_gate)
        t2.start()
        out["n0"] = c0.comm_gate(time.time(), timeout_s=10)
        t2.join()
        assert out["n0"]["released"] and out["n1"]["released"]
    finally:
        c0.close(goodbye=False)
        c1.close(goodbye=False)
        coord.stop()


def test_comm_gate_partial_on_departed_peer_not_a_hang():
    coord = GangCoordinator(world_size=2, heartbeat_timeout_s=30).start()
    c0 = GangClient(coord.address, rank=0, world_size=2).connect()
    c1 = GangClient(coord.address, rank=1, world_size=2).connect()
    try:
        c1.goodbye()
        t0 = time.monotonic()
        resp = c0.comm_gate(time.time(), timeout_s=30)
        assert time.monotonic() - t0 < 5.0
        assert resp["released"] is False
        assert set(resp["ts"]) == {"0"}
    finally:
        c0.close(goodbye=False)
        c1.close(goodbye=False)
        coord.stop()


def test_straggler_selection_is_net_of_comm_wait():
    coord = GangCoordinator(world_size=2, heartbeat_timeout_s=30).start()
    c0 = GangClient(coord.address, rank=0, world_size=2,
                    heartbeat_interval_s=0.05).connect()
    c1 = GangClient(coord.address, rank=1, world_size=2,
                    heartbeat_interval_s=0.05).connect()
    try:
        c0.set_digest({"step_ms": 300.0, "comm_ms": 260.0,
                       "comm_wait": 250.0, "comm_bw": 0.1})
        c1.set_digest({"step_ms": 290.0, "comm_ms": 10.0,
                       "comm_wait": 0.0, "comm_bw": 0.1})
        c0.start_heartbeat()
        c1.start_heartbeat()
        deadline = time.monotonic() + 5
        agg = {}
        while time.monotonic() < deadline:
            agg = c0.status().get("aggregates") or {}
            if agg.get("straggler") == 1:
                break
            time.sleep(0.05)
        assert agg.get("straggler") == 1, agg
        assert agg.get("straggler_net_ms") == 290.0
        fam = monitor.REGISTRY.get("paddle_tpu_gang_rank_comm_ms")
        vals = {lbl["rank"]: cell.get() for lbl, cell in fam.series()}
        assert vals.get("0") == 260.0 and vals.get("1") == 10.0
    finally:
        c0.close()
        c1.close()
        coord.stop()


def test_executor_comm_gate_is_telemetry_that_never_fails_a_step(
        monkeypatch):
    """The executor's gate posts each collective step's arrival and reads
    the peers' (a released gate with a peer, ``paddle_tpu_comms_gate_
    total{outcome}``); with the coordinator gone the steps still run, and
    after 3 failures the gate disarms itself."""
    from paddle_tpu_torch.analysis import comms
    coord = GangCoordinator(world_size=2, heartbeat_timeout_s=60).start()
    monkeypatch.setenv("PADDLE_GANG_COORD", coord.address)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    flags.set_flags({"FLAGS_comms_gate_timeout_s": 5.0})
    prog = _collective_barrier_prog()
    exe = ptt.Executor(CPU)
    feed = {"gsb_x": np.ones((2, 4), np.float32)}
    peer = GangClient(coord.address, rank=1, world_size=2).connect()
    gate = comms.COMMS_GATE_CTR
    try:
        exe.run(prog, feed=feed, fetch_list=["gsb_out"])   # plans, gates
        before = gate.value(outcome="released")
        t = threading.Thread(
            target=lambda: peer.comm_gate(time.time(), timeout_s=10))
        t.start()
        exe.run(prog, feed=feed, fetch_list=["gsb_out"])
        t.join(timeout=10)
        assert gate.value(outcome="released") == before + 1
        peer.close(goodbye=False)
        exe._gang.close(goodbye=False)
        coord.stop()
        off = gate.value(outcome="disabled")
        for _ in range(4):                 # every step still runs
            out, = exe.run(prog, feed=feed, fetch_list=["gsb_out"])
            np.testing.assert_array_equal(np.asarray(out).reshape(2, 4),
                                          feed["gsb_x"])
        assert exe._comm_gate_off and gate.value(outcome="disabled") > off
    finally:
        flags.set_flags({"FLAGS_comms_gate_timeout_s": 10.0})
        coord.stop()
