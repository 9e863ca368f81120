#!/usr/bin/env python
"""Comms-plane smoke: the gate for the collective-communication plane
(``paddle_tpu_torch/analysis/comms.py``; the port of
``tools/comms_smoke.py``)::

    python -m paddle_tpu_torch.tools.comms_smoke

Three gates, each fatal on failure:

(a) **bytes exactness**: a one-process ``GradAllReduce`` run over a dp
    mesh of 2 virtual ranks moves ``paddle_tpu_collective_bytes_total`` by
    the static comms plan's payload x steps exactly, and the verifier's
    stamp carries the plan's fingerprint;

(b) **straggler-wait decomposition**: 2 ranks under the port's launcher
    and its socket coordinator, training across the two processes, rank 1
    held at the ``collective.launch`` fault site every step: the fast
    rank's measured comm time is at least 80% straggler wait (the comm
    gate's timestamp exchange puts the stall in the peer's late arrival,
    not in the wire), the coordinator's net-of-wait straggler is rank 1,
    and gangtop's table carries the COMM / BW% columns without flagging
    the waiting rank COMM-BOUND;

(c) **no added host blocks**: the same loop with comms telemetry on and
    off counts the same host-block events (fetch materializations,
    throttle waits), and with no gang the wait reads 0.

Modes used by the script itself: ``--single-json`` (gates (a) and (c) in
one process, prints ``COMMS_SINGLE``) and ``--rank-child`` (one rank of
gate (b), the launcher's target).  Everything runs on the host.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

STEPS = 8
HANG_S = 0.25


def fail(msg):
    print(f"COMMS SMOKE FAILED: {msg}")
    sys.exit(1)


def _build_and_train(steps, nranks=2, telemetry=True):
    """Tiny GradAllReduce training loop over a dp mesh of ``nranks``
    ranks: virtual ranks in one process, or one a process after
    ``init_parallel_env``.  Returns (program, loss_name, executor, scope,
    per-step host-block deltas, losses)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.distributed.env import process_count
    from paddle_tpu_torch.distributed.transpiler import GradAllReduce
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                            scope_guard)
    from paddle_tpu_torch.parallel import make_mesh, set_mesh

    set_flags({"FLAGS_comms_telemetry": bool(telemetry)})
    set_mesh(make_mesh({"dp": nranks}, [torch.device("cpu")] * nranks))
    scope = Scope()
    ctx = scope_guard(scope)
    ctx.__enter__()
    pg = program_guard(Program(), Program())
    pg.__enter__()
    x = layers.data("x", shape=[8], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    h = layers.fc(x, size=16, act="tanh")
    pred = layers.fc(h, size=1)
    loss = layers.mean(layers.square_error_cost(pred, y))
    opt.SGDOptimizer(0.1).minimize(loss)
    eps = ",".join(f"127.0.0.1:{6170 + i}" for i in range(nranks))
    GradAllReduce().transpile(rank=0, endpoints=eps,
                              current_endpoint=eps.split(",")[0])
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program(), scope=scope, seed=3)
    rng = np.random.RandomState(5)
    xv = rng.rand(8, 8).astype(np.float32)
    yv = xv.sum(1, keepdims=True).astype(np.float32)
    if process_count() > 1:          # each process feeds its rank's rows
        xv, yv = xv[:8 // nranks], yv[:8 // nranks]
    s0 = exe.dispatch_stats()
    losses = []
    for _ in range(steps):
        lv, = exe.run(feed={"x": xv, "y": yv}, fetch_list=[loss.name],
                      scope=scope)
        losses.append(float(np.asarray(lv).mean()))
    s1 = exe.dispatch_stats()
    blocks = {k: s1[k] - s0[k]
              for k in ("fetch_materializations", "throttle_waits",
                        "materialize_block_us", "throttle_block_us",
                        "benchmark_sync_us")}
    return (pt.default_main_program(), loss.name, exe, scope, blocks,
            losses)


def single_json():
    """Gates (a) + (c) in one process over 2 virtual ranks."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.analysis import comms

    # OFF first: the plan is built here, so the ON loop below measures
    # steady-state dispatch only (FLAGS_comms_telemetry is not part of
    # the plan's key: one plan for both loops)
    prog, loss_name, exe, scope, blocks_off, _ = _build_and_train(
        STEPS, telemetry=False)
    b0 = monitor.counter_totals().get(
        "paddle_tpu_collective_bytes_total", 0)
    import numpy as np
    rng = np.random.RandomState(5)
    xv = rng.rand(8, 8).astype(np.float32)
    yv = xv.sum(1, keepdims=True).astype(np.float32)
    from paddle_tpu_torch.flags import set_flags
    set_flags({"FLAGS_comms_telemetry": True})
    s0 = exe.dispatch_stats()
    for _ in range(STEPS):
        exe.run(feed={"x": xv, "y": yv}, fetch_list=[loss_name],
                scope=scope)
    s1 = exe.dispatch_stats()
    blocks_on = {k: s1[k] - s0[k] for k in blocks_off}
    comms.MONITOR.drain()
    b1 = monitor.counter_totals().get(
        "paddle_tpu_collective_bytes_total", 0)

    # explicit verify: the plain-Program dispatch path only verifies
    # opportunistically (fusion candidates); the stamp contract is what
    # this gate checks, so run the verifier directly
    from paddle_tpu_torch.analysis import verifier
    verifier.verify_program(prog, [loss_name])
    va = prog._attrs.get("verify") or {}
    plan = comms.plan_comms(prog, [loss_name], batch_size=8, nranks=2)
    out = {
        "steps": STEPS,
        "plan": {
            "nranks": plan.nranks,
            "collectives": len(plan.collectives),
            "payload_bytes": plan.payload_bytes,
            "wire_bytes": plan.wire_bytes,
            "est_ms": plan.est_ms,
            "compute_ms": plan.compute_ms,
            "bound": plan.bound,
            "fingerprint": plan.fingerprint,
        },
        "verify_stamp": (va.get("comms") or {}).get("fingerprint"),
        "measured_bytes": b1 - b0,
        "expected_bytes": plan.payload_bytes * STEPS,
        "measured_comm_ms": float(monitor.REGISTRY.get(
            "paddle_tpu_comm_step_ms").value()),
        "measured_wait_ms": float(monitor.REGISTRY.get(
            "paddle_tpu_comm_wait_ms").value()),
        "bus_bw": float(monitor.REGISTRY.get(
            "paddle_tpu_collective_bus_bw").value()),
        "blocks_off": blocks_off,
        "blocks_on": blocks_on,
    }
    print("COMMS_SINGLE " + json.dumps(out), flush=True)


def rank_child():
    """One rank of the 2-rank straggler drill (the launcher's target):
    the dp mesh spans the two processes, so the collectives run across
    them; the comm gate's arrival skew, the heartbeat digests and the
    coordinator's straggler selection are what the drill gates."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.analysis import comms
    from paddle_tpu_torch.analysis.verifier import collective_fingerprint
    from paddle_tpu_torch.distributed.env import (Env, GangRendezvous,
                                                  init_parallel_env)
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.tools import gangtop

    env = init_parallel_env()
    rank = env.rank
    slow = int(os.environ.get("COMMS_SLOW_RANK", "-1"))
    if rank == slow:
        set_flags({"FLAGS_fault_inject":
                   f"collective.launch:every=1,hang={HANG_S}"})
    prog, loss_name, exe, scope, _blocks, losses = _build_and_train(
        STEPS, telemetry=True)
    gang = GangRendezvous.from_env()
    if gang is not None and hasattr(gang, "set_progress"):
        fp = collective_fingerprint(prog)
        if fp:
            gang.set_progress(step=STEPS, fingerprint=fp)
    comms.MONITOR.drain()
    comm_ms = float(monitor.REGISTRY.get(
        "paddle_tpu_comm_step_ms").value())
    wait_ms = float(monitor.REGISTRY.get(
        "paddle_tpu_comm_wait_ms").value())
    gates = {labels.get("outcome"): cell.get() for labels, cell in
             monitor.REGISTRY.get("paddle_tpu_comms_gate_total").series()}
    out = {"rank": rank, "steps": STEPS, "comm_ms": comm_ms,
           "wait_ms": wait_ms,
           "wait_frac": wait_ms / comm_ms if comm_ms > 0 else 0.0,
           "gates": gates, "losses_ok": losses[-1] < losses[0]}
    print("COMMS_RANK " + json.dumps(out), flush=True)
    # let a few digest-bearing heartbeats land, then rank 0 snapshots
    # the coordinator view.  Non-zero ranks park LONGER before their
    # goodbye: the straggler aggregate is computed over live ranks, so
    # the peer must still be heartbeating when rank 0 reads it.
    time.sleep(1.0 if rank == 0 else 6.0)
    if rank == 0:
        coord = os.environ.get("PADDLE_GANG_COORD", "")
        if coord:
            status = gangtop.fetch_status(coord)
            print("COMMS_STATUS " + json.dumps(status), flush=True)
            print("COMMS_TABLE_BEGIN", flush=True)
            print(gangtop.render(status), flush=True)
            print("COMMS_TABLE_END", flush=True)
    if gang is not None and hasattr(gang, "goodbye"):
        gang.goodbye()


def _spawn_single():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_GANG_COORD", "PADDLE_GANG_DIR",
              "FLAGS_fault_inject"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--single-json"],
        env=env, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"single-process child exited {r.returncode}:\n"
             f"{r.stdout}\n{r.stderr}")
    for line in r.stdout.splitlines():
        if line.startswith("COMMS_SINGLE "):
            return json.loads(line[len("COMMS_SINGLE "):])
    fail(f"no COMMS_SINGLE line in child output:\n{r.stdout}\n{r.stderr}")


def _run_drill():
    import socket as _socket
    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("PADDLE_GANG_COORD", "PADDLE_GANG_DIR",
              "FLAGS_fault_inject"):
        env.pop(k, None)
    env.update({
        "COMMS_SLOW_RANK": "1",
        "FLAGS_gang_heartbeat_interval_s": "0.15",
        "FLAGS_gang_heartbeat_timeout_s": "15",
    })
    import tempfile
    with tempfile.TemporaryDirectory(prefix="pt_comms_smoke_") as tmp:
        log_dir = os.path.join(tmp, "logs")
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "2", "--started_port", str(port),
             "--log_dir", log_dir,
             os.path.abspath(__file__), "--rank-child"],
            env=env, cwd=REPO, capture_output=True, text=True,
            timeout=420)
        out0 = out1 = ""
        try:
            out0 = open(os.path.join(log_dir, "worker.0.log")).read()
            out1 = open(os.path.join(log_dir, "worker.1.log")).read()
        except OSError:
            pass
        dbg = (f"launcher rc={r.returncode}\n--- stderr ---\n{r.stderr}"
               f"\n--- worker.0 ---\n{out0}\n--- worker.1 ---\n{out1}")
        if r.returncode != 0:
            fail(f"drill launcher did not exit 0\n{dbg}")
        recs = {}
        for line in (out0 + "\n" + out1).splitlines():
            if line.startswith("COMMS_RANK "):
                rec = json.loads(line[len("COMMS_RANK "):])
                recs[rec["rank"]] = rec
        status = None
        for line in out0.splitlines():
            if line.startswith("COMMS_STATUS "):
                status = json.loads(line[len("COMMS_STATUS "):])
        if sorted(recs) != [0, 1]:
            fail(f"missing COMMS_RANK records (got {sorted(recs)})\n{dbg}")
        if status is None:
            fail(f"rank 0 never captured the coordinator status\n{dbg}")
        return recs, status, out0, dbg


def _pin_threads():
    """Children pin torch's thread pools to 1 before building anything:
    the host's float32 sums then run in one order in every child."""
    import torch
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)


def main():
    if "--single-json" in sys.argv:
        _pin_threads()
        return single_json()
    if "--rank-child" in sys.argv:
        _pin_threads()
        return rank_child()

    # -- gates (a) + (c): single-process 2-virtual-device run ------------
    single = _spawn_single()
    if single["measured_bytes"] != single["expected_bytes"]:
        fail(f"gate (a): measured collective bytes "
             f"{single['measured_bytes']} != static plan x steps "
             f"{single['expected_bytes']} ({single})")
    if single["measured_bytes"] <= 0 or single["plan"]["collectives"] < 1:
        fail(f"gate (a): no collective traffic measured ({single})")
    if single["verify_stamp"] != single["plan"]["fingerprint"]:
        fail(f"gate (a): verify-stamped comms fingerprint "
             f"{single['verify_stamp']} != plan "
             f"{single['plan']['fingerprint']}")
    print(f"gate (a) OK: {single['measured_bytes']} B measured == "
          f"{single['plan']['payload_bytes']} B/step x "
          f"{single['steps']} steps; "
          f"{single['plan']['collectives']} collective(s), "
          f"{single['plan']['bound']}-bound, "
          f"bus_bw={single['bus_bw']:.2e}")

    on, off = single["blocks_on"], single["blocks_off"]
    for k in ("fetch_materializations", "throttle_waits"):
        if on[k] != off[k]:
            fail(f"gate (c): host-block event count {k} changed with "
                 f"comms telemetry on: {off[k]} -> {on[k]}")
    # single-process: no gang, so wait must read 0 (all local ranks
    # arrive together by construction)
    if single["measured_wait_ms"] != 0.0:
        fail(f"gate (c): single-process wait_ms should be 0, got "
             f"{single['measured_wait_ms']}")
    print(f"gate (c) OK: host-block events identical on/off "
          f"({ {k: on[k] for k in ('fetch_materializations', 'throttle_waits')} }), "
          f"wait=0 with no gang")

    # -- gate (b): 2-rank straggler drill --------------------------------
    recs, status, out0, dbg = _run_drill()
    fast = recs[0]
    if fast["wait_frac"] < 0.8:
        fail(f"gate (b): fast rank's wait fraction "
             f"{fast['wait_frac']:.3f} < 0.8 — the injected straggler "
             f"was not attributed to the wait bucket\n{dbg}")
    agg = status.get("aggregates") or {}
    if int(agg.get("straggler", -1)) != 1:
        fail(f"gate (b): coordinator straggler is "
             f"{agg.get('straggler')!r}, expected rank 1 (net-of-wait "
             f"selection)\n{dbg}")
    d0 = (status["ranks"].get("0") or {}).get("digest") or {}
    if not isinstance(d0.get("comm_ms"), (int, float)) or \
            not isinstance(d0.get("comm_wait"), (int, float)):
        fail(f"gate (b): rank 0 digest lacks comm_ms/comm_wait keys: "
             f"{d0}\n{dbg}")
    if "COMMS_TABLE_BEGIN" not in out0 or "COMM" not in out0 \
            or "BW%" not in out0:
        fail(f"gate (b): gangtop table missing COMM/BW% columns\n{dbg}")
    table = out0.split("COMMS_TABLE_BEGIN", 1)[1]
    rank0_row = next((ln for ln in table.splitlines()
                      if ln.strip().startswith("0 ")), "")
    if "COMM-BOUND" in rank0_row:
        fail(f"gate (b): the WAITING rank was flagged COMM-BOUND — the "
             f"flag must be straggler-consistent\n{dbg}")
    print(f"gate (b) OK: fast-rank wait fraction "
          f"{fast['wait_frac']:.2f} (wait {fast['wait_ms']:.1f} ms of "
          f"{fast['comm_ms']:.1f} ms comm), straggler=rank 1, "
          f"COMM/BW% columns rendered, no COMM-BOUND on the victim")
    print("comms smoke OK")


if __name__ == "__main__":
    main()
