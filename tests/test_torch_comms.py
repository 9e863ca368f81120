"""The comms plane in the port (``analysis/comms.py``) against the JAX
package's, on the CPU: the tests of ``tests/test_comms.py`` that need no
gang coordinator, client, PS or gangtop, over the port's collective mode on
a ``dp`` mesh of two virtual ranks.

- the static plan: payload bytes, the ring algorithm-bandwidth model, the
  comm-vs-compute verdict, fingerprints that agree across two builds and
  differ with the payload or nranks; no plan without collectives;
- the verifier stamps the plan and folds its fingerprint into the
  collective fingerprint;
- the runtime path: the byte counter's delta is the plan's payload x steps
  exactly, the comms monitor publishes ``comm_step_ms`` > 0 and
  ``comm_wait`` 0 (no gang), a ``collective.launch`` span carries
  ``{signature, bytes, wait_ms, step_id}``, the digest carries
  ``comm_ms`` / ``comm_wait`` / ``comm_bw``; ``FLAGS_comms_telemetry``
  off counts nothing;
- ``paddle_tpu_torch/tools/comms_smoke.py`` (the reference's CI gate,
  ported): bytes exact, no added host blocks, and across two processes
  under the launcher a straggler held at ``collective.launch`` shows as
  the fast rank's wait (>= 80% of its comm time), the coordinator names
  it the straggler, and gangtop's COMM / BW% columns render;
- parity: ``plan_comms`` of the same program built in both packages gives
  the same ``(op, ring_id, dtype, shape, payload_bytes, wire_bytes)`` list
  and the same ``comm_frac`` and ``bound`` (both packages' host peaks are
  the reference's nominal 1e12 FLOP/s and 1e10 B/s).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import layers as ref_layers
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.analysis import comms as ref_comms
from paddle_tpu.distributed.transpiler import GradAllReduce as RefGAR
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu_torch import flags, layers, monitor
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.analysis import comms, verifier
from paddle_tpu_torch.distributed import GradAllReduce
from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                        unique_name)
from paddle_tpu_torch.parallel import make_mesh, set_mesh
from _port_fixtures import collect_garbage_after_module  # noqa: F401


@pytest.fixture(autouse=True)
def _no_mesh_after():
    yield
    set_mesh(None)
    flags.set_flags({"FLAGS_comms_telemetry": True})


def _build_dp_program(nranks=2, hidden=16, port=True):
    """The reference test's GradAllReduce program (``test_comms.py:29``),
    built under its own names so two calls mint identical programs."""
    L, O, G, names, P, guard = (
        (layers, opt, GradAllReduce, unique_name, Program, program_guard)
        if port else (ref_layers, ref_opt, RefGAR, ref_names, pt.Program,
                      pt.program_guard))
    with names.guard():
        main, startup = P(), P()
        with guard(main, startup):
            x = L.data("x", shape=[8], dtype="float32")
            y = L.data("y", shape=[1], dtype="float32")
            h = L.fc(x, size=hidden, act="tanh")
            pred = L.fc(h, size=1)
            loss = L.mean(L.square_error_cost(pred, y))
            O.SGDOptimizer(0.1).minimize(loss)
            eps = ",".join(f"127.0.0.1:{6170 + i}" for i in range(nranks))
            G().transpile(
                rank=0, endpoints=eps, current_endpoint=eps.split(",")[0],
                startup_program=startup, main_program=main)
    return main, startup, loss.name


# -- the static plan ----------------------------------------------------------

def test_plan_allreduce_bytes_and_algorithm_model():
    main, _, loss_name = _build_dp_program(nranks=2, hidden=16)
    plan = comms.plan_comms(main, [loss_name], nranks=2)
    assert plan is not None and plan.nranks == 2
    # every param grad: fc W [8,16], b [16], fc W [16,1], b [1], fp32
    assert len(plan.collectives) == 4
    assert {c.op for c in plan.collectives} == {"c_allreduce_sum"}
    expect_payload = 4 * (8 * 16 + 16 + 16 * 1 + 1)
    assert plan.payload_bytes == expect_payload
    # ring allreduce: 2(n-1)/n x payload = payload at n=2
    assert plan.wire_bytes == expect_payload
    for c in plan.collectives:
        assert c.wire_bytes == c.payload_bytes
        assert c.est_ms == pytest.approx(c.wire_bytes / plan.link_bw * 1e3)
        assert c.signature.startswith("c_allreduce_sum:r0:float32:")
    assert plan.est_ms == pytest.approx(plan.wire_bytes / plan.link_bw * 1e3)
    assert plan.bound in ("comm", "compute")
    assert 0.0 <= plan.comm_frac <= 1.0
    assert "comms plan" in plan.report()
    # at n=4 the ring factor is 2*3/4 = 1.5x payload
    plan4 = comms.plan_comms(main, [loss_name], nranks=4)
    assert plan4.wire_bytes == int(expect_payload * 1.5)


def test_plan_parity_and_divergence_fingerprints():
    main_a, _, loss_a = _build_dp_program(nranks=2, hidden=16)
    main_b, _, loss_b = _build_dp_program(nranks=2, hidden=16)
    pa = comms.plan_comms(main_a, [loss_a], nranks=2)
    pb = comms.plan_comms(main_b, [loss_b], nranks=2)
    assert [c.signature for c in pa.collectives] == \
        [c.signature for c in pb.collectives]
    assert pa.payload_bytes == pb.payload_bytes
    assert pa.fingerprint == pb.fingerprint
    main_c, _, loss_c = _build_dp_program(nranks=2, hidden=32)
    pc = comms.plan_comms(main_c, [loss_c], nranks=2)
    assert pc.fingerprint != pa.fingerprint
    # the same signatures at another nranks: the plan sees it
    p3 = comms.plan_comms(main_a, [loss_a], nranks=3)
    assert [c.signature for c in p3.collectives] == \
        [c.signature for c in pa.collectives]
    assert p3.fingerprint != pa.fingerprint


def test_plan_none_without_collectives():
    with unique_name.guard():
        main, startup = Program(), Program()
        with program_guard(main, startup):
            x = layers.data("x", shape=[4], dtype="float32")
            loss = layers.mean(layers.fc(x, size=4))
    assert comms.plan_comms(main, [loss.name]) is None


def test_verifier_stamps_comms_and_folds_fingerprint():
    main_a, _, loss_a = _build_dp_program(nranks=2)
    verifier.clear_cache()
    res_a = verifier.verify_program(main_a, [loss_a])
    va = main_a._attrs["verify"]["comms"]
    assert va is not None
    assert va["nranks"] == 2
    assert va["payload_bytes"] == res_a.comms_plan.payload_bytes
    assert va["bound"] in ("comm", "compute")
    assert va["fingerprint"] == res_a.comms_plan.fingerprint
    assert len(va["collectives"]) == 4
    assert main_a._attrs["verify"]["sharding"] is None
    # the same collective sequence at another nranks diverges
    main_b, _, loss_b = _build_dp_program(nranks=3)
    res_b = verifier.verify_program(main_b, [loss_b])
    assert res_a.collective_fingerprint
    assert res_b.collective_fingerprint
    assert res_a.collective_fingerprint != res_b.collective_fingerprint
    main_a2, _, loss_a2 = _build_dp_program(nranks=2)
    res_a2 = verifier.verify_program(main_a2, [loss_a2])
    assert res_a2.collective_fingerprint == res_a.collective_fingerprint


# -- the runtime path (collective mode on a dp mesh of 2 virtual ranks) -------

def _dp_exe():
    main, startup, loss_name = _build_dp_program(nranks=2)
    scope = Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope, seed=11)
    set_mesh(make_mesh({"dp": 2}, [torch.device("cpu")] * 2))
    rng = np.random.RandomState(3)
    xv = rng.rand(8, 8).astype(np.float32)
    return main, scope, exe, loss_name, {
        "x": xv, "y": xv.sum(1, keepdims=True).astype(np.float32)}


def test_collective_dispatch_accounts_bytes_and_decomposes():
    main, scope, exe, loss_name, feed = _dp_exe()
    plan = comms.plan_comms(main, [loss_name], batch_size=8, nranks=2)
    before = monitor.counter_totals()
    launches0 = monitor.REGISTRY.get(
        "paddle_tpu_collective_launches_total").value(kind="shard_map_step")
    monitor.TRACER.clear()
    steps = 3
    timed_steps = steps - 1     # the first step counts bytes, no timing
    was = monitor.TRACER.enabled
    monitor.TRACER.enabled = True
    try:
        for _ in range(steps):
            exe.run(main, feed=feed, fetch_list=[loss_name], scope=scope)
        assert comms.MONITOR.drain(timeout_s=30)
    finally:
        monitor.TRACER.enabled = was
    after = monitor.counter_totals()
    delta = after.get("paddle_tpu_collective_bytes_total", 0) - \
        before.get("paddle_tpu_collective_bytes_total", 0)
    assert delta == plan.payload_bytes * steps            # exact
    assert monitor.REGISTRY.get(
        "paddle_tpu_collective_launches_total").value(
            kind="shard_map_step") - launches0 == steps
    fam = monitor.REGISTRY.get("paddle_tpu_collective_bytes_total")
    sigs = {lbl["signature"] for lbl, _ in fam.series()
            if lbl.get("op") == "c_allreduce_sum"}
    assert {c.signature for c in plan.collectives} <= sigs
    assert monitor.REGISTRY.get("paddle_tpu_comm_step_ms").value() > 0
    assert monitor.REGISTRY.get("paddle_tpu_comm_wait_ms").value() == 0
    assert sum(s["count"] for s in
               next(m for m in monitor.REGISTRY.collect()
                    if m["name"] == "paddle_tpu_collective_wait_ms")
               ["series"]) >= timed_steps
    spans = [ev for ev in monitor.TRACER.chrome_events()
             if ev.get("name") == "collective.launch"]
    assert len(spans) >= timed_steps
    args = spans[-1]["args"]
    assert args["bytes"] == plan.payload_bytes
    assert args["signature"] == plan.fingerprint[:12]
    assert "wait_ms" in args and "step_id" in args
    assert spans[-1].get("cat") == "collective"
    digest = monitor.metrics_digest()
    assert "comm_ms" in digest and "comm_wait" in digest \
        and "comm_bw" in digest
    assert "comm_wait" in monitor.capped_digest(digest, max_bytes=80)


def test_comms_telemetry_flag_off_measures_nothing():
    main, scope, exe, loss_name, feed = _dp_exe()
    flags.set_flags({"FLAGS_comms_telemetry": False})
    before = monitor.counter_totals()
    exe.run(main, feed=feed, fetch_list=[loss_name], scope=scope)
    after = monitor.counter_totals()
    assert after.get("paddle_tpu_collective_bytes_total", 0) == \
        before.get("paddle_tpu_collective_bytes_total", 0)


def test_link_bandwidth_table():
    assert comms.device_link_bandwidth(torch.device("cpu")) == 1e10
    assert [k for k, _ in comms.NVLINK_BW][:2] == ["H100 PCIe", "H100 NVL"]
    assert dict(comms.NVLINK_BW)["H100"] == 450e9


# -- parity with the reference's plan ------------------------------------------

@pytest.mark.parametrize("nranks", [2, 4])
@pytest.mark.parametrize("compress", [None, "bf16"])
def test_plan_matches_reference(nranks, compress):
    def build(port):
        L, O, G, names, P, guard = (
            (layers, opt, GradAllReduce, unique_name, Program,
             program_guard) if port else
            (ref_layers, ref_opt, RefGAR, ref_names, pt.Program,
             pt.program_guard))
        with names.guard():
            main, startup = P(), P()
            with guard(main, startup):
                x = L.data("x", shape=[8], dtype="float32")
                y = L.data("y", shape=[1], dtype="float32")
                h = L.fc(x, size=16, act="tanh")
                loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
                O.MomentumOptimizer(0.1, 0.9).minimize(loss)
                eps = ",".join(f"127.0.0.1:{6170 + i}"
                               for i in range(nranks))
                G(compress=compress).transpile(
                    rank=0, endpoints=eps, current_endpoint="127.0.0.1:6170",
                    startup_program=startup, main_program=main)
        return main, loss.name

    ref_main, ref_loss = build(False)
    main, loss = build(True)
    want = ref_comms.plan_comms(ref_main, [ref_loss], batch_size=8)
    got = comms.plan_comms(main, [loss], batch_size=8)

    def rows(plan):
        return [(c.op, c.ring_id, c.dtype, c.shape, c.payload_bytes,
                 c.wire_bytes) for c in plan.collectives]

    assert rows(got) == rows(want)
    assert got.nranks == want.nranks == nranks
    assert got.link_bw == want.link_bw
    assert got.comm_frac == pytest.approx(want.comm_frac, rel=1e-9)
    assert got.bound == want.bound
    assert got.fingerprint == want.fingerprint


def test_comms_smoke_gates_pass():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m",
                        "paddle_tpu_torch.tools.comms_smoke"], cwd=repo,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    for gate in ("gate (a) OK", "gate (b) OK", "gate (c) OK",
                 "comms smoke OK"):
        assert gate in r.stdout, r.stdout[-4000:]
