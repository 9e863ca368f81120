"""The port's parameter server in processes and through its facades, on the
CPU: the PS fleet (``ps_fleet``, ``TranspilerOptimizer``), the PS launcher
(``python -m paddle_tpu_torch.distributed.launch_ps``), the trainer /
pserver runner (``paddle_tpu_torch/tools/ps_runner.py``), the Downpour API
and ``CheckpointManager.save_server``.

- the counterparts of ``tests/test_ps.py``'s ``test_ps_fleet_end_to_end``
  (in process, a server thread), ``test_launch_ps_end_to_end`` (2 servers
  and 2 workers under the launcher) and ``test_two_trainers_subprocess``
  (a pserver and 2 trainers started with their roles on the command line),
  through ``ps_runner.py``; every child pins torch's threads to 1 and runs
  under a timeout;
- the launcher's per-process environments equal the reference's;
- the Downpour descriptor and ``PaddlePSInstance`` roles against
  ``tests/test_misc_shims.py``'s and the reference's;
- ``save_server`` snapshots a server's tables and ``restore`` loads them
  back.
"""

import json
import os
import random
import socket
import subprocess
import sys
import threading
from argparse import Namespace

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.distributed import downpour as ref_downpour
from paddle_tpu.distributed import launch_ps as ref_launch_ps
from paddle_tpu.framework import core as ref_core
from paddle_tpu.framework import unique_name as ref_names
import paddle_tpu as pt
from paddle_tpu_torch import flags
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.distributed import (PSFleet, UserDefinedRoleMaker,
                                          downpour, launch_ps, ps)
from paddle_tpu_torch.distributed.fleet import Role
from paddle_tpu_torch.framework import Scope, core, scope, unique_name
from paddle_tpu_torch.tools.gang_smoke import free_port
from _port_fixtures import collect_garbage_after_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "paddle_tpu_torch", "tools", "ps_runner.py")
DEADLINE_MS = 10000
CHILD_TIMEOUT_S = 120
JOIN_S = 20


@pytest.fixture(autouse=True)
def _fresh():
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    keys = ["FLAGS_rpc_deadline"]
    old = flags.get_flags(keys)
    flags.set_flags({"FLAGS_rpc_deadline": DEADLINE_MS})
    try:
        with unique_name.guard():
            yield
    finally:
        ps.reset_clients()
        flags.set_flags(old)
        scope._scope_stack.pop()
        core.switch_main_program(old_main)
        core.switch_startup_program(old_startup)


def _env():
    env = dict(os.environ, FLAGS_rpc_deadline=str(DEADLINE_MS),
               CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PYTEST_CURRENT_TEST", None)
    return env


def _results(text):
    return [json.loads(line[len("RESULT "):]) for line in text.splitlines()
            if line.startswith("RESULT ")]


def _port_range():
    """A base port with base, base+1 (servers) and base+1000, base+1001
    (worker endpoints) all free."""
    for _ in range(50):
        base = random.randint(20000, 40000)
        socks = []
        try:
            for off in (0, 1, 1000, 1001):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + off))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range found")


def _launch_ps(tmp_path, servers, workers, *runner_args):
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch_ps",
         "--server_num", str(servers), "--worker_num", str(workers),
         "--started_port", str(_port_range()), "--log_dir", str(tmp_path),
         RUNNER, "--cpu", *runner_args],
        cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S)
    logs = {p.name: p.read_text() for p in tmp_path.glob("*.log")}
    assert proc.returncode == 0, proc.stdout + proc.stderr + str(logs)
    return [r for i in range(workers)
            for r in _results(logs[f"worker.{i}.log"])]


# ---------------------------------------------------------------------------
# the fleet, the launcher and the runner
# ---------------------------------------------------------------------------

def test_ps_fleet_end_to_end():
    """The fleet facade's PS flow: a worker trains ``fleet.main_program``
    against a server brought up from the same transpiler on a thread."""
    ep = f"127.0.0.1:{free_port()}"
    x = ptt.layers.data("x", shape=[4], dtype="float32")
    y = ptt.layers.data("y", shape=[1], dtype="float32")
    pred = ptt.layers.fc(x, size=1, bias_attr=False, param_attr=ptt.ParamAttr(
        name="wf", initializer=ptt.initializer.ConstantInitializer(0.0)))
    loss = ptt.layers.mean(ptt.layers.square_error_cost(pred, y))
    f = PSFleet()
    f.init(UserDefinedRoleMaker(current_id=0, role=Role.WORKER,
                                worker_num=1, server_endpoints=[ep]))
    f.distributed_optimizer(opt.SGD(learning_rate=0.1)).minimize(loss)
    assert [op.type for op in f.main_program.global_block().ops][-2:] == \
        ["send", "recv"]
    pserver, pstart = f._transpiler.get_pserver_programs(ep)
    exe = ptt.Executor(ptt.CPUPlace())
    srv_scope = Scope()
    exe.run(pstart, scope=srv_scope)
    srv = threading.Thread(target=exe.run, args=(pserver,),
                           kwargs={"scope": srv_scope}, daemon=True)
    srv.start()
    try:
        exe.run(f.startup_program)
        rng = np.random.RandomState(0)
        w_true = np.array([[1.0], [-2.0], [3.0], [0.5]], np.float32)
        for _ in range(20):
            xv = rng.rand(16, 4).astype(np.float32)
            lv, = exe.run(f.main_program, feed={"x": xv, "y": xv @ w_true},
                          fetch_list=[loss])
        assert float(lv) < 1.0
    finally:
        ps.get_client(ep).stop_server()
        srv.join(JOIN_S)
    assert not srv.is_alive()


def test_launch_ps_end_to_end(tmp_path):
    """The launcher spawns 2 servers and 2 workers with the PS env
    contract; the workers pick their roles through ``ps_fleet`` and the
    sync gang ends with both on the same loss."""
    results = _launch_ps(tmp_path, 2, 2, "--model", "regression")
    assert sorted(r["trainer_id"] for r in results) == [0, 1]
    last = {r["trainer_id"]: r["losses"][-1] for r in results}
    assert abs(last[0] - last[1]) < 1e-4
    assert last[0] < 1.0
    assert results[0]["digests"] == results[1]["digests"]
    assert (tmp_path / "server.0.log").exists() and \
        (tmp_path / "server.1.log").exists()


def test_two_trainers_subprocess():
    """A pserver and 2 trainers with their roles on the command line: sync
    averaging gives both trainers the same parameters, and the shared model
    converges."""
    port = str(free_port())
    env = _env()

    def launch(*args):
        return subprocess.Popen(
            [sys.executable, RUNNER, "--cpu", "--port", port, "--trainers",
             "2", *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=REPO)

    procs = [launch("--role", "pserver")]
    try:
        procs += [launch("--role", "trainer", "--trainer_id", str(i))
                  for i in range(2)]
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(JOIN_S)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    r0, r1 = _results(outs[1][0])[0], _results(outs[2][0])[0]
    np.testing.assert_allclose(r0["wsum"], r1["wsum"], rtol=1e-5)
    assert r0["losses"][-1] < 1.0 and r1["losses"][-1] < 1.0
    assert len(r0["losses"]) == 30


def test_launch_ps_env_equals_the_references():
    for kw in (dict(server_num=2, worker_num=3, servers=None, workers=None,
                    started_port=6270),
               dict(server_num=1, worker_num=1, servers="10.0.0.1:7000",
                    workers="10.0.0.2:7001,10.0.0.3:7001",
                    started_port=6170)):
        args = Namespace(**kw)
        assert launch_ps.get_ps_cluster_env(args) == \
            ref_launch_ps.get_ps_cluster_env(args)
    argv = ["--server_num", "1", "--worker_num", "2", "--log_dir", "/tmp/l",
            "train.py", "--model", "deepfm"]
    assert vars(launch_ps._parse_args(argv)) == \
        vars(ref_launch_ps._parse_args(argv))


# ---------------------------------------------------------------------------
# Downpour and save_server
# ---------------------------------------------------------------------------

def _downpour(pkg, core_mod, names, dp):
    main, startup = core_mod.Program(), core_mod.Program()
    with core_mod.program_guard(main, startup), names.guard():
        ids = pkg.layers.data("ids", shape=[1], dtype="int64")
        emb = pkg.layers.embedding(ids, size=[100, 8], is_sparse=True)
        dense = pkg.layers.data("dense", shape=[4], dtype="float32")
        h = pkg.layers.fc(pkg.layers.concat(
            [pkg.layers.reshape(emb, [-1, 8]), dense], axis=1), size=1)
        cost = pkg.layers.mean(pkg.layers.square(h))
        ps_param, skipped = dp.DownpourSGD(learning_rate=0.01,
                                           window=1).minimize([cost])
        types = [op.type for op in main.global_block().ops]
    return ps_param, skipped, ids.name, types


def test_downpour_sgd_builds_ps_descriptor():
    ps_param, skipped, ids_name, types = _downpour(ptt, core, unique_name,
                                                   downpour)
    assert len(ps_param.server_param.sparse_tables) == 1
    assert ps_param.server_param.sparse_tables[0].slot_key_vars == \
        [ids_name]
    assert len(ps_param.server_param.dense_tables) == 1
    dense_params = ps_param.server_param.dense_tables[0].param_vars
    assert any("fc" in p for p in dense_params)
    assert not any("emb" in p for p in dense_params)
    assert ps_param.program_configs[0]["pull_sparse_table_id"] == [0]
    assert "sgd" in skipped
    ref = _downpour(pt, ref_core, ref_names, ref_downpour)
    assert types == ref[3]
    strip = (lambda p: [(t.table_id, t.learning_rate, t.slot_key_vars,
                         t.slot_value_vars) for t in p.sparse_tables] +
             [(t.table_id, t.learning_rate, t.param_vars) for t in
              p.dense_tables])
    assert strip(ps_param.server_param) == strip(ref[0].server_param)
    assert strip(ps_param.worker_param) == strip(ref[0].worker_param)
    assert skipped == ref[1]
    with pytest.raises(ValueError):
        downpour.DownpourSGD().minimize(None)


def test_ps_instance_roles(monkeypatch):
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("PADDLE_PSERVER_ENDPOINTS",
                       "127.0.0.1:7000,127.0.0.1:7001")
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:7001")
    for dp in (downpour, ref_downpour):
        inst = dp.PaddlePSInstance()
        assert inst.is_server() and not inst.is_worker()
        assert inst.get_server_index() == 1
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    for dp in (downpour, ref_downpour):
        inst = dp.PaddlePSInstance()
        assert inst.is_first_worker() and inst.get_worker_num() == 2
        assert inst.get_node_cnt() == 2 and inst.get_worker_index() == 0


def test_save_server_round_trips_the_tables(tmp_path):
    specs = [{"name": "w", "size": 6, "optimizer": "sgd", "lr": 0.5},
             {"name": "emb", "size": 12, "rows": 4, "optimizer": "sgd",
              "lr": 1.0}]
    srv = ps.PSServer(0, 1, True, specs)
    port = srv.start()
    try:
        cli = ps.PSClient(f"127.0.0.1:{port}")
        cli.put("w", np.arange(6, dtype=np.float32))
        cli.put("emb", np.arange(12, dtype=np.float32) / 7)
        cli.push_dense("w", np.ones(6, np.float32))
        cli.push_sparse("emb", [2], np.full((1, 3), 2.0, np.float32))
        cli.close()
        ckpt = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
        assert ckpt.save_server(3, srv, specs)
        assert not ckpt.save_server(2, srv, specs)    # at or below latest
        ckpt.wait_until_finished()
        want = {s["name"]: srv.get_param(s["name"], s["size"])
                for s in specs}
    finally:
        srv.stop()
        srv.destroy()
    sc = Scope()
    assert CheckpointManager(str(tmp_path / "ck")).restore(scope=sc) == 3
    for name, w in want.items():
        got = sc.find_var(name)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), w)
    np.testing.assert_array_equal(want["w"], np.arange(6) - 0.5)
    np.testing.assert_allclose(want["emb"][6:9], np.arange(6, 9) / 7 - 2.0,
                               rtol=1e-6)
