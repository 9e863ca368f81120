"""Collective training across two processes in the port, on the CPU: the
port's runner (``paddle_tpu_torch/tools/collective_runner.py``) under the
port's launcher at 2 processes, on the reference runner's MLP and batch
(``tests/collective_two_proc_runner.py:26-62, :100-160``).

- ``LOSSES`` (``GradAllReduce`` + SGD), ``GSPMD`` (``with_distributed(
  dp=2)``, each process feeding its half) and ``ZERO`` (ZeRO-1, Adam) are
  equal on both ranks bit for bit, and bit for bit to a third child that
  runs the same programs in one process over an in-process dp 2 mesh of
  virtual ranks; the parameters after the steps too.
- They are within 1e-5 of the reference's single-process run from the
  same weights and global batch (the tolerance of
  ``tests/test_two_process_collective.py``, which skips here: JAX's CPU
  backend runs no cross-process collective).  The weights come from a
  reference startup run, written to an ``.npz`` every child loads.
- ``RING``: each process's half of o is within 2e-4 of the reference's
  ``mha_reference`` over the whole T (its bound), and the runner holds
  o, lse, dq, dk, dv within 1e-5 of the port's plain dense attention; so
  does the model's ``ring_attention`` entry with autograd over the mesh
  that spans the two processes (o and the gradients whole on each).

Every child pins torch's thread pools to 1, so children are held to each
other bit for bit and the pytest worker (the reference) within the
tolerance.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import layers as ref_layers
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu_torch.tools import collective_runner as cr
from paddle_tpu_torch.tools.gang_smoke import free_port
from _port_fixtures import collect_garbage_after_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "paddle_tpu_torch", "tools",
                      "collective_runner.py")
STEPS = 4
RING = (2, 16, 8)


def _ref_mlp(make_opt):
    with ref_names.guard():
        main, startup = RefProgram(), RefProgram()
        with ref_guard(main, startup):
            x = ref_layers.data("x", shape=[8], dtype="float32")
            y = ref_layers.data("y", shape=[1], dtype="float32")
            h = ref_layers.fc(x, size=16, act="tanh")
            pred = ref_layers.fc(h, size=1)
            loss = ref_layers.mean(ref_layers.square_error_cost(pred, y))
            make_opt().minimize(loss)
    return main, startup, loss


def _ref_losses(make_opt, init):
    """The reference's single-process run from ``init`` on the global
    batch."""
    main, startup, loss = _ref_mlp(make_opt)
    sc, exe = RefScope(), RefExecutor()
    exe.run(startup, scope=sc, seed=cr.MLP_SEED)
    for k, v in init.items():
        sc.set_var(k, v)
    feed = cr.mlp_batch()
    return [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=sc)[0]).mean())
            for _ in range(STEPS)]


def _env():
    env = dict(os.environ)
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
              "PADDLE_GANG_COORD", "PADDLE_GANG_DIR"):
        env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _result(text):
    line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
    assert line, text[-3000:]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights and runs, the two ranks' results under the
    port launcher and the in-process child's, started together."""
    tmp = tmp_path_factory.mktemp("two_proc")
    main, startup, _ = _ref_mlp(lambda: ref_opt.SGDOptimizer(0.1))
    sc = RefScope()
    RefExecutor().run(startup, scope=sc, seed=cr.MLP_SEED)
    init = {p.name: np.asarray(sc.find_var(p.name))
            for p in main.all_parameters()}
    npz = str(tmp / "init.npz")
    np.savez(npz, **init)
    args = ["--cpu", "--init", npz, "--steps", str(STEPS), "--ring",
            ",".join(map(str, RING)), "--ring-values", "--ring-op"]
    log_dir = str(tmp / "logs")
    gang = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--started_port", str(free_port()),
         "--log_dir", log_dir, RUNNER] + args, env=_env(), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    single = subprocess.run([sys.executable, RUNNER, "--single"] + args,
                            env=_env(), cwd=REPO, capture_output=True,
                            text=True, timeout=300)
    out, err = gang.communicate(timeout=300)
    logs = [open(os.path.join(log_dir, f"worker.{r}.log")).read()
            for r in (0, 1)]
    assert gang.returncode == 0, err[-3000:] + logs[0][-3000:] + \
        logs[1][-3000:]
    assert single.returncode == 0, single.stderr[-3000:]
    ref = {"losses": _ref_losses(lambda: ref_opt.SGDOptimizer(0.1), init),
           "zero": _ref_losses(lambda: ref_opt.AdamOptimizer(0.05), init)}
    ref["gspmd"] = ref["losses"]
    return {"ranks": [_result(t) for t in logs],
            "single": _result(single.stdout), "ref": ref, "init": init}


@pytest.mark.parametrize("phase", ["losses", "gspmd", "zero"])
def test_ranks_equal_the_in_process_mesh_bit_for_bit(runs, phase):
    r0, r1 = (r[phase] for r in runs["ranks"])
    one = runs["single"][phase]
    assert r0["losses"] == r1["losses"] == one["losses"]
    assert r0["digest0"] == r1["digest0"] == one["digest0"]
    assert r0["digest"] == r1["digest"] == one["digest"]
    assert r0["params"] == r1["params"] == one["params"]
    assert r0["losses"][-1] < r0["losses"][0]        # it trained


@pytest.mark.parametrize("phase", ["losses", "gspmd", "zero"])
def test_ranks_match_the_reference_single_process(runs, phase):
    got = runs["ranks"][0][phase]["losses"]
    np.testing.assert_allclose(got, runs["ref"][phase], rtol=0, atol=1e-5)


@pytest.mark.parametrize("phase", ["losses", "gspmd", "zero"])
def test_collective_bytes_follow_the_comms_plan(runs, phase):
    """Each rank counts the plan's payload a step (the comms plan of the
    transpiled program; the sharding plan of the SPMD ones), as one
    process of virtual ranks does."""
    for r in runs["ranks"] + [runs["single"]]:
        got = r[phase]
        assert got["plan_bytes"] > 0
        assert got["collective_bytes"] == got["plan_bytes"] * STEPS
    assert all(x > 0 for r in runs["ranks"] for x in r[phase]["exchange_ms"])
    assert not any(runs["single"][phase]["exchange_ms"])


def test_ring_across_processes_matches_dense_attention(runs):
    import importlib

    import jax.numpy as jnp
    import torch
    fa_ref = importlib.import_module("paddle_tpu.pallas.flash_attention")
    bh, t, d = RING
    q, k, v, _ = cr._ring_inputs(RING, torch.device("cpu"), 11)
    want = np.asarray(fa_ref.mha_reference(
        *(jnp.asarray(x.numpy()[None]) for x in (q, k, v))))[0]
    blocks = []
    for r in runs["ranks"]:
        ring = r["ring"]
        lo, hi = ring["block"]
        assert (lo, hi) == (t // 2 * int(r is runs["ranks"][1]),
                            t // 2 * (1 + int(r is runs["ranks"][1])))
        got = np.asarray(ring["o"], np.float32)
        np.testing.assert_allclose(got, want[:, lo:hi], rtol=0, atol=2e-4)
        assert max(ring["errors"].values()) <= 1e-5, ring["errors"]
        blocks.append(got)
    one = runs["single"]["ring"]
    assert max(one["errors"].values()) <= 1e-5
    # the model's entry across the processes: o and the gradients whole
    for r in runs["ranks"] + [runs["single"]]:
        assert max(r["ring"]["op_errors"].values()) <= 1e-5, \
            r["ring"]["op_errors"]
    np.testing.assert_array_equal(np.concatenate(blocks, 1),
                                  np.asarray(one["o"], np.float32))
