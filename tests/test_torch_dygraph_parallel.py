"""``dygraph.DataParallel`` across two processes on the CPU.

Two child processes take the launcher's environment
(``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
``PADDLE_TRAINER_ENDPOINTS``, ports from a bound socket), bring up the
gloo group with ``prepare_context`` (the group's own waits end after
``init_parallel_env``'s time limit), and run a small dygraph MLP from the
same weights on their half of a batch:
``scale_loss``, ``backward()``, ``apply_collective_grads()`` and one SGD
step.  Their gradients and updated weights are equal bit for bit, and
within 1e-6 of one process's on the whole batch.  Torch's thread pools are
pinned to 1 in every child; each child has its own 120 s deadline.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.tools.gang_smoke import free_port
from _port_fixtures import (collect_garbage_after_module,  # noqa: F401
                            fresh_port_programs)

pytestmark = pytest.mark.usefixtures("fresh_port_programs")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, DIN, DH = 16, 8, 12

_NET = textwrap.dedent("""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import dygraph

    def run(weights, x, y, parallel):
        with dygraph.guard(ptt.CPUPlace()):
            class MLP(dygraph.Layer):
                def __init__(self):
                    super().__init__("mlp")
                    self.fc1 = dygraph.Linear(%d, %d, act="tanh")
                    self.fc2 = dygraph.Linear(%d, 1)

                def forward(self, v):
                    return self.fc2(self.fc1(v))
            net = MLP()
            net.set_dict(weights)
            model = dygraph.DataParallel(net) if parallel else net
            opt = ptt.optimizer.SGDOptimizer(
                0.1, parameter_list=net.parameters())
            t = dygraph.default_tracer()
            d = model(dygraph.to_variable(x)) - dygraph.to_variable(y)
            loss = t.trace_op("mean", {"X": [d * d]}, {})["Out"][0]
            if parallel:
                loss = model.scale_loss(loss)
            loss.backward()
            if parallel:
                model.apply_collective_grads()
            grads = {n: p.gradient() for n, p in net.named_parameters()}
            opt.minimize(loss)
            return grads, {n: p.numpy() for n, p in net.named_parameters()}
""" % (DIN, DH, DH))

_CHILD = _NET + textwrap.dedent("""
    import sys
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    data = np.load(sys.argv[1])
    env = dygraph.prepare_context()
    rank, n = env.local_rank, env.nranks
    half = len(data["x"]) // n
    rows = slice(rank * half, (rank + 1) * half)
    weights = {k[2:]: data[k] for k in data.files if k.startswith("w:")}
    grads, after = run(weights, data["x"][rows], data["y"][rows], True)
    np.savez(sys.argv[2], **{"g:" + k: v for k, v in grads.items()},
             **{"a:" + k: v for k, v in after.items()})
    print("DONE", rank, n)
""")

exec(_NET)      # defines run() here too


def _weights():
    rng = np.random.RandomState(4)
    with dygraph.guard(ptt.CPUPlace()):
        names = [dygraph.Linear(DIN, DH).state_dict(),
                 dygraph.Linear(DH, 1).state_dict()]
    return {f"fc{i + 1}.{k}": rng.randn(*v.shape).astype("float32") * 0.5
            for i, sd in enumerate(names) for k, v in sd.items()}


def test_data_parallel_two_processes(tmp_path):
    rng = np.random.RandomState(7)
    x = rng.randn(BATCH, DIN).astype("float32")
    y = rng.randn(BATCH, 1).astype("float32")
    weights = _weights()
    data = str(tmp_path / "data.npz")
    np.savez(data, x=x, y=y, **{"w:" + k: v for k, v in weights.items()})
    ports = [free_port(), free_port()]
    eps = ",".join(f"127.0.0.1:{p}" for p in ports)
    procs = []
    for rank in range(2):
        env = dict(os.environ, PADDLE_TRAINER_ID=str(rank),
                   PADDLE_TRAINERS_NUM="2", PADDLE_TRAINER_ENDPOINTS=eps,
                   PADDLE_CURRENT_ENDPOINT=eps.split(",")[rank],
                   PYTHONPATH=REPO + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD, data,
             str(tmp_path / f"rank{rank}.npz")], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "DONE" in out, err[-3000:]
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    assert sorted(r0.files) == sorted(r1.files)
    for k in r0.files:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    grads, after = run(weights, x, y, False)      # noqa: F821 (_NET)
    for name, g in grads.items():
        np.testing.assert_allclose(r0["g:" + name], g, rtol=0, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(r0["a:" + name], after[name], rtol=0,
                                   atol=1e-6, err_msg=name)


def test_parallel_env_reads_the_launcher(monkeypatch):
    for k, v in {"PADDLE_TRAINERS_NUM": "4", "PADDLE_TRAINER_ID": "2",
                 "FLAGS_selected_gpus": "1",
                 "PADDLE_TRAINER_ENDPOINTS": "a:1,b:2,c:3,d:4",
                 "PADDLE_CURRENT_ENDPOINT": "c:3"}.items():
        monkeypatch.setenv(k, v)
    env = dygraph.ParallelEnv()
    assert (env.nranks, env.local_rank, env.dev_id, env.current_endpoint,
            env.trainer_endpoints) == (4, 2, 1, "c:3",
                                       ["a:1", "b:2", "c:3", "d:4"])
    assert dygraph.Env is dygraph.ParallelEnv
