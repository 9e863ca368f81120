"""Shared helpers of the port's parameter-server tests
(``tests/test_torch_ps.py``, ``tests/test_torch_ps_train.py``): both
packages behind one namespace each, a fresh port state with both packages'
RPC deadline at ``DEADLINE_MS``, ports from a bound socket, servers that
are stopped and joined on exit.

A module takes the autouse fixture by importing it by name::

    from _ps_helpers import fresh_ps_state  # noqa: F401
"""


import contextlib
import json
import os
import random
import socket
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import flags as ref_flags
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.distributed import ps as ref_ps
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import core as ref_core
from paddle_tpu.framework import scope as ref_scope
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.layer_helper import LayerHelper as RefLayerHelper
from paddle_tpu.models import ctr as ref_ctr
from paddle_tpu.models import transformer as RT
from paddle_tpu_torch import flags
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.framework import core, scope, unique_name
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.models import ctr
from paddle_tpu_torch.models import transformer as T

DEADLINE_MS = 10000
JOIN_S = 20
CHILD_TIMEOUT_S = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "paddle_tpu_torch", "tools", "ps_runner.py")
#: the reference test_ps_sync_matches_local's tolerances
SYNC_TOL = dict(rtol=2e-3, atol=1e-5)
#: a trajectory held against the reference's on the same weights and feeds
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)
W_TRUE = np.array([[1.0], [-2.0], [3.0], [0.5]], np.float32)

REF = SimpleNamespace(
    name="ref", root=pt, layers=pt.layers, opt=ref_opt, ps=ref_ps,
    core=ref_core, scope=ref_scope, names=ref_names, helper=RefLayerHelper,
    ctr=ref_ctr, T=RT, exe=lambda: RefExecutor(),
    const=lambda v: pt.initializer.ConstantInitializer(v))
PORT = SimpleNamespace(
    name="port", root=ptt, layers=ptt.layers, opt=opt, ps=ps, core=core,
    scope=scope, names=unique_name, helper=LayerHelper, ctr=ctr, T=T,
    exe=lambda: ptt.Executor(ptt.CPUPlace()),
    const=lambda v: ptt.initializer.ConstantInitializer(v))


@pytest.fixture(autouse=True)
def fresh_ps_state():
    """Fresh port default programs, scope and names; both packages' RPC
    deadline at DEADLINE_MS; no client left behind."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    keys = ["FLAGS_rpc_deadline", "FLAGS_rpc_retry_times"]
    old = flags.get_flags(keys)
    old_ref = ref_flags.get_flags(keys)
    flags.set_flags({"FLAGS_rpc_deadline": DEADLINE_MS,
                     "FLAGS_rpc_retry_times": 3})
    ref_flags.set_flags({"FLAGS_rpc_deadline": DEADLINE_MS,
                         "FLAGS_rpc_retry_times": 3})
    try:
        with unique_name.guard():
            yield
    finally:
        ps.reset_clients()
        ref_ps.reset_clients()
        flags.set_flags(old)
        ref_flags.set_flags(old_ref)
        scope._scope_stack.pop()
        core.switch_main_program(old_main)
        core.switch_startup_program(old_startup)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def isolated(pkg):
    """Fresh programs, scope and names of ``pkg``; yields the scope."""
    sc = pkg.scope.Scope()
    with pkg.scope.scope_guard(sc), \
            pkg.core.program_guard(pkg.core.Program(), pkg.core.Program()), \
            pkg.names.guard():
        yield sc


@contextlib.contextmanager
def server(pkg, *args, **kw):
    """A started ``PSServer``; stopped and destroyed on exit."""
    srv = pkg.ps.PSServer(*args, **kw)
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()
        srv.destroy()


@contextlib.contextmanager
def serving(pkg, t, ep):
    """The transpiler's pserver program for ``ep`` run by an executor on a
    thread (as the reference tests run it), stopped and joined on exit."""
    prog, start = t.get_pserver_programs(ep)
    exe, sc = pkg.exe(), pkg.scope.Scope()
    exe.run(start, scope=sc)
    th = threading.Thread(target=exe.run, args=(prog,),
                          kwargs={"scope": sc}, daemon=True)
    th.start()
    try:
        yield
    finally:
        th.join(0.05)
        try:
            if th.is_alive():       # a test may have stopped it already
                pkg.ps.get_client(ep).stop_server()
        finally:
            th.join(JOIN_S)
            pkg.ps.reset_clients()
        assert not th.is_alive(), "the pserver thread did not end"


def host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def seed_tables(pkg, t, sc, values=None):
    """Put the trainer scope's values (or ``values``) of every transpiled
    param into its server."""
    for name, ep in t._param_eps.items():
        v = values[name] if values is not None else host(sc.find_var(name))
        pkg.ps.get_client(ep).put(name, np.asarray(v, np.float32).ravel())


def regression(pkg, pname):
    """The reference tests' 4 -> 1 regression, its weight ``pname`` at 0;
    returns the loss."""
    x = pkg.layers.data("x", shape=[4], dtype="float32")
    y = pkg.layers.data("y", shape=[1], dtype="float32")
    pred = pkg.layers.fc(x, size=1, bias_attr=False,
                         param_attr=pkg.root.ParamAttr(
                             name=pname, initializer=pkg.const(0.0)))
    return pkg.layers.mean(pkg.layers.square_error_cost(pred, y))


def _port_range(servers):
    """A launch_ps base port with the servers' endpoints (base ..) and the
    two workers' (base + 1000, base + 1001) free."""
    for _ in range(50):
        base = random.randint(20000, 40000)
        socks = []
        try:
            for off in (*range(servers), 1000, 1001):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", base + off))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise RuntimeError("no free port range found")


def deepfm_gang(tmp_path, workers, *runner_args, sparse_dim=50, servers=1,
                evals=None):
    """``tools/ps_runner.py``'s DeepFM on the host under ``launch_ps``
    (``servers`` pservers, ``workers`` trainers, ``CHILD_TIMEOUT_S``); each
    worker's ``RESULT`` records, and the pservers' ``PSERVER`` records.
    ``evals``, a list, takes the workers' ``EVAL`` records."""
    env = dict(os.environ, FLAGS_rpc_deadline=str(DEADLINE_MS),
               CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PYTEST_CURRENT_TEST", None)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch_ps",
         "--server_num", str(servers), "--worker_num", str(workers),
         "--started_port", str(_port_range(servers)), "--log_dir",
         str(tmp_path),
         RUNNER, "--cpu", "--model", "deepfm", "--sparse_dim",
         str(sparse_dim), *runner_args],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S)
    logs = {p.name: p.read_text() for p in tmp_path.glob("*.log")}
    assert proc.returncode == 0, proc.stdout + proc.stderr + str(logs)

    def records(tag, names):
        return [json.loads(line[len(tag) + 1:]) for name in names
                for line in logs[name].splitlines()
                if line.startswith(tag + " ")]
    if evals is not None:
        evals.extend(records("EVAL", [f"worker.{i}.log"
                                      for i in range(workers)]))
    return (records("RESULT", [f"worker.{i}.log" for i in range(workers)]),
            records("PSERVER", [f"server.{k}.log" for k in range(servers)]))
