"""The port's distributed API surface against the JAX package's, on the CPU:
the trainer environment (``distributed/env.py``) and the fleet facade's
collective half (``distributed/fleet.py``).

- ``Env`` reads the launcher's ``PADDLE_*`` variables as the reference
  does; one process needs no ``init_parallel_env`` (several bring up
  ``torch.distributed``, ``tests/test_torch_two_process.py``), and
  ``GangRendezvous.from_env`` picks the reference's backend;
- ``fleet.init(PaddleCloudRoleMaker(is_collective=True))`` and the worker
  queries answer as the reference's;
- ``fleet.distributed_optimizer(opt, strategy).minimize(loss)`` gives the
  reference's op-type sequence, startup and main, for ``mode="collective"``
  (``GradAllReduce``) and ``"local_sgd"`` (``LocalSGD``), and the program
  then trains in collective mode over a ``dp`` mesh;
- the parameter-server branches (the PSERVER role maker, ``Role.SERVER``,
  ``init_server``) take the reference's paths.
"""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.distributed import env as ref_env
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu_torch import distributed
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.framework import unique_name
from paddle_tpu_torch.parallel import make_mesh, set_mesh
from _port_fixtures import collect_garbage_after_module  # noqa: F401

# the modules (each package's ``distributed.fleet`` name is the singleton)
ref_fleet = importlib.import_module("paddle_tpu.distributed.fleet")
fleet_mod = importlib.import_module("paddle_tpu_torch.distributed.fleet")

TWO = "10.0.0.1:6170,10.0.0.2:6170"
_VARS = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
         "PADDLE_CURRENT_ENDPOINT", "PADDLE_TRAINER_ENDPOINTS",
         "FLAGS_selected_gpus", "FLAGS_selected_tpus", "TRAINING_ROLE",
         "PADDLE_PSERVER_ENDPOINTS")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for v in _VARS:
        monkeypatch.delenv(v, raising=False)
    yield
    set_mesh(None)


def _fields(e):
    return (e.rank, e.world_size, e.current_endpoint, e.trainer_endpoints,
            e.dev_id)


def test_env_reads_the_launchers_contract(monkeypatch):
    assert _fields(env.Env()) == _fields(ref_env.Env()) == (0, 1, "", [], 0)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "10.0.0.2:6170")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", TWO)
    monkeypatch.setenv("FLAGS_selected_gpus", "3")
    assert _fields(env.Env()) == _fields(ref_env.Env()) == (
        1, 2, "10.0.0.2:6170", TWO.split(","), 3)
    assert env.get_rank() == ref_env.get_rank() == 1
    assert env.get_world_size() == ref_env.get_world_size() == 2


def test_init_parallel_env_is_one_process_only(monkeypatch, tmp_path):
    """One process needs nothing brought up (a no-op returning its Env,
    as the reference's); several go through ``torch.distributed`` (the
    two-process tests drive that), and a world with no rendezvous address
    raises before any wait.  ``GangRendezvous`` is the file backend, and
    ``from_env`` picks what the reference's picks."""
    assert env.init_parallel_env().world_size == 1
    assert env.init_parallel_env(num_processes=1).rank == 0
    assert not env.is_multiprocess() and env.process_count() == 1
    monkeypatch.setattr(env, "_initialized", False)
    with pytest.raises(ValueError, match="no coordinator address"):
        env.init_parallel_env(num_processes=2)
    gang = env.GangRendezvous(str(tmp_path / "g"), rank=0)
    assert (gang.backend, gang.is_leader, gang.world_size) == \
        ("file", True, 1)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    assert env.GangRendezvous.from_env() is None
    assert ref_env.GangRendezvous.from_env() is None
    monkeypatch.setenv("PADDLE_GANG_DIR", str(tmp_path / "g"))
    got, want = env.GangRendezvous.from_env(), \
        ref_env.GangRendezvous.from_env()
    assert (got.backend, got.base_dir, got.rank, got.world_size) == \
        (want.backend, want.base_dir, want.rank, want.world_size) == \
        ("file", str(tmp_path / "g"), 0, 4)


def _queries(f):
    return (f.is_worker(), f.is_server(), f.is_first_worker(),
            f.worker_index(), f.worker_num(), f.server_num(),
            f.worker_endpoints(), f.worker_endpoints(to_string=True),
            f.server_endpoints())


def test_fleet_init_with_the_cloud_role_maker(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", TWO)
    ours, theirs = fleet_mod.Fleet(), ref_fleet.Fleet()
    with pytest.raises(RuntimeError, match="fleet.init"):
        ours.worker_num()
    ours.init(fleet_mod.PaddleCloudRoleMaker(is_collective=True))
    theirs.init(ref_fleet.PaddleCloudRoleMaker(is_collective=True))
    assert _queries(ours) == _queries(theirs) == (
        True, False, False, 1, 2, 0, TWO.split(","), TWO, [])
    # the default role maker is the collective cloud one
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    distributed.fleet.init()
    assert distributed.fleet.is_first_worker()
    assert distributed.fleet.worker_num() == 2


def test_user_defined_role_maker_matches_reference():
    ours, theirs = fleet_mod.Fleet(), ref_fleet.Fleet()
    ours.init(fleet_mod.UserDefinedRoleMaker(current_id=0, worker_num=4))
    theirs.init(ref_fleet.UserDefinedRoleMaker(current_id=0, worker_num=4))
    assert _queries(ours) == _queries(theirs)
    assert ours.worker_num() == 4


def _minimize(port, mode, nranks=2):
    L, O, F, names, root = ((ptt.layers, opt, fleet_mod, unique_name, ptt)
                            if port else (pt.layers, ref_opt, ref_fleet,
                                          ref_names, pt))
    f = F.Fleet()
    f.init(F.UserDefinedRoleMaker(current_id=0, worker_num=nranks))
    strategy = F.DistributedStrategy()
    strategy.mode = mode
    with names.guard():
        main, startup = root.Program(), root.Program()
        with root.program_guard(main, startup):
            x = L.data("x", shape=[8], dtype="float32")
            y = L.data("y", shape=[1], dtype="float32")
            h = L.fc(x, size=16, act="tanh")
            loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
            f.distributed_optimizer(O.SGDOptimizer(0.1), strategy).minimize(
                loss, startup_program=startup)
    return main, startup, loss.name


@pytest.mark.parametrize("mode", ["collective", "local_sgd"])
def test_distributed_optimizer_transpiles_like_the_reference(mode):
    main, startup, loss = _minimize(True, mode)
    ref_main, ref_startup, _ = _minimize(False, mode)
    for ours, theirs in ((main, ref_main), (startup, ref_startup)):
        assert [op.type for op in ours.global_block().ops] == \
            [op.type for op in theirs.global_block().ops]
    types = [op.type for op in main.global_block().ops]
    assert types.count("c_allreduce_sum") == 4
    if mode == "collective":
        assert types.index("c_allreduce_sum") < types.index("sgd")
    else:
        assert types.index("c_allreduce_sum") > max(
            i for i, t in enumerate(types) if t == "sgd")
    assert main._attrs["collective"] == {"nranks": 2, "rank": 0}
    # and it trains in collective mode over a dp mesh of 2
    exe = ptt.Executor(ptt.CPUPlace())
    sc = ptt.Scope()
    exe.run(startup, scope=sc, seed=3)
    set_mesh(make_mesh({"dp": 2}, [torch.device("cpu")] * 2))
    xv = np.random.RandomState(0).rand(4, 8).astype(np.float32)
    out, = exe.run(main, feed={"x": xv, "y": xv[:, :1]}, fetch_list=[loss],
                   scope=sc)
    assert out.shape == (2,) and np.isfinite(out).all()


def test_one_worker_does_not_transpile():
    main, _, _ = _minimize(True, "collective", nranks=1)
    assert "collective" not in main._attrs
    assert "c_allreduce_sum" not in [op.type for op in
                                     main.global_block().ops]


def test_parameter_server_branches_work(monkeypatch):
    """The PSERVER role maker, ``Role.SERVER`` and ``init_server`` take the
    reference's parameter-server branches."""
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("PADDLE_PSERVER_ID", "1")
    monkeypatch.setenv("PADDLE_PSERVER_ENDPOINTS",
                       "127.0.0.1:7000,127.0.0.1:7001")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    got = fleet_mod.PaddleCloudRoleMaker(is_collective=False)
    want = ref_fleet.PaddleCloudRoleMaker(is_collective=False)
    for rm in (got, want):
        rm.generate_role()
        assert rm.is_server() and not rm.is_worker()
        assert rm.server_index() == 1 and rm.worker_num() == 3
        assert rm.get_current_endpoint() == "127.0.0.1:7001"
    assert got.get_pserver_endpoints() == want.get_pserver_endpoints()
    srv = fleet_mod.UserDefinedRoleMaker(
        current_id=0, role=fleet_mod.Role.SERVER,
        server_endpoints=["127.0.0.1:7000"])
    assert srv.is_server() and srv.get_current_endpoint() == \
        "127.0.0.1:7000"
    f = fleet_mod.Fleet()
    f.init(fleet_mod.UserDefinedRoleMaker())
    assert f.init_server() is None               # the reference's no-op
    with pytest.raises(RuntimeError, match="no servers"):
        f.run_server()
    # the PS fleet's server runs its pserver startup on the host
    psf = fleet_mod.PSFleet()
    psf.init(srv)
    with unique_name.guard():
        x = ptt.layers.data("x", shape=[4], dtype="float32")
        loss = ptt.layers.mean(ptt.layers.fc(x, size=1))
        psf.distributed_optimizer(opt.SGD(learning_rate=0.1)).minimize(loss)
    assert [op.type for op in psf.main_program.global_block().ops] == \
        ["listen_and_serv"]
    scope = ptt.Scope()
    with ptt.framework.scope_guard(scope):
        psf.init_server()
    assert sorted(scope.local_var_names()) == sorted(
        s["name"] for s in psf._transpiler._param_specs.values())
    # a collective cloud role maker ignores TRAINING_ROLE, as the reference
    rm = fleet_mod.PaddleCloudRoleMaker(is_collective=True)
    rm.generate_role()
    assert rm.is_worker()


def test_exports_match_the_reference_collective_half():
    import paddle_tpu.distributed as ref_dist
    ps_only = {"GangClient", "GangCoordinator", "GangDegradedError",
               "GangFingerprintError", "coordinator", "launch"}
    want = {n for n in dir(ref_dist) if not n.startswith("_")} - ps_only
    got = {n for n in dir(distributed) if not n.startswith("_")}
    assert want - got == set()
