"""Fleet, the distributed-training facade (the port of
``paddle_tpu/distributed/fleet.py``; ref ``incubate/fleet/base/
fleet_base.py:38,222``, ``incubate/fleet/collective/__init__.py:41,140``,
``incubate/fleet/base/role_maker.py``, and the PS fleet of
``incubate/fleet/parameter_server/distribute_transpiler/__init__.py``).

``fleet.init(role_maker)`` then ``fleet.distributed_optimizer(opt,
strategy).minimize(loss)`` transpiles the program with ``GradAllReduce``
(``strategy.mode == "collective"``) or ``LocalSGD`` (``"local_sgd"``) for
the worker count, and the executor runs it in collective mode over the
``dp`` axis of the current mesh.  ``ps_fleet`` (:class:`PSFleet`) is the
parameter-server facade: ``minimize`` transpiles with
``DistributeTranspiler``; a worker trains ``ps_fleet.main_program``, a
server runs ``init_server()`` and ``run_server()`` (blocks until a trainer
stops it).
"""

from __future__ import annotations

import os
from typing import List, Optional

from .env import Env, init_parallel_env
from .transpiler import GradAllReduce, LocalSGD

class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints: List[str] = []
        self._server_endpoints: List[str] = []
        self._role = Role.WORKER
        self._current_id = 0

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def is_first_worker(self) -> bool:
        return self.is_worker() and self._current_id == 0

    def worker_index(self) -> int:
        return self._current_id

    def server_index(self) -> int:
        return self._current_id

    def worker_num(self) -> int:
        return max(1, len(self._worker_endpoints))

    def server_num(self) -> int:
        return len(self._server_endpoints)

    def get_trainer_endpoints(self) -> List[str]:
        return self._worker_endpoints

    def get_pserver_endpoints(self) -> List[str]:
        return self._server_endpoints

    def get_current_endpoint(self) -> str:
        """This process's own endpoint (ref role_maker get_current_endpoint):
        a server serves its slot of the pserver list; a worker reports its
        trainer endpoint."""
        eps = self._server_endpoints if self.is_server() \
            else self._worker_endpoints
        if not eps:
            return ""
        return eps[min(self._current_id, len(eps) - 1)]

    def generate_role(self):
        pass


class PaddleCloudRoleMaker(RoleMakerBase):
    """Env-var role maker (ref role_maker.py PaddleCloudRoleMaker): reads
    the ``PADDLE_*`` contract of the launchers (``launch``, ``launch_ps``)."""

    def __init__(self, is_collective: bool = False):
        super().__init__()
        self._is_collective = is_collective

    def generate_role(self):
        env = Env()
        training_role = os.getenv("TRAINING_ROLE", "TRAINER")
        if training_role == "PSERVER" and not self._is_collective:
            self._role = Role.SERVER
            self._current_id = int(os.getenv("PADDLE_PSERVER_ID", "0"))
            eps = os.getenv("PADDLE_PSERVER_ENDPOINTS", "")
            self._server_endpoints = eps.split(",") if eps else []
            # servers must still know the trainer count (sync Fanin)
            teps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
            self._worker_endpoints = teps.split(",") if teps else \
                [""] * int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        else:
            self._role = Role.WORKER
            self._current_id = env.rank
            self._worker_endpoints = env.trainer_endpoints or \
                ["127.0.0.1:6174"]
            eps = os.getenv("PADDLE_PSERVER_ENDPOINTS", "")
            self._server_endpoints = eps.split(",") if eps else []


class UserDefinedRoleMaker(RoleMakerBase):
    """ref role_maker.py UserDefinedRoleMaker."""

    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None, worker_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._server_endpoints = server_endpoints or []
        self._worker_endpoints = worker_endpoints or \
            [f"127.0.0.1:{6170 + i}" for i in range(worker_num)]


class DistributedStrategy:
    """ref ``incubate/fleet/collective/__init__.py:94``.  ``nccl_comm_num``
    sets the transpiler's ring count; the other knobs are kept for the
    API (one process, one stream)."""

    def __init__(self):
        self.mode = "collective"          # or "local_sgd"
        self.nccl_comm_num = 1
        self.use_local_sgd = False
        self.local_sgd_steps = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.fuse_all_reduce_ops = True
        self.forward_recompute = False
        self.recompute_checkpoints = []


class Fleet:
    """Singleton facade (ref fleet_base.py:38 Fleet)."""

    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._is_initialized = False
        self._strategy: Optional[DistributedStrategy] = None

    # -- lifecycle -----------------------------------------------------------
    def init(self, role_maker: Optional[RoleMakerBase] = None):
        self._role_maker = role_maker or \
            PaddleCloudRoleMaker(is_collective=True)
        self._role_maker.generate_role()
        if self._role_maker.is_worker() and self._role_maker.worker_num() > 1:
            # one process needs nothing; several bring up
            # torch.distributed
            init_parallel_env()
        self._is_initialized = True

    def _assert_init(self):
        if not self._is_initialized:
            raise RuntimeError("call fleet.init(role_maker) first "
                               "(ref fleet_base.py:268)")

    # -- role queries ---------------------------------------------------------
    def is_worker(self):
        self._assert_init()
        return self._role_maker.is_worker()

    def is_server(self):
        self._assert_init()
        return self._role_maker.is_server()

    def is_first_worker(self):
        self._assert_init()
        return self._role_maker.is_first_worker()

    def worker_index(self):
        self._assert_init()
        return self._role_maker.worker_index()

    def worker_num(self):
        self._assert_init()
        return self._role_maker.worker_num()

    def server_num(self):
        self._assert_init()
        return self._role_maker.server_num()

    def worker_endpoints(self, to_string=False):
        self._assert_init()
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        self._assert_init()
        eps = self._role_maker.get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    # -- training surface ------------------------------------------------------
    def distributed_optimizer(self, optimizer,
                              strategy: Optional[DistributedStrategy] = None):
        self._assert_init()
        self._strategy = strategy or DistributedStrategy()
        return CollectiveOptimizer(optimizer, self._strategy, self)

    def init_worker(self):
        pass

    def init_server(self, *args, **kwargs):
        pass

    def run_server(self):
        raise RuntimeError("collective fleet has no servers; use the "
                           "parameter-server fleet for PS mode")

    def stop_worker(self):
        pass

    def barrier_worker(self):
        """Every rank of a one-process dp mesh is in this process: nothing
        to wait for.  Several processes raise until the multi-process
        slice."""
        if Env().world_size > 1:
            init_parallel_env()

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        from .. import io
        return io.save_inference_model(dirname, feeded_var_names,
                                       target_vars, executor,
                                       main_program=main_program)

    def save_persistables(self, executor, dirname, main_program=None):
        from .. import io
        return io.save_persistables(executor, dirname,
                                    main_program=main_program)


class CollectiveOptimizer:
    """ref ``incubate/fleet/collective/__init__.py:140``: wraps an
    optimizer; ``minimize`` then rewrites the program with the collective
    transpiler for data parallelism."""

    def __init__(self, optimizer, strategy, fleet_: Fleet):
        self._optimizer = optimizer
        self._strategy = strategy
        self._fleet = fleet_

    def backward(self, *args, **kwargs):
        return self._optimizer.backward(*args, **kwargs)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        optimize_ops, params_grads = self._optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        f = self._fleet
        nranks = f.worker_num()
        if nranks > 1:
            eps = f.worker_endpoints()
            current = eps[f.worker_index()] if f.worker_index() < len(eps) \
                else eps[0]
            cls = LocalSGD if (self._strategy.use_local_sgd or
                               self._strategy.mode == "local_sgd") \
                else GradAllReduce
            cls(self._strategy.nccl_comm_num).transpile(
                startup_program=startup_program,
                main_program=loss.block.program if hasattr(loss, "block")
                else None,
                rank=f.worker_index(), endpoints=",".join(eps),
                current_endpoint=current)
        return optimize_ops, params_grads


fleet = Fleet()


# ---------------------------------------------------------------------------
# parameter-server fleet (ref incubate/fleet/parameter_server/
# distribute_transpiler/__init__.py DistributedTranspiler fleet)
# ---------------------------------------------------------------------------

class TranspilerOptimizer:
    """ref parameter_server/distribute_transpiler __init__.py
    TranspilerOptimizer: minimize() then transpile for PS."""

    def __init__(self, optimizer, strategy, fleet):
        self._optimizer = optimizer
        self._strategy = strategy
        self._fleet = fleet

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self._optimizer.minimize(loss, startup_program,
                                          parameter_list, no_grad_set)
        from .ps import DistributeTranspiler, DistributeTranspilerConfig
        cfg = self._strategy if isinstance(
            self._strategy, DistributeTranspilerConfig) else None
        t = DistributeTranspiler(cfg)
        f = self._fleet
        t.transpile(trainer_id=max(f.worker_index(), 0),
                    pservers=f.server_endpoints(to_string=True),
                    trainers=max(f.worker_num(), 1))
        f._transpiler = t
        if f.is_server():
            ep = f._role_maker.get_current_endpoint()
            f._main_program, f._startup_program = t.get_pserver_programs(ep)
        else:
            f._main_program = t.get_trainer_program()
            from ..framework import core
            f._startup_program = core.default_startup_program()
        return result


class PSFleet(Fleet):
    """PS-mode fleet facade: workers train with send/recv programs, servers
    block in run_server() (ref fleet_base + PS fleet impls).  A server's
    executor runs on the host: the tables live there."""

    def __init__(self):
        super().__init__()
        self._transpiler = None
        self._main_program = None
        self._startup_program = None

    def init(self, role_maker: Optional[RoleMakerBase] = None):
        # PS trainers are independent processes wired by the RPC plane,
        # not a torch.distributed group (ref: the PS fleet never runs
        # gen_nccl_id; that bootstrap belongs to collective mode)
        self._role_maker = role_maker or PaddleCloudRoleMaker()
        self._role_maker.generate_role()
        self._is_initialized = True

    @property
    def main_program(self):
        return self._main_program

    @property
    def startup_program(self):
        return self._startup_program

    def distributed_optimizer(self, optimizer, strategy=None):
        self._assert_init()
        self._strategy = strategy
        return TranspilerOptimizer(optimizer, strategy, self)

    def _server_executor(self):
        from ..framework import Executor
        from ..place import CPUPlace
        return Executor(CPUPlace())

    def init_server(self, *args, **kwargs):
        self._server_executor().run(self._startup_program)

    def run_server(self):
        self._server_executor().run(self._main_program)   # blocks until STOP

    def stop_worker(self):
        from . import ps as ps_mod
        if self._transpiler is not None:
            for ep in self._transpiler.eps:
                try:
                    ps_mod.get_client(ep).barrier()
                except Exception:
                    pass
        ps_mod.reset_clients()


ps_fleet = PSFleet()
