"""Distributed training (the port of ``paddle_tpu.distributed``).

- ``c_*`` collective ops (:mod:`collective_ops`), run by the executor's
  collective mode over the ``dp`` ranks of the current mesh;
- the transpilers ``GradAllReduce`` / ``LocalSGD`` (:mod:`transpiler`);
- the fleet facade's collective half (:mod:`fleet`) and the trainer
  environment (:mod:`env`);
- several processes: :func:`init_parallel_env` (``torch.distributed``,
  gloo), the exchange between the processes of a mesh (:mod:`xproc`), the
  launcher (``python -m paddle_tpu_torch.distributed.launch``), and the
  gang: :class:`GangRendezvous` (the file rendezvous) and the socket
  coordinator and client (:mod:`coordinator`), whose frame protocol the
  serving fleet speaks too;
- the parameter server (:mod:`ps`): the ``send`` / ``recv`` /
  ``distributed_lookup_table`` / barrier / ``listen_and_serv`` ops over the
  port's own C++ KV server and client, ``DistributeTranspiler`` and the
  async and geo communicators; the PS fleet (``ps_fleet``), the PS launcher
  (``python -m paddle_tpu_torch.distributed.launch_ps``) and the legacy
  Downpour API (:mod:`downpour`).

Pipeline parallelism lives in ``parallel.pipeline`` and mixture of experts
in ``ops.moe_ops`` (its ``ep`` axis in ``parallel.spmd``).  Not ported yet:
NCCL (every cross-process exchange goes through gloo).
"""

from . import collective_ops  # noqa  (registers the c_* lowerings)
from . import ps  # noqa  (registers send/recv/listen_and_serv lowerings)
from .ps import (Communicator, DistributeTranspiler,  # noqa
                 DistributeTranspilerConfig, GeoCommunicator)
from .coordinator import (MAX_FRAME_BYTES, GangClient,  # noqa
                          GangCoordinator, GangDegradedError,
                          GangFingerprintError, recv_frame, send_frame)
from .env import (Env, GangRendezvous, get_rank,  # noqa
                  get_world_size, init_parallel_env)
from .fleet import (CollectiveOptimizer, DistributedStrategy,  # noqa
                    PaddleCloudRoleMaker, PSFleet, TranspilerOptimizer,
                    UserDefinedRoleMaker, fleet, ps_fleet)
from .transpiler import GradAllReduce, LocalSGD  # noqa
from . import downpour  # noqa  (legacy Downpour PS python API)
