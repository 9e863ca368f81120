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
  serving fleet speaks too.

Not ported yet: the parameter server, pipeline and MoE (ROADMAP Queue 1
item 3 (iii)), and NCCL (every cross-process exchange goes through gloo).
"""

from . import collective_ops  # noqa  (registers the c_* lowerings)
from .coordinator import (MAX_FRAME_BYTES, GangClient,  # noqa
                          GangCoordinator, GangDegradedError,
                          GangFingerprintError, recv_frame, send_frame)
from .env import (Env, GangRendezvous, get_rank,  # noqa
                  get_world_size, init_parallel_env)
from .fleet import (CollectiveOptimizer, DistributedStrategy,  # noqa
                    PaddleCloudRoleMaker, UserDefinedRoleMaker, fleet)
from .transpiler import GradAllReduce, LocalSGD  # noqa
