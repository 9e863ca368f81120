"""Distributed training (the port of ``paddle_tpu.distributed``).

- ``c_*`` collective ops (:mod:`collective_ops`), run by the executor's
  collective mode over the ``dp`` ranks of the current mesh;
- the transpilers ``GradAllReduce`` / ``LocalSGD`` (:mod:`transpiler`);
- the fleet facade's collective half (:mod:`fleet`) and the trainer
  environment (:mod:`env`);
- the gang coordinator's frame protocol (:mod:`coordinator`:
  ``send_frame`` / ``recv_frame``), which the serving fleet speaks.

Not ported yet: several processes (``init_parallel_env``, the launcher,
the coordinator and ``GangRendezvous``: the multi-process slice) and the
parameter server (the PS slice).
"""

from . import collective_ops  # noqa  (registers the c_* lowerings)
from .coordinator import MAX_FRAME_BYTES, recv_frame, send_frame  # noqa
from .env import (Env, GangRendezvous, get_rank,  # noqa
                  get_world_size, init_parallel_env)
from .fleet import (CollectiveOptimizer, DistributedStrategy,  # noqa
                    PaddleCloudRoleMaker, UserDefinedRoleMaker, fleet)
from .transpiler import GradAllReduce, LocalSGD  # noqa
