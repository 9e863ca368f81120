"""The trainer environment (the port of ``paddle_tpu/distributed/env.py:31-56``;
ref ``python/paddle/distributed/launch.py:147-281``).

:class:`Env` reads the launcher's contract: ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_TRAINER_ENDPOINTS`` and the selected device.  One process runs
every rank of a ``dp`` mesh (the executor's collective mode over virtual
ranks or the visible cards); bringing up several processes
(:func:`init_parallel_env` on ``torch.distributed``) and the gang
checkpoint rendezvous (:class:`GangRendezvous`) come with the
multi-process slice.
"""

from __future__ import annotations

import os
from typing import List, Optional

_MULTI_PROCESS = ("the multi-process slice (init_parallel_env on "
                  "torch.distributed, launch.py, the gang coordinator)")


class Env:
    """Parsed trainer environment (≈ dygraph/parallel.py Env)."""

    def __init__(self):
        self.rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self.world_size = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self.current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints: List[str] = eps.split(",") if eps else []

    @property
    def dev_id(self) -> int:
        return int(os.getenv("FLAGS_selected_tpus",
                             os.getenv("FLAGS_selected_gpus", "0")))


def get_rank() -> int:
    return Env().rank


def get_world_size() -> int:
    return Env().world_size


def init_parallel_env(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None) -> Env:
    """A single-process run has nothing to bring up and returns its
    :class:`Env`, as the reference does; more than one process raises
    ``NotImplementedError`` until the multi-process slice."""
    env = Env()
    n = num_processes if num_processes is not None else env.world_size
    if n <= 1:
        return env
    raise NotImplementedError(
        f"init_parallel_env for {n} processes comes with {_MULTI_PROCESS}; "
        "one process runs a dp mesh of ranks (parallel.set_mesh)")


class GangRendezvous:
    """The gang checkpoint rendezvous (ref env.py:61): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"GangRendezvous comes with {_MULTI_PROCESS}")

    @classmethod
    def from_env(cls):
        raise NotImplementedError(
            f"GangRendezvous comes with {_MULTI_PROCESS}")
