"""The trainer environment and the multi-process bootstrap (the port of
``paddle_tpu/distributed/env.py``; ref ``python/paddle/distributed/
launch.py:147-281`` and ``operators/collective/c_gen_nccl_id_op.cc``).

:class:`Env` reads the launcher's contract: ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_TRAINER_ENDPOINTS`` and the selected device
(``FLAGS_selected_gpus``).

:func:`init_parallel_env` brings up ``torch.distributed`` for several
processes: the ``gloo`` backend, its TCP rendezvous at rank 0's endpoint
(``trainer_endpoints[0]``, the reference's coordination address), a finite
timeout for the rendezvous and every exchange after it.  The cross-process
exchange goes through host memory: two processes that share one card
cannot form an NCCL communicator (NCCL refuses two ranks on one device),
and gloo runs wherever torch does.  It is idempotent, a no-op for one
process, and the process group is destroyed at exit.  After it, the
meshes of ``parallel.mesh`` span the processes.

This module also hosts :class:`GangRendezvous`, the file-based rank
rendezvous behind gang checkpoint commits: every rank announces the steps
it has durably checkpointed, and the rank-0 leader publishes a
``COMMITTED <step>`` manifest only when the whole gang agrees: the unit of
recovery is the gang, never a single rank (a torn multi-process save is
refused at resume).  The launcher exports ``PADDLE_GANG_DIR`` so that all
ranks of one job rendezvous in one directory, and ``PADDLE_GANG_COORD``
for the socket backend (``coordinator.GangClient``, same API).
"""

from __future__ import annotations

import atexit
import datetime
import json
import os
import time
from typing import Dict, List, Optional

#: the rendezvous's and every exchange's default time limit: a dead peer
#: ends in an error, never in a hang
DEFAULT_TIMEOUT_S = 300.0


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


_initialized = False


def _shutdown() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def init_parallel_env(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> Env:
    """Bring up the multi-process runtime (≈ c_gen_nccl_id + c_comm_init):
    ``torch.distributed.init_process_group("gloo")`` with its TCP
    rendezvous at ``coordinator_address`` (rank 0's endpoint by default),
    ``num_processes`` ranks and this process as ``process_id`` (the
    launcher's environment by default).  Every wait of the group, the
    rendezvous included, ends after ``timeout_s``.  No-op for one process
    and on a second call."""
    global _initialized
    env = Env()
    if _initialized:
        return env
    n = num_processes if num_processes is not None else env.world_size
    if n <= 1:
        _initialized = True
        return env
    import torch.distributed as dist
    address = coordinator_address or (
        env.trainer_endpoints[0] if env.trainer_endpoints else None)
    if not address:
        raise ValueError("init_parallel_env: no coordinator address (pass "
                         "one, or launch with PADDLE_TRAINER_ENDPOINTS)")
    rank = process_id if process_id is not None else env.rank
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{address}", world_size=int(n),
            rank=int(rank),
            timeout=datetime.timedelta(seconds=float(timeout_s)))
        atexit.register(_shutdown)
    _initialized = True
    return env


def is_multiprocess() -> bool:
    """True after :func:`init_parallel_env` brought up more than one
    process."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def process_index() -> int:
    """This process's rank in the process group (0 without one)."""
    import torch.distributed as dist
    return int(dist.get_rank()) if is_multiprocess() else 0


def process_count() -> int:
    import torch.distributed as dist
    return int(dist.get_world_size()) if is_multiprocess() else 1


# ---------------------------------------------------------------------------
# gang-commit rendezvous (file-based; see module docstring)
# ---------------------------------------------------------------------------

#: from_env's socket-backend client cache: {(address, rank): GangClient}
_SOCKET_CLIENTS: Dict[tuple, object] = {}


def format_manifest(step: int, world_size: int) -> str:
    """The ``COMMITTED <step>`` manifest body: a strict first line the
    parser keys on, plus a JSON metadata line for humans and tooling."""
    meta = {"world_size": int(world_size),
            "time": time.strftime("%Y-%m-%dT%H:%M:%S")}
    return f"COMMITTED {int(step)}\n{json.dumps(meta, sort_keys=True)}\n"


def parse_manifest(text: str) -> int:
    """A manifest body's committed step.  Strict: anything that is not a
    well-formed ``COMMITTED <step>`` first line raises ``ValueError`` (a
    truncated or corrupted manifest reads as "no commit", never as a
    guessed step)."""
    lines = (text or "").splitlines()
    if not lines:
        raise ValueError("empty gang manifest")
    parts = lines[0].split()
    if len(parts) != 2 or parts[0] != "COMMITTED":
        raise ValueError(
            f"malformed gang manifest first line: {lines[0]!r} "
            "(expected 'COMMITTED <step>')")
    try:
        step = int(parts[1])
    except ValueError:
        raise ValueError(
            f"malformed gang manifest step: {parts[1]!r}") from None
    if step < 0:
        raise ValueError(f"gang manifest step {step} is negative")
    return step


def _atomic_write(path: str, body: str) -> None:
    """fsync'd atomic publish: stage to a temp sibling, fsync the file,
    rename over the target, fsync the directory: a reader never sees a
    half-written file and the rename survives a crash."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(body)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    from ..io import _fsync_dir
    _fsync_dir(os.path.dirname(path) or ".")


class GangRendezvous:
    """File-based gang checkpoint-commit barrier.

    Layout under ``base_dir``::

        rank_0, rank_1, ...   per-rank announcements (JSON: the rank's
                              latest durably committed step and every step
                              it still holds)
        MANIFEST              'COMMITTED <step>', published by rank 0 only
                              when every rank holds that step

    Every write is an fsync'd atomic rename, so a reader (the resume path,
    the leader's poll) sees the previous or the new content, never a torn
    file.  A rank dying mid-save never announces, and the manifest stays
    at the last step the whole gang agreed on.
    """

    MANIFEST_NAME = "MANIFEST"
    backend = "file"

    def __init__(self, base_dir: str, rank: Optional[int] = None,
                 world_size: Optional[int] = None):
        env = Env()
        self.base_dir = os.path.abspath(base_dir)
        self.rank = env.rank if rank is None else int(rank)
        self.world_size = env.world_size if world_size is None \
            else int(world_size)
        os.makedirs(self.base_dir, exist_ok=True)

    @classmethod
    def from_env(cls) -> Optional["GangRendezvous"]:
        """The launcher's contract as a backend factory: with
        ``PADDLE_GANG_COORD`` (host:port[,host:port]) set, the socket
        coordinator's ``GangClient`` (one a coordinator and rank in this
        process, heartbeating); else ``PADDLE_GANG_DIR`` selects the file
        backend; a single-rank run gets None.  An unreachable coordinator
        raises after a short retry: one rank quietly on another backend
        would split the gang's coordination plane."""
        if Env().world_size <= 1:
            return None
        coord = os.getenv("PADDLE_GANG_COORD", "")
        base = os.getenv("PADDLE_GANG_DIR", "")
        if coord:
            from .coordinator import GangClient
            key = (coord, Env().rank)
            cached = _SOCKET_CLIENTS.get(key)
            if cached is not None and not cached._hb_stop.is_set():
                return cached
            last: Optional[BaseException] = None
            for delay in (0.0, 0.5, 1.5):    # brief connect retry
                if delay:
                    time.sleep(delay)
                try:
                    client = GangClient(coord).connect().start_heartbeat()
                    _SOCKET_CLIENTS[key] = client
                    return client
                except (OSError, ConnectionError) as e:
                    last = e
            raise ConnectionError(
                f"gang coordinator at {coord} unreachable after "
                f"retries: {last} (PADDLE_GANG_COORD was exported for "
                "the whole gang: refusing to silently split the "
                "coordination plane; unset it to use the file "
                "rendezvous)") from last
        if not base:
            return None
        return cls(base)

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.base_dir, self.MANIFEST_NAME)

    def _rank_path(self, rank: int) -> str:
        return os.path.join(self.base_dir, f"rank_{int(rank)}")

    # -- announcements -------------------------------------------------------
    def announce(self, step: int, steps=None) -> None:
        """Publish this rank's latest durably committed checkpoint step
        (and every step it still holds, so that the leader can pick a
        commit point every rank can restore)."""
        body = json.dumps({
            "rank": self.rank,
            "step": int(step),
            "steps": sorted(int(s) for s in (steps or [step])),
            "pid": os.getpid(),
        }, sort_keys=True)
        _atomic_write(self._rank_path(self.rank), body + "\n")

    def peer_announcements(self) -> Dict[int, dict]:
        """Every rank's announcement; a malformed or missing file is
        absent (a rank mid-write or dead has not announced)."""
        out: Dict[int, dict] = {}
        for r in range(self.world_size):
            try:
                with open(self._rank_path(r)) as f:
                    d = json.loads(f.read())
                out[int(d["rank"])] = {
                    "step": int(d["step"]),
                    "steps": [int(s) for s in d.get("steps", [d["step"]])],
                }
            except (OSError, ValueError, KeyError, TypeError):
                continue
        return out

    # -- manifest ------------------------------------------------------------
    def committed_step(self) -> Optional[int]:
        """The gang's last committed step, or None with no (or a corrupt)
        manifest: corruption reads as 'nothing committed'."""
        try:
            with open(self.manifest_path) as f:
                return parse_manifest(f.read())
        except OSError:
            return None
        except ValueError:
            import warnings
            warnings.warn(
                f"gang manifest {self.manifest_path} is corrupt; treating "
                "as no committed checkpoint")
            return None

    def publish(self, step: int) -> None:
        """Leader only: atomically publish ``COMMITTED <step>``."""
        if not self.is_leader:
            raise RuntimeError(
                f"rank {self.rank} tried to publish the gang manifest; "
                "only rank 0 commits")
        _atomic_write(self.manifest_path,
                      format_manifest(step, self.world_size))

    # -- commit protocols ----------------------------------------------------
    def commit_latest(self) -> Optional[int]:
        """Leader, non-blocking (the steady cadence): publish the newest
        step every rank has durably committed and still holds, if it
        advances the manifest.  Returns the published step or None."""
        if not self.is_leader:
            return None
        anns = self.peer_announcements()
        if len(anns) < self.world_size:
            return None
        common = set(anns[0]["steps"]) if 0 in anns else set()
        for d in anns.values():
            common &= set(d["steps"])
        if not common:
            return None
        best = max(common)
        cur = self.committed_step()
        if cur is not None and best <= cur:
            return None
        self.publish(best)
        return best

    def wait_commit(self, step: int, timeout_s: float,
                    poll_s: float = 0.05) -> bool:
        """Leader, blocking (the emergency barrier): wait until every
        rank's latest announced step equals ``step``, then publish it.
        Ranks that disagree mean the gang tore, and the manifest stays at
        the previous agreed step."""
        if not self.is_leader:
            raise RuntimeError("wait_commit is leader-only; other ranks "
                               "just announce and exit")
        deadline = time.monotonic() + float(timeout_s)
        while True:
            anns = self.peer_announcements()
            if len(anns) == self.world_size and \
                    all(d["step"] == int(step) for d in anns.values()):
                self.publish(step)
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    def wait_manifest(self, step: int, timeout_s: float,
                      poll_s: float = 0.05) -> bool:
        """Any rank: wait until the manifest commits ``step`` (or newer)."""
        deadline = time.monotonic() + float(timeout_s)
        while True:
            cur = self.committed_step()
            if cur is not None and cur >= int(step):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)
