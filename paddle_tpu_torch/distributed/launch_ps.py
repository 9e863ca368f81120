"""Parameter-server job launcher:
``python -m paddle_tpu_torch.distributed.launch_ps train.py``.

The port of ``paddle_tpu/distributed/launch_ps.py`` (ref
``python/paddle/distributed/launch_ps.py``): spawns ``--server_num``
pserver processes and ``--worker_num`` trainer processes on this node with
the PS env contract (``TRAINING_ROLE``, ``PADDLE_PSERVER_ID`` /
``PADDLE_TRAINER_ID``, ``PADDLE_PSERVER_ENDPOINTS``,
``PADDLE_TRAINERS_NUM``), writes each process's log to
``<log_dir>/server.<i>.log`` / ``worker.<i>.log``, and tears the gang down
if any process fails (``launch.start_procs`` / ``launch.wait_procs``).  The
training script uses ``paddle_tpu_torch.distributed.ps_fleet`` to pick its
role from the env.
"""

from __future__ import annotations

import argparse

from .launch import start_procs, wait_procs


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="paddle_tpu_torch PS launcher (ref launch_ps.py)")
    p.add_argument("--server_num", type=int, default=2)
    p.add_argument("--worker_num", type=int, default=2)
    p.add_argument("--servers", default=None,
                   help="comma-separated server endpoints (overrides "
                        "--server_num, for multi-node jobs)")
    p.add_argument("--workers", default=None,
                   help="comma-separated worker endpoints")
    p.add_argument("--started_port", type=int, default=6270)
    p.add_argument("--log_dir", default=None)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def get_ps_cluster_env(args):
    """Per-process env dicts: servers first, then workers."""
    if args.servers:
        server_eps = args.servers.split(",")
    else:
        server_eps = [f"127.0.0.1:{args.started_port + i}"
                      for i in range(args.server_num)]
    if args.workers:
        worker_eps = args.workers.split(",")
    else:
        worker_eps = [f"127.0.0.1:{args.started_port + 1000 + i}"
                      for i in range(args.worker_num)]
    common = {
        "PADDLE_PSERVER_ENDPOINTS": ",".join(server_eps),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(worker_eps),
        "PADDLE_TRAINERS_NUM": str(len(worker_eps)),
    }
    envs = []
    for i in range(len(server_eps)):
        envs.append(dict(common, TRAINING_ROLE="PSERVER",
                         PADDLE_PSERVER_ID=str(i),
                         PADDLE_CURRENT_ENDPOINT=server_eps[i],
                         PADDLE_TRAINER_ID=str(i),
                         PADDLE_LOG_NAME=f"server.{i}"))
    for i in range(len(worker_eps)):
        envs.append(dict(common, TRAINING_ROLE="TRAINER",
                         PADDLE_TRAINER_ID=str(i),
                         PADDLE_CURRENT_ENDPOINT=worker_eps[i],
                         PADDLE_LOG_NAME=f"worker.{i}"))
    return envs


def launch(argv=None):
    args = _parse_args(argv)
    envs = get_ps_cluster_env(args)
    procs, logs = start_procs(args, envs)
    try:
        wait_procs(procs)
    finally:
        for f in logs:
            f.close()


if __name__ == "__main__":
    launch()
