"""The elastic gang drill: kill -9 a rank, the launcher respawns it, the
gang reconverges with an exact loss trajectory (the port of
``tools/gang_smoke.py``)::

    python -m paddle_tpu_torch.tools.gang_smoke [--size linreg|tiny|full2]
        [--cpu] [--total 16] [--kill-step 5]

Through the port's launcher (``python -m paddle_tpu_torch.distributed.
launch --nproc_per_node 2 --max_restarts 1``) and ``tools/gang_runner.py``:

1. two socket-backend ranks train with a ``CheckpointDaemon`` committing
   every 2 steps, while an uninterrupted single-rank child (no gang, the
   same seed and batches) trains the baseline beside them;
2. rank 1 SIGKILLs itself at the top of step ``--kill-step``
   (``GANG_SELF_KILL``); the coordinator the launcher hosts declares it
   dead after the heartbeat timeout;
3. rank 0 sees the gang degraded, drains, and parks at the rejoin barrier
   (``GANG_DEGRADED dead=[1]``, ``GANG_READY 1``);
4. the launcher respawns rank 1, which resumes from the gang manifest step
   and re-admits itself; both ranks finish.

Gates: the launcher exits 0 and respawned once; the survivor parked and
resumed; rank 1's second life resumed at a step in (0, kill step]; each
rank's per-step losses (rank 1's two lives joined) equal the baseline's
bit for bit.  :func:`drill` returns what it saw (the losses, the resume
step, the drill's wall time, the children's ``DONE`` records); the last
line of ``main`` is
``GANG SMOKE OK {json}``.  Children run on the card unless ``--cpu`` (the
``linreg`` size always runs on the host).
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RUNNER = os.path.join(REPO, "paddle_tpu_torch", "tools", "gang_runner.py")


def losses(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("STEP "):
            _, i, _, v = line.split()
            out[int(i)] = v
    return out


def _done(text):
    got = [ln for ln in text.splitlines() if ln.startswith("DONE ")]
    return [json.loads(ln[len("DONE "):]) for ln in got]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gang_env(extra=None):
    """The drill's environment: the repo importable, no inherited gang,
    fast heartbeats."""
    env = dict(os.environ)
    for k in ("FLAGS_fault_inject", "PADDLE_GANG_DIR", "PADDLE_GANG_COORD",
              "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT"):
        env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({"GANG_CKPT_INTERVAL": "2", "GANG_SYNC_COMMITS": "1",
                "FLAGS_gang_heartbeat_interval_s": "0.15",
                "FLAGS_gang_heartbeat_timeout_s": "1.2",
                "FLAGS_gang_rejoin_timeout_s": "120"})
    env.update(extra or {})
    return env


def drill(size="linreg", cpu=True, total=16, kill_step=5, pause=0.3,
          timeout=420.0, env=None) -> dict:
    """Run the drill (module docstring); raises ``AssertionError`` naming
    the failed gate, with the children's logs."""
    size_args = ["--size", size] + (["--cpu"] if cpu else [])
    base_env = gang_env(env)
    with tempfile.TemporaryDirectory(prefix="pt_gang_smoke_") as tmp:
        log_dir = os.path.join(tmp, "logs")
        t0 = time.perf_counter()
        base = subprocess.Popen(
            [sys.executable, RUNNER, os.path.join(tmp, "base"), str(total),
             os.path.join(tmp, "pb")] + size_args,
            env=dict(base_env, PADDLE_TRAINERS_NUM="1"), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            r = subprocess.run(
                [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                 "--nproc_per_node", "2", "--started_port",
                 str(free_port()), "--log_dir", log_dir,
                 "--max_restarts", "1", "--grace_secs", "60",
                 RUNNER, os.path.join(tmp, "ckpt"), str(total),
                 os.path.join(tmp, "prog"), str(pause)] + size_args,
                env=dict(base_env, GANG_SELF_KILL=f"1:{kill_step}"),
                cwd=REPO, capture_output=True, text=True, timeout=timeout)
            gang_s = time.perf_counter() - t0
            b_out, b_err = base.communicate(timeout=timeout)
        finally:
            if base.poll() is None:
                base.kill()
                base.wait()
        logs = [open(os.path.join(log_dir, f"worker.{i}.log")).read()
                if os.path.exists(os.path.join(log_dir, f"worker.{i}.log"))
                else "" for i in (0, 1)]
    out0, out1 = logs
    dbg = (f"launcher rc={r.returncode}\n--- launcher stderr ---\n"
           f"{r.stderr[-4000:]}\n--- worker.0 ---\n{out0[-4000:]}\n"
           f"--- worker.1 ---\n{out1[-4000:]}\n--- baseline rc="
           f"{base.returncode} ---\n{b_err[-2000:]}")

    def gate(cond, what):
        if not cond:
            raise AssertionError(f"gang drill: {what}\n{dbg}")

    gate(base.returncode == 0, "the baseline child failed")
    gate(r.returncode == 0, "the launcher did not exit 0")
    gate("respawning" in r.stderr, "the launcher never respawned rank 1")
    gate(f"SELF_KILL {kill_step}" in out1, "rank 1 never SIGKILLed itself")
    gate("GANG_BACKEND socket" in out0, "the ranks did not use sockets")
    gate("GANG_DEGRADED dead=[1]" in out0,
         "the survivor never saw the gang degraded")
    gate("GANG_READY 1" in out0, "the survivor never reconverged")
    resumes = [int(x.split()[1]) for x in out1.splitlines()
               if x.startswith("RESUMED_AT ")]
    gate(len(resumes) == 2, "rank 1 did not live exactly twice")
    gate(0 < resumes[1] <= kill_step,
         f"the respawned rank resumed at {resumes[1]}, past its kill step "
         f"{kill_step}")
    want = losses(b_out)
    gate(sorted(want) == list(range(total)), "the baseline has step gaps")
    got = {0: losses(out0), 1: losses(out1)}
    for rank, l in got.items():
        gate(sorted(l) == list(range(total)), f"rank {rank} has step gaps")
        bad = [i for i in range(total) if l[i] != want[i]]
        gate(not bad, f"rank {rank}'s losses differ from the baseline's at "
             f"steps {bad}")
    return {"total": total, "kill_step": kill_step, "resumed_at": resumes[1],
            "losses": [want[i] for i in range(total)],
            "wall_s": gang_s, "baseline": _done(b_out),
            "rank0": _done(out0), "rank1": _done(out1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="linreg",
                    choices=("linreg", "tiny", "full2"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--total", type=int, default=16)
    ap.add_argument("--kill-step", type=int, default=5)
    args = ap.parse_args(argv)
    out = drill(args.size, args.cpu or args.size == "linreg", args.total,
                args.kill_step)
    print(f"gang smoke OK: rank 1 kill -9 at step {out['kill_step']}, "
          f"respawned and resumed at {out['resumed_at']}, the survivor "
          f"parked and resumed, {out['total']} steps equal to the baseline "
          f"bit for bit on both ranks")
    print("GANG SMOKE OK " + json.dumps(out))


if __name__ == "__main__":
    main()
