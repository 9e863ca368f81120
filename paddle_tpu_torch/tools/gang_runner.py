"""One rank of a checkpointing gang (the port of
``tests/gang_train_runner.py``).

The rank trains a deterministic model with a background
:class:`~paddle_tpu_torch.resilience.CheckpointDaemon` committing every
``GANG_CKPT_INTERVAL`` steps and announcing to the gang
(``GangRendezvous.from_env``: the socket coordinator the launcher hosts,
or the file rendezvous); the rank-0 leader publishes the ``COMMITTED``
manifest.  Every rank trains the same model on the same batches (no
collective), so every rank's losses equal one uninterrupted rank's::

    python paddle_tpu_torch/tools/gang_runner.py CKPT_ROOT TOTAL_STEPS \\
        PROGRESS_FILE [SLEEP_PER_STEP] [--size linreg|tiny|full2] [--cpu]

``linreg`` is the reference runner's linear regression (Adam 0.05, batch
8 x 4); ``tiny`` and ``full2`` are ``tools/preempt_runner.py``'s GPTs
(``full2``: BERT-base width cut to 2 layers, batch 8 x 2048, on the card).
It prints ``STEP <i> LOSS <repr>`` a step (repr round-trips float32) and
appends each completed step to ``<PROGRESS_FILE>.r<rank>``; the last line
of a clean run is ``DONE {json}`` (the flash kernels' float32 launches,
the step times, the peak memory).

The environment, as the reference runner's: ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` / ``PADDLE_GANG_DIR`` / ``PADDLE_GANG_COORD``
(each rank checkpoints into ``CKPT_ROOT/rank_<id>``),
``GANG_CKPT_INTERVAL`` (default 2), ``GANG_SYNC_COMMITS`` (wait for each
cadence commit, so the committed steps do not depend on timing),
``GANG_SELF_KILL=RANK:STEP`` (rank RANK SIGKILLs itself at the top of
step STEP, once per CKPT_ROOT: the elastic drill under ``launch.py
--max_restarts``), ``GANG_EMERGENCY_HANG=1`` (a preempted rank's
emergency write hangs, for a kill mid-save), ``GANG_AVOID_MULTIPLE=N``
(run past a preemption until the completed steps are not a multiple of
N), ``GANG_FP_OVERRIDE`` (the collective fingerprint to report).

On the socket backend every step updates the heartbeat's progress; when a
peer dies the rank drains, prints ``GANG_DEGRADED dead=[...]``, parks in
``wait_ready`` until the launcher respawns the peer, and prints
``GANG_READY 1``.  On SIGTERM the guard drains, commits the last complete
step, announces it and (rank 0) runs the gang barrier; exit 0.  A rerun
with the same CKPT_ROOT resumes every rank from the manifest step
(``RESUMED_AT <step>``, ``TORN_REJECTS <n>``).  The rank pins torch's
thread pools to 1 before it builds anything.
"""

import argparse
import json
import os
import signal
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: torch's intra-op and inter-op threads in every rank
THREADS = 1


def linreg_batch(step):
    rng = np.random.RandomState(1234 + step)
    x = rng.rand(8, 4).astype(np.float32)
    return {"x": x, "y": x.sum(1, keepdims=True).astype(np.float32)}


def _linreg():
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import layers
    main, startup = ptt.default_main_program(), \
        ptt.default_startup_program()
    startup.random_seed = main.random_seed = 7
    x = layers.data("x", shape=[4], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    pred = layers.fc(x, size=1, param_attr=ptt.ParamAttr(name="gt_w"),
                     bias_attr=ptt.ParamAttr(name="gt_b"))
    loss = layers.mean(layers.square_error_cost(pred, y))
    ptt.optimizer.Adam(0.05).minimize(loss)
    return main, startup, loss


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root")
    ap.add_argument("total", type=int)
    ap.add_argument("progress")
    ap.add_argument("pause", type=float, nargs="?", default=0.0)
    ap.add_argument("--size", default="linreg",
                    choices=("linreg", "tiny", "full2"))
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    args = _args(argv)
    import torch
    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(THREADS)
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags, monitor
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.env import Env, GangRendezvous
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.resilience import (CheckpointDaemon,
                                             PreemptionGuard, resume_or_init)
    from paddle_tpu_torch.tools import preempt_runner as pr

    cpu = args.cpu or args.size == "linreg"
    if cpu:
        place = ptt.CPUPlace()
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("gang_runner: no CUDA device (pass --cpu)")
        torch.cuda.set_device(Env().dev_id)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = False
        place = ptt.CUDAPlace(Env().dev_id)
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    interval = int(os.environ.get("GANG_CKPT_INTERVAL", "2"))
    avoid = int(os.environ.get("GANG_AVOID_MULTIPLE", "0"))
    progress = f"{args.progress}.r{rank}"
    kill_rank, kill_step = -1, -1
    if os.environ.get("GANG_SELF_KILL"):
        kr, _, ks = os.environ["GANG_SELF_KILL"].partition(":")
        kill_rank, kill_step = int(kr), int(ks)
    kill_marker = os.path.join(args.root, f"killed_rank_{rank}")

    if args.size == "linreg":
        main_p, startup, loss = _linreg()

        def batch(step):
            return linreg_batch(step)
    else:
        main_p, startup, loss = pr.build(args.size)

        def batch(step):
            return pr.batch(args.size, step)

    exe = ptt.Executor(place)
    gang = GangRendezvous.from_env()
    socket_gang = gang is not None and \
        getattr(gang, "backend", "file") == "socket"
    if socket_gang:
        print(f"GANG_BACKEND socket {gang.address}", flush=True)
        fp = os.environ.get("GANG_FP_OVERRIDE")
        if not fp:
            try:
                from paddle_tpu_torch.analysis.verifier import \
                    collective_fingerprint
                fp = collective_fingerprint(main_p)
            except Exception:
                fp = None
        if fp:
            gang.set_progress(fingerprint=fp)
    os.makedirs(args.root, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(args.root, f"rank_{rank}"),
                             max_to_keep=50)
    before = monitor.counter_totals()
    start = resume_or_init(ckpt, exe, startup_program=startup,
                           main_program=main_p, gang=gang)
    after = monitor.counter_totals()
    torn = int(after.get("paddle_tpu_checkpoint_torn_rejects_total", 0)
               - before.get("paddle_tpu_checkpoint_torn_rejects_total", 0))
    print(f"RESUMED_AT {start}", flush=True)
    print(f"TORN_REJECTS {torn}", flush=True)

    fa.reset_launch_count()
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    step_ms = []
    daemon = CheckpointDaemon(ckpt, program=main_p, interval_steps=interval,
                              interval_secs=0, gang=gang).start()
    with PreemptionGuard(ckpt, executor=exe, program=main_p,
                         daemon=daemon, gang=gang, exit_code=0) as guard:
        for step in range(start, args.total):
            if rank == kill_rank and step == kill_step and \
                    not os.path.exists(kill_marker):
                # armed once: the respawned rank must not kill itself
                # again when it reaches this step
                with open(kill_marker, "w") as f:
                    f.write(str(step))
                    f.flush()
                    os.fsync(f.fileno())
                print(f"SELF_KILL {step}", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
            t0 = time.perf_counter()
            out, = exe.run(main_p, feed=batch(step), fetch_list=[loss])
            value = float(np.asarray(out).ravel()[0])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            print(f"STEP {step} LOSS {value!r}", flush=True)
            guard.completed_step(step + 1)
            if socket_gang:
                gang.set_progress(step=step + 1)
            if os.environ.get("GANG_SYNC_COMMITS") and \
                    daemon._last_capture_step == step + 1:
                # every cadence commit made deterministic: which steps
                # each rank announced must not depend on timing
                daemon.wait_committed(step + 1)
            with open(progress, "a") as f:
                f.write(f"{step}\n")
                f.flush()
                os.fsync(f.fileno())
            if args.pause:
                time.sleep(args.pause)
            if socket_gang and gang.degraded:
                # a peer died: drain, then park at the rejoin barrier
                # until the launcher respawns it
                print(f"GANG_DEGRADED dead={gang.dead_ranks}", flush=True)
                guard.drain()
                ok = gang.wait_ready()
                print(f"GANG_READY {int(bool(ok))}", flush=True)
                if not ok:
                    raise SystemExit(
                        "gang never reconverged; aborting rank")
            if guard.preempted:
                if avoid and (step + 1) % avoid == 0:
                    continue     # an emergency step no cadence announced
                if os.environ.get("GANG_EMERGENCY_HANG"):
                    flags.set_flags({"FLAGS_fault_inject":
                                   "checkpoint.write:every=1,hang=120"})
                break
    daemon.stop(final_step=args.total)
    done = {"launches": {k: fa.launch_count(k) for k in
                         ("flash_attn_fwd", "flash_attn_bwd")},
            "step_ms": step_ms, "start": start,
            "peak_bytes": 0 if cpu else torch.cuda.max_memory_allocated()}
    print("DONE " + json.dumps(done), flush=True)


if __name__ == "__main__":
    main()
