"""Train the GPT under preemption-safe checkpointing: the SIGTERM drill.

One child process trains::

    python -m paddle_tpu_torch.tools.preempt_runner --ckpt DIR
        [--steps 8] [--interval 2] [--pause-after K] [--size full|tiny]
        [--cpu]

``build_gpt_pretrain`` (fused head, dropout 0.0, flash attention) with
``AdamOptimizer(1e-4)``, the same seeded weights in every child, the batch
of step ``i`` drawn from ``RandomState(1000 + i)``, trained to ``--steps``
under :func:`resilience.resume_or_init`, ``CheckpointDaemon(interval_steps
=--interval).start()`` and :class:`resilience.PreemptionGuard`.  ``full``
is the GPT at BERT-base width (vocab 30522, d 768, 12 layers, 12 heads,
d_inner 3072, max_pos 2048) at batch 8 x 2048 on the card, TF32 off
(and bf16 products reduced in float32, as ``chip_smoke.py`` sets);
``full2`` the same width cut to 2 layers;
``tiny`` a 2-layer GPT (d 64, 4 heads, seq 64, batch 2).  The child pins
the host's intra-op and inter-op thread pools to ``THREADS`` (1) before it
builds anything: the host's float32 sums then run in one fixed order
whatever the machine's cores and load, so two children given the same
arguments compute the same bits.  With
``--pause-after K`` the child prints ``PAUSED K`` once step K is complete
and waits at that boundary for a signal: the parent's SIGTERM is the go, so
nothing races a sleep.  The last line of its output is ``RESULT {json}``:
the losses as float32 bits, a digest per persistable after a resume and
after a preemption's emergency checkpoint, the step and capture times,
the checkpoint counters and the flash kernels' float32 launches.

:func:`drill` runs the whole exercise from a parent (``chip_smoke.py``'s
``preempt_train`` phase, and the CPU test at ``tiny``): (a1), (a2)
uninterrupted and, at the same time, (b) under
``FLAGS_fault_inject=checkpoint.write:once``, SIGTERMed at the pause after
step ``steps // 2``, which drains, writes its emergency checkpoint and
exits 0; then (c) resumed in a fresh process.
:func:`check` holds (c)'s restored state to (b)'s saved state bit for
bit, (b) + (c)'s losses to (a1)'s (bit for bit, or within the largest
(a1)–(a2) difference when those differ), and (b)'s counters to exactly one
injected fault, one retry and no give-up at ``checkpoint.write``.
Checkpoints go under ``tempfile``'s directory, never the checkout, and
each child's directory is deleted once read.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

SIZES = {
    "full": dict(cfg=dict(vocab_size=30522, d_model=768, n_layer=12,
                          n_head=12, d_inner=3072, max_pos=2048,
                          dropout=0.0), batch=8, seq=2048),
    "full2": dict(cfg=dict(vocab_size=30522, d_model=768, n_layer=2,
                           n_head=12, d_inner=3072, max_pos=2048,
                           dropout=0.0), batch=8, seq=2048),
    "tiny": dict(cfg=dict(vocab_size=64, d_model=64, n_layer=2, n_head=4,
                          d_inner=128, max_pos=64, dropout=0.0),
                 batch=2, seq=64),
}
LR = 1e-4
SEED = 1234
SITE = "checkpoint.write"
#: torch's intra-op and inter-op threads in every child
THREADS = 1


def build(size: str):
    """(main, startup, loss) of the drill's training program."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.models import transformer as T
    spec = SIZES[size]
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = SEED
    with program_guard(main, startup):
        _, _, loss = T.build_gpt_pretrain(
            T.BertConfig(**spec["cfg"]), spec["seq"], fused_head=True,
            attn_impl="flash", dropout=0.0)
        optimizer.AdamOptimizer(learning_rate=LR).minimize(loss)
    return main, startup, loss


def batch(size: str, step: int) -> Dict[str, np.ndarray]:
    """The feed of step ``step`` (keyed by the step index alone)."""
    spec = SIZES[size]
    rng = np.random.RandomState(1000 + step)
    ids = rng.randint(1, spec["cfg"]["vocab_size"],
                      (spec["batch"], spec["seq"])).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = 0
    return {"src_ids": ids, "lm_label": labels}


def digests(scope, program) -> Dict[str, str]:
    """A blake2b digest of each persistable's bytes (bf16 as its bits)."""
    from paddle_tpu_torch import io
    out = {}
    for v in io.get_program_persistable_vars(program):
        arr = io._to_numpy(scope.find_var(v.name))
        h = hashlib.blake2b(digest_size=16)
        h.update(str(arr.dtype).encode() + repr(arr.shape).encode())
        h.update(arr.tobytes())
        out[v.name] = h.hexdigest()
    return out


def _bits(x) -> str:
    return np.asarray(x, np.float32).reshape(()).view(np.uint32).tobytes(
    ).hex()


def _span_ms(events, name) -> List[dict]:
    return [dict(ev.get("args") or {}, ms=ev["dur"] / 1e3)
            for ev in events if ev.get("name") == name
            and ev.get("ph") == "X"]


def child(args) -> None:
    import torch
    # before any parallel work: the inter-op pool is fixed at its first use
    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(THREADS)
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import checkpoint, monitor, resilience
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import flash_attention as fa
    on_card = not args.cpu
    if on_card:         # chip_smoke.py's settings for every phase
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = False
    main, startup, loss = build(args.size)
    scope = Scope()
    exe = ptt.Executor(ptt.CPUPlace() if args.cpu else None)
    ckpt = checkpoint.CheckpointManager(args.ckpt, max_to_keep=2)
    t0 = time.perf_counter()
    start = resilience.resume_or_init(ckpt, exe, startup_program=startup,
                                      main_program=main, scope=scope)
    res = {"start": start, "resume_s": time.perf_counter() - t0,
           # the state a resumed child restored
           "digests_start": digests(scope, main) if start else None,
           "losses": {},
           "step_ms": {}, "capture_peak_bytes": [], "preempted": False,
           "threads": [torch.get_num_threads(),
                       torch.get_num_interop_threads()]}
    fa.reset_launch_count()
    daemon = resilience.CheckpointDaemon(
        ckpt, program=main, scope=scope,
        interval_steps=args.interval).start()

    def finish():
        t_d = time.perf_counter()
        # the state a preempted child saved
        res["digests_end"] = digests(scope, main) if res["preempted"] \
            else None
        res["digest_s"] = time.perf_counter() - t_d
        events = monitor.TRACER.chrome_events()
        totals = {n: monitor.REGISTRY.get(n).value(site=SITE)
                  for n in ("paddle_tpu_fault_injected_total",
                            "paddle_tpu_retry_attempts_total",
                            "paddle_tpu_retry_giveups_total")}
        res.update(
            committed=daemon.last_committed, all_steps=ckpt.all_steps(),
            counters=totals,
            launches={k: fa.launch_count(k, "float32")
                      for k in ("flash_attn_fwd", "flash_attn_bwd")},
            capture=_span_ms(events, "checkpoint.capture"),
            persist=_span_ms(events, "checkpoint.persist"),
            restore=_span_ms(events, "checkpoint.restore"),
            drain=_span_ms(events, "preemption.drain"),
            emergency=_span_ms(events, "preemption.checkpoint"),
            bytes=int(sum(
                t.numel() * t.element_size() for t in
                (scope.find_var(v.name) for v in
                 ptt.io.get_program_persistable_vars(main)))),
            device=(torch.cuda.get_device_name(0) if on_card else "cpu"))
        print("RESULT " + json.dumps(res), flush=True)

    guard = resilience.PreemptionGuard(ckpt, executor=exe, program=main,
                                       scope=scope, daemon=daemon)
    try:
        with guard:
            for step in range(start, args.steps):
                feed = batch(args.size, step)
                t_s = time.perf_counter()
                out, = exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)
                res["step_ms"][step] = (time.perf_counter() - t_s) * 1e3
                res["losses"][step] = _bits(out)
                if on_card:
                    torch.cuda.reset_peak_memory_stats()
                    m0 = torch.cuda.memory_allocated()
                guard.completed_step(step + 1)
                if on_card:
                    res["capture_peak_bytes"].append(
                        torch.cuda.max_memory_allocated() - m0)
                if args.pause_after == step + 1:
                    print(f"PAUSED {step + 1}", flush=True)
                    while not guard.preempted:
                        time.sleep(0.01)    # the signal ends the wait
                if guard.preempted:
                    break
            if not guard.preempted:
                daemon.stop()
    except SystemExit:
        res["preempted"] = True
        finish()
        raise
    finish()


# -- the parent's side ---------------------------------------------------------

def spawn(ckpt: str, steps: int, interval: int, size: str, cpu: bool,
          pause_after: Optional[int] = None,
          env: Optional[Dict[str, str]] = None,
          timeout: float = 600.0) -> dict:
    """Run one child to its end; with ``pause_after``, SIGTERM it once it
    prints ``PAUSED``.  Returns its ``RESULT`` with ``rc``, ``wall_s`` and,
    when signalled, ``sigterm_to_exit_ms`` (the parent's clock)."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.preempt_runner",
           "--ckpt", ckpt, "--steps", str(steps), "--interval",
           str(interval), "--size", size]
    if cpu:
        cmd.append("--cpu")
    if pause_after is not None:
        cmd += ["--pause-after", str(pause_after)]
    full_env = dict(os.environ)
    full_env["PYTHONPATH"] = repo + os.pathsep + full_env.get(
        "PYTHONPATH", "")
    full_env.update(env or {})
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(cmd, cwd=repo, env=full_env, text=True,
                                stdout=subprocess.PIPE, stderr=err)
        # a child past its time is killed, which ends the read below
        timer = threading.Timer(timeout, proc.kill)
        timer.start()
        lines, killed_at = [], None
        try:
            for line in proc.stdout:
                lines.append(line)
                if line.startswith("PAUSED") and killed_at is None:
                    killed_at = time.perf_counter()
                    proc.send_signal(signal.SIGTERM)
            rc = proc.wait()
        finally:
            timer.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        t_end = time.perf_counter()
        err.seek(0)
        stderr = err.read()
    result = [ln for ln in lines if ln.startswith("RESULT ")]
    if rc != 0 or not result:
        raise RuntimeError(f"preempt_runner child exited {rc}; stderr "
                           f"tail:\n{stderr[-4000:]}")
    out = json.loads(result[-1][len("RESULT "):])
    out.update(rc=rc, wall_s=t_end - t0, paused=killed_at is not None)
    if killed_at is not None:
        out["sigterm_to_exit_ms"] = (t_end - killed_at) * 1e3
    return out


def drill(size: str, cpu: bool, steps: int = 8, interval: int = 2,
          timeout: float = 600.0) -> dict:
    """(a1), (a2), (b) and (c) as the module docstring says, (a1), (a2)
    and (b) at once, then (c); each child's checkpoint directory under
    ``tempfile``'s directory, deleted once read.  Returns ``{"a1", "a2",
    "b", "c", "disk_free"}``."""
    runs = {}
    root = tempfile.mkdtemp(prefix="paddle_tpu_preempt_")
    free = [shutil.disk_usage(root).free]
    d = os.path.join(root, "bc")
    try:
        # (a1), (a2) and (b) are independent: they run at once
        with ThreadPoolExecutor(3) as pool:
            jobs = {name: pool.submit(spawn, os.path.join(root, name),
                                      steps, interval, size, cpu,
                                      timeout=timeout)
                    for name in ("a1", "a2")}
            jobs["b"] = pool.submit(
                spawn, d, steps, interval, size, cpu,
                pause_after=steps // 2,
                env={"FLAGS_fault_inject": f"{SITE}:once",
                     "FLAGS_watchdog_timeout_s": "300"},
                timeout=timeout)
            runs.update({name: job.result() for name, job in jobs.items()})
        free.append(shutil.disk_usage(root).free)
        for name in ("a1", "a2"):
            shutil.rmtree(os.path.join(root, name))
        runs["c"] = spawn(d, steps, interval, size, cpu, timeout=timeout)
        free.append(shutil.disk_usage(root).free)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free.append(shutil.disk_usage(tempfile.gettempdir()).free)
    runs["disk_free"] = free
    return runs


def _loss(bits: str) -> float:
    return float(np.frombuffer(bytes.fromhex(bits), np.float32)[0])


def check(runs: dict, steps: int = 8) -> dict:
    """Hold the drill to its contract (raises ``AssertionError``); returns
    the report: the first step where (a1) and (a2) differ (None when equal)
    and the largest difference, the tolerance the resume was held to, and
    (b)'s counters."""
    a1, a2, b, c = runs["a1"], runs["a2"], runs["b"], runs["c"]
    half = steps // 2
    want = [a1["losses"][str(i)] for i in range(steps)]
    twin = [a2["losses"][str(i)] for i in range(steps)]
    gaps = [abs(_loss(x) - _loss(y)) for x, y in zip(want, twin)]
    first_diff = next((i for i in range(steps) if want[i] != twin[i]),
                      None)
    if not b["preempted"] or b["start"] != 0 or c["start"] != half:
        raise AssertionError(
            f"drill shape: b preempted={b['preempted']} start={b['start']},"
            f" c start={c['start']} (want True, 0, {half})")
    if b["committed"] != half or max(b["all_steps"]) != half:
        raise AssertionError(f"b committed {b['committed']}, steps "
                             f"{b['all_steps']} (want {half})")
    if c["digests_start"] != b["digests_end"]:
        off = [n for n, h in b["digests_end"].items()
               if c["digests_start"].get(n) != h]
        raise AssertionError(f"restored state differs from the saved "
                             f"state in {len(off)} vars: {off[:5]}")
    got = [b["losses"][str(i)] for i in range(half)] + \
        [c["losses"][str(i)] for i in range(half, steps)]
    tol = max(gaps)
    worst = max(abs(_loss(x) - _loss(y)) for x, y in zip(got, want))
    if first_diff is None and got != want:
        raise AssertionError(
            f"resumed losses {[_loss(x) for x in got]} differ from the "
            f"uninterrupted {[_loss(x) for x in want]} (bitwise), "
            f"largest {worst}")
    if first_diff is not None and worst > tol:
        raise AssertionError(f"resumed losses off by {worst}, beyond the "
                             f"(a1)-(a2) gap {tol}")
    ctr = b["counters"]
    if (ctr["paddle_tpu_fault_injected_total"],
            ctr["paddle_tpu_retry_attempts_total"],
            ctr["paddle_tpu_retry_giveups_total"]) != (1, 1, 0):
        raise AssertionError(f"b's {SITE} counters {ctr}: want 1 fault, "
                             "1 retry, 0 give-ups")
    return {"first_diff_a1_a2": first_diff, "a1_a2_max_gap": tol,
            "resume_max_diff": worst, "bitwise": got == want,
            "counters_b": ctr}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--interval", type=int, default=2)
    ap.add_argument("--pause-after", type=int, default=None)
    ap.add_argument("--size", choices=sorted(SIZES), default="full")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the host (the default is cuda:0)")
    child(ap.parse_args(argv))


if __name__ == "__main__":
    main()
