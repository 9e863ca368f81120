"""Collective training across processes: the port's two-process trainer
(the port of ``tests/collective_two_proc_runner.py``).

Launched as one rank of a gang::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        paddle_tpu_torch/tools/collective_runner.py [options]

or alone with
``--single`` (one process runs both ranks of an in-process dp 2 mesh of
virtual ranks: the comparison child).  Each rank brings up
``init_parallel_env`` (gloo over the host), then runs the phases named by
``--phases`` and prints one line each, ``LOSSES`` / ``GSPMD`` / ``ZERO``
(the per-step losses, JSON) and ``RING`` (JSON), then ``RESULT {json}``
with everything measured.

- ``losses``: the program transpiled by ``GradAllReduce`` and trained in
  collective mode over the dp mesh that spans the processes.  With
  ``--model mlp`` (the reference runner's MLP and SGD(0.1)) every process
  feeds the same 8-row batch, as the reference's runner does (the
  in-process child feeds it twice, one copy a rank); with ``--model gpt``
  (``build_gpt_pretrain`` at BERT-base width, Adam(1e-4), startup seed
  1234) process p feeds rows [p * b, (p + 1) * b) of ``--feed``'s global
  batch (the in-process child the whole batch).
- ``gspmd`` / ``zero``: the untranspiled program under
  ``CompiledProgram.with_distributed(axes={"dp": 2}, zero_stage=0 | 1)``
  over the process-spanning mesh; each process feeds its half of the
  global batch (ref runner :100-140), and the loss comes back global.
  The MLP runs SGD(0.1) and Adam(0.05) as the reference's, the GPT
  Adam(1e-4) in both.
- ``ring``: ring attention with the ``sp`` axis spanning the processes:
  each process holds its half of T of seeded q, k, v (and ``do``), runs
  the ring forward and backward over the pair (K1, K2 and the merge at
  every ring step, the K/V and dK/dV rotations a send and a receive over
  the host), and holds its o, lse, dq, dk, dv to the plain dense
  attention over the whole T (by head groups; the reference's ``RING``
  check): the largest error and its share of ``--ring-tol``'s bound
  (rtol = atol) per tensor; with ``--ring-op`` also the model's entry,
  ``ring_attention`` over the mesh with autograd (o and the gradients
  whole on every process).

``--init NPZ`` loads the MLP's initial parameters (every program starts
from them, so that a test holds both packages to the same weights).  Every
rank pins torch's intra-op and inter-op thread pools to 1 before anything
is built, so that the host's float32 sums run in one order in every child.
On the card (no ``--cpu``) a child without CUDA raises, TF32 is off and
bf16 products reduce in float32, as ``chip_smoke.py`` sets.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import Dict, List

import numpy as np

#: torch's intra-op and inter-op threads in every rank
THREADS = 1
#: the GPT's Adam rate and startup seed (chip_smoke.py's dp_train)
GPT_LR, GPT_SEED = 1e-4, 1234
MLP_SEED = 42
#: ring: head groups of the dense reference (bounds its memory)
RING_REF_HEADS = 4


def _setup(cpu: bool):
    import torch
    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(THREADS)
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("collective_runner: no CUDA device (pass --cpu "
                           "to run on the host)")
    from paddle_tpu_torch.distributed.env import Env
    torch.cuda.set_device(Env().dev_id)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    return torch.device("cuda", Env().dev_id)


def _devices(device, single: bool):
    """The dp mesh's devices: this process's device named twice in the
    in-process child, and over the processes one a process (None on the
    card: ``make_mesh`` takes each process's card)."""
    if single:
        return [device] * 2
    if device.type == "cpu":
        from paddle_tpu_torch.distributed.env import process_count
        return [device] * process_count()
    return None


def _mlp(make_opt):
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework import Program, program_guard, \
        unique_name
    with unique_name.guard():
        main, startup = Program(), Program()
        with program_guard(main, startup):
            x = layers.data("x", shape=[8], dtype="float32")
            y = layers.data("y", shape=[1], dtype="float32")
            h = layers.fc(x, size=16, act="tanh")
            pred = layers.fc(h, size=1)
            loss = layers.mean(layers.square_error_cost(pred, y))
            make_opt().minimize(loss)
    return main, startup, loss


def mlp_batch():
    """The reference runner's global batch: 8 rows of 8 features."""
    rng = np.random.RandomState(7)
    xv = rng.rand(8, 8).astype(np.float32)
    return {"x": xv, "y": xv.sum(1, keepdims=True).astype(np.float32)}


def gpt_config():
    from paddle_tpu_torch.models import transformer as T
    return T.BertConfig(vocab_size=30522, d_model=768, n_layer=12,
                        n_head=12, d_inner=3072, max_pos=2048, dropout=0.0)


def _gpt(make_opt):
    from paddle_tpu_torch.framework import Program, program_guard, \
        unique_name
    from paddle_tpu_torch.models import transformer as T
    cfg = gpt_config()
    with unique_name.guard():
        main, startup = Program(), Program()
        with program_guard(main, startup):
            _, _, loss = T.build_gpt_pretrain(cfg, cfg.max_pos,
                                              fused_head=True,
                                              attn_impl="auto", dropout=0.0)
            make_opt().minimize(loss)
    return main, startup, loss


def digest(scope, program) -> str:
    """One blake2b digest over every parameter's bytes, in name order."""
    from paddle_tpu_torch import io
    h = hashlib.blake2b(digest_size=16)
    for p in sorted(program.all_parameters(), key=lambda p: p.name):
        h.update(p.name.encode())
        h.update(io._to_numpy(scope.find_var(p.name)).tobytes())
    return h.hexdigest()


class _Run:
    """One phase's program, scope and executor, started from the seed (or
    ``--init``'s weights)."""

    def __init__(self, args, device, make_opt, transpile: bool):
        import paddle_tpu_torch as ptt
        from paddle_tpu_torch.distributed import GradAllReduce
        from paddle_tpu_torch.distributed.env import Env
        from paddle_tpu_torch.framework import Scope
        from paddle_tpu_torch.io import params_from_numpy
        build = _gpt if args.model == "gpt" else _mlp
        self.main, self.startup, self.loss = build(make_opt)
        if transpile:
            env = Env()
            eps = env.trainer_endpoints or ["127.0.0.1:6170",
                                            "127.0.0.1:6171"]
            GradAllReduce().transpile(
                startup_program=self.startup, main_program=self.main,
                rank=env.rank, endpoints=",".join(eps),
                current_endpoint=env.current_endpoint or eps[0])
        self.scope = Scope()
        place = ptt.CPUPlace() if device.type == "cpu" else \
            ptt.CUDAPlace(device.index or 0)
        self.exe = ptt.Executor(place)
        seed = GPT_SEED if args.model == "gpt" else MLP_SEED
        self.exe.run(self.startup, scope=self.scope, seed=seed)
        if args.init:
            with np.load(args.init) as f:
                params_from_numpy(self.scope, dict(f), device)
        self.digest0 = digest(self.scope, self.main)

    def steps(self, target, feed, n, device) -> tuple:
        """``n`` steps on one feed: the losses (each a mean over the
        stacked ranks), each step's host ms ending in a synchronize, and
        the exchange's host ms a step (``distributed.xproc.STATS``)."""
        import torch
        from paddle_tpu_torch.distributed import xproc
        losses, ms, xms = [], [], []
        for _ in range(n):
            x0 = xproc.STATS["seconds"]
            t0 = time.perf_counter()
            out, = self.exe.run(target, feed=feed, fetch_list=[self.loss],
                                scope=self.scope)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            xms.append((xproc.STATS["seconds"] - x0) * 1e3)
            losses.append(float(np.asarray(out, np.float64).mean()))
        return losses, ms, xms


def _feeds(args, rank: int, world: int, whole: bool) -> Dict[str, np.ndarray]:
    """The phase's feed: the global batch (``whole``), else this process's
    rows of it."""
    if args.model == "gpt":
        with np.load(args.feed) as f:
            g = {k: f[k] for k in f.files}
    else:
        g = mlp_batch()
    if whole:
        return g
    b = next(iter(g.values())).shape[0] // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in g.items()}


def _phase(args, device, name, steps) -> dict:
    import torch
    from paddle_tpu_torch import monitor, optimizer
    from paddle_tpu_torch.analysis import comms
    from paddle_tpu_torch.distributed.env import Env, process_count
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import make_mesh, set_mesh
    import paddle_tpu_torch as ptt
    env = Env()
    world = 2 if args.single else process_count()
    rank = 0 if args.single else env.rank
    gpt = args.model == "gpt"
    def make_opt():
        if gpt:
            return optimizer.AdamOptimizer(GPT_LR)
        return optimizer.AdamOptimizer(0.05) if name == "zero" \
            else optimizer.SGDOptimizer(0.1)
    run = _Run(args, device, make_opt, transpile=name == "losses")
    devices = _devices(device, args.single)
    if name == "losses":
        # the reference's MLP runner feeds its whole batch on every rank;
        # the GPT's ranks take their rows of the global batch
        if gpt:
            feed = _feeds(args, rank, world, whole=args.single)
        else:
            b = mlp_batch()
            feed = {k: np.concatenate([v, v]) for k, v in b.items()} \
                if args.single else b
        set_mesh(make_mesh({"dp": 2}, devices))
        target = run.main
        batch = next(iter(feed.values())).shape[0] * (
            1 if args.single else world)
        cplan = comms.plan_comms(run.main, [run.loss.name],
                                 batch_size=batch, nranks=2)
        payload = cplan.payload_bytes if cplan is not None else 0
    else:
        feed = _feeds(args, rank, world, whole=args.single)
        zero = 1 if name == "zero" else 0
        target = ptt.CompiledProgram(run.main).with_distributed(
            axes={"dp": 2}, zero_stage=zero, devices=devices)
        from paddle_tpu_torch.analysis.sharding import plan_sharding
        batch = next(iter(feed.values())).shape[0] * (
            1 if args.single else world)
        splan = plan_sharding(run.main, [run.loss.name], batch_size=batch,
                              specs={}, axis_sizes={"dp": 2},
                              zero_stage=zero)
        payload = splan.payload_bytes if splan is not None else None
    try:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device) \
            if device.type == "cuda" else 0
        fa.reset_launch_count()
        b0 = monitor.counter_totals().get(
            "paddle_tpu_collective_bytes_total", 0)
        losses, ms, xms = run.steps(target, feed, steps, device)
        moved = monitor.counter_totals().get(
            "paddle_tpu_collective_bytes_total", 0) - b0
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
    finally:
        set_mesh(None)
    return {"losses": losses, "step_ms": ms, "exchange_ms": xms,
            "digest0": run.digest0, "digest": digest(run.scope, run.main),
            "launches": {k: fa.launch_count(k) for k in
                         ("flash_attn_fwd", "flash_attn_bwd")},
            "collective_bytes": moved, "plan_bytes": payload,
            "peak_bytes": peak, "held_bytes": held,
            "params": {p.name: np.asarray(run.scope.find_var(p.name))
                       .tolist() for p in run.main.all_parameters()}
            if not gpt else None}


def _ring_inputs(shape, device, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(*shape, generator=g) * 0.3).to(device)
            for _ in range(4)]


def _ring(args, device) -> dict:
    """The ring across the processes of an sp 2 mesh: this process's half
    of T against the plain dense attention over the whole T."""
    import torch
    from paddle_tpu_torch.distributed.xproc import span_of
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import ring_attention as ra
    from paddle_tpu_torch.parallel import make_mesh
    bh, t, d = args.ring
    mesh = make_mesh({"sp": 2}, _devices(device, args.single))
    span = span_of(mesh, "sp")
    devices = list(mesh.axis_devices("sp"))
    q, k, v, do = _ring_inputs((bh, t, d), device, args.ring_seed)
    half = t // len(devices)
    lo = span.local[0] * half
    hi = (span.local[-1] + 1) * half
    blk = [x[:, lo:hi].contiguous() for x in (q, k, v, do)]
    fa.reset_launch_count()
    ra.reset_launch_count()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    o, lse = ra.ring_attention_fwd(*blk[:3], devices, span=span)
    dq, dk, dv = ra.ring_attention_bwd(*blk[:3], o, lse, blk[3], devices,
                                       span=span)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attn_fwd": fa.launch_count("flash_attn_fwd"),
                "flash_attn_bwd": fa.launch_count("flash_attn_bwd"),
                "ring_merge": ra.launch_count("ring_merge")}
    # the plain dense attention over the whole T, a group of heads at
    # once; this process's block of it
    ref = {n: [] for n in ("o", "lse", "dq", "dk", "dv")}
    whole_ref = {n: [] for n in ("o", "dq", "dk", "dv")}
    for h0 in range(0, bh, RING_REF_HEADS):
        sl = slice(h0, h0 + RING_REF_HEADS)
        ro, rl = fa.flash_attention_reference(q[sl], k[sl], v[sl])
        g = fa.flash_attention_bwd_reference(q[sl], k[sl], v[sl], ro, rl,
                                             do[sl])[:3]
        for n, x in zip(ref, (ro, rl) + tuple(g)):
            ref[n].append(x[:, lo:hi].float().cpu())
            if n in whole_ref and args.ring_op:
                whole_ref[n].append(x.float().cpu())
    got = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv)
    err, share = {}, {}
    for n in ref:
        r = torch.cat(ref[n])
        e = (got[n].float().cpu() - r).abs()
        tol = args.ring_tol[0] if n in ("o", "lse") else args.ring_tol[1]
        err[n] = float(e.max())
        share[n] = float((e / (tol + tol * r.abs())).max())
    out = {"errors": err, "shares": share, "tolerances": args.ring_tol,
           "ms": wall_ms, "launches": launches, "block": [lo, hi],
           "shape": [bh, t, d]}
    if args.ring_op:
        # the model's entry over the mesh: the whole q, k, v on every
        # process, autograd through the ring, o and the gradients whole
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o4 = ra.ring_attention(*(x[None] for x in leaves), mesh)
        o4.backward(do[None])
        whole = {n: torch.cat(x) for n, x in whole_ref.items()}
        out["op_errors"] = {
            n: float((g.detach().float().cpu() - whole[n]).abs().max())
            for n, g in (("o", o4[0]), ("dq", leaves[0].grad),
                         ("dk", leaves[1].grad), ("dv", leaves[2].grad))}
    if args.ring_values:
        out["o"] = o.float().cpu().numpy().tolist()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("mlp", "gpt"), default="mlp")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--single", action="store_true",
                    help="one process over an in-process dp 2 mesh")
    ap.add_argument("--phases", default="losses,gspmd,zero,ring")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--zero-steps", type=int, default=None)
    ap.add_argument("--init", help=".npz of the MLP's initial parameters")
    ap.add_argument("--feed", help=".npz of the GPT's global batch")
    ap.add_argument("--ring", default="2,16,8",
                    help="bh,T,d of the ring check")
    ap.add_argument("--ring-seed", type=int, default=11)
    ap.add_argument("--ring-tol", default="1e-5,1e-5",
                    help="rtol = atol of o and lse, of the gradients")
    ap.add_argument("--ring-values", action="store_true",
                    help="also print this process's o")
    ap.add_argument("--ring-op", action="store_true",
                    help="also run the model's ring_attention entry "
                         "(autograd, whole tensors) over the mesh")
    args = ap.parse_args(argv)
    args.ring = [int(x) for x in args.ring.split(",")]
    args.ring_tol = [float(x) for x in args.ring_tol.split(",")]
    device = _setup(args.cpu)
    from paddle_tpu_torch.distributed.env import init_parallel_env
    if not args.single:
        init_parallel_env()
    phases: List[str] = [p for p in args.phases.split(",") if p]
    result = {"device": str(device)}
    if not args.cpu:
        import torch
        result["device_name"] = torch.cuda.get_device_name(device)
    for name in phases:
        if name == "ring":
            result["ring"] = _ring(args, device)
            print("RING " + json.dumps(result["ring"]["errors"]),
                  flush=True)
            continue
        steps = args.steps if name != "zero" or args.zero_steps is None \
            else args.zero_steps
        result[name] = _phase(args, device, name, steps)
        print(f"{name.upper()} " + json.dumps(result[name]["losses"]),
              flush=True)
    print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
