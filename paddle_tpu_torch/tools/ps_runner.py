"""One process of a parameter-server job: a pserver or a trainer (the
port's counterpart of ``tests/ps_dist_runner.py`` and
``tests/ps_fleet_runner.py``).

Under the PS launcher, which gives the role through the env contract
(``TRAINING_ROLE``, ``PADDLE_PSERVER_ENDPOINTS``, ...) and ``ps_fleet``::

    python -m paddle_tpu_torch.distributed.launch_ps --server_num 1 \\
        --worker_num 2 paddle_tpu_torch/tools/ps_runner.py --model deepfm

or alone, with the role on the command line (``DistributeTranspiler``
called directly)::

    python paddle_tpu_torch/tools/ps_runner.py --role pserver --port P \\
        --trainers 2 --cpu &
    python paddle_tpu_torch/tools/ps_runner.py --role trainer \\
        --trainer_id 0 --port P --trainers 2 --cpu

Models (``--model``):

- ``regression``: the reference runners' 4 -> 1 linear regression (weight
  ``w``, SGD(0.1), the same ``RandomState(0)`` batches of 16 on every
  trainer; with ``--role`` the weight starts at 0, as in
  ``ps_dist_runner.py``);
- ``deepfm``: ``models.build_ctr_train`` with ``--sparse_dim`` (10000:
  ``tools/bench_deepfm_ps.py:37-44``), ``is_sparse=True``, batches of
  ``--batch`` made from ``RandomState(trainer_id)`` as
  ``bench_deepfm_ps.py:102-108`` makes them; SGD(0.2) in sync and geo
  mode, Adam(0.01) in async mode;
- ``gpt``: ``build_gpt_pretrain`` with the fused head at 2 layers, d 16,
  T 8, Adam(1e-4), batches of ``--batch`` from ``RandomState(trainer_id)``.

``--mode`` is ``sync``, ``async`` (no barrier, the server applies each push)
or ``geo`` (local optimizer, ``GeoCommunicator`` with ``record_rows`` on the
sparse tables, a round every ``--geo_push`` steps, ``flush`` at the end).
Each mode builds its programs under a fresh ``unique_name`` and scope.

In sync mode with several trainers and sparse tables, a ``fetch_barrier``
stands before the step's first push (:func:`fence_lookups`), so a round
pulls every trainer's rows before any trainer's row gradients land.

A trainer runs its startup at seed ``SEED``; unless the model is the
zero-initialized regression, trainer 0 then puts its startup values into
the servers' tables (in geo mode every trainer does, through
``GeoCommunicator.init_snapshots``) and every trainer waits at a barrier,
so the tables start equal to every trainer's startup.  It then takes
``--steps`` steps, each ending in a synchronize, and prints one line
``RESULT {json}``: per step its loss, ms, a sha256 of its dense parameters'
bytes and the PS bytes pushed and pulled; its kernel launches, the fused
op types the executor ran, the steps' ``paddle_tpu_ps_rpc_ms`` by op
(:func:`rpc_quantiles`), and in geo mode each round's pushed rows beside
the distinct ids fed since the round before, and the wall-clock marks of
its phases (imports, programs, startup, seeded tables, steps).  In async
mode trainer 0 then prints ``EVAL {json}``, the loss of the startup's and
of the servers' final parameters on every trainer's first batches
(:func:`async_eval`).  A pserver
prints ``PSERVER {json}`` with its own marks when it stops.  Trainer 0
stops the servers at the end, after every trainer has passed the final
barrier.

Several modes run in one job with ``--mode sync,async,geo`` under
``--server_num 3``: pserver k serves mode k alone, and the trainers run the
modes one after another, each against its own pserver, which trainer 0
stops when the mode ends (no server is restarted on a port a trainer may
still reach).

Every process pins torch's thread pools to 1 (so host float32 sums run in
one order); a pserver hides the card (``CUDA_VISIBLE_DEVICES=""``) and runs
its executor on the host; on the card TF32 is off.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

SEED = 1234
#: learning rates by (model, mode): the reference bench's for the DeepFM
LR = {("regression", "sync"): 0.1, ("regression", "async"): 0.1,
      ("regression", "geo"): 0.1, ("deepfm", "sync"): 0.2,
      ("deepfm", "async"): 0.01, ("deepfm", "geo"): 0.2,
      ("gpt", "sync"): 1e-4, ("gpt", "async"): 1e-4, ("gpt", "geo"): 1e-4}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--role", choices=("pserver", "trainer"),
                    help="the role from argv (default: the launch_ps env)")
    ap.add_argument("--trainer_id", type=int, default=0)
    ap.add_argument("--port", type=int, default=6174)
    ap.add_argument("--trainers", type=int, default=1)
    ap.add_argument("--model", choices=("regression", "deepfm", "gpt"),
                    default="regression")
    ap.add_argument("--mode", default="sync",
                    help="sync, async or geo; or a comma-separated list of "
                         "them, each mode on its own pserver in turn")
    ap.add_argument("--steps", type=int, default=None,
                    help="default: 30 with --role, else 20 (the reference "
                         "runners'); 11 for the DeepFM and 3 for the GPT")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--sparse_dim", type=int, default=10000)
    ap.add_argument("--geo_push", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run the trainer on the host (default: the card)")
    return ap.parse_args(argv)


def _role(args):
    """(role, trainer id, pserver endpoints, trainer count, from_env)."""
    if args.role:
        return (args.role, args.trainer_id, [f"127.0.0.1:{args.port}"],
                args.trainers, False)
    role = os.environ.get("TRAINING_ROLE", "TRAINER")
    eps = os.environ["PADDLE_PSERVER_ENDPOINTS"].split(",")
    return ("pserver" if role == "PSERVER" else "trainer",
            int(os.environ.get("PADDLE_TRAINER_ID", "0")), eps,
            int(os.environ.get("PADDLE_TRAINERS_NUM", "1")), True)


def _device(cpu: bool):
    import torch
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("ps_runner: no CUDA device (pass --cpu to run "
                           "the trainer on the host)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def gpt_config():
    from paddle_tpu_torch.models import transformer as T
    return T.BertConfig(vocab_size=48, d_model=16, n_layer=2, n_head=2,
                        d_inner=32, max_pos=8, dropout=0.0)


def build(args, zero_init: bool):
    """(loss, feed maker, sparse table names, optimizer maker), the layers
    built into the current programs."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import layers, optimizer
    lr = LR[(args.model, args.mode)]
    if args.model == "regression":
        x = layers.data("x", shape=[4], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        init = ptt.initializer.ConstantInitializer(0.0) if zero_init \
            else None
        pred = layers.fc(x, size=1, bias_attr=False,
                         param_attr=ptt.ParamAttr(name="w",
                                                  initializer=init))
        loss = layers.mean(layers.square_error_cost(pred, y))
        rng = np.random.RandomState(0)     # the same data on every trainer
        w_true = np.array([[1.0], [-2.0], [3.0], [0.5]], np.float32)

        def feed(_):
            xv = rng.rand(args.batch or 16, 4).astype(np.float32)
            return {"x": xv, "y": xv @ w_true}
        return loss, feed, (), lambda: optimizer.SGD(learning_rate=lr)
    if args.model == "deepfm":
        from paddle_tpu_torch.models.ctr import build_ctr_train
        loss, _, _ = build_ctr_train(sparse_dim=args.sparse_dim,
                                     embed_size=16, is_sparse=True)
        feed = deepfm_batches(args.trainer_id, args.batch or 512,
                              args.sparse_dim)
        make = (lambda: optimizer.Adam(lr)) if args.mode == "async" else \
            (lambda: optimizer.SGD(learning_rate=lr))
        return loss, feed, ("ctr_embedding", "ctr_wide_w"), make
    from paddle_tpu_torch.models import transformer as T
    cfg = gpt_config()
    _, _, loss = T.build_gpt_pretrain(cfg, cfg.max_pos, fused_head=True,
                                      attn_impl="auto", dropout=0.0)
    rng = np.random.RandomState(args.trainer_id)

    def feed(_):
        ids = rng.randint(1, cfg.vocab_size,
                          (args.batch or 2, cfg.max_pos)).astype(np.int64)
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = 0
        return {"src_ids": ids, "lm_label": labels}
    return loss, feed, (), lambda: optimizer.AdamOptimizer(lr)


def deepfm_batches(trainer_id: int, batch: int, sparse_dim: int):
    """The bench's batches (``tools/bench_deepfm_ps.py:102-108``): dense
    features in [0, 1), per-slot ids below ``sparse_dim``, and a click
    that follows the dense features.  ``feed(step)`` draws the next."""
    rng = np.random.RandomState(trainer_id)

    def feed(_):
        dense = rng.rand(batch, 13).astype(np.float32)
        sparse = rng.randint(0, sparse_dim, (batch, 26)).astype(np.int64)
        click = (dense.sum(1, keepdims=True) > 6.5).astype(np.int64)
        return {"dense": dense, "sparse": sparse, "click": click}
    return feed


def _config(args):
    from paddle_tpu_torch.distributed import DistributeTranspilerConfig
    if args.mode == "geo":
        return DistributeTranspilerConfig(
            geo_sgd_mode=True, geo_sgd_need_push_nums=args.geo_push,
            sync_mode=False)
    return DistributeTranspilerConfig(sync_mode=args.mode == "sync")


def dense_digest(scope, names) -> str:
    """sha256 of the named parameters' bytes, in name order."""
    h = hashlib.sha256()
    for n in sorted(names):
        h.update(scope.find_var(n).detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _launches():
    import importlib
    out = {}
    for mod, names in (("dense_epilogue", ("dense_epilogue",)),
                       ("flash_attention", ("flash_attn_fwd",
                                            "flash_attn_bwd")),
                       ("layer_norm", ("layer_norm_fwd", "layer_norm_bwd"))):
        m = importlib.import_module("paddle_tpu_torch.kernels." + mod)
        for n in names:
            out[n] = m.launch_count(n)
    return out


def fence_lookups(program, eps) -> None:
    """A ``fetch_barrier`` before the first ``send``: every trainer has
    pulled its rows for this step before any trainer pushes the step's row
    gradients, which the server applies as they arrive.  Without it a slow
    trainer's lookups may read rows a fast one has already updated in the
    same step (the sync round is then not the one-process step)."""
    block = program.global_block()
    at = next(i for i, op in enumerate(block.ops) if op.type == "send")
    block.insert_op(at, "fetch_barrier", inputs={}, outputs={},
                    attrs={"endpoints": list(eps)})


def rpc_quantiles(qs=(0.5, 0.99)):
    """``paddle_tpu_ps_rpc_ms`` by op over every endpoint: the count, the
    mean, and each quantile as the upper bound of the bucket it falls in
    (``inf`` past the last)."""
    from paddle_tpu_torch.distributed import ps
    by_op = {}
    for labels, cell in ps._PS_RPC_HIST.series():
        counts, total, n = cell.snapshot()
        acc = by_op.setdefault(labels["op"], [[0] * len(counts), 0.0, 0])
        acc[0] = [a + c for a, c in zip(acc[0], counts)]
        acc[1] += total
        acc[2] += n
    bounds = list(ps._PS_RPC_HIST.buckets) + [float("inf")]
    out = {}
    for op, (counts, total, n) in sorted(by_op.items()):
        if not n:
            continue
        row = {"n": n, "mean": total / n}
        for q in qs:
            run = 0
            for b, c in zip(bounds, counts):
                run += c
                if run >= q * n:
                    row[f"p{round(q * 100)}"] = b
                    break
        out[op] = row
    return out


def reset_rpc_histogram():
    from paddle_tpu_torch.distributed import ps
    for _, cell in ps._PS_RPC_HIST.series():
        cell.reset()


def _fused_types(exe):
    return sorted({op.type for plan in exe._plans.values()
                   for op in plan.program.global_block().ops
                   if op.type.startswith("fused")})


def _session(args, mode, eps, role, tid, n_trainers, use_fleet, device,
             marks):
    """One mode of a job: build the programs, then serve (a pserver) or
    train and report (a trainer); a trainer's gang ends with a barrier and
    trainer 0 stopping the servers."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed import (DistributeTranspiler,
                                              GeoCommunicator,
                                              PaddleCloudRoleMaker, ps)
    from paddle_tpu_torch.distributed import ps_fleet as fleet
    from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                            scope_guard, unique_name)

    args.mode = mode
    marks = dict(marks, mode_start=time.time())
    steps = args.steps or {"deepfm": 11, "gpt": 3}.get(
        args.model, 20 if use_fleet else 30)
    zero_init = args.model == "regression" and not args.role
    main_prog, startup = Program(), Program()
    with unique_name.guard(), program_guard(main_prog, startup):
        loss, feed, tables, make_opt = build(args, zero_init)
        if use_fleet:
            fleet.init(PaddleCloudRoleMaker())
            fleet.distributed_optimizer(make_opt(), _config(args)) \
                .minimize(loss)
            t = fleet._transpiler
        else:
            make_opt().minimize(loss)
            t = DistributeTranspiler(_config(args))
            t.transpile(tid, program=main_prog, pservers=",".join(eps),
                        trainers=n_trainers, startup_program=startup)
    marks["built"] = time.time()
    scope = Scope()
    if role == "pserver":
        with scope_guard(scope):
            if use_fleet:
                fleet.init_server()
                marks["serving"] = time.time()
                fleet.run_server()      # blocks until a trainer stops it
            else:
                prog, pstart = t.get_pserver_programs(eps[0])
                exe = ptt.Executor(ptt.CPUPlace())
                exe.run(pstart, seed=SEED)
                marks["serving"] = time.time()
                exe.run(prog)
        marks["stopped"] = time.time()
        print("PSERVER " + json.dumps({"mode": mode, "marks": marks}),
              flush=True)
        return

    trainer_prog = fleet.main_program if use_fleet else \
        t.get_trainer_program()
    if mode == "sync" and n_trainers > 1 and t._sparse_tables:
        fence_lookups(trainer_prog, eps)
    exe = ptt.Executor(ptt.CPUPlace() if device.type == "cpu" else None)
    exe.run(startup, scope=scope, seed=SEED)
    marks["started"] = time.time()
    geo = None
    if mode == "geo":
        geo = GeoCommunicator(t, scope=scope)
        geo.init_snapshots()
    elif not zero_init and tid == 0:
        for name, spec in t._param_specs.items():
            ps.get_client(t._param_eps[name]).put(name, scope.find_var(name))
    for ep in eps:
        ps.get_client(ep).barrier()     # the tables are seeded
    marks["seeded"] = time.time()
    dense = sorted(n for n, s in t._param_specs.items() if not s["rows"])

    rounds = []
    if geo is not None:
        fed = {n: set() for n in tables}
        round_trip = geo._round_trip

        def counted(work):
            rounds.append({w["pname"]: [
                None if w["rows"] is None else int(len(w["rows"])),
                len(fed[w["pname"]])] for w in work if w["pname"] in fed})
            for s in fed.values():
                s.clear()
            round_trip(work)
        geo._round_trip = counted

    from paddle_tpu_torch.kernels import dense_epilogue, flash_attention
    dense_epilogue.reset_launch_count()
    flash_attention.reset_launch_count()
    reset_rpc_histogram()
    per_step = []
    for step in range(steps):
        fd = feed(step)
        before = dict(ps.STATS)
        t0 = time.perf_counter()
        lv, = exe.run(trainer_prog, feed=fd, fetch_list=[loss], scope=scope)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        if geo is not None:
            rows = (fd["sparse"] + np.arange(26, dtype=np.int64)
                    * args.sparse_dim).ravel()
            for name in tables:
                geo.record_rows(name, rows)
                fed[name].update(rows.tolist())
            geo.step()
        per_step.append({
            "loss": float(np.asarray(lv).reshape(-1)[0]), "ms": ms,
            "digest": dense_digest(scope, dense),
            "bytes_pushed": ps.STATS["bytes_pushed"] - before["bytes_pushed"],
            "bytes_pulled": ps.STATS["bytes_pulled"] - before["bytes_pulled"],
            "push_s": ps.STATS["push_s"] - before["push_s"],
            "pull_s": ps.STATS["pull_s"] - before["pull_s"]})
    if geo is not None:
        geo.flush()
    marks["trained"] = time.time()
    wsum = float(sum(scope.find_var(n).double().sum().item()
                     for n in dense))
    batch = len(next(iter(feed(0).values())))
    print("RESULT " + json.dumps({
        "trainer_id": tid, "model": args.model, "mode": mode,
        "trainers": n_trainers, "device": str(device),
        "losses": [s["loss"] for s in per_step],
        "step_ms": [s["ms"] for s in per_step],
        "examples_per_s": [batch / (s["ms"] / 1e3) for s in per_step],
        "digests": [s["digest"] for s in per_step],
        "bytes_pushed": [s["bytes_pushed"] for s in per_step],
        "bytes_pulled": [s["bytes_pulled"] for s in per_step],
        "push_s": [s["push_s"] for s in per_step],
        "pull_s": [s["pull_s"] for s in per_step],
        "geo_rounds": rounds, "launches": _launches(),
        "rpc_ms": rpc_quantiles(),
        "fused": _fused_types(exe), "wsum": wsum,
        "dense_params": dense, "marks": marks}), flush=True)
    # every trainer is done before anyone stops a server (ref
    # SendComplete / send_barrier shutdown protocol)
    if use_fleet:
        fleet.stop_worker()
    else:
        for ep in eps:
            ps.get_client(ep).barrier()
    if tid == 0 and mode == "async" and not use_fleet:
        # every push has landed: the final tables against the startup's
        print("EVAL " + json.dumps(async_eval(args, t, startup, exe,
                                              n_trainers)), flush=True)
    if tid == 0:
        for ep in eps:
            ps.get_client(ep).stop_server()
    ps.reset_clients()


#: the batches of each trainer that :func:`async_eval` scores
EVAL_BATCHES = 3


def async_eval(args, t, startup, exe, n_trainers):
    """The loss of the startup's parameters and of the servers' final
    ones, both in this process, on the first ``EVAL_BATCHES`` batches of
    every trainer: ``{"init": [...], "final": [...]}`` (trainer-major).
    It runs once every trainer has passed the final barrier, when no push
    is in flight.  Both are scored on the same batches in one process, so
    whether async training helped is not read off the losses the trainers
    saw along the way, which other trainers' pushes raced and which came
    from other batches."""
    import torch
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                            unique_name)
    init, final = Scope(), Scope()
    exe.run(startup, scope=init, seed=SEED)
    exe.run(startup, scope=final, seed=SEED)
    for name, spec in t._param_specs.items():
        like = init.find_var(name)
        got = ps.get_client(t._param_eps[name]).get(
            name, int(np.prod(spec["shape"])), barrier=False)
        final.set_var(name, torch.from_numpy(got).to(
            like.device, like.dtype).reshape(like.shape))
    out = {"init": [], "final": []}
    for tid in range(n_trainers):
        # the trainer's own feed, the same parameter names
        ev = Program()
        with unique_name.guard(), program_guard(ev, Program()):
            loss, feed = build(argparse.Namespace(**dict(
                vars(args), trainer_id=tid)), zero_init=False)[:2]
        batches = [feed(k) for k in range(EVAL_BATCHES)]
        for tag, sc in (("init", init), ("final", final)):
            for fd in batches:
                lv, = exe.run(ev, feed=fd, fetch_list=[loss], scope=sc)
                out[tag].append(float(np.asarray(lv).reshape(-1)[0]))
    return out


def main(argv=None) -> int:
    marks = {"start": time.time()}
    args = parse_args(argv)
    role, tid, eps, n_trainers, from_env = _role(args)
    args.trainer_id = tid
    modes = args.mode.split(",")
    if len(modes) > 1 and len(eps) != len(modes):
        raise ValueError(f"ps_runner: {len(modes)} modes need as many "
                         f"pservers, one a mode (got {len(eps)})")
    if role == "pserver":
        os.environ["CUDA_VISIBLE_DEVICES"] = ""     # the tables are host
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    device = _device(args.cpu or role == "pserver")
    import paddle_tpu_torch  # noqa: F401
    marks["imported"] = time.time()
    if len(modes) == 1:
        _session(args, modes[0], eps, role, tid, n_trainers, from_env,
                 device, marks)
    elif role == "pserver":
        k = int(os.environ.get("PADDLE_PSERVER_ID", "0"))
        _session(args, modes[k], [eps[k]], role, tid, n_trainers, False,
                 device, marks)
    else:
        for mode, ep in zip(modes, eps):
            _session(args, mode, [ep], role, tid, n_trainers, False,
                     device, marks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
