"""Collective data parallelism in the port against the JAX package, on the CPU.

The reference runs collective mode through its ``shard_map`` over n of the
8 CPU devices the conftest makes; the port runs it rank by rank over
``make_mesh({"dp": n}, [cpu] * n)`` (virtual ranks).

- all 14 ``c_*`` op types are registered; each over 2 and 4 ranks gives the
  reference's per-rank outputs on seeded inputs exactly (XLA's CPU
  allreduce also sums float32 in rank order), and each is the identity
  outside collective mode;
- a ``c_*`` op without a gradient (``c_allreduce_max``, as the reference's
  ``lax.pmax``) in the forward of a program with a backward raises
  ``NotImplementedError``, and autograd through one rank of a collective
  does too (the gradients of the others: ``test_torch_collective_grads``);
- ``hierarchical_allreduce`` over ``make_hierarchical_mesh(2, 4)`` sums all
  ranks (the reference's ``test_parallel.py`` case);
- training: the reference's ``test_comms.py`` MLP under ``GradAllReduce``
  (float32 and ``compress="bf16"``) and ``LocalSGD``, and a tiny GPT (2
  layers, d 32) with Adam under ``GradAllReduce``, 4 steps at dp 2 and 4
  from the reference's initial weights (``params_from_numpy``): the
  stacked per-rank losses equal the reference's, shapes included, within
  rtol 1e-5 + atol 1e-6 (bf16: rtol 1e-3 + atol 1e-4, a bf16 ulp of the
  averaged gradient); the state after the steps within the same bounds,
  but the GPT's parameters within 1e-5 (a hundredth of an Adam step at lr
  1e-3: Adam turns float32 noise on near-zero gradients into steps) and
  ``qkv.b`` within ``STEPS * lr`` (its key third's exact gradient is 0);
  every rank's parameters bit for bit (``Executor.verify_replicas``); the
  GPT cases run in ``test_torch_collective_gpt.py`` (the reference's
  compiles take ~10 s each);
- a conv + ``batch_norm`` net at dp 2: the scope's running mean and
  variance equal the reference's pmean'd ones;
- the rank seed: at dropout 0.1 rank r's mask is the mask a one-rank run
  at ``seed + r * 1000003`` draws;
- ``FLAGS_numerics`` with the ``numerics.poison`` site on one rank trips the
  sentinel;
- a batch the ranks do not divide raises, and so does a collective program
  with fewer devices than ranks and no mesh; a plan built for one rank
  count never runs another.

Nothing here starts a process or a ``torch.distributed`` group.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.distributed.transpiler import GradAllReduce as RefGAR
from paddle_tpu.distributed.transpiler import LocalSGD as RefLocalSGD
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.models import transformer as RT
from paddle_tpu_torch import flags
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.analysis import numerics
from paddle_tpu_torch.distributed import GradAllReduce, LocalSGD
from paddle_tpu_torch.distributed.collective_ops import COLLECTIVE_OP_TYPES
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.parallel import (hierarchical_allreduce,
                                       make_hierarchical_mesh, make_mesh,
                                       set_mesh)
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=1e-3, atol=1e-4)
STEPS = 4
GPT_CFG = dict(vocab_size=64, d_model=32, n_layer=2, n_head=4, d_inner=64,
               max_pos=16, dropout=0.0)
GPT_LR = 1e-3

REF = SimpleNamespace(root=pt, layers=pt.layers, opt=ref_opt,
                      names=ref_names, T=RT, GAR=RefGAR, LocalSGD=RefLocalSGD)
PORT = SimpleNamespace(root=ptt, layers=ptt.layers, opt=opt,
                       names=unique_name, T=T, GAR=GradAllReduce,
                       LocalSGD=LocalSGD)


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh port default programs, scope, names; no mesh after."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    set_mesh(None)
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


def _eps(n):
    return ",".join(f"127.0.0.1:{6170 + i}" for i in range(n))


def _dp_mesh(n):
    set_mesh(make_mesh({"dp": n}, [CPU] * n))


# -- the op types ---------------------------------------------------------------

def test_all_14_collective_op_types_are_registered():
    from paddle_tpu.framework import registry as ref_registry
    assert len(COLLECTIVE_OP_TYPES) == 14
    for t in COLLECTIVE_OP_TYPES:
        assert registry.has_op(t) and ref_registry.has_op(t), t
    group = {t for t in COLLECTIVE_OP_TYPES
             if registry.get_op_info(t).collective}
    assert group == {"c_allreduce_sum", "c_allreduce_max",
                     "c_allreduce_min", "c_allreduce_prod", "c_broadcast",
                     "c_allgather", "c_reducescatter"}


# op type -> (attrs, per-rank rows, input scale/offset)
OP_CASES = {
    "c_allreduce_sum": ({"ring_id": 0}, 2),
    "c_allreduce_max": ({"ring_id": 0}, 2),
    "c_allreduce_min": ({"ring_id": 0}, 2),
    "c_allreduce_prod": ({"ring_id": 0}, 2),
    "c_broadcast": ({"ring_id": 0, "root": 1}, 2),
    "c_allgather": ({"ring_id": 0}, 2),
    "c_reducescatter": ({"ring_id": 0}, 4),
    "c_split": ({"ring_id": 0}, 4),
    "c_sync_calc_stream": ({}, 2),
    "c_sync_comm_stream": ({}, 2),
}


def _op_program(pkg, op_type, attrs, n):
    with pkg.names.guard():
        main, startup = pkg.root.Program(), pkg.root.Program()
        with pkg.root.program_guard(main, startup):
            x = pkg.layers.data("x", shape=[3], dtype="float32")
            blk = main.global_block()
            out = blk.create_var(name="out", dtype="float32")
            blk.append_op(op_type, inputs={"X": [x]},
                          outputs={"Out": [out]}, attrs=attrs)
    if n:
        main._attrs["collective"] = {"nranks": n, "rank": 0}
    return main


def _op_input(op_type, rows):
    x = np.random.RandomState(7).randn(rows, 3).astype(np.float32)
    return 1.0 + 0.1 * x if op_type == "c_allreduce_prod" else x


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op_type", sorted(OP_CASES))
def test_collective_op_matches_reference(op_type, n):
    attrs, rows = OP_CASES[op_type]
    xv = _op_input(op_type, rows * n)
    ref_main = _op_program(REF, op_type, attrs, n)
    want, = RefExecutor().run(ref_main, feed={"x": xv}, fetch_list=["out"],
                              scope=RefScope())
    want = np.asarray(want)
    _dp_mesh(n)
    main = _op_program(PORT, op_type, attrs, n)
    got, = ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"x": xv}, fetch_list=["out"], scope=scope.Scope())
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op_type", sorted(OP_CASES))
def test_collective_op_is_the_identity_outside_collective_mode(op_type):
    attrs, rows = OP_CASES[op_type]
    xv = _op_input(op_type, rows)
    main = _op_program(PORT, op_type, attrs, 0)
    got, = ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"x": xv}, fetch_list=["out"], scope=scope.Scope())
    np.testing.assert_array_equal(got, xv)


def test_bootstrap_ops_do_nothing_and_transpile_adds_them():
    main, startup, _ = _build(PORT, "mlp", "grad_allreduce", 2)
    types = [op.type for op in startup.global_block().ops]
    assert types[-2:] == ["c_gen_nccl_id", "c_comm_init"]
    for t in ("c_gen_nccl_id", "c_comm_init", "c_comm_init_all",
              "gen_nccl_id"):
        assert registry.get_op_info(t).lower(None, {}, {}) == {}
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope.Scope())


def test_collective_under_autograd_raises_not_implemented():
    """A collective with no gradient in the forward of a program with a
    backward must never compute a wrong gradient quietly."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", shape=[4], dtype="float32")
        h = ptt.layers.fc(x, size=4)
        blk = main.global_block()
        s = blk.create_var(name="h_max", dtype="float32")
        blk.append_op("c_allreduce_max", inputs={"X": [h]},
                      outputs={"Out": [s]}, attrs={"ring_id": 0})
        loss = ptt.layers.mean(s)
        opt.SGDOptimizer(0.1).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup)
    xv = np.ones((4, 4), np.float32)
    with pytest.raises(NotImplementedError, match="no gradient"):
        exe.run(main, feed={"x": xv}, fetch_list=[loss])
    main._attrs["collective"] = {"nranks": 2, "rank": 0}
    _dp_mesh(2)
    with pytest.raises(NotImplementedError, match="no gradient"):
        exe.run(main, feed={"x": xv}, fetch_list=[loss])
    with pytest.raises(NotImplementedError, match="group VJP"):
        registry.run_forward(registry.get_op_info("c_allreduce_sum"),
                             None, {"X": [torch.ones(2)]}, {})


def test_hierarchical_mesh_and_allreduce():
    """2-level dcn x ici mesh: the hierarchical sum equals the flat sum
    (the reference's test_parallel.py case), on every rank, in copies."""
    mesh = make_hierarchical_mesh(2, 4, [CPU] * 8)
    assert mesh.shape == {"dcn": 2, "ici": 4}
    xs = [torch.tensor([float(i)]) for i in range(8)]
    out = hierarchical_allreduce(xs, mesh)
    assert [float(o) for o in out] == [28.0] * 8
    assert len({o.data_ptr() for o in out}) == 8
    with pytest.raises(ValueError):
        hierarchical_allreduce(xs[:4], mesh)


# -- training parity --------------------------------------------------------------

def _mlp(pkg):
    x = pkg.layers.data("x", shape=[8], dtype="float32")
    y = pkg.layers.data("y", shape=[1], dtype="float32")
    h = pkg.layers.fc(x, size=16, act="tanh")
    pred = pkg.layers.fc(h, size=1)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    pkg.opt.SGDOptimizer(0.1).minimize(loss)
    return loss


def _mlp_feeds():
    rng = np.random.RandomState(3)
    out = []
    for _ in range(STEPS):
        xv = rng.rand(8, 8).astype(np.float32)
        out.append({"x": xv, "y": xv.sum(1, keepdims=True)})
    return out


def _gpt(pkg):
    _, _, loss = pkg.T.build_gpt_pretrain(
        pkg.T.BertConfig(**GPT_CFG), 16, attn_impl="base", fused_head=False,
        dropout=0.0)
    pkg.opt.AdamOptimizer(GPT_LR).minimize(loss)
    return loss


def _gpt_feeds():
    rng = np.random.RandomState(5)
    out = []
    for _ in range(STEPS):
        ids = rng.randint(1, GPT_CFG["vocab_size"], (8, 16)).astype(np.int64)
        lab = np.roll(ids, -1, axis=1)
        lab[:, -1] = 0
        out.append({"src_ids": ids, "lm_label": lab})
    return out


def _bn_net(pkg):
    img = pkg.layers.data("img", shape=[3, 8, 8], dtype="float32")
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    c = pkg.layers.conv2d(img, num_filters=4, filter_size=3, padding=1)
    b = pkg.layers.batch_norm(c, act="relu")
    p = pkg.layers.pool2d(b, pool_type="avg", global_pooling=True)
    pred = pkg.layers.fc(p, size=4, act="softmax")
    loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
    pkg.opt.MomentumOptimizer(0.1, 0.9).minimize(loss)
    return loss


def _bn_feeds():
    rng = np.random.RandomState(9)
    return [{"img": rng.randn(8, 3, 8, 8).astype(np.float32),
             "label": rng.randint(0, 4, (8, 1)).astype(np.int64)}
            for _ in range(STEPS)]


MODELS = {"mlp": (_mlp, _mlp_feeds), "gpt": (_gpt, _gpt_feeds),
          "bn": (_bn_net, _bn_feeds)}


def _build(pkg, model, transpiler, n):
    with pkg.names.guard():
        main, startup = pkg.root.Program(), pkg.root.Program()
        with pkg.root.program_guard(main, startup):
            loss = MODELS[model][0](pkg)
            if transpiler is not None:
                t = {"grad_allreduce": lambda: pkg.GAR(),
                     "grad_allreduce_bf16": lambda: pkg.GAR(compress="bf16"),
                     "local_sgd": lambda: pkg.LocalSGD()}[transpiler]()
                t.transpile(startup_program=startup, main_program=main,
                            rank=0, endpoints=_eps(n),
                            current_endpoint=_eps(n).split(",")[0])
    return main, startup, loss.name


def _persistables(main):
    return [n for n, v in main.global_block().vars.items() if v.persistable]


def _ref_train(model, transpiler, n):
    main, startup, loss = _build(REF, model, transpiler, n)
    sc, exe = RefScope(), RefExecutor()
    exe.run(startup, scope=sc, seed=11)
    init = {k: np.asarray(sc.find_var(k)) for k in _persistables(main)
            if sc.find_var(k) is not None}
    losses = [np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                 scope=sc)[0])
              for f in MODELS[model][1]()]
    state = {k: np.asarray(sc.find_var(k)) for k in init}
    return main, init, losses, state


def _port_train(model, transpiler, n, init):
    main, startup, loss = _build(PORT, model, transpiler, n)
    sc, exe = scope.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=11)
    params_from_numpy(sc, init)
    _dp_mesh(n)
    exe.verify_replicas = True
    losses = [exe.run(main, feed=f, fetch_list=[loss], scope=sc)[0]
              for f in MODELS[model][1]()]
    assert exe.replica_report["ranks"] == n
    assert exe.replica_report["tensors"] == len(
        [p for p in main.all_parameters() if p.trainable])
    assert exe.replica_report["mismatched"] == []
    state = {k: sc.find_var(k).float().numpy() for k in init}
    return main, losses, state


TRAIN_CASES = [("mlp", "grad_allreduce"), ("mlp", "grad_allreduce_bf16"),
               ("mlp", "local_sgd"), ("gpt", "grad_allreduce")]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("model,transpiler", TRAIN_CASES[:3])
def test_training_matches_reference(model, transpiler, n):
    check_training(model, transpiler, n)


def check_training(model, transpiler, n):
    """Train ``model`` in both packages and hold the port to the
    reference (the module docstring's bounds); ``test_torch_collective_gpt``
    runs the GPT case."""
    ref_main, init, want, ref_state = _ref_train(model, transpiler, n)
    main, got, state = _port_train(model, transpiler, n, init)
    assert [op.type for op in main.global_block().ops] == \
        [op.type for op in ref_main.global_block().ops]
    tol = BF16_TOL if transpiler.endswith("bf16") else TOL
    for g, w in zip(got, want):
        assert g.shape == w.shape == (n,), (g.shape, w.shape)
        np.testing.assert_allclose(g, w, **tol)
    params = {p.name for p in main.all_parameters()}
    for k, w in ref_state.items():
        tol_k = tol
        if model == "gpt" and k.endswith("qkv.b"):
            # the key third's exact gradient is 0: Adam steps on noise
            tol_k = dict(rtol=0, atol=STEPS * GPT_LR)
        elif model == "gpt" and k in params:
            # Adam turns float32 noise on near-zero gradients into steps:
            # a hundredth of one step at lr 1e-3
            tol_k = dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(state[k], w, err_msg=k, **tol_k)


def test_batch_norm_running_stats_are_the_reference_pmean():
    ref_main, init, want, ref_state = _ref_train("bn", "grad_allreduce", 2)
    main, got, state = _port_train("bn", "grad_allreduce", 2, init)
    bn = next(op for op in main.global_block().ops
              if op.type == "batch_norm")
    stats = bn.input("Mean") + bn.input("Variance")
    assert len(stats) == 2
    for k in stats:
        assert not np.allclose(ref_state[k], init[k])
        np.testing.assert_allclose(state[k], ref_state[k], err_msg=k, **TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def _dropout_program(pkg, n):
    with pkg.names.guard():
        main, startup = pkg.root.Program(), pkg.root.Program()
        with pkg.root.program_guard(main, startup):
            x = pkg.layers.data("x", shape=[64], dtype="float32")
            out = pkg.layers.dropout(x, 0.1)
    if n:
        main._attrs["collective"] = {"nranks": n, "rank": 0}
    return main, out.name


def test_rank_r_draws_from_seed_plus_r_times_1000003():
    n, seed = 4, 12345
    xv = np.ones((8, 64), np.float32)
    main, out = _dropout_program(PORT, n)
    _dp_mesh(n)
    exe = ptt.Executor(ptt.CPUPlace())
    got, = exe.run(main, feed={"x": xv}, fetch_list=[out], seed=seed)
    assert got.shape == (n, 2, 64)
    single, out1 = _dropout_program(PORT, 0)
    masks = []
    for r in range(n):
        want, = exe.run(single, feed={"x": xv[2 * r:2 * r + 2]},
                        fetch_list=[out1],
                        seed=(seed + r * 1000003) % 2 ** 32)
        np.testing.assert_array_equal(got[r], want)
        masks.append(want == 0)
    assert 0 < np.mean(masks) < 0.3
    assert not all((m == masks[0]).all() for m in masks[1:])


def test_numerics_poison_on_one_rank_trips_the_sentinel():
    main, startup, loss = _build(PORT, "mlp", "grad_allreduce", 2)
    sc, exe = scope.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=11)
    _dp_mesh(2)
    numerics.ENGINE.reset()
    feeds = _mlp_feeds()
    try:
        flags.set_flags({"FLAGS_numerics": "sentinel"})
        exe.run(main, feed=feeds[0], fetch_list=[loss], scope=sc)
        numerics.ENGINE.poll(force=True)
        assert numerics.ENGINE.last_frame.nonfinite == 0
        flags.set_flags({"FLAGS_fault_inject": "numerics.poison:once"})
        exe.run(main, feed=feeds[1], fetch_list=[loss], scope=sc)
        numerics.ENGINE.poll(force=True)
        frame = numerics.ENGINE.last_frame
        assert frame.nonfinite > 0
        assert [r for r in numerics.ENGINE.anomalies
                if r["kind"] == "nonfinite"]
    finally:
        flags.set_flags({"FLAGS_numerics": "off", "FLAGS_fault_inject": ""})
        numerics.clear_quarantine()
        numerics.ENGINE.reset()


def test_stacked_numerics_frame_adds_counts_over_ranks():
    main, startup, loss = _build(PORT, "mlp", "grad_allreduce", 2)
    sc, exe = scope.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=11)
    _dp_mesh(2)
    numerics.ENGINE.reset()
    try:
        flags.set_flags({"FLAGS_numerics": "sentinel"})
        exe.run(main, feed=_mlp_feeds()[0], fetch_list=[loss], scope=sc)
        numerics.ENGINE.poll(force=True)
        frame = numerics.ENGINE.last_frame
        assert frame.nonfinite == 0 and np.isfinite(frame.global_gnorm)
        assert frame.global_gnorm > 0
    finally:
        flags.set_flags({"FLAGS_numerics": "off"})
        numerics.ENGINE.reset()


def test_indivisible_batch_and_missing_devices_raise():
    main, startup, loss = _build(PORT, "mlp", "grad_allreduce", 4)
    sc, exe = scope.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=11)
    xv = np.ones((6, 8), np.float32)
    feed = {"x": xv, "y": xv[:, :1]}
    # no mesh and no card: four ranks have no devices
    with pytest.raises(ValueError, match="needs 4 devices"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=sc)
    # a dp mesh of two ranks is fewer than the program's four
    _dp_mesh(2)
    with pytest.raises(ValueError, match="needs 4 devices"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=sc)
    _dp_mesh(4)
    with pytest.raises(ValueError, match="do not divide"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=sc)


def test_plan_is_keyed_by_rank_count_and_mesh():
    """The same program stamped for 2 then 4 ranks never reuses the 2-rank
    plan: the stacked fetch follows the rank count."""
    main, startup, loss = _build(PORT, "mlp", "grad_allreduce", 2)
    sc, exe = scope.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=11)
    feed = _mlp_feeds()[0]
    _dp_mesh(2)
    assert exe.run(main, feed=feed, fetch_list=[loss],
                   scope=sc)[0].shape == (2,)
    main._attrs["collective"] = {"nranks": 4, "rank": 0}
    _dp_mesh(4)
    assert exe.run(main, feed=feed, fetch_list=[loss],
                   scope=sc)[0].shape == (4,)
    misses = exe.dispatch_stats()["cache_misses"]
    _dp_mesh(4)    # an equal mesh is the same key
    exe.run(main, feed=feed, fetch_list=[loss], scope=sc)
    assert exe.dispatch_stats()["cache_misses"] == misses
    # one step a run in the dispatch ledger, not one a rank
    assert exe.dispatch_stats()["steps_dispatched"] == 4


def test_transpiled_programs_serialize_like_the_reference():
    for model, transpiler in TRAIN_CASES:
        for n in (2, 4):
            ref = _build(REF, model, transpiler, n)
            ours = _build(PORT, model, transpiler, n)
            for a, b in zip(ours[:2], ref[:2]):
                assert json.loads(a.serialize_to_string()) == \
                    json.loads(b.serialize_to_string()), (model, transpiler)
            assert ours[0]._attrs["collective"] == \
                ref[0]._attrs["collective"] == {"nranks": n, "rank": 0}
