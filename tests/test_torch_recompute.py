"""Activation recompute (``framework/recompute.py``, ``RecomputeOptimizer``):
the port against the JAX package, on the CPU.

- the reference's four recompute tests (``tests/test_recompute.py``) run
  against the port: bit-identical losses with and without recompute,
  tagged dropout replayed in the chain, untagged dropout kept stored, the
  ``backward`` → ``apply_gradients`` flow.  The port has no ``tanh`` or
  ``square_error_cost`` op, so its 3-layer model takes ``sigmoid`` and
  ``mean((pred - y)²)``; the structural tests build that model in both
  packages;
- the port's recomputed program against the reference's, for that model
  and a 3-layer AMP BERT under LAMB: the same vars and the same multiset
  of ops, names and attributes.  Only the position of the recomputed
  chains differs: the reference puts every chain right after the
  loss-grad seed, the port each segment's chain (its barriers, then its
  clones) right before the first backward op that reads one of its
  values or the gradient of one of its outputs;
- the executor's plan: every generic grad op of a cloned forward takes
  the clone's graph, no original op of a recomputed segment keeps one,
  and the barriers nothing reads are left out of the plan;
- a 2-layer AMP BERT (dropout 0.1, ``checkpoints=[]``, fusion on with
  the autotuner's verdicts forced to "win" in both packages) through
  ``amp.decorate(RecomputeOptimizer(Lamb))``, 3 steps: its losses against
  the reference run op by op (``jax.disable_jit``) within the AMP
  tolerance (2e-3 relative), both packages drawing the same dropout bits;
  and the port's runs with and without recompute equal to the bit, the
  original FFN chain and its clone both fused.
"""

import json

import jax
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import amp as ref_amp
from paddle_tpu import layers as ref_layers
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.analysis import fusion as ref_fusion
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.models import transformer as RT
from paddle_tpu_torch import amp, flags, layers
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.analysis import fusion
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.framework.recompute import (BARRIER_SUFFIX,
                                                  RECOMPUTE_SUFFIX,
                                                  source_name)
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.models import transformer as T
from _port_fixtures import collect_garbage_after_module  # noqa: F401
from _port_fixtures import patch_same_bits

BERT = dict(vocab_size=64, d_model=32, n_layer=2, n_head=4, d_inner=64,
            max_pos=16, dropout=0.1)
SEQ, BATCH, LR, STEPS = 16, 2, 1e-3, 3
AMP_LOSS_RTOL = 2e-3
WIN = {"base_ms": 1.0, "fused_ms": 0.5, "win": True, "cached": False}
DEFAULTS = {"FLAGS_graph_fusion": True, "FLAGS_fusion_autotune": False,
            "FLAGS_fusion_rank_threshold": 0.02,
            "FLAGS_xla_compile_cache_dir": ""}


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    fusion.clear_cache()
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)
    flags.set_flags(DEFAULTS)
    fusion.clear_cache()


# -- the reference's four tests, against the port -----------------------------

def _build(L, n_layers=3):
    x = L.data("x", shape=[16], dtype="float32")
    y = L.data("y", shape=[1], dtype="float32")
    h = x
    ckpts = []
    for _ in range(n_layers):
        h = L.fc(h, size=16, act="sigmoid")
        ckpts.append(h)
    pred = L.fc(h, size=1)
    d = pred - y
    return L.mean(d * d), ckpts


def _xy(rng, n=8):
    xv = rng.rand(n, 16).astype(np.float32)
    return {"x": xv, "y": xv.sum(1, keepdims=True).astype(np.float32)}


def _train(recompute, steps=10, compiled=False):
    """Losses of ``steps`` steps of the 3-layer model, the program run (a
    ``CompiledProgram`` over it with ``compiled``) and the executor."""
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup), unique_name.guard():
        loss, ckpts = _build(layers)
        o = opt.Adam(0.01)
        if recompute:
            o = opt.RecomputeOptimizer(o)
            o._set_checkpoints(ckpts)
        o.minimize(loss)
    if compiled:
        main = ptt.CompiledProgram(main)
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc, seed=11)
    rng = np.random.RandomState(0)
    out = [float(exe.run(main, feed=_xy(rng), fetch_list=[loss],
                         scope=sc)[0]) for _ in range(steps)]
    return out, main, exe


def _types(prog):
    return [op.type for op in prog.global_block().ops]


def test_recompute_exact_parity():
    base, _, _ = _train(False)
    rc, prog, _ = _train(True)
    np.testing.assert_allclose(base, rc, rtol=0, atol=0)
    assert "optimization_barrier" in _types(prog)
    assert any(RECOMPUTE_SUFFIX in n for op in prog.global_block().ops
               for n in op.output_arg_names())


def _dropout_program(tagged):
    """fc → dropout (tagged, or seed 0 made by hand) → fc → fc, the first
    fc's output the one checkpoint, under RecomputeOptimizer(SGD)."""
    x = layers.data("x", shape=[16], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    h = layers.fc(x, size=16, act="sigmoid")
    c1 = h
    if tagged:
        h = layers.dropout(h, dropout_prob=0.5)
    else:
        helper = LayerHelper("dropout")
        out = helper.create_variable_for_type_inference(h.dtype)
        mask = helper.create_variable_for_type_inference("uint8", True)
        helper.append_op("dropout", inputs={"X": [h]},
                         outputs={"Out": [out], "Mask": [mask]},
                         attrs={"dropout_prob": 0.5, "is_test": False,
                                "seed": 0, "dropout_implementation":
                                    "downgrade_in_infer"})
        h = out
    h = layers.fc(h, size=16, act="sigmoid")
    pred = layers.fc(h, size=1)
    d = pred - y
    loss = layers.mean(d * d)
    o = opt.RecomputeOptimizer(opt.SGD(0.1))
    o._set_checkpoints([c1])
    o.minimize(loss)
    return loss


def _recomputed_dropouts(prog):
    return [op for op in prog.global_block().ops if op.type == "dropout"
            and any(RECOMPUTE_SUFFIX in n for n in op.output_arg_names())]


def test_recompute_replays_tagged_dropout():
    loss = _dropout_program(tagged=True)
    prog = core.default_main_program()
    assert _recomputed_dropouts(prog), \
        "tagged dropout should re-emit in the remat chain"
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(core.default_startup_program(), seed=3)
    rng = np.random.RandomState(1)
    for _ in range(8):
        last, = exe.run(feed=_xy(rng), fetch_list=[loss])
    assert np.isfinite(float(last))


def test_recompute_keeps_untagged_dropout_stored():
    loss = _dropout_program(tagged=False)
    prog = core.default_main_program()
    assert not _recomputed_dropouts(prog)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(core.default_startup_program(), seed=3)
    last, = exe.run(feed=_xy(np.random.RandomState(1)), fetch_list=[loss])
    assert np.isfinite(float(last))


def test_backward_entry_point_applies_recompute():
    loss, ckpts = _build(layers)
    o = opt.RecomputeOptimizer(opt.SGD(0.1))
    o._set_checkpoints(ckpts)
    o.apply_gradients(o.backward(loss))
    prog = core.default_main_program()
    assert "optimization_barrier" in _types(prog)
    # weights are NOT fenced (barriers only on stored activations)
    for op in prog.global_block().ops:
        if op.type == "optimization_barrier":
            v = prog.global_block().vars.get(op.input("X")[0])
            assert v is None or not v.persistable
    n_ops = len(prog.global_block().ops)
    o._apply(prog)          # idempotent
    assert len(prog.global_block().ops) == n_ops
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(core.default_startup_program())
    lv, = exe.run(feed=_xy(np.random.RandomState(2), 4), fetch_list=[loss])
    assert np.isfinite(float(lv))


# -- the recomputed program against the reference's ---------------------------

def _no_decay(p):
    return p.name.endswith(".b") or ".ln" in p.name


def _bert(M, n_layer, ckpts):
    cfg = M.BertConfig(**dict(BERT, n_layer=n_layer))
    return M.build_bert_pretrain(cfg, SEQ, fused_head=True, arange_pos=True,
                                 checkpoints=ckpts)[2]


def _both_recomputed(model, recompute=True):
    """``model`` built in each package under RecomputeOptimizer: the fc
    model under Adam, BERT under ``amp.decorate(RecomputeOptimizer(Lamb))``
    (its ``exclude_from_weight_decay_fn`` on LayerNorms and biases).
    Returns {"ref"|"port": (main, startup, loss name)}."""
    out = {}
    for pkg in ("ref", "port"):
        if pkg == "ref":
            main, startup = RefProgram(), RefProgram()
            guard, names, L, O, A, M = (ref_guard(main, startup),
                                        ref_names.guard(), ref_layers,
                                        ref_opt, ref_amp, RT)
        else:
            main, startup = core.Program(), core.Program()
            guard, names, L, O, A, M = (core.program_guard(main, startup),
                                        unique_name.guard(), layers, opt,
                                        amp, T)
        with guard, names:
            ckpts = [] if recompute else None
            if model == "fc":
                loss, ckpts = _build(L)
                inner = O.Adam(0.01)
            else:
                loss = _bert(M, int(model[4:]), ckpts)
                inner = O.LambOptimizer(
                    LR, exclude_from_weight_decay_fn=_no_decay)
            o = O.RecomputeOptimizer(inner) if recompute else inner
            if recompute:
                o._set_checkpoints(ckpts)
            (A.decorate(o) if model != "fc" else o).minimize(loss)
        out[pkg] = (main, startup, loss.name)
    return out


def _ops(prog):
    d = json.loads(prog.serialize_to_string())
    return d["blocks"][0]["vars"], [json.dumps(op, sort_keys=True)
                                    for op in d["blocks"][0]["ops"]]


def _in_chain(op) -> bool:
    op = json.loads(op)
    return op["type"] == "optimization_barrier" or any(
        RECOMPUTE_SUFFIX in n for ns in op["outputs"].values() for n in ns)


def _seed_index(ops):
    return next(i for i, op in enumerate(ops)
                if json.loads(op)["type"] == "fill_constant" and any(
                    n.endswith("@GRAD") for ns in json.loads(op)["outputs"]
                    .values() for n in ns))


def _chains(ops):
    """(start, end) of each maximal run of chain ops."""
    runs, start = [], None
    for i, op in enumerate(ops + ["{}"]):
        if op != "{}" and _in_chain(op):
            start = i if start is None else start
        elif start is not None:
            runs.append((start, i))
            start = None
    return runs


def _reads(op):
    return {n for ns in json.loads(op)["inputs"].values() for n in ns}


def _writes(op):
    return {n for ns in json.loads(op)["outputs"].values() for n in ns if n}


@pytest.mark.parametrize("model", ["fc", "bert3"])
def test_recomputed_program_matches_reference(model):
    progs = _both_recomputed(model)
    ref_vars, ref_ops = _ops(progs["ref"][0])
    port_vars, port_ops = _ops(progs["port"][0])
    # a var the transform made copies its source's shape and dtype: the
    # same where the packages record the source alike (a tagged dropout's
    # unwritten Mask has no inferred shape in the port)
    assert set(port_vars) == set(ref_vars)
    for n in port_vars:
        src = source_name(n)
        if port_vars[src] == ref_vars[src]:
            assert port_vars[n] == ref_vars[n], n
    assert sorted(port_ops) == sorted(ref_ops)
    assert [o for o in port_ops if not _in_chain(o)] == \
        [o for o in ref_ops if not _in_chain(o)]
    # the reference: one run of chain ops right after the seed
    seed = _seed_index(ref_ops)
    assert _chains(ref_ops) == [(seed + 1, seed + 1 + sum(
        map(_in_chain, ref_ops)))]
    # the port: one run a segment (layers 2-3 and the loss), each right
    # before its first reader
    _assert_chains_before_readers(port_ops, n_segments=3)


def _assert_chains_before_readers(ops, n_segments):
    """``ops`` (``_ops``' form) hold one run of chain ops a segment, each
    after the seed and right before the first op reading a value of it or
    the gradient of one of its outputs."""
    runs = _chains(ops)
    assert len(runs) == n_segments
    seed = _seed_index(ops)
    for start, end in runs:
        made = set().union(*map(_writes, ops[start:end]))
        wanted = made | {n.split(RECOMPUTE_SUFFIX)[0] + "@GRAD"
                         for n in made if RECOMPUTE_SUFFIX in n}
        assert start > seed
        assert _reads(ops[end]) & wanted, ops[end]
        assert not any(_reads(op) & wanted for op in ops[seed + 1:start])


def test_compiled_program_keeps_the_chains_in_place():
    """``CompiledProgram``'s passes re-emit a program from its graph: dead-op
    elimination drops the barriers no clone reads, the fusion pass runs,
    and a recomputed program keeps its order through both, so each
    segment's chain still runs just before its backward."""
    base, _, _ = _train(False, steps=3)
    got, compiled, _ = _train(True, steps=3, compiled=True)
    assert got == base
    main = compiled.program
    optimized, = compiled._optimized_cache.values()
    assert main._attrs.get("__recompute__") and \
        optimized._attrs.get("__recompute__")
    n_barriers = _types(main).count("optimization_barrier")
    assert 0 < _types(optimized).count("optimization_barrier") < n_barriers
    _assert_chains_before_readers(_ops(optimized)[1], n_segments=3)


def test_plan_pairs_each_grad_op_with_the_clone():
    progs = _both_recomputed("bert2")
    main, startup, loss = progs["port"]
    flags.set_flags({"FLAGS_graph_fusion": False})
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc, seed=2)
    exe.run(main, feed=_bert_feed(0), fetch_list=[loss], scope=sc)
    plan, = [p for p in exe._plans.values()
             if any(op.type == "lamb" for op, _ in p.ops)]
    ops = [op for op, _ in plan.ops]
    assert "optimization_barrier" in _types(main)
    read = {n for op in ops for n in op.input_arg_names()}
    for op in ops:          # every barrier left in the plan is read
        if op.type == "optimization_barrier":
            assert op.output("Out")[0] in read
    n_dead = sum(op.type == "optimization_barrier" and
                 op.output("Out")[0] not in read
                 for op in main.global_block().ops)
    assert n_dead > 0
    cloned = {source_name(n) for op in ops for n in op.output_arg_names()
              if RECOMPUTE_SUFFIX in n}
    n_paired = 0
    for i, op in enumerate(ops):
        if not registry.is_generic_grad(op):
            continue
        j = plan.fwd_of[i]
        assert j is not None and j < i, op
        fwd_outs = [n for n in ops[j].output_arg_names() if n]
        if any(source_name(n) in cloned for n in fwd_outs):
            # a cloned forward: the grad op takes the clone's graph
            assert all(RECOMPUTE_SUFFIX in n for n in fwd_outs), (op, ops[j])
            n_paired += 1
    assert n_paired > 20
    for j in plan.wanted:
        outs = [n for n in ops[j].output_arg_names() if n]
        assert not any(n in cloned for n in outs), ops[j]
    # each clone runs after the seed, in its segment's chain
    seed = next(i for i, op in enumerate(ops) if op.type == "fill_constant"
                and op.output("Out")[0].endswith("@GRAD"))
    assert all(i > seed for i, op in enumerate(ops)
               if any(RECOMPUTE_SUFFIX in n for n in op.output_arg_names()))
    assert not any(BARRIER_SUFFIX in n for n in ops[seed].input_arg_names())


# -- a 2-layer AMP BERT under LAMB, fused ----------------------------------------

def _bert_feed(step):
    rng = np.random.RandomState(step)
    ids = rng.randint(1, BERT["vocab_size"], (BATCH, SEQ)).astype(np.int64)
    labels = np.where(rng.rand(BATCH, SEQ) < 0.3, ids, 0).astype(np.int64)
    return {"src_ids": ids, "lm_label": labels}


def _forced_fusion(monkeypatch):
    monkeypatch.setattr(ref_fusion, "_autotune", lambda *a, **k: dict(WIN))
    monkeypatch.setattr(fusion, "_autotune", lambda *a, **k: dict(WIN))
    for f in (flags.set_flags, pt.set_flags):
        f({"FLAGS_graph_fusion": True, "FLAGS_fusion_autotune": True,
           "FLAGS_fusion_rank_threshold": 0.0})


def _fused_plan(exe):
    plan, = [p for p in exe._plans.values()
             if any(op.type == "lamb" for op, _ in p.ops)]
    return plan


def test_amp_bert_under_recompute_and_lamb_matches_reference(monkeypatch):
    _forced_fusion(monkeypatch)
    try:
        progs = _both_recomputed("bert2")
        plain = _both_recomputed("bert2", recompute=False)["port"]
        (rm, rs, rl), (pm, _, pl) = progs["ref"], progs["port"]
        ref_scope = RefScope()
        RefExecutor().run(rs, scope=ref_scope, seed=7)
        init = {v.name: np.asarray(ref_scope.find_var(v.name))
                for v in rs.global_block().vars.values()}
        patch_same_bits(monkeypatch)
        ref_exe = RefExecutor()
        runs = {}
        for name, (main, loss) in (("recompute", (pm, pl)),
                                   ("plain", (plain[0], plain[2]))):
            sc = ptt.io.params_from_numpy(scope.Scope(), init)
            exe = ptt.Executor(ptt.CPUPlace())
            runs[name] = [float(exe.run(main, feed=_bert_feed(s),
                                        fetch_list=[loss], scope=sc,
                                        seed=100 + s)[0])
                          for s in range(STEPS)]
            types = [op.type for op, _ in _fused_plan(exe).ops]
            n_fused = types.count("fused_dense_act")
            # the recomputed layer's original chain and its clone both fuse
            assert n_fused == (2 * BERT["n_layer"] - 1 if name == "recompute"
                               else BERT["n_layer"]), types
            assert types.count("fused_dense_act_grad") == BERT["n_layer"]
            assert types.count("fused_embedding_layer_norm") == 1
        assert runs["recompute"] == runs["plain"]
        for step in range(STEPS):
            with jax.disable_jit():
                want, = ref_exe.run(rm, feed=_bert_feed(step),
                                    fetch_list=[rl], scope=ref_scope,
                                    seed=100 + step)
            np.testing.assert_allclose(runs["recompute"][step],
                                       float(np.asarray(want)),
                                       rtol=AMP_LOSS_RTOL)
        assert runs["recompute"][-1] < runs["recompute"][0]
    finally:
        pt.set_flags(DEFAULTS)


# -- a stored input every segment reads ----------------------------------------

def _masked_encoder(pkg, recompute):
    """A 3-layer float32 encoder reading a fed ``attn_bias`` in every layer
    (BERT with a padding mask) under Adam, in ``pkg``; with ``recompute``
    through RecomputeOptimizer over the layer outputs.  The bias is a
    stored value every segment's chain reads through one barrier."""
    if pkg == "ref":
        main, startup = RefProgram(), RefProgram()
        guard, names, L, O, M = (ref_guard(main, startup), ref_names.guard(),
                                 ref_layers, ref_opt, RT)
    else:
        main, startup = core.Program(), core.Program()
        guard, names, L, O, M = (core.program_guard(main, startup),
                                 unique_name.guard(), layers, opt, T)
    with guard, names:
        ids = L.data("src_ids", shape=[SEQ], dtype="int64")
        bias = L.data("attn_bias", shape=[BERT["n_head"], SEQ, SEQ],
                      dtype="float32")
        ckpts = [] if recompute else None
        x = M.encoder(ids, None, BERT["vocab_size"], BERT["max_pos"], 3,
                      BERT["d_model"], BERT["d_inner"], BERT["n_head"],
                      attn_bias=bias, checkpoints=ckpts, arange_pos=True)
        loss = L.mean(x * x)
        o = O.Adam(LR)
        if recompute:
            o = O.RecomputeOptimizer(o)
            o._set_checkpoints(ckpts)
        o.minimize(loss)
    return main, startup, loss.name


def _masked_feed(step):
    feed = _bert_feed(step)
    keep = np.random.RandomState(50 + step).rand(BATCH, SEQ) < 0.8
    bias = np.where(keep, 0.0, -1e4).astype(np.float32)
    feed = {"src_ids": feed["src_ids"], "attn_bias": np.ascontiguousarray(
        np.broadcast_to(bias[:, None, None, :],
                        (BATCH, BERT["n_head"], SEQ, SEQ)))}
    return feed


def test_recompute_with_an_input_every_segment_reads():
    rm, rs, rl = _masked_encoder("ref", recompute=True)
    ref_scope = RefScope()
    RefExecutor().run(rs, scope=ref_scope, seed=5)
    init = {v.name: np.asarray(ref_scope.find_var(v.name))
            for v in rs.global_block().vars.values()}
    want = [float(np.asarray(RefExecutor().run(
        rm, feed=_masked_feed(s), fetch_list=[rl], scope=ref_scope)[0]))
        for s in range(STEPS)]
    runs = {}
    for recompute in (False, True):
        main, _, loss = _masked_encoder("port", recompute)
        if recompute:
            barriers = [op for op in main.global_block().ops
                        if op.type == "optimization_barrier"
                        and op.input("X") == ["attn_bias"]]
            assert len(barriers) == 1
            readers = [op for op in main.global_block().ops
                       if "attn_bias" + BARRIER_SUFFIX in op.input_arg_names()]
            assert len(readers) == 2        # one clone in each segment
        sc = ptt.io.params_from_numpy(scope.Scope(), init)
        exe = ptt.Executor(ptt.CPUPlace())
        runs[recompute] = [float(exe.run(main, feed=_masked_feed(s),
                                         fetch_list=[loss], scope=sc)[0])
                           for s in range(STEPS)]
    assert runs[True] == runs[False]
    np.testing.assert_allclose(runs[True], want, rtol=1e-5)
