"""The whole graph-fusion pass, the verifier and the CompiledProgram passes:
the port against the JAX package, on the CPU.

- the fused ops: ``fused_dense_act`` (mul and matmul forms, each
  activation, with and without ``use_pallas``, M = 513 where neither
  package's kernel takes the shape) and ``fused_embedding_layer_norm``
  (0-2 addends, ``padding_idx``, with and without ``use_pallas``, a
  ``begin_norm_axis`` short of the last dim) against the reference's
  lowerings, forward and generic gradient, within 1e-5 (the reference runs
  op by op, ``jax.disable_jit``, so it rounds bf16 products as written);
- the pass: a BERT-shaped toy (embedding + position embedding, LayerNorm,
  fc(gelu), fc; no dropout) and a tiny GPT serialize byte for byte like
  the reference's after ``fuse_program``, with the same verdicts, ranks and
  autotune records, autotune verdicts patched to the same value in both
  packages (each package times its own device, so real verdicts differ);
  the tiny GPT's serving program after ``CompiledProgram._optimized`` too;
- the legality near-misses (fetched intermediate, multi-consumer
  intermediate, missing grad rewrite), the rank threshold, the collective
  fingerprint through the rewrite, the frozen addend's '' placeholder, the
  autotune cache's hit/miss counters and its file, a flag flip re-planning;
- the verifier's checks against the reference's diagnostics on the same
  programs, and the CompiledProgram passes (dead ops, add + activation);
- 3 Adam steps of the tiny GPT fused with the kernels' paths
  (``use_pallas`` everywhere, rank threshold 0) in both packages from the
  same numpy weights: losses within 1e-6 relative, state as in
  ``test_torch_train.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import layers as ref_layers
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.analysis import fusion as ref_fusion
from paddle_tpu.analysis import verifier as ref_verifier
from paddle_tpu.compiler import CompiledProgram as RefCompiled
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import registry as ref_registry
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.framework.executor import LowerCtx as RefCtx
from paddle_tpu.models import transformer as RT
from paddle_tpu_torch import flags, layers, monitor
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.analysis import fusion, verifier
from paddle_tpu_torch.compiler import CompiledProgram
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.framework.executor import LowerCtx
from paddle_tpu_torch.models import transformer as T

TOL = dict(rtol=1e-5, atol=1e-5)
DEFAULTS = {"FLAGS_graph_fusion": True, "FLAGS_fusion_autotune": False,
            "FLAGS_fusion_rank_threshold": 0.02,
            "FLAGS_xla_compile_cache_dir": ""}
GPT = dict(vocab_size=64, d_model=32, n_layer=2, n_head=4, d_inner=64,
           max_pos=16, dropout=0.0)
SEQ, BATCH, LR, STEPS = 16, 2, 1e-3, 3
WIN = {"base_ms": 1.0, "fused_ms": 0.5, "win": True, "cached": False}


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh port default programs, scope and names; both packages' fusion
    flags at their defaults and their fusion caches empty."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    for set_flags in (pt.set_flags, flags.set_flags):
        set_flags(DEFAULTS)
    fusion.clear_cache()
    ref_fusion.clear_cache()
    with unique_name.guard():
        yield
    for set_flags in (pt.set_flags, flags.set_flags):
        set_flags(DEFAULTS)
    fusion.clear_cache()
    ref_fusion.clear_cache()
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


def _set_flags(values):
    for set_flags in (pt.set_flags, flags.set_flags):
        set_flags(values)


def _patch_verdicts(monkeypatch, rec=WIN):
    monkeypatch.setattr(ref_fusion, "_autotune", lambda *a, **k: dict(rec))
    monkeypatch.setattr(fusion, "_autotune", lambda *a, **k: dict(rec))


def _f(*shape, seed=0, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _serialized(prog):
    d = json.loads(prog.serialize_to_string())
    d.pop("framework_version")
    return d


def _decisions(prog):
    return prog._attrs["fusion"]["candidates"]


def _types(prog):
    return [op.type for op in prog.global_block().ops]


def _both(build):
    """``build(L, O)`` in each package on fresh programs and names:
    ``{"ref"|"port": (main, startup, fetch names)}``."""
    out = {}
    for pkg, L, O in (("ref", ref_layers, ref_opt), ("port", layers, opt)):
        if pkg == "ref":
            main, startup = RefProgram(), RefProgram()
            guard, names = ref_guard(main, startup), ref_names.guard()
        else:
            main, startup = core.Program(), core.Program()
            guard, names = core.program_guard(main, startup), \
                unique_name.guard()
        with guard, names:
            fetches = build(L, O)
        out[pkg] = (main, startup, [v.name for v in fetches])
    assert _serialized(out["ref"][0]) == _serialized(out["port"][0])
    return out


# -- the fused ops ---------------------------------------------------------------

def _to_jax(ins):
    return {s: [None if a is None else jnp.asarray(a) for a in v]
            for s, v in ins.items()}


def _to_torch(ins):
    return {s: [None if a is None else torch.from_numpy(np.array(a))
                for a in v] for s, v in ins.items()}


def _dense_attrs(**kw):
    a = {"x_num_col_dims": 2, "bias_axis": -1, "act": "gelu",
         "approximate": False, "dropout_prob": 0.0, "seed": 0,
         "is_test": False, "dropout_implementation": "downgrade_in_infer",
         "use_pallas": False}
    a.update(kw)
    return a


def _ids(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int64)


FUSED_CASES = {
    "dense_mul_gelu": ("fused_dense_act", {"X": [_f(3, 8, 12)], "W": [_f(12, 20, seed=1, scale=0.3)], "Bias": [_f(20, seed=2)]}, _dense_attrs(), ["Out"]),
    "dense_mul_gelu_k5": ("fused_dense_act", {"X": [_f(3, 8, 12)], "W": [_f(12, 20, seed=1, scale=0.3)], "Bias": [_f(20, seed=2)]}, _dense_attrs(use_pallas=True), ["Out"]),
    "dense_mul_gelu_tanh_k5": ("fused_dense_act", {"X": [_f(4, 6, 16)], "W": [_f(16, 8, seed=1, scale=0.3)], "Bias": [_f(8, seed=2)]}, _dense_attrs(approximate=True, use_pallas=True), ["Out"]),
    "dense_mul_relu_k5": ("fused_dense_act", {"X": [_f(5, 24)], "W": [_f(24, 16, seed=1, scale=0.3)], "Bias": [_f(16, seed=2)]}, _dense_attrs(x_num_col_dims=1, act="relu", bias_axis=1, use_pallas=True), ["Out"]),
    "dense_matmul_relu_k5": ("fused_dense_act", {"X": [_f(2, 4, 10)], "W": [_f(10, 6, seed=1, scale=0.3)], "Bias": [_f(6, seed=2)]}, _dense_attrs(x_num_col_dims=-1, act="relu", use_pallas=True), ["Out"]),
    "dense_m513_k5": ("fused_dense_act", {"X": [_f(513, 12)], "W": [_f(12, 8, seed=1, scale=0.3)], "Bias": [_f(8, seed=2)]}, _dense_attrs(x_num_col_dims=1, use_pallas=True), ["Out"]),
    "emb_ln_two_addends": ("fused_embedding_layer_norm", {"Ids": [_ids((3, 6, 1), 30, 0)], "W": [_f(30, 16)], "Addends": [_f(3, 6, 16, seed=1), _f(16, seed=2)], "Scale": [_f(16, seed=3) + 1], "Bias": [_f(16, seed=4)]}, {"padding_idx": -1, "epsilon": 1e-5, "begin_norm_axis": 2, "use_pallas": False}, ["Out"]),
    "emb_ln_two_addends_k4": ("fused_embedding_layer_norm", {"Ids": [_ids((3, 6, 1), 30, 0)], "W": [_f(30, 16)], "Addends": [_f(3, 6, 16, seed=1), _f(16, seed=2)], "Scale": [_f(16, seed=3) + 1], "Bias": [_f(16, seed=4)]}, {"padding_idx": -1, "epsilon": 1e-5, "begin_norm_axis": 2, "use_pallas": True}, ["Out"]),
    "emb_ln_padding_k4": ("fused_embedding_layer_norm", {"Ids": [_ids((4, 5), 12, 1)], "W": [_f(12, 8)], "Addends": [], "Scale": [_f(8, seed=3) + 1], "Bias": [_f(8, seed=4)]}, {"padding_idx": 3, "epsilon": 1e-5, "begin_norm_axis": 2, "use_pallas": True}, ["Out"]),
    "emb_ln_not_last_dim_k4": ("fused_embedding_layer_norm", {"Ids": [_ids((2, 4, 1), 10, 2)], "W": [_f(10, 6)], "Addends": [_f(2, 4, 6, seed=5)], "Scale": [_f(24, seed=3) + 1], "Bias": [_f(24, seed=4)]}, {"padding_idx": -1, "epsilon": 1e-5, "begin_norm_axis": 1, "use_pallas": True}, ["Out"]),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_op_matches_reference(case):
    op_type, ins, attrs, og_slots = FUSED_CASES[case]
    with jax.disable_jit():
        ref = ref_registry.get_op_info(op_type).lower(RefCtx(0),
                                                      _to_jax(ins), attrs)
    got = registry.get_op_info(op_type).lower(
        LowerCtx(torch.device("cpu"), 0), _to_torch(ins), attrs)
    assert sorted(got) == sorted(ref)
    for slot in ref:
        g, r = got[slot][0].numpy(), np.asarray(ref[slot][0])
        assert g.shape == r.shape and g.dtype == r.dtype, slot
        np.testing.assert_allclose(g, r, err_msg=slot, **TOL)
    # the generic gradient through every floating input
    gins = {"X$" + s: v for s, v in ins.items()}
    for k, slot in enumerate(og_slots):
        gins["OG$" + slot] = [_f(*got[slot][0].shape, seed=10 + k)]
    gattrs = dict(attrs, __fwd_type__=op_type)
    with jax.disable_jit():
        rg = ref_registry.generic_grad_lower(RefCtx(0), _to_jax(gins),
                                             gattrs)
    pg = registry.generic_grad_lower(LowerCtx(torch.device("cpu"), 0),
                                     _to_torch(gins), gattrs)
    for s, vals in ins.items():
        for j, a in enumerate(vals):
            if not np.issubdtype(a.dtype, np.floating):
                continue
            np.testing.assert_allclose(
                pg["IG$" + s][j].numpy(), np.asarray(rg["IG$" + s][j]),
                err_msg=f"IG${s}[{j}]", **TOL)


def test_untaken_kernel_paths_raise_not_fall_back():
    """The tagged-dropout stage and AMP are not ported: they raise."""
    _, ins, attrs, _ = FUSED_CASES["dense_mul_gelu"]
    info = registry.get_op_info("fused_dense_act")
    ctx = LowerCtx(torch.device("cpu"), 0)
    with pytest.raises(NotImplementedError, match="tagged-dropout"):
        info.lower(ctx, _to_torch(ins), dict(attrs, seed=7,
                                             dropout_prob=0.1))
    out = info.lower(ctx, _to_torch(ins), dict(
        attrs, seed=7, dropout_prob=0.25, is_test=True))["Out"][0]
    plain = info.lower(ctx, _to_torch(ins), attrs)["Out"][0]
    np.testing.assert_allclose(out.numpy(), 0.75 * plain.numpy(), rtol=1e-6)
    ctx.amp = True
    with pytest.raises(NotImplementedError, match="AMP"):
        info.lower(ctx, _to_torch(ins), attrs)


# -- the pass on the BERT-shaped toy and the tiny GPT ------------------------------

def _bert_toy(L, O):
    """emb + pos-emb -> layer_norm -> fc(gelu) -> fc -> mean square, SGD
    (``tests/test_fusion.py``'s toy without its dropout)."""
    src = L.data("src", shape=[6], dtype="int64")
    pos = L.data("pos", shape=[6], dtype="int64")
    x = L.embedding(src, size=[30, 8]) + L.embedding(pos, size=[6, 8])
    x = L.layer_norm(x, begin_norm_axis=2)
    h = L.fc(x, size=16, num_flatten_dims=2, act="gelu")
    out = L.fc(h, size=8, num_flatten_dims=2)
    loss = L.mean(out * out)
    O.SGDOptimizer(learning_rate=0.05).minimize(loss)
    return [loss]


def _bert_feed():
    rng = np.random.RandomState(1)
    return {"src": rng.randint(0, 30, (3, 6)).astype(np.int64),
            "pos": np.tile(np.arange(6, dtype=np.int64), (3, 1))}


def _gpt(L, O):
    Tm = RT if L is ref_layers else T
    _, _, loss = Tm.build_gpt_pretrain(Tm.BertConfig(**GPT), SEQ,
                                       attn_impl="flash", fused_head=True,
                                       dropout=0.0)
    O.AdamOptimizer(LR).minimize(loss)
    return [loss]


def _fuse_both(progs, feed_shapes=None):
    (rm, _, rf), (pm, _, pf) = progs["ref"], progs["port"]
    fused_ref = ref_fusion.fuse_program(rm, rf, feed_shapes=feed_shapes)
    fused = fusion.fuse_program(pm, pf, feed_shapes=feed_shapes)
    assert _serialized(fused) == _serialized(fused_ref)
    assert _decisions(fused) == _decisions(fused_ref)
    return fused, fused_ref


@pytest.mark.parametrize("autotune", [False, True], ids=["rank", "autotune"])
def test_bert_toy_fuses_like_the_reference(monkeypatch, autotune):
    if autotune:
        _patch_verdicts(monkeypatch)
        _set_flags({"FLAGS_fusion_autotune": True})
    fused, _ = _fuse_both(_both(_bert_toy))
    types = _types(fused)
    by = {d["pattern"]: d["verdict"] for d in _decisions(fused)}
    assert by == {"embedding_layer_norm": "applied",
                  "dense_epilogue": "applied"}
    assert "layer_norm" not in types and "gelu" not in types
    # the position lookup (the external addend's producer) survives
    assert types.count("lookup_table") == types.count(
        "lookup_table_grad") == 1
    for t in ("fused_embedding_layer_norm", "fused_dense_act"):
        op, = [op for op in fused.global_block().ops if op.type == t]
        gop, = [op for op in fused.global_block().ops if op.type == t +
                "_grad"]
        assert op.attrs["use_pallas"] is autotune is gop.attrs["use_pallas"]
    if autotune:
        assert all(d["autotune"] == WIN for d in _decisions(fused))


@pytest.mark.parametrize("threshold,autotune", [
    (0.02, False), (0.0, True)], ids=["defaults", "autotuned_threshold_0"])
def test_tiny_gpt_fuses_like_the_reference(monkeypatch, threshold, autotune):
    _patch_verdicts(monkeypatch)
    _set_flags({"FLAGS_fusion_rank_threshold": threshold,
                "FLAGS_fusion_autotune": autotune})
    fused, _ = _fuse_both(_both(_gpt), {"src_ids": (BATCH, SEQ),
                                        "lm_label": (BATCH, SEQ)})
    types = _types(fused)
    assert types.count("fused_dense_act") == GPT["n_layer"]
    assert types.count("fused_dense_act_grad") == GPT["n_layer"]
    n_emb = 1 if threshold == 0.0 else 0
    assert types.count("fused_embedding_layer_norm") == n_emb
    assert types.count("layer_norm") == 2 * GPT["n_layer"] + 1 - n_emb
    emb, = [d for d in _decisions(fused)
            if d["pattern"] == "embedding_layer_norm"]
    assert emb["verdict"] == ("applied" if n_emb else "ranked_out")


def test_tiny_gpt_serving_program_optimizes_like_the_reference():
    def serving(L, O):
        Tm = RT if L is ref_layers else T
        _, logits = Tm.build_gpt_serving(Tm.BertConfig(**GPT), SEQ,
                                         attn_impl="auto")
        return [logits]
    progs = _both(serving)
    shapes = {"src_ids": (BATCH, SEQ)}
    got = CompiledProgram(progs["port"][0])._optimized(
        progs["port"][2], feed_shapes=shapes)
    want = RefCompiled(progs["ref"][0])._optimized(progs["ref"][2],
                                                   feed_shapes=shapes)
    assert _serialized(got) == _serialized(want)
    types = _types(got)
    assert types.count("fused_dense_act") == GPT["n_layer"]
    assert "fused_elemwise_activation" not in types
    assert not any(op.attrs.get("use_pallas")
                   for op in got.global_block().ops)


# -- legality, rank, fingerprint, frozen addend ----------------------------------

def _conv_toy(L, O, side_consumer=False, train=True, fetch_conv=False):
    """conv2d(1x1) + bn + relu -> pool -> fc(softmax) -> ce loss [+ SGD]
    (``tests/test_fusion.py``'s conv toy)."""
    img = L.data("image", shape=[3, 6, 6], dtype="float32")
    label = L.data("label", shape=[1], dtype="int64")
    conv = L.conv2d(img, num_filters=8, filter_size=1, padding=0,
                    bias_attr=False)
    pool = L.pool2d(L.batch_norm(conv, act="relu"), global_pooling=True,
                    pool_type="avg")
    if side_consumer:
        pool = pool + L.pool2d(L.relu(conv), global_pooling=True,
                               pool_type="avg")
    pred = L.fc(pool, size=10, act="softmax")
    loss = L.mean(L.cross_entropy(pred, label))
    if train:
        O.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return [conv, loss] if fetch_conv else [loss]


def _drop_relu_grad(prog):
    blk = prog.global_block()
    blk.ops = [op for op in blk.ops if op.type != "relu_grad"]
    prog._bump_version()


@pytest.mark.parametrize("case,rule", [
    ("fetched", "fetched_internal"), ("side", "multi_consumer"),
    ("no_relu_grad", "missing_grad_rewrite")])
def test_legality_near_misses_match_reference(case, rule):
    progs = _both(lambda L, O: _conv_toy(
        L, O, side_consumer=case == "side", train=case == "no_relu_grad",
        fetch_conv=case == "fetched"))
    if case == "no_relu_grad":
        for m, _, _ in progs.values():
            _drop_relu_grad(m)
    (rm, _, rf), (pm, _, pf) = progs["ref"], progs["port"]
    got = fusion.analyze_program(pm, pf)
    want = ref_fusion.analyze_program(rm, rf)
    assert [d.as_dict() for d in got.decisions] == \
        [d.as_dict() for d in want.decisions]
    conv = [d for d in got.decisions if d.pattern == "conv_bn_relu"]
    assert [(d.verdict, d.rule) for d in conv] == [("rejected", rule)]
    assert fusion.fuse_program(pm, pf) is pm


def test_rank_threshold_gates_rewrites():
    _set_flags({"FLAGS_fusion_rank_threshold": 1.1})    # nothing passes
    progs = _both(_conv_toy)
    pm, _, pf = progs["port"]
    assert fusion.fuse_program(pm, pf) is pm
    verdicts = {d["verdict"] for d in _decisions(pm)}
    assert verdicts == {"ranked_out", "rejected"} or verdicts == {
        "ranked_out"}
    ref_fusion.fuse_program(progs["ref"][0], progs["ref"][2])
    assert _decisions(pm) == _decisions(progs["ref"][0])


def test_collective_fingerprint_unchanged_by_fusion():
    progs = _both(_conv_toy)
    for pkg, ver, fus in (("ref", ref_verifier, ref_fusion),
                          ("port", verifier, fusion)):
        prog, _, (loss,) = progs[pkg]
        blk = prog.global_block()
        blk.create_var(name="allr_out", shape=blk.var(loss).shape,
                       dtype="float32")
        blk.append_op("c_allreduce_sum", inputs={"X": [loss]},
                      outputs={"Out": ["allr_out"]}, attrs={"ring_id": 0})
        prog._bump_version()
        pre = ver.verify_program(prog, (loss,))
        fused = fus.fuse_program(prog, (loss,))
        assert fused is not prog
        post = ver.verify_program(fused, (loss,))
        assert pre.collective_fingerprint is not None
        assert post.collective_fingerprint == pre.collective_fingerprint
        assert fused._attrs["fusion"]["collective_fingerprint_ok"]


def test_frozen_addend_keeps_grad_alignment():
    """A fed (gradient-free) addend keeps its '' placeholder in the fused
    grad op's IG$Addends name list, and the fused program trains exactly
    like the unfused one."""
    def build(L, O):
        src = L.data("src", shape=[6], dtype="int64")
        posv = L.data("posv", shape=[6, 8], dtype="float32")
        x = L.layer_norm(L.embedding(src, size=[30, 8]) + posv,
                         begin_norm_axis=2)
        loss = L.mean(x * x)
        O.SGDOptimizer(learning_rate=0.05).minimize(loss)
        return [loss]
    prog, startup, (loss,) = _both(build)["port"]
    fused = fusion.fuse_program(prog, ())
    gop, = [op for op in fused.global_block().ops
            if op.type == "fused_embedding_layer_norm_grad"]
    assert gop.outputs.get("IG$Addends") == [""]
    rng = np.random.RandomState(3)
    feed = {"src": rng.randint(0, 30, (2, 6)).astype(np.int64),
            "posv": rng.rand(2, 6, 8).astype(np.float32)}
    exe = ptt.Executor(ptt.CPUPlace())
    init = scope.Scope()
    exe.run(startup, scope=init, seed=7)
    out = {}
    for fuse_on in (False, True):
        flags.set_flags({"FLAGS_graph_fusion": fuse_on})
        sc = scope.Scope()
        for n, v in init.items():
            sc.set_var(n, v.clone())
        out[fuse_on] = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                                      scope=sc)[0]) for _ in range(3)]
    assert out[False] == out[True]


# -- autotune, counters, re-planning ---------------------------------------------

def _counter(mod, name, **labels):
    fam = mod.REGISTRY.get(name)
    if fam is None:
        return 0
    return sum(cell.get() for lbl, cell in fam.series()
               if all(lbl.get(k) == v for k, v in labels.items()))


def test_autotune_cache_hit_miss_counters_and_persistence(tmp_path):
    """The real autotuner on the host: a miss times the chain and the
    fused op and writes ``fusion_autotune.json`` under
    ``FLAGS_xla_compile_cache_dir``, keyed on the host (``cpux1``); a fresh
    process (cleared caches) hits the file instead of timing again."""
    _set_flags({"FLAGS_fusion_autotune": True,
                "FLAGS_xla_compile_cache_dir": str(tmp_path)})
    prog, _, fetches = _both(_bert_toy)["port"]
    name = "paddle_tpu_fusion_autotune_total"
    miss0 = _counter(monitor, name, cache="miss")
    fused = fusion.fuse_program(prog, fetches, feed_shapes={"src": (3, 6)})
    miss1 = _counter(monitor, name, cache="miss")
    assert miss1 == miss0 + 2            # the dense and the embedding chain
    records = json.loads((tmp_path / "fusion_autotune.json").read_text())
    assert len(records) == 2
    for key, rec in records.items():
        assert json.loads(key)[3] == "cpux1" and set(rec) == {
            "base_ms", "fused_ms", "win"}
    tuned = [d for d in _decisions(fused) if "autotune" in d]
    assert len(tuned) == 2 and not any(d["autotune"]["cached"]
                                       for d in tuned)
    # a warm run and 3 timed runs of the fused op on the host
    assert [d["autotune"]["fused_runs"] for d in tuned] == [4, 4]
    fusion.clear_cache()
    hit0 = _counter(monitor, name, cache="hit")
    again = fusion.fuse_program(prog, fetches, feed_shapes={"src": (3, 6)})
    assert _counter(monitor, name, cache="hit") == hit0 + 2
    assert _counter(monitor, name, cache="miss") == miss1
    assert [d["verdict"] for d in _decisions(again)] == \
        [d["verdict"] for d in _decisions(fused)]
    assert all(d["autotune"]["cached"] for d in _decisions(again)
               if "autotune" in d)


def test_decisions_are_counted_once_per_program_and_config():
    progs = _both(_bert_toy)
    prog, _, fetches = progs["port"]
    name = "paddle_tpu_fusion_candidates_total"
    before = _counter(monitor, name, verdict="applied")
    for _ in range(2):
        fusion.fuse_program(prog, fetches)
    assert _counter(monitor, name, verdict="applied") == before + 2
    fusion.analyze_program(prog, fetches)          # reports, counts nothing
    assert _counter(monitor, name, verdict="applied") == before + 2


def test_flag_flip_invalidates_executor_plan():
    prog, startup, (loss,) = _both(_bert_toy)["port"]
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc, seed=7)
    for _ in range(2):
        exe.run(prog, feed=_bert_feed(), fetch_list=[loss], scope=sc)
    s = exe.dispatch_stats()
    assert s["traces"] == 2 and s["cache_hits"] == 1     # startup + main
    flags.set_flags({"FLAGS_graph_fusion": False})
    exe.run(prog, feed=_bert_feed(), fetch_list=[loss], scope=sc)
    assert exe.dispatch_stats()["traces"] == 3
    flags.set_flags({"FLAGS_graph_fusion": True,
                     "FLAGS_fusion_rank_threshold": 0.5})
    exe.run(prog, feed=_bert_feed(), fetch_list=[loss], scope=sc)
    assert exe.dispatch_stats()["traces"] == 4


# -- the verifier and the CompiledProgram passes -----------------------------------

def _diag_keys(result):
    return sorted((d.check, d.severity, d.op_type, d.var)
                  for d in result.diagnostics)


def _dead_and_dangling(L, O):
    x = L.data("x", shape=[4], dtype="float32")
    L.data("unused", shape=[4], dtype="float32")
    h = L.fc(x, size=3)
    L.relu(h)                              # dead: nothing reads it
    return [L.mean(h)]


def _undeclared_input(prog):
    blk = prog.global_block()
    blk.ops[-1].inputs["X"] = ["no_such_var"]
    prog._bump_version()


@pytest.mark.parametrize("case", ["dead_and_dangling", "undeclared",
                                  "dangling_fetch", "use_after_donate",
                                  "int64_feed", "collective_order"])
def test_verifier_checks_match_reference(case):
    build = {"dead_and_dangling": _dead_and_dangling}.get(case, _gpt
                                                          if case ==
                                                          "int64_feed"
                                                          else _conv_toy)
    progs = _both(build)
    results = {}
    for pkg, ver in (("ref", ref_verifier), ("port", verifier)):
        prog, _, fetches = progs[pkg]
        if case == "undeclared":
            _undeclared_input(prog)
        elif case == "dangling_fetch":
            fetches = fetches + ["not_a_var"]
        elif case == "use_after_donate":
            fetches = fetches + [prog.all_parameters()[0].name]
        elif case == "collective_order":
            blk = prog.global_block()
            for out in ("a", "b"):          # two unordered identical ones
                blk.create_var(name=out, shape=blk.var(fetches[0]).shape,
                               dtype="float32")
                blk.append_op("c_allreduce_sum", inputs={"X": fetches},
                              outputs={"Out": [out]}, attrs={"ring_id": 0})
            prog._bump_version()
        results[pkg] = ver.verify_program(prog, fetches)
        checked_fetches = fetches
        stamp = prog._attrs["verify"]
        assert stamp["collective_fingerprint"] == \
            results[pkg].collective_fingerprint
    got, want = results["port"], results["ref"]
    assert _diag_keys(got) == _diag_keys(want)
    assert [d.message for d in sorted(got.diagnostics, key=str)] == \
        [d.message for d in sorted(want.diagnostics, key=str)]
    assert (got.int64_static, got.int64_dynamic) == \
        (want.int64_static, want.int64_dynamic)
    # the reference folds its comms plan (not ported) into the fingerprint,
    # so only its presence is compared across the packages
    assert (got.collective_fingerprint is None) == \
        (want.collective_fingerprint is None)
    assert got.dead_ops == want.dead_ops
    assert got.ok == want.ok
    checks = {d.check for d in got.diagnostics}
    expect = {"dead_and_dangling": {"dead_op", "dangling_feed"},
              "undeclared": {"def_before_use"},
              "dangling_fetch": {"dangling_fetch"},
              "use_after_donate": {"use_after_donate"},
              "int64_feed": set(),
              "collective_order": {"collective_order"}}[case]
    assert expect <= checks
    if case == "int64_feed":
        assert got.int64_static == {"src_ids"}
    if not got.ok:
        with pytest.raises(verifier.ProgramVerificationError):
            CompiledProgram(progs["port"][0])._optimized(checked_fetches)


def test_verify_cache_and_counters():
    prog, _, fetches = _both(_conv_toy)["port"]
    runs = "paddle_tpu_verifier_runs_total"
    miss0, hit0 = (_counter(monitor, runs, cache=c) for c in ("miss", "hit"))
    first = verifier.verify_program(prog, fetches)
    assert verifier.verify_program(prog, fetches) is first
    assert _counter(monitor, runs, cache="miss") == miss0 + 1
    assert _counter(monitor, runs, cache="hit") == hit0 + 1
    assert first.cost_plan is not None and first.ok
    assert prog._attrs["verify"]["cost"]["flops"] == first.cost_plan.flops
    assert verifier.collective_fingerprint(prog) is None


def test_compiled_program_passes_match_reference():
    """dead_op_eliminate drops the dead relu; fuse_elewise_add_act_pass
    fuses an add of two fed values with its relu; the fc's mul + bias +
    relu became fused_dense_act first."""
    def build(L, O):
        x = L.data("x", shape=[4], dtype="float32")
        y = L.data("y", shape=[4], dtype="float32")
        h = L.fc(x, size=4, act="relu")
        L.relu(h)                           # dead
        return [L.mean(L.relu(h + y) * h)]
    progs = _both(build)
    shapes = {"x": (2, 4), "y": (2, 4)}
    got = CompiledProgram(progs["port"][0])._optimized(
        progs["port"][2], feed_shapes=shapes)
    want = RefCompiled(progs["ref"][0])._optimized(progs["ref"][2],
                                                   feed_shapes=shapes)
    assert _serialized(got) == _serialized(want)
    types = _types(got)
    assert types.count("fused_elemwise_activation") == 1
    assert types.count("fused_dense_act") == 1 and "relu" not in types
    rng = np.random.RandomState(0)
    feed = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    prog, startup, fetches = progs["port"]
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc, seed=3)
    compiled, = exe.run(CompiledProgram(prog), feed=feed,
                        fetch_list=fetches, scope=sc)
    flags.set_flags({"FLAGS_graph_fusion": False})
    plain, = exe.run(prog, feed=feed, fetch_list=fetches, scope=sc)
    np.testing.assert_allclose(compiled, plain, rtol=1e-6)


# -- 3 Adam steps through the kernels' paths ----------------------------------------

def test_three_fused_adam_steps_match_reference(monkeypatch):
    _patch_verdicts(monkeypatch)
    _set_flags({"FLAGS_fusion_autotune": True,
                "FLAGS_fusion_rank_threshold": 0.0})
    progs = _both(_gpt)
    (rm, rs, (rl,)), (pm, _, (pl,)) = progs["ref"], progs["port"]
    ref_scope = RefScope()
    RefExecutor().run(rs, scope=ref_scope, seed=7)
    init = {v.name: np.asarray(ref_scope.find_var(v.name))
            for v in rs.global_block().vars.values()}
    port_scope = ptt.io.params_from_numpy(scope.Scope(), init)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, GPT["vocab_size"], (BATCH, SEQ)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = 0
    feed = {"src_ids": ids, "lm_label": labels}
    exe, ref_exe = ptt.Executor(ptt.CPUPlace()), RefExecutor()
    losses = []
    for _ in range(STEPS):
        with jax.disable_jit():
            want, = ref_exe.run(rm, feed=feed, fetch_list=[rl],
                                scope=ref_scope)
        got, = exe.run(pm, feed=feed, fetch_list=[pl], scope=port_scope)
        np.testing.assert_allclose(float(got), float(np.asarray(want)),
                                   rtol=1e-6)
        losses.append(float(got))
    assert losses[-1] < losses[0]
    plan, = [p for p in exe._plans.values()
             if any(op.type == "adam" for op, _ in p.ops)]
    fused = [op for op, _ in plan.ops if op.type in (
        "fused_dense_act", "fused_embedding_layer_norm")]
    assert len(fused) == GPT["n_layer"] + 1
    assert all(op.attrs["use_pallas"] for op in fused)
    # state: test_torch_train.py's tolerances (the key third of each
    # qkv.b has a zero gradient, so Adam steps on rounding noise there)
    d = GPT["d_model"]
    for n in init:
        r = np.asarray(ref_scope.find_var(n))
        g = port_scope.find_var(n).numpy()
        if n.endswith("attn.qkv.b"):
            np.testing.assert_allclose(g[d:2 * d], r[d:2 * d], rtol=0,
                                       atol=STEPS * LR, err_msg=n)
            g, r = np.concatenate([g[:d], g[2 * d:]]), \
                np.concatenate([r[:d], r[2 * d:]])
        tol = dict(rtol=1e-4, atol=1e-6) if "_moment" not in n else \
            dict(rtol=1e-4, atol=2e-8)
        np.testing.assert_allclose(g, r, err_msg=n, **tol)
    assert _counter(ref_monitor, "paddle_tpu_fusion_candidates_total",
                    verdict="applied") >= GPT["n_layer"] + 1
