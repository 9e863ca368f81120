"""ResNet training through the graph-fusion pass: the port against the JAX
package, on the CPU.

- every op the ResNet programs add (conv2d, pool2d, batch_norm and its
  explicit grad, cross_entropy, mean, top_k, accuracy, fused_conv1x1_bn,
  gaussian_random) against the reference's lowering, forward and
  gradient, on the same numpy inputs: rtol 1e-5, atol 1e-5 in float32
  (integer outputs exact);
- the fusion pass: on a toy of two bottleneck blocks (strides 1 and 2) and
  on ResNet-50 at 3x32x32, both packages' training programs serialize
  identically before and after ``fuse_program``, with 6 + 6 (toy) and
  36 + 36 (depth 50) fused forward + grad ops and the same decisions;
  a 3x3 conv and an ``is_test`` BN are rejected with the reference's rules;
- 3 Momentum steps of the toy through ``Executor(CPUPlace())`` against
  ``paddle_tpu.Executor()`` from the reference's startup state: losses to
  1e-5 relative (measured 2.2e-7), parameters, velocities and BN running
  statistics to 1e-4 relative + 1e-6 absolute;
- the executor runs each fused op's forward once a step (its grad op
  takes the forward's graph), and a fusion-flag flip re-plans.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the reference lowerings)
import paddle_tpu_torch as ptt
from paddle_tpu import layers as ref_layers
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.analysis import fusion as ref_fusion
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import registry as ref_registry
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.framework.executor import LowerCtx as RefCtx
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu_torch import flags
from paddle_tpu_torch import layers
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.analysis import fusion
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.framework.executor import LowerCtx
from paddle_tpu_torch.models import resnet
from _port_fixtures import collect_garbage_after_module  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    """Fresh port default programs, scope and names for every test."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


def _f(*shape, seed=0, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _to_jax(ins):
    return {s: [None if a is None else jnp.asarray(a) for a in v]
            for s, v in ins.items()}


def _to_torch(ins):
    return {s: [None if a is None else torch.from_numpy(np.array(a))
                for a in v] for s, v in ins.items()}


def _ctx():
    return LowerCtx(torch.device("cpu"), 0)


def _bn_ins(c=4, x_shape=(3, 4, 5, 5)):
    return {"X": [_f(*x_shape) * 2 + 0.5], "Scale": [_f(c, seed=1)],
            "Bias": [_f(c, seed=2)], "Mean": [_f(c, seed=3, scale=0.1)],
            "Variance": [np.abs(_f(c, seed=4)) + 0.5]}


def _fused_ins(cin=6, cout=5, hw=6):
    return {"X": [_f(2, cin, hw, hw)], "Filter": [_f(cout, cin, 1, 1,
                                                    seed=1, scale=0.4)],
            "Scale": [_f(cout, seed=2)], "Bias": [_f(cout, seed=3)],
            "Mean": [_f(cout, seed=4, scale=0.1)],
            "Variance": [np.abs(_f(cout, seed=5)) + 0.5]}


_BN = {"momentum": 0.9, "epsilon": 1e-5, "data_layout": "NCHW"}
_FUSED = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
          "use_global_stats": False}
_POOL = {"global_pooling": False, "adaptive": False, "ceil_mode": False,
         "exclusive": True}
_LOGITS = np.random.RandomState(7).permutation(40).reshape(4, 10)
_PROBS = np.exp(_LOGITS / 9.0) / np.exp(_LOGITS / 9.0).sum(-1,
                                                            keepdims=True)
_PROBS = _PROBS.astype(np.float32)

# name -> (op type, {slot: [array]}, attrs)
FWD_CASES = {
    "conv2d_stride_pad": ("conv2d", {"Input": [_f(2, 3, 9, 9)], "Filter": [_f(4, 3, 3, 3, seed=1)]}, {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1], "groups": 1}),
    "conv2d_groups_dilation": ("conv2d", {"Input": [_f(2, 4, 9, 9)], "Filter": [_f(6, 2, 3, 3, seed=1)]}, {"strides": [1, 1], "paddings": [2, 2], "dilations": [2, 2], "groups": 2}),
    "conv2d_7x7_stem": ("conv2d", {"Input": [_f(1, 3, 16, 16)], "Filter": [_f(8, 3, 7, 7, seed=1)]}, {"strides": [2, 2], "paddings": [3, 3], "dilations": [1, 1], "groups": 1}),
    "pool_max_3x3_s2_p1": ("pool2d", {"X": [_f(2, 3, 9, 9)]}, dict(_POOL, pooling_type="max", ksize=[3, 3], strides=[2, 2], paddings=[1, 1])),
    "pool_global_avg": ("pool2d", {"X": [_f(2, 3, 5, 5)]}, dict(_POOL, pooling_type="avg", ksize=[1, 1], strides=[1, 1], paddings=[0, 0], global_pooling=True)),
    "pool_global_max": ("pool2d", {"X": [_f(2, 3, 5, 5)]}, dict(_POOL, pooling_type="max", ksize=[1, 1], strides=[1, 1], paddings=[0, 0], global_pooling=True)),
    "pool_avg_exclusive_pad": ("pool2d", {"X": [_f(2, 3, 7, 7)]}, dict(_POOL, pooling_type="avg", ksize=[3, 3], strides=[2, 2], paddings=[1, 1])),
    "pool_avg_inclusive_pad": ("pool2d", {"X": [_f(2, 3, 7, 7)]}, dict(_POOL, pooling_type="avg", ksize=[3, 3], strides=[2, 2], paddings=[1, 1], exclusive=False)),
    "pool_max_ceil": ("pool2d", {"X": [_f(2, 3, 8, 8)]}, dict(_POOL, pooling_type="max", ksize=[3, 3], strides=[2, 2], paddings=[0, 0], ceil_mode=True)),
    "pool_avg_ceil_exclusive": ("pool2d", {"X": [_f(2, 3, 8, 8)]}, dict(_POOL, pooling_type="avg", ksize=[3, 3], strides=[2, 2], paddings=[1, 1], ceil_mode=True)),
    "batch_norm_train": ("batch_norm", _bn_ins(), dict(_BN, is_test=False, use_global_stats=False)),
    "batch_norm_is_test": ("batch_norm", _bn_ins(), dict(_BN, is_test=True, use_global_stats=False)),
    "batch_norm_global_stats": ("batch_norm", _bn_ins(), dict(_BN, is_test=False, use_global_stats=True)),
    "batch_norm_2d": ("batch_norm", _bn_ins(x_shape=(6, 4)), dict(_BN, is_test=False, use_global_stats=False)),
    "cross_entropy": ("cross_entropy", {"X": [_PROBS], "Label": [np.array([[1], [0], [9], [4]], np.int64)]}, {"soft_label": False, "ignore_index": -100}),
    "cross_entropy_ignore": ("cross_entropy", {"X": [_PROBS], "Label": [np.array([[1], [0], [9], [0]], np.int64)]}, {"soft_label": False, "ignore_index": 0}),
    "cross_entropy_soft": ("cross_entropy", {"X": [_PROBS], "Label": [_PROBS[::-1].copy()]}, {"soft_label": True, "ignore_index": -100}),
    "mean": ("mean", {"X": [_f(3, 4, 5)]}, {}),
    "top_k": ("top_k", {"X": [_LOGITS.astype(np.float32)]}, {"k": 3}),
    "top_k_ties": ("top_k", {"X": [np.array([[1, 3, 3, 0, 3]], np.float32)]}, {"k": 2}),
    "accuracy": ("accuracy", {"Out": [_PROBS], "Indices": [np.argsort(-_LOGITS, axis=1)[:, :3].astype(np.int64)], "Label": [np.array([[_LOGITS[0].argmax()], [0], [np.argsort(-_LOGITS[2])[2]], [5]], np.int64)]}, {}),
    "fused_relu": ("fused_conv1x1_bn", _fused_ins(), dict(_FUSED, act="relu", stride=1)),
    "fused_no_act": ("fused_conv1x1_bn", _fused_ins(), dict(_FUSED, act="", stride=1)),
    "fused_stride2": ("fused_conv1x1_bn", _fused_ins(hw=7), dict(_FUSED, act="", stride=2)),
    "fused_stride2_relu": ("fused_conv1x1_bn", _fused_ins(hw=6), dict(_FUSED, act="relu", stride=2)),
    "fused_frozen": ("fused_conv1x1_bn", _fused_ins(), dict(_FUSED, act="relu", stride=1, use_global_stats=True)),
}


def _compare(got, ref):
    assert sorted(got) == sorted(ref)
    for slot in ref:
        assert len(got[slot]) == len(ref[slot]), slot
        for g, r in zip(got[slot], ref[slot]):
            g, r = g.numpy(), np.asarray(r)
            assert g.shape == r.shape, (slot, g.shape, r.shape)
            if np.issubdtype(r.dtype, np.integer):
                np.testing.assert_array_equal(g, r, err_msg=slot)
            else:
                assert g.dtype == r.dtype, (slot, g.dtype, r.dtype)
                np.testing.assert_allclose(g, r, err_msg=slot, **TOL)


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_lowering_matches_reference(case):
    op_type, ins, attrs = FWD_CASES[case]
    with jax.disable_jit():
        ref = ref_registry.get_op_info(op_type).lower(RefCtx(0),
                                                      _to_jax(ins), attrs)
    got = registry.get_op_info(op_type).lower(_ctx(), _to_torch(ins), attrs)
    _compare(got, ref)


# generic grads: forward inputs plus a seeded gradient for each output that
# a training program differentiates (a fused op's grad carries only Y's)
GRAD_CASES = {
    "conv2d_stride_pad": ["Output"],
    "conv2d_groups_dilation": ["Output"],
    "pool_max_3x3_s2_p1": ["Out"],
    "pool_global_avg": ["Out"],
    "pool_avg_exclusive_pad": ["Out"],
    "pool_avg_ceil_exclusive": ["Out"],
    "cross_entropy": ["Y"],
    "cross_entropy_soft": ["Y"],
    "mean": ["Out"],
    "fused_relu": ["Y"],
    "fused_no_act": ["Y"],
    "fused_stride2": ["Y"],
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_generic_gradient_matches_reference(case):
    op_type, ins, attrs = FWD_CASES[case]
    fwd = registry.get_op_info(op_type).lower(_ctx(), _to_torch(ins), attrs)
    gins = {"X$" + s: v for s, v in ins.items()}
    for k, slot in enumerate(GRAD_CASES[case]):
        gins["OG$" + slot] = [_f(*fwd[slot][0].shape, seed=10 + k)]
    gattrs = dict(attrs, __fwd_type__=op_type)
    with jax.disable_jit():
        ref = ref_registry.generic_grad_lower(RefCtx(0), _to_jax(gins),
                                              gattrs)
    got = registry.generic_grad_lower(_ctx(), _to_torch(gins), gattrs)
    float_slots = ["IG$" + s for s, v in ins.items()
                   if np.issubdtype(v[0].dtype, np.floating)]
    for slot in float_slots:
        g, r = got[slot][0], np.asarray(ref[slot][0])
        np.testing.assert_allclose(g.numpy(), r, err_msg=slot, **TOL)


@pytest.mark.parametrize("case", ["batch_norm_train",
                                  "batch_norm_global_stats",
                                  "batch_norm_is_test", "batch_norm_2d"])
def test_batch_norm_explicit_grad_matches_reference(case):
    """The grad maker's desc and the explicit grad op's lowering (two-pass
    variance in the recompute, as the reference)."""
    _, ins, attrs = FWD_CASES[case]
    blocks = []
    for core_mod in (core, paddle_tpu.framework.core):
        block = core_mod.Program().global_block()
        for s, v in ins.items():
            block.create_var(name=s.lower(), shape=v[0].shape,
                             dtype="float32")
        for n in ("y", "saved_m", "saved_v"):
            block.create_var(name=n, dtype="float32")
        blocks.append(block)
    descs = []
    for block, reg in zip(blocks, (registry, ref_registry)):
        op = core.Operator(None, "batch_norm",
                           {s: [s.lower()] for s in ins},
                           {"Y": ["y"], "MeanOut": ["mean"],
                            "VarianceOut": ["variance"],
                            "SavedMean": ["saved_m"],
                            "SavedVariance": ["saved_v"]}, attrs)
        descs.append(reg.get_op_info("batch_norm").grad_maker(op, block,
                                                              set()))
    assert descs[0] == descs[1]
    desc, = descs[0]
    arrays = {s.lower(): v[0] for s, v in ins.items()}
    arrays["y@GRAD"] = _f(*ins["X"][0].shape, seed=9)
    gins = {s: [arrays[n] for n in names]
            for s, names in desc["inputs"].items()}
    with jax.disable_jit():
        ref = ref_registry.get_op_info(desc["type"]).lower(
            RefCtx(0), _to_jax(gins), desc["attrs"])
    got = registry.get_op_info(desc["type"]).lower(_ctx(), _to_torch(gins),
                                                   desc["attrs"])
    _compare(got, ref)


def test_gaussian_random_shape_dtype_and_moments():
    attrs = {"shape": [400, 50], "dtype": "float32", "mean": 1.5,
             "std": 0.25, "seed": 0}
    out, = registry.get_op_info("gaussian_random").lower(
        _ctx(), {}, attrs)["Out"]
    with jax.disable_jit():
        ref, = ref_registry.get_op_info("gaussian_random").lower(
            RefCtx(0), {}, attrs)["Out"]
    assert tuple(out.shape) == np.asarray(ref).shape == (400, 50)
    assert out.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    # 20,000 draws: the sample mean and std are within 5 standard errors
    assert abs(float(out.mean()) - 1.5) < 5 * 0.25 / np.sqrt(2e4)
    assert abs(float(out.std()) - 0.25) < 5 * 0.25 / np.sqrt(4e4)


@pytest.mark.parametrize("op_type", ["gaussian_random", "top_k",
                                     "accuracy"])
def test_no_grad_ops_agree_with_reference(op_type):
    assert registry.get_op_info(op_type).no_grad
    assert ref_registry.get_op_info(op_type).no_grad


# -- programs and the fusion pass -----------------------------------------------

def _toy(L, M):
    """Two bottleneck blocks (strides 1 and 2), global pooling, fc with
    softmax, cross-entropy (``tests/test_ir.py:426-447``)."""
    img = L.data("img", shape=[8, 8, 8], dtype="float32")
    label = L.data("label", shape=[1], dtype="int64")
    h = M.bottleneck_block(img, 4, 1, "bb0")
    h = M.bottleneck_block(h, 4, 2, "bb1")
    pred = L.fc(L.pool2d(h, pool_type="avg", global_pooling=True), size=4,
                act="softmax")
    return L.mean(L.cross_entropy(pred, label))


def _resnet50(L, M):
    _, _, loss, _ = M.build_resnet_train(class_dim=10, depth=50,
                                         image_shape=(3, 32, 32))
    return loss


def _build(pkg, model, train=True):
    if pkg == "ref":
        main, startup = RefProgram(), RefProgram()
        with ref_guard(main, startup), ref_names.guard():
            loss = model(ref_layers, ref_resnet)
            if train:
                ref_opt.MomentumOptimizer(0.1, 0.9).minimize(loss)
    else:
        main, startup = core.Program(), core.Program()
        with core.program_guard(main, startup), unique_name.guard():
            loss = model(layers, resnet)
            if train:
                opt.MomentumOptimizer(0.1, 0.9).minimize(loss)
    return main, startup, loss.name


def _serialized(prog):
    d = json.loads(prog.serialize_to_string())
    d.pop("framework_version")
    return d


def _decisions(prog):
    return [(d["anchor"], d["verdict"], d.get("rule"), d["rank"])
            for d in prog._attrs["fusion"]["candidates"]]


_FEEDS = {"toy": {"img": (2, 8, 8, 8), "label": (2, 1)},
          "resnet50": {"image": (4, 3, 32, 32), "label": (4, 1)}}


@pytest.mark.parametrize("model,n_fused", [("toy", 6), ("resnet50", 36)])
def test_fused_training_program_matches_reference(model, n_fused):
    build = {"toy": _toy, "resnet50": _resnet50}[model]
    ref_main, ref_startup, ref_loss = _build("ref", build)
    main, startup, loss = _build("port", build)
    assert _serialized(main) == _serialized(ref_main)
    assert _serialized(startup) == _serialized(ref_startup)
    ref_fusion.clear_cache()
    fused_ref = ref_fusion.fuse_program(ref_main, [ref_loss],
                                        feed_shapes=_FEEDS[model])
    fused = fusion.fuse_program(main, [loss], feed_shapes=_FEEDS[model])
    assert fused is not main
    assert _serialized(fused) == _serialized(fused_ref)
    types = [op.type for op in fused.global_block().ops]
    assert types.count("fused_conv1x1_bn") == n_fused
    assert types.count("fused_conv1x1_bn_grad") == n_fused
    assert _decisions(fused) == _decisions(fused_ref)
    applied = [d for d in _decisions(fused) if d[1] == "applied"]
    assert len(applied) == n_fused
    assert all(d[2] == "kernel_unsupported"
               for d in _decisions(fused) if d[1] == "rejected")
    # cached: the repeat call is the same object
    assert fusion.fuse_program(main, [loss],
                               feed_shapes=_FEEDS[model]) is fused


def _conv_bn(L, kernel, is_test):
    img = L.data("img", shape=[4, 6, 6], dtype="float32")
    conv = L.conv2d(img, num_filters=4, filter_size=kernel,
                    padding=(kernel - 1) // 2, bias_attr=False)
    y = L.batch_norm(conv, act="relu", is_test=is_test)
    return L.mean(y)


@pytest.mark.parametrize("kernel,is_test,rule", [
    (3, False, "kernel_unsupported"), (1, True, "bn_mode_unsupported")])
def test_fusion_rejects_what_the_kernel_does_not_take(kernel, is_test, rule):
    def model(L, M):
        return _conv_bn(L, kernel, is_test)
    ref_main, _, ref_loss = _build("ref", model, train=False)
    main, _, loss = _build("port", model, train=False)
    report = fusion.analyze_program(main, [loss], batch_size=2)
    ref_report = ref_fusion.analyze_program(ref_main, [ref_loss],
                                            batch_size=2)
    assert [(d.verdict, d.rule) for d in report.decisions] == \
        [(d.verdict, d.rule) for d in ref_report.decisions] == \
        [("rejected", rule)]
    assert fusion.fuse_program(main, [loss]) is main


def test_gpt_programs_have_no_candidates():
    """No conv candidates in a GPT program: its candidates are the FFN's
    dense epilogue and the embedding LayerNorm (``test_torch_fusion.py``)."""
    from paddle_tpu_torch.models import transformer as T
    main = core.Program()
    with core.program_guard(main, core.Program()):
        _, _, loss = T.build_gpt_pretrain(
            T.BertConfig(vocab_size=32, d_model=16, n_layer=1, n_head=2,
                         d_inner=32, max_pos=8, dropout=0.0), 8)
        opt.AdamOptimizer(1e-3).minimize(loss)
    patterns = [d.pattern for d in
                fusion.analyze_program(main, [loss.name]).decisions]
    assert "conv_bn_relu" not in patterns
    assert sorted(patterns) == ["dense_epilogue", "embedding_layer_norm"]


# -- training --------------------------------------------------------------------

def _train_plans(exe):
    return [p for p in exe._plans.values()
            if any(op.type == "momentum" for op, _ in p.ops)]


def _toy_feed():
    rng = np.random.RandomState(0)
    return {"img": rng.rand(2, 8, 8, 8).astype(np.float32),
            "label": rng.randint(0, 4, (2, 1)).astype(np.int64)}


def _ref_init(startup):
    ref_scope = RefScope()
    RefExecutor().run(startup, scope=ref_scope, seed=3)
    return ref_scope, {v.name: np.asarray(ref_scope.find_var(v.name))
                       for v in startup.global_block().vars.values()}


def test_three_momentum_steps_match_reference():
    ref_main, ref_startup, ref_loss = _build("ref", _toy)
    main, _, loss = _build("port", _toy)
    ref_scope, init = _ref_init(ref_startup)
    running = [n for n in init if n.endswith((".bn.mean", ".bn.var"))]
    assert len(running) == 2 * 8            # 8 batch norms in the toy
    port_scope = ptt.io.params_from_numpy(scope.Scope(), init)
    exe, ref_exe = ptt.Executor(ptt.CPUPlace()), RefExecutor()
    feed = _toy_feed()
    losses = []
    for _ in range(STEPS):
        want, = ref_exe.run(ref_main, feed=feed, fetch_list=[ref_loss],
                            scope=ref_scope)
        got, = exe.run(main, feed=feed, fetch_list=[loss], scope=port_scope)
        np.testing.assert_allclose(float(got), float(np.asarray(want)),
                                   rtol=LOSS_RTOL)
        losses.append(float(got))
    assert losses[-1] < losses[0]
    plan, = _train_plans(exe)
    types = [op.type for op, _ in plan.ops]
    assert types.count("fused_conv1x1_bn") == 6
    state = ptt.io.params_to_numpy(port_scope)
    assert set(init) <= set(state)
    for n in init:
        r = np.asarray(ref_scope.find_var(n))
        np.testing.assert_allclose(state[n], r, err_msg=n, **STATE_TOL)
    # the running statistics moved, in place
    moved = [n for n in running if not np.allclose(state[n], init[n])]
    assert len(moved) == len(running)


def test_each_fused_forward_runs_once_per_step(monkeypatch):
    """One ``fused_conv1x1_bn`` lowering per fused op and step: each grad
    op, which carries only ``OG$Y``, takes its forward's graph."""
    calls = []
    info = registry.get_op_info("fused_conv1x1_bn")
    lower = info.lower

    def counting(ctx, ins, attrs):
        if ins["X"][0].device.type != "meta":   # not the verifier's inference
            calls.append(torch.is_grad_enabled())
        return lower(ctx, ins, attrs)

    monkeypatch.setattr(info, "lower", counting)
    main, startup, loss = _build("port", _toy)
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc, seed=1)
    for step in range(1, 3):
        exe.run(main, feed=_toy_feed(), fetch_list=[loss], scope=sc)
        assert calls == [True] * 6 * step
    plan, = _train_plans(exe)
    fused_grads = [i for i, (op, _) in enumerate(plan.ops)
                   if op.type == "fused_conv1x1_bn_grad"]
    assert len(fused_grads) == 6
    assert all(plan.fwd_of[i] is not None for i in fused_grads)
    assert None not in plan.fwd_of.values()


def test_fusion_flag_flip_replans_and_trains_the_same():
    main, startup, loss = _build("port", _toy)
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc, seed=1)
    unfused_sc = scope.Scope()
    for n, v in sc.items():
        unfused_sc.set_var(n, v.clone())
    fused_loss, = exe.run(main, feed=_toy_feed(), fetch_list=[loss],
                          scope=sc)
    flags.set_flags({"FLAGS_graph_fusion": False})
    try:
        plain_loss, = exe.run(main, feed=_toy_feed(), fetch_list=[loss],
                              scope=unfused_sc)
    finally:
        flags.set_flags({"FLAGS_graph_fusion": True})
    plans = _train_plans(exe)
    assert sorted([op.type for op, _ in p.ops].count("fused_conv1x1_bn")
                  for p in plans) == [0, 6]
    np.testing.assert_allclose(fused_loss, plain_loss, rtol=1e-6)
    for p in main.all_parameters():
        np.testing.assert_allclose(sc.find_var(p.name).numpy(),
                                   unfused_sc.find_var(p.name).numpy(),
                                   err_msg=p.name, **STATE_TOL)


def test_flags_validate_and_autotune_is_refused(monkeypatch):
    """The flags validate, and with ``FLAGS_fusion_autotune`` on a rewrite
    whose fused op loses its micro-benchmark is refused
    (``autotune_lost``): the program runs unfused."""
    assert flags.get_flags("FLAGS_fusion_rank_threshold") == {
        "FLAGS_fusion_rank_threshold": 0.02}
    with pytest.raises(ValueError, match="unknown flag"):
        flags.set_flags({"FLAGS_no_such_flag": 1})
    main, _, loss = _build("port", _toy)
    monkeypatch.setattr(fusion, "_autotune", lambda cand, batch, device: {
        "base_ms": 1.0, "fused_ms": 2.0, "win": False, "cached": False})
    flags.set_flags({"FLAGS_fusion_autotune": True})
    try:
        assert fusion.fuse_program(main, [loss]) is main
        verdicts = {d["verdict"] for d in main._attrs["fusion"]["candidates"]
                    if d["pattern"] == "conv_bn_relu"}
        assert "autotune_lost" in verdicts and "applied" not in verdicts
    finally:
        flags.set_flags({"FLAGS_fusion_autotune": False})
