"""bf16 AMP (``paddle_tpu_torch.amp``) against the JAX package, on the CPU.

- the policy: the white, black and big-elementwise lists and the
  slot restriction equal the reference's, and ``cast_ins`` gives the
  reference's dtypes for every listed op type and a few unlisted ones,
  over float32 and bf16 inputs of rank 1 to 4 (exact);
- ``DynamicLossScaler``: the same scales and apply/skip verdicts as the
  reference's for a fixed found-inf sequence (exact), and its gauge and
  skipped-step counter;
- the dtype oracle: a toy GPT (2 layers, d 64, 2 heads, seq 64, flash
  attention, fused LM head) and a toy ResNet (two bottleneck blocks)
  under ``amp.decorate``, one step through ``Executor(CPUPlace())``: the
  dtype of every variable an op writes, fetched, equals the reference's
  (exact), fetched whole (the fusion pass then keeps the chains) and as
  the fused program leaves them;
- 3 steps of each toy under ``amp.decorate`` against the reference run op
  by op (``jax.disable_jit``: jitted on the CPU, XLA keeps a bf16
  product's sum in float32): losses within ``LOSS_RTOL``; every parameter
  and every parameter gradient stays float32;
- a generic grad op casts inside its differentiated forward: a float32
  weight's gradient is float32 (the bf16 product's gradient, widened);
- ``fused_dense_act`` and ``fused_embedding_layer_norm`` under AMP on 2-D
  and 3-D inputs, with and without their kernels' plain versions, and
  their gradients, against the reference;
- the fusion autotuner times an AMP program's chains under AMP, and its
  cache key says ``"amp"``.

Tolerances: where both packages round the same float32 values to bf16, a
sum taken in another order can land on the neighbouring bf16 value, so the
fused ops' outputs agree within one bf16 ulp of their largest magnitude
and their gradients within two (``OUT_ULPS``, ``GRAD_ULPS``); the losses
of 3 steps within 2e-3 relative (``LOSS_RTOL``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import amp as ref_amp
from paddle_tpu import layers as ref_layers
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import registry as ref_registry
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.framework.executor import LowerCtx as RefCtx
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu.models import transformer as RT
from paddle_tpu_torch import amp, flags, layers
from paddle_tpu_torch import monitor
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.analysis import fusion
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.framework.executor import LowerCtx
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.models import transformer as T
from _port_fixtures import collect_garbage_after_module  # noqa: F401

GPT = dict(vocab_size=64, d_model=64, n_layer=2, n_head=2, d_inner=128,
           max_pos=64, dropout=0.0)
SEQ, BATCH, STEPS = 64, 2, 3
# 3 AMP steps against the reference: the two packages round the same
# float32 values to bf16 at the same ops, but a bf16 product or sum taken
# in another order can round to the neighbouring value, and those
# differences compound over the steps (measured: GPT 1.9e-4, 5.3e-5,
# 2.2e-4; ResNet 0, 3.7e-4, 4.8e-4 relative, steps 1-3)
LOSS_RTOL = 2e-3
DEFAULTS = {"FLAGS_graph_fusion": True, "FLAGS_fusion_autotune": False,
            "FLAGS_fusion_rank_threshold": 0.02,
            "FLAGS_xla_compile_cache_dir": ""}


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
    flags.set_flags(DEFAULTS)


def _dtype(a) -> str:
    """The dtype's name in both packages (the reference records a 64-bit
    integer as 32-bit: it runs with x64 off)."""
    name = str(a.dtype).replace("torch.", "")
    return {"int64": "int32"}.get(name, name)


def _bf16_ulp(a) -> float:
    top = float(np.abs(np.asarray(a, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


# -- the policy --------------------------------------------------------------

def test_policy_lists_match_reference():
    assert amp.WHITE_LIST == ref_amp.WHITE_LIST
    assert amp.BLACK_LIST == ref_amp.BLACK_LIST
    assert amp.BF16_IF_BIG == ref_amp.BF16_IF_BIG
    assert amp._SLOT_RESTRICT == ref_amp._SLOT_RESTRICT


_CAST_OPS = sorted(amp.WHITE_LIST | amp.BLACK_LIST | amp.BF16_IF_BIG) + [
    "mul_grad", "layer_norm_grad", "batch_norm_grad", "relu_grad",
    "softmax_with_cross_entropy_grad", "transpose2", "flash_attention",
    "fused_dense_act", "lookup_table", "adam"]


@pytest.mark.parametrize("op_type", _CAST_OPS)
def test_cast_ins_dtypes_match_reference(op_type):
    """float32 and bf16 activations of rank 1 to 4 in the X slot (the only
    slot a norm op casts) beside float32 state vectors, a bf16 operand, an
    integer input and an absent one: every resulting dtype is the
    reference's."""
    rng = np.random.RandomState(0)
    for ndim in range(1, 5):
        for x_dtype in ("float32", "bfloat16"):
            shape = (2,) * ndim
            x = rng.randn(*shape).astype(np.float32)
            ins = {"X": [(x, x_dtype)],
                   "Y": [(rng.randn(*shape).astype(np.float32), "float32")],
                   "Scale": [(np.ones(2, np.float32), "float32")],
                   "Mean": [(np.zeros(2, np.float32), "float32")],
                   "W": [(rng.randn(2, 2).astype(np.float32), "bfloat16")],
                   "Ids": [(np.arange(2), "int64")],
                   "Bias": [None]}
            ref = ref_amp.cast_ins(op_type, {
                s: [None if a is None else jnp.asarray(a[0]).astype(a[1])
                    for a in v] for s, v in ins.items()})
            got = amp.cast_ins(op_type, {
                s: [None if a is None else torch.from_numpy(a[0]).to(
                    getattr(torch, a[1])) for a in v]
                    for s, v in ins.items()})
            assert sorted(got) == sorted(ref)
            for slot in ref:
                for g, r in zip(got[slot], ref[slot]):
                    assert (g is None) == (r is None)
                    if g is not None:
                        assert _dtype(g) == _dtype(r), (slot, ndim, x_dtype)


def test_dynamic_loss_scaler_matches_reference():
    found = [False, False, True, False, True, True, False, False, False,
             True, True, True, True, False, False, False, False, False]
    kw = dict(init_loss_scaling=8.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5)
    mine, ref = amp.DynamicLossScaler(**kw), ref_amp.DynamicLossScaler(**kw)
    skipped = monitor.REGISTRY.counter("paddle_tpu_amp_skipped_steps_total")
    n0 = skipped.value()
    got, want = [], []
    for f in found:
        got.append((mine.update(f), mine.scale))
        want.append((ref.update(f), ref.scale))
    assert got == want
    assert monitor.REGISTRY.gauge("paddle_tpu_amp_scale").value() == \
        mine.scale
    assert skipped.value() - n0 == sum(found)


def test_decorate_marks_the_program_and_replans():
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup):
        x = layers.data("x", shape=[4], dtype="float32")
        loss = layers.mean(layers.fc(x, size=3))
        fp = main.fingerprint()
        dec = amp.decorate(opt.SGDOptimizer(0.1), init_loss_scaling=4.0,
                           use_dynamic_loss_scaling=False)
        dec.minimize(loss)
    assert main._attrs["amp"] is True and main.fingerprint() != fp
    assert dec.loss_scaler is None and dec._loss_scaling == 4.0
    assert dec._learning_rate == 0.1          # the inner optimizer's
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc)
    out, = exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                   fetch_list=[loss], scope=sc)
    plan = next(p for p in exe._plans.values()
                if any(op.type == "sgd" for op, _ in p.ops))
    assert plan.amp and out.dtype == np.float32


# -- the toys ------------------------------------------------------------------

def _toy_gpt(pkg):
    if pkg == "ref":
        with ref_names.guard():
            _, _, loss = RT.build_gpt_pretrain(
                RT.BertConfig(**GPT), SEQ, attn_impl="flash",
                fused_head=True, dropout=0.0)
            ref_amp.decorate(ref_opt.AdamOptimizer(1e-3)).minimize(loss)
    else:
        with unique_name.guard():
            _, _, loss = T.build_gpt_pretrain(
                T.BertConfig(**GPT), SEQ, attn_impl="flash",
                fused_head=True, dropout=0.0)
            amp.decorate(opt.AdamOptimizer(1e-3)).minimize(loss)
    return loss


def _toy_resnet(pkg):
    L, O, A, M, names = (
        (ref_layers, ref_opt, ref_amp, ref_resnet, ref_names)
        if pkg == "ref" else (layers, opt, amp, resnet, unique_name))
    with names.guard():
        img = L.data("image", shape=[16, 8, 8], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        h = M.bottleneck_block(img, 16, 1, "bb0")
        h = M.bottleneck_block(h, 16, 2, "bb1")
        pred = L.fc(L.pool2d(h, pool_type="avg", global_pooling=True),
                    size=4, act="softmax", param_attr="fc_out.w",
                    bias_attr="fc_out.b")
        loss = L.mean(L.cross_entropy(pred, label))
        A.decorate(O.MomentumOptimizer(learning_rate=0.1,
                                       momentum=0.9)).minimize(loss)
    return loss


TOYS = {"gpt": _toy_gpt, "resnet": _toy_resnet}


def _feed(model, seed=0):
    rng = np.random.RandomState(seed)
    if model == "gpt":
        ids = rng.randint(1, GPT["vocab_size"], (BATCH, SEQ)).astype(
            np.int64)
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = 0
        return {"src_ids": ids, "lm_label": labels}
    return {"image": rng.rand(4, 16, 8, 8).astype(np.float32),
            "label": rng.randint(0, 4, (4, 1)).astype(np.int64)}


def _both(model):
    """The toy in both packages, from the reference's startup state:
    ``(ref_main, ref_scope, main, port_scope, loss name)``."""
    ref_main, ref_startup = RefProgram(), RefProgram()
    with ref_guard(ref_main, ref_startup):
        TOYS[model]("ref")
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup):
        loss = TOYS[model]("port")
    assert main._attrs["amp"] and ref_main._attrs["amp"]
    ref_scope = RefScope()
    RefExecutor().run(ref_startup, scope=ref_scope, seed=7)
    init = {v.name: np.asarray(ref_scope.find_var(v.name))
            for v in ref_startup.global_block().vars.values()}
    port_scope = ptt.io.params_from_numpy(scope.Scope(), init)
    return ref_main, ref_scope, main, port_scope, loss.name


def _written(program):
    return sorted({n for op in program.global_block().ops
                   for n in op.output_arg_names() if n})


@pytest.mark.parametrize("fetch", ["every_op_output", "after_fusion"])
@pytest.mark.parametrize("model", sorted(TOYS))
def test_fetched_dtypes_match_reference(model, fetch):
    """The dtype oracle: one step, every variable an op writes fetched
    from both packages (``every_op_output``: fetching a chain's internals
    keeps the fusion pass from rewriting it; ``after_fusion``: every
    variable the fused program writes)."""
    ref_main, ref_scope, main, port_scope, loss = _both(model)
    feed = _feed(model)
    names = _written(main)
    assert names == _written(ref_main)
    if fetch == "after_fusion":
        fused = fusion.fuse_program(
            main, [loss], feed_shapes={k: v.shape for k, v in feed.items()})
        assert fused is not main
        names = _written(fused)
    with jax.disable_jit():
        want = RefExecutor().run(ref_main, feed=feed, fetch_list=names,
                                 scope=ref_scope)
    got = ptt.Executor(ptt.CPUPlace()).run(
        main, feed=feed, fetch_list=names, scope=port_scope,
        return_numpy=False)
    bad = {n: (_dtype(g.tensor), _dtype(np.asarray(r)))
           for n, g, r in zip(names, got, want)
           if _dtype(g.tensor) != _dtype(np.asarray(r))}
    assert not bad
    assert sum(_dtype(g.tensor) == "bfloat16" for g in got) > len(names) / 8


@pytest.mark.parametrize("model", sorted(TOYS))
def test_three_amp_steps_match_reference(model):
    ref_main, ref_scope, main, port_scope, loss = _both(model)
    params = [p.name for p in main.all_parameters() if p.trainable]
    grads = [p + "@GRAD" for p in params]
    exe, ref_exe = ptt.Executor(ptt.CPUPlace()), RefExecutor()
    losses = []
    for step in range(STEPS):
        feed = _feed(model, seed=step)
        with jax.disable_jit():
            want, = ref_exe.run(ref_main, feed=feed, fetch_list=[loss],
                                scope=ref_scope)
        got = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                      scope=port_scope, return_numpy=False)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   rtol=LOSS_RTOL)
        losses.append(float(got[0].numpy()))
        # master weights and their gradients stay float32
        assert all(h.tensor.dtype == torch.float32 for h in got), \
            [(g, h.tensor.dtype) for g, h in zip(grads, got[1:])
             if h.tensor.dtype != torch.float32]
        assert all(port_scope.find_var(p).dtype == torch.float32
                   for p in params)
    assert all(np.isfinite(losses))


def test_grad_op_casts_inside_the_differentiated_forward():
    """``mul`` under AMP: the forward's output is bf16, the float32
    weight's gradient is float32 and equals the bf16 product's gradient
    widened (a cast before the leaves would give a bf16 gradient)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(6, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 5).astype(np.float32))
    og = torch.from_numpy(rng.randn(6, 5).astype(np.float32))
    ctx = LowerCtx(torch.device("cpu"), 0, amp=True)
    info = registry.get_op_info("mul")
    fwd = registry.run_forward(info, ctx, {"X": [x], "Y": [w]}, {})
    assert fwd[1]["Out"][0].dtype == torch.bfloat16
    grads = registry.generic_grad_lower(
        ctx, {"X$X": [x], "X$Y": [w], "OG$Out": [og]},
        {"__fwd_type__": "mul"}, fwd)
    gx, gw = grads["IG$X"][0], grads["IG$Y"][0]
    assert gx.dtype == gw.dtype == torch.float32
    want = (x.to(torch.bfloat16).t() @ og.to(torch.bfloat16)).float()
    assert torch.equal(gw, want)
    with jax.disable_jit():
        ref = ref_registry.generic_grad_lower(
            RefCtx(0, amp=True), {"X$X": [jnp.asarray(x.numpy())],
                                  "X$Y": [jnp.asarray(w.numpy())],
                                  "OG$Out": [jnp.asarray(og.numpy())]},
            {"__fwd_type__": "mul"})
    assert _dtype(ref["IG$Y"][0]) == "float32"
    np.testing.assert_allclose(gw.numpy(), np.asarray(ref["IG$Y"][0]),
                               rtol=0, atol=_bf16_ulp(want))


# -- the fused ops under AMP ---------------------------------------------------

def _f(*shape, seed=0, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _dense(x, n, **attrs):
    k = x.shape[-1]
    a = dict(x_num_col_dims=x.ndim - 1, act="gelu", approximate=False,
             bias_axis=x.ndim - 1, seed=0, use_pallas=False)
    a.update(attrs)
    return ("fused_dense_act", {"X": [x], "W": [_f(k, n, seed=1, scale=0.3)],
                                "Bias": [_f(n, seed=2)]}, a)


def _emb(ids, d, addends, **attrs):
    a = dict(padding_idx=-1, epsilon=1e-5, begin_norm_axis=ids.ndim - 1,
             use_pallas=False)
    a.update(attrs)
    return ("fused_embedding_layer_norm", {
        "Ids": [ids], "W": [_f(30, d)], "Addends": addends,
        "Scale": [_f(d, seed=3) + 1], "Bias": [_f(d, seed=4)]}, a)


# The fused ops under AMP: outputs within one bf16 ulp of their largest
# magnitude (both round the same float32 sums; the reference's bf16 gelu is
# several rounded jnp operations, torch's one float32 formula rounded
# once); gradients within two (the bias, scale and addend gradients sum
# bf16 terms over the rows, which the reference rounds as it adds them).
# Measured: at most 0.5 ulp on the outputs, 2 on the gradients.
OUT_ULPS, GRAD_ULPS = 1, 2
_IDS3 = np.random.RandomState(0).randint(0, 30, (3, 6, 1)).astype(np.int64)
_IDS2 = np.random.RandomState(1).randint(0, 30, (12, 1)).astype(np.int64)
AMP_FUSED = {
    "dense_3d_gelu": _dense(_f(3, 8, 12), 20),
    "dense_3d_gelu_k5": _dense(_f(3, 8, 12), 20, use_pallas=True),
    "dense_2d_relu": _dense(_f(16, 24), 16, act="relu"),
    "dense_2d_relu_k5": _dense(_f(16, 24), 16, act="relu", use_pallas=True),
    "dense_matmul_3d_k5": _dense(_f(2, 4, 10), 6, x_num_col_dims=-1,
                                 use_pallas=True),
    "emb_ln_3d": _emb(_IDS3, 16, [_f(3, 6, 16, seed=1), _f(16, seed=2)]),
    "emb_ln_3d_k4": _emb(_IDS3, 16, [_f(3, 6, 16, seed=1), _f(16, seed=2)],
                         use_pallas=True),
    "emb_ln_2d": _emb(_IDS2, 16, [_f(16, seed=2)]),
    "emb_ln_2d_k4": _emb(_IDS2, 16, [_f(16, seed=2)], use_pallas=True),
}


def _to_jax(ins):
    return {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}


def _to_torch(ins):
    return {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}


def _close(got, want, what, ulps):
    """Same dtype, values within ``ulps`` bf16 ulps of the largest."""
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    w = np.asarray(want, np.float32)
    assert _dtype(got) == _dtype(want), what
    np.testing.assert_allclose(g, w, rtol=0, atol=ulps * _bf16_ulp(w),
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(AMP_FUSED))
def test_fused_op_under_amp_matches_reference(case):
    op_type, ins, attrs = AMP_FUSED[case]
    with jax.disable_jit():
        ref = ref_registry.get_op_info(op_type).lower(
            RefCtx(0, amp=True), _to_jax(ins), attrs)
    ctx = LowerCtx(torch.device("cpu"), 0, amp=True)
    got = registry.get_op_info(op_type).lower(ctx, _to_torch(ins), attrs)
    for slot in ref:
        _close(got[slot][0], ref[slot][0], slot, OUT_ULPS)
    big = ins[next(iter(ins))][0].ndim >= 3 if op_type == "fused_dense_act" \
        else ins["Ids"][0].ndim >= 3
    want = "bfloat16" if big or attrs["use_pallas"] and \
        op_type == "fused_dense_act" else "float32"
    assert _dtype(got["Out"][0]) == want
    # the generic gradient through every floating input
    og = _f(*got["Out"][0].shape, seed=10)
    gins = {"X$" + s: v for s, v in ins.items()}
    gins["OG$Out"] = [og]
    gattrs = dict(attrs, __fwd_type__=op_type)
    with jax.disable_jit():
        rg = ref_registry.generic_grad_lower(RefCtx(0, amp=True),
                                             _to_jax(gins), gattrs)
    pg = registry.generic_grad_lower(ctx, _to_torch(gins), gattrs)
    for s, vals in ins.items():
        for j, a in enumerate(vals):
            if np.issubdtype(a.dtype, np.floating):
                _close(pg["IG$" + s][j], rg["IG$" + s][j], f"IG${s}[{j}]",
                       GRAD_ULPS)


# -- the autotuner under AMP ---------------------------------------------------

def test_autotune_times_amp_chains_and_keys_them_amp(tmp_path, monkeypatch):
    flags.set_flags({"FLAGS_fusion_autotune": True,
                     "FLAGS_fusion_rank_threshold": 0.0,
                     "FLAGS_xla_compile_cache_dir": str(tmp_path)})
    fusion.clear_cache()
    regimes = []
    time_chain = fusion._time_chain

    def spy(descs, ext_vals, device, reps=3, amp=False):
        regimes.append(amp)
        return time_chain(descs, ext_vals, device, reps=1, amp=amp)

    monkeypatch.setattr(fusion, "_time_chain", spy)
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup):
        loss = _toy_gpt("port")
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc, seed=1)
    exe.run(main, feed=_feed("gpt"), fetch_list=[loss], scope=sc)
    records = json.loads((tmp_path / "fusion_autotune.json").read_text())
    assert records and regimes and all(regimes)
    assert all(json.loads(k)[-1] == "amp" for k in records)
    plan = next(p for p in exe._plans.values()
                if any(op.type == "adam" for op, _ in p.ops))
    decided = [d for d in plan.block.program._attrs["fusion"]["candidates"]
               if "autotune" in d]
    assert {d["pattern"] for d in decided} == {"dense_epilogue",
                                               "embedding_layer_norm"}
    fusion.clear_cache()
