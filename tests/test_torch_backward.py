"""Gradient synthesis and the training ops of the port against the JAX package.

- ``append_backward`` and ``Optimizer.minimize`` build the same serialized
  training program in both packages (fresh ``unique_name`` generators in
  both): the GPT and BERT pretraining programs, every optimizer ported, with
  gradient clipping and weight decay;
- every op type of the training programs gives the same input gradients
  through the port's generic ``*_grad`` lowering (``torch.autograd``) as
  through the reference's (``jax.vjp``) on the same numpy inputs and output
  gradients — one parametrised test;
- the forward lowerings the training slice adds (loss, reduction,
  comparison, gradient fan-in, clipping and optimizer ops) match the
  reference's.

Tolerance: rtol 1e-5, atol 1e-6 in float32, exact for integer and boolean
outputs.  The reference runs op by op here (``jax.disable_jit``): jitted on
the CPU, XLA folds the convert of a bf16 product back into an f32 product,
so the reference would skip the bf16 rounding of ``fused_lm_head_ce``'s
products that the TPU — and the port — apply; op by op it rounds them as
written, and the two packages agree bit for bit on that op's gradients.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import registry as ref_registry
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.framework.executor import LowerCtx as RefCtx
from paddle_tpu.models import transformer as RT
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.framework.executor import LowerCtx
from paddle_tpu_torch.models import transformer as T
from _port_fixtures import collect_garbage_after_module  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
CFG = dict(vocab_size=64, d_model=32, n_layer=2, n_head=4, d_inner=64,
           max_pos=16, dropout=0.0)


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


# -- the same training program ------------------------------------------------

def _training_program(pkg, build):
    """``build(models, optimizer_module, package)`` inside fresh programs
    and names of ``pkg`` ("ref" or "port")."""
    if pkg == "ref":
        core_mod, names, models, opt_mod, root = (
            pt.framework.core, ref_names, RT, ref_opt, pt)
    else:
        core_mod, names, models, opt_mod, root = (core, unique_name, T, opt,
                                                  ptt)
    main, startup = core_mod.Program(), core_mod.Program()
    with core_mod.program_guard(main, startup), names.guard():
        build(models, opt_mod, root)
    return main, startup


def _gpt_adam(attn_impl, fused_head):
    def build(M, O, root):
        _, _, loss = M.build_gpt_pretrain(M.BertConfig(**CFG), 16,
                                          attn_impl=attn_impl,
                                          fused_head=fused_head, dropout=0.0)
        O.AdamOptimizer(1e-3).minimize(loss)
    return build


def _bert(optimizer):
    def build(M, O, root):
        _, _, loss = M.build_bert_pretrain(M.BertConfig(**CFG), 16,
                                           dropout=0.0, fused_head=False)
        if optimizer == "sgd_clip_value":
            O.SGDOptimizer(0.1, grad_clip=root.GradientClipByValue(
                0.5)).minimize(loss)
        elif optimizer == "momentum_l2":
            O.MomentumOptimizer(0.1, 0.9, use_nesterov=True,
                                regularization=root.regularizer.L2Decay(
                                    1e-4)).minimize(loss)
        elif optimizer == "adam_fused_flat_global_norm":
            O.AdamOptimizer(1e-3, fused_flat=True, fused_max_numel=2048,
                            grad_clip=root.GradientClipByGlobalNorm(
                                1.0)).minimize(loss)
        elif optimizer == "adam_clip_norm_l1":
            O.AdamOptimizer(1e-3, grad_clip=root.GradientClipByNorm(1.0),
                            regularization=root.regularizer.L1Decay(
                                1e-5)).minimize(loss)
    return build


def _backward_only(M, O, root):
    _, _, loss = M.build_gpt_pretrain(M.BertConfig(**CFG), 16,
                                      attn_impl="flash", dropout=0.0)
    pairs = root.append_backward(loss)
    assert pairs and all(g.name == p.name + "@GRAD" for p, g in pairs)


PROGRAMS = {
    "gpt_flash_fused_adam": _gpt_adam("flash", True),
    "gpt_flash_dense_adam": _gpt_adam("flash", False),
    "gpt_base_fused_adam": _gpt_adam("base", True),
    "gpt_base_dense_adam": _gpt_adam("base", False),
    "gpt_backward_only": _backward_only,
    "bert_sgd_clip_value": _bert("sgd_clip_value"),
    "bert_momentum_l2": _bert("momentum_l2"),
    "bert_adam_fused_flat_global_norm": _bert("adam_fused_flat_global_norm"),
    "bert_adam_clip_norm_l1": _bert("adam_clip_norm_l1"),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_training_program_serializes_like_the_reference(name):
    ref_main, ref_startup = _training_program("ref", PROGRAMS[name])
    main, startup = _training_program("port", PROGRAMS[name])
    for ours, theirs in ((main, ref_main), (startup, ref_startup)):
        assert json.loads(ours.serialize_to_string()) == \
            json.loads(theirs.serialize_to_string())


def test_gpt_training_program_has_the_expected_ops():
    """Each differentiable forward op of the GPT program gets one
    ``*_grad`` op; the fan-in of shared grads goes through ``sum``."""
    main, _ = _training_program("port", _gpt_adam("flash", True))
    types = [op.type for op in main.global_block().ops]
    fwd = [t for t in types if not t.endswith("_grad")]
    for t in ("mul", "layer_norm", "flash_attention", "fused_lm_head_ce",
              "lookup_table", "split", "gelu", "reduce_sum"):
        assert types.count(t + "_grad") == fwd.count(t), t
    assert types.count("adam") == len(main.all_parameters())
    assert "sum" in types and "greater_than_grad" not in types


# -- every op's gradient --------------------------------------------------------

def _f(*shape, seed=0, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _ids(*shape, high, seed=0):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.int64)


# name -> (op type, {slot: [array]}, attrs); output grads are drawn from a
# seed for every float output but XShape/Mean/Variance (no grad flows there
# in a training program)
GRAD_CASES = {
    "add_same": ("elementwise_add", {"X": [_f(2, 4, 8)], "Y": [_f(2, 4, 8, seed=1)]}, {"axis": -1}),
    "add_bias_axis2": ("elementwise_add", {"X": [_f(2, 4, 8)], "Y": [_f(8, seed=1)]}, {"axis": 2}),
    "add_pos_broadcast": ("elementwise_add", {"X": [_f(2, 4, 8)], "Y": [_f(1, 4, 8, seed=1)]}, {"axis": -1}),
    "add_scalar": ("elementwise_add", {"X": [_f(3)], "Y": [np.array(1e-6, np.float32)]}, {"axis": -1}),
    "sub_mask": ("elementwise_sub", {"X": [_f(4, 4)], "Y": [_f(4, 4, seed=1)]}, {"axis": -1}),
    "mul_loss_mask": ("elementwise_mul", {"X": [_f(2, 4, 1)], "Y": [_f(2, 4, 1, seed=1)]}, {"axis": -1}),
    "div_scalars": ("elementwise_div", {"X": [np.array(3.5, np.float32)], "Y": [np.array(7.25, np.float32)]}, {"axis": -1}),
    "mul_ncd2": ("mul", {"X": [_f(2, 4, 8)], "Y": [_f(8, 6, seed=1)]}, {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "matmul_scores": ("matmul", {"X": [_f(2, 2, 4, 8)], "Y": [_f(2, 2, 4, 8, seed=1)]}, {"transpose_X": False, "transpose_Y": True, "alpha": 0.35}),
    "matmul_ctx": ("matmul", {"X": [_f(2, 2, 4, 4)], "Y": [_f(2, 2, 4, 8, seed=1)]}, {"transpose_X": False, "transpose_Y": False, "alpha": 1.0}),
    "reshape_heads": ("reshape2", {"X": [_f(2, 4, 8)]}, {"shape": [0, 0, 2, 4]}),
    "transpose": ("transpose2", {"X": [_f(2, 4, 2, 4)]}, {"axis": [0, 2, 1, 3]}),
    "layer_norm": ("layer_norm", {"X": [_f(2, 4, 8) * 2 + 1], "Scale": [_f(8, seed=1)], "Bias": [_f(8, seed=2)]}, {"epsilon": 1e-5, "begin_norm_axis": 2}),
    "split_qkv": ("split", {"X": [_f(2, 4, 12)]}, {"num": 3, "axis": 2, "sections": []}),
    "gelu": ("gelu", {"X": [_f(3, 7) * 3]}, {}),
    "softmax": ("softmax", {"X": [_f(2, 2, 4, 4) * 3]}, {"axis": -1}),
    "scale": ("scale", {"X": [_f(4, 4)]}, {"scale": -1e9, "bias": 0.0, "bias_after_scale": True}),
    "relu": ("relu", {"X": [_f(4, 4)]}, {}),
    "sign": ("sign", {"X": [_f(4, 4)]}, {}),
    "expand": ("expand", {"X": [_f(4, 1)]}, {"expand_times": [1, 4]}),
    "unsqueeze_pos": ("unsqueeze2", {"X": [_f(4, 8)]}, {"axes": [0]}),
    "unsqueeze_mask": ("unsqueeze2", {"X": [_f(2, 4)]}, {"axes": [2]}),
    "reduce_sum_all": ("reduce_sum", {"X": [_f(2, 4, 1)]}, {"dim": None, "keep_dim": False, "reduce_all": True}),
    "reduce_sum_dim": ("reduce_sum", {"X": [_f(2, 4, 3)]}, {"dim": [1], "keep_dim": True, "reduce_all": False}),
    "reduce_mean_dim": ("reduce_mean", {"X": [_f(2, 4, 3)]}, {"dim": [-1], "keep_dim": False, "reduce_all": False}),
    "lookup_table": ("lookup_table", {"W": [_f(10, 4)], "Ids": [np.array([[1, 3, 3, 9, 0], [2, 3, 5, 7, 8]], np.int64)]}, {"padding_idx": -1}),
    "slice_pos_table": ("slice", {"Input": [_f(16, 4)]}, {"axes": [0], "starts": [0], "ends": [8]}),
    "flash_causal": ("flash_attention", {"Q": [_f(1, 2, 16, 8)], "K": [_f(1, 2, 16, 8, seed=1)], "V": [_f(1, 2, 16, 8, seed=2)]}, {"causal": True, "sm_scale": 0.35, "block_q": 0, "block_k": 0}),
    "flash_bias": ("flash_attention", {"Q": [_f(2, 2, 6, 8)], "K": [_f(2, 2, 6, 8, seed=1)], "V": [_f(2, 2, 6, 8, seed=2)], "Bias": [_f(1, 1, 6, 6, seed=3)]}, {"causal": False, "sm_scale": 0.0, "block_q": 0, "block_k": 0}),
    "fused_lm_head_ce": ("fused_lm_head_ce", {"X": [_f(2, 20, 32)], "W": [_f(32, 64, seed=1, scale=0.2)], "Bias": [_f(64, seed=2, scale=0.1)], "Label": [_ids(2, 20, high=64)]}, {"ignore_index": 0, "chunk_size": 16}),
    "swce_dense_head": ("softmax_with_cross_entropy", {"Logits": [_f(2, 4, 10)], "Label": [_ids(2, 4, 1, high=10)]}, {"soft_label": False, "ignore_index": 0, "axis": -1}),
}

_NO_OUTPUT_GRAD = ("XShape", "Mean", "Variance")


def _to_jax(ins):
    return {s: [None if a is None else jnp.asarray(a) for a in v]
            for s, v in ins.items()}


def _to_torch(ins):
    return {s: [None if a is None else torch.from_numpy(np.array(a))
                for a in v] for s, v in ins.items()}


def _port_ctx():
    return LowerCtx(torch.device("cpu"), 0)


def _grad_inputs(op_type, ins, attrs):
    """The ``*_grad`` op's inputs: the forward inputs and a seeded grad for
    each float output (as append_backward wires them)."""
    fwd = registry.get_op_info(op_type).lower(_port_ctx(), _to_torch(ins),
                                              attrs)
    gins = {"X$" + s: v for s, v in ins.items()}
    for k, (slot, outs) in enumerate(sorted(fwd.items())):
        gins["OG$" + slot] = [
            None if slot in _NO_OUTPUT_GRAD or not o.is_floating_point()
            else _f(*o.shape, seed=10 + k + j) for j, o in enumerate(outs)]
    return gins


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_op_gradient_matches_reference(case):
    op_type, ins, attrs = GRAD_CASES[case]
    info = registry.get_op_info(op_type)
    if info.grad_maker is not None:
        # a hand-written grad op: feed both packages the desc it makes
        return _check_grad_maker(op_type, ins, attrs)
    gattrs = dict(attrs, __fwd_type__=op_type)
    gins = _grad_inputs(op_type, ins, attrs)
    with jax.disable_jit():
        ref = ref_registry.generic_grad_lower(RefCtx(0), _to_jax(gins),
                                              gattrs)
    got = registry.generic_grad_lower(_port_ctx(), _to_torch(gins), gattrs)
    assert sorted(got) == sorted(ref)
    for slot, vals in ins.items():
        for j, a in enumerate(vals):
            if not np.issubdtype(a.dtype, np.floating):
                continue            # no gradient for ids or labels
            g, r = got["IG$" + slot][j], np.asarray(ref["IG$" + slot][j])
            assert tuple(g.shape) == r.shape, (slot, g.shape, r.shape)
            np.testing.assert_allclose(g.numpy(), r, err_msg=slot, **TOL)


def _check_grad_maker(op_type, ins, attrs):
    fwd = registry.get_op_info(op_type).lower(_port_ctx(), _to_torch(ins),
                                              attrs)
    gins = {"Softmax": [fwd["Softmax"][0].numpy()], "Label": ins["Label"],
            "LossGrad": [_f(*fwd["Loss"][0].shape, seed=11)]}
    grad_type = op_type + "_grad"
    ref = ref_registry.get_op_info(grad_type).lower(RefCtx(0),
                                                    _to_jax(gins), attrs)
    got = registry.get_op_info(grad_type).lower(_port_ctx(),
                                                _to_torch(gins), attrs)
    np.testing.assert_allclose(got["LogitsGrad"][0].numpy(),
                               np.asarray(ref["LogitsGrad"][0]), **TOL)


def test_generic_grad_reuses_a_kept_forward():
    """The executor hands the grad op the graph of its forward run; that
    gives the same gradients as recomputing the forward, and differentiates
    only the inputs the grad op wants."""
    op_type, ins, attrs = GRAD_CASES["mul_ncd2"]
    gattrs = dict(attrs, __fwd_type__=op_type)
    gins = _to_torch(_grad_inputs(op_type, ins, attrs))
    fresh = registry.generic_grad_lower(_port_ctx(), gins, gattrs)
    info = registry.get_op_info(op_type)
    kept = registry.run_forward(info, _port_ctx(),
                                {"X": gins["X$X"], "Y": gins["X$Y"]}, attrs,
                                {"X": [False], "Y": [True]})
    og = {k: v for k, v in gins.items() if k.startswith("OG$")}
    got = registry.generic_grad_lower(_port_ctx(), og, gattrs, kept)
    assert got["IG$X"] == [None]
    torch.testing.assert_close(got["IG$Y"][0], fresh["IG$Y"][0])


# -- the forward lowerings the training slice adds ------------------------------

FWD_CASES = {
    "sum_three": ("sum", {"X": [_f(3, 4), _f(3, 4, seed=1), _f(3, 4, seed=2)]}, {}),
    "assign": ("assign", {"X": [_f(3, 4)]}, {}),
    "greater_than_label": ("greater_than", {"X": [np.array([[3, 0, 5, 0]], np.int64)], "Y": [np.array(0, np.int64)]}, {"axis": -1}),
    "less_equal": ("less_equal", {"X": [_f(3, 4)], "Y": [_f(4, seed=1)]}, {"axis": -1}),
    "equal": ("equal", {"X": [np.array([1, 2, 3], np.int64)], "Y": [np.array([1, 0, 3], np.int64)]}, {"axis": -1}),
    "cast_mask": ("cast", {"X": [np.array([[True, False, True]])]}, {"in_dtype": "bool", "out_dtype": "float32"}),
    "reduce_max_dim": ("reduce_max", {"X": [_f(2, 4, 3)]}, {"dim": [1], "keep_dim": False, "reduce_all": False}),
    "reduce_min_all": ("reduce_min", {"X": [_f(2, 4, 3)]}, {"dim": None, "keep_dim": True, "reduce_all": True}),
    "reduce_prod_dims": ("reduce_prod", {"X": [_f(2, 3, 2)]}, {"dim": [0, 2], "keep_dim": False, "reduce_all": False}),
    "reduce_any": ("reduce_any", {"X": [np.array([[True, False], [False, False]])]}, {"dim": [1], "keep_dim": False, "reduce_all": False}),
    "swce_soft_label": ("softmax_with_cross_entropy", {"Logits": [_f(3, 5)], "Label": [np.abs(_f(3, 5, seed=1))]}, {"soft_label": True, "ignore_index": -100, "axis": -1}),
    "swce_hard_ignore": ("softmax_with_cross_entropy", {"Logits": [_f(2, 4, 10)], "Label": [np.array([[[0], [3], [9], [0]], [[1], [0], [2], [5]]], np.int64)]}, {"soft_label": False, "ignore_index": 0, "axis": -1}),
    "lm_head_no_bias": ("fused_lm_head_ce", {"X": [_f(3, 7, 16)], "W": [_f(16, 40, seed=1, scale=0.3)], "Label": [_ids(3, 7, high=40)]}, {"ignore_index": -100, "chunk_size": 8}),
    "clip": ("clip", {"X": [_f(3, 4)]}, {"min": -0.5, "max": 0.3}),
    "clip_by_norm": ("clip_by_norm", {"X": [_f(3, 4)]}, {"max_norm": 1.0}),
    "squared_l2_norm": ("squared_l2_norm", {"X": [_f(3, 4)]}, {}),
    "sqrt": ("sqrt", {"X": [np.abs(_f(5))]}, {}),
    "elementwise_max": ("elementwise_max", {"X": [_f(1)], "Y": [np.array([0.5], np.float32)]}, {"axis": -1}),
    "sgd": ("sgd", {"Param": [_f(3, 4)], "Grad": [_f(3, 4, seed=1)], "LearningRate": [np.array([0.1], np.float32)]}, {}),
    "momentum": ("momentum", {"Param": [_f(3, 4)], "Grad": [_f(3, 4, seed=1)], "Velocity": [_f(3, 4, seed=2)], "LearningRate": [np.array([0.1], np.float32)]}, {"mu": 0.9, "use_nesterov": False}),
    "momentum_nesterov": ("momentum", {"Param": [_f(3, 4)], "Grad": [_f(3, 4, seed=1)], "Velocity": [_f(3, 4, seed=2)], "LearningRate": [np.array([0.1], np.float32)]}, {"mu": 0.9, "use_nesterov": True}),
    "adam": ("adam", {"Param": [_f(3, 4)], "Grad": [_f(3, 4, seed=1)], "LearningRate": [np.array([1e-3], np.float32)], "Moment1": [_f(3, 4, seed=2, scale=0.1)], "Moment2": [np.abs(_f(3, 4, seed=3, scale=0.1))], "Beta1Pow": [np.array([0.81], np.float32)], "Beta2Pow": [np.array([0.998], np.float32)]}, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "fused_adam": ("fused_adam", {"Param": [_f(3, 4), _f(5, seed=4)], "Grad": [_f(3, 4, seed=1), _f(5, seed=5)], "LearningRate": [np.array([1e-3], np.float32)], "Moment1": [_f(3, 4, seed=2, scale=0.1), _f(5, seed=6, scale=0.1)], "Moment2": [np.abs(_f(3, 4, seed=3, scale=0.1)), np.abs(_f(5, seed=7, scale=0.1))], "Beta1Pow": [np.array([0.9], np.float32)], "Beta2Pow": [np.array([0.999], np.float32)]}, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_training_forward_lowering_matches_reference(case):
    op_type, ins, attrs = FWD_CASES[case]
    with jax.disable_jit():
        ref = ref_registry.get_op_info(op_type).lower(RefCtx(0),
                                                      _to_jax(ins), attrs)
    got = registry.get_op_info(op_type).lower(_port_ctx(), _to_torch(ins),
                                              attrs)
    assert sorted(got) == sorted(ref)
    for slot in ref:
        assert len(got[slot]) == len(ref[slot]), slot
        for g, r in zip(got[slot], ref[slot]):
            g, r = g.numpy(), np.asarray(r)
            assert g.shape == r.shape, (slot, g.shape, r.shape)
            if r.dtype == np.bool_ or np.issubdtype(r.dtype, np.integer):
                np.testing.assert_array_equal(g, r)
            else:
                assert g.dtype == r.dtype, (slot, g.dtype, r.dtype)
                np.testing.assert_allclose(g, r, err_msg=slot, **TOL)


@pytest.mark.parametrize("op_type", sorted(
    {"greater_than", "less_than", "equal", "reduce_any", "reduce_all",
     "sgd", "momentum", "adam", "fused_adam"}))
def test_no_grad_ops_agree_with_reference(op_type):
    assert registry.get_op_info(op_type).no_grad
    assert ref_registry.get_op_info(op_type).no_grad


_SHARED_OPS = sorted(set(registry.registered_ops())
                     & set(ref_registry.registered_ops()))


@pytest.mark.parametrize("op_type", _SHARED_OPS)
def test_registry_grad_flags_match_reference(op_type):
    """Every op type both registries hold: the same ``no_grad`` flag and
    the same choice between a hand-written ``grad_maker`` and the generic
    grad op (exact, no exceptions)."""
    mine, ref = registry.get_op_info(op_type), ref_registry.get_op_info(
        op_type)
    assert mine.no_grad == ref.no_grad
    assert (mine.grad_maker is None) == (ref.grad_maker is None)


def _range_program(pkg):
    """``y = x + range(Start=w)``, ``reduce_sum``, ``append_backward``,
    with ``w`` a parameter: the ops of the training block."""
    mod = pt if pkg == "ref" else ptt
    names = ref_names if pkg == "ref" else unique_name
    main, startup = mod.framework.Program(), mod.framework.Program()
    with mod.framework.program_guard(main, startup), names.guard():
        block = main.global_block()
        x = block.create_var(name="x", shape=(4,), dtype="float32")
        w = block.create_parameter("w", shape=(1,), dtype="float32")
        r = block.create_var(name="r", shape=(4,), dtype="float32")
        y = block.create_var(name="y", shape=(4,), dtype="float32")
        loss = block.create_var(name="loss", shape=(), dtype="float32")
        block.append_op("range", inputs={"Start": [w]},
                        outputs={"Out": [r]},
                        attrs={"end": 4.0, "step": 1.0, "dtype": "float32"})
        block.append_op("elementwise_add", inputs={"X": [x], "Y": [r]},
                        outputs={"Out": [y]}, attrs={"axis": -1})
        block.append_op("reduce_sum", inputs={"X": [y]},
                        outputs={"Out": [loss]}, attrs={"reduce_all": True})
        mod.framework.append_backward(loss)
    return [op.type for op in main.global_block().ops]


def test_range_gets_no_gradient_as_in_the_reference():
    """A parameter reached only through ``range`` gets no gradient op
    (``range``, ``fill_constant`` and ``uniform_random`` are no_grad)."""
    ops = _range_program("port")
    assert ops == _range_program("ref")
    assert "range_grad" not in ops and ops.count("sum") == 0
