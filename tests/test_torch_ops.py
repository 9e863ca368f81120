"""Each op lowering of the serving slice against the JAX package's.

The same numpy inputs and attrs go through
``paddle_tpu.framework.registry.get_op_info(t).lower`` (jax on the CPU) and
through the port's lowering (torch on the CPU).  Tolerance: rtol 1e-5,
atol 1e-6 in float32 (exact for the shape-only ops).  Integer outputs
compare by value: the reference narrows int64 to int32, the port keeps
int64.  Shape inference is held the same way: both packages append the op
to a block and infer its outputs' shapes (``-1`` batch dims included).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the reference lowerings)
import paddle_tpu_torch  # noqa: F401
from paddle_tpu.framework import core as ref_core
from paddle_tpu.framework import registry as ref_registry
from paddle_tpu.framework.executor import LowerCtx as RefCtx
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.framework.executor import LowerCtx
from _port_fixtures import collect_garbage_after_module  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


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


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# name -> (op type, {slot: [array]}, attrs)
CASES = {
    "add_same": ("elementwise_add", {"X": [_f(2, 3, 4)], "Y": [_f(2, 3, 4, seed=1)]}, {"axis": -1}),
    "add_trailing": ("elementwise_add", {"X": [_f(2, 3, 4)], "Y": [_f(3, 4, seed=1)]}, {"axis": -1}),
    "add_axis1": ("elementwise_add", {"X": [_f(2, 3, 4)], "Y": [_f(3, seed=1)]}, {"axis": 1}),
    "add_axis0_bias": ("elementwise_add", {"X": [_f(2, 3, 4)], "Y": [_f(2, 3, seed=1)]}, {"axis": 0}),
    "add_mask_4d": ("elementwise_add", {"X": [_f(2, 2, 5, 5)], "Y": [_f(5, 5, seed=1)]}, {"axis": -1}),
    "sub_trailing": ("elementwise_sub", {"X": [_f(4, 4)], "Y": [_f(4, seed=1)]}, {"axis": -1}),
    "sub_axis0": ("elementwise_sub", {"X": [_f(3, 4)], "Y": [_f(3, seed=1)]}, {"axis": 0}),
    "emul_trailing": ("elementwise_mul", {"X": [_f(2, 3, 4)], "Y": [_f(4, seed=1)]}, {"axis": -1}),
    "ediv_axis1": ("elementwise_div", {"X": [_f(2, 3, 4)], "Y": [_f(3, seed=1) + 3]}, {"axis": 1}),
    "epow_scalar": ("elementwise_pow", {"X": [np.abs(_f(3, 4)) + 0.5], "Y": [np.array(1.5, np.float32)]}, {"axis": -1}),
    "mul_ncd2": ("mul", {"X": [_f(2, 3, 4)], "Y": [_f(4, 5, seed=1)]}, {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "mul_ncd1": ("mul", {"X": [_f(2, 3, 4)], "Y": [_f(12, 5, seed=1)]}, {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    "matmul_ty_alpha": ("matmul", {"X": [_f(2, 2, 3, 4)], "Y": [_f(2, 2, 5, 4, seed=1)]}, {"transpose_X": False, "transpose_Y": True, "alpha": 0.5}),
    "matmul_plain": ("matmul", {"X": [_f(2, 3, 4)], "Y": [_f(2, 4, 5, seed=1)]}, {"transpose_X": False, "transpose_Y": False, "alpha": 1.0}),
    "matmul_tx": ("matmul", {"X": [_f(4, 3)], "Y": [_f(4, 5, seed=1)]}, {"transpose_X": True, "transpose_Y": False, "alpha": 2.0}),
    "gelu_erf": ("gelu", {"X": [_f(3, 7) * 3]}, {}),
    "gelu_tanh": ("gelu", {"X": [_f(3, 7) * 3]}, {"approximate": True}),
    "relu": ("relu", {"X": [np.array([[-1.0, 0.0, 2.5]], np.float32)]}, {}),
    "tanh": ("tanh", {"X": [_f(3, 7) * 3]}, {}),
    "square_error_cost": ("square_error_cost", {"X": [_f(4, 1)], "Y": [_f(4, 1, seed=1)]}, {}),
    "sign": ("sign", {"X": [np.array([[-3.0, 0.0, 0.5, -0.0]], np.float32)]}, {}),
    "layer_norm_last": ("layer_norm", {"X": [_f(2, 3, 8) * 2 + 1], "Scale": [_f(8, seed=1)], "Bias": [_f(8, seed=2)]}, {"epsilon": 1e-5, "begin_norm_axis": 2}),
    "layer_norm_two_dims": ("layer_norm", {"X": [_f(2, 3, 8)], "Scale": [_f(24, seed=1)], "Bias": [_f(24, seed=2)]}, {"epsilon": 1e-3, "begin_norm_axis": 1}),
    "layer_norm_no_affine": ("layer_norm", {"X": [_f(4, 6)]}, {"epsilon": 1e-5, "begin_norm_axis": 1}),
    "softmax_last": ("softmax", {"X": [_f(2, 3, 5) * 4]}, {"axis": -1}),
    "softmax_axis1": ("softmax", {"X": [_f(2, 3, 5)]}, {"axis": 1}),
    "scale_after": ("scale", {"X": [_f(3, 4)]}, {"scale": -1e9, "bias": 0.0, "bias_after_scale": True}),
    "scale_before": ("scale", {"X": [_f(3, 4)]}, {"scale": 2.0, "bias": 0.5, "bias_after_scale": False}),
    "fill_constant": ("fill_constant", {}, {"shape": [2, 3], "dtype": "float32", "value": 1.5}),
    "fill_constant_int64": ("fill_constant", {}, {"shape": [4], "dtype": "int64", "value": 7.0}),
    "fill_constant_shape_tensor": ("fill_constant", {"ShapeTensor": [np.array([5], np.int32)]}, {"shape": [], "dtype": "float32", "value": -2.0}),
    "split_num": ("split", {"X": [_f(2, 3, 6)]}, {"num": 3, "axis": 2, "sections": []}),
    "split_sections": ("split", {"X": [_f(2, 3, 6)]}, {"num": 0, "axis": 1, "sections": [1, 2]}),
    "reshape_zero_neg1": ("reshape2", {"X": [_f(2, 3, 4)]}, {"shape": [0, -1]}),
    "reshape_heads": ("reshape2", {"X": [_f(2, 3, 8)]}, {"shape": [0, 0, 2, 4]}),
    "reshape_merge": ("reshape2", {"X": [_f(2, 3, 2, 4)]}, {"shape": [0, 0, 8]}),
    "reshape_shape_tensor": ("reshape2", {"X": [_f(2, 3, 4)], "ShapeTensor": [np.array([24], np.int32)]}, {"shape": [0, 0]}),
    "unsqueeze": ("unsqueeze2", {"X": [_f(3, 4)]}, {"axes": [0, 2]}),
    "transpose": ("transpose2", {"X": [_f(2, 3, 4, 5)]}, {"axis": [0, 2, 1, 3]}),
    "lookup_pad": ("lookup_table", {"W": [_f(10, 4)], "Ids": [np.array([[1, 3, 3, 9, 0], [2, 3, 5, 7, 8]], np.int64)]}, {"padding_idx": 3}),
    "lookup_out_of_range": ("lookup_table", {"W": [_f(10, 4)], "Ids": [np.array([[1, 12, -1, 3, -11, 10, -10]], np.int64)]}, {"padding_idx": 3}),
    "lookup_squeeze": ("lookup_table", {"W": [_f(10, 4)], "Ids": [np.array([[[1], [4]], [[0], [9]]], np.int64)]}, {"padding_idx": -1}),
    "range_int": ("range", {}, {"dtype": "float32", "start": 0, "end": 7, "step": 1}),
    "range_frac": ("range", {}, {"dtype": "float32", "start": 1, "end": 10, "step": 2.5}),
    "range_end_tensor": ("range", {"End": [np.array([5.0], np.float32)]}, {"dtype": "float32", "start": 0, "step": 1}),
    "expand_rows": ("expand", {"X": [_f(1, 3)]}, {"expand_times": [2, 1]}),
    "expand_cols": ("expand", {"X": [_f(3, 1)]}, {"expand_times": [1, 4]}),
    "slice_neg": ("slice", {"Input": [_f(5, 6, 2)]}, {"axes": [0, 1], "starts": [-3, 1], "ends": [-1, 100]}),
    "slice_pos_table": ("slice", {"Input": [_f(16, 4)]}, {"axes": [0], "starts": [0], "ends": [8]}),
    "slice_decrease": ("slice", {"Input": [_f(4, 5)]}, {"axes": [0], "starts": [2], "ends": [3], "decrease_axis": [0]}),
    "flash_causal": ("flash_attention", {"Q": [_f(1, 2, 8, 8)], "K": [_f(1, 2, 8, 8, seed=1)], "V": [_f(1, 2, 8, 8, seed=2)]}, {"causal": True, "sm_scale": 0.35, "block_q": 0, "block_k": 0}),
    "flash_bias": ("flash_attention", {"Q": [_f(2, 2, 6, 8)], "K": [_f(2, 2, 6, 8, seed=1)], "V": [_f(2, 2, 6, 8, seed=2)], "Bias": [_f(1, 1, 6, 6, seed=3)]}, {"causal": False, "sm_scale": 0.0, "block_q": 0, "block_k": 0}),
}


def _ref_lower(op_type, ins, attrs):
    info = ref_registry.get_op_info(op_type)
    outs = info.lower(RefCtx(0), {s: [jnp.asarray(a) for a in v]
                                  for s, v in ins.items()}, attrs)
    return {s: [np.asarray(a) for a in v] for s, v in outs.items()}


def _port_lower(op_type, ins, attrs):
    info = registry.get_op_info(op_type)
    ctx = LowerCtx(torch.device("cpu"), 0)
    outs = info.lower(ctx, {s: [torch.from_numpy(a.copy()) for a in v]
                            for s, v in ins.items()}, attrs)
    return {s: [t.numpy() for t in v] for s, v in outs.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowering_matches_reference(case):
    op_type, ins, attrs = CASES[case]
    ref, got = _ref_lower(op_type, ins, attrs), _port_lower(op_type, ins, attrs)
    assert sorted(ref) == sorted(got), (sorted(ref), sorted(got))
    for slot in ref:
        assert len(ref[slot]) == len(got[slot]), slot
        for r, g in zip(ref[slot], got[slot]):
            assert r.shape == g.shape, (slot, r.shape, g.shape)
            if slot == "XShape":
                continue
            if np.issubdtype(r.dtype, np.integer):
                np.testing.assert_array_equal(g, r)
            else:
                assert g.dtype == r.dtype, (slot, g.dtype, r.dtype)
                np.testing.assert_allclose(g, r, **TOL)


def _infer_shapes(core_mod, op_type, ins, attrs, batch_symbolic):
    prog = core_mod.Program()
    block = prog.global_block()
    inputs = {}
    for slot, arrs in ins.items():
        names = []
        for i, a in enumerate(arrs):
            shape = list(a.shape)
            if batch_symbolic and shape and slot in ("X", "Input", "Q", "K",
                                                     "V"):
                shape[0] = -1
            v = block.create_var(name=f"{slot}_{i}", shape=shape,
                                 dtype=a.dtype.name)
            names.append(v.name)
        inputs[slot] = names
    n_out = attrs.get("num") or len(attrs.get("sections", [])) or 1
    slots = {"layer_norm": ("Y", "Mean", "Variance"),
             "reshape2": ("Out", "XShape"), "transpose2": ("Out", "XShape"),
             "unsqueeze2": ("Out", "XShape")}.get(op_type, ("Out",))
    outputs = {s: [block.create_var(name=f"{s}_out_{j}").name
                   for j in range(n_out if op_type == "split" else 1)]
               for s in slots}
    block.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs)
    return {n: block.var(n).shape for ns in outputs.values() for n in ns}


@pytest.mark.parametrize("batch_symbolic", [False, True],
                         ids=["static", "batch-1"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_infer_shape_matches_reference(case, batch_symbolic):
    op_type, ins, attrs = CASES[case]
    ref = _infer_shapes(ref_core, op_type, ins, attrs, batch_symbolic)
    got = _infer_shapes(core, op_type, ins, attrs, batch_symbolic)
    assert got == ref


def test_uniform_random_range_and_shape():
    """Random draws cannot match the reference bit for bit: check shape,
    dtype, range, and that one seed repeats while another differs."""
    attrs = {"shape": [64, 32], "dtype": "float32", "min": -0.25,
             "max": 0.75, "seed": 0}
    info = registry.get_op_info("uniform_random")

    def draw(seed):
        return info.lower(LowerCtx(torch.device("cpu"), seed), {},
                          attrs)["Out"][0]
    a, b, c = draw(3), draw(3), draw(4)
    assert a.shape == (64, 32) and a.dtype == torch.float32
    assert float(a.min()) >= -0.25 and float(a.max()) < 0.75
    assert abs(float(a.mean()) - 0.25) < 0.03
    assert torch.equal(a, b) and not torch.equal(a, c)
    ref = _ref_lower("uniform_random", {}, attrs)["Out"][0]
    assert ref.shape == tuple(a.shape) and ref.dtype == np.float32


def test_common_helpers_match_reference():
    from paddle_tpu.ops import common as ref_common
    from paddle_tpu_torch.ops import common
    assert common.static_int(torch.tensor(7), "k") == \
        ref_common.static_int(np.array(7), "k") == 7
    assert common.static_int(None, "k", 3) == \
        ref_common.static_int(None, "k", 3) == 3
    with pytest.raises(TypeError):      # no value during shape inference
        common.static_int(torch.empty(1, device="meta"), "k")
    a, b = np.ones(2, np.float32), np.zeros(3, np.float32)
    got = common.XS({"X": [None, torch.from_numpy(a), torch.from_numpy(b)]},
                    "X")
    ref = ref_common.XS({"X": [None, jnp.asarray(a), jnp.asarray(b)]}, "X")
    assert [tuple(t.shape) for t in got] == [r.shape for r in ref]
    assert common.XS({}, "X") == ref_common.XS({}, "X") == []


def test_dp_layers_build_like_the_reference():
    """``tanh``, ``elementwise_sub`` and ``square_error_cost`` (the layers of
    the reference's data-parallel test programs) build the same serialized
    program in both packages, and the port's forward runs it."""
    import json

    import paddle_tpu as pt
    import paddle_tpu_torch as ptt
    from paddle_tpu.framework import unique_name as ref_names

    def build(pkg, names):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), names.guard():
            x = pkg.layers.data("x", shape=[4], dtype="float32")
            y = pkg.layers.data("y", shape=[4], dtype="float32")
            h = pkg.layers.tanh(pkg.layers.elementwise_sub(x, y))
            loss = pkg.layers.mean(pkg.layers.square_error_cost(h, y))
        return main, startup, loss

    ref_main, _, ref_loss = build(pt, ref_names)
    main, startup, loss = build(ptt, unique_name)
    assert json.loads(main.serialize_to_string()) == \
        json.loads(ref_main.serialize_to_string())
    xv, yv = _f(3, 4), _f(3, 4, seed=1)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup)
    got, = exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss])
    ref_exe = pt.Executor()
    ref_exe.run(pt.default_startup_program())
    want, = ref_exe.run(ref_main, feed={"x": xv, "y": yv},
                        fetch_list=[ref_loss])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
