"""The optimizers beyond SGD, Momentum and Adam: the port against the JAX
package, on the CPU.

- the 13 optimizer op lowerings (``lars_momentum`` to
  ``average_accumulates``), and ``increment``, ``elementwise_mod`` and
  ``optimization_barrier``, against the reference's on the same numpy
  inputs: ``rmsprop`` centered and not, both ``ftrl`` ``lr_power``
  branches, LAMB with a zero parameter norm and with a zero update norm,
  ``average_accumulates`` with and without the window rolling over;
- each new optimizer class takes 3 steps of a small regression model in
  both packages from the reference's startup values: losses within 1e-6
  relative, every parameter and accumulator within 1e-5 relative;
- ExponentialMovingAverage, ModelAverage and Lookahead over Adam the same,
  and their ``apply()`` guards: inside, the scope holds the reference's
  averaged values; after, the trained ones;
- each class's program re-emitted from its graph (as a pass re-emits it)
  keeps its in-place updates after their reads: 3 steps equal to the bit;
- the card check of ``chip_smoke.py``'s optimizers phase on the host: the
  update re-run on a step's inputs gives its state, a wrong step fails.

Integer counters compare by value: the reference runs with 64-bit types
off, so its int64 counters are int32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the reference lowerings)
import paddle_tpu_torch as ptt
from paddle_tpu import layers as ref_layers
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import registry as ref_registry
from paddle_tpu.framework import scope_guard as ref_scope_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.framework.executor import LowerCtx as RefCtx
from paddle_tpu.parallel import dgc as ref_dgc
from paddle_tpu_torch import layers
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.framework.executor import LowerCtx
from _port_fixtures import collect_garbage_after_module  # noqa: F401

OP_TOL = dict(rtol=1e-6, atol=1e-7)
LOSS_TOL = dict(rtol=1e-6, atol=0)
STATE_TOL = dict(rtol=1e-5, atol=1e-7)
STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


# -- the op lowerings -----------------------------------------------------------

def _f(*shape, seed=0, pos=False):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(a) + np.float32(0.1) if pos else a


P, G = _f(4, 5), _f(4, 5, seed=1)
LR = np.array([0.05], np.float32)
POW = {"Beta1Pow": [np.array([0.9 ** 3], np.float32)],
       "Beta2Pow": [np.array([0.999 ** 3], np.float32)]}
ADAM_INS = dict({"Param": [P], "Grad": [G], "LearningRate": [LR],
                 "Moment1": [_f(4, 5, seed=2) * 0.1],
                 "Moment2": [_f(4, 5, seed=3, pos=True) * 0.01]}, **POW)
ZERO = np.zeros((4, 5), np.float32)


def _avg_ins(num, old, upd):
    i64 = (lambda v: np.array([v], np.int64))
    return {"param": [P], "in_sum_1": [_f(4, 5, seed=4)],
            "in_sum_2": [_f(4, 5, seed=5)], "in_sum_3": [_f(4, 5, seed=6)],
            "in_num_accumulates": [i64(num)],
            "in_old_num_accumulates": [i64(old)],
            "in_num_updates": [i64(upd)]}


# name -> (op type, {slot: [array]}, attrs)
CASES = {
    "lars_momentum": ("lars_momentum", {
        "Param": [P], "Grad": [G], "Velocity": [_f(4, 5, seed=2)],
        "LearningRate": [LR]},
        {"mu": 0.9, "lars_coeff": 1e-3, "lars_weight_decay": 5e-4}),
    "adamw": ("adamw", ADAM_INS, {"beta1": 0.9, "beta2": 0.999,
                                  "epsilon": 1e-8, "coeff": 0.01}),
    "adamax": ("adamax", {
        "Param": [P], "Grad": [G], "LearningRate": [LR],
        "Moment": [_f(4, 5, seed=2)], "InfNorm": [_f(4, 5, seed=3, pos=True)],
        "Beta1Pow": POW["Beta1Pow"]},
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adagrad": ("adagrad", {"Param": [P], "Grad": [G], "LearningRate": [LR],
                            "Moment": [_f(4, 5, seed=2, pos=True)]},
                {"epsilon": 1e-6}),
    "decayed_adagrad": ("decayed_adagrad", {
        "Param": [P], "Grad": [G], "LearningRate": [LR],
        "Moment": [_f(4, 5, seed=2, pos=True)]},
        {"decay": 0.95, "epsilon": 1e-6}),
    "adadelta": ("adadelta", {
        "Param": [P], "Grad": [G],
        "AvgSquaredGrad": [_f(4, 5, seed=2, pos=True)],
        "AvgSquaredUpdate": [_f(4, 5, seed=3, pos=True)]},
        {"epsilon": 1e-6, "rho": 0.95}),
    "rmsprop": ("rmsprop", {
        "Param": [P], "Grad": [G], "LearningRate": [LR],
        "MeanSquare": [_f(4, 5, seed=2, pos=True)],
        "Moment": [_f(4, 5, seed=3)], "MeanGrad": [_f(4, 5, seed=4) * 0.1]},
        {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9,
         "centered": False}),
    "rmsprop_centered": ("rmsprop", {
        "Param": [P], "Grad": [G], "LearningRate": [LR],
        "MeanSquare": [_f(4, 5, seed=2, pos=True) + 1],
        "Moment": [_f(4, 5, seed=3)], "MeanGrad": [_f(4, 5, seed=4) * 0.1]},
        {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9,
         "centered": True}),
    "ftrl_sqrt": ("ftrl", {
        "Param": [P], "Grad": [G], "LearningRate": [LR],
        "SquaredAccumulator": [_f(4, 5, seed=2, pos=True)],
        "LinearAccumulator": [_f(4, 5, seed=3)]},
        {"l1": 0.1, "l2": 0.01, "lr_power": -0.5}),
    "ftrl_power": ("ftrl", {
        "Param": [P], "Grad": [G], "LearningRate": [LR],
        "SquaredAccumulator": [_f(4, 5, seed=2, pos=True)],
        "LinearAccumulator": [_f(4, 5, seed=3)]},
        {"l1": 0.1, "l2": 0.01, "lr_power": -0.7}),
    "lamb": ("lamb", ADAM_INS, {"beta1": 0.9, "beta2": 0.999,
                                "epsilon": 1e-6, "weight_decay": 0.01}),
    "lamb_zero_param": ("lamb", dict(ADAM_INS, Param=[ZERO]),
                        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                         "weight_decay": 0.01}),
    "lamb_zero_update": ("lamb", dict(ADAM_INS, Grad=[ZERO],
                                      Moment1=[ZERO]),
                         {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                          "weight_decay": 0.0}),
    "proximal_gd": ("proximal_gd", {"Param": [P], "Grad": [G],
                                    "LearningRate": [LR]},
                    {"l1": 0.01, "l2": 0.1}),
    "proximal_adagrad": ("proximal_adagrad", {
        "Param": [P], "Grad": [G], "LearningRate": [LR],
        "Moment": [_f(4, 5, seed=2, pos=True)]}, {"l1": 0.01, "l2": 0.1}),
    "dgc_momentum": ("dgc_momentum", {
        "Param": [P], "Grad": [G], "Velocity": [_f(4, 5, seed=2)],
        "LearningRate": [LR]}, {"mu": 0.9, "use_nesterov": True}),
    "average_accumulates": ("average_accumulates", _avg_ins(3, 5, 10), {}),
    "average_accumulates_roll": ("average_accumulates", _avg_ins(3, 0, 10),
                                 {"average_window": 0.15,
                                  "min_average_window": 2,
                                  "max_average_window": 3}),
}


# the other new op types: Lookahead's counter ops and the recompute fence
MISC_CASES = {
    "increment_int32": ("increment", {"X": [np.array([6], np.int32)]},
                        {"step": 1.0}),
    "increment_float": ("increment", {"X": [P]}, {"step": -0.25}),
    "mod_int32": ("elementwise_mod", {
        "X": [np.array([-7, -1, 0, 5, 9], np.int32)],
        "Y": [np.array([3], np.int32)]}, {"axis": -1}),
    "mod_float": ("elementwise_mod", {"X": [P * 3], "Y": [_f(5, seed=1,
                                                             pos=True)]},
                  {"axis": -1}),
    "optimization_barrier": ("optimization_barrier", {"X": [P]}, {}),
}


# the reference registers ``dgc_momentum`` twice: momentum on one process
# (``ops/optimizer_ops.py:285``) and, once ``paddle_tpu.parallel.dgc`` is
# imported, the update on DGC's compressed, momentum-corrected gradient,
# which replaces it in the registry.  Only ``DGCGradAllReduce`` (in that
# module) writes the op, and the port's package imports its ``parallel.dgc``,
# so the port's op is the latter
_REF_LOWERINGS = {"dgc_momentum": ref_dgc._dgc_momentum}


def _ref_lower(op_type, ins, attrs):
    lower = _REF_LOWERINGS.get(op_type) or \
        ref_registry.get_op_info(op_type).lower
    outs = lower(
        RefCtx(0), {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        attrs)
    return {s: [np.asarray(a) for a in v] for s, v in outs.items()}


def _port_lower(op_type, ins, attrs):
    outs = registry.get_op_info(op_type).lower(
        LowerCtx(torch.device("cpu"), 0),
        {s: [torch.from_numpy(a.copy()) for a in v] for s, v in ins.items()},
        attrs)
    return {s: [t.numpy() for t in v] for s, v in outs.items()}


def test_the_new_op_types_are_registered():
    new = {"lars_momentum", "adamw", "adamax", "adagrad", "decayed_adagrad",
           "adadelta", "rmsprop", "ftrl", "lamb", "proximal_gd",
           "proximal_adagrad", "dgc_momentum", "average_accumulates",
           "optimization_barrier", "increment", "elementwise_mod",
           "truncated_gaussian_random"}
    ops = registry.registered_ops()
    # 116 and switch_ffn, then sync_batch_norm and the ops the SPMD
    # lowering emits, then the parameter server's,
    spmd = {"sync_batch_norm", "c_alltoall", "spmd_alias",
            "spmd_vocab_lookup", "spmd_vocab_softmax_ce",
            "spmd_vocab_softmax_ce_grad", "spmd_unflatten",
            "spmd_layer_norm", "spmd_softmax", "spmd_switch_ffn"}
    ps = {"send", "recv", "distributed_lookup_table", "fetch_barrier",
          "send_barrier", "listen_and_serv",
          "sigmoid_cross_entropy_with_logits"}
    # and the types the dygraph layers trace
    dygraph = {"lookup_table_v2", "conv3d", "conv2d_transpose",
               "conv3d_transpose", "group_norm", "prelu",
               "bilinear_tensor_product", "spectral_norm", "sequence_conv",
               "gru_unit", "row_conv", "nce", "tree_conv"}
    # and control flow with the seq2seq path's types
    control_flow = {
        "while", "while_grad", "conditional_block", "conditional_block_infer",
        "static_scan", "static_scan_grad", "select_input", "print",
        "array_write", "array_read", "array_length",
        "tensor_array_to_tensor", "write_to_array", "read_from_array",
        "lod_array_length", "py_func", "ifelse_merge", "drnn_iota",
        "drnn_masked_update", "beam_search", "beam_search_decode",
        "logical_and", "logical_or", "logical_xor", "logical_not",
        "is_empty", "log", "sequence_mask", "sequence_pool", "squeeze",
        "squeeze2", "unsqueeze", "transpose", "stack", "reverse",
        "fill_any_like", "fill_constant_batch_size_like"}
    assert new | spmd | ps | dygraph | control_flow | {"switch_ffn"} <= \
        set(ops) and len(ops) == 117 + len(spmd) + len(ps) + \
        len(dygraph) + len(control_flow)
    assert {c[0] for c in list(CASES.values()) + list(
        MISC_CASES.values())} == new - {"truncated_gaussian_random"}


@pytest.mark.parametrize("case", sorted(CASES) + sorted(MISC_CASES))
def test_optimizer_lowering_matches_reference(case):
    op_type, ins, attrs = CASES.get(case) or MISC_CASES[case]
    ref, got = _ref_lower(op_type, ins, attrs), _port_lower(op_type, ins, attrs)
    assert sorted(ref) == sorted(got), (sorted(ref), sorted(got))
    for slot in ref:
        for r, g in zip(ref[slot], got[slot]):
            assert r.shape == g.shape, (slot, r.shape, g.shape)
            if np.issubdtype(r.dtype, np.integer):
                np.testing.assert_array_equal(g, r, err_msg=slot)
            else:
                assert g.dtype == r.dtype, (slot, g.dtype, r.dtype)
                np.testing.assert_allclose(g, r, err_msg=slot, **OP_TOL)
    if case == "average_accumulates_roll":
        assert got["out_num_accumulates"][0][0] == 0
        np.testing.assert_array_equal(got["out_sum_1"][0], ZERO)
    if case.startswith("lamb_zero"):
        # the trust ratio falls back to 1: a plain Adam-direction step
        assert np.isfinite(got["ParamOut"][0]).all()


# -- 3 steps of each class -------------------------------------------------------

def _model(L):
    x = L.data("x", shape=[6], dtype="float32")
    y = L.data("y", shape=[1], dtype="float32")
    h = L.fc(x, size=8, act="sigmoid")
    pred = L.fc(h, size=1)
    d = pred - y
    return L.mean(d * d)


def _no_decay(p):
    return p.name.endswith("b_0")


CLASSES = {
    "LarsMomentum": lambda O: O.LarsMomentumOptimizer(0.5, 0.9),
    "AdamW": lambda O: O.AdamWOptimizer(0.02, weight_decay=0.05),
    "Adamax": lambda O: O.AdamaxOptimizer(0.02),
    "Adagrad": lambda O: O.AdagradOptimizer(0.1,
                                            initial_accumulator_value=0.1),
    "DecayedAdagrad": lambda O: O.DecayedAdagradOptimizer(0.05),
    "Adadelta": lambda O: O.AdadeltaOptimizer(1.0),
    "RMSProp": lambda O: O.RMSPropOptimizer(0.01, momentum=0.5,
                                            centered=True),
    "Ftrl": lambda O: O.FtrlOptimizer(0.1, l1=0.001, l2=0.01),
    "Lamb": lambda O: O.LambOptimizer(
        0.02, exclude_from_weight_decay_fn=_no_decay),
    "DGCMomentum": lambda O: O.DGCMomentumOptimizer(0.1, 0.9),
}


def _build(pkg, make_opt, wrap=None, after=None):
    """The model under ``make_opt(module)`` in one package, wrapped by
    ``wrap(module, optimizer)`` before ``minimize`` (Lookahead); ``after
    (module)`` makes an averaging wrapper once the program is built.
    Returns (main, startup, loss name, that wrapper)."""
    if pkg == "ref":
        main, startup = RefProgram(), RefProgram()
        guard, names, L, O = (ref_guard(main, startup), ref_names.guard(),
                              ref_layers, ref_opt)
    else:
        main, startup = core.Program(), core.Program()
        guard, names, L, O = (core.program_guard(main, startup),
                              unique_name.guard(), layers, opt)
    with guard, names:
        loss = _model(L)
        o = make_opt(O)
        (wrap(O, o) if wrap is not None else o).minimize(loss)
        extra = after(O) if after is not None else None
        if isinstance(extra, O.ExponentialMovingAverage):
            extra.update()
    return main, startup, loss.name, extra


def _feed(step):
    rng = np.random.RandomState(step)
    x = rng.randn(8, 6).astype(np.float32)
    return {"x": x, "y": np.tanh(x.sum(1, keepdims=True))}


def _run_both(make_opt, wrap=None, after=None):
    rm, rs, rl, r_extra = _build("ref", make_opt, wrap, after)
    pm, _, pl, p_extra = _build("port", make_opt, wrap, after)
    ref_scope = RefScope()
    RefExecutor().run(rs, scope=ref_scope, seed=5)
    init = {v.name: np.asarray(ref_scope.find_var(v.name))
            for v in rs.global_block().vars.values()}
    port_scope = ptt.io.params_from_numpy(scope.Scope(), init)
    exe, ref_exe = ptt.Executor(ptt.CPUPlace()), RefExecutor()
    for step in range(STEPS):
        want, = ref_exe.run(rm, feed=_feed(step), fetch_list=[rl],
                            scope=ref_scope)
        got, = exe.run(pm, feed=_feed(step), fetch_list=[pl],
                       scope=port_scope)
        np.testing.assert_allclose(float(got), float(np.asarray(want)),
                                   **LOSS_TOL)
    for n in init:
        _assert_close(port_scope.find_var(n), ref_scope.find_var(n), n)
    return ref_scope, port_scope, r_extra, p_extra, list(init)


def _assert_close(port_val, ref_val, name):
    r = np.asarray(ref_val)
    g = port_val.numpy() if isinstance(port_val, torch.Tensor) else \
        np.asarray(port_val)
    if np.issubdtype(r.dtype, np.integer):
        np.testing.assert_array_equal(g, r, err_msg=name)
    else:
        np.testing.assert_allclose(g, r, err_msg=name, **STATE_TOL)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_three_steps_match_reference(name):
    _run_both(CLASSES[name])


@pytest.mark.parametrize("name", sorted(CLASSES) + ["Lookahead"])
def test_a_re_emitted_program_keeps_in_place_updates_in_order(name):
    """A pass re-emits a program from its graph (``ir.Graph.to_program``):
    an op updating a persistable in place that no other op feeds (Adamax's
    ``scale`` of its beta1 power, Lookahead's ``increment``) stays after
    the ops reading the old value, and 3 steps equal the program's own to
    the bit."""
    from paddle_tpu_torch.framework import ir
    wrap = (lambda O, o: O.LookaheadOptimizer(o, alpha=0.5, k=2)) \
        if name == "Lookahead" else None
    main, startup, loss, _ = _build(
        "port", CLASSES.get(name, lambda O: O.AdamOptimizer(0.02)), wrap)
    re_emitted = ir.Graph(main).to_program()
    assert sorted(op.type for op in re_emitted.global_block().ops) == \
        sorted(op.type for op in main.global_block().ops)
    runs = []
    for prog in (main, re_emitted):
        exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
        exe.run(startup, scope=sc, seed=5)
        for step in range(STEPS):
            exe.run(prog, feed=_feed(step), fetch_list=[loss], scope=sc)
        runs.append({v.name: sc.find_var(v.name).clone()
                     for v in startup.global_block().vars.values()})
    for n, want in runs[0].items():
        assert torch.equal(runs[1][n], want), n


def test_the_card_check_holds_an_update_on_its_own_inputs():
    """``chip_smoke.py``'s optimizers phase re-runs the ops after the
    backward on the host from a step's starting state, fed the gradients
    that step fetched: that gives the step's state to the bit (Adamax's
    in-place power included), and its check flags a tensor stepped the
    wrong way."""
    import importlib
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        cs = importlib.import_module("chip_smoke")
    finally:
        sys.path.pop(0)
    main, startup, loss, _ = _build("port", CLASSES["Adamax"])
    upd, fed = cs._update_program(main)
    assert sorted(fed) == sorted(p.name + "@GRAD"
                                 for p in main.all_parameters())
    assert "adamax" in [op.type for op in upd.global_block().ops]
    names = [v.name for v in startup.global_block().vars.values()]
    exe, sc, want = ptt.Executor(ptt.CPUPlace()), scope.Scope(), \
        scope.Scope()
    exe.run(startup, scope=sc, seed=5)
    for step in range(2):
        for n in names:
            want.set_var(n, sc.find_var(n).clone())
        out = exe.run(main, feed=_feed(step), fetch_list=[loss] + fed,
                      scope=sc)
        exe.run(upd, feed=dict(zip(fed, out[1:])), scope=want)
        got = {n: sc.find_var(n) for n in names}
        assert cs._check_update("Adamax", got, {
            n: want.find_var(n) for n in names}) == (0.0, None)
    p = main.all_parameters()[0].name
    before = want.find_var(p) + 0.02 * torch.sign(want.find_var(p))
    with pytest.raises(AssertionError, match=p):
        cs._check_update("Adamax", {p: 2 * before - want.find_var(p)},
                         {p: want.find_var(p)})


def test_lamb_excludes_biases_from_weight_decay():
    main, _, _, _ = _build("port", CLASSES["Lamb"])
    decay = {op.input("Param")[0]: op.attrs["weight_decay"]
             for op in main.global_block().ops if op.type == "lamb"}
    assert decay == {"fc_0.w_0": 0.01, "fc_0.b_0": 0.0,
                     "fc_1.w_0": 0.01, "fc_1.b_0": 0.0}


def test_dgc_momentum_tags_its_momentum_ops():
    main, _, _, _ = _build("port", CLASSES["DGCMomentum"])
    ops = [op for op in main.global_block().ops if op.type == "momentum"]
    assert len(ops) == 4 and all(
        op.attrs["dgc"] and op.attrs["sparsity"] == 0.999 for op in ops)


# -- the wrappers ------------------------------------------------------------------

def _adam(O):
    return O.AdamOptimizer(0.02)


def _guarded(pkg, extra, sc, names):
    """The values of ``names`` inside ``extra.apply()`` and after it."""
    guard = ref_scope_guard if pkg == "ref" else scope.scope_guard
    with guard(sc):
        with extra.apply():
            inside = {n: np.array(np.asarray(sc.find_var(n)) if pkg == "ref"
                                  else sc.find_var(n).numpy())
                      for n in names}
        after = {n: sc.find_var(n) for n in names}
    return inside, after


PARAMS = ["fc_0.w_0", "fc_0.b_0", "fc_1.w_0", "fc_1.b_0"]


@pytest.mark.parametrize("kind", ["ema", "model_average"])
def test_averaging_wrappers_match_reference(kind):
    if kind == "ema":
        def after(O):
            return O.ExponentialMovingAverage(0.5)
    else:
        def after(O):
            return O.ModelAverage(0.5, min_average_window=1,
                                  max_average_window=2)
    ref_scope, port_scope, r_extra, p_extra, _ = _run_both(_adam,
                                                           after=after)
    r_in, r_after = _guarded("ref", r_extra, ref_scope, PARAMS)
    p_in, p_after = _guarded("port", p_extra, port_scope, PARAMS)
    for n in PARAMS:
        np.testing.assert_allclose(p_in[n], r_in[n], err_msg=n, **STATE_TOL)
        # restored: the trained values, not the averages
        _assert_close(p_after[n], r_after[n], n)
        assert not np.allclose(p_in[n], p_after[n].numpy())


def test_model_average_keeps_a_parameter_with_no_step():
    _, startup, _, extra = _build("port", _adam,
                                  after=lambda O: O.ModelAverage(0.5))
    sc = scope.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=sc, seed=1)
    before = {n: sc.find_var(n).clone() for n in PARAMS}
    inside, _ = _guarded("port", extra, sc, PARAMS)
    for n in PARAMS:
        np.testing.assert_array_equal(inside[n], before[n].numpy())


def test_lookahead_matches_reference():
    ref_scope, port_scope, _, _, names = _run_both(
        _adam, wrap=lambda O, o: O.LookaheadOptimizer(o, alpha=0.5, k=2))
    assert "lookahead_step" in names
    assert int(port_scope.find_var("lookahead_step")[0]) == STEPS
    for n in PARAMS:
        _assert_close(port_scope.find_var(n + "@SLOW"),
                      ref_scope.find_var(n + "@SLOW"), n + "@SLOW")
