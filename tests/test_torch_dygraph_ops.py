"""The 13 op types the dygraph layers trace, against the JAX package's
lowerings on the CPU.

Each case's numpy inputs (from a seed) go through
``paddle_tpu.framework.registry.get_op_info(t).lower`` and the port's
lowering.  The forward outputs, and the gradients of every floating input
for a random cotangent on every floating output (``jax.vjp`` against
``torch.autograd``), agree within atol 1e-5 + rtol 1e-4 in float32.

``nce`` draws its negatives: the port reports its draws in
``SampleLabels``, and the reference's sampler is replaced, in the test, by
one that returns those samples, so both compute the loss on the same
classes.  Both packages' shape inference of each case agrees too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the reference lowerings)
import paddle_tpu_torch  # noqa: F401
from paddle_tpu.framework import core as ref_core
from paddle_tpu.framework import registry as ref_registry
from paddle_tpu.framework.executor import LowerCtx as RefCtx
from paddle_tpu.ops import structured_ops as ref_structured
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.framework.executor import LowerCtx
from _port_fixtures import collect_garbage_after_module  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)

#: the 13 op types the reference's dygraph layers trace that earlier
#: slices of the port did not register
DYGRAPH_OPS = ("lookup_table_v2", "conv3d", "conv2d_transpose",
               "group_norm", "prelu", "bilinear_tensor_product",
               "sequence_conv", "conv3d_transpose", "spectral_norm",
               "gru_unit", "row_conv", "nce", "tree_conv")


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


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


_EDGES = np.array([[[1, 2], [1, 3], [2, 4], [2, 5]],
                   [[1, 2], [2, 3], [0, 0], [0, 0]]], np.int64)

# name -> (op type, {slot: [array]}, attrs)
CASES = {
    "lookup_table_v2": ("lookup_table_v2", {"W": [_f(10, 4)], "Ids": [np.array([[1, 3, 3], [2, 9, 0]], np.int64)]}, {"padding_idx": 3}),
    "lookup_table_v2_int32": ("lookup_table_v2", {"W": [_f(6, 3)], "Ids": [np.array([[1, 2], [3, 4]], np.int32)]}, {"padding_idx": -1}),
    "conv3d": ("conv3d", {"Input": [_f(2, 3, 4, 5, 5)], "Filter": [_f(4, 3, 2, 3, 3, seed=1)]}, {"strides": [1, 2, 1], "paddings": [1, 0, 1], "dilations": [1, 1, 2], "groups": 1}),
    "conv3d_groups": ("conv3d", {"Input": [_f(1, 4, 3, 4, 4)], "Filter": [_f(6, 2, 2, 2, 2, seed=1)]}, {"strides": [1, 1, 1], "paddings": [0, 1, 1], "dilations": [1, 1, 1], "groups": 2}),
    "conv2d_transpose": ("conv2d_transpose", {"Input": [_f(2, 4, 5, 5)], "Filter": [_f(4, 3, 3, 3, seed=1)]}, {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1], "groups": 1}),
    "conv2d_transpose_groups": ("conv2d_transpose", {"Input": [_f(1, 4, 4, 3)], "Filter": [_f(4, 2, 2, 3, seed=1)]}, {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1], "groups": 2}),
    "conv3d_transpose": ("conv3d_transpose", {"Input": [_f(1, 2, 3, 3, 3)], "Filter": [_f(2, 3, 2, 2, 2, seed=1)]}, {"strides": [2, 2, 2], "paddings": [0, 0, 0], "dilations": [1, 1, 1], "groups": 1}),
    "group_norm": ("group_norm", {"X": [_f(2, 6, 3, 3) * 2 + 1], "Scale": [_f(6, seed=1)], "Bias": [_f(6, seed=2)]}, {"groups": 3, "epsilon": 1e-5}),
    "prelu_all": ("prelu", {"X": [_f(2, 3, 4)], "Alpha": [np.array([0.25], np.float32)]}, {"mode": "all"}),
    "prelu_channel": ("prelu", {"X": [_f(2, 3, 4, 4)], "Alpha": [_f(3, seed=1)]}, {"mode": "channel"}),
    "prelu_element": ("prelu", {"X": [_f(2, 3, 4)], "Alpha": [_f(3, 4, seed=1)]}, {"mode": "element"}),
    "bilinear_tensor_product": ("bilinear_tensor_product", {"X": [_f(3, 4)], "Y": [_f(3, 5, seed=1)], "Weight": [_f(2, 4, 5, seed=2)], "Bias": [_f(1, 2, seed=3)]}, {}),
    "sequence_conv": ("sequence_conv", {"X": [_f(2, 5, 3)], "Filter": [_f(9, 4, seed=1)]}, {"contextLength": 3, "contextStart": -1, "contextStride": 1}),
    "sequence_conv_ahead": ("sequence_conv", {"X": [_f(2, 4, 2)], "Filter": [_f(4, 3, seed=1)]}, {"contextLength": 2, "contextStart": 1}),
    "spectral_norm": ("spectral_norm", {"Weight": [_f(4, 3, 2)], "U": [_f(4, seed=1)], "V": [_f(6, seed=2)]}, {"dim": 0, "power_iters": 2, "eps": 1e-12}),
    "spectral_norm_dim1": ("spectral_norm", {"Weight": [_f(3, 5)], "U": [_f(5, seed=1)], "V": [_f(3, seed=2)]}, {"dim": 1, "power_iters": 1, "eps": 1e-12}),
    "gru_unit": ("gru_unit", {"Input": [_f(3, 12)], "HiddenPrev": [_f(3, 4, seed=1)], "Weight": [_f(4, 12, seed=2)], "Bias": [_f(1, 12, seed=3)]}, {"activation": 2, "gate_activation": 1}),
    "gru_unit_named": ("gru_unit", {"Input": [_f(2, 6)], "HiddenPrev": [_f(2, 2, seed=1)], "Weight": [_f(2, 6, seed=2)]}, {"activation": "relu", "gate_activation": "sigmoid"}),
    "row_conv": ("row_conv", {"X": [_f(2, 5, 3)], "Filter": [_f(3, 3, seed=1)]}, {}),
    "nce_uniform": ("nce", {"Input": [_f(4, 6)], "Label": [np.array([[1], [7], [3], [19]], np.int64)], "Weight": [_f(20, 6, seed=1)], "Bias": [_f(20, seed=2)]}, {"num_neg_samples": 5, "num_total_classes": 20, "sampler": 0}),
    "nce_log_uniform": ("nce", {"Input": [_f(3, 4)], "Label": [np.array([[2, 5], [0, 1], [9, 9]], np.int64)], "Weight": [_f(10, 4, seed=1)]}, {"num_neg_samples": 4, "num_total_classes": 10, "sampler": 1}),
    "tree_conv": ("tree_conv", {"NodesVector": [_f(2, 5, 3)], "EdgeSet": [_EDGES], "Filter": [_f(3, 3, 2, 2, seed=1)]}, {"max_depth": 2}),
}


def _floating(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _port(op_type, ins, attrs, cts=None):
    """Outputs and, given ``cts`` by output slot, the floating inputs'
    gradients of the port's lowering."""
    info = registry.get_op_info(op_type)
    leaves = {s: [torch.from_numpy(a.copy()).requires_grad_(_floating(a))
                  for a in v] for s, v in ins.items()}
    outs = info.lower(LowerCtx(torch.device("cpu"), 3), leaves, attrs)
    got = {s: [t.detach().numpy() for t in v] for s, v in outs.items()}
    if cts is None:
        return got, None
    pairs = [(outs[s][j], torch.from_numpy(c)) for s, cs in cts.items()
             for j, c in enumerate(cs)]
    wrt = [(s, j, t) for s, v in leaves.items() for j, t in enumerate(v)
           if t.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs], [t for *_, t in wrt],
                                [c for _, c in pairs], allow_unused=True)
    return got, {(s, j): (np.zeros(t.shape, np.float32) if g is None
                          else g.numpy())
                 for (s, j, t), g in zip(wrt, grads)}


def _ref(op_type, ins, attrs, cts):
    """Outputs and the floating inputs' gradients of the reference's
    lowering (``jax.vjp`` over the floating inputs)."""
    info = ref_registry.get_op_info(op_type)
    keys = [(s, j) for s, v in ins.items() for j, a in enumerate(v)
            if _floating(a)]

    def fwd(*flt):
        it = iter(flt)
        d = {s: [next(it) if _floating(a) else jnp.asarray(a) for a in v]
             for s, v in ins.items()}
        outs = info.lower(RefCtx(0), d, attrs)
        return {s: [outs[s][j] for j in range(len(cs))]
                for s, cs in cts.items()}, outs

    primals = [jnp.asarray(ins[s][j]) for s, j in keys]
    _, vjp, outs = jax.vjp(fwd, *primals, has_aux=True)
    grads = vjp({s: [jnp.asarray(c) for c in cs] for s, cs in cts.items()})
    return ({s: [np.asarray(t) for t in v] for s, v in outs.items()},
            dict(zip(keys, [np.asarray(g) for g in grads])))


@pytest.fixture
def nce_on_port_samples(monkeypatch):
    """The reference's nce sampler, replaced by one that returns the
    samples the port's op drew (set per case in ``holder``)."""
    holder = {}

    def sample(key, n, num_classes, sampler):
        ids = jnp.asarray(holder["neg"], jnp.int32)
        if sampler == "log_uniform":
            return ids, ref_structured._log_uniform_prob(ids, num_classes)
        return ids, jnp.full((n,), 1.0 / num_classes)
    monkeypatch.setattr(ref_structured, "_sample_classes", sample)
    return holder


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_and_grads_match_reference(case, nce_on_port_samples):
    op_type, ins, attrs = CASES[case]
    got, _ = _port(op_type, ins, attrs)
    if op_type == "nce":
        nce_on_port_samples["neg"] = \
            got["SampleLabels"][0][0, ins["Label"][0].shape[1]:]
    rng = np.random.RandomState(7)
    cts = {s: [rng.randn(*a.shape).astype(np.float32) for a in v]
           for s, v in got.items() if all(_floating(a) for a in v)}
    got, gports = _port(op_type, ins, attrs, cts)
    ref, grefs = _ref(op_type, ins, attrs, cts)
    assert sorted(got) == sorted(ref)
    for slot in ref:
        for r, g in zip(ref[slot], got[slot]):
            assert r.shape == g.shape, (slot, r.shape, g.shape)
            if _floating(r):
                np.testing.assert_allclose(g, r, err_msg=slot, **TOL)
            else:
                np.testing.assert_array_equal(g, r, err_msg=slot)
    assert sorted(gports) == sorted(grefs)
    for key, r in grefs.items():
        np.testing.assert_allclose(gports[key], r, err_msg=str(key), **TOL)


def test_the_thirteen_are_registered():
    assert set(DYGRAPH_OPS) <= set(registry.registered_ops())
    assert set(DYGRAPH_OPS) == {c[0] for c in CASES.values()}


def _infer(core_mod, op_type, ins, attrs):
    prog = core_mod.Program()
    block = prog.global_block()
    inputs = {s: [block.create_var(name=f"{s}_{i}", shape=list(a.shape),
                                   dtype=a.dtype.name).name
                  for i, a in enumerate(v)] for s, v in ins.items()}
    got, _ = _port(op_type, ins, attrs)
    outputs = {s: [block.create_var(name=f"{s}_out_{j}").name
                   for j in range(len(v))] for s, v in got.items()}
    block.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs)
    return {n: block.var(n).shape for ns in outputs.values() for n in ns}


@pytest.mark.parametrize("case", sorted(CASES))
def test_infer_shape_matches_reference(case):
    op_type, ins, attrs = CASES[case]
    assert _infer(core, op_type, ins, attrs) == \
        _infer(ref_core, op_type, ins, attrs)
