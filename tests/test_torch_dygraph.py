"""Dygraph mode of the port against the JAX package's, on the CPU.

Every case of ``tests/test_dygraph.py`` runs in both packages
(``paddle_tpu.dygraph`` on jax's CPU, ``paddle_tpu_torch.dygraph`` under
``guard(CPUPlace())``), a layer's random weights carried from the reference
to the port by ``set_dict``, and the values, gradients and updated
weights agree within atol 1e-5 + rtol 1e-4.  Beside them:

- the ops with a hand-written grad maker (``dropout`` with its mask,
  ``batch_norm``, ``softmax_with_cross_entropy``) under the tape, against
  the reference's ``jax.vjp`` (both dropouts draw the same bytes,
  ``patch_same_bits``);
- ``.grad`` adding up over two ``backward()`` calls, and
  ``retain_graph``, as the reference's tape does both;
- the seven LR decays stepped through ``SGDOptimizer``;
- ``.pdparams`` / ``.pdopt`` written by either package and read by the
  other; the optimizer's ``parameter_list``; the tape's refusals;
- ``guard()`` defaulting to the card (it raises without one).

The tape on the card is held by ``tests/test_torch_dygraph_cuda.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import dygraph as rdy
from paddle_tpu_torch import dygraph as pdy
from paddle_tpu_torch.framework import registry
from _port_fixtures import (collect_garbage_after_module,  # noqa: F401
                            fresh_port_programs, patch_same_bits)

pytestmark = pytest.mark.usefixtures("fresh_port_programs")

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = ptt.CPUPlace()


def _both(fn):
    """``fn(pkg, dy)`` under each package's guard: (reference, port)."""
    with rdy.guard():
        ref = fn(pt, rdy)
    with pdy.guard(CPU):
        got = fn(ptt, pdy)
    return ref, got


def _close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               err_msg=msg, **TOL)


def _state(layer):
    return {k: v.numpy() for k, v in layer.state_dict().items()}


def _mean(dy, x):
    return dy.default_tracer().trace_op("mean", {"X": [x]}, {})["Out"][0]


# -- the cases of tests/test_dygraph.py ------------------------------------

def test_to_variable_and_numpy():
    a = np.arange(6, dtype="float32").reshape(2, 3)
    ref, got = _both(lambda pkg, dy: dy.to_variable(a))
    assert got.shape == ref.shape == (2, 3)
    assert got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    # float64 narrows to float32, as the reference's jnp.asarray does
    ref64, got64 = _both(lambda pkg, dy: dy.to_variable(
        a.astype(np.float64)))
    assert got64.dtype == str(ref64.dtype) == "float32"


def test_eager_arithmetic_backward():
    def run(pkg, dy):
        x = dy.to_variable(np.array([2.0, 3.0], "float32"))
        y = dy.to_variable(np.array([4.0, 5.0], "float32"))
        z = x * y + x
        loss = z * z
        out = dy.default_tracer().trace_op(
            "reduce_sum", {"X": [loss]},
            {"dim": None, "keep_dim": False})["Out"][0]
        out.backward()
        return x.gradient(), y.gradient(), z.gradient(), loss.gradient()
    ref, got = _both(run)
    for r, g in zip(ref, got):
        _close(g, r)


def _carried(fn):
    """``fn(pkg, dy, state)`` in the reference (state None), then in the
    port with the reference's returned layer's state."""
    with rdy.guard():
        layer, ref = fn(pt, rdy, None)
        state = _state(layer)
    with pdy.guard(CPU):
        _, got = fn(ptt, pdy, state)
    return ref, got


def test_fc_layer_forward_backward():
    def run(pkg, dy, state):
        fc = dy.nn.FC("fc", size=4)
        x = dy.to_variable(np.random.RandomState(1).rand(3, 5)
                           .astype("float32"))
        with dy.no_grad():
            fc(x)               # builds the weight
        if state is not None:
            fc.set_dict(state)
        y = fc(x)
        _mean(dy, y * y).backward()
        return fc, (y.numpy(), fc.weight.gradient(), fc.bias.gradient())
    ref, got = _carried(run)
    assert got[1].shape == (5, 4)
    for r, g in zip(ref, got):
        _close(g, r)


def test_conv_bn_pool_stack():
    x = np.random.RandomState(0).randn(2, 3, 8, 8).astype("float32")

    def run(pkg, dy, state):
        class Stack(dy.Layer):
            def __init__(self):
                super().__init__("stack")
                self.conv = dy.nn.Conv2D("c", num_channels=3, num_filters=8,
                                         filter_size=3, padding=1)
                self.bn = dy.nn.BatchNorm("bn", num_channels=8)
                self.pool = dy.nn.Pool2D("p", pool_size=2, pool_stride=2,
                                         pool_type="max")

            def forward(self, v):
                return self.pool(self.bn(self.conv(v)))
        net = Stack()
        if state is not None:
            net.set_dict(state)
        state = _state(net)
        out = net(dy.to_variable(x))
        _mean(dy, out).backward()
        return net, (out.numpy(), net.bn._mean.numpy(),
                     net.bn._variance.numpy(), net.conv.weight.gradient(),
                     net.bn.weight.gradient(), net.bn.bias.gradient())
    with rdy.guard():
        layer, ref = run(pt, rdy, None)
    with pdy.guard(CPU):
        # the reference's weights as they were before its step
        fresh = {k: v for k, v in _state(layer).items()
                 if not k.startswith("bn._")}
        fresh.update({"bn._mean": np.zeros(8, "float32"),
                      "bn._variance": np.ones(8, "float32")})
        _, got = run(ptt, pdy, fresh)
    assert got[0].shape == (2, 8, 4, 4)
    assert not np.allclose(got[1], 0.0)     # running stats updated
    for r, g in zip(ref, got):
        _close(g, r)


def test_embedding_and_layernorm():
    def run(pkg, dy, state):
        emb = dy.nn.Embedding("e", size=[10, 6])
        ln = dy.nn.LayerNorm("ln", normalized_shape=[6], begin_norm_axis=2)
        if state is not None:
            emb.set_dict(state)
        out = ln(emb(dy.to_variable(np.array([[1, 2], [3, 4]], "int32"))))
        _mean(dy, out * out).backward()
        return emb, (out.numpy(), emb.weight.gradient(),
                     ln.weight.gradient(), ln.bias.gradient())
    ref, got = _carried(run)
    assert got[0].shape == (2, 2, 6)
    np.testing.assert_allclose(got[0].mean(-1), 0.0, atol=1e-5)
    for r, g in zip(ref, got):
        _close(g, r)


def test_no_grad():
    def run(pkg, dy):
        x = dy.to_variable(np.ones((2, 2), "float32"))
        with dy.no_grad():
            y = x * x

        @dy.no_grad
        def square(v):
            return v * v
        z = square(x)
        w = x * x
        return (y.stop_gradient, z.stop_gradient, w.stop_gradient,
                len(dy.default_tracer().tape))
    ref, got = _both(run)
    assert got == ref == (True, True, False, 1)


def _line(pkg, dy, state, opt_of, steps, list_in_minimize):
    rng = np.random.RandomState(0)
    xs = rng.randn(64, 1).astype("float32")
    ys = 2.0 * xs + 0.5
    fc = dy.nn.Linear(1, 1)
    if state is not None:
        fc.set_dict(state)
    opt = opt_of(pkg, fc)
    losses = []
    for _ in range(steps):
        d = fc(dy.to_variable(xs)) - dy.to_variable(ys)
        loss = _mean(dy, d * d)
        loss.backward()
        if list_in_minimize:
            opt.minimize(loss, parameter_list=fc.parameters())
        else:
            opt.minimize(loss)
        fc.clear_gradients()
        losses.append(float(loss.numpy()))
    return fc, opt, losses


def _line_both(opt_of, steps, list_in_minimize=False):
    """``steps`` of ``opt_of(pkg, layer)`` fitting y = 2x + 0.5 from the
    same weights in both packages: the losses and weights agree."""
    with rdy.guard():
        state = _state(rdy.nn.Linear(1, 1))
        rfc, ropt, ref = _line(pt, rdy, state, opt_of, steps,
                               list_in_minimize)
    with pdy.guard(CPU):
        pdy.nn.Linear(1, 1)     # the names the reference's first one took
        pfc, popt, got = _line(ptt, pdy, state, opt_of, steps,
                               list_in_minimize)
    _close(got, ref)
    _close(pfc.weight.numpy(), rfc.weight.numpy())
    _close(pfc.bias.numpy(), rfc.bias.numpy())
    return (rfc, ropt, ref), (pfc, popt, got)


def test_sgd_training_loop_converges():
    _, (fc, _, losses) = _line_both(
        lambda pkg, fc: pkg.optimizer.SGDOptimizer(
            learning_rate=0.1, parameter_list=fc.parameters()),
        50, list_in_minimize=True)
    assert losses[-1] < 0.01, losses[-5:]
    np.testing.assert_allclose(fc.weight.numpy().ravel(), [2.0], atol=0.2)


def test_adam_dygraph_step():
    (_, ropt, _), (_, popt, _) = _line_both(
        lambda pkg, fc: pkg.optimizer.AdamOptimizer(
            learning_rate=0.01, parameter_list=fc.parameters()), 3)
    assert "moment1" in popt._accumulators
    assert sorted(popt._accumulators) == sorted(ropt._accumulators)
    for name, accs in ropt._accumulators.items():
        assert sorted(a.name for a in popt._accumulators[name].values()) \
            == sorted(a.name for a in accs.values())
        for k, a in accs.items():
            _close(popt._accumulators[name][k].numpy(), a.numpy(), name)


def test_state_dict_save_load(tmp_path):
    """A layer's ``.pdparams`` written by either package loads into the
    other's layer by ``set_dict``, bit for bit."""
    with rdy.guard():
        r1 = rdy.nn.Linear(3, 2)
        rdy.save_dygraph(r1.state_dict(), str(tmp_path / "ref"))
    with pdy.guard(CPU):
        p1 = pdy.nn.Linear(3, 2)
        pdy.save_dygraph(p1.state_dict(), str(tmp_path / "port"))
        params, opt = pdy.load_dygraph(str(tmp_path / "ref"))
        assert opt is None
        p2 = pdy.nn.Linear(3, 2).set_dict(params)
        np.testing.assert_array_equal(p2.weight.numpy(), r1.weight.numpy())
        np.testing.assert_array_equal(p2.bias.numpy(), r1.bias.numpy())
    with rdy.guard():
        params, _ = rdy.load_dygraph(str(tmp_path / "port"))
        r2 = rdy.nn.Linear(3, 2)
        r2.set_dict(params)
        np.testing.assert_array_equal(r2.weight.numpy(), p1.weight.numpy())
        np.testing.assert_array_equal(r2.bias.numpy(), p1.bias.numpy())


def test_optimizer_state_pdopt_across_packages(tmp_path):
    """An optimizer state (arrays and a step count) saves as ``.pdopt`` in
    either package and loads in the other, equal."""
    state = {"moment1": np.arange(6, dtype="float32").reshape(2, 3),
             "step": 7}
    with pdy.guard(CPU):
        pdy.save_dygraph(dict(state, moment2=pdy.to_variable(
            np.ones(3, "float32"))), str(tmp_path / "port"))
    params, opt = rdy.load_dygraph(str(tmp_path / "port"))
    assert params is None and opt["step"] == 7
    np.testing.assert_array_equal(opt["moment1"], state["moment1"])
    np.testing.assert_array_equal(opt["moment2"], np.ones(3, "float32"))
    rdy.save_dygraph(state, str(tmp_path / "ref"))
    params, opt = pdy.load_dygraph(str(tmp_path / "ref"))
    assert params is None and opt["step"] == 7
    np.testing.assert_array_equal(opt["moment1"], state["moment1"])
    with pytest.raises(ValueError):
        pdy.load_dygraph(str(tmp_path / "missing"))


def test_parameters_traversal_nested():
    def run(pkg, dy):
        class Net(dy.Layer):
            def __init__(self):
                super().__init__("net")
                self.fc1 = dy.nn.Linear(4, 4)
                self.fc2 = dy.nn.Linear(4, 2)

            def forward(self, x):
                return self.fc2(self.fc1(x))
        net = Net()
        return ([p.name for p in net.parameters()],
                [n for n, _ in net.named_parameters()],
                list(net.state_dict()),
                [n for n, _ in net.named_sublayers()], net.full_name(),
                net.fc1.full_name())
    ref, got = _both(run)
    assert got == ref
    assert len(got[0]) == 4 and got[1][0].startswith("fc1.")


def test_dygraph_lr_scheduler():
    (_, ropt, _), (_, popt, _) = _line_both(
        lambda pkg, fc: pkg.optimizer.AdamOptimizer(
            learning_rate=pkg.dygraph.NoamDecay(d_model=512,
                                                warmup_steps=10),
            parameter_list=fc.parameters()), 3)
    assert popt._learning_rate.step_num == ropt._learning_rate.step_num > 1


def test_data_parallel_single_process():
    def run(pkg, dy, state):
        fc = dy.nn.Linear(3, 2)
        if state is not None:
            fc.set_dict(state)
        dp = dy.DataParallel(fc)
        out = dp(dy.to_variable(np.ones((2, 3), "float32")))
        loss = dp.scale_loss(_mean(dy, out))
        loss.backward()
        dp.apply_collective_grads()   # no-op at nranks=1
        return fc, (fc.weight.gradient(), fc.bias.gradient(),
                    dp.parameters()[0].name == fc.weight.name)
    ref, got = _carried(run)
    assert got[2] and ref[2]
    for r, g in zip(ref[:2], got[:2]):
        _close(g, r)


# -- the grad-maker ops under the tape ---------------------------------------

#: state a layer holds without gradient (BatchNorm's running statistics;
#: the grad op, as the static one, gives them none)
_STATE_SLOTS = ("Mean", "Variance")


def _op_grads(pkg, dy, op_type, ins, attrs, out_slot):
    """``mean(out * out)`` of one traced op: its outputs and the
    gradients of its floating inputs."""
    vs = {s: [dy.to_variable(a) for a in v] for s, v in ins.items()}
    for s in _STATE_SLOTS:
        for v in vs.get(s, []):
            v.stop_gradient = True
    outs = dy.default_tracer().trace_op(op_type, vs, attrs)
    o = outs[out_slot][0]
    _mean(dy, o * o).backward()
    return ({s: [v.numpy() for v in vv] for s, vv in outs.items()},
            {s: [v.gradient() for v in vv] for s, vv in vs.items()
             if np.issubdtype(ins[s][0].dtype, np.floating)
             and s not in _STATE_SLOTS})


_R = np.random.RandomState(3)
GRAD_MAKER_CASES = {
    "dropout_upscale": ("dropout", {"X": [_R.randn(4, 16).astype("f4")]},
                        {"dropout_prob": 0.3,
                         "dropout_implementation": "upscale_in_train"},
                        "Out"),
    "dropout_downgrade": ("dropout", {"X": [_R.randn(3, 5).astype("f4")]},
                          {"dropout_prob": 0.5}, "Out"),
    "dropout_is_test": ("dropout", {"X": [_R.randn(3, 5).astype("f4")]},
                        {"dropout_prob": 0.5, "is_test": True}, "Out"),
    "dropout_is_test_upscale": ("dropout",
                                {"X": [_R.randn(3, 5).astype("f4")]},
                                {"dropout_prob": 0.5, "is_test": True,
                                 "dropout_implementation":
                                 "upscale_in_train"}, "Out"),
    "batch_norm": ("batch_norm", {
        "X": [_R.randn(4, 3, 2, 2).astype("f4") * 2 + 1],
        "Scale": [_R.rand(3).astype("f4") + 0.5],
        "Bias": [_R.randn(3).astype("f4")],
        "Mean": [np.zeros(3, "f4")], "Variance": [np.ones(3, "f4")]},
        {"momentum": 0.9, "epsilon": 1e-5}, "Y"),
    "batch_norm_test": ("batch_norm", {
        "X": [_R.randn(4, 3, 2, 2).astype("f4")],
        "Scale": [_R.rand(3).astype("f4") + 0.5],
        "Bias": [_R.randn(3).astype("f4")],
        "Mean": [_R.randn(3).astype("f4")],
        "Variance": [_R.rand(3).astype("f4") + 0.5]},
        {"is_test": True}, "Y"),
    "softmax_with_cross_entropy": ("softmax_with_cross_entropy", {
        "Logits": [_R.randn(5, 7).astype("f4")],
        "Label": [np.array([[1], [0], [6], [3], [3]], np.int64)]},
        {}, "Loss"),
}


@pytest.mark.parametrize("case", sorted(GRAD_MAKER_CASES))
def test_grad_maker_ops_under_the_tape(case, monkeypatch):
    patch_same_bits(monkeypatch)
    op_type, ins, attrs, out_slot = GRAD_MAKER_CASES[case]
    assert registry.get_op_info(op_type).grad_maker is not None
    ref, got = _both(lambda pkg, dy: _op_grads(pkg, dy, op_type, ins,
                                               attrs, out_slot))
    for slot in ref[0]:
        if slot in got[0]:
            for r, g in zip(ref[0][slot], got[0][slot]):
                _close(g, r, slot)
    assert ref[1].keys() == got[1].keys()
    for slot in ref[1]:
        for r, g in zip(ref[1][slot], got[1][slot]):
            if r is None:
                assert g is None, slot
            else:
                _close(g, r, slot)
    if op_type == "dropout" and not attrs.get("is_test"):
        mask = got[0]["Mask"][0].astype(bool)
        assert 0 < mask.mean() < 1


# -- accumulation and retain_graph ---------------------------------------------

def test_grads_add_up_over_two_backwards():
    def run(pkg, dy):
        w = dy.to_variable(np.array([1.5, -2.0], "float32"))
        out = []
        for k in (1.0, 3.0):
            y = w * w * k
            _mean(dy, y).backward()
            out.append(w.gradient())
        return out
    ref, got = _both(run)
    for r, g in zip(ref, got):
        _close(g, r)
    _close(got[1], got[0] * 4)      # 2w/2 + 3 * 2w/2


def test_retain_graph():
    """The tape survives ``backward(retain_graph=True)``; a second sweep
    adds into every ``.grad`` on its path, intermediates included, as the
    reference's does; without it the tape is cleared."""
    def run(pkg, dy):
        x = dy.to_variable(np.array([1.0, 2.0, 3.0], "float32"))
        h = x * x
        loss = _mean(dy, h * x)
        loss.backward(retain_graph=True)
        first = (x.gradient(), len(dy.default_tracer().tape))
        loss.backward()
        return first, x.gradient(), h.gradient(), \
            len(dy.default_tracer().tape)
    ref, got = _both(run)
    _close(got[0][0], ref[0][0])
    assert got[0][1] == ref[0][1] == 3
    _close(got[1], ref[1])
    _close(got[2], ref[2])
    assert got[3] == ref[3] == 0


def test_indexing_and_sugar():
    def run(pkg, dy):
        x = dy.to_variable(np.arange(1, 7, dtype="float32").reshape(2, 3))
        y = (2.0 - x[1:, ::2]) / (x[:1, 1:] + 1.0) ** 2.0 * -x[0:1, 1:]
        _mean(dy, y).backward()
        return y.numpy(), x.gradient()
    ref, got = _both(run)
    for r, g in zip(ref, got):
        _close(g, r)


# -- the LR decays -----------------------------------------------------------

DECAYS = {
    "piecewise": lambda d: d.PiecewiseDecay([2, 4], [0.1, 0.05, 0.01]),
    "natural_exp": lambda d: d.NaturalExpDecay(0.1, 2, 0.5, staircase=True),
    "exponential": lambda d: d.ExponentialDecay(0.1, 3, 0.7),
    "inverse_time": lambda d: d.InverseTimeDecay(0.1, 2, 0.5),
    "polynomial": lambda d: d.PolynomialDecay(0.1, 4, 0.01, power=2.0,
                                              cycle=True),
    "cosine": lambda d: d.CosineDecay(0.1, 2, 3),
    "noam": lambda d: d.NoamDecay(8, 3),
}


@pytest.mark.parametrize("decay", sorted(DECAYS))
def test_lr_decays_through_an_optimizer(decay):
    (_, ropt, _), (_, popt, _) = _line_both(
        lambda pkg, fc: pkg.optimizer.SGDOptimizer(
            learning_rate=DECAYS[decay](pkg.dygraph),
            parameter_list=fc.parameters()), 6)
    assert popt._learning_rate.step_num == ropt._learning_rate.step_num
    assert popt._learning_rate.step() == pytest.approx(
        ropt._learning_rate.step(), rel=1e-12)


# -- the optimizer's parameter_list, refusals, the device --------------------

def test_constructor_parameter_list():
    with pdy.guard(CPU):
        fc = pdy.nn.Linear(2, 2)
        opt = ptt.optimizer.MomentumOptimizer(0.1, 0.9,
                                              parameter_list=fc.parameters())
        before = fc.weight.numpy().copy()
        loss = _mean(pdy, fc(pdy.to_variable(np.ones((3, 2), "float32"))))
        opt.minimize(loss)          # runs loss.backward() itself
        assert fc.weight.gradient() is not None
        assert not np.allclose(before, fc.weight.numpy())
        assert set(opt._accumulators["velocity"]) == \
            {p.name for p in fc.parameters()}
        with pytest.raises(ValueError, match="parameter_list"):
            ptt.optimizer.SGDOptimizer(0.1).minimize(loss)


def test_tape_refusals():
    def detached(ctx, ins, attrs):
        return {"Out": [ins["X"][0].detach() * 2]}
    registry.register_op("test_detached_out", detached)
    try:
        with pdy.guard(CPU):
            x = pdy.to_variable(np.ones(3, "float32"))
            with pytest.raises(NotImplementedError,
                               match="test_detached_out"):
                pdy.default_tracer().trace_op("test_detached_out",
                                              {"X": [x]})
            # without a gradient to take, it runs
            with pdy.no_grad():
                y = pdy.default_tracer().trace_op(
                    "test_detached_out", {"X": [x]})["Out"][0]
            np.testing.assert_array_equal(y.numpy(), [2.0, 2.0, 2.0])
            with pytest.raises(NotImplementedError, match="no registered"):
                pdy.default_tracer().trace_op("no_such_op", {"X": [x]})
    finally:
        registry._REGISTRY.pop("test_detached_out")


def test_a_grad_op_that_ignores_an_output_refuses_its_gradient():
    """``softmax_with_cross_entropy``'s grad op reads the gradient of
    ``Loss`` alone: a gradient that reaches its ``Softmax`` raises, where
    ignoring it would give a wrong gradient quietly."""
    with pdy.guard(CPU):
        logits = pdy.to_variable(np.random.RandomState(0).randn(4, 3)
                                 .astype("float32"))
        outs = pdy.default_tracer().trace_op(
            "softmax_with_cross_entropy",
            {"Logits": [logits],
             "Label": [np.array([[1], [0], [2], [2]], np.int64)]}, {})
        with pytest.raises(NotImplementedError, match="'Softmax'"):
            _mean(pdy, outs["Softmax"][0]).backward()


def test_integer_inputs_get_no_grad():
    def run(pkg, dy):
        w = dy.to_variable(np.random.RandomState(0).rand(5, 3)
                           .astype("float32"))
        ids = dy.to_variable(np.array([[0], [3], [3]], np.int64))
        out = dy.default_tracer().trace_op(
            "lookup_table_v2", {"W": [w], "Ids": [ids]}, {})["Out"][0]
        _mean(dy, out * out).backward()
        return w.gradient(), ids.gradient()
    ref, got = _both(run)
    _close(got[0], ref[0])
    assert got[1] is None and ref[1] is None


def test_guard_places_tensors():
    with pdy.guard(CPU):
        assert pdy.enabled()
        with pdy.guard(CPU):
            pdy.to_variable(np.ones(2, "float32")) * 2.0
        assert len(pdy.default_tracer().tape) == 1   # the inner kept it
        fc = pdy.nn.Linear(2, 2)
        assert fc.weight.device == torch.device("cpu")
    assert not pdy.enabled()
    assert pdy.default_tracer().tape == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPUPlace"):
            with pdy.guard():
                pass
        with pytest.raises(RuntimeError, match="CPUPlace"):
            pdy.to_variable(np.ones(2, "float32"))

