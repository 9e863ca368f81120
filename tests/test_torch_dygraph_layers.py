"""The 20 ``dygraph.nn`` layers of the port against the JAX package's, on
the CPU.

Each layer is built with the same arguments in both packages; one forward
without the tape builds a lazy layer's weights (``FC``, ``SequenceConv``,
``RowConv``), the reference's weights and buffers go into the port's by
``set_dict``, and one forward and ``backward()`` of ``mean(out * out)``
(summed over a layer's outputs) runs in each.  The outputs, every
parameter's gradient, every input's gradient and the buffers after the
step (``BatchNorm``'s running statistics, ``SpectralNorm``'s vectors)
agree within atol 1e-5 + rtol 1e-4.  ``NCE`` draws its negatives from a
numpy ``RandomState`` in both; both dropouts draw the same bytes
(``patch_same_bits``, which only a layer without an initializer can take:
the reference's initializers draw from the patched streams too).
"""

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu import dygraph as rdy
from paddle_tpu_torch import dygraph as pdy
from _port_fixtures import (collect_garbage_after_module,  # noqa: F401
                            fresh_port_programs, patch_same_bits)

pytestmark = pytest.mark.usefixtures("fresh_port_programs")

TOL = dict(rtol=1e-4, atol=1e-5)


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


_EDGES = np.array([[[1, 2], [1, 3], [2, 4], [2, 5]],
                   [[1, 2], [2, 3], [0, 0], [0, 0]]], np.int64)

# name -> (build(nn), [inputs])
LAYERS = {
    "Conv2D": (lambda nn: nn.Conv2D("c", num_channels=3, num_filters=4, filter_size=3, stride=2, padding=1, act="relu"), [_f(2, 3, 7, 7)]),
    "Conv3D": (lambda nn: nn.Conv3D("c3", num_channels=2, num_filters=3, filter_size=2, padding=1), [_f(1, 2, 3, 4, 4)]),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose("ct", num_channels=3, num_filters=4, filter_size=3, stride=2, padding=1, act="tanh"), [_f(2, 3, 4, 4)]),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose("ct3", num_channels=2, num_filters=2, filter_size=2, stride=2), [_f(1, 2, 2, 3, 3)]),
    "Pool2D": (lambda nn: nn.Pool2D("p", pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1), [_f(2, 3, 7, 7)]),
    "FC": (lambda nn: nn.FC("fc", size=5, num_flatten_dims=2, act="sigmoid"), [_f(2, 3, 4)]),
    "Linear": (lambda nn: nn.Linear(6, 3, act="relu"), [_f(4, 6)]),
    "BatchNorm": (lambda nn: nn.BatchNorm("bn", num_channels=3, act="relu"), [_f(4, 3, 5, 5) * 2 + 1]),
    "Embedding": (lambda nn: nn.Embedding("e", size=[10, 4], padding_idx=2), [np.array([[1, 2], [9, 2], [0, 5]], np.int64)]),
    "LayerNorm": (lambda nn: nn.LayerNorm("ln", begin_norm_axis=1, act="relu"), [_f(3, 2, 4)]),
    "GroupNorm": (lambda nn: nn.GroupNorm("gn", channels=6, groups=3), [_f(2, 6, 3, 3)]),
    "GRUUnit": (lambda nn: nn.GRUUnit("gru", size=12), [_f(3, 12), _f(3, 4, seed=1)]),
    "PRelu": (lambda nn: nn.PRelu("pr", mode="channel", channel=3), [_f(2, 3, 4, 4)]),
    "BilinearTensorProduct": (lambda nn: nn.BilinearTensorProduct("btp", size=3, x_dim=4, y_dim=5, act="tanh"), [_f(2, 4), _f(2, 5, seed=1)]),
    "SpectralNorm": (lambda nn: nn.SpectralNorm("sn", weight_shape=[4, 3, 2], dim=1, power_iters=2), [_f(4, 3, 2)]),
    "NCE": (lambda nn: nn.NCE("nce", num_total_classes=12, dim=5, num_neg_samples=4, seed=3), [_f(3, 5), np.array([[1], [7], [11]], np.int64)]),
    "SequenceConv": (lambda nn: nn.SequenceConv("sc", num_filters=4, filter_size=3, act="relu"), [_f(2, 5, 3)]),
    "RowConv": (lambda nn: nn.RowConv("rc", future_context_size=2), [_f(2, 5, 3)]),
    "TreeConv": (lambda nn: nn.TreeConv("tc", output_size=2, num_filters=2, feature_size=3), [_f(2, 5, 3), _EDGES]),
    "Dropout": (lambda nn: nn.Dropout(0.4), [_f(4, 8)]),
}


def _run(dy, build, inputs, state):
    layer = build(dy.nn)
    vs = [dy.to_variable(a) for a in inputs]
    with dy.no_grad():
        layer(*vs)              # builds a lazy layer's weights
    if state is not None:
        layer.set_dict(state)
    before = {k: v.numpy() for k, v in layer.state_dict().items()}
    out = layer(*vs)
    outs = list(out) if isinstance(out, tuple) else [out]
    t = dy.default_tracer()
    loss = None
    for o in outs:
        m = t.trace_op("mean", {"X": [o * o]}, {})["Out"][0]
        loss = m if loss is None else loss + m
    loss.backward()
    return (before, [o.numpy() for o in outs],
            {n: p.gradient() for n, p in layer.named_parameters()},
            [v.gradient() for v in vs],
            {k: v.numpy() for k, v in layer.state_dict().items()})


def test_all_twenty_layers_are_here():
    assert len(LAYERS) == 20
    for name in LAYERS:
        assert hasattr(pdy, name) and hasattr(pdy.nn, name)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_reference(name, monkeypatch):
    build, inputs = LAYERS[name]
    with rdy.guard():
        if name == "Dropout":       # after the initializers' draws
            patch_same_bits(monkeypatch)
        rbefore, rout, rgrads, rin, rafter = _run(rdy, build, inputs, None)
    with pdy.guard(ptt.CPUPlace()):
        pbefore, pout, pgrads, pin, pafter = _run(pdy, build, inputs,
                                                  rbefore)
    assert sorted(pbefore) == sorted(rbefore)
    for r, g in zip(rout, pout):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, **TOL)
    assert sorted(pgrads) == sorted(rgrads)
    for n, r in rgrads.items():
        np.testing.assert_allclose(pgrads[n], r, err_msg=n, **TOL)
    for i, (r, g) in enumerate(zip(rin, pin)):
        if r is None:
            assert g is None, i
        else:
            np.testing.assert_allclose(g, r, err_msg=f"input {i}", **TOL)
    for k, r in rafter.items():
        np.testing.assert_allclose(pafter[k], r, err_msg=k, **TOL)


def test_train_and_eval_modes():
    """``BatchNorm`` and ``Dropout`` follow ``Layer.training``: in eval
    mode BN normalizes by its running statistics and leaves them, and
    dropout passes its input through (``upscale_in_train``)."""
    x = _f(4, 3, 2, 2) * 3 + 2
    with pdy.guard(ptt.CPUPlace()):
        class Net(pdy.Layer):
            def __init__(self):
                super().__init__("net")
                self.bn = pdy.BatchNorm("bn", num_channels=3)
                self.drop = pdy.Dropout(0.5)

            def forward(self, v):
                return self.drop(self.bn(v))
        net = Net()
        net(pdy.to_variable(x))
        mean = net.bn._mean.numpy().copy()
        assert not np.allclose(mean, 0)
        net.eval()
        assert not net.bn.training and not net.drop.training
        y = net(pdy.to_variable(x)).numpy()
        np.testing.assert_array_equal(net.bn._mean.numpy(), mean)
        var = net.bn._variance.numpy()
        want = (x - mean.reshape(1, 3, 1, 1)) / np.sqrt(
            var.reshape(1, 3, 1, 1) + 1e-5)
        np.testing.assert_allclose(y, want, **TOL)
        net.train()
        assert net.bn.training and net.drop.training
