"""``contrib.layers.basic_gru`` / ``basic_lstm`` of the port against the
JAX package: one and two layers, bidirectional, masked by
``sequence_length``, with and without initial states.  The same layer
calls build both programs (``tests/_both.py``); the outputs, the final
states and the gradients of every parameter, of the input and of the
initial states are held on the same numpy inputs.

Tolerance: 1e-5 absolute + 1e-4 relative.
"""

import numpy as np
import pytest

from _both import run_both
from _port_fixtures import collect_garbage_after_module  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
B, T, D, H = 3, 5, 4, 6

#: (num_layers, bidirectional, masked, initial states given)
CONFIGS = {"one_layer": (1, False, False, False),
           "two_layers_masked": (2, False, True, True),
           "bidirectional": (1, True, False, True),
           "two_layers_bidirectional_masked": (2, True, True, False)}


def _build(cell, num_layers, bidi, masked, with_init):
    rng = np.random.RandomState(3)
    dirs = 2 if bidi else 1
    feed = {"x": rng.randn(B, T, D).astype(np.float32),
            "sl": np.array([5, 2, 4], np.int64),
            "h0": rng.randn(num_layers * dirs, B, H).astype(np.float32),
            "c0": rng.randn(num_layers * dirs, B, H).astype(np.float32)}

    def build(pkg):
        layers = pkg.layers
        from importlib import import_module
        contrib = import_module(pkg.__name__ + ".contrib.layers")
        x = layers.data("x", shape=[T, D], dtype="float32")
        x.stop_gradient = False
        sl = layers.data("sl", shape=[], dtype="int64") if masked else None
        inits = []
        for n in ("h0", "c0"):
            v = layers.data(n, shape=[num_layers * dirs, B, H],
                            dtype="float32", append_batch_size=False)
            v.stop_gradient = False
            inits.append(v)
        h0, c0 = inits if with_init else (None, None)
        if cell == "gru":
            out, last_h = contrib.basic_gru(
                x, h0, H, num_layers=num_layers, sequence_length=sl,
                bidirectional=bidi, batch_first=True, name="g")
            finals = [last_h]
        else:
            out, last_h, last_c = contrib.basic_lstm(
                x, h0, c0, H, num_layers=num_layers, sequence_length=sl,
                bidirectional=bidi, batch_first=True, name="l")
            finals = [last_h, last_c]
        loss = layers.mean(layers.square(out))
        for f in finals:
            loss = loss + layers.reduce_sum(layers.tanh(f)) * 0.1
        pkg.append_backward(loss)
        params = sorted(p.name for p in
                        pkg.default_main_program().all_parameters())
        grads = [p + "@GRAD" for p in params] + ["x@GRAD"] + (
            [n.name + "@GRAD" for n in inits[:len(finals)]]
            if with_init else [])
        used = {k: v for k, v in feed.items()
                if k in ("x",) or (k == "sl" and masked) or
                (with_init and k in ("h0", "c0")[:len(finals)])}
        return [out] + finals + [loss] + grads, used
    return build


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_basic_rnn_matches_reference(cell, config):
    num_layers, bidi, masked, with_init = CONFIGS[config]
    got = run_both(_build(cell, num_layers, bidi, masked, with_init))
    (ref,), (port,) = got["ref"], got["port"]
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert r.shape == p.shape, (r.shape, p.shape)
        np.testing.assert_allclose(p, r, **TOL)
    out = port[0]
    dirs = 2 if bidi else 1
    assert out.shape == (B, T, H * dirs)
    assert port[1].shape == (num_layers * dirs, B, H)
    if masked:
        # a row's padded steps carry its state: its forward output past
        # its length repeats the last valid one
        np.testing.assert_allclose(out[1, 2:, :H], out[1, 1:2, :H].repeat(
            3, axis=0), rtol=1e-6)
