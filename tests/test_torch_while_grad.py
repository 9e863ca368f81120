"""The bounded While's gradient in the port against the JAX package: the
eight cases of ``tests/test_while_grad.py`` (the closed form, numeric
parity by central differences, the unbounded loop staying forward-only,
two consumers of the loop's output, two loops carrying one var, a
condition guarding a domain, extra trips changing nothing, and the
warning of a truncated loop), each built by the same layer calls in both
packages on the same inputs (``tests/_both.py``), with the reference
test's own checks kept on the port's values.  Then a StaticRNN whose body
draws random bits (a dropout, tagged or not, and ``uniform_random``): its
gradient's replay of the body draws what the forward drew, and a body op
that autograd cannot differentiate raises.

Tolerance: losses and gradients within 1e-5 absolute + 1e-4 relative.
"""

import numpy as np
import pytest

from _both import run_both
from _port_fixtures import collect_garbage_after_module  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def _same(got):
    for r_step, p_step in zip(got["ref"], got["port"]):
        for r, p in zip(r_step, p_step):
            assert r.shape == p.shape, (r.shape, p.shape)
            np.testing.assert_allclose(p, r, **TOL)
    return got["port"]


def _geometric_loop(pkg, max_trips):
    """acc = x; repeat 3 times: acc = acc * w; loss = mean(acc):
    d loss/d x = w^3 / n, d loss/d w = 3 w^2 mean(x)."""
    layers = pkg.layers
    x = layers.data("x", shape=[4], dtype="float32")
    x.stop_gradient = False
    w = layers.create_parameter([1], "float32", name="w_scale")
    i = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    limit = layers.fill_constant(shape=[1], dtype="float32", value=3.0)
    acc = layers.elementwise_mul(x, layers.ones_like(x))
    cond = layers.less_than(i, limit)
    wh = layers.While(cond, max_trip_count=max_trips)
    with wh.block():
        layers.assign(layers.elementwise_mul(acc, w), acc)
        layers.increment(i, 1.0)
        layers.less_than(i, limit, cond=cond)
    return x, w, layers.mean(acc)


def _with_w(w_val, build):
    """A builder whose startup sets ``w_scale`` to ``w_val``."""
    def wrapped(pkg):
        fetch, feed = build(pkg)
        sb = pkg.default_startup_program().global_block()
        for op in sb.ops:
            if "w_scale" in op.output_arg_names():
                op.type, op.inputs = "fill_constant", {}
                op.attrs = {"shape": [1], "dtype": "float32",
                            "value": float(w_val)}
        return fetch, feed
    return wrapped


def test_while_grad_matches_closed_form():
    xv = np.array([[0.5, -1.0, 2.0, 3.0]], np.float32)

    def build(pkg):
        x, w, loss = _geometric_loop(pkg, max_trips=5)
        pkg.append_backward(loss)
        return [loss, "x@GRAD", "w_scale@GRAD"], {"x": xv}
    (lv, gx, gw), = _same(run_both(_with_w(1.5, build)))
    wv = 1.5
    np.testing.assert_allclose(lv, (xv * wv ** 3).mean(), rtol=1e-5)
    np.testing.assert_allclose(gx, np.full_like(xv, wv ** 3 / xv.size),
                               rtol=1e-5)
    np.testing.assert_allclose(gw, [3 * wv ** 2 * xv.mean()], rtol=1e-5)


def test_while_grad_numeric_parity():
    """Central differences on the loop's parameter gradient."""
    xv = np.array([[1.0, 2.0, -0.5, 0.25]], np.float32)

    def run(w_val, want_grads):
        def build(pkg):
            x, w, loss = _geometric_loop(pkg, max_trips=4)
            if want_grads:
                pkg.append_backward(loss)
            return [loss] + (["w_scale@GRAD"] if want_grads else []), \
                {"x": xv}
        return _same(run_both(_with_w(w_val, build)))[0]

    eps = 1e-2
    (l_plus,), (l_minus,) = run(1.2 + eps, False), run(1.2 - eps, False)
    numeric = (float(l_plus) - float(l_minus)) / (2 * eps)
    _, gw = run(1.2, True)
    np.testing.assert_allclose(float(gw[0]), numeric, rtol=1e-3)


def test_while_unbounded_stays_forward_only():
    """No max_trip_count: no grad op is made for the loop."""
    made = {}

    def build(pkg):
        layers = pkg.layers
        x = layers.data("x", shape=[4], dtype="float32")
        i = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        limit = layers.fill_constant(shape=[1], dtype="float32", value=3.0)
        acc = layers.elementwise_mul(x, layers.ones_like(x))
        cond = layers.less_than(i, limit)
        wh = layers.While(cond)
        with wh.block():
            layers.assign(acc * 2.0, acc)
            layers.increment(i, 1.0)
            layers.less_than(i, limit, cond=cond)
        loss = layers.mean(acc)
        pkg.append_backward(loss)
        made[pkg.__name__] = [op.type for op in pkg.default_main_program()
                              .global_block().ops]
        return [loss], {"x": np.ones((2, 4), np.float32)}
    (lv,), = _same(run_both(build))
    np.testing.assert_allclose(lv, 8.0, rtol=1e-5)
    assert made["paddle_tpu_torch"] == made["paddle_tpu"]
    assert "while_grad" not in made["paddle_tpu_torch"]


def test_while_grad_multi_consumer():
    """The loop's output feeds two consumers: their contributions sum
    before while_grad replays the loop."""
    xv = np.array([[0.5, -1.0, 2.0, 3.0]], np.float32)

    def build(pkg):
        layers = pkg.layers
        x = layers.data("x", shape=[4], dtype="float32")
        x.stop_gradient = False
        w = layers.create_parameter([1], "float32", name="w_scale")
        i = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        limit = layers.fill_constant(shape=[1], dtype="float32", value=3.0)
        acc = layers.elementwise_mul(x, layers.ones_like(x))
        cond = layers.less_than(i, limit)
        wh = layers.While(cond, max_trip_count=5)
        with wh.block():
            layers.assign(layers.elementwise_mul(acc, w), acc)
            layers.increment(i, 1.0)
            layers.less_than(i, limit, cond=cond)
        loss = layers.mean(acc) + layers.mean(acc * 2.0)
        pkg.append_backward(loss)
        return ["x@GRAD", "w_scale@GRAD"], {"x": xv}
    (gx, gw), = _same(run_both(_with_w(1.5, build)))
    wv = 1.5
    np.testing.assert_allclose(gx, np.full_like(xv, 3 * wv ** 3 / xv.size),
                               rtol=1e-5)
    np.testing.assert_allclose(gw, [3 * 3 * wv ** 2 * xv.mean()], rtol=1e-5)


def test_two_sequential_while_loops_grad():
    """Two bounded loops carrying the same var, each replayed from its own
    snapshot: acc = x -> x^2 -> x^4, d mean(x^4)/dx = 4 x^3 / n."""
    xv = np.array([[2.0, 3.0]], np.float32)

    def build(pkg):
        layers = pkg.layers
        x = layers.data("x", shape=[2], dtype="float32")
        x.stop_gradient = False
        acc = layers.elementwise_mul(x, layers.ones_like(x))
        for _ in range(2):
            i = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
            lim = layers.fill_constant(shape=[1], dtype="float32",
                                       value=1.0)
            cond = layers.less_than(i, lim)
            wh = layers.While(cond, max_trip_count=2)
            with wh.block():
                layers.assign(layers.elementwise_mul(acc, acc), acc)
                layers.increment(i, 1.0)
                layers.less_than(i, lim, cond=cond)
        loss = layers.mean(acc)
        pkg.append_backward(loss)
        return [loss, "x@GRAD"], {"x": xv}
    (lv, gx), = _same(run_both(build))
    np.testing.assert_allclose(lv, (xv ** 4).mean(), rtol=1e-5)
    np.testing.assert_allclose(gx, 4 * xv ** 3 / xv.size, rtol=1e-5)


def test_while_grad_domain_guard_no_nan():
    """The condition guards a domain (sqrt(limit - i)): a dead iteration
    never runs the body on the frozen state, so the grads stay finite."""
    xv = np.array([[1.0, 2.0]], np.float32)

    def build(pkg):
        layers = pkg.layers
        x = layers.data("x", shape=[2], dtype="float32")
        x.stop_gradient = False
        acc = layers.elementwise_mul(x, layers.ones_like(x))
        i = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        lim = layers.fill_constant(shape=[1], dtype="float32", value=3.0)
        cond = layers.less_than(i, lim)
        wh = layers.While(cond, max_trip_count=6)
        with wh.block():
            gap = layers.sqrt(lim - i)
            layers.assign(acc * gap, acc)
            layers.increment(i, 1.0)
            layers.less_than(i, lim, cond=cond)
        loss = layers.mean(acc)
        pkg.append_backward(loss)
        return [loss, "x@GRAD"], {"x": xv}
    (lv, gx), = _same(run_both(build))
    expect = np.sqrt(3.0) * np.sqrt(2.0) * np.sqrt(1.0)
    np.testing.assert_allclose(lv, (xv * expect).mean(), rtol=1e-5)
    assert np.isfinite(gx).all()
    np.testing.assert_allclose(gx, np.full_like(xv, expect / xv.size),
                               rtol=1e-5)


def test_while_bounded_early_exit_masking():
    """A max_trip_count above the trips taken changes nothing."""
    for trips in (3, 8, 16):
        def build(pkg):
            x, w, loss = _geometric_loop(pkg, max_trips=trips)
            return [loss], {"x": np.ones((1, 4), np.float32)}
        (lv,), = _same(run_both(_with_w(2.0, build)))
        np.testing.assert_allclose(lv, 8.0, rtol=1e-5,
                                   err_msg=f"trips={trips}")


def test_bounded_while_truncation_warns(capfd):
    """An under-sized max_trip_count: the result is the truncated one in
    both packages, and each says the loop was truncated."""
    said = {}

    def build(pkg):
        layers = pkg.layers
        i = layers.fill_constant(shape=[1], dtype="float32", value=0)
        limit = layers.fill_constant(shape=[1], dtype="float32", value=10)
        cond = layers.less_than(i, limit)
        w = layers.While(cond, max_trip_count=3)
        with w.block():
            layers.assign(i + 1.0, i)
            layers.less_than(i, limit, cond=cond)
        return [i], {}

    def capture(tag):
        out = capfd.readouterr()
        said[tag] = out.out + out.err
    (out,), = _same(run_both(build, between=capture))
    assert float(out[0]) == 3.0
    assert "truncated" in said["ref"] and "truncated" in said["port"]


# -- a StaticRNN whose body holds a dropout ----------------------------------
# The gradient replays the body under torch.autograd: the dropout's lowering
# must stay differentiable there (on the card its kernel runs inside an
# autograd Function) and the replay must draw the forward's masks.

def _dropout_rnn(p, cell, seed=None):
    """x [T 4, batch 3, 5] time-major through a StaticRNN whose step is
    ``cell(layers, x_t, h_prev) -> h`` then ``dropout(h, p, seed=seed)``
    (upscale in train), the dropped value its memory and its output; loss
    the mean."""
    def build(pkg):
        layers = pkg.layers
        x = layers.data("x", shape=[4, 3, 5], dtype="float32",
                        append_batch_size=False)
        x.stop_gradient = False
        # the reference makes its base key at the run's first draw; made
        # first inside the scan's trace it leaks a tracer, so a dropout
        # that keeps everything draws first, outside the loop
        x_in = layers.dropout(x, 0.0,
                              dropout_implementation="upscale_in_train")
        rnn = layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x_in)
            h_prev = rnn.memory(shape=[-1, 5], batch_ref=x_t)
            d = layers.dropout(cell(layers, x_t, h_prev), p, seed=seed,
                               dropout_implementation="upscale_in_train")
            rnn.update_memory(h_prev, d)
            rnn.step_output(d)
        out = rnn()
        loss = layers.mean(out)
        pkg.append_backward(loss)
        xv = np.random.RandomState(7).randn(4, 3, 5).astype(np.float32)
        return [loss, out, "x@GRAD"], {"x": xv}
    return build


def _tanh_fc_cell(layers, x_t, h_prev):
    return layers.fc(layers.concat([x_t, h_prev], axis=1), size=5,
                     act="tanh", param_attr="rnn_fc_w", bias_attr="rnn_fc_b")


def test_static_rnn_dropout_in_its_body_matches_the_reference():
    """With p 0 the masks keep everything in both packages, so the loss,
    the outputs and the gradients of x and of the cell's weight agree."""
    build = _dropout_rnn(0.0, _tanh_fc_cell)

    def with_w(pkg):
        fetch, feed = build(pkg)
        return fetch + ["rnn_fc_w@GRAD", "rnn_fc_b@GRAD"], feed
    (loss, out, gx, gw, gb), = _same(run_both(with_w))
    assert np.abs(gx).min() > 0 and np.abs(gw).max() > 0 and gb.any()


@pytest.mark.parametrize("seed", [None, 0], ids=["tagged", "untagged"])
def test_static_rnn_dropout_grad_replays_the_forwards_masks(seed):
    """With p 0.5 each package's x@GRAD is the forward's mask times the
    scale 2 of upscale_in_train, times 2, over the count: the gradient's
    replay of the body drew the masks its forward drew (the packages'
    random streams differ, so each is held to its own forward).  A tagged
    dropout draws from its tag's stream; an untagged one (``seed=0``)
    from the run's counter, which the port's replay rewinds to the
    forward's.  The reference's untagged replay draws other masks than its
    forward, so there only the port is held."""
    got = run_both(_dropout_rnn(
        0.5, lambda layers, x_t, h_prev: layers.elementwise_add(
            layers.scale(x_t, 2.0), layers.scale(h_prev, 0.0)), seed))
    for tag in ("ref", "port") if seed is None else ("port",):
        (loss, out, gx), = got[tag]
        kept = out != 0
        assert 0.2 < kept.mean() < 0.8, (tag, kept.mean())
        np.testing.assert_allclose(gx, kept * 4.0 / out.size, rtol=1e-6,
                                   err_msg=tag)


def test_port_body_op_without_a_gradient_raises(monkeypatch):
    """A body op whose lowering gives floating outputs with no gradient
    (a kernel launched outside autograd) makes the loop's gradient raise,
    naming the op, where it would give zeros quietly."""
    import pytest
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.framework import registry
    info = registry.get_op_info("tanh")
    lower = info.lower
    monkeypatch.setattr(info, "lower", lambda *a: {
        k: [v.detach() for v in vs] for k, vs in lower(*a).items()})
    build = _dropout_rnn(0.0, lambda layers, x_t, h_prev: layers.tanh(
        layers.elementwise_add(x_t, h_prev)))
    main, startup, scope = ptt.Program(), ptt.Program(), framework.Scope()
    with framework.unique_name.guard(), ptt.program_guard(main, startup):
        fetch, feed = build(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    with pytest.raises(RuntimeError, match="op 'tanh': autograd cannot"):
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def test_port_static_rnn_grad_replays_the_generators_draws():
    """A body that draws from the run's generator (``uniform_random``):
    x@GRAD is the forward's noise over the count, so the replay drew what
    the forward drew (the generator rewinds to the loop's start)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.layer_helper import LayerHelper

    def noise(layers, x_t, h_prev):
        helper = LayerHelper("uniform_random")
        u = helper.create_variable_for_type_inference("float32")
        helper.append_op("uniform_random", outputs={"Out": [u]},
                         attrs={"shape": [3, 5], "dtype": "float32",
                                "min": 0.5, "max": 1.5})
        return layers.elementwise_add(layers.elementwise_mul(x_t, u),
                                      layers.scale(h_prev, 0.0))
    main, startup, scope = ptt.Program(), ptt.Program(), framework.Scope()
    with framework.unique_name.guard(), ptt.program_guard(main, startup):
        fetch, feed = _dropout_rnn(0.0, noise)(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    loss, out, gx = (np.asarray(v) for v in exe.run(
        main, feed=feed, fetch_list=fetch, scope=scope))
    u = out / feed["x"]
    assert 0.5 <= u.min() and u.max() < 1.5 and np.ptp(u) > 0.1
    np.testing.assert_allclose(gx, u / out.size, rtol=1e-5)
