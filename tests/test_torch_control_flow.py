"""Control flow of the port against the JAX package: the nine cases of
``tests/test_control_flow.py`` (tensor arrays, While, Switch, IfElse,
StaticRNN forward and training, DynamicRNN's masking, Print and
``py_func`` with its backward), each built by the same layer calls in
both packages and run on the same numpy inputs, the port's scope taking
the reference's startup values (``tests/_both.py``).  Each case also
keeps the reference test's own checks on the port's values.

Tolerance: 1e-6 absolute on every fetch, exact for integers and booleans.
"""

import numpy as np
import pytest

from _both import run_both
from _port_fixtures import collect_garbage_after_module  # noqa: F401

ATOL = 1e-6


def _same(got):
    """Every fetch of every step equal across the packages, within ATOL."""
    ref, port = got["ref"], got["port"]
    assert len(ref) == len(port)
    for r_step, p_step in zip(ref, port):
        for r, p in zip(r_step, p_step):
            assert r.shape == p.shape, (r.shape, p.shape)
            if r.dtype.kind in "biu":
                np.testing.assert_array_equal(p, r)
            else:
                np.testing.assert_allclose(p, r, rtol=0, atol=ATOL)
    return port


def _array_write_read_length(pkg):
    layers = pkg.layers
    x = layers.data("x", shape=[3], dtype="float32")
    arr = layers.create_array("float32", max_len=8)
    i0 = layers.fill_constant([1], "int64", 0)
    i1 = layers.fill_constant([1], "int64", 1)
    layers.array_write(x, i0, arr)
    two = layers.scale(x, scale=2.0)
    layers.array_write(two, i1, arr)
    r0 = layers.array_read(arr, i0)
    r1 = layers.array_read(arr, i1)
    ln = layers.array_length(arr)
    return [r0, r1, ln], {"x": np.random.RandomState(0).rand(2, 3)
                          .astype(np.float32)}


def test_array_write_read_length():
    (g0, g1, gl), = _same(run_both(_array_write_read_length))
    xv = np.random.RandomState(0).rand(2, 3).astype(np.float32)
    np.testing.assert_allclose(g0, xv)
    np.testing.assert_allclose(g1, 2 * xv)
    assert int(gl) == 2


def _while_accumulation(pkg):
    layers = pkg.layers
    i = layers.fill_constant([1], "int64", 0)
    limit = layers.fill_constant([1], "int64", 5)
    acc = layers.fill_constant([1], "float32", 0.0)
    cond = layers.less_than(i, limit)
    w = layers.While(cond)
    with w.block():
        acc2 = layers.elementwise_add(
            acc, layers.fill_constant([1], "float32", 1.0))
        layers.assign(acc2, acc)
        layers.increment(i, value=1, in_place=True)
        layers.less_than(i, limit, cond=cond)
    return [acc, i], {}


def test_while_with_array_accumulation():
    (acc, i), = _same(run_both(_while_accumulation))
    assert float(acc.ravel()[0]) == 5.0 and int(i.ravel()[0]) == 5


def _switch_lr(pkg):
    layers = pkg.layers
    step = layers.fill_constant([1], "float32", 7.0)
    lr = layers.create_global_var(shape=[1], value=0.0, dtype="float32",
                                  persistable=True, name="lr_sw")
    b1 = layers.fill_constant([1], "float32", 5.0)
    b2 = layers.fill_constant([1], "float32", 10.0)
    sw = layers.Switch()
    with sw.case(layers.less_than(step, b1)):
        layers.assign(layers.fill_constant([1], "float32", 1.0), lr)
    with sw.case(layers.less_than(step, b2)):
        layers.assign(layers.fill_constant([1], "float32", 0.5), lr)
    with sw.default():
        layers.assign(layers.fill_constant([1], "float32", 0.1), lr)
    return [lr], {}


def test_switch_lr_pattern():
    (lr,), = _same(run_both(_switch_lr))
    assert float(lr.ravel()[0]) == 0.5


def _ifelse(pkg):
    layers = pkg.layers
    x = layers.data("x", shape=[1], dtype="float32")
    zero = layers.fill_constant([1], "float32", 0.0)
    cond = layers.greater_than(x, zero)
    ie = layers.IfElse(cond)
    with ie.true_block():
        ie.output(layers.scale(ie.input(x), scale=2.0))
    with ie.false_block():
        ie.output(layers.scale(ie.input(x), scale=-1.0))
    out = ie()
    return [out], {"x": np.array([[1.0], [-2.0], [3.0]], np.float32)}


def test_ifelse_rowwise():
    (out,), = _same(run_both(_ifelse))
    np.testing.assert_allclose(out.ravel(), [2.0, 2.0, 6.0])


def _static_rnn_sum(pkg):
    layers = pkg.layers
    x = layers.data("x", shape=[3, 4, 2], dtype="float32",
                    append_batch_size=False)
    rnn = layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        mem = rnn.memory(shape=[4, 2], dtype="float32", value=0.0)
        s = layers.elementwise_add(mem, xt)
        rnn.update_memory(mem, s)
        rnn.step_output(s)
    out = rnn()
    return [out], {"x": np.random.RandomState(1).rand(3, 4, 2)
                   .astype(np.float32)}


def test_static_rnn_sum():
    (out,), = _same(run_both(_static_rnn_sum))
    xv = np.random.RandomState(1).rand(3, 4, 2).astype(np.float32)
    assert out.shape == (3, 4, 2)
    np.testing.assert_allclose(out, np.cumsum(xv, 0), rtol=1e-6)


def _static_rnn_train(pkg):
    layers = pkg.layers
    x = layers.data("x", shape=[3, 2, 4], dtype="float32",
                    append_batch_size=False)
    rnn = layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        mem = rnn.memory(shape=[2, 4], dtype="float32", value=0.0)
        h = layers.fc([xt, mem], size=4, bias_attr=False)
        rnn.update_memory(mem, h)
        rnn.step_output(h)
    out = rnn()
    loss = layers.mean(layers.square(out))
    pkg.optimizer.SGD(0.1).minimize(loss)
    return [loss], {"x": np.random.RandomState(0).rand(3, 2, 4)
                    .astype(np.float32)}


def test_static_rnn_grad_flows():
    losses = _same(run_both(_static_rnn_train, steps=16))
    # grads reach the fc weight captured inside the step block
    assert float(losses[-1][0]) < float(losses[0][0])


def _dynamic_rnn(pkg):
    layers = pkg.layers
    x = layers.data("x", shape=[4, 3], dtype="float32")
    sl = layers.data("sl", shape=[], dtype="int32")
    drnn = layers.DynamicRNN()
    with drnn.block():
        xt = drnn.step_input(x, seq_len=sl)
        mem = drnn.memory(shape=[3], batch_ref=x, value=0.0)
        s = layers.elementwise_add(mem, xt)
        drnn.update_memory(mem, s)
        drnn.output(s)
    out = drnn()
    last = layers.sequence_last_step(out, seq_len=sl)
    return [out, last], {"x": np.ones((2, 4, 3), np.float32),
                         "sl": np.array([2, 4], np.int32)}


def test_dynamic_rnn_masks_state():
    (out, last), = _same(run_both(_dynamic_rnn))
    # memory freezes at each row's end: the last valid output is the sum
    np.testing.assert_allclose(last[0], 2 * np.ones(3))
    np.testing.assert_allclose(last[1], 4 * np.ones(3))
    np.testing.assert_allclose(out[1, -1], 4 * np.ones(3))


def _print_and_py_func(pkg):
    layers = pkg.layers
    x = layers.data("x", shape=[2], dtype="float32")
    y = layers.Print(layers.scale(x, scale=1.0), message="dbg")
    out = pkg.default_main_program().global_block().create_var(
        name="pyfunc_out", shape=[-1, 2], dtype="float32")
    layers.nn.py_func(lambda a: a * 3.0, x, out)
    return [y, out], {"x": np.ones((2, 2), np.float32)}


def test_print_and_py_func(capfd):
    said = {}
    got = run_both(_print_and_py_func,
                   between=lambda tag: said.update(
                       {tag: capfd.readouterr().out}))
    (y, out), = _same(got)
    np.testing.assert_allclose(out, 3 * np.ones((2, 2)))
    assert "dbg" in said["port"] and "dbg" in said["ref"]


def _py_func_backward(pkg):
    layers = pkg.layers
    x = layers.data("x", shape=[2], dtype="float32")
    x.stop_gradient = False
    out = pkg.default_main_program().global_block().create_var(
        name="pyfunc_out2", shape=[-1, 2], dtype="float32")
    layers.nn.py_func(lambda a: a * a, x, out,
                      backward_func=lambda a, o, g: 2.0 * a * g)
    loss = layers.mean(out)
    pkg.append_backward(loss)
    return [x.name + "@GRAD", loss], \
        {"x": np.array([[3.0, -1.0], [0.5, 2.0]], np.float32)}


def test_py_func_backward():
    (gx, loss), = _same(run_both(_py_func_backward))
    xv = np.array([[3.0, -1.0], [0.5, 2.0]], np.float32)
    np.testing.assert_allclose(gx, 2 * xv / 4, rtol=1e-5)
    np.testing.assert_allclose(loss, (xv * xv).mean(), rtol=1e-6)


def test_port_while_counts_its_host_syncs():
    """The port reads a While's condition once an iteration (and once more
    to see it false): 5 iterations, 6 reads, and the body's 5 ops run 5
    times."""
    from paddle_tpu_torch.ops import control_flow_ops as cf
    cf.reset_host_syncs()
    run_both(_while_accumulation)
    assert cf.host_syncs() == {"while": 6, "conditional_block": 0,
                               "while_iterations": 5, "body_ops": 25}


@pytest.mark.parametrize("op_type", ["while", "conditional_block",
                                     "static_scan"])
def test_dygraph_refuses_raw_ops(op_type):
    """Both packages' dygraph tracers refuse an op over a sub-block
    (ref ``paddle_tpu/dygraph/tracer.py:180``)."""
    import paddle_tpu as pt
    import paddle_tpu_torch as ptt
    from paddle_tpu import dygraph as rdy
    from paddle_tpu_torch import dygraph as pdy
    for dy, place in ((rdy, pt.CPUPlace()), (pdy, ptt.CPUPlace())):
        with dy.guard(place):
            x = dy.to_variable(np.ones(3, "float32"))
            with pytest.raises(TypeError, match="control-flow"):
                dy.default_tracer().trace_op(op_type, {"X": [x]}, {})



def test_a_name_read_only_in_a_body_stays_alive():
    """y, a fresh product, dies at its add in the global block but is read
    again inside the While's body, which the while op does not name (taken
    out of its inputs, outputs and carried vars, as a program built by
    other means may leave it; the reference's executor refuses such a
    program, so the port alone runs it): the plan keeps y alive until the
    while, neither freeing it nor adding into it in place."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                            unique_name)
    main, startup = Program(), Program()
    with unique_name.guard(), program_guard(main, startup):
        x = layers.data("x", shape=[2, 3], dtype="float32",
                        append_batch_size=False)
        w = layers.create_parameter([3, 3], "float32", name="w_live")
        y = layers.matmul(x, w)
        z = layers.elementwise_add(y, layers.fill_constant([3], "float32",
                                                           1.0))
        i = layers.fill_constant([1], "int64", 0)
        n = layers.fill_constant([1], "int64", 2)
        acc = layers.fill_constant([2, 3], "float32", 0.0)
        cond = layers.less_than(i, n)
        wh = layers.While(cond)
        with wh.block():
            layers.assign(layers.elementwise_add(acc, y), acc)
            layers.increment(i, 1.0)
            layers.less_than(i, n, cond=cond)
    op, = [op for op in main.global_block().ops if op.type == "while"]
    for names in (op.inputs["X"], op.outputs["Out"],
                  op.attrs["carried_vars"]):
        names.remove(y.name)
    xv = np.random.RandomState(3).rand(2, 3).astype(np.float32)
    scope, exe = Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    got_acc, got_z = exe.run(main, feed={"x": xv}, fetch_list=[acc, z],
                             scope=scope)
    yv = xv @ np.asarray(scope.find_var("w_live"))
    np.testing.assert_allclose(np.asarray(got_z), yv + 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got_acc), 2 * yv, rtol=1e-6)
