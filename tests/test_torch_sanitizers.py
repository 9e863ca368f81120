"""``FLAGS_check_nan_inf`` and the op context of a failed run, the port's
against the JAX package's, on the CPU.

- with the flag on, a non-finite float output is reported naming the Fluid
  op that made it, and both packages name the same ops for the same
  program and feed; a clean run prints nothing;
- the flag is part of the executor's plan key: turning it on after a first
  run takes effect;
- a failing lowering names the op and its inputs' shapes.

The reference's donation-aliasing check has no counterpart: the eager step
donates no buffer, so two scope names bound to one tensor are harmless.
"""

import re

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import layers as ref_layers
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu_torch import flags, layers
from paddle_tpu_torch.framework import core, scope as scope_mod, unique_name
from _port_fixtures import collect_garbage_after_module  # noqa: F401

_HIT = re.compile(r"FLAGS_check_nan_inf: non-finite value in output "
                  r"(\S+) of op (\w+)")


@pytest.fixture(autouse=True)
def _isolation():
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope_mod._scope_stack.append(scope_mod.Scope())
    with unique_name.guard():
        yield
    flags.set_flags({"FLAGS_check_nan_inf": False})
    pt.set_flags({"FLAGS_check_nan_inf": False})
    scope_mod._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


def _sqrt_program(pkg):
    """x -> sqrt(x) -> scale(2): sqrt(-1) is NaN, and so is its scale."""
    mod_layers = layers if pkg == "port" else ref_layers
    main, startup = (core.Program(), core.Program()) if pkg == "port" \
        else (RefProgram(), RefProgram())
    guard = core.program_guard if pkg == "port" else ref_guard
    with guard(main, startup):
        x = mod_layers.data("x", shape=[4], dtype="float32")
        block = main.global_block()
        y = block.create_var(name="sq", shape=x.shape, dtype="float32")
        block.append_op(type="sqrt", inputs={"X": [x]},
                        outputs={"Out": [y]})
        z = mod_layers.scale(y, scale=2.0)
    return main, startup, z.name


def _run(pkg, x, flag=True):
    main, startup, z = _sqrt_program(pkg)
    if pkg == "port":
        flags.set_flags({"FLAGS_check_nan_inf": flag})
        exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    else:
        pt.set_flags({"FLAGS_check_nan_inf": flag})
        exe, scope = RefExecutor(), RefScope()
    exe.run(startup, scope=scope)
    out, = exe.run(main, feed={"x": x}, fetch_list=[z], scope=scope)
    return np.asarray(out)


def test_nan_inf_sanitizer_names_the_op_as_the_reference(capfd):
    x = -np.ones((2, 4), np.float32)
    got = _run("port", x)
    port_hits = _HIT.findall(capfd.readouterr().out)
    want = _run("ref", x)
    import jax
    jax.effects_barrier()
    ref_hits = _HIT.findall(capfd.readouterr().out)
    assert np.isnan(got).all() and np.isnan(want).all()
    assert ("Out[0]", "sqrt") in port_hits
    assert sorted(set(port_hits)) == sorted(set(ref_hits))


def test_nan_inf_sanitizer_silent_when_clean(capfd):
    out = _run("port", np.ones((2, 4), np.float32))
    np.testing.assert_allclose(out, 2.0)
    assert "FLAGS_check_nan_inf" not in capfd.readouterr().out


def test_flag_flip_after_a_first_run_takes_effect(capfd):
    main, startup, z = _sqrt_program("port")
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": -np.ones((2, 4), np.float32)}
    exe.run(main, feed=feed, fetch_list=[z], scope=scope)
    assert "FLAGS_check_nan_inf" not in capfd.readouterr().out
    flags.set_flags({"FLAGS_check_nan_inf": True})
    exe.run(main, feed=feed, fetch_list=[z], scope=scope)
    assert ("Out[0]", "sqrt") in _HIT.findall(capfd.readouterr().out)


def test_lowering_error_carries_op_context():
    with core.program_guard(core.Program(), core.Program()):
        x = layers.data("x", shape=[4], dtype="float32")
        y = layers.data("y", shape=[6], dtype="float32")
        block = core.default_main_program().global_block()
        out = block.create_var(name="sum_xy", shape=x.shape,
                               dtype="float32")
        block.append_op(type="elementwise_add", inputs={"X": [x], "Y": [y]},
                        outputs={"Out": [out]}, attrs={"axis": -1})
        exe = ptt.Executor(ptt.CPUPlace())
        with pytest.raises(RuntimeError) as ei:
            exe.run(feed={"x": np.ones((2, 4), np.float32),
                          "y": np.ones((2, 6), np.float32)},
                    fetch_list=[out.name], scope=ptt.Scope())
    msg = str(ei.value)
    assert "elementwise_add" in msg and "shape" in msg
