"""The initializers the port lacked (TruncatedNormal, MSRA, Bilinear,
NumpyArray, Xavier's normal form) and ``truncated_gaussian_random``: the
port against the JAX package, on the CPU.

- each initializer, reached through ``layers.create_parameter`` and
  through ``fc``'s ``ParamAttr``, puts the same op with the same attributes
  in the startup program as the reference's does;
- the random ones cannot match JAX's bits (the packages draw from
  different generators), so their draws are held to their distribution:
  shape, dtype, the truncation bound, the mean and the standard deviation
  within 5 standard errors of a 65,536-element draw, MSRA's scale;
- Bilinear and NumpyArray are ``assign_value``: their values equal the
  reference's exactly;
- ``truncated_gaussian_random`` on its own, float32 and float64.
"""

import json
import math

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401
import paddle_tpu_torch as ptt
from paddle_tpu import initializer as ref_init
from paddle_tpu import layers as ref_layers
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.param_attr import ParamAttr as RefParamAttr
from paddle_tpu_torch import initializer, layers
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.framework.executor import LowerCtx
from paddle_tpu_torch.param_attr import ParamAttr
from _port_fixtures import collect_garbage_after_module  # noqa: F401

# the standard deviation of N(0, 1) cut at ±2
TRUNC_STD = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                      / math.erf(math.sqrt(2)))
N_SE = 5.0


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


INITS = {
    "truncated_normal": lambda I: I.TruncatedNormal(loc=0.5, scale=2.0),
    "msra_uniform": lambda I: I.MSRA(),
    "msra_normal": lambda I: I.MSRA(uniform=False),
    "msra_fan_in": lambda I: I.MSRAInitializer(uniform=False, fan_in=64),
    "xavier_normal": lambda I: I.Xavier(uniform=False),
    "bilinear": lambda I: I.Bilinear(),
    "numpy_array": lambda I: I.NumpyArrayInitializer(
        np.arange(4 * 3 * 5 * 5, dtype=np.float32).reshape(4, 3, 5, 5)
        / 7.0),
}
SHAPES = {"bilinear": [4, 3, 5, 5], "numpy_array": [4, 3, 5, 5]}
BIG = [256, 256]


def _startup(pkg, make, shape, via="create_parameter"):
    """A program holding one parameter initialized by ``make(module)``,
    made through ``create_parameter`` or an ``fc``'s ParamAttr."""
    if pkg == "ref":
        main, startup = RefProgram(), RefProgram()
        guard, names, L, I, PA = (ref_guard(main, startup),
                                  ref_names.guard(), ref_layers, ref_init,
                                  RefParamAttr)
    else:
        main, startup = core.Program(), core.Program()
        guard, names, L, I, PA = (core.program_guard(main, startup),
                                  unique_name.guard(), layers, initializer,
                                  ParamAttr)
    with guard, names:
        if via == "fc":
            x = L.data("x", shape=[shape[0]], dtype="float32")
            L.fc(x, size=shape[1], param_attr=PA(name="w",
                                                 initializer=make(I)))
        else:
            L.create_parameter(shape, "float32", name="w",
                               default_initializer=make(I))
    return startup


def _init_op(startup):
    ops = json.loads(startup.serialize_to_string())["blocks"][0]["ops"]
    op, = [op for op in ops if op["outputs"]["Out"] == ["w"]]
    return op


@pytest.mark.parametrize("name,via", [
    (n, v) for n in sorted(INITS) for v in ("create_parameter", "fc")
    if v == "create_parameter" or n not in SHAPES])
def test_startup_op_matches_reference(name, via):
    shape = SHAPES.get(name, [64, 32])
    ref = _init_op(_startup("ref", INITS[name], shape, via))
    got = _init_op(_startup("port", INITS[name], shape, via))
    assert got == ref
    assert got["type"] == {"truncated_normal": "truncated_gaussian_random",
                           "msra_uniform": "uniform_random",
                           "msra_normal": "gaussian_random",
                           "msra_fan_in": "gaussian_random",
                           "xavier_normal": "gaussian_random"}.get(
                               name, "assign_value")


def _draw(name, shape=BIG, seed=3):
    sc = scope.Scope()
    ptt.Executor(ptt.CPUPlace()).run(
        _startup("port", INITS[name], shape), scope=sc, seed=seed)
    w = sc.find_var("w")
    assert tuple(w.shape) == tuple(shape) and w.dtype == torch.float32
    return w.double().numpy().reshape(-1)


def _assert_moments(w, mean, std):
    se = std / math.sqrt(w.size)
    assert abs(w.mean() - mean) <= N_SE * se, (w.mean(), mean, se)
    # the sample std's standard error is about std / sqrt(2n)
    assert abs(w.std() - std) <= N_SE * std / math.sqrt(2 * w.size), \
        (w.std(), std)


def test_truncated_normal_draw():
    w = _draw("truncated_normal")
    assert np.all(np.abs(w - 0.5) <= 2 * 2.0 + 1e-6)
    _assert_moments(w, 0.5, 2.0 * TRUNC_STD)
    # a fresh seed draws anew
    assert not np.array_equal(w, _draw("truncated_normal", seed=4))


def test_msra_and_xavier_draws():
    fan_in = BIG[0]
    limit = math.sqrt(6.0 / fan_in)
    w = _draw("msra_uniform")
    assert np.all(np.abs(w) <= limit)
    _assert_moments(w, 0.0, limit / math.sqrt(3.0))
    _assert_moments(_draw("msra_normal"), 0.0, math.sqrt(2.0 / fan_in))
    _assert_moments(_draw("msra_fan_in"), 0.0, math.sqrt(2.0 / 64))
    _assert_moments(_draw("xavier_normal"), 0.0,
                    math.sqrt(2.0 / (BIG[0] + BIG[1])))


@pytest.mark.parametrize("name", ["bilinear", "numpy_array"])
def test_assigned_values_equal_reference(name):
    shape = SHAPES[name]
    ref_scope = RefScope()
    RefExecutor().run(_startup("ref", INITS[name], shape), scope=ref_scope)
    np.testing.assert_array_equal(_draw(name, shape).astype(np.float32),
                                  np.asarray(ref_scope.find_var("w"))
                                  .reshape(-1))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_truncated_gaussian_random_op(dtype):
    attrs = {"shape": [128, 512], "dtype": dtype, "mean": -1.0, "std": 0.5,
             "seed": 0}
    out, = registry.get_op_info("truncated_gaussian_random").lower(
        LowerCtx(torch.device("cpu"), 9), {}, attrs)["Out"]
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == \
        (128, 512)
    w = out.double().numpy().reshape(-1)
    assert np.all(np.abs(w + 1.0) <= 1.0 + 1e-6)
    _assert_moments(w, -1.0, 0.5 * TRUNC_STD)
    assert registry.get_op_info("truncated_gaussian_random").stateful_rng
