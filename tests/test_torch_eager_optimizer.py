"""The eager optimizer apply of the port (``dygraph.eager_apply``'s
``EagerBlock``, ``Optimizer._dygraph_minimize`` under ``dygraph.guard()``),
on which the pipeline engine's per-stage update stands, on the CPU.

- two eager steps of SGD, Momentum (with an L2 regularizer) and Adam on
  ``VarBase`` parameters, fed the gradients the static program computed,
  equal two static steps of the same optimizer in the port (bit for bit:
  the same lowerings) and in the JAX package from the same weights and
  feeds (rtol 1e-5 + atol 1e-6); Adam's accumulators live as ``VarBase`` s
  on the parameter's device and ``fused_flat`` stays off;
- ``eager_clip_grads`` for the three clip classes equals the JAX package's
  on the same numpy gradients (rtol 1e-6);
- the constructor's ``parameter_list`` is taken, and an eager ``loss``
  with no gradients runs its ``backward()`` (dygraph, ROADMAP item 4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu import clip as ref_clip
from paddle_tpu import optimizer as ref_opt
from paddle_tpu import regularizer as ref_reg
from paddle_tpu.dygraph.eager_apply import eager_clip_grads as \
    ref_eager_clip
from paddle_tpu.dygraph.tracer import VarBase as RefVarBase
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import scope_guard as ref_scope_guard
from paddle_tpu.framework import unique_name as ref_names
import paddle_tpu_torch as ptt
from paddle_tpu_torch import clip, regularizer
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.dygraph import (EagerBlock, VarBase, eager_clip_grads,
                                      guard, in_dygraph_mode)
from paddle_tpu_torch.framework import core, scope, unique_name
from paddle_tpu_torch.io import params_from_numpy
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 2


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh port default programs, scope and names."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


def _make(kind, mod, reg):
    if kind == "sgd":
        return mod.SGDOptimizer(0.1)
    if kind == "momentum":
        return mod.MomentumOptimizer(0.1, 0.9,
                                     regularization=reg.L2Decay(1e-2))
    return mod.AdamOptimizer(learning_rate=0.01, fused_flat=True)


def _feeds():
    rng = np.random.RandomState(2)
    return [{"x": rng.rand(8, 6).astype(np.float32),
             "y": rng.rand(8, 3).astype(np.float32)} for _ in range(STEPS)]


def _static(pkg, kind, init=None):
    """(initial weights, per-step gradients, per-step weights) of STEPS
    static steps in ``pkg``."""
    ref = pkg is pt
    names = ref_names if ref else unique_name
    main, startup = pkg.Program(), pkg.Program()
    with names.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[6], dtype="float32")
        y = pkg.layers.data("y", shape=[3], dtype="float32")
        pred = pkg.layers.fc(x, size=3)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        _make(kind, ref_opt if ref else opt,
              ref_reg if ref else regularizer).minimize(loss)
    params = [p.name for p in main.all_parameters()]
    grads = [n + "@GRAD" for n in params]
    if ref:
        sc, exe = RefScope(), RefExecutor()
        with ref_scope_guard(sc):
            exe.run(startup, scope=sc, seed=3)
    else:
        sc, exe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
        exe.run(startup, scope=sc, seed=3)
        params_from_numpy(sc, init)
    first = {n: np.asarray(sc.find_var(n)).copy() for n in params}
    gs, ws = [], []
    for f in _feeds():
        out = exe.run(main, feed=f, fetch_list=grads, scope=sc)
        gs.append({n: np.asarray(g) for n, g in zip(params, out)})
        ws.append({n: np.asarray(sc.find_var(n)).copy() for n in params})
    return first, gs, ws


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_eager_steps_equal_static_steps(kind):
    init, ref_g, ref_w = _static(pt, kind)
    _, gs, ws = _static(ptt, kind, init)
    vbs = [VarBase(torch.from_numpy(init[n].copy()), name=n,
                   persistable=True, device=CPU) for n in init]
    o = _make(kind, opt, regularizer)
    for step in range(STEPS):
        for vb in vbs:
            vb.grad = torch.from_numpy(gs[step][vb.name])
        assert not in_dygraph_mode()
        with guard(ptt.CPUPlace()):
            assert in_dygraph_mode()
            o.minimize(None, parameter_list=vbs)
        for vb in vbs:
            np.testing.assert_array_equal(vb.numpy(), ws[step][vb.name],
                                          err_msg=vb.name)
            np.testing.assert_allclose(vb.numpy(), ref_w[step][vb.name],
                                       err_msg=vb.name, **TOL)
    if kind == "adam":
        assert not o._pending_fused
        accs = o._accumulators["moment1"]
        assert set(accs) == {vb.name for vb in vbs}
        assert all(isinstance(a, VarBase) and a.device == CPU
                   for a in accs.values())
        assert float(o._accumulators["beta1_pow_acc"][vbs[0].name]
                     .value[0]) == pytest.approx(0.9 ** (STEPS + 1))


@pytest.mark.parametrize("which", ["global_norm", "norm", "value"])
def test_eager_clip_grads_equal_reference(which):
    rng = np.random.RandomState(4)
    gs = [rng.randn(5, 3).astype(np.float32) * 3,
          rng.randn(7).astype(np.float32)]
    make = {"global_norm": lambda m: m.GradientClipByGlobalNorm(1.5),
            "norm": lambda m: m.GradientClipByNorm(0.8),
            "value": lambda m: m.GradientClipByValue(0.5, -0.25)}[which]
    ref = ref_eager_clip([(RefVarBase(np.zeros_like(g)), jnp.asarray(g))
                          for g in gs], make(ref_clip))
    got = eager_clip_grads([(VarBase(np.zeros_like(g)), torch.from_numpy(g))
                            for g in gs], make(clip))
    for (_, r), (_, g) in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=0)


def test_unported_dygraph_raises():
    """Once the parts the eager apply stood without: the constructor's
    ``parameter_list`` is taken, and a loss no parameter has a gradient
    of runs its own ``backward()`` (a loss off the tape leaves them
    without one, and the step skips them)."""
    vb = VarBase(np.ones(3, np.float32), name="p", device=CPU)
    o = opt.SGDOptimizer(0.1, parameter_list=[vb])
    assert o._parameter_list == [vb]
    with guard(ptt.CPUPlace()):
        _, pg = o.minimize(VarBase(np.ones(1, np.float32)))
    assert pg == []
    np.testing.assert_array_equal(vb.numpy(), np.ones(3, np.float32))
    blk = EagerBlock(0.5)
    out = blk.append_op("sgd", inputs={"Param": [vb], "Grad": [
        torch.ones(3)], "LearningRate": [None]}, outputs={"ParamOut": [vb]})
    np.testing.assert_array_equal(vb.numpy(), np.full(3, 0.5, np.float32))
    assert out["ParamOut"][0].device == CPU
