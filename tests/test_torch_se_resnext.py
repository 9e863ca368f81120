"""SE-ResNeXt-50, which dropout unblocks: one Momentum step of the port
against the JAX package at 3x64x64, batch 4, on the CPU.

Both packages draw the head's dropout from the same bits
(``_port_fixtures.patch_same_bits``) and start from the same numpy
weights.  A random-init depth-50 net amplifies float32 rounding
chaotically (deep conv weights' steps differ by up to 40% at this batch;
at 3x32x32, batch 2, the last stage's BN over 2 values a channel moves
the loss by 8%), so the step is held as ``chip_smoke.py`` holds
ResNet-50: the loss within 1e-4 relative (6.6e-6 measured), every BN
running statistic within 2^-10 of its tensor's largest magnitude, the
classifier's weights and velocities within 2^-8 of their step's largest
magnitude (3e-5 measured).  The reference runs jitted: the net has no bf16
rounding for XLA to fold away.
"""

import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (registers the reference lowerings)
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework import core, scope, unique_name
from paddle_tpu_torch.models import resnet
from _port_fixtures import collect_garbage_after_module  # noqa: F401
from _port_fixtures import patch_same_bits

LOSS_RTOL, STAT_FRAC, CLASSIFIER_FRAC = 1e-4, 2.0 ** -10, 2.0 ** -8


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


def _build(models, optimizer):
    loss, _, _ = models.build_se_resnext_train(class_dim=10, depth=50,
                                               image_shape=(3, 64, 64))
    optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
    return loss.name


def test_se_resnext_step_matches_reference(monkeypatch):
    ref_main, ref_startup = RefProgram(), RefProgram()
    with ref_guard(ref_main, ref_startup), ref_names.guard():
        ref_loss = _build(ref_resnet, ref_opt)
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup), unique_name.guard():
        loss = _build(resnet, opt)
    types = [op.type for op in main.global_block().ops]
    assert types.count("dropout") == 1 and types.count("sigmoid") == 16
    # the port's startup state, fed to both
    port_scope, exe = scope.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=port_scope, seed=7)
    init = ptt.io.params_to_numpy(port_scope)
    ref_scope = RefScope()
    for n, a in init.items():
        ref_scope.set_var(n, a)
    patch_same_bits(monkeypatch)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(4, 3, 64, 64).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    want, = RefExecutor().run(ref_main, feed=feed, fetch_list=[ref_loss],
                              scope=ref_scope, seed=5)
    got, = exe.run(main, feed=feed, fetch_list=[loss], scope=port_scope,
                   seed=5)
    np.testing.assert_allclose(float(got), float(np.asarray(want)),
                               rtol=LOSS_RTOL)
    state = ptt.io.params_to_numpy(port_scope)
    stats = [n for n in init if n.endswith((".bn.mean", ".bn.var"))]
    head = [n for n in init if n.startswith("se_fc_out.")]
    assert len(stats) == 2 * 53 and len(head) == 4
    for n in stats:
        r = np.asarray(ref_scope.find_var(n))
        np.testing.assert_allclose(state[n], r, rtol=0, err_msg=n,
                                   atol=STAT_FRAC * np.abs(r).max())
    for n in head:
        r = np.asarray(ref_scope.find_var(n))
        np.testing.assert_allclose(
            state[n], r, rtol=0, err_msg=n,
            atol=CLASSIFIER_FRAC * np.abs(r - init[n]).max())
