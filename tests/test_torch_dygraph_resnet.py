"""A depth-50 ResNet in dygraph (``tests/_dygraph_resnet.py``: the
structure and parameter names of ``models/resnet.py``) at 3x32x32, batch
4, class_dim 10, two ``MomentumOptimizer(0.1, 0.9)`` steps on the CPU,
from one static startup's values and one feed:

- against the port's static program (``build_resnet_train``, graph fusion
  off): every loss within 1e-4 relative, and after the second step
  ``fc_out.w`` and every BN running mean within 1e-4 of their largest
  magnitude (the same lowerings and grad ops: they agree bit for bit);
- against the JAX package's dygraph, as a check for gross errors: the
  losses within REF_LOSS_RTOL (1e-2) relative and ``fc_out.w`` within
  REF_W_FRAC (5e-2) of its largest magnitude.  1e-4 cannot hold here: the
  late BNs normalize over 4 values each (1x1 maps at batch 4), which
  amplifies rounding-level differences of the backends, and the JAX
  package does not agree with itself at that level either.  On the CPU
  its own static program and dygraph differ by 3.4e-4 and 6.7e-4 in the
  two losses, by 1.7e-2 of ``fc_out.w``'s largest magnitude and by 0.73
  of a BN running mean's (so the running means are not held); the two
  packages' static programs differ by 1.3e-3 in the first loss; the port's
  dygraph and the reference's by 1.1e-3 and 6.5e-4, and 2.3e-2 of
  ``fc_out.w``.  A lost or doubled gradient moves them far more.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu_torch import flags, optimizer
from paddle_tpu_torch.framework import Program, Scope, program_guard
from paddle_tpu_torch.framework import unique_name
from paddle_tpu_torch.models import resnet
from _dygraph_resnet import build_resnet, conv_bns, load_static, loss_of
from _port_fixtures import (collect_garbage_after_module,  # noqa: F401
                            fresh_port_programs)

pytestmark = pytest.mark.usefixtures("fresh_port_programs")

CFG = dict(class_dim=10, depth=50, image_shape=(3, 32, 32))
BATCH, STEPS = 4, 2
LOSS_RTOL, PARAM_FRAC = 1e-4, 1e-4
REF_LOSS_RTOL, REF_W_FRAC = 1e-2, 5e-2


def _state(scope, names):
    return {n: np.asarray(scope.find_var(n)).copy() for n in names}


@pytest.fixture(scope="module")
def static_runs():
    """The port's startup values, the feed, and STEPS unfused static steps
    in each package from them: {package: (losses, watched state after)}."""
    main, startup = Program(), Program()
    with unique_name.guard(), program_guard(main, startup):
        _, _, loss, _ = resnet.build_resnet_train(**CFG)
        optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
    scope, exe = Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope, seed=11)
    values = {n: v.numpy().copy() for n, v in scope.items()}
    rng = np.random.RandomState(0)
    feed = {"image": rng.rand(BATCH, *CFG["image_shape"]).astype("f4"),
            "label": rng.randint(0, CFG["class_dim"], (BATCH, 1))
            .astype(np.int64)}
    watched = ["fc_out.w"] + [v.name for v in main.list_vars()
                              if v.name.endswith(".bn.mean")]
    flags.set_flags({"FLAGS_graph_fusion": False})
    try:
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[loss],
                                           scope=scope)[0]))
                  for _ in range(STEPS)]
    finally:
        flags.set_flags({"FLAGS_graph_fusion": True})
    runs = {"port": (losses, _state(scope, watched))}
    rmain, rstartup = RefProgram(), RefProgram()
    with ref_names.guard(), ref_guard(rmain, rstartup):
        _, _, rloss, _ = ref_resnet.build_resnet_train(**CFG)
        ref_opt.MomentumOptimizer(0.1, 0.9).minimize(rloss)
    rscope, rexe = RefScope(), RefExecutor()
    rexe.run(rstartup, scope=rscope)
    for n, v in values.items():
        rscope.set_var(n, jnp.asarray(v))
    rlosses = [float(np.asarray(rexe.run(rmain, feed=feed,
                                         fetch_list=[rloss],
                                         scope=rscope)[0]))
               for _ in range(STEPS)]
    runs["ref"] = (rlosses, _state(rscope, watched))
    return values, feed, runs


def _dygraph_steps(pkg, values, feed):
    """STEPS Momentum steps of the dygraph ResNet of ``pkg`` from
    ``values``: the losses, and fc_out.w and the BN running means after."""
    dy = pkg.dygraph
    with dy.guard(ptt.CPUPlace()) if pkg is ptt else dy.guard():
        net = build_resnet(pkg, CFG["depth"], CFG["class_dim"])
        load_static(dy, net, values, CFG["image_shape"])
        opt = pkg.optimizer.MomentumOptimizer(
            0.1, 0.9, parameter_list=net.parameters())
        losses = []
        for _ in range(STEPS):
            loss = loss_of(dy, net, dy.to_variable(feed["image"]),
                           dy.to_variable(feed["label"]))
            loss.backward()
            opt.minimize(loss)
            net.clear_gradients()
            losses.append(float(loss.numpy()))
        state = {l.bn_name + ".mean": l.bn._mean.numpy()
                 for l in conv_bns(net)}
        state["fc_out.w"] = net.fc.weight.numpy()
        return losses, state


def test_dygraph_resnet_matches_the_static_program(static_runs):
    values, feed, runs = static_runs
    losses, state = _dygraph_steps(ptt, values, feed)
    want_losses, want = runs["port"]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL, atol=0)
    assert losses == want_losses            # bit for bit on the CPU
    assert len(state) == len(want) == 54
    for n, w in want.items():
        assert np.abs(state[n] - w).max() <= PARAM_FRAC * np.abs(w).max(), n


def test_dygraph_resnet_against_the_reference_dygraph(static_runs):
    values, feed, runs = static_runs
    ref_losses, ref = _dygraph_steps(pt, values, feed)
    # the premise of the loose limits: the reference's own static program
    # and dygraph differ beyond LOSS_RTOL here
    own = max(abs(a - b) / abs(b) for a, b in zip(runs["ref"][0],
                                                  ref_losses))
    assert own > LOSS_RTOL, own
    losses, state = _dygraph_steps(ptt, values, feed)
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=REF_LOSS_RTOL,
                               atol=0)
    w = ref["fc_out.w"]
    assert np.abs(state["fc_out.w"] - w).max() <= \
        REF_W_FRAC * np.abs(w).max()
