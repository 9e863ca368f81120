"""Gradients through the ``c_*`` collectives and ``sync_batch_norm`` in the
port's collective mode against the JAX package's ``shard_map`` mode.

A collective op in the forward of a program with a backward: ``x`` ->
``fc`` -> the collective -> ``mean(out ** 2)``, so each rank's output
gradient differs.  Both packages run the
program at dp 2 and dp 4 (the port over a mesh of virtual CPU ranks, the
reference over its CPU devices) from the same weights; the per-rank
gradients of the collective's input and of the fc weight must agree
(rtol 1e-5, atol 1e-6), with the reference's transposes: ``psum``'s is
``psum``, ``all_gather``'s ``psum_scatter`` and back, the broadcast's the
sum of every rank's gradient on the root, the product's each rank's
gradient times the others' inputs.  ``c_allreduce_max`` has no gradient in
either package.  ``sync_batch_norm`` normalizes with the ring's batch
moments: its output, running statistics and input / scale / bias
gradients against the reference's, and against one-rank batch norm of the
whole batch.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.parallel import make_mesh, set_mesh
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh port default programs, scope, names; no mesh after."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    set_mesh(None)
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


CASES = {
    "c_allreduce_sum": {"ring_id": 0},
    "c_allreduce_prod": {"ring_id": 0},
    "c_allgather": {"ring_id": 0},
    "c_reducescatter": {"ring_id": 0},
    "c_broadcast": {"ring_id": 0, "root": 1},
    "c_split": {"ring_id": 0},
    "c_sync_calc_stream": {},
}


def _program(root, layers, opt_mod, names, op_type, attrs, n):
    with names.guard():
        main, startup = root.Program(), root.Program()
        with root.program_guard(main, startup):
            x = layers.data("x", shape=[4], dtype="float32")
            h = layers.fc(x, size=4, name="cg_fc")
            blk = main.global_block()
            out = blk.create_var(name="cg_out", dtype="float32")
            blk.append_op(op_type, inputs={"X": [h]},
                          outputs={"Out": [out]}, attrs=attrs)
            loss = layers.mean(layers.square(out))
            opt_mod.SGDOptimizer(0.0).minimize(loss)
    main._attrs["collective"] = {"nranks": n, "rank": 0}
    return main, startup, h.name, loss.name


def _feed(op_type, n):
    rows = 4 * n
    x = np.random.RandomState(5).randn(rows, 4).astype(np.float32)
    return {"x": x}


def _grads(pkg, op_type, n, init=None):
    if pkg == "ref":
        main, startup, h, loss = _program(pt, pt.layers, pt.optimizer,
                                          ref_names, op_type, CASES[op_type],
                                          n)
        sc, exe = RefScope(), RefExecutor()
        exe.run(startup, scope=sc, seed=3)
        params = {p.name: np.asarray(sc.find_var(p.name))
                  for p in main.all_parameters()}
        got = exe.run(main, feed=_feed(op_type, n),
                      fetch_list=[loss, h + "@GRAD", "cg_fc.w_0@GRAD"],
                      scope=sc)
        return params, [np.asarray(g) for g in got]
    main, startup, h, loss = _program(ptt, ptt.layers, opt, unique_name,
                                      op_type, CASES[op_type], n)
    sc, exe = scope.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=3)
    params_from_numpy(sc, init)
    set_mesh(make_mesh({"dp": n}, [CPU] * n))
    got = exe.run(main, feed=_feed(op_type, n),
                  fetch_list=[loss, h + "@GRAD", "cg_fc.w_0@GRAD"], scope=sc)
    return None, got


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op_type", sorted(CASES))
def test_collective_gradient_matches_reference(op_type, n):
    init, want = _grads("ref", op_type, n)
    _, got = _grads("port", op_type, n, init)
    for g, w, what in zip(got, want, ("loss", "dX", "dW")):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg=what, **TOL)


def test_max_and_min_have_no_gradient():
    """``lax.pmax`` has no differentiation rule: neither package
    differentiates through ``c_allreduce_max`` / ``_min``."""
    for t in ("c_allreduce_max", "c_allreduce_min"):
        main, startup, h, loss = _program(ptt, ptt.layers, opt, unique_name,
                                          t, {"ring_id": 0}, 2)
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup, scope=scope.Scope())
        set_mesh(make_mesh({"dp": 2}, [CPU] * 2))
        with pytest.raises(NotImplementedError, match="no gradient"):
            exe.run(main, feed=_feed(t, 2), fetch_list=[loss],
                    scope=scope.Scope())
    info = registry.get_op_info("c_allreduce_sum")
    assert info.grad is not None and info.collective
    with pytest.raises(NotImplementedError, match="group VJP"):
        registry.run_forward(info, None, {"X": [torch.ones(2)]}, {})


# -- sync_batch_norm ----------------------------------------------------------

def _bn_program(root, layers, opt_mod, names, op, n):
    with names.guard():
        main, startup = root.Program(), root.Program()
        with root.program_guard(main, startup):
            x = layers.data("x", shape=[3, 4, 4], dtype="float32")
            c = layers.conv2d(x, num_filters=4, filter_size=1,
                              name="sbn_conv")
            helper_out = layers.batch_norm(c, name="sbn")
            blk = main.global_block()
            bn = next(o for o in blk.ops if o.type == "batch_norm")
            bn.type = op
            bn.attrs["ring_id"] = 0
            loss = layers.mean(layers.square(helper_out))
            opt_mod.SGDOptimizer(0.0).minimize(loss)
    if n:
        main._attrs["collective"] = {"nranks": n, "rank": 0}
    bn = next(o for o in main.global_block().ops if o.type == op)
    names = [bn.input(s)[0] + "@GRAD" for s in ("Scale", "Bias")] + \
        [bn.input(s)[0] for s in ("Mean", "Variance")]
    return main, startup, c.name, loss.name, names


def _bn_feed(n):
    return {"x": np.random.RandomState(8).randn(2 * max(n, 1) * 2, 3, 4, 4)
            .astype(np.float32)}


def _bn_run(pkg, op, n, init=None, feed=None):
    fetch = None
    if pkg == "ref":
        main, startup, c, loss, names = _bn_program(
            pt, pt.layers, pt.optimizer, ref_names, op, n)
        sc, exe = RefScope(), RefExecutor()
        exe.run(startup, scope=sc, seed=4)
        init = {p: np.asarray(sc.find_var(p)) for p in
                main.global_block().vars if main.global_block().var(p)
                .persistable and sc.find_var(p) is not None}
        fetch = [loss, c + "@GRAD"] + names
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=sc)
        return init, fetch, [np.asarray(g) for g in got]
    main, startup, c, loss, _ = _bn_program(ptt, ptt.layers, opt,
                                            unique_name, op, n)
    sc, exe = scope.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=4)
    params_from_numpy(sc, init)
    if n:
        set_mesh(make_mesh({"dp": n}, [CPU] * n))
    return None, None, exe, main, sc, loss, c


@pytest.mark.parametrize("n", [2, 4])
def test_sync_batch_norm_matches_reference(n):
    feed = _bn_feed(n)
    init, fetch, want = _bn_run("ref", "sync_batch_norm", n, feed=feed)
    _, _, exe, main, sc, loss, c = _bn_run("port", "sync_batch_norm", n,
                                           init)
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=sc)
    for name, g, w in zip(fetch, got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    # the ring's moments are the whole batch's: one rank of plain batch
    # norm over the whole batch gives the same loss and statistics
    _, _, exe1, main1, sc1, loss1, _ = _bn_run("port", "batch_norm", 0,
                                               init)
    set_mesh(None)
    one = exe1.run(main1, feed=feed, fetch_list=[loss1] + fetch[4:],
                   scope=sc1)
    np.testing.assert_allclose(got[0].mean(), one[0], **TOL)
    for g, w in zip(got[4:], one[1:]):
        np.testing.assert_allclose(g[0], w, **TOL)
