"""The CTR model of the port (``models/ctr.py``'s ``build_ctr_train``) and
the ops it needs (``sigmoid_cross_entropy_with_logits``, the layers
``elementwise_add`` / ``elementwise_mul``) against the JAX package's, on
the CPU.

- ``build_ctr_train(sparse_dim=50)`` (DeepFM: the shared slot-offset tables
  ``ctr_embedding`` and ``ctr_wide_w``, the deep MLP, the FM term): the
  loss and the gradient of every parameter equal the reference's on the
  same weights (the reference's startup, ``params_from_numpy``) and feeds,
  with the sparse embedding and without, and without the FM term;
- ``sigmoid_cross_entropy_with_logits`` with and without ``normalize``, with
  ``ignore_index`` labels among the others: its output and the gradient of
  its mean equal the reference's;
- the DeepFM at ``sparse_dim`` 50 over the parameter server, under the PS
  launcher with ``paddle_tpu_torch/tools/ps_runner.py`` (children with one
  torch thread, under a timeout): in a sync gang of 2 trainers their dense
  parameters are equal bit for bit after every step and their mean loss is
  one process's on both batches (from the same startup) within 1e-4 (the
  geo gang is in ``test_torch_ps_train.py``).
"""

import contextlib

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import append_backward as ref_backward
from paddle_tpu.framework import core as ref_core
from paddle_tpu.framework import scope as ref_scope
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.models import ctr as ref_ctr
from paddle_tpu_torch.framework import (append_backward, core, scope,
                                        unique_name)
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import build_ctr_train, ctr
from _port_fixtures import collect_garbage_after_module  # noqa: F401
from _ps_helpers import deepfm_gang

SPARSE_DIM, EMBED, BATCH = 50, 8, 16

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _fresh():
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


@contextlib.contextmanager
def _guard(core_mod, scope_mod, names):
    sc = scope_mod.Scope()
    with scope_mod.scope_guard(sc), \
            core_mod.program_guard(core_mod.Program(), core_mod.Program()), \
            names.guard():
        yield sc


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.rand(BATCH, 13).astype(np.float32)
    return {"dense": dense,
            "sparse": rng.randint(0, SPARSE_DIM, (BATCH, 26)).astype(
                np.int64),
            "click": (dense.sum(1, keepdims=True) > 6.5).astype(np.int64)}


def _ref_run(kw, feed):
    with _guard(ref_core, ref_scope, ref_names) as sc:
        loss, prob, _ = ref_ctr.build_ctr_train(**kw)
        pairs = ref_backward(loss)
        exe = RefExecutor()
        exe.run(ref_core.default_startup_program(), scope=sc)
        init = {p.name: np.asarray(sc.find_var(p.name)).copy()
                for p, _ in pairs}
        out = exe.run(feed=feed, fetch_list=[loss, prob] +
                      [g for _, g in pairs], scope=sc)
        return init, [p.name for p, _ in pairs], out


def _port_run(kw, feed, init):
    with _guard(core, scope, unique_name) as sc:
        loss, prob, feeds = build_ctr_train(**kw)
        assert [v.name for v in feeds] == ["dense", "sparse", "click"]
        pairs = append_backward(loss)
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(core.default_startup_program(), scope=sc)
        names = [p.name for p, _ in pairs]
        assert set(names) == set(init)
        params_from_numpy(sc, init)
        out = exe.run(feed=feed, fetch_list=[loss, prob] +
                      [g for _, g in pairs], scope=sc)
        return names, out


@pytest.mark.parametrize("kw", [
    dict(is_sparse=True), dict(is_sparse=False),
    dict(is_sparse=True, use_fm=False, deep_layers=(32,))],
    ids=["sparse", "dense", "no_fm"])
def test_ctr_loss_and_gradients_match_the_reference(kw):
    kw = dict(kw, sparse_dim=SPARSE_DIM, embed_size=EMBED)
    feed = _feed()
    init, ref_names_, want = _ref_run(kw, feed)
    assert {"ctr_embedding", "ctr_wide_w"} <= set(init)
    assert init["ctr_embedding"].shape == (26 * SPARSE_DIM, EMBED)
    names, got = _port_run(kw, feed, init)
    assert names == ref_names_
    np.testing.assert_allclose(got[0], want[0], **TOL)          # loss
    np.testing.assert_allclose(got[1], want[1], **TOL)          # prob
    for name, g, w in zip(names, got[2:], want[2:]):
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)
    # the gradient reaches every table row the feed touched, and no other
    g_emb = got[2 + names.index("ctr_embedding")]
    rows = np.unique(feed["sparse"] + np.arange(26) * SPARSE_DIM)
    hit = np.abs(g_emb).sum(1) > 0
    assert hit[rows].all() and hit.sum() == len(rows)


def _sce(layers, x, label, kw):
    out = layers.sigmoid_cross_entropy_with_logits(x, label, **kw)
    return out, layers.mean(out)


@pytest.mark.parametrize("normalize", [False, True])
def test_sigmoid_cross_entropy_with_logits_matches_the_reference(normalize):
    rng = np.random.RandomState(3)
    xv = (rng.randn(6, 5) * 4).astype(np.float32)
    lv = rng.rand(6, 5).astype(np.float32)
    lv[rng.rand(6, 5) < 0.3] = -1.0              # ignored elements
    kw = dict(ignore_index=-1, normalize=normalize)
    feed = {"x": xv, "label": lv}
    with _guard(ref_core, ref_scope, ref_names) as sc:
        x = pt.layers.data("x", shape=[5], dtype="float32")
        x.stop_gradient = False
        label = pt.layers.data("label", shape=[5], dtype="float32")
        out, loss = _sce(pt.layers, x, label, kw)
        ref_backward(loss, parameter_list=[])
        want = RefExecutor().run(feed=feed, fetch_list=[
            out, loss, ref_core.grad_var_name("x")], scope=sc)
    with _guard(core, scope, unique_name) as sc:
        x = ptt.layers.data("x", shape=[5], dtype="float32")
        x.stop_gradient = False
        label = ptt.layers.data("label", shape=[5], dtype="float32")
        out, loss = _sce(ptt.layers, x, label, kw)
        append_backward(loss, parameter_list=[])
        got = ptt.Executor(ptt.CPUPlace()).run(feed=feed, fetch_list=[
            out, loss, core.grad_var_name("x")], scope=sc)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert (got[0][lv == -1] == 0).all() and (got[2][lv == -1] == 0).all()
    # the closed form, in float64
    x64, l64 = xv.astype(np.float64), lv.astype(np.float64)
    ref = np.maximum(x64, 0) - x64 * l64 + np.log1p(np.exp(-np.abs(x64)))
    ref[lv == -1] = 0
    if normalize:
        ref /= max((lv != -1).sum(), 1)
    np.testing.assert_allclose(got[0], ref, rtol=1e-5, atol=1e-6)


def test_elementwise_layers_match_the_reference():
    rng = np.random.RandomState(1)
    feed = {"a": rng.randn(4, 3, 5).astype(np.float32),
            "b": rng.randn(3, 5).astype(np.float32)}
    outs = []
    for mod, cm, sm, nm, run in (
            (pt, ref_core, ref_scope, ref_names,
             lambda f, sc: RefExecutor().run(feed=feed, fetch_list=f,
                                             scope=sc)),
            (ptt, core, scope, unique_name,
             lambda f, sc: ptt.Executor(ptt.CPUPlace()).run(
                 feed=feed, fetch_list=f, scope=sc))):
        with _guard(cm, sm, nm) as sc:
            a = mod.layers.data("a", shape=[3, 5], dtype="float32")
            b = mod.layers.data("b", shape=[3, 5], dtype="float32",
                                append_batch_size=False)
            outs.append(run([mod.layers.elementwise_add(a, b, axis=1),
                             mod.layers.elementwise_mul(a, b, axis=1)], sc))
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    np.testing.assert_allclose(outs[1][1], feed["a"] * feed["b"],
                               rtol=1e-6)
    assert ctr.NUM_SPARSE_SLOTS == ref_ctr.NUM_SPARSE_SLOTS == 26


# ---------------------------------------------------------------------------
# the DeepFM over the parameter server
# ---------------------------------------------------------------------------

def _one_process_losses(feeds, sparse_dim):
    """The DeepFM on one process from the runner's startup, over both
    trainers' batches concatenated."""
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    main, startup = Program(), Program()
    with program_guard(main, startup):
        loss, _, _ = build_ctr_train(sparse_dim=sparse_dim, embed_size=16,
                                     is_sparse=True)
        opt.SGD(learning_rate=0.2).minimize(loss)
    sc, exe = Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=1234)
    return [float(exe.run(main, feed=fd, fetch_list=[loss], scope=sc)[0])
            for fd in feeds]


def test_deepfm_sync_gang_matches_one_process(tmp_path):
    """The DeepFM (shared slot-offset tables as row-sharded server tables)
    in a sync gang of 2 trainers: their dense parameters are equal bit for
    bit after every step, and the mean of their losses is the loss of one
    process on both batches, within 1e-4."""
    from paddle_tpu_torch.tools.ps_runner import deepfm_batches
    steps, batch, dim = 6, 16, SPARSE_DIM
    results, _ = deepfm_gang(tmp_path, 2, "--mode", "sync", "--batch",
                             str(batch), "--steps", str(steps))
    r = {x["trainer_id"]: x for x in results}
    assert r[0]["digests"] == r[1]["digests"]
    assert "fused_dense_act" in r[0]["fused"]
    assert all(b > 0 for b in r[0]["bytes_pushed"] + r[0]["bytes_pulled"])
    f0, f1 = deepfm_batches(0, batch, dim), deepfm_batches(1, batch, dim)
    feeds = []
    for s in range(steps):
        a, b = f0(s), f1(s)
        feeds.append({k: np.concatenate([a[k], b[k]]) for k in a})
    one = _one_process_losses(feeds, dim)
    mean = [(x + y) / 2 for x, y in zip(r[0]["losses"], r[1]["losses"])]
    np.testing.assert_allclose(mean, one, rtol=1e-4)
