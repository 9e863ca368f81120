"""The port's parameter server trained against the JAX package's, on the
CPU: the counterparts of the training tests of ``tests/test_ps.py``.

- 1-trainer sync PS-SGD tracks local SGD and the reference's PS run;
- geo-SGD pushes deltas (dense), pushes only the touched rows of a sparse
  table (found by the scan, or recorded with ``record_rows``; a hot
  interval takes the dense fallback), runs its round trips on a thread
  and flushes, and a failed background round trip raises at the next
  boundary;
- the sparse embedding flow (``distributed_lookup_table`` pulls, row
  pushes) and a shared table with ``padding_idx``;
- the DeepFM under the PS launcher (``tools/ps_runner.py``) in one job
  running sync, async and geo in turn, a pserver a mode: sync keeps the
  trainers bit for bit, each geo round pushes at most the distinct ids fed
  since the round before, and the flush leaves nothing unpushed.

Each loss trajectory (and the server's tables) is held against the
reference's run of the same scenario on the same weights (the reference's
startup values, loaded into the port with ``params_from_numpy`` and put
into both servers) and feeds, within the reference test's tolerances where
it has them (``SYNC_TOL``) and ``TRAJ_TOL`` where it trains without one.
The deadlines are ``test_torch_ps.py``'s.
"""

import contextlib

import numpy as np
import pytest

from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import core as ref_core
from paddle_tpu_torch import flags
from paddle_tpu_torch.io import params_from_numpy
from _port_fixtures import collect_garbage_after_module  # noqa: F401
from _ps_helpers import fresh_ps_state  # noqa: F401
from _ps_helpers import (JOIN_S, PORT, REF, SYNC_TOL, TRAJ_TOL, W_TRUE,
                         deepfm_gang, free_port, host, isolated, regression,
                         seed_tables, serving)


# ---------------------------------------------------------------------------
# the ops and the transpiler, trained
# ---------------------------------------------------------------------------

def _regression_feeds(steps):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        xv = rng.rand(16, 4).astype(np.float32)
        out.append({"x": xv, "y": xv @ W_TRUE})
    return out


def _train_local(pkg, steps=25):
    with isolated(pkg) as sc:
        loss = regression(pkg, "w_local")
        pkg.opt.SGD(learning_rate=0.1).minimize(loss)
        exe = pkg.exe()
        exe.run(pkg.core.default_startup_program(), scope=sc)
        losses = [float(np.asarray(exe.run(
            feed=fd, fetch_list=[loss], scope=sc)[0]))
            for fd in _regression_feeds(steps)]
        return losses, host(sc.find_var("w_local")).copy()


def _train_ps_sync(pkg, steps=25):
    with isolated(pkg) as sc:
        loss = regression(pkg, "w")
        pkg.opt.SGD(learning_rate=0.1).minimize(loss)
        ep = f"127.0.0.1:{free_port()}"
        t = pkg.ps.DistributeTranspiler()
        t.transpile(0, pservers=ep, trainers=1)
        trainer = t.get_trainer_program()
        exe = pkg.exe()
        with serving(pkg, t, ep):
            exe.run(pkg.core.default_startup_program(), scope=sc)
            losses = [float(np.asarray(exe.run(
                trainer, feed=fd, fetch_list=[loss], scope=sc)[0]))
                for fd in _regression_feeds(steps)]
            return losses, host(sc.find_var("w")).copy()


def test_ps_sync_matches_local():
    """1-trainer PS-SGD tracks local SGD step for step, and the reference's
    PS run of the same scenario."""
    local_losses, local_w = _train_local(PORT)
    ps_losses, w_ps = _train_ps_sync(PORT)
    ref_losses, ref_w = _train_ps_sync(REF)
    np.testing.assert_allclose(ps_losses, local_losses, **SYNC_TOL)
    np.testing.assert_allclose(w_ps.ravel(), local_w.ravel(), rtol=1e-3)
    np.testing.assert_allclose(ps_losses, ref_losses, **SYNC_TOL)
    np.testing.assert_allclose(w_ps.ravel(), ref_w.ravel(), rtol=1e-3)


def _geo_regression(pkg, steps=10):
    with isolated(pkg) as sc:
        loss = regression(pkg, "wg")
        pkg.opt.SGD(learning_rate=0.1).minimize(loss)
        ep = f"127.0.0.1:{free_port()}"
        cfg = pkg.ps.DistributeTranspilerConfig(
            geo_sgd_mode=True, geo_sgd_need_push_nums=5, sync_mode=False)
        t = pkg.ps.DistributeTranspiler(cfg)
        t.transpile(0, pservers=ep, trainers=1)
        trainer = t.get_trainer_program()       # keeps the local optimizer
        assert "sgd" in [op.type for op in trainer.global_block().ops]
        exe = pkg.exe()
        with serving(pkg, t, ep):
            exe.run(pkg.core.default_startup_program(), scope=sc)
            geo = pkg.ps.GeoCommunicator(t, scope=sc)
            geo.init_snapshots()
            losses = []
            for fd in _regression_feeds(steps):
                losses.append(float(np.asarray(exe.run(
                    trainer, feed=fd, fetch_list=[loss], scope=sc)[0])))
                geo.step()
            srv_w = pkg.ps.get_client(ep).get("wg", 4, barrier=False)
            local_w = host(sc.find_var("wg")).ravel()
            return losses, srv_w, local_w


def test_geo_sgd_pushes_deltas():
    losses, srv_w, local_w = _geo_regression(PORT)
    # after 10 steps at a push interval of 5 the server holds the merged
    # params, not 0
    np.testing.assert_allclose(srv_w, local_w, rtol=1e-5)
    assert np.abs(srv_w).sum() > 0.1
    ref_losses, ref_srv, _ = _geo_regression(REF)
    np.testing.assert_allclose(losses, ref_losses, **TRAJ_TOL)
    np.testing.assert_allclose(srv_w, ref_srv, rtol=1e-5)


def _ref_startup_values(build, names=None):
    """The reference's startup values of the program ``build`` makes."""
    with isolated(REF) as sc:
        build(REF)
        RefExecutor().run(ref_core.default_startup_program(), scope=sc)
        main = ref_core.default_main_program()
        names = names or [p.name for p in main.all_parameters()]
        return {n: np.asarray(sc.find_var(n)).copy() for n in names}


def _sparse_model(pkg):
    ids = pkg.layers.data("ids", shape=[4], dtype="int64")
    label = pkg.layers.data("label", shape=[1], dtype="float32")
    emb = pkg.layers.embedding(ids, size=[60, 8], is_sparse=True,
                               param_attr=pkg.root.ParamAttr(name="emb_w"))
    pred = pkg.layers.fc(pkg.layers.reduce_sum(emb, dim=[1]), size=1,
                         param_attr=pkg.root.ParamAttr(name="fc_w"),
                         bias_attr=False)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, label))
    pkg.opt.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _sparse_flow(pkg, init):
    with isolated(pkg) as sc:
        loss = _sparse_model(pkg)
        ep = f"127.0.0.1:{free_port()}"
        t = pkg.ps.DistributeTranspiler()
        t.transpile(0, pservers=ep, trainers=1)
        assert t._param_specs["emb_w"]["rows"] == 60
        trainer = t.get_trainer_program()
        types = [op.type for op in trainer.global_block().ops]
        assert "distributed_lookup_table" in types
        assert "lookup_table" not in types
        exe = pkg.exe()
        with serving(pkg, t, ep):
            exe.run(pkg.core.default_startup_program(), scope=sc)
            if pkg is PORT:
                params_from_numpy(sc, init)
            seed_tables(pkg, t, sc, init)
            cli = pkg.ps.get_client(ep)
            before = cli.get_rows("emb_w", np.arange(60), 8).copy()
            rng = np.random.RandomState(0)
            losses, touched = [], set()
            for _ in range(15):
                iv = rng.randint(0, 30, (8, 4)).astype(np.int64)
                touched.update(iv.ravel().tolist())
                yv = (iv.sum(1, keepdims=True) / 60.0).astype(np.float32)
                losses.append(float(np.asarray(exe.run(
                    trainer, feed={"ids": iv, "label": yv},
                    fetch_list=[loss], scope=sc)[0])))
            after = cli.get_rows("emb_w", np.arange(60), 8)
            return losses, before, after, touched


def test_sparse_embedding_transpiler_flow():
    """is_sparse embedding → distributed_lookup_table row pulls and sparse
    row-gradient pushes: touched rows train on the server, untouched rows
    stay; the loss trajectory is the reference's on the same weights."""
    init = _ref_startup_values(_sparse_model)
    losses, before, after, touched = _sparse_flow(PORT, init)
    changed = np.abs(after - before).sum(1) > 1e-7
    assert changed[sorted(touched)].all()
    untouched = [i for i in range(60) if i not in touched and i >= 30]
    if untouched:
        assert not changed[untouched].any()
    assert losses[-1] < losses[0], f"no training: {losses}"
    ref_losses, _, ref_after, _ = _sparse_flow(REF, init)
    np.testing.assert_allclose(losses, ref_losses, **TRAJ_TOL)
    np.testing.assert_allclose(after, ref_after, rtol=1e-4, atol=1e-6)


def _shared_model(pkg):
    ids_a = pkg.layers.data("ids_a", shape=[2], dtype="int64")
    ids_b = pkg.layers.data("ids_b", shape=[2], dtype="int64")
    label = pkg.layers.data("label", shape=[1], dtype="float32")
    emb_a = pkg.layers.embedding(
        ids_a, size=[40, 4], is_sparse=True, padding_idx=0,
        param_attr=pkg.root.ParamAttr(name="shared_emb"))
    emb_b = pkg.layers.embedding(
        ids_b, size=[40, 4], is_sparse=True, padding_idx=0,
        param_attr=pkg.root.ParamAttr(name="shared_emb"))
    feat = pkg.layers.concat([pkg.layers.reduce_sum(emb_a, dim=[1]),
                              pkg.layers.reduce_sum(emb_b, dim=[1])], axis=1)
    pred = pkg.layers.fc(feat, size=1, bias_attr=False)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, label))
    pkg.opt.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _shared_flow(pkg, init):
    with isolated(pkg) as sc:
        loss = _shared_model(pkg)
        ep = f"127.0.0.1:{free_port()}"
        t = pkg.ps.DistributeTranspiler()
        t.transpile(0, pservers=ep, trainers=1)
        assert len(t._sparse_tables["shared_emb"]) == 2
        trainer = t.get_trainer_program()
        types = [op.type for op in trainer.global_block().ops]
        assert types.count("distributed_lookup_table") == 2
        for op in trainer.global_block().ops:     # no dense table grad
            assert "shared_emb@GRAD" not in op.output_arg_names()
        exe = pkg.exe()
        with serving(pkg, t, ep):
            exe.run(pkg.core.default_startup_program(), scope=sc)
            if pkg is PORT:
                params_from_numpy(sc, init)
            seed_tables(pkg, t, sc, init)
            rng = np.random.RandomState(0)
            losses = []
            for _ in range(10):
                a = rng.randint(0, 20, (8, 2)).astype(np.int64)
                b = rng.randint(20, 40, (8, 2)).astype(np.int64)
                a[0, 0] = 0                   # the padding id every batch
                yv = rng.rand(8, 1).astype(np.float32)
                lv = float(np.asarray(exe.run(
                    trainer, feed={"ids_a": a, "ids_b": b, "label": yv},
                    fetch_list=[loss], scope=sc)[0]))
                assert np.isfinite(lv)
                losses.append(lv)
            rows = pkg.ps.get_client(ep).get_rows("shared_emb",
                                                  np.arange(40), 4)
            return losses, rows


def test_sparse_shared_table_and_padding():
    """Two lookup sites on one sparse table with padding_idx: both sites
    pull and push rows; the padding row gets no gradient."""
    init = _ref_startup_values(_shared_model)
    losses, rows = _shared_flow(PORT, init)
    assert np.abs(rows[1:20]).sum() > 0 and np.abs(rows[20:]).sum() > 0
    np.testing.assert_array_equal(rows[0], init["shared_emb"][0])
    ref_losses, ref_rows = _shared_flow(REF, init)
    np.testing.assert_allclose(losses, ref_losses, **TRAJ_TOL)
    np.testing.assert_allclose(rows, ref_rows, rtol=1e-4, atol=1e-6)


def _geo_toy(pkg, push_nums=2, lr=0.1):
    ids = pkg.layers.data("ids", shape=[1], dtype="int64")
    emb = pkg.layers.embedding(ids, size=[8, 4], is_sparse=True,
                               param_attr=pkg.root.ParamAttr(name="geo_emb"))
    pred = pkg.layers.fc(pkg.layers.reduce_sum(emb, dim=[1]), size=1,
                         bias_attr=False)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(
        pred, pkg.layers.fill_constant([1, 1], "float32", 1.0)))
    pkg.opt.SGD(learning_rate=lr).minimize(loss)
    return loss


@contextlib.contextmanager
def _geo_session(pkg, init, push_nums=2, async_push=False):
    """The geo toy transpiled, served, started from ``init`` and snapshot:
    yields (exe, trainer, loss, transpiler, geo, scope, endpoint)."""
    with isolated(pkg) as sc:
        loss = _geo_toy(pkg, push_nums)
        ep = f"127.0.0.1:{free_port()}"
        cfg = pkg.ps.DistributeTranspilerConfig(
            geo_sgd_mode=True, geo_sgd_need_push_nums=push_nums,
            sync_mode=False)
        t = pkg.ps.DistributeTranspiler(cfg)
        t.transpile(0, pservers=ep, trainers=1)
        trainer = t.get_trainer_program()
        exe = pkg.exe()
        with serving(pkg, t, ep):
            exe.run(pkg.core.default_startup_program(), scope=sc)
            if pkg is PORT:
                params_from_numpy(sc, init)
            geo = pkg.ps.GeoCommunicator(t, scope=sc, async_push=async_push)
            geo.init_snapshots()
            yield exe, trainer, loss, t, geo, sc, ep


def _geo_init():
    return _ref_startup_values(lambda pkg: _geo_toy(pkg))


def _geo_sparse_rows(pkg, init, record):
    feed_ids = np.array([[1], [3], [1], [6]], np.int64)
    hot_ids = np.arange(8).reshape(8, 1).astype(np.int64)
    with _geo_session(pkg, init) as (exe, trainer, loss, t, geo, sc, ep):
        init_table = host(sc.find_var("geo_emb")).astype(np.float32)
        losses = []
        for _ in range(4):                        # 2 push intervals
            losses.append(float(np.asarray(exe.run(
                trainer, feed={"ids": feed_ids}, fetch_list=[loss],
                scope=sc)[0])))
            if record:
                geo.record_rows("geo_emb", feed_ids.ravel())
            geo.step()
        local = host(sc.find_var("geo_emb")).astype(np.float32)
        srv = pkg.ps.get_client(ep).get_rows("geo_emb", list(range(8)), 4)
        hot = None
        if not record:
            # a HOT interval (>= half the rows) takes the dense fallback
            for _ in range(2):
                losses.append(float(np.asarray(exe.run(
                    trainer, feed={"ids": hot_ids}, fetch_list=[loss],
                    scope=sc)[0])))
                geo.step()
            hot = (host(sc.find_var("geo_emb")).astype(np.float32),
                   pkg.ps.get_client(ep).get_rows("geo_emb",
                                                  list(range(8)), 4))
        return losses, init_table, local, np.asarray(srv), hot


@pytest.mark.parametrize("record", [False, True],
                         ids=["scan", "record_rows"])
def test_geo_sgd_sparse_row_pushes(record):
    """Geo-SGD with an is_sparse embedding pushes only the touched rows
    (found by the scan, or recorded with ``record_rows``): untouched server
    rows keep their seeded values, touched ones match the trainer; a hot
    interval takes the dense fallback (scan)."""
    init = _geo_init()
    losses, init_table, local, srv, hot = _geo_sparse_rows(PORT, init,
                                                           record)
    touched, untouched = [1, 3, 6], [0, 2, 4, 5, 7]
    np.testing.assert_allclose(srv[touched], local[touched], rtol=1e-5)
    np.testing.assert_allclose(srv[untouched], init_table[untouched],
                               rtol=1e-6)
    assert np.abs(local[touched] - init_table[touched]).max() > 1e-5
    if hot is not None:
        np.testing.assert_allclose(hot[1], hot[0], rtol=1e-5)
    ref = _geo_sparse_rows(REF, init, record)
    np.testing.assert_allclose(losses, ref[0], **TRAJ_TOL)
    np.testing.assert_allclose(srv, ref[3], rtol=1e-5, atol=1e-7)


def _geo_async(pkg, init):
    with _geo_session(pkg, init, async_push=True) as (
            exe, trainer, loss, t, geo, sc, ep):
        rng = np.random.RandomState(0)
        losses = []
        for _ in range(12):
            feed_ids = rng.randint(0, 8, (4, 1)).astype(np.int64)
            losses.append(float(np.asarray(exe.run(
                trainer, feed={"ids": feed_ids}, fetch_list=[loss],
                scope=sc)[0])))
            geo.record_rows("geo_emb", feed_ids.ravel())
            geo.step()
        geo.flush()
        pairs = {}
        for pname, spec in t._param_specs.items():
            pairs[pname] = (
                host(sc.find_var(pname)).astype(np.float32).ravel(),
                pkg.ps.get_client(ep).get(pname, spec["size"],
                                          barrier=False))
        return losses, pairs


def test_geo_async_push_converges_and_flushes():
    """async_push=True: round trips on a background thread, local drift
    kept, and flush() leaves the server equal to the trainer."""
    init = _geo_init()
    losses, pairs = _geo_async(PORT, init)
    assert losses[-1] < losses[0]
    for local, srv in pairs.values():
        np.testing.assert_allclose(srv, local, rtol=1e-5, atol=1e-6)
    ref_losses, _ = _geo_async(REF, init)
    np.testing.assert_allclose(losses, ref_losses, **TRAJ_TOL)


def test_geo_worker_error_surfaces_at_join():
    """A failed background round trip raises at the next boundary, not
    into the thread.  The reference's test stops the server; here the push
    fails by ``FLAGS_fault_inject`` (a fault on every ``ps.push_sparse``
    past the retry budget), which fails the same round trip without the
    native client's 10 s of connect attempts to a stopped server."""
    init = _geo_init()
    with _geo_session(PORT, init, async_push=True) as (
            exe, trainer, loss, t, geo, sc, ep):
        feed_ids = np.array([[1], [2]], np.int64)
        for _ in range(2):                        # first boundary: push ok
            exe.run(trainer, feed={"ids": feed_ids}, fetch_list=[loss],
                    scope=sc)
            geo.record_rows("geo_emb", feed_ids.ravel())
            geo.step()
        flags.set_flags({"FLAGS_fault_inject": "ps.push_sparse:every=1"})
        try:
            with pytest.raises(RuntimeError, match="geo background"):
                for _ in range(4):
                    exe.run(trainer, feed={"ids": feed_ids},
                            fetch_list=[loss], scope=sc)
                    geo.record_rows("geo_emb", feed_ids.ravel())
                    geo.step()
                geo.flush()
        finally:
            flags.set_flags({"FLAGS_fault_inject": ""})
        if geo._worker is not None:
            geo._worker.join(JOIN_S)
            assert not geo._worker.is_alive()


def test_deepfm_gang_runs_the_three_modes_in_turn(tmp_path):
    """One launch_ps job with a pserver a mode (``--server_num 3 --mode
    sync,async,geo``): the two trainers run the modes in turn, each against
    its own pserver; sync keeps the trainers' dense parameters equal bit
    for bit; geo (local SGD, a round every 2 steps, recorded rows) pushes
    at most the distinct ids fed since the round before, and its flush
    leaves nothing unpushed; async's trainer 0 scores the startup's and
    the server's final parameters on both trainers' first three batches;
    every pserver stops after its mode."""
    evals = []
    results, servers = deepfm_gang(
        tmp_path, 2, "--mode", "sync,async,geo", "--geo_push", "2",
        "--batch", "8", "--steps", "5", servers=3, evals=evals)
    by = {(r["mode"], r["trainer_id"]): r for r in results}
    assert sorted(by) == [(m, t) for m in ("async", "geo", "sync")
                          for t in (0, 1)]
    assert sorted(s["mode"] for s in servers) == ["async", "geo", "sync"]
    assert by["sync", 0]["digests"] == by["sync", 1]["digests"]
    for (mode, _), r in by.items():
        assert np.isfinite(r["losses"]).all()
        if mode != "geo":
            assert all(b > 0 for b in r["bytes_pushed"]) and \
                all(b > 0 for b in r["bytes_pulled"])
            continue
        rounds = r["geo_rounds"]
        assert len(rounds) == 3                    # steps 2, 4, the flush
        for rnd in rounds:
            for table in ("ctr_embedding", "ctr_wide_w"):
                pushed, fed = rnd[table]
                assert pushed is not None and 0 < pushed <= fed
    ev, = evals
    assert len(ev["init"]) == len(ev["final"]) == 6
    assert np.isfinite(ev["init"] + ev["final"]).all()
    assert ev["init"] != ev["final"]
    # the modes ran one after another
    assert by["sync", 0]["marks"]["trained"] <= \
        by["async", 0]["marks"]["mode_start"]
