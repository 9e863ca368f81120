"""The port's numerics plane (``analysis/numerics.py``) against the JAX
package's, on the CPU.

- the packed stats vector: the same seeded grads, activations and weight
  pairs through both packages' ``build_step_stats``, in ``sentinel`` and
  ``full`` mode, give the same layout, equal counts, absmax and
  histograms, and sums of squares within 1e-5 relative; the reference's
  pack/unpack, element-count, tensor-level sentinel, poisoned-weight,
  empty-block and rank-stacked cases;
- the engine: the same frame sequence through both engines gives the same
  anomaly records, spikes (with hysteresis and a frozen window) and
  quarantine; the top-K gauge churn stays bounded with exact totals;
- through the executor: a small MLP trains to the same losses in both
  packages at ``sentinel`` (weights carried across) with equal global grad
  norms, to the same loss fingerprint across the three modes, re-plans on
  a mode flip, batches its reductions (a few ``_foreach_norm`` calls a
  step, not one a gradient), and full mode publishes per-variable stats;
  the compiler's census equals the reference's;
- the poison drill (``numerics.poison``) trips the engine once, bumps the
  quarantine counter once and holds the checkpoint daemon's capture; an
  anomaly opens a profiler window with ``trigger: "anomaly"``;
- the decode logits sentinel, the flag's validation, and the AMP loss
  scaler's anomaly records.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import layers as ref_layers
from paddle_tpu.analysis import numerics as ref_numerics
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu_torch import flags, layers, monitor, profiler
from paddle_tpu_torch.analysis import numerics
from paddle_tpu_torch.analysis.numerics import (
    ENGINE, NumericsFrame, StatsLayout, build_step_stats, loss_fingerprint)
from paddle_tpu_torch.framework import core, scope as scope_mod, unique_name
from _port_fixtures import collect_garbage_after_module  # noqa: F401

_DEFAULTS = {"FLAGS_numerics": "off", "FLAGS_numerics_spike_factor": 10.0,
             "FLAGS_numerics_window": 16, "FLAGS_numerics_topk": 8,
             "FLAGS_numerics_quarantine": True}


@pytest.fixture(autouse=True)
def _isolation(monkeypatch, tmp_path):
    """Fresh port default programs, scope and names; both engines reset and
    both planes off after each test; anomaly windows under tmp_path."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope_mod._scope_stack.append(scope_mod.Scope())
    monkeypatch.setattr(profiler.SAMPLER, "base_dir", str(tmp_path))
    ENGINE.reset()
    ref_numerics.ENGINE.reset()
    with unique_name.guard():
        yield
    profiler.SAMPLER.close()
    flags.set_flags(dict(_DEFAULTS, FLAGS_fault_inject=""))
    pt.set_flags(_DEFAULTS)
    ENGINE.reset()
    ref_numerics.ENGINE.reset()
    scope_mod._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


def _frame(layout, vec, step=1):
    return NumericsFrame(step, np.asarray(vec, np.float64), layout)


def _pack(mode, values, written, rw=(), rw_in=(), rw_out=()):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in values.items()}
    return build_step_stats(t, set(written), (), tuple(rw),
                            [torch.from_numpy(np.asarray(v)) for v in rw_in],
                            [torch.from_numpy(np.asarray(v)) for v in rw_out],
                            mode)


def _ref_pack(mode, values, written, rw=(), rw_in=(), rw_out=()):
    import jax.numpy as jnp
    return ref_numerics.build_step_stats(
        {k: jnp.asarray(v) for k, v in values.items()}, set(written), (),
        tuple(rw), [jnp.asarray(v) for v in rw_in],
        [jnp.asarray(v) for v in rw_out], mode)


# -- the packed vector against the reference's -------------------------------

def _case(kind):
    rng = np.random.RandomState(7)
    vals = {"fc_0.w_0@GRAD": rng.randn(16, 8).astype(np.float32),
            "fc_0.b_0@GRAD": rng.randn(8).astype(np.float32),
            "fc_1.w_0@GRAD": (rng.randn(8, 4) * 1e-4).astype(np.float32),
            "loss@GRAD": np.ones((), np.float32),
            "h": (rng.randn(4, 8) * 300).astype(np.float32),
            "h2": rng.randn(4, 4).astype(np.float32),
            "ids": rng.randint(0, 5, (4,)).astype(np.int64),
            "fc_0.w_0": rng.randn(16, 8).astype(np.float32),
            "fc_1.w_0": rng.randn(8, 4).astype(np.float32),
            "lr": np.full((1,), 0.1, np.float32)}
    rw = ("fc_0.w_0", "fc_1.w_0", "lr")
    rw_in = [vals[n] + rng.randn(*vals[n].shape).astype(np.float32) * 1e-3
             for n in rw]
    if kind == "nan_grad":
        vals["fc_0.b_0@GRAD"][3] = np.nan
        vals["fc_1.w_0@GRAD"][0, 1] = np.inf
    elif kind == "nan_act":
        vals["h"][1, 2] = np.nan
    elif kind == "nan_weight":
        vals["fc_1.w_0"][2, 2] = -np.inf
    rw_out = [vals[n] for n in rw]
    return vals, set(vals), rw, rw_in, rw_out


@pytest.mark.parametrize("kind", ["clean", "nan_grad", "nan_act",
                                  "nan_weight"])
@pytest.mark.parametrize("mode", ["sentinel", "full"])
def test_vector_matches_reference_slot_for_slot(mode, kind):
    vals, written, rw, rw_in, rw_out = _case(kind)
    rl, rp = _ref_pack(mode, vals, written, rw, rw_in, rw_out)
    pl, pp = _pack(mode, vals, written, rw, rw_in, rw_out)
    assert (pl.mode, pl.grads, pl.weights, pl.size) == \
        (rl.mode, rl.grads, rl.weights, rl.size)
    r, p = np.asarray(rp, np.float64), pp.numpy().astype(np.float64)
    assert p.shape == r.shape == (rl.size,)
    h = StatsLayout.HEADER
    exact = [0, 1, 2, 4, 5]                   # counts and absmax
    sq = [3]
    if mode == "full":
        for i in range(len(rl.grads)):
            sq.append(h + 3 * i)
            exact += [h + 3 * i + 1, h + 3 * i + 2]
        off = h + 3 * len(rl.grads)
        sq += list(range(off, off + 2 * len(rl.weights)))
        exact += list(range(off + 2 * len(rl.weights), rl.size))
    np.testing.assert_array_equal(p[exact], r[exact])
    np.testing.assert_allclose(p[sq], r[sq], rtol=1e-5, atol=0)
    # the sentinel watches grads and weight state, not activations
    seen = kind != "clean" and not (mode == "sentinel" and kind == "nan_act")
    assert (_frame(pl, p).nonfinite > 0) == seen


def test_full_pack_unpack_roundtrip():
    g = np.array([[1.0, -2.0], [2.0, 4.0]], np.float32)
    act = np.array([0.5, -8.0, 0.25], np.float32)
    w_old = np.ones((2, 2), np.float32)
    w_new = w_old - 0.1
    layout, packed = _pack(
        "full", {"w@GRAD": g, "h": act, "w": w_new}, ["w@GRAD", "h", "w"],
        rw=["w"], rw_in=[w_old], rw_out=[w_new])
    assert layout.mode == "full"
    assert layout.grads == ("w@GRAD",) and layout.weights == ("w",)
    assert packed.shape == (layout.size,)
    f = _frame(layout, packed.numpy(), step=3)
    assert f.step == 3 and f.nonfinite == 0
    assert f.global_gnorm == pytest.approx(np.sqrt((g ** 2).sum()))
    assert f.grads["w@GRAD"]["norm"] == pytest.approx(
        np.sqrt((g ** 2).sum()))
    assert f.grads["w@GRAD"]["absmax"] == pytest.approx(4.0)
    assert f.act_absmax == pytest.approx(8.0)
    exp = np.sqrt((0.1 ** 2 * 4) / (w_new ** 2).sum())
    assert f.weights["w"]["update_ratio"] == pytest.approx(exp, rel=1e-5)
    assert f.grad_hist.sum() == g.size and f.act_hist.sum() == act.size
    assert NumericsFrame.range_bits(f.grad_hist) >= 2


def test_full_counts_nonfinite_elements():
    g = np.array([1.0, np.nan, np.inf, 2.0], np.float32)
    layout, packed = _pack("full", {"w@GRAD": g}, ["w@GRAD"])
    f = _frame(layout, packed.numpy())
    assert f.nonfinite_grad == 2 and f.grads["w@GRAD"]["nonfinite"] == 2
    assert f.grad_hist.sum() == 2        # non-finite never lands in a bin


def test_sentinel_is_tensor_level_and_cheap():
    layout, packed = _pack(
        "sentinel", {"a@GRAD": np.ones((4,), np.float32),
                     "b@GRAD": np.array([1.0, np.nan], np.float32)},
        ["a@GRAD", "b@GRAD"])
    assert layout.mode == "sentinel" and layout.size == StatsLayout.HEADER
    f = _frame(layout, packed.numpy())
    assert f.nonfinite_grad == 1          # tensors, not elements
    assert not f.grads and not np.isfinite(f.global_gnorm)


def test_sentinel_catches_poisoned_weight_state_not_just_grads():
    layout, packed = _pack(
        "sentinel", {"w@GRAD": np.zeros(2, np.float32)}, ["w@GRAD"],
        rw=["w"], rw_in=[np.ones(2, np.float32)],
        rw_out=[np.array([np.nan, 1.0], np.float32)])
    f = _frame(layout, packed.numpy())
    assert f.nonfinite_weight == 1 and f.nonfinite > 0


def test_empty_block_opts_out_unless_forced():
    assert _pack("sentinel", {}, []) == (None, None)
    layout, packed = build_step_stats({}, set(), (), (), [], [],
                                      "sentinel", force=True)
    assert layout is not None
    assert packed.shape == (StatsLayout.HEADER,) and float(packed.sum()) == 0


def test_rank_stacked_frame_combines():
    layout, packed = _pack("sentinel",
                           {"w@GRAD": np.array([3.0, 4.0], np.float32)},
                           ["w@GRAD"])
    v = packed.numpy()
    bad = v.copy()
    bad[0] = 2.0
    f = _frame(layout, np.stack([v, bad]))
    assert f.nonfinite_grad == 2 and f.global_gnorm == pytest.approx(5.0)


# -- the engine --------------------------------------------------------------

def _full_frame_for(mod, gnorms, step, nonfinite=0.0):
    names = tuple(sorted(gnorms))
    layout = mod.StatsLayout("full", names, ())
    vec = np.zeros(layout.size, np.float64)
    vec[0] = nonfinite
    vec[3] = sum(v * v for v in gnorms.values())
    for i, n in enumerate(names):
        vec[mod.StatsLayout.HEADER + 3 * i] = gnorms[n] ** 2
    return mod.NumericsFrame(step, vec, layout)


def _records(engine):
    return [{k: v for k, v in r.items() if k != "t"}
            for r in engine.anomalies]


def test_engines_trip_alike_on_the_same_frames(monkeypatch):
    """One sequence of frames (a stable median, a spike, a sustained spike,
    recovery, a second spike, then a non-finite episode of three frames, a
    clean one and another episode) through both engines."""
    import paddle_tpu.profiler as ref_profiler
    monkeypatch.setattr(ref_profiler.SAMPLER, "trigger_window",
                        lambda *a, **k: False)
    monkeypatch.setattr(profiler.SAMPLER, "trigger_window",
                        lambda *a, **k: False)
    seq = [({"a@GRAD": 1.0, "b@GRAD": 2.0}, 0.0)] * 8 + [
        ({"a@GRAD": 50.0, "b@GRAD": 2.1}, 0.0),
        ({"a@GRAD": 49.0, "b@GRAD": 2.0}, 0.0),
        ({"a@GRAD": 1.0, "b@GRAD": 40.0}, 0.0),
        ({"a@GRAD": 1.1, "b@GRAD": 2.0}, 0.0),
        ({"a@GRAD": 0.9, "b@GRAD": 2.0}, 0.0),
        ({"a@GRAD": 70.0, "b@GRAD": 2.0}, 0.0),
        ({"a@GRAD": 1.0, "b@GRAD": 2.0}, 3.0),
        ({"a@GRAD": 1.0, "b@GRAD": 2.0}, 1.0),
        ({"a@GRAD": 1.0, "b@GRAD": 2.0}, 2.0),
        ({"a@GRAD": 1.0, "b@GRAD": 2.0}, 0.0),
        ({"a@GRAD": 1.0, "b@GRAD": 2.0}, 5.0)]
    for step, (g, nf) in enumerate(seq, 1):
        ref_numerics.ENGINE._process(_full_frame_for(ref_numerics, g, step,
                                                     nf))
        ENGINE._process(_full_frame_for(numerics, g, step, nf))
    got, want = _records(ENGINE), _records(ref_numerics.ENGINE)
    assert got == want
    kinds = [r["kind"] for r in got]
    assert kinds.count("grad_spike") == 3 and kinds.count("nonfinite") == 2
    assert numerics.poisoned_since() == ref_numerics.poisoned_since() == 15
    assert ENGINE._windows.keys() == ref_numerics.ENGINE._windows.keys()
    for n in ENGINE._windows:
        assert list(ENGINE._windows[n]) == \
            list(ref_numerics.ENGINE._windows[n])


def test_engine_nonfinite_trip_latches_once_and_quarantines():
    before = monitor.counter_totals()
    for step in (5, 6, 7):
        ENGINE._process(_full_frame_for(numerics, {"w@GRAD": 1.0}, step,
                                        nonfinite=3.0))
    recs = [r for r in ENGINE.anomalies if r["kind"] == "nonfinite"]
    assert len(recs) == 1 and recs[0]["step"] == 5
    assert numerics.is_poisoned() and numerics.poisoned_since() == 5
    after = monitor.counter_totals()
    assert after["paddle_tpu_numerics_anomalies_total"] - \
        before.get("paddle_tpu_numerics_anomalies_total", 0) == 1
    assert after["paddle_tpu_numerics_nonfinite_total"] - \
        before.get("paddle_tpu_numerics_nonfinite_total", 0) == 9
    numerics.clear_quarantine()
    assert not numerics.is_poisoned()


def test_engine_spike_detection_with_hysteresis():
    flags.set_flags({"FLAGS_numerics_spike_factor": 10.0})
    step = [0]

    def feed(v):
        step[0] += 1
        ENGINE._process(_full_frame_for(numerics, {"w@GRAD": v}, step[0]))

    def spikes():
        return [r for r in ENGINE.anomalies if r["kind"] == "grad_spike"]

    for _ in range(8):
        feed(1.0)
    assert not spikes()
    feed(50.0)
    assert len(spikes()) == 1 and spikes()[0]["var"] == "w@GRAD"
    assert spikes()[0]["value"] == pytest.approx(50.0)
    feed(49.0)                              # still high: disarmed
    assert len(spikes()) == 1 and not numerics.is_poisoned()
    for _ in range(3):
        feed(1.0)                           # recovered: re-armed
    feed(60.0)
    assert len(spikes()) == 2


def test_spike_window_does_not_self_legitimize():
    for step in range(1, 29):
        ENGINE._process(_full_frame_for(
            numerics, {"w@GRAD": 1.0 if step <= 8 else 50.0}, step))
    win = ENGINE._windows["w@GRAD"]
    assert sorted(win)[len(win) // 2] == pytest.approx(1.0)


def test_topk_gauge_churn_stays_bounded_and_totals_exact():
    flags.set_flags({"FLAGS_numerics_topk": 5})
    before = monitor.counter_totals()
    total_nf = 0
    for step in range(1, 201):
        nf = step % 3
        total_nf += nf
        ENGINE._process(_full_frame_for(
            numerics, {f"var_{step:03d}@GRAD": float(step)}, step,
            nonfinite=float(nf)))
        ENGINE._class_tripped.clear()   # each frame its own episode
    series = [lbl for lbl, _ in numerics.NUM_GNORM_GAUGE.series()]
    assert len(series) <= 5
    assert len(numerics.NUM_ABSMAX_GAUGE.series()) <= 5
    assert {"var": "var_200@GRAD"} in series
    after = monitor.counter_totals()
    assert after["paddle_tpu_numerics_nonfinite_total"] - \
        before.get("paddle_tpu_numerics_nonfinite_total", 0) == total_nf


def test_anomaly_opens_a_profiler_window(tmp_path):
    ENGINE._process(_full_frame_for(numerics, {"w@GRAD": 1.0}, 4,
                                    nonfinite=1.0))
    assert profiler.SAMPLER._active is not None
    profiler.SAMPLER.close()
    manifest = tmp_path / "manifest.json"
    if manifest.exists():   # a window that saw no step is abandoned
        windows = json.loads(manifest.read_text())["windows"]
        assert all(w["trigger"] == "anomaly" for w in windows)


# -- through the executor ----------------------------------------------------

X = np.linspace(-1, 1, 4 * 8, dtype=np.float32).reshape(4, 8)


def _mlp_port(mode, seed=3):
    flags.set_flags({"FLAGS_numerics": mode})
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup), unique_name.guard():
        x = layers.data("x", shape=[8], dtype="float32")
        h = layers.fc(x, size=16, act="relu",
                      param_attr=ptt.ParamAttr(name="w0"),
                      bias_attr=ptt.ParamAttr(name="b0"))
        loss = layers.mean(layers.fc(h, size=4,
                                     param_attr=ptt.ParamAttr(name="w1"),
                                     bias_attr=ptt.ParamAttr(name="b1")))
        ptt.optimizer.SGD(0.05).minimize(loss)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope, seed=seed)
    return exe, main, scope, loss.name


def _mlp_ref(mode, seed=3):
    pt.set_flags({"FLAGS_numerics": mode})
    main, startup = RefProgram(), RefProgram()
    with ref_guard(main, startup), ref_names.guard():
        x = ref_layers.data("x", shape=[8], dtype="float32")
        h = ref_layers.fc(x, size=16, act="relu",
                          param_attr=pt.ParamAttr(name="w0"),
                          bias_attr=pt.ParamAttr(name="b0"))
        loss = ref_layers.mean(ref_layers.fc(
            h, size=4, param_attr=pt.ParamAttr(name="w1"),
            bias_attr=pt.ParamAttr(name="b1")))
        pt.optimizer.SGD(0.05).minimize(loss)
    scope = RefScope()
    exe = RefExecutor()
    exe.run(startup, scope=scope, seed=seed)
    return exe, main, scope, loss.name


def _train(mode, steps=6):
    exe, main, scope, loss = _mlp_port(mode)
    losses = [float(exe.run(main, feed={"x": X}, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    ENGINE.poll(force=True)
    return losses, exe


def test_losses_and_norms_match_reference_at_sentinel():
    ref_exe, ref_main, ref_scope, ref_loss = _mlp_ref("sentinel")
    exe, main, scope, loss = _mlp_port("sentinel")
    for n in ("w0", "b0", "w1", "b1"):
        scope.set_var(n, torch.from_numpy(
            np.array(ref_scope.find_var(n), np.float32)))
    for _ in range(4):
        want, = ref_exe.run(ref_main, feed={"x": X}, fetch_list=[ref_loss],
                            scope=ref_scope)
        got, = exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope)
        np.testing.assert_allclose(float(got), float(np.asarray(want)),
                                   rtol=1e-5, atol=0)
        ref_numerics.ENGINE.poll(force=True)
        ENGINE.poll(force=True)
        rf, pf = ref_numerics.ENGINE.last_frame, ENGINE.last_frame
        assert pf.nonfinite == rf.nonfinite == 0
        np.testing.assert_allclose(pf.global_gnorm, rf.global_gnorm,
                                   rtol=1e-5)
    assert ENGINE.frames_processed == ref_numerics.ENGINE.frames_processed


def test_loss_parity_across_modes():
    base, _ = _train("off")
    for mode in ("sentinel", "full"):
        ENGINE.reset()
        got, _ = _train(mode)
        assert loss_fingerprint(got) == loss_fingerprint(base), mode


def test_mode_flip_replans():
    _, exe = _train("off", steps=2)
    assert ENGINE.frames_processed == 0
    exe2_losses, exe2 = _train("sentinel", steps=2)
    assert ENGINE.frames_processed >= 2
    # the same executor re-plans on a flip: the mode is in the plan key
    exe_, main, scope, loss = _mlp_port("off")
    exe_.run(main, feed={"x": X}, fetch_list=[loss], scope=scope)
    n_plans = exe_.dispatch_stats()["traces"]
    flags.set_flags({"FLAGS_numerics": "sentinel"})
    exe_.run(main, feed={"x": X}, fetch_list=[loss], scope=scope)
    assert exe_.dispatch_stats()["traces"] == n_plans + 1


def test_end_to_end_full_mode_publishes_per_var_stats():
    _train("full")
    f = ENGINE.last_frame
    assert f is not None and f.grads
    assert any(n.endswith("@GRAD") for n in f.grads)
    assert f.weights and all(0 < w["update_ratio"] < 1
                             for w in f.weights.values())
    assert set(f.weights) == {"w0", "b0", "w1", "b1"}
    assert numerics.NUM_GLOBAL_GNORM_GAUGE.value() > 0
    assert ENGINE.frames_processed >= 6
    assert numerics.NUM_RANGE_GAUGE.value(var_class="grad") > 0


def test_sentinel_batches_its_reductions(monkeypatch):
    """A sentinel step reduces its gradients in a few multi-tensor calls:
    one ``_foreach_norm`` for the step's grads (all under the flush bound)
    and one for the weight state, not one a gradient."""
    exe, main, scope, loss = _mlp_port("sentinel")
    exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope)
    calls = []
    real = torch._foreach_norm

    def counting(ts, *a, **k):
        calls.append(len(ts))
        return real(ts, *a, **k)
    monkeypatch.setattr(torch, "_foreach_norm", counting)
    exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope)
    n_grads = max(sum(1 for n in p.written if n.endswith("@GRAD"))
                  for p in exe._plans.values())
    assert n_grads >= 6
    assert len(calls) <= 3 and sum(calls) >= n_grads


def test_compiled_program_stamps_the_reference_census():
    _, main, _, loss = _mlp_port("full")
    _, ref_main, _, ref_loss = _mlp_ref("full")
    got = numerics.plan_numerics(main, (loss,))
    want = ref_numerics.plan_numerics(ref_main, (ref_loss,))
    assert got == want and got["acts"]
    # the compiler stamps the census of the program after its passes
    opt = ptt.CompiledProgram(main)._optimized([loss])
    assert opt._attrs["numerics"] == numerics.plan_numerics(opt, [loss])


def test_poison_drill_trips_once_and_holds_the_capture():
    from paddle_tpu_torch.resilience import CheckpointDaemon

    class _Ckpt:
        def __init__(self):
            self.saved = []

        def save_arrays(self, step, state, force=True, kind="daemon"):
            self.saved.append(int(step))
            return True

        def wait_until_finished(self):
            pass

        def latest_step(self):
            return max(self.saved) if self.saved else None

    exe, main, scope, loss = _mlp_port("sentinel")
    ckpt = _Ckpt()
    daemon = CheckpointDaemon(ckpt, program=main, scope=scope,
                              interval_steps=1)
    holds0 = numerics.QUARANTINE_CTR.value()
    flags.set_flags({"FLAGS_fault_inject": "numerics.poison:once@3"})
    taken = []
    for step in range(1, 7):
        exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope)
        taken.append(daemon.step_completed(step, scope=scope))
    daemon.stop()
    recs = [r for r in ENGINE.anomalies if r["kind"] == "nonfinite"]
    assert len(recs) == 1 and numerics.is_poisoned()
    assert numerics.poisoned_since() == recs[0]["step"]
    # the third step entered poisoned: its capture and every later one
    # is held, and nothing after the last healthy step is written
    assert taken == [True, True, False, False, False, False]
    assert ckpt.latest_step() == 2
    assert numerics.QUARANTINE_CTR.value() - holds0 == 4
    numerics.clear_quarantine()


def test_checkpoint_daemon_holds_capture_while_poisoned():
    from paddle_tpu_torch.resilience import CheckpointDaemon

    class _Ckpt:
        saved = []

        def save_arrays(self, step, state, force=True, kind="daemon"):
            self.saved.append(int(step))
            return True

        def wait_until_finished(self):
            pass

        def latest_step(self):
            return max(self.saved) if self.saved else None

    exe, main, scope, loss = _mlp_port("sentinel")
    ckpt = _Ckpt()
    ckpt.saved = []
    daemon = CheckpointDaemon(ckpt, program=main, scope=scope,
                              interval_steps=1)
    before = numerics.QUARANTINE_CTR.value()
    assert daemon.step_completed(1, scope=scope)
    ENGINE._process(_full_frame_for(numerics, {"w@GRAD": 1.0}, 2,
                                    nonfinite=1.0))
    assert not daemon.step_completed(2, scope=scope)
    assert not daemon.step_completed(3, scope=scope)
    assert numerics.QUARANTINE_CTR.value() - before == 2
    numerics.clear_quarantine()
    assert daemon.step_completed(4, scope=scope)
    daemon.stop()
    assert 2 not in ckpt.saved and 3 not in ckpt.saved


# -- the decode sentinel, flags, AMP ------------------------------------------

def test_serving_logits_sentinel_records_and_unlatches():
    numerics.note_nonfinite("logits", 5, step=7, detail={"slots": [0]})
    recs = [r for r in ENGINE.anomalies if r["kind"] == "nonfinite_logits"]
    assert len(recs) == 1 and recs[0]["value"] == 5
    numerics.note_nonfinite("logits", 2, step=8)
    assert len([r for r in ENGINE.anomalies
                if r["kind"] == "nonfinite_logits"]) == 1   # latched
    numerics.note_nonfinite("logits", 0, step=9)
    numerics.note_nonfinite("logits", 1, step=10)
    assert len([r for r in ENGINE.anomalies
                if r["kind"] == "nonfinite_logits"]) == 2
    assert not numerics.is_poisoned()
    assert numerics.NONFINITE_CTR.value(var_class="logits") >= 8


def test_decode_loop_counts_poisoned_logits():
    from paddle_tpu_torch.serving.scheduler import DecodeScheduler
    flags.set_flags({"FLAGS_numerics": "sentinel"})
    sched = DecodeScheduler.__new__(DecodeScheduler)
    sched._iter = 3
    logits = np.zeros((4, 6), np.float32)
    logits[1, 2] = np.nan
    logits[3, 0] = np.inf                   # slot 3 is not stepped
    sched._logits_sentinel(logits, [0, 1])
    recs = [r for r in ENGINE.anomalies if r["kind"] == "nonfinite_logits"]
    assert len(recs) == 1 and recs[0]["value"] == 1
    assert recs[0]["slots"] == [0, 1] and recs[0]["step"] == 3


def test_flag_validation():
    with pytest.raises(ValueError):
        flags.set_flags({"FLAGS_numerics": "everything"})
    assert flags.get_flags("FLAGS_numerics")["FLAGS_numerics"] == "off"
    flags.set_flags({"FLAGS_numerics": "full", "FLAGS_numerics_window": 2})
    assert numerics.mode() == "full" and numerics._CONFIG["window"] == 4


def test_amp_dynamic_loss_scaler_events_match_reference():
    from paddle_tpu.amp import DynamicLossScaler as RefScaler
    from paddle_tpu_torch.amp import DynamicLossScaler
    verdicts = [False, True, True, False, False, False, True]
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5)
    s, r = DynamicLossScaler(**kw), RefScaler(**kw)
    assert [s.update(v) for v in verdicts] == [r.update(v) for v in verdicts]
    assert s.scale == r.scale == 1024.0
    assert _records(ENGINE) == _records(ref_numerics.ENGINE)
    kinds = [x["kind"] for x in _records(ENGINE)]
    assert kinds == ["step_skipped", "loss_scale_decreased",
                     "loss_scale_increased", "step_skipped"]
    assert monitor.REGISTRY.get("paddle_tpu_amp_scale").value() == 1024.0


def test_amp_decorate_wires_scaler():
    from paddle_tpu_torch import amp
    opt = amp.decorate(ptt.optimizer.SGD(0.1), init_loss_scaling=256.0,
                       use_dynamic_loss_scaling=True)
    assert opt.loss_scaler is not None and opt._loss_scaling == 256.0
    assert amp.decorate(ptt.optimizer.SGD(0.1),
                        use_dynamic_loss_scaling=False).loss_scaler is None
