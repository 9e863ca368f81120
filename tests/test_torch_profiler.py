"""The port's ``profiler.py`` against the JAX package's, on the CPU.

- the host API: ``RecordEvent`` events land in ``profiler_report`` and in
  ``chrome_trace`` beside the step tracer's spans, on one epoch axis;
- a ``SamplingProfiler`` configured through ``FLAGS_profile_sample_*`` and
  driven by a real CPU ``Executor`` opens and closes its windows on the
  same ``[start, end)`` step ranges as the reference's sampler fed the same
  step ids; each window holds a Kineto ``trace.json.gz`` and a
  ``summary.json`` whose steps are the window's (host ranges: the host has
  no device time), and the manifest has the reference's schema;
- rotation at ``max_windows`` deletes the oldest windows;
- the regression trigger's warm-up and hysteresis open the same windows
  as the reference's on the same median sequence;
- a failed open counts ``paddle_tpu_profile_windows_total{outcome=
  "error"}`` and leaves no directory; the executor's dispatch ledger and
  the profiler's ``dispatch_stats`` aggregate.
"""

import json
import os
import warnings

import jax
import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu import profiler as ref_profiler
from paddle_tpu_torch import flags, monitor, profiler
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework import core, executor, unique_name
from paddle_tpu_torch.models import transformer as T
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CFG = dict(vocab_size=64, d_model=32, n_layer=2, n_head=4, d_inner=64,
           max_pos=16, dropout=0.0)
_SAMPLE_FLAGS = ("FLAGS_profile_sample_every_n_steps",
                 "FLAGS_profile_sample_window_steps",
                 "FLAGS_profile_sample_dir",
                 "FLAGS_profile_sample_max_windows",
                 "FLAGS_profile_sample_regress_frac")


@pytest.fixture(autouse=True)
def _restore_sampler():
    saved = flags.get_flags(list(_SAMPLE_FLAGS))
    yield
    profiler.SAMPLER.close()
    flags.set_flags(saved)


@pytest.fixture
def ref_sampler(monkeypatch):
    """A fresh reference sampler whose jax.profiler calls do nothing (only
    its window bookkeeping is compared)."""
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    from paddle_tpu.analysis import device_profile as ref_dp
    monkeypatch.setattr(ref_dp, "summarize_and_publish", lambda d: None)
    return ref_profiler.SamplingProfiler()


def _windows(base):
    with open(os.path.join(base, "manifest.json")) as f:
        return json.load(f)["windows"]


def _ranges(base):
    return [(os.path.basename(w["dir"]), w["start_step"], w["end_step"],
             w["trigger"]) for w in _windows(base)]


def _tiny_train():
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup), unique_name.guard():
        _, _, loss = T.build_gpt_pretrain(T.BertConfig(**CFG), 16,
                                          attn_impl="flash",
                                          fused_head=True, dropout=0.0)
        opt.AdamOptimizer(1e-3).minimize(loss)
    scope, exe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope, seed=1)
    ids = np.random.RandomState(0).randint(1, 64, (2, 16)).astype(np.int64)
    feed = {"src_ids": ids, "lm_label": np.roll(ids, -1, 1)}
    return exe, main, scope, feed, loss


def test_record_event_report_and_chrome_trace(tmp_path):
    profiler.reset_profiler()
    with profiler.RecordEvent("outside"):
        pass                                  # not recorded: profiler off
    with profiler.profiler(profile_path=str(tmp_path / "t.json")):
        for _ in range(3):
            with profiler.RecordEvent("outer"):
                with profiler.record_event("inner"):
                    pass
        with monitor.span("host.span", "test"):
            pass
    rep = profiler.profiler_report()
    assert set(rep) == {"outer", "inner"}
    assert rep["outer"]["calls"] == 3 and rep["inner"]["calls"] == 3
    assert rep["outer"]["total_us"] >= rep["inner"]["total_us"]
    events = json.load(open(tmp_path / "t.json"))["traceEvents"]
    ours = [e for e in events if e["name"] in ("outer", "inner")]
    span, = [e for e in events if e["name"] == "host.span"]
    assert len(ours) == 6
    # one epoch axis: the events lie within a second of the tracer's span
    assert all(abs(e["ts"] - span["ts"]) < 1e6 for e in ours)
    profiler.reset_profiler()
    assert profiler.profiler_report() == {}


def test_sampled_windows_match_reference(tmp_path, ref_sampler):
    # the startup run before the sampler is on: both samplers see the
    # same 9 step ids
    exe, main, scope, feed, loss = _tiny_train()
    base = str(tmp_path / "port")
    flags.set_flags({"FLAGS_profile_sample_every_n_steps": 3,
                     "FLAGS_profile_sample_window_steps": 2,
                     "FLAGS_profile_sample_dir": base,
                     "FLAGS_profile_sample_max_windows": 8})
    ref_base = str(tmp_path / "ref")
    ref_sampler.configure(3, 2, ref_base, 8)
    ids = []
    for _ in range(9):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        ids.append(executor.last_step_id())
    profiler.SAMPLER.close()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in ids:
            ref_sampler.on_step(i)
        ref_sampler.close()
    assert ids == list(range(ids[0], ids[0] + 9))
    got, want = _ranges(base), _ranges(ref_base)
    assert got == want and len(got) >= 2
    for w in _windows(base):
        assert set(w) == {"dir", "start_step", "end_step", "wall_start",
                          "wall_end", "trigger"}
        assert w["wall_start"] <= w["wall_end"]
        assert sorted(os.listdir(w["dir"])) == ["summary.json",
                                                 "trace.json.gz"]
        s = json.load(open(os.path.join(w["dir"], "summary.json")))
        # the host's steps: spans from the host ranges, no device time
        assert [r["step"] for r in s["steps"]] == list(
            range(w["start_step"], w["end_step"]))
        assert all(r["device_ms"] == 0.0 and r["span_ms"] > 0
                   for r in s["steps"])


def test_rotation_keeps_newest_windows(tmp_path, ref_sampler):
    exe, main, scope, feed, loss = _tiny_train()
    base = str(tmp_path / "port")
    flags.set_flags({"FLAGS_profile_sample_every_n_steps": 2,
                     "FLAGS_profile_sample_window_steps": 1,
                     "FLAGS_profile_sample_dir": base,
                     "FLAGS_profile_sample_max_windows": 2})
    ref_base = str(tmp_path / "ref")
    ref_sampler.configure(2, 1, ref_base, 2)
    ids = []
    for _ in range(10):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        ids.append(executor.last_step_id())
    profiler.SAMPLER.close()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in ids:
            ref_sampler.on_step(i)
        ref_sampler.close()
    got = _ranges(base)
    assert got == _ranges(ref_base) and len(got) == 2
    on_disk = sorted(d for d in os.listdir(base) if d.startswith("window_"))
    assert on_disk == [g[0] for g in got]


def test_regression_trigger_matches_reference(tmp_path, ref_sampler):
    sampler = profiler.SamplingProfiler()
    sampler.configure(0, 2, str(tmp_path / "port"), 8, regress_frac=0.5)
    ref_sampler.configure(0, 2, str(tmp_path / "ref"), 8, regress_frac=0.5)
    # warm-up (8 medians) at 10 ms, a regression to 20 ms, recovery to
    # 12 ms (within half the threshold: re-arms), a second regression
    meds = [10.0] * 9 + [20.0] * 4 + [12.0] * 3 + [16.0] * 3 + [25.0] * 3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, ms in enumerate(meds, start=100):
            sampler.on_step(i, ms)
            ref_sampler.on_step(i, ms)
        sampler.close()
        ref_sampler.close()
    got = _ranges(str(tmp_path / "port"))
    assert got == _ranges(str(tmp_path / "ref"))
    assert [g[3] for g in got] == ["regress", "regress"]


def test_trigger_window_and_failed_open(tmp_path, monkeypatch):
    sampler = profiler.SamplingProfiler()
    sampler.configure(0, 1, str(tmp_path), 8)
    ctr = monitor.REGISTRY.counter("paddle_tpu_profile_windows_total",
                                   "", ("outcome",))
    errors = ctr.value(outcome="error")

    def broken():
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(profiler, "_kineto_profile", broken)
    assert sampler.trigger_window(41, trigger="oom") is False
    assert ctr.value(outcome="error") == errors + 1
    assert "profiler unavailable" in profiler.last_window_error()
    assert os.listdir(tmp_path) == []
    monkeypatch.undo()
    assert sampler.trigger_window(41, trigger="oom") is True
    assert sampler.trigger_window(42) is False       # one window at a time
    empties = ctr.value(outcome="empty")
    sampler.close()                                  # saw no step
    assert ctr.value(outcome="empty") == empties + 1
    assert os.listdir(tmp_path) == []


def test_dispatch_ledger_and_aggregate():
    exe, main, scope, feed, loss = _tiny_train()
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    h, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                 return_numpy=False)
    float(np.asarray(h))
    st = exe.dispatch_stats()
    assert set(st) == set(executor._DispatchStats._INT_FIELDS) | set(
        executor._DispatchStats._US_FIELDS) | {
            "steps_in_flight", "compiled_blocks", "max_in_flight"}
    assert st["steps_dispatched"] == 5 and st["traces"] == 2
    assert st["cache_hits"] == 3 and st["cache_misses"] == 2
    assert st["eager_fetch_steps"] == 4 and st["lazy_fetch_steps"] == 1
    assert st["fetch_materializations"] == 4
    assert st["time_to_dispatch_us"] > 0
    assert st["host_block_us"] == pytest.approx(
        st["materialize_block_us"] + st["throttle_block_us"]
        + st["benchmark_sync_us"])
    after = profiler.dispatch_stats()
    assert after["steps_dispatched"] >= st["steps_dispatched"]
    assert after["executors"] >= 1
    mfu = monitor.REGISTRY.get("paddle_tpu_step_mfu").value(
        executor=str(exe._stats.serial))
    assert 0 < mfu < 1
    flags.set_flags({"FLAGS_benchmark": True})
    try:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    finally:
        flags.set_flags({"FLAGS_benchmark": False})
    assert exe.dispatch_stats()["benchmark_sync_us"] > 0
    serial = str(exe._stats.serial)
    retired = monitor.REGISTRY.get(
        "paddle_tpu_executor_steps_dispatched").value(executor="retired")
    del exe, h
    import gc
    gc.collect()
    fam = monitor.REGISTRY.get("paddle_tpu_executor_steps_dispatched")
    assert serial not in {labels["executor"] for labels, _ in fam.series()}
    assert fam.value(executor="retired") == retired + 6


def test_analytic_gauges_follow_the_dispatched_plan():
    """The window's measured MFU divides by the analytic flops gauge: it
    holds the flops of the program dispatched last (batch 2, then 1, then
    2 again), not of the one planned last."""
    exe, main, scope, feed, loss = _tiny_train()
    small = {"src_ids": feed["src_ids"][:1], "lm_label": feed["lm_label"][:1]}
    gauge = monitor.REGISTRY.get("paddle_tpu_analytic_step_flops")
    seen = []
    for f in (feed, small, feed):
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        seen.append(gauge.value())
    planned = sorted(p.cost_info[0] for p in exe._plans.values()
                     if p.fetch_names == (loss.name,))
    assert seen[0] == seen[2] == planned[1] > seen[1] == planned[0]


def test_dispatch_span_carries_step_id():
    exe, main, scope, feed, loss = _tiny_train()
    monitor.TRACER.clear()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    sid = executor.last_step_id()
    spans = {e["name"]: e for e in monitor.TRACER.chrome_events()
             if e.get("ph") == "X"}
    assert spans["executor.dispatch"]["args"] == {"step": sid}
    assert spans["fetch.materialize"]["args"]["step"] == sid
