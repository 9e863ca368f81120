"""The port's resilience layer against the JAX package's, on the CPU.

- ``backoff_schedule`` and ``RetryPolicy.schedule`` give the reference's
  lists exactly;
- ``retry_call`` under the same ``FLAGS_fault_inject`` specs: the same
  results, exceptions and counter deltas (faults, retries, give-ups),
  the deadline included;
- ``CircuitBreaker``: the same state sequence under one fake clock;
- the watchdog: a hang-mode ``executor.dispatch`` becomes
  ``HungStepError`` with a dump holding the reference's section headers;
  disabled it registers nothing; armed, it arms faulthandler; the
  escalate flag validates as the reference's does;
- an injected ``executor.dispatch`` fault keeps the plan (no re-plan);
- the io repair (the reference's ``tests/test_resilience.py:274-357``): a
  save that fails mid-write leaves the earlier directory byte for byte, a
  foreign subdirectory survives a re-save, a failed second rename rolls
  back, and a saver killed between the two renames leaves a directory
  that loads here and does not without the recovery (the parent's
  ``load_vars``);
- ``StepTracer.chrome_events`` gives the reference's names, categories,
  phases and args for the same spans; ``export`` writes the three files.
"""

import glob
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import resilience as ref_res
from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers
from paddle_tpu_torch import monitor
from paddle_tpu_torch import resilience as res
from paddle_tpu_torch.framework import core, scope, unique_name
from _port_fixtures import collect_garbage_after_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RESET = {"FLAGS_fault_inject": "", "FLAGS_watchdog_timeout_s": 0.0,
          "FLAGS_watchdog_dump_dir": "", "FLAGS_watchdog_escalate": "",
          "FLAGS_rpc_retry_times": 3, "FLAGS_rpc_deadline": 180000,
          "FLAGS_rpc_circuit_break_secs": 0.0}


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh port programs, scope and names; flags reset in both
    packages after each test."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)
    res.release_hangs()
    ref_res.release_hangs()
    port_flags.set_flags(_RESET)
    pt.set_flags(_RESET)


def _set(flags):
    port_flags.set_flags(flags)
    pt.set_flags(flags)


def _ctr(mon, site):
    return tuple(mon.REGISTRY.get(n).value(site=site) for n in (
        "paddle_tpu_fault_injected_total",
        "paddle_tpu_retry_attempts_total",
        "paddle_tpu_retry_giveups_total"))


@pytest.mark.parametrize("args", [
    (1,), (2,), (6,), (5, 0.01, 3.0, 0.05, 0.2, 7), (8, 0.5, 2.0, 2.0, 0.0, 1),
    (4, 0.05, 1.5, 0.1, 0.5, 12345)])
def test_backoff_schedule_equals_reference(args):
    assert res.backoff_schedule(*args) == ref_res.backoff_schedule(*args)


@pytest.mark.parametrize("site", ["ps.put", "checkpoint.write", ""])
def test_retry_policy_schedule_equals_reference(site):
    for kw in ({}, {"max_attempts": 5, "seed": 3},
               {"max_attempts": 4, "base_delay_s": 0.2, "jitter": 0.3}):
        assert res.RetryPolicy(**kw).schedule(site) == \
            ref_res.RetryPolicy(**kw).schedule(site)
    _set({"FLAGS_rpc_retry_times": 5, "FLAGS_rpc_deadline": 2500})
    for s in ("ps.get", site):
        p, r = res.RetryPolicy.from_flags(s), ref_res.RetryPolicy.from_flags(s)
        assert (p.max_attempts, p.deadline_s, p.schedule(s)) == \
            (r.max_attempts, r.deadline_s, r.schedule(s))


def _retry_outcome(mod, mon, site, spec, policy_kw):
    mod.configure(f"{site}:{spec}")
    before = _ctr(mon, site)
    calls = []

    def fn():
        calls.append(1)
        mod.maybe_inject(site)
        return "ok"

    try:
        out = mod.retry_call(site, fn, policy=mod.RetryPolicy(**policy_kw))
    except Exception as e:
        out = (type(e).__name__, str(e).split(":")[0])
    after = _ctr(mon, site)
    mod.configure("")
    return out, len(calls), tuple(a - b for a, b in zip(after, before))


@pytest.mark.parametrize("spec,policy_kw", [
    ("times=2", dict(max_attempts=3, base_delay_s=0.001)),
    ("times=5", dict(max_attempts=3, base_delay_s=0.001)),
    ("every=2", dict(max_attempts=2, base_delay_s=0.001)),
    ("once", dict(max_attempts=1)),
    ("times=3", dict(max_attempts=4, base_delay_s=0.2, deadline_s=0.05)),
])
def test_retry_call_equals_reference(spec, policy_kw):
    site = "ps.get_rows"
    got = _retry_outcome(res, monitor, site, spec, policy_kw)
    want = _retry_outcome(ref_res, ref_monitor, site, spec, policy_kw)
    assert got == want


def test_retry_call_never_retries_a_hang_or_a_plain_error():
    for err in (res.HungStepError("x"), ValueError("y")):
        calls = []

        def fn(err=err):
            calls.append(1)
            raise err
        with pytest.raises(type(err)):
            res.retry_call("ps.put", fn,
                           policy=res.RetryPolicy(3, base_delay_s=0.001))
        assert len(calls) == 1


def _breaker_trace(mod):
    clock = {"t": 100.0}
    br = mod.CircuitBreaker(name="", cooldown_s=10.0,
                            clock=lambda: clock["t"])
    trace = [br.state]

    def probe():
        try:
            br.check("site")
            trace.append(("pass", br.state))
        except mod.CircuitOpenError as e:
            trace.append(("open", round(e.remaining_s, 6), br.state))

    probe()
    br.record_giveup()
    trace.append(br.state)
    probe()
    clock["t"] += 4.0
    probe()
    clock["t"] += 6.0
    trace.append(br.state)
    probe()                 # claims the half-open probe
    probe()                 # concurrent call during the probe: fails fast
    br.record_giveup()      # the probe gave up: open again
    probe()
    clock["t"] += 10.0
    probe()
    br.record_success()
    trace.append(br.state)
    probe()
    return trace


def test_circuit_breaker_sequence_equals_reference():
    assert _breaker_trace(res) == _breaker_trace(ref_res)
    br = res.CircuitBreaker(cooldown_s=0.0)
    br.record_giveup()
    br.check()              # a zero cool-down disables the breaker
    assert br.state == "closed"


def test_named_breaker_publishes_its_state():
    clock = {"t": 0.0}
    br = res.CircuitBreaker(name="ep:7", cooldown_s=1.0,
                            clock=lambda: clock["t"])
    gauge = monitor.REGISTRY.get("paddle_tpu_circuit_breaker_state")
    seen = [gauge.value(endpoint="ep:7")]
    br.record_giveup()
    seen.append(gauge.value(endpoint="ep:7"))
    clock["t"] = 2.0
    br.check()
    seen.append(gauge.value(endpoint="ep:7"))
    br.record_success()
    seen.append(gauge.value(endpoint="ep:7"))
    assert seen == [0, 2, 1, 0]


def _tiny(exe):
    x = layers.data("x", shape=[4], dtype="float32")
    loss = layers.mean(layers.fc(x, size=2))
    exe.run(core.default_startup_program())
    return loss, {"x": np.ones((2, 4), np.float32)}


def _headers(text):
    return {"--- thread" if ln.startswith("--- thread") else ln
            for ln in text.splitlines()
            if ln.startswith(("===", "--- "))}


def test_hang_mode_dispatch_becomes_hung_step_error(tmp_path):
    exe = ptt.Executor(ptt.CPUPlace())
    loss, feed = _tiny(exe)
    before = monitor.REGISTRY.get(
        "paddle_tpu_watchdog_fired_total").value(site="executor.dispatch")
    port_flags.set_flags({"FLAGS_fault_inject":
                          "executor.dispatch:once,hang=60",
                          "FLAGS_watchdog_timeout_s": 0.5,
                          "FLAGS_watchdog_dump_dir": str(tmp_path)})
    t0 = time.monotonic()
    with pytest.raises(res.HungStepError, match="executor.dispatch"):
        exe.run(feed=feed, fetch_list=[loss])
    assert time.monotonic() - t0 < 30.0
    dump, = glob.glob(str(tmp_path / "paddle_tpu_watchdog_*.txt"))
    text = open(dump).read()
    pt.set_flags({"FLAGS_watchdog_dump_dir": str(tmp_path / "ref")})
    want = _headers(open(ref_res.dump_state("reference")).read())
    assert _headers(text) == want == {
        "=== watchdog dump ===", "--- thread", "--- metrics ---",
        "--- trace (last 200 events) ---"}
    assert "site: executor.dispatch" in text
    assert monitor.REGISTRY.get("paddle_tpu_watchdog_fired_total").value(
        site="executor.dispatch") == before + 1
    port_flags.set_flags({"FLAGS_watchdog_timeout_s": 0.0})
    out, = exe.run(feed=feed, fetch_list=[loss])     # the hang is spent
    assert np.isfinite(out).all()


def test_disabled_watchdog_registers_nothing():
    port_flags.set_flags({"FLAGS_watchdog_timeout_s": 0.0})
    thread = res.WATCHDOG._thread
    with res.WATCHDOG.watch("anything"):
        assert res.WATCHDOG._watches == {}
    assert res.WATCHDOG._thread is thread


def test_watchdog_arms_faulthandler(monkeypatch):
    import faulthandler
    calls = []
    monkeypatch.setattr(faulthandler, "dump_traceback_later",
                        lambda *a, **k: calls.append(("arm", a, k)))
    monkeypatch.setattr(faulthandler, "cancel_dump_traceback_later",
                        lambda: calls.append(("cancel",)))
    port_flags.set_flags({"FLAGS_watchdog_timeout_s": 5.0})
    with res.WATCHDOG.watch("unit.fh"):
        assert calls and calls[-1][0] == "arm"
        assert calls[-1][2].get("exit") is False
    assert calls[-1] == ("cancel",)


def test_watchdog_escalate_validates_as_the_reference():
    for mod_set, wd in ((port_flags.set_flags, res.WATCHDOG),
                        (pt.set_flags, ref_res.WATCHDOG)):
        with pytest.raises(ValueError):
            mod_set({"FLAGS_watchdog_escalate": "bogus"})
        mod_set({"FLAGS_watchdog_escalate": "abort"})
        assert wd.escalate == "abort"
        mod_set({"FLAGS_watchdog_escalate": ""})
        assert wd.escalate == ""


def test_injected_dispatch_fault_keeps_the_plan():
    exe = ptt.Executor(ptt.CPUPlace())
    loss, feed = _tiny(exe)
    exe.run(feed=feed, fetch_list=[loss])
    traces = exe.dispatch_stats()["traces"]
    port_flags.set_flags({"FLAGS_fault_inject": "executor.dispatch:once"})
    with pytest.raises(res.InjectedFault):
        exe.run(feed=feed, fetch_list=[loss])
    out, = exe.run(feed=feed, fetch_list=[loss])
    assert np.isfinite(out).all()
    assert exe.dispatch_stats()["traces"] == traces


def test_fetch_materialize_site_fires_in_both_fetch_paths():
    exe = ptt.Executor(ptt.CPUPlace())
    loss, feed = _tiny(exe)
    port_flags.set_flags({"FLAGS_fault_inject": "fetch.materialize:every=1"})
    with pytest.raises(res.InjectedFault):
        exe.run(feed=feed, fetch_list=[loss])
    h, = exe.run(feed=feed, fetch_list=[loss], return_numpy=False)
    with pytest.raises(res.InjectedFault):
        h.numpy()


def test_step_hooks_run_after_the_write_back():
    exe = ptt.Executor(ptt.CPUPlace())
    loss, feed = _tiny(exe)
    seen = []

    def hook(e, sc):
        w = [v for v in core.default_main_program().list_vars()
             if v.persistable][0]
        seen.append((e is exe, sc.find_var(w.name) is not None))

    exe.add_step_hook(hook)
    exe.add_step_hook(hook)            # registered once
    exe.run(feed=feed, fetch_list=[loss])
    exe.remove_step_hook(hook)
    exe.run(feed=feed, fetch_list=[loss])
    assert seen == [(True, True)]
    assert exe.drain() == 0            # the host has nothing in flight


# -- the io repair (ref tests/test_resilience.py:274-357) ---------------------

def _params_program(name="av"):
    x = layers.data("x", shape=[4], dtype="float32")
    h = layers.fc(x, size=3, param_attr=ptt.ParamAttr(name=f"{name}_w"),
                  bias_attr=ptt.ParamAttr(name=f"{name}_b"))
    layers.mean(h)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(core.default_startup_program())
    return exe


def test_save_vars_crash_mid_save_preserves_previous_dir(tmp_path,
                                                         monkeypatch):
    exe = _params_program()
    d = str(tmp_path / "params")
    port_io.save_params(exe, d)
    good = {f: open(os.path.join(d, f), "rb").read() for f in os.listdir(d)}
    assert "__meta__.json" in good and len(good) >= 3
    sc = scope.global_scope()
    sc.set_var("av_w", sc.find_var("av_w") * 0 + 9.0)
    real_save, calls = np.save, []

    def exploding_save(path, arr, *a, **k):
        calls.append(path)
        if len(calls) == 2:
            raise OSError("disk full")
        return real_save(path, arr, *a, **k)

    monkeypatch.setattr(np, "save", exploding_save)
    with pytest.raises(OSError, match="disk full"):
        port_io.save_params(exe, d)
    monkeypatch.setattr(np, "save", real_save)
    assert {f: open(os.path.join(d, f), "rb").read()
            for f in os.listdir(d)} == good
    assert [p for p in os.listdir(tmp_path)
            if ".tmp." in p or ".old." in p] == []
    port_io.save_params(exe, d)
    assert open(os.path.join(d, "av_w.npy"), "rb").read() != \
        good["av_w.npy"]


def test_save_vars_preserves_foreign_subdirectories(tmp_path):
    exe = _params_program()
    d = tmp_path / "params"
    port_io.save_params(exe, str(d))
    (d / "assets").mkdir()
    (d / "assets" / "vocab.txt").write_text("hello\n")
    port_io.save_params(exe, str(d))
    assert (d / "assets" / "vocab.txt").read_text() == "hello\n"


def test_failed_second_rename_rolls_back(tmp_path, monkeypatch):
    exe = _params_program()
    d = str(tmp_path / "params")
    port_io.save_params(exe, d)
    good = open(os.path.join(d, "av_w.npy"), "rb").read()
    real_rename, calls = os.rename, []

    def failing_rename(src, dst):
        calls.append(src)
        if ".tmp." in src:
            raise OSError("rename refused")
        return real_rename(src, dst)

    fsynced = []
    monkeypatch.setattr(port_io, "_fsync_dir", fsynced.append)
    monkeypatch.setattr(os, "rename", failing_rename)
    with pytest.raises(OSError, match="rename refused"):
        port_io.save_params(exe, d)
    monkeypatch.setattr(os, "rename", real_rename)
    assert open(os.path.join(d, "av_w.npy"), "rb").read() == good
    assert [p for p in os.listdir(tmp_path) if ".old." in p] == []
    port_io.save_params(exe, d)
    assert str(tmp_path) in fsynced          # the parent is fsynced


_KILLED_SAVER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import io, layers
    from paddle_tpu_torch.framework import core
    d = sys.argv[1]
    x = layers.data("x", shape=[4], dtype="float32")
    layers.mean(layers.fc(x, size=2, param_attr=ptt.ParamAttr(name="rw")))
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(core.default_startup_program())
    io.save_params(exe, d)
    np.save(d + ".want.npy", io._to_numpy(ptt.global_scope().find_var("rw")))
    real_rename = os.rename

    def die_between(src, dst):
        real_rename(src, dst)
        if ".old." in dst:          # the first rename: die before the next
            os._exit(9)

    os.rename = die_between
    io.save_params(exe, d)
""")


def test_saver_killed_between_renames_loads_after_the_repair(tmp_path):
    d = str(tmp_path / "params")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _KILLED_SAVER, d], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 9, r.stderr[-2000:]
    assert not os.path.isdir(d) and glob.glob(d + ".old.*")
    want = np.load(d + ".want.npy")
    layers.mean(layers.fc(layers.data("x", shape=[4], dtype="float32"),
                          size=2, param_attr=ptt.ParamAttr(name="rw")))
    # the parent tree's load_vars had no recovery: the directory is gone
    real = port_io._recover_interrupted_swap
    port_io._recover_interrupted_swap = lambda dirname: None
    try:
        with pytest.raises(ValueError, match="missing saved var file"):
            port_io.load_params(None, d)
    finally:
        port_io._recover_interrupted_swap = real
    with pytest.warns(UserWarning, match="died mid-publish"):
        port_io.load_params(None, d)
    np.testing.assert_array_equal(
        scope.global_scope().find_var("rw").numpy(), want)


# -- the step tracer ------------------------------------------------------------

def _record(tracer):
    with tracer.span("retry.backoff", "resilience", site="s", attempt=1):
        pass
    tracer.instant("fault.injected", "resilience", {"site": "s", "call": 2})
    tracer.counter("queue", 3.0, cat="memory")
    tracer.add_complete("checkpoint.capture", "checkpoint", 1.0, 1.5,
                        {"step": 4, "kind": "daemon"})
    with tracer.span("plain"):
        pass
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur", "pid",
                                                      "tid")}
            for ev in tracer.chrome_events() if ev["ph"] != "M"]


def test_step_tracer_chrome_events_equal_reference():
    got = _record(monitor.StepTracer())
    want = _record(ref_monitor.StepTracer())
    assert got == want
    t = monitor.StepTracer(max_events=3)
    t.enabled = False
    t.instant("x")
    assert len(t) == 0
    t.enabled = True
    for i in range(5):
        t.instant(f"e{i}")
    assert [e["name"] for e in t.chrome_events() if e["ph"] == "i"] == \
        ["e2", "e3", "e4"]


def test_export_writes_metrics_and_trace(tmp_path):
    paths = monitor.export(str(tmp_path))
    assert sorted(paths) == ["json", "prom", "trace"]
    prom = open(paths["prom"]).read()
    assert "# TYPE paddle_tpu_fault_injected_total counter" in prom
    import json
    assert "traceEvents" in json.load(open(paths["trace"]))
    totals = monitor.counter_totals()
    assert "paddle_tpu_retry_attempts_total" in totals
    port_flags.set_flags({"FLAGS_telemetry": False})
    assert not monitor.TRACER.enabled
    port_flags.set_flags({"FLAGS_telemetry": True})
