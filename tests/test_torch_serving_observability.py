"""The port's serving observability plane against the JAX package's, on the
CPU: request traces, the SLO burn-rate plane, the scrape endpoint, the
tenant plane's eviction, ``shrink_widths`` and the batcher's run-ahead.

- ``parse_slo`` parses the same specs to the same targets and refuses the
  same malformed ones; ``BurnRateEvaluator`` fed the same records at the
  same times gives the same ``evaluate()`` output as the reference's at
  every tick (breach, hysteresis, recovery, latency objectives, zero
  traffic, window edges, idle wildcard tenants, forgotten tenants); the
  flags are validated at ``set_flags``;
- every request's phase spans partition submit -> resolve under one trace
  id and sum to its ``e2e_ms`` (the dispatch span carries the step id,
  width, occupancy and padding); the decode loop's chain likewise;
- the tenant plane's eviction retires the tenant's series into
  ``tenant="retired"`` as the reference's does, stale completions neither
  resurrect the SLO state nor touch the new incarnation; shed on burn;
- ``/metrics``, ``/healthz`` and ``/statusz`` answer on 127.0.0.1 (port
  0), ``/healthz`` turns 503 on drain, ``serve_until_terminated`` drains
  on SIGTERM and returns 0;
- ``shrink_widths`` halves the built buckets' widths and the next batch
  runs at it; ``alive_stats`` counts the batches on the card at once, at
  most ``MAX_QUEUED_BATCHES`` + 1;
- the port's scheduler, bucketing and monitor register every serving
  family the reference's do.
"""

import json
import os
import re
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import serving as ref_serving
from paddle_tpu_torch import flags, monitor, serving
from paddle_tpu_torch.framework import core, scope as scope_mod, unique_name
from paddle_tpu_torch.models import transformer as T
from _port_fixtures import collect_garbage_after_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import timeline  # noqa: E402  (tools/timeline.py: the Prometheus validator)

_SLO_DEFAULTS = {"FLAGS_serving_slo": "", "FLAGS_serving_slo_shed": False,
                 "FLAGS_serving_slo_fast_window_s": 60.0,
                 "FLAGS_serving_slo_slow_window_s": 600.0,
                 "FLAGS_serving_slo_burn_threshold": 10.0,
                 "FLAGS_metrics_port": 0}


@pytest.fixture(autouse=True)
def _isolation():
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope_mod._scope_stack.append(scope_mod.Scope())
    with unique_name.guard():
        yield
    flags.set_flags(_SLO_DEFAULTS)
    pt.set_flags({k: v for k, v in _SLO_DEFAULTS.items()
                  if k != "FLAGS_metrics_port"})
    scope_mod._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


def _concat_factory(seq):
    prog, startup = core.Program(), core.Program()
    with core.program_guard(prog, startup):
        x = ptt.layers.data("x", shape=[seq], dtype="float32")
        out = ptt.layers.concat([x, x], axis=1)
    return prog, ["x"], [out.name]


def _server(**kw):
    kw.setdefault("buckets", (8,))
    kw.setdefault("max_batch", 2)
    kw.setdefault("batch_wait_ms", 0.0)
    return serving.InferenceServer(_concat_factory, ptt.Scope(),
                                   executor=ptt.Executor(ptt.CPUPlace()),
                                   **kw)


def _totals(mon, name, **labels):
    fam = mon.REGISTRY.get(name)
    if fam is None:
        return 0.0
    return sum(cell.get() for lbl, cell in fam.series()
               if all(lbl.get(k) == v for k, v in labels.items()))


def _serving_spans(trace_id):
    evs = [(name, t0, t0 + dur, args)
           for ph, name, cat, _tid, t0, dur, args
           in list(monitor.TRACER._events)
           if ph == "X" and cat == "serving" and args
           and args.get("trace") == trace_id]
    return sorted(evs, key=lambda e: e[1])


def _last_materialize(tenant):
    mats = [args for ph, name, cat, _t, _ts, _d, args
            in list(monitor.TRACER._events)
            if ph == "X" and name == "serving.materialize" and args
            and args.get("tenant") == tenant]
    assert mats, "no materialize span emitted"
    return mats[-1]


# -- the SLO grammar and flags -----------------------------------------------

_SPECS = ["tenantA:p99_ms=250,avail=99.9;tenantB:avail=99;*:p99_ms=500",
          "", " ; a:avail=100 ;", "t:p99_ms=1e3", "nocolon", "t:",
          "t:frobs=3", "t:p99_ms=abc", "t:avail=0", "t:avail=101",
          "t:p99_ms=-5", ":avail=99", "t:avail=99,p99_ms=10,avail=98"]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_slo_matches_reference(spec):
    def parse(fn):
        try:
            return {t: v.as_dict() for t, v in fn(spec).items()}
        except ValueError:
            return "refused"
    assert parse(serving.parse_slo) == parse(ref_serving.parse_slo)


def test_parse_slo_grammar():
    t = serving.parse_slo(
        "tenantA:p99_ms=250,avail=99.9;tenantB:avail=99;*:p99_ms=500")
    assert t["tenantA"].p99_ms == 250 and t["tenantA"].avail == 99.9
    assert t["tenantB"].p99_ms is None and t["tenantB"].avail == 99.0
    assert t["*"].p99_ms == 500 and t["*"].avail == 99.0
    assert abs(t["tenantB"].budget - 0.01) < 1e-12


def test_slo_flags_validated_at_set_flags():
    with pytest.raises(ValueError):
        flags.set_flags({"FLAGS_serving_slo": "t:not_a_key=1"})
    flags.set_flags({"FLAGS_serving_slo": "t:p99_ms=100"})
    for bad in ({"FLAGS_serving_slo_fast_window_s": 900.0},
                {"FLAGS_serving_slo_fast_window_s": 0.0},
                {"FLAGS_serving_slo_burn_threshold": 0.0}):
        with pytest.raises(ValueError):
            flags.set_flags(bad)
    assert flags.get_flags(["FLAGS_serving_slo_fast_window_s",
                            "FLAGS_serving_slo_slow_window_s"]) == {
        "FLAGS_serving_slo_fast_window_s": 60.0,
        "FLAGS_serving_slo_slow_window_s": 600.0}
    flags.set_flags({"FLAGS_serving_slo_fast_window_s": 900.0,
                     "FLAGS_serving_slo_slow_window_s": 1800.0})
    with pytest.raises(ValueError):
        flags.set_flags({"FLAGS_metrics_port": "http"})


# -- burn rates against the reference ----------------------------------------

def _scenario(name):
    """(targets spec, [("rec", tenant, ok, latency, t) | ("eval", t) |
    ("forget", tenant)])"""
    ev = []
    if name == "breach_hysteresis_recovery":
        ev += [("rec", "bt", False, 0.0, 1000 + i * 0.1) for i in range(5)]
        ev += [("eval", 1001.0)]
        ev += [("rec", "bt", True, 1.0, 1002 + i * 0.01) for i in range(50)]
        ev += [("eval", 1003.0), ("eval", 1070.0), ("eval", 1700.0)]
        return "bt:avail=99", ev
    if name == "latency_objective":
        ev += [("rec", "lt", True, 50 + 100 * (i % 2), 50 + i * 0.1)
               for i in range(4)]
        return "lt:p99_ms=100", ev + [("eval", 51.0)]
    if name == "zero_traffic_and_untracked":
        return "idle:avail=99", [("eval", 10.0),
                                 ("rec", "stranger", False, 0.0, 10.0),
                                 ("eval", 11.0)]
    if name == "window_edges":
        return "bt:avail=99", [("rec", "bt", False, 0.0, 2000.0),
                               ("eval", 2000.0 + 60 - 1e-6),
                               ("eval", 2060.0), ("eval", 2601.0)]
    if name == "idle_wildcard":
        return "*:avail=99", [("rec", "idle_w", True, 1.0, 50.0),
                              ("eval", 51.0), ("eval", 652.0),
                              ("rec", "br_w", False, 0.0, 2000.0),
                              ("eval", 2000.5), ("eval", 2601.5),
                              ("eval", 2602.5)]
    if name == "forget":
        return "*:avail=99;decl:avail=99.5", [
            ("rec", "churn", False, 0.0, 100.0),
            ("rec", "decl", True, 1.0, 100.0), ("eval", 100.5),
            ("forget", "churn"), ("forget", "decl"), ("eval", 101.0),
            ("rec", "decl", False, 0.0, 101.5), ("eval", 102.0)]
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "breach_hysteresis_recovery", "latency_objective",
    "zero_traffic_and_untracked", "window_edges", "idle_wildcard",
    "forget"])
def test_burn_rate_evaluator_matches_reference(name):
    spec, events = _scenario(name)
    port = serving.BurnRateEvaluator(serving.parse_slo(spec))
    ref = ref_serving.BurnRateEvaluator(ref_serving.parse_slo(spec))
    n_eval = 0
    for e in events:
        if e[0] == "rec":
            _, tenant, ok, lat, t = e
            port.record(tenant, ok=ok, latency_ms=lat, now=t)
            ref.record(tenant, ok=ok, latency_ms=lat, now=t)
        elif e[0] == "forget":
            port.forget(e[1])
            ref.forget(e[1])
        else:
            assert port.evaluate(now=e[1]) == ref.evaluate(now=e[1]), e
            assert port.state() == ref.state()
            n_eval += 1
    assert n_eval >= 1


def test_burn_rate_breach_recovery_hysteresis():
    ev = serving.BurnRateEvaluator({"bt": serving.SLOTarget(avail=99.0)})
    t0 = 1000.0
    for i in range(5):
        ev.record("bt", ok=False, now=t0 + i * 0.1)
    n0 = _totals(monitor, "paddle_tpu_slo_breach_total", tenant="bt")
    st = ev.evaluate(now=t0 + 1)
    assert st["bt"]["burn_fast"] == pytest.approx(100.0)
    assert st["bt"]["breached"] and ev.in_breach("bt")
    assert _totals(monitor, "paddle_tpu_slo_breach_total",
                   tenant="bt") == n0 + 1
    assert monitor.SLO_BURN_GAUGE.value(tenant="bt", window="fast") == \
        pytest.approx(100.0)
    assert monitor.SLO_BREACHED_GAUGE.value(tenant="bt") == 1
    for i in range(50):
        ev.record("bt", ok=True, latency_ms=1.0, now=t0 + 2 + i * 0.01)
    st = ev.evaluate(now=t0 + 3)
    assert 5.0 < st["bt"]["burn_fast"] < 10.0 and st["bt"]["breached"]
    st = ev.evaluate(now=t0 + 70)
    assert st["bt"]["burn_fast"] == 0.0 and not st["bt"]["breached"]
    assert monitor.SLO_BREACHED_GAUGE.value(tenant="bt") == 0
    kinds = [args for ph, name, cat, _t, _ts, _d, args
             in list(monitor.TRACER._events)
             if ph == "i" and name in ("slo.breach", "slo.recover")
             and args and args.get("tenant") == "bt"]
    assert len(kinds) >= 2


def test_evaluator_from_flags_off_by_default():
    assert serving.BurnRateEvaluator.from_flags() is None
    flags.set_flags({"FLAGS_serving_slo": "ff:p99_ms=10",
                     "FLAGS_serving_slo_fast_window_s": 5.0})
    ev = serving.BurnRateEvaluator.from_flags()
    assert ev is not None and ev.fast_window_s == 5.0
    assert ev.targets["ff"].p99_ms == 10


# -- the tenant plane --------------------------------------------------------

def _drive_plane(mod, mon, plane, tenant):
    plane.set_quota(tenant, 2)
    a1, a2, a3 = (plane.try_admit(tenant) for _ in range(3))
    gen0 = plane.generation(tenant)
    plane.complete(tenant, 5.0, gen=gen0)
    plane.reject(tenant, "quota")
    plane.evict(tenant)
    stale_current = plane.is_current(tenant, gen0)
    plane.complete(tenant, 7.0, gen=gen0)       # a straggler
    plane.fail(tenant, gen=gen0)
    plane.reject(tenant, "draining")
    assert plane.try_admit(tenant)              # a new incarnation
    gen1 = plane.generation(tenant)
    plane.complete(tenant, 1.0, gen=gen1)
    fams = ("paddle_tpu_serving_requests_total",
            "paddle_tpu_serving_completed_total",
            "paddle_tpu_serving_failed_total",
            "paddle_tpu_serving_rejected_total")
    return {"admits": (a1, a2, a3), "gens": (gen0, gen1),
            "stale_current": stale_current,
            "current": plane.is_current(tenant, gen1),
            "snapshot": plane.snapshot(),
            "outstanding": plane.outstanding(tenant),
            "series": {f: (_totals(mon, f, tenant=tenant),
                           _totals(mon, f, tenant="retired") > 0)
                       for f in fams},
            "queue": mon.SERVING_QUEUE_GAUGE.value(tenant=tenant)}


def test_tenant_eviction_matches_reference():
    got = _drive_plane(serving, monitor, serving.TenantPlane(),
                       "evict_parity_t")
    want = _drive_plane(ref_serving, ref_monitor, ref_serving.TenantPlane(),
                        "evict_parity_t")
    assert got == want
    assert got["gens"] == (0, 1) and not got["stale_current"]


def test_tenant_evict_wires_slo_forget():
    flags.set_flags({"FLAGS_serving_slo": "*:avail=99"})
    srv = _server()
    assert srv.slo is not None
    srv.slo.record("ev_hook_t", ok=False)
    srv.tenants.evict("ev_hook_t")
    with srv.slo._mu:
        assert "ev_hook_t" not in srv.slo._events


def test_stale_completion_does_not_resurrect_slo():
    flags.set_flags({"FLAGS_serving_slo": "*:avail=99"})
    srv = _server()
    req = serving.Request("stale_t", feeds={})
    req.admit_gen = srv.tenants.generation("stale_t")
    srv.tenants.evict("stale_t")
    srv._on_complete(req, [np.zeros(1)], 1.0)
    srv._on_fail(serving.Request("stale_t", feeds={}), RuntimeError("x"))
    with srv.slo._mu:
        assert "stale_t" not in srv.slo._events
    assert "stale_t" not in srv.slo.evaluate()
    assert srv.tenants.try_admit("stale_t")
    req2 = serving.Request("stale_t", feeds={})
    req2.admit_gen = srv.tenants.generation("stale_t")
    srv._on_complete(req2, [np.zeros(1)], 1.0)
    assert "stale_t" in srv.slo.evaluate()


def test_slo_series_retire_with_tenant():
    monitor.SLO_BURN_GAUGE.set(5.0, tenant="bye_t", window="fast")
    monitor.SLO_BREACHED_GAUGE.set(1, tenant="bye_t")
    monitor.SLO_BREACH_CTR.inc(2, tenant="bye_t")
    monitor.SERVING_PHASE_HIST.observe(1.0, phase="admit", tenant="bye_t",
                                       bucket="8")
    monitor.SERVING_KV_TENANT_PAGES.set(3, tenant="bye_t")
    tot0 = _totals(monitor, "paddle_tpu_slo_breach_total")
    monitor.retire_tenant_series("bye_t")
    for fam in ("paddle_tpu_slo_burn_rate", "paddle_tpu_slo_breached",
                "paddle_tpu_slo_breach_total", "paddle_tpu_serving_phase_ms",
                "paddle_tpu_serving_kv_tenant_pages"):
        assert not any(lbl.get("tenant") == "bye_t"
                       for lbl, _ in monitor.REGISTRY.get(fam).series()), fam
    assert _totals(monitor, "paddle_tpu_slo_breach_total") == tot0
    assert _totals(monitor, "paddle_tpu_slo_breach_total",
                   tenant="retired") >= 2


def test_slo_eval_failure_warns_once():
    import warnings as _w
    flags.set_flags({"FLAGS_serving_slo": "*:avail=99"})
    srv = _server()

    def boom(now=None):
        raise RuntimeError("boom")
    srv.slo.evaluate = boom
    with pytest.warns(UserWarning, match="SLO evaluator failed"):
        srv._slo_eval_safe()
    with _w.catch_warnings():
        _w.simplefilter("error")
        srv._slo_eval_safe()


def test_shed_on_burn_admission():
    flags.set_flags({"FLAGS_serving_slo": "shed_t:avail=99",
                     "FLAGS_serving_slo_shed": True})
    srv = _server()
    assert srv.slo is not None and srv._slo_shed
    for _ in range(5):
        srv.slo.record("shed_t", ok=False)
    srv.slo.evaluate()
    n0 = _totals(monitor, "paddle_tpu_serving_rejected_total",
                 tenant="shed_t", reason="slo_shed")
    f = srv.submit("shed_t", {"x": np.ones(4, np.float32)})
    with pytest.raises(serving.AdmissionError, match="slo_shed"):
        f.result(0)
    assert _totals(monitor, "paddle_tpu_serving_rejected_total",
                   tenant="shed_t", reason="slo_shed") == n0 + 1
    srv.stop()


# -- request traces ----------------------------------------------------------

def test_trace_chain_partitions_e2e_latency():
    srv = _server()
    srv.warmup()
    srv.start()
    try:
        srv.submit("trace_t", {"x": np.arange(1, 6, dtype=np.float32)},
                   seq_len=5).result(timeout=60)
        mat = _last_materialize("trace_t")
        spans = _serving_spans(mat["trace"])
        assert [n for n, *_ in spans] == [
            "serving.admit", "serving.queue_wait", "serving.batch_wait",
            "serving.dispatch", "serving.materialize"]
        for (_n1, _s1, e1, _a1), (_n2, s2, _e2, _a2) in zip(spans,
                                                            spans[1:]):
            assert s2 == pytest.approx(e1, abs=1e-6)
        phase_sum_ms = sum(t1 - t0 for _n, t0, t1, _a in spans) * 1e3
        assert phase_sum_ms == pytest.approx(mat["e2e_ms"], rel=0.10,
                                             abs=0.05)
        d = spans[3][3]
        assert d["step"] >= 1 and d["width"] >= d["occupancy"] >= 1
        assert d["pad_rows"] == d["width"] - d["occupancy"]
        assert d["pad_frac"] == round(d["pad_rows"] / d["width"], 4)
        from paddle_tpu_torch.framework.executor import last_step_id
        assert d["step"] <= last_step_id()
        assert all(a["tenant"] == "trace_t" and a["bucket"] == "8"
                   for *_x, a in spans)
        phases = {lbl["phase"] for lbl, _c in
                  monitor.SERVING_PHASE_HIST.series()
                  if lbl.get("tenant") == "trace_t"}
        assert phases == {"admit", "queue_wait", "batch_wait", "dispatch",
                          "materialize"}
        assert srv.statusz()["mean_occupancy"] >= 1.0
    finally:
        srv.stop()


def test_decode_trace_chain_and_load_gauges():
    cfg = T.BertConfig(vocab_size=48, d_model=16, n_layer=1, n_head=2,
                       d_inner=32, max_pos=32, dropout=0.0)
    scope = ptt.Scope()
    startup = core.Program()
    with core.program_guard(core.Program(), startup):
        T.build_gpt_serving(cfg, 8, attn_impl="base")
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope, seed=3)
    eng = serving.DecodeEngine(cfg, scope, max_slots=2, page_len=4,
                               max_seq=16, place=ptt.CPUPlace())
    dsrv = serving.DecodeServer(eng).start()
    try:
        tok0 = _totals(monitor, "paddle_tpu_serving_generated_tokens_total")
        out = dsrv.submit("dec_t", np.array([3, 5, 7], np.int64),
                          max_new_tokens=3).result(timeout=120)
        assert len(out) == 3
        mat = _last_materialize("dec_t")
        spans = _serving_spans(mat["trace"])
        assert [n for n, *_ in spans] == ["serving.admit",
                                          "serving.queue_wait",
                                          "serving.decode",
                                          "serving.materialize"]
        assert all(a["bucket"] == "decode" for *_x, a in spans)
        assert spans[2][3]["generated"] == 3 and spans[2][3]["iters"] >= 3
        phase_sum_ms = sum(t1 - t0 for _n, t0, t1, _a in spans) * 1e3
        assert phase_sum_ms == pytest.approx(mat["e2e_ms"], rel=0.10,
                                             abs=0.05)
        assert _totals(monitor, "paddle_tpu_serving_generated_tokens_total"
                       ) == tok0 + 3
        assert monitor.SERVING_FREE_SLOTS_GAUGE.value() == 2
    finally:
        assert dsrv.drain(10)
        dsrv.stop()


def test_trace_ids_unique_per_request():
    r1 = serving.Request("u_t", feeds={}, seq_len=1, bucket=8)
    r2 = serving.Request("u_t", feeds={}, seq_len=1, bucket=8)
    assert r1.trace_id != r2.trace_id
    assert r1.tm == {"submit": r1.t_submit} and r1.admit_gen == 0


def test_batcher_counts_batches_padding_and_liveness():
    from paddle_tpu_torch.serving import scheduler
    srv = _server(max_batch=4)
    srv.warmup()
    b0 = _totals(monitor, "paddle_tpu_serving_batches_total", bucket="8")
    p0 = _totals(monitor, "paddle_tpu_serving_padding_rows_total")
    t0 = time.time()
    srv.start()
    futs = [srv.submit("cnt_t", {"x": np.ones(3, np.float32)})
            for _ in range(3)]
    for f in futs:
        f.result(timeout=60)
    assert srv.drain(10)
    srv.stop()
    log = srv.batch_log()
    assert _totals(monitor, "paddle_tpu_serving_batches_total",
                   bucket="8") == b0 + len(log)
    assert _totals(monitor, "paddle_tpu_serving_padding_rows_total") == \
        p0 + sum(b["width"] - b["occupancy"] for b in log)
    assert scheduler.last_alive_wall >= t0
    assert monitor.SERVING_LAST_OCC_GAUGE.value() == log[-1]["occupancy"]


# -- the scrape endpoint and SIGTERM -----------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_enable_http_honors_disabled_flag():
    srv = _server()
    assert srv.enable_http() is None and srv._http is None


def test_httpd_metrics_healthz_statusz():
    flags.set_flags({"FLAGS_serving_slo": "*:p99_ms=500"})
    srv = _server()
    srv.warmup()
    srv.start()
    http = srv.enable_http(0, host="127.0.0.1")
    assert srv.enable_http(0) is http
    try:
        srv.submit("http_t", {"x": np.ones(4, np.float32)}).result(
            timeout=60)
        code, body = _get(http.url + "/metrics")
        assert code == 200 and timeline.validate_prometheus(body) > 0
        assert "paddle_tpu_serving_phase_ms" in body
        assert _get(http.url + "/healthz") == (200, "ok\n")
        srv._slo_eval_safe()
        code, body = _get(http.url + "/statusz")
        st = json.loads(body)
        assert code == 200 and st["draining"] is False
        assert st["buckets"] == {"8": 2} and st["compile"]["traces"] >= 1
        assert st["slo"]["http_t"]["breached"] is False
        assert _get(http.url + "/nope")[0] == 404
        assert _totals(monitor, "paddle_tpu_metrics_http_requests_total",
                       path="other", status="404") >= 1
        srv._draining.set()
        assert _get(http.url + "/healthz") == (503, "draining\n")
        assert json.loads(_get(http.url + "/statusz")[1])["draining"]
    finally:
        srv.stop()
    assert srv._http is None


def test_httpd_standalone_exporter():
    with serving.MetricsHTTPServer(port=0) as http:
        code, body = _get(http.url + "/metrics")
        assert code == 200 and timeline.validate_prometheus(body) > 0
        assert _get(http.url + "/healthz")[0] == 200
        assert json.loads(_get(http.url + "/statusz")[1]) == {}
    with pytest.raises(RuntimeError):
        http.url


def test_serve_until_terminated_drains_on_sigterm():
    srv = _server()
    srv.warmup()
    srv.start()
    results = []

    def client():
        results.append(srv.submit("sig_t", {"x": np.ones(4, np.float32)})
                       .result(timeout=60))
        os.kill(os.getpid(), signal.SIGTERM)

    old = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=client)
    t.start()
    rc = srv.serve_until_terminated(poll_s=0.01, drain_timeout_s=30)
    t.join(30)
    assert rc == 0 and len(results) == 1
    assert signal.getsignal(signal.SIGTERM) == old
    f = srv.submit("sig_t", {"x": np.ones(4, np.float32)})
    with pytest.raises(serving.AdmissionError, match="draining"):
        f.result(0)


# -- widths and run-ahead ----------------------------------------------------

def test_shrink_widths_halves_built_buckets_and_the_next_batch_runs_at_it():
    srv = _server(buckets=(8, 16), max_batch=4)
    srv.warmup([8])
    assert srv.plan.width_of(8) == 4 and srv.plan.width_of(16) is None
    assert srv.shrink_widths() == {8: 2}
    assert srv.plan.width_of(16) is None        # cold buckets untouched
    assert srv.statusz()["buckets"] == {"8": 2, "16": None}
    srv.start()
    futs = [srv.submit("sh_t", {"x": np.full(5, i, np.float32)}, seq_len=5)
            for i in range(4)]
    outs = [f.result(timeout=60)[0] for f in futs]
    assert srv.drain(10)
    srv.stop()
    assert all(b["width"] == 2 for b in srv.batch_log())
    for i, o in enumerate(outs):
        row = np.pad(np.full(5, i, np.float32), (0, 3))
        np.testing.assert_array_equal(o, np.concatenate([row, row]))
    assert srv.shrink_widths() == {8: 1}
    assert srv.shrink_widths() == {8: 1}        # floor 1


def test_shrink_widths_as_the_reference_bucket_plan():
    def factory(seq):
        return _concat_factory(seq)
    port = serving.BucketPlan((8, 16, 32), factory, 8)
    port.plan(8)
    port.plan(32)
    ref = ref_serving.BucketPlan((8, 16, 32), lambda s: (None, [], []), 8)
    for b in (8, 32):
        ref._plans[b] = (None, [], [], 8)
    for _ in range(4):
        assert port.shrink_widths() == ref.shrink_widths()


def test_alive_stats_count_the_batches_on_the_card():
    from paddle_tpu_torch.serving import scheduler as sched
    release = threading.Event()

    class Handle:
        def __init__(self, rows):
            self.rows = rows

        def __array__(self, dtype=None, copy=None):
            assert release.wait(30)
            return np.zeros((self.rows, 4), np.float32)

    class Exe:
        calls = 0

        def run(self, compiled, feed, fetch_list, scope, return_numpy):
            Exe.calls += 1
            return [Handle(len(feed["x"]))]

    def factory(seq):
        prog = core.Program()
        with core.program_guard(prog, core.Program()):
            x = ptt.layers.data("x", shape=[seq], dtype="int64")
        return prog, ["x"], [x.name]

    srv = serving.InferenceServer(factory, ptt.Scope(), buckets=(4,),
                                  max_batch=1, executor=Exe()).start()
    futs = [srv.submit("t", {"x": np.arange(3)}) for _ in range(6)]
    deadline = time.monotonic() + 10
    while srv.alive_stats()["alive"] < 1 + sched.MAX_QUEUED_BATCHES and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert srv.alive_stats() == {"alive": 1 + sched.MAX_QUEUED_BATCHES,
                                 "max_alive": 1 + sched.MAX_QUEUED_BATCHES}
    release.set()
    for f in futs:
        f.result(timeout=30)
    assert srv.drain(10)
    srv.stop()
    assert srv.alive_stats(reset=True) == {
        "alive": 0, "max_alive": 1 + sched.MAX_QUEUED_BATCHES}
    assert srv.alive_stats()["max_alive"] == 0
    log = srv.batch_log()
    assert max(b["alive_at_dispatch"] for b in log) == \
        1 + sched.MAX_QUEUED_BATCHES


def _families(path):
    src = open(os.path.join(REPO, path)).read()
    return set(re.findall(r"REGISTRY\.(?:counter|gauge|histogram)\(\s*"
                          r"\"(paddle_tpu_[a-z_]+)\"", src))


@pytest.mark.parametrize("mod", ["serving/scheduler.py",
                                 "serving/bucketing.py", "serving/httpd.py"])
def test_serving_modules_register_the_reference_families(mod):
    assert _families("paddle_tpu/" + mod) <= _families(
        "paddle_tpu_torch/" + mod)


def test_monitor_registers_the_reference_serving_families():
    want = {n for n in _families("paddle_tpu/monitor.py")
            if n.startswith(("paddle_tpu_serving_", "paddle_tpu_slo_"))}
    assert want and want <= _families("paddle_tpu_torch/monitor.py")


def test_monitor_registers_the_reference_fleet_families():
    want = {n for n in _families("paddle_tpu/monitor.py")
            if n.startswith("paddle_tpu_fleet_")}
    assert len(want) == 8 and want <= _families("paddle_tpu_torch/monitor.py")


# -- the heartbeat digest ------------------------------------------------------

def test_metrics_digest_carries_serving_load():
    """The reference's test; the scheduler's liveness stamp is set here
    (the reference's relies on an earlier test's serving loop)."""
    import paddle_tpu_torch.serving.scheduler as sched
    old = sched.last_alive_wall
    sched.last_alive_wall = time.time()
    try:
        monitor.SERVING_QUEUE_GAUGE.set(3, tenant="dg_a")
        monitor.SERVING_QUEUE_GAUGE.set(2, tenant="dg_b")
        monitor.SERVING_QUEUE_GAUGE.set(99, tenant="retired")  # excluded
        monitor.SERVING_LAST_OCC_GAUGE.set(4)
        monitor.SERVING_FREE_SLOTS_GAUGE.set(1)
        monitor.SERVING_TPS_GAUGE.set(123.456)
        d = monitor.metrics_digest()
        assert d["srv_q"] >= 5.0        # dg_a + dg_b (other tests may add)
        assert d["occ"] == 4.0 and d["slots"] == 1.0
        assert d["tps"] == 123.456
        # the serving keys survive a cap after the core keys
        capped = monitor.capped_digest(dict(d), max_bytes=2048)
        assert "srv_q" in capped
    finally:
        sched.last_alive_wall = old
        monitor.SERVING_QUEUE_GAUGE.fold({"tenant": "dg_a"}, None)
        monitor.SERVING_QUEUE_GAUGE.fold({"tenant": "dg_b"}, None)
        monitor.SERVING_QUEUE_GAUGE.fold({"tenant": "retired"}, None)


def _oversize_digest(seed):
    rng = np.random.RandomState(seed)
    keys = list(monitor._DIGEST_PRIORITY)
    d = {k: round(float(rng.rand() * 10 ** rng.randint(0, 9)), 5)
         for k in keys if rng.rand() < 0.8}
    for i in range(int(rng.randint(0, 40))):
        d[f"x{rng.randint(1000):03d}_{i}"] = float(rng.rand())
    return d


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cap", [40, 120, 300, 512])
def test_capped_digest_matches_reference(seed, cap):
    d = _oversize_digest(seed)
    assert monitor._DIGEST_PRIORITY == ref_monitor._DIGEST_PRIORITY
    assert monitor.DIGEST_MAX_BYTES == ref_monitor.DIGEST_MAX_BYTES
    got = monitor.capped_digest(d, max_bytes=cap)
    assert got == ref_monitor.capped_digest(d, max_bytes=cap)
    assert len(json.dumps(got, sort_keys=True)) <= cap or not got


def test_digest_freshness_gates_the_hbm_keys(monkeypatch):
    from paddle_tpu_torch import hbm
    monkeypatch.setattr(hbm.ACCOUNTANT, "last_sample", (1000, 24))
    monkeypatch.setattr(hbm.ACCOUNTANT, "last_publish_wall", time.time())
    d = monitor.metrics_digest()
    assert (d["hbm"], d["hdrm"]) == (1000, 24)
    monkeypatch.setattr(hbm.ACCOUNTANT, "last_sample", (1000, None))
    d = monitor.metrics_digest()
    assert d["hbm"] == 1000 and "hdrm" not in d
    monkeypatch.setattr(hbm.ACCOUNTANT, "last_publish_wall",
                        time.time() - 1e4)
    assert "hbm" not in monitor.metrics_digest()


# -- latency_report ------------------------------------------------------------

def test_latency_report_decomposes_exported_trace(tmp_path):
    """The reference's test, on the port's tool."""
    from paddle_tpu_torch.tools import latency_report

    def span(name, trace, tenant, bucket, ts, dur_ms, **extra):
        return {"ph": "X", "name": "serving." + name, "cat": "serving",
                "ts": ts, "dur": dur_ms * 1e3,
                "args": dict(trace=trace, tenant=tenant, bucket=bucket,
                             **extra)}

    events = []
    for i, e2e in enumerate((10.0, 30.0)):      # two lat_t requests
        t = 1000 + i
        events += [
            span("admit", t, "lat_t", "8", 0, 1.0),
            span("queue_wait", t, "lat_t", "8", 1e3, 2.0),
            span("batch_wait", t, "lat_t", "8", 3e3, 1.0),
            span("dispatch", t, "lat_t", "8", 4e3, e2e - 5.0,
                 step=7, pad_frac=0.25 * i),
            span("materialize", t, "lat_t", "8", (e2e - 1.0) * 1e3,
                 1.0, e2e_ms=e2e),
        ]
    events += [
        span("admit", 2000, "dec_t", "decode", 0, 1.0),
        span("queue_wait", 2000, "dec_t", "decode", 1e3, 1.0),
        span("decode", 2000, "dec_t", "decode", 2e3, 17.0),
        span("materialize", 2000, "dec_t", "decode", 19e3, 1.0,
             e2e_ms=20.0),
    ]
    # an in-flight chain, and bare executor steps that a serving trace
    # must not count twice
    events.append(span("admit", 3000, "lat_t", "8", 0, 1.0))
    exec_spans = [
        {"ph": "X", "name": "executor.dispatch", "ts": 0,
         "dur": 5e3, "args": {"step": 7}},
        {"ph": "X", "name": "fetch.materialize", "ts": 6e3,
         "dur": 2e3, "args": {"n": 1, "step": 7}},
    ]
    events += exec_spans
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))

    rep = latency_report.report(latency_report.load_chains(str(path)))
    assert rep["total_requests"] == 3
    assert rep["in_flight_at_export"] == 1
    by_key = {(g["tenant"], g["bucket"]): g for g in rep["groups"]}
    assert ("untagged", "untagged") not in by_key
    # an executor-only trace decomposes under 'untagged'
    xpath = tmp_path / "exec_trace.json"
    xpath.write_text(json.dumps({"traceEvents": exec_spans}))
    xrep = latency_report.report(latency_report.load_chains(str(xpath)))
    assert xrep["total_requests"] == 1
    unt = xrep["groups"][0]
    assert (unt["tenant"], unt["bucket"]) == ("untagged", "untagged")
    assert unt["phases"]["dispatch"] == {"p50_ms": 5.0, "p99_ms": 5.0}
    assert unt["phases"]["materialize"] == {"p50_ms": 2.0, "p99_ms": 2.0}
    assert unt["e2e"] == {"p50_ms": 7.0, "p99_ms": 7.0}
    lat = by_key[("lat_t", "8")]
    assert lat["requests"] == 2
    assert lat["e2e"] == {"p50_ms": 10.0, "p99_ms": 30.0}
    assert lat["phases"]["dispatch"]["p99_ms"] == 25.0
    assert lat["phases"]["admit"] == {"p50_ms": 1.0, "p99_ms": 1.0}
    assert "decode" not in lat["phases"]
    assert lat["pad_frac_p50"] == 0.0
    dec = by_key[("dec_t", "decode")]
    assert dec["phases"]["decode"] == {"p50_ms": 17.0, "p99_ms": 17.0}
    assert "batch_wait" not in dec["phases"]
    only = latency_report.report(latency_report.load_chains(str(path)),
                                 tenant="dec_t")
    assert [g["tenant"] for g in only["groups"]] == ["dec_t"]
    text = latency_report.render(rep)
    assert "lat_t" in text and "dec_t" in text and "PAD" in text


def test_latency_report_matches_reference_on_the_ports_trace(tmp_path,
                                                             capsys):
    import latency_report as ref_lr   # tools/latency_report.py
    from paddle_tpu_torch.tools import latency_report as lr
    monitor.TRACER.clear()
    srv = _server(buckets=(8, 16))
    srv.warmup()
    srv.start()
    try:
        futs = [srv.submit(f"lr_{'ab'[i % 2]}",
                           {"x": np.arange(1, n + 1, dtype=np.float32)},
                           seq_len=n)
                for i, n in enumerate((3, 5, 8, 11, 16, 2, 9))]
        for f in futs:
            f.result(timeout=60)
    finally:
        srv.stop()
    paths = monitor.export(str(tmp_path / "exp"))
    path = paths["trace"]
    for kw in ({}, {"tenant": "lr_a"}, {"bucket": "16"},
               {"tenant": "lr_b", "bucket": "8"}):
        got = lr.report(lr.load_chains(path), **kw)
        want = ref_lr.report(ref_lr.load_chains(path), **kw)
        assert got == want, kw
        assert lr.render(got) == ref_lr.render(want)
    assert got["total_requests"] >= 1
    assert lr.report(lr.load_chains(path))["total_requests"] == 7
    for argv in ([path], [path, "--json"], [path, "--json", "--tenant",
                                           "lr_a"], [path, "--bucket", "8"]):
        rc = lr.main(argv)
        mine = capsys.readouterr().out
        assert rc == ref_lr.main(argv) == 0
        assert mine == capsys.readouterr().out, argv


# -- F2: a served step holds its logits once ---------------------------------

def _gpt_serving_plan(train=False):
    cfg = T.BertConfig(vocab_size=96, d_model=16, n_layer=2, n_head=2,
                       d_inner=32, max_pos=32, dropout=0.0)
    prog, startup = core.Program(), core.Program()
    with core.program_guard(prog, startup):
        if train:
            _, _, out = T.build_gpt_pretrain(cfg, 16, attn_impl="base",
                                             fused_head=False, dropout=0.0)
            ptt.optimizer.SGD(0.1).minimize(out)
        else:
            _, out = T.build_gpt_serving(cfg, 16, attn_impl="base")
    scope, exe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope, seed=3)
    return prog, scope, exe, out.name


def test_lm_head_bias_adds_into_its_dying_product(monkeypatch):
    """The served step adds each GEMM's bias into the product it no longer
    needs (the static plan counts one buffer there), so the LM head holds
    one [B, T, vocab] tensor, not two; the logits are bit for bit those of
    the out-of-place add."""
    from paddle_tpu_torch.framework import executor as ex
    prog, scope, exe, logits = _gpt_serving_plan()
    ids = np.random.RandomState(1).randint(1, 96, (2, 16))
    seen = []
    real = ex._add_in_place

    def spy(op, ctx, env, read):
        x = env[op.inputs["X"][0]]
        ptr = x.data_ptr()
        out = real(op, ctx, env, read)
        seen.append((op.outputs["Out"][0], out["Out"][0].data_ptr() == ptr))
        return out
    monkeypatch.setattr(ex, "_add_in_place", spy)
    got, = exe.run(prog, feed={"src_ids": ids}, fetch_list=[logits],
                   scope=scope)
    plan = next(p for p in exe._plans.values() if logits in p.fetch_names)
    assert logits in [n for n, _ in seen] and all(ok for _, ok in seen)
    assert len(seen) == len(plan.inplace_add) >= 5
    monkeypatch.setattr(plan, "inplace_add", frozenset())
    want, = exe.run(prog, feed={"src_ids": ids}, fetch_list=[logits],
                    scope=scope)
    np.testing.assert_array_equal(got, want)


def test_no_in_place_add_where_a_graph_or_the_statistics_read_it(
        monkeypatch):
    """Training programs differentiate their adds (the graph keeps X), and
    a full-mode numerics step reads X when it dies: neither adds in
    place."""
    from paddle_tpu_torch.framework import executor as ex
    calls = []
    monkeypatch.setattr(ex, "_add_in_place",
                        lambda *a: calls.append(a) or None)
    prog, scope, exe, loss = _gpt_serving_plan(train=True)
    ids = np.random.RandomState(2).randint(1, 96, (2, 16))
    exe.run(prog, feed={"src_ids": ids, "lm_label": ids},
            fetch_list=[loss], scope=scope)
    plan = next(p for p in exe._plans.values() if loss in p.fetch_names)
    assert not plan.inplace_add
    sprog, sscope, sexe, logits = _gpt_serving_plan()
    flags.set_flags({"FLAGS_numerics": "full"})
    try:
        sexe.run(sprog, feed={"src_ids": ids}, fetch_list=[logits],
                 scope=sscope)
    finally:
        flags.set_flags({"FLAGS_numerics": "off"})
    from paddle_tpu_torch.analysis import numerics
    numerics.ENGINE.poll(force=True)
    assert numerics.ENGINE.last_frame.act_hist.sum() > 0
    numerics.ENGINE.reset()
    assert calls == []
