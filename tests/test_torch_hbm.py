"""The port's ``hbm.py`` and ``memory.py`` against the JAX package's, on
the CPU.

- the HBM accountant: from the same injected live-bytes samples, scope
  contents, KV-pool and capture bytes, both accountants publish the same
  live, windowed peak, budget, headroom, drift and per-class gauges, and
  the headroom-regression trigger (warm-up, hysteresis) fires on the same
  samples;
- OOM forensics: the dump's budget arithmetic re-adds, the requested size
  is read from PyTorch's "Tried to allocate 2.00 GiB" and from the
  reference's XLA messages (the same bytes as the reference's parser), and
  ``paddle_tpu_oom_total{site}`` counts;
- the executor's OOM path on the CPU: the ``memory.oom`` drill raises the
  injected fault with the summary and the dump appended and keeps the
  plan; an out-of-memory error out of an op is re-raised with the same
  report and drops the plan;
- the wirings: the executor's step hook feeds the accountant (params and
  optimizer state attributed from the scope), ``PagedKVCache`` registers
  its pools (``kv_pages`` = ``pool_bytes()``), the checkpoint daemon
  reports and clears its capture bytes;
- ``memory.live_bytes`` on the host is the live scopes' CPU tensor bytes,
  ``summary`` names the scope's tensors, ``_is_oom_error`` knows
  ``torch.cuda.OutOfMemoryError``.
"""

import os
import re

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu import flags as ref_flags
from paddle_tpu import hbm as ref_hbm
from paddle_tpu import monitor as ref_monitor
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu_torch import flags, hbm, memory, monitor
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch import resilience
from paddle_tpu_torch.framework import core, registry, unique_name
from paddle_tpu_torch.models import transformer as T
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CFG = dict(vocab_size=64, d_model=32, n_layer=2, n_head=4, d_inner=64,
           max_pos=16, dropout=0.0)


@pytest.fixture(autouse=True)
def _reset():
    yield
    for f in (flags, ref_flags):
        f.set_flags({"FLAGS_memory_budget_mb": 0, "FLAGS_fault_inject": "",
                     "FLAGS_oom_dump_dir": ""})
    hbm.set_ckpt_capture_bytes(0)
    ref_hbm.set_ckpt_capture_bytes(0)


def _gauges(mod, mon):
    def val(name, **labels):
        fam = mon.REGISTRY.get(name)
        series = {tuple(sorted(lb.items())): c.get()
                  for lb, c in fam.series()}
        return series.get(tuple(sorted(labels.items())))
    out = {n: val(f"paddle_tpu_hbm_{n}")
           for n in ("live_bytes", "peak_bytes", "budget_bytes",
                     "headroom_bytes", "plan_drift")}
    out.update({c: val("paddle_tpu_hbm_class_bytes", cls=c)
                for c in ("params", "opt_state", "activations",
                          "lazy_fetch", "ckpt_capture", "kv_pages")})
    return {k: None if v is None else float(v) for k, v in out.items()}


def test_accountant_publishes_as_reference(monkeypatch):
    sizes = {"w": (64, 32), "b": (32,), "m1": (64, 32), "m2": (64, 32)}
    ref_scope, scope = RefScope(), ptt.Scope()
    for n, s in sizes.items():
        ref_scope.set_var(n, np.zeros(s, np.float32))
        scope.set_var(n, torch.zeros(s))
    info = {"params": frozenset({"w", "b"}),
            "opt_state": frozenset({"m1", "m2"}),
            "plan_steady": 40000, "plan_peak": 90000, "plan_batch": 4}
    kv, ckpt = 3000, 512
    monkeypatch.setattr(hbm, "_kv_pool_bytes", lambda: kv)
    monkeypatch.setattr(ref_hbm, "_kv_pool_bytes", lambda: kv)
    hbm.set_ckpt_capture_bytes(ckpt)
    ref_hbm.set_ckpt_capture_bytes(ckpt)
    acc, ref_acc = hbm.HBMAccountant(), ref_hbm.HBMAccountant()
    acc.configure(True, 1, 3, 0.0)
    ref_acc.configure(True, 1, 3, 0.0)
    samples = [(50000, 0), (61000, 0), (45000, 1), (70000, 1), (52000, 0)]
    for step, (live, budget_mb) in enumerate(samples):
        flags.set_flags({"FLAGS_memory_budget_mb": budget_mb})
        ref_flags.set_flags({"FLAGS_memory_budget_mb": budget_mb})
        monkeypatch.setattr(hbm, "measure_live_bytes", lambda: live)
        monkeypatch.setattr(ref_hbm, "measure_live_bytes", lambda: live)
        acc._sample(step, scope, info, 100)
        got = _gauges(hbm, monitor)
        ref_acc._sample(step, ref_scope, info, 100)
        want = _gauges(ref_hbm, ref_monitor)
        assert got == want, (step, got, want)
        assert got["live_bytes"] == live
        assert got["params"] == (64 * 32 + 32) * 4
        assert acc.last_sample == ref_acc.last_sample
    # the peak is over the last 3 samples
    assert _gauges(hbm, monitor)["peak_bytes"] == 70000


def test_headroom_regression_trigger_as_reference():
    acc, ref_acc = hbm.HBMAccountant(), ref_hbm.HBMAccountant()
    acc.configure(True, 1, 16, 0.3)
    ref_acc.configure(True, 1, 16, 0.3)
    rooms = [100.0, 110, 105, 100, 90, 70, 60, 75, 100, 60, 50, None, 0]
    got = [acc._observe_headroom_locked(h) for h in rooms]
    want = [ref_acc._observe_headroom_locked(h) for h in rooms]
    assert got == want and got.count(True) == 2


def test_note_step_drains_off_thread():
    acc = hbm.HBMAccountant()
    acc.configure(True, 1, 4, 0.0)
    scope = ptt.Scope()
    scope.set_var("w", torch.ones(10))
    ok = monitor.REGISTRY.get("paddle_tpu_hbm_samples_total").value(
        outcome="ok")
    for step in range(3):
        acc.note_step(step, scope, {"params": frozenset({"w"}),
                                    "opt_state": frozenset()}, 0)
    assert acc.drain(10)
    assert monitor.REGISTRY.get("paddle_tpu_hbm_samples_total").value(
        outcome="ok") >= ok + 1
    assert acc.last_sample[0] == hbm.measure_live_bytes()


@pytest.mark.parametrize("msg", [
    "RESOURCE_EXHAUSTED: Out of memory allocating 123456 bytes.",
    "Out of memory while trying to allocate 1.21G.",
    "while trying to allocate 99999 bytes",
    "allocate 3.5MiB",
    "no size here"])
def test_parse_requested_bytes_as_reference(msg):
    assert hbm.parse_requested_bytes(msg) == \
        ref_hbm.parse_requested_bytes(msg)


def test_parse_requested_bytes_pytorch_form():
    msg = ("CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a "
           "total capacity of 79.19 GiB of which 1.06 GiB is free.")
    assert hbm.parse_requested_bytes(msg) == 2 << 30
    assert hbm.parse_requested_bytes(
        "Tried to allocate 20.00 MiB (GPU 0; 15.78 GiB total)") == 20 << 20


def _dump_numbers(path):
    nums = {}
    for line in open(path):
        m = re.match(r"^(\w+_bytes|measured_plus_requested): (-?\d+)$",
                     line.strip())
        if m:
            nums[m.group(1)] = int(m.group(2))
    return nums


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


def test_oom_forensics_dump_adds_up(tmp_path):
    flags.set_flags({"FLAGS_oom_dump_dir": str(tmp_path),
                     "FLAGS_memory_budget_mb": 1})
    exe, main, scope, feed, loss = _tiny_train()
    n = hbm.OOM_CTR.value(site="dispatch")
    err = RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB.")
    path = hbm.oom_forensics(err, scope=scope, program=main,
                             fetch_names=[loss.name], batch=2)
    assert hbm.OOM_CTR.value(site="dispatch") == n + 1
    assert os.path.dirname(path) == str(tmp_path)
    nums = _dump_numbers(path)
    assert nums["requested_bytes"] == 2 << 30
    assert nums["budget_bytes"] == 1 << 20
    assert nums["measured_bytes"] == memory.live_bytes() > 0
    assert nums["measured_plus_requested"] == \
        nums["measured_bytes"] + nums["requested_bytes"]
    assert nums["deficit_bytes"] == \
        nums["measured_plus_requested"] - nums["budget_bytes"]
    from paddle_tpu_torch.analysis.memory import plan_memory
    plan = plan_memory(main, [loss.name], batch_size=2)
    assert nums["plan_peak_bytes"] == plan.peak_bytes
    text = open(path).read()
    assert f"peak {hbm._fmt(plan.peak_bytes)} at op #{plan.peak_pos}" in text
    top_name = plan.peak_live[0][0]
    assert re.search(rf"\s{re.escape(top_name)}$", text, re.M)
    assert "=== paddle_tpu_torch device memory summary ===" in text


def test_executor_oom_drill_keeps_plan(tmp_path):
    flags.set_flags({"FLAGS_oom_dump_dir": str(tmp_path)})
    exe, main, scope, feed, loss = _tiny_train()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    n = hbm.OOM_CTR.value(site="injected")
    traces = exe.dispatch_stats()["traces"]
    flags.set_flags({"FLAGS_fault_inject": "memory.oom:once"})
    with pytest.raises(resilience.InjectedFault) as ei:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    flags.set_flags({"FLAGS_fault_inject": ""})
    msg = str(ei.value)
    assert msg.startswith("injected fault at 'memory.oom'")
    assert "device memory summary" in msg
    dump = re.search(r"oom forensics dump: (\S+)", msg).group(1)
    assert os.path.isfile(dump)
    assert hbm.OOM_CTR.value(site="injected") == n + 1
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe.dispatch_stats()["traces"] == traces      # plan kept


def test_executor_real_oom_drops_plan(tmp_path, monkeypatch):
    flags.set_flags({"FLAGS_oom_dump_dir": str(tmp_path)})
    exe, main, scope, feed, loss = _tiny_train()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    plan, = [p for p in exe._plans.values()
             if any(op.type == "adam" for op, _ in p.ops)]
    op_type = plan.ops[0][0].type
    real = registry.get_op_info(op_type)

    def oom(ctx, ins, attrs):
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB.")

    monkeypatch.setattr(real, "lower", oom)
    n = hbm.OOM_CTR.value(site="dispatch")
    traces = exe.dispatch_stats()["traces"]
    with pytest.raises(RuntimeError) as ei:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    msg = str(ei.value)
    assert "CUDA out of memory" in msg and "oom forensics dump:" in msg
    assert memory._is_oom_error(ei.value.__cause__)
    assert hbm.OOM_CTR.value(site="dispatch") == n + 1
    monkeypatch.undo()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe.dispatch_stats()["traces"] == traces + 1  # plan dropped


def test_executor_feeds_the_accountant():
    exe, main, scope, feed, loss = _tiny_train()
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert hbm.ACCOUNTANT.drain(30)
    plan, = [p for p in exe._plans.values()
             if any(op.type == "adam" for op, _ in p.ops)]
    info = plan.hbm_info
    params = sum(scope.find_var(n).numel() * 4 for n in info["params"])
    opt_state = sum(scope.find_var(n).numel() * 4
                    for n in info["opt_state"])
    cls = {lb["cls"]: c.get() for lb, c in
           hbm.HBM_CLASS_GAUGE.series()}
    assert info["params"] == {p.name for p in main.all_parameters()}
    assert cls["params"] == params and cls["opt_state"] == opt_state
    assert info["plan_steady"] > 0 and info["plan_peak"] > \
        info["plan_steady"]
    assert hbm.HBM_LIVE_GAUGE.value() > 0


def test_kv_pool_registers_its_bytes():
    from paddle_tpu_torch.serving.kv_cache import PagedKVCache
    before = hbm._kv_pool_bytes()
    cache = PagedKVCache(2, 9, 4, 2, 8, 2)
    assert cache in hbm._kv_pools
    assert hbm._kv_pool_bytes() == before + cache.pool_bytes() > before
    del cache
    import gc
    gc.collect()
    assert hbm._kv_pool_bytes() == before


def test_daemon_reports_and_clears_capture_bytes(tmp_path, monkeypatch):
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.tools import preempt_runner as pr
    reports = []
    monkeypatch.setattr(hbm, "set_ckpt_capture_bytes", reports.append)
    main, start, loss = pr.build("tiny")
    ck = checkpoint.CheckpointManager(str(tmp_path))
    exe, sc = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    exe.run(start, scope=sc)
    daemon = resilience.CheckpointDaemon(ck, program=main, scope=sc,
                                         interval_steps=1,
                                         capture_chunk_mb=1).start()
    exe.run(main, feed=pr.batch("tiny", 0), fetch_list=[loss], scope=sc)
    assert daemon.step_completed(1) and daemon.stop() == 1
    # host tensors take no card copies: every report is a clear
    assert reports and set(reports) == {0}


def test_live_bytes_summary_and_oom_test():
    scope = ptt.Scope()
    before = memory.live_bytes()
    scope.set_var("big", torch.zeros(1000, 10))
    scope.set_var("view", scope.find_var("big")[:10])   # same storage
    assert memory.live_bytes() == before + 40000
    text = memory.summary(scope)
    assert "big" in text and "(1000, 10)" in text
    assert memory.device_memory_stats() == {}
    assert memory._is_oom_error(torch.cuda.OutOfMemoryError("x"))
    assert memory._is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: y"))
    assert not memory._is_oom_error(ValueError("bad shape"))
    assert hbm.budget_bytes() == 0
    flags.set_flags({"FLAGS_memory_budget_mb": 5})
    assert hbm.budget_bytes() == 5 << 20


def test_record_plans_flag_and_plan_store():
    assert not hbm.plans_enabled()
    flags.set_flags({"FLAGS_hbm_record_plans": True})
    try:
        assert hbm.plans_enabled()
    finally:
        flags.set_flags({"FLAGS_hbm_record_plans": False})
    entry = hbm.record_xla_plan("t", hbm._MeasuredPlan(1000, 4000))
    assert entry["peak_bytes"] == 4000 and entry["temp_bytes"] == 3000
    tag2 = memory.record_hbm_plan("t", hbm._MeasuredPlan(10, 20))
    assert tag2.startswith("t#")
