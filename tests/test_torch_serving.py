"""The serving slice as a whole: the reference ``InferenceServer`` (JAX on
the CPU) and the port's ``InferenceServer(executor=Executor(CPUPlace()))``
serve the same requests of a tiny GPT (the CFG of ``tests/test_serving.py``)
on the same weights.

Checks: each request's trimmed logits agree within 1e-4; the port builds
one plan per bucket (``compile_stats()["traces"] == len(buckets)``) however
many request shapes arrive; quotas reject; drain finishes everything
admitted and then refuses new work; the concurrency lint is clean on the
port.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt  # noqa: F401
import paddle_tpu_torch as ptt
from paddle_tpu import serving as ref_serving
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.models import transformer as RT
from paddle_tpu_torch.framework import core, scope, unique_name
from paddle_tpu_torch.models import transformer as T
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CFG = dict(vocab_size=48, d_model=16, n_layer=2, n_head=2, d_inner=32,
           max_pos=64, dropout=0.0)
BUCKETS = (8, 16)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    """Fresh port default programs, scope and names for every test."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


def _ref_factory(attn_impl):
    cfg = RT.BertConfig(**CFG)

    def factory(seq):
        prog, startup = RefProgram(), RefProgram()
        with ref_guard(prog, startup):
            _, logits = RT.build_gpt_serving(cfg, seq, attn_impl=attn_impl)
        return prog, ["src_ids"], [logits.name]
    return factory


def _port_factory(attn_impl):
    cfg = T.BertConfig(**CFG)

    def factory(seq):
        prog, startup = core.Program(), core.Program()
        with core.program_guard(prog, startup):
            _, logits = T.build_gpt_serving(cfg, seq, attn_impl=attn_impl)
        return prog, ["src_ids"], [logits.name]
    return factory


@pytest.fixture(scope="module")
def weights():
    """Reference-initialized weights of the tiny GPT, as numpy."""
    cfg = RT.BertConfig(**CFG)
    startup = RefProgram()
    with ref_guard(RefProgram(), startup):
        RT.build_gpt_serving(cfg, 8, attn_impl="base")
    ref_scope = RefScope()
    RefExecutor().run(startup, scope=ref_scope, seed=11)
    return {v.name: np.asarray(ref_scope.find_var(v.name))
            for v in startup.global_block().vars.values()}


def _requests():
    rng = np.random.RandomState(5)
    out = []
    for i in range(12):
        n = int(rng.randint(2, 17))
        ids = rng.randint(1, CFG["vocab_size"], (n,)).astype(np.int64)
        out.append(("acme" if i % 2 else "globex", ids))
    return out


def _serve(srv, reqs):
    assert srv.warmup() == len(BUCKETS)
    srv.start()
    futs = [srv.submit(t, {"src_ids": ids}) for t, ids in reqs]
    outs = [f.result(timeout=120) for f in futs]
    assert srv.drain(60)
    srv.stop()
    return outs


@pytest.mark.parametrize("attn_impl", ["flash", "auto"])
def test_port_server_matches_reference_server(weights, attn_impl):
    reqs = _requests()
    ref_scope = RefScope()
    for n, a in weights.items():
        ref_scope.set_var(n, jnp.asarray(a))
    ref = _serve(ref_serving.InferenceServer(
        _ref_factory(attn_impl), ref_scope, buckets=BUCKETS, max_batch=4,
        batch_wait_ms=5.0), reqs)

    port_scope = ptt.io.params_from_numpy(scope.Scope(), weights)
    srv = ptt.serving.InferenceServer(
        _port_factory(attn_impl), port_scope, buckets=BUCKETS, max_batch=4,
        executor=ptt.Executor(ptt.CPUPlace()), batch_wait_ms=5.0)
    got = _serve(srv, reqs)
    for (_, ids), r, g in zip(reqs, ref, got):
        assert g[0].shape == (len(ids), CFG["vocab_size"])
        np.testing.assert_allclose(g[0], r[0], **LOGITS_TOL)
    # 12 requests of many shapes, one plan per bucket
    assert srv.compile_stats()["traces"] == len(BUCKETS)
    assert sum(b["occupancy"] for b in srv.batch_log()) == len(reqs)


def test_quota_rejects_and_drain_finishes_admitted(weights):
    port_scope = ptt.io.params_from_numpy(scope.Scope(), weights)
    srv = ptt.serving.InferenceServer(
        _port_factory("base"), port_scope, buckets=BUCKETS, max_batch=4,
        executor=ptt.Executor(ptt.CPUPlace()), tenant_quota=2)
    ids = np.arange(1, 6, dtype=np.int64)
    admitted = [srv.submit("acme", {"src_ids": ids}) for _ in range(2)]
    over = srv.submit("acme", {"src_ids": ids})
    other = srv.submit("globex", {"src_ids": ids})
    too_long = srv.submit("globex", {"src_ids": np.ones(17, np.int64)})
    for f, reason in ((over, "quota"), (too_long, "exceeds")):
        assert f.done()
        with pytest.raises(ptt.serving.AdmissionError, match=reason):
            f.result()
    assert srv.tenants.outstanding("acme") == 2
    srv.start()
    assert srv.drain(60)
    for f in admitted + [other]:
        assert f.result(timeout=1)[0].shape == (5, CFG["vocab_size"])
    assert srv.tenants.snapshot() == {"acme": 0, "globex": 0}
    late = srv.submit("acme", {"src_ids": ids})
    with pytest.raises(ptt.serving.AdmissionError, match="draining"):
        late.result()
    srv.stop()
    assert srv.tenants.rejected == {("acme", "quota"): 1,
                                    ("globex", "too_long"): 1,
                                    ("acme", "draining"): 1}


def test_failed_batch_fails_its_futures_and_the_server_lives(weights):
    port_scope = ptt.io.params_from_numpy(scope.Scope(), weights)
    port_scope.erase("lm_out.w")
    srv = ptt.serving.InferenceServer(
        _port_factory("base"), port_scope, buckets=BUCKETS, max_batch=4,
        executor=ptt.Executor(ptt.CPUPlace())).start()
    bad = srv.submit("acme", {"src_ids": np.arange(1, 6, dtype=np.int64)})
    with pytest.raises(RuntimeError, match="lm_out.w"):
        bad.result(timeout=60)
    port_scope.set_var("lm_out.w", ptt.io.params_from_numpy(
        scope.Scope(), {"w": weights["lm_out.w"]}).find_var("w"))
    good = srv.submit("acme", {"src_ids": np.arange(1, 6, dtype=np.int64)})
    assert good.result(timeout=60)[0].shape == (5, CFG["vocab_size"])
    assert srv.drain(10)
    srv.stop()


def test_concurrency_lint_is_clean_on_the_port():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import lint_concurrency
    finally:
        sys.path.pop(0)
    violations = lint_concurrency.lint_paths(
        [os.path.join(REPO, "paddle_tpu_torch")])
    assert [str(v) for v in violations if not v.suppressed] == []


def test_scheduler_stops_dispatching_while_fetches_wait():
    """Batches whose fetches the completion thread has not copied out yet
    hold their outputs on the card: the scheduler dispatches at most
    MAX_QUEUED_BATCHES beyond the one being materialized."""
    import threading
    import time
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

    srv = ptt.serving.InferenceServer(factory, scope.Scope(), buckets=(4,),
                                      max_batch=1, executor=Exe()).start()
    futs = [srv.submit("t", {"x": np.arange(3)}) for _ in range(6)]
    deadline = time.monotonic() + 10
    while Exe.calls < 1 + sched.MAX_QUEUED_BATCHES and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert Exe.calls == 1 + sched.MAX_QUEUED_BATCHES
    release.set()
    assert [f.result(timeout=30)[0].shape for f in futs] == [(3,)] * 6
    assert Exe.calls == 6
    assert srv.drain(10)
    srv.stop()
