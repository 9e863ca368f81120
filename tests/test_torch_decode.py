"""The decode slice: the reference's paged-KV decode path (JAX on the CPU)
and the port's (``DecodeEngine(place=CPUPlace())``) on the same weights, at
the reference tests' tiny GPT (``tests/test_serving.py``).

Checks:
- the port's ``GPTDecodeModel`` step against the reference's on the same
  pools, ids, positions, page table and active mask (some slots inactive,
  partly filled tables, a page boundary crossed), three steps in a row:
  logits and both pools (scratch page 0 aside, whose writes race in
  both) within atol 1e-5, rtol 1e-5;
- ``DecodeServer`` generation token for token against the reference's
  ``DecodeServer`` and against the greedy continuation of the port's
  full-context program (``build_gpt_serving``);
- pool accounting, slot reuse with ``trace_count == 1`` and every page
  freed, EOS, the context-window and empty-prompt ``AdmissionError`` s, a
  pool too tight for two requests at once (serialized, no deadlock);
- an injected transient fault is absorbed (``faults_absorbed_total`` + 1);
  a non-transient one fails only the stepped requests and frees their
  pages, and the server serves the next request;
- ``statusz()`` and ``kv_census()`` keys equal the reference's,
  ``memory.budget_mb`` included;
- ``params_from_scope``'s ``KeyError``; ``DecodeEngine()`` needs a GPU;
  the fault-injection flag's parsing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt  # noqa: F401
import paddle_tpu_torch as ptt
from paddle_tpu import serving as ref_serving
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.models import transformer as RT
from paddle_tpu_torch import flags, resilience
from paddle_tpu_torch.framework import core, scope, unique_name
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.serving import scheduler as port_sched
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CFG = dict(vocab_size=48, d_model=16, n_layer=2, n_head=2, d_inner=32,
           max_pos=64, dropout=0.0)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
CPU = ptt.CPUPlace()


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


@pytest.fixture(scope="module")
def weights():
    """Reference-initialized weights of the tiny GPT, as numpy (the seed of
    ``tests/test_serving.py``'s ``gpt_model``)."""
    cfg = RT.BertConfig(**CFG)
    startup = RefProgram()
    with ref_guard(RefProgram(), startup):
        RT.build_gpt_serving(cfg, 8, attn_impl="base")
    ref_scope = RefScope()
    RefExecutor().run(startup, scope=ref_scope, seed=7)
    return {v.name: np.asarray(ref_scope.find_var(v.name))
            for v in startup.global_block().vars.values()}


def _ref_scope(weights):
    s = RefScope()
    for n, a in weights.items():
        s.set_var(n, jnp.asarray(a))
    return s


def _engine(weights, **kw):
    return ptt.serving.DecodeEngine(T.BertConfig(**CFG), weights,
                                    place=CPU, **kw)


def test_step_matches_reference_step(weights):
    page_len, max_pages, n_pages, S = 4, 4, 12, 4
    rcfg, cfg = RT.BertConfig(**CFG), T.BertConfig(**CFG)
    rng = np.random.RandomState(3)
    shape = (cfg.n_layer, n_pages, page_len, cfg.n_head,
             cfg.d_model // cfg.n_head)
    k0 = rng.randn(*shape).astype(np.float32)
    v0 = rng.randn(*shape).astype(np.float32)
    # partly filled tables; unallocated entries 0 (masked off by pos)
    table = np.array([[3, 7, 0, 0], [5, 0, 0, 0], [1, 9, 0, 0],
                      [2, 4, 6, 8]], np.int32)
    # slot 0 in page 1; slot 1 inactive; slot 2 crosses from page 0 to
    # page 1 after the first step; slot 3 leaves after the second step
    pos = np.array([5, 0, 3, 13])
    active = np.array([True, False, True, True])
    ref_model = ref_serving.GPTDecodeModel(rcfg, page_len, max_pages)
    port_model = ptt.serving.GPTDecodeModel(cfg, page_len, max_pages)
    ref_params = {n: jnp.asarray(a) for n, a in weights.items()}
    port_params = {n: torch.from_numpy(a.copy()) for n, a in weights.items()}
    rk, rv = jnp.asarray(k0), jnp.asarray(v0)
    pk, pv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    for step in range(3):
        ids = rng.randint(1, cfg.vocab_size, (S,)).astype(np.int32)
        if step == 2:
            active[3] = False
        rl, rk, rv = ref_model.step(ref_params, rk, rv, ids, pos, table,
                                    active)
        pl = port_model.step(port_params, pk, pv, ids, pos, table, active)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **STEP_TOL)
        for got, want in ((pk, rk), (pv, rv)):
            np.testing.assert_allclose(got.numpy()[:, 1:],
                                       np.asarray(want)[:, 1:], **STEP_TOL)
        pos = pos + active
    assert ref_model.trace_count == port_model.trace_count == 1


def _prompts():
    rng = np.random.RandomState(1)
    return [rng.randint(1, CFG["vocab_size"],
                        (int(rng.randint(2, 7)),)).astype(np.int64)
            for _ in range(4)]


def _generate(srv, prompts, max_new=5):
    srv.start()
    futs = [srv.submit("pt_a" if i % 2 else "pt_b", p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    gens = [list(map(int, f.result(timeout=120))) for f in futs]
    assert srv.drain(10)
    srv.stop()
    return gens


def _port_program_greedy(weights, prompt, n, seq=16):
    """Greedy continuation through ONE fixed-length full-context program
    (causal: right padding never reaches position len(toks) - 1)."""
    cfg = T.BertConfig(**CFG)
    prog = core.Program()
    with core.program_guard(prog, core.Program()):
        _, logits = T.build_gpt_serving(cfg, seq, attn_impl="base")
    port_scope = ptt.io.params_from_numpy(scope.Scope(), weights)
    exe = ptt.Executor(CPU)
    toks, out = list(map(int, prompt)), []
    for _ in range(n):
        feed = np.zeros((1, seq), np.int64)
        feed[0, :len(toks)] = toks
        lg, = exe.run(prog, feed={"src_ids": feed}, fetch_list=[logits],
                      scope=port_scope)
        out.append(int(np.argmax(lg[0, len(toks) - 1])))
        toks.append(out[-1])
    return out


def test_generation_matches_reference_server_and_program(weights):
    prompts = _prompts()
    rcfg = RT.BertConfig(**CFG)
    ref = _generate(ref_serving.DecodeServer(ref_serving.DecodeEngine(
        rcfg, _ref_scope(weights), max_slots=3, page_len=4, max_seq=32)),
        prompts)
    eng = _engine(weights, max_slots=3, page_len=4, max_seq=32)
    got = _generate(ptt.serving.DecodeServer(eng), prompts)
    assert got == ref
    for p, g in zip(prompts, got):
        assert g == _port_program_greedy(weights, p, 5)
    assert eng.trace_count == 1 and eng.cache.pages_in_use() == 0


def test_paged_cache_pool_accounting():
    cache = ptt.serving.PagedKVCache(n_layers=1, n_pages=4, page_len=2,
                                     n_head=1, d_head=4, max_slots=2)
    p1 = cache.alloc_page(0)
    p2 = cache.alloc_page(0)
    p3 = cache.alloc_page(1)
    assert {p1, p2, p3} <= {1, 2, 3} and len({p1, p2, p3}) == 3
    assert cache.alloc_page(1) is None       # exhausted (page 0 reserved)
    assert cache.pages_in_use() == 3
    assert cache.pages_of(0) == [p1, p2]
    assert cache.free_slot(0) == 2
    assert cache.pages_in_use() == 1
    assert cache.alloc_page(1) is not None   # freed pages reused
    cache.free_slot(1)
    assert cache.pages_in_use() == 0
    assert cache.pool_bytes() == 2 * 4 * 2 * 1 * 4 * 4
    cache.k.fill_(1.0)
    k_ptr = cache.k.data_ptr()
    cache.reinit_pools()                     # zeroed in place
    assert cache.k.data_ptr() == k_ptr and not cache.k.any()
    with pytest.raises(ValueError, match="page 0"):
        ptt.serving.PagedKVCache(1, 1, 2, 1, 4, 1)


def test_slot_reuse_no_rebuild_pages_freed(weights):
    eng = _engine(weights, max_slots=2, page_len=4, max_seq=32)
    srv = ptt.serving.DecodeServer(eng).start()
    rng = np.random.RandomState(2)
    # 6 requests through 2 slots: joins/leaves between iterations
    futs = [srv.submit("pt_a", rng.randint(1, CFG["vocab_size"],
                                           (3 + i % 4,)), max_new_tokens=3)
            for i in range(6)]
    for f in futs:
        assert len(f.result(timeout=60)) == 3
    assert eng.trace_count == 1            # ONE step built, ever
    assert eng.cache.pages_in_use() == 0   # every page recycled
    f = srv.submit("pt_b", rng.randint(1, CFG["vocab_size"], (4,)),
                   max_new_tokens=2)
    assert len(f.result(timeout=60)) == 2
    assert srv.compile_stats() == {"traces": 1, "kv_pages_in_use": 0}
    assert all(r["occupancy"] >= 1 for r in srv.iter_log())
    assert srv.drain(10)
    srv.stop()


def test_eos_and_admission_errors(weights):
    eng = _engine(weights, max_slots=1, page_len=4, max_seq=32)
    srv = ptt.serving.DecodeServer(eng).start()
    prompt = np.asarray([3, 9, 17], np.int64)
    first = srv.submit("pt_a", prompt, max_new_tokens=6).result(timeout=60)
    assert len(first) == 6
    # the same greedy decode with eos at the first generated token stops
    gen = srv.submit("pt_a", prompt, max_new_tokens=6,
                     eos_id=int(first[0])).result(timeout=60)
    assert list(gen) == [int(first[0])]
    # the context window and an empty prompt are admission errors
    for bad in (srv.submit("pt_a", np.arange(1, 30), max_new_tokens=10),
                srv.submit("pt_a", [], max_new_tokens=2)):
        assert bad.done()
        with pytest.raises(ptt.serving.AdmissionError):
            bad.result(0)
    assert srv.tenants.rejected == {("pt_a", "too_long"): 2}
    assert srv.drain(10)
    srv.stop()
    late = srv.submit("pt_a", prompt)
    with pytest.raises(ptt.serving.AdmissionError, match="draining"):
        late.result(0)


def test_tight_pool_no_deadlock(weights):
    # each request needs ceil((4+4)/2) = 4 pages; the pool holds 5 usable:
    # optimistic admission would start both and wedge mid-growth
    eng = _engine(weights, max_slots=2, page_len=2, max_seq=8, n_pages=6)
    srv = ptt.serving.DecodeServer(eng).start()
    rng = np.random.RandomState(5)
    futs = [srv.submit("pool_t", rng.randint(1, CFG["vocab_size"], (4,)),
                       max_new_tokens=4) for _ in range(2)]
    for f in futs:
        assert len(f.result(timeout=60)) == 4
    assert eng.cache.pages_in_use() == 0
    # serialized: never both requests in the batch at once
    assert max(r["occupancy"] for r in srv.iter_log()) == 1
    srv.stop()


def test_injected_fault_is_absorbed(weights):
    eng = _engine(weights, max_slots=2, page_len=4, max_seq=32)
    srv = ptt.serving.DecodeServer(eng).start()
    before = port_sched.FAULTS_ABSORBED_CTR.value()
    injected = resilience._FAULT_CTR.value(site="serving.decode_step")
    flags.set_flags({"FLAGS_fault_inject": "serving.decode_step:once"})
    try:
        out = srv.submit("pt_a", [3, 9, 17], max_new_tokens=4).result(
            timeout=60)
    finally:
        flags.set_flags({"FLAGS_fault_inject": ""})
    assert len(out) == 4
    assert port_sched.FAULTS_ABSORBED_CTR.value() == before + 1
    assert resilience._FAULT_CTR.value(
        site="serving.decode_step") == injected + 1
    assert srv.drain(10)
    srv.stop()


def test_non_transient_fault_fails_the_stepped_requests_only(weights):
    eng = _engine(weights, max_slots=1, page_len=4, max_seq=32)
    real, calls = eng.run_iteration, []

    def flaky(ids, pos, active):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device fault")
        return real(ids, pos, active)

    eng.run_iteration = flaky
    srv = ptt.serving.DecodeServer(eng)
    stepped = srv.submit("pt_a", [3, 9, 17], max_new_tokens=3)
    queued = srv.submit("pt_b", [5, 6], max_new_tokens=3)
    srv.start()
    with pytest.raises(RuntimeError, match="device fault"):
        stepped.result(timeout=60)
    assert len(queued.result(timeout=60)) == 3
    nxt = srv.submit("pt_a", [3, 9, 17], max_new_tokens=3)
    assert len(nxt.result(timeout=60)) == 3
    assert eng.cache.pages_in_use() == 0
    assert srv.tenants.snapshot() == {"pt_a": 0, "pt_b": 0}
    assert srv.drain(10)
    srv.stop()


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) and k != "tenants"
            and k != "per_tenant" else None
            for k, v in d.items()}


def test_statusz_and_census_keys_match_reference(weights):
    rcfg, cfg = RT.BertConfig(**CFG), T.BertConfig(**CFG)
    ref = ref_serving.DecodeServer(ref_serving.DecodeEngine(
        rcfg, _ref_scope(weights), max_slots=2, page_len=4, max_seq=32))
    srv = ptt.serving.DecodeServer(ptt.serving.DecodeEngine(
        cfg, weights, max_slots=2, page_len=4, max_seq=32, place=CPU))
    for s in (ref, srv):     # one request admitted into a slot, not stepped
        s.submit("census_t", [3, 9, 17], max_new_tokens=4)
        with s._sched._cv:
            s._sched._admit_locked()
    r_st, p_st = ref.statusz(), srv.statusz()
    assert _keys(p_st) == _keys(r_st)
    assert p_st["memory"]["budget_mb"] == r_st["memory"]["budget_mb"] == 0
    r_row = ref._sched.kv_census()["census_t"]
    p_row = srv._sched.kv_census()["census_t"]
    assert set(p_row) == set(r_row) == \
        set(p_st["memory"]["kv"]["per_tenant"]["census_t"])
    assert p_row == {k: r_row[k] for k in p_row}
    assert p_st["slots"] == r_st["slots"] == {"total": 2, "free": 1}
    assert p_st["memory"]["kv"]["pages_in_use"] == 2


def test_params_from_scope_names_the_missing_param(weights):
    cfg = T.BertConfig(**CFG)
    s = ptt.io.params_from_numpy(scope.Scope(), weights)
    assert set(ptt.serving.params_from_scope(s, cfg)) == set(weights)
    s.erase("enc_1.ffn.fc2.b")
    with pytest.raises(KeyError, match="enc_1.ffn.fc2.b"):
        ptt.serving.params_from_scope(s, cfg)
    with pytest.raises(KeyError, match="missing from scope"):
        ptt.serving.DecodeEngine(cfg, s, place=CPU)


def test_engine_needs_a_gpu_or_the_host(weights):
    cfg = T.BertConfig(**CFG)
    with pytest.raises(AttributeError):     # a program, or nothing
        ptt.serving.DecodeEngine(cfg, weights, program=object(), place=CPU)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: DecodeEngine() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.serving.DecodeEngine(cfg, weights)


def test_fault_inject_flag_parsing():
    specs = resilience.parse_fault_inject(
        "serving.decode_step:every=3;compile:once@2,seed=1")
    assert specs["serving.decode_step"].every == 3
    assert specs["compile"].at == 2
    fire = [specs["serving.decode_step"].fire()[0] for _ in range(6)]
    assert fire == [False, False, True, False, False, True]
    for bad in ("serving.decode_step", "serving.decode_step:seed=1",
                "serving.decode_step:every=2,bogus=1",
                "serving.decode_step:p=2"):
        with pytest.raises(ValueError):
            resilience.parse_fault_inject(bad)
    # hang mode parses since the watchdog is ported
    hang = resilience.parse_fault_inject(
        "serving.decode_step:once,hang=5")["serving.decode_step"]
    assert (hang.mode, hang.hang_s, hang.at) == ("hang", 5.0, 1)
    # a malformed spec is refused before anything is applied
    with pytest.raises(ValueError):
        flags.set_flags({"FLAGS_serving_kv_page_len": 8,
                         "FLAGS_fault_inject": "nonsense"})
    assert flags.get_flags("FLAGS_serving_kv_page_len") == {
        "FLAGS_serving_kv_page_len": 16}
    assert resilience._SPECS == {}
