"""Training with the port against the JAX package, on the CPU.

- a tiny GPT (vocab 64, d 32, 2 layers, 4 heads, d_inner 64, seq 16,
  batch 2), with ``attn_impl`` flash or base and the fused or the dense LM
  head, takes 3 Adam steps in both packages from the same numpy weights:
  the loss of every step, every parameter and every Adam accumulator agree;
- the executor runs each differentiated forward op once: one flash forward
  and one flash backward per layer and step (no recompute);
- a scope the port trained, saved with ``save_params`` /
  ``save_persistables``, loads into ``paddle_tpu`` and the reverse, and
  ``params_to_numpy`` carries weights and Adam state across.

Tolerances, measured: the loss agrees to 1.1e-7 relative, the Adam moments
to 7e-9 absolute, the parameters to 1e-6 + 1e-4 relative — except the key
third of each ``qkv.b``.  Its exact gradient is zero (softmax is invariant
to adding the same amount to every score of a row), so both packages
differentiate float32 rounding noise (|m1| ~ 3e-10 against a median of
6e-4) and Adam normalizes the noise into steps of up to ``lr``: there the
parameters differ by up to 3e-5 after 3 steps at lr 1e-3, and are held to
within ``3 * lr`` of each other, the most 3 Adam steps can move them.  The
reference runs op by op (``jax.disable_jit``) so that it rounds the bf16
products of the fused head as the port (and the TPU) does; jitted on the
CPU, XLA keeps those products in float32 (see ``test_torch_backward.py``).
"""


import jax
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.models import transformer as RT
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework import core, scope, unique_name
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import transformer as T
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CFG = dict(vocab_size=64, d_model=32, n_layer=2, n_head=4, d_inner=64,
           max_pos=16, dropout=0.0)
SEQ, BATCH, LR, STEPS = 16, 2, 1e-3, 3
LOSS_TOL = dict(rtol=1e-6, atol=0)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
ACC_TOL = dict(rtol=1e-4, atol=2e-8)


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


def _build(pkg, attn_impl="flash", fused_head=True):
    if pkg == "ref":
        main, startup = RefProgram(), RefProgram()
        with ref_guard(main, startup), ref_names.guard():
            _, _, loss = RT.build_gpt_pretrain(
                RT.BertConfig(**CFG), SEQ, attn_impl=attn_impl,
                fused_head=fused_head, dropout=0.0)
            ref_opt.AdamOptimizer(LR).minimize(loss)
    else:
        main, startup = core.Program(), core.Program()
        with core.program_guard(main, startup), unique_name.guard():
            _, _, loss = T.build_gpt_pretrain(
                T.BertConfig(**CFG), SEQ, attn_impl=attn_impl,
                fused_head=fused_head, dropout=0.0)
            opt.AdamOptimizer(LR).minimize(loss)
    return main, startup, loss.name


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = 0                     # [PAD]: excluded from the loss
    return {"src_ids": ids, "lm_label": labels}


def _ref_init(startup, seed=7):
    ref_scope = RefScope()
    RefExecutor().run(startup, scope=ref_scope, seed=seed)
    return ref_scope, {v.name: np.asarray(ref_scope.find_var(v.name))
                       for v in startup.global_block().vars.values()}


def _ref_step(exe, main, loss, ref_scope, feed):
    with jax.disable_jit():
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=ref_scope)
    return float(np.asarray(out))


def _assert_state_close(names, ref_scope, port_scope):
    d = CFG["d_model"]
    for n in names:
        r = np.asarray(ref_scope.find_var(n))
        g = port_scope.find_var(n).numpy()
        if n.endswith("attn.qkv.b"):
            # the key third has a zero gradient: Adam steps on noise
            np.testing.assert_allclose(g[d:2 * d], r[d:2 * d], rtol=0,
                                       atol=STEPS * LR, err_msg=n)
            g, r = np.concatenate([g[:d], g[2 * d:]]), \
                np.concatenate([r[:d], r[2 * d:]])
        tol = PARAM_TOL if "_moment" not in n else ACC_TOL
        np.testing.assert_allclose(g, r, err_msg=n, **tol)


@pytest.mark.parametrize("fused_head", [True, False],
                         ids=["fused_head", "dense_head"])
@pytest.mark.parametrize("attn_impl", ["flash", "base"])
def test_three_adam_steps_match_reference(attn_impl, fused_head):
    ref_main, ref_startup, ref_loss = _build("ref", attn_impl, fused_head)
    main, _, loss = _build("port", attn_impl, fused_head)
    ref_scope, init = _ref_init(ref_startup)
    port_scope = ptt.io.params_from_numpy(scope.Scope(), init)
    exe, ref_exe = ptt.Executor(ptt.CPUPlace()), RefExecutor()
    feed = _feed()
    losses = []
    for _ in range(STEPS):
        want = _ref_step(ref_exe, ref_main, ref_loss, ref_scope, feed)
        got, = exe.run(main, feed=feed, fetch_list=[loss], scope=port_scope)
        np.testing.assert_allclose(float(got), want, **LOSS_TOL)
        losses.append(float(got))
    assert losses[-1] < losses[0]
    moments = [n for n in init if "_moment" in n]
    assert len(moments) == 2 * len(main.all_parameters())
    _assert_state_close(init, ref_scope, port_scope)
    # the beta powers stepped 3 times
    b1 = [n for n in init if "beta1_pow_acc" in n][0]
    np.testing.assert_allclose(port_scope.find_var(b1).numpy(),
                               [0.9 ** (STEPS + 1)], rtol=1e-6)


def test_each_forward_op_runs_once_per_step(monkeypatch):
    """One flash forward and one flash backward per layer and step: the
    grad ops take the forward's graph instead of re-running it."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_fwd", count_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", count_bwd)
    main, startup, loss = _build("port", "flash", True)
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc, seed=1)
    assert calls == {"fwd": 0, "bwd": 0}
    for step in range(1, 3):
        exe.run(main, feed=_feed(step), fetch_list=[loss], scope=sc)
        assert calls == {"fwd": CFG["n_layer"] * step,
                         "bwd": CFG["n_layer"] * step}
    # the plan of the training program (the fused program the executor
    # runs in place of ``main``)
    plan = next(p for p in exe._plans.values()
                if any(op.type == "adam" for op, _ in p.ops))
    assert plan.fwd_of and None not in plan.fwd_of.values()
    assert len(plan.wanted) == len(plan.fwd_of)


def test_grad_ops_without_their_forward_recompute_it(monkeypatch):
    """A grad op whose forward op the plan cannot find (here: the fused
    dense + gelu ops of the FFNs are hidden from the pairing) recomputes its
    forward and gives the same step."""
    from paddle_tpu_torch.framework import executor as executor_mod
    main, startup, loss = _build("port", "base", False)
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc, seed=1)
    paired_sc = scope.Scope()
    for n, v in sc.items():
        paired_sc.set_var(n, v.clone())
    want, = exe.run(main, feed=_feed(), fetch_list=[loss], scope=paired_sc)

    key = executor_mod._fwd_key
    monkeypatch.setattr(executor_mod, "_fwd_key", lambda op: (
        ("hidden", id(op)) if op.type == "fused_dense_act" else key(op)))
    exe2 = ptt.Executor(ptt.CPUPlace())
    got, = exe2.run(main, feed=_feed(), fetch_list=[loss], scope=sc)
    plan, = exe2._plans.values()
    unpaired = [plan.ops[i][0].type for i, j in plan.fwd_of.items()
                if j is None]
    assert unpaired == ["fused_dense_act_grad"] * CFG["n_layer"]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for p in main.all_parameters():
        np.testing.assert_allclose(sc.find_var(p.name).numpy(),
                                   paired_sc.find_var(p.name).numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=p.name)


def test_port_trained_scope_loads_into_reference(tmp_path):
    main, startup, loss = _build("port")
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc, seed=3)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=sc)
    ptt.io.save_params(dirname=str(tmp_path / "p"), main_program=main,
                       scope=sc)
    ptt.io.save_persistables(dirname=str(tmp_path / "all"),
                             main_program=main, scope=sc,
                             filename="state.npz")
    ref_main, _, _ = _build("ref")
    for dirname, loader, filename in (
            ("p", pt.io.load_params, None),
            ("all", pt.io.load_persistables, "state.npz")):
        ref_scope = RefScope()
        loader(dirname=str(tmp_path / dirname), main_program=ref_main,
               scope=ref_scope, filename=filename)
        pred = (lambda v: v.is_parameter) if dirname == "p" else \
            (lambda v: v.persistable)
        names = [v.name for v in ref_main.list_vars() if pred(v)]
        assert names
        for n in names:
            np.testing.assert_array_equal(
                np.asarray(ref_scope.find_var(n)), sc.find_var(n).numpy())


def test_reference_trained_state_trains_on_in_the_port(tmp_path):
    """The reference trains a step and saves its persistables (weights,
    Adam moments, beta powers, learning rate); the port loads them and
    takes the next step as the reference does; ``params_to_numpy`` carries
    the port's state back and the reference continues from it."""
    ref_main, ref_startup, ref_loss = _build("ref")
    ref_scope, _ = _ref_init(ref_startup)
    ref_exe = RefExecutor()
    _ref_step(ref_exe, ref_main, ref_loss, ref_scope, _feed(0))
    pt.io.save_persistables(dirname=str(tmp_path / "s"),
                            main_program=ref_main, scope=ref_scope)

    main, _, loss = _build("port")
    sc = scope.Scope()
    ptt.io.load_persistables(dirname=str(tmp_path / "s"), main_program=main,
                             scope=sc)
    exe = ptt.Executor(ptt.CPUPlace())
    want = _ref_step(ref_exe, ref_main, ref_loss, ref_scope, _feed(1))
    got, = exe.run(main, feed=_feed(1), fetch_list=[loss], scope=sc)
    np.testing.assert_allclose(float(got), want, **LOSS_TOL)

    state = ptt.io.params_to_numpy(sc)
    assert set(state) == {v.name for v in main.list_vars() if v.persistable}
    back = RefScope()
    for n, a in state.items():
        back.set_var(n, a)
    want = _ref_step(ref_exe, ref_main, ref_loss, ref_scope, _feed(2))
    again = _ref_step(ref_exe, ref_main, ref_loss, back, _feed(2))
    got, = exe.run(main, feed=_feed(2), fetch_list=[loss], scope=sc)
    np.testing.assert_allclose([float(got), again], [want, want],
                               **LOSS_TOL)


def test_save_replaces_an_earlier_save_whole(tmp_path):
    main, startup, _ = _build("port")
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc, seed=3)
    d = tmp_path / "p"
    ptt.io.save_params(dirname=str(d), main_program=main, scope=sc)
    (d / "notes.txt").write_text("kept")
    w = main.all_parameters()[0].name
    sc.set_var(w, sc.find_var(w) + 1)
    ptt.io.save_params(dirname=str(d), main_program=main, scope=sc)
    assert (d / "notes.txt").read_text() == "kept"
    assert not list(tmp_path.glob("p.*"))        # no staging dir left
    back = scope.Scope()
    ptt.io.load_params(dirname=str(d), main_program=main, scope=back)
    np.testing.assert_array_equal(back.find_var(w).numpy(),
                                  sc.find_var(w).numpy())
