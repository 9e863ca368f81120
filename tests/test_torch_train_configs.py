"""The training configurations dropout unblocks: the port against the JAX
package at dropout 0.1, on the CPU.

Both packages draw the same bits: the reference's ``LowerCtx.rng_tagged``,
``LowerCtx.rng`` and ``jax.random.bits`` and the port's one byte source,
``kernels.dropout.philox_bytes``, are patched to one numpy draw keyed by
(the op's tag or counter, shape).  Each program starts from the
reference's startup state.

- a 2-layer BERT (``build_bert_pretrain``, arange positions) takes 3 Adam
  steps in float32 and 3 under ``amp.decorate`` (the fused head), and its
  ``masked_gather`` form 3 in float32;
- a 2-layer Transformer NMT (``build_transformer_nmt``) takes 3 Adam
  steps;
- (SE-ResNeXt-50's step is in ``test_torch_se_resnext.py``);
- in the port, the fused program (its FFN dropouts folded into
  ``fused_dense_act``) and the unfused one give the same losses, bit for
  bit, with the real Philox bits;
- ``gather``, ``assign_value`` and ``sigmoid`` against the reference's
  lowerings, and their gradients where they have one.

The float32 programs take the dense LM head, so the reference runs
jitted (the fused head's bf16 rounding needs it op by op, see
``test_torch_train.py``, which holds that head); the AMP program takes the
fused head and the reference runs op by op (``jax.disable_jit``).

Tolerances are ``tests/test_torch_train.py``'s (the loss 1e-6 relative,
parameters 1e-4 + 1e-6, Adam moments 1e-4 + 2e-8, the key third of each
``qkv.b`` and each cross-attention ``k.b`` within 3 lr: a key bias's
exact gradient is zero) and, under AMP,
``tests/test_torch_amp.py``'s (losses 2e-3 relative).  ``masked_gather``
differentiates 8 tokens of 32, so some gradient elements sit at the float32
noise of their tensor's largest one (8e-7 against 0.09, 1.2% apart), and
Adam normalizes such an element into a step of ~lr either way: its
parameters are held within 1e-2 lr absolute (2.4e-6 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the reference lowerings)
import paddle_tpu_torch as ptt
from paddle_tpu import amp as ref_amp
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import registry as ref_registry
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.framework.executor import LowerCtx as RefCtx
from paddle_tpu.models import transformer as RT
from paddle_tpu_torch import amp, flags
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.framework.executor import LowerCtx
from paddle_tpu_torch.models import transformer as T
from _port_fixtures import collect_garbage_after_module  # noqa: F401
from _port_fixtures import patch_same_bits

BERT = dict(vocab_size=64, d_model=32, n_layer=2, n_head=4, d_inner=64,
            max_pos=16, dropout=0.1)
SEQ, BATCH, LR, STEPS, MASKED = 16, 2, 1e-3, 3, 4
NMT = dict(src_vocab=40, trg_vocab=40, seq_len=8, d_model=16, n_layer=2,
           n_head=2, d_inner=32, dropout=0.1, fused_head=False)
LOSS_TOL = dict(rtol=1e-6, atol=0)
AMP_LOSS_RTOL = 2e-3
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
ACC_TOL = dict(rtol=1e-4, atol=2e-8)
MASKED_PARAM_TOL = dict(rtol=1e-4, atol=1e-2 * LR)
DEFAULTS = {"FLAGS_graph_fusion": True}


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)
    flags.set_flags(DEFAULTS)


@pytest.fixture
def same_bits(monkeypatch):
    """Patched after the startup programs ran (their initializers keep
    their own draws): see the module docstring."""
    return lambda: patch_same_bits(monkeypatch)


# -- the programs ------------------------------------------------------------

def _bert(M, masked=False, fused_head=False):
    cfg = M.BertConfig(**BERT)
    _, _, loss = M.build_bert_pretrain(cfg, SEQ, fused_head=fused_head,
                                       arange_pos=True,
                                       masked_gather=MASKED if masked
                                       else None)
    return loss


def _nmt(M):
    return M.build_transformer_nmt(**NMT)[2]


MODELS = {"bert": (_bert, RT, T), "masked": (lambda M: _bert(M, True),
                                             RT, T),
          "bert_fused_head": (lambda M: _bert(M, fused_head=True), RT, T),
          "nmt": (_nmt, RT, T)}


def _build(pkg, model, use_amp=False):
    fn, ref_mod, port_mod = MODELS[model]
    if pkg == "ref":
        main, startup = RefProgram(), RefProgram()
        with ref_guard(main, startup), ref_names.guard():
            loss = fn(ref_mod)
            o = ref_opt.AdamOptimizer(LR)
            (ref_amp.decorate(o) if use_amp else o).minimize(loss)
    else:
        main, startup = core.Program(), core.Program()
        with core.program_guard(main, startup), unique_name.guard():
            loss = fn(port_mod)
            o = opt.AdamOptimizer(LR)
            (amp.decorate(o) if use_amp else o).minimize(loss)
    return main, startup, loss.name


def _feed(model, seed=0):
    rng = np.random.RandomState(seed)
    if model == "nmt":
        s, v = NMT["seq_len"], NMT["src_vocab"]
        pos = np.tile(np.arange(1, s + 1), (BATCH, 1)).astype(np.int64)
        trg = rng.randint(1, v, (BATCH, s)).astype(np.int64)
        label = np.roll(trg, -1, axis=1)
        label[:, -1] = 0
        return {"src_ids": rng.randint(1, v, (BATCH, s)).astype(np.int64),
                "src_pos": pos, "trg_ids": trg, "trg_pos": pos,
                "label": label}
    ids = rng.randint(1, BERT["vocab_size"], (BATCH, SEQ)).astype(np.int64)
    if model == "masked":
        pos = np.stack([rng.choice(SEQ, MASKED, replace=False) + b * SEQ
                        for b in range(BATCH)]).astype(np.int64)
        return {"src_ids": ids, "mask_pos": pos,
                "lm_label": ids.reshape(-1)[pos]}
    labels = np.where(rng.rand(BATCH, SEQ) < 0.3, ids, 0).astype(np.int64)
    return {"src_ids": ids, "lm_label": labels}


def _ref_init(startup, seed=7):
    ref_scope = RefScope()
    RefExecutor().run(startup, scope=ref_scope, seed=seed)
    return ref_scope, {v.name: np.asarray(ref_scope.find_var(v.name))
                       for v in startup.global_block().vars.values()}


def _assert_state_close(names, ref_scope, port_scope, d_model,
                        param_tol=PARAM_TOL):
    for n in names:
        r = np.asarray(ref_scope.find_var(n))
        g = port_scope.find_var(n).numpy()
        if n.endswith(".k.b"):
            # a separate key projection's bias (NMT's cross-attention): its
            # exact gradient is zero, as the key third of qkv.b's
            np.testing.assert_allclose(g, r, rtol=0, atol=STEPS * LR,
                                       err_msg=n)
            continue
        if n.endswith("qkv.b"):
            # the key third has a zero gradient: Adam steps on noise
            d = d_model
            np.testing.assert_allclose(g[d:2 * d], r[d:2 * d], rtol=0,
                                       atol=STEPS * LR, err_msg=n)
            g, r = np.concatenate([g[:d], g[2 * d:]]), \
                np.concatenate([r[:d], r[2 * d:]])
        tol = param_tol if "_moment" not in n else ACC_TOL
        np.testing.assert_allclose(g, r, err_msg=n, **tol)


@pytest.mark.parametrize("model,use_amp", [
    ("bert", False), ("bert_fused_head", True), ("masked", False),
    ("nmt", False)],
    ids=["bert_float32", "bert_amp", "bert_masked_gather", "nmt"])
def test_three_adam_steps_match_reference(model, use_amp, same_bits):
    ref_main, ref_startup, ref_loss = _build("ref", model, use_amp=use_amp)
    main, _, loss = _build("port", model, use_amp=use_amp)
    types = [op.type for op in main.global_block().ops]
    assert types.count("dropout") == types.count("dropout_grad") > 0
    ref_scope, init = _ref_init(ref_startup)
    port_scope = ptt.io.params_from_numpy(scope.Scope(), init)
    same_bits()
    exe, ref_exe = ptt.Executor(ptt.CPUPlace()), RefExecutor()
    losses = []
    for step in range(STEPS):
        feed = _feed(model, seed=step)
        with jax.disable_jit(use_amp):
            want, = ref_exe.run(ref_main, feed=feed, fetch_list=[ref_loss],
                                scope=ref_scope, seed=100 + step)
        got, = exe.run(main, feed=feed, fetch_list=[loss], scope=port_scope,
                       seed=100 + step)
        if use_amp:
            np.testing.assert_allclose(float(got), float(np.asarray(want)),
                                       rtol=AMP_LOSS_RTOL)
        else:
            np.testing.assert_allclose(float(got), float(np.asarray(want)),
                                       **LOSS_TOL)
        losses.append(float(got))
    assert np.isfinite(losses).all()
    if not use_amp:
        d = BERT["d_model"] if model != "nmt" else NMT["d_model"]
        _assert_state_close(init, ref_scope, port_scope, d,
                            MASKED_PARAM_TOL if model == "masked"
                            else PARAM_TOL)
    else:
        assert all(port_scope.find_var(p.name).dtype == torch.float32
                   for p in main.all_parameters())


@pytest.mark.parametrize("model", ["bert", "nmt"])
def test_fused_and_unfused_programs_give_the_same_losses(model):
    """The port's own Philox bits: the fusion pass folds each FFN's tagged
    dropout into ``fused_dense_act``, which regenerates the unfused op's
    mask, forward and backward."""
    main, startup, loss = _build("port", model)
    init_scope = scope.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=init_scope, seed=3)
    runs = {}
    for fused in (True, False):
        flags.set_flags({"FLAGS_graph_fusion": fused})
        sc = scope.Scope()
        for n, v in init_scope.items():
            sc.set_var(n, v.clone())
        exe = ptt.Executor(ptt.CPUPlace())
        runs[fused] = [float(exe.run(main, feed=_feed(model, step),
                                     fetch_list=[loss], scope=sc,
                                     seed=40 + step)[0])
                       for step in range(STEPS)]
        plan = next(p for p in exe._plans.values()
                    if any(op.type == "adam" for op, _ in p.ops))
        types = [op.type for op, _ in plan.ops]
        n_fused = types.count("fused_dense_act")
        n_layers = BERT["n_layer"] if model == "bert" else 2 * NMT["n_layer"]
        assert n_fused == (n_layers if fused else 0)
        if fused:
            # every fused FFN carries its dropout tail
            assert all(op.attrs["seed"] for op, _ in plan.ops
                       if op.type == "fused_dense_act")
    assert runs[True] == runs[False]


# -- the new ops -------------------------------------------------------------

def _lower_both(op_type, ins_np, attrs, grad=False):
    port_ins = {k: [torch.from_numpy(a) for a in v]
                for k, v in ins_np.items()}
    ref_ins = {k: [jnp.asarray(a) for a in v] for k, v in ins_np.items()}
    got = registry.get_op_info(op_type).lower(
        LowerCtx(torch.device("cpu"), 1), port_ins, attrs)
    with jax.disable_jit():
        want = ref_registry.get_op_info(op_type).lower(RefCtx(1), ref_ins,
                                                       attrs)
    return got, want


@pytest.mark.parametrize("case", ["rows", "index_n1", "axis1", "negative"])
def test_gather_matches_reference(case):
    rng = np.random.RandomState(0)
    x = rng.randn(6, 5, 3).astype(np.float32)
    idx = {"rows": np.array([4, 0, 4, 2]), "index_n1": np.array([[1], [5]]),
           "axis1": np.array([3, 1]), "negative": np.array([-1, -6, 2])}[case]
    attrs = {"axis": 1} if case == "axis1" else {}
    got, want = _lower_both("gather", {"X": [x], "Index": [idx]}, attrs)
    np.testing.assert_array_equal(got["Out"][0].numpy(),
                                  np.asarray(want["Out"][0]))
    # the generic autograd gradient: a scatter-add of the output gradient
    xt = torch.from_numpy(x).requires_grad_()
    with torch.enable_grad():
        out = registry.get_op_info("gather").lower(
            LowerCtx(torch.device("cpu"), 1),
            {"X": [xt], "Index": [torch.from_numpy(idx)]}, attrs)["Out"][0]
        g, = torch.autograd.grad(out.sum(), xt)
    _, vjp = jax.vjp(lambda a: ref_registry.get_op_info("gather").lower(
        RefCtx(1), {"X": [a], "Index": [jnp.asarray(idx)]}, attrs)["Out"][0],
        jnp.asarray(x))
    rg, = vjp(jnp.ones(out.shape, jnp.float32))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int32", "int64"])
def test_assign_value_matches_reference(dtype):
    vals = np.arange(12).reshape(3, 4).astype(dtype) - 5
    attrs = {"shape": [3, 4], "dtype": dtype,
             "values": vals.reshape(-1).tolist()}
    got, want = _lower_both("assign_value", {}, attrs)
    np.testing.assert_array_equal(got["Out"][0].numpy(),
                                  np.asarray(want["Out"][0]))
    assert registry.get_op_info("assign_value").no_grad


def test_layers_assign_of_an_array_is_assign_value():
    from paddle_tpu_torch import layers
    a = np.triu(np.full((3, 3), -1e9, np.float32), k=1)
    v = layers.assign(a)
    op = core.default_main_program().global_block().ops[-1]
    assert op.type == "assign_value" and v.dtype == "float32"
    out, = ptt.Executor(ptt.CPUPlace()).run(fetch_list=[v])
    np.testing.assert_array_equal(out, a)


def test_sigmoid_matches_reference():
    x = np.random.RandomState(1).randn(4, 7).astype(np.float32) * 4
    got, want = _lower_both("sigmoid", {"X": [x]}, {})
    np.testing.assert_allclose(got["Out"][0].numpy(),
                               np.asarray(want["Out"][0]), rtol=1e-6,
                               atol=1e-7)
