"""Dropout on a Philox stream: the port against the JAX package, on the CPU.

- the plain Philox4x32-10 gives Random123's known answers; its bytes are
  deterministic for (seed, tag), and streams of other tags, seeds and the
  run's counter share no more bytes than chance; the keep rate is within
  5 sigma of the binomial 1 - threshold / 256 at p 0.1, 0.5 and 0.001 (the
  floor of 1), exact at p 0 and 1; the threshold equals the reference's on
  every byte value;
- the ``dropout`` op against the reference's lowering: ``is_test`` in
  both implementations exactly; training, given the same bits (the
  reference's ``jax.random.bits`` and the port's ``philox_bytes`` fed one
  numpy draw), exactly in float32 and bf16, where the scale is rounded to
  bf16 before the product; an untagged op's ``Mask`` fed to the
  reference's ``dropout_grad`` gives the port's ``XGrad``; the tagged
  ``dropout_grad`` regenerates the forward's mask;
- ``fused_dense_act``'s dropout tail against the reference's, forward and
  gradient, float32 and AMP;
- a generic grad op that recomputes a counter-stream forward draws the
  forward's bits (the executor's ``rng_marks``);
- ``stateful_rng`` equals the reference's for every op type both register;
- ``layers.dropout`` tags its op with the reference's crc32 of the output
  name, or the explicit seed.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the reference lowerings)
import paddle_tpu_torch as ptt
from paddle_tpu.framework import registry as ref_registry
from paddle_tpu.framework.executor import LowerCtx as RefCtx
from paddle_tpu.ops import nn_ops as ref_nn_ops
from paddle_tpu_torch import layers
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.framework.executor import LowerCtx
from paddle_tpu_torch.kernels import dropout as dk
from _port_fixtures import collect_garbage_after_module  # noqa: F401
from _port_fixtures import patch_same_bits

#: Random123's known answers for Philox4x32-10 (kat_vectors):
#: (counter, key) -> output words
KAT = [((0, 0, 0, 0), (0, 0),
        (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
       ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
        (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
       ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
        (0xa4093822, 0x299f31d0),
        (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]


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


@pytest.fixture
def same_bits(monkeypatch):
    patch_same_bits(monkeypatch)


# -- the plain Philox --------------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_gives_the_known_answers(ctr, key, want):
    words = dk.philox4x32_10(*(torch.tensor([c], dtype=torch.int64)
                               for c in ctr), *key)
    assert [int(w) for w in words] == list(want)


def test_bytes_are_deterministic_and_little_endian():
    s = dk.tagged_stream(1234567890123, 42)
    a = dk.philox_bytes(s, (3, 37), "cpu")
    assert a.dtype == torch.uint8 and a.shape == (3, 37)
    assert torch.equal(a, dk.philox_bytes(s, (3, 37), "cpu"))
    # a shorter draw is a prefix of a longer one: byte i is at counter i/16
    assert torch.equal(dk.philox_bytes(s, (50,), "cpu"),
                       a.reshape(-1)[:50])
    g = torch.tensor([1], dtype=torch.int64)
    words = dk.philox4x32_10(g, g * 0, g * 0 + 42, g * 0 + dk.TAGGED,
                             1234567890123 & 0xFFFFFFFF,
                             1234567890123 >> 32)
    want = [(int(w) >> (8 * b)) & 0xFF for w in words for b in range(4)]
    assert a.reshape(-1)[16:32].tolist() == want


@pytest.mark.parametrize("other", [
    dk.tagged_stream(7, 43), dk.tagged_stream(8, 42),
    dk.counter_stream(7, 42), dk.counter_stream(7, 1)],
    ids=["tag", "seed", "counter_same_number", "counter"])
def test_streams_are_independent(other):
    n = 1 << 16
    a = dk.philox_bytes(dk.tagged_stream(7, 42), (n,), "cpu")
    b = dk.philox_bytes(other, (n,), "cpu")
    same = float((a == b).double().mean())
    # chance is 1/256 = 0.0039; 5 sigma of n Bernoulli draws
    sigma = (1 / 256 * (1 - 1 / 256) / n) ** 0.5
    assert abs(same - 1 / 256) < 5 * sigma
    corr = np.corrcoef(a.double().numpy(), b.double().numpy())[0, 1]
    assert abs(corr) < 5 / n ** 0.5


@pytest.mark.parametrize("p", [0.1, 0.5, 0.001, 0.0, 1.0])
def test_keep_rate_is_binomial(p):
    n = 1 << 18
    x = torch.ones(n)
    out, mask = dk.dropout_fwd(x, dk.tagged_stream(3, 9), dk.threshold(p),
                               1.0, want_mask=True)
    kept = int(mask.sum())
    assert torch.equal(out, mask.float())
    q = 1 - dk.threshold(p) / 256
    if q in (0.0, 1.0):
        assert kept == q * n
    else:
        assert abs(kept - q * n) < 5 * (n * q * (1 - q)) ** 0.5
    if p == 0.001:
        assert dk.threshold(p) == 1         # the floor: 1/256 dropped


class _BitsCtx:
    """A reference lowering context whose streams are placeholders (the
    test patches ``jax.random.bits``)."""

    def rng(self):
        return "ctr"

    def rng_tagged(self, tag):
        return "tag"


@pytest.mark.parametrize("p", [0.0, 0.001, 0.002, 0.1, 0.25, 0.5, 0.9,
                               0.998, 0.999, 1.0])
def test_threshold_equals_the_reference(p, monkeypatch):
    """On each of the 256 byte values, the port's keep equals the
    reference's ``_dropout_keep``."""
    every = np.arange(256, dtype=np.uint8)
    monkeypatch.setattr(jax.random, "bits",
                        lambda key, shape, dtype: jnp.asarray(every))
    want = np.asarray(ref_nn_ops._dropout_keep(
        _BitsCtx(), {"dropout_prob": p, "seed": 5}, (256,)))
    got = torch.from_numpy(every).to(torch.int32) >= dk.threshold(p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scale_rounds_to_the_dtype_first():
    assert dk.rounded_scale(1 / 0.9, torch.bfloat16) == 1.109375
    assert dk.rounded_scale(1 / 0.9, torch.float32) == \
        float(np.float32(1 / 0.9))
    x = torch.tensor([7.0], dtype=torch.bfloat16)
    out, _ = dk.dropout_fwd(x, dk.tagged_stream(0, 1), 0, 1 / 0.9)
    assert float(out) == 7.75


# -- the ops against the reference -----------------------------------------

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _x(dtype, shape=(4, 8, 33), seed=0):
    tt, jt = DTYPES[dtype]
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(a).to(tt), jnp.asarray(a).astype(jt)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


def _bf16_ulp(a) -> float:
    top = float(np.abs(a).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def _run_port(op_type, ins, attrs, ctx=None):
    ctx = ctx or LowerCtx(torch.device("cpu"), 11)
    return registry.get_op_info(op_type).lower(ctx, ins, attrs)


def _run_ref(op_type, ins, attrs, ctx=None):
    ctx = ctx or RefCtx(11)
    with jax.disable_jit():
        return ref_registry.get_op_info(op_type).lower(ctx, ins, attrs)


IMPLS = ["downgrade_in_infer", "upscale_in_train"]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
def test_is_test_equals_the_reference(impl, dtype):
    xt, xj = _x(dtype)
    attrs = {"dropout_prob": 0.3, "is_test": True, "seed": 5,
             "dropout_implementation": impl}
    got = _run_port("dropout", {"X": [xt]}, attrs)
    want = _run_ref("dropout", {"X": [xj]}, attrs)
    np.testing.assert_array_equal(_np(got["Out"][0]), _np(want["Out"][0]))
    np.testing.assert_array_equal(got["Mask"][0].numpy(),
                                  np.asarray(want["Mask"][0]))


@pytest.mark.parametrize("seed", [5, 0], ids=["tagged", "untagged"])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
def test_training_equals_the_reference_given_the_same_bits(
        impl, dtype, p, seed, same_bits):
    xt, xj = _x(dtype)
    attrs = {"dropout_prob": p, "is_test": False, "seed": seed,
             "dropout_implementation": impl}
    got = _run_port("dropout", {"X": [xt]}, attrs)
    want = _run_ref("dropout", {"X": [xj]}, attrs)
    assert got["Out"][0].dtype == xt.dtype
    np.testing.assert_array_equal(_np(got["Out"][0]), _np(want["Out"][0]))
    if not seed:
        np.testing.assert_array_equal(got["Mask"][0].numpy(),
                                      np.asarray(want["Mask"][0]))
    # the gradient: the tagged op regenerates its mask; the untagged one
    # reads Mask, here the port's fed to the reference's dropout_grad
    gt, gj = _x(dtype, seed=1)
    g_ins = {"OutGrad": [gt]}
    r_ins = {"OutGrad": [gj]}
    if not seed:
        g_ins["Mask"] = got["Mask"]
        r_ins["Mask"] = [jnp.asarray(got["Mask"][0].numpy())]
    gx = _run_port("dropout_grad", g_ins, attrs)["XGrad"][0]
    rx = _run_ref("dropout_grad", r_ins, attrs)["XGrad"][0]
    assert gx.dtype == gt.dtype
    np.testing.assert_array_equal(_np(gx), _np(rx))
    keep = _np(got["Out"][0]) != 0
    assert ((_np(gx) != 0) == (keep & (_np(gt) != 0))).all()


def test_tagged_grad_regenerates_the_forward_mask():
    """With the real Philox: the grad of a tagged op, run from its own
    context, keeps exactly the elements the forward kept."""
    x = torch.rand(64, 130) + 0.5
    attrs = {"dropout_prob": 0.25, "seed": 77,
             "dropout_implementation": "upscale_in_train"}
    out = _run_port("dropout", {"X": [x]}, attrs,
                    LowerCtx(torch.device("cpu"), 5))["Out"][0]
    assert "Mask" not in _run_port("dropout", {"X": [x]}, attrs)
    g = _run_port("dropout_grad", {"OutGrad": [torch.ones_like(x)]}, attrs,
                  LowerCtx(torch.device("cpu"), 5))["XGrad"][0]
    torch.testing.assert_close(g * x, out, rtol=0, atol=0)
    other = _run_port("dropout_grad", {"OutGrad": [torch.ones_like(x)]},
                      attrs, LowerCtx(torch.device("cpu"), 6))["XGrad"][0]
    assert not torch.equal(other, g)        # the next step draws anew


def test_untagged_draws_advance_the_counter():
    ctx = LowerCtx(torch.device("cpu"), 5)
    x = torch.ones(4096)
    attrs = {"dropout_prob": 0.5, "seed": 0}
    a = _run_port("dropout", {"X": [x]}, attrs, ctx)["Mask"][0]
    b = _run_port("dropout", {"X": [x]}, attrs, ctx)["Mask"][0]
    assert ctx._counter == 2 and not torch.equal(a, b)


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "amp"])
@pytest.mark.parametrize("impl", IMPLS)
def test_fused_dense_act_dropout_tail_equals_the_reference(impl, amp,
                                                           same_bits):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 16).astype(np.float32)
    w = rng.randn(16, 24).astype(np.float32) * 0.2
    b = rng.randn(24).astype(np.float32)
    attrs = {"x_num_col_dims": 2, "bias_axis": -1, "act": "gelu",
             "approximate": False, "dropout_prob": 0.3, "seed": 1234,
             "is_test": False, "dropout_implementation": impl,
             "use_pallas": False}
    ctx = LowerCtx(torch.device("cpu"), 11, amp=amp)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    with torch.enable_grad():
        out = registry.get_op_info("fused_dense_act").lower(
            ctx, {"X": [leaves[0]], "W": [leaves[1]], "Bias": [leaves[2]]},
            attrs)["Out"][0]
        dy = torch.from_numpy(rng.randn(2, 6, 24).astype(np.float32))
        grads = torch.autograd.grad(out, leaves, dy.to(out.dtype))
    rctx = RefCtx(11, amp=amp)
    lower = ref_registry.get_op_info("fused_dense_act").lower

    def f(xj, wj, bj):
        return lower(rctx, {"X": [xj], "W": [wj], "Bias": [bj]},
                     attrs)["Out"][0]

    with jax.disable_jit():
        want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, w, b)))
        rgrads = vjp(jnp.asarray(dy).astype(want.dtype))
    assert str(out.dtype).endswith(str(want.dtype))
    got, want = _np(out.detach()), _np(want)
    np.testing.assert_array_equal(got == 0, want == 0)      # the mask
    # under AMP a bf16 sum taken in another order may round to the
    # neighbouring value: one bf16 ulp of the largest output, two of each
    # gradient's (as the AMP parity tests hold the fused ops)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_bf16_ulp(want) if amp else 1e-6)
    for g, r in zip(grads, rgrads):
        r = _np(r)
        np.testing.assert_allclose(g.float().numpy(), r, rtol=1e-5,
                                   atol=2 * _bf16_ulp(r) if amp else 1e-6)


# -- the executor's streams --------------------------------------------------

@pytest.fixture
def counter_op():
    """A test op that drops x on the run's counter stream and takes the
    generic autograd gradient: its grad op recomputes the forward."""
    def lower(ctx, ins, attrs):
        return {"Out": [dk.dropout(ins["X"][0], ctx.rng(), 128, 2.0)]}
    registry.register_op("test_counter_dropout", lower, stateful_rng=True)
    yield "test_counter_dropout"
    del registry._REGISTRY["test_counter_dropout"]


def test_grad_op_without_its_forward_replays_the_counter(counter_op,
                                                        monkeypatch):
    """The grad op is kept from pairing with its forward, so it recomputes
    the forward after a later op advanced the counter: the rewind makes it
    draw the forward's bits (``rng_marks``), so x's gradient is 2 exactly
    where the forward kept x."""
    from paddle_tpu_torch.framework import executor as executor_mod
    from paddle_tpu_torch.layer_helper import LayerHelper
    x = layers.data("x", shape=[256], dtype="float32")
    x.stop_gradient = False
    helper = LayerHelper(counter_op)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(counter_op, inputs={"X": [x]}, outputs={"Out": [out]})
    later = layers.dropout(out, 0.5, seed=0)     # draws the next counter
    loss = layers.reduce_sum(later)
    from paddle_tpu_torch.framework.backward import append_backward
    append_backward(loss)
    main = core.default_main_program()
    key = executor_mod._fwd_key
    monkeypatch.setattr(executor_mod, "_fwd_key", lambda op: (
        ("hidden", id(op)) if op.type == counter_op else key(op)))
    feed = {"x": np.ones((2, 256), np.float32)}
    exe = ptt.Executor(ptt.CPUPlace())
    o, m, g = exe.run(main, feed=feed, seed=3,
                      fetch_list=[out, later, x.name + "@GRAD"])
    plan, = exe._plans.values()
    assert None in plan.fwd_of.values()
    kept = o != 0
    assert 0.4 < kept.mean() < 0.6 and 0.15 < (m != 0).mean() < 0.35
    np.testing.assert_array_equal(g, np.where(m != 0, 2.0, 0.0))


def test_stateful_rng_equals_the_reference():
    both = set(registry.registered_ops()) & set(
        ref_registry.registered_ops())
    got = {t for t in both if registry.get_op_info(t).stateful_rng}
    want = {t for t in both if ref_registry.get_op_info(t).stateful_rng}
    assert got == want
    assert {"dropout", "dropout_grad", "fused_dense_act", "uniform_random",
            "gaussian_random"} <= got


@pytest.mark.parametrize("seed", [None, 17, 0])
def test_layer_tags_its_op_as_the_reference(seed):
    x = layers.data("x", shape=[8], dtype="float32")
    out = layers.dropout(x, 0.2, seed=seed)
    op = core.default_main_program().global_block().ops[-1]
    want = seed if seed is not None else \
        (zlib.crc32(out.name.encode()) & 0x7FFFFFFF) or 1
    assert op.type == "dropout" and op.attrs["seed"] == want
    assert op.output("Mask") and \
        core.default_main_program().global_block().var(
            op.output("Mask")[0]).dtype == "uint8"
