"""The port's flash-attention backward (K2) against the JAX package.

The same numpy ``q, k, v, o, lse, do`` go through three routes and must
give the same ``(dq, dk, dv)``:

- the port's ``flash_attention_bwd`` on CPU tensors, which is the plain
  version of the CUDA kernel (``flash_attention_bwd_reference``);
- the reference's ``_flash_bwd_jax`` (the blockwise scan the JAX package
  runs off the TPU, and for any biased backward);
- the reference's ``_flash_bwd_pallas`` in interpret mode at 8-row blocks,
  both its combined and its split kernels, as ``tests/test_attention.py``
  runs them.

Tolerance: 1e-5 absolute and relative, float32 — the routes differ only in
summation order.  The ``torch.autograd.Function`` the ``flash_attention``
op differentiates through is checked against autograd through
``mha_reference`` (2e-5: the dense softmax's own rounding), except on rows
with no live key, where the flash backward gives zero by design (the
reference's ``p = 0`` where ``s <= NEG_INF / 2``) while the dense softmax
averages over the masked keys.  The CUDA kernel itself is held against the
plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa
from _port_fixtures import collect_garbage_after_module  # noqa: F401

# the module, not the function paddle_tpu.pallas re-exports under its name
ref_fa = importlib.import_module("paddle_tpu.pallas.flash_attention")

TOL = dict(rtol=1e-5, atol=1e-5)
AUTOGRAD_TOL = dict(rtol=2e-5, atol=2e-5)

# (bh, Tq, Tk, d, causal)
CASES = {
    "causal": (3, 16, 16, 8, True),
    "noncausal": (3, 16, 16, 8, False),
    "ragged_13_causal": (2, 13, 13, 8, True),
    "ragged_13_noncausal": (2, 13, 13, 32, False),
    "causal_tq_lt_tk": (2, 8, 24, 8, True),
    "masked_rows_causal_tq_gt_tk": (2, 24, 8, 8, True),
    "d32_causal": (2, 16, 16, 32, True),
}


def _inputs(bh, tq, tk, d, causal, seed=0):
    """q, k, v, do and the forward's o, lse (from the reference)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, tq, d).astype(np.float32)
    k = rng.randn(bh, tk, d).astype(np.float32)
    v = rng.randn(bh, tk, d).astype(np.float32)
    do = rng.randn(bh, tq, d).astype(np.float32)
    o, lse = ref_fa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), None, causal,
                               1.0 / math.sqrt(d), 8, 8, False)
    return q, k, v, np.asarray(o), np.asarray(lse), do


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(q, k, v, o, lse, do, causal):
    return [g.numpy() for g in fa.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(o), _t(lse), _t(do), causal)]


def _close(got, want, tol=TOL):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_reference_scan(case):
    bh, tq, tk, d, causal = CASES[case]
    q, k, v, o, lse, do = _inputs(bh, tq, tk, d, causal)
    want = ref_fa._flash_bwd_jax(*(jnp.asarray(a) for a in (q, k, v)), None,
                                 jnp.asarray(o), jnp.asarray(lse),
                                 jnp.asarray(do), causal, 1.0 / math.sqrt(d),
                                 8, tk - tq)
    _close(_port(q, k, v, o, lse, do, causal), want[:3])


@pytest.mark.parametrize("impl", ["combined", "split"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_pallas_interpret(case, impl):
    bh, tq, tk, d, causal = CASES[case]
    q, k, v, o, lse, do = _inputs(bh, tq, tk, d, causal, seed=1)
    want = ref_fa._flash_bwd_pallas(*(jnp.asarray(a) for a in
                                      (q, k, v, o, lse, do)),
                                    causal, 1.0 / math.sqrt(d), 8, 8,
                                    tk - tq, True, impl=impl)
    _close(_port(q, k, v, o, lse, do, causal), want)


def test_rows_without_a_live_key_get_zero_gradients():
    bh, tq, tk, d, causal = CASES["masked_rows_causal_tq_gt_tk"]
    q, k, v, o, lse, do = _inputs(bh, tq, tk, d, causal, seed=2)
    dq, dk, dv = _port(q, k, v, o, lse, do, causal)
    dead = tq - tk                     # rows q + Tk - Tq < 0 see no key
    assert (dq[:, :dead] == 0).all() and np.abs(dq[:, dead:]).max() > 0
    # the dead rows add nothing to dk/dv either: drop them and compare
    live = _port(q[:, dead:], k, v, o[:, dead:], lse[:, dead:],
                 do[:, dead:], causal)
    np.testing.assert_allclose(dk, live[1], **TOL)
    np.testing.assert_allclose(dv, live[2], **TOL)


@pytest.mark.parametrize("kind", ["one", "bh"])
def test_bias_backward_matches_reference_with_dbias(kind):
    bh, tq, tk, d = 4, 12, 10, 8
    rng = np.random.RandomState(3)
    q, do = (rng.randn(bh, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(bh, tk, d).astype(np.float32) for _ in range(2))
    bias = rng.randn(1 if kind == "one" else bh, tq, tk).astype(np.float32)
    sm = 1.0 / math.sqrt(d)
    jq, jk, jv, jb = (jnp.asarray(a) for a in (q, k, v, bias))
    o, lse = ref_fa._flash_fwd(jq, jk, jv, jb, False, sm, 8, 8, False)
    want = ref_fa._flash_bwd_jax(jq, jk, jv, jb, o, lse, jnp.asarray(do),
                                 False, sm, 8, 0)
    got = fa.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(np.asarray(o)), _t(np.asarray(lse)), _t(do),
        _t(bias), False, sm)
    _close([g.numpy() for g in got[:3]], want[:3])
    assert got[3].shape == bias.shape
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **TOL)


# -- the autograd.Function the flash_attention op runs -----------------------

# (b, h, Tq, Tk, d, causal, bias kind)
AUTOGRAD_CASES = {
    "causal": (2, 2, 16, 16, 8, True, None),
    "noncausal_d32": (1, 2, 13, 13, 32, False, None),
    "causal_tq_lt_tk": (1, 2, 8, 24, 8, True, None),
    "bias_11": (2, 2, 12, 12, 8, True, "11"),
    "bias_b1": (2, 2, 12, 10, 8, False, "b1"),
}


@pytest.mark.parametrize("case", sorted(AUTOGRAD_CASES))
def test_function_grads_match_autograd_through_mha_reference(case):
    b, h, tq, tk, d, causal, bias_kind = AUTOGRAD_CASES[case]
    rng = np.random.RandomState(4)
    arrays = [rng.randn(b, h, t, d).astype(np.float32) for t in (tq, tk, tk)]
    w = _t(rng.randn(b, h, tq, d).astype(np.float32))
    if bias_kind == "11":
        arrays.append(rng.randn(1, 1, tq, tk).astype(np.float32))
    elif bias_kind == "b1":
        arrays.append(rng.randn(b, 1, tq, tk).astype(np.float32))

    def grads(fn):
        ts = [_t(a).requires_grad_() for a in arrays]
        bias = ts[3] if len(ts) > 3 else None
        out = fn(ts[0], ts[1], ts[2], bias=bias, causal=causal)
        return torch.autograd.grad((out * w).sum(), ts)

    fa.reset_launch_count()
    got = grads(fa.flash_attention)
    want = grads(fa.mha_reference)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **AUTOGRAD_TOL)
    assert fa.launch_count("flash_attn_bwd") == 0     # CPU: plain version


@pytest.mark.parametrize("bad", ["dtype", "layout", "lse_shape", "device"])
def test_backward_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q = torch.randn(2, 16, 64)
    k, v, o, do = (q.clone() for _ in range(4))
    lse = torch.zeros(2, 16)
    if bad == "dtype":
        do = do.double()
    elif bad == "layout":
        o = torch.randn(2, 64, 16).transpose(1, 2)
    elif bad == "lse_shape":
        lse = torch.zeros(2, 15)
    elif bad == "device":
        q, k, v, o, do, lse = (x.to("meta") for x in (q, k, v, o, do, lse))
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention_bwd(q, k, v, o, lse, do, True)


# -- bf16 operands (AMP) ---------------------------------------------------------
#
# q, k, v, o and do rounded to bf16 in both packages (the same bits), lse in
# float32.  The reference is ``_flash_bwd_pallas`` in interpret mode, both
# kernels: float32 arithmetic, each gradient rounded once to bf16 (the
# combined kernel's dk/dv partials are float32 and rounded once after their
# sum).  The port's plain version computes in float32 and rounds once too:
# each gradient within one bf16 ulp of its largest magnitude.

def _bf16_ulp(a):
    top = float(np.abs(np.asarray(a, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("impl", ["combined", "split"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_backward_matches_pallas_interpret(case, impl):
    bh, tq, tk, d, causal = CASES[case]
    q, k, v, o, lse, do = _inputs(bh, tq, tk, d, causal, seed=5)
    sm = 1.0 / math.sqrt(d)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, o, do)]
    want = ref_fa._flash_bwd_pallas(jb[0], jb[1], jb[2], jb[3],
                                    jnp.asarray(lse), jb[4], causal, sm, 8,
                                    8, tk - tq, True, impl=impl)
    tb = [torch.from_numpy(np.array(a)).to(torch.bfloat16)
          for a in (q, k, v, o, do)]
    got = fa.flash_attention_bwd(tb[0], tb[1], tb[2], tb[3], _t(lse), tb[4],
                                 causal, sm)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and str(w.dtype) == "bfloat16"
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=_bf16_ulp(w), err_msg=name)
