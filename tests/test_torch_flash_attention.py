"""The port's flash-attention forward against the JAX package.

The same numpy inputs go through ``paddle_tpu.pallas.flash_attention``
(which runs its blockwise ``_flash_fwd_jax`` on the CPU) and through the
port's ``flash_attention``/``flash_attention_fwd`` (whose CPU path is the
plain version of the CUDA kernel).  Tolerance: 1e-5 absolute and relative,
float32.  The CUDA kernel itself is held against the plain version on the
card by ``tests/test_torch_cuda.py`` (and by ``chip_smoke.py``).  The
arithmetic of the Hopper kernels is emulated here and held to the bounds
the card checks use: bf16 (bf16 products summed in float32, P and dS as
three bf16 terms) and float32 (every operand as three bf16 terms, every
product as six term products).
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

# (b, h, Tq, Tk, d, causal, bias kind, block_k of the JAX reference)
CASES = {
    "causal": (2, 2, 64, 64, 64, True, None, None),
    "noncausal": (2, 2, 64, 64, 64, False, None, None),
    "causal_tq_lt_tk": (1, 2, 32, 96, 64, True, None, None),
    "ragged_t_d8": (1, 2, 77, 77, 8, True, None, 32),
    "bias_2d": (2, 2, 40, 40, 64, False, "2d", None),
    "bias_11": (2, 2, 40, 40, 64, True, "11", None),
    "bias_bh": (2, 2, 40, 56, 8, False, "bh", None),
    "masked_row_inf_bias": (1, 2, 48, 48, 64, False, "inf_row", None),
    "masked_rows_causal_tq_gt_tk": (1, 2, 40, 24, 8, True, None, None),
}


def _inputs(b, h, tq, tk, d, bias_kind, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, h, tk, d).astype(np.float32)
    v = rng.randn(b, h, tk, d).astype(np.float32)
    bias = None
    if bias_kind == "2d":
        bias = rng.randn(tq, tk).astype(np.float32)
    elif bias_kind == "11":
        bias = rng.randn(1, 1, tq, tk).astype(np.float32)
    elif bias_kind == "bh":
        bias = rng.randn(b, h, tq, tk).astype(np.float32)
    elif bias_kind == "inf_row":
        bias = np.zeros((1, 1, tq, tk), np.float32)
        bias[..., 7, :] = -np.inf
    return q, k, v, bias


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_output_matches_reference(case):
    b, h, tq, tk, d, causal, bias_kind, block_k = CASES[case]
    q, k, v, bias = _inputs(b, h, tq, tk, d, bias_kind)
    ref = np.asarray(ref_fa.flash_attention(
        _j(q), _j(k), _j(v), bias=_j(bias), causal=causal, block_k=block_k))
    got = fa.flash_attention(_t(q), _t(k), _t(v), bias=_t(bias),
                             causal=causal).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    if bias_kind == "inf_row":
        assert (got[..., 7, :] == 0).all()      # l == 0 is read as 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_lse_matches_reference(case):
    b, h, tq, tk, d, causal, bias_kind, block_k = CASES[case]
    q, k, v, bias = _inputs(b, h, tq, tk, d, bias_kind, seed=1)
    sm = 1.0 / math.sqrt(d)
    bc = None
    if bias is not None:
        b4 = bias[None, None] if bias.ndim == 2 else bias
        bc = (b4.reshape(1, tq, tk) if b4.shape[:2] == (1, 1) else
              np.broadcast_to(b4, (b, h, tq, tk)).reshape(b * h, tq, tk))
        bc = np.ascontiguousarray(bc)
    qc, kc, vc = (x.reshape(b * h, -1, d) for x in (q, k, v))
    _, ref_lse = ref_fa._flash_fwd(_j(qc), _j(kc), _j(vc), _j(bc), causal,
                                   sm, 512, block_k or tk, False)
    o, lse = fa.flash_attention_fwd(_t(qc), _t(kc), _t(vc), _t(bc), causal,
                                    sm)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)
    assert o.shape == (b * h, tq, d) and lse.dtype == torch.float32


@pytest.mark.parametrize("case", ["causal", "causal_tq_lt_tk", "bias_bh",
                                  "ragged_t_d8"])
def test_mha_reference_matches_reference(case):
    b, h, tq, tk, d, causal, bias_kind, _ = CASES[case]
    q, k, v, bias = _inputs(b, h, tq, tk, d, bias_kind, seed=2)
    ref = np.asarray(ref_fa.mha_reference(_j(q), _j(k), _j(v), _j(bias),
                                          causal=causal))
    got = fa.mha_reference(_t(q), _t(k), _t(v), _t(bias), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    flash = fa.flash_attention(_t(q), _t(k), _t(v), bias=_t(bias),
                               causal=causal)
    np.testing.assert_allclose(flash.numpy(), ref, **TOL)


@pytest.mark.parametrize("bad", ["dtype", "layout", "head_dim", "bias",
                                 "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q = torch.randn(2, 16, 64)
    k, v, bias = q.clone(), q.clone(), None
    if bad == "dtype":
        q = q.double()
    elif bad == "layout":
        q = torch.randn(2, 64, 16).transpose(1, 2)
    elif bad == "head_dim":
        # any d > 0 runs on the CPU (tests/test_torch_head_dim.py); none
        # runs at d = 0
        q, k, v = (torch.randn(2, 16, 0) for _ in range(3))
    elif bad == "bias":
        bias = torch.zeros(3, 16, 16)
    elif bad == "device":
        q, k, v = (x.to("meta") for x in (q, k, v))
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention_fwd(q, k, v, bias, True)


def test_cpu_path_counts_no_launches():
    fa.reset_launch_count()
    q = torch.randn(2, 16, 64)
    fa.flash_attention_fwd(q, q, q, None, True)
    assert fa.launch_count() == 0


# -- bf16 operands (AMP) ---------------------------------------------------------
#
# The same seeded numpy inputs rounded to bf16 in both packages (both round
# to nearest even, so the bits agree).  The reference is the Pallas kernel
# itself, ``_flash_fwd_pallas`` in interpret mode at 8-row blocks, as
# ``tests/test_attention.py`` runs it; it computes in float32 and rounds o
# once to bf16, as the port's plain version does.  o within one bf16 ulp of
# its largest magnitude (the sums in another order can round to the
# neighbouring value), lse (float32) within 1e-5.  (For rows that see no
# key, the reference's XLA path; see below.)

def _bf16_ulp(a):
    top = float(np.abs(np.asarray(a, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_forward_matches_pallas_interpret(case):
    b, h, tq, tk, d, causal, bias_kind, _ = CASES[case]
    q, k, v, bias = _inputs(b, h, tq, tk, d, bias_kind, seed=5)
    sm = 1.0 / math.sqrt(d)
    bc = None
    if bias is not None:
        b4 = bias[None, None] if bias.ndim == 2 else bias
        bc = np.ascontiguousarray(
            b4.reshape(1, tq, tk) if b4.shape[:2] == (1, 1) else
            np.broadcast_to(b4, (b, h, tq, tk)).reshape(b * h, tq, tk))
    qc, kc, vc = (x.reshape(b * h, -1, d) for x in (q, k, v))
    # rows that see no key at all: the Pallas kernel skips their dead
    # blocks and writes 0, the reference's XLA path (and the port) average
    # v over the masked keys; the port follows the XLA path
    # (``test_flash_output_matches_reference``)
    interpret = case != "masked_rows_causal_tq_gt_tk"
    ro, rl = ref_fa._flash_fwd(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (qc, kc, vc)),
        _j(bc), causal, sm, 8, 8, interpret)
    o, lse = fa.flash_attention_fwd(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (qc, kc, vc)),
        _t(bc), causal, sm)
    assert o.dtype == torch.bfloat16 and str(ro.dtype) == "bfloat16"
    assert lse.dtype == torch.float32
    ro = np.asarray(ro, np.float32)
    np.testing.assert_allclose(o.float().numpy(), ro, rtol=0,
                               atol=_bf16_ulp(ro))
    np.testing.assert_allclose(lse.numpy(), np.asarray(rl), **TOL)


# -- the arithmetic of the Hopper bf16 kernels, emulated on the CPU -----------
#
# ``csrc/flash_attn_fwd_sm90.cu`` and ``csrc/flash_attn_bwd_sm90.cu`` compute
# S = q.k^T and dP = do.v^T as bf16 ``wgmma`` products with float32 sums (a
# product of two bf16 values is exact in float32, so a float32 matmul of the
# bf16 values is the same arithmetic up to the order of the sums), scale the
# float32 S, and give the float32 P and dS to the tensor cores as three bf16
# terms, hi = bf16(x), mid = bf16(x - hi) and lo = x - hi - mid, which hold x
# exactly, each product issued three times.  The emulation below does that in
# PyTorch, the forward tile by tile (128 keys, the online softmax with its
# rescaling), and holds it to the bounds the card checks use: o within one
# bf16 ulp of its largest magnitude of the Pallas kernel in interpret mode
# and lse within 1e-5, each gradient within one bf16 ulp of its largest
# magnitude of the port's plain backward.

# (bh, Tq, Tk, d, causal)
SM90_CASES = {
    "causal_t260": (2, 260, 260, 64, True),
    "ragged_d40_noncausal": (2, 77, 90, 40, False),
    "causal_tq_lt_tk": (2, 96, 260, 64, True),
    "d128_t130_causal": (2, 130, 130, 128, True),
}


def _split(x):
    """The three bf16 terms of float32 ``x``, widened back to float32."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    return hi, mid, (x - hi - mid).to(torch.bfloat16).float()


def _terms_dot(x, b):
    """x . b as the kernels issue it: one product per bf16 term of x."""
    return sum(torch.matmul(t, b) for t in _split(x))


def _causal_live(tq, tk):
    return (torch.arange(tq)[:, None] + (tk - tq)
            >= torch.arange(tk)[None, :])


def _emulate_sm90_fwd(q, k, v, causal, sm_scale, block=128):
    bh, tq, d = q.shape
    tk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    live = _causal_live(tq, tk)
    m = torch.full((bh, tq, 1), fa.NEG_INF)
    l = torch.zeros(bh, tq, 1)
    acc = torch.zeros(bh, tq, d)
    for k0 in range(0, tk, block):
        kb, vb = kf[:, k0:k0 + block], vf[:, k0:k0 + block]
        s = torch.matmul(qf, kb.transpose(1, 2)) * sm_scale
        if causal:
            s = s.masked_fill(~live[:, k0:k0 + block], fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + _terms_dot(p, vb)
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l).to(torch.bfloat16), (m + torch.log(l))[..., 0]


def _emulate_sm90_bwd(q, k, v, o, lse, do, causal, sm_scale):
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    tq, tk = q.shape[1], k.shape[1]
    delta = torch.sum(dof * o.float(), dim=-1, keepdim=True)
    s = torch.matmul(qf, kf.transpose(1, 2)) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_causal_live(tq, tk), p, torch.zeros_like(p))
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - delta)
    dv = _terms_dot(p.transpose(1, 2), dof)
    dk = _terms_dot(ds.transpose(1, 2), qf) * sm_scale
    dq = _terms_dot(ds, kf) * sm_scale
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _sm90_inputs(bh, tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(bh, t, d).astype(np.float32) for t in (tq, tk, tk, tq)]


@pytest.mark.parametrize("case", sorted(SM90_CASES))
def test_sm90_arithmetic_forward_matches_pallas_interpret(case):
    bh, tq, tk, d, causal = SM90_CASES[case]
    q, k, v, _ = _sm90_inputs(bh, tq, tk, d, seed=7)
    sm = 1.0 / math.sqrt(d)
    ro, rl = ref_fa._flash_fwd(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)), None,
        causal, sm, 128, 128, True)
    o, lse = _emulate_sm90_fwd(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal, sm)
    ro = np.asarray(ro, np.float32)
    np.testing.assert_allclose(o.float().numpy(), ro, rtol=0,
                               atol=_bf16_ulp(ro))
    np.testing.assert_allclose(lse.numpy(), np.asarray(rl), **TOL)


@pytest.mark.parametrize("case", sorted(SM90_CASES))
def test_sm90_arithmetic_backward_matches_plain_version(case):
    bh, tq, tk, d, causal = SM90_CASES[case]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _sm90_inputs(bh, tq, tk, d, seed=8))
    sm = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_reference(q, k, v, None, causal, sm)
    got = _emulate_sm90_bwd(q, k, v, o, lse, do, causal, sm)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                            causal, sm)[:3]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == torch.bfloat16
        w = w.float().numpy()
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=_bf16_ulp(w), err_msg=name)


def test_three_bf16_terms_hold_a_float32_exactly():
    """The kernels' split of P and dS: hi + mid + lo is the float32 value
    bit for bit (24 significant bits, 8 a bf16 term), over the range
    softmax weights and their gradients take; two terms leave ~2^-18."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy((rng.randn(1 << 16) * np.exp(rng.uniform(
        -60, 10, 1 << 16))).astype(np.float32))
    hi, mid, lo = _split(x)
    assert torch.equal(hi + mid + lo, x)
    two = (hi + (x - hi).to(torch.bfloat16).float() - x).abs() / x.abs()
    assert 2.0 ** -20 < float(two.max()) <= 2.0 ** -17


def test_bf16_goes_to_the_hopper_sources():
    """Both operand dtypes run the Hopper sources (float32 as term planes),
    and every source a dtype names is registered and present."""
    from paddle_tpu_torch.kernels import _build
    for dtype in (torch.bfloat16, torch.float32):
        assert fa.DTYPES[dtype] == ("flash_attn_fwd_sm90",
                                    "flash_attn_bwd_sm90"), dtype
    for lib in sum(fa.DTYPES.values(), ()):
        assert (_build.CSRC / _build.SOURCES[lib]).is_file(), lib


# -- the float32 form: every product as six bf16 term products ----------------
#
# For float32 q, k, v (and do) the Hopper kernels first write each operand
# as its three bf16 term planes and issue every product as the six term
# products of weight 2^-16 and above, in two chains from zero (hi . hi; the
# five lower ones) that join by a float32 add; P and dS are split in
# registers the same way.  The forward takes 64-key tiles.  The emulation
# below does that in PyTorch (a float32 matmul of bf16-valued terms is the
# same arithmetic up to the order of the sums) and holds it to the card
# checks' float32 bounds, 1e-5 + 1e-4 relative: the forward against the
# Pallas kernel in interpret mode, the backward against the plain version.

KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)     # chip_smoke.py's ATOL, RTOL
LOWER_TERMS = ((0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def _six(a, b):
    """a . b as the float32 form issues it: the product of the hi terms
    plus the five lower term products (the three of weight 2^-24 and below
    dropped)."""
    at, bt = _split(a), _split(b)
    return torch.matmul(at[0], bt[0]) + sum(
        torch.matmul(at[i], bt[j]) for i, j in LOWER_TERMS)


def _emulate_sm90_fwd_f32(q, k, v, causal, sm_scale, block=64):
    bh, tq, d = q.shape
    tk = k.shape[1]
    live = _causal_live(tq, tk)
    m = torch.full((bh, tq, 1), fa.NEG_INF)
    l = torch.zeros(bh, tq, 1)
    acc = torch.zeros(bh, tq, d)
    for k0 in range(0, tk, block):
        kb, vb = k[:, k0:k0 + block], v[:, k0:k0 + block]
        s = _six(q, kb.transpose(1, 2)) * sm_scale
        if causal:
            s = s.masked_fill(~live[:, k0:k0 + block], fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + _six(p, vb)
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    return acc / l, (m + torch.log(l))[..., 0]


def _emulate_sm90_bwd_f32(q, k, v, o, lse, do, causal, sm_scale):
    tq, tk = q.shape[1], k.shape[1]
    delta = torch.sum(do * o, dim=-1, keepdim=True)
    p = torch.exp(_six(q, k.transpose(1, 2)) * sm_scale - lse[..., None])
    if causal:
        p = torch.where(_causal_live(tq, tk), p, torch.zeros_like(p))
    ds = p * (_six(do, v.transpose(1, 2)) - delta)
    dv = _six(p.transpose(1, 2), do)
    dk = _six(ds.transpose(1, 2), q) * sm_scale
    dq = _six(ds, k) * sm_scale
    return dq, dk, dv


def test_three_bf16_terms_hold_float32_operands_exactly():
    """The split pass over q, k, v and do: hi + mid + lo is the float32
    value bit for bit at magnitudes 1e-30 to 1e30 of both signs, each term
    within 2^-8 of the one before (8 significant bits a term)."""
    rng = np.random.RandomState(11)
    n = 1 << 16
    x = torch.from_numpy((rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(
        -30, 30, n)).astype(np.float32))
    hi, mid, lo = _split(x)
    assert torch.equal(hi + mid + lo, x)
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0 ** -8).all())
    # the six term products keep a product of two such values to ~2^-24
    # (where the product stays in float32's range)
    xs = x[(x.abs() > 1e-15) & (x.abs() < 1e15)]
    xt, yt = _split(xs), _split(xs.flip(0))
    six = xt[0] * yt[0] + sum(xt[i] * yt[j] for i, j in LOWER_TERMS)
    exact = xs.double() * xs.flip(0).double()
    assert float(((six.double() - exact).abs() / exact.abs()).max()) \
        < 2.0 ** -22


@pytest.mark.parametrize("case", sorted(SM90_CASES))
def test_sm90_float32_arithmetic_forward_matches_pallas_interpret(case):
    bh, tq, tk, d, causal = SM90_CASES[case]
    q, k, v, _ = _sm90_inputs(bh, tq, tk, d, seed=12)
    sm = 1.0 / math.sqrt(d)
    ro, rl = ref_fa._flash_fwd(*(jnp.asarray(x) for x in (q, k, v)), None,
                               causal, sm, 128, 128, True)
    o, lse = _emulate_sm90_fwd_f32(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, sm)
    assert str(ro.dtype) == "float32"
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), **KERNEL_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rl), **KERNEL_TOL)


@pytest.mark.parametrize("case", sorted(SM90_CASES))
def test_sm90_float32_arithmetic_backward_matches_plain_version(case):
    bh, tq, tk, d, causal = SM90_CASES[case]
    q, k, v, do = (torch.from_numpy(x)
                   for x in _sm90_inputs(bh, tq, tk, d, seed=13))
    sm = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_reference(q, k, v, None, causal, sm)
    got = _emulate_sm90_bwd_f32(q, k, v, o, lse, do, causal, sm)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                            causal, sm)[:3]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **KERNEL_TOL)
