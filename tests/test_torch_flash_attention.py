"""The port's flash-attention forward against the JAX package.

The same numpy inputs go through ``paddle_tpu.pallas.flash_attention``
(which runs its blockwise ``_flash_fwd_jax`` on the CPU) and through the
port's ``flash_attention``/``flash_attention_fwd`` (whose CPU path is the
plain version of the CUDA kernel).  Tolerance: 1e-5 absolute and relative,
float32.  The CUDA kernel itself is held against the plain version on the
card by ``tests/test_torch_cuda.py`` (and by ``chip_smoke.py``).
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
        q, k, v = (torch.randn(2, 16, 12) for _ in range(3))
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
