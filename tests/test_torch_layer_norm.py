"""K4 (LayerNorm over the last dim) against the JAX package, on the CPU.

- ``layer_norm_fwd_plain`` (the plain version the CPU path and
  ``chip_smoke.py`` use) against the reference's ``_ln_ref`` and against
  ``_fwd_pallas`` run in interpret mode, at rows 1/37/515 x d 8/96/768:
  y within 1e-5 + 1e-5 relative (float32, the sums in another order);
- ``layer_norm_bwd_plain`` against ``_bwd_pallas`` in interpret mode: dx
  within 1e-5 + 1e-5 relative, dscale and dbias (sums over all rows) within
  1e-5 of the sum of their terms' magnitudes;
- ``fused_layer_norm`` (the ``autograd.Function``; on CPU tensors the plain
  versions) against ``jax.vjp`` of the reference's ``fused_layer_norm``
  (custom VJP) over a 3-D input;
- the wrappers' contract: CPU tensors take the plain version and count no
  launch; a wrong dtype, shape or layout raises.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import layer_norm as ln
from _port_fixtures import collect_garbage_after_module  # noqa: F401

ref_ln = importlib.import_module("paddle_tpu.pallas.layer_norm")

TOL = dict(rtol=1e-5, atol=1e-5)
SUM_RTOL = 1e-5
EPS = 1e-5


def _inputs(rows, d, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, d) * 2 + 0.5).astype(np.float32)
    s = (rng.randn(d) * 0.5 + 1).astype(np.float32)
    b = (rng.randn(d) * 0.1).astype(np.float32)
    dy = rng.randn(rows, d).astype(np.float32)
    return x, s, b, dy


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


SHAPES = [(r, d) for r in (1, 37, 515) for d in (8, 96, 768)]


@pytest.mark.parametrize("rows,d", SHAPES)
def test_forward_plain_matches_reference(rows, d):
    x, s, b, _ = _inputs(rows, d, seed=rows + d)
    y = ln.layer_norm_fwd_plain(*_t(x, s, b), EPS)
    assert y.dtype == torch.float32 and tuple(y.shape) == (rows, d)
    want_ref = ref_ln._ln_ref(jnp.asarray(x), jnp.asarray(s),
                              jnp.asarray(b), EPS)
    want_kernel = ref_ln._fwd_pallas(jnp.asarray(x), jnp.asarray(s),
                                     jnp.asarray(b), EPS, True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_kernel), **TOL)


@pytest.mark.parametrize("rows,d", SHAPES)
def test_backward_plain_matches_reference_kernel(rows, d):
    x, s, _, dy = _inputs(rows, d, seed=3 * rows + d)
    dx, ds, db = ln.layer_norm_bwd_plain(*_t(x, s, dy), EPS)
    rdx, rds, rdb = ref_ln._bwd_pallas(jnp.asarray(x), jnp.asarray(s),
                                       jnp.asarray(dy), EPS, True)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), **TOL)
    xhat = np.asarray(ln.layer_norm_fwd_plain(
        *_t(x, np.ones(d, np.float32), np.zeros(d, np.float32)), EPS))
    for got, want, terms in ((ds, rds, np.abs(dy * xhat)),
                             (db, rdb, np.abs(dy))):
        assert got.dtype == torch.float32 and tuple(got.shape) == (d,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=SUM_RTOL * terms.sum(axis=0).max())


@pytest.mark.parametrize("shape", [(3, 5, 96), (2, 768)])
def test_function_grads_match_reference_vjp(shape):
    rng = np.random.RandomState(11)
    x = (rng.randn(*shape) * 1.5).astype(np.float32)
    s = (rng.randn(shape[-1]) + 1).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    xt, st, bt = (torch.from_numpy(a).requires_grad_() for a in (x, s, b))
    y = ln.fused_layer_norm(xt, st, bt, EPS)
    got = torch.autograd.grad(y, (xt, st, bt), torch.from_numpy(g))
    want_y, vjp = jax.vjp(
        lambda x_, s_, b_: ref_ln.fused_layer_norm(x_, s_, b_, eps=EPS),
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    want = vjp(jnp.asarray(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
    rows = int(np.prod(shape[:-1]))
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5 * rows)


def test_cpu_counts_no_launch_and_bad_inputs_raise():
    x, s, b, dy = _t(*_inputs(4, 8, seed=0))
    ln.reset_launch_count()
    ln.layer_norm_fwd(x, s, b, EPS)
    ln.layer_norm_bwd(x, s, dy, EPS)
    assert ln.launch_count("layer_norm_fwd") == 0
    assert ln.launch_count("layer_norm_bwd") == 0
    with pytest.raises(TypeError, match="float32"):
        ln.layer_norm_fwd(x.double(), s, b, EPS)
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm_fwd(x.t(), s, b, EPS)
    with pytest.raises(ValueError, match=r"must be \(8,\)"):
        ln.layer_norm_fwd(x, s[:4].contiguous(), b, EPS)
    with pytest.raises(ValueError, match=r"must be \(4, 8\)"):
        ln.layer_norm_bwd(x, s, dy[:2].contiguous(), EPS)


# (rows, d, dtype, partial rows): the one-warp-a-row backward up to d 768
# (float32) and 1024 (bf16), one partial row a cluster of 64 warps, at most
# 12; wider rows the multi-warp backward, one a block of 8 / wpr rows, at
# most 512
PARTIAL_ROWS = [(1, 4, "float32", 1), (64, 768, "float32", 1),
                (65, 768, "float32", 2), (16384, 768, "float32", 12),
                (16385, 760, "bfloat16", 12), (700, 1024, "bfloat16", 11),
                (16384, 772, "float32", 512), (7, 1028, "bfloat16", 4),
                (4099, 1000, "float32", 512), (16385, 4096, "float32", 512),
                (9, 4096, "bfloat16", 9), (100, 2048, "float32", 50)]


@pytest.mark.parametrize("rows,d,dtype,want", PARTIAL_ROWS)
def test_backward_scratch_follows_the_row_and_wide_forms(rows, d, dtype,
                                                         want):
    assert ln.partial_rows(rows, d, getattr(torch, dtype)) == want


def test_backward_scratch_refuses_what_the_kernels_refuse():
    """The widths the card's kernels refuse raise the wrappers' error; the
    CPU wrappers take them (the plain versions)."""
    with pytest.raises(ValueError, match="exceeds the kernel's 4096"):
        ln.partial_rows(8, 4097, torch.float32)
    for rows, d in ((0, 8), (8, 0)):
        with pytest.raises(ValueError, match="positive"):
            ln.partial_rows(rows, d, torch.bfloat16)
    x, s, _, dy = _t(*_inputs(3, 4097, seed=1))
    dx, ds, db = ln.layer_norm_bwd(x, s, dy, EPS)
    assert tuple(dx.shape) == (3, 4097) and tuple(ds.shape) == (4097,)


# -- bf16 rows (AMP) ---------------------------------------------------------------
#
# x and dy rounded to bf16 in both packages, scale and bias float32.  The
# reference's kernels in interpret mode compute the statistics in float32
# and write y and dx in x's dtype, rounded once; dscale and dbias stay
# float32.  y and dx within one bf16 ulp of their largest magnitude, dscale
# and dbias within the float32 tolerance above.

def _bf16_ulp(a):
    top = float(np.abs(np.asarray(a, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("rows,d", [(37, 96), (515, 768), (1, 8)])
def test_bf16_plain_matches_reference_kernels(rows, d):
    x, s, b, dy = _inputs(rows, d, seed=rows + 2 * d)
    jx, jdy = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, dy))
    tx, tdy = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, dy))
    ry = ref_ln._fwd_pallas(jx, jnp.asarray(s), jnp.asarray(b), EPS, True)
    rdx, rds, rdb = ref_ln._bwd_pallas(jx, jnp.asarray(s), jdy, EPS, True)
    y = ln.layer_norm_fwd(tx, *_t(s, b), EPS)
    dx, ds, db = ln.layer_norm_bwd(tx, *_t(s), tdy, EPS)
    for name, got, want in (("y", y, ry), ("dx", dx, rdx)):
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=_bf16_ulp(want), err_msg=name)
    xhat = np.asarray(ln.layer_norm_fwd_plain(
        tx.float(), *_t(np.ones(d, np.float32), np.zeros(d, np.float32)),
        EPS))
    dyf = tdy.float().numpy()
    for got, want, terms in ((ds, rds, np.abs(dyf * xhat)),
                             (db, rdb, np.abs(dyf))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=SUM_RTOL * terms.sum(axis=0).max())
