"""K3 (1x1 convolution with batch-norm statistics) against the JAX package,
on the CPU.

- ``conv1x1_stats_plain`` (the plain version the CPU path and
  ``chip_smoke.py`` use) against ``paddle_tpu.pallas.conv_bn.
  conv1x1_stats_nchw`` run in interpret mode under ``jax.disable_jit()``:
  jitted on the CPU, XLA drops the bf16 rounding of a bf16 product, so the
  Pallas kernel would not compute what it computes on the TPU.  Both round
  the operands to bf16 (products exact in float32) and sum in float32 in
  another order: y agrees to 2e-6 + 1e-5 relative, and the statistics to
  1e-5 relative of the sum of |terms| (Σ|y| for s, Σy² for s2).
- ``conv1x1_stats`` (the ``autograd.Function``; on CPU tensors its forward
  is the plain version) against ``jax.grad`` of the reference's
  ``conv1x1_stats`` (custom VJP) through all three outputs, same
  tolerance: the backward is float32 in both.
- the wrapper's contract: CPU tensors take the plain version and count no
  launch; a wrong dtype, shape or layout raises.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import conv_bn as cb
from _port_fixtures import collect_garbage_after_module  # noqa: F401

ref_cb = importlib.import_module("paddle_tpu.pallas.conv_bn")

Y_TOL = dict(rtol=1e-5, atol=2e-6)
STAT_RTOL = 1e-5


def _inputs(n, cin, cout, p, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, cin, p) * 0.5).astype(np.float32)
    w = (rng.randn(cout, cin) * 0.3).astype(np.float32)
    return x, w


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("cin,cout", [(13, 21), (12, 20), (64, 64)],
                         ids=["odd", "ragged", "tile"])
@pytest.mark.parametrize("p", [49, 64, 196])
def test_plain_matches_reference_kernel(n, cin, cout, p):
    x, w = _inputs(n, cin, cout, p, seed=cin + p + n)
    with jax.disable_jit():
        ry, rs, rs2 = ref_cb.conv1x1_stats_nchw(jnp.asarray(x),
                                                jnp.asarray(w),
                                                interpret=True)
    y, s, s2 = cb.conv1x1_stats_plain(torch.from_numpy(x),
                                      torch.from_numpy(w))
    assert y.dtype == torch.float32 and y.shape == (n, cout, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **Y_TOL)
    ya = np.abs(np.asarray(ry, np.float64))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=0,
                               atol=STAT_RTOL * ya.sum(axis=(0, 2)).max())
    np.testing.assert_allclose(s2.numpy(), np.asarray(rs2), rtol=STAT_RTOL)


def test_plain_rounds_operands_to_bf16():
    """A value that bf16 cannot hold is rounded before the product."""
    x = torch.full((1, 1, 2), 1.0 + 2.0 ** -10)
    w = torch.ones(1, 1)
    y, s, s2 = cb.conv1x1_stats_plain(x, w)
    assert torch.equal(y, torch.ones(1, 1, 2))
    assert float(s) == 2.0 and float(s2) == 2.0


@pytest.mark.parametrize("p", [49, 196])
def test_function_grads_match_reference_vjp(p):
    x, w = _inputs(2, 16, 8, p, seed=p)
    coef = np.arange(8, dtype=np.float32)

    def ref_loss(x_, w_):
        y, s, s2 = ref_cb.conv1x1_stats(x_, w_)
        return ((y.astype(jnp.float32) ** 2).sum() * 0.5
                + (s * coef).sum() + (s2 * 0.1).sum())

    with jax.disable_jit():
        want = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y, s, s2 = cb.conv1x1_stats(xt, wt)
    loss = (y ** 2).sum() * 0.5 + (s * torch.from_numpy(coef)).sum() \
        + (s2 * 0.1).sum()
    got = torch.autograd.grad(loss, (xt, wt))
    for g, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=STAT_RTOL,
                                   atol=STAT_RTOL * np.abs(r).max())


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    x, w = _inputs(2, 8, 4, 49, seed=1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    cb.reset_launch_count()
    got = cb.conv1x1_stats_fwd(xt, wt)
    want = cb.conv1x1_stats_plain(xt, wt)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert cb.launch_count() == 0


@pytest.mark.parametrize("case", ["dtype", "rank", "channels", "layout"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, w = torch.zeros(2, 8, 49), torch.zeros(4, 8)
    if case == "dtype":
        x = x.double()
    elif case == "rank":
        x = x[0]
    elif case == "channels":
        w = torch.zeros(4, 7)
    else:
        x = torch.zeros(2, 49, 8).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        cb.conv1x1_stats_fwd(x, w)


# -- bf16 x (AMP) ------------------------------------------------------------------
#
# Under AMP the fused op hands K3 a bf16 x and the float32 master w.  The
# same seeded x rounded to bf16 in both packages; the reference's kernel in
# interpret mode writes y in x's dtype, rounded once from the float32 sum,
# as the plain version does: y within one bf16 ulp of its largest
# magnitude, s and s2 (float32 sums of the float32 products) within the
# float32 tolerances above.

def _bf16_ulp(a):
    top = float(np.abs(np.asarray(a, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout,p", [(13, 21, 49), (64, 64, 196),
                                        (12, 20, 64)])
def test_bf16_plain_matches_reference_kernel(cin, cout, p, w_dtype):
    x, w = _inputs(2, cin, cout, p, seed=cin + cout + p)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(w_dtype)
    with jax.disable_jit():
        ry, rs, rs2 = ref_cb.conv1x1_stats_nchw(jx, jw, interpret=True)
    y, s, s2 = cb.conv1x1_stats_plain(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(w).to(getattr(torch, w_dtype)))
    assert y.dtype == torch.bfloat16 and str(ry.dtype) == "bfloat16"
    assert s.dtype == s2.dtype == torch.float32
    ry = np.asarray(ry, np.float32)
    np.testing.assert_allclose(y.float().numpy(), ry, rtol=0,
                               atol=_bf16_ulp(ry))
    ya = np.abs(ry.astype(np.float64))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=0,
                               atol=STAT_RTOL * ya.sum(axis=(0, 2)).max())
    np.testing.assert_allclose(s2.numpy(), np.asarray(rs2), rtol=STAT_RTOL)
