"""K6 (matmul with the producer's batch-norm folded in, and batch-norm
statistics) against the JAX package, on the CPU.

- ``matmul_bn_stats_plain`` (the plain version the CPU path and
  ``chip_smoke.py`` use) against ``paddle_tpu.pallas.conv_bn.
  matmul_bn_stats(..., interpret=True)`` under ``jax.disable_jit()``
  (jitted on the CPU, XLA drops the bf16 rounding of a bf16 product), for
  float32 and bfloat16 x, with and without producer statistics, relu on
  and off.  Both run the prologue as separate float32 operations, round
  the operands to bf16 (products exact in float32) and sum in float32 in
  other orders: a float32 y agrees to 2e-6 + 1e-5 relative; a bf16 y to
  one bf16 ulp (2^-7 relative; two float32 sums a few ulps apart can round
  to neighbouring bf16 values); the statistics to 1e-5 of the sum of
  |terms| (Σ|y| for s, Σy² for s2).  With statistics, y may also differ by
  one bf16 ulp of its largest term, 2^-7 max_k |a||w|: the reference's
  interpret mode, compiled by XLA on the CPU for a grid of several blocks,
  contracts ``* g + b`` into one FMA, so about 1 prologue value in 60,000
  rounds to the neighbouring bf16 value (the port rounds each operation,
  as the plain PyTorch ops do).
- the reference's shape rule: an M above 1024 with no dividing block of 8
  rows raises the same ``ValueError`` in both packages.
- ``mm_stats`` (the ``autograd.Function``) against ``jax.grad`` of the
  reference's ``mm_stats`` through all three outputs (1e-5 of the largest
  gradient: float32 in both).
- the wrapper's contract: CPU tensors take the plain version and count no
  launch; a wrong dtype, shape, layout or statistic raises.
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

F32_TOL = dict(rtol=1e-5, atol=2e-6)
BF16_RTOL = 2.0 ** -7
STAT_RTOL = 1e-5


def _inputs(m, k, n, seed, stats):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 0.5).astype(np.float32)
    w = (rng.randn(k, n) * 0.3).astype(np.float32)
    ps = None
    if stats:
        ps = ((rng.randn(k) * 0.1).astype(np.float32),
              rng.uniform(0.5, 2.0, k).astype(np.float32),
              (1 + rng.randn(k) * 0.1).astype(np.float32),
              (rng.randn(k) * 0.1).astype(np.float32))
    return x, w, ps


def _reference(x, w, ps, relu, dtype):
    jx = jnp.asarray(x).astype(dtype)
    jw = jnp.asarray(w).astype(dtype)
    jps = None if ps is None else tuple(jnp.asarray(p) for p in ps)
    with jax.disable_jit():
        y, s, s2 = ref_cb.matmul_bn_stats(jx, jw, jps, relu=relu,
                                          interpret=True)
    return (np.asarray(y.astype(jnp.float32)), np.asarray(s),
            np.asarray(s2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stats,relu", [(False, False), (False, True),
                                        (True, False), (True, True)],
                         ids=["plain", "relu_only", "norm", "norm_relu"])
@pytest.mark.parametrize("m,k,n", [(64, 16, 8), (200, 24, 70),
                                   (1536, 40, 16)])
def test_plain_matches_reference_kernel(dtype, stats, relu, m, k, n):
    x, w, ps = _inputs(m, k, n, seed=m + k + n, stats=stats)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ry, rs, rs2 = _reference(x, w, ps, relu, jdt)
    tdt = getattr(torch, dtype)
    tps = None if ps is None else tuple(torch.from_numpy(p) for p in ps)
    y, s, s2 = cb.matmul_bn_stats_plain(torch.from_numpy(x).to(tdt),
                                        torch.from_numpy(w).to(tdt), tps,
                                        relu=relu)
    assert y.dtype == tdt and y.shape == (m, n)
    assert s.dtype == s2.dtype == torch.float32
    yf, extra = y.float().numpy(), 0.0
    if stats:
        a = torch.from_numpy(x).to(tdt).float()
        a = (a - tps[0]) * tps[1] * tps[2] + tps[3]
        a = torch.relu(a) if relu else a
        terms = (a.to(torch.bfloat16).float().abs()[:, :, None]
                 * torch.from_numpy(w).to(tdt).float().abs()[None])
        extra = BF16_RTOL * terms.amax(dim=1).numpy()
    if dtype == "float32":
        tol = F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(ry) + extra
    else:
        tol = 1e-6 + BF16_RTOL * np.abs(ry) + extra
    assert (np.abs(yf - ry) <= tol).all(), np.abs(yf - ry).max()
    ya = np.abs(ry.astype(np.float64)).sum(axis=0)
    np.testing.assert_allclose(s.numpy(), rs, rtol=0,
                               atol=STAT_RTOL * ya.max())
    np.testing.assert_allclose(s2.numpy(), rs2, rtol=STAT_RTOL)


def test_relu_without_stats_matches_the_reference_test():
    """relu applies without the normalize (``test_conv_bn_kernel.py:69``):
    y = bf16(max(x, 0)) @ bf16(w)."""
    x, w, _ = _inputs(64, 16, 8, seed=7, stats=False)
    y, _, _ = cb.matmul_bn_stats_plain(torch.from_numpy(x),
                                       torch.from_numpy(w), None, relu=True)
    want = (torch.relu(torch.from_numpy(x)).to(torch.bfloat16).float()
            @ torch.from_numpy(w).to(torch.bfloat16).float())
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(
        y, cb.matmul_bn_stats_plain(torch.from_numpy(x), torch.from_numpy(w),
                                    None, relu=False)[0])


@pytest.mark.parametrize("m", [1027, 2052])
def test_m_without_dividing_block_raises_in_both_packages(m):
    x, w = np.zeros((m, 4), np.float32), np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="no dividing block_m"):
        ref_cb.matmul_bn_stats(jnp.asarray(x), jnp.asarray(w), None,
                               relu=False, interpret=True)
    with pytest.raises(ValueError, match="no dividing block_m"):
        cb.matmul_bn_stats_fwd(torch.from_numpy(x), torch.from_numpy(w))


@pytest.mark.parametrize("m", [1, 513, 1024, 1032])
def test_m_with_a_dividing_block_is_taken(m):
    y, s, s2 = cb.matmul_bn_stats_fwd(torch.ones(m, 4), torch.ones(4, 2),
                                      relu=False)
    assert y.shape == (m, 2) and float(s[0]) == 4.0 * m


@pytest.mark.parametrize("m", [64, 1536])
def test_mm_stats_grads_match_reference_vjp(m):
    x, w, _ = _inputs(m, 16, 8, seed=m, stats=False)
    coef = np.arange(8, dtype=np.float32)

    def ref_loss(x_, w_):
        y, s, s2 = ref_cb.mm_stats(x_, w_)
        return ((y.astype(jnp.float32) ** 2).sum() * 0.5
                + (s * coef).sum() + (s2 * 0.1).sum())

    with jax.disable_jit():
        want = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y, s, s2 = cb.mm_stats(xt, wt)
    loss = (y ** 2).sum() * 0.5 + (s * torch.from_numpy(coef)).sum() \
        + (s2 * 0.1).sum()
    got = torch.autograd.grad(loss, (xt, wt))
    for g, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=STAT_RTOL,
                                   atol=STAT_RTOL * np.abs(r).max())


def test_mm_stats_bf16_grads_keep_the_dtypes():
    x = torch.randn(32, 16).to(torch.bfloat16).requires_grad_(True)
    w = torch.randn(16, 8).requires_grad_(True)
    y, s, s2 = cb.mm_stats(x, w)
    assert y.dtype == torch.bfloat16
    gx, gw = torch.autograd.grad(y.float().sum() + s.sum() + s2.sum(),
                                 (x, w))
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    x, w, ps = _inputs(40, 24, 10, seed=1, stats=True)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    tps = tuple(torch.from_numpy(p) for p in ps)
    cb.reset_launch_count()
    got = cb.matmul_bn_stats_fwd(xt, wt, tps, relu=True)
    want = cb.matmul_bn_stats_plain(xt, wt, tps, relu=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert cb.launch_count("matmul_bn_stats") == 0


@pytest.mark.parametrize("case", ["dtype", "rank", "inner", "layout",
                                  "stats_len", "stats_count", "empty"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, w, ps = torch.zeros(16, 8), torch.zeros(8, 4), None
    if case == "dtype":
        x = x.half()
    elif case == "rank":
        x = x[0]
    elif case == "inner":
        w = torch.zeros(7, 4)
    elif case == "layout":
        w = torch.zeros(4, 8).t()
    elif case == "stats_len":
        ps = (torch.zeros(7),) * 4
    elif case == "stats_count":
        ps = (torch.zeros(8),) * 3
    else:
        x, w = torch.zeros(0, 8), torch.zeros(8, 4)
    with pytest.raises((TypeError, ValueError)):
        cb.matmul_bn_stats_fwd(x, w, ps)
