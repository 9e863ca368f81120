"""K5 (dense layer with its bias + activation epilogue) against the JAX
package, on the CPU.

- ``dense_act_plain`` (the plain version the CPU path and ``chip_smoke.py``
  use) against ``paddle_tpu.pallas.dense_epilogue.matmul_bias_act`` run in
  interpret mode under ``jax.disable_jit()`` (jitted on the CPU, XLA drops
  the bf16 rounding of a bf16 product), for each activation: both round the
  operands to bf16 (products exact in float32) and sum in float32 in
  another order, so y agrees within 1e-5 + 1e-5 relative;
- ``dense_act`` (the ``autograd.Function``; on CPU tensors its forward is
  the plain version) against ``jax.vjp`` of ``matmul_bias_act``, whose
  backward recomputes the pre-activation from bf16 products: dx, dw, db
  within 1e-5 + 1e-5 relative;
- M = 513, which no 8-row block divides, is refused by the reference's
  kernel (and the fused op falls back to float32 there); the port's fused
  op decides the same before any launch (``test_torch_fusion.py`` compares
  the two fused ops);
- the wrapper's contract: CPU tensors take the plain version and count no
  launch; a wrong dtype, shape, layout or activation raises.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import dense_epilogue as de
from paddle_tpu_torch.ops import fused_ops
from _port_fixtures import collect_garbage_after_module  # noqa: F401

ref_de = importlib.import_module("paddle_tpu.pallas.dense_epilogue")

TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = [("", False), ("relu", False), ("gelu", False), ("gelu", True)]
ACT_IDS = ["none", "relu", "gelu_erf", "gelu_tanh"]


def _inputs(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * k ** -0.5).astype(np.float32)
    b = (rng.randn(n) * 0.5).astype(np.float32)
    return x, w, b


def _ref(x, w, b, act, approximate):
    with jax.disable_jit():
        return ref_de.matmul_bias_act(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), act=act,
                                      approximate=approximate,
                                      interpret=True)


@pytest.mark.parametrize("act,approximate", ACTS, ids=ACT_IDS)
@pytest.mark.parametrize("m,k,n", [(8, 16, 24), (64, 96, 130),
                                   (512, 40, 24)])
def test_plain_matches_reference_kernel(m, k, n, act, approximate):
    x, w, b = _inputs(m, k, n, seed=m + k + n)
    y = de.dense_act_plain(*map(torch.from_numpy, (x, w, b)), act,
                           approximate)
    assert y.dtype == torch.float32 and tuple(y.shape) == (m, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(_ref(
        x, w, b, act, approximate)), **TOL)


@pytest.mark.parametrize("act,approximate", ACTS, ids=ACT_IDS)
def test_function_grads_match_reference_vjp(act, approximate):
    x, w, b = _inputs(40, 48, 72, seed=5)
    g = np.random.RandomState(6).randn(40, 72).astype(np.float32)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = de.dense_act(xt, wt, bt, act, approximate)
    got = torch.autograd.grad(y, (xt, wt, bt), torch.from_numpy(g))
    with jax.disable_jit():
        want_y, vjp = jax.vjp(
            lambda x_, w_, b_: ref_de.matmul_bias_act(
                x_, w_, b_, act=act, approximate=approximate,
                interpret=True),
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        want = vjp(jnp.asarray(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


def test_m513_is_refused_by_the_reference_kernel_and_the_shape_rule():
    x, w, b = _inputs(513, 16, 8, seed=1)
    with pytest.raises(ValueError, match="no dividing block_m"):
        _ref(x, w, b, "gelu", False)
    assert not fused_ops._k5_tiles(513)
    assert all(fused_ops._k5_tiles(m) for m in (1, 7, 512, 520, 16384))


def test_cpu_counts_no_launch_and_bad_inputs_raise():
    x, w, b = map(torch.from_numpy, _inputs(4, 8, 6, seed=0))
    de.reset_launch_count()
    de.dense_act_fwd(x, w, b, "gelu")
    assert de.launch_count() == 0
    with pytest.raises(TypeError, match="float32"):
        de.dense_act_fwd(x.double(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        de.dense_act_fwd(x, w.t().contiguous().t(), b)
    with pytest.raises(ValueError, match=r"x must be \[M, K\]"):
        de.dense_act_fwd(x, w[:5].contiguous(), b)
    with pytest.raises(ValueError, match="activation"):
        de.dense_act_fwd(x, w, b, "tanh")


# -- bf16 operands (AMP) -----------------------------------------------------------
#
# Under AMP the fused op hands K5 bf16 x and w (``_amp_pair``) and the
# float32 bias.  The same seeded operands rounded to bf16 in both packages;
# the reference's kernel in interpret mode (under ``jax.disable_jit()``)
# writes y in x's dtype, rounded once from the float32 sum plus bias and
# activation, as the plain version does: y within one bf16 ulp of its
# largest magnitude.

def _bf16_ulp(a):
    top = float(np.abs(np.asarray(a, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("act,approximate", ACTS, ids=ACT_IDS)
@pytest.mark.parametrize("m,k,n", [(8, 16, 24), (64, 96, 130),
                                   (512, 40, 24)])
def test_bf16_plain_matches_reference_kernel(m, k, n, act, approximate):
    x, w, b = _inputs(m, k, n, seed=m + k + n + 1)
    with jax.disable_jit():
        ry = ref_de.matmul_bias_act(
            jnp.asarray(x).astype(jnp.bfloat16),
            jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(b), act=act,
            approximate=approximate, interpret=True)
    y = de.dense_act_fwd(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(w).to(torch.bfloat16),
                         torch.from_numpy(b), act, approximate)
    assert y.dtype == torch.bfloat16 and str(ry.dtype) == "bfloat16"
    ry = np.asarray(ry, np.float32)
    np.testing.assert_allclose(y.float().numpy(), ry, rtol=0,
                               atol=_bf16_ulp(ry))
