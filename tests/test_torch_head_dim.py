"""Flash and ring attention at any head dim, against the JAX package.

The reference computes attention at any head dim d (its blockwise
``_flash_fwd_jax`` on the CPU).  The port's wrappers take the plain
versions for CPU tensors at any d > 0 as well; on the card the kernels
run d up to 128, zero-padded to a multiple of 8 (``tests/test_torch_cuda.py``
holds that on the card).  Here, at d = 4, 12 and 136:

- ``flash_attention`` forward within 1e-5 absolute and relative of the
  reference's ``flash_attention``, and the gradients of ``sum(o * w)``
  within 2e-5 of ``jax.grad`` through the reference (its custom VJP, the
  plain ``_flash_bwd_jax`` on the CPU): the routes differ only in the order
  of their float32 sums;
- ``ring_attention`` over ``[cpu] * 4`` against the reference's ring under
  ``shard_map`` on the first 4 CPU devices: the output within 2e-5 and the
  gradients within 2e-4 (the reference tests' own tolerances);
- the wrappers' head-dim arithmetic: the padded dim is the next multiple
  of 8, padding is exact, and a d above 128 is refused for the card with a
  ``ValueError`` that names the reason (a meta tensor stands in for a card
  tensor: the check runs before any data moves).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.pallas import ring_attention as ref_ring
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import ring_attention as ra
from paddle_tpu_torch.parallel import make_mesh
from _port_fixtures import collect_garbage_after_module  # noqa: F401

# the module, not the function paddle_tpu.pallas re-exports under its name
ref_fa = importlib.import_module("paddle_tpu.pallas.flash_attention")

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
RING_O_TOL = dict(rtol=2e-5, atol=2e-5)
RING_GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
HEAD_DIMS = (4, 12, 136)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_forward_at_any_head_dim(d, causal):
    q, k, v = (_rand((2, 2, 24, d), i) for i in range(3))
    want = np.asarray(ref_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    assert got.shape == (2, 2, 24, d)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_grads_at_any_head_dim(d, causal):
    q, k, v = (_rand((1, 2, 20, d), i + 3) for i in range(3))
    w = _rand((1, 2, 20, d), 9)
    want = jax.grad(
        lambda q_, k_, v_: jnp.sum(ref_fa.flash_attention(
            q_, k_, v_, causal=causal) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   err_msg=f"d{name}", **GRAD_TOL)


def _ref_ring(causal):
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    spec = P(None, None, "sp", None)
    return jax.jit(shard_map(
        lambda q, k, v: ref_ring(q, k, v, "sp", causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_ring_at_any_head_dim(d, causal):
    q, k, v = (_rand((1, 2, 16, d), i + 6) for i in range(3))
    w = _rand((1, 2, 16, d), 12)
    ring = _ref_ring(causal)
    want_o = np.asarray(ring(q, k, v))
    want = jax.grad(lambda q_, k_, v_: jnp.sum(ring(q_, k_, v_) * w),
                    argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ra.ring_attention(qt, kt, vt, make_mesh({"sp": 4}, ["cpu"] * 4),
                          causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), want_o, **RING_O_TOL)
    (o * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   err_msg=f"d{name}", **RING_GRAD_TOL)


@pytest.mark.parametrize("d, dp", [(1, 8), (4, 8), (8, 8), (12, 16),
                                   (20, 24), (121, 128), (128, 128)])
def test_padded_head_dim_is_the_next_multiple_of_8(d, dp):
    assert fa.padded_head_dim("test", d) == dp
    x = torch.from_numpy(_rand((2, 5, d), d))
    xp = fa.pad_head_dim(x, dp)
    assert xp.shape == (2, 5, dp) and xp.is_contiguous()
    assert torch.equal(xp[..., :d], x) and not xp[..., d:].any()


def test_padding_the_head_dim_is_exact():
    """The kernels' padded call: the plain version on zero-padded q, k, v
    with the true d's scale gives the unpadded result."""
    q, k, v = (torch.from_numpy(_rand((3, 16, 12), i)) for i in range(3))
    do = torch.from_numpy(_rand((3, 16, 12), 5))
    qp, kp, vp, dop = (fa.pad_head_dim(x, 16) for x in (q, k, v, do))
    sm = 12 ** -0.5
    o, lse = fa.flash_attention_reference(q, k, v, None, True, sm)
    op, lsep = fa.flash_attention_reference(qp, kp, vp, None, True, sm)
    torch.testing.assert_close(op[..., :12], o, rtol=0, atol=1e-6)
    assert not op[..., 12:].any()
    torch.testing.assert_close(lsep, lse, rtol=0, atol=1e-6)
    grads = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                             True, sm)[:3]
    gradsp = fa.flash_attention_bwd_reference(qp, kp, vp, op, lsep, dop,
                                              None, True, sm)[:3]
    for g, gp in zip(grads, gradsp):
        torch.testing.assert_close(gp[..., :12], g, rtol=0, atol=1e-6)
        assert not gp[..., 12:].any()


def test_a_head_dim_above_128_is_refused_for_the_card():
    with pytest.raises(ValueError, match="shared memory"):
        fa.padded_head_dim("test", 136)
    q = torch.zeros(2, 8, 136, device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        ra.ring_attention_fwd(q, q, q, [torch.device("meta")] * 2)


def test_cpu_tensors_take_any_head_dim_and_launch_nothing():
    fa.reset_launch_count()
    q = torch.from_numpy(_rand((2, 16, 12), 0))
    o, lse = fa.flash_attention_fwd(q, q, q, None, True)
    assert o.shape == (2, 16, 12) and fa.launch_count() == 0
    with pytest.raises(ValueError, match="positive"):
        fa.flash_attention_fwd(q[..., :0], q[..., :0], q[..., :0])
