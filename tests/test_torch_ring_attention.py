"""The port's ring attention (K7) against the JAX package's, on the CPU.

- the same numpy q, k, v go through ``paddle_tpu.pallas.ring_attention``
  under ``shard_map`` on the CPU mesh (the first 4 or all 8 of the
  conftest's virtual devices, as ``tests/test_attention.py`` runs it) and
  through the port's ``ring_attention`` over a mesh of virtual ranks
  (``make_mesh({"sp": n}, [cpu] * n)``): sp 4 and 8, causal or not, the
  output at (1, 2, 32, 8) within 2e-5 absolute and relative and the
  gradients of ``sum(o * w)`` at (1, 2, 16, 8) within 2e-4 (the reference
  tests' own tolerances);
- the bf16 forward against the reference ring run op by op
  (``jax.disable_jit``: jitted on the CPU, XLA keeps bf16 products in
  float32).  The reference runs under ``jax.vmap`` with the ``sp`` axis
  name, whose ``ppermute`` and ``axis_index`` are those of ``shard_map``:
  ``shard_map`` run op by op takes ~45 s a call on a CPU host.  Within one
  bf16 ulp of max|o|;
- the plain merge against the reference's ``_merge``, NEG_INF rows on
  either side and on both: exact on those rows (their weights are 0 and
  1), elsewhere within two float32 ulps of the terms (XLA's ``exp`` and
  ``log`` on the CPU and PyTorch's differ by an ulp), one bf16 ulp in bf16;
- the ring's schedule: the kernel calls per forward + backward are
  ``expected_launches`` (n² K1, n² K2, n(n - 1) merges; causal n(n + 1)/2
  and n(n - 1)/2), the causal diagonal steps pass ``causal=True``;
- the flash backward with a given ``delta`` equals the one that computes
  it; the ring refuses a T its ranks do not divide.

Nothing here starts a process or a ``torch.distributed`` group: the
virtual ranks run one after another in this process.
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
from paddle_tpu_torch.framework import core, scope, unique_name
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import ring_attention as ra
from paddle_tpu_torch.parallel import make_mesh
from _port_fixtures import collect_garbage_after_module  # noqa: F401

# the module, not the function paddle_tpu.pallas re-exports under its name
ref_ring_mod = importlib.import_module("paddle_tpu.pallas.ring_attention")

CPU = torch.device("cpu")
O_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


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


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ref_ring(n, causal):
    """The reference ring under shard_map over the first n CPU devices."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    spec = P(None, None, "sp", None)
    return jax.jit(shard_map(
        lambda q, k, v: ref_ring(q, k, v, "sp", causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec))


def _port_mesh(n):
    return make_mesh({"sp": n}, [CPU] * n)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("n", [4, 8], ids=["sp4", "sp8"])
def test_ring_forward_matches_reference_ring(n, causal):
    q, k, v = (_rand((1, 2, 32, 8), i) for i in range(3))
    want = np.asarray(_ref_ring(n, causal)(q, k, v))
    got = ra.ring_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), _port_mesh(n),
                            causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **O_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("n", [4, 8], ids=["sp4", "sp8"])
def test_ring_grads_match_reference_ring(n, causal):
    q, k, v = (_rand((1, 2, 16, 8), i) for i in range(3))
    w = _rand((1, 2, 16, 8), 11)
    ring = _ref_ring(n, causal)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(ring(q_, k_, v_) * w),
                    argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ra.ring_attention(qt, kt, vt, _port_mesh(n), causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   err_msg=f"d{name}", **GRAD_TOL)


def _ref_ring_vmapped(q, k, v, n, causal):
    """The reference ring with its sp axis named by ``jax.vmap`` (the same
    collectives as under shard_map), over [b, h, T, d] inputs."""
    b, h, t, d = q.shape

    def shard(x):
        return jnp.moveaxis(x.reshape(b, h, n, t // n, d), 2, 0)

    o = jax.vmap(lambda q_, k_, v_: ref_ring(q_, k_, v_, "sp",
                                             causal=causal),
                 axis_name="sp")(shard(q), shard(k), shard(v))
    return jnp.moveaxis(o, 0, 2).reshape(b, h, t, d)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_bf16_forward_matches_reference_op_by_op(causal):
    q, k, v = (_rand((1, 2, 32, 8), i) for i in range(3))
    with jax.disable_jit():
        want = _ref_ring_vmapped(*(jnp.asarray(x).astype(jnp.bfloat16)
                                   for x in (q, k, v)), 4, causal)
    want = np.asarray(want.astype(jnp.float32))
    got = ra.ring_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                              for x in (q, k, v)), _port_mesh(4),
                            causal=causal)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


def _merge_inputs():
    rng = np.random.RandomState(5)
    bh, tq, d = 3, 64, 8
    o1, o2 = (rng.randn(bh, tq, d).astype(np.float32) for _ in range(2))
    l1, l2 = ((rng.randn(bh, tq) * 3).astype(np.float32) for _ in range(2))
    l1[0, :5] = ra.NEG_INF              # masked on the left only
    l2[0, 3:8] = ra.NEG_INF             # on the right (3, 4: on both)
    l2[1, :4] = ra.NEG_INF
    l1[2, 10:12] = l2[2, 10:12] = ra.NEG_INF
    masked = (l1 <= ra.NEG_INF / 2) | (l2 <= ra.NEG_INF / 2)
    return o1, l1, o2, l2, masked


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_reference_merge(dtype):
    o1, l1, o2, l2, masked = _merge_inputs()
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    with jax.disable_jit():
        ro, rl = ref_ring_mod._merge(jnp.asarray(o1).astype(jd),
                                     jnp.asarray(l1),
                                     jnp.asarray(o2).astype(jd),
                                     jnp.asarray(l2))
    ro = np.asarray(ro.astype(jnp.float32))
    rl = np.asarray(rl)
    t1, t2 = (torch.from_numpy(x).to(td) for x in (o1, o2))
    go, gl = ra.ring_merge(t1, torch.from_numpy(l1), t2,
                           torch.from_numpy(l2))
    assert go.dtype == td and gl.dtype == torch.float32
    go, gl = go.float().numpy(), gl.numpy()
    # rows with a NEG_INF side: weights 0 and 1 (or a fully masked row)
    np.testing.assert_array_equal(go[masked], ro[masked])
    np.testing.assert_array_equal(gl[masked], rl[masked])
    assert (rl[masked] <= ra.NEG_INF / 2).sum() == 4   # masked on both
    terms = np.abs(t1.float().numpy()) + np.abs(t2.float().numpy())
    if dtype == "float32":
        assert np.all(np.abs(go - ro) <= 2.0 ** -22 * terms)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ro).max())) - 7)
        np.testing.assert_allclose(go, ro, rtol=0, atol=ulp)
    np.testing.assert_allclose(gl, rl, rtol=2.0 ** -22, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_into_out_equals_the_fresh_merge_and_reference(dtype):
    """``out=(o1, lse1)`` (the ring's in-place merge) on CPU tensors: the
    out pair is returned and holds the bits of the merge into new tensors,
    which the reference's ``_merge`` matches as above."""
    o1, l1, o2, l2, masked = _merge_inputs()
    td = getattr(torch, dtype)
    t1, t2 = (torch.from_numpy(x).to(td) for x in (o1, o2))
    tl1, tl2 = torch.from_numpy(l1), torch.from_numpy(l2)
    fo, fl = ra.ring_merge(t1, tl1, t2, tl2)
    a, b = t1.clone(), tl1.clone()
    got = ra.ring_merge(a, b, t2, tl2, out=(a, b))
    assert got[0] is a and got[1] is b
    assert torch.equal(a, fo) and torch.equal(b, fl)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with jax.disable_jit():
        ro, rl = ref_ring_mod._merge(jnp.asarray(o1).astype(jd),
                                     jnp.asarray(l1),
                                     jnp.asarray(o2).astype(jd),
                                     jnp.asarray(l2))
    ro = np.asarray(ro.astype(jnp.float32))
    np.testing.assert_array_equal(a.float().numpy()[masked], ro[masked])
    np.testing.assert_allclose(b.numpy(), np.asarray(rl), rtol=2.0 ** -22,
                               atol=0)


def test_merge_out_refuses_memory_of_another_input():
    """An out tensor may be o1 (lse1) itself, never memory of another
    input, and must have o1's (lse1's) shape and dtype."""
    o1, l1, o2, l2, _ = _merge_inputs()
    t1, tl1, t2, tl2 = (torch.from_numpy(x) for x in (o1, l1, o2, l2))
    for out in ((t2, tl1), (t1, tl2), (t1[:, :8].contiguous(), tl1),
                (t1, tl1.double()), (torch.empty_like(t1), t2[0, :, 0])):
        with pytest.raises(ValueError, match="out"):
            ra.ring_merge(t1, tl1, t2, tl2, out=out)
    fresh = (torch.empty_like(t1), torch.empty_like(tl1))
    assert ra.ring_merge(t1, tl1, t2, tl2, out=fresh) is fresh


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_forward_merges_in_place_and_matches_reference_ring(
        monkeypatch, causal):
    """The ring's kernel steps merge into each rank's running partial
    (``out`` is ``(o1, lse1)`` itself); the forward still matches the
    reference ring under shard_map at sp 4."""
    real_merge = ra.ring_merge
    in_place = []

    def merge(o1, lse1, o2, lse2, out=None):
        in_place.append(out is not None and out[0] is o1
                        and out[1] is lse1)
        return real_merge(o1, lse1, o2, lse2, out=out)

    monkeypatch.setattr(ra, "ring_merge", merge)
    q, k, v = (_rand((1, 2, 32, 8), i) for i in range(3))
    want = np.asarray(_ref_ring(4, causal)(q, k, v))
    got = ra.ring_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), _port_mesh(4),
                            causal=causal)
    assert in_place == [True] * ra.expected_launches(4, causal)["ring_merge"]
    np.testing.assert_allclose(got.numpy(), want, **O_TOL)


def test_expected_launches_are_the_schedules():
    """n^2 K1 and K2 and n(n - 1) merges without a mask, n(n + 1)/2 and
    n(n - 1)/2 causal: the counts chip_smoke.py holds the ring to."""
    want = {(1, False): (1, 0), (2, False): (4, 2), (4, False): (16, 12),
            (8, False): (64, 56), (1, True): (1, 0), (2, True): (3, 1),
            (4, True): (10, 6), (8, True): (36, 28)}
    for (n, causal), (steps, merges) in want.items():
        assert ra.expected_launches(n, causal) == {
            "flash_attn_fwd": steps, "flash_attn_bwd": steps,
            "ring_merge": merges}


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_schedule_launches(monkeypatch, n, causal):
    """One forward + backward calls K1, K2 and the merge as
    ``expected_launches`` says; the causal flag is set on the diagonal
    steps only."""
    calls = {"flash_attn_fwd": [], "flash_attn_bwd": [], "ring_merge": 0}
    real_fwd, real_bwd = fa.flash_attention_fwd, fa.flash_attention_bwd
    real_merge = ra.ring_merge

    def fwd(q, k, v, bias=None, causal=False, sm_scale=None):
        calls["flash_attn_fwd"].append(bool(causal))
        return real_fwd(q, k, v, bias, causal, sm_scale)

    def bwd(q, k, v, o, lse, do, causal=False, sm_scale=None, delta=None):
        assert delta is not None      # computed once, outside the steps
        calls["flash_attn_bwd"].append(bool(causal))
        return real_bwd(q, k, v, o, lse, do, causal, sm_scale, delta)

    def merge(*a, **kw):
        calls["ring_merge"] += 1
        return real_merge(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    monkeypatch.setattr(ra, "ring_merge", merge)
    q, k, v = (torch.from_numpy(_rand((1, 2, 16, 8), i)).requires_grad_()
               for i in range(3))
    o = ra.ring_attention(q, k, v, _port_mesh(n), causal=causal)
    o.sum().backward()
    want = ra.expected_launches(n, causal)
    got = {key: len(c) if isinstance(c, list) else c
           for key, c in calls.items()}
    assert got == want
    for key in ("flash_attn_fwd", "flash_attn_bwd"):
        assert sum(calls[key]) == (n if causal else 0)
    ref = fa.mha_reference(*(x.detach() for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), ref.numpy(), **O_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_ring_calls_no_kernel_wrapper(monkeypatch, causal):
    """``plain=True`` runs the schedule through the plain K1, K2 and merge
    only (the ring's reference on the card), with the wrappers' values on
    CPU tensors."""
    q, k, v, do = (torch.from_numpy(_rand((2, 16, 8), i)) for i in range(4))
    devices = [CPU] * 4
    o, lse = ra.ring_attention_fwd(q, k, v, devices, causal)
    grads = ra.ring_attention_bwd(q, k, v, o, lse, do, devices, causal)

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called")

    for mod, name in ((fa, "flash_attention_fwd"),
                      (fa, "flash_attention_bwd"), (ra, "ring_merge")):
        monkeypatch.setattr(mod, name, refuse)
    po, plse = ra.ring_attention_fwd(q, k, v, devices, causal, plain=True)
    pgrads = ra.ring_attention_bwd(q, k, v, o, lse, do, devices, causal,
                                   plain=True)
    for a, b in zip((o, lse) + grads, (po, plse) + pgrads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flash_backward_with_given_delta():
    q, k, v, do = (torch.from_numpy(_rand((2, 24, 8), i)) for i in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, None, True)
    delta = torch.sum(do * o, dim=-1)
    want = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, True, None, delta)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="delta"):
        fa.flash_attention_bwd(q, k, v, o, lse, do, True, None,
                               delta.double())


def test_ring_refuses_what_it_cannot_shard():
    q = torch.zeros(1, 2, 12, 8)
    with pytest.raises(ValueError, match="not divisible"):
        ra.ring_attention(q, q, q, _port_mesh(8))
    with pytest.raises(ValueError, match="one shape"):
        ra.ring_attention(q, torch.zeros(1, 2, 16, 8), q, _port_mesh(4))


@pytest.mark.parametrize("tensor_device, mesh_device", [
    ("cpu", torch.device("cuda", 0)),
    # a meta tensor stands in for a card tensor: the check runs before any
    # data moves, so a CPU mesh must refuse it the same way
    ("meta", CPU)])
def test_ring_refuses_a_mesh_of_another_device_type(tensor_device,
                                                    mesh_device):
    """No hidden move: tensors of one device type never ring over a mesh
    of another (e.g. card tensors over a CPU mesh left set by earlier
    code)."""
    mesh = make_mesh({"sp": 2}, [mesh_device] * 2)
    q = torch.zeros(1, 2, 8, 8, device=tensor_device)
    with pytest.raises(ValueError, match="mesh must hold"):
        ra.ring_attention(q, q, q, mesh)
    qs = q.reshape(2, 8, 8)
    with pytest.raises(ValueError, match="mesh must hold"):
        ra.ring_attention_fwd(qs, qs, qs, list(mesh.axis_devices("sp")))


def test_ring_runs_on_the_sp_axis_of_a_larger_mesh():
    """Under a dp x sp mesh the ring runs over the sp ranks of dp index 0
    (the dp positions hold replicas)."""
    mesh = make_mesh({"sp": 4, "dp": 2}, [CPU] * 8)
    assert mesh.axis_names == ("dp", "sp")
    assert mesh.shape == {"dp": 2, "sp": 4}
    assert len(mesh.axis_devices("sp")) == 4
    q, k, v = (torch.from_numpy(_rand((1, 2, 16, 8), i)) for i in range(3))
    got = ra.ring_attention(q, k, v, mesh, causal=True)
    want = fa.mha_reference(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **O_TOL)
