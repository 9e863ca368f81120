"""K8 (the attention skeletons) against the JAX package, on the CPU.

- ``attn_skeleton_fwd_plain`` and ``attn_skeleton_bwd_plain`` (the plain
  versions the CPU path and ``chip_smoke.py`` use) against the reference's
  Pallas skeletons ``_fwd_skeleton`` and ``_bwd_skeleton`` of
  ``tools/attn_shape_ceiling.py``, run under ``pltpu.
  force_tpu_interpret_mode()``, for d 64 and 128 and several
  ``block_q``/``block_k`` pairs (the reference's ``block_k`` may be any
  divisor of T; the partials depend on ``block_q`` only).  Both sum float32
  products in other orders: o and dq within 2^-20 of the sum of their
  terms' magnitudes (|q||k||v| for o, |q||k||do||v||k| for dq), the dk/dv
  partials likewise (|q||k||do||v||q| and |q||k||do|), plus 1e-6.
- the wrappers' contract: blocks that are not multiples of 64 dividing T,
  a d above 128, other dtypes and shapes raise; CPU tensors take the plain
  versions and count no launch.
- the shared memory a block of each kernel takes (``shared_bytes``, the
  source's layouts: the forward, the backward at block_q 64 and above),
  within the 227 KB an H100 block may use at every d from 1 to 128.
- the kernels' arithmetic emulated on the CPU (each float32 operand and
  each product that feeds another split into three bf16 terms, every
  product as the six term products of weight 2^-16 and above in two
  chains, hi.hi and the lower five, each 64-key or 64-query tile's product
  joined to its sum by float32 adds) against the reference skeletons,
  within the same 2^-20 of the terms' magnitudes, on inputs whose rows are
  scaled by 2^-8..2^8; with two terms in place of three it misses that
  bound.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu_torch.kernels import attn_skeleton as sk
from _port_fixtures import collect_garbage_after_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUM_RTOL, ATOL = 2.0 ** -20, 1e-6


def _load_reference():
    tools = os.path.join(REPO, "tools")
    spec = importlib.util.spec_from_file_location(
        "_ref_attn_shape_ceiling", os.path.join(tools, "attn_shape_ceiling.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, tools)           # it imports tools/_tpu_timing.py
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(tools)
    return mod


ref = _load_reference()


def _inputs(bh, t, d, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(bh, t, d) * 0.5).astype(np.float32) for _ in range(4)]


def _within(got, want, terms, what):
    err = np.abs(got.numpy() - np.asarray(want))
    bound = ATOL + SUM_RTOL * terms
    assert (err <= bound).all(), (what, float(err.max()),
                                  float((err / bound).max()))


@pytest.mark.parametrize("t,d,bq,bk", [(128, 64, 64, 64), (128, 64, 64, 32),
                                       (128, 128, 128, 64),
                                       (256, 64, 128, 256),
                                       (256, 128, 64, 128)])
def test_forward_matches_reference_skeleton(t, d, bq, bk):
    bh = 2
    q, k, v, _ = _inputs(bh, t, d, seed=t + d + bq)
    with pltpu.force_tpu_interpret_mode():
        want = ref._fwd_skeleton(bh, t, d, bq, bk)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    if bq % 64 == 0 and bk % 64 == 0:
        got = sk.attn_skeleton_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                   block_q=bq, block_k=bk)
    else:
        got = sk.attn_skeleton_fwd_plain(
            *(torch.from_numpy(a) for a in (q, k, v)))
    terms = (np.abs(q) @ np.abs(k).transpose(0, 2, 1)) @ np.abs(v)
    _within(got, want, terms, "o")


@pytest.mark.parametrize("t,d,bq,bk", [(128, 64, 64, 64), (128, 64, 64, 32),
                                       (128, 128, 128, 64),
                                       (256, 64, 128, 256),
                                       (256, 128, 64, 128)])
def test_backward_matches_reference_skeleton(t, d, bq, bk):
    bh = 2
    q, k, v, do = _inputs(bh, t, d, seed=t + d + bk)
    with pltpu.force_tpu_interpret_mode():
        want = ref._bwd_skeleton(bh, t, d, bq, bk)(
            *(jnp.asarray(a) for a in (q, k, v, do)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    if bk % 64 == 0:
        got = sk.attn_skeleton_bwd(tq, tk, tv, tdo, block_q=bq, block_k=bk)
    else:
        got = sk.attn_skeleton_bwd_plain(tq, tk, tv, tdo, bq)
    nq = t // bq
    assert got[1].shape == got[2].shape == (bh, nq, t, d)
    s_abs = np.abs(q) @ np.abs(k).transpose(0, 2, 1)
    ds_abs = s_abs * (np.abs(do) @ np.abs(v).transpose(0, 2, 1))

    def per_block(a, x):
        return (a.reshape(bh, nq, bq, t).transpose(0, 1, 3, 2)
                @ np.abs(x).reshape(bh, nq, bq, d))

    _within(got[0], want[0], ds_abs @ np.abs(k), "dq")
    _within(got[1], want[1], per_block(ds_abs, q), "dkp")
    _within(got[2], want[2], per_block(s_abs, do), "dvp")


def test_partials_sum_to_the_full_gradients():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 256, 32, seed=3))
    full = sk.attn_skeleton_bwd(q, k, v, do, block_q=256)
    for bq in (64, 128):
        dq, dkp, dvp = sk.attn_skeleton_bwd(q, k, v, do, block_q=bq)
        torch.testing.assert_close(dq, full[0])
        torch.testing.assert_close(dkp.sum(dim=1), full[1][:, 0],
                                   rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(dvp.sum(dim=1), full[2][:, 0],
                                   rtol=1e-5, atol=1e-4)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 128, 16, seed=5))
    sk.reset_launch_count()
    assert torch.equal(sk.attn_skeleton_fwd(q, k, v),
                       sk.attn_skeleton_fwd_plain(q, k, v))
    for a, b in zip(sk.attn_skeleton_bwd(q, k, v, do, 64),
                    sk.attn_skeleton_bwd_plain(q, k, v, do, 64)):
        assert torch.equal(a, b)
    assert sk.launch_count("attn_skeleton_fwd") == 0
    assert sk.launch_count("attn_skeleton_bwd") == 0


@pytest.mark.parametrize("case", ["block_q_32", "block_q_not_dividing",
                                  "block_k_96", "d_over_128", "dtype",
                                  "shapes_differ", "rank"])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case, which):
    t, d, bq, bk = 192, 64, 64, 64
    shapes = [(2, t, d)] * 4
    dtype = torch.float32
    if case == "block_q_32":
        bq = 32
    elif case == "block_q_not_dividing":
        bq = 128
    elif case == "block_k_96":
        bk = 96
    elif case == "d_over_128":
        shapes = [(2, t, 136)] * 4
    elif case == "dtype":
        dtype = torch.float64
    elif case == "shapes_differ":
        shapes = [(2, t, d), (2, 128, d), (2, t, d), (2, t, d)]
    else:
        shapes = [(t, d)] * 4
    q, k, v, do = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises((TypeError, ValueError)):
        if which == "fwd":
            sk.attn_skeleton_fwd(q, k, v, block_q=bq, block_k=bk)
        else:
            sk.attn_skeleton_bwd(q, k, v, do, block_q=bq, block_k=bk)


# (key of shared_bytes, block_q) -> bytes at d <= 64 and d <= 128, as
# csrc/attn_skeleton_sm90.cu lays them out (the card test holds the
# source's own numbers to shared_bytes)
SMEM_LAYOUTS = {"fwd": (("fwd", 64), (148544, 197696)),
                "bwd_block_q_64": (("bwd", 64), (197696, 222272)),
                "bwd_block_q_128": (("bwd", 128), (173120, 222272))}


@pytest.mark.parametrize("layout", sorted(SMEM_LAYOUTS))
def test_shared_memory_fits_a_block_at_every_head_dim(layout):
    (key, bq), (at64, at128) = SMEM_LAYOUTS[layout]
    sizes = {d: sk.shared_bytes(d, bq)[key] for d in range(1, 129)}
    assert max(sizes.values()) <= sk.MAX_SHARED_BYTES == 232448
    assert {sizes[d] for d in range(1, 65)} == {at64}
    assert {sizes[d] for d in range(65, 129)} == {at128}


def _terms(x, n=3):
    """The first ``n`` bf16 terms of float32 ``x``, as float32 tensors
    (three sum to x exactly)."""
    out = []
    for _ in range(n):
        t = x.to(torch.bfloat16).float()
        out.append(t)
        x = x - t
    return out


# the term pairs of a float32-exact product: hi.hi, then the lower five
# (hi.mid, mid.hi, hi.lo, mid.mid, lo.hi); with two terms, the products of
# hi and mid
_PAIRS = {3: ((0, 1), (1, 0), (0, 2), (1, 1), (2, 0)),
          2: ((0, 1), (1, 0), (1, 1))}


def _emulated(a, b, n):
    """a @ b as the kernels issue it: the hi.hi chain and the lower
    products' chain, each from zero, joined by one float32 add."""
    ta, tb = _terms(a, n), _terms(b, n)
    lo = sum(ta[i] @ tb[j] for i, j in _PAIRS[n])
    return ta[0] @ tb[0] + lo


def _emulated_skeletons(q, k, v, do, block_q, n=3):
    """o, dq, dkp, dvp with the kernels' tiling: 64-key tiles joined to o
    and dq, 64-query sub-tiles joined to a block's partials, in order."""
    bh, t, d = q.shape
    o, dq = torch.zeros_like(q), torch.zeros_like(q)
    dkp = torch.zeros(bh, t // block_q, t, d)
    dvp = torch.zeros_like(dkp)
    for j in range(0, t, 64):
        kj, vj = k[:, j:j + 64], v[:, j:j + 64]
        for i in range(0, t, 64):
            qi, oi = q[:, i:i + 64], do[:, i:i + 64]
            s = _emulated(qi, kj.transpose(1, 2), n)
            o[:, i:i + 64] += _emulated(s, vj, n)
            ds = s * _emulated(oi, vj.transpose(1, 2), n)
            dq[:, i:i + 64] += _emulated(ds, kj, n)
            dvp[:, i // block_q, j:j + 64] += _emulated(s.transpose(1, 2),
                                                        oi, n)
            dkp[:, i // block_q, j:j + 64] += _emulated(ds.transpose(1, 2),
                                                        qi, n)
    return o, dq, dkp, dvp


def _high_range_inputs(bh, t, d, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(bh, t, d) * 2.0 ** rng.randint(-8, 9, (bh, t, 1))
             ).astype(np.float32) for _ in range(4)]


def _reference_skeletons(q, k, v, do, block_q):
    bh, t, d = q.shape
    with pltpu.force_tpu_interpret_mode():
        o = ref._fwd_skeleton(bh, t, d, block_q, 64)(
            *(jnp.asarray(a) for a in (q, k, v)))
        grads = ref._bwd_skeleton(bh, t, d, block_q, 64)(
            *(jnp.asarray(a) for a in (q, k, v, do)))
    return (o,) + tuple(grads)


def _terms_of_skeletons(q, k, v, do, block_q):
    bh, t, d = q.shape
    nq = t // block_q
    s_abs = np.abs(q) @ np.abs(k).transpose(0, 2, 1)
    ds_abs = s_abs * (np.abs(do) @ np.abs(v).transpose(0, 2, 1))

    def per_block(a, x):
        return (a.reshape(bh, nq, block_q, t).transpose(0, 1, 3, 2)
                @ np.abs(x).reshape(bh, nq, block_q, d))

    return (s_abs @ np.abs(v), ds_abs @ np.abs(k), per_block(ds_abs, q),
            per_block(s_abs, do))


@pytest.mark.parametrize("block_q", [64, 128])
def test_kernel_arithmetic_holds_the_bound_on_high_range_inputs(block_q):
    q, k, v, do = _high_range_inputs(2, 256, 64, seed=block_q)
    want = _reference_skeletons(q, k, v, do, block_q)
    got = _emulated_skeletons(*(torch.from_numpy(a) for a in (q, k, v, do)),
                              block_q)
    for g, w, terms, what in zip(got, want, _terms_of_skeletons(
            q, k, v, do, block_q), ("o", "dq", "dkp", "dvp")):
        _within(g, w, terms, what)


def test_two_terms_miss_the_bound():
    q, k, v, do = _high_range_inputs(2, 128, 64, seed=2)
    want = _reference_skeletons(q, k, v, do, 64)
    got = _emulated_skeletons(*(torch.from_numpy(a) for a in (q, k, v, do)),
                              64, n=2)
    terms = _terms_of_skeletons(q, k, v, do, 64)
    over = [float((np.abs(g.numpy() - np.asarray(w))
                   / (ATOL + SUM_RTOL * t)).max())
            for g, w, t in zip(got, want, terms)]
    assert max(over) > 1, over
