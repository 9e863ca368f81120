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
