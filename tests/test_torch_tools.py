"""The port's measurement tools (``paddle_tpu_torch.tools``) on the CPU.

- ``rn50_fused_bench``: at a tiny M, with the tool's own seed-0 inputs, the
  fused chain (two K6 calls through their plain versions) against the same
  two-call chain built from the JAX ``matmul_bn_stats(interpret=True)``
  under ``jax.disable_jit()``, and the library chain against the
  reference's ``xla_chain`` math (``tools/rn50_fused_bench.py:48-55``),
  also under ``disable_jit`` (jitted on the CPU, XLA drops the bf16
  rounding of a bf16 product).  The chains' float32 sums agree to 1e-5
  relative: the same operations in float32, bf16 products summed in other
  orders, and a bf16 rounding that can land on the neighbouring value.
- ``timing``: the peak table by card name, an unknown card raises, and
  every timer raises without a CUDA device (as do both tools' entry points).
- ``attn_shape_ceiling.analyse``: MFU, ``fill_ratio`` and the two ratios on
  given times.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.tools import attn_shape_ceiling as asc
from paddle_tpu_torch.tools import rn50_fused_bench as rfb
from paddle_tpu_torch.tools import timing

ref_cb = importlib.import_module("paddle_tpu.pallas.conv_bn")

SUM_RTOL = 1e-5
TINY = (("tiny_a", 512, 64, 16), ("tiny_b", 256, 32, 32))


def _jax_chains(x, w1, w2, g1, b1, eps=rfb.EPS):
    m = x.shape[0]

    def xla_chain(x, w1, w2, g1, b1):
        y1 = (x @ w1).astype(jnp.float32)
        mu = jnp.mean(y1, axis=0)
        var = jnp.mean(jnp.square(y1), axis=0) - mu * mu
        inv = jax.lax.rsqrt(var + eps)
        y1n = jnp.maximum((y1 - mu) * inv * g1 + b1, 0.0)
        y2 = y1n.astype(jnp.bfloat16) @ w2
        return y2.astype(jnp.float32).sum()

    def fused_chain(x, w1, w2, g1, b1):
        y1, s, s2 = ref_cb.matmul_bn_stats(x, w1, None, relu=False,
                                           interpret=True)
        mu = s / m
        var = s2 / m - mu * mu
        inv = jax.lax.rsqrt(var + eps)
        y2, _, _ = ref_cb.matmul_bn_stats(y1, w2, (mu, inv, g1, b1),
                                          relu=True, interpret=True)
        return y2.astype(jnp.float32).sum()

    args = [jnp.asarray(a.float().numpy()) for a in (x, w1, w2, g1, b1)]
    for i in range(3):
        args[i] = args[i].astype(jnp.bfloat16)
    with jax.disable_jit():
        return float(xla_chain(*args)), float(fused_chain(*args))


@pytest.mark.parametrize("shape", TINY, ids=[s[0] for s in TINY])
def test_chains_match_the_reference_chains(shape):
    name, m, cin, cmid = shape
    rng = np.random.RandomState(0)
    args = rfb.make_inputs(m, cin, cmid, rng, torch.device("cpu"))
    assert [a.dtype for a in args] == [torch.bfloat16] * 3 + \
        [torch.float32] * 2
    want_lib, want_fused = _jax_chains(*args)
    got_lib = float(rfb.library_chain(*args))
    got_fused = float(rfb.fused_chain(*args))
    assert abs(got_lib - want_lib) <= SUM_RTOL * abs(want_lib)
    assert abs(got_fused - want_fused) <= SUM_RTOL * abs(want_fused)
    # the two chains compute the same function
    assert abs(got_fused - got_lib) <= 2.0 ** -7 * abs(got_lib)


def test_make_inputs_follows_the_reference_stream():
    """x, w1, w2 from one RandomState in the reference's order."""
    rng = np.random.RandomState(0)
    x, w1, w2, g1, b1 = rfb.make_inputs(8, 4, 2, rng, torch.device("cpu"))
    ref = np.random.RandomState(0)
    want = [ref.randn(8, 4).astype(np.float32) * 0.5,
            ref.randn(4, 2).astype(np.float32) * 0.05,
            ref.randn(2, 2).astype(np.float32) * 0.05]
    for got, w in zip((x, w1, w2), want):
        assert torch.equal(got, torch.from_numpy(w).to(torch.bfloat16))
    assert torch.equal(g1, torch.ones(2)) and torch.equal(b1, torch.zeros(2))


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (67e12, 989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (51e12, 756e12, 2.0e12)),
    ("NVIDIA H100 NVL", (60e12, 835e12, 3.9e12)),
    ("NVIDIA H200", (67e12, 989e12, 4.8e12))])
def test_peak_table(name, want):
    assert timing.peaks(name) == want


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "cpu", ""])
def test_unknown_card_raises(name):
    with pytest.raises(RuntimeError, match="no peak table entry"):
        timing.peaks(name)


@pytest.mark.parametrize("call", ["time_fn", "time_fn_slope", "time_held",
                                  "rn50_main", "ceiling_main",
                                  "ceiling_probe_cpu"])
def test_timing_and_tools_raise_without_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        if call == "time_fn":
            timing.time_fn(torch.zeros, 4)
        elif call == "time_fn_slope":
            timing.time_fn_slope(torch.zeros, 4)
        elif call == "time_held":
            timing.time_held(torch.zeros, 4)
        elif call == "rn50_main":
            rfb.main(shapes=TINY)
        elif call == "ceiling_main":
            asc.main(["--quick"])
        else:
            asc.probe(128, 2, device=torch.device("cpu"))


def test_rn50_main_on_the_cpu_stops_at_the_timing(monkeypatch):
    """Parity runs on the given device; the timing needs the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rfb.main(shapes=TINY[:1], device=torch.device("cpu"))


def test_slope_calls_count_what_time_fn_slope_runs():
    """The launch counts the tools' callers expect come from these."""
    assert timing.slope_calls() == 1 + 3 * (8 + 40)
    assert timing.slope_calls((1, 2), 1) == 4
    assert rfb.K6_LAUNCHES_PER_SHAPE == 2 * (1 + timing.slope_calls())


def test_slope_iters_must_grow():
    with pytest.raises(ValueError, match="0 < lo < hi"):
        timing.time_fn_slope(torch.zeros, 4, iters=(8, 8))


def test_ceiling_analysis_arithmetic():
    out = {"T": 2048, "bh": 24, "d": 64, "fwd_skel_ms": 1.0,
           "fwd_skel_d128_ms": 2.2, "bwd_skel_ms": 3.0, "flash_fwd_ms": 2.5,
           "flash_fwd_bwd_ms": 10.0}
    asc.analyse(out, 67e12)
    f_fwd = 4.0 * 24 * 2048 ** 2 * 64
    assert out["fwd_skel_mfu"] == pytest.approx(f_fwd / 1e-3 / 67e12 * 100)
    assert out["bwd_skel_mfu"] == pytest.approx(2.5 * f_fwd / 3e-3 / 67e12
                                                * 100)
    assert out["fill_ratio"] == pytest.approx(1.1)
    assert out["fwd_vs_skel"] == pytest.approx(2.5)
    assert out["fb_vs_skel"] == pytest.approx(2.5)
    assert out["peak"] == {"kind": asc.PEAK_KIND, "flops": 67e12}
    assert "14*d" in out["fb_vs_skel_note"]


def test_ceiling_cases_and_blocks_come_from_the_port():
    from paddle_tpu_torch.kernels import flash_attention as fa
    assert asc.CASES == ((2048, 24), (8192, 6), (16384, 2))
    assert fa.BLOCK_Q == fa.BLOCK_K == 64
