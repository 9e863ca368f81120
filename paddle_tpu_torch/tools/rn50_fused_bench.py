"""Fused matmul + BN statistics (K6) against the library composition, at
the ResNet-50 bandwidth-bound stage shapes.  It measures the forward
bottleneck-1x1 pattern:

    y1, s, s2 = matmul_bn_stats(x, w1)                     # K6 + BN stats
    y2 = matmul_bn_stats(y1, w2, (mu, inv, g1, b1), relu)  # fold normalize

against the library chain: a bf16 ``torch.matmul``, the batch statistics
in float32 (two reductions), the normalize + relu, and a second bf16
``torch.matmul``.  Both read and write the same logical tensors; the fused
chain saves the statistics pass and the normalize's round trip.  Each shape
checks parity first (the chains' sums, relative), then times both chains
on the card with CUDA events (:func:`.timing.time_fn_slope`: the slope
between 8 and 40 calls, each the minimum of 3, so a pause of the host in
one measurement does not count).

    python -m paddle_tpu_torch.tools.rn50_fused_bench

runs on the card and raises without one.  :func:`main` prints one line per
shape and returns ``{shape name: numbers}``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import conv_bn as cb
from . import timing

EPS = 1e-5
#: (name, M = N*H*W, Cin, Cmid) at batch 256: stage 0 (56x56, 64 channels)
#: and stage 1 (28x28, 128 channels)
SHAPES = (("stage0_56x56", 256 * 56 * 56, 256, 64),
          ("stage1_28x28", 256 * 28 * 28, 512, 128))
#: K6 launches of one shape in :func:`main`: two a fused chain, for the
#: parity check and each of ``time_fn_slope``'s calls
K6_LAUNCHES_PER_SHAPE = 2 * (1 + timing.slope_calls())


def make_inputs(m, cin, cmid, rng, device):
    """``(x, w1, w2, g1, b1)``: x and the weights drawn from ``rng`` in
    float32 (in this order), rounded to bf16 on ``device``; gamma 1, beta
    0."""
    def bf16(a):
        return torch.from_numpy(a).to(device).to(torch.bfloat16)
    x = bf16(rng.randn(m, cin).astype(np.float32) * 0.5)
    w1 = bf16(rng.randn(cin, cmid).astype(np.float32) * 0.05)
    w2 = bf16(rng.randn(cmid, cmid).astype(np.float32) * 0.05)
    g1 = torch.ones(cmid, dtype=torch.float32, device=device)
    b1 = torch.zeros(cmid, dtype=torch.float32, device=device)
    return x, w1, w2, g1, b1


def library_chain(x, w1, w2, g1, b1):
    """The separate passes: bf16 matmul, float32 batch statistics,
    normalize + relu, bf16 matmul; the float32 sum of the output."""
    y1 = torch.matmul(x, w1).float()
    mu = y1.mean(dim=0)
    var = (y1 * y1).mean(dim=0) - mu * mu
    inv = torch.rsqrt(var + EPS)
    y1n = torch.relu((y1 - mu) * inv * g1 + b1)
    y2 = torch.matmul(y1n.to(torch.bfloat16), w2)
    return y2.float().sum()


def fused_chain(x, w1, w2, g1, b1):
    """Two K6 calls, the normalize + relu folded into the second's read;
    the float32 sum of the output."""
    m = x.shape[0]
    y1, s, s2 = cb.matmul_bn_stats_fwd(x, w1, None, relu=False)
    mu = s / m
    var = s2 / m - mu * mu
    inv = torch.rsqrt(var + EPS)
    y2, _, _ = cb.matmul_bn_stats_fwd(y1, w2, (mu, inv, g1, b1), relu=True)
    return y2.float().sum()


def run_shape(name, m, cin, cmid, rng, device):
    """Parity, then the two chains' times, at one shape."""
    args = make_inputs(m, cin, cmid, rng, device)
    a = float(library_chain(*args))
    n0 = cb.launch_count("matmul_bn_stats")
    b = float(fused_chain(*args))
    launches = cb.launch_count("matmul_bn_stats") - n0
    rel = abs(a - b) / max(abs(a), 1.0)
    lib_ms = timing.time_fn_slope(library_chain, *args) * 1e3
    fused_ms = timing.time_fn_slope(fused_chain, *args) * 1e3
    gb = (m * cin * 2 + m * cmid * 2 * 2 + m * cmid * 2) / 1e9
    print(f"{name}: library {lib_ms:7.3f} ms | fused {fused_ms:7.3f} ms | "
          f"speedup {lib_ms / fused_ms:5.2f}x | rel-err {rel:.2e} | "
          f"~{gb:.1f} GB logical | K6 launches per fused chain {launches}",
          flush=True)
    return {"library_ms": lib_ms, "fused_ms": fused_ms,
            "speedup": lib_ms / fused_ms, "rel_err": rel,
            "library_sum": a, "fused_sum": b, "fused_launches": launches,
            "logical_gb": gb}


def main(shapes=SHAPES, device=None):
    """Every shape of ``shapes`` on ``device`` (default ``cuda``), with one
    seed-0 numpy stream across them; raises without a CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("rn50_fused_bench: no CUDA device")
        device = torch.device("cuda")
    rng = np.random.RandomState(0)
    return {name: run_shape(name, m, cin, cmid, rng, device)
            for name, m, cin, cmid in shapes}


if __name__ == "__main__":
    main()
