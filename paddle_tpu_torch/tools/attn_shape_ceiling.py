"""Per-shape ceiling of the flash-attention kernels on the card, from
skeleton kernels (K8): the flash forward minus the softmax (the q·kᵀ and
s·v products, S kept on chip, no [T, T] traffic) and the combined backward
minus the softmax (the same five products and the real dk/dv partial
writes).  A skeleton does the real kernel's products and unavoidable memory
movement and nothing else, so

    real kernel / skeleton

is the share of the softmax and its bookkeeping, and ``flops / skeleton
time`` the rate the shape allows on this design.  The skeletons run in the
float32 K1/K2's arithmetic on the tensor cores (each operand split into
three bf16 term planes by a split pass that is part of the launch, as it is
of K1's and K2's; every float32 product as six bf16 term products), so both
ratios are at least 1 where the skeleton is the ceiling it should be.  The
split pass reads the operands and writes their planes: 94 MB for the
forward and 126 MB for the backward at [24, 2048, 64], at least 0.028 and
0.038 ms at an H100's 3.35 TB/s, about a tenth of the forward skeleton's
time and a twentieth of the backward's (PERF.md).

``fill_ratio`` is t(d = 128) / (2 t(d = 64)) of the forward skeleton.  On
a TPU it tested whether d = 64 fills only half of the 128-lane matrix unit
(a ratio near 0.5).  On Hopper each ``wgmma`` reads whole 64-column panels
of the head dim, so d = 128 is twice the products of d = 64 on the same
tiles; the probe reports what it measures.

``fb_vs_skel`` sets K1 + K2 (through ``flash_attention`` with autograd)
against the forward skeleton plus the backward skeleton.  The port's K2
runs two passes (dK/dV, then dQ) that both recompute S and dP, 14*d flops a
(q, k) pair, while the backward skeleton does the TPU combined kernel's
10*d in one pass and writes its partials instead.

Timing: CUDA events around a plain loop of calls, the slope over two
iteration counts, each the minimum over repetitions (:mod:`.timing`).
MFU is against the card's rate for float32-exact products as bf16 term
products on the tensor cores (``timing.f32_split_flops``: the bf16 peak
/ 6).

    python -m paddle_tpu_torch.tools.attn_shape_ceiling [--quick] [--t T]

runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..kernels import attn_skeleton as sk
from ..kernels import flash_attention as fa
from . import timing

#: (T, bh) at d = 64
CASES = ((2048, 24), (8192, 6), (16384, 2))
PEAK_KIND = "float32 as 6 bf16 term products on the tensor cores"
FB_NOTE = ("K1 + K2: K2 runs two passes that recompute S and dP (14*d flops "
           "a pair); the backward skeleton runs the combined kernel's 10*d "
           "in one pass and writes per-q-block dk/dv partials")


def analyse(out, peak):
    """Adds the rates and ratios to a report holding ``T``, ``bh``, ``d``
    and the times ``fwd_skel_ms``, ``fwd_skel_d128_ms``, ``bwd_skel_ms``,
    ``flash_fwd_ms``, ``flash_fwd_bwd_ms``."""
    t, bh, d = out["T"], out["bh"], out["d"]
    f_fwd = 4.0 * bh * t * t * d                  # QK + PV, 2 flops an FMA
    f_bwd = 10.0 * bh * t * t * d                 # 5 products
    fwd_skel, bwd_skel = out["fwd_skel_ms"], out["bwd_skel_ms"]
    out["peak"] = {"kind": PEAK_KIND, "flops": peak}
    out["fwd_skel_mfu"] = f_fwd / (fwd_skel / 1e3) / peak * 100
    out["bwd_skel_mfu"] = f_bwd / (bwd_skel / 1e3) / peak * 100
    out["fill_ratio"] = out["fwd_skel_d128_ms"] / (2 * fwd_skel)
    out["fwd_vs_skel"] = out["flash_fwd_ms"] / fwd_skel
    out["fb_vs_skel"] = out["flash_fwd_bwd_ms"] / (fwd_skel + bwd_skel)
    out["fb_vs_skel_note"] = FB_NOTE
    return out


def probe(t, bh, d=64, device=None, iters=(8, 40), reps=3):
    """Times the skeletons (d and 2d forward, d backward) and the real
    kernels at ``[bh, t, d]``; returns the report (also printed)."""
    if device is None:
        device = torch.device("cuda")
    if device.type != "cuda":
        raise RuntimeError(f"attn_shape_ceiling: times the card, got "
                           f"{device}")
    # K1/K2's tiles, for the forward and the backward skeleton alike
    bq, bk = min(fa.BLOCK_Q, t), min(fa.BLOCK_K, t)
    # the backward's two partials, and at most 16 float32 [bh, T, d]
    # tensors live besides them (inputs, outputs, the d = 128 set)
    need = 2 * bh * (t // bq) * t * d * 4 + 16 * bh * t * d * 4
    free, _ = torch.cuda.mem_get_info(device)
    if need > free:
        raise RuntimeError(f"attn_shape_ceiling: T={t} bh={bh} d={d} needs "
                           f"{need / 1e9:.2f} GB, {free / 1e9:.2f} GB free")
    rng = np.random.RandomState(0)

    def mk(dd):
        return tuple(torch.from_numpy(rng.randn(bh, t, dd).astype(np.float32)
                                      * 0.1).to(device) for _ in range(4))

    q, k, v, do = mk(d)
    out = {"T": t, "bh": bh, "d": d, "device": torch.cuda.get_device_name(
        device), "fwd_blocks": [bq, bk], "bwd_blocks": [bq, bk]}

    def slope_ms(fn, *args):
        return timing.time_fn_slope(fn, *args, iters=iters, reps=reps) * 1e3

    out["fwd_skel_ms"] = slope_ms(sk.attn_skeleton_fwd, q, k, v, bq, bk)
    q2, k2, v2, _ = mk(2 * d)
    out["fwd_skel_d128_ms"] = slope_ms(sk.attn_skeleton_fwd, q2, k2, v2, bq,
                                       bk)
    del q2, k2, v2
    out["bwd_skel_ms"] = slope_ms(sk.attn_skeleton_bwd, q, k, v, do, bq, bk)

    # the real kernels: K1, and K1 + K2 through autograd
    q4, k4, v4 = (a.view(1, bh, t, d) for a in (q, k, v))
    out["flash_fwd_ms"] = slope_ms(fa.flash_attention, q4, k4, v4)
    leaves = [a.detach().requires_grad_(True) for a in (q4, k4, v4)]

    def fwd_bwd():
        with torch.enable_grad():
            o = fa.flash_attention(*leaves)
            return torch.autograd.grad(o.sum(), leaves)

    out["flash_fwd_bwd_ms"] = slope_ms(fwd_bwd)
    analyse(out, timing.f32_split_flops(out["device"]))
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="only the (8192, 6) case")
    ap.add_argument("--t", type=int, help="only the case of this T")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("attn_shape_ceiling: no CUDA device")
    cases = [(8192, 6)] if args.quick else list(CASES)
    if args.t is not None:
        cases = [c for c in cases if c[0] == args.t]
    reports = [probe(t, bh) for t, bh in cases]
    print(json.dumps(reports))
    return reports


if __name__ == "__main__":
    main()
