"""How the GEMM-core kernels round: the share of their outputs that differ
from the plain version's value, which way those lean, and a digest of each
output.

    python3 paddle_tpu_torch/tools/gemm_flips.py [--root DIR] [--json PATH]

Runs on the card, each case against its plain version on the same seeded
inputs:

- ``dense_epilogue``: K5 (``dense_act_fwd``, bf16 x and w) at the AMP
  path's shapes;
- ``conv1x1_stats_bf16``: the bf16 K3 (``conv1x1_stats_fwd``, bf16 x,
  float32 w) at ResNet-50's 15 conv1x1 shapes at batch 256;
- ``conv1x1_stats_f32``: the float32 K3 (float32 x and w) at the same 15
  shapes at batch 128 (the float32 ResNet-50 path's batch);
- ``matmul_bn_stats``: K6 at ``rn50_fused_bench``'s four calls' shapes
  (bf16; the second call of each stage normalizes its seeded x with x's
  own column statistics and a seeded gamma and beta, then relu, so every
  checkout gets the same inputs) and one float32 call with producer
  statistics and relu.

Each sums exact bf16 products in float32, in another order than the plain
version; an output that differs was rounded from a float32 sum on the other
side of a rounding boundary (bf16 outputs), or is another float32 sum
(float32 outputs).  About half of those lie nearer zero when the sums
differ only in order; more when the kernel's sums drift toward zero (the
tensor cores' float32 sums truncate).

The kernels come from the ``paddle_tpu_torch`` found under ``--root``
(default: the checkout holding this file), so one seeded run can be made
through another checkout's kernels, e.g. the parent commit's.  Run it as a
file, not with ``-m``, for that.  Each case also prints a digest of the
kernel's output: where two checkouts' digests agree, their kernels wrote
the same bits.  It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

#: (name, M, K, N, activation) of K5 at the AMP fused path
K5_CASES = (("[16384, 768] x [768, 3072] gelu", 16384, 768, 3072, "gelu"),
            ("[16384, 768] x [768, 3072] relu", 16384, 768, 3072, "relu"),
            ("M=4097 gelu", 4097, 768, 3072, "gelu"))
#: ResNet-50's conv1x1 shapes (Cin, Cout, H*W) at 224x224, at batch 256
K3_SHAPES = ((64, 64, 3136), (64, 256, 3136), (256, 64, 3136),
             (256, 128, 3136), (128, 512, 784), (256, 512, 784),
             (512, 128, 784), (512, 256, 784), (256, 1024, 196),
             (512, 1024, 196), (1024, 256, 196), (1024, 512, 196),
             (512, 2048, 49), (1024, 2048, 49), (2048, 512, 49))
K3_BATCH = 256
#: the float32 ResNet-50 path's batch
K3_F32_BATCH = 128
#: (name, M, K, N, x dtype, statistics and relu) of K6: rn50_fused_bench's
#: four calls at batch 256, then a float32 call with producer statistics
K6_CASES = (("stage0 call 1", 256 * 56 * 56, 256, 64, "bfloat16", False),
            ("stage0 call 2", 256 * 56 * 56, 64, 64, "bfloat16", True),
            ("stage1 call 1", 256 * 28 * 28, 512, 128, "bfloat16", False),
            ("stage1 call 2", 256 * 28 * 28, 128, 128, "bfloat16", True),
            ("float32 [65536, 256] x [256, 64]", 65536, 256, 64, "float32",
             True))
#: the kernels a run takes (chip_smoke.py's kernel phase runs the float32
#: K3's and K6's)
KERNELS = ("dense_epilogue", "conv1x1_stats_bf16", "conv1x1_stats_f32",
           "matmul_bn_stats")


def flips(got, ref):
    """``(n, toward, total)``: how many of the bf16 ``got`` differ from the
    bf16 ``ref``, how many of those lie nearer zero, and the count."""
    diff = got != ref
    toward = diff & (got.float().abs() < ref.float().abs())
    return int(diff.sum()), int(toward.sum()), got.numel()


def digest(t):
    """The first 12 hex digits of the SHA-1 of ``t``'s bytes: two runs'
    outputs are bit-identical where their digests agree."""
    import torch
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
    return hashlib.sha1(raw.numpy().tobytes()).hexdigest()[:12]


def run(root, kernels=KERNELS):
    """One line per case of each of ``kernels``; returns ``{case: {"n",
    "toward", "total", "digest"}}``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from paddle_tpu_torch.kernels import conv_bn as cb
    from paddle_tpu_torch.kernels import dense_epilogue as de
    if not torch.cuda.is_available():
        raise RuntimeError("gemm_flips: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = torch.bfloat16
    out = {}

    def report(name, got, ref):
        n, toward, total = flips(got, ref)
        out[name] = {"n": n, "toward": toward, "total": total,
                     "digest": digest(got)}
        print(f"{name}: {n} of {total} ({100 * n / total:.3f}%) differ from "
              f"the plain version's, {100 * toward / max(n, 1):.0f}% of them "
              f"nearer zero; y's digest {out[name]['digest']}", flush=True)

    if "dense_epilogue" in kernels:
        for i, (name, m, k, n, act) in enumerate(K5_CASES):
            g = torch.Generator(device="cuda").manual_seed(100 + i)
            x = torch.randn(m, k, device="cuda", generator=g).to(bf16)
            w = (torch.randn(k, n, device="cuda", generator=g)
                 * k ** -0.5).to(bf16)
            b = torch.randn(n, device="cuda", generator=g)
            report(f"dense_epilogue bf16 {name}",
                   de.dense_act_fwd(x, w, b, act),
                   de.dense_act_plain(x, w, b, act))
            del x, w
    for dtype, tag, batch, seed in ((bf16, "bf16", K3_BATCH, 200),
                                    (torch.float32, "f32", K3_F32_BATCH,
                                     300)):
        if f"conv1x1_stats_{tag}" not in kernels:
            continue
        for i, (ci, co, p) in enumerate(K3_SHAPES):
            g = torch.Generator(device="cuda").manual_seed(seed + i)
            x = torch.randn(batch, ci, p, device="cuda",
                            generator=g).to(dtype)
            w = torch.randn(co, ci, device="cuda", generator=g) * ci ** -0.5
            report(f"conv1x1_stats {tag} [{batch}, {ci}, {p}] x [{co}, {ci}]",
                   cb.conv1x1_stats_fwd(x, w)[0],
                   cb.conv1x1_stats_plain(x, w)[0])
            del x, w
            torch.cuda.empty_cache()
    if "matmul_bn_stats" in kernels:
        for i, (name, m, k, n, dt, norm) in enumerate(K6_CASES):
            g = torch.Generator(device="cuda").manual_seed(400 + i)
            x = (torch.randn(m, k, device="cuda", generator=g)
                 * 0.5).to(getattr(torch, dt))
            w = (torch.randn(k, n, device="cuda", generator=g)
                 * 0.05).to(bf16)
            ps = None
            if norm:
                # the statistics of x as a first call's plain version gives
                # them: the same inputs in every checkout
                xf = x.float()
                mu = xf.mean(dim=0)
                inv = torch.rsqrt((xf * xf).mean(dim=0) - mu * mu + 1e-5)
                ps = (mu, inv, 1 + 0.1 * torch.randn(k, device="cuda",
                                                     generator=g),
                      0.1 * torch.randn(k, device="cuda", generator=g))
                del xf
            report(f"matmul_bn_stats {dt} {name} [{m}, {k}] x [{k}, {n}]"
                   + (" normalize + relu" if norm else ""),
                   cb.matmul_bn_stats_fwd(x, w, ps, relu=norm)[0],
                   cb.matmul_bn_stats_plain(x, w, ps, relu=norm)[0])
            del x, w
            torch.cuda.empty_cache()
    n = sum(v["n"] for v in out.values())
    toward = sum(v["toward"] for v in out.values())
    print(f"all cases: {n} of {sum(v['total'] for v in out.values())} "
          f"differ, {100 * toward / max(n, 1):.1f}% of them nearer zero "
          f"(kernels of {os.path.dirname(cb.__file__)}, "
          f"{torch.cuda.get_device_name(0)})", flush=True)
    return out


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose paddle_tpu_torch runs")
    ap.add_argument("--json", help="also write the counts here")
    args = ap.parse_args(argv)
    out = run(args.root)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
