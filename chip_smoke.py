#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--profile]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(``/usr/local/cuda``).  It imports only the port, never ``paddle_tpu`` or
JAX, prints one line per phase, and raises on any failure:

1. ``env``    — the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, and the nvcc build of every kernel from ``csrc/``.
2. ``kernel`` — each hand-written kernel against its plain PyTorch version
   on the card, at the shapes of the main paths and at the edge cases,
   float32 with TF32 off: ``|kernel - plain| <= ATOL + RTOL * |plain|``
   (plus, for the bf16 products of K3 and K5, 2^-20 of the sum of the
   terms' magnitudes, and for the column sums of K3 and K4's backward,
   2^-14 of theirs).
3. ``serve``  — the GPT causal LM at BERT-base width (vocab 30522, d 768,
   12 layers, 12 heads, d_inner 3072, max_pos 2048, random weights from a
   seed) behind ``InferenceServer`` with buckets (512, 1024, 2048) and
   ``max_batch`` 8: warmup, then 24 requests of 300-2048 tokens from two
   tenants.  Each bucket's program goes through ``CompiledProgram.
   _optimized`` (the verifier, dead-op elimination, the fusion pass:
   12 ``fused_dense_act`` at default flags, without the kernel).  Every
   result must be finite ``[len, 30522]`` logits, the flash forward must
   have launched 12 times per batch dispatched to a bucket >= 1024 (and
   nowhere else), and one 1100-token request must match the same bucket
   program run by the port on the CPU.
4. ``train``  — the same model trained through the Fluid entry points
   (``build_gpt_pretrain`` with the fused head, ``AdamOptimizer.minimize``,
   ``Executor().run``) at seq 2048, batch 8, float32: one warm-up step and
   5 timed steps on one fixed batch.  The executor's fusion pass rewrites
   the 12 FFN chains into ``fused_dense_act`` (float32, no kernel at
   default flags).  The losses must be finite and fall,
   and every step must launch the flash forward and the flash backward 12
   times each.  Then a 2-layer, batch-1, seq-1024 step on the card must
   match the same step run by the port on the CPU.
5. ``resnet`` — ResNet-50 (1000 classes, 3x224x224, depth 50, random
   weights from a seed) trained through ``build_resnet_train``,
   ``MomentumOptimizer(0.1, 0.9).minimize`` and ``Executor().run`` at batch
   128, float32, TF32 off: the executor's fusion pass rewrites the 36
   conv1x1 + batch_norm pairs into ``fused_conv1x1_bn``, so every step must
   launch K3 36 times; one warm-up step and 5 timed steps on one fixed
   batch, with finite, falling losses.  Then one step on the card against
   the same step on the host: fused (the card rounds K3's operands to
   bf16, the host multiplies in float32) on a toy of two bottleneck blocks
   (loss within 2^-6) and at depth 50, 3x64x64, batch 8 (within 2^-3), and
   unfused (``FLAGS_graph_fusion`` off, float32 on both sides) at depth 50
   (loss 1e-4, BN running statistics 2^-10 and classifier gradients 2^-8
   of their largest magnitude).
6. ``fused_train`` — the GPT of ``train`` (the same program, batch and
   seeds) with the fusion autotuner on (``FLAGS_fusion_autotune``, rank
   threshold 0, verdicts cached in a fresh temporary directory): the plan
   must hold 12 ``fused_dense_act`` and 1 ``fused_embedding_layer_norm``
   with ``use_pallas`` set, and their grads (24 ``layer_norm`` left of 25);
   every autotune verdict must be a win.  One warm-up step (which also
   times the autotuner's candidates) and 5 timed steps, each launching K5
   12 times, K4's forward and backward once, K1 and K2 12 times; finite,
   falling losses.  Then the fused program of a 2-layer, batch-1, seq-1024
   step runs on the card and on the host, with the train phase's
   tolerances.
7. ``timing`` — each kernel, its plain version and one PyTorch library call
   computing the same function, with CUDA events, at the main-path shapes
   ([96, 2048, 64] causal for K1/K2, ResNet-50's 15 conv1x1 shapes at batch
   128 for K3, [16384, 768] for K4, [16384, 768] x [768, 3072] gelu for
   K5); the least time the card could take (``bound``); the server's
   per-bucket batch latency, requests/s and tokens/s, the GPT training
   steps' time, tokens/s and peak memory (plain and fused), and the ResNet
   step's time, images/s, peak memory and summed K3 time.

Then one JSON line describing every kernel, the ``nvidia-smi`` line, and a
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 2 before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ATOL, RTOL = 1e-5, 1e-4                 # kernel vs plain, float32
# K3 vs its plain version: both sum exact bf16 products in float32, in
# other orders, so y may differ by a few float32 ulps of the sum of |terms|
# (16 ulps: 2^-20 of sum |w||x|); s sums N*P values of either sign (2^-14
# of sum |y|: the sequential part of the kernel's reduction adds up to ~800
# row partials), s2 positive values (2^-14 relative)
K3_SUM_RTOL, K3_STAT_RTOL = 2.0 ** -20, 2.0 ** -14
SERVE_ATOL, SERVE_RTOL = 2e-3, 2e-3     # card vs host logits, float32
# card vs host training step.  The fused LM head rounds its products to
# bf16, and a sum taken in another order can round to the neighbouring bf16
# value; the head's weight gradient adds up one bf16-rounded partial per
# 1024-token chunk, and partials can cancel.  So each gradient must agree
# elementwise within two bf16 ulps plus one bf16 ulp of its largest
# magnitude, and all but 1 in 10,000 of its values within two bf16 ulps
# plus 1e-4 of its largest magnitude.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 2 * 2.0 ** -8
TRAIN_GRAD_ATOL_FRAC, TRAIN_GRAD_TIGHT_FRAC = 2.0 ** -8, 1e-4
TRAIN_GRAD_TIGHT_SHARE = 1e-4
# The fused step's K5 backward recomputes its pre-activation as a bf16
# product (bf16 result), as the reference's _mba_bwd does: where the card's
# and the host's float32 sums round to neighbouring bf16 values (~1 in 10^5
# elements), the activation's derivative moves by a bf16 ulp and a whole
# column of the FFN weight's gradient moves with it.  Every value stays
# within the bound above; the share beyond the tight one may reach 1e-3
# (1.4e-4 of enc_1.ffn.fc1.w@GRAD seen on an H100 80GB HBM3, 700 W)
FUSED_GRAD_TIGHT_SHARE = 1e-3
SLICE = (96, 2048, 64)                  # 8 sequences x 12 heads, T, d_head
TRAIN_BATCH, TRAIN_STEPS = 8, 5
RESNET_BATCH, RESNET_STEPS = 128, 5
# ResNet card vs host, one step.  The fused step: K3 rounds its operands to
# bf16 on the card (as the TPU kernel does) and the host multiplies in
# float32, so each fused product differs by up to 2^-8 relative.  A
# randomly initialised ResNet-50 amplifies such differences chaotically (a
# ReLU input within rounding of 0 flips; the loss of a depth-50, 3x64x64,
# batch-8 step moved by 4.1e-3 with bf16 operands on the host, by 1.4e-2
# and 3.9e-2 with two builds of K3 on the card), so the fused step is held
# to 2^-6 on the loss at the toy (two bottleneck blocks, 16 filters, where
# the noise stays near the bf16 level) and only to 2^-3 at depth 50, a
# check for gross errors.  The unfused step is float32 on both sides: at
# depth 50 the loss to 1e-4, every BN running statistic after the step to
# 2^-10 of its tensor's largest magnitude, and the classifier's gradients
# to 2^-8 of theirs.  Deeper gradients are reported, not held: at this
# batch one flipped pixel moves a conv weight's gradient by a few percent
# (a float64 host product in place of the float32 one moves them by 2-9%
# of their largest value).
RESNET_TOY_LOSS_RTOL, RESNET_FUSED_LOSS_RTOL = 2.0 ** -6, 2.0 ** -3
RESNET_F32_LOSS_RTOL, RESNET_F32_STAT_FRAC = 1e-4, 2.0 ** -10
RESNET_F32_GRAD_FRAC = 2.0 ** -8
RESNET_SMALL = dict(class_dim=10, depth=50, image_shape=(3, 64, 64))
RESNET_SMALL_BATCH = 8
# K5 against its plain version: both sum exact bf16 products in float32 in
# other orders, so y gets K3's allowance of 2^-20 of sum |x||w|.  K4's
# dscale and dbias sum up to 16384 rows of either sign: 2^-14 of the sum of
# their terms' magnitudes
K4_SUM_RTOL = 2.0 ** -14
# the fused path: the autotuner on and every candidate ranked in (the
# embedding LayerNorm's share is 0.0028, under the default threshold)
FUSED_FLAGS = {"FLAGS_fusion_autotune": True,
               "FLAGS_fusion_rank_threshold": 0.0}
DEFAULT_FLAGS = {"FLAGS_fusion_autotune": False,
                 "FLAGS_fusion_rank_threshold": 0.02,
                 "FLAGS_xla_compile_cache_dir": ""}
#: an autotuner miss runs the fused op once to warm up and 3 times timed
AUTOTUNE_CALLS = 4

# NVIDIA data-sheet peaks (dense): float32 on the CUDA cores, bf16 on the
# tensor cores, HBM bandwidth
_PEAKS = (("PCIe", 51e12, 756e12, 2.0e12), ("NVL", 60e12, 835e12, 3.9e12),
          ("H100", 67e12, 989e12, 3.35e12), ("H200", 67e12, 989e12, 4.8e12))


def _log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _peaks(name, kind="float32"):
    for key, f32, bf16, bw in _PEAKS:
        if key in name:
            return (f32 if kind == "float32" else bf16), bw
    raise RuntimeError(f"no peak table entry for card {name!r}")


def _time_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_env():
    import torch
    from paddle_tpu_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log("env", f"gpu: {smi}")
    _log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
         f"cuda {torch.version.cuda} device "
         f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.build()
    total = time.perf_counter() - t0
    for name, info in built.items():
        log = info["log"].splitlines()
        regs = [int(m.group(1)) for ln in log
                for m in [re.search(r"Used (\d+) registers", ln)] if m]
        spills = [int(m.group(1)) for ln in log
                  for m in [re.search(r"(\d+) bytes spill stores", ln)] if m]
        _log("env", f"nvcc {name}: {info['seconds']:.2f} s; ptxas: "
             f"{len(regs)} functions, registers max {max(regs, default=0)},"
             f" spill stores max {max(spills, default=0)} bytes")
    _log("env", f"kernel build wall time {total:.2f} s")
    return smi


def _check(name, got, ref, extra=None):
    """Max abs error of ``got`` against ``ref``; raises unless every value
    is within ``ATOL + RTOL * |ref|`` (plus ``extra``, a per-value or
    scalar allowance, where given)."""
    import torch
    err = (got - ref).abs()
    bound = ATOL + RTOL * ref.abs()
    if extra is not None:
        bound = bound + extra
    bad = ~(err <= bound)
    bad &= ~((got == ref) | (torch.isnan(got) & torch.isnan(ref)))
    finite = torch.isfinite(err)
    max_abs = float(err[finite].max()) if finite.any() else 0.0
    if bad.any():
        more = " + sum allowance" if extra is not None else ""
        raise AssertionError(f"{name}: {int(bad.sum())} values outside "
                             f"atol {ATOL} rtol {RTOL}{more}; max abs "
                             f"{max_abs}")
    return max_abs


#: ResNet-50's conv1x1 shapes (Cin, Cout, H*W) at 224x224: what K3 gets
K3_SHAPES = ((64, 64, 3136), (64, 256, 3136), (256, 64, 3136),
             (256, 128, 3136), (128, 512, 784), (256, 512, 784),
             (512, 128, 784), (512, 256, 784), (256, 1024, 196),
             (512, 1024, 196), (1024, 256, 196), (1024, 512, 196),
             (512, 2048, 49), (1024, 2048, 49), (2048, 512, 49))


def check_k3(name, x, w):
    """K3 against its plain version on the card: y per value within the
    float32 allowance of its sum, s and s2 within theirs."""
    import torch
    from paddle_tpu_torch.kernels import conv_bn as cb
    y, s, s2 = cb.conv1x1_stats_fwd(x, w)
    torch.cuda.synchronize()
    ry, rs, rs2 = cb.conv1x1_stats_plain(x, w)
    terms = torch.einsum("oc,ncp->nop", w.to(torch.bfloat16).float().abs(),
                         x.to(torch.bfloat16).float().abs())
    e_y = _check(name + " y", y, ry, K3_SUM_RTOL * terms)
    del terms
    e_s = _check(name + " s", s, rs,
                 K3_STAT_RTOL * ry.abs().sum(dim=(0, 2)))
    e_s2 = _check(name + " s2", s2, rs2, K3_STAT_RTOL * rs2)
    return e_y, e_s, e_s2


def phase_kernel():
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    bh, t, d = SLICE
    cases = [
        ("slice [96,2048,64] causal", bh, t, t, d, True, None),
        ("T=1000 causal", 8, 1000, 1000, 64, True, None),
        ("T=1000 non-causal", 8, 1000, 1000, 64, False, None),
        ("bias [1,Tq,Tk]", 8, 700, 700, 64, False, "one"),
        ("bias [bh,Tq,Tk]", 8, 700, 700, 64, False, "bh"),
        ("Tq=128 < Tk=1024 causal", 12, 128, 1024, 64, True, None),
        ("fully masked rows (-inf bias)", 4, 256, 256, 64, False, "-inf"),
        ("fully masked rows (causal Tq > Tk)", 4, 200, 72, 64, True, None),
        ("d=32 causal", 8, 777, 777, 32, True, None),
        ("d=128 causal", 8, 777, 777, 128, True, None),
    ]
    worst = {"flash_attn_fwd": 0.0, "flash_attn_bwd": 0.0}
    for name, bh_, tq, tk, d_, causal, bias_kind in cases:
        q = torch.randn(bh_, tq, d_, device="cuda", generator=g)
        k = torch.randn(bh_, tk, d_, device="cuda", generator=g)
        v = torch.randn(bh_, tk, d_, device="cuda", generator=g)
        bias = None
        if bias_kind == "one":
            bias = torch.randn(1, tq, tk, device="cuda", generator=g)
        elif bias_kind == "bh":
            bias = torch.randn(bh_, tq, tk, device="cuda", generator=g)
        elif bias_kind == "-inf":
            bias = torch.zeros(1, tq, tk, device="cuda")
            bias[0, 5::17, :] = float("-inf")
        o, lse = fa.flash_attention_fwd(q, k, v, bias, causal)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v, bias, causal)
        torch.cuda.synchronize()
        e_o = _check(name + " o", o, ro)
        e_l = _check(name + " lse", lse, rlse)
        if bias_kind == "-inf":
            rows = o[:, 5::17]
            assert bool((rows == 0).all()), "fully masked rows must give o=0"
        worst["flash_attn_fwd"] = max(worst["flash_attn_fwd"], e_o, e_l)
        _log("kernel", f"flash_attn_fwd {name}: max abs err o {e_o:.3g} "
             f"lse {e_l:.3g} (atol {ATOL}, rtol {RTOL}) ok")
        if bias is not None:
            continue        # a biased backward is the plain version
        do = torch.randn(bh_, tq, d_, device="cuda", generator=g)
        got = fa.flash_attention_bwd(q, k, v, ro, rlse, do, causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, ro, rlse, do, None,
                                                causal)
        torch.cuda.synchronize()
        errs = [_check(f"{name} {n}", a, b)
                for n, a, b in zip(("dq", "dk", "dv"), got, want)]
        if tq > tk and causal:
            assert bool((got[0][:, :tq - tk] == 0).all()), \
                "rows without a live key must get dq = 0"
        worst["flash_attn_bwd"] = max(worst["flash_attn_bwd"], *errs)
        _log("kernel", f"flash_attn_bwd {name}: max abs err dq {errs[0]:.3g}"
             f" dk {errs[1]:.3g} dv {errs[2]:.3g} (atol {ATOL}, rtol "
             f"{RTOL}) ok")
        del got, want

    # K3 at ResNet-50's shapes at the training batch, then the edges
    k3_cases = [(f"[{RESNET_BATCH}, {ci}, {p}] x [{co}, {ci}]",
                 RESNET_BATCH, ci, co, p, 1) for ci, co, p in K3_SHAPES]
    k3_cases += [("N=1 P=49", 1, 512, 2048, 49, 1),
                 ("Cin 13 Cout 70 P 65 (ragged tiles)", 3, 13, 70, 65, 1),
                 ("Cin 12 Cout 20 P 49", 5, 12, 20, 49, 1),
                 ("Cin 3 Cout 5 P 1", 2, 3, 5, 1, 1),
                 ("stride-2 view of [8, 256, 56, 56]", 8, 256, 512, 3136, 2),
                 ("stride-2 view of [8, 1024, 14, 14]", 8, 1024, 2048, 196,
                  2)]
    worst["conv1x1_stats"] = 0.0
    for name, n, ci, co, p, stride in k3_cases:
        side = int(round(p ** 0.5))
        if stride > 1:
            x4 = torch.randn(n, ci, side, side, device="cuda", generator=g)
            x = x4[:, :, ::stride, ::stride].reshape(n, ci, -1)
            del x4
        else:
            x = torch.randn(n, ci, p, device="cuda", generator=g)
        w = torch.randn(co, ci, device="cuda", generator=g) * ci ** -0.5
        e_y, e_s, e_s2 = check_k3(name, x, w)
        worst["conv1x1_stats"] = max(worst["conv1x1_stats"], e_y)
        _log("kernel", f"conv1x1_stats {name}: max abs err y {e_y:.3g} s "
             f"{e_s:.3g} s2 {e_s2:.3g} (atol {ATOL}, rtol {RTOL}, + "
             f"{K3_SUM_RTOL:.3g} sum|w||x| on y, {K3_STAT_RTOL:.3g} of "
             f"sum|y| / s2 on the stats) ok")
        del x, w

    # K5 at the fused path's shapes (batch 8 x 2048 tokens and fractions of
    # it), each activation, then the edges
    from paddle_tpu_torch.kernels import dense_epilogue as de
    from paddle_tpu_torch.kernels import layer_norm as ln
    acts = (("", False), ("relu", False), ("gelu", False), ("gelu", True))
    k5_cases = [(f"[{m}, 768] x [768, 3072]", m, 768, 3072)
                for m in (4096, 8192, 16384)]
    k5_cases += [("M=1", 1, 768, 3072), ("M=513", 513, 768, 3072),
                 ("ragged N, K: [300, 100] x [100, 130]", 300, 100, 130),
                 ("ragged M, N, K: [257, 33] x [33, 7]", 257, 33, 7)]
    worst["dense_epilogue"] = 0.0
    for name, m, k, n in k5_cases:
        x = torch.randn(m, k, device="cuda", generator=g)
        w = torch.randn(k, n, device="cuda", generator=g) * k ** -0.5
        b = torch.randn(n, device="cuda", generator=g)
        terms = x.to(torch.bfloat16).float().abs() @ \
            w.to(torch.bfloat16).float().abs()
        errs = []
        for act, approx in acts:
            y = de.dense_act_fwd(x, w, b, act, approx)
            torch.cuda.synchronize()
            ry = de.dense_act_plain(x, w, b, act, approx)
            what = f"dense_epilogue {name} act {act or 'none'}" + (
                " (tanh)" if approx else "")
            errs.append(_check(what, y, ry, K3_SUM_RTOL * terms))
            del y, ry
        worst["dense_epilogue"] = max(worst["dense_epilogue"], *errs)
        _log("kernel", f"dense_epilogue {name}: max abs err y, act none/"
             f"relu/gelu/gelu-tanh {'/'.join(f'{e:.3g}' for e in errs)} "
             f"(atol {ATOL}, rtol {RTOL}, + {K3_SUM_RTOL:.3g} sum|x||w|) ok")
        del x, w, b, terms

    # K4 at the fused path's shape, then the edges
    k4_cases = [("[16384, 768]", 16384, 768), ("rows 1", 1, 768),
                ("rows 4099", 4099, 768), ("d 96", 4099, 96),
                ("d 1000", 4099, 1000), ("d 4096", 4099, 4096)]
    worst["layer_norm_fwd"] = worst["layer_norm_bwd"] = 0.0
    for name, rows, d in k4_cases:
        x = torch.randn(rows, d, device="cuda", generator=g) * 2 + 0.5
        sc = torch.randn(d, device="cuda", generator=g) + 1
        bi = torch.randn(d, device="cuda", generator=g)
        dy = torch.randn(rows, d, device="cuda", generator=g)
        y = ln.layer_norm_fwd(x, sc, bi, 1e-5)
        dx, ds, db = ln.layer_norm_bwd(x, sc, dy, 1e-5)
        torch.cuda.synchronize()
        ry = ln.layer_norm_fwd_plain(x, sc, bi, 1e-5)
        rdx, rds, rdb = ln.layer_norm_bwd_plain(x, sc, dy, 1e-5)
        xhat = ln.layer_norm_fwd_plain(x, torch.ones_like(sc),
                                       torch.zeros_like(bi), 1e-5)
        e_y = _check(f"layer_norm_fwd {name} y", y, ry)
        e_dx = _check(f"layer_norm_bwd {name} dx", dx, rdx)
        e_ds = _check(f"layer_norm_bwd {name} dscale", ds, rds,
                      K4_SUM_RTOL * (dy * xhat).abs().sum(dim=0))
        e_db = _check(f"layer_norm_bwd {name} dbias", db, rdb,
                      K4_SUM_RTOL * dy.abs().sum(dim=0))
        worst["layer_norm_fwd"] = max(worst["layer_norm_fwd"], e_y)
        worst["layer_norm_bwd"] = max(worst["layer_norm_bwd"], e_dx)
        _log("kernel", f"layer_norm {name}: max abs err y {e_y:.3g} dx "
             f"{e_dx:.3g} (atol {ATOL}, rtol {RTOL}) dscale {e_ds:.3g} "
             f"dbias {e_db:.3g} (+ {K4_SUM_RTOL:.3g} sum of |terms|) ok")
        del x, dy, y, dx, ry, rdx, xhat
    return worst


def _gpt_cfg():
    from paddle_tpu_torch.models import transformer as T
    return T.BertConfig(vocab_size=30522, d_model=768, n_layer=12,
                        n_head=12, d_inner=3072, max_pos=2048, dropout=0.0)


def _factory(cfg):
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.models import transformer as T

    def factory(seq):
        prog, startup = Program(), Program()
        with program_guard(prog, startup):
            _, logits = T.build_gpt_serving(cfg, seq, attn_impl="auto")
        return prog, ["src_ids"], [logits.name]
    return factory


def phase_serve():
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import transformer as T

    cfg = _gpt_cfg()
    factory = _factory(cfg)
    scope = Scope()
    exe = ptt.Executor()
    startup = Program()
    with program_guard(Program(), startup):
        T.build_gpt_serving(cfg, 512, attn_impl="auto")
    exe.run(startup, scope=scope, seed=1234)
    n_params = sum(int(scope.find_var(v.name).numel())
                   for v in startup.global_block().vars.values())
    head = cfg.d_model * cfg.vocab_size + cfg.vocab_size
    assert n_params == cfg.num_params() + head, n_params
    _log("serve", f"GPT causal LM, {n_params / 1e6:.1f} M parameters "
         f"(LM head included) on {exe.device}")

    buckets = (512, 1024, 2048)
    srv = ptt.serving.InferenceServer(factory, scope, buckets=buckets,
                                      max_batch=8, batch_wait_ms=20.0)
    rng = np.random.RandomState(7)
    lengths = [1100] + [int(x) for x in rng.randint(300, 2049, 23)]
    reqs = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int64)
            for n in lengths]

    # the main path, counted: warmup + 24 requests through the server
    fa.reset_launch_count()
    t_w = time.perf_counter()
    warmed = srv.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_w
    srv.start()
    t0 = time.perf_counter()
    futs = [srv.submit("tenant_a" if i % 2 else "tenant_b",
                       {"src_ids": ids}) for i, ids in enumerate(reqs)]
    outs = [f.result(timeout=600) for f in futs]
    assert srv.drain(120), "drain did not finish"
    wall = time.perf_counter() - t0
    srv.stop()
    launches = fa.launch_count()

    log = srv.batch_log()
    flash_batches = sum(1 for b in log if b["bucket"] >= 1024) + \
        sum(1 for b in buckets if b >= 1024)
    expected = cfg.n_layer * flash_batches
    if launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             f"expected {cfg.n_layer} x {flash_batches}")
    for ids, out in zip(reqs, outs):
        assert out[0].shape == (len(ids), cfg.vocab_size), out[0].shape
        assert np.isfinite(out[0]).all(), "non-finite logits"
    stats = srv.compile_stats()
    assert stats["traces"] == len(buckets), stats
    # each bucket's plan runs its CompiledProgram._optimized program
    fused = [[op for op, _ in p.ops if op.type == "fused_dense_act"]
             for p in srv.executor._plans.values()]
    if [len(f) for f in fused] != [cfg.n_layer] * len(buckets) or any(
            op.attrs["use_pallas"] for f in fused for op in f):
        raise AssertionError(
            f"bucket plans hold {[len(f) for f in fused]} fused_dense_act "
            f"ops, expected {cfg.n_layer} each without the kernel")
    _log("serve", f"CompiledProgram._optimized: {cfg.n_layer} "
         f"fused_dense_act (use_pallas False) in each of "
         f"{len(buckets)} bucket programs")
    _log("serve", f"warmup {warmed} buckets in {warm_s:.2f} s; "
         f"{len(reqs)} requests in {len(log)} batches "
         f"{[(b['bucket'], b['occupancy']) for b in log]}; plans built "
         f"{stats['traces']}; flash launches {launches} = "
         f"{cfg.n_layer} x {flash_batches} batches at buckets >= 1024")

    # one 1100-token request against the same bucket program on the host
    cpu_scope = Scope()
    for name, val in scope.items():
        cpu_scope.set_var(name, val.detach().cpu())
    prog, _, fetch = factory(2048)
    feed = np.zeros((1, 2048), np.int64)
    feed[0, :len(reqs[0])] = reqs[0]
    t_c = time.perf_counter()
    ref, = ptt.Executor(ptt.CPUPlace()).run(
        prog, feed={"src_ids": feed}, fetch_list=fetch, scope=cpu_scope)
    ref = ref[0, :len(reqs[0])]
    err = np.abs(outs[0][0] - ref)
    ok = err <= SERVE_ATOL + SERVE_RTOL * np.abs(ref)
    if not ok.all():
        raise AssertionError(f"served logits differ from the host run: max "
                             f"abs {err.max()} (atol {SERVE_ATOL} rtol "
                             f"{SERVE_RTOL})")
    _log("serve", f"1100-token request vs host run of the bucket-2048 "
         f"program ({time.perf_counter() - t_c:.1f} s): max abs err "
         f"{err.max():.3g}, max |logit| {np.abs(ref).max():.3g} "
         f"(atol {SERVE_ATOL}, rtol {SERVE_RTOL}) ok")
    tokens = int(sum(lengths))
    per_bucket = {}
    for b in log:
        per_bucket.setdefault(b["bucket"], []).append(b["latency_ms"])
    return {"wall_s": wall, "requests": len(reqs), "tokens": tokens,
            "launches": launches, "flash_batches": flash_batches,
            "per_bucket_ms": per_bucket, "batches": log,
            "scope": scope, "factory": factory}


def _train_program(cfg, seq):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.models import transformer as T
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss = T.build_gpt_pretrain(cfg, seq, fused_head=True,
                                          attn_impl="auto", dropout=0.0)
        optimizer.AdamOptimizer(learning_rate=1e-4).minimize(loss)
    return main, startup, loss


def _train_feed(cfg, batch, seq, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.vocab_size, (batch, seq)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = 0
    return {"src_ids": ids, "lm_label": labels}


def phase_train():
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import flash_attention as fa

    cfg = _gpt_cfg()
    seq = cfg.max_pos
    main, startup, loss = _train_program(cfg, seq)
    types = [op.type for op in main.global_block().ops]
    n_flash = types.count("flash_attention")
    assert n_flash == types.count("flash_attention_grad") == cfg.n_layer, \
        (n_flash, types.count("flash_attention_grad"))
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=1234)
    n_params = sum(int(scope.find_var(p.name).numel())
                   for p in main.all_parameters())
    _log("train", f"GPT causal LM pretraining program: {len(types)} ops "
         f"({n_flash} flash_attention, {types.count('adam')} adam), "
         f"{n_params / 1e6:.1f} M parameters, Adam state on {exe.device}")
    feed = _train_feed(cfg, TRAIN_BATCH, seq)
    tokens = TRAIN_BATCH * seq

    # the main path, counted: a warm-up step and the timed steps
    fa.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # earlier phases' and the weights
    t_w = time.perf_counter()
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0])]
    warm_s = time.perf_counter() - t_w
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out))
    launches = {k: fa.launch_count(k)
                for k in ("flash_attn_fwd", "flash_attn_bwd")}
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_STEPS + 1
    for k, n in launches.items():
        if n != cfg.n_layer * steps:
            raise AssertionError(f"{k} launched {n} times in {steps} "
                                 f"training steps, expected "
                                 f"{cfg.n_layer} per step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    step_ms = 1e3 * float(np.mean(step_s))
    _log("train", f"batch {TRAIN_BATCH} x seq {seq}: warm-up step "
         f"{warm_s:.2f} s, then {TRAIN_STEPS} steps of "
         f"{', '.join(f'{1e3 * x:.1f}' for x in step_s)} ms; losses "
         f"{', '.join(f'{x:.4f}' for x in losses)}; flash launches "
         f"{launches} = {cfg.n_layer} x {steps} steps each; peak memory "
         f"{peak / 2**30:.2f} GiB, of which {held / 2**30:.2f} GiB allocated "
         f"before the first step")

    _small_train_check("train", exe)
    return {"launches": launches, "losses": losses, "step_ms": step_ms,
            "step_s": step_s, "warmup_s": warm_s,
            "tokens_per_s": tokens / (step_ms / 1e3),
            "peak_bytes": peak, "held_bytes": held, "tokens": tokens,
            "main": main,
            "loss": loss, "scope": scope, "feed": feed}


def _small_train_check(phase, exe, fused=False):
    """A 2-layer, batch-1, seq-1024 step on the card against the same step
    on the host: the loss within TRAIN_LOSS_RTOL, four gradients within
    two bf16 ulps (see the constants).  ``fused``: the host runs the fused
    program the card's plan ran (the autotuner's verdicts are the card's;
    the host would time its own)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.analysis import fusion
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.models import transformer as T
    cfg = _gpt_cfg()
    small = T.BertConfig(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                         n_layer=2, n_head=cfg.n_head, d_inner=cfg.d_inner,
                         max_pos=1024, dropout=0.0)
    s_main, s_startup, s_loss = _train_program(small, 1024)
    s_scope, host_scope = Scope(), Scope()
    exe.run(s_startup, scope=s_scope, seed=99)
    for name, val in s_scope.items():
        host_scope.set_var(name, val.detach().cpu())
    s_feed = _train_feed(small, 1, 1024, seed=1)
    grads = ["lm_out.w@GRAD", "enc_0.attn.qkv.w@GRAD",
             "enc_1.ffn.fc1.w@GRAD", "word_embedding@GRAD"]
    fetch = [s_loss.name] + grads
    card = exe.run(s_main, feed=s_feed, fetch_list=fetch, scope=s_scope)
    host_prog, what = s_main, ""
    if fused:
        # the executor's own call, answered from the pass's result cache
        host_prog = fusion.fuse_program(
            s_main, fetch, feed_shapes={n: v.shape for n, v in
                                        s_feed.items()}, device=exe.device)
        assert host_prog is not s_main, "the small program was not fused"
        what = " (fused program; verdicts at this shape: " + ", ".join(
            f"{d['pattern']} {d['verdict']}" + (
                f" {d['autotune']['base_ms']}/{d['autotune']['fused_ms']} ms"
                if "autotune" in d else "")
            for d in host_prog._attrs["fusion"]["candidates"]) + ")"
    t_c = time.perf_counter()
    host = ptt.Executor(ptt.CPUPlace()).run(
        host_prog, feed=s_feed, fetch_list=fetch, scope=host_scope)
    host_s = time.perf_counter() - t_c
    loss_err = abs(float(card[0]) - float(host[0])) / abs(float(host[0]))
    if loss_err > TRAIN_LOSS_RTOL:
        raise AssertionError(f"card loss {float(card[0])} vs host "
                             f"{float(host[0])}: rel err {loss_err}")
    worst = []
    for name, c, h in zip(grads, card[1:], host[1:]):
        top = float(np.abs(h).max())
        err = np.abs(c - h)
        rel = TRAIN_GRAD_RTOL * np.abs(h)
        bad = int((err > TRAIN_GRAD_ATOL_FRAC * top + rel).sum())
        loose = int((err > TRAIN_GRAD_TIGHT_FRAC * top + rel).sum())
        share = FUSED_GRAD_TIGHT_SHARE if fused else TRAIN_GRAD_TIGHT_SHARE
        if bad or loose > share * h.size:
            raise AssertionError(
                f"{name}: {bad} of {h.size} values beyond "
                f"{TRAIN_GRAD_ATOL_FRAC:.3g} x max|g|, {loose} beyond "
                f"{TRAIN_GRAD_TIGHT_FRAC} x max|g| (rtol {TRAIN_GRAD_RTOL:.3g}"
                f", at most {share:g} of them); max abs err {err.max()}, "
                f"max |g| {top}")
        worst.append(f"{name} {err.max():.3g} (max |g| {top:.3g}, "
                     f"{loose} of {h.size} beyond 1e-4 x max|g|)")
    _log(phase, f"2-layer batch-1 seq-1024 step vs host run{what} "
         f"({host_s:.1f} s): loss rel err {loss_err:.3g} (rtol "
         f"{TRAIN_LOSS_RTOL}); grads max abs err {'; '.join(worst)} "
         f"(rtol {TRAIN_GRAD_RTOL:.3g}) ok")


def _adam_plan(exe):
    """The executor's plan of the training program (the fused program it
    runs in place of the one it was given)."""
    plan, = [p for p in exe._plans.values()
             if any(op.type == "adam" for op, _ in p.ops)]
    return plan


def _fused_launches():
    from paddle_tpu_torch.kernels import dense_epilogue as de
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    return {"dense_epilogue": de.launch_count(),
            "layer_norm_fwd": ln.launch_count("layer_norm_fwd"),
            "layer_norm_bwd": ln.launch_count("layer_norm_bwd"),
            "flash_attn_fwd": fa.launch_count("flash_attn_fwd"),
            "flash_attn_bwd": fa.launch_count("flash_attn_bwd")}


def phase_fused_train():
    import shutil
    import tempfile

    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import dense_epilogue as de
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln

    cfg = _gpt_cfg()
    seq = cfg.max_pos
    cache_dir = tempfile.mkdtemp(prefix="fusion_autotune_")
    flags.set_flags(dict(FUSED_FLAGS, FLAGS_xla_compile_cache_dir=cache_dir))
    try:
        main, startup, loss = _train_program(cfg, seq)
        n_ln = [op.type for op in main.global_block().ops].count(
            "layer_norm")
        scope, exe = Scope(), ptt.Executor()
        exe.run(startup, scope=scope, seed=1234)
        feed = _train_feed(cfg, TRAIN_BATCH, seq)
        tokens = TRAIN_BATCH * seq

        # the main path, counted: a warm-up step (the plan, with the
        # autotuner's timings) and the timed steps
        for mod in (fa, de, ln):
            mod.reset_launch_count()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        prev = _fused_launches()
        per_step, losses, step_s = [], [], []
        for _ in range(TRAIN_STEPS + 1):
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            now = _fused_launches()
            per_step.append({k: now[k] - prev[k] for k in now})
            prev = now
            losses.append(float(out))
        launches = _fused_launches()
        peak = torch.cuda.max_memory_allocated()
        warm_s = step_s.pop(0)
        plan = _adam_plan(exe)
        ftypes = [op.type for op, _ in plan.ops]
        decisions = plan.block.program._attrs["fusion"]["candidates"]
        for d in decisions:
            t = d.get("autotune") or {}
            _log("fused_train", f"autotune {d['pattern']} at {d['anchor']}: "
                 f"verdict {d['verdict']}, rank {d['rank']}, base_ms "
                 f"{t.get('base_ms')}, fused_ms {t.get('fused_ms')}, win "
                 f"{t.get('win')}, cached {t.get('cached')}")
        lost = [d for d in decisions if d["verdict"] != "applied"]
        if lost:
            raise AssertionError(f"fusion candidates not applied: {lost}")
        want = {"fused_dense_act": cfg.n_layer,
                "fused_dense_act_grad": cfg.n_layer,
                "fused_embedding_layer_norm": 1,
                "fused_embedding_layer_norm_grad": 1,
                "layer_norm": n_ln - 1}
        got = {t: ftypes.count(t) for t in want}
        unkernelled = [op.type for op, _ in plan.ops
                       if op.type in want and op.type != "layer_norm"
                       and not op.attrs["use_pallas"]]
        if got != want or unkernelled:
            raise AssertionError(f"fused plan holds {got}, expected {want}; "
                                 f"without the kernel: {unkernelled}")
        # the warm-up step also timed each missed candidate's fused op
        misses = {p: sum(1 for d in decisions if d["pattern"] == p
                         and not d["autotune"]["cached"])
                  for p in ("dense_epilogue", "embedding_layer_norm")}
        step_want = {"dense_epilogue": cfg.n_layer, "layer_norm_fwd": 1,
                     "layer_norm_bwd": 1, "flash_attn_fwd": cfg.n_layer,
                     "flash_attn_bwd": cfg.n_layer}
        warm_want = dict(step_want)
        warm_want["dense_epilogue"] += AUTOTUNE_CALLS * misses[
            "dense_epilogue"]
        warm_want["layer_norm_fwd"] += AUTOTUNE_CALLS * misses[
            "embedding_layer_norm"]
        if per_step != [warm_want] + [step_want] * TRAIN_STEPS:
            raise AssertionError(f"launches per step {per_step}, expected "
                                 f"{warm_want} then {step_want}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"fused training losses not finite and "
                                 f"falling: {losses}")
        step_ms = 1e3 * float(np.mean(step_s))
        _log("fused_train", f"batch {TRAIN_BATCH} x seq {seq}: fused plan of "
             f"{len(ftypes)} ops ({got}); warm-up step {warm_s:.2f} s, then "
             f"{TRAIN_STEPS} steps of "
             f"{', '.join(f'{1e3 * x:.1f}' for x in step_s)} ms; losses "
             f"{', '.join(f'{x:.4f}' for x in losses)}; launches per step "
             f"{per_step[1]} (warm-up {per_step[0]}); peak memory "
             f"{peak / 2**30:.2f} GiB, of which {held / 2**30:.2f} GiB "
             f"allocated before the first step")
        _small_train_check("fused_train", exe, fused=True)
    finally:
        flags.set_flags(DEFAULT_FLAGS)
        shutil.rmtree(cache_dir, ignore_errors=True)
    return {"launches": launches, "per_step": per_step, "losses": losses,
            "step_ms": step_ms, "step_s": step_s, "warmup_s": warm_s,
            "tokens_per_s": tokens / (step_ms / 1e3), "peak_bytes": peak,
            "held_bytes": held, "decisions": decisions}


def _resnet_program(**kw):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.models import resnet
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss, accs = resnet.build_resnet_train(**kw)
        optimizer.MomentumOptimizer(learning_rate=0.1,
                                    momentum=0.9).minimize(loss)
    return main, startup, loss, accs


def _resnet_feed(batch, class_dim, image_shape, seed=0):
    """bench.py:208-214: one fixed batch of uniform images and labels."""
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(batch, *image_shape).astype(np.float32),
            "label": rng.randint(0, class_dim, (batch, 1)).astype(np.int64)}


def _train_plan(exe):
    """The executor's one plan of a training program (the fused program
    it runs in place of the one it was given)."""
    plan, = [p for p in exe._plans.values()
             if any(op.type == "momentum" for op, _ in p.ops)]
    return plan


def _fused_shapes(plan):
    """(Cin, Cout, H*W) of each fused_conv1x1_bn op the plan runs."""
    block = plan.block
    out = []
    for op, _ in plan.ops:
        if op.type != "fused_conv1x1_bn":
            continue
        w = block.var(op.input("Filter")[0]).shape
        y = block.var(op.output("Y")[0]).shape
        out.append((int(w[1]), int(w[0]), int(y[2]) * int(y[3])))
    return out


def _toy_resnet_program():
    """Two bottleneck blocks (strides 1 and 2, 16 filters) on a [16, 8, 8]
    input, global pooling, fc with softmax: 6 fused conv1x1 + BN pairs."""
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.models import resnet
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("image", shape=[16, 8, 8], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        h = resnet.bottleneck_block(img, 16, 1, "bb0")
        h = resnet.bottleneck_block(h, 16, 2, "bb1")
        pred = layers.fc(layers.pool2d(h, pool_type="avg",
                                       global_pooling=True), size=4,
                         act="softmax", param_attr="fc_out.w",
                         bias_attr="fc_out.b")
        loss = layers.mean(layers.cross_entropy(pred, label))
        optimizer.MomentumOptimizer(learning_rate=0.1,
                                    momentum=0.9).minimize(loss)
    return main, startup, loss


def _resnet_small_check(exe, model, fused):
    """One step on the card against the same step on the host: the toy or
    depth 50 at 3x64x64, batch 8, with the fusion pass on or off."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import conv_bn as cb
    if model == "toy":
        main, startup, loss = _toy_resnet_program()
        feed = _resnet_feed(4, 4, (16, 8, 8), seed=1)
        n_fused, what = 6, "toy (2 bottleneck blocks, 16 filters) batch-4"
        tol = RESNET_TOY_LOSS_RTOL
    else:
        main, startup, loss, _ = _resnet_program(**RESNET_SMALL)
        feed = _resnet_feed(RESNET_SMALL_BATCH, RESNET_SMALL["class_dim"],
                            RESNET_SMALL["image_shape"], seed=1)
        n_fused = 36
        what = f"depth-50 3x64x64 batch-{RESNET_SMALL_BATCH}"
        tol = RESNET_FUSED_LOSS_RTOL if fused else RESNET_F32_LOSS_RTOL
    scope, host_scope = Scope(), Scope()
    exe.run(startup, scope=scope, seed=7)
    for name, val in scope.items():
        host_scope.set_var(name, val.detach().cpu())
    held = ["fc_out.w@GRAD", "fc_out.b@GRAD"]
    grads = held + ([] if model == "toy" else [
        "res3_2.b2.conv.w@GRAD", "res2_0.short.conv.w@GRAD",
        "res0_0.b0.conv.w@GRAD", "stem.conv.w@GRAD"])
    fetch = [loss.name] + grads
    flags.set_flags({"FLAGS_graph_fusion": fused})
    try:
        n0 = cb.launch_count()
        card = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        k3 = cb.launch_count() - n0
        t_c = time.perf_counter()
        host = ptt.Executor(ptt.CPUPlace()).run(main, feed=feed,
                                                fetch_list=fetch,
                                                scope=host_scope)
        host_s = time.perf_counter() - t_c
    finally:
        flags.set_flags({"FLAGS_graph_fusion": True})
    if k3 != (n_fused if fused else 0):
        raise AssertionError(f"K3 launched {k3} times in the "
                             f"{'fused' if fused else 'unfused'} step")
    loss_err = abs(float(card[0]) - float(host[0])) / abs(float(host[0]))
    if not loss_err <= tol:
        raise AssertionError(f"{what}: card loss {float(card[0])} vs host "
                             f"{float(host[0])}: rel err {loss_err} > {tol}")

    def frac(c, h):
        c, h = np.asarray(c, np.float64), np.asarray(h, np.float64)
        return float(np.abs(c - h).max()) / max(float(np.abs(h).max()),
                                                1e-30)

    grad_err = {name: frac(c, h)
                for name, c, h in zip(grads, card[1:], host[1:])}
    stats = [v.name for v in main.list_vars()
             if v.name.endswith((".bn.mean", ".bn.var"))]
    stat_err = max(frac(scope.find_var(n).cpu(), host_scope.find_var(n))
                   for n in stats)
    if not fused:
        bad = {n: e for n, e in grad_err.items()
               if n in held and not e <= RESNET_F32_GRAD_FRAC}
        if bad or not stat_err <= RESNET_F32_STAT_FRAC:
            raise AssertionError(
                f"unfused card step vs host: classifier gradients {bad} "
                f"(bound {RESNET_F32_GRAD_FRAC:.3g} x max|g|), BN running "
                f"statistics {stat_err:.3g} (bound "
                f"{RESNET_F32_STAT_FRAC:.3g} x max|v|)")
    how = "fused (K3, bf16 operands)" if fused else "unfused (float32)"
    _log("resnet", f"{what} {how} step vs host run ({host_s:.1f} s): loss "
         f"{float(card[0]):.6f} vs {float(host[0]):.6f}, rel err "
         f"{loss_err:.3g} (rtol {tol:.3g}); {len(stats)} BN running "
         f"statistics max err / max|v| {stat_err:.3g}"
         + ("" if fused else f" (bound {RESNET_F32_STAT_FRAC:.3g})")
         + "; grads max abs err / max|g|: "
         + "; ".join(f"{n.split('@')[0]} {e:.3g}"
                     for n, e in grad_err.items())
         + ("" if fused else f" (classifier's bound "
                             f"{RESNET_F32_GRAD_FRAC:.3g})")
         + f"; K3 launches {k3} ok")
    return {"loss_rel_err": loss_err, "stat_err_frac": stat_err,
            "grad_err_frac": grad_err}


def phase_resnet():
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import conv_bn as cb

    cfg = dict(class_dim=1000, depth=50, image_shape=(3, 224, 224))
    t_b = time.perf_counter()
    main, startup, loss, accs = _resnet_program(**cfg)
    types = [op.type for op in main.global_block().ops]
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=1234)
    n_params = sum(int(scope.find_var(p.name).numel())
                   for p in main.all_parameters() if p.trainable)
    _log("resnet", f"ResNet-50 training program: {len(types)} ops "
         f"({types.count('conv2d')} conv2d, {types.count('batch_norm')} "
         f"batch_norm, {types.count('momentum')} momentum), "
         f"{n_params / 1e6:.2f} M trainable parameters on {exe.device}; "
         f"built in {time.perf_counter() - t_b:.1f} s")
    feed = _resnet_feed(RESNET_BATCH, cfg["class_dim"], cfg["image_shape"])
    fetch = [loss, accs[0], accs[1]]

    # the main path, counted: a warm-up step and the timed steps
    cb.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # earlier phases' and the weights
    t_w = time.perf_counter()
    out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    warm_s = time.perf_counter() - t_w
    per_step = [cb.launch_count()]
    losses, acc1 = [float(out[0])], [float(out[1])]
    step_s = []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(cb.launch_count() - sum(per_step))
        losses.append(float(out[0]))
        acc1.append(float(out[1]))
    launches = cb.launch_count()
    peak = torch.cuda.max_memory_allocated()
    plan = _train_plan(exe)
    shapes = _fused_shapes(plan)
    ftypes = [op.type for op, _ in plan.ops]
    step_ms = 1e3 * float(np.mean(step_s))
    _log("resnet", f"batch {RESNET_BATCH} x 3x224x224 float32: fused plan "
         f"of {len(ftypes)} ops (36 fused_conv1x1_bn + 36 grads, "
         f"{ftypes.count('conv2d')} conv2d left); warm-up step "
         f"{warm_s:.2f} s, then {RESNET_STEPS} steps of "
         f"{', '.join(f'{1e3 * x:.1f}' for x in step_s)} ms; losses "
         f"{', '.join(f'{x:.4f}' for x in losses)}; top-1 acc "
         f"{acc1[0]:.3f} -> {acc1[-1]:.3f}; K3 launches {per_step} = "
         f"{launches}; peak memory {peak / 2**30:.2f} GiB, of which "
         f"{held / 2**30:.2f} GiB allocated before the first step")
    if len(shapes) != 36 or ftypes.count("fused_conv1x1_bn_grad") != 36:
        raise AssertionError(f"the fusion pass gave {len(shapes)} fused ops "
                             f"and {ftypes.count('fused_conv1x1_bn_grad')} "
                             "fused grads, expected 36 and 36")
    if per_step != [36] * (RESNET_STEPS + 1):
        raise AssertionError(f"K3 launches per step {per_step}, expected 36 "
                             f"in each of {RESNET_STEPS + 1} steps")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"ResNet losses not finite and falling: "
                             f"{losses}")
    small = {"toy_fused": _resnet_small_check(exe, "toy", True),
             "fused": _resnet_small_check(exe, "depth50", True),
             "unfused": _resnet_small_check(exe, "depth50", False)}
    return {"launches": launches, "per_step": per_step, "losses": losses,
            "step_ms": step_ms, "step_s": step_s, "warmup_s": warm_s,
            "images_per_s": RESNET_BATCH / (step_ms / 1e3),
            "peak_bytes": peak, "held_bytes": held, "shapes": shapes,
            "small": small,
            "main": main, "fetch": fetch, "scope": scope, "feed": feed}


def _profile_rows(prof):
    """(device ms, count, name) of every kernel and copy on the card; host
    ops (aten, autograd nodes, Function records) only aggregate these."""
    rows = []
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(evt, "device_time_total", None)
        if dev is None:
            dev = getattr(evt, "cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    return rows


def phase_profile(serve):
    """Device time of one full bucket-2048 batch (8 x 2048 tokens) by
    kernel, with ``torch.profiler``: where a batch's time goes."""
    import torch
    import paddle_tpu_torch as ptt
    from torch.profiler import ProfilerActivity, profile
    prog, _, fetch = serve["factory"](2048)
    exe = ptt.Executor()
    feed = {"src_ids": np.random.RandomState(3).randint(
        1, 30522, (8, 2048)).astype(np.int64)}
    exe.run(prog, feed=feed, fetch_list=fetch, scope=serve["scope"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        h, = exe.run(prog, feed=feed, fetch_list=fetch,
                     scope=serve["scope"], return_numpy=False)
        t1 = time.perf_counter()
        h.numpy()
        t2 = time.perf_counter()
    rows = _profile_rows(prof)
    copy_ms = sum(r[0] for r in rows if r[2].startswith("Memcpy"))
    kernel_ms = sum(r[0] for r in rows) - copy_ms
    wall_ms = (t2 - t0) * 1e3
    _log("profile", f"bucket-2048 batch of 8: wall {wall_ms:.1f} ms "
         f"(dispatch {1e3 * (t1 - t0):.1f} ms, fetch to host "
         f"{1e3 * (t2 - t1):.1f} ms); on the card: kernels {kernel_ms:.1f} "
         f"ms ({100 * kernel_ms / wall_ms:.1f}% of wall), copies "
         f"{copy_ms:.1f} ms")
    for ms, count, key in rows[:12]:
        _log("profile", f"  {ms:9.2f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "dispatch_ms": 1e3 * (t1 - t0),
            "fetch_ms": 1e3 * (t2 - t1), "kernel_ms": kernel_ms,
            "copy_ms": copy_ms,
            "top": rows[:20]}


def phase_resnet_profile(resnet):
    """Device time of one ResNet-50 step by kernel class, with
    ``torch.profiler``; the Momentum ops are marked with a
    ``record_function`` range, whose device total is their kernels'."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import registry
    from torch.profiler import ProfilerActivity, profile, record_function
    exe = ptt.Executor()
    args = dict(feed=resnet["feed"], fetch_list=resnet["fetch"],
                scope=resnet["scope"])
    exe.run(resnet["main"], **args)
    torch.cuda.synchronize()
    info = registry.get_op_info("momentum")
    lower = info.lower

    def marked(ctx, ins, attrs):
        with record_function("momentum_op"):
            return lower(ctx, ins, attrs)

    info.lower = marked
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            exe.run(resnet["main"], **args)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        info.lower = lower
    # the range's own GPU-side row is a span, not a kernel: leave it out
    rows = [r for r in _profile_rows(prof) if r[2] != "momentum_op"]
    momentum_ms = sum(
        (getattr(e, "device_time_total", None) or
         getattr(e, "cuda_time_total", 0.0)) / 1e3
        for e in prof.key_averages() if e.key == "momentum_op"
        and not str(getattr(e, "device_type", "")).endswith("CUDA"))
    classes = {"K3 (conv1x1_stats)": 0.0, "cuDNN convolutions": 0.0,
               "GEMMs": 0.0, "copies": 0.0,
               "BN, elementwise, reductions, Momentum": 0.0}
    for ms, _, key in rows:
        k = key.lower()
        if "conv1x1_stats" in k or "stats_kernel" in k:
            cls = "K3 (conv1x1_stats)"
        elif k.startswith("memcpy") or k.startswith("memset"):
            cls = "copies"
        elif any(t in k for t in ("conv", "cudnn", "xmma", "dgrad", "wgrad",
                                  "fprop", "winograd", "implicit")):
            cls = "cuDNN convolutions"
        elif "gemm" in k or "cutlass" in k:
            cls = "GEMMs"
        else:
            cls = "BN, elementwise, reductions, Momentum"
        classes[cls] += ms
    kernel_ms = sum(v for c, v in classes.items() if c != "copies")
    _log("profile", f"ResNet-50 step, batch {RESNET_BATCH}: wall "
         f"{wall_ms:.1f} ms; kernels {kernel_ms:.1f} ms "
         f"({100 * kernel_ms / wall_ms:.1f}% of wall)")
    for cls, ms in classes.items():
        _log("profile", f"  {ms:9.2f} ms  {cls}")
    _log("profile", f"  of which Momentum's ops {momentum_ms:.2f} ms")
    for ms, count, key in rows[:24]:
        _log("profile", f"  {ms:9.2f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "classes": classes,
            "momentum_ms": momentum_ms, "top": rows[:40]}


def phase_train_profile(train):
    """Device time of one full-width training step by kernel, with
    ``torch.profiler``: where a step's time goes."""
    import torch
    import paddle_tpu_torch as ptt
    from torch.profiler import ProfilerActivity, profile
    exe = ptt.Executor()
    args = dict(feed=train["feed"], fetch_list=[train["loss"]],
                scope=train["scope"])
    exe.run(train["main"], **args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(train["main"], **args)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = _profile_rows(prof)
    kernel_ms = sum(r[0] for r in rows if not r[2].startswith("Memcpy"))
    _log("profile", f"training step, batch {TRAIN_BATCH} x seq 2048: wall "
         f"{wall_ms:.1f} ms; kernels {kernel_ms:.1f} ms "
         f"({100 * kernel_ms / wall_ms:.1f}% of wall)")
    for ms, count, key in rows[:24]:
        _log("profile", f"  {ms:9.2f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "top": rows[:40]}


def _bound(flops, nbytes, kind="float32"):
    import torch
    peak_flops, peak_bw = _peaks(torch.cuda.get_device_name(0), kind)
    t_ops, t_mem = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return (max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes",
            f"{flops / 1e9:.1f} GFLOP at {peak_flops / 1e12:.0f} TFLOP/s "
            f"{kind}, {nbytes / 1e6:.0f} MB at {peak_bw / 1e12:.2f} TB/s")


def timing_k3(smi, resnet):
    """K3 at each of ResNet-50's 15 shapes at the training batch: kernel,
    plain version, one library composition (a bf16 ``torch.matmul`` of the
    cast operands plus the two float32 reductions) and the bound (x, w, y
    and the stats moved once in float32; 2*N*P*Cin*Cout bf16 products at
    the tensor-core rate); then the per-step sums over the 36 launches."""
    import torch
    from paddle_tpu_torch.kernels import conv_bn as cb
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    counts = {sh: resnet["shapes"].count(sh) for sh in K3_SHAPES}
    if sum(counts.values()) != 36:
        raise AssertionError(f"fused shapes {resnet['shapes']} are not "
                             "ResNet-50's")
    n = RESNET_BATCH
    rows, totals = [], dict.fromkeys(("ms", "plain_ms", "library_ms",
                                      "bound_ms"), 0.0)
    by_bytes = 0.0          # the part of the summed bound set by bytes
    for ci, co, p in K3_SHAPES:
        x = torch.randn(n, ci, p, device="cuda", generator=g)
        w = torch.randn(co, ci, device="cuda", generator=g) * ci ** -0.5

        def library():
            y = torch.matmul(w.to(torch.bfloat16), x.to(torch.bfloat16))
            yf = y.float()
            return yf.sum(dim=(0, 2)), (yf * yf).sum(dim=(0, 2))

        ms = _time_ms(lambda: cb.conv1x1_stats_fwd(x, w), 10)
        plain_ms = _time_ms(lambda: cb.conv1x1_stats_plain(x, w), 3)
        library_ms = _time_ms(library, 10)
        flops = 2.0 * n * p * ci * co
        nbytes = 4.0 * (n * ci * p + co * ci + n * co * p + 2 * co)
        bound_ms, bound_by, why = _bound(flops, nbytes, "bfloat16")
        k = counts[(ci, co, p)]
        by_bytes += k * bound_ms if bound_by == "bytes" else 0.0
        rows.append({"shape": [n, ci, co, p], "per_step": k, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "tflops": flops / ms / 1e9})
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms),
                         ("bound_ms", bound_ms)):
            totals[key] += k * val
        _log("timing", f"conv1x1_stats [{n}, {ci}, {p}] x [{co}, {ci}] "
             f"(x{k} a step): kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
             f"TFLOP/s), plain {plain_ms:.4f} ms, bf16 matmul + sums "
             f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
             f"({why}): {100 * bound_ms / ms:.1f}% of bound")
        del x, w
    _log("timing", f"conv1x1_stats per ResNet-50 step (36 launches) on "
         f"{smi}: kernel {totals['ms']:.3f} ms, plain "
         f"{totals['plain_ms']:.3f} ms, bf16 matmul + sums "
         f"{totals['library_ms']:.3f} ms, bound {totals['bound_ms']:.3f} ms"
         f" ({100 * totals['bound_ms'] / totals['ms']:.1f}% of bound)")
    _log("timing", f"resnet on {smi}: step {resnet['step_ms']:.1f} ms (mean "
         f"of {RESNET_STEPS}), {resnet['images_per_s']:.1f} images/s, K3 "
         f"{100 * totals['ms'] / resnet['step_ms']:.1f}% of the step, peak "
         f"memory {resnet['peak_bytes'] / 2**30:.2f} GiB "
         f"({(resnet['peak_bytes'] - resnet['held_bytes']) / 2**30:.2f} GiB "
         f"above what was allocated before the first step)")
    bound_by = "bytes" if by_bytes >= totals["bound_ms"] / 2 \
        else "operations"
    return {"ms": totals["ms"], "plain_ms": totals["plain_ms"],
            "library_ms": totals["library_ms"],
            "bound_ms": totals["bound_ms"], "bound_by": bound_by,
            "per_shape": rows}


def phase_timing(smi, serve, train):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    bh, t, d = SLICE
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    q = torch.randn(bh, t, d, device="cuda", generator=g)
    k = torch.randn(bh, t, d, device="cuda", generator=g)
    v = torch.randn(bh, t, d, device="cuda", generator=g)
    do = torch.randn(bh, t, d, device="cuda", generator=g)
    pairs = t * (t + 1) // 2                 # live (q, k) pairs, causal
    out = {}

    # K1: q.k and p.v, 2 flops per FMA; q, k, v read, o and lse written
    ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, None, True), 20)
    plain_ms = _time_ms(
        lambda: fa.flash_attention_reference(q, k, v, None, True), 5)
    q4, k4, v4 = (x.view(8, 12, t, d) for x in (q, k, v))
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        20)
    bound_ms, bound_by, why = _bound(4.0 * d * bh * pairs,
                                     4.0 * (4 * bh * t * d + bh * t))
    out["flash_attn_fwd"] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": library_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by}
    _log("timing", f"flash_attn_fwd [96,2048,64] causal f32 on {smi}: "
         f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
         f"sdpa {library_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
         f"({why}): {100 * bound_ms / ms:.1f}% of bound")

    # K2: S, dP, dV, dK, dQ, 2 flops per FMA each; q, k, v, o, do, lse and
    # delta read, dq, dk, dv written
    o, lse = fa.flash_attention_fwd(q, k, v, None, True)
    ms = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True),
                  10)
    plain_ms = _time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, None, True), 3)
    qg, kg, vg = (x.view(8, 12, t, d).detach().requires_grad_()
                  for x in (q, k, v))
    do4 = do.view(8, 12, t, d)

    def sdpa_fwd():
        with torch.enable_grad():
            return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), do4)

    library_ms = _time_ms(sdpa_fwd_bwd, 10) - _time_ms(sdpa_fwd, 10)
    bound_ms, bound_by, why = _bound(10.0 * d * bh * pairs,
                                     4.0 * (8 * bh * t * d + 2 * bh * t))
    out["flash_attn_bwd"] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": library_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by}
    _log("timing", f"flash_attn_bwd [96,2048,64] causal f32 on {smi}: "
         f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward "
         f"{library_ms:.4f} ms (forward+backward minus forward); bound "
         f"{bound_ms:.4f} ms by {bound_by} ({why}): "
         f"{100 * bound_ms / ms:.1f}% of bound")

    per_batch = serve["launches"] / max(serve["flash_batches"], 1)
    _log("timing", f"flash launches per batch at buckets >= 1024: "
         f"{per_batch:g}")
    for b, lat in sorted(serve["per_bucket_ms"].items()):
        _log("timing", f"serve bucket {b}: {len(lat)} batches, batch "
             f"latency mean {np.mean(lat):.1f} ms (min {np.min(lat):.1f}, "
             f"max {np.max(lat):.1f})")
    _log("timing", f"serve: {serve['requests']} requests, "
         f"{serve['tokens']} tokens in {serve['wall_s']:.2f} s: "
         f"{serve['requests'] / serve['wall_s']:.2f} req/s, "
         f"{serve['tokens'] / serve['wall_s']:.0f} tokens/s")
    _log("timing", f"train on {smi}: step {train['step_ms']:.1f} ms (mean "
         f"of {TRAIN_STEPS}), {train['tokens_per_s']:.0f} tokens/s, peak "
         f"memory {train['peak_bytes'] / 2**30:.2f} GiB")
    return out


def timing_k45(smi, train, fused):
    """K5 at [16384, 768] x [768, 3072] with gelu and K4 forward and
    backward at [16384, 768], the fused path's shapes: kernel, plain
    version, one library composition and the bound; then the fused
    training step next to the plain one."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import dense_epilogue as de
    from paddle_tpu_torch.kernels import layer_norm as ln
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    rows, d, n = TRAIN_BATCH * 2048, 768, 3072
    per_step = fused["per_step"][-1]          # a timed step's launches
    out = {}

    # K5: 2·M·K·N bf16 products; x, w, b read and y written in float32
    x = torch.randn(rows, d, device="cuda", generator=g)
    w = torch.randn(d, n, device="cuda", generator=g) * d ** -0.5
    b = torch.randn(n, device="cuda", generator=g)
    ms = _time_ms(lambda: de.dense_act_fwd(x, w, b, "gelu"), 20)
    plain_ms = _time_ms(lambda: de.dense_act_plain(x, w, b, "gelu"), 5)
    library_ms = _time_ms(lambda: F.gelu(torch.matmul(
        x.to(torch.bfloat16), w.to(torch.bfloat16)).float() + b), 20)
    flops = 2.0 * rows * d * n
    bound_ms, bound_by, why = _bound(
        flops, 4.0 * (rows * d + d * n + n + rows * n), "bfloat16")
    out["dense_epilogue"] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": library_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by}
    _log("timing", f"dense_epilogue [{rows}, {d}] x [{d}, {n}] gelu f32 "
         f"({per_step['dense_epilogue']:g} a step) on {smi}: kernel "
         f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
         f"{plain_ms:.4f} ms, bf16 matmul + bias + gelu {library_ms:.4f} ms;"
         f" bound {bound_ms:.4f} ms by {bound_by} ({why}): "
         f"{100 * bound_ms / ms:.1f}% of bound")
    del x, w, b

    # K4: x read and y written (forward); x, dy read and dx written
    # (backward); scale, bias, dscale, dbias once each
    x = torch.randn(rows, d, device="cuda", generator=g)
    sc = torch.randn(d, device="cuda", generator=g) + 1
    bi = torch.randn(d, device="cuda", generator=g)
    dy = torch.randn(rows, d, device="cuda", generator=g)
    xg, sg, bg = (t.detach().requires_grad_() for t in (x, sc, bi))

    def lib_fwd():
        with torch.enable_grad():
            return F.layer_norm(xg, (d,), sg, bg, 1e-5)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (xg, sg, bg), dy)

    lib_f = _time_ms(lib_fwd, 20)
    for name, fn, plain, library, nbytes, flops in (
            ("layer_norm_fwd", lambda: ln.layer_norm_fwd(x, sc, bi, 1e-5),
             lambda: ln.layer_norm_fwd_plain(x, sc, bi, 1e-5), lib_f,
             4.0 * (2 * rows * d + 2 * d), 8.0 * rows * d),
            ("layer_norm_bwd", lambda: ln.layer_norm_bwd(x, sc, dy, 1e-5),
             lambda: ln.layer_norm_bwd_plain(x, sc, dy, 1e-5),
             _time_ms(lib_fwd_bwd, 20) - lib_f,
             4.0 * (3 * rows * d + 3 * d), 16.0 * rows * d)):
        ms = _time_ms(fn, 20)
        plain_ms = _time_ms(plain, 5)
        bound_ms, bound_by, why = _bound(flops, nbytes)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        lib_what = "F.layer_norm" + (" fwd+bwd minus fwd"
                                     if name.endswith("bwd") else "")
        _log("timing", f"{name} [{rows}, {d}] f32 ({per_step[name]:g} a "
             f"step) on {smi}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
             f"{lib_what} {library:.4f} ms; bound {bound_ms:.4f} ms by "
             f"{bound_by} ({why}): {100 * bound_ms / ms:.1f}% of bound")
    _log("timing", f"fused_train on {smi}: step {fused['step_ms']:.1f} ms "
         f"(mean of {TRAIN_STEPS}), {fused['tokens_per_s']:.0f} tokens/s, "
         f"peak memory {fused['peak_bytes'] / 2**30:.2f} GiB "
         f"({(fused['peak_bytes'] - fused['held_bytes']) / 2**30:.2f} GiB "
         f"above what was allocated before its first step); train: step "
         f"{train['step_ms']:.1f} ms, {train['tokens_per_s']:.0f} tokens/s, "
         f"peak {train['peak_bytes'] / 2**30:.2f} GiB "
         f"({(train['peak_bytes'] - train['held_bytes']) / 2**30:.2f} GiB "
         f"above)")
    return out


_KERNELS = (
    ("flash_attn_fwd", "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
     "paddle_tpu/pallas/flash_attention.py:179"),
    ("flash_attn_bwd", "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
     "paddle_tpu/pallas/flash_attention.py:499"),
    ("conv1x1_stats", "paddle_tpu_torch/csrc/conv1x1_stats.cu",
     "paddle_tpu/pallas/conv_bn.py:143"),
    ("layer_norm_fwd", "paddle_tpu_torch/csrc/layer_norm.cu",
     "paddle_tpu/pallas/layer_norm.py:92"),
    ("layer_norm_bwd", "paddle_tpu_torch/csrc/layer_norm.cu",
     "paddle_tpu/pallas/layer_norm.py:111"),
    ("dense_epilogue", "paddle_tpu_torch/csrc/dense_epilogue.cu",
     "paddle_tpu/pallas/dense_epilogue.py:69"),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write every measurement here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one bucket-2048 batch, one GPT "
                         "training step and one ResNet-50 step by kernel")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (the fused LM head) accumulate in float32 throughout
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    smi = phase_env()
    worst = phase_kernel()
    serve = phase_serve()
    train = phase_train()
    fused = phase_fused_train()
    resnet = phase_resnet()
    timing = phase_timing(smi, serve, train)
    timing["conv1x1_stats"] = timing_k3(smi, resnet)
    timing.update(timing_k45(smi, train, fused))
    k3_shapes = timing["conv1x1_stats"].pop("per_shape")
    prof = None
    if args.profile:
        prof = {"serve": phase_profile(serve),
                "train": phase_train_profile(train),
                "resnet": phase_resnet_profile(resnet)}
    by_path = {"flash_attn_fwd": {"serve": serve["launches"],
                                  "train": train["launches"]["flash_attn_fwd"],
                                  "fused_train":
                                  fused["launches"]["flash_attn_fwd"]},
               "flash_attn_bwd": {"train":
                                  train["launches"]["flash_attn_bwd"],
                                  "fused_train":
                                  fused["launches"]["flash_attn_bwd"]},
               "conv1x1_stats": {"resnet": resnet["launches"]}}
    for name in ("layer_norm_fwd", "layer_norm_bwd", "dense_epilogue"):
        by_path[name] = {"fused_train": fused["launches"][name]}
    kernels = [dict(name=name, route="cuda", source=src, replaces=ref,
                    launches=sum(by_path[name].values()),
                    launches_by_path=by_path[name],
                    max_abs_err=worst[name], **timing[name])
               for name, src, ref in _KERNELS]
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"gpu": smi, "kernels": kernels, "profile": prof,
                       "conv1x1_stats_shapes": k3_shapes,
                       "serve": {k: v for k, v in serve.items()
                                 if k not in ("scope", "factory")},
                       "train": {k: v for k, v in train.items()
                                 if k not in ("main", "loss", "scope",
                                              "feed")},
                       "fused_train": fused,
                       "resnet": {k: v for k, v in resnet.items()
                                  if k not in ("main", "fetch", "scope",
                                               "feed")}},
                      f, indent=1, default=float)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
