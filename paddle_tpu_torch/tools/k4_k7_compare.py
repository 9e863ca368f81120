"""K4's backward and K7's merge through one checkout's kernels: a digest of
each output, the share that differ from the plain version, how far they
moved from another run's, and the kernels' times warm and cold.

    python3 paddle_tpu_torch/tools/k4_k7_compare.py [--root DIR]
        [--save PATH] [--against PATH] [--no-time] [--json PATH]

Runs on the card, each case on seeded inputs (the same in every checkout):

- ``ring_merge``: the merge at a ring step's shard of ``ring_train``
  ([24, 2048, 64]) and at d 12 ([6, 1000, 12]; bf16 rows of 24 bytes),
  float32 and bf16, with NEG_INF rows on either side and on both; outputs
  o and lse;
- ``layer_norm_bwd``: K4's backward at the fused paths' [16384, 768] and at
  [4099, 1000], float32 and bf16; outputs dx, dscale and dbias.

Each output's line gives its digest (two runs wrote the same bits where
their digests agree) and how many values differ from the plain version's.
``--save`` writes the outputs to a file, and ``--against`` reads another
run's file and gives, output by output, the share of values that moved
and by how many ulps of their type (so one call can hold a change's
outputs against its parent's).  Unless ``--no-time``, the merge at [24,
2048, 64] and the backward at [16384, 768] are timed on the card alone
(``timing.time_held``): warm, the same inputs call after call (they stay
in the 50 MB L2), and cold (:func:`cold_ms`: input sets of more than 50
MB in all, taken in turn).

The kernels come from the ``paddle_tpu_torch`` under ``--root`` (default:
the checkout holding this file); run this as a file, not with ``-m``, for
another checkout's.  It calls the wrappers as every checkout has them
(fresh outputs).  It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

#: (name, bh, tq, d) of the merge
MERGE_CASES = (("[24, 2048, 64]", 24, 2048, 64), ("[6, 1000, 12]", 6, 1000,
                                                   12))
#: (name, rows, d) of K4's backward
LN_CASES = (("[16384, 768]", 16384, 768), ("[4099, 1000]", 4099, 1000))
#: input sets of the cold timings: 6 x 19 MB (bf16 merge) and 3 x 50 MB
#: (bf16 K4 backward), each more than the 50 MB L2 in all
MERGE_SETS, LN_SETS = 6, 3


def cold_ms(calls, reps=3):
    """ms a call on the card alone with its inputs out of L2: ``calls``,
    each on its own input set (the sets more than the L2 in all), taken in
    turn after a warm call of each; the best of ``reps`` rounds of
    ``timing.time_held`` over three turns."""
    from paddle_tpu_torch.tools.timing import time_held
    for c in calls:
        c()
    turn = [0]

    def call():
        calls[turn[0] % len(calls)]()
        turn[0] += 1
    return 1e3 * min(time_held(call, runs=3 * len(calls))[0]
                     for _ in range(reps))


def warm_ms(call, reps=3):
    """ms a call on the card alone on the same inputs each time."""
    from paddle_tpu_torch.tools.timing import time_held
    call()
    return 1e3 * min(time_held(call)[0] for _ in range(reps))


def ulps(a, b):
    """The distance in ulps of their type between each value of the
    float32 or bf16 tensors ``a`` and ``b`` (as int64)."""
    import torch
    bits = 32 if a.dtype == torch.float32 else 16
    it = torch.int32 if bits == 32 else torch.int16
    sign = -(2 ** (bits - 1))

    def ordered(t):
        i = t.contiguous().view(it).to(torch.int64)
        # sign-magnitude to an order of the integers
        return torch.where(i < 0, sign - i, i)
    return (ordered(a) - ordered(b)).abs()


def _merge_inputs(bh, tq, d, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    o1, o2 = (torch.randn(bh, tq, d, device="cuda", generator=g).to(dtype)
              for _ in range(2))
    l1, l2 = (torch.randn(bh, tq, device="cuda", generator=g) * 4
              for _ in range(2))
    l1[:, : tq // 8] = -1e30                # masked on the left
    l2[:, tq // 16: tq // 4] = -1e30         # on the right, and on both
    return o1, l1, o2, l2


def _ln_inputs(rows, d, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, d, device="cuda", generator=g) * 2
         + 0.5).to(dtype)
    sc = torch.randn(d, device="cuda", generator=g) + 1
    dy = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    return x, sc, dy


def run(root, save=None, against=None, time_them=True):
    """One line per output of each case (and per timing); returns ``{case:
    {...}}``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import ring_attention as ra
    from paddle_tpu_torch.tools.gemm_flips import digest
    if not torch.cuda.is_available():
        raise RuntimeError("k4_k7_compare: no CUDA device")
    other = torch.load(against) if against else {}
    out, saved = {}, {}

    def report(case, names, got, ref):
        for name, g_, r_ in zip(names, got, ref):
            key = f"{case} {name}"
            n = int((g_ != r_).sum())
            rec = {"digest": digest(g_), "vs_plain": n, "total": g_.numel()}
            line = (f"{key}: digest {rec['digest']}, {n} of {g_.numel()} "
                    "differ from the plain version's")
            if key in other:
                o_ = other[key].to(g_.device)
                u = ulps(g_, o_)
                moved = int((u > 0).sum())
                top = float(o_.float().abs().max())
                # the largest move in ulps of the tensor's largest magnitude
                of_max = float((g_.float() - o_.float()).abs().max()) / (
                    2.0 ** (math.floor(math.log2(top))
                            - (7 if g_.dtype == torch.bfloat16 else 23))
                    if top > 0 else 1.0)
                rec.update(moved=moved, max_ulps=int(u.max()),
                           one_ulp=int((u == 1).sum()), max_ulps_of_max=of_max)
                line += (f"; against --against: {moved} "
                         f"({100 * moved / g_.numel():.4f}%) moved, "
                         f"{rec['one_ulp']} of them by one ulp, at most "
                         f"{int(u.max())} ulps of their own value and "
                         f"{of_max:.3g} of the largest magnitude")
            out[key] = rec
            saved[key] = g_.cpu()
            print(line, flush=True)

    bf16 = torch.bfloat16
    for dt, tag in ((torch.float32, "float32"), (bf16, "bf16")):
        for i, (name, bh, tq, d) in enumerate(MERGE_CASES):
            o1, l1, o2, l2 = _merge_inputs(bh, tq, d, dt, 500 + i)
            report(f"ring_merge {tag} {name}", ("o", "lse"),
                   ra.ring_merge(o1, l1, o2, l2),
                   ra.ring_merge_reference(o1, l1, o2, l2))
        for i, (name, rows, d) in enumerate(LN_CASES):
            x, sc, dy = _ln_inputs(rows, d, dt, 600 + i)
            report(f"layer_norm_bwd {tag} {name}", ("dx", "dscale", "dbias"),
                   ln.layer_norm_bwd(x, sc, dy, 1e-5),
                   ln.layer_norm_bwd_plain(x, sc, dy, 1e-5))
        torch.cuda.empty_cache()
    if save:
        torch.save(saved, save)
    if time_them:
        card = torch.cuda.get_device_name(0)
        for dt, tag in ((torch.float32, "float32"), (bf16, "bf16")):
            name, bh, tq, d = MERGE_CASES[0]
            sets = [_merge_inputs(bh, tq, d, dt, 700 + s)
                    for s in range(MERGE_SETS)]
            calls = [lambda s=s: ra.ring_merge(*s) for s in sets]
            t = {"warm_ms": warm_ms(calls[0]), "cold_ms": cold_ms(calls)}
            out[f"ring_merge {tag} {name} times"] = t
            print(f"ring_merge {tag} {name} on {card}: warm {t['warm_ms']:.4f}"
                  f" ms, cold {t['cold_ms']:.4f} ms", flush=True)
            del sets, calls
            name, rows, d = LN_CASES[0]
            sets = [_ln_inputs(rows, d, dt, 800 + s) for s in range(LN_SETS)]
            calls = [lambda s=s: ln.layer_norm_bwd(s[0], s[1], s[2], 1e-5)
                     for s in sets]
            t = {"warm_ms": warm_ms(calls[0]), "cold_ms": cold_ms(calls)}
            out[f"layer_norm_bwd {tag} {name} times"] = t
            print(f"layer_norm_bwd {tag} {name} on {card}: warm "
                  f"{t['warm_ms']:.4f} ms, cold {t['cold_ms']:.4f} ms",
                  flush=True)
            del sets, calls
            torch.cuda.empty_cache()
    print(f"kernels of {os.path.dirname(ra.__file__)}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return out


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose paddle_tpu_torch runs")
    ap.add_argument("--save", help="write the outputs here (torch.save)")
    ap.add_argument("--against", help="a --save file of another run")
    ap.add_argument("--no-time", action="store_true",
                    help="digests only, no timing")
    ap.add_argument("--json", help="also write the results here")
    args = ap.parse_args(argv)
    out = run(args.root, args.save, args.against, not args.no_time)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
