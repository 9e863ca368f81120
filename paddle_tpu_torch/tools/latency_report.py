"""Offline request-latency phase decomposition from an exported trace (the
port of ``tools/latency_report.py``).

Reads the chrome trace ``monitor.export`` writes and answers "where does the
p99 live": for every tenant x bucket, the per-phase p50/p99 over the request
chains of the serving plane (``serving.admit / queue_wait / batch_wait /
dispatch / decode / materialize``), the end-to-end quantiles and the
padding share carried on the dispatch spans.

Spans without tenant/bucket tags fall into an ``untagged`` group, and a
trace with no serving chains at all is chained by the step id the executor
stamps on its ``executor.dispatch`` / ``fetch.materialize`` spans, so a
training run's trace gives a dispatch/materialize decomposition.

    python -m paddle_tpu_torch.tools.latency_report trace.json
    python -m paddle_tpu_torch.tools.latency_report trace.json --json
    python -m paddle_tpu_torch.tools.latency_report trace.json --tenant t

It reads only the file, so it runs anywhere after the server is gone (the
live view of the same numbers is ``paddle_tpu_serving_phase_ms`` on
``/metrics``).  The output equals the reference tool's on the same file.
"""

import argparse
import json
import sys

#: canonical phase order (a chain uses the subset its path emits: the
#: batch path has batch_wait+dispatch, the decode path has decode)
PHASES = ("admit", "queue_wait", "batch_wait", "dispatch", "decode",
          "materialize")

#: group name for chains whose spans carry no tenant/bucket tags
#: (executor-only traces, foreign serving spans)
UNTAGGED = "untagged"

#: executor span name -> phase it contributes to an untagged step chain
_EXECUTOR_PHASES = {"executor.dispatch": "dispatch",
                    "fetch.materialize": "materialize"}


def load_chains(path):
    """trace json -> {(pid, chain_id): {"tenant", "bucket", "phases":
    {phase: ms}, "e2e_ms", "pad_frac"}} for every serving.* chain PLUS
    an untagged chain per executor step (see module docstring).
    Trace/step ids are only PROCESS-unique (per-process counters), so a
    multi-rank merged gang trace is keyed on (pid, id) — two ranks'
    request 1 must not fuse into one chain."""
    with open(path) as f:
        data = json.load(f)
    events = data if isinstance(data, list) else data.get(
        "traceEvents", [])
    chains = {}
    executor_chains = {}
    for ev in events:
        name = str(ev.get("name", ""))
        args = ev.get("args") or {}
        if ev.get("ph") != "X":
            continue
        if name.startswith("serving.") and "trace" in args:
            phase = name[len("serving."):]
            if phase not in PHASES:
                continue
            # spans without tenant/bucket tags (foreign emitters, older
            # exports) fall back to the untagged group instead of being
            # silently mislabeled or dropped
            dst = chains
            key = (ev.get("pid"), args["trace"])
            tenant = str(args.get("tenant", UNTAGGED))
            bucket = str(args.get("bucket", UNTAGGED))
        elif name in _EXECUTOR_PHASES and "step" in args:
            # executor-ONLY decomposition: chain dispatch+materialize by
            # the step id the executor stamps on both spans.  Collected
            # separately and used only when the trace has NO serving
            # chains — a serving trace's executor spans are the same
            # milliseconds its serving.dispatch/materialize phases
            # already attribute, and double-counting them would inflate
            # the report
            dst = executor_chains
            phase = _EXECUTOR_PHASES[name]
            key = (ev.get("pid"), f"step:{args['step']}")
            tenant = bucket = UNTAGGED
        else:
            continue
        c = dst.setdefault(key, {
            "tenant": tenant, "bucket": bucket,
            "phases": {}, "e2e_ms": None, "pad_frac": None})
        c["phases"][phase] = c["phases"].get(phase, 0.0) \
            + ev.get("dur", 0.0) / 1e3
        if phase == "materialize" and "e2e_ms" in args:
            c["e2e_ms"] = float(args["e2e_ms"])
        if phase == "dispatch" and "pad_frac" in args:
            c["pad_frac"] = float(args["pad_frac"])
    if not chains:
        chains = executor_chains
        for c in chains.values():
            if c["e2e_ms"] is None and c["phases"]:
                # executor chains carry no submit->resolve envelope;
                # the recorded phases ARE the chain, so their sum is
                # the honest end-to-end (otherwise report() would drop
                # the chain as in-flight)
                c["e2e_ms"] = sum(c["phases"].values())
    return chains


def _pct(sorted_vals, q):
    """Nearest-rank percentile: smallest value with at least q of the
    sample at or below it."""
    if not sorted_vals:
        return None
    import math
    return sorted_vals[max(math.ceil(q * len(sorted_vals)) - 1, 0)]


def report(chains, tenant=None, bucket=None):
    """Aggregate chains -> per (tenant, bucket) phase decomposition."""
    groups = {}
    incomplete = 0
    for c in chains.values():
        if tenant is not None and c["tenant"] != tenant:
            continue
        if bucket is not None and c["bucket"] != bucket:
            continue
        if c["e2e_ms"] is None:        # chain never materialized: the
            incomplete += 1            # request was in flight at export
            continue
        groups.setdefault((c["tenant"], c["bucket"]), []).append(c)
    out = []
    for (ten, buck), cs in sorted(groups.items()):
        row = {"tenant": ten, "bucket": buck, "requests": len(cs),
               "phases": {}}
        for ph in PHASES:
            vals = sorted(c["phases"][ph] for c in cs
                          if ph in c["phases"])
            if vals:
                row["phases"][ph] = {"p50_ms": round(_pct(vals, 0.5), 3),
                                     "p99_ms": round(_pct(vals, 0.99), 3)}
        e2e = sorted(c["e2e_ms"] for c in cs)
        row["e2e"] = {"p50_ms": round(_pct(e2e, 0.5), 3),
                      "p99_ms": round(_pct(e2e, 0.99), 3)}
        pads = sorted(c["pad_frac"] for c in cs
                      if c["pad_frac"] is not None)
        if pads:
            row["pad_frac_p50"] = round(_pct(pads, 0.5), 4)
        out.append(row)
    return {"groups": out, "total_requests": sum(
        r["requests"] for r in out), "in_flight_at_export": incomplete}


def render(rep):
    lines = []
    hdr = (f"{'TENANT':<12} {'BUCKET':>7} {'N':>5}  "
           + "".join(f"{ph + ' p50/p99':>22}" for ph in PHASES)
           + f"{'e2e p50/p99':>22} {'PAD':>6}")
    lines.append(hdr)
    lines.append("-" * len(hdr))

    def fmt(d):
        if d is None:
            return f"{'-':>22}"
        return f"{d['p50_ms']:>10.2f}/{d['p99_ms']:<11.2f}"

    for r in rep["groups"]:
        pad = f"{r['pad_frac_p50']:.0%}" if "pad_frac_p50" in r else "-"
        lines.append(
            f"{r['tenant']:<12} {r['bucket']:>7} {r['requests']:>5}  "
            + "".join(fmt(r["phases"].get(ph)) for ph in PHASES)
            + fmt(r["e2e"]) + f"{pad:>6}")
    lines.append(f"{rep['total_requests']} request(s) in "
                 f"{len(rep['groups'])} tenant x bucket group(s)"
                 + (f"; {rep['in_flight_at_export']} in flight at export"
                    if rep["in_flight_at_export"] else ""))
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="p50/p99 phase decomposition per tenant/bucket "
                    "from an exported serving trace")
    p.add_argument("trace", help="chrome trace json (monitor.export)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--tenant", default=None, help="filter by tenant")
    p.add_argument("--bucket", default=None,
                   help="filter by bucket ('decode' for the KV loop)")
    args = p.parse_args(argv)
    rep = report(load_chains(args.trace), tenant=args.tenant,
                 bucket=args.bucket)
    if args.as_json:
        json.dump(rep, sys.stdout, indent=1, sort_keys=True)
        print()
    else:
        print(render(rep))
    return 0 if rep["total_requests"] else 2


if __name__ == "__main__":
    sys.exit(main())
