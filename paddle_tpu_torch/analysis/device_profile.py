"""Measured device-time attribution from captured profiler windows (the
port of ``paddle_tpu/analysis/device_profile.py``).

``profiler.SamplingProfiler`` captures ``torch.profiler`` windows
(``<window>/trace.json.gz``, a Kineto chrome trace); this module turns one
into attribution:

- **Trace parser** (:func:`parse_trace`): the chrome-trace JSON with its
  process and thread names.  Device work is the GPU processes' ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` events; host frames (``cpu_op``,
  ``python_function``, ``user_annotation``) and the ``cuda_runtime`` /
  ``cuda_driver`` calls never count as device time.
- **Step join** (:func:`step_intervals`): the executor wraps each step in a
  ``record_function`` range named ``paddle_tpu.step#<id>`` (its
  process-global step id, the one on its ``executor.dispatch`` span and in
  the window manifest).  Kineto writes the range on each GPU stream its
  kernels ran on as a ``gpu_user_annotation`` spanning them, so kernels
  attribute to steps by containment on the device clock.  A trace without
  a GPU (the host) has only the host ranges (``user_annotation``): steps
  then have spans and no device time.
- **Op-class attribution** (:func:`classify_kernel`): CUDA kernel names
  (the port's own, cuBLAS, cuDNN, NCCL, PyTorch's) map onto the reference's
  classes (matmul / conv / attention / embedding / collective / infeed /
  elementwise / other): per-step device ms, the idle fraction of the step
  span, per-class shares and **measured MFU** (analytic flops a step over
  the measured device-busy time x the card's peak), published as
  ``paddle_tpu_step_mfu_measured`` beside the executor's live gauge.
- :func:`summarize_and_publish`, the sampler's post-close hook, persists
  ``<window>/summary.json`` (shares, the measured-vs-analytic divergence
  table, the per-kernel wasted-roofline ranking) and never raises: a
  malformed capture warns and is counted.

The reference's XPlane reader (``read_xplane``, ``xplane_kernel_ms``) has no
counterpart: ``torch.profiler`` writes no XPlane.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

from .. import monitor as _monitor

__all__ = [
    "classify_kernel", "parse_trace", "step_intervals", "device_lanes",
    "kernels_by_step", "attribute", "summarize_window", "write_summary",
    "summarize_and_publish", "latest_profile_run", "MEASURED_CLASSES",
    "STEP_ANNOTATION", "step_annotation",
]

#: measured device-time classes, the attribution buckets kernels map to
MEASURED_CLASSES = ("matmul", "conv", "attention", "embedding",
                    "collective", "infeed", "elementwise", "other")

#: the executor's step range name; the step id follows the '#'
STEP_ANNOTATION = "paddle_tpu.step"
_STEP_RX = re.compile(r"^paddle_tpu\.step#(-?\d+)$")

#: chrome-trace categories of device work (Kineto)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

MFU_MEASURED_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_step_mfu_measured",
    "measured model-flops utilization in [0,1]: analytic flops/step "
    "over MEASURED per-step device-busy time x chip peak, from the last "
    "parsed profiler window — the companion of the analytic "
    "paddle_tpu_step_mfu gauge (divergence = dispatch-interval slack "
    "the analytic estimate cannot see)")
IDLE_FRAC_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_step_device_idle_frac",
    "measured idle/gap fraction of the step span (device lanes quiet) "
    "from the last parsed profiler window")
DEVICE_SHARE_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_step_device_time_share",
    "measured device-time share by op class from the last parsed "
    "profiler window — the MEASURED counterpart of the analytic "
    "paddle_tpu_step_flops_share", ("op_class",))
_SUMMARY_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_profile_summaries_total",
    "post-close window summaries by outcome (ok / empty / error)",
    ("outcome",))

#: wall time of the last successful publish
last_publish_wall = 0.0


def step_annotation(step_id: int) -> str:
    """The range name that carries ``step_id`` onto the device timeline."""
    return f"{STEP_ANNOTATION}#{int(step_id)}"


# ---------------------------------------------------------------------------
# kernel-name -> op-class attribution
# ---------------------------------------------------------------------------

#: ordered (regex, class) rules over demangled CUDA kernel names: the FIRST
#: match wins, so NCCL beats the 'reduce' in its kernel names, cuDNN's
#: implicit-GEMM convolutions beat 'gemm', and casts and layout passes
#: (the port's float32 split into bf16 term planes, ``sm90::
#: split_planes_kernel``; its operand rounding; cuDNN's batch norm and
#: NCHW/NHWC transposes) are elementwise before 'conv' or 'gemm' claim
#: them
_KERNEL_RULES: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(p, re.IGNORECASE), c) for p, c in (
        (r"nccl|all_?reduce|all_?gather|reduce_?scatter|all_?to_?all|"
         r"sendrecv", "collective"),
        (r"memcpy\s*(htod|dtoh)|host.?to.?device|device.?to.?host",
         "infeed"),
        (r"split_planes|round_pad|round_w_kernel|bn_fw|bn_bw|"
         r"nchw_?to_?nhwc|nhwc_?to_?nchw|nchw2nhwc|nhwc2nchw",
         "elementwise"),
        (r"flash|fmha|attention|attn|sdpa|\bmha|skeleton_(fwd|bwd)|"
         r"ring_merge", "attention"),
        # cuDNN's FFT convolutions: the transforms, the filter flip and
        # complex (cf32) GEMMs, which nothing else in a step launches
        (r"conv|fprop|dgrad|wgrad|implicit_?convolve|winograd|fft2d|"
         r"flip_filter|gemm_cf32", "conv"),
        (r"gemm|matmul|cublas|cutlass|xmma|nvjet|mm_stats|dense_act|"
         r"sm90g::", "matmul"),
        (r"gather|scatter|index_select|indexselect|embedding|index_put|"
         r"index_add|indexing|take", "embedding"),
        (r"elementwise|vectorized|unrolled|reduce|norm|dropout|softmax|"
         r"cast|copy|memcpy|memset|fill|cat_|catarray|where|gelu|relu|"
         r"sigmoid|tanh|exp|log|philox|adam|sgd|momentum|lamb|foreach|"
         r"stats_kernel|colsum|ln_fwd|ln_bwd|pow|sqrt|mul|add|sub|div|"
         r"max|min|sum|mean|transpose|permute|pad|arange|compare|clamp",
         "elementwise"),
    ))


def classify_kernel(name: str) -> str:
    """Map one CUDA kernel (or copy / memset) name to a measured op class.
    Unrecognized -> 'other'."""
    n = str(name).strip()
    for rx, cls in _KERNEL_RULES:
        if rx.search(n):
            return cls
    return "other"


# ---------------------------------------------------------------------------
# chrome-trace (Kineto) parsing
# ---------------------------------------------------------------------------

def parse_trace(path: str) -> Optional[Dict[str, Any]]:
    """Load one chrome-trace JSON (optionally gzipped) into
    ``{"events": [...], "processes": {pid: name},
    "threads": {(pid, tid): name}}``; each event keeps its ``cat``.
    Malformed or truncated files warn and return None — the post-close
    hook must never raise."""
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8",
                           errors="replace") as f:
                data = json.load(f)
        else:
            with open(path, encoding="utf-8", errors="replace") as f:
                data = json.load(f)
    except (OSError, EOFError, ValueError) as e:
        warnings.warn(f"device_profile: unreadable trace {path!r}: {e!r}")
        return None
    if not isinstance(data, dict):
        warnings.warn(f"device_profile: trace {path!r} is not an object")
        return None
    events = data.get("traceEvents")
    if not isinstance(events, list):
        warnings.warn(f"device_profile: trace {path!r} has no traceEvents")
        return None
    processes: Dict[Any, str] = {}
    threads: Dict[Tuple[Any, Any], str] = {}
    spans: List[Dict[str, Any]] = []
    for ev in events:
        if not isinstance(ev, dict):
            continue
        ph = ev.get("ph")
        if ph == "M":
            args = ev.get("args") or {}
            if ev.get("name") == "process_name":
                processes[ev.get("pid")] = str(args.get("name", ""))
            elif ev.get("name") == "thread_name":
                threads[(ev.get("pid"), ev.get("tid"))] = \
                    str(args.get("name", ""))
        elif ph == "X":
            try:
                ts = float(ev.get("ts", 0.0))
                dur = float(ev.get("dur", 0.0))
            except (TypeError, ValueError):
                continue
            spans.append({"name": str(ev.get("name", "")),
                          "cat": str(ev.get("cat", "")),
                          "pid": ev.get("pid"), "tid": ev.get("tid"),
                          "ts": ts, "dur": dur,
                          "args": ev.get("args") or {}})
    return {"events": spans, "processes": processes, "threads": threads}


def step_intervals(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Framework-step intervals from the ``paddle_tpu.step#<id>`` ranges:
    their device form (``gpu_user_annotation``) where the trace has one,
    else the host ranges.  One id on several streams collapses to the
    widest span.  Sorted by start time."""
    found: Dict[str, Dict[int, Tuple[float, float]]] = {}
    for ev in trace["events"]:
        m = _STEP_RX.match(ev["name"])
        if m is None:
            continue
        by_id = found.setdefault(
            "device" if ev["cat"] == "gpu_user_annotation" else "host", {})
        step = int(m.group(1))
        t0, t1 = ev["ts"], ev["ts"] + ev["dur"]
        if step in by_id:
            o0, o1 = by_id[step]
            by_id[step] = (min(t0, o0), max(t1, o1))
        else:
            by_id[step] = (t0, t1)
    by_id = found.get("device") or found.get("host") or {}
    return [{"step": s, "ts": t0, "dur": t1 - t0}
            for s, (t0, t1) in sorted(by_id.items(),
                                      key=lambda kv: kv[1][0])]


def device_lanes(trace: Dict[str, Any]) -> List[Tuple[Any, Any]]:
    """(pid, tid) lanes that carry device work: the GPU streams on which
    Kineto recorded kernels, copies or memsets."""
    return sorted({(ev["pid"], ev["tid"]) for ev in trace["events"]
                   if ev["cat"] in DEVICE_CATS}, key=repr)


def _union_ms(intervals: List[Tuple[float, float]]) -> float:
    """Total length (ms) of the union of [t0, t1) microsecond intervals
    — overlapping kernels on parallel lanes count once (wall busy time,
    the roofline's denominator), not summed."""
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur0, cur1 = intervals[0]
    for t0, t1 in intervals[1:]:
        if t0 > cur1:
            total += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    total += cur1 - cur0
    return total / 1e3


def _device_events(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [ev for ev in trace["events"]
            if ev["cat"] in DEVICE_CATS and ev["dur"] > 0]


def _step_of(steps, ev) -> Optional[int]:
    mid = ev["ts"] + ev["dur"] / 2.0
    for s in steps:
        if s["ts"] <= mid < s["ts"] + s["dur"]:
            return s["step"]
    return None


def kernels_by_step(trace: Dict[str, Any]) -> Dict[Optional[int], list]:
    """{step id (None: outside every step): [device events]}: each event
    joins the step whose span holds its midpoint."""
    steps = step_intervals(trace)
    out: Dict[Optional[int], list] = {}
    for ev in _device_events(trace):
        out.setdefault(_step_of(steps, ev), []).append(ev)
    return out


def attribute(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Attribute device time to framework steps and op classes (ref
    ``device_profile.py:266-342``, the same arithmetic).  Returns per-step
    rows (measured device ms, span ms, idle fraction, per-class ms),
    window-level per-class totals and shares, and the per-kernel
    aggregation the divergence table ranks."""
    steps = step_intervals(trace)
    kernels = _device_events(trace)

    per_kernel: Dict[str, Dict[str, Any]] = {}
    per_class_ms: Dict[str, float] = {}
    step_rows: List[Dict[str, Any]] = []
    unattributed_ms = 0.0

    by_step: Dict[Optional[int], List[dict]] = {}
    for ev in kernels:
        cls = classify_kernel(ev["name"])
        ms = ev["dur"] / 1e3
        k = per_kernel.setdefault(
            ev["name"], {"name": ev["name"], "op_class": cls,
                         "ms": 0.0, "count": 0})
        k["ms"] += ms
        k["count"] += 1
        per_class_ms[cls] = per_class_ms.get(cls, 0.0) + ms
        sid = _step_of(steps, ev)
        by_step.setdefault(sid, []).append(ev)
        if sid is None:
            unattributed_ms += ms

    for s in steps:
        evs = by_step.get(s["step"], [])
        busy = _union_ms([(max(e["ts"], s["ts"]),
                           min(e["ts"] + e["dur"], s["ts"] + s["dur"]))
                          for e in evs])
        span_ms = s["dur"] / 1e3
        cls_ms: Dict[str, float] = {}
        for e in evs:
            c = classify_kernel(e["name"])
            cls_ms[c] = cls_ms.get(c, 0.0) + e["dur"] / 1e3
        step_rows.append({
            "step": s["step"],
            "span_ms": round(span_ms, 6),
            "device_ms": round(busy, 6),
            "idle_frac": round(1.0 - busy / span_ms, 6)
            if span_ms > 0 else None,
            "per_class_ms": {c: round(v, 6)
                             for c, v in sorted(cls_ms.items())}})

    total_ms = sum(per_class_ms.values())
    share = {c: v / total_ms for c, v in per_class_ms.items()} \
        if total_ms > 0 else {}
    spans = [r["span_ms"] for r in step_rows if r["span_ms"] > 0]
    busy_in_steps = [r["device_ms"] for r in step_rows]
    idle = (1.0 - sum(busy_in_steps) / sum(spans)) if spans else None
    return {
        "steps": step_rows,
        "n_steps": len(step_rows),
        "per_class_ms": {c: round(v, 6)
                         for c, v in sorted(per_class_ms.items())},
        "per_class_share": {c: round(v, 6)
                            for c, v in sorted(share.items())},
        "device_ms_total": round(total_ms, 6),
        "unattributed_ms": round(unattributed_ms, 6),
        "idle_frac": round(idle, 6) if idle is not None else None,
        "kernels": sorted(
            ({**k, "ms": round(k["ms"], 6)} for k in per_kernel.values()),
            key=lambda k: -k["ms"]),
    }


# ---------------------------------------------------------------------------
# window summary: the persisted objective oracle
# ---------------------------------------------------------------------------

#: analytic cost-model classes folded into the measured buckets for the
#: divergence table (norm/softmax/reduce/optimizer are elementwise kernels
#: on the card)
_ANALYTIC_TO_MEASURED = {
    "matmul": "matmul", "conv": "conv", "attention": "attention",
    "embedding": "embedding",
}

_TRACE_NAMES = ("trace.json.gz", "trace.json")


def latest_profile_run(window_dir: str) -> Optional[str]:
    """The directory holding a window's trace: the window itself, where
    the sampler exports ``trace.json.gz`` (the reference's windows hold
    ``plugins/profile/<run>/`` directories instead); None when it holds no
    trace."""
    if any(os.path.isfile(os.path.join(window_dir, n))
           for n in _TRACE_NAMES):
        return window_dir
    return None


def summarize_window(window_dir: str,
                     flops_per_step: Optional[float] = None,
                     peak_flops: Optional[float] = None,
                     analytic_share: Optional[Dict[str, float]] = None,
                     ) -> Optional[Dict[str, Any]]:
    """Parse one captured window into the summary dict (the schema
    ``<window>/summary.json`` persists).  ``flops_per_step`` /
    ``peak_flops`` enable measured MFU; ``analytic_share`` (the
    ``paddle_tpu_step_flops_share`` per-class flop shares) enables the
    measured-vs-analytic divergence table and the per-kernel
    wasted-roofline-headroom ranking.  Warns and returns None when the
    window holds no parseable capture — never raises."""
    run = latest_profile_run(window_dir)
    if run is None:
        warnings.warn(f"device_profile: no trace under {window_dir!r}")
        return None
    trace = None
    trace_path = None
    for name in _TRACE_NAMES:
        cand = os.path.join(run, name)
        if not os.path.isfile(cand):
            continue
        trace = parse_trace(cand)
        if trace is not None:
            trace_path = cand
            break
    if trace is None:
        warnings.warn(f"device_profile: no parseable trace under {run!r}")
        return None
    summary: Dict[str, Any] = {
        "window": window_dir,
        "profile_run": run,
        "trace": os.path.basename(trace_path),
        **attribute(trace),
    }

    # measured MFU: analytic flops/step over measured device-busy time
    # per step x peak.  Steps with zero measured device time drop out
    # (a window tail can clip a step's kernels).
    busy = [r["device_ms"] for r in summary["steps"]
            if r["device_ms"] > 0]
    mfu_measured = None
    if busy and flops_per_step and peak_flops:
        mean_busy_s = sum(busy) / len(busy) / 1e3
        mfu_measured = flops_per_step / mean_busy_s / peak_flops
    spans = [r["span_ms"] for r in summary["steps"] if r["span_ms"] > 0]
    mfu_analytic = None
    if spans and flops_per_step and peak_flops:
        mfu_analytic = flops_per_step / (sum(spans) / len(spans) / 1e3) \
            / peak_flops
    summary["measured"] = {
        "flops_per_step": flops_per_step,
        "peak_flops": peak_flops,
        "mfu_measured": round(mfu_measured, 6)
        if mfu_measured is not None else None,
        "mfu_analytic_over_span": round(mfu_analytic, 6)
        if mfu_analytic is not None else None,
    }

    if analytic_share:
        summary["divergence"] = _divergence(
            summary, analytic_share, flops_per_step, peak_flops)
    return summary


def _divergence(summary: Dict[str, Any],
                analytic_share: Dict[str, float],
                flops_per_step: Optional[float],
                peak_flops: Optional[float]) -> Dict[str, Any]:
    """Measured-vs-analytic attribution: per-class time share against
    flop share (a class burning far more time than its flop share is
    memory/latency-bound — the fusion arc's candidate list), and the
    per-kernel wasted-roofline-headroom ranking (measured ms minus the
    roofline-minimum ms for the flops the class attributes to it),
    largest headroom first."""
    folded: Dict[str, float] = {}
    for cls, share in analytic_share.items():
        m = _ANALYTIC_TO_MEASURED.get(cls, "elementwise")
        folded[m] = folded.get(m, 0.0) + float(share)
    measured_share = summary.get("per_class_share", {})
    classes = sorted(set(folded) | set(measured_share))
    table = [{
        "op_class": c,
        "measured_time_share": round(measured_share.get(c, 0.0), 6),
        "analytic_flop_share": round(folded.get(c, 0.0), 6),
        "time_over_flop_ratio": round(
            measured_share.get(c, 0.0) / folded[c], 4)
        if folded.get(c, 0.0) > 0 else None,
    } for c in classes]

    ranking: List[Dict[str, Any]] = []
    n_steps = max(summary.get("n_steps") or 0, 1)
    per_class_ms = summary.get("per_class_ms", {})
    if flops_per_step and peak_flops:
        for k in summary.get("kernels", []):
            cls_ms = per_class_ms.get(k["op_class"], 0.0)
            # window-total class flops: kernel ms totals span the window
            cls_flops = flops_per_step * n_steps * \
                folded.get(k["op_class"], 0.0)
            # class flops attribute to kernels proportionally by time
            est_flops = cls_flops * (k["ms"] / cls_ms) if cls_ms > 0 \
                else 0.0
            ms_per_step = k["ms"] / n_steps
            ideal_ms = est_flops / n_steps / peak_flops * 1e3
            ranking.append({
                "kernel": k["name"], "op_class": k["op_class"],
                "ms_per_step": round(ms_per_step, 6),
                "est_flops_per_step": round(est_flops / n_steps, 3),
                "roofline_min_ms": round(ideal_ms, 6),
                "wasted_ms": round(ms_per_step - ideal_ms, 6),
            })
        ranking.sort(key=lambda r: -r["wasted_ms"])
    return {"per_class": table, "wasted_headroom": ranking}


def write_summary(window_dir: str, summary: Dict[str, Any]) -> str:
    """Persist ``<window>/summary.json`` atomically (tmp + replace)."""
    path = os.path.join(window_dir, "summary.json")
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=1, sort_keys=False)
    os.replace(tmp, path)
    return path


def _live_analytic() -> Tuple[Optional[float], Optional[float],
                              Dict[str, float]]:
    """(flops/step, peak flops, per-class flop share) from the gauges the
    executor publishes when it plans a program: the denominators the
    post-close hook joins to the captured window."""
    flops = peak = None
    fam = _monitor.REGISTRY.get("paddle_tpu_analytic_step_flops")
    if fam is not None:
        v = fam.value()
        if v:
            flops = float(v)
    try:
        from .cost import device_peak_flops
        peak = float(device_peak_flops())
    except Exception:
        peak = None
    share: Dict[str, float] = {}
    sfam = _monitor.REGISTRY.get("paddle_tpu_step_flops_share")
    if sfam is not None:
        for labels, cell in sfam.series():
            c = labels.get("op_class")
            if c:
                share[c] = float(cell.get())
    return flops, peak, share


def summarize_and_publish(window_dir: str) -> Optional[str]:
    """The SamplingProfiler post-close hook: parse the just-closed
    window, persist ``summary.json``, and publish the measured gauges —
    ``paddle_tpu_step_mfu_measured``, the idle fraction and the per-class
    device-time shares.  Returns the summary path, or None (warn + count)
    on any failure — this path must NEVER fail the training step."""
    global last_publish_wall
    try:
        flops, peak, share = _live_analytic()
        summary = summarize_window(window_dir, flops_per_step=flops,
                                   peak_flops=peak,
                                   analytic_share=share or None)
        if summary is None:
            _SUMMARY_CTR.inc(1, outcome="empty")
            return None
        path = write_summary(window_dir, summary)
        mfu = summary["measured"]["mfu_measured"]
        if mfu is not None:
            MFU_MEASURED_GAUGE.set(float(mfu))
        if summary["idle_frac"] is not None:
            IDLE_FRAC_GAUGE.set(float(summary["idle_frac"]))
        # stale classes zero out: the gauge reflects THIS window only
        for labels, cell in DEVICE_SHARE_GAUGE.series():
            cell.set(0.0)
        for c, v in summary["per_class_share"].items():
            DEVICE_SHARE_GAUGE.set(float(v), op_class=c)
        last_publish_wall = time.time()
        _SUMMARY_CTR.inc(1, outcome="ok")
        if _monitor.TRACER.enabled:
            _monitor.TRACER.instant(
                "profile.window_summary", "profile",
                {"window": window_dir, "mfu_measured": mfu,
                 "idle_frac": summary["idle_frac"],
                 "n_steps": summary["n_steps"]})
        return path
    except Exception as e:       # never fail the step/close path
        _SUMMARY_CTR.inc(1, outcome="error")
        warnings.warn(
            f"device_profile: window summary failed for "
            f"{window_dir!r}: {e!r}")
        return None
