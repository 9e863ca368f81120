"""The numerics plane (the port of ``paddle_tpu/analysis/numerics.py``):
per-step tensor-health statistics, the anomaly engine and the checkpoint
quarantine.

- **Step statistics** (:class:`StepStats`, :func:`build_step_stats`):
  behind ``FLAGS_numerics`` (``off`` | ``sentinel`` | ``full``) the
  executor folds each step's statistics into one small packed float32
  vector with the reference's layout (:class:`StatsLayout`).  ``sentinel``
  counts poisoned gradient and weight-state tensors and sums the global
  grad norm at one reduction a tensor; ``full`` adds per-variable grad
  norms, absmax and element-exact non-finite counts, weight-update ratios
  (‖Δw‖/‖w‖), activation absmax and log2 dynamic-range histograms.  The
  reference computes them inside its jitted step; the eager executor hands
  each value to :class:`StepStats` when it lets go of it (a temporary after
  its last reader, the rest at the end of the step) and reduces what it
  was handed in multi-tensor batches (``torch._foreach_norm``), so a
  sentinel step adds a few launches, not one per gradient.  The vector
  stays on the card; :class:`StatsCopy` moves it to pinned host memory
  behind the step's work with a non-blocking copy and an event.

- **The engine** (:class:`NumericsEngine`, the process ``ENGINE``): decodes
  a frame only once its copy's event has completed (or a bounded backlog
  forces it, counted), trips on NaN/Inf (latched per episode), detects
  grad-norm spikes against a windowed median with hysteresis, fires
  ``numerics.anomaly`` tracer instants, opens a profiler window
  (``trigger: "anomaly"``) and quarantines the checkpoint plane: once a
  step is poisoned, ``resilience.CheckpointDaemon`` holds its captures.

- **Surfaces**: per-variable gauges ``paddle_tpu_numerics_{grad_norm,
  update_ratio,absmax}`` over a bounded top-K of series,
  ``paddle_tpu_numerics_nonfinite_total{var_class}`` and
  ``paddle_tpu_numerics_anomalies_total{kind}``.
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import monitor as _monitor

__all__ = [
    "MODES", "mode", "configure", "build_step_stats", "StatsLayout",
    "StepStats", "StatsCopy", "NumericsFrame", "NumericsEngine", "ENGINE",
    "record_anomaly", "note_nonfinite", "poisoned_since", "is_poisoned",
    "clear_quarantine", "plan_numerics", "loss_fingerprint",
]

MODES = ("off", "sentinel", "full")

#: per-variable sections in full mode: the largest tensors, at most this many
MAX_TRACED_VARS = 32

#: log2 dynamic-range histogram bins: floor(log2|x|) clipped to
#: [_HIST_LO, _HIST_HI]
_HIST_LO, _HIST_HI = -20, 11
HIST_BINS = _HIST_HI - _HIST_LO + 1

# -- metric families (ref numerics.py:82-126) --------------------------------

NUM_GNORM_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_numerics_grad_norm",
    "per-variable gradient L2 norm of the most recent processed step "
    "(top-K by norm; churn folds out so the registry stays bounded)",
    ("var",))
NUM_UPDATE_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_numerics_update_ratio",
    "per-variable weight-update ratio ‖Δw‖/‖w‖ of the most recent "
    "processed step (top-K by ratio) — the classic LR-sanity signal "
    "(healthy training sits around 1e-3)", ("var",))
NUM_ABSMAX_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_numerics_absmax",
    "per-variable gradient absmax of the most recent processed step "
    "(top-K; the bf16/int8 overflow headroom signal)", ("var",))
NUM_GLOBAL_GNORM_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_numerics_global_grad_norm",
    "global gradient L2 norm (sqrt of the sum over EVERY grad var, "
    "traced or not) of the most recent processed step — the heartbeat "
    "digest's 'gnorm' key")
NUM_RANGE_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_numerics_dynamic_range_bits",
    "occupied log2 dynamic range (highest - lowest populated exponent "
    "bin) of the most recent step's histogram, by class — the signal a "
    "blockwise-int8 quantization policy reads for scale headroom",
    ("var_class",))
NONFINITE_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_numerics_nonfinite_total",
    "non-finite (NaN/Inf) observations by variable class (grad / act / "
    "weight / logits): ELEMENT counts in full mode and the serving "
    "logits sentinel, poisoned-TENSOR counts in sentinel mode — the "
    "heartbeat digest's 'nanf' key", ("var_class",))
ANOMALY_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_numerics_anomalies_total",
    "numerics anomaly records by kind (nonfinite / grad_spike / "
    "nonfinite_logits / loss_scale_* / step_skipped)", ("kind",))
FORCED_SYNC_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_numerics_forced_syncs_total",
    "stats frames materialized by the backlog bound instead of the "
    "ready-poll — nonzero means the lazy path fell behind and the "
    "training thread paid a host sync")
QUARANTINE_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_checkpoint_quarantine_holds_total",
    "checkpoint captures held back because the numerics engine has the "
    "step quarantined (poisoned state must not advance the manifest)")

# -- configuration (FLAGS_numerics*; flags.set_flags calls configure) --------

_CONFIG = {
    "mode": "off",
    "spike_factor": 10.0,
    "window": 16,
    "topk": 8,
    "quarantine": True,
}


def mode() -> str:
    """The active ``FLAGS_numerics`` mode (the executor's plan key)."""
    return _CONFIG["mode"]


def configure(mode: str, spike_factor: Optional[float] = None,
              window: Optional[int] = None, topk: Optional[int] = None,
              quarantine: Optional[bool] = None) -> None:
    if mode not in MODES:
        raise ValueError(
            f"FLAGS_numerics must be one of {MODES}, got {mode!r}")
    _CONFIG["mode"] = mode
    if spike_factor is not None:
        _CONFIG["spike_factor"] = float(spike_factor)
    if window is not None:
        _CONFIG["window"] = max(int(window), 4)
    if topk is not None:
        _CONFIG["topk"] = max(int(topk), 1)
    if quarantine is not None:
        _CONFIG["quarantine"] = bool(quarantine)


# -- the compiler's census slot (ref numerics.py:169-214) --------------------

_plan_cache: Dict[Any, Dict[str, Any]] = {}
_plan_lock = threading.Lock()


def plan_numerics(program, fetch_names=()) -> Dict[str, Any]:
    """The float activations a full-mode step may trace in the (post-fusion)
    program: ``{"acts": sorted names}``.  ``CompiledProgram._optimized``
    stamps it into ``program._attrs["numerics"]`` after fusion; the step's
    statistics intersect it with what the step wrote.  Grads and weight
    state always trace.  Fingerprint-cached."""
    key = (program.fingerprint(), tuple(fetch_names))
    with _plan_lock:
        plan = _plan_cache.get(key)
        if plan is not None:
            return plan
    block = program.global_block()
    acts = []
    written = set()
    for op in block.ops:
        if op.type in ("feed", "fetch"):
            continue
        for n in op.output_arg_names():
            if not n or n in written:
                continue
            written.add(n)
            if not block.has_var(n):
                continue
            v = block.var(n)
            dt = str(getattr(v, "dtype", "") or "")
            if "float" not in dt and "bf16" not in dt:
                continue
            if not n.endswith("@GRAD") and not v.persistable:
                acts.append(n)
    plan = {"acts": sorted(acts)}
    with _plan_lock:
        if len(_plan_cache) > 256:
            _plan_cache.clear()
        _plan_cache.setdefault(key, plan)
    return plan


# -- the step's statistics ---------------------------------------------------

class StatsLayout:
    """Host-side description of one packed stats vector (the reference's
    layout, slot for slot).

    Header (both modes): ``[nonfinite_grad, nonfinite_act,
    nonfinite_weight, global_gnorm_sq, grad_absmax, act_absmax]``.  The
    weight-state scan matters beside the grad scan: a NaN'd weight can hide
    from the backward (``relu_grad`` masks on ``x > 0``, and ``NaN > 0`` is
    False) while the persisted state is poisoned.  ``full`` appends 3
    floats a traced grad (``gnorm_sq, absmax, nonfinite``), 2 a traced
    weight (``wnorm_sq, dnorm_sq``), then the grad and act histograms
    (:data:`HIST_BINS` bins each)."""

    HEADER = 6

    def __init__(self, mode: str, grads: Tuple[str, ...] = (),
                 weights: Tuple[str, ...] = ()):
        self.mode = mode
        self.grads = tuple(grads)
        self.weights = tuple(weights)

    @property
    def size(self) -> int:
        if self.mode != "full":
            return self.HEADER
        return (self.HEADER + 3 * len(self.grads)
                + 2 * len(self.weights) + 2 * HIST_BINS)


def _is_float(v) -> bool:
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _norms(tensors: List[torch.Tensor], ord: float) -> List[torch.Tensor]:
    """float32 ``ord``-norms of the tensors, one multi-tensor reduction a
    dtype (``torch._foreach_norm``: on the card one fused launch and its
    cleanup over up to ~100 tensors).  No scaling, so a sum of squares
    that overflows float32 comes back infinite, as the reference's
    ``sum(square(x))`` does."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    groups: Dict[Any, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        ns = torch._foreach_norm([tensors[i] for i in idx], ord,
                                 dtype=torch.float32)
        for i, n in zip(idx, ns):
            out[i] = n
    return out


def _absmax(t: torch.Tensor) -> torch.Tensor:
    """max |x| in float32 (NaN propagates, as ``jnp.max`` does)."""
    if t.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=t.device)
    return t.detach().abs().amax().float()


def _nonfinite(t: torch.Tensor) -> torch.Tensor:
    return (~torch.isfinite(t)).sum().float()


def _exp_hist_into(hist: torch.Tensor, t: torch.Tensor) -> None:
    """Add ``t``'s finite nonzero elements to the log2 histogram ``hist``
    (int64): bin = clip(floor(log2|x|), lo, hi).  One scatter-add a
    tensor, with no host sync (full-mode cost, by design)."""
    ax = t.detach().reshape(-1).float().abs()
    ok = torch.isfinite(ax) & (ax > 0)
    e = torch.floor(torch.log2(torch.where(ok, ax, torch.ones_like(ax))))
    idx = (e.clamp_(_HIST_LO, _HIST_HI) - _HIST_LO).long()
    part = torch.zeros(HIST_BINS, dtype=torch.int32, device=t.device)
    part.index_add_(0, idx, ok.to(torch.int32))
    hist += part


class StepStats:
    """One step's tensor-health statistics, gathered as the step hands its
    values over (the reference's ``build_step_stats`` over the value
    environment of its traced step, ``numerics.py:286-429``).

    ``offer(name, tensor)`` takes a value the step wrote: a float
    ``@GRAD`` always, a float activation (not fed, not read-write
    persistable, rank >= 1, in the compiler's census when there is one) in
    full mode.  Offered tensors wait in a batch that is reduced once it
    holds :attr:`FLUSH_BYTES`, so the statistics keep a temporary alive at
    most that many bytes past its last reader.  :meth:`finish` reduces the
    rest and the weight state and packs the vector."""

    FLUSH_BYTES = 256 << 20

    def __init__(self, mode: str, written, feed_names=(), persist_rw=(),
                 spec: Optional[Dict[str, Any]] = None):
        self.mode = mode
        self._full = mode == "full"
        self._written = written
        self._skip_act = set(feed_names) | set(persist_rw)
        allowed = set((spec or {}).get("acts", ()))
        self._allowed = allowed or None
        self._batch: List[Tuple[str, torch.Tensor, bool]] = []
        self._batch_bytes = 0
        self._seen = set()
        # name -> 0-d float32 tensors: [gnorm_sq] or [gnorm_sq, absmax, nf]
        self._grads: Dict[str, List[torch.Tensor]] = {}
        self._grad_size: Dict[str, int] = {}
        self._acts: Dict[str, List[torch.Tensor]] = {}   # [absmax, nf]
        self._hist: Dict[str, torch.Tensor] = {}         # "grad" / "act"

    def offer(self, name: str, t) -> None:
        if name in self._seen or name not in self._written \
                or not _is_float(t):
            return
        if name.endswith("@GRAD"):
            is_grad = True
        elif (self._full and name not in self._skip_act and t.dim() >= 1
              and (self._allowed is None or name in self._allowed)):
            is_grad = False
        else:
            return
        self._seen.add(name)
        self._batch.append((name, t, is_grad))
        self._batch_bytes += t.numel() * t.element_size()
        if self._batch_bytes >= self.FLUSH_BYTES:
            self._flush()

    def _hist_of(self, cls: str, device) -> torch.Tensor:
        h = self._hist.get(cls)
        if h is None:
            h = self._hist[cls] = torch.zeros(HIST_BINS, dtype=torch.int64,
                                              device=device)
        return h

    def _flush(self) -> None:
        pend, self._batch, self._batch_bytes = self._batch, [], 0
        grads = [(n, t) for n, t, g in pend if g]
        if grads:
            norms = _norms([t for _, t in grads], 2)
            for (n, t), nrm in zip(grads, norms):
                self._grad_size[n] = t.numel()
                self._grads[n] = [nrm, _absmax(t), _nonfinite(t)] \
                    if self._full else [nrm]
                if self._full:
                    _exp_hist_into(self._hist_of("grad", t.device), t)
        for n, t, g in pend:
            if not g:
                self._acts[n] = [_absmax(t), _nonfinite(t)]
                _exp_hist_into(self._hist_of("act", t.device), t)

    def finish(self, persist_rw=(), rw_in=(), rw_out=(),
               device=None, force: bool = False):
        """``(layout, packed)``, or ``(None, None)`` when the step had
        nothing to observe (a startup program) and ``force`` is off;
        forcing gives an all-zero header."""
        self._flush()
        f32 = torch.float32
        grad_names = sorted(self._grads)
        act_names = sorted(self._acts)
        weight_pairs = []
        if self._full:
            for n, old, new in zip(persist_rw, rw_in, rw_out):
                if (_is_float(new) and _is_float(old)
                        and old.shape == new.shape
                        and (n + "@GRAD") in self._written):
                    weight_pairs.append((n, old, new))
        state_vals = [v for v in rw_out if _is_float(v)]
        if not grad_names and not act_names and not weight_pairs \
                and not state_vals and not force:
            return None, None
        if device is None:
            device = next((v[0].device for v in list(self._grads.values())
                           + list(self._acts.values())),
                          state_vals[0].device if state_vals
                          else torch.device("cpu"))
        zero = torch.zeros((), dtype=f32, device=device)

        def col(xs):
            return torch.stack(xs) if xs else zero.reshape(1)[:0]

        # each tensor's sum of squares, squared from its norm after the
        # stack (one launch, not one a gradient)
        gsq = col([self._grads[n][0] for n in grad_names]).square()
        if not self._full:
            # one reduction a tensor: NaN/Inf propagate through the norms,
            # so the nonfinite slots count poisoned TENSORS here
            state = col(_norms(state_vals, 1) if state_vals else [])
            header = [(~torch.isfinite(gsq)).sum().to(f32), zero,
                      (~torch.isfinite(state)).sum().to(f32),
                      gsq.sum(), zero, zero]
            return StatsLayout("sentinel"), torch.stack(header)
        g_amax = col([self._grads[n][1] for n in grad_names])
        g_nf = col([self._grads[n][2] for n in grad_names])
        a_amax = col([self._acts[n][0] for n in act_names])
        a_nf = col([self._acts[n][1] for n in act_names])
        header = [
            g_nf.sum(), a_nf.sum(),
            col([_nonfinite(v) for v in state_vals]).sum(),
            gsq.sum(),
            g_amax.amax() if grad_names else zero,
            a_amax.amax() if act_names else zero,
        ]
        # per-variable sections for the largest tensors, in the
        # reference's order (size desc, name asc)
        order = sorted(range(len(grad_names)),
                       key=lambda i: (-self._grad_size[grad_names[i]],
                                      grad_names[i]))[:MAX_TRACED_VARS]
        parts = [torch.stack(header)]
        if order:
            traced = [self._grads[grad_names[i]] for i in order]
            parts.append(torch.stack(
                [col([g[0] for g in traced]).square(),
                 col([g[1] for g in traced]),
                 col([g[2] for g in traced])], dim=1).reshape(-1))
        worder = sorted(range(len(weight_pairs)),
                        key=lambda i: (-weight_pairs[i][2].numel(),
                                       weight_pairs[i][0]))[:MAX_TRACED_VARS]
        if worder:
            news = [weight_pairs[i][2] for i in worder]
            diffs = [(weight_pairs[i][2].float() - weight_pairs[i][1].float())
                     for i in worder]
            parts.append(torch.stack([col(_norms(news, 2)),
                                      col(_norms(diffs, 2))],
                                     dim=1).square().reshape(-1))
        layout = StatsLayout("full", tuple(grad_names[i] for i in order),
                             tuple(weight_pairs[i][0] for i in worder))
        for c in ("grad", "act"):
            h = self._hist.get(c)
            parts.append(h.to(f32) if h is not None
                         else torch.zeros(HIST_BINS, dtype=f32,
                                          device=device))
        return layout, torch.cat(parts)


def build_step_stats(values: Dict[str, Any], written, feed_names,
                     persist_rw, rw_in, rw_out, mode: str,
                     spec: Optional[Dict[str, Any]] = None,
                     force: bool = False):
    """``(layout, packed)`` over a step's whole value environment (the
    reference's signature, ``numerics.py:286``): every written value is
    offered, in name order, then the weight state is reduced."""
    st = StepStats(mode, set(written), feed_names, persist_rw, spec)
    for n in sorted(written):
        v = values.get(n)
        if v is not None:
            st.offer(n, v)
    return st.finish(persist_rw, rw_in, rw_out, force=force)


#: pinned host buffers of decoded frames, by length, for the next copies:
#: a step's copy then allocates nothing (a fresh pinned allocation is a
#: driver call of up to milliseconds)
_PINNED: Dict[int, List[torch.Tensor]] = {}
_PINNED_MU = threading.Lock()
_PINNED_KEEP = 16


class StatsCopy:
    """A packed stats vector on its way to the host.  On the card: a
    non-blocking copy into a pinned host buffer queued behind the step, and
    an event recorded after it, so reading the frame never syncs the
    training thread once the event has completed.  On the host the vector
    is already there."""

    __slots__ = ("host", "event", "shape")

    def __init__(self, vec: torch.Tensor):
        # a collective step's vector is [nranks, L]: one row a rank
        self.shape = tuple(vec.shape)
        if vec.is_cuda:
            n = vec.numel()
            with _PINNED_MU:
                free = _PINNED.get(n)
                host = free.pop() if free else None
            if host is None:
                host = torch.empty(n, dtype=torch.float32, pin_memory=True)
            host.view(self.shape).copy_(vec, non_blocking=True)
            self.host = host
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(vec.device))
        else:
            self.host = vec.detach()
            self.event = None

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        """The vector as float64 (a copy), once the copy has landed; the
        pinned buffer goes back to the pool."""
        if self.event is None:
            return self.host.numpy().astype(np.float64)
        self.event.synchronize()
        out = self.host.numpy().astype(np.float64).reshape(self.shape)
        with _PINNED_MU:
            free = _PINNED.setdefault(out.size, [])
            if len(free) < _PINNED_KEEP:
                free.append(self.host)
        self.host = None
        return out


# -- the host-side frame (ref numerics.py:436-505) ---------------------------

class NumericsFrame:
    """One step's unpacked tensor-health statistics."""

    __slots__ = ("step", "nonfinite_grad", "nonfinite_act",
                 "nonfinite_weight", "global_gnorm",
                 "grad_absmax", "act_absmax", "grads", "weights",
                 "grad_hist", "act_hist")

    def __init__(self, step: int, vec: np.ndarray, layout: StatsLayout):
        if vec.ndim == 2:
            # per-rank stacked frames: counts and hists SUM, absmax MAXes,
            # norms average
            v = vec.astype(np.float64)
            vec = np.where(
                np.isfinite(v).all(0), v.mean(0), np.float64("nan"))
            h = StatsLayout.HEADER
            for i in (0, 1, 2):
                vec[i] = v[:, i].sum()
            vec[4] = v[:, 4].max()
            vec[5] = v[:, 5].max()
            if layout.mode == "full":
                vec[-2 * HIST_BINS:] = v[:, -2 * HIST_BINS:].sum(0)
                for i in range(len(layout.grads)):
                    vec[h + 3 * i + 1] = v[:, h + 3 * i + 1].max()
                    vec[h + 3 * i + 2] = v[:, h + 3 * i + 2].sum()
        vec = np.asarray(vec, np.float64)
        self.step = int(step)
        self.nonfinite_grad = float(np.nan_to_num(vec[0], nan=1.0))
        self.nonfinite_act = float(np.nan_to_num(vec[1], nan=1.0))
        self.nonfinite_weight = float(np.nan_to_num(vec[2], nan=1.0))
        gsq = float(vec[3])
        self.global_gnorm = (float(np.sqrt(gsq)) if np.isfinite(gsq)
                             and gsq >= 0 else float("nan"))
        self.grad_absmax = float(vec[4])
        self.act_absmax = float(vec[5])
        self.grads: Dict[str, Dict[str, float]] = {}
        self.weights: Dict[str, Dict[str, float]] = {}
        self.grad_hist = self.act_hist = None
        if layout.mode == "full":
            off = StatsLayout.HEADER
            for n in layout.grads:
                sq, amax, nf = vec[off:off + 3]
                off += 3
                self.grads[n] = {
                    "norm": (float(np.sqrt(sq)) if np.isfinite(sq)
                             and sq >= 0 else float("nan")),
                    "absmax": float(amax), "nonfinite": float(nf)}
            for n in layout.weights:
                wsq, dsq = vec[off:off + 2]
                off += 2
                ratio = (float(np.sqrt(dsq / wsq))
                         if wsq > 0 and np.isfinite(wsq)
                         and np.isfinite(dsq) else 0.0)
                self.weights[n] = {
                    "wnorm": float(np.sqrt(max(wsq, 0.0))),
                    "update_ratio": ratio}
            self.grad_hist = vec[off:off + HIST_BINS]
            self.act_hist = vec[off + HIST_BINS:off + 2 * HIST_BINS]

    @property
    def nonfinite(self) -> float:
        return (self.nonfinite_grad + self.nonfinite_act
                + self.nonfinite_weight)

    @staticmethod
    def range_bits(hist) -> int:
        """Occupied log2 dynamic range of a histogram (0 = empty)."""
        nz = np.nonzero(np.asarray(hist) > 0)[0]
        return int(nz[-1] - nz[0] + 1) if nz.size else 0


# -- anomaly records (ref numerics.py:513-556) -------------------------------

def record_anomaly(kind: str, step: Optional[int] = None,
                   var: Optional[str] = None,
                   value: Optional[float] = None,
                   detail: Optional[Dict[str, Any]] = None,
                   instant: str = "numerics.anomaly",
                   capture: bool = False,
                   quarantine: bool = False) -> Dict[str, Any]:
    """Append one anomaly record (the one format every numerics event uses:
    engine trips, AMP loss-scale moves, the decode logits sentinel): bumps
    ``paddle_tpu_numerics_anomalies_total{kind}``, emits the tracer
    instant, optionally opens a profiler window (``trigger: "anomaly"``)
    and/or quarantines the checkpoint plane.  Returns the record."""
    rec: Dict[str, Any] = {"kind": kind, "t": time.time()}
    if step is not None:
        rec["step"] = int(step)
    if var is not None:
        rec["var"] = str(var)
    if value is not None:
        try:
            rec["value"] = float(value)
        except (TypeError, ValueError):
            rec["value"] = repr(value)
    if detail:
        rec.update(detail)
    ANOMALY_CTR.inc(1, kind=kind)
    if _monitor.TRACER.enabled:
        _monitor.TRACER.instant(instant, "numerics", dict(rec))
    ENGINE._note_record(rec, capture=capture, quarantine=quarantine)
    return rec


def note_nonfinite(var_class: str, n: int, step: Optional[int] = None,
                   detail: Optional[Dict[str, Any]] = None) -> None:
    """A sentinel outside the step (the decode loop counts non-finite
    logits here): bumps the class counter and emits one anomaly record an
    episode (latched until a clean ``n == 0`` observation)."""
    NONFINITE_CTR.inc(int(n), var_class=var_class)
    if int(n) > 0:
        ENGINE._class_trip(var_class, int(n), step=step, detail=detail)
    else:
        with ENGINE._mu:
            ENGINE._class_tripped.discard(var_class)


# -- the engine (ref numerics.py:563-805) ------------------------------------

class NumericsEngine:
    """Turns stats frames into anomaly records, gauges and quarantine
    state.  A frame is decoded only once its copy reports ready
    (:meth:`StatsCopy.is_ready`) or the bounded backlog forces it (counted
    in ``paddle_tpu_numerics_forced_syncs_total``)."""

    MAX_BACKLOG = 8
    MAX_RECORDS = 256

    def __init__(self):
        self._mu = threading.Lock()
        self._pending: collections.deque = collections.deque()  # guarded-by: _mu
        self._windows: Dict[str, collections.deque] = {}  # guarded-by: _mu
        self._armed: Dict[str, bool] = {}  # guarded-by: _mu
        self._published: set = set()       # guarded-by: _mu
        self._published_w: set = set()     # guarded-by: _mu
        self._class_tripped: set = set()   # guarded-by: _mu
        self._poisoned_since: Optional[int] = None  # guarded-by: _mu
        self._nf_cells = {
            c: NONFINITE_CTR.labels(var_class=c)
            for c in ("grad", "act", "weight")}
        self.anomalies: collections.deque = collections.deque(
            maxlen=self.MAX_RECORDS)
        self.frames_processed = 0
        self.last_frame: Optional[NumericsFrame] = None

    # -- executor side -------------------------------------------------------
    def note_step(self, step_id: int, stats: "StatsCopy",
                  layout: StatsLayout) -> None:
        """Queue one step's stats and decode whatever is ready; never
        waits."""
        with self._mu:
            self._pending.append((int(step_id), stats, layout))
        self.poll()

    def poll(self, force: bool = False) -> int:
        """Decode ready frames; ``force=True`` waits for every pending one
        (the checkpoint quarantine gate and tests; never the step's path).
        Returns the number of frames processed."""
        done = 0
        while True:
            with self._mu:
                if not self._pending:
                    return done
                step_id, stats, layout = self._pending[0]
                overflow = len(self._pending) > self.MAX_BACKLOG
                if not force and not overflow and not stats.is_ready():
                    return done
                self._pending.popleft()
            if overflow and not force:
                FORCED_SYNC_CTR.inc()
            self._process(NumericsFrame(step_id, stats.numpy(), layout))
            done += 1

    # -- frame processing ----------------------------------------------------
    def _process(self, frame: NumericsFrame) -> None:
        self.frames_processed += 1
        self.last_frame = frame
        if np.isfinite(frame.global_gnorm):
            NUM_GLOBAL_GNORM_GAUGE.set(round(frame.global_gnorm, 6))
        self._nf_cells["grad"].inc(int(frame.nonfinite_grad))
        if frame.nonfinite_act:
            self._nf_cells["act"].inc(int(frame.nonfinite_act))
        if frame.nonfinite_weight:
            self._nf_cells["weight"].inc(int(frame.nonfinite_weight))
        if frame.grad_hist is not None:
            NUM_RANGE_GAUGE.set(frame.range_bits(frame.grad_hist),
                                var_class="grad")
            NUM_RANGE_GAUGE.set(frame.range_bits(frame.act_hist),
                                var_class="act")
        # the NaN/Inf sentinel, latched per episode
        bad = frame.nonfinite > 0 or not np.isfinite(frame.global_gnorm)
        if bad:
            cls = ("weight" if frame.nonfinite_weight
                   else "grad" if frame.nonfinite_grad
                   or not np.isfinite(frame.global_gnorm) else "act")
            self._class_trip(
                cls, int(frame.nonfinite), step=frame.step,
                # absmax exists in full mode only
                detail=({"grad_absmax": frame.grad_absmax,
                         "act_absmax": frame.act_absmax}
                        if frame.grad_hist is not None else None),
                in_graph=True)
        else:
            with self._mu:
                self._class_tripped -= {"grad", "act", "weight"}
        if frame.grads:
            self._publish_vars(frame)
            self._detect_spikes(frame)

    def _publish_vars(self, frame: NumericsFrame) -> None:
        k = _CONFIG["topk"]
        top = sorted(frame.grads,
                     key=lambda n: -np.nan_to_num(
                         frame.grads[n]["norm"], nan=np.inf))[:k]
        wtop = sorted(frame.weights,
                      key=lambda n: -frame.weights[n]["update_ratio"])[:k]
        with self._mu:
            stale = self._published - set(top)
            stale_w = self._published_w - set(wtop)
            self._published = set(top)
            self._published_w = set(wtop)
        # churned-out variables drop their series
        for n in stale:
            NUM_GNORM_GAUGE.fold({"var": n}, None)
            NUM_ABSMAX_GAUGE.fold({"var": n}, None)
        for n in stale_w:
            NUM_UPDATE_GAUGE.fold({"var": n}, None)
        for n in top:
            g = frame.grads[n]
            NUM_GNORM_GAUGE.set(round(np.nan_to_num(
                g["norm"], nan=-1.0), 6), var=n)
            NUM_ABSMAX_GAUGE.set(round(np.nan_to_num(
                g["absmax"], nan=-1.0), 6), var=n)
        for n in wtop:
            NUM_UPDATE_GAUGE.set(
                round(frame.weights[n]["update_ratio"], 8), var=n)

    def _detect_spikes(self, frame: NumericsFrame) -> None:
        factor = _CONFIG["spike_factor"]
        wlen = _CONFIG["window"]
        for n, g in frame.grads.items():
            v = g["norm"]
            if not np.isfinite(v):
                continue             # the sentinel already tripped
            with self._mu:
                win = self._windows.get(n)
                if win is None or win.maxlen != wlen:
                    win = self._windows[n] = collections.deque(
                        list(win or ()), maxlen=wlen)
                    if len(self._windows) > 4 * MAX_TRACED_VARS:
                        # variable churn across programs must not grow
                        # the window table forever
                        for dead in list(self._windows)[
                                :len(self._windows) // 2]:
                            if dead not in frame.grads:
                                del self._windows[dead]
                                self._armed.pop(dead, None)
                med = (sorted(win)[len(win) // 2] if win else None)
                armed = self._armed.get(n, True)
                fire = recover = False
                if med is not None and med > 0 and len(win) >= 4:
                    if v > factor * med:
                        if armed:
                            fire = True
                            self._armed[n] = False
                        # the window freezes while tripped, so a spiking
                        # norm cannot drag the median up to its level
                    else:
                        win.append(v)
                        if not armed and v <= (factor / 2.0) * med:
                            recover = self._armed[n] = True
                else:
                    win.append(v)
                med_out = med
            if fire:
                record_anomaly(
                    "grad_spike", step=frame.step, var=n, value=v,
                    detail={"median": round(float(med_out), 6),
                            "factor": factor}, capture=True)
            elif recover and _monitor.TRACER.enabled:
                _monitor.TRACER.instant(
                    "numerics.recovered", "numerics",
                    {"var": n, "step": frame.step, "value": v})

    # -- anomaly plumbing ----------------------------------------------------
    def _class_trip(self, var_class: str, n: int,
                    step: Optional[int] = None,
                    detail: Optional[Dict[str, Any]] = None,
                    in_graph: bool = False) -> None:
        with self._mu:
            first = var_class not in self._class_tripped
            self._class_tripped.add(var_class)
        if first:
            record_anomaly(
                "nonfinite" if in_graph else f"nonfinite_{var_class}",
                step=step, var=var_class, value=n, detail=detail,
                capture=True,
                quarantine=in_graph
                and var_class in ("grad", "act", "weight"))

    def _note_record(self, rec: Dict[str, Any], capture: bool,
                     quarantine: bool) -> None:
        self.anomalies.append(rec)
        if quarantine and _CONFIG["quarantine"]:
            with self._mu:
                if self._poisoned_since is None:
                    self._poisoned_since = int(rec.get("step", 0) or 0)
                    poisoned = self._poisoned_since
                else:
                    poisoned = None
            if poisoned is not None and _monitor.TRACER.enabled:
                _monitor.TRACER.instant(
                    "numerics.quarantine", "numerics",
                    {"since_step": poisoned, "kind": rec.get("kind")})
        if capture:
            from ..profiler import SAMPLER
            SAMPLER.trigger_window(rec.get("step"), trigger="anomaly")

    # -- quarantine ----------------------------------------------------------
    def poisoned_since(self) -> Optional[int]:
        with self._mu:
            return self._poisoned_since

    def clear_quarantine(self) -> None:
        """Operator action: the poisoned state was rolled back, so the
        checkpoint plane may commit again."""
        with self._mu:
            self._poisoned_since = None
            self._class_tripped.clear()

    def reset(self) -> None:
        """Full state reset (tests, phase isolation)."""
        with self._mu:
            self._pending.clear()
            self._windows.clear()
            self._armed.clear()
            self._published.clear()
            self._published_w.clear()
            self._class_tripped.clear()
            self._poisoned_since = None
        self.anomalies.clear()
        self.frames_processed = 0
        self.last_frame = None


ENGINE = NumericsEngine()


def poisoned_since() -> Optional[int]:
    return ENGINE.poisoned_since()


def is_poisoned() -> bool:
    return ENGINE.poisoned_since() is not None


def clear_quarantine() -> None:
    ENGINE.clear_quarantine()


def loss_fingerprint(losses, decimals: int = 5) -> str:
    """sha1 over the rounded loss trajectory: the gate that the statistics
    never perturb the training math (equal across ``FLAGS_numerics``
    modes)."""
    a = np.round(np.asarray(list(losses), np.float64), decimals)
    return hashlib.sha1(a.tobytes()).hexdigest()
