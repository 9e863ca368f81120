"""Bucketized shape plan: pad arbitrary request shapes onto a small set of
buckets, so the number of distinct programs the server runs is bounded by
the bucket count, not by the number of distinct request shapes (the port's
``paddle_tpu/serving/bucketing.py``).

A bucket is a sequence length; every feed of a request is padded along its
leading (per-example sequence) axis up to the bucket, and the batch is
padded to a fixed per-bucket width.  Fluid programs bake the sequence
length into op attrs (position-table slices, causal-mask ranges), so the
server materializes one program per bucket through a ``program_factory``.
Width admission (``bucketing.py:142-157``): under a memory budget a
bucket's batch width starts at ``max_batch`` and halves until the bucket
program's static peak plan (``analysis.memory``) fits it, and
``shrink_widths`` halves every built bucket's width (ref
``bucketing.py:159-178``), taking effect at the next batch.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .. import monitor as _monitor

BUCKET_WIDTH_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_serving_bucket_width",
    "admitted batch width per compile bucket (lowered below "
    "FLAGS_serving_max_batch when the static HBM plan at full width "
    "exceeds FLAGS_memory_budget_mb)", ("bucket",))
PAD_TOKENS_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_serving_padding_rows_total",
    "dummy batch rows dispatched to keep bucket shapes fixed (the "
    "occupancy complement: rows = batches*width - real requests)")


def parse_buckets(spec: str, max_len: int = 512) -> Tuple[int, ...]:
    """Bucket grammar: ``"16,32,64"`` explicit, ``"pow2:LO:HI"`` powers of
    two from LO to HI inclusive, ``""`` = powers of two from 8 up to
    ``max_len``."""
    spec = (spec or "").strip()
    if not spec:
        buckets, b = [], 8
        while b < max_len:
            buckets.append(b)
            b *= 2
        buckets.append(max_len)
        return tuple(sorted(set(buckets)))
    if spec.startswith("pow2:"):
        try:
            _, lo, hi = spec.split(":")
            lo, hi = int(lo), int(hi)
        except ValueError:
            raise ValueError(
                f"bad bucket spec {spec!r}: expected 'pow2:LO:HI'")
        if lo <= 0 or hi < lo:
            raise ValueError(f"bad bucket spec {spec!r}: need 0 < LO <= HI")
        buckets, b = [], lo
        while b < hi:
            buckets.append(b)
            b *= 2
        buckets.append(hi)
        return tuple(sorted(set(buckets)))
    try:
        buckets = tuple(sorted({int(tok) for tok in spec.split(",") if tok}))
    except ValueError:
        raise ValueError(
            f"bad bucket spec {spec!r}: expected comma-separated ints or "
            "'pow2:LO:HI'")
    if not buckets or any(b <= 0 for b in buckets):
        raise ValueError(f"bad bucket spec {spec!r}: buckets must be > 0")
    return buckets


def bucket_for(seq_len: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket that fits ``seq_len``; None when it exceeds the
    largest bucket (the request is rejected at admission, not truncated)."""
    for b in buckets:
        if seq_len <= b:
            return b
    return None


def pad_to_bucket(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Pad one per-example feed along its leading axis up to ``bucket``
    with zeros (0 is the [PAD] id).  Scalars and feeds already at the
    bucket pass through."""
    a = np.asarray(arr)
    if a.ndim == 0 or a.shape[0] == bucket:
        return a
    if a.shape[0] > bucket:
        raise ValueError(
            f"feed of length {a.shape[0]} exceeds bucket {bucket}")
    pad = [(0, bucket - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


class BucketPlan:
    """Per-bucket execution plan: the bucket program (built once through
    ``program_factory`` and wrapped in a CompiledProgram) plus the admitted
    batch width.  With ``memory_budget_mb`` > 0 the width starts at
    ``max_batch`` and halves until the bucket program's static peak at that
    width fits the budget: an over-budget bucket serves narrower batches
    instead of running out of card memory."""

    def __init__(self, buckets: Sequence[int],
                 program_factory: Callable[[int], tuple], max_batch: int,
                 memory_budget_mb: int = 0):
        self.buckets = tuple(sorted(buckets))
        self._factory = program_factory
        self._max_batch = max(1, int(max_batch))
        self._budget = int(memory_budget_mb)
        self._plans: Dict[int, tuple] = {}  # guarded-by: _mu
        self._mu = threading.Lock()

    def plan(self, bucket: int):
        """(compiled_program, feed_names, fetch_names, width) for one
        bucket — built on first use, memoized after."""
        with self._mu:
            entry = self._plans.get(bucket)
        if entry is not None:
            return entry
        from ..compiler import CompiledProgram
        program, feed_names, fetch_names = self._factory(bucket)
        feed_names = [getattr(f, "name", f) for f in feed_names]
        fetch_names = [getattr(f, "name", f) for f in fetch_names]
        width = self._admit_width(program, fetch_names)
        entry = (CompiledProgram(program), list(feed_names),
                 list(fetch_names), width)
        BUCKET_WIDTH_GAUGE.set(width, bucket=str(bucket))
        with self._mu:
            # first build wins: every caller dispatches the same program
            entry = self._plans.setdefault(bucket, entry)
        return entry

    def _admit_width(self, program, fetch_names) -> int:
        width = self._max_batch
        if self._budget <= 0:
            return width
        from ..analysis.memory import plan_memory
        budget_bytes = self._budget * (1 << 20)
        while width > 1:
            try:
                plan = plan_memory(program, tuple(fetch_names),
                                   batch_size=width)
            except Exception:
                return width        # planning must never block serving
            if plan.peak_bytes <= budget_bytes:
                return width
            width //= 2
        return width

    def shrink_widths(self) -> Dict[int, int]:
        """Halve the admitted width of every built bucket (floor 1): the
        degradation rung for a replica short of card memory.  The scheduler
        reads the width from the memoized entry at every batch, so the
        next batch runs at it (the executor builds one new plan for the
        new feed shape).  Cold buckets keep their planned width.  Returns
        {bucket: new width}."""
        out: Dict[int, int] = {}
        with self._mu:
            for bucket, entry in list(self._plans.items()):
                compiled, feeds, fetches, width = entry
                new = max(1, int(width) // 2)
                if new != width:
                    self._plans[bucket] = (compiled, feeds, fetches, new)
                out[bucket] = new
        for bucket, w in out.items():
            BUCKET_WIDTH_GAUGE.set(w, bucket=str(bucket))
        return out

    def width_of(self, bucket: int) -> Optional[int]:
        """Admitted width of a built bucket plan; None for a cold bucket
        (statusz never triggers a build)."""
        with self._mu:
            entry = self._plans.get(int(bucket))
        return entry[3] if entry is not None else None

    def static_peak_of(self, bucket: int) -> Optional[int]:
        """Static peak (bytes) of a built bucket program at its admitted
        width (fingerprint-cached); None for a cold bucket or on a planner
        failure."""
        with self._mu:
            entry = self._plans.get(int(bucket))
        if entry is None:
            return None
        compiled, _feeds, fetch_names, width = entry
        try:
            from ..analysis.memory import plan_memory
            return int(plan_memory(compiled.program, tuple(fetch_names),
                                   batch_size=width).peak_bytes)
        except Exception:
            return None

    def bucket_for(self, seq_len: int) -> Optional[int]:
        return bucket_for(seq_len, self.buckets)
