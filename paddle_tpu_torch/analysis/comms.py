"""Collective-communication observability: the static comms plan and its
runtime measurement (the port of ``paddle_tpu/analysis/comms.py``).

- **Static comms plan** (:func:`plan_comms`): walk the dependency-ordered
  ``framework.ir`` Graph, price every ``c_*`` collective with its payload
  bytes and the ring algorithm-bandwidth model (an allreduce moves
  ``2(n-1)/n`` of its bytes a rank, allgather / reduce-scatter / broadcast
  ``(n-1)/n``), and divide by :func:`device_link_bandwidth` for an analytic
  comm time; against the cost plan's compute time that gives a static
  comm-vs-compute verdict.  Cached on the program fingerprint; the verifier
  stamps it into ``program._attrs["verify"]["comms"]`` and folds its
  fingerprint into the collective fingerprint.

- **Runtime measurement** (:class:`CommsMonitor`, fed by the executor's
  collective mode): every collective step is a ``collective.launch``.  The
  executor bumps the byte counters synchronously after a dispatch that did
  not fail and hands the step's record to the monitor, whose background
  thread waits for it off the training thread and publishes
  ``paddle_tpu_collective_ms{op,signature}``, the wait histogram, the
  windowed ``paddle_tpu_comm_step_ms`` / ``paddle_tpu_comm_wait_ms`` /
  ``paddle_tpu_collective_bus_bw`` gauges the heartbeat digest reads
  (``comm_ms`` / ``comm_wait`` / ``comm_bw``), and a ``collective.launch``
  tracer span with ``{signature, bytes, wait_ms, step_id}``.

  Wire time: the reference's collectives are fused into one XLA step, so
  it apportions the step's measured time by the plan's analytic comm
  share.  The port's collectives are launches of their own, run between
  the ranks' segments, so the executor times the collective segment
  itself (from before the first collective to after the last): with CUDA
  events on the card, the host clock on the CPU.  The record's probe is
  the event after the last collective.

- The straggler wait comes from the gang coordinator's ``comm_gate`` (the
  executor's ``_comm_gate_wait``: each rank posts its arrival and reads
  its peers'); with no gang attached the wait is 0, exactly as in the
  reference.

Gating: ``FLAGS_comms_telemetry`` (default on).
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import monitor as _monitor
from ..framework.core import Block, Program

__all__ = [
    "CollectiveCost", "CommsPlan", "plan_comms", "clear_cache",
    "device_link_bandwidth", "CommsMonitor", "MONITOR",
]

# -- metric families (the reference's names, comms.py:89-134) ----------------

COLLECTIVE_MS_HIST = _monitor.REGISTRY.histogram(
    "paddle_tpu_collective_ms",
    "measured per-collective wire time (ms) per dispatched collective "
    "step: the collective segment's time apportioned across its "
    "collectives by wire bytes", ("op", "signature"),
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
             50.0, 100.0, 250.0, 500.0, 1000.0, 5000.0, 30000.0))
COLLECTIVE_BYTES_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_collective_bytes_total",
    "collective payload bytes launched (static-plan bytes accounted per "
    "dispatched collective step)", ("op", "signature"))
COLLECTIVE_WAIT_HIST = _monitor.REGISTRY.histogram(
    "paddle_tpu_collective_wait_ms",
    "straggler wait per collective step (ms): max peer arrival skew "
    "measured by the pre-collective coordinator timestamp exchange "
    "(0 with no gang attached — all local ranks arrive together)",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
             50.0, 100.0, 250.0, 500.0, 1000.0, 5000.0, 30000.0))
COMM_BW_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_collective_bus_bw",
    "measured algorithm bandwidth over the device link peak, in [0,1] "
    "(windowed median; digest key 'comm_bw')")
COMM_STEP_MS_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_comm_step_ms",
    "measured comm time per collective step (ms), wait + wire "
    "(windowed median; digest key 'comm_ms')")
COMM_WAIT_MS_GAUGE = _monitor.REGISTRY.gauge(
    "paddle_tpu_comm_wait_ms",
    "straggler-wait part of paddle_tpu_comm_step_ms (ms; windowed "
    "median; digest key 'comm_wait')")
COMMS_DROPPED_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_comms_records_dropped_total",
    "collective launch records dropped because the comms monitor's "
    "bounded queue was full (byte counters are bumped synchronously "
    "and stay exact; only the timing sample is lost)")
COMMS_GATE_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_comms_gate_total",
    "pre-collective coordinator timestamp exchanges by outcome "
    "('released', 'partial', 'error', 'disabled')", ("outcome",))

#: op type -> fraction of the payload each rank moves over the wire.
#: Ring algorithms: allreduce = reduce-scatter + allgather = 2(n-1)/n;
#: allgather / reduce-scatter / broadcast (ring pipeline) = (n-1)/n;
#: c_split is a local slice (no wire traffic).
_ALGO_FACTOR = {
    "c_allreduce_sum": lambda n: 2.0 * (n - 1) / n,
    "c_allreduce_max": lambda n: 2.0 * (n - 1) / n,
    "c_allreduce_min": lambda n: 2.0 * (n - 1) / n,
    # prod gathers, then multiplies locally (collective_ops)
    "c_allreduce_prod": lambda n: (n - 1) / n,
    "c_allgather": lambda n: (n - 1) / n,
    "c_reducescatter": lambda n: (n - 1) / n,
    "c_broadcast": lambda n: (n - 1) / n,
    "c_split": lambda n: 0.0,
}

#: NVLink bytes/s one card sends, by card name: half of the bidirectional
#: per-GPU NVLink figure of NVIDIA's data sheets (H100 / H200 SXM: 900
#: GB/s over 18 NVLink 4 links; H100 PCIe and NVL: 600 GB/s over the
#: NVLink bridge).  Longest key first.
NVLINK_BW = (("H100 PCIe", 300e9), ("H100 NVL", 300e9), ("H100", 450e9),
             ("H200", 450e9))

#: the host's nominal "wire" (the reference's smoke constant)
HOST_LINK_BW = 1e10


def device_link_bandwidth(device=None) -> float:
    """Peak link bytes/s a card sends: the one peak that divides both the
    static plan's comm estimate and the live ``paddle_tpu_collective_bus_bw``
    gauge (the ``cost.device_peak_flops`` discipline).  A CUDA card takes
    its NVLink figure from :data:`NVLINK_BW` by name; the host, and a card
    the table does not know, get the reference's nominal 1e10.

    Virtual ranks on one card (a ``dp`` mesh of ``[cuda:0] * n``) move
    their collective bytes through the card's own memory, not a link, so
    there ``paddle_tpu_collective_bus_bw`` is not a link measurement."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return HOST_LINK_BW
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return HOST_LINK_BW
    name = torch.cuda.get_device_name(device)
    return next((bw for key, bw in NVLINK_BW if key in name), HOST_LINK_BW)


_ITEMSIZE = {"bfloat16": 2, "float16": 2, "bool": 1}


def _itemsize(dtype) -> int:
    d = str(dtype or "float32")
    if d in _ITEMSIZE:
        return _ITEMSIZE[d]
    try:
        return int(np.dtype(d).itemsize)
    except TypeError:
        return 4


@dataclass(frozen=True)
class CollectiveCost:
    """One collective's static price at the resolved batch."""

    #: block path ("0" = top block; loop bodies e.g. "0/while@5/1")
    path: str
    #: dependency-order position within its block
    pos: int
    op: str
    ring_id: int
    dtype: str
    shape: Tuple[int, ...]
    #: logical payload bytes (numel x itemsize at the resolved batch)
    payload_bytes: int
    #: bytes each rank moves over the wire (payload x algorithm factor)
    wire_bytes: int
    #: analytic wire time at link peak (ms)
    est_ms: float

    @property
    def signature(self) -> str:
        """Compact label-safe signature (the {signature} metric label)."""
        dims = "x".join(str(d) for d in self.shape) or "scalar"
        return f"{self.op}:r{self.ring_id}:{self.dtype}:{dims}"


@dataclass
class CommsPlan:
    """Analytic per-step comms model of one program (see module doc)."""

    nranks: int = 1
    link_bw: float = HOST_LINK_BW
    batch_size: int = 1
    collectives: List[CollectiveCost] = field(default_factory=list)
    #: total logical payload bytes per step across collectives
    payload_bytes: int = 0
    #: total per-rank wire bytes per step (algorithm-model traffic)
    wire_bytes: int = 0
    #: analytic comm time per step at link peak (ms)
    est_ms: float = 0.0
    #: analytic compute time per step at the card's peak (ms; 0.0 when
    #: cost planning failed)
    compute_ms: float = 0.0
    #: sha1 over (nranks, ordered (path, op, ring, dtype, shape, bytes)):
    #: the cross-rank parity token folded into the collective fingerprint
    fingerprint: str = ""

    @property
    def comm_frac(self) -> float:
        """Analytic comm share of the step, in [0, 1]."""
        total = self.est_ms + self.compute_ms
        return self.est_ms / total if total > 0 else 0.0

    @property
    def bound(self) -> str:
        """Static verdict: what bounds the step if nothing overlaps."""
        if not self.collectives:
            return "compute"
        return "comm" if self.est_ms > self.compute_ms else "compute"

    def report(self) -> str:
        lines = [
            f"comms plan (nranks={self.nranks}, batch={self.batch_size}, "
            f"link {self.link_bw / 1e9:.0f} GB/s): "
            f"{len(self.collectives)} collective(s), "
            f"{self.payload_bytes / 1e6:.2f} MB payload, "
            f"{self.wire_bytes / 1e6:.2f} MB wire, "
            f"est {self.est_ms:.3f} ms comm vs {self.compute_ms:.3f} ms "
            f"compute -> {self.bound}-bound "
            f"(comm share {self.comm_frac:.1%})"]
        for c in self.collectives:
            lines.append(
                f"  {c.path}#{c.pos:<4} {c.signature:<48} "
                f"{c.payload_bytes / 1e6:8.3f} MB  "
                f"wire {c.wire_bytes / 1e6:8.3f} MB  {c.est_ms:7.4f} ms")
        return "\n".join(lines)


def _shape_of(block: Block, name, batch_size: int):
    if not name or not block.has_var(name):
        return None, "float32"
    v = block.var(name)
    if v.shape is None:
        return None, str(v.dtype or "float32")
    return tuple(batch_size if d in (-1, None) else int(d)
                 for d in v.shape), str(v.dtype or "float32")


# (program fingerprint, fetch tuple, batch, nranks) -> CommsPlan; a bounded
# FIFO, the verifier/cost/memory cache discipline
_CACHE: Dict[tuple, CommsPlan] = {}  # guarded-by: _CACHE_LOCK
_CACHE_CAP = 128
_CACHE_LOCK = threading.Lock()


def clear_cache() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()


def _visible_devices() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def plan_comms(program: Program, fetch_names=(), batch_size: int = 1,
               nranks: Optional[int] = None) -> Optional[CommsPlan]:
    """Static comms plan for one program, or None when the program
    launches no collectives (and carries no ``collective`` attr).
    ``nranks`` defaults to the transpiler's ``_attrs["collective"]``
    stamp, falling back to the visible card count.  Cached on (program
    fingerprint, fetch tuple, batch, nranks)."""
    fetch_names = tuple(
        f.name if hasattr(f, "name") else f for f in (fetch_names or ()))
    if nranks is None:
        coll = program._attrs.get("collective") or {}
        nranks = int(coll.get("nranks", 0) or 0)
        if nranks <= 0:
            nranks = _visible_devices()
    nranks = max(int(nranks), 1)
    key = (program.fingerprint(), fetch_names, int(batch_size), nranks)
    with _CACHE_LOCK:
        cached = _CACHE.get(key)
    if cached is not None:
        return cached if cached.collectives or cached.nranks else None
    with _monitor.TRACER.span("comms.plan", "compile",
                              fetches=len(fetch_names)):
        plan = _plan(program, fetch_names, int(batch_size), nranks)
    # a negative result caches an empty marker, so the steady-state
    # dispatch of a collective-free program stays a dict probe
    plan_obj = CommsPlan(nranks=0) if plan is None else plan
    with _CACHE_LOCK:
        if key not in _CACHE:
            if len(_CACHE) >= _CACHE_CAP:
                _CACHE.pop(next(iter(_CACHE)))
            _CACHE[key] = plan_obj
        plan_obj = _CACHE[key]
    return plan_obj if plan_obj.nranks else None


def _plan(program: Program, fetch_names, batch_size: int,
          nranks: int) -> Optional[CommsPlan]:
    from ..framework import ir
    from .verifier import _COLLECTIVE_OPS, sub_blocks_of

    link_bw = device_link_bandwidth()
    entries: List[CollectiveCost] = []

    def gather(block_graph, path: str):
        block = program.blocks[block_graph.block_idx]
        order = {n.id: i for i, n in enumerate(
            block_graph.topology_sort())}
        pos = {id(op): i for i, op in enumerate(block.ops)}
        for n in sorted(block_graph.op_nodes,
                        key=lambda n: (order.get(n.id, 0), n.id)):
            if n.name in _COLLECTIVE_OPS:
                op = n.op
                x = op.input("X")
                shape, dtype = _shape_of(block, x[0] if x else None,
                                         batch_size)
                numel = 1
                for d in (shape or ()):
                    numel *= max(int(d), 1)
                payload = (numel if shape is not None else 1) \
                    * _itemsize(dtype)
                factor = _ALGO_FACTOR.get(n.name, lambda n_: 1.0)(nranks) \
                    if nranks > 1 else 0.0
                wire = int(payload * factor)
                entries.append(CollectiveCost(
                    path=path,
                    pos=order.get(n.id, 0),
                    op=n.name,
                    ring_id=int(op.attrs.get("ring_id", 0) or 0),
                    dtype=dtype,
                    shape=tuple(shape or ()),
                    payload_bytes=int(payload),
                    wire_bytes=wire,
                    est_ms=wire / link_bw * 1e3))
            subs = sub_blocks_of(n.op)
            if subs:
                idx = pos.get(id(n.op), order.get(n.id, 0))
                for _, sub in subs:
                    gather(ir.Graph(program, sub.idx),
                           f"{path}/{n.name}@{idx}/{sub.idx}")

    gather(ir.Graph(program), "0")
    if not entries and not program._attrs.get("collective"):
        return None

    compute_ms = 0.0
    try:
        from .cost import device_peak_flops, plan_cost
        cplan = plan_cost(program, fetch_names, batch_size=batch_size)
        compute_ms = cplan.flops / device_peak_flops() * 1e3
    except Exception:
        pass

    h = hashlib.sha1()
    h.update(repr(nranks).encode())
    for c in entries:
        h.update(repr((c.path, c.op, c.ring_id, c.dtype, c.shape,
                       c.payload_bytes)).encode())
    return CommsPlan(
        nranks=nranks, link_bw=link_bw, batch_size=batch_size,
        collectives=entries,
        payload_bytes=sum(c.payload_bytes for c in entries),
        wire_bytes=sum(c.wire_bytes for c in entries),
        est_ms=sum(c.est_ms for c in entries),
        compute_ms=compute_ms,
        fingerprint=h.hexdigest())


def stamp_attrs(plan: Optional[CommsPlan]) -> Optional[dict]:
    """The ``_attrs["verify"]["comms"]`` payload other layers read without
    re-planning."""
    if plan is None:
        return None
    return {
        "nranks": plan.nranks,
        "link_bw": plan.link_bw,
        "payload_bytes": plan.payload_bytes,
        "wire_bytes": plan.wire_bytes,
        "est_ms": round(plan.est_ms, 6),
        "compute_ms": round(plan.compute_ms, 6),
        "comm_frac": round(plan.comm_frac, 6),
        "bound": plan.bound,
        "fingerprint": plan.fingerprint,
        "collectives": [
            (c.path, c.pos, c.op, c.signature, c.payload_bytes,
             c.wire_bytes) for c in plan.collectives],
    }


def bound_byte_cells(plan: CommsPlan):
    """The (cell, payload) byte-counter pairs, resolved once per plan, so
    a step's accounting is a lock and an add per collective."""
    return [(COLLECTIVE_BYTES_CTR.labels(op=c.op, signature=c.signature),
             c.payload_bytes) for c in plan.collectives]


# -- runtime measurement ------------------------------------------------------

def _segment_ms(segment) -> Optional[float]:
    """The collective segment's time in ms: a pair of CUDA events (start,
    end) or of host ``perf_counter`` seconds; None without one."""
    if segment is None:
        return None
    a, b = segment
    if hasattr(a, "elapsed_time"):
        return float(a.elapsed_time(b))
    return max((b - a) * 1e3, 0.0)


class CommsMonitor:
    """Background decomposer of collective launch records (ref
    comms.py:341-520).

    The executor's collective mode hands each step a record (step id, the
    probe, the comms plan, the launch time, the dispatch time, the
    straggler wait, the collective segment's two timestamps).  A daemon
    worker waits for the probe off the training thread, so the training
    thread pays one deque append, then publishes the per-collective wire
    histograms, the wait histogram, the windowed ``comm_step_ms`` /
    ``comm_wait_ms`` / ``bus_bw`` gauges and a ``collective.launch``
    tracer span stamped with the launch and retire times.  The queue is
    bounded: under backlog the oldest record's timing sample is dropped
    (counted); the byte counters are bumped at dispatch and stay exact."""

    MAX_PENDING = 8
    _WINDOW = 9

    def __init__(self):
        self._cv = threading.Condition()
        self._pending: collections.deque = collections.deque()  # guarded-by: _cv
        self._inflight = 0                                      # guarded-by: _cv
        self._thread: Optional[threading.Thread] = None         # guarded-by: _cv
        self._ms_win: collections.deque = collections.deque(
            maxlen=self._WINDOW)                                # guarded-by: _cv
        self._wait_win: collections.deque = collections.deque(
            maxlen=self._WINDOW)                                # guarded-by: _cv
        self._bw_win: collections.deque = collections.deque(
            maxlen=self._WINDOW)                                # guarded-by: _cv
        #: wall-clock time of the last gauge publish: metrics_digest drops
        #: the comm_* keys once it is stale
        self.last_publish_wall = 0.0

    def _ensure_thread_locked(self):  # guarded-by-caller: _cv
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="pt-comms-monitor")
            self._thread.start()

    def note_launch(self, step_id: int, probe, plan: CommsPlan,
                    t_start: float, t_dispatch: float,
                    wait_ms: Optional[float], segment=None) -> None:
        """Queue one collective launch for off-thread decomposition.
        ``t_start`` / ``t_dispatch`` are ``perf_counter`` seconds (launch
        entry / dispatch return); ``probe`` a CUDA event after the last
        collective (None on the host); ``wait_ms`` the gate's straggler
        wait (None: no gang attached); ``segment`` the collective
        segment's (start, end) pair (events or host seconds)."""
        with self._cv:
            self._ensure_thread_locked()
            if len(self._pending) >= self.MAX_PENDING:
                self._pending.popleft()
                COMMS_DROPPED_CTR.inc()
            self._pending.append(
                (step_id, probe, plan, t_start, t_dispatch, wait_ms,
                 segment))
            self._cv.notify()

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Block until every queued record is decomposed.  Returns False
        on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._pending or self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 0.1))
        return True

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                rec = self._pending.popleft()
                self._inflight += 1
            try:
                self._decompose(*rec)
            except Exception:
                pass             # telemetry must never kill the worker
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _decompose(self, step_id, probe, plan, t_start, t_dispatch,
                   wait_ms, segment=None):
        if probe is not None:
            probe.synchronize()
        t_ready = time.perf_counter()
        exec_ms = max((t_ready - t_start) * 1e3, 0.0)
        wire_ms = _segment_ms(segment)
        if wire_ms is None:
            wire_ms = exec_ms * plan.comm_frac
        wait = float(wait_ms) if wait_ms is not None else 0.0
        comm_ms = wait + wire_ms
        total_wire = float(plan.wire_bytes) or 1.0
        for c in plan.collectives:
            COLLECTIVE_MS_HIST.observe(
                wire_ms * (c.wire_bytes / total_wire),
                op=c.op, signature=c.signature)
        COLLECTIVE_WAIT_HIST.observe(wait)
        # measured algorithm bandwidth over link peak
        bus_bw = 0.0
        if plan.wire_bytes and wire_ms > 0:
            bus_bw = (plan.wire_bytes / (wire_ms / 1e3)) / plan.link_bw
        with self._cv:
            self._ms_win.append(comm_ms)
            self._wait_win.append(wait)
            self._bw_win.append(bus_bw)
            med_ms = sorted(self._ms_win)[len(self._ms_win) // 2]
            med_wait = sorted(self._wait_win)[len(self._wait_win) // 2]
            med_bw = sorted(self._bw_win)[len(self._bw_win) // 2]
        COMM_STEP_MS_GAUGE.set(med_ms)
        COMM_WAIT_MS_GAUGE.set(med_wait)
        COMM_BW_GAUGE.set(med_bw)
        self.last_publish_wall = time.time()
        if _monitor.TRACER.enabled:
            _monitor.TRACER.add_complete(
                "collective.launch", "collective", t_start, t_ready,
                {"signature": plan.fingerprint[:12],
                 "bytes": plan.payload_bytes,
                 "wire_bytes": plan.wire_bytes,
                 "wait_ms": round(wait, 3),
                 "wire_ms": round(wire_ms, 3),
                 "nranks": plan.nranks,
                 "step_id": step_id,
                 "dispatch_ms": round((t_dispatch - t_start) * 1e3, 3)})


#: the process-wide monitor the executor's collective mode feeds
MONITOR = CommsMonitor()
