"""Executor: runs a Program's global block op by op, eagerly, on one device.

The port's counterpart of ``paddle_tpu/framework/executor.py`` (ref
``python/paddle/fluid/executor.py:295`` and ``framework/executor.cc:432``).
Where the reference traces the whole block into one XLA computation, this
executor calls each op's lowering on torch tensors in program order
(``feed``/``fetch`` ops are skipped) and frees every temporary after its
last reader — the reference's eager-deletion GC (``executor.cc:106-141``).

Per (program version, feed names and signatures, fetch list, scope) the
executor builds a *plan* once: the resolved lowerings, the liveness table
and the persistables to write back.  ``dispatch_stats()["traces"]`` counts
plans built — the analog of the reference's compiled-block count, which the
serving plane holds equal to the number of buckets.

Graph fusion: before it builds the plan of a plain Program, the executor
runs ``analysis.fusion.fuse_program`` at the real feed batch (the
reference's plain-Program fusion slot, ``executor.py:1404-1413``) and plans
the program it returns; a ``CompiledProgram`` plans what its
``_optimized`` gives (the verifier, dead-op elimination, the fusion pass,
``fuse_elewise_add_act_pass``).  Either way the pass gets the executor's
device, where the fusion autotuner times its candidates.  The plan key
carries the fusion flags' config token, so a flag flip re-plans.

Training: a synthesized ``*_grad`` op differentiates its forward op with
``torch.autograd`` (``registry.generic_grad_lower``).  Eager torch has no
CSE to merge a recomputed forward with the original, so the plan pairs each
generic grad op with its forward op, from the program alone, and the run
executes that forward op once under ``torch.enable_grad()`` on detached
inputs that require grad; its graph waits in a side table until the grad op
takes it (and frees it).  A grad op is paired by the forward's type and
inputs and by the output gradients it carries: a fused op's grad carries
only ``OG$Y`` of its five outputs.  After ``framework/recompute.py`` a grad
op pairs with the clone of its forward (names compared by source), so the
original runs without a graph and the clone's graph lives from its chain,
just before the segment's backward, to the grad op.  Everything else runs
under ``torch.no_grad()``, the optimizer ops included, and their outputs reach
the scope through the write-back of persistables.

Random ops draw from a ``torch.Generator`` on the executor's device, seeded
per run from ``seed`` or from ``program.random_seed`` and a step counter
(the reference's formula).  Dropout draws from stateless Philox streams
keyed by that seed (``LowerCtx.rng`` / ``rng_tagged``): a tagged stream is
a pure function of (seed, tag), so a grad op regenerates its forward's
mask; a grad op that recomputes a counter-stream forward rewinds the
counter to where the forward drew (``rng_marks``, the reference's
``executor.py:862-869, 897-918``).

AMP: a program that ``amp.decorate(...).minimize`` (or ``amp.enable``)
marked carries ``_attrs["amp"]``; its runs hand every op's inputs through
``amp.cast_ins`` before the lowering (the reference's
``executor.py:859-861``).  A differentiated forward casts after its leaves
are made (``registry.run_forward``), so master-weight gradients come back
float32.

Resilience (``resilience.py``): a run's ops execute under
``WATCHDOG.watch("executor.dispatch")`` with the ``executor.dispatch``
injection site inside, and fetches materialize under
``WATCHDOG.watch("fetch.materialize")`` with ``fetch.materialize`` inside
(``FetchHandle.numpy`` too); a failed run keeps its plan.  Step hooks
(``add_step_hook``) run after every run once the scope holds the step's
outputs, the checkpoint daemon's capture point; on the card each run
records a CUDA event, and ``drain()`` waits for the events still pending,
the preemption guard's barrier before a checkpoint.

Left out so far: the nan/inf sanitizer, meshes, and the rest of the
reference's telemetry.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import amp as _amp
from .. import resilience as _resil
from ..analysis import fusion as _fusion
from ..kernels import dropout as _dropout
from . import registry
from .core import Program, Variable, default_main_program, grad_var_name
from .recompute import dead_barriers, source_name
from .scope import Scope, global_scope


class LowerCtx:
    """Per-run context handed to op lowerings; ``amp`` is the program's
    bf16 AMP flag."""

    def __init__(self, device: torch.device, seed: int, amp: bool = False):
        self.device = device
        self._seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self._generator = None
        self.amp = bool(amp)
        self._counter = 0
        # output name of a stateful_rng op -> the counter before it ran
        self.rng_marks: Dict[str, int] = {}

    def rng(self) -> _dropout.Stream:
        """A fresh counter stream each call (``executor.py:731-733``)."""
        self._counter += 1
        return _dropout.counter_stream(self._seed, self._counter)

    def rng_tagged(self, tag: int) -> _dropout.Stream:
        """The op tag's stream, independent of the order ops run in: an op
        and its grad op draw the same bits (``executor.py:735-742``); the
        counter word's kind keeps it apart from :meth:`rng`'s streams."""
        return _dropout.tagged_stream(self._seed, tag)

    @property
    def generator(self) -> torch.Generator:
        if self._generator is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(self._seed)
            self._generator = g
        return self._generator


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A fetched tensor on the host.  numpy has no bfloat16, so a bf16
    tensor (an AMP activation) comes back widened to float32, which is
    exact; ``return_numpy=False`` keeps the tensor and its dtype."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class FetchHandle:
    """A fetched tensor still being computed on the card.  ``numpy()``
    waits on the CUDA event recorded on the dispatching stream when the
    run returned, then copies to the host."""

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self._event = None
        if tensor.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensor.device))

    def numpy(self) -> np.ndarray:
        with _resil.WATCHDOG.watch("fetch.materialize"):
            _resil.maybe_inject("fetch.materialize")
            if self._event is None:
                return _to_numpy(self.tensor)
            self._event.synchronize()
            # copy on a side stream: on the dispatching stream the copy
            # would queue behind every batch dispatched after this one
            with torch.cuda.stream(torch.cuda.Stream(self.tensor.device)):
                return _to_numpy(self.tensor)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def _fwd_key(op) -> tuple:
    """What a forward op and its generic grad op share: the type and the
    input names by slot, each name as its source (``recompute.source_name``:
    a recomputed clone reads ``v@RBAR`` or ``v@RECOMPUTE`` where the grad op
    of the original reads ``v``)."""
    return (op.type,
            tuple(sorted((s, tuple(map(source_name, ns)))
                         for s, ns in op.inputs.items())))


def _grad_key(op) -> tuple:
    return (op.attrs["__fwd_type__"],
            tuple(sorted((s[2:], tuple(map(source_name, ns)))
                         for s, ns in op.inputs.items()
                         if s.startswith("X$"))))


def _carries_grads_of(grad_op, fwd_op) -> bool:
    """Whether each output gradient the grad op carries (``OG$<slot>``) is
    the gradient of ``fwd_op``'s output in that slot (of its source, for a
    recomputed clone's ``v@RECOMPUTE``).  A grad op may carry fewer slots
    than its forward has outputs."""
    for s, ns in grad_op.inputs.items():
        if s.startswith("OG$") and list(ns) != [
                grad_var_name(source_name(n))
                for n in fwd_op.outputs.get(s[3:], [])]:
            return False
    return True


class _Plan:
    """Everything a run of one block needs that does not depend on values.

    ``ops`` holds ``(op, info)``; a generic grad op carries its forward
    op's info.  ``fwd_of`` maps each generic grad op's index to the index of
    the forward op whose graph it takes (None when the block holds no such
    op: the grad op then recomputes its forward); ``wanted`` maps each
    forward op so taken to the input gradients its grad op wants, by
    slot.  In a recomputed program a grad op takes its forward's clone,
    the latest op of that key before it; a barrier nobody reads is left
    out."""

    def __init__(self, program: Program, fetch_names):
        block = program.global_block()
        self.block = block
        self.amp = bool(program._attrs.get("amp", False))
        self.ops = []
        self.fwd_of: Dict[int, Optional[int]] = {}
        self.wanted: Dict[int, Dict[str, List[bool]]] = {}
        fwd_at: Dict[tuple, List[int]] = {}
        dead = {id(op) for op in dead_barriers(block.ops, fetch_names)}
        for op in block.ops:
            if op.type in ("feed", "fetch") or id(op) in dead:
                continue
            i = len(self.ops)
            if registry.is_generic_grad(op):
                self.ops.append(
                    (op, registry.get_op_info(op.attrs["__fwd_type__"])))
                cands = fwd_at.get(_grad_key(op), [])
                j = next((c for c in reversed(cands)
                          if _carries_grads_of(op, self.ops[c][0])), None)
                self.fwd_of[i] = j
                if j is not None:
                    cands.remove(j)
                    self.wanted[j] = {s[3:]: [bool(n) for n in ns]
                                      for s, ns in op.outputs.items()
                                      if s.startswith("IG$")}
                continue
            self.ops.append((op, registry.get_op_info(op.type)))
            fwd_at.setdefault(_fwd_key(op), []).append(i)
        persistable = {n for n, v in block.vars.items() if v.persistable}
        keep = set(fetch_names) | persistable
        last: Dict[str, int] = {}
        written = set()
        for i, (op, _) in enumerate(self.ops):
            for slot, names in op.inputs.items():
                if self.fwd_of.get(i) is not None and slot.startswith("X$"):
                    continue        # the forward's graph holds what it needs
                for n in names:
                    if n:
                        last[n] = i
            for n in op.output_arg_names():
                if n:
                    written.add(n)
                    last[n] = max(last.get(n, -1), i)
        self.free_after: List[List[str]] = [[] for _ in self.ops]
        for n, i in last.items():
            if n not in keep:
                self.free_after[i].append(n)
        self.persist_out = sorted(written & persistable)


def _feed_sig(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    a = np.asarray(x)
    return a.shape, a.dtype.name


def _op_context(block, op) -> str:
    parts = [f"op={op.type!r}"]
    for slot, names in op.inputs.items():
        for n in names:
            shape = block.var(n).shape if n and block.has_var(n) else None
            parts.append(f"in {slot}:{n} shape={shape}")
    parts.append(f"outs={[n for ns in op.outputs.values() for n in ns]}")
    return "\n  ".join(parts)


class Executor:
    """ref ``python/paddle/fluid/executor.py:295`` Executor.

    ``place`` picks the device: ``CUDAPlace(n)`` (the default, ``n = 0``)
    or ``CPUPlace()``.  Without a CUDA device the default raises — a run
    on the host must ask for it."""

    def __init__(self, place=None):
        from ..place import CUDAPlace, checked_device
        self.device = checked_device(place, "Executor")
        self.place = CUDAPlace(0) if place is None else place
        self._lock = threading.Lock()
        self._plans: Dict[Any, _Plan] = {}  # guarded-by: _lock
        counters = ("traces", "cache_hits", "cache_misses",
                    "steps_dispatched")
        self._stats = dict.fromkeys(counters, 0)  # guarded-by: _lock
        self._step_seed = 0  # guarded-by: _lock
        self._step_hooks: List[Any] = []  # guarded-by: _lock
        # an event per dispatched run on the card, not yet seen complete
        self._inflight: collections.deque = \
            collections.deque()  # guarded-by: _lock

    def close(self):
        with self._lock:
            self._plans.clear()
            self._inflight.clear()

    # -- step-boundary hooks (ref executor.py:1273-1290) ---------------------
    def add_step_hook(self, fn) -> None:
        """Register ``fn(executor, scope)`` to run after every completed
        ``run()``, once the scope holds the step's outputs (still being
        computed on the card: a hook that needs host values copies on the
        device and waits elsewhere, as the checkpoint daemon does).  Every
        run counts, startup programs included; hooks run on the
        dispatching thread, and a hook's exception fails the run."""
        with self._lock:
            if fn not in self._step_hooks:
                self._step_hooks.append(fn)

    def remove_step_hook(self, fn) -> None:
        with self._lock:
            if fn in self._step_hooks:
                self._step_hooks.remove(fn)

    def drain(self) -> int:
        """Wait until every run dispatched on the card has finished there,
        so the scope's values are computed (ref executor.py:2137-2157).
        Returns the number of runs waited on; on the host, 0."""
        with self._lock:
            pending = list(self._inflight)
            self._inflight.clear()
        waited = 0
        for ev in pending:
            if not ev.query():
                ev.synchronize()
                waited += 1
        return waited

    def _note_dispatched(self) -> None:
        if self.device.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        with self._lock:
            while self._inflight and self._inflight[0].query():
                self._inflight.popleft()
            self._inflight.append(ev)

    def dispatch_stats(self) -> Dict[str, int]:
        """Counters the serving plane reads: plans built (``traces``,
        ``cache_misses``), plan reuses (``cache_hits``), runs
        (``steps_dispatched``) and plans held (``compiled_blocks``)."""
        with self._lock:
            out = dict(self._stats)
            out["compiled_blocks"] = len(self._plans)
        return out

    def _to_device(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda" and x.device.type == "cpu":
            # pinned and asynchronous: a copy from pageable memory would
            # block this thread until the card has finished all queued work
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True,
            seed: Optional[int] = None):
        """Run the program's global block once.  Returns the fetches as
        numpy arrays, or as :class:`FetchHandle` s with
        ``return_numpy=False`` (the device work may still be running)."""
        from ..compiler import CompiledProgram
        compiled = program if isinstance(program, CompiledProgram) else None
        if compiled is not None:
            program = compiled.program
        if program is None:
            program = default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = tuple(f.name if isinstance(f, Variable) else f
                            for f in (fetch_list or []))
        feed_names = tuple(sorted(feed))
        feed_sigs = tuple(_feed_sig(feed[n]) for n in feed_names)
        key = (program.fingerprint(), feed_names, feed_sigs, fetch_names,
               scope._serial, None if compiled is None else compiled._serial,
               _fusion.config_token())
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                self._stats["cache_misses"] += 1
                self._stats["traces"] += 1
                feed_shapes = {n: _feed_sig(v)[0] for n, v in feed.items()}
                if compiled is not None:
                    run_prog = compiled._optimized(
                        fetch_names, feed_shapes, device=self.device)
                else:
                    # the plain-Program fusion slot, at the real batch
                    run_prog = _fusion.fuse_program(
                        program, fetch_names, feed_shapes=feed_shapes,
                        device=self.device)
                plan = self._plans[key] = _Plan(run_prog, fetch_names)
            else:
                self._stats["cache_hits"] += 1
            self._stats["steps_dispatched"] += 1
            self._step_seed += 1
            step_seed = self._step_seed
        seed_val = seed if seed is not None else (
            program.random_seed * 1000003 + step_seed)
        env = {n: self._to_device(v) for n, v in feed.items()}
        # an injected fault or a hang raises around the ops, and the plan
        # stays cached (ref executor.py:1636-1660): a recovered fault must
        # not pay a re-plan
        with _resil.WATCHDOG.watch("executor.dispatch"), torch.no_grad():
            _resil.maybe_inject("executor.dispatch")
            run_plan(plan, LowerCtx(self.device, seed_val, plan.amp), env,
                     lambda name: self._read(scope, plan.block, name))
        self._note_dispatched()
        if plan.persist_out:
            scope.set_vars({n: env[n] for n in plan.persist_out})
        with self._lock:
            hooks = list(self._step_hooks)
        for h in hooks:
            h(self, scope)
        fetches = [env[n] if n in env else self._read(scope, plan.block, n)
                   for n in fetch_names]
        if return_numpy:
            with _resil.WATCHDOG.watch("fetch.materialize"):
                _resil.maybe_inject("fetch.materialize")
                return [_to_numpy(t) for t in fetches]
        return [FetchHandle(t) for t in fetches]

    def _read(self, scope: Scope, block, name: str) -> torch.Tensor:
        v = scope.find_var(name)
        if v is None:
            hint = (" — did you run the startup program?"
                    if block.has_var(name) and block.var(name).persistable
                    else "")
            raise KeyError(f"op input var {name!r} has no value: not fed, "
                           f"not in scope, and not produced by a preceding "
                           f"op{hint}")
        if not (isinstance(v, torch.Tensor) and v.device == self.device):
            # the scope holds tensors on the executor's device
            v = self._to_device(v)
            scope.set_var(name, v)
        return v


def run_plan(plan: _Plan, ctx: LowerCtx, env: Dict[str, Any],
             read: Callable[[str], torch.Tensor]) -> None:
    """Run a block's plan op by op on ``env`` (name -> tensor): each op's
    outputs land in it, and each temporary leaves it after its last
    reader.  ``read(name)`` gives an input that ``env`` lacks (the
    executor reads the scope).  ``Executor.run`` and
    ``framework.function``'s callables run their blocks through it."""
    graphs: Dict[int, registry.Forward] = {}   # kept, by forward op
    try:
        for i, (op, info) in enumerate(plan.ops):
            try:
                outs = _run_op(plan, i, op, info, ctx, env, read, graphs)
            except Exception as e:
                raise RuntimeError(
                    f"{type(e).__name__} while running op {op.type!r}: "
                    f"{e}\n  {_op_context(plan.block, op)}") from e
            for slot, names in op.outputs.items():
                for n, val in zip(names, outs.get(slot, [])):
                    if n and val is not None:
                        env[n] = val.detach()
            for n in plan.free_after[i]:
                env.pop(n, None)
    finally:
        graphs.clear()      # a raised error's traceback must not pin them


def _run_op(plan, i, op, info, ctx, env, read, graphs):
    grad = i in plan.fwd_of
    fwd = plan.fwd_of.get(i)
    ins = {}
    for slot, names in op.inputs.items():
        if fwd is not None and slot.startswith("X$"):
            continue
        vals = []
        for n in names:
            if not n:
                vals.append(None)
            elif n in env:
                vals.append(env[n])
            elif grad and slot.startswith("OG$"):
                vals.append(None)   # an output nobody differentiated
            else:
                vals.append(read(n))
        ins[slot] = vals
    if grad:
        if fwd is None and info.stateful_rng:
            return _replay_grad(op, ctx, ins)
        return registry.generic_grad_lower(
            ctx, ins, op.attrs, graphs.pop(fwd) if fwd is not None
            else None)
    if info.stateful_rng:
        for n in op.output_arg_names():
            if n:
                ctx.rng_marks[n] = ctx._counter
    if i in plan.wanted:
        # casts after making its leaves, when the program is AMP
        graphs[i] = registry.run_forward(info, ctx, ins, op.attrs,
                                         plan.wanted[i])
        return graphs[i][1]
    if ctx.amp:
        ins = _amp.cast_ins(op.type, ins)
    return info.lower(ctx, ins, op.attrs) or {}


def _replay_grad(op, ctx, ins):
    """A generic grad op recomputing a forward that draws random bits:
    the counter rewinds to where the forward drew, so the recompute
    draws the same bits, then comes back (``executor.py:897-918``)."""
    mark = next((ctx.rng_marks[n[:-len("@GRAD")]]
                 for s, ns in op.inputs.items() if s.startswith("OG$")
                 for n in ns if n and n.endswith("@GRAD")
                 and n[:-len("@GRAD")] in ctx.rng_marks), None)
    if mark is None:
        return registry.generic_grad_lower(ctx, ins, op.attrs)
    saved, ctx._counter = ctx._counter, mark
    try:
        return registry.generic_grad_lower(ctx, ins, op.attrs)
    finally:
        ctx._counter = saved
