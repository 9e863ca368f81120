"""Step-indexed training checkpoints: the port of ``paddle_tpu/checkpoint.py``.

The reference writes through orbax; the port writes its own step
directories in the format of ``io.save_vars`` (one ``<name>.npy`` per var,
bfloat16 as its uint16 bits, ``__meta__.json`` with the true dtypes), so
nothing is pickled and a bfloat16 value round-trips bit for bit::

    ckpt = CheckpointManager("/tmp/run1", max_to_keep=3)
    start = ckpt.latest_step() or 0          # resume after preemption
    if start:
        ckpt.restore(start, scope=scope)
    for step in range(start, total):
        exe.run(...)
        ckpt.save(step, program=main_program)

A save gathers the state on the calling thread and hands it to one writer
thread, which writes ``<dir>/<step>.tmp.<pid>``, fsyncs every file and the
directory and renames it to ``<dir>/<step>``; :meth:`commit` waits for the
writer and fsyncs the root.  A write that failed in the background raises
at the next call.  The semantics are orbax's: a save at a step at or below
the latest returns False, ``max_to_keep`` keeps the newest steps (deleted
from ``all_steps()`` at once, from the disk once the newer step is
written), ``save_interval_steps`` skips off-interval saves unless
``force``.

Not ported yet: ``save_server`` (the PS snapshot, ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import collections
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import io as _io
from . import monitor as _monitor
from .framework import core
from .framework.scope import Scope, global_scope

__all__ = ["CheckpointManager"]

SAVE_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_checkpoint_saves_total",
    "checkpoint writes handed to the (async) writer, by kind "
    "('interval' = train-loop cadence, 'daemon' = background daemon, "
    "'emergency' = preemption-time force-save)", ("kind",))
BYTES_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_checkpoint_bytes_total",
    "host bytes handed to the checkpoint writer")
COMMIT_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_checkpoint_commits_total",
    "checkpoints made durable, by kind ('rank' = this rank's write "
    "finished + fsync'd, 'gang' = the leader published a COMMITTED "
    "manifest the whole gang agreed on)", ("kind",))
TORN_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_checkpoint_torn_rejects_total",
    "checkpoints refused at resume: newer than (or missing) the gang's "
    "COMMITTED manifest — a torn multi-rank save is never restored")
STRETCH_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_checkpoint_cadence_stretched_total",
    "checkpoint-daemon capture windows stretched past the configured "
    "cadence because the last observed save exceeded "
    "FLAGS_checkpoint_cadence_stretch_frac of the interval")
SAVE_HIST = _monitor.REGISTRY.histogram(
    "paddle_tpu_checkpoint_save_ms",
    "wall ms per checkpoint save call (async: schedule + serialize "
    "handoff; the durable commit is the daemon/exit path's wait)",
    buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
             1000.0, 2500.0, 5000.0, 15000.0, 60000.0))


def _host_arrays(state: Dict[str, Any]):
    """``{name: value}`` -> (C-ordered numpy arrays, dtype names): tensors
    anywhere, numpy arrays, numpy bfloat16 (as its uint16 bits)."""
    arrays, dtypes = {}, {}
    for name, val in state.items():
        if isinstance(val, torch.Tensor):
            arr = _io._to_numpy(val)
            dtypes[name] = _io._dtype_name(val, arr)
        else:
            arr = np.ascontiguousarray(np.asarray(val))
            dtypes[name] = str(arr.dtype)
            if dtypes[name] == "bfloat16":
                arr = arr.view(np.uint16)
        arrays[name] = arr
    return arrays, dtypes


class CheckpointManager:
    """Atomic, step-indexed, keep-last-k checkpoints of scope state."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._interval = max(int(save_interval_steps), 1)
        self._max_to_keep = int(max_to_keep) if max_to_keep else 0
        for entry in os.listdir(self._dir):
            if ".tmp." in entry:        # a writer that died mid-step
                shutil.rmtree(os.path.join(self._dir, entry),
                              ignore_errors=True)
        self._cv = threading.Condition()
        # steps on disk or queued, ascending
        self._steps: List[int] = self._scan()  # guarded-by: _cv
        self._queue: collections.deque = collections.deque()  # guarded-by: _cv
        self._busy = False  # guarded-by: _cv
        self._error: Optional[BaseException] = None  # guarded-by: _cv
        self._closed = False  # guarded-by: _cv
        self._thread: Optional[threading.Thread] = None
        #: wall ms of the latest accepted save call (gather + hand-off)
        self.last_save_ms: Optional[float] = None

    def _scan(self) -> List[int]:
        steps = []
        for entry in os.listdir(self._dir):
            if entry.isdigit() and os.path.isfile(
                    os.path.join(self._dir, entry, "__meta__.json")):
                steps.append(int(entry))
        return sorted(steps)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    # -- the writer thread ----------------------------------------------------
    def _writer(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:
                    return
                step, arrays, dtypes, doomed = self._queue.popleft()
                self._busy = True
            try:
                self._write_step(step, arrays, dtypes)
                for s in doomed:
                    shutil.rmtree(self._step_dir(s), ignore_errors=True)
            except BaseException as e:
                with self._cv:
                    # the step never landed: the kept steps stay kept
                    self._steps = sorted(
                        set(self._steps) - {step} | set(doomed))
                    self._error = e
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _write_step(self, step, arrays, dtypes) -> None:
        final = self._step_dir(step)
        tmp = final + f".tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            _io._write_blobs(tmp, arrays, dtypes)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _raise_background_error(self) -> None:
        with self._cv:
            err, self._error = self._error, None
        if err is not None:
            raise err

    # -- state gathering ------------------------------------------------------
    def _gather(self, program, scope) -> Dict[str, Any]:
        scope = scope or global_scope()
        program = program or core.default_main_program()
        state = {}
        for v in _io.get_program_persistable_vars(program):
            val = scope.find_var(v.name)
            if val is None:
                raise RuntimeError(
                    f"persistable var {v.name!r} has no value in the "
                    "scope; did you run the startup program before "
                    "checkpointing?")
            state[v.name] = val
        return state

    def _write(self, step: int, state: Dict[str, Any], force: bool,
               kind: str = "interval") -> bool:
        if not force and step % self._interval != 0:
            return False
        from . import resilience as _resil
        step = int(step)

        def _once() -> bool:
            # the 'checkpoint.write' injection site; a write that failed
            # in the background raises here, and the retry re-attempts
            # this step cleanly
            _resil.maybe_inject("checkpoint.write")
            self._raise_background_error()
            arrays, dtypes = _host_arrays(state)
            with self._cv:
                if self._closed:
                    raise RuntimeError("CheckpointManager is closed")
                if self._steps and step <= self._steps[-1]:
                    return False
                self._steps.append(step)
                doomed = []
                if self._max_to_keep and \
                        len(self._steps) > self._max_to_keep:
                    doomed = self._steps[:-self._max_to_keep]
                    self._steps = self._steps[-self._max_to_keep:]
                self._queue.append((step, arrays, dtypes, doomed))
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._writer, daemon=True,
                        name="pt-ckpt-writer")
                    self._thread.start()
                self._cv.notify_all()
            return True

        t0 = time.perf_counter()
        with _monitor.TRACER.span("checkpoint.save", "checkpoint",
                                  step=step, kind=kind):
            accepted = _resil.retry_call(
                "checkpoint.write", _once,
                retryable=lambda e: _resil.is_transient(e)
                or isinstance(e, (OSError, TimeoutError)))
        save_ms = (time.perf_counter() - t0) * 1e3
        SAVE_HIST.observe(save_ms)
        if accepted:
            self.last_save_ms = save_ms
            SAVE_CTR.inc(1, kind=kind)
            BYTES_CTR.inc(sum(
                int(v.numel() * v.element_size())
                if isinstance(v, torch.Tensor) else int(np.asarray(v).nbytes)
                for v in state.values()))
        return accepted

    # -- API (the reference's: orbax's shape, save_persistables' meaning) --
    def save(self, step: int, program=None, scope: Optional[Scope] = None,
             force: bool = False, kind: str = "interval") -> bool:
        """Write the program's persistables at ``step``; True iff the
        write was accepted (False off-interval without ``force``, or at a
        step at or below the latest)."""
        if not force and step % self._interval != 0:
            return False
        return self._write(step, self._gather(program, scope), force=True,
                           kind=kind)

    def save_arrays(self, step: int, state: Dict[str, Any],
                    force: bool = True, kind: str = "daemon") -> bool:
        """Write an already gathered ``{name: host value}`` snapshot (the
        daemon's entry point)."""
        return self._write(step, dict(state), force=force, kind=kind)

    def wait_until_finished(self) -> None:
        """Block until every queued write is on disk; a background write
        error raises here."""
        with self._cv:
            while self._queue or self._busy:
                self._cv.wait()
        self._raise_background_error()

    def commit(self, kind: str = "rank") -> Optional[int]:
        """Wait for the writer and fsync the root, so that the step
        directories' renames survive a crash.  Returns the latest step now
        on disk."""
        self.wait_until_finished()
        _io._fsync_dir(self._dir)
        step = self.latest_step()
        if step is not None:
            COMMIT_CTR.inc(1, kind=kind)
        return step

    def latest_step(self) -> Optional[int]:
        with self._cv:
            return self._steps[-1] if self._steps else None

    def all_steps(self) -> List[int]:
        with self._cv:
            return list(self._steps)

    def prune_after(self, step: int) -> list:
        """Delete every checkpoint newer than ``step``; returns them."""
        self.wait_until_finished()
        with self._cv:
            doomed = [s for s in self._steps if s > int(step)]
            self._steps = [s for s in self._steps if s <= int(step)]
        for s in doomed:
            shutil.rmtree(self._step_dir(s))
        if doomed:
            _io._fsync_dir(self._dir)
        return doomed

    def restore(self, step: Optional[int] = None, program=None,
                scope: Optional[Scope] = None) -> int:
        """Load every var saved at ``step`` (default: the latest) into the
        scope as host tensors (the executor moves them to its device);
        returns the step."""
        self.wait_until_finished()
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        scope = scope or global_scope()
        d = self._step_dir(step)
        with _monitor.TRACER.span("checkpoint.restore", "checkpoint",
                                  step=step):
            import json
            with open(os.path.join(d, "__meta__.json")) as f:
                meta = json.load(f)["vars"]
            for name, m in meta.items():
                arr = np.load(os.path.join(d, name.replace("/", "__")
                                           + ".npy"))
                scope.set_var(name, _io._to_tensor(arr, m["dtype"],
                                                   torch.device("cpu")))
        return step

    def close(self):
        self.wait_until_finished()
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
