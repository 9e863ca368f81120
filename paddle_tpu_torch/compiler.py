"""CompiledProgram and BuildStrategy (ref ``python/paddle/fluid/compiler.py``;
the port's counterpart of ``paddle_tpu/compiler.py``).

``CompiledProgram._optimized`` applies the reference's program passes
(``compiler.py:148-266``), in its order:

1. the program verifier (``FLAGS_program_verify``): error findings raise
   ``ProgramVerificationError`` before any pass touches the program;
2. ``dead_op_eliminate`` (fetched vars are protected);
3. the cost-guided fusion pass (``analysis.fusion.fuse_program``) at the
   real feed batch, before ``fuse_elewise_add_act_pass``, which would
   otherwise consume the bias + activation tails the dense-epilogue pattern
   targets;
4. ``fuse_elewise_add_act_pass`` when ``BuildStrategy.fuse_elewise_add_act_
   ops`` is set (the default);
5. under ``FLAGS_numerics`` the numerics census after fusion
   (``analysis.numerics.plan_numerics``, ref ``compiler.py:241-251``),
   stamped into ``_attrs["numerics"]``: the activations a full-mode step
   traces are the ones the rewritten program produces.

Results are cached per CompiledProgram on the reference's key (program
version, fetch set, fusion config, batch), the numerics mode and the device
the fusion autotuner timed on.  Each pass's wall time goes to the
``paddle_tpu_compiler_pass_ms{pass}`` histogram.  A transpiled collective
program (``distributed.GradAllReduce`` / ``LocalSGD``) keeps its
``_attrs["collective"]``, and the executor runs it in collective mode.  Not
ported yet: the transient-fault retries, the tracer spans and
``with_data_parallel`` / ``with_distributed`` / ``with_gspmd`` (the GSPMD
slice).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Optional

from . import monitor as _monitor
from .framework.core import Program

_OPT_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_compiler_optimize_total",
    "CompiledProgram graph-pass applications by program-cache outcome",
    ("cache",))
_OPT_HIT = _OPT_CTR.labels(cache="hit")
_OPT_MISS = _OPT_CTR.labels(cache="miss")
_PASS_HIST = _monitor.REGISTRY.histogram(
    "paddle_tpu_compiler_pass_ms",
    "per-pass wall time (ms) inside compiler.optimize, by pass",
    ("pass",),
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
             250.0, 500.0, 1000.0, 5000.0))

#: CompiledProgram identity for the executor's plan key (``id()`` can be
#: reused after a CompiledProgram is collected)
_cp_serials = itertools.count()


class BuildStrategy:
    """ref ``details/build_strategy.h`` (``paddle_tpu/compiler.py:54``):
    ``fuse_elewise_add_act_ops`` (default on) gates
    ``fuse_elewise_add_act_pass``.  The reference's data-parallel and
    memory knobs have nothing to act on in the port yet."""

    def __init__(self):
        self.fuse_elewise_add_act_ops = True


@contextlib.contextmanager
def _timed_pass(pass_name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _PASS_HIST.observe((time.perf_counter() - t0) * 1e3,
                           **{"pass": pass_name})


class CompiledProgram:
    def __init__(self, program: Program,
                 build_strategy: Optional[BuildStrategy] = None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._serial = next(_cp_serials)
        self._optimized_cache = {}

    @property
    def program(self) -> Program:
        return self._program

    def _optimized(self, fetch_names=(), feed_shapes=None,
                   device=None) -> Program:
        """The program after the BuildStrategy's passes (see the module
        docstring), for ``fetch_names`` at the batch of ``feed_shapes``, on
        ``device`` (the host by default)."""
        from .analysis import fusion as _fusion
        from .analysis import numerics as _numerics
        from .flags import get_flags
        from .framework import ir
        batch = _fusion._batch_of(feed_shapes)
        key = (self._program.fingerprint(), frozenset(fetch_names),
               _fusion.config_token(), batch, _fusion._device_key(device),
               _numerics.mode())
        prog = self._optimized_cache.get(key)
        if prog is not None:
            _OPT_HIT.inc()
            return prog
        _OPT_MISS.inc()
        protected = frozenset(fetch_names)
        prog = self._program
        if get_flags("FLAGS_program_verify")["FLAGS_program_verify"]:
            from .analysis import verifier as _verifier
            with _timed_pass("program_verify"):
                _verifier.verify_or_raise(prog, fetch_names)
        with _timed_pass("dead_op_eliminate"):
            g = ir.get_pass("dead_op_eliminate",
                            protected=protected).apply(ir.Graph(prog))
        if g.attrs.get("dead_op_eliminate_count"):
            with _timed_pass("to_program"):
                prog = g.to_program()
        with _timed_pass("graph_fusion"):
            prog = _fusion.fuse_program(prog, fetch_names,
                                        feed_shapes=feed_shapes,
                                        device=device)
        if self._build_strategy.fuse_elewise_add_act_ops:
            with _timed_pass("fuse_elewise_add_act"):
                g = ir.get_pass("fuse_elewise_add_act_pass",
                                protected=protected).apply(ir.Graph(prog))
            if g.attrs.get("fuse_elewise_add_act_count"):
                with _timed_pass("to_program"):
                    prog = g.to_program()
        if _numerics.mode() != "off":
            with _timed_pass("numerics_spec"):
                prog._attrs["numerics"] = _numerics.plan_numerics(
                    prog, fetch_names)
        self._optimized_cache[key] = prog
        return prog
