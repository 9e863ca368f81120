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
``_attrs["collective"]``, and the executor runs it in collective mode.

SPMD (ref ``compiler.py:268-432``): :meth:`CompiledProgram.
with_data_parallel` (a ``dp`` mesh over the given places),
:meth:`~CompiledProgram.with_distributed` (parameters laid out by their
``dist_spec``, optionally ZeRO-1) and :meth:`~CompiledProgram.with_gspmd`
(the logical-axis partitioner picks or applies a rule table, ZeRO-1 on by
default) set a mesh, and the executor runs the optimized program lowered
to one per-rank program over its ranks (:meth:`~CompiledProgram._lower`,
``parallel.spmd``).  The rank layout is the reference's
``_build_in_shardings``: feeds follow their spec (batch on ``dp`` by
default), parameters their ``dist_spec``, accumulators their parameter's
through ``shard_like``, plus ``dp`` on a free, divisible dim 0 under
ZeRO-1.  Each reconfiguration takes a new serial, so no plan built for the
old one runs.  After ``distributed.init_parallel_env`` the default mesh
spans the processes (one card each): each process feeds its block of the
batch and runs its own ranks.  A program run on a mesh skips the fusion
passes: the lowering knows the unfused op set.  Not ported yet: the transient-fault
retries and the tracer spans.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Optional

import torch

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


def _default_ranks() -> int:
    """Ranks of a default mesh: one a process over several processes, else
    every visible card (at least one)."""
    from .distributed.env import is_multiprocess, process_count
    if is_multiprocess():
        return process_count()
    return max(torch.cuda.device_count(), 1)


class CompiledProgram:
    def __init__(self, program: Program,
                 build_strategy: Optional[BuildStrategy] = None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._serial = next(_cp_serials)
        self._optimized_cache = {}
        self._mesh = None
        self._input_specs = {}
        self._zero_stage = 0

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
        ptok = None
        if self._program._attrs.get("partition"):
            # the stamp lives in _attrs, outside the structural fingerprint
            from .parallel.partitioner import partition_fingerprint
            ptok = partition_fingerprint(self._program._attrs["partition"])
        key = (self._program.fingerprint(), frozenset(fetch_names),
               _fusion.config_token(), batch, _fusion._device_key(device),
               _numerics.mode(), ptok, self._mesh is not None)
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
        if self._mesh is None:
            with _timed_pass("graph_fusion"):
                prog = _fusion.fuse_program(prog, fetch_names,
                                            feed_shapes=feed_shapes,
                                            device=device)
        if self._build_strategy.fuse_elewise_add_act_ops and \
                self._mesh is None:
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

    # -- SPMD (ref compiler.py:268-432) -------------------------------------
    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """Split the batch over a ``dp`` mesh: ``places`` (Places or
        devices; an int takes that many cards), every visible card by
        default.  Parameters stay replicated; each gradient is all-reduced
        over the ranks before the optimizer reads it.  ``loss_name``,
        ``exec_strategy`` and ``share_vars_from`` are the reference's
        signature: the global-batch loss needs no name here."""
        from .parallel.mesh import make_mesh
        if build_strategy is not None:
            self._build_strategy = build_strategy
        if isinstance(places, int):
            devices = [torch.device("cuda", i) for i in range(places)]
        elif places:
            devices = [getattr(p, "device", p) for p in places]
        else:
            devices = None
        self._mesh = make_mesh(
            {"dp": len(devices) if devices else _default_ranks()}, devices)
        self._input_specs, self._zero_stage = {}, 0
        # a reconfiguration changes what the executor lowers without
        # touching the program fingerprint: a new serial invalidates the
        # plans built for the old one
        self._serial = next(_cp_serials)
        return self

    def with_distributed(self, mesh=None, axes=None, input_specs=None,
                         zero_stage=0, devices=None):
        """SPMD over an explicit mesh: parameters laid out by their
        ``dist_spec`` annotations, feeds by ``input_specs`` (batch on
        ``dp`` by default); ``zero_stage=1`` also splits optimizer state
        over ``dp`` (ZeRO-1).  ``axes`` builds the mesh over ``devices``
        (every visible card by default)."""
        from .parallel.mesh import make_mesh
        if mesh is None and axes is None:
            raise ValueError(
                "with_distributed() needs either `mesh` (a parallel.Mesh) "
                "or `axes` (e.g. {'dp': 2, 'mp': 4})")
        self._mesh = mesh if mesh is not None else make_mesh(axes, devices)
        self._input_specs = dict(input_specs or {})
        if zero_stage not in (0, 1):
            raise ValueError("zero_stage must be 0 or 1 (ZeRO-1: "
                             "optimizer-state sharding)")
        self._zero_stage = int(zero_stage)
        self._serial = next(_cp_serials)
        return self

    def with_gspmd(self, axes=None, mesh=None, rules=None, zero_stage=1,
                   input_specs=None, fetch_names=(), batch_size: int = 1,
                   budget_mb=None, devices=None):
        """Model parallelism through the logical-axis partitioner
        (``parallel.partitioner``): infer each parameter's logical axes,
        apply a rule table (``rules="auto"``: the cheapest-traffic table
        whose per-shard static peak fits ``FLAGS_memory_budget_mb``, or
        ``budget_mb``) and run SPMD over a topology mesh, ZeRO-1 on by
        default.  ``rules`` is a table name (``"replicated"``,
        ``"mp_hidden"``, ``"mp_hidden_vocab"``), a ``{logical_axis:
        mesh_axis}`` dict, a ``LogicalAxisRules`` or ``"auto"``; None reads
        ``FLAGS_gspmd_rules``, and with neither ``mesh`` nor ``axes``
        ``FLAGS_gspmd_mesh`` gives the axes (one mp axis over every card
        when empty).  The stamp lands in ``program._attrs["partition"]``."""
        from .flags import get_flags
        from .parallel import partitioner as _part
        from .parallel.mesh import make_topology_mesh, mesh_axis_sizes
        if rules is None:
            rules = get_flags("FLAGS_gspmd_rules")["FLAGS_gspmd_rules"]
        if mesh is None:
            if axes is None:
                spec = get_flags("FLAGS_gspmd_mesh")["FLAGS_gspmd_mesh"]
                if spec:
                    axes = {k: int(v) for k, v in
                            (kv.split(":") for kv in spec.split(","))}
                else:
                    axes = {"dp": 1,
                            "mp": len(devices) if devices else
                            _default_ranks()}
            mesh = make_topology_mesh(axes, devices)
        self._mesh = mesh
        if zero_stage not in (0, 1):
            raise ValueError("zero_stage must be 0 or 1 (ZeRO-1: "
                             "optimizer-state sharding)")
        fetch_names = tuple(
            f.name if hasattr(f, "name") else f for f in fetch_names)
        stamp = _part.partition_program(
            self._program, mesh_axis_sizes(mesh), rules=rules,
            fetch_names=fetch_names, batch_size=batch_size,
            budget_mb=budget_mb)
        self._input_specs = dict(input_specs or {})
        self._zero_stage = int(zero_stage)
        # the analysis prices ZeRO-1's split off the stamp, and the
        # partition fingerprint hashes it
        stamp["zero_stage"] = self._zero_stage
        # the new stamp changes the verify stamp: drop what was cached for
        # the program before, and take a new serial
        self._program._attrs.pop("verify", None)
        self._optimized_cache = {}
        self._serial = next(_cp_serials)
        return self

    def _lower(self, fetch_names=(), feed_shapes=None, device=None):
        """The ``parallel.spmd.SpmdLayout`` the executor runs for this
        configuration at the batch of ``feed_shapes``: the optimized
        program, its sharding plan (the stamp's, or the ``dist_spec`` s'
        over the mesh) and the per-rank program lowered from them."""
        from .analysis import fusion as _fusion
        from .analysis.sharding import plan_sharding
        from .parallel.mesh import mesh_axis_sizes
        from .parallel.spmd import lower_program
        prog = self._optimized(fetch_names, feed_shapes, device=device)
        batch = _fusion._batch_of(feed_shapes)
        if prog._attrs.get("partition"):
            plan = plan_sharding(prog, fetch_names, batch_size=batch)
        else:
            block = prog.global_block()
            specs = {n: tuple(v.dist_spec) for n, v in block.vars.items()
                     if v.is_parameter and getattr(v, "dist_spec", None)
                     and any(v.dist_spec)}
            plan = plan_sharding(prog, fetch_names, batch_size=batch,
                                 specs=specs,
                                 axis_sizes=mesh_axis_sizes(self._mesh),
                                 rules=None, zero_stage=self._zero_stage)
        for name, spec in self._input_specs.items():
            want = plan.specs.get(name)
            if tuple(spec or ()) != tuple(want or ())[:len(spec or ())]:
                raise NotImplementedError(
                    f"input_specs[{name!r}] = {spec}: feeds laid out other "
                    f"than the sharding plan's {want} (batch on 'dp') are "
                    "not lowered yet (ROADMAP Queue 1 item 3 (i))")
        return lower_program(prog, fetch_names, batch, self._mesh, plan,
                             zero_stage=self._zero_stage)
