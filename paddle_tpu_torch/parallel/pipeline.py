"""Pipeline parallelism: program sections over devices, the GPipe schedule
(the port of ``paddle_tpu/parallel/pipeline.py``; ref ``PipelineOptimizer``,
``python/paddle/fluid/optimizer.py:2687``, run by ``PipelineTrainer`` /
``SectionWorker``, ``framework/trainer.h:110``, ``device_worker.h:262``).

- The split is program-level, as the reference's: the ops between two cut
  vars form a :class:`Section`, a standalone sub-Program with its boundary
  signature (:func:`split_program`).
- The runtime (:class:`PipelineEngine`) is functional: each section is a
  differentiable function of its parameters and boundary inputs
  (``framework.function.program_as_vjp``) run on its stage's device.  The
  forward wave runs every microbatch through the stages and stashes each
  stage's inputs per microbatch; boundary activations move to the next
  stage's device with ``tensor.to``.  The backward wave runs in reverse
  and is recompute-based (each section's forward runs again under
  autograd, as the reference's ``jax.vjp`` of a section does); a boundary
  var read by several later stages (a skip connection) sums its
  cotangents over them.  Parameter gradients accumulate over the
  microbatches under a 1/M loss seed: the objective is the mean of the
  microbatch losses.
- Apply: the inner optimizer updates each stage's parameters on their
  device through the eager apply (``dygraph.eager_apply``): every
  optimizer works per stage unchanged.
- A stage's placement is one ``torch.device`` (several stages may name the
  same one: ``[cuda:0] * 4``) or a list of devices, the stage's ``dp``
  submesh: its batch is split over the list and its parameters
  replicated, by the SPMD lowering's batch-on-``dp`` rules, which give the
  one-device result.

The stages run one after another on the host thread: nothing overlaps
stage s of microbatch m with stage s+1 of microbatch m-1 yet.  The block
runs with seed 0 each call, so at a dropout above 0 every microbatch and
every step draws the same masks (the reference's ``program_as_function``
does the same), and the recompute draws the forward's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework.core import (Operator, Program, Variable,
                              default_main_program)


class Section:
    """One pipeline stage: a sub-program and its boundary signature (ref
    ``SectionWorkerParameter``, ``framework/trainer_desc.proto:66-86``)."""

    def __init__(self, idx: int, program: Program, in_names: List[str],
                 feed_names: List[str], out_names: List[str],
                 param_names: List[str]):
        self.idx = idx
        self.program = program
        self.in_names = in_names        # activations from earlier stages
        self.feed_names = feed_names    # raw feeds this stage consumes
        self.out_names = out_names      # activations for later stages
        self.param_names = param_names

    def __repr__(self):
        return (f"Section({self.idx}, ops={len(self.program.global_block().ops)}, "
                f"in={self.in_names}, feed={self.feed_names}, "
                f"out={self.out_names})")


def _copy_section_program(src_block, ops: Sequence[Operator]) -> Program:
    """A fresh Program holding ``ops`` and the vars they touch."""
    prog = Program()
    blk = prog.global_block()
    for op in ops:
        for name in op.input_arg_names() + op.output_arg_names():
            if blk.has_var(name):
                continue
            if src_block.has_var(name):
                v = src_block.var(name)
                nv = Variable(blk, name, shape=v.shape, dtype=v.dtype,
                              persistable=v.persistable,
                              is_parameter=v.is_parameter,
                              trainable=getattr(v, "trainable", False))
                nv.stop_gradient = getattr(v, "stop_gradient", False)
                blk.vars[name] = nv
            else:
                blk.create_var(name=name)
    for op in ops:
        # a raw copy: the var metadata came from the source block
        blk.ops.append(Operator(blk, op.type, dict(op.inputs),
                                dict(op.outputs), dict(op.attrs)))
    prog._bump_version()
    return prog


def split_program(program: Program, cut_vars: Sequence,
                  loss_name: str) -> List[Section]:
    """Split at the cut vars: section s holds the ops after the producer of
    cut s-1 up to and including the producer of cut s (the reference's
    ``cut_list`` semantics)."""
    block = program.global_block()
    cut_names = [c.name if isinstance(c, Variable) else c for c in cut_vars]
    ops = list(block.ops)

    producer_idx = {}
    for i, op in enumerate(ops):
        for name in op.output_arg_names():
            producer_idx[name] = i

    bounds = []
    for c in cut_names:
        if c not in producer_idx:
            raise ValueError(f"cut var {c!r} is not produced by any op")
        bounds.append(producer_idx[c])
    if bounds != sorted(bounds):
        raise ValueError("cut_list must be topologically ordered")
    bounds = bounds + [len(ops) - 1]

    feed_candidates = set()
    for op in ops:
        for name in op.input_arg_names():
            if name not in producer_idx and not block.var(name).persistable:
                feed_candidates.add(name)

    produced_by_stage: Dict[str, int] = {}
    slices = []
    start = 0
    for s, end in enumerate(bounds):
        sec_ops = ops[start:end + 1]
        slices.append(sec_ops)
        for op in sec_ops:
            for name in op.output_arg_names():
                produced_by_stage[name] = s
        start = end + 1

    consumed_by: Dict[str, set] = {}
    for s, sec_ops in enumerate(slices):
        for op in sec_ops:
            for name in op.input_arg_names():
                consumed_by.setdefault(name, set()).add(s)

    sections = []
    for s, sec_ops in enumerate(slices):
        internal = set()
        params, ins, feeds = [], [], []
        for op in sec_ops:
            for name in op.input_arg_names():
                if name in internal:
                    continue
                v = block.var(name)
                if v.persistable:
                    if name not in params:
                        params.append(name)
                elif name in feed_candidates:
                    if name not in feeds:
                        feeds.append(name)
                elif produced_by_stage.get(name, s) != s:
                    if name not in ins:
                        ins.append(name)
            for name in op.output_arg_names():
                internal.add(name)
        outs = []
        for op in sec_ops:
            for name in op.output_arg_names():
                later = any(t > s for t in consumed_by.get(name, ()))
                if (later or name == loss_name) and name not in outs:
                    outs.append(name)
        sections.append(Section(s, _copy_section_program(block, sec_ops),
                                ins, feeds, outs, params))
    return sections


def _device(d) -> torch.device:
    return torch.device(getattr(d, "device", d))


class PipelineEngine:
    """The GPipe runtime over sections (ref ``PipelineTrainer`` +
    ``SectionWorker`` s; module docstring).  ``devices`` holds one entry a
    stage: a device, or a list of devices (the stage's ``dp`` submesh);
    the visible cards round-robin by default.  The stages' parameters are
    taken from ``scope`` (the global scope by default) onto their devices
    and stay there until :meth:`sync_to_scope`."""

    def __init__(self, sections: List[Section], loss_name: str,
                 optimizer, num_microbatches: int,
                 devices: Optional[List] = None, scope=None):
        from ..dygraph.tracer import VarBase
        from ..framework.function import program_as_vjp
        from ..framework.scope import global_scope

        self.sections = sections
        self.loss_name = loss_name
        self.optimizer = optimizer
        self.num_microbatches = int(num_microbatches)
        if devices is None:
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError(
                    "PipelineEngine places its stages on the visible cards "
                    "by default and sees none: pass devices= (e.g. "
                    "[torch.device('cpu')] * stages) to run on the host")
            devices = [torch.device("cuda", s % n)
                       for s in range(len(sections))]
        if len(devices) != len(sections):
            raise ValueError(f"{len(devices)} stage placements for "
                             f"{len(sections)} sections")
        # a stage runs on a list of ranks: one device, or its dp submesh
        self.devices: List[List[torch.device]] = []
        for dv in devices:
            if isinstance(dv, (list, tuple)):
                if not dv:
                    raise ValueError(
                        "a pipeline stage got an EMPTY device list — "
                        f"{torch.cuda.device_count()} card(s) visible; "
                        "check the per-stage device partition")
                self.devices.append([_device(d) for d in dv])
            else:
                self.devices.append([_device(dv)])

        scope = scope or global_scope()
        self._scope = scope
        self._vbs: List[Dict[str, VarBase]] = []
        self._fns = []
        for s, sec in enumerate(sections):
            vbs = {}
            for name in sec.param_names:
                val = scope.find_var(name)
                if val is None:
                    raise RuntimeError(
                        f"parameter {name!r} not initialized — run the "
                        f"startup program first")
                vbs[name] = VarBase(torch.as_tensor(val), name=name,
                                    persistable=True, trainable=True,
                                    device=self.devices[s][0])
            self._vbs.append(vbs)
            self._fns.append(program_as_vjp(
                sec.program, sec.in_names + sec.feed_names, sec.out_names))

    def _params(self, s) -> Dict[str, torch.Tensor]:
        return {n: vb.value for n, vb in self._vbs[s].items()}

    def _checked(self, s, outs):
        """A stage's outputs must lie on its device: a lowering that fell
        back to the host raises rather than run on."""
        want = self.devices[s][0]
        for n, v in zip(self.sections[s].out_names, outs):
            if isinstance(v, torch.Tensor) and v.device.type != want.type:
                raise RuntimeError(
                    f"pipeline stage {s} built for {want} produced "
                    f"{n!r} on {v.device}")
        return outs

    # -- one step ------------------------------------------------------------
    def _microbatches(self, feed):
        M = self.num_microbatches
        for k, v in feed.items():
            if np.asarray(v).shape[0] % M:
                raise ValueError(
                    f"feed {k!r} batch {np.asarray(v).shape[0]} is not "
                    f"divisible by num_microbatches={M}; unequal "
                    f"microbatches would skew the 1/M gradient weighting")
        return [{k: np.ascontiguousarray(np.array_split(np.asarray(v), M)[m])
                 for k, v in feed.items()} for m in range(M)]

    def _forward_wave(self, micro):
        """Every microbatch through every stage; returns each stage's
        stashed (inputs, feeds) per microbatch, the activations by name and
        the losses."""
        M, S = len(micro), len(self.sections)
        stash = [[None] * M for _ in range(S)]
        acts_by_name = [dict() for _ in range(M)]
        losses = [None] * M
        for m in range(M):
            for s, sec in enumerate(self.sections):
                dev = self.devices[s][0]
                acts = [acts_by_name[m][n].to(dev) for n in sec.in_names]
                feeds = [torch.from_numpy(micro[m][n]).to(dev)
                         for n in sec.feed_names]
                stash[s][m] = (acts, feeds)
                outs = self._checked(s, self._fns[s].forward(
                    self._params(s), acts + feeds, self.devices[s]))
                for n, v in zip(sec.out_names, outs):
                    acts_by_name[m][n] = v
                    if n == self.loss_name:
                        losses[m] = v
        return stash, acts_by_name, losses

    def _backward_wave(self, stash, acts_by_name, losses):
        """Reverse order, each section's VJP by recompute; returns each
        stage's parameter gradients summed over the microbatches."""
        M, S = len(losses), len(self.sections)
        gacc: List[Optional[Dict]] = [None] * S
        for m in range(M):
            gacts_by_name: Dict[str, torch.Tensor] = {}
            for s in range(S - 1, -1, -1):
                sec = self.sections[s]
                dev = self.devices[s][0]
                gouts = []
                for n in sec.out_names:
                    if n == self.loss_name:
                        g = torch.full(tuple(losses[m].shape), 1.0 / M,
                                       dtype=torch.float32, device=dev)
                    elif n in gacts_by_name:
                        g = gacts_by_name[n].to(dev)
                    else:
                        g = None            # no later stage reads it
                    gouts.append(g)
                acts, feeds = stash[s][m]
                gp, ga = self._fns[s].vjp(self._params(s), acts + feeds,
                                          gouts, self.devices[s])
                for n, v in zip(sec.in_names, ga):
                    # a boundary var read by several later stages (a skip
                    # connection): the cotangents sum over its consumers
                    if n in gacts_by_name:
                        prev = gacts_by_name[n]
                        gacts_by_name[n] = prev + v.to(prev.device)
                    else:
                        gacts_by_name[n] = v
                if gacc[s] is None:
                    gacc[s] = dict(gp)
                else:
                    gacc[s] = {n: gacc[s][n] + v for n, v in gp.items()}
        return gacc

    def _apply(self, gacc):
        """The inner optimizer's update of each stage through the eager
        apply, on the stage's device (each op runs on its parameter's;
        the guard takes the first stage's)."""
        from ..dygraph import base as dy_base
        from ..place import CPUPlace, CUDAPlace
        dev = self.devices[0][0]
        with dy_base.guard(CPUPlace() if dev.type == "cpu"
                           else CUDAPlace(dev.index or 0)):
            for s, vbs in enumerate(self._vbs):
                for n, vb in vbs.items():
                    vb.grad = gacc[s][n]
                self.optimizer._dygraph_minimize(
                    None, parameter_list=list(vbs.values()))
                for vb in vbs.values():
                    vb.grad = None

    def train_step(self, feed: Dict[str, np.ndarray]) -> float:
        """One optimizer step over ``num_microbatches`` slices of ``feed``;
        returns the mean of the microbatch losses."""
        stash, acts, losses = self._forward_wave(self._microbatches(feed))
        self._apply(self._backward_wave(stash, acts, losses))
        return float(np.mean([float(l.reshape(-1)[0]) for l in losses]))

    def sync_to_scope(self):
        """Write the stages' parameters back to the scope (for
        ``save_persistables``)."""
        for vbs in self._vbs:
            for n, vb in vbs.items():
                self._scope.set_var(n, vb.value)


class PipelineOptimizer:
    """ref ``python/paddle/fluid/optimizer.py:2687`` PipelineOptimizer.

    ``cut_list`` marks the stage boundaries.  The reference's scheduler
    knobs (``place_list``, ``concurrency_list``, ``queue_size``,
    ``sync_steps``, ``start_cpu_core_id``) configure its section-worker
    threads; they are accepted and ignored, as in ``paddle_tpu``."""

    def __init__(self, optimizer, cut_list=None, place_list=None,
                 concurrency_list=None, queue_size=30, sync_steps=1,
                 start_cpu_core_id=0, num_microbatches=1):
        self._inner = optimizer
        self._cut_list = cut_list or []
        self._num_microbatches = num_microbatches
        self._sections: List[Section] = []
        self._loss_name: Optional[str] = None

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Split the forward program at ``cut_list``; the engine runs the
        backward and the apply, so no grad op is appended."""
        program = loss.block.program if hasattr(loss, "block") else \
            default_main_program()
        self._loss_name = loss.name if hasattr(loss, "name") else str(loss)
        self._sections = split_program(program, self._cut_list,
                                       self._loss_name)
        return [], []

    @property
    def sections(self) -> List[Section]:
        return self._sections

    def create_engine(self, devices=None, scope=None) -> PipelineEngine:
        """The runtime, built after the startup program has run."""
        if not self._sections:
            raise RuntimeError("call minimize(loss) first")
        return PipelineEngine(self._sections, self._loss_name, self._inner,
                              self._num_microbatches, devices, scope)
