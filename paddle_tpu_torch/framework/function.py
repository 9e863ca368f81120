"""Program → function: a block as a callable
``fn(params_dict, *feeds) -> fetches`` over torch tensors (the port of
``paddle_tpu/framework/function.py``).

The callable runs the block op by op through the executor's block runner
(``executor.run_plan``), with the plan built once, when the function is
made: an op type with no lowering raises then.  Unlike ``Executor.run`` it
runs no pass of its own (the graph-fusion slot included) and touches no
scope: the block runs exactly as given.  It runs on the device of the
tensors it is given (the params', else the feeds'); numpy feeds go there.
The inference engine (``paddle_tpu_torch.inference``) dispatches through
it.

:func:`program_as_vjp` makes a block a *differentiable* function for the
pipeline engine (``parallel.pipeline``), whose backward is recompute-based
as the reference's ``jax.vjp`` of a section is (``paddle_tpu/parallel/
pipeline.py:236-241``): the forward runs again under autograd, the whole
block treated as one forward op (``registry.run_forward`` makes detached
leaf copies of the parameters and floating arguments) with no detach
between its ops, then ``registry.generic_grad_lower`` takes
``torch.autograd.grad`` of the fetches against the given cotangents.  An op
whose lowering autograd cannot differentiate (its floating outputs carry
no gradient though an input does) raises, naming the op; so does a
collective.  Over a list of ranks (a pipeline stage's ``dp`` submesh) the
floating arguments are split on dim 0, the parameters replicated, and the
block runs rank by rank op by op under the SPMD lowering's batch-on-``dp``
rules (``parallel.spmd``): an op reading a split var keeps dim 0 a batch
dim, and a batch reduction (``mean``, ``reduce_sum``, ``reduce_mean`` over
dim 0) is summed over the ranks in rank order, a mean's scaled by 1/n,
which gives the one-device function on a divisible batch.  The block runs
with seed 0 each call (as :func:`program_as_function`), so a recompute
draws the forward's dropout masks, and every call the same ones.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import registry
from .core import Program, Variable
from .executor import Executor, LowerCtx, _Plan, run_plan
from .scope import Scope, scope_guard


def init_program_params(startup_program: Program, scope=None, seed=0,
                        place=None) -> Dict[str, torch.Tensor]:
    """Run a startup program on ``place`` (the card unless ``CPUPlace()``),
    returning ``{name: tensor}`` of the persistables it set."""
    scope = scope or Scope()
    with scope_guard(scope):
        Executor(place).run(startup_program, scope=scope, seed=seed)
    return {name: val for name, val in scope.items() if val is not None}


def _names(vs):
    return [v.name if isinstance(v, Variable) else v for v in vs]


def _runner(program: Program, feed_names, fetch_names):
    """``run(values, feeds, seed) -> env``: the block's plan, run on a
    copy of ``values`` with the feeds bound."""
    plan = _Plan(program, fetch_names)

    def missing(name):
        raise KeyError(f"op input var {name!r} has no value: not fed, not "
                       "in params, and not produced by a preceding op")

    def run(values, feeds, seed):
        device = next((t.device for t in itertools.chain(values.values(),
                                                         feeds)
                       if isinstance(t, torch.Tensor)), torch.device("cpu"))
        env = dict(values)
        for name, f in zip(feed_names, feeds):
            if not isinstance(f, torch.Tensor):
                f = torch.from_numpy(np.ascontiguousarray(f))
            env[name] = f.to(device)
        with torch.no_grad():
            run_plan(plan, LowerCtx(device, seed, plan.amp), env, missing)
        return env

    return run


def program_as_function(program: Program, feed_names: Sequence[str],
                        fetch_names: Sequence[str]):
    """Return ``fn(params, *feeds) -> tuple(fetches)``; ``params`` is
    ``{name: tensor}`` of every persistable the block reads."""
    feed_names, fetch_names = _names(feed_names), _names(fetch_names)
    run = _runner(program, feed_names, fetch_names)

    def fn(params: Dict[str, torch.Tensor], *feeds):
        env = run(params, feeds, 0)
        return tuple(env[n] for n in fetch_names)

    return fn


def program_as_train_step(program: Program, feed_names: Sequence[str],
                          fetch_names: Sequence[str],
                          state_names: Sequence[str]):
    """``fn(state, *feeds, seed=0) -> (fetches, new_state)``: one optimizer
    step as a function of the training state (params and accumulators)."""
    feed_names, fetch_names = _names(feed_names), _names(fetch_names)
    run = _runner(program, feed_names, fetch_names)

    def fn(state: Dict[str, torch.Tensor], *feeds, seed=0):
        env = run(state, feeds, seed)
        return (tuple(env[n] for n in fetch_names),
                {n: env[n] for n in state_names})

    return fn


def _checked(info: registry.OpInfo) -> registry.OpInfo:
    """``info`` whose lowering raises, under autograd, when it reads an
    input that requires grad and none of its floating outputs does."""
    def lower(ctx, ins, attrs):
        outs = info.lower(ctx, ins, attrs) or {}
        if torch.is_grad_enabled() and not info.no_grad and any(
                isinstance(v, torch.Tensor) and v.requires_grad
                for vs in ins.values() for v in vs):
            fl = [v for vs in outs.values() for v in vs
                  if isinstance(v, torch.Tensor) and v.is_floating_point()]
            if fl and not any(v.requires_grad for v in fl):
                raise NotImplementedError(
                    f"op {info.type!r}: autograd cannot differentiate its "
                    "lowering (its outputs carry no gradient), so a "
                    "differentiated program cannot hold it")
        return outs
    return registry.OpInfo(info.type, lower, info.infer, info.grad_maker,
                           info.no_grad, info.stateful_rng, info.collective,
                           info.grad)


class SectionFunction:
    """A block as a differentiable function of its persistables and
    arguments (:func:`program_as_vjp`)."""

    def __init__(self, program: Program, arg_names, fetch_names):
        self.arg_names = _names(arg_names)
        self.fetch_names = _names(fetch_names)
        self.plan = _Plan(program, self.fetch_names)
        ops = []
        for op, info in self.plan.ops:
            if info.collective or registry.is_generic_grad(op):
                raise NotImplementedError(
                    f"op {op.type!r}: a differentiable program function "
                    "holds forward ops of one rank only")
            ops.append((op, _checked(info)))
        self.ops = ops
        self._info = registry.OpInfo("program_section", self._lower, None)

    # -- the op loop ----------------------------------------------------------
    def _run(self, params: List[Dict[str, torch.Tensor]],
             args: List[list], seed: int = 0):
        """Run the block once a rank (``params[r]``, ``args[r]`` on rank
        r's device), op by op, nothing detached; returns each rank's env
        and the names split on dim 0 over the ranks."""
        from ..parallel.spmd import (_BATCH_REDUCE, _ROW_LOCAL, _ring_sum,
                                     moves_batch_dim)
        plan, n = self.plan, len(params)
        envs, ctxs = [], []
        for p, a in zip(params, args):
            env = dict(p)
            env.update(zip(self.arg_names, a))
            envs.append(env)
            device = next((t.device for t in itertools.chain(p.values(), a)
                           if isinstance(t, torch.Tensor)),
                          torch.device("cpu"))
            ctxs.append(LowerCtx(device, seed, plan.amp))
        split = {name for name, t in zip(self.arg_names, args[0])
                 if n > 1 and isinstance(t, torch.Tensor) and t.dim()}
        for i, (op, info) in enumerate(self.ops):
            rows = [m for m in op.input_arg_names() if m in split]
            if rows and (op.type not in _ROW_LOCAL | _BATCH_REDUCE
                         or moves_batch_dim(op)):
                raise NotImplementedError(
                    f"op {op.type!r} reads {rows[0]!r}, split on dim 0 over "
                    "a stage's devices, and does not keep dim 0 a batch dim")
            for ctx, env in zip(ctxs, envs):
                ins = {}
                for slot, names in op.inputs.items():
                    vals = []
                    for m in names:
                        if m and m not in env:
                            raise KeyError(
                                f"op input var {m!r} has no value: not an "
                                "argument, not in params, and not produced "
                                "by a preceding op")
                        vals.append(env[m] if m else None)
                    ins[slot] = vals
                if ctx.amp:
                    from .. import amp as _amp
                    ins = _amp.cast_ins(op.type, ins)
                outs = registry.lower_one(info, ctx, ins, op.attrs) or {}
                for slot, names in op.outputs.items():
                    for m, v in zip(names, outs.get(slot, [])):
                        if m and v is not None:
                            env[m] = v
            outs = [m for m in op.output_arg_names() if m]
            if rows and op.type in _BATCH_REDUCE and \
                    self._reduces_rows(op):
                for m in outs:
                    tot = _ring_sum([env[m] for env in envs],
                                    envs[0][m].device)
                    if op.type != "reduce_sum":
                        tot = tot / n
                    for ctx, env in zip(ctxs, envs):
                        env[m] = tot.to(ctx.device)
            elif rows:
                split.update(outs)
            for m in plan.free_after[i]:
                for env in envs:
                    env.pop(m, None)
        return envs, split

    @staticmethod
    def _reduces_rows(op) -> bool:
        dim = op.attrs.get("dim")
        if op.type == "mean" or op.attrs.get("reduce_all") or dim is None:
            return True
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        return any(int(d) == 0 for d in dims)

    # -- placement --------------------------------------------------------------
    @staticmethod
    def _place(params, args, devices):
        """Each rank's params (replicated) and args (floating and integer
        tensors with a dim split on dim 0; the rest replicated)."""
        n = len(devices)
        ps = [{k: v.to(d) for k, v in params.items()} for d in devices]
        per = [[] for _ in devices]
        for a in args:
            if n > 1 and isinstance(a, torch.Tensor) and a.dim():
                if a.shape[0] % n:
                    raise ValueError(
                        f"batch {a.shape[0]} does not divide over the "
                        f"{n} devices of a stage")
                for r, (piece, d) in enumerate(zip(a.chunk(n), devices)):
                    per[r].append(piece.to(d))
            else:
                for r, d in enumerate(devices):
                    per[r].append(a.to(d) if isinstance(a, torch.Tensor)
                                  else a)
        return ps, per

    def _lower(self, ctx, ins, attrs):
        """The block as one forward op over every rank (``run_forward``):
        ``Param`` / ``Arg`` hold each rank's values in turn, ``Out`` each
        rank's fetches."""
        n = attrs["ranks"]
        names = list(attrs["param_names"])
        k, a = len(names), len(self.arg_names)
        params = [dict(zip(names, ins["Param"][r * k:(r + 1) * k]))
                  for r in range(n)]
        args = [ins["Arg"][r * a:(r + 1) * a] for r in range(n)]
        envs, split = self._run(params, args)
        attrs["split"] = split
        return {"Out": [env[f] for env in envs for f in self.fetch_names]}

    def _gather(self, vals, split, device):
        return torch.cat([v.to(device) for v in vals]) if split else vals[0]

    # -- the two entry points ------------------------------------------------------
    def forward(self, params: Dict[str, torch.Tensor], args, devices):
        """The fetches (a rank's split fetches joined on dim 0 on
        ``devices[0]``) of the block on ``devices``, without autograd."""
        ps, per = self._place(params, list(args), devices)
        with torch.no_grad():
            envs, split = self._run(ps, per)
        return tuple(self._gather([env[f] for env in envs], f in split,
                                  devices[0]) for f in self.fetch_names)

    def vjp(self, params: Dict[str, torch.Tensor], args, cotangents,
            devices):
        """``(param_grads, arg_grads)``: the forward re-run under autograd
        and ``torch.autograd.grad`` of the fetches against ``cotangents``
        (None: a zero cotangent), each parameter's gradient summed over the
        ranks in rank order on ``devices[0]``, a split argument's joined,
        an integer argument's None."""
        n = len(devices)
        names = list(params)
        ps, per = self._place(params, list(args), devices)
        ins = {"Param": [p[k] for p in ps for k in names],
               "Arg": [a for row in per for a in row]}
        attrs = {"ranks": n, "param_names": names}
        ctx = LowerCtx(devices[0], 0)
        fwd = registry.run_forward(self._info, ctx, ins, attrs)
        split = attrs.pop("split")
        og = []
        for r, d in enumerate(devices):
            for f, g in zip(self.fetch_names, cotangents):
                if g is None or (f not in split and r):
                    og.append(None)         # replicated: rank 0 carries it
                elif f in split:
                    og.append(g.chunk(n)[r].to(d))
                else:
                    og.append(g.to(d))
        res = registry.generic_grad_lower(
            ctx, {"OG$Out": og}, {"__fwd_type__": self._info.type},
            forward=fwd)
        from ..parallel.spmd import _ring_sum
        gp, ga = res["IG$Param"], res["IG$Arg"]
        k, a = len(names), len(self.arg_names)
        dev0 = devices[0]
        pgrads = {m: _ring_sum([gp[r * k + j] for r in range(n)], dev0)
                  for j, m in enumerate(names)}
        agrads = []
        for j, arg in enumerate(args):
            gs = [ga[r * a + j] for r in range(n)]
            if gs[0] is None:
                agrads.append(None)
            elif n > 1 and arg.dim():
                agrads.append(torch.cat([g.to(dev0) for g in gs]))
            else:
                agrads.append(_ring_sum(gs, dev0))
        return pgrads, agrads


def program_as_vjp(program: Program, arg_names: Sequence[str],
                   fetch_names: Sequence[str]) -> SectionFunction:
    """A block as a differentiable function (module docstring):
    ``f.forward(params, args, devices)`` gives the fetches,
    ``f.vjp(params, args, cotangents, devices)`` the gradients of every
    parameter and argument by recompute.  ``devices`` is one device or a
    stage's ``dp`` submesh."""
    return SectionFunction(program, arg_names, fetch_names)
