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
"""

from __future__ import annotations

import itertools
from typing import Dict, Sequence

import numpy as np
import torch

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
