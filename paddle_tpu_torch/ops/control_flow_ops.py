"""Control-flow op lowerings (the port's ``paddle_tpu/ops/control_flow_ops.py``,
ref ``operators/controlflow/while_op.cc``, ``conditional_block_op.cc``,
``recurrent_op.cc``, ``tensor_array_read_write_op.cc``, ``py_func_op.cc``).

The reference traces a sub-block once into ``lax.while_loop`` /
``lax.cond`` / ``lax.scan``; the port runs it eagerly, an iteration at a
time, over an ``ExecState`` of its own (``framework/executor.py``
``run_block``):

- ``while`` reads its condition on the host before each iteration (one
  sync an iteration on the card, counted by :func:`host_syncs`); the
  bounded form (``max_trip_count``) stops there too, so a dead iteration
  never runs the body, as the reference's ``lax.cond`` skips it;
- ``while_grad`` and ``static_scan_grad`` replay the loop from its
  snapshotted inputs under ``torch.autograd`` and differentiate the replay
  (the reference's ``jax.vjp`` of the scan);
- ``conditional_block`` reads its predicate on the host and runs the
  sub-block only when it holds;
- the tensor arrays are dense ``[max_len, ...]`` buffers plus a length
  scalar, updated functionally, as in the reference.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, List

import numpy as np
import torch

from ..framework.registry import get_op_info, register_op
from .common import X, XS, canon_dtype

#: host reads of a control-flow decision since the last reset, by op type
_SYNCS: Dict[str, int] = {"while": 0, "conditional_block": 0}
#: the iterations ``while`` ran, and the ops run inside loop and branch
#: bodies, since the last reset
_TRIPS = [0]
_BODY_OPS = [0]


def host_syncs() -> Dict[str, int]:
    """Host reads of a loop condition or a branch predicate (each a sync
    on the card), the while iterations run and the ops dispatched inside
    sub-blocks (a grad op's replay included), since the last
    :func:`reset_host_syncs`."""
    return dict(_SYNCS, while_iterations=_TRIPS[0], body_ops=_BODY_OPS[0])


def reset_host_syncs() -> None:
    for k in _SYNCS:
        _SYNCS[k] = 0
    _TRIPS[0] = _BODY_OPS[0] = 0


def _host_bool(t, kind) -> bool:
    _SYNCS[kind] += 1
    return bool(t.reshape(()).item())


def _sub_state(state, values):
    from ..framework.executor import ExecState
    return ExecState(dict(values), state.lookup)


def _run_body(ctx, sub_block, state, values):
    """One run of ``sub_block`` over ``values`` atop ``state``; the
    sub-block's state after it."""
    from ..framework.executor import run_block
    st = _sub_state(state, values)
    run_block(ctx, sub_block, st)
    _BODY_OPS[0] += len(sub_block.ops)
    return st


def _mark_rng(ctx, sub_block):
    """Where a loop starts to draw random bits (the run's counter of
    dropout streams, and its generator's state), for the loop's grad op."""
    ctx.rng_marks[("loop", sub_block.idx)] = (ctx._counter,
                                              ctx.generator.get_state())


@contextlib.contextmanager
def _replaying(ctx, sub_block):
    """The grad op's replay of a loop draws the bits its forward drew:
    the counter and the generator rewind to the forward's mark, and come
    back after (the top-level ``executor._replay_grad``)."""
    mark = ctx.rng_marks.get(("loop", sub_block.idx))
    if mark is None:
        yield
        return
    saved = ctx._counter, ctx.generator.get_state()
    ctx._counter = mark[0]
    ctx.generator.set_state(mark[1])
    try:
        yield
    finally:
        ctx._counter = saved[0]
        ctx.generator.set_state(saved[1])


def _run_while(ctx, sub_block, carried, cond_name, init: Dict, state,
               max_trips):
    """The loop over the carried values ``init``: (final values, whether
    the condition still held when ``max_trips`` stopped it).  Each
    iteration's carried values keep their dtype and shape (the reference's
    scan carry)."""
    env = dict(init)
    trips = 0
    while max_trips is None or trips < max_trips:
        if not _host_bool(env[cond_name], "while"):
            return env, False
        st = _run_body(ctx, sub_block, state, env)
        env = {n: st.lookup(n).to(c.dtype).reshape(c.shape)
               for n, c in env.items()}
        trips += 1
        _TRIPS[0] += 1
    return env, cond_name in env and _host_bool(env[cond_name], "while")


def _while_grad_maker(op, block, no_grad_set):
    """Grad op for the bounded (max_trip_count) while (ref
    ``control_flow_ops.py:54``): consumes the final carried grads, replays
    the loop from the snapshotted initial values, and emits grads for the
    initial carried values.  An unbounded while stays forward-only."""
    from ..framework.core import grad_var_name
    if "max_trip_count" not in op.attrs:
        return []
    carried = op.attrs["carried_vars"]

    def _is_float(n):
        if not block.has_var(n):
            return False
        v = block.var(n)
        # an unknown dtype is taken as float, so no gradient flow is
        # dropped quietly (a zero cotangent of an integer carry is harmless)
        return v.dtype is None or str(v.dtype).startswith("float")

    g_inputs = {
        "InitSnapshot": list(op.input("InitSnapshot")),
        "OutGrad": [grad_var_name(n) if _is_float(n) else ""
                    for n in carried],
    }
    g_outputs = {
        "InitGrad": [grad_var_name(n)
                     if _is_float(n) and n not in no_grad_set else ""
                     for n in carried],
    }
    return [{"type": "while_grad", "inputs": g_inputs,
             "outputs": g_outputs, "attrs": dict(op.attrs)}]


@register_op("while", raw=True, grad_maker=_while_grad_maker)
def _while(ctx, block, op, state):
    sub_block = op.attrs["sub_block"]
    carried = op.attrs["carried_vars"]
    cond_name = op.input("Condition")[0]
    max_trips = op.attrs.get("max_trip_count")
    init = {n: state.lookup(n) for n in carried}
    _mark_rng(ctx, sub_block)
    final, truncated = _run_while(ctx, sub_block, carried, cond_name, init,
                                  state, max_trips)
    if truncated:
        # an under-sized max_trip_count truncates the loop: its result and
        # its gradients are wrong, so say so (the reference prints too)
        print(f"WARNING: while(max_trip_count={max_trips}) stopped with its "
              f"condition still true: the loop was truncated and its "
              f"result and gradients are wrong; raise max_trip_count",
              file=sys.stderr, flush=True)
    for n in carried:
        state.write(n, final[n])


def _cot(state, gname, primal):
    """The cotangent of ``primal``: the named gradient, or None."""
    g = state.get(gname) if gname else None
    return None if g is None else g.to(primal.dtype)


def _grad_of(leaves, outputs, cots):
    """``torch.autograd.grad`` of ``outputs`` (with ``cots``) by
    ``leaves``: a zero gradient where a leaf is unused."""
    pairs = [(o, c) for o, c in zip(outputs, cots)
             if c is not None and o.requires_grad]
    grads = [None] * len(leaves)
    if pairs and leaves:
        grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                    [c for _, c in pairs],
                                    allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)]


def _leaf(v):
    return v.detach().requires_grad_(True)


@register_op("while_grad", raw=True)
def _while_grad(ctx, block, op, state):
    sub_block = op.attrs["sub_block"]
    carried = op.attrs["carried_vars"]
    max_trips = op.attrs["max_trip_count"]
    cond_name = op.attrs["cond_var"]
    init_vals = [state.lookup(n) for n in op.input("InitSnapshot")]
    # the grad maker names an InitGrad wherever a carry might be float;
    # the values decide
    diff_idx = [i for i in range(len(carried))
                if op.output("InitGrad")[i]
                and init_vals[i].is_floating_point()]
    with torch.enable_grad(), _replaying(ctx, sub_block):
        leaves = {i: _leaf(init_vals[i]) for i in diff_idx}
        init = {n: leaves.get(i, init_vals[i])
                for i, n in enumerate(carried)}
        final, _ = _run_while(ctx, sub_block, carried, cond_name, init,
                              state, max_trips)
        outs = [final[carried[i]] for i in diff_idx]
        cots = [_cot(state, op.input("OutGrad")[i], o)
                for i, o in zip(diff_idx, outs)]
        grads = _grad_of([leaves[i] for i in diff_idx], outs, cots)
    for i, g in zip(diff_idx, grads):
        state.write(op.output("InitGrad")[i], g)


@register_op("conditional_block", no_grad=True, raw=True)
def _conditional_block(ctx, block, op, state):
    """ref conditional_block_op.cc: the sub-block runs when the predicate
    holds.  Its outputs keep their values when it does not (zeros for one
    that has none), the reference's requirement that they pre-exist."""
    sub_block = op.attrs["sub_block"]
    cond_name = op.input("Cond")[0] if op.input("Cond") \
        else op.input("Condition")[0]
    out_names = op.output("Out")
    if _host_bool(state.lookup(cond_name), "conditional_block"):
        st = _run_body(ctx, sub_block, state, {})
        for n in out_names:
            state.write(n, st.lookup(n))
        return
    for n in out_names:
        if state.get(n) is None:
            state.write(n, torch.zeros((), device=ctx.device))


def _scan(ctx, sub_block, state, attrs, seqs, inits, params=None):
    """The recurrence of ``static_scan`` over ``seqs`` (batch-major unless
    ``time_major``) from ``inits``: (final states, stacked step outputs).
    ``params`` (name -> value) override the captured reads."""
    state_names = attrs["state_vars"]
    xs_names = attrs["step_input_vars"]
    out_names = attrs["step_output_vars"]
    time_major = attrs.get("time_major", False)
    xs = [s if time_major else s.transpose(0, 1) for s in seqs]
    steps = range(xs[0].shape[0]) if xs else range(0)
    if attrs.get("reverse", False):
        steps = reversed(steps)
    carry = list(inits)
    ys: List[List] = [[] for _ in out_names]
    for t in steps:
        values = dict(params or {})
        values.update(zip(state_names, carry))
        values.update((n, x[t]) for n, x in zip(xs_names, xs))
        st = _run_body(ctx, sub_block, state, values)
        carry = [st.lookup(n) for n in state_names]
        for y, n in zip(ys, out_names):
            y.append(st.lookup(n))
    if attrs.get("reverse", False):
        ys = [y[::-1] for y in ys]           # in the inputs' time order
    stacked = [torch.stack(y, 0) for y in ys]
    if not time_major:
        stacked = [v.transpose(0, 1) for v in stacked]
    return carry, stacked


@register_op("static_scan", raw=True)
def _static_scan(ctx, block, op, state):
    """A recurrence over a time axis (ref ``recurrent_op.cc`` /
    StaticRNN; the reference's ``lax.scan``): attrs carry the sub-block,
    the state vars (their initial values in ``Init``), the per-step inputs
    (scanned along time) and the per-step outputs (stacked along time)."""
    seqs = [state.lookup(n) for n in op.input("X")]
    inits = [state.lookup(n) for n in op.input("Init")]
    _mark_rng(ctx, op.attrs["sub_block"])
    final, stacked = _scan(ctx, op.attrs["sub_block"], state, op.attrs,
                           seqs, inits)
    for n, v in zip(op.output("FinalStates"), final):
        state.write(n, v)
    for n, v in zip(op.output("Out"), stacked):
        state.write(n, v)


def _static_scan_grad_maker(op, block, no_grad_set):
    from ..framework.core import grad_var_name

    def outs_for(names):
        res = []
        for n in names:
            v = block.var(n) if block.has_var(n) else None
            if n in no_grad_set or (v is not None and v.stop_gradient):
                res.append("")
            else:
                res.append(grad_var_name(n))
        return res

    g_inputs = {
        "X": list(op.input("X")),
        "Init": list(op.input("Init")),
        "Params": list(op.input("Params")),
        "OutGrad": [grad_var_name(n) for n in op.output("Out")],
        "FinalGrad": [grad_var_name(n) for n in op.output("FinalStates")],
    }
    g_outputs = {
        "XGrad": outs_for(op.input("X")),
        "InitGrad": outs_for(op.input("Init")),
        "ParamsGrad": outs_for(op.input("Params")),
    }
    return [{"type": "static_scan_grad", "inputs": g_inputs,
             "outputs": g_outputs, "attrs": dict(op.attrs)}]


def _static_scan_infer(op, block):
    """FinalStates mirror the in-block state vars; Out stacks the in-block
    step outputs along the time axis (axis 0 time-major, 1 otherwise)
    (ref ``control_flow_ops.py:475``)."""
    sub = op.attrs["sub_block"]
    time_major = op.attrs.get("time_major", False)
    T = None
    xs = op.input("X")
    if xs:
        xv = block.var(xs[0])
        if xv.shape is not None:
            if time_major:
                T = xv.shape[0]
            elif len(xv.shape) > 1:
                T = xv.shape[1]

    def inner(name):
        return sub.var(name) if sub.has_var(name) else None

    for n_out, n_in in zip(op.output("FinalStates"),
                           op.attrs["state_vars"]):
        iv, v = inner(n_in), block.var(n_out)
        if iv is None:
            continue
        if iv.shape is not None:
            v.shape = tuple(iv.shape)
        v.dtype = iv.dtype
    for n_out, n_in in zip(op.output("Out"),
                           op.attrs["step_output_vars"]):
        iv, v = inner(n_in), block.var(n_out)
        if iv is None:
            continue
        if iv.shape is not None:
            s = list(iv.shape)
            t = -1 if T is None else T
            v.shape = tuple([t] + s) if time_major \
                else tuple(s[:1] + [t] + s[1:])
        v.dtype = iv.dtype


get_op_info("static_scan").grad_maker = _static_scan_grad_maker
get_op_info("static_scan").infer = _static_scan_infer


@register_op("static_scan_grad", raw=True)
def _static_scan_grad(ctx, block, op, state):
    """The scan replayed from its inputs under ``torch.autograd`` and
    differentiated by X, Init and Params (ref ``recurrent_op.cc``
    RecurrentGradOp; the reference's ``jax.vjp`` of the scan)."""
    groups = [("X", "XGrad"), ("Init", "InitGrad"), ("Params", "ParamsGrad")]
    vals = {slot: [state.lookup(n) for n in op.input(slot)]
            for slot, _ in groups}
    with torch.enable_grad(), _replaying(ctx, op.attrs["sub_block"]):
        leaves = []         # (grad name, leaf)
        for slot, gslot in groups:
            for j, (v, g) in enumerate(zip(vals[slot], op.output(gslot))):
                if g and v.is_floating_point():
                    vals[slot][j] = _leaf(v)
                    leaves.append((g, vals[slot][j]))
        final, stacked = _scan(ctx, op.attrs["sub_block"], state, op.attrs,
                               vals["X"], vals["Init"],
                               dict(zip(op.input("Params"), vals["Params"])))
        outs = list(final) + list(stacked)
        cots = [_cot(state, n, v) for n, v in zip(
            op.input("FinalGrad") + op.input("OutGrad"), outs)]
        grads = _grad_of([t for _, t in leaves], outs, cots)
    for (g, _), v in zip(leaves, grads):
        state.write(g, v)


@register_op("select_input", no_grad=True)
def _select_input(ctx, ins, attrs):
    xs = XS(ins, "X")
    idx = int(X(ins, "Mask").reshape(()).item())
    return {"Out": [xs[idx]]}


@register_op("print", no_grad=True)
def _print(ctx, ins, attrs):
    x = X(ins, "In")
    print(attrs.get("message", "") + str(x.detach().cpu().numpy()),
          flush=True)
    return {"Out": [x]}


# ---------------------------------------------------------------------------
# TensorArray ops: a dense [max_len, ...] buffer and a length scalar (ref
# operators/controlflow/tensor_array_read_write.cc, LoDTensorArray)
# ---------------------------------------------------------------------------

def _index(i):
    return i.reshape(()).to(torch.int64)


@register_op("array_write")
def _array_write(ctx, ins, attrs):
    x, arr, ln = X(ins, "X"), X(ins, "Array"), X(ins, "ArrayLen")
    i = _index(X(ins, "I"))
    if arr is None:
        arr = torch.zeros((attrs.get("max_len", 128),) + tuple(x.shape),
                          dtype=x.dtype, device=x.device)
        ln = torch.zeros((), dtype=torch.int32, device=x.device)
    max_len = arr.shape[0]
    # the reference's dynamic_update_slice clamps the start index, and the
    # length counter with it: array_length never exceeds the buffer
    at = i.clamp(0, max_len - 1)
    onehot = (torch.arange(max_len, device=arr.device) == at).reshape(
        (max_len,) + (1,) * x.dim())
    arr = torch.where(onehot, x.unsqueeze(0).to(arr.dtype), arr)
    ln = torch.clamp(torch.maximum(ln.to(torch.int32),
                                   (i + 1).to(torch.int32)), max=max_len)
    return {"Out": [arr], "OutLen": [ln]}


@register_op("array_read")
def _array_read(ctx, ins, attrs):
    arr = X(ins, "Array")
    i = _index(X(ins, "I")).clamp(0, arr.shape[0] - 1)
    return {"Out": [torch.index_select(arr, 0, i.reshape(1))[0]]}


@register_op("array_length", no_grad=True)
def _array_length(ctx, ins, attrs):
    return {"Out": [X(ins, "ArrayLen").to(torch.int64)]}


@register_op("tensor_array_to_tensor")
def _tensor_array_to_tensor(ctx, ins, attrs):
    """Stack or concat the whole buffer (rows past the length are zero;
    callers mask by the length, as with any padded batch)."""
    arr = X(ins, "Array")
    axis = attrs.get("axis", 0)
    if attrs.get("use_stack", True):
        out = torch.movedim(arr, 0, axis) if axis else arr
        per_elem = 1
    else:
        out = torch.cat(list(arr.unbind(0)), dim=axis)
        per_elem = arr.shape[1 + axis] if arr.dim() > 1 + axis else 1
    index = torch.full((arr.shape[0],), per_elem, dtype=torch.int32,
                       device=arr.device)
    return {"Out": [out], "OutIndex": [index]}


def _alias(new, old):
    info = get_op_info(old)
    register_op(new, info.lower, infer=info.infer,
                grad_maker=info.grad_maker, no_grad=info.no_grad,
                stateful_rng=info.stateful_rng, raw=info.raw)


# ref compat_ops.py:29-34: tensor_array_read_write_op.cc's names,
# conditional_block_infer_op.cc
_alias("write_to_array", "array_write")
_alias("read_from_array", "array_read")
_alias("lod_array_length", "array_length")
_alias("conditional_block_infer", "conditional_block")


# ---------------------------------------------------------------------------
# py_func: a host Python function as an op (ref operators/py_func_op.cc),
# its optional backward through torch.autograd.Function
# ---------------------------------------------------------------------------

PY_FUNC_TABLE: Dict[int, Dict] = {}


class _PyFunc(torch.autograd.Function):
    @staticmethod
    def forward(fctx, entry, specs, *xs):
        outs = _call_host(entry["forward"], xs, specs)
        fctx.entry = entry
        fctx.save_for_backward(*xs, *outs)
        fctx.n = len(xs)
        return tuple(outs)

    @staticmethod
    def backward(fctx, *gs):
        saved = fctx.saved_tensors
        xs, outs = saved[:fctx.n], saved[fctx.n:]
        specs = [(tuple(x.shape), x.dtype) for x in xs]
        grads = _call_host(fctx.entry["backward"], (*xs, *outs, *gs), specs)
        return (None, None, *grads)


def _call_host(fn, arrs, specs):
    """``fn`` on the host values of ``arrs``; its results as tensors of
    ``specs`` (shape, dtype) on the inputs' device."""
    device = arrs[0].device
    outs = fn(*[a.detach().cpu().numpy() for a in arrs])
    if not isinstance(outs, (tuple, list)):
        outs = (outs,)
    return [torch.as_tensor(np.asarray(o)).to(device=device, dtype=dt)
            .reshape(shape) for o, (shape, dt) in zip(outs, specs)]


@register_op("py_func")
def _py_func(ctx, ins, attrs):
    entry = PY_FUNC_TABLE[attrs["func_id"]]
    xs = XS(ins, "X")
    specs = [(tuple(xs[0].shape[0] if s == -1 else s for s in shape),
              canon_dtype(dtype))
             for shape, dtype in zip(attrs["out_shapes"],
                                     attrs["out_dtypes"])]
    if entry.get("backward") is None:
        outs = _call_host(entry["forward"], xs, specs)
    else:
        outs = _PyFunc.apply(entry, specs, *xs)
    return {"Out": list(outs)}


@register_op("ifelse_merge")
def _ifelse_merge(ctx, ins, attrs):
    """Row-wise merge of IfElse branch outputs by a bool cond [batch, 1]."""
    cond, x, y = X(ins, "Cond"), X(ins, "X"), X(ins, "Y")
    c = cond.reshape((cond.shape[0],) + (1,) * (x.dim() - 1)).to(torch.bool)
    return {"Out": [torch.where(c, x, y)]}


@register_op("drnn_iota", no_grad=True)
def _drnn_iota(ctx, ins, attrs):
    """[batch, T] -> row-wise arange(T): scanned batch-major, each step's
    time index for DynamicRNN's masking."""
    x = X(ins, "X")
    return {"Out": [torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device).expand(x.shape)]}


@register_op("drnn_masked_update")
def _drnn_masked_update(ctx, ins, attrs):
    """new where t < seq_len else prev: a finished row's state freezes."""
    t, sl = X(ins, "T"), X(ins, "SeqLen")
    new, prev = X(ins, "New"), X(ins, "Prev")
    mask = t.to(torch.int64) < sl.to(torch.int64)
    mask = mask.reshape((mask.shape[0],) + (1,) * (new.dim() - 1))
    return {"Out": [torch.where(mask, new, prev)]}
