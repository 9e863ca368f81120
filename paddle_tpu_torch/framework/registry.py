"""Op registry: per-op-type lowering on torch tensors, shape inference and
grad synthesis.

The port's counterpart of ``paddle_tpu/framework/registry.py``.  An op type
registers one *lowering*, ``lower(ctx, ins, attrs) -> outs`` where
``ins``/``outs`` are ``{slot: [tensor]}``; the executor calls it eagerly on
the executor's device.  Shape inference is the lowering itself run on
``device="meta"`` tensors, which carry shapes and dtypes and no data (the
reference runs it under ``jax.eval_shape``).

Gradients: every op gets a synthesized ``<type>_grad`` op desc, the same
desc the reference makes (slots ``X$``/``OG$``/``IG$``, attr
``__fwd_type__``), whose lowering differentiates the forward lowering with
``torch.autograd``.  An op may register a hand-written ``grad_maker``
instead.  Eager torch has no CSE to merge a recomputed forward with the
original, so the executor runs each differentiated forward op once under
``torch.enable_grad()`` (:func:`run_forward`) and hands its graph to the
grad op; :func:`generic_grad_lower` recomputes the forward only when it is
called without one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from .core import Block, Operator, grad_var_name


class OpInfo:
    def __init__(self, type: str, lower: Callable, infer: Optional[Callable],
                 grad_maker: Optional[Callable] = None,
                 no_grad: bool = False, stateful_rng: bool = False,
                 collective: bool = False, grad=None, raw: bool = False):
        self.type = type
        self.lower = lower
        self.infer = infer
        self.grad_maker = grad_maker    # None -> generic autograd grad
        self.no_grad = no_grad
        # draws random bits: a grad op that recomputes it from the run's
        # counter stream replays the forward's draws (executor rng_marks)
        self.stateful_rng = stateful_rng
        # a group lowering over every rank of the dp axis at once:
        # ``lower(ctxs, ins_list, attrs) -> outs_list``, one entry a rank
        # (see :func:`lower_one`)
        self.collective = collective
        # a collective's gradient: a callable giving its group VJP
        # ``vjp(ctxs, ins_list, attrs) -> outs_list`` over the grad op's
        # X$/OG$ inputs and IG$ outputs (None: not differentiable)
        self.grad = grad
        # a shape rule ``shape(ins, attrs) -> {slot: [Meta]}`` that shape
        # inference runs in place of the lowering (``ops/shape_rules.py``)
        self.shape = None
        # a raw op's lowering is ``lower(ctx, block, op, state)``: control
        # flow runs its sub-block over the executor's state (ref while_op.cc
        # executing a sub-block); only its ``infer`` shapes its outputs
        self.raw = raw


_REGISTRY: Dict[str, OpInfo] = {}


def register_op(type: str, lower: Callable = None, *, infer: Callable = None,
                grad_maker: Callable = None, no_grad: bool = False,
                stateful_rng: bool = False, collective: bool = False,
                grad=None, raw: bool = False):
    """Register an op lowering (``infer`` overrides shape inference,
    ``grad_maker`` the generic grad desc, ``no_grad`` marks an op without
    gradient, ``stateful_rng`` one that draws random bits, ``collective``
    a group lowering over the ranks of the executor's collective mode,
    ``grad`` a callable giving a collective's group VJP, ``raw`` a
    lowering ``lower(ctx, block, op, state)`` over the executor's state,
    which control flow needs).  Usable as decorator or call."""
    def deco(fn):
        _REGISTRY[type] = OpInfo(type, fn, infer, grad_maker, no_grad,
                                 stateful_rng, collective, grad, raw)
        return fn
    if lower is not None:
        return deco(lower)
    return deco


def get_op_info(type: str) -> OpInfo:
    if type not in _REGISTRY:
        raise NotImplementedError(f"op {type!r} has no registered lowering")
    return _REGISTRY[type]


def has_op(type: str) -> bool:
    return type in _REGISTRY


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


def lower_one(info: OpInfo, ctx, ins: Dict[str, List], attrs):
    """Run ``info``'s lowering for one rank: a collective op's group
    lowering over a group of one, which is its identity (its single-device
    semantics, the reference's ``collective_axis`` None)."""
    if info.collective:
        return info.lower([ctx], [ins], attrs)[0]
    return info.lower(ctx, ins, attrs)


def collective_grad_info(fwd_info: OpInfo, grad_type: str) -> OpInfo:
    """The grad op of a collective: its group VJP, run as a collective of
    its own (every rank's output gradient at once).  A collective with no
    VJP raises ``NotImplementedError``, as the reference's ``lax.pmax``
    has no differentiation rule: a collective never computes a wrong
    gradient quietly."""
    if fwd_info.grad is None:
        raise NotImplementedError(
            f"op {fwd_info.type!r} is a collective with no gradient (the "
            f"reference's lowering of it has no differentiation rule); a "
            f"program cannot differentiate through it")
    return OpInfo(grad_type, fwd_info.grad(), None, collective=True)


# ---------------------------------------------------------------------------
# build-time shape/dtype inference (ref framework/operator.cc:913 InferShape)
# ---------------------------------------------------------------------------

#: stands in for a symbolic (-1) dim while the lowering runs on meta
#: tensors; a large prime, so a collision with a real dim is unlikely
SENTINEL = 9973


class Meta(NamedTuple):
    """An input or output of a shape rule: its shape (``SENTINEL`` for a
    symbolic dim) and torch dtype."""
    shape: tuple
    dtype: torch.dtype


class AbstractCtx:
    """Lowering context for shape inference: meta device, no generator;
    its random streams are placeholders (no bits are drawn on meta)."""
    device = torch.device("meta")
    generator = None
    amp = False
    rank, nranks = 0, 1

    def rng(self):
        return None

    def rng_tagged(self, tag):
        return None


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


#: the dtype the reference records for an inferred var: it infers with
#: 64-bit types off, so an int64 or float64 result is recorded 32-bit
#: (values keep their 64-bit type at run time in the port)
_RECORDED_DTYPE = {"int64": "int32", "float64": "float32"}


def infer_op(op: Operator, block: Block) -> None:
    """Populate output Variable shape/dtype by the op's shape rule, or by
    running the lowering on meta tensors.  Best effort, as in the
    reference: an op whose lowering needs values (a shape read from a
    tensor) leaves its outputs unset."""
    if op.type not in _REGISTRY:
        return
    info = _REGISTRY[op.type]
    if info.infer is not None:
        info.infer(op, block)
        return
    if info.raw:
        # a sub-block cannot run on meta tensors: a raw op without an
        # ``infer`` leaves its outputs as they are
        return
    had_symbolic = False
    try:
        ins = {}
        for slot, names in op.inputs.items():
            arrs = []
            for n in names:
                if not n:
                    arrs.append(None)
                    continue
                v = block.var(n)
                if v.shape is None:
                    return  # can't infer yet
                if -1 in v.shape:
                    had_symbolic = True
                shape = tuple(SENTINEL if d == -1 else d for d in v.shape)
                dtype = getattr(torch, v.dtype)
                arrs.append(Meta(shape, dtype) if info.shape is not None
                            else torch.empty(shape, dtype=dtype,
                                             device="meta"))
            ins[slot] = arrs
        outs = info.shape(ins, op.attrs) if info.shape is not None \
            else lower_one(info, AbstractCtx(), ins, op.attrs)
        for slot, names in op.outputs.items():
            for n, t in zip(names, outs.get(slot, [])):
                if t is None:
                    continue
                v = block.var(n)
                v.shape = tuple(-1 if (had_symbolic and d == SENTINEL) else d
                                for d in t.shape)
                name = dtype_name(t.dtype)
                v.dtype = _RECORDED_DTYPE.get(name, name)
    except Exception:
        # the executor re-checks with real tensors at run time
        pass


# ---------------------------------------------------------------------------
# generic autograd gradient (stands in for GradOpDescMaker per op)
# ---------------------------------------------------------------------------

GENERIC_GRAD_TYPE_SUFFIX = "_grad"


def make_grad_ops(op: Operator, block: Block,
                  no_grad_set: set) -> List[Dict[str, Any]]:
    """Grad op descs for ``op`` (ref core.get_grad_op_desc), exactly as
    ``paddle_tpu.framework.registry.make_grad_ops`` makes them: a list of
    ``{type, inputs, outputs, attrs}`` dicts, grad vars named
    ``<name>@GRAD``."""
    info = get_op_info(op.type)
    if info.no_grad:
        return []
    if info.grad_maker is not None:
        return info.grad_maker(op, block, no_grad_set)
    if info.raw:
        return []       # no generic gradient over a sub-block
    g_inputs: Dict[str, List[str]] = {}
    for slot, names in op.inputs.items():
        g_inputs["X$" + slot] = list(names)
    for slot, names in op.outputs.items():
        g_inputs["OG$" + slot] = [grad_var_name(n) for n in names]
    g_outputs: Dict[str, List[str]] = {}
    for slot, names in op.inputs.items():
        outs = []
        for n in names:
            v = block.var(n) if block.has_var(n) else None
            if n in no_grad_set or (v is not None and v.stop_gradient):
                outs.append("")          # empty = not needed (ref kEmptyVarName)
            else:
                outs.append(grad_var_name(n))
        g_outputs["IG$" + slot] = outs
    attrs = dict(op.attrs)
    attrs["__fwd_type__"] = op.type
    return [{"type": op.type + GENERIC_GRAD_TYPE_SUFFIX,
             "inputs": g_inputs, "outputs": g_outputs, "attrs": attrs,
             "__generic__": True}]


def is_generic_grad(op: Operator) -> bool:
    """A synthesized ``*_grad`` op: its type has no lowering of its own."""
    return "__fwd_type__" in op.attrs and op.type not in _REGISTRY


#: a forward op run for differentiation: its inputs by slot (leaves that
#: require grad where a gradient is wanted) and its outputs with their graph
Forward = Tuple[Dict[str, List], Dict[str, List]]


def run_forward(info: OpInfo, ctx, ins: Dict[str, List], attrs,
                wanted: Optional[Dict[str, List[bool]]] = None) -> Forward:
    """Run a forward lowering under ``torch.enable_grad()`` on detached
    copies of its floating inputs that require grad (those ``wanted``
    marks; all of them when ``wanted`` is None).  Under AMP
    (``ctx.amp``) the inputs are cast after the leaves are made, inside
    the differentiated function (the reference's ``registry.py:223-227``):
    a float32 master weight's gradient comes back float32 through the
    cast, where a cast before the leaves would round it to bf16.  A
    collective's gradient is its group VJP (:func:`collective_grad_info`),
    never autograd through one rank."""
    if info.collective:
        raise NotImplementedError(
            f"op {info.type!r} is a collective: its gradient is its group "
            f"VJP (registry.collective_grad_info), not autograd")
    leaves = {}
    for slot, vals in ins.items():
        want = [True] * len(vals) if wanted is None else \
            wanted.get(slot, [False] * len(vals))
        row = []
        for j, v in enumerate(vals):
            if v is not None and v.is_floating_point() and want[j]:
                v = v.detach().requires_grad_(True)
            row.append(v)
        leaves[slot] = row
    with torch.enable_grad():
        cast = leaves
        if ctx.amp:
            from .. import amp
            cast = amp.cast_ins(info.type, leaves)
        outs = info.lower(ctx, cast, attrs) or {}
    return leaves, outs


def generic_grad_lower(ctx, ins: Dict[str, List], attrs: Dict[str, Any],
                       forward: Optional[Forward] = None):
    """Lowering of a synthesized ``*_grad`` op: ``torch.autograd.grad`` of
    the forward lowering.  ``forward`` is the graph the executor kept from
    the forward op; without it the forward is recomputed from the ``X$``
    inputs.  An absent output grad is a zero cotangent; an input the
    outputs do not depend on gets a zero gradient, and a non-floating one
    None."""
    fwd_type = attrs["__fwd_type__"]
    if forward is None:
        fwd_attrs = {k: v for k, v in attrs.items() if k != "__fwd_type__"}
        x_ins = {s[2:]: list(v) for s, v in ins.items() if s.startswith("X$")}
        forward = run_forward(get_op_info(fwd_type), ctx, x_ins, fwd_attrs)
    leaves, outs = forward
    outputs, cotangents = [], []
    for slot in sorted(s[3:] for s in ins if s.startswith("OG$")):
        for out, og in zip(outs.get(slot, []), ins["OG$" + slot]):
            if og is None or out is None or not out.requires_grad:
                continue
            outputs.append(out)
            cotangents.append(og.to(out.dtype))
    wrt = [(slot, j, t) for slot, vals in leaves.items()
           for j, t in enumerate(vals)
           if t is not None and t.requires_grad]
    grads = [None] * len(wrt)
    if outputs and wrt:
        grads = torch.autograd.grad(outputs, [t for _, _, t in wrt],
                                    cotangents, allow_unused=True)
    result = {"IG$" + slot: [None] * len(vals)
              for slot, vals in leaves.items()}
    for (slot, j, t), g in zip(wrt, grads):
        result["IG$" + slot][j] = torch.zeros_like(t) if g is None else g
    return result
