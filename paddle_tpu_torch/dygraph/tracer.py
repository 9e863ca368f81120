"""Eager (define-by-run) execution: ``VarBase`` tensors and a tape (the
port of ``paddle_tpu/dygraph/tracer.py``; ref ``imperative/tracer.h:31-46``
Tracer::TraceOp, ``imperative/layer.h:55,168`` VarBase/OpBase,
``imperative/engine.h`` and ``imperative/gradient_accumulator.h``).

Every traced op runs the same registered lowering the executor runs, on
its first ``VarBase`` input's device (the guard's where it has none).  An
op that needs a gradient is taped as a :class:`TapeNode` whose backward is
the static path's own:

- an op with a hand-written ``grad_maker`` (``dropout``, ``batch_norm``,
  ``softmax_with_cross_entropy``) runs the grad ops its maker describes,
  on the forward's inputs, outputs and context (a dropout's grad reads the
  ``Mask`` its forward wrote, and launches the dropout kernel on the card);
- any other op is differentiated by ``torch.autograd.grad`` over the graph
  its forward left (``registry.run_forward``): one small graph a node, so
  ``backward`` is the reference's reverse sweep over the tape, seeding
  ones at the root, handing each node its outputs' ``.grad`` as
  cotangents and adding the input gradients into ``.grad``
  (GradientAccumulator).  An op whose floating outputs carry no gradient
  though an input needs one raises and names the op.

The tape is cleared after ``backward`` unless ``retain_graph``.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..framework import registry, unique_name
from ..framework.core import Operator, grad_var_name


def as_tensor(value, device=None) -> torch.Tensor:
    """``value`` (a tensor, a ``VarBase`` or array-like) as a tensor on
    ``device`` (a tensor's own device when None, else the host)."""
    if isinstance(value, VarBase):
        value = value.value
    if not isinstance(value, torch.Tensor):
        arr = np.ascontiguousarray(np.asarray(value))
        # torch does not wrap a read-only array (a jax array's view): copy
        value = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return value if device is None else value.to(device)


def constant(value, device) -> torch.Tensor:
    """An array-like (a number, a numpy array) as a tensor on ``device``,
    float64 narrowed to float32 as the reference's ``jnp.asarray``
    narrows it; integers keep their width (the port keeps int64 ids)."""
    if isinstance(value, (torch.Tensor, VarBase)):
        return as_tensor(value, device)
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return as_tensor(arr, device)


def _floating(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


class VarBase:
    """An eager tensor: ``value`` on its device, ``grad`` (a tensor or
    None), ``name``, ``persistable``, ``trainable``, ``stop_gradient``."""

    def __init__(self, value, name: Optional[str] = None,
                 stop_gradient: bool = False, persistable: bool = False,
                 trainable: bool = True, device=None):
        self._value = as_tensor(value, device)
        self.name = name or unique_name.generate("eager_tmp")
        self.stop_gradient = stop_gradient
        self.persistable = persistable
        self.trainable = trainable
        self.grad: Optional[torch.Tensor] = None

    # -- data access ---------------------------------------------------------
    @property
    def value(self) -> torch.Tensor:
        return self._value

    def set_value(self, v):
        """Hold ``v`` on this var's device."""
        self._value = as_tensor(v, self._value.device)

    def numpy(self) -> np.ndarray:
        return _to_numpy(self._value)

    @property
    def device(self) -> torch.device:
        return self._value.device

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self) -> str:
        return str(self._value.dtype).replace("torch.", "")

    @property
    def ndim(self):
        return self._value.dim()

    def __len__(self):
        return self._value.shape[0]

    def detach(self) -> "VarBase":
        return VarBase(self._value, stop_gradient=True)

    def astype(self, dtype):
        return _trace_unary("cast", self, {"out_dtype": str(np.dtype(dtype))})

    # -- autograd ------------------------------------------------------------
    def backward(self, backward_strategy=None, retain_graph: bool = False):
        """Reverse sweep of the global tape from this var (ref
        ``imperative/engine.cc`` Engine::Execute).  Accepts fluid's
        ``loss.backward(BackwardStrategy())`` call form; a strategy does not
        bind to ``retain_graph``."""
        from .base import BackwardStrategy
        if backward_strategy is not None and \
                not isinstance(backward_strategy, BackwardStrategy):
            retain_graph = bool(backward_strategy)
        default_tracer().backward(self, retain_graph=retain_graph)

    def gradient(self) -> Optional[np.ndarray]:
        return None if self.grad is None else _to_numpy(self.grad)

    def clear_gradient(self):
        self.grad = None

    # -- operator sugar (the static Variable's op set) -----------------------
    def _binary(self, other, op_type, reverse=False):
        x, y = (other, self) if reverse else (self, other)
        return _trace_binary(op_type, x, y)

    def __add__(self, o): return self._binary(o, "elementwise_add")
    def __radd__(self, o): return self._binary(o, "elementwise_add", True)
    def __sub__(self, o): return self._binary(o, "elementwise_sub")
    def __rsub__(self, o): return self._binary(o, "elementwise_sub", True)
    def __mul__(self, o): return self._binary(o, "elementwise_mul")
    def __rmul__(self, o): return self._binary(o, "elementwise_mul", True)
    def __truediv__(self, o): return self._binary(o, "elementwise_div")
    def __rtruediv__(self, o): return self._binary(o, "elementwise_div", True)
    def __pow__(self, o): return self._binary(o, "elementwise_pow")
    def __neg__(self): return _trace_unary("scale", self, {"scale": -1.0})

    def __getitem__(self, idx):
        return default_tracer().trace_fn(lambda v: v[idx], [self])[0]

    def __repr__(self):
        return (f"VarBase(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, stop_gradient={self.stop_gradient})\n"
                f"{self.numpy()}")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _trace_binary(op_type, x, y):
    outs = default_tracer().trace_op(op_type, {"X": [x], "Y": [y]},
                                     {"axis": -1})
    return outs["Out"][0]


def _trace_unary(op_type, x, attrs):
    return default_tracer().trace_op(op_type, {"X": [x]}, attrs)["Out"][0]


def _NONE():
    return None


class TapeNode:
    """One recorded forward op: its inputs, weak references to its
    outputs, and ``vjp(cotangents, retain_graph) -> input gradients``."""

    __slots__ = ("inputs", "outputs", "vjp")

    def __init__(self, inputs: List[Optional[VarBase]],
                 outputs: List[VarBase], vjp: Callable):
        self.inputs = inputs
        # a dead output can no longer receive or pass on a gradient
        self.outputs = [_NONE if o is None else weakref.ref(o)
                        for o in outputs]
        self.vjp = vjp


def _autograd_vjp(leaves: List, outs: List):
    """The backward of a node differentiated by autograd: the gradients of
    ``leaves`` (None where a leaf needs none) from the outputs'
    cotangents."""
    wrt = [i for i, t in enumerate(leaves)
           if isinstance(t, torch.Tensor) and t.requires_grad]

    def vjp(cts, retain_graph):
        pairs = [(o, g) for o, g in zip(outs, cts)
                 if g is not None and o is not None and o.requires_grad]
        grads = [None] * len(leaves)
        if not pairs or not wrt:
            return grads
        got = torch.autograd.grad([o for o, _ in pairs],
                                  [leaves[i] for i in wrt],
                                  [g.to(o.dtype) for o, g in pairs],
                                  retain_graph=retain_graph,
                                  allow_unused=True)
        for i, g in zip(wrt, got):
            grads[i] = torch.zeros_like(leaves[i]) if g is None else g
        return grads
    return vjp


def _grad_op_vjp(info, ctx, attrs, ins: Dict[str, List],
                 outs: Dict[str, List]):
    """The backward of an op with a ``grad_maker``: its grad op descs, run
    through their lowerings on the forward's inputs, outputs and context.
    Vars are named by slot and position (``in:X:0``, ``out:Mask:0``)."""
    op = Operator(None, info.type,
                  {s: [f"in:{s}:{j}" for j in range(len(v))]
                   for s, v in ins.items()},
                  {s: [f"out:{s}:{j}" for j in range(len(v))]
                   for s, v in outs.items()}, attrs)
    env = {f"in:{s}:{j}": t for s, v in ins.items() for j, t in enumerate(v)}
    env.update({f"out:{s}:{j}": t for s, v in outs.items()
                for j, t in enumerate(v)})
    out_names = [n for s in sorted(outs) for n in op.output(s)]
    in_names = [n for s in ins for n in op.input(s)]

    descs = info.grad_maker(op, None, set())
    read = {n for d in descs for names in d["inputs"].values()
            for n in names}

    def vjp(cts, retain_graph):
        e = dict(env)
        for n, g in zip(out_names, cts):
            if g is None:
                continue
            if grad_var_name(n) not in read:
                raise NotImplementedError(
                    f"op {info.type!r}: its grad op takes no gradient of "
                    f"output {n.split(':')[1]!r}, so the tape cannot pass "
                    "one back through it")
            e[grad_var_name(n)] = g
        for desc in descs:
            gins = {s: [e.get(n) if n else None for n in names]
                    for s, names in desc["inputs"].items()}
            ginfo = registry.get_op_info(desc["type"])
            with torch.no_grad():
                gouts = registry.lower_one(ginfo, ctx, gins,
                                           dict(desc.get("attrs", {}))) or {}
            for s, names in desc["outputs"].items():
                for n, t in zip(names, gouts.get(s, [])):
                    if n and t is not None:
                        e[n] = t
        return [e.get(grad_var_name(n)) for n in in_names]
    return vjp


_seed_counter = itertools.count(1)


class Tracer:
    """ref ``imperative/tracer.h:31``: owns the tape and the grad switch."""

    def __init__(self):
        self.tape: List[TapeNode] = []
        self._grad_enabled = True

    # -- mode ----------------------------------------------------------------
    def grad_enabled(self) -> bool:
        return self._grad_enabled

    def set_grad_enabled(self, flag: bool):
        self._grad_enabled = flag

    def _tracks(self, flat_vb, stop_gradient=False, no_grad=False) -> bool:
        return (self._grad_enabled and not stop_gradient and not no_grad
                and any(vb is not None and not vb.stop_gradient
                        and _floating(vb.value) for vb in flat_vb))

    # -- forward -------------------------------------------------------------
    def trace_op(self, op_type: str, ins: Dict[str, List[Any]],
                 attrs: Optional[Dict[str, Any]] = None,
                 stop_gradient: bool = False) -> Dict[str, List[VarBase]]:
        """Run one op eagerly through its registered lowering; tape it when
        an input needs a gradient (ref ``Tracer::TraceOp`` +
        TraceBackward).  Non-``VarBase`` inputs (arrays, numbers) become
        constants on the op's device."""
        from .base import current_device
        from ..framework.executor import LowerCtx
        info = registry.get_op_info(op_type)
        if info.raw:
            # a sub-block has no place in eager mode (ref tracer.py:180)
            raise TypeError(
                f"op {op_type!r} is a control-flow (raw) op; use the python "
                f"control flow of dygraph mode instead")
        attrs = dict(attrs or {})
        vbs = [v for vs in ins.values() for v in vs if isinstance(v, VarBase)]
        device = vbs[0].device if vbs else current_device()
        flat_vb: List[Optional[VarBase]] = []
        vals: Dict[str, List] = {}
        wanted: Dict[str, List[bool]] = {}
        for slot, vs in ins.items():
            row, want = [], []
            for v in vs:
                vb = v if isinstance(v, VarBase) else None
                flat_vb.append(vb)
                row.append(None if v is None else constant(v, device))
                want.append(vb is not None and not vb.stop_gradient)
            vals[slot] = row
            wanted[slot] = want
        ctx = LowerCtx(device, next(_seed_counter))
        track = self._tracks(flat_vb, stop_gradient, info.no_grad)
        if not track or info.grad_maker is not None:
            with torch.no_grad():
                outs = registry.lower_one(info, ctx, vals, attrs) or {}
            vjp = _grad_op_vjp(info, ctx, attrs, vals, outs) if track \
                else None
        else:
            leaves, outs = registry.run_forward(info, ctx, vals, attrs,
                                                wanted)
            flat_out = [o for s in sorted(outs) for o in outs[s]]
            fl = [o for o in flat_out if _floating(o)]
            if fl and not any(o.requires_grad for o in fl):
                raise NotImplementedError(
                    f"op {op_type!r}: autograd cannot differentiate its "
                    "lowering (its outputs carry no gradient), so the tape "
                    "cannot hold it")
            vjp = _autograd_vjp([t for s in ins for t in leaves[s]],
                                flat_out)
        result: Dict[str, List[VarBase]] = {}
        out_vbs: List[VarBase] = []
        for slot in sorted(outs):
            result[slot] = [None if o is None else
                            VarBase(o.detach(), stop_gradient=not track)
                            for o in outs[slot]]
            out_vbs.extend(result[slot])
        if track:
            self.tape.append(TapeNode(flat_vb, out_vbs, vjp))
        return result

    def trace_fn(self, fn, inputs: List[Any]) -> List[VarBase]:
        """Tape ``fn(*tensors) -> tensor | list`` (the tensor sugar with no
        op type, such as indexing), differentiated by autograd."""
        flat_vb = [v if isinstance(v, VarBase) else None for v in inputs]
        device = next((v.device for v in flat_vb if v is not None), None)
        track = self._tracks(flat_vb)
        leaves = []
        for vb, v in zip(flat_vb, inputs):
            t = constant(v, device)
            if track and vb is not None and not vb.stop_gradient and \
                    _floating(t):
                t = t.detach().requires_grad_(True)
            leaves.append(t)
        with torch.set_grad_enabled(track):
            out = fn(*leaves)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        out_vbs = [VarBase(o.detach(), stop_gradient=not track)
                   for o in outs]
        if track:
            self.tape.append(TapeNode(flat_vb, out_vbs,
                                      _autograd_vjp(leaves, outs)))
        return out_vbs

    # -- backward (the Engine) -----------------------------------------------
    def backward(self, root: VarBase, retain_graph: bool = False):
        if root.grad is None:
            root.grad = torch.ones_like(root.value)
        for node in reversed(self.tape):
            cts, any_grad = [], False
            for ref in node.outputs:
                o = ref()
                g = o.grad if o is not None and _floating(o.value) else None
                cts.append(g)
                any_grad = any_grad or g is not None
            if not any_grad:
                continue
            in_grads = node.vjp(cts, retain_graph)
            for vb, g in zip(node.inputs, in_grads):
                if vb is None or vb.stop_gradient or g is None:
                    continue
                # GradientAccumulator (imperative/gradient_accumulator.h)
                vb.grad = g if vb.grad is None else vb.grad + g
        if not retain_graph:
            self.tape.clear()


_default_tracer = Tracer()


def default_tracer() -> Tracer:
    return _default_tracer
