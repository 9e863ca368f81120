"""``Layer``: the dygraph module base class (the port of
``paddle_tpu/dygraph/layers.py``; ref ``python/paddle/fluid/dygraph/
layers.py`` and ``imperative/layer.h:314``): parameters and sublayers
registered by attribute assignment, ``create_parameter``,
``parameters()``, ``state_dict`` / ``set_dict`` and train / eval mode.
Parameters are named by ``unique_name`` as the reference names them, so
one construction sequence gives both packages the same names and
``state_dict`` keys."""

from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..framework import registry, unique_name
from ..framework.core import Program, convert_dtype
from ..initializer import (Initializer, _global_bias_initializer,
                           _global_weight_initializer)
from ..param_attr import ParamAttr
from .base import current_device
from .tracer import VarBase, as_tensor

_init_seed = itertools.count(1)


def eager_initialize(shape, dtype, initializer: Initializer,
                     seed: Optional[int] = None, device=None):
    """Run an initializer eagerly: it appends its op(s) to a one-var
    scratch block, which runs through the startup lowerings on ``device``
    (the guard's) with a generator seeded from ``seed`` (the next of a
    process-wide counter when None), and gives the tensor: one init
    semantics for static and dygraph."""
    from ..framework.executor import LowerCtx
    device = device or current_device()
    block = Program().global_block()
    v = block.create_var(name="__param__", shape=shape, dtype=dtype,
                         persistable=True)
    initializer(v, block)
    ctx = LowerCtx(device, seed if seed is not None else next(_init_seed))
    env = {}
    for op in block.ops:
        ins = {s: [env[n] for n in names] for s, names in op.inputs.items()}
        outs = registry.lower_one(registry.get_op_info(op.type), ctx, ins,
                                  op.attrs) or {}
        for s, names in op.outputs.items():
            env.update(zip(names, outs.get(s, [])))
    return env["__param__"]


class Layer:
    """Dygraph module base (ref dygraph/layers.py Layer)."""

    def __init__(self, name_scope: Optional[str] = None,
                 dtype: str = "float32"):
        scope = name_scope or self.__class__.__name__.lower()
        self._full_name = unique_name.generate(scope)
        self._dtype = convert_dtype(dtype)
        self._parameters: "OrderedDict[str, VarBase]" = OrderedDict()
        self._sub_layers: "OrderedDict[str, Layer]" = OrderedDict()
        self._buffers: "OrderedDict[str, VarBase]" = OrderedDict()
        self.training = True

    # -- identity ------------------------------------------------------------
    def full_name(self) -> str:
        return self._full_name

    # -- mode ----------------------------------------------------------------
    def train(self):
        self.training = True
        for l in self._sub_layers.values():
            l.train()
        return self

    def eval(self):
        self.training = False
        for l in self._sub_layers.values():
            l.eval()
        return self

    # -- parameter creation --------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> VarBase:
        attr = ParamAttr._to_attr(attr)
        dtype = convert_dtype(dtype or self._dtype)
        if attr is not None and attr.initializer is not None:
            init = attr.initializer
        elif default_initializer is not None:
            init = default_initializer
        else:
            init = (_global_bias_initializer() if is_bias
                    else _global_weight_initializer())
        value = eager_initialize(list(shape), dtype, init)
        name = (attr.name if attr is not None and attr.name
                else unique_name.generate(f"{self._full_name}.w"))
        p = VarBase(value, name=name, persistable=True,
                    trainable=attr.trainable if attr is not None else True)
        p.stop_gradient = not p.trainable
        p.regularizer = getattr(attr, "regularizer", None)
        return p

    def create_variable(self, name=None, persistable=False, dtype=None,
                        value=None, shape=None) -> VarBase:
        dtype = convert_dtype(dtype or self._dtype)
        if value is None:
            value = np.zeros(shape or [1], dtype)
        v = VarBase(np.asarray(value, dtype), name=name,
                    persistable=persistable, trainable=False,
                    device=current_device())
        v.stop_gradient = True
        return v

    # -- registration --------------------------------------------------------
    def add_parameter(self, name: str, parameter: VarBase) -> VarBase:
        self._parameters[name] = parameter
        object.__setattr__(self, name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer") -> "Layer":
        self._sub_layers[name] = sublayer
        object.__setattr__(self, name, sublayer)
        return sublayer

    def register_buffer(self, name: str, value: VarBase) -> VarBase:
        self._buffers[name] = value
        object.__setattr__(self, name, value)
        return value

    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        subs = self.__dict__.get("_sub_layers")
        if params is not None and isinstance(value, VarBase) \
                and value.persistable:
            params[name] = value
        elif subs is not None and isinstance(value, Layer):
            subs[name] = value
        object.__setattr__(self, name, value)

    # -- traversal -----------------------------------------------------------
    def parameters(self, include_sublayers: bool = True) -> List[VarBase]:
        return [p for _, p in self.named_parameters(include_sublayers)]

    def named_parameters(self, include_sublayers: bool = True,
                         prefix: str = ""):
        seen = set()
        for name, p in self._parameters.items():
            if id(p) not in seen:
                seen.add(id(p))
                yield prefix + name, p
        if include_sublayers:
            for lname, l in self._sub_layers.items():
                for n, p in l.named_parameters(True, f"{prefix}{lname}."):
                    if id(p) not in seen:
                        seen.add(id(p))
                        yield n, p

    def sublayers(self, include_sublayers: bool = True) -> List["Layer"]:
        out = []
        for l in self._sub_layers.values():
            out.append(l)
            if include_sublayers:
                out.extend(l.sublayers(True))
        return out

    def named_sublayers(self, prefix: str = ""):
        for name, l in self._sub_layers.items():
            full = prefix + name
            yield full, l
            yield from l.named_sublayers(f"{full}.")

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # -- state dict ----------------------------------------------------------
    def state_dict(self, include_sublayers: bool = True,
                   prefix: str = "") -> Dict[str, VarBase]:
        out: "OrderedDict[str, VarBase]" = OrderedDict()
        for name, p in self._parameters.items():
            out[prefix + name] = p
        for name, b in self._buffers.items():
            out[prefix + name] = b
        if include_sublayers:
            for lname, l in self._sub_layers.items():
                out.update(l.state_dict(True, f"{prefix}{lname}."))
        return out

    def set_dict(self, state: Dict, include_sublayers: bool = True,
                 use_structured_name: bool = True):
        """Load ``state`` (``VarBase`` s or arrays by ``state_dict`` key)
        into this layer's parameters and buffers, each cast to its dtype
        on its device."""
        for key, target in self.state_dict(include_sublayers).items():
            if key not in state:
                continue
            v = state[key]
            arr = v.value if isinstance(v, VarBase) else as_tensor(v)
            if tuple(arr.shape) != target.shape:
                raise ValueError(
                    f"shape mismatch for {key}: saved {tuple(arr.shape)} "
                    f"vs model {target.shape}")
            target.set_value(arr.to(target.value.dtype))
        return self

    load_dict = set_dict

    # -- call ----------------------------------------------------------------
    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)
