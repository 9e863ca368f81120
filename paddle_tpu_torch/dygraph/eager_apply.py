"""The eager block (the port of ``paddle_tpu/dygraph/eager_apply.py``): the
static-graph ``Optimizer._append_optimize_op`` runs unchanged in dygraph
mode against it, each appended op running at once through its registered
lowering (the reference's shared kernels, ``imperative/
prepared_operator.h``).  The pipeline engine applies each stage's optimizer
this way."""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..framework import registry
from ..framework.executor import LowerCtx
from .tracer import VarBase, as_tensor

_seed = itertools.count(10_000_000)


class EagerBlock:
    """Duck-types the part of ``Block`` the optimizers' ``_append_optimize_op``
    and the clip and regularizer helpers use: ``append_op`` and
    ``create_var``.  An op runs under ``torch.no_grad()`` on its
    parameter's device (the first ``VarBase`` input's when it has no
    ``Param``); ``lr_value`` stands for the static learning-rate var."""

    def __init__(self, lr_value: float):
        self.lr = float(lr_value)

    def create_var(self, name=None, shape=None, dtype=None, **kw) -> VarBase:
        v = VarBase(torch.zeros(shape or [1],
                                dtype=getattr(torch, dtype or "float32")),
                    name=name, trainable=False)
        v.stop_gradient = True
        return v

    def _resolve(self, slot: str, v, device):
        if isinstance(v, VarBase):
            return v.value.to(device)
        if slot == "LearningRate" and (v is None or hasattr(v, "block")):
            # the static learning-rate var (or none): the eager value
            return torch.tensor([self.lr], dtype=torch.float32,
                                device=device)
        if hasattr(v, "block"):
            raise TypeError(f"static Variable {v.name!r} passed to an eager "
                            f"optimizer (slot {slot})")
        return as_tensor(v, device)

    @staticmethod
    def _device(inputs) -> torch.device:
        first = (inputs.get("Param") or [None])[0]
        if not isinstance(first, VarBase):
            first = next((v for vs in inputs.values() for v in vs
                          if isinstance(v, VarBase)), None)
        if first is None:
            raise ValueError("an eager op needs a VarBase input to place it")
        return first.device

    def append_op(self, type: str, inputs: Optional[Dict] = None,
                  outputs: Optional[Dict] = None,
                  attrs: Optional[Dict] = None):
        inputs = inputs or {}
        info = registry.get_op_info(type)
        device = self._device(inputs)
        ins = {slot: [self._resolve(slot, v, device) for v in vs]
               for slot, vs in inputs.items()}
        with torch.no_grad():
            outs = registry.lower_one(info, LowerCtx(device, next(_seed)),
                                      ins, dict(attrs or {})) or {}
        for slot, targets in (outputs or {}).items():
            for tgt, val in zip(targets, outs.get(slot, [])):
                if isinstance(tgt, VarBase):
                    tgt.set_value(val)
        return outs


def eager_clip_grads(params_grads: List[Tuple[VarBase, Any]], grad_clip):
    """The three clip attrs of ``clip.py`` on eager gradients."""
    if grad_clip is None or not params_grads:
        return params_grads
    from ..clip import (GradientClipByGlobalNorm, GradientClipByNorm,
                        GradientClipByValue)
    if isinstance(grad_clip, GradientClipByGlobalNorm):
        dev = params_grads[0][1].device
        gn = torch.sqrt(sum(torch.sum(torch.square(g)).to(dev)
                            for _, g in params_grads))
        scale = grad_clip.clip_norm / torch.clamp(gn,
                                                  min=grad_clip.clip_norm)
        return [(p, g * scale.to(g.device)) for p, g in params_grads]
    if isinstance(grad_clip, GradientClipByNorm):
        out = []
        for p, g in params_grads:
            n = torch.sqrt(torch.sum(torch.square(g)))
            out.append((p, g * torch.clamp(
                grad_clip.clip_norm / torch.clamp(n, min=1e-12), max=1.0)))
        return out
    if isinstance(grad_clip, GradientClipByValue):
        return [(p, torch.clamp(g, grad_clip.min, grad_clip.max))
                for p, g in params_grads]
    return params_grads
