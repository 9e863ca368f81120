"""``VarBase`` as a value holder (ref ``imperative/layer.h:55``; the port of
``paddle_tpu/dygraph/tracer.py``'s ``VarBase`` data access): a
``torch.Tensor`` on an explicit device, its gradient slot and its
metadata.  The eager apply (``dygraph.eager_apply``) reads and writes
parameters and optimizer accumulators through it.

Not ported yet (ROADMAP Queue 1 item 4): the tracer and its tape, eager
autograd (``backward``, ``gradient``), and the operator sugar.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..framework import unique_name


def as_tensor(value, device=None) -> torch.Tensor:
    """``value`` (a tensor, a ``VarBase`` or array-like) as a tensor on
    ``device`` (a tensor's own device when None, else the host)."""
    if isinstance(value, VarBase):
        value = value.value
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    return value if device is None else value.to(device)


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

    @property
    def value(self) -> torch.Tensor:
        return self._value

    def set_value(self, v):
        """Hold ``v`` on this var's device."""
        self._value = as_tensor(v, self._value.device)

    def numpy(self) -> np.ndarray:
        t = self._value.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    @property
    def device(self) -> torch.device:
        return self._value.device

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self) -> str:
        return str(self._value.dtype).replace("torch.", "")
