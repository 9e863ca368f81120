"""The dygraph mode switch and conversion helpers (the port of
``paddle_tpu/dygraph/base.py``; ref ``python/paddle/fluid/dygraph/
base.py``): ``guard()``, ``enabled()``, ``to_variable()``, ``no_grad``.

``guard(place)`` puts the mode on a device: ``CUDAPlace(0)`` when no place
is given (``place.checked_device``: with no card it raises, it never falls
back to the host).  ``to_variable``, parameter creation and an op with no
tensor input put their tensors on it; inside the guard the static
optimizers apply their update ops at once on ``VarBase`` values."""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

from .tracer import VarBase, constant, default_tracer

_in_dygraph = False
_device: Optional[torch.device] = None


def enabled() -> bool:
    return _in_dygraph


def in_dygraph_mode() -> bool:
    return _in_dygraph


def current_device() -> torch.device:
    """The innermost guard's device; outside a guard the card's
    (``CUDAPlace(0)``, checked)."""
    if _device is not None:
        return _device
    from ..place import checked_device
    return checked_device(None, "dygraph")


@contextlib.contextmanager
def guard(place=None):
    """``with dygraph.guard(place):`` enables eager execution on ``place``
    (the card when None).  The outermost guard clears the tape on exit."""
    from ..place import checked_device
    global _in_dygraph, _device
    device = checked_device(place, "dygraph.guard")
    prev, prev_device = _in_dygraph, _device
    _in_dygraph, _device = True, device
    try:
        yield
    finally:
        _in_dygraph, _device = prev, prev_device
        if not prev:  # only the outermost guard owns the tape
            default_tracer().tape.clear()


def to_variable(value, name=None, zero_copy=None) -> VarBase:
    """A numpy array (or a ``VarBase``, returned as it is) as a
    ``VarBase`` on the guard's device (ref dygraph/base.py
    to_variable)."""
    if isinstance(value, VarBase):
        return value
    return VarBase(constant(value, current_device()), name=name,
                   stop_gradient=False)


class no_grad:
    """A context manager and a decorator that turn the tape off (ref
    dygraph/base.py no_grad)."""

    def __enter__(self):
        t = default_tracer()
        self._prev = t.grad_enabled()
        t.set_grad_enabled(False)
        return self

    def __exit__(self, *exc):
        default_tracer().set_grad_enabled(self._prev)
        return False

    def __new__(cls, func=None):
        if func is not None and callable(func):
            @functools.wraps(func)
            def wrapper(*args, **kwargs):
                with no_grad():
                    return func(*args, **kwargs)
            return wrapper
        return super().__new__(cls)


class BackwardStrategy:
    """ref dygraph/backward_strategy.py: ``sort_sum_gradient`` asks for a
    fixed order of gradient accumulation, which the tape's reverse sweep
    already has; the knob is kept for the API."""

    def __init__(self):
        self.sort_sum_gradient = False
