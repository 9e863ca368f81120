"""Places (ref ``platform/place.h``): where an Executor runs.

``CUDAPlace(n)`` is the n-th CUDA device; ``CPUPlace()`` is the host.  An
``Executor()`` given no place runs on ``CUDAPlace(0)``.
"""

from __future__ import annotations

import torch


class CPUPlace:
    """ref platform/place.h:37 CPUPlace."""

    @property
    def device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace:
    """ref platform/place.h:26 CUDAPlace: the ``device_id``-th CUDA device."""

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    @property
    def device(self) -> torch.device:
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


def checked_device(place, owner: str) -> torch.device:
    """``place``'s device (``CUDAPlace(0)`` when None), refused when it
    names a CUDA device this process does not have: a run on the host must
    ask for ``CPUPlace()``, it never falls back to it.  ``owner`` names the
    caller in the error."""
    if place is None:
        place = CUDAPlace(0)
    device = place.device
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{owner}({place!r}): no CUDA device is available; "
                "pass CPUPlace() to run on the host")
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{owner}({place!r}): only "
                f"{torch.cuda.device_count()} CUDA device(s)")
    return device


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def device_count() -> int:
    return torch.cuda.device_count()
