"""Launch counts of the port's kernels, by kernel and operand dtype.

Each kernel module keeps one :class:`LaunchCounts` behind its
``launch_count(kernel, dtype=None)`` and ``reset_launch_count()``.  A
wrapper counts a launch once the kernel was accepted, never a run of the
plain version; ``chip_smoke.py`` resets the counts before a main path and
reads them after it, by dtype where a kernel has a bf16 form.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch


class LaunchCounts:
    """Launches of named kernels, by the dtype name of their operands."""

    def __init__(self, *kernels: str):
        self._lock = threading.Lock()
        self._n: Dict[str, Dict[str, int]] = {
            k: {} for k in kernels}  # guarded-by: _lock

    def count(self, kernel: str, dtype: torch.dtype) -> None:
        name = str(dtype).replace("torch.", "")
        with self._lock:
            per = self._n[kernel]
            per[name] = per.get(name, 0) + 1

    def get(self, kernel: str, dtype: Optional[str] = None) -> int:
        """Launches of ``kernel`` on ``dtype`` operands ("float32",
        "bfloat16"; None: any) since the last :meth:`reset`."""
        with self._lock:
            per = self._n[kernel]
            return sum(per.values()) if dtype is None else per.get(dtype, 0)

    def reset(self) -> None:
        with self._lock:
            for per in self._n.values():
                per.clear()
