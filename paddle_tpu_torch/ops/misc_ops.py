"""Miscellaneous op lowerings (the subset of ``paddle_tpu/ops/misc_ops.py``
the recompute transform needs).

``optimization_barrier`` (ref ``misc_ops.py:213-219``) is XLA's CSE fence:
the recompute transform (``framework/recompute.py``) reads every stored
value entering a recomputed chain through one, so the compiler cannot merge
the recomputation back into the original.  Eager torch has no CSE, so here
the op is an identity that hands back its input tensor (no copy); it keeps
its type and names so both packages build the same program.
"""

from __future__ import annotations

from ..framework.registry import register_op
from .common import X


@register_op("optimization_barrier", no_grad=True)
def _optimization_barrier(ctx, ins, attrs):
    return {"Out": [X(ins, "X")]}
