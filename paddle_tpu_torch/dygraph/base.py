"""The dygraph mode switch (ref ``python/paddle/fluid/dygraph/base.py``;
the port of ``paddle_tpu/dygraph/base.py``'s ``guard`` and
``in_dygraph_mode``).  Inside ``guard()`` the static optimizers apply
their update ops at once on ``VarBase`` values (``Optimizer.minimize`` takes
its dygraph branch).  There is no tape to clear: eager autograd is not
ported (ROADMAP Queue 1 item 4)."""

from __future__ import annotations

import contextlib

_in_dygraph = False


def in_dygraph_mode() -> bool:
    return _in_dygraph


@contextlib.contextmanager
def guard(place=None):
    """``with dygraph.guard():`` enables eager execution.  ``place`` is the
    reference's signature: every ``VarBase`` already names its device."""
    global _in_dygraph
    prev = _in_dygraph
    _in_dygraph = True
    try:
        yield
    finally:
        _in_dygraph = prev
