"""Fixtures shared by the port's test modules (``tests/test_torch_*.py``).

A module takes one by importing it by name::

    from _port_fixtures import collect_garbage_after_module  # noqa: F401
"""

import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def collect_garbage_after_module():
    """Run the cyclic collector once this module's tests are done.  The
    reference's executors retire their metric series from a GC finalizer
    that takes the lock ``paddle_tpu.monitor`` holds while it lists a
    family's series, so a collection that lands inside a later test's
    ``monitor.collect()`` deadlocks the process.  Collecting here frees
    what this module left at a safe point and resets the generations, so
    the next module does not inherit a full collection that is due."""
    yield
    gc.collect()
