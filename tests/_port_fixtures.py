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


@pytest.fixture
def fresh_port_programs():
    """Fresh port default programs, scope and unique names (the
    reference's come from ``conftest.py``'s ``_fresh_programs``)."""
    from paddle_tpu_torch.framework import core, scope, unique_name
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


def same_bits_draw(key, shape):
    """One numpy byte draw keyed by (stream key, shape): what both
    packages' dropouts read in the parity tests (:func:`patch_same_bits`)."""
    import zlib

    import numpy as np
    h = zlib.crc32(repr((key, tuple(int(d) for d in shape))).encode())
    return np.random.RandomState(h).randint(0, 256, tuple(shape),
                                            dtype=np.uint8)


def patch_same_bits(monkeypatch):
    """Make both packages' dropouts draw from :func:`same_bits_draw`: the
    reference's streams become ``("tag", tag)`` / ``("ctr", n)`` keys
    (``LowerCtx.rng_tagged`` / ``LowerCtx.rng``) and ``jax.random.bits``
    reads the draw by that key; the port's one byte source,
    ``kernels.dropout.philox_bytes``, reads it by the same key."""
    import jax
    import jax.numpy as jnp
    import torch
    from paddle_tpu.framework.executor import LowerCtx as RefCtx
    from paddle_tpu_torch.kernels import dropout as dk

    def rng(self):
        self._counter += 1
        return ("ctr", self._counter)

    def port_bytes(stream, shape, device):
        kind = "tag" if stream.word3 == dk.TAGGED else "ctr"
        return torch.from_numpy(same_bits_draw((kind, stream.word2), shape))

    monkeypatch.setattr(RefCtx, "rng", rng)
    monkeypatch.setattr(RefCtx, "rng_tagged",
                        lambda self, tag: ("tag", int(tag)))
    monkeypatch.setattr(jax.random, "bits", lambda key, shape, dtype:
                        jnp.asarray(same_bits_draw(key, shape)))
    monkeypatch.setattr(dk, "philox_bytes", port_bytes)
