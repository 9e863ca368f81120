"""Dygraph data parallelism (the port of ``paddle_tpu/dygraph/parallel.py``;
ref ``python/paddle/fluid/dygraph/parallel.py``: Env:33, DataParallel:84
with scale_loss:150 and apply_collective_grads:201).

``prepare_context`` brings up the process group with the port's
``distributed.env.init_parallel_env`` (gloo, rank 0's endpoint).  After
``loss.backward()``, ``apply_collective_grads`` sums every parameter's
gradient over the ranks: each process's gradients go to every other
through pinned host memory (``distributed.xproc.ProcessSpan.exchange``),
and each process adds the ranks' gradients in rank order, so every rank
holds the same bits.  At one rank both are no-ops, as in the reference.
"""

from __future__ import annotations

import os

from .layers import Layer
from .tracer import VarBase


class ParallelEnv:
    """ref dygraph/parallel.py Env:33: the launcher's variables."""

    def __init__(self):
        self._nranks = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self._local_rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._dev_id = int(os.getenv("FLAGS_selected_gpus", "0"))
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def nranks(self):
        return self._nranks

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def dev_id(self):
        return self._dev_id

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints


Env = ParallelEnv


def prepare_context(strategy=None):
    """Bring up the process group of the launcher's ranks (the
    reference's NCCLParallelContext::Init); one process needs none."""
    env = ParallelEnv()
    if env.nranks > 1 and env.trainer_endpoints:
        from ..distributed.env import init_parallel_env
        init_parallel_env(env.trainer_endpoints[0], env.nranks,
                          env.local_rank)
    return env


class DataParallel(Layer):
    """ref dygraph/parallel.py:84: wraps a Layer; after ``loss.backward()``
    ``apply_collective_grads()`` sums every trainable gradient over the
    ranks."""

    def __init__(self, layers: Layer, strategy=None):
        super().__init__("data_parallel")
        self._layers = layers
        self._env = ParallelEnv()

    @property
    def nranks(self):
        return max(self._env.nranks, 1)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss: VarBase) -> VarBase:
        """ref parallel.py:150: the loss times 1/nranks, so the summed
        gradients are those of the global mean."""
        if self.nranks <= 1:
            return loss
        return loss * (1.0 / self.nranks)

    def apply_collective_grads(self):
        """ref parallel.py:201: every gradient summed over the ranks, in
        rank order, through pinned host memory."""
        if self.nranks <= 1:
            return
        from ..distributed.xproc import ProcessSpan
        params = [p for p in self._layers.parameters() if p.grad is not None]
        if not params:
            return
        device = params[0].grad.device
        span = ProcessSpan(range(self.nranks))
        every = span.exchange({span.me: [p.grad for p in params]}, device)
        for i, p in enumerate(params):
            total = every[0][i].to(device)
            for r in range(1, self.nranks):
                total = total + every[r][i].to(device)
            p.grad = total.to(p.grad.device)

    # the wrapped layer's state
    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_dict(self, *a, **k):
        return self._layers.set_dict(*a, **k)

    load_dict = set_dict


def scale_loss(loss, nranks=None):
    n = nranks if nranks is not None else ParallelEnv().nranks
    return loss * (1.0 / n) if n > 1 else loss
