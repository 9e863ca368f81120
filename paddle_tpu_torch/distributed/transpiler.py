"""Collective transpilers (the port of ``paddle_tpu/distributed/transpiler.py``;
ref ``python/paddle/fluid/transpiler/collective.py``): rewrite a trained
program for data parallelism.

``GradAllReduce`` (ref ``:178-268``) scales every gradient by 1/nranks and
all-reduces it before the first optimize op; ``LocalSGD`` (ref ``:269``)
averages every parameter after the last one.  ``_init_communicator`` (ref
``:99``) adds ``c_gen_nccl_id`` / ``c_comm_init`` to the startup program
for each ring.  The main program is stamped ``_attrs["collective"] =
{"nranks", "rank"}``, and the executor runs it in collective mode: the
block rank by rank over the ``dp`` ranks, feeds split on the batch, the
parameters one value read by every rank, the ``c_*`` ops over all ranks
at once (``framework/executor.py``).
"""

from __future__ import annotations

from typing import Optional

from ..framework import core
from ..framework.core import Program

# ops that consume a Param/Grad pair (ref collective.py OpRole.Optimize)
OPTIMIZE_OPS = {
    "sgd", "momentum", "lars_momentum", "adam", "adamw", "adamax",
    "adagrad", "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
    "dgc_momentum", "proximal_gd", "proximal_adagrad",
}


class Collective:
    """Base transpiler (ref collective.py:36)."""

    def __init__(self, nrings: int = 1):
        self.nrings = nrings
        self.nranks = 1
        self.rank = 0

    def transpile(self, startup_program: Optional[Program] = None,
                  main_program: Optional[Program] = None,
                  rank: int = 0, endpoints: str = "127.0.0.1:6174",
                  current_endpoint: str = "127.0.0.1:6174",
                  wait_port: bool = True):
        if isinstance(endpoints, str):
            endpoints = endpoints.split(",")
        self.rank = rank
        self.nranks = len(endpoints)
        startup = startup_program or core.default_startup_program()
        main = main_program or core.default_main_program()
        self._init_communicator(startup, rank, endpoints, current_endpoint)
        self._transpile_main(main)
        # the executor runs this block in collective mode
        main._attrs["collective"] = {"nranks": self.nranks,
                                     "rank": self.rank}
        return main

    def _init_communicator(self, startup, rank, endpoints, current_endpoint):
        """ref collective.py:99 — gen id + comm init per ring."""
        block = startup.global_block()
        for ring_id in range(self.nrings):
            block.append_op("c_gen_nccl_id", attrs={
                "ring_id": ring_id, "rank": rank,
                "endpoint": current_endpoint,
                "other_endpoints": [e for e in endpoints
                                    if e != current_endpoint]})
            block.append_op("c_comm_init", attrs={
                "ring_id": ring_id, "nranks": len(endpoints),
                "rank": rank})

    def _transpile_main(self, main):
        raise NotImplementedError

    def _append_dense_allreduce(self, block, at, grads, compress=None):
        """scale 1/nranks + c_allreduce_sum per grad (ref collective.py
        :189, :208), shared by GradAllReduce and the DGC transpiler's
        dense tail.  ``compress="bf16"`` casts each gradient to bf16 around
        the allreduce: half the bytes for ~1e-3-relative noise on an
        already averaged gradient."""
        ring = 0
        for g in grads:
            block.insert_op(at, "scale",
                            inputs={"X": [g]}, outputs={"Out": [g]},
                            attrs={"scale": 1.0 / self.nranks, "bias": 0.0,
                                   "bias_after_scale": False})
            at += 1
            if compress == "bf16":
                block.insert_op(at, "cast",
                                inputs={"X": [g]}, outputs={"Out": [g]},
                                attrs={"in_dtype": "float32",
                                       "out_dtype": "bfloat16"})
                at += 1
            block.insert_op(at, "c_allreduce_sum",
                            inputs={"X": [g]}, outputs={"Out": [g]},
                            attrs={"ring_id": ring % self.nrings,
                                   "use_calc_stream": True})
            at += 1
            if compress == "bf16":
                block.insert_op(at, "cast",
                                inputs={"X": [g]}, outputs={"Out": [g]},
                                attrs={"in_dtype": "bfloat16",
                                       "out_dtype": "float32"})
                at += 1
            ring += 1
        return at


class GradAllReduce(Collective):
    """Synchronous data parallelism (ref collective.py:178): every
    parameter gradient is scaled by 1/nranks and all-reduced before the
    optimizer reads it, so with the batch split over the ranks the update
    is the global batch's mean gradient.  ``compress="bf16"`` halves the
    allreduce's bytes."""

    def __init__(self, nrings: int = 1, compress=None):
        super().__init__(nrings)
        if compress not in (None, "bf16"):
            raise ValueError("compress must be None or 'bf16'")
        self._compress = compress

    def _transpile_main(self, main):
        block = main.global_block()
        grads = []
        first_opt = None
        for i, op in enumerate(block.ops):
            if op.type in OPTIMIZE_OPS:
                if first_opt is None:
                    first_opt = i
                for g in op.input("Grad"):
                    if g and g not in grads:
                        grads.append(g)
        if first_opt is None or not grads:
            return
        self._append_dense_allreduce(block, first_opt, grads,
                                     compress=self._compress)


class LocalSGD(Collective):
    """Local SGD with model averaging (ref collective.py:269): each rank
    steps its optimizer on its own gradients, then the parameters are
    averaged over the ranks (``c_allreduce_sum`` + ``scale``; the
    reference's snapshot/delta form has the same fixed point)."""

    def _transpile_main(self, main):
        block = main.global_block()
        params = []
        last_opt = None
        for i, op in enumerate(block.ops):
            if op.type in OPTIMIZE_OPS:
                last_opt = i
                for p in op.input("Param"):
                    if p and p not in params:
                        params.append(p)
        if last_opt is None:
            return
        at = last_opt + 1
        for ring, p in enumerate(params):
            block.insert_op(at, "c_allreduce_sum",
                            inputs={"X": [p]}, outputs={"Out": [p]},
                            attrs={"ring_id": ring % self.nrings})
            block.insert_op(at + 1, "scale",
                            inputs={"X": [p]}, outputs={"Out": [p]},
                            attrs={"scale": 1.0 / self.nranks, "bias": 0.0,
                                   "bias_after_scale": False})
            at += 2
