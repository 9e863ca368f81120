"""Legacy Downpour PS Python API (the port of
``paddle_tpu/distributed/downpour.py``; ref
``python/paddle/fluid/distributed/``: downpour.py DownpourSGD, node.py
DownpourServer/DownpourWorker, which make the descriptors, ps_instance.py
PaddlePSInstance).

The reference builds pslib protobuf (`ps_pb2.PSParameter`) consumed by
Baidu's closed-source brpc parameter server.  Here the same descriptor
shapes are plain dataclasses, and the runtime they configure is this
package's native TCP KV parameter server
(``paddle_tpu_torch.distributed.ps``) with row-sharded sparse tables — the open equivalent of the DownpourSparseTable
accessor stack.  Role bootstrap uses the launcher's env contract instead of
MPI (ref ps_instance uses mpi4py ranks)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..framework.backward import append_backward

__all__ = ["DownpourSGD", "DownpourServer", "DownpourWorker",
           "PaddlePSInstance"]


# -- table descriptors (ref node.py TableParameter shapes) -------------------
@dataclass
class SparseTable:
    table_id: int
    learning_rate: float
    slot_key_vars: List[str]
    slot_value_vars: List[str]
    table_class: str = "DownpourSparseTable"
    accessor_class: str = "DownpourFeatureValueAccessor"


@dataclass
class DenseTable:
    table_id: int
    learning_rate: float
    param_vars: List[str]
    grad_vars: List[str]
    table_class: str = "DownpourDenseTable"
    accessor_class: str = "DownpourDenseValueAccessor"


@dataclass
class ServerDesc:
    server_class: str = "PaddleTpuKvServer"      # native TCP KV server
    client_class: str = "PaddleTpuKvClient"
    sparse_tables: List[SparseTable] = field(default_factory=list)
    dense_tables: List[DenseTable] = field(default_factory=list)


@dataclass
class WorkerDesc:
    window: int = 1
    sparse_tables: List[SparseTable] = field(default_factory=list)
    dense_tables: List[DenseTable] = field(default_factory=list)


@dataclass
class PSParameter:
    """ref ps_pb2.PSParameter — the full job descriptor."""
    server_param: ServerDesc = field(default_factory=ServerDesc)
    worker_param: WorkerDesc = field(default_factory=WorkerDesc)
    program_configs: List[Dict] = field(default_factory=list)


class DownpourServer:
    """Makes the server-side descriptor (ref node.py:35)."""

    def __init__(self):
        self.server_ = ServerDesc()

    def add_sparse_table(self, table_id, learning_rate, slot_key_vars,
                         slot_value_vars):
        self.server_.sparse_tables.append(SparseTable(
            table_id, learning_rate,
            [v.name if hasattr(v, "name") else v for v in slot_key_vars],
            [v.name if hasattr(v, "name") else v for v in slot_value_vars]))

    def add_dense_table(self, table_id, learning_rate, param_vars, grad_vars):
        self.server_.dense_tables.append(DenseTable(
            table_id, learning_rate,
            [v.name if hasattr(v, "name") else v for v in param_vars],
            [v.name if hasattr(v, "name") else v for v in grad_vars]))

    def get_desc(self) -> ServerDesc:
        return self.server_


class DownpourWorker:
    """Makes the worker-side descriptor (ref node.py:122)."""

    def __init__(self, window=1):
        self.window = window
        self.worker_ = WorkerDesc(window=window)

    def add_sparse_table(self, table_id, learning_rate, slot_key_vars,
                         slot_value_vars):
        self.worker_.sparse_tables.append(SparseTable(
            table_id, learning_rate,
            [v.name if hasattr(v, "name") else v for v in slot_key_vars],
            [v.name if hasattr(v, "name") else v for v in slot_value_vars]))

    def add_dense_table(self, table_id, learning_rate, param_vars, grad_vars):
        self.worker_.dense_tables.append(DenseTable(
            table_id, learning_rate,
            [v.name if hasattr(v, "name") else v for v in param_vars],
            [v.name if hasattr(v, "name") else v for v in grad_vars]))

    def get_desc(self) -> WorkerDesc:
        return self.worker_


def _find_lookup_tables(program) -> Dict[str, Dict[str, List[str]]]:
    """Sparse-embedding sites: table param → {ids inputs, emb outputs}
    (ref helper.py find_distributed_lookup_table*)."""
    tables: Dict[str, Dict[str, List[str]]] = {}
    for op in program.global_block().ops:
        if op.type in ("lookup_table", "distributed_lookup_table") and \
                (op.attrs.get("is_sparse") or op.attrs.get("is_distributed")
                 or op.type == "distributed_lookup_table"):
            w = op.input("W")[0]
            entry = tables.setdefault(w, {"ids": [], "embs": []})
            entry["ids"] += op.input("Ids")
            entry["embs"] += op.output("Out")
    return tables


class DownpourSGD:
    """Legacy distributed optimizer (ref downpour.py:24): appends backward,
    splits params into one sparse table per embedding + one dense table for
    the rest, and returns the PS job descriptor plus the optimizer ops the
    worker must skip (the server applies the updates)."""

    def __init__(self, learning_rate=0.001, window=1):
        self.learning_rate_ = learning_rate
        self.window_ = window
        self.type = "downpour"

    def minimize(self, losses, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if not isinstance(losses, list):
            raise ValueError("losses is a list, like [model.cost]")
        program = losses[0].block.program
        tables = _find_lookup_tables(program)

        ps_param = PSParameter()
        server = DownpourServer()
        worker = DownpourWorker(self.window_)
        table_id = 0
        for w, io in tables.items():
            server.add_sparse_table(table_id, self.learning_rate_,
                                    io["ids"], io["embs"])
            worker.add_sparse_table(table_id, self.learning_rate_,
                                    io["ids"], io["embs"])
            table_id += 1

        param_grads_list = []
        for loss in losses:
            params_grads = sorted(
                append_backward(loss, parameter_list, no_grad_set),
                key=lambda x: x[0].name)
            param_grads_list.append(params_grads)
            dense = [(p, g) for p, g in params_grads
                     if p.name not in tables]
            server.add_dense_table(table_id, self.learning_rate_,
                                   [p for p, _ in dense],
                                   [g for _, g in dense])
            worker.add_dense_table(table_id, self.learning_rate_,
                                   [p for p, _ in dense],
                                   [g for _, g in dense])
            ps_param.program_configs.append({
                "program_id": str(id(loss.block.program)),
                "pull_sparse_table_id": list(range(len(tables))),
                "push_sparse_table_id": list(range(len(tables))),
                "pull_dense_table_id": [table_id],
                "push_dense_table_id": [table_id]})
            table_id += 1

        ps_param.server_param = server.get_desc()
        ps_param.worker_param = worker.get_desc()
        # server applies the updates; the worker skips its local optimizer
        worker_skipped_ops = ["lookup_table_grad", "sgd"]
        return [ps_param, worker_skipped_ops]


class PaddlePSInstance:
    """Role bootstrap (ref ps_instance.py:17, MPI-rank based).  Here roles
    come from the launcher env contract
    (``paddle_tpu_torch.distributed.launch_ps``):
    TRAINING_ROLE, PADDLE_TRAINER_ID / current endpoint index."""

    def __init__(self, server_worker_mode=1, proc_per_node=2):
        self.server_worker_mode = server_worker_mode
        self.proc_per_node = proc_per_node
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        self._is_server = role == "PSERVER"
        if self._is_server:
            eps = os.environ.get("PADDLE_PSERVER_ENDPOINTS", "").split(",")
            cur = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
            self._rank = eps.index(cur) if cur in eps else 0
        else:
            self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._nodes = int(os.environ.get(
            "PADDLE_TRAINERS_NUM",
            os.environ.get("PADDLE_TRAINERS", "1")))

    def is_server(self):
        return self._is_server

    def is_worker(self):
        return not self._is_server

    def is_first_worker(self):
        return self.is_worker() and self._rank == 0

    def get_worker_index(self):
        return self._rank

    def get_server_index(self):
        return self._rank

    def get_worker_num(self):
        return self._nodes

    def get_node_cnt(self):
        return self._nodes

    def barrier_all(self):
        """MPI barrier analog — the launcher's gang start/stop covers it."""

    def finalize(self):
        pass
