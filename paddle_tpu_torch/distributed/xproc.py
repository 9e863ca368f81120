"""The exchange between the processes of a mesh (the port's counterpart of
the cross-process collectives XLA runs for the reference once
``jax.distributed`` spans hosts).

A mesh whose ranks span processes (``parallel.mesh``, after
``init_parallel_env``) runs each rank's work in the process that owns it;
:class:`ProcessSpan` says which ranks those are and moves tensors between
the processes over the ``torch.distributed`` group (``gloo``):

- :meth:`ProcessSpan.exchange`: every process hands in its local ranks'
  tensors and gets every rank's back.  The tensors are packed into one
  byte buffer a process (each tensor's bytes 16-byte aligned), staged in
  pinned host memory when they live on the card, sent to every other
  process while theirs are received (``isend`` / ``irecv`` pairs: gloo's
  ``all_gather`` was the slower transport, PERF.md 25a / 25b), and
  unpacked onto the caller's device; the shapes and dtypes travel ahead
  in a small header, so ranks may differ in them, and a None stays
  None.
  Each collective lowering then computes over every rank's input on this
  process's device, in rank order, exactly as it does over a mesh of
  virtual ranks in one process: a two-process result is bit for bit the
  in-process one.  gloo's own reductions are not used (their order of
  summation is not fixed).
- :meth:`ProcessSpan.rotate`: the ring's shift, rank i's tensor to rank
  (i + 1) % n, an ``isend`` / ``irecv`` pair over host memory between
  neighbouring processes and a plain device copy within one.

Every exchange waits at most the process group's timeout
(``init_parallel_env(timeout_s=)``): a dead peer ends in an error.
:data:`STATS` counts the exchanges and rotations, their host seconds
(staging and the wait on the peers included) and the bytes this process
sent.
"""

from __future__ import annotations

import pickle
import time
from typing import Dict, List, Optional, Sequence

import torch

from .env import process_index

_ALIGN = 16

#: this process's cross-process traffic: calls, host seconds, bytes sent
STATS = {"calls": 0, "seconds": 0.0, "bytes": 0}


def reset_stats() -> None:
    STATS.update(calls=0, seconds=0.0, bytes=0)


def _count(t0: float, nbytes: int) -> None:
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    STATS["bytes"] += int(nbytes)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * int(t.element_size())


def _wait(reqs) -> None:
    for q in reqs:
        q.wait()


def _host(n: int, device: torch.device) -> torch.Tensor:
    return torch.empty(n, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


class ProcessSpan:
    """The processes that run the ranks of a mesh: ``procs[r]`` is rank
    r's process (its ``torch.distributed`` rank).  ``local`` lists this
    process's ranks in rank order; ``multi`` is whether another process
    runs some."""

    def __init__(self, procs: Sequence[int]):
        self.procs = [int(p) for p in procs]
        self.me = process_index()
        self.local = [r for r, p in enumerate(self.procs) if p == self.me]
        self.multi = len(set(self.procs)) > 1

    @property
    def n(self) -> int:
        return len(self.procs)

    def is_local(self, rank: int) -> bool:
        return self.procs[rank] == self.me

    def exchange(self, items: Dict[int, List[Optional[torch.Tensor]]],
                 device: torch.device) -> List[List[Optional[torch.Tensor]]]:
        """Every rank's list of tensors from each process's ``items``
        (some or all of its local ranks -> their tensors; a rank no
        process names stays None).  Local ranks keep their own tensors;
        another process's arrive on ``device``."""
        out: List[Optional[List[Optional[torch.Tensor]]]] = [None] * self.n
        for r in items:
            out[r] = list(items[r])
        if not self.multi:
            return out
        import torch.distributed as dist
        t0 = time.perf_counter()
        metas: Dict[int, list] = {}
        size = 0
        for r in sorted(items):
            m = []
            for t in items[r]:
                if t is None:
                    m.append(None)
                    continue
                m.append((tuple(t.shape), str(t.dtype).rsplit(".", 1)[1],
                          size))
                size += -(-_nbytes(t) // _ALIGN) * _ALIGN
            metas[r] = m
        buf = _host(max(size, _ALIGN), device)
        for r in metas:
            for t, m in zip(items[r], metas[r]):
                if t is not None and t.numel():
                    n = _nbytes(t)
                    buf[m[2]:m[2] + n].copy_(
                        t.detach().contiguous().reshape(-1)
                        .view(torch.uint8), non_blocking=True)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        head = torch.frombuffer(bytearray(pickle.dumps(metas)),
                                dtype=torch.uint8)
        peers = sorted(set(self.procs) - {self.me})
        lens = {p: torch.empty(2, dtype=torch.int64) for p in peers}
        mine = torch.tensor([head.numel(), buf.numel()], dtype=torch.int64)
        _wait([dist.isend(mine, p) for p in peers] +
              [dist.irecv(lens[p], p) for p in peers])
        heads = {p: torch.empty(int(lens[p][0]), dtype=torch.uint8)
                 for p in peers}
        bufs = {p: _host(int(lens[p][1]), device) for p in peers}
        _wait([q for p in peers for q in (dist.isend(head, p),
                                          dist.isend(buf, p))] +
              [q for p in peers for q in (dist.irecv(heads[p], p),
                                          dist.irecv(bufs[p], p))])
        for p in peers:
            pm = pickle.loads(heads[p].numpy().tobytes())
            for r, m in pm.items():
                got = []
                for meta in m:
                    if meta is None:
                        got.append(None)
                        continue
                    shape, dt, off = meta
                    dtype = _dtype(dt)
                    numel = 1
                    for d in shape:
                        numel *= int(d)
                    nb = numel * torch.empty((), dtype=dtype).element_size()
                    t = bufs[p][off:off + nb].view(dtype).reshape(shape)
                    got.append(t.to(device, non_blocking=True))
                out[int(r)] = got
        _count(t0, size * len(peers))
        return out

    def rotate(self, shards: List[Optional[torch.Tensor]],
               device: torch.device) -> List[Optional[torch.Tensor]]:
        """Rank i's shard to rank (i + 1) % n, for this process's ranks
        (another process's entries stay None): a device copy when both
        ranks are here, else a send to the next rank's process and a
        receive from the previous one's, through host memory.  A rank's
        incoming shard has the shape and dtype of the one it sends."""
        n = self.n
        out: List[Optional[torch.Tensor]] = [None] * n
        sends, recvs = [], []
        for i in self.local:
            src = (i - 1) % n
            if self.is_local(src):
                out[i] = shards[src].to(device, non_blocking=True)
            else:
                recvs.append((i, src))
            dst = (i + 1) % n
            if not self.is_local(dst):
                sends.append((i, dst))
        if not (sends or recvs):
            return out
        import torch.distributed as dist
        t0 = time.perf_counter()
        reqs, held = [], []
        for i, dst in sends:
            t = shards[i].detach().contiguous()
            h = t.cpu() if t.device.type != "cpu" else t
            held.append(h)
            reqs.append(dist.isend(h, dst=self.procs[dst]))
        bufs = []
        for i, src in recvs:
            like = shards[i]
            b = torch.empty(like.shape, dtype=like.dtype)
            bufs.append((i, b))
            reqs.append(dist.irecv(b, src=self.procs[src]))
        _wait(reqs)
        for i, b in bufs:
            out[i] = b.to(device, non_blocking=True) \
                if device.type == "cuda" else b
        _count(t0, sum(_nbytes(h) for h in held))
        return out


def span_of(mesh, axis: Optional[str] = None) -> ProcessSpan:
    """The :class:`ProcessSpan` of a mesh's ranks in flat order, or of the
    ranks along ``axis`` at position 0 of the others (``Mesh.
    axis_devices``'s ranks).  A mesh of one process gives a span of one."""
    procs = getattr(mesh, "processes", None)
    if procs is None:
        n = mesh.devices.size if axis is None else \
            int(mesh.shape[axis])
        return ProcessSpan([process_index()] * n)
    if axis is None:
        return ProcessSpan(list(procs.flat))
    import numpy as np
    i = mesh.axis_names.index(axis)
    return ProcessSpan(list(np.moveaxis(procs, i, -1).reshape(
        -1, procs.shape[i])[0]))
