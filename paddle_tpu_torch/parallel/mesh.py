"""Device meshes: the port of ``paddle_tpu/parallel/mesh.py``.

A :class:`Mesh` names the axes of an object ndarray of ``torch.device``,
as ``jax.sharding.Mesh`` names an array of JAX devices:

- ``dp``  — data parallel
- ``mp``  — tensor/model parallel
- ``sp``  — sequence/context parallel (the ring-attention axis)
- ``pp``  — pipeline stages
- ``ep``  — expert parallel (MoE)

The contract is the reference's: axes are ordered as :data:`AXES` (names
outside it follow in the order given), and the sizes must multiply to the
number of devices, or :func:`make_mesh` raises.  ``devices=None`` means
every visible CUDA card; with no card it raises (there is no CPU fallback).

After ``distributed.init_parallel_env`` brought up several processes, a
mesh spans them: each entry knows its process (``Mesh.processes``, the
``torch.distributed`` rank that runs it; ref ``mesh.py:105`` and the
executor's ``_mesh_is_multiprocess``).  :func:`make_mesh` with no devices
takes one card a process (the launcher's ``FLAGS_selected_gpus``), in
process order; an explicit list of ``k x processes`` devices gives
entries ``[p * k, (p + 1) * k)`` to process p (``[cpu] * 2`` over two
processes: one rank each).  The executor runs each process's ranks only
and moves what the collectives need between the processes
(``distributed.xproc``).

An explicit device list may name a device more than once:
``[torch.device("cpu")] * 8`` or ``[torch.device("cuda", 0)] * 4``.  That
is the port's analog of XLA's ``--xla_force_host_platform_device_count``,
with which the reference's tests build their 8-device CPU mesh: each
position of the mesh is a rank of its own (a *virtual rank*), and the
ranks that share a device run one after another on it.  Only tests and
``chip_smoke.py`` build such meshes.

The executor's collective mode runs a transpiled program over the ``dp``
axis of the current mesh (``framework/executor.py``), so a ``dp`` mesh of
virtual ranks trains data-parallel on one card or on the host.
:func:`data_parallel_mesh` takes the first n cards,
:func:`make_hierarchical_mesh` builds the two-level ``("dcn", "ici")`` mesh
and :func:`hierarchical_allreduce` reduces per-rank tensors over it, intra
axis first.  GSPMD's pieces: :func:`make_topology_mesh` (on the card
:func:`make_mesh`'s order: there is no ICI to map), :func:`sharding_for`
(a ``parallel.spmd.Sharding`` for a spec, axes the mesh lacks dropped) and
:func:`axis_groups` (the ranks that share their coordinates on every other
axis: the ring of a collective over one axis of a 2-D mesh).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

AXES = ("dp", "mp", "sp", "pp", "ep")

_current_mesh: Optional["Mesh"] = None


class Mesh:
    """Named axes over an object ndarray of ``torch.device``.

    ``devices`` has one dimension per axis; ``shape`` maps each axis name
    to its size, in axis order (``jax.sharding.Mesh.shape``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 processes=None):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} cannot take "
                             f"the axes {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        #: each entry's process (None: every entry is this process's)
        self.processes = None if processes is None else \
            np.asarray(processes, dtype=np.int64).reshape(devices.shape)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names,
                        (int(s) for s in self.devices.shape)))

    def axis_devices(self, axis_name: str) -> list:
        """The devices along ``axis_name`` at position 0 of every other
        axis: the ranks of one ``axis_name`` group, in rank order."""
        i = self.axis_names.index(axis_name)
        return list(np.moveaxis(self.devices, i, -1).reshape(
            -1, self.devices.shape[i])[0])

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def _cuda_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass "
                           "an explicit device list (e.g. "
                           "[torch.device('cpu')] * n) to build a mesh of "
                           "virtual ranks")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _process_devices():
    """(devices, processes) of a mesh over the process group: each
    process's card (``FLAGS_selected_gpus``), in process order."""
    from ..distributed.env import Env, process_count
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass "
                           "an explicit device list (e.g. "
                           "[torch.device('cpu')] * processes)")
    n = process_count()
    return [torch.device("cuda", Env().dev_id)] * n, list(range(n))


def _processes_of(devices) -> Optional[list]:
    """Each device's process when the process group spans several: the
    list cut into equal consecutive parts, one a process."""
    from ..distributed.env import is_multiprocess, process_count
    if not is_multiprocess():
        return None
    n = process_count()
    if len(devices) % n:
        raise ValueError(f"a mesh over {n} processes needs a multiple of "
                         f"{n} devices, have {len(devices)}")
    k = len(devices) // n
    return [i // k for i in range(len(devices))]


def make_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """Build a Mesh from {axis_name: size}; sizes must multiply to
    #devices.  Axis order follows :data:`AXES`, so dp is outermost.  Over
    several processes the mesh spans them (module docstring)."""
    from ..distributed.env import is_multiprocess
    if devices is None and is_multiprocess():
        devices, procs = _process_devices()
    else:
        devices = [torch.device(d) for d in (
            devices if devices is not None else _cuda_devices())]
        procs = _processes_of(devices)
    names = [a for a in AXES if a in axes] + \
        [a for a in axes if a not in AXES]
    sizes = [int(axes[a]) for a in names]
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(f"mesh {axes} needs {int(np.prod(sizes))} devices, "
                         f"have {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), axis_names=tuple(names),
                processes=procs)


def data_parallel_mesh(n: Optional[int] = None) -> Mesh:
    """A ``dp`` mesh over the first ``n`` visible cards (all of them when
    ``n`` is None), or over every process's card after
    ``init_parallel_env``; raises with no card."""
    from ..distributed.env import is_multiprocess
    if is_multiprocess():
        devs, _ = _process_devices()
        return make_mesh({"dp": len(devs)})
    devs = _cuda_devices()
    if n is not None:
        devs = devs[:n]
    return make_mesh({"dp": len(devs)}, devs)


def set_mesh(mesh: Optional[Mesh]):
    global _current_mesh
    _current_mesh = mesh


def current_mesh() -> Optional[Mesh]:
    return _current_mesh


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    """{axis_name: size} of a Mesh."""
    return {str(a): int(s)
            for a, s in zip(mesh.axis_names, mesh.devices.shape)}


def make_hierarchical_mesh(inter: int, intra: int, devices=None) -> Mesh:
    """Two-level data-parallel mesh (ref ``mesh.py:132``; the reference's
    ``NCCLCommunicator::InitHierarchicalCtxs`` inter/intra-node rings):
    axes ``("dcn", "ici")``, the slow inter-node level outermost."""
    return make_mesh({"dcn": inter, "ici": intra}, devices)


def hierarchical_allreduce(tensors: Sequence[torch.Tensor], mesh: Mesh,
                           inter_axis: str = "dcn",
                           intra_axis: str = "ici") -> list:
    """The two-stage allreduce over a hierarchical mesh (ref ``mesh.py:146``,
    ``nccl_helper.h:246``): ``tensors`` holds one tensor a rank, in the
    order of ``mesh.devices.flat``.  Each group of the fast intra axis is
    summed first, in rank order on its first rank's device, then the
    groups' sums over the inter axis on rank 0's device.  Returns one
    tensor a rank, each on that rank's device; no rank's output aliases
    another's.  The port has no ``shard_map``, so the function takes the
    ranks' tensors at once, where the reference's runs inside one."""
    shape = mesh.devices.shape
    names = mesh.axis_names
    if len(tensors) != mesh.devices.size:
        raise ValueError(f"{len(tensors)} tensors for a mesh of "
                         f"{mesh.devices.size} ranks")
    grid = np.arange(mesh.devices.size).reshape(shape)
    rest = [a for a in names if a not in (inter_axis, intra_axis)]
    grid = np.transpose(grid, [names.index(a) for a in rest]
                        + [names.index(inter_axis), names.index(intra_axis)])
    out: list = [None] * len(tensors)
    for group in grid.reshape(-1, shape[names.index(inter_axis)],
                              shape[names.index(intra_axis)]):
        partials = []
        for row in group:                       # intra axis first
            dev = tensors[row[0]].device
            acc = tensors[row[0]].clone()
            for r in row[1:]:
                acc.add_(tensors[r].to(dev))
            partials.append(acc)
        dev = partials[0].device                # then the inter axis
        total = partials[0]
        for p in partials[1:]:
            total.add_(p.to(dev))
        for r in group.reshape(-1):
            out[r] = total.to(tensors[r].device, copy=True)
    return out


def _axis_in(mesh: Mesh, axis) -> bool:
    if isinstance(axis, (tuple, list)):
        return all(a in mesh.axis_names for a in axis)
    return axis in mesh.axis_names


def sharding_for(mesh: Mesh, spec):
    """A ``parallel.spmd.Sharding`` of ``spec`` (None = replicated, else a
    tuple of axis names or None per dim) over ``mesh``; axes the mesh
    lacks are dropped, so a tp-annotated model runs unchanged on a
    dp-only mesh (ref ``mesh.py:64-74``)."""
    from .spmd import Sharding
    if spec is None:
        return Sharding(mesh, ())
    return Sharding(mesh, tuple(
        (a if (a is not None and _axis_in(mesh, a)) else None)
        for a in spec))


def make_topology_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """The GSPMD partitioner's mesh (ref ``mesh.py:82-124``).  The
    reference asks ``mesh_utils`` to put the inner axes on adjacent chips
    of the ICI torus; one host's cards (NVLink all to all) have no such
    order to find, so this is :func:`make_mesh`'s, and its errors."""
    return make_mesh(axes, devices)


def rank_coords(mesh: Mesh, rank: int) -> Dict[str, int]:
    """{axis: index} of flat rank ``rank`` (the order of
    ``mesh.devices.flat``)."""
    idx = np.unravel_index(int(rank), mesh.devices.shape)
    return {a: int(i) for a, i in zip(mesh.axis_names, idx)}


def axis_groups(mesh: Mesh, axis: str) -> list:
    """The rings of ``axis``: lists of flat ranks that share their
    coordinates on every other axis, each in ``axis`` order.  Every rank
    is in exactly one group; an axis the mesh lacks makes one group a
    rank."""
    grid = np.arange(mesh.devices.size).reshape(mesh.devices.shape)
    if axis not in mesh.axis_names:
        return [[int(r)] for r in grid.flat]
    i = mesh.axis_names.index(axis)
    return [[int(r) for r in row] for row in
            np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i])]
