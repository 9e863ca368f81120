"""Parallelism over devices: the mesh and DGC (``paddle_tpu/parallel``)."""

from .mesh import (AXES, Mesh, current_mesh, data_parallel_mesh,  # noqa
                   hierarchical_allreduce, make_hierarchical_mesh,
                   make_mesh, mesh_axis_sizes, set_mesh)
from .dgc import DGCGradAllReduce  # noqa  (registers the dgc_* lowerings)
