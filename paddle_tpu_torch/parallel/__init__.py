"""Parallelism over devices: the mesh (``paddle_tpu/parallel``)."""

from .mesh import (AXES, Mesh, current_mesh, make_mesh,  # noqa
                   mesh_axis_sizes, set_mesh)
