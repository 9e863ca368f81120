"""Parallelism over devices: the mesh, GSPMD (the logical-axis
partitioner and the SPMD lowering) and DGC (``paddle_tpu/parallel``)."""

from .mesh import (AXES, Mesh, axis_groups, current_mesh,  # noqa
                   data_parallel_mesh, hierarchical_allreduce,
                   make_hierarchical_mesh, make_mesh, make_topology_mesh,
                   mesh_axis_sizes, rank_coords, set_mesh, sharding_for)
from .partitioner import (DEFAULT_RULE_TABLES, LogicalAxisRules,  # noqa
                          apply_rules, choose_rules, infer_logical_axes,
                          partition_fingerprint, partition_program,
                          rule_table)
from .spmd import Sharding, ShardedValue  # noqa
from .dgc import DGCGradAllReduce  # noqa  (registers the dgc_* lowerings)
