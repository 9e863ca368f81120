"""Program analyses (the port's ``paddle_tpu/analysis/``): the cost model,
the graph-fusion pass, the program verifier, the static memory planner, the
measured device-time attribution of profiler windows, the numerics plane
(``numerics``: per-step tensor-health statistics, the anomaly engine and
the checkpoint quarantine), the comms plane (``comms``: the static comms
plan of a collective program and its runtime measurement) and the sharding
plane (``sharding``: PartitionSpec propagation and the reshard plan of a
partitioned program)."""

from .comms import (  # noqa: F401
    CommsPlan, device_link_bandwidth, plan_comms,
)
from .memory import MemoryPlan, plan_memory, plan_sharded_memory  # noqa
from .numerics import (  # noqa: F401
    NumericsEngine, NumericsFrame, StatsLayout, loss_fingerprint,
    plan_numerics, record_anomaly,
)
from .sharding import (  # noqa: F401
    ReshardEdge, ShardingPlan, check_decode_hostable, plan_sharding,
    runtime_comms_plan,
)
from .verifier import (  # noqa: F401
    CHECKS, Diagnostic, ProgramVerificationError, VerifyResult,
    collective_fingerprint, verify_or_raise, verify_program,
)

__all__ = ["CHECKS", "CommsPlan", "Diagnostic", "MemoryPlan",
           "NumericsEngine", "NumericsFrame", "ProgramVerificationError",
           "ReshardEdge", "ShardingPlan", "StatsLayout", "VerifyResult",
           "check_decode_hostable", "collective_fingerprint",
           "device_link_bandwidth", "loss_fingerprint", "plan_comms",
           "plan_memory", "plan_numerics", "plan_sharded_memory",
           "plan_sharding", "record_anomaly", "runtime_comms_plan",
           "verify_or_raise", "verify_program"]
