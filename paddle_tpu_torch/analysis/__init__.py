"""Program analyses (the port's ``paddle_tpu/analysis/``): the cost model,
the graph-fusion pass, the program verifier, the static memory planner, the
measured device-time attribution of profiler windows, the numerics plane
(``numerics``: per-step tensor-health statistics, the anomaly engine and
the checkpoint quarantine) and the comms plane (``comms``: the static comms
plan of a collective program and its runtime measurement)."""

from .comms import (  # noqa: F401
    CommsPlan, device_link_bandwidth, plan_comms,
)
from .numerics import (  # noqa: F401
    NumericsEngine, NumericsFrame, StatsLayout, loss_fingerprint,
    plan_numerics, record_anomaly,
)

__all__ = ["CommsPlan", "NumericsEngine", "NumericsFrame", "StatsLayout",
           "device_link_bandwidth", "loss_fingerprint", "plan_comms",
           "plan_numerics", "record_anomaly"]
