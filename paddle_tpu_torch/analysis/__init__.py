"""Program analyses (the port's ``paddle_tpu/analysis/``): the cost model,
the graph-fusion pass, the program verifier, the static memory planner, the
measured device-time attribution of profiler windows and the numerics
plane (``numerics``: per-step tensor-health statistics, the anomaly engine
and the checkpoint quarantine)."""

from .numerics import (  # noqa: F401
    NumericsEngine, NumericsFrame, StatsLayout, loss_fingerprint,
    plan_numerics, record_anomaly,
)

__all__ = ["NumericsEngine", "NumericsFrame", "StatsLayout",
           "loss_fingerprint", "plan_numerics", "record_anomaly"]
