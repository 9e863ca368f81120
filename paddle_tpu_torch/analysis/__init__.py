"""Program analyses (the port's ``paddle_tpu/analysis/``): the cost model,
the graph-fusion pass, the program verifier, the static memory planner and
the measured device-time attribution of profiler windows."""
