"""Program analyses (the port's ``paddle_tpu/analysis/``): the cost model
and the graph-fusion pass."""
