"""The inference engine (the port of ``paddle_tpu/inference/``; ref
``paddle/fluid/inference/``, SURVEY §2.9).

The reference stack is AnalysisConfig → the analysis IR passes → an
executor.  The port's predictor loads a saved inference model, runs the
reference's pass pipeline over it in the reference's order (among them
``attention_fuse_pass``, which puts a long dense attention chain on the
``flash_attention`` op and so on K1, and ``conv_bn_fuse_pass``), and runs
the analyzed program op by op through ``framework.function`` on the card
(``CUDAPlace``), or on the host when the config asks for it
(``disable_gpu()``).
"""

from .api import NativePaddlePredictor  # noqa
from .api import (AnalysisConfig, AnalysisPredictor, PaddlePredictor,  # noqa
                  PaddleTensor, ZeroCopyTensor, clear_engine_cache,
                  create_paddle_predictor)
