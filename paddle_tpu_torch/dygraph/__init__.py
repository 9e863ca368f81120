"""Dygraph (define-by-run) mode (the port of ``paddle_tpu/dygraph``; ref
``python/paddle/fluid/dygraph/`` and ``paddle/fluid/imperative/``):

- :mod:`tracer`: ``VarBase``, the ``Tracer`` and its tape;
- :mod:`base`: ``guard(place)`` (the card by default), ``to_variable``,
  ``no_grad``, ``BackwardStrategy``;
- :mod:`layers` / :mod:`nn`: ``Layer`` and the 20 ``nn`` layers;
- :mod:`learning_rate_scheduler`: the seven decays;
- :mod:`checkpoint`: ``save_dygraph`` / ``load_dygraph``;
- :mod:`parallel`: ``DataParallel`` over the process group;
- :mod:`eager_apply`: the optimizers' eager update (``EagerBlock``).
"""

from . import nn  # noqa
from .base import enabled, guard, in_dygraph_mode, no_grad, to_variable  # noqa
from .checkpoint import load_dygraph, save_dygraph  # noqa
from .eager_apply import EagerBlock, eager_clip_grads  # noqa
from .layers import Layer  # noqa
from .learning_rate_scheduler import (CosineDecay, ExponentialDecay,  # noqa
                                      InverseTimeDecay, LearningRateDecay,
                                      NaturalExpDecay, NoamDecay,
                                      PiecewiseDecay, PolynomialDecay)
from .nn import (FC, NCE, BatchNorm, BilinearTensorProduct, Conv2D,  # noqa
                 Conv2DTranspose, Conv3D, Conv3DTranspose, Dropout,
                 Embedding, GroupNorm, GRUUnit, LayerNorm, Linear, Pool2D,
                 PRelu, RowConv, SequenceConv, SpectralNorm, TreeConv)
from .parallel import DataParallel, Env, ParallelEnv, prepare_context  # noqa
from .tracer import Tracer, VarBase, default_tracer  # noqa
from .base import BackwardStrategy  # noqa
