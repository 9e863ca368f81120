"""Dygraph (define-by-run) mode: the part of ``paddle_tpu/dygraph`` the
static optimizers' eager apply stands on (the pipeline engine applies each
stage's optimizer through it).

- :mod:`base`: ``guard()``, ``in_dygraph_mode()``;
- :mod:`tracer`: ``VarBase`` as a value holder;
- :mod:`eager_apply`: ``EagerBlock`` and ``eager_clip_grads``.

Not ported yet (ROADMAP Queue 1 item 4): the tape and eager autograd
(``VarBase.backward``), ``dygraph.nn``'s layers, ``to_variable``,
``no_grad``, the learning-rate schedulers and the checkpoints.
"""

from .base import guard, in_dygraph_mode  # noqa
from .eager_apply import EagerBlock, eager_clip_grads  # noqa
from .tracer import VarBase  # noqa
