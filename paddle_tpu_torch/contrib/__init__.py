"""Contrib subpackages (the port's part of ``paddle_tpu/contrib/``, ref
``python/paddle/fluid/contrib/``): the recurrent layers and the seq2seq
decoders.  The rest of the reference's contrib waits for later slices."""

from . import decoder, layers  # noqa
