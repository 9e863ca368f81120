"""Contrib layers (the port's part of ``paddle_tpu/contrib/layers/``, ref
``python/paddle/fluid/contrib/layers/``): the basic recurrent layers."""

from .rnn_impl import (BasicGRUUnit, BasicLSTMUnit, basic_gru,  # noqa
                       basic_lstm)
