"""Seq2seq decoder toolkit (the port's ``paddle_tpu/contrib/decoder/``, ref
``python/paddle/fluid/contrib/decoder/``)."""

from .beam_search_decoder import (BeamSearchDecoder, InitState,  # noqa
                                  StateCell, TrainingDecoder)
