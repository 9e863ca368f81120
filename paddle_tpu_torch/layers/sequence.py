"""Sequence layers over padded-plus-lengths tensors (the port's part of
``paddle_tpu/layers/sequence.py``): ``sequence_mask`` and the pooling
layers.  The other sequence layers wait for their op types (ROADMAP)."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def sequence_mask(x, maxlen=None, dtype="int64"):
    """lengths [b] -> mask [b, maxlen] (ref sequence_mask_op)."""
    helper = LayerHelper("sequence_mask")
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]},
                     attrs={"maxlen": maxlen or -1, "out_dtype": dtype})
    return out


def sequence_pool(input, pool_type, is_test=False, seq_len=None):
    """padded [b, t, ...] + lengths -> pooled [b, ...] (ref
    sequence_pool_op.cc; ``pool_type`` average, sum, sqrt, max, last or
    first)."""
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference("int32", True)
    inputs = {"X": [input]}
    seq_len = seq_len or getattr(input, "seq_len_var", None)
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op("sequence_pool", inputs=inputs,
                     outputs={"Out": [out], "MaxIndex": [idx]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, seq_len=None):
    return sequence_pool(input, "first", seq_len=seq_len)


def sequence_last_step(input, seq_len=None):
    return sequence_pool(input, "last", seq_len=seq_len)
