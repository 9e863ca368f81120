"""Metric layers (``paddle_tpu/layers/metric_op.py``; ref
``python/paddle/fluid/layers/metric_op.py``)."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from . import nn


def accuracy(input, label, k=1, correct=None, total=None):
    """top_k + accuracy ops: the share of rows whose label is among their
    k largest predictions."""
    helper = LayerHelper("accuracy")
    _, topk_indices = nn.topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32", True)
    correct = correct or helper.create_variable_for_type_inference("int32",
                                                                   True)
    total = total or helper.create_variable_for_type_inference("int32", True)
    helper.append_op("accuracy",
                     inputs={"Out": [input], "Indices": [topk_indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    return acc_out
