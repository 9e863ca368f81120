"""Metric op lowerings (the ``accuracy`` op of ``paddle_tpu/ops/
metrics_ops.py``; ref ``operators/metrics/accuracy_op.cc``)."""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from .common import X


@register_op("accuracy", no_grad=True)
def _accuracy(ctx, ins, attrs):
    """Share of rows whose label is among their top-k ``Indices``."""
    indices, label = X(ins, "Indices"), X(ins, "Label")
    if label.dim() == 2 and label.shape[1] == 1:
        label = label[:, 0]
    correct = torch.any(indices == label[:, None].to(indices.dtype), dim=1)
    n = indices.shape[0]
    num_correct = torch.sum(correct.to(torch.float32))
    return {"Accuracy": [num_correct / n],
            "Correct": [num_correct.to(torch.int32)],
            "Total": [torch.tensor(n, dtype=torch.int32,
                                   device=indices.device)]}
