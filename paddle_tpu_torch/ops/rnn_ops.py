"""Recurrent op lowerings (the port's part of ``paddle_tpu/ops/rnn_ops.py``,
ref ``operators/gru_unit_op.cc`` and ``row_conv_op.cc``): the one-step
``gru_unit`` and the lookahead ``row_conv`` the dygraph ``GRUUnit`` and
``RowConv`` trace, on dense ``[batch, ...]`` tensors.  The scanned
``lstm`` / ``gru`` wait for their layers (ROADMAP Queue 1 item 4)."""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from .common import X

_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda x: x}
#: the reference's integer codes of the activations
_CODES = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _act(attr, default):
    name = _CODES.get(attr, default) if isinstance(attr, int) else attr
    return _ACTS[name]


@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """One GRU step (ref ``rnn_ops.py:138``): ``Input [b, 3d]`` (update,
    reset, candidate pre-activations), ``HiddenPrev [b, d]``, ``Weight
    [d, 3d]``, ``Bias [1, 3d]``; ``origin_mode`` is not read, as in the
    reference."""
    inp, h_prev = X(ins, "Input"), X(ins, "HiddenPrev")
    w, bias = X(ins, "Weight"), X(ins, "Bias")
    d = h_prev.shape[-1]
    gate_act = _act(attrs.get("gate_activation", 1), "sigmoid")
    cand_act = _act(attrs.get("activation", 2), "tanh")
    x = inp + bias.reshape(-1) if bias is not None else inp
    w_ur, w_c = w[:, :2 * d], w[:, 2 * d:]
    xu, xr, xc = x[:, :d], x[:, d:2 * d], x[:, 2 * d:]
    gates = torch.cat([xu, xr], -1) + h_prev @ w_ur
    u, r = gate_act(gates[:, :d]), gate_act(gates[:, d:])
    c = cand_act(xc + (r * h_prev) @ w_c)
    h = u * c + (1 - u) * h_prev
    return {"Gate": [torch.cat([u, r, c], -1)],
            "ResetHiddenPrev": [r * h_prev], "Hidden": [h]}


@register_op("row_conv")
def _row_conv(ctx, ins, attrs):
    """Lookahead row convolution (ref ``rnn_ops.py:179``) on ``[b, t, d]``:
    ``out[:, i] = sum_k x[:, i + k] * Filter[k]``, zero past the end."""
    x, filt = X(ins, "X"), X(ins, "Filter")
    k = filt.shape[0]
    t = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, 0, k - 1))
    out = pad[:, 0:t] * filt[0]
    for i in range(1, k):
        out = out + pad[:, i:i + t] * filt[i]
    return {"Out": [out]}
