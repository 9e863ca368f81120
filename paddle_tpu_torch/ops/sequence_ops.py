"""Sequence op lowerings over padded-plus-lengths tensors (the port's part
of ``paddle_tpu/ops/sequence_ops.py``, ref ``operators/sequence_ops/``):
``sequence_mask`` and ``sequence_pool``.  Data is dense ``[batch, time,
...]``; an optional ``SeqLen`` input ``[batch]`` masks the padding.  The
other sequence and LoD op types wait for a later slice (ROADMAP)."""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from .common import X, canon_dtype, static_int


def _time_mask(x, seq_len, dtype=None):
    """[b, t, 1, ...] mask from lengths, broadcastable to x."""
    if seq_len is None:
        return None
    t = x.shape[1]
    m = torch.arange(t, device=x.device)[None, :] < seq_len.reshape(-1, 1)
    m = m.reshape(tuple(m.shape) + (1,) * (x.dim() - 2))
    return m if dtype is None else m.to(dtype)


@register_op("sequence_mask", no_grad=True)
def _sequence_mask(ctx, ins, attrs):
    """lengths [b] -> mask [b, maxlen] (ref ``sequence_ops.py:28``); a
    ``maxlen`` of -1 is the longest length, read on the host."""
    lens = X(ins, "X")
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        maxlen = static_int(lens.max().reshape(1), "sequence_mask maxlen")
    m = torch.arange(maxlen, device=lens.device)[None, :] < \
        lens.reshape(-1, 1)
    return {"Y": [m.to(canon_dtype(attrs.get("out_dtype", "int64")))]}


@register_op("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    """Pool over time within each length (ref ``sequence_ops.py:40``):
    AVERAGE, SUM, SQRT, MAX, FIRST or LAST."""
    x = X(ins, "X")
    seq_len = X(ins, "SeqLen")
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    mask = _time_mask(x, seq_len, x.dtype)
    n = seq_len.reshape((-1,) + (1,) * (x.dim() - 2)).to(x.dtype) \
        if seq_len is not None else x.shape[1]
    if ptype in ("AVERAGE", "SUM", "SQRT"):
        s = torch.sum(x * mask if mask is not None else x, dim=1)
        if ptype == "AVERAGE":
            out = s / n
        elif ptype == "SQRT":
            out = s / (torch.sqrt(n) if seq_len is not None
                       else x.shape[1] ** 0.5)
        else:
            out = s
    elif ptype == "MAX":
        low = torch.finfo(x.dtype).min if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        out = torch.amax(torch.where(mask.bool(), x, low)
                         if mask is not None else x, dim=1)
    elif ptype == "FIRST":
        out = x[:, 0]
    elif ptype == "LAST":
        if seq_len is not None:
            idx = torch.clamp(seq_len.to(torch.int64) - 1, min=0)
            out = torch.take_along_dim(
                x, idx.reshape((-1, 1) + (1,) * (x.dim() - 2)), dim=1)[:, 0]
        else:
            out = x[:, -1]
    else:
        raise NotImplementedError(f"sequence_pool type {ptype}")
    return {"Out": [out],
            "MaxIndex": [torch.zeros((x.shape[0],), dtype=torch.int32,
                                     device=x.device)]}
