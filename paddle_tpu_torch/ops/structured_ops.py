"""Candidate-sampling losses (the port's part of
``paddle_tpu/ops/structured_ops.py``, ref ``operators/nce_op.cc``): the
``nce`` op.

Its negative samples are drawn from the run's counter stream
(``LowerCtx.rng``, the Philox stream the dropout kernel reads), four
bytes a sample as one uint32; the draws differ from the reference's jax
keys, and the op reports them in ``SampleLabels``, so a loss is held
against the reference on the same samples."""

from __future__ import annotations

import math

import torch

from ..framework.registry import register_op
from ..kernels.dropout import philox_bytes
from .common import X


def _log_uniform_prob(ids, range_max):
    return torch.log1p(1.0 / (ids.float() + 1.0)) / math.log(range_max + 1.0)


def uniform_draws(stream, n, device) -> torch.Tensor:
    """``n`` floats in [0, 1) from ``stream``: four bytes each, read as a
    little-endian uint32 over 2^32 (zeros on the meta device, where no
    bits are drawn)."""
    if stream is None or device.type == "meta":
        return torch.zeros(n, dtype=torch.float64, device=device)
    b = philox_bytes(stream, (n, 4), device).to(torch.int64)
    words = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return words.to(torch.float64) / 2.0 ** 32


def sample_classes(stream, n, num_classes, sampler, device):
    """``n`` shared negative samples and their proposal probabilities
    (ref ``structured_ops.py:241-253``): uniform, or log-uniform by the
    inverse of its CDF."""
    u = uniform_draws(stream, n, device)
    if sampler == "log_uniform":
        ids = (torch.exp(u * math.log(num_classes + 1.0)) - 1.0).long()
        ids = ids.clamp(0, num_classes - 1)
        return ids, _log_uniform_prob(ids, num_classes)
    ids = torch.floor(u * num_classes).long().clamp(0, num_classes - 1)
    return ids, torch.full((n,), 1.0 / num_classes, device=device)


@register_op("nce", stateful_rng=True)
def _nce(ctx, ins, attrs):
    """ref ``structured_ops.py:256``: NCE's logistic loss with the noise
    correction ``logit - log(num_neg * q)`` (ref nce_op.h), over each
    example's true classes and ``num_neg_samples`` negatives shared by the
    batch."""
    x, label = X(ins, "Input"), X(ins, "Label")       # [b, d], [b, nt]
    w, bias = X(ins, "Weight"), X(ins, "Bias")        # [C, d], [C]
    num_neg = attrs.get("num_neg_samples", 10)
    num_classes = attrs.get("num_total_classes", w.shape[0])
    sampler = {0: "uniform", 1: "log_uniform"}.get(attrs.get("sampler", 0),
                                                    "uniform")
    if label.dim() == 1:
        label = label[:, None]
    label = label.long()
    neg, q_neg = sample_classes(ctx.rng(), num_neg, num_classes, sampler,
                                x.device)
    q_true = (_log_uniform_prob(label, num_classes)
              if sampler == "log_uniform"
              else torch.full(label.shape, 1.0 / num_classes,
                              device=x.device))
    s_true = torch.einsum("bd,bnd->bn", x, w[label])
    s_neg = x @ w[neg].T                              # [b, S]
    if bias is not None:
        bvec = bias.reshape(-1)
        s_true = s_true + bvec[label]
        s_neg = s_neg + bvec[neg][None, :]
    lt = s_true - torch.log(num_neg * q_true + 1e-20).to(x.dtype)
    ln = s_neg - torch.log(num_neg * q_neg + 1e-20).to(x.dtype)[None, :]
    sp = torch.nn.functional.softplus
    cost = sp(-lt).sum(dim=1) + sp(ln).sum(dim=1)
    labels = torch.cat([label, neg[None, :].expand(x.shape[0], num_neg)],
                       dim=1)
    return {"Cost": [cost[:, None]],
            "SampleLogits": [torch.cat([s_true, s_neg], dim=1)],
            "SampleLabels": [labels]}
