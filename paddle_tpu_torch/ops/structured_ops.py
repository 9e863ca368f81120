"""Candidate-sampling losses and beam search (the port's part of
``paddle_tpu/ops/structured_ops.py``, ref ``operators/nce_op.cc``,
``beam_search_op.cc``, ``beam_search_decode_op.cc``): the ``nce``,
``beam_search`` and ``beam_search_decode`` ops.

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


# ---------------------------------------------------------------------------
# beam search (ref structured_ops.py:364-439, beam_search_op.cc,
# beam_search_decode_op.cc)
# ---------------------------------------------------------------------------

#: the score a frozen beam's dead candidates get (the reference's)
NEG_INF = -1e9


def beam_candidates(ins, attrs):
    """The candidates a ``beam_search`` step chooses among: (scores, ids),
    each [batch, beam_size * K].  A finished beam (its previous id
    ``end_id``) keeps its frozen score in column 0 and ``NEG_INF`` in the
    others."""
    pre_ids = X(ins, "pre_ids").reshape(-1)
    pre_scores = X(ins, "pre_scores").reshape(-1)
    ids, scores = X(ins, "ids"), X(ins, "scores")       # [bb, K]
    beam_size, end_id = attrs["beam_size"], attrs["end_id"]
    bb, k = scores.shape
    dev = scores.device
    if ids is None:
        ids = torch.arange(k, device=dev)[None, :].expand(bb, k)
    acc = scores if attrs.get("is_accumulated", True) else \
        pre_scores[:, None] + torch.log(scores + 1e-20)
    finished = (pre_ids == end_id)[:, None]
    first_col = (torch.arange(k, device=dev) == 0)[None, :]
    frozen = torch.where(first_col, pre_scores[:, None].to(acc.dtype),
                         torch.full((), NEG_INF, dtype=acc.dtype,
                                    device=dev))
    cand_score = torch.where(finished, frozen, acc)
    cand_id = torch.where(finished, torch.full_like(ids, end_id), ids)
    return (cand_score.reshape(bb // beam_size, beam_size * k),
            cand_id.reshape(bb // beam_size, beam_size * k))


@register_op("beam_search", no_grad=True)
def _beam_search(ctx, ins, attrs):
    """One decoding step over dense [batch * beam, K] candidates
    (:func:`beam_candidates`): every sentence keeps exactly ``beam_size``
    slots.  The best ``beam_size`` of each sentence's ``beam_size * K``
    candidates are taken by a stable descending sort, so a tie goes to the
    lower candidate index, as ``lax.top_k`` breaks it (``torch.topk`` does
    not promise an order)."""
    beam_size = attrs["beam_size"]
    cand_score, cand_id = beam_candidates(ins, attrs)
    batch, n = cand_score.shape
    k = n // beam_size
    top_s, top_i = torch.sort(cand_score, dim=1, descending=True,
                              stable=True)
    top_s, top_i = top_s[:, :beam_size], top_i[:, :beam_size]
    sel_id = torch.gather(cand_id, 1, top_i)
    parent = top_i // k + torch.arange(batch, device=cand_score.device)[
        :, None] * beam_size
    bb = batch * beam_size
    return {"selected_ids": [sel_id.reshape(bb, 1).to(torch.int64)],
            "selected_scores": [top_s.reshape(bb, 1)],
            "parent_idx": [parent.reshape(bb).to(torch.int64)]}


@register_op("beam_search_decode", no_grad=True)
def _beam_search_decode(ctx, ins, attrs):
    """Backtrack the stored steps into sentences: Ids / Scores / Parents
    [T, bb(, 1)] (stacked tensor arrays) -> SentenceIds / SentenceScores
    [batch, beam, T].  The dense slots carry their parents explicitly
    where the reference recovers them from each step's LoD."""
    ids, scores = X(ins, "Ids"), X(ins, "Scores")
    parents = X(ins, "Parents")
    beam_size = attrs["beam_size"]
    ids = ids.reshape(ids.shape[0], -1)                 # [T, bb]
    scores = scores.reshape(scores.shape[0], -1)
    parents = parents.reshape(parents.shape[0], -1).to(torch.int64)
    t, bb = ids.shape
    slot = torch.arange(bb, device=ids.device)
    toks, scs = [None] * t, [None] * t
    for s in range(t - 1, -1, -1):
        toks[s] = ids[s][slot]
        scs[s] = scores[s][slot]
        slot = parents[s][slot]
    sent_ids = torch.stack(toks, 1).reshape(bb // beam_size, beam_size, t)
    sent_scores = torch.stack(scs, 1).reshape(bb // beam_size, beam_size, t)
    return {"SentenceIds": [sent_ids.to(torch.int64)],
            "SentenceScores": [sent_scores]}
