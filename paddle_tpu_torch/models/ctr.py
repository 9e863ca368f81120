"""CTR models: a DeepFM-style sparse + dense click predictor (the port of
``paddle_tpu/models/ctr.py``; ref ``tests/unittests/dist_ctr.py``, the
PS-mode reference workload, and the pslib DownpourWorker sparse pull/push
pattern).

The 26 sparse slots share one embedding table indexed with slot-offset ids
(slot i maps id → i * sparse_dim + id): one gather instead of 26 small
ones, and one server table instead of 26 under the parameter server."""

from __future__ import annotations

import numpy as np

from .. import layers
from ..param_attr import ParamAttr

NUM_SPARSE_SLOTS = 26
NUM_DENSE = 13


def build_ctr_train(sparse_dim=1000, embed_size=16, is_sparse=False,
                    deep_layers=(64, 32), use_fm=True):
    """Returns (avg_loss, prob, feeds).

    feeds: dense [N, 13] float32, sparse [N, 26] int64 (per-slot ids),
    label [N, 1] int64.
    """
    dense = layers.data("dense", shape=[NUM_DENSE], dtype="float32")
    sparse = layers.data("sparse", shape=[NUM_SPARSE_SLOTS], dtype="int64")
    label = layers.data("click", shape=[1], dtype="int64")

    # slot-offset the ids into one shared table: [26 * sparse_dim, E]
    offsets = layers.assign(
        np.arange(NUM_SPARSE_SLOTS, dtype="int64") * sparse_dim)
    slot_ids = layers.elementwise_add(sparse, offsets)
    emb = layers.embedding(
        slot_ids, size=[NUM_SPARSE_SLOTS * sparse_dim, embed_size],
        is_sparse=is_sparse, param_attr=ParamAttr(name="ctr_embedding"))
    # emb: [N, 26, E]

    # wide part: sum of per-slot 1-d weights (linear over sparse features)
    wide_emb = layers.embedding(
        slot_ids, size=[NUM_SPARSE_SLOTS * sparse_dim, 1],
        is_sparse=is_sparse, param_attr=ParamAttr(name="ctr_wide_w"))
    wide = layers.reduce_sum(wide_emb, dim=[1])          # [N, 1]

    # deep part: flattened embeddings + dense features → MLP
    deep_in = layers.concat(
        [layers.reshape(emb, shape=[-1, NUM_SPARSE_SLOTS * embed_size]),
         dense], axis=1)
    h = deep_in
    for width in deep_layers:
        h = layers.fc(h, size=width, act="relu")
    deep = layers.fc(h, size=1)

    logit = layers.elementwise_add(wide, deep)
    if use_fm:
        # FM second-order term: 0.5 * ((Σv)² − Σv²) summed over E
        sum_v = layers.reduce_sum(emb, dim=[1])          # [N, E]
        sum_sq = layers.elementwise_mul(sum_v, sum_v)
        sq_sum = layers.reduce_sum(layers.elementwise_mul(emb, emb),
                                   dim=[1])
        fm = layers.scale(layers.reduce_sum(
            layers.elementwise_sub(sum_sq, sq_sum), dim=[1], keep_dim=True),
            scale=0.5)
        logit = layers.elementwise_add(logit, fm)

    loss = layers.sigmoid_cross_entropy_with_logits(logit,
                                                    layers.cast(label,
                                                                "float32"))
    avg_loss = layers.mean(loss)
    prob = layers.sigmoid(logit)
    return avg_loss, prob, [dense, sparse, label]
