"""Transformer encoder, the GPT serving program, the BERT/GPT pretraining
programs and the Transformer-base NMT program, built from the layer DSL.

The port's copy of ``paddle_tpu/models/transformer.py`` (ref
``python/paddle/fluid/tests/unittests/dist_transformer.py:958,1034``): the
op lists, variable names and parameter names are the reference's, so a
scope of ``paddle_tpu`` parameters serves and trains here unchanged.
Dropout is the reference's: after the embedding LayerNorm, on the
attention weights (the "base" chain only), on each sublayer's output and on
the FFN's hidden activation, all ``upscale_in_train``.
"""

from __future__ import annotations

import numpy as np

from .. import layers
from ..param_attr import ParamAttr


def multi_head_attention(queries, keys, values, d_model, n_head,
                         dropout_rate=0.0, attn_bias=None, is_test=False,
                         param_prefix="attn", attn_impl="base",
                         causal=False):
    """ref dist_transformer.py:958 multi_head_attention.

    attn_impl: "base" (matmul→softmax→matmul chain, ref recipe), "flash"
    (the fused ``flash_attention`` op), "ring" (the ``ring_attention`` op:
    the ring over the current mesh's ``sp`` axis, flash without one; no
    ``attn_bias``), or "auto" — flash from T ≥ 1024 when no
    attention-weight dropout is wanted, else base (the reference's rule,
    ``paddle_tpu/models/transformer.py:37-40``).  The fused paths skip
    attention-weight dropout, as the reference's do."""
    d_head = d_model // n_head
    if attn_impl == "auto":
        seq = queries.shape[1] if queries.shape is not None else 0
        exact = (dropout_rate == 0.0) or is_test
        attn_impl = "flash" if (seq and seq >= 1024 and exact) else "base"
    if attn_impl not in ("base", "flash", "ring"):
        raise NotImplementedError(f"attn_impl={attn_impl!r} is not ported")

    def _proj(x, size, name):
        return layers.fc(x, size=size, num_flatten_dims=2,
                         param_attr=ParamAttr(name=f"{param_prefix}.{name}.w"),
                         bias_attr=ParamAttr(name=f"{param_prefix}.{name}.b"))

    if queries is keys and keys is values:
        # self-attention: one fused QKV projection
        qkv = _proj(queries, 3 * d_model, "qkv")
        q, k, v = layers.split(qkv, 3, dim=2)
    else:
        q = _proj(queries, d_model, "q")
        k = _proj(keys, d_model, "k")
        v = _proj(values, d_model, "v")

    def _split_heads(x):
        # [b, t, d] -> [b, h, t, dh]
        y = layers.reshape(x, shape=[0, 0, n_head, d_head])
        return layers.transpose(y, perm=[0, 2, 1, 3])

    q, k, v = _split_heads(q), _split_heads(k), _split_heads(v)
    if attn_impl == "flash":
        ctx = layers.flash_attention(q, k, v, bias=attn_bias, causal=causal,
                                     sm_scale=float(d_head) ** -0.5)
    elif attn_impl == "ring":
        assert attn_bias is None, "ring attention supports causal= only"
        ctx = layers.ring_attention(q, k, v, causal=causal,
                                    sm_scale=float(d_head) ** -0.5)
    else:
        # scaled dot-product attention (ref dist_transformer.py:1034)
        scores = layers.matmul(q, k, transpose_y=True,
                               alpha=float(d_head) ** -0.5)
        if attn_bias is not None:
            scores = scores + attn_bias
        if causal:
            # [T,T] additive mask built from ops: -1e9 where j > i
            t = q.shape[2]
            r = layers.range(0, t, 1, "float32")
            row = layers.expand(layers.unsqueeze(r, [1]), [1, t])
            col = layers.expand(layers.unsqueeze(r, [0]), [t, 1])
            mask = layers.scale(layers.relu(layers.sign(col - row)),
                                scale=-1e9)
            scores = scores + mask
        weights = layers.softmax(scores)
        if dropout_rate:
            weights = layers.dropout(
                weights, dropout_prob=dropout_rate, is_test=is_test,
                dropout_implementation="upscale_in_train")
        ctx = layers.matmul(weights, v)                   # [b, h, t, dh]
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = layers.reshape(ctx, shape=[0, 0, d_model])
    return layers.fc(ctx, size=d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(name=f"{param_prefix}.out.w"),
                     bias_attr=ParamAttr(name=f"{param_prefix}.out.b"))


def positionwise_ffn(x, d_inner, d_model, dropout_rate=0.0, is_test=False,
                     param_prefix="ffn", act="gelu"):
    h = layers.fc(x, size=d_inner, num_flatten_dims=2, act=act,
                  param_attr=ParamAttr(name=f"{param_prefix}.fc1.w"),
                  bias_attr=ParamAttr(name=f"{param_prefix}.fc1.b"))
    if dropout_rate:
        h = layers.dropout(h, dropout_prob=dropout_rate, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    return layers.fc(h, size=d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(name=f"{param_prefix}.fc2.w"),
                     bias_attr=ParamAttr(name=f"{param_prefix}.fc2.b"))


def encoder_layer(x, d_model, d_inner, n_head, dropout_rate=0.0,
                  attn_bias=None, is_test=False, idx=0, attn_impl="base",
                  causal=False):
    """post-LN residual block (ref dist_transformer encoder_layer)."""
    attn = multi_head_attention(x, x, x, d_model, n_head, dropout_rate,
                                attn_bias, is_test,
                                param_prefix=f"enc_{idx}.attn",
                                attn_impl=attn_impl, causal=causal)
    if dropout_rate:
        attn = layers.dropout(attn, dropout_prob=dropout_rate,
                              is_test=is_test,
                              dropout_implementation="upscale_in_train")
    x = layers.layer_norm(x + attn, begin_norm_axis=2,
                          param_attr=ParamAttr(name=f"enc_{idx}.ln1.w"),
                          bias_attr=ParamAttr(name=f"enc_{idx}.ln1.b"))
    ffn = positionwise_ffn(x, d_inner, d_model, dropout_rate, is_test,
                           param_prefix=f"enc_{idx}.ffn")
    if dropout_rate:
        ffn = layers.dropout(ffn, dropout_prob=dropout_rate, is_test=is_test,
                             dropout_implementation="upscale_in_train")
    return layers.layer_norm(x + ffn, begin_norm_axis=2,
                             param_attr=ParamAttr(name=f"enc_{idx}.ln2.w"),
                             bias_attr=ParamAttr(name=f"enc_{idx}.ln2.b"))


def encoder(src_ids, pos_ids, vocab_size, max_pos, n_layer, d_model, d_inner,
            n_head, dropout_rate=0.0, attn_bias=None, is_test=False,
            type_ids=None, n_types=2, attn_impl="base", checkpoints=None,
            arange_pos=False, causal=False):
    """BERT-style embedding + N encoder layers.  ``checkpoints=[]``
    collects each layer's output, the segment boundaries of
    ``RecomputeOptimizer`` (ref ``transformer.py:139-176``).
    ``arange_pos=True``: the position embedding is a static slice of the
    table broadcast over the batch (positions 0..T-1 for every row)."""
    emb = layers.embedding(src_ids, size=[vocab_size, d_model],
                           param_attr=ParamAttr(name="word_embedding"))
    if arange_pos:
        seq_len = src_ids.shape[-1]
        pos_table = layers.create_parameter(
            [max_pos, d_model], dtype="float32",
            attr=ParamAttr(name="pos_embedding"))
        pos = layers.slice(pos_table, axes=[0], starts=[0], ends=[seq_len])
        pos = layers.unsqueeze(pos, [0])          # [1, T, D] broadcast-add
    else:
        pos = layers.embedding(pos_ids, size=[max_pos, d_model],
                               param_attr=ParamAttr(name="pos_embedding"))
    x = emb + pos
    if type_ids is not None:
        x = x + layers.embedding(type_ids, size=[n_types, d_model],
                                 param_attr=ParamAttr(name="sent_embedding"))
    x = layers.layer_norm(x, begin_norm_axis=2,
                          param_attr=ParamAttr(name="pre_encoder.ln.w"),
                          bias_attr=ParamAttr(name="pre_encoder.ln.b"))
    if dropout_rate:
        x = layers.dropout(x, dropout_prob=dropout_rate, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    for i in range(n_layer):
        x = encoder_layer(x, d_model, d_inner, n_head, dropout_rate,
                          attn_bias, is_test, idx=i, attn_impl=attn_impl,
                          causal=causal)
        if checkpoints is not None:
            checkpoints.append(x)
    return x


class BertConfig:
    """BERT-base defaults (BASELINE config #4)."""

    def __init__(self, vocab_size=30522, d_model=768, n_layer=12, n_head=12,
                 d_inner=3072, max_pos=512, dropout=0.1):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_layer = n_layer
        self.n_head = n_head
        self.d_inner = d_inner
        self.max_pos = max_pos
        self.dropout = dropout

    def num_params(self):
        V, D, L, F, P = (self.vocab_size, self.d_model, self.n_layer,
                         self.d_inner, self.max_pos)
        per_layer = 4 * D * D + 4 * D + 2 * D * F + F + D + 4 * D
        return V * D + P * D + 2 * D + L * per_layer


def _lm_head_loss(enc, cfg, lm_label, fused_head, param_name):
    """Shared LM head + masked-mean CE (label 0 = [PAD] excluded) used by
    both the MLM and causal-LM builders (ref ``transformer.py:200``)."""
    if fused_head:
        loss = layers.fused_lm_head_ce(
            enc, cfg.vocab_size, lm_label,
            param_attr=ParamAttr(name=f"{param_name}.w"),
            bias_attr=ParamAttr(name=f"{param_name}.b"), ignore_index=0)
        logits = None
    else:
        logits = layers.fc(enc, size=cfg.vocab_size, num_flatten_dims=2,
                           param_attr=ParamAttr(name=f"{param_name}.w"),
                           bias_attr=ParamAttr(name=f"{param_name}.b"))
        loss = layers.softmax_with_cross_entropy(
            logits, layers.unsqueeze(lm_label, [2]), ignore_index=0)
    mask = layers.cast(lm_label > 0, "float32")
    masked = layers.reduce_sum(loss * layers.unsqueeze(mask, [2]))
    denom = layers.reduce_sum(mask) + 1e-6
    return logits, masked / denom


def build_bert_pretrain(cfg: BertConfig, seq_len, is_test=False,
                        dropout=None, attn_impl="base", fused_head=False,
                        checkpoints=None, arange_pos=False,
                        masked_gather=None):
    """Masked-LM pretraining net: ids+mask-labels → mean masked CE loss
    (ref ``transformer.py:221``).  Labels use 0 ([PAD]) for unmasked
    positions, which are excluded from loss and denominator.
    ``checkpoints=[]`` collects each layer's output for
    ``RecomputeOptimizer``.

    ``masked_gather=N`` (ref ``:236-262``): feed ``mask_pos`` ([b, N]
    flattened absolute positions, b_idx * seq + pos) and ``lm_label`` [b,
    N]; the encoder output is gathered to the N masked positions of each
    sequence before the head."""
    dropout = cfg.dropout if dropout is None else dropout
    src_ids = layers.data("src_ids", shape=[seq_len], dtype="int64")
    pos_ids = None if arange_pos else \
        layers.data("pos_ids", shape=[seq_len], dtype="int64")
    label_len = masked_gather if masked_gather else seq_len
    lm_label = layers.data("lm_label", shape=[label_len], dtype="int64")
    mask_pos = layers.data("mask_pos", shape=[label_len], dtype="int64") \
        if masked_gather else None
    enc = encoder(src_ids, pos_ids, cfg.vocab_size, cfg.max_pos, cfg.n_layer,
                  cfg.d_model, cfg.d_inner, cfg.n_head, dropout,
                  is_test=is_test, attn_impl=attn_impl,
                  checkpoints=checkpoints, arange_pos=arange_pos)
    if masked_gather:
        flat = layers.reshape(enc, shape=[-1, cfg.d_model])
        enc = layers.reshape(
            layers.gather(flat, layers.reshape(mask_pos, shape=[-1])),
            shape=[-1, label_len, cfg.d_model])
    logits, avg_loss = _lm_head_loss(enc, cfg, lm_label, fused_head,
                                     "mlm_out")
    feeds = [src_ids] if arange_pos else [src_ids, pos_ids]
    if mask_pos is not None:
        feeds.append(mask_pos)
    feeds.append(lm_label)
    return tuple(feeds), logits, avg_loss


def build_gpt_pretrain(cfg: BertConfig, seq_len, is_test=False,
                       dropout=None, attn_impl="auto", fused_head=True,
                       checkpoints=None):
    """Decoder-only causal LM (ref ``transformer.py:270``): ids → causal
    transformer → next-token CE.  ``lm_label`` is the next-token target
    (the input pipeline shifts; label 0 = [PAD] is excluded from the
    loss).  ``attn_impl="auto"`` picks the flash kernels from T ≥ 1024."""
    dropout = cfg.dropout if dropout is None else dropout
    src_ids = layers.data("src_ids", shape=[seq_len], dtype="int64")
    lm_label = layers.data("lm_label", shape=[seq_len], dtype="int64")
    enc = encoder(src_ids, None, cfg.vocab_size, cfg.max_pos, cfg.n_layer,
                  cfg.d_model, cfg.d_inner, cfg.n_head, dropout,
                  is_test=is_test, attn_impl=attn_impl,
                  checkpoints=checkpoints, arange_pos=True, causal=True)
    logits, avg_loss = _lm_head_loss(enc, cfg, lm_label, fused_head,
                                     "lm_out")
    return (src_ids, lm_label), logits, avg_loss


def build_gpt_serving(cfg: BertConfig, seq_len, attn_impl="auto"):
    """Inference-only causal LM: ids → next-token logits, no label feed
    and no loss — the program a serving bucket factory materializes per
    sequence-length bucket (``paddle_tpu_torch.serving.InferenceServer``).
    Parameter names match ``paddle_tpu``'s ``build_gpt_pretrain`` exactly
    (shared ``lm_out`` head), so a trained scope serves unchanged."""
    src_ids = layers.data("src_ids", shape=[seq_len], dtype="int64")
    enc = encoder(src_ids, None, cfg.vocab_size, cfg.max_pos, cfg.n_layer,
                  cfg.d_model, cfg.d_inner, cfg.n_head, 0.0,
                  is_test=True, attn_impl=attn_impl, arange_pos=True,
                  causal=True)
    logits = layers.fc(enc, size=cfg.vocab_size, num_flatten_dims=2,
                       param_attr=ParamAttr(name="lm_out.w"),
                       bias_attr=ParamAttr(name="lm_out.b"))
    return (src_ids,), logits


# -- Transformer-base NMT (BASELINE config #3, WMT14 en-de) ------------------

def annotate_tensor_parallel(program=None):
    """The Megatron layout by parameter name, as ``dist_spec`` s (ref
    ``transformer.py:312``): q/k/v/qkv and fc1 column-parallel, out and
    fc2 row-parallel, the word embedding and the MLM head vocab-sharded,
    all over ``mp``.  ``CompiledProgram.with_distributed`` lays the
    parameters out so."""
    from ..framework.core import default_main_program
    program = program or default_main_program()
    for p in program.all_parameters():
        n = p.name
        if n.endswith((".q.w", ".k.w", ".v.w", ".qkv.w", ".fc1.w")):
            p.dist_spec = (None, "mp")          # column parallel
        elif n.endswith((".q.b", ".k.b", ".v.b", ".qkv.b", ".fc1.b")):
            p.dist_spec = ("mp",)
        elif n.endswith((".out.w", ".fc2.w")):
            p.dist_spec = ("mp", None)          # row parallel
        elif n == "word_embedding":
            p.dist_spec = ("mp", None)          # vocab sharded
        elif n == "mlm_out.w":
            p.dist_spec = (None, "mp")
        elif n == "mlm_out.b":
            p.dist_spec = ("mp",)
    return program


def build_transformer_nmt(src_vocab, trg_vocab, seq_len, d_model=512,
                          n_layer=6, n_head=8, d_inner=2048, dropout=0.1,
                          is_test=False, fused_head=False):
    """Encoder-decoder NMT Transformer (ref ``transformer.py:336``, after
    dist_transformer.py transformer()).

    Decoder self-attention adds a causal bias (an ``assign_value``
    constant); cross-attention attends the encoder output.
    ``fused_head=True`` computes projection + CE with the chunked
    ``fused_lm_head_ce`` op (no bias); ``logits`` is then None."""
    src_ids = layers.data("src_ids", shape=[seq_len], dtype="int64")
    src_pos = layers.data("src_pos", shape=[seq_len], dtype="int64")
    trg_ids = layers.data("trg_ids", shape=[seq_len], dtype="int64")
    trg_pos = layers.data("trg_pos", shape=[seq_len], dtype="int64")
    label = layers.data("label", shape=[seq_len], dtype="int64")

    enc_out = encoder(src_ids, src_pos, src_vocab, seq_len + 1, n_layer,
                      d_model, d_inner, n_head, dropout, is_test=is_test)

    # causal bias [1, 1, t, t]
    causal = np.triu(np.full((seq_len, seq_len), -1e9, np.float32), k=1)
    causal_var = layers.assign(causal.reshape(1, 1, seq_len, seq_len))
    causal_var.stop_gradient = True

    x = layers.embedding(trg_ids, size=[trg_vocab, d_model],
                         param_attr=ParamAttr(name="trg_word_embedding"))
    pos = layers.embedding(trg_pos, size=[seq_len + 1, d_model],
                           param_attr=ParamAttr(name="trg_pos_embedding"))
    x = x + pos
    x = layers.layer_norm(x, begin_norm_axis=2)
    for i in range(n_layer):
        attn = multi_head_attention(x, x, x, d_model, n_head, dropout,
                                    attn_bias=causal_var, is_test=is_test,
                                    param_prefix=f"dec_{i}.self")
        x = layers.layer_norm(x + attn, begin_norm_axis=2)
        cross = multi_head_attention(x, enc_out, enc_out, d_model, n_head,
                                     dropout, is_test=is_test,
                                     param_prefix=f"dec_{i}.cross")
        x = layers.layer_norm(x + cross, begin_norm_axis=2)
        ffn = positionwise_ffn(x, d_inner, d_model, dropout, is_test,
                               param_prefix=f"dec_{i}.ffn", act="relu")
        x = layers.layer_norm(x + ffn, begin_norm_axis=2)

    if fused_head:
        loss = layers.fused_lm_head_ce(
            x, trg_vocab, label, bias_attr=False,
            param_attr=ParamAttr(name="nmt_out.w"), ignore_index=0)
        logits = None
    else:
        logits = layers.fc(x, size=trg_vocab, num_flatten_dims=2,
                           param_attr=ParamAttr(name="nmt_out.w"),
                           bias_attr=False)
        loss = layers.softmax_with_cross_entropy(
            logits, layers.unsqueeze(label, [2]), ignore_index=0)
    mask = layers.cast(label > 0, "float32")
    avg_loss = layers.reduce_sum(loss * layers.unsqueeze(mask, [2])) / \
        (layers.reduce_sum(mask) + 1e-6)
    return (src_ids, src_pos, trg_ids, trg_pos, label), logits, avg_loss
