"""A seq2seq model of the ``rnn_search`` recipe's widths, built from the
layer calls both packages share, so one builder makes the same training
and decoding programs in ``paddle_tpu`` and ``paddle_tpu_torch``.

The widths are PaddlePaddle/models ``rnn_search``'s IWSLT'15 en-vi recipe
(``run.sh`` / ``infer.sh``): 2 layers, hidden 512, source vocab 17191,
target vocab 7709, batch 128, dropout 0.2, Adam 1e-3 clipped by global
norm 5.0, beam 10.  The model is what the reference's API can build:

- encoder: ``embedding`` [src_vocab, hidden], then
  ``contrib.layers.basic_lstm`` (``num_layers`` layers, masked by
  ``src_len``, dropout between the layers, batch first);
- decoder: a ``contrib.decoder.StateCell`` of states ``h`` and ``c``,
  initialised from the encoder's top layer's final states, updated by one
  LSTM step (``fc`` to 4 x hidden, ``split``, the gate activations, as
  ``BasicLSTMUnit`` does), with no attention (the decoder API has none);
- training: the cell under ``TrainingDecoder`` over ``embedding``
  [trg_vocab, hidden] of the shifted target, ``fc`` to the target vocab,
  ``softmax_with_cross_entropy`` masked by ``sequence_mask(trg_len)``;
- decoding: the same cell under ``BeamSearchDecoder`` (beam ``beam``,
  ``topk_size`` ``beam``, ``max_len`` ``max_len``, ``end_id`` 1), the
  encoder's states expanded to ``batch * beam`` rows in the program.

``chip_smoke.py``'s ``seq2seq`` phase and ``tests/test_torch_seq2seq.py``
use it::

    cfg = Seq2SeqConfig(hidden=32, src_vocab=50, trg_vocab=50, seq=8)
    main, startup, loss = build_train(paddle_tpu_torch, cfg, dropout=0.0)
    feed = train_feed(cfg, batch=4, seed=0)
"""

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Seq2SeqConfig:
    num_layers: int = 2
    hidden: int = 512
    src_vocab: int = 17191
    trg_vocab: int = 7709
    seq: int = 50           # source and target padded to this length
    min_len: int = 10       # lengths drawn in [min_len, seq]
    beam: int = 10
    max_len: int = 50       # decode steps
    end_id: int = 1
    lr: float = 1e-3
    clip: float = 5.0


def _encoder(pkg, cfg, src, src_len, dropout):
    """The encoder's top layer's final ``h`` and ``c`` ([batch, hidden])."""
    layers = pkg.layers
    from importlib import import_module
    basic_lstm = import_module(pkg.__name__ + ".contrib.layers").basic_lstm
    emb = layers.embedding(src, size=[cfg.src_vocab, cfg.hidden],
                           param_attr=pkg.ParamAttr(name="src_emb"))
    _, last_h, last_c = basic_lstm(
        emb, None, None, hidden_size=cfg.hidden, num_layers=cfg.num_layers,
        sequence_length=src_len, dropout_prob=dropout, batch_first=True,
        name="enc")
    top = cfg.num_layers - 1

    def top_of(s):
        return layers.squeeze(layers.slice(s, axes=[0], starts=[top],
                                           ends=[top + 1]), axes=[0])
    return top_of(last_h), top_of(last_c)


def _cell(pkg, cfg, h0, c0):
    """The decoder's StateCell: one LSTM step of ``fc`` + ``split`` and
    the gate activations (``BasicLSTMUnit``'s, forget bias 1.0)."""
    layers = pkg.layers
    from importlib import import_module
    D = import_module(pkg.__name__ + ".contrib.decoder")
    cell = D.StateCell(inputs={"x": None},
                       states={"h": D.InitState(init=h0, need_reorder=True),
                               "c": D.InitState(init=c0, need_reorder=True)},
                       out_state="h")

    @cell.state_updater
    def updater(sc):
        x, h, c = sc.get_input("x"), sc.get_state("h"), sc.get_state("c")
        gates = layers.fc(layers.concat([x, h], axis=1),
                          size=4 * cfg.hidden,
                          param_attr=pkg.ParamAttr(name="dec_w"),
                          bias_attr=pkg.ParamAttr(name="dec_b"))
        i, j, f, o = layers.split(gates, num_or_sections=4, dim=1)
        new_c = layers.elementwise_add(
            layers.elementwise_mul(c, layers.sigmoid(f + 1.0)),
            layers.elementwise_mul(layers.sigmoid(i), layers.tanh(j)))
        new_h = layers.elementwise_mul(layers.tanh(new_c),
                                       layers.sigmoid(o))
        sc.set_state("h", new_h)
        sc.set_state("c", new_c)
    return cell, D


def build_train(pkg, cfg, dropout=0.2):
    """The training program: (main, startup, loss), the optimizer's ops
    appended (Adam clipped by global norm)."""
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        src = layers.data("src", shape=[cfg.seq], dtype="int64")
        src_len = layers.data("src_len", shape=[], dtype="int64")
        trg_in = layers.data("trg_in", shape=[cfg.seq], dtype="int64")
        trg_out = layers.data("trg_out", shape=[cfg.seq], dtype="int64")
        trg_len = layers.data("trg_len", shape=[], dtype="int64")
        h0, c0 = _encoder(pkg, cfg, src, src_len, dropout)
        cell, D = _cell(pkg, cfg, h0, c0)
        trg_emb = layers.embedding(trg_in, size=[cfg.trg_vocab, cfg.hidden],
                                   param_attr=pkg.ParamAttr(name="trg_emb"))
        dec = D.TrainingDecoder(cell)
        with dec.block():
            cur = dec.step_input(trg_emb, seq_len=trg_len)
            cell.compute_state(inputs={"x": cur})
            cell.update_states()
            dec.output(cell.get_state("h"))
        dec_out = dec()                                 # [b, seq, hidden]
        logits = layers.fc(dec_out, size=cfg.trg_vocab, num_flatten_dims=2,
                           param_attr=pkg.ParamAttr(name="out_w"),
                           bias_attr=pkg.ParamAttr(name="out_b"))
        ce = layers.softmax_with_cross_entropy(
            logits, layers.unsqueeze(trg_out, [2]))    # [b, seq, 1]
        mask = layers.sequence_mask(trg_len, maxlen=cfg.seq,
                                    dtype="float32")    # [b, seq]
        ce = layers.elementwise_mul(layers.squeeze(ce, axes=[2]), mask)
        loss = layers.reduce_sum(layers.reduce_mean(ce, dim=[0]))
        pkg.optimizer.AdamOptimizer(
            learning_rate=cfg.lr,
            grad_clip=pkg.GradientClipByGlobalNorm(cfg.clip)
        ).minimize(loss)
    return main, startup, loss


def build_decode(pkg, cfg, batch):
    """The decoding program for ``batch`` sentences: (main, startup, feed
    names, [ids, scores]), ``SentenceIds`` / ``SentenceScores`` of
    ``beam_search_decode`` [batch, beam, max_len + 1].  The beam's rows
    are each sentence's ``beam`` hypotheses in turn."""
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        # static shapes throughout: the beam's rows are laid out from the
        # batch, and shape inference needs it known
        src = layers.data("src", shape=[batch, cfg.seq], dtype="int64",
                          append_batch_size=False)
        src_len = layers.data("src_len", shape=[batch], dtype="int64",
                              append_batch_size=False)
        bb = batch * cfg.beam
        init_ids = layers.data("init_ids", shape=[bb, 1], dtype="int64",
                               append_batch_size=False)
        init_scores = layers.data("init_scores", shape=[bb, 1],
                                  dtype="float32", append_batch_size=False)
        h0, c0 = _encoder(pkg, cfg, src, src_len, 0.0)

        def beamed(s):                # [b, hidden] -> [b * beam, hidden]
            s = layers.expand(layers.unsqueeze(s, [1]), [1, cfg.beam, 1])
            return layers.reshape(s, [bb, cfg.hidden])
        cell, D = _cell(pkg, cfg, beamed(h0), beamed(c0))
        dec = D.BeamSearchDecoder(
            cell, init_ids, init_scores, target_dict_dim=cfg.trg_vocab,
            word_dim=cfg.hidden, topk_size=cfg.beam, sparse_emb=False,
            max_len=cfg.max_len, beam_size=cfg.beam, end_id=cfg.end_id)
        dec.decode()
        ids, scores = dec()
    return main, startup, ["src", "src_len", "init_ids", "init_scores"], \
        [ids, scores]


def _lengths(rng, cfg, n):
    return rng.randint(cfg.min_len, cfg.seq + 1, size=n).astype(np.int64)


def train_feed(cfg, batch, seed=0):
    """Token ids in [2, vocab) padded with 0 past each length, the
    target shifted right behind the start id 0."""
    rng = np.random.RandomState(seed)
    src_len, trg_len = _lengths(rng, cfg, batch), _lengths(rng, cfg, batch)
    pos = np.arange(cfg.seq)[None, :]
    src = rng.randint(2, cfg.src_vocab, (batch, cfg.seq)) * (
        pos < src_len[:, None])
    trg = rng.randint(2, cfg.trg_vocab, (batch, cfg.seq)) * (
        pos < trg_len[:, None])
    trg_in = np.concatenate([np.zeros((batch, 1), np.int64), trg[:, :-1]],
                            axis=1)
    return {"src": src.astype(np.int64), "src_len": src_len,
            "trg_in": trg_in.astype(np.int64),
            "trg_out": trg.astype(np.int64), "trg_len": trg_len}


def decode_feed(cfg, batch, seed=0):
    """Source sentences and the beam's seed: start id 0 on every row,
    score 0 on each sentence's first beam and -1e9 on the others."""
    rng = np.random.RandomState(seed)
    src_len = _lengths(rng, cfg, batch)
    pos = np.arange(cfg.seq)[None, :]
    src = rng.randint(2, cfg.src_vocab, (batch, cfg.seq)) * (
        pos < src_len[:, None])
    scores = np.full((batch, cfg.beam), -1e9, np.float32)
    scores[:, 0] = 0.0
    return {"src": src.astype(np.int64), "src_len": src_len,
            "init_ids": np.zeros((batch * cfg.beam, 1), np.int64),
            "init_scores": scores.reshape(-1, 1)}
