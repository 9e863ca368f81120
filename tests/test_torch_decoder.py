"""``contrib.decoder`` of the port against the JAX package: the
teacher-forced ``TrainingDecoder``, ``BeamSearchDecoder`` and the
``beam_search`` op's order on ties (ref ``tests/test_decoder.py``).  The
same layer calls build both programs (``tests/_both.py``), with the
weights pinned by name or shape.

- the TrainingDecoder's outputs and two SGD steps' losses within 1e-5
  absolute + 1e-4 relative;
- BeamSearchDecoder: the sentences' ids equal to the reference's and to a
  numpy beam search of the same weights, the scores within 1e-5; the
  data has no near-tie (the top ``beam + 1`` live candidates of every
  sentence at every step more than 1e-3 apart), so equal ids are a fair
  demand;
- the greedy (beam 1) numpy simulation of ``tests/test_decoder.py``;
- ties: frozen beams and equal scores select the lower candidate index
  in both packages, as ``lax.top_k`` does.
"""

import numpy as np

from _both import run_both
from _port_fixtures import collect_garbage_after_module  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
NEG_INF = -1e9


def _decoder(pkg):
    from importlib import import_module
    return import_module(pkg.__name__ + ".contrib.decoder")


def _tanh_updater(pkg, hidden, name):
    def updater(sc):
        x, h = sc.get_input("x"), sc.get_state("h")
        sc.set_state("h", pkg.layers.fc(
            pkg.layers.concat([x, h], axis=1), size=hidden, act="tanh",
            param_attr=pkg.ParamAttr(name=f"{name}_w"),
            bias_attr=pkg.ParamAttr(name=f"{name}_b")))
    return updater


def test_training_decoder_teacher_forced():
    batch, seq, word_dim, hidden = 3, 5, 4, 6
    rng = np.random.RandomState(0)
    feed = {"trg": rng.rand(batch, seq, word_dim).astype(np.float32),
            "boot": rng.randn(batch, hidden).astype(np.float32) * 0.1,
            "sl": np.array([5, 3, 1], np.int64)}

    def build(pkg):
        layers, D = pkg.layers, _decoder(pkg)
        trg = layers.data("trg", shape=[seq, word_dim], dtype="float32")
        boot = layers.data("boot", shape=[hidden], dtype="float32")
        sl = layers.data("sl", shape=[], dtype="int64")
        cell = D.StateCell(inputs={"x": None},
                           states={"h": D.InitState(init=boot)},
                           out_state="h")
        cell.state_updater(_tanh_updater(pkg, hidden, "train_dec"))
        dec = D.TrainingDecoder(cell)
        with dec.block():
            current = dec.step_input(trg, seq_len=sl)
            cell.compute_state(inputs={"x": current})
            cell.update_states()
            dec.output(cell.get_state("h"))
        out = dec()
        loss = layers.reduce_mean(layers.square(out))
        pkg.optimizer.SGD(0.1).minimize(loss)
        return [out, loss], feed

    got = run_both(build, steps=2)
    for r_step, p_step in zip(got["ref"], got["port"]):
        for r, p in zip(r_step, p_step):
            assert r.shape == p.shape
            np.testing.assert_allclose(p, r, **TOL)
    (o1, l1), (_, l2) = got["port"]
    assert o1.shape == (batch, seq, hidden)
    assert float(l2) < float(l1)
    # the third row stopped after one step: its state holds from there
    np.testing.assert_allclose(o1[2, 1:], np.repeat(o1[2, :1], 4, 0))


def _beam_program(beam, vocab, word_dim, hidden, max_len, end_id, bb):
    def build(pkg):
        layers, D = pkg.layers, _decoder(pkg)
        init_ids = layers.data("init_ids", shape=[1], dtype="int64")
        init_scores = layers.data("init_scores", shape=[1],
                                  dtype="float32")
        boot = layers.data("boot", shape=[hidden], dtype="float32")
        cell = D.StateCell(inputs={"x": None},
                           states={"h": D.InitState(init=boot,
                                                    need_reorder=True)},
                           out_state="h")
        cell.state_updater(_tanh_updater(pkg, hidden, "beam_dec"))
        dec = D.BeamSearchDecoder(
            cell, init_ids, init_scores, target_dict_dim=vocab,
            word_dim=word_dim, topk_size=vocab, max_len=max_len,
            beam_size=beam, end_id=end_id)
        dec.decode()
        return list(dec()), None
    return build


def _weights(rng, vocab, word_dim, hidden, scale):
    return {"E": rng.randn(vocab, word_dim).astype(np.float32) * scale,
            "W1": rng.randn(word_dim + hidden, hidden).astype(np.float32)
            * scale,
            "b1": rng.randn(hidden).astype(np.float32) * 0.1,
            "W2": rng.randn(hidden, vocab).astype(np.float32) * scale,
            "b2": rng.randn(vocab).astype(np.float32) * 0.1}


def _pinner(w, vocab, word_dim, hidden):
    """Pin the decoder's parameters by shape (the embedding and the output
    fc have generated names)."""
    def pin(state):
        for n, v in state.items():
            shape = tuple(v.shape)
            if shape == (vocab, word_dim):
                state[n] = w["E"]
            elif shape == (word_dim + hidden, hidden):
                state[n] = w["W1"]
            elif shape == (hidden,) and n.endswith("_b"):
                state[n] = w["b1"]
            elif shape == (hidden, vocab):
                state[n] = w["W2"]
            elif shape == (vocab,):
                state[n] = w["b2"]
    return pin


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _numpy_beam(w, boot, init_scores, beam, max_len, end_id):
    """The decoder's program in numpy float32: (ids [batch, beam, T],
    the smallest gap between consecutive scores among each sentence's top
    beam + 1 live candidates over all steps)."""
    bb, k = boot.shape[0], w["E"].shape[0]
    batch = bb // beam
    ids = np.zeros(bb, np.int64)
    scores = init_scores.reshape(-1).astype(np.float32)
    h = boot
    hist = [(ids, scores, np.zeros(bb, np.int64))]
    gap = np.inf
    for _ in range(max_len):
        x = w["E"][ids]
        h = np.tanh(np.concatenate([x, h], 1) @ w["W1"] + w["b1"])
        p = _softmax(h @ w["W2"] + w["b2"]).astype(np.float32)
        order = np.argsort(-p, axis=1, kind="stable")
        top_p = np.take_along_axis(p, order, 1)
        acc = np.log(top_p) + scores[:, None]
        fin = (ids == end_id)[:, None]
        first = (np.arange(k) == 0)[None, :]
        cand = np.where(fin, np.where(first, scores[:, None], NEG_INF),
                        acc).astype(np.float32).reshape(batch, beam * k)
        cand_id = np.where(fin, end_id, order).reshape(batch, beam * k)
        pick = np.argsort(-cand, axis=1, kind="stable")
        for row, sel in zip(cand, pick):
            live = row[sel[:beam + 1]]
            live = live[live > NEG_INF / 2]
            if len(live) > 1:
                gap = min(gap, float(np.min(-np.diff(live))))
        pick = pick[:, :beam]
        parent = (pick // k + np.arange(batch)[:, None] * beam).reshape(-1)
        ids = np.take_along_axis(cand_id, pick, 1).reshape(-1)
        scores = np.take_along_axis(cand, pick, 1).reshape(-1)
        h = h[parent]
        hist.append((ids, scores, parent))
    slot, toks = np.arange(bb), []
    for ids_t, _, parents_t in reversed(hist):
        toks.append(ids_t[slot])
        slot = parents_t[slot]
    return np.stack(toks[::-1], 1).reshape(batch, beam, -1), gap


def test_beam_search_decoder_matches_reference():
    batch, beam, vocab, word_dim, hidden, max_len, end_id = \
        2, 3, 11, 4, 6, 5, 1
    bb = batch * beam
    rng = np.random.RandomState(11)
    w = _weights(rng, vocab, word_dim, hidden, 1.0)
    init_scores = np.tile(np.array([[0.0]] + [[NEG_INF]] * (beam - 1),
                                   np.float32), (batch, 1))
    feed = {"init_ids": np.zeros((bb, 1), np.int64),
            "init_scores": init_scores,
            "boot": rng.randn(bb, hidden).astype(np.float32)}
    feed["boot"] = np.repeat(feed["boot"][::beam], beam, 0)
    build = _beam_program(beam, vocab, word_dim, hidden, max_len, end_id,
                          bb)
    got = run_both(lambda pkg: (build(pkg)[0], feed),
                   pin=_pinner(w, vocab, word_dim, hidden))
    (r_ids, r_scores), = got["ref"]
    (p_ids, p_scores), = got["port"]
    want, gap = _numpy_beam(w, feed["boot"], init_scores, beam, max_len,
                            end_id)
    assert gap > 1e-3, f"the data has a near-tie ({gap})"
    assert p_ids.shape == (batch, beam, max_len + 1)
    np.testing.assert_array_equal(r_ids, want)
    np.testing.assert_array_equal(p_ids, r_ids)
    np.testing.assert_allclose(p_scores, r_scores, rtol=0, atol=1e-5)
    # a finished hypothesis keeps emitting end_id to the fixed length
    for b, k in zip(*np.where((p_ids == end_id).any(axis=2))):
        row = p_ids[b, k]
        assert np.all(row[int(np.argmax(row == end_id)):] == end_id)


def test_beam_decoder_greedy_matches_numpy():
    """beam 1 against the greedy numpy simulation of
    ``tests/test_decoder.py`` with its pinned weights, in both packages."""
    vocab, word_dim, hidden, max_len = 5, 3, 4, 4
    w = _weights(np.random.RandomState(7), vocab, word_dim, hidden, 0.5)
    feed = {"init_ids": np.zeros((1, 1), np.int64),
            "init_scores": np.zeros((1, 1), np.float32),
            "boot": np.zeros((1, hidden), np.float32)}
    build = _beam_program(1, vocab, word_dim, hidden, max_len, vocab + 7, 1)
    got = run_both(lambda pkg: (build(pkg)[0][:1], feed),
                   pin=_pinner(w, vocab, word_dim, hidden))
    h, prev, want = np.zeros(hidden, np.float32), 0, [0]
    for _ in range(max_len):
        h = np.tanh(np.concatenate([w["E"][prev], h]) @ w["W1"] + w["b1"])
        prev = int(np.argmax(_softmax(h @ w["W2"] + w["b2"])))
        want.append(prev)
    for tag in ("ref", "port"):
        np.testing.assert_array_equal(got[tag][0][0][0, 0], want)


def test_beam_search_ties_pick_the_lower_index():
    """Two sentences of beam 3 over K 4: sentence 0's beam 0 finished (its
    columns 1.. at NEG_INF, tying), sentence 1's candidates tie in pairs.
    Both packages pick the same parents: the lower candidate first."""
    beam, k = 3, 4
    pre_ids = np.array([[1], [5], [6], [2], [3], [4]], np.int64)
    pre_scores = np.array([[-0.5], [-1.0], [-1.0], [0.0], [0.0], [-9.0]],
                          np.float32)
    ids = np.tile(np.arange(10, 10 + k, dtype=np.int64), (6, 1))
    scores = np.array([[-3, -3, -3, -3],
                       [-2, -2, -7, -8],
                       [-2, -2, -7, -8],
                       [-1, -1, -4, -4],
                       [-1, -1, -4, -4],
                       [NEG_INF] * 4], np.float32)
    feed = {"pre_ids": pre_ids, "pre_scores": pre_scores, "ids": ids,
            "scores": scores}

    def build(pkg):
        layers = pkg.layers
        vs = {n: layers.data(n, shape=list(v.shape), dtype=str(v.dtype),
                             append_batch_size=False)
              for n, v in feed.items()}
        out = layers.beam_search(vs["pre_ids"], vs["pre_scores"],
                                 vs["ids"], vs["scores"], beam, end_id=1)
        return list(out), feed
    got = run_both(build)
    for r, p in zip(got["ref"][0], got["port"][0]):
        np.testing.assert_array_equal(p, r)
    sel, sc, parent = got["port"][0]
    # sentence 0: the frozen beam (-0.5) first, then rows 1 and 2's
    # first columns (-2, tied: the lower row and column win)
    np.testing.assert_array_equal(parent[:3], [0, 1, 1])
    np.testing.assert_array_equal(sel[:3, 0], [1, 10, 11])
    np.testing.assert_array_equal(parent[3:], [3, 3, 4])
