"""The seq2seq path of the port against the JAX package: the model of
``tests/_seq2seq.py`` (the ``rnn_search`` recipe's structure) at 2
layers, hidden 32, vocabularies of 50, length 8, batch 4 and beam 3,
built by the same builder in both packages, the port's scope taking the
reference's startup values by name.

- three Adam steps (clipped by global norm) with dropout 0.2 between the
  encoder's layers, both packages' dropouts drawing the same bits
  (``patch_same_bits``): each step's loss and, after the three, every
  parameter and Adam moment within 1e-5 absolute + 1e-4 relative;
- the decode program after ``save_inference_model`` /
  ``load_inference_model`` in each package: the sentences' ids equal, the
  scores within 1e-5;
- the training program's op types, sub-blocks included, are the
  reference's, and each of them is registered in the port;
- the shape rules give the two programs the shapes and dtypes of the
  lowerings' meta runs, and a fresh process builds both at the recipe's
  full width without importing ``torch._dynamo`` (its own 120 s
  deadline).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from _both import PKGS, executor, startup_state
from _port_fixtures import collect_garbage_after_module  # noqa: F401
from _port_fixtures import patch_same_bits
import _seq2seq as S

CFG = S.Seq2SeqConfig(num_layers=2, hidden=32, src_vocab=50, trg_vocab=50,
                      seq=8, min_len=3, beam=3, max_len=8)
BATCH, STEPS = 4, 3
TOL = dict(rtol=1e-4, atol=1e-5)


def _op_types(program):
    return sorted({op.type for b in program.blocks for op in b.ops})


def test_training_matches_reference(monkeypatch):
    feeds = [S.train_feed(CFG, BATCH, seed=s) for s in range(STEPS)]
    runs, carried = {}, None
    for tag, pkg, fw in PKGS:
        main, startup, loss = S.build_train(pkg, CFG, dropout=0.2)
        scope, exe = fw.Scope(), executor(pkg)
        exe.run(startup, scope=scope)
        if carried is None:
            carried = startup_state(startup, scope)
        for n, v in carried.items():
            scope.set_var(n, v)
        runs[tag] = (main, startup, loss, scope, exe)
    # the startups drew their own way; the steps' dropouts draw alike
    patch_same_bits(monkeypatch)
    losses, state, types = {}, {}, {}
    for tag, (main, startup, loss, scope, exe) in runs.items():
        types[tag] = _op_types(main)
        losses[tag] = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[loss], scope=scope)[0]))
            for f in feeds]
        state[tag] = startup_state(startup, scope)
    assert types["port"] == types["ref"]
    assert {"while", "static_scan", "static_scan_grad", "dropout"} & set(
        types["port"]) == {"static_scan", "static_scan_grad", "dropout"}
    np.testing.assert_allclose(losses["port"], losses["ref"], **TOL)
    assert losses["port"][-1] < losses["port"][0]
    assert sorted(state["port"]) == sorted(state["ref"])
    assert len(state["port"]) > 20
    for n, r in state["ref"].items():
        np.testing.assert_allclose(state["port"][n], r, err_msg=n, **TOL)


def test_decode_after_save_and_load_matches_reference(tmp_path):
    feed = S.decode_feed(CFG, BATCH, seed=5)
    out, carried = {}, None
    for tag, pkg, fw in PKGS:
        main, startup, feed_names, fetch = S.build_decode(pkg, CFG, BATCH)
        scope, exe = fw.Scope(), executor(pkg)
        exe.run(startup, scope=scope)
        if carried is None:
            carried = startup_state(startup, scope)
        for n, v in carried.items():
            scope.set_var(n, v)
        d = str(tmp_path / tag)
        pkg.io.save_inference_model(d, feed_names, fetch, exe,
                                    main_program=main, scope=scope)
        loaded = fw.Scope()
        prog, names, fetch_names = pkg.io.load_inference_model(
            d, exe, scope=loaded)
        assert sorted(names) == sorted(feed_names)
        assert any(op.type == "while" for op in prog.global_block().ops)
        out[tag] = [np.asarray(v) for v in exe.run(
            prog, feed={n: feed[n] for n in names},
            fetch_list=fetch_names, scope=loaded)]
    (r_ids, r_scores), (p_ids, p_scores) = out["ref"], out["port"]
    assert p_ids.shape == (BATCH, CFG.beam, CFG.max_len + 1)
    np.testing.assert_array_equal(p_ids, r_ids)
    np.testing.assert_allclose(p_scores, r_scores, rtol=0, atol=1e-5)
    assert (p_ids[:, :, 1:] > 0).any()


def test_every_op_type_of_the_path_is_registered():
    from paddle_tpu_torch.framework import registry
    have = set(registry.registered_ops())
    types = set()
    for build in (lambda pkg: S.build_train(pkg, CFG, dropout=0.2)[:2],
                  lambda pkg: S.build_decode(pkg, CFG, BATCH)[:2]):
        for p in build(pt):
            types.update(_op_types(p))
        ported = set()
        for p in build(ptt):
            ported.update(_op_types(p))
        assert ported <= types
    missing = {t for t in types if t not in have and not (
        t.endswith("_grad") and t[:-len("_grad")] in have)}
    assert not missing, missing


def _var_shapes(progs):
    return {(i, b.idx, v.name): (v.shape, v.dtype)
            for i, p in enumerate(progs) for b in p.blocks
            for v in b.vars.values()}


def test_rules_give_the_meta_inference(monkeypatch):
    from paddle_tpu_torch.framework import registry
    from paddle_tpu_torch.ops import shape_rules

    def build():
        return list(S.build_train(ptt, CFG, dropout=0.2)[:2]) + list(
            S.build_decode(ptt, CFG, BATCH)[:2])
    with_rules = _var_shapes(build())
    for t in shape_rules.RULES:
        monkeypatch.setattr(registry.get_op_info(t), "shape", None)
    on_meta = _var_shapes(build())
    assert len(with_rules) > 300
    assert with_rules == on_meta


_FRESH = textwrap.dedent("""
    import sys
    sys.path.insert(0, "tests")
    import paddle_tpu_torch as ptt
    import _seq2seq as S
    cfg = S.Seq2SeqConfig()
    progs = list(S.build_train(ptt, cfg)[:2]) + list(
        S.build_decode(ptt, cfg, 16)[:2])
    n = sum(len(b.ops) for p in progs for b in p.blocks)
    print("ops", n, "dynamo", "torch._dynamo" in sys.modules)
""")


def test_building_imports_no_dynamo():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FRESH], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr[-3000:]
    words = out.stdout.split()
    assert words[-1] == "False", out.stdout
    assert int(words[1]) > 200
