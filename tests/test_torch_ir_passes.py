"""The IR pass library across packages: each of the 19 registered passes
applied by ``paddle_tpu`` and by the port to the same program.

Every case builds its program with the reference's layers (the cases of
``tests/test_ir.py``), initializes it with the reference's startup program
from a seed, serializes it, and parses it in the port.  Both packages then
apply the same passes, and the test holds:

- the re-serialized programs equal (op types and order, slots, attributes,
  vars with their shapes and dtypes) and the ``*_count`` graph attributes
  equal, at the counts the reference's tests expect;
- for the passes that fold values into the scope (``conv_bn_fuse_pass``,
  the GRU/LSTM gate bias, the pre-multiplied embedding table), the scopes
  after the pass hold the same names and values within 1e-7;
- where the port lowers every op of the rewritten program, both rewritten
  programs run on the same feeds and agree within 1e-5.

Besides: ``registered_passes()`` equal in both packages, ``PassBuilder``,
``apply_passes``, ``Graph.apply_to_program``, and a training run through
``conv_bn_train_fuse_pass`` before ``minimize`` in both packages.
"""

import json
import re

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu import layers as L
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import ir as ref_ir
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu_torch.framework import core, ir, scope, unique_name
from _port_fixtures import collect_garbage_after_module  # noqa: F401

RUN_TOL = dict(rtol=1e-5, atol=1e-5)
FOLD_TOL = dict(rtol=1e-7, atol=1e-7)


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    """Fresh port default programs, scope and names for every test."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


# ---------------------------------------------------------------------------
# the cases: reference programs, their seeds and feeds
# ---------------------------------------------------------------------------

def _fc_mlp(rng):
    x = L.data("x", shape=[4], dtype="float32")
    h = L.fc(x, size=8, act="relu")
    out = L.fc(h, size=3)
    return {"x": rng.rand(5, 4).astype(np.float32)}, [out]


def _fc_multi_consumer(rng):
    x = L.data("x", shape=[4], dtype="float32")
    w = L.create_parameter([4, 3], "float32", name="w_mc")
    b = L.create_parameter([3], "float32", name="b_mc")
    mul_out = L.mul(x, w)
    added = L.elementwise_add(mul_out, b)
    extra = L.scale(mul_out, scale=2.0)
    return {"x": rng.rand(5, 4).astype(np.float32)}, [added, extra]


def _fc_slots(rng):
    xp = L.create_parameter([2, 4], "float32", name="xp_slot")
    y = L.data("yy", shape=[4, 3], dtype="float32", append_batch_size=False)
    b = L.create_parameter([3], "float32", name="b_slot")
    out = L.elementwise_add(L.mul(xp, y), b)
    return {"yy": rng.rand(4, 3).astype(np.float32)}, [out]


def _add_act(rng):
    x = L.data("x", shape=[4], dtype="float32")
    y = L.data("y", shape=[4], dtype="float32")
    r = L.relu(L.elementwise_add(x, y))
    g1 = L.gelu(L.elementwise_add(x, y))
    s1 = L.scale(L.elementwise_add(x, y), scale=2.0, bias=1.0)
    mid = L.elementwise_add(x, y)
    kept = L.relu(mid)
    feed = {"x": rng.randn(3, 4).astype(np.float32),
            "y": rng.randn(3, 4).astype(np.float32)}
    return feed, [r, g1, s1, mid, kept]


def _attention(rng, t=32, bias=None, causal_mask=False, axis=-1,
               cross=False):
    b, h, d, tk = 2, 2, 8, 48
    q = L.data("q", shape=[h, t, d], dtype="float32")
    k = L.data("k", shape=[h, t, d], dtype="float32")
    v = L.data("v", shape=[h, t, d], dtype="float32")
    feed = {n: rng.randn(b, h, t, d).astype(np.float32) * 0.3
            for n in ("q", "k", "v")}
    scores = L.matmul(q, k, transpose_y=True, alpha=0.25)
    if causal_mask:
        from paddle_tpu import initializer
        mask_np = np.triu(np.full((t, t), -1e9, np.float32), k=1)
        mask = L.create_parameter(
            [t, t], "float32", name="causal_mask",
            default_initializer=initializer.NumpyArrayInitializer(mask_np))
        mask.stop_gradient = True
        scores = scores + mask
    if bias:
        bv = L.data("bias", shape=[h, t, t], dtype="float32")
        feed["bias"] = rng.randn(b, h, t, t).astype(np.float32) * 0.1
        scores = scores + bv
    out = L.matmul(L.softmax(scores, axis=axis), v)
    if cross:
        ek = L.data("enc_k", shape=[h, tk, d], dtype="float32")
        ev = L.data("enc_v", shape=[h, tk, d], dtype="float32")
        feed["enc_k"] = rng.randn(b, h, tk, d).astype(np.float32) * 0.3
        feed["enc_v"] = rng.randn(b, h, tk, d).astype(np.float32) * 0.3
        s2 = L.matmul(out, ek, transpose_y=True, alpha=0.25)
        out = L.matmul(L.softmax(s2), ev)
    return feed, [L.scale(out, scale=1.0)]


def _conv_bn(rng):
    img = L.data("img", shape=[3, 8, 8], dtype="float32")
    conv = L.conv2d(img, num_filters=4, filter_size=3, bias_attr=False)
    out = L.batch_norm(conv, is_test=True)
    return {"img": rng.rand(2, 3, 8, 8).astype(np.float32)}, [out]


def _conv_act(rng):
    img = L.data("img", shape=[3, 8, 8], dtype="float32")
    out = L.conv2d(img, num_filters=4, filter_size=3, act="relu")
    return {"img": rng.randn(2, 3, 8, 8).astype(np.float32)}, [out]


def _bottlenecks(rng):
    from paddle_tpu.models.resnet import bottleneck_block
    img = L.data("img", shape=[8, 8, 8], dtype="float32")
    label = L.data("label", shape=[1], dtype="int64")
    h = bottleneck_block(img, 4, 1, "bb0")
    h = bottleneck_block(h, 4, 2, "bb1")
    pred = L.fc(L.flatten(L.pool2d(h, pool_type="avg", global_pooling=True)),
                size=4, act="softmax")
    loss = L.mean(L.cross_entropy(pred, label))
    feed = {"img": rng.rand(2, 8, 8, 8).astype(np.float32),
            "label": rng.randint(0, 4, (2, 1)).astype(np.int64)}
    return feed, [loss]


def _fc_chain(rng):
    x = L.data("x", shape=[8], dtype="float32")
    h = x
    for _ in range(3):
        h = L.fc(h, size=8, act="relu")
    return {"x": rng.rand(4, 8).astype(np.float32)}, [L.scale(h, scale=1.0)]


def _squared_mat_sub(rng):
    a = L.data("a", shape=[4], dtype="float32")
    b = L.data("b", shape=[4, 6], dtype="float32", append_batch_size=False)
    xy = L.matmul(a, b)
    out = L.scale(L.square(xy) - L.matmul(L.square(a), L.square(b)),
                  scale=0.5)
    feed = {"a": rng.rand(3, 4).astype(np.float32),
            "b": rng.rand(4, 6).astype(np.float32)}
    return feed, [L.scale(out, scale=1.0)]


def _transpose_flatten_concat(rng):
    u = L.data("u", shape=[2, 3, 4], dtype="float32")
    v = L.data("v", shape=[2, 5, 4], dtype="float32")
    flat = [L.flatten(L.transpose(t, perm=[0, 2, 3, 1])) for t in (u, v)]
    out = L.concat(flat, axis=1)
    feed = {"u": rng.rand(2, 2, 3, 4).astype(np.float32),
            "v": rng.rand(2, 2, 5, 4).astype(np.float32)}
    return feed, [L.scale(out, scale=1.0)]


def _seqpool_concat(rng):
    u = L.data("u", shape=[5, 3], dtype="float32")
    v = L.data("v", shape=[7, 3], dtype="float32")
    out = L.concat([L.sequence_pool(t, pool_type="sum") for t in (u, v)],
                   axis=1)
    return {}, [L.scale(out, scale=1.0)]


def _fc_gru_lstm(rng):
    from paddle_tpu.layers import compat as rnn_layers
    x = L.data("x", shape=[5, 6], dtype="float32")
    h = 4
    hidden_g = rnn_layers.dynamic_gru(
        L.fc(x, size=3 * h, num_flatten_dims=2), size=h)
    hidden_l, _ = rnn_layers.dynamic_lstm(
        L.fc(x, size=4 * h, num_flatten_dims=2), size=4 * h,
        use_peepholes=True)
    return {}, [L.concat([hidden_g, hidden_l], axis=2)]


def _embedding_fc_lstm(rng):
    from paddle_tpu.layers import compat as rnn_layers
    ids = L.data("ids", shape=[5, 1], dtype="int64")
    emb = L.embedding(ids, size=[11, 6])
    hidden, _ = rnn_layers.dynamic_lstm(
        L.fc(emb, size=12, num_flatten_dims=2), size=12,
        use_peepholes=False)
    return {}, [hidden]


def _seqconv(rng):
    from paddle_tpu.layers import sequence as seq_layers
    x = L.data("x", shape=[7, 5], dtype="float32")
    return {}, [seq_layers.sequence_conv(x, num_filters=6, filter_size=3,
                                         act="relu")]


def _dead_op(rng):
    x = L.data("x", shape=[4], dtype="float32")
    out = L.fc(x, size=3, act="relu")
    L.scale(L.relu(x), scale=3.0)          # nothing reads it
    return {"x": rng.rand(2, 4).astype(np.float32)}, [out]


# (id, builder, for_test, [(pass, attrs)], expected counts, runnable)
# attrs may hold "scope" (each package passes its own) and "protected"
# (the fetch names)
CASES = [
    ("fc_fuse", _fc_mlp, False, [("fc_fuse_pass", {})],
     {"fc_fuse_count": 2}, True),
    ("fc_fuse_multi_consumer", _fc_multi_consumer, False,
     [("fc_fuse_pass", {})], {"fc_fuse_count": 0}, True),
    ("fc_fuse_slots_not_roles", _fc_slots, False, [("fc_fuse_pass", {})],
     {"fc_fuse_count": 0}, True),
    ("fuse_elewise_add_act", _add_act, False,
     [("fuse_elewise_add_act_pass", {"protected": True})],
     {"fuse_elewise_add_act_count": 3}, True),
    ("attention_fuse", _attention, False,
     [("attention_fuse_pass", {"min_seq_len": 16})],
     {"attention_fuse_count": 1}, True),
    ("attention_fuse_below_crossover", _attention, False,
     [("attention_fuse_pass", {"min_seq_len": 1024})],
     {"attention_fuse_count": 0}, True),
    ("attention_fuse_causal_and_cross",
     lambda rng: _attention(rng, causal_mask=True, cross=True), False,
     [("attention_fuse_pass", {"min_seq_len": 16, "scope": True})],
     {"attention_fuse_count": 2}, True),
    ("attention_fuse_bias", lambda rng: _attention(rng, bias=True), False,
     [("attention_fuse_pass", {"min_seq_len": 16, "scope": True})],
     {"attention_fuse_count": 1}, True),
    ("attention_fuse_softmax_axis", lambda rng: _attention(rng, axis=2),
     False, [("attention_fuse_pass", {"min_seq_len": 16})],
     {"attention_fuse_count": 0}, True),
    ("conv_bn_fuse", _conv_bn, True,
     [("conv_bn_fuse_pass", {"scope": True})], {"conv_bn_fuse_count": 1},
     True),
    ("conv_elementwise_add_act_fuse", _conv_act, True,
     [("conv_elementwise_add_act_fuse_pass", {})],
     {"conv_elementwise_add_act_fuse_count": 1}, True),
    ("conv_bn_train_fuse", _bottlenecks, False,
     [("conv_bn_train_fuse_pass", {})], {"conv_bn_train_fuse_count": 6},
     True),
    ("repeated_fc_relu_fuse", _fc_chain, False,
     [("fc_fuse_pass", {}), ("repeated_fc_relu_fuse_pass", {})],
     {"fc_fuse_count": 3, "repeated_fc_relu_fuse_count": 1}, True),
    ("squared_mat_sub_fuse", _squared_mat_sub, False,
     [("squared_mat_sub_fuse_pass", {})],
     {"squared_mat_sub_fuse_count": 1}, True),
    ("transpose_flatten_concat_fuse", _transpose_flatten_concat, False,
     [("transpose_flatten_concat_fuse_pass", {})],
     {"transpose_flatten_concat_fuse_count": 1}, True),
    ("seqpool_concat_fuse", _seqpool_concat, False,
     [("seqpool_concat_fuse_pass", {})],
     {"seqpool_concat_fuse_count": 1}, False),
    ("fc_gru_lstm_fuse", _fc_gru_lstm, True,
     [("fc_fuse_pass", {}), ("fc_gru_fuse_pass", {"scope": True}),
      ("fc_lstm_fuse_pass", {"scope": True})],
     {"fc_fuse_count": 2, "fc_gru_fuse_count": 1, "fc_lstm_fuse_count": 1},
     False),
    ("embedding_fc_lstm_fuse", _embedding_fc_lstm, True,
     [("fc_fuse_pass", {}),
      ("embedding_fc_lstm_fuse_pass", {"scope": True})],
     {"fc_fuse_count": 1, "embedding_fc_lstm_fuse_count": 1}, False),
    ("seqconv_eltadd_relu_fuse", _seqconv, True,
     [("seqconv_eltadd_relu_fuse_pass", {})],
     {"seqconv_eltadd_relu_fuse_count": 1}, False),
    ("dead_op_eliminate", _dead_op, False,
     [("dead_op_eliminate", {"protected": True})],
     {"dead_op_eliminate_count": 2}, True),
    ("graph_to_program", _fc_mlp, False,
     [("fc_fuse_pass", {}), ("graph_to_program_pass", {})],
     {"fc_fuse_count": 2}, True),
]


def _build(builder, for_test, seed=3):
    """The reference program, its fetch names, feeds and the values its
    startup program sets (numpy)."""
    main, startup = RefProgram(), RefProgram()
    with ref_guard(main, startup):
        feed, fetch = builder(np.random.RandomState(seed))
    ref_scope = RefScope()
    RefExecutor().run(startup, scope=ref_scope, seed=seed)
    values = {n: np.asarray(v) for n, v in ref_scope.items()
              if v is not None}
    prog = main.clone(for_test=True) if for_test else main
    return prog, [v.name for v in fetch], feed, values


def _scopes(values):
    ref_scope = RefScope()
    for n, v in values.items():
        ref_scope.set_var(n, np.array(v))
    return ref_scope, ptt.io.params_from_numpy(ptt.Scope(), values)


def _blocks(program):
    return json.loads(json.dumps(program.to_dict()["blocks"]))


def _counts(graph):
    return {k: v for k, v in graph.attrs.items() if k.endswith("_count")}


def _apply(pkg_ir, program, passes, scope, fetch):
    g = pkg_ir.Graph(program)
    for name, attrs in passes:
        kw = dict(attrs)
        if kw.get("scope"):
            kw["scope"] = scope
        if kw.get("protected"):
            kw["protected"] = frozenset(fetch)
        g = pkg_ir.get_pass(name, **kw).apply(g)
    return g


def _scope_values(s):
    out = {}
    for n, v in s.items():
        if v is None:
            continue
        out[n] = v.detach().cpu().numpy() if hasattr(v, "detach") \
            else np.asarray(v)
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pass_rewrites_like_the_reference(case):
    _, builder, for_test, passes, counts, runnable = case
    prog, fetch, feed, values = _build(builder, for_test)
    port_prog = core.Program.parse_from_string(prog.serialize_to_string())
    assert _blocks(port_prog) == _blocks(prog)
    ref_scope, port_scope = _scopes(values)
    rg = _apply(ref_ir, prog, passes, ref_scope, fetch)
    pg = _apply(ir, port_prog, passes, port_scope, fetch)
    assert _counts(pg) == _counts(rg)
    assert {k: _counts(pg)[k] for k in counts} == counts
    ref_out, port_out = rg.to_program(), pg.to_program()
    assert _blocks(port_out) == _blocks(ref_out)
    if "graph_to_program_pass" in dict(passes):
        assert _blocks(pg.attrs["program"]) == _blocks(ref_out)
    if any(a.get("scope") for _, a in passes):
        rv, pv = _scope_values(ref_scope), _scope_values(port_scope)
        assert sorted(pv) == sorted(rv)
        for n in rv:
            np.testing.assert_allclose(pv[n], rv[n], err_msg=n, **FOLD_TOL)
    if not runnable:
        with pytest.raises(RuntimeError, match="has no registered lowering"):
            ptt.Executor(ptt.CPUPlace()).run(port_out, fetch_list=fetch,
                                             scope=port_scope)
        return
    want = RefExecutor().run(ref_out, feed=feed, fetch_list=fetch,
                             scope=ref_scope)
    got = ptt.Executor(ptt.CPUPlace()).run(port_out, feed=feed,
                                           fetch_list=fetch,
                                           scope=port_scope)
    for n, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=n, **RUN_TOL)


def test_memory_passes_give_the_reference_tables():
    prog, fetch, _, _ = _build(_fc_mlp, False)
    port_prog = core.Program.parse_from_string(prog.serialize_to_string())
    rg = ref_ir.get_pass("buffer_shared_inplace_pass").apply(
        ref_ir.Graph(prog))
    pg = ir.get_pass("buffer_shared_inplace_pass").apply(ir.Graph(port_prog))
    assert pg.attrs["last_use"] == rg.attrs["last_use"]
    assert pg.attrs["inplace_pairs"] == rg.attrs["inplace_pairs"]
    assert pg.attrs["inplace_pairs"]


def test_graph_viz_pass_draws_the_reference_graph(tmp_path):
    prog, _, _, _ = _build(_fc_mlp, False)
    port_prog = core.Program.parse_from_string(prog.serialize_to_string())
    path = str(tmp_path / "g.dot")
    rg = ref_ir.get_pass("graph_viz_pass", highlights=["x"]).apply(
        ref_ir.Graph(prog))
    pg = ir.get_pass("graph_viz_pass", highlights=["x"],
                     graph_viz_path=path).apply(ir.Graph(port_prog))

    def by_order(dot):
        """Node ids numbered by first appearance (the two packages count
        nodes from different offsets)."""
        ids = {}
        return re.sub(r"n(\d+)", lambda m: "n%d" % ids.setdefault(
            m.group(1), len(ids)), dot)

    assert by_order(pg.attrs["graph_viz_dot"]) == \
        by_order(rg.attrs["graph_viz_dot"])
    with open(path) as f:
        assert f.read() == pg.attrs["graph_viz_dot"]
    assert 'label="mul" shape=box' in pg.attrs["graph_viz_dot"]


def test_registered_passes_match_the_reference():
    assert ir.registered_passes() == ref_ir.registered_passes()
    assert len(ir.registered_passes()) == 19


def test_pass_builder_and_apply_passes():
    prog, fetch, feed, values = _build(_fc_chain, False)
    port_prog = core.Program.parse_from_string(prog.serialize_to_string())
    pb = ir.PassBuilder(["fc_fuse_pass"])
    pb.append_pass("graph_to_program_pass")
    pb.insert_pass(1, "repeated_fc_relu_fuse_pass")
    pb.append_pass("graph_viz_pass")
    pb.remove_pass(3)
    assert [p.name for p in pb.all_passes()] == [
        "fc_fuse_pass", "repeated_fc_relu_fuse_pass",
        "graph_to_program_pass"]
    assert pb.all_passes()[0].set("protected", fetch).get(
        "protected") == fetch
    g = pb.apply(ir.Graph(port_prog))
    types = [op.type for op in g.attrs["program"].global_block().ops]
    assert types.count("fusion_repeated_fc_relu") == 1 and "fc" not in types
    names = ["fc_fuse_pass", "repeated_fc_relu_fuse_pass"]
    got = ir.apply_passes(port_prog, names, protected=fetch)
    want = ref_ir.apply_passes(prog, names, protected=fetch)
    assert _blocks(got) == _blocks(want)
    assert _blocks(port_prog) == _blocks(prog)     # the source unchanged
    _, port_scope = _scopes(values)
    out, = ptt.Executor(ptt.CPUPlace()).run(got, feed=feed, fetch_list=fetch,
                                            scope=port_scope)
    ref, = RefExecutor().run(want, feed=feed, fetch_list=fetch,
                             scope=_scopes(values)[0])
    np.testing.assert_allclose(out, np.asarray(ref), **RUN_TOL)
    with pytest.raises(KeyError, match="no pass registered"):
        ir.get_pass("no_such_pass")
    with pytest.raises(ValueError, match="needs scope="):
        ir.apply_passes(port_prog, ["conv_bn_fuse_pass"])


def test_conv_bn_train_pass_before_minimize_trains_like_the_reference():
    """``conv_bn_train_fuse_pass`` written back into the program
    (``Graph.apply_to_program``) before ``minimize``, as the reference's
    test does: 6 fused pairs, and 2 Momentum steps with losses within
    1e-5 of the reference's."""
    from paddle_tpu import optimizer as ref_opt
    from paddle_tpu_torch import layers as PL
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import resnet

    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(2, 8, 8, 8).astype(np.float32),
            "label": rng.randint(0, 4, (2, 1)).astype(np.int64)}

    def losses(pkg_ir, exe, layers_mod, bottleneck, opt_mod, prog_cls,
               guard, scope_cls):
        main, startup = prog_cls(), prog_cls()
        with guard(main, startup):
            img = layers_mod.data("img", shape=[8, 8, 8], dtype="float32")
            label = layers_mod.data("label", shape=[1], dtype="int64")
            h = bottleneck(img, 4, 1, "bb0")
            h = bottleneck(h, 4, 2, "bb1")
            pred = layers_mod.fc(layers_mod.pool2d(
                h, pool_type="avg", global_pooling=True), size=4,
                act="softmax", param_attr="fc_out.w", bias_attr="fc_out.b")
            loss = layers_mod.mean(layers_mod.cross_entropy(pred, label))
            g = pkg_ir.get_pass("conv_bn_train_fuse_pass").apply(
                pkg_ir.Graph(main))
            assert g.attrs["conv_bn_train_fuse_count"] == 6
            g.apply_to_program()
            opt_mod.MomentumOptimizer(0.1, 0.9).minimize(loss)
        types = [op.type for op in main.global_block().ops]
        assert types.count("fused_conv1x1_bn") == 6
        s = scope_cls()
        exe.run(startup, scope=s, seed=3)
        return main, loss, s

    from paddle_tpu.models.resnet import bottleneck_block as ref_bb
    rmain, rloss, rscope = losses(ref_ir, RefExecutor(), L, ref_bb, ref_opt,
                                  RefProgram, ref_guard, RefScope)
    pexe = ptt.Executor(ptt.CPUPlace())
    pmain, ploss, pscope = losses(ir, pexe, PL, resnet.bottleneck_block,
                                  optimizer, core.Program,
                                  core.program_guard, ptt.Scope)
    # the same starting weights in both
    ptt.io.params_from_numpy(pscope, {n: np.asarray(v)
                                      for n, v in rscope.items()
                                      if v is not None})
    for _ in range(2):
        want, = RefExecutor().run(rmain, feed=feed, fetch_list=[rloss.name],
                                  scope=rscope)
        got, = pexe.run(pmain, feed=feed, fetch_list=[ploss.name],
                        scope=pscope)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
