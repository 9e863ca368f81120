"""The port's GSPMD partitioner (``paddle_tpu_torch.parallel.
partitioner``) against the JAX package's, on the CPU.

The same programs are built in both packages (fresh name generators, so
every var has the same name): the MLP of the reference's
``test_gspmd.py``, its toy BERT and a toy GPT with ``attn_impl="flash"``.
For each, over dp 2 x mp 2 and dp 2 x mp 4 and every default rule table:
``infer_logical_axes``, ``apply_rules``' stamp (the parameter specs, the
activation constraints, the dims the divisibility guard dropped) and its
warning, ``choose_rules``' per-table report and choice at a loose, a
middle and an impossible budget, and ``partition_fingerprint`` with
``zero_stage`` 0 and 1 equal the reference's.  The flags
``FLAGS_gspmd_mesh`` / ``FLAGS_gspmd_rules`` validate as the reference's;
the choice counter and the per-shard gauge move as its test holds them.
"""

import warnings

import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import transformer as RT
from paddle_tpu.parallel import partitioner as ref_part
from paddle_tpu_torch import flags, monitor
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.parallel import partitioner as part
from paddle_tpu_torch.parallel import (LogicalAxisRules, make_topology_mesh,
                                       mesh_axis_sizes, rule_table)
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CPU = torch.device("cpu")
MESHES = [{"dp": 2, "mp": 2}, {"dp": 2, "mp": 4}]
TABLES = ["replicated", "mp_hidden", "mp_hidden_vocab"]
BATCH = {"mlp": 16, "bert": 8, "gpt": 8}


def _model(root, layers, opt, T_, which, hidden=16):
    if which == "mlp":
        x = layers.data("x", shape=[8], dtype="float32")
        y = layers.data("y", shape=[1], dtype="int64")
        h = layers.fc(x, size=hidden, act="relu", name="gs_fc1")
        pred = layers.fc(h, size=4, act="softmax", name="gs_fc2")
        loss = layers.mean(layers.cross_entropy(pred, y))
        opt.AdamOptimizer(learning_rate=0.01).minimize(loss)
        return loss
    if which == "bert":
        cfg = T_.BertConfig(vocab_size=64, d_model=16, n_layer=2, n_head=4,
                            d_inner=32, max_pos=32, dropout=0.0)
        _, _, loss = T_.build_bert_pretrain(cfg, seq_len=8)
    else:
        cfg = T_.BertConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4,
                            d_inner=64, max_pos=16, dropout=0.0)
        _, _, loss = T_.build_gpt_pretrain(cfg, 16, attn_impl="flash",
                                           fused_head=False, dropout=0.0)
    opt.AdamOptimizer(learning_rate=0.01).minimize(loss)
    return loss


def build(pkg, which, hidden=16):
    """(main, startup, loss name) of ``which`` in ``pkg`` ("ref" or
    "port"), fresh names."""
    if pkg == "ref":
        from paddle_tpu.framework import unique_name
        root, layers, opt, T_ = pt, pt.layers, pt.optimizer, RT
    else:
        from paddle_tpu_torch.framework import unique_name
        root, layers, opt, T_ = ptt, ptt.layers, ptt.optimizer, T
    main, startup = root.Program(), root.Program()
    with unique_name.guard(), root.program_guard(main, startup):
        loss = _model(root, layers, opt, T_, which, hidden)
    return main, startup, loss.name


def _both(which, hidden=16):
    return build("ref", which, hidden), build("port", which, hidden)


def _stamp(stamp):
    return {k: stamp.get(k) for k in ("rules", "rules_token", "mesh_axes",
                                      "params", "activations", "dropped")}


@pytest.mark.parametrize("which", ["mlp", "bert", "gpt"])
def test_infer_logical_axes_equals_reference(which):
    (rm, _, _), (pm, _, _) = _both(which)
    assert part.infer_logical_axes(pm) == ref_part.infer_logical_axes(rm)


@pytest.mark.parametrize("mesh,zero", [(MESHES[0], 0), (MESHES[1], 1)],
                         ids=["dp2mp2-zero0", "dp2mp4-zero1"])
@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("which", ["mlp", "bert", "gpt"])
def test_apply_rules_and_fingerprint_equal_reference(which, table, mesh,
                                                     zero):
    (rm, _, rl), (pm, _, pl) = _both(which)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_part.apply_rules(rm, table, mesh)
        got = part.apply_rules(pm, table, mesh)
    assert _stamp(got) == _stamp(want)
    want["zero_stage"] = got["zero_stage"] = zero
    assert part.partition_fingerprint(got) == \
        ref_part.partition_fingerprint(want)
    for name, spec in got["params"].items():
        assert pm.global_block().var(name).dist_spec == spec


def test_divisibility_drop_warns_like_the_reference():
    """A 6-wide fc under mp 4: the dim stays replicated, recorded in
    ``dropped`` and warned once per fingerprint."""
    (rm, _, _), (pm, _, _) = _both("mlp", hidden=6)
    with part._DROP_WARNED_LOCK:
        part._DROP_WARNED.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = part.apply_rules(pm, "mp_hidden", {"dp": 2, "mp": 4})
        part.apply_rules(pm, "mp_hidden", {"dp": 2, "mp": 4})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_part.apply_rules(rm, "mp_hidden", {"dp": 2, "mp": 4})
    assert got["dropped"] == want["dropped"] and got["dropped"]
    msgs = [str(w.message) for w in caught
            if "shard_divisibility" in str(w.message)]
    assert len(msgs) == 1 and "gs_fc1" in msgs[0], msgs


def _report(rep):
    return [{k: v for k, v in r.items()} for r in rep]


@pytest.mark.parametrize("mesh", MESHES, ids=["dp2mp2", "dp2mp4"])
@pytest.mark.parametrize("which", ["mlp", "bert", "gpt"])
def test_choose_rules_report_equals_reference(which, mesh):
    (rm, _, rl), (pm, _, pl) = _both(which)
    b = BATCH[which]
    got_t, got = part.choose_rules(pm, mesh, fetch_names=[pl],
                                   batch_size=b, budget_mb=None)
    want_t, want = ref_part.choose_rules(rm, mesh, fetch_names=[rl],
                                         batch_size=b, budget_mb=None)
    assert got_t.name == want_t.name
    assert _report(got) == _report(want)
    peaks = {r["rules"]: r["per_shard_peak_bytes"] for r in got}
    for budget in ((peaks["mp_hidden"] + peaks["replicated"]) / 2 / 2**20,
                   1e-6, 100.0):
        gt, gr = part.choose_rules(pm, mesh, fetch_names=[pl],
                                   batch_size=b, budget_mb=budget)
        wt, wr = ref_part.choose_rules(rm, mesh, fetch_names=[rl],
                                       batch_size=b, budget_mb=budget)
        assert gt.name == wt.name and _report(gr) == _report(wr)


def test_partition_program_auto_and_fingerprint():
    (rm, _, rl), (pm, _, pl) = _both("bert")
    mesh = {"dp": 2, "mp": 4}
    got = part.partition_program(pm, mesh, rules="auto", fetch_names=[pl],
                                 batch_size=8, budget_mb=1e-6)
    want = ref_part.partition_program(rm, mesh, rules="auto",
                                      fetch_names=[rl], batch_size=8,
                                      budget_mb=1e-6)
    assert _stamp(got) == _stamp(want)
    assert _report(got["planner"]) == _report(want["planner"])
    assert part.partition_fingerprint(got) == \
        ref_part.partition_fingerprint(want)
    assert part.partition_fingerprint(got).endswith(
        "#rules=" + got["rules"])
    assert part.partition_fingerprint(None) is None


def test_rule_tables_and_topology_mesh():
    assert [t.token() for t in part.DEFAULT_RULE_TABLES] == \
        [t.token() for t in ref_part.DEFAULT_RULE_TABLES]
    assert rule_table("mp_hidden").name == "mp_hidden"
    t = rule_table({"mlp": "mp"})
    assert isinstance(t, LogicalAxisRules) and t.rules == {"mlp": "mp"}
    assert rule_table(t) is t
    with pytest.raises(ValueError, match="unknown rule table"):
        rule_table("bogus")
    mesh = make_topology_mesh({"mp": 4, "dp": 2}, [CPU] * 8)
    assert mesh.axis_names == ("dp", "mp")
    assert mesh_axis_sizes(mesh) == {"dp": 2, "mp": 4}
    with pytest.raises(ValueError, match="devices"):
        make_topology_mesh({"dp": 3, "mp": 5}, [CPU] * 8)


def test_gspmd_flags_validate():
    flags.set_flags({"FLAGS_gspmd_mesh": "dp:2,mp:4"})
    try:
        with pytest.raises(ValueError, match="axis:size"):
            flags.set_flags({"FLAGS_gspmd_mesh": "dp=2"})
        with pytest.raises(ValueError, match="positive"):
            flags.set_flags({"FLAGS_gspmd_mesh": "dp:0"})
        with pytest.raises(ValueError, match="unknown rule table"):
            flags.set_flags({"FLAGS_gspmd_rules": "nonsense"})
        flags.set_flags({"FLAGS_gspmd_rules": "mp_hidden"})
        assert flags.get_flags("FLAGS_gspmd_rules")[
            "FLAGS_gspmd_rules"] == "mp_hidden"
    finally:
        flags.set_flags({"FLAGS_gspmd_mesh": "", "FLAGS_gspmd_rules": "auto"})


def test_choice_counter_and_per_shard_gauge():
    """One tick of ``paddle_tpu_gspmd_rule_choices_total`` a planner run,
    labelled by table and outcome; the gauge holds the chosen table's
    per-shard peak, below the replicated one when a table shards."""
    ctr = monitor.REGISTRY.get("paddle_tpu_gspmd_rule_choices_total")
    gauge = monitor.REGISTRY.get("paddle_tpu_gspmd_per_shard_peak_bytes")
    pm, _, pl = build("port", "mlp")
    mesh = {"dp": 2, "mp": 4}
    before = ctr.value(rules="replicated", outcome="fit")
    _, rep = part.choose_rules(pm, mesh, fetch_names=[pl], batch_size=16,
                               budget_mb=100.0)
    assert ctr.value(rules="replicated", outcome="fit") == before + 1
    peaks = {r["rules"]: r["per_shard_peak_bytes"] for r in rep}
    assert gauge.value() == float(peaks["replicated"])
    fb = ctr.value(rules="mp_hidden_vocab", outcome="fallback")
    part.choose_rules(pm, mesh, fetch_names=[pl], batch_size=16,
                      budget_mb=1e-6)
    assert ctr.value(rules="mp_hidden_vocab", outcome="fallback") == fb + 1
    mid = (peaks["mp_hidden"] + peaks["replicated"]) / 2 / 2**20
    t2, rep2 = part.choose_rules(pm, mesh, fetch_names=[pl],
                                 batch_size=16, budget_mb=mid)
    chosen = next(r for r in rep2 if r["chosen"])
    assert t2.name != "replicated"
    assert gauge.value() == float(chosen["per_shard_peak_bytes"]) < \
        float(peaks["replicated"])
