"""The port's static sharding analysis (``paddle_tpu_torch.analysis.
sharding``) and its consumers against the JAX package's, on the CPU.

- ``plan_sharding`` of the MLP, the toy BERT and the toy flash GPT
  (``test_torch_partitioner``'s programs) under every default table, over
  dp 2 x mp 2 and dp 2 x mp 4, ZeRO 0 and 1: the edges (kind, axis, var,
  reason, direction, payload, wire bytes, exactness, op), the propagated
  specs, the diagnostics and ``resh_token`` equal the reference's;
- the three checks trip and near-miss as the reference's
  ``test_sharding_analysis.py:106-245`` holds them: ``mesh_axis_overuse``
  under a table mapping two logical axes of one weight onto ``mp``,
  ``spec_conflict`` (an error for two axes on one contraction, a warning
  and a priced gather for a one-sided one), ``shard_divisibility``;
- the verifier stamps the plan, folds ``#resh=`` before ``#rules=`` into
  the collective fingerprint, and refuses a conflicting table at optimize
  time with no dispatch;
- ``choose_rules``' rows are priced by the plan, ``runtime_comms_plan`` is
  None for an unpartitioned program;
- ``check_decode_hostable`` and ``DecodeEngine(program=...)``: an
  mp-sharded program raises naming its specs, a dp-only one hosts.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.analysis import sharding as ref_sharding
from paddle_tpu.analysis import verifier as ref_verifier
from paddle_tpu.parallel import partitioner as ref_part
from paddle_tpu_torch import monitor
from paddle_tpu_torch.analysis import ProgramVerificationError
from paddle_tpu_torch.analysis import sharding, verifier
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.parallel import partitioner as part
from test_torch_partitioner import BATCH, MESHES, TABLES, _both, build
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CPU = torch.device("cpu")
MESH = {"dp": 2, "mp": 2}
BAD_RULES = {"embed": "mp", "mlp": "mp", "batch": "dp"}


def _edges(plan):
    return [(e.var, e.kind, e.mesh_axis, e.nranks, e.payload_bytes,
             e.wire_bytes, e.reason, e.exact, e.direction, e.op_type,
             e.op_index, e.src_spec, e.dst_spec, e.dtype, e.shape)
            for e in plan.edges]


def _diags(plan):
    """The findings (the port words the overuse message for its own
    lowering, so the message is left out)."""
    return [(d.check, d.severity, d.var, d.op_index, d.fix_hint)
            for d in plan.diagnostics]


def _partitioned(which, table, mesh, zero):
    (rm, _, rl), (pm, _, pl) = _both(which)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for p, m in ((part, pm), (ref_part, rm)):
            st = p.partition_program(m, mesh, rules=table)
            st["zero_stage"] = zero
    return (rm, rl), (pm, pl)


@pytest.mark.parametrize("mesh,zero", [(MESHES[0], 0), (MESHES[0], 1),
                                       (MESHES[1], 1)],
                         ids=["dp2mp2-zero0", "dp2mp2-zero1", "dp2mp4-zero1"])
@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("which", ["mlp", "bert", "gpt"])
def test_plan_sharding_equals_reference(which, table, mesh, zero):
    (rm, rl), (pm, pl) = _partitioned(which, table, mesh, zero)
    b = BATCH[which]
    got = sharding.plan_sharding(pm, [pl], batch_size=b)
    want = ref_sharding.plan_sharding(rm, [rl], batch_size=b)
    assert _edges(got) == _edges(want)
    assert got.resh_token == want.resh_token
    assert got.specs == want.specs
    assert _diags(got) == _diags(want)
    assert (got.payload_bytes, got.wire_bytes) == \
        (want.payload_bytes, want.wire_bytes)
    assert sharding.stamp_attrs(got) == ref_sharding.stamp_attrs(want)
    assert not got.unexplained
    # the reshard token folds into the verifier's fingerprint
    fp = verifier.collective_fingerprint(pm)
    assert fp == ref_verifier.collective_fingerprint(rm)
    assert fp.index("#resh=") < fp.index("#rules=")
    assert pm._attrs["verify"]["sharding"]["resh_token"] == \
        sharding.plan_sharding(pm, [], batch_size=1).resh_token


def test_plan_is_none_unpartitioned_and_cached():
    (rm, _, rl), (pm, _, pl) = _both("mlp")
    assert sharding.plan_sharding(pm, [pl], batch_size=16) is None
    assert sharding.runtime_comms_plan(pm, [pl], batch_size=16) is None
    part.partition_program(pm, MESH, rules="mp_hidden")
    p1 = sharding.plan_sharding(pm, [pl], batch_size=16)
    assert sharding.plan_sharding(pm, [pl], batch_size=16) is p1
    cp = sharding.runtime_comms_plan(pm, [pl], batch_size=16)
    assert cp.payload_bytes == p1.payload_bytes
    assert [c.op for c in cp.collectives] == \
        [e.collective_op for e in p1.edges]
    gauge = monitor.REGISTRY.get("paddle_tpu_gspmd_reshard_bytes")
    sharding.clear_cache()
    p2 = sharding.plan_sharding(pm, [pl], batch_size=16)
    assert p2 is not p1 and gauge.value() == float(p2.payload_bytes)


def _adhoc(specs, rules):
    (rm, _, rl), (pm, _, pl) = _both("mlp")
    blk = pm.global_block()

    def name(sub):
        return next(n for n in blk.vars if sub in n)
    specs = {name(k) if k.startswith("gs_") else k: v
             for k, v in specs.items()}
    got = sharding.plan_sharding(pm, [pl], batch_size=16, specs=specs,
                                 axis_sizes=MESH, rules=rules)
    want = ref_sharding.plan_sharding(rm, [rl], batch_size=16, specs=specs,
                                      axis_sizes=MESH, rules=rules)
    assert _edges(got) == _edges(want) and _diags(got) == _diags(want)
    return got


def test_mesh_axis_overuse_trips_and_near_misses():
    (rm, _, rl), (pm, _, pl) = _both("mlp")
    for p, m in ((part, pm), (ref_part, rm)):
        p.partition_program(m, MESH, rules=BAD_RULES)
    got = sharding.plan_sharding(pm, [pl], batch_size=16)
    want = ref_sharding.plan_sharding(rm, [rl], batch_size=16)
    assert _diags(got) == _diags(want)
    errs = [d for d in got.diagnostics
            if d.check == "mesh_axis_overuse" and d.severity == "error"]
    assert errs and "mp" in errs[0].message
    for rules in ("replicated", "mp_hidden"):
        (_, _, _), (pm2, _, pl2) = _both("mlp")
        part.partition_program(pm2, MESH, rules=rules)
        plan = sharding.plan_sharding(pm2, [pl2], batch_size=16)
        assert not [d for d in plan.diagnostics if d.severity == "error"]


def test_spec_conflict_trips_and_near_misses():
    pm, _, _ = build("port", "mlp")
    blk = pm.global_block()
    w2 = next(n for n in blk.vars if "gs_fc2.w" in n)
    mm2 = next(op for op in blk.ops if op.type == "mul"
               and w2 in op.inputs["Y"])
    act = mm2.inputs["X"][0]
    trip = _adhoc({"gs_fc1.w": (None, "mp"), act: (None, "mp"),
                   "gs_fc2.w": ("dp", None)}, "adhoc_conflict")
    assert [d for d in trip.diagnostics
            if d.check == "spec_conflict" and d.severity == "error"]
    near = _adhoc({"gs_fc1.w": ("mp", None)}, "adhoc_onesided")
    assert not [d for d in near.diagnostics if d.severity == "error"]
    assert [d for d in near.diagnostics if d.check == "spec_conflict"]
    assert any(e.kind == "all_gather" and e.reason == "spec_mismatch"
               for e in near.edges)


def test_shard_divisibility_warns_and_near_misses():
    (rm, _, rl), (pm, _, pl) = _both("mlp", hidden=6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for p, m in ((part, pm), (ref_part, rm)):
            p.partition_program(m, {"dp": 2, "mp": 4}, rules="mp_hidden")
    got = sharding.plan_sharding(pm, [pl], batch_size=16)
    want = ref_sharding.plan_sharding(rm, [rl], batch_size=16)
    divs = [d for d in got.diagnostics if d.check == "shard_divisibility"]
    assert divs and all(d.severity == "warning" for d in divs)
    assert _diags(got) == _diags(want)
    (_, _, _), (pm2, _, pl2) = _both("mlp")
    st = part.partition_program(pm2, MESH, rules="mp_hidden")
    assert not st["dropped"]
    assert not [d for d in sharding.plan_sharding(
        pm2, [pl2], batch_size=16).diagnostics
        if d.check == "shard_divisibility"]


def test_optimize_refuses_conflicting_table_zero_dispatches():
    main, startup, loss = build("port", "mlp")
    exe = ptt.Executor(ptt.CPUPlace())
    sc = ptt.framework.Scope()
    exe.run(startup, scope=sc, seed=99)
    compiled = ptt.CompiledProgram(main).with_gspmd(
        axes={"dp": 2, "mp": 4}, rules=BAD_RULES, devices=[CPU] * 8)
    d0 = monitor.counter_totals().get(
        "paddle_tpu_executor_steps_dispatched", 0)
    rng = np.random.RandomState(3)
    with pytest.raises(ProgramVerificationError, match="mesh_axis_overuse"):
        exe.run(compiled, feed={
            "x": rng.rand(16, 8).astype(np.float32),
            "y": rng.randint(0, 4, (16, 1)).astype(np.int64)},
            fetch_list=[loss], scope=sc)
    assert monitor.counter_totals().get(
        "paddle_tpu_executor_steps_dispatched", 0) == d0


def test_choose_rules_rows_priced_by_the_plan():
    pm, _, pl = build("port", "mlp")
    table, report = part.choose_rules(pm, MESH, fetch_names=[pl],
                                      batch_size=16)
    for row in report:
        p2, _, l2 = build("port", "mlp")
        part.partition_program(p2, MESH, rules=row["rules"])
        plan = sharding.plan_sharding(p2, [l2], batch_size=16)
        assert row["reshard_edges"] == len(plan.edges)
        assert row["reshard_bytes"] == plan.payload_bytes
        assert row["est_comm_ms"] == round(plan.est_ms, 4)
    assert next(r for r in report if r["chosen"])["rules"] == table.name


def test_plan_sharded_memory_divides_listed_vars():
    from paddle_tpu.analysis import memory as ref_memory
    from paddle_tpu_torch.analysis import memory
    (rm, _, rl), (pm, _, pl) = _both("mlp")
    specs = {n: (None, "mp") for n, v in pm.global_block().vars.items()
             if "gs_fc1.w" in n and v.is_parameter}
    base = memory.plan_memory(pm, [pl], batch_size=16)
    got = memory.plan_sharded_memory(pm, [pl], batch_size=16, specs=specs,
                                     axis_sizes={"dp": 2, "mp": 4})
    want = ref_memory.plan_sharded_memory(rm, [rl], batch_size=16,
                                          specs=specs,
                                          axis_sizes={"dp": 2, "mp": 4})
    assert got.resident_bytes < base.resident_bytes
    assert (got.peak_bytes, got.resident_bytes) == \
        (want.peak_bytes, want.resident_bytes)


def test_decode_hostable_gate_and_engine():
    pm, _, pl = build("port", "mlp")
    assert sharding.check_decode_hostable(pm) == []
    part.partition_program(pm, MESH, rules="mp_hidden")
    with pytest.raises(ValueError, match="model-parallel sharded"):
        sharding.check_decode_hostable(pm)
    off = sharding.check_decode_hostable(pm, raise_on_violation=False)
    assert off and all("mp" in spec for _, spec in off)
    dp_only, _, _ = build("port", "mlp")
    part.partition_program(dp_only, {"dp": 4}, rules="replicated")
    assert sharding.check_decode_hostable(dp_only) == []
    # the engine runs the gate before it touches a weight
    cfg = T.BertConfig(vocab_size=48, d_model=16, n_layer=1, n_head=2,
                       d_inner=32, max_pos=16, dropout=0.0)
    with pytest.raises(ValueError, match="model-parallel sharded"):
        ptt.serving.DecodeEngine(cfg, {}, program=pm, place=ptt.CPUPlace())
    sc, startup = ptt.framework.Scope(), ptt.Program()
    with ptt.program_guard(ptt.Program(), startup):
        T.build_gpt_serving(cfg, 8)
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=sc, seed=1)
    eng = ptt.serving.DecodeEngine(cfg, sc, max_slots=2, page_len=4,
                                   max_seq=16, program=dp_only,
                                   place=ptt.CPUPlace())
    assert eng.cfg is cfg
