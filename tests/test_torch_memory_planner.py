"""The static memory planner (``analysis/memory.py``) of the port against
the JAX package's, on the CPU.

The same programs are built in both packages: the tiny GPT training
program (flash attention, fused LM head, Adam), a toy ResNet of two
bottleneck blocks (Momentum) before and after the fusion pass, an
inference clone of the GPT serving program, and an fc + SGD program that
fetches a parameter it updates (a fetched read-write persistable).  Both
planners must give EQUAL plans at batch 1 and at the real batch:
``peak_bytes``, ``peak_pos``, ``peak_op``, ``resident_bytes``,
``steady_bytes``, ``top_ops(5)``, the per-op footprints and the live set
at the peak.  Also against the reference: the verifier's
``_attrs["verify"]["memory"]`` stamp and its ``memory_budget`` warning
under ``FLAGS_memory_budget_mb``, and the batch server's width admission
(``BucketPlan._admit_width``) halving under a budget.
"""

import pytest

import paddle_tpu  # noqa: F401  (registers the reference lowerings)
from paddle_tpu import flags as ref_flags
from paddle_tpu import layers as ref_layers
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.analysis import fusion as ref_fusion
from paddle_tpu.analysis import memory as ref_memory
from paddle_tpu.analysis import verifier as ref_verifier
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu.models import transformer as RT
from paddle_tpu.serving import bucketing as ref_bucketing
from paddle_tpu_torch import flags
from paddle_tpu_torch import layers
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.analysis import fusion
from paddle_tpu_torch.analysis import memory
from paddle_tpu_torch.analysis import verifier
from paddle_tpu_torch.framework import core, unique_name
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.serving import bucketing
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CFG = dict(vocab_size=64, d_model=32, n_layer=2, n_head=4, d_inner=64,
           max_pos=16, dropout=0.0)
SEQ = 16


@pytest.fixture(autouse=True)
def _reset():
    """Fresh plan caches in both packages and no memory budget."""
    memory.clear_cache()
    ref_memory.clear_cache()
    verifier.clear_cache()
    ref_verifier.clear_cache()
    yield
    flags.set_flags({"FLAGS_memory_budget_mb": 0})
    ref_flags.set_flags({"FLAGS_memory_budget_mb": 0})


def _pkg(name):
    """(Program, program_guard, unique_name, layers, optimizer, transformer,
    resnet) of one package."""
    if name == "ref":
        return (RefProgram, ref_guard, ref_names, ref_layers, ref_opt, RT,
                ref_resnet)
    return (core.Program, core.program_guard, unique_name, layers, opt, T,
            resnet)


def _gpt_train(name):
    Program, guard, names, _, o, M, _ = _pkg(name)
    main, startup = Program(), Program()
    with guard(main, startup), names.guard():
        _, _, loss = M.build_gpt_pretrain(M.BertConfig(**CFG), SEQ,
                                          attn_impl="flash",
                                          fused_head=True, dropout=0.0)
        o.AdamOptimizer(1e-3).minimize(loss)
    return main, [loss.name]


def _toy_resnet(name, fused=False):
    Program, guard, names, L, o, _, R = _pkg(name)
    main, startup = Program(), Program()
    with guard(main, startup), names.guard():
        img = L.data("image", shape=[16, 8, 8], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        h = R.bottleneck_block(img, 16, 1, "bb0")
        h = R.bottleneck_block(h, 16, 2, "bb1")
        pred = L.fc(L.pool2d(h, pool_type="avg", global_pooling=True),
                    size=4, act="softmax", param_attr="fc_out.w",
                    bias_attr="fc_out.b")
        loss = L.mean(L.cross_entropy(pred, label))
        o.MomentumOptimizer(learning_rate=0.1, momentum=0.9).minimize(loss)
    if fused:
        fuse = ref_fusion.fuse_program if name == "ref" else \
            fusion.fuse_program
        main = fuse(main, [loss.name], feed_shapes={
            "image": (4, 16, 8, 8), "label": (4, 1)})
    return main, [loss.name]


def _gpt_inference_clone(name):
    Program, guard, names, _, _, M, _ = _pkg(name)
    main, startup = Program(), Program()
    with guard(main, startup), names.guard():
        _, logits = M.build_gpt_serving(M.BertConfig(**CFG), SEQ,
                                        attn_impl="flash")
    return main.clone(for_test=True), [logits.name]


def _fetched_rw_param(name):
    Program, guard, names, L, o, _, _ = _pkg(name)
    main, startup = Program(), Program()
    with guard(main, startup), names.guard():
        x = L.data("x", shape=[8], dtype="float32")
        y = L.fc(x, size=6, param_attr="w", bias_attr="b")
        loss = L.mean(y)
        o.SGD(0.1).minimize(loss)
    return main, [loss.name, "w"]


PROGRAMS = {"gpt_train": _gpt_train, "toy_resnet": _toy_resnet,
            "toy_resnet_fused": lambda n: _toy_resnet(n, fused=True),
            "gpt_inference_clone": _gpt_inference_clone,
            "fetched_rw_param": _fetched_rw_param}
#: the real batch of each program's feeds
BATCH = {"gpt_train": 2, "toy_resnet": 4, "toy_resnet_fused": 4,
         "gpt_inference_clone": 3, "fetched_rw_param": 5}


def _fields(plan):
    return {"peak_bytes": plan.peak_bytes, "peak_pos": plan.peak_pos,
            "peak_op": plan.peak_op, "resident_bytes": plan.resident_bytes,
            "steady_bytes": plan.steady_bytes,
            "top_ops": plan.top_ops(5), "per_op": plan.per_op,
            "peak_live": sorted(plan.peak_live),
            "intervals": plan.intervals, "batch_size": plan.batch_size}


@pytest.mark.parametrize("batch", ["one", "real"])
@pytest.mark.parametrize("prog", sorted(PROGRAMS))
def test_plan_equals_reference(prog, batch):
    ref_main, ref_fetch = PROGRAMS[prog]("ref")
    main, fetch = PROGRAMS[prog]("port")
    assert fetch == ref_fetch
    b = 1 if batch == "one" else BATCH[prog]
    want = ref_memory.plan_memory(ref_main, ref_fetch, batch_size=b)
    got = memory.plan_memory(main, fetch, batch_size=b)
    assert _fields(got) == _fields(want)
    assert got.peak_bytes > got.resident_bytes > 0


def test_fetched_rw_persistable_costs_one_copy():
    main, fetch = _fetched_rw_param("port")
    with_w = memory.plan_memory(main, fetch, batch_size=5)
    without = memory.plan_memory(main, fetch[:1], batch_size=5)
    w_bytes = 8 * 6 * 4
    assert with_w.steady_bytes == without.steady_bytes + w_bytes


def test_plan_cache_and_report():
    main, fetch = _gpt_train("port")
    p1 = memory.plan_memory(main, fetch, batch_size=2)
    assert memory.plan_memory(main, fetch, batch_size=2) is p1
    assert memory.plan_memory(main, fetch, batch_size=3) is not p1
    report = p1.report(3)
    assert report.startswith("static HBM plan (batch=2): peak ")
    assert report.count("[info] hbm_peak") == 3
    # the per-shard plan (GSPMD's planner): no spec is the plain plan, a
    # sharded layout the reference's per-shard bytes
    assert memory.plan_sharded_memory(main, fetch, batch_size=2,
                                      specs={}).peak_bytes == p1.peak_bytes
    ref_main, ref_fetch = _gpt_train("ref")
    specs = {n: (None, "mp") for n, v in main.global_block().vars.items()
             if v.is_parameter and len(v.shape or ()) == 2}
    sizes = {"dp": 2, "mp": 4}
    got = memory.plan_sharded_memory(main, fetch, batch_size=2, specs=specs,
                                     axis_sizes=sizes)
    want = ref_memory.plan_sharded_memory(ref_main, ref_fetch, batch_size=2,
                                          specs=specs, axis_sizes=sizes)
    assert (got.peak_bytes, got.resident_bytes, got.steady_bytes) == \
        (want.peak_bytes, want.resident_bytes, want.steady_bytes)
    assert got.resident_bytes < p1.resident_bytes


@pytest.mark.parametrize("prog", ["gpt_train", "toy_resnet"])
def test_verifier_stamps_memory_as_reference(prog):
    ref_main, ref_fetch = PROGRAMS[prog]("ref")
    main, fetch = PROGRAMS[prog]("port")
    ref_verifier.verify_program(ref_main, ref_fetch)
    res = verifier.verify_program(main, fetch)
    assert main._attrs["verify"]["memory"] == \
        ref_main._attrs["verify"]["memory"]
    assert res.memory_plan.peak_bytes == \
        main._attrs["verify"]["memory"]["peak_bytes"]
    assert not [d for d in res.diagnostics if d.check == "memory_budget"]


def test_memory_budget_warning_as_reference():
    ref_main, ref_fetch = _toy_resnet_big("ref")
    main, fetch = _toy_resnet_big("port")
    assert memory.plan_memory(main, fetch).peak_bytes > 1 << 20
    for f in (flags, ref_flags):
        f.set_flags({"FLAGS_memory_budget_mb": 1})
    want = ref_verifier.verify_program(ref_main, ref_fetch)
    got = verifier.verify_program(main, fetch)
    wd = [d for d in want.diagnostics if d.check == "memory_budget"]
    gd = [d for d in got.diagnostics if d.check == "memory_budget"]
    assert len(gd) == len(wd) == 1
    assert (gd[0].severity, gd[0].message, gd[0].op_type,
            gd[0].op_index) == (wd[0].severity, wd[0].message,
                                wd[0].op_type, wd[0].op_index)


def _toy_resnet_big(name):
    """The toy ResNet's blocks at 64 filters on a [64, 32, 32] image: a
    batch-1 plan past 1 MiB."""
    Program, guard, names, L, o, _, R = _pkg(name)
    main, startup = Program(), Program()
    with guard(main, startup), names.guard():
        img = L.data("image", shape=[64, 32, 32], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        h = R.bottleneck_block(img, 64, 1, "bb0")
        pred = L.fc(L.pool2d(h, pool_type="avg", global_pooling=True),
                    size=4, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        o.MomentumOptimizer(learning_rate=0.1, momentum=0.9).minimize(loss)
    return main, [loss.name]


@pytest.mark.parametrize("budget_mb", [0, 1, 3, 64])
def test_admit_width_halves_as_reference(budget_mb):
    ref_main, ref_fetch = _toy_resnet_big("ref")
    main, fetch = _toy_resnet_big("port")
    ref_plan = ref_bucketing.BucketPlan((32,), None, 8,
                                        memory_budget_mb=budget_mb)
    plan = bucketing.BucketPlan((32,), None, 8, memory_budget_mb=budget_mb)
    want = ref_plan._admit_width(ref_main, ref_fetch)
    got = plan._admit_width(main, fetch)
    assert got == want
    if budget_mb:
        # the admitted width fits the budget, or is 1
        peak = memory.plan_memory(main, fetch, batch_size=got).peak_bytes
        assert got == 1 or peak <= budget_mb << 20
        assert got == 8 or memory.plan_memory(
            main, fetch, batch_size=2 * got).peak_bytes > budget_mb << 20
    else:
        assert got == 8


def test_statusz_reports_budget_and_widths():
    """An InferenceServer built under FLAGS_memory_budget_mb admits the
    planned width and reports the budget (no dispatch needed)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.serving import InferenceServer

    def factory(seq):
        main, fetch = _toy_resnet_big("port")
        return main, ["image", "label"], fetch

    flags.set_flags({"FLAGS_memory_budget_mb": 3})
    srv = InferenceServer(factory, None, buckets=(32,), max_batch=8,
                          executor=ptt.Executor(ptt.CPUPlace()))
    assert srv.statusz()["memory"]["per_bucket"]["32"]["width"] is None
    _, _, _, width = srv.plan.plan(32)
    main, fetch = _toy_resnet_big("port")
    ref_main, ref_fetch = _toy_resnet_big("ref")
    assert width == ref_bucketing.BucketPlan(
        (32,), None, 8, memory_budget_mb=3)._admit_width(ref_main,
                                                         ref_fetch)
    mem = srv.statusz()["memory"]
    assert mem["budget_mb"] == 3
    assert mem["per_bucket"]["32"]["width"] == width < 8
    assert mem["per_bucket"]["32"]["static_peak_bytes"] == \
        memory.plan_memory(main, fetch, batch_size=width).peak_bytes
    assert InferenceServer(factory, None, buckets=(32,), max_batch=8,
                           executor=ptt.Executor(ptt.CPUPlace()),
                           memory_budget_mb=0).plan.plan(32)[3] == 8
