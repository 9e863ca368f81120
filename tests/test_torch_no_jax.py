"""The port stands alone: no JAX and nothing of ``paddle_tpu``.

- in a subprocess where ``import jax`` and ``import paddle_tpu`` fail,
  importing ``paddle_tpu_torch``, serving one request (through
  ``CompiledProgram``'s verifier and passes), generating from one prompt
  through ``DecodeServer`` over a host ``DecodeEngine``, taking Adam steps of a tiny
  GPT, with the fusion autotuner on in the last, one bf16 AMP step
  (``amp.decorate``, master weights staying float32), one Momentum step of a
  toy ResNet through the graph-fusion pass, and the measurement tools'
  chains, skeletons and peak table (``paddle_tpu_torch.tools``), and one
  ring attention forward + backward over 4 virtual ranks on the CPU, and
  one step of a tiny GPT at dropout 0.1 under Lookahead over
  ``RecomputeOptimizer(LambOptimizer)`` with an MSRA-initialized
  parameter beside it, and a tiny GPT artifact built with the dense
  attention chain, saved with ``save_inference_model`` and served by an
  ``AnalysisPredictor`` on the host through the analysis passes (9
  ``fc``), and ``apply_passes`` of
  ``conv_bn_train_fuse_pass``, and a checkpoint daemon's save of the tiny
  GPT of ``tools/preempt_runner.py`` and its resume in a fresh scope
  (``resume_or_init``, the state bit for bit), work; so do full-mode
  numerics statistics of a small MLP and an SLO-tracked request served
  behind the scrape endpoint, and one request routed through a
  ``FleetRouter`` over an in-process ``ReplicaEndpoint``, and two
  ``GradAllReduce`` steps of a tiny MLP in collective mode over a ``dp``
  mesh of two virtual ranks (the comms plan stamped, the bytes counted),
  and one ``with_gspmd`` step of a tiny MLP over dp 2 x mp 2 virtual ranks
  (the plan's bytes counted, the Adam moment a dp-sharded value), and one
  pipelined step of a two-stage MLP (a stage on a device list) and one
  ``switch_moe_ffn`` step over ep 2 x dp 2 virtual ranks;
- a source scan finds no ``jax`` or ``paddle_tpu`` import in the package or
  in ``chip_smoke.py``, the multi-process modules and tools among them;
- ``init_parallel_env`` at world 1, a coordinator and a client run in a
  subprocess with JAX blocked;
- ``Executor()`` and ``DecodeEngine()`` (the card by default) raise when
  there is no GPU.
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

import paddle_tpu_torch as ptt
from _port_fixtures import collect_garbage_after_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now fails
    sys.modules["paddle_tpu"] = None
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    from paddle_tpu_torch.models import transformer as T

    cfg = T.BertConfig(vocab_size=48, d_model=16, n_layer=2, n_head=2,
                       d_inner=32, max_pos=64, dropout=0.0)

    def factory(seq):
        prog, startup = Program(), Program()
        with program_guard(prog, startup):
            _, logits = T.build_gpt_serving(cfg, seq, attn_impl="flash")
        return prog, ["src_ids"], [logits.name]

    scope = Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    startup = Program()
    with program_guard(Program(), startup):
        T.build_gpt_serving(cfg, 8)
    exe.run(startup, scope=scope, seed=1)
    srv = ptt.serving.InferenceServer(factory, scope, buckets=(8,),
                                      max_batch=2, executor=exe).start()
    out = srv.submit("t", {"src_ids": np.arange(1, 6)}).result(timeout=60)
    srv.drain(10)
    srv.stop()
    assert out[0].shape == (5, 48), out[0].shape
    eng = ptt.serving.DecodeEngine(cfg, scope, max_slots=2, page_len=4,
                                   max_seq=16, place=ptt.CPUPlace())
    dsrv = ptt.serving.DecodeServer(eng).start()
    gen = dsrv.submit("t", [3, 9, 17], max_new_tokens=4).result(timeout=60)
    dsrv.drain(10)
    dsrv.stop()
    assert len(gen) == 4 and eng.trace_count == 1, (gen, eng.trace_count)

    from paddle_tpu_torch import optimizer
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss = T.build_gpt_pretrain(cfg, 8, attn_impl="flash",
                                          dropout=0.0)
        optimizer.AdamOptimizer(1e-3).minimize(loss)
    train_scope = Scope()
    exe.run(startup, scope=train_scope, seed=2)
    ids = np.arange(1, 17).reshape(2, 8)
    l0, = exe.run(main, feed={"src_ids": ids, "lm_label": ids},
                  fetch_list=[loss], scope=train_scope)
    l1, = exe.run(main, feed={"src_ids": ids, "lm_label": ids},
                  fetch_list=[loss], scope=train_scope)
    assert l1 < l0, (l0, l1)
    import tempfile
    from paddle_tpu_torch import flags
    flags.set_flags({"FLAGS_fusion_autotune": True,
                     "FLAGS_fusion_rank_threshold": 0.0,
                     "FLAGS_xla_compile_cache_dir": tempfile.mkdtemp()})
    l2, = exe.run(main, feed={"src_ids": ids, "lm_label": ids},
                  fetch_list=[loss], scope=train_scope)
    tuned = [p for p in exe._plans.values()
             if p.block.program._attrs.get("fusion", {}).get("candidates")
             and all("autotune" in d for d in
                     p.block.program._attrs["fusion"]["candidates"])]
    assert len(tuned) == 1 and np.isfinite(l2), (len(tuned), l2)
    flags.set_flags({"FLAGS_fusion_autotune": False,
                     "FLAGS_fusion_rank_threshold": 0.02})
    from paddle_tpu_torch import amp
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, aloss = T.build_gpt_pretrain(cfg, 8, attn_impl="flash",
                                           dropout=0.0)
        amp.decorate(optimizer.AdamOptimizer(1e-3)).minimize(aloss)
    amp_scope = Scope()
    exe.run(startup, scope=amp_scope, seed=2)
    la, = exe.run(main, feed={"src_ids": ids, "lm_label": ids},
                  fetch_list=[aloss], scope=amp_scope)
    assert np.isfinite(la) and all(
        amp_scope.find_var(p.name).dtype == torch.float32
        for p in main.all_parameters()), la
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import resnet
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", shape=[8, 8, 8], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        h = resnet.bottleneck_block(img, 4, 2, "bb0")
        pred = layers.fc(layers.pool2d(h, pool_type="avg",
                                       global_pooling=True),
                         size=4, act="softmax")
        rloss = layers.mean(layers.cross_entropy(pred, label))
        optimizer.MomentumOptimizer(0.1, 0.9).minimize(rloss)
    rn_scope = Scope()
    exe.run(startup, scope=rn_scope, seed=3)
    rl, = exe.run(main, feed={"img": np.ones((2, 8, 8, 8), np.float32),
                              "label": np.array([[1], [2]])},
                  fetch_list=[rloss], scope=rn_scope)
    plan, = [p for p in exe._plans.values()
             if any(op.type == "momentum" and "bb0" in op.input("Param")[0]
                    for op, _ in p.ops)]
    n_fused = [op.type for op, _ in plan.ops].count("fused_conv1x1_bn")
    assert n_fused == 3 and np.isfinite(rl), (n_fused, rl)
    from paddle_tpu_torch.kernels import attn_skeleton
    from paddle_tpu_torch.tools import (attn_shape_ceiling, rn50_fused_bench,
                                        timing)
    args = rn50_fused_bench.make_inputs(64, 16, 8, np.random.RandomState(0),
                                        "cpu")
    fs = float(rn50_fused_bench.fused_chain(*args))
    ls = float(rn50_fused_bench.library_chain(*args))
    assert abs(fs - ls) <= 2.0 ** -7 * abs(ls), (fs, ls)
    q = torch.ones(1, 64, 8)
    assert attn_skeleton.attn_skeleton_bwd(q, q, q, q)[1].shape == (1, 1,
                                                                   64, 8)
    assert timing.peaks("NVIDIA H100 80GB HBM3")[0] == 67e12
    assert attn_shape_ceiling.CASES[0] == (2048, 24)
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import ring_attention as ra
    from paddle_tpu_torch.parallel import make_mesh
    qkv = [torch.randn(1, 2, 16, 8, generator=torch.Generator().manual_seed(i))
           .requires_grad_() for i in range(3)]
    ro = ra.ring_attention(*qkv, make_mesh({"sp": 4}, [torch.device("cpu")]
                                           * 4), causal=True)
    ro.sum().backward()
    want = fa.mha_reference(*(x.detach() for x in qkv), causal=True)
    assert torch.allclose(ro, want, atol=2e-5) and all(
        torch.isfinite(x.grad).all() for x in qkv)
    from paddle_tpu_torch import initializer
    ckpts = []
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, rloss = T.build_gpt_pretrain(cfg, 8, attn_impl="flash",
                                           dropout=0.1, checkpoints=ckpts)
        lamb = optimizer.RecomputeOptimizer(optimizer.LambOptimizer(1e-3))
        lamb._set_checkpoints(ckpts)
        optimizer.LookaheadOptimizer(lamb, k=2).minimize(rloss)
        layers.create_parameter([4, 4], "float32", name="extra",
                                default_initializer=initializer.MSRA())
    rc_scope = Scope()
    exe.run(startup, scope=rc_scope, seed=4)
    rcl, = exe.run(main, feed={"src_ids": ids, "lm_label": ids},
                   fetch_list=[rloss], scope=rc_scope)
    n_bar = [op.type for op in main.global_block().ops].count(
        "optimization_barrier")
    assert np.isfinite(rcl) and n_bar > 0, (rcl, n_bar)
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.framework import ir
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, logits = T.build_gpt_serving(cfg, 8, attn_impl="base")
    inf_scope = Scope()
    exe.run(startup, scope=inf_scope, seed=5)
    model_dir = tempfile.mkdtemp()
    ptt.save_inference_model(model_dir, ["src_ids"], [logits], exe,
                             main_program=main, scope=inf_scope)
    config = inference.AnalysisConfig(model_dir)
    config.disable_gpu()
    pred = inference.create_paddle_predictor(config)
    n_fc = [op.type for op in pred.program.global_block().ops].count("fc")
    po = pred.run([inference.PaddleTensor(ids, name="src_ids")])
    assert n_fc == 9 and po[0].as_ndarray().shape == (2, 8, 48), n_fc
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", shape=[8, 8, 8], dtype="float32")
        h = resnet.bottleneck_block(img, 4, 2, "bb0")
        layers.mean(h)
    fused = ir.apply_passes(main, ["conv_bn_train_fuse_pass"])
    assert [op.type for op in fused.global_block().ops].count(
        "fused_conv1x1_bn") == 3
    from paddle_tpu_torch import checkpoint, resilience
    from paddle_tpu_torch.tools import preempt_runner as pr
    pmain, pstart, ploss = pr.build("tiny")
    ck = checkpoint.CheckpointManager(tempfile.mkdtemp())
    pexe, psc = ptt.Executor(ptt.CPUPlace()), Scope()
    assert resilience.resume_or_init(ck, pexe, startup_program=pstart,
                                     main_program=pmain, scope=psc) == 0
    daemon = resilience.CheckpointDaemon(ck, program=pmain, scope=psc,
                                         interval_steps=1).start()
    pexe.run(pmain, feed=pr.batch("tiny", 0), fetch_list=[ploss],
             scope=psc)
    assert daemon.step_completed(1) and daemon.stop() == 1
    psc2 = Scope()
    assert resilience.resume_or_init(
        ck, ptt.Executor(ptt.CPUPlace()), startup_program=pstart,
        main_program=pmain, scope=psc2) == 1
    assert pr.digests(psc2, pmain) == pr.digests(psc, pmain)
    assert not [m for m, mod in sys.modules.items() if mod is not None
                and (m == "jax" or m.startswith(("jax.", "paddle_tpu.")))]
    print("served", out[0].shape, "generated", len(gen), "trained", float(l0), float(l1),
          "amp", float(la), "resnet", float(rl), "recompute", float(rcl))
""")


def test_port_imports_and_serves_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "served (5, 48) generated 4" in res.stdout


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|paddle_tpu)(?:[.\s,]|$)", re.M)


def _sources():
    root = os.path.join(REPO, "paddle_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_jax_or_reference_import_in_sources():
    scanned = {os.path.relpath(p, REPO) for p in _sources()}
    assert {"paddle_tpu_torch/amp.py",
            "paddle_tpu_torch/analysis/fusion.py",
            "paddle_tpu_torch/analysis/verifier.py",
            "paddle_tpu_torch/compiler.py",
            "paddle_tpu_torch/debugger.py",
            "paddle_tpu_torch/framework/ir.py",
            "paddle_tpu_torch/kernels/conv_bn.py",
            "paddle_tpu_torch/kernels/dense_epilogue.py",
            "paddle_tpu_torch/kernels/dropout.py",
            "paddle_tpu_torch/models/transformer.py",
            "paddle_tpu_torch/ops/nn_ops.py",
            "paddle_tpu_torch/ops/tensor_ops.py",
            "paddle_tpu_torch/kernels/layer_norm.py",
            "paddle_tpu_torch/models/resnet.py",
            "paddle_tpu_torch/monitor.py",
            "paddle_tpu_torch/ops/fused_ops.py",
            "paddle_tpu_torch/kernels/attn_skeleton.py",
            "paddle_tpu_torch/tools/__init__.py",
            "paddle_tpu_torch/tools/timing.py",
            "paddle_tpu_torch/tools/rn50_fused_bench.py",
            "paddle_tpu_torch/tools/attn_shape_ceiling.py",
            "paddle_tpu_torch/kernels/ring_attention.py",
            "paddle_tpu_torch/ops/attention_ops.py",
            "paddle_tpu_torch/parallel/__init__.py",
            "paddle_tpu_torch/parallel/mesh.py",
            "paddle_tpu_torch/parallel/partitioner.py",
            "paddle_tpu_torch/parallel/spmd.py",
            "paddle_tpu_torch/analysis/sharding.py",
            "paddle_tpu_torch/distributed/collective_ops.py",
            "paddle_tpu_torch/resilience.py",
            "paddle_tpu_torch/serving/kv_cache.py",
            "paddle_tpu_torch/serving/scheduler.py",
            "paddle_tpu_torch/framework/recompute.py",
            "paddle_tpu_torch/framework/executor.py",
            "paddle_tpu_torch/ops/misc_ops.py",
            "paddle_tpu_torch/ops/optimizer_ops.py",
            "paddle_tpu_torch/layers/control_flow.py",
            "paddle_tpu_torch/optimizer.py",
            "paddle_tpu_torch/initializer.py",
            "paddle_tpu_torch/io.py",
            "paddle_tpu_torch/flags.py",
            "paddle_tpu_torch/framework/function.py",
            "paddle_tpu_torch/inference/__init__.py",
            "paddle_tpu_torch/inference/api.py",
            "paddle_tpu_torch/ops/compat_ops.py",
            "paddle_tpu_torch/layers/tensor.py",
            "paddle_tpu_torch/checkpoint.py",
            "paddle_tpu_torch/tools/preempt_runner.py",
            "paddle_tpu_torch/serving/server.py",
            "paddle_tpu_torch/memory.py",
            "paddle_tpu_torch/analysis/memory.py",
            "paddle_tpu_torch/hbm.py",
            "paddle_tpu_torch/profiler.py",
            "paddle_tpu_torch/analysis/device_profile.py",
            "paddle_tpu_torch/analysis/numerics.py",
            "paddle_tpu_torch/serving/slo.py",
            "paddle_tpu_torch/serving/httpd.py",
            "paddle_tpu_torch/serving/bucketing.py",
            "paddle_tpu_torch/serving/fleet.py",
            "paddle_tpu_torch/serving/autoscaler.py",
            "paddle_tpu_torch/distributed/__init__.py",
            "paddle_tpu_torch/distributed/coordinator.py",
            "paddle_tpu_torch/distributed/collective_ops.py",
            "paddle_tpu_torch/distributed/transpiler.py",
            "paddle_tpu_torch/distributed/env.py",
            "paddle_tpu_torch/distributed/fleet.py",
            "paddle_tpu_torch/parallel/dgc.py",
            "paddle_tpu_torch/analysis/comms.py",
            "paddle_tpu_torch/tools/latency_report.py",
            "paddle_tpu_torch/tools/fleet_smoke.py",
            "paddle_tpu_torch/distributed/launch.py",
            "paddle_tpu_torch/distributed/xproc.py",
            "paddle_tpu_torch/tools/collective_runner.py",
            "paddle_tpu_torch/tools/gang_runner.py",
            "paddle_tpu_torch/tools/gang_smoke.py",
            "paddle_tpu_torch/tools/gangtop.py",
            "paddle_tpu_torch/tools/comms_smoke.py",
            "paddle_tpu_torch/parallel/pipeline.py",
            "paddle_tpu_torch/ops/moe_ops.py",
            "paddle_tpu_torch/layers/nn.py",
            "paddle_tpu_torch/dygraph/__init__.py",
            "paddle_tpu_torch/dygraph/base.py",
            "paddle_tpu_torch/dygraph/tracer.py",
            "paddle_tpu_torch/dygraph/eager_apply.py"} <= scanned
    offenders = []
    for path in _sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, REPO)}: "
                                 f"{m.group(0).strip()}")
    assert offenders == []


_PLANES_BLOCKED = textwrap.dedent("""
    import json, os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["paddle_tpu"] = None
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags, hbm, optimizer, profiler
    from paddle_tpu_torch.analysis import device_profile, memory
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    from paddle_tpu_torch.models import transformer as T

    cfg = T.BertConfig(vocab_size=48, d_model=16, n_layer=2, n_head=2,
                       d_inner=32, max_pos=64, dropout=0.0)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss = T.build_gpt_pretrain(cfg, 8, attn_impl="flash",
                                          dropout=0.0)
        optimizer.AdamOptimizer(1e-3).minimize(loss)
    plan = memory.plan_memory(main, [loss], batch_size=2)
    assert plan.peak_bytes > plan.steady_bytes > 0, plan.report()
    d = tempfile.mkdtemp()
    flags.set_flags({"FLAGS_profile_sample_every_n_steps": 2,
                     "FLAGS_profile_sample_window_steps": 2,
                     "FLAGS_profile_sample_dir": d})
    scope, exe = Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope, seed=2)
    ids = np.arange(1, 17).reshape(2, 8)
    for _ in range(4):
        exe.run(main, feed={"src_ids": ids, "lm_label": ids},
                fetch_list=[loss], scope=scope)
    profiler.SAMPLER.close()
    w, = json.load(open(os.path.join(d, "manifest.json")))["windows"]
    s = json.load(open(os.path.join(w["dir"], "summary.json")))
    assert s["n_steps"] == w["end_step"] - w["start_step"] == 2, s
    assert hbm.ACCOUNTANT.drain(30) and hbm.HBM_LIVE_GAUGE.value() > 0
    assert profiler.dispatch_stats()["steps_dispatched"] == 5
    assert not [m for m, mod in sys.modules.items() if mod is not None
                and (m == "jax" or m.startswith(("jax.", "paddle_tpu.")))]
    print("window", w["start_step"], w["end_step"], "peak", plan.peak_bytes)
""")


def test_planes_run_with_jax_blocked():
    """A sampled profiler window (trace, manifest, summary), the HBM
    accountant and a static memory plan, with JAX and the reference
    unimportable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _PLANES_BLOCKED], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "window " in res.stdout


_NUMERICS_SERVING_BLOCKED = textwrap.dedent("""
    import json, sys, urllib.request
    sys.modules["jax"] = None
    sys.modules["paddle_tpu"] = None
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags, layers
    from paddle_tpu_torch.analysis import numerics
    from paddle_tpu_torch.framework import Program, Scope, program_guard

    flags.set_flags({"FLAGS_numerics": "full",
                     "FLAGS_serving_slo": "*:p99_ms=500"})
    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data("x", shape=[8], dtype="float32")
        loss = layers.mean(layers.fc(layers.fc(x, 16, act="relu"), 4))
        ptt.optimizer.SGD(0.1).minimize(loss)
    scope, exe = Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope, seed=1)
    for _ in range(3):
        exe.run(main, feed={"x": np.ones((4, 8), np.float32)},
                fetch_list=[loss], scope=scope)
    numerics.ENGINE.poll(force=True)
    f = numerics.ENGINE.last_frame
    assert f.grads and f.weights and f.global_gnorm > 0, f.grads

    def factory(seq):
        prog, st = Program(), Program()
        with program_guard(prog, st):
            v = layers.data("v", shape=[seq], dtype="float32")
            out = layers.concat([v, v], axis=1)
        return prog, ["v"], [out.name]
    srv = ptt.serving.InferenceServer(factory, Scope(), buckets=(8,),
                                      max_batch=2, executor=exe).start()
    http = srv.enable_http(0, host="127.0.0.1")
    direct = srv.submit("t", {"v": np.ones(4, np.float32)}).result(
        timeout=60)
    srv._slo_eval_safe()
    st = json.loads(urllib.request.urlopen(http.url + "/statusz").read())
    assert st["slo"]["t"]["breached"] is False, st
    from paddle_tpu_torch.distributed import coordinator
    from paddle_tpu_torch.serving import autoscaler, fleet
    from paddle_tpu_torch.tools import latency_report
    ep = fleet.ReplicaEndpoint(srv).start()
    router = fleet.FleetRouter([ep.address])
    routed = router.infer("t", {"v": np.ones(4, np.float32)})
    assert np.array_equal(np.asarray(routed[0]), direct[0]), routed
    assert router.snapshot()["completed"] == 1
    ep.stop()
    assert autoscaler.AutoscalerPolicy().target == 1
    assert coordinator.MAX_FRAME_BYTES == 16 << 20
    assert callable(latency_report.report)
    srv.drain(10)
    srv.stop()
    assert not [m for m, mod in sys.modules.items() if mod is not None
                and (m == "jax" or m.startswith(("jax.", "paddle_tpu.")))]
    print("numerics", len(f.grads), "slo", sorted(st["slo"]), "routed")
""")


def test_numerics_and_serving_planes_run_with_jax_blocked():
    """Full-mode statistics of a small MLP, an SLO-tracked served request,
    the scrape endpoint, and a request routed by a ``FleetRouter`` over a
    ``ReplicaEndpoint`` (the fleet, autoscaler, frame-protocol and
    latency_report modules imported), with JAX and the reference
    unimportable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _NUMERICS_SERVING_BLOCKED],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "numerics " in res.stdout and " routed" in res.stdout


_COLLECTIVE_BLOCKED = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["paddle_tpu"] = None
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import layers, monitor, optimizer
    from paddle_tpu_torch.analysis import comms, verifier
    from paddle_tpu_torch.distributed import GradAllReduce
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    from paddle_tpu_torch.parallel import make_mesh, set_mesh

    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data("x", shape=[8], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        h = layers.fc(x, size=16, act="tanh")
        loss = layers.mean(layers.square_error_cost(layers.fc(h, 1), y))
        optimizer.SGD(0.1).minimize(loss)
        GradAllReduce().transpile(startup_program=startup,
                                  main_program=main, rank=0,
                                  endpoints="127.0.0.1:1,127.0.0.1:2",
                                  current_endpoint="127.0.0.1:1")
    verifier.verify_program(main, [loss.name])
    stamp = main._attrs["verify"]["comms"]
    assert stamp["nranks"] == 2 and len(stamp["collectives"]) == 4, stamp
    scope, exe = Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope, seed=1)
    set_mesh(make_mesh({"dp": 2}, [torch.device("cpu")] * 2))
    xv = np.random.RandomState(0).rand(8, 8).astype(np.float32)
    before = monitor.counter_totals().get(
        "paddle_tpu_collective_bytes_total", 0)
    for _ in range(2):
        out, = exe.run(main, feed={"x": xv, "y": xv[:, :1]},
                       fetch_list=[loss], scope=scope)
    assert comms.MONITOR.drain(30)
    got = monitor.counter_totals()["paddle_tpu_collective_bytes_total"]
    assert got - before == 2 * stamp["payload_bytes"], (got, before)
    assert out.shape == (2,) and np.isfinite(out).all(), out
    assert not [m for m, mod in sys.modules.items() if mod is not None
                and (m == "jax" or m.startswith(("jax.", "paddle_tpu.")))]
    print("collective", out.shape, "bytes", got - before)
    from paddle_tpu_torch.analysis.sharding import plan_sharding
    from paddle_tpu_torch.parallel import ShardedValue
    set_mesh(None)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data("x", shape=[8], dtype="float32")
        y = layers.data("y", shape=[1], dtype="int64")
        h = layers.fc(x, size=16, act="relu")
        pred = layers.fc(h, size=4, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, y))
        optimizer.AdamOptimizer(0.01).minimize(loss)
    scope = Scope()
    exe.run(startup, scope=scope, seed=2)
    compiled = ptt.CompiledProgram(main).with_gspmd(
        axes={"dp": 2, "mp": 2}, rules="mp_hidden", zero_stage=1,
        devices=[torch.device("cpu")] * 4)
    before = monitor.counter_totals().get(
        "paddle_tpu_collective_bytes_total", 0)
    gl, = exe.run(compiled, feed={
        "x": xv, "y": np.zeros((8, 1), np.int64)}, fetch_list=[loss],
        scope=scope)
    moved = monitor.counter_totals()[
        "paddle_tpu_collective_bytes_total"] - before
    plan = plan_sharding(main, [loss.name], batch_size=8)
    assert moved == plan.payload_bytes and np.isfinite(gl), (moved, gl)
    assert any(isinstance(scope.find_var(n), ShardedValue)
               for n in scope.local_var_names() if "moment1" in n)
    assert not [m for m, mod in sys.modules.items() if mod is not None
                and (m == "jax" or m.startswith(("jax.", "paddle_tpu.")))]
    print("gspmd", gl.shape, "bytes", moved)
""")


def test_collective_mode_runs_with_jax_blocked():
    """Two GradAllReduce steps of a tiny MLP over a dp mesh of two virtual
    ranks, the verifier's comms stamp and the byte counter, then a
    with_gspmd step over dp 2 x mp 2, with JAX and the reference
    unimportable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _COLLECTIVE_BLOCKED],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "collective (2,) bytes " in res.stdout
    assert "gspmd () bytes " in res.stdout


_PIPE_MOE_BLOCKED = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["paddle_tpu"] = None
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    cpu = torch.device("cpu")
    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data("x", shape=[8], dtype="float32")
        y = layers.data("y", shape=[1], dtype="int64")
        h = layers.fc(x, size=16, act="relu")
        loss = layers.mean(layers.cross_entropy(
            layers.fc(h, size=4, act="softmax"), y))
        pipe = optimizer.PipelineOptimizer(optimizer.AdamOptimizer(0.01),
                                           cut_list=[h], num_microbatches=2)
        pipe.minimize(loss)
    sc = Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=sc)
    eng = pipe.create_engine(devices=[cpu, [cpu, cpu]], scope=sc)
    rng = np.random.RandomState(0)
    pl = eng.train_step({"x": rng.rand(8, 8).astype("float32"),
                         "y": rng.randint(0, 4, (8, 1)).astype("int64")})
    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data("x", shape=[4, 8], dtype="float32")
        out, aux = layers.switch_moe_ffn(x, num_experts=4, d_inner=8)
        loss = layers.mean(out * out) + 0.1 * aux
        optimizer.AdamOptimizer(0.01).minimize(loss)
    sc = Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc)
    prog = ptt.CompiledProgram(main).with_distributed(
        axes={"ep": 2, "dp": 2}, devices=[cpu] * 4)
    ml, = exe.run(prog, feed={"x": rng.rand(4, 4, 8).astype("float32")},
                  fetch_list=[loss], scope=sc)
    assert np.isfinite(pl) and np.isfinite(ml), (pl, ml)
    assert not [m for m, mod in sys.modules.items() if mod is not None
                and (m == "jax" or m.startswith(("jax.", "paddle_tpu.")))]
    print("pipeline", round(pl, 4), "moe", float(ml))
""")


def test_pipeline_and_moe_run_with_jax_blocked():
    """One pipelined Adam step of a two-stage MLP (its second stage on a
    device list) and one ``switch_moe_ffn`` step under ``ep`` 2 x ``dp`` 2
    virtual ranks, with JAX and the reference unimportable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _PIPE_MOE_BLOCKED],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "pipeline " in res.stdout and " moe " in res.stdout


def test_default_executor_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Executor() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.serving.InferenceServer(lambda seq: None, ptt.Scope())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.serving.DecodeEngine(None, {})
    assert ptt.Executor(ptt.CPUPlace()).device == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 2
    assert '"ok"' not in res.stdout and "no CUDA device" in res.stderr


_WORLD_ONE_BLOCKED = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["paddle_tpu"] = None
    import paddle_tpu_torch
    from paddle_tpu_torch.distributed import (coordinator, env, launch,
                                              xproc)
    from paddle_tpu_torch.tools import (collective_runner, gang_runner,
                                        gang_smoke, gangtop, comms_smoke)
    e = env.init_parallel_env()
    assert e.world_size == 1 and env.init_parallel_env() is not e
    assert not env.is_multiprocess() and env.process_count() == 1
    coord = coordinator.GangCoordinator(1).start()
    c = coordinator.GangClient(coord.address, rank=0, world_size=1)
    st = c.connect().status()
    c.close()
    coord.stop()
    assert not [m for m, mod in sys.modules.items() if mod is not None
                and (m == "jax" or m.startswith(("jax.", "paddle_tpu.")))]
    print("world", e.world_size, st["status"])
""")


def test_init_parallel_env_at_world_one_with_jax_blocked():
    """``init_parallel_env`` at world 1, the launcher, the coordinator and
    the multi-process tools import and run with JAX and the reference
    unimportable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID"):
        env.pop(k, None)
    res = subprocess.run([sys.executable, "-c", _WORLD_ONE_BLOCKED],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "world 1 ok" in res.stdout
