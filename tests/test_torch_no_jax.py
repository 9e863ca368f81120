"""The port stands alone: no JAX and nothing of ``paddle_tpu``.

- in a subprocess where ``import jax`` and ``import paddle_tpu`` fail,
  importing ``paddle_tpu_torch``, serving one request (through
  ``CompiledProgram``'s verifier and passes), taking Adam steps of a tiny
  GPT, with the fusion autotuner on in the last, one Momentum step of a
  toy ResNet through the graph-fusion pass, and the measurement tools'
  chains, skeletons and peak table (``paddle_tpu_torch.tools``) on the CPU
  works;
- a source scan finds no ``jax`` or ``paddle_tpu`` import in the package or
  in ``chip_smoke.py``;
- ``Executor()`` (the card by default) raises when there is no GPU.
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

import paddle_tpu_torch as ptt

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
    assert not [m for m, mod in sys.modules.items() if mod is not None
                and (m == "jax" or m.startswith(("jax.", "paddle_tpu.")))]
    print("served", out[0].shape, "trained", float(l0), float(l1),
          "resnet", float(rl))
""")


def test_port_imports_and_serves_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "served (5, 48)" in res.stdout


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
    assert {"paddle_tpu_torch/analysis/fusion.py",
            "paddle_tpu_torch/analysis/verifier.py",
            "paddle_tpu_torch/compiler.py",
            "paddle_tpu_torch/debugger.py",
            "paddle_tpu_torch/framework/ir.py",
            "paddle_tpu_torch/kernels/conv_bn.py",
            "paddle_tpu_torch/kernels/dense_epilogue.py",
            "paddle_tpu_torch/kernels/layer_norm.py",
            "paddle_tpu_torch/models/resnet.py",
            "paddle_tpu_torch/monitor.py",
            "paddle_tpu_torch/ops/fused_ops.py",
            "paddle_tpu_torch/kernels/attn_skeleton.py",
            "paddle_tpu_torch/tools/__init__.py",
            "paddle_tpu_torch/tools/timing.py",
            "paddle_tpu_torch/tools/rn50_fused_bench.py",
            "paddle_tpu_torch/tools/attn_shape_ceiling.py"} <= scanned
    offenders = []
    for path in _sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, REPO)}: "
                                 f"{m.group(0).strip()}")
    assert offenders == []


def test_default_executor_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Executor() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.serving.InferenceServer(lambda seq: None, ptt.Scope())
    assert ptt.Executor(ptt.CPUPlace()).device == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 2
    assert '"ok"' not in res.stdout and "no CUDA device" in res.stderr
