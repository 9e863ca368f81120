"""The inference engine across packages, on the host: an artifact either
package's ``save_inference_model`` writes loads in the other's predictor,
and the two predictors agree.

- the MLP of ``tests/test_io_inference.py``, both ways, within 1e-5;
- a 2-layer, d-64 GPT at T 1024 built with ``attn_impl="base"`` (the
  in-graph causal mask reaches ``flash_attention`` as its Bias), saved by
  ``paddle_tpu``: 2 ``flash_attention`` ops, no softmax, 9 ``fc``, within
  1e-4 of the reference's predictor; and a long attention chain with a
  frozen persistable causal mask, which becomes ``causal=True`` with no
  Bias, within 1e-4;
- a toy ResNet (two bottleneck blocks, BN statistics moved off their
  initial values) saved by the port, through ``conv_bn_fuse_pass`` and
  ``conv_elementwise_add_act_fuse_pass``, within 1e-5 of the reference's
  predictor (both fold in float64 from the same values and store float32,
  so only the convolutions' summation orders differ);
- the engine cache's hit and miss counts and a re-save's miss and
  eviction, ``ZeroCopyTensor``, ``NativePaddlePredictor`` (no pass; the
  GPT's exact GELU where ``fc`` takes the tanh form), and a predictor that
  asks for the card raising when there is none;
- ``framework.function``: a startup program's values, a block as a
  function and a Momentum train step against the reference's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import layers as L
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu import inference as ref_inf
from paddle_tpu_torch import inference as inf
from paddle_tpu_torch import layers as PL
from paddle_tpu_torch.framework import core, scope, unique_name
from _port_fixtures import collect_garbage_after_module  # noqa: F401

MLP_TOL = dict(rtol=1e-5, atol=1e-5)
GPT_TOL = dict(rtol=1e-4, atol=1e-4)
RESNET_TOL = dict(rtol=1e-5, atol=1e-5)


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


def _host_config(path, ir_optim=True):
    cfg = inf.AnalysisConfig(str(path))
    cfg.disable_gpu()
    cfg.switch_ir_optim(ir_optim)
    return cfg


def _run_port(pred, name, x):
    return pred.run([inf.PaddleTensor(x, name=name)])[0].as_ndarray()


def _run_ref(path, name, x, native=False):
    cls = ref_inf.NativePaddlePredictor if native else \
        ref_inf.create_paddle_predictor
    pred = cls(ref_inf.AnalysisConfig(str(path)))
    return pred.run([ref_inf.PaddleTensor(x, name=name)])[0].as_ndarray()


def _ref_mlp(path):
    main, startup = RefProgram(), RefProgram()
    with ref_guard(main, startup):
        x = L.data("x", shape=[4], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        pred = L.fc(L.fc(x, size=8, act="relu"), size=1)
        L.mean(L.square_error_cost(pred, y))
    s = RefScope()
    exe = RefExecutor()
    exe.run(startup, scope=s, seed=1)
    pt.save_inference_model(str(path), ["x"], [pred], exe,
                            main_program=main, scope=s)


def _port_mlp(path, seed=1):
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup):
        x = PL.data("x", shape=[4], dtype="float32")
        pred = PL.fc(PL.fc(x, size=8, act="relu"), size=1)
    s = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=s, seed=seed)
    ptt.save_inference_model(str(path), ["x"], [pred], exe,
                             main_program=main, scope=s)


def test_mlp_artifacts_load_both_ways(tmp_path):
    xs = np.random.RandomState(2).randn(5, 4).astype(np.float32)
    _ref_mlp(tmp_path / "ref")
    pred = inf.create_paddle_predictor(_host_config(tmp_path / "ref"))
    assert [op.type for op in pred.program.global_block().ops] == \
        ["fc", "fc"]
    assert pred.pass_counts["fc_fuse_count"] == 2
    np.testing.assert_allclose(_run_port(pred, "x", xs),
                               _run_ref(tmp_path / "ref", "x", xs),
                               **MLP_TOL)
    _port_mlp(tmp_path / "port")
    prog, feeds, fetches = pt.load_inference_model(
        str(tmp_path / "port"), scope=RefScope())
    assert feeds == ["x"] and len(fetches) == 1
    pred = inf.create_paddle_predictor(_host_config(tmp_path / "port"))
    np.testing.assert_allclose(_run_port(pred, "x", xs),
                               _run_ref(tmp_path / "port", "x", xs),
                               **MLP_TOL)


def test_gpt_artifact_fuses_attention_onto_flash(tmp_path):
    from paddle_tpu.models import transformer as RT
    t = 1024
    cfg = RT.BertConfig(vocab_size=64, d_model=64, n_layer=2, n_head=2,
                        d_inner=128, max_pos=t, dropout=0.0)
    main, startup = RefProgram(), RefProgram()
    with ref_guard(main, startup):
        _, logits = RT.build_gpt_serving(cfg, t, attn_impl="base")
    s = RefScope()
    exe = RefExecutor()
    exe.run(startup, scope=s, seed=3)
    pt.save_inference_model(str(tmp_path), ["src_ids"], [logits], exe,
                            main_program=main, scope=s)
    ids = np.random.RandomState(0).randint(1, 64, (1, t)).astype(np.int64)
    pred = inf.create_paddle_predictor(_host_config(tmp_path))
    ops = pred.program.global_block().ops
    types = [op.type for op in ops]
    assert types.count("flash_attention") == 2 and "softmax" not in types
    assert types.count("fc") == 9 and "mul" not in types
    assert all(op.input("Bias") and not op.attrs["causal"]
               for op in ops if op.type == "flash_attention")
    got = _run_port(pred, "src_ids", ids)
    assert got.shape == (1, t, 64)
    np.testing.assert_allclose(got, _run_ref(tmp_path, "src_ids", ids),
                               **GPT_TOL)
    # the native predictor runs the dense chain and the exact GELU, as
    # the reference's does; fc's tanh GELU moves the logits off it
    native = inf.NativePaddlePredictor(_host_config(tmp_path))
    assert "fc" not in [op.type for op in native.program.global_block().ops]
    nat = _run_port(native, "src_ids", ids)
    np.testing.assert_allclose(
        nat, _run_ref(tmp_path, "src_ids", ids, native=True), **GPT_TOL)
    assert np.abs(nat - got).max() > 1e-5


def test_frozen_causal_mask_becomes_causal(tmp_path):
    b, h, t, d = 1, 2, 1024, 8
    rng = np.random.RandomState(4)
    qv = (rng.randn(b, h, t, d) * 0.3).astype(np.float32)
    main, startup = RefProgram(), RefProgram()
    with ref_guard(main, startup):
        from paddle_tpu import initializer
        q = L.data("q", shape=[h, t, d], dtype="float32")
        k = L.create_parameter([b, h, t, d], "float32", name="fk")
        v = L.create_parameter([b, h, t, d], "float32", name="fv")
        mask = L.create_parameter(
            [t, t], "float32", name="causal_mask",
            default_initializer=initializer.NumpyArrayInitializer(
                np.triu(np.full((t, t), -1e9, np.float32), k=1)))
        scores = L.matmul(q, k, transpose_y=True, alpha=0.35)
        out = L.matmul(L.softmax(scores + mask), v)
    s = RefScope()
    exe = RefExecutor()
    exe.run(startup, scope=s, seed=3)
    pt.save_inference_model(str(tmp_path), ["q"], [out], exe,
                            main_program=main, scope=s)
    pred = inf.create_paddle_predictor(_host_config(tmp_path))
    flash, = [op for op in pred.program.global_block().ops
              if op.type == "flash_attention"]
    assert flash.attrs["causal"] and not flash.input("Bias")
    np.testing.assert_allclose(_run_port(pred, "q", qv),
                               _run_ref(tmp_path, "q", qv), **GPT_TOL)


def test_port_resnet_artifact_folds_conv_bn(tmp_path):
    from paddle_tpu_torch.models import resnet
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup):
        img = PL.data("image", shape=[16, 8, 8], dtype="float32")
        h = resnet.bottleneck_block(img, 16, 1, "bb0", is_test=True)
        h = resnet.bottleneck_block(h, 16, 2, "bb1", is_test=True)
        pred = PL.fc(PL.pool2d(h, pool_type="avg", global_pooling=True),
                     size=4, act="softmax")
    s = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=s, seed=5)
    rng = np.random.RandomState(6)
    for v in main.list_vars():
        if v.name.endswith((".bn.mean", ".bn.var", ".bn.scale")):
            val = rng.rand(*v.shape).astype(np.float32)
            s.set_var(v.name, torch.from_numpy(
                val + (0.5 if v.name.endswith((".var", ".scale")) else 0)))
    ptt.save_inference_model(str(tmp_path), ["image"], [pred], exe,
                             main_program=main, scope=s)
    xs = rng.rand(3, 16, 8, 8).astype(np.float32)
    p = inf.create_paddle_predictor(_host_config(tmp_path))
    types = [op.type for op in p.program.global_block().ops]
    # 8 conv + BN pairs (3 a block and 2 shortcuts), 4 of them followed
    # by relu; 2 residual add + relu
    assert p.pass_counts["conv_bn_fuse_count"] == 8
    assert types.count("conv2d_fusion") == 4 and "batch_norm" not in types
    assert types.count("fused_elemwise_activation") == 2
    got = _run_port(p, "image", xs)
    np.testing.assert_allclose(got, _run_ref(tmp_path, "image", xs),
                               **RESNET_TOL)
    native = _run_port(inf.NativePaddlePredictor(_host_config(tmp_path)),
                       "image", xs)
    np.testing.assert_allclose(got, native, **RESNET_TOL)


def test_engine_cache_hits_and_a_resave_misses(tmp_path):
    ctr = inf.api._ENGINE_CTR
    inf.clear_engine_cache()
    _port_mlp(tmp_path)
    hit, miss = ctr.value(cache="hit"), ctr.value(cache="miss")
    p1 = inf.create_paddle_predictor(_host_config(tmp_path))
    p2 = inf.create_paddle_predictor(_host_config(tmp_path))
    assert p1._engine is p2._engine and p1._fn is p2._fn
    assert (ctr.value(cache="hit") - hit, ctr.value(cache="miss") - miss) \
        == (1, 1)
    # ir_optim off is another engine
    inf.NativePaddlePredictor(_host_config(tmp_path))
    assert ctr.value(cache="miss") - miss == 2
    xs = np.ones((2, 4), np.float32)
    before = _run_port(p1, "x", xs)
    import time
    time.sleep(0.01)
    _port_mlp(tmp_path, seed=2)           # new weights at the same path
    p3 = inf.create_paddle_predictor(_host_config(tmp_path))
    assert p3._engine is not p1._engine
    assert ctr.value(cache="miss") - miss == 3
    assert not np.allclose(_run_port(p3, "x", xs), before)
    root_keys = [k for k in inf.api._ENGINE_CACHE if k[3]]
    assert len(root_keys) == 1             # the stale engine went


def test_zero_copy_tensors(tmp_path):
    _ref_mlp(tmp_path)
    pred = inf.create_paddle_predictor(_host_config(tmp_path))
    assert pred.get_input_names() == ["x"]
    xs = np.random.RandomState(3).randn(4, 4).astype(np.float32)
    pred.get_input_tensor("x").copy_from_cpu(xs)
    pred.zero_copy_run()
    out = pred.get_output_tensor(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_allclose(out, _run_ref(tmp_path, "x", xs), **MLP_TOL)


def test_predictor_on_the_card_needs_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the predictor runs on it")
    _port_mlp(tmp_path)
    cfg = inf.AnalysisConfig(str(tmp_path))
    assert cfg.use_gpu()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inf.create_paddle_predictor(cfg)
    cfg.enable_use_gpu(device_id=1)
    assert cfg.gpu_device_id() == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inf.NativePaddlePredictor(cfg)


def test_program_functions_match_the_reference():
    from paddle_tpu import optimizer as ref_opt
    from paddle_tpu.framework import function as ref_fn
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import function as fn

    rng = np.random.RandomState(7)
    xs = rng.randn(6, 4).astype(np.float32)
    ys = rng.randn(6, 1).astype(np.float32)

    def build(layers_mod, opt_mod, prog_cls, guard):
        main, startup = prog_cls(), prog_cls()
        with guard(main, startup):
            x = layers_mod.data("x", shape=[4], dtype="float32")
            y = layers_mod.data("y", shape=[1], dtype="float32")
            pred = layers_mod.fc(x, size=1, param_attr="w", bias_attr="b")
            d = pred - y
            loss = layers_mod.mean(d * d)
            opt_mod.MomentumOptimizer(0.1, 0.9).minimize(loss)
        return main, startup, pred, loss

    rmain, rstart, rpred, rloss = build(L, ref_opt, RefProgram, ref_guard)
    pmain, pstart, ppred, ploss = build(PL, optimizer, core.Program,
                                        core.program_guard)
    rstate = ref_fn.init_program_params(rstart, seed=1)
    pstate = fn.init_program_params(pstart, seed=1, place=ptt.CPUPlace())
    assert sorted(pstate) == sorted(rstate)
    pstate = {n: torch.from_numpy(np.array(rstate[n])) for n in rstate}
    infer = fn.program_as_function(pmain.clone(for_test=True)._prune(
        [ppred.name]), ["x"], [ppred])
    want = ref_fn.program_as_function(rmain.clone(for_test=True)._prune(
        [rpred.name]), ["x"], [rpred])(rstate, xs)
    np.testing.assert_allclose(infer(pstate, xs)[0].numpy(),
                               np.asarray(want[0]), **MLP_TOL)
    names = sorted(rstate)
    rstep = ref_fn.program_as_train_step(rmain, ["x", "y"], [rloss], names)
    pstep = fn.program_as_train_step(pmain, ["x", "y"], [ploss], names)
    for _ in range(2):
        (rl,), rstate = rstep(rstate, xs, ys)
        (pl,), pstate = pstep(pstate, torch.from_numpy(xs), ys)
        np.testing.assert_allclose(float(pl), float(rl), rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(pstate[n].numpy(), np.asarray(rstate[n]),
                                   err_msg=n, **MLP_TOL)
