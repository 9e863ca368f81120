"""Pipeline parallelism in the port (``parallel.pipeline``: ``split_program``,
``PipelineOptimizer``, the GPipe ``PipelineEngine``) against the JAX
package's, on the CPU.

- ``split_program`` gives the reference's sections (op types, boundary,
  feed, output and parameter names) for the same program;
- the counterparts of the five tests of ``tests/test_pipeline.py``: the MLP
  cut in three stages under SGD (4 microbatches), Adam (2), one microbatch
  and a skip connection (a boundary var read by two later stages), each loss
  trajectory held against the reference's ``PipelineEngine`` on the same
  weights (``params_from_numpy`` of the reference's startup) and feeds, and
  against the port's one-device training, within the reference test's
  tolerances (SGD rtol 1e-5 + atol 1e-6, Adam rtol 1e-4 + atol 1e-5), and
  the indivisible batch's ``ValueError``;
- the MLP with its stages on device lists (``[cpu, cpu]``, a stage's dp
  submesh) against the same stages on one device: losses and parameters
  within 1e-5; an empty list raises (the GPT's cases:
  ``test_torch_pipeline_gpt.py``);
- the differentiable section function raises, naming the op, for a
  collective and for an op whose lowering autograd cannot differentiate.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import scope_guard as ref_scope_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.models import transformer as RT
from paddle_tpu.parallel import pipeline as ref_pipe
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.framework.function import program_as_vjp
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.parallel import (PipelineEngine, PipelineOptimizer,
                                       split_program)
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CPU = torch.device("cpu")
SGD_TOL = dict(rtol=1e-5, atol=1e-6)
ADAM_TOL = dict(rtol=1e-4, atol=1e-5)
GPT_LR = 1e-3

REF = SimpleNamespace(root=pt, layers=pt.layers, opt=ref_opt,
                      names=ref_names, T=RT)
PORT = SimpleNamespace(root=ptt, layers=ptt.layers, opt=opt,
                       names=unique_name, T=T)


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh port default programs, scope and names."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


def _mlp(pkg, skip=False):
    layers = pkg.layers
    x = layers.data("x", shape=[8], dtype="float32")
    y = layers.data("y", shape=[1], dtype="int64")
    h1 = layers.fc(x, size=16, act="relu")
    h2 = layers.fc(h1, size=16, act="relu")
    pred = layers.fc(h1 + h2 if skip else h2, size=4, act="softmax")
    loss = layers.mean(layers.cross_entropy(pred, y))
    return [h1, h2], loss


def _gpt_cfg(pkg):
    return pkg.T.BertConfig(vocab_size=64, d_model=64, n_layer=2, n_head=4,
                            d_inner=128, max_pos=16, dropout=0.0)


def _gpt(pkg):
    cps = []
    _, _, loss = pkg.T.build_gpt_pretrain(_gpt_cfg(pkg), 16,
                                          attn_impl="flash", dropout=0.0,
                                          fused_head=False, checkpoints=cps)
    return [cps[0]], loss


def _feeds(which, steps):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(steps):
        if which == "gpt":
            ids = rng.randint(1, 64, (4, 16)).astype(np.int64)
            lab = np.roll(ids, -1, axis=1)
            lab[:, -1] = 0
            out.append({"src_ids": ids, "lm_label": lab})
        else:
            out.append({"x": rng.rand(16, 8).astype(np.float32),
                        "y": rng.randint(0, 4, (16, 1)).astype(np.int64)})
    return out


def _build(pkg, which, optimizer_fn, pipeline, microbatches):
    """(main, startup, pipe or None, loss name), fresh names."""
    main, startup = pkg.root.Program(), pkg.root.Program()
    with pkg.names.guard(), pkg.root.program_guard(main, startup):
        if which == "gpt":
            cuts, loss = _gpt(pkg)
        else:
            cuts, loss = _mlp(pkg, skip=which == "skip")
        pipe = None
        if pipeline:
            pipe_cls = ref_pipe.PipelineOptimizer if pkg is REF else \
                PipelineOptimizer
            pipe = pipe_cls(optimizer_fn(pkg), cut_list=cuts,
                            num_microbatches=microbatches)
            pipe.minimize(loss)
        else:
            optimizer_fn(pkg).minimize(loss)
    return main, startup, pipe, loss.name


def _ref_run(which, optimizer_fn, microbatches, steps):
    """The reference pipeline's losses, its initial weights and final
    parameters."""
    main, startup, pipe, _ = _build(REF, which, optimizer_fn, True,
                                    microbatches)
    sc = RefScope()
    with ref_scope_guard(sc):
        RefExecutor().run(startup, scope=sc, seed=42)
        init = {k: np.asarray(sc.find_var(k))
                for k, v in startup.global_block().vars.items()
                if v.persistable and sc.find_var(k) is not None}
        eng = pipe.create_engine(scope=sc)
        losses = [eng.train_step(f) for f in _feeds(which, steps)]
        eng.sync_to_scope()
        final = {k: np.asarray(sc.find_var(k)) for k in init}
    return init, losses, final


def _port_run(which, optimizer_fn, init, microbatches, steps, pipeline=True,
              devices=None):
    main, startup, pipe, loss = _build(PORT, which, optimizer_fn, pipeline,
                                       microbatches)
    sc = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=42)
    params_from_numpy(sc, init)
    feeds = _feeds(which, steps)
    if not pipeline:
        return [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=sc)[0])) for f in feeds], sc
    eng = pipe.create_engine(devices=devices or [CPU] * len(pipe.sections),
                             scope=sc)
    losses = [eng.train_step(f) for f in feeds]
    eng.sync_to_scope()
    return losses, sc


def _sgd(pkg):
    return pkg.opt.SGDOptimizer(0.1)


def _adam(pkg):
    return pkg.opt.AdamOptimizer(learning_rate=0.01)


def _adam_gpt(pkg):
    return pkg.opt.AdamOptimizer(learning_rate=GPT_LR)


def test_split_program_sections_equal_reference():
    rm, _, rpipe, _ = _build(REF, "skip", _sgd, True, 4)
    pm, _, ppipe, _ = _build(PORT, "skip", _sgd, True, 4)
    rs, ps = rpipe.sections, ppipe.sections
    assert len(ps) == len(rs) == 3
    for r, p in zip(rs, ps):
        assert (p.idx, p.in_names, p.feed_names, p.out_names,
                p.param_names) == (r.idx, r.in_names, r.feed_names,
                                   r.out_names, r.param_names)
        assert [o.type for o in p.program.global_block().ops] == \
            [o.type for o in r.program.global_block().ops]
    # the reference test's assertions, on the port's own split
    h1, h2 = ps[0].out_names[0], ps[1].out_names[0]
    assert ps[0].feed_names == ["x"]
    assert ps[1].in_names == [h1] and ps[2].in_names == [h1, h2]
    assert "y" in ps[2].feed_names
    total = sum(len(s.program.global_block().ops) for s in ps)
    assert total == len(pm.global_block().ops)
    # the reference's errors
    blk = pm.global_block()
    with pytest.raises(ValueError, match="not produced"):
        split_program(pm, ["x"], blk.ops[-1].output_arg_names()[0])
    with pytest.raises(ValueError, match="topologically"):
        split_program(pm, [h2, h1], blk.ops[-1].output_arg_names()[0])


@pytest.mark.parametrize("which,optimizer_fn,microbatches,tol", [
    ("mlp", _sgd, 4, SGD_TOL),
    ("mlp", _adam, 2, ADAM_TOL),
    ("mlp", _sgd, 1, SGD_TOL),
    ("skip", _sgd, 4, SGD_TOL),
], ids=["sgd", "adam", "single_microbatch", "skip_connection"])
def test_pipeline_matches_reference_and_one_device(which, optimizer_fn,
                                                   microbatches, tol):
    steps = 3 if which == "skip" else 4
    init, want, _ = _ref_run(which, optimizer_fn, microbatches, steps)
    got, _ = _port_run(which, optimizer_fn, init, microbatches, steps)
    np.testing.assert_allclose(got, want, **tol)
    single, _ = _port_run(which, optimizer_fn, init, microbatches, steps,
                          pipeline=False)
    np.testing.assert_allclose(got, single, **tol)


def test_pipeline_rejects_indivisible_batch():
    init, _, _ = _ref_run("mlp", _sgd, 4, 0)
    main, startup, pipe, _ = _build(PORT, "mlp", _sgd, True, 4)
    sc = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=sc, seed=42)
    eng = pipe.create_engine(devices=[CPU] * 3, scope=sc)
    rng = np.random.RandomState(0)
    with pytest.raises(ValueError, match="divisible"):
        eng.train_step({"x": rng.rand(10, 8).astype("float32"),
                        "y": rng.randint(0, 4, (10, 1)).astype("int64")})


def _device_list_case(which, optimizer_fn, microbatches):
    """Every stage on ``[cpu, cpu]`` against every stage on one device:
    losses and parameters within 1e-5."""
    init, _, _ = _ref_run(which, optimizer_fn, microbatches, 0)
    n = 3 if which == "mlp" else 2
    one, sc1 = _port_run(which, optimizer_fn, init, microbatches, 3)
    got, sc2 = _port_run(which, optimizer_fn, init, microbatches, 3,
                         devices=[[CPU, CPU]] * n)
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)
    for name in init:
        # qkv.b's key third has an exactly-zero gradient: Adam steps it by
        # +-lr on rounding noise, whatever the order of the sums
        atol = 3 * GPT_LR if name.endswith("qkv.b") else 1e-5
        np.testing.assert_allclose(np.asarray(sc2.find_var(name)),
                                   np.asarray(sc1.find_var(name)),
                                   rtol=0, atol=atol, err_msg=name)


def test_stage_on_device_list_matches_one_device():
    _device_list_case("mlp", _adam, 2)


def test_empty_device_list_and_default_devices_raise(monkeypatch):
    _, startup, pipe, _ = _build(PORT, "mlp", _sgd, True, 2)
    sc = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=sc, seed=42)
    with pytest.raises(ValueError, match="EMPTY device list"):
        pipe.create_engine(devices=[CPU, [], CPU], scope=sc)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="visible cards"):
        pipe.create_engine(scope=sc)
    assert isinstance(pipe.create_engine(devices=[CPU] * 3, scope=sc),
                      PipelineEngine)
    assert opt.PipelineOptimizer is PipelineOptimizer


def test_section_function_refuses_what_it_cannot_differentiate(monkeypatch):
    main = core.Program()
    with ptt.program_guard(main, core.Program()):
        x = ptt.layers.data("x", shape=[4], dtype="float32")
        y = ptt.layers.relu(x)
    blk = main.global_block()
    # a lowering whose output carries no gradient
    info = registry.get_op_info("relu")
    broken = registry.OpInfo("relu", lambda ctx, ins, attrs: {
        "Out": [torch.relu(ins["X"][0]).detach()]}, info.infer)
    monkeypatch.setitem(registry._REGISTRY, "relu", broken)
    fn = program_as_vjp(main, [x.name], [y.name])
    xv = torch.randn(2, 4)
    fn.forward({}, [xv], [CPU])        # no autograd: runs
    with pytest.raises(RuntimeError, match="'relu'.*autograd cannot"):
        fn.vjp({}, [xv], [torch.ones(2, 4)], [CPU])
    monkeypatch.undo()
    # a collective
    blk.append_op("c_allreduce_sum", inputs={"X": [y]},
                  outputs={"Out": [y]})
    with pytest.raises(NotImplementedError, match="c_allreduce_sum"):
        program_as_vjp(main, [x.name], [y.name])
