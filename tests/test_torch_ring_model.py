"""BERT through the ``ring_attention`` op: the port against itself and
against the JAX package, on the CPU (after ``tests/test_attention_model.py``).

The toy BERT (vocab 64, d 16, 2 layers, 2 heads, d_inner 32, seq 16,
dropout 0) takes 3 SGD steps (lr 0.05) on seeded feeds:

- on the port, ``attn_impl="ring"`` under ``make_mesh({"sp": 8}, [cpu] *
  8)`` (8 virtual ranks, 2 tokens each) gives the losses of ``"base"``,
  and so does ``"ring"`` with no mesh (the op then runs flash attention):
  rtol 1e-4, atol 1e-5, the reference test's tolerances;
- the port's ring run matches the reference's ring run
  (``make_mesh({"sp": 8})`` over the conftest's 8 CPU devices, under
  ``shard_map``), both from the reference's initial weights
  (``params_from_numpy``): rtol 1e-5;
- the ring program serializes as the reference's does;
- the op rings only under a mesh whose ``sp`` axis has more than one rank;
- ``make_mesh`` keeps the reference's contract: sizes that do not multiply
  to the device count raise, and with no card ``make_mesh()`` raises.

Nothing here starts a process or a ``torch.distributed`` group.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.models import transformer as RT
from paddle_tpu.parallel import make_mesh as ref_make_mesh
from paddle_tpu.parallel import mesh as ref_pmesh
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework import core, scope, unique_name
from paddle_tpu_torch.kernels import ring_attention as ra
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.parallel import make_mesh, mesh as pmesh
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CFG = dict(vocab_size=64, d_model=16, n_layer=2, n_head=2, d_inner=32,
           max_pos=32, dropout=0.0)
SEQ, BATCH, STEPS = 16, 4, 3
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    """Fresh port default programs, scope, names and mesh for every test."""
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)
    pmesh.set_mesh(None)


def _feeds():
    rng = np.random.RandomState(3)
    return [{"src_ids": rng.randint(1, 64, (BATCH, SEQ)).astype("int64"),
             "pos_ids": np.tile(np.arange(SEQ), (BATCH, 1)).astype("int64"),
             "lm_label": rng.randint(0, 64, (BATCH, SEQ)).astype("int64")}
            for _ in range(STEPS)]


def _build(pkg, attn_impl):
    if pkg == "ref":
        main, startup = RefProgram(), RefProgram()
        with ref_guard(main, startup), ref_names.guard():
            _, _, loss = RT.build_bert_pretrain(RT.BertConfig(**CFG), SEQ,
                                                attn_impl=attn_impl)
            ref_opt.SGDOptimizer(learning_rate=0.05).minimize(loss)
    else:
        main, startup = core.Program(), core.Program()
        with core.program_guard(main, startup), unique_name.guard():
            _, _, loss = T.build_bert_pretrain(T.BertConfig(**CFG), SEQ,
                                               attn_impl=attn_impl)
            opt.SGDOptimizer(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _ref_train(attn_impl, mesh):
    """The reference's 3 steps (``test_attention_model._train_bert``) and
    its initial weights."""
    main, startup, loss = _build("ref", attn_impl)
    ref_scope = RefScope()
    exe = RefExecutor()
    exe.run(startup, scope=ref_scope, seed=11)
    init = {v.name: np.array(ref_scope.find_var(v.name))
            for v in startup.global_block().vars.values()}
    old = ref_pmesh._current_mesh
    ref_pmesh._current_mesh = mesh
    try:
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                           scope=ref_scope)[0]))
                  for f in _feeds()]
    finally:
        ref_pmesh._current_mesh = old
    return losses, init


def _port_train(attn_impl, mesh, init):
    main, _, loss = _build("port", attn_impl)
    port_scope = ptt.io.params_from_numpy(scope.Scope(), init)
    exe = ptt.Executor(ptt.CPUPlace())
    pmesh.set_mesh(mesh)
    try:
        return [float(exe.run(main, feed=f, fetch_list=[loss],
                              scope=port_scope)[0]) for f in _feeds()]
    finally:
        pmesh.set_mesh(None)


@pytest.fixture(scope="module")
def reference():
    """The reference's base and ring runs (ring over its 8-device mesh)."""
    base, init = _ref_train("base", None)
    ring, init_ring = _ref_train("ring", ref_make_mesh({"sp": 8}))
    for name, arr in init.items():
        np.testing.assert_array_equal(init_ring[name], arr)
    return {"base": base, "ring": ring, "init": init}


def test_port_ring_matches_port_base(reference):
    init = reference["init"]
    base = _port_train("base", None, init)
    ring = _port_train("ring", make_mesh({"sp": 8}, [CPU] * 8), init)
    np.testing.assert_allclose(base, ring, rtol=1e-4, atol=1e-5)
    assert ring[-1] < ring[0]


def test_port_ring_without_a_mesh_runs_flash(reference):
    init = reference["init"]
    base = _port_train("base", None, init)
    ring = _port_train("ring", None, init)
    np.testing.assert_allclose(base, ring, rtol=1e-4, atol=1e-5)


def test_port_ring_matches_reference_ring(reference):
    got = _port_train("ring", make_mesh({"sp": 8}, [CPU] * 8),
                      reference["init"])
    np.testing.assert_allclose(got, reference["ring"], rtol=1e-5)
    np.testing.assert_allclose(got, reference["base"], rtol=1e-4, atol=1e-5)


def test_ring_program_serializes_like_the_reference():
    ref_main, ref_startup, _ = _build("ref", "ring")
    main, startup, _ = _build("port", "ring")
    for ours, theirs in ((main, ref_main), (startup, ref_startup)):
        assert json.loads(ours.serialize_to_string()) == \
            json.loads(theirs.serialize_to_string())
    assert [op.type for op in main.global_block().ops].count(
        "ring_attention") == CFG["n_layer"]


@pytest.mark.parametrize("axes,rings", [({"sp": 8}, True),
                                        ({"dp": 8}, False),
                                        ({"sp": 1}, False),
                                        ({"dp": 2, "sp": 4}, True)],
                         ids=["sp8", "dp8", "sp1", "dp2_sp4"])
def test_op_rings_only_over_an_sp_axis(monkeypatch, reference, axes, rings):
    calls = []
    real = ra.ring_attention

    def counted(q, k, v, mesh, axis_name="sp", **kw):
        calls.append(mesh.shape[axis_name])
        return real(q, k, v, mesh, axis_name, **kw)

    monkeypatch.setattr(ra, "ring_attention", counted)
    n = int(np.prod(list(axes.values())))
    got = _port_train("ring", make_mesh(axes, [CPU] * n), reference["init"])
    assert calls == ([axes["sp"]] * CFG["n_layer"] * STEPS if rings else [])
    np.testing.assert_allclose(got, reference["base"], rtol=1e-4, atol=1e-5)


def test_make_mesh_keeps_the_reference_contract(monkeypatch):
    with pytest.raises(ValueError, match="needs 3 devices, have 4"):
        make_mesh({"sp": 3}, [CPU] * 4)
    mesh = make_mesh({"sp": 2, "dp": 2}, [CPU] * 4)
    assert mesh.axis_names == ("dp", "sp") and mesh.devices.shape == (2, 2)
    assert pmesh.mesh_axis_sizes(mesh) == {"dp": 2, "sp": 2}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"sp": 1})
