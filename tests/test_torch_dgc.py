"""Deep Gradient Compression in the port (``parallel/dgc.py``) against the
JAX package's, on the CPU: the tests of ``tests/test_dgc.py`` that need no
dygraph, over the port's collective mode on a ``dp`` mesh of 8 virtual
ranks (the reference's 8 CPU devices), and a parity test.

- before ``rampup_begin_step`` DGC is plain synchronous momentum (also
  Nesterov), rtol 1e-4 + atol 1e-5 as the reference test; the sparse
  phase trains; ``local_grad_clip_norm`` wires ``dgc_clip_by_norm``; each
  run starts from the reference test's initial weights;
- the op's state mechanics on one rank (top-1 of |v| is sent, the chosen
  u/v slots reset);
- parity: at dp 4, sparsity 0.9, ``rampup_begin_step=2``, the per-step
  stacked losses and the U/V state equal the reference's over 5 steps
  (2 dense, 3 sparse) from its initial weights, rtol 1e-5 + atol 1e-6 on
  the losses and 1e-5 + 1e-6 on U/V.  Top-k chooses the same indices in
  both packages while no two |v| tie.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.parallel import DGCGradAllReduce as RefDGC
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework import core, registry, scope, unique_name
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.parallel import DGCGradAllReduce, make_mesh, set_mesh
from paddle_tpu_torch.parallel.dgc import topk_count
from _port_fixtures import collect_garbage_after_module  # noqa: F401

_EPS8 = ",".join(f"127.0.0.1:{6170 + i}" for i in range(8))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh():
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    set_mesh(None)
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)


def _build(L):
    x = L.data("x", shape=[8], dtype="float32")
    y = L.data("y", shape=[1], dtype="int64")
    h = L.fc(x, size=16, act="relu")
    pred = L.fc(h, size=4, act="softmax")
    return L.mean(L.cross_entropy(pred, y))


def _feeds(steps):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(steps):
        x = rng.rand(16, 8).astype("float32")
        y = x[:, :4].argmax(1).reshape(-1, 1).astype("int64")
        out.append({"x": x, "y": y})
    return out


def _reference_init():
    """The reference test's initial weights: its program's startup at seed
    42 (``test_dgc.py:_run``)."""
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), ref_names.guard():
        np.random.seed(0)
        _build(pt.layers)
    sc = RefScope()
    RefExecutor().run(start, scope=sc, seed=42)
    return {p.name: np.asarray(sc.find_var(p.name))
            for p in main.all_parameters()}


def _run(optimizer, transpile, steps=6, eps=_EPS8):
    """The reference test's ``_run`` on the port, from the reference's
    initial weights: dp 8 when transpiled."""
    main, start, sc = ptt.Program(), ptt.Program(), scope.Scope()
    with ptt.program_guard(main, start), ptt.scope_guard(sc), \
            unique_name.guard():
        loss = _build(ptt.layers)
        optimizer().minimize(loss)
        if transpile:
            DGCGradAllReduce().transpile(rank=0, endpoints=eps,
                                         current_endpoint="127.0.0.1:6170")
            n = len(eps.split(","))
            set_mesh(make_mesh({"dp": n}, [CPU] * n))
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(start, seed=42)
        params_from_numpy(sc, _reference_init())
        out = []
        for f in _feeds(steps):
            lv, = exe.run(main, feed=f, fetch_list=[loss.name])
            out.append(float(np.asarray(lv).mean()))
        return out


def test_dgc_rampup_matches_dense_momentum():
    """Before rampup_begin_step DGC is plain sync momentum (the dense
    mean-gradient phase)."""
    dense = _run(lambda: opt.MomentumOptimizer(0.1, 0.9), transpile=False,
                 steps=4)
    dgc = _run(lambda: opt.DGCMomentumOptimizer(
        0.1, 0.9, rampup_begin_step=1000), transpile=True, steps=4)
    np.testing.assert_allclose(dense, dgc, rtol=1e-4, atol=1e-5)


def test_dgc_sparse_phase_trains():
    out = _run(lambda: opt.DGCMomentumOptimizer(
        0.1, 0.9, rampup_begin_step=0, sparsity=[0.9]),
        transpile=True, steps=25)
    first, last = np.mean(out[:5]), np.mean(out[-5:])
    assert last < first - 0.1, f"no progress: {first} -> {last}"


def test_dgc_op_units():
    """dgc_allreduce's state mechanics on one rank: top-1 of |v| is sent,
    the chosen u/v slots reset, the rest accumulate."""
    info = registry.get_op_info("dgc_allreduce")
    assert info.collective
    g = torch.tensor([1.0, -3.0, 0.5, 0.25])
    u, v, s = torch.zeros(4), torch.zeros(4), torch.zeros(1)
    outs, = info.lower([None], [{"X": [g], "U": [u], "V": [v],
                                 "Step": [s]}],
                       {"mu": 0.0, "sparsity": 0.75, "rampup_begin_step": 0})
    np.testing.assert_allclose(outs["Out"][0].numpy(), [0, -3.0, 0, 0],
                               atol=1e-6)
    np.testing.assert_allclose(outs["UOut"][0].numpy(),
                               [1.0, 0, 0.5, 0.25], atol=1e-6)
    np.testing.assert_allclose(outs["VOut"][0].numpy(),
                               [1.0, 0, 0.5, 0.25], atol=1e-6)
    assert float(outs["StepOut"][0][0]) == 1.0
    assert topk_count(4, 0.75) == 1 and topk_count(10, 0.999) == 1


def test_dgc_group_lowering_sums_every_ranks_pairs():
    """Over two ranks the chosen pairs of both are summed and halved, each
    rank gets its own copy, and each rank's u/v reset at its own picks."""
    info = registry.get_op_info("dgc_allreduce")
    g0 = torch.tensor([4.0, 0.0, 1.0, 0.0])
    g1 = torch.tensor([0.0, -2.0, 1.0, 0.0])
    ins = [{"X": [g], "U": [torch.zeros(4)], "V": [torch.zeros(4)],
            "Step": [torch.zeros(1)]} for g in (g0, g1)]
    o0, o1 = info.lower([None, None], ins,
                        {"mu": 0.0, "sparsity": 0.75,
                         "rampup_begin_step": 0})
    np.testing.assert_array_equal(o0["Out"][0].numpy(), [2.0, -1.0, 0, 0])
    np.testing.assert_array_equal(o1["Out"][0].numpy(), [2.0, -1.0, 0, 0])
    assert o0["Out"][0].data_ptr() != o1["Out"][0].data_ptr()
    np.testing.assert_array_equal(o0["VOut"][0].numpy(), [0, 0, 1.0, 0])
    np.testing.assert_array_equal(o1["VOut"][0].numpy(), [0, 0, 1.0, 0])


def test_dgc_nesterov_rampup_parity_and_clip():
    dense = _run(lambda: opt.MomentumOptimizer(0.1, 0.9, use_nesterov=True),
                 transpile=False, steps=4)
    dgc = _run(lambda: opt.DGCMomentumOptimizer(
        0.1, 0.9, use_nesterov=True, rampup_begin_step=1000),
        transpile=True, steps=4)
    np.testing.assert_allclose(dense, dgc, rtol=1e-4, atol=1e-5)
    out = _run(lambda: opt.DGCMomentumOptimizer(
        0.1, 0.9, rampup_begin_step=0, sparsity=[0.9],
        local_grad_clip_norm=1.0), transpile=True, steps=8)
    assert all(np.isfinite(out))


# -- parity ---------------------------------------------------------------------

def _parity_program(port):
    root, names, O, Dgc = ((ptt, unique_name, opt, DGCGradAllReduce) if port
                           else (pt, ref_names, ref_opt, RefDGC))
    eps = ",".join(f"127.0.0.1:{6170 + i}" for i in range(4))
    with names.guard():
        main, start = root.Program(), root.Program()
        with root.program_guard(main, start):
            loss = _build(root.layers)
            O.DGCMomentumOptimizer(0.1, 0.9, rampup_begin_step=2,
                                   sparsity=[0.9]).minimize(loss)
            Dgc().transpile(startup_program=start, main_program=main,
                            rank=0, endpoints=eps,
                            current_endpoint="127.0.0.1:6170")
    return main, start, loss.name


def test_dgc_matches_reference_over_dense_and_sparse_steps():
    ref_main, ref_start, ref_loss = _parity_program(False)
    main, start, loss = _parity_program(True)
    assert [op.type for op in main.global_block().ops] == \
        [op.type for op in ref_main.global_block().ops]
    rsc, rexe = RefScope(), RefExecutor()
    rexe.run(ref_start, scope=rsc, seed=42)
    names = [n for n, v in main.global_block().vars.items()
             if v.persistable and rsc.find_var(n) is not None]
    init = {n: np.asarray(rsc.find_var(n)) for n in names}
    sc, exe = scope.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(start, scope=sc, seed=42)
    params_from_numpy(sc, init)
    set_mesh(make_mesh({"dp": 4}, [CPU] * 4))
    exe.verify_replicas = True
    uv = [n for n in names if n.endswith(("@DGC_U", "@DGC_V"))]
    assert len(uv) == 8
    for step, f in enumerate(_feeds(5)):
        want = np.asarray(rexe.run(ref_main, feed=f, fetch_list=[ref_loss],
                                   scope=rsc)[0])
        got, = exe.run(main, feed=f, fetch_list=[loss], scope=sc)
        assert got.shape == want.shape == (4,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"step {step}")
        for n in uv:
            np.testing.assert_allclose(
                sc.find_var(n).numpy(), np.asarray(rsc.find_var(n)),
                rtol=1e-5, atol=1e-6, err_msg=f"{n} step {step}")
    # the sparse steps left most of V in place (k = 10% a rank)
    v = sc.find_var(next(n for n in uv if n.endswith("@DGC_V"))).numpy()
    assert np.count_nonzero(v) > v.size // 2
