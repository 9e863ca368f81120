"""Mixture of experts in the port (``ops.moe_ops``' ``switch_ffn``,
``layers.switch_moe_ffn``, and the op under an ``ep`` axis:
``analysis.sharding``'s rule and ``parallel.spmd``'s ``spmd_switch_ffn``)
against the JAX package, on the CPU.

- ``switch_ffn``'s ``Out``, ``AuxLoss`` and the gradient of every input
  (through the generic grad: autograd of the lowering) against the
  reference's lowering and ``jax.vjp`` on the same numpy inputs, within
  rtol 1e-5 + atol 1e-5, for relu and gelu (the tanh form, as
  ``jax.nn.gelu``'s default), at a capacity that drops tokens and one that
  does not;
- the counterparts of the four tests of ``tests/test_moe.py``: one expert is
  the dense FFN and its aux loss exactly 1; one SGD step moves the gate and
  every expert weight; a rigged gate's overflow tokens give zero rows; and
  the reference test's MoE (B 8, T 4, d 16, E 4) trained 4 Adam steps from
  the reference's initial weights under ``with_distributed(axes={"ep": 2,
  "dp": 4})`` over ``[cpu] * 8`` equals the port's and the reference's
  one-device runs within rtol 2e-4 + atol 1e-5 (the reference test's
  bound), and the loss falls;
- the plan: a ``c_alltoall`` over ``ep`` of every rank's ``[E, C, d]``
  dispatch buffer, gathers over ``ep`` of the experts' outputs and (in the
  backward) of the buffers' gradients, each rank's ``[2, E]`` float32
  counts over ``dp``, and the per-parameter dp gradient sync; every byte
  counted by hand, and ``paddle_tpu_collective_bytes_total`` moves by
  exactly steps x the plan's payload;
- each rank holds E/2 experts' weights and Adam moments (per-rank bytes
  half the whole).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as pt
import paddle_tpu.ops.moe_ops  # noqa: F401  (registers switch_ffn)
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import registry as ref_registry
from paddle_tpu.framework import scope_guard as ref_scope_guard
from paddle_tpu.framework import unique_name as ref_names
import paddle_tpu_torch as ptt
from paddle_tpu_torch import monitor
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.analysis.sharding import plan_sharding
from paddle_tpu_torch.framework import (core, registry, scope,
                                        unique_name)
from paddle_tpu_torch.framework.executor import LowerCtx
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.parallel import ShardedValue, set_mesh
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
EP_TOL = dict(rtol=2e-4, atol=1e-5)
BYTES = "paddle_tpu_collective_bytes_total"
SLOTS = ("X", "GateW", "W1", "B1", "W2", "B2")


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh port default programs, scope and names; no mesh after."""
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


def _inputs(B, T, d, F, E, seed=0):
    rng = np.random.RandomState(seed)
    return {"X": rng.randn(B, T, d).astype(np.float32),
            "GateW": rng.randn(d, E).astype(np.float32),
            "W1": (rng.randn(E, d, F) * 0.3).astype(np.float32),
            "B1": (rng.randn(E, F) * 0.1).astype(np.float32),
            "W2": (rng.randn(E, F, d) * 0.3).astype(np.float32),
            "B2": (rng.randn(E, d) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("cf", [0.5, 4.0], ids=["drops", "keeps"])
def test_switch_ffn_outputs_and_grads_equal_reference(cf, act):
    B, T, d, F, E = 2, 16, 8, 12, 4
    vals = _inputs(B, T, d, F, E)
    attrs = {"capacity_factor": cf, "act": act}
    rng = np.random.RandomState(1)
    g_out = rng.randn(B, T, d).astype(np.float32)
    g_aux = np.float32(0.7)

    ref = ref_registry.get_op_info("switch_ffn").lower

    def ref_f(*xs):
        o = ref(None, {s: [x] for s, x in zip(SLOTS, xs)}, attrs)
        return o["Out"][0], o["AuxLoss"][0]

    (r_out, r_aux), vjp = jax.vjp(ref_f, *(jnp.asarray(vals[s])
                                           for s in SLOTS))
    r_grads = vjp((jnp.asarray(g_out), jnp.asarray(g_aux)))

    info = registry.get_op_info("switch_ffn")
    ctx = LowerCtx(CPU, 0)
    ins = {s: [torch.from_numpy(vals[s])] for s in SLOTS}
    fwd = registry.run_forward(info, ctx, ins, attrs)
    out, aux = fwd[1]["Out"][0], fwd[1]["AuxLoss"][0]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(r_out), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(r_aux), **TOL)
    grads = registry.generic_grad_lower(
        ctx, {"OG$Out": [torch.from_numpy(g_out)],
              "OG$AuxLoss": [torch.tensor(g_aux)]},
        dict(attrs, __fwd_type__="switch_ffn"), forward=fwd)
    for s, want in zip(SLOTS, r_grads):
        np.testing.assert_allclose(grads["IG$" + s][0].numpy(),
                                   np.asarray(want), err_msg=s, **TOL)
    # the drop case drops: some token's row is zero
    rows = np.abs(out.detach().numpy().reshape(-1, d)).max(1)
    cap = int(np.ceil(cf * B * T / E))
    assert (rows == 0).any() == (cap * E < B * T or cf < 1)


def _np_dense_ffn(x, w1, b1, w2, b2):
    return np.maximum(x @ w1 + b1, 0.0) @ w2 + b2


def _exe():
    return ptt.Executor(ptt.CPUPlace())


def test_switch_ffn_e1_matches_dense_ffn():
    B, T, d, F = 2, 6, 8, 16
    sc = ptt.Scope()
    with ptt.scope_guard(sc), ptt.program_guard(core.Program(),
                                                core.Program()):
        x = ptt.layers.data("x", shape=[T, d], dtype="float32")
        out, aux = ptt.layers.switch_moe_ffn(x, num_experts=1, d_inner=F,
                                             capacity_factor=2.0,
                                             param_prefix="moe1")
        exe = _exe()
        exe.run(ptt.default_startup_program(), scope=sc)
        xv = np.random.RandomState(0).randn(B, T, d).astype(np.float32)
        ov, av = exe.run(feed={"x": xv}, fetch_list=[out.name, aux.name],
                         scope=sc)
        w = {n: np.asarray(sc.find_var(f"moe1.{n}"))[0]
             for n in ("w1", "b1", "w2", "b2")}
    want = _np_dense_ffn(xv.reshape(-1, d), w["w1"], w["b1"], w["w2"],
                         w["b2"]).reshape(B, T, d)
    np.testing.assert_allclose(np.asarray(ov), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(np.asarray(av)), 1.0, rtol=1e-6)


def test_switch_ffn_gradients_flow():
    B, T, d, F, E = 2, 8, 8, 16, 4
    sc = ptt.Scope()
    with ptt.scope_guard(sc), ptt.program_guard(core.Program(),
                                                core.Program()):
        x = ptt.layers.data("x", shape=[T, d], dtype="float32")
        out, aux = ptt.layers.switch_moe_ffn(x, num_experts=E, d_inner=F,
                                             param_prefix="moeg")
        loss = ptt.layers.mean(out * out) + 0.01 * aux
        opt.SGDOptimizer(learning_rate=1.0).minimize(loss)
        exe = _exe()
        exe.run(ptt.default_startup_program(), scope=sc)
        names = ["moeg.gate.w", "moeg.w1", "moeg.b1", "moeg.w2", "moeg.b2"]
        before = {n: np.asarray(sc.find_var(n)).copy() for n in names}
        xv = np.random.RandomState(1).randn(B, T, d).astype(np.float32)
        lv, = exe.run(feed={"x": xv}, fetch_list=[loss.name], scope=sc)
        assert np.isfinite(float(np.asarray(lv)))
        after = {n: np.asarray(sc.find_var(n)) for n in names}
    for n in names:
        assert np.abs(after[n] - before[n]).max() > 0, f"no gradient: {n}"


def test_switch_ffn_capacity_drop():
    B, T, d, F, E = 1, 8, 4, 8, 2
    S = B * T
    cap = int(np.ceil(1.25 * S / E))          # 5 < 8 tokens
    sc = ptt.Scope()
    with ptt.scope_guard(sc), ptt.program_guard(core.Program(),
                                                core.Program()):
        x = ptt.layers.data("x", shape=[T, d], dtype="float32")
        out, _ = ptt.layers.switch_moe_ffn(x, num_experts=E, d_inner=F,
                                           param_prefix="moec")
        exe = _exe()
        exe.run(ptt.default_startup_program(), scope=sc)
        # every token picks expert 0: column 0 sums the positive features
        sc.set_var("moec.gate.w", torch.from_numpy(np.stack(
            [np.ones(d), -np.ones(d)], axis=1).astype(np.float32)))
        xv = np.abs(np.random.RandomState(2).randn(B, T, d)) \
            .astype(np.float32) + 0.1
        ov, = exe.run(feed={"x": xv}, fetch_list=[out.name], scope=sc)
    flat = np.asarray(ov).reshape(S, d)
    assert np.abs(flat[:cap]).max() > 0, "kept tokens must produce output"
    np.testing.assert_allclose(flat[cap:], 0.0,
                               err_msg="overflow tokens must be dropped")


# -- ep x dp -----------------------------------------------------------------

B_, T_, D_, F_, E_ = 8, 4, 16, 32, 4


def _moe_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with (ref_names if pkg is pt else unique_name).guard(), \
            pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[T_, D_], dtype="float32")
        y = pkg.layers.data("y", shape=[T_, D_], dtype="float32")
        out, aux = pkg.layers.switch_moe_ffn(x, num_experts=E_,
                                             d_inner=F_, param_prefix="moep")
        loss = pkg.layers.mean((out - y) * (out - y)) + 0.1 * aux
        (ref_opt if pkg is pt else opt).AdamOptimizer(
            learning_rate=1e-2).minimize(loss)
    return main, startup, loss.name


def _feed():
    rng = np.random.RandomState(5)
    return {"x": rng.randn(B_, T_, D_).astype(np.float32),
            "y": rng.randn(B_, T_, D_).astype(np.float32)}


def _ref_losses(steps=4):
    main, startup, loss = _moe_program(pt)
    sc = RefScope()
    with ref_scope_guard(sc):
        exe = RefExecutor()
        exe.run(startup, scope=sc, seed=99)
        init = {k: np.asarray(sc.find_var(k))
                for k, v in startup.global_block().vars.items()
                if v.persistable and sc.find_var(k) is not None}
        losses = [float(np.asarray(exe.run(main, feed=_feed(),
                                           fetch_list=[loss])[0]))
                  for _ in range(steps)]
    return init, losses


def _port_losses(init, ep, steps=4):
    main, startup, loss = _moe_program(ptt)
    sc = ptt.Scope()
    exe = _exe()
    exe.run(startup, scope=sc, seed=99)
    params_from_numpy(sc, init)
    prog = main
    if ep:
        prog = ptt.CompiledProgram(main).with_distributed(
            axes={"ep": 2, "dp": 4}, devices=[CPU] * 8)
    losses = [float(np.asarray(exe.run(prog, feed=_feed(), fetch_list=[loss],
                                       scope=sc)[0])) for _ in range(steps)]
    return losses, main, loss, sc


def _bytes():
    return monitor.counter_totals().get(BYTES, 0)


def test_switch_ffn_ep_sharded_matches_replicated_and_reference():
    init, ref = _ref_losses()
    single, *_ = _port_losses(init, ep=False)
    np.testing.assert_allclose(single, ref, **EP_TOL)
    before = _bytes()
    ep, main, loss, sc = _port_losses(init, ep=True)
    moved = _bytes() - before
    assert all(np.isfinite(single)) and all(np.isfinite(ep))
    np.testing.assert_allclose(ep, single, **EP_TOL)
    np.testing.assert_allclose(ep, ref, **EP_TOL)
    assert single[-1] < single[0]

    # the plan, byte by byte
    plan = plan_sharding(main, [loss], batch_size=B_, specs={
        n: tuple(v.dist_spec) for n, v in main.global_block().vars.items()
        if v.is_parameter and v.dist_spec and any(v.dist_spec)},
        axis_sizes={"ep": 2, "dp": 4})
    cap = int(np.ceil(1.25 * B_ * T_ / E_))
    buf = E_ * cap * D_ * 4 * 4                # a rank's buffer x dp ranks
    moe = [(e.kind, e.mesh_axis, e.reason, e.direction, e.payload_bytes)
           for e in plan.edges if e.op_type == "switch_ffn"]
    assert moe == [("all_gather", "dp", "moe_counts", "fwd", 4 * 2 * E_ * 4),
                   ("all_to_all", "ep", "constraint", "fwd", buf * 2),
                   ("all_gather", "ep", "constraint", "fwd", buf),
                   ("all_gather", "ep", "constraint", "bwd", buf)]
    assert [e.collective_op for e in plan.edges
            if e.op_type == "switch_ffn"][1] == "c_alltoall"
    sizes = {"moep.gate.w": D_ * E_, "moep.w1": E_ * D_ * F_ // 2,
             "moep.b1": E_ * F_ // 2, "moep.w2": E_ * F_ * D_ // 2,
             "moep.b2": E_ * D_ // 2}
    sync = {e.var: e.payload_bytes for e in plan.edges
            if e.reason == "grad_sync"}
    assert sync == {n: 4 * s for n, s in sizes.items()}
    assert plan.payload_bytes == sum(m[-1] for m in moe) + sum(sync.values())
    assert not plan.unexplained
    assert moved == 4 * plan.payload_bytes

    # each rank holds E/2 experts' weights and Adam moments
    blk = main.global_block()
    experts = ("moep.w1", "moep.b1", "moep.w2", "moep.b2")
    split = list(experts) + [n for n, v in blk.vars.items()
                             if getattr(v, "shard_like", None) in experts
                             and "moment" in n]
    assert len(split) == 12
    for n in split:
        v = sc.find_var(n)
        assert isinstance(v, ShardedValue), n
        assert v.spec[0] == "ep" and v.local_nbytes * 2 == v.nbytes, n
