"""GSPMD on transformers in the port, on the CPU over meshes of virtual
ranks (the helpers of ``test_torch_gspmd.py``).

- the toy BERT (dp 2 x mp 4) and the toy flash GPT (dp 2 x mp 2, fp32 head)
  under ``mp_hidden_vocab`` + ZeRO-1 equal the one-device run from the
  JAX package's weights, losses (rtol 2e-4, atol 1e-6, also against the
  JAX package's losses) and every parameter's gradient (atol 1e-6), and
  ``paddle_tpu_collective_bytes_total`` moves by exactly steps x the plan's
  payload;
- ``with_distributed`` + ``annotate_tensor_parallel`` on the toy BERT
  equals the JAX package's one-device run (rtol 2e-4, atol 1e-5, ref
  ``test_parallel.py:63``): no activation constraint, so the heads stay
  sharded through attention.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu_torch import monitor
from paddle_tpu_torch.analysis.sharding import plan_sharding
from paddle_tpu_torch.framework import Scope
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.parallel import ShardedValue
from test_torch_gspmd import TOL, _feeds, _gspmd, _port_run, _ref_single
from _port_fixtures import collect_garbage_after_module  # noqa: F401

CPU = torch.device("cpu")


@pytest.mark.parametrize("which,axes", [("bert", {"dp": 2, "mp": 4}),
                                        ("gpt", {"dp": 2, "mp": 2})])
def test_transformer_gspmd_losses_and_gradients(which, axes):
    init, want = _ref_single(which, 3)
    _, _, single, _, _ = _port_run(which, init, grads=True)
    main, sc, got, moved, loss = _port_run(
        which, init, _gspmd(axes, "mp_hidden_vocab"), grads=True)
    np.testing.assert_allclose([float(g[0]) for g in got], want, **TOL)
    for step, (g, s) in enumerate(zip(got, single)):
        assert float(g[0]) == pytest.approx(float(s[0]), rel=2e-4, abs=1e-6)
        for k, (a, b) in enumerate(zip(g[1:], s[1:])):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                       err_msg=f"step {step} grad {k}")
    plan = plan_sharding(main, [loss], batch_size=8)
    assert plan.edges and not plan.unexplained
    assert moved == 3 * plan.payload_bytes
    # sharded parameters and ZeRO-1 state between steps
    w = sc.find_var("enc_0.ffn.fc1.w")
    assert isinstance(w, ShardedValue) and w.spec == (None, "mp")


def _bert_sgd(pkg):
    if pkg == "ref":
        from paddle_tpu.framework import unique_name
        root, opt, T_ = pt, pt.optimizer, None
    else:
        from paddle_tpu_torch.framework import unique_name
        root, opt, T_ = ptt, ptt.optimizer, T
    from paddle_tpu.models import transformer as RT
    T_ = T_ or RT
    main, startup = root.Program(), root.Program()
    with unique_name.guard(), root.program_guard(main, startup):
        cfg = T_.BertConfig(vocab_size=64, d_model=16, n_layer=2, n_head=4,
                            d_inner=32, max_pos=32, dropout=0.0)
        _, _, loss = T_.build_bert_pretrain(cfg, seq_len=8)
        opt.SGDOptimizer(learning_rate=0.05).minimize(loss)
    return main, startup, loss.name


def test_tensor_parallel_bert_matches_single():
    """``with_distributed`` over dp 2 x mp 4 with the Megatron names'
    layout: no activation constraint, so the heads stay sharded through
    attention and the pack's backward runs the inverse all-to-all (counted
    as unplanned traffic)."""
    rmain, rstart, rloss = _bert_sgd("ref")
    sc0, exe0 = RefScope(), RefExecutor()
    exe0.run(rstart, scope=sc0, seed=11)
    init = {k: np.asarray(sc0.find_var(k))
            for k, v in rmain.global_block().vars.items()
            if v.persistable and sc0.find_var(k) is not None}
    feeds = _feeds("bert", 3)
    want = [float(np.asarray(exe0.run(rmain, feed=f, fetch_list=[rloss],
                                      scope=sc0)[0])) for f in feeds]
    main, startup, loss = _bert_sgd("port")
    sc, exe = Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=11)
    params_from_numpy(sc, init)
    T.annotate_tensor_parallel(main)
    c = ptt.CompiledProgram(main).with_distributed(
        axes={"dp": 2, "mp": 4}, devices=[CPU] * 8)
    ctr = monitor.REGISTRY.get("paddle_tpu_gspmd_unplanned_bytes_total")
    u0 = ctr.value(reason="reshard_bwd")
    got = [float(exe.run(c, feed=f, fetch_list=[loss], scope=sc)[0])
           for f in feeds]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    assert ctr.value(reason="reshard_bwd") > u0
    assert sc.find_var("word_embedding").spec == ("mp", None)



