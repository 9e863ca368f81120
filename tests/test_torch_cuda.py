"""The port on the card: tests that need a CUDA device.

Every test here carries the ``cuda`` marker and skips without a device.
The file imports neither JAX nor ``paddle_tpu`` (the GPU machine need not
have them), so it runs there with the repo's conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

- the flash-attention forward (K1) and backward (K2) kernels against their
  plain versions on the same card tensors, over the edge cases of the CPU
  parity tests (rtol 1e-4, atol 1e-5, float32), counting one launch per
  call;
- the wrappers refuse what the kernels do not take, on the card too;
- a tiny GPT served by ``InferenceServer()`` on ``cuda:0`` (the default
  executor) against the same program run on the host (1e-4 on the logits);
- a tiny GPT trained 3 Adam steps on ``cuda:0`` against the same steps on
  the host (loss 1e-5, parameters 2e-5 + 1e-4 relative, the key third of
  ``qkv.b`` within 3 lr: its exact gradient is zero, so Adam steps on
  rounding noise there), through K1 and K2;
- the conv1x1 + BN-statistics kernel (K3) against its plain version at
  ResNet-50's 15 conv1x1 shapes (batch 2) and at the edges: y within
  1e-5 + 1e-4 relative + 2^-20 of sum |w||x| (both sum exact bf16
  products in float32, in other orders), s within 2^-14 of sum |y|, s2
  within 2^-14 relative; its ``autograd.Function`` on the card against
  the host;
- a toy ResNet (two bottleneck blocks) trained on the card through the
  fusion pass against the host: 6 K3 launches a step; the fused step's
  loss within 2^-6 relative (K3 rounds its operands to bf16 on the card,
  the host multiplies in float32), the unfused steps (float32 on both
  sides) to 1e-5 on the loss and 1e-4 + 2e-5 on the parameters;
- the LayerNorm kernels (K4) against their plain versions, forward and
  backward, at widths 8 to 4096 (ragged, unaligned): y and dx within
  1e-5 + 1e-4 relative, dscale and dbias within 2^-14 of the sum of their
  terms' magnitudes; the dense-epilogue kernel (K5) against its plain
  version for each activation at ragged M, N and K: y within 1e-5 + 1e-4
  relative + 2^-20 of sum |x||w|; both ``autograd.Function`` s on the card
  against the host;
- a tiny GPT step fused with the kernels' paths (autotune verdicts set to
  win, rank threshold 0) on the card against the same fused program on the
  host: one K5 launch per layer, one K4 forward and one backward.
- the matmul + BN-statistics kernel (K6) against its plain version, float32
  and bf16 operands, with and without the producer's statistics and relu,
  at ragged M, K and N: a float32 y within 1e-5 + 1e-4 relative + 2^-20 of
  sum |a||w|, a bf16 y within one bf16 ulp (2^-7 relative) more, s within
  2^-14 of sum |y|, s2 within 2^-14 relative; one launch a call, ``mm_stats``
  one launch forward and none backward, its gradients against the host.
- the attention skeletons (K8) against their plain versions, d 8 to 128,
  ``block_q`` 64 to 256: o, dq and the dk/dv partials within 1e-5 + 1e-4
  relative + 2^-20 of the sum of their terms' magnitudes.
- one quick run of each tool (``rn50_fused_bench``, ``attn_shape_ceiling``)
  at small shapes; ``timing.time_held`` times the card alone and repeats
  (then refuses) a round whose hold ended before the host had enqueued it;
  the autotuner's chain timing on the card.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework import Program, Scope, program_guard
from paddle_tpu_torch.kernels import attn_skeleton as sk
from paddle_tpu_torch.kernels import conv_bn as cb
from paddle_tpu_torch.kernels import dense_epilogue as de
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import layer_norm as ln
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.tools import timing

pytestmark = pytest.mark.cuda

# (bh, Tq, Tk, d, causal, bias kind)
CASES = {
    "causal": (4, 64, 64, 64, True, None),
    "noncausal": (4, 64, 64, 64, False, None),
    "causal_tq_lt_tk": (2, 32, 96, 64, True, None),
    "ragged_t_d8": (2, 77, 77, 8, True, None),
    "ragged_t_d40": (2, 77, 90, 40, False, None),
    "bias_one": (4, 40, 40, 64, True, "one"),
    "bias_bh": (4, 40, 56, 8, False, "bh"),
    "masked_row_inf_bias": (2, 48, 48, 64, False, "inf_row"),
    "masked_rows_causal_tq_gt_tk": (2, 40, 24, 8, True, None),
    "d128": (2, 130, 130, 128, True, None),
    "bh_past_grid_y_limit": (70000, 8, 8, 8, True, None),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(bh, tq, tk, d, bias_kind, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(bh, t, d, generator=g) for t in (tq, tk, tk))
    bias = None
    if bias_kind == "one":
        bias = torch.randn(1, tq, tk, generator=g)
    elif bias_kind == "bh":
        bias = torch.randn(bh, tq, tk, generator=g)
    elif bias_kind == "inf_row":
        bias = torch.zeros(1, tq, tk)
        bias[:, 7, :] = float("-inf")
    return [None if x is None else x.to(device) for x in (q, k, v, bias)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(cuda, case):
    bh, tq, tk, d, causal, bias_kind = CASES[case]
    q, k, v, bias = _inputs(bh, tq, tk, d, bias_kind, cuda)
    n0 = fa.launch_count()
    o, lse = fa.flash_attention_fwd(q, k, v, bias, causal)
    torch.cuda.synchronize()
    assert fa.launch_count() == n0 + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, bias, causal)
    torch.testing.assert_close(o, ro, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-5)
    if bias_kind == "inf_row":
        assert bool((o[:, 7] == 0).all())


def _bwd_inputs(bh, tq, tk, d, causal, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(bh, tq, d, generator=g) for _ in range(2))
    k, v = (torch.randn(bh, tk, d, generator=g) for _ in range(2))
    o, lse = fa.flash_attention_reference(q, k, v, None, causal)
    return [x.to(device) for x in (q, k, v, o, lse, do)]


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c][5] is None))
def test_backward_kernel_matches_plain_version(cuda, case):
    bh, tq, tk, d, causal, _ = CASES[case]
    q, k, v, o, lse, do = _bwd_inputs(bh, tq, tk, d, causal, cuda)
    n0 = fa.launch_count("flash_attn_bwd")
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert fa.launch_count("flash_attn_bwd") == n0 + 1
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                            causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5, msg=name)
    if case == "masked_rows_causal_tq_gt_tk":
        assert bool((got[0][:, :tq - tk] == 0).all())


def test_function_backward_launches_the_kernel(cuda):
    q, k, v = (torch.randn(1, 2, 64, 32, device=cuda, requires_grad=True)
               for _ in range(3))
    n0 = (fa.launch_count("flash_attn_fwd"), fa.launch_count("flash_attn_bwd"))
    out = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (fa.launch_count("flash_attn_fwd"),
            fa.launch_count("flash_attn_bwd")) == (n0[0] + 1, n0[1] + 1)
    ref = torch.autograd.grad(
        fa.mha_reference(q, k, v, causal=True).square().sum(), (q, k, v))
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "layout", "lse"])
def test_backward_wrapper_refuses_on_the_card(cuda, bad):
    q, k, v, o, lse, do = _bwd_inputs(2, 16, 16, 64, True, cuda)
    if bad == "dtype":
        do = do.half()
    elif bad == "layout":
        o = o.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "lse":
        lse = lse[:, :8].contiguous()
    n0 = fa.launch_count("flash_attn_bwd")
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    assert fa.launch_count("flash_attn_bwd") == n0


@pytest.mark.parametrize("bad", ["dtype", "layout", "head_dim"])
def test_wrapper_refuses_on_the_card(cuda, bad):
    q = torch.randn(2, 16, 64, device=cuda)
    if bad == "dtype":
        q = q.half()
    elif bad == "layout":
        q = torch.randn(2, 64, 16, device=cuda).transpose(1, 2)
    elif bad == "head_dim":
        q = torch.randn(2, 16, 136, device=cuda)
    n0 = fa.launch_count()
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention_fwd(q, q, q, None, True)
    assert fa.launch_count() == n0


def test_server_on_the_card_matches_the_host(cuda):
    cfg = T.BertConfig(vocab_size=48, d_model=32, n_layer=2, n_head=2,
                       d_inner=64, max_pos=64, dropout=0.0)

    def factory(seq):
        prog, startup = Program(), Program()
        with program_guard(prog, startup):
            _, logits = T.build_gpt_serving(cfg, seq, attn_impl="flash")
        return prog, ["src_ids"], [logits.name]

    scope, startup = Scope(), Program()
    with program_guard(Program(), startup):
        T.build_gpt_serving(cfg, 16)
    exe = ptt.Executor()
    assert exe.device == cuda
    exe.run(startup, scope=scope, seed=5)
    host_scope = Scope()
    for name, val in scope.items():
        host_scope.set_var(name, val.cpu())

    srv = ptt.serving.InferenceServer(factory, scope, buckets=(16, 32),
                                      max_batch=4).start()
    rng = np.random.RandomState(0)
    reqs = [rng.randint(1, 48, (n,)).astype(np.int64)
            for n in (5, 16, 9, 30, 17, 3)]
    n0 = fa.launch_count()
    outs = [f.result(timeout=120)
            for f in [srv.submit("t", {"src_ids": r}) for r in reqs]]
    assert srv.drain(30)
    srv.stop()
    batches = len(srv.batch_log())
    assert fa.launch_count() - n0 == cfg.n_layer * batches

    host = ptt.Executor(ptt.CPUPlace())
    for ids, out in zip(reqs, outs):
        prog, _, fetch = factory(32)
        feed = np.zeros((1, 32), np.int64)
        feed[0, :len(ids)] = ids
        ref, = host.run(prog, feed={"src_ids": feed}, fetch_list=fetch,
                        scope=host_scope)
        np.testing.assert_allclose(out[0], ref[0, :len(ids)], rtol=1e-4,
                                   atol=1e-4)


def test_training_on_the_card_matches_the_host(cuda):
    from paddle_tpu_torch import optimizer as opt
    cfg = T.BertConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4,
                       d_inner=64, max_pos=64, dropout=0.0)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss = T.build_gpt_pretrain(cfg, 64, attn_impl="flash",
                                          fused_head=True, dropout=0.0)
        opt.AdamOptimizer(1e-3).minimize(loss)
    exe, host = ptt.Executor(), ptt.Executor(ptt.CPUPlace())
    scope, host_scope = Scope(), Scope()
    exe.run(startup, scope=scope, seed=3)
    for name, val in scope.items():
        host_scope.set_var(name, val.cpu())
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 64, (2, 64)).astype(np.int64)
    feed = {"src_ids": ids, "lm_label": np.roll(ids, -1, axis=1)}
    n0 = (fa.launch_count("flash_attn_fwd"), fa.launch_count("flash_attn_bwd"))
    for _ in range(3):
        got, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        want, = host.run(main, feed=feed, fetch_list=[loss],
                         scope=host_scope)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (fa.launch_count("flash_attn_fwd") - n0[0],
            fa.launch_count("flash_attn_bwd") - n0[1]) == (6, 6)
    d = cfg.d_model
    for p in main.all_parameters():
        got = scope.find_var(p.name).cpu().numpy()
        want = host_scope.find_var(p.name).numpy()
        if p.name.endswith("attn.qkv.b"):
            # the key third's exact gradient is zero: Adam steps on noise
            np.testing.assert_allclose(got[d:2 * d], want[d:2 * d], rtol=0,
                                       atol=3e-3, err_msg=p.name)
            got = np.concatenate([got[:d], got[2 * d:]])
            want = np.concatenate([want[:d], want[2 * d:]])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5,
                                   err_msg=p.name)


# -- K3: conv1x1 + BN statistics ----------------------------------------------

K3_SHAPES = {
    **{f"rn50_{ci}_{co}_{p}": (2, ci, co, p) for ci, co, p in (
        (64, 64, 3136), (64, 256, 3136), (256, 64, 3136), (256, 128, 3136),
        (128, 512, 784), (256, 512, 784), (512, 128, 784), (512, 256, 784),
        (256, 1024, 196), (512, 1024, 196), (1024, 256, 196),
        (1024, 512, 196), (512, 2048, 49), (1024, 2048, 49),
        (2048, 512, 49))},
    "n1_p49": (1, 512, 2048, 49),
    "odd_cin_cout": (3, 13, 70, 65),
    "ragged_cout": (2, 12, 20, 49),
    "one_pixel": (2, 3, 5, 1),
}


def _k3_check(x, w):
    y, s, s2 = cb.conv1x1_stats_fwd(x, w)
    torch.cuda.synchronize()
    ry, rs, rs2 = cb.conv1x1_stats_plain(x, w)
    terms = torch.einsum("oc,ncp->nop", w.to(torch.bfloat16).float().abs(),
                         x.to(torch.bfloat16).float().abs())
    assert bool(((y - ry).abs() <= 1e-5 + 1e-4 * ry.abs()
                 + 2.0 ** -20 * terms).all())
    assert bool(((s - rs).abs()
                 <= 2.0 ** -14 * ry.abs().sum(dim=(0, 2)) + 1e-6).all())
    assert bool(((s2 - rs2).abs() <= 2.0 ** -14 * rs2 + 1e-6).all())


@pytest.mark.parametrize("case", sorted(K3_SHAPES))
def test_k3_matches_plain_version(cuda, case):
    n, ci, co, p = K3_SHAPES[case]
    g = torch.Generator().manual_seed(ci + co + p)
    x = torch.randn(n, ci, p, generator=g).to(cuda)
    w = (torch.randn(co, ci, generator=g) * ci ** -0.5).to(cuda)
    n0 = cb.launch_count()
    _k3_check(x, w)
    assert cb.launch_count() == n0 + 1


def test_k3_on_a_stride_two_view(cuda):
    """The strided shortcut's input: x[:, :, ::2, ::2], made contiguous."""
    g = torch.Generator().manual_seed(3)
    x4 = torch.randn(2, 256, 56, 56, generator=g).to(cuda)
    w = (torch.randn(512, 256, generator=g) / 16).to(cuda)
    _k3_check(x4[:, :, ::2, ::2].reshape(2, 256, -1), w)


@pytest.mark.parametrize("bad", ["dtype", "layout", "channels"])
def test_k3_wrapper_refuses_on_the_card(cuda, bad):
    x, w = torch.randn(2, 8, 49, device=cuda), torch.randn(4, 8, device=cuda)
    if bad == "dtype":
        x = x.half()
    elif bad == "layout":
        x = torch.randn(2, 49, 8, device=cuda).transpose(1, 2)
    else:
        w = torch.randn(4, 9, device=cuda)
    n0 = cb.launch_count()
    with pytest.raises((TypeError, ValueError)):
        cb.conv1x1_stats_fwd(x, w)
    assert cb.launch_count() == n0


def test_k3_function_grads_match_the_host(cuda):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 64, 196, generator=g)
    w = torch.randn(32, 64, generator=g) / 8
    coef = torch.arange(32, dtype=torch.float32)
    grads = []
    for dev in ("cpu", cuda):
        xt = x.to(dev).requires_grad_(True)
        wt = w.to(dev).requires_grad_(True)
        y, s, s2 = cb.conv1x1_stats(xt, wt)
        loss = (y ** 2).sum() * 0.5 + (s * coef.to(dev)).sum() \
            + (s2 * 0.1).sum()
        grads.append([t.cpu() for t in torch.autograd.grad(loss, (xt, wt))])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()))


def _toy_resnet():
    from paddle_tpu_torch import layers
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.models import resnet
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", shape=[16, 8, 8], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        h = resnet.bottleneck_block(img, 16, 1, "bb0")
        h = resnet.bottleneck_block(h, 16, 2, "bb1")
        pred = layers.fc(layers.pool2d(h, pool_type="avg",
                                       global_pooling=True),
                         size=4, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, label))
        opt.MomentumOptimizer(0.1, 0.9).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_toy_resnet_on_the_card_matches_the_host(cuda, fused):
    from paddle_tpu_torch import flags
    main, startup, loss = _toy_resnet()
    exe, host = ptt.Executor(), ptt.Executor(ptt.CPUPlace())
    scope, host_scope = Scope(), Scope()
    exe.run(startup, scope=scope, seed=3)
    for name, val in scope.items():
        host_scope.set_var(name, val.cpu())
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(4, 16, 8, 8).astype(np.float32),
            "label": rng.randint(0, 4, (4, 1)).astype(np.int64)}
    flags.set_flags({"FLAGS_graph_fusion": fused})
    try:
        n0 = cb.launch_count()
        steps = 1 if fused else 3
        for _ in range(steps):
            got, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            want, = host.run(main, feed=feed, fetch_list=[loss],
                             scope=host_scope)
            np.testing.assert_allclose(got, want,
                                       rtol=2.0 ** -6 if fused else 1e-5)
    finally:
        flags.set_flags({"FLAGS_graph_fusion": True})
    assert cb.launch_count() - n0 == (6 if fused else 0)
    if fused:
        return
    for p in main.all_parameters():
        np.testing.assert_allclose(scope.find_var(p.name).cpu().numpy(),
                                   host_scope.find_var(p.name).numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=p.name)


# -- K4 and K5 -----------------------------------------------------------------

LN_SHAPES = {"1x8": (1, 8), "37x96": (37, 96), "515x768": (515, 768),
             "4099x1000": (4099, 1000), "7x4096": (7, 4096), "33x5": (33, 5),
             "unaligned_9x96": (9, 96)}


@pytest.mark.parametrize("case", sorted(LN_SHAPES))
def test_k4_matches_plain_version(cuda, case):
    rows, d = LN_SHAPES[case]
    g = torch.Generator().manual_seed(rows + d)
    x = (torch.randn(rows, d, generator=g) * 2 + 0.5).to(cuda)
    if case.startswith("unaligned"):
        # a view one float past a 16-byte boundary: scalar accesses
        flat = torch.randn(rows * d + 1, generator=g).to(cuda)
        x = flat[1:].view(rows, d)
    s = (torch.randn(d, generator=g) + 1).to(cuda)
    b = torch.randn(d, generator=g).to(cuda)
    dy = torch.randn(rows, d, generator=g).to(cuda)
    n0 = (ln.launch_count("layer_norm_fwd"), ln.launch_count("layer_norm_bwd"))
    y = ln.layer_norm_fwd(x, s, b, 1e-5)
    dx, ds, db = ln.layer_norm_bwd(x, s, dy, 1e-5)
    torch.cuda.synchronize()
    assert (ln.launch_count("layer_norm_fwd"),
            ln.launch_count("layer_norm_bwd")) == (n0[0] + 1, n0[1] + 1)
    ry = ln.layer_norm_fwd_plain(x, s, b, 1e-5)
    rdx, rds, rdb = ln.layer_norm_bwd_plain(x, s, dy, 1e-5)
    assert bool(((y - ry).abs() <= 1e-5 + 1e-4 * ry.abs()).all())
    assert bool(((dx - rdx).abs() <= 1e-5 + 1e-4 * rdx.abs()).all())
    xhat = ln.layer_norm_fwd_plain(x, torch.ones_like(s),
                                   torch.zeros_like(b), 1e-5)
    for got, want, terms in ((ds, rds, (dy * xhat).abs()),
                             (db, rdb, dy.abs())):
        assert bool(((got - want).abs()
                     <= 2.0 ** -14 * terms.sum(dim=0) + 1e-6).all())


K5_SHAPES = {"1x64x128": (1, 64, 128), "513x96x130": (513, 96, 130),
             "256x100x72": (256, 100, 72), "300x768x3072": (300, 768, 3072),
             "129x33x7": (129, 33, 7)}


@pytest.mark.parametrize("act,approximate", [("", False), ("relu", False),
                                             ("gelu", False), ("gelu", True)],
                         ids=["none", "relu", "gelu_erf", "gelu_tanh"])
@pytest.mark.parametrize("case", sorted(K5_SHAPES))
def test_k5_matches_plain_version(cuda, case, act, approximate):
    m, k, n = K5_SHAPES[case]
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g).to(cuda)
    w = (torch.randn(k, n, generator=g) * k ** -0.5).to(cuda)
    b = torch.randn(n, generator=g).to(cuda)
    n0 = de.launch_count()
    y = de.dense_act_fwd(x, w, b, act, approximate)
    torch.cuda.synchronize()
    assert de.launch_count() == n0 + 1
    ry = de.dense_act_plain(x, w, b, act, approximate)
    terms = x.to(torch.bfloat16).float().abs() @ \
        w.to(torch.bfloat16).float().abs()
    assert bool(((y - ry).abs() <= 1e-5 + 1e-4 * ry.abs()
                 + 2.0 ** -20 * terms).all())


@pytest.mark.parametrize("bad", ["dtype", "layout", "inner", "act"])
def test_k5_wrapper_refuses_on_the_card(cuda, bad):
    x, w = torch.randn(8, 16, device=cuda), torch.randn(16, 4, device=cuda)
    b, act = torch.randn(4, device=cuda), "gelu"
    if bad == "dtype":
        x = x.half()
    elif bad == "layout":
        w = torch.randn(4, 16, device=cuda).t()
    elif bad == "inner":
        w = torch.randn(15, 4, device=cuda)
    else:
        act = "tanh"
    n0 = de.launch_count()
    with pytest.raises((TypeError, ValueError)):
        de.dense_act_fwd(x, w, b, act)
    assert de.launch_count() == n0


def test_k4_and_k5_functions_match_the_host(cuda):
    g = torch.Generator().manual_seed(9)
    x = torch.randn(64, 96, generator=g)
    w = torch.randn(96, 40, generator=g) / 10
    b = torch.randn(40, generator=g)
    s, c = torch.randn(40, generator=g) + 1, torch.randn(40, generator=g)
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_(True) for t in (x, w, b, s, c)]
        h = de.dense_act(*leaves[:3], "gelu", False)
        y = ln.fused_layer_norm(h, leaves[3], leaves[4])
        loss = (y * y).sum()
        grads.append([t.cpu() for t in torch.autograd.grad(loss, leaves)])
    for a, b_ in zip(*grads):
        torch.testing.assert_close(b_, a, rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()))


def test_fused_tiny_gpt_step_on_the_card_matches_the_host(cuda, monkeypatch):
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.analysis import fusion
    monkeypatch.setattr(fusion, "_autotune", lambda *a, **k: {
        "base_ms": 1.0, "fused_ms": 0.5, "win": True, "cached": False})
    cfg = T.BertConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4,
                       d_inner=64, max_pos=16, dropout=0.0)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss = T.build_gpt_pretrain(cfg, 16, attn_impl="flash",
                                          fused_head=True, dropout=0.0)
        opt.AdamOptimizer(1e-3).minimize(loss)
    exe, host = ptt.Executor(), ptt.Executor(ptt.CPUPlace())
    scope, host_scope = Scope(), Scope()
    exe.run(startup, scope=scope, seed=5)
    for name, val in scope.items():
        host_scope.set_var(name, val.cpu())
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 64, (2, 16)).astype(np.int64)
    feed = {"src_ids": ids, "lm_label": np.roll(ids, -1, axis=1)}
    flags.set_flags({"FLAGS_fusion_autotune": True,
                     "FLAGS_fusion_rank_threshold": 0.0})
    try:
        n0 = (de.launch_count(), ln.launch_count("layer_norm_fwd"),
              ln.launch_count("layer_norm_bwd"))
        got, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        counts = (de.launch_count() - n0[0],
                  ln.launch_count("layer_norm_fwd") - n0[1],
                  ln.launch_count("layer_norm_bwd") - n0[2])
        plan, = [p for p in exe._plans.values()
                 if any(op.type == "adam" for op, _ in p.ops)]
        want, = host.run(plan.block.program, feed=feed, fetch_list=[loss],
                         scope=host_scope)
    finally:
        flags.set_flags({"FLAGS_fusion_autotune": False,
                         "FLAGS_fusion_rank_threshold": 0.02})
    assert counts == (cfg.n_layer, 1, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4)


# -- K6: matmul + BN statistics ------------------------------------------------

# (M, K, N, x dtype, w dtype)
K6_SHAPES = {
    "m513_k24_n64_f32": (513, 24, 64, "float32", "float32"),
    "m1_k40_n70_f32": (1, 40, 70, "float32", "float32"),
    "m1032_k13_n130_f32": (1032, 13, 130, "float32", "float32"),
    "m4096_k256_n64_bf16": (4096, 256, 64, "bfloat16", "bfloat16"),
    "m2048_k64_n128_bf16": (2048, 64, 128, "bfloat16", "bfloat16"),
    "m300_k40_n9_bf16_x_f32_w": (300, 40, 9, "bfloat16", "float32"),
    "m257_k33_n17_f32_x_bf16_w": (257, 33, 17, "float32", "bfloat16"),
}


def _k6_inputs(m, k, n, xdt, wdt, device, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g).to(getattr(torch, xdt))
    w = (torch.randn(k, n, generator=g) * k ** -0.5).to(getattr(torch, wdt))
    ps = (torch.randn(k, generator=g) * 0.1,
          torch.rand(k, generator=g) + 0.5,
          1 + torch.randn(k, generator=g) * 0.1,
          torch.randn(k, generator=g) * 0.1)
    return x.to(device), w.to(device), tuple(p.to(device) for p in ps)


def _k6_check(x, w, ps, relu):
    n0 = cb.launch_count("matmul_bn_stats")
    y, s, s2 = cb.matmul_bn_stats_fwd(x, w, ps, relu=relu)
    torch.cuda.synchronize()
    assert cb.launch_count("matmul_bn_stats") == n0 + 1
    ry, rs, rs2 = cb.matmul_bn_stats_plain(x, w, ps, relu=relu)
    assert y.dtype == x.dtype and y.shape == ry.shape
    a = x.float()
    if ps is not None:
        a = (a - ps[0]) * ps[1] * ps[2] + ps[3]
    a = torch.relu(a) if relu else a
    terms = a.to(torch.bfloat16).float().abs() @ \
        w.to(torch.bfloat16).float().abs()
    tol = 1e-5 + 1e-4 * ry.float().abs() + 2.0 ** -20 * terms
    if x.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ry.float().abs()
    assert bool(((y.float() - ry.float()).abs() <= tol).all())
    assert bool(((s - rs).abs()
                 <= 2.0 ** -14 * ry.float().abs().sum(dim=0) + 1e-6).all())
    assert bool(((s2 - rs2).abs() <= 2.0 ** -14 * rs2 + 1e-6).all())


@pytest.mark.parametrize("stats,relu", [(False, False), (False, True),
                                        (True, True)],
                         ids=["plain", "relu", "norm_relu"])
@pytest.mark.parametrize("case", sorted(K6_SHAPES))
def test_k6_matches_plain_version(cuda, case, stats, relu):
    m, k, n, xdt, wdt = K6_SHAPES[case]
    x, w, ps = _k6_inputs(m, k, n, xdt, wdt, cuda, seed=m + k + n)
    _k6_check(x, w, ps if stats else None, relu)


def test_k6_unaligned_operands_take_scalar_loads(cuda):
    """Views one element past a 16-byte boundary (contiguous all the
    same): the kernel must not use its 16-byte loads there."""
    g = torch.Generator().manual_seed(11)
    flat = torch.randn(129 * 64 + 1, generator=g).to(cuda)
    x = flat[1:].view(129, 64)
    wflat = torch.randn(64 * 32 + 1, generator=g).to(cuda)
    w = wflat[1:].view(64, 32)
    _k6_check(x, w, None, False)


@pytest.mark.parametrize("bad", ["dtype", "layout", "inner", "m_rule",
                                 "stats"])
def test_k6_wrapper_refuses_on_the_card(cuda, bad):
    x, w = torch.randn(16, 8, device=cuda), torch.randn(8, 4, device=cuda)
    ps = None
    if bad == "dtype":
        x = x.half()
    elif bad == "layout":
        w = torch.randn(4, 8, device=cuda).t()
    elif bad == "inner":
        w = torch.randn(7, 4, device=cuda)
    elif bad == "m_rule":
        x = torch.randn(1027, 8, device=cuda)
    else:
        ps = (torch.zeros(8, device=cuda),) * 3 + (torch.zeros(8),)
    n0 = cb.launch_count("matmul_bn_stats")
    with pytest.raises((TypeError, ValueError)):
        cb.matmul_bn_stats_fwd(x, w, ps)
    assert cb.launch_count("matmul_bn_stats") == n0


def test_mm_stats_launches_and_grads_match_the_host(cuda):
    g = torch.Generator().manual_seed(12)
    x = torch.randn(300, 48, generator=g)
    w = torch.randn(48, 24, generator=g) / 7
    coef = torch.arange(24, dtype=torch.float32)
    grads, counts = [], []
    for dev in ("cpu", cuda):
        xt = x.to(dev).requires_grad_(True)
        wt = w.to(dev).requires_grad_(True)
        n0 = cb.launch_count("matmul_bn_stats")
        y, s, s2 = cb.mm_stats(xt, wt)
        n1 = cb.launch_count("matmul_bn_stats")
        loss = (y ** 2).sum() * 0.5 + (s * coef.to(dev)).sum() \
            + (s2 * 0.1).sum()
        grads.append([t.cpu() for t in torch.autograd.grad(loss, (xt, wt))])
        counts.append((n1 - n0, cb.launch_count("matmul_bn_stats") - n1))
    assert counts == [(0, 0), (1, 0)]
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()))


# -- K8: the attention skeletons -----------------------------------------------

# (bh, T, d, block_q)
K8_SHAPES = {"t128_d64_bq64": (2, 128, 64, 64),
             "t256_d128_bq128": (2, 256, 128, 128),
             "t256_d40_bq256": (3, 256, 40, 256),
             "t192_d8_bq64": (2, 192, 8, 64),
             "t512_d64_bq128": (4, 512, 64, 128)}


@pytest.mark.parametrize("case", sorted(K8_SHAPES))
def test_k8_matches_plain_versions(cuda, case):
    bh, t, d, bq = K8_SHAPES[case]
    g = torch.Generator().manual_seed(t + d)
    q, k, v, do = (torch.randn(bh, t, d, generator=g).to(cuda)
                   for _ in range(4))
    n0 = (sk.launch_count("attn_skeleton_fwd"),
          sk.launch_count("attn_skeleton_bwd"))
    o = sk.attn_skeleton_fwd(q, k, v, bq, 64)
    dq, dkp, dvp = sk.attn_skeleton_bwd(q, k, v, do, bq, 64)
    torch.cuda.synchronize()
    assert (sk.launch_count("attn_skeleton_fwd"),
            sk.launch_count("attn_skeleton_bwd")) == (n0[0] + 1, n0[1] + 1)
    ro = sk.attn_skeleton_fwd_plain(q, k, v)
    rdq, rdkp, rdvp = sk.attn_skeleton_bwd_plain(q, k, v, do, bq)
    qa, ka, va, da = (a.abs() for a in (q, k, v, do))
    s_abs = qa @ ka.transpose(1, 2)
    ds_abs = s_abs * (da @ va.transpose(1, 2))
    nq = t // bq

    def per_block(a, x):
        return a.view(bh, nq, bq, t).transpose(2, 3) @ x.view(bh, nq, bq, d)

    for got, want, terms in ((o, ro, s_abs @ va), (dq, rdq, ds_abs @ ka),
                             (dkp, rdkp, per_block(ds_abs, qa)),
                             (dvp, rdvp, per_block(s_abs, da))):
        assert got.shape == want.shape
        assert bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs()
                     + 2.0 ** -20 * terms).all())


@pytest.mark.parametrize("bad", ["block_q", "d", "dtype"])
def test_k8_wrappers_refuse_on_the_card(cuda, bad):
    t, d, bq = 128, 64, 64
    dtype = torch.float32
    if bad == "block_q":
        bq = 96
    elif bad == "d":
        d = 136
    else:
        dtype = torch.float16
    q = torch.zeros(2, t, d, device=cuda, dtype=dtype)
    n0 = sk.launch_count("attn_skeleton_bwd")
    with pytest.raises((TypeError, ValueError)):
        sk.attn_skeleton_bwd(q, q, q, q, bq)
    assert sk.launch_count("attn_skeleton_bwd") == n0


# -- the tools -------------------------------------------------------------------

def test_rn50_fused_bench_runs_on_the_card(cuda):
    from paddle_tpu_torch.tools import rn50_fused_bench as rfb
    out = rfb.main(shapes=(("small", 8192, 128, 64),))["small"]
    assert out["fused_launches"] == 2
    assert out["rel_err"] <= 2.0 ** -7
    assert out["library_ms"] > 0 and out["fused_ms"] > 0


def test_attn_shape_ceiling_probe_runs_on_the_card(cuda):
    from paddle_tpu_torch.tools import attn_shape_ceiling as asc
    n0 = sk.launch_count("attn_skeleton_bwd")
    out = asc.probe(256, 2, iters=(1, 2), reps=1)
    assert sk.launch_count("attn_skeleton_bwd") - n0 == 1 + 1 + 2
    for key in ("fwd_skel_ms", "fwd_skel_d128_ms", "bwd_skel_ms",
                "flash_fwd_ms", "flash_fwd_bwd_ms", "fill_ratio",
                "fwd_vs_skel", "fb_vs_skel"):
        assert out[key] > 0, key


def test_time_held_times_the_card(cuda):
    a = torch.randn(512, 512, device=cuda)
    sec, calls = timing.time_held(torch.matmul, a, a, runs=5)
    assert calls == 5 and 0 < sec < 0.1


def test_time_held_refuses_a_hold_the_host_outran(cuda):
    """A hold of 1000 cycles ends long before the host has enqueued calls
    that each sleep 2 ms: every round is repeated with twice the hold, and
    after the last the timer raises instead of timing the host's gaps."""
    import time
    a = torch.ones(8, device=cuda)

    def slow():
        time.sleep(0.002)
        a.add_(1)

    with pytest.raises(RuntimeError, match="longer to enqueue"):
        timing.time_held(slow, runs=3, hold_cycles=1000)
    torch.cuda.synchronize()
    assert float(a[0]) == 1 + 3 * timing.HOLD_TRIES


def test_autotune_times_a_chain_on_the_card(cuda):
    from paddle_tpu_torch.analysis import fusion
    descs = [("elementwise_add", {"X": ["x"], "Y": ["y"]}, {"Out": ["s"]},
              {"axis": -1}),
             ("relu", {"X": ["s"]}, {"Out": ["r"]}, {})]
    vals = {"x": torch.randn(256, 256, device=cuda),
            "y": torch.randn(256, 256, device=cuda)}
    ms, runs = fusion._time_chain(descs, vals, cuda)
    assert 0 < ms < 10
    assert runs >= 1 + 3 * 5 and (runs - 1) % 5 == 0
