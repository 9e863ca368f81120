"""The port on the card: tests that need a CUDA device.

Every test here carries the ``cuda`` marker and skips without a device.
The file imports neither JAX nor ``paddle_tpu`` (the GPU machine need not
have them), so it runs there with the repo's conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

- the flash-attention forward (K1) and backward (K2) kernels (the Hopper
  sources, TMA and ``wgmma``; float32 as six bf16 term products) against
  their plain versions on the same card tensors, over the edge cases of
  the CPU parity tests (rtol 1e-4, atol 1e-5, float32, also from an
  operand off 16 bytes), counting one launch per call; the bf16 forms over
  the same cases, K2 with a given delta too, within one bf16 ulp of each
  output's largest magnitude, and their refusal of an operand that is not
  16-byte aligned;
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
- the attention skeletons (K8, Hopper: float32 as bf16 term products)
  against their plain versions, d 8 to 128 (and d 12, zero-padded),
  ``block_q`` 64 to 256, the tool's own [24, 2048, 64], and inputs whose
  rows are scaled by 2^-8..2^8: o, dq and the dk/dv partials within
  1e-5 + 1e-4 relative + 2^-20 of the sum of their terms' magnitudes; one
  launch of each wrapper at d 128, T 192; the shared memory the source
  lays out equals ``attn_skeleton.shared_bytes``.
- one quick run of each tool (``rn50_fused_bench``, ``attn_shape_ceiling``)
  at small shapes; ``timing.time_held`` times the card alone and repeats
  (then refuses) a round whose hold ended before the host had enqueued it;
  the autotuner's chain timing on the card.
- ring attention (K7): the merge kernel against its plain version, float32
  (within 1e-6 + 1e-6 relative) and bf16 (one bf16 ulp of each value), with
  NEG_INF rows on either side and on both; the ring over ``[cuda:0] * n``
  (n 2 and 4, virtual ranks) against K1/K2 over the full T (o within 2e-5,
  gradients within 2e-4 in float32; 2 bf16 ulps of max|o| and 4 of each
  gradient's in bf16) and against the plain ring (1e-5 + 1e-4 relative;
  4 bf16 ulps of each value + 4 of the RMS), with the launch counts of
  ``expected_launches``; K2
  with a given delta (float32 and bf16) against its plain version given
  the same delta; the toy BERT ring program on the card against the host.
- head dims off 8 (zero-padded on the card): K1 and K2 at d = 12 and 20
  in both dtypes against their plain versions at the true d, the ring at
  d = 20 against the plain ring, and d = 136 refused with the reason;
- K5 and the bf16 K3 on the Hopper GEMM core: K5 at a ragged M (4097), K
  and N off multiples of 8 and x or w one element off 16 bytes, both
  dtypes; the bf16 K3 at Cout 64, P 49 and 196 with a short last column
  tile, P 56 (TMA), Cin 13, the stride-2 shortcut's copies (P 196 and
  49) and an x off 16 bytes, under K3's bf16 bounds above.
- the float32 K3 on the core (A built in registers): short last pixel
  tiles at P 3136, 784 and 196 (TMA), P 49 with N 1 and an odd N (slab),
  P 64 and 4 (slab), Cin off 4 (a copy with zero channels or pixels), P
  off 4 above 64 (a copy; y from the registers), Cout * P off 4 at the
  slab route (y from the registers), w in float32 and bf16, and an x off
  16 bytes, under K3's float32 bounds above; K6 on the core at N 64 and
  128 (and a ragged 130), M and K ragged, with and without the producer's
  statistics and relu, x in bf16 and float32, and with x and w off 16
  bytes, under K6's bounds above.
- the merge kernel redesigned (16-byte accesses, a lane group a row): o
  and lse equal to the plain version's bit for bit in both dtypes at d 8,
  12, 20, 64, 128 and 136 over 1015 rows with NEG_INF rows on either side
  and on both, and from an o1 off 16 bytes (the scalar form); ``out=(o1,
  lse1)`` gives the bits of a fresh output; an out over another input is
  refused;
- K4's backward redesigned (a warp a row up to ``layer_norm.ROW_MAX_D``,
  cluster sums of dscale and dbias), both dtypes, at d 4, 12, 760, 768,
  the limit, the limit + 4 (the multi-warp form) and 4096, rows 1, 7 and
  16385, and on views off 16 bytes: dx within 1e-5 + 1e-4 relative in
  float32 (plus the one-pass variance's allowance where a row is
  ill-conditioned) and one bf16 ulp of max|dx| in bf16, dscale and dbias
  within 2^-14 of the sum of their terms' magnitudes, a second call bit
  for bit; the wrapper's scratch rule equals the source's, which refuses
  another count.
- the decode step captured as a CUDA graph (a tiny GPT): a replay equals
  the uncaptured step on the same inputs and pools, logits and pools bit
  for bit (else within 1e-6 relative); after ``reinit_pools`` a replay
  still writes into the live pools (zeroed in place, never reallocated);
  two engines in one process capture once each and agree; a
  ``DecodeServer`` on the card generates what one on the host does.
- the dropout kernel against its plain version bit for bit (out and mask,
  float32 and bf16, ragged lengths, views off 16 bytes, a stored mask in
  place of the stream, p 0 and 1), one launch a call; its
  ``autograd.Function`` regenerates the mask in the backward; a tiny BERT
  at dropout 0.1 trains a step on the card as on the host (the same bits
  by design: loss 1e-5 relative); a CUDA tensor the kernel does not take,
  or a launch that fails, raises (no plain fallback).
- activation recompute: a 2-layer BERT (d 256, dropout 0.1, AMP, LAMB)
  with and without ``RecomputeOptimizer`` over its layer outputs, 3 steps
  on the card from the same weights: the same losses to the bit, and the
  recomputed program's peak above its start lower; the LAMB and LARS
  updates on card tensors under ``torch.cuda.set_sync_debug_mode("error")``
  (no host sync) against their host lowerings.
- the inference engine: a tiny GPT artifact built with the dense attention
  chain (T 1024) through ``AnalysisPredictor`` on ``cuda:0``: one biased
  K1 launch a layer a run, the logits within 1e-4 of the host predictor's;
  a toy ResNet artifact through ``conv_bn_fuse_pass`` (the folded weights
  on the card) within 1e-4 of the host's; ``conv_bn_train_fuse_pass``
  through ``apply_passes`` before ``minimize``: 6 K3 launches a step, the
  loss within 2^-6 of the host's (K3 rounds its operands to bf16).
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework import Program, Scope, program_guard
from paddle_tpu_torch.kernels import attn_skeleton as sk
from paddle_tpu_torch.kernels import conv_bn as cb
from paddle_tpu_torch.kernels import dense_epilogue as de
from paddle_tpu_torch.kernels import dropout as dk
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import layer_norm as ln
from paddle_tpu_torch.kernels import ring_attention as ra
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.parallel import make_mesh, set_mesh
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
             "t512_d64_bq128": (4, 512, 64, 128),
             # the attention-ceiling tool's first case
             "t2048_d64_bq64_tool": (24, 2048, 64, 64),
             "t128_d12_bq64_padded": (2, 128, 12, 64)}
# (bh, T, d, block_q) with every row of q, k, v, do scaled by 2^-8..2^8:
# products spanning 2^+-24, where two bf16 terms (~2^-17 of each value) or
# one tensor-core chain over all tiles would exceed 2^-20 of the terms
K8_HIGH_RANGE = {"d64_bq64": (4, 512, 64, 64),
                 "d128_bq64": (2, 256, 128, 64),
                 "d64_bq256": (2, 512, 64, 256),
                 "d128_bq128": (2, 256, 128, 128)}


def _k8_check(cuda, bh, t, d, bq, seed, high_range=False):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(bh, t, d, generator=g) for _ in range(4))
    if high_range:
        q, k, v, do = (x * torch.exp2(torch.randint(
            -8, 9, (bh, t, 1), generator=g).float()) for x in (q, k, v, do))
    q, k, v, do = (x.to(cuda) for x in (q, k, v, do))
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


@pytest.mark.parametrize("case", sorted(K8_SHAPES))
def test_k8_matches_plain_versions(cuda, case):
    bh, t, d, bq = K8_SHAPES[case]
    _k8_check(cuda, bh, t, d, bq, t + d)


@pytest.mark.parametrize("case", sorted(K8_HIGH_RANGE))
def test_k8_high_range_inputs_match_plain_versions(cuda, case):
    bh, t, d, bq = K8_HIGH_RANGE[case]
    _k8_check(cuda, bh, t, d, bq, 7 * t + d, high_range=True)


def test_k8_d128_t192_launches_each_kernel_once(cuda):
    """T = 192 is not a multiple of the forward's 128-row q tiles (its last
    tile is half past T); d 128 takes the backward's one-consumer layout."""
    sk.reset_launch_count()
    _k8_check(cuda, 2, 192, 128, 64, 192)
    assert sk.launch_count("attn_skeleton_fwd") == 1
    assert sk.launch_count("attn_skeleton_bwd") == 1


@pytest.mark.parametrize("d", [8, 64, 100, 128])
def test_k8_shared_memory_is_what_the_helper_says(cuda, d):
    import ctypes
    from paddle_tpu_torch.kernels import _build
    fn = _build.load("attn_skeleton").paddle_tpu_torch_attn_skeleton_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    assert fn(d, 0) == sk.shared_bytes(d)["fwd"]
    assert fn(d, 1) == sk.shared_bytes(d, 64)["bwd"]
    assert fn(d, 2) == sk.shared_bytes(d, 128)["bwd"]


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


# -- the bf16 forms of K1-K5 (AMP) -------------------------------------------
#
# Each bf16 kernel against its plain version on the same bf16 card tensors.
# The plain versions widen to float32, compute, and round the output once;
# the kernels take their float32 sums in other orders and round once too, so
# a bf16 output may land on the neighbouring bf16 value: within one bf16 ulp
# of the output's largest magnitude (plus the float32 allowance of the
# float32 form).  Float32 outputs (lse, s, s2, dscale, dbias) keep the
# float32 forms' tolerances.

BF16 = torch.bfloat16


def _ulp(t):
    """One bf16 ulp of ``t``'s largest magnitude."""
    top = float(t.float().abs().max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def _within_ulp(got, want, extra=0.0, what=""):
    assert got.dtype == want.dtype == BF16, what
    err = (got.float() - want.float()).abs()
    assert bool((err <= _ulp(want) + extra).all()), (
        what, float(err.max()), _ulp(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_k1_matches_plain_version(cuda, case):
    bh, tq, tk, d, causal, bias_kind = CASES[case]
    q, k, v, bias = _inputs(bh, tq, tk, d, bias_kind, cuda, seed=5)
    q, k, v = (t.to(BF16) for t in (q, k, v))
    n0 = fa.launch_count("flash_attn_fwd", "bfloat16")
    o, lse = fa.flash_attention_fwd(q, k, v, bias, causal)
    torch.cuda.synchronize()
    assert fa.launch_count("flash_attn_fwd", "bfloat16") == n0 + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, bias, causal)
    _within_ulp(o, ro, what="o")
    assert lse.dtype == torch.float32
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c][5] is None))
def test_bf16_k2_matches_plain_version(cuda, case):
    bh, tq, tk, d, causal, _ = CASES[case]
    q, k, v, o, lse, do = _bwd_inputs(bh, tq, tk, d, causal, cuda, seed=6)
    q, k, v, o, do = (t.to(BF16) for t in (q, k, v, o, do))
    n0 = fa.launch_count("flash_attn_bwd", "bfloat16")
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert fa.launch_count("flash_attn_bwd", "bfloat16") == n0 + 1
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                            causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _within_ulp(g, w, what=name)


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c][5] is None))
def test_bf16_k2_with_a_given_delta_matches_plain_version(cuda, case):
    """The bf16 K2's delta_ready path (ring attention's) at every shape of
    CASES against the plain backward given the same delta: rowsum(do * o)
    plus noise, so a kernel that computed its own delta would disagree."""
    bh, tq, tk, d, causal, _ = CASES[case]
    q, k, v, o, lse, do = _bwd_inputs(bh, tq, tk, d, causal, cuda, seed=7)
    q, k, v, o, do = (t.to(BF16) for t in (q, k, v, o, do))
    g = torch.Generator().manual_seed(8)
    delta = (torch.sum(do.float() * o.float(), dim=-1)
             + torch.randn(bh, tq, generator=g).to(cuda))
    n0 = fa.launch_count("flash_attn_bwd", "bfloat16")
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, None, delta)
    torch.cuda.synchronize()
    assert fa.launch_count("flash_attn_bwd", "bfloat16") == n0 + 1
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                            causal, None, delta)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        _within_ulp(g_, w_, what=name)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_bf16_k1_k2_refuse_an_operand_off_16_bytes(cuda, kernel):
    """The bf16 kernels read their operands by TMA, which needs 16-byte
    aligned bases: a contiguous view two bytes in is refused, not run."""
    q, k, v, o, lse, do = _bwd_inputs(2, 16, 16, 64, True, cuda)
    q, k, v, o, do = (t.to(BF16) for t in (q, k, v, o, do))
    q = torch.empty(q.numel() + 1, dtype=BF16, device=cuda)[1:].view(
        q.shape).copy_(q)
    assert q.is_contiguous() and q.data_ptr() % 16
    name = f"flash_attn_{kernel}"
    n0 = fa.launch_count(name, "bfloat16")
    with pytest.raises(ValueError, match="16-byte"):
        if kernel == "fwd":
            fa.flash_attention_fwd(q, k, v, None, True)
        else:
            fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    assert fa.launch_count(name, "bfloat16") == n0


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_k1_k2_take_a_float32_operand_off_16_bytes(cuda, kernel):
    """The float32 form reads q, k, v and do only in its split pass (TMA
    reads the term planes, scratch of its own), so a contiguous view one
    float past a 16-byte boundary runs, through the pass's scalar loads,
    and matches the plain version."""
    q, k, v, o, lse, do = _bwd_inputs(2, 130, 130, 64, True, cuda, seed=9)
    qu = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape).copy_(q)
    assert qu.is_contiguous() and qu.data_ptr() % 16
    name = f"flash_attn_{kernel}"
    n0 = fa.launch_count(name, "float32")
    if kernel == "fwd":
        got = fa.flash_attention_fwd(qu, k, v, None, True)
        want = fa.flash_attention_reference(q, k, v, None, True)
    else:
        got = fa.flash_attention_bwd(qu, k, v, o, lse, do, True)
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                                True)[:3]
    torch.cuda.synchronize()
    assert fa.launch_count(name, "float32") == n0 + 1
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-5)


def test_bf16_k1_k2_function_keeps_the_dtype(cuda):
    q, k, v = (torch.randn(2, 2, 64, 32, device=cuda).to(BF16)
               .requires_grad_() for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in grads)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(K3_SHAPES))
def test_bf16_k3_matches_plain_version(cuda, case, w_dtype):
    n, ci, co, p = K3_SHAPES[case]
    g = torch.Generator().manual_seed(ci + co + p + 1)
    x = torch.randn(n, ci, p, generator=g).to(cuda).to(BF16)
    w = (torch.randn(co, ci, generator=g) * ci ** -0.5).to(cuda).to(
        getattr(torch, w_dtype))
    n0 = cb.launch_count("conv1x1_stats", "bfloat16")
    y, s, s2 = cb.conv1x1_stats_fwd(x, w)
    torch.cuda.synchronize()
    assert cb.launch_count("conv1x1_stats", "bfloat16") == n0 + 1
    ry, rs, rs2 = cb.conv1x1_stats_plain(x, w)
    terms = torch.einsum("oc,ncp->nop", w.to(BF16).float().abs(),
                         x.float().abs())
    _within_ulp(y, ry, 2.0 ** -20 * terms, "y")
    yf = torch.einsum("oc,ncp->nop", w.to(BF16).float(), x.float())
    assert bool(((s - rs).abs()
                 <= 2.0 ** -14 * yf.abs().sum(dim=(0, 2)) + 1e-6).all())
    assert bool(((s2 - rs2).abs() <= 2.0 ** -14 * rs2 + 1e-6).all())


@pytest.mark.parametrize("case", sorted(LN_SHAPES))
def test_bf16_k4_matches_plain_version(cuda, case):
    rows, d = LN_SHAPES[case]
    g = torch.Generator().manual_seed(rows + d + 1)
    x = (torch.randn(rows, d, generator=g) * 2 + 0.5).to(cuda).to(BF16)
    if case.startswith("unaligned"):
        # a view one element past an 8-byte boundary: scalar accesses
        flat = torch.randn(rows * d + 1, generator=g).to(cuda).to(BF16)
        x = flat[1:].view(rows, d)
    s = (torch.randn(d, generator=g) + 1).to(cuda)
    b = torch.randn(d, generator=g).to(cuda)
    dy = torch.randn(rows, d, generator=g).to(cuda).to(BF16)
    n0 = (ln.launch_count("layer_norm_fwd", "bfloat16"),
          ln.launch_count("layer_norm_bwd", "bfloat16"))
    y = ln.layer_norm_fwd(x, s, b, 1e-5)
    dx, ds, db = ln.layer_norm_bwd(x, s, dy, 1e-5)
    torch.cuda.synchronize()
    assert (ln.launch_count("layer_norm_fwd", "bfloat16"),
            ln.launch_count("layer_norm_bwd", "bfloat16")) == (
        n0[0] + 1, n0[1] + 1)
    ry = ln.layer_norm_fwd_plain(x, s, b, 1e-5)
    rdx, rds, rdb = ln.layer_norm_bwd_plain(x, s, dy, 1e-5)
    _within_ulp(y, ry, what="y")
    _within_ulp(dx, rdx, what="dx")
    assert ds.dtype == db.dtype == torch.float32
    xhat = ln.layer_norm_fwd_plain(x.float(), torch.ones_like(s),
                                   torch.zeros_like(b), 1e-5)
    for got, want, terms in ((ds, rds, (dy.float() * xhat).abs()),
                             (db, rdb, dy.float().abs())):
        assert bool(((got - want).abs()
                     <= 2.0 ** -14 * terms.sum(dim=0) + 1e-6).all())


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,approximate", [("", False), ("relu", False),
                                             ("gelu", False), ("gelu", True)],
                         ids=["none", "relu", "gelu_erf", "gelu_tanh"])
@pytest.mark.parametrize("case", sorted(K5_SHAPES))
def test_bf16_k5_matches_plain_version(cuda, case, act, approximate,
                                       w_dtype):
    """bf16 x with bf16 w (the AMP path; read where they lie when K and N
    are multiples of 8, else through the padded copy) or float32 w."""
    m, k, n = K5_SHAPES[case]
    g = torch.Generator().manual_seed(m + k + n + 1)
    x = torch.randn(m, k, generator=g).to(cuda).to(BF16)
    w = (torch.randn(k, n, generator=g) * k ** -0.5).to(cuda).to(
        getattr(torch, w_dtype))
    b = torch.randn(n, generator=g).to(cuda)
    n0 = de.launch_count("dense_epilogue", "bfloat16")
    y = de.dense_act_fwd(x, w, b, act, approximate)
    torch.cuda.synchronize()
    assert de.launch_count("dense_epilogue", "bfloat16") == n0 + 1
    ry = de.dense_act_plain(x, w, b, act, approximate)
    terms = x.float().abs() @ w.to(BF16).float().abs()
    _within_ulp(y, ry, 2.0 ** -20 * terms, "y")


def test_bf16_k5_reads_an_unaligned_operand_through_the_copy(cuda):
    g = torch.Generator().manual_seed(11)
    flat = torch.randn(64 * 96 + 1, generator=g).to(cuda).to(BF16)
    x = flat[1:].view(64, 96)                # 2 bytes past 16-byte boundary
    w = (torch.randn(96, 136, generator=g) / 10).to(cuda).to(BF16)
    b = torch.randn(136, generator=g).to(cuda)
    y = de.dense_act_fwd(x, w, b, "gelu")
    torch.cuda.synchronize()
    _within_ulp(y, de.dense_act_plain(x, w, b, "gelu"),
                2.0 ** -20 * (x.float().abs() @ w.float().abs()), "y")


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4", "k5"])
def test_bf16_wrappers_refuse_mixed_or_other_dtypes(cuda, kernel):
    """A dtype the kernel does not take raises; it never falls back."""
    h = torch.float16
    with pytest.raises((TypeError, ValueError)):
        if kernel == "k1":
            q = torch.randn(2, 16, 64, device=cuda).to(BF16)
            fa.flash_attention_fwd(q, q.float(), q, None, True)
        elif kernel == "k2":
            q, k, v, o, lse, do = _bwd_inputs(2, 16, 16, 64, True, cuda)
            fa.flash_attention_bwd(q.to(BF16), k.to(BF16), v.to(BF16),
                                   o.to(BF16), lse, do, True)
        elif kernel == "k3":
            cb.conv1x1_stats_fwd(torch.randn(2, 8, 49, device=cuda).to(h),
                                 torch.randn(4, 8, device=cuda))
        elif kernel == "k4":
            x = torch.randn(4, 8, device=cuda).to(BF16)
            ln.layer_norm_bwd(x, torch.ones(8, device=cuda),
                              torch.randn(4, 8, device=cuda), 1e-5)
        else:
            de.dense_act_fwd(torch.randn(8, 16, device=cuda).to(BF16),
                             torch.randn(16, 4, device=cuda).to(BF16),
                             torch.randn(4, device=cuda).to(BF16))


def test_amp_tiny_gpt_step_on_the_card_matches_the_host(cuda):
    """One ``amp.decorate(Adam)`` step of a tiny GPT (flash attention, the
    fused head) on the card against the host: the bf16 K1 and K2 run once
    a layer; the loss within 2^-7 relative (bf16 products summed in other
    orders)."""
    from paddle_tpu_torch import amp, optimizer
    cfg = T.BertConfig(vocab_size=48, d_model=64, n_layer=2, n_head=2,
                       d_inner=128, max_pos=64, dropout=0.0)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss = T.build_gpt_pretrain(cfg, 64, fused_head=True,
                                          attn_impl="flash", dropout=0.0)
        amp.decorate(optimizer.AdamOptimizer(1e-3)).minimize(loss)
    scope, host_scope = Scope(), Scope()
    exe = ptt.Executor()
    exe.run(startup, scope=scope, seed=4)
    for name, val in scope.items():
        host_scope.set_var(name, val.detach().cpu())
    rng = np.random.RandomState(2)
    ids = rng.randint(1, 48, (2, 64)).astype(np.int64)
    feed = {"src_ids": ids, "lm_label": np.roll(ids, -1, axis=1)}
    n0 = (fa.launch_count("flash_attn_fwd", "bfloat16"),
          fa.launch_count("flash_attn_bwd", "bfloat16"))
    card, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert (fa.launch_count("flash_attn_fwd", "bfloat16") - n0[0],
            fa.launch_count("flash_attn_bwd", "bfloat16") - n0[1]) == (2, 2)
    host, = ptt.Executor(ptt.CPUPlace()).run(main, feed=feed,
                                              fetch_list=[loss],
                                              scope=host_scope)
    np.testing.assert_allclose(card, host, rtol=2.0 ** -7)
    for p in main.all_parameters():
        assert scope.find_var(p.name).dtype == torch.float32


# -- ring attention (K7) -------------------------------------------------------


def _merge_inputs(device, dtype, seed=9):
    g = torch.Generator().manual_seed(seed)
    bh, tq, d = 6, 200, 64
    o1, o2 = (torch.randn(bh, tq, d, generator=g) for _ in range(2))
    l1, l2 = (torch.randn(bh, tq, generator=g) * 4 for _ in range(2))
    l1[0, :40] = ra.NEG_INF                 # masked on the left
    l2[0, 20:60] = ra.NEG_INF               # on the right (20-39: both)
    l2[3, ::3] = ra.NEG_INF
    return [x.to(device) for x in (o1.to(dtype), l1, o2.to(dtype), l2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_merge_matches_plain_version(cuda, dtype):
    o1, l1, o2, l2 = _merge_inputs(cuda, getattr(torch, dtype))
    n0 = ra.launch_count("ring_merge", dtype)
    o, lse = ra.ring_merge(o1, l1, o2, l2)
    torch.cuda.synchronize()
    assert ra.launch_count("ring_merge", dtype) == n0 + 1
    ro, rlse = ra.ring_merge_reference(o1, l1, o2, l2)
    torch.testing.assert_close(lse, rlse, rtol=1e-6, atol=1e-6)
    assert bool((lse[0, 20:40] == ra.NEG_INF).all())
    if dtype == "float32":
        torch.testing.assert_close(o, ro, rtol=1e-6, atol=1e-6)
    else:
        err = (o.float() - ro.float()).abs()
        ulp = 2.0 ** (torch.floor(torch.log2(ro.float().abs()
                                             .clamp_min(1e-30))) - 7)
        assert o.dtype == BF16 and bool((err <= ulp).all()), float(err.max())


@pytest.mark.parametrize("bad", ["dtype", "layout", "lse"])
def test_ring_merge_wrapper_refuses_on_the_card(cuda, bad):
    o1, l1, o2, l2 = _merge_inputs(cuda, torch.float32)
    if bad == "dtype":
        o1, o2 = o1.half(), o2.half()
    elif bad == "layout":
        o1 = o1.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        l1 = l1.double()
    n0 = ra.launch_count()
    with pytest.raises((TypeError, ValueError)):
        ra.ring_merge(o1, l1, o2, l2)
    assert ra.launch_count() == n0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_full_attention_on_the_card(cuda, n, causal, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(n)
    q, k, v, do = (torch.randn(4, 256, 64, generator=g).to(cuda).to(dt)
                   for _ in range(4))
    devices = [cuda] * n
    fa.reset_launch_count()
    ra.reset_launch_count()
    o, lse = ra.ring_attention_fwd(q, k, v, devices, causal)
    dq, dk, dv = ra.ring_attention_bwd(q, k, v, o, lse, do, devices, causal)
    torch.cuda.synchronize()
    got = {"flash_attn_fwd": fa.launch_count("flash_attn_fwd", dtype),
           "flash_attn_bwd": fa.launch_count("flash_attn_bwd", dtype),
           "ring_merge": ra.launch_count("ring_merge", dtype)}
    assert got == ra.expected_launches(n, causal)
    ro, rlse = fa.flash_attention_fwd(q, k, v, None, causal)
    want = fa.flash_attention_bwd(q, k, v, ro, rlse, do, causal)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    if dtype == "float32":
        torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
        for g_, w_ in zip((dq, dk, dv), want):
            torch.testing.assert_close(g_, w_, rtol=2e-4, atol=2e-4)
    else:
        for name, g_, w_, ulps in zip(("o", "dq", "dk", "dv"),
                                      (o, dq, dk, dv), (ro,) + want,
                                      (2, 4, 4, 4)):
            assert g_.dtype == BF16, name
            err = float((g_.float() - w_.float()).abs().max())
            assert err <= ulps * _ulp(w_), (name, err, _ulp(w_))
    # against the plain ring: the same schedule through the plain steps
    po, plse = ra.ring_attention_fwd(q, k, v, devices, causal, plain=True)
    plain = ra.ring_attention_bwd(q, k, v, o, lse, do, devices, causal,
                                  plain=True)
    torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-5)
    for name, g_, w_ in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                            (po,) + plain):
        if dtype == "float32":
            torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-5,
                                       msg=name)
        else:
            # 4 bf16 ulps of each value plus 4 of the tensor's RMS
            w32 = w_.float()
            each = 2.0 ** (torch.floor(torch.log2(
                w32.abs().clamp_min(1e-30))) - 7)
            rms = float(w32.square().mean().sqrt())
            err = (g_.float() - w32).abs()
            assert bool((err <= 4 * (each + 2.0 ** (np.floor(np.log2(rms))
                                                    - 7))).all()), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_k2_with_a_given_delta_on_the_card(cuda, causal, dtype):
    """K2 with the caller's delta against its plain version given the same
    delta.  The delta is rowsum(do * o) plus noise, so a kernel that
    recomputed its own delta instead would disagree."""
    q, k, v, o, lse, do = _bwd_inputs(4, 130, 130, 64, causal, cuda)
    if dtype == "bfloat16":
        q, k, v, o, do = (x.to(BF16) for x in (q, k, v, o, do))
    g = torch.Generator().manual_seed(5)
    delta = (torch.sum(do.float() * o.float(), dim=-1)
             + torch.randn(4, 130, generator=g).to(cuda))
    n0 = fa.launch_count("flash_attn_bwd", dtype)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, None, delta)
    torch.cuda.synchronize()
    assert fa.launch_count("flash_attn_bwd", dtype) == n0 + 1
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                            causal, None, delta)[:3]
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        if dtype == "float32":
            torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-5,
                                       msg=name)
        else:
            _within_ulp(g_, w_, what=name)


def test_ring_bert_on_the_card_matches_the_host(cuda):
    """The toy BERT ring program, 2 SGD steps over 4 virtual ranks on the
    card and on the host: losses within 1e-5 relative."""
    from paddle_tpu_torch import optimizer
    cfg = T.BertConfig(vocab_size=64, d_model=64, n_layer=2, n_head=2,
                       d_inner=128, max_pos=64, dropout=0.0)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss = T.build_bert_pretrain(cfg, 64, attn_impl="ring",
                                           arange_pos=True)
        optimizer.SGDOptimizer(0.05).minimize(loss)
    scope, host_scope = Scope(), Scope()
    exe = ptt.Executor()
    exe.run(startup, scope=scope, seed=4)
    for name, val in scope.items():
        host_scope.set_var(name, val.detach().cpu())
    rng = np.random.RandomState(2)
    feed = {"src_ids": rng.randint(1, 64, (2, 64)).astype(np.int64),
            "lm_label": rng.randint(0, 64, (2, 64)).astype(np.int64)}
    host_exe = ptt.Executor(ptt.CPUPlace())
    try:
        for _ in range(2):
            set_mesh(make_mesh({"sp": 4}, [cuda] * 4))
            ra.reset_launch_count()
            card, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            assert ra.launch_count("ring_merge") == 2 * 12
            set_mesh(make_mesh({"sp": 4}, [torch.device("cpu")] * 4))
            host, = host_exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=host_scope)
            np.testing.assert_allclose(card, host, rtol=1e-5)
    finally:
        set_mesh(None)


# -- head dims that are not multiples of 8 (run zero-padded), and above 128 --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [12, 20])
def test_k1_k2_at_a_head_dim_off_8(cuda, d, dtype):
    """K1 and K2 at head dim 12 and 20 (zero-padded to 16 and 24 on the
    card) against their plain versions at the true d: float32 within 1e-4
    relative + 1e-5, bf16 within one bf16 ulp of each output's largest
    magnitude; one launch each, outputs of the true d."""
    dt = getattr(torch, dtype)
    q, k, v, o, lse, do = _bwd_inputs(4, 77, 90, d, False, cuda)
    q, k, v, do = (x.to(dt) for x in (q, k, v, do))
    n0 = (fa.launch_count("flash_attn_fwd", dtype),
          fa.launch_count("flash_attn_bwd", dtype))
    got_o, got_lse = fa.flash_attention_fwd(q, k, v, None, False)
    ro, rlse = fa.flash_attention_reference(q, k, v, None, False)
    grads = fa.flash_attention_bwd(q, k, v, ro, rlse, do, False)
    torch.cuda.synchronize()
    assert (fa.launch_count("flash_attn_fwd", dtype),
            fa.launch_count("flash_attn_bwd", dtype)) == (n0[0] + 1,
                                                          n0[1] + 1)
    want = fa.flash_attention_bwd_reference(q, k, v, ro, rlse, do, None,
                                            False)[:3]
    assert got_o.shape == q.shape and all(
        g_.shape == x.shape for g_, x in zip(grads, (q, k, v)))
    torch.testing.assert_close(got_lse, rlse, rtol=1e-4, atol=1e-5)
    for name, g_, w_ in zip(("o", "dq", "dk", "dv"), (got_o,) + grads,
                            (ro,) + tuple(want)):
        if dtype == "float32":
            torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-5,
                                       msg=name)
        else:
            _within_ulp(g_, w_, what=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_at_a_head_dim_off_8(cuda, dtype):
    """The ring over [cuda:0] * 4 at d = 20 against its plain version (the
    same schedule through the plain K1, K2 and merge): float32 within
    1e-4 relative + 1e-5, bf16 within 4 bf16 ulps of each value plus 4 of
    the tensor's RMS (the ring's tolerances in chip_smoke.py)."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(21)
    q, k, v, do = (torch.randn(4, 256, 20, generator=g).to(cuda).to(dt)
                   for _ in range(4))
    devices = [cuda] * 4
    o, lse = ra.ring_attention_fwd(q, k, v, devices, causal=True)
    grads = ra.ring_attention_bwd(q, k, v, o, lse, do, devices, causal=True)
    ro, rlse = ra.ring_attention_fwd(q, k, v, devices, causal=True,
                                     plain=True)
    want = ra.ring_attention_bwd(q, k, v, ro, rlse, do, devices,
                                 causal=True, plain=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-5)
    for name, g_, w_ in zip(("o", "dq", "dk", "dv"), (o,) + grads,
                            (ro,) + want):
        assert g_.shape == w_.shape == q.shape, name
        if dtype == "float32":
            torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-5,
                                       msg=name)
        else:
            gf, wf = g_.float(), w_.float()
            ulp = torch.exp2(torch.floor(torch.log2(wf.abs().clamp_min(
                1e-30))) - 7)
            rms = float(wf.square().mean().sqrt())
            bound = 4 * ulp + 4 * 2.0 ** (np.floor(np.log2(rms)) - 7)
            assert bool(((gf - wf).abs() <= bound).all()), name


def test_k1_refuses_a_head_dim_above_128_with_the_reason(cuda):
    q = torch.randn(2, 16, 136, device=cuda)
    n0 = fa.launch_count()
    with pytest.raises(ValueError, match="shared memory"):
        fa.flash_attention_fwd(q, q, q, None, True)
    with pytest.raises(ValueError, match="shared memory"):
        ra.ring_attention_fwd(q, q, q, [cuda] * 2)
    assert fa.launch_count() == n0


# -- K5 and the bf16 K3 on the Hopper GEMM core (csrc/sm90_gemm.cuh) ---------

# (M, K, N): a ragged M over the full width, K and N off 8 (the rounded
# copy), a ragged everything
K5_CORE = {"4097x768x3072": (4097, 768, 3072), "4097x100x130":
           (4097, 100, 130), "300x36x20": (300, 36, 20)}


@pytest.mark.parametrize("off", ["aligned", "x_off_16", "w_off_16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(K5_CORE))
def test_k5_core_edges(cuda, case, dtype, off):
    """K5 at a ragged M, K and N off multiples of 8, and with x or w one
    element past a 16-byte boundary (read through the rounded copy):
    float32 y within 1e-5 + 1e-4 relative + 2^-20 of sum |x||w|, bf16 y
    within one bf16 ulp of its largest magnitude plus that sum term."""
    m, k, n = K5_CORE[case]
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(m + k + n)

    def operand(rows, cols, scale, shifted):
        t = torch.randn(rows * cols + 1, generator=g) * scale
        t = t.to(cuda).to(dt)
        return t[1:].view(rows, cols) if shifted else t[:-1].view(rows, cols)

    x = operand(m, k, 1.0, off == "x_off_16")
    w = operand(k, n, k ** -0.5, off == "w_off_16")
    b = torch.randn(n, generator=g).to(cuda)
    n0 = de.launch_count("dense_epilogue", dtype)
    y = de.dense_act_fwd(x, w, b, "gelu")
    torch.cuda.synchronize()
    assert de.launch_count("dense_epilogue", dtype) == n0 + 1
    ry = de.dense_act_plain(x, w, b, "gelu")
    terms = x.to(BF16).float().abs() @ w.to(BF16).float().abs()
    if dtype == "float32":
        assert bool(((y - ry).abs() <= 1e-5 + 1e-4 * ry.abs()
                     + 2.0 ** -20 * terms).all())
    else:
        _within_ulp(y, ry, 2.0 ** -20 * terms, "y")


# (n, Cin, Cout, P): Cout 64 (half a 128-row tile), P 49 and 196 (rows that
# are not whole 16-byte chunks: laid out from raw slabs) with a last column
# tile short of images or pixels, P 56 (whole chunks: TMA), Cin off 8, a
# wide ragged P (x padded for TMA, y stored from the registers), and 12 k
# steps (both warpgroups on each laid-out stage, Cout off 256)
K3_CORE = {"cout64_p49": (3, 64, 64, 49), "cout64_p196": (3, 128, 64, 196),
           "p49_tail": (5, 256, 200, 49), "p196_tail": (3, 96, 72, 196),
           "p56_tma": (3, 64, 136, 56), "cin13_p196": (2, 13, 40, 196),
           "p300_padded_x": (2, 16, 24, 300),
           "cin768_p49_shared": (2, 768, 300, 49)}


@pytest.mark.parametrize("case", sorted(K3_CORE))
def test_bf16_k3_core_edges(cuda, case):
    """The bf16 K3 on the GEMM core at its layout edges: y within one bf16
    ulp of its largest magnitude + 2^-20 of sum |w||x|, s within 2^-14 of
    sum |y|, s2 within 2^-14 relative; one launch."""
    n, ci, co, p = K3_CORE[case]
    g = torch.Generator().manual_seed(ci + co + p + 7)
    x = torch.randn(n, ci, p, generator=g).to(cuda).to(BF16)
    w = (torch.randn(co, ci, generator=g) * ci ** -0.5).to(cuda)
    n0 = cb.launch_count("conv1x1_stats", "bfloat16")
    _bf16_k3_check(x, w)
    assert cb.launch_count("conv1x1_stats", "bfloat16") == n0 + 1


def _bf16_k3_check(x, w):
    y, s, s2 = cb.conv1x1_stats_fwd(x, w)
    torch.cuda.synchronize()
    ry, rs, rs2 = cb.conv1x1_stats_plain(x, w)
    terms = torch.einsum("oc,ncp->nop", w.to(BF16).float().abs(),
                         x.float().abs())
    _within_ulp(y, ry, 2.0 ** -20 * terms, "y")
    yf = torch.einsum("oc,ncp->nop", w.to(BF16).float(), x.float())
    assert bool(((s - rs).abs()
                 <= 2.0 ** -14 * yf.abs().sum(dim=(0, 2)) + 1e-6).all())
    assert bool(((s2 - rs2).abs() <= 2.0 ** -14 * rs2 + 1e-6).all())


@pytest.mark.parametrize("side", [28, 14])
def test_bf16_k3_on_a_stride_two_copy(cuda, side):
    """The strided shortcut's bf16 input, x[:, :, ::2, ::2] made contiguous
    (P = 196 and 49), as the fused op hands it to K3."""
    g = torch.Generator().manual_seed(side)
    x4 = torch.randn(2, 256, side, side, generator=g).to(cuda).to(BF16)
    w = (torch.randn(512, 256, generator=g) / 16).to(cuda)
    _bf16_k3_check(x4[:, :, ::2, ::2].contiguous().reshape(2, 256, -1), w)


def test_bf16_k3_reads_an_operand_off_16_bytes(cuda):
    """x one element past a 16-byte boundary: the kernel reads an aligned
    copy (channels padded to 8 on the way)."""
    g = torch.Generator().manual_seed(31)
    flat = torch.randn(2 * 64 * 196 + 1, generator=g).to(cuda).to(BF16)
    x = flat[1:].view(2, 64, 196)
    w = (torch.randn(48, 64, generator=g) / 8).to(cuda)
    _bf16_k3_check(x, w)


# -- the float32 K3 and K6 on the Hopper GEMM core ------------------------------

# (n, Cin, Cout, P): short last pixel tiles on the TMA route (3136 = 24 x
# 128 + 64, 784 = 6 x 128 + 16, 196 = 128 + 68) with a ragged channel tile,
# the slab route (P <= 64) with one image, an odd image count and Cout * P
# off 4 (y from the registers), Cin off 4 at both routes (channels or
# pixels copied), P off 4 above 64 (x copied, y from the registers)
K3_F32_CORE = {"p3136_tail": (2, 64, 136, 3136), "p784_tail": (2, 128, 64,
                                                                 784),
               "p196_tail": (3, 96, 72, 196), "p49_n1": (1, 512, 2048, 49),
               "p49_odd_n": (5, 256, 200, 49), "p64_slab": (3, 64, 40, 64),
               "p4_slab": (5, 16, 8, 4), "slab_y_regs": (3, 8, 5, 49),
               "cin13_p196": (2, 13, 40, 196), "cin6_p49": (3, 6, 20, 49),
               "p301_padded_x": (2, 16, 24, 301)}


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(K3_F32_CORE))
def test_f32_k3_core_edges(cuda, case, w_dtype):
    """The float32 K3 on the GEMM core at its routes' edges: K3's float32
    bounds; one launch."""
    n, ci, co, p = K3_F32_CORE[case]
    g = torch.Generator().manual_seed(ci + co + p + 11)
    x = torch.randn(n, ci, p, generator=g).to(cuda)
    w = (torch.randn(co, ci, generator=g) * ci ** -0.5).to(cuda)
    w = w.to(getattr(torch, w_dtype))
    n0 = cb.launch_count("conv1x1_stats", "float32")
    _k3_check(x, w)
    assert cb.launch_count("conv1x1_stats", "float32") == n0 + 1


@pytest.mark.parametrize("p", [784, 49])
def test_f32_k3_reads_an_operand_off_16_bytes(cuda, p):
    """x one element past a 16-byte boundary: the kernel reads an aligned
    copy, on either route."""
    g = torch.Generator().manual_seed(p)
    flat = torch.randn(2 * 64 * p + 1, generator=g).to(cuda)
    x = flat[1:].view(2, 64, p)
    w = (torch.randn(48, 64, generator=g) / 8).to(cuda)
    _k3_check(x, w)


@pytest.mark.parametrize("stats,relu", [(False, False), (False, True),
                                        (True, True), (True, False)],
                         ids=["plain", "relu", "norm_relu", "norm"])
@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [64, 128, 130])
def test_k6_core_edges(cuda, n, xdt, stats, relu):
    """K6 on the GEMM core at 64- and 128-column tiles, a ragged M (past a
    128-row tile) and K (past a 64-deep stage), each A path (SS for a bf16
    x with neither, A built in registers otherwise): K6's bounds; one
    launch."""
    x, w, ps = _k6_inputs(1000, 72, n, xdt, xdt, cuda, seed=n + len(xdt))
    _k6_check(x, w, ps if stats else None, relu)


@pytest.mark.parametrize("stats", [False, True], ids=["plain", "norm_relu"])
@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [64, 128])
def test_k6_core_takes_operands_off_16_bytes(cuda, n, xdt, stats):
    """x and w one element past a 16-byte boundary: x through its aligned
    copy, w through the bf16 copy every call makes."""
    dt = getattr(torch, xdt)
    g = torch.Generator().manual_seed(n + 5)
    x = torch.randn(300 * 64 + 1, generator=g).to(cuda).to(dt)[1:]
    w = (torch.randn(64 * n + 1, generator=g) / 8).to(cuda).to(dt)[1:]
    x, w = x.view(300, 64), w.view(64, n)
    assert x.data_ptr() % 16 and w.data_ptr() % 16
    _, _, ps = _k6_inputs(300, 64, n, xdt, xdt, cuda, seed=1)
    _k6_check(x, w, ps if stats else None, stats)


# -- the merge (K7) and the K4 backward redesigned for Hopper ---------------


MERGE_DIMS = [8, 12, 20, 64, 128, 136]


def _merge_rows(device, dtype, d, seed, bh=5, tq=203):
    """Partials of bh * tq rows (1015: no multiple of a block's rows) with
    NEG_INF rows on the left, on the right and on both."""
    g = torch.Generator().manual_seed(seed)
    o1, o2 = (torch.randn(bh, tq, d, generator=g) for _ in range(2))
    l1, l2 = (torch.randn(bh, tq, generator=g) * 4 for _ in range(2))
    l1[0, :40] = ra.NEG_INF
    l2[0, 20:60] = ra.NEG_INF               # 20-39: masked on both sides
    l2[3, ::3] = ra.NEG_INF
    l1[4, 1::7] = ra.NEG_INF
    return [x.to(device) for x in (o1.to(dtype), l1, o2.to(dtype), l2)]


@pytest.mark.parametrize("d", MERGE_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_merge_equals_plain_version_bit_for_bit(cuda, dtype, d):
    """The 16-byte form (d * size a multiple of 16) and the scalar form
    (bf16 d 12 and 20) give the plain version's o and lse exactly."""
    o1, l1, o2, l2 = _merge_rows(cuda, getattr(torch, dtype), d, seed=d)
    n0 = ra.launch_count("ring_merge", dtype)
    o, lse = ra.ring_merge(o1, l1, o2, l2)
    torch.cuda.synchronize()
    assert ra.launch_count("ring_merge", dtype) == n0 + 1
    ro, rlse = ra.ring_merge_reference(o1, l1, o2, l2)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert bool((lse[0, 20:40] == ra.NEG_INF).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_merge_off_16_bytes_takes_the_scalar_form(cuda, dtype):
    """o1 one element past a 16-byte boundary: the scalar form, the same
    bits as the plain version and as the 16-byte form on aligned copies."""
    dt = getattr(torch, dtype)
    a1, l1, o2, l2 = _merge_rows(cuda, dt, 64, seed=3)
    flat = torch.empty(a1.numel() + 1, dtype=dt, device=cuda)
    o1 = flat[1:].view(a1.shape)
    o1.copy_(a1)
    assert o1.data_ptr() % 16
    o, lse = ra.ring_merge(o1, l1, o2, l2)
    ro, rlse = ra.ring_merge_reference(o1, l1, o2, l2)
    vo, vlse = ra.ring_merge(a1, l1, o2, l2)
    torch.cuda.synchronize()
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert torch.equal(o, vo) and torch.equal(lse, vlse)


@pytest.mark.parametrize("d", [12, 64, 136])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_merge_in_place_gives_the_fresh_bits(cuda, dtype, d):
    """``out=(o1, lse1)``: the merge written over the first partial equals
    the merge into new tensors, and returns the out pair."""
    o1, l1, o2, l2 = _merge_rows(cuda, getattr(torch, dtype), d, seed=d + 1)
    o, lse = ra.ring_merge(o1, l1, o2, l2)
    a, b = o1.clone(), l1.clone()
    got = ra.ring_merge(a, b, o2, l2, out=(a, b))
    torch.cuda.synchronize()
    assert got[0] is a and got[1] is b
    assert torch.equal(a, o) and torch.equal(b, lse)


def test_ring_merge_refuses_an_out_over_another_input(cuda):
    o1, l1, o2, l2 = _merge_rows(cuda, torch.float32, 64, seed=4)
    n0 = ra.launch_count()
    for out in ((o2, l1), (o1, l2), (o1[:, :100].contiguous(), l1)):
        with pytest.raises(ValueError):
            ra.ring_merge(o1, l1, o2, l2, out=out)
    assert ra.launch_count() == n0


def _variance_allowance(x, s, dy, eps=1e-5):
    """Per value of dx, 4 float32 ulps of kappa times its row's largest
    term, kappa = (m^2 + var) / (var + eps): the one-pass variance both
    versions take (the TPU kernel's formula) keeps only 1 / kappa of
    float32's precision.  At d 4 a row of nearly equal values has kappa in
    the hundreds (16385 rows of the test's inputs): there the plain
    version itself misses a float64 evaluation of the formula by more than
    1e-4 relative, and the replaced kernel missed the plain version at the
    same values as this one.  Elsewhere the allowance is far below 1e-5."""
    xf, g = x.double(), dy.double() * s.double()
    m = xf.mean(dim=1, keepdim=True)
    var = ((xf * xf).mean(dim=1, keepdim=True) - m * m).clamp(min=0)
    rstd = torch.rsqrt(var + eps)
    xh = (xf - m) * rstd
    terms = rstd * (g.abs() + g.mean(dim=1, keepdim=True).abs()
                    + xh.abs() * (g * xh).mean(dim=1, keepdim=True).abs())
    kappa = (m * m + var) / (var + eps)
    return (4 * 2.0 ** -24 * kappa * terms.amax(dim=1, keepdim=True)).float()


def _k4_bwd_check(x, s, dy):
    """K4's backward against its plain version (dx: 1e-5 + 1e-4 relative in
    float32, with the one-pass variance's allowance, one bf16 ulp of
    max|dx| in bf16; dscale and dbias 2^-14 of the sum of their terms'
    magnitudes) and against a second call, bit for bit."""
    n0 = ln.launch_count("layer_norm_bwd")
    dx, ds, db = ln.layer_norm_bwd(x, s, dy, 1e-5)
    again = ln.layer_norm_bwd(x, s, dy, 1e-5)
    torch.cuda.synchronize()
    assert ln.launch_count("layer_norm_bwd") == n0 + 2
    rdx, rds, rdb = ln.layer_norm_bwd_plain(x, s, dy, 1e-5)
    if x.dtype == BF16:
        _within_ulp(dx, rdx, what="dx")
    else:
        assert bool(((dx - rdx).abs() <= 1e-5 + 1e-4 * rdx.abs()
                     + _variance_allowance(x, s, dy)).all())
    xhat = ln.layer_norm_fwd_plain(x.float(), torch.ones_like(s),
                                   torch.zeros_like(s), 1e-5)
    dyf = dy.float()
    for got, want, terms in ((ds, rds, (dyf * xhat).abs()),
                             (db, rdb, dyf.abs())):
        assert got.dtype == torch.float32
        assert bool(((got - want).abs()
                     <= 2.0 ** -14 * terms.sum(dim=0) + 1e-6).all())
    for a, b in zip((dx, ds, db), again):
        assert torch.equal(a, b)


def _k4_width(d, dtype):
    limit = ln.ROW_MAX_D[dtype]
    return {"limit": limit, "limit+4": limit + 4}.get(d) or int(d)


@pytest.mark.parametrize("rows", [1, 7, 16385])
@pytest.mark.parametrize("d", ["4", "12", "760", "768", "limit", "limit+4",
                               "4096"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_backward_at_the_row_form_edges(cuda, dtype, d, rows):
    """The one-warp-a-row form up to its widest d (12 and bf16 4 and 12
    with element accesses), the multi-warp form past it, at 1, 7 and
    16385 rows."""
    dt = getattr(torch, dtype)
    d = _k4_width(d, dt)
    g = torch.Generator().manual_seed(rows + d)
    x = (torch.randn(rows, d, generator=g) * 2 + 0.5).to(cuda).to(dt)
    s = (torch.randn(d, generator=g) + 1).to(cuda)
    dy = torch.randn(rows, d, generator=g).to(cuda).to(dt)
    _k4_bwd_check(x, s, dy)


@pytest.mark.parametrize("d", ["12", "768", "limit", "4096"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_backward_on_views_off_16_bytes(cuda, dtype, d):
    """x and dy one element past a 16-byte boundary: element accesses."""
    dt = getattr(torch, dtype)
    d = _k4_width(d, dt)
    rows = 33
    g = torch.Generator().manual_seed(d + 9)
    x = (torch.randn(rows * d + 1, generator=g) * 2 + 0.5).to(cuda).to(dt)
    dy = torch.randn(rows * d + 1, generator=g).to(cuda).to(dt)
    x, dy = x[1:].view(rows, d), dy[1:].view(rows, d)
    assert x.data_ptr() % 16 and dy.data_ptr() % 16
    s = (torch.randn(d, generator=g) + 1).to(cuda)
    _k4_bwd_check(x, s, dy)


def test_k4_partial_rows_agree_with_the_source(cuda):
    """The wrapper's scratch rule (``partial_rows``) is the source's, and
    the source refuses a launch given another count."""
    fn = ln._entry("partial_rows")
    for dtype, code in ln.DTYPES.items():
        for rows in (1, 63, 64, 65, 1024, 16385):
            for d in (4, 12, 760, 768, 769, 1024, 1025, 2048, 4096):
                assert fn(rows, d, code) == ln.partial_rows(rows, d, dtype), (
                    dtype, rows, d)
    x = torch.randn(100, 768, device=cuda)
    s = torch.ones(768, device=cuda)
    prow = ln.partial_rows(100, 768, torch.float32)
    part = torch.empty(2, prow + 1, 768, device=cuda)
    grads = torch.empty(2, 768, device=cuda)
    err = ln._entry("bwd")(x.data_ptr(), s.data_ptr(), x.data_ptr(),
                           torch.empty_like(x).data_ptr(), part.data_ptr(),
                           prow + 1, grads.data_ptr(), 100, 768, 1e-5, 0,
                           torch.cuda.current_stream().cuda_stream)
    assert err != 0


DECODE_CFG = dict(vocab_size=48, d_model=32, n_layer=2, n_head=2,
                  d_inner=64, max_pos=64, dropout=0.0)


def _decode_weights():
    cfg = T.BertConfig(**DECODE_CFG)
    scope, startup = Scope(), Program()
    with program_guard(Program(), startup):
        T.build_gpt_serving(cfg, 8)
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope, seed=5)
    return cfg, {n: v.numpy() for n, v in scope.items()}


def _prefill(eng, n_slots, n_steps, seed=0):
    """Teacher-force ``n_steps`` positions of random tokens into the first
    ``n_slots`` slots; returns the next step's (ids, pos, active)."""
    rng = np.random.RandomState(seed)
    S = eng.max_slots
    for s in range(n_slots):
        assert eng.reserve_slot(s, -(-(n_steps + 1) // eng.page_len))
    active = np.arange(S) < n_slots
    for t in range(n_steps):
        eng.run_iteration(rng.randint(1, 48, S), np.full(S, t), active)
    return rng.randint(1, 48, S), np.full(S, n_steps), active


def _close_or_equal(got, want):
    if not torch.equal(got, want):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale)


def test_decode_graph_matches_the_uncaptured_step(cuda):
    cfg, w = _decode_weights()
    eng = ptt.serving.DecodeEngine(cfg, w, max_slots=4, page_len=4,
                                   max_seq=32)
    assert eng.device == cuda and eng.cache.k.is_cuda
    ids, pos, active = _prefill(eng, 3, 9)
    k0, v0 = eng.cache.k.clone(), eng.cache.v.clone()
    got = torch.from_numpy(eng.run_iteration(ids, pos, active))
    want = eng.model.step_eager(
        eng.params, k0, v0, torch.as_tensor(ids, device=cuda),
        torch.as_tensor(pos, device=cuda),
        torch.as_tensor(eng.page_table, dtype=torch.long, device=cuda),
        torch.as_tensor(active, device=cuda))
    _close_or_equal(got, want.cpu())
    _close_or_equal(eng.cache.k[:, 1:], k0[:, 1:])
    _close_or_equal(eng.cache.v[:, 1:], v0[:, 1:])
    assert eng.trace_count == 1


def test_decode_graph_writes_the_live_pools_after_reinit(cuda):
    cfg, w = _decode_weights()
    eng = ptt.serving.DecodeEngine(cfg, w, max_slots=2, page_len=4,
                                   max_seq=32)
    ids, pos, active = _prefill(eng, 2, 5)
    k_ptr = eng.cache.k.data_ptr()
    eng.cache.reinit_pools()
    assert eng.cache.k.data_ptr() == k_ptr and not eng.cache.k.any()
    eng.run_iteration(ids, pos, active)
    page = eng.page_table[0, pos[0] // 4]
    written = eng.cache.k[:, page, pos[0] % 4]
    assert bool(written.abs().sum(-1).gt(0).all())
    # only this step's positions hold values: the rest stayed zeroed
    assert int((eng.cache.k[:, 1:].abs().sum((-1, -2)) > 0).sum()) == \
        cfg.n_layer * int(active.sum())
    assert eng.trace_count == 1


def test_two_decode_engines_capture_once_each(cuda):
    cfg, w = _decode_weights()
    engs = [ptt.serving.DecodeEngine(cfg, w, max_slots=2, page_len=4,
                                     max_seq=32) for _ in range(2)]
    outs = [_prefill(e, 2, 6, seed=3) for e in engs]
    logits = [e.run_iteration(*o) for e, o in zip(engs, outs)]
    np.testing.assert_array_equal(logits[0], logits[1])
    assert [e.trace_count for e in engs] == [1, 1]


def test_decode_server_on_the_card_matches_the_host(cuda):
    cfg, w = _decode_weights()
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 48, (n,)) for n in (3, 7, 12, 5, 9)]
    gens = []
    for place in (ptt.CUDAPlace(0), ptt.CPUPlace()):
        eng = ptt.serving.DecodeEngine(cfg, w, max_slots=3, page_len=4,
                                       max_seq=32, place=place)
        srv = ptt.serving.DecodeServer(eng).start()
        futs = [srv.submit("t", p, max_new_tokens=6) for p in prompts]
        gens.append([list(f.result(timeout=120)) for f in futs])
        assert srv.drain(10)
        srv.stop()
        assert eng.trace_count == 1 and eng.cache.pages_in_use() == 0
    assert gens[0] == gens[1]



# -- dropout -----------------------------------------------------------------

DROPOUT_CASES = {"bert_ffn": ((128, 3072), 0), "ragged": ((7, 333), 0),
                 "off_16_bytes": ((5, 100), 1), "one": ((1,), 0)}


@pytest.mark.parametrize("p", [0.1, 0.5, 0.001, 0.0, 1.0])
@pytest.mark.parametrize("case", sorted(DROPOUT_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_kernel_equals_plain_version_bit_for_bit(cuda, dtype, case,
                                                         p):
    shape, off = DROPOUT_CASES[case]
    g = torch.Generator().manual_seed(3)
    n = int(np.prod(shape))
    x = torch.randn(n + off, generator=g).to(cuda, getattr(torch, dtype))
    x = x[off:].reshape(shape)
    stream = dk.tagged_stream(0x123456789AB, 0x7FFFFFF1)
    n0 = dk.launch_count("dropout", dtype)
    out, mask = dk.dropout_fwd(x, stream, dk.threshold(p), 1 / (1 - p)
                               if p < 1 else 1.0, want_mask=True)
    torch.cuda.synchronize()
    assert dk.launch_count("dropout", dtype) == n0 + 1
    want, wmask = dk.dropout_plain(x, stream, dk.threshold(p),
                                   1 / (1 - p) if p < 1 else 1.0,
                                   want_mask=True)
    assert torch.equal(mask, wmask)
    assert torch.equal(out.view(torch.int16 if dtype == "bfloat16"
                                else torch.int32),
                       want.view(torch.int16 if dtype == "bfloat16"
                                 else torch.int32))
    # the stored mask in place of the stream (an untagged op's gradient)
    again, none = dk.dropout_fwd(x, None, 0, 2.0, mask_in=mask)
    assert none is None and torch.equal(again, dk.dropout_plain(
        x, None, 0, 2.0, mask_in=mask)[0])


def test_dropout_function_regenerates_the_mask_on_the_card(cuda):
    x = (torch.rand(64, 771, device=cuda) + 0.5).requires_grad_()
    stream = dk.counter_stream(99, 4)
    out = dk.dropout(x, stream, dk.threshold(0.25), 4 / 3)
    g, = torch.autograd.grad(out.sum(), x)
    torch.cuda.synchronize()
    assert torch.equal(g != 0, out != 0)
    assert torch.equal(out.cpu(), dk.dropout_plain(
        x.detach().cpu(), stream, dk.threshold(0.25), 4 / 3)[0])


def test_dropout_kernel_refuses_rather_than_falls_back(cuda, monkeypatch):
    x = torch.ones(64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dk.dropout_fwd(x, dk.tagged_stream(1, 2), 26, 1.0)
    x = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="threshold"):
        dk.dropout_fwd(x, dk.tagged_stream(1, 2), 257, 1.0)
    dk._entry()
    monkeypatch.setitem(dk._entries, "dropout", lambda *a: 98)
    monkeypatch.setattr(dk, "dropout_plain", None)  # never reached
    n0 = dk.launch_count()
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        dk.dropout_fwd(x, dk.tagged_stream(1, 2), 26, 1.0)
    assert dk.launch_count() == n0


def test_bert_step_with_dropout_on_the_card_matches_the_host(cuda):
    cfg = T.BertConfig(vocab_size=64, d_model=32, n_layer=2, n_head=4,
                       d_inner=64, max_pos=16, dropout=0.1)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss = T.build_bert_pretrain(cfg, 16, fused_head=True,
                                           arange_pos=True)
        ptt.optimizer.AdamOptimizer(1e-3).minimize(loss)
    host_scope, card_scope = Scope(), Scope()
    host = ptt.Executor(ptt.CPUPlace())
    host.run(startup, scope=host_scope, seed=1)
    for n, v in host_scope.items():
        card_scope.set_var(n, v.to(cuda))
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 64, (2, 16))
    feed = {"src_ids": ids, "lm_label": np.where(rng.rand(2, 16) < 0.3,
                                                 ids, 0)}
    n0 = dk.launch_count("dropout", "float32")
    got, = ptt.Executor().run(main, feed=feed, fetch_list=[loss],
                              scope=card_scope, seed=5)
    want, = host.run(main, feed=feed, fetch_list=[loss], scope=host_scope,
                     seed=5)
    # 9 dropouts and their 9 gradients, two of each in a fused FFN
    assert dk.launch_count("dropout", "float32") - n0 == 18
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _recompute_bert(recompute):
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework import unique_name
    cfg = T.BertConfig(vocab_size=1000, d_model=256, n_layer=2, n_head=4,
                       d_inner=1024, max_pos=128, dropout=0.1)
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        ckpts = [] if recompute else None
        _, _, loss = T.build_bert_pretrain(cfg, 128, fused_head=True,
                                           arange_pos=True,
                                           checkpoints=ckpts)
        opt = optimizer.LambOptimizer(1e-3)
        if recompute:
            opt = optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(ckpts)
        amp.decorate(opt).minimize(loss)
    return main, startup, loss


def test_recompute_on_the_card_matches_and_lowers_the_peak(cuda):
    init = Scope()
    ptt.Executor().run(_recompute_bert(False)[1], scope=init, seed=3)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 1000, (16, 128))
    feed = {"src_ids": ids, "lm_label": np.where(rng.rand(16, 128) < 0.3,
                                                 ids, 0)}
    losses, above = {}, {}
    for recompute in (False, True):
        main, _, loss = _recompute_bert(recompute)
        sc = Scope()
        for n, v in init.items():
            sc.set_var(n, v.clone())
        exe = ptt.Executor()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        losses[recompute] = [float(exe.run(main, feed=feed,
                                           fetch_list=[loss], scope=sc,
                                           seed=10 + s)[0])
                             for s in range(3)]
        above[recompute] = torch.cuda.max_memory_allocated() - held
        del sc, exe
    assert losses[True] == losses[False]
    assert above[True] < above[False], above


@pytest.mark.parametrize("op_type", ["lamb", "lars_momentum"])
def test_lamb_and_lars_updates_never_sync_with_the_host(cuda, op_type):
    from paddle_tpu_torch.framework import registry
    from paddle_tpu_torch.framework.executor import LowerCtx
    g = torch.Generator().manual_seed(0)
    p, grad = torch.randn(768, 3072, generator=g), \
        torch.randn(768, 3072, generator=g) * 1e-2
    ins = {"Param": [p], "Grad": [grad],
           "LearningRate": [torch.tensor([1e-3])]}
    if op_type == "lamb":
        ins.update(Moment1=[torch.zeros_like(p)],
                   Moment2=[torch.zeros_like(p)],
                   Beta1Pow=[torch.tensor([0.9])],
                   Beta2Pow=[torch.tensor([0.999])])
    else:
        ins.update(Velocity=[torch.zeros_like(p)])
    lower = registry.get_op_info(op_type).lower
    want = lower(LowerCtx(torch.device("cpu"), 0), ins, {})
    card_ins = {s: [v.to(cuda) for v in vs] for s, vs in ins.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = lower(LowerCtx(cuda, 0), card_ins, {})
        with pytest.raises(RuntimeError):
            card_ins["Param"][0].sum().item()     # the mode is on
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for slot, vals in want.items():
        for w, c in zip(vals, got[slot]):
            torch.testing.assert_close(c.cpu(), w, rtol=1e-6, atol=1e-7)


def _tiny_gpt_artifact(path, seq=1024):
    cfg = T.BertConfig(vocab_size=64, d_model=64, n_layer=2, n_head=2,
                       d_inner=128, max_pos=seq, dropout=0.0)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, logits = T.build_gpt_serving(cfg, seq, attn_impl="base")
    sc = Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=3)
    ptt.save_inference_model(str(path), ["src_ids"], [logits], exe,
                             main_program=main, scope=sc)
    return cfg


def _predictors(path):
    from paddle_tpu_torch import inference as inf
    host = inf.AnalysisConfig(str(path))
    host.disable_gpu()
    return (inf.create_paddle_predictor(inf.AnalysisConfig(str(path))),
            inf.create_paddle_predictor(host))


def test_predictor_on_the_card_runs_the_biased_k1(cuda, tmp_path):
    from paddle_tpu_torch import inference as inf
    cfg = _tiny_gpt_artifact(tmp_path)
    card, host = _predictors(tmp_path)
    assert card.device == cuda and all(
        t.device == cuda for t in card._params.values())
    ids = np.random.RandomState(0).randint(1, 64, (2, 1024))
    fa.reset_launch_count()
    got = card.run([inf.PaddleTensor(ids, name="src_ids")])[0].as_ndarray()
    assert fa.launch_count("flash_attn_fwd") == cfg.n_layer
    want = host.run([inf.PaddleTensor(ids, name="src_ids")])[0].as_ndarray()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_predictor_on_the_card_folds_conv_bn(cuda, tmp_path):
    from paddle_tpu_torch import inference as inf
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import resnet
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("image", shape=[16, 8, 8], dtype="float32")
        h = resnet.bottleneck_block(img, 16, 1, "bb0", is_test=True)
        h = resnet.bottleneck_block(h, 16, 2, "bb1", is_test=True)
        pred = layers.fc(layers.pool2d(h, pool_type="avg",
                                       global_pooling=True), size=4)
    sc = Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=5)
    ptt.save_inference_model(str(tmp_path), ["image"], [pred], exe,
                             main_program=main, scope=sc)
    card, host = _predictors(tmp_path)
    assert card.pass_counts["conv_bn_fuse_count"] == 8
    xs = np.random.RandomState(1).rand(4, 16, 8, 8).astype(np.float32)
    got = card.run([inf.PaddleTensor(xs, name="image")])[0].as_ndarray()
    want = host.run([inf.PaddleTensor(xs, name="image")])[0].as_ndarray()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_conv_bn_train_pass_launches_k3(cuda):
    from paddle_tpu_torch import flags, layers, optimizer
    from paddle_tpu_torch.framework import ir
    from paddle_tpu_torch.models import resnet
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", shape=[16, 8, 8], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        h = resnet.bottleneck_block(img, 16, 1, "bb0")
        h = resnet.bottleneck_block(h, 16, 2, "bb1")
        pred = layers.fc(layers.pool2d(h, pool_type="avg",
                                       global_pooling=True), size=4,
                         act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, label))
    fused = ir.apply_passes(main, ["conv_bn_train_fuse_pass"])
    floss = fused.global_block().var(loss.name)
    with program_guard(fused, startup):
        optimizer.MomentumOptimizer(0.1, 0.9).minimize(floss)
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(4, 16, 8, 8).astype(np.float32),
            "label": rng.randint(0, 4, (4, 1)).astype(np.int64)}
    card_scope, host_scope = Scope(), Scope()
    ptt.Executor().run(startup, scope=card_scope, seed=3)
    for n, v in card_scope.items():
        host_scope.set_var(n, v.cpu())
    flags.set_flags({"FLAGS_graph_fusion": False})
    try:
        cb.reset_launch_count()
        got, = ptt.Executor().run(fused, feed=feed, fetch_list=[floss],
                                  scope=card_scope)
        assert cb.launch_count("conv1x1_stats") == 6
        want, = ptt.Executor(ptt.CPUPlace()).run(
            fused, feed=feed, fetch_list=[floss], scope=host_scope)
    finally:
        flags.set_flags({"FLAGS_graph_fusion": True})
    assert abs(float(got) - float(want)) <= 2.0 ** -6 * abs(float(want))
