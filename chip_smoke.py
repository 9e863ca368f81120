#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--profile]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(``/usr/local/cuda``).  It imports only the port, never ``paddle_tpu`` or
JAX, prints one line per phase, and raises on any failure:

1. ``env``    — the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, the nvcc build of every kernel from ``csrc/``, and
   the g++ build of the parameter server (``csrc/ps_server.cc``).
2. ``kernel`` — each hand-written kernel against its plain PyTorch version
   on the card, at the shapes of the main paths and at the edge cases,
   float32 with TF32 off: ``|kernel - plain| <= ATOL + RTOL * |plain|``
   (plus, for the bf16 products of K3, K5 and K6 and the float32 products
   of K8, 2^-20 of the sum of the terms' magnitudes, one bf16 ulp for K6's
   bf16 outputs, and for the column sums of K3, K4's backward and K6, 2^-14
   of theirs).  K1/K2 run their Hopper sources in both dtypes (TMA, bf16
   ``wgmma``; float32 as six bf16 term products a product): the float32
   form's ptxas lines and shared memory are printed first, and each
   float32 K1/K2 line also counts the outputs more than 4 float32 ulps from
   the plain version's and how many of those lie nearer zero (and, without
   a bias at Tq = Tk, the same for SDPA float32's o as a yardstick); the
   cases include head dims 12 and 20, which run zero-padded.  K6 at
   ``rn50_fused_bench``'s four calls and at float32 edges; K8 (Hopper,
   float32 as bf16 term products: its ptxas lines, C7507 / C7512 notes,
   HGMMA count in SASS and shared memory printed first) at [4, 512, 64 |
   128], block_q 64 and 128, at the ``attn_ceiling`` path's calls, and
   with rows scaled by 2^-8..2^8.  Then the bf16 forms of K1-K5 (AMP)
   against their plain versions: K1/K2 (their ptxas lines and shared
   memory printed first) at [96, 2048, 64] causal, T 1000, biased
   (forward), d 128 at T 130, d 40 ragged non-causal, causal Tq < Tk and
   d 12 and 20, each line also counting the outputs that differ from the
   plain version's and how many of those lie nearer zero;
   K3 at the 15 shapes at batch
   256 (bf16 x, float32 w); K4 at [16384, 768] and 4099 rows; K5 at
   [16384, 768] x [768, 3072] gelu and relu and M 4097: each bf16 output
   within one bf16 ulp of its largest magnitude (plus the float32
   allowance of K3's and K5's sums), the float32 outputs as above; the K3
   and K5 lines count their flipped outputs the same way (K3 in both
   dtypes, K5 and K6 run on the Hopper GEMM core, ``csrc/sm90_gemm.cuh``;
   the float32 K3 and K6 build their A operands in registers: their ptxas
   lines are printed first, and ``tools/gemm_flips.py`` prints a digest of
   each output with the share off the plain version's value at the float32
   K3's 15 shapes at batch 128 and K6's calls).
3. ``serve``  — the GPT causal LM at BERT-base width (vocab 30522, d 768,
   12 layers, 12 heads, d_inner 3072, max_pos 2048, random weights from a
   seed) behind ``InferenceServer`` with buckets (512, 1024, 2048) and
   ``max_batch`` 8: warmup, then 24 requests of 300-2048 tokens from two
   tenants.  Each bucket's program goes through ``CompiledProgram.
   _optimized`` (the verifier, dead-op elimination, the fusion pass:
   12 ``fused_dense_act`` at default flags, without the kernel).  Every
   result must be finite ``[len, 30522]`` logits, the flash forward must
   have launched 12 times per batch dispatched to a bucket >= 1024 (and
   nowhere else), and one 1100-token request must match the same bucket
   program run by the port on the CPU.
   ``decode`` — the same model and weights behind ``DecodeServer`` over
   ``DecodeEngine(cfg, scope, max_slots=8)`` at the flag defaults (page_len
   16, max_seq 2048: 128 pages a slot, 1025 pages, 2 x 604 MB of pools),
   the step captured once as a CUDA graph: 15 requests with prompts of
   32-384 tokens (seed 11) from two tenants and ``max_new_tokens`` 32, then
   a 16th repeating the shortest prompt with ``eos_id`` its first greedy
   token, which must return that one token; every request the right length,
   ``trace_count`` 1 and no page in use at the end.  Two requests' logits,
   teacher-forced through the engine at every position, against the
   bucket-512 serving program on the card (``SERVE_ATOL``/``SERVE_RTOL``),
   each generated token its argmax or within that tolerance of it (counted);
   64 positions against a ``DecodeEngine(place=CPUPlace())``; the graph
   against the uncaptured step on the same inputs and pools (bit for bit,
   else within 1e-6 relative); the iteration's median and p90 ms at
   occupancy 8, tokens/s, the graph against the uncaptured step over 50
   iterations, peak card memory, and under ``--profile`` both steps by
   kernel.  No hand-written kernel launches on this path.
4. ``train``  — the same model trained through the Fluid entry points
   (``build_gpt_pretrain`` with the fused head, ``AdamOptimizer.minimize``,
   ``Executor().run``) at seq 2048, batch 8, float32: one warm-up step and
   5 timed steps on one fixed batch.  The executor's fusion pass rewrites
   the 12 FFN chains into ``fused_dense_act`` (float32, no kernel at
   default flags).  The losses must be finite and fall,
   and every step must launch the flash forward and the flash backward 12
   times each.  Then a 2-layer, batch-1, seq-1024 step on the card must
   match the same step run by the port on the CPU.
   ``amp_train`` — the same under ``amp.decorate(AdamOptimizer(1e-4))``
   (bf16 AMP, ``bench.py:424``): every step launches the bf16 K1 and K2 12
   times each and no float32 form; finite, falling losses, the first
   within 2^-7 of ``train``'s first; every parameter float32 after the
   steps; a 2-layer AMP step on the card against the host.
5. ``resnet`` — ResNet-50 (1000 classes, 3x224x224, depth 50, random
   weights from a seed) trained through ``build_resnet_train``,
   ``MomentumOptimizer(0.1, 0.9).minimize`` and ``Executor().run`` at batch
   128, float32, TF32 off: the executor's fusion pass rewrites the 36
   conv1x1 + batch_norm pairs into ``fused_conv1x1_bn``, so every step must
   launch K3 36 times; one warm-up step and 5 timed steps on one fixed
   batch, with finite, falling losses.  Then one step on the card against
   the same step on the host: fused (the card rounds K3's operands to
   bf16, the host multiplies in float32) on a toy of two bottleneck blocks
   (loss within 2^-6) and at depth 50, 3x64x64, batch 8 (within 2^-3), and
   unfused (``FLAGS_graph_fusion`` off, float32 on both sides) at depth 50
   (loss 1e-4, BN running statistics 2^-10 and classifier gradients 2^-8
   of their largest magnitude).
   ``amp_resnet`` — ResNet-50 under ``amp.decorate(MomentumOptimizer(0.1,
   0.9))`` (``bench.py:189``) at batch 256 (``bench.py:182``): 36 bf16 K3
   launches a step (bf16 x, float32 master w) and no float32 form; finite,
   falling losses, parameters float32; an AMP step of the toy and of depth
   50 at 3x64x64 on the card against the host (the toy's loss, BN running
   statistics and classifier gradients; depth 50's loss within 2^-3).
   ``predict`` (after ``resnet``) — the inference engine.  The GPT of
   ``serve`` (its weights) built with the dense attention recipe
   (``build_gpt_serving(cfg, 2048, attn_impl="base")``, the causal mask
   built in the graph), saved with ``save_inference_model`` and loaded by
   ``create_paddle_predictor(AnalysisConfig(dir))``: the analysis passes
   must leave 12 ``flash_attention`` ops, each with the mask as its Bias,
   and no softmax; a batch of 4 x 2048 seeded ids runs once to warm up
   and 3 times timed through ``run`` (ids in, logits out to the host), then
   3 times through ``zero_copy_run`` (the logits stay on the card), each
   run launching the biased float32 K1 12 times and no other kernel; the
   logits of sequence 0 within ``SERVE_ATOL``/``SERVE_RTOL`` of the same
   analyzed program run on the host (``program_as_function`` over the
   params on the host); ``NativePaddlePredictor`` (the dense chain and the
   exact GELU) timed and its largest logit difference recorded, not held;
   a second predictor on the directory one engine-cache hit.  The biased
   K1 alone at that shape ([48, 2048, 64], a [1, 2048, 2048] bias) against
   its plain version, then timed beside the plain version and SDPA with
   the same mask.  ResNet-50 inference (``resnet(img, depth=50,
   is_test=True)``) over the ``resnet`` phase's trained scope, batch 64,
   float32: ``conv_bn_fuse_count`` 53, and the probabilities and the
   classifier's logits of the analyzed program against the native one
   (``PREDICT_*`` constants), no kernel launched.  The toy ResNet's
   training program through ``apply_passes(..., ["conv_bn_train_fuse_pass"])``
   before ``minimize``, graph fusion off: 6 ``fused_conv1x1_bn``, K3
   launched 6 times a step, 3 Momentum steps with losses within
   ``RESNET_TOY_LOSS_RTOL`` of the unrewritten program's.  Each part
   prints its times (run, load and analysis on the host) and peak card
   memory beside the card's name and power limit.
6. ``fused_train`` — the GPT of ``train`` (the same program, batch and
   seeds) with the fusion autotuner on (``FLAGS_fusion_autotune``, rank
   threshold 0, verdicts cached in a fresh temporary directory): the plan
   must hold 12 ``fused_dense_act`` and 1 ``fused_embedding_layer_norm``
   with ``use_pallas`` set, and their grads (24 ``layer_norm`` left of 25);
   every autotune verdict must be a win.  One warm-up step (which also
   times the autotuner's candidates) and 5 timed steps, each launching K5
   12 times, K4's forward and backward once, K1 and K2 12 times; finite,
   falling losses.  Then the fused program of a 2-layer, batch-1, seq-1024
   step runs on the card and on the host, with the train phase's
   tolerances.  ``amp_fused_train`` — the same under AMP: the bf16 K5 and
   K4 as the autotune verdicts give them (records keyed ``"amp"``), the
   bf16 K1 and K2 12 times a step.
7. ``rn50_fused`` — ``paddle_tpu_torch.tools.rn50_fused_bench.main()``
   at both ResNet-50 stage shapes (M 802,816 and 200,704, bf16): the fused
   chain (two K6 launches, the normalize + relu folded into the second)
   against the library chain, sums within 2^-7 relative, then both timed.
8. ``attn_ceiling`` — ``paddle_tpu_torch.tools.attn_shape_ceiling.main()``
   at (T, bh) = (2048, 24), (8192, 6), (16384, 2), d 64: the K8 skeletons
   (and the forward at d 128) against K1 and K1 + K2; each report printed
   with ``fwd_vs_skel`` and ``fb_vs_skel`` (the skeletons run K1/K2's
   float32 arithmetic, so each is at least 1 where the skeleton is the
   ceiling it should be).
9. ``ring_kernel`` — ring attention (K7) at [24, 8192, 64] (BERT-base at
   batch 2 x 8192) with sp 4 over ``[cuda:0] * 4`` (four virtual ranks on
   the one card), float32 and bf16, causal and not: the ring's forward and
   backward launch K1, K2 and the merge kernel as the schedule says (n^2
   K1 and K2 and n(n - 1) merges, causal n(n + 1)/2 and n(n - 1)/2); o,
   lse, dq, dk and dv match the plain ring, the same schedule through the
   plain K1, K2 and merge (float32: the kernels' 1e-5 + 1e-4 relative;
   bf16: 4 bf16 ulps of each value + 4 of the tensor's RMS), and K1/K2
   over the full T (float32: o 2e-5, gradients 2e-4; bf16: 2 bf16 ulps of
   max|o|, 4 of each gradient's, and 8 of each value + 8 of the RMS); the
   merge kernel matches its plain version with NEG_INF rows on either side
   and on both (1e-6; one bf16 ulp).  ``kernel`` and ``kernel_bf16`` hold
   K1 and K2 (given the ring's delta) at a ring step's [24, 2048, 64]
   shard, causal and not, against their plain versions.  ``kernel``
   prints what ptxas says of the merge and K4's row backward.
10. ``ring_train`` — ``bench.py:531-567``'s 8k line with
   ``attn_impl="ring"``: BERT-base pretraining at batch 2 x 8192 under
   ``amp.decorate(AdamOptimizer(1e-4))`` with sp 4 over ``[cuda:0] * 4``,
   1 warm-up + 3 steps, each launching the bf16 K1 and K2 12 x 16 times and
   the bf16 merge 12 x 12 times; the same program with
   ``attn_impl="flash"`` from the same seed and feed, and every ring loss
   within 1e-4 relative of its step's flash loss.
11. ``timing`` — each kernel, its plain version and one PyTorch library call
   computing the same function, with CUDA events, at the main-path shapes
   ([96, 2048, 64] causal for K1/K2, ResNet-50's 15 conv1x1 shapes at batch
   128 for K3, [16384, 768] for K4, [16384, 768] x [768, 3072] gelu for
   K5, the four rn50_fused calls for K6, [24, 2048, 64] for K8 (its bound
   at the term-product rate), which no single library call computes; K3
   in both dtypes also shape by shape, with the route its x takes: TMA,
   or raw slabs (laid out by the producer in bf16, read from the slab into
   registers in float32); the float32
   K3, K6 and their library calls also on the card alone, as K4, in
   ``held_ms`` and ``library_held_ms``); the least time the card could
   take
   (``bound``; for the float32 K1/K2, K8 and ring at the rate of float32
   products as six bf16 term products, 989 / 6 TFLOP/s on an H100, with
   the CUDA-core rate's beside it); the server's per-bucket batch
   latency, requests/s and tokens/s, the GPT training steps' time, tokens/s
   and peak memory (plain and fused), and the ResNet step's time, images/s,
   peak memory and summed K3 time; the bf16 forms of K1-K5 at the AMP
   paths' shapes against SDPA, ``F.layer_norm``, and the bf16 matmul
   compositions, and the three AMP paths' steps; the ring's forward and
   backward at ``ring_kernel``'s
   shape (non-causal) against K1/K2 and SDPA over the full T, the plain
   ring and the bound, the merge kernel at a ring step's shape, and the
   ring and flash training steps.  The merge (as the ring calls it, in
   place) and K4's backward are timed warm (the same inputs call after
   call, L2-resident) and cold (input sets of more than the 50 MB L2 in
   all, in turn): their ``ms`` and share of the bound are the cold time,
   ``warm_ms`` the other.  ``--profile`` adds, by kernel class, a
   bucket-2048 serving batch, a float32 and an AMP GPT step, a ResNet-50
   step (float32 and AMP) and one step of each ``ring_train`` program
   (ring and flash).
12. ``bert_train`` — BERT-base MLM pretraining at ``bench.py:264-300``'s
   full configuration with its default dropout 0.1 (``BertConfig()``,
   batch 128 x seq 128, fused head, arange positions, AMP Adam) and the
   fusion autotuner on, 1 + 5 steps: finite losses, the bf16 dropout
   kernel launched 98 times a timed step (49 dropouts, 49 gradients), the
   bf16 K5 and K4 as the verdicts give them; then a 2-layer AMP step of
   the same width, autotuned, against the host at the same masks (the
   bits depend only on the seed and the tags), and the fused 2-layer
   float32 program against the unfused one on the card (3 steps, losses
   within 1e-5 relative); ``--profile`` adds one step by kernel class.
   ``bert_masked`` — the ``masked_gather=20`` line (``bench.py:323-357``),
   1 + 3 steps.  ``transformer_wmt`` — Transformer-base WMT
   (``bench.py:579-625``: V 37000, d 512, 6 + 6 layers, batch 32 x seq
   256, AMP Adam), 1 + 3 steps, 86 dropout launches a step.
   ``se_resnext`` — SE-ResNeXt-50 (3x224x224, 1000 classes, Momentum,
   float32, TF32 off) at batch 64, 1 + 3 steps; whether the 1x1 conv + BN
   pairs went to K3 is reported.  The ``kernel`` phases hold the dropout
   kernel against its plain version bit for bit (out, mask and both
   gradient forms) at [128, 128, 768] and [128, 12, 128, 128], p 0.1,
   0.5, 0.001, 0 and 1, both implementations, with the keep rate within 5
   binomial standard deviations; ``timing`` times it cold at [128, 12,
   128, 128] beside ``F.dropout``, and the new paths' steps.
13. ``recompute_train`` — ``bert_train``'s BERT-base (batch 128 x seq
   128, dropout 0.1, AMP, autotuner on) under LAMB (weight decay 0.01,
   none on LayerNorm scales and biases), built twice at one seed: (a)
   ``amp.decorate(LambOptimizer).minimize`` and (b) through
   ``RecomputeOptimizer`` over the 12 layer outputs (``checkpoints=[]``);
   one autotune cache, the same weights, 1 + 3 steps each: each step's
   loss, the median step time and tokens/s, the peak memory and the part
   above what was allocated before the program's first step, and the
   launches a step of the bf16 K5, K4 and dropout kernel, which must equal
   what the planned program's ops give (the recomputed chains' included).
   (a) and (b) must give the same losses to the bit and (b) the lower peak
   above its start.
   ``seq2seq`` (before ``optimizers``) — control flow, float32 with TF32
   off: ``tests/_seq2seq.py``'s model at the widths of PaddlePaddle/models
   ``rnn_search`` (IWSLT'15 en-vi, ``run.sh`` / ``infer.sh``): embedding
   [17191, 512], ``contrib.layers.basic_lstm`` (2 layers, hidden 512,
   masked by the source lengths, dropout 0.2 between the layers; a
   ``static_scan`` a layer), a ``contrib.decoder.StateCell`` LSTM step
   under ``TrainingDecoder`` over embedding [7709, 512] of the shifted
   target (no attention: the reference's decoder API has none), ``fc`` to
   7709 and ``softmax_with_cross_entropy`` masked by ``sequence_mask``;
   lengths in [10, 50] from the seed, padded to 50.  (a) batch 128, Adam
   1e-3 clipped by global norm 5.0, ``SEQ2SEQ_STEPS`` steps on the card
   and on the host, each from the host's state: each loss within
   ``SEQ2SEQ_LOSS_RTOL`` relative, and the clipped gradients of
   ``SEQ2SEQ_GRADS`` within ``SEQ2SEQ_GRAD_RTOL`` (``_rel_diff``); it
   prints the step ms, the peak above held and the ops a step (those
   inside sub-blocks counted as they run).  (b) the
   same cell under ``BeamSearchDecoder`` (beam 10, topk 10, max_len 50,
   end_id 1; the encoder's states expanded to the beam in the program),
   saved by ``save_inference_model`` with (a)'s trained weights, loaded on
   the card and on the host, run on 16 sentences (160 beam rows): the
   ``SentenceIds`` equal to the host's, or, where a sentence's differ, the
   first beam step whose choice differs a near-tie on the host (its best
   candidates within ``SEQ2SEQ_TIE``); the ``SentenceScores`` within
   ``SEQ2SEQ_SCORE_RTOL`` relative where the ids agree; it prints the ms
   a decode, the while's iterations and the host syncs of its condition
   (one an iteration, and one to see it false).  (c) one case of
   ``tests/test_while_grad.py``'s numeric parity at width 512: x times w
   three times under a While bounded at 4 trips, the loss and the
   gradients of x and w within ``ATOL`` + ``RTOL`` of the host's, d loss /
   d w within 1e-3 of central differences on the card.  (d) a StaticRNN
   of (a)'s batch, length and width whose body holds an untagged dropout
   (tanh fc cell, dropout ``SEQ2SEQ_DROPOUT``), differentiated: the
   gradient's replay runs the dropout kernel inside its autograd Function
   and rewinds the run's counter to the forward's, so the loss and the
   gradients of x and of the cell's weight match the host's within
   ``SEQ2SEQ_LOSS_RTOL`` / ``SEQ2SEQ_GRAD_RTOL`` and are not zero; the
   kernel launches 3 times a step (forward, replay, backward).  No K1-K8
   launches on the path; the dropout kernel launches for the encoder's
   dropout and its grad, as the program's ops say, and for (d), and
   matches its plain version at the path's shape bit for bit.  The phase's wall time is printed against
   its budget, ``SEQ2SEQ_BUDGET_S``.
14. ``optimizers`` — the 10 optimizer classes this slice added, and
   Lookahead, ModelAverage and ExponentialMovingAverage over Adam: a
   1-layer BERT of BERT-base's width (2 layers until the PS slice; float32
   with the dense LM head, TF32
   off, dropout 0.1, batch 4 x 128) takes 3 steps on the card and on the
   host, each from the host's state: losses within 1e-5 relative, and
   what the update reads (the gradients) within 1e-5 as the norm of the
   difference over the host's.  The update itself is held on the same
   inputs: the host runs the program's update ops from the same state on
   the card's gradients, and every element of every parameter and
   accumulator (and of the averages ``apply()`` puts in the scope) must be
   within 1e-5 of the largest of its tensor.  (A step-normalizing
   optimizer turns float32 noise in a near-zero gradient, such as the key
   third of each ``qkv.b``, whose exact gradient is zero, into a step of
   either sign; fed the same gradient, no element is exempt.)  LAMB's and
   LARS's updates run under ``torch.cuda.set_sync_debug_mode("error")``.
   Then the new initializers on the card: the truncated normal's bound,
   mean and std, MSRA's scales, Bilinear's and NumpyArray's values equal
   to the host's.
   ``dp_train`` (after ``train``) — collective data parallelism: ``train``'s
   GPT and batch (8 x 2048, float32) over ``make_mesh({"dp": 4}, [cuda:0] *
   4)``, four virtual ranks of 2 sequences.  (a) ``GradAllReduce`` + Adam
   from the startup seed of a single-device run of the untranspiled
   program on the same batch (run first, 1 + 4 steps, weights compared):
   each step's mean over the 4 stacked losses within ``DP_LOSS_RTOL`` of
   the single-device loss; every rank's trainable parameters equal bit for
   bit at every step (``Executor.verify_replicas``); K1 and K2 12 x 4 x 5
   times each; ``paddle_tpu_collective_bytes_total`` moved by the comms
   plan's payload (every parameter x 4 B) x 5 exactly; the comms monitor
   drained with ``paddle_tpu_comm_step_ms`` > 0, the wait 0 and the digest
   carrying ``comm_ms`` / ``comm_wait`` / ``comm_bw``; the dp peak memory
   below the single-device peak; the step beside the single-device step
   and the collective segment's event-timed ms.  (b) ``DGCMomentumOptimizer
   (DGC_LR, 0.9, rampup_begin_step=1, sparsity=[0.999])`` through
   ``DGCGradAllReduce``, 3 steps: the first two losses (the second follows
   the dense step) against 2 steps of Momentum + ``GradAllReduce`` within
   ``DP_LOSS_RTOL``, the sparse steps' losses and every U/V finite; the
   allgathered pairs' bytes against the dense allreduce's.  K1/K2 are
   also held against their plain versions at a rank's [24, 2048, 64] in
   ``kernel``.
   ``gspmd_train`` (after ``dp_train``) — GSPMD: the same GPT, batch and
   Adam through ``CompiledProgram(main).with_gspmd(axes={"dp": 2, "mp":
   2}, rules="mp_hidden_vocab", zero_stage=1)`` over
   ``make_topology_mesh(..., [cuda:0] * 4)``, 1 + ``DP_STEPS`` steps,
   against ``dp_train``'s single-device run (same startup seed and feed).
   ``choose_rules``' per-table report at full width is printed; each
   step's loss within ``DP_LOSS_RTOL`` of the single-device loss; the
   gathered parameters after the last step within
   ``GSPMD_PARAM_ATOL``; K1 and K2 launched as often as the lowered
   program's ``flash_attention`` ops x 4 ranks x steps (the plan gathers q,
   k and v whole, so each rank runs all 12 heads of its 4 sequences at
   [48, 2048, 64]); ``paddle_tpu_collective_bytes_total`` moved by exactly
   steps x the sharding plan's payload; an Adam moment a ``ShardedValue``
   with dim 0 over dp, ``per_device_nbytes`` its shard; the peak above
   held at most 4 x the per-shard static plan of the chosen table, and
   printed beside the single-device run's with the step time.
   ``pipe_train`` (after ``gspmd_train``) — pipeline parallelism: the
   same GPT, feed and startup seed split by ``PipelineOptimizer(
   AdamOptimizer(1e-4), cut_list=..., num_microbatches=4)`` and run by its
   GPipe ``PipelineEngine`` (the forward wave, the backward wave by
   recompute, the eager Adam apply).  (a) four stages cut after layers 3,
   6 and 9 on ``[cuda:0] * 4``, 1 + ``DP_STEPS`` steps: each loss within
   ``DP_LOSS_RTOL`` of ``dp_train``'s single-device run (the feed's one
   label 0 a row gives every microbatch the same count of counted
   labels, so the mean of the microbatch losses is the batch loss), the
   parameters after the last step within ``GSPMD_PARAM_ATOL``, K1 96 and
   K2 48 a step (12 layers x 4 microbatches, K1 in the forward wave and
   again in the recompute) and no other kernel.  (b) two stages cut after
   layer 6, each on ``[cuda:0, cuda:0]`` (a stage's dp submesh), 1 + 2
   steps: each loss within ``DP_LOSS_RTOL`` of (a)'s, K1 192 and K2 96 a
   step.  Each prints its stages' op counts and boundary names, the step
   ms (host clock ending in a synchronize) split into the forward wave,
   the backward wave and the apply, the peak memory above held beside the
   single-device run's, and the launches.
   ``moe_train`` (after ``pipe_train``) — mixture of experts:
   ``switch_moe_ffn`` at the GPT's width (x ``[8, 2048, 768]`` float32,
   8 experts, d_inner 3072, capacity 1.25, relu) under ``mean((out -
   y)^2) + 0.1 aux`` and Adam(``MOE_LR``), 1 + ``DP_STEPS`` steps, (a) on one
   device and (b) under ``with_distributed(axes={"ep": 2, "dp": 2})`` over
   ``[cuda:0] * 4`` from the same startup seed: each loss within
   ``MOE_LOSS_RTOL`` of (a)'s, the loss falls in both,
   ``paddle_tpu_collective_bytes_total`` moved by exactly steps x the
   sharding plan's payload (its ``c_alltoall`` dispatch over ``ep``
   printed with every edge kind), each rank holding half the experts'
   weights and Adam moments (per-rank bytes), and no kernel launched (the
   reference runs these products outside any Pallas kernel).
   ``ps_train`` (after ``moe_train``) — the parameter server, float32
   with TF32 off.  (a) the DeepFM CTR gang of ``tools/bench_deepfm_ps.py``
   (``build_ctr_train(sparse_dim=10000, embed_size=16, is_sparse=True)``:
   shared tables [260000, 16] and [260000, 1] held by the server, deep
   layers (64, 32), FM on; batch 512 a trainer from
   ``RandomState(trainer_id)``) under ``python -m
   paddle_tpu_torch.distributed.launch_ps --server_num 3 --worker_num 2``
   running ``paddle_tpu_torch/tools/ps_runner.py --mode sync,async,geo``:
   a pserver a mode on the host, the two trainers on ``cuda:0`` running
   the modes in turn, 1 + 10 steps each.  sync, SGD(0.2): both trainers'
   dense parameters equal bit for bit after every step, and the mean of
   their losses within
   ``DP_LOSS_RTOL`` of one process on ``cuda:0`` over both batches
   (1024) from the same tables; async, Adam(0.01): the loss of the
   server's final parameters on both trainers' first three batches below
   the startup's on the same batches, both scored by trainer 0 after the
   final barrier (the trainers' own losses race each other's pushes); geo,
   local SGD(0.2), a round every 5 steps with ``record_rows`` on both
   tables and ``flush`` at the end: the loss falls, and every round pushes
   at most the distinct ids fed since the round before.  Each prints a
   step's ms and examples/s per trainer, the bytes pushed and pulled a
   step, the K5 launches and fused ops, and ``paddle_tpu_ps_rpc_ms`` p50
   / p99 by op.  (b) ``train``'s GPT (``_dp_program``, Adam(1e-4))
   transpiled by ``DistributeTranspiler`` (sync, 1 trainer, 1 pserver):
   the pserver runs on a thread of this process on the host, its tables
   put from the trainer's startup (checked equal to it, and its own host
   startup's match counted), and the trainer on ``cuda:0`` takes
   ``dp_train``'s batch for 1 + ``DP_STEPS`` steps: each loss within
   ``DP_LOSS_RTOL`` of ``dp_train``'s single-device run, K1 and K2 12 a
   step, every parameter pulled from the server equal to the trainer's
   copy, and ``save_server``'s snapshot restoring to the same values.  It
   prints a step's ms split into device compute, the copy to the host,
   the push (the server's Adam included), the pull and the copy back, the
   bytes each way, the peak above held beside the one device's, and the
   RPC quantiles.
   ``dygraph_train`` (after ``ps_train``) — dygraph mode, float32 with
   TF32 off.  (a) ResNet-50 (depth 50, class_dim 1000, 3x224x224) built
   from ``dygraph.nn`` layers (``tests/_dygraph_resnet.py``, the
   structure and parameter names of ``models/resnet.py``) from a static
   startup's values, ``DYGRAPH_STEPS`` steps of ``MomentumOptimizer(0.1,
   0.9, parameter_list=...)`` at batch ``DYGRAPH_BATCH`` against the
   unfused static program on the same card, feed and weights, both on
   cuDNN's deterministic algorithms (on the default ones two static runs
   already differ, printed as the yardstick): each loss within
   ``DYGRAPH_LOSS_RTOL``, ``fc_out.w`` and ``DYGRAPH_BN_STAT`` after the
   last step within ``DYGRAPH_PARAM_FRAC`` of their largest magnitude, no
   kernel launched; the step ms of both and their peaks above held.  (b)
   ``train``'s width traced: ``Linear`` to q, k, v
   (``DYGRAPH_ATTN``), ``trace_op("flash_attention")`` causal,
   ``Dropout(DYGRAPH_DROPOUT)``, ``mean``, ``backward()``: dq, dk, dv
   (scaled by the mean's count) within ``ATOL`` + ``RTOL`` of autograd
   of the plain attention on the card, the dropout's gradient equal to
   mask x scale x upstream bit for bit, and each step K1 1, K2 1 and the
   dropout kernel 2 (its forward and its grad op).  (c) (a)'s net saved
   by ``save_dygraph``, zeroed, and loaded by ``load_dygraph`` +
   ``set_dict``: every tensor bit for bit on the card.
   ``gang_train`` (after ``dygraph_train``) — several processes: two
   trainer processes of ``python -m paddle_tpu_torch.distributed.launch
   --nproc_per_node 2`` share this card, each running
   ``paddle_tpu_torch/tools/collective_runner.py`` under the launcher's
   gang coordinator with ``FLAGS_gang_step_barrier`` on and heartbeats
   live; the exchange between them is gloo over pinned host memory (one
   card: NCCL refuses two ranks of a communicator on one device).  (a)
   ``train``'s GPT (batch 8 x 2048, 4 sequences a process: process p feeds
   rows [4p, 4p + 4) of ``dp_train``'s feed) under ``GradAllReduce`` +
   Adam, 1 + 4 steps; (b) the same GPT under ``with_distributed(axes=
   {"dp": 2}, zero_stage=1)``, 1 + 2 steps.  Each: both processes' startup
   weights, losses and final parameters equal bit for bit, each loss
   within ``GANG_LOSS_RTOL`` of ``dp_train``'s one-device run, K1 and K2
   12 a step a process, the collective bytes the plan's payload x steps
   (the comms plan; the sharding plan).  (c) ring attention at
   ``RING_SLICE``, float32, non-causal, sp 2 across the processes (the
   K/V and dK/dV rotations a send and a receive): each process's half of
   o, lse, dq, dk, dv within rtol = atol ``RING_O_TOL`` / ``RING_GRAD_TOL``
   of the plain dense attention over the whole T, K1/K2/merge 2/2/1 a
   process.  (d) the elastic drill of ``tools/gang_smoke.py`` at
   preempt_runner's ``full2`` (d 768, 2 layers, batch 8 x 2048): two
   socket-backend ranks under ``CheckpointDaemon`` (every 2 steps), rank 1
   SIGKILLs itself at step ``GANG_KILL_STEP``, ``--max_restarts 1``
   respawns it from the gang manifest, and both ranks' losses equal an
   uninterrupted child's bit for bit.  It prints each process's step ms
   (host clock ending in a synchronize), the exchange's ms a step, the
   peak memory, the bytes against the plan and the launches.
15. ``preempt_train`` (after ``gang_train``) — preemption-safe training of
   the ``train`` phase's GPT cut to 2 layers (``preempt_runner``'s
   ``full2``: batch 8 x 2048, float32, Adam 1e-4, dropout 0.0, TF32 off),
   each run a child process of ``paddle_tpu_torch.tools.preempt_runner``:
   8 steps under ``resume_or_init``, ``CheckpointDaemon(interval_steps=2)``
   and ``PreemptionGuard``, the same seeded weights and the batch keyed by
   the step.  (a1), (a2) uninterrupted and, at the same time, (b) under
   ``FLAGS_fault_inject=checkpoint.write:once`` pauses at the boundary
   after step 4 until the phase's SIGTERM, drains, writes its emergency
   checkpoint and exits 0; (c) resumes in a fresh process and trains
   steps 4-7.  (c)'s restored state must equal (b)'s saved state bit for
   bit (a digest a persistable), (b) + (c)'s losses (a1)'s bit for bit
   (or, when (a1) and (a2) differ, within their largest difference, the
   first differing step named), (b)'s counters read 1 injected fault, 1
   retry and 0 give-ups at ``checkpoint.write``, and each child launches
   the float32 K1 and K2 2 times a step.  It prints the bytes a
   checkpoint, the training thread's stall per capture, the daemon's
   save (copy to the host, write, fsync), SIGTERM to exit, the restore,
   the step with the daemon against ``train``'s, the peak card memory
   above start across a capture, and the free disk before and after.
   Checkpoints go under ``tempfile``'s directory and are deleted once
   read.
16. ``observe_train`` (after ``optimizers``) — the time and memory planes
   on ``train``'s executor and GPT (float32, batch 8 x 2048): one step
   opens a ``torch.profiler`` window (``FLAGS_profile_sample_*``) of 2
   steps, the HBM accountant on.  Fatal: the window ``ok`` and no window,
   summary or accountant error; ``summary.json`` holds 2 steps; in those
   steps each flash entry point's kernel events (``flash_fwd_sm90``, and
   K2's delta, dK/dV and dQ passes) as many as its wrapper's launches,
   nothing else classed attention (K1 + 3 x K2 events); the per-class
   shares, recomputed unrounded from the trace, sum to 1 within 1e-6 and
   match the published ones; 0 <= idle fraction < 1, 0 < measured MFU <=
   1, each step's device ms within its span; ``paddle_tpu_step_mfu`` set;
   the ledger's time to dispatch and host-blocked time non-zero; the
   accountant's live, peak and headroom gauges published (budget = live +
   headroom).  Prints the plan's peak beside the measured one, measured
   and live MFU, the idle fraction, the top kernels and the shares; then
   the step in three legs, alternating (host clocks, 4 x 3 steps each):
   as by default (the accountant on), with the planes idle, and idle
   without the executor's device-timeline range.
   ``observe_resnet`` — ResNet-50 float32 at batch 256 through the fusion
   pass, 1 warm-up + 3 steps (the last 2 in a window): 36 K3 a step,
   finite falling losses, the window's checks as above, the unfused and
   fused programs' planned peaks beside the measured one, the three legs
   as above; then the
   ``memory.oom`` drill through ``Executor.run`` (an ``InjectedFault``
   with the summary and the dump's path, the dump's sums re-adding,
   ``paddle_tpu_oom_total{site="injected"}`` 1) and a real
   ``torch.cuda.OutOfMemoryError`` (twice the card) through
   ``hbm.oom_forensics``, its requested size read.  ``observe_serve`` —
   ``serve``'s GPT at bucket 2048 under a ``FLAGS_memory_budget_mb``
   between the bucket program's planned peaks at widths 4 and 8: the
   bucket admits 4, ``statusz`` reports the budget, 6 requests answered,
   K1 12 times a batch; F2 (PR 21): a lone batch of 4 peaks above what is
   held within the budget (x ``F2_SLACK``), one width-4 step's fetch holds
   exactly its logits after the step, and the 6 requests peak within the
   budget times the batches alive at once (``alive_stats()``); a
   ``DecodeEngine(max_slots=8)`` moves the accountant's ``kv_pages`` class
   by exactly its ``pool_bytes()``.
   ``numerics`` — ``bench.py:959``'s MLP at ``FLAGS_numerics`` off,
   sentinel and full, 3 + 40 steps each: the loss fingerprints equal, no
   forced sync and no materialization inside the timed steps, the
   overheads in steps/s; ``train``'s GPT (float32, 8 x 2048) from seeded
   weights at sentinel beside off, 1 + 3 steps and one CUDA-only profiled
   step each: the losses equal to the bit, K1/K2 12 times a step, the
   kernels the sentinel adds a step; then the two modes' steps
   interleaved on one executor (4 rounds) for the overhead; the poison drill (a capture every
   step, ``numerics.poison`` on step 4: one trip, one quarantine hold, the
   checkpoint at step 3, a profiler window with ``trigger: "anomaly"``);
   a small GPT's decode loop with NaN'd weights records one
   ``nonfinite_logits`` anomaly.
   ``serve_plane`` — ``serve``'s GPT at buckets 512 and 2048 with an
   ``FLAGS_serving_slo`` target and the scrape endpoint on 127.0.0.1: each
   request's five phase spans sum to its ``e2e_ms`` within 10% + 0.05 ms
   and its dispatch span carries a step >= 1 and ``pad_rows`` = width -
   occupancy; ``/metrics``, ``/healthz``, ``/statusz`` answer 200 with the
   SLO state; ``shrink_widths()`` halves both buckets and the next
   bucket-2048 batch runs at width 4; evicting a tenant folds its series
   into ``tenant="retired"``; K1 12 times a bucket-2048 batch.
   ``serve_fleet`` — ``serve``'s GPT behind the serving fleet: (a) two
   ``ReplicaEndpoint``s on 127.0.0.1, each over its own ``InferenceServer``
   (bucket 32, ``max_batch`` 4, flash attention), behind one
   ``FleetRouter``: 8 requests of 4-12 tokens from two tenants routed one
   at a time, each within ``FLEET_ATOL`` + ``FLEET_RTOL`` of the same
   request submitted directly (routed and direct p50/p99, the largest
   frame's bytes and JSON times printed); the 8 again from 4 clients while
   one endpoint stops: no failure, ``reroutes{reason="dead"}`` >= 1, the
   router's ledger exact, K1 12 times a batch; (b) a ``DecodeServer`` (8
   slots) behind an endpoint: 4 greedy prompts through
   ``FleetRouter.decode`` equal to its direct ``submit`` token for token;
   (c) ``paddle_tpu_torch/tools/fleet_smoke.py --width full2`` (the
   width, at 2 layers since the PS slice) over the first two layers of
   ``serve``'s weights (``io.save_persistables``), every replica's probe
   logits within ``FLEET_ATOL`` + ``FLEET_RTOL`` of an in-process server's
   over ``serve``'s scope: replica processes on this card for ``drain`` (SIGTERM: exit 0, drain
   re-routes), ``kill`` (SIGKILL: dead re-routes, p99) and ``scale`` (one
   scale-up, one death repair, one idle retire through the drain, exit 0),
   no client-visible failure; each child loads the kernels built above and
   reports its K1 launches (2 a batch), peak memory and time to READY.

Then one JSON line describing every kernel, the ``nvidia-smi`` line, and a
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 2 before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np

ATOL, RTOL = 1e-5, 1e-4                 # kernel vs plain, float32
# K3 vs its plain version: both sum exact bf16 products in float32, in
# other orders, so y may differ by a few float32 ulps of the sum of |terms|
# (16 ulps: 2^-20 of sum |w||x|); s sums N*P values of either sign (2^-14
# of sum |y|: the sequential part of the kernel's reduction adds up to ~800
# row partials), s2 positive values (2^-14 relative)
K3_SUM_RTOL, K3_STAT_RTOL = 2.0 ** -20, 2.0 ** -14
SERVE_ATOL, SERVE_RTOL = 2e-3, 2e-3     # card vs host logits, float32
# the decode phase: slots, requests (the last one an EOS repeat), prompt
# lengths, tokens generated a request, iterations of the uncaptured step
# timed against the graph, and the positions run again on the host
DECODE_SLOTS, DECODE_REQUESTS, DECODE_NEW = 8, 16, 32
DECODE_PROMPT = (32, 384)
DECODE_UNCAPTURED_ITERS, DECODE_HOST_POSITIONS = 50, 64
# card vs host training step.  The fused LM head rounds its products to
# bf16, and a sum taken in another order can round to the neighbouring bf16
# value; the head's weight gradient adds up one bf16-rounded partial per
# 1024-token chunk, and partials can cancel.  So each gradient must agree
# elementwise within two bf16 ulps plus one bf16 ulp of its largest
# magnitude, and all but 1 in 10,000 of its values within two bf16 ulps
# plus 1e-4 of its largest magnitude.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 2 * 2.0 ** -8
TRAIN_GRAD_ATOL_FRAC, TRAIN_GRAD_TIGHT_FRAC = 2.0 ** -8, 1e-4
TRAIN_GRAD_TIGHT_SHARE = 1e-4
# The fused step's K5 backward recomputes its pre-activation as a bf16
# product (bf16 result), as the reference's _mba_bwd does: where the card's
# and the host's float32 sums round to neighbouring bf16 values (~1 in 10^5
# elements), the activation's derivative moves by a bf16 ulp and a whole
# column of the FFN weight's gradient moves with it.  Every value stays
# within the bound above; the share beyond the tight one may reach 1e-3
# (1.4e-4 of enc_1.ffn.fc1.w@GRAD seen on an H100 80GB HBM3, 700 W)
FUSED_GRAD_TIGHT_SHARE = 1e-3
SLICE = (96, 2048, 64)                  # 8 sequences x 12 heads, T, d_head
TRAIN_BATCH, TRAIN_STEPS = 8, 5
# dp_train: virtual ranks on the card, timed steps after a warm-up, the DGC
# steps, its learning rate and sparsity; dp losses against one device's
# (the gradient sums run in another order)
DP_RANKS, DP_STEPS, DGC_STEPS = 4, 4, 3
DGC_LR, DGC_SPARSITY = 1e-3, 0.999
DP_LOSS_RTOL = 1e-4
# gspmd_train: the parameters after 1 + DP_STEPS Adam steps at lr 1e-4
# against the single-device run's.  Adam moves an element by about lr a
# step whatever its gradient's size, so float32 noise in a near-zero
# gradient (the key third of each qkv.b, whose exact gradient is 0) can
# move it by up to steps x lr: the bound.
GSPMD_AXES, GSPMD_RULES = {"dp": 2, "mp": 2}, "mp_hidden_vocab"
GSPMD_PARAM_ATOL = (1 + DP_STEPS) * 1e-4
# pipe_train: (a) four stages cut after layers 3, 6 and 9 (checkpoints 2, 5,
# 8), 1 + DP_STEPS steps; (b) two stages cut after layer 6, each on two
# virtual ranks, 1 + 2 steps; 4 microbatches of 2 sequences.  The losses
# against one device's within DP_LOSS_RTOL, the parameters within
# GSPMD_PARAM_ATOL (Adam's noise bound above)
PIPE_CUTS, PIPE_CUTS_B, PIPE_MICROBATCHES, PIPE_STEPS_B = (2, 5, 8), (5,), \
    4, 3
# moe_train: the experts, inner width and capacity factor of the layer at
# the GPT's width; ep x dp; the losses' bound (the reference test's); Adam's
# learning rate: the reference test's 1e-2 (at d 16) overshoots at d 768,
# where the loss rose at the fifth step on an H100 80GB HBM3, 700 W (and
# the JAX package's own run at this width rises too), so 1e-3
MOE_EXPERTS, MOE_INNER, MOE_CF = 8, 3072, 1.25
MOE_AXES, MOE_LOSS_RTOL, MOE_LR = {"ep": 2, "dp": 2}, 2e-4, 1e-3
# ps_train: (a) the DeepFM gang (tools/bench_deepfm_ps.py:37-44, 59-60):
# sparse ids a slot, batch a trainer, 1 + 10 steps in each mode, geo's push
# interval, the launcher's time limit; (b) the GPT's pserver: the RPC
# deadline (ms) of both parts
PS_SPARSE_DIM, PS_BATCH, PS_STEPS, PS_GEO_PUSH = 10000, 512, 11, 5
PS_TIMEOUT_S, PS_RPC_DEADLINE_MS = 300, 120000
# dygraph_train: (a) ResNet-50 in dygraph against the static program,
# batch, steps, the loss's relative limit and the parameters' (of their
# largest magnitude); (b) a traced flash attention at the GPT's width,
# batch x heads x T x d_head, its steps, the dropout rate
DYGRAPH_RESNET = dict(class_dim=1000, depth=50, image_shape=(3, 224, 224))
DYGRAPH_BATCH, DYGRAPH_STEPS = 32, 3
DYGRAPH_LOSS_RTOL, DYGRAPH_PARAM_FRAC = 1e-4, 1e-4
DYGRAPH_BN_STAT = "res3_2.b2.bn.mean"
DYGRAPH_ATTN, DYGRAPH_ATTN_STEPS, DYGRAPH_DROPOUT = (2, 12, 2048, 64), 2, 0.1
# preempt_train: steps a run, the daemon's interval, and a child's time limit
PREEMPT_STEPS, PREEMPT_INTERVAL, PREEMPT_TIMEOUT_S = 8, 2, 300
# ... at BERT-base width cut to 2 layers (preempt_runner's "full2"), which
# pays for gang_train's time
PREEMPT_SIZE = "full2"
# gang_train: two trainer processes of the port's launcher share this card;
# (a) GradAllReduce + Adam and (b) ZeRO-1 steps, their losses against
# dp_train's one-device run, (c) the ring across the pair, (d) the elastic
# drill at 2 layers: steps, the kill, the pause a step, the heartbeats
GANG_STEPS, GANG_ZERO_STEPS, GANG_LOSS_RTOL = 1 + 4, 1 + 2, 1e-5
GANG_DRILL_STEPS, GANG_KILL_STEP, GANG_DRILL_PAUSE_S = 12, 4, 0.5
GANG_HEARTBEAT = {"FLAGS_gang_heartbeat_interval_s": "0.25",
                  "FLAGS_gang_heartbeat_timeout_s": "2.5"}
GANG_TIMEOUT_S = 420
RESNET_BATCH, RESNET_STEPS = 128, 5
# ResNet card vs host, one step.  The fused step: K3 rounds its operands to
# bf16 on the card (as the TPU kernel does) and the host multiplies in
# float32, so each fused product differs by up to 2^-8 relative.  A
# randomly initialised ResNet-50 amplifies such differences chaotically (a
# ReLU input within rounding of 0 flips; the loss of a depth-50, 3x64x64,
# batch-8 step moved by 4.1e-3 with bf16 operands on the host, by 1.4e-2
# and 3.9e-2 with two builds of K3 on the card), so the fused step is held
# to 2^-6 on the loss at the toy (two bottleneck blocks, 16 filters, where
# the noise stays near the bf16 level) and only to 2^-3 at depth 50, a
# check for gross errors.  The unfused step is float32 on both sides: at
# depth 50 the loss to 1e-4, every BN running statistic after the step to
# 2^-10 of its tensor's largest magnitude, and the classifier's gradients
# to 2^-8 of theirs.  Deeper gradients are reported, not held: at this
# batch one flipped pixel moves a conv weight's gradient by a few percent
# (a float64 host product in place of the float32 one moves them by 2-9%
# of their largest value).
RESNET_TOY_LOSS_RTOL, RESNET_FUSED_LOSS_RTOL = 2.0 ** -6, 2.0 ** -3
RESNET_F32_LOSS_RTOL, RESNET_F32_STAT_FRAC = 1e-4, 2.0 ** -10
RESNET_F32_GRAD_FRAC = 2.0 ** -8
RESNET_SMALL = dict(class_dim=10, depth=50, image_shape=(3, 64, 64))
RESNET_SMALL_BATCH = 8
# K5 against its plain version: both sum exact bf16 products in float32 in
# other orders, so y gets K3's allowance of 2^-20 of sum |x||w|.  K4's
# dscale and dbias sum up to 16384 rows of either sign: 2^-14 of the sum of
# their terms' magnitudes
K4_SUM_RTOL = 2.0 ** -14
# the fused path: the autotuner on and every candidate ranked in (the
# embedding LayerNorm's share is 0.0028, under the default threshold)
FUSED_FLAGS = {"FLAGS_fusion_autotune": True,
               "FLAGS_fusion_rank_threshold": 0.0}
DEFAULT_FLAGS = {"FLAGS_fusion_autotune": False,
                 "FLAGS_fusion_rank_threshold": 0.02,
                 "FLAGS_xla_compile_cache_dir": ""}

# K6 against its plain version.  Both multiply the same bf16 operands
# (products exact in float32) and sum them in float32 in other orders, so a
# float32 y gets K3's 2^-20 of sum |a||w|; a bf16 y (bf16 x) is the rounding
# of those sums, and two sums a few float32 ulps apart can round to
# neighbouring bf16 values: one bf16 ulp more, 2^-7 of |y|.  s and s2 get
# K3's 2^-14 (they come from the float32 sums in both).
K6_BF16_RTOL = 2.0 ** -7
# K8 against its plain version: float32 sums of float32 products at two
# levels (S = q.k then S.v; dq = (S * dP).k), in other orders than cuBLAS's;
# 2^-20 of the sum of the terms' magnitudes (|q||k||v| for o, and so on)
K8_SUM_RTOL = 2.0 ** -20
# The bf16 forms of K1-K5 (AMP) against their plain versions, which widen
# the same bf16 inputs to float32, compute, and round each output once: the
# kernels take their float32 sums in other orders and round once too, so a
# bf16 output may land on the neighbouring bf16 value.  Each bf16 output is
# held to one bf16 ulp of its largest magnitude (plus, for the products of
# K3 and K5, the float32 allowance 2^-20 of the sum of |terms|); the float32
# outputs (lse, s, s2, dscale, dbias) keep the float32 forms' tolerances.
BF16_ULPS = 1
AMP_BATCH_RESNET = 256                  # bench.py:182
# the AMP GPT's first loss against the float32 train phase's first loss
# (the same weights from the same seed, the same feed): the bf16 products
# and activations move a loss near log(30522) = 10.3 by a few 1e-4
# relative; 2^-7 is a check for gross errors
AMP_LOSS_RTOL = 2.0 ** -7
# card vs host, one AMP step of the 2-layer toy (seq 1024) and of the toy
# ResNet: both round the same values to bf16 at the same ops, but cuBLAS,
# cuDNN and the kernels sum in other orders than the host, and a bf16
# activation that rounds to the neighbouring value moves everything after
# it by a bf16 ulp.  The loss within 2^-7 relative; the gradients and BN
# running statistics held compared (not each value): within 2^-3 of their
# largest magnitude, a check for gross errors, with the measured share
# reported.  An AMP step of ResNet-50 at depth 50 is held like the fused
# float32 one, to RESNET_FUSED_LOSS_RTOL on the loss: both sides round to
# bf16 at the same ops but in other orders, and a random-init depth-50 net
# amplifies a bf16-level difference chaotically (its classifier gradients
# moved by 0.35 of their largest magnitude and its BN statistics by 0.11 on
# an H100 80GB HBM3, 700 W; the fused float32 step: 0.34 and 0.11)
AMP_SMALL_LOSS_RTOL, AMP_SMALL_FRAC = 2.0 ** -7, 2.0 ** -3
# rn50_fused: the fused chain's output sum against the library chain's.
# The chains round y1 to bf16 at the same place but take the statistics
# from different values (the float32 sums in K6, the rounded bf16 y1 in
# the library), so normalized values can round to neighbouring bf16 values:
# one bf16 ulp, 2^-7, of the sum
RN50_FUSED_RTOL = 2.0 ** -7
# ring attention (K7): BERT-base at batch 2 x 8192 (b*h = 24, d 64), sp 4
# over one card (virtual ranks).  The ring against its plain version (the
# same schedule through the plain K1, K2 and merge): float32 o, lse, dq,
# dk and dv within ATOL + RTOL |ref|, as every kernel against its plain
# version; bf16 every value within RING_BF16_EACH_PLAIN bf16 ulps of itself
# plus as many of the tensor's RMS: a K1 partial or a merge weight that
# rounds to the other neighbouring bf16 value moves a merge product by one
# ulp of that product, and partials reach ~8x the RMS of o.  The ring
# against K1/K2 over the full T: float32 o within RING_O_TOL and the
# gradients within RING_GRAD_TOL (abs and rel, the reference tests'
# tolerances: the ring sums its partials in another order); bf16 o within
# 2 bf16 ulps of max|o| and each gradient within 4 of its largest
# magnitude, and besides every value within RING_BF16_EACH_FULL ulps of
# itself plus as many of the RMS (the ring rounds each of its n partials
# to bf16, K1/K2 round once).  The merge kernel against its plain version:
# float32 within 1e-6 + 1e-6 rel, bf16 within one bf16 ulp of each value.
# The ring's training losses within 1e-4 relative of the flash program's,
# step by step.
RING_SLICE, RING_SP = (24, 8192, 64), 4
RING_BATCH, RING_SEQ, RING_STEPS = 2, 8192, 3
RING_O_TOL, RING_GRAD_TOL = 2e-5, 2e-4
RING_BF16_ULPS_O, RING_BF16_ULPS_GRAD = 2, 4
RING_BF16_EACH_PLAIN, RING_BF16_EACH_FULL = 4, 8
RING_MERGE_TOL, RING_LOSS_RTOL = 1e-6, 1e-4
# input sets of the cold timings of the merge (6 x 19 MB in bf16, at a ring
# step's [24, 2048, 64]) and of K4's backward (3 x 50 MB in bf16, at [16384,
# 768]): more than the card's 50 MB L2 in all
MERGE_COLD_SETS, K4_COLD_SETS = 6, 3
# the dropout kernel against its plain version, bit for bit, at BERT-base's
# shapes at batch 128 x 128 (a sublayer's output, the attention weights),
# with the keep rate within DROPOUT_SIGMAS binomial standard deviations of
# 1 - threshold / 256; timed cold over DROPOUT_COLD_SETS input sets (50 MB
# each in bf16 at [128, 12, 128, 128])
DROPOUT_SHAPES = ((128, 128, 768), (128, 12, 128, 128))
DROPOUT_PS, DROPOUT_SIGMAS, DROPOUT_COLD_SETS = (0.1, 0.5, 0.001, 0.0,
                                                 1.0), 5, 3
# the training configurations dropout unblocks: bench.py's BERT-base line
# (bench.py:264-300: BertConfig(), seq 128, batch 128, fused head, arange
# positions, AMP Adam 1e-4) with the fusion autotuner on, 1 + 5 steps; its
# masked_gather=20 line (bench.py:323-357), 1 + 3; Transformer-base WMT
# (bench.py:579-625: V 37000, d 512, 6 + 6 layers, 8 heads, F 2048, batch
# 32, seq 256, fused head, AMP Adam), 1 + 3; SE-ResNeXt-50 (3x224x224, 1000
# classes, Momentum(0.1, 0.9), float32, TF32 off) at batch 64, 1 + 3
BERT_BATCH, BERT_SEQ, BERT_STEPS = 128, 128, 5
# the 2-layer AMP step against the host: 16 x 128 tokens, so the autotuner
# times the FFN products at M 2048
BERT_SMALL_BATCH = 16
BERT_MASKED, BERT_MASKED_STEPS = 20, 3
WMT = dict(vocab=37000, d_model=512, n_layer=6, n_head=8, d_inner=2048)
WMT_BATCH, WMT_SEQ, WMT_STEPS = 32, 256, 3
SE_BATCH, SE_STEPS, SE_IMAGE = 64, 3, (3, 224, 224)
# a dropout a sublayer: BERT-base 1 + 4 x 12 = 49 a forward (the embedding,
# each layer's attention weights, attention output, FFN hidden and FFN
# output), as many gradients; the NMT's encoder 1 + 4 x 6, its decoder
# 3 x 6 (self- and cross-attention weights, FFN hidden)
BERT_DROPOUTS, WMT_DROPOUTS = 2 * 49, 2 * 43
# the fused 2-layer BERT (autotuner off) against the unfused one on the
# card, float32, 3 steps: the fused tail regenerates the unfused op's masks,
# so the losses differ only by the products' order (1e-5 relative)
FUSED_UNFUSED_RTOL = 1e-5
# recompute_train: bert_train's BERT-base under LAMB (You et al. 2019, the
# large-batch BERT recipe: weight decay 0.01, none on LayerNorm scales and
# biases), with and without RecomputeOptimizer, 1 + RECOMPUTE_STEPS steps
RECOMPUTE_STEPS, LAMB_LR, LAMB_DECAY = 3, 1e-4, 0.01
# seq2seq: tests/_seq2seq.py's model at PaddlePaddle/models rnn_search's
# IWSLT'15 en-vi widths (run.sh / infer.sh: 2 layers, hidden 512, vocab
# 17191 / 7709, batch 128, dropout 0.2, Adam 1e-3 clipped at global norm
# 5.0, beam 10); (a) steps card vs host and the clipped gradients held,
# (b) the sentences decoded, (c) the While's width; the seed; the losses',
# gradients' and scores' relative limits; the gap under which two
# candidates are a near-tie; the phase's time budget (printed, not fatal)
SEQ2SEQ_BATCH, SEQ2SEQ_STEPS, SEQ2SEQ_DROPOUT = 128, 3, 0.2
SEQ2SEQ_GRADS = ("src_emb", "enc_l0_d0_0_w", "out_w")
SEQ2SEQ_DECODE_BATCH, SEQ2SEQ_WHILE_WIDTH, SEQ2SEQ_SEED = 16, 512, 29
SEQ2SEQ_LOSS_RTOL = SEQ2SEQ_GRAD_RTOL = SEQ2SEQ_SCORE_RTOL = 1e-4
SEQ2SEQ_TIE, SEQ2SEQ_BUDGET_S = 1e-4, 45.0
# optimizers: a BERT of BERT-base's width at OPT_LAYERS layers (2 until
# the PS slice cut it to 1 to pay for ps_train), float32, OPT_STEPS steps
# on the card and on the host at batch OPT_BATCH x 128: float32 products in
# other orders, so losses within 1e-5 relative and each gradient within
# 1e-5 (norm of the difference over the norm); the update on the same
# inputs, each element within 1e-5 of its tensor's largest; the new
# initializers' draws within OPT_INIT_SE standard errors of their mean and
# std
OPT_STEPS, OPT_BATCH, OPT_LAYERS = 3, 4, 1
OPT_LOSS_RTOL, OPT_STATE_RTOL, OPT_INIT_SE = 1e-5, 1e-5, 5.0
# predict: the GPT serving artifact (the dense recipe, attn_impl="base") at
# batch PREDICT_BATCH x PREDICT_SEQ, a warm-up and PREDICT_RUNS timed runs
# of each predictor; ResNet-50 inference at batch PREDICT_RESNET_BATCH,
# the folded program (conv_bn_fuse_pass) against the native one on the
# card.  The fold multiplies each filter by gamma / sigma in float64 and
# rounds once to float32, which moves each conv's float32 sums by a few
# ulps, and cuDNN may pick another algorithm for the folded conv: on the
# host (depth 50, 3x64x64, batch 8, BN statistics moved off their initial
# values) the classifier's logits moved by at most 7.3e-7 of their largest
# magnitude and the probabilities by 3.0e-7 absolute and 2.2e-5 relative;
# held at 2^-14 of the largest logit and 1e-5 + 1e-3 relative, 30-80x
# that.
# conv_bn_train_fuse_pass: PREDICT_TRAIN_STEPS Momentum steps of the toy,
# the rewritten program (K3) against the unrewritten one (float32), the
# loss within RESNET_TOY_LOSS_RTOL (K3 rounds its operands to bf16)
PREDICT_BATCH, PREDICT_SEQ, PREDICT_RUNS = 4, 2048, 3
PREDICT_RESNET_BATCH = 64
PREDICT_RESNET_ATOL, PREDICT_RESNET_RTOL = 1e-5, 1e-3
PREDICT_LOGIT_FRAC = 2.0 ** -14
PREDICT_TRAIN_STEPS = 3
# the time and memory planes (observe_*): a sampled window's steps, the
# overhead measurement's rounds and steps a leg, ResNet-50 float32 at
# batch 256 (ROADMAP Queue 1 item 1), the requests served under a budget
OBSERVE_WINDOW_STEPS = 2
OBSERVE_OVERHEAD_ROUNDS, OBSERVE_OVERHEAD_STEPS = 4, 3
OBSERVE_RESNET_BATCH, OBSERVE_RESNET_STEPS = 256, 3
OBSERVE_SERVE_REQUESTS = 6
# F2: the bucket's lone batch of 4 peaks above what is held within the
# budget, and the six requests within the budget times the batches alive
# at once; the slack covers the allocator's rounding to its blocks
F2_SLACK = 1.05
# what a served step may leave allocated beside its fetch's logits
F2_LEFT_BYTES = 1 << 20
# the numerics plane (numerics): bench.py:959's MLP, 3 + 40 steps a mode;
# train's GPT at sentinel beside off, 1 + 3 steps each and one profiled
# step; the poison drill's step that enters poisoned
NUMERICS_MLP_WARMUP, NUMERICS_MLP_STEPS = 3, 40
NUMERICS_GPT_STEPS = 3
NUMERICS_GPT_ROUNDS = 4
NUMERICS_POISON_AT = 4
# the serving plane (serve_plane): the SLO target, and the gate of
# tools/serving_smoke.py:219 on a request's phase sum against its e2e_ms
SERVE_PLANE_SLO = "*:p99_ms=60000,avail=99"
TRACE_SUM_RTOL, TRACE_SUM_ATOL_MS = 0.10, 0.05
# the serving fleet (serve_fleet): routed logits against the same server's
# direct ones (batches may be made up differently); requests of 4-12
# tokens, whose logits (len x 30522 float32) travel as JSON lists; the
# decode prompts; the chaos drill's time limit
FLEET_ATOL, FLEET_RTOL = 1e-5, 1e-4
FLEET_BUCKET, FLEET_REQUESTS, FLEET_TOKENS = 32, 8, (4, 12)
FLEET_DECODE_PROMPTS, FLEET_DECODE_LEN, FLEET_DECODE_NEW = 4, (8, 32), 16
FLEET_SMOKE_TIMEOUT_S = 600
# serve_fleet (c): the replica processes serve the GPT at BERT-base width cut
# to 2 layers (fleet_smoke's "full2"), which pays for ps_train's time
FLEET_REPLICA_WIDTH = "full2"


#: the script's start: each log line carries the seconds since, so a run's
#: output says where its time went
_T0 = time.perf_counter()


def _log(phase, msg):
    print(f"[{phase} +{time.perf_counter() - _T0:.1f}s] {msg}", flush=True)


def _peaks(name, kind="float32"):
    """``(FLOP/s, bytes/s)`` of the card ``name`` for ``kind``: "float32"
    on the CUDA cores, "bfloat16" on the tensor cores, or "float32_split",
    float32-exact products as bf16 term products on the tensor cores."""
    from paddle_tpu_torch.tools import timing
    f32, bf16, bw = timing.peaks(name)
    if kind == "float32_split":
        return timing.f32_split_flops(name), bw
    return (f32 if kind == "float32" else bf16), bw


def phase_env():
    import torch
    from paddle_tpu_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log("env", f"gpu: {smi}")
    _log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
         f"cuda {torch.version.cuda} device "
         f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.build()
    total = time.perf_counter() - t0
    for name, info in built.items():
        log = info["log"].splitlines()
        regs = [int(m.group(1)) for ln in log
                for m in [re.search(r"Used (\d+) registers", ln)] if m]
        spills = [int(m.group(1)) for ln in log
                  for m in [re.search(r"(\d+) bytes spill stores", ln)] if m]
        _log("env", f"nvcc {name}: {info['seconds']:.2f} s; ptxas: "
             f"{len(regs)} functions, registers max {max(regs, default=0)},"
             f" spill stores max {max(spills, default=0)} bytes")
    _log("env", f"kernel build wall time {total:.2f} s")
    from paddle_tpu_torch import ps_native
    t0 = time.perf_counter()
    lib = ps_native.build()
    _log("env", f"g++ {lib.name} (the parameter server, "
         f"csrc/{ps_native.SOURCE}): {time.perf_counter() - t0:.2f} s")
    return smi, built


def _ptxas_lines(log):
    """``(function, what ptxas -v says of it)`` for each entry function of
    a build log: registers, barriers, stack, spills, and the performance
    notes (C7512 and the like) that name it."""
    out, mangled, name = {}, {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(r"(flash_(?:fwd|bwd)_sm90_(?:\w*?_)?kernel)"
                          r"(?:I((?:Li\d+E)+|\d*\w+?)E)?", m.group(1))
            args = (re.findall(r"Li(\d+)E", k.group(2)) or
                    [re.sub(r"^\d+", "", k.group(2))] if k and k.group(2)
                    else [])
            name = (f"{k.group(1)}<{', '.join(args)}>" if args
                    else k.group(1) if k else m.group(1))
            out[name], mangled[name] = [], k.group(0) if k else m.group(1)
        elif name and ("Used" in ln or "spill" in ln):
            out[name].append(ln.split(":", 1)[-1].strip())
    for ln in log.splitlines():
        if "Performance Loss" in ln:
            for fn in out:
                if mangled[fn] in ln:
                    out[fn].append(ln.split(":", 1)[-1].strip()[:90])
    return out


def _check(name, got, ref, extra=None):
    """Max abs error of ``got`` against ``ref``; raises unless every value
    is within ``ATOL + RTOL * |ref|`` (plus ``extra``, a per-value or
    scalar allowance, where given)."""
    import torch
    err = (got - ref).abs()
    bound = ATOL + RTOL * ref.abs()
    if extra is not None:
        bound = bound + extra
    bad = ~(err <= bound)
    bad &= ~((got == ref) | (torch.isnan(got) & torch.isnan(ref)))
    finite = torch.isfinite(err)
    max_abs = float(err[finite].max()) if finite.any() else 0.0
    if bad.any():
        more = " + sum allowance" if extra is not None else ""
        raise AssertionError(f"{name}: {int(bad.sum())} values outside "
                             f"atol {ATOL} rtol {RTOL}{more}; max abs "
                             f"{max_abs}")
    return max_abs


#: ResNet-50's conv1x1 shapes (Cin, Cout, H*W) at 224x224: what K3 gets
K3_SHAPES = ((64, 64, 3136), (64, 256, 3136), (256, 64, 3136),
             (256, 128, 3136), (128, 512, 784), (256, 512, 784),
             (512, 128, 784), (512, 256, 784), (256, 1024, 196),
             (512, 1024, 196), (1024, 256, 196), (1024, 512, 196),
             (512, 2048, 49), (1024, 2048, 49), (2048, 512, 49))


def check_k3(name, x, w):
    """K3 against its plain version on the card: y per value within the
    float32 allowance of its sum, s and s2 within theirs."""
    import torch
    from paddle_tpu_torch.kernels import conv_bn as cb
    y, s, s2 = cb.conv1x1_stats_fwd(x, w)
    torch.cuda.synchronize()
    ry, rs, rs2 = cb.conv1x1_stats_plain(x, w)
    terms = torch.einsum("oc,ncp->nop", w.to(torch.bfloat16).float().abs(),
                         x.to(torch.bfloat16).float().abs())
    e_y = _check(name + " y", y, ry, K3_SUM_RTOL * terms)
    del terms
    e_s = _check(name + " s", s, rs,
                 K3_STAT_RTOL * ry.abs().sum(dim=(0, 2)))
    e_s2 = _check(name + " s2", s2, rs2, K3_STAT_RTOL * rs2)
    return e_y, e_s, e_s2


def _k6_terms(x, w, ps, relu):
    """sum_k |bf16(a)||bf16(w)| per output value, a the prologue's output
    as the plain version computes it."""
    import torch
    a = x.float()
    if ps is not None:
        a = (a - ps[0]) * ps[1] * ps[2] + ps[3]
    if relu:
        a = torch.relu(a)
    return a.to(torch.bfloat16).float().abs() @ \
        w.to(torch.bfloat16).float().abs()


def check_k6(name, x, w, ps, relu):
    """K6 against its plain version on the card: y per value within the
    allowance of its sum (one bf16 ulp more for a bf16 y), s and s2 within
    theirs.  Returns the max abs errors and the kernel's outputs."""
    import torch
    from paddle_tpu_torch.kernels import conv_bn as cb
    y, s, s2 = cb.matmul_bn_stats_fwd(x, w, ps, relu)
    torch.cuda.synchronize()
    ry, rs, rs2 = cb.matmul_bn_stats_plain(x, w, ps, relu)
    extra = K3_SUM_RTOL * _k6_terms(x, w, ps, relu)
    if x.dtype == torch.bfloat16:
        extra = extra + K6_BF16_RTOL * ry.float().abs()
    e_y = _check(name + " y", y.float(), ry.float(), extra)
    del extra
    e_s = _check(name + " s", s, rs,
                 K3_STAT_RTOL * ry.float().abs().sum(dim=0))
    e_s2 = _check(name + " s2", s2, rs2, K3_STAT_RTOL * rs2)
    return (e_y, e_s, e_s2), (y, s, s2)


def check_k8(name, q, k, v, do, block_q):
    """K8's forward (and its backward unless ``do`` is None) against their
    plain versions on the card: each value within the float32 allowance of
    its sum of terms.  Returns the forward's and the backward's max abs
    errors."""
    import torch
    from paddle_tpu_torch.kernels import attn_skeleton as sk
    bh, t, d = q.shape
    qa, ka, va = (a.abs() for a in (q, k, v))
    s_abs = qa @ ka.transpose(1, 2)
    o = sk.attn_skeleton_fwd(q, k, v, block_q)
    torch.cuda.synchronize()
    e_o = _check(name + " o", o, sk.attn_skeleton_fwd_plain(q, k, v),
                 K8_SUM_RTOL * (s_abs @ va))
    del o
    if do is None:
        return e_o, []
    grads = sk.attn_skeleton_bwd(q, k, v, do, block_q)
    torch.cuda.synchronize()
    rgrads = sk.attn_skeleton_bwd_plain(q, k, v, do, block_q)
    da = do.abs()
    ds_abs = s_abs * (da @ va.transpose(1, 2))
    nq = t // block_q

    def per_block(a, x):
        return a.view(bh, nq, block_q, t).transpose(2, 3) @ \
            x.view(bh, nq, block_q, d)

    errs = [_check(f"{name} {n}", g, r, K8_SUM_RTOL * terms)
            for n, g, r, terms in (
                ("dq", grads[0], rgrads[0], ds_abs @ ka),
                ("dkp", grads[1], rgrads[1], per_block(ds_abs, qa)),
                ("dvp", grads[2], rgrads[2], per_block(s_abs, da)))]
    return e_o, errs


def _sm90_report(built, dtype):
    """Log the ptxas lines of the Hopper K1/K2 form for ``dtype`` (from
    ``built``, the build log) and its dynamic shared memory a block beside
    the other form's."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    f32 = dtype == torch.float32
    form, other = ("float32", torch.bfloat16) if f32 else ("bf16",
                                                          torch.float32)
    for lib in ("flash_attn_fwd_sm90", "flash_attn_bwd_sm90"):
        if lib not in built:
            _log("kernel", f"{lib}: built before this run, no ptxas log")
            continue
        for fn, lines in _ptxas_lines(built[lib]["log"]).items():
            mine = (fn.endswith(", 3>") or fn.endswith("<f>")
                    or "split_planes" in fn) if f32 else (
                fn.endswith(", 1>") or fn.endswith("<__nv_bfloat16>"))
            if mine:
                _log("kernel", f"ptxas {lib} ({form}) {fn}: "
                     f"{'; '.join(lines)}")
    for d_ in (64, 128):
        mine, theirs = (fa.sm90_shared_bytes(d_, t) for t in (dtype, other))
        _log("kernel", f"{form} K1/K2 dynamic shared memory a block at d <= "
             f"{d_}: " + ", ".join(f"{k} {v} bytes ({theirs[k]} in the "
                                   f"{'bf16' if f32 else 'float32'} form)"
                                   for k, v in mine.items()))


def _ptxas_by_kernel(log, pattern):
    """``{kernel<template arguments>: [what ptxas -v says of it]}`` for the
    entry functions of a build log whose names match ``pattern``:
    registers, spills, and the notes C7507 (the setmaxnreg split ignored)
    and C7512 (wgmmas serialized) where ptxas names the function."""
    name, out = None, {}
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(f"({pattern})I(\\w+?)EEv", m.group(1))
            name = None
            if k:
                args = ", ".join(re.findall(r"L[ib](\d+)E", k.group(2)))
                name = f"{k.group(1)}<{args or k.group(2)}>"
                out[name] = []
        elif name and ("Used" in ln or "spill" in ln or "C75" in ln):
            out[name].append(ln.split(":", 1)[-1].strip()[:90])
    return out


def _core_report(built):
    """Log what ptxas says of each kernel of the float32 K3 and of K6,
    which build A in registers: registers, spills, and its performance
    notes (C7507: the setmaxnreg split ignored; C7512: wgmmas serialized)."""
    for lib, tag in (("conv1x1_stats", "conv_f32_kernel"),
                     ("matmul_bn_stats", "mm_stats_kernel")):
        if lib not in built:
            _log("kernel", f"{lib}: built before this run, no ptxas log")
            continue
        for fn, lines in _ptxas_by_kernel(built[lib]["log"], tag).items():
            _log("kernel", f"ptxas {lib} {fn}: {'; '.join(lines)}")
    # ptxas names no function in this note: counted a library
    for lib in ("conv1x1_stats", "matmul_bn_stats", "dense_epilogue"):
        if lib in built:
            n = built[lib]["log"].count("C7507")
            _log("kernel", f"ptxas {lib}: {n} kernels with (C7507) "
                 "'setmaxnreg' ignored")


def _k4_k7_report(built):
    """Log what ptxas says of the K4 row backward (per row type and units
    a lane), its second pass and the merge kernel (per type and elements
    an access): registers, shared memory and spills; and how many clusters
    of the row backward the card holds at once against its grid's."""
    pat = (r"(ln_bwd_row_kernel|ring_merge_kernel)I(f|13__nv_bfloat16)"
           r"Li(\d+)E")
    for lib in ("layer_norm", "ring_attention"):
        if lib not in built:
            _log("kernel", f"{lib}: built before this run, no ptxas log")
            continue
        name, lines = None, {}
        for ln in built[lib]["log"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                k = re.search(pat, m.group(1))
                if k:
                    kind = "float" if k.group(2) == "f" else "bf16"
                    name = f"{k.group(1)}<{kind}, {k.group(3)}>"
                else:
                    name = ("colsum_rows_kernel" if "colsum_rows_kernel"
                            in m.group(1) else None)
                if name:
                    lines[name] = []
            elif name and ("Used" in ln or "spill" in ln):
                lines[name].append(ln.split(":", 1)[-1].strip()[:90])
        for fn, what in lines.items():
            _log("kernel", f"ptxas {lib} {fn}: {'; '.join(what)}")
    import ctypes
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import layer_norm as ln
    lib = _build.load("layer_norm")
    active = lib.paddle_tpu_torch_layer_norm_active_clusters
    active.argtypes, active.restype = [ctypes.c_int], ctypes.c_int
    for dtype, code in ln.DTYPES.items():
        n = active(code)
        if n <= 0:
            raise AssertionError(f"K4 row backward {dtype}: occupancy query "
                                 f"failed (CUDA error {-n})")
        grid = ln.ROW_CLUSTERS[dtype]
        _log("kernel", f"K4 row backward {dtype} at d {ln.ROW_MAX_D[dtype]}:"
             f" the card holds {n} clusters of 8 blocks at once; its grid "
             f"takes at most {grid} ("
             f"{'one wave' if n >= grid else 'more than one wave'})")


def _sass_hgmma(lib):
    """``{function: HGMMA instructions in its SASS}`` of the built library
    ``lib`` (``cuobjdump -sass``, beside nvcc): the ``wgmma`` a kernel
    really issues."""
    from paddle_tpu_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(lib))],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            out[fn] = 0
        elif fn and "HGMMA" in ln:
            out[fn] += 1
    return out


def _k8_report(built):
    """Log what ptxas says of each kernel of K8's source (registers,
    spills, and the notes C7507, 'setmaxnreg' ignored, and C7512, wgmmas
    serialized), the HGMMA instructions in each skeleton kernel's SASS
    (none fails: the skeletons run on the tensor cores) and the dynamic
    shared memory a block takes at d 64 and 128, which must equal
    ``attn_skeleton.shared_bytes`` (the layout the CPU tests hold to the
    227 KB a block may use)."""
    import ctypes
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import attn_skeleton as sk
    lib = "attn_skeleton"
    if lib not in built:
        _log("kernel", f"{lib}: built before this run, no ptxas log")
    else:
        log = built[lib]["log"]
        for fn, lines in _ptxas_by_kernel(
                log, r"skeleton_(?:fwd|bwd)_sm90_kernel|"
                     r"split_planes_kernel").items():
            _log("kernel", f"ptxas {lib} {fn}: {'; '.join(lines)}")
        _log("kernel", f"ptxas {lib}: {log.count('C7507')} notes (C7507) "
             f"'setmaxnreg' ignored, {log.count('C7512')} (C7512) wgmma "
             "serialized")
    hgmma = {}
    for fn, n in _sass_hgmma(lib).items():
        k = re.search(r"(skeleton_(?:fwd|bwd)_sm90_kernel)I(\w+?)EEv", fn)
        if k:
            args = ", ".join(re.findall(r"L[ib](\d+)E", k.group(2)))
            hgmma[f"{k.group(1)}<{args}>"] = n
    if len(hgmma) != 6 or not all(hgmma.values()):
        raise AssertionError(f"K8's kernels issue no wgmma (HGMMA in SASS): "
                             f"{hgmma}")
    _log("kernel", f"SASS {lib}: HGMMA instructions "
         + ", ".join(f"{k} {v}" for k, v in sorted(hgmma.items())))
    fn = _build.load(lib).paddle_tpu_torch_attn_skeleton_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    for d in (64, 128):
        got = {key: fn(d, which) for which, key in enumerate(
            ("fwd", "bwd", "bwd_block_q_gt_64"))}
        want = {"fwd": sk.shared_bytes(d)["fwd"],
                "bwd": sk.shared_bytes(d)["bwd"],
                "bwd_block_q_gt_64": sk.shared_bytes(d, 128)["bwd"]}
        if got != want:
            raise AssertionError(f"K8 shared memory at d {d}: the source "
                                 f"lays out {got}, shared_bytes says {want}")
        _log("kernel", f"K8 dynamic shared memory a block at d <= {d}: "
             + ", ".join(f"{k} {v} bytes" for k, v in got.items())
             + f" (of {sk.MAX_SHARED_BYTES})")


def _high_range(x, g):
    """``x`` with each row (the last dim) scaled by 2^e, e an integer
    drawn uniformly from [-8, 8]: a K8 input whose products span 2^±24,
    so that a two-term split or one long tensor-core chain would break the
    2^-20-of-terms check."""
    import torch
    e = torch.randint(-8, 9, x.shape[:-1] + (1,), device=x.device,
                      generator=g)
    return x * torch.exp2(e.float())


def _ulps_off(got, ref, ulps=4):
    """How many float32 values of ``got`` lie more than ``ulps`` float32
    ulps of the plain version's value from it, and the share of those
    nearer zero (about half when the sums differ only in order, more when
    one side's sums truncate)."""
    import torch
    r = ref.abs()
    ulp = torch.where(r > 0, torch.exp2(torch.floor(torch.log2(r)) - 23),
                      torch.full_like(r, 2.0 ** -149))
    off = (got - ref).abs() > ulps * ulp
    n = int(off.sum())
    toward = int((off & (got.abs() < r)).sum())
    return (f"{n} of {got.numel()} ({100 * n / got.numel():.1f}%) beyond "
            f"{ulps} float32 ulps of the plain version's, "
            f"{100 * toward / max(n, 1):.0f}% of them nearer zero")


def phase_kernel(built):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    _sm90_report(built, torch.float32)
    _k4_k7_report(built)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    bh, t, d = SLICE
    cases = [
        ("slice [96,2048,64] causal", bh, t, t, d, True, None),
        # a dp_train rank's call: 2 sequences x 12 heads
        ("dp rank [24,2048,64] causal", 24, t, t, d, True, None),
        ("T=1000 causal", 8, 1000, 1000, 64, True, None),
        ("T=1000 non-causal", 8, 1000, 1000, 64, False, None),
        ("bias [1,Tq,Tk]", 8, 700, 700, 64, False, "one"),
        ("bias [bh,Tq,Tk]", 8, 700, 700, 64, False, "bh"),
        ("Tq=128 < Tk=1024 causal", 12, 128, 1024, 64, True, None),
        ("fully masked rows (-inf bias)", 4, 256, 256, 64, False, "-inf"),
        ("fully masked rows (causal Tq > Tk)", 4, 200, 72, 64, True, None),
        ("d=32 causal", 8, 777, 777, 32, True, None),
        ("d=128 causal", 8, 777, 777, 128, True, None),
        # head dims that are not multiples of 8 run zero-padded
        ("d=12 causal", 8, 300, 300, 12, True, None),
        ("d=20 Tq=77 Tk=90 non-causal", 8, 77, 90, 20, False, None),
    ]
    # K1 and K2 as the attn_ceiling path calls them: non-causal, d 64
    from paddle_tpu_torch.tools.attn_shape_ceiling import CASES
    cases += [(f"attn_ceiling [{bh_}, {t_}, 64] non-causal", bh_, t_, t_, 64,
               False, None) for t_, bh_ in CASES]
    # K1 and K2 as a ring step runs them (ring_kernel, ring_train): a
    # [24, 2048, 64] shard, K2 given the delta the ring computes once
    cases += [(f"ring step {_ring_step_shape()} {c}, given delta", 24,
               2048, 2048, 64, c == "causal", "delta")
              for c in ("non-causal", "causal")]
    worst = {"flash_attn_fwd": 0.0, "flash_attn_bwd": 0.0}
    for name, bh_, tq, tk, d_, causal, bias_kind in cases:
        q = torch.randn(bh_, tq, d_, device="cuda", generator=g)
        k = torch.randn(bh_, tk, d_, device="cuda", generator=g)
        v = torch.randn(bh_, tk, d_, device="cuda", generator=g)
        bias = None
        if bias_kind == "one":
            bias = torch.randn(1, tq, tk, device="cuda", generator=g)
        elif bias_kind == "bh":
            bias = torch.randn(bh_, tq, tk, device="cuda", generator=g)
        elif bias_kind == "-inf":
            bias = torch.zeros(1, tq, tk, device="cuda")
            bias[0, 5::17, :] = float("-inf")
        o, lse = fa.flash_attention_fwd(q, k, v, bias, causal)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v, bias, causal)
        torch.cuda.synchronize()
        e_o = _check(name + " o", o, ro)
        e_l = _check(name + " lse", lse, rlse)
        if bias_kind == "-inf":
            rows = o[:, 5::17]
            assert bool((rows == 0).all()), "fully masked rows must give o=0"
        worst["flash_attn_fwd"] = max(worst["flash_attn_fwd"], e_o, e_l)
        yardstick = ""
        if bias is None and tq == tk:
            # the library's float32 attention counted the same way
            sdpa = F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  is_causal=causal)[0]
            yardstick = f"; SDPA float32's o: {_ulps_off(sdpa, ro)}"
            del sdpa
        _log("kernel", f"flash_attn_fwd {name}: max abs err o {e_o:.3g} "
             f"lse {e_l:.3g} (atol {ATOL}, rtol {RTOL}) ok; o: "
             f"{_ulps_off(o, ro)}{yardstick}")
        if bias is not None:
            continue        # a biased backward is the plain version
        do = torch.randn(bh_, tq, d_, device="cuda", generator=g)
        delta = (torch.sum(do * ro, dim=-1) if bias_kind == "delta"
                 else None)
        got = fa.flash_attention_bwd(q, k, v, ro, rlse, do, causal, None,
                                     delta)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, ro, rlse, do, None,
                                                causal, None, delta)
        torch.cuda.synchronize()
        errs = [_check(f"{name} {n}", a, b)
                for n, a, b in zip(("dq", "dk", "dv"), got, want)]
        if tq > tk and causal:
            assert bool((got[0][:, :tq - tk] == 0).all()), \
                "rows without a live key must get dq = 0"
        worst["flash_attn_bwd"] = max(worst["flash_attn_bwd"], *errs)
        _log("kernel", f"flash_attn_bwd {name}: max abs err dq {errs[0]:.3g}"
             f" dk {errs[1]:.3g} dv {errs[2]:.3g} (atol {ATOL}, rtol "
             f"{RTOL}) ok; dq: {_ulps_off(got[0], want[0])}; dv: "
             f"{_ulps_off(got[2], want[2])}")
        del got, want

    # K3 at ResNet-50's shapes at the training batch, then the edges
    _core_report(built)
    k3_cases = [(f"[{RESNET_BATCH}, {ci}, {p}] x [{co}, {ci}]",
                 RESNET_BATCH, ci, co, p, 1) for ci, co, p in K3_SHAPES]
    k3_cases += [("N=1 P=49", 1, 512, 2048, 49, 1),
                 ("Cin 13 Cout 70 P 65 (ragged tiles)", 3, 13, 70, 65, 1),
                 ("Cin 12 Cout 20 P 49", 5, 12, 20, 49, 1),
                 ("Cin 3 Cout 5 P 1", 2, 3, 5, 1, 1),
                 ("stride-2 view of [8, 256, 56, 56]", 8, 256, 512, 3136, 2),
                 ("stride-2 view of [8, 1024, 14, 14]", 8, 1024, 2048, 196,
                  2)]
    worst["conv1x1_stats"] = 0.0
    from paddle_tpu_torch.kernels import conv_bn as cb
    for name, n, ci, co, p, stride in k3_cases:
        side = int(round(p ** 0.5))
        if stride > 1:
            x4 = torch.randn(n, ci, side, side, device="cuda", generator=g)
            x = x4[:, :, ::stride, ::stride].reshape(n, ci, -1)
            del x4
        else:
            x = torch.randn(n, ci, p, device="cuda", generator=g)
        w = torch.randn(co, ci, device="cuda", generator=g) * ci ** -0.5
        e_y, e_s, e_s2 = check_k3(name, x, w)
        worst["conv1x1_stats"] = max(worst["conv1x1_stats"], e_y)
        _log("kernel", f"conv1x1_stats {name} (x by {cb.f32_route(p)}"
             f"{', copied' if cb.f32_operand(x) is not x else ''}): max abs"
             f" err y {e_y:.3g} s "
             f"{e_s:.3g} s2 {e_s2:.3g} (atol {ATOL}, rtol {RTOL}, + "
             f"{K3_SUM_RTOL:.3g} sum|w||x| on y, {K3_STAT_RTOL:.3g} of "
             f"sum|y| / s2 on the stats) ok")
        del x, w

    # K5 at the fused path's shapes (batch 8 x 2048 tokens and fractions of
    # it), each activation, then the edges
    from paddle_tpu_torch.kernels import dense_epilogue as de
    from paddle_tpu_torch.kernels import layer_norm as ln
    acts = (("", False), ("relu", False), ("gelu", False), ("gelu", True))
    k5_cases = [(f"[{m}, 768] x [768, 3072]", m, 768, 3072)
                for m in (4096, 8192, 16384)]
    k5_cases += [("M=1", 1, 768, 3072), ("M=513", 513, 768, 3072),
                 ("ragged N, K: [300, 100] x [100, 130]", 300, 100, 130),
                 ("ragged M, N, K: [257, 33] x [33, 7]", 257, 33, 7)]
    worst["dense_epilogue"] = 0.0
    for name, m, k, n in k5_cases:
        x = torch.randn(m, k, device="cuda", generator=g)
        w = torch.randn(k, n, device="cuda", generator=g) * k ** -0.5
        b = torch.randn(n, device="cuda", generator=g)
        terms = x.to(torch.bfloat16).float().abs() @ \
            w.to(torch.bfloat16).float().abs()
        errs = []
        for act, approx in acts:
            y = de.dense_act_fwd(x, w, b, act, approx)
            torch.cuda.synchronize()
            ry = de.dense_act_plain(x, w, b, act, approx)
            what = f"dense_epilogue {name} act {act or 'none'}" + (
                " (tanh)" if approx else "")
            errs.append(_check(what, y, ry, K3_SUM_RTOL * terms))
            del y, ry
        worst["dense_epilogue"] = max(worst["dense_epilogue"], *errs)
        _log("kernel", f"dense_epilogue {name}: max abs err y, act none/"
             f"relu/gelu/gelu-tanh {'/'.join(f'{e:.3g}' for e in errs)} "
             f"(atol {ATOL}, rtol {RTOL}, + {K3_SUM_RTOL:.3g} sum|x||w|) ok")
        del x, w, b, terms

    # K4 at the fused path's shape, then the edges
    k4_cases = [("[16384, 768]", 16384, 768), ("rows 1", 1, 768),
                ("rows 4099", 4099, 768), ("d 96", 4099, 96),
                ("d 1000", 4099, 1000), ("d 4096", 4099, 4096)]
    worst["layer_norm_fwd"] = worst["layer_norm_bwd"] = 0.0
    for name, rows, d in k4_cases:
        x = torch.randn(rows, d, device="cuda", generator=g) * 2 + 0.5
        sc = torch.randn(d, device="cuda", generator=g) + 1
        bi = torch.randn(d, device="cuda", generator=g)
        dy = torch.randn(rows, d, device="cuda", generator=g)
        y = ln.layer_norm_fwd(x, sc, bi, 1e-5)
        dx, ds, db = ln.layer_norm_bwd(x, sc, dy, 1e-5)
        torch.cuda.synchronize()
        ry = ln.layer_norm_fwd_plain(x, sc, bi, 1e-5)
        rdx, rds, rdb = ln.layer_norm_bwd_plain(x, sc, dy, 1e-5)
        xhat = ln.layer_norm_fwd_plain(x, torch.ones_like(sc),
                                       torch.zeros_like(bi), 1e-5)
        e_y = _check(f"layer_norm_fwd {name} y", y, ry)
        e_dx = _check(f"layer_norm_bwd {name} dx", dx, rdx)
        e_ds = _check(f"layer_norm_bwd {name} dscale", ds, rds,
                      K4_SUM_RTOL * (dy * xhat).abs().sum(dim=0))
        e_db = _check(f"layer_norm_bwd {name} dbias", db, rdb,
                      K4_SUM_RTOL * dy.abs().sum(dim=0))
        worst["layer_norm_fwd"] = max(worst["layer_norm_fwd"], e_y)
        worst["layer_norm_bwd"] = max(worst["layer_norm_bwd"], e_dx)
        _log("kernel", f"layer_norm {name}: max abs err y {e_y:.3g} dx "
             f"{e_dx:.3g} (atol {ATOL}, rtol {RTOL}) dscale {e_ds:.3g} "
             f"dbias {e_db:.3g} (+ {K4_SUM_RTOL:.3g} sum of |terms|) ok")
        del x, dy, y, dx, ry, rdx, xhat

    # K6 at rn50_fused_bench's four calls (bf16, each stage's second call
    # normalizing the first's output with its statistics), then the edges
    from paddle_tpu_torch.tools.rn50_fused_bench import SHAPES
    worst["matmul_bn_stats"] = 0.0
    bf16 = torch.bfloat16

    def log_k6(name, errs):
        worst["matmul_bn_stats"] = max(worst["matmul_bn_stats"], errs[0])
        _log("kernel", f"matmul_bn_stats {name}: max abs err y {errs[0]:.3g}"
             f" s {errs[1]:.3g} s2 {errs[2]:.3g} (atol {ATOL}, rtol {RTOL},"
             f" + {K3_SUM_RTOL:.3g} sum|a||w|, + {K6_BF16_RTOL:.3g} |y| for "
             f"a bf16 y; {K3_STAT_RTOL:.3g} of sum|y| / s2 on the stats) ok")

    for stage, m, cin, cmid in SHAPES:
        x = (torch.randn(m, cin, device="cuda", generator=g) * 0.5).to(bf16)
        w1 = (torch.randn(cin, cmid, device="cuda", generator=g)
              * 0.05).to(bf16)
        w2 = (torch.randn(cmid, cmid, device="cuda", generator=g)
              * 0.05).to(bf16)
        errs, (y1, s, s2) = check_k6(f"{stage} call 1 [{m}, {cin}] x "
                                     f"[{cin}, {cmid}] bf16", x, w1, None,
                                     False)
        log_k6(f"{stage} call 1", errs)
        del x
        mu = s / m
        inv = torch.rsqrt(s2 / m - mu * mu + 1e-5)
        ps = (mu, inv, torch.ones_like(mu), torch.zeros_like(mu))
        errs, _ = check_k6(f"{stage} call 2 (normalize + relu)", y1, w2, ps,
                           True)
        log_k6(f"{stage} call 2 [{m}, {cmid}] x [{cmid}, {cmid}] bf16, "
               f"normalize + relu", errs)
        del y1
    for m in (513, 1):
        for k, n in ((24, 64), (40, 70)):
            x = torch.randn(m, k, device="cuda", generator=g)
            w = torch.randn(k, n, device="cuda", generator=g) * k ** -0.5
            ps = (torch.randn(k, device="cuda", generator=g) * 0.1,
                  torch.rand(k, device="cuda", generator=g) + 0.5,
                  1 + torch.randn(k, device="cuda", generator=g) * 0.1,
                  torch.randn(k, device="cuda", generator=g) * 0.1)
            for stats, relu in ((None, False), (None, True), (ps, True),
                                (ps, False)):
                what = (f"f32 [{m}, {k}] x [{k}, {n}]"
                        f"{' normalize' if stats else ''}"
                        f"{' + relu' if relu else ''}")
                errs, _ = check_k6(what, x, w, stats, relu)
                log_k6(what, errs)

    # the float32 K3's and K6's outputs against their plain versions, bit
    # by bit: digests and the share off (tools/gemm_flips.py)
    from paddle_tpu_torch.tools import gemm_flips
    for case, r in gemm_flips.run(
            os.path.dirname(os.path.abspath(__file__)),
            ("conv1x1_stats_f32", "matmul_bn_stats")).items():
        _log("kernel", f"digest {case}: {r['digest']}, {r['n']} of "
             f"{r['total']} off the plain version's, "
             f"{100 * r['toward'] / max(r['n'], 1):.0f}% of them nearer zero")
    torch.cuda.empty_cache()

    # K8 at (bh 4, T 512), d 64 and 128, block_q 64 and 128; then at the
    # attn_ceiling path's calls: K1/K2's 64-row blocks at each of its cases,
    # forward and backward at d 64, forward at d 128; then inputs whose rows
    # are scaled by 2^-8..2^8 (_high_range) at both backward layouts
    from paddle_tpu_torch.kernels.flash_attention import BLOCK_Q
    _k8_report(built)
    worst["attn_skeleton_fwd"] = worst["attn_skeleton_bwd"] = 0.0
    k8_cases = [(4, 512, d, bq, True, False) for d in (64, 128)
                for bq in (64, 128)]
    k8_cases += [(bh_, t_, d, BLOCK_Q, d == 64, False) for t_, bh_ in CASES
                 for d in (64, 128)]
    k8_cases += [(4, 512, d, bq, True, True) for d, bq in ((64, 64),
                                                           (128, 128))]
    for bh_, t_, d, block_q, bwd, wide in k8_cases:
        q, k, v, do = (torch.randn(bh_, t_, d, device="cuda", generator=g)
                       for _ in range(4))
        if wide:
            q, k, v, do = (_high_range(x, g) for x in (q, k, v, do))
        name = (f"[{bh_}, {t_}, {d}] block_q {block_q}"
                f"{' rows scaled 2^-8..2^8' if wide else ''}")
        e_o, errs = check_k8(name, q, k, v, do if bwd else None, block_q)
        if not wide:    # scaled rows' errors scale with them (up to 2^24)
            worst["attn_skeleton_fwd"] = max(worst["attn_skeleton_fwd"], e_o)
            worst["attn_skeleton_bwd"] = max(worst["attn_skeleton_bwd"],
                                             *errs, 0.0)
        grads = (f" dq {errs[0]:.3g} dkp {errs[1]:.3g} dvp {errs[2]:.3g}"
                 if bwd else " (forward only)")
        _log("kernel", f"attn_skeleton {name}: max abs err o {e_o:.3g}"
             f"{grads} (atol {ATOL}, rtol {RTOL}, + {K8_SUM_RTOL:.3g} of the "
             f"sum of |terms|) ok")
        del q, k, v, do
    torch.cuda.empty_cache()
    worst.update(check_dropout("float32"))
    return worst


def _bf16_ulp(t):
    """One bf16 ulp of ``t``'s largest magnitude."""
    top = float(t.float().abs().max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def _check_bf16(name, got, ref, extra=None):
    """Max abs error of the bf16 ``got`` against the bf16 ``ref``; raises
    unless every value is within BF16_ULPS bf16 ulps of ``ref``'s largest
    magnitude (plus ``extra``, a per-value allowance, where given)."""
    import torch
    if got.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: dtypes {got.dtype}, {ref.dtype}, "
                             "expected bfloat16")
    err = (got.float() - ref.float()).abs()
    ulp = _bf16_ulp(ref)
    bound = BF16_ULPS * ulp + (0.0 if extra is None else extra)
    bad = ~(err <= bound)
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} values beyond "
                             f"{BF16_ULPS} bf16 ulp ({ulp:.3g}) of the "
                             f"largest magnitude; max abs "
                             f"{float(err.max())}")
    return float(err.max())


def _flips(got, ref):
    """How many of the bf16 ``got`` differ from the bf16 ``ref`` (each by
    landing on the other neighbour of a float32 value), and the share of
    those nearer zero: about half when the two sums differ only in order,
    more when one of them drifts toward zero."""
    diff = got != ref
    n = int(diff.sum())
    toward = int((diff & (got.float().abs() < ref.float().abs())).sum())
    return (f"{n} of {got.numel()} ({100 * n / got.numel():.3f}%) differ "
            f"from the plain version's, {100 * toward / max(n, 1):.0f}% of "
            "them nearer zero")


def phase_kernel_bf16(built):
    """The bf16 forms of K1-K5 (AMP) against their plain versions on the
    card, at the AMP paths' shapes and the float32 checks' edges: K1/K2
    (the Hopper kernels, whose ptxas lines from ``built``, the build log,
    and shared memory it prints first) at [96, 2048, 64] causal, a ragged
    T, the biased forward, d 128 at T 130, d 40 ragged non-causal, causal
    Tq < Tk, and a ring step's [24, 2048, 64] shard causal and not, K2
    given the delta the ring computes once; K3 at
    ResNet-50's 15 conv1x1 shapes at batch 256 (bf16 x, the float32
    master w); K4 at [16384, 768] and a ragged row count; K5 at [16384,
    768] x [768, 3072] gelu and relu and an M that is not a tile
    multiple."""
    import torch
    from paddle_tpu_torch.kernels import conv_bn as cb
    from paddle_tpu_torch.kernels import dense_epilogue as de
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    _sm90_report(built, torch.bfloat16)
    g = torch.Generator(device="cuda")
    g.manual_seed(10)
    bf16 = torch.bfloat16
    worst = dict.fromkeys(("flash_attn_fwd_bf16", "flash_attn_bwd_bf16",
                           "conv1x1_stats_bf16", "layer_norm_fwd_bf16",
                           "layer_norm_bwd_bf16", "dense_epilogue_bf16"),
                          0.0)
    bh, t, d = SLICE
    step = _ring_step_shape()
    for name, bh_, tq, tk, d_, causal, kind in (
            ("slice [96,2048,64] causal", bh, t, t, d, True, None),
            ("T=1000 causal", 8, 1000, 1000, 64, True, None),
            ("bias [1,Tq,Tk] T=700", 8, 700, 700, 64, False, "bias"),
            ("d=128 T=130 causal", 24, 130, 130, 128, True, None),
            ("d=40 Tq=77 Tk=90 non-causal", 24, 77, 90, 40, False, None),
            ("causal Tq=512 < Tk=2048", 24, 512, 2048, 64, True, None),
            ("d=12 T=300 causal", 24, 300, 300, 12, True, None),
            ("d=20 Tq=77 Tk=90 non-causal", 24, 77, 90, 20, False, None),
            (f"ring step {step} non-causal, given delta", 24, 2048, 2048,
             64, False, "delta"),
            (f"ring step {step} causal, given delta", 24, 2048, 2048, 64,
             True, "delta")):
        q, k, v = (torch.randn(bh_, n, d_, device="cuda",
                               generator=g).to(bf16) for n in (tq, tk, tk))
        biased = kind == "bias"
        bias = torch.randn(1, tq, tk, device="cuda",
                           generator=g) if biased else None
        o, lse = fa.flash_attention_fwd(q, k, v, bias, causal)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v, bias, causal)
        e_o = _check_bf16(name + " o", o, ro)
        e_l = _check(name + " lse", lse, rlse)
        worst["flash_attn_fwd_bf16"] = max(worst["flash_attn_fwd_bf16"],
                                           e_o)
        _log("kernel", f"flash_attn_fwd bf16 {name}: max abs err o "
             f"{e_o:.3g} ({BF16_ULPS} bf16 ulp of max|o|), lse {e_l:.3g} "
             f"(atol {ATOL}, rtol {RTOL}) ok; o: {_flips(o, ro)}")
        del o, lse
        if biased:
            continue        # a biased backward is the plain version
        do = torch.randn(bh_, tq, d_, device="cuda", generator=g).to(bf16)
        delta = (torch.sum(do.float() * ro.float(), dim=-1)
                 if kind == "delta" else None)
        got = fa.flash_attention_bwd(q, k, v, ro, rlse, do, causal, None,
                                     delta)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, ro, rlse, do, None,
                                                causal, None, delta)
        errs = [_check_bf16(f"{name} {n}", a, b)
                for n, a, b in zip(("dq", "dk", "dv"), got, want)]
        worst["flash_attn_bwd_bf16"] = max(worst["flash_attn_bwd_bf16"],
                                           *errs)
        _log("kernel", f"flash_attn_bwd bf16 {name}: max abs err dq "
             f"{errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} ("
             f"{BF16_ULPS} bf16 ulp of each max) ok; dv: "
             f"{_flips(got[2], want[2])}")
        del got, want, q, k, v, do
    torch.cuda.empty_cache()

    for ci, co, p in K3_SHAPES:
        n = AMP_BATCH_RESNET
        name = f"[{n}, {ci}, {p}] bf16 x [{co}, {ci}] f32"
        x = torch.randn(n, ci, p, device="cuda", generator=g).to(bf16)
        w = torch.randn(co, ci, device="cuda", generator=g) * ci ** -0.5
        y, s, s2 = cb.conv1x1_stats_fwd(x, w)
        torch.cuda.synchronize()
        ry, rs, rs2 = cb.conv1x1_stats_plain(x, w)
        terms = torch.einsum("oc,ncp->nop", w.to(bf16).float().abs(),
                             x.float().abs())
        e_y = _check_bf16(name + " y", y, ry, K3_SUM_RTOL * terms)
        del terms
        e_s = _check(name + " s", s, rs,
                     K3_STAT_RTOL * ry.float().abs().sum(dim=(0, 2)))
        e_s2 = _check(name + " s2", s2, rs2, K3_STAT_RTOL * rs2)
        worst["conv1x1_stats_bf16"] = max(worst["conv1x1_stats_bf16"], e_y)
        _log("kernel", f"conv1x1_stats {name}: max abs err y {e_y:.3g} "
             f"({BF16_ULPS} bf16 ulp of max|y| + {K3_SUM_RTOL:.3g} "
             f"sum|w||x|), s {e_s:.3g} s2 {e_s2:.3g} ok; y: {_flips(y, ry)}")
        del x, y, ry
    torch.cuda.empty_cache()

    for name, rows, d_ in (("[16384, 768]", 16384, 768),
                           ("rows 4099", 4099, 768)):
        x = (torch.randn(rows, d_, device="cuda", generator=g) * 2
             + 0.5).to(bf16)
        sc = torch.randn(d_, device="cuda", generator=g) + 1
        bi = torch.randn(d_, device="cuda", generator=g)
        dy = torch.randn(rows, d_, device="cuda", generator=g).to(bf16)
        y = ln.layer_norm_fwd(x, sc, bi, 1e-5)
        dx, ds, db = ln.layer_norm_bwd(x, sc, dy, 1e-5)
        torch.cuda.synchronize()
        ry = ln.layer_norm_fwd_plain(x, sc, bi, 1e-5)
        rdx, rds, rdb = ln.layer_norm_bwd_plain(x, sc, dy, 1e-5)
        xhat = ln.layer_norm_fwd_plain(x.float(), torch.ones_like(sc),
                                       torch.zeros_like(bi), 1e-5)
        e_y = _check_bf16(f"layer_norm_fwd bf16 {name} y", y, ry)
        e_dx = _check_bf16(f"layer_norm_bwd bf16 {name} dx", dx, rdx)
        e_ds = _check(f"layer_norm_bwd bf16 {name} dscale", ds, rds,
                      K4_SUM_RTOL * (dy.float() * xhat).abs().sum(dim=0))
        e_db = _check(f"layer_norm_bwd bf16 {name} dbias", db, rdb,
                      K4_SUM_RTOL * dy.float().abs().sum(dim=0))
        worst["layer_norm_fwd_bf16"] = max(worst["layer_norm_fwd_bf16"], e_y)
        worst["layer_norm_bwd_bf16"] = max(worst["layer_norm_bwd_bf16"],
                                           e_dx)
        _log("kernel", f"layer_norm bf16 {name}: max abs err y {e_y:.3g} dx "
             f"{e_dx:.3g} ({BF16_ULPS} bf16 ulp of each max) dscale "
             f"{e_ds:.3g} dbias {e_db:.3g} (+ {K4_SUM_RTOL:.3g} sum of "
             f"|terms|) ok")

    for name, m, act in (("[16384, 768] x [768, 3072] gelu", 16384, "gelu"),
                         ("[16384, 768] x [768, 3072] relu", 16384, "relu"),
                         ("M=4097 gelu", 4097, "gelu")):
        x = torch.randn(m, 768, device="cuda", generator=g).to(bf16)
        w = (torch.randn(768, 3072, device="cuda", generator=g)
             * 768 ** -0.5).to(bf16)
        b = torch.randn(3072, device="cuda", generator=g)
        y = de.dense_act_fwd(x, w, b, act)
        torch.cuda.synchronize()
        ry = de.dense_act_plain(x, w, b, act)
        terms = x.float().abs() @ w.float().abs()
        e_y = _check_bf16(f"dense_epilogue bf16 {name} y", y, ry,
                          K3_SUM_RTOL * terms)
        worst["dense_epilogue_bf16"] = max(worst["dense_epilogue_bf16"], e_y)
        _log("kernel", f"dense_epilogue bf16 {name}: max abs err y "
             f"{e_y:.3g} ({BF16_ULPS} bf16 ulp of max|y| + "
             f"{K3_SUM_RTOL:.3g} sum|x||w|) ok; y: {_flips(y, ry)}")
        del x, w, y, ry, terms
    torch.cuda.empty_cache()
    worst.update(check_dropout("bfloat16"))
    return worst


def _gpt_cfg():
    from paddle_tpu_torch.models import transformer as T
    return T.BertConfig(vocab_size=30522, d_model=768, n_layer=12,
                        n_head=12, d_inner=3072, max_pos=2048, dropout=0.0)


def _factory(cfg, attn_impl="auto"):
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.models import transformer as T

    def factory(seq):
        prog, startup = Program(), Program()
        with program_guard(prog, startup):
            _, logits = T.build_gpt_serving(cfg, seq, attn_impl=attn_impl)
        return prog, ["src_ids"], [logits.name]
    return factory


def phase_serve():
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import transformer as T

    cfg = _gpt_cfg()
    factory = _factory(cfg)
    scope = Scope()
    exe = ptt.Executor()
    startup = Program()
    with program_guard(Program(), startup):
        T.build_gpt_serving(cfg, 512, attn_impl="auto")
    exe.run(startup, scope=scope, seed=1234)
    n_params = sum(int(scope.find_var(v.name).numel())
                   for v in startup.global_block().vars.values())
    head = cfg.d_model * cfg.vocab_size + cfg.vocab_size
    assert n_params == cfg.num_params() + head, n_params
    _log("serve", f"GPT causal LM, {n_params / 1e6:.1f} M parameters "
         f"(LM head included) on {exe.device}")

    buckets = (512, 1024, 2048)
    srv = ptt.serving.InferenceServer(factory, scope, buckets=buckets,
                                      max_batch=8, batch_wait_ms=20.0)
    rng = np.random.RandomState(7)
    lengths = [1100] + [int(x) for x in rng.randint(300, 2049, 23)]
    reqs = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int64)
            for n in lengths]

    # the main path, counted: warmup + 24 requests through the server
    fa.reset_launch_count()
    t_w = time.perf_counter()
    warmed = srv.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_w
    srv.start()
    t0 = time.perf_counter()
    futs = [srv.submit("tenant_a" if i % 2 else "tenant_b",
                       {"src_ids": ids}) for i, ids in enumerate(reqs)]
    outs = [f.result(timeout=600) for f in futs]
    assert srv.drain(120), "drain did not finish"
    wall = time.perf_counter() - t0
    srv.stop()
    launches = fa.launch_count()

    log = srv.batch_log()
    flash_batches = sum(1 for b in log if b["bucket"] >= 1024) + \
        sum(1 for b in buckets if b >= 1024)
    expected = cfg.n_layer * flash_batches
    if launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             f"expected {cfg.n_layer} x {flash_batches}")
    for ids, out in zip(reqs, outs):
        assert out[0].shape == (len(ids), cfg.vocab_size), out[0].shape
        assert np.isfinite(out[0]).all(), "non-finite logits"
    stats = srv.compile_stats()
    assert stats["traces"] == len(buckets), stats
    # each bucket's plan runs its CompiledProgram._optimized program
    fused = [[op for op, _ in p.ops if op.type == "fused_dense_act"]
             for p in srv.executor._plans.values()]
    if [len(f) for f in fused] != [cfg.n_layer] * len(buckets) or any(
            op.attrs["use_pallas"] for f in fused for op in f):
        raise AssertionError(
            f"bucket plans hold {[len(f) for f in fused]} fused_dense_act "
            f"ops, expected {cfg.n_layer} each without the kernel")
    _log("serve", f"CompiledProgram._optimized: {cfg.n_layer} "
         f"fused_dense_act (use_pallas False) in each of "
         f"{len(buckets)} bucket programs")
    _log("serve", f"warmup {warmed} buckets in {warm_s:.2f} s; "
         f"{len(reqs)} requests in {len(log)} batches "
         f"{[(b['bucket'], b['occupancy']) for b in log]}; plans built "
         f"{stats['traces']}; flash launches {launches} = "
         f"{cfg.n_layer} x {flash_batches} batches at buckets >= 1024")

    # one 1100-token request against the same bucket program on the host
    cpu_scope = Scope()
    for name, val in scope.items():
        cpu_scope.set_var(name, val.detach().cpu())
    prog, _, fetch = factory(2048)
    feed = np.zeros((1, 2048), np.int64)
    feed[0, :len(reqs[0])] = reqs[0]
    t_c = time.perf_counter()
    ref, = ptt.Executor(ptt.CPUPlace()).run(
        prog, feed={"src_ids": feed}, fetch_list=fetch, scope=cpu_scope)
    ref = ref[0, :len(reqs[0])]
    err = np.abs(outs[0][0] - ref)
    ok = err <= SERVE_ATOL + SERVE_RTOL * np.abs(ref)
    if not ok.all():
        raise AssertionError(f"served logits differ from the host run: max "
                             f"abs {err.max()} (atol {SERVE_ATOL} rtol "
                             f"{SERVE_RTOL})")
    _log("serve", f"1100-token request vs host run of the bucket-2048 "
         f"program ({time.perf_counter() - t_c:.1f} s): max abs err "
         f"{err.max():.3g}, max |logit| {np.abs(ref).max():.3g} "
         f"(atol {SERVE_ATOL}, rtol {SERVE_RTOL}) ok")
    tokens = int(sum(lengths))
    per_bucket = {}
    for b in log:
        per_bucket.setdefault(b["bucket"], []).append(b["latency_ms"])
    return {"wall_s": wall, "requests": len(reqs), "tokens": tokens,
            "launches": launches, "flash_batches": flash_batches,
            "per_bucket_ms": per_bucket, "batches": log,
            "scope": scope, "factory": factory}


#: every hand-written kernel's launch counter, by name: no kernel launches
#: on the decode path (its attention is plain einsum, as the reference's)
_KERNEL_MODULES = {
    "flash_attn_fwd": "flash_attention", "flash_attn_bwd": "flash_attention",
    "conv1x1_stats": "conv_bn", "matmul_bn_stats": "conv_bn",
    "layer_norm_fwd": "layer_norm", "layer_norm_bwd": "layer_norm",
    "dense_epilogue": "dense_epilogue", "attn_skeleton_fwd": "attn_skeleton",
    "attn_skeleton_bwd": "attn_skeleton", "ring_merge": "ring_attention",
    "dropout": "dropout"}


def _kernel_module(name):
    import importlib
    return importlib.import_module(
        "paddle_tpu_torch.kernels." + _KERNEL_MODULES[name])


def _launches_nonzero():
    counts = {n: _kernel_module(n).launch_count(n) for n in _KERNEL_MODULES}
    return {n: c for n, c in counts.items() if c}


def _teacher_forced(eng, toks, slot=0):
    """The engine's logits at every position of ``toks``, fed one token an
    iteration into ``slot`` (alone in the batch), then the slot freed."""
    S = eng.max_slots
    assert eng.reserve_slot(slot, -(-len(toks) // eng.page_len))
    ids, pos = np.zeros(S, np.int32), np.zeros(S, np.int32)
    active = np.arange(S) == slot
    out = []
    for t, tok in enumerate(toks):
        ids[slot], pos[slot] = tok, t
        out.append(eng.run_iteration(ids, pos, active)[slot])
    eng.release_slot(slot)
    return np.stack(out)


def _within(got, ref):
    err = np.abs(got - ref)
    return err, bool((err <= SERVE_ATOL + SERVE_RTOL * np.abs(ref)).all())


def phase_decode(serve, profile=False):
    """The paged-KV decode path at BERT-base width: ``DecodeServer`` over a
    ``DecodeEngine`` whose step is one captured CUDA graph."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.serving import DecodeEngine, DecodeServer

    cfg = _gpt_cfg()
    scope = serve["scope"]
    for name in _KERNEL_MODULES:
        _kernel_module(name).reset_launch_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    eng = DecodeEngine(cfg, scope, max_slots=DECODE_SLOTS)
    pages_a_slot = -(-cfg.max_pos // 16)
    if (eng.page_len, eng.max_seq, eng.max_pages, eng.cache.n_pages) != \
            (16, cfg.max_pos, pages_a_slot, 1 + DECODE_SLOTS * pages_a_slot):
        raise AssertionError("the flag defaults did not size the engine")
    pool = eng.cache.pool_bytes()
    _log("decode", f"DecodeEngine on {eng.device}: {DECODE_SLOTS} slots, "
         f"page_len {eng.page_len}, max_seq {eng.max_seq} "
         f"({eng.max_pages} pages a slot), {eng.cache.n_pages} pages; "
         f"pool_bytes {pool} (2 x {pool / 2e6:.1f} MB)")

    srv = DecodeServer(eng).start()
    rng = np.random.RandomState(11)
    lengths = rng.randint(DECODE_PROMPT[0], DECODE_PROMPT[1] + 1,
                          DECODE_REQUESTS - 1)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int64)
               for n in lengths]
    t0 = time.perf_counter()
    futs = [srv.submit("tenant_a" if i % 2 else "tenant_b", p,
                       max_new_tokens=DECODE_NEW)
            for i, p in enumerate(prompts)]
    gens = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    log = srv.iter_log()
    # the 16th request repeats the shortest prompt with eos_id set to its
    # first greedy token: it must return exactly that token
    j = int(np.argmin(lengths))
    eos = int(gens[j][0])
    eos_gen = srv.submit("tenant_a", prompts[j], max_new_tokens=DECODE_NEW,
                         eos_id=eos).result(timeout=600)
    if not srv.drain(60):
        raise AssertionError("decode drain did not finish")
    srv.stop()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    bad = [(i, len(g)) for i, g in enumerate(gens) if len(g) != DECODE_NEW]
    if bad or list(eos_gen) != [eos]:
        raise AssertionError(f"wrong generation lengths {bad}; EOS request "
                             f"gave {list(eos_gen)}, expected [{eos}]")
    if eng.trace_count != 1 or eng.cache.pages_in_use() != 0:
        raise AssertionError(f"trace_count {eng.trace_count}, pages in use "
                             f"{eng.cache.pages_in_use()}: expected 1, 0")
    tokens = sum(len(g) for g in gens)
    occ8 = [r["iter_ms"] for r in log if r["occupancy"] == DECODE_SLOTS]
    step8 = [r["step_ms"] for r in log if r["occupancy"] == DECODE_SLOTS]
    it_med, it_p90 = np.median(occ8), np.percentile(occ8, 90)
    _log("decode", f"{DECODE_REQUESTS} requests ({DECODE_REQUESTS - 1} "
         f"prompts of {lengths.min()}-{lengths.max()} tokens from two "
         f"tenants + 1 EOS request, ok), max_new_tokens {DECODE_NEW}: "
         f"{tokens} tokens generated in {wall:.3f} s over {len(log)} "
         f"iterations = {tokens / wall:.1f} tokens/s; trace_count "
         f"{eng.trace_count}, pages in use 0")
    _log("decode", f"iteration at occupancy {DECODE_SLOTS} ({len(occ8)} "
         f"iterations, host clock): median {it_med:.4f} ms, p90 "
         f"{it_p90:.4f} ms; the step alone (replay + logits to the host) "
         f"median {np.median(step8):.4f} ms, p90 "
         f"{np.percentile(step8, 90):.4f} ms")
    _log("decode", f"peak card memory {peak / 2**30:.3f} GiB, of which "
         f"{held / 2**30:.3f} GiB allocated before the engine; pools "
         f"{pool / 2**30:.3f} GiB")

    # the card against the full-context serving program at bucket 512, run
    # by the port on the card: logits at every position (teacher-forced
    # through the engine on a fresh slot), and each generated token the
    # program's argmax, or within the tolerance of it
    prog, _, fetch = _factory(cfg)(512)
    exe = ptt.Executor()
    picks = [int(i) for i in np.argsort(lengths)[::-1][:2]]
    ties, worst, forced = [], 0.0, {}
    for i in picks:
        toks = np.concatenate([prompts[i], gens[i]]).astype(np.int64)
        feed = np.zeros((1, 512), np.int64)
        feed[0, :len(toks)] = toks
        ref, = exe.run(prog, feed={"src_ids": feed}, fetch_list=fetch,
                       scope=scope)
        ref = ref[0, :len(toks)]
        got = forced[i] = _teacher_forced(eng, toks)
        err, ok = _within(got, ref)
        if not ok:
            raise AssertionError(f"decode logits of request {i} differ from "
                                 f"the program's: max abs {err.max()}")
        worst = max(worst, float(err.max()))
        for n, g in enumerate(gens[i]):
            row = ref[len(prompts[i]) - 1 + n]
            top = int(np.argmax(row))
            if top == int(g):
                continue
            if row[top] - row[g] > SERVE_ATOL + SERVE_RTOL * abs(row[top]):
                raise AssertionError(
                    f"request {i} token {n}: generated {int(g)}, the "
                    f"program's argmax {top} by {row[top] - row[g]}")
            ties.append((i, n))
    _log("decode", f"card vs the bucket-512 program on the card, requests "
         f"{picks} ({[len(prompts[i]) + DECODE_NEW for i in picks]} "
         f"positions): max abs err {worst:.3g} (atol {SERVE_ATOL}, rtol "
         f"{SERVE_RTOL}) ok; generated tokens off the program's argmax "
         f"within the tolerance: {len(ties)} (request, token) {ties}")

    # the card against the host engine over the same weights
    host = DecodeEngine(cfg, {n: t.cpu() for n, t in eng.params.items()},
                        max_slots=1, max_seq=DECODE_HOST_POSITIONS,
                        place=ptt.CPUPlace())
    toks = np.concatenate([prompts[picks[0]], gens[picks[0]]])[
        :DECODE_HOST_POSITIONS]
    err, ok = _within(forced[picks[0]][:DECODE_HOST_POSITIONS],
                      _teacher_forced(host, toks))
    if not ok:
        raise AssertionError(f"card vs host decode logits: max abs "
                             f"{err.max()}")
    _log("decode", f"card vs DecodeEngine(place=CPUPlace()), "
         f"{DECODE_HOST_POSITIONS} positions: max abs err {err.max():.3g} "
         f"ok")
    del host

    # the graph against the uncaptured step on the same inputs and pools:
    # every slot active, full page tables, random pool contents
    dev = eng.device
    S = DECODE_SLOTS
    for s in range(S):
        assert eng.reserve_slot(s, eng.max_pages)
    g = torch.Generator(device=dev).manual_seed(12)
    eng.cache.k.normal_(generator=g)
    eng.cache.v.normal_(generator=g)
    ids = rng.randint(1, cfg.vocab_size, S).astype(np.int32)
    pos = rng.randint(0, eng.max_seq - 2 * DECODE_UNCAPTURED_ITERS,
                      S).astype(np.int32)
    active = np.ones(S, bool)
    k0, v0 = eng.cache.k.clone(), eng.cache.v.clone()
    table = torch.as_tensor(eng.page_table, dtype=torch.long, device=dev)

    def eager(ids, pos):
        return eng.model.step_eager(
            eng.params, k0, v0, torch.as_tensor(ids, device=dev).long(),
            torch.as_tensor(pos, device=dev).long(), table,
            torch.as_tensor(active, device=dev)).cpu().numpy()

    lg = eng.run_iteration(ids, pos, active)
    le = eager(ids, pos)
    diffs = {"logits": float(np.abs(lg - le).max()),
             "k": float((eng.cache.k - k0)[:, 1:].abs().max()),
             "v": float((eng.cache.v - v0)[:, 1:].abs().max())}
    scale = {"logits": float(np.abs(le).max()),
             "k": float(k0.abs().max()), "v": float(v0.abs().max())}
    if any(d > 1e-6 * scale[n] for n, d in diffs.items()):
        raise AssertionError(f"graph vs uncaptured step: {diffs}")
    _log("decode", "graph vs the uncaptured step, same inputs and pools "
         "(8 slots active, full tables): " + (
             "logits and pools bit for bit" if not any(diffs.values()) else
             f"largest differences {diffs} (within 1e-6 of {scale})"))

    # what the graph buys: the same step replayed and run uncaptured, each
    # iteration ending with the logits on the host
    times = {}
    for name, fn in (("graph", lambda i, p: eng.run_iteration(i, p, active)),
                     ("uncaptured", eager)):
        fn(ids, pos)
        ms = []
        for it in range(DECODE_UNCAPTURED_ITERS):
            t1 = time.perf_counter()
            fn(ids, pos + it)
            ms.append((time.perf_counter() - t1) * 1e3)
        times[name] = ms
    med = {n: float(np.median(v)) for n, v in times.items()}
    _log("decode", f"{DECODE_UNCAPTURED_ITERS} iterations at occupancy "
         f"{S}, host clock: graph median {med['graph']:.4f} ms (p90 "
         f"{np.percentile(times['graph'], 90):.4f}), uncaptured median "
         f"{med['uncaptured']:.4f} ms (p90 "
         f"{np.percentile(times['uncaptured'], 90):.4f}): "
         f"{med['uncaptured'] / med['graph']:.2f}x")

    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        prof = {}
        for name, fn in (("graph",
                          lambda: eng.run_iteration(ids, pos, active)),
                         ("uncaptured", lambda: eager(ids, pos))):
            fn()
            torch.cuda.synchronize()
            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as pr:
                t1 = time.perf_counter()
                for _ in range(5):
                    fn()
                wall_ms = (time.perf_counter() - t1) * 1e3 / 5
            rows = _profile_rows(pr)
            copy_ms = sum(r[0] for r in rows if r[2].startswith("Memcpy"))
            kernel_ms = (sum(r[0] for r in rows) - copy_ms) / 5
            prof[name] = {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
                          "copy_ms": copy_ms / 5, "top": rows[:12]}
            _log("decode", f"profile, {name} step at occupancy {S}: wall "
                 f"{wall_ms:.4f} ms, kernels {kernel_ms:.4f} ms "
                 f"({100 * kernel_ms / wall_ms:.1f}% of wall), copies "
                 f"{copy_ms / 5:.4f} ms a step")
            for ms, count, key in rows[:8]:
                _log("decode", f"  {ms / 5:9.4f} ms  x{count // 5:<4d} "
                     f"{key[:90]}")
    for s in range(S):
        eng.release_slot(s)
    launched = _launches_nonzero()
    if launched:
        raise AssertionError(f"kernels launched on the decode path: "
                             f"{launched}")
    _log("decode", "no hand-written kernel launched across the phase")
    out = {"requests": DECODE_REQUESTS, "tokens": tokens, "wall_s": wall,
           "iterations": len(log), "tokens_per_s": tokens / wall,
           "iter_ms_occ8": {"median": float(it_med), "p90": float(it_p90),
                            "n": len(occ8)},
           "step_ms_occ8_median": float(np.median(step8)),
           "graph_vs_uncaptured_ms": med, "peak_bytes": peak,
           "held_bytes": held, "pool_bytes": pool, "ties": ties,
           "max_abs_err_program": worst, "graph_diffs": diffs,
           "trace_count": eng.trace_count, "profile": prof}
    del eng, srv, k0, v0, table
    torch.cuda.empty_cache()
    return out


def _train_program(cfg, seq, amp=False):
    """``build_gpt_pretrain`` with ``AdamOptimizer(1e-4)``, under
    ``amp.decorate`` (bench.py:424) when ``amp``."""
    from paddle_tpu_torch import amp as amp_mod
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.models import transformer as T
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss = T.build_gpt_pretrain(cfg, seq, fused_head=True,
                                          attn_impl="auto", dropout=0.0)
        adam = optimizer.AdamOptimizer(learning_rate=1e-4)
        (amp_mod.decorate(adam) if amp else adam).minimize(loss)
    return main, startup, loss


def _train_feed(cfg, batch, seq, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.vocab_size, (batch, seq)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = 0
    return {"src_ids": ids, "lm_label": labels}


def phase_train():
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import flash_attention as fa

    cfg = _gpt_cfg()
    seq = cfg.max_pos
    main, startup, loss = _train_program(cfg, seq)
    types = [op.type for op in main.global_block().ops]
    n_flash = types.count("flash_attention")
    assert n_flash == types.count("flash_attention_grad") == cfg.n_layer, \
        (n_flash, types.count("flash_attention_grad"))
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=1234)
    n_params = sum(int(scope.find_var(p.name).numel())
                   for p in main.all_parameters())
    _log("train", f"GPT causal LM pretraining program: {len(types)} ops "
         f"({n_flash} flash_attention, {types.count('adam')} adam), "
         f"{n_params / 1e6:.1f} M parameters, Adam state on {exe.device}")
    feed = _train_feed(cfg, TRAIN_BATCH, seq)
    tokens = TRAIN_BATCH * seq

    # the main path, counted: a warm-up step and the timed steps
    fa.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # earlier phases' and the weights
    t_w = time.perf_counter()
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0])]
    warm_s = time.perf_counter() - t_w
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(out))
    launches = {k: fa.launch_count(k)
                for k in ("flash_attn_fwd", "flash_attn_bwd")}
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_STEPS + 1
    for k, n in launches.items():
        if n != cfg.n_layer * steps:
            raise AssertionError(f"{k} launched {n} times in {steps} "
                                 f"training steps, expected "
                                 f"{cfg.n_layer} per step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    step_ms = 1e3 * float(np.mean(step_s))
    _log("train", f"batch {TRAIN_BATCH} x seq {seq}: warm-up step "
         f"{warm_s:.2f} s, then {TRAIN_STEPS} steps of "
         f"{', '.join(f'{1e3 * x:.1f}' for x in step_s)} ms; losses "
         f"{', '.join(f'{x:.4f}' for x in losses)}; flash launches "
         f"{launches} = {cfg.n_layer} x {steps} steps each; peak memory "
         f"{peak / 2**30:.2f} GiB, of which {held / 2**30:.2f} GiB allocated "
         f"before the first step")

    _small_train_check("train", exe)
    return {"launches": launches, "losses": losses, "step_ms": step_ms,
            "step_s": step_s, "warmup_s": warm_s,
            "tokens_per_s": tokens / (step_ms / 1e3),
            "peak_bytes": peak, "held_bytes": held, "tokens": tokens,
            "main": main, "exe": exe,
            "loss": loss, "scope": scope, "feed": feed}


def _dp_program(cfg, seq, make_opt, transpiler=None):
    """``_train_program``'s GPT under names of its own, minimized by
    ``make_opt()`` and, given a transpiler, transpiled for DP_RANKS
    endpoints (rank 0)."""
    from paddle_tpu_torch.framework import (Program, program_guard,
                                            unique_name)
    from paddle_tpu_torch.models import transformer as T
    with unique_name.guard():
        main, startup = Program(), Program()
        with program_guard(main, startup):
            _, _, loss = T.build_gpt_pretrain(cfg, seq, fused_head=True,
                                              attn_impl="auto", dropout=0.0)
            make_opt().minimize(loss)
            if transpiler is not None:
                eps = ",".join(f"127.0.0.1:{6170 + i}"
                               for i in range(DP_RANKS))
                transpiler.transpile(startup_program=startup,
                                     main_program=main, rank=0,
                                     endpoints=eps,
                                     current_endpoint=eps.split(",")[0])
    return main, startup, loss


def _weights_digest(scope, main):
    """Each parameter's float64 sum: two startups at one seed agree."""
    return {p.name: float(scope.find_var(p.name).double().sum())
            for p in main.all_parameters()}


def _dp_steps(exe, main, loss, scope, feed, steps):
    """``steps`` steps on one batch, each ending in a synchronize: the
    losses (one per rank in collective mode), the seconds of each step,
    the peak memory and what was allocated before the first step."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(np.asarray(out, np.float64).reshape(-1))
    return losses, step_s, torch.cuda.max_memory_allocated(), held


def _one_device_run(cfg, seq, feed, steps):
    """``_dp_program``'s GPT with Adam(1e-4) on one device from startup
    seed 1234: the losses, step seconds, peak and held bytes, the startup's
    weights digest and the final parameters on the host."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Scope
    main, start, loss = _dp_program(
        cfg, seq, lambda: optimizer.AdamOptimizer(learning_rate=1e-4))
    sc, exe = Scope(), ptt.Executor()
    exe.run(start, scope=sc, seed=1234)
    w0 = _weights_digest(sc, main)
    one, one_s, peak, held = _dp_steps(exe, main, loss, sc, feed, steps)
    params = {p: sc.find_var(p).detach().cpu() for p in w0}
    del sc, exe
    torch.cuda.empty_cache()
    return one, one_s, peak, held, w0, params


def _dp_losses_match(phase, want, got, rtol=DP_LOSS_RTOL):
    """Each step's mean over the ranks' losses against the reference run's
    (its mean over ranks too) within ``rtol``; the worst ratio."""
    worst = 0.0
    for step, (w, g) in enumerate(zip(want, got)):
        g, w = np.asarray(g), np.asarray(w)
        rel = abs(g.mean() - w.mean()) / abs(w.mean())
        if not (np.isfinite(g).all() and rel <= rtol):
            raise AssertionError(f"{phase}: step {step} losses {g} against "
                                 f"{w} (relative {rel:.3g}, limit {rtol})")
        worst = max(worst, rel)
    return worst


def phase_dp_train(smi, train):
    """Collective data parallelism at full width: ``train``'s GPT and batch
    (8 x 2048) over a ``dp`` mesh of DP_RANKS virtual ranks on this card.
    (a) ``GradAllReduce`` + Adam against the untranspiled program on one
    device from the same startup seed; (b) ``DGCGradAllReduce`` +
    ``DGCMomentumOptimizer`` against ``GradAllReduce`` + Momentum."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import monitor, optimizer
    from paddle_tpu_torch.analysis import comms
    from paddle_tpu_torch.distributed import GradAllReduce
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import (DGCGradAllReduce, make_mesh,
                                           set_mesh)
    from paddle_tpu_torch.parallel.dgc import topk_count

    t_phase = time.perf_counter()
    cfg = _gpt_cfg()
    seq = cfg.max_pos
    feed = train["feed"]
    steps = DP_STEPS + 1
    kernels = ("flash_attn_fwd", "flash_attn_bwd")

    def adam():
        return optimizer.AdamOptimizer(learning_rate=1e-4)

    # (a) one device, the untranspiled program, the same global batch
    one, one_s, one_peak, one_held, w0, one_params = _one_device_run(
        cfg, seq, feed, steps)
    n_params = sum(int(v.numel()) for v in one_params.values())

    set_mesh(make_mesh({"dp": DP_RANKS}, [torch.device("cuda", 0)]
                       * DP_RANKS))
    try:
        main4, start4, loss4 = _dp_program(cfg, seq, adam, GradAllReduce())
        sc4, exe4 = Scope(), ptt.Executor()
        exe4.run(start4, scope=sc4, seed=1234)
        if _weights_digest(sc4, main4) != w0:
            raise AssertionError("dp_train: the dp startup's weights differ "
                                 "from the single-device run's")
        exe4.verify_replicas = True
        cplan = comms.plan_comms(main4, [loss4.name],
                                 batch_size=TRAIN_BATCH, nranks=DP_RANKS)
        bytes0 = monitor.counter_totals().get(
            "paddle_tpu_collective_bytes_total", 0)
        fa.reset_launch_count()
        dp, dp_s, dp_peak, dp_held = _dp_steps(exe4, main4, loss4, sc4, feed,
                                               steps)
        launches = {k: fa.launch_count(k) for k in kernels}
        moved = monitor.counter_totals()[
            "paddle_tpu_collective_bytes_total"] - bytes0
        replicas = dict(exe4.replica_report)
        if not comms.MONITOR.drain(60):
            raise AssertionError("dp_train: the comms monitor did not drain")
        comm_ms = comms.COMM_STEP_MS_GAUGE.value()
        comm_wait = comms.COMM_WAIT_MS_GAUGE.value()
        bus_bw = comms.COMM_BW_GAUGE.value()
        digest = monitor.metrics_digest()
        del sc4, exe4
        torch.cuda.empty_cache()

        worst = _dp_losses_match("dp_train", one, dp)
        if any(l.shape != (DP_RANKS,) for l in dp):
            raise AssertionError(f"dp_train: stacked losses {dp}")
        want = cfg.n_layer * DP_RANKS * steps
        if launches != {k: want for k in kernels}:
            raise AssertionError(f"dp_train: K1/K2 launched {launches}, "
                                 f"expected {want} each")
        if cplan.payload_bytes != 4 * n_params or \
                moved != cplan.payload_bytes * steps:
            raise AssertionError(
                f"dp_train: {moved} collective bytes over {steps} steps, "
                f"plan {cplan.payload_bytes} a step, {n_params} params")
        if replicas["mismatched"] or replicas["ranks"] != DP_RANKS:
            raise AssertionError(f"dp_train: replicas {replicas}")
        if not (comm_ms > 0 and comm_wait == 0 and
                {"comm_ms", "comm_wait", "comm_bw"} <= set(digest)):
            raise AssertionError(f"dp_train: comms plane comm_ms {comm_ms},"
                                 f" wait {comm_wait}, digest {digest}")
        if not dp_peak < one_peak:
            raise AssertionError(f"dp_train: dp-{DP_RANKS} peak {dp_peak} "
                                 f"not below one device's {one_peak}")
        one_ms = 1e3 * float(np.mean(one_s[1:]))
        dp_ms = 1e3 * float(np.mean(dp_s[1:]))
        gib = 2.0 ** 30
        _log("dp_train", f"(a) GradAllReduce + Adam over dp {DP_RANKS} "
             f"virtual ranks on cuda:0, batch {TRAIN_BATCH} x {seq} ("
             f"{TRAIN_BATCH // DP_RANKS} sequences a rank), 1 + {DP_STEPS} "
             f"steps: losses {[round(float(l.mean()), 6) for l in dp]} "
             f"(mean over ranks) against one device's "
             f"{[round(float(l.mean()), 6) for l in one]}, worst relative "
             f"{worst:.3g} (limit {DP_LOSS_RTOL}); last step per rank "
             f"{[round(float(x), 6) for x in dp[-1]]}")
        _log("dp_train", f"replicas: {replicas['tensors']} trainable "
             f"tensors compared bit for bit over {DP_RANKS} ranks every "
             f"step, 0 differ; K1/K2 {launches} = {cfg.n_layer} x "
             f"{DP_RANKS} x {steps}; collective bytes {moved} = plan "
             f"{cplan.payload_bytes} ({cplan.payload_bytes / 1e9:.4f} GB, "
             f"{n_params} params x 4 B, {len(cplan.collectives)} "
             f"allreduces) x {steps}; wire {cplan.wire_bytes} B a step")
        _log("dp_train", f"step {dp_ms:.1f} ms (timed steps "
             f"{', '.join(f'{1e3 * x:.1f}' for x in dp_s[1:])}; warm-up "
             f"{dp_s[0]:.2f} s) against one device's {one_ms:.1f} ms "
             f"({', '.join(f'{1e3 * x:.1f}' for x in one_s[1:])}; warm-up "
             f"{one_s[0]:.2f} s), replica check included; collective "
             f"segment (CUDA events from the first allreduce to the last) "
             f"{comm_ms:.2f} ms median, wait {comm_wait} ms, bus_bw "
             f"{bus_bw:.4f} of {cplan.link_bw / 1e9:.0f} GB/s (HBM, not a "
             f"link: virtual ranks); on {smi}")
        _log("dp_train", f"peak memory {dp_peak / gib:.3f} GiB "
             f"({(dp_peak - dp_held) / gib:.3f} above the {dp_held / gib:.3f}"
             f" held) against one device's {one_peak / gib:.3f} "
             f"({(one_peak - one_held) / gib:.3f} above); the per-rank "
             f"gradients of ranks 1-{DP_RANKS - 1} hold "
             f"{(DP_RANKS - 1) * cplan.payload_bytes / gib:.3f} GiB more")

        # (b) DGC: its dense first step against Momentum + GradAllReduce
        def momentum():
            return optimizer.MomentumOptimizer(DGC_LR, 0.9)

        mainm, startm, lossm = _dp_program(cfg, seq, momentum,
                                           GradAllReduce())
        scm, exem = Scope(), ptt.Executor()
        exem.run(startm, scope=scm, seed=1234)
        mom, _, _, _ = _dp_steps(exem, mainm, lossm, scm, feed, 2)
        del scm, exem
        torch.cuda.empty_cache()

        def dgc():
            return optimizer.DGCMomentumOptimizer(
                DGC_LR, 0.9, rampup_begin_step=1, sparsity=[DGC_SPARSITY])

        maind, startd, lossd = _dp_program(cfg, seq, dgc, DGCGradAllReduce())
        scd, exed = Scope(), ptt.Executor()
        exed.run(startd, scope=scd, seed=1234)
        fa.reset_launch_count()
        ld, ld_s, ld_peak, _ = _dp_steps(exed, maind, lossd, scd, feed,
                                         DGC_STEPS)
        dgc_launches = {k: fa.launch_count(k) for k in kernels}
        worst_d = _dp_losses_match("dp_train (b)", mom, ld[:2])
        uv = [n for n in scd.local_var_names()
              if n.endswith(("@DGC_U", "@DGC_V"))]
        bad = [n for n in uv if not bool(torch.isfinite(
            scd.find_var(n)).all())]
        if bad or not uv or not all(np.isfinite(l).all() for l in ld):
            raise AssertionError(f"dp_train (b): losses {ld}, non-finite "
                                 f"U/V {bad[:4]} of {len(uv)}")
        want = cfg.n_layer * DP_RANKS * DGC_STEPS
        if dgc_launches != {k: want for k in kernels}:
            raise AssertionError(f"dp_train (b): K1/K2 launched "
                                 f"{dgc_launches}, expected {want} each")
        dgc_ops = [op for op in maind.global_block().ops
                   if op.type == "dgc_allreduce"]
        numels = [int(maind.global_block().var(op.input("U")[0]).shape[0])
                  for op in dgc_ops]
        sparse_b = sum(DP_RANKS * topk_count(n, DGC_SPARSITY) * (8 + 4)
                       for n in numels)
        dense_b = 4 * sum(numels)
        del scd, exed
        torch.cuda.empty_cache()
        _log("dp_train", f"(b) DGCGradAllReduce + DGCMomentumOptimizer("
             f"{DGC_LR}, 0.9, rampup_begin_step=1, sparsity="
             f"[{DGC_SPARSITY}]), {len(dgc_ops)} dgc_allreduce ops: losses "
             f"{[round(float(l.mean()), 6) for l in ld]}; steps 1-2 against"
             f" Momentum + GradAllReduce's {[round(float(l.mean()), 6) for l in mom]}"
             f" (worst relative {worst_d:.3g}; step 2 follows the dense "
             f"update); steps 2-{DGC_STEPS} sparse, {len(uv)} U/V tensors "
             f"finite; steps {', '.join(f'{1e3 * x:.1f}' for x in ld_s)} "
             f"ms, peak {ld_peak / gib:.3f} GiB; allgathered (int64 index, "
             f"float32 value) pairs {sparse_b} B a step over {DP_RANKS} "
             f"ranks against the dense allreduce's {dense_b} B; K1/K2 "
             f"{dgc_launches}")
    finally:
        set_mesh(None)
    wall = time.perf_counter() - t_phase
    _log("dp_train", f"phase wall time {wall:.1f} s")
    return {"launches": launches, "dgc_launches": dgc_launches,
            "losses": [l.tolist() for l in dp],
            "single_losses": [l.tolist() for l in one],
            "worst_rel": worst, "step_ms": dp_ms, "single_step_ms": one_ms,
            "step_s": dp_s, "single_step_s": one_s,
            "comm_step_ms": comm_ms, "comm_wait_ms": comm_wait,
            "bus_bw": bus_bw, "payload_bytes": cplan.payload_bytes,
            "wire_bytes": cplan.wire_bytes, "collective_bytes": moved,
            "replica_tensors": replicas["tensors"], "peak_bytes": dp_peak,
            "held_bytes": dp_held, "single_peak_bytes": one_peak,
            "single_held_bytes": one_held, "single_params": one_params,
            "feed": feed,
            "weights_digest": w0,
            "dgc": {"losses": [l.tolist() for l in ld],
                    "momentum_losses": [l.tolist() for l in mom],
                    "worst_rel": worst_d, "step_s": ld_s,
                    "peak_bytes": ld_peak, "sparse_bytes": sparse_b,
                    "dense_bytes": dense_b, "ops": len(dgc_ops)},
            "wall_s": wall}


def phase_gspmd_train(smi, dp_train):
    """GSPMD at full width (module docstring): ``train``'s GPT and batch
    under ``with_gspmd(GSPMD_AXES, GSPMD_RULES, zero_stage=1)`` over four
    virtual ranks on this card, against ``dp_train``'s single-device run
    of the same program, seed, feed and steps."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import monitor, optimizer
    from paddle_tpu_torch.analysis.sharding import plan_sharding
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.hbm import per_device_nbytes
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import (ShardedValue, choose_rules,
                                           make_topology_mesh)

    t_phase = time.perf_counter()
    cfg = _gpt_cfg()
    seq = cfg.max_pos
    steps = DP_STEPS + 1
    kernels = ("flash_attn_fwd", "flash_attn_bwd")
    gib = 2.0 ** 30
    n = int(np.prod(list(GSPMD_AXES.values())))

    def adam():
        return optimizer.AdamOptimizer(learning_rate=1e-4)

    main, startup, loss = _dp_program(cfg, seq, adam)
    t0 = time.perf_counter()
    _, report = choose_rules(main, GSPMD_AXES, fetch_names=[loss.name],
                             batch_size=TRAIN_BATCH, budget_mb=0)
    choose_s = time.perf_counter() - t0
    for r in report:
        _log("gspmd_train", f"choose_rules {r['rules']}: per-shard peak "
             f"{r['per_shard_peak_bytes'] / 1e9:.2f} GB, steady "
             f"{r['per_shard_steady_bytes'] / 1e9:.2f} GB, "
             f"{r['sharded_params']} sharded vars, {r['reshard_edges']} "
             f"reshard edges, {r['reshard_bytes'] / 1e9:.3f} GB payload a "
             f"step, est comm {r['est_comm_ms']:.2f} ms vs compute "
             f"{r['est_compute_ms']:.2f} ms ({r['bound']}-bound)")
    per_shard = {r["rules"]: r["per_shard_peak_bytes"] for r in report}
    sc, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=sc, seed=1234)
    if _weights_digest(sc, main) != dp_train["weights_digest"]:
        raise AssertionError("gspmd_train: the startup's weights differ "
                             "from the single-device run's")
    mesh = make_topology_mesh(GSPMD_AXES, [torch.device("cuda", 0)] * n)
    compiled = ptt.CompiledProgram(main).with_gspmd(
        mesh=mesh, rules=GSPMD_RULES, zero_stage=1)
    stamp = main._attrs["partition"]
    bytes0 = monitor.counter_totals().get(
        "paddle_tpu_collective_bytes_total", 0)
    fa.reset_launch_count()
    losses, step_s, peak, held = _dp_steps(
        exe, compiled, loss, sc, dp_train["feed"], steps)
    launches = {k: fa.launch_count(k) for k in kernels}
    moved = monitor.counter_totals()[
        "paddle_tpu_collective_bytes_total"] - bytes0
    plan = plan_sharding(main, [loss.name], batch_size=TRAIN_BATCH)
    layout = next(p.spmd for p in exe._plans.values() if p.spmd)
    n_flash = [op.type for op in layout.program.global_block().ops].count(
        "flash_attention")
    one = [np.asarray(l) for l in dp_train["single_losses"]]
    worst = _dp_losses_match("gspmd_train", one, losses)
    want = n_flash * n * steps
    if launches != {k: want for k in kernels}:
        raise AssertionError(f"gspmd_train: K1/K2 launched {launches}, the "
                             f"lowered program implies {n_flash} x {n} x "
                             f"{steps} = {want} each")
    if moved != steps * plan.payload_bytes or plan.unexplained:
        raise AssertionError(
            f"gspmd_train: {moved} collective bytes over {steps} steps, "
            f"plan {plan.payload_bytes} a step ({len(plan.unexplained)} "
            "unexplained edges)")
    moment = next((n_, sc.find_var(n_)) for n_ in sc.local_var_names()
                  if n_.startswith("enc_0.ffn.fc1.w_moment1"))
    mv = moment[1]
    if not (isinstance(mv, ShardedValue) and mv.spec[0] == "dp" and
            per_device_nbytes(mv) == mv.nbytes // n):
        raise AssertionError(f"gspmd_train: {moment[0]} is {mv!r}")
    diffs = {}
    for p, want_t in dp_train["single_params"].items():
        v = sc.find_var(p)
        got = v.to_global() if isinstance(v, ShardedValue) else v
        diffs[p] = float((got.detach().cpu() - want_t).abs().max())
    worst_p = max(diffs, key=diffs.get)
    plan4 = n * per_shard[stamp["rules"]]
    if not peak - held <= plan4:
        raise AssertionError(f"gspmd_train: peak {peak - held} B above held"
                             f" exceeds {n} x the per-shard static plan "
                             f"({plan4} B)")
    if not diffs[worst_p] <= GSPMD_PARAM_ATOL:
        raise AssertionError(f"gspmd_train: parameter {worst_p} differs "
                             f"by {diffs[worst_p]:.3g} from the single-"
                             f"device run's (limit {GSPMD_PARAM_ATOL})")
    edges = {}
    for e in plan.edges:
        k = (e.kind, e.reason, e.direction)
        c, b = edges.get(k, (0, 0))
        edges[k] = (c + 1, b + e.payload_bytes)
    step_ms = 1e3 * float(np.mean(step_s[1:]))
    one_ms = dp_train["single_step_ms"]
    one_above = dp_train["single_peak_bytes"] - \
        dp_train["single_held_bytes"]
    sharded = sum(isinstance(sc.find_var(v), ShardedValue)
                  for v in sc.local_var_names())
    _log("gspmd_train", f"with_gspmd(axes={GSPMD_AXES}, rules="
         f"{GSPMD_RULES!r}, zero_stage=1) over {n} virtual ranks on "
         f"cuda:0: {len(stamp['params'])} sharded parameters, "
         f"{len(plan.edges)} reshard edges (0 unexplained), "
         f"{plan.payload_bytes / 1e9:.3f} GB payload a step, the lowered "
         f"program {len(layout.program.global_block().ops)} ops, "
         f"{layout.n_collectives} collectives; choose_rules "
         f"{choose_s:.1f} s")
    for k, (c, b) in sorted(edges.items()):
        _log("gspmd_train", f"  {k[0]:<14} {k[1]:<12} {k[2]}: {c} edges, "
             f"{b / 1e6:.1f} MB")
    _log("gspmd_train", f"losses {[round(float(l.mean()), 6) for l in losses]}"
         f" against one device's {[round(float(l.mean()), 6) for l in one]}"
         f", worst relative {worst:.3g} (limit {DP_LOSS_RTOL}); gathered "
         f"parameters after {steps} steps within {diffs[worst_p]:.3g} "
         f"({worst_p}; limit {GSPMD_PARAM_ATOL:.1e}), median "
         f"{float(np.median(list(diffs.values()))):.3g}; K1/K2 {launches} "
         f"= {n_flash} x {n} ranks x {steps} steps; collective bytes "
         f"{moved} = plan x {steps}; {sharded} ShardedValues in the scope, "
         f"{moment[0]} {mv.spec} holds {per_device_nbytes(mv)} B a rank "
         f"of {mv.nbytes}")
    _log("gspmd_train", f"step {step_ms:.1f} ms (timed steps "
         f"{', '.join(f'{1e3 * x:.1f}' for x in step_s[1:])}; warm-up "
         f"{step_s[0]:.2f} s, the lowering included) against one device's "
         f"{one_ms:.1f} ms; peak {(peak - held) / gib:.3f} GiB above the "
         f"{held / gib:.3f} held, against one device's {one_above / gib:.3f}"
         f" and {n} x the per-shard static plan's {plan4 / gib:.3f}; on "
         f"{smi}")
    del sc, exe, compiled
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    _log("gspmd_train", f"phase wall time {wall:.1f} s")
    return {"launches": launches, "losses": [l.tolist() for l in losses],
            "worst_rel": worst, "param_max_diff": diffs[worst_p],
            "param_worst": worst_p, "step_ms": step_ms, "step_s": step_s,
            "single_step_ms": one_ms, "peak_bytes": peak,
            "held_bytes": held, "single_above_bytes": one_above,
            "per_shard_plan_bytes": per_shard, "collective_bytes": moved,
            "payload_bytes": plan.payload_bytes,
            "wire_bytes": plan.wire_bytes, "edges": len(plan.edges),
            "edge_kinds": {"/".join(k): v for k, v in edges.items()},
            "report": report, "choose_rules_s": choose_s,
            "lowered_ops": len(layout.program.global_block().ops),
            "collectives": layout.n_collectives, "wall_s": wall}


def _card():
    """The card the virtual ranks of pipe_train and moe_train share."""
    import torch
    return torch.device("cuda", 0)


def _pipe_program(cfg, seq, cuts, microbatches):
    """``_dp_program``'s GPT (the same names, so the same startup weights),
    split at the layer outputs ``cuts`` by ``PipelineOptimizer(Adam(1e-4))``
    with ``microbatches`` microbatches; returns the program, its startup and
    the pipeline optimizer."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import (Program, program_guard,
                                            unique_name)
    from paddle_tpu_torch.models import transformer as T
    with unique_name.guard():
        main, startup = Program(), Program()
        with program_guard(main, startup):
            cps = []
            _, _, loss = T.build_gpt_pretrain(cfg, seq, fused_head=True,
                                              attn_impl="auto", dropout=0.0,
                                              checkpoints=cps)
            pipe = optimizer.PipelineOptimizer(
                optimizer.AdamOptimizer(learning_rate=1e-4),
                cut_list=[cps[i] for i in cuts],
                num_microbatches=microbatches)
            pipe.minimize(loss)
    return main, startup, pipe


def _pipe_steps(eng, feed, steps):
    """``steps`` engine steps on one batch: the losses, each step's seconds
    (host clock, ending in a synchronize) and its forward wave, backward
    wave and apply seconds (each phase ending in a synchronize), the peak
    memory and what was held before the first step."""
    import torch
    split = {"forward": [], "backward": [], "apply": []}

    def timed(key, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            split[key].append(time.perf_counter() - t0)
            return out
        return run
    eng._forward_wave = timed("forward", eng._forward_wave)
    eng._backward_wave = timed("backward", eng._backward_wave)
    eng._apply = timed("apply", eng._apply)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(eng.train_step(feed))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return losses, step_s, split, torch.cuda.max_memory_allocated(), held


def phase_pipe_train(smi, dp_train):
    """Pipeline parallelism at full width (module docstring): ``train``'s
    GPT cut into four stages on ``[cuda:0] * 4`` (a), and into two stages
    each on ``[cuda:0, cuda:0]`` (b), against ``dp_train``'s single-device
    run of the same startup seed and feed."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    cfg = _gpt_cfg()
    seq = cfg.max_pos
    feed = dp_train["feed"]
    one = [np.asarray(l) for l in dp_train["single_losses"]]
    gib = 2.0 ** 30
    cuda0 = _card()
    out = {}
    for case, cuts, devices, steps in (
            ("a", PIPE_CUTS, [cuda0] * (len(PIPE_CUTS) + 1), DP_STEPS + 1),
            ("b", PIPE_CUTS_B, [[cuda0, cuda0]] * (len(PIPE_CUTS_B) + 1),
             PIPE_STEPS_B)):
        main, startup, pipe = _pipe_program(cfg, seq, cuts,
                                            PIPE_MICROBATCHES)
        sc = Scope()
        ptt.Executor().run(startup, scope=sc, seed=1234)
        if _weights_digest(sc, main) != dp_train["weights_digest"]:
            raise AssertionError(f"pipe_train ({case}): the startup's "
                                 "weights differ from the single-device "
                                 "run's")
        eng = pipe.create_engine(devices=devices, scope=sc)
        for sec in pipe.sections:
            _log("pipe_train", f"({case}) stage {sec.idx} on "
                 f"{devices[sec.idx]}: "
                 f"{len(sec.program.global_block().ops)} ops, "
                 f"{len(sec.param_names)} parameters, in {sec.in_names}, "
                 f"feeds {sec.feed_names}, out {sec.out_names}")
        _reset_launches()
        losses, step_s, split, peak, held = _pipe_steps(eng, feed, steps)
        launches = _launches_nonzero()
        ranks = len(devices[0]) if isinstance(devices[0], list) else 1
        per_step = cfg.n_layer * PIPE_MICROBATCHES * ranks
        want = {"flash_attn_fwd": 2 * per_step * steps,
                "flash_attn_bwd": per_step * steps}
        if launches != want:
            raise AssertionError(
                f"pipe_train ({case}): launches {launches}, expected "
                f"{want}: {cfg.n_layer} layers x {PIPE_MICROBATCHES} "
                f"microbatches x {ranks} rank(s) x {steps} steps, K1 in the "
                "forward wave and again in the recompute")
        if case == "a":
            worst = _dp_losses_match("pipe_train (a)", one,
                                     [[l] for l in losses])
            eng.sync_to_scope()
            diffs = {p: float((sc.find_var(p).detach().cpu() - w)
                              .abs().max())
                     for p, w in dp_train["single_params"].items()}
            worst_p = max(diffs, key=diffs.get)
            if not diffs[worst_p] <= GSPMD_PARAM_ATOL:
                raise AssertionError(
                    f"pipe_train (a): parameter {worst_p} differs by "
                    f"{diffs[worst_p]:.3g} from the single-device run's "
                    f"(limit {GSPMD_PARAM_ATOL})")
            ref_name = "one device"
        else:
            a = out["a"]["losses"]
            worst = _dp_losses_match("pipe_train (b)",
                                     [[x] for x in a[:steps]],
                                     [[l] for l in losses])
            diffs, worst_p, ref_name = None, None, "(a)"
        step_ms = 1e3 * float(np.mean(step_s[1:]))
        split_ms = {k: 1e3 * float(np.mean(v[1:])) for k, v in split.items()}
        _log("pipe_train", f"({case}) PipelineOptimizer(Adam(1e-4), "
             f"{len(cuts) + 1} stages, num_microbatches="
             f"{PIPE_MICROBATCHES}), batch {TRAIN_BATCH} x {seq}, 1 + "
             f"{steps - 1} steps: losses {[round(l, 6) for l in losses]} "
             f"against {ref_name}'s "
             f"{[round(float(np.mean(l)), 6) for l in (one if case == 'a' else [[x] for x in out['a']['losses']])][:steps]}"
             f", worst relative {worst:.3g} (limit {DP_LOSS_RTOL})"
             + (f"; parameters after the last step within "
                f"{diffs[worst_p]:.3g} ({worst_p}; limit "
                f"{GSPMD_PARAM_ATOL:.1e}), median "
                f"{float(np.median(list(diffs.values()))):.3g}"
                if diffs else ""))
        _log("pipe_train", f"({case}) step {step_ms:.1f} ms (timed steps "
             f"{', '.join(f'{1e3 * x:.1f}' for x in step_s[1:])}; warm-up "
             f"{step_s[0]:.2f} s): forward wave {split_ms['forward']:.1f} "
             f"ms, backward wave {split_ms['backward']:.1f} ms, apply "
             f"{split_ms['apply']:.1f} ms (each ending in a synchronize), "
             f"against one device's {dp_train['single_step_ms']:.1f} ms; "
             f"peak {(peak - held) / gib:.3f} GiB above the "
             f"{held / gib:.3f} held, one device's "
             f"{(dp_train['single_peak_bytes'] - dp_train['single_held_bytes']) / gib:.3f}"
             f"; K1/K2 {launches}; on {smi}")
        out[case] = {"launches": launches, "losses": losses,
                     "worst_rel": worst, "step_ms": step_ms,
                     "step_s": step_s, "split_ms": split_ms,
                     "peak_bytes": peak, "held_bytes": held,
                     "param_max_diff": diffs[worst_p] if diffs else None,
                     "param_worst": worst_p,
                     "sections": [{"ops": len(s.program.global_block().ops),
                                   "in": s.in_names, "out": s.out_names}
                                  for s in pipe.sections]}
        del eng, sc, pipe, main, startup
        torch.cuda.empty_cache()
    fa.reset_launch_count()
    wall = time.perf_counter() - t_phase
    _log("pipe_train", f"phase wall time {wall:.1f} s")
    out["wall_s"] = wall
    return out


def _moe_program(seq, d):
    """``switch_moe_ffn`` at width ``d`` (``MOE_EXPERTS`` experts,
    ``MOE_INNER`` inner, capacity ``MOE_CF``, relu) under
    ``mean((out - y)^2) + 0.1 aux`` (the reference's
    ``tests/test_moe.py:99-122``) and Adam(``MOE_LR``)."""
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.framework import (Program, program_guard,
                                            unique_name)
    with unique_name.guard():
        main, startup = Program(), Program()
        with program_guard(main, startup):
            x = layers.data("x", shape=[seq, d], dtype="float32")
            y = layers.data("y", shape=[seq, d], dtype="float32")
            out, aux = layers.switch_moe_ffn(
                x, num_experts=MOE_EXPERTS, d_inner=MOE_INNER,
                capacity_factor=MOE_CF, act="relu")
            loss = layers.mean((out - y) * (out - y)) + 0.1 * aux
            optimizer.AdamOptimizer(learning_rate=MOE_LR).minimize(loss)
    return main, startup, loss


def phase_moe_train(smi):
    """Mixture of experts at the GPT's width (module docstring): one device
    (a) against ``with_distributed(axes=MOE_AXES)`` over ``[cuda:0] * 4``
    (b)."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.hbm import per_device_nbytes
    from paddle_tpu_torch.parallel import ShardedValue

    t_phase = time.perf_counter()
    cfg = _gpt_cfg()
    seq, d = cfg.max_pos, cfg.d_model
    rng = np.random.RandomState(7)
    feed = {"x": rng.randn(TRAIN_BATCH, seq, d).astype(np.float32),
            "y": rng.randn(TRAIN_BATCH, seq, d).astype(np.float32)}
    steps = DP_STEPS + 1
    gib = 2.0 ** 30
    n = int(np.prod(list(MOE_AXES.values())))
    _reset_launches()
    runs = {}
    for case in ("a", "b"):
        main, startup, loss = _moe_program(seq, d)
        sc, exe = Scope(), ptt.Executor()
        exe.run(startup, scope=sc, seed=4321)
        digest = _weights_digest(sc, main)
        prog = main if case == "a" else ptt.CompiledProgram(main) \
            .with_distributed(axes=MOE_AXES, devices=[_card()] * n)
        bytes0 = monitor.counter_totals().get(
            "paddle_tpu_collective_bytes_total", 0)
        losses, step_s, peak, held = _dp_steps(exe, prog, loss, sc, feed,
                                               steps)
        moved = monitor.counter_totals().get(
            "paddle_tpu_collective_bytes_total", 0) - bytes0
        runs[case] = {"losses": [float(l.mean()) for l in losses],
                      "step_s": step_s, "peak": peak, "held": held,
                      "digest": digest, "moved": moved}
        if case == "b":
            layout = next(p.spmd for p in exe._plans.values() if p.spmd)
            plan = layout.plan
            state = {}
            for name in sc.local_var_names():
                v = sc.find_var(name)
                if isinstance(v, ShardedValue):
                    state[name] = (per_device_nbytes(v), v.nbytes, v.spec)
        del sc, exe, prog
        torch.cuda.empty_cache()
    a, b = runs["a"], runs["b"]
    if a["digest"] != b["digest"]:
        raise AssertionError("moe_train: the two startups' weights differ")
    rel = [abs(x - y) / abs(x) for x, y in zip(a["losses"], b["losses"])]
    if not (all(np.isfinite(a["losses"] + b["losses"])) and
            max(rel) <= MOE_LOSS_RTOL):
        raise AssertionError(f"moe_train: ep losses {b['losses']} against "
                             f"one device's {a['losses']} (worst relative "
                             f"{max(rel):.3g}, limit {MOE_LOSS_RTOL})")
    if not (a["losses"][-1] < a["losses"][0] and
            b["losses"][-1] < b["losses"][0]):
        raise AssertionError(f"moe_train: the loss does not fall: "
                             f"{a['losses']}, {b['losses']}")
    if b["moved"] != steps * plan.payload_bytes or plan.unexplained:
        raise AssertionError(f"moe_train: {b['moved']} collective bytes "
                             f"over {steps} steps, plan "
                             f"{plan.payload_bytes} a step")
    experts = {k: v for k, v in state.items() if v[2][0] == "ep"}
    if len(experts) != 12 or any(loc * 2 != whole for loc, whole, _ in
                                 experts.values()):
        raise AssertionError(f"moe_train: the expert-split state {experts}")
    launches = _launches_nonzero()
    if launches:
        raise AssertionError(f"moe_train: kernels launched {launches}; "
                             "no kernel runs on this path")
    a2a = [e for e in plan.edges if e.collective_op == "c_alltoall"]
    kinds = {}
    for e in plan.edges:
        k = (e.collective_op, e.mesh_axis, e.reason, e.direction)
        c, nb = kinds.get(k, (0, 0))
        kinds[k] = (c + 1, nb + e.payload_bytes)
    for k, (c, nb) in sorted(kinds.items()):
        _log("moe_train", f"  {k[0]:<16} over {k[1]:<3} {k[2]:<11} {k[3]}: "
             f"{c} edge(s), {nb} B a step")
    ms = {c: 1e3 * float(np.mean(r["step_s"][1:])) for c, r in runs.items()}
    loc = sum(v[0] for v in experts.values())
    whole = sum(v[1] for v in experts.values())
    _log("moe_train", f"switch_moe_ffn(E={MOE_EXPERTS}, d_inner="
         f"{MOE_INNER}, capacity {MOE_CF}, relu) on x [{TRAIN_BATCH}, "
         f"{seq}, {d}] float32, mean((out - y)^2) + 0.1 aux, Adam({MOE_LR}), "
         f"1 + {steps - 1} steps: (a) one device {a['losses']}, (b) "
         f"with_distributed(axes={MOE_AXES}) over [cuda:0] * {n} "
         f"{b['losses']}, worst relative {max(rel):.3g} (limit "
         f"{MOE_LOSS_RTOL}); c_alltoall {len(a2a)} a step, "
         f"{sum(e.payload_bytes for e in a2a)} B; collective bytes "
         f"{b['moved']} = plan {plan.payload_bytes} x {steps}; the expert "
         f"weights and Adam moments ({len(experts)} tensors) hold {loc} B "
         f"a rank of {whole}; no kernel launched")
    _log("moe_train", f"step (a) {ms['a']:.1f} ms, (b) {ms['b']:.1f} ms "
         f"(host clock ending in a synchronize; warm-ups "
         f"{a['step_s'][0]:.2f} s, {b['step_s'][0]:.2f} s); peak (a) "
         f"{(a['peak'] - a['held']) / gib:.3f} GiB above "
         f"{a['held'] / gib:.3f} held, (b) "
         f"{(b['peak'] - b['held']) / gib:.3f} above "
         f"{b['held'] / gib:.3f}; on {smi}")
    wall = time.perf_counter() - t_phase
    _log("moe_train", f"phase wall time {wall:.1f} s")
    return {"launches": {}, "losses": a["losses"], "ep_losses": b["losses"],
            "worst_rel": max(rel), "step_ms": ms, "step_s": {
                c: r["step_s"] for c, r in runs.items()},
            "peak_bytes": {c: r["peak"] for c, r in runs.items()},
            "held_bytes": {c: r["held"] for c, r in runs.items()},
            "collective_bytes": b["moved"],
            "payload_bytes": plan.payload_bytes,
            "alltoall_bytes": sum(e.payload_bytes for e in a2a),
            "edges": {"/".join(map(str, k)): v for k, v in kinds.items()},
            "expert_state_bytes_a_rank": loc, "expert_state_bytes": whole,
            "wall_s": wall}


def _ps_port_range(servers):
    """A launch_ps base port: base .. base + servers - 1 (the pservers) and
    base + 1000, base + 1001 (the workers' endpoints) free."""
    import random
    for _ in range(50):
        base = random.randint(20000, 40000)
        socks = []
        try:
            for off in (*range(servers), 1000, 1001):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", base + off))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise RuntimeError("ps_train: no free port range")


def _ps_ctr_one_process():
    """The DeepFM on this process over both trainers' batches of each step
    (1024 rows), SGD(0.2), from the runner's startup seed."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                            unique_name)
    from paddle_tpu_torch.models import build_ctr_train
    from paddle_tpu_torch.tools.ps_runner import SEED, deepfm_batches
    with unique_name.guard():
        main, startup = Program(), Program()
        with program_guard(main, startup):
            loss, _, _ = build_ctr_train(sparse_dim=PS_SPARSE_DIM,
                                         embed_size=16, is_sparse=True)
            optimizer.SGD(learning_rate=0.2).minimize(loss)
    sc, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=sc, seed=SEED)
    f0 = deepfm_batches(0, PS_BATCH, PS_SPARSE_DIM)
    f1 = deepfm_batches(1, PS_BATCH, PS_SPARSE_DIM)
    losses = []
    for step in range(PS_STEPS):
        a, b = f0(step), f1(step)
        fd = {k: np.concatenate([a[k], b[k]]) for k in a}
        losses.append([float(exe.run(main, feed=fd, fetch_list=[loss],
                                     scope=sc)[0])])
    return losses


def _rpc_line(rpc):
    return ", ".join(f"{op} n {r['n']} p50 <= {r['p50']} p99 <= "
                     f"{r['p99']} ms" for op, r in rpc.items())


def _falls(runs):
    """The trainers' mean loss over the last three steps is below their
    mean over the first three."""
    return float(np.mean([r[-3:] for r in runs])) < \
        float(np.mean([r[:3] for r in runs]))


def _ps_ctr_gang(smi):
    """``ps_train`` (a): the DeepFM gang in sync, async and geo mode."""
    import subprocess
    import tempfile
    import torch
    from paddle_tpu_torch.tools import gang_smoke

    repo = os.path.dirname(os.path.abspath(__file__))
    runner = os.path.join(repo, "paddle_tpu_torch", "tools", "ps_runner.py")
    env = gang_smoke.gang_env({"FLAGS_rpc_deadline":
                               str(PS_RPC_DEADLINE_MS)})
    one = _ps_ctr_one_process()
    torch.cuda.empty_cache()
    out = {"one_process_losses": [x[0] for x in one]}
    modes = ("sync", "async", "geo")
    with tempfile.TemporaryDirectory(prefix="pt_ps_train_") as log_dir:
        wall0 = time.time()
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch_ps",
             "--server_num", str(len(modes)), "--worker_num", "2",
             "--started_port", str(_ps_port_range(len(modes))),
             "--log_dir", log_dir, runner, "--model", "deepfm", "--mode",
             ",".join(modes), "--sparse_dim", str(PS_SPARSE_DIM), "--batch",
             str(PS_BATCH), "--steps", str(PS_STEPS), "--geo_push",
             str(PS_GEO_PUSH)],
            env=env, cwd=repo, capture_output=True, text=True,
            timeout=PS_TIMEOUT_S)
        launch_s = time.perf_counter() - t0
        logs = {f: open(os.path.join(log_dir, f)).read()
                for f in sorted(os.listdir(log_dir))}
    if r.returncode != 0:
        tails = "".join(f"\n--- {f} ---\n{text[-3000:]}"
                        for f, text in logs.items())
        raise AssertionError(f"ps_train (a): the launcher exited "
                             f"{r.returncode}: {r.stderr[-3000:]}{tails}")

    def records(tag, files):
        return [json.loads(ln[len(tag) + 1:]) for f in files
                for ln in logs.get(f, "").splitlines()
                if ln.startswith(tag + " ")]
    results = records("RESULT", ["worker.0.log", "worker.1.log"])
    servers = records("PSERVER", [f"server.{k}.log"
                                  for k in range(len(modes))])
    runs = {}
    for mode in modes:
        res = sorted((x for x in results if x["mode"] == mode),
                     key=lambda x: x["trainer_id"])
        if [x["trainer_id"] for x in res] != [0, 1]:
            raise AssertionError(f"ps_train (a) {mode}: trainers' results "
                                 f"{[x['trainer_id'] for x in res]}; the "
                                 f"logs end:\n{list(logs.values())[-1][-3000:]}")
        runs[mode] = (res, [x["marks"] for x in servers
                            if x["mode"] == mode])
    _log("ps_train", f"(a) one launch_ps job, a pserver a mode, 2 trainers "
         f"running sync, async and geo in turn: {launch_s:.1f} s")
    for mode in modes:
        res, srv_marks = runs[mode]
        what = f"ps_train (a) {mode}"
        worst = scored = None
        if mode == "sync":
            if res[0]["digests"] != res[1]["digests"]:
                bad = next(i for i, (x, y) in enumerate(zip(
                    res[0]["digests"], res[1]["digests"])) if x != y)
                raise AssertionError(f"{what}: the trainers' dense "
                                     f"parameters differ after step {bad}")
            worst = _dp_losses_match(what, one, [
                [x, y] for x, y in zip(res[0]["losses"], res[1]["losses"])])
        elif mode == "async":
            # async trainers read tables the other trainer is writing, and
            # each step's loss is of another batch: the last steps' losses
            # against the first ones is a comparison a race (or a slow
            # host's pacing) can flip.  So trainer 0, after the final
            # barrier, scores the startup's and the server's final
            # parameters on the same batches in one process.
            ev, = records("EVAL", ["worker.0.log"])
            init, final = (float(np.mean(ev[k])) for k in ("init", "final"))
            if not (np.isfinite(ev["init"] + ev["final"]).all() and
                    final < init):
                raise AssertionError(f"{what}: the final parameters' loss "
                                     f"{final} on the first batches is not "
                                     f"below the startup's {init}: {ev}")
            scored = ev
        elif not _falls([rr["losses"] for rr in res]):
            raise AssertionError(f"{what}: the loss does not fall: "
                                 f"{[rr['losses'] for rr in res]}")
        if mode == "geo":
            for rr in res:
                rounds = rr["geo_rounds"]
                if len(rounds) != PS_STEPS // PS_GEO_PUSH + 1 or any(
                        p is None or not 0 < p <= fed
                        for rnd in rounds for p, fed in (
                            rnd[t] for t in ("ctr_embedding",
                                             "ctr_wide_w"))):
                    raise AssertionError(f"{what}: trainer "
                                         f"{rr['trainer_id']} rounds "
                                         f"{rounds} push rows not fed")
        marks = [rr["marks"] for rr in res] + srv_marks
        timeline = [{k: round(v - wall0, 2) for k, v in mk.items()}
                    for mk in marks]
        rec = {"worst_rel": worst, "scored": scored,
               "timeline_s": timeline,
               "trainers": [{k: rr[k] for k in (
                   "losses", "step_ms", "examples_per_s", "bytes_pushed",
                   "bytes_pulled", "push_s", "pull_s", "geo_rounds",
                   "launches", "fused", "rpc_ms")} for rr in res]}
        out[mode] = rec
        k5 = sum(rr["launches"]["dense_epilogue"] for rr in res)
        rec["k5_launches"] = k5
        _log("ps_train", f"(a) {mode}: its pserver on the host, 2 trainers "
             f"on cuda:0, DeepFM sparse_dim {PS_SPARSE_DIM} "
             f"(tables [{26 * PS_SPARSE_DIM}, 16] and [{26 * PS_SPARSE_DIM}"
             f", 1] on the server), batch {PS_BATCH} a trainer, 1 + "
             f"{PS_STEPS - 1} steps: losses "
             f"{[[round(x, 5) for x in rr['losses']] for rr in res]}"
             + (f"; dense parameters equal bit for bit on both trainers "
                f"after every step; mean loss against one process on 1024 "
                f"rows {[round(x[0], 5) for x in one]}: worst relative "
                f"{worst:.3g} (limit {DP_LOSS_RTOL})" if mode == "sync"
                else f"; the final parameters' mean loss on both trainers' "
                f"first batches {np.mean(scored['final']):.5f} below the "
                f"startup's {np.mean(scored['init']):.5f} (one process, "
                f"after the final barrier)" if mode == "async"
                else "; the loss falls"))
        _log("ps_train", f"(a) {mode} marks, seconds from the launch "
             f"(trainers 0, 1, then its pserver): {timeline}")
        for rr in res:
            ms = float(np.mean(rr["step_ms"][1:]))
            _log("ps_train", f"(a) {mode} trainer {rr['trainer_id']}: step "
                 f"{ms:.2f} ms ({PS_BATCH / ms * 1e3:.0f} examples/s; "
                 f"host clock ending in a synchronize, timed steps "
                 f"{', '.join(f'{x:.1f}' for x in rr['step_ms'][1:])}; "
                 f"first {rr['step_ms'][0]:.1f}); pushed "
                 f"{np.mean(rr['bytes_pushed'][1:]):.0f} B, pulled "
                 f"{np.mean(rr['bytes_pulled'][1:]):.0f} B a step; K5 "
                 f"{rr['launches']['dense_epilogue']} launches, fused "
                 f"{rr['fused']}; RPCs {_rpc_line(rr['rpc_ms'])}; on {smi}")
            if mode == "geo":
                _log("ps_train", f"(a) geo trainer {rr['trainer_id']}: "
                     f"rounds (rows pushed / distinct ids fed since the "
                     f"round before) {rr['geo_rounds']}")
    out["launch_s"] = launch_s
    return out


class _GradsOnly:
    """An optimizer stand-in: ``minimize`` appends the backward and no
    update."""

    def minimize(self, loss):
        from paddle_tpu_torch.framework import append_backward
        self.params_grads = append_backward(loss)


def _server_adam_losses(cfg, seq, feed, steps, w0, lr=1e-4, b1=0.9,
                        b2=0.999, eps=1e-8):
    """The plain reference of ``ps_train`` (b): ``_dp_program``'s GPT on one
    device from the same startup, each step's gradients applied in float32
    on the card by the parameter server's Adam (``csrc/ps_server.cc``
    ``apply_update``: moments in float32, ``m / (1 - b1^t)`` and ``u / (1 -
    b2^t)`` in double, eps added after the square root).  The Adam op
    (dp_train's one device) adds eps to the uncorrected ``sqrt(v)``
    instead, so the two part where ``|g|`` is near eps / sqrt(1 - b2^t)."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Scope
    f32 = np.float32
    grads_only = _GradsOnly()
    main, start, loss = _dp_program(cfg, seq, lambda: grads_only)
    sc, exe = Scope(), ptt.Executor()
    exe.run(start, scope=sc, seed=1234)
    if _weights_digest(sc, main) != w0:
        raise AssertionError("ps_train (b): the reference's startup "
                             "weights differ from dp_train's")
    pairs = grads_only.params_grads
    mom = {p.name: (torch.zeros_like(sc.find_var(p.name)),
                    torch.zeros_like(sc.find_var(p.name))) for p, _ in pairs}
    b1f, b2f = float(f32(b1)), float(f32(b2))
    losses = []
    for t in range(1, steps + 1):
        out = exe.run(main, feed=feed, fetch_list=[loss] +
                      [g for _, g in pairs], scope=sc, return_numpy=False)
        losses.append(np.asarray(out[0].numpy(), np.float64).reshape(-1))
        bc1, bc2 = 1.0 - b1f ** t, 1.0 - b2f ** t
        for (p, _), h in zip(pairs, out[1:]):
            g, (m, u) = h.tensor, mom[p.name]
            m.mul_(b1f).add_(g, alpha=float(f32(1) - f32(b1f)))
            u.mul_(b2f).add_(g * g, alpha=float(f32(1) - f32(b2f)))
            mh = (m.double() / bc1).float()
            uh = (u.double() / bc2).float()
            sc.find_var(p.name).sub_(float(f32(lr)) * mh /
                                     (torch.sqrt(uh) + float(f32(eps))))
    del sc, exe, mom
    torch.cuda.empty_cache()
    return losses


def _ps_gpt(smi, dp_train):
    """``ps_train`` (b): the GPT over a pserver thread on the host."""
    import tempfile
    import threading
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags, optimizer
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed import DistributeTranspiler, ps
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.tools import gang_smoke
    from paddle_tpu_torch.tools.ps_runner import (reset_rpc_histogram,
                                                  rpc_quantiles)

    cfg = _gpt_cfg()
    seq = cfg.max_pos
    steps = DP_STEPS + 1
    kernels = ("flash_attn_fwd", "flash_attn_bwd")
    gib = 2.0 ** 30
    flags.set_flags({"FLAGS_rpc_deadline": PS_RPC_DEADLINE_MS})
    main, start, loss = _dp_program(
        cfg, seq, lambda: optimizer.AdamOptimizer(learning_rate=1e-4))
    ep = f"127.0.0.1:{gang_smoke.free_port()}"
    t = DistributeTranspiler()
    t.transpile(0, program=main, pservers=ep, trainers=1,
                startup_program=start)
    specs = t._param_specs
    got = {(s["optimizer"], s["lr"]) for s in specs.values()}
    if got != {("adam", 1e-4)}:
        raise AssertionError(f"ps_train (b): the server's optimizers {got} "
                             "are not Adam at the trainer's 1e-4")
    trainer = t.get_trainer_program()
    pprog, pstart = t.get_pserver_programs(ep)
    srv_scope = Scope()
    t0 = time.perf_counter()
    ptt.Executor(ptt.CPUPlace()).run(pstart, scope=srv_scope, seed=1234)
    host_startup_s = time.perf_counter() - t0
    lsv, = pprog.global_block().ops
    box, ready = {}, threading.Event()

    def serve():
        try:
            box["srv"] = ps.run_pserver(lsv, srv_scope, wait=False)
        finally:
            ready.set()
        box["srv"].wait()

    th = threading.Thread(target=serve, daemon=True, name="pt-pserver")
    th.start()
    if not ready.wait(120) or "srv" not in box:
        raise AssertionError("ps_train (b): the pserver did not start")
    srv = box["srv"]
    try:
        t0 = time.perf_counter()
        ref = _server_adam_losses(cfg, seq, dp_train["feed"], steps,
                                  dp_train["weights_digest"])
        ref_s = time.perf_counter() - t0
        sc, exe = Scope(), ptt.Executor()
        exe.run(start, scope=sc, seed=1234)
        w0 = _weights_digest(sc, main)
        if w0 != dp_train["weights_digest"]:
            raise AssertionError("ps_train (b): the trainer's startup "
                                 "weights differ from dp_train's")

        def host(n):
            return sc.find_var(n).detach().cpu().numpy().ravel()
        own = sum(np.array_equal(srv.get_param(n, s["size"]), host(n))
                  for n, s in specs.items())
        cli = ps.get_client(ep)
        t0 = time.perf_counter()
        for n in specs:
            cli.put(n, sc.find_var(n))
        put_s = time.perf_counter() - t0
        for n, s in specs.items():
            tab = srv.get_param(n, s["size"])
            if not (np.array_equal(tab, host(n)) and float(
                    torch.from_numpy(tab).double().sum()) == w0[n]):
                raise AssertionError(f"ps_train (b): the server's {n} is "
                                     "not the trainer's startup value")
        _log("ps_train", f"(b) {len(specs)} tables, "
             f"{sum(s['size'] for s in specs.values())} floats, Adam at "
             f"lr 1e-4 on the server: its own startup on the host "
             f"({host_startup_s:.1f} s) reproduces {own} of {len(specs)} "
             f"tables of the trainer's on the card, so the trainer's are "
             f"put ({put_s:.2f} s) and checked equal by bytes and by "
             f"_weights_digest sums")
        torch.cuda.empty_cache()
        fa.reset_launch_count()
        ps.reset_stats()
        reset_rpc_histogram()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        losses, step_s, parts = [], [], []
        for _ in range(steps):
            before = dict(ps.STATS)
            t0 = time.perf_counter()
            lv, = exe.run(trainer, feed=dp_train["feed"], fetch_list=[loss],
                          scope=sc)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(np.asarray(lv, np.float64).reshape(-1))
            parts.append({k: ps.STATS[k] - before[k] for k in ps.STATS})
        peak = torch.cuda.max_memory_allocated()
        launches = {k: fa.launch_count(k) for k in kernels}
        rpc = rpc_quantiles()
        worst = _dp_losses_match("ps_train (b)", ref, losses)
        first = _dp_losses_match("ps_train (b) step 1",
                                 dp_train["single_losses"][:1], losses[:1])
        adam_gap = max(
            abs(float(g[0]) - float(w[0])) / abs(float(w[0]))
            for g, w in zip(losses, dp_train["single_losses"]))
        want = cfg.n_layer * steps
        if launches != {k: want for k in kernels}:
            raise AssertionError(f"ps_train (b): K1/K2 launched {launches},"
                                 f" expected {want} each")
        bad = [n for n, s in specs.items() if not np.array_equal(
            srv.get_param(n, s["size"]), host(n))]
        if bad:
            raise AssertionError(f"ps_train (b): the server's {bad[:4]} "
                                 "differ from the trainer's copies")
        with tempfile.TemporaryDirectory(prefix="pt_ps_ckpt_") as d:
            ck = CheckpointManager(d)
            if not ck.save_server(steps, srv, list(specs.values())):
                raise AssertionError("ps_train (b): save_server refused")
            ck.wait_until_finished()
            rs = Scope()
            ck.restore(scope=rs)
            back = [n for n, s in specs.items() if float(
                rs.find_var(n).double().sum()) != float(torch.from_numpy(
                    srv.get_param(n, s["size"])).double().sum())]
            if back:
                raise AssertionError(f"ps_train (b): save_server's "
                                     f"snapshot of {back[:4]} loads back "
                                     "to other sums")
    finally:
        try:
            ps.get_client(ep).stop_server()
        finally:
            th.join(120)
            ps.reset_clients()
            flags.set_flags({"FLAGS_rpc_deadline": 180000})
        if th.is_alive():
            raise AssertionError("ps_train (b): the pserver thread did not "
                                 "end")
        srv.destroy()
    timed = parts[1:]

    def mean_ms(key):
        return 1e3 * float(np.mean([p[key] for p in timed]))
    step_ms = 1e3 * float(np.mean(step_s[1:]))
    split = {k: mean_ms(k) for k in ("device_wait_s", "d2h_s", "push_s",
                                     "pull_s", "h2d_s")}
    compute = step_ms - sum(v for k, v in split.items()
                            if k != "device_wait_s")
    pushed = float(np.mean([p["bytes_pushed"] for p in timed]))
    pulled = float(np.mean([p["bytes_pulled"] for p in timed]))
    _log("ps_train", f"(b) the GPT (vocab {cfg.vocab_size}, d "
         f"{cfg.d_model}, {cfg.n_layer} layers, T {seq}) over 1 pserver, "
         f"batch {TRAIN_BATCH} x {seq}, 1 + {DP_STEPS} steps: losses "
         f"{[round(float(l[0]), 6) for l in losses]} against one device "
         f"with the server's Adam {[round(float(l[0]), 6) for l in ref]} "
         f"({ref_s:.1f} s), worst relative {worst:.3g} (limit "
         f"{DP_LOSS_RTOL}); step 1 against dp_train's one device "
         f"{first:.3g}; dp_train's Adam op (eps before the bias "
         f"correction) {[round(float(l[0]), 6) for l in dp_train['single_losses']]}"
         f", largest relative gap {adam_gap:.3g}; K1/K2 {launches} = "
         f"{cfg.n_layer} x {steps}; every parameter pulled from the server "
         f"equals the trainer's copy; save_server's snapshot restores to "
         f"the server's sums")
    _log("ps_train", f"(b) step {step_ms:.1f} ms (timed steps "
         f"{', '.join(f'{1e3 * x:.1f}' for x in step_s[1:])}; first "
         f"{step_s[0]:.2f} s): device compute {compute:.1f} (of it "
         f"{split['device_wait_s']:.1f} waiting at the first push), copy "
         f"to the host {split['d2h_s']:.1f}, push with the server's Adam "
         f"{split['push_s']:.1f}, pull {split['pull_s']:.1f}, copy back "
         f"{split['h2d_s']:.1f}; {pushed:.0f} B pushed and {pulled:.0f} B "
         f"pulled a step; peak {(peak - held) / gib:.3f} GiB above "
         f"{held / gib:.3f} held, against dp_train's one device "
         f"{(dp_train['single_peak_bytes'] - dp_train['single_held_bytes']) / gib:.3f}"
         f" above, {dp_train['single_step_ms']:.1f} ms a step; on {smi}")
    _log("ps_train", f"(b) RPCs: {_rpc_line(rpc)}")
    return {"launches": launches, "losses": [float(l[0]) for l in losses],
            "reference_losses": [float(l[0]) for l in ref],
            "worst_rel": worst, "adam_op_gap": adam_gap,
            "step_s": step_s, "step_ms": step_ms,
            "split_ms": split, "compute_ms": compute,
            "bytes_pushed": pushed, "bytes_pulled": pulled,
            "peak_bytes": peak, "held_bytes": held, "rpc_ms": rpc,
            "own_startup_tables": own, "tables": len(specs),
            "put_s": put_s, "host_startup_s": host_startup_s}


def phase_ps_train(smi, dp_train):
    """The parameter server on the card (module docstring): (a) the DeepFM
    gang in three modes, (b) the GPT over a pserver thread."""
    t_phase = time.perf_counter()
    a = _ps_ctr_gang(smi)
    b = _ps_gpt(smi, dp_train)
    k5 = sum(a[m]["k5_launches"] for m in ("sync", "async", "geo"))
    wall = time.perf_counter() - t_phase
    _log("ps_train", f"K5 {k5} launches over (a)'s trainers; phase wall "
         f"time {wall:.1f} s")
    return {"a": a, "b": b, "launches": dict(b["launches"],
                                             dense_epilogue=k5),
            "wall_s": wall}


def _gang_results(phase, log_dir, n=2):
    """Each rank's ``RESULT`` record from the launcher's worker logs."""
    out = []
    for r in range(n):
        path = os.path.join(log_dir, f"worker.{r}.log")
        text = open(path).read() if os.path.exists(path) else ""
        got = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        if not got:
            raise AssertionError(f"{phase}: rank {r} printed no RESULT; "
                                 f"its log ends:\n{text[-3000:]}")
        out.append(json.loads(got[-1][len("RESULT "):]))
    return out


def phase_gang_train(smi, dp_train):
    """Several processes (module docstring): two trainer processes of the
    port's launcher on this card, (a) GradAllReduce + Adam, (b) ZeRO-1,
    (c) the ring across the pair, then (d) the elastic kill -9 drill."""
    import subprocess
    import tempfile

    import torch
    from paddle_tpu_torch.kernels import ring_attention as ra
    from paddle_tpu_torch.tools import gang_smoke

    t_phase = time.perf_counter()
    cfg = _gpt_cfg()
    gib = 2.0 ** 30
    torch.cuda.empty_cache()        # the children need the card's memory
    one = dp_train["single_losses"]
    _log("gang_train", "backend gloo: the two processes share this one "
         "card, and NCCL refuses two ranks of one communicator on one "
         "device; every collective gathers the ranks' tensors through "
         "pinned host memory and reduces them on the card in rank order")
    repo = os.path.dirname(os.path.abspath(__file__))
    runner = os.path.join(repo, "paddle_tpu_torch", "tools",
                          "collective_runner.py")
    with tempfile.TemporaryDirectory(prefix="pt_gang_train_") as tmp:
        feed = os.path.join(tmp, "feed.npz")
        np.savez(feed, **dp_train["feed"])
        log_dir = os.path.join(tmp, "logs")
        env = gang_smoke.gang_env(dict(GANG_HEARTBEAT,
                                       FLAGS_gang_step_barrier="1"))
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "2", "--started_port",
             str(gang_smoke.free_port()), "--log_dir", log_dir, runner,
             "--model", "gpt", "--feed", feed, "--phases",
             "losses,zero,ring", "--steps", str(GANG_STEPS),
             "--zero-steps", str(GANG_ZERO_STEPS), "--ring",
             ",".join(map(str, (RING_SLICE[0], RING_SLICE[1],
                                RING_SLICE[2]))),
             "--ring-seed", "21", "--ring-tol",
             f"{RING_O_TOL},{RING_GRAD_TOL}"],
            env=env, cwd=repo, capture_output=True, text=True,
            timeout=GANG_TIMEOUT_S)
        launch_s = time.perf_counter() - t0
        if r.returncode != 0:
            tails = "".join(
                f"\n--- worker.{i} ---\n" + open(os.path.join(
                    log_dir, f"worker.{i}.log")).read()[-3000:]
                for i in (0, 1) if os.path.exists(os.path.join(
                    log_dir, f"worker.{i}.log")))
            raise AssertionError(f"gang_train: the launcher exited "
                                 f"{r.returncode}: {r.stderr[-3000:]}"
                                 f"{tails}")
        res = _gang_results("gang_train", log_dir)
    kinds = ("flash_attn_fwd", "flash_attn_bwd")
    out = {"launch_s": launch_s}
    for key, what, steps in (("losses", "(a) GradAllReduce + Adam",
                              GANG_STEPS),
                             ("zero", "(b) with_distributed(dp 2, ZeRO-1)",
                              GANG_ZERO_STEPS)):
        r0, r1 = res[0][key], res[1][key]
        if r0["digest0"] != r1["digest0"]:
            raise AssertionError(f"gang_train {what}: the ranks' startup "
                                 "weights differ")
        if r0["losses"] != r1["losses"] or r0["digest"] != r1["digest"]:
            raise AssertionError(f"gang_train {what}: the ranks differ: "
                                 f"losses {r0['losses']} / {r1['losses']}")
        worst = _dp_losses_match(f"gang_train {what}", one, r0["losses"],
                                 GANG_LOSS_RTOL)
        want = cfg.n_layer * steps
        for rr in (r0, r1):
            if rr["launches"] != {k: want for k in kinds}:
                raise AssertionError(f"gang_train {what}: K1/K2 launched "
                                     f"{rr['launches']}, expected {want} "
                                     f"each ({cfg.n_layer} a step)")
            if rr["plan_bytes"] is None or \
                    rr["collective_bytes"] != rr["plan_bytes"] * steps:
                raise AssertionError(
                    f"gang_train {what}: {rr['collective_bytes']} "
                    f"collective bytes, plan {rr['plan_bytes']} x {steps}")
        ms = [float(np.mean(rr["step_ms"][1:])) for rr in (r0, r1)]
        xms = [float(np.mean(rr["exchange_ms"][1:])) for rr in (r0, r1)]
        peak = [(rr["peak_bytes"] - rr["held_bytes"]) / gib
                for rr in (r0, r1)]
        out[key] = {"losses": r0["losses"], "worst_rel": worst,
                    "step_ms": [rr["step_ms"] for rr in (r0, r1)],
                    "exchange_ms": [rr["exchange_ms"] for rr in (r0, r1)],
                    "peak_bytes": [rr["peak_bytes"] for rr in (r0, r1)],
                    "held_bytes": [rr["held_bytes"] for rr in (r0, r1)],
                    "launches": [rr["launches"] for rr in (r0, r1)],
                    "collective_bytes": r0["collective_bytes"],
                    "plan_bytes": r0["plan_bytes"]}
        _log("gang_train", f"{what}, 2 processes x batch "
             f"{TRAIN_BATCH // 2} x {cfg.max_pos}, 1 + {steps - 1} steps: "
             f"losses {[round(x, 6) for x in r0['losses']]} equal on both "
             f"ranks bit for bit (parameters too: digest {r0['digest'][:12]}"
             f"), against one device's worst relative {worst:.3g} (limit "
             f"{GANG_LOSS_RTOL}); K1/K2 {want} a rank ({cfg.n_layer} a "
             f"step); collective bytes {r0['collective_bytes']} = plan "
             f"{r0['plan_bytes']} x {steps} on each rank")
        _log("gang_train", f"{what}: step {ms[0]:.1f} / {ms[1]:.1f} ms "
             f"(host clock ending in a synchronize, timed steps of ranks 0 "
             f"/ 1; warm-up {r0['step_ms'][0] / 1e3:.2f} / "
             f"{r1['step_ms'][0] / 1e3:.2f} s), the cross-process exchange "
             f"{xms[0]:.1f} / {xms[1]:.1f} ms a step, peak {peak[0]:.3f} / "
             f"{peak[1]:.3f} GiB above held, against one device's "
             f"{dp_train['single_step_ms']:.1f} ms; on {smi}")
    rings = [rr["ring"] for rr in res]
    want = {k: v // 2 for k, v in ra.expected_launches(2, False).items()}
    for rank, ring in enumerate(rings):
        if ring["launches"] != want:
            raise AssertionError(f"gang_train (c): rank {rank} launched "
                                 f"{ring['launches']}, expected {want}")
        if not max(ring["shares"].values()) <= 1.0:
            raise AssertionError(f"gang_train (c): rank {rank} errors "
                                 f"{ring['errors']} (shares of the bound "
                                 f"{ring['shares']})")
    out["ring"] = rings
    _log("gang_train", f"(c) ring attention {list(RING_SLICE)} float32 "
         f"non-causal, sp 2 across the two processes (the K/V and dK/dV "
         f"rotations a send and a receive over gloo): each process's half "
         f"against the plain dense attention over the whole T, max abs err "
         + "; ".join(f"rank {i} " + " ".join(
             f"{n} {e:.3g} ({ring['shares'][n]:.2f})"
             for n, e in ring["errors"].items())
             for i, ring in enumerate(rings))
         + f" (share of rtol = atol = {RING_O_TOL} o, lse, {RING_GRAD_TOL} "
         f"grads); K1/K2/merge {rings[0]['launches']} a rank; fwd + bwd "
         f"{rings[0]['ms']:.1f} / {rings[1]['ms']:.1f} ms; on {smi}")
    t0 = time.perf_counter()
    drill = gang_smoke.drill(
        "full2", cpu=False, total=GANG_DRILL_STEPS,
        kill_step=GANG_KILL_STEP, pause=GANG_DRILL_PAUSE_S,
        timeout=GANG_TIMEOUT_S, env=GANG_HEARTBEAT)
    drill_s = time.perf_counter() - t0
    n2 = 2
    for who in ("baseline", "rank0", "rank1"):
        done = drill[who][-1]
        steps = GANG_DRILL_STEPS - done["start"]
        if done["launches"] != {k: n2 * steps for k in kinds}:
            raise AssertionError(f"gang_train (d): {who} launched "
                                 f"{done['launches']} in {steps} steps")
    out["drill"] = dict(drill, drill_s=drill_s)
    step_ms = [float(np.median(drill[w][-1]["step_ms"]))
               for w in ("baseline", "rank0", "rank1")]
    _log("gang_train", f"(d) elastic drill (GPT at d 768, 2 layers, batch "
         f"8 x 2048, CheckpointDaemon every 2 steps): rank 1 SIGKILLed "
         f"itself at step {GANG_KILL_STEP}, the launcher respawned it, it "
         f"resumed at the manifest's step {drill['resumed_at']}; both "
         f"ranks' {GANG_DRILL_STEPS} losses equal the uninterrupted "
         f"baseline's bit for bit; median step {step_ms[0]:.1f} (baseline)"
         f" / {step_ms[1]:.1f} / {step_ms[2]:.1f} ms (ranks, the respawn's "
         f"life); drill {drill_s:.1f} s; on {smi}")
    wall = time.perf_counter() - t_phase
    # the kernels' launches in the children, by path (both ranks; the
    # respawned rank's second life)
    out["launches"] = {
        "gang_train": {k: sum(lr[k] for key in ("losses", "zero")
                              for lr in out[key]["launches"])
                       for k in kinds},
        "gang_ring": {k: sum(ring["launches"][k] for ring in rings)
                      for k in kinds + ("ring_merge",)},
        "gang_drill": {k: sum(drill[w][-1]["launches"][k]
                              for w in ("baseline", "rank0", "rank1"))
                       for k in kinds}}
    out["wall_s"] = wall
    _log("gang_train", f"phase wall time {wall:.1f} s (launcher "
         f"{launch_s:.1f} s, drill {drill_s:.1f} s)")
    return out


def phase_preempt_train(train):
    """The SIGTERM drill of ``tools.preempt_runner`` at full width."""
    import torch
    from paddle_tpu_torch.tools import preempt_runner as pr

    torch.cuda.empty_cache()      # the children need the card's memory
    cfg = _gpt_cfg()
    cfg.n_layer = pr.SIZES[PREEMPT_SIZE]["cfg"]["n_layer"]
    t0 = time.perf_counter()
    runs = pr.drill(PREEMPT_SIZE, cpu=False, steps=PREEMPT_STEPS,
                    interval=PREEMPT_INTERVAL, timeout=PREEMPT_TIMEOUT_S)
    wall = time.perf_counter() - t0
    report = pr.check(runs, PREEMPT_STEPS)
    half = PREEMPT_STEPS // 2
    trained = {"a1": PREEMPT_STEPS, "a2": PREEMPT_STEPS, "b": half,
               "c": PREEMPT_STEPS - half}
    launches = {"flash_attn_fwd": 0, "flash_attn_bwd": 0}
    for name, steps in trained.items():
        for k, n in runs[name]["launches"].items():
            if n != cfg.n_layer * steps:
                raise AssertionError(
                    f"preempt_train ({name}): float32 {k} launched {n} "
                    f"times in {steps} steps, expected {cfg.n_layer} a "
                    f"step")
            launches[k] += n
    if report["first_diff_a1_a2"] is not None:
        _log("preempt_train", f"(a1) and (a2) differ from step "
             f"{report['first_diff_a1_a2']} (largest loss gap "
             f"{report['a1_a2_max_gap']:.3e}): the resume is held to it")
    names = ("a1", "a2", "b", "c")
    captures = [c["ms"] for n in names for c in runs[n]["capture"]]
    persists = [p for n in names for p in runs[n]["persist"]]
    a1_steps = [runs["a1"]["step_ms"][str(i)]
                for i in range(1, PREEMPT_STEPS)]
    peak = max((b for n in names for b in runs[n]["capture_peak_bytes"]),
               default=0)
    c = runs["c"]
    out = {
        "launches": launches, "report": report, "wall_s": wall,
        "bytes": runs["a1"]["bytes"],
        "capture_ms": captures,
        "capture_ms_median": float(np.median(captures)),
        "save_ms": [p["ms"] for p in persists],
        "host_copy_ms": [p["host_copy_ms"] for p in persists],
        "sigterm_to_exit_ms": runs["b"]["sigterm_to_exit_ms"],
        "emergency_ms": [e["ms"] for e in runs["b"]["emergency"]],
        "drain_ms": [e["ms"] for e in runs["b"]["drain"]],
        "restore_ms": [r["ms"] for r in c["restore"]],
        "resume_s": c["resume_s"],
        "step_ms_a1": a1_steps,
        "step_ms_median": float(np.median(a1_steps)),
        "train_step_ms": train["step_ms"],
        "capture_peak_bytes": peak,
        "disk_free": runs["disk_free"],
        "losses": {n: runs[n]["losses"] for n in names},
        "child_wall_s": {n: runs[n]["wall_s"] for n in names}}
    _log("preempt_train",
         f"{out['bytes'] / 1e9:.3f} GB a checkpoint "
         f"({len(runs['b']['digests_end'])} persistables); "
         f"training-thread stall per capture: median "
         f"{out['capture_ms_median']:.2f} ms over {len(captures)} "
         f"captures (max {max(captures):.2f}); daemon save (copy to the "
         f"host, write, fsync): {', '.join(f'{x:.0f}' for x in out['save_ms'])} ms "
         f"(host copy {', '.join(f'{x:.1f}' for x in out['host_copy_ms'])} ms)")
    out["digest_ms_b"] = 1e3 * runs["b"]["digest_s"]
    _log("preempt_train",
         f"SIGTERM to exit {out['sigterm_to_exit_ms']:.0f} ms (drain "
         f"{out['drain_ms']}, emergency checkpoint {out['emergency_ms']} "
         f"ms, the drill's digests of the saved state "
         f"{out['digest_ms_b']:.0f} ms); resume: restore {out['restore_ms']} ms, resume_or_init "
         f"{c['resume_s']:.2f} s; step with the daemon: median "
         f"{out['step_ms_median']:.1f} ms ({', '.join(f'{x:.1f}' for x in a1_steps)}) "
         f"against train's {train['step_ms']:.1f} ms; peak card memory "
         f"above start across a capture {peak / 2**30:.3f} GiB; free disk "
         f"{', '.join(f'{x / 2**30:.1f}' for x in out['disk_free'])} GiB")
    _log("preempt_train",
         f"restored state == saved state (bitwise, all persistables); "
         f"losses (b)+(c) vs (a1): bitwise {report['bitwise']}, largest "
         f"difference {report['resume_max_diff']:.3e} (a1-a2 gap "
         f"{report['a1_a2_max_gap']:.3e}); (b) checkpoint.write: "
         f"{report['counters_b']}; float32 K1/K2 launches {launches}; "
         f"children {', '.join(f'{n} {s:.1f} s' for n, s in out['child_wall_s'].items())}, "
         f"phase {wall:.1f} s")
    return out


def _small_train_check(phase, exe, fused=False):
    """A 2-layer, batch-1, seq-1024 step on the card against the same step
    on the host: the loss within TRAIN_LOSS_RTOL, four gradients within
    two bf16 ulps (see the constants).  ``fused``: the host runs the fused
    program the card's plan ran (the autotuner's verdicts are the card's;
    the host would time its own)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.analysis import fusion
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.models import transformer as T
    cfg = _gpt_cfg()
    small = T.BertConfig(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                         n_layer=2, n_head=cfg.n_head, d_inner=cfg.d_inner,
                         max_pos=1024, dropout=0.0)
    s_main, s_startup, s_loss = _train_program(small, 1024)
    s_scope, host_scope = Scope(), Scope()
    exe.run(s_startup, scope=s_scope, seed=99)
    for name, val in s_scope.items():
        host_scope.set_var(name, val.detach().cpu())
    s_feed = _train_feed(small, 1, 1024, seed=1)
    grads = ["lm_out.w@GRAD", "enc_0.attn.qkv.w@GRAD",
             "enc_1.ffn.fc1.w@GRAD", "word_embedding@GRAD"]
    fetch = [s_loss.name] + grads
    card = exe.run(s_main, feed=s_feed, fetch_list=fetch, scope=s_scope)
    host_prog, what = s_main, ""
    if fused:
        # the executor's own call, answered from the pass's result cache
        host_prog = fusion.fuse_program(
            s_main, fetch, feed_shapes={n: v.shape for n, v in
                                        s_feed.items()}, device=exe.device)
        assert host_prog is not s_main, "the small program was not fused"
        what = " (fused program; verdicts at this shape: " + ", ".join(
            f"{d['pattern']} {d['verdict']}" + (
                f" {d['autotune']['base_ms']}/{d['autotune']['fused_ms']} ms"
                if "autotune" in d else "")
            for d in host_prog._attrs["fusion"]["candidates"]) + ")"
    t_c = time.perf_counter()
    host = ptt.Executor(ptt.CPUPlace()).run(
        host_prog, feed=s_feed, fetch_list=fetch, scope=host_scope)
    host_s = time.perf_counter() - t_c
    loss_err = abs(float(card[0]) - float(host[0])) / abs(float(host[0]))
    if loss_err > TRAIN_LOSS_RTOL:
        raise AssertionError(f"card loss {float(card[0])} vs host "
                             f"{float(host[0])}: rel err {loss_err}")
    worst = []
    for name, c, h in zip(grads, card[1:], host[1:]):
        top = float(np.abs(h).max())
        err = np.abs(c - h)
        rel = TRAIN_GRAD_RTOL * np.abs(h)
        bad = int((err > TRAIN_GRAD_ATOL_FRAC * top + rel).sum())
        loose = int((err > TRAIN_GRAD_TIGHT_FRAC * top + rel).sum())
        share = FUSED_GRAD_TIGHT_SHARE if fused else TRAIN_GRAD_TIGHT_SHARE
        if bad or loose > share * h.size:
            raise AssertionError(
                f"{name}: {bad} of {h.size} values beyond "
                f"{TRAIN_GRAD_ATOL_FRAC:.3g} x max|g|, {loose} beyond "
                f"{TRAIN_GRAD_TIGHT_FRAC} x max|g| (rtol {TRAIN_GRAD_RTOL:.3g}"
                f", at most {share:g} of them); max abs err {err.max()}, "
                f"max |g| {top}")
        worst.append(f"{name} {err.max():.3g} (max |g| {top:.3g}, "
                     f"{loose} of {h.size} beyond 1e-4 x max|g|)")
    _log(phase, f"2-layer batch-1 seq-1024 step vs host run{what} "
         f"({host_s:.1f} s): loss rel err {loss_err:.3g} (rtol "
         f"{TRAIN_LOSS_RTOL}); grads max abs err {'; '.join(worst)} "
         f"(rtol {TRAIN_GRAD_RTOL:.3g}) ok")


def _adam_plan(exe):
    """The executor's plan of the training program (the fused program it
    runs in place of the one it was given)."""
    plan, = [p for p in exe._plans.values()
             if any(op.type == "adam" for op, _ in p.ops)]
    return plan


def _fused_launches(dtype=None):
    """Launch counts of the GPT paths' kernels on ``dtype`` operands
    ("float32", "bfloat16"; None: both)."""
    from paddle_tpu_torch.kernels import dense_epilogue as de
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    return {"dense_epilogue": de.launch_count("dense_epilogue", dtype),
            "layer_norm_fwd": ln.launch_count("layer_norm_fwd", dtype),
            "layer_norm_bwd": ln.launch_count("layer_norm_bwd", dtype),
            "flash_attn_fwd": fa.launch_count("flash_attn_fwd", dtype),
            "flash_attn_bwd": fa.launch_count("flash_attn_bwd", dtype)}


def phase_fused_train():
    import shutil
    import tempfile

    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import dense_epilogue as de
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln

    cfg = _gpt_cfg()
    seq = cfg.max_pos
    cache_dir = tempfile.mkdtemp(prefix="fusion_autotune_")
    flags.set_flags(dict(FUSED_FLAGS, FLAGS_xla_compile_cache_dir=cache_dir))
    try:
        main, startup, loss = _train_program(cfg, seq)
        n_ln = [op.type for op in main.global_block().ops].count(
            "layer_norm")
        scope, exe = Scope(), ptt.Executor()
        exe.run(startup, scope=scope, seed=1234)
        feed = _train_feed(cfg, TRAIN_BATCH, seq)
        tokens = TRAIN_BATCH * seq

        # the main path, counted: a warm-up step (the plan, with the
        # autotuner's timings) and the timed steps
        for mod in (fa, de, ln):
            mod.reset_launch_count()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        prev = _fused_launches()
        per_step, losses, step_s = [], [], []
        for _ in range(TRAIN_STEPS + 1):
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            now = _fused_launches()
            per_step.append({k: now[k] - prev[k] for k in now})
            prev = now
            losses.append(float(out))
        launches = _fused_launches()
        peak = torch.cuda.max_memory_allocated()
        warm_s = step_s.pop(0)
        plan = _adam_plan(exe)
        ftypes = [op.type for op, _ in plan.ops]
        decisions = plan.block.program._attrs["fusion"]["candidates"]
        for d in decisions:
            t = d.get("autotune") or {}
            _log("fused_train", f"autotune {d['pattern']} at {d['anchor']}: "
                 f"verdict {d['verdict']}, rank {d['rank']}, base_ms "
                 f"{t.get('base_ms')}, fused_ms {t.get('fused_ms')}, win "
                 f"{t.get('win')}, cached {t.get('cached')}")
        lost = [d for d in decisions if d["verdict"] != "applied"]
        if lost:
            raise AssertionError(f"fusion candidates not applied: {lost}")
        want = {"fused_dense_act": cfg.n_layer,
                "fused_dense_act_grad": cfg.n_layer,
                "fused_embedding_layer_norm": 1,
                "fused_embedding_layer_norm_grad": 1,
                "layer_norm": n_ln - 1}
        got = {t: ftypes.count(t) for t in want}
        unkernelled = [op.type for op, _ in plan.ops
                       if op.type in want and op.type != "layer_norm"
                       and not op.attrs["use_pallas"]]
        if got != want or unkernelled:
            raise AssertionError(f"fused plan holds {got}, expected {want}; "
                                 f"without the kernel: {unkernelled}")
        # the warm-up step also ran each missed candidate's fused op as
        # often as its autotune record says (a warm run and 3 held rounds)
        tuned = {p: sum(d["autotune"].get("fused_runs", 0) for d in decisions
                        if d["pattern"] == p)
                 for p in ("dense_epilogue", "embedding_layer_norm")}
        step_want = {"dense_epilogue": cfg.n_layer, "layer_norm_fwd": 1,
                     "layer_norm_bwd": 1, "flash_attn_fwd": cfg.n_layer,
                     "flash_attn_bwd": cfg.n_layer}
        warm_want = dict(step_want)
        warm_want["dense_epilogue"] += tuned["dense_epilogue"]
        warm_want["layer_norm_fwd"] += tuned["embedding_layer_norm"]
        if per_step != [warm_want] + [step_want] * TRAIN_STEPS:
            raise AssertionError(f"launches per step {per_step}, expected "
                                 f"{warm_want} then {step_want}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"fused training losses not finite and "
                                 f"falling: {losses}")
        step_ms = 1e3 * float(np.mean(step_s))
        _log("fused_train", f"batch {TRAIN_BATCH} x seq {seq}: fused plan of "
             f"{len(ftypes)} ops ({got}); warm-up step {warm_s:.2f} s, then "
             f"{TRAIN_STEPS} steps of "
             f"{', '.join(f'{1e3 * x:.1f}' for x in step_s)} ms; losses "
             f"{', '.join(f'{x:.4f}' for x in losses)}; launches per step "
             f"{per_step[1]} (warm-up {per_step[0]}); peak memory "
             f"{peak / 2**30:.2f} GiB, of which {held / 2**30:.2f} GiB "
             f"allocated before the first step")
        _small_train_check("fused_train", exe, fused=True)
    finally:
        flags.set_flags(DEFAULT_FLAGS)
        shutil.rmtree(cache_dir, ignore_errors=True)
    return {"launches": launches, "per_step": per_step, "losses": losses,
            "step_ms": step_ms, "step_s": step_s, "warmup_s": warm_s,
            "tokens_per_s": tokens / (step_ms / 1e3), "peak_bytes": peak,
            "held_bytes": held, "decisions": decisions}


def _amp_launches():
    """The bf16 and float32 launch counts of the kernels the AMP GPT paths
    run, as ``<kernel>_bf16`` and ``<kernel>_f32``."""
    return {k + tag: n for dtype, tag in (("bfloat16", "_bf16"),
                                          ("float32", "_f32"))
            for k, n in _fused_launches(dtype).items()}


def _frac_err(c, h):
    """max |c - h| / max |h|, and the share of values beyond two bf16 ulps
    of their own magnitude plus 1e-3 of the largest."""
    c, h = np.asarray(c, np.float64), np.asarray(h, np.float64)
    top = max(float(np.abs(h).max()), 1e-30)
    err = np.abs(c - h)
    share = float((err > 2 * 2.0 ** -8 * np.abs(h) + 1e-3 * top).mean())
    return float(err.max()) / top, share


def _small_amp_check(phase, exe, fused=False):
    """One AMP step of a 2-layer, batch-1, seq-1024 GPT on the card
    against the same step on the host: the loss within
    AMP_SMALL_LOSS_RTOL, four gradients within AMP_SMALL_FRAC of their
    largest magnitude (see the constants).  ``fused``: the host runs the
    fused program the card's plan ran."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.analysis import fusion
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.models import transformer as T
    cfg = _gpt_cfg()
    small = T.BertConfig(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                         n_layer=2, n_head=cfg.n_head, d_inner=cfg.d_inner,
                         max_pos=1024, dropout=0.0)
    s_main, s_startup, s_loss = _train_program(small, 1024, amp=True)
    s_scope, host_scope = Scope(), Scope()
    exe.run(s_startup, scope=s_scope, seed=99)
    for name, val in s_scope.items():
        host_scope.set_var(name, val.detach().cpu())
    s_feed = _train_feed(small, 1, 1024, seed=1)
    grads = ["lm_out.w@GRAD", "enc_0.attn.qkv.w@GRAD",
             "enc_1.ffn.fc1.w@GRAD", "word_embedding@GRAD"]
    fetch = [s_loss.name] + grads
    card = exe.run(s_main, feed=s_feed, fetch_list=fetch, scope=s_scope)
    host_prog = s_main
    if fused:
        host_prog = fusion.fuse_program(
            s_main, fetch, feed_shapes={n: v.shape for n, v in
                                        s_feed.items()}, device=exe.device)
    t_c = time.perf_counter()
    host = ptt.Executor(ptt.CPUPlace()).run(
        host_prog, feed=s_feed, fetch_list=fetch, scope=host_scope)
    host_s = time.perf_counter() - t_c
    loss_err = abs(float(card[0]) - float(host[0])) / abs(float(host[0]))
    errs = {n: _frac_err(c, h) for n, c, h in zip(grads, card[1:], host[1:])}
    bad = {n: e for n, e in errs.items() if not e[0] <= AMP_SMALL_FRAC}
    if not loss_err <= AMP_SMALL_LOSS_RTOL or bad:
        raise AssertionError(f"{phase}: AMP card step vs host: loss "
                             f"{float(card[0])} vs {float(host[0])} (rel "
                             f"{loss_err}), gradients beyond "
                             f"{AMP_SMALL_FRAC} x max|g|: {bad}")
    _log(phase, f"2-layer batch-1 seq-1024 AMP step vs host run"
         f"{' (fused program)' if fused else ''} ({host_s:.1f} s): loss "
         f"{float(card[0]):.6f} vs {float(host[0]):.6f}, rel err "
         f"{loss_err:.3g} (rtol {AMP_SMALL_LOSS_RTOL:.3g}); grads max err / "
         f"max|g| (share beyond 2 bf16 ulps + 1e-3 max|g|): "
         + "; ".join(f"{n.split('@')[0]} {e[0]:.3g} ({e[1]:.2g})"
                     for n, e in errs.items())
         + f" (bound {AMP_SMALL_FRAC:.3g}) ok")
    return {"loss_rel_err": loss_err, "grad_err_frac": errs}


def phase_amp_train(train, fused=False):
    """The GPT of ``train`` under ``amp.decorate(AdamOptimizer(1e-4))``
    (bench.py:424), batch 8 x 2048, one warm-up and 5 timed steps; with
    the autotuner on when ``fused``.  Every step launches the bf16 K1 and
    K2 12 times each and no float32 form; fused, the bf16 K5 and K4 as
    the autotune verdicts give them (the warm-up step also runs each
    missed candidate's fused op ``fused_runs`` times).  The losses finite
    and falling, the first within AMP_LOSS_RTOL of ``train``'s first (the
    same weights and feed), every parameter float32 after the steps."""
    import shutil
    import tempfile

    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.analysis import fusion
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import dense_epilogue as de
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln

    phase = "amp_fused_train" if fused else "amp_train"
    cfg = _gpt_cfg()
    seq = cfg.max_pos
    cache_dir = tempfile.mkdtemp(prefix="fusion_autotune_")
    if fused:
        # a fresh autotune cache: the file then holds this phase's records
        # only (the pass keeps the float32 phase's in memory and would
        # write them out beside them)
        fusion.clear_cache()
        flags.set_flags(dict(FUSED_FLAGS,
                             FLAGS_xla_compile_cache_dir=cache_dir))
    try:
        main, startup, loss = _train_program(cfg, seq, amp=True)
        assert main._attrs.get("amp") is True
        scope, exe = Scope(), ptt.Executor()
        exe.run(startup, scope=scope, seed=1234)
        feed = _train_feed(cfg, TRAIN_BATCH, seq)
        tokens = TRAIN_BATCH * seq

        # the main path, counted: a warm-up step and the timed steps
        for mod in (fa, de, ln):
            mod.reset_launch_count()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        prev = _amp_launches()
        per_step, losses, step_s = [], [], []
        for _ in range(TRAIN_STEPS + 1):
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            now = _amp_launches()
            per_step.append({k: now[k] - prev[k] for k in now})
            prev = now
            losses.append(float(out))
        launches = _amp_launches()
        peak = torch.cuda.max_memory_allocated()
        warm_s = step_s.pop(0)
        plan = _adam_plan(exe)
        ftypes = [op.type for op, _ in plan.ops]
        step_want = dict.fromkeys(launches, 0)
        step_want.update(flash_attn_fwd_bf16=cfg.n_layer,
                         flash_attn_bwd_bf16=cfg.n_layer)
        warm_want = dict(step_want)
        decisions = []
        if fused:
            decisions = plan.block.program._attrs["fusion"]["candidates"]
            for d in decisions:
                t = d.get("autotune") or {}
                _log(phase, f"autotune {d['pattern']} at {d['anchor']}: "
                     f"verdict {d['verdict']}, rank {d['rank']}, base_ms "
                     f"{t.get('base_ms')}, fused_ms {t.get('fused_ms')}, "
                     f"win {t.get('win')}, cached {t.get('cached')}")
            with open(os.path.join(cache_dir, "fusion_autotune.json")) as f:
                keys = [json.loads(k) for k in json.load(f)]
            if not keys or any(k[-1] != "amp" for k in keys):
                raise AssertionError(f"autotune records not keyed 'amp': "
                                     f"{keys}")
            applied = {p: sum(d["verdict"] == "applied" for d in decisions
                              if d["pattern"] == p)
                       for p in ("dense_epilogue", "embedding_layer_norm")}
            tuned = {p: sum((d.get("autotune") or {}).get("fused_runs", 0)
                            for d in decisions if d["pattern"] == p)
                     for p in applied}
            if ftypes.count("fused_dense_act") != applied["dense_epilogue"] \
                    or not all(op.attrs["use_pallas"] for op, _ in plan.ops
                               if op.type in ("fused_dense_act",
                                              "fused_embedding_layer_norm")):
                raise AssertionError(f"fused plan: {applied}, fused ops "
                                     f"{ftypes.count('fused_dense_act')}")
            step_want.update(
                dense_epilogue_bf16=applied["dense_epilogue"],
                layer_norm_fwd_bf16=applied["embedding_layer_norm"],
                layer_norm_bwd_bf16=applied["embedding_layer_norm"])
            warm_want = dict(step_want)
            warm_want["dense_epilogue_bf16"] += tuned["dense_epilogue"]
            warm_want["layer_norm_fwd_bf16"] += tuned["embedding_layer_norm"]
        if per_step != [warm_want] + [step_want] * TRAIN_STEPS:
            raise AssertionError(f"{phase}: launches per step {per_step}, "
                                 f"expected {warm_want} then {step_want}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{phase}: losses not finite and falling: "
                                 f"{losses}")
        rel = abs(losses[0] - train["losses"][0]) / abs(train["losses"][0])
        if not rel <= AMP_LOSS_RTOL:
            raise AssertionError(f"{phase}: first loss {losses[0]} vs the "
                                 f"float32 step's {train['losses'][0]} "
                                 f"(rel {rel} > {AMP_LOSS_RTOL})")
        not_f32 = [p.name for p in main.all_parameters()
                   if scope.find_var(p.name).dtype != torch.float32]
        if not_f32:
            raise AssertionError(f"{phase}: parameters not float32 after "
                                 f"the steps: {not_f32}")
        step_ms = 1e3 * float(np.mean(step_s))
        nz = {k: v for k, v in per_step[1].items() if v}
        _log(phase, f"batch {TRAIN_BATCH} x seq {seq} bf16 AMP: plan of "
             f"{len(ftypes)} ops ({ftypes.count('fused_dense_act')} "
             f"fused_dense_act, {ftypes.count('fused_embedding_layer_norm')}"
             f" fused_embedding_layer_norm); warm-up step {warm_s:.2f} s, "
             f"then {TRAIN_STEPS} steps of "
             f"{', '.join(f'{1e3 * x:.1f}' for x in step_s)} ms; losses "
             f"{', '.join(f'{x:.4f}' for x in losses)} (first vs float32 "
             f"{train['losses'][0]:.4f}: rel {rel:.3g}, rtol "
             f"{AMP_LOSS_RTOL:.3g}); launches per step {nz} (warm-up "
             f"{ {k: v for k, v in per_step[0].items() if v} }); "
             f"{len(main.all_parameters())} parameters float32; peak "
             f"memory {peak / 2**30:.2f} GiB, of which {held / 2**30:.2f} "
             f"GiB allocated before the first step")
        small = _small_amp_check(phase, exe, fused)
    finally:
        if fused:
            flags.set_flags(DEFAULT_FLAGS)
        shutil.rmtree(cache_dir, ignore_errors=True)
    return {"launches": launches, "per_step": per_step, "losses": losses,
            "step_ms": step_ms, "step_s": step_s, "warmup_s": warm_s,
            "tokens_per_s": tokens / (step_ms / 1e3), "peak_bytes": peak,
            "held_bytes": held, "decisions": decisions, "small": small,
            "main": main, "loss": loss, "scope": scope, "feed": feed}


def _resnet_program(amp=False, **kw):
    """``build_resnet_train`` with ``MomentumOptimizer(0.1, 0.9)``, under
    ``amp.decorate`` (bench.py:189) when ``amp``."""
    from paddle_tpu_torch import amp as amp_mod
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.models import resnet
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss, accs = resnet.build_resnet_train(**kw)
        mom = optimizer.MomentumOptimizer(learning_rate=0.1, momentum=0.9)
        (amp_mod.decorate(mom) if amp else mom).minimize(loss)
    return main, startup, loss, accs


def _resnet_feed(batch, class_dim, image_shape, seed=0):
    """bench.py:208-214: one fixed batch of uniform images and labels."""
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(batch, *image_shape).astype(np.float32),
            "label": rng.randint(0, class_dim, (batch, 1)).astype(np.int64)}


def _train_plan(exe):
    """The executor's one plan of a training program (the fused program
    it runs in place of the one it was given)."""
    plan, = [p for p in exe._plans.values()
             if any(op.type == "momentum" for op, _ in p.ops)]
    return plan


def _fused_shapes(plan):
    """(Cin, Cout, H*W) of each fused_conv1x1_bn op the plan runs."""
    block = plan.block
    out = []
    for op, _ in plan.ops:
        if op.type != "fused_conv1x1_bn":
            continue
        w = block.var(op.input("Filter")[0]).shape
        y = block.var(op.output("Y")[0]).shape
        out.append((int(w[1]), int(w[0]), int(y[2]) * int(y[3])))
    return out


def _toy_resnet_program(amp=False, passes=()):
    """Two bottleneck blocks (strides 1 and 2, 16 filters) on a [16, 8, 8]
    input, global pooling, fc with softmax: 6 fused conv1x1 + BN pairs;
    under ``amp.decorate`` when ``amp``.  ``passes`` go over the forward
    program (``ir.apply_passes``) before ``minimize``."""
    from paddle_tpu_torch import amp as amp_mod
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.framework import Program, ir, program_guard
    from paddle_tpu_torch.models import resnet
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("image", shape=[16, 8, 8], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        h = resnet.bottleneck_block(img, 16, 1, "bb0")
        h = resnet.bottleneck_block(h, 16, 2, "bb1")
        pred = layers.fc(layers.pool2d(h, pool_type="avg",
                                       global_pooling=True), size=4,
                         act="softmax", param_attr="fc_out.w",
                         bias_attr="fc_out.b")
        loss = layers.mean(layers.cross_entropy(pred, label))
    if passes:
        main = ir.apply_passes(main, passes)
        loss = main.global_block().var(loss.name)
    with program_guard(main, startup):
        mom = optimizer.MomentumOptimizer(learning_rate=0.1, momentum=0.9)
        (amp_mod.decorate(mom) if amp else mom).minimize(loss)
    return main, startup, loss


def _resnet_small_check(exe, model, fused, amp=False):
    """One step on the card against the same step on the host: the toy or
    depth 50 at 3x64x64, batch 8, with the fusion pass on or off, and under
    ``amp.decorate`` when ``amp`` (the loss within AMP_SMALL_LOSS_RTOL for
    the toy, RESNET_FUSED_LOSS_RTOL at depth 50; on the toy the BN running
    statistics and the classifier's gradients within AMP_SMALL_FRAC of
    their largest magnitude)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import conv_bn as cb
    if model == "toy":
        main, startup, loss = _toy_resnet_program(amp)
        feed = _resnet_feed(4, 4, (16, 8, 8), seed=1)
        n_fused, what = 6, "toy (2 bottleneck blocks, 16 filters) batch-4"
        tol = AMP_SMALL_LOSS_RTOL if amp else RESNET_TOY_LOSS_RTOL
    else:
        main, startup, loss, _ = _resnet_program(amp, **RESNET_SMALL)
        feed = _resnet_feed(RESNET_SMALL_BATCH, RESNET_SMALL["class_dim"],
                            RESNET_SMALL["image_shape"], seed=1)
        n_fused = 36
        what = f"depth-50 3x64x64 batch-{RESNET_SMALL_BATCH}"
        tol = RESNET_FUSED_LOSS_RTOL if fused else RESNET_F32_LOSS_RTOL
    scope, host_scope = Scope(), Scope()
    exe.run(startup, scope=scope, seed=7)
    for name, val in scope.items():
        host_scope.set_var(name, val.detach().cpu())
    held = ["fc_out.w@GRAD", "fc_out.b@GRAD"]
    grads = held + ([] if model == "toy" else [
        "res3_2.b2.conv.w@GRAD", "res2_0.short.conv.w@GRAD",
        "res0_0.b0.conv.w@GRAD", "stem.conv.w@GRAD"])
    fetch = [loss.name] + grads
    flags.set_flags({"FLAGS_graph_fusion": fused})
    try:
        cb.reset_launch_count()
        card = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        k3 = cb.launch_count("conv1x1_stats")
        t_c = time.perf_counter()
        host = ptt.Executor(ptt.CPUPlace()).run(main, feed=feed,
                                                fetch_list=fetch,
                                                scope=host_scope)
        host_s = time.perf_counter() - t_c
    finally:
        flags.set_flags({"FLAGS_graph_fusion": True})
    if k3 != (n_fused if fused else 0):
        raise AssertionError(f"K3 launched {k3} times in the "
                             f"{'fused' if fused else 'unfused'} step")
    loss_err = abs(float(card[0]) - float(host[0])) / abs(float(host[0]))
    if not loss_err <= tol:
        raise AssertionError(f"{what}: card loss {float(card[0])} vs host "
                             f"{float(host[0])}: rel err {loss_err} > {tol}")

    grad_err = {name: _frac_err(c, h)[0]
                for name, c, h in zip(grads, card[1:], host[1:])}
    stats = [v.name for v in main.list_vars()
             if v.name.endswith((".bn.mean", ".bn.var"))]
    stat_err = max(_frac_err(scope.find_var(n).cpu(),
                             host_scope.find_var(n))[0] for n in stats)
    # held: float32 on both sides, or AMP on the toy (at depth 50 AMP is
    # held like the fused float32 step, to the loss: see the constants)
    strict = not fused or (amp and model == "toy")
    if strict:
        g_tol = AMP_SMALL_FRAC if amp else RESNET_F32_GRAD_FRAC
        s_tol = AMP_SMALL_FRAC if amp else RESNET_F32_STAT_FRAC
        bad = {n: e for n, e in grad_err.items()
               if n in held and not e <= g_tol}
        if bad or not stat_err <= s_tol:
            raise AssertionError(
                f"{'AMP' if amp else 'unfused'} card step vs host: "
                f"classifier gradients {bad} (bound {g_tol:.3g} x max|g|), "
                f"BN running statistics {stat_err:.3g} (bound "
                f"{s_tol:.3g} x max|v|)")
    how = "fused (K3, bf16 operands)" if fused else "unfused (float32)"
    if amp:
        how = "AMP fused (K3 on bf16 x)"
    _log("amp_resnet" if amp else "resnet",
         f"{what} {how} step vs host run ({host_s:.1f} s): loss "
         f"{float(card[0]):.6f} vs {float(host[0]):.6f}, rel err "
         f"{loss_err:.3g} (rtol {tol:.3g}); {len(stats)} BN running "
         f"statistics max err / max|v| {stat_err:.3g}"
         + ("" if not strict else
            f" (bound {AMP_SMALL_FRAC if amp else RESNET_F32_STAT_FRAC:.3g})")
         + "; grads max abs err / max|g|: "
         + "; ".join(f"{n.split('@')[0]} {e:.3g}"
                     for n, e in grad_err.items())
         + ("" if not strict else
            f" (classifier's bound "
            f"{AMP_SMALL_FRAC if amp else RESNET_F32_GRAD_FRAC:.3g})")
         + f"; K3 launches {k3} ok")
    return {"loss_rel_err": loss_err, "stat_err_frac": stat_err,
            "grad_err_frac": grad_err}


def phase_resnet():
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import conv_bn as cb

    cfg = dict(class_dim=1000, depth=50, image_shape=(3, 224, 224))
    t_b = time.perf_counter()
    main, startup, loss, accs = _resnet_program(**cfg)
    types = [op.type for op in main.global_block().ops]
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=1234)
    n_params = sum(int(scope.find_var(p.name).numel())
                   for p in main.all_parameters() if p.trainable)
    _log("resnet", f"ResNet-50 training program: {len(types)} ops "
         f"({types.count('conv2d')} conv2d, {types.count('batch_norm')} "
         f"batch_norm, {types.count('momentum')} momentum), "
         f"{n_params / 1e6:.2f} M trainable parameters on {exe.device}; "
         f"built in {time.perf_counter() - t_b:.1f} s")
    feed = _resnet_feed(RESNET_BATCH, cfg["class_dim"], cfg["image_shape"])
    fetch = [loss, accs[0], accs[1]]

    # the main path, counted: a warm-up step and the timed steps
    cb.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # earlier phases' and the weights
    t_w = time.perf_counter()
    out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    warm_s = time.perf_counter() - t_w
    per_step = [cb.launch_count()]
    losses, acc1 = [float(out[0])], [float(out[1])]
    step_s = []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(cb.launch_count() - sum(per_step))
        losses.append(float(out[0]))
        acc1.append(float(out[1]))
    launches = cb.launch_count()
    peak = torch.cuda.max_memory_allocated()
    plan = _train_plan(exe)
    shapes = _fused_shapes(plan)
    ftypes = [op.type for op, _ in plan.ops]
    step_ms = 1e3 * float(np.mean(step_s))
    _log("resnet", f"batch {RESNET_BATCH} x 3x224x224 float32: fused plan "
         f"of {len(ftypes)} ops (36 fused_conv1x1_bn + 36 grads, "
         f"{ftypes.count('conv2d')} conv2d left); warm-up step "
         f"{warm_s:.2f} s, then {RESNET_STEPS} steps of "
         f"{', '.join(f'{1e3 * x:.1f}' for x in step_s)} ms; losses "
         f"{', '.join(f'{x:.4f}' for x in losses)}; top-1 acc "
         f"{acc1[0]:.3f} -> {acc1[-1]:.3f}; K3 launches {per_step} = "
         f"{launches}; peak memory {peak / 2**30:.2f} GiB, of which "
         f"{held / 2**30:.2f} GiB allocated before the first step")
    if len(shapes) != 36 or ftypes.count("fused_conv1x1_bn_grad") != 36:
        raise AssertionError(f"the fusion pass gave {len(shapes)} fused ops "
                             f"and {ftypes.count('fused_conv1x1_bn_grad')} "
                             "fused grads, expected 36 and 36")
    if per_step != [36] * (RESNET_STEPS + 1):
        raise AssertionError(f"K3 launches per step {per_step}, expected 36 "
                             f"in each of {RESNET_STEPS + 1} steps")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"ResNet losses not finite and falling: "
                             f"{losses}")
    small = {"toy_fused": _resnet_small_check(exe, "toy", True),
             "fused": _resnet_small_check(exe, "depth50", True),
             "unfused": _resnet_small_check(exe, "depth50", False)}
    return {"launches": launches, "per_step": per_step, "losses": losses,
            "step_ms": step_ms, "step_s": step_s, "warmup_s": warm_s,
            "images_per_s": RESNET_BATCH / (step_ms / 1e3),
            "peak_bytes": peak, "held_bytes": held, "shapes": shapes,
            "small": small,
            "main": main, "fetch": fetch, "scope": scope, "feed": feed}


def phase_amp_resnet():
    """ResNet-50 under ``amp.decorate(MomentumOptimizer(0.1, 0.9))``
    (bench.py:189) at batch 256 (bench.py:182), 3x224x224: the fusion pass
    rewrites the 36 conv1x1 + BN pairs, and every step launches the bf16
    K3 36 times (bf16 x, float32 master w) and no float32 form; one
    warm-up and 5 timed steps on one fixed batch, finite, falling losses,
    every parameter float32.  Then one AMP step on the card against the
    host: the toy (loss, BN running statistics and classifier gradients)
    and depth 50 at 3x64x64 (the loss; see the constants)."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import conv_bn as cb

    cfg = dict(class_dim=1000, depth=50, image_shape=(3, 224, 224))
    main, startup, loss, accs = _resnet_program(True, **cfg)
    assert main._attrs.get("amp") is True
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=1234)
    batch = AMP_BATCH_RESNET
    feed = _resnet_feed(batch, cfg["class_dim"], cfg["image_shape"])
    fetch = [loss, accs[0], accs[1]]

    # the main path, counted: a warm-up step and the timed steps
    cb.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    per_step, losses, step_s = [], [], []
    prev = (0, 0)
    for _ in range(RESNET_STEPS + 1):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        now = (cb.launch_count("conv1x1_stats", "bfloat16"),
               cb.launch_count("conv1x1_stats", "float32"))
        per_step.append((now[0] - prev[0], now[1] - prev[1]))
        prev = now
        losses.append(float(out[0]))
    launches = cb.launch_count("conv1x1_stats", "bfloat16")
    peak = torch.cuda.max_memory_allocated()
    warm_s = step_s.pop(0)
    plan = _train_plan(exe)
    shapes = _fused_shapes(plan)
    if len(shapes) != 36 or per_step != [(36, 0)] * (RESNET_STEPS + 1):
        raise AssertionError(f"amp_resnet: {len(shapes)} fused ops, (bf16, "
                             f"float32) K3 launches per step {per_step}, "
                             f"expected 36 and (36, 0)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"amp_resnet losses not finite and falling: "
                             f"{losses}")
    not_f32 = [p.name for p in main.all_parameters()
               if scope.find_var(p.name).dtype != torch.float32]
    if not_f32:
        raise AssertionError(f"amp_resnet: parameters not float32: "
                             f"{not_f32}")
    step_ms = 1e3 * float(np.mean(step_s))
    _log("amp_resnet", f"batch {batch} x 3x224x224 bf16 AMP: fused plan of "
         f"{len(plan.ops)} ops; warm-up step {warm_s:.2f} s, then "
         f"{RESNET_STEPS} steps of "
         f"{', '.join(f'{1e3 * x:.1f}' for x in step_s)} ms; losses "
         f"{', '.join(f'{x:.4f}' for x in losses)}; bf16 K3 launches "
         f"{[n for n, _ in per_step]} = {launches}, float32 0; "
         f"{len(main.all_parameters())} parameters float32; peak memory "
         f"{peak / 2**30:.2f} GiB, of which {held / 2**30:.2f} GiB "
         f"allocated before the first step")
    small = {"toy": _resnet_small_check(exe, "toy", True, amp=True),
             "depth50": _resnet_small_check(exe, "depth50", True, amp=True)}
    return {"launches": launches, "per_step": per_step, "losses": losses,
            "step_ms": step_ms, "step_s": step_s, "warmup_s": warm_s,
            "images_per_s": batch / (step_ms / 1e3), "peak_bytes": peak,
            "held_bytes": held, "shapes": shapes, "small": small,
            "main": main, "fetch": fetch, "scope": scope, "feed": feed}


def _reset_launches():
    """Every kernel's launch counter to 0."""
    for name in _KERNEL_MODULES:
        _kernel_module(name).reset_launch_count()


def _predict_k1(smi, pred_ids_shape):
    """The biased float32 K1 at the predictor's shape ([b*h, T, 64] with
    the in-graph causal mask as a [1, T, T] bias) against its plain
    version, then the three timed: the kernel, the plain version and
    SDPA float32 with the same additive mask.  Not counted in the path's
    launches (the counters are reset before the path runs)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    cfg = _gpt_cfg()
    b, t = pred_ids_shape
    bh, d = b * cfg.n_head, cfg.d_model // cfg.n_head
    g = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = (torch.randn(bh, t, d, device="cuda", generator=g)
               for _ in range(3))
    bias = torch.triu(torch.full((t, t), -1e9, device="cuda"),
                      diagonal=1)[None]
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, bias, False, scale)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, bias, False,
                                                  scale)
    err = _check("flash_attn_fwd biased (predict)", o, o_ref)
    _check("flash_attn_fwd biased lse (predict)", lse, lse_ref)
    ms = _held_ms(lambda: fa.flash_attention_fwd(q, k, v, bias, False,
                                                 scale))
    plain_ms = _held_ms(lambda: fa.flash_attention_reference(
        q, k, v, bias, False, scale))
    q4, k4, v4 = (x.view(b, cfg.n_head, t, d) for x in (q, k, v))
    lib_ms = _held_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=bias[0], scale=scale))
    flops = 4 * bh * t * t * d
    nbytes = 4 * (4 * bh * t * d + t * t + bh * t)
    bound_ms, bound_by, how = _bound(flops, nbytes, "float32_split")
    _log("predict", f"{smi}: biased float32 K1 at [{bh}, {t}, {d}] with a "
         f"[1, {t}, {t}] bias: max abs err {err:.3g} vs plain; {ms:.4f} ms "
         f"(plain {plain_ms:.3f}, SDPA float32 with the mask "
         f"{lib_ms:.4f}; bound {bound_ms:.4f} by {bound_by}: {how})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def _predict_gpt(smi, serve, tmp):
    """The GPT serving artifact through the predictor (see phase_predict)."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import inference as inf
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.framework.function import program_as_function
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import transformer as T

    cfg = _gpt_cfg()
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, logits = T.build_gpt_serving(cfg, PREDICT_SEQ, attn_impl="base")
    path = os.path.join(tmp, "gpt")
    t0 = time.perf_counter()
    ptt.save_inference_model(path, ["src_ids"], [logits], None,
                             main_program=main, scope=serve["scope"])
    save_s = time.perf_counter() - t0
    ctr = inf.api._ENGINE_CTR
    hits, misses = ctr.value(cache="hit"), ctr.value(cache="miss")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pred = inf.create_paddle_predictor(inf.AnalysisConfig(path))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ops = pred.program.global_block().ops
    types = [op.type for op in ops]
    flash = [op for op in ops if op.type == "flash_attention"]
    n_fc = types.count("fc")
    if len(flash) != cfg.n_layer or "softmax" in types or any(
            not op.input("Bias") or op.attrs["causal"] for op in flash):
        raise AssertionError(
            f"predict: the analyzed GPT holds {len(flash)} flash_attention "
            f"ops (want {cfg.n_layer}, each with the mask as Bias), "
            f"softmax {types.count('softmax')}")
    if pred.device.type != "cuda" or any(
            t.device.type != "cuda" for t in pred._params.values()):
        raise AssertionError("predict: the predictor's params are not on "
                             "the card")
    rng = np.random.RandomState(17)
    ids = rng.randint(1, cfg.vocab_size,
                      (PREDICT_BATCH, PREDICT_SEQ)).astype(np.int64)
    feed = [inf.PaddleTensor(ids, name="src_ids")]

    # the main path, counted: a warm-up run, then the timed runs (host in,
    # host out), then zero-copy runs (the logits stay on the card)
    _reset_launches()
    per_run, run_s, zc_s = [], [], []

    def counted(fn):
        before = fa.launch_count("flash_attn_fwd", "float32")
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        per_run.append(fa.launch_count("flash_attn_fwd", "float32")
                       - before)
        return out, dt

    out, _ = counted(lambda: pred.run(feed)[0].as_ndarray())
    for _ in range(PREDICT_RUNS):
        out, dt = counted(lambda: pred.run(feed)[0].as_ndarray())
        run_s.append(dt)
    pred.get_input_tensor("src_ids").copy_from_cpu(ids)
    for _ in range(PREDICT_RUNS):
        _, dt = counted(pred.zero_copy_run)
        zc_s.append(dt)
    launches = fa.launch_count("flash_attn_fwd", "float32")
    others = {n: c for n, c in _launches_nonzero().items()
              if n != "flash_attn_fwd"}
    peak = torch.cuda.max_memory_allocated()
    zc = pred.get_output_tensor(pred.get_output_names()[0]).copy_to_cpu()
    if per_run != [cfg.n_layer] * (2 * PREDICT_RUNS + 1) or others or \
            fa.launch_count("flash_attn_fwd", "bfloat16"):
        raise AssertionError(f"predict: K1 launches a run {per_run} "
                             f"(want {cfg.n_layer} each), other kernels "
                             f"{others}")
    if out.shape != (PREDICT_BATCH, PREDICT_SEQ, cfg.vocab_size) or \
            not np.isfinite(out).all() or not np.array_equal(out, zc):
        raise AssertionError(f"predict: logits {out.shape}, finite "
                             f"{np.isfinite(out).all()}, zero-copy equal "
                             f"{np.array_equal(out, zc)}")

    # the same analyzed program on the host, one sequence (plain versions)
    host_fn = program_as_function(pred.program, pred.feed_names,
                                  pred.fetch_names)
    t0 = time.perf_counter()
    ref = host_fn({n: v.cpu() for n, v in pred._params.items()},
                  ids[:1])[0].numpy()[0]
    host_s = time.perf_counter() - t0
    err = np.abs(out[0] - ref)
    if not (err <= SERVE_ATOL + SERVE_RTOL * np.abs(ref)).all():
        raise AssertionError(f"predict: logits differ from the host run of "
                             f"the analyzed program: max abs {err.max()}")

    # the native predictor (dense chain, exact GELU): recorded, not held
    _reset_launches()
    native = inf.NativePaddlePredictor(inf.AnalysisConfig(path))
    native.run(feed)
    nat_s = []
    for _ in range(PREDICT_RUNS):
        t = time.perf_counter()
        nat = native.run(feed)[0].as_ndarray()
        nat_s.append(time.perf_counter() - t)
    nat_k1 = fa.launch_count("flash_attn_fwd")
    nat_err = float(np.abs(nat - out).max())
    second = inf.create_paddle_predictor(inf.AnalysisConfig(path))
    hit, miss = ctr.value(cache="hit") - hits, ctr.value(cache="miss") - \
        misses
    if second._engine is not pred._engine or (hit, miss) != (1, 2):
        raise AssertionError(f"predict: engine cache hit {hit} miss {miss}"
                             f" (want 1 and 2: analysis, native)")
    peak = max(peak, torch.cuda.max_memory_allocated())
    ms = [1e3 * x for x in run_s]
    zms = [1e3 * x for x in zc_s]
    nms = [1e3 * x for x in nat_s]
    _log("predict", f"{smi}: GPT serving artifact (seq {PREDICT_SEQ}, "
         f"attn_impl base) saved in {save_s:.2f} s; load + analysis passes "
         f"{load_s:.2f} s (host): {len(flash)} flash_attention (Bias: the "
         f"in-graph mask), {n_fc} fc, {len(types)} ops; passes "
         f"{ {k: v for k, v in pred.pass_counts.items() if v} }")
    _log("predict", f"{smi}: batch {PREDICT_BATCH} x {PREDICT_SEQ}: run "
         f"(ids in, logits out to the host) {', '.join(f'{x:.1f}' for x in ms)}"
         f" ms; zero_copy_run (logits kept on the card) "
         f"{', '.join(f'{x:.1f}' for x in zms)} ms; K1 launches a run "
         f"{per_run} = {launches}, no other kernel; peak memory "
         f"{peak / 2**30:.2f} GiB, {held / 2**30:.2f} GiB held before")
    _log("predict", f"sequence 0 vs the host run of the analyzed program "
         f"({host_s:.1f} s): max abs err {err.max():.3g} (atol {SERVE_ATOL}"
         f", rtol {SERVE_RTOL}) ok; NativePaddlePredictor (dense chain, "
         f"exact GELU, K1 launches {nat_k1}): "
         f"{', '.join(f'{x:.1f}' for x in nms)} ms a run, max |logit "
         f"delta| {nat_err:.3g} (not held); engine cache hit {hit} miss "
         f"{miss}")
    del pred, native, second
    inf.clear_engine_cache()
    torch.cuda.empty_cache()
    return {"launches": launches, "per_run": per_run, "run_ms": ms,
            "zero_copy_ms": zms, "native_ms": nms, "load_s": load_s,
            "save_s": save_s, "host_err": float(err.max()),
            "native_err": nat_err, "native_k1": nat_k1, "n_fc": n_fc,
            "n_flash": len(flash), "peak_bytes": peak, "held_bytes": held}


def _predict_resnet(smi, resnet, tmp):
    """ResNet-50 inference through the predictor (see phase_predict)."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import inference as inf
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    from paddle_tpu_torch.models import resnet as rn

    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("image", shape=[3, 224, 224], dtype="float32")
        probs = rn.resnet(img, class_dim=1000, depth=50, is_test=True)
    # the classifier's logits, the softmax's input, are fetched too
    sm, = [op for op in main.global_block().ops if op.type == "softmax"]
    logits = main.global_block().var(sm.input("X")[0])
    scope = resnet["scope"]
    need = [v.name for v in main.list_vars() if v.persistable]
    if any(scope.find_var(n) is None for n in need):
        # the trained scope's names differ: seeded weights instead
        scope = Scope()
        ptt.Executor().run(startup, scope=scope, seed=1234)
        origin = "seeded weights"
    else:
        origin = "the resnet phase's trained scope (BN statistics moved)"
    path = os.path.join(tmp, "resnet50")
    ptt.save_inference_model(path, ["image"], [probs, logits], None,
                             main_program=main, scope=scope)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = inf.create_paddle_predictor(inf.AnalysisConfig(path))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    native = inf.NativePaddlePredictor(inf.AnalysisConfig(path))
    types = [op.type for op in pred.program.global_block().ops]
    n_fold = pred.pass_counts["conv_bn_fuse_count"]
    n_fusion = types.count("conv2d_fusion")
    if n_fold != 53 or "batch_norm" in types:
        raise AssertionError(f"predict: conv_bn_fuse_count {n_fold} "
                             f"(want 53), batch_norm left "
                             f"{types.count('batch_norm')}")
    xs = np.random.RandomState(23).rand(
        PREDICT_RESNET_BATCH, 3, 224, 224).astype(np.float32)
    feed = [inf.PaddleTensor(xs, name="image")]
    _reset_launches()
    times = {}
    outs = {}
    for name, p in (("analysis", pred), ("native", native)):
        p.run(feed)
        times[name] = []
        for _ in range(PREDICT_RUNS):
            t = time.perf_counter()
            outs[name] = [o.as_ndarray() for o in p.run(feed)]
            times[name].append(1e3 * (time.perf_counter() - t))
    moved = _launches_nonzero()
    (got, got_l), (want, want_l) = outs["analysis"], outs["native"]
    err = np.abs(got - want)
    ok = err <= PREDICT_RESNET_ATOL + PREDICT_RESNET_RTOL * np.abs(want)
    l_err = float(np.abs(got_l - want_l).max() / np.abs(want_l).max())
    if got.shape != (PREDICT_RESNET_BATCH, 1000) or not ok.all() or \
            not l_err <= PREDICT_LOGIT_FRAC or moved:
        raise AssertionError(
            f"predict: ResNet-50 analysis vs native on the card: shape "
            f"{got.shape}, probabilities max abs err {err.max()} (atol "
            f"{PREDICT_RESNET_ATOL}, rtol {PREDICT_RESNET_RTOL}), logits "
            f"max err / max|logit| {l_err} (bound {PREDICT_LOGIT_FRAC}); "
            f"kernels launched {moved}")
    agree = float((got.argmax(1) == want.argmax(1)).mean())
    _log("predict", f"{smi}: ResNet-50 inference over {origin}, batch "
         f"{PREDICT_RESNET_BATCH} x 3x224x224 float32, TF32 off: load + "
         f"passes {load_s:.2f} s (host); conv_bn_fuse_count {n_fold}, "
         f"conv2d_fusion {n_fusion}, fused_elemwise_activation "
         f"{types.count('fused_elemwise_activation')}, {len(types)} ops "
         f"(native {len(native.program.global_block().ops)}); run "
         f"{', '.join(f'{x:.1f}' for x in times['analysis'])} ms, native "
         f"{', '.join(f'{x:.1f}' for x in times['native'])} ms; "
         f"vs native: logits max err / max|logit| {l_err:.3g} (max|logit| "
         f"{np.abs(want_l).max():.3g}, bound {PREDICT_LOGIT_FRAC:.3g}), "
         f"probabilities max abs err {err.max():.3g} (atol "
         f"{PREDICT_RESNET_ATOL}, rtol {PREDICT_RESNET_RTOL}), top-1 "
         f"agreement {agree:.3f}; no kernel launched")
    del pred, native
    inf.clear_engine_cache()
    torch.cuda.empty_cache()
    return {"load_s": load_s, "conv_bn_fuse_count": n_fold,
            "conv2d_fusion": n_fusion, "run_ms": times["analysis"],
            "native_ms": times["native"], "max_abs_err": float(err.max()),
            "logit_err_frac": l_err,
            "top1_agreement": agree, "weights": origin}


def _predict_train_pass(smi):
    """``conv_bn_train_fuse_pass`` on the toy's training program (see
    phase_predict)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import conv_bn as cb

    main, startup, loss = _toy_resnet_program(
        passes=("conv_bn_train_fuse_pass",))
    plain, plain_startup, plain_loss = _toy_resnet_program()
    types = [op.type for op in main.global_block().ops]
    if types.count("fused_conv1x1_bn") != 6:
        raise AssertionError(f"predict: the pass gave "
                             f"{types.count('fused_conv1x1_bn')} "
                             f"fused_conv1x1_bn, want 6")
    feed = _resnet_feed(4, 4, (16, 8, 8), seed=1)
    exe = ptt.Executor()
    scopes = {k: Scope() for k in ("fused", "plain")}
    exe.run(startup, scope=scopes["fused"], seed=7)
    exe.run(plain_startup, scope=scopes["plain"], seed=7)
    for n, v in scopes["fused"].items():      # the same weights in both
        if scopes["plain"].find_var(n) is not None:
            scopes["plain"].set_var(n, v.clone())
    losses = {"fused": [], "plain": []}
    flags.set_flags({"FLAGS_graph_fusion": False})
    try:
        _reset_launches()
        for _ in range(PREDICT_TRAIN_STEPS):
            losses["fused"].append(float(exe.run(
                main, feed=feed, fetch_list=[loss],
                scope=scopes["fused"])[0]))
        launches = cb.launch_count("conv1x1_stats", "float32")
        others = {n: c for n, c in _launches_nonzero().items()
                  if n != "conv1x1_stats"}
        for _ in range(PREDICT_TRAIN_STEPS):
            losses["plain"].append(float(exe.run(
                plain, feed=feed, fetch_list=[plain_loss],
                scope=scopes["plain"])[0]))
    finally:
        flags.set_flags({"FLAGS_graph_fusion": True})
    errs = [abs(f - p) / abs(p) for f, p in zip(losses["fused"],
                                                losses["plain"])]
    if launches != 6 * PREDICT_TRAIN_STEPS or others or \
            not max(errs) <= RESNET_TOY_LOSS_RTOL:
        raise AssertionError(
            f"predict: conv_bn_train_fuse_pass: K3 launches {launches} "
            f"(want {6 * PREDICT_TRAIN_STEPS}), others {others}; losses "
            f"{losses} rel err {max(errs)} (rtol {RESNET_TOY_LOSS_RTOL})")
    _log("predict", f"{smi}: toy training program through apply_passes("
         f"conv_bn_train_fuse_pass) before minimize, graph fusion off: 6 "
         f"fused_conv1x1_bn, K3 launches {launches} over "
         f"{PREDICT_TRAIN_STEPS} steps; losses "
         f"{', '.join(f'{x:.6f}' for x in losses['fused'])} vs the "
         f"unrewritten program's "
         f"{', '.join(f'{x:.6f}' for x in losses['plain'])}: rel err max "
         f"{max(errs):.3g} (rtol {RESNET_TOY_LOSS_RTOL:.3g}) ok")
    return {"launches": launches, "losses": losses, "loss_rel_err": errs}


def phase_predict(smi, serve, resnet):
    """The inference engine on the card: the GPT serving artifact through
    ``AnalysisPredictor`` (attention_fuse_pass onto the biased K1),
    ResNet-50 inference through conv_bn_fuse_pass, and
    conv_bn_train_fuse_pass on a training program (K3)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_predict_")
    try:
        gpt = _predict_gpt(smi, serve, tmp)
        k1 = _predict_k1(smi, (PREDICT_BATCH, PREDICT_SEQ))
        rn = _predict_resnet(smi, resnet, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    train = _predict_train_pass(smi)
    return {"gpt": gpt, "biased_k1": k1, "resnet": rn, "train_pass": train,
            "launches": gpt["launches"],
            "train_pass_launches": train["launches"]}


def _profile_rows(prof):
    """(device ms, count, name) of every kernel and copy on the card; host
    ops (aten, autograd nodes, Function records) only aggregate these."""
    rows = []
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(evt, "device_time_total", None)
        if dev is None:
            dev = getattr(evt, "cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    return rows


def phase_profile(serve):
    """Device time of one full bucket-2048 batch (8 x 2048 tokens) by
    kernel, with ``torch.profiler``: where a batch's time goes."""
    import torch
    import paddle_tpu_torch as ptt
    from torch.profiler import ProfilerActivity, profile
    prog, _, fetch = serve["factory"](2048)
    exe = ptt.Executor()
    feed = {"src_ids": np.random.RandomState(3).randint(
        1, 30522, (8, 2048)).astype(np.int64)}
    exe.run(prog, feed=feed, fetch_list=fetch, scope=serve["scope"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        h, = exe.run(prog, feed=feed, fetch_list=fetch,
                     scope=serve["scope"], return_numpy=False)
        t1 = time.perf_counter()
        h.numpy()
        t2 = time.perf_counter()
    rows = _profile_rows(prof)
    copy_ms = sum(r[0] for r in rows if r[2].startswith("Memcpy"))
    kernel_ms = sum(r[0] for r in rows) - copy_ms
    wall_ms = (t2 - t0) * 1e3
    _log("profile", f"bucket-2048 batch of 8: wall {wall_ms:.1f} ms "
         f"(dispatch {1e3 * (t1 - t0):.1f} ms, fetch to host "
         f"{1e3 * (t2 - t1):.1f} ms); on the card: kernels {kernel_ms:.1f} "
         f"ms ({100 * kernel_ms / wall_ms:.1f}% of wall), copies "
         f"{copy_ms:.1f} ms")
    for ms, count, key in rows[:12]:
        _log("profile", f"  {ms:9.2f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "dispatch_ms": 1e3 * (t1 - t0),
            "fetch_ms": 1e3 * (t2 - t1), "kernel_ms": kernel_ms,
            "copy_ms": copy_ms,
            "top": rows[:20]}


def phase_resnet_profile(resnet, what="", batch=RESNET_BATCH):
    """Device time of one ResNet-50 step (``what``: "AMP " for the AMP
    program, at ``batch``) by kernel class, with ``torch.profiler``; the
    Momentum ops are marked with a ``record_function`` range, whose device
    total is their kernels'."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import registry
    from torch.profiler import ProfilerActivity, profile, record_function
    exe = ptt.Executor()
    args = dict(feed=resnet["feed"], fetch_list=resnet["fetch"],
                scope=resnet["scope"])
    exe.run(resnet["main"], **args)
    torch.cuda.synchronize()
    info = registry.get_op_info("momentum")
    lower = info.lower

    def marked(ctx, ins, attrs):
        with record_function("momentum_op"):
            return lower(ctx, ins, attrs)

    info.lower = marked
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            exe.run(resnet["main"], **args)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        info.lower = lower
    # the range's own GPU-side row is a span, not a kernel: leave it out
    rows = [r for r in _profile_rows(prof) if r[2] != "momentum_op"]
    momentum_ms = sum(
        (getattr(e, "device_time_total", None) or
         getattr(e, "cuda_time_total", 0.0)) / 1e3
        for e in prof.key_averages() if e.key == "momentum_op"
        and not str(getattr(e, "device_type", "")).endswith("CUDA"))
    classes = {"K3 (conv1x1_stats)": 0.0, "cuDNN convolutions": 0.0,
               "GEMMs": 0.0, "copies": 0.0, "casts": 0.0,
               "BN, elementwise, reductions, Momentum": 0.0}
    for ms, _, key in rows:
        k = key.lower()
        if any(t in k for t in ("conv1x1_stats", "stats_kernel",
                                "conv_tma_kernel", "conv_gather_kernel",
                                "conv_f32_kernel", "round_w_kernel")):
            cls = "K3 (conv1x1_stats)"
        elif k.startswith("memcpy") or k.startswith("memset"):
            cls = "copies"
        elif any(t in k for t in ("conv", "cudnn", "xmma", "dgrad", "wgrad",
                                  "fprop", "winograd", "implicit")):
            cls = "cuDNN convolutions"
        elif "gemm" in k or "cutlass" in k:
            cls = "GEMMs"
        elif "copy_kernel" in k:
            cls = "casts"
        else:
            cls = "BN, elementwise, reductions, Momentum"
        classes[cls] += ms
    kernel_ms = sum(v for c, v in classes.items() if c != "copies")
    _log("profile", f"{what}ResNet-50 step, batch {batch}: wall "
         f"{wall_ms:.1f} ms; kernels {kernel_ms:.1f} ms "
         f"({100 * kernel_ms / wall_ms:.1f}% of wall)")
    for cls, ms in classes.items():
        _log("profile", f"  {ms:9.2f} ms  {cls}")
    _log("profile", f"  of which Momentum's ops {momentum_ms:.2f} ms")
    for ms, count, key in rows[:24]:
        _log("profile", f"  {ms:9.2f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "classes": classes,
            "momentum_ms": momentum_ms, "top": rows[:40]}


def _profile_step(label, step):
    """Device time of one call of ``step`` (a full training step; one call
    before it warms up) by kernel class, with ``torch.profiler``: where a
    step's time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = _profile_rows(prof)
    kernel_ms = sum(r[0] for r in rows if not r[2].startswith("Memcpy"))
    # kernel classes by name: the port's kernels, cuBLAS, PyTorch's dtype
    # casts (AMP), the rest (elementwise, reductions, Adam)
    classes = dict.fromkeys(("K1", "K2", "K1/K2 float32 split pass",
                             "K4, K5", "K7 merge", "dropout", "GEMMs",
                             "casts", "elementwise, reductions, Adam"), 0.0)
    for ms, _, key in rows:
        k = key.lower()
        if k.startswith(("memcpy", "memset")):
            continue
        cls = ("K1" if "flash_fwd" in k else "K2" if "flash_bwd" in k
               else "K1/K2 float32 split pass" if "split_planes" in k
               else "K4, K5" if any(t in k for t in (
                   "ln_fwd", "ln_bwd", "colsum", "dense_act", "round_pad"))
               else "K7 merge" if "ring_merge" in k
               else "dropout" if "dropout_kernel" in k
               else "GEMMs" if any(t in k for t in (
                   "gemm", "cutlass", "nvjet", "xmma"))
               else "casts" if "copy_kernel" in k
               else "elementwise, reductions, Adam")
        classes[cls] += ms
    _log("profile", f"{label}: wall {wall_ms:.1f} ms; kernels "
         f"{kernel_ms:.1f} ms ({100 * kernel_ms / wall_ms:.1f}% of wall): "
         + ", ".join(f"{c} {ms:.1f}" for c, ms in classes.items()))
    for ms, count, key in rows[:24]:
        _log("profile", f"  {ms:9.2f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "classes": classes,
            "top": rows[:40]}


def phase_train_profile(train, what=""):
    """One full-width GPT training step (``what``: "AMP " for the AMP
    program) by kernel class."""
    import paddle_tpu_torch as ptt
    exe = ptt.Executor()
    args = dict(feed=train["feed"], fetch_list=[train["loss"]],
                scope=train["scope"])
    return _profile_step(
        f"{what}training step, batch {TRAIN_BATCH} x seq 2048",
        lambda: exe.run(train["main"], **args))


def _held_ms(fn, reps=3):
    """ms a call of ``fn`` on the card alone: the best of ``reps`` rounds
    of ``timing.time_held`` after a warm call.  For calls whose host side
    (wrapper, allocations, autograd) takes about as long as their kernels:
    a run of calls timed with events would time the host's gaps."""
    from paddle_tpu_torch.tools.timing import time_held
    fn()
    return 1e3 * min(time_held(fn)[0] for _ in range(reps))


def _bound(flops, nbytes, kind="float32"):
    import torch
    from paddle_tpu_torch.tools.timing import F32_TERM_PRODUCTS
    peak_flops, peak_bw = _peaks(torch.cuda.get_device_name(0), kind)
    t_ops, t_mem = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    rate = (f"float32 as {F32_TERM_PRODUCTS} bf16 term products"
            if kind == "float32_split" else kind)
    return (max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes",
            f"{flops / 1e9:.1f} GFLOP at {peak_flops / 1e12:.1f} TFLOP/s "
            f"{rate}, {nbytes / 1e6:.0f} MB at {peak_bw / 1e12:.2f} TB/s")


def timing_k3(smi, resnet):
    """K3 at each of ResNet-50's 15 shapes at the training batch: kernel,
    plain version, one library composition (a bf16 ``torch.matmul`` of the
    cast operands plus the two float32 reductions) and the bound (x, w, y
    and the stats moved once in float32; 2*N*P*Cin*Cout bf16 products at
    the tensor-core rate); then the per-step sums over the 36 launches.
    ``ms`` and ``library_ms`` are runs of event-timed calls, as in earlier
    runs; ``held_ms`` and ``library_held_ms`` the card alone
    (``_held_ms``), without the wrapper's host gaps."""
    import torch
    from paddle_tpu_torch.kernels import conv_bn as cb
    from paddle_tpu_torch.tools.timing import time_fn
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    counts = {sh: resnet["shapes"].count(sh) for sh in K3_SHAPES}
    if sum(counts.values()) != 36:
        raise AssertionError(f"fused shapes {resnet['shapes']} are not "
                             "ResNet-50's")
    n = RESNET_BATCH
    rows, totals = [], dict.fromkeys(("ms", "held_ms", "plain_ms",
                                      "library_ms", "library_held_ms",
                                      "bound_ms"), 0.0)
    by_bytes = 0.0          # the part of the summed bound set by bytes
    for ci, co, p in K3_SHAPES:
        x = torch.randn(n, ci, p, device="cuda", generator=g)
        w = torch.randn(co, ci, device="cuda", generator=g) * ci ** -0.5

        def library():
            y = torch.matmul(w.to(torch.bfloat16), x.to(torch.bfloat16))
            yf = y.float()
            return yf.sum(dim=(0, 2)), (yf * yf).sum(dim=(0, 2))

        ms = 1e3 * time_fn(lambda: cb.conv1x1_stats_fwd(x, w), iters=10)
        held_ms = _held_ms(lambda: cb.conv1x1_stats_fwd(x, w))
        plain_ms = 1e3 * time_fn(lambda: cb.conv1x1_stats_plain(x, w),
                                 iters=3)
        library_ms = 1e3 * time_fn(library, iters=10)
        library_held_ms = _held_ms(library)
        flops = 2.0 * n * p * ci * co
        nbytes = 4.0 * (n * ci * p + co * ci + n * co * p + 2 * co)
        bound_ms, bound_by, why = _bound(flops, nbytes, "bfloat16")
        k = counts[(ci, co, p)]
        by_bytes += k * bound_ms if bound_by == "bytes" else 0.0
        route = cb.f32_route(p)
        rows.append({"shape": [n, ci, co, p], "per_step": k, "ms": ms,
                     "held_ms": held_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "library_held_ms": library_held_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "tflops": flops / ms / 1e9, "route": route})
        for key, val in (("ms", ms), ("held_ms", held_ms),
                         ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("library_held_ms", library_held_ms),
                         ("bound_ms", bound_ms)):
            totals[key] += k * val
        _log("timing", f"conv1x1_stats [{n}, {ci}, {p}] x [{co}, {ci}] "
             f"(x{k} a step, x by {route}) on {smi}: kernel {ms:.4f} ms "
             f"({flops / ms / 1e9:.1f} TFLOP/s; {held_ms:.4f} alone), plain "
             f"{plain_ms:.4f} ms, bf16 matmul + sums {library_ms:.4f} ms "
             f"({library_held_ms:.4f} alone); bound {bound_ms:.4f} ms by "
             f"{bound_by} ({why}): {100 * bound_ms / ms:.1f}% of bound "
             f"({100 * bound_ms / held_ms:.1f}% alone)")
        del x, w
    _log("timing", f"conv1x1_stats per ResNet-50 step (36 launches) on "
         f"{smi}: kernel {totals['ms']:.3f} ms ({totals['held_ms']:.3f} "
         f"alone), plain {totals['plain_ms']:.3f} ms, bf16 matmul + sums "
         f"{totals['library_ms']:.3f} ms ({totals['library_held_ms']:.3f} "
         f"alone), bound {totals['bound_ms']:.3f} ms"
         f" ({100 * totals['bound_ms'] / totals['ms']:.1f}% of bound, "
         f"{100 * totals['bound_ms'] / totals['held_ms']:.1f}% alone)")
    _log("timing", f"resnet on {smi}: step {resnet['step_ms']:.1f} ms (mean "
         f"of {RESNET_STEPS}), {resnet['images_per_s']:.1f} images/s, K3 "
         f"{100 * totals['ms'] / resnet['step_ms']:.1f}% of the step, peak "
         f"memory {resnet['peak_bytes'] / 2**30:.2f} GiB "
         f"({(resnet['peak_bytes'] - resnet['held_bytes']) / 2**30:.2f} GiB "
         f"above what was allocated before the first step)")
    bound_by = "bytes" if by_bytes >= totals["bound_ms"] / 2 \
        else "operations"
    return {"ms": totals["ms"], "held_ms": totals["held_ms"],
            "plain_ms": totals["plain_ms"],
            "library_ms": totals["library_ms"],
            "library_held_ms": totals["library_held_ms"],
            "bound_ms": totals["bound_ms"], "bound_by": bound_by,
            "per_shape": rows}


def phase_timing(smi, serve, train):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.tools.timing import time_fn
    bh, t, d = SLICE
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    q = torch.randn(bh, t, d, device="cuda", generator=g)
    k = torch.randn(bh, t, d, device="cuda", generator=g)
    v = torch.randn(bh, t, d, device="cuda", generator=g)
    do = torch.randn(bh, t, d, device="cuda", generator=g)
    pairs = t * (t + 1) // 2                 # live (q, k) pairs, causal
    out = {}

    # K1: q.k and p.v, 2 flops per FMA; q, k, v read, o and lse written
    ms = 1e3 * time_fn(lambda: fa.flash_attention_fwd(q, k, v, None, True),
                       iters=20)
    plain_ms = 1e3 * time_fn(
        lambda: fa.flash_attention_reference(q, k, v, None, True), iters=5)
    q4, k4, v4 = (x.view(8, 12, t, d) for x in (q, k, v))
    library_ms = 1e3 * time_fn(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        iters=20)
    # the bound at the float32 form's rate, six bf16 term products a
    # float32 product on the tensor cores; the CUDA-core rate beside it
    flops, nbytes = 4.0 * d * bh * pairs, 4.0 * (4 * bh * t * d + bh * t)
    bound_ms, bound_by, why = _bound(flops, nbytes, "float32_split")
    core_ms = _bound(flops, nbytes)[0]
    out["flash_attn_fwd"] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": library_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by}
    _log("timing", f"flash_attn_fwd [96,2048,64] causal f32 on {smi}: "
         f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
         f"sdpa {library_ms:.4f} ms ({ms / library_ms:.3f}x); bound "
         f"{bound_ms:.4f} ms by {bound_by} ({why}): "
         f"{100 * bound_ms / ms:.1f}% of bound; {core_ms:.4f} ms at the "
         f"CUDA-core float32 rate")

    # K2: S, dP, dV, dK, dQ, 2 flops per FMA each; q, k, v, o, do, lse and
    # delta read, dq, dk, dv written
    o, lse = fa.flash_attention_fwd(q, k, v, None, True)
    ms = 1e3 * time_fn(
        lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True), iters=10)
    plain_ms = 1e3 * time_fn(lambda: fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, None, True), iters=3)
    qg, kg, vg = (x.view(8, 12, t, d).detach().requires_grad_()
                  for x in (q, k, v))
    do4 = do.view(8, 12, t, d)

    def sdpa_fwd():
        with torch.enable_grad():
            return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), do4)

    library_ms = 1e3 * (time_fn(sdpa_fwd_bwd, iters=10)
                        - time_fn(sdpa_fwd, iters=10))
    flops, nbytes = 10.0 * d * bh * pairs, 4.0 * (8 * bh * t * d + 2 * bh * t)
    bound_ms, bound_by, why = _bound(flops, nbytes, "float32_split")
    core_ms = _bound(flops, nbytes)[0]
    out["flash_attn_bwd"] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": library_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by}
    _log("timing", f"flash_attn_bwd [96,2048,64] causal f32 on {smi}: "
         f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward "
         f"{library_ms:.4f} ms (forward+backward minus forward; "
         f"{ms / library_ms:.3f}x); bound {bound_ms:.4f} ms by {bound_by} "
         f"({why}): {100 * bound_ms / ms:.1f}% of bound; {core_ms:.4f} ms "
         f"at the CUDA-core float32 rate")

    per_batch = serve["launches"] / max(serve["flash_batches"], 1)
    _log("timing", f"flash launches per batch at buckets >= 1024: "
         f"{per_batch:g}")
    for b, lat in sorted(serve["per_bucket_ms"].items()):
        _log("timing", f"serve bucket {b}: {len(lat)} batches, batch "
             f"latency mean {np.mean(lat):.1f} ms (min {np.min(lat):.1f}, "
             f"max {np.max(lat):.1f})")
    _log("timing", f"serve: {serve['requests']} requests, "
         f"{serve['tokens']} tokens in {serve['wall_s']:.2f} s: "
         f"{serve['requests'] / serve['wall_s']:.2f} req/s, "
         f"{serve['tokens'] / serve['wall_s']:.0f} tokens/s")
    _log("timing", f"train on {smi}: step {train['step_ms']:.1f} ms (mean "
         f"of {TRAIN_STEPS}), {train['tokens_per_s']:.0f} tokens/s, peak "
         f"memory {train['peak_bytes'] / 2**30:.2f} GiB")
    return out


def timing_k45(smi, train, fused):
    """K5 at [16384, 768] x [768, 3072] with gelu and K4 forward and
    backward at [16384, 768], the fused path's shapes: kernel, plain
    version, one library composition and the bound; then the fused
    training step next to the plain one."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import dense_epilogue as de
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.tools.k4_k7_compare import cold_ms
    from paddle_tpu_torch.tools.timing import time_fn
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    rows, d, n = TRAIN_BATCH * 2048, 768, 3072
    per_step = fused["per_step"][-1]          # a timed step's launches
    out = {}

    # K5: 2·M·K·N bf16 products; x, w, b read and y written in float32
    x = torch.randn(rows, d, device="cuda", generator=g)
    w = torch.randn(d, n, device="cuda", generator=g) * d ** -0.5
    b = torch.randn(n, device="cuda", generator=g)
    ms = 1e3 * time_fn(lambda: de.dense_act_fwd(x, w, b, "gelu"), iters=20)
    plain_ms = 1e3 * time_fn(lambda: de.dense_act_plain(x, w, b, "gelu"),
                             iters=5)
    library_ms = 1e3 * time_fn(lambda: F.gelu(torch.matmul(
        x.to(torch.bfloat16), w.to(torch.bfloat16)).float() + b), iters=20)
    flops = 2.0 * rows * d * n
    bound_ms, bound_by, why = _bound(
        flops, 4.0 * (rows * d + d * n + n + rows * n), "bfloat16")
    out["dense_epilogue"] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": library_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by}
    _log("timing", f"dense_epilogue [{rows}, {d}] x [{d}, {n}] gelu f32 "
         f"({per_step['dense_epilogue']:g} a step) on {smi}: kernel "
         f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
         f"{plain_ms:.4f} ms, bf16 matmul + bias + gelu {library_ms:.4f} ms;"
         f" bound {bound_ms:.4f} ms by {bound_by} ({why}): "
         f"{100 * bound_ms / ms:.1f}% of bound")
    del x, w, b

    # K4: x read and y written (forward); x, dy read and dx written
    # (backward); scale, bias, dscale, dbias once each
    x = torch.randn(rows, d, device="cuda", generator=g)
    sc = torch.randn(d, device="cuda", generator=g) + 1
    bi = torch.randn(d, device="cuda", generator=g)
    dy = torch.randn(rows, d, device="cuda", generator=g)
    xg, sg, bg = (t.detach().requires_grad_() for t in (x, sc, bi))

    def lib_fwd():
        with torch.enable_grad():
            return F.layer_norm(xg, (d,), sg, bg, 1e-5)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (xg, sg, bg), dy)

    # K4's calls take about as long on the host as on the card, so every
    # column is the card's time alone (``_held_ms``); the library's backward
    # is fwd+bwd minus fwd (a run of 20 timed with events read 0.136-0.923
    # ms on an H100 80GB HBM3, 700 W: the host's enqueue gaps).  The
    # backward is also timed cold (input sets in turn, ``cold_ms``), and
    # its share of the bound uses that time
    lib_f = _held_ms(lib_fwd)
    cold_sets = [(x, dy)] + [
        (torch.randn(rows, d, device="cuda", generator=g),
         torch.randn(rows, d, device="cuda", generator=g))
        for _ in range(K4_COLD_SETS - 1)]
    for name, fn, plain, library, nbytes, flops in (
            ("layer_norm_fwd", lambda: ln.layer_norm_fwd(x, sc, bi, 1e-5),
             lambda: ln.layer_norm_fwd_plain(x, sc, bi, 1e-5), lib_f,
             4.0 * (2 * rows * d + 2 * d), 8.0 * rows * d),
            ("layer_norm_bwd", lambda: ln.layer_norm_bwd(x, sc, dy, 1e-5),
             lambda: ln.layer_norm_bwd_plain(x, sc, dy, 1e-5),
             _held_ms(lib_fwd_bwd) - lib_f,
             4.0 * (3 * rows * d + 3 * d), 16.0 * rows * d)):
        warm_ms = ms = _held_ms(fn)
        if name == "layer_norm_bwd":
            ms = cold_ms([
                lambda s=s: ln.layer_norm_bwd(s[0], sc, s[1], 1e-5)
                for s in cold_sets])
        plain_ms = _held_ms(plain)
        bound_ms, bound_by, why = _bound(flops, nbytes)
        out[name] = {"ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
                     "library_ms": library, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        lib_what = "F.layer_norm" + (" fwd+bwd minus fwd"
                                     if name.endswith("bwd") else "")
        basis = (f"cold {ms:.4f} ms ({K4_COLD_SETS} input sets in turn), "
                 f"warm {warm_ms:.4f} ms" if name == "layer_norm_bwd"
                 else f"{ms:.4f} ms")
        _log("timing", f"{name} [{rows}, {d}] f32 ({per_step[name]:g} a "
             f"step) on {smi}: kernel {basis}, plain {plain_ms:.4f} ms, "
             f"{lib_what} {library:.4f} ms; bound {bound_ms:.4f} ms by "
             f"{bound_by} ({why}): {100 * bound_ms / ms:.1f}% of bound"
             + (" cold" if name == "layer_norm_bwd" else ""))
    del cold_sets
    _log("timing", f"fused_train on {smi}: step {fused['step_ms']:.1f} ms "
         f"(mean of {TRAIN_STEPS}), {fused['tokens_per_s']:.0f} tokens/s, "
         f"peak memory {fused['peak_bytes'] / 2**30:.2f} GiB "
         f"({(fused['peak_bytes'] - fused['held_bytes']) / 2**30:.2f} GiB "
         f"above what was allocated before its first step); train: step "
         f"{train['step_ms']:.1f} ms, {train['tokens_per_s']:.0f} tokens/s, "
         f"peak {train['peak_bytes'] / 2**30:.2f} GiB "
         f"({(train['peak_bytes'] - train['held_bytes']) / 2**30:.2f} GiB "
         f"above)")
    return out


def timing_bf16(smi, amp_train, amp_fused, amp_resnet):
    """The bf16 forms of K1-K5 at the AMP paths' shapes: kernel, plain
    version, one library call or composition in bf16, and the bound (the
    bytes at the bf16 sizes over the memory rate; the operations at the
    rate of the arithmetic the kernel runs: bf16 tensor cores for K1 and K2
    (their S, dP and split P, dS products) and the K3 and K5 products,
    float32 for K4).  The libraries' autograd chains
    (SDPA's and LayerNorm's backward) are timed as slopes of two run
    lengths.  Then the three AMP paths' steps."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import conv_bn as cb
    from paddle_tpu_torch.kernels import dense_epilogue as de
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.tools.k4_k7_compare import cold_ms
    from paddle_tpu_torch.tools.timing import time_fn, time_fn_slope
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    bf16 = torch.bfloat16
    out = {}

    def row(name, ms, plain_ms, library_ms, flops, nbytes, kind, what, lib,
            warm_ms=None):
        """``ms`` is cold where ``warm_ms`` is given (the share of the
        bound uses it)."""
        bound_ms, bound_by, why = _bound(flops, nbytes, kind)
        out[name] = {"ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        basis = f"{ms:.4f} ms"
        if warm_ms is not None:
            out[name]["warm_ms"] = warm_ms
            basis = (f"cold {ms:.4f} ms (input sets in turn), warm "
                     f"{warm_ms:.4f} ms")
        _log("timing", f"{name} {what} on {smi}: kernel {basis}, plain "
             f"{plain_ms:.4f} ms, {lib} {library_ms:.4f} ms; bound "
             f"{bound_ms:.4f} ms by {bound_by} ({why}): "
             f"{100 * bound_ms / ms:.1f}% of bound"
             + (" cold" if warm_ms is not None else ""))

    # K1 and K2 at [96, 2048, 64] causal, bf16 q, k, v, o, do
    bh, t, d = SLICE
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g).to(bf16)
                   for _ in range(4))
    pairs = t * (t + 1) // 2
    q4, k4, v4 = (x.view(8, 12, t, d) for x in (q, k, v))
    row("flash_attn_fwd_bf16",
        1e3 * time_fn(lambda: fa.flash_attention_fwd(q, k, v, None, True),
                      iters=20),
        1e3 * time_fn(lambda: fa.flash_attention_reference(q, k, v, None,
                                                           True), iters=5),
        1e3 * time_fn(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), iters=20),
        4.0 * d * bh * pairs, 2.0 * 4 * bh * t * d + 4.0 * bh * t, "bfloat16",
        "[96,2048,64] causal bf16", "sdpa bf16 (p rounded to bf16)")
    o, lse = fa.flash_attention_fwd(q, k, v, None, True)
    qg, kg, vg = (x.view(8, 12, t, d).detach().requires_grad_()
                  for x in (q, k, v))
    do4 = do.view(8, 12, t, d)

    def sdpa_fwd():
        with torch.enable_grad():
            return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), do4)

    row("flash_attn_bwd_bf16",
        1e3 * time_fn(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                     True), iters=10),
        1e3 * time_fn(lambda: fa.flash_attention_bwd_reference(
            q, k, v, o, lse, do, None, True), iters=3),
        1e3 * (time_fn_slope(sdpa_fwd_bwd) - time_fn_slope(sdpa_fwd)),
        10.0 * d * bh * pairs,
        2.0 * 8 * bh * t * d + 4.0 * 2 * bh * t, "bfloat16",
        "[96,2048,64] causal bf16",
        "sdpa bf16 backward (fwd+bwd minus fwd, slopes)")
    del q, k, v, do, o, lse, qg, kg, vg, q4, k4, v4, do4
    torch.cuda.empty_cache()

    # K3 summed over an AMP ResNet-50 step's 36 launches at batch 256
    counts = {sh: amp_resnet["shapes"].count(sh) for sh in K3_SHAPES}
    n = AMP_BATCH_RESNET
    tot = dict.fromkeys(("ms", "ms_f32_batch", "plain_ms", "library_ms",
                         "bound_ms", "by_bytes"), 0.0)
    k3_rows = []
    for ci, co, p in K3_SHAPES:
        x = torch.randn(n, ci, p, device="cuda", generator=g).to(bf16)
        w = torch.randn(co, ci, device="cuda", generator=g) * ci ** -0.5
        xh = x[:RESNET_BATCH]           # the float32 resnet phase's batch

        def library():
            yf = torch.matmul(w.to(bf16), x).float()
            return yf.sum(dim=(0, 2)), (yf * yf).sum(dim=(0, 2))

        c = counts[(ci, co, p)]
        ms = 1e3 * time_fn(lambda: cb.conv1x1_stats_fwd(x, w), iters=10)
        lib_ms = 1e3 * time_fn(library, iters=10)
        tot["ms"] += c * ms
        tot["ms_f32_batch"] += c * 1e3 * time_fn(
            lambda: cb.conv1x1_stats_fwd(xh, w), iters=10)
        tot["plain_ms"] += c * 1e3 * time_fn(
            lambda: cb.conv1x1_stats_plain(x, w), iters=3)
        tot["library_ms"] += c * lib_ms
        # x and y in bf16, w and the sums in float32, once each
        b_ms, b_by, why = _bound(2.0 * n * p * ci * co,
                                 2.0 * (n * ci * p + n * co * p)
                                 + 4.0 * co * ci + 4.0 * 2 * co, "bfloat16")
        tot["bound_ms"] += c * b_ms
        tot["by_bytes"] += c * b_ms if b_by == "bytes" else 0.0
        route = "TMA" if p % 8 == 0 else "raw slabs laid out by the producer"
        k3_rows.append({"shape": [n, ci, co, p], "per_step": c, "ms": ms,
                        "library_ms": lib_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "route": route})
        _log("timing", f"conv1x1_stats_bf16 [{n}, {ci}, {p}] x [{co}, {ci}] "
             f"(x{c} a step, x by {route}) on {smi}: kernel {ms:.4f} ms, "
             f"bf16 matmul + float32 sums {lib_ms:.4f} ms; bound "
             f"{b_ms:.4f} ms by {b_by} ({why}): {100 * b_ms / ms:.1f}% of "
             f"bound")
        del x, xh, w
    out["conv1x1_stats_bf16"] = {
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "library_ms": tot["library_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["by_bytes"] >= tot["bound_ms"] / 2
        else "operations", "ms_at_batch_128": tot["ms_f32_batch"],
        "per_shape": k3_rows}
    _log("timing", f"conv1x1_stats_bf16 per AMP ResNet-50 step (36 "
         f"launches, batch {n}, bf16 x) on {smi}: kernel {tot['ms']:.3f} ms,"
         f" plain {tot['plain_ms']:.3f} ms, bf16 matmul + float32 sums "
         f"{tot['library_ms']:.3f} ms; bound {tot['bound_ms']:.3f} ms (the "
         f"sum of each shape's, {tot['by_bytes']:.3f} ms of it by bytes): "
         f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of bound; the bf16 "
         f"kernel at the float32 phase's batch {RESNET_BATCH} "
         f"{tot['ms_f32_batch']:.3f} ms")
    torch.cuda.empty_cache()

    # K4 at [16384, 768], bf16 x, y, dy, dx
    rows, d4 = TRAIN_BATCH * 2048, 768
    x = (torch.randn(rows, d4, device="cuda", generator=g)).to(bf16)
    sc = torch.randn(d4, device="cuda", generator=g) + 1
    bi = torch.randn(d4, device="cuda", generator=g)
    dy = torch.randn(rows, d4, device="cuda", generator=g).to(bf16)
    xg = x.detach().requires_grad_()
    sg, bg = (t_.to(bf16).requires_grad_() for t_ in (sc, bi))

    def lib_fwd():
        with torch.enable_grad():
            return F.layer_norm(xg, (d4,), sg, bg, 1e-5)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (xg, sg, bg), dy)

    # every column the card's time alone, as the float32 rows (timing_k45)
    lib_f = _held_ms(lib_fwd)
    row("layer_norm_fwd_bf16",
        _held_ms(lambda: ln.layer_norm_fwd(x, sc, bi, 1e-5)),
        _held_ms(lambda: ln.layer_norm_fwd_plain(x, sc, bi, 1e-5)),
        lib_f, 8.0 * rows * d4, 2.0 * 2 * rows * d4 + 4.0 * 2 * d4,
        "float32", f"[{rows}, {d4}] bf16", "F.layer_norm bf16 (card only)")
    cold_sets = [(x, dy)] + [
        (torch.randn(rows, d4, device="cuda", generator=g).to(bf16),
         torch.randn(rows, d4, device="cuda", generator=g).to(bf16))
        for _ in range(K4_COLD_SETS - 1)]
    row("layer_norm_bwd_bf16",
        cold_ms([lambda s=s: ln.layer_norm_bwd(s[0], sc, s[1], 1e-5)
                 for s in cold_sets]),
        _held_ms(lambda: ln.layer_norm_bwd_plain(x, sc, dy, 1e-5)),
        _held_ms(lib_fwd_bwd) - lib_f, 16.0 * rows * d4,
        2.0 * 3 * rows * d4 + 4.0 * 3 * d4, "float32",
        f"[{rows}, {d4}] bf16",
        "F.layer_norm bf16 fwd+bwd minus fwd (card only)",
        warm_ms=_held_ms(lambda: ln.layer_norm_bwd(x, sc, dy, 1e-5)))
    del x, dy, xg, cold_sets

    # K5 at [16384, 768] x [768, 3072] gelu, bf16 x, w and y
    n5 = 3072
    x = torch.randn(rows, d4, device="cuda", generator=g).to(bf16)
    w = (torch.randn(d4, n5, device="cuda", generator=g)
         * d4 ** -0.5).to(bf16)
    b = torch.randn(n5, device="cuda", generator=g)
    bb = b.to(bf16)
    row("dense_epilogue_bf16",
        1e3 * time_fn(lambda: de.dense_act_fwd(x, w, b, "gelu"), iters=20),
        1e3 * time_fn(lambda: de.dense_act_plain(x, w, b, "gelu"), iters=5),
        1e3 * time_fn(lambda: F.gelu(torch.matmul(x, w) + bb), iters=20),
        2.0 * rows * d4 * n5, 2.0 * (rows * d4 + d4 * n5 + rows * n5)
        + 4.0 * n5, "bfloat16", f"[{rows}, {d4}] x [{d4}, {n5}] gelu bf16",
        "bf16 matmul + bias + F.gelu")
    del x, w
    torch.cuda.empty_cache()

    for name, r, unit, per in (
            ("amp_train", amp_train, "tokens/s", "tokens_per_s"),
            ("amp_fused_train", amp_fused, "tokens/s", "tokens_per_s"),
            ("amp_resnet", amp_resnet, "images/s", "images_per_s")):
        _log("timing", f"{name} on {smi}: step {r['step_ms']:.1f} ms (mean "
             f"of {len(r['step_s'])}), {r[per]:.0f} {unit}, peak memory "
             f"{r['peak_bytes'] / 2**30:.2f} GiB "
             f"({(r['peak_bytes'] - r['held_bytes']) / 2**30:.2f} GiB above "
             f"what was allocated before its first step)")
    return out


def phase_rn50_fused():
    """``rn50_fused_bench.main()`` at both stage shapes: the fused chain
    (two K6 launches) against the library chain, parity then times."""
    import torch
    from paddle_tpu_torch.kernels import conv_bn as cb
    from paddle_tpu_torch.tools import rn50_fused_bench as rfb

    # the main path, counted: the tool's entry point
    cb.reset_launch_count()
    t0 = time.perf_counter()
    shapes = rfb.main()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = cb.launch_count("matmul_bn_stats")
    for name, r in shapes.items():
        if r["fused_launches"] != 2:
            raise AssertionError(f"{name}: the fused chain launched K6 "
                                 f"{r['fused_launches']} times, not 2")
        if not (np.isfinite(r["fused_sum"]) and np.isfinite(
                r["library_sum"]) and r["rel_err"] <= RN50_FUSED_RTOL):
            raise AssertionError(f"{name}: fused sum {r['fused_sum']} vs "
                                 f"library {r['library_sum']} (rel "
                                 f"{r['rel_err']:.3g} > {RN50_FUSED_RTOL})")
        _log("rn50_fused", f"{name}: fused {r['fused_ms']:.4f} ms, library "
             f"{r['library_ms']:.4f} ms ({r['speedup']:.3f}x), sums "
             f"{r['fused_sum']:.6g} / {r['library_sum']:.6g} (rel "
             f"{r['rel_err']:.3g} <= {RN50_FUSED_RTOL:.3g}), 2 K6 launches "
             f"a chain ok")
    expected = rfb.K6_LAUNCHES_PER_SHAPE * len(shapes)
    if launches != expected:
        raise AssertionError(f"rn50_fused: {launches} K6 launches, "
                             f"expected {expected}")
    _log("rn50_fused", f"{launches} K6 launches in {wall_s:.1f} s (inputs "
         f"made on the host from the seed included)")
    return {"shapes": shapes, "launches": launches, "wall_s": wall_s}


def phase_attn_ceiling():
    """``attn_shape_ceiling.main()`` at its three cases: the K8 skeletons
    and K1 / K1 + K2 timed at each; every report printed."""
    import torch
    from paddle_tpu_torch.kernels import attn_skeleton as sk
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.tools import attn_shape_ceiling as asc

    # the main path, counted: the tool's entry point
    sk.reset_launch_count()
    fa.reset_launch_count()
    t0 = time.perf_counter()
    reports = asc.main([])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: mod.launch_count(name) for mod, name in (
        (sk, "attn_skeleton_fwd"), (sk, "attn_skeleton_bwd"),
        (fa, "flash_attn_fwd"), (fa, "flash_attn_bwd"))}
    if len(reports) != len(asc.CASES):
        raise AssertionError(f"attn_ceiling: {len(reports)} reports")
    keys = ("fwd_skel_ms", "fwd_skel_d128_ms", "bwd_skel_ms",
            "flash_fwd_ms", "flash_fwd_bwd_ms")
    for r in reports:
        if not all(np.isfinite(r[k_]) and r[k_] > 0 for k_ in keys):
            raise AssertionError(f"attn_ceiling: bad times in {r}")
        _log("attn_ceiling", f"T {r['T']} bh {r['bh']} d {r['d']}: "
             f"skeleton fwd {r['fwd_skel_ms']:.4f} ms "
             f"({r['fwd_skel_mfu']:.1f}% of {r['peak']['kind']}), d 128 "
             f"{r['fwd_skel_d128_ms']:.4f} ms (fill_ratio "
             f"{r['fill_ratio']:.3f}), bwd {r['bwd_skel_ms']:.4f} ms "
             f"({r['bwd_skel_mfu']:.1f}%); K1 {r['flash_fwd_ms']:.4f} ms, "
             f"fwd_vs_skel {r['fwd_vs_skel']:.3f}; K1 + K2 "
             f"{r['flash_fwd_bwd_ms']:.4f} ms, fb_vs_skel "
             f"{r['fb_vs_skel']:.3f} ({r['fb_vs_skel_note']})")
    if not all(launches.values()):
        raise AssertionError(f"attn_ceiling: a kernel never launched: "
                             f"{launches}")
    _log("attn_ceiling", f"launches {launches} in {wall_s:.1f} s")
    return {"reports": reports, "launches": launches, "wall_s": wall_s}


# -- ring attention (K7) -----------------------------------------------------

def _ring_mesh():
    """sp 4 over one card: the four ranks of the ring are virtual (one
    device named four times, the port's analog of XLA's forced host device
    count), so every rotation is a no-op and the ranks run in turn."""
    import torch
    from paddle_tpu_torch.parallel import make_mesh
    return make_mesh({"sp": RING_SP}, [torch.device("cuda", 0)] * RING_SP)


def _ring_counts():
    """The launch counts the ring runs, by dtype: K1, K2 and the merge."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import ring_attention as ra
    return {dt: {"flash_attn_fwd": fa.launch_count("flash_attn_fwd", dt),
                 "flash_attn_bwd": fa.launch_count("flash_attn_bwd", dt),
                 "ring_merge": ra.launch_count("ring_merge", dt)}
            for dt in ("float32", "bfloat16")}


def _ring_inputs(g, dtype, n=4):
    import torch
    bh, t, d = RING_SLICE
    return [torch.randn(bh, t, d, device="cuda", generator=g).to(dtype)
            for _ in range(n)]


def _ring_step_shape():
    """The [b*h, T/n, d] shard a ring step gives K1 and K2."""
    bh, t, d = RING_SLICE
    return [bh, t // RING_SP, d]


def _ring_check(name, got, ref, each, kernel_tol=False, ulps_of_max=None,
                tol=None):
    """``(max abs error, largest share of its bound)`` of the ring's ``got``
    against ``ref``; raises unless every value is within bounds.  float32 (and every lse): ATOL + RTOL |ref|
    with ``kernel_tol``, else ``tol`` + ``tol`` |ref|.  bf16: ``each`` bf16
    ulps of each value plus ``each`` ulps of ``ref``'s RMS, and where given
    ``ulps_of_max`` ulps of its largest magnitude as well."""
    import torch
    err = (got.float() - ref.float()).abs()
    if got.dtype == torch.bfloat16:
        r = ref.float()
        rms = float(r.square().mean().sqrt())
        bound = each * (2.0 ** (torch.floor(torch.log2(
            r.abs().clamp_min(1e-30))) - 7) + _bf16_ulp(torch.tensor(rms)))
        if ulps_of_max is not None:
            bound = bound.clamp_max(ulps_of_max * _bf16_ulp(ref))
    elif kernel_tol:
        bound = ATOL + RTOL * ref.abs()
    else:
        bound = tol + tol * ref.abs()
    bad = ~(err <= bound)
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} values out of "
                             f"bounds; max abs err {float(err.max())}")
    return float(err.max()), float((err / bound).max())


def phase_ring_kernel():
    """Ring attention (K7) at [24, 8192, 64] (BERT-base at batch 2 x 8192)
    with sp 4 over one card (virtual ranks), float32 and bf16, causal and
    not: the ring's forward and backward (K1, K2 and the merge a step) as
    the main path, counted; then its o, lse, dq, dk and dv against the
    plain ring (the same schedule through the plain K1, K2 and merge) and
    against K1/K2 over the full T, and the merge kernel against its plain
    version on partials with NEG_INF rows on either side and on both."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import ring_attention as ra
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    devices = list(_ring_mesh().axis_devices("sp"))
    bh, t, d = RING_SLICE
    cases = [(dt, causal) for dt in (torch.float32, torch.bfloat16)
             for causal in (False, True)]
    inputs = {c: _ring_inputs(g, c[0]) for c in cases}

    # the main path, counted: the ring forward and backward of each case
    fa.reset_launch_count()
    ra.reset_launch_count()
    t0 = time.perf_counter()
    out = {}
    for (dt, causal), (q, k, v, do) in inputs.items():
        o, lse = ra.ring_attention_fwd(q, k, v, devices, causal)
        out[(dt, causal)] = (o, lse) + ra.ring_attention_bwd(
            q, k, v, o, lse, do, devices, causal)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _ring_counts()
    want = {k_: sum(ra.expected_launches(RING_SP, c)[k_] for c in (False,
                                                                  True))
            for k_ in ("flash_attn_fwd", "flash_attn_bwd", "ring_merge")}
    if launches != {"float32": want, "bfloat16": want}:
        raise AssertionError(f"ring_kernel: launches {launches}, expected "
                             f"{want} a dtype")
    _log("ring_kernel", f"ring fwd + bwd at {list(RING_SLICE)} sp "
         f"{RING_SP} (virtual ranks on one card), float32 and bf16, causal "
         f"and not, in {wall_s:.2f} s: launches {launches} (= the schedule's"
         f" n^2 + n(n+1)/2 K1 and K2, n(n-1) + n(n-1)/2 merges a dtype) ok")

    worst = {"ring_merge": 0.0, "ring_merge_bf16": 0.0}
    names = ("o", "lse", "dq", "dk", "dv")
    for (dt, causal), (q, k, v, do) in inputs.items():
        got = out[(dt, causal)]
        tag = (f"ring {list(RING_SLICE)} sp {RING_SP} "
               f"{'causal' if causal else 'non-causal'} "
               f"{str(dt).replace('torch.', '')}")
        for name, g_ in zip(names, got):
            want_dt = torch.float32 if name == "lse" else dt
            if g_.dtype != want_dt:
                raise AssertionError(f"{tag} {name}: dtype {g_.dtype}")
        # against its plain version: the same schedule, plain steps (no
        # kernel launched)
        before = _ring_counts()
        po, plse = ra.ring_attention_fwd(q, k, v, devices, causal,
                                         plain=True)
        plain = (po, plse) + ra.ring_attention_bwd(q, k, v, got[0], got[1],
                                                   do, devices, causal,
                                                   plain=True)
        if _ring_counts() != before:
            raise AssertionError(f"{tag}: the plain ring launched a kernel")
        errs = [_ring_check(f"{tag} {n_} vs plain", g_, r_,
                            each=RING_BF16_EACH_PLAIN, kernel_tol=True)
                for n_, g_, r_ in zip(names, got, plain)]
        _log("ring_kernel", f"{tag} vs the plain ring: max abs err "
             + " ".join(f"{n_} {e:.3g} ({u:.2f} of its bound)"
                        for n_, (e, u) in zip(names, errs))
             + (f" ({RING_BF16_EACH_PLAIN} bf16 ulps of each value + of "
                "the RMS)" if dt == torch.bfloat16 else
                f" (atol {ATOL}, rtol {RTOL})") + " ok")
        del po, plse, plain
        # against K1/K2 over the full T
        ro, rlse = fa.flash_attention_fwd(q, k, v, None, causal)
        full = (ro, rlse) + fa.flash_attention_bwd(q, k, v, ro, rlse, do,
                                                   causal)
        errs = [_ring_check(f"{tag} {n_} vs K1/K2", g_, r_,
                            each=RING_BF16_EACH_FULL,
                            ulps_of_max=dict(o=RING_BF16_ULPS_O).get(
                                n_, RING_BF16_ULPS_GRAD),
                            tol=RING_O_TOL if n_ in ("o", "lse")
                            else RING_GRAD_TOL)
                for n_, g_, r_ in zip(names, got, full)]
        what = (f"{RING_BF16_ULPS_O} bf16 ulps of max|o|, "
                f"{RING_BF16_ULPS_GRAD} of each gradient's, and "
                f"{RING_BF16_EACH_FULL} of each value + of the RMS"
                if dt == torch.bfloat16 else
                f"rtol = atol = {RING_O_TOL} o, lse, {RING_GRAD_TOL} grads")
        _log("ring_kernel", f"{tag} vs K1, K2 over the full T: max abs err "
             + " ".join(f"{n_} {e:.3g} ({u:.2f} of its bound)"
                        for n_, (e, u) in zip(names, errs))
             + f" ({what}) ok")
        del ro, rlse, full
    del out

    # the merge kernel against its plain version at a ring step's shape
    tq = t // RING_SP
    for dt, key in ((torch.float32, "ring_merge"),
                    (torch.bfloat16, "ring_merge_bf16")):
        o1, o2 = (torch.randn(bh, tq, d, device="cuda", generator=g).to(dt)
                  for _ in range(2))
        l1, l2 = (torch.randn(bh, tq, device="cuda", generator=g) * 4
                  for _ in range(2))
        l1[:, 0:300] = ra.NEG_INF          # masked on the left
        l2[:, 200:500] = ra.NEG_INF        # on the right (200-299: both)
        l1[3::5, 1000:] = ra.NEG_INF
        o, lse = ra.ring_merge(o1, l1, o2, l2)
        ro, rlse = ra.ring_merge_reference(o1, l1, o2, l2)
        torch.cuda.synchronize()
        if not bool((lse[:, 200:300] == ra.NEG_INF).all()):
            raise AssertionError(f"{key}: rows masked on both sides must "
                                 "keep lse = NEG_INF")
        err = (o.float() - ro.float()).abs()
        if dt == torch.bfloat16:
            ulp = 2.0 ** (torch.floor(torch.log2(
                ro.float().abs().clamp_min(1e-30))) - 7)
            ok, tol = bool((err <= ulp).all()), "one bf16 ulp of each"
        else:
            ok = bool((err <= RING_MERGE_TOL
                       + RING_MERGE_TOL * ro.abs()).all())
            tol = f"{RING_MERGE_TOL}"
        e_l = float((lse - rlse).abs().max())
        if not ok or not e_l <= RING_MERGE_TOL * float(
                rlse.abs().max()):
            raise AssertionError(f"{key}: max abs err o {float(err.max())}"
                                 f" lse {e_l}")
        worst[key] = max(float(err.max()), e_l)
        _log("ring_kernel", f"{key} [{bh}, {tq}, {d}] (NEG_INF rows on "
             f"either side and both) vs plain: max abs err o "
             f"{float(err.max()):.3g} ({tol}), lse {e_l:.3g} ok")
    del inputs
    torch.cuda.empty_cache()
    return {"launches": launches, "worst": worst, "wall_s": wall_s}


def _ring_program(seq, attn_impl):
    """``bench.py:531-567``'s 8k line: ``build_bert_pretrain`` at seq 8192
    with the fused head and static positions, under
    ``amp.decorate(AdamOptimizer(1e-4))``."""
    from paddle_tpu_torch import amp as amp_mod
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.models import transformer as T
    main, startup = Program(), Program()
    with program_guard(main, startup):
        cfg = T.BertConfig(max_pos=seq)
        _, _, loss = T.build_bert_pretrain(cfg, seq, fused_head=True,
                                           arange_pos=True,
                                           attn_impl=attn_impl, dropout=0.0)
        amp_mod.decorate(optimizer.AdamOptimizer(
            learning_rate=1e-4)).minimize(loss)
    return cfg, main, startup, loss


def phase_ring_train(profile=False):
    """BERT-base pretraining at batch 2 x 8192 under AMP (``bench.py``'s 8k
    line) with ``attn_impl="ring"`` over sp 4 on one card (virtual ranks),
    1 warm-up + 3 steps counted: every step launches the bf16 K1 and K2 12
    x 16 times and the bf16 merge 12 x 12 times; then the same program
    with ``attn_impl="flash"`` (what the reference's bench runs on one
    chip) from the same startup seed and feed, and every ring loss held to
    the flash loss of its step.  With ``profile``, two more steps of each
    program after the counted ones, the second by kernel class."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import ring_attention as ra
    from paddle_tpu_torch.parallel import set_mesh

    seq, batch = RING_SEQ, RING_BATCH
    feed = None
    results = {}
    for impl in ("ring", "flash"):
        cfg, main, startup, loss = _ring_program(seq, impl)
        types = [op.type for op in main.global_block().ops]
        n_attn = types.count(f"{impl}_attention")
        if n_attn != cfg.n_layer:
            raise AssertionError(f"{impl} program: {n_attn} attention ops")
        scope, exe = Scope(), ptt.Executor()
        exe.run(startup, scope=scope, seed=1234)
        if feed is None:
            rng = np.random.RandomState(0)
            feed = {"src_ids": rng.randint(1, cfg.vocab_size, (batch, seq))
                    .astype(np.int64),
                    "lm_label": rng.randint(0, cfg.vocab_size, (batch, seq))
                    .astype(np.int64)}
            n_params = sum(int(scope.find_var(p.name).numel())
                           for p in main.all_parameters())
            _log("ring_train", f"BERT-base pretraining program at seq {seq}:"
                 f" {len(types)} ops ({n_attn} {impl}_attention), "
                 f"{n_params / 1e6:.1f} M parameters, AMP")
        set_mesh(_ring_mesh() if impl == "ring" else None)
        try:
            # the main path, counted: a warm-up step and the timed steps
            fa.reset_launch_count()
            ra.reset_launch_count()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            prev = _ring_counts()
            per_step, losses, step_s = [], [], []
            for _ in range(RING_STEPS + 1):
                t0 = time.perf_counter()
                out, = exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                now = _ring_counts()
                per_step.append({dt: {k_: now[dt][k_] - prev[dt][k_]
                                      for k_ in now[dt]} for dt in now})
                prev = now
                losses.append(float(out))
            peak = torch.cuda.max_memory_allocated()
            if profile:
                prof = _profile_step(
                    f"ring_train {impl} step, batch {batch} x seq {seq}",
                    lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope))
        finally:
            set_mesh(None)
        warm_s = step_s.pop(0)
        n = RING_SP if impl == "ring" else 1
        want = {k_: cfg.n_layer * c
                for k_, c in ra.expected_launches(n, False).items()}
        step_want = {"bfloat16": want,
                     "float32": dict.fromkeys(want, 0)}
        if per_step != [step_want] * (RING_STEPS + 1):
            raise AssertionError(f"ring_train {impl}: launches per step "
                                 f"{per_step}, expected {step_want}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"ring_train {impl}: losses {losses}")
        step_ms = 1e3 * float(np.mean(step_s))
        results[impl] = {
            "losses": losses, "step_s": step_s, "step_ms": step_ms,
            "warmup_s": warm_s, "tokens_per_s": batch * seq / step_ms * 1e3,
            "peak_bytes": peak, "held_bytes": held,
            "per_step": per_step[1]["bfloat16"],
            "profile": prof if profile else None,
            "launches": {dt: {k_: sum(s[dt][k_] for s in per_step)
                              for k_ in want} for dt in per_step[0]}}
        where = (f"sp {RING_SP} (virtual ranks on one card)"
                 if impl == "ring" else "one card")
        _log("ring_train", f"{impl} {where}: batch {batch} x seq {seq} AMP:"
             f" warm-up {warm_s:.2f} s, then {RING_STEPS} steps of "
             f"{', '.join(f'{1e3 * x:.1f}' for x in step_s)} ms (mean "
             f"{step_ms:.1f}), {results[impl]['tokens_per_s']:.0f} "
             f"tokens/s; losses {', '.join(f'{x:.4f}' for x in losses)}; "
             f"launches a step {per_step[1]['bfloat16']} (bf16); peak "
             f"memory {peak / 2**30:.2f} GiB, of which {held / 2**30:.2f} "
             f"GiB allocated before the first step")
        del scope, exe, main, startup
        torch.cuda.empty_cache()
    rels = [abs(r - f) / abs(f) for r, f in zip(results["ring"]["losses"],
                                                results["flash"]["losses"])]
    if not all(x <= RING_LOSS_RTOL for x in rels):
        raise AssertionError(f"ring_train: ring losses "
                             f"{results['ring']['losses']} vs flash "
                             f"{results['flash']['losses']} (rel {rels})")
    _log("ring_train", f"every step's loss ring vs flash: rel "
         f"{', '.join(f'{x:.3g}' for x in rels)} (rtol {RING_LOSS_RTOL}); "
         f"a ring step launches {cfg.n_layer} layers x "
         f"{RING_SP * RING_SP} K1 and K2 and "
         f"{RING_SP * (RING_SP - 1)} merges (sp {RING_SP}, non-causal) ok")
    results["loss_rel"] = rels
    return results


def timing_ring(smi, ring_train):
    """K7 at [24, 8192, 64] non-causal sp 4 over one card (virtual ranks),
    float32 and bf16: the ring's forward and backward, K1 and K2 over the
    full T, ``scaled_dot_product_attention`` over the full T (the one
    library call computing the same function), the plain ring (the plain
    K1, K2 and merge on the same schedule), and the bound (4 d bh T^2
    forward and 10 d bh T^2 backward operations at the rate of the
    dtype's K1/K2 on the tensor cores: bf16, or float32 as six bf16 term
    products, with the CUDA-core float32 rate beside it;
    q, k, v (o, do) read and o, lse (dq, dk, dv) written once).  Then the
    merge kernel at a ring step's shape ([24, 2048, 64]), its plain
    version, and its bytes bound; and the ring training step next to the
    flash one."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import ring_attention as ra
    from paddle_tpu_torch.tools.k4_k7_compare import cold_ms
    from paddle_tpu_torch.tools.timing import time_fn, time_fn_slope
    g = torch.Generator(device="cuda")
    g.manual_seed(22)
    devices = list(_ring_mesh().axis_devices("sp"))
    bh, t, d = RING_SLICE
    b, h = RING_BATCH, bh // RING_BATCH
    out = {"ring": {}}
    for dt, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        q, k, v, do = _ring_inputs(g, dt)
        o, lse = ra.ring_attention_fwd(q, k, v, devices)
        esz = 4.0 if dt == torch.float32 else 2.0
        fwd_ms = _held_ms(lambda: ra.ring_attention_fwd(q, k, v, devices))
        bwd_ms = _held_ms(lambda: ra.ring_attention_bwd(q, k, v, o, lse, do,
                                                        devices))
        k1_ms = 1e3 * time_fn(lambda: fa.flash_attention_fwd(q, k, v),
                              iters=5)
        ro, rlse = fa.flash_attention_fwd(q, k, v)
        k2_ms = 1e3 * time_fn(lambda: fa.flash_attention_bwd(
            q, k, v, ro, rlse, do), iters=3)
        plain_fwd = 1e3 * time_fn(lambda: ra.ring_attention_fwd(
            q, k, v, devices, plain=True), iters=2)
        plain_bwd = 1e3 * time_fn(lambda: ra.ring_attention_bwd(
            q, k, v, o, lse, do, devices, plain=True), iters=2)
        q4, k4, v4, do4 = (x.view(b, h, t, d) for x in (q, k, v, do))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))

        def sdpa_fwd():
            with torch.enable_grad():
                return F.scaled_dot_product_attention(qg, kg, vg)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), do4)

        sdpa_ms = 1e3 * time_fn(lambda: F.scaled_dot_product_attention(
            q4, k4, v4), iters=5)
        sdpa_bwd_ms = 1e3 * (time_fn_slope(sdpa_fwd_bwd)
                             - time_fn_slope(sdpa_fwd))
        name = "float32" if dt == torch.float32 else "bfloat16"
        kind = "float32_split" if dt == torch.float32 else name
        f_bound, f_by, f_why = _bound(4.0 * d * bh * t * t,
                                      esz * 4 * bh * t * d + 4.0 * bh * t,
                                      kind)
        b_bound, b_by, b_why = _bound(10.0 * d * bh * t * t,
                                      esz * 8 * bh * t * d + 4.0 * bh * t,
                                      kind)
        if dt == torch.float32:
            f_why += (f"; {_bound(4.0 * d * bh * t * t, 0.0)[0]:.3f} ms at "
                      "the CUDA-core float32 rate")
            b_why += (f"; {_bound(10.0 * d * bh * t * t, 0.0)[0]:.3f} ms at "
                      "the CUDA-core float32 rate")
        out["ring"][name] = {
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "k1_full_ms": k1_ms,
            "k2_full_ms": k2_ms, "plain_fwd_ms": plain_fwd,
            "plain_bwd_ms": plain_bwd, "sdpa_fwd_ms": sdpa_ms,
            "sdpa_bwd_ms": sdpa_bwd_ms, "fwd_bound_ms": f_bound,
            "fwd_bound_by": f_by, "bwd_bound_ms": b_bound,
            "bwd_bound_by": b_by}
        _log("timing", f"ring (K7) {list(RING_SLICE)} sp {RING_SP} (virtual "
             f"ranks on one card) non-causal {name} on {smi}: forward "
             f"{fwd_ms:.3f} ms (K1 over the full T {k1_ms:.3f}, plain ring "
             f"{plain_fwd:.3f}, SDPA {sdpa_ms:.3f}; bound {f_bound:.3f} by "
             f"{f_by}, {f_why}), backward {bwd_ms:.3f} ms (K2 over the full"
             f" T {k2_ms:.3f}, plain ring {plain_bwd:.3f}, SDPA fwd+bwd "
             f"minus fwd {sdpa_bwd_ms:.3f}; bound {b_bound:.3f} by {b_by}, "
             f"{b_why})")
        del q, k, v, do, o, lse, ro, rlse, qg, kg, vg
        torch.cuda.empty_cache()

        # the merge at a ring step's shape as the ring calls it (in place
        # into the running partial): two partials read, one written.  The
        # card's time alone (a call's host side outlasts its kernel), warm
        # (the same 19 MB, bf16, call after call: they stay in the 50 MB
        # L2) and cold (input sets of more than 50 MB in all, in turn),
        # which the share of the bound uses
        tq = t // RING_SP
        sets = [[torch.randn(bh, tq, d, device="cuda", generator=g).to(dt),
                 torch.randn(bh, tq, device="cuda", generator=g),
                 torch.randn(bh, tq, d, device="cuda", generator=g).to(dt),
                 torch.randn(bh, tq, device="cuda", generator=g)]
                for _ in range(MERGE_COLD_SETS)]
        calls = [lambda s=s: ra.ring_merge(*s, out=(s[0], s[1]))
                 for s in sets]
        warm_ms = _held_ms(calls[0])
        ms = cold_ms(calls)
        o1, l1, o2, l2 = sets[0]
        plain_ms = _held_ms(lambda: ra.ring_merge_reference(o1, l1, o2, l2))
        # per row: 2 exp, 1 log, 2 divisions and ~8 more; 3 per element
        bound_ms, bound_by, why = _bound(
            bh * tq * (13.0 + 3.0 * d), esz * 3 * bh * tq * d
            + 4.0 * 3 * bh * tq)
        out["ring_merge" + tag] = {"ms": ms, "warm_ms": warm_ms,
                                   "plain_ms": plain_ms, "library_ms": None,
                                   "bound_ms": bound_ms,
                                   "bound_by": bound_by}
        _log("timing", f"ring_merge{tag} [{bh}, {tq}, {d}] in place on "
             f"{smi}: kernel cold {ms:.4f} ms ({MERGE_COLD_SETS} input "
             f"sets in turn), warm {warm_ms:.4f} ms (L2), plain "
             f"{plain_ms:.4f} ms, no single library call; bound "
             f"{bound_ms:.4f} ms by {bound_by} ({why}): "
             f"{100 * bound_ms / ms:.1f}% of bound cold "
             f"({100 * bound_ms / warm_ms:.1f}% warm)")
        del sets, calls, o1, o2, l1, l2
    for impl in ("ring", "flash"):
        r = ring_train[impl]
        _log("timing", f"ring_train {impl} on {smi}: step {r['step_ms']:.1f}"
             f" ms (mean of {RING_STEPS}), {r['tokens_per_s']:.0f} tokens/s,"
             f" peak memory {r['peak_bytes'] / 2**30:.2f} GiB")
    return out


def timing_k68(smi):
    """K6 at rn50_fused_bench's four calls (bf16): kernel, plain version,
    one library composition (a bf16 ``torch.matmul`` + the two float32
    sums, with the normalize + relu pass before the second call's) and the
    bound (x, w, the statistics in and y, s, s2 out, once each; 2*M*K*N bf16
    products at the tensor-core rate); ``ms`` and ``library_ms`` event-timed
    as in earlier runs, ``held_ms`` and ``library_held_ms`` the card
    alone.  K8 forward and backward at the ceiling tool's first case, [24,
    2048, 64], block_q 64: kernel (its split pass included), plain version
    and the bound (float32-exact products as six bf16 term products on the
    tensor cores, the arithmetic the skeletons run, with the CUDA-core
    float32 rate's time beside; q, k, v (do) read, o (dq and the partials)
    written); no single PyTorch call computes the skeletons, so no library
    time."""
    import torch
    from paddle_tpu_torch.kernels import attn_skeleton as sk
    from paddle_tpu_torch.kernels import conv_bn as cb
    from paddle_tpu_torch.tools.rn50_fused_bench import SHAPES
    from paddle_tpu_torch.tools.timing import time_fn
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    bf16 = torch.bfloat16
    rows, totals = [], dict.fromkeys(("ms", "held_ms", "plain_ms",
                                      "library_ms", "library_held_ms",
                                      "bound_ms"), 0.0)
    out = {}
    for stage, m, cin, cmid in SHAPES:
        x = (torch.randn(m, cin, device="cuda", generator=g) * 0.5).to(bf16)
        w1 = (torch.randn(cin, cmid, device="cuda", generator=g)
              * 0.05).to(bf16)
        w2 = (torch.randn(cmid, cmid, device="cuda", generator=g)
              * 0.05).to(bf16)
        y1, s, s2 = cb.matmul_bn_stats_fwd(x, w1, None, False)
        mu = s / m
        inv = torch.rsqrt(s2 / m - mu * mu + 1e-5)
        gam, bet = torch.ones_like(mu), torch.zeros_like(mu)
        ps = (mu, inv, gam, bet)

        def lib1():
            yf = torch.matmul(x, w1).float()
            return yf.sum(dim=0), (yf * yf).sum(dim=0)

        def lib2():
            a = torch.relu((y1.float() - mu) * inv * gam + bet).to(bf16)
            yf = torch.matmul(a, w2).float()
            return yf.sum(dim=0), (yf * yf).sum(dim=0)

        for call, (xin, w, stats, relu, lib) in enumerate(
                ((x, w1, None, False, lib1), (y1, w2, ps, True, lib2)), 1):
            mm, k = xin.shape
            n = w.shape[1]
            ms = 1e3 * time_fn(lambda: cb.matmul_bn_stats_fwd(
                xin, w, stats, relu), iters=20)
            held_ms = _held_ms(lambda: cb.matmul_bn_stats_fwd(xin, w, stats,
                                                              relu))
            plain_ms = 1e3 * time_fn(lambda: cb.matmul_bn_stats_plain(
                xin, w, stats, relu), iters=5)
            library_ms = 1e3 * time_fn(lib, iters=20)
            library_held_ms = _held_ms(lib)
            flops = 2.0 * mm * k * n
            nbytes = 2.0 * (mm * k + k * n + mm * n) + 4.0 * 2 * n + (
                4.0 * 4 * k if stats else 0.0)
            bound_ms, bound_by, why = _bound(flops, nbytes, "bfloat16")
            rows.append({"stage": stage, "call": call, "shape": [mm, k, n],
                         "ms": ms, "held_ms": held_ms,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "library_held_ms": library_held_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by})
            for key, val in (("ms", ms), ("held_ms", held_ms),
                             ("plain_ms", plain_ms),
                             ("library_ms", library_ms),
                             ("library_held_ms", library_held_ms),
                             ("bound_ms", bound_ms)):
                totals[key] += val
            what = "normalize + relu + " if stats else ""
            _log("timing", f"matmul_bn_stats {stage} call {call} [{mm}, {k}]"
                 f" x [{k}, {n}] bf16 on {smi}: kernel {ms:.4f} ms "
                 f"({nbytes / ms / 1e6:.0f} GB/s; {held_ms:.4f} alone), "
                 f"plain {plain_ms:.4f} ms, {what}bf16 matmul + sums "
                 f"{library_ms:.4f} ms ({library_held_ms:.4f} alone); bound "
                 f"{bound_ms:.4f} ms by {bound_by} ({why}): "
                 f"{100 * bound_ms / ms:.1f}% of bound "
                 f"({100 * bound_ms / held_ms:.1f}% alone)")
        del x, y1
    by = {r["bound_by"] for r in rows}
    out["matmul_bn_stats"] = dict(
        totals, bound_by=by.pop() if len(by) == 1 else "bytes and operations",
        per_call=rows)
    _log("timing", f"matmul_bn_stats over the 4 calls on {smi}: kernel "
         f"{totals['ms']:.4f} ms ({totals['held_ms']:.4f} alone), plain "
         f"{totals['plain_ms']:.4f} ms, library {totals['library_ms']:.4f} "
         f"ms ({totals['library_held_ms']:.4f} alone), bound "
         f"{totals['bound_ms']:.4f} ms "
         f"({100 * totals['bound_ms'] / totals['ms']:.1f}% of bound, "
         f"{100 * totals['bound_ms'] / totals['held_ms']:.1f}% alone)")

    bh, t, d, bq = 24, 2048, 64, 64
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g) * 0.1
                   for _ in range(4))
    for name, fn, plain, flops, nbytes in (
            ("attn_skeleton_fwd", lambda: sk.attn_skeleton_fwd(q, k, v, bq),
             lambda: sk.attn_skeleton_fwd_plain(q, k, v),
             4.0 * bh * t * t * d, 4.0 * 4 * bh * t * d),
            ("attn_skeleton_bwd",
             lambda: sk.attn_skeleton_bwd(q, k, v, do, bq),
             lambda: sk.attn_skeleton_bwd_plain(q, k, v, do, bq),
             10.0 * bh * t * t * d,
             4.0 * (5 * bh * t * d + 2 * bh * (t // bq) * t * d))):
        ms = 1e3 * time_fn(fn, iters=10)
        plain_ms = 1e3 * time_fn(plain, iters=3)
        bound_ms, bound_by, why = _bound(flops, nbytes, "float32_split")
        core_ms = _bound(flops, nbytes)[0]
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        _log("timing", f"{name} [{bh}, {t}, {d}] block_q {bq} f32 on {smi}: "
             f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
             f"{plain_ms:.4f} ms, no single library call; bound "
             f"{bound_ms:.4f} ms by {bound_by} ({why}): "
             f"{100 * bound_ms / ms:.1f}% of bound; {core_ms:.4f} ms at the "
             f"CUDA-core float32 rate")
    return out


def _bits_equal(a, b):
    import torch
    it = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(it),
                                              b.contiguous().view(it))


def check_dropout(dtype):
    """The dropout kernel against its plain version on the card, bit for
    bit: out and mask at DROPOUT_SHAPES for each p of DROPOUT_PS in both
    implementations, and the gradient (the same stream on an output
    gradient, and the stored mask in place of the stream); the keep rate
    within DROPOUT_SIGMAS binomial standard deviations."""
    import torch
    from paddle_tpu_torch.kernels import dropout as dk
    from paddle_tpu_torch.ops.nn_ops import dropout_scale
    phase = "kernel" if dtype == "float32" else "kernel_bf16"
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda")
    g.manual_seed(16)
    worst, rates, cases = 0.0, [], 0
    for shape in DROPOUT_SHAPES:
        x = torch.randn(shape, device="cuda", generator=g).to(dt)
        dy = torch.randn(shape, device="cuda", generator=g).to(dt)
        n = x.numel()
        for i, p in enumerate(DROPOUT_PS):
            stream = dk.tagged_stream(0x5EED00000000 + 977 * i,
                                      0x7FFFFF00 + i)
            thr = dk.threshold(p)
            for impl in ("upscale_in_train", "downgrade_in_infer"):
                scale = dropout_scale({"dropout_prob": p,
                                       "dropout_implementation": impl})
                out, mask = dk.dropout_fwd(x, stream, thr, scale,
                                           want_mask=True)
                ref, rmask = dk.dropout_plain(x, stream, thr, scale,
                                              want_mask=True)
                gx = dk.dropout_fwd(dy, stream, thr, scale)[0]
                gref = dk.dropout_plain(dy, stream, thr, scale)[0]
                gm = dk.dropout_fwd(dy, None, 0, scale, mask_in=mask)[0]
                torch.cuda.synchronize()
                for what, a, b in (("out", out, ref), ("grad", gx, gref),
                                   ("grad from the mask", gm, gref)):
                    if not _bits_equal(a, b):
                        raise AssertionError(
                            f"dropout {dtype} {shape} p {p} {impl}: {what} "
                            f"differs from the plain version: max abs "
                            f"{float((a.float() - b.float()).abs().max())}")
                if not torch.equal(mask, rmask):
                    raise AssertionError(f"dropout {dtype} {shape} p {p}: "
                                         f"{int((mask != rmask).sum())} mask "
                                         f"bytes differ")
                worst = max(worst, float((out.float() - ref.float()).abs()
                                         .max()))
                cases += 1
            kept = int(mask.sum())
            q = 1 - thr / 256
            sd = (n * q * (1 - q)) ** 0.5
            if (q in (0.0, 1.0) and kept != q * n) or \
                    abs(kept - q * n) > DROPOUT_SIGMAS * sd:
                raise AssertionError(f"dropout p {p}: kept {kept} of {n}, "
                                     f"expected {q * n:.0f} +- "
                                     f"{DROPOUT_SIGMAS} x {sd:.1f}")
            rates.append(f"p {p}: {(kept - q * n) / max(sd, 1e-30):+.2f} sd")
        del x, dy, out, mask, ref, rmask, gx, gref, gm
    _log(phase, f"dropout {dtype}: {cases} cases at {list(DROPOUT_SHAPES)} "
         f"(p {list(DROPOUT_PS)}, both implementations): out, mask and both "
         f"gradient forms bit for bit with the plain version; keep rate vs "
         f"1 - threshold/256 at [128, 12, 128, 128] in sd: "
         f"{'; '.join(rates[len(DROPOUT_PS):])} ok")
    return {"dropout" + ("" if dtype == "float32" else "_bf16"): worst}


def timing_dropout(smi, bert, wmt, se):
    """The dropout kernel at BERT's attention weights [128, 12, 128, 128]
    (p 0.1, upscale_in_train), both dtypes: cold over input sets of more
    than the L2 in all (its share of the bound uses that time), warm, its
    plain version, and ``F.dropout`` at the same shape and dtype (cold).
    The bound: x read and out written at the card's bytes rate, against
    ~9 operations an element (the product, compare and select, and 10
    Philox rounds of ~10 integer operations per 16 elements) at its
    float32 rate."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import dropout as dk
    from paddle_tpu_torch.tools.k4_k7_compare import cold_ms
    from paddle_tpu_torch.tools.timing import time_fn
    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    shape = DROPOUT_SHAPES[1]
    stream, thr, scale = dk.tagged_stream(3, 5), dk.threshold(0.1), 1 / 0.9
    out = {}
    for dtype, name in (("float32", "dropout"), ("bfloat16", "dropout_bf16")):
        dt = getattr(torch, dtype)
        sets = [torch.randn(shape, device="cuda", generator=g).to(dt)
                for _ in range(DROPOUT_COLD_SETS)]
        n = sets[0].numel()
        ms = cold_ms([lambda s=s: dk.dropout_fwd(s, stream, thr, scale)
                      for s in sets])
        warm = _held_ms(lambda: dk.dropout_fwd(sets[0], stream, thr, scale))
        # the plain version's host side (its small constant tensors) takes
        # longer than its kernels: timed with events over a run of calls
        plain = 1e3 * time_fn(lambda: dk.dropout_plain(sets[0], stream, thr,
                                                       scale), iters=5)
        library = cold_ms([lambda s=s: F.dropout(s, 0.1, training=True)
                           for s in sets])
        nbytes = 2.0 * n * sets[0].element_size()
        bound_ms, bound_by, why = _bound(n * (3 + 100 / 16), nbytes)
        out[name] = {"ms": ms, "warm_ms": warm, "plain_ms": plain,
                     "library_ms": library, "bound_ms": bound_ms,
                     "bound_by": bound_by, "shape": list(shape)}
        _log("timing", f"{name} {list(shape)} p 0.1 on {smi}: kernel cold "
             f"{ms:.4f} ms ({DROPOUT_COLD_SETS} input sets in turn), warm "
             f"{warm:.4f} ms, plain {plain:.4f} ms, F.dropout cold "
             f"{library:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
             f"({why}): {100 * bound_ms / ms:.1f}% of bound cold")
        del sets
    for label, r in (("bert_train", bert), ("transformer_wmt", wmt),
                     ("se_resnext", se)):
        _log("timing", f"{label} on {smi}: step {r['step_ms']:.1f} ms (mean "
             f"of {len(r['step_s'])}), {r['rate']:.0f} {r['unit']}/s, peak "
             f"memory {r['peak_bytes'] / 2**30:.2f} GiB "
             f"({(r['peak_bytes'] - r['held_bytes']) / 2**30:.2f} GiB above "
             f"what was allocated before its first step)")
    return out


def _dropout_launches():
    from paddle_tpu_torch.kernels import dropout as dk
    return {d: dk.launch_count("dropout", d) for d in ("float32",
                                                        "bfloat16")}


def _run_steps(phase, exe, main, feed, loss, scope, steps, counts):
    """A warm-up step and ``steps`` timed ones, each ending in a
    synchronize; ``counts()`` read after each.  Returns the losses, the
    timed steps' seconds, the warm-up's, each step's launches and the
    peak memory above what was held before the first step."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    prev, per_step, losses, step_s = counts(), [], [], []
    for _ in range(steps + 1):
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        now = counts()
        per_step.append({k: now[k] - prev[k] for k in now})
        prev = now
        losses.append(float(out))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: losses not finite: {losses}")
    warm_s = step_s.pop(0)
    return {"losses": losses, "step_s": step_s, "warmup_s": warm_s,
            "step_ms": 1e3 * float(np.mean(step_s)), "per_step": per_step,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "held_bytes": held}


def _bert_program(cfg, seq, amp=True, masked_gather=None):
    """``build_bert_pretrain`` as bench.py builds it (fused head, arange
    positions) under ``amp.decorate(AdamOptimizer(1e-4))`` when ``amp``."""
    from paddle_tpu_torch import amp as amp_mod
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.models import transformer as T
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss = T.build_bert_pretrain(cfg, seq, fused_head=True,
                                           arange_pos=True,
                                           masked_gather=masked_gather)
        adam = optimizer.AdamOptimizer(learning_rate=1e-4)
        (amp_mod.decorate(adam) if amp else adam).minimize(loss)
    return main, startup, loss


def _bert_feed(cfg, batch, seq, seed=0, n_mask=None):
    """bench.py's feeds: random ids, every position labelled (or, with
    ``n_mask``, n_mask distinct positions a sequence and their labels)."""
    rng = np.random.RandomState(seed)
    if n_mask:
        pos = np.stack([rng.choice(seq, n_mask, replace=False) + i * seq
                        for i in range(batch)]).astype(np.int64)
        return {"src_ids": rng.randint(1, cfg.vocab_size, (batch, seq)),
                "mask_pos": pos,
                "lm_label": rng.randint(1, cfg.vocab_size, (batch, n_mask))}
    return {"src_ids": rng.randint(1, cfg.vocab_size, (batch, seq)),
            "lm_label": rng.randint(0, cfg.vocab_size, (batch, seq))}


def _bert_small_checks(exe):
    """Two 2-layer BERTs of BERT-base's width at seq 128.  (1) The AMP
    program, fused and autotuned on the card (the flags are the caller's),
    one step at batch BERT_SMALL_BATCH against the same fused program on
    the host at the same seed: the masks are the same by design (the bits depend only on
    the seed and the tags), so the two differ by the AMP tolerances only.
    (2) float32, autotuner off: the fused program against the unfused one
    (``FLAGS_graph_fusion`` off) on the card, 3 steps at batch 8 from the
    same weights: losses within FUSED_UNFUSED_RTOL."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.analysis import fusion
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.models import transformer as T
    small = T.BertConfig(n_layer=2)
    s_main, s_startup, s_loss = _bert_program(small, BERT_SEQ)
    s_scope, host_scope = Scope(), Scope()
    exe.run(s_startup, scope=s_scope, seed=99)
    for name, val in s_scope.items():
        host_scope.set_var(name, val.detach().cpu())
    feed = _bert_feed(small, BERT_SMALL_BATCH, BERT_SEQ, seed=1)
    grads = ["mlm_out.w@GRAD", "enc_0.attn.qkv.w@GRAD",
             "enc_1.ffn.fc1.w@GRAD", "word_embedding@GRAD"]
    fetch = [s_loss.name] + grads
    card = exe.run(s_main, feed=feed, fetch_list=fetch, scope=s_scope,
                   seed=7)
    host_prog = fusion.fuse_program(
        s_main, fetch, feed_shapes={n: v.shape for n, v in feed.items()},
        device=exe.device)
    n_tail = sum(op.type == "fused_dense_act" and bool(op.attrs["seed"])
                 for op in host_prog.global_block().ops)
    t_c = time.perf_counter()
    host = ptt.Executor(ptt.CPUPlace()).run(
        host_prog, feed=feed, fetch_list=fetch, scope=host_scope, seed=7)
    host_s = time.perf_counter() - t_c
    loss_err = abs(float(card[0]) - float(host[0])) / abs(float(host[0]))
    errs = {n: _frac_err(c, h) for n, c, h in zip(grads, card[1:], host[1:])}
    bad = {n: e for n, e in errs.items() if not e[0] <= AMP_SMALL_FRAC}
    if not loss_err <= AMP_SMALL_LOSS_RTOL or bad:
        raise AssertionError(f"bert_train: AMP card step vs host: loss "
                             f"{float(card[0])} vs {float(host[0])} (rel "
                             f"{loss_err}), gradients beyond "
                             f"{AMP_SMALL_FRAC} x max|g|: {bad}")
    verdicts = ", ".join(
        f"{d['pattern']} {d['verdict']}" for d in
        host_prog._attrs.get("fusion", {}).get("candidates", []))
    _log("bert_train", f"2-layer batch-{BERT_SMALL_BATCH} seq-{BERT_SEQ} AMP "
         f"step, autotuned ({n_tail} fused_dense_act with the dropout tail; "
         f"verdicts {verdicts}), "
         f"vs the host at the same masks ({host_s:.1f} s): loss "
         f"{float(card[0]):.6f} vs {float(host[0]):.6f}, rel err "
         f"{loss_err:.3g} (rtol {AMP_SMALL_LOSS_RTOL:.3g}); grads max err / "
         f"max|g| (share beyond 2 bf16 ulps + 1e-3 max|g|): "
         + "; ".join(f"{n.split('@')[0]} {e[0]:.3g} ({e[1]:.2g})"
                     for n, e in errs.items())
         + f" (bound {AMP_SMALL_FRAC:.3g}) ok")

    saved = flags.get_flags(["FLAGS_fusion_autotune", "FLAGS_graph_fusion"])
    f_main, f_startup, f_loss = _bert_program(small, BERT_SEQ, amp=False)
    init = Scope()
    exe.run(f_startup, scope=init, seed=98)
    runs, n_fused = {}, {}
    try:
        for fused in (True, False):
            flags.set_flags({"FLAGS_fusion_autotune": False,
                             "FLAGS_graph_fusion": fused})
            sc = Scope()
            for name, val in init.items():
                sc.set_var(name, val.clone())
            fexe = ptt.Executor()
            runs[fused] = [float(fexe.run(
                f_main, feed=_bert_feed(small, 8, BERT_SEQ, seed=step),
                fetch_list=[f_loss], scope=sc, seed=50 + step)[0])
                for step in range(3)]
            plan = _adam_plan(fexe)
            n_fused[fused] = sum(op.type == "fused_dense_act" and
                                 bool(op.attrs["seed"])
                                 for op, _ in plan.ops)
    finally:
        flags.set_flags(saved)
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs[True], runs[False]))
    if n_fused != {True: 2, False: 0} or not rel <= FUSED_UNFUSED_RTOL:
        raise AssertionError(f"bert_train: fused vs unfused float32: losses "
                             f"{runs}, rel {rel}; fused dropout tails "
                             f"{n_fused}")
    _log("bert_train", f"2-layer batch-8 float32, fused ({n_fused[True]} "
         f"dropout tails, autotuner off) vs unfused on the card, 3 steps: "
         f"losses {', '.join(f'{x:.6f}' for x in runs[True])} vs "
         f"{', '.join(f'{x:.6f}' for x in runs[False])}, max rel "
         f"{rel:.3g} (rtol {FUSED_UNFUSED_RTOL}) ok")
    return {"amp_loss_rel_err": loss_err, "amp_grad_err_frac": errs,
            "amp_dropout_tails": n_tail, "amp_verdicts": verdicts,
            "fused_losses": runs[True], "unfused_losses": runs[False],
            "fused_vs_unfused_rel": rel}


def phase_bert_train(profile=False):
    """BERT-base MLM pretraining at bench.py's full configuration with its
    default dropout 0.1, the fusion autotuner on: the 12 FFN chains become
    ``fused_dense_act`` with the dropout tail (the bf16 K5 where the
    autotuner measured it faster) and the embedding LayerNorm the bf16 K4;
    every dropout and dropout gradient runs the dropout kernel in bf16.
    1 + BERT_STEPS steps; then the 2-layer checks (``_bert_small_checks``)
    and, with ``profile``, one step by kernel class."""
    import shutil
    import tempfile

    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.analysis import fusion
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.models import transformer as T

    cfg = T.BertConfig()
    assert cfg.dropout == 0.1
    cache_dir = tempfile.mkdtemp(prefix="fusion_autotune_")
    fusion.clear_cache()
    flags.set_flags(dict(FUSED_FLAGS, FLAGS_xla_compile_cache_dir=cache_dir))
    try:
        main, startup, loss = _bert_program(cfg, BERT_SEQ)
        types = [op.type for op in main.global_block().ops]
        n_drop = types.count("dropout") + types.count("dropout_grad")
        if n_drop != BERT_DROPOUTS:
            raise AssertionError(f"bert_train: {n_drop} dropout ops, "
                                 f"expected {BERT_DROPOUTS}")
        scope, exe = Scope(), ptt.Executor()
        exe.run(startup, scope=scope, seed=1234)
        n_params = sum(int(scope.find_var(p.name).numel())
                       for p in main.all_parameters())
        feed = _bert_feed(cfg, BERT_BATCH, BERT_SEQ)
        for name in _KERNEL_MODULES:
            _kernel_module(name).reset_launch_count()

        def counts():
            c = {k + "_bf16": v for k, v in _fused_launches("bfloat16")
                 .items()}
            c.update({"dropout_" + d: n for d, n in
                      _dropout_launches().items()})
            return c

        r = _run_steps("bert_train", exe, main, feed, loss, scope,
                       BERT_STEPS, counts)
        plan = _adam_plan(exe)
        ftypes = [op.type for op, _ in plan.ops]
        decisions = plan.block.program._attrs["fusion"]["candidates"]
        applied = {p: sum(d["verdict"] == "applied" for d in decisions
                          if d["pattern"] == p)
                   for p in ("dense_epilogue", "embedding_layer_norm")}
        tails = sum(op.type == "fused_dense_act" and bool(op.attrs["seed"])
                    for op, _ in plan.ops)
        launches = {k: sum(s[k] for s in r["per_step"])
                    for k in r["per_step"][0]}
        step = r["per_step"][-1]
        want = {"dropout_bfloat16": BERT_DROPOUTS, "dropout_float32": 0,
                "dense_epilogue_bf16": applied["dense_epilogue"],
                "layer_norm_fwd_bf16": applied["embedding_layer_norm"],
                "layer_norm_bwd_bf16": applied["embedding_layer_norm"]}
        got = {k: step[k] for k in want}
        if any(s["dropout_bfloat16"] != BERT_DROPOUTS
               for s in r["per_step"][1:]) or got != want or \
                not launches["dense_epilogue_bf16"] or \
                not launches["layer_norm_fwd_bf16"] or \
                not launches["layer_norm_bwd_bf16"]:
            raise AssertionError(f"bert_train: launches per step "
                                 f"{r['per_step']}, expected {want} a timed "
                                 f"step and K5, K4 bf16 launched")
        tokens = BERT_BATCH * BERT_SEQ
        r.update(launches=launches, tokens=tokens, n_params=n_params,
                 rate=tokens / (r["step_ms"] / 1e3), unit="tokens",
                 applied=applied, tails=tails, ops=len(ftypes))
        _log("bert_train", f"BERT-base MLM (vocab {cfg.vocab_size}, d "
             f"{cfg.d_model}, {cfg.n_layer} layers, dropout {cfg.dropout}; "
             f"{n_params / 1e6:.1f} M parameters), batch {BERT_BATCH} x seq "
             f"{BERT_SEQ}, AMP Adam, autotuner on: plan of {len(ftypes)} ops "
             f"({ftypes.count('fused_dense_act')} fused_dense_act, {tails} "
             f"with the dropout tail; applied {applied}); warm-up step "
             f"{r['warmup_s']:.2f} s, then {BERT_STEPS} steps of "
             f"{', '.join(f'{1e3 * x:.1f}' for x in r['step_s'])} ms "
             f"({r['rate']:.0f} tokens/s); losses "
             f"{', '.join(f'{x:.4f}' for x in r['losses'])}; launches a "
             f"step { {k: v for k, v in step.items() if v} } (warm-up "
             f"{ {k: v for k, v in r['per_step'][0].items() if v} }); peak "
             f"memory {r['peak_bytes'] / 2**30:.2f} GiB, of which "
             f"{r['held_bytes'] / 2**30:.2f} GiB allocated before the first "
             f"step")
        r["small"] = _bert_small_checks(exe)
        if profile:
            r["profile"] = _profile_step(
                f"BERT-base AMP training step, batch {BERT_BATCH} x seq "
                f"{BERT_SEQ} (autotuned)",
                lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope))
    finally:
        flags.set_flags(DEFAULT_FLAGS)
        shutil.rmtree(cache_dir, ignore_errors=True)
    return r


def phase_bert_masked():
    """bench.py's masked-gather BERT-base line: the encoder output gathered
    to 20 positions a sequence before the head; AMP Adam, default flags,
    1 + BERT_MASKED_STEPS steps."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.models import transformer as T
    cfg = T.BertConfig()
    main, startup, loss = _bert_program(cfg, BERT_SEQ,
                                        masked_gather=BERT_MASKED)
    types = [op.type for op in main.global_block().ops]
    assert types.count("gather") == 1, types.count("gather")
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=1234)
    feed = _bert_feed(cfg, BERT_BATCH, BERT_SEQ, n_mask=BERT_MASKED)
    r = _run_steps("bert_masked", exe, main, feed, loss, scope,
                   BERT_MASKED_STEPS, _dropout_launches)
    if any(s["bfloat16"] != BERT_DROPOUTS for s in r["per_step"]):
        raise AssertionError(f"bert_masked: dropout launches a step "
                             f"{r['per_step']}, expected {BERT_DROPOUTS}")
    tokens = BERT_BATCH * BERT_SEQ
    r.update(rate=tokens / (r["step_ms"] / 1e3), unit="tokens",
             launches={"dropout_bf16": sum(s["bfloat16"]
                                           for s in r["per_step"])})
    _log("bert_masked", f"BERT-base, masked_gather {BERT_MASKED}, batch "
         f"{BERT_BATCH} x seq {BERT_SEQ}, AMP Adam: warm-up step "
         f"{r['warmup_s']:.2f} s, then {BERT_MASKED_STEPS} steps of "
         f"{', '.join(f'{1e3 * x:.1f}' for x in r['step_s'])} ms "
         f"({r['rate']:.0f} tokens/s); losses "
         f"{', '.join(f'{x:.4f}' for x in r['losses'])}; dropout launches "
         f"{BERT_DROPOUTS} a step, bf16; peak memory "
         f"{r['peak_bytes'] / 2**30:.2f} GiB")
    return r


def phase_transformer_wmt():
    """Transformer-base WMT14 en-de at bench.py's configuration (WMT): AMP
    Adam, default flags, 1 + WMT_STEPS steps; every dropout and dropout
    gradient (43 + 43 a step) through the bf16 dropout kernel."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import amp as amp_mod
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    from paddle_tpu_torch.models import transformer as T
    v, seq = WMT["vocab"], WMT_SEQ
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss = T.build_transformer_nmt(
            v, v, seq, d_model=WMT["d_model"], n_layer=WMT["n_layer"],
            n_head=WMT["n_head"], d_inner=WMT["d_inner"], fused_head=True)
        amp_mod.decorate(optimizer.AdamOptimizer(1e-4)).minimize(loss)
    types = [op.type for op in main.global_block().ops]
    n_drop = types.count("dropout") + types.count("dropout_grad")
    if n_drop != WMT_DROPOUTS or types.count("assign_value") != 1:
        raise AssertionError(f"transformer_wmt: {n_drop} dropout ops "
                             f"(expected {WMT_DROPOUTS}), "
                             f"{types.count('assign_value')} assign_value")
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=1234)
    n_params = sum(int(scope.find_var(p.name).numel())
                   for p in main.all_parameters())
    rng = np.random.RandomState(0)
    pos = np.tile(np.arange(seq), (WMT_BATCH, 1))
    feed = {"src_ids": rng.randint(1, v, (WMT_BATCH, seq)), "src_pos": pos,
            "trg_ids": rng.randint(1, v, (WMT_BATCH, seq)), "trg_pos": pos,
            "label": rng.randint(1, v, (WMT_BATCH, seq))}
    r = _run_steps("transformer_wmt", exe, main, feed, loss.name, scope,
                   WMT_STEPS, _dropout_launches)
    if any(s["bfloat16"] != WMT_DROPOUTS or s["float32"]
           for s in r["per_step"]):
        raise AssertionError(f"transformer_wmt: dropout launches a step "
                             f"{r['per_step']}, expected {WMT_DROPOUTS} "
                             f"bf16")
    tokens = 2 * WMT_BATCH * seq
    r.update(rate=tokens / (r["step_ms"] / 1e3), unit="tokens",
             n_params=n_params,
             launches={"dropout_bf16": sum(s["bfloat16"]
                                           for s in r["per_step"])})
    _log("transformer_wmt", f"Transformer-base NMT (V {v}, d "
         f"{WMT['d_model']}, {WMT['n_layer']} + {WMT['n_layer']} layers, "
         f"{WMT['n_head']} heads, F {WMT['d_inner']}, dropout 0.1; "
         f"{n_params / 1e6:.1f} M parameters), batch {WMT_BATCH} x seq {seq}"
         f", AMP Adam: warm-up step {r['warmup_s']:.2f} s, then {WMT_STEPS} "
         f"steps of {', '.join(f'{1e3 * x:.1f}' for x in r['step_s'])} ms "
         f"({r['rate']:.0f} source + target tokens/s); losses "
         f"{', '.join(f'{x:.4f}' for x in r['losses'])}; dropout launches "
         f"{WMT_DROPOUTS} a step, bf16; peak memory "
         f"{r['peak_bytes'] / 2**30:.2f} GiB, of which "
         f"{r['held_bytes'] / 2**30:.2f} GiB allocated before the first "
         f"step")
    return r


def phase_se_resnext():
    """SE-ResNeXt-50 (``build_se_resnext_train``: 3x224x224, 1000 classes,
    cardinality 32, the head's dropout 0.5) under
    ``MomentumOptimizer(0.1, 0.9)``, float32, TF32 off, batch SE_BATCH,
    1 + SE_STEPS steps: finite losses, the head's dropout and its gradient
    through the float32 kernel each step; whether the fusion pass took the
    1x1 conv + BN pairs into K3 is reported, not held."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    from paddle_tpu_torch.kernels import conv_bn as cb
    from paddle_tpu_torch.models import resnet
    main, startup = Program(), Program()
    with program_guard(main, startup):
        loss, _, _ = resnet.build_se_resnext_train(image_shape=SE_IMAGE)
        optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=1234)
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(SE_BATCH, *SE_IMAGE).astype(np.float32),
            "label": rng.randint(0, 1000, (SE_BATCH, 1))}

    def counts():
        c = _dropout_launches()
        c["conv1x1_stats"] = cb.launch_count("conv1x1_stats")
        return c

    assert not torch.backends.cudnn.allow_tf32
    r = _run_steps("se_resnext", exe, main, feed, loss.name, scope, SE_STEPS,
                   counts)
    if any(s["float32"] != 2 or s["bfloat16"] for s in r["per_step"]):
        raise AssertionError(f"se_resnext: dropout launches a step "
                             f"{r['per_step']}, expected 2 float32")
    plan = _train_plan(exe)
    ftypes = [op.type for op, _ in plan.ops]
    r.update(rate=SE_BATCH / (r["step_ms"] / 1e3), unit="images",
             fused_conv1x1_bn=ftypes.count("fused_conv1x1_bn"),
             k3_per_step=r["per_step"][-1]["conv1x1_stats"],
             launches={"dropout": sum(s["float32"] for s in r["per_step"])})
    _log("se_resnext", f"SE-ResNeXt-50 (32 x 4d groups, SE ratio 16), batch "
         f"{SE_BATCH} x {'x'.join(map(str, SE_IMAGE))}, Momentum, float32, TF32 off: warm-up "
         f"step {r['warmup_s']:.2f} s, then {SE_STEPS} steps of "
         f"{', '.join(f'{1e3 * x:.1f}' for x in r['step_s'])} ms "
         f"({r['rate']:.1f} images/s); losses "
         f"{', '.join(f'{x:.4f}' for x in r['losses'])}; the fusion pass "
         f"took {r['fused_conv1x1_bn']} conv1x1 + BN pairs into "
         f"fused_conv1x1_bn (K3 launches a step: {r['k3_per_step']}); "
         f"dropout launches 2 a step, float32; peak memory "
         f"{r['peak_bytes'] / 2**30:.2f} GiB")
    return r


_KERNELS = (
    ("flash_attn_fwd", "paddle_tpu_torch/csrc/flash_attn_fwd_sm90.cu",
     "paddle_tpu/pallas/flash_attention.py:179"),
    ("flash_attn_bwd", "paddle_tpu_torch/csrc/flash_attn_bwd_sm90.cu",
     "paddle_tpu/pallas/flash_attention.py:499"),
    ("conv1x1_stats", "paddle_tpu_torch/csrc/conv1x1_stats.cu",
     "paddle_tpu/pallas/conv_bn.py:143"),
    ("layer_norm_fwd", "paddle_tpu_torch/csrc/layer_norm.cu",
     "paddle_tpu/pallas/layer_norm.py:92"),
    ("layer_norm_bwd", "paddle_tpu_torch/csrc/layer_norm.cu",
     "paddle_tpu/pallas/layer_norm.py:111"),
    ("dense_epilogue", "paddle_tpu_torch/csrc/dense_epilogue.cu",
     "paddle_tpu/pallas/dense_epilogue.py:69"),
    ("matmul_bn_stats", "paddle_tpu_torch/csrc/matmul_bn_stats.cu",
     "paddle_tpu/pallas/conv_bn.py:58"),
    ("attn_skeleton_fwd", "paddle_tpu_torch/csrc/attn_skeleton_sm90.cu",
     "tools/attn_shape_ceiling.py:38"),
    ("attn_skeleton_bwd", "paddle_tpu_torch/csrc/attn_skeleton_sm90.cu",
     "tools/attn_shape_ceiling.py:78"),
    ("ring_merge", "paddle_tpu_torch/csrc/ring_attention.cu",
     "paddle_tpu/pallas/ring_attention.py:70"),
    ("dropout", "paddle_tpu_torch/csrc/dropout.cu",
     "paddle_tpu/ops/nn_ops.py:647"),
)


#: the kernels with a bf16 form (AMP), listed as ``<name>_bf16``
_BF16_FORMS = ("flash_attn_fwd", "flash_attn_bwd", "conv1x1_stats",
               "layer_norm_fwd", "layer_norm_bwd", "dense_epilogue",
               "ring_merge", "dropout")


def _lamb_excluded(param):
    """The BERT recipe's LAMB: no weight decay on LayerNorm scales and
    biases (``enc_i.ln1.w``, ``pre_encoder.ln.w``, every ``*.b``)."""
    return param.name.endswith(".b") or ".ln" in param.name


def _recompute_program(cfg, seq, recompute):
    """``build_bert_pretrain`` as ``_bert_program`` builds it, under
    ``amp.decorate(LambOptimizer)``: (a) as it is, (b) through
    ``RecomputeOptimizer`` with the layer outputs ``checkpoints=[]``
    collects.  Fresh names, so (a) and (b) name every var alike."""
    from paddle_tpu_torch import amp as amp_mod
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import transformer as T
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        ckpts = [] if recompute else None
        _, _, loss = T.build_bert_pretrain(cfg, seq, fused_head=True,
                                           arange_pos=True,
                                           checkpoints=ckpts)
        opt = optimizer.LambOptimizer(
            LAMB_LR, lamb_weight_decay=LAMB_DECAY,
            exclude_from_weight_decay_fn=_lamb_excluded)
        if recompute:
            opt = optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(ckpts)
        amp_mod.decorate(opt).minimize(loss)
    return main, startup, loss


def _optimizer_plan(exe, op_type):
    plan, = [p for p in exe._plans.values()
             if any(op.type == op_type for op, _ in p.ops)]
    return plan


def _planned_launches(plan):
    """The launches a step of ``plan`` makes, from its ops: K5 one a
    ``fused_dense_act`` with its kernel, K4 forward and backward one a
    ``fused_embedding_layer_norm`` and its grad with the kernel, and the
    dropout kernel one a ``dropout``, a ``dropout_grad`` and a fused op or
    fused grad op with a dropout tail."""
    ops = [op for op, _ in plan.ops]

    def n(op_type, kernel=False, tail=False):
        return sum(op.type == op_type
                   and (not kernel or bool(op.attrs.get("use_pallas")))
                   and (not tail or op.attrs.get("dropout_prob", 0) > 0)
                   for op in ops)
    return {"dense_epilogue_bf16": n("fused_dense_act", kernel=True),
            "layer_norm_fwd_bf16": n("fused_embedding_layer_norm",
                                     kernel=True),
            "layer_norm_bwd_bf16": n("fused_embedding_layer_norm_grad",
                                     kernel=True),
            "dropout_bfloat16": n("dropout") + n("dropout_grad")
            + n("fused_dense_act", tail=True)
            + n("fused_dense_act_grad", tail=True)}


def phase_recompute_train():
    """BERT-base at ``bert_train``'s configuration (``BertConfig()``, batch
    128 x seq 128, dropout 0.1, fused head, arange positions, AMP, the
    fusion autotuner on) under the published large-batch BERT optimizer,
    LAMB, built twice at one seed: (a) ``amp.decorate(Lamb).minimize`` and
    (b) ``amp.decorate(RecomputeOptimizer(Lamb))`` over the 12 layer
    outputs.  Both share one autotune cache, start from the same weights
    and take 1 + RECOMPUTE_STEPS steps on one batch: their losses must be
    equal to the bit, (b)'s peak above what was allocated before its first
    step lower than (a)'s, and each timed step's K5, K4 and dropout
    launches those its plan's ops give."""
    import shutil
    import tempfile

    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.analysis import fusion
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.framework.recompute import RECOMPUTE_SUFFIX
    from paddle_tpu_torch.models import transformer as T

    cfg = T.BertConfig()
    cache_dir = tempfile.mkdtemp(prefix="fusion_autotune_")
    fusion.clear_cache()
    flags.set_flags(dict(FUSED_FLAGS, FLAGS_xla_compile_cache_dir=cache_dir))
    feed = _bert_feed(cfg, BERT_BATCH, BERT_SEQ)
    out = {}
    try:
        progs = {k: _recompute_program(cfg, BERT_SEQ, k == "b")
                 for k in ("a", "b")}
        init, exe = Scope(), ptt.Executor()
        exe.run(progs["a"][1], scope=init, seed=1234)
        scopes = {}
        for k in progs:
            scopes[k] = Scope()
            for name, val in init.items():
                scopes[k].set_var(name, val.clone())
        del init
        for name in _KERNEL_MODULES:
            _kernel_module(name).reset_launch_count()

        def counts():
            c = {k + "_bf16": v for k, v in _fused_launches("bfloat16")
                 .items()}
            c.update({"dropout_" + d: n for d, n in
                      _dropout_launches().items()})
            return c

        for k, (main, _, loss) in progs.items():
            kexe = ptt.Executor()
            r = _run_steps(f"recompute_train ({k})", kexe, main, feed, loss,
                           scopes[k], RECOMPUTE_STEPS, counts)
            plan = _optimizer_plan(kexe, "lamb")
            want = _planned_launches(plan)
            for s in r["per_step"][1:]:
                got = {n: s[n] for n in want}
                if got != want or s["dropout_float32"]:
                    raise AssertionError(
                        f"recompute_train ({k}): launches a step {s}, "
                        f"the plan's ops give {want}")
            ops = [op for op, _ in plan.ops]
            r.update(
                launches={n: sum(s[n] for s in r["per_step"])
                          for n in r["per_step"][0]},
                planned=want, ops=len(ops),
                recomputed=sum(any(RECOMPUTE_SUFFIX in n
                                   for n in op.output_arg_names())
                               for op in ops),
                barriers=sum(op.type == "optimization_barrier"
                             for op in ops),
                median_ms=1e3 * float(np.median(r["step_s"])),
                above_bytes=r["peak_bytes"] - r["held_bytes"])
            r["rate"] = BERT_BATCH * BERT_SEQ / (r["median_ms"] / 1e3)
            out[k] = r
            _log("recompute_train", f"({k}) BERT-base, batch {BERT_BATCH} x "
                 f"seq {BERT_SEQ}, AMP LAMB"
                 + (f", recompute over the {cfg.n_layer} layer outputs"
                    if k == "b" else "")
                 + f": plan of {len(ops)} ops ({r['recomputed']} recomputed,"
                 f" {r['barriers']} barriers); warm-up "
                 f"{r['warmup_s']:.2f} s, steps "
                 f"{', '.join(f'{1e3 * x:.1f}' for x in r['step_s'])} ms "
                 f"(median {r['median_ms']:.1f}, {r['rate']:.0f} tokens/s); "
                 f"losses {', '.join(repr(x) for x in r['losses'])}; "
                 f"launches a step {want} (the plan's); peak "
                 f"{r['peak_bytes'] / 2**30:.3f} GiB, "
                 f"{r['above_bytes'] / 2**30:.3f} GiB above the "
                 f"{r['held_bytes'] / 2**30:.3f} GiB held before the first "
                 f"step")
            del kexe, plan, ops
            torch.cuda.empty_cache()
    finally:
        flags.set_flags(DEFAULT_FLAGS)
        shutil.rmtree(cache_dir, ignore_errors=True)
    a, b = out["a"], out["b"]
    equal = np.array_equal(np.asarray(a["losses"], np.float32),
                           np.asarray(b["losses"], np.float32))
    if not equal:
        raise AssertionError(f"recompute_train: losses (a) {a['losses']} "
                             f"and (b) {b['losses']} differ")
    if not b["above_bytes"] < a["above_bytes"]:
        raise AssertionError(f"recompute_train: (b) holds "
                             f"{b['above_bytes']} bytes above its start, "
                             f"(a) {a['above_bytes']}")
    _log("recompute_train", f"(a) and (b) losses equal to the bit over "
         f"{RECOMPUTE_STEPS + 1} steps; peak above start "
         f"{a['above_bytes'] / 2**30:.3f} -> "
         f"{b['above_bytes'] / 2**30:.3f} GiB; median step "
         f"{a['median_ms']:.1f} -> {b['median_ms']:.1f} ms "
         f"({b['median_ms'] / a['median_ms']:.3f}x) ok")
    return out


# ---------------------------------------------------------------------------
# seq2seq: control flow on the card (tests/_seq2seq.py's model)
# ---------------------------------------------------------------------------

def _seq2seq_module():
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import _seq2seq
    return _seq2seq


def _scalar(v):
    return float(np.asarray(v).reshape(-1)[0])


def _join(xs, fmt=".6f"):
    return ", ".join(format(x, fmt) for x in xs)


def _seq2seq_train(smi, S, cfg):
    """``seq2seq`` (a): SEQ2SEQ_STEPS Adam steps of the training program on
    the card and on the host, each from the host's state; returns the
    host's scope (its trained weights) and the report."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.ops import control_flow_ops as cf
    main, startup, loss = S.build_train(ptt, cfg, dropout=SEQ2SEQ_DROPOUT)
    blk = main.global_block()
    grads = [n + "@GRAD.clip_0" for n in SEQ2SEQ_GRADS]
    if not all(blk.has_var(n) for n in grads):
        raise AssertionError(f"seq2seq (a): the clipped gradients {grads} "
                             f"are not all in the program")
    host, card = ptt.Executor(ptt.CPUPlace()), ptt.Executor()
    host_scope, card_scope = Scope(), Scope()
    host.run(startup, scope=host_scope, seed=SEQ2SEQ_SEED)
    names = [n for n in startup.global_block().vars
             if host_scope.find_var(n) is not None]
    feeds = [S.train_feed(cfg, SEQ2SEQ_BATCH, seed=s)
             for s in range(SEQ2SEQ_STEPS)]
    rows = []
    for s, f in enumerate(feeds):
        # each step starts from the host's state: a step's difference is
        # its own, not the sum of the steps before it
        for n in names:
            card_scope.set_var(n, host_scope.find_var(n).to(card.device))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        cf.reset_host_syncs()
        t0 = time.perf_counter()
        c_out = card.run(main, feed=f, fetch_list=[loss] + grads,
                         scope=card_scope, seed=SEQ2SEQ_SEED + 1 + s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        body_ops = cf.host_syncs()["body_ops"]
        peak = torch.cuda.max_memory_allocated() - held
        h_out = host.run(main, feed=f, fetch_list=[loss] + grads,
                         scope=host_scope, seed=SEQ2SEQ_SEED + 1 + s)
        t2 = time.perf_counter()
        lc, lh = _scalar(c_out[0]), _scalar(h_out[0])
        rel = abs(lc - lh) / abs(lh)
        if not (np.isfinite(lc) and rel <= SEQ2SEQ_LOSS_RTOL):
            raise AssertionError(f"seq2seq (a) step {s}: loss {lc} on the "
                                 f"card, {lh} on the host (relative "
                                 f"{rel:.3g}, limit {SEQ2SEQ_LOSS_RTOL})")
        errs = {n: _rel_diff(torch.from_numpy(np.asarray(c)).to(card.device),
                             torch.from_numpy(np.asarray(h)))
                for n, c, h in zip(SEQ2SEQ_GRADS, c_out[1:], h_out[1:])}
        bad = {n: e for n, e in errs.items() if not e <= SEQ2SEQ_GRAD_RTOL}
        if bad:
            raise AssertionError(f"seq2seq (a) step {s}: clipped gradients "
                                 f"{bad} apart (norm of the difference "
                                 f"over the host's; limit "
                                 f"{SEQ2SEQ_GRAD_RTOL})")
        rows.append({"loss": lc, "host_loss": lh, "rel": rel,
                     "grad_rel": errs, "card_ms": 1e3 * (t1 - t0),
                     "host_ms": 1e3 * (t2 - t1), "peak_bytes": peak,
                     "held_bytes": held, "body_ops": body_ops})
    n_global = len(blk.ops)
    subs = [len(b.ops) for b in main.blocks[1:]]
    # the ops run inside the loops' bodies are counted as they run (each
    # scan's body cfg.seq times forward and again in its grad's replay)
    dispatched = n_global + rows[-1]["body_ops"]
    n_dropout = sum(op.type in ("dropout", "dropout_grad")
                    for op in blk.ops)
    gib = 2.0 ** 30
    _log("seq2seq", f"(a) rnn_search at 2 x {cfg.hidden}, vocab "
         f"{cfg.src_vocab} / {cfg.trg_vocab}, batch {SEQ2SEQ_BATCH} x "
         f"{cfg.seq}, dropout {SEQ2SEQ_DROPOUT}, Adam({cfg.lr}) clipped at "
         f"global norm {cfg.clip}: {SEQ2SEQ_STEPS} steps card vs host, each "
         f"from the host's state: losses "
         f"{_join(r['loss'] for r in rows)} (host "
         f"{_join(r['host_loss'] for r in rows)}), worst "
         f"relative {max(r['rel'] for r in rows):.3g} (limit "
         f"{SEQ2SEQ_LOSS_RTOL}); clipped gradients (norm of the difference "
         f"over the host's, limit {SEQ2SEQ_GRAD_RTOL}): "
         + ", ".join(f"{n} {max(r['grad_rel'][n] for r in rows):.3g}"
                     for n in SEQ2SEQ_GRADS))
    _log("seq2seq", f"(a) card steps "
         f"{_join((r['card_ms'] for r in rows), '.1f')} ms (host clock "
         f"ending in a synchronize; the first builds the plan), host steps "
         f"{_join((r['host_ms'] for r in rows), '.0f')} ms; "
         f"peak {max(r['peak_bytes'] for r in rows) / gib:.3f} GiB above "
         f"{rows[-1]['held_bytes'] / gib:.3f} held; a step dispatches "
         f"{dispatched} ops ({n_global} in the global block, "
         f"{_join((r['body_ops'] for r in rows), 'd')} counted inside "
         f"sub-blocks of {subs} ops, forward and the grads' replay); on "
         f"{smi}")
    return host_scope, {"steps": rows, "global_ops": n_global,
                        "sub_block_ops": subs, "ops_a_step": dispatched,
                        "dropout_ops": n_dropout}


class _BeamRecord:
    """Record each ``beam_search`` call's inputs and outputs on the host
    (numpy) while it is entered: the decode's steps, one list a run."""

    def __init__(self):
        from paddle_tpu_torch.framework import registry
        self.info = registry.get_op_info("beam_search")
        self.calls = []

    def __enter__(self):
        lower = self.saved = self.info.lower

        def run(ctx, ins, attrs):
            out = lower(ctx, ins, attrs)
            if ctx.device.type != "meta":
                self.calls.append((
                    {k: [t.detach().cpu() for t in v if t is not None]
                     for k, v in ins.items()}, dict(attrs),
                    {k: v[0].detach().cpu().numpy() for k, v in out.items()}))
            return out
        self.info.lower = run
        return self

    def __exit__(self, *exc):
        self.info.lower = self.saved


def _tie_gap(call, sentence, slot):
    """In a recorded host ``beam_search`` call, the gap between one
    sentence's candidates ranked ``slot`` and ``slot + 1``: the two whose
    order decides that slot."""
    import torch
    from paddle_tpu_torch.ops.structured_ops import beam_candidates
    ins, attrs, _ = call
    scores, _ = beam_candidates({k: v for k, v in ins.items() if v}, attrs)
    s = torch.sort(scores[sentence].double(), descending=True).values
    return float(s[slot] - s[slot + 1])


def _seq2seq_decode(smi, S, cfg, trained):
    """``seq2seq`` (b): the decode program saved with
    ``save_inference_model``, loaded on the card and on the host, run on
    SEQ2SEQ_DECODE_BATCH sentences."""
    import tempfile
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.ops import control_flow_ops as cf
    batch = SEQ2SEQ_DECODE_BATCH
    dm, ds, feed_names, fetch = S.build_decode(ptt, cfg, batch)
    host, card = ptt.Executor(ptt.CPUPlace()), ptt.Executor()
    hs = Scope()
    host.run(ds, scope=hs, seed=SEQ2SEQ_SEED)
    carried = [n for n in hs.local_var_names()
               if trained.find_var(n) is not None]
    for n in carried:
        hs.set_var(n, trained.find_var(n).clone())
    with tempfile.TemporaryDirectory(prefix="pt_seq2seq_") as d:
        ptt.io.save_inference_model(d, feed_names, fetch, host,
                                    main_program=dm, scope=hs)
        card_sc, host_sc = Scope(), Scope()
        prog, names, fetch_names = ptt.io.load_inference_model(
            d, card, scope=card_sc)
        hprog, _, _ = ptt.io.load_inference_model(d, host, scope=host_sc)
    whiles = [op for op in prog.global_block().ops if op.type == "while"]
    if len(whiles) != 1 or len(prog.blocks) < 2:
        raise AssertionError(f"seq2seq (b): the loaded program holds "
                             f"{len(whiles)} while ops and "
                             f"{len(prog.blocks)} blocks")
    feed = S.decode_feed(cfg, batch, seed=SEQ2SEQ_SEED + 11)
    fd = {n: feed[n] for n in names}
    rec_h, rec_c = _BeamRecord(), _BeamRecord()
    with rec_h:
        h_ids, h_scores = (np.asarray(v) for v in host.run(
            hprog, feed=fd, fetch_list=fetch_names, scope=host_sc))
    with rec_c:
        c_ids, c_scores = (np.asarray(v) for v in card.run(
            prog, feed=fd, fetch_list=fetch_names, scope=card_sc))
    # timed again without the recorder
    cf.reset_host_syncs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.run(prog, feed=fd, fetch_list=fetch_names, scope=card_sc)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    syncs = cf.host_syncs()
    want = (batch, cfg.beam, cfg.max_len + 1)
    if c_ids.shape != want or h_ids.shape != want or \
            not np.isfinite(c_scores).all():
        raise AssertionError(f"seq2seq (b): ids {c_ids.shape} on the card, "
                             f"{h_ids.shape} on the host, want {want}")
    if len(rec_c.calls) != len(rec_h.calls) or \
            syncs["while_iterations"] != len(rec_h.calls):
        raise AssertionError(f"seq2seq (b): {len(rec_c.calls)} beam steps "
                             f"on the card, {len(rec_h.calls)} on the host, "
                             f"{syncs}")
    # where a sentence's ids differ, the first slot of the first step
    # whose choice differs must be a near-tie on the host: its candidates
    # ranked there and next within SEQ2SEQ_TIE
    differ = [b for b in range(batch) if not np.array_equal(c_ids[b],
                                                             h_ids[b])]
    ties = {}
    for b in differ:
        rows = slice(b * cfg.beam, (b + 1) * cfg.beam)
        step = slot = gap = None
        for t, (c, h) in enumerate(zip(rec_c.calls, rec_h.calls)):
            same = np.logical_and.reduce([
                c[2][k][rows].reshape(-1) == h[2][k][rows].reshape(-1)
                for k in ("selected_ids", "parent_idx")])
            if not same.all():
                step, slot = t, int(np.argmin(same))
                gap = _tie_gap(h, b, slot)
                break
        if gap is None or not gap <= SEQ2SEQ_TIE:
            raise AssertionError(f"seq2seq (b): sentence {b}'s ids differ "
                                 f"from the host's, first at beam step "
                                 f"{step} slot {slot}, where the host's "
                                 f"candidates ranked there and next are "
                                 f"{gap} apart (a near-tie is within "
                                 f"{SEQ2SEQ_TIE})")
        ties[b] = (step, slot, gap)
    same = np.all(c_ids == h_ids, axis=2)                 # [batch, beam]
    err = np.abs(c_scores - h_scores) / np.maximum(np.abs(h_scores), 1.0)
    worst = float(err[same].max()) if same.any() else 0.0
    if not worst <= SEQ2SEQ_SCORE_RTOL:
        raise AssertionError(f"seq2seq (b): scores {worst:.3g} apart where "
                             f"the ids agree (limit {SEQ2SEQ_SCORE_RTOL})")
    _log("seq2seq", f"(b) the decode program (BeamSearchDecoder, beam "
         f"{cfg.beam}, topk {cfg.beam}, max_len {cfg.max_len}, end_id "
         f"{cfg.end_id}) after save_inference_model / load_inference_model "
         f"({len(prog.blocks)} blocks, the while's body "
         f"{len(prog.blocks[1].ops)} ops), (a)'s trained weights "
         f"({len(carried)} tensors), {batch} sentences = "
         f"{batch * cfg.beam} beam rows: ids equal to the host's in "
         f"{batch - len(differ)} of {batch} sentences"
         + (f" (the others first part at a near-tie on the host, "
            f"sentence: (step, slot, gap) {ties})" if ties else "")
         + f"; scores where the ids agree within {worst:.3g} relative "
         f"(limit {SEQ2SEQ_SCORE_RTOL}); a decode {ms:.1f} ms (host clock "
         f"ending in a synchronize), {syncs['while_iterations']} while "
         f"iterations, {syncs['while']} host syncs of its condition; "
         f"on {smi}")
    return {"ms": ms, "syncs": syncs, "differ": ties, "score_rel": worst,
            "beam_steps": len(rec_h.calls)}


def _geometric_loop(layers, ptt, width, w_val, grads):
    """``tests/test_while_grad.py``'s loop at ``width``: acc = x times w
    three times under a While bounded at 4 trips; loss = mean(acc)."""
    x = layers.data("x", shape=[width], dtype="float32")
    x.stop_gradient = False
    w = layers.create_parameter(
        [1], "float32", name="w_scale",
        default_initializer=ptt.initializer.ConstantInitializer(w_val))
    i = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    limit = layers.fill_constant(shape=[1], dtype="float32", value=3.0)
    acc = layers.elementwise_mul(x, layers.ones_like(x))
    cond = layers.less_than(i, limit)
    wh = layers.While(cond, max_trip_count=4)
    with wh.block():
        layers.assign(layers.elementwise_mul(acc, w), acc)
        layers.increment(i, 1.0)
        layers.less_than(i, limit, cond=cond)
    loss = layers.mean(acc)
    if grads:
        ptt.append_backward(loss)
        return [loss, "x@GRAD", "w_scale@GRAD"]
    return [loss]


def _seq2seq_while_grad(smi):
    """``seq2seq`` (c): one case of ``test_while_grad_numeric_parity`` at
    width SEQ2SEQ_WHILE_WIDTH on the card against the host, and against
    central differences."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                            unique_name)
    xv = np.random.RandomState(SEQ2SEQ_SEED).randn(
        4, SEQ2SEQ_WHILE_WIDTH).astype(np.float32)

    def run(exe, w_val, grads):
        main, startup = Program(), Program()
        with unique_name.guard(), program_guard(main, startup):
            fetch = _geometric_loop(layers, ptt, SEQ2SEQ_WHILE_WIDTH, w_val,
                                    grads)
        sc = Scope()
        exe.run(startup, scope=sc)
        return [np.asarray(v) for v in exe.run(main, feed={"x": xv},
                                               fetch_list=fetch, scope=sc)]
    card, host = ptt.Executor(), ptt.Executor(ptt.CPUPlace())
    c, h = run(card, 1.2, True), run(host, 1.2, True)
    for what, a, b in zip(("loss", "x@GRAD", "w_scale@GRAD"), c, h):
        if not np.allclose(a, b, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"seq2seq (c): {what} on the card "
                                 f"{a.ravel()[:4]} against the host's "
                                 f"{b.ravel()[:4]}")
    eps = 1e-2
    numeric = (_scalar(run(card, 1.2 + eps, False)[0]) -
               _scalar(run(card, 1.2 - eps, False)[0])) / (2 * eps)
    gw = _scalar(c[2])
    if not abs(gw - numeric) <= 1e-3 * abs(numeric):
        raise AssertionError(f"seq2seq (c): d loss / d w {gw} against "
                             f"central differences {numeric}")
    _log("seq2seq", f"(c) the bounded While's gradient (x [4, "
         f"{SEQ2SEQ_WHILE_WIDTH}] times w three times, max_trip_count 4): "
         f"loss, x@GRAD and w@GRAD on the card within atol {ATOL} + rtol "
         f"{RTOL} of the host's; d loss / d w {gw:.6f} against central "
         f"differences {numeric:.6f} (rtol 1e-3)")
    return {"w_grad": gw, "numeric": numeric}


def _seq2seq_rnn_dropout(smi, cfg):
    """``seq2seq`` (d): a StaticRNN whose body holds an untagged dropout
    (``seed=0``: its masks come from the run's counter) at the path's
    batch, length and width.  The gradient replays the body under
    ``torch.autograd``, so the dropout kernel runs inside its autograd
    Function and the counter rewinds to the forward's; the loss and the
    gradients of x and of the cell's weight on the card against the host
    (the same Philox streams), and the kernel's launches: the forward's,
    the replay's and their backward's, one a step each."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                            unique_name)
    T, B, H = cfg.seq, SEQ2SEQ_BATCH, cfg.hidden
    main, startup = Program(), Program()
    with unique_name.guard(), program_guard(main, startup):
        x = layers.data("x", shape=[T, B, H], dtype="float32",
                        append_batch_size=False)
        x.stop_gradient = False
        rnn = layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(shape=[-1, H], batch_ref=x_t)
            h = layers.fc(layers.concat([x_t, h_prev], axis=1), size=H,
                          act="tanh", param_attr="drnn_w",
                          bias_attr="drnn_b")
            d = layers.dropout(h, SEQ2SEQ_DROPOUT, seed=0,
                               dropout_implementation="upscale_in_train")
            rnn.update_memory(h_prev, d)
            rnn.step_output(d)
        loss = layers.mean(rnn())
        ptt.append_backward(loss)
    fetch = [loss, "x@GRAD", "drnn_w@GRAD"]
    xv = np.random.RandomState(SEQ2SEQ_SEED).randn(T, B, H).astype(
        np.float32)
    host, card = ptt.Executor(ptt.CPUPlace()), ptt.Executor()
    hs, cs = Scope(), Scope()
    host.run(startup, scope=hs, seed=SEQ2SEQ_SEED)
    for n in startup.global_block().vars:
        if hs.find_var(n) is not None:
            cs.set_var(n, hs.find_var(n).to(card.device))
    n0 = _launches_nonzero().get("dropout", 0)
    c = card.run(main, feed={"x": xv}, fetch_list=fetch, scope=cs,
                 seed=SEQ2SEQ_SEED)
    launches = _launches_nonzero().get("dropout", 0) - n0
    h = host.run(main, feed={"x": xv}, fetch_list=fetch, scope=hs,
                 seed=SEQ2SEQ_SEED)
    lc, lh = _scalar(c[0]), _scalar(h[0])
    rel = abs(lc - lh) / abs(lh)
    errs = {n: _rel_diff(torch.from_numpy(np.asarray(a)).to(card.device),
                         torch.from_numpy(np.asarray(b)))
            for n, a, b in zip(fetch[1:], c[1:], h[1:])}
    norms = {n: float(np.linalg.norm(a)) for n, a in zip(fetch[1:], c[1:])}
    if not (np.isfinite(lc) and rel <= SEQ2SEQ_LOSS_RTOL) or \
            not all(e <= SEQ2SEQ_GRAD_RTOL for e in errs.values()) or \
            not all(v > 0 for v in norms.values()):
        raise AssertionError(f"seq2seq (d): loss {lc} on the card, {lh} on "
                             f"the host; gradients {errs} apart (limit "
                             f"{SEQ2SEQ_GRAD_RTOL}), norms on the card "
                             f"{norms}")
    if launches != 3 * T:
        raise AssertionError(f"seq2seq (d): the dropout kernel launched "
                             f"{launches} times, expected {3 * T} (the "
                             f"forward, the replay and its backward, "
                             f"{T} steps each)")
    _log("seq2seq", f"(d) StaticRNN [{T}, {B}, {H}] with an untagged "
         f"dropout {SEQ2SEQ_DROPOUT} in its body: loss relative "
         f"{rel:.3g}, gradients (norm of the difference over the host's) "
         + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
         + f" (limit {SEQ2SEQ_GRAD_RTOL}); dropout launches {launches}; "
         f"on {smi}")
    return {"loss_rel": rel, "grad_rel": errs, "launches": launches}


def phase_seq2seq(smi):
    """Control flow on the card (module docstring): (a) training, (b) beam
    decoding after a save and load, (c) the bounded While's gradient, (d)
    a dropout inside a StaticRNN's body, differentiated."""
    import torch
    from paddle_tpu_torch.kernels import dropout as dk
    from paddle_tpu_torch.ops.nn_ops import dropout_scale
    t_phase = time.perf_counter()
    S = _seq2seq_module()
    cfg = S.Seq2SeqConfig()
    _reset_launches()
    trained, a = _seq2seq_train(smi, S, cfg)
    b = _seq2seq_decode(smi, S, cfg, trained)
    c = _seq2seq_while_grad(smi)
    d = _seq2seq_rnn_dropout(smi, cfg)
    launches = _launches_nonzero()
    want = {"dropout": a["dropout_ops"] * SEQ2SEQ_STEPS + d["launches"]}
    if launches != want:
        raise AssertionError(f"seq2seq: kernels launched {launches}, "
                             f"expected {want} (the dropout between the "
                             f"encoder's layers and its grad, a step, "
                             f"and (d)'s)")
    # the dropout kernel on the path's input against its plain version
    x = torch.randn(SEQ2SEQ_BATCH, cfg.seq, cfg.hidden, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(29))
    stream = dk.tagged_stream(0x5E025E0, 0x7FFFFF29)
    thr = dk.threshold(SEQ2SEQ_DROPOUT)
    scale = dropout_scale({"dropout_prob": SEQ2SEQ_DROPOUT})
    got = dk.dropout_fwd(x, stream, thr, scale)[0]
    ref = dk.dropout_plain(x, stream, thr, scale)[0]
    if not _bits_equal(got, ref):
        raise AssertionError("seq2seq: the dropout kernel differs from its "
                             "plain version at the path's shape")
    wall = time.perf_counter() - t_phase
    _log("seq2seq", f"launches on the path {launches} (K1-K8 none); the "
         f"dropout kernel at [{SEQ2SEQ_BATCH}, {cfg.seq}, {cfg.hidden}] p "
         f"{SEQ2SEQ_DROPOUT} equal to its plain version bit for bit")
    _log("seq2seq", f"phase wall time {wall:.1f} s (budget "
         f"{SEQ2SEQ_BUDGET_S:.0f} s)")
    return {"launches": launches, "train": a, "decode": b, "while_grad": c,
            "rnn_dropout": d, "wall_s": wall}


# optimizers: name -> a maker of the optimizer
def _optimizer_cases():
    from paddle_tpu_torch import optimizer as O
    return {
        "LarsMomentum": lambda: O.LarsMomentumOptimizer(0.1, 0.9),
        "AdamW": lambda: O.AdamWOptimizer(1e-3, weight_decay=0.01),
        "Adamax": lambda: O.AdamaxOptimizer(1e-3),
        "Adagrad": lambda: O.AdagradOptimizer(
            1e-2, initial_accumulator_value=0.1),
        "DecayedAdagrad": lambda: O.DecayedAdagradOptimizer(1e-3),
        "Adadelta": lambda: O.AdadeltaOptimizer(1.0),
        "RMSProp": lambda: O.RMSPropOptimizer(1e-3, momentum=0.5,
                                              centered=True),
        "Ftrl": lambda: O.FtrlOptimizer(1e-3, l1=1e-4, l2=1e-4),
        "Lamb": lambda: O.LambOptimizer(
            1e-3, exclude_from_weight_decay_fn=_lamb_excluded),
        "DGCMomentum": lambda: O.DGCMomentumOptimizer(0.1, 0.9),
        "Lookahead": lambda: O.LookaheadOptimizer(O.AdamOptimizer(1e-3),
                                                  alpha=0.5, k=2),
        "ModelAverage": lambda: O.AdamOptimizer(1e-3),
        "ExponentialMovingAverage": lambda: O.AdamOptimizer(1e-3),
    }


class _NoHostSync:
    """Run the lowerings of ``op_types`` under
    ``torch.cuda.set_sync_debug_mode("error")``: an update that reads a
    value back to the host raises.  Counts the guarded calls that ran an
    update (shape inference calls a lowering on meta tensors too)."""

    def __init__(self, op_types):
        from paddle_tpu_torch.framework import registry
        self.infos = [registry.get_op_info(t) for t in op_types]
        self.calls = 0

    def __enter__(self):
        import torch
        self.saved = [info.lower for info in self.infos]

        def guarded(lower):
            def run(ctx, ins, attrs):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return lower(ctx, ins, attrs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    self.calls += ctx.device.type != "meta"
            return run
        for info in self.infos:
            info.lower = guarded(info.lower)
        return self

    def __exit__(self, *exc):
        for info, lower in zip(self.infos, self.saved):
            info.lower = lower


def _rel_diff(card, host):
    """The norm of card - host over the host's, in float64 on ``card``'s
    device: on the card the float64 work of a large gradient costs
    milliseconds (on the host it was most of ``optimizers``' checks)."""
    c = card.detach().double()
    h = host.detach().to(c.device).double()
    return float((c - h).norm() / max(float(h.norm()), 1e-30))


def _update_program(main):
    """The ops of ``main`` after its backward (the optimizer's, with the
    wrappers' that follow them) as a program of their own, and the names
    they read that no op of theirs writes and no scope holds: the
    gradients, which a run of it is fed."""
    upd = main.clone()
    blk = upd.global_block()
    split = 1 + max(i for i, op in enumerate(blk.ops)
                    if op.attrs.get("op_role") == "backward")
    blk.ops = blk.ops[split:]
    upd._bump_version()
    made, fed = set(), []
    for op in blk.ops:
        for n in op.input_arg_names():
            if n and n not in made and n not in fed and not (
                    blk.has_var(n) and blk.var(n).persistable):
                fed.append(n)
        made.update(op.output_arg_names())
    return upd, fed


def _check_update(name, card, want):
    """Every tensor of ``card`` against ``want`` (name -> tensor), the
    host's update from the same state and inputs: integers equal,
    floating ones each element within OPT_STATE_RTOL of the largest
    element of its tensor, in float64 on ``card``'s device (as
    ``_rel_diff``).  Returns the worst (that difference, name)."""
    import torch
    worst = (0.0, None)
    for n, c in card.items():
        c = c.detach()
        h = want[n].detach().to(c.device)
        if not c.is_floating_point():
            if not torch.equal(c, h):
                raise AssertionError(f"optimizers {name}: {n} {c} vs {h}")
            continue
        c, h = c.double(), h.double()
        err = float((c - h).abs().max()) / max(float(h.abs().max()), 1e-30)
        if not err <= OPT_STATE_RTOL:
            raise AssertionError(f"optimizers {name}: {n} differs by {err} "
                                 f"of its largest element (bound "
                                 f"{OPT_STATE_RTOL})")
        worst = max(worst, (err, n), key=lambda t: t[0])
    return worst


def _check_initializers():
    """The startup program with each new initializer on the card: the
    truncated normal within its bound, mean and std within OPT_INIT_SE
    standard errors, MSRA's uniform and normal scales, Bilinear's and
    NumpyArray's values equal to the host's."""
    import math

    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import initializer as I
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    shape, fan_in = [1024, 1024], 1024
    inits = {"trunc": I.TruncatedNormal(loc=0.0, scale=0.02),
             "msra_u": I.MSRA(), "msra_n": I.MSRA(uniform=False),
             "bilinear": I.Bilinear(),
             "numpy": I.NumpyArrayInitializer(
                 np.random.RandomState(3).randn(64, 48).astype(np.float32))}
    shapes = {"bilinear": [16, 8, 4, 4], "numpy": [64, 48]}
    main, startup = Program(), Program()
    with program_guard(main, startup):
        for n, init in inits.items():
            layers.create_parameter(shapes.get(n, shape), "float32", name=n,
                                    default_initializer=init)
    card, host = Scope(), Scope()
    ptt.Executor().run(startup, scope=card, seed=17)
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=host, seed=17)
    trunc_std = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                          / math.erf(math.sqrt(2)))
    report = {}
    for n, mean, std, bound in (
            ("trunc", 0.0, 0.02 * trunc_std, 0.04),
            ("msra_u", 0.0, math.sqrt(6.0 / fan_in) / math.sqrt(3.0),
             math.sqrt(6.0 / fan_in)),
            ("msra_n", 0.0, math.sqrt(2.0 / fan_in), None)):
        w = card.find_var(n)
        assert w.is_cuda and tuple(w.shape) == tuple(shape), (n, w.shape)
        w = w.double().cpu().reshape(-1)
        k = w.numel()
        m, s = float(w.mean()), float(w.std())
        ok = abs(m - mean) <= OPT_INIT_SE * std / math.sqrt(k) and \
            abs(s - std) <= OPT_INIT_SE * std / math.sqrt(2 * k) and \
            (bound is None or float((w - mean).abs().max()) <= bound * (
                1 + 1e-6))
        if not ok:
            raise AssertionError(f"optimizers: {n} on the card: mean {m}, "
                                 f"std {s}, want {mean}, {std}, bound "
                                 f"{bound}")
        report[n] = {"mean": m, "std": s, "want_std": std}
    for n in ("bilinear", "numpy"):
        if not torch.equal(card.find_var(n).cpu(), host.find_var(n)):
            raise AssertionError(f"optimizers: {n} differs on the card")
    return report


def phase_optimizers():
    """The 10 optimizer classes this slice added, and Lookahead,
    ModelAverage and ExponentialMovingAverage over Adam: a BERT of
    BERT-base's width at OPT_LAYERS layers (dropout 0.1, float32 with the
    dense LM head, TF32
    off) takes OPT_STEPS steps on the card and on the host at the same
    seeds, each from the host's state: the losses within OPT_LOSS_RTOL, and what the update
    ops read (the gradients) within OPT_STATE_RTOL as ``_rel_diff`` says.
    The host then runs the update ops (``_update_program``) from that same
    state on the card's gradients, and every parameter and accumulator the
    card wrote must match it as ``_check_update`` says, the averages
    ``apply()`` puts in the scope after the last step likewise.  LAMB's and
    LARS's updates run under sync-debug "error"; then, on the card, the
    new initializers (``_check_initializers``)."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                            scope_guard, unique_name)
    from paddle_tpu_torch.models import transformer as T

    cfg = T.BertConfig(n_layer=OPT_LAYERS)
    feeds = [_bert_feed(cfg, OPT_BATCH, BERT_SEQ, seed=s)
             for s in range(OPT_STEPS)]
    out = {}
    for name, make in _optimizer_cases().items():
        main, startup = Program(), Program()
        with program_guard(main, startup), unique_name.guard():
            # the dense head: the fused one rounds its products to bf16,
            # and a sum the card and the host take in other orders can
            # round to neighbouring bf16 values
            _, _, loss = T.build_bert_pretrain(cfg, BERT_SEQ,
                                               arange_pos=True)
            opt = make()
            opt.minimize(loss)
            avg = None
            if name == "ModelAverage":
                avg = O.ModelAverage(0.15, min_average_window=1,
                                     max_average_window=2)
            elif name == "ExponentialMovingAverage":
                avg = O.ExponentialMovingAverage(0.9)
                avg.update()
        upd, fed = _update_program(main)
        host_scope, card_scope, want_scope = Scope(), Scope(), Scope()
        host = ptt.Executor(ptt.CPUPlace())
        host.run(startup, scope=host_scope, seed=21)
        names = [v.name for v in startup.global_block().vars.values()]
        card = ptt.Executor()
        guard = _NoHostSync(("lamb", "lars_momentum"))
        got, want, card_s, host_s = [], [], 0.0, 0.0
        worst, worst_in = (0.0, None), (0.0, None)
        for s, f in enumerate(feeds):
            # each step starts from the host's state: a step's difference
            # is its own, not the sum of the steps before it
            for n in names:
                v = host_scope.find_var(n)
                card_scope.set_var(n, v.to(card.device))
                want_scope.set_var(n, v.clone())
            t0 = time.perf_counter()
            with guard:
                c_out = card.run(main, feed=f, fetch_list=[loss] + fed,
                                 scope=card_scope, seed=60 + s)
            t1 = time.perf_counter()
            h_out = host.run(main, feed=f, fetch_list=[loss] + fed,
                             scope=host_scope, seed=60 + s)
            card_s, host_s = card_s + t1 - t0, \
                host_s + time.perf_counter() - t1
            got.append(float(c_out[0]))
            want.append(float(h_out[0]))
            for n, c, h in zip(fed, c_out[1:], h_out[1:]):
                err = _rel_diff(torch.from_numpy(c).to(card.device),
                                torch.from_numpy(h))
                if not err <= OPT_STATE_RTOL:
                    raise AssertionError(f"optimizers {name}: {n} "
                                         f"difference {err} (bound "
                                         f"{OPT_STATE_RTOL})")
                worst_in = max(worst_in, (err, n), key=lambda t: t[0])
            # the host's update from the same state on the card's inputs
            host.run(upd, feed=dict(zip(fed, c_out[1:])), scope=want_scope)
            worst = max(worst, _check_update(
                name, {n: card_scope.find_var(n) for n in names},
                {n: want_scope.find_var(n) for n in names}),
                key=lambda t: t[0])
        loss_err = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        if not loss_err <= OPT_LOSS_RTOL:
            raise AssertionError(f"optimizers {name}: losses {got} on the "
                                 f"card, {want} on the host")
        if avg is not None:
            params = [p.name for p in main.all_parameters()]
            averaged = []
            for sc in (card_scope, want_scope):
                trained = {n: sc.find_var(n) for n in params}
                with scope_guard(sc), avg.apply():
                    averaged.append({n: sc.find_var(n) for n in params})
                if any(sc.find_var(n) is not trained[n] for n in params):
                    raise AssertionError(f"optimizers {name}: apply() did "
                                         f"not restore the parameters")
            worst = max(worst, _check_update(name + " apply()", *averaged),
                        key=lambda t: t[0])
        n_ops = {t: [op.type for op in main.global_block().ops].count(t)
                 for t in ("lamb", "lars_momentum")}
        if guard.calls != OPT_STEPS * sum(n_ops.values()) or (
                name in ("Lamb", "LarsMomentum") and not guard.calls):
            raise AssertionError(f"optimizers {name}: {guard.calls} guarded "
                                 f"updates for {n_ops} ops")
        out[name] = {"losses": got, "host_losses": want,
                     "loss_rel_err": loss_err, "worst_input": worst_in,
                     "worst_update": worst, "card_s": card_s,
                     "host_s": host_s, "no_sync_updates": guard.calls}
        _log("optimizers", f"{name}: {OPT_STEPS} steps card vs host "
             f"({card_s:.2f} / {host_s:.2f} s): losses "
             f"{', '.join(f'{x:.6f}' for x in got)}, max rel {loss_err:.2g}"
             f" (rtol {OPT_LOSS_RTOL}); worst of {len(fed)} update inputs "
             f"{worst_in[1]} {worst_in[0]:.2g} (norm, rtol {OPT_STATE_RTOL})"
             f"; update on the card's inputs: worst {worst[1]} "
             f"{worst[0]:.2g} of its largest element (bound "
             f"{OPT_STATE_RTOL}, every element held)"
             + (f"; {guard.calls} updates under sync-debug \"error\""
                if guard.calls else "") + " ok")
        torch.cuda.empty_cache()
    out["initializers"] = _check_initializers()
    _log("optimizers", "initializers on the card: " + "; ".join(
        f"{n} mean {r['mean']:.3g} std {r['std']:.5g} (want "
        f"{r['want_std']:.5g})" for n, r in out["initializers"].items())
        + "; Bilinear and NumpyArray equal to the host ok")
    return out


# ---------------------------------------------------------------------------
# the time and memory planes on the main paths
# ---------------------------------------------------------------------------

#: the flash kernels' entry points as Kineto names them, and how many of
#: each a K1 (fwd) or K2 (bwd) launch runs: K2 is three kernels (delta,
#: dK/dV, dQ); the float32 split passes are elementwise (a cast)
_FLASH_EVENTS = {"flash_fwd_sm90_kernel": "flash_attn_fwd",
                 "flash_bwd_sm90_delta_kernel": "flash_attn_bwd",
                 "flash_bwd_sm90_dkdv_kernel": "flash_attn_bwd",
                 "flash_bwd_sm90_dq_kernel": "flash_attn_bwd"}


def _plane_counts():
    """The sampling profiler's windows and summaries and the accountant's
    samples, by outcome: every count but ``ok`` must stay 0."""
    from paddle_tpu_torch import monitor
    out = {}
    for fam, outcomes in (("paddle_tpu_profile_windows_total",
                           ("ok", "error", "empty")),
                          ("paddle_tpu_profile_summaries_total",
                           ("ok", "error", "empty")),
                          ("paddle_tpu_hbm_samples_total",
                           ("ok", "error"))):
        m = monitor.REGISTRY.get(fam)
        for o in outcomes:
            out[f"{fam}{{{o}}}"] = 0 if m is None else m.value(outcome=o)
    return out


def _plane_errors(before):
    """Counts other than ``ok`` that moved since ``before``."""
    after = _plane_counts()
    return {k: after[k] - before.get(k, 0) for k in after
            if not k.endswith("{ok}") and after[k] != before.get(k, 0)}


def _sampled_window(phase, run_step, steps):
    """Run one step that opens a ``torch.profiler`` window
    (``FLAGS_profile_sample_every_n_steps`` set to its step id), then
    ``steps`` steps inside it (the window closes at the end of the last);
    the launch counts are read and reset after the first step.  Returns the
    window's manifest entry, its summary, the per-step device events and
    the launches of the first step and of the window's."""
    import tempfile
    from paddle_tpu_torch import flags, profiler
    from paddle_tpu_torch.analysis import device_profile as dp
    from paddle_tpu_torch.framework import executor as ex
    base = tempfile.mkdtemp(prefix=f"{phase}_windows_")
    saved = flags.get_flags(["FLAGS_profile_sample_every_n_steps",
                             "FLAGS_profile_sample_window_steps",
                             "FLAGS_profile_sample_dir"])
    opened_at = ex.last_step_id() + 1
    flags.set_flags({"FLAGS_profile_sample_every_n_steps": opened_at,
                     "FLAGS_profile_sample_window_steps": steps,
                     "FLAGS_profile_sample_dir": base})
    try:
        run_step()
        if ex.last_step_id() != opened_at:
            raise AssertionError(f"{phase}: the window's first step took id "
                                 f"{ex.last_step_id()}, not {opened_at}")
        first = {name: _kernel_module(name).launch_count(name)
                 for name in _KERNEL_MODULES}
        _reset_launches()
        for _ in range(steps):
            run_step()
        launches = {name: _kernel_module(name).launch_count(name)
                    for name in _KERNEL_MODULES}
        profiler.SAMPLER.close()
    finally:
        flags.set_flags(saved)
    with open(os.path.join(base, "manifest.json")) as f:
        w, = json.load(f)["windows"]
    if (w["start_step"], w["end_step"]) != (opened_at + 1,
                                            opened_at + 1 + steps):
        raise AssertionError(f"{phase}: window {w}, expected steps "
                             f"[{opened_at + 1}, {opened_at + 1 + steps})")
    with open(os.path.join(w["dir"], "summary.json")) as f:
        summary = json.load(f)
    trace = dp.parse_trace(os.path.join(w["dir"], profiler.TRACE_FILE))
    by_step = dp.kernels_by_step(trace)
    events = {s: by_step.get(s, []) for s in range(w["start_step"],
                                                   w["end_step"])}
    return {"window": w, "summary": summary, "events": events,
            "all_events": [e for evs in by_step.values() for e in evs],
            "launches": launches, "first_launches": first, "dir": base}


def _check_summary(phase, got, steps):
    """The fatal checks every sampled window's summary meets.  The
    per-class shares, recomputed unrounded from the trace's device events,
    sum to 1 within 1e-6, and each published share (rounded to 6
    decimals) is its recomputed one within 1e-6."""
    from paddle_tpu_torch.analysis import device_profile as dp
    summary = got["summary"]
    if summary["n_steps"] != steps:
        raise AssertionError(f"{phase}: summary holds {summary['n_steps']} "
                             f"steps, expected {steps}")
    cls_ms = {}
    for e in got["all_events"]:
        c = dp.classify_kernel(e["name"])
        cls_ms[c] = cls_ms.get(c, 0.0) + e["dur"]
    total = sum(cls_ms.values())
    shares = {c: v / total for c, v in cls_ms.items()}
    published = summary["per_class_share"]
    if abs(sum(shares.values()) - 1.0) > 1e-6 or set(shares) != set(
            published) or any(abs(shares[c] - published[c]) > 1e-6
                              for c in shares):
        raise AssertionError(f"{phase}: per-class shares {shares} (sum "
                             f"{sum(shares.values())}), published "
                             f"{published}")
    idle = summary["idle_frac"]
    if idle is None or not 0 <= idle < 1:
        raise AssertionError(f"{phase}: idle fraction {idle}")
    mfu = summary["measured"]["mfu_measured"]
    if mfu is None or not 0 < mfu <= 1:
        raise AssertionError(f"{phase}: measured MFU {mfu}")
    for r in summary["steps"]:
        if not 0 < r["device_ms"] <= r["span_ms"]:
            raise AssertionError(f"{phase}: step {r['step']} device "
                                 f"{r['device_ms']} ms, span "
                                 f"{r['span_ms']} ms")


def _check_attention_events(phase, got):
    """The window's steps hold as many events of each flash entry point as
    their wrappers counted launches, and nothing else classed attention
    (K1 + 3 x K2 events).  Returns the attention events' names and the
    count by entry point."""
    from paddle_tpu_torch.analysis import device_profile as dp
    events = [e for evs in got["events"].values() for e in evs]
    attn = [e["name"] for e in events
            if dp.classify_kernel(e["name"]) == "attention"]
    per_name = {n: sum(n in a for a in attn) for n in _FLASH_EVENTS}
    want = {n: got["launches"][k] for n, k in _FLASH_EVENTS.items()}
    k1, k2 = (got["launches"][k] for k in ("flash_attn_fwd",
                                            "flash_attn_bwd"))
    if per_name != want or len(attn) != k1 + 3 * k2:
        raise AssertionError(f"{phase}: attention-class kernel events "
                             f"{len(attn)} by entry point {per_name}, "
                             f"expected {want} (K1 {k1} + 3 x K2 {k2}); "
                             f"names {sorted(set(attn))[:6]}")
    return attn, per_name


def _top_kernels(summary, n=8):
    return [(k["name"][:60], k["op_class"], round(k["ms"] / max(
        summary["n_steps"], 1), 3), k["count"]) for k in
        summary["kernels"][:n]]


def _hbm_gauges():
    from paddle_tpu_torch import hbm
    return {"live": hbm.HBM_LIVE_GAUGE.value(),
            "peak": hbm.HBM_PEAK_GAUGE.value(),
            "budget": hbm.HBM_BUDGET_GAUGE.value(),
            "headroom": hbm.HBM_HEADROOM_GAUGE.value(),
            "drift": hbm.HBM_DRIFT_GAUGE.value(),
            **{c: cell.get() for c, cell in hbm._CLASS_CELLS.items()}}


class _NoRange:
    """A stand-in for the executor's ``_StepRange`` that does nothing."""

    def __init__(self, *a):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _planes_overhead(phase, smi, step):
    """Host clocks of ``step()`` (synchronized) in three legs, alternating
    over OBSERVE_OVERHEAD_ROUNDS rounds of OBSERVE_OVERHEAD_STEPS: the
    planes as they run by default (no window, the HBM accountant on),
    idle (the accountant off), and idle with the executor's step range
    taken out by a local monkeypatch."""
    import torch
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.framework import executor as ex
    real = ex._StepRange
    legs = {"default": [], "idle": [], "no_range": []}
    try:
        for _ in range(OBSERVE_OVERHEAD_ROUNDS):
            for leg, times in legs.items():
                flags.set_flags({"FLAGS_hbm_telemetry": leg == "default"})
                ex._StepRange = _NoRange if leg == "no_range" else real
                for _ in range(OBSERVE_OVERHEAD_STEPS):
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
    finally:
        ex._StepRange = real
        flags.set_flags({"FLAGS_hbm_telemetry": True})
    med = {k: float(np.median(v)) for k, v in legs.items()}
    iqr = {k: (float(np.percentile(v, 25)), float(np.percentile(v, 75)))
           for k, v in legs.items()}
    _log(phase, f"overhead (host clocks, {len(legs['idle'])} steps a leg, "
         f"alternating): step median {med['default']:.2f} ms as by default "
         f"(accountant on), {med['idle']:.2f} ms with the planes idle, "
         f"{med['no_range']:.2f} ms without the step range too; quartiles "
         f"{ {k: tuple(round(x, 2) for x in v) for k, v in iqr.items()} } "
         f"on {smi}")
    return {"steps_ms": legs, "median": med, "quartiles": iqr}


def phase_observe_train(smi, train):
    """``train``'s GPT (its executor, scope and batch) with one sampled
    window of OBSERVE_WINDOW_STEPS steps and the HBM accountant on; then the
    step with the planes idle against the step without the step range."""
    import shutil
    import torch
    from paddle_tpu_torch import flags, hbm, monitor, profiler
    from paddle_tpu_torch.analysis import memory as amem
    from paddle_tpu_torch.framework import executor as ex
    exe, main, scope = train["exe"], train["main"], train["scope"]
    feed, loss = train["feed"], train["loss"]
    cfg = _gpt_cfg()
    flags.set_flags({"FLAGS_hbm_telemetry": True})
    counts = _plane_counts()
    ledger0 = exe.dispatch_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()

    def step():
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)

    got = _sampled_window("observe_train", step, OBSERVE_WINDOW_STEPS)
    peak = torch.cuda.max_memory_allocated()
    assert hbm.ACCOUNTANT.drain(60), "the HBM accountant did not drain"
    errors = _plane_errors(counts)
    if errors:
        raise AssertionError(f"observe_train: telemetry errors {errors} "
                             f"(last window error "
                             f"{profiler.last_window_error()})")
    s = got["summary"]
    _check_summary("observe_train", got, OBSERVE_WINDOW_STEPS)
    k1, k2 = (got["launches"][k] for k in ("flash_attn_fwd",
                                            "flash_attn_bwd"))
    if (k1, k2) != (cfg.n_layer * OBSERVE_WINDOW_STEPS,) * 2:
        raise AssertionError(f"observe_train: K1/K2 launched {k1}/{k2} in "
                             f"the window")
    attn, per_name = _check_attention_events("observe_train", got)
    mfu_live = monitor.REGISTRY.get("paddle_tpu_step_mfu").value(
        executor=str(exe._stats.serial))
    if not 0 < mfu_live <= 1:
        raise AssertionError(f"observe_train: live MFU {mfu_live}")
    ledger = exe.dispatch_stats()
    d = {k: ledger[k] - ledger0[k] for k in ("steps_dispatched",
                                              "time_to_dispatch_us",
                                              "host_block_us",
                                              "materialize_block_us",
                                              "throttle_block_us")}
    if not (d["time_to_dispatch_us"] > 0 and d["host_block_us"] > 0):
        raise AssertionError(f"observe_train: ledger {d}")
    g = _hbm_gauges()
    if not (g["live"] > 0 and g["peak"] >= g["live"] and g["headroom"] > 0
            and g["budget"] == g["live"] + g["headroom"]):
        raise AssertionError(f"observe_train: HBM gauges {g}")
    mplan = amem.plan_memory(main, [loss.name], batch_size=TRAIN_BATCH)
    per_class = {c: round(v, 4) for c, v in s["per_class_share"].items()}
    n_steps = d["steps_dispatched"]
    n_events = sum(len(v) for v in got["events"].values())
    _log("observe_train", f"window steps [{got['window']['start_step']}, "
         f"{got['window']['end_step']}): {n_events} device events, "
         f"attention-class {len(attn)} = K1 {k1} + 3 x K2 {k2} "
         f"{per_name}; idle fraction {s['idle_frac']:.4f}; measured MFU "
         f"{s['measured']['mfu_measured']:.4f}, live MFU {mfu_live:.4f} "
         f"(peak {s['measured']['peak_flops']:.3g} FLOP/s, analytic "
         f"{s['measured']['flops_per_step']:.4g} flops a step); steps "
         f"{[(r['step'], r['device_ms'], r['span_ms']) for r in s['steps']]}"
         f" (device ms, span ms) on {smi}")
    _log("observe_train", f"per-class device shares {per_class}; top "
         f"kernels (name, class, ms a step, count) {_top_kernels(s)}")
    _log("observe_train", f"memory: plan peak {mplan.peak_bytes / 2**30:.3f}"
         f" GiB at op #{mplan.peak_pos} ({mplan.peak_op}), steady "
         f"{mplan.steady_bytes / 2**30:.3f} GiB; measured peak "
         f"{peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} above the "
         f"{held / 2**30:.3f} GiB held before); accountant live "
         f"{g['live'] / 2**30:.3f} GiB, headroom {g['headroom'] / 2**30:.2f}"
         f" GiB, drift {g['drift']:.4f}, params {g['params'] / 2**30:.3f}, "
         f"opt_state {g['opt_state'] / 2**30:.3f}, activations "
         f"{g['activations'] / 2**30:.3f} GiB")
    _log("observe_train", f"ledger over {n_steps} steps: time to dispatch "
         f"{d['time_to_dispatch_us'] / n_steps / 1e3:.2f} ms a step, host "
         f"blocked {d['host_block_us'] / n_steps / 1e3:.2f} ms a step "
         f"(materialize {d['materialize_block_us'] / n_steps / 1e3:.2f}, "
         f"throttle {d['throttle_block_us'] / n_steps / 1e3:.2f})")
    shutil.rmtree(got["dir"], ignore_errors=True)

    over = _planes_overhead("observe_train", smi, step)
    # after the steady steps the live gauge's 9 intervals are all steps
    mfu_end = monitor.REGISTRY.get("paddle_tpu_step_mfu").value(
        executor=str(exe._stats.serial))
    step_ms = monitor.REGISTRY.get("paddle_tpu_step_device_ms").value(
        executor=str(exe._stats.serial))
    _log("observe_train", f"then the live gauges: step {step_ms:.2f} ms, "
         f"MFU {mfu_end:.4f}")
    return {"window": got["window"], "summary": {
                k: s[k] for k in ("steps", "n_steps", "per_class_share",
                                  "per_class_ms", "idle_frac", "measured",
                                  "device_ms_total", "unattributed_ms")},
            "kernels": s["kernels"], "mfu_live": mfu_live,
            "attention_events": len(attn), "per_name": per_name,
            "launches": {k: v for k, v in got["launches"].items() if v},
            "plan_peak_bytes": mplan.peak_bytes,
            "plan_steady_bytes": mplan.steady_bytes,
            "measured_peak_bytes": peak, "held_bytes": held,
            "hbm": g, "ledger": d, "overhead": over,
            "live_after_overhead": {"step_ms": step_ms, "mfu": mfu_end}}


def _dump_sums(path):
    """The budget arithmetic lines of an OOM dump, checked to re-add."""
    nums = {}
    with open(path) as f:
        for line in f:
            k, _, v = line.strip().partition(": ")
            if k.endswith("_bytes") or k == "measured_plus_requested":
                nums[k] = int(v)
    if nums["measured_plus_requested"] != nums["measured_bytes"] + \
            nums["requested_bytes"] or nums["deficit_bytes"] != \
            nums["measured_plus_requested"] - nums["budget_bytes"]:
        raise AssertionError(f"OOM dump {path}: sums do not re-add {nums}")
    return nums


def phase_observe_resnet(smi):
    """ResNet-50 float32 at OBSERVE_RESNET_BATCH through the fusion pass
    (K3), 1 warm-up + OBSERVE_RESNET_STEPS steps, the middle ones in a
    sampled window; the plan's peak beside the measured one; then the
    ``memory.oom`` drill through ``Executor.run`` and a real
    ``torch.cuda.OutOfMemoryError`` through ``oom_forensics``."""
    import re as _re
    import shutil
    import tempfile
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags, hbm, resilience
    from paddle_tpu_torch.analysis import memory as amem
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import conv_bn as cb
    cfg = dict(class_dim=1000, depth=50, image_shape=(3, 224, 224))
    main, startup, loss, accs = _resnet_program(**cfg)
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=1234)
    feed = _resnet_feed(OBSERVE_RESNET_BATCH, cfg["class_dim"],
                        cfg["image_shape"])
    t_p = time.perf_counter()
    mplan = amem.plan_memory(main, [loss.name],
                             batch_size=OBSERVE_RESNET_BATCH)
    plan_s = time.perf_counter() - t_p
    counts = _plane_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    losses = []

    def step():
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))

    cb.reset_launch_count()
    t_w = time.perf_counter()
    step()                                   # the warm-up: plans, fuses
    warm_s = time.perf_counter() - t_w
    warm_k3 = cb.launch_count()
    # the window opens at the end of the first step after the warm-up and
    # holds the next OBSERVE_RESNET_STEPS - 1
    got = _sampled_window("observe_resnet", step, OBSERVE_RESNET_STEPS - 1)
    first_k3 = got["first_launches"]["conv1x1_stats"] - warm_k3
    window_k3 = got["launches"]["conv1x1_stats"]
    k3 = warm_k3 + first_k3 + window_k3
    peak = torch.cuda.max_memory_allocated()
    assert hbm.ACCOUNTANT.drain(60), "the HBM accountant did not drain"
    errors = _plane_errors(counts)
    if errors:
        raise AssertionError(f"observe_resnet: telemetry errors {errors}")
    _check_summary("observe_resnet", got, OBSERVE_RESNET_STEPS - 1)
    if (warm_k3, first_k3, window_k3) != (
            36, 36, 36 * (OBSERVE_RESNET_STEPS - 1)):
        raise AssertionError(
            f"observe_resnet: K3 launched {warm_k3} in the warm-up, "
            f"{first_k3} in the first step and {window_k3} in the window's "
            f"{OBSERVE_RESNET_STEPS - 1}, expected 36 a step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"observe_resnet: losses not finite and "
                             f"falling: {losses}")
    fplan = [p for p in exe._plans.values()
             if any(op.type == "momentum" for op, _ in p.ops)][0]
    fused_peak = amem.plan_memory(fplan.program, [loss.name],
                                  batch_size=OBSERVE_RESNET_BATCH).peak_bytes
    s = got["summary"]
    _log("observe_resnet", f"batch {OBSERVE_RESNET_BATCH} x 3x224x224 "
         f"float32: warm-up {warm_s:.2f} s, losses "
         f"{', '.join(f'{x:.4f}' for x in losses)}; K3 {warm_k3} + "
         f"{first_k3} + {window_k3} = {k3}; "
         f"window steps {[(r['step'], r['device_ms'], r['span_ms']) for r in s['steps']]}"
         f" (device ms, span ms); idle fraction {s['idle_frac']:.4f}, "
         f"measured MFU {s['measured']['mfu_measured']:.4f} on {smi}")
    _log("observe_resnet", f"per-class device shares "
         f"{ {c: round(v, 4) for c, v in s['per_class_share'].items()} }; "
         f"top kernels {_top_kernels(s)}")
    _log("observe_resnet", f"memory: plan peak (unfused program) "
         f"{mplan.peak_bytes / 2**30:.3f} GiB at op #{mplan.peak_pos} "
         f"({mplan.peak_op}), the fused program's "
         f"{fused_peak / 2**30:.3f} GiB (planned in {plan_s:.2f} s); "
         f"measured peak {peak / 2**30:.3f} GiB, "
         f"{(peak - held) / 2**30:.3f} above the {held / 2**30:.3f} GiB "
         f"held before the warm-up")

    over = _planes_overhead("observe_resnet", smi, lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope))

    # the memory.oom drill through Executor.run
    dump_dir = tempfile.mkdtemp(prefix="oom_dumps_")
    flags.set_flags({"FLAGS_oom_dump_dir": dump_dir})
    try:
        n_inj = hbm.OOM_CTR.value(site="injected")
        flags.set_flags({"FLAGS_fault_inject": "memory.oom:once"})
        try:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            raise AssertionError("observe_resnet: the memory.oom drill did "
                                 "not raise")
        except resilience.InjectedFault as e:
            msg = str(e)
        finally:
            flags.set_flags({"FLAGS_fault_inject": ""})
        m = _re.search(r"oom forensics dump: (\S+)", msg)
        if m is None or "device memory summary" not in msg:
            raise AssertionError(f"observe_resnet: drill error lacks the "
                                 f"report: {msg[:400]}")
        drill = _dump_sums(m.group(1))
        if hbm.OOM_CTR.value(site="injected") != n_inj + 1 or n_inj != 0:
            raise AssertionError("observe_resnet: oom_total{injected} "
                                 f"{hbm.OOM_CTR.value(site='injected')}")
        if drill["plan_peak_bytes"] != fused_peak:
            raise AssertionError(f"observe_resnet: the dump's plan peak "
                                 f"{drill['plan_peak_bytes']} is not the "
                                 f"fused program's {fused_peak}")
        # a real OutOfMemoryError: a request larger than the card
        total = torch.cuda.get_device_properties(0).total_memory
        n_real = hbm.OOM_CTR.value(site="dispatch")
        try:
            torch.empty(2 * total, dtype=torch.uint8, device="cuda")
            raise AssertionError("observe_resnet: a 2x-card allocation "
                                 "succeeded")
        except torch.cuda.OutOfMemoryError as e:
            err = e
        path = hbm.oom_forensics(err, scope=scope, program=main,
                                 fetch_names=[loss.name],
                                 batch=OBSERVE_RESNET_BATCH)
        real = _dump_sums(path)
        if abs(real["requested_bytes"] - 2 * total) > total // 100 or \
                hbm.OOM_CTR.value(site="dispatch") != n_real + 1:
            raise AssertionError(f"observe_resnet: requested "
                                 f"{real['requested_bytes']} of "
                                 f"{2 * total} ({str(err)[:160]})")
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    finally:
        flags.set_flags({"FLAGS_oom_dump_dir": ""})
        shutil.rmtree(dump_dir, ignore_errors=True)
        shutil.rmtree(got["dir"], ignore_errors=True)
    _log("observe_resnet", f"memory.oom drill: InjectedFault with the "
         f"summary and dump, oom_total{{injected}} 1, dump sums re-add "
         f"(measured {drill['measured_bytes'] / 2**30:.3f} GiB, plan peak "
         f"{drill['plan_peak_bytes'] / 2**30:.3f} GiB, budget "
         f"{drill['budget_bytes'] / 2**30:.2f} GiB); real OOM "
         f"{str(err).splitlines()[0][:100]!r}: requested "
         f"{real['requested_bytes']} bytes read, deficit "
         f"{real['deficit_bytes'] / 2**30:.2f} GiB; the next step ran")
    return {"losses": losses, "launches": k3,
            "window": got["window"], "summary": {
                k: s[k] for k in ("steps", "n_steps", "per_class_share",
                                  "per_class_ms", "idle_frac", "measured",
                                  "device_ms_total", "unattributed_ms")},
            "kernels": s["kernels"],
            "plan_peak_bytes": mplan.peak_bytes,
            "fused_plan_peak_bytes": fused_peak, "plan_s": plan_s,
            "measured_peak_bytes": peak, "held_bytes": held,
            "overhead": over, "oom_drill": drill, "oom_real": real}


def _active_blocks():
    """{address: bytes} of the allocator's live blocks
    (``torch.cuda.memory_snapshot``)."""
    import torch
    return {b["address"]: b["size"]
            for seg in torch.cuda.memory_snapshot()
            for b in seg["blocks"] if b["state"] == "active_allocated"}


def phase_observe_serve(smi, serve):
    """``serve``'s GPT at bucket 2048 under a FLAGS_memory_budget_mb between
    the bucket program's plan peaks at widths 4 and 8: the bucket admits 4.
    F2: a lone batch of 4 requests peaks above what is held within the
    budget (x F2_SLACK), and the bytes its fetch holds after the step are
    its logits; then 6 requests peak within the budget times the batches
    alive at once (the batcher's run-ahead).  Then a DecodeEngine's pools in
    the accountant's kv_pages class."""
    import gc
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags, hbm
    from paddle_tpu_torch.analysis import memory as amem
    from paddle_tpu_torch.kernels import flash_attention as fa
    cfg, factory, scope = _gpt_cfg(), serve["factory"], serve["scope"]
    prog, _, fetch = factory(2048)
    p4, p8 = (amem.plan_memory(prog, fetch, batch_size=w).peak_bytes
              for w in (4, 8))
    budget_mb = (p4 + p8) // 2 >> 20
    if not p4 <= budget_mb << 20 < p8:
        raise AssertionError(f"observe_serve: no budget between {p4} and "
                             f"{p8}")
    flags.set_flags({"FLAGS_memory_budget_mb": budget_mb})
    try:
        srv = ptt.serving.InferenceServer(factory, scope, buckets=(2048,),
                                          max_batch=8, batch_wait_ms=20.0)
        rng = np.random.RandomState(11)
        reqs = [rng.randint(1, cfg.vocab_size, (int(n),)).astype(np.int64)
                for n in rng.randint(1100, 2049, OBSERVE_SERVE_REQUESTS)]
        fa.reset_launch_count()
        srv.warmup()
        # F2, the lone batch: 4 requests submitted together, resolved and
        # their batch released before the next measurement
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lone_held = torch.cuda.memory_allocated()
        srv.start()
        lone = [srv.submit("lone", {"src_ids": ids}) for ids in reqs[:4]]
        lone_outs = [f.result(timeout=600) for f in lone]
        deadline = time.monotonic() + 60
        while srv.alive_stats()["alive"] and time.monotonic() < deadline:
            time.sleep(0.01)
        torch.cuda.synchronize()
        lone_peak = torch.cuda.max_memory_allocated() - lone_held
        lone_alive = srv.alive_stats(reset=True)
        lone_log = srv.batch_log()
        # the six requests, the batcher running ahead as it does
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        futs = [srv.submit(f"t{i % 2}", {"src_ids": ids})
                for i, ids in enumerate(reqs)]
        outs = [f.result(timeout=600) for f in futs]
        assert srv.drain(120), "drain did not finish"
        peak = torch.cuda.max_memory_allocated()
        alive = srv.alive_stats()
        st = srv.statusz()
        srv.stop()
        launches = fa.launch_count()
        log = srv.batch_log()[len(lone_log):]
        # attribution: one width-4 step through the same program and plan,
        # its fetch kept on the card; what stays allocated is what the
        # fetch holds, the rest of the peak is the step's temporaries
        compiled, feed_names, fetch_names, width4 = srv.plan.plan(2048)
        feed = {"src_ids": np.zeros((width4, 2048), np.int64)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _active_blocks()
        step_held = torch.cuda.memory_allocated()
        handle, = srv.executor.run(compiled, feed=feed,
                                   fetch_list=list(fetch_names),
                                   scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated() - step_held
        fetch_bytes = torch.cuda.memory_allocated() - step_held
        logits_bytes = handle.tensor.numel() * handle.tensor.element_size()
        # the blocks the step left allocated: the logits and what else
        left = sorted((v for k, v in _active_blocks().items()
                       if k not in before), reverse=True)
        del handle
    finally:
        flags.set_flags({"FLAGS_memory_budget_mb": 0})
    width = st["memory"]["per_bucket"]["2048"]["width"]
    if width != 4 or st["memory"]["budget_mb"] != budget_mb:
        raise AssertionError(f"observe_serve: statusz memory {st['memory']}"
                             f", expected width 4 under {budget_mb} MiB")
    for ids, out in zip(reqs, outs):
        if out[0].shape != (len(ids), cfg.vocab_size) or \
                not np.isfinite(out[0]).all():
            raise AssertionError("observe_serve: a request's logits")
    n_batches = len(log) + len(lone_log)
    if launches != cfg.n_layer * (n_batches + 1) or \
            any(b["occupancy"] > 4 for b in log):
        raise AssertionError(f"observe_serve: K1 launched {launches} for "
                             f"{n_batches} batches + warm-up, batches "
                             f"{[b['occupancy'] for b in log]}")
    for ids, out in zip(reqs, lone_outs):
        if out[0].shape != (len(ids), cfg.vocab_size) or \
                not np.isfinite(out[0]).all():
            raise AssertionError("observe_serve: a lone request's logits")
    budget_bytes = budget_mb << 20
    plan4 = st["memory"]["per_bucket"]["2048"]["static_peak_bytes"]
    _log("observe_serve", f"F2 lone batch: {len(lone_log)} batch "
         f"{[b['occupancy'] for b in lone_log]}, {lone_alive['max_alive']} "
         f"alive at once, peak {lone_peak / 2**30:.3f} GiB above the "
         f"{lone_held / 2**30:.3f} held against the plan's "
         f"{plan4 / 2**30:.3f} and the budget's {budget_bytes / 2**30:.3f} "
         f"({lone_peak / plan4:.3f}x the plan); one width-4 step alone: "
         f"peak {step_peak / 2**30:.3f} GiB above held, its fetch holding "
         f"{fetch_bytes / 2**30:.3f} GiB after the step (the logits "
         f"{logits_bytes / 2**30:.3f}; blocks left {left[:6]} bytes) on "
         f"{smi}")
    if len(lone_log) != 1 or lone_alive["max_alive"] != 1 or \
            lone_peak > budget_bytes * F2_SLACK:
        raise AssertionError(
            f"observe_serve: F2 lone batch peaked {lone_peak} bytes above "
            f"held, over the budget {budget_bytes} x {F2_SLACK} "
            f"({len(lone_log)} batches, {lone_alive} alive)")
    if not 0 <= fetch_bytes - logits_bytes <= F2_LEFT_BYTES:
        raise AssertionError(f"observe_serve: a step leaves {fetch_bytes} "
                             f"bytes allocated, its logits "
                             f"{logits_bytes} (blocks {left[:8]})")
    if peak - held > budget_bytes * alive["max_alive"] * F2_SLACK:
        raise AssertionError(
            f"observe_serve: F2 six requests peaked {peak - held} bytes "
            f"above held, over the budget {budget_bytes} x "
            f"{alive['max_alive']} batches alive x {F2_SLACK}")
    _log("observe_serve", f"F2 six requests: batches "
         f"{[b['occupancy'] for b in log]} with "
         f"{[b['alive_at_dispatch'] for b in log]} alive at each dispatch, "
         f"at most {alive['max_alive']} at once; peak "
         f"{(peak - held) / 2**30:.3f} GiB above held = "
         f"{(peak - held) / lone_peak:.3f}x the lone batch's, within "
         f"{alive['max_alive']} x the budget on {smi}")
    _log("observe_serve", f"bucket 2048 under FLAGS_memory_budget_mb "
         f"{budget_mb} (plan peaks {p4 / 2**30:.3f} GiB at width 4, "
         f"{p8 / 2**30:.3f} at 8): width {width}; {len(reqs)} requests in "
         f"{len(log)} batches {[b['occupancy'] for b in log]}, K1 launches "
         f"{launches}; measured peak {peak / 2**30:.3f} GiB "
         f"({(peak - held) / 2**30:.3f} above the {held / 2**30:.3f} held) "
         f"against the plan's {st['memory']['per_bucket']['2048']['static_peak_bytes'] / 2**30:.3f}"
         f" on {smi}")

    # a DecodeEngine's pools in the accountant's kv_pages class
    def kv_sample():
        hbm.ACCOUNTANT.note_step(0, None, None, 0)
        assert hbm.ACCOUNTANT.drain(60)
        return hbm._CLASS_CELLS["kv_pages"].get()

    gc.collect()
    before = kv_sample()
    eng = ptt.serving.DecodeEngine(cfg, scope, max_slots=8)
    pool = eng.cache.pool_bytes()
    after = kv_sample()
    if after - before != pool:
        raise AssertionError(f"observe_serve: kv_pages moved by "
                             f"{after - before}, the engine's pools are "
                             f"{pool} bytes")
    del eng
    gc.collect()
    _log("observe_serve", f"DecodeEngine(max_slots 8): kv_pages "
         f"{before / 2**30:.3f} -> {after / 2**30:.3f} GiB, its "
         f"pool_bytes() {pool / 2**30:.3f} GiB")
    return {"budget_mb": budget_mb, "plan_peak_w4": p4, "plan_peak_w8": p8,
            "width": width, "launches": launches,
            "batches": [b["occupancy"] for b in log],
            "alive_at_dispatch": [b["alive_at_dispatch"] for b in log],
            "max_alive": alive["max_alive"],
            "measured_peak_bytes": peak, "held_bytes": held,
            "lone_peak_above_held": lone_peak, "lone_held": lone_held,
            "step_peak_above_held": step_peak, "fetch_bytes": fetch_bytes,
            "logits_bytes": logits_bytes, "blocks_left": left,
            "kv_pool_bytes": pool}


def _numerics_mlp(mode):
    """``bench.py:959`` ``bench_numerics``' MLP on the card at one
    FLAGS_numerics mode, seeded: 3 warm-up and 40 timed lazy-fetch steps.
    Returns steps/s, the loss fingerprint, frames decoded, the forced
    syncs and the fetch materializations inside the timed steps."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags, layers, optimizer
    from paddle_tpu_torch.analysis import numerics
    from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                            unique_name)
    flags.set_flags({"FLAGS_numerics": mode})
    numerics.ENGINE.reset()
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        x = layers.data("x", shape=[256], dtype="float32")
        h = layers.fc(x, size=512, act="relu")
        h = layers.fc(h, size=512, act="relu")
        loss = layers.mean(layers.fc(h, size=256))
        optimizer.SGD(0.01).minimize(loss)
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=7)
    feed = {"x": torch.from_numpy(np.linspace(-1, 1, 256 * 256, dtype=np.float32)
                                  .reshape(256, 256)).cuda()}
    handles = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]
               for _ in range(NUMERICS_MLP_WARMUP)]
    exe.drain()
    forced0 = numerics.FORCED_SYNC_CTR.value()
    mat0 = exe.dispatch_stats()["fetch_materializations"]
    t0 = time.perf_counter()
    for _ in range(NUMERICS_MLP_STEPS):
        handles.append(exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope, return_numpy=False)[0])
    mats = exe.dispatch_stats()["fetch_materializations"] - mat0
    handles[-1].numpy()                 # one sync bounds the pipeline
    dt = time.perf_counter() - t0
    forced = numerics.FORCED_SYNC_CTR.value() - forced0
    losses = [float(h.numpy()) for h in handles]
    numerics.ENGINE.poll(force=True)
    return {"steps_per_s": NUMERICS_MLP_STEPS / dt,
            "fingerprint": numerics.loss_fingerprint(losses),
            "frames": numerics.ENGINE.frames_processed,
            "forced_syncs": forced, "materializations": mats,
            "last_gnorm": (numerics.ENGINE.last_frame.global_gnorm
                           if numerics.ENGINE.last_frame else None)}


def _count_kernels(run):
    """Kernels one call of ``run`` launches on the card (a CUDA-only
    ``torch.profiler`` trace; copies and memsets excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset", "[memory]")))


def _numerics_gpt(mode, cfg, feed):
    """``train``'s GPT (float32, 8 x 2048) from seeded weights in a fresh
    scope at one mode: 1 + NUMERICS_GPT_STEPS steps (host clock, each
    ending in its loss), then one step under a CUDA-only profiler whose
    kernels are counted."""
    import gc
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.analysis import numerics
    from paddle_tpu_torch.framework import Scope
    flags.set_flags({"FLAGS_numerics": mode})
    numerics.ENGINE.reset()
    main, startup, loss = _train_program(cfg, cfg.max_pos)
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=1234)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0])]
    step_s = []
    for _ in range(NUMERICS_GPT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
        step_s.append(time.perf_counter() - t0)
    kernels = _count_kernels(lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope))
    numerics.ENGINE.poll(force=True)
    f = numerics.ENGINE.last_frame
    out = {"losses": losses, "step_ms": [1e3 * x for x in step_s],
           "kernels_a_step": kernels,
           "frames": numerics.ENGINE.frames_processed,
           "gnorm": None if f is None else f.global_gnorm,
           "nonfinite": None if f is None else f.nonfinite}
    del exe, scope
    gc.collect()
    return out


def _numerics_gpt_interleaved(cfg, feed):
    """The sentinel's cost on the GPT step, fairly: one scope and executor
    (a plan a mode, both warm), NUMERICS_GPT_ROUNDS rounds of an off step
    then a sentinel step (host clock, each ending in its loss)."""
    import gc
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.framework import Scope
    main, startup, loss = _train_program(cfg, cfg.max_pos)
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=1234)
    times = {"off": [], "sentinel": []}
    for r in range(NUMERICS_GPT_ROUNDS + 1):
        for mode in ("off", "sentinel"):
            flags.set_flags({"FLAGS_numerics": mode})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            if r:                       # round 0 builds the plans
                times[mode].append(1e3 * (time.perf_counter() - t0))
    flags.set_flags({"FLAGS_numerics": "off"})
    del exe, scope
    gc.collect()
    return times


def _numerics_drill():
    """The poison drill of ``tools/numerics_smoke.py`` on the card: the
    MLP at sentinel under a CheckpointDaemon capturing every step, the
    ``numerics.poison`` site firing on step NUMERICS_POISON_AT; two more
    steps feed the anomaly's profiler window."""
    import shutil
    import tempfile
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags, layers, optimizer, profiler
    from paddle_tpu_torch.analysis import numerics
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                            unique_name)
    from paddle_tpu_torch.resilience import CheckpointDaemon
    prof_dir = tempfile.mkdtemp(prefix="chip_smoke_numerics_prof_")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_numerics_ckpt_")
    flags.set_flags({"FLAGS_numerics": "sentinel",
                     "FLAGS_profile_sample_dir": prof_dir})
    numerics.ENGINE.reset()
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        x = layers.data("x", shape=[256], dtype="float32")
        h = layers.fc(x, size=512, act="relu")
        loss = layers.mean(layers.fc(h, size=256))
        optimizer.SGD(0.01).minimize(loss)
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=7)
    feed = {"x": np.linspace(-1, 1, 64 * 256, dtype=np.float32)
            .reshape(64, 256)}
    ckpt = CheckpointManager(ckpt_dir, max_to_keep=20)
    daemon = CheckpointDaemon(ckpt, program=main, scope=scope,
                              interval_steps=1).start()
    holds0 = numerics.QUARANTINE_CTR.value()
    flags.set_flags({"FLAGS_fault_inject":
                     f"numerics.poison:once@{NUMERICS_POISON_AT}"})
    try:
        taken = []
        for step in range(1, NUMERICS_POISON_AT + 1):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
            taken.append(daemon.step_completed(step, scope=scope))
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        last = daemon.stop()
        numerics.ENGINE.poll(force=True)
        profiler.SAMPLER.close()
        with open(os.path.join(prof_dir, "manifest.json")) as f:
            triggers = [w["trigger"] for w in json.load(f)["windows"]]
        out = {"taken": taken, "last_committed": last,
               "latest_step": ckpt.latest_step(),
               "trips": sum(1 for r in numerics.ENGINE.anomalies
                            if r["kind"] == "nonfinite"),
               "poisoned_since": numerics.poisoned_since(),
               "holds": numerics.QUARANTINE_CTR.value() - holds0,
               "triggers": triggers}
    finally:
        flags.set_flags({"FLAGS_fault_inject": "", "FLAGS_numerics": "off",
                         "FLAGS_profile_sample_dir": ""})
        numerics.clear_quarantine()
        shutil.rmtree(prof_dir, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def _numerics_decode_drill():
    """A small GPT's decode loop on the card with every weight NaN'd: its
    logits are non-finite from the first iteration, and the sentinel
    records one ``nonfinite_logits`` anomaly for the episode."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.analysis import numerics
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    from paddle_tpu_torch.models import transformer as T
    cfg = T.BertConfig(vocab_size=64, d_model=32, n_layer=1, n_head=2,
                       d_inner=64, max_pos=64, dropout=0.0)
    scope = Scope()
    startup = Program()
    with program_guard(Program(), startup):
        T.build_gpt_serving(cfg, 8, attn_impl="base")
    ptt.Executor().run(startup, scope=scope, seed=5)
    for name, v in list(scope.items()):
        if v.is_floating_point():
            scope.set_var(name, v * float("nan"))
    flags.set_flags({"FLAGS_numerics": "sentinel"})
    numerics.ENGINE.reset()
    try:
        eng = ptt.serving.DecodeEngine(cfg, scope, max_slots=2,
                                       page_len=4, max_seq=32)
        dsrv = ptt.serving.DecodeServer(eng).start()
        gen = dsrv.submit("nan_t", [3, 5, 7], max_new_tokens=4).result(
            timeout=300)
        assert dsrv.drain(60)
        dsrv.stop()
        recs = [r for r in numerics.ENGINE.anomalies
                if r["kind"] == "nonfinite_logits"]
        counted = numerics.NONFINITE_CTR.value(var_class="logits")
    finally:
        flags.set_flags({"FLAGS_numerics": "off"})
    return {"generated": len(gen), "records": len(recs),
            "nonfinite_logits": counted}


def phase_numerics(smi):
    """The numerics plane on the card: the MLP at off / sentinel / full
    (loss fingerprints equal, overheads in steps/s, no forced sync), the
    GPT step at sentinel beside off (losses equal to the bit, K1/K2
    launched, kernels added a step), the poison drill and the decode
    logits drill.  Every check is fatal."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.analysis import numerics
    from paddle_tpu_torch.kernels import flash_attention as fa
    try:
        mlp = {m: _numerics_mlp(m) for m in ("off", "sentinel", "full")}
    finally:
        flags.set_flags({"FLAGS_numerics": "off"})
    fps = {m: r["fingerprint"] for m, r in mlp.items()}
    if len(set(fps.values())) != 1:
        raise AssertionError(f"numerics: MLP loss fingerprints differ "
                             f"across modes: {fps}")
    for m in ("sentinel", "full"):
        r = mlp[m]
        if r["forced_syncs"] or r["materializations"] or \
                r["frames"] < NUMERICS_MLP_WARMUP + NUMERICS_MLP_STEPS:
            raise AssertionError(f"numerics: MLP at {m}: {r}")
    ovh = {m: mlp["off"]["steps_per_s"] / mlp[m]["steps_per_s"] - 1.0
           for m in ("sentinel", "full")}
    rates = ", ".join(f"{m} {r['steps_per_s']:.1f}" for m, r in mlp.items())
    _log("numerics", f"MLP (bench.py:959) {NUMERICS_MLP_STEPS} steps: "
         f"{rates} steps/s; overhead sentinel {100 * ovh['sentinel']:.2f}%, full "
         f"{100 * ovh['full']:.2f}%; fingerprints equal ({fps['off'][:12]}); "
         f"frames decoded {mlp['sentinel']['frames']}, forced syncs 0 on "
         f"{smi}")

    cfg = _gpt_cfg()
    feed = _train_feed(cfg, TRAIN_BATCH, cfg.max_pos)
    fa.reset_launch_count()
    try:
        gpt = {m: _numerics_gpt(m, cfg, feed) for m in ("off", "sentinel")}
        inter = _numerics_gpt_interleaved(cfg, feed)
    finally:
        flags.set_flags({"FLAGS_numerics": "off"})
    launches = {k: fa.launch_count(k)
                for k in ("flash_attn_fwd", "flash_attn_bwd")}
    # each fresh run: warm-up, timed steps, the profiled step; then the
    # interleaved leg's plan-building round and its rounds
    runs = 2 * (NUMERICS_GPT_STEPS + 2) + 2 * (NUMERICS_GPT_ROUNDS + 1)
    off, sen = gpt["off"], gpt["sentinel"]
    if np.array(off["losses"], np.float32).tobytes() != \
            np.array(sen["losses"], np.float32).tobytes():
        raise AssertionError(f"numerics: GPT losses at sentinel "
                             f"{sen['losses']} differ from off "
                             f"{off['losses']}")
    if any(n != cfg.n_layer * runs for n in launches.values()):
        raise AssertionError(f"numerics: K1/K2 launched {launches} in "
                             f"{runs} GPT steps")
    if sen["frames"] < NUMERICS_GPT_STEPS + 2 or sen["nonfinite"] != 0 \
            or not np.isfinite(sen["gnorm"]) or sen["gnorm"] <= 0:
        raise AssertionError(f"numerics: GPT frames {sen}")
    added = sen["kernels_a_step"] - off["kernels_a_step"]
    med = {m: float(np.median(v)) for m, v in inter.items()}
    _log("numerics", f"GPT 8 x 2048 float32: losses equal to the bit "
         f"({', '.join(f'{x:.6f}' for x in sen['losses'])}); fresh runs' "
         f"steps off {', '.join(f'{x:.1f}' for x in off['step_ms'])} ms, "
         f"sentinel {', '.join(f'{x:.1f}' for x in sen['step_ms'])} ms; "
         f"kernels a step {off['kernels_a_step']} -> "
         f"{sen['kernels_a_step']} (+{added}); global grad norm "
         f"{sen['gnorm']:.4f}; K1/K2 {launches} on {smi}")
    _log("numerics", f"GPT interleaved on one executor, "
         f"{NUMERICS_GPT_ROUNDS} rounds: off "
         f"{', '.join(f'{x:.1f}' for x in inter['off'])} ms, sentinel "
         f"{', '.join(f'{x:.1f}' for x in inter['sentinel'])} ms; medians "
         f"{med['off']:.1f} / {med['sentinel']:.1f} ms "
         f"({100 * (med['sentinel'] / med['off'] - 1):+.2f}%) on {smi}")

    drill = _numerics_drill()
    want_taken = [True] * (NUMERICS_POISON_AT - 1) + [False]
    if drill["taken"] != want_taken or drill["trips"] != 1 or \
            drill["holds"] != 1 or \
            drill["latest_step"] != NUMERICS_POISON_AT - 1 or \
            "anomaly" not in drill["triggers"]:
        raise AssertionError(f"numerics: poison drill {drill}")
    _log("numerics", f"poison drill: step {NUMERICS_POISON_AT} entered "
         f"poisoned, the engine tripped {drill['trips']} time (poisoned "
         f"since step {drill['poisoned_since']}), captures "
         f"{drill['taken']}, quarantine holds +{drill['holds']}, the "
         f"checkpoint stays at step {drill['latest_step']}, windows "
         f"{drill['triggers']}")
    dec = _numerics_decode_drill()
    if dec["records"] != 1 or dec["generated"] != 4 or \
            dec["nonfinite_logits"] <= 0:
        raise AssertionError(f"numerics: decode logits drill {dec}")
    _log("numerics", f"decode logits drill: {dec['nonfinite_logits']:.0f} "
         f"non-finite logits counted, {dec['records']} nonfinite_logits "
         f"record")
    numerics.ENGINE.reset()
    return {"mlp": mlp, "overhead": ovh, "gpt": gpt,
            "gpt_interleaved_ms": inter, "gpt_interleaved_median_ms": med,
            "kernels_added_a_step": added, "launches": launches,
            "drill": drill, "decode_drill": dec}


def _http_get(url):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def phase_serve_plane(smi, serve):
    """``serve``'s GPT behind the serving plane: the tracer on, an
    FLAGS_serving_slo target, the scrape endpoint on 127.0.0.1 (port 0).
    Every request's phase spans sum to its e2e_ms (10% + 0.05 ms), each
    dispatch span carries its step and padding; the endpoints answer 200
    with the SLO state; shrink_widths halves bucket 2048 and the next batch
    runs at it; evicting a tenant retires its series.  Every check is
    fatal."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import flags, monitor
    from paddle_tpu_torch.kernels import flash_attention as fa
    cfg, factory, scope = _gpt_cfg(), serve["factory"], serve["scope"]
    flags.set_flags({"FLAGS_serving_slo": SERVE_PLANE_SLO,
                     "FLAGS_telemetry": True})
    rng = np.random.RandomState(21)
    reqs = [(f"plane_{'ab'[i % 2]}", rng.randint(
        1, cfg.vocab_size, (int(n),)).astype(np.int64))
        for i, n in enumerate([300, 420, 1500, 1800, 2000, 480])]
    fa.reset_launch_count()
    try:
        srv = ptt.serving.InferenceServer(factory, scope,
                                          buckets=(512, 2048), max_batch=8,
                                          batch_wait_ms=20.0)
        srv.warmup()
        torch.cuda.synchronize()
        srv.start()
        http = srv.enable_http(0, host="127.0.0.1")
        futs = [srv.submit(t, {"src_ids": ids}) for t, ids in reqs]
        outs = [f.result(timeout=600) for f in futs]
        srv._slo_eval_safe()
        codes = {p: _http_get(http.url + p) for p in
                 ("/metrics", "/healthz", "/statusz")}
        st = json.loads(codes["/statusz"][1])
        shrunk = srv.shrink_widths()
        extra = rng.randint(1, cfg.vocab_size, (1700,)).astype(np.int64)
        extra_out = srv.submit("plane_a", {"src_ids": extra}).result(
            timeout=600)
        log = srv.batch_log()
        evicted_before = sum(
            c.get() for lbl, c in monitor.SERVING_REQ_CTR.series()
            if lbl.get("tenant") in ("plane_a", "retired"))
        srv.tenants.evict("plane_a")
        metrics_after = _http_get(http.url + "/metrics")[1]
        assert srv.drain(120)
        srv.stop()
    finally:
        flags.set_flags({"FLAGS_serving_slo": ""})
    launches = fa.launch_count()
    for (t, ids), out in zip(reqs + [("plane_a", extra)],
                             outs + [extra_out]):
        if out[0].shape != (len(ids), cfg.vocab_size) or \
                not np.isfinite(out[0]).all():
            raise AssertionError(f"serve_plane: a request's logits {t}")
    # the request trace chains, by trace id
    spans = {}
    for ph, name, cat, _tid, t0, dur, args in list(monitor.TRACER._events):
        if ph == "X" and cat == "serving" and args and \
                str(args.get("tenant", "")).startswith("plane_"):
            spans.setdefault(args["trace"], []).append((t0, dur, name,
                                                        args))
    worst = 0.0
    for trace, chain in spans.items():
        chain.sort()
        names = [n for _t0, _d, n, _a in chain]
        if names != ["serving.admit", "serving.queue_wait",
                     "serving.batch_wait", "serving.dispatch",
                     "serving.materialize"]:
            raise AssertionError(f"serve_plane: trace {trace}: {names}")
        e2e = chain[-1][3]["e2e_ms"]
        total = 1e3 * sum(d for _t0, d, _n, _a in chain)   # s -> ms
        worst = max(worst, abs(total - e2e) / e2e)
        if abs(total - e2e) > TRACE_SUM_RTOL * e2e + TRACE_SUM_ATOL_MS:
            raise AssertionError(f"serve_plane: trace {trace} phases sum "
                                 f"to {total} ms, e2e {e2e} ms")
        d = chain[3][3]
        if d["step"] < 1 or d["pad_rows"] != d["width"] - d["occupancy"]:
            raise AssertionError(f"serve_plane: dispatch span {d}")
    if len(spans) != len(reqs) + 1:
        raise AssertionError(f"serve_plane: {len(spans)} trace chains for "
                             f"{len(reqs) + 1} requests")
    if any(c != 200 for c, _ in codes.values()) or st["slo"] is None or \
            "paddle_tpu_serving_phase_ms" not in codes["/metrics"][1]:
        raise AssertionError(f"serve_plane: endpoints "
                             f"{ {p: c for p, (c, _) in codes.items()} }, "
                             f"statusz slo {st.get('slo')}")
    if shrunk != {512: 4, 2048: 4} or log[-1]["bucket"] != 2048 or \
            log[-1]["width"] != 4:
        raise AssertionError(f"serve_plane: shrink_widths {shrunk}, last "
                             f"batch {log[-1]}")
    if any(lbl.get("tenant") == "plane_a"
           for fam in (monitor.SERVING_REQ_CTR, monitor.SERVING_PHASE_HIST,
                       monitor.SERVING_LAT_HIST)
           for lbl, _c in fam.series()) or 'tenant="plane_a"' in \
            metrics_after:
        raise AssertionError("serve_plane: plane_a's series survived its "
                             "eviction")
    retired = sum(c.get() for lbl, c in monitor.SERVING_REQ_CTR.series()
                  if lbl.get("tenant") in ("plane_a", "retired"))
    if retired != evicted_before:
        raise AssertionError(f"serve_plane: requests_total moved "
                             f"{evicted_before} -> {retired} on eviction")
    k1_batches = sum(1 for b in log if b["bucket"] >= 1024) + 1
    if launches != cfg.n_layer * k1_batches:
        raise AssertionError(f"serve_plane: K1 launched {launches}, "
                             f"expected {cfg.n_layer} x {k1_batches}")
    _log("serve_plane", f"{len(spans)} request trace chains, phase sums "
         f"within {100 * worst:.3f}% of e2e; batches "
         f"{[(b['bucket'], b['width'], b['occupancy']) for b in log]}; "
         f"endpoints {[c for c, _ in codes.values()]}, statusz slo "
         f"{sorted(st['slo'])}; shrink_widths {shrunk}; plane_a evicted, "
         f"its series folded into retired; K1 launches {launches} on "
         f"{smi}")
    return {"traces": len(spans), "worst_phase_sum_rel": worst,
            "batches": [(b["bucket"], b["width"], b["occupancy"])
                        for b in log],
            "codes": {p: c for p, (c, _) in codes.items()},
            "slo": st["slo"], "shrunk": shrunk, "launches": launches}


def _wait_fresh(router, n, timeout_s=15.0):
    """Until the router's prober has heard from ``n`` replicas."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        view = router.replica_view()
        if sum(1 for r in view.values() if r["fresh"]) >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"serve_fleet: replicas never fresh: "
                         f"{router.replica_view()}")


def _fleet_in_process(cfg, scope):
    """(a): two endpoints, each over its own InferenceServer on the card,
    behind one router: 8 requests routed one by one and the same 8 submitted
    directly, then the 8 again from 4 client threads while one endpoint
    stops."""
    import threading
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import FleetRouter, ReplicaEndpoint
    factory = _factory(cfg, attn_impl="flash")
    srvs, eps = [], []
    for i in range(2):
        sc = Scope()              # the same tensors, a scope a server
        for name, val in scope.items():
            sc.set_var(name, val)
        srv = ptt.serving.InferenceServer(
            factory, sc, buckets=(FLEET_BUCKET,), max_batch=4,
            batch_wait_ms=2.0)
        srv.warmup()
        srvs.append(srv.start())
        eps.append(ReplicaEndpoint(srv, host="127.0.0.1",
                                   replica_id=f"fleet-{i}").start())
    router = FleetRouter([e.address for e in eps],
                         digest_ttl_s=3.0).start()
    rng = np.random.RandomState(31)
    reqs = [(f"fleet_{'ab'[i % 2]}",
             rng.randint(1, cfg.vocab_size, (int(n),)).astype(np.int64))
            for i, n in enumerate(rng.randint(FLEET_TOKENS[0],
                                              FLEET_TOKENS[1] + 1,
                                              FLEET_REQUESTS))]
    try:
        _wait_fresh(router, 2)
        torch.cuda.synchronize()
        for name in _KERNEL_MODULES:
            _kernel_module(name).reset_launch_count()
        dead0 = monitor.FLEET_REROUTE_CTR.value(reason="dead")
        routed, lat_routed = [], []
        for t, ids in reqs:
            t0 = time.perf_counter()
            out = router.infer(t, {"src_ids": ids})
            lat_routed.append((time.perf_counter() - t0) * 1e3)
            routed.append(np.asarray(out[0], np.float32))
        direct, lat_direct = [], []
        for t, ids in reqs:
            t0 = time.perf_counter()
            out = srvs[0].submit(t, {"src_ids": ids}).result(timeout=600)
            lat_direct.append((time.perf_counter() - t0) * 1e3)
            direct.append(out[0])
        # the largest response's frame: bytes, JSON encode and decode
        big = max(range(len(reqs)), key=lambda i: len(reqs[i][1]))
        t0 = time.perf_counter()
        body = json.dumps({"ok": True, "outputs": [routed[big].tolist()]},
                          sort_keys=True).encode("utf-8")
        t1 = time.perf_counter()
        json.loads(body.decode("utf-8"))
        t2 = time.perf_counter()
        frame = {"bytes": len(body) + 4, "tokens": len(reqs[big][1]),
                 "encode_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3}
        # the kill leg: 4 clients, endpoint 0 stops after 3 answers
        got, errors, mu = {}, [], threading.Lock()
        three = threading.Event()

        def client(idx):
            for i in range(idx, len(reqs), 4):
                try:
                    out = router.infer(reqs[i][0], {"src_ids": reqs[i][1]})
                    with mu:
                        got[i] = np.asarray(out[0], np.float32)
                        if len(got) >= 3:
                            three.set()
                except Exception as e:        # counted, checked below
                    with mu:
                        errors.append(repr(e))
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        t_kill = time.perf_counter()
        for th in threads:
            th.start()
        three.wait(timeout=600)
        eps[0].stop()
        for th in threads:
            th.join(timeout=600)
        kill_s = time.perf_counter() - t_kill
        snap = router.snapshot()
        dead = monitor.FLEET_REROUTE_CTR.value(reason="dead") - dead0
        # a batch counts its K1 launches when it is dispatched and enters
        # the batch log when its fetches land: the stopped endpoint's
        # server may still run one whose requests were rerouted, so both
        # servers drain before the two counts are read
        for s in srvs:
            s.drain(120)
        torch.cuda.synchronize()
        launches = fa.launch_count("flash_attn_fwd")
        others = _launches_nonzero()
        batches = sum(len(s.batch_log()) for s in srvs)
    finally:
        router.stop()
        for e in eps:
            e.stop()
        for s in srvs:
            s.drain(120)
            s.stop()
    worst = 0.0
    for i, (t, ids) in enumerate(reqs):
        for what, o in (("routed", routed[i]), ("kill leg", got.get(i))):
            if o is None or o.shape != (len(ids), cfg.vocab_size) or \
                    not np.isfinite(o).all():
                raise AssertionError(f"serve_fleet: {what} request {i}: "
                                     f"{None if o is None else o.shape}")
            err = np.abs(o - direct[i])
            worst = max(worst, float(err.max()))
            if not (err <= FLEET_ATOL + FLEET_RTOL
                    * np.abs(direct[i])).all():
                raise AssertionError(
                    f"serve_fleet: {what} request {i} differs from the "
                    f"direct submit by {err.max()} (atol {FLEET_ATOL} "
                    f"rtol {FLEET_RTOL})")
    if errors or snap["failed"] or snap["rejected"] or \
            snap["completed"] != snap["admitted"] or \
            snap["admitted"] != 2 * len(reqs):
        raise AssertionError(f"serve_fleet: kill leg errors {errors[:3]}, "
                             f"ledger {snap}")
    if dead < 1:
        raise AssertionError("serve_fleet: no reroutes{reason=dead} after "
                             "an endpoint stopped mid-stream")
    if launches != cfg.n_layer * batches or launches == 0:
        raise AssertionError(f"serve_fleet: K1 launched {launches}, "
                             f"expected {cfg.n_layer} x {batches} batches")
    return {"requests": 2 * len(reqs), "max_abs_err": worst,
            "routed_p50_ms": float(np.percentile(lat_routed, 50)),
            "routed_p99_ms": float(np.percentile(lat_routed, 99)),
            "direct_p50_ms": float(np.percentile(lat_direct, 50)),
            "direct_p99_ms": float(np.percentile(lat_direct, 99)),
            "frame": frame, "dead_reroutes": dead, "kill_leg_s": kill_s,
            "batches": batches, "launches": launches,
            "other_launches": {k: v for k, v in others.items()
                               if k != "flash_attn_fwd"},
            "ledger": {k: snap[k] for k in ("admitted", "completed",
                                            "failed", "rejected")}}


def _fleet_decode(cfg, scope, pool_bytes):
    """(b): a DecodeServer behind an endpoint; the router's greedy tokens
    against the same server's direct submit.  The engine is ``decode``'s
    (``pool_bytes`` its pools)."""
    from paddle_tpu_torch.serving import (DecodeEngine, DecodeServer,
                                          FleetRouter, ReplicaEndpoint)
    eng = DecodeEngine(cfg, scope, max_slots=DECODE_SLOTS)
    if eng.cache.pool_bytes() != pool_bytes:
        raise AssertionError(f"serve_fleet: decode pools "
                             f"{eng.cache.pool_bytes()} != {pool_bytes}")
    srv = DecodeServer(eng).start()
    ep = ReplicaEndpoint(srv, host="127.0.0.1",
                         replica_id="fleet-decode").start()
    router = FleetRouter([ep.address], digest_ttl_s=3.0).start()
    rng = np.random.RandomState(41)
    prompts = [rng.randint(1, cfg.vocab_size, (int(n),)).astype(np.int64)
               for n in rng.randint(FLEET_DECODE_LEN[0],
                                    FLEET_DECODE_LEN[1] + 1,
                                    FLEET_DECODE_PROMPTS)]
    try:
        t0 = time.perf_counter()
        routed = [router.decode("fleet_dec", p,
                                max_new_tokens=FLEET_DECODE_NEW)
                  for p in prompts]
        routed_s = time.perf_counter() - t0
        direct = [[int(x) for x in srv.submit(
            "fleet_dec", p, max_new_tokens=FLEET_DECODE_NEW).result(600)]
            for p in prompts]
    finally:
        router.stop()
        ep.stop()
        srv.drain(120)
        srv.stop()
    if routed != direct or any(len(r) != FLEET_DECODE_NEW for r in routed):
        raise AssertionError(f"serve_fleet: routed decode {routed} != "
                             f"direct {direct}")
    return {"prompts": len(prompts), "tokens": FLEET_DECODE_NEW,
            "routed_s": routed_s, "traces": int(eng.trace_count)}


def _replica_cfg():
    """The replicas' GPT: ``serve``'s width at ``FLEET_REPLICA_WIDTH``'s
    depth; its parameters are the first layers of ``serve``'s, by name."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.tools import fleet_smoke
    return T.BertConfig(**fleet_smoke.WIDTHS[FLEET_REPLICA_WIDTH])


def _fleet_replicas(cfg, scope):
    """(c): ``tools/fleet_smoke.py --width full2`` for drain, kill and
    scale: replica processes on this card serving ``scope``'s weights
    (saved here with ``io.save_persistables``), loading the kernels built
    above.  The tool holds every replica's probe logits against the same
    probe served here in process over ``scope`` (``--expect``).  Returns
    its FLEET RESULT."""
    import shutil
    import tempfile
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.tools import fleet_smoke
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "paddle_tpu_torch", "tools", "fleet_smoke.py")
    env = dict(os.environ, PADDLE_TPU_TORCH_BUILD_DIR=str(
        _build.build_dir()))
    wdir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        factory = _factory(cfg, attn_impl="flash")
        prog = factory(FLEET_BUCKET)[0]
        ptt.io.save_persistables(None, os.path.join(wdir, "w"),
                                 main_program=prog, scope=scope)
        sc = Scope()              # the same tensors, the server's own scope
        for name, val in scope.items():
            sc.set_var(name, val)
        expect = fleet_smoke.serve_probe(factory, sc, ptt.Executor(),
                                         FLEET_REPLICA_WIDTH)
        if expect.shape != (fleet_smoke.REQUEST_TOKENS[FLEET_REPLICA_WIDTH],
                            cfg.vocab_size) or not np.isfinite(expect).all():
            raise AssertionError(f"serve_fleet: probe logits {expect.shape}")
        np.save(os.path.join(wdir, "expect.npy"), expect)
        r = subprocess.run(
            [sys.executable, tool, "--width", FLEET_REPLICA_WIDTH,
             "--weights", os.path.join(wdir, "w"),
             "--expect", os.path.join(wdir, "expect.npy"),
             "--scenario", "drain", "kill", "scale"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, timeout=FLEET_SMOKE_TIMEOUT_S)
    finally:
        shutil.rmtree(wdir, ignore_errors=True)
    lines = r.stdout.splitlines()
    for ln in lines:
        if ln.startswith("fleet ") or ln.startswith("weights "):
            _log("serve_fleet", ln)
    res = [ln for ln in lines if ln.startswith("FLEET RESULT ")]
    if r.returncode != 0 or "FLEET SMOKE PASS" not in lines or not res:
        tail = "\n".join(ln for ln in lines
                         if not ln.startswith("STATS"))[-6000:]
        raise AssertionError(f"serve_fleet: fleet_smoke exited "
                             f"{r.returncode}:\n{tail}")
    out = json.loads(res[-1][len("FLEET RESULT "):])["scenarios"]
    _check_fleet_result(out, cfg.n_layer)
    return out


def _check_fleet_result(out, n_layer):
    """fleet_smoke's numbers against the phase's contract: the drained
    child exited 0, re-routes of each kind, one scale-up, one death
    repair, one idle retire whose child exited 0, and every child prebuilt,
    served, and launched K1 ``n_layer`` times a batch."""
    d, k, sc = out["drain"], out["kill"], out["scale"]
    if d["drained_rc"] != 0 or d["drain_reroutes"] < 1:
        raise AssertionError(f"serve_fleet: drain {d}")
    if k["dead_reroutes"] < 1:
        raise AssertionError(f"serve_fleet: kill {k}")
    if (sc["scale_up"], sc["death_repair"], sc["idle_retire"],
            sc["retired_rc"]) != (1, 1, 1, [0]):
        raise AssertionError(f"serve_fleet: scale {sc}")
    for name, scen in out.items():
        for ch in scen["children"]:
            st = ch["stats"]
            if st is None or st["prebuilt"] is not True:
                raise AssertionError(f"serve_fleet: {name} child {ch}: no "
                                     "stats, or it built its kernels")
            if st["batches"] == 0 or st["k1"] < n_layer * \
                    st["batches"] or (st["final"] and st["k1"] !=
                                      n_layer * st["batches"]):
                raise AssertionError(f"serve_fleet: {name} child {ch}: K1 "
                                     f"against its batches")


def phase_serve_fleet(smi, serve, decode):
    """``serve``'s GPT behind the serving fleet.  (a) two
    ``ReplicaEndpoint``s over two ``InferenceServer``s (bucket 32,
    ``max_batch`` 4, flash attention) behind a ``FleetRouter``: 8 requests
    of 4-12 tokens from two tenants, routed and direct, the routed logits
    within ``FLEET_ATOL`` + ``FLEET_RTOL`` of the direct ones; the same
    requests from 4 clients while one endpoint stops: no failure,
    ``reroutes{dead}`` >= 1, the ledger exact, K1 12 times a batch.  (b) a
    ``DecodeServer`` (8 slots) behind an endpoint: 4 greedy prompts through
    ``FleetRouter.decode`` equal to the same server's ``submit``, token
    for token.  (c) ``fleet_smoke.py --width full2`` (drain, kill, scale:
    replica processes on this card, each replica's probe logits within
    ``FLEET_ATOL`` + ``FLEET_RTOL`` of an in-process server's).  Every
    check is fatal."""
    import torch
    cfg, scope = _gpt_cfg(), serve["scope"]
    t_phase = time.perf_counter()
    a = _fleet_in_process(cfg, scope)
    fr = a["frame"]
    _log("serve_fleet", f"(a) {a['requests']} requests over 2 endpoints, "
         f"max |routed - direct| {a['max_abs_err']:.3g} (atol {FLEET_ATOL} "
         f"rtol {FLEET_RTOL}); routed p50/p99 {a['routed_p50_ms']:.1f}/"
         f"{a['routed_p99_ms']:.1f} ms, direct {a['direct_p50_ms']:.1f}/"
         f"{a['direct_p99_ms']:.1f} ms (one at a time); largest frame "
         f"{fr['bytes']} bytes ({fr['tokens']} tokens), JSON encode "
         f"{fr['encode_ms']:.1f} ms decode {fr['decode_ms']:.1f} ms; kill "
         f"leg {a['kill_leg_s']:.2f} s, {a['dead_reroutes']:.0f} dead "
         f"reroute(s), ledger {a['ledger']}; K1 {a['launches']} = "
         f"{cfg.n_layer} x {a['batches']} batches, other kernels "
         f"{a['other_launches']}")
    b = _fleet_decode(cfg, scope, decode["pool_bytes"])
    torch.cuda.empty_cache()
    _log("serve_fleet", f"(b) {b['prompts']} prompts x {b['tokens']} "
         f"greedy tokens routed in {b['routed_s']:.2f} s, equal to the "
         f"direct submit; decode traces {b['traces']}")
    t_c = time.perf_counter()
    c = _fleet_replicas(_replica_cfg(), scope)
    c_s = time.perf_counter() - t_c
    kids = [(name, ch) for name, scen in c.items()
            for ch in scen["children"]]
    for name, ch in kids:
        st = ch["stats"]
        _log("serve_fleet", f"(c) {name} child {ch['addr']}: rc "
             f"{ch['rc']}, spawn to READY {ch['spawn_to_ready_s']:.2f} s "
             f"(its own clock: imports {st['imported_s']:.2f} s, weights "
             f"on the card {st['loaded_s']:.2f} s, READY "
             f"{st['ready_s']:.2f} s), K1 {st['k1']} over "
             f"{st['batches']} batches, peak "
             f"{st['peak_bytes'] / 2**20:.1f} MiB allocated")
    wall = time.perf_counter() - t_phase
    _log("serve_fleet", f"(c) {c_s:.1f} s: drain p99 "
         f"{c['drain']['p99_ms']:.1f} ms, kill p99 "
         f"{c['kill']['p99_ms']:.1f} ms, scale-up after "
         f"{c['scale']['scale_up_s']:.2f} s of spike (p99 "
         f"{c['scale']['p99_spike_ms']:.1f} ms), recovered p99 "
         f"{c['scale']['p99_recovered_ms']:.1f} ms < "
         f"{c['scale']['slo_p99_ms']:.1f} ms; phase wall {wall:.1f} s on "
         f"{smi}")
    return {"in_process": a, "decode": b, "replicas": c,
            "replicas_s": c_s, "wall_s": wall, "launches": a["launches"],
            "replica_launches": sum(ch["stats"]["k1"] for _n, ch in kids)}


def _dygraph_resnet(smi):
    """``dygraph_train`` (a): ResNet-50 built from ``dygraph.nn`` layers
    (``tests/_dygraph_resnet.py``) from the static program's startup
    values, DYGRAPH_STEPS Momentum steps against the unfused static
    program on the same card and feed; then (c) its save and load."""
    import tempfile
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import dygraph, flags, optimizer
    from paddle_tpu_torch.framework import Scope
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from _dygraph_resnet import build_resnet, conv_bns, load_static, loss_of

    cfg = DYGRAPH_RESNET
    main, startup, loss, _ = _resnet_program(**cfg)
    scope, exe = Scope(), ptt.Executor()
    exe.run(startup, scope=scope, seed=1234)
    values = {n: v.detach().clone() for n, v in scope.items()}
    feed = _resnet_feed(DYGRAPH_BATCH, cfg["class_dim"], cfg["image_shape"],
                        seed=3)

    def timed(step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def static_run():
        """DYGRAPH_STEPS unfused static steps from ``values``: losses and
        seconds, the peak above held, fc_out.w and DYGRAPH_BN_STAT."""
        for n, v in values.items():
            scope.set_var(n, v.clone())
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        flags.set_flags({"FLAGS_graph_fusion": False})
        try:
            steps = [timed(lambda: float(exe.run(
                main, feed=feed, fetch_list=[loss], scope=scope)[0]))
                for _ in range(DYGRAPH_STEPS)]
        finally:
            flags.set_flags({"FLAGS_graph_fusion": True})
        return (steps, torch.cuda.max_memory_allocated() - held,
                scope.find_var("fc_out.w").detach().clone(),
                scope.find_var(DYGRAPH_BN_STAT).detach().clone())

    # cuDNN's default algorithms accumulate a conv's weight gradient in no
    # fixed order: two runs of the static program itself differ after the
    # first update, and lr 0.1 amplifies that over the steps.  The
    # yardstick is two such runs; the held comparison runs both sides on
    # its deterministic algorithms
    noise = [static_run()[0] for _ in range(2)]
    noise_rel = max(abs(x - y) / abs(y) for (x, _), (y, _) in
                    zip(*noise))
    torch.backends.cudnn.deterministic = True
    try:
        static, static_peak, want_w, want_m = static_run()
        del scope, exe
        torch.cuda.empty_cache()
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t_b = time.perf_counter()
        with dygraph.guard():
            net = build_resnet(ptt, **{k: cfg[k] for k in ("depth",
                                                           "class_dim")})
            load_static(dygraph, net, values, cfg["image_shape"])
            build_s = time.perf_counter() - t_b
            opt = optimizer.MomentumOptimizer(
                0.1, 0.9, parameter_list=net.parameters())

            def step():
                l = loss_of(dygraph, net,
                            dygraph.to_variable(feed["image"]),
                            dygraph.to_variable(feed["label"]))
                l.backward()
                opt.minimize(l)
                net.clear_gradients()
                return float(l.numpy())
            dyn = [timed(step) for _ in range(DYGRAPH_STEPS)]
            dyn_peak = torch.cuda.max_memory_allocated() - held
            bn = {l.bn_name + ".mean": l.bn for l in conv_bns(net)}
            got_w = net.fc.weight.value
            got_m = bn[DYGRAPH_BN_STAT]._mean.value
            launches = _launches_nonzero()
            # (c) save, zero every parameter and buffer, load back
            state = {k: v.value.clone()
                     for k, v in net.state_dict().items()}
            with tempfile.TemporaryDirectory() as d:
                t_s = time.perf_counter()
                dygraph.save_dygraph(net.state_dict(),
                                     os.path.join(d, "rn50"))
                save_s = time.perf_counter() - t_s
                nbytes = os.path.getsize(os.path.join(d, "rn50.pdparams"))
                for v in net.state_dict().values():
                    v.set_value(torch.zeros_like(v.value))
                t_l = time.perf_counter()
                params, _ = dygraph.load_dygraph(os.path.join(d, "rn50"))
                net.set_dict(params)
                load_s = time.perf_counter() - t_l
            differ = [k for k, v in net.state_dict().items()
                      if not torch.equal(v.value, state[k])
                      or v.value.device != state[k].device]
    finally:
        torch.backends.cudnn.deterministic = False
    if differ:
        raise AssertionError(f"dygraph_train (c): {len(differ)} of "
                             f"{len(state)} tensors differ after save and "
                             f"load, first {differ[:3]}")
    losses = [(x, y) for (x, _), (y, _) in zip(dyn, static)]
    worst = max(abs(x - y) / abs(y) for x, y in losses)
    w_frac = float((got_w - want_w).abs().max() / want_w.abs().max())
    m_frac = float((got_m - want_m).abs().max() / want_m.abs().max())
    dyn_ms = [1e3 * t for _, t in dyn]
    static_ms = [1e3 * t for _, t in static]
    default_ms = [1e3 * t for _, t in noise[1]]
    _log("dygraph_train", f"(a) ResNet-50 in dygraph (Conv2D / BatchNorm / "
         f"Pool2D / FC), batch {DYGRAPH_BATCH} x "
         f"{'x'.join(map(str, cfg['image_shape']))} float32, "
         f"MomentumOptimizer(0.1, 0.9, parameter_list=...), built and "
         f"loaded from the static startup in {build_s:.2f} s: losses "
         f"{[x for x, _ in losses]} against the unfused static program's "
         f"{[y for _, y in losses]}, worst relative {worst:.3g} (limit "
         f"{DYGRAPH_LOSS_RTOL}); after step {DYGRAPH_STEPS} fc_out.w "
         f"{w_frac:.3g} and {DYGRAPH_BN_STAT} {m_frac:.3g} of their largest "
         f"magnitude (limit {DYGRAPH_PARAM_FRAC}), both on cuDNN's "
         f"deterministic algorithms (two static runs on its default ones "
         f"differ by {noise_rel:.3g} relative, losses "
         f"{[x for x, _ in noise[0]]} and {[x for x, _ in noise[1]]}); "
         f"steps {', '.join(f'{x:.1f}' for x in dyn_ms)} ms dygraph, "
         f"{', '.join(f'{x:.1f}' for x in static_ms)} ms static, "
         f"{', '.join(f'{x:.1f}' for x in default_ms)} ms static on the "
         f"default algorithms (host clock, each ending in a synchronize; "
         f"the first of each a warm-up); peak {dyn_peak / 2**30:.3f} GiB "
         f"above held dygraph, {static_peak / 2**30:.3f} static; launches "
         f"{launches}; on {smi}")
    _log("dygraph_train", f"(c) save_dygraph of {len(state)} tensors "
         f"({nbytes} B) in {save_s:.2f} s, load_dygraph + set_dict in "
         f"{load_s:.2f} s: every tensor equal bit for bit on "
         f"{next(iter(state.values())).device}")
    if not worst <= DYGRAPH_LOSS_RTOL or not w_frac <= DYGRAPH_PARAM_FRAC \
            or not m_frac <= DYGRAPH_PARAM_FRAC:
        raise AssertionError("dygraph_train (a): dygraph and static differ "
                             "beyond the limits above")
    if launches:
        raise AssertionError(f"dygraph_train (a): kernels launched on the "
                             f"unfused ResNet path: {launches}")
    return {"losses": [x for x, _ in losses],
            "static_losses": [y for _, y in losses], "worst_rel": worst,
            "fc_out_w_frac": w_frac, "bn_mean_frac": m_frac,
            "static_noise_rel": noise_rel, "step_ms": dyn_ms,
            "static_step_ms": static_ms, "static_default_ms": default_ms,
            "peak_bytes": dyn_peak, "static_peak_bytes": static_peak,
            "build_s": build_s, "save_s": save_s, "load_s": load_s,
            "checkpoint_bytes": nbytes}


def _dygraph_attention(smi):
    """``dygraph_train`` (b): Linear to q, k, v, a traced
    ``flash_attention`` (K1, its backward K2), ``Dropout``, ``mean`` and
    ``backward()``; the q, k, v gradients against autograd of the plain
    attention on the card, the dropout's gradient against mask x scale x
    upstream exactly."""
    import torch
    import paddle_tpu_torch as ptt  # noqa: F401
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.nn_ops import dropout_scale
    b, h, t, d = DYGRAPH_ATTN
    w = h * d
    rng = np.random.RandomState(5)
    x_np = rng.randn(b * t, w).astype(np.float32)
    per_step, step_ms, errs = [], [], {}
    with dygraph.guard():
        tracer = dygraph.default_tracer()
        proj = [dygraph.Linear(w, w) for _ in range(3)]
        drop = dygraph.Dropout(DYGRAPH_DROPOUT)

        def heads(y):
            y = tracer.trace_op("reshape2", {"X": [y]},
                                {"shape": [b, t, h, d]})["Out"][0]
            return tracer.trace_op("transpose2", {"X": [y]},
                                   {"axis": [0, 2, 1, 3]})["Out"][0]
        for _ in range(DYGRAPH_ATTN_STEPS):
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = dygraph.to_variable(x_np)
            q, k, v = (heads(p(x)) for p in proj)
            o = tracer.trace_op("flash_attention",
                                {"Q": [q], "K": [k], "V": [v]},
                                {"causal": True})["Out"][0]
            y = drop(o)
            loss = tracer.trace_op("mean", {"X": [y]}, {})["Out"][0]
            loss.backward()
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            per_step.append(_launches_nonzero())
        # the plain attention, differentiated by autograd, on the same
        # q, k, v and upstream gradient; both sides scaled by the mean's
        # count, the gradients of the sum
        n = float(o.value.numel())
        leaves = [z.value.reshape(b * h, t, d).detach().requires_grad_(True)
                  for z in (q, k, v)]
        ref_o, _ = fa.flash_attention_reference(*leaves, causal=True)
        want = torch.autograd.grad(ref_o, leaves,
                                   o.grad.reshape(b * h, t, d))
        for name, z, r in zip("qkv", (q, k, v), want):
            errs[name] = _check(f"dygraph_train (b) d{name}",
                                z.grad.reshape(b * h, t, d) * n, r * n)
        keep = y.value != 0
        if bool((o.value == 0).any()):
            raise AssertionError("dygraph_train (b): an attention output "
                                 "is exactly 0, so the mask cannot be read "
                                 "from the dropout's output")
        scale = torch.tensor(dropout_scale(
            {"dropout_prob": DYGRAPH_DROPOUT,
             "dropout_implementation": "upscale_in_train"}),
            dtype=torch.float32, device=o.device)
        want_do = torch.where(keep, y.grad * scale, torch.zeros_like(y.grad))
        if not torch.equal(o.grad, want_do):
            raise AssertionError(
                f"dygraph_train (b): the dropout's gradient differs from "
                f"mask x scale x upstream at "
                f"{int((o.grad != want_do).sum())} elements")
        kept = float(keep.float().mean())
    want_counts = {"flash_attn_fwd": 1, "flash_attn_bwd": 1, "dropout": 2}
    if any(c != want_counts for c in per_step):
        raise AssertionError(f"dygraph_train (b): launches a step "
                             f"{per_step}, expected {want_counts}")
    _log("dygraph_train", f"(b) Linear -> q, k, v [{b}, {h}, {t}, {d}] -> "
         f"traced flash_attention (causal) -> Dropout({DYGRAPH_DROPOUT}) -> "
         f"mean -> backward(): dq, dk, dv x {int(n)} within atol {ATOL} + "
         f"rtol {RTOL} of autograd of the plain attention (max abs "
         f"{', '.join(f'd{k} {e:.3g}' for k, e in errs.items())}); the "
         f"dropout's gradient equal to mask x scale x upstream bit for bit "
         f"(kept {kept:.4f}); launches a step {per_step[-1]}; steps "
         f"{', '.join(f'{x:.1f}' for x in step_ms)} ms (forward and "
         f"backward, host clock ending in a synchronize); on {smi}")
    return {"launches": {k: v * DYGRAPH_ATTN_STEPS
                         for k, v in want_counts.items()},
            "max_abs_err": errs, "step_ms": step_ms, "kept": kept}


def phase_dygraph_train(smi):
    """Dygraph on the card (module docstring): (a) and (c) ResNet-50, (b)
    the traced flash attention."""
    t_phase = time.perf_counter()
    a = _dygraph_resnet(smi)
    b = _dygraph_attention(smi)
    wall = time.perf_counter() - t_phase
    _log("dygraph_train", f"phase wall time {wall:.1f} s")
    return {"resnet": a, "attention": b, "launches": b["launches"],
            "wall_s": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write every measurement here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one bucket-2048 batch, a decode "
                         "step (graph and uncaptured), a float32 "
                         "and an AMP GPT step, a float32 and an AMP "
                         "ResNet-50 step, a step of each ring_train "
                         "program and a bert_train step by kernel")
    ap.add_argument("--only", choices=("ps_train", "dygraph_train",
                                       "seq2seq", "optimizers"),
                    help="a probe: build the kernels, run dp_train's "
                         "one-device steps and this phase alone, and end "
                         "with the phase's summary (not the ok line)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (the fused LM head) accumulate in float32 throughout
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    smi, built = phase_env()
    if args.only in ("dygraph_train", "seq2seq", "optimizers"):
        t0 = time.perf_counter()
        out = {"dygraph_train": phase_dygraph_train, "seq2seq": phase_seq2seq,
               "optimizers": lambda _: phase_optimizers()}[args.only](smi)
        wall = time.perf_counter() - t0
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"gpu": smi, args.only: out}, f, indent=1,
                          default=float)
        print(json.dumps({"probe": args.only,
                          "launches": out.get("launches"),
                          "wall_s": wall}))
        return 0
    if args.only == "ps_train":
        cfg = _gpt_cfg()
        feed = _train_feed(cfg, TRAIN_BATCH, cfg.max_pos)
        one, one_s, peak, held, w0, _ = _one_device_run(
            cfg, cfg.max_pos, feed, DP_STEPS + 1)
        out = phase_ps_train(smi, {
            "single_losses": [x.tolist() for x in one],
            "weights_digest": w0, "feed": feed, "single_peak_bytes": peak,
            "single_held_bytes": held,
            "single_step_ms": 1e3 * float(np.mean(one_s[1:]))})
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"gpu": smi, "ps_train": out}, f, indent=1,
                          default=float)
        print(json.dumps({"probe": "ps_train", "launches": out["launches"],
                          "wall_s": out["wall_s"]}))
        return 0
    worst = phase_kernel(built)
    worst.update(phase_kernel_bf16(built))
    ring_kernel = phase_ring_kernel()
    worst.update(ring_kernel["worst"])
    serve = phase_serve()
    decode = phase_decode(serve, args.profile)
    train = phase_train()
    dp_train = phase_dp_train(smi, train)
    gspmd_train = phase_gspmd_train(smi, dp_train)
    pipe_train = phase_pipe_train(smi, dp_train)
    moe_train = phase_moe_train(smi)
    ps_train = phase_ps_train(smi, dp_train)
    dygraph_train = phase_dygraph_train(smi)
    gang_train = phase_gang_train(smi, dp_train)
    preempt = phase_preempt_train(train)
    amp_train = phase_amp_train(train)
    fused = phase_fused_train()
    amp_fused = phase_amp_train(train, fused=True)
    resnet = phase_resnet()
    predict = phase_predict(smi, serve, resnet)
    amp_resnet = phase_amp_resnet()
    rn50_fused = phase_rn50_fused()
    ceiling = phase_attn_ceiling()
    ring_train = phase_ring_train(args.profile)
    bert = phase_bert_train(args.profile)
    bert_masked = phase_bert_masked()
    wmt = phase_transformer_wmt()
    se = phase_se_resnext()
    recompute = phase_recompute_train()
    seq2seq = phase_seq2seq(smi)
    optimizers = phase_optimizers()
    observe_train = phase_observe_train(smi, train)
    observe_resnet = phase_observe_resnet(smi)
    observe_serve = phase_observe_serve(smi, serve)
    numerics = phase_numerics(smi)
    serve_plane = phase_serve_plane(smi, serve)
    serve_fleet = phase_serve_fleet(smi, serve, decode)
    timing = phase_timing(smi, serve, train)
    timing["conv1x1_stats"] = timing_k3(smi, resnet)
    timing.update(timing_k45(smi, train, fused))
    timing.update(timing_k68(smi))
    timing.update(timing_bf16(smi, amp_train, amp_fused, amp_resnet))
    timing.update(timing_ring(smi, ring_train))
    timing.update(timing_dropout(smi, bert, wmt, se))
    ring_times = timing.pop("ring")
    k3_shapes = timing["conv1x1_stats"].pop("per_shape")
    k3_bf16_shapes = timing["conv1x1_stats_bf16"].pop("per_shape")
    k6_calls = timing["matmul_bn_stats"].pop("per_call")
    prof = None
    if args.profile:
        prof = {"serve": phase_profile(serve),
                "train": phase_train_profile(train),
                "amp_train": phase_train_profile(amp_train, "AMP "),
                "resnet": phase_resnet_profile(resnet),
                "amp_resnet": phase_resnet_profile(
                    amp_resnet, "AMP ", AMP_BATCH_RESNET),
                **{f"ring_train_{impl}": ring_train[impl]["profile"]
                   for impl in ("ring", "flash")},
                "bert_train": bert["profile"]}
    by_path = {"flash_attn_fwd": {"serve": serve["launches"],
                                  "train": train["launches"]["flash_attn_fwd"],
                                  "fused_train":
                                  fused["launches"]["flash_attn_fwd"],
                                  "predict": predict["launches"]},
               "flash_attn_bwd": {"train":
                                  train["launches"]["flash_attn_bwd"],
                                  "fused_train":
                                  fused["launches"]["flash_attn_bwd"]},
               "conv1x1_stats": {"resnet": resnet["launches"],
                                 "conv_bn_train_pass":
                                 predict["train_pass_launches"]},
               "matmul_bn_stats": {"rn50_fused": rn50_fused["launches"]}}
    for name in ("layer_norm_fwd", "layer_norm_bwd", "dense_epilogue"):
        by_path[name] = {"fused_train": fused["launches"][name]}
    for name in ("attn_skeleton_fwd", "attn_skeleton_bwd", "flash_attn_fwd",
                 "flash_attn_bwd"):
        by_path.setdefault(name, {})["attn_ceiling"] = \
            ceiling["launches"][name]
    # the bf16 forms, launched by the AMP paths
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        by_path[name + "_bf16"] = {
            "amp_train": amp_train["launches"][name + "_bf16"],
            "amp_fused_train": amp_fused["launches"][name + "_bf16"]}
    for name in ("layer_norm_fwd", "layer_norm_bwd", "dense_epilogue"):
        by_path[name + "_bf16"] = {
            "amp_fused_train": amp_fused["launches"][name + "_bf16"]}
    by_path["conv1x1_stats_bf16"] = {"amp_resnet": amp_resnet["launches"]}
    # the ring's paths: ring_kernel runs both dtypes, ring_train (AMP) bf16
    for name in ("flash_attn_fwd", "flash_attn_bwd", "ring_merge"):
        for dtype, tag in (("float32", ""), ("bfloat16", "_bf16")):
            by_path.setdefault(name + tag, {}).update(
                ring_kernel=ring_kernel["launches"][dtype][name],
                ring_train=ring_train["ring"]["launches"][dtype][name])
    # the dropout kernel: float32 on se_resnext, bf16 on the AMP paths
    by_path["dropout"] = {"se_resnext": se["launches"]["dropout"]}
    by_path["dropout_bf16"] = {
        "bert_train": bert["launches"]["dropout_bfloat16"],
        "bert_masked": bert_masked["launches"]["dropout_bf16"],
        "transformer_wmt": wmt["launches"]["dropout_bf16"]}
    for name in ("dense_epilogue", "layer_norm_fwd", "layer_norm_bwd"):
        by_path[name + "_bf16"]["bert_train"] = \
            bert["launches"][name + "_bf16"]
    # recompute_train: (a) and (b), the recomputed chains' launches included
    for name, key in (("dense_epilogue_bf16", "dense_epilogue_bf16"),
                      ("layer_norm_fwd_bf16", "layer_norm_fwd_bf16"),
                      ("layer_norm_bwd_bf16", "layer_norm_bwd_bf16"),
                      ("dropout_bf16", "dropout_bfloat16")):
        for k in ("a", "b"):
            by_path[name][f"recompute_train_{k}"] = \
                recompute[k]["launches"][key]
    # preempt_train: the float32 K1/K2 of its four child processes
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        by_path[name]["preempt_train"] = preempt["launches"][name]
    # the time and memory planes' paths: the sampled window's steps
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        by_path[name]["observe_train"] = observe_train["launches"][name]
    by_path["conv1x1_stats"]["observe_resnet"] = observe_resnet["launches"]
    by_path["flash_attn_fwd"]["observe_serve"] = observe_serve["launches"]
    # the numerics and serving planes' paths
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        by_path[name]["numerics"] = numerics["launches"][name]
    by_path["flash_attn_fwd"]["serve_plane"] = serve_plane["launches"]
    # collective data parallelism: dp 4 virtual ranks, (a) and (b)
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        by_path[name]["dp_train"] = dp_train["launches"][name]
        by_path[name]["dp_train_dgc"] = dp_train["dgc_launches"][name]
        by_path[name]["gspmd_train"] = gspmd_train["launches"][name]
    # pipeline: (a) four stages, (b) two stages on two ranks each
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        by_path[name]["pipe_train"] = pipe_train["a"]["launches"][name]
        by_path[name]["pipe_train_b"] = pipe_train["b"]["launches"][name]
    # several processes: the two ranks' steps, the ring across them, and
    # the elastic drill's children (each child's own counts)
    for path, counts in gang_train["launches"].items():
        for name, n in counts.items():
            by_path[name][path] = n
    # the serving fleet: in process, and the replica processes' own counts
    by_path["flash_attn_fwd"]["serve_fleet"] = serve_fleet["launches"]
    by_path["flash_attn_fwd"]["serve_fleet_replicas"] = \
        serve_fleet["replica_launches"]
    # mixture of experts: no kernel runs on its path
    for name in by_path:
        by_path[name]["moe_train"] = moe_train["launches"].get(name, 0)
    # the parameter server: (b)'s GPT steps and (a)'s DeepFM trainers
    for name, n in ps_train["launches"].items():
        by_path[name]["ps_train"] = n
    # dygraph: (b)'s traced attention (the ResNet runs no kernel)
    for name, n in dygraph_train["launches"].items():
        by_path[name]["dygraph_train"] = n
    # control flow: the float32 dropout between the encoder's layers alone
    for name in by_path:
        by_path[name]["seq2seq"] = seq2seq["launches"].get(name, 0)
    missing = [n for n, paths in by_path.items() if not sum(paths.values())]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: "
                             f"{missing}")
    kernels = [dict(name=name, route="cuda", source=src, replaces=ref,
                    launches=sum(by_path[name].values()),
                    launches_by_path=by_path[name],
                    max_abs_err=worst[name], **timing[name])
               for name, src, ref in _KERNELS + tuple(
                   (n + "_bf16", src, ref)
                   for n, src, ref in _KERNELS if n in _BF16_FORMS)]
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"gpu": smi, "kernels": kernels, "profile": prof,
                       "conv1x1_stats_shapes": k3_shapes,
                       "conv1x1_stats_bf16_shapes": k3_bf16_shapes,
                       "matmul_bn_stats_calls": k6_calls,
                       "rn50_fused": rn50_fused, "attn_ceiling": ceiling,
                       "ring_kernel": ring_kernel, "ring_times": ring_times,
                       "ring_train": ring_train, "decode": decode,
                       "bert_train": bert, "bert_masked": bert_masked,
                       "transformer_wmt": wmt, "se_resnext": se,
                       "recompute_train": recompute, "seq2seq": seq2seq,
                       "optimizers": optimizers, "predict": predict,
                       "preempt_train": preempt,
                       "serve": {k: v for k, v in serve.items()
                                 if k not in ("scope", "factory")},
                       "train": {k: v for k, v in train.items()
                                 if k not in ("main", "loss", "scope",
                                              "feed", "exe")},
                       "observe_train": observe_train,
                       "dp_train": {k: v for k, v in dp_train.items()
                                    if k not in ("single_params", "feed",
                                                 "weights_digest")},
                       "gspmd_train": gspmd_train,
                       "pipe_train": pipe_train, "moe_train": moe_train,
                       "ps_train": ps_train,
                       "dygraph_train": dygraph_train,
                       "gang_train": gang_train,
                       "observe_resnet": observe_resnet,
                       "observe_serve": observe_serve,
                       "numerics": numerics, "serve_plane": serve_plane,
                       "serve_fleet": serve_fleet,
                       "fused_train": fused,
                       "resnet": {k: v for k, v in resnet.items()
                                  if k not in ("main", "fetch", "scope",
                                               "feed")},
                       **{name: {k: v for k, v in r.items()
                                 if k not in ("main", "loss", "fetch",
                                              "scope", "feed")}
                          for name, r in (("amp_train", amp_train),
                                          ("amp_fused_train", amp_fused),
                                          ("amp_resnet", amp_resnet))}},
                      f, indent=1, default=float)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
