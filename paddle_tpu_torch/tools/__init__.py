"""Measurement tools of the port: CUDA-event timing and the card's peak
rates (:mod:`.timing`), the fused matmul + BN-statistics benchmark
(:mod:`.rn50_fused_bench`) and the attention-ceiling probe
(:mod:`.attn_shape_ceiling`)."""
