"""The fused attention ops (``paddle_tpu/ops/attention_ops.py``), run by the
port's CUDA kernels on the card and by their plain versions on the CPU.

- ``flash_attention`` (:23-35): single-device fused attention
  (``paddle_tpu_torch.kernels.flash_attention``).
- ``ring_attention`` (:38-64): the same contract, but when the current
  mesh (``paddle_tpu_torch.parallel``) has the op's ``axis_name`` axis
  (``sp``) with more than one rank, the sequence is sharded over it and the
  K/V shards rotate over the ring
  (``paddle_tpu_torch.kernels.ring_attention``; it raises when the mesh
  names devices of another type than the tensors'); otherwise it degrades
  to flash attention, so programs are portable across meshes.

The ``flash_attention`` op's ``block_q``/``block_k``/``bwd_impl`` attrs tune
the TPU kernel and are ignored here.
"""

from __future__ import annotations

from ..framework.registry import register_op
from .common import X


def _infer_flash(op, block):
    q = block.var(op.input("Q")[0])
    out = block.var(op.output("Out")[0])
    out.shape, out.dtype = q.shape, q.dtype


@register_op("flash_attention", infer=_infer_flash)
def _flash_attention(ctx, ins, attrs):
    from ..kernels.flash_attention import flash_attention
    q, k, v = X(ins, "Q"), X(ins, "K"), X(ins, "V")
    out = flash_attention(q, k, v, bias=X(ins, "Bias"),
                          causal=bool(attrs.get("causal", False)),
                          sm_scale=attrs.get("sm_scale") or None)
    return {"Out": [out]}


@register_op("ring_attention", infer=_infer_flash)
def _ring_attention(ctx, ins, attrs):
    from ..parallel.mesh import current_mesh
    q, k, v = X(ins, "Q"), X(ins, "K"), X(ins, "V")
    causal = bool(attrs.get("causal", False))
    sm_scale = attrs.get("sm_scale") or None
    axis = attrs.get("axis_name", "sp") or "sp"

    mesh = current_mesh()
    if mesh is not None and axis in mesh.axis_names and \
            mesh.shape[axis] > 1:
        from ..kernels.ring_attention import ring_attention
        return {"Out": [ring_attention(q, k, v, mesh, axis, causal=causal,
                                       sm_scale=sm_scale)]}

    from ..kernels.flash_attention import flash_attention
    return {"Out": [flash_attention(q, k, v, causal=causal,
                                    sm_scale=sm_scale)]}
