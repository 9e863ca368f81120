"""Miscellaneous op lowerings (the subset of ``paddle_tpu/ops/misc_ops.py``
the recompute transform and the dygraph ``TreeConv`` need).

``optimization_barrier`` (ref ``misc_ops.py:213-219``) is XLA's CSE fence:
the recompute transform (``framework/recompute.py``) reads every stored
value entering a recomputed chain through one, so the compiler cannot merge
the recomputation back into the original.  Eager torch has no CSE, so here
the op is an identity that hands back its input tensor (no copy); it keeps
its type and names so both packages build the same program.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from .common import X


@register_op("optimization_barrier", no_grad=True)
def _optimization_barrier(ctx, ins, attrs):
    return {"Out": [X(ins, "X")]}


@register_op("tree_conv")
def _tree_conv(ctx, ins, attrs):
    """Tree-based convolution (ref ``misc_ops.py:144``, tree_conv_op.cc and
    math/tree2col.cc).  ``NodesVector [b, n, f]``, ``EdgeSet [b, e, 2]``
    parent -> child edges (1-based, 0 pads), ``Filter [f, 3, out, m]``:
    a node's patch is itself (the top slice) and its direct children,
    weighted left / right by their ordinal among their siblings."""
    nodes, edges, filt = X(ins, "NodesVector"), X(ins, "EdgeSet"), \
        X(ins, "Filter")
    _, _, out_c, m = filt.shape
    b, n, _ = nodes.shape
    e = edges.shape[1]
    parent, child = edges[..., 0].long(), edges[..., 1].long()
    valid = (parent > 0).to(nodes.dtype)              # [b, e]
    p0 = (parent - 1).clamp(min=0)
    c0 = (child - 1).clamp(min=0)
    nchild = torch.zeros((b, n), dtype=nodes.dtype,
                         device=nodes.device).scatter_add(1, p0, valid)
    nc_per_edge = torch.gather(nchild, 1, p0)         # [b, e]
    # an edge's ordinal among its siblings: the earlier valid edges of its
    # parent
    earlier = torch.tril(torch.ones(e, e, dtype=torch.bool,
                                    device=nodes.device), -1)
    same = (p0[:, :, None] == p0[:, None, :]) & earlier
    sib_idx = (same.to(nodes.dtype) * valid[:, None, :]).sum(dim=2)
    denom = (nc_per_edge - 1.0).clamp(min=1.0)
    eta_r = torch.where(nc_per_edge > 1, sib_idx / denom,
                        torch.full_like(sib_idx, 0.5)) * valid
    eta_l = (1.0 - eta_r) * valid
    child_feat = torch.gather(nodes, 1, c0[..., None].expand(
        b, e, nodes.shape[2]))                        # [b, e, f]
    wt, wl, wr = filt[:, 0], filt[:, 1], filt[:, 2]   # [f, out, m]
    top = torch.einsum("bnf,fom->bnom", nodes, wt)
    side = torch.einsum("bef,fom->beom", child_feat * eta_l[..., None], wl) \
        + torch.einsum("bef,fom->beom", child_feat * eta_r[..., None], wr)
    agg = torch.zeros((b, n, out_c, m), dtype=nodes.dtype,
                      device=nodes.device).scatter_add(
        1, p0[:, :, None, None].expand(b, e, out_c, m), side)
    # no activation here: the layer applies it after the bias
    return {"Out": [top + agg]}
