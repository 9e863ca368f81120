"""Cost-guided, training-safe graph fusion over the ``framework.ir`` Graph
(the port's ``paddle_tpu/analysis/fusion.py``).

The executor runs this pass on every plain Program before it builds a
plan, and ``CompiledProgram._optimized`` runs it between dead-op
elimination and ``fuse_elewise_add_act_pass``, both at the real feed batch.
Its decisions are the reference's:

1. **Match** candidates with ``PDPattern``/``GraphPatternDetector``:

   ======================  =================================  ================
   pattern                 subgraph                           fused op
   ======================  =================================  ================
   conv_bn_relu            conv2d(1x1) + batch_norm(train)    fused_conv1x1_bn
                           [+ relu]
   dense_epilogue          mul/matmul + bias add +            fused_dense_act
                           gelu/relu [+ tagged dropout]
   embedding_layer_norm    lookup_table [+ adds] +            fused_embedding_
                           layer_norm                         layer_norm
   ======================  =================================  ================

2. **Prove each match legal for training**: every internal var is
   single-consumer, not fetched, not persistable, not referenced by a
   control-flow sub-block, and alias-safe under the in-place pairs of
   ``buffer_shared_inplace_pass``; in a program with grad ops the forward
   rewrite comes with the matching grad-chain rewrite (the chain's grad
   ops become the fused op's generic grad op) or the candidate is
   rejected, with the failing rule.

3. **Rank survivors by the cost model's per-class shares**
   (``analysis.cost``): a candidate whose op class is below
   ``FLAGS_fusion_rank_threshold`` of the step's flops and bytes is
   "ranked_out".

4. **Autotune** (``FLAGS_fusion_autotune``): replay the matched chain and
   the fused op with its kernel (``use_pallas``) through the port's
   lowerings on the executor's device, best of 3 after a warm call, and
   apply the rewrite only where the fused op wins.  Verdicts are cached
   on (pattern, shapes, batch, device name x count) in memory and in
   ``<FLAGS_xla_compile_cache_dir>/fusion_autotune.json``.  With autotune
   off (the default) the pass applies on legality and rank alone, and the
   fused ops run the exact float32 composition.

Safety rails: the verifier runs before and after the pass, the collective
fingerprint must be unchanged by the rewrite (a changed one rolls it back),
and every decision is counted in
``paddle_tpu_fusion_candidates_total{pattern,verdict}``.
``FLAGS_graph_fusion`` (default on) is the master gate, and the executor
keys its plans on :func:`config_token`.  Three differences from the
reference: on a card each timed round is 5 runs timed by CUDA events on the
card alone (the reference times one dispatch of a jitted chain on the host
clock; see :func:`_time_chain`), a kernel that fails while it is timed
raises (the reference falls back to rank alone), and pre-device-key cache
files are not migrated (the port never wrote any).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from .. import monitor as _monitor
from ..framework.core import Block, Program, grad_var_name
from ..framework.recompute import (RECOMPUTE_SUFFIX, dead_barriers,
                                   source_name)

__all__ = ["FusionDecision", "FusionReport", "analyze_program",
           "clear_cache", "config_token", "fuse_program"]

_CAND_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_fusion_candidates_total",
    "graph-fusion candidate decisions by pattern and verdict "
    "(applied / rejected / ranked_out / autotune_lost / overlapped / "
    "verify_failed)", ("pattern", "verdict"))
_AUTOTUNE_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_fusion_autotune_total",
    "fusion autotune micro-benchmark lookups by cache outcome",
    ("cache",))
_AUTOTUNE_HIT = _AUTOTUNE_CTR.labels(cache="hit")
_AUTOTUNE_MISS = _AUTOTUNE_CTR.labels(cache="miss")

#: collective op prefixes fusion must never touch
_COLLECTIVE_PREFIX = "c_"

#: activations the dense epilogue folds
_DENSE_ACTS = ("gelu", "relu")


def config_token() -> tuple:
    """The fusion configuration visible to cache keys: plans keyed on it
    are invalidated by any fusion-flag change."""
    from ..flags import get_flags
    fl = get_flags(["FLAGS_graph_fusion", "FLAGS_fusion_autotune",
                    "FLAGS_fusion_rank_threshold"])
    return (bool(fl["FLAGS_graph_fusion"]),
            bool(fl["FLAGS_fusion_autotune"]),
            float(fl["FLAGS_fusion_rank_threshold"]))


@dataclass
class FusionDecision:
    """One candidate's fate."""

    pattern: str
    anchor: str                 # the chain's output var
    verdict: str                # applied|rejected|ranked_out|...
    rule: Optional[str] = None  # failing legality rule for 'rejected'
    rank: float = 0.0           # per-class cost share in [0, 1]
    autotune: Optional[dict] = None   # {base_ms, fused_ms, win, cached}

    def as_dict(self) -> dict:
        out = {"pattern": self.pattern, "anchor": self.anchor,
               "verdict": self.verdict, "rank": round(self.rank, 4)}
        if self.rule:
            out["rule"] = self.rule
        if self.autotune:
            out["autotune"] = dict(self.autotune)
        return out


@dataclass
class FusionReport:
    decisions: List[FusionDecision] = field(default_factory=list)
    applied: int = 0
    collective_fingerprint_ok: bool = True

    def by_verdict(self, verdict: str) -> List[FusionDecision]:
        return [d for d in self.decisions if d.verdict == verdict]

    def as_dict(self) -> dict:
        return {"applied": self.applied,
                "collective_fingerprint_ok":
                    self.collective_fingerprint_ok,
                "candidates": [d.as_dict() for d in self.decisions]}


# ---------------------------------------------------------------------------
# candidate model
# ---------------------------------------------------------------------------

class _Candidate:
    """One matched subgraph: ``fwd_ops``/``grad_ops`` are the op nodes the
    rewrite removes, ``internal`` the var nodes that disappear with them
    (``dead_outputs``: side outputs that die), ``build(graph, use_pallas)``
    applies the forward and grad rewrite.  ``base_descs``/``fused_descs``
    are the (type, inputs, outputs, attrs) descs the autotuner replays, and
    ``ext_inputs`` maps the chain's external inputs to (shape, dtype)."""

    def __init__(self, pattern: str, op_class: str, anchor: str):
        self.pattern = pattern
        self.op_class = op_class
        self.anchor = anchor
        self.fwd_ops: List = []
        self.grad_ops: List = []
        self.internal: List = []
        self.grad_internal: List = []
        self.dead_outputs: List = []
        self.reject_rule: Optional[str] = None   # structural pre-reject
        self.build = None               # set by the matcher when legal
        self.base_descs: List[tuple] = []
        self.fused_descs: List[tuple] = []
        self.ext_inputs: Dict[str, tuple] = {}
        self.shape_key: tuple = ()
        self.amp = False                # the program's AMP regime

    def all_ops(self) -> List:
        return self.fwd_ops + self.grad_ops


def _desc(op) -> tuple:
    """The autotuner's replay desc of one Operator."""
    return (op.type,
            {s: list(n) for s, n in op.inputs.items()},
            {s: list(n) for s, n in op.outputs.items()},
            dict(op.attrs))


def _has_grad_ops(program: Program) -> bool:
    return any(op.type.endswith("_grad")
               for op in program.global_block().ops)


def _node_by_name(op_node, name):
    return next((v for v in op_node.inputs if v.name == name), None)


def _fwd_consumers(var_node):
    """A var's forward consumers: grad ops re-read forward values
    (``X$<slot>`` inputs), and legality checks those separately."""
    return [c for c in var_node.outputs if not c.name.endswith("_grad")]


def _out_node_by_name(op_node, name):
    return next((v for v in op_node.outputs if v.name == name), None)


def _grad_of(name: str) -> str:
    """The gradient name the backward carries for a forward value: a
    recomputed clone's ``v@RECOMPUTE`` carries ``v``'s (``v@GRAD``)."""
    return grad_var_name(source_name(name))


def _cloned(program, name: str) -> bool:
    """Whether the recompute transform cloned the op writing ``name``:
    the backward then reads the clone, whose candidate takes the grad
    chain."""
    block = program.global_block()
    return block.has_var(name + RECOMPUTE_SUFFIX) or \
        block.has_var(name + RECOMPUTE_SUFFIX + "@DEAD")


def _grad_consumer(graph, grad_name: str, type_: str, slot: str):
    """The op node of ``type_`` whose ``slot`` input is ``grad_name``:
    how the backward chain is walked."""
    for n in graph.op_nodes:
        if n.name != type_:
            continue
        names = n.op.input(slot)
        if names and names[0] == grad_name:
            return n
    return None


# ---------------------------------------------------------------------------
# pattern matchers
# ---------------------------------------------------------------------------

def _match_conv_bn_relu(graph, program, fetch_names) -> List[_Candidate]:
    """conv2d + batch_norm(train) [+ relu] → ``fused_conv1x1_bn``.

    The spine matches via PDPattern; the fused kernel's limits (1x1,
    square stride, no padding, dilation or groups, NCHW, no bias) are
    legality rules, so near-misses show in the report."""
    from ..framework import ir

    pat = ir.PDPattern()
    conv = pat.new_op("conv2d")
    conv_out = pat.new_var("conv_out").as_intermediate()
    bn = pat.new_op("batch_norm")
    pat.link(conv, conv_out)
    pat.link(conv_out, bn)
    cands = []
    for m in ir.GraphPatternDetector(pat)(graph):
        conv_n, bn_n, cout_n = m[conv], m[bn], m[conv_out]
        y_node = next((v for v in bn_n.outputs
                       if v.name in bn_n.op.output("Y")), None)
        if y_node is None:
            continue
        cand = _Candidate("conv_bn_relu", "conv", anchor=y_node.name)
        cand.fwd_ops = [conv_n, bn_n]
        cand.internal = [cout_n]
        a = bn_n.op.attrs
        ca = conv_n.op.attrs
        strides = ca.get("strides", [1, 1])
        w_node = ir._input_node(conv_n, "Filter")
        x_node = ir._input_node(conv_n, "Input")
        wshape = getattr(getattr(w_node, "var", None), "shape", None) \
            if w_node is not None else None
        if a.get("is_test") or a.get("use_global_stats") or \
                a.get("data_layout", "NCHW") != "NCHW":
            cand.reject_rule = "bn_mode_unsupported"
        elif ca.get("groups", 1) != 1 or \
                any(p != 0 for p in ca.get("paddings", [0, 0])) or \
                any(d != 1 for d in ca.get("dilations", [1, 1])) or \
                strides[0] != strides[1] or conv_n.op.input("Bias"):
            cand.reject_rule = "kernel_unsupported"
        elif not wshape or len(wshape) != 4 or wshape[2] != 1 or \
                wshape[3] != 1:
            cand.reject_rule = "kernel_unsupported"
        elif w_node is None or x_node is None:
            cand.reject_rule = "kernel_unsupported"
        cands.append(cand)
        if cand.reject_rule:
            continue
        # an exclusive relu tail folds into the fused act
        out_node, relu_n = y_node, None
        y_fwd = _fwd_consumers(y_node)
        if len(y_fwd) == 1 and y_fwd[0].is_op("relu") \
                and y_node.name not in fetch_names:
            relu_n = y_fwd[0]
            cand.fwd_ops.append(relu_n)
            cand.internal.append(y_node)
            out_node = relu_n.outputs[0]
        cand.anchor = out_node.name
        by_name = {v.name: v for v in bn_n.inputs}

        def bn_in(slot):
            names = bn_n.op.input(slot)
            return by_name.get(names[0]) if names else None

        scale_n, bias_n = bn_in("Scale"), bn_in("Bias")
        mean_n, var_n = bn_in("Mean"), bn_in("Variance")
        if None in (scale_n, bias_n, mean_n, var_n):
            cand.reject_rule = "kernel_unsupported"
            continue
        fused_attrs = {"momentum": a.get("momentum", 0.9),
                       "epsilon": a.get("epsilon", 1e-5),
                       "act": "relu" if relu_n is not None else "",
                       "stride": int(strides[0]),
                       "is_test": False, "use_global_stats": False}
        outs = {"Y": [out_node]}
        for slot in ("MeanOut", "VarianceOut", "SavedMean",
                     "SavedVariance"):
            names = bn_n.op.output(slot)
            node = next((v for v in bn_n.outputs if names and
                         v.name in names), None)
            if node is not None:
                outs[slot] = [node]
        ins = {"X": [x_node], "Filter": [w_node], "Scale": [scale_n],
               "Bias": [bias_n], "Mean": [mean_n], "Variance": [var_n]}

        _finish_candidate(
            graph, program, cand,
            fused_type="fused_conv1x1_bn",
            fused_ins=ins, fused_outs=outs, fused_attrs=fused_attrs,
            out_node=out_node, og_slot_name="Y",
            grad_chain=_conv_bn_grad_chain(graph, conv_n, bn_n, relu_n,
                                           out_node),
            grad_ig={"X": ("conv2d_grad", "IG$Input"),
                     "Filter": ("conv2d_grad", "IG$Filter"),
                     "Scale": ("batch_norm_explicit_grad", "IG$Scale"),
                     "Bias": ("batch_norm_explicit_grad", "IG$Bias")})
    return cands


def _conv_bn_grad_chain(graph, conv_n, bn_n, relu_n, out_node):
    """The relu_grad → batch_norm_explicit_grad → conv2d_grad chain of
    one matched forward, or None when absent."""
    chain = []
    g = _grad_of(out_node.name)
    if relu_n is not None:
        rg = _grad_consumer(graph, g, "relu_grad", "OG$Out")
        if rg is None or rg.op.attrs.get("__fwd_type__") != "relu":
            return None
        chain.append(rg)
        igx = rg.op.output("IG$X")
        if not igx or not igx[0]:
            return None
        g = igx[0]
    bg = _grad_consumer(graph, g, "batch_norm_explicit_grad", "OG$Y")
    if bg is None:
        return None
    chain.append(bg)
    igx = bg.op.output("IG$X")
    if not igx or not igx[0]:
        return None
    cg = _grad_consumer(graph, igx[0], "conv2d_grad", "OG$Output")
    if cg is None or cg.op.attrs.get("__fwd_type__") != "conv2d":
        return None
    chain.append(cg)
    return chain


def _match_dense_epilogue(graph, program, fetch_names) -> List[_Candidate]:
    """mul/matmul + elementwise_add(bias) + gelu/relu [+ tagged dropout]
    → ``fused_dense_act`` (``paddle_tpu/analysis/fusion.py:357``)."""
    from ..framework import ir

    cands = []
    for mm_type in ("mul", "matmul"):
        pat = ir.PDPattern()
        mm = pat.new_op(mm_type)
        mm_out = pat.new_var("mm_out").as_intermediate()
        add = pat.new_op("elementwise_add")
        bias = pat.new_var("bias", persistable=True)
        add_out = pat.new_var("add_out").as_intermediate()
        pat.link(mm, mm_out)
        pat.link(mm_out, add)
        pat.link(bias, add)
        pat.link(add, add_out)
        for m in ir.GraphPatternDetector(pat)(graph):
            mm_n, add_n = m[mm], m[add]
            mm_out_n, add_out_n, bias_n = m[mm_out], m[add_out], m[bias]
            # the detector links by edges only: the bias must be the add's
            # Y slot and the product its X
            if not add_n.op.input("Y") or \
                    add_n.op.input("Y")[0] != bias_n.name or \
                    add_n.op.input("X")[0] != mm_out_n.name:
                continue
            add_fwd = _fwd_consumers(add_out_n)
            if len(add_fwd) != 1 or add_fwd[0].name not in _DENSE_ACTS:
                continue
            act_n = add_fwd[0]
            act_out = act_n.outputs[0]
            cand = _Candidate("dense_epilogue", "matmul",
                              anchor=act_out.name)
            cand.fwd_ops = [mm_n, add_n, act_n]
            cand.internal = [mm_out_n, add_out_n]
            cands.append(cand)
            x_node = _node_by_name(mm_n, mm_n.op.input("X")[0])
            w_node = _node_by_name(mm_n, mm_n.op.input("Y")[0])
            ma = mm_n.op.attrs
            bshape = getattr(getattr(bias_n, "var", None), "shape", None)
            wshape = getattr(getattr(w_node, "var", None), "shape", None)
            if x_node is None or w_node is None or \
                    not w_node.persistable:
                cand.reject_rule = "kernel_unsupported"
            elif mm_type == "matmul" and (
                    ma.get("transpose_X") or ma.get("transpose_Y") or
                    ma.get("alpha", 1.0) != 1.0):
                cand.reject_rule = "kernel_unsupported"
            elif mm_type == "mul" and \
                    int(ma.get("y_num_col_dims", 1)) != 1:
                # the fused lowering reshapes W at y_num_col_dims=1
                cand.reject_rule = "kernel_unsupported"
            elif not bshape or len(bshape) != 1 or \
                    not wshape or len(wshape) != 2:
                # the fused lowering takes a 2-D [K, N] weight and a
                # per-feature bias
                cand.reject_rule = "kernel_unsupported"
            if cand.reject_rule:
                continue
            # the bias broadcasts over the last (feature) dim of the
            # flattened product: the add's axis must resolve to it and the
            # bias length must be the product's N
            out_rank = (int(ma.get("x_num_col_dims", 1)) + 1
                        if mm_type == "mul"
                        else len(getattr(getattr(x_node, "var", None),
                                         "shape", None) or ()) or None)
            axis = int(add_n.op.attrs.get("axis", -1))
            if out_rank is None or (axis != -1 and axis != out_rank - 1) \
                    or (bshape[0] not in (-1, None) and
                        wshape[-1] not in (-1, None) and
                        bshape[0] != wshape[-1]):
                cand.reject_rule = "kernel_unsupported"
                continue
            out_node = act_out
            drop_n = None
            # an exclusive TAGGED dropout tail folds in: the tag makes the
            # fused op regenerate the same mask; an untagged dropout
            # replays its stored mask and stays unfused
            act_fwd = _fwd_consumers(act_out)
            if len(act_fwd) == 1 and act_fwd[0].is_op("dropout") and \
                    act_out.name not in fetch_names and \
                    act_fwd[0].op.attrs.get("seed", 0):
                drop_n = act_fwd[0]
                cand.fwd_ops.append(drop_n)
                cand.internal.append(act_out)
                out_node = ir._output_node(drop_n, "Out")
                mask = ir._output_node(drop_n, "Mask")
                if out_node is None:
                    cand.reject_rule = "kernel_unsupported"
                    continue
                if mask is not None:
                    cand.dead_outputs.append(mask)
            cand.anchor = out_node.name
            da = drop_n.op.attrs if drop_n is not None else {}
            fused_attrs = {
                "x_num_col_dims": int(ma.get("x_num_col_dims", 1))
                if mm_type == "mul" else -1,
                "bias_axis": axis,
                "act": act_n.name,
                "approximate": bool(
                    act_n.op.attrs.get("approximate", False)),
                "dropout_prob": float(da.get("dropout_prob", 0.0)),
                "seed": int(da.get("seed", 0)),
                "is_test": bool(da.get("is_test", False)),
                "dropout_implementation":
                    str(da.get("dropout_implementation",
                               "downgrade_in_infer")),
                "use_pallas": False,
            }
            _finish_candidate(
                graph, program, cand,
                fused_type="fused_dense_act",
                fused_ins={"X": [x_node], "W": [w_node],
                           "Bias": [bias_n]},
                fused_outs={"Out": [out_node]},
                fused_attrs=fused_attrs,
                out_node=out_node, og_slot_name="Out",
                grad_chain=_dense_grad_chain(graph, mm_type, out_node,
                                             drop_n, act_n),
                grad_ig={"X": (mm_type + "_grad", "IG$X"),
                         "W": (mm_type + "_grad", "IG$Y"),
                         "Bias": ("elementwise_add_grad", "IG$Y")})
    return cands


def _dense_grad_chain(graph, mm_type, out_node, drop_n, act_n):
    """[dropout_grad →] act_grad → elementwise_add_grad → mm_grad of one
    matched forward (``fusion.py:507``), or None."""
    chain = []
    g = _grad_of(out_node.name)
    if drop_n is not None:
        dg = _grad_consumer(graph, g, "dropout_grad", "OutGrad")
        if dg is None or dg.op.input("Mask"):
            return None         # an untagged dropout replays its mask
        chain.append(dg)
        xg = dg.op.output("XGrad")
        if not xg or not xg[0]:
            return None
        g = xg[0]
    for type_, fwd_type in ((act_n.name + "_grad", act_n.name),
                            ("elementwise_add_grad", "elementwise_add"),
                            (mm_type + "_grad", mm_type)):
        gop = _grad_consumer(graph, g, type_, "OG$Out")
        if gop is None or gop.op.attrs.get("__fwd_type__") != fwd_type:
            return None
        chain.append(gop)
        igx = gop.op.output("IG$X")
        if fwd_type != mm_type and (not igx or not igx[0]):
            return None
        g = igx[0] if igx else ""
    return chain


def _match_embedding_layer_norm(graph, program,
                                fetch_names) -> List[_Candidate]:
    """lookup_table [+ elementwise_adds] + layer_norm →
    ``fused_embedding_layer_norm`` (``fusion.py:543``).  The BERT-shaped
    chain is ``emb + pos [+ sent] -> layer_norm``: the chain side must be
    each add's X slot with the default axis, and every collapsed
    intermediate is legality-checked like any other internal var."""
    from ..framework import ir

    cands = []
    for ln_n in graph.ops_of_type("layer_norm"):
        x_in = ir._input_node(ln_n, "X")
        if x_in is None:
            continue
        # walk the producer chain: up to 2 adds over the lookup output
        chain_ops: List = []          # adds, outermost first
        addends: List = []            # external addend var nodes
        internal: List = []
        cur = x_in
        lt_n = None
        for _ in range(3):
            if not cur.inputs:
                break
            p = cur.inputs[0]
            if p.is_op(("lookup_table", "lookup_table_v2")):
                lt_n = p
                internal.append(cur)
                break
            if p.is_op("elementwise_add") and \
                    int(p.op.attrs.get("axis", -1)) == -1:
                xn = _node_by_name(p, p.op.input("X")[0])
                yn = _node_by_name(p, p.op.input("Y")[0])
                if xn is None or yn is None:
                    break
                chain_ops.append(p)
                addends.append(yn)
                internal.append(cur)
                cur = xn
                continue
            break
        y_node = ir._output_node(ln_n, "Y")
        if lt_n is None or y_node is None:
            continue
        chain_ops.reverse()
        addends.reverse()
        cand = _Candidate("embedding_layer_norm", "embedding",
                          anchor=y_node.name)
        cand.fwd_ops = [lt_n] + chain_ops + [ln_n]
        cand.internal = list(internal)
        cands.append(cand)
        ids_n = ir._input_node(lt_n, "Ids")
        w_node = ir._input_node(lt_n, "W")
        scale_n = ir._input_node(ln_n, "Scale")
        bias_n = ir._input_node(ln_n, "Bias")
        la = lt_n.op.attrs
        if ids_n is None or w_node is None or not w_node.persistable:
            cand.reject_rule = "kernel_unsupported"
            continue
        if la.get("is_sparse") or la.get("is_distributed"):
            # sparse/PS tables lower through the parameter-server path
            cand.reject_rule = "distributed_table"
            continue
        fused_attrs = {
            "padding_idx": la.get("padding_idx", -1),
            "epsilon": ln_n.op.attrs.get("epsilon", 1e-5),
            "begin_norm_axis": ln_n.op.attrs.get("begin_norm_axis", 1),
            "use_pallas": False,
        }
        ins = {"Ids": [ids_n], "W": [w_node], "Addends": list(addends)}
        outs = {"Out": [y_node]}
        grad_ig = {"W": (lt_n.name + "_grad", "IG$W")}
        for slot, node in (("Scale", scale_n), ("Bias", bias_n)):
            if node is not None:
                ins[slot] = [node]
                grad_ig[slot] = ("layer_norm_grad", "IG$" + slot)
        for slot in ("Mean", "Variance"):
            node = ir._output_node(ln_n, slot)
            if node is not None:
                outs[slot] = [node]
        grad = _embedding_ln_grad_chain(graph, y_node, chain_ops, lt_n)
        _finish_candidate(
            graph, program, cand,
            fused_type="fused_embedding_layer_norm",
            fused_ins=ins, fused_outs=outs, fused_attrs=fused_attrs,
            out_node=y_node, og_slot_name="Out",
            grad_chain=grad[0] if grad else None, grad_ig=grad_ig,
            addend_grads=grad[1] if grad else None)
    return cands


def _embedding_ln_grad_chain(graph, y_node, chain_ops, lt_n):
    """(chain grad ops, per-addend grad names) for an embedding + LN
    match (``fusion.py:651``), or None.  The add grads' IG$Y outputs carry
    the external addends' gradients, which the fused grad op must keep
    producing ('' for an addend that takes none)."""
    lng = _grad_consumer(graph, _grad_of(y_node.name),
                         "layer_norm_grad", "OG$Y")
    if lng is None or lng.op.attrs.get("__fwd_type__") != "layer_norm":
        return None
    chain = [lng]
    igx = lng.op.output("IG$X")
    if not igx or not igx[0]:
        return None
    g = igx[0]
    addend_gnames = []
    for _ in chain_ops:
        ag = _grad_consumer(graph, g, "elementwise_add_grad", "OG$Out")
        if ag is None or \
                ag.op.attrs.get("__fwd_type__") != "elementwise_add":
            return None
        chain.append(ag)
        igy = ag.op.output("IG$Y")
        addend_gnames.append(igy[0] if igy else "")
        igx = ag.op.output("IG$X")
        if not igx or not igx[0]:
            return None
        g = igx[0]
    ltg = _grad_consumer(graph, g, lt_n.name + "_grad", "OG$Out")
    if ltg is None or ltg.op.attrs.get("__fwd_type__") != lt_n.name:
        return None
    chain.append(ltg)
    addend_gnames.reverse()
    return chain, addend_gnames


#: the matchers the pass runs, in order
_MATCHERS = (_match_conv_bn_relu, _match_dense_epilogue,
             _match_embedding_layer_norm)


# ---------------------------------------------------------------------------
# shared candidate finishing: grads, replay descs, the build closure
# ---------------------------------------------------------------------------

def _finish_candidate(graph, program, cand, *, fused_type, fused_ins,
                      fused_outs, fused_attrs, out_node, og_slot_name,
                      grad_chain, grad_ig, addend_grads=None):
    """Attach the grad chain, the autotuner's replay material and the
    ``build()`` closure to a matched candidate (``fusion.py:692``).
    ``grad_ig`` maps a fused input slot to (the original grad op type, its
    IG slot), which names the gradients the fused grad op must keep
    producing; ``addend_grads`` are the external addends' gradient names,
    in the addends' order."""
    if cand.reject_rule:
        return
    if _cloned(program, out_node.name):
        # a recomputed original: its clone takes the grad chain, and the
        # legality rules hold no grad op reads what the rewrite removes
        grad_chain = None
    elif _has_grad_ops(program) and not grad_chain:
        cand.reject_rule = "missing_grad_rewrite"
        return
    cand.grad_ops = list(grad_chain or ())
    adds = [n for n in cand.grad_ops if n.name == "elementwise_add_grad"]

    def addend_node(gname):
        return next((v for gop in adds
                     for v in [_out_node_by_name(gop, gname)]
                     if v is not None), None)

    if addend_grads and cand.grad_ops and any(
            gname and addend_node(gname) is None for gname in addend_grads):
        # an unresolvable name would leave the fused grad op's output
        # outside the graph's edges (topology could order its consumers
        # before it)
        cand.reject_rule = "missing_grad_rewrite"
        return
    # every gradient produced by one chain op and consumed only inside
    # the chain vanishes with it
    removed = {n.id for n in cand.grad_ops}
    cand.grad_internal = [v for gop in cand.grad_ops for v in gop.outputs
                          if v.outputs and
                          all(c.id in removed for c in v.outputs)]

    # autotune replay material: the chain's forward descs, the fused op's
    # desc, and the chain's external inputs with their shapes
    block = program.global_block()
    # the chains are timed in the regime the run will use: an AMP program
    # runs them through bf16 casts (the reference's fusion.py:735-739)
    cand.amp = bool(program._attrs.get("amp", False))
    cand.base_descs = [_desc(n.op) for n in cand.fwd_ops]
    cand.fused_descs = [(fused_type,
                         {s: [v.name for v in vs]
                          for s, vs in fused_ins.items()},
                         {s: [v.name for v in vs]
                          for s, vs in fused_outs.items()},
                         dict(fused_attrs))]
    internal_names = {v.name for v in cand.internal}
    ext = {}
    for v in (v for n in cand.fwd_ops for v in n.inputs):
        if v.name in internal_names or v.name in ext:
            continue
        var = v.var if v.var is not None else (
            block.var(v.name) if block.has_var(v.name) else None)
        if var is None or var.shape is None:
            ext = {}
            break
        ext[v.name] = (tuple(var.shape), str(var.dtype or "float32"))
    cand.ext_inputs = ext
    out_var = getattr(out_node, "var", None)
    # by source names: a recomputed chain and its clone share a verdict
    cand.shape_key = tuple(sorted(
        (source_name(n), s) for n, (s, _) in ext.items())) + (
        ("out", tuple(out_var.shape) if out_var is not None and
         out_var.shape else ()),)

    def build(g, use_pallas=False):
        attrs = dict(fused_attrs)
        if "use_pallas" in attrs:
            attrs["use_pallas"] = bool(use_pallas)
        fused_node = g.create_op_node(fused_type, inputs=fused_ins,
                                      outputs=fused_outs, attrs=attrs)
        doomed = list(cand.fwd_ops) + list(cand.internal) + \
            list(cand.dead_outputs)
        if cand.grad_ops:
            # the fused op's generic grad desc (X$/OG$/IG$), wired to the
            # original external gradient names so the accumulation and
            # optimizer ops downstream are untouched
            g_ins = {"X$" + slot: list(nodes)
                     for slot, nodes in fused_ins.items()}
            og_name = _grad_of(out_node.name)
            g_ins["OG$" + og_slot_name] = [next(
                (v for gop in cand.grad_ops
                 for v in [_node_by_name(gop, og_name)] if v is not None),
                None)]
            g_outs = {}
            by_type = {}
            for gop in cand.grad_ops:
                by_type.setdefault(gop.name, gop)
            for slot, (gtype, ig_slot) in grad_ig.items():
                gop = by_type.get(gtype)
                names = gop.op.output(ig_slot) if gop is not None else None
                if not names or not names[0]:
                    continue
                node = _out_node_by_name(gop, names[0])
                if node is not None:
                    g_outs["IG$" + slot] = [node]
            addend_nodes = [addend_node(gname) if gname else None
                            for gname in addend_grads or ()]
            if any(n is not None for n in addend_nodes):
                g_outs["IG$Addends"] = [n for n in addend_nodes
                                        if n is not None]
            g_attrs = dict(attrs)
            g_attrs["__fwd_type__"] = fused_type
            gnode = g.create_op_node(fused_type + "_grad", inputs=g_ins,
                                     outputs=g_outs, attrs=g_attrs)
            if any(n is None for n in addend_nodes):
                # positional alignment: the executor zips the generic
                # grad's per-addend gradients with the output NAME list,
                # so an addend without a gradient keeps its '' placeholder
                # (graph edges track only the real nodes, created above)
                gnode.op.outputs["IG$Addends"] = [
                    gname or "" for gname in addend_grads]
            doomed += list(cand.grad_ops) + list(cand.grad_internal)
        g.safe_remove_nodes(doomed)
        return fused_node, gnode if cand.grad_ops else None

    cand.build = build


# ---------------------------------------------------------------------------
# legality
# ---------------------------------------------------------------------------

#: rules worth a user-facing warning (a structural kernel limit is not: a
#: 3x3 conv missing the 1x1 kernel is expected, not a bug)
_WARN_RULES = frozenset({
    "fetched_internal", "multi_consumer", "persistable_internal",
    "subblock_ref", "missing_grad_rewrite", "alias_hazard",
})


def _legality(cand: _Candidate, program, fetch_names,
              alias_pairs) -> Optional[str]:
    """None when the candidate is provably training-safe, else the
    failing rule."""
    from ..framework.ir import _referenced_outside_block0
    if cand.reject_rule:
        return cand.reject_rule
    fetched = set(fetch_names)
    member_ids = {n.id for n in cand.all_ops()}
    member_ops = {id(n.op) for n in cand.all_ops()}
    for op_n in cand.all_ops():
        if op_n.name.startswith(_COLLECTIVE_PREFIX):
            return "collective"
        if any(isinstance(v, Block) for v in op_n.op.attrs.values()):
            return "subblock_op"
    for v in cand.internal + cand.grad_internal:
        if v.name in fetched:
            return "fetched_internal"
        if v.persistable:
            return "persistable_internal"
        if any(c.id not in member_ids for c in v.outputs):
            return "multi_consumer"
        if _referenced_outside_block0(program, v.name):
            return "subblock_ref"
        # an internal var sharing a buffer through an in-place pair whose
        # consumer op survives the rewrite cannot disappear
        for src, out, consumer_op in alias_pairs:
            if v.name in (src, out) and id(consumer_op) not in member_ops:
                return "alias_hazard"
    for v in cand.dead_outputs:
        if v.name in fetched:
            return "fetched_internal"
        if v.persistable:
            return "persistable_internal"
        if any(c.id not in member_ids for c in v.outputs):
            return "multi_consumer"
    return None


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------

_AUTOTUNE_MEM: Dict[str, dict] = {}     # guarded-by: _AUTOTUNE_LOCK
_AUTOTUNE_LOADED = [False]              # guarded-by: _AUTOTUNE_LOCK
_AUTOTUNE_LOCK = threading.Lock()


def _autotune_path() -> Optional[str]:
    from ..flags import get_flags
    d = get_flags("FLAGS_xla_compile_cache_dir")[
        "FLAGS_xla_compile_cache_dir"]
    return os.path.join(str(d), "fusion_autotune.json") if d else None


def _device_key(device=None) -> str:
    """The hardware a verdict was measured on, ``<name>x<count>``: e.g.
    ``NVIDIA_H100_80GB_HBM3x1`` for a card, ``cpux1`` for the host."""
    device = torch.device(device or "cpu")
    if device.type != "cuda":
        return f"{device.type}x1"
    name = torch.cuda.get_device_name(device).replace(" ", "_")
    return f"{name}x{torch.cuda.device_count()}"


def _autotune_load_locked():   # guarded-by-caller: _AUTOTUNE_LOCK
    if _AUTOTUNE_LOADED[0]:
        return
    _AUTOTUNE_LOADED[0] = True
    path = _autotune_path()
    if not path:
        return
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return
    if isinstance(data, dict):
        for k, v in data.items():
            if isinstance(v, dict):
                _AUTOTUNE_MEM.setdefault(k, v)


def _autotune_persist_locked():   # guarded-by-caller: _AUTOTUNE_LOCK
    path = _autotune_path()
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(_AUTOTUNE_MEM, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass          # a read-only cache dir must not fail the pass


def _fill_value(shape, dtype, batch: int, device):
    """A replay input: zeros for integer inputs (valid ids), 0.5 for
    floating ones (variance-like operands must survive rsqrt)."""
    rs = tuple(batch if d in (-1, None) else int(d) for d in shape)
    if "int" in str(dtype):
        return torch.zeros(rs, dtype=torch.int64, device=device)
    return torch.full(rs, 0.5, dtype=torch.float32, device=device)


def _replay(descs, env, ctx):
    """Run a straight-line chain of op descs through the registered
    lowerings on a value environment: the autotuner's harness for the base
    chain and the fused op alike.  Under AMP each op's inputs pass through
    ``amp.cast_ins`` as the executor casts them (the fused ops apply the
    policy themselves)."""
    from .. import amp as _amp
    from ..framework import registry as _reg
    for typ, ins_names, outs_names, attrs in descs:
        ins = {s: [env.get(n) for n in names]
               for s, names in ins_names.items()}
        if ctx.amp:
            ins = _amp.cast_ins(typ, ins)
        outs = _reg.get_op_info(typ).lower(ctx, ins, attrs) or {}
        for s, names in outs_names.items():
            for n, v in zip(names, outs.get(s, [])):
                if n:
                    env[n] = v


def _time_chain(descs, ext_vals, device, reps=3,
                amp=False) -> Tuple[float, int]:
    """``(ms a run, runs made)``, replayed under the AMP regime ``amp``:
    the best of ``reps`` timed rounds after a
    warm run (which builds any kernel).  On the host a round is one run on
    the host clock.  On a card a round is ``tools.timing.time_held``'s 5
    runs, timed on the card alone with CUDA events while the host
    enqueues them behind a hold kernel.  The reference times one jitted
    dispatch of the chain; the port replays it op by op, and a
    synchronized run of a sub-millisecond chain times the host's enqueue of
    each op instead (on an H100 the embedding-LayerNorm verdict flipped from
    run to run)."""
    from ..framework.executor import LowerCtx
    from ..tools import timing

    def run():
        _replay(descs, dict(ext_vals), LowerCtx(device, 0, amp))

    with torch.no_grad():
        run()
        runs, best = 1, float("inf")
        if device.type != "cuda":
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                best = min(best, time.perf_counter() - t0)
            return best * 1e3, runs + reps
        with torch.cuda.device(device):
            torch.cuda.synchronize(device)
            for _ in range(reps):
                sec, n = timing.time_held(run)
                best, runs = min(best, sec), runs + n
    return best * 1e3, runs


def _autotune(cand: _Candidate, batch: int, device) -> Optional[dict]:
    """Measured fused-vs-base verdict for one candidate, cached on
    (pattern, shape key, batch, device name x count, AMP regime: "amp" or
    "f32"); a miss's record also
    holds ``fused_runs``, the runs of the fused op it made.  None when the
    candidate cannot be replayed (unknown shapes): the caller then decides
    on rank alone."""
    if not cand.ext_inputs or not cand.base_descs:
        return None
    device = torch.device(device or "cpu")
    amp = cand.amp
    key = json.dumps([cand.pattern, cand.shape_key, batch,
                      _device_key(device), "amp" if amp else "f32"],
                     default=str)
    with _AUTOTUNE_LOCK:
        _autotune_load_locked()
        hit = _AUTOTUNE_MEM.get(key)
    if hit is not None:
        _AUTOTUNE_HIT.inc()
        return dict(hit, cached=True)
    _AUTOTUNE_MISS.inc()
    ext_vals = {n: _fill_value(s, d, batch, device)
                for n, (s, d) in cand.ext_inputs.items()}
    # the fused op is timed with its kernel
    fused_descs = [(t, i, o, dict(a, use_pallas=True)
                    if "use_pallas" in a else a)
                   for t, i, o, a in cand.fused_descs]
    base_ms, _ = _time_chain(cand.base_descs, ext_vals, device, amp=amp)
    fused_ms, fused_runs = _time_chain(fused_descs, ext_vals, device,
                                       amp=amp)
    rec = {"base_ms": round(base_ms, 4), "fused_ms": round(fused_ms, 4),
           "win": bool(fused_ms <= base_ms), "cached": False,
           "fused_runs": fused_runs}
    with _AUTOTUNE_LOCK:
        _AUTOTUNE_MEM[key] = {k: rec[k] for k in
                              ("base_ms", "fused_ms", "win")}
        _autotune_persist_locked()
    return rec


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

#: (fingerprint, fetches, config token, batch, device key) -> fused Program,
#: or None when the pass applied nothing; a bounded FIFO
_RESULT_CACHE: Dict[tuple, Optional[Program]] = {}  # guarded-by: _RESULT_LOCK
_RESULT_CAP = 64
_RESULT_LOCK = threading.Lock()

#: (fingerprint, token) pairs whose rejection warnings already fired
_WARNED: set = set()                    # guarded-by: _RESULT_LOCK


def clear_cache() -> None:
    with _RESULT_LOCK:
        _RESULT_CACHE.clear()
        _WARNED.clear()
    with _AUTOTUNE_LOCK:
        _AUTOTUNE_MEM.clear()
        _AUTOTUNE_LOADED[0] = False


def _fetch_tuple(fetch_names) -> tuple:
    return tuple(f.name if hasattr(f, "name") else f
                 for f in (fetch_names or ()))


def analyze_program(program: Program, fetch_names=(), batch_size: int = 1,
                    device=None) -> FusionReport:
    """The candidates, their legality verdicts, cost ranks and autotune
    verdicts (timed on ``device``, the host by default), with no rewrite
    applied and nothing cached."""
    _, report = _fuse(program, _fetch_tuple(fetch_names), batch_size,
                      dry_run=True, device=device)
    return report


def fuse_program(program: Program, fetch_names=(), feed_shapes=None,
                 device=None) -> Program:
    """The pass: the fused program (a new Program) when any candidate was
    applied and the result passed re-verification, else ``program``
    itself.  ``device`` is where the program will run, and where the
    autotuner times its candidates (the host by default).  Cached on
    (fingerprint, fetches, config token, batch, device), so a repeat call
    is a dict probe."""
    from ..flags import get_flags
    if not get_flags("FLAGS_graph_fusion")["FLAGS_graph_fusion"]:
        return program
    fetch_names = _fetch_tuple(fetch_names)
    batch = _batch_of(feed_shapes)
    token = config_token()
    key = (program.fingerprint(), fetch_names, token, batch,
           _device_key(device))
    with _RESULT_LOCK:
        if key in _RESULT_CACHE:
            cached = _RESULT_CACHE[key]
            return cached if cached is not None else program
    fused, report = _fuse(program, fetch_names, batch, dry_run=False,
                          device=device)
    with _RESULT_LOCK:
        # concurrent first fusions of one program: only the insert winner
        # counts the decisions and warns
        won = key not in _RESULT_CACHE
        if won:
            if len(_RESULT_CACHE) >= _RESULT_CAP:
                _RESULT_CACHE.pop(next(iter(_RESULT_CACHE)))
            _RESULT_CACHE[key] = fused if fused is not program else None
        cached = _RESULT_CACHE[key]
        warn_key = (program.fingerprint(), token)
        do_warn = won and warn_key not in _WARNED
        if do_warn:
            if len(_WARNED) >= 4 * _RESULT_CAP:
                _WARNED.clear()
            _WARNED.add(warn_key)
    if not won:
        return cached if cached is not None else program
    _count_decisions(report)
    if do_warn:
        _warn_rejections(report)
    return fused


def _batch_of(feed_shapes) -> int:
    if feed_shapes:
        for shape in (feed_shapes.values()
                      if isinstance(feed_shapes, dict) else feed_shapes):
            if shape:
                return max(int(shape[0]), 1)
    return 1


def _warn_rejections(report: FusionReport) -> None:
    """One warning listing the rejections worth a user's attention."""
    from .verifier import Diagnostic
    diags = [
        Diagnostic("fusion_reject", "warning",
                   f"fusion candidate {d.pattern!r} at {d.anchor!r} "
                   f"rejected by legality rule {d.rule!r}",
                   var=d.anchor,
                   fix_hint="analysis.fusion.analyze_program shows the "
                            "full candidate report")
        for d in report.decisions
        if d.verdict == "rejected" and d.rule in _WARN_RULES]
    if diags:
        import warnings

        from .. import debugger
        warnings.warn("graph fusion rejections:\n"
                      + debugger.format_diagnostics(diags), stacklevel=3)


def _count_decisions(report: FusionReport) -> None:
    """Count each final verdict once per (program, config): called only by
    ``fuse_program``'s result-cache insert winner."""
    for dec in report.decisions:
        _CAND_CTR.inc(1, pattern=dec.pattern, verdict=dec.verdict)


def _fuse(program: Program, fetch_names, batch: int, dry_run: bool,
          device=None) -> Tuple[Program, FusionReport]:
    from ..flags import get_flags
    from ..framework import ir
    from . import cost as _cost
    from . import verifier as _verifier

    fl = get_flags(["FLAGS_fusion_autotune", "FLAGS_fusion_rank_threshold"])
    autotune_on = bool(fl["FLAGS_fusion_autotune"])
    threshold = float(fl["FLAGS_fusion_rank_threshold"])

    report = FusionReport()
    graph = ir.Graph(program)
    # a recomputed program's unread barriers would be consumers of the
    # original chains' values (the executor skips them)
    dead = {id(op) for op in dead_barriers(
        [n.op for n in graph.op_nodes], fetch_names)}
    graph.safe_remove_nodes([x for n in graph.op_nodes if id(n.op) in dead
                             for x in [n] + n.outputs])
    candidates: List[_Candidate] = []
    for matcher in _MATCHERS:
        candidates.extend(matcher(graph, program, fetch_names))
    if not candidates:
        return program, report

    # verify BEFORE the pass: fusion never applies to a broken program,
    # and the collective fingerprint anchors the invariance check
    pre = _verifier.verify_program(program, fetch_names)
    if not pre.ok:
        return program, report

    plan = _cost.plan_cost(program, fetch_names, batch_size=batch)
    fshare = plan.share()
    btotal = float(plan.bytes) or 1.0
    bshare = {c: b / btotal for c, b in plan.per_class_bytes.items()}
    alias_graph = ir.get_pass("buffer_shared_inplace_pass").apply(
        ir.Graph(program))
    # (src, out, consumer Operator): the pair and the op that would
    # compute in place, compared with candidate membership by identity
    alias_pairs = []
    for src, out in alias_graph.attrs.get("inplace_pairs", []):
        consumer = next(
            (op for op in program.global_block().ops
             if src in op.input_arg_names()
             and out in op.output_arg_names()), None)
        if consumer is not None:
            alias_pairs.append((src, out, consumer))

    def rank_of(c):
        return max(fshare.get(c.op_class, 0.0), bshare.get(c.op_class, 0.0))

    applied: List[Tuple[_Candidate, bool]] = []
    taken: set = set()
    for cand in sorted(candidates, key=rank_of, reverse=True):
        rank = rank_of(cand)
        dec = FusionDecision(cand.pattern, cand.anchor, verdict="",
                             rank=rank)
        report.decisions.append(dec)
        rule = _legality(cand, program, fetch_names, alias_pairs)
        if rule is not None:
            dec.verdict, dec.rule = "rejected", rule
            continue
        if any(n.id in taken for n in cand.all_ops()):
            dec.verdict = "overlapped"
            continue
        if rank < threshold:
            dec.verdict = "ranked_out"
            continue
        use_pallas = False
        if autotune_on:
            verdict = _autotune(cand, batch, device)
            if verdict is not None:
                dec.autotune = verdict
                if not verdict["win"]:
                    dec.verdict = "autotune_lost"
                    continue
                use_pallas = True
        dec.verdict = "applied"
        taken.update(n.id for n in cand.all_ops())
        applied.append((cand, use_pallas))

    if dry_run or not applied:
        report.applied = len(applied) if dry_run else 0
        if not dry_run:
            program._attrs["fusion"] = report.as_dict()
        return program, report

    for cand, use_pallas in applied:
        fwd_node, grad_node = cand.build(graph, use_pallas=use_pallas)
        # the rank ``to_program`` keeps for a recomputed program: the
        # forward where its last op ran, the grad where its first one did
        graph.rank[fwd_node.id] = max(graph.rank[n.id] for n in cand.fwd_ops)
        if grad_node is not None:
            graph.rank[grad_node.id] = min(graph.rank[n.id]
                                           for n in cand.grad_ops)
    fused = graph.to_program()
    report.applied = len(applied)

    # verify AFTER the pass: the fused program must be clean and its
    # collective fingerprint unchanged, or the rewrite rolls back whole
    post = _verifier.verify_program(fused, fetch_names)
    fp_ok = post.collective_fingerprint == pre.collective_fingerprint
    report.collective_fingerprint_ok = fp_ok
    if not post.ok or not fp_ok:
        for dec in report.decisions:
            if dec.verdict == "applied":
                dec.verdict = "verify_failed"
        report.applied = 0
        import warnings
        warnings.warn(
            "graph fusion rolled back: the fused program "
            + ("failed verification" if not post.ok
               else "changed the collective fingerprint")
            + " — running unfused", stacklevel=3)
        program._attrs["fusion"] = report.as_dict()
        return program, report
    fused._attrs["fusion"] = report.as_dict()
    return fused, report
