"""Cost-guided, training-safe graph fusion over the ``framework.ir`` Graph
(the port's ``paddle_tpu/analysis/fusion.py``).

The executor runs this pass on every plain Program before it builds a
plan, at the real feed batch.  Its decisions are the reference's:

1. **Match** candidates with ``PDPattern``/``GraphPatternDetector``.  The
   port has one matcher so far:

   ======================  =================================  ================
   pattern                 subgraph                           fused op
   ======================  =================================  ================
   conv_bn_relu            conv2d(1x1) + batch_norm(train)    fused_conv1x1_bn
                           [+ relu]
   ======================  =================================  ================

2. **Prove each match legal for training**: every internal var is
   single-consumer, not fetched, not persistable, not referenced by a
   control-flow sub-block, and alias-safe under the in-place pairs of
   ``buffer_shared_inplace_pass``; in a program with grad ops the forward
   rewrite comes with the matching grad-chain rewrite (relu_grad →
   batch_norm_explicit_grad → conv2d_grad become the fused op's generic
   grad op) or the candidate is rejected, with the failing rule.

3. **Rank survivors by the cost model's per-class shares**
   (``analysis.cost``): a candidate whose op class is below
   ``FLAGS_fusion_rank_threshold`` of the step's flops and bytes is
   "ranked_out".

``FLAGS_graph_fusion`` (default on) is the master gate, and the executor
keys its plans on :func:`config_token`.  Not ported yet: the
``dense_epilogue`` and ``embedding_layer_norm`` matchers (they come with
K4/K5), autotune (``FLAGS_fusion_autotune``: the pass raises when it is
on), the verifier run before and after the pass, and the decision
counters.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..framework.core import Block, Program

__all__ = ["FusionDecision", "FusionReport", "analyze_program",
           "config_token", "fuse_program"]

#: collective op prefixes fusion must never touch
_COLLECTIVE_PREFIX = "c_"


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
    verdict: str                # applied|rejected|ranked_out|overlapped
    rule: Optional[str] = None  # failing legality rule for 'rejected'
    rank: float = 0.0           # per-class cost share in [0, 1]

    def as_dict(self) -> dict:
        out = {"pattern": self.pattern, "anchor": self.anchor,
               "verdict": self.verdict, "rank": round(self.rank, 4)}
        if self.rule:
            out["rule"] = self.rule
        return out


@dataclass
class FusionReport:
    decisions: List[FusionDecision] = field(default_factory=list)
    applied: int = 0

    def as_dict(self) -> dict:
        return {"applied": self.applied,
                "candidates": [d.as_dict() for d in self.decisions]}


# ---------------------------------------------------------------------------
# candidate model
# ---------------------------------------------------------------------------

class _Candidate:
    """One matched subgraph: ``fwd_ops``/``grad_ops`` are the op nodes the
    rewrite removes, ``internal`` the var nodes that disappear with them,
    and ``build(graph)`` applies the forward and grad rewrite."""

    def __init__(self, pattern: str, op_class: str, anchor: str):
        self.pattern = pattern
        self.op_class = op_class
        self.anchor = anchor
        self.fwd_ops: List = []
        self.grad_ops: List = []
        self.internal: List = []
        self.grad_internal: List = []
        self.reject_rule: Optional[str] = None   # structural pre-reject
        self.build = None               # set by the matcher when legal

    def all_ops(self) -> List:
        return self.fwd_ops + self.grad_ops


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
    g = out_node.name + "@GRAD"
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


#: the matchers the pass runs, in order
_MATCHERS = (_match_conv_bn_relu,)


# ---------------------------------------------------------------------------
# shared candidate finishing: grads and the build closure
# ---------------------------------------------------------------------------

def _finish_candidate(graph, program, cand, *, fused_type, fused_ins,
                      fused_outs, fused_attrs, out_node, og_slot_name,
                      grad_chain, grad_ig):
    """Attach the grad chain and the ``build()`` closure to a matched
    candidate.  ``grad_ig`` maps a fused input slot to (the original grad
    op type, its IG slot), which names the gradients the fused grad op
    must keep producing."""
    if cand.reject_rule:
        return
    if _has_grad_ops(program) and not grad_chain:
        cand.reject_rule = "missing_grad_rewrite"
        return
    cand.grad_ops = list(grad_chain or ())
    # every gradient produced by one chain op and consumed only inside
    # the chain vanishes with it
    removed = {n.id for n in cand.grad_ops}
    cand.grad_internal = [v for gop in cand.grad_ops for v in gop.outputs
                          if v.outputs and
                          all(c.id in removed for c in v.outputs)]

    def build(g):
        fused_node = g.create_op_node(fused_type, inputs=fused_ins,
                                      outputs=fused_outs,
                                      attrs=dict(fused_attrs))
        doomed = list(cand.fwd_ops) + list(cand.internal)
        if cand.grad_ops:
            # the fused op's generic grad desc (X$/OG$/IG$), wired to the
            # original external gradient names so the accumulation and
            # optimizer ops downstream are untouched
            g_ins = {"X$" + slot: list(nodes)
                     for slot, nodes in fused_ins.items()}
            og_name = out_node.name + "@GRAD"
            og_node = None
            for gop in cand.grad_ops:
                og_node = _node_by_name(gop, og_name)
                if og_node is not None:
                    break
            g_ins["OG$" + og_slot_name] = [og_node]
            g_outs = {}
            by_type = {}
            for gop in cand.grad_ops:
                by_type.setdefault(gop.name, gop)
            for slot, (gtype, ig_slot) in grad_ig.items():
                gop = by_type.get(gtype)
                if gop is None:
                    continue
                names = gop.op.output(ig_slot)
                if not names or not names[0]:
                    continue
                node = _out_node_by_name(gop, names[0])
                if node is not None:
                    g_outs["IG$" + slot] = [node]
            g_attrs = dict(fused_attrs)
            g_attrs["__fwd_type__"] = fused_type
            g.create_op_node(fused_type + "_grad", inputs=g_ins,
                             outputs=g_outs, attrs=g_attrs)
            doomed += list(cand.grad_ops) + list(cand.grad_internal)
        g.safe_remove_nodes(doomed)
        return fused_node

    cand.build = build


# ---------------------------------------------------------------------------
# legality
# ---------------------------------------------------------------------------

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
    return None


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

#: (fingerprint, fetches, config token, batch) -> fused Program, or None
#: when the pass applied nothing; a bounded FIFO
_RESULT_CACHE: Dict[tuple, Optional[Program]] = {}  # guarded-by: _RESULT_LOCK
_RESULT_CAP = 64
_RESULT_LOCK = threading.Lock()


def analyze_program(program: Program, fetch_names=(),
                    batch_size: int = 1) -> FusionReport:
    """The candidates, their legality verdicts and cost ranks, with no
    rewrite applied and nothing cached."""
    fetch_names = tuple(
        f.name if hasattr(f, "name") else f for f in (fetch_names or ()))
    _, report = _fuse(program, fetch_names, batch_size, dry_run=True)
    return report


def fuse_program(program: Program, fetch_names=(),
                 feed_shapes=None) -> Program:
    """The pass: the fused program (a new Program) when any candidate was
    applied, else ``program`` itself.  Cached on (fingerprint, fetches,
    config token, batch), so a repeat call is a dict probe."""
    from ..flags import get_flags
    if not get_flags("FLAGS_graph_fusion")["FLAGS_graph_fusion"]:
        return program
    fetch_names = tuple(
        f.name if hasattr(f, "name") else f for f in (fetch_names or ()))
    batch = _batch_of(feed_shapes)
    key = (program.fingerprint(), fetch_names, config_token(), batch)
    with _RESULT_LOCK:
        if key in _RESULT_CACHE:
            cached = _RESULT_CACHE[key]
            return cached if cached is not None else program
    fused, _ = _fuse(program, fetch_names, batch, dry_run=False)
    with _RESULT_LOCK:
        if key not in _RESULT_CACHE:
            if len(_RESULT_CACHE) >= _RESULT_CAP:
                _RESULT_CACHE.pop(next(iter(_RESULT_CACHE)))
            _RESULT_CACHE[key] = fused if fused is not program else None
        cached = _RESULT_CACHE[key]
    return cached if cached is not None else program


def _batch_of(feed_shapes) -> int:
    if feed_shapes:
        for shape in (feed_shapes.values()
                      if isinstance(feed_shapes, dict) else feed_shapes):
            if shape:
                return max(int(shape[0]), 1)
    return 1


def _fuse(program: Program, fetch_names, batch: int,
          dry_run: bool) -> Tuple[Program, FusionReport]:
    from ..flags import get_flags
    from ..framework import ir
    from . import cost as _cost

    fl = get_flags(["FLAGS_fusion_autotune", "FLAGS_fusion_rank_threshold"])
    if fl["FLAGS_fusion_autotune"]:
        raise NotImplementedError(
            "FLAGS_fusion_autotune: the fusion autotuner is not ported; "
            "set the flag to False")
    threshold = float(fl["FLAGS_fusion_rank_threshold"])

    report = FusionReport()
    graph = ir.Graph(program)
    candidates: List[_Candidate] = []
    for matcher in _MATCHERS:
        candidates.extend(matcher(graph, program, fetch_names))
    if not candidates:
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

    applied: List[_Candidate] = []
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
        dec.verdict = "applied"
        taken.update(n.id for n in cand.all_ops())
        applied.append(cand)

    if dry_run or not applied:
        report.applied = len(applied) if dry_run else 0
        if not dry_run:
            program._attrs["fusion"] = report.as_dict()
        return program, report

    for cand in applied:
        cand.build(graph)
    fused = graph.to_program()
    report.applied = len(applied)
    fused._attrs["fusion"] = report.as_dict()
    return fused, report
