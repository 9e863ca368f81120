"""Graph IR and pass infrastructure: the part of ``paddle_tpu/framework/
ir.py`` the graph-fusion pass needs (ref ``paddle/fluid/framework/ir/``).

- ``Node`` / ``Graph`` (``ir/node.h``, ``ir/graph.h``): the dependency
  graph of one block, var nodes in SSA form, ``topology_sort`` and
  ``to_program`` (``ir/graph_to_program_pass.cc``);
- ``Pass`` / ``register_pass`` / ``get_pass`` (``ir/pass.h``);
- ``PDNode`` / ``PDPattern`` / ``GraphPatternDetector``
  (``ir/graph_pattern_detector.h``);
- ``buffer_shared_inplace_pass`` and the ``reference_count_pass`` it
  reads (``ir/memory_optimize_pass/``): the in-place pairs the fusion
  pass's legality rules check against;
- ``dead_op_analysis`` / ``dead_subblock_op_analysis`` (the verifier's
  ``dead_op`` check) and the ``dead_op_eliminate`` pass;
- ``fuse_elewise_add_act_pass`` (``ir/fuse_elewise_add_act_pass.cc``),
  which ``CompiledProgram`` runs after the fusion pass.

Graph building, node order and topology sort are the reference's, so a
rewrite gives the same program in both packages.  The reference's other
passes (the inference fusions, ``conv_bn_train_fuse_pass``, the viz pass)
are not ported yet.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from .core import Block, Operator, Program, Variable
from .recompute import is_recomputed

_node_ids = itertools.count()


class Node:
    """Op or var node (ref ``ir/node.h``).  Var nodes are SSA: every write
    to a name makes a fresh var node."""

    def __init__(self, kind: str, name: str, op: Optional[Operator] = None,
                 var: Optional[Variable] = None):
        self.id = next(_node_ids)
        self.kind = kind                    # "op" | "var"
        self.name = name                    # op type, or var name
        self.op = op
        self.var = var
        self.inputs: List[Node] = []
        self.outputs: List[Node] = []

    def is_op(self, type=None) -> bool:
        if self.kind != "op" or type is None:
            return self.kind == "op"
        if isinstance(type, (tuple, list, set, frozenset)):
            return self.name in type
        return self.name == type

    @property
    def persistable(self) -> bool:
        return bool(self.var is not None and self.var.persistable)

    def __repr__(self):
        return f"Node#{self.id}({self.kind}:{self.name})"


class Graph:
    """Dependency graph of one block of a Program (ref ``ir/graph.h``)."""

    def __init__(self, program: Program, block_idx: int = 0):
        self.program = program
        self.block_idx = block_idx
        self.attrs: Dict[str, object] = {}
        self.op_nodes: List[Node] = []      # in program order
        self.var_nodes: List[Node] = []
        # op node id -> its place in the program (``to_program`` keeps a
        # recomputed program's order by it); a pass may rank a new node
        self.rank: Dict[int, float] = {}
        block = program.blocks[block_idx]
        latest: Dict[str, Node] = {}        # name -> current SSA def

        def var_meta(name):
            return block.vars.get(name) or (
                block.var(name) if block.has_var(name) else None)

        for op in block.ops:
            op_node = Node("op", op.type, op=op)
            self.rank[op_node.id] = len(self.op_nodes)
            self.op_nodes.append(op_node)
            for name in op.input_arg_names():
                if not name:
                    continue
                v = latest.get(name)
                if v is None:
                    v = Node("var", name, var=var_meta(name))
                    latest[name] = v
                    self.var_nodes.append(v)
                op_node.inputs.append(v)
                v.outputs.append(op_node)
            for name in op.output_arg_names():
                if not name:
                    continue
                v = Node("var", name, var=var_meta(name))
                latest[name] = v
                self.var_nodes.append(v)
                op_node.outputs.append(v)
                v.inputs.append(op_node)

    def all_op_nodes(self) -> List[Node]:
        return list(self.op_nodes)

    def all_var_nodes(self) -> List[Node]:
        return list(self.var_nodes)

    def ops_of_type(self, type: str) -> List[Node]:
        return [n for n in self.op_nodes if n.name == type]

    def topology_sort(self, priority: Optional[Dict[int, int]] = None
                      ) -> List[Node]:
        """Op nodes in dependency order, ties in node order (ref
        ``graph_helper.cc`` TopologySortOperations).  With ``priority``
        (op node id -> rank), the ready op of the lowest rank goes first:
        an order of ranks that respects the dependencies comes back as it
        is.

        Besides the data edges, a write of a name waits for the reads and
        the write of its version before that come before it in the
        program (``self.rank``).  The reference's sort has only the data
        edges: an op updating a persistable in place that nothing feeds,
        such as Adamax's ``scale`` of its beta1 power, ran first, before
        the update reading the old power."""
        indeg: Dict[int, int] = {op.id: 0 for op in self.op_nodes}
        succ: Dict[int, List[Node]] = {}

        def edge(a, b):
            succ.setdefault(a.id, []).append(b)
            indeg[b.id] += 1

        for op in self.op_nodes:
            for v in op.outputs:
                for consumer in v.outputs:
                    edge(op, consumer)
        versions: Dict[str, List[Node]] = {}
        for v in self.var_nodes:
            versions.setdefault(v.name, []).append(v)
        for vs in versions.values():
            for before, v in zip(vs, vs[1:]):
                for writer in v.inputs:
                    for other in itertools.chain(before.outputs,
                                                 before.inputs):
                        # where a data edge already orders the pair, a
                        # second one would move the writer in the queue
                        if self.rank[other.id] < self.rank[writer.id] \
                                and writer not in succ.get(other.id, ()):
                            edge(other, writer)
        if priority is None:            # breadth first, the reference's
            ready = deque()
            push, pop = ready.append, ready.popleft
        else:
            ready = []

            def push(op):
                heapq.heappush(ready, (priority[op.id], op.id, op))

            def pop():
                return heapq.heappop(ready)[2]
        for op in self.op_nodes:
            if indeg[op.id] == 0:
                push(op)
        order: List[Node] = []
        while ready:
            op = pop()
            order.append(op)
            for consumer in succ.get(op.id, []):
                indeg[consumer.id] -= 1
                if indeg[consumer.id] == 0:
                    push(consumer)
        if len(order) != len(self.op_nodes):
            raise RuntimeError("graph has a cycle; pass produced invalid IR")
        return order

    def create_op_node(self, type: str, inputs: Dict[str, List[Node]],
                       outputs: Dict[str, List[Node]],
                       attrs: Optional[dict] = None) -> Node:
        """A new op node; its rank, until a pass sets another, is just
        after its inputs' producers."""
        block = self.program.blocks[self.block_idx]
        op = Operator(block, type, attrs=attrs or {})
        op.inputs = {slot: [v.name for v in vs] for slot, vs in inputs.items()}
        op.outputs = {slot: [v.name for v in vs]
                      for slot, vs in outputs.items()}
        node = Node("op", type, op=op)
        for vs in inputs.values():
            for v in vs:
                node.inputs.append(v)
                v.outputs.append(node)
        for vs in outputs.values():
            for v in vs:
                node.outputs.append(v)
                v.inputs.append(node)
        self.op_nodes.append(node)
        self.rank[node.id] = 0.5 + max(
            (self.rank[p.id] for vs in inputs.values() for v in vs
             for p in v.inputs), default=-1)
        return node

    def safe_remove_nodes(self, nodes: Sequence[Node]) -> None:
        doomed = {n.id for n in nodes}
        self.op_nodes = [o for o in self.op_nodes if o.id not in doomed]
        self.var_nodes = [v for v in self.var_nodes if v.id not in doomed]
        for n in itertools.chain(self.op_nodes, self.var_nodes):
            n.inputs = [i for i in n.inputs if i.id not in doomed]
            n.outputs = [o for o in n.outputs if o.id not in doomed]

    def to_program(self) -> Program:
        """A new Program: block 0 from this graph in topological order,
        the other blocks cloned from the source.  A recomputed program
        (``recompute.is_recomputed``) keeps its order, ranked by
        ``self.rank``: the executor runs ops in list order, and there the
        order is the memory plan (each recomputed chain just before the
        backward that reads it), where the breadth-first order would run
        every chain in the forward pass."""
        out = self.program.clone()
        blk = out.global_block()
        for v in self.var_nodes:
            if v.var is not None and v.name not in blk.vars:
                blk.create_var(name=v.name, shape=v.var.shape,
                               dtype=v.var.dtype,
                               persistable=v.var.persistable)
        blk.ops = []
        for op_node in self.topology_sort(
                self.rank if is_recomputed(self.program) else None):
            op = op_node.op
            attrs = {k: out.blocks[val.idx] if isinstance(val, Block)
                     else val for k, val in op.attrs.items()}
            nop = Operator(blk, op.type, None, None, attrs)
            nop.inputs = {k: list(v) for k, v in op.inputs.items()}
            nop.outputs = {k: list(v) for k, v in op.outputs.items()}
            blk.ops.append(nop)
        # sub-block rewrites recorded by a pass (the Graph models one
        # block): dead_op_eliminate's dead body ops are pruned here
        sub_dead = self.attrs.get("dead_subblock_ops")
        if sub_dead:
            prune_subblock_ops(out, sub_dead)
        out._bump_version()
        return out


# ---------------------------------------------------------------------------
# Pass framework (ref ir/pass.h)
# ---------------------------------------------------------------------------

class Pass:
    """Base pass: override ``apply_impl(graph) -> graph``.  The
    ``protected`` attr names the vars an executor will fetch: a rewrite
    must not remove their defining ops."""

    name = "pass"

    def __init__(self, **attrs):
        self.attrs = attrs

    def protected_vars(self) -> frozenset:
        return frozenset(self.attrs.get("protected") or ())

    def apply(self, graph: Graph) -> Graph:
        out = self.apply_impl(graph)
        return graph if out is None else out

    def apply_impl(self, graph: Graph) -> Optional[Graph]:
        raise NotImplementedError


_PASS_REGISTRY: Dict[str, Callable[..., Pass]] = {}


def register_pass(name: str):
    """``REGISTER_PASS`` (ref ir/pass.h:195)."""
    def deco(cls):
        cls.name = name
        _PASS_REGISTRY[name] = cls
        return cls
    return deco


def get_pass(name: str, **attrs) -> Pass:
    if name not in _PASS_REGISTRY:
        raise KeyError(f"no pass registered under {name!r}; "
                       f"have {sorted(_PASS_REGISTRY)}")
    return _PASS_REGISTRY[name](**attrs)


# ---------------------------------------------------------------------------
# Pattern detector (ref ir/graph_pattern_detector.{h,cc})
# ---------------------------------------------------------------------------

class PDNode:
    """One slot of a pattern: kind, op type, predicate and role flags."""

    def __init__(self, pattern: "PDPattern", name: str, kind: str,
                 op_type: Optional[str] = None,
                 predicate: Optional[Callable[[Node], bool]] = None,
                 persistable: Optional[bool] = None):
        self.pattern = pattern
        self.pd_name = name
        self.kind = kind
        self.op_type = op_type
        self.predicate = predicate
        self.persistable = persistable
        self.intermediate = False

    def as_intermediate(self) -> "PDNode":
        """Matched nodes are consumed by the rewrite (removed)."""
        self.intermediate = True
        return self

    def matches(self, node: Node) -> bool:
        if node.kind != self.kind:
            return False
        if self.op_type is not None and node.name != self.op_type:
            return False
        if self.persistable is not None and node.kind == "var" and \
                node.persistable != self.persistable:
            return False
        return self.predicate is None or self.predicate(node)


class PDPattern:
    """A small graph of PDNodes with edges."""

    def __init__(self):
        self.nodes: List[PDNode] = []
        self.edges: List[tuple] = []        # (from PDNode, to PDNode)

    def new_op(self, op_type: str, name: Optional[str] = None,
               predicate=None) -> PDNode:
        n = PDNode(self, name or op_type, "op", op_type=op_type,
                   predicate=predicate)
        self.nodes.append(n)
        return n

    def new_var(self, name: str, persistable: Optional[bool] = None,
                predicate=None) -> PDNode:
        n = PDNode(self, name, "var", predicate=predicate,
                   persistable=persistable)
        self.nodes.append(n)
        return n

    def link(self, frm: PDNode, to: PDNode) -> None:
        self.edges.append((frm, to))


class GraphPatternDetector:
    """Backtracking subgraph matcher, the reference's search: PDNodes are
    assigned in order of their candidate counts, candidates in graph
    order, matches are taken first-found and never overlap.

    One difference in how, not in what: where a PDNode has an edge to an
    already-assigned node, only that node's neighbours are tried (in
    candidate order), instead of every candidate being tried and refused
    by the edge check.  The same matches come out, in the same order,
    without the reference's scan of every var node per pair of ops."""

    def __init__(self, pattern: PDPattern):
        self.pattern = pattern

    def __call__(self, graph: Graph) -> List[Dict[PDNode, Node]]:
        pat = self.pattern
        all_nodes = graph.all_op_nodes() + graph.all_var_nodes()
        candidates = {pd: [n for n in all_nodes if pd.matches(n)]
                      for pd in pat.nodes}
        rank = {pd: {n.id: i for i, n in enumerate(candidates[pd])}
                for pd in pat.nodes}
        order = sorted(pat.nodes, key=lambda pd: len(candidates[pd]))
        matches: List[Dict[PDNode, Node]] = []
        used_ids = set()                    # no overlapping rewrites

        def edges_ok(assign: Dict[PDNode, Node]) -> bool:
            for frm, to in pat.edges:
                if frm in assign and to in assign:
                    if assign[to] not in assign[frm].outputs:
                        return False
            return True

        def options(pd, assign):
            """pd's candidates that can still satisfy its edges to the
            nodes assigned so far, in candidate order."""
            near = None
            for frm, to in pat.edges:
                if frm is pd and to in assign:
                    near = assign[to].inputs
                elif to is pd and frm in assign:
                    near = assign[frm].outputs
                if near is not None:
                    break
            if near is None:
                return candidates[pd]
            r = rank[pd]
            picked = {n.id: n for n in near if n.id in r}
            return [picked[i] for i in sorted(picked, key=r.__getitem__)]

        def dfs(i: int, assign: Dict[PDNode, Node]):
            if i == len(order):
                if not any(n.id in used_ids for n in assign.values()):
                    matches.append(dict(assign))
                    used_ids.update(
                        n.id for pd, n in assign.items()
                        if pd.intermediate or pd.kind == "op")
                return
            pd = order[i]
            taken = {n.id for n in assign.values()}
            for cand in options(pd, assign):
                if cand.id in taken:
                    continue
                assign[pd] = cand
                if edges_ok(assign):
                    dfs(i + 1, assign)
                del assign[pd]

        dfs(0, {})
        return matches


def _input_node(op_node, slot, i=0):
    names = op_node.op.input(slot)
    if not names or i >= len(names):
        return None
    return next((v for v in op_node.inputs if v.name == names[i]), None)


def _output_node(op_node, slot, i=0):
    names = op_node.op.output(slot)
    if not names or i >= len(names):
        return None
    return next((v for v in op_node.outputs if v.name == names[i]), None)


def _referenced_outside_block0(program, name: str) -> bool:
    """True if an op in a control-flow sub-block touches ``name``: the
    block-0 Graph cannot see those consumers."""
    for blk in program.blocks[1:]:
        for op in blk.ops:
            if name in op.input_arg_names() or \
                    name in op.output_arg_names():
                return True
    return False


# ---------------------------------------------------------------------------
# Memory-analysis passes (ref ir/memory_optimize_pass/)
# ---------------------------------------------------------------------------

@register_pass("reference_count_pass")
class ReferenceCountPass(Pass):
    """Liveness: last-use position per non-persistable var
    (``graph.attrs['last_use']``)."""

    def apply_impl(self, graph: Graph) -> Graph:
        order = {op.id: i for i, op in enumerate(graph.topology_sort())}
        last_use: Dict[str, int] = {}
        for v in graph.all_var_nodes():
            if v.persistable:
                continue
            uses = [order[c.id] for c in v.outputs if c.id in order]
            if uses:
                last_use[v.name] = max(uses)
        graph.attrs["last_use"] = last_use
        return graph


@register_pass("buffer_shared_inplace_pass")
class BufferSharedInplacePass(Pass):
    """Pairs (in, out) an op could compute in place because the input dies
    there (ref ``buffer_shared_inplace_op_pass.cc``;
    ``graph.attrs['inplace_pairs']``)."""

    INPLACE_OPS = ("relu", "scale", "reshape", "reshape2", "squeeze",
                   "squeeze2", "unsqueeze", "unsqueeze2", "flatten",
                   "flatten2", "elementwise_add", "softmax", "dropout")

    def apply_impl(self, graph: Graph) -> Graph:
        graph = get_pass("reference_count_pass").apply(graph)
        last_use = graph.attrs["last_use"]
        order = {op.id: i for i, op in enumerate(graph.topology_sort())}
        pairs = []
        for op in graph.all_op_nodes():
            if op.name not in self.INPLACE_OPS:
                continue
            for vin in op.inputs:
                if vin.persistable or vin.name not in last_use:
                    continue
                if last_use[vin.name] == order[op.id] and op.outputs:
                    pairs.append((vin.name, op.outputs[0].name))
                    break
        graph.attrs["inplace_pairs"] = pairs
        return graph


# ---------------------------------------------------------------------------
# Elementwise add + activation (ref ir/fuse_elewise_add_act_pass.cc)
# ---------------------------------------------------------------------------

@register_pass("fuse_elewise_add_act_pass")
class FuseElewiseAddActPass(Pass):
    """elementwise_add + activation -> ``fused_elemwise_activation``
    (``paddle_tpu/framework/ir.py:718``).  The count lands in
    ``graph.attrs['fuse_elewise_add_act_count']``."""

    ACTS = ("relu", "scale", "tanh", "sigmoid", "gelu")

    def apply_impl(self, graph: Graph) -> Graph:
        protected = self.protected_vars()
        count = 0
        for add in list(graph.ops_of_type("elementwise_add")):
            if add not in graph.op_nodes:
                continue
            out = add.outputs[0] if add.outputs else None
            if out is None or len(out.outputs) != 1 or \
                    out.name in protected:
                continue
            act = out.outputs[0]
            if not act.is_op() or act.name not in self.ACTS:
                continue
            # bind by slot: elementwise broadcast is X-major
            by_name = {v.name: v for v in add.inputs}
            try:
                xs = [by_name[add.op.input("X")[0]],
                      by_name[add.op.input("Y")[0]]]
            except (KeyError, IndexError):
                continue
            extra = {}
            if act.name == "scale":
                extra = {"scale": act.op.attrs.get("scale", 1.0),
                         "bias": act.op.attrs.get("bias", 0.0),
                         "bias_after_scale":
                         act.op.attrs.get("bias_after_scale", True)}
            graph.create_op_node(
                "fused_elemwise_activation",
                inputs={"X": [xs[0]], "Y": [xs[1]]},
                outputs={"Out": [act.outputs[0]]},
                attrs={"functor_list": ["elementwise_add", act.name],
                       "axis": add.op.attrs.get("axis", -1), **extra})
            graph.safe_remove_nodes([add, act, out])
            count += 1
        graph.attrs["fuse_elewise_add_act_count"] = count
        return graph


# ---------------------------------------------------------------------------
# Dead-op analysis and elimination (``paddle_tpu/framework/ir.py:1578-1763``)
# ---------------------------------------------------------------------------

SIDE_EFFECT_OPS = frozenset({
    "feed", "fetch", "listen_and_serv", "send", "recv", "print", "assert",
    "save", "load", "py_func", "gen_nccl_id",
})


def _is_root_op(op, outputs_observed) -> bool:
    """A liveness root: a side-effecting op, a collective, an op carrying a
    sub-block, an op without outputs, or one whose output is observed."""
    if op.type in SIDE_EFFECT_OPS or op.type.startswith("c_"):
        return True
    if any(isinstance(v, Block) for v in op.attrs.values()):
        return True
    outs = [n for n in op.output_arg_names() if n]
    return not outs or any(outputs_observed(n) for n in outs)


def dead_op_analysis(graph: Graph, protected=frozenset()) -> List[Node]:
    """The op nodes of ``graph`` whose outputs reach no liveness root: no
    ``protected`` (fetched) var, no persistable, no var a control-flow
    sub-block references, no side-effecting op.  The verifier's ``dead_op``
    check and the ``dead_op_eliminate`` pass share this sweep."""
    program = graph.program
    block = program.blocks[graph.block_idx]
    sub_refs = set()
    for blk in program.blocks:
        if blk.idx == graph.block_idx:
            continue
        for op in blk.ops:
            sub_refs.update(op.input_arg_names())
            sub_refs.update(op.output_arg_names())

    def observed(name):
        return name in protected or name in sub_refs or (
            block.has_var(name) and block.var(name).persistable)

    live = {n.id for n in graph.op_nodes if _is_root_op(n.op, observed)}
    stack = [n for n in graph.op_nodes if n.id in live]
    while stack:
        op_node = stack.pop()
        for v in op_node.inputs:
            for producer in v.inputs:
                if producer.id not in live:
                    live.add(producer.id)
                    stack.append(producer)
    return [n for n in graph.op_nodes if n.id not in live]


def dead_subblock_op_analysis(program: Program,
                              protected=frozenset()) -> Dict[int, tuple]:
    """Per sub-block (idx > 0), the program-order indices of the ops whose
    outputs reach none of the block's roots: names any other block
    references (loop-carried vars, conditions, and the enclosing op's
    string attrs), fetched names, persistables, side-effecting ops.
    Returns ``{block_idx: (op indices...)}`` for blocks with a dead op."""
    out: Dict[int, tuple] = {}
    for block in program.blocks[1:]:
        ext_refs = set()
        for other in program.blocks:
            if other.idx == block.idx:
                continue
            for op in other.ops:
                ext_refs.update(op.input_arg_names())
                ext_refs.update(op.output_arg_names())
                if not any(isinstance(v, Block) and v.idx == block.idx
                           for v in op.attrs.values()):
                    continue
                # the enclosing op's attr lists name body vars outside
                # its input/output slots
                for av in op.attrs.values():
                    if isinstance(av, (list, tuple)):
                        ext_refs.update(x for x in av if isinstance(x, str))
                    elif isinstance(av, str):
                        ext_refs.add(av)

        def observed(name, _b=block):
            return name in protected or name in ext_refs or (
                _b.has_var(name) and _b.var(name).persistable)

        live = {i for i, op in enumerate(block.ops)
                if _is_root_op(op, observed)}
        changed = True
        while changed:
            changed = False
            needed = {n for i in live
                      for n in block.ops[i].input_arg_names() if n}
            for i, op in enumerate(block.ops):
                if i not in live and needed & {
                        n for n in op.output_arg_names() if n}:
                    live.add(i)
                    changed = True
        dead = tuple(i for i in range(len(block.ops)) if i not in live)
        if dead:
            out[block.idx] = dead
    return out


def prune_subblock_ops(program: Program,
                       dead_map: Dict[int, tuple]) -> int:
    """Drop the ops :func:`dead_subblock_op_analysis` named from
    ``program``'s sub-blocks, in place.  Returns how many went."""
    removed = 0
    for idx, indices in (dead_map or {}).items():
        if idx <= 0 or idx >= len(program.blocks):
            continue
        block = program.blocks[idx]
        doomed = set(indices)
        kept = [op for i, op in enumerate(block.ops) if i not in doomed]
        removed += len(block.ops) - len(kept)
        block.ops = kept
    if removed:
        program._bump_version()
    return removed


@register_pass("dead_op_eliminate")
class DeadOpEliminatePass(Pass):
    """Remove the ops :func:`dead_op_analysis` finds, with their outputs,
    and record the dead sub-block ops for :meth:`Graph.to_program` to
    prune.  The count lands in ``graph.attrs['dead_op_eliminate_count']``."""

    def apply_impl(self, graph: Graph) -> Graph:
        dead = dead_op_analysis(graph, self.protected_vars())
        # a dead op's consumers are dead too, so its outputs go with it
        doomed_vars = [v for n in dead for v in n.outputs]
        graph.safe_remove_nodes(list(dead) + doomed_vars)
        sub_dead = dead_subblock_op_analysis(graph.program,
                                             self.protected_vars())
        graph.attrs["dead_subblock_ops"] = sub_dead
        graph.attrs["dead_op_eliminate_count"] = \
            len(dead) + sum(len(v) for v in sub_dead.values())
        return graph
