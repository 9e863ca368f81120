"""Graph IR and pass infrastructure: the port of ``paddle_tpu/framework/
ir.py`` (ref ``paddle/fluid/framework/ir/``).

- ``Node`` / ``Graph`` (``ir/node.h``, ``ir/graph.h``): the dependency
  graph of one block, var nodes in SSA form, ``topology_sort``,
  ``to_program`` (``ir/graph_to_program_pass.cc``) and
  ``apply_to_program``;
- ``Pass`` / ``register_pass`` / ``get_pass`` / ``registered_passes``
  (``ir/pass.h``), ``PassBuilder`` (``ir/pass_builder.h``) and
  ``apply_passes``;
- ``PDNode`` / ``PDPattern`` / ``GraphPatternDetector``
  (``ir/graph_pattern_detector.h``);
- the fusion passes: ``fc_fuse_pass``, ``attention_fuse_pass`` (a dense
  attention chain onto the ``flash_attention`` op, which runs the port's
  K1 on the card), ``fuse_elewise_add_act_pass``, ``conv_bn_train_fuse_pass``
  (onto ``fused_conv1x1_bn``, K3 on the card), the serving
  canonicalizations (``repeated_fc_relu``, ``squared_mat_sub``,
  ``transpose_flatten_concat``, ``seqpool_concat``), the recurrent and
  sequence rewrites (``fc_gru``, ``fc_lstm``, ``embedding_fc_lstm``,
  ``seqconv_eltadd_relu``), ``conv_elementwise_add_act_fuse_pass`` and
  the inference-time ``conv_bn_fuse_pass``;
- ``buffer_shared_inplace_pass`` and the ``reference_count_pass`` it
  reads (``ir/memory_optimize_pass/``);
- ``dead_op_analysis`` / ``dead_subblock_op_analysis`` (the verifier's
  ``dead_op`` check) and the ``dead_op_eliminate`` pass;
- ``graph_viz_pass`` (DOT) and ``graph_to_program_pass``.

Graph building, node order, pattern matching and each rewrite are the
reference's, so a pass gives the same program in both packages.  The
passes that fold numbers (``conv_bn_fuse_pass``, the fc bias into a GRU or
LSTM gate bias, the pre-multiplied embedding table) read the scope's values
in float64 and store float32 tensors on the device of the values they
replace.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

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
        the update reading the old power.  The parameter-server ops
        (``ORDERED_OPS``) also keep their program order among themselves,
        as the reference's ordered host callbacks do: a pull, a barrier or
        a push with no data edge between them would otherwise move (a
        ``recv`` before the last ``send`` of its step)."""
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
        ordered = [op for op in self.op_nodes if op.name in ORDERED_OPS]
        ordered.sort(key=lambda op: self.rank[op.id])
        for before, op in zip(ordered, ordered[1:]):
            if op not in succ.get(before.id, ()):
                edge(before, op)
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

    def create_var_node(self, name: str, shape=None, dtype=None,
                        persistable: bool = False) -> Node:
        block = self.program.blocks[self.block_idx]
        var = block.create_var(name=name, shape=shape, dtype=dtype,
                               persistable=persistable)
        node = Node("var", var.name, var=var)
        self.var_nodes.append(node)
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

    def apply_to_program(self) -> Program:
        """Write the rewritten block 0 back into the source program.

        For a train-time pass that runs between the model build and
        ``minimize()``: the backward goes to ``loss.block.program``, so a
        clone from :meth:`to_program` would split the gradients from the
        optimizer ops.  Vars the rewrite orphaned go, except persistables
        and parameters (their values live in the scope)."""
        rebuilt = self.to_program()
        src = self.program
        blk = src.global_block()
        new_blk = rebuilt.global_block()
        for name, v in new_blk.vars.items():
            if name not in blk.vars:
                blk.vars[name] = v
                v.block = blk
        ops = []
        referenced = set()
        for op in new_blk.ops:
            for k, val in op.attrs.items():
                if isinstance(val, Block):
                    op.attrs[k] = src.blocks[val.idx]
            op.block = blk
            ops.append(op)
            referenced.update(op.input_arg_names())
            referenced.update(op.output_arg_names())
        blk.ops = ops
        for name in list(blk.vars):
            v = blk.vars[name]
            if name not in referenced and not v.persistable and \
                    not getattr(v, "is_parameter", False):
                del blk.vars[name]
        sub_dead = self.attrs.get("dead_subblock_ops")
        if sub_dead:
            prune_subblock_ops(src, sub_dead)
        src._bump_version()
        return src


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
        return frozenset(self.get("protected") or ())

    def set(self, key, value):
        self.attrs[key] = value
        return self

    def get(self, key, default=None):
        return self.attrs.get(key, default)

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


def registered_passes() -> List[str]:
    return sorted(_PASS_REGISTRY)


class PassBuilder:
    """Ordered pass pipeline (ref ir/pass_builder.h PassBuilder)."""

    def __init__(self, names: Optional[Sequence[str]] = None):
        self._passes: List[Pass] = [get_pass(n) for n in (names or [])]

    def append_pass(self, name: str, **attrs) -> Pass:
        p = get_pass(name, **attrs)
        self._passes.append(p)
        return p

    def insert_pass(self, idx: int, name: str, **attrs) -> Pass:
        p = get_pass(name, **attrs)
        self._passes.insert(idx, p)
        return p

    def remove_pass(self, idx: int) -> None:
        del self._passes[idx]

    def all_passes(self) -> List[Pass]:
        return list(self._passes)

    def apply(self, graph: Graph) -> Graph:
        for p in self._passes:
            graph = p.apply(graph)
        return graph


def apply_passes(program: Program, names: Sequence[str],
                 **attrs) -> Program:
    """Program → Graph → the named passes, in order → a new Program."""
    graph = Graph(program)
    for n in names:
        graph = get_pass(n, **attrs).apply(graph)
    return graph.to_program()


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


def _sole_producer(var_node, op_type):
    """The op producing ``var_node`` iff it is of ``op_type``."""
    if not var_node.inputs or not var_node.inputs[0].is_op(op_type):
        return None
    return var_node.inputs[0]


def _host_value(scope, name) -> np.ndarray:
    """The scope's value of ``name`` as a numpy array on the host."""
    v = scope.find_var(name)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _host_f64(scope, name) -> np.ndarray:
    return np.asarray(_host_value(scope, name), np.float64)


def _set_f32(scope, name, arr, like) -> None:
    """Store ``arr`` in the scope as a float32 tensor on the device of the
    scope's value of ``like`` (the host when that is no tensor)."""
    ref = scope.find_var(like)
    device = ref.device if isinstance(ref, torch.Tensor) else "cpu"
    scope.set_var(name, torch.from_numpy(
        np.ascontiguousarray(arr, np.float32)).to(device))


# ---------------------------------------------------------------------------
# Fusion passes (``paddle_tpu/framework/ir.py:492-1523``)
# ---------------------------------------------------------------------------

@register_pass("fc_fuse_pass")
class FCFusePass(Pass):
    """mul(X,W) + elementwise_add(·,b) [+ act] → one ``fc`` op
    (ref ir/fc_fuse_pass.cc).  ``fc`` applies gelu in its tanh form, as
    the reference's does (``jax.nn.gelu``'s default), where the ``gelu``
    op it replaces is exact."""

    ACTS = ("relu", "tanh", "sigmoid", "gelu")

    def apply_impl(self, graph: Graph) -> Graph:
        pat = PDPattern()
        mul = pat.new_op("mul")
        mul_out = pat.new_var("mul_out").as_intermediate()
        add = pat.new_op("elementwise_add")
        bias = pat.new_var("bias", persistable=True)
        add_out = pat.new_var("add_out")
        pat.link(mul, mul_out)
        pat.link(mul_out, add)
        pat.link(bias, add)
        pat.link(add, add_out)
        protected = self.protected_vars()
        count = 0
        for m in GraphPatternDetector(pat)(graph):
            # mul_out feeds only the add and is not fetched
            if len(m[mul_out].outputs) != 1 or \
                    m[mul_out].name in protected:
                continue
            mul_op, add_op = m[mul], m[add]
            # operands by slot: fc is X@W, W mul's Y and a weight
            by_name = {v.name: v for v in mul_op.inputs}
            x_node = by_name.get(mul_op.op.input("X")[0])
            w_node = by_name.get(mul_op.op.input("Y")[0])
            if x_node is None or w_node is None or not w_node.persistable:
                continue
            out_node = m[add_out]
            act_type = ""
            doomed = [mul_op, add_op, m[mul_out]]
            consumers = out_node.outputs
            if len(consumers) == 1 and consumers[0].is_op() and \
                    consumers[0].name in self.ACTS and \
                    out_node.name not in protected:
                act_op = consumers[0]
                act_type = act_op.name
                doomed += [act_op, out_node]
                out_node = act_op.outputs[0]
            graph.create_op_node(
                "fc",
                inputs={"Input": [x_node], "W": [w_node],
                        "Bias": [m[bias]]},
                outputs={"Out": [out_node]},
                attrs={"in_num_col_dims":
                       mul_op.op.attrs.get("x_num_col_dims", 1),
                       "activation_type": act_type})
            graph.safe_remove_nodes(doomed)
            count += 1
        graph.attrs["fc_fuse_count"] = count
        return graph


@register_pass("attention_fuse_pass")
class AttentionFusePass(Pass):
    """matmul(Q,Kᵀ,α) [+ mask add] → softmax → matmul(·,V)  ⇒  one
    ``flash_attention`` op, which runs K1 on the card
    (``paddle_tpu/framework/ir.py:554``).  A saved artifact built with the
    dense recipe gets the fused kernel at load time from T >=
    ``min_seq_len`` (default 1024).

    The chain's forms: no mask; an additive ``[*,*,Tq,Tk]`` bias, which
    becomes the op's Bias; a persistable frozen causal mask (with
    ``scope=``), dropped for ``causal=True``; cross-attention (Tq != Tk)."""

    @staticmethod
    def _is_frozen_causal_mask(arr) -> bool:
        """True for [*..,T,T] masks with ~0 on/below the diagonal and a
        large negative constant strictly above."""
        if arr.ndim < 2 or arr.shape[-1] != arr.shape[-2]:
            return False
        t = arr.shape[-1]
        m = arr.reshape(-1, t, t)
        if not np.allclose(m, m[0], atol=1e-6):
            return False       # the same mask for every batch/head
        low = np.tril(m[0])
        up = m[0][np.triu_indices(t, k=1)]
        return (np.allclose(low, 0.0, atol=1e-6)
                and up.size > 0 and bool((up <= -1e4).all()))

    def apply_impl(self, graph: Graph) -> Graph:
        min_seq = int(self.get("min_seq_len", 1024) or 0)
        protected = self.protected_vars()
        count = 0
        for mm1 in list(graph.ops_of_type("matmul")):
            if mm1 not in graph.op_nodes:
                continue
            a = mm1.op.attrs
            if not a.get("transpose_Y") or a.get("transpose_X"):
                continue
            scores = mm1.outputs[0] if mm1.outputs else None
            if scores is None or len(scores.outputs) != 1 or \
                    scores.name in protected:
                continue
            # optional additive mask between scores and softmax
            nxt = scores.outputs[0]
            bias_node, doomed_mask = None, []
            if nxt.is_op("elementwise_add"):
                add = nxt
                m_out = add.outputs[0] if add.outputs else None
                if m_out is None or len(m_out.outputs) != 1 or \
                        m_out.name in protected:
                    continue
                by_name = {v.name: v for v in add.inputs}
                if by_name.get(add.op.input("X")[0]) is not scores:
                    continue
                bias_node = by_name.get(add.op.input("Y")[0])
                doomed_mask = [add, m_out]
                nxt = m_out.outputs[0]
            if not nxt.is_op("softmax"):
                continue
            sm = nxt
            sm_axis = sm.op.attrs.get("axis", -1)
            probs = sm.outputs[0] if sm.outputs else None
            if probs is None or len(probs.outputs) != 1 or \
                    probs.name in protected:
                continue
            mm2 = probs.outputs[0]
            if not mm2.is_op("matmul"):
                continue
            a2 = mm2.op.attrs
            if a2.get("transpose_X") or a2.get("transpose_Y") or \
                    a2.get("alpha", 1.0) != 1.0:
                continue
            if mm2.op.input("X")[0] != probs.name:
                continue
            q_node = _input_node(mm1, "X")
            k_node = _input_node(mm1, "Y")
            v_node = _input_node(mm2, "Y")
            if q_node is None or k_node is None or v_node is None:
                continue
            # the crossover: shorter sequences keep the dense chain
            shape = getattr(q_node.var, "shape", None)
            if shape is None or len(shape) != 4 or shape[-2] is None:
                continue
            if shape[-2] != -1 and shape[-2] < min_seq:
                continue
            # the op is rank-4 and normalizes over the last (key) axis
            if any(len(getattr(n.var, "shape", None) or ()) != 4
                   for n in (k_node, v_node)):
                continue
            scores_rank = len(getattr(scores.var, "shape", None) or shape)
            if sm_axis not in (-1, scores_rank - 1):
                continue
            causal = False
            if bias_node is not None:
                # [B,1,1,Tk] padding masks stay on the dense path
                bshape = getattr(bias_node.var, "shape", None)
                if bshape is None or len(bshape) < 2 or \
                        bshape[-2] in (1, None):
                    continue
                scope = self.get("scope")
                if scope is not None and \
                        getattr(bias_node.var, "persistable", False) and \
                        not bias_node.inputs and \
                        scope.find_var(bias_node.name) is not None:
                    causal = self._is_frozen_causal_mask(
                        _host_value(scope, bias_node.name))
            inputs = {"Q": [q_node], "K": [k_node], "V": [v_node]}
            if bias_node is not None and not causal:
                inputs["Bias"] = [bias_node]
            elif causal and len(bias_node.outputs) == 1 and \
                    bias_node.name not in protected:
                doomed_mask.append(bias_node)   # the mask fed only this add
            out_node = mm2.outputs[0]
            graph.create_op_node(
                "flash_attention", inputs=inputs,
                outputs={"Out": [out_node]},
                attrs={"sm_scale": float(a.get("alpha", 1.0)),
                       "causal": causal})
            graph.safe_remove_nodes(
                [mm1, scores, sm, probs, mm2] + doomed_mask)
            count += 1
        graph.attrs["attention_fuse_count"] = count
        return graph


@register_pass("conv_bn_train_fuse_pass")
class ConvBNTrainFusePass(Pass):
    """conv2d(1x1) + batch_norm(train) [+ relu] → ``fused_conv1x1_bn``
    (``paddle_tpu/framework/ir.py:763``), whose conv and BN sums run as
    K3 on the card.  Run it before ``minimize()``: once the backward
    reads the conv's output, the pair no longer matches."""

    def apply_impl(self, graph: Graph) -> Graph:
        protected = self.protected_vars()
        count = 0
        for bn in list(graph.ops_of_type("batch_norm")):
            if bn not in graph.op_nodes:
                continue
            a = bn.op.attrs
            if a.get("is_test") or a.get("use_global_stats"):
                continue
            if a.get("data_layout", "NCHW") != "NCHW":
                continue
            by_name = {v.name: v for v in bn.inputs}
            x_in = by_name.get(bn.op.input("X")[0])
            if x_in is None or not x_in.inputs or \
                    not x_in.inputs[0].is_op("conv2d"):
                continue
            if len(x_in.outputs) != 1 or x_in.name in protected:
                continue                     # the conv feeds the BN only
            conv = x_in.inputs[0]
            ca = conv.op.attrs
            strides = ca.get("strides", [1, 1])
            if ca.get("groups", 1) != 1 or \
                    any(p != 0 for p in ca.get("paddings", [0, 0])) or \
                    any(d != 1 for d in ca.get("dilations", [1, 1])) or \
                    strides[0] != strides[1]:
                continue
            w_node = _input_node(conv, "Filter")
            x_node = _input_node(conv, "Input")
            if w_node is None or x_node is None:
                continue
            wshape = getattr(w_node.var, "shape", None)
            if not wshape or len(wshape) != 4 or wshape[2] != 1 or \
                    wshape[3] != 1:
                continue
            if conv.op.input("Bias"):
                continue
            y_node = next((v for v in bn.outputs
                           if v.name in bn.op.output("Y")), None)
            if y_node is None:
                continue
            # a relu that alone reads Y folds into the act attr
            act, doomed_act = "", []
            if len(y_node.outputs) == 1 and \
                    y_node.outputs[0].is_op("relu") and \
                    y_node.name not in protected:
                relu = y_node.outputs[0]
                act = "relu"
                out_node = relu.outputs[0]
                doomed_act = [relu, y_node]
            else:
                out_node = y_node
            outs = {"Y": [out_node]}
            for slot in ("MeanOut", "VarianceOut", "SavedMean",
                         "SavedVariance"):
                names = bn.op.output(slot)
                if names:
                    node = next((v for v in bn.outputs
                                 if v.name in names), None)
                    if node is not None:
                        outs[slot] = [node]
            graph.create_op_node(
                "fused_conv1x1_bn",
                inputs={"X": [x_node], "Filter": [w_node],
                        "Scale": [by_name[bn.op.input("Scale")[0]]],
                        "Bias": [by_name[bn.op.input("Bias")[0]]],
                        "Mean": [by_name[bn.op.input("Mean")[0]]],
                        "Variance": [by_name[bn.op.input("Variance")[0]]]},
                outputs=outs,
                attrs={"momentum": a.get("momentum", 0.9),
                       "epsilon": a.get("epsilon", 1e-5),
                       "act": act, "stride": int(strides[0]),
                       "is_test": False,
                       "use_global_stats": False})
            graph.safe_remove_nodes([conv, x_in, bn] + doomed_act)
            count += 1
        graph.attrs["conv_bn_train_fuse_count"] = count
        return graph


@register_pass("repeated_fc_relu_fuse_pass")
class RepeatedFCReluFusePass(Pass):
    """Chains of fc(act=relu) → one ``fusion_repeated_fc_relu`` (fused op:
    ref fused/fusion_repeated_fc_relu_op.cc).  Runs after fc_fuse_pass,
    which makes the fc nodes it chains."""

    def apply_impl(self, graph: Graph) -> Graph:
        protected = self.protected_vars()
        count = 0
        consumed = set()
        for fc in list(graph.ops_of_type("fc")):
            if fc not in graph.op_nodes or fc in consumed:
                continue
            if fc.op.attrs.get("activation_type") != "relu":
                continue
            # chain heads only: the input is no relu-fc's output
            x_node = _input_node(fc, "Input")
            if x_node is None:
                continue
            if x_node.inputs and x_node.inputs[0].is_op("fc") and \
                    x_node.inputs[0].op.attrs.get("activation_type") == \
                    "relu":
                continue
            chain = [fc]
            while True:
                out = chain[-1].outputs[0]
                if len(out.outputs) != 1 or out.name in protected:
                    break
                nxt = out.outputs[0]
                if not nxt.is_op("fc") or \
                        nxt.op.attrs.get("activation_type") != "relu" or \
                        nxt.op.input("Input")[0] != out.name:
                    break
                chain.append(nxt)
            if len(chain) < 2:
                continue
            ws, bs, doomed = [], [], []
            ok = True
            for i, node in enumerate(chain):
                by_name = {v.name: v for v in node.inputs}
                w = by_name.get(node.op.input("W")[0])
                b = by_name.get(node.op.input("Bias")[0]) \
                    if node.op.input("Bias") else None
                if w is None or b is None:
                    ok = False
                    break
                ws.append(w)
                bs.append(b)
                doomed.append(node)
                if i < len(chain) - 1:
                    doomed.append(node.outputs[0])
            if not ok:
                continue
            out_node = chain[-1].outputs[0]
            graph.create_op_node(
                "fusion_repeated_fc_relu",
                inputs={"X": [x_node], "W": ws, "Bias": bs},
                outputs={"Out": [out_node]}, attrs={})
            graph.safe_remove_nodes(doomed)
            consumed.update(chain)
            count += 1
        graph.attrs["repeated_fc_relu_fuse_count"] = count
        return graph


@register_pass("squared_mat_sub_fuse_pass")
class SquaredMatSubFusePass(Pass):
    """square(X·Y) − square(X)·square(Y) [→ scale] → one
    ``fusion_squared_mat_sub`` (ref ir/squared_mat_sub_fuse_pass.cc)."""

    def apply_impl(self, graph: Graph) -> Graph:
        protected = self.protected_vars()
        count = 0
        for sub in list(graph.ops_of_type("elementwise_sub")):
            if sub not in graph.op_nodes:
                continue
            lhs = _input_node(sub, "X")
            rhs = _input_node(sub, "Y")
            if lhs is None or rhs is None or not lhs.inputs or \
                    not rhs.inputs:
                continue
            sq_xy, mm2 = lhs.inputs[0], rhs.inputs[0]
            if not sq_xy.is_op("square") or not mm2.is_op("matmul"):
                continue
            mm1_out = sq_xy.inputs[0]
            if not mm1_out.inputs or not mm1_out.inputs[0].is_op("matmul"):
                continue
            mm1 = mm1_out.inputs[0]
            a1, a2 = mm1.op.attrs, mm2.op.attrs
            if any(a.get("transpose_X") or a.get("transpose_Y") or
                   a.get("alpha", 1.0) != 1.0 for a in (a1, a2)):
                continue
            # mm2's operands are square(x), square(y) of mm1's operands
            x_node = _input_node(mm1, "X")
            y_node = _input_node(mm1, "Y")
            sqx_v = _input_node(mm2, "X")
            sqy_v = _input_node(mm2, "Y")
            if None in (x_node, y_node, sqx_v, sqy_v):
                continue
            if not sqx_v.inputs or not sqx_v.inputs[0].is_op("square") or \
                    not sqy_v.inputs or not sqy_v.inputs[0].is_op("square"):
                continue
            sqx_op, sqy_op = sqx_v.inputs[0], sqy_v.inputs[0]
            if sqx_op.inputs[0] is not x_node or \
                    sqy_op.inputs[0] is not y_node:
                continue
            inter = [mm1_out, lhs, rhs, sqx_v, sqy_v]
            if any(len(v.outputs) != 1 or v.name in protected
                   for v in inter):
                continue
            out_node = sub.outputs[0]
            scalar = 1.0
            doomed_scale = []
            if len(out_node.outputs) == 1 and out_node.name not in \
                    protected and out_node.outputs[0].is_op("scale"):
                sc = out_node.outputs[0]
                if sc.op.attrs.get("bias", 0.0) == 0.0:
                    scalar = float(sc.op.attrs.get("scale", 1.0))
                    doomed_scale = [sc, out_node]
                    out_node = sc.outputs[0]
            graph.create_op_node(
                "fusion_squared_mat_sub",
                inputs={"X": [x_node], "Y": [y_node]},
                outputs={"Out": [out_node]}, attrs={"scalar": scalar})
            graph.safe_remove_nodes(
                [mm1, mm1_out, sq_xy, lhs, sqx_op, sqx_v, sqy_op, sqy_v,
                 mm2, rhs, sub] + doomed_scale)
            count += 1
        graph.attrs["squared_mat_sub_fuse_count"] = count
        return graph


@register_pass("transpose_flatten_concat_fuse_pass")
class TransposeFlattenConcatFusePass(Pass):
    """N × (transpose2 → flatten2) → concat ⇒ one
    ``fusion_transpose_flatten_concat``
    (ref ir/transpose_flatten_concat_fuse_pass.cc)."""

    def apply_impl(self, graph: Graph) -> Graph:
        protected = self.protected_vars()
        count = 0
        for cc in list(graph.ops_of_type("concat")):
            if cc not in graph.op_nodes:
                continue
            srcs, doomed, perms = [], [cc], []
            ok = True
            for v in cc.inputs:
                if v.name in protected or len(v.outputs) != 1 or \
                        not v.inputs or not v.inputs[0].is_op(
                            ("flatten2", "flatten")):
                    ok = False
                    break
                fl = v.inputs[0]
                if fl.op.attrs.get("axis", 1) != 1:
                    ok = False
                    break
                fv = _input_node(fl, "X")
                if fv is None or len(fv.outputs) != 1 or \
                        fv.name in protected or not fv.inputs or \
                        not fv.inputs[0].is_op(("transpose2", "transpose")):
                    ok = False
                    break
                tr = fv.inputs[0]
                perms.append(tuple(tr.op.attrs.get("axis", [])))
                src = _input_node(tr, "X")
                # the XShape side outputs nothing reads go with their ops
                extra = [o for node in (tr, fl) for o in node.outputs
                         if o is not fv and o is not v]
                if src is None or any(
                        o.outputs or o.name in protected for o in extra):
                    ok = False
                    break
                srcs.append(src)
                doomed += [fl, v, tr, fv] + extra
            if not ok or len(srcs) < 2 or len(set(perms)) != 1:
                continue
            out_node = cc.outputs[0]
            graph.create_op_node(
                "fusion_transpose_flatten_concat",
                inputs={"X": srcs}, outputs={"Out": [out_node]},
                attrs={"trans_axis": list(perms[0]),
                       "concat_axis": cc.op.attrs.get("axis", 1)})
            graph.safe_remove_nodes(doomed)
            count += 1
        graph.attrs["transpose_flatten_concat_fuse_count"] = count
        return graph


@register_pass("seqpool_concat_fuse_pass")
class SeqpoolConcatFusePass(Pass):
    """N × sequence_pool → concat ⇒ one ``fusion_seqpool_concat``
    (ref ir/seqpool_concat_fuse_pass.cc).  A graph rewrite only: the port
    has no lowering of ``sequence_pool`` or of the fused op yet."""

    def apply_impl(self, graph: Graph) -> Graph:
        protected = self.protected_vars()
        count = 0
        for cc in list(graph.ops_of_type("concat")):
            if cc not in graph.op_nodes:
                continue
            if cc.op.attrs.get("axis", 1) not in (1, -1):
                continue
            srcs, doomed, ptypes = [], [cc], set()
            ok = True
            for v in cc.inputs:
                if v.name in protected or len(v.outputs) != 1 or \
                        not v.inputs or \
                        not v.inputs[0].is_op("sequence_pool"):
                    ok = False
                    break
                sp = v.inputs[0]
                if sp.op.input("SeqLen"):
                    ok = False     # per-branch lengths stay unfused
                    break
                ptypes.add(sp.op.attrs.get("pooltype", "AVERAGE").upper())
                src = _input_node(sp, "X")
                extra = [o for o in sp.outputs if o is not v]
                if src is None or any(
                        o.outputs or o.name in protected for o in extra):
                    ok = False     # a read or fetched MaxIndex
                    break
                srcs.append(src)
                doomed += [sp, v] + extra
            if not ok or len(srcs) < 2 or len(ptypes) != 1:
                continue
            out_node = cc.outputs[0]
            graph.create_op_node(
                "fusion_seqpool_concat",
                inputs={"X": srcs}, outputs={"Out": [out_node]},
                attrs={"pooltype": next(iter(ptypes))})
            graph.safe_remove_nodes(doomed)
            count += 1
        graph.attrs["seqpool_concat_fuse_count"] = count
        return graph


def _match_fc_proj(g, protected):
    """The act-free fc (in_num_col_dims 2, a persistable weight) producing
    ``g``'s Input projection: (fc, proj, x, w, bias) or None."""
    proj = _input_node(g, "Input")
    if proj is None or proj.name in protected or len(proj.outputs) != 1:
        return None
    fc = _sole_producer(proj, "fc")
    if fc is None or fc.op.attrs.get("activation_type") or \
            int(fc.op.attrs.get("in_num_col_dims", 1)) != 2:
        return None
    x_node = _input_node(fc, "Input")
    w_node = _input_node(fc, "W")
    b_fc = _input_node(fc, "Bias")
    if x_node is None or w_node is None or not w_node.persistable:
        return None
    return fc, proj, x_node, w_node, b_fc


def _rnn_struct_outs(g, keep_slots, protected):
    """``g``'s outputs in ``keep_slots``, and the others (its batch
    buffers), which must be dead for the rewrite: (outs, doomed) or
    None."""
    outs, doomed = {}, []
    for v in g.outputs:
        slot = next((s for s in keep_slots
                     if g.op.output(s) and v.name in g.op.output(s)), None)
        if slot is not None:
            outs[slot] = v
        elif v.outputs or v.name in protected:
            return None
        else:
            doomed.append(v)
    if set(outs) != set(keep_slots):
        return None
    return outs, doomed


class _FCRNNFuseBase(Pass):
    """fc → {gru,lstm} ⇒ {fusion_gru,fusion_lstm} (ref
    ir/fc_gru_fuse_pass.cc, ir/fc_lstm_fuse_pass.cc).  The fc bias folds
    into the gate bias, which needs ``scope=``.  A graph rewrite only: the
    port has no lowering of ``gru``, ``lstm`` or the fused ops yet."""

    RNN = ""
    FUSED = ""
    OUTS = ()

    def apply_impl(self, graph: Graph) -> Graph:
        scope = self.get("scope")
        protected = self.protected_vars()
        count = 0
        for g in list(graph.ops_of_type(self.RNN)):
            if g not in graph.op_nodes:
                continue
            m = _match_fc_proj(g, protected)
            if m is None:
                continue
            fc, proj, x_node, w_node, b_fc = m
            bg_node = _input_node(g, "Bias")
            if b_fc is not None and bg_node is not None and scope is None:
                continue        # the bias fold needs the values
            so = _rnn_struct_outs(g, self.OUTS, protected)
            if so is None:
                continue        # a batch buffer something reads
            outs, dead_outs = so
            # the fused gate bias: the rnn's, plus fc's over the gate
            # prefix (a peephole tail is untouched)
            bias_nodes = None
            doomed_bias = []
            if b_fc is not None and bg_node is not None:
                bg = _host_f64(scope, bg_node.name)
                bf = _host_f64(scope, b_fc.name).reshape(-1)
                fused = bg.copy()
                fused.reshape(-1)[:bf.size] += bf
                name = outs[self.OUTS[0]].name + ".fused_gate_bias"
                node = graph.create_var_node(
                    name, shape=tuple(bg.shape), dtype="float32",
                    persistable=True)
                _set_f32(scope, name, fused, bg_node.name)
                bias_nodes = [node]
                doomed_bias = [
                    n for n in (b_fc, bg_node)
                    if all(c in (fc, g) for c in n.outputs) and
                    not _referenced_outside_block0(graph.program, n.name)]
                for n in doomed_bias:   # dead params leave the scope too
                    scope.erase(n.name)
            elif b_fc is not None:
                bias_nodes = [b_fc]
            elif bg_node is not None:
                bias_nodes = [bg_node]
            inputs = {"X": [x_node], "WeightX": [w_node],
                      "WeightH": [_input_node(g, "Weight")]}
            if bias_nodes:
                inputs["Bias"] = bias_nodes
            for slot in ("H0", "C0", "SeqLen"):
                n = _input_node(g, slot)
                if n is not None:
                    inputs[slot] = [n]
            graph.create_op_node(
                self.FUSED, inputs=inputs,
                outputs={s: [outs[s]] for s in self.OUTS},
                attrs=dict(g.op.attrs))
            graph.safe_remove_nodes([fc, proj, g] + doomed_bias +
                                    dead_outs)
            count += 1
        graph.attrs[self.name.replace("_pass", "") + "_count"] = count
        return graph


@register_pass("fc_gru_fuse_pass")
class FCGRUFusePass(_FCRNNFuseBase):
    RNN, FUSED, OUTS = "gru", "fusion_gru", ("Hidden",)


@register_pass("fc_lstm_fuse_pass")
class FCLSTMFusePass(_FCRNNFuseBase):
    RNN, FUSED, OUTS = "lstm", "fusion_lstm", ("Hidden", "Cell")


@register_pass("embedding_fc_lstm_fuse_pass")
class EmbeddingFCLSTMFusePass(Pass):
    """lookup_table → fc → lstm ⇒ ``fused_embedding_fc_lstm`` with the
    table pre-multiplied, emb·W_fc + b_fc a row (ref
    ir/embedding_fc_lstm_fuse_pass.cc).  Needs ``scope=``.  A graph
    rewrite only: the port has no lowering of ``lstm`` or the fused op
    yet."""

    def apply_impl(self, graph: Graph) -> Graph:
        scope = self.get("scope")
        if scope is None:
            raise ValueError("embedding_fc_lstm_fuse_pass needs scope= "
                             "to pre-multiply the embedding table")
        protected = self.protected_vars()
        count = 0
        for g in list(graph.ops_of_type("lstm")):
            if g not in graph.op_nodes:
                continue
            m = _match_fc_proj(g, protected)
            if m is None:
                continue
            fc, proj, emb_out, w_node, b_fc = m
            if emb_out.name in protected or len(emb_out.outputs) != 1:
                continue
            lt = None
            for t in ("lookup_table", "lookup_table_v2"):
                lt = lt or _sole_producer(emb_out, t)
            if lt is None:
                continue
            pad = lt.op.attrs.get("padding_idx", -1)
            if pad not in (-1, None):
                # a padding row embeds to zeros before the projection;
                # the pre-multiplied row would carry b_fc
                continue
            emb_w = _input_node(lt, "W")
            ids = _input_node(lt, "Ids")
            if emb_w is None or not emb_w.persistable:
                continue
            if any(c is not lt for c in emb_w.outputs):
                continue        # a shared table stays
            so = _rnn_struct_outs(g, ("Hidden", "Cell"), protected)
            if so is None:
                continue
            outs, dead_outs = so
            table = _host_f64(scope, emb_w.name) @ \
                _host_f64(scope, w_node.name)
            if b_fc is not None:
                table = table + _host_f64(scope, b_fc.name).reshape(1, -1)
            name = outs["Hidden"].name + ".premul_embeddings"
            tbl_node = graph.create_var_node(
                name, shape=tuple(table.shape), dtype="float32",
                persistable=True)
            _set_f32(scope, name, table, emb_w.name)
            inputs = {"Ids": [ids], "Embeddings": [tbl_node],
                      "WeightH": [_input_node(g, "Weight")]}
            bg = _input_node(g, "Bias")
            if bg is not None:
                inputs["Bias"] = [bg]
            for slot in ("H0", "C0", "SeqLen"):
                n = _input_node(g, slot)
                if n is not None:
                    inputs[slot] = [n]
            graph.create_op_node(
                "fused_embedding_fc_lstm", inputs=inputs,
                outputs={"Hidden": [outs["Hidden"]],
                         "Cell": [outs["Cell"]]},
                attrs=dict(g.op.attrs))
            doomed = [lt, emb_out, fc, proj, g] + dead_outs
            for n in (emb_w, w_node, b_fc):
                # consumed params leave graph and scope, unless a
                # sub-block the Graph cannot see shares them
                if n is not None and \
                        all(c in (lt, fc) for c in n.outputs) and \
                        not _referenced_outside_block0(graph.program,
                                                       n.name):
                    doomed.append(n)
                    scope.erase(n.name)
            graph.safe_remove_nodes(doomed)
            count += 1
        graph.attrs["embedding_fc_lstm_fuse_count"] = count
        return graph


@register_pass("conv_elementwise_add_act_fuse_pass")
class ConvEltwiseAddActFusePass(Pass):
    """conv2d → elementwise_add(per-channel bias) → act ⇒ ``conv2d_fusion``
    (ref ir/conv_elementwise_add_act_fuse_pass.cc).  Runs before
    fuse_elewise_add_act_pass, which would take the add → act tail."""

    ACTS = ("relu", "sigmoid", "tanh")

    def apply_impl(self, graph: Graph) -> Graph:
        protected = self.protected_vars()
        count = 0
        for conv in list(graph.ops_of_type("conv2d")):
            if conv not in graph.op_nodes:
                continue
            conv_out = _output_node(conv, "Output")
            if conv_out is None or conv_out.name in protected or \
                    len(conv_out.outputs) != 1:
                continue
            add = conv_out.outputs[0]
            if not add.is_op("elementwise_add") or \
                    int(add.op.attrs.get("axis", -1)) != 1:
                continue
            bias = _input_node(add, "Y")
            if bias is None or not bias.persistable or \
                    bias.var is None or len(bias.var.shape or ()) != 1:
                continue
            add_out = _output_node(add, "Out")
            if add_out is None or add_out.name in protected or \
                    len(add_out.outputs) != 1:
                continue
            act = add_out.outputs[0]
            if not act.is_op() or act.name not in self.ACTS:
                continue
            out_node = act.outputs[0]
            attrs = dict(conv.op.attrs)
            attrs["activation"] = act.name
            graph.create_op_node(
                "conv2d_fusion",
                inputs={"Input": [_input_node(conv, "Input")],
                        "Filter": [_input_node(conv, "Filter")],
                        "Bias": [bias]},
                outputs={"Output": [out_node]}, attrs=attrs)
            graph.safe_remove_nodes([conv, conv_out, add, add_out, act])
            count += 1
        graph.attrs["conv_elementwise_add_act_fuse_count"] = count
        return graph


@register_pass("seqconv_eltadd_relu_fuse_pass")
class SeqConvEltAddReluFusePass(Pass):
    """sequence_conv → elementwise_add(bias) → relu ⇒
    ``fusion_seqconv_eltadd_relu`` (ref
    ir/seqconv_eltadd_relu_fuse_pass.cc).  A graph rewrite only: the port
    has no lowering of ``sequence_conv`` or of the fused op yet."""

    def apply_impl(self, graph: Graph) -> Graph:
        protected = self.protected_vars()
        count = 0
        for sc in list(graph.ops_of_type("sequence_conv")):
            if sc not in graph.op_nodes:
                continue
            if int(sc.op.attrs.get("contextStride", 1)) != 1:
                continue
            sc_out = _output_node(sc, "Out")
            if sc_out is None or sc_out.name in protected or \
                    len(sc_out.outputs) != 1:
                continue
            add = sc_out.outputs[0]
            if not add.is_op("elementwise_add"):
                continue
            bias = _input_node(add, "Y")
            if bias is None or not bias.persistable or \
                    bias.var is None or len(bias.var.shape or ()) != 1 or \
                    int(add.op.attrs.get("axis", -1)) != 2:
                continue        # only the 1-D per-filter feature bias
            add_out = _output_node(add, "Out")
            if add_out is None or add_out.name in protected or \
                    len(add_out.outputs) != 1:
                continue
            relu = add_out.outputs[0]
            if not relu.is_op("relu"):
                continue
            out_node = relu.outputs[0]
            graph.create_op_node(
                "fusion_seqconv_eltadd_relu",
                inputs={"X": [_input_node(sc, "X")],
                        "Filter": [_input_node(sc, "Filter")],
                        "Bias": [bias]},
                outputs={"Out": [out_node]},
                attrs={"contextLength":
                       sc.op.attrs.get("contextLength", 3),
                       "contextStart": sc.op.attrs.get("contextStart", 0)})
            graph.safe_remove_nodes([sc, sc_out, add, add_out, relu])
            count += 1
        graph.attrs["seqconv_eltadd_relu_fuse_count"] = count
        return graph


@register_pass("conv_bn_fuse_pass")
class ConvBNFusePass(Pass):
    """conv2d + batch_norm(is_test) → conv2d + an elementwise_add of the
    folded bias (ref ir/conv_bn_fuse_pass.cc).  W' = W·(γ/σ) per output
    channel and b' = β − μ·γ/σ, folded in float64 from the scope's values
    (``scope=``) and stored back as float32 on the filter's device."""

    def apply_impl(self, graph: Graph) -> Graph:
        scope = self.get("scope")
        if scope is None:
            raise ValueError("conv_bn_fuse_pass needs scope= with param "
                             "values to fold numerically")
        count = 0
        for bn in list(graph.ops_of_type("batch_norm")):
            if bn not in graph.op_nodes:
                continue
            if not bn.op.attrs.get("is_test") and \
                    not bn.op.attrs.get("use_global_stats"):
                continue
            conv_out = next((v for v in bn.inputs
                             if v.inputs and v.inputs[0].is_op("conv2d")),
                            None)
            if conv_out is None or len(conv_out.outputs) != 1:
                continue
            conv = conv_out.inputs[0]
            w_node = next((v for v in conv.inputs if v.persistable), None)
            if w_node is None:
                continue        # no plain persistable filter to fold into
            if any(c is not conv for c in w_node.outputs):
                continue        # a shared filter's other readers
            by_name = {v.name: v for v in bn.inputs}
            op = bn.op
            scale_n = op.input("Scale")[0]
            bias_n = op.input("Bias")[0]
            mean_n = op.input("Mean")[0]
            var_n = op.input("Variance")[0]
            eps = op.attrs.get("epsilon", 1e-5)
            gamma = _host_f64(scope, scale_n)
            beta = _host_f64(scope, bias_n)
            mu = _host_f64(scope, mean_n)
            var = _host_f64(scope, var_n)
            w = _host_f64(scope, w_node.name)
            factor = gamma / np.sqrt(var + eps)       # [out_c]
            _set_f32(scope, w_node.name, w * factor.reshape(-1, 1, 1, 1),
                     w_node.name)
            fused_bias_name = op.output("Y")[0] + ".conv_bn_bias"
            bias_node = graph.create_var_node(
                fused_bias_name, shape=(len(factor),), dtype="float32",
                persistable=True)
            _set_f32(scope, fused_bias_name, beta - mu * factor,
                     w_node.name)
            y_node = next(v for v in bn.outputs
                          if v.name in op.output("Y"))
            graph.create_op_node(
                "elementwise_add",
                inputs={"X": [conv_out], "Y": [bias_node]},
                outputs={"Out": [y_node]},
                attrs={"axis": 1})
            # the statistics outputs die with the bn node
            doomed = [bn] + [v for v in bn.outputs if v is not y_node]
            doomed += [by_name[n] for n in
                       (scale_n, bias_n, mean_n, var_n)
                       if n in by_name and
                       all(c is bn for c in by_name[n].outputs)]
            graph.safe_remove_nodes(doomed)
            count += 1
        graph.attrs["conv_bn_fuse_count"] = count
        return graph


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


#: host RPC ops that run in their program order among themselves
ORDERED_OPS = frozenset({
    "send", "recv", "distributed_lookup_table", "fetch_barrier",
    "send_barrier", "listen_and_serv",
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


# ---------------------------------------------------------------------------
# Graph viz / round-trip passes
# ---------------------------------------------------------------------------

@register_pass("graph_viz_pass")
class GraphVizPass(Pass):
    """DOT dump (ref ir/graph_viz_pass.cc) into
    ``graph.attrs['graph_viz_dot']``, and into the file the
    ``graph_viz_path`` attr names."""

    def apply_impl(self, graph: Graph) -> Graph:
        lines = ["digraph G {", "  rankdir=TB;"]
        for op in graph.all_op_nodes():
            lines.append(
                f'  n{op.id} [label="{op.name}" shape=box '
                f'style=filled fillcolor="#ffd39b"];')
        highlights = frozenset(self.get("highlights") or ())
        for v in graph.all_var_nodes():
            fill = "#f4adad" if v.name in highlights else \
                "#c0d9ee" if not v.persistable else "#b5e7b5"
            lines.append(
                f'  n{v.id} [label="{v.name}" shape=ellipse '
                f'style=filled fillcolor="{fill}"];')
        for n in graph.all_op_nodes() + graph.all_var_nodes():
            for o in n.outputs:
                lines.append(f"  n{n.id} -> n{o.id};")
        lines.append("}")
        dot = "\n".join(lines)
        graph.attrs["graph_viz_dot"] = dot
        path = self.get("graph_viz_path")
        if path:
            with open(path, "w") as f:
                f.write(dot)
        return graph


@register_pass("graph_to_program_pass")
class GraphToProgramPass(Pass):
    """Graph → Program (ref ir/graph_to_program_pass.cc), into
    ``graph.attrs['program']``."""

    def apply_impl(self, graph: Graph) -> Graph:
        graph.attrs["program"] = graph.to_program()
        return graph
