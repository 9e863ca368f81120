"""Activation rematerialization as a program transform (the port's
``paddle_tpu/framework/recompute.py``).

``apply_recompute(program, checkpoints)`` rewrites a program AFTER
``append_backward``, as the reference does:

1. the forward ops between consecutive checkpoint vars form segments;
2. each segment is re-emitted in the backward region with every
   intermediate renamed ``v@RECOMPUTE``, reading segment inputs through an
   ``optimization_barrier`` (``v@RBAR``);
3. backward ops are rewired to consume the ``@RECOMPUTE`` values.

The ops, names and attributes are the reference's.  One thing differs: the
position of the recomputed chains.  The reference puts them all right after
the loss-grad seed, since XLA schedules by dataflow.  The port's executor
runs ops in list order and keeps each differentiated forward's autograd
graph until its grad op takes it, so chains placed together would all be
alive before the first backward op.  Here each segment's chain (its
clones) sits just before the first backward op that reads one of its
values or the gradient of one of its outputs: the segments come back in
reverse order, one at a time.  A barrier sits before the first chain to
run that reads it.

RNG-stateful ops are NOT recomputed UNLESS their draw is replay-safe:
tagged dropout (a nonzero ``seed`` attr) derives its bits purely from
(run seed, tag), so re-evaluating it reproduces the identical mask and it
recomputes like any pure op.  Counter-stream RNG ops (untagged dropout, …)
would re-draw differently, so their outputs stay stored and feed the
recomputed chain through barriers.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from . import registry
from .core import Operator, Program, grad_var_name

RECOMPUTE_SUFFIX = "@RECOMPUTE"
BARRIER_SUFFIX = "@RBAR"
# the program attr marking a recomputed program (``RecomputeOptimizer``'s
# guard in the reference); ``Program.clone`` carries it, and
# ``ir.Graph.to_program`` keeps such a program's order
RECOMPUTED_ATTR = "__recompute__"


def _is_rng_op(op: Operator) -> bool:
    if op.type == "dropout" and op.attrs.get("seed", 0):
        return False     # tagged dropout replays bit-identically — pure
    info = registry._REGISTRY.get(op.type)
    return bool(info and info.stateful_rng)


def source_name(name: str) -> str:
    """The forward value a recompute name stands for: ``v`` for
    ``v@RECOMPUTE``, ``v@RECOMPUTE@DEAD`` and ``v@RBAR``; other names are
    their own source."""
    name = name.split(RECOMPUTE_SUFFIX)[0]
    return name[:-len(BARRIER_SUFFIX)] if name.endswith(BARRIER_SUFFIX) \
        else name


def is_recomputed(program: Program) -> bool:
    return bool(program._attrs.get(RECOMPUTED_ATTR))


def dead_barriers(ops: Sequence[Operator], fetch_names=()) -> List[Operator]:
    """The ``optimization_barrier`` ops of ``ops`` whose output no op reads
    and no fetch takes.  The transform fences every stored input of a
    cloned op, as the reference does, and under XLA the unread barriers
    vanish; run, one would keep its source alive from the forward pass
    into the backward one, and be a consumer that blocks the fusion of an
    original chain."""
    read = set(fetch_names).union(*(op.input_arg_names() for op in ops))
    return [op for op in ops if op.type == "optimization_barrier"
            and not read.intersection(op.output_arg_names())]


def apply_recompute(program: Program,
                    checkpoints: Sequence[str]) -> Program:
    """Rewrite IN PLACE; returns the program, marked ``RECOMPUTED_ATTR``.
    ``checkpoints`` are forward var names (segment boundaries) that stay
    stored."""
    block = program.global_block()
    ckpt = set(checkpoints)
    loss_seed = None
    for i, op in enumerate(block.ops):
        if op.type == "fill_constant" and any(
                n.endswith("@GRAD") for n in op.output_arg_names()):
            loss_seed = i
            break
    if loss_seed is None:
        raise ValueError("apply_recompute needs a program with backward "
                         "ops (call minimize()/append_backward first)")

    fwd_ops = block.ops[:loss_seed]
    bwd_ops = block.ops[loss_seed:]

    # vars the backward actually reads from the forward
    bwd_reads = set()
    for op in bwd_ops:
        bwd_reads.update(op.input_arg_names())

    # choose ops to recompute: forward ops after the FIRST checkpoint,
    # excluding RNG ops (their outputs stay stored — re-drawing a dropout
    # mask would silently change gradients)
    rename: Dict[str, str] = {}
    recompute_ops: List[Operator] = []
    barriered: Dict[str, str] = {}
    # segment of each clone and of each barrier (the segment whose clone
    # first read it); segment k ends with the op writing checkpoint k + 1
    clone_seg: List[int] = []
    barrier_seg: Dict[str, int] = {}
    seg = -1

    def barrier_name(v):
        # parameters/persistables are never fenced (the reference's rule:
        # they are jit arguments there)
        var = block.vars.get(v)
        if var is not None and var.persistable:
            return v
        if v not in barriered:
            barriered[v] = v + BARRIER_SUFFIX
            barrier_seg[v] = seg
        return barriered[v]

    for op in fwd_ops:
        outs = op.output_arg_names()
        ends_segment = bool(ckpt & set(outs))
        if seg >= 0 and not _is_rng_op(op) and op.type != "feed":
            needed = any(o in bwd_reads and o not in ckpt for o in outs)
            feeds_chain = any(o in rename for o in op.input_arg_names())
            if needed or feeds_chain:
                # clone with renamed inputs/outputs; every stored value
                # entering the chain passes through a barrier (evaluated
                # for every input, as the reference does: a barrier no
                # clone reads is left for the executor to skip)
                clone = Operator(block, op.type, attrs=dict(op.attrs))
                clone.inputs = {
                    slot: [rename.get(n, barrier_name(n) if n else n)
                           for n in names]
                    for slot, names in op.inputs.items()}
                clone.outputs = {}
                for slot, names in op.outputs.items():
                    new = []
                    for n in names:
                        if not n:
                            new.append(n)
                        elif n in ckpt:
                            # checkpoints stay stored: the clone's copy is
                            # dead; chain reads hit the barrier'd original
                            new.append(n + RECOMPUTE_SUFFIX + "@DEAD")
                        else:
                            rename[n] = n + RECOMPUTE_SUFFIX
                            new.append(rename[n])
                    clone.outputs[slot] = new
                recompute_ops.append(clone)
                clone_seg.append(seg)
        if ends_segment:
            seg += 1

    if not recompute_ops:
        return program

    # materialize barrier ops + vars
    barrier_ops: Dict[str, Operator] = {}
    for src, dst in barriered.items():
        if not block.has_var(dst):
            v = block.var(src) if block.has_var(src) else None
            block.create_var(name=dst, shape=v.shape if v else None,
                             dtype=v.dtype if v else "float32")
        barrier_ops[src] = Operator(block, "optimization_barrier",
                                    inputs={"X": [src]},
                                    outputs={"Out": [dst]})
    for clone in recompute_ops:
        for names in clone.outputs.values():
            for dst in names:
                if dst and not block.has_var(dst):
                    src = dst.split(RECOMPUTE_SUFFIX)[0]
                    v = block.var(src) if block.has_var(src) else None
                    block.create_var(name=dst,
                                     shape=v.shape if v else None,
                                     dtype=v.dtype if v else "float32")

    # rewire backward reads onto the recomputed values
    for op in bwd_ops:
        for slot, names in op.inputs.items():
            op.inputs[slot] = [rename.get(n, n) for n in names]

    block.ops = fwd_ops + [bwd_ops[0]] + _place_chains(
        bwd_ops[1:], recompute_ops, clone_seg, barrier_ops, barrier_seg)
    program._attrs[RECOMPUTED_ATTR] = True
    program._bump_version()
    return program


def _place_chains(bwd_rest, clones, clone_seg, barrier_ops, barrier_seg):
    """``bwd_rest`` with each segment's chain (its clones, in the
    reference's order) inserted just before the first op that reads a
    value of the chain or the gradient of one of its outputs; a chain
    nothing reads stays at the front, the reference's place.  A chain
    reading another segment's values is placed no later than it.  Each
    barrier goes just before the first chain to run that reads it: a
    stored value several segments read (a fed attention bias) is fenced
    once, for all of them.  A barrier no clone reads stays with the
    segment whose clone made it."""
    segs = sorted(set(clone_seg))
    chain = {s: [] for s in segs}
    made = {s: set() for s in segs}
    for clone, s in zip(clones, clone_seg):
        chain[s].append(clone)
        made[s].update(n for n in clone.output_arg_names() if n)
    pos = {}
    for s in segs:
        wanted = made[s] | {grad_var_name(source_name(n)) for n in made[s]}
        pos[s] = next((i for i, op in enumerate(bwd_rest)
                       if wanted.intersection(op.input_arg_names())), 0)
    reads = {s: {n for op in chain[s] for n in op.input_arg_names()}
             for s in segs}
    for s in reversed(segs):
        for j in segs:
            if j != s and made[j] & reads[s]:
                pos[j] = min(pos[j], pos[s])
    fences: Dict[int, List[Operator]] = {s: [] for s in segs}
    for src, bar in barrier_ops.items():
        readers = [s for s in segs if bar.output("Out")[0] in reads[s]]
        first = min(readers, key=lambda s: (pos[s], s)) if readers \
            else barrier_seg[src]
        fences[first].append(bar)
    at: Dict[int, List[Operator]] = {}
    for s in segs:          # at one position: fences first, then chains
        at.setdefault(pos[s], []).extend(fences[s])
    for s in segs:
        at[pos[s]].extend(chain[s])
    out: List[Operator] = []
    for i, op in enumerate(bwd_rest):
        out.extend(at.pop(i, []))
        out.append(op)
    for ops in at.values():     # no backward op after the seed
        out.extend(ops)
    return out
