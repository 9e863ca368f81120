"""Program-level autodiff: synthesize grad ops into the Program.

The port's copy of ``paddle_tpu/framework/backward.py`` (ref
``python/paddle/fluid/backward.py:558`` append_backward): reverse-walk the
ops that contribute to the loss, ask each op's grad maker for grad op descs
(``registry.make_grad_ops`` — generic, ``torch.autograd``-backed, unless an
op registers a custom maker), rename+sum gradients of multi-consumer vars
(ref ``_addup_repetitive_outputs_``), and append the resulting ops to the
block.  Grad vars use the ``<name>@GRAD`` convention (ref
``framework/operator.h:57``).  The ops, names and attrs it appends are the
reference's, so the two packages serialize the same training program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import registry
from .core import Block, Operator, Program, Variable, grad_var_name


def _relevant_ops(block: Block, loss: Variable,
                  no_grad_set: Set[str]) -> Tuple[List[int], Set[str]]:
    """Backward slice: indices of ops on a path to ``loss`` plus the set of
    vars that need gradients."""
    needed: Set[str] = {loss.name}
    relevant: List[int] = []
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if registry.has_op(op.type) and registry.get_op_info(op.type).no_grad:
            continue
        if needed & set(op.output_arg_names()):
            relevant.append(i)
            for n in op.input_arg_names():
                if n and n not in no_grad_set:
                    v = block.var(n) if block.has_var(n) else None
                    if v is not None and v.stop_gradient:
                        continue
                    needed.add(n)
    relevant.reverse()
    return relevant, needed


def append_backward(loss: Variable,
                    parameter_list: Optional[Sequence] = None,
                    no_grad_set: Optional[Set[str]] = None,
                    callbacks=None) -> List[Tuple[Variable, Variable]]:
    """Append grad ops for ``loss``; return [(param, param@GRAD)] pairs."""
    block = loss.block.program.global_block()
    program = block.program
    no_grad = set(no_grad_set or ())
    for v in block.vars.values():
        if v.stop_gradient and not v.is_parameter:
            no_grad.add(v.name)
        elif v.dtype is not None and v.dtype not in (
                "float16", "bfloat16", "float32", "float64"):
            # integer/bool vars carry no gradient (the reference's
            # OpKernelType dispatch never registers grad kernels for them;
            # torch.autograd refuses them)
            no_grad.add(v.name)

    relevant, needed = _relevant_ops(block, loss, no_grad)

    # every op appended below is training-only: tag it so
    # clone(for_test=True) prunes the backward tail (ref OpRole::kBackward)
    with program._op_role_guard("backward"):
        return _append_backward_tagged(block, program, loss, no_grad,
                                       relevant, needed, parameter_list)


def _append_backward_tagged(block, program, loss, no_grad, relevant, needed,
                            parameter_list):
    # seed: d loss / d loss = 1  (ref backward.py _append_loss_ops /
    # ScaleLossGradOpHandle with coeff 1 on a single device)
    loss_g_name = grad_var_name(loss.name)
    block.create_var(name=loss_g_name, shape=loss.shape, dtype=loss.dtype,
                     stop_gradient=True)
    block.append_op(
        "fill_constant", outputs={"Out": [loss_g_name]},
        attrs={"shape": list(loss.shape or ()), "dtype": loss.dtype,
               "value": 1.0})

    # generate grad descs in reverse order
    descs: List[Dict] = []
    have_grad: Set[str] = {loss_g_name}
    for i in reversed(relevant):
        op = block.ops[i]
        # only if some output's grad exists
        if not any(grad_var_name(n) in have_grad
                   for n in op.output_arg_names()):
            continue
        # only if some input needs a grad
        if not any(n in needed and n not in no_grad
                   for n in op.input_arg_names()):
            continue
        for d in registry.make_grad_ops(op, block, no_grad):
            descs.append(d)
            for names in d["outputs"].values():
                for n in names:
                    if n:
                        have_grad.add(n)

    # Resolve grad dataflow: sum parallel contributions (ref backward.py
    # _addup_repetitive_outputs_) AND version in-place redefinitions (ref
    # _rename_grad_ for in-place ops).  A desc that consumes grad name N
    # and produces N again (while_grad on a carried var) REPLACES the
    # value — its output gets a fresh version and later consumers read
    # that version; plain producers of the current version are summands,
    # materialized right before the first desc that reads them.
    ver: Dict[str, int] = {}

    def rd(n):
        v = ver.get(n, 0)
        return n if v == 0 else f"{n}@V{v}"

    # contribs[n]: pending summands of the CURRENT version of grad n —
    # ("site", di, slot, j) for a desc output not yet renamed, or
    # ("value", name) once a reader has materialized the sum.  Within one
    # version every contribution precedes the first reader (descs are
    # generated in reverse op order), so a contribution arriving AFTER a
    # read can only mean the forward program redefined the var in place
    # without a gradient-redefining op — numerically ambiguous, raised
    # loudly below rather than silently mis-summed.
    contribs: Dict[str, List[tuple]] = {}
    sums_before: Dict[int, List[Tuple[str, List[str]]]] = {}
    end_sums: List[Tuple[str, List[str]]] = []
    end_assigns: List[Tuple[str, str]] = []

    def _materialize(n, at_di):
        """Collapse this version's pending summands into one value."""
        entries = contribs.get(n)
        if not entries:
            return
        if len(entries) == 1:
            if entries[0][0] == "site":
                contribs[n] = [("value", rd(n))]
            return
        parts, k = [], 0
        for e in entries:
            if e[0] == "value":
                parts.append(e[1])
            else:
                _, pi, slot, j = e
                pn = f"{rd(n)}@RENAME@{k}"
                k += 1
                descs[pi]["outputs"][slot][j] = pn
                parts.append(pn)
        if at_di is None:
            end_sums.append((rd(n), parts))
        else:
            sums_before.setdefault(at_di, []).append((rd(n), parts))
        contribs[n] = [("value", rd(n))]

    for di, d in enumerate(descs):
        raw_ins = {n for names in d["inputs"].values() for n in names if n}
        for n in raw_ins:
            _materialize(n, di)
        for slot, names in d["inputs"].items():
            d["inputs"][slot] = [rd(n) if n else n for n in names]
        for slot, names in d["outputs"].items():
            for j, n in enumerate(names):
                if not n:
                    continue
                if n in raw_ins and contribs.get(n):
                    # redefinition: new version, sole producer so far
                    ver[n] = ver.get(n, 0) + 1
                    d["outputs"][slot][j] = rd(n)
                    contribs[n] = [("site", di, slot, j)]
                else:
                    entries = contribs.setdefault(n, [])
                    if entries and entries[0][0] == "value":
                        raise ValueError(
                            f"gradient contribution to {n!r} arrives after "
                            "a grad op already read it: the forward "
                            "program overwrites this variable in place "
                            "(e.g. assign with an existing output) between "
                            "reads, which makes its gradient ambiguous — "
                            "write the second value to a fresh variable")
                    d["outputs"][slot][j] = rd(n)
                    entries.append(("site", di, slot, j))

    for n in list(contribs):
        _materialize(n, None)          # unconsumed summands (param grads)
        if rd(n) != n:
            # optimizers look up the canonical <name>@GRAD
            end_assigns.append((n, rd(n)))

    # append to block, materializing grad vars
    def _append_sum(name, parts):
        if not block.has_var(name):
            src = block.var(parts[0]) if block.has_var(parts[0]) else None
            block.create_var(name=name,
                             shape=src.shape if src else None,
                             dtype=src.dtype if src else "float32",
                             stop_gradient=True)
        block.append_op("sum", inputs={"X": parts},
                        outputs={"Out": [name]})

    appended: List[Operator] = []
    for di, d in enumerate(descs):
        for name, parts in sums_before.get(di, []):
            _append_sum(name, parts)
        _ensure_grad_vars(block, d)
        op = Operator(block, d["type"], None, None, d["attrs"])
        op.inputs = d["inputs"]
        op.outputs = d["outputs"]
        block.ops.append(op)
        program._bump_version()
        appended.append(op)
    for name, parts in end_sums:
        _append_sum(name, parts)
    for target, src in end_assigns:
        if not block.has_var(target):
            sv = block.var(src) if block.has_var(src) else None
            block.create_var(name=target,
                             shape=sv.shape if sv else None,
                             dtype=sv.dtype if sv else "float32",
                             stop_gradient=True)
        block.append_op("assign", inputs={"X": [src]},
                        outputs={"Out": [target]})

    # collect (param, grad) pairs
    if parameter_list is not None:
        params = [p if isinstance(p, Variable) else block.var(p)
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]
    result = []
    for p in params:
        gname = grad_var_name(p.name)
        if block.has_var(gname):
            gv = block.var(gname)
            if gv.shape is None:
                gv.shape, gv.dtype = p.shape, p.dtype
            result.append((p, gv))
    return result


def _ensure_grad_vars(block: Block, desc: Dict) -> None:
    """Create Variables for a grad desc's args, inferring metadata from the
    forward var where the @GRAD convention applies."""
    for names in list(desc["inputs"].values()) + list(desc["outputs"].values()):
        for n in names:
            if not n or block.has_var(n):
                continue
            base = n.split("@GRAD")[0] if "@GRAD" in n else None
            if base and block.has_var(base):
                fv = block.var(base)
                block.create_var(name=n, shape=fv.shape, dtype=fv.dtype,
                                 stop_gradient=True)
            else:
                block.create_var(name=n, stop_gradient=True)


def calc_gradient(targets, inputs, target_gradients=None,
                  no_grad_set=None):
    """ref backward.py:820 — gradients of ``targets`` w.r.t. ``inputs``."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if len(targets) != 1:
        raise NotImplementedError("calc_gradient supports a single target")
    append_backward(targets[0], no_grad_set=no_grad_set)
    block = targets[0].block.program.global_block()
    outs = []
    for iv in inputs:
        g = grad_var_name(iv.name)
        outs.append(block.var(g) if block.has_var(g) else None)
    return outs


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)
