"""Control-flow layers (the port's ``paddle_tpu/layers/control_flow.py``,
ref ``python/paddle/fluid/layers/control_flow.py``).

The comparison and counter layers, tensor arrays, ``While``, ``Switch``,
``IfElse``, ``StaticRNN``, ``DynamicRNN`` and ``Print``.  They build the
reference's op descs over sub-blocks; the port's executor runs a
sub-block eagerly, an iteration at a time (``ops/control_flow_ops.py``).
As in the reference, a loop body is shape-static; gradients flow through
``StaticRNN`` / ``DynamicRNN`` and through a ``While`` given a
``max_trip_count``, not through an unbounded ``While``.
"""

from __future__ import annotations

from ..framework import unique_name
from ..framework.core import Variable, default_main_program
from ..layer_helper import LayerHelper
from . import tensor


def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", True)
    helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"step": float(value)})
    return out


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", True)
    helper.append_op("is_empty", inputs={"X": [x]}, outputs={"Out": [cond]})
    return cond


class While:
    """``while cond: body`` over a sub-block (ref control_flow.py While,
    operators/controlflow/while_op.cc:43).

    Unbounded by default, and then forward-only, as the reference's
    ``lax.while_loop``; with ``max_trip_count=N`` at most N iterations,
    and differentiable: ``while_grad`` replays the loop from a snapshot of
    its carried values (the reference's ``WhileGradOp``,
    while_op.cc:312).  The loop must end within N trips; a truncated one
    prints a warning.
    """

    def __init__(self, cond, is_test=False, name=None,
                 max_trip_count=None):
        self.cond_var = cond
        self.program = default_main_program()
        self.helper = LayerHelper("while", name=name)
        self.max_trip_count = max_trip_count

    def block(self):
        return _WhileBlockGuard(self)


def _collect_io(block):
    """(reads, writes) over a block INCLUDING nested sub-blocks — a Switch
    inside a While reads/writes through a conditional_block whose body the
    outer capture analysis must see."""
    reads, writes = set(), set()
    for op in block.ops:
        reads.update(op.input_arg_names())
        writes.update(op.output_arg_names())
        for val in op.attrs.values():
            if hasattr(val, "ops") and hasattr(val, "vars"):   # a Block
                r, w = _collect_io(val)
                reads.update(r)
                writes.update(w)
    return reads, writes


class _WhileBlockGuard:
    def __init__(self, while_op: While):
        self.while_op = while_op

    def __enter__(self):
        self.block = self.while_op.program._create_block()
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            return False
        program = self.while_op.program
        inner = program.current_block()
        program._rollback()
        parent = program.current_block()
        # loop-carried vars: every var read in the sub-block that lives in the
        # parent and is written in the sub-block, plus the condition var;
        # collection recurses into nested conditional sub-blocks
        read, written = _collect_io(inner)
        # membership must be recursive (has_var) — parent.vars is local-only,
        # and the loop may sit inside another sub-block whose captures live
        # further up the chain
        carried = sorted({n for n in (read | written) if parent.has_var(n)}
                         | {self.while_op.cond_var.name})
        reads = sorted(n for n in read if parent.has_var(n))
        max_trips = self.while_op.max_trip_count
        inputs = {"Condition": [self.while_op.cond_var.name], "X": reads}
        attrs = {"sub_block": inner, "carried_vars": list(carried),
                 "cond_var": self.while_op.cond_var.name}
        if max_trips is not None:
            # differentiable path: snapshot the initial carried values so
            # while_grad can replay the loop (the loop writes carried vars
            # in place, destroying their pre-loop values)
            snaps = []
            for n in carried:
                v = parent.var(n)
                # unique per loop: two Whiles carrying the same var must
                # not share (and overwrite) one snapshot
                snap = parent.create_var(
                    name=unique_name.generate(n + "@WHILE_INIT"),
                    shape=v.shape, dtype=v.dtype)
                parent.append_op("assign", inputs={"X": [n]},
                                 outputs={"Out": [snap.name]}, attrs={})
                snaps.append(snap.name)
            inputs["InitSnapshot"] = snaps
            attrs["max_trip_count"] = int(max_trips)
        parent.append_op("while", inputs=inputs,
                         outputs={"Out": list(carried)}, attrs=attrs)
        return False


def create_array(dtype, max_len=128):
    """TensorArray analog (ref LoDTensorArray / control_flow.create_array):
    a pre-sized dense buffer ``[max_len, ...]`` plus a length scalar, made
    at the first ``array_write``, so it composes with While (the buffer is
    another carried var).  The buffer must receive its first write
    *outside* any While block, so the loop body sees an initialized carry.
    """
    helper = LayerHelper("create_array")
    arr = helper.create_variable_for_type_inference(dtype, True)
    ln = helper.create_variable_for_type_inference("int32", True)
    arr.array_len_var = ln.name
    arr.array_max_len = max_len
    arr.is_tensor_array = True
    arr.array_written = False
    return arr


def array_write(x, i, array=None):
    """ref tensor_array_read_write.cc WriteToArray: a functional update of
    one row of the dense buffer."""
    if array is None:
        array = create_array(x.dtype)
    helper = LayerHelper("array_write")
    inputs = {"X": [x], "I": [i]}
    if getattr(array, "array_written", True):
        inputs["Array"] = [array]
        inputs["ArrayLen"] = [array.array_len_var]
    helper.append_op("array_write", inputs=inputs,
                     outputs={"Out": [array],
                              "OutLen": [array.array_len_var]},
                     attrs={"max_len": getattr(array, "array_max_len", 128)})
    array.array_written = True
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op("array_read", inputs={"Array": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("array_length",
                     inputs={"ArrayLen": [array.array_len_var]},
                     outputs={"Out": [out]})
    return out


class Switch:
    """ref control_flow.py Switch — first-true-case-wins piecewise execution.

    Each ``case`` body runs under a ``conditional_block`` whose predicate is
    ``cond AND NOT any-earlier-cond``; ``default()`` fires when no case did.
    Bodies assign into pre-existing parent vars (the reference's usage, e.g.
    LR scheduling), which become the conditional block's outputs.
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.program = default_main_program()
        self.pre_not_taken = None   # bool var: no earlier case taken

    def case(self, condition):
        return _SwitchCaseGuard(self, condition)

    def default(self):
        return _SwitchCaseGuard(self, None)


class _SwitchCaseGuard:
    def __init__(self, switch, condition):
        self.switch = switch
        self.condition = condition

    def __enter__(self):
        from . import nn
        sw = self.switch
        if self.condition is None:          # default: no earlier case taken
            if sw.pre_not_taken is None:
                raise ValueError("Switch.default() before any case")
            self.pred = sw.pre_not_taken
        elif sw.pre_not_taken is None:      # first case
            self.pred = self.condition
            sw.pre_not_taken = nn.logical_not(self.condition)
        else:
            self.pred = nn.logical_and(sw.pre_not_taken, self.condition)
            sw.pre_not_taken = nn.logical_and(
                sw.pre_not_taken, nn.logical_not(self.condition))
        self.block = self.switch.program._create_block()
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            return False
        program = self.switch.program
        inner = program.current_block()
        program._rollback()
        parent = program.current_block()
        reads, writes = _collect_io(inner)
        written = sorted(n for n in writes if parent.has_var(n))
        parent.append_op(
            "conditional_block",
            # reads declared so an enclosing While's capture analysis sees
            # through this case body
            inputs={"Cond": [self.pred.name],
                    "X": sorted(n for n in reads if parent.has_var(n))},
            outputs={"Out": written},
            attrs={"sub_block": inner})
        return False


class _parent_block:
    """Temporarily redirect layer building to the current block's parent
    (used by StaticRNN/DynamicRNN to build init/index vars outside the
    step sub-block)."""

    def __init__(self, program):
        self.program = program

    def __enter__(self):
        self.saved = self.program._current_block_idx
        self.program._current_block_idx = \
            self.program.current_block().parent_idx
        return self

    def __exit__(self, *a):
        self.program._current_block_idx = self.saved
        return False


class IfElse:
    """Batch-row conditional (ref control_flow.py IfElse over
    split_lod_tensor/merge_lod_tensor).

    Fluid partitions the batch by a bool column and runs each branch on
    its rows; here, as in the reference, both branches run on the whole
    batch and the outputs merge row-wise by the condition: the same
    results for row-independent branch bodies, which is what the
    partitioning supports anyway.
    """

    OUT_IF_ELSE_BLOCKS = True

    def __init__(self, cond, name=None):
        self.cond = cond
        self.helper = LayerHelper("ifelse", name=name)
        self._true_outs = []
        self._false_outs = []
        self._in_true = None        # None = outside any branch guard

    def input(self, x):
        """Fluid slices the branch's rows here; dense: identity."""
        return x

    def true_block(self):
        return _IfElseBranch(self, True)

    def false_block(self):
        return _IfElseBranch(self, False)

    def output(self, *outs):
        if self._in_true is None:
            raise ValueError(
                "IfElse.output() must be called inside true_block()/"
                "false_block()")
        if self._in_true:
            self._true_outs.extend(outs)
        else:
            self._false_outs.extend(outs)

    def __call__(self):
        if not self._true_outs or not self._false_outs:
            raise ValueError("IfElse: both branches must call output()")
        if len(self._true_outs) != len(self._false_outs):
            raise ValueError("IfElse: branch output arity mismatch")
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            helper = LayerHelper("ifelse_merge")
            out = helper.create_variable_for_type_inference(t.dtype)
            helper.append_op("ifelse_merge",
                             inputs={"Cond": [self.cond], "X": [t],
                                     "Y": [f]},
                             outputs={"Out": [out]})
            merged.append(out)
        return merged if len(merged) > 1 else merged[0]


class _IfElseBranch:
    def __init__(self, ie, is_true):
        self.ie = ie
        self.is_true = is_true

    def __enter__(self):
        self.ie._in_true = self.is_true
        return self

    def __exit__(self, *a):
        self.ie._in_true = None
        return False


class StaticRNN:
    """Time-major static recurrence as one ``static_scan`` op (ref
    control_flow.py StaticRNN / operators/recurrent_op.cc).

    Usage mirrors the reference: ``with rnn.step():`` then ``step_input``,
    ``memory``, ``update_memory``, ``step_output``; call ``rnn()`` for the
    stacked outputs.  Inputs are time-major ``[T, batch, ...]``.
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.program = default_main_program()
        self.seq_inputs = []      # (parent var, in-block var)
        self.memories = []        # (init parent var, in-block var, new name)
        self.step_outputs = []
        self._time_major = True
        self._block = None

    def step(self):
        return _StaticRNNGuard(self)

    def step_input(self, x):
        block = self.program.current_block()
        if x.shape is None:
            step_shape = None
        elif self._time_major:
            step_shape = list(x.shape[1:])          # scan over axis 0
        else:
            # batch-major: the per-step slice keeps the batch dim
            step_shape = [x.shape[0]] + list(x.shape[2:])
        v = block.create_var(
            name=self.helper.name + ".t_" + str(len(self.seq_inputs)),
            shape=step_shape, dtype=x.dtype)
        self.seq_inputs.append((x, v))
        return v

    def _resolve_batch_ref(self, batch_ref, ref_batch_dim_idx):
        """Map a batch_ref var to one usable from the PARENT block.

        The boot memory is built in the parent block, but callers naturally
        pass in-block vars (the step_input result, per the reference's own
        example, control_flow.py:408).  Step vars map back to their parent
        sequence (batch axis 1 time-major, 0 otherwise); other in-block vars
        fall back to any parent sequence (step inputs share the batch dim);
        a var that is neither visible in the parent nor mappable is a
        build-time error instead of a far-away trace-time KeyError.
        """
        seq_dim = 1 if self._time_major else 0
        for x, v in self.seq_inputs:
            if v.name == batch_ref.name:
                return x, seq_dim
        inner = self.program.current_block()
        if inner.parent is not None and inner.parent.has_var(batch_ref.name):
            return batch_ref, ref_batch_dim_idx
        if self.seq_inputs:
            return self.seq_inputs[0][0], seq_dim
        raise ValueError(
            f"memory(batch_ref={batch_ref.name!r}): var is only defined "
            "inside the rnn step block and no step_input exists yet to take "
            "the batch size from; call step_input first or pass a "
            "parent-block var")

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               dtype="float32", init_value=None, init_batch_dim_idx=0,
               ref_batch_dim_idx=1):
        from . import tensor
        if init is None:
            if shape is None:
                raise ValueError("StaticRNN.memory needs init or shape")
            fill = value if init_value is None else init_value
            if batch_ref is not None:
                # ref control_flow.py:436: shape[init_batch_dim_idx] is
                # replaced by batch_ref's batch size.
                src, dim_idx = self._resolve_batch_ref(
                    batch_ref, ref_batch_dim_idx)
            # build the init in the PARENT block (we're inside the step
            # sub-block here; static_scan reads Init from the parent env)
            with _parent_block(self.program):
                if batch_ref is not None:
                    init = tensor.fill_constant_batch_size_like(
                        src, shape=list(shape), dtype=dtype, value=fill,
                        input_dim_idx=dim_idx,
                        output_dim_idx=init_batch_dim_idx)
                else:
                    init = tensor.fill_constant(
                        shape=list(shape), dtype=dtype, value=fill)
        block = self.program.current_block()
        v = block.create_var(
            name=self.helper.name + ".mem_" + str(len(self.memories)),
            shape=list(init.shape) if init.shape else None, dtype=init.dtype)
        self.memories.append([init, v, None])
        return v

    def update_memory(self, mem, new):
        for m in self.memories:
            if m[1].name == mem.name:
                # write new value back into the memory's own name so the
                # scan body's carry-out reads it (ref rnn_memory_helper)
                block = self.program.current_block()
                block.append_op("assign", inputs={"X": [new.name]},
                                outputs={"Out": [mem.name]}, attrs={})
                m[2] = new.name
                return
        raise ValueError(f"update_memory: {mem.name} is not a memory")

    def step_output(self, o):
        self.step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        outs = self._outs
        return outs if len(outs) > 1 else outs[0]


class _StaticRNNGuard:
    def __init__(self, rnn: StaticRNN):
        self.rnn = rnn

    def __enter__(self):
        self.rnn._block = self.rnn.program._create_block()
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            return False
        rnn = self.rnn
        program = rnn.program
        inner = program.current_block()
        program._rollback()
        helper = rnn.helper
        final_vars, out_vars = [], []
        for init, v, new in rnn.memories:
            fv = helper.create_variable_for_type_inference(init.dtype)
            final_vars.append(fv)
        for o in rnn.step_outputs:
            ov = helper.create_variable_for_type_inference(o.dtype)
            out_vars.append(ov)
        parent = program.current_block()
        # captured vars (weights etc.): read in the sub-block, defined in the
        # parent — declared as Params so append_backward sees the dependency
        # and static_scan_grad can produce their grads
        seq_names = {x.name for x, _ in rnn.seq_inputs}
        init_names = {m[0].name for m in rnn.memories}
        inner_names = {v_.name for _, v_ in rnn.seq_inputs} | \
                      {m[1].name for m in rnn.memories}
        read = {n for op_ in inner.ops for n in op_.input_arg_names()}
        written = {n for op_ in inner.ops for n in op_.output_arg_names()}
        params = sorted(n for n in (read - written - inner_names -
                                    seq_names - init_names)
                        if parent.has_var(n))
        parent.append_op(
            "static_scan",
            inputs={"X": [x.name for x, _ in rnn.seq_inputs],
                    "Init": [m[0].name for m in rnn.memories],
                    "Params": params},
            outputs={"FinalStates": [v.name for v in final_vars],
                     "Out": [v.name for v in out_vars]},
            attrs={"sub_block": inner,
                   "state_vars": [m[1].name for m in rnn.memories],
                   "step_input_vars": [v.name for _, v in rnn.seq_inputs],
                   "step_output_vars": [o.name for o in rnn.step_outputs],
                   "time_major": rnn._time_major})
        rnn._outs = out_vars
        rnn._finals = final_vars
        return False


class DynamicRNN(StaticRNN):
    """Batch-major padded recurrence with per-example lengths — the dense
    replacement for the reference's LoD DynamicRNN (control_flow.py:~1700).

    ``step_input(x, seq_len)``: x is ``[batch, T, ...]`` padded; states
    freeze once ``t >= seq_len[b]`` so final states equal the value at each
    sequence's true end (ref's shrink_rnn_memory semantics, done with masks
    instead of batch reordering).
    """

    def __init__(self, name=None):
        super().__init__(name=name)
        self._time_major = False
        self.seq_len = None
        self._t_var = None

    def block(self):
        return self.step()

    def step_input(self, x, seq_len=None):
        if seq_len is None:
            seq_len = getattr(x, "seq_len_var", None)
            if isinstance(seq_len, str):
                blk = self.program.current_block()
                seq_len = blk.var(seq_len) if blk.has_var(seq_len) else None
        if seq_len is not None and self.seq_len is None:
            self.seq_len = seq_len
        # also scan a time-index input for masking: arange [T] -> t scalar
        if self._t_var is None and self.seq_len is not None:
            from . import tensor
            # build [batch, T] index matrix in the parent block so its
            # batch-major slice at step t is the per-row time index t
            with _parent_block(self.program):
                T = x.shape[1]
                steps = tensor.fill_constant_batch_size_like(
                    x, shape=[1, T], dtype="int32", value=0.0)
                helper = LayerHelper("drnn_steps")
                idx = helper.create_variable_for_type_inference("int32", True)
                helper.append_op("drnn_iota", inputs={"X": [steps]},
                                 outputs={"Out": [idx]}, attrs={})
            self._steps_parent = idx
            self._t_var = super().step_input(idx)
        return super().step_input(x)

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               dtype="float32", init_value=None, need_reorder=False):
        if init is None and shape is not None and batch_ref is not None:
            # ref DynamicRNN.memory: shape excludes batch (prepend the slot
            # the boot fill replaces); parent vars are batch-major here
            return super().memory(shape=[1] + list(shape),
                                  batch_ref=batch_ref, value=value,
                                  dtype=dtype, init_value=init_value,
                                  init_batch_dim_idx=0, ref_batch_dim_idx=0)
        return super().memory(init=init, shape=shape, dtype=dtype,
                              value=value, init_value=init_value)

    def update_memory(self, mem, new):
        if self.seq_len is not None and self._t_var is not None:
            helper = LayerHelper("drnn_mask")
            masked = helper.create_variable_for_type_inference(new.dtype)
            helper.append_op(
                "drnn_masked_update",
                inputs={"T": [self._t_var], "SeqLen": [self.seq_len],
                        "New": [new], "Prev": [mem]},
                outputs={"Out": [masked]}, attrs={})
            new = masked
        super().update_memory(mem, new)

    def output(self, *outputs):
        super().output(*outputs)


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """ref control_flow.py Print: the print op (the value printed when the
    op runs)."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"message": (message or input.name) + " = "})
    return out
