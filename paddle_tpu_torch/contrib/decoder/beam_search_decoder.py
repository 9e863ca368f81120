"""Declarative seq2seq decoding: InitState / StateCell / TrainingDecoder /
BeamSearchDecoder (the port's ``paddle_tpu/contrib/decoder/
beam_search_decoder.py``, ref ``python/paddle/fluid/contrib/decoder/
beam_search_decoder.py:43,159,384,523``).

Fluid threads variable-width beams through LoD (``sequence_expand`` to
replicate states, ``lod_reset`` on scores).  Here, as in the reference,
every sentence keeps exactly ``beam_size`` dense hypothesis slots
([batch*beam, ...] activations), the ``beam_search`` op returns explicit
``parent_idx`` pointers, and states are re-ordered with one ``gather``.
Training decode wraps DynamicRNN (one ``static_scan``); beam decode is a
``While`` whose body is one step."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

from ... import layers
from ...framework import unique_name
from ...framework.core import Variable

__all__ = ["InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder"]


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState:
    """Initial decoder state (ref beam_search_decoder.py:43): either an
    existing Variable (e.g. encoder final state) or a zero-filled shape."""

    def __init__(self, init=None, shape=None, value=0.0,
                 init_boot=None, need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                "init_boot must be provided to infer the init batch size")
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape, dtype=dtype)
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class _MemoryState:
    """State held as a DynamicRNN memory (training mode; ref :100)."""

    def __init__(self, state_name, rnn_obj, init_state):
        self._state_name = state_name
        self._rnn_obj = rnn_obj
        self._state_mem = self._rnn_obj.memory(init=init_state.value)

    def get_state(self):
        return self._state_mem

    def update_state(self, state):
        self._rnn_obj.update_memory(self._state_mem, state)


class _ArrayState:
    """State held in a tensor array (beam-search mode; ref :114): read at
    the loop counter, written at counter+1 by the decoder's end-of-step
    hook."""

    def __init__(self, state_name, program, init_state, buffer_len=128):
        self._state_name = state_name
        self._init = init_state.value
        self._need_reorder = init_state.need_reorder
        # the array + its seed write live in the PARENT block (ref :115
        # parent_block.append_op write_to_array) — inside the while body
        # they would never run before the first iteration
        from ...layers.control_flow import _parent_block
        ctx = (_parent_block(program)
               if program.current_block().parent_idx >= 0
               else contextlib.nullcontext())
        with ctx:
            self._state_array = layers.create_array(self._init.dtype,
                                                    max_len=buffer_len)
            zero = layers.fill_constant([1], "int64", 0)
            layers.array_write(self._init, zero, self._state_array)
        self._counter = None          # bound by the decoder
        self._pending = None

    def get_state(self):
        return layers.array_read(self._state_array, self._counter)

    def update_state(self, state):
        self._pending = state


class StateCell:
    """Named decoder states + inputs with a user ``state_updater``
    (ref beam_search_decoder.py:159)."""

    def __init__(self, inputs: Dict[str, Optional[Variable]],
                 states: Dict[str, InitState], out_state: str, name=None):
        self._inputs = dict(inputs)
        self._cur_states: Dict[str, object] = {}
        self._state_names = list(states)
        self._states_holder = states
        self._out_state = out_state
        self._pending_values: Dict[str, Variable] = {}
        self._updater = None
        self._decoder_obj = None
        self._in_decoder = False
        self._switched_decoder = False

    # -- decoder binding (ref _enter/_leave/_switch_decoder) -----------------
    def _enter_decoder(self, decoder_obj):
        if self._in_decoder:
            raise ValueError("StateCell has already entered a decoder.")
        self._in_decoder = True
        self._decoder_obj = decoder_obj
        self._switched_decoder = False

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder or self._decoder_obj is not decoder_obj:
            raise ValueError(
                "StateCell not in this decoder object.")
        self._in_decoder = False
        self._decoder_obj = None
        self._switched_decoder = False

    def _switch_decoder(self):
        if not self._in_decoder:
            raise ValueError("StateCell must be enrolled in a decoder.")
        if self._switched_decoder:
            raise ValueError("StateCell already done switching.")
        for state_name, init in self._states_holder.items():
            if self._decoder_obj.type == _DecoderType.TRAINING:
                self._cur_states[state_name] = _MemoryState(
                    state_name, self._decoder_obj.dynamic_rnn, init)
            else:
                st = _ArrayState(
                    state_name, self._decoder_obj._program, init,
                    buffer_len=self._decoder_obj._buffer_len)
                st._counter = self._decoder_obj._counter
                self._cur_states[state_name] = st
                self._decoder_obj._register_state(st)
        self._switched_decoder = True

    # -- state access --------------------------------------------------------
    def get_state(self, state_name):
        if not self._switched_decoder:
            self._switch_decoder()
        if state_name not in self._cur_states:
            raise ValueError(f"unknown state {state_name!r}")
        st = self._cur_states[state_name]
        return st.get_state() if not isinstance(st, Variable) else st

    def get_input(self, input_name):
        if input_name not in self._inputs or \
                self._inputs[input_name] is None:
            raise ValueError(f"input variable {input_name!r} not found")
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        """Stage a new value; committed by update_states (ref :303)."""
        if not self._switched_decoder:
            self._switch_decoder()
        if state_name not in self._cur_states:
            raise ValueError(f"unknown state {state_name!r}")
        self._pending_values[state_name] = state_value

    def state_updater(self, updater):
        """Decorator registering the per-step state computation
        (ref :314)."""
        self._updater = updater

        def _decorator(state_cell):
            if state_cell is not self:
                raise TypeError("updater must take this StateCell")
            updater(state_cell)
        return _decorator

    def compute_state(self, inputs: Dict[str, Variable]):
        """Bind this step's inputs, then run the updater (ref :335)."""
        if not self._switched_decoder:
            self._switch_decoder()
        for name, value in inputs.items():
            if name not in self._inputs:
                raise ValueError(f"unknown input {name!r}")
            self._inputs[name] = value
        self._updater(self)

    def update_states(self):
        """Commit staged values back to memories/arrays (ref :360)."""
        for name, value in self._pending_values.items():
            self._cur_states[name].update_state(value)
        self._pending_values = {}

    def out_state(self):
        """This step's output state: the staged value if present, else the
        holder's current value (ref :374)."""
        pending = self._pending_values.get(self._out_state)
        if pending is not None:
            return pending
        return self._cur_states[self._out_state].get_state()


class TrainingDecoder:
    """Teacher-forced decoding over DynamicRNN (ref :384)."""

    def __init__(self, state_cell: StateCell, name=None):
        self._rnn = layers.DynamicRNN(name=name)
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._in_block = False
        self._outputs: List[Variable] = []

    @property
    def dynamic_rnn(self):
        return self._rnn

    @property
    def type(self):
        return _DecoderType.TRAINING

    @property
    def state_cell(self):
        return self._state_cell

    @contextlib.contextmanager
    def block(self):
        self._in_block = True
        with self._rnn.block():
            yield
        self._in_block = False
        self._state_cell._leave_decoder(self)

    def step_input(self, x, seq_len=None):
        return self._rnn.step_input(x, seq_len=seq_len)

    def static_input(self, x):
        # parent-scope vars are captured by the scan lowering automatically;
        # the reference needed an explicit reorder-by-rank-table copy
        return x

    def output(self, *outputs):
        for out in outputs:
            self._rnn.step_output(out)

    def __call__(self, *args, **kwargs):
        return self._rnn(*args, **kwargs)


class BeamSearchDecoder:
    """Inference-time beam search (ref :523).

    Usage (auto mode)::

        decoder = BeamSearchDecoder(state_cell, init_ids, init_scores,
                                    target_dict_dim, word_dim,
                                    beam_size=4, end_id=1, max_len=20)
        decoder.decode()
        translation_ids, translation_scores = decoder()
    """

    BEFORE, IN, AFTER = 0, 1, 2

    def __init__(self, state_cell: StateCell, init_ids, init_scores,
                 target_dict_dim, word_dim, input_var_dict=None,
                 topk_size=50, sparse_emb=True, max_len=100, beam_size=1,
                 end_id=1, name=None):
        self._counter = layers.zeros(shape=[1], dtype="int64")
        self._counter.stop_gradient = True
        self._buffer_len = max_len + 1      # exact dense array size
        self._max_len = layers.fill_constant([1], "int64", max_len)
        self._cond = layers.less_than(self._counter, self._max_len)
        self._while_op = layers.While(self._cond)
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._status = self.BEFORE
        self._zero_idx = layers.fill_constant([1], "int64", 0)
        self._array_dict = {}
        self._array_link = []
        self._array_states: List[_ArrayState] = []
        self._ids_array = None
        self._scores_array = None
        self._parents_array = None     # created+seeded at first decode step
        self._beam_size = beam_size
        self._end_id = end_id
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._parent_idx = None
        from ...framework.core import default_main_program
        self._program = default_main_program()

    @property
    def type(self):
        return _DecoderType.BEAM_SEARCH

    def _parent_block(self):
        return self._program.global_block()

    def _register_state(self, array_state: _ArrayState):
        self._array_states.append(array_state)

    @contextlib.contextmanager
    def block(self):
        """Per-step body; on exit the step-end bookkeeping runs under
        'still alive' (ref :620-643)."""
        if self._status != self.BEFORE:
            raise ValueError("block() can only be invoked once.")
        self._status = self.IN
        with self._while_op.block():
            yield
            sw = layers.Switch()
            with sw.case(self._cond):
                layers.increment(self._counter, value=1.0, in_place=True)
                for value, array in self._array_link:
                    layers.array_write(value, self._counter, array)
                if self._parent_idx is not None:
                    layers.array_write(self._parent_idx, self._counter,
                                       self._parents_array)
                # re-ordered states stored for the next step
                for st in self._array_states:
                    if st._pending is not None:
                        layers.array_write(st._pending, self._counter,
                                           st._state_array)
                        st._pending = None
                layers.less_than(self._counter, self._max_len,
                                 cond=self._cond)
        self._status = self.AFTER
        self._state_cell._leave_decoder(self)

    def early_stop(self):
        """break: force the while condition false (ref :649)."""
        false = layers.fill_constant([1], "bool", 0)
        layers.assign(false, self._cond)

    def read_array(self, init, is_ids=False, is_scores=False):
        """Array-backed loop variable seeded with ``init`` (ref :731)."""
        if self._status != self.IN:
            raise ValueError("read_array must be called inside block()")
        if is_ids and is_scores:
            raise ValueError("an array cannot be ids and scores at once")
        if not isinstance(init, Variable):
            raise TypeError("`init` must be a Variable")
        from ...layers.control_flow import _parent_block
        with _parent_block(self._program):
            array = layers.create_array(init.dtype,
                                        max_len=self._buffer_len)
            layers.array_write(init, self._zero_idx, array)
        if is_ids:
            self._ids_array = array
        elif is_scores:
            self._scores_array = array
        read_value = layers.array_read(array, self._counter)
        self._array_dict[read_value.name] = array
        return read_value

    def update_array(self, array_var, value):
        """Queue ``value`` for the end-of-step write (ref :780)."""
        if self._status != self.IN:
            raise ValueError("update_array must be called inside block()")
        array = self._array_dict.get(array_var.name)
        if array is None:
            raise ValueError("invoke read_array before update_array")
        self._array_link.append((value, array))

    @property
    def state_cell(self):
        return self._state_cell

    # -- auto decode (ref :653) ----------------------------------------------
    def decode(self):
        with self.block():
            prev_ids = self.read_array(self._init_ids, is_ids=True)
            prev_scores = self.read_array(self._init_scores,
                                          is_scores=True)
            # parents array seeded with identity pointers for step 0
            from ...layers.control_flow import _parent_block
            with _parent_block(self._program):
                self._parents_array = layers.create_array(
                    "int64", max_len=self._buffer_len)
                seed_parents = layers.fill_constant_batch_size_like(
                    self._init_ids, shape=[-1], dtype="int64", value=0)
                layers.array_write(seed_parents, self._zero_idx,
                                   self._parents_array)
            prev_emb = layers.embedding(
                prev_ids, size=[self._target_dict_dim, self._word_dim],
                dtype="float32", is_sparse=self._sparse_emb,
                param_attr=None)
            prev_emb = layers.reshape(prev_emb, [-1, self._word_dim])

            feed_dict, update_dict = {}, {}
            for name, init_var in self._input_var_dict.items():
                if name not in self._state_cell._inputs:
                    raise ValueError(
                        f"Variable {name} not found in StateCell")
                read_var = self.read_array(init=init_var)
                update_dict[name] = read_var
                feed_dict[name] = read_var
            for input_name in self._state_cell._inputs:
                if input_name not in feed_dict:
                    feed_dict[input_name] = prev_emb

            self._state_cell.compute_state(inputs=feed_dict)
            current_state = self._state_cell.out_state()
            scores = layers.fc(current_state,
                               size=self._target_dict_dim, act="softmax")
            topk_scores, topk_indices = layers.topk(scores,
                                                    k=self._topk_size)
            # dense: prev_scores [bb,1] broadcasts over the topk axis
            accu_scores = layers.elementwise_add(
                layers.log(topk_scores), prev_scores)
            selected_ids, selected_scores, parent_idx = layers.beam_search(
                prev_ids, prev_scores, topk_indices, accu_scores,
                self._beam_size, end_id=self._end_id, level=0)
            self._parent_idx = parent_idx

            # NOTE: no early exit here (vs Fluid's is_empty(selected_ids)
            # check) — finished beams re-emit end_id with frozen scores
            # under the dense beam_search op, so running the fixed trip
            # count is semantically identical while keeping every array
            # slot written (an early stop would leave zero-filled steps
            # that corrupt the backtrack).

            # re-order THIS STEP's computed states by the beam parents,
            # then commit (gathering st.get_state() would reorder the
            # stale previous-step value and drop the update entirely)
            for name in self._state_cell._state_names:
                staged = self._state_cell._pending_values.get(name)
                if staged is None:
                    staged = self._state_cell._cur_states[name].get_state()
                self._state_cell.set_state(
                    name, layers.gather(staged, parent_idx))
            self._state_cell.update_states()
            self.update_array(prev_ids, selected_ids)
            self.update_array(prev_scores, selected_scores)
            for name, var_to_update in update_dict.items():
                self.update_array(var_to_update, feed_dict[name])

    def __call__(self):
        """Backtrack arrays into sentences (ref :802)."""
        if self._status != self.AFTER:
            raise ValueError(
                "output may only be read after the decode block")
        ids, _ = layers.tensor_array_to_tensor(self._ids_array, axis=0,
                                               use_stack=True)
        scores, _ = layers.tensor_array_to_tensor(self._scores_array,
                                                  axis=0, use_stack=True)
        parents, _ = layers.tensor_array_to_tensor(self._parents_array,
                                                   axis=0, use_stack=True)
        return layers.beam_search_decode(ids, scores, parents,
                                         beam_size=self._beam_size,
                                         end_id=self._end_id)
