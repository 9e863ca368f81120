"""Basic GRU / LSTM built from primitive ops (the port's
``paddle_tpu/contrib/layers/rnn_impl.py``, ref ``python/paddle/fluid/
contrib/layers/rnn_impl.py``: BasicGRUUnit / basic_gru / BasicLSTMUnit /
basic_lstm, multi-layer, bidirectional, length-masked recurrences over
StaticRNN).

Each layer and direction is one ``static_scan`` (a StaticRNN).  Variable
lengths use a per-step 0/1 mask (new_h = mask·h' + (1-mask)·h) on dense
padded batches: the padded steps carry the state through unchanged, which
also makes the plain time reversal right for the backward direction."""

from __future__ import annotations

from ... import layers
from ...framework import unique_name
from ...param_attr import ParamAttr

__all__ = ["BasicGRUUnit", "basic_gru", "BasicLSTMUnit", "basic_lstm"]


class BasicGRUUnit:
    """One GRU step from concat/matmul/sigmoid/tanh ops (ref
    rnn_impl.py:22)."""

    def __init__(self, name_scope, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 dtype="float32"):
        self._name = unique_name.generate(name_scope)
        self._hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._gate_activation = gate_activation or layers.sigmoid
        self._activation = activation or layers.tanh
        self._dtype = dtype
        self._built = False

    def build_once(self, input_size):
        if self._built:
            return
        h = self._hidden_size
        self._gate_weight = layers.create_parameter(
            [input_size + h, 2 * h], dtype=self._dtype,
            name=self._name + "_gate_w", attr=self._param_attr)
        self._gate_bias = layers.create_parameter(
            [2 * h], dtype=self._dtype, name=self._name + "_gate_b",
            attr=self._bias_attr, is_bias=True)
        self._candidate_weight = layers.create_parameter(
            [input_size + h, h], dtype=self._dtype,
            name=self._name + "_cand_w", attr=self._param_attr)
        self._candidate_bias = layers.create_parameter(
            [h], dtype=self._dtype, name=self._name + "_cand_b",
            attr=self._bias_attr, is_bias=True)
        self._built = True

    def __call__(self, input, pre_hidden):
        if not self._built:
            self.build_once(int(input.shape[-1]))
        concat = layers.concat([input, pre_hidden], axis=1)
        gate_input = layers.elementwise_add(
            layers.matmul(concat, self._gate_weight), self._gate_bias)
        gates = self._gate_activation(gate_input)
        r, u = layers.split(gates, num_or_sections=2, dim=1)
        r_hidden = layers.elementwise_mul(r, pre_hidden)
        candidate = layers.elementwise_add(
            layers.matmul(layers.concat([input, r_hidden], axis=1),
                          self._candidate_weight), self._candidate_bias)
        c = self._activation(candidate)
        # h' = u·h + (1-u)·c
        return layers.elementwise_add(
            layers.elementwise_mul(u, pre_hidden),
            layers.elementwise_mul(1.0 - u, c))


class BasicLSTMUnit:
    """One LSTM step (ref rnn_impl.py:622): i,j,f,o from a single fused
    matmul; forget_bias added pre-sigmoid."""

    def __init__(self, name_scope, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 forget_bias=1.0, dtype="float32"):
        self._name = unique_name.generate(name_scope)
        self._hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._gate_activation = gate_activation or layers.sigmoid
        self._activation = activation or layers.tanh
        self._forget_bias = float(forget_bias)
        self._dtype = dtype
        self._built = False

    def build_once(self, input_size):
        if self._built:
            return
        h = self._hidden_size
        self._weight = layers.create_parameter(
            [input_size + h, 4 * h], dtype=self._dtype,
            name=self._name + "_w", attr=self._param_attr)
        self._bias = layers.create_parameter(
            [4 * h], dtype=self._dtype, name=self._name + "_b",
            attr=self._bias_attr, is_bias=True)
        self._built = True

    def __call__(self, input, pre_hidden, pre_cell):
        if not self._built:
            self.build_once(int(input.shape[-1]))
        concat = layers.concat([input, pre_hidden], axis=1)
        gate_input = layers.elementwise_add(
            layers.matmul(concat, self._weight), self._bias)
        i, j, f, o = layers.split(gate_input, num_or_sections=4, dim=1)
        new_cell = layers.elementwise_add(
            layers.elementwise_mul(
                pre_cell,
                self._gate_activation(f + self._forget_bias)),
            layers.elementwise_mul(self._gate_activation(i),
                                   self._activation(j)))
        new_hidden = layers.elementwise_mul(
            self._activation(new_cell), self._gate_activation(o))
        return new_hidden, new_cell


def _mask_per_step(sequence_length, seq_len, dtype):
    """[T, batch, 1] 0/1 mask, time-major."""
    mask = layers.sequence_mask(sequence_length, maxlen=seq_len,
                                dtype=dtype)                    # [B, T]
    return layers.unsqueeze(layers.transpose(mask, [1, 0]), [2])


def _run_direction(unit_fn, step_in, init_states, mask, seq_len):
    """One scan: unit_fn(x_t, *states) → new states tuple; masked carry."""
    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(step_in)
        mems = [rnn.memory(init=s) for s in init_states]
        new_states = unit_fn(x_t, *mems)
        if not isinstance(new_states, tuple):
            new_states = (new_states,)
        if mask is not None:
            m_t = rnn.step_input(mask)
            new_states = tuple(
                layers.elementwise_add(
                    layers.elementwise_mul(ns, m_t),
                    layers.elementwise_mul(pm, 1.0 - m_t))
                for ns, pm in zip(new_states, mems))
        for pm, ns in zip(mems, new_states):
            rnn.update_memory(pm, ns)
        rnn.step_output(new_states[0])
        for ns in new_states:
            rnn.step_output(ns)
    outs = rnn()
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    seq_out = outs[0]                               # [T, B, H]
    finals = [layers.slice(o, axes=[0], starts=[seq_len - 1],
                           ends=[seq_len])
              for o in outs[1:]]
    finals = [layers.squeeze(f, axes=[0]) for f in finals]
    return seq_out, finals


def _stack_rnn(make_unit, n_states, input, init_states, hidden_size,
               num_layers, sequence_length, dropout_prob, bidirectional,
               batch_first, dtype):
    """The body basic_gru and basic_lstm share."""
    if batch_first:
        input = layers.transpose(input, [1, 0, 2])       # → [T, B, in]
    seq_len = int(input.shape[0])
    mask = None
    if sequence_length is not None:
        mask = _mask_per_step(sequence_length, seq_len, dtype)
    directions = 2 if bidirectional else 1

    # init_states[k]: [num_layers*dirs, batch, hidden] or None
    def init_of(k, layer, direction):
        if init_states[k] is None:
            shape = [1, int(input.shape[1]), hidden_size]
            z = layers.fill_constant_batch_size_like(
                input, shape=[-1, hidden_size], dtype=dtype, value=0.0,
                input_dim_idx=1, output_dim_idx=0)
            return z
        idx = layer * directions + direction
        s = layers.slice(init_states[k], axes=[0], starts=[idx],
                         ends=[idx + 1])
        return layers.squeeze(s, axes=[0])

    layer_in = input
    in_size = int(input.shape[-1])
    last_states = [[] for _ in range(n_states)]
    for layer in range(num_layers):
        dir_outs = []
        for direction in range(directions):
            unit = make_unit(layer, direction)
            # params built OUTSIDE the scan body, with a static input size
            # (step vars lose shape inference inside the sub-block)
            unit.build_once(in_size)
            x = layer_in if direction == 0 else \
                layers.reverse(layer_in, axis=[0])
            m = mask if direction == 0 else (
                layers.reverse(mask, axis=[0]) if mask is not None else None)
            seq_out, finals = _run_direction(
                unit, x, [init_of(k, layer, direction)
                          for k in range(n_states)], m, seq_len)
            if direction == 1:
                seq_out = layers.reverse(seq_out, axis=[0])
            dir_outs.append(seq_out)
            for k in range(n_states):
                last_states[k].append(finals[k])
        layer_in = dir_outs[0] if directions == 1 else \
            layers.concat(dir_outs, axis=2)
        in_size = hidden_size * directions
        if dropout_prob > 0.0 and layer != num_layers - 1:
            layer_in = layers.dropout(layer_in, dropout_prob)

    rnn_out = layer_in                                   # [T, B, H*dirs]
    if batch_first:
        rnn_out = layers.transpose(rnn_out, [1, 0, 2])
    finals = [layers.stack(st, axis=0) for st in last_states]
    return rnn_out, finals


def basic_gru(input, init_hidden, hidden_size, num_layers=1,
              sequence_length=None, dropout_prob=0.0, bidirectional=False,
              batch_first=True, param_attr=None, bias_attr=None,
              gate_activation=None, activation=None, dtype="float32",
              name="basic_gru"):
    """ref rnn_impl.py:139 — returns (rnn_out, last_hidden)."""
    def make_unit(layer, direction):
        return BasicGRUUnit(
            f"{name}_l{layer}_d{direction}", hidden_size,
            _sub_attr(param_attr, layer, direction),
            _sub_attr(bias_attr, layer, direction),
            gate_activation, activation, dtype)
    rnn_out, (last_hidden,) = _stack_rnn(
        make_unit, 1, input, [init_hidden], hidden_size, num_layers,
        sequence_length, dropout_prob, bidirectional, batch_first, dtype)
    return rnn_out, last_hidden


def basic_lstm(input, init_hidden, init_cell, hidden_size, num_layers=1,
               sequence_length=None, dropout_prob=0.0, bidirectional=False,
               batch_first=True, param_attr=None, bias_attr=None,
               gate_activation=None, activation=None, forget_bias=1.0,
               dtype="float32", name="basic_lstm"):
    """ref rnn_impl.py:353 — returns (rnn_out, last_hidden, last_cell)."""
    def make_unit(layer, direction):
        return BasicLSTMUnit(
            f"{name}_l{layer}_d{direction}", hidden_size,
            _sub_attr(param_attr, layer, direction),
            _sub_attr(bias_attr, layer, direction),
            gate_activation, activation, forget_bias, dtype)
    rnn_out, (last_hidden, last_cell) = _stack_rnn(
        make_unit, 2, input, [init_hidden, init_cell], hidden_size,
        num_layers, sequence_length, dropout_prob, bidirectional,
        batch_first, dtype)
    return rnn_out, last_hidden, last_cell


def _sub_attr(attr, layer, direction):
    """Per-layer param attr names (ref rnn_impl.py name mangling)."""
    if attr is None or not isinstance(attr, ParamAttr) or attr.name is None:
        return attr
    return ParamAttr(name=f"{attr.name}_l{layer}_d{direction}",
                     initializer=attr.initializer)
