"""The dygraph ``nn`` layers (the port of ``paddle_tpu/dygraph/nn.py``; ref
``python/paddle/fluid/dygraph/nn.py``: Conv2D:35 Conv3D:244 Pool2D:662
FC:773 BatchNorm:963 Embedding:1178 LayerNorm:1266 GRUUnit:1411 NCE:1564
PRelu:1793 BilinearTensorProduct:1864 Conv2DTranspose:1964 SequenceConv:2199
RowConv:2289 GroupNorm:2365 SpectralNorm:2464 TreeConv:2564).

Each layer owns eager parameters and traces the op types the static layer
DSL appends, through the tracer: the same lowerings, so the same
semantics.  ``BatchNorm`` writes its running statistics from the op's
``MeanOut`` / ``VarianceOut``; ``BatchNorm`` and ``Dropout`` follow
``Layer.training``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import torch

from ..initializer import (ConstantInitializer, NormalInitializer,
                           UniformInitializer)
from .base import current_device
from .layers import Layer
from .tracer import VarBase, default_tracer

__all__ = [
    "Conv2D", "Conv3D", "Conv2DTranspose", "Pool2D", "FC", "Linear",
    "BatchNorm", "Embedding", "LayerNorm", "GRUUnit", "NCE", "PRelu",
    "BilinearTensorProduct", "GroupNorm", "SpectralNorm", "SequenceConv",
    "RowConv", "TreeConv", "Dropout",
]


def _pair(v, n=2):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def _trace(op_type, ins, attrs=None):
    return default_tracer().trace_op(op_type, ins, attrs)


def _buffer(arr) -> VarBase:
    """A layer's state (running statistics, power-iteration vectors, fixed
    samples): no gradient, on the guard's device."""
    return VarBase(arr, persistable=True, trainable=False,
                   stop_gradient=True, device=current_device())


def _act(x, act: Optional[str]):
    if act is None:
        return x
    return _trace(act, {"X": [x]}, {})["Out"][0]


class Conv2D(Layer):
    """ref dygraph/nn.py:35."""

    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=None, stride=1, padding=0, dilation=1,
                 groups=None,
                 param_attr=None, bias_attr=None, use_cudnn=True, act=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._groups = groups or 1
        self._stride = _pair(stride)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._act = act
        fs = _pair(filter_size)
        filter_shape = [num_filters, num_channels // self._groups] + fs
        std = (2.0 / (fs[0] * fs[1] * num_channels)) ** 0.5
        self.weight = self.create_parameter(
            filter_shape, attr=param_attr, dtype=dtype,
            default_initializer=NormalInitializer(0.0, std))
        self.bias = (None if bias_attr is False else self.create_parameter(
            [num_filters], attr=bias_attr, dtype=dtype, is_bias=True))

    def forward(self, input):
        out = _trace("conv2d",
                     {"Input": [input], "Filter": [self.weight]},
                     {"strides": self._stride, "paddings": self._padding,
                      "dilations": self._dilation, "groups": self._groups,
                      "data_format": "NCHW"})["Output"][0]
        if self.bias is not None:
            out = _trace("elementwise_add", {"X": [out], "Y": [self.bias]},
                         {"axis": 1})["Out"][0]
        return _act(out, self._act)


class Conv3D(Layer):
    """ref dygraph/nn.py:244."""

    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=None, stride=1, padding=0, dilation=1,
                 groups=None, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._groups = groups or 1
        self._stride = _pair(stride, 3)
        self._padding = _pair(padding, 3)
        self._dilation = _pair(dilation, 3)
        self._act = act
        fs = _pair(filter_size, 3)
        filter_shape = [num_filters, num_channels // self._groups] + fs
        self.weight = self.create_parameter(filter_shape, attr=param_attr,
                                            dtype=dtype)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [num_filters], attr=bias_attr, dtype=dtype, is_bias=True))

    def forward(self, input):
        out = _trace("conv3d", {"Input": [input], "Filter": [self.weight]},
                     {"strides": self._stride, "paddings": self._padding,
                      "dilations": self._dilation,
                      "groups": self._groups})["Output"][0]
        if self.bias is not None:
            out = _trace("elementwise_add", {"X": [out], "Y": [self.bias]},
                         {"axis": 1})["Out"][0]
        return _act(out, self._act)


class Conv2DTranspose(Layer):
    """ref dygraph/nn.py:1964."""

    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=None, padding=0, stride=1, dilation=1,
                 groups=None, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._groups = groups or 1
        self._stride = _pair(stride)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._act = act
        fs = _pair(filter_size)
        self.weight = self.create_parameter(
            [num_channels, num_filters // self._groups] + fs,
            attr=param_attr, dtype=dtype)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [num_filters], attr=bias_attr, dtype=dtype, is_bias=True))

    def forward(self, input):
        out = _trace("conv2d_transpose",
                     {"Input": [input], "Filter": [self.weight]},
                     {"strides": self._stride, "paddings": self._padding,
                      "dilations": self._dilation,
                      "groups": self._groups})["Output"][0]
        if self.bias is not None:
            out = _trace("elementwise_add", {"X": [out], "Y": [self.bias]},
                         {"axis": 1})["Out"][0]
        return _act(out, self._act)


class Conv3DTranspose(Layer):
    """ref dygraph/nn.py:441."""

    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=None, padding=0, stride=1, dilation=1,
                 groups=None, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._groups = groups or 1
        self._stride = _pair(stride, 3)
        self._padding = _pair(padding, 3)
        self._dilation = _pair(dilation, 3)
        self._act = act
        fs = _pair(filter_size, 3)
        self.weight = self.create_parameter(
            [num_channels, num_filters // self._groups] + fs,
            attr=param_attr, dtype=dtype)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [num_filters], attr=bias_attr, dtype=dtype, is_bias=True))

    def forward(self, input):
        out = _trace("conv3d_transpose",
                     {"Input": [input], "Filter": [self.weight]},
                     {"strides": self._stride, "paddings": self._padding,
                      "dilations": self._dilation,
                      "groups": self._groups})["Output"][0]
        if self.bias is not None:
            out = _trace("elementwise_add", {"X": [out], "Y": [self.bias]},
                         {"axis": 1})["Out"][0]
        return _act(out, self._act)


class Pool2D(Layer):
    """ref dygraph/nn.py:662."""

    def __init__(self, name_scope=None, pool_size=-1, pool_type="max",
                 pool_stride=1, pool_padding=0, global_pooling=False,
                 use_cudnn=True, ceil_mode=False, exclusive=True,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._attrs = {"pooling_type": pool_type, "ksize": _pair(pool_size),
                       "strides": _pair(pool_stride),
                       "paddings": _pair(pool_padding),
                       "global_pooling": global_pooling,
                       "ceil_mode": ceil_mode, "exclusive": exclusive,
                       "data_format": "NCHW"}

    def forward(self, input):
        return _trace("pool2d", {"X": [input]}, dict(self._attrs))["Out"][0]


class FC(Layer):
    """ref dygraph/nn.py:773 — mul + bias + act; lazy weight creation on the
    first forward (the reference builds from the first input's shape too)."""

    def __init__(self, name_scope=None, size=None, num_flatten_dims=1,
                 param_attr=None, bias_attr=None, act=None, is_test=False,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._size = size
        self._num_flatten_dims = num_flatten_dims
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._act = act
        self.weight: Optional[VarBase] = None
        self.bias: Optional[VarBase] = None

    def _build_once(self, input):
        in_dim = int(np.prod(input.shape[self._num_flatten_dims:]))
        self.weight = self.create_parameter([in_dim, self._size],
                                            attr=self._param_attr,
                                            dtype=self._dtype)
        if self._bias_attr is not False:
            self.bias = self.create_parameter([self._size],
                                              attr=self._bias_attr,
                                              dtype=self._dtype, is_bias=True)

    def forward(self, input):
        if self.weight is None:
            self._build_once(input)
        out = _trace("mul", {"X": [input], "Y": [self.weight]},
                     {"x_num_col_dims": self._num_flatten_dims,
                      "y_num_col_dims": 1})["Out"][0]
        if self.bias is not None:
            out = _trace("elementwise_add", {"X": [out], "Y": [self.bias]},
                         {"axis": -1})["Out"][0]
        return _act(out, self._act)


class Linear(FC):
    """2.0-style alias: explicit input_dim instead of lazy build."""

    def __init__(self, input_dim, output_dim, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__(None, output_dim, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, dtype=dtype)
        self.weight = self.create_parameter([input_dim, output_dim],
                                            attr=param_attr, dtype=dtype)
        if bias_attr is not False:
            self.bias = self.create_parameter([output_dim], attr=bias_attr,
                                              dtype=dtype, is_bias=True)


class BatchNorm(Layer):
    """ref dygraph/nn.py:963 — running stats live as buffers, updated in
    training forward via the batch_norm op's MeanOut/VarianceOut."""

    def __init__(self, name_scope=None, num_channels=None, act=None,
                 is_test=False, momentum=0.9, epsilon=1e-5, param_attr=None,
                 bias_attr=None, dtype="float32", data_layout="NCHW",
                 use_global_stats=False):
        super().__init__(name_scope, dtype)
        self._momentum = momentum
        self._epsilon = epsilon
        self._act = act
        self._layout = data_layout
        self._use_global_stats = use_global_stats
        c = [num_channels]
        self.weight = self.create_parameter(
            c, attr=param_attr, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter(c, attr=bias_attr, dtype=dtype,
                                          is_bias=True)
        self.register_buffer("_mean", _buffer(np.zeros(c, "float32")))
        self.register_buffer("_variance", _buffer(np.ones(c, "float32")))
        if is_test:
            self.training = False

    def forward(self, input):
        outs = _trace(
            "batch_norm",
            {"X": [input], "Scale": [self.weight], "Bias": [self.bias],
             "Mean": [self._mean], "Variance": [self._variance]},
            {"momentum": self._momentum, "epsilon": self._epsilon,
             "is_test": not self.training, "data_layout": self._layout,
             "use_global_stats": self._use_global_stats})
        if self.training and not self._use_global_stats:
            self._mean.set_value(outs["MeanOut"][0].value)
            self._variance.set_value(outs["VarianceOut"][0].value)
        return _act(outs["Y"][0], self._act)


class Embedding(Layer):
    """ref dygraph/nn.py:1178."""

    def __init__(self, name_scope=None, size=None, is_sparse=False,
                 is_distributed=False, padding_idx=None, param_attr=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._padding_idx = -1 if padding_idx is None else padding_idx
        self.weight = self.create_parameter(
            list(size), attr=param_attr, dtype=dtype,
            default_initializer=UniformInitializer(-0.05, 0.05))

    def forward(self, input):
        return _trace("lookup_table_v2",
                      {"W": [self.weight], "Ids": [input]},
                      {"padding_idx": self._padding_idx})["Out"][0]


class LayerNorm(Layer):
    """ref dygraph/nn.py:1266."""

    def __init__(self, name_scope=None, normalized_shape=None, scale=True,
                 shift=True, begin_norm_axis=1, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._epsilon = epsilon
        self._begin_norm_axis = begin_norm_axis
        self._act = act
        dim = [int(np.prod(normalized_shape))] \
            if normalized_shape is not None else None
        self._dim = dim
        self.weight = None
        self.bias = None
        self._scale, self._shift = scale, shift
        if dim is not None:
            self._build(dim)

    def _build(self, dim):
        if self._scale:
            self.weight = self.create_parameter(
                dim, dtype=self._dtype,
                default_initializer=ConstantInitializer(1.0))
        if self._shift:
            self.bias = self.create_parameter(dim, dtype=self._dtype,
                                              is_bias=True)

    def forward(self, input):
        if self._dim is None:
            self._dim = [int(np.prod(input.shape[self._begin_norm_axis:]))]
            self._build(self._dim)
        ins = {"X": [input]}
        if self.weight is not None:
            ins["Scale"] = [self.weight]
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        out = _trace("layer_norm", ins,
                     {"epsilon": self._epsilon,
                      "begin_norm_axis": self._begin_norm_axis})["Y"][0]
        return _act(out, self._act)


class GroupNorm(Layer):
    """ref dygraph/nn.py:2365."""

    def __init__(self, name_scope=None, channels=None, groups=None,
                 epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._groups = groups
        self._epsilon = epsilon
        self._act = act
        self.weight = self.create_parameter(
            [channels], attr=param_attr, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter([channels], attr=bias_attr,
                                          dtype=dtype, is_bias=True)

    def forward(self, input):
        out = _trace("group_norm",
                     {"X": [input], "Scale": [self.weight],
                      "Bias": [self.bias]},
                     {"groups": self._groups, "epsilon": self._epsilon})
        return _act(out["Y"][0], self._act)


class GRUUnit(Layer):
    """ref dygraph/nn.py:1411 — one GRU step: gates from input + hidden."""

    def __init__(self, name_scope=None, size=None, param_attr=None,
                 bias_attr=None, activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32"):
        super().__init__(name_scope, dtype)
        d = size // 3
        self._d = d
        self._activation = activation
        self._gate_activation = gate_activation
        self._origin_mode = origin_mode
        self.weight = self.create_parameter([d, d * 3], attr=param_attr,
                                            dtype=dtype)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [1, d * 3], attr=bias_attr, dtype=dtype, is_bias=True))

    def forward(self, input, hidden):
        ins = {"Input": [input], "HiddenPrev": [hidden],
               "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        outs = _trace("gru_unit", ins,
                      {"activation": self._activation,
                       "gate_activation": self._gate_activation,
                       "origin_mode": self._origin_mode})
        return (outs["Hidden"][0], outs["ResetHiddenPrev"][0],
                outs["Gate"][0])


class PRelu(Layer):
    """ref dygraph/nn.py:1793."""

    def __init__(self, name_scope=None, mode="all", channel=None,
                 input_shape=None, param_attr=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._mode = mode
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            shape = [channel if channel is not None else input_shape[1]]
        else:
            shape = list(input_shape[1:])
        self.weight = self.create_parameter(
            shape, attr=param_attr, dtype=dtype,
            default_initializer=ConstantInitializer(0.25))

    def forward(self, input):
        return _trace("prelu", {"X": [input], "Alpha": [self.weight]},
                      {"mode": self._mode})["Out"][0]


class BilinearTensorProduct(Layer):
    """ref dygraph/nn.py:1864: out_k = x W_k y^T + b."""

    def __init__(self, name_scope=None, size=None, x_dim=None, y_dim=None,
                 param_attr=None, bias_attr=None, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._act = act
        self.weight = self.create_parameter([size, x_dim, y_dim],
                                            attr=param_attr, dtype=dtype)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [1, size], attr=bias_attr, dtype=dtype, is_bias=True))

    def forward(self, x, y):
        ins = {"X": [x], "Y": [y], "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        out = _trace("bilinear_tensor_product", ins, {})["Out"][0]
        return _act(out, self._act)


class SpectralNorm(Layer):
    """ref dygraph/nn.py:2464 — power-iteration spectral normalization,
    composed from matmul/l2_normalize ops (u, v kept as buffers)."""

    def __init__(self, name_scope=None, weight_shape=None, dim=0,
                 power_iters=1, eps=1e-12, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.register_buffer("weight_u", _buffer(
            np.random.RandomState(0).normal(size=[h]).astype("float32")))
        self.register_buffer("weight_v", _buffer(
            np.random.RandomState(1).normal(size=[w]).astype("float32")))

    def forward(self, weight):
        dim, eps = self._dim, self._eps
        perm = [dim] + [i for i in range(weight.ndim) if i != dim]
        w = _trace("transpose2", {"X": [weight]}, {"axis": perm})["Out"][0]
        h = w.shape[0]
        w = _trace("reshape2", {"X": [w]}, {"shape": [h, -1]})["Out"][0]
        u, v = self.weight_u.value, self.weight_v.value
        wv = w.value
        for _ in range(self._power_iters):
            v = wv.T @ u
            v = v / (torch.linalg.norm(v) + eps)
            u = wv @ v
            u = u / (torch.linalg.norm(u) + eps)
        self.weight_u.set_value(u)
        self.weight_v.set_value(v)
        sigma_u = VarBase(u, stop_gradient=True)
        sigma_v = VarBase(v, stop_gradient=True)
        uw = _trace("matmul",
                    {"X": [_trace("reshape2", {"X": [sigma_u]},
                                  {"shape": [1, -1]})["Out"][0]],
                     "Y": [w]}, {})["Out"][0]
        sigma = _trace("matmul",
                       {"X": [uw],
                        "Y": [_trace("reshape2", {"X": [sigma_v]},
                                     {"shape": [-1, 1]})["Out"][0]]},
                       {})["Out"][0]
        sigma = _trace("reshape2", {"X": [sigma]}, {"shape": [1]})["Out"][0]
        return _trace("elementwise_div", {"X": [weight], "Y": [sigma]},
                      {"axis": -1})["Out"][0]


class NCE(Layer):
    """ref dygraph/nn.py:1564 — noise-contrastive estimation head.

    Eager realization: sample ``num_neg_samples`` negatives uniformly, score
    positives + negatives against class embeddings, binary logistic loss
    (the reference nce_op's uniform-sampler path).
    """

    def __init__(self, name_scope=None, num_total_classes=None, dim=None,
                 num_neg_samples=10, param_attr=None, bias_attr=None,
                 dtype="float32", seed=0):
        super().__init__(name_scope, dtype)
        self._num_total_classes = num_total_classes
        self._num_neg = num_neg_samples
        self._rng = np.random.RandomState(seed or 0)
        self.weight = self.create_parameter([num_total_classes, dim],
                                            attr=param_attr, dtype=dtype)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [num_total_classes], attr=bias_attr, dtype=dtype, is_bias=True))

    def forward(self, input, label):
        n = input.shape[0]
        neg = self._rng.randint(0, self._num_total_classes,
                                (n, self._num_neg)).astype("int64")
        lbl = _trace("reshape2", {"X": [label]}, {"shape": [n, 1]})["Out"][0]
        ids = _trace("concat",
                     {"X": [lbl, VarBase(neg, stop_gradient=True,
                                         device=input.device)]},
                     {"axis": 1})["Out"][0]
        emb = _trace("lookup_table_v2", {"W": [self.weight], "Ids": [ids]},
                     {"padding_idx": -1})["Out"][0]       # (n, 1+k, d)
        x3 = _trace("reshape2", {"X": [input]},
                    {"shape": [n, 1, -1]})["Out"][0]
        logits = _trace("matmul", {"X": [emb], "Y": [x3]},
                        {"transpose_Y": True})["Out"][0]  # (n, 1+k, 1)
        logits = _trace("reshape2", {"X": [logits]},
                        {"shape": [n, 1 + self._num_neg]})["Out"][0]
        if self.bias is not None:
            b = _trace("lookup_table_v2",
                       {"W": [_trace("reshape2", {"X": [self.bias]},
                                     {"shape": [-1, 1]})["Out"][0]],
                        "Ids": [ids]}, {"padding_idx": -1})["Out"][0]
            b = _trace("reshape2", {"X": [b]},
                       {"shape": [n, 1 + self._num_neg]})["Out"][0]
            logits = _trace("elementwise_add", {"X": [logits], "Y": [b]},
                            {"axis": -1})["Out"][0]
        targets = np.zeros((n, 1 + self._num_neg), "float32")
        targets[:, 0] = 1.0
        loss = _trace("sigmoid_cross_entropy_with_logits",
                      {"X": [logits],
                       "Label": [VarBase(targets, stop_gradient=True,
                                         device=input.device)]},
                      {})["Out"][0]
        loss = _trace("reduce_sum", {"X": [loss]},
                      {"dim": [1], "keep_dim": True})["Out"][0]
        return loss


class SequenceConv(Layer):
    """ref dygraph/nn.py:2199 — context-window conv over the time axis of a
    padded (batch, time, dim) sequence batch (LoD replaced by dense+mask)."""

    def __init__(self, name_scope=None, num_filters=None, filter_size=3,
                 filter_stride=1, padding=True, param_attr=None,
                 bias_attr=None, act=None, dtype="float32", input_dim=None):
        super().__init__(name_scope, dtype)
        self._filter_size = filter_size
        self._act = act
        self._num_filters = num_filters
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None
        if input_dim is not None:
            self._build(input_dim)

    def _build(self, dim):
        self.weight = self.create_parameter(
            [self._filter_size * dim, self._num_filters],
            attr=self._param_attr, dtype=self._dtype)
        if self._bias_attr is not False:
            self.bias = self.create_parameter([self._num_filters],
                                              attr=self._bias_attr,
                                              dtype=self._dtype, is_bias=True)

    def forward(self, input):
        if self.weight is None:
            self._build(input.shape[-1])
        out = _trace("sequence_conv",
                     {"X": [input], "Filter": [self.weight]},
                     {"contextLength": self._filter_size,
                      "contextStart": -(self._filter_size // 2),
                      "contextStride": 1})["Out"][0]
        if self.bias is not None:
            out = _trace("elementwise_add", {"X": [out], "Y": [self.bias]},
                         {"axis": -1})["Out"][0]
        return _act(out, self._act)


class RowConv(Layer):
    """ref dygraph/nn.py:2289 — lookahead row convolution."""

    def __init__(self, name_scope=None, future_context_size=2,
                 param_attr=None, act=None, dtype="float32", input_dim=None):
        super().__init__(name_scope, dtype)
        self._act = act
        self._k = future_context_size
        self._param_attr = param_attr
        self.weight = None
        if input_dim is not None:
            self._build(input_dim)

    def _build(self, dim):
        self.weight = self.create_parameter([self._k + 1, dim],
                                            attr=self._param_attr,
                                            dtype=self._dtype)

    def forward(self, input):
        if self.weight is None:
            self._build(input.shape[-1])
        out = _trace("row_conv", {"X": [input], "Filter": [self.weight]},
                     {})["Out"][0]
        return _act(out, self._act)


class TreeConv(Layer):
    """ref dygraph/nn.py:2564 — tree-based conv over node features and an
    adjacency-derived edge set; realized densely via matmul over a
    (batch, nodes, nodes) propagation matrix."""

    def __init__(self, name_scope=None, output_size=None, num_filters=1,
                 max_depth=2, act="tanh", param_attr=None, bias_attr=None,
                 dtype="float32", feature_size=None):
        super().__init__(name_scope, dtype)
        self._output_size = output_size
        self._num_filters = num_filters
        self._max_depth = max_depth
        self._act = act
        self.weight = self.create_parameter(
            [feature_size, 3, output_size, num_filters],
            attr=param_attr, dtype=dtype)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [num_filters], attr=bias_attr, dtype=dtype, is_bias=True))

    def forward(self, nodes_vector, edge_set):
        out = _trace("tree_conv",
                     {"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
                      "Filter": [self.weight]},
                     {"max_depth": self._max_depth})["Out"][0]
        if self.bias is not None:
            out = _trace("elementwise_add", {"X": [out], "Y": [self.bias]},
                         {"axis": -1})["Out"][0]
        return _act(out, self._act)


class Dropout(Layer):
    """Convenience eager dropout (2.0-style; the reference uses
    fluid.layers.dropout functionally in dygraph)."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, input):
        return _trace("dropout", {"X": [input]},
                      {"dropout_prob": self._p,
                       "is_test": not self.training,
                       "dropout_implementation": "upscale_in_train"}
                      )["Out"][0]
