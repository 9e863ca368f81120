"""The layer DSL: Python functions appending ops to the default main program.

The subset of ``paddle_tpu/layers/nn.py`` that the serving, training and
ResNet slices use, with
the reference's signatures and op descs (ref ``python/paddle/fluid/layers/
nn.py``; ``fc`` at :231 is the canonical pattern: LayerHelper -> create
params -> append ops -> bias -> activation).
"""

from __future__ import annotations

import numpy as np

from ..framework.core import Variable
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .math_ops import _elementwise_binary, scale  # noqa: F401  (re-export)


# ---------------------------------------------------------------------------
# dense / embedding
# ---------------------------------------------------------------------------

def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """ref layers/nn.py:231 — mul(+sum) + elementwise_add + act."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    dtype = inputs[0].dtype
    mul_results = []
    pattrs = param_attr if isinstance(param_attr, (list, tuple)) \
        else [param_attr] * len(inputs)
    for inp, pa in zip(inputs, pattrs):
        in_dim = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(pa, shape=[in_dim, size], dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op("mul", inputs={"X": [inp], "Y": [w]},
                         outputs={"Out": [tmp]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op("sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """ref layers/nn.py embedding → lookup_table op."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op("lookup_table", inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"padding_idx": pad, "is_sparse": is_sparse,
                            "is_distributed": is_distributed})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": float(alpha)})
    return out


# ---------------------------------------------------------------------------
# conv / pool
# ---------------------------------------------------------------------------

def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """ref ``paddle_tpu/layers/nn.py:97`` → conv2d op + bias + act; the
    filter starts from N(0, 2 / (kh·kw·C_in))."""
    helper = LayerHelper("conv2d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    num_channels = input.shape[1] if data_format == "NCHW" \
        else input.shape[-1]
    fs = _pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + fs
    std = (2.0 / (fs[0] * fs[1] * num_channels)) ** 0.5
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=dtype,
                                default_initializer=NormalInitializer(0.0,
                                                                      std))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op("conv2d", inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": _pair(stride),
                            "paddings": _pair(padding),
                            "dilations": _pair(dilation), "groups": groups,
                            "data_format": data_format})
    if bias_attr is False:
        pre_act = pre_bias
    else:
        b = helper.create_parameter(bias_attr, shape=[num_filters],
                                    dtype=dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(dtype)
        helper.append_op("elementwise_add",
                         inputs={"X": [pre_bias], "Y": [b]},
                         outputs={"Out": [pre_act]}, attrs={"axis": 1})
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type,
                            "ksize": _pair(pool_size),
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding),
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode, "exclusive": exclusive,
                            "data_format": data_format})
    return out


# ---------------------------------------------------------------------------
# normalization / softmax
# ---------------------------------------------------------------------------

def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """ref ``paddle_tpu/layers/nn.py:200`` → batch_norm op.  The running
    mean and variance are persistable, not trainable, and the op writes
    them in place (``MeanOut`` is ``Mean``, ``VarianceOut`` is
    ``Variance``)."""
    helper = LayerHelper("batch_norm", act=act, name=name)
    dtype = input.dtype
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype,
                                   is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False),
        shape=[c], dtype="float32",
        default_initializer=ConstantInitializer(0.0))
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False),
        shape=[c], dtype="float32",
        default_initializer=ConstantInitializer(1.0))
    mean.stop_gradient = True
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference("float32", True)
    saved_var = helper.create_variable_for_type_inference("float32", True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("layer_norm", act=act, name=name)
    dtype = input.dtype
    norm_dim = int(np.prod(input.shape[begin_norm_axis:]))
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(param_attr, shape=[norm_dim], dtype=dtype,
                                    default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, shape=[norm_dim], dtype=dtype,
                                    is_bias=True)
        inputs["Bias"] = [b]
    mean = helper.create_variable_for_type_inference("float32", True)
    var = helper.create_variable_for_type_inference("float32", True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("softmax", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


# ---------------------------------------------------------------------------
# losses and reductions
# ---------------------------------------------------------------------------

def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    sm = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [sm], "Loss": [loss]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis})
    if return_softmax:
        return loss, sm
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy", inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def square_error_cost(input, label):
    """ref ``paddle_tpu/layers/nn.py:388``: (input - label)^2."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square_error_cost",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64", True)
    inputs = {"X": [input]}
    attrs = {}
    if isinstance(input, Variable) and isinstance(k, Variable):
        inputs["K"] = [k]
    else:
        attrs["k"] = int(k)
    helper.append_op("top_k", inputs=inputs,
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs=attrs)
    return values, indices


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    """ref ``paddle_tpu/layers/nn.py:397``: the elementwise logistic loss
    of logits ``x`` against ``label`` in [0, 1]."""
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


def fused_lm_head_ce(x, size, label, param_attr=None, bias_attr=None,
                     ignore_index=-100, chunk_size=1024):
    """Chunked LM head + cross-entropy (ref ``paddle_tpu/layers/nn.py:1507``):
    O(chunk × vocab) memory instead of ``[tokens, vocab]`` logits.  Owns its
    projection parameters like ``fc`` (weight ``[d_in, size]``)."""
    helper = LayerHelper("fused_lm_head_ce", param_attr=param_attr,
                         bias_attr=bias_attr)
    d_in = int(x.shape[-1])
    w = helper.create_parameter(param_attr, shape=[d_in, size],
                                dtype=x.dtype)
    inputs = {"X": [x], "W": [w], "Label": [label]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[size], dtype=x.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b]
    loss = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "fused_lm_head_ce", inputs=inputs, outputs={"Loss": [loss]},
        attrs={"ignore_index": ignore_index, "chunk_size": chunk_size})
    return loss


def _reduce(op_type, input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    helper.append_op(op_type, inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"dim": dim, "keep_dim": keep_dim,
                            "reduce_all": dim is None})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------

def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("unsqueeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim, "sections": []}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "axis": dim, "sections": list(num_or_sections)}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op("split", inputs={"X": [input]}, outputs={"Out": outs},
                     attrs=attrs)
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("expand", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def flatten(x, axis=1, name=None):
    """ref ``paddle_tpu/layers/nn.py:620``: the ``flatten2`` op, x as
    [prod(shape[:axis]), prod(shape[axis:])]."""
    helper = LayerHelper("flatten", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("flatten2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": axis})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------

def elementwise_add(x, y, axis=-1, act=None, name=None):
    """ref ``paddle_tpu/layers/nn.py:801``: ``x + y``."""
    return _elementwise_binary(x, y, "elementwise_add", axis=axis, act=act)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    """ref ``paddle_tpu/layers/nn.py:805``: ``x - y``."""
    return _elementwise_binary(x, y, "elementwise_sub", axis=axis, act=act)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    """ref ``paddle_tpu/layers/nn.py:809``: ``x * y``."""
    return _elementwise_binary(x, y, "elementwise_mul", axis=axis, act=act)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    """ref ``paddle_tpu/layers/nn.py:829``: ``x mod y``, the sign of y."""
    return _elementwise_binary(x, y, "elementwise_mod", axis=axis, act=act)


def _unary(op_type, x, name=None, **attrs):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def relu(x, name=None): return _unary("relu", x, name)
def sigmoid(x, name=None): return _unary("sigmoid", x, name)
def sign(x, name=None): return _unary("sign", x, name)
def square(x, name=None): return _unary("square", x, name)
def tanh(x, name=None): return _unary("tanh", x, name)
def log(x, name=None): return _unary("log", x, name)
def sqrt(x, name=None): return _unary("sqrt", x, name)
def logical_not(x, out=None, name=None): return _unary("logical_not", x, name)


def _binary_logical(op_type, x, y, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def logical_and(x, y, out=None, name=None):
    return _binary_logical("logical_and", x, y, name)


def logical_or(x, y, out=None, name=None):
    return _binary_logical("logical_or", x, y, name)


def logical_xor(x, y, out=None, name=None):
    return _binary_logical("logical_xor", x, y, name)


def squeeze(input, axes, name=None):
    """ref ``paddle_tpu/layers/nn.py:600``: the ``squeeze2`` op."""
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op("stack", inputs={"X": xs}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """A host Python function as an op (ref ``paddle_tpu/layers/nn.py:1462``,
    py_func_op.cc).  ``out`` vars are made beforehand with their shapes (a
    leading -1 is the batch); ``backward_func(*x, *out, *out_grads) ->
    x_grads`` differentiates it."""
    from ..ops.control_flow_ops import PY_FUNC_TABLE
    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    fid = len(PY_FUNC_TABLE)
    PY_FUNC_TABLE[fid] = {"forward": func, "backward": backward_func}
    helper.append_op("py_func", inputs={"X": list(xs)},
                     outputs={"Out": list(outs)},
                     attrs={"func_id": fid,
                            "out_shapes": [list(o.shape) for o in outs],
                            "out_dtypes": [o.dtype for o in outs]})
    return out


# ---------------------------------------------------------------------------
# dropout and gather
# ---------------------------------------------------------------------------

def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """ref ``paddle_tpu/layers/nn.py:507`` (``operators/dropout_op.cc``).

    The keep mask is one byte of a Philox stream an element
    (``paddle_tpu_torch.kernels.dropout``), so the drop probability is
    quantized to multiples of 1/256, and a tiny nonzero ``dropout_prob``
    drops at least 1/256 of the elements.  The op's tag is ``seed`` when
    given (two ops given one seed draw the same pattern), else the crc32
    of its output's name: the op and its grad op draw the same bits from
    the run's seed and the tag, so the mask is regenerated, not stored.
    ``seed=0`` makes an untagged op, whose grad reads its stored mask."""
    import zlib
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8", True)
    tag = seed if seed is not None else \
        (zlib.crc32(out.name.encode()) & 0x7FFFFFFF) or 1
    helper.append_op("dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": tag,
                            "dropout_implementation": dropout_implementation})
    return out


def gather(input, index, overwrite=True):
    """ref ``paddle_tpu/layers/nn.py:693``: rows of ``input`` at
    ``index``."""
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


# ---------------------------------------------------------------------------
# fused attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    block_q=None, block_k=None, name=None):
    """Fused online-softmax attention over [b, h, T, d] tensors (ref
    ``paddle_tpu/layers/nn.py:1153``): the ``flash_attention`` op, run by
    the port's CUDA kernel (``paddle_tpu_torch.kernels.flash_attention``).
    ``block_q``/``block_k`` are recorded in the op desc for parity; the
    CUDA kernel picks its own tiles."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if bias is not None:
        inputs["Bias"] = [bias]
    helper.append_op("flash_attention", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"causal": causal, "sm_scale": sm_scale or 0.0,
                            "block_q": block_q or 0, "block_k": block_k or 0})
    return out


def ring_attention(q, k, v, causal=False, sm_scale=None, axis_name="sp",
                   name=None):
    """Sequence-parallel attention (ref ``paddle_tpu/layers/nn.py:1175``):
    the ``ring_attention`` op.  Under a current mesh whose ``axis_name``
    axis has more than one rank, K/V shards rotate over that ring
    (``paddle_tpu_torch.kernels.ring_attention``); otherwise it runs
    flash attention."""
    helper = LayerHelper("ring_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    helper.append_op("ring_attention", inputs={"Q": [q], "K": [k], "V": [v]},
                     outputs={"Out": [out]},
                     attrs={"causal": causal, "sm_scale": sm_scale or 0.0,
                            "axis_name": axis_name})
    return out


def switch_moe_ffn(x, num_experts, d_inner, capacity_factor=1.25,
                   act="relu", param_prefix="moe", name=None):
    """Switch-Transformer mixture-of-experts FFN over a ``[b, t, d]`` input
    (ref ``paddle_tpu/layers/nn.py:1528-1567``).  Returns ``(out,
    aux_loss)``.  The expert weights carry ``dist_spec`` ``("ep", ...)``:
    a mesh with an ``ep`` axis splits the experts over it, and without one
    the annotations are inert and the layer runs dense."""
    helper = LayerHelper("switch_ffn", name=name)
    d = int(x.shape[-1])
    E, F = int(num_experts), int(d_inner)

    def _p(suffix, shape, ep_spec, is_bias=False):
        v = helper.create_parameter(
            ParamAttr(name=f"{param_prefix}.{suffix}"), shape, x.dtype,
            is_bias=is_bias)
        v.dist_spec = ep_spec
        return v

    gate_w = _p("gate.w", [d, E], None)
    w1 = _p("w1", [E, d, F], ("ep", None, None))
    b1 = _p("b1", [E, F], ("ep", None), is_bias=True)
    w2 = _p("w2", [E, F, d], ("ep", None, None))
    b2 = _p("b2", [E, d], ("ep", None), is_bias=True)

    out = helper.create_variable_for_type_inference(x.dtype)
    aux = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "switch_ffn",
        inputs={"X": [x], "GateW": [gate_w], "W1": [w1], "B1": [b1],
                "W2": [w2], "B2": [b2]},
        outputs={"Out": [out], "AuxLoss": [aux]},
        attrs={"capacity_factor": float(capacity_factor), "act": act})
    return out, aux
