"""Shape rules: the output shapes and dtypes of common op types derived
from their inputs' without running the lowering.

Shape inference (``registry.infer_op``) runs a lowering on meta tensors.
torch computes many ops on meta tensors with Python reference kernels,
and the first call of one imports ``torch._dynamo`` (8–10 s of a process's
start on an H100 host, PERF.md 27b).  Each op type here gets a rule
instead: ``rule(ins, attrs) -> {slot: [Meta]}`` over ``Meta(shape,
dtype)`` inputs, the shapes with ``registry.SENTINEL`` for a symbolic dim,
giving what the lowering gives on meta tensors (held against that in
``tests/test_torch_shape_rules.py``).  A rule raises where the lowering
would, and the outputs then stay unset, as they do after a failed meta
run.  The op types are those the GPT, ResNet-50 and DeepFM training
programs build with.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from ..framework.registry import Meta, get_op_info
from .common import canon_axis, canon_dtype, reduce_axes


def _meta(m: Meta) -> torch.Tensor:
    """An empty meta tensor of ``m``: creating one runs no Python kernel,
    and ``torch.result_type`` of such tensors is C++."""
    return torch.empty(m.shape, dtype=m.dtype, device="meta")


def broadcast(*shapes: Sequence[int]) -> tuple:
    """numpy's (and torch's) broadcast of ``shapes``; raises on a
    mismatch."""
    n = max(len(s) for s in shapes)
    out = []
    for i in range(n):
        dims = {s[i - n + len(s)] for s in shapes if i - n + len(s) >= 0}
        dims.discard(1)
        if len(dims) > 1:
            raise ValueError(f"shapes {shapes} do not broadcast")
        out.append(dims.pop() if dims else 1)
    return tuple(out)


def result_type(*ms: Meta) -> torch.dtype:
    dtype = torch.result_type(_meta(ms[0]), _meta(ms[1])) \
        if len(ms) > 1 else ms[0].dtype
    for m in ms[2:]:
        dtype = torch.result_type(torch.empty((1,) * len(m.shape)
                                              if m.shape else (),
                                              dtype=dtype, device="meta"),
                                  _meta(m))
    return dtype


def like(m: Meta) -> Meta:
    return Meta(tuple(m.shape), m.dtype)


def _x_aligned(x: Meta, y: Meta, axis) -> tuple:
    """``common.broadcast_to_x``'s reshape of y, on shapes."""
    xs, ys = tuple(x.shape), tuple(y.shape)
    if not ys or ys == xs:
        return ys
    if axis == -1:
        axis = len(xs) - len(ys)
    trail = len(xs) - axis - len(ys)
    if trail < 0:
        return ys
    return (1,) * axis + ys + (1,) * trail


def _elementwise(name):
    def rule(ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        ys = _x_aligned(x, y, attrs.get("axis", -1))
        dtype = result_type(x, Meta(ys, y.dtype))
        if name == "elementwise_div" and not dtype.is_floating_point:
            dtype = torch.get_default_dtype()       # torch.div divides
        return {"Out": [Meta(broadcast(x.shape, ys), dtype)]}
    return rule


def _compare(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    ys = _x_aligned(x, y, attrs.get("axis", -1))
    return {"Out": [Meta(broadcast(x.shape, ys), torch.bool)]}


def _unary(ins, attrs):
    return {"Out": [like(ins["X"][0])]}


def _gelu(ins, attrs):
    x = ins["X"][0]
    if not x.dtype.is_floating_point:
        raise TypeError(f"gelu of {x.dtype}")
    return {"Out": [like(x)]}


def _scale(ins, attrs):
    x, st = ins["X"][0], (ins.get("ScaleTensor") or [None])[0]
    shape = broadcast(x.shape, st.shape) if st is not None else x.shape
    return {"Out": [Meta(tuple(shape), x.dtype)]}


def _sum(ins, attrs):
    xs = [m for m in ins["X"] if m is not None]
    return {"Out": [Meta(broadcast(*[m.shape for m in xs]),
                         result_type(*xs))]}


def _adam(ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    return {"ParamOut": [like(p)],
            "Moment1Out": [Meta(broadcast(m1.shape, g.shape),
                                result_type(m1, g))],
            "Moment2Out": [Meta(broadcast(m2.shape, g.shape),
                                result_type(m2, g))],
            "Beta1PowOut": [like(ins["Beta1Pow"][0])],
            "Beta2PowOut": [like(ins["Beta2Pow"][0])]}


def _sgd(ins, attrs):
    return {"ParamOut": [like(ins["Param"][0])]}


def _momentum(ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    return {"ParamOut": [like(p)],
            "VelocityOut": [Meta(broadcast(v.shape, g.shape),
                                 result_type(v, g))]}


def _layer_norm(ins, attrs):
    x = ins["X"][0]
    lead = tuple(x.shape[:attrs.get("begin_norm_axis", 1)])
    return {"Y": [like(x)], "Mean": [Meta(lead, torch.float32)],
            "Variance": [Meta(lead, torch.float32)]}


def _batch_norm(ins, attrs):
    from .nn_ops import _bn_axes
    x, mean, var = ins["X"][0], ins["Mean"][0], ins["Variance"][0]
    if attrs.get("use_global_stats", False) or attrs.get("is_test", False):
        return {"Y": [like(x)], "MeanOut": [like(mean)],
                "VarianceOut": [like(var)], "SavedMean": [like(mean)],
                "SavedVariance": [like(var)]}
    axes, _ = _bn_axes(attrs.get("data_layout", "NCHW"), len(x.shape))
    stat = Meta(tuple(d for i, d in enumerate(x.shape) if i not in axes),
                torch.float32)
    return {"Y": [like(x)],
            "MeanOut": [Meta(broadcast(mean.shape, stat.shape),
                             result_type(mean, stat))],
            "VarianceOut": [Meta(broadcast(var.shape, stat.shape),
                                 result_type(var, stat))],
            "SavedMean": [stat], "SavedVariance": [stat]}


def _lookup_table(ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    shape = tuple(ids.shape)
    if len(shape) >= 2 and shape[-1] == 1:
        shape = shape[:-1]
    return {"Out": [Meta(shape + tuple(w.shape[1:]), w.dtype)]}


def _matmul(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    xs, ys = list(x.shape), list(y.shape)
    if len(xs) == 1:
        xs = [1] + xs
    if len(ys) == 1:
        ys = ys + [1]
    if attrs.get("transpose_X", False):
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if attrs.get("transpose_Y", False):
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if xs[-1] != ys[-2]:
        raise ValueError(f"matmul of {x.shape} and {y.shape}")
    if len(xs) == 2 and len(ys) == 2:
        shape = (xs[0], ys[1])
    else:
        shape = broadcast(xs[:-2], ys[:-2]) + (xs[-2], ys[-1])
    return {"Out": [Meta(tuple(shape), result_type(x, y))]}


def _range(ins, attrs):
    if any(ins.get(s) and ins[s][0] is not None
           for s in ("Start", "End", "Step")):
        raise TypeError("range bounds are read from a tensor at run time")
    s, e, st = attrs.get("start", 0), attrs.get("end"), attrs.get("step", 1)
    n = math.ceil((e - s) / st)
    if n < 0:
        raise ValueError(f"range({s}, {e}, {st})")
    return {"Out": [Meta((n,), canon_dtype(attrs.get("dtype", "float32")))]}


def _random(ins, attrs):
    shape = tuple(attrs.get("shape", []))
    if any(d < 0 for d in shape):
        raise ValueError(f"random shape {shape}")
    return {"Out": [Meta(shape, canon_dtype(attrs.get("dtype",
                                                       "float32")))]}


def _accuracy(ins, attrs):
    return {"Accuracy": [Meta((), torch.float32)],
            "Correct": [Meta((), torch.int32)],
            "Total": [Meta((), torch.int32)]}


def _cross_entropy(ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    if attrs.get("soft_label", False):
        shape = broadcast(label.shape, x.shape)
        return {"Y": [Meta(shape[:-1] + (1,), result_type(label, x))]}
    li = tuple(label.shape)
    if len(li) == len(x.shape) and li[-1] == 1:
        li = li[:-1]
    return {"Y": [Meta(li + (1,), x.dtype)]}


def _mean(ins, attrs):
    return {"Out": [Meta((), ins["X"][0].dtype)]}


def _reduce(ins, attrs):
    x = ins["X"][0]
    nd = len(x.shape)
    axes = reduce_axes(attrs.get("dim"), nd, attrs.get("reduce_all", False))
    if not axes:
        return {"Out": [like(x)]}
    keep = attrs.get("keep_dim", False)
    shape = tuple(1 if i in axes else d for i, d in enumerate(x.shape)
                  if keep or i not in axes)
    dtype = x.dtype if x.dtype.is_floating_point else torch.int64
    return {"Out": [Meta(shape, dtype)]}


def _gather(ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    ishape = tuple(idx.shape)
    if len(ishape) == 2 and ishape[1] == 1:
        ishape = ishape[:1]
    axis = canon_axis(attrs.get("axis", 0), len(x.shape))
    return {"Out": [Meta(tuple(x.shape[:axis]) + ishape
                         + tuple(x.shape[axis + 1:]), x.dtype)]}


def _pool2d(ins, attrs):
    from .nn_ops import _pair, _pool_extra
    x = ins["X"][0]
    n, c, h, w = x.shape
    kh, kw = _pair(attrs.get("ksize", [1, 1]))
    if attrs.get("global_pooling", False) or (
            attrs.get("adaptive", False) and (kh, kw) == (1, 1)):
        return {"Out": [Meta((n, c, 1, 1), x.dtype)]}
    if attrs.get("adaptive", False):
        if h % kh or w % kw:
            raise NotImplementedError("adaptive pool needs divisible sizes")
        return {"Out": [Meta((n, c, kh, kw), x.dtype)]}
    sh, sw = _pair(attrs.get("strides", [1, 1]))
    ph, pw = _pair(attrs.get("paddings", [0, 0]))
    ceil = attrs.get("ceil_mode", False)
    oh = (h + 2 * ph + _pool_extra(h, kh, sh, ph, ceil) - kh) // sh + 1
    ow = (w + 2 * pw + _pool_extra(w, kw, sw, pw, ceil) - kw) // sw + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"pool2d output {oh} x {ow}")
    return {"Out": [Meta((n, c, oh, ow), x.dtype)]}


def _concat(ins, attrs):
    xs = [m for m in ins["X"] if m is not None]
    axis = canon_axis(attrs.get("axis", 0), len(xs[0].shape))
    shape = list(xs[0].shape)
    for m in xs[1:]:
        if len(m.shape) != len(shape) or any(
                a != b for i, (a, b) in enumerate(zip(m.shape, shape))
                if i != axis):
            raise ValueError(f"concat of {[m.shape for m in xs]}")
    shape[axis] = sum(m.shape[axis] for m in xs)
    return {"Out": [Meta(tuple(shape), result_type(*xs))]}


def _sigmoid_ce(ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    return {"Out": [Meta(broadcast(x.shape, label.shape),
                         result_type(x, label))]}


def _float_unary(ins, attrs):
    x = ins["X"][0]
    dtype = x.dtype if x.dtype.is_floating_point \
        else torch.get_default_dtype()
    return {"Out": [Meta(tuple(x.shape), dtype)]}


def _logical_not(ins, attrs):
    return {"Out": [Meta(tuple(ins["X"][0].shape), torch.bool)]}


def _squeeze2(ins, attrs):
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    if axes:
        drop = {canon_axis(a, len(x.shape)) for a in axes}
        drop = {a for a in drop if x.shape[a] == 1}
        shape = tuple(d for i, d in enumerate(x.shape) if i not in drop)
    else:
        shape = tuple(d for d in x.shape if d != 1)
    return {"Out": [Meta(shape, x.dtype)],
            "XShape": [Meta((0,) + tuple(x.shape), x.dtype)]}


def _stack(ins, attrs):
    xs = [m for m in ins["X"] if m is not None]
    if any(tuple(m.shape) != tuple(xs[0].shape) for m in xs):
        raise ValueError(f"stack of {[m.shape for m in xs]}")
    shape = list(xs[0].shape)
    axis = canon_axis(attrs.get("axis", 0), len(shape) + 1)
    return {"Y": [Meta(tuple(shape[:axis] + [len(xs)] + shape[axis:]),
                       result_type(*xs))]}


def _fill_batch_size_like(ins, attrs):
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ins["Input"][0].shape[attrs.get("input_dim_idx", 0)]
    return {"Out": [Meta(tuple(shape), canon_dtype(attrs["dtype"]))]}


def _sequence_mask(ins, attrs):
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise TypeError("sequence_mask's maxlen is read at run time")
    n = math.prod(ins["X"][0].shape)
    return {"Y": [Meta((n, maxlen),
                       canon_dtype(attrs.get("out_dtype", "int64")))]}


def _array_write(ins, attrs):
    x, arr = ins["X"][0], (ins.get("Array") or [None])[0]
    out = like(arr) if arr is not None else Meta(
        (attrs.get("max_len", 128),) + tuple(x.shape), x.dtype)
    return {"Out": [out], "OutLen": [Meta((), torch.int32)]}


def _array_read(ins, attrs):
    arr = ins["Array"][0]
    return {"Out": [Meta(tuple(arr.shape[1:]), arr.dtype)]}


def _swce(ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    nd = len(logits.shape)
    axis = canon_axis(attrs.get("axis", -1), nd)
    if attrs.get("soft_label", False):
        shape = list(broadcast(label.shape, logits.shape))
        shape[axis] = 1
        return {"Softmax": [like(logits)],
                "Loss": [Meta(tuple(shape), result_type(label, logits))]}
    li = list(label.shape)
    if len(li) == nd and li[axis] == 1:
        del li[axis]
    li.insert(canon_axis(attrs.get("axis", -1), len(li) + 1), 1)
    return {"Softmax": [like(logits)],
            "Loss": [Meta(tuple(li), logits.dtype)]}


def _squared_l2_norm(ins, attrs):
    return {"Out": [Meta((1,), ins["X"][0].dtype)]}


def _masked_update(ins, attrs):
    new, prev = ins["New"][0], ins["Prev"][0]
    return {"Out": [Meta(broadcast(new.shape, prev.shape),
                         result_type(new, prev))]}


def _beam_search(ins, attrs):
    scores = ins["scores"][0]
    bb = scores.shape[0]
    dtype = scores.dtype if attrs.get("is_accumulated", True) else \
        result_type(ins["pre_scores"][0], scores)
    return {"selected_ids": [Meta((bb, 1), torch.int64)],
            "selected_scores": [Meta((bb, 1), dtype)],
            "parent_idx": [Meta((bb,), torch.int64)]}


def _beam_search_decode(ins, attrs):
    ids, scores = ins["Ids"][0], ins["Scores"][0]
    t, beam = ids.shape[0], attrs["beam_size"]
    bb = math.prod(ids.shape[1:])
    shape = (bb // beam, beam, t)
    return {"SentenceIds": [Meta(shape, torch.int64)],
            "SentenceScores": [Meta(shape, scores.dtype)]}


RULES: Dict[str, object] = {
    **{t: _elementwise(t) for t in (
        "elementwise_add", "elementwise_sub", "elementwise_mul",
        "elementwise_div")},
    "greater_than": _compare, "relu": _unary, "sign": _unary,
    "gelu": _gelu,
    "scale": _scale, "sum": _sum, "sgd": _sgd, "momentum": _momentum,
    "adam": _adam, "layer_norm": _layer_norm,
    "batch_norm": _batch_norm, "lookup_table": _lookup_table,
    "matmul": _matmul, "range": _range, "uniform_random": _random,
    "gaussian_random": _random, "accuracy": _accuracy,
    "cross_entropy": _cross_entropy, "mean": _mean, "pool2d": _pool2d,
    "concat": _concat, "sigmoid_cross_entropy_with_logits": _sigmoid_ce,
    # the seq2seq programs' (control flow, the recurrent layers, decoding)
    "less_than": _compare, "log": _float_unary, "tanh": _float_unary,
    "sigmoid": _float_unary, "sqrt": _float_unary, "increment": _unary,
    "elementwise_max": _elementwise("elementwise_max"),
    "reduce_mean": _reduce, "reduce_sum": _reduce, "gather": _gather,
    "softmax_with_cross_entropy": _swce,
    "squared_l2_norm": _squared_l2_norm,
    "drnn_masked_update": _masked_update, "beam_search": _beam_search,
    "beam_search_decode": _beam_search_decode,
    "logical_not": _logical_not, "squeeze2": _squeeze2, "stack": _stack,
    "fill_constant_batch_size_like": _fill_batch_size_like,
    "sequence_mask": _sequence_mask, "array_write": _array_write,
    "array_read": _array_read,
}


for _t, _rule in RULES.items():
    get_op_info(_t).shape = _rule
