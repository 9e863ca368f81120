"""Analytic per-op flops/bytes cost model over the dependency-ordered
``framework.ir`` Graph (the port's ``paddle_tpu/analysis/cost.py``).

The graph-fusion pass ranks its candidates by the per-class shares of this
model (``CostPlan.share()`` for flops, ``per_class_bytes`` for bytes), so
the port keeps the reference's accounting exactly:

- **matmul family** (``mul``/``matmul``/``matmul_v2``): 2·M·K·N;
- **conv2d**: 2·C_in·kh·kw per output element; **fused_conv1x1_bn**:
  2·C_in per output element;
- **grad ops** inherit their forward op's formula ×2;
- **everything else**: a per-element factor on the largest output;
- **bytes** per op = input bytes read + output bytes written at the
  resolved batch (symbolic dims take ``batch_size``).

Plans are cached on (program fingerprint, fetch tuple, batch).  The
reference's XLA cross-check (``xla_cost_*``) has no counterpart here.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..framework.core import Block, Program

__all__ = ["CostPlan", "plan_cost"]

#: op type -> roofline class.  Grad ops inherit their forward's class;
#: anything unlisted is "other".
_CLASS_OF = {
    "conv2d": "conv", "depthwise_conv2d": "conv", "conv2d_transpose": "conv",
    "mul": "matmul", "matmul": "matmul", "matmul_v2": "matmul",
    "lookup_table": "embedding", "lookup_table_v2": "embedding",
    "gather": "embedding", "gather_nd": "embedding",
    "scatter": "embedding", "scatter_nd_add": "embedding",
    "batch_norm": "norm", "layer_norm": "norm", "group_norm": "norm",
    "softmax": "softmax", "softmax_with_cross_entropy": "softmax",
    "cross_entropy": "softmax", "cross_entropy2": "softmax",
    "reduce_sum": "reduce", "reduce_mean": "reduce", "reduce_max": "reduce",
    "mean": "reduce", "sum": "reduce",
    "adam": "optimizer", "momentum": "optimizer", "sgd": "optimizer",
    "adagrad": "optimizer", "lamb": "optimizer", "rmsprop": "optimizer",
    "flash_attention": "attention", "fused_attention": "attention",
    # analysis.fusion rewrite targets keep their source chain's class so
    # the roofline shares survive fusion
    "fused_conv1x1_bn": "conv", "fused_dense_act": "matmul",
    "fused_embedding_layer_norm": "embedding",
}

#: per-element flop factors for the cheap elementwise classes; everything not
#: matched by a structural formula below falls back to one of these
_ELEM_FLOPS = {
    "softmax": 5.0, "softmax_with_cross_entropy": 7.0,
    "cross_entropy": 3.0, "cross_entropy2": 3.0,
    "layer_norm": 8.0, "batch_norm": 4.0, "group_norm": 8.0,
    "gelu": 9.0, "tanh": 6.0, "sigmoid": 4.0, "erf": 6.0,
    "exp": 2.0, "log": 2.0, "sqrt": 2.0, "rsqrt": 2.0, "pow": 3.0,
    "dropout": 2.0, "adam": 10.0, "lamb": 14.0, "momentum": 4.0,
    "fused_embedding_layer_norm": 8.0,
}

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "bool": 1}


def _itemsize(dtype) -> int:
    d = str(dtype or "float32")
    if d in _ITEMSIZE:
        return _ITEMSIZE[d]
    try:
        return int(np.dtype(d).itemsize)
    except TypeError:
        return 4


def _shape(block: Block, name, batch_size: int) -> Optional[Tuple[int, ...]]:
    if not name or not block.has_var(name):
        return None
    v = block.var(name)
    if v.shape is None:
        return None
    return tuple(batch_size if d in (-1, None) else int(d)
                 for d in v.shape)


def _numel(shape) -> int:
    if shape is None:
        return 0
    n = 1
    for d in shape:
        n *= max(int(d), 1)
    return n


def _var_bytes(block: Block, name, batch_size: int) -> int:
    s = _shape(block, name, batch_size)
    if s is None:
        return 0
    v = block.var(name)
    return max(_numel(s), 1) * _itemsize(v.dtype)


@dataclass
class CostPlan:
    """Analytic per-step flops/bytes model of one program."""

    #: total analytic flops per step (forward + backward + optimizer)
    flops: int = 0
    #: total logical bytes accessed per step (inputs read + outputs
    #: written, not deduplicated across ops — an upper bound on traffic)
    bytes: int = 0
    #: per-op attribution in dependency order:
    #: (pos, op_type, op_class, flops, bytes)
    per_op: List[tuple] = field(default_factory=list)
    #: op_class -> total flops (the roofline share the fusion arc ranks
    #: candidates by; ``share()`` normalizes)
    per_class: Dict[str, int] = field(default_factory=dict)
    #: op_class -> total bytes
    per_class_bytes: Dict[str, int] = field(default_factory=dict)
    batch_size: int = 1

    def share(self) -> Dict[str, float]:
        """Per-class flop share in [0, 1] (empty program: {})."""
        total = float(self.flops) or 1.0
        return {c: f / total for c, f in self.per_class.items()}

    def intensity(self) -> float:
        """Arithmetic intensity (flops per logical byte accessed)."""
        return self.flops / self.bytes if self.bytes else 0.0


def _slot(op, name):
    """Input slot resolution that also sees a GRAD op's forwarded
    forward-inputs (``make_grad_ops`` re-feeds them under ``X$<slot>`` —
    the same convention the verifier's int64 classifier follows)."""
    return op.input("X$" + name) or op.input(name)


def _matmul_flops(block, op, batch_size) -> Optional[int]:
    """2·M·K·N for the mul/matmul family; None when shapes are unknown."""
    xs = _slot(op, "X")
    ys = _slot(op, "Y")
    if not xs or not ys:
        return None
    x = _shape(block, xs[0], batch_size)
    y = _shape(block, ys[0], batch_size)
    if not x or not y:
        return None
    if op.type == "mul":
        # mul flattens X to 2-D at num_col_dims: [prod(lead), K] @ [K, N]
        ncd = int(op.attrs.get("x_num_col_dims", 1))
        m = _numel(x[:ncd])
        k = _numel(x[ncd:])
        n = _numel(y[1:]) if len(y) > 1 else 1
        return 2 * m * k * n
    tx = bool(op.attrs.get("transpose_X") or op.attrs.get("trans_x"))
    ty = bool(op.attrs.get("transpose_Y") or op.attrs.get("trans_y"))
    if len(x) == 1:                       # vector promotes to [1, K]
        x = (1,) + x
    if len(y) == 1:                       # vector promotes to [K, 1]
        y = y + (1,)
    xm, xk = (x[-1], x[-2]) if tx else (x[-2], x[-1])
    yn = y[-2] if ty else y[-1]
    lead = _numel(x[:-2]) if len(x) > 2 else \
        (_numel(y[:-2]) if len(y) > 2 else 1)
    return 2 * lead * xm * xk * yn


def _conv_flops(block, op, batch_size) -> Optional[int]:
    f = _slot(op, "Filter")
    # a conv grad has no "Output" slot; the output GRADIENT it consumes
    # has the forward output's shape, which is all the formula needs
    o = op.output("Output") or op.input("OG$Output") or \
        op.input("Output@GRAD")
    if not f or not o:
        return None
    w = _shape(block, f[0], batch_size)
    out = _shape(block, o[0], batch_size)
    if not w or not out or len(w) < 4 or len(out) < 4:
        return None
    # out [N, C_out, H, W]; filter [C_out, C_in/groups, kh, kw]
    return 2 * _numel(out) * w[1] * w[2] * w[3]


def _fused_conv1x1_flops(block, op, batch_size) -> Optional[int]:
    """fused_conv1x1_bn: the 1x1 conv is 2·Cin MACs per output element
    (the BN epilogue is elementwise noise the conv formula dominates)."""
    f = _slot(op, "Filter")
    y = op.output("Y") or op.input("OG$Y")
    if not f or not y:
        return None
    w = _shape(block, f[0], batch_size)
    out = _shape(block, y[0], batch_size)
    if not w or not out or len(w) < 2:
        return None
    return 2 * _numel(out) * w[1]


def _op_cost(block: Block, op, batch_size: int) -> Tuple[int, int, str]:
    """(flops, bytes, op_class) of one op at the resolved batch."""
    typ = op.type
    is_grad = typ.endswith("_grad")
    fwd = typ[: -len("_grad")] if is_grad else typ
    grad_mult = 2 if is_grad else 1

    in_bytes = sum(_var_bytes(block, n, batch_size)
                   for n in op.input_arg_names())
    out_bytes = sum(_var_bytes(block, n, batch_size)
                    for n in op.output_arg_names())
    bytes_ = in_bytes + out_bytes
    cls = _CLASS_OF.get(fwd, "other")

    flops = None
    if fwd in ("mul", "matmul", "matmul_v2"):
        flops = _matmul_flops(block, op, batch_size)
    elif fwd in ("conv2d", "depthwise_conv2d", "conv2d_transpose"):
        flops = _conv_flops(block, op, batch_size)
    elif fwd == "fused_conv1x1_bn":
        flops = _fused_conv1x1_flops(block, op, batch_size)
    elif fwd in ("lookup_table", "lookup_table_v2", "gather", "gather_nd",
                 "scatter", "scatter_nd_add"):
        flops = 0
    if flops is None:
        # per-element fallback on the dominant output (grad ops read the
        # forward's output names through the same var set, so the element
        # count is comparable)
        elems = max((_numel(_shape(block, n, batch_size))
                     for n in op.output_arg_names() if n), default=0)
        if not elems:
            elems = max((_numel(_shape(block, n, batch_size))
                         for n in op.input_arg_names() if n), default=0)
        flops = int(elems * _ELEM_FLOPS.get(fwd, 1.0))
    return int(flops) * grad_mult, int(bytes_), cls


# (program fingerprint, fetch tuple, batch) -> CostPlan; bounded FIFO —
# same discipline as the verifier and memory-planner caches
_CACHE: Dict[tuple, CostPlan] = {}  # guarded-by: _CACHE_LOCK
_CACHE_CAP = 128
_CACHE_LOCK = threading.Lock()


def plan_cost(program: Program, fetch_names=(),
              batch_size: int = 1) -> CostPlan:
    """Analytic flops/bytes plan for one program (see module docstring).
    Cached on (program fingerprint, fetch tuple, batch_size); symbolic
    (-1/None) dims resolve through ``batch_size``."""
    fetch_names = tuple(
        f.name if hasattr(f, "name") else f for f in (fetch_names or ()))
    key = (program.fingerprint(), fetch_names, int(batch_size))
    with _CACHE_LOCK:
        cached = _CACHE.get(key)
    if cached is not None:
        return cached
    plan = _plan(program, int(batch_size))
    with _CACHE_LOCK:
        if key not in _CACHE:
            if len(_CACHE) >= _CACHE_CAP:
                _CACHE.pop(next(iter(_CACHE)))
            _CACHE[key] = plan
        plan = _CACHE[key]
    return plan


def _plan(program: Program, batch_size: int) -> CostPlan:
    from ..framework import ir
    from ..framework.core import Block as _Block
    block = program.global_block()
    graph = ir.Graph(program)
    order = graph.topology_sort()

    plan = CostPlan(batch_size=batch_size)
    per_class: Dict[str, int] = {}
    per_class_bytes: Dict[str, int] = {}

    def add(pos, blk, op):
        if op.type in ("feed", "fetch"):
            return
        fl, by, cls = _op_cost(blk, op, batch_size)
        plan.flops += fl
        plan.bytes += by
        per_class[cls] = per_class.get(cls, 0) + fl
        per_class_bytes[cls] = per_class_bytes.get(cls, 0) + by
        plan.per_op.append((pos, op.type, cls, fl, by))
        # sub-block bodies (while/cond) count ONCE — a static model
        # cannot know the trip count; the per-iteration cost is the
        # honest per-step lower bound (same convention as the planner)
        for v in op.attrs.values():
            if isinstance(v, _Block):
                for sop in v.ops:
                    add(pos, v, sop)

    for i, node in enumerate(order):
        add(i, block, node.op)
    plan.per_class = per_class
    plan.per_class_bytes = per_class_bytes
    return plan
