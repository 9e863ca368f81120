"""Automatic mixed precision in bf16 (the port's ``paddle_tpu/amp.py``; ref
``python/paddle/fluid/contrib/mixed_precision/decorator.py:27,208``,
``fp16_lists.py``, ``fp16_utils.py``).

As in the reference, the program is not rewritten: the executor casts each
op's inputs as it runs the op (:func:`cast_ins`).  Matmul-class ops (the
white list) take bf16 operands, numerically sensitive ops (the black list)
float32, and the big elementwise ops (``BF16_IF_BIG``) bf16 when one of
their inputs is an activation of rank 3 or more.  Master weights stay
float32 in the scope: a grad op differentiates its forward through the
cast (``registry.run_forward``), so weight gradients come back float32.
bf16 needs no loss scaling; :class:`DynamicLossScaler` is the state machine
of fp16 policies, kept for parity.

The same policy lives inside the fused ops' lowerings
(``ops/fused_ops.py``), which are in no list: one blanket cast over a fused
op would differ from the per-op casts of the chain it replaced.
"""

from __future__ import annotations

import torch

from . import monitor as _monitor

# ops whose FLOPs dominate and that are bf16-safe (ref fp16_lists.py
# white_list)
WHITE_LIST = {
    "mul", "matmul", "matmul_v2", "conv2d", "depthwise_conv2d", "conv3d",
    "conv2d_transpose", "fc", "bilinear_tensor_product",
}

# numerically sensitive ops forced to float32 (ref fp16_lists.py
# black_list).  The norm and softmax lowerings compute their statistics in
# float32 and return the input's dtype, so they are not here.
BLACK_LIST = {
    "softmax_with_cross_entropy", "softmax_with_cross_entropy_grad",
    "cross_entropy", "cross_entropy2",
    "mean", "reduce_mean", "reduce_sum", "sum", "exp", "log",
    "squared_l2_norm", "l2_normalize", "norm",
    "sigmoid_cross_entropy_with_logits",
    "isfinite", "sqrt", "rsqrt", "pow", "logsumexp",
}

# big elementwise traffic: bf16 only on activations (ndim >= 3), so scalar
# and learning-rate arithmetic keeps full precision
BF16_IF_BIG = {
    "elementwise_add", "elementwise_sub", "elementwise_mul", "dropout",
    "gelu", "relu", "tanh", "sigmoid", "swish", "leaky_relu", "relu6",
    "softmax", "layer_norm", "batch_norm", "group_norm", "scale", "concat",
}

_COMPUTE = torch.bfloat16
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

# norm ops carry float32 state (running statistics, scale and bias) that
# must not be rounded to bf16 every step: only the activation slot is cast
_SLOT_RESTRICT = {"batch_norm": {"X"}, "layer_norm": {"X"},
                  "group_norm": {"X"}}


def _cast_all(ins, target, slots=None):
    out = {}
    for slot, arrs in ins.items():
        if slots is not None and slot not in slots:
            out[slot] = arrs
            continue
        out[slot] = [a.to(target) if isinstance(a, torch.Tensor)
                     and a.dtype in _FLOATS and a.dtype != target else a
                     for a in arrs]
    return out


def cast_ins(op_type: str, ins):
    """Apply the AMP policy to an op's input tensors as it runs."""
    base = op_type[:-5] if op_type.endswith("_grad") else op_type
    if base in WHITE_LIST or op_type in WHITE_LIST:
        return _cast_all(ins, _COMPUTE)
    if base in BLACK_LIST or op_type in BLACK_LIST:
        return _cast_all(ins, torch.float32)
    if base in BF16_IF_BIG:
        big = any(isinstance(a, torch.Tensor) and a.dim() >= 3
                  for arrs in ins.values() for a in arrs)
        if big:
            return _cast_all(ins, _COMPUTE, _SLOT_RESTRICT.get(base))
    return ins


def enable(program=None):
    """Turn on bf16 AMP for a program's runs."""
    from .framework.core import default_main_program
    program = program or default_main_program()
    program._attrs["amp"] = True
    program._bump_version()
    return program


class DynamicLossScaler:
    """Dynamic loss-scaling state machine (ref decorator.py:208
    ``update_loss_scaling``): halve the scale (and skip the step) on a
    non-finite gradient, grow it after ``incr_every_n_steps`` consecutive
    clean steps.  The live scale is the ``paddle_tpu_amp_scale`` gauge,
    skipped steps count in ``paddle_tpu_amp_skipped_steps_total``, and each
    skipped step and scale move is a numerics anomaly record
    (``analysis.numerics.record_anomaly``, the ``amp.loss_scale`` tracer
    instant; ref amp.py:114-152)."""

    def __init__(self, init_loss_scaling=2 ** 15, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0,
                 decr_ratio=0.8, min_scale=1.0):
        self.scale = float(init_loss_scaling)
        self.incr_every_n_steps = int(incr_every_n_steps)
        self.decr_every_n_nan_or_inf = max(int(decr_every_n_nan_or_inf), 1)
        self.incr_ratio = float(incr_ratio)
        self.decr_ratio = float(decr_ratio)
        self.min_scale = float(min_scale)
        self._good_steps = 0
        self._bad_steps = 0
        self._step = 0
        self._gauge = _monitor.REGISTRY.gauge(
            "paddle_tpu_amp_scale",
            "current dynamic loss scale (fp16 AMP); a scale pinned at "
            "its minimum with skipped steps climbing means the model "
            "is producing non-finite grads every step")
        self._skip_ctr = _monitor.REGISTRY.counter(
            "paddle_tpu_amp_skipped_steps_total",
            "optimizer steps SKIPPED by dynamic loss scaling "
            "(non-finite gradients at the current scale)")
        self._gauge.set(self.scale)

    def _event(self, kind, value=None, detail=None):
        from .analysis import numerics as _numerics
        _numerics.record_anomaly(
            kind, step=self._step, value=value,
            detail=dict(detail or (), scale=self.scale),
            instant="amp.loss_scale")

    def update(self, found_inf) -> bool:
        """Feed one step's found-non-finite verdict; True when the step's
        update is to be applied, False when it is to be skipped."""
        self._step += 1
        if bool(found_inf):
            self._good_steps = 0
            self._bad_steps += 1
            self._skip_ctr.inc()
            if self._bad_steps >= self.decr_every_n_nan_or_inf:
                self._bad_steps = 0
                old = self.scale
                self.scale = max(self.scale * self.decr_ratio,
                                 self.min_scale)
                self._gauge.set(self.scale)
                self._event("loss_scale_decreased", value=self.scale,
                            detail={"from": old})
            else:
                self._event("step_skipped", value=self.scale)
            return False
        self._bad_steps = 0
        self._good_steps += 1
        if self._good_steps >= self.incr_every_n_steps:
            self._good_steps = 0
            old = self.scale
            self.scale = self.scale * self.incr_ratio
            self._gauge.set(self.scale)
            self._event("loss_scale_increased", value=self.scale,
                        detail={"from": old})
        return True


def decorate(optimizer, amp_lists=None, init_loss_scaling=2 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True):
    """ref decorator.py:27: an optimizer whose ``minimize`` (and
    ``backward``) turns on bf16 AMP for the loss's program.  bf16 needs no
    loss scaling, so no run applies the scale; ``.loss_scaler`` is the
    state machine for callers that drive an fp16 policy."""

    class _AmpOptimizer:
        def __init__(self, inner):
            self._inner = inner
            self.loss_scaler = (
                DynamicLossScaler(
                    init_loss_scaling=init_loss_scaling,
                    incr_every_n_steps=incr_every_n_steps,
                    decr_every_n_nan_or_inf=decr_every_n_nan_or_inf,
                    incr_ratio=incr_ratio, decr_ratio=decr_ratio)
                if use_dynamic_loss_scaling else None)

        @property
        def _loss_scaling(self):
            return (self.loss_scaler.scale
                    if self.loss_scaler is not None
                    else float(init_loss_scaling))

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def minimize(self, loss, **kw):
            enable(loss.block.program)
            return self._inner.minimize(loss, **kw)

        def backward(self, loss, **kw):
            enable(loss.block.program)
            return self._inner.backward(loss, **kw)

    return _AmpOptimizer(optimizer)
