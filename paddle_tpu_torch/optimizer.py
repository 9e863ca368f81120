"""Optimizers: append_backward + per-param optimize ops.

The static-graph half of ``paddle_tpu/optimizer.py`` (ref
``python/paddle/fluid/optimizer.py:50``): the base ``Optimizer`` creates a
learning-rate var and accumulators (persistables the startup program fills),
appends one optimize op per parameter, and ``minimize`` = append_backward →
(clip, regularize) → apply_gradients.  The ops, names and attrs are the
reference's, so both packages build the same training program.  Ported so
far: SGD (ref :631), Momentum (:701) and Adam (:1271, ``fused_flat``
included).  Dygraph, LARS, Lamb, DGC, Recompute and Lookahead are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

from .clip import append_gradient_clip_ops
from .framework import unique_name
from .framework.backward import append_backward
from .framework.core import (Variable, default_main_program,
                             default_startup_program)
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None, parameter_list=None):
        if parameter_list is not None:
            raise NotImplementedError("dygraph optimizers (parameter_list) "
                                      "are not ported yet")
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._learning_rate_var: Optional[Variable] = None
        self.helper: Optional[LayerHelper] = None

    # -- learning rate -------------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            return
        if self._learning_rate_var is not None:
            return
        from .layers.tensor import create_global_var
        self._learning_rate_var = create_global_var(
            shape=[1], value=float(self._learning_rate), dtype="float32",
            persistable=True,
            name=unique_name.generate("learning_rate"))

    def _global_learning_rate(self):
        return self._learning_rate_var

    @property
    def learning_rate(self):
        return self._learning_rate

    # -- accumulators --------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if name in self._accumulators and \
                param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        block = default_main_program().global_block()
        shape = list(shape if shape is not None else param.shape)
        var = block.create_var(
            name=unique_name.generate(f"{param.name}_{name}"),
            shape=shape, dtype=dtype or param.dtype, persistable=True,
            stop_gradient=True)
        sb = default_startup_program().global_block()
        sb.create_var(name=var.name, shape=shape, dtype=var.dtype,
                      persistable=True)
        sb.append_op("fill_constant", outputs={"Out": [var.name]},
                     attrs={"shape": shape, "dtype": var.dtype,
                            "value": float(fill_value)})
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- hooks ---------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, parameters_and_grads):
        pass

    # -- public API ----------------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        block = default_main_program().global_block()
        # clip/regularization/update ops are training-only: tag them so
        # clone(for_test=True) prunes the optimize tail (ref OpRole)
        with block.program._op_role_guard("optimize"):
            params_grads = append_gradient_clip_ops(params_grads,
                                                    self._grad_clip)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
            self._create_global_learning_rate()
            self._create_accumulators(block, [p for p, _ in params_grads])
            for pg in params_grads:
                self._append_optimize_op(block, pg)
            self._finish_update(block, params_grads)
        return []

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        if grad_clip is not None:
            self._grad_clip = grad_clip
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    """ref optimizer.py:631."""

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        block.append_op("sgd",
                        inputs={"Param": [p], "Grad": [g],
                                "LearningRate": [self._global_learning_rate()]},
                        outputs={"ParamOut": [p]})


class MomentumOptimizer(Optimizer):
    """ref optimizer.py:701."""

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        block.append_op("momentum",
                        inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                                "LearningRate": [self._global_learning_rate()]},
                        outputs={"ParamOut": [p], "VelocityOut": [v]},
                        attrs={"mu": self._momentum,
                               "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    """ref optimizer.py:1271.

    ``fused_flat=True`` replaces the per-param ``adam`` ops with ONE
    ``fused_adam`` op over the params (flat-concat update, one shared
    beta-pow pair); ``fused_max_numel`` keeps the larger params out of the
    flat group."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, fused_flat=False,
                 fused_max_numel=None, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._fused_flat = fused_flat
        self._fused_max_numel = fused_max_numel
        self._pending_fused = []

    def _in_flat_group(self, p):
        if self._fused_max_numel is None:
            return True
        n = 1
        for d in (p.shape or ()):
            n *= max(int(d), 1)
        return n <= self._fused_max_numel

    def _create_accumulators(self, block, parameters):
        flat_first = next((p for p in parameters
                           if self._in_flat_group(p)), None)
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            if self._fused_flat and self._in_flat_group(p) and \
                    flat_first is not None:
                # one shared beta-pow pair: every param steps together
                self._accumulators.setdefault("beta1_pow_acc", {})[p.name] = \
                    self._add_accumulator("beta1_pow_acc", flat_first,
                                          fill_value=self._beta1, shape=[1])
                self._accumulators.setdefault("beta2_pow_acc", {})[p.name] = \
                    self._add_accumulator("beta2_pow_acc", flat_first,
                                          fill_value=self._beta2, shape=[1])
            else:
                self._add_accumulator("beta1_pow_acc", p,
                                      fill_value=self._beta1, shape=[1])
                self._add_accumulator("beta2_pow_acc", p,
                                      fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        if self._fused_flat and self._in_flat_group(p):
            self._pending_fused.append((p, g))
            return
        block.append_op(
            "adam",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._global_learning_rate()],
                    "Moment1": [self._get_accumulator("moment1", p)],
                    "Moment2": [self._get_accumulator("moment2", p)],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
                    "Beta2Pow": [self._get_accumulator("beta2_pow_acc", p)]},
            outputs={"ParamOut": [p],
                     "Moment1Out": [self._get_accumulator("moment1", p)],
                     "Moment2Out": [self._get_accumulator("moment2", p)],
                     "Beta1PowOut": [self._get_accumulator("beta1_pow_acc", p)],
                     "Beta2PowOut": [self._get_accumulator("beta2_pow_acc", p)]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, parameters_and_grads):
        if not self._pending_fused:
            return
        pending, self._pending_fused = self._pending_fused, []
        ps = [p for p, _ in pending]
        gs = [g for _, g in pending]
        m1 = [self._get_accumulator("moment1", p) for p in ps]
        m2 = [self._get_accumulator("moment2", p) for p in ps]
        b1p = self._get_accumulator("beta1_pow_acc", ps[0])
        b2p = self._get_accumulator("beta2_pow_acc", ps[0])
        block.append_op(
            "fused_adam",
            inputs={"Param": ps, "Grad": gs,
                    "LearningRate": [self._global_learning_rate()],
                    "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": ps, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
