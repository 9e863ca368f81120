"""Optimizers: append_backward + per-param optimize ops.

The static-graph half of ``paddle_tpu/optimizer.py`` (ref
``python/paddle/fluid/optimizer.py:50``): the base ``Optimizer`` creates a
learning-rate var and accumulators (persistables the startup program fills),
appends one optimize op per parameter, and ``minimize`` = append_backward →
(clip, regularize) → apply_gradients.  The ops, names and attrs are the
reference's, so both packages build the same training program.  Ported:
SGD (ref :631), Momentum (:701), LarsMomentum (:1068), Adagrad (:1168),
Adam (:1271, ``fused_flat`` included), AdamW, Adamax (:1452),
DecayedAdagrad (:1606), Adadelta (:1698), RMSProp (:1796), Ftrl (:1969),
Lamb (:2113), DGCMomentum (:809, one process), and the wrappers
ExponentialMovingAverage (:2457), ModelAverage (:2267),
RecomputeOptimizer and LookaheadOptimizer (:2980).

Dygraph (ref :135-198): inside ``dygraph.guard()``, ``minimize`` applies
the update at once on ``VarBase`` parameters (the constructor's
``parameter_list``, or ``minimize``'s) through the eager block
(``dygraph.eager_apply``): the same ``_append_optimize_op`` s, each op run
through its lowering, accumulators held as ``VarBase`` s under the
reference's names, clipping and regularization applied to the gradients
first; Adam's ``fused_flat`` stays off there.  The gradients are the
tape's (``loss.backward()``, run by ``minimize`` when no parameter has
one yet).  The pipeline engine (``parallel.pipeline``) applies each
stage's optimizer this way.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

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
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
        self._parameter_list = parameter_list   # dygraph: VarBase s
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
        from .dygraph import base as _dy_base
        if _dy_base.in_dygraph_mode():
            from .dygraph.tracer import VarBase
            shp = list(shape if shape is not None else param.shape)
            acc = VarBase(torch.full(shp, float(fill_value),
                                     dtype=getattr(torch, dtype or
                                                   param.dtype),
                                     device=param.device),
                          name=f"{param.name}_{name}", persistable=True,
                          trainable=False)
            acc.stop_gradient = True
            self._accumulators.setdefault(name, {})[param.name] = acc
            return acc
        block = default_main_program().global_block()
        shape = list(shape if shape is not None else param.shape)
        var = block.create_var(
            name=unique_name.generate(f"{param.name}_{name}"),
            shape=shape, dtype=dtype or param.dtype, persistable=True,
            stop_gradient=True)
        # accumulators shard like their parameter, resolved when a
        # partitioned program is lowered (ref optimizer.py:84-87), so a
        # layout applied after minimize() still reaches them
        var.shard_like = param.name
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
        from .dygraph import base as _dy_base
        if _dy_base.in_dygraph_mode():
            return self._dygraph_minimize(loss, parameter_list)
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    # -- dygraph (eager) apply (ref :135-198) --------------------------------
    def _dygraph_lr_value(self) -> float:
        lr = self._learning_rate
        if callable(lr) and not isinstance(lr, (int, float)):
            lr = lr()                   # a dygraph learning-rate decay
        if hasattr(lr, "numpy"):
            lr = float(np.asarray(lr.numpy()).reshape(-1)[0])
        return float(lr)

    def _dygraph_minimize(self, loss, parameter_list=None):
        """One eager update of ``parameter_list`` (the constructor's when
        None): ``loss.backward()`` first when neither the loss nor any
        parameter has a gradient yet, then clip, regularize (a parameter's
        own regularizer before the optimizer's, as
        ``append_regularization_ops``), and each ``_append_optimize_op``
        on an ``EagerBlock``."""
        from .dygraph.eager_apply import EagerBlock, eager_clip_grads
        from .regularizer import L2DecayRegularizer
        params = parameter_list if parameter_list is not None \
            else self._parameter_list
        if params is None:
            raise ValueError(
                "dygraph minimize needs parameter_list (pass it to minimize "
                "or the optimizer constructor)")
        if loss is not None and getattr(loss, "grad", None) is None and \
                all(p.grad is None for p in params):
            loss.backward()
        params_grads = [(p, p.grad) for p in params
                        if p.grad is not None and p.trainable]
        params_grads = eager_clip_grads(params_grads, self._grad_clip)
        new_pg = []
        for p, g in params_grads:
            reg = getattr(p, "regularizer", None) or self.regularization
            coeff = getattr(reg, "_coeff", 0.0) if reg is not None else 0.0
            if coeff:
                if isinstance(reg, L2DecayRegularizer):
                    g = g + coeff * p.value
                else:
                    g = g + coeff * torch.sign(p.value)
            new_pg.append((p, g))
        block = EagerBlock(self._dygraph_lr_value())
        self._create_accumulators(block, [p for p, _ in new_pg])
        for pg in new_pg:
            self._append_optimize_op(block, pg)
        self._finish_update(block, new_pg)
        return [], new_pg


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


class LarsMomentumOptimizer(Optimizer):
    """ref optimizer.py:1068 (``paddle_tpu/optimizer.py:235``)."""

    def __init__(self, learning_rate, momentum, lars_coeff=1e-3,
                 lars_weight_decay=5e-4, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        block.append_op("lars_momentum",
                        inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                                "LearningRate": [self._global_learning_rate()]},
                        outputs={"ParamOut": [p], "VelocityOut": [v]},
                        attrs={"mu": self._momentum,
                               "lars_coeff": self._lars_coeff,
                               "lars_weight_decay": self._lars_weight_decay})


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

    def _use_fused(self) -> bool:
        """``fused_flat``, off in dygraph mode (ref :284)."""
        from .dygraph import base as _dy_base
        return self._fused_flat and not _dy_base.in_dygraph_mode()

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
            if self._use_fused() and self._in_flat_group(p) and \
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

    def _adam_io(self, p, g):
        """The (inputs, outputs) slots of an ``adam``-shaped op (adam,
        adamw, lamb) for one parameter."""
        acc = {slot: [self._get_accumulator(name, p)] for slot, name in
               (("Moment1", "moment1"), ("Moment2", "moment2"),
                ("Beta1Pow", "beta1_pow_acc"),
                ("Beta2Pow", "beta2_pow_acc"))}
        inputs = dict({"Param": [p], "Grad": [g],
                       "LearningRate": [self._global_learning_rate()]},
                      **acc)
        outputs = dict({"ParamOut": [p]},
                       **{slot + "Out": v for slot, v in acc.items()})
        return inputs, outputs

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        if self._use_fused() and self._in_flat_group(p):
            self._pending_fused.append((p, g))
            return
        block.append_op("adam", *self._adam_io(p, g),
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


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay (``paddle_tpu/optimizer.py:358``;
    ``weight_decay`` is the op's ``coeff``)."""

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._coeff = weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        block.append_op("adamw", *self._adam_io(*param_and_grad),
                        attrs={"beta1": self._beta1, "beta2": self._beta2,
                               "epsilon": self._epsilon,
                               "coeff": self._coeff})


class AdamaxOptimizer(Optimizer):
    """ref optimizer.py:1452 (``paddle_tpu/optimizer.py:384``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        block.append_op(
            "adamax",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._global_learning_rate()],
                    "Moment": [self._get_accumulator("moment", p)],
                    "InfNorm": [self._get_accumulator("inf_norm", p)],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)]},
            outputs={"ParamOut": [p],
                     "MomentOut": [self._get_accumulator("moment", p)],
                     "InfNormOut": [self._get_accumulator("inf_norm", p)]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, parameters_and_grads):
        for p, _ in parameters_and_grads:
            b1 = self._get_accumulator("beta1_pow_acc", p)
            block.append_op("scale", inputs={"X": [b1]},
                            outputs={"Out": [b1]},
                            attrs={"scale": self._beta1})


class _MomentOptimizer(Optimizer):
    """An update with one ``moment`` accumulator: Adagrad and
    DecayedAdagrad."""

    _op_type = ""

    def _attrs(self):
        raise NotImplementedError

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._init_acc)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        block.append_op(self._op_type,
                        inputs={"Param": [p], "Grad": [g], "Moment": [m],
                                "LearningRate": [self._global_learning_rate()]},
                        outputs={"ParamOut": [p], "MomentOut": [m]},
                        attrs=self._attrs())


class AdagradOptimizer(_MomentOptimizer):
    """ref optimizer.py:1168 (``paddle_tpu/optimizer.py:422``)."""

    _op_type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _attrs(self):
        return {"epsilon": self._epsilon}


class DecayedAdagradOptimizer(_MomentOptimizer):
    """ref optimizer.py:1606 (``paddle_tpu/optimizer.py:445``)."""

    _op_type = "decayed_adagrad"
    _init_acc = 0.0

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _attrs(self):
        return {"decay": self._decay, "epsilon": self._epsilon}


class AdadeltaOptimizer(Optimizer):
    """ref optimizer.py:1698 (``paddle_tpu/optimizer.py:466``)."""

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("_avg_squared_grad", p)
            self._add_accumulator("_avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("_avg_squared_grad", p)
        up = self._get_accumulator("_avg_squared_update", p)
        block.append_op("adadelta",
                        inputs={"Param": [p], "Grad": [g],
                                "AvgSquaredGrad": [sq],
                                "AvgSquaredUpdate": [up]},
                        outputs={"ParamOut": [p], "AvgSquaredGradOut": [sq],
                                 "AvgSquaredUpdateOut": [up]},
                        attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    """ref optimizer.py:1796 (``paddle_tpu/optimizer.py:491``)."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        block.append_op(
            "rmsprop",
            inputs={"Param": [p], "Grad": [g], "Moment": [mom],
                    "MeanSquare": [ms], "MeanGrad": [mg],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p], "MomentOut": [mom],
                     "MeanSquareOut": [ms], "MeanGradOut": [mg]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    """ref optimizer.py:1969 (``paddle_tpu/optimizer.py:523``)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        block.append_op(
            "ftrl",
            inputs={"Param": [p], "Grad": [g], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class LambOptimizer(AdamOptimizer):
    """ref optimizer.py:2113 (``paddle_tpu/optimizer.py:549``): the
    layer-adaptive large-batch optimizer.  ``exclude_from_weight_decay_fn
    (param)`` true zeroes a parameter's decay (LayerNorm scales and biases
    in the BERT recipe)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kw)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, param_and_grad):
        p, _ = param_and_grad
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        block.append_op("lamb", *self._adam_io(*param_and_grad),
                        attrs={"beta1": self._beta1, "beta2": self._beta2,
                               "epsilon": self._epsilon,
                               "weight_decay": wd})


class DGCMomentumOptimizer(MomentumOptimizer):
    """ref optimizer.py:809 (``paddle_tpu/optimizer.py:582``): deep
    gradient compression.  Untranspiled it is Momentum, its ops tagged with
    the compression settings; ``parallel.DGCGradAllReduce`` rewrites the
    tagged ops into ``dgc_allreduce`` + ``dgc_momentum`` for the executor's
    collective mode."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,),
                 local_grad_clip_norm=None, **kw):
        super().__init__(learning_rate, momentum, **kw)
        self._rampup_begin_step = rampup_begin_step
        self._sparsity = sparsity
        self._local_grad_clip_norm = local_grad_clip_norm

    def _append_optimize_op(self, block, param_and_grad):
        super()._append_optimize_op(block, param_and_grad)
        op = block.ops[-1]
        op.attrs["dgc"] = True
        op.attrs["rampup_begin_step"] = self._rampup_begin_step
        op.attrs["sparsity"] = float(self._sparsity[-1]) \
            if isinstance(self._sparsity, (list, tuple)) else \
            float(self._sparsity)
        if self._local_grad_clip_norm is not None:
            op.attrs["local_grad_clip_norm"] = \
                float(self._local_grad_clip_norm)


@contextlib.contextmanager
def _swapped(values: Dict[str, torch.Tensor], need_restore: bool):
    """Put ``values`` in the global scope under their names; on exit put
    the old values back when ``need_restore``."""
    from .framework.scope import global_scope
    scope = global_scope()
    backups = {n: scope.find_var(n) for n in values}
    scope.set_vars(values)
    try:
        yield
    finally:
        if need_restore:
            scope.set_vars(backups)


class ExponentialMovingAverage:
    """ref optimizer.py:2457 (``paddle_tpu/optimizer.py:611``): a shadow
    ``<name><param>.ema`` per trainable parameter, moved by ``update()``'s
    ops every step; ``apply()`` is a guard that swaps the shadows into the
    scope and swaps the parameters back on exit."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or ""
        self._shadows: Dict[str, Variable] = {}

    def update(self):
        block = default_main_program().global_block()
        sb = default_startup_program().global_block()
        for p in block.all_parameters():
            if not p.trainable:
                continue
            sname = f"{self._name}{p.name}.ema"
            shadow = block.create_var(name=sname, shape=p.shape,
                                      dtype=p.dtype, persistable=True,
                                      stop_gradient=True)
            sb.create_var(name=sname, shape=list(p.shape), dtype=p.dtype,
                          persistable=True)
            sb.append_op("fill_constant", outputs={"Out": [sname]},
                         attrs={"shape": list(p.shape), "dtype": p.dtype,
                                "value": 0.0})
            self._shadows[p.name] = shadow
            # shadow = decay*shadow + (1-decay)*param
            tmp = block.create_var(
                name=unique_name.generate(sname + ".tmp"), shape=p.shape,
                dtype=p.dtype, stop_gradient=True)
            block.append_op("scale", inputs={"X": [shadow]},
                            outputs={"Out": [tmp]},
                            attrs={"scale": self._decay})
            tmp2 = block.create_var(
                name=unique_name.generate(sname + ".tmp2"), shape=p.shape,
                dtype=p.dtype, stop_gradient=True)
            block.append_op("scale", inputs={"X": [p]},
                            outputs={"Out": [tmp2]},
                            attrs={"scale": 1.0 - self._decay})
            block.append_op("elementwise_add",
                            inputs={"X": [tmp], "Y": [tmp2]},
                            outputs={"Out": [shadow]})

    def apply(self, executor=None, need_restore=True):
        from .framework.scope import global_scope
        scope = global_scope()
        return _swapped({pname: scope.find_var(shadow.name)
                         for pname, shadow in self._shadows.items()
                         if scope.find_var(shadow.name) is not None},
                        need_restore)

    def restore(self, executor=None):
        pass


class ModelAverage(Optimizer):
    """ref optimizer.py:2267 (``paddle_tpu/optimizer.py:678``): running
    sums of every trainable parameter over a window
    (``average_accumulates``).  ``apply()`` is a guard that puts the
    averages, (sum_1 + sum_2 + sum_3) / (num_accumulates +
    old_num_accumulates), in the scope, computed on the scope's device
    (a parameter with no accumulated step keeps its value), and puts the
    parameters back on exit."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(0.0, **kw)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads: List[Tuple[Variable, Variable]] = []
        block = default_main_program().global_block()
        for p in block.all_parameters():
            if p.trainable:
                self._append_average_accumulate_op(p)

    def _append_average_accumulate_op(self, param):
        block = default_main_program().global_block()
        sum1 = self._add_accumulator("sum_1", param)
        sum2 = self._add_accumulator("sum_2", param)
        sum3 = self._add_accumulator("sum_3", param)
        num_acc = self._add_accumulator("num_accumulates", param,
                                        dtype="int64", shape=[1])
        old_num = self._add_accumulator("old_num_accumulates", param,
                                        dtype="int64", shape=[1])
        num_upd = self._add_accumulator("num_updates", param,
                                        dtype="int64", shape=[1])
        block.append_op(
            "average_accumulates",
            inputs={"param": [param], "in_sum_1": [sum1], "in_sum_2": [sum2],
                    "in_sum_3": [sum3], "in_num_accumulates": [num_acc],
                    "in_old_num_accumulates": [old_num],
                    "in_num_updates": [num_upd]},
            outputs={"out_sum_1": [sum1], "out_sum_2": [sum2],
                     "out_sum_3": [sum3], "out_num_accumulates": [num_acc],
                     "out_old_num_accumulates": [old_num],
                     "out_num_updates": [num_upd]},
            attrs={"average_window": self.average_window,
                   "min_average_window": self.min_average_window,
                   "max_average_window": self.max_average_window})

    def apply(self, executor=None, need_restore=True):
        from .framework.scope import global_scope
        scope = global_scope()

        def val(acc, pname):
            return scope.find_var(self._accumulators[acc][pname].name)

        averages = {}
        for pname in self._accumulators.get("sum_1", {}):
            s1, param = val("sum_1", pname), scope.find_var(pname)
            if s1 is None or param is None:
                continue
            total = s1 + val("sum_2", pname) + val("sum_3", pname)
            cnt = (val("num_accumulates", pname) +
                   val("old_num_accumulates", pname)).to(total.dtype)
            averages[pname] = torch.where(cnt > 0,
                                          total / cnt.clamp(min=1), param)
        return _swapped(averages, need_restore)

    def restore(self, executor=None):
        pass


class RecomputeOptimizer:
    """Activation rematerialization around an optimizer
    (``paddle_tpu/optimizer.py:776-816``; see ``framework/recompute.py``)::

        opt = optimizer.RecomputeOptimizer(Adam(1e-4))
        opt._set_checkpoints([layer_out_1, layer_out_2, ...])
        opt.minimize(loss)

    ``backward`` → ``apply_gradients`` rewrites as well, and
    ``amp.decorate(RecomputeOptimizer(...))`` composes."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = []

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = [
            c.name if hasattr(c, "name") else c for c in checkpoints]

    def __getattr__(self, name):
        return getattr(self._optimizer, name)

    def _apply(self, program):
        # idempotent: minimize() delegates to the inner optimizer whose
        # backward() may already have routed through this wrapper
        from .framework.recompute import apply_recompute, is_recomputed
        if self._checkpoints and not is_recomputed(program):
            apply_recompute(program, self._checkpoints)

    def backward(self, loss, **kw):
        result = self._optimizer.backward(loss, **kw)
        self._apply(loss.block.program)
        return result

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        result = self._optimizer.minimize(loss, startup_program,
                                          parameter_list, no_grad_set,
                                          grad_clip=grad_clip)
        self._apply(loss.block.program)
        return result


class LookaheadOptimizer:
    """Lookahead (arXiv:1907.08610; ref ``optimizer.py:2980``,
    ``paddle_tpu/optimizer.py:821``): the inner optimizer moves the fast
    weights every step; every k-th step the slow weights (``<name>@SLOW``)
    move toward them by ``alpha`` and the fast weights reset to them.  As
    in the reference, the blend runs every step under a 0/1 mask of
    ``lookahead_step % k == 0``, with no branch."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        assert inner_optimizer is not None, "inner optimizer can not be None"
        assert 0.0 <= alpha <= 1.0, "alpha must be in [0, 1]"
        assert isinstance(k, int) and k > 0, "k must be a positive int"
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self.type = "lookahead"

    def __getattr__(self, name):
        return getattr(self.inner_optimizer, name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        result = self.inner_optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set,
            grad_clip=grad_clip)
        main_block = loss.block
        startup = startup_program or default_startup_program()
        params = [p.name for p in main_block.program.all_parameters()]
        with main_block.program._op_role_guard("optimize"):
            self._append_lookahead_ops(main_block, startup, params)
        return result

    def _append_lookahead_ops(self, main_block, startup, params):
        from . import layers
        # slow copies beside the fast params, set to the fast values by
        # the startup program
        for name in params:
            fast = main_block.var(name)
            main_block.create_var(name=name + "@SLOW", shape=fast.shape,
                                  dtype=fast.dtype, persistable=True)
            sb = startup.global_block()
            sv = sb.create_var(name=name + "@SLOW", shape=fast.shape,
                               dtype=fast.dtype, persistable=True)
            if not sb.has_var(name):
                # params restored by loading instead of init ops
                sb.create_var(name=name, shape=fast.shape,
                              dtype=fast.dtype, persistable=True)
            sb.append_op("assign", inputs={"X": [name]},
                         outputs={"Out": [sv.name]}, attrs={})
        # an int32 counter, as the reference's (a float32 one would freeze
        # at 2^24)
        step = layers.create_global_var(name="lookahead_step", shape=[1],
                                        value=0, dtype="int32",
                                        persistable=True)
        layers.increment(step, value=1, in_place=True)
        mod = layers.elementwise_mod(step, layers.fill_constant(
            shape=[1], dtype="int32", value=self.k))
        mask = layers.cast(layers.equal(mod, layers.fill_constant(
            shape=[1], dtype="int32", value=0)), "float32")
        for name in params:
            fast = main_block.var(name)
            slow = main_block.var(name + "@SLOW")
            blend = slow + self.alpha * (fast - slow)
            new_slow = mask * blend + (1.0 - mask) * slow
            new_fast = mask * new_slow + (1.0 - mask) * fast
            layers.assign(new_slow, slow)
            layers.assign(new_fast, fast)


# fluid-style aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
DGCMomentum = DGCMomentumOptimizer


def __getattr__(name):
    # PipelineOptimizer lives in parallel.pipeline (ref :768-772): imported
    # on first use, since the pipeline pulls in the executor machinery
    if name == "PipelineOptimizer":
        from .parallel.pipeline import PipelineOptimizer
        return PipelineOptimizer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
