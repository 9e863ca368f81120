"""Weight-decay regularizers appended as grad-side ops, the port's copy of
``paddle_tpu/regularizer.py`` (ref ``python/paddle/fluid/regularizer.py``:
L1/L2 append ops onto the grad before the optimize op)."""

from __future__ import annotations


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from .framework import unique_name
        decay = block.create_var(
            name=unique_name.generate(param.name + ".l2decay"),
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        new_grad = block.create_var(
            name=unique_name.generate(grad.name + ".reg"),
            shape=grad.shape, dtype=grad.dtype, stop_gradient=True)
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [new_grad]})
        return new_grad


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from .framework import unique_name
        sign = block.create_var(
            name=unique_name.generate(param.name + ".sign"),
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        decay = block.create_var(
            name=unique_name.generate(param.name + ".l1decay"),
            shape=param.shape, dtype=param.dtype, stop_gradient=True)
        block.append_op("scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        new_grad = block.create_var(
            name=unique_name.generate(grad.name + ".reg"),
            shape=grad.shape, dtype=grad.dtype, stop_gradient=True)
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [new_grad]})
        return new_grad


def append_regularization_ops(params_grads, regularization=None):
    """ref regularizer.py append_regularization_ops — per-param override wins."""
    out = []
    for param, grad in params_grads:
        reg = param.regularizer or regularization
        if grad is None or reg is None:
            out.append((param, grad))
            continue
        block = grad.block
        out.append((param, reg(param, grad, block)))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
