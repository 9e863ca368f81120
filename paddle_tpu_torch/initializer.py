"""Parameter initializers (the subset of ``paddle_tpu/initializer.py`` that
fc, embedding, conv2d, layer_norm, batch_norm and create_parameter use; ref
``python/paddle/fluid/initializer.py``).

Each initializer appends an init op to the *startup* program targeting the
parameter var, exactly as the reference does: Constant → fill_constant,
Uniform → uniform_random, Normal → gaussian_random, Xavier → a scaled
uniform.
"""

from __future__ import annotations

import math

import numpy as np

from .framework.core import Variable, default_startup_program


class Initializer:
    def __call__(self, var: Variable, block=None):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block=None):
        block = block or default_startup_program().global_block()
        block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                         persistable=True)
        block.append_op("fill_constant", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block=None):
        block = block or default_startup_program().global_block()
        block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                         persistable=True)
        block.append_op("uniform_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "min": self.low, "max": self.high,
                               "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        block = block or default_startup_program().global_block()
        block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                         persistable=True)
        block.append_op("gaussian_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": self.loc, "std": self.scale,
                               "seed": self.seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return shape[0] if shape else 1, shape[0] if shape else 1
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


class XavierInitializer(Initializer):
    """Glorot init (ref initializer.py XavierInitializer); the normal form
    waits for ``gaussian_random``."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        if not uniform:
            raise NotImplementedError("XavierInitializer(uniform=False) "
                                      "needs gaussian_random, not ported")
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def __call__(self, var, block=None):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = math.sqrt(6.0 / (fi + fo))
        UniformInitializer(-limit, limit, self.seed)(var, block)


# aliases matching fluid's public names
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)
