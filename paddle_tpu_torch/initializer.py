"""Parameter initializers (the port's ``paddle_tpu/initializer.py``; ref
``python/paddle/fluid/initializer.py``).

Each initializer appends an init op to the *startup* program targeting the
parameter var, exactly as the reference does: Constant → fill_constant,
Uniform → uniform_random, Normal → gaussian_random, TruncatedNormal →
truncated_gaussian_random, Xavier and MSRA → a scaled uniform or normal,
Bilinear and NumpyArray → assign_value.
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


class TruncatedNormalInitializer(Initializer):
    """N(loc, scale²) cut at two standard deviations."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        block = block or default_startup_program().global_block()
        block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                         persistable=True)
        block.append_op("truncated_gaussian_random",
                        outputs={"Out": [var.name]},
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
    """Glorot init (ref initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block=None):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He/Kaiming init (ref initializer.py MSRAInitializer): uniform in
    ±sqrt(6 / fan_in), or normal with std sqrt(2 / fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block=None):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


def _assign_value(var, block, shape, values):
    block = block or default_startup_program().global_block()
    block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                     persistable=True)
    block.append_op("assign_value", outputs={"Out": [var.name]},
                    attrs={"shape": list(shape), "dtype": var.dtype,
                           "values": values})


class BilinearInitializer(Initializer):
    """The bilinear-interpolation kernel of a 4-D conv-transpose weight
    (ref initializer.py Bilinear), as an ``assign_value``."""

    def __call__(self, var, block=None):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("BilinearInitializer expects 4-D weight")
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        idx = np.arange(int(np.prod(shape)))
        x = idx % shape[3]
        y = (idx // shape[3]) % shape[2]
        w = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        _assign_value(var, block, shape,
                      w.astype("float32").reshape(-1).tolist())


class NumpyArrayInitializer(Initializer):
    """A given array's values (ref initializer.py NumpyArrayInitializer),
    as an ``assign_value``."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block=None):
        _assign_value(var, block, self.value.shape,
                      self.value.reshape(-1).tolist())


# aliases matching fluid's public names
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)
