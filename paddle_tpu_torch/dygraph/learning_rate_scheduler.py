"""The dygraph learning-rate decays (the port of
``paddle_tpu/dygraph/learning_rate_scheduler.py``; ref
``python/paddle/fluid/dygraph/learning_rate_scheduler.py``): stateful decay
objects the optimizer calls once a step (``Optimizer._dygraph_lr_value``)."""

from __future__ import annotations

import math

__all__ = ["LearningRateDecay", "PiecewiseDecay", "NaturalExpDecay",
           "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
           "CosineDecay", "NoamDecay"]


class LearningRateDecay:
    def __init__(self, begin=0, step=1):
        self.step_num = begin
        self.step_size = step

    def __call__(self):
        lr = self.step()
        self.step_num += self.step_size
        return lr

    def step(self) -> float:
        raise NotImplementedError


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1):
        super().__init__(begin, step)
        self.boundaries = list(boundaries)
        self.values = list(values)

    def step(self):
        for i, b in enumerate(self.boundaries):
            if self.step_num < b:
                return float(self.values[i])
        return float(self.values[len(self.boundaries)])


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.ds, self.dr, self.staircase = \
            learning_rate, decay_steps, decay_rate, staircase

    def step(self):
        div = self.step_num / self.ds
        if self.staircase:
            div = math.floor(div)
        return self.lr * math.exp(-self.dr * div)


class ExponentialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.ds, self.dr, self.staircase = \
            learning_rate, decay_steps, decay_rate, staircase

    def step(self):
        div = self.step_num / self.ds
        if self.staircase:
            div = math.floor(div)
        return self.lr * (self.dr ** div)


class InverseTimeDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.ds, self.dr, self.staircase = \
            learning_rate, decay_steps, decay_rate, staircase

    def step(self):
        div = self.step_num / self.ds
        if self.staircase:
            div = math.floor(div)
        return self.lr / (1 + self.dr * div)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.ds, self.end_lr, self.power, self.cycle = \
            learning_rate, decay_steps, end_learning_rate, power, cycle

    def step(self):
        n = self.step_num
        ds = self.ds
        if self.cycle:
            div = math.ceil(n / ds) or 1
            ds = ds * div
        else:
            n = min(n, ds)
        return ((self.lr - self.end_lr) * (1 - n / ds) ** self.power
                + self.end_lr)


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs,
                 begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.spe, self.epochs = learning_rate, step_each_epoch, epochs

    def step(self):
        epoch = math.floor(self.step_num / self.spe)
        return self.lr * 0.5 * (math.cos(epoch * math.pi / self.epochs) + 1)


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1):
        super().__init__(begin, step)
        self.d_model, self.warmup = d_model, warmup_steps

    def step(self):
        n = max(self.step_num, 1)
        return (self.d_model ** -0.5) * min(n ** -0.5,
                                            n * self.warmup ** -1.5)
