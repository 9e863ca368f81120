"""Gradient clipping, the port's copy of ``paddle_tpu/clip.py`` (ref
``python/paddle/fluid/clip.py``): GradientClipByValue / ByNorm /
ByGlobalNorm append clip ops onto grads before the optimizer ops."""

from __future__ import annotations

from .framework import unique_name


class BaseGradientClipAttr:
    def _append_clip_op(self, block, param, grad):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _append_clip_op(self, block, param, grad):
        out = block.create_var(
            name=unique_name.generate(grad.name + ".clip"),
            shape=grad.shape, dtype=grad.dtype, stop_gradient=True)
        block.append_op("clip", inputs={"X": [grad]}, outputs={"Out": [out]},
                        attrs={"min": self.min, "max": self.max})
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _append_clip_op(self, block, param, grad):
        out = block.create_var(
            name=unique_name.generate(grad.name + ".clip"),
            shape=grad.shape, dtype=grad.dtype, stop_gradient=True)
        block.append_op("clip_by_norm", inputs={"X": [grad]},
                        outputs={"Out": [out]},
                        attrs={"max_norm": self.clip_norm})
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """ref clip.py GradientClipByGlobalNorm — scale all grads by
    clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_all(self, params_grads):
        if not params_grads:
            return params_grads
        block = params_grads[0][1].block
        sq_norms = []
        for p, g in params_grads:
            if g is None or not p.need_clip:
                continue
            sq = block.create_var(
                name=unique_name.generate(g.name + ".sq"),
                shape=(1,), dtype="float32", stop_gradient=True)
            block.append_op("squared_l2_norm", inputs={"X": [g]},
                            outputs={"Out": [sq]})
            sq_norms.append(sq)
        if not sq_norms:
            return params_grads
        total = block.create_var(name=unique_name.generate("gnorm_sq"),
                                 shape=(1,), dtype="float32",
                                 stop_gradient=True)
        block.append_op("sum", inputs={"X": sq_norms},
                        outputs={"Out": [total]})
        gnorm = block.create_var(name=unique_name.generate("gnorm"),
                                 shape=(1,), dtype="float32",
                                 stop_gradient=True)
        block.append_op("sqrt", inputs={"X": [total]},
                        outputs={"Out": [gnorm]})
        # scale = clip / max(gnorm, clip)
        maxed = block.create_var(name=unique_name.generate("gnorm_max"),
                                 shape=(1,), dtype="float32",
                                 stop_gradient=True)
        clipv = block.create_var(name=unique_name.generate("clipnorm"),
                                 shape=(1,), dtype="float32",
                                 stop_gradient=True)
        block.append_op("fill_constant", outputs={"Out": [clipv]},
                        attrs={"shape": [1], "dtype": "float32",
                               "value": self.clip_norm})
        block.append_op("elementwise_max",
                        inputs={"X": [gnorm], "Y": [clipv]},
                        outputs={"Out": [maxed]})
        scale = block.create_var(name=unique_name.generate("clip_scale"),
                                 shape=(1,), dtype="float32",
                                 stop_gradient=True)
        block.append_op("elementwise_div",
                        inputs={"X": [clipv], "Y": [maxed]},
                        outputs={"Out": [scale]})
        out = []
        for p, g in params_grads:
            if g is None or not p.need_clip:
                out.append((p, g))
                continue
            ng = block.create_var(
                name=unique_name.generate(g.name + ".clip"),
                shape=g.shape, dtype=g.dtype, stop_gradient=True)
            block.append_op("elementwise_mul",
                            inputs={"X": [g], "Y": [scale]},
                            outputs={"Out": [ng]})
            out.append((p, ng))
        return out


def append_gradient_clip_ops(params_grads, clip_attr=None):
    if clip_attr is None:
        return params_grads
    if isinstance(clip_attr, GradientClipByGlobalNorm):
        return clip_attr._clip_all(params_grads)
    out = []
    for p, g in params_grads:
        if g is None or not p.need_clip:
            out.append((p, g))
            continue
        out.append((p, clip_attr._append_clip_op(g.block, p, g)))
    return out


def set_gradient_clip(clip, param_list=None, program=None):
    """ref clip.py set_gradient_clip — stores clip on params."""
    from .framework.core import default_main_program
    program = program or default_main_program()
    if param_list is None:
        param_list = program.all_parameters()
    for p in param_list:
        p.gradient_clip_attr = clip


def error_clip_callback(block, context):
    pass


ErrorClipByValue = GradientClipByValue
