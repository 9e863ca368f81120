"""LayerHelper: the glue every layer uses to create params and append ops.

The port's copy of ``paddle_tpu/layer_helper.py`` (ref
``python/paddle/fluid/layer_helper.py``) — create_parameter appends the
initializer op to the startup program and declares the Parameter in the main
program; append_op/create_variable_for_type_inference mirror the reference
API so layer code reads the same.
"""

from __future__ import annotations

from typing import Optional

from .framework import unique_name
from .framework.core import (Variable, default_main_program,
                             default_startup_program)
from .initializer import (_global_bias_initializer,
                          _global_weight_initializer)
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.main_program.current_block().append_op(
            type, inputs=inputs, outputs=outputs, attrs=attrs)

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(self.name + ".tmp"),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_global_variable(self, shape, dtype, name=None,
                               persistable=True, stop_gradient=True):
        return self.main_program.global_block().create_var(
            name=name or unique_name.generate(self.name + ".global"),
            shape=shape, dtype=dtype, persistable=persistable,
            stop_gradient=stop_gradient)

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None) -> Optional[Variable]:
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        suffix = "b" if is_bias else "w"
        name = attr.name or unique_name.generate(f"{self.name}.{suffix}")
        init = attr.initializer or default_initializer or (
            _global_bias_initializer() if is_bias else _global_weight_initializer())
        param = self.main_program.current_block().create_parameter(
            name=name, shape=shape, dtype=dtype,
            initializer=init, trainable=attr.trainable,
            regularizer=attr.regularizer, need_clip=attr.need_clip)
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        # also declare in startup program + its init op
        init(param, self.startup_program.global_block())
        return param

    def append_bias_op(self, input_var, dim_start=1, num_flatten_dims=None):
        bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = input_var.shape[dim_start:]
        b = self.create_parameter(bias_attr, shape=list(size),
                                  dtype=input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op("elementwise_add", inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [out]}, attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=act)
        return out
