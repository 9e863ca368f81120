"""Tensor-creation layers (the subset of ``paddle_tpu/layers/tensor.py`` the
port runs so far; ref ``python/paddle/fluid/layers/tensor.py``)."""

from __future__ import annotations

import numpy as np

from ..framework.core import Variable, convert_dtype
from ..layer_helper import LayerHelper


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter")
    from ..param_attr import ParamAttr
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def concat(input, axis=0, name=None):
    """ref ``paddle_tpu/layers/tensor.py:51``: the ``concat`` op."""
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A var of the global block that the startup program fills with
    ``value`` (ref ``layers/tensor.py`` create_global_var)."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(shape=list(shape), dtype=dtype,
                                        name=name, persistable=persistable)
    from ..framework.core import default_startup_program
    sb = default_startup_program().global_block()
    sb.create_var(name=var.name, shape=list(shape), dtype=dtype,
                  persistable=persistable)
    sb.append_op("fill_constant", outputs={"Out": [var.name]},
                 attrs={"shape": list(shape), "dtype": dtype,
                        "value": float(value)})
    return var


def assign(input, output=None):
    """ref ``paddle_tpu/layers/tensor.py:67``: a Variable is copied by the
    ``assign`` op; a numpy array (or anything ``np.asarray`` takes) becomes
    an ``assign_value`` op holding its values."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(str(arr.dtype))
        helper.append_op("assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(arr.shape),
                                "dtype": str(arr.dtype),
                                "values": arr.reshape(-1).tolist()})
    return output


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    out.stop_gradient = True
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
                            "value": float(value)})
    return out


def range(start, end, step, dtype):
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(convert_dtype(dtype), True)
    attrs = {"dtype": convert_dtype(dtype)}
    inputs = {}
    for nm, v in (("Start", start), ("End", end), ("Step", step)):
        if isinstance(v, Variable):
            inputs[nm] = [v]
        else:
            attrs[nm.lower()] = v
    helper.append_op("range", inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out
