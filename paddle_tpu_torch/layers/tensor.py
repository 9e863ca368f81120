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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """ref ``paddle_tpu/layers/tensor.py:96``: a constant whose
    ``output_dim_idx`` dim is ``input``'s ``input_dim_idx`` dim."""
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    out.stop_gradient = True
    helper.append_op("fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": convert_dtype(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones_like(x, out=None):
    """ref ``paddle_tpu/layers/tensor.py:145``: the ``fill_any_like`` op."""
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"value": 1.0})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    if isinstance(axis, int):
        axis = [axis]
    helper.append_op("reverse", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": list(axis)})
    return out


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """ref ``paddle_tpu/layers/tensor.py:250``: stack or concat the dense
    array buffer (rows past the written length are zero)."""
    helper = LayerHelper("tensor_array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_index = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("tensor_array_to_tensor",
                     inputs={"Array": [input]},
                     outputs={"Out": [out], "OutIndex": [out_index]},
                     attrs={"axis": axis, "use_stack": use_stack})
    return out, out_index
