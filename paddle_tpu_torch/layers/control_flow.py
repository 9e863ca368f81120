"""Control-flow layers (the subset of ``paddle_tpu/layers/control_flow.py``
the port runs so far: the comparison and counter layers Lookahead uses; ref
``python/paddle/fluid/layers/control_flow.py``)."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def equal(x, y, cond=None):
    """Elementwise ``x == y`` as a bool var (ref ``compare_op.cc``)."""
    helper = LayerHelper("equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", True)
    helper.append_op("equal", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def increment(x, value=1.0, in_place=True):
    """``x + value`` (ref ``increment_op.cc``), written back to ``x`` when
    ``in_place``."""
    helper = LayerHelper("increment")
    out = x if in_place else \
        helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"step": float(value)})
    return out
