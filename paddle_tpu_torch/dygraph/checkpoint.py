"""Dygraph state-dict persistence (the port of
``paddle_tpu/dygraph/checkpoint.py``; ref ``python/paddle/fluid/dygraph/
checkpoint.py`` save_dygraph / load_dygraph): a pickled dict of numpy
arrays, ``.pdparams`` for a layer's state and ``.pdopt`` for an
optimizer's, the reference's format, so a file written by either package
loads in the other."""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .tracer import VarBase, _to_numpy

_PARAMS_SUFFIX = ".pdparams"
_OPT_SUFFIX = ".pdopt"


def save_dygraph(state_dict: Dict, model_path: str):
    """Save a Layer.state_dict() (or optimizer state dict) to
    ``model_path + '.pdparams'`` (ref checkpoint.py save_dygraph)."""
    is_opt = any(not isinstance(v, (VarBase, np.ndarray)) and
                 not hasattr(v, "shape") for v in state_dict.values())
    suffix = _OPT_SUFFIX if is_opt else _PARAMS_SUFFIX
    d = os.path.dirname(model_path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = {}
    for k, v in state_dict.items():
        if isinstance(v, VarBase):
            v = v.value
        payload[k] = (_to_numpy(v) if isinstance(v, torch.Tensor)
                      else np.asarray(v) if hasattr(v, "shape") else v)
    with open(model_path + suffix, "wb") as f:
        pickle.dump(payload, f, protocol=2)


def load_dygraph(model_path: str) -> Tuple[Optional[Dict], Optional[Dict]]:
    """Load (param_state, opt_state); either may be None
    (ref checkpoint.py load_dygraph)."""
    params, opt = None, None
    if os.path.exists(model_path + _PARAMS_SUFFIX):
        with open(model_path + _PARAMS_SUFFIX, "rb") as f:
            params = pickle.load(f)
    if os.path.exists(model_path + _OPT_SUFFIX):
        with open(model_path + _OPT_SUFFIX, "rb") as f:
            opt = pickle.load(f)
    if params is None and opt is None:
        raise ValueError(f"no checkpoint found at "
                         f"{model_path}(.pdparams/.pdopt)")
    return params, opt
