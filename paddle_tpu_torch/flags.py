"""Runtime flags (the port's counterpart of ``paddle_tpu/flags.py``; ref
``platform/flags.cc`` and ``core.globals()``).

Only the three graph-fusion flags exist so far, with the reference's names
and defaults.  ``FLAGS_*`` environment variables seed them at import, as the
reference's ``__bootstrap__`` does; a malformed value warns and is ignored.
"""

from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["get_flags", "set_flags"]

_DEFAULTS: Dict[str, Any] = {
    # the training-safe fusion pass the executor runs on a plain Program
    # before it builds a plan (conv1x1 + batch_norm [+ relu] ->
    # fused_conv1x1_bn); applies on static legality and cost rank
    "FLAGS_graph_fusion": True,
    # micro-benchmark each candidate before rewriting it (not ported: the
    # pass refuses to run with it on)
    "FLAGS_fusion_autotune": False,
    # a candidate whose op class is below this share of the program's
    # analytic flop and byte budget is not worth a rewrite
    "FLAGS_fusion_rank_threshold": 0.02,
}

_values: Dict[str, Any] = dict(_DEFAULTS)


def _coerce(name: str, raw):
    default = _DEFAULTS[name]
    if isinstance(default, bool):
        if isinstance(raw, str):
            return raw.lower() in ("1", "true", "yes", "on")
        return bool(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def set_flags(flags: Dict[str, Any]) -> None:
    """ref ``paddle.set_flags``.  Every name and value is checked before
    any is applied."""
    coerced = {}
    for name, value in flags.items():
        if name not in _DEFAULTS:
            raise ValueError(f"unknown flag {name!r}")
        coerced[name] = _coerce(name, value)
    _values.update(coerced)


def get_flags(flags) -> Dict[str, Any]:
    """ref ``paddle.get_flags``: a name or a list of names -> dict."""
    names = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    for name in names:
        if name not in _values:
            raise ValueError(f"unknown flag {name!r}")
        out[name] = _values[name]
    return out


def _bootstrap_from_env() -> None:
    import warnings
    for name in _DEFAULTS:
        raw = os.environ.get(name)
        if raw is None:
            continue
        try:
            set_flags({name: raw})
        except (ValueError, TypeError) as e:
            warnings.warn(f"ignoring malformed env var {name}={raw!r}: {e}")


_bootstrap_from_env()
