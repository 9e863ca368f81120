"""Runtime flags (the port's counterpart of ``paddle_tpu/flags.py``; ref
``platform/flags.cc`` and ``core.globals()``).

The graph-fusion flags, the program verifier's gate, the directory of the
fusion autotuner's verdicts, the decode server's paged-KV and retry flags
and the fault-injection table exist so far, with the reference's names and
defaults.  ``FLAGS_*`` environment variables seed them at import, as the
reference's ``__bootstrap__`` does; a malformed value warns and is ignored.
"""

from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["get_flags", "set_flags", "warn_noop"]

_DEFAULTS: Dict[str, Any] = {
    # the training-safe fusion pass the executor and CompiledProgram run
    # before a plan is built (conv1x1 + batch_norm, dense + bias +
    # activation, embedding + adds + layer_norm); applies on static
    # legality and cost rank
    "FLAGS_graph_fusion": True,
    # micro-benchmark each candidate (its chain against the fused op with
    # the hand-written kernel) on the executor's device and apply the
    # rewrite with the kernel only where the kernel wins
    "FLAGS_fusion_autotune": False,
    # a candidate whose op class is below this share of the program's
    # analytic flop and byte budget is not worth a rewrite
    "FLAGS_fusion_rank_threshold": 0.02,
    # the program verifier (analysis/verifier.py) runs in
    # CompiledProgram._optimized before any pass; error findings raise
    "FLAGS_program_verify": True,
    # the reference's name, kept because users' scripts set it: in the port
    # it only names the directory of the autotuner's fusion_autotune.json
    "FLAGS_xla_compile_cache_dir": "",
    # transient-fault absorption: how many times the decode loop re-runs a
    # step whose dispatch raised a transient error (injected faults, errors
    # tagged by resilience.mark_transient) before failing its requests
    "FLAGS_serving_max_retries": 1,
    # paged KV cache of the decode engine: the page length in tokens, and
    # the page-pool size (0 = 1 + slots x pages a slot's window needs)
    "FLAGS_serving_kv_page_len": 16,
    "FLAGS_serving_kv_pages": 0,
    # deterministic fault injection, "site:spec[;site:spec...]"
    # (resilience.parse_fault_inject); setting it reloads the table
    "FLAGS_fault_inject": "",
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
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, str):
        return str(raw)
    return raw


def set_flags(flags: Dict[str, Any]) -> None:
    """ref ``paddle.set_flags``.  Every name and value is checked before
    any is applied; ``FLAGS_fault_inject`` is parsed then, so a malformed
    spec is refused up front, and applying it reloads the injection
    table."""
    from . import resilience
    coerced = {}
    for name, value in flags.items():
        if name not in _DEFAULTS:
            raise ValueError(f"unknown flag {name!r}")
        coerced[name] = _coerce(name, value)
        if name == "FLAGS_fault_inject":
            resilience.parse_fault_inject(coerced[name])
    _values.update(coerced)
    if "FLAGS_fault_inject" in coerced:
        resilience.configure(coerced["FLAGS_fault_inject"])


def get_flags(flags) -> Dict[str, Any]:
    """ref ``paddle.get_flags``: a name or a list of names -> dict."""
    names = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    for name in names:
        if name not in _values:
            raise ValueError(f"unknown flag {name!r}")
        out[name] = _values[name]
    return out


_warned_noop_knobs = set()


def warn_noop(knob: str, why: str = "") -> None:
    """Log once that a reference-parity knob has no effect in the port
    (``paddle_tpu/flags.py:702``)."""
    if knob in _warned_noop_knobs:
        return
    _warned_noop_knobs.add(knob)
    import logging
    logging.getLogger("paddle_tpu_torch").warning(
        "%s is accepted for API parity but has no effect%s",
        knob, f" ({why})" if why else "")


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
