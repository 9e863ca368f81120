"""Program debugging helpers (ref ``python/paddle/fluid/debugger.py``; the
port's ``paddle_tpu/debugger.py``).  Only ``format_diagnostics`` so far: the
verifier and the fusion pass report through it."""

from __future__ import annotations

__all__ = ["format_diagnostics"]


def format_diagnostics(diagnostics) -> str:
    """Render verifier ``Diagnostic`` records as a readable report: one
    ``[severity] check`` line with op/var context, plus an indented fix
    hint (``paddle_tpu/debugger.py:13``)."""
    lines = []
    for d in diagnostics:
        loc = []
        if d.op_type is not None:
            loc.append(f"op {d.op_type!r}"
                       + (f" (#{d.op_index})" if d.op_index is not None
                          else ""))
        if d.var is not None:
            loc.append(f"var {d.var!r}")
        if d.block is not None and d.block != "0":
            loc.append(f"block {d.block}")
        where = f" @ {', '.join(loc)}" if loc else ""
        lines.append(f"[{d.severity}] {d.check}{where}: {d.message}")
        if d.fix_hint:
            lines.append(f"    fix: {d.fix_hint}")
    return "\n".join(lines)
