"""Card-memory observability (the port of ``paddle_tpu/memory.py``; ref
capability: ``memory/allocation/allocator_facade.h`` stats and
``retry_allocator.h`` OOM handling).

On the card the caching allocator owns the memory, so what the framework
gives users is observability: what is resident, how big, and what was live
when an OOM hit.

- ``summary(scope)`` — per-var bytes of the scope's tensors, largest first,
  then the allocator bytes no scope var accounts for, with totals, the
  allocator's counters and the recorded plans;
- ``device_memory_stats()`` — ``torch.cuda.memory_stats`` and
  ``mem_get_info`` under the reference's keys (``bytes_in_use``,
  ``peak_bytes_in_use``, ``bytes_limit``); ``{}`` on the host;
- ``live_bytes()`` — ``torch.cuda.memory_allocated`` on the card; on the
  host the distinct storages of the CPU tensors that live scopes hold
  (between steps the executor keeps no other tensor: every temporary is
  freed after its last reader, which is what the planner's ``steady_bytes``
  models);
- the executor appends ``summary()`` to an OOM error, so it names the
  tensors that were resident (``framework/executor.py``).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["summary", "device_memory_stats", "live_bytes",
           "record_hbm_plan", "hbm_plans"]


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:8.2f} {unit}"
        n /= 1024
    return f"{n:.2f} TiB"


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def _cuda_device(device=None):
    import torch
    if device is not None:
        device = torch.device(device)
        return device if device.type == "cuda" else None
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def _host_live_bytes() -> int:
    import torch
    from .framework.scope import LIVE_SCOPES
    seen = set()
    total = 0
    for scope in list(LIVE_SCOPES):
        for _, val in list(scope.items()):
            # a sharded value (SPMD) holds one tensor a rank
            for v in getattr(val, "locals", None) or [val]:
                if not isinstance(v, torch.Tensor) or \
                        v.device.type != "cpu":
                    continue
                st = v.untyped_storage()
                key = st.data_ptr()
                if key in seen:
                    continue
                seen.add(key)
                total += int(st.nbytes())
    return total


def live_bytes(device=None) -> int:
    """Bytes of live tensors: the caching allocator's allocated bytes on
    the card, the live scopes' CPU tensors on the host."""
    dev = _cuda_device(device)
    if dev is None:
        return _host_live_bytes()
    import torch
    return int(torch.cuda.memory_allocated(dev))


def device_memory_stats(device=None) -> dict:
    """The allocator's counters for one card under the reference's keys:
    ``bytes_in_use`` (allocated), ``peak_bytes_in_use`` (the allocated
    peak since the last reset), ``bytes_reserved`` (held by the caching
    allocator) and ``bytes_limit`` (the card's total memory); ``{}`` on
    the host."""
    dev = _cuda_device(device)
    if dev is None:
        return {}
    import torch
    try:
        st = torch.cuda.memory_stats(dev)
        _free, total = torch.cuda.mem_get_info(dev)
    except Exception:
        return {}
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(st.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(total),
            "num_ooms": int(st.get("num_ooms", 0))}


def summary(scope: Optional[object] = None, max_rows: int = 40) -> str:
    """Human-readable residency report: the scope's tensors (named) first,
    largest first, then the allocator bytes no scope tensor accounts for
    (activations, autograd graphs, the caching allocator's blocks in use),
    with totals and allocator counters."""
    import torch
    from .framework.scope import global_scope
    scope = scope if scope is not None else global_scope()
    named = []
    seen = set()
    for name, val in list(scope.items()):
        if not isinstance(val, torch.Tensor):
            continue
        key = (val.device, val.untyped_storage().data_ptr())
        if key in seen:
            continue
        seen.add(key)
        named.append((name, val))
    named.sort(key=lambda kv: -_nbytes(kv[1]))
    total_named = sum(_nbytes(v) for _, v in named)
    live = live_bytes()
    on_card = _cuda_device() is not None
    anon = max(live - sum(_nbytes(v) for _, v in named
                          if v.device.type == "cuda"), 0) if on_card else 0
    lines = ["=== paddle_tpu_torch device memory summary ===",
             f"scope vars: {len(named)}  ({_fmt_bytes(total_named).strip()})"
             f"   not in the scope: {_fmt_bytes(anon).strip()}"]
    for name, v in named[:max_rows]:
        lines.append(f"  {_fmt_bytes(_nbytes(v))}  "
                     f"{str(v.dtype).replace('torch.', ''):>9s} "
                     f"{str(tuple(v.shape)):>20s}  {name}  [{v.device}]")
    if len(named) > max_rows:
        rest = sum(_nbytes(v) for _, v in named[max_rows:])
        lines.append(f"  {_fmt_bytes(rest)}  … {len(named) - max_rows} "
                     "more scope vars")
    if anon:
        lines.append(f"  {_fmt_bytes(anon)}  allocated on the card by no "
                     "scope var (activations, autograd graphs)")
    stats = device_memory_stats()
    if stats:
        parts = [f"{k}={_fmt_bytes(stats[k]).strip()}"
                 for k in ("bytes_in_use", "peak_bytes_in_use",
                           "bytes_reserved", "bytes_limit") if k in stats]
        lines.append("allocator: " + "  ".join(parts))
    for tag, plan in hbm_plans().items():
        lines.append(
            f"hbm plan [{tag[:48]}]: peak "
            f"{_fmt_bytes(plan['peak_bytes']).strip()} "
            f"(args {_fmt_bytes(plan['argument_bytes']).strip()}, temps "
            f"{_fmt_bytes(plan['temp_bytes']).strip()}, out "
            f"{_fmt_bytes(plan['output_bytes']).strip()}, aliased "
            f"-{_fmt_bytes(plan['alias_bytes']).strip()})")
    lines.append(f"total live device bytes: {_fmt_bytes(live).strip()}")
    return "\n".join(lines)


# --- measured plans (ref allocator_facade.h stats) --------------------------
# The reference records each compiled executable's XLA buffer assignment
# here.  The port has no executable: ``hbm.record_xla_plan`` records the
# allocator's measured peak over a plan's first run under the same keys
# (arguments = bytes allocated before the run, temps = the peak above them,
# outputs and aliases 0).

_HBM_PLANS: dict = {}


def record_hbm_plan(tag: str, ma) -> str:
    """Store one plan's memory analysis (an object with the reference's
    ``*_size_in_bytes`` attributes); returns the tag it was stored under
    (suffixed ``#n`` on collision)."""
    if tag in _HBM_PLANS:
        n = 2
        while f"{tag}#{n}" in _HBM_PLANS:
            n += 1
        tag = f"{tag}#{n}"
    arg = int(getattr(ma, "argument_size_in_bytes", 0))
    out = int(getattr(ma, "output_size_in_bytes", 0))
    tmp = int(getattr(ma, "temp_size_in_bytes", 0))
    alias = int(getattr(ma, "alias_size_in_bytes", 0))
    code = int(getattr(ma, "generated_code_size_in_bytes", 0))
    _HBM_PLANS[tag] = {
        "argument_bytes": arg, "output_bytes": out, "temp_bytes": tmp,
        "alias_bytes": alias, "generated_code_bytes": code,
        "peak_bytes": arg + out + tmp + code - alias,
    }
    return tag


def hbm_plans() -> dict:
    return dict(_HBM_PLANS)


def _is_oom_error(e: BaseException) -> bool:
    """An allocation failure: ``torch.cuda.OutOfMemoryError`` or a message
    the reference's test knows."""
    try:
        import torch
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return True
    except Exception:
        pass
    s = str(e)
    return ("RESOURCE_EXHAUSTED" in s or "Out of memory" in s
            or "out of memory" in s or "OOM" in s)
