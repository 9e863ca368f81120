"""Timing on the card with CUDA events, and the card's peak rates.

- :func:`time_fn` — seconds per call of ``f(*args)``: one warm call, then
  ``iters`` calls between two CUDA events on the current stream.
- :func:`time_fn_slope` — seconds per call from two iteration counts:
  ``(t(hi) - t(lo)) / (hi - lo)``, each leg the minimum over ``reps``
  repetitions, so a fixed cost per measurement (the events, the launch of
  the first call) cancels and delays, which only add, are left out.
  :func:`slope_calls` is the number of calls it makes.
- :func:`time_held` — seconds per call of the card's work alone: the calls
  are enqueued while the card spins on a hold kernel, so gaps between the
  host's enqueues are not timed (for callables that enqueue many small
  kernels from the host).
- :func:`peaks` — NVIDIA's data-sheet peaks (dense) of the card by name:
  float32 on the CUDA cores, bf16 on the tensor cores, and HBM bandwidth.
  A card the table does not know raises.

The callables may return anything (a tensor or a tuple of them); their
results are dropped.  Every function here needs a CUDA device and raises
without one: a time taken on the host is not a time of the card.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

#: (name fragment, f32 FLOP/s on the CUDA cores, bf16 FLOP/s on the tensor
#: cores, HBM bytes/s); the first fragment found in the card's name wins
PEAKS = (("PCIe", 51e12, 756e12, 2.0e12), ("NVL", 60e12, 835e12, 3.9e12),
         ("H100", 67e12, 989e12, 3.35e12), ("H200", 67e12, 989e12, 4.8e12))
#: :func:`time_fn_slope`'s iteration counts and repetitions
SLOPE_ITERS, SLOPE_REPS = (8, 40), 3
#: GPU clock cycles of :func:`time_held`'s first hold (~10 ms at an H100's
#: 1.98 GHz), and the rounds it tries, doubling the hold, before it raises
HOLD_CYCLES, HOLD_TRIES = 20_000_000, 4


def peaks(name: str) -> Tuple[float, float, float]:
    """``(f32 FLOP/s, bf16 FLOP/s, HBM bytes/s)`` of the card ``name``
    (``torch.cuda.get_device_name``); raises for a card not in the table."""
    for key, f32, bf16, bw in PEAKS:
        if key in name:
            return f32, bf16, bw
    raise RuntimeError(f"no peak table entry for card {name!r}")


def _need_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device (timing is on the card)")


def _elapsed_s(f: Callable, args, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        f(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def time_fn(f: Callable, *args, iters: int = 8) -> float:
    """Seconds per call of ``f(*args)`` on the card (after one warm
    call)."""
    _need_cuda("time_fn")
    f(*args)
    torch.cuda.synchronize()
    return _elapsed_s(f, args, iters) / iters


def time_fn_slope(f: Callable, *args,
                  iters: Tuple[int, int] = SLOPE_ITERS,
                  reps: int = SLOPE_REPS) -> float:
    """Seconds per call of ``f(*args)`` on the card: the slope between
    ``iters[0]`` and ``iters[1]`` calls, each the minimum over ``reps``."""
    lo, hi = iters
    if not 0 < lo < hi:
        raise ValueError(f"time_fn_slope: iters {iters} must be 0 < lo < hi")
    _need_cuda("time_fn_slope")
    f(*args)
    torch.cuda.synchronize()
    t_lo = min(_elapsed_s(f, args, lo) for _ in range(reps))
    t_hi = min(_elapsed_s(f, args, hi) for _ in range(reps))
    return max(t_hi - t_lo, 1e-9) / (hi - lo)


def slope_calls(iters: Tuple[int, int] = SLOPE_ITERS,
                reps: int = SLOPE_REPS) -> int:
    """Calls :func:`time_fn_slope` makes: one warm call and ``reps`` legs
    of each iteration count."""
    return 1 + reps * (iters[0] + iters[1])


def time_held(f: Callable, *args, runs: int = 5,
              hold_cycles: int = HOLD_CYCLES) -> Tuple[float, int]:
    """``(seconds per call, calls made)`` of ``f(*args)`` on the card
    alone.  The card spins on a hold kernel while the host enqueues
    ``runs`` calls between two CUDA events.  If the hold has ended by the
    time the last call is enqueued (the start event has completed), the
    events would time the host's gaps: the round is repeated with twice
    the hold, up to ``HOLD_TRIES`` rounds, and then this raises."""
    _need_cuda("time_held")
    calls = 0
    for _ in range(HOLD_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        start.record()
        for _ in range(runs):
            f(*args)
        calls += runs
        held = not start.query()
        end.record()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / 1e3 / runs, calls
        hold_cycles *= 2
    raise RuntimeError(f"time_held: the host took longer to enqueue {runs} "
                       f"calls than a hold of {hold_cycles // 2} cycles")
