"""Fault injection and the transient-error taxonomy: the part of
``paddle_tpu/resilience.py`` (:137-391) that the decode loop needs.

- **Fault injection** (``FLAGS_fault_inject="site:spec[;site:spec...]"``):
  deterministic, flag-driven hooks.  Spec grammar (comma-joined keys)::

      serving.decode_step:every=3     # every 3rd call raises
      serving.decode_step:once@2      # exactly the 2nd call (also once@step2)
      serving.decode_step:p=0.1,seed=7   # Bernoulli, deterministic stream
      serving.decode_step:times=2     # the first 2 calls

  An injected fault raises :class:`InjectedFault` (transient by contract)
  and bumps ``paddle_tpu_fault_injected_total{site=...}``.  The reference's
  ``hang`` mode needs the watchdog, which is not ported: a spec that asks
  for it is refused at parse time.
- **Taxonomy**: :func:`mark_transient` tags an exception as retryable and
  :func:`is_transient` reads the tag; the decode loop re-runs a step whose
  error is transient.

Not ported yet (ROADMAP): the retry engine and backoff schedule, circuit
breakers, ``CheckpointDaemon``, ``PreemptionGuard`` and the hung-step
watchdog.
"""

from __future__ import annotations

import random
import re
import threading
import warnings
from typing import Any, Dict

from . import monitor as _monitor

__all__ = ["InjectedFault", "is_transient", "mark_transient", "KNOWN_SITES",
           "FaultSpec", "parse_fault_inject", "configure", "maybe_inject"]

_FAULT_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_fault_injected_total",
    "faults fired by the FLAGS_fault_inject framework", ("site",))


class InjectedFault(RuntimeError):
    """A deterministic fault fired by ``FLAGS_fault_inject`` — transient by
    contract, so a site with a retry budget absorbs it."""

    pt_transient = True

    def __init__(self, site: str, call_n: int, spec: str):
        super().__init__(
            f"injected fault at {site!r} (call #{call_n}, spec {spec!r})")
        self.site = site
        self.call_n = call_n


def mark_transient(e: BaseException) -> BaseException:
    """Tag an exception as transient, so :func:`is_transient` callers
    retry it."""
    e.pt_transient = True
    return e


def is_transient(e: BaseException) -> bool:
    return bool(getattr(e, "pt_transient", False))


#: the reference's hook sites (a documented contract: parsing warns on an
#: unknown site rather than failing).  The port calls ``maybe_inject`` at
#: ``serving.decode_step`` so far.
KNOWN_SITES = (
    "ps.put", "ps.get", "ps.push_dense", "ps.push_sparse", "ps.get_rows",
    "ps.put_typed", "ps.get_typed", "ps.push_typed",
    "dataloader.produce", "compile", "executor.dispatch",
    "fetch.materialize", "checkpoint.write", "serving.decode_step",
    "collective.launch", "numerics.poison", "memory.oom",
    "serving.batch_dispatch", "router.forward", "coordinator.frame",
    "replica.heartbeat", "autoscaler.decide", "autoscaler.spawn",
    "autoscaler.retire",
)

_ONCE_RE = re.compile(r"^once(?:@(?:step)?(\d+))?$")


class FaultSpec:
    """One site's parsed injection spec and its thread-safe call counter."""

    def __init__(self, site: str, raw: str, every: int = 0, at: int = 0,
                 times: int = 0, p: float = 0.0, seed: int = 0):
        self.site = site
        self.raw = raw
        self.every = every
        self.at = at
        self.times = times
        self.p = p
        self.seed = seed
        self._mu = threading.Lock()
        self._count = 0  # guarded-by: _mu
        self._rng = random.Random(seed) if p > 0 else None

    def fire(self):
        """Advance the call counter; -> (should_fire, call_number)."""
        with self._mu:
            self._count += 1
            n = self._count
            hit = ((self.every and n % self.every == 0)
                   or (self.at and n == self.at)
                   or (self.times and n <= self.times)
                   or (self._rng is not None
                       and self._rng.random() < self.p))
        return bool(hit), n

    def __repr__(self):
        return f"FaultSpec({self.site}:{self.raw})"


def parse_fault_inject(value: str) -> Dict[str, FaultSpec]:
    """Parse ``FLAGS_fault_inject`` into {site: FaultSpec}.  Raises
    ``ValueError`` on a malformed entry, so ``set_flags`` refuses a typo'd
    spec up front instead of silently never injecting."""
    specs: Dict[str, FaultSpec] = {}
    for entry in (value or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if ":" not in entry:
            raise ValueError(
                f"fault-inject entry {entry!r} is not 'site:spec'")
        site, _, body = entry.partition(":")
        site = site.strip()
        if site not in KNOWN_SITES:
            warnings.warn(
                f"fault-inject site {site!r} is not a built-in hook "
                f"(known: {', '.join(KNOWN_SITES)}); it will only fire "
                "if something calls maybe_inject() with that name")
        kw: Dict[str, Any] = {}
        for tok in body.split(","):
            tok = tok.strip()
            if not tok:
                continue
            m = _ONCE_RE.match(tok)
            if m:
                kw["at"] = int(m.group(1)) if m.group(1) else 1
                continue
            if tok == "hang" or tok.startswith("hang="):
                raise ValueError("hang mode needs the watchdog, not ported")
            if "=" not in tok:
                raise ValueError(
                    f"fault-inject token {tok!r} in {entry!r} not understood"
                    " (expected every=N, once[@N], times=N, p=F or seed=N)")
            k, _, v = tok.partition("=")
            k = k.strip()
            if k in ("every", "times", "seed"):
                kw[k] = int(v)
            elif k == "p":
                kw["p"] = float(v)
            else:
                raise ValueError(
                    f"unknown fault-inject key {k!r} in {entry!r}")
        if not (kw.get("every") or kw.get("at") or kw.get("times")
                or kw.get("p")):
            raise ValueError(
                f"fault-inject entry {entry!r} has no trigger "
                "(every=/once/times=/p=)")
        if kw.get("every", 0) < 0 or kw.get("times", 0) < 0 or \
                not (0.0 <= kw.get("p", 0.0) <= 1.0):
            raise ValueError(f"fault-inject entry {entry!r} out of range")
        specs[site] = FaultSpec(site, body, **kw)
    return specs


#: the live spec table, replaced wholesale by configure(); maybe_inject's
#: fast path is one dict probe against an (almost always) empty dict
_SPECS: Dict[str, FaultSpec] = {}


def configure(value: str) -> None:
    """(Re)load the injection table from a ``FLAGS_fault_inject`` string
    (setting the flag calls this)."""
    global _SPECS
    _SPECS = parse_fault_inject(value)


def maybe_inject(site: str) -> None:
    """Injection hook: a no-op unless ``FLAGS_fault_inject`` names
    ``site``; then raises :class:`InjectedFault` on the calls its spec
    picks."""
    spec = _SPECS.get(site)
    if spec is None:
        return
    hit, n = spec.fire()
    if not hit:
        return
    _FAULT_CTR.inc(1, site=site)
    raise InjectedFault(site, n, spec.raw)
