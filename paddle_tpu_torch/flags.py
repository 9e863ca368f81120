"""Runtime flags (the port's counterpart of ``paddle_tpu/flags.py``; ref
``platform/flags.cc`` and ``core.globals()``).

The graph-fusion flags, the program verifier's gate, the directory of the
fusion autotuner's verdicts, the decode server's paged-KV and retry flags,
the fault-injection table, the step tracer's flags, the hung-step
watchdog's, the checkpoint daemon's cadence and capture flags, the retry
engine's budget flags, the executor's throttle and ``FLAGS_benchmark``,
the memory budget, the sampling profiler's and the HBM accountant's flags,
the numerics plane's (``FLAGS_numerics*``, ``FLAGS_check_nan_inf``), the
serving SLO plane's (``FLAGS_serving_slo*``), the metrics endpoint's
(``FLAGS_metrics_port``, ``FLAGS_metrics_host``), the serving fleet's
and its autoscaler's (``FLAGS_fleet_*``), the comms plane's
(``FLAGS_comms_telemetry``, ``FLAGS_comms_gate_timeout_s``), GSPMD's
(``FLAGS_gspmd_mesh``, ``FLAGS_gspmd_rules``) and the gang's
(``FLAGS_gang_*``, ``FLAGS_coordinator_standby``,
``FLAGS_coordinator_metrics_port``) exist so far, with the
reference's names, defaults, validation and side effects.  ``FLAGS_*`` environment variables
seed them at import, as the reference's ``__bootstrap__`` does; a
malformed value warns and is ignored.
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
    # the retry engine's budget at the PS sites (resilience.RetryPolicy.
    # from_flags): retries after the first attempt, and the deadline in ms
    "FLAGS_rpc_deadline": 180000,
    "FLAGS_rpc_retry_times": 3,
    # circuit breaker: after a retry budget is exhausted, fail calls fast
    # for this many seconds, then let one half-open probe through; 0
    # disables the breaker
    "FLAGS_rpc_circuit_break_secs": 0.0,
    # the step tracer (monitor.TRACER): span recording, export at process
    # exit into this directory, and the ring's capacity
    "FLAGS_telemetry": True,
    "FLAGS_telemetry_export_path": "",
    "FLAGS_telemetry_max_events": 200000,
    # hung-step watchdog: a watched dispatch or fetch exceeding this many
    # seconds dumps every thread's stack and the telemetry ring and raises
    # HungStepError in the hung thread; 0 disables it
    "FLAGS_watchdog_timeout_s": 0.0,
    # where watchdog dumps land ("" = the system temp dir)
    "FLAGS_watchdog_dump_dir": "",
    # "abort": SIGABRT the process when a hung call has not returned a
    # grace window past its deadline (a hang inside C, where the async
    # raise cannot land); "" disables the tier
    "FLAGS_watchdog_escalate": "",
    # checkpoint daemon cadence (resilience.CheckpointDaemon): capture
    # every N completed steps and/or every S seconds; 0 disables a trigger
    "FLAGS_checkpoint_interval_steps": 0,
    "FLAGS_checkpoint_interval_secs": 0.0,
    # capture in groups of at most this many MiB, each group on its way to
    # the host before the next is copied: bounds the capture's extra card
    # bytes at the chunk; 0 = one pass of device copies (2x the state)
    "FLAGS_checkpoint_capture_chunk_mb": 0,
    # adaptive cadence: defer a capture until the last save took at most
    # this fraction of the gap since the previous capture; 0 disables
    "FLAGS_checkpoint_cadence_stretch_frac": 0.0,
    # per-step device sync so wall timing is attributable (normally steps
    # pipeline asynchronously); wins over the in-flight throttle
    "FLAGS_benchmark": False,
    # async dispatch throttle: at most this many runs on the card before
    # run() waits for the oldest one's event; 0 disables it
    "FLAGS_executor_max_inflight_steps": 2,
    # HBM budget in MiB (analysis/memory.py, hbm.py): a verified program
    # whose batch-1 peak plan exceeds it gets a "memory_budget" warning,
    # the batch server halves a bucket's width until its plan fits, and
    # the accountant's headroom is budget - live; 0 = no budget
    "FLAGS_memory_budget_mb": 0,
    # sampling profiler (profiler.SAMPLER): every N executor dispatches
    # open a torch.profiler window of window_steps steps under dir
    # (window_<step>/, at most max_windows kept, oldest deleted first; a
    # manifest.json maps each window to its step range); 0 disables
    "FLAGS_profile_sample_every_n_steps": 0,
    "FLAGS_profile_sample_window_steps": 4,
    "FLAGS_profile_sample_dir": "",
    "FLAGS_profile_sample_max_windows": 8,
    # open a window the moment the median dispatch interval regresses by
    # this fraction over the best median seen; 0 disables
    "FLAGS_profile_sample_regress_frac": 0.0,
    # the HBM accountant (hbm.ACCOUNTANT): sample live card bytes off the
    # training thread every N dispatched steps, peak over the last
    # FLAGS_hbm_window samples
    "FLAGS_hbm_telemetry": True,
    "FLAGS_hbm_sample_every_n_steps": 1,
    "FLAGS_hbm_window": 16,
    # record each plan's allocator peak over its first run
    # (hbm.record_xla_plan, the reference's name)
    "FLAGS_hbm_record_plans": False,
    # open a profiler window (trigger "hbm_regress") when the measured
    # headroom shrinks by this fraction under the best seen; 0 disables
    "FLAGS_hbm_headroom_regress_frac": 0.0,
    # where OOM forensics dumps land ("" = FLAGS_watchdog_dump_dir, else
    # the system temp dir)
    "FLAGS_oom_dump_dir": "",
    # every float output of every op is checked after the op runs, and a
    # non-finite one is reported naming the Fluid op that made it (one
    # host sync an op: off by default, as in the reference)
    "FLAGS_check_nan_inf": False,
    # the numerics plane (analysis/numerics.py): "off", "sentinel" (NaN/Inf
    # trips over the step's gradients and weight state and the global grad
    # norm, one reduction a tensor) or "full" (adds per-variable grad norms
    # and absmax, update ratios, activations and log2 histograms); the
    # statistics reach the host off the step, and the mode is part of the
    # executor's plan key
    "FLAGS_numerics": "off",
    # spike detection: a grad norm above factor x its windowed median
    # fires a grad_spike record (re-armed at factor / 2)
    "FLAGS_numerics_spike_factor": 10.0,
    "FLAGS_numerics_window": 16,
    # per-variable gauge series held at once (top-K by norm / ratio)
    "FLAGS_numerics_topk": 8,
    # a poisoned step holds the checkpoint daemon's captures
    "FLAGS_numerics_quarantine": True,
    # per-tenant SLO objectives (serving/slo.py), e.g.
    # "tenantA:p99_ms=250,avail=99.9;*:p99_ms=500"; "" turns the plane off
    "FLAGS_serving_slo": "",
    # the burn-rate windows, the breach threshold (on both windows;
    # recovery at half of it on the fast one) and the evaluator's cadence
    "FLAGS_serving_slo_fast_window_s": 60.0,
    "FLAGS_serving_slo_slow_window_s": 600.0,
    "FLAGS_serving_slo_burn_threshold": 10.0,
    "FLAGS_serving_slo_eval_interval_s": 1.0,
    # refuse a breached tenant's new submits (reason "slo_shed")
    "FLAGS_serving_slo_shed": False,
    # the /metrics /healthz /statusz endpoint (serving/httpd.py): its port
    # (0 disables it) and bind address
    "FLAGS_metrics_port": 0,
    "FLAGS_metrics_host": "0.0.0.0",
    # the serving fleet (serving/fleet.py): FleetRouter placement,
    # "least_loaded" (the fresh replica with the smallest srv_q, ties
    # round-robin) or "round_robin"
    "FLAGS_fleet_route_policy": "least_loaded",
    # load-report freshness: the srv_q/occ/slots/tps digest keys ride only
    # while a serving loop woke within this many seconds, and a replica
    # whose report is older is held out of placement; must be > 0
    "FLAGS_fleet_digest_ttl_s": 10.0,
    # the fleet autoscaler (serving/autoscaler.py): the live replica count
    # stays inside [min, max] (validated as an effective pair)
    "FLAGS_fleet_min_replicas": 1,
    "FLAGS_fleet_max_replicas": 4,
    # the controller's tick; the *_ticks flags count in units of it (> 0)
    "FLAGS_fleet_scale_eval_interval_s": 2.0,
    # consecutive ticks the scale-up (fleet SLO breached and mean srv_q >=
    # queue_high) / scale-down (no breach, empty queues, per-replica rate
    # under idle_qps) condition must hold before the target moves
    "FLAGS_fleet_scale_up_ticks": 2,
    "FLAGS_fleet_scale_down_ticks": 5,
    # no further target change this long after one (death repair exempt)
    "FLAGS_fleet_scale_cooldown_s": 30.0,
    "FLAGS_fleet_queue_high": 4.0,
    "FLAGS_fleet_idle_qps": 0.5,
    # breached ticks before admission shedding engages (only while a spawn
    # is in flight or the fleet is at max, and only with
    # FLAGS_serving_slo_shed)
    "FLAGS_fleet_shed_after_ticks": 2,
    # a replica under this headroom fraction gets a bucket-width shrink
    # first, then after the grace ticks a drain and respawn; in [0, 1)
    "FLAGS_fleet_oom_headroom_frac": 0.10,
    "FLAGS_fleet_shrink_grace_ticks": 3,
    # wait after a failed spawn before retrying (>= 0)
    "FLAGS_fleet_spawn_backoff_s": 10.0,
    # the comms plane (analysis/comms.py): the executor's collective mode
    # bumps the per-collective byte counters after each step and hands the
    # step's timing record to the off-thread comms monitor (a few counter
    # bumps and one queue append a step)
    "FLAGS_comms_telemetry": True,
    # how long the pre-collective timestamp exchange through the gang
    # coordinator (the executor's comm gate) waits for every rank before
    # returning a partial view; the gate disarms after 3 failures
    "FLAGS_comms_gate_timeout_s": 10.0,
    # the gang (distributed/env.py, distributed/coordinator.py): how long
    # the rank-0 leader waits for every rank to announce the same
    # emergency-checkpoint step before it leaves the manifest where it was
    "FLAGS_gang_commit_timeout_s": 30.0,
    # every rank's GangClient heartbeat cadence, and how long a rank may
    # miss heartbeats before the coordinator declares it dead
    "FLAGS_gang_heartbeat_interval_s": 0.5,
    "FLAGS_gang_heartbeat_timeout_s": 10.0,
    # how long a survivor parks in GangClient.wait_ready() for the
    # launcher (--max_restarts) to respawn a dead rank
    "FLAGS_gang_rejoin_timeout_s": 300.0,
    # the executor's per-step gang barrier before a collective step
    # (socket backend only): refuses a fingerprint mismatch before
    # dispatch; one coordinator round trip a step, so off by default
    "FLAGS_gang_step_barrier": False,
    "FLAGS_gang_step_barrier_timeout_s": 60.0,
    # the launcher also hosts a warm-standby coordinator (primary port + 1)
    # and hands the ranks both addresses
    "FLAGS_coordinator_standby": False,
    # the launcher's coordinator serves /metrics /healthz /statusz on this
    # port (0 disables it)
    "FLAGS_coordinator_metrics_port": 0,
    # GSPMD (parallel/partitioner.py): the default mesh of
    # CompiledProgram.with_gspmd when neither `mesh` nor `axes` is given,
    # "axis:size[,axis:size...]" ("" = one mp axis over every visible
    # card), and its default rule table: "auto" (the cheapest-traffic
    # table whose per-shard static peak fits FLAGS_memory_budget_mb) or a
    # table name ("replicated", "mp_hidden", "mp_hidden_vocab")
    "FLAGS_gspmd_mesh": "",
    "FLAGS_gspmd_rules": "auto",
}

_NUMERICS_FLAGS = ("FLAGS_numerics", "FLAGS_numerics_spike_factor",
                   "FLAGS_numerics_window", "FLAGS_numerics_topk",
                   "FLAGS_numerics_quarantine")
_SLO_NUMERIC = ("FLAGS_serving_slo_fast_window_s",
                "FLAGS_serving_slo_slow_window_s",
                "FLAGS_serving_slo_burn_threshold")

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
        if name == "FLAGS_watchdog_escalate" and \
                coerced[name] not in ("", "abort"):
            raise ValueError(
                f"FLAGS_watchdog_escalate must be '' or 'abort', got "
                f"{coerced[name]!r}")
        if name == "FLAGS_gspmd_mesh" and coerced[name]:
            # the "axis:size,..." grammar refuses here, not in with_gspmd
            try:
                parsed = {k: int(v) for k, v in
                          (kv.split(":") for kv in coerced[name].split(","))}
            except Exception:
                raise ValueError(
                    "FLAGS_gspmd_mesh must be 'axis:size[,axis:size...]' "
                    f"e.g. 'dp:2,mp:4', got {coerced[name]!r}")
            if not parsed or any(s <= 0 for s in parsed.values()):
                raise ValueError(
                    f"FLAGS_gspmd_mesh sizes must be positive: "
                    f"{coerced[name]!r}")
        if name == "FLAGS_gspmd_rules" and coerced[name] != "auto":
            from .parallel.partitioner import rule_table
            rule_table(coerced[name])   # raises on an unknown table name
        if name == "FLAGS_numerics" and \
                coerced[name] not in ("off", "sentinel", "full"):
            raise ValueError(
                "FLAGS_numerics must be 'off', 'sentinel' or 'full', "
                f"got {coerced[name]!r}")
        if name == "FLAGS_serving_slo" and coerced[name]:
            from .serving.slo import parse_slo
            parse_slo(coerced[name])
        _check_fleet_flag(name, coerced[name])
    if any(n in coerced for n in _SLO_NUMERIC):
        # the pair and threshold in force after this call (new values over
        # the current ones) must hold, so a bad pair is refused here
        eff = {n: float(coerced.get(n, _values[n])) for n in _SLO_NUMERIC}
        fast = eff["FLAGS_serving_slo_fast_window_s"]
        slow = eff["FLAGS_serving_slo_slow_window_s"]
        if not 0 < fast <= slow:
            raise ValueError(
                "SLO windows must satisfy 0 < fast <= slow (got "
                f"fast={fast}, slow={slow})")
        if eff["FLAGS_serving_slo_burn_threshold"] <= 0:
            raise ValueError(
                "FLAGS_serving_slo_burn_threshold must be > 0 (got "
                f"{eff['FLAGS_serving_slo_burn_threshold']})")
    fleet_size = ("FLAGS_fleet_min_replicas", "FLAGS_fleet_max_replicas")
    if any(n in coerced for n in fleet_size):
        # the bounds in force after this call must form 1 <= min <= max
        eff = {n: int(coerced.get(n, _values[n])) for n in fleet_size}
        lo = eff["FLAGS_fleet_min_replicas"]
        hi = eff["FLAGS_fleet_max_replicas"]
        if not 1 <= lo <= hi:
            raise ValueError(
                "fleet size bounds must satisfy 1 <= min <= max (got "
                f"min={lo}, max={hi})")
    _values.update(coerced)
    for name, value in coerced.items():
        _apply_side_effect(name, value)


def _check_fleet_flag(name: str, value) -> None:
    """The reference's per-flag checks of the fleet flags."""
    if name == "FLAGS_fleet_route_policy" and \
            value not in ("least_loaded", "round_robin"):
        raise ValueError(
            "FLAGS_fleet_route_policy must be 'least_loaded' or "
            f"'round_robin', got {value!r}")
    if name == "FLAGS_fleet_digest_ttl_s" and value <= 0:
        raise ValueError(
            "FLAGS_fleet_digest_ttl_s must be > 0 (a zero/negative TTL "
            f"would blind placement), got {value!r}")
    if name == "FLAGS_fleet_scale_eval_interval_s" and value <= 0:
        raise ValueError(
            f"FLAGS_fleet_scale_eval_interval_s must be > 0, got {value!r}")
    if name in ("FLAGS_fleet_scale_cooldown_s", "FLAGS_fleet_spawn_backoff_s",
                "FLAGS_fleet_queue_high", "FLAGS_fleet_idle_qps") \
            and value < 0:
        raise ValueError(f"{name} must be >= 0, got {value!r}")
    if name in ("FLAGS_fleet_scale_up_ticks", "FLAGS_fleet_scale_down_ticks",
                "FLAGS_fleet_shed_after_ticks",
                "FLAGS_fleet_shrink_grace_ticks") and value < 1:
        raise ValueError(f"{name} must be >= 1, got {value!r}")
    if name == "FLAGS_fleet_oom_headroom_frac" and not 0 <= value < 1:
        raise ValueError(
            f"FLAGS_fleet_oom_headroom_frac must be in [0, 1), got {value!r}")


def _apply_side_effect(name: str, value) -> None:
    from . import monitor, resilience
    if name == "FLAGS_fault_inject":
        resilience.configure(value)       # validated in set_flags
    elif name == "FLAGS_telemetry":
        monitor.TRACER.enabled = bool(value)
    elif name == "FLAGS_telemetry_max_events":
        monitor.TRACER.set_capacity(int(value))
    elif name == "FLAGS_telemetry_export_path":
        if value:
            monitor.enable_export_on_exit(str(value))
        else:
            monitor.disable_export_on_exit()
    elif name == "FLAGS_watchdog_timeout_s":
        resilience.WATCHDOG.set_timeout(float(value))
    elif name == "FLAGS_watchdog_escalate":
        resilience.WATCHDOG.escalate = str(value)
    elif name in ("FLAGS_profile_sample_every_n_steps",
                  "FLAGS_profile_sample_window_steps",
                  "FLAGS_profile_sample_dir",
                  "FLAGS_profile_sample_max_windows",
                  "FLAGS_profile_sample_regress_frac"):
        from . import profiler
        fl = _values
        profiler.SAMPLER.configure(
            int(fl["FLAGS_profile_sample_every_n_steps"]),
            int(fl["FLAGS_profile_sample_window_steps"]),
            str(fl["FLAGS_profile_sample_dir"]),
            int(fl["FLAGS_profile_sample_max_windows"]),
            regress_frac=float(fl["FLAGS_profile_sample_regress_frac"]))
    elif name in ("FLAGS_hbm_telemetry", "FLAGS_hbm_sample_every_n_steps",
                  "FLAGS_hbm_window", "FLAGS_hbm_headroom_regress_frac"):
        from . import hbm
        fl = _values
        hbm.ACCOUNTANT.configure(
            bool(fl["FLAGS_hbm_telemetry"]),
            int(fl["FLAGS_hbm_sample_every_n_steps"]),
            int(fl["FLAGS_hbm_window"]),
            float(fl["FLAGS_hbm_headroom_regress_frac"]))
    elif name in _NUMERICS_FLAGS:
        from .analysis import numerics
        fl = _values
        numerics.configure(
            str(fl["FLAGS_numerics"]),
            spike_factor=float(fl["FLAGS_numerics_spike_factor"]),
            window=int(fl["FLAGS_numerics_window"]),
            topk=int(fl["FLAGS_numerics_topk"]),
            quarantine=bool(fl["FLAGS_numerics_quarantine"]))
    elif name in ("FLAGS_rpc_retry_times", "FLAGS_rpc_deadline"):
        # the reference's native PS client reads these from the
        # environment; mirrored as the reference does
        os.environ[name] = str(int(value))


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
