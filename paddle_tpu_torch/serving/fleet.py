"""Serving fleet: replica endpoints and the :class:`FleetRouter` (the port
of ``paddle_tpu/serving/fleet.py``).

A fleet is N serving replicas (each an
:class:`~paddle_tpu_torch.serving.server.InferenceServer` or
:class:`~paddle_tpu_torch.serving.server.DecodeServer` behind a
:class:`ReplicaEndpoint`) fronted by one :class:`FleetRouter`.  The router
speaks the gang coordinator's length-prefixed JSON frames
(``distributed/coordinator.py``) to each replica, places every request on
the least-loaded healthy replica, and absorbs replica failure: a request
whose replica dies mid-batch is replayed on a survivor instead of reaching
the client as an error.  The wire format is the reference's, outputs
included (nested JSON lists), so a port router can front reference replicas
and back.

Placement (``FLAGS_fleet_route_policy``): ``least_loaded`` (default) takes
the fresh, non-draining, breaker-closed replica with the smallest ``srv_q``
from its load report, ties broken round-robin; ``round_robin`` rotates over
the healthy set.

Freshness: a replica's load report ages out after
``FLAGS_fleet_digest_ttl_s`` seconds without contact (a reply or a probe
refreshes it).  A stale replica is held out of placement while the prober
keeps knocking, so a slow replica rejoins on its next answer.

Per forward attempt: a refused, reset or torn connection marks the replica
``dead``, opens its circuit breaker and re-routes (``reason="dead"``); a
``draining`` refusal (a SIGTERMed replica finishing its own work) marks it
``draining`` and re-routes (``"drain"``); an open breaker skips it without
touching the wire (``"circuit"``); any other refusal re-routes as
``"error"``.  Re-routes follow ``resilience.RetryPolicy``'s jittered ladder
under a deadline and pass the ``router.forward`` fault site; each one
counts in ``paddle_tpu_fleet_reroutes_total{reason}``.  A request that
lands after a re-route observes ``paddle_tpu_fleet_failover_ms``, the wall
time from its first failed attempt, as the family's help says (the
reference's router leaves that family to its coordinator's clients).

Quota: the router keeps its own fleet-wide
:class:`~paddle_tpu_torch.serving.server.TenantPlane`, so a tenant's quota
bounds its outstanding requests across all replicas; the router's
``BurnRateEvaluator`` (``FLAGS_serving_slo``) sees every request's
end-to-end outcome, and the autoscaler's shed switch refuses new work
(``slo_shed``).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import monitor as _monitor
from .. import resilience as _resil
from ..distributed.coordinator import recv_frame, send_frame
from .server import AdmissionError, TenantPlane

__all__ = ["ReplicaEndpoint", "FleetRouter", "FleetError"]

#: FLEET_REPLICA_STATE gauge encoding (documented on the family)
_STATE_CODE = {"up": 0, "draining": 1, "dead": 2, "stale": 3}


class FleetError(RuntimeError):
    """The fleet could not complete a request: every placement candidate
    failed or the retry deadline elapsed."""


# ---------------------------------------------------------------------------
# replica side: a frame-protocol endpoint in front of one serving server
# ---------------------------------------------------------------------------

class ReplicaEndpoint:
    """TCP front for ONE serving server, speaking the coordinator's
    frame protocol (4-byte BE length + JSON).

    Ops: ``infer`` (InferenceServer.submit), ``decode``
    (DecodeServer.submit), ``status`` (load probe).  Every reply carries
    the replica's current load report (``srv_q``/``occ``/``slots``/
    ``tps`` where available) and its ``draining`` bit, so each response
    doubles as a freshness heartbeat for the router's placement table.
    """

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 replica_id: Optional[str] = None):
        self.server = server
        self.host = host
        self._requested_port = int(port)
        self.port: Optional[int] = None
        self.replica_id = replica_id or f"replica-{os.getpid()}"
        self._lsock: Optional[socket.socket] = None
        self._mu = threading.Lock()
        self._stopping = False                  # guarded-by: _mu
        self._conns: List[socket.socket] = []   # guarded-by: _mu
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ReplicaEndpoint":
        if self._lsock is not None:
            return self
        with self._mu:
            self._stopping = False
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self._requested_port))
        s.listen(128)
        self._lsock = s
        self.port = s.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="pt-replica-accept")
        t.start()
        self._threads.append(t)
        return self

    @property
    def address(self) -> str:
        if self.port is None:
            raise RuntimeError("replica endpoint not started")
        return f"{self.host}:{self.port}"

    def stop(self) -> None:
        with self._mu:
            self._stopping = True
            conns, self._conns = self._conns, []
        if self._lsock is not None:
            # close() alone does NOT wake a thread blocked in accept():
            # the in-flight syscall keeps the LISTEN socket alive in the
            # kernel, which keeps completing handshakes nobody serves —
            # a "stopped" replica that still looks connectable hangs
            # clients until timeout instead of refusing fast
            try:
                self._lsock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._lsock.close()
            except OSError:
                pass
            self._lsock = None
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- accept / serve ------------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._lsock.accept()
            except (OSError, AttributeError):
                return
            with self._mu:
                if self._stopping:
                    conn.close()
                    return
                self._conns.append(conn)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True, name="pt-replica-conn")
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                req = recv_frame(conn)
                try:
                    resp = self._handle(req)
                except Exception as e:     # a bad request must not kill
                    resp = {"ok": False,   # the endpoint
                            "error": "internal",
                            "detail": repr(e)[:300]}
                resp.setdefault("replica", self.replica_id)
                resp.setdefault("load", self._load())
                resp.setdefault("draining", self._draining())
                send_frame(conn, resp)
        except (ConnectionError, OSError, ValueError):
            pass                           # client went away / bad frame
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._mu:
                if conn in self._conns:
                    self._conns.remove(conn)

    # -- load report ---------------------------------------------------------
    def _draining(self) -> bool:
        return bool(self.server._draining.is_set())

    def _load(self) -> Dict[str, float]:
        """The placement digest: queue depth from the server itself (the
        authoritative number), the occupancy/slot/throughput keys from
        the monitor digest when the scheduler is alive to report them."""
        load = {"srv_q": float(self.server.queue_depth())}
        try:
            digest = _monitor.metrics_digest()
        except Exception:
            digest = {}
        # hbm/hdrm ride along when the memory accountant publishes them —
        # the autoscaler's OOM-risk headroom signal (degradation ladder)
        for k in ("occ", "slots", "tps", "hbm", "hdrm"):
            if k in digest:
                load[k] = float(digest[k])
        return load

    # -- ops -----------------------------------------------------------------
    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "status":
            return {"ok": True}
        if op == "infer":
            return self._op_infer(req)
        if op == "decode":
            return self._op_decode(req)
        if op == "control":
            return self._op_control(req)
        return {"ok": False, "error": "unknown_op", "detail": str(op)}

    def _op_control(self, req: dict) -> dict:
        """Autoscaler control plane.  ``shrink_width`` is the degradation
        ladder's first rung: halve this replica's admitted bucket widths
        to claw back card memory headroom.  A server without the actuator (e.g.
        DecodeServer — no BucketPlan) answers ``unsupported``, which
        escalates the controller's ladder straight to drain-and-respawn."""
        cmd = req.get("cmd")
        if cmd == "shrink_width":
            fn = getattr(self.server, "shrink_widths", None)
            if fn is None:
                return {"ok": False, "error": "unsupported",
                        "detail": f"{type(self.server).__name__} has no "
                                  "bucket plan to shrink"}
            try:
                widths = fn()
            except Exception as e:
                return {"ok": False, "error": "internal",
                        "detail": repr(e)[:300]}
            return {"ok": True,
                    "widths": {str(b): int(w) for b, w in widths.items()}}
        return {"ok": False, "error": "unknown_cmd", "detail": str(cmd)}

    @staticmethod
    def _admission_reply(e: AdmissionError) -> dict:
        # the draining refusal is a ROUTING signal (re-route, don't
        # fail); every other admission verdict is final for this replica
        msg = str(e)
        if "draining" in msg:
            return {"ok": False, "error": "draining", "detail": msg}
        return {"ok": False, "error": "admission", "detail": msg}

    def _op_infer(self, req: dict) -> dict:
        feeds = {}
        for name, spec in (req.get("feeds") or {}).items():
            feeds[name] = np.asarray(spec["data"],
                                     dtype=spec.get("dtype") or None)
        try:
            fut = self.server.submit(str(req.get("tenant", "default")),
                                     feeds, seq_len=req.get("seq_len"))
            result = fut.result(timeout=float(req.get("timeout_s", 30.0)))
        except AdmissionError as e:
            return self._admission_reply(e)
        outputs = [np.asarray(a).tolist() for a in (result or [])]
        return {"ok": True, "outputs": outputs}

    def _op_decode(self, req: dict) -> dict:
        try:
            fut = self.server.submit(
                str(req.get("tenant", "default")),
                list(req.get("prompt") or []),
                max_new_tokens=int(req.get("max_new_tokens", 16)),
                eos_id=req.get("eos_id"))
            result = fut.result(timeout=float(req.get("timeout_s", 30.0)))
        except AdmissionError as e:
            return self._admission_reply(e)
        return {"ok": True, "tokens": np.asarray(result).tolist()}


# ---------------------------------------------------------------------------
# router side: placement + re-route
# ---------------------------------------------------------------------------

class FleetRouter:
    """Fleet front door: places each request on the best healthy replica
    and re-routes around failures (see module docstring for the policy
    and failure taxonomy)."""

    def __init__(self, replicas: Sequence[str],
                 policy: Optional[str] = None,
                 digest_ttl_s: Optional[float] = None,
                 tenant_quota: int = 0,
                 request_timeout_s: float = 30.0,
                 retry_policy: Optional[_resil.RetryPolicy] = None):
        from ..flags import get_flags
        fl = get_flags(["FLAGS_fleet_route_policy",
                        "FLAGS_fleet_digest_ttl_s"])
        self.policy = str(policy or fl["FLAGS_fleet_route_policy"])
        self.digest_ttl_s = float(digest_ttl_s if digest_ttl_s is not None
                                  else fl["FLAGS_fleet_digest_ttl_s"])
        self.request_timeout_s = float(request_timeout_s)
        #: fleet-wide quota plane — ONE admission decision per request,
        #: made here, so N replicas never multiply a tenant's budget
        self.tenants = TenantPlane(default_quota=int(tenant_quota))
        # generous default ladder: enough attempts to visit every
        # replica plus backoff headroom, bounded by a hard deadline so a
        # wedged fleet fails the client loudly instead of forever
        self._retry = retry_policy or _resil.RetryPolicy(
            max_attempts=max(4, 2 * len(replicas) + 2),
            base_delay_s=0.02, max_delay_s=0.25,
            deadline_s=self.request_timeout_s)
        self._mu = threading.Lock()
        self._reps: Dict[str, dict] = {}        # guarded-by: _mu
        for addr in replicas:
            self._reps[str(addr)] = {
                "state": "up", "load": {}, "last_seen": 0.0,
                "breaker": _resil.CircuitBreaker(name=f"fleet.{addr}"),
            }
            _monitor.FLEET_REPLICA_STATE.set(_STATE_CODE["up"],
                                             replica=str(addr))
        self._rr = 0                            # guarded-by: _mu
        self._stats = {"admitted": 0, "completed": 0,  # guarded-by: _mu
                       "failed": 0, "rejected": 0}
        #: autoscaler shed switch: while True, _admit rejects every new
        #: request with reason="slo_shed" (cheap backpressure while a
        #: spawn is in flight or the fleet is pinned at max)
        self._shedding = False                  # guarded-by: _mu
        # fleet-level SLO plane: the router records every request's e2e
        # outcome, so the autoscaler reads ONE burn-rate signal for the
        # whole fleet (per-replica evaluators see only their slice of
        # traffic and none of the routing/retry latency).  None when
        # FLAGS_serving_slo is empty — the controller then scales on
        # queue pressure alone.
        from .slo import BurnRateEvaluator
        self.slo = BurnRateEvaluator.from_flags()
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._prober is None or not self._prober.is_alive():
            self._stop.clear()
            self._prober = threading.Thread(target=self._probe_loop,
                                            daemon=True,
                                            name="pt-fleet-prober")
            self._prober.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=2.0)
            self._prober = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- replica table -------------------------------------------------------
    def _set_state_locked(self, addr: str,  # guarded-by-caller: _mu
                          state: str) -> None:
        rep = self._reps[addr]
        if rep["state"] != state:
            rep["state"] = state
            _monitor.FLEET_REPLICA_STATE.set(_STATE_CODE[state],
                                             replica=addr)

    def _note_reply(self, addr: str, resp: dict) -> None:
        """Any reply from a replica refreshes its freshness clock and
        load report — replies ARE the router's heartbeat plane."""
        with self._mu:
            rep = self._reps.get(addr)
            if rep is None:
                return
            rep["last_seen"] = time.monotonic()
            # ANY reply proves the transport works: close the breaker
            # (a half-open probe that got an answer succeeded, even a
            # "draining" refusal — state still holds the replica out)
            rep["breaker"].record_success()
            load = resp.get("load")
            if isinstance(load, dict):
                rep["load"] = load
            if resp.get("draining"):
                self._set_state_locked(addr, "draining")
            elif rep["state"] in ("dead", "stale", "draining"):
                self._set_state_locked(addr, "up")

    def _mark_dead(self, addr: str) -> None:
        with self._mu:
            rep = self._reps.get(addr)
            if rep is None:
                return
            self._set_state_locked(addr, "dead")
            rep["breaker"].record_giveup()

    def _mark_draining(self, addr: str) -> None:
        with self._mu:
            if addr in self._reps:
                self._set_state_locked(addr, "draining")

    def add_replica(self, addr: str) -> None:
        """Admit a freshly spawned replica into placement (autoscaler
        scale-up / death repair).  Idempotent; the new replica enters
        with no load report and proves freshness on its first probe or
        reply."""
        addr = str(addr)
        with self._mu:
            if addr in self._reps:
                return
            self._reps[addr] = {
                "state": "up", "load": {}, "last_seen": 0.0,
                "breaker": _resil.CircuitBreaker(name=f"fleet.{addr}"),
            }
            _monitor.FLEET_REPLICA_STATE.set(_STATE_CODE["up"],
                                             replica=addr)

    def remove_replica(self, addr: str) -> None:
        """Drop a retired/dead replica from the table (autoscaler
        retire path, AFTER its drain finished).  Folds the replica's
        state gauge series so the registry does not grow with fleet
        churn."""
        addr = str(addr)
        with self._mu:
            rep = self._reps.pop(addr, None)
        if rep is not None:
            _monitor.FLEET_REPLICA_STATE.fold({"replica": addr}, None)

    def set_shedding(self, on: bool) -> None:
        """Engage/release fleet-wide admission shedding (the autoscaler's
        shed-vs-scale arbitration actuator)."""
        with self._mu:
            self._shedding = bool(on)

    def replica_view(self) -> Dict[str, dict]:
        """The autoscaler's per-replica signal view: placement state,
        last load report (srv_q + the digest keys incl. hbm/hdrm), and
        whether the load report is fresh under the digest TTL."""
        now = time.monotonic()
        with self._mu:
            return {a: {"state": r["state"],
                        "load": dict(r["load"]),
                        "fresh": bool(r["last_seen"] and
                                      now - r["last_seen"]
                                      <= self.digest_ttl_s)}
                    for a, r in self._reps.items()}

    def control(self, addr: str, cmd: str,
                timeout_s: float = 5.0) -> dict:
        """Send one control op (e.g. ``shrink_width``) directly to a
        replica — control traffic never routes through placement."""
        resp = self._call(addr, {"op": "control", "cmd": str(cmd)},
                          timeout_s)
        self._note_reply(addr, resp)
        return resp

    def snapshot(self) -> Dict[str, Any]:
        """Operational view: per-replica state/load/freshness plus the
        router's exact request ledger (admitted == completed + failed +
        in-flight; the chaos drill asserts this sums)."""
        now = time.monotonic()
        with self._mu:
            reps = {a: {"state": r["state"],
                        "load": dict(r["load"]),
                        "age_s": (round(now - r["last_seen"], 3)
                                  if r["last_seen"] else None),
                        "breaker": r["breaker"].state}
                    for a, r in self._reps.items()}
            return {"replicas": reps, "policy": self.policy,
                    "ttl_s": self.digest_ttl_s,
                    "shedding": self._shedding, **self._stats}

    # -- placement -----------------------------------------------------------
    def _place(self, exclude=()) -> Optional[str]:
        """Pick the next replica: fresh, not draining/dead, breaker
        willing.  Falls back to probing a stale (but never a draining)
        replica when nothing fresh remains — a router that has lost
        every load report must still try the fleet, not refuse it."""
        now = time.monotonic()
        with self._mu:
            fresh, stale = [], []
            for addr, rep in self._reps.items():
                if addr in exclude or rep["state"] in ("draining", "dead"):
                    continue
                age = now - rep["last_seen"]
                if rep["last_seen"] and age <= self.digest_ttl_s:
                    if rep["state"] == "stale":
                        self._set_state_locked(addr, "up")
                    fresh.append(addr)
                else:
                    if rep["last_seen"] and rep["state"] == "up":
                        # digest TTL: the load report aged out — hold
                        # the replica out of normal placement until a
                        # probe or reply refreshes it
                        self._set_state_locked(addr, "stale")
                    stale.append(addr)
            pool = fresh or stale
            if not pool:
                return None
            if fresh and self.policy == "least_loaded":
                pool = sorted(
                    fresh, key=lambda a:
                    float(self._reps[a]["load"].get("srv_q", 0.0)))
                best_q = float(
                    self._reps[pool[0]]["load"].get("srv_q", 0.0))
                pool = [a for a in pool
                        if float(self._reps[a]["load"].get("srv_q", 0.0))
                        <= best_q]
            self._rr += 1
            candidates = [pool[(self._rr + i) % len(pool)]
                          for i in range(len(pool))]
            for addr in candidates:
                try:
                    self._reps[addr]["breaker"].check(f"fleet.{addr}")
                except _resil.CircuitOpenError:
                    continue
                return addr
            return None

    # -- transport -----------------------------------------------------------
    def _call(self, addr: str, payload: dict, timeout_s: float) -> dict:
        host, _, port = addr.rpartition(":")
        with socket.create_connection((host, int(port)),
                                      timeout=timeout_s) as s:
            s.settimeout(timeout_s)
            send_frame(s, payload)
            return recv_frame(s)

    def _forward(self, payload: dict, timeout_s: float) -> dict:
        """Place + send with bounded re-route.  Idempotent-by-contract:
        the serving ops are pure functions of their payload, so a
        request whose replica died mid-batch is safe to replay on a
        survivor."""
        delays = self._retry.schedule("router.forward")
        deadline = time.monotonic() + (self._retry.deadline_s
                                       or self.request_timeout_s)
        tried: List[str] = []
        last_err: Optional[str] = None
        # when this request's first attempt failed: a re-routed success
        # observes the failover histogram from here
        t_failed: Optional[float] = None
        for attempt in range(self._retry.max_attempts):
            # a replica that failed THIS request is excluded for one
            # lap; after every replica failed once, start a clean lap
            # (the prober may have revived one meanwhile)
            exclude = tried if len(tried) < len(self._reps) else ()
            if len(tried) >= len(self._reps):
                tried = []
            addr = self._place(exclude=exclude)
            if addr is None:
                last_err = "no placeable replica"
                _monitor.FLEET_REROUTE_CTR.inc(1, reason="circuit")
            else:
                try:
                    _resil.maybe_inject("router.forward")
                    resp = self._call(addr, payload, timeout_s)
                    self._note_reply(addr, resp)
                    if resp.get("ok"):
                        if t_failed is not None:
                            _monitor.FLEET_FAILOVER_HIST.observe(
                                (time.monotonic() - t_failed) * 1e3)
                        return resp
                    err = resp.get("error")
                    if err == "draining":
                        # SIGTERM'd replica: its drain finishes its own
                        # in-flight work; THIS request re-routes
                        self._mark_draining(addr)
                        tried.append(addr)
                        _monitor.FLEET_REROUTE_CTR.inc(1, reason="drain")
                        last_err = f"{addr} draining"
                    elif err == "admission":
                        # a final per-replica verdict — not transport
                        # failure; surface it (router quota is the
                        # fleet-wide gate, this is replica-local)
                        raise AdmissionError(resp.get("detail", err))
                    else:
                        tried.append(addr)
                        _monitor.FLEET_REROUTE_CTR.inc(1, reason="error")
                        last_err = f"{addr}: {err}: " \
                                   f"{resp.get('detail', '')}"
                except (OSError, ConnectionError, ValueError,
                        _resil.InjectedFault) as e:
                    self._mark_dead(addr)
                    tried.append(addr)
                    _monitor.FLEET_REROUTE_CTR.inc(1, reason="dead")
                    last_err = f"{addr}: {e!r}"
            if t_failed is None:
                t_failed = time.monotonic()
            if attempt < self._retry.max_attempts - 1:
                delay = delays[attempt]
                if time.monotonic() + delay > deadline:
                    break
                time.sleep(delay)
        raise FleetError(
            f"fleet request failed after {len(tried) or 1} replica "
            f"attempt(s): {last_err}")

    # -- client surface ------------------------------------------------------
    def _admit(self, tenant: str) -> None:
        with self._mu:
            shedding = self._shedding
        if shedding:
            # the autoscaler's arbitration verdict: cheap, immediate
            # backpressure instead of queueing work that will miss its
            # objective while the spawn warms up
            self.tenants.reject(tenant, "slo_shed")
            with self._mu:
                self._stats["rejected"] += 1
            raise AdmissionError(f"tenant {tenant!r} rejected (slo_shed)")
        if not self.tenants.try_admit(tenant):
            self.tenants.reject(tenant, "quota")
            with self._mu:
                self._stats["rejected"] += 1
            raise AdmissionError(f"tenant {tenant!r} rejected (quota)")
        with self._mu:
            self._stats["admitted"] += 1

    def _finish(self, tenant: str, t0: float, err=None) -> None:
        latency_ms = (time.perf_counter() - t0) * 1e3
        if err is None:
            self.tenants.complete(tenant, latency_ms)
            with self._mu:
                self._stats["completed"] += 1
        else:
            self.tenants.fail(tenant)
            with self._mu:
                self._stats["failed"] += 1
        if self.slo is not None:
            # fleet-level burn signal: every ADMITTED request's e2e
            # outcome (shed/quota rejections never reach here — they
            # must not feed the breach that caused them)
            self.slo.record(tenant, err is None, latency_ms)

    def infer(self, tenant: str, feeds: Dict[str, Any],
              seq_len: Optional[int] = None,
              timeout_s: Optional[float] = None) -> List[Any]:
        """Run one inference request on the fleet; returns the output
        list (nested Python lists, one per fetch)."""
        t0 = time.perf_counter()
        self._admit(tenant)
        payload = {"op": "infer", "tenant": tenant, "seq_len": seq_len,
                   "feeds": {k: {"data": np.asarray(v).tolist(),
                                 "dtype": str(np.asarray(v).dtype)}
                             for k, v in feeds.items()}}
        try:
            resp = self._forward(payload,
                                 timeout_s or self.request_timeout_s)
        except BaseException as e:
            self._finish(tenant, t0, err=e)
            raise
        self._finish(tenant, t0)
        return resp.get("outputs", [])

    def decode(self, tenant: str, prompt: Sequence[int],
               max_new_tokens: int = 16, eos_id: Optional[int] = None,
               timeout_s: Optional[float] = None) -> List[int]:
        """Run one decode request on the fleet; returns the token ids."""
        t0 = time.perf_counter()
        self._admit(tenant)
        payload = {"op": "decode", "tenant": tenant,
                   "prompt": [int(t) for t in prompt],
                   "max_new_tokens": int(max_new_tokens),
                   "eos_id": eos_id}
        try:
            resp = self._forward(payload,
                                 timeout_s or self.request_timeout_s)
        except BaseException as e:
            self._finish(tenant, t0, err=e)
            raise
        self._finish(tenant, t0)
        return resp.get("tokens", [])

    # -- prober --------------------------------------------------------------
    def _probe_loop(self) -> None:
        """Background freshness plane: knock on every replica (status
        op) every ttl/3 so an idle fleet stays fresh, a drained replica
        that finished restarting rejoins, and a dead one is probed for
        recovery without waiting for live traffic to find it."""
        interval = max(self.digest_ttl_s / 3.0, 0.05)
        while not self._stop.wait(interval):
            with self._mu:
                addrs = list(self._reps.keys())
            for addr in addrs:
                if self._stop.is_set():
                    return
                try:
                    resp = self._call(addr, {"op": "status"},
                                      timeout_s=min(interval, 2.0))
                    self._note_reply(addr, resp)
                except (OSError, ConnectionError, ValueError):
                    with self._mu:
                        rep = self._reps.get(addr)
                        if rep is not None and rep["state"] != "dead":
                            # no reroute counter here: nothing was
                            # in flight — the probe just downgrades
                            # the table
                            self._set_state_locked(
                                addr,
                                "stale" if rep["state"] == "up"
                                else rep["state"])
