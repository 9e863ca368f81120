"""Socket-based gang coordination: the liveness plane and elastic rank
recovery (the port of ``paddle_tpu/distributed/coordinator.py``).

The file-based :class:`~paddle_tpu_torch.distributed.env.GangRendezvous`
makes gang checkpoint commits crash-safe, but it needs a shared
filesystem, cannot tell a slow rank from a dead one, and gives the
surviving ranks no signal when a peer is SIGKILLed.  This module is the
live half of the coordination plane, after the Fluid fleet/PS endpoint
design (a rank-0 endpoint and heartbeats, not a shared directory):

- :class:`GangCoordinator`: a TCP server (stdlib sockets only, hosted by
  the launcher or a rank-0 side thread) holding the gang's state: the
  per-rank heartbeat tables, the committed-step manifest, step barriers,
  comm gates and the collective-fingerprint registry.
- :class:`GangClient`: one a rank.  A background thread heartbeats
  ``(rank, committed steps, current step, collective fingerprint,
  metrics digest)`` every ``FLAGS_gang_heartbeat_interval_s``; the same
  object speaks the whole ``GangRendezvous`` protocol (``announce`` /
  ``commit_latest`` / ``wait_commit`` / ``committed_step`` /
  ``wait_manifest``) over the socket, so ``CheckpointDaemon``,
  ``PreemptionGuard`` and ``resume_or_init`` run unchanged on either
  backend.

Wire protocol
-------------
Length-prefixed JSON frames: a 4-byte big-endian unsigned length, then
that many bytes of UTF-8 JSON with sorted keys (one object a frame, 16 MiB
cap), byte for byte the reference's, so a port client drives a reference
coordinator and back.  Every request carries ``op`` and (usually)
``rank``; every response carries ``ok``.  Cheap ops ride one persistent
connection per client (serialized by a lock); blocking ops
(``wait_commit``, ``wait_ready``, ``step_barrier``, ``wait_manifest``,
``comm_gate``) each open a one-shot connection, so a parked rank's
heartbeats and announcements never queue behind them.  The serving fleet
(``serving/fleet.py``) speaks the same frames.

Liveness
--------
A rank missing heartbeats for ``FLAGS_gang_heartbeat_timeout_s`` is
declared dead: the gang turns ``degraded``, every barrier waiter wakes
with a ``degraded`` refusal instead of hanging inside a collective, and
every heartbeat response names the dead ranks.  Survivors see
``client.degraded``, drain their in-flight steps and park in
``client.wait_ready()``.  When the launcher (``--max_restarts``) respawns
the rank, its ``hello`` re-admits it and the parked survivors resume.
The gang never commits a step past the last all-rank-durable one, so the
rejoining rank's ``resume_or_init`` lands where the survivors' trajectory
is still consistent with it.

Fingerprints
------------
The verifier's collective fingerprint rides every heartbeat and every
``step_barrier`` arrival.  Two ranks that disagree get an immediate
:class:`GangFingerprintError` naming both ranks and both fingerprints:
the barrier is refused for everyone, and the heartbeat check latches the
mismatch into ``client.check()``.

The coordinator keeps the gang's state in memory (the launcher outlives
every rank).  ``manifest_dir`` also persists the ``COMMITTED`` manifest
through the file backend's fsync'd atomic file, so a full job restart
still refuses torn saves.

High availability
-----------------
A coordinator made with ``standby_of="host:port"`` is a warm standby: it
serves read-only ops and mirrors the primary's replicated log
(``repl_sync`` frames: hello, announce, publish, goodbye).  When the
primary stays silent past ``heartbeat_timeout_s`` it promotes itself: it
bumps the leadership ``epoch``, reloads the shared ``MANIFEST`` (lag must
never regress the durable record), grants every mirrored rank a fresh
heartbeat grace and starts the liveness scan.  Epoch fencing: every frame
carries the epoch (a coordinator that sees a newer one is a zombie and
refuses with ``fenced``), and the manifest mirror writes through an
``EPOCH`` file in ``manifest_dir``, so a zombie primary's write is
dropped.  Clients take a comma-separated ``PADDLE_GANG_COORD`` and re-dial
on a bounded, backed-off schedule that rotates addresses on transport
errors and on ``standby`` / ``fenced`` refusals.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

from .. import monitor as _monitor
from .env import Env, format_manifest, parse_manifest, _atomic_write

__all__ = [
    "GangCoordinator", "GangClient", "GangDegradedError",
    "GangFingerprintError", "send_frame", "recv_frame",
]

#: one JSON frame may not exceed this (a gang control message is tiny;
#: anything bigger is a protocol error, not a bigger buffer)
MAX_FRAME_BYTES = 16 << 20


class GangDegradedError(RuntimeError):
    """A gang operation was refused because a rank is dead (missed
    ``FLAGS_gang_heartbeat_timeout_s`` of heartbeats).  Survivors should
    drain and park in ``wait_ready()`` until the launcher respawns the
    rank — not retry the refused collective."""

    def __init__(self, msg: str, dead=()):
        super().__init__(msg)
        self.dead = sorted(int(r) for r in dead)


class GangFingerprintError(RuntimeError):
    """Two ranks entered the gang with different collective fingerprints
    (the verifier's signature over the dependency-ordered collective
    sequence + fetch list).  Without this check the mismatch manifests as
    a cross-rank hang inside the first unpaired collective; with it, the
    step barrier fails immediately, naming both ranks."""


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def send_frame(sock: socket.socket, obj: Any) -> None:
    """Serialize ``obj`` as one length-prefixed JSON frame."""
    body = json.dumps(obj, sort_keys=True).encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise ValueError(
            f"gang frame of {len(body)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte cap")
    sock.sendall(struct.pack(">I", len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("gang peer closed the connection")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Any:
    """Read one length-prefixed JSON frame (raises ``ConnectionError`` on
    a closed peer, ``ValueError`` on an oversized or malformed frame)."""
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    if n > MAX_FRAME_BYTES:
        raise ValueError(
            f"gang frame announces {n} bytes, over the "
            f"{MAX_FRAME_BYTES}-byte cap (corrupt stream?)")
    return json.loads(_recv_exact(sock, n).decode("utf-8"))


# ---------------------------------------------------------------------------
# coordinator (server)
# ---------------------------------------------------------------------------

class GangCoordinator:
    """Rank-0 gang coordinator: heartbeat tables + manifest + barriers.

    Hosted by the launcher (which survives any rank's death — the natural
    place for elastic recovery) or embedded in a rank-0 side thread.  All
    state lives under one condition variable; blocking requests wait on
    it, so a rank death or a barrier release wakes every waiter at once.
    """

    #: how many replicated-log entries the primary retains — a standby
    #: further behind than this gets a full snapshot instead (repl_sync)
    REPL_LOG_KEEP = 512

    #: ops a STANDBY serves (read-only + the replication pull itself);
    #: everything else is refused with ``standby`` so clients rotate to
    #: the primary instead of split-braining state onto the mirror
    _STANDBY_OPS = ("status", "manifest", "repl_sync")

    def __init__(self, world_size: int, host: str = "127.0.0.1",
                 port: int = 0,
                 heartbeat_timeout_s: Optional[float] = None,
                 manifest_dir: Optional[str] = None,
                 standby_of: Optional[str] = None):
        from ..flags import get_flags
        if heartbeat_timeout_s is None:
            heartbeat_timeout_s = float(
                get_flags("FLAGS_gang_heartbeat_timeout_s")
                ["FLAGS_gang_heartbeat_timeout_s"])
        self.world_size = int(world_size)
        self.host = host
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.manifest_dir = manifest_dir
        #: the primary this coordinator mirrors ("host:port"), None for
        #: a primary.  Fixed at construction; the live role is _role.
        self.standby_of = standby_of
        self._requested_port = int(port)
        #: the actually-bound port, set by start() (an ephemeral request
        #: gets a fresh port on every (re)start)
        self.port: Optional[int] = None
        self._cv = threading.Condition(threading.Lock())
        self._ranks: Dict[int, dict] = {}       # guarded-by: _cv
        self._manifest: Optional[int] = None    # guarded-by: _cv
        self._barriers: Dict[int, dict] = {}    # guarded-by: _cv
        self._comm_gates: Dict[int, dict] = {}  # guarded-by: _cv
        #: leadership role + epoch fence (HA): the epoch bumps on every
        #: standby promotion and rides every request/response; the
        #: manifest mirror writes through the EPOCH file against it
        self._role = "standby" if standby_of else "primary"  # guarded-by: _cv
        self._epoch = 0                         # guarded-by: _cv
        #: replicated log of durable events (hello role/endpoint,
        #: announce, manifest publish, goodbye) the standby replays;
        #: _log_base is the seq of _log[0] after pruning
        self._log: List[dict] = []              # guarded-by: _cv
        self._log_seq = 0                       # guarded-by: _cv
        self._log_base = 0                      # guarded-by: _cv
        #: optional scrape surface (FLAGS_coordinator_metrics_port /
        #: start_metrics_http) — stopped with the coordinator
        self._metrics_http = None
        self._mismatch: Optional[dict] = None   # guarded-by: _cv
        #: pluggable status sections (attach_status_section): name ->
        #: zero-arg callable whose snapshot rides status_snapshot() —
        #: how the fleet autoscaler's TGT/SIZE view reaches gangtop
        self._status_sections: Dict[str, Any] = {}  # guarded-by: _cv
        self._stopping = False                  # guarded-by: _cv
        self._conns: List[socket.socket] = []   # guarded-by: _cv
        self._mirror_mu = threading.Lock()      # manifest-file writes
        self._lsock: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        if manifest_dir:
            self._manifest = self._load_manifest(manifest_dir)

    @staticmethod
    def _load_manifest(manifest_dir: str) -> Optional[int]:
        try:
            with open(os.path.join(manifest_dir, "MANIFEST")) as f:
                return parse_manifest(f.read())
        except (OSError, ValueError):
            return None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "GangCoordinator":
        if self._lsock is not None:
            return self
        with self._cv:
            self._stopping = False      # restartable after stop()
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self._requested_port))
        s.listen(128)
        self._lsock = s
        self.port = s.getsockname()[1]
        with self._cv:
            standby = self._role == "standby"
        # a standby runs the mirror loop INSTEAD of the liveness scan
        # (it must not declare anyone dead off tables it only mirrors);
        # promotion starts the liveness thread when it takes over
        loops = ((self._accept_loop, "pt-gang-accept"),
                 (self._mirror_loop, "pt-gang-mirror") if standby
                 else (self._liveness_loop, "pt-gang-liveness"))
        for target, name in loops:
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        return self

    @property
    def address(self) -> str:
        if self.port is None:
            raise RuntimeError("coordinator not started")
        return f"{self.host}:{self.port}"

    def stop(self) -> None:
        http, self._metrics_http = self._metrics_http, None
        if http is not None:
            try:
                http.stop()
            except Exception:
                pass
        with self._cv:
            self._stopping = True
            conns, self._conns = self._conns, []
            self._cv.notify_all()
        if self._lsock is not None:
            # close() alone does NOT wake a thread blocked in accept():
            # the in-flight syscall keeps the LISTEN socket alive in the
            # kernel, which keeps completing handshakes nobody serves —
            # a "stopped" coordinator that still looks connectable hangs
            # dialing clients until timeout instead of refusing fast
            # (the failover ladder in GangClient depends on the refusal)
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
                return                     # listener closed: shutting down
            with self._cv:
                if self._stopping:
                    conn.close()
                    return
                self._conns.append(conn)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True, name="pt-gang-conn")
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        from .. import resilience as _resil
        try:
            while True:
                req = recv_frame(conn)
                # chaos site: an injected fault here drops the
                # connection mid-exchange (the client sent a frame and
                # never gets its response — the torn-frame drill); hang
                # mode wedges this one conn's service thread
                _resil.maybe_inject("coordinator.frame")
                try:
                    resp = self._fenced_handle(req)
                except Exception as e:   # a bad request must not kill the
                    resp = {"ok": False,  # coordinator
                            "error": "internal",
                            "detail": repr(e)[:300]}
                # every response carries the leadership epoch + role so
                # clients track the newest leader and fence zombies
                with self._cv:
                    resp.setdefault("epoch", self._epoch)
                    resp.setdefault("role", self._role)
                send_frame(conn, resp)
        except (ConnectionError, OSError, ValueError,
                _resil.InjectedFault):
            pass                           # client went away / bad frame
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._cv:
                if conn in self._conns:
                    self._conns.remove(conn)

    # -- state helpers (all hold _cv; the `# guarded-by-caller: _cv`
    # annotations make the lint VERIFY that every same-module call site
    # actually holds it, instead of per-line lint-ok suppressions) -----------
    def _entry_locked(self, rank: int) -> dict:  # guarded-by-caller: _cv
        e = self._ranks.get(rank)
        if e is None:
            # 'step'/'steps' are the DURABLE record — written only by
            # announce (after the rank's checkpoint is fsync-durable),
            # read by commit_latest/wait_commit/peers.  'cur_step' is
            # heartbeat-borne training progress, observability only: a
            # manifest must never commit on the strength of a heartbeat
            # (the step a rank is TRAINING is exactly the step it has
            # not durably saved).
            e = {"alive": True, "finished": False,
                 "last_hb": time.monotonic(),
                 "step": None, "steps": [], "cur_step": None,
                 "hb_steps": [], "fingerprint": None,
                 # latest heartbeat metrics digest (step-time estimate, MFU,
                 # queue, in-flight; byte-capped) — observability only,
                 # like cur_step: never feeds commit decisions
                 "digest": None,
                 "pid": None, "deaths": 0, "joins": 0,
                 # fleet role ("trainer"/"replica"/"router", from hello)
                 # + the serving endpoint a replica registered — the
                 # router's discovery surface, replicated to the standby
                 "role": "trainer", "endpoint": None,
                 # server-side barrier sequence: the k-th step_barrier
                 # arrival of every rank pairs with the k-th of its
                 # peers (see _op_step_barrier)
                 "bseq": 0,
                 # server-side comm-gate sequence (the pre-collective
                 # timestamp exchange pairs the same way)
                 "cseq": 0}
            self._ranks[rank] = e
        return e

    def _touch_locked(self, rank: int, pid: Optional[int] = None,
                      hello: bool = False) -> dict:  # guarded-by-caller: _cv
        """A frame from a live rank refreshes its liveness; a frame from
        a rank previously declared dead is a REJOIN (the elastic path).
        A rank that said goodbye is DEPARTED: only an explicit ``hello``
        (a respawn introducing itself) re-admits it — its trailing
        frames (a final announce, a heartbeat racing the goodbye) must
        not resurrect it into a death sentence at process exit."""
        e = self._entry_locked(rank)
        if e["finished"] and not hello:
            return e
        rejoined = not e["alive"] and not e["finished"]
        e["alive"] = True
        e["finished"] = False
        e["last_hb"] = time.monotonic()
        if pid is not None:
            e["pid"] = int(pid)
        if rejoined:
            # the respawn prunes torn steps before it re-announces, so
            # the pre-death durable record may overstate what is on
            # disk NOW — a manifest committed from it could name a
            # pruned step.  Clear it; the rank re-announces its real
            # post-prune holdings from _resume_gang.
            e["step"] = None
            e["steps"] = []
            e["digest"] = None     # pre-death metrics are stale too
            e["joins"] += 1
            # barrier resync: the respawn's executor restarts its local
            # barrier count while survivors kept counting — reset EVERY
            # rank's server-side sequence (and drop stale barriers) so
            # post-rejoin arrivals pair from zero on both sides.  Safe:
            # any pre-death waiter was already refused with `degraded`
            # (survivors drain and park, they never sit in a barrier
            # across a rejoin).
            for other in self._ranks.values():
                other["bseq"] = 0
                other["cseq"] = 0
            self._barriers.clear()
            self._comm_gates.clear()
            _monitor.GANG_REJOIN_CTR.inc()
            if _monitor.TRACER.enabled:
                _monitor.TRACER.instant(
                    "gang.rejoin", "gang", {"rank": int(rank)})
            if not self._dead_locked():
                _monitor.GANG_DEGRADED_GAUGE.set(0)
            self._cv.notify_all()
        return e

    def _dead_locked(self) -> List[int]:
        """Ranks that went silent WITHOUT an orderly goodbye — a rank
        that finished its work and said goodbye is done, not dead (its
        peers must keep training, not park for a respawn that will
        never come)."""
        return sorted(r for r, e in self._ranks.items()
                      if not e["alive"] and not e["finished"])

    def _status_locked(self) -> str:
        if self._dead_locked():
            return "degraded"
        present = sum(1 for e in self._ranks.values()
                      if e["alive"] or e["finished"])
        return "ok" if present >= self.world_size else "forming"

    def _publish_locked(self, step: int) -> None:  # guarded-by-caller: _cv
        """In-memory commit + waiter wakeup.  The durable file mirror is
        the CALLER's job after releasing ``_cv`` (:meth:`_mirror_manifest`)
        — an fsync inside the one coordinator lock would stall every
        heartbeat, announce, and the liveness scan behind disk I/O."""
        self._manifest = int(step)
        self._log_locked({"ev": "manifest", "step": int(step)})
        self._cv.notify_all()

    def _log_locked(self, entry: dict) -> None:  # guarded-by-caller: _cv
        """Append a durable event to the replicated log (bounded; a
        standby further behind than the retained window re-syncs from a
        full snapshot instead)."""
        self._log.append(dict(entry, seq=self._log_seq))
        self._log_seq += 1
        overflow = len(self._log) - self.REPL_LOG_KEEP
        if overflow > 0:
            del self._log[:overflow]
            self._log_base += overflow

    def _mirror_manifest(self) -> None:
        """Persist the CURRENT manifest to ``manifest_dir`` (same
        fsync'd-atomic file the file backend writes).  Called outside
        the lock; re-reads the step under it, so a racing later publish
        just makes this write the newer step."""
        if not self.manifest_dir:
            return
        with self._cv:
            step = self._manifest
        if step is None:
            return
        # serialize mirror writes: _atomic_write stages to a PER-PROCESS
        # temp name, and two serve threads mirroring concurrently (e.g.
        # a zombie wait_commit waiter racing a fresh commit_latest)
        # would truncate each other's staging file mid-fsync
        with self._cv:
            epoch = self._epoch
        with self._mirror_mu:
            os.makedirs(self.manifest_dir, exist_ok=True)
            # epoch fencing folded into the manifest write path: the
            # EPOCH file is the durable fence token.  A zombie primary
            # (SIGKILL-survivor scheduling delay, partitioned host)
            # reaching this point AFTER a standby promoted observes the
            # newer fence and DROPS its write — the manifest can never
            # be torn backward by a stale leader.
            epath = os.path.join(self.manifest_dir, "EPOCH")
            try:
                with open(epath) as f:
                    fence = int(f.read().strip() or 0)
            except (OSError, ValueError):
                fence = 0
            if fence > epoch:
                _monitor.COORD_FENCED_CTR.inc(1, path="manifest")
                if _monitor.TRACER.enabled:
                    _monitor.TRACER.instant(
                        "gang.manifest_fenced", "gang",
                        {"epoch": epoch, "fence": fence})
                return
            if epoch > fence:
                _atomic_write(epath, f"{epoch}\n")
            _atomic_write(os.path.join(self.manifest_dir, "MANIFEST"),
                          format_manifest(step, self.world_size))

    @staticmethod
    def _gspmd_rules_of(fingerprint) -> Optional[str]:
        """GSPMD rule-table name from a fingerprint's ``#rules=<table>``
        suffix (the verifier's partition fold stamps it) — None for
        unpartitioned programs.  Surfaced per-rank in the status payload
        so gangtop shows a mixed-table gang BEFORE the step-barrier
        refusal fires."""
        f = str(fingerprint) if fingerprint is not None else ""
        return f.split("#rules=", 1)[1] if "#rules=" in f else None

    @staticmethod
    def _find_mismatch(named, where: str) -> Optional[dict]:
        """First disagreeing (rank, fingerprint) pair in a sorted list
        of non-None fingerprints, as a diagnostic record naming both
        ranks — None when all agree.  Shared by the passive heartbeat
        check and the step-barrier refusal; counts the mismatch."""
        if len({f for _, f in named}) <= 1:
            return None
        (r1, f1) = named[0]
        (r2, f2) = next((r, f) for r, f in named[1:] if f != f1)
        detail = (f"collective fingerprint mismatch{where}: "
                  f"rank {r1} reports {f1!r} but rank {r2} "
                  f"reports {f2!r} — divergent programs would "
                  "deadlock inside the first unpaired collective")
        # GSPMD-partitioned fingerprints carry a "#rules=<table>" suffix
        # (verifier partition fold): when both sides have one, name the
        # rule tables outright — "mp_hidden vs replicated" is actionable
        # in a way two hex digests are not
        t1, t2 = (f.split("#rules=", 1)[1] if "#rules=" in str(f) else None
                  for f in (f1, f2))
        if t1 is not None and t2 is not None and t1 != t2:
            detail += (f" (divergent GSPMD rule tables: rank {r1} "
                       f"chose {t1!r}, rank {r2} chose {t2!r})")
        elif t1 is not None and t2 is not None:
            # same rule-table NAME but still divergent: compare the
            # "#resh=<edges>x<sha8>" reshard-plan tokens (the sharding
            # analysis's traffic multiset) — two ranks running the same
            # table over different programs are named by PLAN, so the
            # operator sees "24x1a2b3c4d vs 30x5e6f7a8b" instead of two
            # opaque digests
            p1, p2 = (f.split("#resh=", 1)[1].split("#", 1)[0]
                      if "#resh=" in str(f) else None for f in (f1, f2))
            if p1 is not None and p2 is not None and p1 != p2:
                detail += (f" (same rule table {t1!r} but divergent "
                           f"GSPMD reshard plans: rank {r1} plans "
                           f"{p1}, rank {r2} plans {p2} — the programs "
                           "move different collective traffic)")
        mm = {"ranks": [int(r1), int(r2)],
              "fingerprints": [f1, f2],
              "detail": detail}
        _monitor.GANG_FP_CTR.inc()
        if _monitor.TRACER.enabled:
            _monitor.TRACER.instant("gang.fingerprint_mismatch", "gang",
                                    dict(mm))
        return mm

    def _check_fingerprints_locked(self) -> None:  # guarded-by-caller: _cv
        """Passive cross-rank fingerprint exchange: latch the first pair
        of live ranks whose heartbeat fingerprints disagree.  The barrier
        path enforces; this path makes the mismatch visible in every
        heartbeat response (``client.check()``)."""
        named = sorted((r, e["fingerprint"])
                       for r, e in self._ranks.items()
                       if e["alive"] and e["fingerprint"] is not None)
        if len({f for _, f in named}) <= 1:
            self._mismatch = None
            return
        if self._mismatch is not None:
            return
        self._mismatch = self._find_mismatch(named, "")
        self._cv.notify_all()

    def _gang_view_locked(self) -> dict:
        return {"status": self._status_locked(),
                "dead": self._dead_locked(),
                "manifest": self._manifest,
                "mismatch": self._mismatch}

    # -- liveness scan -------------------------------------------------------
    def _liveness_loop(self) -> None:
        poll = max(min(self.heartbeat_timeout_s / 4.0, 0.5), 0.02)
        while True:
            newly_dead: List[int] = []
            with self._cv:
                if self._stopping:
                    return
                now = time.monotonic()
                for r, e in self._ranks.items():
                    if e["alive"] and not e["finished"] and \
                            now - e["last_hb"] > self.heartbeat_timeout_s:
                        e["alive"] = False
                        e["deaths"] += 1
                        newly_dead.append(r)
                if newly_dead:
                    # wake barrier/ready waiters: survivors must get the
                    # degraded refusal NOW, not at their next timeout
                    self._cv.notify_all()
                self._cv.wait(timeout=poll)
            for r in newly_dead:
                _monitor.GANG_DEATH_CTR.inc()
                _monitor.GANG_DEGRADED_GAUGE.set(1)
                # a dead rank's digest series retire (counter totals
                # fold to rank="retired", gauges drop as the serving tenants' do);
                # the aggregate skew/straggler gauges recompute over the
                # survivors only
                _monitor.retire_gang_rank_series(r)
                if _monitor.TRACER.enabled:
                    _monitor.TRACER.instant(
                        "gang.rank_dead", "gang",
                        {"rank": int(r),
                         "timeout_s": self.heartbeat_timeout_s})
            if newly_dead:
                self._refresh_gang_gauges()

    # -- standby mirror / promotion ------------------------------------------
    def _mirror_loop(self) -> None:
        """Standby-side replication: poll the primary's ``repl_sync`` op
        over a one-shot connection, absorb the snapshot/entry stream,
        and promote when the primary stays silent past the heartbeat
        timeout (the same staleness budget ranks get)."""
        poll = max(min(self.heartbeat_timeout_s / 4.0, 0.5), 0.05)
        since = 0
        peer_epoch = 0
        last_ok = time.monotonic()
        host, _, port = str(self.standby_of).rpartition(":")
        while True:
            with self._cv:
                if self._stopping or self._role != "standby":
                    return
            try:
                with socket.create_connection((host, int(port)),
                                              timeout=poll * 2) as s:
                    send_frame(s, {"op": "repl_sync", "since": since})
                    resp = recv_frame(s)
                if isinstance(resp, dict) and resp.get("ok"):
                    since = self._absorb_repl(resp)
                    pe = resp.get("epoch")
                    if isinstance(pe, int) and not isinstance(pe, bool):
                        peer_epoch = max(peer_epoch, pe)
                    last_ok = time.monotonic()
            except (OSError, ConnectionError, ValueError):
                pass                       # primary unreachable this round
            if time.monotonic() - last_ok > self.heartbeat_timeout_s:
                self._promote(peer_epoch)
                return
            with self._cv:
                if self._stopping:
                    return
                self._cv.wait(timeout=poll)

    def _absorb_repl(self, resp: dict) -> int:
        """Fold a ``repl_sync`` response into the local tables; returns
        the next log cursor.  Snapshot responses rebuild the rank table
        wholesale; entry responses replay the durable event stream."""
        with self._cv:
            snap = resp.get("snapshot")
            if isinstance(snap, dict):
                mf = snap.get("manifest")
                if mf is not None:
                    self._manifest = (mf if self._manifest is None
                                      else max(self._manifest, int(mf)))
                for r, d in (snap.get("ranks") or {}).items():
                    e = self._entry_locked(int(r))
                    e["step"] = d.get("step")
                    e["steps"] = list(d.get("steps") or [])
                    e["role"] = d.get("role") or e["role"]
                    e["endpoint"] = d.get("endpoint")
                    e["pid"] = d.get("pid")
            for entry in resp.get("entries") or ():
                if isinstance(entry, dict):
                    self._apply_repl_locked(entry)
            return int(resp.get("next") or 0)

    def _apply_repl_locked(self, entry: dict) -> None:  # guarded-by-caller: _cv
        ev = entry.get("ev")
        if ev == "hello":
            e = self._entry_locked(int(entry["rank"]))
            e["pid"] = entry.get("pid")
            e["role"] = entry.get("role") or e["role"]
            e["endpoint"] = entry.get("endpoint")
        elif ev == "announce":
            e = self._entry_locked(int(entry["rank"]))
            e["step"] = entry.get("step")
            e["steps"] = list(entry.get("steps") or [])
        elif ev == "manifest":
            step = int(entry["step"])
            self._manifest = (step if self._manifest is None
                              else max(self._manifest, step))
        elif ev == "goodbye":
            e = self._entry_locked(int(entry["rank"]))
            e["alive"] = False
            e["finished"] = True

    def _promote(self, peer_epoch: int) -> None:
        """Standby → primary takeover.  Epoch-fenced: the new epoch
        strictly exceeds anything the old primary could have stamped, so
        a zombie survivor is refused at both the frame layer (clients
        carry the newer epoch) and the manifest write path (EPOCH file).
        Ranks get a fresh heartbeat grace window — the standby only
        mirrored their liveness, it never measured it."""
        t0 = time.monotonic()
        with self._cv:
            if self._stopping or self._role != "standby":
                return
            self._role = "primary"
            self._epoch = max(self._epoch, int(peer_epoch)) + 1
            epoch = self._epoch
            now = time.monotonic()
            for e in self._ranks.values():
                e["last_hb"] = now
                if not e["finished"]:
                    e["alive"] = True
            self._cv.notify_all()
        # durable catch-up: both coordinators share manifest_dir, and the
        # replication stream may lag the primary's last fsync — the
        # on-disk record must never regress across a failover
        if self.manifest_dir:
            disk = self._load_manifest(self.manifest_dir)
            if disk is not None:
                with self._cv:
                    self._manifest = (disk if self._manifest is None
                                      else max(self._manifest, disk))
        _monitor.COORD_FAILOVER_CTR.inc()
        _monitor.COORD_EPOCH_GAUGE.set(epoch)
        if _monitor.TRACER.enabled:
            _monitor.TRACER.instant("gang.coord_failover", "gang",
                                    {"epoch": epoch})
        self._mirror_manifest()            # stamps the EPOCH fence token
        t = threading.Thread(target=self._liveness_loop, daemon=True,
                             name="pt-gang-liveness")
        t.start()
        self._threads.append(t)
        _monitor.FLEET_FAILOVER_HIST.observe(
            (time.monotonic() - t0) * 1e3)

    def _op_repl_sync(self, req: dict) -> dict:
        since = int(req.get("since", 0))
        with self._cv:
            if since < self._log_base:
                # cursor fell off the bounded log — full snapshot resync
                ranks = {str(r): {"step": e["step"],
                                  "steps": list(e["steps"]),
                                  "role": e["role"],
                                  "endpoint": e["endpoint"],
                                  "pid": e["pid"]}
                         for r, e in self._ranks.items()}
                return {"ok": True, "next": self._log_seq,
                        "snapshot": {"manifest": self._manifest,
                                     "ranks": ranks}}
            return {"ok": True, "next": self._log_seq,
                    "entries": list(self._log[since - self._log_base:])}

    # -- request dispatch ----------------------------------------------------
    def _fenced_handle(self, req: dict) -> dict:
        """Epoch fence + standby gate in front of the op table.  A
        request carrying a NEWER epoch than ours proves a newer leader
        exists — this coordinator is a zombie and must refuse (the
        client rotates to the real primary); a standby refuses every
        state-mutating op the same way."""
        op = req.get("op")
        peer_epoch = req.get("epoch")
        with self._cv:
            epoch, role = self._epoch, self._role
        if isinstance(peer_epoch, int) and not isinstance(peer_epoch, bool) \
                and peer_epoch > epoch:
            _monitor.COORD_FENCED_CTR.inc(1, path="frame")
            return {"ok": False, "error": "fenced", "epoch": epoch}
        if role == "standby" and op not in self._STANDBY_OPS:
            return {"ok": False, "error": "standby",
                    "primary": self.standby_of, "epoch": epoch}
        return self._handle(req)

    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            return {"ok": False, "error": "unknown_op", "detail": str(op)}
        return fn(req)

    def _op_hello(self, req: dict) -> dict:
        with self._cv:
            e = self._touch_locked(int(req["rank"]), pid=req.get("pid"),
                                   hello=True)
            if e["joins"] == 0:
                e["joins"] = 1
            if req.get("role"):
                e["role"] = str(req["role"])
            if req.get("endpoint"):
                e["endpoint"] = str(req["endpoint"])
            self._log_locked({"ev": "hello", "rank": int(req["rank"]),
                              "pid": e["pid"], "role": e["role"],
                              "endpoint": e["endpoint"]})
            return {"ok": True, "world_size": self.world_size,
                    **self._gang_view_locked()}

    def _op_heartbeat(self, req: dict) -> dict:
        rank = int(req["rank"])
        digest = req.get("digest")
        digest_ok = False
        digest_capped = False
        if isinstance(digest, dict):
            # server-side byte-cap enforcement: an oversized digest is
            # CAPPED with the same priority-ordered key dropping the
            # client applies (counted; the beat itself always refreshes
            # liveness) — refusing the whole digest would blind the
            # skew/straggler/NaN plane to exactly the rank whose client
            # mis-sized its payload
            if len(json.dumps(digest, sort_keys=True)) \
                    > _monitor.DIGEST_MAX_BYTES:
                digest = _monitor.capped_digest(digest) or None
                digest_capped = True
            digest_ok = digest is not None
        else:
            # a beat WITHOUT a digest CLEARS the stored one: a rank
            # whose executor retired (metrics_digest() now empty) must
            # drop out of straggler/skew math, not haunt it with its
            # last reading forever.  Old digest-less clients simply
            # keep the field at its initial None.
            digest = None
        with self._cv:
            e = self._touch_locked(rank)
            # heartbeat progress is observability + fingerprint
            # exchange ONLY — the durable step/steps record is
            # announce's to write (see _entry_locked)
            if req.get("step") is not None:
                e["cur_step"] = int(req["step"])
            if req.get("steps") is not None:
                # observability echo of the rank's committed list (the
                # DURABLE record stays announce-only — see _entry_locked)
                e["hb_steps"] = sorted(int(s) for s in req["steps"])
            if req.get("fingerprint") is not None:
                # never let a fingerprint-less beat (another client in
                # the same process, a rank before its first verify)
                # erase a known fingerprint — that would un-latch a
                # genuine mismatch between beats
                e["fingerprint"] = req["fingerprint"]
            digest_changed = e["digest"] != digest
            e["digest"] = digest
            self._check_fingerprints_locked()
            view = self._gang_view_locked()
        _monitor.GANG_HB_CTR.inc(1, role="coordinator")
        if digest_capped:
            _monitor.GANG_DIGEST_OVERSIZE_CTR.inc()
        if digest_ok:
            self._fold_digest(rank, digest)
        if req.get("step") is not None or digest_changed:
            self._refresh_gang_gauges()
        return {"ok": True, **view}

    #: digest key -> the per-rank gauge family it lands in.  The
    #: serving keys (srv_q/occ/slots/tps) are the per-replica load
    #: signal the fleet router/autoscaler consumes — published here so
    #: the coordinator host's /metrics (or file export) carries the
    #: whole fleet's serving load.
    _DIGEST_GAUGES = {
        "step_ms": _monitor.GANG_RANK_STEP_MS,
        "mfu": _monitor.GANG_RANK_MFU,
        "queue": _monitor.GANG_RANK_QUEUE,
        "inflight": _monitor.GANG_RANK_INFLIGHT,
        "srv_q": _monitor.GANG_RANK_SRVQ,
        "occ": _monitor.GANG_RANK_OCC,
        "slots": _monitor.GANG_RANK_FREE_SLOTS,
        "tps": _monitor.GANG_RANK_TPS,
        # numerics plane: grad-norm + cumulative non-finite count — the
        # "which rank is NaN'ing" columns gangtop renders
        "gnorm": _monitor.GANG_RANK_GNORM,
        "nanf": _monitor.GANG_RANK_NANF,
        # comms plane: per-step measured comm time (wait + wire), its
        # straggler-wait part, and the bus-bandwidth gauge — gangtop's
        # COMM/BW% columns, and comm_wait feeds the net-of-wait
        # straggler selection below
        "comm_ms": _monitor.GANG_RANK_COMM_MS,
        "comm_wait": _monitor.GANG_RANK_COMM_WAIT,
        "comm_bw": _monitor.GANG_RANK_COMM_BW,
        # hbm plane: measured live bytes + headroom (budget - live) —
        # gangtop's HBM/HDRM% columns and OOM-RISK flag, and the
        # fleet-wide headroom surface the GSPMD sharding chooser and an
        # autoscaler consume
        "hbm": _monitor.GANG_RANK_HBM,
        "hdrm": _monitor.GANG_RANK_HDRM,
    }

    def _fold_digest(self, rank: int, digest: dict) -> None:
        """Per-rank digest values → per-rank registry series (exported
        by monitor.export on the coordinator host).  Runs OUTSIDE _cv:
        gauge cells have their own locks, and metric work must never
        stall the liveness scan."""
        _monitor.GANG_DIGEST_CTR.inc(1, rank=str(rank))
        for key, fam in self._DIGEST_GAUGES.items():
            v = digest.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                fam.set(float(v), rank=str(rank))
            else:
                # the key stopped riding the digest (server stopped, or
                # shed under the byte cap): DROP the rank's series — a
                # frozen last value would read as live load to a router
                # doing least-loaded placement on it
                fam.fold({"rank": str(rank)}, None)

    def _aggregates_locked(self) -> dict:  # guarded-by-caller: _cv
        """Gang-level aggregates over the LIVE ranks' heartbeat state —
        the ONE place the selection rules live (gauges, the status
        payload, and therefore gangtop all read this).  Degraded-aware
        by construction: dead and departed ranks drop out of the
        snapshot, so a degraded gang's skew reflects only the
        survivors still training.  A straggler is a COMPARISON — with
        fewer than two live digests there is nobody to be slower than,
        and the skews reset to 0 rather than freeze (a gauge latched
        at its pre-death maximum would keep an alert firing against a
        healthy solo survivor forever)."""
        live = {r: e for r, e in self._ranks.items()
                if e["alive"] and not e["finished"]}
        steps = [e["cur_step"] for e in live.values()
                 if e["cur_step"] is not None]
        step_ms = {r: e["digest"]["step_ms"]
                   for r, e in live.items()
                   if isinstance(e.get("digest"), dict)
                   and isinstance(e["digest"].get("step_ms"),
                                  (int, float))}
        # straggler selection is NET of comm wait (digest 'comm_wait',
        # the comms plane's measured peer-arrival skew): a rank whose
        # step is long because it sat WAITING for a slow peer is the
        # victim, not the straggler — blaming it would point the
        # runbook at exactly the wrong chip
        def _net(r):
            d = live[r].get("digest") or {}
            w = d.get("comm_wait")
            if isinstance(w, (int, float)) and not isinstance(w, bool):
                return max(float(step_ms[r]) - float(w), 0.0)
            return float(step_ms[r])
        agg = {"step_skew": (max(steps) - min(steps)
                             if len(steps) >= 2 else 0),
               "step_time_skew_ms": 0.0,
               "straggler": -1, "straggler_step_ms": 0.0}
        if len(step_ms) >= 2:
            slow = max(step_ms, key=_net)
            agg["straggler"] = int(slow)
            agg["straggler_step_ms"] = float(step_ms[slow])
            agg["straggler_net_ms"] = round(_net(slow), 3)
            agg["step_time_skew_ms"] = \
                max(step_ms.values()) - min(step_ms.values())
        # distinct GSPMD rule tables among live ranks: >1 means the
        # planners diverged and the NEXT step barrier will refuse —
        # surfacing it here makes the condition visible in gangtop /
        # /statusz while the gang is still running
        tables = sorted({t for t in (
            self._gspmd_rules_of(e["fingerprint"]) for e in live.values())
            if t is not None})
        if tables:
            agg["gspmd_rule_tables"] = tables
        return agg

    def _refresh_gang_gauges(self) -> None:
        """Publish the aggregates as registry gauges (exported by
        monitor.export on the coordinator host)."""
        with self._cv:
            agg = self._aggregates_locked()
        _monitor.GANG_STEP_SKEW_GAUGE.set(agg["step_skew"])
        _monitor.GANG_STEP_TIME_SKEW_GAUGE.set(agg["step_time_skew_ms"])
        _monitor.GANG_STRAGGLER_GAUGE.set(agg["straggler"])
        _monitor.GANG_STRAGGLER_MS_GAUGE.set(agg["straggler_step_ms"])

    def _op_announce(self, req: dict) -> dict:
        rank = int(req["rank"])
        with self._cv:
            e = self._touch_locked(rank)
            e["step"] = int(req["step"])
            e["steps"] = sorted(int(s) for s in
                                (req.get("steps") or [req["step"]]))
            self._log_locked({"ev": "announce", "rank": rank,
                              "step": e["step"],
                              "steps": list(e["steps"])})
            # announcements move the wait_commit barrier
            self._cv.notify_all()
        return {"ok": True}

    def _op_goodbye(self, req: dict) -> dict:
        """Orderly departure (clean exit / preemption drain finished):
        the rank stops heartbeating ON PURPOSE.  It is excluded from the
        liveness scan and never degrades the gang — the opposite of a
        SIGKILL, which says nothing and IS a death."""
        with self._cv:
            e = self._entry_locked(int(req["rank"]))
            e["alive"] = False
            e["finished"] = True
            self._log_locked({"ev": "goodbye", "rank": int(req["rank"])})
            if not self._dead_locked():
                # a rank declared dead that then departs cleanly must
                # not leave the degraded gauge latched on a healthy,
                # completed gang (the runbook keys on it)
                _monitor.GANG_DEGRADED_GAUGE.set(0)
            self._cv.notify_all()
        # an orderly departure retires its digest series exactly like a
        # death: the rank is gone either way, and the skew/straggler
        # aggregates must track only the ranks still training
        _monitor.retire_gang_rank_series(int(req["rank"]))
        self._refresh_gang_gauges()
        return {"ok": True}

    def _op_peers(self, req: dict) -> dict:
        with self._cv:
            peers = {int(r): {"step": e["step"], "steps": list(e["steps"])}
                     for r, e in self._ranks.items()
                     if e["step"] is not None}
        return {"ok": True, "peers": {str(r): d for r, d in peers.items()}}

    def _op_manifest(self, req: dict) -> dict:
        with self._cv:
            return {"ok": True, "step": self._manifest}

    def _op_publish(self, req: dict) -> dict:
        if int(req["rank"]) != 0:
            return {"ok": False, "error": "not_leader",
                    "detail": f"rank {req['rank']} tried to publish the "
                              "gang manifest; only rank 0 commits"}
        with self._cv:
            self._publish_locked(int(req["step"]))
        self._mirror_manifest()
        return {"ok": True}

    def _op_commit_latest(self, req: dict) -> dict:
        """Non-blocking steady-state commit: publish the newest step every
        rank has durably announced (dead ranks count with their LAST
        announcement — what they durably hold on disk is exactly what
        they last announced), if it advances the manifest."""
        if int(req["rank"]) != 0:
            return {"ok": True, "published": None}
        published = None
        with self._cv:
            if len([e for e in self._ranks.values() if e["steps"]]) \
                    >= self.world_size:
                common = None
                for e in self._ranks.values():
                    s = set(e["steps"])
                    common = s if common is None else (common & s)
                if common:
                    best = max(common)
                    if self._manifest is None or best > self._manifest:
                        self._publish_locked(best)
                        published = best
        if published is not None:
            self._mirror_manifest()
        return {"ok": True, "published": published}

    def _op_wait_commit(self, req: dict) -> dict:
        """Blocking emergency barrier: wait until every rank's LATEST
        announced step equals ``step``, then publish (strict equality —
        the file backend's contract)."""
        if int(req["rank"]) != 0:
            return {"ok": False, "error": "not_leader",
                    "detail": "wait_commit is leader-only"}
        step = int(req["step"])
        deadline = time.monotonic() + float(req.get("timeout_s", 30.0))
        committed = False
        with self._cv:
            while True:
                anns = [e for e in self._ranks.values()
                        if e["step"] is not None]
                if len(anns) >= self.world_size and \
                        all(e["step"] == step for e in anns):
                    self._publish_locked(step)
                    committed = True
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(timeout=min(left, 0.25))
        if committed:
            self._mirror_manifest()
        return {"ok": True, "committed": committed}

    def _op_wait_manifest(self, req: dict) -> dict:
        step = int(req["step"])
        deadline = time.monotonic() + float(req.get("timeout_s", 30.0))
        with self._cv:
            while True:
                if self._manifest is not None and self._manifest >= step:
                    return {"ok": True, "reached": True}
                left = deadline - time.monotonic()
                if left <= 0:
                    return {"ok": True, "reached": False}
                self._cv.wait(timeout=min(left, 0.25))

    def _op_wait_ready(self, req: dict) -> dict:
        """Park until the whole gang is alive (the elastic rejoin
        barrier) — or report the still-dead ranks at the deadline."""
        deadline = time.monotonic() + float(req.get("timeout_s", 300.0))
        with self._cv:
            while True:
                if self._status_locked() == "ok":
                    return {"ok": True, "ready": True}
                left = deadline - time.monotonic()
                if left <= 0:
                    return {"ok": True, "ready": False,
                            "dead": self._dead_locked()}
                self._cv.wait(timeout=min(left, 0.25))

    def _op_step_barrier(self, req: dict) -> dict:
        """Per-step gang barrier with fingerprint enforcement: released
        only when every rank arrived with the SAME collective
        fingerprint.  A mismatch refuses the barrier for everyone,
        naming both ranks; a dead rank refuses it with ``degraded``
        (survivors park instead of hanging inside a collective).

        Pairing is by SERVER-SIDE arrival order, not the client's step
        value: each rank's k-th arrival pairs with every peer's k-th.
        A client-supplied key would desynchronize after an elastic
        respawn (the fresh process's executor restarts its local count
        while survivors kept counting — every barrier would then time
        out); the rejoin path resets all sequences to re-pair from
        zero, and the client's ``step`` stays in the diagnostics."""
        rank = int(req["rank"])
        step = int(req["step"])
        fp = req.get("fingerprint")
        deadline = time.monotonic() + float(req.get("timeout_s", 60.0))
        with self._cv:
            e = self._touch_locked(rank)
            seq = e["bseq"]
            e["bseq"] = seq + 1
            b = self._barriers.setdefault(
                seq, {"fps": {}, "error": None})
            b["fps"][rank] = fp
            if b["error"] is None:
                named = sorted((r, f) for r, f in b["fps"].items()
                               if f is not None)
                mm = self._find_mismatch(
                    named, f" at the step-{step} barrier")
                if mm is not None:
                    b["error"] = f"step {step} barrier refused: " \
                                 + mm["detail"]
            self._cv.notify_all()
            while True:
                if b["error"] is not None:
                    return {"ok": False, "error": "fingerprint",
                            "detail": b["error"]}
                dead = self._dead_locked()
                if dead:
                    return {"ok": False, "error": "degraded",
                            "dead": dead,
                            "detail": f"rank(s) {dead} died while the "
                                      f"gang was at the step-{step} "
                                      "barrier"}
                gone = sorted(r for r, e in self._ranks.items()
                              if e["finished"] and r not in b["fps"])
                if gone:
                    # an orderly departed rank can never arrive: refuse
                    # NOW with the real reason instead of stalling the
                    # full timeout and mis-diagnosing a slow rank
                    return {"ok": False, "error": "degraded",
                            "dead": gone,
                            "detail": f"rank(s) {gone} departed "
                                      "(finished their run) before the "
                                      f"step-{step} barrier; it can "
                                      "never release"}
                if len(b["fps"]) >= self.world_size:
                    for s in [s for s in self._barriers
                              if s < seq - 8]:    # bounded history
                        del self._barriers[s]
                    return {"ok": True, "released": True}
                left = deadline - time.monotonic()
                if left <= 0:
                    # withdraw the un-released arrival so a RETRY pairs
                    # at the same sequence the late peers will reach
                    # (consuming it would leave the gang permanently
                    # off by one); only when this rank hasn't already
                    # arrived at a later barrier concurrently
                    if e["bseq"] == seq + 1:
                        e["bseq"] = seq
                        b["fps"].pop(rank, None)
                    return {"ok": False, "error": "timeout",
                            "detail": f"step {step} barrier timed out "
                                      f"with {len(b['fps'])}/"
                                      f"{self.world_size} ranks arrived"}
                self._cv.wait(timeout=min(left, 0.25))

    def _op_comm_gate(self, req: dict) -> dict:
        """Pre-collective timestamp exchange (the comms-observability
        "timestamp allgather" over the socket plane): each rank posts
        its host wall-clock arrival at the k-th collective launch and
        waits (bounded) for every live peer's, so each rank can
        decompose the collective's measured wall time into
        straggler-wait (max peer arrival minus its own) vs wire time.

        Pairing is by server-side arrival order, exactly like
        ``_op_step_barrier`` (and reset with it on an elastic rejoin).
        Unlike the barrier this op NEVER refuses: telemetry must not
        fail a step — a timeout, a dead or departed peer just returns
        the partial timestamp view (``released=False``), and a timed-out
        arrival is withdrawn so a retry re-pairs at the same sequence."""
        rank = int(req["rank"])
        ts = float(req["ts"])
        deadline = time.monotonic() + float(req.get("timeout_s", 10.0))
        with self._cv:
            e = self._touch_locked(rank)
            seq = e["cseq"]
            e["cseq"] = seq + 1
            g = self._comm_gates.setdefault(seq, {"ts": {}})
            g["ts"][rank] = ts
            # bounded history pruned on ENTRY, not on release: the
            # partial-return paths below (dead peer, timeout) are the
            # steady state of a degraded-but-running gang, and pruning
            # only on full release would leak one entry per collective
            # step forever.  A straggler later arriving at a pruned seq
            # just re-creates it and gets a partial view — the same
            # contract a timeout gives it.
            for s in [s for s in self._comm_gates if s < seq - 8]:
                del self._comm_gates[s]
            self._cv.notify_all()
            while True:
                view = {str(r): t for r, t in g["ts"].items()}
                if len(g["ts"]) >= self.world_size:
                    return {"ok": True, "released": True, "ts": view}
                blocked = sorted(
                    r for r, o in self._ranks.items()
                    if r not in g["ts"]
                    and (not o["alive"] or o["finished"]))
                if blocked:
                    # a dead/departed peer can never arrive: return the
                    # partial view NOW instead of stalling the step for
                    # the whole timeout
                    return {"ok": True, "released": False, "ts": view,
                            "missing": blocked}
                left = deadline - time.monotonic()
                if left <= 0:
                    # withdraw the un-released arrival so a retry pairs
                    # at the sequence the late peers will reach (the
                    # step-barrier discipline)
                    if e["cseq"] == seq + 1:
                        e["cseq"] = seq
                        g["ts"].pop(rank, None)
                    return {"ok": True, "released": False, "ts": view}
                self._cv.wait(timeout=min(left, 0.25))

    def status_snapshot(self) -> dict:
        """The full gang view (rank table + aggregates) — one payload
        shared by the ``status`` socket op, gangtop, and the
        ``/statusz`` scrape endpoint, so the three can never disagree."""
        with self._cv:
            ranks = {str(r): {"alive": e["alive"],
                              "finished": e["finished"],
                              "step": e["step"],
                              "steps": list(e["steps"]),
                              "cur_step": e["cur_step"],
                              "hb_steps": list(e["hb_steps"]),
                              "fingerprint": e["fingerprint"],
                              "gspmd_rules": self._gspmd_rules_of(
                                  e["fingerprint"]),
                              "digest": (dict(e["digest"])
                                         if e["digest"] else None),
                              "pid": e["pid"], "deaths": e["deaths"],
                              "joins": e["joins"],
                              "role": e["role"],
                              "endpoint": e["endpoint"],
                              "age_s": round(
                                  time.monotonic() - e["last_hb"], 3)}
                     for r, e in self._ranks.items()}
            out = {"ranks": ranks,
                   "aggregates": self._aggregates_locked(),
                   "epoch": self._epoch,
                   "coord_role": self._role,
                   **self._gang_view_locked()}
            sections = dict(self._status_sections)
        # section callables run OUTSIDE _cv: they take their own locks
        # (the autoscaler's status() does), and a status scrape must
        # never be able to deadlock the coordination plane
        for name, fn in sections.items():
            try:
                out[name] = fn()
            except Exception as e:   # a broken section must not break
                out[name] = {"error": repr(e)[:200]}   # the whole view
        return out

    def attach_status_section(self, name: str, fn) -> None:
        """Register a zero-arg callable whose dict snapshot appears as
        ``name`` in every ``status_snapshot()`` (and hence the status
        socket op, ``/statusz``, and gangtop).  Re-attaching a name
        replaces it; the fleet autoscaler attaches as ``autoscaler``."""
        with self._cv:
            self._status_sections[str(name)] = fn

    def _op_status(self, req: dict) -> dict:
        return {"ok": True, **self.status_snapshot()}

    # -- scrape surface ------------------------------------------------------
    def start_metrics_http(self, port: int, host: str = "0.0.0.0"):
        """Serve ``/metrics`` ``/healthz`` ``/statusz`` off this
        coordinator's process registry (the launcher folds every rank's
        heartbeat digest into per-rank gauges here, so one scrape covers
        the whole gang — no serving stack required).  Reuses the serving
        plane's :class:`~paddle_tpu_torch.serving.httpd.MetricsHTTPServer`;
        ``/healthz`` answers 503 while the gang is degraded, so the same
        probe a load balancer uses works for a training gang.  Stopped
        with the coordinator."""
        from ..serving.httpd import MetricsHTTPServer

        def health():
            with self._cv:
                status = self._status_locked()
            return status != "degraded", status

        self._metrics_http = MetricsHTTPServer(
            port=int(port), host=host, health_fn=health,
            status_fn=self.status_snapshot).start()
        return self._metrics_http


# ---------------------------------------------------------------------------
# client (one per rank; GangRendezvous-compatible)
# ---------------------------------------------------------------------------

class GangClient:
    """A rank's connection to the :class:`GangCoordinator`.

    Implements the same protocol surface as the file-based
    :class:`~paddle_tpu_torch.distributed.env.GangRendezvous` (so the
    checkpoint daemon, the preemption guard, and ``resume_or_init`` are
    backend-agnostic) plus the liveness plane: a heartbeat thread, the
    ``degraded``/``dead_ranks`` view, ``wait_ready`` parking, and the
    fingerprint-enforcing ``step_barrier``.
    """

    backend = "socket"

    def __init__(self, address: Optional[str] = None,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 heartbeat_interval_s: Optional[float] = None,
                 role: str = "trainer",
                 endpoint: Optional[str] = None):
        from ..flags import get_flags
        env = Env()
        address = address or os.getenv("PADDLE_GANG_COORD", "")
        if not address or ":" not in address:
            raise ValueError(
                f"gang coordinator address {address!r} is not host:port "
                "(set PADDLE_GANG_COORD or pass address=)")
        # comma-separated address list: primary first, warm standby
        # after (launch.py exports both when --coordinator_standby);
        # the client rotates through them on redial
        self._addrs: List[tuple] = []
        for a in address.split(","):
            a = a.strip()
            if not a:
                continue
            host, _, port = a.rpartition(":")
            self._addrs.append((host, int(port)))
        self.address = address
        self._host, self._port = self._addrs[0]
        self.role = str(role)
        self.endpoint = endpoint
        self.rank = env.rank if rank is None else int(rank)
        self.world_size = env.world_size if world_size is None \
            else int(world_size)
        if heartbeat_interval_s is None:
            heartbeat_interval_s = float(
                get_flags("FLAGS_gang_heartbeat_interval_s")
                ["FLAGS_gang_heartbeat_interval_s"])
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self._mu = threading.Lock()
        self._sock: Optional[socket.socket] = None  # guarded-by: _mu
        self._state_mu = threading.Lock()
        self._progress: Dict[str, Any] = {          # guarded-by: _state_mu
            "step": None, "steps": [], "fingerprint": None}
        self._view: Dict[str, Any] = {              # guarded-by: _state_mu
            "status": "forming", "dead": [], "manifest": None,
            "mismatch": None}
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        #: the heartbeat thread's live socket, mirrored here so close()
        #: can interrupt a blocking send/recv (a beat mid-flight when
        #: the client is closed would otherwise outlive the 2 s join —
        #: and a zombie beat can re-dial an EPHEMERAL PORT a newer
        #: coordinator has since reused, injecting a stale rank entry
        #: into a foreign gang)
        self._hb_sock: Optional[socket.socket] = None  # guarded-by: _state_mu
        #: which of _addrs the next dial targets — advanced by
        #: _rotate_addr when the current coordinator is unreachable,
        #: a standby, or fenced
        self._addr_idx = 0                # guarded-by: _state_mu
        #: highest leadership epoch observed in any response; stamped
        #: into every request so a zombie primary fences itself
        self._seen_epoch = 0              # guarded-by: _state_mu
        # bounded redial budget per RPC: enough to visit every address
        # twice plus a grace attempt (failover completes within one
        # backoff ladder instead of failing loud on the first drop)
        self._redial_attempts = max(4, 2 * len(self._addrs) + 1)
        self._degraded_noted = False
        #: None = auto-collect monitor.metrics_digest() per beat;
        #: a dict = fixed override (tests, foreign runners)
        self._digest_override: Optional[Dict[str, Any]] = None  # guarded-by: _state_mu

    # -- connection plumbing -------------------------------------------------
    def _dial(self, timeout_s: float = 10.0) -> socket.socket:
        with self._state_mu:
            host, port = self._addrs[self._addr_idx]
        s = socket.create_connection((host, port), timeout=timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _rotate_addr(self) -> None:
        """Advance the dial target to the next coordinator address
        (no-op with a single address — the redial loop just re-dials)."""
        with self._state_mu:
            if len(self._addrs) > 1:
                self._addr_idx = (self._addr_idx + 1) % len(self._addrs)

    def _absorb_epoch(self, resp: dict) -> Optional[dict]:
        """Track the newest leadership epoch; map the two failover
        refusals (``standby``, ``fenced``) to ``None`` so the caller
        rotates and retries instead of raising them at the user."""
        ep = resp.get("epoch")
        if isinstance(ep, int) and not isinstance(ep, bool):
            with self._state_mu:
                if ep > self._seen_epoch:
                    self._seen_epoch = ep
        if not resp.get("ok") and resp.get("error") in ("standby", "fenced"):
            return None
        return resp

    def _rpc(self, req: dict, timeout_s: float = 30.0,
             oneshot: bool = False) -> dict:
        """One request/response with bounded failover.  Cheap ops share
        the persistent connection (lock-serialized); blocking ops
        (``oneshot=True``) dial their own so a parked ``wait_ready``
        never queues the daemon's announces or the heartbeat behind it.
        Transport errors and standby/fenced refusals redial through the
        address list on a deterministic backoff ladder (the retry engine's)
        before the fail-loud ConnectionError — long enough for a warm
        standby to promote, short enough that a truly dead plane still
        fails fast."""
        req = dict(req)
        req.setdefault("rank", self.rank)
        with self._state_mu:
            req.setdefault("epoch", self._seen_epoch)
        if oneshot:
            return self._failover_oneshot(req, timeout_s)
        with self._mu:
            return self._failover_persistent(req, timeout_s)

    def _failover_oneshot(self, req: dict, timeout_s: float) -> dict:
        from .. import resilience as _resil
        delays = _resil.backoff_schedule(
            self._redial_attempts, base_delay_s=0.05, max_delay_s=1.0,
            seed=zlib.crc32(b"gang.oneshot") & 0xFFFFFFFF)
        last: Optional[BaseException] = None
        t_fail: Optional[float] = None
        for attempt in range(self._redial_attempts):
            try:
                s = self._dial()
                try:
                    s.settimeout(timeout_s)
                    send_frame(s, req)
                    resp = self._absorb_epoch(recv_frame(s))
                finally:
                    try:
                        s.close()
                    except OSError:
                        pass
                if resp is None:          # standby/fenced: rotate + retry
                    last = ConnectionError("coordinator is standby/fenced")
                    t_fail = t_fail or time.monotonic()
                    self._rotate_addr()
                elif t_fail is not None:
                    self._note_failover(t_fail)
                    return self._checked(resp)
                else:
                    return self._checked(resp)
            except (OSError, ConnectionError, ValueError) as e:
                last = e
                t_fail = t_fail or time.monotonic()
                if attempt >= 1:          # first retry is a free re-dial
                    self._rotate_addr()
            if attempt < self._redial_attempts - 1:
                time.sleep(delays[attempt])
        raise ConnectionError(
            f"gang coordinator(s) at {self.address} unreachable after "
            f"{self._redial_attempts} attempts: {last}") from last

    def _failover_persistent(self, req: dict,  # guarded-by-caller: _mu
                             timeout_s: float) -> dict:
        from .. import resilience as _resil
        delays = _resil.backoff_schedule(
            self._redial_attempts, base_delay_s=0.05, max_delay_s=1.0,
            seed=zlib.crc32(b"gang.persistent") & 0xFFFFFFFF)
        last: Optional[BaseException] = None
        t_fail: Optional[float] = None
        for attempt in range(self._redial_attempts):
            try:
                if self._sock is None:
                    self._sock = self._dial()
                self._sock.settimeout(timeout_s)
                send_frame(self._sock, req)
                resp = self._absorb_epoch(recv_frame(self._sock))
                if resp is None:          # standby/fenced: rotate + retry
                    last = ConnectionError("coordinator is standby/fenced")
                    t_fail = t_fail or time.monotonic()
                    self._close_sock_locked()
                    self._rotate_addr()
                else:
                    if t_fail is not None:
                        self._note_failover(t_fail)
                    return self._checked(resp)
            except (OSError, ConnectionError, ValueError) as e:
                last = e
                t_fail = t_fail or time.monotonic()
                self._close_sock_locked()
                if attempt >= 1:          # first retry is a free reconnect
                    self._rotate_addr()
            if attempt < self._redial_attempts - 1:
                # bounded sleep (ladder caps at ~0.75 s total) under _mu:
                # only other _rpc callers queue behind it, and they would
                # hit the same dead coordinator anyway  # lint-ok: bounded backoff while the coordinator plane fails over
                time.sleep(delays[attempt])
        raise ConnectionError(
            f"gang coordinator(s) at {self.address} unreachable after "
            f"{self._redial_attempts} attempts: {last}") from last

    def _close_sock_locked(self) -> None:  # guarded-by-caller: _mu
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None

    def _note_failover(self, t_fail: float) -> None:
        """An RPC that failed and then succeeded crossed a coordinator
        failover (or blip) — record how long the client was dark."""
        ms = (time.monotonic() - t_fail) * 1e3
        _monitor.FLEET_FAILOVER_HIST.observe(ms)
        if _monitor.TRACER.enabled:
            _monitor.TRACER.instant(
                "gang.client_failover", "gang",
                {"rank": self.rank, "ms": round(ms, 3)})

    @staticmethod
    def _checked(resp: dict) -> dict:
        if resp.get("ok"):
            return resp
        err = resp.get("error")
        detail = resp.get("detail", "")
        if err == "fingerprint":
            raise GangFingerprintError(detail)
        if err == "degraded":
            raise GangDegradedError(detail, dead=resp.get("dead", ()))
        if err == "timeout":
            raise TimeoutError(detail)
        raise RuntimeError(f"gang coordinator refused request: "
                           f"{err}: {detail}")

    def connect(self) -> "GangClient":
        resp = self._rpc({"op": "hello", "pid": os.getpid(),
                          "role": self.role, "endpoint": self.endpoint})
        self._absorb_view(resp)
        return self

    def goodbye(self) -> None:
        """Tell the coordinator this rank is departing ON PURPOSE (work
        done / preemption drain complete).  Without it, the rank's
        silence reads as a death and degrades the gang — a crashed or
        SIGKILLed rank never says this, which is exactly how the
        coordinator tells a departure from a death (the PreemptionGuard
        sends it only on a CLEAN exit of the guarded block).  Stops the
        heartbeat thread first so no trailing beat races the departure.
        Best-effort: a dead coordinator at shutdown is not an error."""
        self._hb_stop.set()
        try:
            self._rpc({"op": "goodbye"}, timeout_s=5.0, oneshot=True)
        except (OSError, ConnectionError, RuntimeError):
            pass

    def close(self, goodbye: bool = True) -> None:
        self._hb_stop.set()
        # interrupt a beat blocked in send/recv (socket timeouts run to
        # 5 s, longer than the join below) — closing the socket makes
        # the blocking call raise NOW, so the thread reliably dies
        # inside this close() instead of beating once more afterwards
        self._drop_hb_sock()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None
        if goodbye:
            self.goodbye()
        with self._mu:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
            self._sock = None

    # -- liveness plane ------------------------------------------------------
    def start_heartbeat(self) -> "GangClient":
        if self._hb_thread is None or not self._hb_thread.is_alive():
            self._hb_stop.clear()
            self._hb_thread = threading.Thread(
                target=self._hb_loop, daemon=True,
                name=f"pt-gang-hb-r{self.rank}")
            self._hb_thread.start()
        return self

    def _absorb_view(self, resp: dict) -> None:
        view = {"status": resp.get("status", "forming"),
                "dead": list(resp.get("dead") or []),
                "manifest": resp.get("manifest"),
                "mismatch": resp.get("mismatch")}
        with self._state_mu:
            self._view = view
        if view["status"] == "degraded" and not self._degraded_noted:
            self._degraded_noted = True
            if _monitor.TRACER.enabled:
                _monitor.TRACER.instant(
                    "gang.degraded", "gang",
                    {"rank": self.rank, "dead": view["dead"]})
        elif view["status"] == "ok":
            self._degraded_noted = False

    def _drop_hb_sock(self) -> None:
        with self._state_mu:
            sock, self._hb_sock = self._hb_sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _hb_loop(self) -> None:
        from .. import resilience as _resil
        fails = 0          # consecutive beat failures (loop-local)
        while not self._hb_stop.is_set():
            try:
                with self._state_mu:
                    sock = self._hb_sock
                if sock is None:
                    # dial FIRST, publish under the lock after — close()
                    # observing None here is fine: the stop flag is
                    # checked again before the next beat is sent
                    sock = self._dial()
                    sock.settimeout(
                        max(4.0 * self.heartbeat_interval_s, 5.0))
                    with self._state_mu:
                        self._hb_sock = sock
                with self._state_mu:
                    payload = {"op": "heartbeat", "rank": self.rank,
                               "epoch": self._seen_epoch,
                               **self._progress}
                    override = self._digest_override
                digest = override
                if digest is None:
                    # auto-collect this rank's runtime digest (a few
                    # targeted registry reads — the beat stays cheap);
                    # digest failure must never cost a heartbeat
                    try:
                        digest = _monitor.metrics_digest()
                    except Exception:
                        digest = None
                if digest:
                    payload["digest"] = _monitor.capped_digest(digest)
                if self._hb_stop.is_set():
                    break        # close() raced the dial: never beat
                # chaos site: a dropped/hung beat exercises the
                # coordinator's liveness scan + the standby's promotion
                _resil.maybe_inject("replica.heartbeat")
                send_frame(sock, payload)
                resp = self._absorb_epoch(recv_frame(sock))
                _monitor.GANG_HB_CTR.inc(1, role="client")
                if resp is None:
                    # beating a standby (or a fenced zombie): rotate to
                    # the real primary and re-hello so the new leader
                    # learns this rank's role/endpoint
                    self._drop_hb_sock()
                    self._rotate_addr()
                    try:
                        self.connect()
                    except (OSError, ConnectionError, RuntimeError):
                        pass
                elif resp.get("ok"):
                    fails = 0
                    self._absorb_view(resp)
            except (OSError, ConnectionError, ValueError,
                    _resil.InjectedFault):
                self._drop_hb_sock()      # reconnect on the next beat
                fails += 1
                if fails >= 2:
                    # two straight dead beats: the primary is likely
                    # gone — try the next coordinator address
                    self._rotate_addr()
                    fails = 0
            self._hb_stop.wait(self.heartbeat_interval_s)
        self._drop_hb_sock()

    def set_progress(self, step: Optional[int] = None,
                     steps=None, fingerprint: Optional[str] = None) -> None:
        """Update what the next heartbeat carries: the rank's current
        step, its durably-committed step list, and its collective
        fingerprint.  ``None`` leaves a field unchanged."""
        with self._state_mu:
            if step is not None:
                self._progress["step"] = int(step)
            if steps is not None:
                self._progress["steps"] = sorted(int(s) for s in steps)
            if fingerprint is not None:
                self._progress["fingerprint"] = str(fingerprint)

    def set_digest(self, digest: Optional[Dict[str, Any]]) -> None:
        """Override the metrics digest the heartbeat carries (``None``
        returns to auto-collection from the monitor registry).  For
        runners whose metrics live outside this process's registry."""
        with self._state_mu:
            self._digest_override = dict(digest) if digest else None

    @property
    def degraded(self) -> bool:
        with self._state_mu:
            return self._view["status"] == "degraded"

    @property
    def dead_ranks(self) -> List[int]:
        with self._state_mu:
            return list(self._view["dead"])

    def check(self) -> None:
        """Raise the latched cross-rank fingerprint mismatch, if any —
        the passive (heartbeat-borne) form of the barrier refusal."""
        with self._state_mu:
            mm = self._view.get("mismatch")
        if mm:
            raise GangFingerprintError(mm["detail"])

    def wait_ready(self, timeout_s: Optional[float] = None) -> bool:
        """Park until every rank of the gang is alive again (the elastic
        rejoin barrier).  Returns False if the deadline passes with ranks
        still dead."""
        if timeout_s is None:
            from ..flags import get_flags
            timeout_s = float(get_flags("FLAGS_gang_rejoin_timeout_s")
                              ["FLAGS_gang_rejoin_timeout_s"])
        with _monitor.TRACER.span("gang.wait_ready", "gang",
                                  rank=self.rank):
            resp = self._rpc({"op": "wait_ready", "timeout_s": timeout_s},
                             timeout_s=timeout_s + 10.0, oneshot=True)
        return bool(resp.get("ready"))

    def step_barrier(self, step: int, fingerprint: Optional[str] = None,
                     timeout_s: float = 60.0) -> None:
        """Gang step barrier with collective-fingerprint enforcement.
        Raises :class:`GangFingerprintError` (mismatch, naming both
        ranks), :class:`GangDegradedError` (a rank died — drain and
        ``wait_ready`` instead of entering the collective), or
        ``TimeoutError``."""
        if fingerprint is None:
            with self._state_mu:
                fingerprint = self._progress["fingerprint"]
        with _monitor.TRACER.span("gang.step_barrier", "gang",
                                  rank=self.rank, step=int(step)):
            self._rpc({"op": "step_barrier", "step": int(step),
                       "fingerprint": fingerprint,
                       "timeout_s": timeout_s},
                      timeout_s=timeout_s + 10.0, oneshot=True)

    def comm_gate(self, ts: float, timeout_s: float = 10.0) -> dict:
        """Pre-collective timestamp exchange (comms observability): post
        this rank's collective-launch arrival timestamp (epoch seconds)
        and collect every live peer's, pairing by server-side arrival
        order.  Returns ``{"released": bool, "ts": {rank: epoch_s}}`` —
        ``released=False`` means the view is partial (timeout, or a
        dead/departed peer).  Never raises a gang refusal: this is
        telemetry, not coordination — transport errors do propagate so
        the caller can latch the gate off."""
        resp = self._rpc({"op": "comm_gate", "ts": float(ts),
                          "timeout_s": float(timeout_s)},
                         timeout_s=float(timeout_s) + 10.0, oneshot=True)
        return {"released": bool(resp.get("released")),
                "ts": resp.get("ts") or {}}

    # -- GangRendezvous protocol (socket transport) --------------------------
    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def announce(self, step: int, steps=None) -> None:
        steps = sorted(int(s) for s in (steps or [step]))
        # the heartbeat echoes this list as OBSERVABILITY (the
        # coordinator stores it as hb_steps; the durable record the
        # manifest commits on is this announce alone).  The heartbeat's
        # 'step' field stays the CURRENT training step —
        # set_progress(step=...) is the training loop's to call.
        self.set_progress(steps=steps)
        self._rpc({"op": "announce", "step": int(step), "steps": steps})

    def peer_announcements(self) -> Dict[int, dict]:
        resp = self._rpc({"op": "peers"})
        return {int(r): {"step": int(d["step"]),
                         "steps": [int(s) for s in d["steps"]]}
                for r, d in resp["peers"].items()}

    def committed_step(self) -> Optional[int]:
        step = self._rpc({"op": "manifest"})["step"]
        return None if step is None else int(step)

    def publish(self, step: int) -> None:
        if not self.is_leader:
            raise RuntimeError(
                f"rank {self.rank} tried to publish the gang manifest; "
                "only rank 0 commits")
        self._rpc({"op": "publish", "step": int(step)})

    def commit_latest(self) -> Optional[int]:
        if not self.is_leader:
            return None
        pub = self._rpc({"op": "commit_latest"}).get("published")
        return None if pub is None else int(pub)

    def wait_commit(self, step: int, timeout_s: float,
                    poll_s: float = 0.05) -> bool:
        if not self.is_leader:
            raise RuntimeError("wait_commit is leader-only; other ranks "
                               "just announce and exit")
        resp = self._rpc({"op": "wait_commit", "step": int(step),
                          "timeout_s": float(timeout_s)},
                         timeout_s=float(timeout_s) + 10.0, oneshot=True)
        return bool(resp.get("committed"))

    def wait_manifest(self, step: int, timeout_s: float,
                      poll_s: float = 0.05) -> bool:
        resp = self._rpc({"op": "wait_manifest", "step": int(step),
                          "timeout_s": float(timeout_s)},
                         timeout_s=float(timeout_s) + 10.0, oneshot=True)
        return bool(resp.get("reached"))

    def status(self) -> dict:
        """Full coordinator-side gang view (debugging / tests)."""
        return self._rpc({"op": "status"})
