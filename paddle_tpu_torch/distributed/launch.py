"""Process launcher: ``python -m paddle_tpu_torch.distributed.launch
train.py`` (the port of ``paddle_tpu/distributed/launch.py``; ref
``python/paddle/distributed/launch.py:147-281``).

It parses the cluster (node ips, processes a node), spawns one trainer
process a rank with the ``PADDLE_TRAINER_ID`` / ``PADDLE_CURRENT_ENDPOINT``
/ ``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ENDPOINTS`` contract and
``FLAGS_selected_gpus`` (the rank's card: its local index modulo the
visible cards, so that every process of a one-card host gets card 0),
writes each rank's log, and tears the job down if a rank dies.  Rank 0's
endpoint is ``init_parallel_env``'s rendezvous address.

Gang coordination: by default (``--gang_backend socket``) the node-0
launcher hosts a :class:`~paddle_tpu_torch.distributed.coordinator.
GangCoordinator` on ``started_port + world_size`` and exports
``PADDLE_GANG_COORD``, so every rank's heartbeats, checkpoint commits and
barriers ride sockets (the manifest is still mirrored into
``PADDLE_GANG_DIR`` so that a full job restart refuses torn saves).
``--gang_backend file`` keeps the shared-directory rendezvous.

Elastic recovery: ``--max_restarts N`` lets the launcher respawn a rank
that died abnormally (SIGKILL, OOM, crash) instead of tearing the job
down.  The coordinator has declared the rank dead (survivors drained and
parked at the rejoin barrier); the respawned process resumes from the
gang manifest step through ``resume_or_init``, re-admits itself with its
``hello``, and training goes on: the gang never committed a step past the
last all-rank-durable one, so the combined loss trajectory is exactly the
uninterrupted one.

Gang preemption: a SIGTERM or SIGINT to the launcher forwards SIGTERM to
every rank, then waits up to ``--grace_secs`` for the gang to drain: each
rank's ``PreemptionGuard`` finishes its emergency checkpoint and
announces it, and the rank-0 leader publishes the ``COMMITTED`` manifest
only when every rank saved the same step.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="paddle_tpu_torch distributed launcher "
                    "(ref python/paddle/distributed/launch.py)")
    p.add_argument("--cluster_node_ips", default="127.0.0.1",
                   help="comma-separated node ips")
    p.add_argument("--node_ip", default="127.0.0.1",
                   help="this node's ip")
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes per node (processes beyond the "
                        "visible cards share them)")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--gang_dir", default=None,
                   help="shared rendezvous dir for gang checkpoint "
                        "commits (exported as PADDLE_GANG_DIR; default: "
                        "<log_dir>/gang, or a fresh temp dir)")
    p.add_argument("--gang_backend", choices=("socket", "file"),
                   default="socket",
                   help="gang coordination transport: 'socket' (default) "
                        "hosts a rank-0 TCP coordinator on the node-0 "
                        "launcher at started_port + world_size and "
                        "exports PADDLE_GANG_COORD (liveness plane + "
                        "elastic recovery, no shared FS needed); 'file' "
                        "keeps the shared-directory rendezvous")
    p.add_argument("--coordinator_standby", action="store_true",
                   default=None,
                   help="also host a warm-standby gang coordinator at "
                        "started_port + world_size + 1 that mirrors the "
                        "primary's manifest + announcements over a "
                        "replicated log and promotes itself (epoch-"
                        "fenced) on primary heartbeat loss; ranks get "
                        "both addresses via PADDLE_GANG_COORD and fail "
                        "over automatically (default: "
                        "FLAGS_coordinator_standby)")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="how many abnormal rank exits the launcher may "
                        "absorb by respawning the rank (elastic "
                        "recovery; the respawned rank resumes from the "
                        "gang manifest step).  0 = any abnormal exit "
                        "tears the job down (the old behavior)")
    p.add_argument("--grace_secs", type=float, default=60.0,
                   help="how long a SIGTERM'd launcher waits for ranks "
                        "to finish their gang-coordinated emergency "
                        "checkpoint before SIGKILLing stragglers")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _cluster_shape(args):
    """(node_ips, world_size) — the one derivation every launch helper
    shares, so the coordinator port, the rank envs, and the hosting
    gate can never disagree."""
    node_ips = args.cluster_node_ips.split(",")
    return node_ips, len(node_ips) * args.nproc_per_node


def gang_coord_address(args) -> str:
    """The (derivable, launcher-independent) coordinator endpoint: node-0
    at ``started_port + world_size`` — every node's launcher computes the
    same address without any cross-node exchange."""
    node_ips, world = _cluster_shape(args)
    return f"{node_ips[0]}:{args.started_port + world}"


def _standby_enabled(args) -> bool:
    """--coordinator_standby, defaulting to FLAGS_coordinator_standby
    when the CLI flag was not given (None)."""
    if args.coordinator_standby is not None:
        return bool(args.coordinator_standby)
    try:
        from ..flags import get_flags
        return bool(get_flags("FLAGS_coordinator_standby")
                    ["FLAGS_coordinator_standby"])
    except Exception:
        return False


def standby_node(node_ips) -> str:
    """Cross-node standby placement (pure — the unit-tested decision):
    the warm standby must not share the primary's failure domain, so it
    lands on node 1 whenever the cluster HAS a second node; a
    single-node cluster keeps it next to the primary (the pre-cross-node
    behavior, still useful against process death)."""
    node_ips = list(node_ips)
    return node_ips[1] if len(node_ips) > 1 else node_ips[0]


def gang_standby_address(args) -> str:
    """The warm standby's endpoint: one port above the primary, hosted
    on ``standby_node`` (same derivable-everywhere property — every
    launcher computes the same address with no cross-node exchange)."""
    node_ips, world = _cluster_shape(args)
    return f"{standby_node(node_ips)}:{args.started_port + world + 1}"


def _resolve_gang_dir(args) -> str:
    """One gang dir per launcher invocation — memoized on the args
    namespace so the ranks' PADDLE_GANG_DIR and the coordinator's
    manifest mirror are the SAME directory (a mkdtemp fallback resolved
    twice would give the coordinator a manifest path no rank reads)."""
    cached = getattr(args, "_resolved_gang_dir", None)
    if cached is None:
        cached = args.gang_dir or (
            os.path.join(args.log_dir, "gang") if args.log_dir
            else tempfile.mkdtemp(prefix="pt_gang_"))
        args._resolved_gang_dir = cached
    return cached


def _visible_cards() -> int:
    """The cards this host shows (0 without CUDA)."""
    try:
        import torch
        return int(torch.cuda.device_count())
    except Exception:
        return 0


def get_cluster_env(args):
    """Build the per-rank env dicts (ref launch.py start_procs :147)."""
    node_ips, world = _cluster_shape(args)
    nnodes = len(node_ips)
    nproc = args.nproc_per_node
    endpoints = [f"{ip}:{args.started_port + i}"
                 for ip in node_ips for i in range(nproc)]
    node_idx = node_ips.index(args.node_ip)
    gang_dir = _resolve_gang_dir(args)
    if nnodes > 1 and not args.gang_dir and args.gang_backend == "file":
        # every launcher invents its own default dir, so on a multi-NODE
        # job the ranks would rendezvous in per-node directories the
        # leader never reads — the gang could then never commit, and
        # every resume would cold-start.  (The socket backend has no
        # shared-FS requirement: ranks talk to the node-0 coordinator.)
        import warnings
        warnings.warn(
            "multi-node launch without --gang_dir: gang checkpoint "
            f"commits need ONE directory visible to every node, but "
            f"{gang_dir!r} is node-local; pass --gang_dir on shared "
            "storage or gang commits will never publish")
    cards = max(_visible_cards(), 1)
    envs = []
    for local in range(nproc):
        rank = node_idx * nproc + local
        env = {
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_GANG_DIR": gang_dir,
            "FLAGS_selected_gpus": str(local % cards),
            "TRAINING_ROLE": "TRAINER",
        }
        if args.gang_backend == "socket" and world > 1:
            addr = gang_coord_address(args)
            if _standby_enabled(args):
                # both addresses, primary first: GangClient rotates to
                # the standby on primary loss (epoch-fenced failover)
                addr = f"{addr},{gang_standby_address(args)}"
            env["PADDLE_GANG_COORD"] = addr
        envs.append(env)
    return envs


def start_coordinator(args):
    """Host this node's share of the gang coordination plane (socket
    backend, multi-rank jobs only).  The node-0 launcher hosts the
    primary; the ``standby_node`` launcher (node 1 on multi-node
    clusters — cross-node placement, so the standby survives the
    primary's whole node dying; node 0 itself when single-node) hosts
    the warm standby.  Returns the list of coordinators THIS launcher
    started — possibly empty.  The launcher is the natural host: it
    outlives every rank, so rank death, respawn, and the rejoin barrier
    all survive any trainer process dying."""
    node_ips, world = _cluster_shape(args)
    if args.gang_backend != "socket" or world <= 1:
        return []
    from .coordinator import GangCoordinator
    coords = []
    if node_ips.index(args.node_ip) == 0:
        host, _, port = gang_coord_address(args).rpartition(":")
        coords.append(GangCoordinator(
            world, host=host, port=int(port),
            manifest_dir=_resolve_gang_dir(args)).start())
    if _standby_enabled(args) and args.node_ip == standby_node(node_ips):
        sb_host, _, sb_port = gang_standby_address(args).rpartition(":")
        # same manifest_dir: the standby's promotion path re-reads the
        # durable MANIFEST so replication lag can never regress it, and
        # its EPOCH fence token lands where the zombie primary looks.
        # (Multi-node jobs need --gang_dir on shared storage for the
        # mirror to be shared — the same rule the file backend has.)
        # standby_of is the DERIVED primary address: on a multi-node
        # cluster this launcher never constructed the primary object.
        coords.append(GangCoordinator(
            world, host=sb_host, port=int(sb_port),
            manifest_dir=_resolve_gang_dir(args),
            standby_of=gang_coord_address(args)).start())
    if not coords:
        return []
    # FLAGS_coordinator_metrics_port: the launcher's process registry
    # holds the whole gang's per-rank digest gauges (the coordinator
    # folds every heartbeat into it), so serving /metrics + /statusz
    # HERE makes the gang scrapeable with no serving stack — reusing
    # the serving plane's MetricsHTTPServer.  /statusz carries the same
    # rank table gangtop renders; /healthz answers 503 while degraded.
    try:
        from ..flags import get_flags
        fl = get_flags(["FLAGS_coordinator_metrics_port",
                        "FLAGS_metrics_host"])
        mport = int(fl["FLAGS_coordinator_metrics_port"])
        if mport:
            srv = coords[0].start_metrics_http(
                mport, host=str(fl["FLAGS_metrics_host"]))
            sys.stderr.write(
                f"paddle_tpu_torch launch: coordinator metrics at "
                f"{srv.url}/metrics\n")
    except Exception as e:       # scrape surface must never kill launch
        sys.stderr.write(
            f"paddle_tpu_torch launch: coordinator metrics server failed: "
            f"{e!r}\n")
    return coords


def _spawn(args, env, log_mode="w"):
    """Start one rank process (``log_mode='a'`` on a respawn, so the
    restarted rank's output lands after its first life's)."""
    cmd = [sys.executable, "-u", args.training_script] + \
        args.training_script_args
    full_env = dict(os.environ, **env)
    out = None
    if args.log_dir:
        log_name = env.get("PADDLE_LOG_NAME",
                           f"worker.{env['PADDLE_TRAINER_ID']}")
        out = open(os.path.join(args.log_dir, f"{log_name}.log"),
                   log_mode)
    proc = subprocess.Popen(cmd, env=full_env, stdout=out,
                            stderr=subprocess.STDOUT if out else None)
    return proc, out


def start_procs(args, envs):
    """Spawn one training process per local rank (ref launch.py:147)."""
    procs, logs = [], []
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    for env in envs:
        proc, out = _spawn(args, env)
        procs.append(proc)
        if out is not None:
            logs.append(out)
    return procs, logs


def drain_gang(procs, grace_secs: float = 60.0):
    """Forward SIGTERM to every live rank, then WAIT for the gang to
    drain: ranks run their PreemptionGuard emergency save + gang
    announce, the leader publishes the COMMITTED manifest, and only
    stragglers still alive after ``grace_secs`` are SIGKILLed.  Returns
    True iff every rank exited cleanly (exit 0) within the grace window —
    i.e. the gang checkpoint is trustworthy."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + float(grace_secs)
    while time.monotonic() < deadline:
        if all(p.poll() is not None for p in procs):
            break
        time.sleep(0.2)
    clean = True
    for p in procs:
        if p.poll() is None:
            p.kill()
            clean = False
    for p in procs:
        p.wait()
        clean = clean and p.returncode == 0
    return clean


def wait_procs(procs, grace_secs: float = 60.0, stop=None, args=None,
               envs=None, max_restarts: int = 0, logs=None):
    """Wait for all ranks; on an abnormal rank exit, either respawn it
    (elastic: ``max_restarts`` budget left and ``args``/``envs`` given —
    the rank resumes from the gang manifest and the coordinator re-admits
    it at the rejoin barrier) or kill the gang (ref :256).

    A SIGTERM to the launcher (``stop`` flag set by the signal handler)
    or a Ctrl-C drains the gang gracefully — every rank gets SIGTERM and
    ``grace_secs`` to finish its coordinated emergency checkpoint —
    instead of orphaning ranks mid-save."""
    restarts_left = int(max_restarts)
    try:
        while True:
            if stop is not None and stop.get("signum") is not None:
                ok = drain_gang(procs, grace_secs)
                raise SystemExit(0 if ok else 1)
            alive = False
            for i, p in enumerate(procs):
                ret = p.poll()
                if ret is None:
                    alive = True
                elif ret != 0:
                    if restarts_left > 0 and args is not None \
                            and envs is not None:
                        restarts_left -= 1
                        sys.stderr.write(
                            f"paddle_tpu_torch launch: rank "
                            f"{envs[i]['PADDLE_TRAINER_ID']} (pid "
                            f"{p.pid}) exited {ret}; respawning "
                            f"({restarts_left} restart(s) left) — it "
                            "will resume from the gang manifest step\n")
                        sys.stderr.flush()
                        newp, out = _spawn(args, envs[i], log_mode="a")
                        procs[i] = newp
                        if out is not None and logs is not None:
                            logs.append(out)
                        alive = True
                    else:
                        drain_gang(procs, grace_secs)
                        raise SystemExit(
                            f"rank process {p.pid} exited with {ret}")
            if not alive:
                return
            time.sleep(0.5)
    except KeyboardInterrupt:
        ok = drain_gang(procs, grace_secs)
        raise SystemExit(0 if ok else 1) from None


class ReplicaLauncher:
    """The ``--max_restarts`` respawn machinery generalized into a
    target-size actuator for the fleet autoscaler: ``spawn()`` starts
    one serving-replica process and blocks until it prints its
    ``READY <host:port>`` line; ``retire(addr)`` SIGTERMs it — the
    replica's guard path drains its in-flight work (the drain
    contract, never a kill) — and SIGKILLs only a straggler still alive
    past ``grace_secs``.

    The command is re-invoked verbatim per spawn; each child inherits
    ``env`` over the parent's.  The READY protocol is the same one
    ``paddle_tpu_torch/tools/fleet_smoke.py`` children speak, so the autoscaler drill
    exercises this exact path.
    """

    def __init__(self, cmd, env=None, grace_secs: float = 30.0,
                 ready_timeout_s: float = 120.0):
        self.cmd = list(cmd)
        self.env = dict(env or {})
        self.grace_secs = float(grace_secs)
        self.ready_timeout_s = float(ready_timeout_s)
        self._procs = {}    # addr -> subprocess.Popen

    def spawn(self) -> str:
        """Start one replica; returns its address.  Raises
        ``RuntimeError`` when the child dies or stays silent past
        ``ready_timeout_s`` (the autoscaler turns that into backoff +
        re-shed, never a crash)."""
        proc = subprocess.Popen(
            self.cmd, env=dict(os.environ, **self.env),
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        deadline = time.monotonic() + self.ready_timeout_s
        addr = None
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break                      # child closed stdout / died
            line = line.strip()
            if line.startswith("READY "):
                addr = line.split(None, 1)[1]
                break
        if addr is None:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            raise RuntimeError(
                f"replica spawn failed: no READY line (exit "
                f"{proc.returncode})")
        self._procs[addr] = proc
        return addr

    def retire(self, addr: str) -> int:
        """Drain-then-stop the replica at ``addr``; returns its exit
        code (0 = the drain finished every in-flight request)."""
        proc = self._procs.pop(str(addr), None)
        if proc is None:
            raise KeyError(f"no spawned replica at {addr!r}")
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            deadline = time.monotonic() + self.grace_secs
            while time.monotonic() < deadline and proc.poll() is None:
                time.sleep(0.05)
            if proc.poll() is None:
                proc.kill()
        return proc.wait()

    def alive(self):
        """Addresses of spawned replicas whose process is still up."""
        return [a for a, p in self._procs.items() if p.poll() is None]

    def stop_all(self, grace_secs=None) -> None:
        """Teardown: retire every spawned replica (best effort)."""
        if grace_secs is not None:
            self.grace_secs = float(grace_secs)
        for addr in list(self._procs):
            try:
                self.retire(addr)
            except Exception:
                pass


def launch(argv=None):
    args = _parse_args(argv)
    envs = get_cluster_env(args)
    coords = start_coordinator(args)
    procs, logs = start_procs(args, envs)
    # a scheduler preempts the LAUNCHER: forward + drain, don't die and
    # leave ranks checkpointing into a gang that can never commit
    stop = {"signum": None}
    old = None
    try:
        old = signal.signal(signal.SIGTERM,
                            lambda s, f: stop.__setitem__("signum", s))
    except ValueError:          # not the main thread (embedded use)
        pass
    try:
        wait_procs(procs, grace_secs=args.grace_secs, stop=stop,
                   args=args, envs=envs,
                   max_restarts=args.max_restarts, logs=logs)
    finally:
        if old is not None:
            signal.signal(signal.SIGTERM, old)
        for c in coords:
            c.stop()
        for f in logs:
            f.close()


if __name__ == "__main__":
    launch()
