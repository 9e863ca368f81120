#!/usr/bin/env python
"""Fleet chaos drill (the port of ``tools/fleet_smoke.py``): real replica
processes behind a ``FleetRouter`` under an open-loop client, with scripted
kills, asserting that the fleet drops nothing.

    python paddle_tpu_torch/tools/fleet_smoke.py [--scenario drain kill
        coord scale] [--cpu] [--width tiny|full|full2] [--full] [--bench]

1. ``drain`` — SIGTERM one of two replicas mid-load: the replica drains its
   in-flight work and exits 0; the router holds it out of placement and
   re-routes (``reason="drain"``); the client sees no failure and the
   router's ledger sums exactly (completed == admitted, failed == rejected
   == 0).
2. ``kill`` — SIGKILL one of two replicas mid-request: in-flight requests
   replay on the survivor (``reason="dead"`` >= 1), no client-visible
   failure, the p99 over the failover printed.
3. ``coord`` — the whole topology: a primary and a warm-standby gang
   coordinator (``--role coordinator`` children, one manifest directory),
   two replicas registered with both addresses (``role="replica"``), a
   rank-0 publisher committing manifest steps every 50 ms: SIGKILL the
   primary mid-commit-loop; the standby promotes (epoch >= 1, the
   ``EPOCH`` fence stamped), the publisher and the replicas fail over with
   no error, the serving traffic drops nothing, and the ``MANIFEST`` file
   never reads torn or goes back.
4. ``scale`` — the autoscaler's loop from one replica: a load spike counts
   exactly one scale-up and spawns a second replica (p99 back under the
   calibrated objective, no failure); a replica SIGKILLed under load is
   replaced; sustained idle retires exactly one replica through its drain
   (the retired child exits 0).

``--full`` adds, after those four, a torn router forward
(``router.forward:once``) to ``kill``, a torn coordinator frame
(``coordinator.frame:once@5`` in the primary) to ``coord``, a failed spawn
(``autoscaler.spawn:once``: the controller backs off, sheds while the
breach lasts, retries, never counts the decision twice) to ``scale``, and
``scale+coord``: the autoscaler attached to a warm standby whose primary
is SIGKILLed: the standby promotes with the autoscaler's section in its
status (gangtop's footer), the controller keeps ticking and counts no
decision across the failover.  ``--bench`` prints one ``FLEET BENCH
{json}`` line: two-replica QPS, the p99 while the autoscaler absorbs a
spike, the p99 under a replica SIGKILL.

Every replica serves the same GPT (``--width tiny``: vocab 64, d 64, 4
layers; ``full``: the GPT at BERT-base width, vocab 30522, d 768, 12
layers, 12 heads; ``full2``: that width at 2 layers), built with one
bucket (32) and flash attention and
served through ``InferenceServer`` behind a ``ReplicaEndpoint``.  The
driver makes seeded random weights on the replicas' device, serves one
probe request from them in process, and saves them with
``io.save_persistables`` into a temporary directory; or it takes a
directory so written from ``--weights`` and that server's probe logits
from ``--expect`` (a ``.npy`` file).  Each child loads the weights.
Before any load, the driver sends the probe to each replica directly:
every replica's logits must agree with the in-process server's within
1e-5 + 1e-4 relative.  The replicas run on ``cuda:0`` (one card for all
of them; they load the kernels the parent's build directory already holds
and report whether any had to be built), or with ``--cpu`` on the host
with one torch thread each.  Requests are ``REQUEST_TOKENS[width]`` tokens
long: at full width a request's logits travel as JSON lists of 30522
floats a token.

Children print ``READY <addr>`` once serving, then a ``STATS {json}`` line
every half second and on exit: flash-forward (K1) launches and batches
served since READY, ``torch.cuda.max_memory_allocated``, seconds from
process start to its imports done, its weights loaded and READY,
and whether the kernels were prebuilt.  The last line of the driver's
output is ``FLEET RESULT {json}``: each scenario's numbers and the stats and
exit code of every child.
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

_T_START = time.perf_counter()
_ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(_ROOT))

import numpy as np  # noqa: E402

REPLICA_BUCKETS = (32,)
#: tiny: big enough that a request costs ~10 ms on a CPU, so a drain and a
#: failover find requests in flight; full: the GPT at BERT-base width
WIDTHS = {
    "tiny": dict(vocab_size=64, d_model=64, n_layer=4, n_head=4,
                 d_inner=256, max_pos=64, dropout=0.0),
    "full": dict(vocab_size=30522, d_model=768, n_layer=12, n_head=12,
                 d_inner=3072, max_pos=2048, dropout=0.0),
    "full2": dict(vocab_size=30522, d_model=768, n_layer=2, n_head=12,
                  d_inner=3072, max_pos=2048, dropout=0.0),
}
#: tokens a request: a full-width request's logits go back as JSON, ~0.6 MB
#: a token
REQUEST_TOKENS = {"tiny": 24, "full": 2, "full2": 2}
WEIGHT_SEED = 4321
#: how long a drained replica's endpoint keeps refusing before it closes
DRAIN_GRACE_S = 0.5
#: a replica's probe logits must agree this closely with the in-process
#: server's
PROBE_ATOL, PROBE_RTOL = 1e-5, 1e-4
#: the coordinators' heartbeat timeout: their liveness and the standby's
#: promotion clock
HB_TIMEOUT = 0.3

#: set by main(): the replica device flag, the model width, the weights'
#: directory and the probe's expected logits
_CFG = {"cpu": False, "width": "tiny"}


def _program_factory(width):
    from paddle_tpu_torch.framework import Program, program_guard
    from paddle_tpu_torch.models import transformer as T
    cfg = T.BertConfig(**WIDTHS[width])

    def factory(seq):
        prog, startup = Program(), Program()
        with program_guard(prog, startup):
            _, logits = T.build_gpt_serving(cfg, seq, attn_impl="flash")
        return prog, ["src_ids"], [logits.name]
    return cfg, factory


def _executor(cpu):
    """The replicas' executor: ``cuda:0`` with TF32 off, or the host with
    one torch thread."""
    import torch
    import paddle_tpu_torch as ptt
    if cpu:
        torch.set_num_threads(1)
        return ptt.Executor(ptt.CPUPlace())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ptt.Executor()


def probe_feeds(width):
    """The probe request each replica answers before any load."""
    return _feeds(0, 0, width)


def serve_probe(factory, scope, exe, width):
    """The probe's logits from one in-process ``InferenceServer`` over
    ``scope``."""
    from paddle_tpu_torch.serving.server import InferenceServer
    srv = InferenceServer(factory, scope, buckets=REPLICA_BUCKETS,
                          max_batch=4, executor=exe).start()
    try:
        out = srv.submit("probe", probe_feeds(width),
                         seq_len=REQUEST_TOKENS[width]).result(timeout=600)
    finally:
        srv.stop()
    return np.asarray(out[0], np.float32)


def write_weights(width, dirname, cpu):
    """Seeded random weights of the serving GPT, made on the replicas'
    device and saved with ``io.save_persistables``.  Returns the probe's
    logits, served in process from the weights before they were saved."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import Program, Scope, program_guard
    from paddle_tpu_torch.models import transformer as T
    cfg = T.BertConfig(**WIDTHS[width])
    main, startup = Program(), Program()
    with program_guard(main, startup):
        T.build_gpt_serving(cfg, REPLICA_BUCKETS[0], attn_impl="flash")
    scope = Scope()
    exe = _executor(cpu)
    exe.run(startup, scope=scope, seed=WEIGHT_SEED)
    expect = serve_probe(_program_factory(width)[1], scope, exe, width)
    ptt.io.save_persistables(exe, dirname, main_program=main, scope=scope)
    return expect


# ---------------------------------------------------------------------------
# child roles
# ---------------------------------------------------------------------------

class _DelayExecutor:
    """Executor proxy adding a fixed service time per dispatch, so that a
    replica behaves like a saturated device: concurrent requests pile up in
    the scheduler's queue (the ``srv_q`` the autoscaler reads) and a spike
    pushes p99 past the calibrated objective."""

    def __init__(self, inner, delay_s):
        self._inner = inner
        self._delay_s = float(delay_s)

    def run(self, *a, **kw):
        time.sleep(self._delay_s)
        return self._inner.run(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def replica_main(args) -> int:
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.serving.fleet import ReplicaEndpoint
    from paddle_tpu_torch.serving.server import InferenceServer
    t_imported = time.perf_counter() - _T_START
    on_card = not args.cpu
    prebuilt = (_build.library_path("flash_attn_fwd_sm90").exists()
                if on_card else None)
    exe = _executor(args.cpu)
    _cfg, factory = _program_factory(args.width)
    scope = Scope()
    prog, _feeds, _fetch = factory(REPLICA_BUCKETS[0])
    ptt.io.load_persistables(exe, args.weights, main_program=prog,
                             scope=scope)
    if on_card:
        torch.cuda.synchronize()
    t_loaded = time.perf_counter() - _T_START
    if args.batch_delay_ms > 0:
        exe = _DelayExecutor(exe, args.batch_delay_ms / 1000.0)
    srv = InferenceServer(factory, scope, buckets=REPLICA_BUCKETS,
                          max_batch=4, executor=exe).start()
    srv.warmup()
    fa.reset_launch_count()
    if on_card:
        torch.cuda.synchronize()
    ep = ReplicaEndpoint(srv, replica_id=f"replica-{args.rank}").start()
    client = None
    if args.coord:
        from paddle_tpu_torch.distributed.coordinator import GangClient
        client = GangClient(address=args.coord, rank=args.rank,
                            world_size=args.world,
                            heartbeat_interval_s=0.1, role="replica",
                            endpoint=ep.address)
        client.connect().start_heartbeat()
    ready_s = time.perf_counter() - _T_START
    out_mu = threading.Lock()

    def stats(final=False):
        st = {"rank": args.rank, "k1": fa.launch_count("flash_attn_fwd"),
              "batches": len(srv.batch_log()),
              "ready_s": ready_s, "imported_s": t_imported,
              "loaded_s": t_loaded, "prebuilt": prebuilt, "final": final,
              "peak_bytes": (torch.cuda.max_memory_allocated()
                             if on_card else None)}
        with out_mu:
            print("STATS " + json.dumps(st), flush=True)

    print(f"READY {ep.address}", flush=True)
    done = threading.Event()

    def report():
        while not done.wait(0.5):
            stats()
    threading.Thread(target=report, daemon=True,
                     name="replica-stats").start()
    # blocks until SIGTERM, then drains: exit 0 iff nothing was dropped
    code = srv.serve_until_terminated(poll_s=0.02, drain_timeout_s=20.0)
    # the endpoint answers "draining" a moment longer, so that a router
    # still placing on this replica learns of the drain from a refusal
    # rather than from a closed port
    time.sleep(DRAIN_GRACE_S)
    done.set()
    if client is not None:
        client.close()
    ep.stop()
    stats(final=True)
    return code


def coordinator_main(args) -> int:
    """A gang coordinator child (a primary, or with ``--standby-of`` a
    warm standby): ``READY <addr>``, then serve until SIGTERM."""
    from paddle_tpu_torch.distributed.coordinator import GangCoordinator
    coord = GangCoordinator(args.world, port=0,
                            heartbeat_timeout_s=HB_TIMEOUT,
                            manifest_dir=args.manifest_dir or None,
                            standby_of=args.standby_of or None).start()
    print(f"READY {coord.address}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    signal.signal(signal.SIGINT, lambda s, f: stop.set())
    stop.wait()
    coord.stop()
    return 0


# ---------------------------------------------------------------------------
# driver plumbing
# ---------------------------------------------------------------------------

class Child:
    """One replica process: its READY address, and a reader thread keeping
    its last ``STATS`` line (the pipe never fills)."""

    def __init__(self, proc, addr, spawn_to_ready_s):
        self.proc = proc
        self.addr = addr
        self.spawn_to_ready_s = spawn_to_ready_s
        self.stats = None
        self.lines = []
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            if line.startswith("STATS "):
                self.stats = json.loads(line[len("STATS "):])

    def record(self):
        self._t.join(timeout=10.0)
        return {"addr": self.addr, "rc": self.proc.returncode,
                "spawn_to_ready_s": self.spawn_to_ready_s,
                "stats": self.stats}


#: every child the driver started, in order
CHILDREN = []


def _spawn(extra_args):
    """Start one replica; returns the :class:`Child` once it is READY."""
    return _spawn_many([extra_args])[0]


def _spawn_many(arg_lists, role="replica", env_extra=None):
    """Start several children of ``role`` together and wait until each is
    READY."""
    started = []
    for extra in arg_lists:
        cmd = [sys.executable, "-u", __file__, "--role", role] + (
            ["--weights", _CFG["weights"], "--width", _CFG["width"]] +
            (["--cpu"] if _CFG["cpu"] else []) if role == "replica"
            else []) + [str(a) for a in extra]
        env = dict(os.environ)
        env["PYTHONPATH"] = str(_ROOT) + os.pathsep + env.get("PYTHONPATH",
                                                              "")
        env.update(env_extra or {})
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=sys.stderr, text=True)
        started.append((proc, t0))
    out = []
    for proc, t0 in started:
        deadline = time.monotonic() + 300.0
        while True:
            line = proc.stdout.readline()
            if line.startswith("READY "):
                child = Child(proc, line.split(None, 1)[1].strip(),
                              time.perf_counter() - t0)
                CHILDREN.append(child)
                out.append(child)
                break
            if not line and proc.poll() is not None:
                _kill_all([p for p, _ in started])
                raise RuntimeError(f"{role} died before READY (exit "
                                   f"{proc.returncode})")
            if time.monotonic() > deadline:
                _kill_all([p for p, _ in started])
                raise RuntimeError(f"{role} never became READY")
    return out


def _wait_exit(proc, timeout_s=30.0) -> int:
    try:
        return proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise


def _kill_all(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            pass


def _stop_all(procs, timeout_s=30.0):
    """SIGTERM the replicas still running (each drains and prints its last
    stats), then kill whatever outlives ``timeout_s``."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + timeout_s
    for p in live:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
    _kill_all(live)


def _feeds(idx, n, width):
    tokens = REQUEST_TOKENS[width]
    vocab = WIDTHS[width]["vocab_size"]
    return {"src_ids": ((np.arange(tokens) + idx + n) % min(vocab, 40))
            .astype("int64")}


class OpenLoopLoad:
    """N client threads firing inference at the router back to back (small
    think time); records each request's latency and every error."""

    def __init__(self, router, n_clients=6, think_s=0.005,
                 shed_ok=False):
        self.router = router
        self.n_clients = n_clients
        self.think_s = think_s
        #: shed-tolerant mode: an ``slo_shed`` admission rejection is the
        #: autoscaler's verdict, not a failure, and is recorded apart
        self.shed_ok = shed_ok
        self._stop = threading.Event()
        self._mu = threading.Lock()
        self.latencies = []          # guarded-by: _mu
        self.errors = []             # guarded-by: _mu
        self.sheds = []              # guarded-by: _mu
        self._threads = []

    def start(self):
        for i in range(self.n_clients):
            t = threading.Thread(target=self._client, args=(i,),
                                 daemon=True, name=f"fleet-client-{i}")
            t.start()
            self._threads.append(t)
        return self

    def _client(self, idx):
        n = 0
        tokens = REQUEST_TOKENS[_CFG["width"]]
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                self.router.infer(f"tenant{idx % 2}",
                                  _feeds(idx, n, _CFG["width"]),
                                  seq_len=tokens, timeout_s=30.0)
                with self._mu:
                    self.latencies.append(time.perf_counter() - t0)
            except Exception as e:
                msg = repr(e)
                with self._mu:
                    if self.shed_ok and "slo_shed" in msg:
                        self.sheds.append(msg)
                    else:
                        self.errors.append(msg)
            n += 1
            self._stop.wait(self.think_s)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60.0)

    def p99_ms(self) -> float:
        with self._mu:
            lats = sorted(self.latencies)
        if not lats:
            return 0.0
        return lats[min(int(0.99 * len(lats)), len(lats) - 1)] * 1e3

    def counts(self):
        with self._mu:
            return len(self.latencies), list(self.errors)


def _ctr(counter, **labels) -> float:
    try:
        return float(counter.value(**labels))
    except Exception:
        return 0.0


def _assert_ledger(router, load, scenario):
    """completed == admitted exactly; no failure anywhere."""
    done, errors = load.counts()
    snap = router.snapshot()
    assert not errors, f"[{scenario}] client-visible failures: " \
                       f"{errors[:5]} ({len(errors)} total)"
    assert snap["failed"] == 0 and snap["rejected"] == 0, \
        f"[{scenario}] router ledger has failures: {snap}"
    assert snap["completed"] == snap["admitted"] == done, \
        f"[{scenario}] ledger does not sum: admitted=" \
        f"{snap['admitted']} completed={snap['completed']} " \
        f"client-done={done}"
    return done, snap


def _call(addr, payload, timeout_s):
    """One request frame straight to a replica's endpoint, and its reply."""
    import socket
    from paddle_tpu_torch.distributed.coordinator import (recv_frame,
                                                          send_frame)
    host, _, port = addr.rpartition(":")
    with socket.create_connection((host, int(port)),
                                  timeout=timeout_s) as s:
        s.settimeout(timeout_s)
        send_frame(s, payload)
        return recv_frame(s)


def _probe_against_expected(addrs, scenario):
    """The probe straight to each replica: every replica's logits agree
    with the in-process server's over the weights it loaded."""
    width = _CFG["width"]
    want = _CFG["expect"]
    payload = {"op": "infer", "tenant": "probe",
               "seq_len": REQUEST_TOKENS[width],
               "feeds": {k: {"data": v.tolist(), "dtype": str(v.dtype)}
                         for k, v in probe_feeds(width).items()}}
    for addr in addrs:
        resp = _call(addr, payload, 120.0)
        assert resp.get("ok"), f"[{scenario}] probe of {addr}: {resp}"
        got = np.asarray(resp["outputs"][0], np.float32)
        assert got.shape == want.shape, \
            f"[{scenario}] {addr}'s logits {got.shape}, want {want.shape}"
        err = np.abs(got - want)
        assert (err <= PROBE_ATOL + PROBE_RTOL * np.abs(want)).all(), \
            f"[{scenario}] {addr}'s logits differ from the in-process " \
            f"server's by {err.max()}"
        print(f"fleet probe [{scenario}] {addr}: max |replica - in-process|"
              f" {err.max():.3g} (atol {PROBE_ATOL} rtol {PROBE_RTOL})",
              flush=True)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def scenario_drain():
    """SIGTERM one replica under load: no failure, drain re-routes, the
    drained replica exits 0."""
    from paddle_tpu_torch import monitor as M
    from paddle_tpu_torch.serving.fleet import FleetRouter
    drain0 = _ctr(M.FLEET_REROUTE_CTR, reason="drain")
    r0, r1 = _spawn_many([["--rank", 0], ["--rank", 1]])
    # round_robin: placement keeps offering the SIGTERMed replica until its
    # draining refusal comes back, so a reason="drain" re-route is certain
    # (least_loaded could steer away from its queue before it refuses)
    router = FleetRouter([r0.addr, r1.addr], policy="round_robin",
                         digest_ttl_s=1.0).start()
    _probe_against_expected([r0.addr, r1.addr], "drain")
    load = OpenLoopLoad(router).start()
    try:
        time.sleep(1.5)               # both replicas take traffic
        r0.proc.send_signal(signal.SIGTERM)
        time.sleep(2.5)               # drain + re-routed load
        load.stop()
        code = _wait_exit(r0.proc)
        assert code == 0, f"[drain] SIGTERMed replica exited {code} " \
                          "(dropped in-flight work)"
        done, snap = _assert_ledger(router, load, "drain")
        drains = _ctr(M.FLEET_REROUTE_CTR, reason="drain") - drain0
        assert drains >= 1, "[drain] no drain re-route was recorded"
        states = {a: r["state"] for a, r in snap["replicas"].items()}
        print(f"fleet drain OK: {done} requests, 0 failed, "
              f"{drains:.0f} drain re-route(s), replica exit 0, "
              f"states={states}", flush=True)
        return {"requests": done, "drain_reroutes": drains,
                "drained_rc": code, "p99_ms": load.p99_ms(),
                "children": [r0, r1]}
    finally:
        load.stop()
        router.stop()
        _stop_all([r0.proc, r1.proc])


def scenario_kill(inject_forward=False):
    """SIGKILL one replica mid-request: in-flight requests replay on the
    survivor, no failure, p99 bounded."""
    from paddle_tpu_torch import monitor as M
    from paddle_tpu_torch import resilience as R
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.serving.fleet import FleetRouter
    dead0 = _ctr(M.FLEET_REROUTE_CTR, reason="dead")
    fault0 = _ctr(R._FAULT_CTR, site="router.forward")
    if inject_forward:
        set_flags({"FLAGS_fault_inject": "router.forward:once"})
    r0, r1 = _spawn_many([["--rank", 0], ["--rank", 1]])
    router = FleetRouter([r0.addr, r1.addr], digest_ttl_s=1.0).start()
    name = "kill+inject" if inject_forward else "kill"
    _probe_against_expected([r0.addr, r1.addr], name)
    load = OpenLoopLoad(router).start()
    try:
        time.sleep(1.5)
        r0.proc.kill()                # SIGKILL mid-request
        time.sleep(2.5)
        load.stop()
        done, snap = _assert_ledger(router, load, name)
        deads = _ctr(M.FLEET_REROUTE_CTR, reason="dead") - dead0
        assert deads >= 1, f"[{name}] no dead re-route was recorded"
        p99 = load.p99_ms()
        assert p99 < 10000.0, f"[{name}] p99 unbounded: {p99:.0f}ms"
        if inject_forward:
            faults = _ctr(R._FAULT_CTR, site="router.forward") - fault0
            assert faults == 1, f"[{name}] injected ledger: {faults}"
        print(f"fleet {name} OK: {done} requests, 0 failed, "
              f"{deads:.0f} dead re-route(s), p99 {p99:.0f}ms", flush=True)
        return {"requests": done, "dead_reroutes": deads, "p99_ms": p99,
                "children": [r0, r1]}
    finally:
        if inject_forward:
            set_flags({"FLAGS_fault_inject": ""})
        load.stop()
        router.stop()
        _stop_all([r0.proc, r1.proc])


def scenario_coord(inject_frame=False):
    """SIGKILL the primary coordinator mid-commit-loop: the standby
    promotes epoch-fenced, the publisher and the replicas fail over with
    no error, the serving traffic drops nothing, the manifest never tears
    (ref ``tools/fleet_smoke.py:355-470``).  ``inject_frame`` tears the
    primary's fifth frame (``coordinator.frame:once@5``)."""
    from paddle_tpu_torch.distributed.coordinator import GangClient
    from paddle_tpu_torch.distributed.env import parse_manifest
    from paddle_tpu_torch.serving.fleet import FleetRouter
    from paddle_tpu_torch.tools.gangtop import fetch_status

    mdir = tempfile.mkdtemp(prefix="pt_fleet_gang_")
    world = 3                         # rank 0 publisher + 2 replicas
    name = "coord+inject" if inject_frame else "coord"
    prim, = _spawn_many([["--world", world, "--manifest-dir", mdir]],
                        role="coordinator",
                        env_extra={"FLAGS_fault_inject":
                                   "coordinator.frame:once@5"}
                        if inject_frame else None)
    stand, = _spawn_many([["--world", world, "--manifest-dir", mdir,
                           "--standby-of", prim.addr]], role="coordinator")
    coord_addr = f"{prim.addr},{stand.addr}"
    r0, r1 = _spawn_many([["--rank", r, "--world", world, "--coord",
                           coord_addr] for r in (1, 2)])
    router = FleetRouter([r0.addr, r1.addr], digest_ttl_s=1.0).start()
    _probe_against_expected([r0.addr, r1.addr], name)
    load = OpenLoopLoad(router).start()
    pub = GangClient(address=coord_addr, rank=0, world_size=world,
                     heartbeat_interval_s=0.1).connect().start_heartbeat()
    pub_errors, published, torn, regressed = [], [0], [], []
    stop = threading.Event()

    def publisher():
        step = 0
        while not stop.is_set():
            step += 1
            try:
                pub.publish(step)
                published[0] = step
            except Exception as e:
                pub_errors.append(repr(e))
            stop.wait(0.05)

    def manifest_watch():
        """At every instant the durable file is absent or parses
        strictly, and its step never goes back across the failover."""
        last = 0
        path = os.path.join(mdir, "MANIFEST")
        while not stop.is_set():
            time.sleep(0.002)
            try:
                with open(path) as f:
                    text = f.read()
            except OSError:
                continue
            try:
                step = parse_manifest(text)
            except ValueError as e:
                torn.append(f"torn manifest: {e!r} text={text!r}")
                continue
            if step < last:
                regressed.append((last, step))
            last = step

    threads = [threading.Thread(target=publisher, daemon=True),
               threading.Thread(target=manifest_watch, daemon=True)]
    for t in threads:
        t.start()
    try:
        time.sleep(1.5)               # commits and heartbeats flowing
        prim.proc.kill()              # SIGKILL mid-commit-loop
        time.sleep(4.0)               # promotion and post-failover load
        stop.set()
        load.stop()
        for t in threads:
            t.join(timeout=5.0)
        assert not pub_errors, f"[{name}] publisher failures across " \
            f"the failover: {pub_errors[:3]}"
        assert not torn, f"[{name}] {torn[:2]}"
        assert not regressed, f"[{name}] manifest regressed: {regressed}"
        done, _snap = _assert_ledger(router, load, name)
        st = fetch_status(stand.addr)
        assert st.get("coord_role") == "primary", \
            f"[{name}] the standby never promoted: {st.get('coord_role')}"
        assert int(st.get("epoch", 0)) >= 1, \
            f"[{name}] promotion without an epoch bump: {st.get('epoch')}"
        assert int(st.get("manifest") or 0) >= published[0] - 1, \
            f"[{name}] the manifest lost commits: {st.get('manifest')} " \
            f"against {published[0]} published"
        with open(os.path.join(mdir, "EPOCH")) as f:
            fence = int(f.read().strip())
        assert fence >= 1, f"[{name}] EPOCH fence not stamped: {fence}"
        roles = {r: e.get("role") for r, e in st["ranks"].items()}
        assert all(e["alive"] or e["finished"]
                   for r, e in st["ranks"].items()
                   if roles.get(r) == "replica"), \
            f"[{name}] replicas lost after the failover: {st['ranks']}"
        print(f"fleet {name} OK: {done} requests 0 failed, "
              f"{published[0]} steps published 0 errors, standby "
              f"promoted epoch={st['epoch']}, manifest "
              f"{st.get('manifest')} never torn, roles={roles}",
              flush=True)
        return {"requests": done, "published": published[0],
                "epoch": int(st["epoch"]), "manifest": st.get("manifest"),
                "p99_ms": load.p99_ms(), "children": [r0, r1]}
    finally:
        stop.set()
        load.stop()
        router.stop()
        try:
            pub.close(goodbye=False)
        except Exception:
            pass
        _stop_all([r0.proc, r1.proc])
        _kill_all([prim.proc, stand.proc])
        shutil.rmtree(mdir, ignore_errors=True)


def scenario_scale_failover():
    """The autoscaler attached to a warm standby's status plane, its
    primary SIGKILLed: the standby promotes (epoch bump) with the
    ``autoscaler`` section in its status (gangtop's footer), the
    controller keeps ticking and counts no decision across the failover
    (ref ``tools/fleet_smoke.py:783-830``)."""
    from paddle_tpu_torch.distributed.coordinator import GangCoordinator
    from paddle_tpu_torch.tools.gangtop import render

    prim, = _spawn_many([["--world", 1]], role="coordinator")
    standby = GangCoordinator(1, port=0, heartbeat_timeout_s=HB_TIMEOUT,
                              standby_of=prim.addr).start()
    # min == max == 1 pins the fleet: any scale count is a flap
    rig = _ScaleRig(max_replicas=1)
    rig.scaler.attach_to(standby)
    rig.scaler.start()
    load = OpenLoopLoad(rig.router, n_clients=4, think_s=0.01).start()
    try:
        time.sleep(1.0)
        ctr_before = _scale_totals()
        ticks0 = rig.scaler.status()["ticks"]
        prim.proc.kill()             # SIGKILL the primary coordinator
        _wait_until(lambda: standby.status_snapshot()
                    .get("coord_role") == "primary",
                    20.0, "[scale+coord] standby promotion")
        time.sleep(1.0)              # post-failover ticks and traffic
        load.stop()
        st = standby.status_snapshot()
        assert int(st.get("epoch", 0)) >= 1, \
            f"[scale+coord] promotion without an epoch bump: {st}"
        asc = st.get("autoscaler")
        assert isinstance(asc, dict) and asc.get("target") == 1, \
            f"[scale+coord] the autoscaler section is missing from the " \
            f"promoted standby's status: {asc}"
        assert _scale_totals() == ctr_before, \
            f"[scale+coord] the autoscaler flapped across the failover: " \
            f"{ctr_before} -> {_scale_totals()}"
        assert rig.scaler.status()["ticks"] > ticks0, \
            "[scale+coord] the controller loop died across the failover"
        done, _snap = _assert_ledger(rig.router, load, "scale+coord")
        txt = render(st)
        assert "fleet: TGT=1" in txt, txt
        print(f"fleet scale+coord OK: {done} requests 0 failed, standby "
              f"promoted epoch={st['epoch']}, controller ticking, no "
              f"scale flap, gangtop footer renders", flush=True)
        with rig._mu:
            children = list(rig.procs.values())
        return {"requests": done, "epoch": int(st["epoch"]),
                "children": children}
    finally:
        load.stop()
        standby.stop()
        rig.close()
        _kill_all([prim.proc])


#: every label pair the autoscaler counts: the drill asserts the whole
#: ledger, so a decision under a wrong reason still fails
_SCALE_LABELS = (("up", "burn_queue"), ("up", "death"), ("up", "oom"),
                 ("down", "idle"), ("down", "surplus"))


def _scale_totals():
    from paddle_tpu_torch import monitor as M
    return {(d, r): _ctr(M.FLEET_SCALE_CTR, dir=d, reason=r)
            for d, r in _SCALE_LABELS}


def _wait_until(cond, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out after {deadline_s:.0f}s waiting "
                         f"for {what}")


class _ScaleRig:
    """A FleetRouter over replica processes with spawn and retire closures
    wired into a FleetAutoscaler.  The spawn closure waits for ``READY
    <addr>``; the retire closure is the drain contract (SIGTERM and wait:
    the child exits 0 iff it dropped nothing)."""

    def __init__(self, max_replicas=2, interval_s=0.25,
                 shed_enabled=False, backoff_s=None, delay_ms=20.0):
        from paddle_tpu_torch.flags import set_flags
        from paddle_tpu_torch.serving.autoscaler import (AutoscalerPolicy,
                                                         FleetAutoscaler)
        from paddle_tpu_torch.serving.fleet import FleetRouter
        self._mu = threading.Lock()
        self.procs = {}              # addr -> Child     guarded-by: _mu
        self.retired = {}            # addr -> exit code  guarded-by: _mu
        self._next_rank = 0          # guarded-by: _mu
        self.probe_failures = []     # guarded-by: _mu
        # simulated service time per dispatch (max_batch 4): a spike's
        # backlog lands in the scheduler's queue, where srv_q sees it
        self._delay_ms = float(delay_ms)
        addr = self.spawn_fn()
        self.router = FleetRouter([addr], digest_ttl_s=1.0).start()
        # hysteresis and cooldown sized to the drill's 0.25 s ticks
        policy = AutoscalerPolicy(
            min_replicas=1, max_replicas=max_replicas, queue_high=3.0,
            idle_qps=0.5, up_ticks=2, down_ticks=4, cooldown_ticks=6,
            shed_after_ticks=2, shed_enabled=shed_enabled,
            initial_target=1)
        if backoff_s is not None:
            set_flags({"FLAGS_fleet_spawn_backoff_s": float(backoff_s)})
        try:
            self.scaler = FleetAutoscaler(self.router, self.spawn_fn,
                                          self.retire_fn, policy=policy,
                                          interval_s=interval_s)
        finally:
            if backoff_s is not None:
                set_flags({"FLAGS_fleet_spawn_backoff_s": 10.0})

    def spawn_fn(self):
        with self._mu:
            rank = self._next_rank
            self._next_rank += 1
        child = _spawn(["--rank", rank, "--batch-delay-ms",
                        self._delay_ms])
        with self._mu:
            self.procs[child.addr] = child
        try:
            _probe_against_expected([child.addr], f"spawned rank {rank}")
        except AssertionError as e:
            # the autoscaler's thread counts a raising spawn as failed and
            # retries; the drill's waits fail on the record at once
            with self._mu:
                self.probe_failures.append(str(e))
            raise
        return child.addr

    def until(self, cond, deadline_s, what):
        """``_wait_until``, failing at once when a spawned replica failed
        its probe."""
        def checked():
            with self._mu:
                bad = list(self.probe_failures)
            assert not bad, bad[0]
            return cond()
        _wait_until(checked, deadline_s, what)

    def retire_fn(self, addr):
        with self._mu:
            child = self.procs.get(addr)
        if child is None or child.proc.poll() is not None:
            return
        child.proc.send_signal(signal.SIGTERM)  # drain, never a kill
        code = _wait_exit(child.proc, timeout_s=60.0)
        with self._mu:
            self.retired[addr] = code

    def live(self):
        return len(self.live_addrs())

    def live_addrs(self):
        return [a for a, r in self.router.replica_view().items()
                if r["state"] in ("up", "stale")]

    def kill_replica(self, addr):
        with self._mu:
            child = self.procs.get(addr)
        if child is not None:
            child.proc.kill()

    def calibrate_slo(self, factor=3.0):
        """One client on the seed replica measures a queue-free baseline
        p99; the fleet objective is ``factor`` times it, so the spike
        breaches and light traffic recovers on any host.  Returns (the
        calibration load, the objective in ms)."""
        from paddle_tpu_torch.serving.slo import BurnRateEvaluator, SLOTarget
        cal = OpenLoopLoad(self.router, n_clients=1, think_s=0.01).start()
        time.sleep(1.5)
        cal.stop()
        base = cal.p99_ms()
        assert base > 0, "SLO calibration produced no latencies"
        thresh = max(factor * base, 5.0)
        # threshold 5: a breach needs >= 5% of the window over the
        # objective (a spike is ~100%), recovery tolerates 2.5% stragglers
        self.router.slo = BurnRateEvaluator(
            {"*": SLOTarget(p99_ms=thresh)},
            fast_window_s=1.5, slow_window_s=3.0, threshold=5.0)
        return cal, thresh

    def close(self):
        self.scaler.stop()
        self.router.stop()
        with self._mu:
            procs = [c.proc for c in self.procs.values()]
        _stop_all(procs)


def scenario_scale(inject_spawn=False):
    """Load spike -> exactly one counted scale-up -> p99 back under the
    objective with no failure; SIGKILL under load -> the target restored;
    sustained idle -> exactly one drain-retire.  ``inject_spawn`` fails the
    first spawn: the controller backs off, sheds while the breach lasts,
    retries after the backoff and never counts the decision again."""
    from paddle_tpu_torch import monitor as M
    from paddle_tpu_torch import resilience as R
    from paddle_tpu_torch.flags import set_flags

    name = "scale+inject" if inject_spawn else "scale"
    ctr0 = _scale_totals()
    n_children0 = len(CHILDREN)

    def delta(d, r):
        return _ctr(M.FLEET_SCALE_CTR, dir=d, reason=r) - ctr0[(d, r)]

    dead_rr0 = _ctr(M.FLEET_REROUTE_CTR, reason="dead")
    fault0 = _ctr(R._FAULT_CTR, site="autoscaler.spawn")
    if inject_spawn:
        set_flags({"FLAGS_fault_inject": "autoscaler.spawn:once"})
    rig = _ScaleRig(shed_enabled=inject_spawn,
                    backoff_s=1.0 if inject_spawn else None)
    loads = []
    try:
        cal, thresh = rig.calibrate_slo()
        loads.append(cal)
        rig.scaler.start()

        # -- phase 1: spike -> one scale-up, shed only while spawning ----
        spike = OpenLoopLoad(rig.router, n_clients=24, think_s=0.002,
                             shed_ok=inject_spawn).start()
        loads.append(spike)
        shed_seen = [False]

        def scaled_up():
            if rig.router.snapshot().get("shedding"):
                shed_seen[0] = True
            return rig.live() >= 2

        t_spike = time.perf_counter()
        rig.until(scaled_up, 300.0, f"[{name}] scale-up to 2 replicas")
        scale_up_s = time.perf_counter() - t_spike
        time.sleep(1.0)              # the new replica takes spike load
        spike.stop()
        assert delta("up", "burn_queue") == 1, \
            f"[{name}] scale-up not counter-exact: " \
            f"{delta('up', 'burn_queue'):.0f}"
        assert delta("up", "death") == 0 and delta("up", "oom") == 0, \
            f"[{name}] spurious up counts: {_scale_totals()}"
        if inject_spawn:
            faults = _ctr(R._FAULT_CTR, site="autoscaler.spawn") - fault0
            assert faults == 1, f"[{name}] injected ledger: {faults}"
            assert rig.scaler.status()["spawn_failures"] == 1
            assert shed_seen[0], \
                f"[{name}] shed never engaged while the spawn was " \
                "in flight / backing off"

        # -- recovery: breach clears, shed releases, p99 under the SLO ----
        rec = OpenLoopLoad(rig.router, n_clients=4, think_s=0.01,
                           shed_ok=inject_spawn).start()
        loads.append(rec)

        def recovered():
            st = rig.router.slo.evaluate()
            return bool(st) and not any(v["breached"]
                                        for v in st.values())

        rig.until(recovered, 60.0, f"[{name}] SLO breach recovery")
        rec.stop()
        # a fresh window after the breach cleared: rec's own p99 still
        # carries the tail of the transient
        post = OpenLoopLoad(rig.router, n_clients=4, think_s=0.01,
                            shed_ok=inject_spawn).start()
        loads.append(post)
        time.sleep(1.5)
        post.stop()
        p99_rec = post.p99_ms()
        assert p99_rec < thresh, \
            f"[{name}] p99 did not return under the objective: " \
            f"{p99_rec:.0f}ms >= {thresh:.0f}ms"
        if inject_spawn:
            assert not rig.router.snapshot()["shedding"], \
                f"[{name}] shed still engaged after recovery"

        # -- phase 2: SIGKILL under load -> death repair to the target ----
        kill_load = OpenLoopLoad(rig.router, n_clients=6, think_s=0.005,
                                 shed_ok=inject_spawn).start()
        loads.append(kill_load)
        time.sleep(0.8)
        rig.kill_replica(rig.live_addrs()[0])
        rig.until(lambda: delta("up", "death") == 1
                    and rig.live() >= 2,
                    300.0, f"[{name}] death repair back to target")
        time.sleep(1.0)
        kill_load.stop()
        deads = _ctr(M.FLEET_REROUTE_CTR, reason="dead") - dead_rr0
        assert deads >= 1, f"[{name}] no dead re-route was recorded"
        assert delta("up", "burn_queue") == 1, \
            f"[{name}] repair recounted the scale-up decision"

        # -- phase 3: sustained idle -> exactly one drain-retire ----------
        rig.until(lambda: delta("down", "idle") == 1
                    and rig.live() == 1,
                    120.0, f"[{name}] idle drain-retire")
        assert delta("down", "surplus") == 0, \
            f"[{name}] surplus flap: {_scale_totals()}"

        def _retire_recorded():
            with rig._mu:
                return len(rig.retired) == 1

        rig.until(_retire_recorded, 60.0,
                    f"[{name}] retired child exit record")
        with rig._mu:
            retired = dict(rig.retired)
        assert len(retired) == 1 and all(c == 0
                                         for c in retired.values()), \
            f"[{name}] retired replica dropped work: {retired}"

        # -- ledger + controller liveness --------------------------------
        total_done, total_errors, total_sheds = 0, [], 0
        for ld in loads:
            done, errors = ld.counts()
            total_done += done
            total_errors += errors
            with ld._mu:
                total_sheds += len(ld.sheds)
        assert not total_errors, \
            f"[{name}] client-visible failures: {total_errors[:5]} " \
            f"({len(total_errors)} total)"
        snap = rig.router.snapshot()
        assert snap["failed"] == 0, f"[{name}] router failures: {snap}"
        assert snap["completed"] == snap["admitted"] == total_done, \
            f"[{name}] ledger does not sum: admitted=" \
            f"{snap['admitted']} completed={snap['completed']} " \
            f"client-done={total_done}"
        assert snap["rejected"] == total_sheds, \
            f"[{name}] rejected={snap['rejected']} != " \
            f"sheds={total_sheds}"
        if not inject_spawn:
            assert total_sheds == 0, \
                f"[{name}] shed engaged without the flag"
        st = rig.scaler.status()
        assert st["target"] == 1 and st["size"] == 1, st
        ticks0 = st["ticks"]
        time.sleep(0.7)
        assert rig.scaler.status()["ticks"] > ticks0, \
            f"[{name}] controller loop died"
        print(f"fleet {name} OK: {total_done} requests 0 failed "
              f"({total_sheds} shed), 1 scale-up 1 death-repair "
              f"1 idle-retire (exit 0), p99 {p99_rec:.0f}ms < "
              f"SLO {thresh:.0f}ms", flush=True)
        return {"requests": total_done, "sheds": total_sheds,
                "scale_up": delta("up", "burn_queue"),
                "death_repair": delta("up", "death"),
                "idle_retire": delta("down", "idle"),
                "retired_rc": list(retired.values()),
                "scale_up_s": scale_up_s, "p99_spike_ms": spike.p99_ms(),
                "p99_recovered_ms": p99_rec, "slo_p99_ms": thresh,
                "dead_reroutes": deads,
                "children": CHILDREN[n_children0:]}
    finally:
        if inject_spawn:
            set_flags({"FLAGS_fault_inject": ""})
        for ld in loads:
            ld.stop()
        rig.close()


def bench_fleet():
    """``--bench``: two-replica QPS, the p99 while the autoscaler absorbs a
    spike, the p99 under a replica SIGKILL."""
    rig = _ScaleRig()
    try:
        _, thresh = rig.calibrate_slo()
        rig.scaler.start()

        spike = OpenLoopLoad(rig.router, n_clients=24,
                             think_s=0.002).start()
        rig.until(lambda: rig.live() >= 2, 300.0, "bench scale-up")
        time.sleep(1.0)
        spike.stop()
        p99_spike = spike.p99_ms()

        steady = OpenLoopLoad(rig.router, n_clients=6,
                              think_s=0.005).start()
        t0 = time.monotonic()
        time.sleep(2.0)
        steady.stop()
        done, _ = steady.counts()
        qps = done / max(time.monotonic() - t0, 1e-9)

        kill_load = OpenLoopLoad(rig.router, n_clients=6,
                                 think_s=0.005).start()
        time.sleep(0.5)
        rig.kill_replica(rig.live_addrs()[0])
        time.sleep(2.5)
        kill_load.stop()
        p99_kill = kill_load.p99_ms()

        print("FLEET BENCH " + json.dumps({
            "aggregate_qps": round(qps, 2),
            "p99_spike_ms": round(p99_spike, 2),
            "p99_kill_ms": round(p99_kill, 2),
            "slo_p99_ms": round(thresh, 2),
            "replicas": 2}), flush=True)
    finally:
        rig.close()
    return 0


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def _result_line(results):
    out = {}
    for name, res in results.items():
        out[name] = {k: v for k, v in res.items() if k != "children"}
        out[name]["children"] = [c.record() for c in res["children"]]
    return "FLEET RESULT " + json.dumps(
        {"width": _CFG["width"], "cpu": _CFG["cpu"],
         "request_tokens": REQUEST_TOKENS[_CFG["width"]],
         "scenarios": out}, default=float)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--role", choices=("driver", "replica", "coordinator"),
                    default="driver")
    ap.add_argument("--scenario", nargs="+",
                    choices=("drain", "kill", "coord", "scale"),
                    default=None, help="run these scenarios (driver)")
    ap.add_argument("--full", action="store_true",
                    help="after the default scenarios, their "
                         "fault-injection variants (slow)")
    ap.add_argument("--bench", action="store_true",
                    help="numbers only; prints one 'FLEET BENCH {json}' "
                         "line")
    ap.add_argument("--cpu", action="store_true",
                    help="replicas on the host (the default is cuda:0)")
    ap.add_argument("--width", choices=sorted(WIDTHS), default="tiny")
    ap.add_argument("--weights", default="",
                    help="the replicas' weights, saved by "
                         "io.save_persistables from the serving GPT of "
                         "--width (default: seeded weights written to a "
                         "temporary directory); needs --expect")
    ap.add_argument("--expect", default="",
                    help="a .npy file: the probe's logits from an "
                         "in-process server over the --weights")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1,
                    help="replica / coordinator role: the gang's size")
    ap.add_argument("--coord", default="",
                    help="replica role: register with the gang "
                         "coordinator(s) at these addresses")
    ap.add_argument("--manifest-dir", default="",
                    help="coordinator role: the manifest directory")
    ap.add_argument("--standby-of", default="",
                    help="coordinator role: run as this primary's warm "
                         "standby")
    ap.add_argument("--batch-delay-ms", type=float, default=0.0,
                    help="replica role: simulated per-dispatch service "
                         "time (the scale drill's saturation knob)")
    args = ap.parse_args(argv)
    if args.role == "replica":
        return replica_main(args)
    if args.role == "coordinator":
        return coordinator_main(args)
    if bool(args.weights) != bool(args.expect):
        ap.error("--weights and --expect go together")
    _CFG.update(cpu=bool(args.cpu), width=args.width)
    wdir = tempfile.mkdtemp(prefix="paddle_tpu_torch_fleet_")
    _CFG["weights"] = args.weights or os.path.join(wdir, "weights")
    try:
        if args.weights:
            _CFG["expect"] = np.load(args.expect)
        else:
            t_w = time.perf_counter()
            _CFG["expect"] = write_weights(args.width, _CFG["weights"],
                                           args.cpu)
            print(f"weights ({args.width}) written in "
                  f"{time.perf_counter() - t_w:.1f} s", flush=True)
        if args.bench:
            return bench_fleet()
        scenarios = {"drain": scenario_drain, "kill": scenario_kill,
                     "coord": scenario_coord, "scale": scenario_scale}
        results = {}
        for name in args.scenario or ("drain", "kill", "coord", "scale"):
            results[name] = scenarios[name]()
        if args.full and not args.scenario:
            results["kill+inject"] = scenario_kill(inject_forward=True)
            results["coord+inject"] = scenario_coord(inject_frame=True)
            results["scale+inject"] = scenario_scale(inject_spawn=True)
            results["scale+coord"] = scenario_scale_failover()
        print("FLEET SMOKE PASS", flush=True)
        print(_result_line(results), flush=True)
    finally:
        _kill_all([c.proc for c in CHILDREN])
        shutil.rmtree(wdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
