"""Parameter-server training: the port of ``paddle_tpu/distributed/ps.py``
(ref SURVEY §2.5 PS path).

The runtime is the port's own copy of the native KV server
(``csrc/ps_server.cc``, built and loaded by :mod:`..ps_native`):

- ``DistributeTranspiler`` (ref ``transpiler/distribute_transpiler.py:212,
  476``) rewrites a trained program into a trainer program (optimizer ops
  removed; ``send`` grad / ``recv`` param ops appended) and per-endpoint
  pserver programs (one ``listen_and_serv`` op carrying the param table
  and the server-side optimizer config; the native server applies them in
  C++).
- ``send`` / ``recv`` / ``distributed_lookup_table`` (ref
  ``operators/distributed_ops/``) run in place in the trainer's op list:
  the eager executor makes the host RPC between two ops.  A trainer's ops
  run on its place (the card by default); only the pushed and pulled bytes
  cross to the host.  The reference pins a PS step to the host CPU, since
  its jitted ``io_callback`` s cannot run on the accelerator.
- ``Communicator`` (ref ``operators/distributed/communicator.h:162``): the
  async param puller; ``GeoCommunicator``: geo-SGD (local steps, periodic
  param-delta push).
- sync semantics: the server accumulates each grad until every trainer
  pushed, applies the update once, and ``recv`` blocks until applied (the
  RunSyncLoop barrier structure, ``listen_and_serv_op.cc:109-183``).

Tables are float32 numpy on the host.  A client method takes numpy or a
``torch.Tensor`` on any device and returns numpy.  Params are placed
round-robin (ref ``ps_dispatcher.py`` RoundRobin) at whole-param
granularity; sparse tables shard by row.

``STATS`` counts a trainer's PS traffic (bytes each way, and the host
seconds of the copies and RPCs of ``send``, ``recv`` and
``distributed_lookup_table``); ``reset_stats()`` zeroes it.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import monitor as _monitor
from .. import ps_native
from .. import resilience as _resil
from ..framework import core
from ..framework.core import Program
from ..framework.registry import register_op
from ..framework.scope import global_scope
from ..ops.common import X, XS

OPTIM_IDS = {"sgd": 0, "momentum": 1, "adagrad": 2, "adam": 3}

#: a trainer's PS traffic: bytes pushed / pulled, and host seconds waiting
#: for the device before a push's copy, copying to the host, pushing,
#: pulling, and copying back to the device
STATS = {"bytes_pushed": 0, "bytes_pulled": 0, "device_wait_s": 0.0,
         "d2h_s": 0.0, "push_s": 0.0, "pull_s": 0.0, "h2d_s": 0.0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k.endswith("_s") else 0


# ---------------------------------------------------------------------------
# client registry
# ---------------------------------------------------------------------------

_clients: Dict[str, "PSClient"] = {}
_clients_lock = threading.Lock()

#: per-site retry policy cache: (retry_times, deadline_ms) -> policy, so the
#: no-failure hot path pays one flag read and a dict probe per RPC
_policy_cache: Dict[tuple, "_resil.RetryPolicy"] = {}

#: per-endpoint RPC latency: wall time of the whole ``_rpc`` envelope
#: (native transport retries included), per endpoint and op
_PS_RPC_HIST = _monitor.REGISTRY.histogram(
    "paddle_tpu_ps_rpc_ms",
    "parameter-server RPC wall time (ms) per endpoint and op (ps.put / "
    "ps.get / ps.push_dense / ps.push_sparse / ...), native transport "
    "retries included; circuit-open fail-fast rejections are excluded "
    "(they never touch the wire — see "
    "paddle_tpu_retry_circuit_open_total)",
    ("endpoint", "op"),
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
             100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
             30000.0, 120000.0, 300000.0))


def _rpc(site: str, fn, breaker: "Optional[_resil.CircuitBreaker]" = None):
    """Run one RPC attempt-function under the INJECTED-fault retry policy.

    The native client owns transport retries (``FLAGS_rpc_retry_times``
    with backoff and reconnect); it alone knows whether a request reached
    the wire and refuses to replay a possibly-applied push.  So this
    wrapper retries only the transient faults raised above the transport
    (``FLAGS_fault_inject``), while native errors surface once the native
    budget is spent.

    ``breaker`` (the client's per-endpoint circuit breaker,
    ``FLAGS_rpc_circuit_break_secs``): once a call exhausts its retry
    budget on transient failures, later calls fail fast with
    ``CircuitOpenError`` for the cool-down; a deterministic failure (a
    server verdict) closes it, since the endpoint answered."""
    from ..flags import get_flags
    if breaker is not None:
        breaker.check(site)
    fl = get_flags(["FLAGS_rpc_retry_times", "FLAGS_rpc_deadline"])
    key = (int(fl["FLAGS_rpc_retry_times"]), int(fl["FLAGS_rpc_deadline"]))
    policy = _policy_cache.get(key)
    if policy is None:
        policy = _policy_cache[key] = _resil.RetryPolicy.from_flags(site)
    endpoint = (breaker.name if breaker is not None and breaker.name
                else "local")
    t0 = time.perf_counter()
    try:
        out = _resil.retry_call(site, fn, policy=policy,
                                retryable=_resil.is_transient)
    except Exception as e:
        if breaker is not None:
            if _resil.is_transient(e) or \
                    _resil.is_transient(getattr(e, "__cause__", None)
                                        or e):
                breaker.record_giveup()
            else:
                breaker.record_success()
        raise
    finally:
        _PS_RPC_HIST.observe((time.perf_counter() - t0) * 1e3,
                             endpoint=endpoint, op=site)
    if breaker is not None:
        breaker.record_success()
    return out


def _host(value) -> np.ndarray:
    """``value`` as a host numpy array (a tensor leaves its device; bf16
    widens to float32, which is exact)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


def _bf16_bits(value) -> np.ndarray:
    """The bf16 wire payload: a bf16 tensor's own bits, or float32 values
    rounded to nearest even on the dropped 16 bits (``csrc/bf16.h``)."""
    if isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
        return value.detach().cpu().contiguous().view(torch.int16) \
            .numpy().view(np.uint16).ravel()
    bits = np.ascontiguousarray(_host(value), np.float32).ravel() \
        .view(np.uint32)
    lsb = (bits >> 16) & 1
    return ((bits + np.uint32(0x7FFF) + lsb) >> 16).astype(np.uint16)


def _typed_code(dtype):
    """(wire code, host element dtype): float32 0, bfloat16 1 (carried as
    its uint16 bits, float32 on the host), int64 2."""
    if dtype in (torch.bfloat16, "bfloat16") or \
            getattr(dtype, "__name__", "") == "bfloat16" or \
            str(dtype) == "bfloat16":
        return 1, np.dtype(np.uint16)
    if dtype in (torch.int64, torch.float32):
        dtype = str(dtype).replace("torch.", "")
    d = np.dtype(dtype)
    if d == np.dtype(np.int64):
        return 2, d
    if d == np.dtype(np.float32):
        return 0, d
    raise ValueError(
        f"typed PS tables support float32/bfloat16/int64, got {d}")


class PSClient:
    """ctypes wrapper over the native client (ref grpc_client.h RPCClient).

    ``FLAGS_rpc_retry_times`` / ``FLAGS_rpc_deadline`` govern the native
    transport retry loop (read at connect and on every request); every RPC
    also runs under ``_rpc``, so ``FLAGS_fault_inject`` sites (``ps.put``,
    ``ps.get``, ...) fire inside the attempt."""

    def __init__(self, endpoint: str):
        lib = ps_native.load()
        host, port = endpoint.rsplit(":", 1)
        if host in ("localhost", ""):
            host = "127.0.0.1"
        self._lib = lib
        # the native client reads FLAGS_rpc_deadline from the env at
        # connect time and FLAGS_rpc_retry_times on every request
        import os
        from ..flags import get_flags
        fl = get_flags(["FLAGS_rpc_deadline", "FLAGS_rpc_retry_times"])
        os.environ["FLAGS_rpc_deadline"] = str(int(
            fl["FLAGS_rpc_deadline"]))
        os.environ["FLAGS_rpc_retry_times"] = str(int(
            fl["FLAGS_rpc_retry_times"]))
        self._h = lib.ps_client_connect(host.encode(), int(port))
        if not self._h:
            raise ConnectionError(f"cannot connect to pserver {endpoint}")
        # one dead pserver must not make every call to it re-pay the full
        # retry backoff, nor poison calls to its peers
        self._breaker = _resil.CircuitBreaker(name=endpoint)

    @staticmethod
    def _check_dtype(dtype):
        if dtype is not None and np.dtype(dtype).itemsize != 4:
            raise ValueError(
                f"PS tables carry 4-byte elements; dtype={np.dtype(dtype)} "
                "cannot ride the wire format losslessly (use "
                "int32/uint32/float32)")

    def _buf(self, arr, dtype=None):
        self._check_dtype(dtype)
        a = _host(arr)
        if dtype is not None:
            # 4-byte non-float tables bit-cast through the float32 wire
            a = np.ascontiguousarray(a, dtype).view(np.float32)
        else:
            a = np.ascontiguousarray(a, np.float32)
        return a, a.ctypes.data_as(ctypes.c_void_p)

    def put(self, name: str, value, dtype=None) -> None:
        a, p = self._buf(value, dtype)    # dtype errors must NOT retry

        def _once():
            _resil.maybe_inject("ps.put")
            rc = self._lib.ps_client_put(self._h, name.encode(), p, a.size)
            if rc != 0:
                raise RuntimeError(
                    f"ps put({name}) failed (server down or "
                    "FLAGS_rpc_deadline exceeded?)")
        _rpc("ps.put", _once, breaker=self._breaker)

    def get(self, name: str, size: int, barrier: bool = True, dtype=None):
        self._check_dtype(dtype)
        out = np.empty(size, np.float32)
        fn = self._lib.ps_client_get if barrier else \
            self._lib.ps_client_get_nobarrier

        def _once():
            _resil.maybe_inject("ps.get")
            n = fn(self._h, name.encode(),
                   out.ctypes.data_as(ctypes.c_void_p), size)
            if n == -2:
                # a server verdict: never retried
                raise RuntimeError(f"ps get({name}): expected {size} "
                                   f"floats, got {n} (unknown table)")
            if n != size:
                raise RuntimeError(
                    f"ps get({name}): expected {size} floats, got {n} "
                    "(mis-sized table, server down, or FLAGS_rpc_deadline "
                    "exceeded?)")
        _rpc("ps.get", _once, breaker=self._breaker)
        if dtype is not None:
            return out.view(dtype)
        return out

    def push_dense(self, name: str, grad) -> None:
        a, p = self._buf(grad)

        def _once():
            _resil.maybe_inject("ps.push_dense")
            rc = self._lib.ps_client_push_dense(self._h, name.encode(), p,
                                                a.size)
            if rc != 0:
                raise RuntimeError(
                    f"ps push_dense({name}) failed — gradient would be "
                    "silently dropped (unknown table or server down)")
        _rpc("ps.push_dense", _once, breaker=self._breaker)

    def push_sparse(self, name: str, rows, grad) -> None:
        r = np.ascontiguousarray(_host(rows).ravel(), np.uint32)
        a, p = self._buf(grad)

        def _once():
            _resil.maybe_inject("ps.push_sparse")
            rc = self._lib.ps_client_push_sparse(
                self._h, name.encode(), r.ctypes.data_as(ctypes.c_void_p),
                len(r), p, a.size)
            if rc != 0:
                raise RuntimeError(
                    f"ps push_sparse({name}) failed — gradient would be "
                    "silently dropped (unknown table or server down)")
        _rpc("ps.push_sparse", _once, breaker=self._breaker)

    def get_rows(self, name: str, rows, width: int):
        r = np.ascontiguousarray(_host(rows).ravel(), np.uint32)
        out = np.empty(len(r) * width, np.float32)

        def _once():
            _resil.maybe_inject("ps.get_rows")
            n = self._lib.ps_client_get_rows(
                self._h, name.encode(), r.ctypes.data_as(ctypes.c_void_p),
                len(r), out.ctypes.data_as(ctypes.c_void_p), out.size)
            if n != out.size:
                raise RuntimeError(
                    f"ps get_rows({name}): expected {out.size} floats, got "
                    f"{n} (unknown table or wrong width?)")
        _rpc("ps.get_rows", _once, breaker=self._breaker)
        return out.reshape(len(r), width)

    def barrier(self) -> None:
        self._lib.ps_client_barrier(self._h)

    def stop_server(self) -> None:
        self._lib.ps_client_stop_server(self._h)

    # -- typed tables (ref VariableMessage.dtype, send_recv.proto.in:47):
    # bf16 tables ride the wire at half the bytes (float32 master on the
    # server); int64 tables (CTR show/click counters) are exact end to end
    # and accumulate on push.  bf16 values go out rounded to nearest even
    # (or as a bf16 tensor's own bits) and come back widened to float32.

    @staticmethod
    def _typed_payload(value, code, d):
        if code == 1:
            return np.ascontiguousarray(_bf16_bits(value))
        return np.ascontiguousarray(_host(value).ravel(), d)

    def put_typed(self, name: str, value, dtype) -> None:
        code, d = _typed_code(dtype)
        a = self._typed_payload(value, code, d)

        def _once():
            _resil.maybe_inject("ps.put_typed")
            rc = self._lib.ps_client_put_typed(
                self._h, name.encode(), a.ctypes.data_as(ctypes.c_void_p),
                a.size, code)
            if rc != 0:
                raise RuntimeError(f"ps put_typed({name}) failed")
        _rpc("ps.put_typed", _once, breaker=self._breaker)

    def get_typed(self, name: str, size: int, dtype):
        code, d = _typed_code(dtype)
        out = np.empty(size, d)

        def _once():
            _resil.maybe_inject("ps.get_typed")
            n = self._lib.ps_client_get_typed(
                self._h, name.encode(), out.ctypes.data_as(ctypes.c_void_p),
                size, code)
            if n == -2:
                raise RuntimeError(
                    f"ps get_typed({name}): expected {size} elems, got "
                    f"{n} (unknown table or dtype mismatch)")
            if n != size:
                raise RuntimeError(
                    f"ps get_typed({name}): expected {size} elems, got {n}")
        _rpc("ps.get_typed", _once, breaker=self._breaker)
        if code == 1:
            return (out.astype(np.uint32) << 16).view(np.float32)
        return out

    def push_typed(self, name: str, grad, dtype, rows=None) -> None:
        """int64 tables: accumulate-add (counters); bf16/f32 tables: run
        the table's optimizer against the float32 master.  ``rows`` selects
        per-row sparse application."""
        code, d = _typed_code(dtype)
        a = self._typed_payload(grad, code, d)
        if rows is None:
            rp, nr = None, 0
        else:
            r = np.ascontiguousarray(_host(rows).ravel(), np.uint32)
            rp, nr = r.ctypes.data_as(ctypes.c_void_p), len(r)

        def _once():
            _resil.maybe_inject("ps.push_typed")
            rc = self._lib.ps_client_push_typed(
                self._h, name.encode(), rp, nr,
                a.ctypes.data_as(ctypes.c_void_p), a.size, code)
            if rc != 0:
                raise RuntimeError(f"ps push_typed({name}) failed")
        _rpc("ps.push_typed", _once, breaker=self._breaker)

    def close(self) -> None:
        if self._h:
            self._lib.ps_client_destroy(self._h)
            self._h = None


def get_client(endpoint: str) -> PSClient:
    with _clients_lock:
        c = _clients.get(endpoint)
        if c is None:
            c = PSClient(endpoint)
            _clients[endpoint] = c
        return c


def reset_clients() -> None:
    with _clients_lock:
        for c in _clients.values():
            try:
                c.close()
            except Exception:
                pass
        _clients.clear()


# ---------------------------------------------------------------------------
# server (ref listen_and_serv_op.cc + grpc_server.cc)
# ---------------------------------------------------------------------------

class PSServer:
    """Owns one native server; built from a pserver program's
    ``listen_and_serv`` attrs and the initialized scope values (host
    copies of tensors on any device)."""

    def __init__(self, port: int, num_trainers: int, sync_mode: bool,
                 param_specs: List[dict], scope=None):
        lib = ps_native.load()
        self._lib = lib
        self._h = lib.ps_server_create(int(port), int(num_trainers),
                                       1 if sync_mode else 0)
        scope = scope or global_scope()
        for spec in param_specs:
            init = scope.find_var(spec["name"])
            val = np.ascontiguousarray(
                _host(init).ravel() if init is not None
                else np.zeros(spec["size"]), np.float32)
            lib.ps_server_add_param(
                self._h, spec["name"].encode(), val.size,
                val.ctypes.data_as(ctypes.c_void_p),
                OPTIM_IDS.get(spec.get("optimizer", "sgd"), 0),
                float(spec.get("lr", 0.01)), float(spec.get("hp1", 0.9)),
                float(spec.get("hp2", 0.999)),
                int(spec.get("rows", 0)))
        self.port = None

    def start(self) -> int:
        port = self._lib.ps_server_start(self._h)
        if port < 0:
            raise RuntimeError(f"pserver bind failed: {port}")
        self.port = port
        return port

    def wait(self) -> None:
        self._lib.ps_server_wait(self._h)

    def stop(self) -> None:
        self._lib.ps_server_stop(self._h)

    def get_param(self, name: str, size: int):
        out = np.empty(size, np.float32)
        n = self._lib.ps_server_get(self._h, name.encode(),
                                    out.ctypes.data_as(ctypes.c_void_p), size)
        return out[:max(n, 0)]

    def destroy(self) -> None:
        self._lib.ps_server_destroy(self._h)
        self._h = None


def run_pserver(op, scope, wait: bool = True) -> Optional[PSServer]:
    """Execute a ``listen_and_serv`` op on the host (``Executor.run`` hands
    a pserver program here before it builds any plan)."""
    attrs = op.attrs
    endpoint = attrs["endpoint"]
    port = int(endpoint.rsplit(":", 1)[1])
    server = PSServer(port, attrs.get("Fanin", 1),
                      attrs.get("sync_mode", True),
                      attrs.get("param_specs", []), scope)
    server.start()
    if wait:
        server.wait()
        server.destroy()
        return None
    return server


# ---------------------------------------------------------------------------
# trainer-side ops (ref operators/distributed_ops/send_op.cc, recv_op.cc,
# distributed_lookup_table_op.cc): host RPCs in place in the op list
# ---------------------------------------------------------------------------

def _no_infer(op, block) -> None:
    """PS ops make RPCs: shape inference never runs their lowerings."""


def _to_host_for(ctx, x, what: str) -> np.ndarray:
    """A trainer tensor on the host for a push.  A CUDA place never holds a
    parameter or gradient on the CPU: that raises.  The device's queued
    work is waited on first, so the copy's time is the copy's alone."""
    if ctx.device.type == "cuda" and x.device != ctx.device:
        raise RuntimeError(
            f"{what}: a tensor on {x.device} in a trainer whose place is "
            f"{ctx.device}; the executor holds every parameter and "
            "gradient on its device")
    t0 = time.perf_counter()
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    t1 = time.perf_counter()
    a = _host(x)
    STATS["device_wait_s"] += t1 - t0
    STATS["d2h_s"] += time.perf_counter() - t1
    return a


def _timed(key: str, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    STATS[key] += time.perf_counter() - t0
    return out


def _to_device(ctx, a: np.ndarray) -> torch.Tensor:
    t0 = time.perf_counter()
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(ctx.device)
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    STATS["h2d_s"] += time.perf_counter() - t0
    return t


@register_op("send", no_grad=True, infer=_no_infer)
def _send(ctx, ins, attrs):
    eps = attrs["epmap"]
    names = attrs["send_varnames"]
    is_sparse = attrs.get("is_sparse", [0] * len(names))
    xs = XS(ins, "X")
    rows_in = ins.get("Rows", [None] * len(xs))
    pad = int(attrs.get("padding_idx", -1))
    for x, ep, nm, sp, rows in zip(xs, eps, names, is_sparse, rows_in):
        v = _to_host_for(ctx, x, f"send({nm})")
        if sp and rows is not None:
            r = _host(rows).ravel()
            v = np.asarray(v, np.float32).reshape(len(r), -1)
            if pad >= 0:
                keep = r != pad     # padding rows carry no gradient
                r, v = r[keep], v[keep]
            if len(r):
                _timed("push_s", get_client(ep).push_sparse, nm, r, v)
                STATS["bytes_pushed"] += v.nbytes + 4 * len(r)
        else:
            _timed("push_s", get_client(ep).push_dense, nm, v)
            STATS["bytes_pushed"] += 4 * v.size
    return {}


@register_op("recv", no_grad=True, infer=_no_infer)
def _recv(ctx, ins, attrs):
    eps = attrs["epmap"]
    names = attrs["recv_varnames"]
    shapes = attrs["shapes"]
    barrier = attrs.get("with_barrier", True)
    outs = []
    for ep, nm, shape in zip(eps, names, shapes):
        size = int(np.prod(shape)) if shape else 1
        v = _timed("pull_s", get_client(ep).get, nm, size, barrier=barrier)
        STATS["bytes_pulled"] += 4 * size
        outs.append(_to_device(ctx, v.reshape(tuple(shape))))
    return {"Out": outs}


def _lookup_infer(op, block) -> None:
    ids = block.var(op.input("Ids")[0])
    if ids.shape is None:
        return
    shape = tuple(ids.shape)
    if len(shape) >= 2 and shape[-1] == 1:
        shape = shape[:-1]
    out = block.var(op.output("Outputs")[0])
    out.shape = shape + (int(op.attrs["emb_dim"]),)
    out.dtype = "float32"


@register_op("distributed_lookup_table", no_grad=True, infer=_lookup_infer)
def _distributed_lookup_table(ctx, ins, attrs):
    """Sparse embedding pull (ref distributed_lookup_table_op.cc +
    parameter_prefetch.cc): fetch only the queried rows from the owning
    pserver."""
    ids = X(ins, "Ids")
    ep = attrs["endpoint"]
    table = attrs["table_name"]
    width = attrs["emb_dim"]
    pad = int(attrs.get("padding_idx", -1))
    flat = _host(ids).reshape(-1)
    safe = np.where(flat == pad, 0, flat) if pad >= 0 else flat
    rows = _timed("pull_s", get_client(ep).get_rows, table,
                  np.asarray(safe, np.uint32), width)
    STATS["bytes_pulled"] += rows.nbytes
    out = _to_device(ctx, rows)
    if pad >= 0:
        # padding rows are zero, exactly as the local lookup_table kernel
        keep = torch.from_numpy(flat != pad).to(out.device)
        out = out * keep.to(out.dtype)[:, None]
    # mirror lookup_table's trailing dim-1 squeeze so rewritten programs
    # keep the shapes they were built with
    shape = tuple(ids.shape)
    if len(shape) >= 2 and shape[-1] == 1:
        shape = shape[:-1]
    return {"Outputs": [out.reshape(shape + (width,))]}


@register_op("fetch_barrier", no_grad=True, infer=_no_infer)
def _fetch_barrier(ctx, ins, attrs):
    for ep in attrs.get("endpoints", []):
        get_client(ep).barrier()
    return {}


register_op("send_barrier", lambda ctx, ins, attrs: {}, no_grad=True,
            infer=_no_infer)


@register_op("listen_and_serv", no_grad=True, infer=_no_infer)
def _listen_and_serv(ctx, ins, attrs):
    raise RuntimeError(
        "listen_and_serv is a host-side blocking op; Executor.run hands a "
        "pserver program to ps.run_pserver before building a plan — "
        "reaching this lowering means the pserver program was embedded "
        "in a larger block")


# ---------------------------------------------------------------------------
# transpiler (ref transpiler/distribute_transpiler.py)
# ---------------------------------------------------------------------------

class DistributeTranspilerConfig:
    """ref distribute_transpiler.py:131."""

    slice_var_up = True
    split_method = "RoundRobin"
    min_block_size = 8192
    sync_mode = True
    runtime_split_send_recv = False
    geo_sgd_mode = False
    geo_sgd_need_push_nums = 100

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


#: optimizer op types the transpiler moves to the pserver
PS_OPTIMIZER_OPS = {"sgd", "momentum", "adagrad", "adam"}


class DistributeTranspiler:
    """ref transpiler/distribute_transpiler.py DistributeTranspiler.

    ``transpile`` → ``get_trainer_program`` / ``get_pserver_program`` /
    ``get_startup_program``, the reference's call protocol.
    """

    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self._param_eps: Dict[str, str] = {}     # param -> endpoint
        self._param_specs: Dict[str, dict] = {}
        self._grad_of: Dict[str, str] = {}       # param -> grad var
        self._sparse_tables: Dict[str, list] = {}  # table -> lookup sites
        self._origin_program: Optional[Program] = None

    def transpile(self, trainer_id: int, program: Optional[Program] = None,
                  pservers: str = "127.0.0.1:6174", trainers: int = 1,
                  sync_mode: Optional[bool] = None, startup_program=None,
                  current_endpoint: str = ""):
        self.trainer_id = trainer_id
        self.trainer_num = trainers
        self.eps = pservers.split(",")
        if sync_mode is not None:
            self.config.sync_mode = sync_mode
        program = program or core.default_main_program()
        self._origin_program = program
        self._startup = startup_program or core.default_startup_program()
        block = program.global_block()

        # (param, grad, optimizer) triples from the optimize ops
        lr_value = self._find_lr_value()
        for op in block.ops:
            if op.type not in PS_OPTIMIZER_OPS:
                continue
            pname = op.input("Param")[0]
            gname = op.input("Grad")[0]
            pvar = block.var(pname)
            size = int(np.prod([d for d in pvar.shape if d > 0]))
            spec = {"name": pname, "size": size, "optimizer": op.type,
                    "lr": lr_value, "shape": [d for d in pvar.shape],
                    "rows": 0}
            if op.type == "momentum":
                spec["hp1"] = op.attrs.get("mu", 0.9)
            if op.type == "adam":
                spec["hp1"] = op.attrs.get("beta1", 0.9)
                spec["hp2"] = op.attrs.get("beta2", 0.999)
            self._param_specs[pname] = spec
            self._grad_of[pname] = gname
        # sparse embedding tables: a lookup_table marked is_sparse /
        # is_distributed becomes a row-sharded server table pulled by id;
        # the trainer never holds the full table.  A table may be looked
        # up at several sites (shared embedding): every site is recorded
        # and every site's row grads are pushed.
        self._sparse_tables = {}
        for op in block.ops:
            if op.type != "lookup_table" or not (
                    op.attrs.get("is_sparse") or
                    op.attrs.get("is_distributed")):
                continue
            w = op.input("W")[0]
            if w not in self._param_specs:
                continue
            wvar = block.var(w)
            self._param_specs[w]["rows"] = int(wvar.shape[0])
            self._sparse_tables.setdefault(w, []).append({
                "ids": op.input("Ids")[0],
                "out": op.output("Out")[0],
                "emb_dim": int(wvar.shape[1]),
                "padding_idx": op.attrs.get("padding_idx", -1),
            })
        # round-robin placement (ref ps_dispatcher.py RoundRobinDispatcher)
        for i, pname in enumerate(sorted(self._param_specs)):
            self._param_eps[pname] = self.eps[i % len(self.eps)]

    def _find_lr_value(self) -> float:
        for op in self._startup.global_block().ops \
                if self._startup is not None else []:
            if op.type == "fill_constant":
                out = op.output("Out")
                if out and "learning_rate" in out[0]:
                    return float(op.attrs.get("value", 0.01))
        return 0.01

    # -- trainer side --------------------------------------------------------
    def get_trainer_program(self, wait_port: bool = True) -> Program:
        """ref :814 — strip optimizer ops; append send(grad) + recv(param).

        geo-SGD mode keeps local optimizer ops (the GeoCommunicator pushes
        deltas outside the step)."""
        prog = self._origin_program.clone()
        block = prog.global_block()
        sparse = self._sparse_tables
        if not self.config.geo_sgd_mode:
            grad_prefixes = tuple(core.grad_var_name(w) for w in sparse)

            def _is_dense_table_grad(op):
                # drop the dense full-table grad of sparse params (and the
                # sum merging multi-site @RENAME@ pieces): row grads are
                # pushed instead
                outs = op.output_arg_names()
                return bool(outs) and all(
                    o.startswith(grad_prefixes) for o in outs)

            block.ops = [
                op for op in block.ops
                if op.type not in PS_OPTIMIZER_OPS and
                not (grad_prefixes and _is_dense_table_grad(op))]
            # sparse tables: each lookup site becomes a row pull from the
            # owning pserver, and only the touched rows' grads are pushed
            for w, sites in sparse.items():
                ep = self._param_eps[w]
                for site in sites:
                    for op in block.ops:
                        if op.type == "lookup_table" and \
                                op.input("W") == [w] and \
                                op.input("Ids") == [site["ids"]] and \
                                op.output("Out") == [site["out"]]:
                            op.type = "distributed_lookup_table"
                            op.inputs = {"Ids": [site["ids"]]}
                            op.outputs = {"Outputs": [site["out"]]}
                            op.attrs = {"endpoint": ep, "table_name": w,
                                        "emb_dim": site["emb_dim"],
                                        "padding_idx": site["padding_idx"]}
                            break
                    # d loss / d out rows ARE the per-id row grads; sync
                    # mode scales by 1/trainers client-side (the dense path
                    # divides server-side on apply; sparse rows apply as
                    # they arrive)
                    gname = core.grad_var_name(site["out"])
                    if self.trainer_num > 1:
                        block.append_op(
                            "scale", inputs={"X": [gname]},
                            outputs={"Out": [gname]},
                            attrs={"scale": 1.0 / self.trainer_num,
                                   "bias": 0.0,
                                   "bias_after_scale": False})
                    block.append_op(
                        "send",
                        inputs={"X": [gname], "Rows": [site["ids"]]},
                        outputs={},
                        attrs={"epmap": [ep], "send_varnames": [w],
                               "is_sparse": [1],
                               "padding_idx": site["padding_idx"]})
            by_ep: Dict[str, List[str]] = {}
            for pname, ep in self._param_eps.items():
                if pname in sparse:
                    continue
                by_ep.setdefault(ep, []).append(pname)
            for ep, pnames in sorted(by_ep.items()):
                block.append_op(
                    "send",
                    inputs={"X": [self._grad_of[p] for p in pnames]},
                    outputs={},
                    attrs={"epmap": [ep] * len(pnames),
                           "send_varnames": pnames})
                block.append_op(
                    "recv", inputs={},
                    outputs={"Out": pnames},
                    attrs={"epmap": [ep] * len(pnames),
                           "recv_varnames": pnames,
                           "shapes": [self._param_specs[p]["shape"]
                                      for p in pnames],
                           "with_barrier": self.config.sync_mode})
        prog._attrs["is_distributed"] = True
        return prog

    # -- pserver side --------------------------------------------------------
    def get_pserver_program(self, endpoint: str) -> Program:
        """ref :948 — one listen_and_serv op with this endpoint's shard."""
        prog = Program()
        specs = [self._param_specs[p]
                 for p, ep in sorted(self._param_eps.items())
                 if ep == endpoint]
        if self.config.geo_sgd_mode:
            # geo: trainers push param DELTAS; the server just adds them
            # (SGD with lr=1 on grad=-delta → value += delta)
            specs = [dict(s, optimizer="sgd", lr=1.0) for s in specs]
        prog.global_block().append_op(
            "listen_and_serv", inputs={}, outputs={},
            attrs={"endpoint": endpoint,
                   "Fanin": self.trainer_num,
                   "sync_mode": self.config.sync_mode and
                   not self.config.geo_sgd_mode,
                   "param_specs": specs})
        return prog

    def get_pserver_programs(self, endpoint: str):
        p = self.get_pserver_program(endpoint)
        return p, self.get_startup_program(endpoint, p)

    def get_startup_program(self, endpoint: str,
                            pserver_program: Optional[Program] = None
                            ) -> Program:
        """Startup for one pserver: create and init only its params."""
        prog = Program()
        blk = prog.global_block()
        src = self._startup.global_block()
        mine = {p for p, ep in self._param_eps.items() if ep == endpoint}
        for name in mine:
            v = src.var(name) if src.has_var(name) else None
            blk.create_var(name=name,
                           shape=v.shape if v else
                           self._param_specs[name]["shape"],
                           dtype=v.dtype if v else "float32",
                           persistable=True)
        for op in src.ops:
            outs = op.output_arg_names()
            if outs and all(o in mine for o in outs):
                blk.append_op(op.type, inputs=dict(op.inputs),
                              outputs=dict(op.outputs), attrs=dict(op.attrs))
        return prog


# ---------------------------------------------------------------------------
# async / geo communicators (ref operators/distributed/communicator.h,
# python/paddle/fluid/communicator.py)
# ---------------------------------------------------------------------------

def _scope_f32(scope, name: str) -> np.ndarray:
    """A scope value as a float32 host array (a copy when it lies on a
    device)."""
    return np.asarray(_host(scope.find_var(name)), np.float32)


def _scope_write(scope, name: str, value: np.ndarray) -> None:
    """Write a host value back where the scope holds the var: onto its
    tensor's device and dtype."""
    old = scope.find_var(name)
    t = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    if isinstance(old, torch.Tensor):
        t = t.to(device=old.device, dtype=old.dtype)
    scope.set_var(name, t)


class Communicator:
    """Async-mode background param PULLER (the RecvThread half of ref
    ``communicator.h``; the push half is the in-program ``send`` op, which
    applies at once in async mode).

    Use with a trainer program transpiled WITHOUT recv ops: with in-program
    recv, the step's own write-back would race these background writes."""

    def __init__(self, transpiler: DistributeTranspiler, scope=None,
                 send_interval_s: float = 0.01):
        self.t = transpiler
        self.scope = scope or global_scope()
        self.interval = send_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[Exception] = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        # a dead puller must not be silent: check()/stop() surface it
        # (ref communicator.h RecvThread glog-fatals on RPC error)
        try:
            while not self._stop.is_set():
                for pname, ep in self.t._param_eps.items():
                    spec = self.t._param_specs[pname]
                    fresh = get_client(ep).get(pname, spec["size"],
                                               barrier=False)
                    _scope_write(self.scope, pname,
                                 fresh.reshape(spec["shape"]))
                self._stop.wait(self.interval)
        except Exception as e:   # noqa: BLE001 — any RPC failure
            self.error = e

    def check(self):
        """Raise if the background puller died."""
        if self.error is not None:
            raise RuntimeError(
                "Communicator recv thread died; trainer was reading stale "
                "params") from self.error

    def stop(self, timeout: Optional[float] = None):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("Communicator recv thread did not end "
                                   f"within {timeout} s")
        self.check()


class GeoCommunicator:
    """geo-SGD (ref distribute_transpiler geo_sgd_mode + communicator_py):
    train locally; every ``push_nums`` steps push param deltas (the server
    adds them: SGD at lr 1 on -delta ≡ += delta) and pull the merged
    params.

    - **row recording**: :meth:`record_rows` reports the table rows each
      batch fed; at a push boundary only those rows are diffed and pushed.
      Without recording, a sparse table falls back to a full scan (and,
      when >= half the rows moved, to one dense round trip).
    - **async round trips** (``async_push=True``): the TCP push/pull runs
      on a background thread; the boundary step only gathers deltas and
      applies the previous round's merged rows.  Local updates made while
      a round is in flight are kept (``new = fresh + (cur − cur@push)``)
      and re-pushed next round.

    Snapshots and deltas are float32 numpy on the host; scope writes go
    back onto the device the scope holds each var on.
    """

    def __init__(self, transpiler: DistributeTranspiler, scope=None,
                 async_push: bool = False):
        self.t = transpiler
        self.scope = scope or global_scope()
        self.push_nums = transpiler.config.geo_sgd_need_push_nums
        self.async_push = async_push
        self._step = 0
        self._snapshots: Dict[str, np.ndarray] = {}
        self._touched: Dict[str, List[np.ndarray]] = {}
        self._worker: Optional[threading.Thread] = None
        self._worker_exc: Optional[BaseException] = None
        self._inflight: List[dict] = []

    def init_snapshots(self):
        for pname, spec in self.t._param_specs.items():
            v = _scope_f32(self.scope, pname)
            self._snapshots[pname] = v.copy()
            # seed the server with the initial value
            get_client(self.t._param_eps[pname]).put(pname, v.ravel())

    def record_rows(self, pname: str, rows) -> None:
        """Report the rows of sparse table ``pname`` fed this step (ref
        geo_sgd_communicator.cc sparse-id recording).  Deltas are then
        computed only on recorded rows at the boundary."""
        if pname not in self.t._param_specs:
            raise KeyError(
                f"record_rows({pname!r}): not a transpiled parameter "
                f"(known: {sorted(self.t._param_specs)})")
        self._touched.setdefault(pname, []).append(
            np.asarray(_host(rows), np.int64).ravel())

    def step(self):
        self._step += 1
        if self._step % self.push_nums:
            return
        self._join_and_apply()             # previous round (async mode)
        work = self._collect_deltas()
        if not work:
            return
        if self.async_push:
            def _run():
                try:
                    self._round_trip(work)
                except BaseException as e:   # surfaced at the next join
                    self._worker_exc = e
            self._worker = threading.Thread(target=_run, daemon=True)
            self._worker.start()
        else:
            self._round_trip(work)
            self._join_and_apply()

    def flush(self):
        """Drain the in-flight round and push any remaining local delta
        synchronously (call once at the end of training)."""
        self._join_and_apply()
        work = self._collect_deltas()
        if work:
            self._round_trip(work)
            self._join_and_apply()

    # -- boundary phases (all scope access happens on the caller's thread;
    #    the worker only moves bytes) --------------------------------------

    def _collect_deltas(self) -> List[dict]:
        work = []
        n = self.t.trainer_num
        for pname, ep in self.t._param_eps.items():
            spec = self.t._param_specs[pname]
            cur = _scope_f32(self.scope, pname)
            snap = self._snapshots[pname]
            recorded = self._touched.pop(pname, None)
            if spec.get("rows") and cur.ndim == 2:
                if recorded is not None:
                    rows = np.unique(np.concatenate(recorded))
                else:
                    rows = np.flatnonzero((cur != snap).any(axis=1))
                if rows.size == 0:
                    continue
                if rows.size * 2 < cur.shape[0]:
                    cur_rows = cur[rows].astype(np.float32, copy=True)
                    delta = (cur_rows - snap[rows]) / n
                    work.append({"pname": pname, "ep": ep, "rows": rows,
                                 "cur_at_push": cur_rows, "delta": delta,
                                 "width": cur.shape[1]})
                    continue
            # dense param — or a HOT sparse interval (>= half the rows
            # moved: one dense round trip beats per-row applies)
            delta = (cur - snap) / n
            work.append({"pname": pname, "ep": ep, "rows": None,
                         "cur_at_push": cur.copy(), "delta": delta,
                         "spec": spec})
        return work

    def _round_trip(self, work: List[dict]) -> None:
        # each param is appended as it completes: on a mid-list failure
        # the pushed params are applied (snapshots advanced) at the next
        # join, so a surviving caller cannot re-push a merged delta
        for w in work:
            cli = get_client(w["ep"])
            if w["rows"] is not None:
                cli.push_sparse(w["pname"], w["rows"],
                                (-w["delta"]).astype(np.float32))
                w["fresh"] = np.asarray(
                    cli.get_rows(w["pname"], w["rows"], width=w["width"]),
                    np.float32)
            else:
                cli.push_dense(w["pname"], -w["delta"].ravel())
                fresh = cli.get(w["pname"], w["spec"]["size"], barrier=False)
                w["fresh"] = fresh.reshape(w["spec"]["shape"]).astype(
                    np.float32)
            self._inflight.append(w)

    def _join_and_apply(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        exc, self._worker_exc = self._worker_exc, None
        # apply whatever completed BEFORE surfacing a failure: those deltas
        # are merged server-side, so their snapshots must advance
        work, self._inflight = self._inflight, []
        for w in work:
            pname = w["pname"]
            cur = _scope_f32(self.scope, pname)
            if w["rows"] is not None:
                rows, fresh = w["rows"], w["fresh"]
                new = np.array(cur, np.float32)       # writable copy
                if self.async_push:
                    # merged rows + local drift made while the round was
                    # in flight (snapshot := fresh keeps the drift in the
                    # next round's delta)
                    new[rows] = fresh + (cur[rows] - w["cur_at_push"])
                else:
                    # synchronous boundary: no step ran since the push
                    new[rows] = fresh
                self._snapshots[pname][rows] = fresh
                _scope_write(self.scope, pname, new)
            else:
                if self.async_push:
                    new = (w["fresh"] + (cur - w["cur_at_push"])).astype(
                        np.float32)
                else:
                    new = w["fresh"]
                self._snapshots[pname] = w["fresh"].copy()
                _scope_write(self.scope, pname, new)
        if exc is not None:
            raise RuntimeError("geo background push/pull failed") from exc
