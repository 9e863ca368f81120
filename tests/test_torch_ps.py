"""The port's parameter server (``distributed/ps.py`` over its own copy of
the C++ KV server, ``csrc/ps_server.cc``) against the JAX package's, on
the CPU: the server, the client, the ops and the transpiler (the training
flows are in ``test_torch_ps_train.py``, the processes in
``test_torch_ps_fleet.py``).

- the counterparts of ``tests/test_ps.py``'s server and client tests (KV
  round trip and server SGD, sparse rows, typed bf16 and int64 tables, the
  bounded retry on a dead server and the reconnect across a restart, the
  CRC rejecting a corrupt frame) and of its ``distributed_lookup_table``
  test, with the reference test's checks;
- the wire: the port's client against the reference's server and the
  reference's client against the port's server, dense and sparse tables;
- bf16 typed-table bits equal the reference's (round to nearest even);
- the transpiled trainer and pserver programs (op types, ``epmap``,
  ``param_specs``, startup ops) equal the reference's for the CTR model and
  a 2-layer GPT, each spec's ``lr`` the optimizer's; the fusion pass keeps
  the PS ops in program order; a pserver's startup reproduces the
  trainer's tables only where it draws in the trainer's order, in both
  packages alike;
- the async puller writes onto the scope's device, and the
  ``listen_and_serv`` lowering refuses to run inside a block;
- the runner's 2-layer GPT over a pserver in three processes: the trainers
  bit for bit, the first loss one process's.

Every test that starts a server sets ``FLAGS_rpc_deadline`` to at most
10000 ms (``_ps_helpers.fresh_ps_state``), stops and destroys (or joins)
the server in a ``finally``, joins threads with a timeout and asserts
they ended, and picks ports with a bound socket.  The server library
builds on first use: a failed build fails the tests, none skips.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.distributed import ps as ref_ps
from paddle_tpu_torch import flags
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.framework import Program, Scope, core, program_guard
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.models import ctr
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.tools import ps_runner
from _port_fixtures import collect_garbage_after_module  # noqa: F401
from _ps_helpers import fresh_ps_state  # noqa: F401
from _ps_helpers import (CHILD_TIMEOUT_S, DEADLINE_MS, JOIN_S, PORT, REF,
                         REPO, RUNNER, free_port, host, isolated, regression,
                         server, serving)


# ---------------------------------------------------------------------------
# the server and client
# ---------------------------------------------------------------------------

def test_kv_roundtrip_and_server_sgd():
    with server(PORT, 0, 1, True, [
            {"name": "w", "size": 4, "optimizer": "sgd", "lr": 0.5}]) as s:
        cli = ps.PSClient(f"127.0.0.1:{s.port}")
        cli.put("w", np.array([1.0, 2.0, 3.0, 4.0], np.float32))
        np.testing.assert_allclose(cli.get("w", 4), [1, 2, 3, 4])
        # a tensor goes in as its values
        cli.push_dense("w", torch.ones(4))
        np.testing.assert_allclose(cli.get("w", 4), [0.5, 1.5, 2.5, 3.5])
        cli.close()


def test_sparse_rows():
    with server(PORT, 0, 1, False, [
            {"name": "emb", "size": 12, "rows": 4, "optimizer": "sgd",
             "lr": 1.0}]) as s:
        cli = ps.PSClient(f"127.0.0.1:{s.port}")
        cli.put("emb", np.arange(12, dtype=np.float32))
        np.testing.assert_allclose(cli.get_rows("emb", [2, 0], width=3),
                                   [[6, 7, 8], [0, 1, 2]])
        cli.push_sparse("emb", [1], np.array([[1.0, 1.0, 1.0]], np.float32))
        np.testing.assert_allclose(cli.get_rows("emb", [1], width=3),
                                   [[2, 3, 4]])           # -= 1 * g
        cli.close()


@pytest.mark.parametrize("port_client", [True, False],
                         ids=["port_client", "ref_client"])
def test_wire_compatible_with_the_reference(port_client):
    """One wire format: the port's client drives the reference's server,
    and the reference's client the port's, over a dense and a sparse
    table (put, get, push, get_rows, the server's SGD)."""
    srv_pkg, cli_pkg = (REF, PORT) if port_client else (PORT, REF)
    with server(srv_pkg, 0, 1, True, [
            {"name": "w", "size": 4, "optimizer": "sgd", "lr": 0.5},
            {"name": "emb", "size": 12, "rows": 4, "optimizer": "sgd",
             "lr": 1.0}]) as s:
        cli = cli_pkg.ps.PSClient(f"127.0.0.1:{s.port}")
        cli.put("w", np.array([1.0, 2.0, 3.0, 4.0], np.float32))
        cli.push_dense("w", np.ones(4, np.float32))
        np.testing.assert_array_equal(cli.get("w", 4),
                                      [0.5, 1.5, 2.5, 3.5])
        cli.put("emb", np.arange(12, dtype=np.float32))
        cli.push_sparse("emb", [3, 1],
                        np.array([[1, 1, 1], [2, 2, 2]], np.float32))
        np.testing.assert_array_equal(
            cli.get_rows("emb", [1, 3, 0], width=3),
            [[1, 2, 3], [8, 9, 10], [0, 1, 2]])
        np.testing.assert_array_equal(
            s.get_param("emb", 12),
            [0, 1, 2, 1, 2, 3, 6, 7, 8, 8, 9, 10])
        cli.close()


def test_typed_bf16_table():
    """bf16 values ride the wire as bf16; the server keeps a float32
    master and runs the optimizer on it."""
    with server(PORT, 0, 1, True, []) as s:
        cli = ps.PSClient(f"127.0.0.1:{s.port}")
        vals = np.array([0.5, -1.25, 3.0, 1e-3], np.float32)
        as_bf16 = torch.from_numpy(vals).bfloat16().float().numpy()
        cli.put_typed("emb", vals, "bfloat16")
        np.testing.assert_array_equal(cli.get_typed("emb", 4, "bfloat16"),
                                      as_bf16)
        # default SGD at lr 0.01: w -= lr * g
        cli.push_typed("emb", torch.ones(4, dtype=torch.bfloat16),
                       torch.bfloat16)
        got = cli.get_typed("emb", 4, torch.bfloat16)
        want = torch.from_numpy(as_bf16 - 0.01).bfloat16().float().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-2)
        with pytest.raises(RuntimeError):        # a loud dtype mismatch
            cli.get_typed("emb", 4, np.int64)
        cli.close()


def test_bf16_bits_equal_the_reference():
    """The port builds the bf16 payload itself (the top 16 bits, rounded
    to nearest even, as ``csrc/bf16.h``): the bits the reference's client
    sends and reads back are the port's, ties and subnormals included."""
    import ml_dtypes
    bf16 = ml_dtypes.bfloat16
    rng = np.random.RandomState(0)
    vals = np.concatenate([
        rng.randn(64).astype(np.float32) * 10.0 ** rng.randint(-6, 6, 64),
        np.array([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8),
                  1e-40, 3.3895314e38, 0.0, -0.0], np.float32)])
    np.testing.assert_array_equal(
        ps._bf16_bits(vals), vals.astype(bf16).view(np.uint16))
    with server(PORT, 0, 1, True, []) as s:
        ep = f"127.0.0.1:{s.port}"
        ps.get_client(ep).put_typed("p", vals, "bfloat16")
        ref_ps.get_client(ep).put_typed("r", vals.astype(bf16), bf16)
        from_ref = ps.get_client(ep).get_typed("r", vals.size, "bfloat16")
        from_port = ref_ps.get_client(ep).get_typed("p", vals.size, bf16)
        np.testing.assert_array_equal(
            from_ref.view(np.uint32) >> 16, from_port.view(np.uint16))
        np.testing.assert_array_equal(
            from_ref, vals.astype(bf16).astype(np.float32))


def test_typed_int64_counter_table():
    """int64 tables are exact beyond 2^31 and accumulate on push."""
    with server(PORT, 0, 1, True, []) as s:
        cli = ps.PSClient(f"127.0.0.1:{s.port}")
        big = np.array([2**40 + 7, 5, -3, 2**33], np.int64)
        cli.put_typed("clicks", big, np.int64)
        np.testing.assert_array_equal(cli.get_typed("clicks", 4, np.int64),
                                      big)
        cli.push_typed("clicks", torch.ones(4, dtype=torch.int64),
                       torch.int64)
        np.testing.assert_array_equal(cli.get_typed("clicks", 4, np.int64),
                                      big + 1)
        cli.close()


def test_typed_int64_sparse_rows():
    with server(PORT, 0, 1, True, []) as s:
        cli = ps.PSClient(f"127.0.0.1:{s.port}")
        table = np.arange(12, dtype=np.int64)            # 4 rows x 3
        cli.put_typed("freq", table, np.int64)
        cli.push_typed("freq", np.full(6, 100, np.int64), np.int64,
                       rows=[1, 3])
        want = table.reshape(4, 3).copy()
        want[[1, 3]] += 100
        np.testing.assert_array_equal(
            cli.get_typed("freq", 12, np.int64).reshape(4, 3), want)
        cli.close()


def test_client_retry_bounded_on_dead_server():
    """A killed server surfaces a clean client error after the bounded
    retry budget, not a hang."""
    flags.set_flags({"FLAGS_rpc_deadline": 500, "FLAGS_rpc_retry_times": 2})
    srv = ps.PSServer(0, 1, True, [
        {"name": "w", "size": 2, "optimizer": "sgd", "lr": 0.1}])
    port = srv.start()
    cli = ps.PSClient(f"127.0.0.1:{port}")
    try:
        np.testing.assert_allclose(cli.get("w", 2), [0, 0])
    finally:
        srv.stop()
        srv.destroy()
    t0 = time.time()
    with pytest.raises(RuntimeError):
        cli.get("w", 2)
    assert time.time() - t0 < 30
    cli.close()


def test_client_retry_recovers_across_server_restart():
    """An idempotent request reconnects and succeeds when the server comes
    back on the same port."""
    flags.set_flags({"FLAGS_rpc_deadline": 2000, "FLAGS_rpc_retry_times": 4})
    port = free_port()
    spec = [{"name": "w", "size": 2, "optimizer": "sgd", "lr": 0.1}]
    srv = ps.PSServer(port, 1, True, spec)
    srv.start()
    cli = ps.PSClient(f"127.0.0.1:{port}")
    try:
        cli.put("w", np.array([1.0, 2.0], np.float32))
    finally:
        srv.stop()
        srv.destroy()
    revived = {}

    def revive():
        time.sleep(0.8)
        s2 = ps.PSServer(port, 1, True, spec)
        s2.start()
        revived["server"] = s2
    th = threading.Thread(target=revive)
    th.start()
    try:
        np.testing.assert_allclose(cli.get("w", 2), [0, 0])  # fresh init
    finally:
        th.join(JOIN_S)
        assert not th.is_alive()
        cli.close()
        if "server" in revived:
            revived["server"].stop()
            revived["server"].destroy()


def test_transport_crc_rejects_corrupt_frame():
    """A corrupted push is rejected before any table mutation (the CRC
    covers the whole frame) and the stream is dropped."""
    with server(PORT, 0, 1, True, [
            {"name": "w", "size": 4, "optimizer": "sgd", "lr": 0.5}]) as s:
        cli = ps.PSClient(f"127.0.0.1:{s.port}")
        cli.put("w", np.array([1.0, 2.0, 3.0, 4.0], np.float32))
        payload = np.array([9.0] * 4, np.float32).tobytes()
        frame = (struct.pack("<B", 2) + struct.pack("<H", 1) + b"w" +
                 struct.pack("<I", 0) + struct.pack("<Q", len(payload)) +
                 payload + struct.pack("<I", 0xDEADBEEF))
        with socket.create_connection(("127.0.0.1", s.port),
                                      timeout=10) as raw:
            raw.sendall(frame)
            resp = b""
            while len(resp) < 8:
                chunk = raw.recv(8 - len(resp))
                if not chunk:
                    break
                resp += chunk
            assert resp == b"\xfe" + b"\xff" * 7
            assert raw.recv(1) == b""
        np.testing.assert_allclose(cli.get("w", 4), [1, 2, 3, 4])
        # the frame CRC is IEEE CRC-32 (the published check value)
        lib = ps.ps_native.load()
        import ctypes
        assert lib.ptn_crc32(0, ctypes.c_char_p(b"123456789"), 9) == \
            0xCBF43926
        cli.close()


def test_distributed_lookup_table_op():
    port = free_port()
    with server(PORT, port, 1, False, [
            {"name": "embtab", "size": 20, "rows": 5, "optimizer": "sgd",
             "lr": 1.0}]):
        ps.PSClient(f"127.0.0.1:{port}").put(
            "embtab", np.arange(20, dtype=np.float32))
        with isolated(PORT) as sc:
            ids = ptt.layers.data("ids", shape=[3], dtype="int64")
            helper = LayerHelper("distributed_lookup_table")
            out = helper.create_variable_for_type_inference("float32")
            helper.append_op("distributed_lookup_table",
                             inputs={"Ids": [ids]},
                             outputs={"Outputs": [out]},
                             attrs={"endpoint": f"127.0.0.1:{port}",
                                    "table_name": "embtab", "emb_dim": 4})
            assert tuple(out.shape) == (-1, 3, 4)      # no RPC to infer it
            exe = PORT.exe()
            exe.run(core.default_startup_program(), scope=sc)
            got, = exe.run(feed={"ids": np.array([[0, 2, 4]], np.int64)},
                           fetch_list=[out], scope=sc)
        np.testing.assert_allclose(got[0, 0], [0, 1, 2, 3])
        np.testing.assert_allclose(got[0, 1], [8, 9, 10, 11])
        np.testing.assert_allclose(got[0, 2], [16, 17, 18, 19])


def test_communicator_pulls_onto_the_scope_device():
    """The async puller writes the server's values back as tensors where
    the scope holds them, and ``stop`` joins it."""
    with isolated(PORT) as sc:
        loss = regression(PORT, "wc")
        opt.SGD(learning_rate=0.1).minimize(loss)
        ep = f"127.0.0.1:{free_port()}"
        t = ps.DistributeTranspiler()
        t.transpile(0, pservers=ep, trainers=1, sync_mode=False)
        with serving(PORT, t, ep):
            PORT.exe().run(core.default_startup_program(), scope=sc)
            ps.get_client(ep).put("wc", np.arange(4, dtype=np.float32))
            comm = ps.Communicator(t, scope=sc, send_interval_s=0.01)
            comm.start()
            deadline = time.time() + JOIN_S
            while time.time() < deadline and not np.array_equal(
                    host(sc.find_var("wc")).ravel(), np.arange(4)):
                time.sleep(0.01)
            comm.stop(timeout=JOIN_S)
            got = sc.find_var("wc")
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            assert got.dtype == torch.float32 and tuple(got.shape) == (4, 1)
            np.testing.assert_array_equal(got.numpy().ravel(), np.arange(4))


def test_listen_and_serv_lowering_refuses():
    from paddle_tpu_torch.framework import registry
    info = registry.get_op_info("listen_and_serv")
    with pytest.raises(RuntimeError, match="host-side blocking op"):
        info.lower(None, {}, {})


# ---------------------------------------------------------------------------
# the transpiled programs against the reference's
# ---------------------------------------------------------------------------

def _ctr(pkg, make_opt):
    loss, _, _ = pkg.ctr.build_ctr_train(sparse_dim=50, embed_size=8,
                                         is_sparse=True)
    make_opt(pkg).minimize(loss)


def _gpt(pkg, make_opt):
    cfg = pkg.T.BertConfig(vocab_size=48, d_model=16, n_layer=2, n_head=2,
                           d_inner=32, max_pos=8, dropout=0.0)
    _, _, loss = pkg.T.build_gpt_pretrain(cfg, 8, fused_head=True,
                                          attn_impl="flash", dropout=0.0)
    make_opt(pkg).minimize(loss)


_OPTS = {
    "sgd": (lambda pkg: pkg.opt.SGD(learning_rate=0.2), 0.2),
    "momentum": (lambda pkg: pkg.opt.MomentumOptimizer(0.05, 0.8), 0.05),
    "adagrad": (lambda pkg: pkg.opt.AdagradOptimizer(0.03), 0.03),
    "adam": (lambda pkg: pkg.opt.AdamOptimizer(1e-3, beta1=0.8,
                                               beta2=0.99), 1e-3),
}


def _transpiled(pkg, build, opt_name, mode, trainers=2):
    """(trainer program's op list, pserver programs' attrs, startup op
    types per endpoint) of the model transpiled for two endpoints."""
    eps = "127.0.0.1:7001,127.0.0.1:7002"
    cfg = pkg.ps.DistributeTranspilerConfig(
        geo_sgd_mode=mode == "geo", geo_sgd_need_push_nums=5,
        sync_mode=mode == "sync")
    with isolated(pkg):
        build(pkg, _OPTS[opt_name][0])
        t = pkg.ps.DistributeTranspiler(cfg)
        t.transpile(1, pservers=eps, trainers=trainers)
        trainer = t.get_trainer_program()
        ops = [(op.type, {k: v for k, v in op.attrs.items()
                          if k in ("epmap", "send_varnames",
                                   "recv_varnames", "shapes", "is_sparse",
                                   "padding_idx", "with_barrier",
                                   "endpoint", "table_name", "emb_dim",
                                   "scale")},
                sorted((k, list(v)) for k, v in op.inputs.items()),
                sorted((k, list(v)) for k, v in op.outputs.items()))
               for op in trainer.global_block().ops]
        servers, startups = {}, {}
        for ep in eps.split(","):
            prog, start = t.get_pserver_programs(ep)
            lsv, = prog.global_block().ops
            servers[ep] = dict(lsv.attrs)
            startups[ep] = sorted(
                (op.type, tuple(op.output_arg_names()))
                for op in start.global_block().ops)
        return ops, servers, startups, trainer._attrs.get("is_distributed")


@pytest.mark.parametrize("model,opt_name,mode", [
    ("ctr", "sgd", "sync"), ("ctr", "adam", "async"), ("ctr", "sgd", "geo"),
    ("gpt", "adam", "sync"), ("gpt", "momentum", "async"),
    ("gpt", "adagrad", "sync")])
def test_transpiled_programs_equal_the_reference(model, opt_name, mode):
    """The trainer program (op types, epmap, send / recv names, shapes,
    the sparse rewrite and its scale), each endpoint's param_specs and its
    startup ops equal the reference's for the CTR model and a 2-layer GPT;
    every spec's lr is the optimizer's."""
    build = {"ctr": _ctr, "gpt": _gpt}[model]
    got = _transpiled(PORT, build, opt_name, mode)
    want = _transpiled(REF, build, opt_name, mode)
    assert got[3] is True and want[3] is True
    assert [o[0] for o in got[0]] == [o[0] for o in want[0]]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    lr = _OPTS[opt_name][1]
    specs = [s for attrs in got[1].values() for s in attrs["param_specs"]]
    assert specs and all(s["lr"] == (1.0 if mode == "geo" else
                                     pytest.approx(lr, rel=1e-6))
                         for s in specs)
    if mode != "geo":
        assert {s["optimizer"] for s in specs} == {opt_name}


def test_fusion_keeps_the_ps_ops_in_order():
    """The executor's fusion pass re-emits a trainer program in dependency
    order; the PS ops keep their program order among themselves (a
    ``recv`` after every ``send`` of its step, a lookup fence between the
    pulls and the pushes), while the MLP still fuses."""
    from paddle_tpu_torch.analysis.fusion import fuse_program
    from paddle_tpu_torch.framework import ir
    from paddle_tpu_torch.tools.ps_runner import fence_lookups
    with isolated(PORT):
        loss, _, _ = ctr.build_ctr_train(sparse_dim=50, embed_size=8,
                                         is_sparse=True)
        opt.SGD(learning_rate=0.2).minimize(loss)
        t = ps.DistributeTranspiler()
        t.transpile(0, pservers="127.0.0.1:7001", trainers=2)
        trainer = t.get_trainer_program()
        fence_lookups(trainer, ["127.0.0.1:7001"])
        fused = fuse_program(trainer, [loss.name], feed_shapes={
            "dense": (16, 13), "sparse": (16, 26), "click": (16, 1)})
    assert fused is not trainer
    assert "fused_dense_act" in [op.type for op in fused.global_block().ops]

    def ps_ops(prog):
        return [(op.type, tuple(op.input_arg_names()))
                for op in prog.global_block().ops
                if op.type in ir.ORDERED_OPS]
    want = ps_ops(trainer)
    assert [o[0] for o in want] == [
        "distributed_lookup_table", "distributed_lookup_table",
        "fetch_barrier", "send", "send", "send", "recv"]
    assert ps_ops(fused) == want


@pytest.mark.parametrize("servers", [1, 2])
def test_pserver_startup_matches_the_trainer_only_in_draw_order(servers):
    """A pserver's startup runs the subset of the startup ops that make its
    tables; its random tables equal the trainer's only where the subset
    draws in the trainer's order (one pserver: all; two: each one's first
    random table), in both packages alike.  So a trainer that must start
    from the server's values (on the card: a host server, a card trainer)
    puts them."""
    eps = ",".join(f"127.0.0.1:{7001 + i}" for i in range(servers))

    def same(pkg, seed):
        with isolated(pkg) as sc:
            loss, _, _ = pkg.ctr.build_ctr_train(sparse_dim=50, embed_size=8,
                                                 is_sparse=True)
            pkg.opt.SGD(learning_rate=0.2).minimize(loss)
            t = pkg.ps.DistributeTranspiler()
            t.transpile(0, pservers=eps, trainers=2)
            kw = {} if seed is None else {"seed": seed}
            pkg.exe().run(pkg.core.default_startup_program(), scope=sc,
                          **kw)
            out = {}
            for ep in eps.split(","):
                _, start = t.get_pserver_programs(ep)
                ssc = pkg.scope.Scope()
                pkg.exe().run(start, scope=ssc, **kw)
                for name, where in t._param_eps.items():
                    if where == ep:
                        out[name] = np.array_equal(
                            host(ssc.find_var(name)),
                            host(sc.find_var(name)))
            return out
    got, want = same(PORT, 1234), same(REF, None)
    assert got == want
    assert all(got.values()) == (servers == 1)


def test_gpt_over_a_pserver_through_the_runner():
    """``tools/ps_runner.py --model gpt``: a pserver and two trainers of
    the 2-layer GPT (Adam on the server) with their roles on the command
    line; the trainers hold the same dense parameters after every step, and
    trainer 0's first loss is the same program's on one process from the
    same startup seed."""
    env = dict(os.environ, FLAGS_rpc_deadline=str(DEADLINE_MS),
               CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PYTEST_CURRENT_TEST", None)
    common = ["--cpu", "--port", str(free_port()), "--trainers", "2",
              "--model", "gpt", "--batch", "2", "--steps", "3"]
    procs = [subprocess.Popen(
        [sys.executable, RUNNER, *common, *role], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
        for role in (["--role", "pserver"],
                     ["--role", "trainer", "--trainer_id", "0"],
                     ["--role", "trainer", "--trainer_id", "1"])]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(JOIN_S)
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    r0, r1 = (json.loads([ln for ln in out.splitlines()
                          if ln.startswith("RESULT ")][0][len("RESULT "):])
              for out, _ in outs[1:])
    assert r0["digests"] == r1["digests"] and len(r0["losses"]) == 3
    assert np.isfinite(r0["losses"]).all()
    cfg = ps_runner.gpt_config()
    main, startup = Program(), Program()
    with program_guard(main, startup):
        _, _, loss = T.build_gpt_pretrain(cfg, cfg.max_pos, fused_head=True,
                                          attn_impl="auto", dropout=0.0)
    sc, exe = Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=sc, seed=ps_runner.SEED)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, cfg.vocab_size, (2, cfg.max_pos)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = 0
    want, = exe.run(main, feed={"src_ids": ids, "lm_label": labels},
                    fetch_list=[loss], scope=sc)
    np.testing.assert_allclose(r0["losses"][0], float(want), rtol=1e-5)
