"""Checkpoint daemon, preemption guard and resume: the port against the
JAX package, on the CPU.

- the daemon's cadence by steps and through the executor's step hook
  (``attach``) commits the same steps as the reference's daemon, and the
  restored state equals the live scope; a capture in chunks commits the
  same bits as one in a pass; the adaptive stretch, a background error
  and the anchor to the checkpoint's latest step behave as the
  reference's;
- the guard's emergency checkpoint in process (``trigger``), with and
  without a daemon, as the reference's;
- a gang (``gang=``, or the launcher's environment naming one) is taken
  by the daemon and the guard as the reference's;
- the tiny GPT of ``tools/preempt_runner.py`` (2 layers, d 64, 4 heads,
  seq 64, batch 2, Adam): 8 uninterrupted steps against 4 steps, an
  emergency checkpoint, and 4 more in a fresh ``Executor`` and scope after
  ``resume_or_init``: the losses equal bit for bit; the uninterrupted
  losses (the first bit for bit) within 1e-5 relative (the card-vs-host GPT-train
  tolerance of ``test_torch_cuda.py``) of the reference's, trained from
  the same weights.  The port-vs-reference 1e-6 of ``test_torch_train.py``
  does not hold at this width and learning rate: Adam's first step divides
  by ``sqrt(v) + eps``, an effective eps of 3.2e-7 on the gradient at
  lr 1e-4, so a gradient element of ~1e-7 that float32 rounding moves by
  ~3e-7 (gradients agree within 1.4e-6 of a largest 0.0195) steps by
  0.35 lr in one package and 0.59 lr in the other; the losses then differ
  by up to 3.1e-6 relative over 8 steps (measured);
- one SIGTERM drill through the runner in subprocesses, the step-boundary
  handshake in place of a sleep: (b) drains, checkpoints and exits 0,
  (c) restores (b)'s state bit for bit, and (b) + (c)'s losses equal an
  uninterrupted run's.
"""

import os
import signal

import jax
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import layers as ref_layers
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import optimizer as ref_opt
from paddle_tpu import resilience as ref_res
from paddle_tpu.checkpoint import CheckpointManager as RefManager
from paddle_tpu.framework import Executor as RefExecutor
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu.models import transformer as RT
from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import layers, monitor, optimizer
from paddle_tpu_torch import resilience as res
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.framework import core, scope, unique_name
from paddle_tpu_torch.tools import preempt_runner as pr
from _port_fixtures import collect_garbage_after_module  # noqa: F401

PKGS = ("ref", "port")


@pytest.fixture(autouse=True)
def _fresh():
    main, startup = core.Program(), core.Program()
    old_main = core.switch_main_program(main)
    old_startup = core.switch_startup_program(startup)
    scope._scope_stack.append(scope.Scope())
    with unique_name.guard():
        yield
    scope._scope_stack.pop()
    core.switch_main_program(old_main)
    core.switch_startup_program(old_startup)
    port_flags.set_flags({"FLAGS_fault_inject": ""})
    pt.set_flags({"FLAGS_fault_inject": ""})


class _Pkg:
    """One package's side of a comparison: a tiny fc + SGD program, its
    executor, scope and checkpoint manager."""

    def __init__(self, pkg, directory, max_to_keep=10):
        self.pkg = pkg
        self.res = ref_res if pkg == "ref" else res
        self.mon = ref_monitor if pkg == "ref" else monitor
        if pkg == "ref":
            self.main, startup = RefProgram(), RefProgram()
            with ref_guard(self.main, startup), ref_names.guard():
                x = ref_layers.data("x", shape=[4], dtype="float32")
                self.loss = ref_layers.mean(ref_layers.fc(
                    x, size=2, param_attr=pt.ParamAttr(name="cd_w")))
                ref_opt.SGD(0.1).minimize(self.loss)
            self.scope, self.exe = RefScope(), RefExecutor()
            self.ckpt = RefManager(directory, max_to_keep=max_to_keep)
        else:
            self.main, startup = core.Program(), core.Program()
            with core.program_guard(self.main, startup), unique_name.guard():
                x = layers.data("x", shape=[4], dtype="float32")
                self.loss = layers.mean(layers.fc(
                    x, size=2, param_attr=ptt.ParamAttr(name="cd_w")))
                optimizer.SGD(0.1).minimize(self.loss)
            self.scope, self.exe = scope.Scope(), ptt.Executor(
                ptt.CPUPlace())
            self.ckpt = CheckpointManager(directory,
                                          max_to_keep=max_to_keep)
        self.exe.run(startup, scope=self.scope)

    def step(self, i):
        x = np.random.RandomState(i).rand(4, 4).astype(np.float32)
        self.exe.run(self.main, feed={"x": x}, fetch_list=[self.loss],
                     scope=self.scope)

    def daemon(self, **kw):
        return self.res.CheckpointDaemon(self.ckpt, program=self.main,
                                         scope=self.scope, **kw)

    def value(self, sc, name="cd_w"):
        v = sc.find_var(name)
        return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def _both(tmp_path, fn, **kw):
    out = {}
    for pkg in PKGS:
        p = _Pkg(pkg, str(tmp_path / pkg), **kw)
        out[pkg] = fn(p)
        p.ckpt.close()
    return out


def test_daemon_step_cadence_equals_reference(tmp_path):
    def run(p):
        before = p.mon.counter_totals()
        daemon = p.daemon(interval_steps=3).start()
        took = []
        for i in range(8):
            p.step(i)
            took.append(daemon.step_completed(i + 1))
            if took[-1]:
                assert daemon.wait_committed(i + 1, timeout_s=60)
        last = daemon.stop(final_step=8)
        fresh = scope.Scope() if p.pkg == "port" else RefScope()
        restored = p.ckpt.restore(scope=fresh)
        assert np.array_equal(p.value(fresh), p.value(p.scope))
        after = p.mon.counter_totals()
        return (took, last, p.ckpt.all_steps(), restored,
                [after.get(k, 0) - before.get(k, 0) for k in (
                    "paddle_tpu_checkpoint_saves_total",
                    "paddle_tpu_checkpoint_commits_total",
                    "paddle_tpu_checkpoint_save_ms_count")])
    out = _both(tmp_path, run)
    assert out["port"] == out["ref"]
    assert out["port"][2] == [3, 6, 8]


def test_daemon_attach_cadence_equals_reference(tmp_path):
    def run(p):
        daemon = p.daemon(interval_steps=2).start()
        daemon.attach(p.exe)
        for i in range(5):
            p.step(i)
            if (i + 1) % 2 == 0:
                assert daemon.wait_committed(i + 1, timeout_s=60)
        daemon.stop()
        p.step(5)                   # detached: no longer counted
        return p.ckpt.all_steps(), daemon._auto_step
    out = _both(tmp_path, run)
    assert out["port"] == out["ref"] == ([2, 4], 5)


def test_chunked_capture_commits_the_same_bits(tmp_path):
    p = _Pkg("port", str(tmp_path / "a"))
    p.step(0)
    bits = []
    for i, chunk in enumerate((0, 1)):
        ckpt = CheckpointManager(str(tmp_path / f"c{i}"))
        d = res.CheckpointDaemon(ckpt, program=p.main, scope=p.scope,
                                 capture_chunk_mb=chunk)
        assert d.capture(1)
        d.stop()
        sc = scope.Scope()
        ckpt.restore(scope=sc)
        bits.append({n: ptt.io._to_numpy(sc.find_var(n)).tobytes()
                     for n, _ in sc.items()})
        ckpt.close()
    assert bits[0] == bits[1] and "cd_w" in bits[0]
    p.ckpt.close()


def test_stretch_background_error_and_anchor_equal_reference(tmp_path):
    def run(p):
        out = []
        before = p.mon.counter_totals().get(
            "paddle_tpu_checkpoint_cadence_stretched_total", 0)
        d = p.daemon(interval_steps=1, cadence_stretch_frac=0.5)
        d._last_save_s = 1000.0           # a writer far behind the cadence
        out += [d.due(1), d.due(2)]
        d._last_save_s = 0.0
        out.append(d.due(3))
        out.append(p.mon.counter_totals().get(
            "paddle_tpu_checkpoint_cadence_stretched_total", 0) - before)

        class Doomed:
            def save_arrays(self, *a, **k):
                raise OSError("disk gone")

        d = p.res.CheckpointDaemon(Doomed(), program=p.main,
                                   scope=p.scope, interval_steps=1)
        d.step_completed(1)
        try:                    # the daemon never started: stop drains
            d.stop()
        except RuntimeError as e:
            out.append(("stop raised", "daemon failed" in str(e)))
        p.step(0)
        p.ckpt.save(6, program=p.main, scope=p.scope)
        p.ckpt.wait_until_finished()
        d = p.daemon(interval_steps=2)
        out += [d._last_capture_step, d._auto_step,
                d.step_completed(7), d.step_completed(8)]
        d.stop()
        return out
    out = _both(tmp_path, run)
    assert out["port"] == out["ref"]
    assert out["port"] == [False, False, True, 1, ("stop raised", True),
                           6, 6, False, True]


def test_guard_emergency_checkpoint_equals_reference(tmp_path):
    def run(p):
        name = "paddle_tpu_preemption_signals_total"
        before = p.mon.counter_totals().get(name, 0)
        with p.res.PreemptionGuard(p.ckpt, executor=p.exe, program=p.main,
                                   scope=p.scope,
                                   exit_on_preempt=False) as guard:
            for i in range(8):
                p.step(i)
                guard.completed_step(i + 1)
                if i == 2:
                    guard.trigger(signal.SIGTERM)
                if guard.preempted:
                    break
        first = (p.ckpt.latest_step(),
                 p.mon.counter_totals().get(name, 0) - before)
        daemon = p.daemon(interval_steps=2).start()
        exit_code = None
        try:
            with p.res.PreemptionGuard(executor=p.exe, program=p.main,
                                       scope=p.scope, daemon=daemon,
                                       exit_code=3) as guard:
                for i in range(3, 8):
                    p.step(i)
                    guard.completed_step(i + 1)
                    if i == 4:
                        guard.trigger(signal.SIGTERM)
                    if guard.preempted:
                        break
        except SystemExit as e:
            exit_code = e.code
        return first, exit_code, daemon.last_committed, p.ckpt.all_steps()
    out = _both(tmp_path, run)
    assert out["port"] == out["ref"]
    assert out["port"] == ((3, 1), 3, 5, [3, 5])


def test_a_gang_raises(monkeypatch, tmp_path):
    """A gang no longer raises: the daemon and the guard take the gang
    given, or the launcher's (``GangRendezvous.from_env``: the file
    backend here), as the reference's do; one rank has none.  The gang
    protocol itself is ``tests/test_torch_gang.py``'s."""
    from paddle_tpu_torch.distributed.env import GangRendezvous
    ckpt = CheckpointManager(str(tmp_path / "c"))
    gang = GangRendezvous(str(tmp_path / "gang"), rank=0, world_size=1)
    daemon = res.CheckpointDaemon(ckpt, gang=gang)
    assert daemon.gang is gang
    assert res.PreemptionGuard(ckpt, daemon=daemon).gang is gang
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_GANG_DIR", str(tmp_path / "gang"))
    got = res.CheckpointDaemon(ckpt).gang
    want = ref_res.CheckpointDaemon(
        RefManager(str(tmp_path / "r"))).gang
    assert (got.backend, got.world_size, got.base_dir) == \
        (want.backend, want.world_size, want.base_dir) == \
        ("file", 2, str(tmp_path / "gang"))
    assert res.PreemptionGuard(ckpt).gang.base_dir == got.base_dir
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    assert res.CheckpointDaemon(ckpt).gang is None   # one rank: no gang
    ckpt.close()


# -- the tiny GPT -----------------------------------------------------------

STEPS = 8


def _port_gpt():
    with unique_name.guard():
        return pr.build("tiny")


def _train(main, loss, exe, sc, steps, guard=None):
    losses = []
    for i in steps:
        out, = exe.run(main, feed=pr.batch("tiny", i), fetch_list=[loss],
                       scope=sc)
        losses.append(pr._bits(out))
        if guard is not None:
            guard.completed_step(i + 1)
    return losses


def test_tiny_gpt_preempted_and_resumed_equals_uninterrupted(tmp_path):
    main, startup, loss = _port_gpt()
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc)
    init = ptt.io.params_to_numpy(sc)
    want = _train(main, loss, exe, sc, range(STEPS))

    ckpt = CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    assert res.resume_or_init(ckpt, exe, startup_program=startup,
                              main_program=main, scope=sc) == 0
    daemon = res.CheckpointDaemon(ckpt, program=main, scope=sc,
                                  interval_steps=3).start()
    with res.PreemptionGuard(ckpt, executor=exe, program=main, scope=sc,
                             daemon=daemon, exit_on_preempt=False) as g:
        got = _train(main, loss, exe, sc, range(STEPS // 2), guard=g)
        g.trigger()
    assert ckpt.all_steps() == [3, 4]
    saved = pr.digests(sc, main)

    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    start = res.resume_or_init(CheckpointManager(str(tmp_path / "run")),
                               exe, startup_program=startup,
                               main_program=main, scope=sc)
    assert start == STEPS // 2 and pr.digests(sc, main) == saved
    got += _train(main, loss, exe, sc, range(start, STEPS))
    assert got == want

    # the reference from the same weights, op by op (the fused head's bf16
    # rounding, as test_torch_train.py runs it)
    rmain, rstartup = RefProgram(), RefProgram()
    with ref_guard(rmain, rstartup), ref_names.guard():
        _, _, rloss = RT.build_gpt_pretrain(
            RT.BertConfig(**pr.SIZES["tiny"]["cfg"]), pr.SIZES["tiny"]["seq"],
            fused_head=True, attn_impl="flash", dropout=0.0)
        ref_opt.AdamOptimizer(pr.LR).minimize(rloss)
    rsc = RefScope()
    RefExecutor().run(rstartup, scope=rsc)
    assert set(init) >= {v.name for v in rmain.list_vars()
                         if v.persistable}
    for name, v in init.items():
        rsc.set_var(name, v)
    rexe = RefExecutor()
    ref_losses = []
    with jax.disable_jit():
        for i in range(STEPS):
            out, = rexe.run(rmain, feed=pr.batch("tiny", i),
                            fetch_list=[rloss], scope=rsc)
            ref_losses.append(float(np.asarray(out)))
    assert want[0] == pr._bits(ref_losses[0])      # before any update
    np.testing.assert_allclose([pr._loss(b) for b in want],
                               ref_losses, rtol=1e-5, atol=0)


def test_sigterm_drill_through_the_runner(tmp_path):
    # the uninterrupted baseline is a child of the same runner (threads
    # pinned, as in b and c), so the bitwise check holds child against
    # child; the in-process run, in a worker whose thread pools and load
    # the test does not control, ties the runner to the executor at 1e-5
    steps = 4
    main, startup, loss = _port_gpt()
    exe, sc = ptt.Executor(ptt.CPUPlace()), scope.Scope()
    exe.run(startup, scope=sc)
    here = _train(main, loss, exe, sc, range(steps))
    a = pr.spawn(str(tmp_path / "base"), steps, 1, "tiny", cpu=True,
                 timeout=120)
    assert a["threads"] == [pr.THREADS] * 2 and not a["preempted"]
    want = [a["losses"][str(i)] for i in range(steps)]
    np.testing.assert_allclose([pr._loss(x) for x in want],
                               [pr._loss(x) for x in here],
                               rtol=1e-5, atol=0)
    d = str(tmp_path / "run")
    b = pr.spawn(d, steps, 1, "tiny", cpu=True, pause_after=steps // 2,
                 env={"FLAGS_fault_inject": "checkpoint.write:once"},
                 timeout=120)
    c = pr.spawn(d, steps, 1, "tiny", cpu=True, timeout=120)
    assert b["threads"] == c["threads"] == [pr.THREADS] * 2
    assert b["paused"] and b["preempted"] and b["rc"] == 0
    assert b["committed"] == steps // 2 and c["start"] == steps // 2
    assert c["digests_start"] == b["digests_end"]
    assert b["counters"] == {"paddle_tpu_fault_injected_total": 1,
                             "paddle_tpu_retry_attempts_total": 1,
                             "paddle_tpu_retry_giveups_total": 0}
    got = [b["losses"][str(i)] for i in range(steps // 2)] + \
        [c["losses"][str(i)] for i in range(steps // 2, steps)]
    assert got == want
    assert c["all_steps"] == [3, 4] and os.path.isdir(os.path.join(d, "4"))
