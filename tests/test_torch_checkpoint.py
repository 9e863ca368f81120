"""The port's ``CheckpointManager`` against the JAX package's (orbax), on
the CPU.

- the same call sequence through both managers gives the same results:
  what each save returns (a step at or below the latest is refused,
  off-interval saves skipped), ``latest_step``, ``all_steps`` (keep-last-k),
  ``prune_after``, ``commit``, a reopened manager's steps, and the restored
  arrays bit for bit, bfloat16 included;
- ``save`` of a program's persistables restores bit for bit in both;
- ``checkpoint.write:once`` is absorbed by one retry in both (1 injected
  fault, 1 retry, 0 give-ups);
- the port's own format: ``<dir>/<step>/`` holds one ``.npy`` a var and
  ``__meta__.json``, nothing pickled; a write that fails in the background
  raises at the next call and keeps the kept steps; a writer's staging
  leftovers are cleared when a manager opens the directory.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import layers as ref_layers
from paddle_tpu import monitor as ref_monitor
from paddle_tpu.checkpoint import CheckpointManager as RefManager
from paddle_tpu.framework import Program as RefProgram
from paddle_tpu.framework import Scope as RefScope
from paddle_tpu.framework import program_guard as ref_guard
from paddle_tpu.framework import unique_name as ref_names
from paddle_tpu_torch import checkpoint as port_ckpt
from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers, monitor
from paddle_tpu_torch.framework import core, scope, unique_name
from _port_fixtures import collect_garbage_after_module  # noqa: F401

Manager = port_ckpt.CheckpointManager


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


def _state(seed):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2 ** 16, (3, 5)).astype(np.uint16)
    bits[(bits & 0x7f80) == 0x7f80] = 0x3f80     # no NaN / inf patterns
    return {"w": rng.randn(4, 3).astype(np.float32),
            "step_ct": np.array([seed], np.int64),
            "h": bits.view(ml_dtypes.bfloat16)}


def _as_port(state):
    out = {}
    for k, v in state.items():
        if str(v.dtype) == "bfloat16":
            out[k] = torch.from_numpy(
                v.view(np.uint16).view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v.copy())
    return out


def _bits(v):
    if isinstance(v, torch.Tensor):
        v = port_io._to_numpy(v)
    v = np.asarray(v)
    return (str(v.dtype).replace("uint16", "bfloat16"), v.shape,
            v.view(np.uint8).tobytes() if v.dtype.itemsize else b"")


def _sequence(make, port):
    """One call sequence; returns what each call gave."""
    m = make(max_to_keep=2)
    put = _as_port if port else dict
    log = []
    for step in (1, 1, 0, 3, 5):
        log.append(("save", step, m.save_arrays(step, put(_state(step)))))
    log.append(("latest", m.latest_step(), m.all_steps()))
    log.append(("commit", m.commit()))
    log.append(("prune", m.prune_after(3), m.all_steps()))
    log.append(("save", 4, m.save_arrays(4, put(_state(4)))))
    m.wait_until_finished()
    log.append(("latest", m.latest_step(), m.all_steps()))
    restored = {}
    for step in m.all_steps():
        sc = scope.Scope() if port else RefScope()
        log.append(("restore", m.restore(step, scope=sc)))
        restored[step] = {k: _bits(sc.find_var(k))
                          for k in ("w", "step_ct", "h")}
    return m, log, restored


def test_call_sequence_equals_reference(tmp_path):
    ref, ref_log, ref_restored = _sequence(
        lambda **kw: RefManager(str(tmp_path / "ref"), **kw), port=False)
    got, log, restored = _sequence(
        lambda **kw: Manager(str(tmp_path / "port"), **kw), port=True)
    assert log == ref_log
    assert restored == ref_restored
    want = {s: {k: _bits(v) for k, v in _state(s).items()} for s in (3, 4)}
    assert restored == want
    ref.close()
    got.close()
    again = Manager(str(tmp_path / "port"))
    assert again.all_steps() == RefManager(str(tmp_path / "ref")
                                           ).all_steps() == [3, 4]


def _program(pkg):
    if pkg == "ref":
        main, startup = RefProgram(), RefProgram()
        with ref_guard(main, startup), ref_names.guard():
            x = ref_layers.data("x", shape=[4], dtype="float32")
            ref_layers.mean(ref_layers.fc(
                x, size=3, param_attr=pt.ParamAttr(name="ck_w")))
    else:
        main, startup = core.Program(), core.Program()
        with core.program_guard(main, startup), unique_name.guard():
            x = layers.data("x", shape=[4], dtype="float32")
            layers.mean(layers.fc(x, size=3,
                                  param_attr=ptt.ParamAttr(name="ck_w")))
    return main


def test_program_save_and_interval_equal_reference(tmp_path):
    rng = np.random.RandomState(3)
    values = {"ck_w": rng.randn(4, 3).astype(np.float32),
              "fc_0.b_0": rng.randn(3).astype(np.float32)}
    out = {}
    for pkg in ("ref", "port"):
        main = _program(pkg)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        assert names == sorted(values)
        if pkg == "ref":
            sc, m = RefScope(), RefManager(str(tmp_path / pkg),
                                           save_interval_steps=2)
            for k, v in values.items():
                sc.set_var(k, v)
        else:
            sc, m = scope.Scope(), Manager(str(tmp_path / pkg),
                                           save_interval_steps=2)
            ptt.io.params_from_numpy(sc, values)
        calls = [m.save(3, program=main, scope=sc),
                 m.save(4, program=main, scope=sc),
                 m.save(5, program=main, scope=sc, force=True)]
        m.wait_until_finished()
        fresh = scope.Scope() if pkg == "port" else RefScope()
        calls.append(m.restore(scope=fresh))
        out[pkg] = (calls, m.all_steps(),
                    {k: _bits(fresh.find_var(k)) for k in values})
        m.close()
    assert out["port"] == out["ref"]
    assert out["port"][0] == [False, True, True, 5]


def test_retried_write_once_equals_reference(tmp_path):
    deltas = {}
    for pkg, mon, set_flags, make, put in (
            ("ref", ref_monitor, pt.set_flags, RefManager, dict),
            ("port", monitor, port_flags.set_flags, Manager, _as_port)):
        names = ("paddle_tpu_fault_injected_total",
                 "paddle_tpu_retry_attempts_total",
                 "paddle_tpu_retry_giveups_total")
        before = [mon.REGISTRY.get(n).value(site="checkpoint.write")
                  for n in names]
        set_flags({"FLAGS_fault_inject": "checkpoint.write:once"})
        m = make(str(tmp_path / pkg))
        ok = [m.save_arrays(1, put(_state(1))),
              m.save_arrays(2, put(_state(2)))]
        m.wait_until_finished()
        set_flags({"FLAGS_fault_inject": ""})
        after = [mon.REGISTRY.get(n).value(site="checkpoint.write")
                 for n in names]
        deltas[pkg] = (ok, m.all_steps(),
                       [a - b for a, b in zip(after, before)])
        m.close()
    assert deltas["port"] == deltas["ref"] == ([True, True], [1, 2],
                                               [1, 1, 0])


def test_port_format_has_no_pickle(tmp_path):
    m = Manager(str(tmp_path), max_to_keep=3)
    assert m.save_arrays(7, _as_port(_state(7)))
    assert m.commit() == 7
    d = tmp_path / "7"
    assert sorted(os.listdir(d)) == ["__meta__.json", "h.npy",
                                     "step_ct.npy", "w.npy"]
    meta = json.load(open(d / "__meta__.json"))["vars"]
    assert meta["h"]["dtype"] == "bfloat16"
    for f in ("h", "step_ct", "w"):
        np.load(d / f"{f}.npy", allow_pickle=False)
    m.close()


def test_background_write_error_raises_at_the_next_call(tmp_path,
                                                        monkeypatch):
    m = Manager(str(tmp_path), max_to_keep=1)
    assert m.save_arrays(1, _as_port(_state(1)))
    m.wait_until_finished()
    real = port_io._write_blobs

    def failing(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(port_io, "_write_blobs", failing)
    assert m.save_arrays(2, _as_port(_state(2)))
    assert m.all_steps() == [2]            # keep-last-1, as orbax shows it
    with pytest.raises(OSError, match="disk gone"):
        m.wait_until_finished()
    assert m.all_steps() == [1]            # the failed step never landed
    assert (tmp_path / "1" / "__meta__.json").exists()
    monkeypatch.setattr(port_io, "_write_blobs", real)
    assert m.save_arrays(2, _as_port(_state(2)))
    assert m.commit() == 2
    m.close()


def test_staging_leftovers_cleared_on_open(tmp_path):
    (tmp_path / "3.tmp.999").mkdir()
    (tmp_path / "4").mkdir()                      # no meta: incomplete
    m = Manager(str(tmp_path))
    assert m.all_steps() == [] and m.latest_step() is None
    assert not (tmp_path / "3.tmp.999").exists()
    with pytest.raises(FileNotFoundError):
        m.restore()
    m.close()
