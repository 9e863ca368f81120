"""Weights and optimizer state carried between the port and ``paddle_tpu``.

- :func:`params_from_numpy` puts a ``{name: numpy array}`` map — the
  parameters of a ``paddle_tpu`` scope, under the names its model builders
  give them — into a port scope as tensors on a device;
  :func:`params_to_numpy` takes such a map out of a port scope.
- :func:`save_vars` / :func:`save_params` / :func:`save_persistables` write,
  and :func:`load_vars` / :func:`load_params` / :func:`load_persistables`
  read, the directory format of ``paddle_tpu.io.save_vars``
  (``io.py:150-219``): one ``<name>.npy`` per var (``/`` spelled ``__``) or
  one ``.npz`` when ``filename`` is given, plus ``__meta__.json``, where
  bfloat16 values travel as their uint16 bits and the meta records the true
  dtype.

- :func:`save_inference_model` / :func:`load_inference_model` write and
  read the reference's inference artifact (``io.py:299-356``): the program
  pruned to its targets and cloned for test, as the program JSON of
  ``Program.serialize_to_string`` with ``feed_names`` / ``fetch_names`` in
  ``__model__``, and beside it only the persistables that program uses.

So a model saved by ``paddle_tpu`` serves and trains on in the port, and a
scope the port trained loads into ``paddle_tpu``; an inference artifact
either package saves loads in the other's predictor.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from .framework.core import (PROGRAM_FORMAT_VERSION, Program, Variable,
                             default_main_program)
from .framework.scope import Scope, global_scope
from .version import __version__

__all__ = ["params_from_numpy", "params_to_numpy", "save_vars",
           "save_params", "save_persistables", "load_vars", "load_params",
           "load_persistables", "save_inference_model",
           "load_inference_model"]


def _to_tensor(arr: np.ndarray, dtype_name: Optional[str],
               device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:       # e.g. a view of a jax array
        arr = arr.copy()
    if dtype_name == "bfloat16" and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_numpy(scope: Scope, arrays: Dict[str, np.ndarray],
                      device="cpu") -> Scope:
    """Set each ``name -> array`` into ``scope`` as a tensor on ``device``."""
    for name, arr in arrays.items():
        scope.set_var(name, _to_tensor(np.asarray(arr), None,
                                       torch.device(device)))
    return scope


def _to_numpy(t) -> np.ndarray:
    """A scope value as a C-ordered numpy array; bfloat16 as its uint16
    bits (numpy has no bfloat16)."""
    if not isinstance(t, torch.Tensor):
        return np.ascontiguousarray(np.asarray(t))
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_to_numpy(scope: Scope,
                    names: Optional[Iterable[str]] = None
                    ) -> Dict[str, np.ndarray]:
    """``{name: numpy array}`` of ``names`` (default: every var the scope
    holds a value for) — parameters and optimizer accumulators alike, ready
    for a ``paddle_tpu`` scope or :func:`params_from_numpy`.  A bfloat16
    tensor comes out as float32 (numpy has no bfloat16)."""
    if names is None:
        names = [n for n, v in scope.items() if v is not None]
    out = {}
    for n in names:
        t = scope.find_var(n)
        if t is None:
            raise KeyError(f"variable {n!r} has no value in the scope")
        if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            t = t.float()
        out[n] = _to_numpy(t)
    return out


def _is_persistable(var) -> bool:
    return bool(var.persistable) and var.type not in ("raw", "step_scopes")


def _is_parameter(var) -> bool:
    return bool(var.is_parameter)


def save_vars(executor=None, dirname=None, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """ref io.py save_vars.  The blobs and ``__meta__.json`` are written to
    a staging directory beside ``dirname`` and then renamed into place, so
    a save that fails leaves an earlier save whole."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = [v for v in program.list_vars()
                if (predicate or _is_persistable)(v)]
    arrays, dtypes = {}, {}
    for v in vars:
        t = scope.find_var(v.name)
        if t is None:
            raise ValueError(f"variable {v.name!r} has no value in scope — "
                             "run the startup program before saving")
        arrays[v.name] = _to_numpy(t)
        dtypes[v.name] = ("bfloat16" if isinstance(t, torch.Tensor)
                          and t.dtype == torch.bfloat16
                          else str(arrays[v.name].dtype))
    dst = os.path.abspath(dirname)
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    tmp = dst.rstrip(os.sep) + f".tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        if filename is not None:
            np.savez(os.path.join(tmp, filename), **arrays)
        else:
            for name, arr in arrays.items():
                np.save(os.path.join(tmp, name.replace("/", "__")), arr)
        meta = {name: {"shape": list(arr.shape), "dtype": dtypes[name]}
                for name, arr in arrays.items()}
        with open(os.path.join(tmp, "__meta__.json"), "w") as f:
            json.dump({"filename": filename, "vars": meta,
                       "version": PROGRAM_FORMAT_VERSION,
                       "framework_version": __version__}, f)
        if os.path.isdir(dst):
            # files of an earlier save that this one does not rewrite stay
            for entry in os.listdir(dst):
                src, keep = os.path.join(dst, entry), os.path.join(tmp, entry)
                if os.path.exists(keep):
                    continue
                if os.path.isdir(src):
                    shutil.copytree(src, keep)
                else:
                    shutil.copy2(src, keep)
            old = dst + f".old.{os.getpid()}"
            os.rename(dst, old)
            os.rename(tmp, dst)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, dst)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_params(executor=None, dirname=None, main_program=None,
                filename=None, scope=None):
    """ref io.py:254 — trainable parameters only."""
    save_vars(executor, dirname, main_program, None, _is_parameter,
              filename, scope)


def save_persistables(executor=None, dirname=None, main_program=None,
                      filename=None, scope=None):
    """ref io.py:487 — parameters and optimizer accumulators."""
    save_vars(executor, dirname, main_program, None, _is_persistable,
              filename, scope)


def load_vars(executor=None, dirname=None, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """ref io.py load_vars.  Tensors land on ``executor``'s device (the
    host when no executor is given)."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    device = executor.device if executor is not None else torch.device("cpu")
    meta_path = os.path.join(dirname, "__meta__.json")
    var_meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        fmt = int(meta.get("version", 0))
        if fmt > PROGRAM_FORMAT_VERSION:
            raise ValueError(
                f"parameter blobs in {dirname} have format version {fmt}, "
                f"newer than this framework supports "
                f"({PROGRAM_FORMAT_VERSION}; saved by framework "
                f"{meta.get('framework_version', '<unknown>')!r})")
        var_meta = meta.get("vars", {})
    if vars is None:
        vars = [v for v in program.list_vars()
                if (predicate or _is_persistable)(v)]

    def _restore(name, arr):
        return _to_tensor(arr, var_meta.get(name, {}).get("dtype"), device)

    if filename is not None:
        path = os.path.join(dirname, filename)
        if not os.path.exists(path):
            path = path + ".npz"
        data = np.load(path)
        missing = [v.name for v in vars if v.name not in data]
        if missing:
            raise ValueError(
                f"combined checkpoint {path} is missing vars: {missing}")
        for v in vars:
            scope.set_var(v.name, _restore(v.name, data[v.name]))
        return
    for v in vars:
        path = os.path.join(dirname, v.name.replace("/", "__") + ".npy")
        if not os.path.exists(path):
            raise ValueError(f"missing saved var file {path}")
        scope.set_var(v.name, _restore(v.name, np.load(path)))


def load_params(executor=None, dirname=None, main_program=None,
                filename=None, scope=None):
    load_vars(executor, dirname, main_program, None, _is_parameter,
              filename, scope)


def load_persistables(executor=None, dirname=None, main_program=None,
                      filename=None, scope=None):
    load_vars(executor, dirname, main_program, None, _is_persistable,
              filename, scope)


def save_inference_model(dirname, feeded_var_names: Sequence[str],
                         target_vars: Sequence, executor=None,
                         main_program: Optional[Program] = None,
                         model_filename=None, params_filename=None,
                         export_for_deployment=True, scope=None):
    """ref io.py:933 — prune to the fetch targets, switch to test mode,
    save the program and the persistables it uses.  Returns the feed
    names."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    target_names = [t.name if isinstance(t, Variable) else t
                    for t in target_vars]
    infer = program.clone(for_test=True)._prune(target_names)
    os.makedirs(dirname, exist_ok=True)
    used = set()
    for op in infer.global_block().ops:
        used.update(op.input_arg_names())
        used.update(op.output_arg_names())
    pvars = [v for v in infer.list_vars() if _is_persistable(v)
             and v.name in used]
    payload = json.loads(infer.serialize_to_string())
    payload["feed_names"] = list(feeded_var_names)
    payload["fetch_names"] = list(target_names)
    with open(os.path.join(dirname, model_filename or "__model__"),
              "wb") as f:
        f.write(json.dumps(payload).encode("utf-8"))
    save_vars(executor, dirname, infer, pvars, None, params_filename,
              scope)
    return list(feeded_var_names)


def load_inference_model(dirname, executor=None, model_filename=None,
                         params_filename=None, scope=None):
    """ref io.py:1113 → (program, feed_names, fetch_names).  Only the vars
    ``__meta__.json`` lists are read: the pruned program's var table still
    names training-only persistables the save left out."""
    scope = scope or global_scope()
    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        payload = json.loads(f.read().decode("utf-8"))
    program = Program.parse_from_string(json.dumps(payload).encode("utf-8"))
    saved = None
    meta_path = os.path.join(dirname, "__meta__.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            saved = set(json.load(f)["vars"])
    vars = [v for v in program.list_vars() if _is_persistable(v)
            and (saved is None or v.name in saved)]
    load_vars(executor, dirname, program, vars, None, params_filename,
              scope)
    return (program, payload.get("feed_names", []),
            payload.get("fetch_names", []))
