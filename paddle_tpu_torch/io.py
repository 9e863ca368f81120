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

  A save is staged beside ``dirname``, every file fsynced, and published
  by :func:`_atomic_publish_dir` (ref ``io.py:41-132``): files of an
  earlier save that this one does not write are hard-linked in, the old
  directory is parked at ``<dirname>.old.<pid>`` and rolled back if the
  second rename fails, and the parent is fsynced.  :func:`load_vars`
  first runs :func:`_recover_interrupted_swap`, so a saver that died
  between the two renames leaves a loadable directory.

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
           "load_inference_model", "get_program_persistable_vars"]


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


def get_program_persistable_vars(program: Program):
    return [v for v in program.list_vars() if _is_persistable(v)]


def _dtype_name(t, arr: np.ndarray) -> str:
    return ("bfloat16" if isinstance(t, torch.Tensor)
            and t.dtype == torch.bfloat16 else str(arr.dtype))


def _fsync_dir(path: str) -> None:
    """fsync a directory, so that renames inside it survive a crash (a
    file's own fsync does not persist its directory entry)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return                   # a platform without directory open
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_blobs(dirpath: str, arrays: Dict[str, np.ndarray],
                 dtypes: Dict[str, str], filename=None) -> None:
    """Write ``arrays`` into the (new, empty) directory ``dirpath`` in the
    format of ``save_vars``: one ``.npy`` per var, or one ``.npz`` named
    ``filename``, and ``__meta__.json``; fsync every file and the
    directory."""
    if filename is not None:
        np.savez(os.path.join(dirpath, filename), **arrays)
    else:
        for name, arr in arrays.items():
            np.save(os.path.join(dirpath, name.replace("/", "__")), arr)
    meta = {name: {"shape": list(arr.shape), "dtype": dtypes[name]}
            for name, arr in arrays.items()}
    with open(os.path.join(dirpath, "__meta__.json"), "w") as f:
        json.dump({"filename": filename, "vars": meta,
                   "version": PROGRAM_FORMAT_VERSION,
                   "framework_version": __version__}, f)
        f.flush()
        os.fsync(f.fileno())
    for entry in os.listdir(dirpath):
        if entry != "__meta__.json":
            _fsync_file(os.path.join(dirpath, entry))
    _fsync_dir(dirpath)


def _atomic_publish_dir(tmpdir: str, dst: str,
                        preserve_existing: bool = True) -> None:
    """Publish the fully written staging directory ``tmpdir`` at ``dst``
    (ref ``io.py:59-111``).  Files ``dst`` holds that ``tmpdir`` lacks (an
    inference model's ``__model__``, a user's ``assets/``) are hard-linked
    in first (copied where links fail).  The directories then swap by two
    renames; a failed second rename rolls the old directory back, and a
    process dying between them leaves it at ``<dst>.old.<pid>``, which
    :func:`_recover_interrupted_swap` renames back.  The parent is
    fsynced last."""
    dst = os.path.abspath(dst)
    if os.path.isdir(dst):
        if preserve_existing:
            for entry in os.listdir(dst):
                src, keep = os.path.join(dst, entry), os.path.join(tmpdir,
                                                                   entry)
                if os.path.exists(keep):
                    continue     # the fresh save wins
                try:
                    if os.path.isdir(src):
                        shutil.copytree(src, keep, copy_function=os.link)
                    elif os.path.isfile(src):
                        os.link(src, keep)
                except OSError:
                    if os.path.isdir(src):
                        shutil.rmtree(keep, ignore_errors=True)
                        shutil.copytree(src, keep)
                    elif os.path.isfile(src):
                        shutil.copy2(src, keep)
        old = dst + f".old.{os.getpid()}"
        shutil.rmtree(old, ignore_errors=True)
        os.rename(dst, old)
        try:
            os.rename(tmpdir, dst)
        except BaseException:
            os.rename(old, dst)      # roll the good directory back
            raise
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmpdir, dst)
    _fsync_dir(os.path.dirname(dst) or ".")


def _recover_interrupted_swap(dirname: str) -> None:
    """``dirname`` missing beside a ``<dirname>.old.<pid>``: a saver died
    between the two renames of the publish, and the sibling is the last
    complete save.  Rename it back (the newest when there are several)."""
    import glob
    import warnings
    dst = os.path.abspath(dirname)
    if os.path.isdir(dst):
        return
    leftovers = sorted(glob.glob(dst + ".old.*"), key=os.path.getmtime)
    if not leftovers:
        return
    warnings.warn(
        f"param dir {dirname!r} missing but {leftovers[-1]!r} exists — a "
        "save died mid-publish; recovering the last complete state")
    os.rename(leftovers[-1], dst)
    _fsync_dir(os.path.dirname(dst) or ".")


def save_vars(executor=None, dirname=None, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """ref io.py save_vars.  The blobs and ``__meta__.json`` are written
    and fsynced in a staging directory beside ``dirname`` and published by
    :func:`_atomic_publish_dir`, so a save that fails or dies leaves an
    earlier save whole."""
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
        dtypes[v.name] = _dtype_name(t, arrays[v.name])
    dst = os.path.abspath(dirname)
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    tmp = dst.rstrip(os.sep) + f".tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        _write_blobs(tmp, arrays, dtypes, filename)
        _atomic_publish_dir(tmp, dst)
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
    _recover_interrupted_swap(dirname)
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
    from .framework.core import sub_block_io
    used = set()
    for op in infer.global_block().ops:
        used.update(op.input_arg_names())
        used.update(op.output_arg_names())
        # what a While's body reads (its weights) is saved too
        used |= sub_block_io(op)
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
