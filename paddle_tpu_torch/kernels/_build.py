"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  ``nvcc``
compiles it for ``sm_90a`` into a shared library at first use, and the
library is loaded with ``ctypes`` (no PyTorch headers are compiled, so a
build takes seconds).  Libraries live under ``build/`` next to the package
(or ``$PADDLE_TPU_TORCH_BUILD_DIR``), in a directory named by a hash of the
sources and flags: an edited source builds anew, an unchanged one loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"

#: kernel name -> source file under csrc/
SOURCES = {"flash_attn_fwd": "flash_attn_fwd.cu",
           "flash_attn_bwd": "flash_attn_bwd.cu",
           "conv1x1_stats": "conv1x1_stats.cu",
           "layer_norm": "layer_norm.cu",
           "dense_epilogue": "dense_epilogue.cu",
           "matmul_bn_stats": "matmul_bn_stats.cu",
           "attn_skeleton": "attn_skeleton.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock


def build_dir() -> Path:
    env = os.environ.get("PADDLE_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "paddle_tpu_torch_kernels"


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (CUDA_HOME or /usr/local/cuda)")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / SOURCES[name]).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / _digest(name) / f"lib{name}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` process per source, all started together.  Returns ``{name:
    {"path", "seconds", "log"}}`` for the libraries it built; raises with
    the compiler's output when any build fails."""
    names = list(SOURCES if names is None else names)
    with _lock:
        procs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, time.perf_counter())
        failed, built = [], {}
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)
            built[name] = {"path": str(out), "log": log,
                           "seconds": time.perf_counter() - t0}
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return built


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built at first use."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    with _lock:
        return _libs.setdefault(name, lib)
