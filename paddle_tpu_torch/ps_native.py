"""The parameter server's native runtime: build, load and declare.

The port's copy of the PS half of ``paddle_tpu/native/__init__.py``
(``:125-156``).  The TCP KV server and client are host C++
(``csrc/ps_server.cc``, with ``csrc/bf16.h``); no CUDA is involved.  At
first use ``g++ -O2 -std=c++17 -fPIC -shared -pthread`` builds it into the
build directory of the CUDA kernels (``kernels/_build.build_dir()``), under
a directory named by a hash of the sources and flags, and the library is
loaded with ``ctypes``.  A failed build raises with the compiler's output:
there is no pure-Python server to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .kernels._build import CSRC, build_dir

SOURCE = "ps_server.cc"
HEADERS = ("bf16.h",)
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib = None  # guarded-by: _lock


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in (SOURCE,) + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / _digest() / "libps_server.so"


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the parameter server needs g++ to build "
                           f"csrc/{SOURCE} (no C++ compiler on PATH)")
    return cxx


def build() -> Path:
    """Compile the library unless this source's build exists; returns its
    path.  Several processes may build at once: each writes its own file
    and renames it into place."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(CSRC / SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building the parameter server failed "
                           f"({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib) -> None:
    c = ctypes
    i64, p, cp = c.c_int64, c.c_void_p, c.c_char_p
    sigs = {
        "ps_server_create": ([c.c_int, c.c_int, c.c_int], p),
        "ps_server_add_param": ([p, cp, i64, p, c.c_int, c.c_float,
                                 c.c_float, c.c_float, i64], c.c_int),
        "ps_server_start": ([p], c.c_int),
        "ps_server_wait": ([p], None),
        "ps_server_stop": ([p], None),
        "ps_server_get": ([p, cp, p, i64], c.c_int),
        "ps_server_destroy": ([p], None),
        "ps_client_connect": ([cp, c.c_int], p),
        "ps_client_put": ([p, cp, p, i64], c.c_int),
        "ps_client_get": ([p, cp, p, i64], i64),
        "ps_client_get_nobarrier": ([p, cp, p, i64], i64),
        "ps_client_push_dense": ([p, cp, p, i64], c.c_int),
        "ps_client_push_sparse": ([p, cp, p, c.c_uint32, p, i64], c.c_int),
        "ps_client_get_rows": ([p, cp, p, c.c_uint32, p, i64], i64),
        "ps_client_put_typed": ([p, cp, p, i64, c.c_int], c.c_int),
        "ps_client_get_typed": ([p, cp, p, i64, c.c_int], i64),
        "ps_client_push_typed": ([p, cp, p, c.c_uint32, p, i64, c.c_int],
                                 c.c_int),
        "ps_server_add_param_typed": ([p, cp, i64, p, c.c_int, c.c_int,
                                       c.c_float, c.c_float, c.c_float,
                                       i64], c.c_int),
        "ps_client_barrier": ([p], c.c_int),
        "ps_client_stop_server": ([p], c.c_int),
        "ps_client_destroy": ([p], None),
        "ptn_crc32": ([c.c_uint32, p, c.c_uint64], c.c_uint32),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def load():
    """The loaded, declared library, built at first use (raises when the
    build fails)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib
