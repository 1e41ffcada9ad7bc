"""ctypes loader for the host-side setup kernels in ``native/fenasetup.cpp``.

The C++ source is shared with the JAX package; this loader compiles it with
``g++`` at first use into ``build/native/`` at the root of the checkout
(listed in ``.gitignore``), under a file name keyed by a hash of the source,
so a changed source is rebuilt and a stale library is never loaded.

Every entry point falls back to NumPy when no compiler is available: this is
host-side setup work (sort-unique over packed int64 keys, RCM ordering), so
the fallback hides no device work.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "fenasetup.cpp")
_BUILD = os.path.join(_ROOT, "build", "native")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_state = {"tried": False, "lib": None}


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(_BUILD, f"_fenasetup-{digest.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    # process-unique temp name: concurrent test workers must not interleave
    # object code into one file; os.replace installs atomically
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False
    os.replace(tmp, so)
    return True


def _load():
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        if not os.path.exists(_SRC):
            return None
        so = _library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.fena_unique_i64.restype = ctypes.c_int64
        lib.fena_unique_i64.argtypes = [i64p, ctypes.c_int64, i64p, i64p]
        lib.fena_searchsorted_i64.restype = ctypes.c_int64
        lib.fena_searchsorted_i64.argtypes = [i64p, ctypes.c_int64, i64p,
                                              ctypes.c_int64, i64p]
        lib.fena_rcm_rank.restype = None
        lib.fena_rcm_rank.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_int32, i32p]
        _state["lib"] = lib
        return lib


def unique_i64(keys: np.ndarray):
    """``np.unique(keys, return_inverse=True)`` for non-negative int64 keys."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.int64).ravel()
    if lib is None:
        return np.unique(keys, return_inverse=True)
    n = keys.shape[0]
    uniq = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    nu = lib.fena_unique_i64(keys.ctypes.data_as(i64p), n,
                             uniq.ctypes.data_as(i64p),
                             inverse.ctypes.data_as(i64p))
    return uniq[:nu].copy(), inverse


def searchsorted_i64(uniq: np.ndarray, queries: np.ndarray):
    """``(np.searchsorted(uniq, queries), n_exact_hits)`` for sorted uniq."""
    lib = _load()
    uniq = np.ascontiguousarray(uniq, dtype=np.int64)
    queries = np.ascontiguousarray(queries, dtype=np.int64).ravel()
    if lib is None:
        pos = np.searchsorted(uniq, queries)
        if not uniq.size:
            return pos, 0
        hits = int((uniq[np.clip(pos, 0, uniq.shape[0] - 1)]
                    == queries).sum())
        return pos, hits
    pos = np.empty(queries.shape[0], dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    hits = lib.fena_searchsorted_i64(
        uniq.ctypes.data_as(i64p), uniq.shape[0],
        queries.ctypes.data_as(i64p), queries.shape[0],
        pos.ctypes.data_as(i64p))
    return pos, int(hits)


def rcm_rank(cell_dofs: np.ndarray, ndof: int):
    """RCM rank (old dof -> new dof) from cell connectivity, or None when
    the native library is unavailable (the caller then uses scipy)."""
    lib = _load()
    if lib is None:
        return None
    cd = np.ascontiguousarray(cell_dofs, dtype=np.int32)
    rank = np.empty(ndof, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.fena_rcm_rank(cd.ctypes.data_as(i32p), cd.shape[0], cd.shape[1],
                      ndof, rank.ctypes.data_as(i32p))
    return rank
