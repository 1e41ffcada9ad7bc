"""Build and load the port's hand-written CUDA kernels.

Every source ``csrc/<name>.cu`` becomes its own plain-C shared library,
compiled with ``nvcc`` for ``sm_90a`` at first use into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), under a name keyed
by a hash of that source and the flags.  :func:`build` starts one ``nvcc``
per missing library, all at once; :func:`load` builds what is missing and
opens the library with ctypes.  Nothing here runs when the module is
imported: the CPU never needs a kernel library.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_BUILD = os.path.join(_ROOT, "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = {os.path.splitext(os.path.basename(p))[0]: p
           for p in sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what nvcc printed for each library this process built (``-Xptxas -v``:
# registers, shared memory and spills of every kernel)
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> str:
    """The library built from ``csrc/<name>.cu``: keyed by a hash of the
    source and the flags, so an edit of either builds a new one."""
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the libraries of ``names`` (default: every source) that are
    not built yet, one ``nvcc`` process each, all started together.
    Returns the seconds from the start until each library was done (0.0
    for one that was already there); raises if any compile fails."""
    names = list(SOURCES if names is None else names)
    secs = {n: 0.0 for n in names}
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return secs
    os.makedirs(_BUILD, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = f"{library_path(n)}.{os.getpid()}.tmp"
        procs[n] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, SOURCES[n], "-o", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        secs[n] = time.perf_counter() - t0
        build_log[n] = err
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            errors.append(f"nvcc failed on {SOURCES[n]} "
                          f"({proc.returncode}):\n{err[-4000:]}")
        else:
            os.replace(tmp, library_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The opened library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(library_path(name))
        return _libs[name]
