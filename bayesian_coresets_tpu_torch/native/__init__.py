"""Exact host-side NNLS: the JAX package's Lawson-Hanson solver in C++.

The source is this package's own ``native/nnls.cpp``, a byte-for-byte copy
of the JAX package's (this package reads no file of the JAX one).  It is
compiled with ``g++`` at first use into ``build/native/`` beside the
package (listed in ``.gitignore``),
under a name that carries a hash of the source, the flags and the
compiler, and loaded with ctypes.  There is no fallback: without ``g++``,
or if the build fails, :func:`nnls` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "nnls.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH; the exact NNLS solver cannot be built")
    return found


def library_path() -> Path:
    """Path of the library for the current source, flags and compiler."""
    if not SOURCE.is_file():
        raise RuntimeError(f"NNLS source not found: {SOURCE}")
    gxx = _gxx()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(gxx.encode())
    return BUILD_DIR / f"libbcnnls_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # a private name renamed into place: concurrent builds never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        r = subprocess.run([_gxx(), *FLAGS, str(SOURCE), "-o", tmp],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}) on {SOURCE}:\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the solver; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            dp = ctypes.POINTER(ctypes.c_double)
            lib.bc_nnls.restype = ctypes.c_int
            lib.bc_nnls.argtypes = [dp, dp, ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp]
            _lib = lib
        return _lib


def nnls(A: np.ndarray, b: np.ndarray, maxiter: int | None = None):
    """min_x ||A x - b||_2 s.t. x >= 0, exactly (Lawson-Hanson in f64).

    A: (m, n); b: (m,).  Returns (x, rnorm) like ``scipy.optimize.nnls``;
    raises RuntimeError if the solver cannot be built or the solve fails.
    """
    lib = load_library()
    A = np.ascontiguousarray(A, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    m, n = A.shape
    if b.shape != (m,):
        raise ValueError(f"shape mismatch: A {A.shape}, b {b.shape}")
    x = np.zeros(n, np.float64)
    rnorm = np.zeros(1, np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    code = lib.bc_nnls(A.ctypes.data_as(dp), b.ctypes.data_as(dp), m, n,
                       -1 if maxiter is None else int(maxiter),
                       x.ctypes.data_as(dp), rnorm.ctypes.data_as(dp))
    if code == 1:
        raise RuntimeError("native nnls: maxiter reached")
    if code == 2:
        raise RuntimeError("native nnls: numerical failure (singular passive set)")
    return x, float(rnorm[0])
