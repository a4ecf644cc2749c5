"""Build and load the package's CUDA kernels (``csrc/*.cu``, ``csrc/*.cuh``).

Each source is compiled by its own ``nvcc`` for Hopper (``sm_90a``), all at
once, and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``.  The build runs at
first use and again whenever a source, the flags or the compiler changes:
the library's file name carries a hash of all three, so a stale library is
never loaded.  It lands in ``build/kernels/`` beside the package (listed in
``.gitignore``).  A failed build raises with nvcc's output; nothing falls
back to another implementation.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (no nvcc on PATH and none under CUDA_HOME "
                       "or /usr/local/cuda); the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    """Path of the library for the current sources, flags and compiler."""
    nvcc = _nvcc()
    h = hashlib.sha256()
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"libbct_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise with nvcc's output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{o}")
    return "".join(outs)


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # one nvcc per source, all started together, then one link; everything
    # goes to private names and the library is renamed into place, so
    # concurrent builders never load a half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in _sources()]
        log = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                    for src, o in zip(_sources(), objs)])
        lib = Path(tmpdir) / "lib.so"
        log += _run([[_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]])
        out.with_suffix(".log").write_text(log)
        os.replace(lib, out)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            for fn, args in [
                (lib.giga_select_launch, [ptr, i32, i64, i64, ptr, i32] + [ptr] * 6),
                (lib.packed_select_launch, [ptr, i64, i64, ptr, i32] + [ptr] * 6),
                (lib.giga_dots_launch, [ptr, i32, i64, i64, ptr, i32, ptr, ptr]),
                (lib.giga_score_launch, [ptr, i32, i64] + [ptr] * 6),
                (lib.giga_empty_launch, [ptr, i32, i64] + [ptr] * 6),
                (lib.fold_scale_launch, [ptr, i64, ptr, ptr, ptr]),
                (lib.giga_step_dirs_launch, [ptr, i64, ptr, ptr, ptr, ptr, i32] + [ptr] * 6),
                (lib.giga_step_update_launch,
                 [ptr, i32, i64, ptr, ptr, i64, ptr, i32, i32] + [ptr] * 13 + [f32] * 3
                 + [ptr] * 5),
            ]:
                fn.restype = ctypes.c_int
                fn.argtypes = args
            _lib = lib
        return _lib
