"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/torch_kernels/lib<name>-<hash>.so`` at the repository root
(the hash covers the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edited source or header is rebuilt),
then loaded with ``ctypes``. Nothing is built while a module is imported:
the wrappers call :func:`load` at their first launch on a CUDA tensor.
:func:`build` starts one ``nvcc`` per source, all at once, so a cold start
pays for the slowest source, not the sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "build", "load", "lib_path",
           "nvcc_path"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("gram", "cholesky", "trsm", "gp_predict", "cem_score",
           "cholesky_hbm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            f"{CSRC} on first use"
        )
    return found


def lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library of ``names`` in parallel; return the
    paths. The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<lib>.log``. Raises with the
    compiler's output when a source does not build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: lib_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        path.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, entry: str, argtypes: tuple):
    """The C entry point ``entry`` of ``lib<name>``, built and loaded on the
    first call and kept; it returns the ``cudaGetLastError()`` code as an
    int."""
    fn = _FNS.get((name, entry))
    if fn is not None:
        return fn
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            _LIBS[name] = lib
    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    _FNS[(name, entry)] = fn
    return fn
