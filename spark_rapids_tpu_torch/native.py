"""Build and load the port's native libraries.

A kernel library ``<name>`` is the file ``csrc/<name>.cu`` with a plain
``extern "C"`` launcher, compiled by ``nvcc`` for ``sm_90a`` into
``build/`` at the repository root, at first use. The library's file name
carries a hash of every source in ``csrc/`` and the flags, so an edit
rebuilds it; nvcc's report (ptxas's registers, stack frames and spills)
is kept beside it as ``<library>.log``. Libraries load with ``ctypes``;
nothing includes PyTorch's headers.

A host library (``csrc/<name>.cpp``: the memory runtime's OOM state
machine and disk spill store) is compiled by ``g++`` into the same
directory, named by the hash of its one source, under a file lock and
through a temporary file renamed over the target: processes that start
together never load a library another is still writing.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

__all__ = ["library_path", "build", "build_log", "load", "build_host"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> None:
    """Compile ``csrc/<name>.cu`` unless it is built already."""
    out = library_path(name)
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
         str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)


def build_log(name: str) -> str:
    """nvcc's output for the built library ``name``, built first if
    needed."""
    build(name)
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library, built first if needed (once, whatever the
    threads that ask)."""
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build(name)
            lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return lib


GXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]


def build_host(name: str) -> Optional[Path]:
    """``csrc/<name>.cpp`` built with g++ (module doc): the library's path,
    or None where no g++ is installed or the build fails."""
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, out)
    return out
