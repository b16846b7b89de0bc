"""Build and load the CUDA kernels of ``crnerf_tpu_torch/csrc``.

Each source is compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes. The library goes to ``build/`` at the
root of the checkout, named by a hash of the source, the shared headers
(``*.cuh``) and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. ``load`` may be called from several threads, one
per source, to build the libraries side by side. Nothing
is built when a module is imported: the first launch builds. ``entry``
binds one C function for a wrapper that is called often: it loads at its
first call and from then on calls the function with no lock or lookup.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()                      # guards the two dicts
_SOURCE_LOCKS: Dict[str, threading.Lock] = {}  # one build per source
BUILD_LOG: Dict[str, str] = {}  # source name -> nvcc's output (ptxas -v)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return path


def load(source: str, argtypes: Dict[str, Sequence]) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (if its hash changed) and load it.
    ``argtypes`` maps each exported C function to its ctypes argtypes;
    every exported function returns a cudaError_t as int."""
    with _LOCK:
        source_lock = _SOURCE_LOCKS.setdefault(source, threading.Lock())
    with source_lock:
        if source in _LIBS:
            return _LIBS[source]
        src = CSRC / source
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"{src.stem}_{digest}.so"
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source} (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            BUILD_LOG[source] = proc.stdout + proc.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, types in argtypes.items():
            fn = getattr(lib, name)
            fn.argtypes = list(types)
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
        return lib


def entry(source: str, argtypes: Dict[str, Sequence],
          name: str) -> Callable[..., int]:
    """-> a callable for the C function ``name`` of ``csrc/<source>``
    (``argtypes`` as ``load`` takes them): its first call loads the
    library (building it if need be), later calls go straight to the
    bound function."""
    fn = None

    def call(*args) -> int:
        nonlocal fn
        if fn is None:
            fn = getattr(load(source, argtypes), name)
        return fn(*args)

    return call
