"""ctypes bindings for the native host runtime (``storage_native.cpp``): the
inventory-space reducer and the job engine, a copy of the JAX package's.

``load()`` builds the library at first use with g++ and the JAX package's
Makefile flags (no ``-ffast-math``: the bands keep the Python path's f64
bits) into ``build/storage_tpu_torch/native/<hash of source and flags>/`` at
the repository root, so a changed source rebuilds and an unchanged one is
reused.  Each build writes a temporary file and renames it into place, so
processes that build at once do not clash.  A failed build raises with the
compiler's output.  Nothing happens at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "storage_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "storage_tpu_torch" / "native"
LIB_NAME = "libstorage_tpu_torch_native.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

JOB_FN = ctypes.CFUNCTYPE(None, ctypes.c_int64, ctypes.c_void_p)

JOB_PENDING = 0
JOB_RUNNING = 1
JOB_SUCCESS = 2
JOB_ERROR = 3
JOB_CANCELLED = 4

_D = ctypes.POINTER(ctypes.c_double)
_V = ctypes.c_void_p
_I64 = ctypes.c_int64
# name: (restype, argtypes)
SIGNATURES = {
    # num_steps, width, is_step, node inv/min/max, min_inv, max_inv, loss,
    # starting inventory, lower, upper
    "stpu_inventory_space_reduce": (ctypes.c_int, (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _D, _D, _D, _D, _D, _D, ctypes.c_double,
        _D, _D)),
    "stpu_job_engine_create": (_V, (ctypes.c_int,)),
    "stpu_job_engine_destroy": (None, (_V,)),
    "stpu_job_submit": (_I64, (_V, JOB_FN, _V)),
    "stpu_job_status": (ctypes.c_int, (_V, _I64)),
    "stpu_job_progress": (ctypes.c_double, (_V, _I64)),
    "stpu_job_set_progress": (None, (_V, _I64, ctypes.c_double)),
    "stpu_job_set_status": (None, (_V, _I64, ctypes.c_int)),
    "stpu_job_request_cancel": (None, (_V, _I64)),
    "stpu_job_cancel_requested": (ctypes.c_int, (_V, _I64)),
    "stpu_job_wait": (ctypes.c_int, (_V, _I64)),
    "stpu_job_engine_num_running": (ctypes.c_int, (_V,)),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the library unless this source is already built; returns its
    path.  Raises ``RuntimeError`` with the compiler's output on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host runtime needs a C++ compiler.")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib.parent, suffix=".so.tmp")
    os.close(fd)
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True,
                             text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} ({out.returncode}):\n"
                               f"{(out.stdout + out.stderr)[-8000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The native library with every entry point's argtypes set, built at the
    first call."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib
