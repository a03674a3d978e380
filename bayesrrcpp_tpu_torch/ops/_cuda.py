"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface; it is compiled
by ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` on first use,
keyed by a hash of the sources and flags, and loaded with ctypes.  Nothing
is compiled or loaded when this module is imported.  A missing ``nvcc`` or
a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC"]

_VOID_P, _INT = ctypes.c_void_p, ctypes.c_int

# argtypes of each library's entry points (ctypes would pass a bare Python
# int as a 32-bit int and cut a pointer)
SIGNATURES = {
    "jacobi_t": {
        "jacobi_t_dot_splits": ([_INT], _INT),
        "jacobi_t_max_block": ([], _INT),
        "jacobi_t_max_round": ([], _INT),
        "jacobi_t_max_components": ([], _INT),
        "jacobi_t_error_string": ([_INT], ctypes.c_char_p),
        "jacobi_t_sweep": ([_VOID_P, _INT, _INT, _INT, _INT, _INT, _INT]
                           + [_VOID_P] * 21 + [_INT] + [_VOID_P] * 5, _INT),
    },
}


class Library:
    """A loaded kernel library plus what its build printed."""

    def __init__(self, name: str, path: str, build_log: str,
                 build_seconds: float):
        self.name = name
        self.path = path
        self.build_log = build_log
        self.build_seconds = build_seconds
        self.lib = ctypes.CDLL(path)
        for fn, (args, res) in SIGNATURES[name].items():
            f = getattr(self.lib, fn)
            f.argtypes = args
            f.restype = res

    def check(self, rc: int, what: str):
        if rc != 0:
            msg = self.lib.jacobi_t_error_string(rc).decode()
            raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


_LOADED: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ on the machine with the card")
    return path


def library(name: str) -> Library:
    """The built and loaded ``csrc/<name>.cu`` (built once per source
    hash; later calls in the process reuse the handle)."""
    import time

    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        src = os.path.join(CSRC, f"{name}.cu")
        deps = sorted([src] + glob.glob(os.path.join(CSRC, "*.cuh")))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for d in deps:
            with open(d, "rb") as f:
                h.update(f.read())
        so = os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")
        log, secs = "", 0.0
        if not os.path.exists(so):
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                 capture_output=True, text=True)
            secs = time.perf_counter() - t0
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            os.replace(tmp, so)
        _LOADED[name] = Library(name, so, log, secs)
        return _LOADED[name]
