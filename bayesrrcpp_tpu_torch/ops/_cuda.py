"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface; it is compiled
by ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` on first use,
keyed by a hash of the sources and flags, and loaded with ctypes.
``libraries`` starts one ``nvcc`` per source, all at once, and waits for
them together.  Nothing is compiled or loaded when this module is imported.
A missing ``nvcc`` or a failed build raises: there is no fallback.
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
# int as a 32-bit int and cut a pointer); the strided BayesR sweeps take
# (Nw, x_int8, nr, n_rounds, J, B, K, G) after the words, and the strided
# sweeps end with the missing-call indicator's partials (null: the fold,
# int8 or dense mode) and the stream
SIGNATURES = {
    "jacobi_t": {
        "jacobi_t_dot_splits": ([_INT], _INT),
        "jacobi_t_dense_dot_splits": ([_INT], _INT),
        "jacobi_t_int8_dot_splits": ([_INT], _INT),
        "jacobi_t_max_block": ([], _INT),
        "jacobi_t_max_round": ([], _INT),
        "jacobi_t_max_components": ([], _INT),
        "jacobi_t_error_string": ([_INT], ctypes.c_char_p),
        "jacobi_t_row_apply_ring_rows": ([_INT], _INT),
        "jacobi_t_sweep": ([_VOID_P] + [_INT] * 8 + [_VOID_P] * 21 + [_INT]
                           + [_VOID_P] * 6, _INT),
        "jacobi_t_hs_sweep": ([_VOID_P] + [_INT] * 5 + [_VOID_P] * 17
                              + [_INT] + [_VOID_P] * 4, _INT),
    },
    # the fused multi-chain sweeps: the single-chain argument lists with
    # the chain count C in front
    "jacobi_t_mc": {
        "jacobi_t_mc_max_chains": ([], _INT),
        "jacobi_t_mc_error_string": ([_INT], ctypes.c_char_p),
        "jacobi_t_mc_row_apply_ring_rows": ([_INT], _INT),
        "jacobi_t_mc_sweep": ([_INT, _VOID_P] + [_INT] * 8 + [_VOID_P] * 21
                              + [_INT] + [_VOID_P] * 6, _INT),
        "jacobi_t_hs_mc_sweep": ([_INT, _VOID_P] + [_INT] * 5
                                 + [_VOID_P] * 17 + [_INT] + [_VOID_P] * 4,
                                 _INT),
    },
    # the serial (J=1) and row-layout (J > 1) sweeps, one chain or fused:
    # 12 ints (C, pz_by_marker, Nw, n_pos, chunk, B, K, G, Mpad, nsplit,
    # mode, J; mode 0 fold, 1 in-kernel decode, 2 dense, 3 int8 fold, 4
    # int8 in-kernel decode), then 25 operand pointers and the stream; the round solve:
    # 4 ints (J, B, K, G), 16 operand pointers and the stream
    "serial": {
        "serial_max_block": ([], _INT),
        "serial_max_row_block": ([], _INT),
        "serial_max_chains": ([], _INT),
        "serial_max_components": ([], _INT),
        "serial_window": ([_INT, _INT], _INT),
        "serial_dot_splits": ([_INT], _INT),
        "serial_dense_dot_splits": ([_INT], _INT),
        "serial_int8_dot_splits": ([_INT], _INT),
        "serial_error_string": ([_INT], ctypes.c_char_p),
        "serial_row_apply_ring_rows": ([_INT], _INT),
        "serial_sweep": ([_INT] * 12 + [_VOID_P] * 26, _INT),
        "serial_round_solve": ([_INT] * 4 + [_VOID_P] * 17, _INT),
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
            msg = getattr(self.lib, f"{self.name}_error_string")(rc).decode()
            raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


_LOADED: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ on the machine with the card")
    return path


def _target(name: str):
    """(source, shared library path) of ``csrc/<name>.cu``; the path is keyed
    by a hash of the flags, the source and every header of ``csrc/``."""
    src = os.path.join(CSRC, f"{name}.cu")
    deps = sorted([src] + glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for d in deps:
        with open(d, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def libraries(*names: str) -> list:
    """The built and loaded ``csrc/<name>.cu`` of each name (built once per
    source hash, one ``nvcc`` per source started together; later calls in
    the process reuse the handles)."""
    import time

    with _LOCK:
        jobs = []
        for name in dict.fromkeys(names):
            if name in _LOADED:
                continue
            src, so = _target(name)
            if os.path.exists(so):
                _LOADED[name] = Library(name, so, "", 0.0)
                continue
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, src, so, tmp, proc, time.perf_counter()))
        done = [(job, job[4].communicate()[0], time.perf_counter() - job[5])
                for job in jobs]
        for (name, src, so, tmp, proc, _), log, secs in done:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            os.replace(tmp, so)
            _LOADED[name] = Library(name, so, log, secs)
        return [_LOADED[name] for name in names]


def library(name: str) -> Library:
    """The built and loaded ``csrc/<name>.cu`` (see ``libraries``)."""
    return libraries(name)[0]


def row_apply_ring_rows(rows: int) -> int:
    """Set, in every kernel library, the smallest round (J*B entries) whose
    row apply (dense and int8 rows) takes the ring and not the direct path;
    ``rows < 0`` leaves it.  Returns the previous value.  Both paths give
    the same bits; the tests hold them against each other."""
    old = None
    for lib in libraries("jacobi_t", "jacobi_t_mc", "serial"):
        old = getattr(lib.lib, f"{lib.name}_row_apply_ring_rows")(rows)
    return old
