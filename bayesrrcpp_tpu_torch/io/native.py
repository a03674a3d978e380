"""ctypes bridge to the native (C++) sample-row formatter.

Counterpart of ``bayesrrcpp_tpu/io/native.py`` (the CSV half; the .bed
decoder is ROADMAP Queue 1 item 10).  It shares ``native/sampsink.cpp`` and
its build with the JAX package.

The reference's native runtime around the sampler is the lock-free queue +
CSV consumer thread (src/concurrentqueue.h, src/BayesRv2.cpp:281-290).  Our
equivalent native component is ``native/sampsink.cpp``: a C++ formatter that
turns a dense (n, width) f64 row block into the Eigen-CommaInitFmt CSV text
(the bottleneck at scale is double->ascii, which CPython is ~50x slower at).
Built via ``python native/build.py`` into ``native/libsampsink.so``; loading
is optional -- a NumPy fallback keeps everything working without it.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

_LIB = None
_TRIED = False


def _native_so(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native", name)


def _ensure_built(so_path: str) -> bool:
    """Auto-build the native library on first use (the .so is not shipped).

    Returns True if the .so exists (already or after a successful quiet
    build); failures are non-fatal -- every native path has a pure-Python
    fallback."""
    if os.path.exists(so_path):
        return True
    build_py = os.path.join(os.path.dirname(so_path), "build.py")
    if not os.path.exists(build_py):
        return False
    name = os.path.basename(so_path)[3:-3]  # libfoo.so -> foo
    try:
        import subprocess
        import sys

        subprocess.run([sys.executable, build_py, name], check=True,
                       capture_output=True, timeout=120)
    except Exception:
        return False
    return os.path.exists(so_path)


class NativeWriter:
    def __init__(self, lib):
        self._lib = lib
        self._lib.format_rows_csv.restype = ctypes.c_longlong
        self._lib.format_rows_csv.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_char_p, ctypes.c_longlong,
        ]

    def format_rows(self, mat) -> str:
        import numpy as np

        mat = np.ascontiguousarray(mat, np.float64)
        n, w = mat.shape
        # worst case ~25 bytes per field incl ", "
        bufsize = n * w * 26 + n + 16
        buf = ctypes.create_string_buffer(bufsize)
        written = self._lib.format_rows_csv(
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, w, buf, bufsize)
        if written < 0:
            raise RuntimeError("native CSV formatter buffer overflow")
        return buf.raw[:written].decode("ascii")


def get_native_writer() -> Optional[NativeWriter]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = _native_so("libsampsink.so")
    if _ensure_built(so):
        try:
            _LIB = NativeWriter(ctypes.CDLL(so))
        except OSError:
            _LIB = None
    return _LIB
