"""ctypes bridges to the native (C++) sample-row formatter and .bed decoder.

Counterpart of ``bayesrrcpp_tpu/io/native.py``.  It shares
``native/sampsink.cpp``, ``native/bedreader.cpp`` and their build
(``native/build.py``) with the JAX package; ``native/`` is host code of
neither package.

The reference's native runtime around the sampler is the lock-free queue +
CSV consumer thread (src/concurrentqueue.h, src/BayesRv2.cpp:281-290).  Our
equivalent native component is ``native/sampsink.cpp``: a C++ formatter that
turns a dense (n, width) f64 row block into the Eigen-CommaInitFmt CSV text
(the bottleneck at scale is double->ascii, which CPython is ~50x slower at).
Built via ``python native/build.py`` into ``native/libsampsink.so``; loading
is optional -- a NumPy fallback keeps everything working without it.  The
same holds for the threaded PLINK .bed -> packed-word decoder
(``native/libbedreader.so``, ``io/bed.py``'s NumPy decoder without it).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

_LIB = None
_TRIED = False
_BED = None
_BED_TRIED = False


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


class NativeBedDecoder:
    """ctypes bridge to the threaded PLINK .bed -> packed-2-bit-word decoder
    (native/bedreader.cpp).  One streaming pass: genotype bytes in, sampler
    word layout + per-marker standardization stats out."""

    def __init__(self, lib):
        self._lib = lib
        self._lib.bed_decode_packed.restype = ctypes.c_longlong
        self._lib.bed_decode_packed.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ]

    def decode(self, raw, m, n, wpad, n_threads=0):
        """raw: (M*bpm,) uint8 genotype bytes (no 3-byte header).  Returns
        (words (M, wpad) int32, means, sds, miss_counts, total_missing)."""
        import numpy as np

        raw = np.ascontiguousarray(raw, np.uint8)
        words = np.empty((m, wpad), np.int32)
        means = np.empty((m,), np.float64)
        sds = np.empty((m,), np.float64)
        miss = np.empty((m,), np.int64)
        total = self._lib.bed_decode_packed(
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), m, n,
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), wpad,
            means.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            sds.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            miss.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), n_threads)
        if total < 0:
            raise ValueError("bed_decode_packed: invalid arguments")
        return words, means, sds, miss, int(total)


def get_native_bed() -> Optional[NativeBedDecoder]:
    global _BED, _BED_TRIED
    if _BED_TRIED:
        return _BED
    _BED_TRIED = True
    so = _native_so("libbedreader.so")
    if _ensure_built(so):
        try:
            _BED = NativeBedDecoder(ctypes.CDLL(so))
        except OSError:
            _BED = None
    return _BED
