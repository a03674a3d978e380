"""Sample sinks: stream thinned posterior samples to disk.

Counterpart of ``bayesrrcpp_tpu/io/sink.py`` for the ``"bayesr"`` schema
(src/BayesRv2.cpp:16-37): header ``iteration, mu, beta[1..M], sigmaE,
sigmaG, comp[1..M], epsilon[1..N]``, rows ``", "``-separated as Eigen's
CommaInitFmt writes them (src/BayesRv2.cpp:72).  A background writer thread
drains a bounded queue, so formatting overlaps the next chunk's device
work.  The other schemas (groups, grstart, horseshoe) come with their
samplers (ROADMAP Queue 1 items 6-8).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

import numpy as np

from .native import get_native_writer


def _check_schema(schema: str):
    if schema != "bayesr":
        raise NotImplementedError(
            f"CSV schema {schema!r} is not ported to bayesrrcpp_tpu_torch "
            f"yet (ROADMAP Queue 1 items 6-8)")


def csv_header(schema: str, M: int, N: int, groups: int = 0, F: int = 0,
               emit_epsilon: bool = True) -> str:
    """Reference-exact CSV header (src/BayesRv2.cpp:16-37)."""
    _check_schema(schema)
    parts: List[str] = ["iteration", "mu"]
    parts += [f"beta[{i+1}]" for i in range(M)]
    parts += ["sigmaE", "sigmaG"]
    parts += [f"comp[{i+1}]" for i in range(M)]
    if emit_epsilon:
        parts += [f"epsilon[{i+1}]" for i in range(N)]
    return ",".join(parts) + "\n"


def assemble_rows(schema: str, rows: Dict[str, np.ndarray]) -> np.ndarray:
    """Stack an emission chunk into the (n, width) row layout of the
    schema (src/BayesRv2.cpp:260)."""
    _check_schema(schema)
    n = rows["mu"].shape[0]
    fields = [rows["iteration"], rows["mu"], rows["beta"], rows["sigmaE"],
              rows["sigmaG"], rows["comp"], rows["epsilon"]]
    return np.concatenate(
        [np.asarray(f, np.float64).reshape(n, -1) for f in fields], axis=1)


class _AsyncWriterMixin:
    """Bounded-queue background writer."""

    def _start_writer(self, maxsize: int = 8):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                try:
                    self._write_chunk(item)
                except Exception as e:  # surfaced on write/flush/close
                    self._exc = e
            finally:
                self._q.task_done()

    def _submit(self, item):
        if self._exc is not None:
            raise self._exc
        self._q.put(item)

    def flush(self):
        self._q.join()  # blocks until every submitted chunk is written
        if self._exc is not None:
            raise self._exc

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._exc is not None:
            raise self._exc


class CSVSink(_AsyncWriterMixin):
    """Reference-schema CSV sample sink with a background writer thread."""

    def __init__(self, path: str, schema: str, M: int, N: int, *,
                 groups: int = 0, F: int = 0, emit_epsilon: bool = True):
        header = csv_header(schema, M, N, groups, F, emit_epsilon)
        self.path = path
        self.schema = schema
        self._native = get_native_writer()
        self._fh = open(path, "w", buffering=1 << 20)
        self._fh.write(header)
        self._start_writer()

    def write(self, rows: Dict[str, np.ndarray]):
        self._submit(assemble_rows(self.schema, rows))

    def _write_chunk(self, mat: np.ndarray):
        if self._native is not None:
            self._fh.write(self._native.format_rows(mat))
        else:
            out = [", ".join(repr(float(x)) for x in r) for r in mat]
            self._fh.write("\n".join(out) + "\n")

    def close(self):
        try:
            super().close()
        finally:
            self._fh.close()
