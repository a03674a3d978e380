"""Sample sinks: stream thinned posterior samples to disk.

Counterpart of ``bayesrrcpp_tpu/io/sink.py``'s CSV schemas, rows
``", "``-separated as Eigen's CommaInitFmt writes them
(src/BayesRv2.cpp:72):

- ``"bayesr"`` (src/BayesRv2.cpp:16-37): ``iteration, mu, beta[1..M],
  sigmaE, sigmaG, comp[1..M], epsilon[1..N]``;
- ``"groups"`` (src/BayesRv2Groups.cpp:25-54): ``iteration, mu,
  beta[1..M], sigmaE, comp[1..M], sigmaG[1..G], epsilon[1..N],
  alpha[1..F], sigmaF`` (comp before sigmaG, sigmaF last);
- ``"grstart"`` (src/BRv2Grstart.cpp:26-50): ``iteration, mu, beta[1..M],
  sigmaE, comp[1..M], sigmaG[1..G], epsilon[1..N]``;
- ``"horseshoe"`` (src/HorseshoeR.cpp:279-291): ``iteration, mu,
  beta[1..M], sigmaE, tau, lambda[1..M], epsilon[1..N]``, without the
  reference's trailing comma, so the columns align with the rows.

A background writer thread drains a bounded queue, so formatting overlaps
the next chunk's device work.  ``NpzSink`` is the columnar output (one
``.npz`` of every emitted field, written on close), ``TeeSink`` fans one
stream out to several sinks (the CLI's CSV + ``--npz-out``), ``MemorySink``
keeps the chunks in memory, and ``ChainFanoutSink`` splits a multi-chain
stream (``run_chains``) into one sink per chain, in any schema
(bayesrrcpp_tpu/io/sink.py:173-271).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Optional

import numpy as np

from .native import get_native_writer

# per schema, the columns in order: (name, width) with width "M", "N",
# "G", "F" or 1 (src/BayesRv2.cpp:16-37, src/BayesRv2Groups.cpp:25-54,
# src/BRv2Grstart.cpp:26-50, src/HorseshoeR.cpp:279-291); the rows' field
# of each column block is its name, epsilon's "epsilon"
_SCHEMAS = {
    "bayesr": (("beta", "M"), ("sigmaE", 1), ("sigmaG", 1), ("comp", "M"),
               ("epsilon", "N")),
    "groups": (("beta", "M"), ("sigmaE", 1), ("comp", "M"), ("sigmaG", "G"),
               ("epsilon", "N"), ("alpha", "F"), ("sigmaF", 1)),
    "grstart": (("beta", "M"), ("sigmaE", 1), ("comp", "M"),
                ("sigmaG", "G"), ("epsilon", "N")),
    "horseshoe": (("beta", "M"), ("sigmaE", 1), ("tau", 1), ("lambda", "M"),
                  ("epsilon", "N")),
}


def _columns(schema: str):
    if schema not in _SCHEMAS:
        raise ValueError(f"unknown schema {schema!r}")
    return _SCHEMAS[schema]


def csv_header(schema: str, M: int, N: int, groups: int = 0, F: int = 0,
               emit_epsilon: bool = True) -> str:
    """Reference-exact CSV header of ``schema``."""
    widths = {"M": M, "N": N if emit_epsilon else 0, "G": groups, "F": F}
    parts: List[str] = ["iteration", "mu"]
    for name, width in _columns(schema):
        if width == 1:
            parts.append(name)
        else:
            parts += [f"{name}[{i + 1}]" for i in range(widths[width])]
    return ",".join(parts) + "\n"


def assemble_rows(schema: str, rows: Dict[str, np.ndarray]) -> np.ndarray:
    """Stack an emission chunk into the (n, width) row layout of the
    schema (src/BayesRv2.cpp:260, src/BayesRv2Groups.cpp:317,
    src/BRv2Grstart.cpp:267, src/HorseshoeR.cpp:258)."""
    n = rows["mu"].shape[0]
    fields = [rows["iteration"], rows["mu"]] + [rows[name] for name, _ in
                                                _columns(schema)]
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


class NpzSink(_AsyncWriterMixin):
    """Columnar sink (bayesrrcpp_tpu/io/sink.py:173-196): keeps every
    chunk's fields and, on close, writes them concatenated over the
    emissions to one ``.npz`` (``np.savez_compressed``; the reference's
    only output is a CSV carrying the N residuals in every row)."""

    def __init__(self, path: str):
        self.path = path
        self._chunks: List[Dict[str, np.ndarray]] = []
        self._start_writer()

    def write(self, rows: Dict[str, np.ndarray]):
        self._submit(dict(rows))

    def _write_chunk(self, rows):
        self._chunks.append(rows)

    def close(self):
        super().close()
        if self._chunks:
            np.savez_compressed(self.path, **_merged(self._chunks))


class TeeSink:
    """One sample stream to several sinks, e.g. a CSV and an ``NpzSink``
    (bayesrrcpp_tpu/io/sink.py:199-215)."""

    def __init__(self, *sinks):
        self.sinks = sinks

    def write(self, rows):
        for s in self.sinks:
            s.write(rows)

    def flush(self):
        for s in self.sinks:
            s.flush()

    def close(self):
        for s in self.sinks:
            s.close()


class MemorySink(_AsyncWriterMixin):
    """The chunks in memory (bayesrrcpp_tpu/io/sink.py:218-235):
    ``result()`` is every field concatenated over the emissions."""

    def __init__(self):
        self.rows: List[Dict[str, np.ndarray]] = []
        self._start_writer()

    def write(self, rows):
        self._submit(rows)

    def _write_chunk(self, rows):
        self.rows.append(rows)

    def result(self) -> Dict[str, np.ndarray]:
        self.flush()
        return _merged(self.rows) if self.rows else {}


def _merged(chunks) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([c[k] for c in chunks], axis=0)
            for k in chunks[0]}


class ChainFanoutSink:
    """Split a multi-chain sample stream (fields shaped (emits, chains,
    ...)) into one sink per chain (bayesrrcpp_tpu/io/sink.py:238-271).

    ``make_sink(c)`` builds the sink of chain c;
    ``ChainFanoutSink.csv(path, n_chains, schema, **kw)`` writes one
    ``CSVSink`` per chain at ``path`` with ``.chain{c}`` inserted before the
    extension (``.csv`` when there is none).
    """

    def __init__(self, make_sink, n_chains: int):
        self.sinks = [make_sink(c) for c in range(n_chains)]

    @classmethod
    def csv(cls, path, n_chains, schema, **kw):
        root, ext = os.path.splitext(path)
        return cls(lambda c: CSVSink(f"{root}.chain{c}{ext or '.csv'}",
                                     schema, **kw), n_chains)

    @property
    def paths(self) -> List[str]:
        return [s.path for s in self.sinks]

    def write(self, rows: Dict[str, np.ndarray]):
        for c, s in enumerate(self.sinks):
            s.write({k: v[:, c] for k, v in rows.items()})

    def flush(self):
        for s in self.sinks:
            s.flush()

    def close(self):
        for s in self.sinks:
            s.close()
