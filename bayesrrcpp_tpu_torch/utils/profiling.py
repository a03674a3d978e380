"""Profiling / throughput instrumentation.

Counterpart of ``bayesrrcpp_tpu/utils/profiling.py``.  The reference's
only instrumentation is a whole-chain wall-clock print (reference:
src/BayesRv2.cpp:167, 276-278).  This module provides the north-star
counter (SNP-updates/s and Gibbs iterations/min, ``ChainStats``), a timer
whose windows end when the card's work has ended (``ChainTimer``), and an
optional ``torch.profiler`` trace context for per-kernel timelines.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class ChainStats:
    """Throughput accounting for a sampler run."""

    markers: int
    iterations: int = 0
    elapsed_s: float = 0.0
    compile_s: float = 0.0

    @property
    def snp_updates_per_sec(self) -> float:
        return (self.markers * self.iterations / self.elapsed_s
                if self.elapsed_s else 0.0)

    @property
    def gibbs_iters_per_min(self) -> float:
        return 60.0 * self.iterations / self.elapsed_s if self.elapsed_s else 0.0

    def as_dict(self):
        return {
            "markers": self.markers,
            "iterations": self.iterations,
            "elapsed_s": round(self.elapsed_s, 3),
            "compile_s": round(self.compile_s, 3),
            "snp_updates_per_sec": round(self.snp_updates_per_sec, 1),
            "gibbs_iters_per_min": round(self.gibbs_iters_per_min, 2),
        }


class ChainTimer:
    """Measure sampler throughput with warmup-aware timing.

    Usage:
        timer = ChainTimer(markers=sampler.M, device=sampler.device)
        with timer.compile():            # first call (kernel build + run)
            state = sampler._run_steps(state, v, n)
        with timer.measure(n):
            state = sampler._run_steps(state, v, n)
        print(timer.stats.as_dict())

    CUDA launches return before the card has run them, so on a CUDA
    ``device`` (None: the current card, once CUDA is initialized) each
    window ends with ``torch.cuda.synchronize``: the time holds the card's
    work, as the JAX timer's ``block_until_ready``.
    """

    def __init__(self, markers: int, device=None):
        self.stats = ChainStats(markers=markers)
        self.device = None if device is None else torch.device(device)

    def _sync(self):
        if self.device is None:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def compile(self):
        t0 = time.perf_counter()
        yield
        self._sync()
        self.stats.compile_s += time.perf_counter() - t0

    @contextlib.contextmanager
    def measure(self, iterations: int):
        t0 = time.perf_counter()
        yield
        self._sync()
        self.stats.elapsed_s += time.perf_counter() - t0
        self.stats.iterations += iterations


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace context: the host's and, where there is a
    card, the card's activity, written as a Chrome trace (JSON, for
    chrome://tracing, Perfetto or TensorBoard) into ``log_dir``.

    No-op when ``log_dir`` is None so call sites can keep the context
    unconditionally.
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
