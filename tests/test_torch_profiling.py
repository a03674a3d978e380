"""The port's ``utils/profiling.py`` against the JAX package's
(``bayesrrcpp_tpu/utils/profiling.py``), on the CPU: the throughput
record, the timer (tests/test_summary.py::test_chain_timer) and the
trace context."""
import os
import time

import pytest
import torch

from bayesrrcpp_tpu.utils import profiling as jprof
from bayesrrcpp_tpu_torch.utils import profiling as tprof


def test_chain_timer():
    t = tprof.ChainTimer(markers=1000)
    with t.compile():
        pass
    with t.measure(10):
        time.sleep(0.01)
    d = t.stats.as_dict()
    assert d["iterations"] == 10
    assert d["snp_updates_per_sec"] > 0
    assert d["elapsed_s"] >= 0.01
    with tprof.trace(None):  # no-op path
        pass


@pytest.mark.parametrize("fields", [
    dict(markers=503_808),
    dict(markers=503_808, iterations=30, elapsed_s=0.42123456,
         compile_s=1.23456),
    dict(markers=7, iterations=3, elapsed_s=1e-4, compile_s=0.0),
])
def test_chain_stats_as_dict_equals_jax(fields):
    ours = tprof.ChainStats(**fields)
    theirs = jprof.ChainStats(**fields)
    assert ours.as_dict() == theirs.as_dict()
    assert ours.snp_updates_per_sec == theirs.snp_updates_per_sec
    assert ours.gibbs_iters_per_min == theirs.gibbs_iters_per_min


def test_timer_window_on_a_cpu_device_counts_the_work():
    """``device="cpu"`` times the window as it is (no synchronize)."""
    t = tprof.ChainTimer(markers=10, device="cpu")
    with t.measure(2):
        torch.ones(1000).cumsum(0)
    assert t.stats.iterations == 2 and t.stats.elapsed_s > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.ones(256, 256) @ torch.ones(256, 256)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    assert (tmp_path / files[0]).stat().st_size > 0
