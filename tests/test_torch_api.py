"""The port's functional API and CSV sink (bayesrrcpp_tpu_torch/api.py,
io/sink.py) against the JAX package's schema, on the CPU."""
import numpy as np
import pytest

from bayesrrcpp_tpu.io.sink import csv_header as j_csv_header
from bayesrrcpp_tpu_torch import BayesRConfig, SpikeSlabSampler, api, simulate
from bayesrrcpp_tpu_torch.config import ChainConfig
from bayesrrcpp_tpu_torch.io.sink import csv_header

CVA = np.array([0.001, 0.01, 0.1])


def _read_csv(path):
    with open(path) as f:
        header = f.readline().rstrip("\n").split(",")
        rows = [r.split(", ") for r in f.read().strip().split("\n") if r]
    return header, rows


@pytest.mark.parametrize("emit_epsilon", [True, False])
def test_csv_header_matches_jax(emit_epsilon):
    assert csv_header("bayesr", 7, 5, emit_epsilon=emit_epsilon) == \
        j_csv_header("bayesr", 7, 5, emit_epsilon=emit_epsilon)


def test_other_schemas_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        csv_header("horseshoe", 3, 3)


@pytest.mark.parametrize("name,entry", [("BayesRSamplerV2Groups", "item 7"),
                                        ("BRV2Grstart", "item 6"),
                                        ("HorseshoeR", "item 8")])
def test_entry_points_outside_the_slice_raise(name, entry):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {entry}"):
        getattr(api, name)("unused.csv", 1, 10, 5, 1)


def test_run_chains_raises():
    sim = simulate.simulate_bayesr(seed=1, N=40, M=16, n_causal=2)
    s = SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=16))
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        s.run_chains(None, 4, ChainConfig(10, 5))


@pytest.mark.parametrize("burn_in,thinning,emit_epsilon",
                         [(20, 5, True), (17, 4, False)])
def test_rows_align_and_first_emission(tmp_path, burn_in, thinning,
                                       emit_epsilon):
    sim = simulate.simulate_bayesr(seed=41, N=120, M=48, n_causal=6, h2=0.5)
    out = tmp_path / "c1.csv"
    api.BayesRSamplerV2(str(out), 2, 40, burn_in, thinning, sim.X, sim.Y,
                        0.01, 0.001, 0.001, 0.001, 0.001, CVA, block_size=16,
                        emit_epsilon=emit_epsilon)
    header, rows = _read_csv(out)
    M, N = 48, 120
    assert len(header) == 2 + 2 * M + 2 + (N if emit_epsilon else 0)
    assert all(len(r) == len(header) for r in rows)
    first = -(-burn_in // thinning) * thinning
    assert float(rows[0][0]) == first
    assert [int(float(r[0])) for r in rows] == \
        list(ChainConfig(40, burn_in, thinning).emit_iterations())
    vals = np.array(rows, float)
    assert np.isfinite(vals).all()
    comps = vals[:, 4 + M:4 + 2 * M]
    assert set(np.unique(comps)) <= {0.0, 1.0, 2.0, 3.0}


def test_api_recovers_signal(tmp_path):
    """tests/test_jacobi_t.py:218-232's recipe through the dense API."""
    sim = simulate.simulate_bayesr(seed=77, N=400, M=160, n_causal=16,
                                   h2=0.5)
    out = tmp_path / "rec.csv"
    state = api.BayesRSamplerV2(str(out), 7, 150, 75, 5, sim.X, sim.Y, 0.01,
                                0.001, 0.001, 0.001, 0.001, CVA,
                                block_size=16, emit_epsilon=False)
    _, rows = _read_csv(out)
    vals = np.array(rows, float)
    bh = vals[:, 2:2 + 160].mean(axis=0)
    corr = np.corrcoef(sim.beta_true, bh)[0, 1]
    assert corr > 0.8, corr
    assert np.isfinite(vals).all() and state.iteration == 150

