"""The port's functional API and CSV sink (bayesrrcpp_tpu_torch/api.py,
io/sink.py) against the JAX package's schema, on the CPU."""
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu.io.sink import csv_header as j_csv_header
from bayesrrcpp_tpu_torch import (BayesRConfig, HorseshoeConfig,
                                  HorseshoeSampler, SpikeSlabSampler, api,
                                  simulate)
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
    """The groups and grstart schemas are ported (byte-equal to JAX's
    headers; tests/test_torch_resume.py holds every schema); a schema the
    reference has not raises, as JAX's."""
    for schema in ("groups", "grstart"):
        assert csv_header(schema, 3, 3, groups=2, F=1) == \
            j_csv_header(schema, 3, 3, groups=2, F=1)
    with pytest.raises(ValueError, match="schema"):
        csv_header("nope", 3, 3)


@pytest.mark.parametrize("name,entry", [("BayesRSamplerV2Groups", "item 6"),
                                        ("BRV2Grstart", "item 7")])
def test_entry_points_outside_the_slice_raise(name, entry, tmp_path):
    """Queue 1 items 6 and 7 are ported: each entry point runs on the CPU
    with JAX's positional signature and writes its schema's CSV
    (tests/test_torch_resume.py holds the round trip to JAX)."""
    sim = simulate.simulate_bayesr(seed=1, N=40, M=16, n_causal=2)
    cva = np.tile(CVA, (2, 1))
    g_assign = np.arange(16) % 2
    out = str(tmp_path / f"{name}.csv")
    hyper = (0.01, 0.001, 0.001, 0.001, 0.001, cva, 2, g_assign)
    if name == "BayesRSamplerV2Groups":
        st = api.BayesRSamplerV2Groups(out, 1, 10, 5, 1, sim.X, sim.Y,
                                       *hyper, np.ones((40, 1)),
                                       block_size=16, device="cpu")
        schema, F = "groups", 1
    else:
        st = api.BRV2Grstart(out, 1, 10, 5, 1, 0.1, np.zeros(16), 1.0,
                             np.ones(2), sim.X, sim.Y, np.zeros(16), *hyper,
                             block_size=16, device="cpu")
        schema, F = "grstart", 0
    header, rows = _read_csv(out)
    assert ",".join(header) + "\n" == j_csv_header(schema, 16, 40, 2, F)
    assert len(rows) == 5 and all(len(r) == len(header) for r in rows)
    assert st.iteration == 10 and st.sigmaGG.shape == (2,)


def test_run_chains_raises():
    """Dense X on the plain Gram-blocked sweep (``api``'s backend, and the
    samplers' default on the CPU) has no fused multi-chain kernel:
    ``fused=True`` raises."""
    sim = simulate.simulate_bayesr(seed=1, N=40, M=16, n_causal=2)
    s = SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=16),
                         device="cpu")
    assert not s.supports_fused_chains
    with pytest.raises(ValueError, match="fused"):
        s.run_chains(torch.Generator().manual_seed(0), 4,
                     ChainConfig(10, 5), fused=True)


def test_entry_points_without_a_card_raise(monkeypatch):
    """No ``device`` and no card: the samplers and ``api`` functions raise
    rather than run on the CPU; an explicit CPU device or a CPU tensor X
    runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = simulate.simulate_bayesr(seed=1, N=40, M=16, n_causal=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HorseshoeSampler(sim.X, sim.Y, HorseshoeConfig(block_size=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.BayesRSamplerV2("unused.csv", 1, 4, 2, 1, sim.X, sim.Y, 0.01,
                            0.001, 0.001, 0.001, 0.001, CVA, block_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.HorseshoeR("unused.csv", 1, 4, 2, 1, sim.X, sim.Y, 1.0, 0.001,
                       0.001, 1.0, 1.0, 1.0, 10.0, 10.0, block_size=16)
    s = SpikeSlabSampler(torch.as_tensor(sim.X), sim.Y, CVA,
                         BayesRConfig(block_size=16))
    assert s.device.type == "cpu"


@pytest.mark.parametrize("burn_in,thinning,emit_epsilon",
                         [(20, 5, True), (17, 4, False)])
def test_rows_align_and_first_emission(tmp_path, burn_in, thinning,
                                       emit_epsilon):
    sim = simulate.simulate_bayesr(seed=41, N=120, M=48, n_causal=6, h2=0.5)
    out = tmp_path / "c1.csv"
    api.BayesRSamplerV2(str(out), 2, 40, burn_in, thinning, sim.X, sim.Y,
                        0.01, 0.001, 0.001, 0.001, 0.001, CVA, block_size=16,
                        emit_epsilon=emit_epsilon, device="cpu")
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
                                block_size=16, emit_epsilon=False,
                                device="cpu")
    _, rows = _read_csv(out)
    vals = np.array(rows, float)
    bh = vals[:, 2:2 + 160].mean(axis=0)
    corr = np.corrcoef(sim.beta_true, bh)[0, 1]
    assert corr > 0.8, corr
    assert np.isfinite(vals).all() and state.iteration == 150

