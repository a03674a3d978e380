"""The port's marker-sharded BayesR sampler driven end to end on the CPU,
on a (1, 1) mesh: a chain with torch variates recovers the planted
effects (tests/test_sharded.py's recipe and bound), and pre-packed words
are sliced and run as fused chains (``run_chains``).  The replays against
JAX are tests/test_torch_sharded.py and test_torch_sharded_dm2.py."""
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu_torch import BayesRConfig, ChainConfig, simulate
from bayesrrcpp_tpu_torch.ops import genotypes
from bayesrrcpp_tpu_torch.parallel import ShardedSpikeSlabSampler, make_mesh

CVA = np.array([0.001, 0.01, 0.1])


def test_torch_variates_chain_recovers_signal():
    """test_sharded.py:test_sharded_t_kernel_packed through the port on a
    (1, 1) mesh: 2-bit words, the "t" plan, corr above JAX's 0.75."""
    rng = np.random.default_rng(93)
    N, M = 320, 4096
    dosage = rng.binomial(2, rng.uniform(0.2, 0.8, M), size=(N, M)).astype(
        float)
    dense = (dosage - dosage.mean(0)) / dosage.std(0, ddof=1)
    bt = np.zeros(M)
    bt[rng.choice(M, 40, replace=False)] = rng.normal(0, 0.25, 40)
    y = dense @ bt + rng.normal(0, 0.7, N)
    s = ShardedSpikeSlabSampler(dosage, y, CVA, BayesRConfig(block_size=32),
                                make_mesh(1, 1, device="cpu"),
                                backend="pallas", x_dtype="2bit")
    assert s.strided and not s.data.has_missing
    st, out = s.run(torch.Generator().manual_seed(5), ChainConfig(120, 60, 5))
    corr = np.corrcoef(bt, out["beta"].mean(axis=0))[0, 1]
    assert corr > 0.75, corr
    assert np.isfinite(out["sigmaE"]).all()
    assert out["beta"].shape == (12, M) and out["comp"].shape == (12, M)
    rel = torch.linalg.norm(st.eps - s.refresh_eps(st).eps) / \
        torch.linalg.norm(st.eps)
    assert float(rel) < 1e-4


def test_prepacked_slices_and_run_chains():
    """Pre-packed words on the device, sliced by the sampler, and the
    fused ``run_chains`` through a chain axis of 2."""
    g = torch.Generator().manual_seed(4)
    M, Nw = 2048, 4096 // 16
    words = simulate.random_packed_words(g, M, Nw, device="cpu")
    means, sds = simulate.packed_word_stats(M)
    Y = torch.randn(4096, generator=g)
    s = ShardedSpikeSlabSampler(words, Y, CVA, BayesRConfig(block_size=256),
                                make_mesh(1, 1, device="cpu"),
                                backend="pallas", x_dtype="2bit",
                                transposed=True, x_stats=(means, sds),
                                has_missing=False)
    assert torch.equal(s.data.XT[:M], words)
    q = genotypes.quantize_packed(words, True, (means, sds), s.B, s.Mpad,
                                  4096, prepacked=True, device="cpu")
    torch.testing.assert_close(s.data.gram, q.gram)
    torch.testing.assert_close(s.data.xsq, q.xsq)
    st, out = s.run_chains(torch.Generator().manual_seed(1), 2,
                           ChainConfig(6, 2, 2))
    assert out["beta"].shape == (2, 2, M)
    assert np.isfinite(out["sigmaE"]).all()
    with pytest.raises(ValueError, match="has_missing"):
        ShardedSpikeSlabSampler(words, Y, CVA, BayesRConfig(block_size=256),
                                make_mesh(1, 1, device="cpu"),
                                backend="pallas", x_dtype="2bit",
                                transposed=True, x_stats=(means, sds),
                                has_missing=True)
