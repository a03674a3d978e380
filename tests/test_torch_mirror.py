"""The port's literal scan sampler against the NumPy mirror of the
reference iteration (tests/numpy_mirror.py), on the CPU, in float64.

As tests/test_golden_mirror.py holds JAX's: ``SpikeSlabSampler(...,
backend="scan", permutation="full", dtype=torch.float64)`` steps with the
JAX sampler's own draws (tests/torch_replay.py ``JaxReplay``: the full
permutation, p and z by position, the hyperparameters' gammas, all in
float64), and ``mirror_step`` -- the reference's C++ control flow, with
its y_tilde pass, branchy accumulate-and-break selection and m0-scaled
sigmaG draw -- steps from the port's init with the same key.  Three
iterations, ungrouped (N=250, M=96) and grouped (two groups, N=200,
M=80); ``_compare``'s tolerances: labels exact, beta and eps to rtol
1e-9, mu to 1e-10, sigmaE, sigmaGG and pi to 1e-9.
"""
import jax
import numpy as np
import torch

from bayesrrcpp_tpu import simulate
from bayesrrcpp_tpu_torch import BayesRConfig, GroupsConfig, SpikeSlabSampler
from tests.numpy_mirror import mirror_step
from tests.test_golden_mirror import _compare
from tests.torch_replay import JaxReplay

CVA = np.array([0.001, 0.01, 0.1])


class _State:
    """A port state read as test_golden_mirror's ``_compare`` reads JAX's."""

    def __init__(self, st):
        for k in ("mu", "beta", "labels", "eps", "sigmaE", "sigmaGG", "pi"):
            setattr(self, k, getattr(st, k).numpy())


def _run_pair(sim, cva2, g_assign, config, variant, iters=3):
    s = SpikeSlabSampler(sim.X, sim.Y, cva2, config, g_assign=g_assign,
                         backend="scan", permutation="full",
                         dtype=torch.float64, device="cpu")
    assert (s.backend, s.permutation, s.variant) == ("scan", "full", variant)
    rv = JaxReplay(jax.random.PRNGKey(17))
    st = s.init(rv)
    mirror = {"key": rv.key, "mu": float(st.mu), "beta": st.beta.numpy().copy(),
              "labels": st.labels.numpy().copy(), "eps": st.eps.numpy().copy(),
              "sigmaE": float(st.sigmaE),
              "sigmaGG": st.sigmaGG.numpy().copy(),
              "pi": st.pi.numpy().copy()}
    cfg = {"cva": np.atleast_2d(cva2), "v0E": config.v0E, "s02E": config.s02E,
           "v0G": config.v0G, "s02G": config.s02G}
    d = s.data
    XT, xsq = d.XT.numpy(), d.xsq.numpy()
    gas, valid = d.g_assign.numpy(), d.valid.numpy()
    for _ in range(iters):
        st = s.step(st, rv)
        mirror = mirror_step(XT, xsq, gas, mirror, cfg, variant, s.Mpad,
                             valid)
        assert np.array_equal(np.asarray(rv.key), np.asarray(mirror["key"]))
    assert st.beta.dtype == torch.float64 and st.iteration == iters
    return _State(st), mirror


def test_mirror_ungrouped():
    sim = simulate.simulate_bayesr(seed=71, N=250, M=96, n_causal=12, h2=0.5)
    st, mirror = _run_pair(sim, CVA, None, BayesRConfig(block_size=32),
                           "bayesr")
    _compare(st, mirror)


def test_mirror_grouped():
    sim = simulate.simulate_bayesr(seed=72, N=200, M=80, n_causal=10, h2=0.5,
                                   n_groups=2)
    st, mirror = _run_pair(sim, np.tile(CVA, (2, 1)), sim.g_assign,
                           GroupsConfig(block_size=32), "groups")
    _compare(st, mirror)
