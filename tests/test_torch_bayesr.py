"""The port's BayesR sampler (bayesrrcpp_tpu_torch/models/bayesr.py)
against the JAX package, on the CPU.

- The Jacobi plan: the port must choose the same (J, B, layout) and Mpad as
  the reference for every M, since the plan fixes the Markov kernel.
- Variate-injected steps: the port draws through a variates object that
  replays the JAX sampler's own draws from its PRNG key (ROADMAP "How a
  part is held against the reference"), so init and each step must agree
  with JAX ``SpikeSlabSampler(..., x_dtype="2bit")`` run in interpret mode:
  labels exactly, floats to f32 reassociation.
- Statistical: a ``TorchVariates`` chain recovers the planted effects on
  the tests/test_layout.py:134-152 recipe.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu import distributions as jdist
from bayesrrcpp_tpu.ops import block_sweep as jbs
from bayesrrcpp_tpu.ops.pallas_jacobi import auto_jacobi_plan as j_plan
from bayesrrcpp_tpu.ops.pallas_jacobi import planned_mpad as j_mpad
from bayesrrcpp_tpu_torch import BayesRConfig, ChainConfig, SpikeSlabSampler
from bayesrrcpp_tpu_torch import simulate
from bayesrrcpp_tpu_torch.convert import (data_from_jax, state_from_jax,
                                          unpermute_eps)
from bayesrrcpp_tpu_torch.ops import genotypes
from bayesrrcpp_tpu_torch.ops.jacobi import auto_jacobi_plan, planned_mpad

CVA = np.array([0.0001, 0.001, 0.01])


@pytest.mark.parametrize("block", [512, 256, 32])
def test_plan_matches_jax(block):
    Ms = [96, 100, 160, 1024, 2000, 2048, 4096, 8192, 10_000, 49_152,
          100_000, 246_000, 503_808]
    for M in Ms:
        assert auto_jacobi_plan(M, block) == j_plan(M, block), M
        assert planned_mpad(M, block) == j_mpad(M, block), M
    assert auto_jacobi_plan(503_808, 512) == (128, 32, "t")


class JaxReplayVariates:
    """The JAX sampler's draws, re-derived from its key exactly as
    ``bayesrrcpp_tpu/models/bayesr.py`` draws them (init :391-394,
    _pre_sweep :511-519, the strided step :590-599, _hyper_block :556-579).
    """

    def __init__(self, key):
        self.key = key

    @staticmethod
    def _t(x):
        return torch.as_tensor(np.array(x, np.float32))

    def init_sigmaGG(self, G):
        self.key, kG, _ = jax.random.split(self.key, 3)
        return self._t(jax.vmap(
            lambda k: jdist.beta_rng(k, 1.0, 1.0, dtype=jnp.float32))(
                jax.random.split(kG, G)))

    def begin_step(self):
        self.keys = jax.random.split(self.key, 11)
        self.key = self.keys[0]

    def mu_noise(self):
        return self._t(jax.random.normal(self.keys[1], (), jnp.float32))

    def orders(self, nb, B, J):
        rho, inner = jbs.strided_orders(self.keys[4], nb, B, J)
        return (torch.as_tensor(np.array(rho)),
                torch.as_tensor(np.array(inner)))

    def p(self, n):
        return self._t(jax.random.uniform(self.keys[5], (n,), jnp.float32))

    def z(self, n):
        return self._t(jax.random.normal(self.keys[6], (n,), jnp.float32))

    def sigmaE_gamma(self, shape):
        # the JAX draw is f64 under the tests' x64 mode (a python-float dof)
        return self._t(jax.random.gamma(self.keys[7],
                                        jnp.asarray(shape, jnp.float64)))

    def sigmaG_gamma(self, shapes):
        ks = jax.random.split(self.keys[9], shapes.shape[0])
        return self._t(jax.vmap(jax.random.gamma)(
            ks, jnp.asarray(shapes.numpy(), jnp.float32)))

    def pi_gamma(self, alpha):
        ks = jax.random.split(self.keys[10], alpha.shape[0])
        return self._t(jax.vmap(jax.random.gamma)(
            ks, jnp.asarray(alpha.numpy(), jnp.float32)))


def _np_state(st):
    return {k: np.array(v) for k, v in st._asdict().items()}


def _assert_states_close(js, ts, sampler):
    np.testing.assert_array_equal(np.asarray(js.labels), ts.labels.numpy())
    np.testing.assert_allclose(np.asarray(js.beta), ts.beta.numpy(),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(unpermute_eps(np.asarray(js.eps), sampler.Npad),
                               ts.eps.numpy(), rtol=2e-4, atol=2e-5)
    for name in ("mu", "sigmaE", "sigmaGG", "pi"):
        np.testing.assert_allclose(np.asarray(getattr(js, name)),
                                   getattr(ts, name).numpy(), rtol=1e-4,
                                   err_msg=name)
    assert int(js.iteration) == ts.iteration


def test_steps_match_jax_sampler_with_replayed_variates():
    N, M = 2000, 4096
    rng = np.random.default_rng(5)
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(
        float)
    beta_t = np.zeros(M)
    beta_t[rng.choice(M, 20, replace=False)] = rng.normal(0, 0.2, 20)
    Y = (dosage - dosage.mean(0)) / dosage.std(0, ddof=1) @ beta_t \
        + rng.normal(0, 0.8, N)

    js = jbr.SpikeSlabSampler(dosage, Y, CVA, jbr.BayesRConfig(),
                              x_dtype="2bit", dtype=jnp.float32)
    ts = SpikeSlabSampler(dosage, Y, CVA, BayesRConfig(), x_dtype="2bit")
    assert (js.jacobi, js.B, js.jacobi_layout) == (16, 32, "t")
    assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad, ts.Npad) == \
        (16, 32, "t", js.Mpad, js.Npad)
    # the sweep inputs carried across exactly (the port's own stats are
    # held to JAX in test_torch_genotypes.py)
    ts.data = data_from_jax(
        {k: np.array(v) for k, v in js.data._asdict().items()}, N=N,
        device="cpu")

    key = jax.random.PRNGKey(3)
    rv = JaxReplayVariates(key)
    jst = js.init(key)
    tst = ts.init(rv)
    _assert_states_close(jst, tst, ts)
    for n_steps in (1, 2):        # states after 1 and after 3 steps
        for _ in range(n_steps):
            jst = js.step(jst)
            tst = ts.step(tst, rv)
        np.testing.assert_array_equal(np.asarray(jst.key), np.asarray(rv.key))
        _assert_states_close(jst, tst, ts)
    # the JAX state carried across continues identically
    carried = state_from_jax(_np_state(jst), ts)
    np.testing.assert_allclose(carried.eps.numpy(), tst.eps.numpy(),
                               rtol=2e-4, atol=2e-5)


def test_torch_variates_chain_recovers_signal():
    """tests/test_layout.py:134-152 through the port: N=4096 (two
    2048-lane tiles), M=2048, block_size 256 -> plan (8, 32, "t"); 60
    burn-in steps, posterior mean over 40."""
    N, M = 4096, 2048
    g = torch.Generator().manual_seed(13)
    words = simulate.random_packed_words(g, M, N // 16, device="cpu")
    means, sds = simulate.packed_word_stats(M)
    bt = torch.zeros(M)
    bt[torch.randperm(M, generator=g)[:32]] = 0.25
    signal = genotypes.xbeta_packed(
        words, torch.as_tensor(means, dtype=torch.float32),
        torch.as_tensor(1.0 / sds, dtype=torch.float32), bt, 256, N)
    Y = signal + 0.7 * torch.randn(N, generator=g)
    s = SpikeSlabSampler(words, Y, CVA, BayesRConfig(block_size=256),
                         transposed=True, x_dtype="2bit",
                         x_stats=(means, sds))
    assert (s.jacobi, s.B, s.jacobi_layout) == (8, 32, "t")
    st, out = s.run(torch.Generator().manual_seed(6), ChainConfig(100, 60, 1))
    corr = np.corrcoef(out["beta"].mean(axis=0), bt.numpy())[0, 1]
    assert corr > 0.8, corr
    assert np.isfinite(out["sigmaE"]).all()
    # tracked eps vs the exact recompute Y - mu - X beta
    ex = s.refresh_eps(st)
    rel = torch.linalg.norm(st.eps - ex.eps) / torch.linalg.norm(ex.eps)
    assert float(rel) < 1e-4


@pytest.mark.parametrize("case", ["groups", "fixed", "int8", "missing",
                                  "row_plan", "scan"])
def test_configurations_outside_the_slice_raise(case):
    rng = np.random.default_rng(0)
    N, M = 64, 96
    dosage = rng.binomial(2, 0.4, size=(N, M)).astype(float)
    Y = rng.normal(size=N)
    kw = dict(x_dtype="2bit")
    cva = CVA
    if case == "groups":
        cva = np.tile(CVA, (2, 1))
    elif case == "fixed":
        kw["fixed"] = rng.normal(size=(N, 2))
    elif case == "int8":
        kw["x_dtype"] = "int8"
    elif case == "missing":
        dosage[3, 5] = np.nan
        dosage = np.concatenate([dosage] * 40, axis=1)   # a "t" plan
    elif case == "scan":
        kw = dict(backend="scan")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SpikeSlabSampler(dosage, Y, cva, BayesRConfig(), **kw)
