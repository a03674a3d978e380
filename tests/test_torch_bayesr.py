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
    ``bayesrrcpp_tpu/models/bayesr.py`` draws them (init :391-396,
    init_from :424-435, _pre_sweep :511-530, the strided step :590-599,
    _hyper_block :553-579), the groups variant's fixed-effect and sigmaF
    draws included.
    """

    def __init__(self, key):
        self.key = key

    @staticmethod
    def _t(x):
        return torch.as_tensor(np.array(x, np.float32))

    def init_sigmaGG(self, G):
        self.key, kG, self.kF = jax.random.split(self.key, 3)
        return self._t(jax.vmap(
            lambda k: jdist.beta_rng(k, 1.0, 1.0, dtype=jnp.float32))(
                jax.random.split(kG, G)))

    def init_sigmaF(self):
        return self._t(jax.random.uniform(self.kF, (), jnp.float32))

    def init_from_pi_gamma(self, alpha):
        self.key, kpi = jax.random.split(self.key)
        ks = jax.random.split(kpi, alpha.shape[0])
        return self._t(jax.vmap(jax.random.gamma)(
            ks, jnp.asarray(alpha.numpy(), jnp.float32)))

    def fixed_order(self, F):
        return torch.as_tensor(np.array(jax.random.permutation(
            self.keys[2], F)))

    def fixed_z(self, F):
        return self._t(jax.random.normal(self.keys[3], (F,), jnp.float32))

    def sigmaF_gamma(self, shape):
        # a python-float dof: f64 under the tests' x64, as JAX's draw
        return self._t(jax.random.gamma(self.keys[8],
                                        jnp.asarray(shape, jnp.float64)))

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
    ts = SpikeSlabSampler(dosage, Y, CVA, BayesRConfig(), x_dtype="2bit",
                          device="cpu")
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
                         x_stats=(means, sds), device="cpu")
    assert (s.jacobi, s.B, s.jacobi_layout) == (8, 32, "t")
    st, out = s.run(torch.Generator().manual_seed(6), ChainConfig(100, 60, 1))
    corr = np.corrcoef(out["beta"].mean(axis=0), bt.numpy())[0, 1]
    assert corr > 0.8, corr
    assert np.isfinite(out["sigmaE"]).all()
    # tracked eps vs the exact recompute Y - mu - X beta
    ex = s.refresh_eps(st)
    rel = torch.linalg.norm(st.eps - ex.eps) / torch.linalg.norm(ex.eps)
    assert float(rel) < 1e-4


@pytest.mark.parametrize("case", ["groups", "fixed", "int8", "row_plan",
                                  "scan", "dense_row_plan"])
def test_configurations_outside_the_slice_raise(case):
    rng = np.random.default_rng(0)
    N, M = 64, 96
    dosage = rng.binomial(2, 0.4, size=(N, M)).astype(float)
    Y = rng.normal(size=N)
    kw = dict(x_dtype="2bit", device="cpu")
    cva = CVA
    if case == "groups":
        cva = np.tile(CVA, (2, 1))
    elif case == "fixed":
        kw["fixed"] = rng.normal(size=(N, 2))
    elif case == "row_plan":
        # row layout with J > 1: ported, the step equals JAX's on that plan
        # (M=96's own J=1 plan runs the serial sweep)
        kw.update(jacobi_blocks=2, jacobi_layout="row")
    elif case == "scan":
        kw = dict(backend="scan", device="cpu")
    elif case == "dense_row_plan":
        # dense X through the kernels, on a row-layout plan with J > 1:
        # ported, as row_plan
        kw = dict(backend="pallas", jacobi_blocks=2, jacobi_layout="row",
                  device="cpu")
    if case in ("groups", "fixed"):
        # ported (Queue 1 item 6): the bayesr variant with per-group rows or
        # fixed effects builds as JAX's (tests/test_torch_groups.py replays
        # the groups variant's steps) and steps
        js = jbr.SpikeSlabSampler(dosage, Y, cva, jbr.BayesRConfig(),
                                  x_dtype="2bit", fixed=kw.get("fixed"),
                                  dtype=jnp.float32)
        ts = SpikeSlabSampler(dosage, Y, cva, BayesRConfig(), **kw)
        assert (ts.variant, ts.G, ts.F) == (js.variant, js.G, js.F)
        np.testing.assert_allclose(ts.data.prior_pi.numpy(),
                                   np.asarray(js.data.prior_pi), rtol=1e-7)
        g = torch.Generator().manual_seed(0)
        st = ts.step(ts.init(g), g)
        assert st.sigmaGG.shape == (ts.G,) and st.alpha.shape == (ts.F,)
        assert bool(torch.isfinite(st.eps).all())
        rel = torch.linalg.norm(st.eps - ts.refresh_eps(st).eps) \
            / torch.linalg.norm(st.eps)
        assert float(rel) < 1e-5
        return
    if case in ("row_plan", "dense_row_plan"):
        # (imported here: that module imports this one's replay variates)
        from tests.test_torch_row_samplers import assert_row_step_matches_jax

        assert_row_step_matches_jax("bayesr", dosage, Y, cva, **kw)
        return
    if case == "int8":
        # int8 codes: ported, a replayed step equals JAX's (both at the
        # J=1 plan of M=96: the serial int8 fold sweep)
        from tests.test_torch_int8_samplers import \
            assert_int8_step_matches_jax

        assert_int8_step_matches_jax("bayesr", dosage, Y, cva)
        return
    # the scan (Queue 1 item 8): ported, with JAX's option checks (its
    # replayed steps: tests/test_torch_scan.py, test_torch_mirror.py)
    s = SpikeSlabSampler(dosage, Y, cva, BayesRConfig(), **kw)
    assert (s.backend, s.permutation) == ("scan", "full")
    g = torch.Generator().manual_seed(0)
    assert bool(torch.isfinite(s.step(s.init(g), g).eps).all())
    for bad in (dict(x_dtype="2bit"), dict(permutation="full",
                                           backend="blocked")):
        with pytest.raises(ValueError, match="backend"):
            SpikeSlabSampler(dosage, Y, cva, BayesRConfig(),
                             **{**kw, **bad})
