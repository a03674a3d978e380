"""The port's regularized-horseshoe sampler (bayesrrcpp_tpu_torch/models/
horseshoe.py) against the JAX package, on the CPU.

- Variate-injected steps: the port draws through a variates object that
  replays the JAX sampler's own draws from its PRNG key, so init,
  init_from and each step must agree with JAX ``HorseshoeSampler`` (packed
  2-bit through the interpret-mode kernel, and dense through the blocked
  sweep) to f32 reassociation: rtol 2e-4 on every state field.
- ``gamma_shape_rng``: the moments of each of its three branches.
- The ``"horseshoe"`` CSV schema byte for byte against the JAX sink's, and
  ``api.HorseshoeR`` end to end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu import distributions as jdist
from bayesrrcpp_tpu.io import sink as jsink
from bayesrrcpp_tpu.ops import block_sweep as jbs
from bayesrrcpp_tpu_torch import (ChainConfig, HorseshoeConfig,
                                  HorseshoeSampler, api, distributions,
                                  simulate)
from bayesrrcpp_tpu_torch.convert import (horseshoe_data_from_jax,
                                          horseshoe_state_from_jax,
                                          unpermute_eps)
from bayesrrcpp_tpu_torch.io import sink as tsink


def _hs_config(N, M, n_causal, block_size):
    # the reference smoke script's hyper recipe (tests/test_horseshoe.py:15-19)
    A = (1.0 / np.sqrt(N)) * n_causal / (M - n_causal)
    return dict(A=A, v0E=0.001, s02E=0.001, vL=1.0, vT=1.0, c2=1.0, vC=10.0,
                sC=10.0, block_size=block_size)


class JaxHorseshoeReplayVariates:
    """The JAX horseshoe sampler's draws, re-derived from its key exactly
    as ``bayesrrcpp_tpu/models/horseshoe.py`` draws them (init :286-292,
    init_from :320-345, the step's 10 keys :388-389)."""

    def __init__(self, key):
        self.key = key

    @staticmethod
    def _t(x):
        return torch.as_tensor(np.array(x, np.float32))

    @staticmethod
    def _gamma(k, shape):
        # a python-float shape: the JAX draw is f64 under the tests' x64
        return jax.random.gamma(k, jnp.asarray(shape, jnp.float64))

    def init_gammas(self, eta_shape, tau_shape):
        self.key, keta, ktau = jax.random.split(self.key, 3)
        return (self._t(self._gamma(keta, eta_shape)),
                self._t(self._gamma(ktau, tau_shape)))

    def init_from_gammas(self, eta_shape, local_alpha, n, c2_shape):
        self.key, keta, kv, kc2 = jax.random.split(self.key, 4)
        return (self._t(self._gamma(keta, eta_shape)),
                self._t(jdist.gamma_shape_rng(kv, local_alpha, n,
                                              dtype=jnp.float32)),
                self._t(self._gamma(kc2, c2_shape)))

    def begin_step(self):
        self.keys = jax.random.split(self.key, 10)
        self.key = self.keys[0]
        self.local_keys = [self.keys[3], self.keys[6]]   # v, then lambda

    def mu_noise(self):
        return self._t(jax.random.normal(self.keys[1], (), jnp.float32))

    def eta_gamma(self, shape):
        return self._t(self._gamma(self.keys[2], shape))

    def local_gamma(self, alpha, n):
        return self._t(jdist.gamma_shape_rng(self.local_keys.pop(0), alpha,
                                             n, dtype=jnp.float32))

    def orders(self, nb, B, J):
        rho, inner = jbs.strided_orders(self.keys[4], nb, B, J)
        return (torch.as_tensor(np.array(rho)),
                torch.as_tensor(np.array(inner)))

    def block_orders(self, nb, B):
        border, inner = jbs.block_orders(self.keys[4], nb, B)
        return (torch.as_tensor(np.array(border)),
                torch.as_tensor(np.array(inner)))

    def z(self, n):
        return self._t(jax.random.normal(self.keys[5], (n,), jnp.float32))

    def tau_gamma(self, shape):
        return self._t(self._gamma(self.keys[7], shape))

    def c2_gamma(self, shape):
        return self._t(self._gamma(self.keys[8], shape))

    def sigmaE_gamma(self, shape):
        return self._t(self._gamma(self.keys[9], shape))


def _data(seed, N, M):
    rng = np.random.default_rng(seed)
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(
        float)
    beta_t = np.zeros(M)
    beta_t[rng.choice(M, 20, replace=False)] = rng.normal(0, 0.2, 20)
    X = (dosage - dosage.mean(0)) / dosage.std(0, ddof=1)
    return dosage, X, X @ beta_t + rng.normal(0, 0.8, N)


def _assert_states_close(js, ts, sampler):
    eps = np.asarray(js.eps)
    if sampler.x_packed:
        eps = unpermute_eps(eps, sampler.Npad)
    np.testing.assert_allclose(eps, ts.eps.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(js.beta), ts.beta.numpy(),
                               rtol=2e-4, atol=2e-6)
    for name in ("mu", "sigmaE", "lam", "v", "tau", "eta", "c2"):
        np.testing.assert_allclose(np.asarray(getattr(js, name)),
                                   getattr(ts, name).numpy(), rtol=2e-4,
                                   err_msg=name)
    assert int(js.iteration) == ts.iteration


@pytest.mark.parametrize("storage", ["packed", "dense"])
def test_steps_match_jax_sampler_with_replayed_variates(storage):
    """Packed: N=2000 (pad lanes) x M=1000 (pad markers to Mpad=1024) on an
    explicit (8, 32, "t") plan through the interpret-mode kernel.  Dense:
    the blocked sweep behind ``api.HorseshoeR``."""
    N, M = (2000, 1000) if storage == "packed" else (300, 200)
    dosage, X, Y = _data(5, N, M)
    cfg = _hs_config(N, M, 20, 32 if storage == "packed" else 64)
    if storage == "packed":
        kw = dict(x_dtype="2bit", jacobi_blocks=8, jacobi_layout="t")
        js = jbr.HorseshoeSampler(dosage, Y, jbr.HorseshoeConfig(**cfg),
                                  dtype=jnp.float32, **kw)
        ts = HorseshoeSampler(dosage, Y, HorseshoeConfig(**cfg), **kw,
                              device="cpu")
        assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad, ts.Npad) == \
            (8, 32, "t", js.Mpad, js.Npad) == (8, 32, "t", 1024, 2048)
        # the sweep inputs carried across exactly (the port's own stats are
        # held to JAX in test_torch_genotypes.py)
        ts.data = horseshoe_data_from_jax(
            {k: np.array(v) for k, v in js.data._asdict().items()}, N=N,
            device="cpu")
    else:
        js = jbr.HorseshoeSampler(X, Y, jbr.HorseshoeConfig(**cfg),
                                  dtype=jnp.float32)
        ts = HorseshoeSampler(X, Y, HorseshoeConfig(**cfg), device="cpu")
        assert (js.backend, ts.backend, ts.B, ts.Mpad) == \
            ("blocked", "blocked", 64, js.Mpad)

    key = jax.random.PRNGKey(3)
    rv = JaxHorseshoeReplayVariates(key)
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
    carried = horseshoe_state_from_jax(
        {k: np.array(v) for k, v in jst._asdict().items()}, ts)
    for name in ("eps", "beta", "lam", "tau"):
        np.testing.assert_allclose(getattr(carried, name).numpy(),
                                   getattr(tst, name).numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_init_from_matches_jax():
    N, M = 300, 200
    _, X, Y = _data(8, N, M)
    cfg = _hs_config(N, M, 20, 64)
    js = jbr.HorseshoeSampler(X, Y, jbr.HorseshoeConfig(**cfg),
                              dtype=jnp.float32)
    ts = HorseshoeSampler(X, Y, HorseshoeConfig(**cfg), device="cpu")
    rng = np.random.default_rng(1)
    prev = dict(mu=0.03, beta=rng.normal(0, 0.05, M), sigmaE=0.7, tau=0.002,
                lam=rng.uniform(0.2, 3.0, M), epsilon=rng.normal(0, 1, N))
    key = jax.random.PRNGKey(11)
    rv = JaxHorseshoeReplayVariates(key)
    jst = js.init_from(key, **prev)
    tst = ts.init_from(rv, **prev)
    _assert_states_close(jst, tst, ts)
    # pad lambdas are 1, pad betas 0
    assert ts.Mpad > M and (tst.lam[M:] == 1).all() and (tst.beta[M:] == 0).all()
    jst, tst = js.step(jst), ts.step(tst, rv)
    _assert_states_close(jst, tst, ts)


@pytest.mark.parametrize("alpha", [0.5, 1.0, 1.5, 2.0, 2.5, 0.7])
def test_gamma_shape_rng_moments(alpha):
    """Gamma(alpha, 1) has mean and variance alpha; 2e5 draws put the
    sample mean within 5 sd (5*sqrt(alpha/n)) and the variance within 5 %
    (the sd of the sample variance is sqrt(alpha*(6+2*alpha)/n))."""
    n = 200_000
    g = distributions.gamma_shape_rng(torch.Generator().manual_seed(4),
                                      alpha, n)
    assert g.shape == (n,) and g.dtype == torch.float32 and (g > 0).all()
    x = g.double()
    assert abs(float(x.mean()) - alpha) < 5 * np.sqrt(alpha / n)
    assert abs(float(x.var()) / alpha - 1) < 0.05


@pytest.mark.parametrize("emit_epsilon", [True, False])
def test_csv_header_and_rows_match_jax(tmp_path, emit_epsilon):
    M, N, n = 5, 4, 3
    assert tsink.csv_header("horseshoe", M, N, emit_epsilon=emit_epsilon) \
        == jsink.csv_header("horseshoe", M, N, emit_epsilon=emit_epsilon)
    rng = np.random.default_rng(2)
    rows = {"iteration": np.arange(n) * 10 + 20,
            "mu": rng.normal(size=n).astype(np.float32),
            "beta": rng.normal(size=(n, M)).astype(np.float32),
            "sigmaE": rng.uniform(size=n).astype(np.float32),
            "tau": rng.uniform(size=n).astype(np.float32),
            "lambda": rng.uniform(size=(n, M)).astype(np.float32),
            "epsilon": rng.normal(size=(n, N if emit_epsilon else 0)).astype(
                np.float32)}
    paths = []
    for mod, name in ((tsink, "port.csv"), (jsink, "jax.csv")):
        path = tmp_path / name
        s = mod.CSVSink(str(path), "horseshoe", M=M, N=N,
                        emit_epsilon=emit_epsilon)
        s.write(rows)
        s.close()
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_api_horseshoe_end_to_end(tmp_path):
    """``api.HorseshoeR`` on the dense blocked path: the CSV's widths,
    emitted iterations and values, and recovery of the planted effects
    (the tests/test_horseshoe.py recipe, shortened)."""
    N, M, nc = 400, 160, 16
    sim = simulate.simulate_bayesr(seed=21, N=N, M=M, n_causal=nc, h2=0.5)
    c = _hs_config(N, M, nc, 32)
    out = tmp_path / "hs.csv"
    state = api.HorseshoeR(str(out), 7, 200, 100, 5, sim.X, sim.Y, c["A"],
                           c["v0E"], c["s02E"], c["vL"], c["vT"], c["c2"],
                           c["vC"], c["sC"], block_size=32, device="cpu")
    with open(out) as f:
        header = f.readline().rstrip("\n").split(",")
        rows = [r.split(", ") for r in f.read().strip().split("\n")]
    assert header == tsink.csv_header("horseshoe", M, N).rstrip().split(",")
    assert len(header) == 2 + 2 * M + 2 + N
    assert all(len(r) == len(header) for r in rows)
    vals = np.array(rows, float)
    assert list(vals[:, 0]) == list(ChainConfig(200, 100, 5).emit_iterations())
    assert np.isfinite(vals).all() and (vals[:, 3 + M] > 0).all()   # tau
    assert (vals[:, 4 + M:4 + 2 * M] > 0).all()                     # lambda
    corr = np.corrcoef(sim.beta_true, vals[:, 2:2 + M].mean(axis=0))[0, 1]
    assert corr > 0.8, corr
    assert state.iteration == 200


@pytest.mark.parametrize("case", ["int8", "row_plan", "scan",
                                  "dense_kernel"])
def test_configurations_outside_the_slice_raise(case):
    rng = np.random.default_rng(0)
    N, M = 64, 96
    dosage = rng.binomial(2, 0.4, size=(N, M)).astype(float)
    Y = rng.normal(size=N)
    kw = dict(x_dtype="2bit")
    if case == "row_plan":
        # row layout with J > 1: ported, the step equals JAX's on that plan
        # (M=96's own J=1 plan runs the serial sweep)
        kw.update(jacobi_blocks=2, jacobi_layout="row")
    elif case == "scan":
        kw = dict(backend="scan")
    elif case == "dense_kernel":
        # dense X runs the kernels, a row-layout plan with J > 1 too
        kw = dict(backend="pallas", jacobi_blocks=2, jacobi_layout="row")
    if case in ("row_plan", "dense_kernel"):
        # (imported here: that module imports this one's replay variates)
        from tests.test_torch_row_samplers import assert_row_step_matches_jax

        assert_row_step_matches_jax("horseshoe", dosage, Y, **kw)
    elif case == "int8":
        # int8 codes: ported, a replayed step equals JAX's (the J=1 plan of
        # M=96: the serial int8 fold sweep)
        from tests.test_torch_int8_samplers import \
            assert_int8_step_matches_jax

        assert_int8_step_matches_jax("horseshoe", dosage, Y)
    else:
        # the scan (Queue 1 item 8): ported, with JAX's option checks (its
        # replayed steps: tests/test_torch_scan.py)
        s = HorseshoeSampler(dosage, Y, HorseshoeConfig(), **kw,
                             device="cpu")
        assert (s.backend, s.permutation) == ("scan", "full")
        g = torch.Generator().manual_seed(0)
        assert bool(torch.isfinite(s.step(s.init(g), g).eps).all())
        for bad in (dict(x_dtype="2bit"), dict(permutation="full",
                                               backend="blocked")):
            with pytest.raises(ValueError, match="backend"):
                HorseshoeSampler(dosage, Y, HorseshoeConfig(),
                                 **{**kw, **bad}, device="cpu")
    if case == "dense_kernel":
        s = HorseshoeSampler(dosage, Y, HorseshoeConfig(), backend="pallas",
                             device="cpu")
        assert s.supports_fused_chains and (s.jacobi, s.backend) == (
            1, "pallas")
    if case == "int8":
        # dense X on the CPU defaults to the plain sweep, which has no fused
        # multi-chain kernel: fused=True raises, the default runs the
        # chains through the single-chain step
        s = HorseshoeSampler(dosage, Y, HorseshoeConfig(block_size=32),
                             device="cpu")
        assert s.backend == "blocked" and not s.supports_fused_chains
        with pytest.raises(ValueError, match="fused"):
            s.run_chains(torch.Generator().manual_seed(0), 4,
                         ChainConfig(10, 5), fused=True)
        _, out = s.run_chains(torch.Generator().manual_seed(0), 2,
                              ChainConfig(4, 2, 2))
        assert out["beta"].shape == (1, 2, M) and np.isfinite(
            out["beta"]).all()
