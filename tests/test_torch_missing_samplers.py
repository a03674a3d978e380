"""Both samplers on genotypes with missing calls against the JAX package,
on the CPU: 3 replayed steps (the port draws through a variates object
that replays the JAX sampler's own draws, as tests/test_torch_bayesr.py)
at J > 1 in the "t" layout (the strided kernels' ``miss`` mode), at J=1
(the serial in-kernel decode), and fused at J > 1; and ``run_chains`` at
J=1, which has no fused kernel for missing calls and so steps each chain
alone, as JAX's vmapped fallback (``fused=True`` raises).

Data: dosages with ~3 % missing calls made with numpy from a seed, N=1500
(pad lanes exist), M=256 in blocks of B=16.  The port's data is the JAX
sampler's carried across by ``convert`` (words, statistics and
``has_missing``).  Tolerances as tests/test_torch_bayesr.py's: labels
exact, beta rtol 2e-4 / atol 2e-6, the hyperparameters rtol 2e-4.  The
first steps from init move most markers far, so eps is held as
tests/test_torch_serial.py holds it: 2e-4 |eps| + 2e-5 + 1e-5 L1, L1 per
lane the sum of the magnitudes of what the step adds to it (|d_m s_m
x_mn|, missing calls 0), since the packages add those terms in different
orders in f32 (reading, the fused BayesR case: 3 of 6,144 lanes 2.6e-5
apart, beyond 2e-4 |eps| + 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu_torch import (BayesRConfig, ChainConfig, HorseshoeConfig,
                                  HorseshoeSampler, SpikeSlabSampler)
from bayesrrcpp_tpu_torch.convert import (data_from_jax,
                                          horseshoe_data_from_jax,
                                          unpermute_eps)
from bayesrrcpp_tpu_torch.ops import genotypes
from tests.test_torch_horseshoe import JaxHorseshoeReplayVariates
from tests.test_torch_multichain import (JaxBayesRReplayVariates,
                                         JaxChainReplay)

CVA = np.array([0.001, 0.01, 0.1])
N, M, B = 1500, 256, 16
PLANS = {"t": dict(jacobi_blocks=4, jacobi_layout="t"),
         "serial": dict(jacobi_blocks=1)}


def _samplers(kind, seed, plan):
    rng = np.random.default_rng(seed)
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(
        float)
    beta_t = np.where(rng.random(M) < 0.1, rng.normal(0, 0.3, M), 0.0)
    Y = ((dosage - dosage.mean(0)) / dosage.std(0, ddof=1) @ beta_t
         + rng.normal(0, 0.8, N))
    dosage[rng.random(dosage.shape) < 0.03] = np.nan
    kw = dict(x_dtype="2bit", **PLANS[plan])
    if kind == "bayesr":
        js = jbr.SpikeSlabSampler(dosage, Y, CVA,
                                  jbr.BayesRConfig(block_size=B),
                                  dtype=jnp.float32, **kw)
        ts = SpikeSlabSampler(dosage, Y, CVA, BayesRConfig(block_size=B),
                              device="cpu", **kw)
        carry, Replay = data_from_jax, JaxBayesRReplayVariates
    else:
        cfg = dict(A=1.0 / np.sqrt(N) * 20 / (M - 20), block_size=B)
        js = jbr.HorseshoeSampler(dosage, Y, jbr.HorseshoeConfig(**cfg),
                                  dtype=jnp.float32, **kw)
        ts = HorseshoeSampler(dosage, Y, HorseshoeConfig(**cfg),
                              device="cpu", **kw)
        carry, Replay = horseshoe_data_from_jax, JaxHorseshoeReplayVariates
    assert js._x_miss and ts.data.has_missing
    assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad, ts.Npad) == \
        (js.jacobi, js.B, js.jacobi_layout, js.Mpad, js.Npad)
    ts.data = carry({k: np.array(v) for k, v in js.data._asdict().items()},
                    N=N, device="cpu")
    assert ts.data.has_missing
    return js, ts, Replay


def _update_l1(ts, beta0, beta1):
    """Per eps lane, the sum of |d_m s_m x_mn| over the markers m, with
    d = beta1 - beta0 and x standardized (0 for a missing call); float64,
    the shape of eps."""
    d = ts.data
    x = genotypes.decode_rows(d.XT, d.x_mean, d.x_scale, d.row_valid)
    return (beta1 - beta0).double().abs() @ x.double().abs()


def _assert_close(jst, tst, ts, l1):
    j = {k: np.asarray(v) for k, v in jst._asdict().items()}
    if "labels" in j:
        np.testing.assert_array_equal(j["labels"], tst.labels.numpy())
    np.testing.assert_allclose(j["beta"], tst.beta.numpy(), rtol=2e-4,
                               atol=2e-6)
    for field in ("mu", "sigmaE", "sigmaGG", "pi", "lam", "v", "tau", "eta",
                  "c2"):
        if field in j:
            np.testing.assert_allclose(j[field], getattr(tst, field).numpy(),
                                       rtol=2e-4, err_msg=field)
    e_jax = unpermute_eps(j["eps"], ts.Npad)
    e_port = tst.eps.numpy()
    assert np.all(np.abs(e_jax - e_port) <= 2e-4 * np.abs(e_port) + 2e-5
                  + 1e-5 * l1.numpy())
    assert (e_port[..., N:] == 0).all()
    assert np.all(j["iteration"] == tst.iteration)


@pytest.mark.parametrize("plan", ["t", "serial"])
@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_steps_on_missing_data_match_jax(kind, plan):
    js, ts, Replay = _samplers(kind, 7, plan)
    assert ts._sweep_kw()["fold_affine"] is False
    assert ts._sweep_kw().get("missing", False) is (plan == "t")
    key = jax.random.PRNGKey(4)
    rv = Replay(key)
    jst, tst = js.init(key), ts.init(rv)
    for _ in range(3):
        beta0 = tst.beta
        jst = js.step(jst)
        tst = ts.step(tst, rv)
        _assert_close(jst, tst, ts, _update_l1(ts, beta0, tst.beta))
    ex = ts.refresh_eps(tst)
    rel = torch.linalg.norm(tst.eps - ex.eps) / torch.linalg.norm(ex.eps)
    assert float(rel) < 1e-5


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_fused_steps_on_missing_data_match_jax(kind):
    """J > 1: the fused kernels' miss mode, 3 chains, the shared visit
    order chain 0's (JAX's ``korder[0]``)."""
    C = 3
    js, ts, Replay = _samplers(kind, 8, "t")
    assert ts.supports_fused_chains and js.supports_fused_chains
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    rv = JaxChainReplay([Replay(k) for k in keys])
    jst, tst = jax.vmap(js.init)(keys), ts.init(rv, chains=C)
    for _ in range(3):
        beta0 = tst.beta
        jst = js.step_chains(jst)
        tst = ts.step_chains(tst, rv)
        _assert_close(jst, tst, ts, _update_l1(ts, beta0, tst.beta))
    assert not torch.equal(tst.beta[0], tst.beta[1])


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_run_chains_on_missing_data_at_j1_steps_each_chain(kind):
    """J=1 with missing calls: no fused kernel (JAX's has no in-kernel
    decode either), so ``run_chains`` steps each chain with its own
    variates and orders, as JAX's vmapped fallback (two steps against
    ``jax.vmap(_step_impl)``); ``fused=True`` raises."""
    C = 2
    js, ts, Replay = _samplers(kind, 9, "serial")
    assert not ts.supports_fused_chains and not js.supports_fused_chains
    with pytest.raises(ValueError, match="fused"):
        ts.run_chains(torch.Generator().manual_seed(0), C, ChainConfig(2, 1),
                      fused=True)
    with pytest.raises(ValueError, match="fused"):
        ts.step_chains(ts.init(torch.Generator(), chains=C),
                       torch.Generator())
    keys = jax.random.split(jax.random.PRNGKey(6), C)
    rv = JaxChainReplay([Replay(k) for k in keys])
    jst, tst = jax.vmap(js.init)(keys), ts.init(rv, chains=C)
    vstep = jax.vmap(js._step_impl, in_axes=(0, None))
    for _ in range(2):
        beta0 = tst.beta
        jst = vstep(jst, js.data)
        tst = ts._step_unfused(tst, rv)
        _assert_close(jst, tst, ts, _update_l1(ts, beta0, tst.beta))
    st, out = ts.run_chains(torch.Generator().manual_seed(1), C,
                            ChainConfig(3, 1, 1))
    assert out["beta"].shape == (2, C, M)
    assert np.isfinite(out["sigmaE"]).all()
    assert not np.array_equal(out["beta"][:, 0], out["beta"][:, 1])


@pytest.mark.parametrize("auto", [True, False])
def test_row_plans_on_missing_data_follow_jax(auto):
    """A row-layout plan with J > 1: with missing calls the auto plan falls
    back to J=1 (the in-kernel decode) and an explicit one is refused, as
    in the JAX samplers (bayesr.py:290-300)."""
    rng = np.random.default_rng(10)
    Mr = 4096
    dosage = rng.binomial(2, 0.3, size=(N, Mr)).astype(float)
    dosage[rng.random(dosage.shape) < 0.01] = np.nan
    Y = rng.normal(size=N)
    kw = dict(x_dtype="2bit", jacobi_layout="row")
    if auto:
        js = jbr.SpikeSlabSampler(dosage, Y, CVA, jbr.BayesRConfig(), **kw)
        ts = SpikeSlabSampler(dosage, Y, CVA, BayesRConfig(), device="cpu",
                              **kw)
        assert (ts.jacobi, ts.jacobi_layout, ts.B, ts.Mpad) == \
            (js.jacobi, js.jacobi_layout, js.B, js.Mpad)
        assert ts.jacobi == 1 and ts._sweep_kw()["fold_affine"] is False
    else:
        for make, cfg, extra in (
                (jbr.SpikeSlabSampler, jbr.BayesRConfig(), {}),
                (SpikeSlabSampler, BayesRConfig(), {"device": "cpu"})):
            with pytest.raises(ValueError, match="packed-missing"):
                make(dosage, Y, CVA, cfg, jacobi_blocks=4, **kw, **extra)
