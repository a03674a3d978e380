"""Both samplers on int8 genotype codes (``x_dtype="int8"``) against the JAX
package, on the CPU.

- Three replayed steps of ``SpikeSlabSampler`` and ``HorseshoeSampler``
  (the port draws through a variates object that replays the JAX
  sampler's own draws, tests/test_torch_bayesr.py) in each routing case:
  the strided plan (J=4, "t": sites #1/#2), J=1 (the serial sweep, #9/#10),
  a row plan (J=4, "row": #15/#16), codes with missing calls (the auto
  plan falls back to J=1, the serial in-kernel decode ``_q``), fused
  ``step_chains`` of 3 chains on the strided plan and at J=1 (#3/#4,
  #11/#12), and ``run_chains`` on codes with missing calls, unfused (each
  chain through the single-chain step; ``fused=True`` raises).  The JAX
  samplers run their Pallas kernels in interpret mode; the port's data is
  the JAX sampler's carried across by ``convert``.
- An int8 chain against the dense chain on the same standardized matrix,
  through the port alone (the counterpart of tests/test_pallas.py:225).
- The JAX package's int8 refusals, which the port keeps.

Data: dosages made with numpy from a seed, N=1500, M=256 in blocks of
B=16 (tests/test_torch_missing_samplers.py's recipe), 3 % missing calls
where asked.  Tolerances as tests/test_torch_missing_samplers.py's for
the 2-bit modes: labels exact, beta rtol 2e-4 / atol 2e-6, the
hyperparameters rtol 2e-4 (mu also atol 1e-6, as
tests/test_torch_sharded.py: it may sit near 0), eps 2e-4 |eps| + 2e-5 + 1e-5 L1 per lane (L1
the sum of the magnitudes of what the step adds to the lane: the first
steps from init move most markers far, and the packages add those terms
in different orders in f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu_torch import (BayesRConfig, ChainConfig, HorseshoeConfig,
                                  HorseshoeSampler, SpikeSlabSampler,
                                  TorchVariates)
from bayesrrcpp_tpu_torch.convert import (data_from_jax,
                                          horseshoe_data_from_jax)
from bayesrrcpp_tpu_torch.ops import genotypes
from tests.test_torch_dense_samplers import ChainReplay
from tests.test_torch_horseshoe import JaxHorseshoeReplayVariates
from tests.test_torch_multichain import JaxBayesRReplayVariates

CVA = np.array([0.001, 0.01, 0.1])
N, M, B, C = 1500, 256, 16, 3
PLANS = {"t": dict(jacobi_blocks=4, jacobi_layout="t"),
         "serial": dict(jacobi_blocks=1),
         "row": dict(jacobi_blocks=4, jacobi_layout="row"),
         "missing": {}}


def _dosage(seed, missing):
    rng = np.random.default_rng(seed)
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(
        float)
    beta_t = np.where(rng.random(M) < 0.1, rng.normal(0, 0.3, M), 0.0)
    X = (dosage - dosage.mean(0)) / dosage.std(0, ddof=1)
    Y = X @ beta_t + rng.normal(0, 0.8, N)
    if missing:
        dosage[rng.random(dosage.shape) < 0.03] = np.nan
    return dosage, X, Y


def _samplers(kind, seed, plan):
    dosage, _, Y = _dosage(seed, plan == "missing")
    kw = dict(x_dtype="int8", **PLANS[plan])
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
    assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad, ts.Npad) == \
        (js.jacobi, js.B, js.jacobi_layout, js.Mpad, js.Npad)
    assert ts.Npad == N and ts.data.XT.dtype == torch.int8
    assert ts.data.has_missing == (plan == "missing")
    ts.data = carry({k: np.array(v) for k, v in js.data._asdict().items()},
                    N=N, device="cpu")
    assert ts.data.has_missing == (plan == "missing")
    return js, ts, Replay


def _update_l1(ts, beta0, beta1):
    """Per eps lane, the sum of |d_m s_m x_mn| over the markers m, with d =
    beta1 - beta0 and x standardized (0 for a missing call); float64."""
    d = ts.data
    x = genotypes.decode_rows(d.XT, d.x_mean, d.x_scale)
    return (beta1 - beta0).double().abs() @ x.double().abs()


def _assert_close(jst, tst, l1):
    j = {k: np.asarray(v) for k, v in jst._asdict().items()}
    if "labels" in j:
        np.testing.assert_array_equal(j["labels"], tst.labels.numpy())
    np.testing.assert_allclose(j["beta"], tst.beta.numpy(), rtol=2e-4,
                               atol=2e-6)
    for field in ("mu", "sigmaE", "sigmaGG", "pi", "lam", "v", "tau", "eta",
                  "c2"):
        if field in j:
            # mu may sit near 0: atol 1e-6 as tests/test_torch_sharded.py
            np.testing.assert_allclose(j[field], getattr(tst, field).numpy(),
                                       rtol=2e-4,
                                       atol=1e-6 if field == "mu" else 0,
                                       err_msg=field)
    e_port = tst.eps.numpy()
    assert np.all(np.abs(j["eps"] - e_port) <= 2e-4 * np.abs(e_port) + 2e-5
                  + 1e-5 * l1.numpy())
    assert np.all(j["iteration"] == tst.iteration)


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_int8_steps_match_jax(kind, plan):
    js, ts, Replay = _samplers(kind, 7, plan)
    kw = ts._sweep_kw()
    assert kw["fold_affine"] is (plan != "missing")
    assert "row_valid" not in kw and "missing" not in kw
    assert ts.strided == (plan == "t")
    if plan == "missing":
        assert ts.jacobi == 1 and not ts.supports_fused_chains
    key = jax.random.PRNGKey(4)
    rv = Replay(key)
    jst, tst = js.init(key), ts.init(rv)
    for _ in range(3):
        beta0 = tst.beta
        jst = js.step(jst)
        tst = ts.step(tst, rv)
        _assert_close(jst, tst, _update_l1(ts, beta0, tst.beta))
    ex = ts.refresh_eps(tst)
    rel = torch.linalg.norm(tst.eps - ex.eps) / torch.linalg.norm(ex.eps)
    assert float(rel) < 1e-5


@pytest.mark.parametrize("plan", ["t", "serial"])
@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_int8_fused_steps_match_jax(kind, plan):
    """3 fused chains (the shared visit order chain 0's, as JAX's
    ``korder[0]``)."""
    js, ts, Replay = _samplers(kind, 8, plan)
    assert ts.supports_fused_chains and js.supports_fused_chains
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    rv = ChainReplay([Replay(k) for k in keys])
    jst, tst = jax.vmap(js.init)(keys), ts.init(rv, chains=C)
    for _ in range(3):
        beta0 = tst.beta
        jst = js.step_chains(jst)
        tst = ts.step_chains(tst, rv)
        _assert_close(jst, tst, _update_l1(ts, beta0, tst.beta))
    assert not torch.equal(tst.beta[0], tst.beta[1])


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_int8_run_chains_with_missing_calls_steps_each_chain(kind):
    """Codes with missing calls: no fused kernel (JAX has no fused in-kernel
    decode either), so ``run_chains`` steps each chain with its own
    variates and orders, as JAX's vmapped fallback (two steps against
    ``jax.vmap(_step_impl)``); ``fused=True`` raises."""
    js, ts, Replay = _samplers(kind, 9, "missing")
    assert not ts.supports_fused_chains and not js.supports_fused_chains
    with pytest.raises(ValueError, match="fused"):
        ts.run_chains(torch.Generator().manual_seed(0), 2, ChainConfig(2, 1),
                      fused=True)
    keys = jax.random.split(jax.random.PRNGKey(6), 2)
    from tests.test_torch_multichain import JaxChainReplay

    rv = JaxChainReplay([Replay(k) for k in keys])
    jst, tst = jax.vmap(js.init)(keys), ts.init(rv, chains=2)
    vstep = jax.vmap(js._step_impl, in_axes=(0, None))
    for _ in range(2):
        beta0 = tst.beta
        jst = vstep(jst, js.data)
        tst = ts._step_unfused(tst, rv)
        _assert_close(jst, tst, _update_l1(ts, beta0, tst.beta))
    st, out = ts.run_chains(torch.Generator().manual_seed(1), 2,
                            ChainConfig(3, 1, 1))
    assert out["beta"].shape == (2, 2, M)
    assert np.isfinite(out["sigmaE"]).all()


@pytest.mark.parametrize("plan", ["t", "serial"])
def test_int8_chain_equals_dense_chain(plan):
    """The int8 fold sweep and the dense sweep on the same standardized
    matrix, through the port alone, from the same variates (the twin of
    tests/test_pallas.py:225): labels equal, beta to rtol 3e-4 / atol
    3e-6, sigmaE to rtol 2e-4, eps to rtol 3e-4 / atol 3e-5 (fold vs
    decoded dots: f32 reassociation)."""
    dosage, X, Y = _dosage(41, False)
    cfg = BayesRConfig(block_size=B)
    s_d = SpikeSlabSampler(X, Y, CVA, cfg, backend="pallas", device="cpu",
                           **PLANS[plan])
    s_q = SpikeSlabSampler(dosage, Y, CVA, cfg, x_dtype="int8", device="cpu",
                           **PLANS[plan])
    assert (s_d.jacobi, s_d.B, s_d.Mpad, s_d.Npad) == \
        (s_q.jacobi, s_q.B, s_q.Mpad, s_q.Npad)
    v_d = TorchVariates(torch.Generator().manual_seed(42))
    v_q = TorchVariates(torch.Generator().manual_seed(42))
    st_d, st_q = s_d.init(v_d), s_q.init(v_q)
    for _ in range(3):
        st_d, st_q = s_d.step(st_d, v_d), s_q.step(st_q, v_q)
    assert torch.equal(st_d.labels, st_q.labels)
    torch.testing.assert_close(st_d.beta, st_q.beta, rtol=3e-4, atol=3e-6)
    torch.testing.assert_close(st_d.sigmaE, st_q.sigmaE, rtol=2e-4, atol=0)
    torch.testing.assert_close(st_d.eps, st_q.eps, rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("case", ["backend", "values", "explicit_j",
                                  "auto_t"])
def test_int8_refusals_follow_jax(case):
    """What the JAX samplers refuse on int8 codes, the port refuses: a
    backend other than the kernels (bayesr.py:129, horseshoe.py:76), values
    outside {0, 1, 2, NaN} (genotypes.py:421-424), an explicit J > 1 on
    codes with missing calls (bayesr.py:290-300); and both fall back to
    J=1 from the auto "t" plan there (int8 has no strided missing-call
    mode)."""
    rng = np.random.default_rng(12)
    Mr = 4096
    dosage = rng.binomial(2, 0.3, size=(64, Mr)).astype(float)
    Y = rng.normal(size=64)
    if case == "backend":
        for make, cfg in ((jbr.SpikeSlabSampler, jbr.BayesRConfig()),
                          (SpikeSlabSampler, BayesRConfig())):
            with pytest.raises(ValueError, match="pallas"):
                make(dosage, Y, CVA, cfg, x_dtype="int8", backend="blocked")
        with pytest.raises(ValueError, match="pallas"):
            HorseshoeSampler(dosage, Y, HorseshoeConfig(), x_dtype="int8",
                             backend="blocked", device="cpu")
        return
    if case == "values":
        bad = dosage.copy()
        bad[0, 0] = 1.5
        for make, cfg, extra in (
                (jbr.SpikeSlabSampler, jbr.BayesRConfig(), {}),
                (SpikeSlabSampler, BayesRConfig(), {"device": "cpu"})):
            with pytest.raises(ValueError, match="int8"):
                make(bad, Y, CVA, cfg, x_dtype="int8", **extra)
        return
    dosage[rng.random(dosage.shape) < 0.01] = np.nan
    kw = dict(x_dtype="int8", jacobi_layout="t")
    if case == "explicit_j":
        for make, cfg, extra in (
                (jbr.SpikeSlabSampler, jbr.BayesRConfig(), {}),
                (SpikeSlabSampler, BayesRConfig(), {"device": "cpu"})):
            with pytest.raises(ValueError, match="missing-free quantized"):
                make(dosage, Y, CVA, cfg, jacobi_blocks=4, **kw, **extra)
        return
    js = jbr.SpikeSlabSampler(dosage, Y, CVA, jbr.BayesRConfig(), **kw)
    ts = SpikeSlabSampler(dosage, Y, CVA, BayesRConfig(), device="cpu", **kw)
    assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad) == \
        (js.jacobi, js.B, js.jacobi_layout, js.Mpad)
    assert ts.jacobi == 1 and not ts.strided
    assert ts._sweep_kw()["fold_affine"] is False


def assert_int8_step_matches_jax(kind, dosage, Y, cva=CVA, **kw):
    """One replayed step of the port's sampler on ``dosage`` as int8 codes
    equals JAX's (this module's tolerances), the port's data carried
    across from JAX's; ``kw`` the samplers' plan keywords."""
    if kind == "bayesr":
        js = jbr.SpikeSlabSampler(dosage, Y, cva, jbr.BayesRConfig(),
                                  x_dtype="int8", dtype=jnp.float32, **kw)
        ts = SpikeSlabSampler(dosage, Y, cva, BayesRConfig(), x_dtype="int8",
                              device="cpu", **kw)
        carry, Replay = data_from_jax, JaxBayesRReplayVariates
    else:
        js = jbr.HorseshoeSampler(dosage, Y, jbr.HorseshoeConfig(),
                                  x_dtype="int8", dtype=jnp.float32, **kw)
        ts = HorseshoeSampler(dosage, Y, HorseshoeConfig(), x_dtype="int8",
                              device="cpu", **kw)
        carry, Replay = horseshoe_data_from_jax, JaxHorseshoeReplayVariates
    assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad, ts.Npad) == \
        (js.jacobi, js.B, js.jacobi_layout, js.Mpad, js.Npad)
    ts.data = carry({k: np.array(v) for k, v in js.data._asdict().items()},
                    N=len(Y), device="cpu")
    key = jax.random.PRNGKey(3)
    rv = Replay(key)
    jst, tst = js.init(key), ts.init(rv)
    beta0 = tst.beta
    jst, tst = js.step(jst), ts.step(tst, rv)
    _assert_close(jst, tst, _update_l1(ts, beta0, tst.beta))
