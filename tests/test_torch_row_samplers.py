"""Both samplers on row-layout plans with J > 1 (``jacobi_layout="row"``,
an explicit ``jacobi_blocks`` under the default layout, or the auto plan
at M=1500 with ``block_size=64``) against the JAX package, on the CPU.

- The plans: (J, B, layout, Mpad, Npad) equal to the JAX samplers'.
- Three replayed steps of ``SpikeSlabSampler`` and ``HorseshoeSampler``
  (the port draws through a variates object that replays the JAX
  sampler's own draws, tests/test_torch_bayesr.py), one chain (``step``:
  the row-layout sweep, ``ops/jacobi.py``) and 3 fused chains
  (``step_chains``: the serial fused sweep with chain 0's block order, as
  JAX's ``_mc_step_impl`` on a row plan), on dense X at
  ``jacobi_blocks=4`` (N=150, M=96, B=16: Mpad=128, nr=2) and on 2-bit
  words at the auto plan (2, 64, "row") of M=1500.  The JAX samplers run
  their Pallas kernels in interpret mode; the port's data is JAX's,
  carried across by ``convert``.  Tolerances: labels exact; on dense X
  eps, beta and the hyperparameters to rtol 2e-5 / atol 2e-6 (those of
  tests/test_torch_dense_samplers.py); on words beta and the
  hyperparameters to rtol 2e-4, the horseshoe's lambda and v to 4e-4, eps
  to 2e-4 |eps| + 2e-5 plus 1e-5 of what the sweep added to each lane
  (tests/test_torch_serial.py's tolerances and their reasons).
- ``convert`` carries JAX packed data at a row plan with B=128 (the Gram
  blocks, words and statistics equal the port's own layout; one step of
  each agrees).
- Recovery through the row sweep: tests/test_jacobi.py:108-125 and
  :179-198 on the port (N=400, M=160, B=16, J=5), corr > 0.8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu_torch import (BayesRConfig, ChainConfig, HorseshoeConfig,
                                  HorseshoeSampler, SpikeSlabSampler,
                                  simulate)
from bayesrrcpp_tpu_torch.convert import (data_from_jax,
                                          horseshoe_data_from_jax,
                                          unpermute_eps)
from bayesrrcpp_tpu_torch.models import bayesr as tbayesr
from bayesrrcpp_tpu_torch.models import horseshoe as thorseshoe
from tests.test_torch_dense_samplers import ChainReplay
from tests.test_torch_horseshoe import JaxHorseshoeReplayVariates
from tests.test_torch_multichain import JaxBayesRReplayVariates
from tests.test_torch_serial import _update_l1

CVA = np.array([0.001, 0.01, 0.1])
# (N, M, block_size, plan keywords, packed) of each data set
DATA = {"dense": (150, 96, 16, dict(backend="pallas", jacobi_blocks=4),
                  False),
        "packed_auto": (300, 1500, 64, {}, True)}


def _xy(seed, N, M):
    rng = np.random.default_rng(seed)
    dosage = rng.binomial(2, rng.uniform(0.2, 0.8, M), size=(N, M)).astype(
        float)
    X = (dosage - dosage.mean(axis=0)) / dosage.std(axis=0, ddof=1)
    beta_t = np.zeros(M)
    beta_t[rng.choice(M, 8, replace=False)] = rng.normal(0, 0.3, 8)
    return dosage, X, X @ beta_t + rng.normal(0, 0.7, N)


def _samplers(kind, data, seed):
    """The JAX and port samplers on the same X and plan, the port's data
    carried across from JAX's."""
    N, M, bs, kw, packed = DATA[data]
    dosage, X, Y = _xy(seed, N, M)
    Xs = dosage if packed else X
    if packed:
        kw = dict(kw, x_dtype="2bit")
    if kind == "bayesr":
        js = jbr.SpikeSlabSampler(Xs, Y, CVA, jbr.BayesRConfig(block_size=bs),
                                  dtype=jnp.float32, **kw)
        ts = SpikeSlabSampler(Xs, Y, CVA, BayesRConfig(block_size=bs),
                              device="cpu", **kw)
        carry, Replay = data_from_jax, JaxBayesRReplayVariates
    else:
        cfg = dict(block_size=bs, A=1.0 / np.sqrt(N) * 8 / (M - 8))
        js = jbr.HorseshoeSampler(Xs, Y, jbr.HorseshoeConfig(**cfg),
                                  dtype=jnp.float32, **kw)
        ts = HorseshoeSampler(Xs, Y, HorseshoeConfig(**cfg), device="cpu",
                              **kw)
        carry, Replay = horseshoe_data_from_jax, JaxHorseshoeReplayVariates
    plan = (js.jacobi, js.B, js.jacobi_layout, js.Mpad, js.Npad)
    assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad, ts.Npad) == plan
    assert ts.jacobi > 1 and ts.jacobi_layout == "row"
    assert ts.backend == "pallas" and ts.x_packed == packed
    assert ts.supports_fused_chains and js.supports_fused_chains
    ts.data = carry({k: np.array(v) for k, v in js.data._asdict().items()},
                    N=N, device="cpu")
    return js, ts, Replay


@pytest.mark.parametrize("block,M,plan", [
    (16, 96, dict(jacobi_blocks=4)),                       # default layout
    (16, 96, dict(jacobi_blocks=3, jacobi_layout="row")),
    (512, 4096, dict(jacobi_layout="row")),                # auto_jacobi
    (64, 1500, {}),                                        # the auto plan
    (32, 600, {})])
def test_row_plans_match_jax(block, M, plan):
    rng = np.random.default_rng(M)
    dosage = rng.binomial(2, 0.3, size=(64, M)).astype(float)
    Y = rng.standard_normal(64)
    for x_dtype in ("2bit", "dense"):
        kw = dict(plan, x_dtype=x_dtype)
        if x_dtype == "dense":
            kw["backend"] = "pallas"
        js = jbr.SpikeSlabSampler(dosage, Y, CVA,
                                  jbr.BayesRConfig(block_size=block),
                                  dtype=jnp.float32, **kw)
        ts = SpikeSlabSampler(dosage, Y, CVA, BayesRConfig(block_size=block),
                              device="cpu", **kw)
        jplan = (js.jacobi, js.B, js.jacobi_layout, js.Mpad, js.Npad)
        assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad, ts.Npad) == jplan
        assert jplan[0] > 1 and jplan[2] == "row"
        hs = HorseshoeSampler(dosage, Y, HorseshoeConfig(block_size=block),
                              device="cpu", **kw)
        assert (hs.jacobi, hs.B, hs.jacobi_layout, hs.Mpad) == jplan[:4]


def _assert_step_close(packed, j, tst, l1):
    if "labels" in j:
        np.testing.assert_array_equal(j["labels"], tst.labels.numpy())
    rtol, atol = (2e-4, 2e-6) if packed else (2e-5, 2e-6)
    np.testing.assert_allclose(j["beta"], tst.beta.numpy(), rtol=rtol,
                               atol=atol)
    for field in ("mu", "sigmaE", "sigmaGG", "pi", "lam", "v", "tau", "eta",
                  "c2"):
        if field in j:
            widen = 2 if packed and field in ("lam", "v") else 1
            np.testing.assert_allclose(j[field], getattr(tst, field).numpy(),
                                       rtol=rtol * widen, atol=atol,
                                       err_msg=field)
    e_port = tst.eps.numpy()
    if packed:
        e_jax = unpermute_eps(j["eps"], e_port.shape[-1])
        assert np.all(np.abs(e_jax - e_port) <= 2e-4 * np.abs(e_port) + 2e-5
                      + 1e-5 * l1)
    else:
        np.testing.assert_allclose(j["eps"], e_port, rtol=rtol, atol=atol)


def assert_row_step_matches_jax(kind, X, Y, cva=CVA, cfg=None, **kw):
    """One replayed step of the port's sampler on a row plan with J > 1
    equals JAX's (tolerances as ``test_row_steps_match_jax``): both built on
    X and Y with the keywords ``kw`` and config keywords ``cfg``, the
    port's data carried across from JAX's."""
    cfg = cfg or {}
    kw = {k: v for k, v in kw.items() if k != "device"}
    packed = kw.get("x_dtype") == "2bit"
    if kind == "bayesr":
        js = jbr.SpikeSlabSampler(X, Y, cva, jbr.BayesRConfig(**cfg),
                                  dtype=jnp.float32, **kw)
        ts = SpikeSlabSampler(X, Y, cva, BayesRConfig(**cfg), device="cpu",
                              **kw)
        carry, Replay = data_from_jax, JaxBayesRReplayVariates
    else:
        js = jbr.HorseshoeSampler(X, Y, jbr.HorseshoeConfig(**cfg),
                                  dtype=jnp.float32, **kw)
        ts = HorseshoeSampler(X, Y, HorseshoeConfig(**cfg), device="cpu",
                              **kw)
        carry, Replay = horseshoe_data_from_jax, JaxHorseshoeReplayVariates
    plan = (js.jacobi, js.B, js.jacobi_layout, js.Mpad, js.Npad)
    assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad, ts.Npad) == plan
    assert ts.jacobi > 1 and ts.jacobi_layout == "row"
    ts.data = carry({k: np.array(v) for k, v in js.data._asdict().items()},
                    N=len(Y), device="cpu")
    key = jax.random.PRNGKey(3)
    rv = Replay(key)
    jst, tst = js.init(key), ts.init(rv)
    beta0 = tst.beta
    jst, tst = js.step(jst), ts.step(tst, rv)
    l1 = _update_l1(ts, beta0, tst.beta).numpy() if packed else None
    _assert_step_close(packed, {k: np.asarray(v) for k, v in
                                jst._asdict().items()}, tst, l1)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("data", ["dense", "packed_auto"])
@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_row_steps_match_jax(kind, data, fused, monkeypatch):
    js, ts, Replay = _samplers(kind, data, 7)
    packed = DATA[data][4]
    model = tbayesr if kind == "bayesr" else thorseshoe
    # one chain sweeps with the row-layout kernel, fused chains with the
    # serial fused one (JAX's _mc_step_impl on a row plan)
    name = f"{kind}_sweep_mc" if fused else f"{kind}_jacobi"
    sweep = getattr(model, name)
    calls = []

    def recorded(*a, **kw):
        calls.append(kw.get("J"))
        return sweep(*a, **kw)

    monkeypatch.setattr(model, name, recorded)
    if fused:
        keys = jax.random.split(jax.random.PRNGKey(5), 3)
        rv = ChainReplay([Replay(k) for k in keys])
        jst, tst = jax.vmap(js.init)(keys), ts.init(rv, chains=3)
        jstep, tstep = js.step_chains, ts.step_chains
    else:
        key = jax.random.PRNGKey(4)
        rv = Replay(key)
        jst, tst = js.init(key), ts.init(rv)
        jstep, tstep = js.step, ts.step
    for _ in range(3):
        beta0 = tst.beta
        jst = jstep(jst)
        tst = tstep(tst, rv)
        l1 = _update_l1(ts, beta0, tst.beta).numpy() if packed else None
        _assert_step_close(packed, {k: np.asarray(v) for k, v in
                                    jst._asdict().items()}, tst, l1)
    assert calls == [None if fused else ts.jacobi] * 3
    if fused:
        assert not torch.equal(tst.beta[0], tst.beta[1])
    ex = ts.refresh_eps(tst)
    rel = torch.linalg.norm(tst.eps - ex.eps, dim=-1) / torch.linalg.norm(
        ex.eps, dim=-1)
    assert float(rel.max()) < 1e-5


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_convert_carries_row_plan_data(kind):
    """JAX packed data at a row plan with B=128 (M=4096, block_size 128,
    ``jacobi_layout="row"``: J=4) equals the port's own layout of the same
    dosages, and one step of each agrees."""
    rng = np.random.default_rng(17)
    N, M = 500, 4096
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(
        float)
    Y = rng.standard_normal(N)
    kw = dict(x_dtype="2bit", jacobi_layout="row")
    if kind == "bayesr":
        js = jbr.SpikeSlabSampler(dosage, Y, CVA,
                                  jbr.BayesRConfig(block_size=128),
                                  dtype=jnp.float32, **kw)
        own = SpikeSlabSampler(dosage, Y, CVA, BayesRConfig(block_size=128),
                               device="cpu", **kw)
        carried = data_from_jax(
            {k: np.array(v) for k, v in js.data._asdict().items()}, N=N,
            device="cpu")
        Replay = JaxBayesRReplayVariates
    else:
        js = jbr.HorseshoeSampler(dosage, Y, jbr.HorseshoeConfig(
            block_size=128), dtype=jnp.float32, **kw)
        own = HorseshoeSampler(dosage, Y, HorseshoeConfig(block_size=128),
                               device="cpu", **kw)
        carried = horseshoe_data_from_jax(
            {k: np.array(v) for k, v in js.data._asdict().items()}, N=N,
            device="cpu")
        Replay = JaxHorseshoeReplayVariates
    assert (own.jacobi, own.B, own.jacobi_layout) == (js.jacobi, js.B,
                                                      js.jacobi_layout) \
        == (4, 128, "row")
    for name in ("XT", "valid", "row_valid"):
        assert torch.equal(getattr(carried, name), getattr(own.data, name))
    # the two sum N=500 products per Gram entry (and per xsq) in other
    # orders: f32 reassociation relative to entries up to N on the
    # diagonal, and ~5e-5 absolute on entries near 0
    for name in ("xsq", "gram", "x_mean", "x_scale", "x_colsum"):
        torch.testing.assert_close(getattr(carried, name),
                                   getattr(own.data, name), rtol=2e-5,
                                   atol=1e-4)
    key = jax.random.PRNGKey(9)
    r1, r2 = Replay(key), Replay(key)
    st_own = own.step(own.init(r1), r1)
    own.data = carried
    st_car = own.step(own.init(r2), r2)
    if kind == "bayesr":
        assert torch.equal(st_own.labels, st_car.labels)
    # the two data differ by f32 reassociation (the Gram to 6e-6 relative)
    # and the first step from init moves every marker: beta and eps held
    # to 2e-4 of their largest value (readings: 5e-5 and 4e-5)
    for name in ("beta", "eps"):
        a, b = getattr(st_own, name), getattr(st_car, name)
        torch.testing.assert_close(a, b, rtol=2e-4,
                                   atol=2e-4 * float(a.abs().max()))


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_row_sweep_recovers_signal(kind):
    """The J > 1 Markov kernel recovers the planted effects, the standard
    of tests/test_jacobi.py:108-125 (BayesR) and :179-198 (horseshoe) on
    the same recipe, swept by the port's row-layout plain version."""
    sim = simulate.simulate_bayesr(seed=77 if kind == "bayesr" else 79,
                                   N=400, M=160, n_causal=16, h2=0.5)
    kw = dict(backend="pallas", device="cpu", jacobi_blocks=5)
    if kind == "bayesr":
        s = SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=16),
                             **kw)
    else:
        A = (1.0 / np.sqrt(400)) * 16.0 / (160 - 16.0)
        s = HorseshoeSampler(sim.X, sim.Y, HorseshoeConfig(block_size=16,
                                                           A=A), **kw)
    assert (s.jacobi, s.B, s.jacobi_layout) == (5, 16, "row")
    _, out = s.run(torch.Generator().manual_seed(7), ChainConfig(150, 75, 5))
    corr = np.corrcoef(sim.beta_true, out["beta"].mean(axis=0))[0, 1]
    assert corr > 0.8, corr
    assert np.isfinite(out["sigmaE"]).all()
