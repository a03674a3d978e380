"""The grouped BayesR sampler with fixed effects (``variant="groups"``,
SURVEY C2) of bayesrrcpp_tpu_torch/models/bayesr.py against the JAX
package, on the CPU.

- Variate-injected steps: the port draws through a replay of the JAX
  sampler's own draws from its PRNG key (tests/test_torch_bayesr.py's
  ``JaxReplayVariates``, with the fixed effects' visit order and normals,
  sigmaF's gamma and init's uniform sigmaF), and three steps from JAX's init
  must agree with JAX ``SpikeSlabSampler(..., GroupsConfig(...),
  g_assign=..., fixed=...)`` with its Pallas kernels in interpret mode, on
  every path the plan picks: the strided sweep (``jacobi_blocks=8,
  jacobi_layout="t"``) on 2-bit words without and with missing calls
  (the ``miss`` mode), int8 codes and dense rows; the exact serial sweep
  at J=1 on words (fold, and the in-kernel decode of words with missing
  calls); the row-layout sweep (``jacobi_blocks=4``); the plain
  Gram-blocked sweep on dense rows; one chain (``step``) and, where the
  kernels fuse, C=2 fused chains (``step_chains``).  G in {2, 4} groups
  (``g_assign = m % G``), F in {0, 3} fixed effects; N=300, M=512 (JAX's
  kernels in interpret mode take most of this file's time), but N=1500
  for the strided ``miss`` mode (its r = s (C eps) - m s sum(eps) plus
  the missing calls' correction cancels terms larger than r: at N=300,
  M=1024 the two packages' beta part by up to 2.6e-5 after one step in
  the ungrouped variant too, beyond the tolerance below; N=1500 is
  tests/test_torch_missing_samplers.py's).
- Tolerances: labels exact; beta, alpha, mu, sigmaE, sigmaF, sigmaGG
  (each group's drawn from its ``bacc``) and pi to rtol 2e-4 / atol 2e-6
  (tests/test_torch_serial.py's, f32 reassociation); eps to 2e-4 |eps| +
  2e-5 plus 1e-5 of what the step added to each lane (the sweep's moved
  rows and the fixed effects' columns, ``update_l1``: the two packages
  sum those terms in different orders).
- The sweep's counts ``v`` and per-group ``bacc``, each held directly
  at every replayed step: one sweep visits every marker once, so v is the
  histogram of the new labels per group (exact, against JAX's labels) and
  bacc the per-group sum of beta^2 (rtol 1e-5 against the port's own
  beta, 4e-4 against JAX's).
- The prior pi of both variants and JAX's refusals.
- Statistical: the recovery of tests/test_bayesr.py:86
  (``test_groups_with_fixed_effects``: N=700, M=240, 2 groups, 3 fixed
  effects, cva x 10) at its bounds, corr > 0.75 and alpha within 0.15.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu_torch import (ChainConfig, GroupsConfig,
                                  SpikeSlabSampler, simulate)
from bayesrrcpp_tpu_torch.convert import (data_from_jax, state_from_jax,
                                          unpermute_eps)
from bayesrrcpp_tpu_torch.ops import genotypes
from tests.test_torch_multichain import (JaxBayesRReplayVariates,
                                         JaxChainReplay)
from tests.test_torch_serial import JaxSerialChainReplay

CVA = np.array([0.001, 0.01, 0.1])
N, M = 300, 512
# name: (storage, sampler keywords, G, F)
CASES = {
    "t-fold": ("2bit", dict(jacobi_blocks=8, jacobi_layout="t",
                            block_size=32), 4, 3),
    "t-miss": ("2bit-miss", dict(jacobi_blocks=8, jacobi_layout="t",
                                 block_size=32, n=1500), 2, 3),
    "t-int8": ("int8", dict(jacobi_blocks=8, jacobi_layout="t",
                            block_size=32), 4, 0),
    "t-dense": ("dense", dict(jacobi_blocks=8, jacobi_layout="t",
                              block_size=32, backend="pallas"), 2, 3),
    "serial-fold": ("2bit", dict(jacobi_blocks=1, block_size=64), 4, 3),
    "serial-q": ("2bit-miss", dict(jacobi_blocks=1, block_size=64), 2, 0),
    "row": ("2bit", dict(jacobi_blocks=4, block_size=64), 4, 3),
    "plain": ("dense", dict(backend="blocked", block_size=64), 4, 3),
}


def data(storage, G, F, seed=7, N=N, M=M):
    """(X, Y, g_assign, fixed, sampler keywords) of a case: dosages (NaN
    for a missing call) for words and int8 codes, standardized rows for
    dense X; a signal in every group and from the fixed effects."""
    rng = np.random.default_rng(seed)
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(
        float)
    X = (dosage - dosage.mean(0)) / dosage.std(0, ddof=1)
    beta_t = np.where(rng.random(M) < 0.05, rng.normal(0, 0.3, M), 0.0)
    fixed = rng.normal(size=(N, F))
    Y = X @ beta_t + fixed @ rng.normal(0, 0.5, F) + rng.normal(0, 0.8, N)
    if storage.endswith("miss"):
        dosage[rng.random(dosage.shape) < 0.02] = np.nan
    kw = {} if storage == "dense" else dict(
        x_dtype="int8" if storage == "int8" else "2bit")
    return (X if storage == "dense" else dosage), Y, np.arange(M) % G, \
        (fixed if F else None), kw


def samplers(name):
    storage, plan, G, F = CASES[name]
    kw = dict(plan)
    n = kw.pop("n", N)
    X, Y, g_assign, fixed, xkw = data(storage, G, F, N=n)
    kw.update(xkw)
    bs = kw.pop("block_size")
    cva = np.tile(CVA, (G, 1))
    js = jbr.SpikeSlabSampler(X, Y, cva, jbr.GroupsConfig(block_size=bs),
                              g_assign=g_assign, fixed=fixed,
                              dtype=jnp.float32, **kw)
    ts = SpikeSlabSampler(X, Y, cva, GroupsConfig(block_size=bs),
                          g_assign=g_assign, fixed=fixed, device="cpu", **kw)
    plan_ = (js.jacobi, js.B, js.jacobi_layout, js.Mpad, js.Npad)
    assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad, ts.Npad) == plan_
    assert (ts.variant, ts.G, ts.F) == ("groups", G, F)
    # the port's own data against JAX's, then JAX's carried across
    jd = {k: np.array(v) for k, v in js.data._asdict().items()}
    np.testing.assert_array_equal(ts.data.g_assign.numpy(), jd["g_assign"])
    np.testing.assert_allclose(ts.data.prior_pi.numpy(), jd["prior_pi"])
    carried = data_from_jax(jd, N=n, device="cpu")
    np.testing.assert_array_equal(ts.data.fixedT.numpy(),
                                  carried.fixedT.numpy())
    np.testing.assert_allclose(ts.data.fsq.numpy(), jd["fsq"], rtol=1e-7)
    ts.data = carried
    return js, ts


def update_l1(ts, beta0, beta1, alpha0, alpha1):
    """Per eps lane, the sum of the magnitudes of the terms a step adds to
    it: |d_m x_mn| over the markers m with d = beta1 - beta0 (x the
    standardized value) and |d_f F_fn| over the fixed effects; float64."""
    d = ts.data
    if ts.x_packed or ts.x_int8:
        codes = (genotypes.decode_codes(d.XT) if ts.x_packed
                 else d.XT.to(torch.int32))
        miss = codes == 3
        x = ((codes.double() - d.x_mean.double()[:, None])
             * d.x_scale.double()[:, None]).abs()
        x = torch.where(miss, 0.0, x)
    else:
        x = d.XT.double().abs()
    l1 = (beta1 - beta0).double().abs() @ x
    if ts.F:
        l1 = l1 + (alpha1 - alpha0).double().abs() @ d.fixedT.double().abs()
    return l1.numpy()


def assert_close(j, tst, ts, l1):
    np.testing.assert_array_equal(j["labels"], tst.labels.numpy())
    for field in ("beta", "alpha", "mu", "sigmaE", "sigmaF", "sigmaGG",
                  "pi"):
        np.testing.assert_allclose(j[field], getattr(tst, field).numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=field)
    e_port = tst.eps.numpy()
    e_jax = (unpermute_eps(j["eps"], ts.Npad) if ts.x_packed else j["eps"])
    assert np.all(np.abs(e_jax - e_port) <= 2e-4 * np.abs(e_port) + 2e-5
                  + 1e-5 * l1)
    assert np.all(j["iteration"] == tst.iteration)


# (case, fused): each path and storage mode once, C=2 fused chains where
# the kernels fuse them (the strided and serial fused sweeps; the row plan
# fuses through the serial one, as in JAX)
RUNS = [("t-fold", True), ("t-miss", False), ("t-int8", True),
        ("t-dense", False), ("serial-fold", True), ("serial-q", False),
        ("row", False), ("plain", False)]
SWEEPS = ("bayesr_jacobi_t", "bayesr_jacobi_t_mc", "bayesr_sweep",
          "bayesr_sweep_mc", "bayesr_jacobi")


def record_sweeps(monkeypatch):
    """Every sweep result of the port's BayesR steps, in call order."""
    from bayesrrcpp_tpu_torch.models import bayesr as tbayesr

    out = []

    def wrap(fn):
        def recorded(*a, **kw):
            res = fn(*a, **kw)
            out.append(res)
            return res
        return recorded

    for name in SWEEPS:
        monkeypatch.setattr(tbayesr, name, wrap(getattr(tbayesr, name)))
    monkeypatch.setattr(tbayesr.bs, "bayesr_block_sweep",
                        wrap(tbayesr.bs.bayesr_block_sweep))
    return out


def per_group(ts, labels, beta):
    """Per group, the label histogram (..., G, K) and the sum of beta^2
    (..., G) over the real markers, float64: after one sweep visits every
    marker once, its counts v and its bacc (beta^2 summed over the slab
    hits; a spike hit leaves beta 0) are these."""
    g = ts.data.g_assign[:ts.M].long()
    lab = torch.as_tensor(labels)[..., :ts.M].long()
    b2 = torch.as_tensor(beta)[..., :ts.M].double() ** 2
    onehot = torch.nn.functional.one_hot(g, ts.G).double()     # (M, G)
    hist = torch.stack([(lab == k).double() @ onehot for k in range(ts.K)],
                       dim=-1)
    return hist, b2 @ onehot


@pytest.mark.parametrize("name,fused", RUNS)
def test_grouped_steps_match_jax(name, fused, monkeypatch):
    js, ts = samplers(name)
    key = jax.random.PRNGKey(11)
    if fused:
        C = 2
        keys = jax.random.split(key, C)
        Chain = (JaxChainReplay if ts.strided else JaxSerialChainReplay)
        rv = Chain([JaxBayesRReplayVariates(k) for k in keys])
        jst, tst = jax.vmap(js.init)(keys), ts.init(rv, chains=C)
        step_j, step_t = js.step_chains, ts.step_chains
    else:
        rv = JaxBayesRReplayVariates(key)
        jst, tst = js.init(key), ts.init(rv)
        step_j, step_t = js.step, ts.step
    sweeps = record_sweeps(monkeypatch)
    for it in range(3):
        beta0, alpha0 = tst.beta, tst.alpha
        jst = step_j(jst)
        tst = step_t(tst, rv)
        j = {k: np.asarray(v) for k, v in jst._asdict().items()}
        assert_close(j, tst, ts, update_l1(ts, beta0, tst.beta, alpha0,
                                           tst.alpha))
        # the sweep's v and bacc, each directly: v exact to the histogram
        # of JAX's labels per group, bacc to the port's own per-group
        # |beta|^2 (f32 sums: 1e-5) and to JAX's (beta to 2e-4: 4e-4)
        res = sweeps[it]
        hist, b2 = per_group(ts, j["labels"], j["beta"])
        np.testing.assert_array_equal(res.v.double().numpy(), hist.numpy())
        _, own = per_group(ts, tst.labels, tst.beta)
        np.testing.assert_allclose(res.beta_acum.numpy(), own.numpy(),
                                   rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(res.beta_acum.numpy(), b2.numpy(),
                                   rtol=4e-4, atol=1e-8)
    assert len(sweeps) == 3
    assert bool((tst.labels > 0).any())
    carried = state_from_jax({k: np.array(v) for k, v in
                              jst._asdict().items()}, ts)
    torch.testing.assert_close(carried.alpha, tst.alpha, rtol=2e-4,
                               atol=2e-6)
    # the tracked eps (fixed-effect term included) against the recompute
    ex = ts.refresh_eps(tst)
    rel = torch.linalg.norm(tst.eps - ex.eps, dim=-1) / torch.linalg.norm(
        ex.eps, dim=-1)
    assert float(rel.max()) < 1e-5


@pytest.mark.parametrize("reference_prior_pi", [True, False])
def test_prior_and_refusals_follow_jax(reference_prior_pi):
    """The groups prior pi (0.5, 0.5/K, ...; normalised only with
    ``reference_prior_pi=False``), the bayesr variant's from cva, and
    JAX's refusals of g_assign out of range and of a fixed matrix of
    another N."""
    X, Y, g_assign, fixed, _ = data("dense", 3, 2)
    cva = np.tile(CVA, (3, 1))
    for variant in ("groups", "bayesr"):
        cfg = dict(block_size=64, reference_prior_pi=reference_prior_pi)
        js = jbr.SpikeSlabSampler(X, Y, cva, jbr.GroupsConfig(**cfg),
                                  g_assign=g_assign, fixed=fixed,
                                  variant=variant, dtype=jnp.float32)
        ts = SpikeSlabSampler(X, Y, cva, GroupsConfig(**cfg),
                              g_assign=g_assign, fixed=fixed,
                              variant=variant, device="cpu")
        np.testing.assert_allclose(ts.data.prior_pi.numpy(),
                                   np.asarray(js.data.prior_pi), rtol=1e-7)
    for bad in (dict(g_assign=np.full(M, 3)),
                dict(g_assign=np.arange(M - 1) % 3),
                dict(fixed=np.ones((N - 1, 2)))):
        kw = dict(dict(g_assign=g_assign, fixed=fixed), **bad)
        with pytest.raises(ValueError):
            SpikeSlabSampler(X, Y, cva, GroupsConfig(), device="cpu", **kw)


def test_groups_with_fixed_effects_recovers_signal():
    """tests/test_bayesr.py:86 (``test_groups_with_fixed_effects``) through
    the port at its bounds: N=700, M=240, 30 causal markers in 2 groups, 3
    fixed effects, cva x 10, the plain blocked sweep (block 64) in f32;
    50 iterations, the posterior over the last 25 (JAX's chain is 500,
    burn-in 250, thinning 2: the port's plain sweep is a Python loop,
    0.1-0.3 s an iteration here; the chain settles within 20, reading corr
    0.957 and alpha within 0.04 at 50, 60 and 100 iterations)."""
    sim = simulate.simulate_bayesr(seed=11, N=700, M=240, n_causal=30,
                                   h2=0.5, n_groups=2, n_fixed=3)
    cva = np.tile(CVA * 10.0, (2, 1))
    s = SpikeSlabSampler(sim.X, sim.Y, cva, GroupsConfig(block_size=64),
                         g_assign=sim.g_assign, fixed=sim.fixed,
                         backend="blocked", device="cpu")
    _, out = s.run(torch.Generator().manual_seed(3), ChainConfig(50, 25, 1))
    corr = np.corrcoef(sim.beta_true, out["beta"].mean(axis=0))[0, 1]
    assert corr > 0.75, corr
    np.testing.assert_allclose(out["alpha"].mean(axis=0), sim.alpha_true,
                               atol=0.15)
    assert out["sigmaG"].shape[1] == 2
    assert out["sigmaF"].ndim == 1
    assert np.isfinite(out["sigmaG"]).all()
