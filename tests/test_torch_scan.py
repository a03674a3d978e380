"""The port's literal scan sweeps (bayesrrcpp_tpu_torch/ops/sweep.py) and the
scan backend against the JAX package, on the CPU.

- ``bayesr_sweep_scan`` (two groups) and ``horseshoe_sweep_scan`` against
  JAX's (bayesrrcpp_tpu/ops/sweep.py:40, :84) on the same inputs, drawn
  with numpy from a seed: a full permutation of M=160 markers (the last 5
  padding, valid False), N=300, a warm state; in float32 (labels and the
  counts exact, beta and eps to rtol 2e-4 / atol 2e-5, bacc to rtol 1e-4:
  the two packages sum in different orders) and float64 (labels and counts
  exact, floats to rtol 1e-10 / atol 1e-12).
- The port's blocked sweep equals its scan in float64 under one
  generator (the same block orders, p and z) at tests/test_bayesr.py:31-45's
  tolerances (labels exact, beta and eps rtol 1e-8 / atol 1e-10, sigmaE and
  sigmaGG rtol 1e-8), three steps: BayesR (N=800, M=300, B=64, the recipe
  of tests/test_bayesr.py:20), the groups variant with two groups and three
  fixed effects, and the horseshoe (N=600, M=400, tests/test_horseshoe.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu.ops import sweep as jsweep
from bayesrrcpp_tpu_torch import (BayesRConfig, GroupsConfig,
                                  HorseshoeConfig, HorseshoeSampler,
                                  SpikeSlabSampler, simulate)
from bayesrrcpp_tpu_torch.ops import sweep as tsweep

N, M, PAD = 300, 160, 5
TOL = {np.float32: dict(rtol=2e-4, atol=2e-5),
       np.float64: dict(rtol=1e-10, atol=1e-12)}


def _inputs(seed, dt, G=2, K=4):
    rng = np.random.default_rng(seed)
    XT = rng.standard_normal((M, N))
    XT[M - PAD:] = 0.0
    XT = (XT - XT.mean(1, keepdims=True)) / np.maximum(
        XT.std(1, keepdims=True), 1e-9) * (np.arange(M) < M - PAD)[:, None]
    beta = np.where(rng.random(M) < 0.2, rng.normal(0, 0.05, M), 0.0)
    beta[M - PAD:] = 0.0
    return dict(
        XT=XT.astype(dt), xsq=(XT * XT).sum(1).astype(dt),
        eps=rng.standard_normal(N).astype(dt), beta=beta.astype(dt),
        labels=np.where(beta != 0, rng.integers(1, K, M), 0).astype(np.int32),
        order=rng.permutation(M).astype(np.int32),
        p=rng.random(M).astype(dt), z=rng.standard_normal(M).astype(dt),
        pi=rng.dirichlet([6, 2, 1, 1], G).astype(dt),
        cva=np.tile([1e-3, 1e-2, 1e-1], (G, 1)).astype(dt),
        sigmaE=np.asarray(0.8, dt), sigmaGG=rng.uniform(0.02, 0.1, G).astype(dt),
        g_assign=(np.arange(M) % G).astype(np.int32),
        valid=np.arange(M) < M - PAD,
        lam=rng.uniform(0.1, 2.0, M).astype(dt), tau=np.asarray(0.05, dt),
        c2=np.asarray(1.5, dt))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_bayesr_scan_sweep_matches_jax(dt):
    a = _inputs(11, dt)
    keys = ("XT", "xsq", "eps", "beta", "labels", "order", "p", "z", "pi",
            "cva", "sigmaE", "sigmaGG", "g_assign", "valid")
    jr = jsweep.bayesr_sweep_scan(*(jnp.asarray(a[k]) for k in keys))
    tr = tsweep.bayesr_sweep_scan(*(torch.as_tensor(a[k]) for k in keys))
    assert tr.eps.dtype == torch.as_tensor(a["eps"]).dtype
    np.testing.assert_array_equal(tr.labels.numpy(), np.asarray(jr.labels))
    np.testing.assert_array_equal(tr.v.numpy(), np.asarray(jr.v))
    assert (tr.labels.numpy() != a["labels"]).any()
    for name in ("beta", "eps"):
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   np.asarray(getattr(jr, name)),
                                   **TOL[dt], err_msg=name)
    np.testing.assert_allclose(tr.beta_acum.numpy(),
                               np.asarray(jr.beta_acum),
                               rtol=1e-4 if dt == np.float32 else 1e-10)
    # padding markers untouched
    assert (tr.beta.numpy()[M - PAD:] == 0).all()


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_horseshoe_scan_sweep_matches_jax(dt):
    a = _inputs(12, dt)
    keys = ("XT", "xsq", "eps", "beta", "order", "z", "lam", "tau", "c2",
            "sigmaE", "valid")
    je, jb = jsweep.horseshoe_sweep_scan(*(jnp.asarray(a[k]) for k in keys))
    te, tb = tsweep.horseshoe_sweep_scan(*(torch.as_tensor(a[k])
                                           for k in keys))
    assert te.dtype == tb.dtype == torch.as_tensor(a["eps"]).dtype
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL[dt])
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL[dt])
    assert (tb.numpy()[M - PAD:] == 0).all()


def _pair(make, steps=3):
    """(blocked, scan) states after ``steps`` steps of ``make(backend,
    **kw)``'s samplers, each drawing from a generator seeded alike."""
    out = []
    for kw in (dict(backend="blocked"),
               dict(backend="scan", permutation="blocked")):
        s = make(**kw)
        g = torch.Generator().manual_seed(0)
        st = s.init(g)
        for _ in range(steps):
            st = s.step(st, g)
        assert st.eps.dtype == torch.float64
        out.append(st)
    return out


def _close(b, s, name, **tol):
    np.testing.assert_allclose(getattr(b, name).numpy(),
                               getattr(s, name).numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("variant", ["bayesr", "groups"])
def test_blocked_equals_scan_f64(variant):
    if variant == "bayesr":
        sim = simulate.simulate_bayesr(seed=7, N=800, M=300, n_causal=40,
                                       h2=0.5)
        cva, cfg, kw = (np.array([0.0001, 0.001, 0.01]),
                        BayesRConfig(block_size=64), {})
    else:
        sim = simulate.simulate_bayesr(seed=8, N=600, M=240, n_causal=30,
                                       h2=0.5, n_groups=2, n_fixed=3)
        cva, cfg = np.tile([0.001, 0.01, 0.1], (2, 1)), GroupsConfig(
            block_size=64)
        kw = dict(g_assign=sim.g_assign, fixed=sim.fixed)
    b, s = _pair(lambda **k: SpikeSlabSampler(
        sim.X, sim.Y, cva, cfg, dtype=torch.float64, device="cpu", **kw,
        **k))
    np.testing.assert_array_equal(b.labels.numpy(), s.labels.numpy())
    for name in ("beta", "eps"):
        _close(b, s, name, rtol=1e-8, atol=1e-10)
    for name in ("sigmaE", "sigmaGG", "alpha", "sigmaF", "pi"):
        _close(b, s, name, rtol=1e-8)
    assert (b.labels.numpy() > 0).sum() > 0


def test_horseshoe_blocked_equals_scan_f64():
    sim = simulate.simulate_bayesr(seed=21, N=600, M=400, n_causal=30,
                                   h2=0.5)
    A = (1.0 / np.sqrt(600)) * 30 / (400 - 30)
    cfg = HorseshoeConfig(A=A, block_size=64)
    b, s = _pair(lambda **k: HorseshoeSampler(
        sim.X, sim.Y, cfg, dtype=torch.float64, device="cpu", **k))
    for name in ("beta", "eps"):
        _close(b, s, name, rtol=1e-8, atol=1e-10)
    for name in ("tau", "sigmaE", "lam", "c2"):
        _close(b, s, name, rtol=1e-8)
