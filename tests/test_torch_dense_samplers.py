"""Both samplers on dense f32 X through the sweep kernels' dense mode
(``backend="pallas"``) against the JAX package, on the CPU.

- Three replayed steps of ``SpikeSlabSampler`` and ``HorseshoeSampler``
  (the port draws through a variates object that replays the JAX
  sampler's own draws, tests/test_torch_bayesr.py), one chain (``step``)
  and 3 fused chains (``step_chains``, the shared visit order chain 0's),
  at the strided plan (J=3, "t") and at ``jacobi_blocks=1`` (the serial
  sweeps).  The JAX sampler runs its Pallas kernels in interpret mode; the
  port's data is the JAX sampler's carried across by ``convert``.
- Dense against packed fold on the same dosages, through the port alone:
  the twin of tests/test_jacobi_t.py:150-220 (same variates seed, three
  steps; labels equal, beta to rtol 3e-4 / atol 3e-6, sigmaE to 2e-4).
- The dense plan (J, B, layout) against JAX's at M = 96, 1,500 and 4,096
  with ``block_size`` 512 and 64; on the row plan with J > 1 (M=1,500 at
  64) one replayed step equals JAX's.
- ``convert.data_from_jax`` on JAX dense data: the same arrays and the same
  sweep as the port's own layout; JAX int8 data carries across.
- ``cli.py --backend``, and a dense CLI run on ``--device cpu``.

Data: standardized dosages made with numpy from a seed, N=150, M=96 in
blocks of B=16 (JAX's dense-vs-packed cases, tests/test_jacobi_t.py:153).
Tolerances of the replayed steps: labels exact, eps, beta and the
hyperparameters to rtol 2e-5 / atol 2e-6, f32 reassociation (the two
packages sum each dot and apply in different orders).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu_torch import (BayesRConfig, HorseshoeConfig,
                                  HorseshoeSampler, SpikeSlabSampler,
                                  TorchVariates, cli)
from bayesrrcpp_tpu_torch.convert import (data_from_jax,
                                          horseshoe_data_from_jax)
from tests.test_torch_horseshoe import JaxHorseshoeReplayVariates
from tests.test_torch_multichain import (JaxBayesRReplayVariates,
                                         JaxChainReplay)

CVA = np.array([0.001, 0.01, 0.1])
N, M, B, C = 150, 96, 16, 3
PLANS = {"t": dict(jacobi_blocks=3, jacobi_layout="t"),
         "serial": dict(jacobi_blocks=1)}


class ChainReplay(JaxChainReplay):
    """``JaxChainReplay`` with the serial sweep's block order chain 0's
    too, as JAX's ``_mc_step_impl`` takes ``korder[0]`` at J=1."""

    def block_orders(self, nb, B):
        return self.singles[0].block_orders(nb, B)


def dense_data(seed, M=M, N=N):
    """(dosage, standardized X, Y), numpy (the recipe of
    tests/test_jacobi.py:_nomissing_dosage)."""
    rng = np.random.default_rng(seed)
    dosage = rng.binomial(2, rng.uniform(0.2, 0.8, M), size=(N, M)).astype(
        float)
    X = (dosage - dosage.mean(axis=0)) / dosage.std(axis=0, ddof=1)
    beta_t = np.zeros(M)
    beta_t[rng.choice(M, 8, replace=False)] = rng.normal(0, 0.3, 8)
    return dosage, X, X @ beta_t + rng.normal(0, 0.7, N)


def samplers(kind, seed, plan):
    """The JAX and port samplers on the same dense X, the port's data
    carried across from JAX's."""
    _, X, Y = dense_data(seed)
    kw = dict(backend="pallas", **PLANS[plan])
    if kind == "bayesr":
        js = jbr.SpikeSlabSampler(X, Y, CVA, jbr.BayesRConfig(block_size=B),
                                  dtype=jnp.float32, **kw)
        ts = SpikeSlabSampler(X, Y, CVA, BayesRConfig(block_size=B),
                              device="cpu", **kw)
        carry, Replay = data_from_jax, JaxBayesRReplayVariates
    else:
        js = jbr.HorseshoeSampler(X, Y, jbr.HorseshoeConfig(block_size=B),
                                  dtype=jnp.float32, **kw)
        ts = HorseshoeSampler(X, Y, HorseshoeConfig(block_size=B),
                              device="cpu", **kw)
        carry, Replay = horseshoe_data_from_jax, JaxHorseshoeReplayVariates
    assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad, ts.Npad) == \
        (js.jacobi, js.B, js.jacobi_layout, js.Mpad, js.Npad)
    assert ts.backend == "pallas" and not ts.x_packed
    assert ts.supports_fused_chains and js.supports_fused_chains
    ts.data = carry({k: np.array(v) for k, v in js.data._asdict().items()},
                    N=N, device="cpu")
    return js, ts, Replay


def assert_states_close(jst, tst):
    j = {k: np.asarray(v) for k, v in jst._asdict().items()}
    if "labels" in j:
        np.testing.assert_array_equal(j["labels"], tst.labels.numpy())
    for field in ("eps", "beta", "mu", "sigmaE", "sigmaGG", "pi", "lam", "v",
                  "tau", "eta", "c2"):
        if field in j:
            np.testing.assert_allclose(j[field], getattr(tst, field).numpy(),
                                       rtol=2e-5, atol=2e-6, err_msg=field)
    assert np.all(j["iteration"] == tst.iteration)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("plan", ["t", "serial"])
@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_dense_steps_match_jax(kind, plan, fused):
    js, ts, Replay = samplers(kind, 7, plan)
    assert ts._sweep_kw() == {"x_mean": None}
    if fused:
        keys = jax.random.split(jax.random.PRNGKey(5), C)
        rv = ChainReplay([Replay(k) for k in keys])
        jst, tst = jax.vmap(js.init)(keys), ts.init(rv, chains=C)
        jstep, tstep = js.step_chains, ts.step_chains
    else:
        key = jax.random.PRNGKey(4)
        rv = Replay(key)
        jst, tst = js.init(key), ts.init(rv)
        jstep, tstep = js.step, ts.step
    assert tst.eps.shape[-1] == N
    for _ in range(3):
        jst = jstep(jst)
        tst = tstep(tst, rv)
        assert_states_close(jst, tst)
    if fused:
        assert not torch.equal(tst.beta[0], tst.beta[1])
    ex = ts.refresh_eps(tst)
    rel = torch.linalg.norm(tst.eps - ex.eps) / torch.linalg.norm(ex.eps)
    assert float(rel) < 1e-5


@pytest.mark.parametrize("case", ["bayesr", "bayesr_fused", "bayesr_serial",
                                  "horseshoe"])
def test_dense_equals_packed_fold(case):
    """The dense kernels' sweep and the packed fold sweep on the same
    dosages, through the port alone, from the same variates: the twin of
    tests/test_jacobi_t.py:test_t_fold_quantized_equals_dense and its
    fused and horseshoe versions."""
    dosage, X, Y = dense_data(41)
    plan = PLANS["serial" if case == "bayesr_serial" else "t"]
    if case == "horseshoe":
        cfg = HorseshoeConfig(block_size=B)
        s_d = HorseshoeSampler(X, Y, cfg, backend="pallas", device="cpu",
                               **plan)
        s_q = HorseshoeSampler(dosage, Y, cfg, x_dtype="2bit", device="cpu",
                               **plan)
    else:
        cfg = BayesRConfig(block_size=B)
        s_d = SpikeSlabSampler(X, Y, CVA, cfg, backend="pallas",
                               device="cpu", **plan)
        s_q = SpikeSlabSampler(dosage, Y, CVA, cfg, x_dtype="2bit",
                               device="cpu", **plan)
    assert (s_d.jacobi, s_d.B, s_d.Mpad) == (s_q.jacobi, s_q.B, s_q.Mpad)
    assert s_q._sweep_kw()["fold_affine"] and s_d.Npad == N < s_q.Npad
    chains = C if case == "bayesr_fused" else None
    v_d = TorchVariates(torch.Generator().manual_seed(42), chains=chains)
    v_q = TorchVariates(torch.Generator().manual_seed(42), chains=chains)
    st_d, st_q = s_d.init(v_d, chains=chains), s_q.init(v_q, chains=chains)
    step_d = s_d.step_chains if chains else s_d.step
    step_q = s_q.step_chains if chains else s_q.step
    for _ in range(3):
        st_d, st_q = step_d(st_d, v_d), step_q(st_q, v_q)
    if case != "horseshoe":
        torch.testing.assert_close(st_d.labels, st_q.labels, rtol=0, atol=0)
    torch.testing.assert_close(st_d.beta, st_q.beta, rtol=3e-4, atol=3e-6)
    torch.testing.assert_close(st_d.sigmaE, st_q.sigmaE, rtol=2e-4, atol=0)
    torch.testing.assert_close(st_d.eps, st_q.eps[..., :N], rtol=3e-4,
                               atol=3e-5)


@pytest.mark.parametrize("block", [512, 64])
def test_dense_plan_matches_jax(block):
    rng = np.random.default_rng(3)
    for m in (96, 1500, 4096):
        X = rng.standard_normal((24, m))
        Y = rng.standard_normal(24)
        js = jbr.SpikeSlabSampler(X, Y, CVA, jbr.BayesRConfig(block_size=block),
                                  backend="pallas", dtype=jnp.float32)
        jplan = (js.jacobi, js.B, js.jacobi_layout)
        if jplan[2] == "row" and jplan[0] > 1:
            # both sweep it with the row-layout kernel (site #16)
            assert (m, block) == (1500, 64), jplan
            from tests.test_torch_row_samplers import \
                assert_row_step_matches_jax

            assert_row_step_matches_jax("bayesr", X, Y, CVA,
                                        cfg=dict(block_size=block),
                                        backend="pallas")
            continue
        ts = SpikeSlabSampler(X, Y, CVA, BayesRConfig(block_size=block),
                              backend="pallas", device="cpu")
        assert (ts.jacobi, ts.B, ts.jacobi_layout) == jplan, m
        assert (ts.Mpad, ts.Npad) == (js.Mpad, js.Npad)
        # the plain backend keeps J=1, as JAX's blocked one
        tb = SpikeSlabSampler(X, Y, CVA, BayesRConfig(block_size=block),
                              device="cpu")
        assert (tb.backend, tb.jacobi, tb.supports_fused_chains) == (
            "blocked", 1, False)


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_convert_carries_dense_data(kind):
    """JAX dense data carried across equals the port's own layout of the
    same X (rows bitwise, statistics to f32 reassociation), and a sweep of
    each gives the same state; JAX int8 data of the same dosages carries
    across too (its codes unchanged, tests/test_torch_int8_io.py)."""
    js, ts, Replay = samplers(kind, 11, "t")
    carried = ts.data
    dosage, X, Y = dense_data(11)
    own = (SpikeSlabSampler(X, Y, CVA, BayesRConfig(block_size=B),
                            backend="pallas", device="cpu", **PLANS["t"])
           if kind == "bayesr" else
           HorseshoeSampler(X, Y, HorseshoeConfig(block_size=B),
                            backend="pallas", device="cpu", **PLANS["t"]))
    assert torch.equal(carried.XT, own.data.XT)
    assert carried.XT.dtype == torch.float32 and not carried.has_missing
    assert carried.x_mean.numel() == carried.row_valid.numel() == 0
    torch.testing.assert_close(carried.xsq, own.data.xsq, rtol=2e-6, atol=0)
    torch.testing.assert_close(carried.gram, own.data.gram, rtol=2e-5,
                               atol=2e-5)
    key = jax.random.PRNGKey(9)
    r1, r2 = Replay(key), Replay(key)
    st1 = ts.step(ts.init(r1), r1)
    st2 = own.step(own.init(r2), r2)
    if kind == "bayesr":
        assert torch.equal(st1.labels, st2.labels)
    torch.testing.assert_close(st1.beta, st2.beta, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(st1.eps, st2.eps, rtol=2e-5, atol=2e-6)
    j8 = jbr.SpikeSlabSampler(dosage, Y, CVA, jbr.BayesRConfig(block_size=B),
                              x_dtype="int8", dtype=jnp.float32)
    d8 = data_from_jax({k: np.array(v) for k, v in j8.data._asdict().items()},
                       N=N, device="cpu")
    assert d8.XT.dtype == torch.int8 and not d8.has_missing
    np.testing.assert_array_equal(d8.XT.numpy(), np.asarray(j8.data.XT))


def test_cli_backend_flag(tmp_path):
    """``--backend`` parses JAX's choices: auto picks the kernels for
    dense X on the card and the plain sweep on the CPU; pallas runs the
    kernels' dense mode on the CPU (their plain versions); scan runs the
    literal per-marker sweep."""
    _, X, Y = dense_data(13)
    np.save(tmp_path / "x.npy", X)
    np.save(tmp_path / "y.npy", Y)
    base = ["--x", str(tmp_path / "x.npy"), "--y", str(tmp_path / "y.npy"),
            "--device", "cpu", "--iterations", "6", "--burn-in", "2",
            "--thinning", "2", "--block-size", str(B)]
    for kind in ("bayesr", "horseshoe"):
        for backend in ("pallas", "auto", "blocked", "scan"):
            out = str(tmp_path / f"{kind}_{backend}.csv")
            assert cli.main([kind, *base, "--backend", backend,
                             "--out", out]) == 0
            with open(out) as f:
                header = f.readline().rstrip("\n").split(",")
                rows = [r for r in f.read().split("\n") if r]
            assert len(header) == 2 + 2 * M + 2 + N
            assert len(rows) == 2
            assert all(len(r.split(", ")) == len(header) for r in rows)
            assert not any("nan" in r or "inf" in r for r in rows)
    with pytest.raises(SystemExit):
        cli.main(["bayesr", *base, "--backend", "xla",
                  "--out", str(tmp_path / "bad.csv")])
    assert not os.path.exists(tmp_path / "bad.csv")
