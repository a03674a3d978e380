"""The port's exact sequential (J=1) sweeps (bayesrrcpp_tpu_torch/ops/
serial.py, ops/multichain.py) and the samplers' J=1 steps against the JAX
package, on the CPU.

The same packed words, Gram blocks, warm state and variates (block order,
inner permutations, p, z), made with numpy from a seed at N=2048 (one
2048-lane tile), M=512, B=64, go through

- JAX ``bayesr_sweep_pallas`` / ``horseshoe_sweep_pallas`` and the fused
  ``bayesr_sweep_pallas_mc`` / ``horseshoe_sweep_pallas_mc`` with
  ``interpret=True, fold_affine=True``, the TPU kernels run as the JAX
  tests run them;
- the port's wrappers on CPU tensors (their plain versions).

``max_call_blocks=3`` splits the 8-block sweep into chunks of 2, 3 and 3
blocks, so sum(eps) is recomputed at two chunk boundaries.  Tolerances are
tests/test_torch_jacobi_t.py's: labels and v exact, floats to f32
reassociation (the two sum the dots in different orders), also for each
fused chain against the single-chain plain version (one matrix product
over C chains rounds unlike C products over one).  Then 3 replayed steps
of both samplers at ``jacobi_blocks=1``, one chain and fused, against the
JAX samplers at two seeds (eps held to the rounding of what a sweep adds
to it, against a float64 rerun of the sweep), and the auto plan for M <
2048.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu.ops import genotypes as jgen
from bayesrrcpp_tpu.ops.pallas_multichain import (bayesr_sweep_pallas_mc,
                                                  horseshoe_sweep_pallas_mc)
from bayesrrcpp_tpu.ops.pallas_sweep import (bayesr_sweep_pallas,
                                             horseshoe_sweep_pallas)
from bayesrrcpp_tpu_torch import (BayesRConfig, ChainConfig, HorseshoeConfig,
                                  HorseshoeSampler, SpikeSlabSampler)
from bayesrrcpp_tpu_torch.convert import (data_from_jax,
                                          horseshoe_data_from_jax,
                                          horseshoe_state_from_jax,
                                          state_from_jax, unpermute_eps)
from bayesrrcpp_tpu_torch.models import bayesr as tbayesr
from bayesrrcpp_tpu_torch.models import horseshoe as thorseshoe
from bayesrrcpp_tpu_torch.ops import genotypes, multichain, serial
from tests.test_torch_horseshoe import JaxHorseshoeReplayVariates
from tests.test_torch_multichain import (JaxBayesRReplayVariates,
                                         JaxChainReplay)

CVA = np.array([0.001, 0.01, 0.1])
N, M, B = 2048, 512, 64
NB = M // B


def _case(seed, G, C=None):
    """Packed data (the JAX host packer), a warm state and variates, all
    numpy; with C, every per-chain array has a leading chain axis and p/z
    are marker-indexed (C, M)."""
    rng = np.random.default_rng(seed)
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(
        float)
    q = jgen.quantize_packed(dosage, False, None, B, M, N, prepacked=False)
    lead = () if C is None else (C,)
    eps = rng.standard_normal(lead + (N,)).astype(np.float32)
    beta = np.zeros(lead + (M,), np.float32)
    labels = np.zeros(lead + (M,), np.int32)
    for c in np.ndindex(lead):
        hot = rng.choice(M, M // 8, replace=False)
        labels[c + (hot,)] = rng.integers(1, 4, hot.size)
        beta[c + (hot,)] = rng.normal(0, 0.05, hot.size)
    return dict(
        q=q, eps=eps, eps_perm=eps[..., np.asarray(q.n_perm)], beta=beta,
        labels=labels,
        border=rng.permutation(NB).astype(np.int32),
        inner=np.argsort(rng.random((NB, B)), axis=1).astype(np.int32),
        p=rng.random(lead + (M,)).astype(np.float32),
        z=rng.standard_normal(lead + (M,)).astype(np.float32),
        pi=rng.dirichlet([5, 2, 2, 1], lead + (G,)).astype(np.float32),
        cva=np.tile(CVA.astype(np.float32), (G, 1)),
        sigmaE=rng.uniform(0.5, 1.0, lead).astype(np.float32),
        sigmaGG=rng.uniform(0.02, 0.08, lead + (G,)).astype(np.float32),
        lam=rng.uniform(0.1, 2.0, lead + (M,)).astype(np.float32),
        tau=rng.uniform(0.01, 0.1, lead).astype(np.float32),
        c2=rng.uniform(1.0, 2.0, lead).astype(np.float32),
        gas=(np.arange(M) % G).astype(np.int32),
        valid=np.arange(M) < M - 3)         # a few invalid pad markers


def _data(c):
    q = c["q"]
    return [torch.as_tensor(np.array(x)) for x in (q.XT, q.gram, q.xsq)]


def _kw(c, max_call_blocks=None):
    q = c["q"]
    return dict(x_mean=torch.as_tensor(np.array(q.x_mean)),
                x_scale=torch.as_tensor(np.array(q.x_scale)),
                x_xsum=torch.as_tensor(np.array(q.x_colsum)),
                fold_affine=True, row_valid=torch.ones(N, dtype=torch.bool),
                max_call_blocks=max_call_blocks)


def _jax_kw(c, max_call_blocks=None):
    q = c["q"]
    return dict(interpret=True, x_mean=q.x_mean, x_scale=q.x_scale,
                x_xsum=q.x_colsum, fold_affine=True, row_valid=q.row_valid,
                max_call_blocks=max_call_blocks)


def _bayesr_args(c, mod):
    """The BayesR sweep's arguments after the data, for torch or jnp."""
    a = torch.as_tensor if mod is torch else jnp.asarray
    return [a(c[k]) for k in ("beta", "labels", "border", "inner", "p", "z",
                              "pi", "cva", "sigmaE", "sigmaGG", "gas",
                              "valid")]


def _hs_args(c, mod):
    a = torch.as_tensor if mod is torch else jnp.asarray
    return [a(c[k]) for k in ("beta", "border", "inner", "z", "lam", "tau",
                              "c2", "sigmaE", "valid")]


# ------------------------------------------------------------ the sweeps


@pytest.mark.parametrize("G,chunk", [(1, None), (2, 3)])
def test_bayesr_plain_matches_jax_kernel(G, chunk):
    c = _case(3 + G, G)
    q = c["q"]
    before = serial.bayesr_sweep.launches
    out = serial.bayesr_sweep(*_data(c), torch.as_tensor(c["eps"]),
                              *_bayesr_args(c, torch), **_kw(c, chunk))
    assert serial.bayesr_sweep.launches == before   # CPU: the plain version
    ref = serial.bayesr_sweep_reference(*_data(c), torch.as_tensor(c["eps"]),
                                        *_bayesr_args(c, torch),
                                        **_kw(c, chunk))
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    ker = bayesr_sweep_pallas(q.XT, q.gram, q.xsq, jnp.asarray(c["eps_perm"]),
                              *_bayesr_args(c, jnp), **_jax_kw(c, chunk))
    np.testing.assert_array_equal(np.asarray(ker.labels), out.labels.numpy())
    np.testing.assert_array_equal(np.asarray(ker.v), out.v.numpy())
    assert (out.labels != torch.as_tensor(c["labels"])).any()
    np.testing.assert_allclose(np.asarray(ker.beta), out.beta.numpy(),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(unpermute_eps(np.asarray(ker.eps), N),
                               out.eps.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ker.beta_acum),
                               out.beta_acum.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("chunk", [None, 3])
def test_horseshoe_plain_matches_jax_kernel(chunk):
    c = _case(11, 1)
    q = c["q"]
    before = serial.horseshoe_sweep.launches
    eps, beta = serial.horseshoe_sweep(*_data(c), torch.as_tensor(c["eps"]),
                                       *_hs_args(c, torch), **_kw(c, chunk))
    assert serial.horseshoe_sweep.launches == before
    e_k, b_k = horseshoe_sweep_pallas(
        q.XT, q.gram, q.xsq, jnp.asarray(c["eps_perm"]), *_hs_args(c, jnp),
        **_jax_kw(c, chunk))
    np.testing.assert_allclose(np.asarray(b_k), beta.numpy(), rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_allclose(unpermute_eps(np.asarray(e_k), N), eps.numpy(),
                               rtol=2e-4, atol=2e-5)


def _remapped(c, ch):
    """Chain ch of a fused case as a single-chain case: its own state and
    variates, p/z moved from marker to sweep-position order."""
    at = serial.position_markers(torch.as_tensor(c["border"]),
                                 torch.as_tensor(c["inner"]), B).numpy()
    one = {k: (v[ch] if k in ("eps", "beta", "labels", "pi", "sigmaE",
                              "sigmaGG", "lam", "tau", "c2") else v)
           for k, v in c.items()}
    one["p"], one["z"] = c["p"][ch][at], c["z"][ch][at]
    return one


@pytest.mark.parametrize("chunk", [None, 3])
def test_bayesr_mc_plain_matches_jax_kernel_and_single_chains(chunk):
    C = 3
    c = _case(21, 1, C)
    q = c["q"]
    before = multichain.bayesr_sweep_mc.launches
    out = multichain.bayesr_sweep_mc(*_data(c), torch.as_tensor(c["eps"]),
                                     *_bayesr_args(c, torch), **_kw(c, chunk))
    assert multichain.bayesr_sweep_mc.launches == before
    ker = bayesr_sweep_pallas_mc(
        q.XT, q.gram, q.xsq, jnp.asarray(c["eps_perm"]),
        *_bayesr_args(c, jnp), **_jax_kw(c, chunk))
    np.testing.assert_array_equal(np.asarray(ker.labels), out.labels.numpy())
    np.testing.assert_array_equal(np.asarray(ker.v), out.v.numpy())
    np.testing.assert_allclose(np.asarray(ker.beta), out.beta.numpy(),
                               rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(unpermute_eps(np.asarray(ker.eps), N),
                               out.eps.numpy(), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(np.asarray(ker.beta_acum),
                               out.beta_acum.numpy(), rtol=3e-4, atol=1e-6)
    for ch in range(C):
        one = _remapped(c, ch)
        res = serial.bayesr_sweep_reference(
            *_data(one), torch.as_tensor(one["eps"]),
            *_bayesr_args(one, torch), **_kw(one, chunk))
        assert torch.equal(res.labels, out.labels[ch])
        assert torch.equal(res.v, out.v[ch])
        torch.testing.assert_close(res.beta, out.beta[ch], rtol=2e-4,
                                   atol=2e-6)
        torch.testing.assert_close(res.eps, out.eps[ch], rtol=2e-4,
                                   atol=2e-5)
        torch.testing.assert_close(res.beta_acum, out.beta_acum[ch],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("chunk", [None, 3])
def test_horseshoe_mc_plain_matches_jax_kernel_and_single_chains(chunk):
    C = 3
    c = _case(31, 1, C)
    q = c["q"]
    before = multichain.horseshoe_sweep_mc.launches
    eps, beta = multichain.horseshoe_sweep_mc(
        *_data(c), torch.as_tensor(c["eps"]), *_hs_args(c, torch),
        **_kw(c, chunk))
    assert multichain.horseshoe_sweep_mc.launches == before
    e_k, b_k = horseshoe_sweep_pallas_mc(
        q.XT, q.gram, q.xsq, jnp.asarray(c["eps_perm"]), *_hs_args(c, jnp),
        **_jax_kw(c, chunk))
    np.testing.assert_allclose(np.asarray(b_k), beta.numpy(), rtol=3e-4,
                               atol=3e-6)
    np.testing.assert_allclose(unpermute_eps(np.asarray(e_k), N), eps.numpy(),
                               rtol=3e-4, atol=3e-5)
    for ch in range(C):
        one = _remapped(c, ch)
        e1, b1 = serial.horseshoe_sweep_reference(
            *_data(one), torch.as_tensor(one["eps"]), *_hs_args(one, torch),
            **_kw(one, chunk))
        torch.testing.assert_close(b1, beta[ch], rtol=2e-4, atol=2e-6)
        torch.testing.assert_close(e1, eps[ch], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("bad", ["dense", "no_fold"])
def test_modes_outside_the_slice_raise(bad):
    """int8 codes (sites #9/#10: ported, the ``dense`` case) run and equal
    the packed sweep of the same dosages bitwise (N = Npad here: the same
    codes, the same plain algebra); and the in-kernel decode
    (``fold_affine=False``, words with missing calls), which runs one chain
    only (tests/test_torch_missing.py): the fused sweeps refuse it, as
    JAX's ``bayesr_sweep_pallas_mc`` does."""
    c = _case(5, 1)
    words, gram, xsq = _data(c)
    kw = _kw(c)
    eps = torch.as_tensor(c["eps"])
    if bad == "dense":
        codes = genotypes.decode_codes(words)[:, :N].to(torch.int8)
        kw8 = {k: v for k, v in kw.items() if k != "row_valid"}
        for fn, args in ((serial.bayesr_sweep, _bayesr_args(c, torch)),
                         (serial.horseshoe_sweep, _hs_args(c, torch))):
            for a, b in zip(fn(codes, gram, xsq, eps, *args, **kw8),
                            fn(words, gram, xsq, eps, *args, **kw)):
                assert torch.equal(a, b)
        return
    kw["fold_affine"] = False
    for fn, args in ((multichain.bayesr_sweep_mc, _bayesr_args(c, torch)),
                     (multichain.horseshoe_sweep_mc, _hs_args(c, torch))):
        with pytest.raises(NotImplementedError, match="single-chain only"):
            fn(words, gram, xsq, eps, *args, **kw)


# ------------------------------------------------------------ the samplers


class JaxSerialChainReplay(JaxChainReplay):
    """``JaxChainReplay`` whose blocked sweep orders are chain 0's, as
    JAX's fused J=1 step takes ``korder[0]`` (bayesr.py:717)."""

    def block_orders(self, nb, B):
        return self.singles[0].block_orders(nb, B)


def _samplers(kind, seed, **kw):
    rng = np.random.default_rng(seed)
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(
        float)
    beta_t = np.where(rng.random(M) < 0.05, rng.normal(0, 0.3, M), 0.0)
    X = (dosage - dosage.mean(0)) / dosage.std(0, ddof=1)
    Y = X @ beta_t + rng.normal(0, 0.8, N)
    kw = dict(x_dtype="2bit", **kw)
    if kind == "bayesr":
        js = jbr.SpikeSlabSampler(dosage, Y, CVA,
                                  jbr.BayesRConfig(block_size=B),
                                  dtype=jnp.float32, **kw)
        ts = SpikeSlabSampler(dosage, Y, CVA, BayesRConfig(block_size=B),
                              device="cpu", **kw)
        ts.data = data_from_jax(
            {k: np.array(v) for k, v in js.data._asdict().items()}, N=N,
            device="cpu")
        return js, ts, JaxBayesRReplayVariates, state_from_jax
    cfg = dict(A=1.0 / np.sqrt(N) * 20 / (M - 20), block_size=B)
    js = jbr.HorseshoeSampler(dosage, Y, jbr.HorseshoeConfig(**cfg),
                              dtype=jnp.float32, **kw)
    ts = HorseshoeSampler(dosage, Y, HorseshoeConfig(**cfg), device="cpu",
                          **kw)
    ts.data = horseshoe_data_from_jax(
        {k: np.array(v) for k, v in js.data._asdict().items()}, N=N,
        device="cpu")
    return js, ts, JaxHorseshoeReplayVariates, horseshoe_state_from_jax


def _update_l1(ts, beta0, beta1):
    """Per eps lane, the sum of the magnitudes of the terms a sweep adds to
    it: |d_m * s_m * (c_mn - m_m)| over the markers m, with d = beta1 -
    beta0; float64, the shape of eps."""
    d = ts.data
    x = (genotypes.decode_codes(d.XT).double()
         - d.x_mean.double()[:, None]).abs()
    return ((beta1 - beta0).double() * d.x_scale.double()).abs() @ x


def _as_f64(x):
    return x.double() if torch.is_tensor(x) and x.is_floating_point() else x


# eps tolerances of the replayed steps, in units of _update_l1 (see below)
L1_TOL_PORT_JAX, L1_TOL_F64 = 1e-5, 6e-6


@pytest.mark.parametrize("seed,key", [(5, 3), (41, 7)])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_serial_steps_match_jax_with_replayed_variates(kind, fused, seed, key,
                                                       monkeypatch):
    """3 replayed steps at jacobi_blocks=1 (plan (1, 64, "row"), Mpad = M):
    one chain through ``step``, or C=3 fused chains through
    ``step_chains`` with chain 0's block order; labels exact, beta and the
    hyperparameters to rtol 2e-4, the horseshoe's lambda and its auxiliary
    v to 4e-4: lambda's rate vL/v + beta^2/(2 tau) carries beta squared,
    so where that term dominates lambda's relative rounding is twice
    beta's, and v is drawn from lambda (reading, seed 41 / key 7, step 2:
    beta within its tolerance at 1.9e-4 relative, lambda 3.0e-4 with the
    beta term 78 % of the rate).

    eps is held to the size of what a sweep adds to it.  A lane of eps
    receives d_m*s_m*(c_mn - m_m) from every marker m that moved, and the
    two packages sum those terms in f32 in different orders, so their gap
    scales with L1, the sum of the terms' magnitudes (``_update_l1``), not
    with |eps|.  In the first step from init most markers move far and L1
    reaches ~10 where eps may be ~0.01.  Each step's sweep is rerun in
    float64 (the plain version given float64 operands) on the port's
    operands: the port is within 6e-6 L1 of it at every step and JAX at the
    first, where both start from the same state (readings, seed 41 / key
    7: 3.4e-6 and 3.7e-6 L1, a gap of 4.5e-5 between them on a lane with
    L1 = 9.3 and eps = -0.10; after 3 steps 2.2e-6).  The two packages
    stay within 2e-4 |eps| + 2e-5 + 1e-5 L1 of each other at every step,
    so the gap does not grow beyond rounding."""
    js, ts, Replay, from_jax = _samplers(kind, seed, jacobi_blocks=1)
    assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad, ts.Npad) == \
        (js.jacobi, js.B, js.jacobi_layout, js.Mpad, js.Npad) == \
        (1, B, "row", M, N)
    assert ts.supports_fused_chains and js.supports_fused_chains
    if fused:
        C = 3
        keys = jax.random.split(jax.random.PRNGKey(key), C)
        rv = JaxSerialChainReplay([Replay(k) for k in keys])
        jst, tst = jax.vmap(js.init)(keys), ts.init(rv, chains=C)
        step_j, step_t = js.step_chains, ts.step_chains
    else:
        jkey = jax.random.PRNGKey(key)
        rv = Replay(jkey)
        jst, tst = js.init(jkey), ts.init(rv)
        step_j, step_t = js.step, ts.step
    # the sweep's operands of each step, to rerun it in float64
    model = tbayesr if kind == "bayesr" else thorseshoe
    name = f"{kind}_sweep" + ("_mc" if fused else "")
    sweep = getattr(model, name)
    calls = []

    def recorded(*a, **kw):
        calls.append((a, kw))
        return sweep(*a, **kw)

    monkeypatch.setattr(model, name, recorded)
    for it in range(3):
        beta0 = tst.beta
        jst = step_j(jst)
        tst = step_t(tst, rv)
        j = {k: np.asarray(v) for k, v in jst._asdict().items()}
        if "labels" in j:
            np.testing.assert_array_equal(j["labels"], tst.labels.numpy())
        np.testing.assert_allclose(j["beta"], tst.beta.numpy(), rtol=2e-4,
                                   atol=2e-6)
        for field in ("mu", "sigmaE", "sigmaGG", "pi", "lam", "v", "tau",
                      "eta", "c2"):
            if field in j:
                np.testing.assert_allclose(
                    j[field], getattr(tst, field).numpy(),
                    rtol=4e-4 if field in ("lam", "v") else 2e-4,
                    err_msg=field)
        assert np.all(j["iteration"] == tst.iteration)
        l1 = _update_l1(ts, beta0, tst.beta).numpy()
        a, kw = calls[it]
        out64 = sweep(*map(_as_f64, a),
                      **{k: _as_f64(v) for k, v in kw.items()})
        e64 = out64[0].numpy()
        e_port = tst.eps.double().numpy()
        e_jax = unpermute_eps(j["eps"], ts.Npad)
        assert np.all(np.abs(e_port - e64) <= 2e-6 + L1_TOL_F64 * l1)
        if it == 0:
            assert np.all(np.abs(e_jax - e64) <= 2e-6 + L1_TOL_F64 * l1)
        assert np.all(np.abs(e_jax - e_port) <= 2e-4 * np.abs(e_port) + 2e-5
                      + L1_TOL_PORT_JAX * l1)
    if fused:
        assert not torch.equal(tst.beta[0], tst.beta[1])
    carried = from_jax({k: np.array(v) for k, v in jst._asdict().items()}, ts)
    torch.testing.assert_close(carried.eps, tst.eps, rtol=2e-4, atol=2e-5)
    ex = ts.refresh_eps(tst)
    rel = torch.linalg.norm(tst.eps - ex.eps, dim=-1) / torch.linalg.norm(
        ex.eps, dim=-1)
    assert float(rel.max()) < 1e-5


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_auto_plan_below_2048_markers_is_serial_in_both(kind):
    """M < 2048 has no transposed plan: both packages fall back to J=1,
    which the port now runs (the serial sweep) instead of raising; an
    explicit J=1 in the "t" layout runs it too."""
    js, ts, _, _ = _samplers(kind, 43)
    assert (ts.jacobi, ts.B, ts.jacobi_layout, ts.Mpad) == \
        (js.jacobi, js.B, js.jacobi_layout, js.Mpad)
    assert ts.jacobi == 1 and ts.jacobi_layout == "row"
    _, tt, _, _ = _samplers(kind, 43, jacobi_blocks=1, jacobi_layout="t")
    assert (tt.jacobi, tt.jacobi_layout) == (1, "t")
    st, out = tt.run(torch.Generator().manual_seed(1),
                     ChainConfig(3, 1, 1))
    assert np.isfinite(out["beta"]).all() and st.iteration == 3
