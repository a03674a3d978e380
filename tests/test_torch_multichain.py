"""The port's fused multi-chain runs (``run_chains``, ``step_chains``, the
mc sweeps of bayesrrcpp_tpu_torch/ops/jacobi_t.py, ``ChainFanoutSink``,
``utils/summary``) against the JAX package, on the CPU.

- The mc sweeps' plain versions against JAX ``bayesr_jacobi_t_pallas_mc`` /
  ``horseshoe_jacobi_t_pallas_mc`` run in interpret mode on the same packed
  words, warm per-chain states and variates: C=3 reaches JAX's C <= 4
  kernel, C=6 its wide mc8 kernel.  Labels and v exact, floats at the JAX
  multi-chain tests' rtol 3e-4 (tests/test_jacobi_t.py:455-460).
- Three replayed ``step_chains`` of each sampler against JAX
  ``step_chains``: chain c replays JAX chain c's key (``jax.vmap`` of a
  draw gives the per-key bits), the shared visit order is chain 0's
  (``korder[0]``), and the state carries across through the chain-batched
  ``convert`` functions.  Tolerances as tests/test_torch_bayesr.py's.
- The unfused path on dense X (each chain its own orders) against JAX's
  vmapped single-chain step; ``fused=True`` on dense X raises.
- ``run_chains`` output shapes and the per-chain CSVs of
  ``ChainFanoutSink`` byte for byte against JAX's sink on the same rows.
- ``utils/summary`` against the JAX module on the same arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu.io import sink as jsink
from bayesrrcpp_tpu.ops import block_sweep as jbs
from bayesrrcpp_tpu.ops import genotypes as jgen
from bayesrrcpp_tpu.ops.pallas_jacobi_t import (bayesr_jacobi_t_pallas_mc,
                                                horseshoe_jacobi_t_pallas_mc)
from bayesrrcpp_tpu.utils import summary as jsummary
from bayesrrcpp_tpu_torch import (BayesRConfig, ChainConfig, HorseshoeConfig,
                                  HorseshoeSampler, SpikeSlabSampler,
                                  TorchVariates)
from bayesrrcpp_tpu_torch.convert import (data_from_jax,
                                          horseshoe_data_from_jax,
                                          horseshoe_state_from_jax,
                                          state_from_jax, unpermute_eps)
from bayesrrcpp_tpu_torch.io import sink as tsink
from bayesrrcpp_tpu_torch.ops.jacobi_t import (
    bayesr_jacobi_t_mc, bayesr_jacobi_t_reference, horseshoe_jacobi_t_mc,
    horseshoe_jacobi_t_reference)
from bayesrrcpp_tpu_torch.utils import summary as tsummary
from tests.test_torch_bayesr import JaxReplayVariates
from tests.test_torch_horseshoe import JaxHorseshoeReplayVariates

CVA = np.array([0.001, 0.01, 0.1])
# the JAX multi-chain tests' shape (tests/test_jacobi_t.py:433-460): N pads
# to 2048 lanes, M = 96 markers in nb=6 blocks of B=16, J=3 -> 2 rounds
N, M, B, J = 150, 96, 16, 3


class JaxChainReplay:
    """Chain-batched replay of the JAX samplers' draws from per-chain
    single-chain replays: every role stacks the chains' draws (tensor
    arguments are split by chain), except ``orders``, which is chain 0's,
    as JAX's ``_mc_step_impl`` takes ``korder[0]``.  ``for_chain(c)`` is
    chain c's own replay (JAX's vmapped single-chain step)."""

    def __init__(self, singles):
        self.singles = singles

    def for_chain(self, c):
        return self.singles[c]

    def begin_step(self):
        for s in self.singles:
            s.begin_step()

    def orders(self, nb, B, J):
        return self.singles[0].orders(nb, B, J)

    def __getattr__(self, name):
        def role(*args):
            per = [getattr(s, name)(*(a[c] if isinstance(a, torch.Tensor)
                                      else a for a in args))
                   for c, s in enumerate(self.singles)]
            if isinstance(per[0], tuple):
                return tuple(torch.stack(x) for x in zip(*per))
            return torch.stack(per)
        return role


class JaxBayesRReplayVariates(JaxReplayVariates):
    """``JaxReplayVariates`` plus the dense blocked sweep's orders, drawn
    from the same key as the strided ones (models/bayesr.py:619)."""

    def block_orders(self, nb, B):
        border, inner = jbs.block_orders(self.keys[4], nb, B)
        return (torch.as_tensor(np.array(border)),
                torch.as_tensor(np.array(inner)))


def _dosage(seed):
    rng = np.random.default_rng(seed)
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(
        float)
    beta_t = np.where(rng.random(M) < 0.15, rng.normal(0, 0.3, M), 0.0)
    X = (dosage - dosage.mean(0)) / dosage.std(0, ddof=1)
    return dosage, X, X @ beta_t + rng.normal(0, 0.8, N)


# ------------------------------------------------------------ the sweeps


def _sweep_case(seed, C):
    """Packed words (the JAX host packer), a warm per-chain state and
    variates, all numpy; eps in individual order and in JAX's order."""
    rng = np.random.default_rng(seed)
    dosage, _, _ = _dosage(seed)
    q = jgen.quantize_packed(dosage, False, None, B, M, N, prepacked=False)
    Npad = q.Npad
    eps = np.zeros((C, Npad), np.float32)
    eps[:, :N] = rng.standard_normal((C, N))
    beta = np.zeros((C, M), np.float32)
    labels = np.zeros((C, M), np.int32)
    for c in range(C):
        hot = rng.choice(M, M // 8, replace=False)
        labels[c, hot] = rng.integers(1, 4, hot.size)
        beta[c, hot] = rng.normal(0, 0.05, hot.size)
    nb = M // B
    return dict(
        q=q, Npad=Npad, eps=eps, eps_perm=eps[:, np.asarray(q.n_perm)],
        beta=beta, labels=labels,
        rho=rng.permutation(nb // J).astype(np.int32),
        inner=np.argsort(rng.random((nb, B)), axis=1).astype(np.int32),
        p=rng.random((C, M)).astype(np.float32),
        z=rng.standard_normal((C, M)).astype(np.float32),
        pi=rng.dirichlet([5, 2, 2, 1], (C, 1)).astype(np.float32),
        cva=CVA[None].astype(np.float32),
        sigmaE=rng.uniform(0.5, 1.0, C).astype(np.float32),
        sigmaGG=rng.uniform(0.02, 0.08, (C, 1)).astype(np.float32),
        lam=rng.uniform(0.1, 2.0, (C, M)).astype(np.float32),
        tau=rng.uniform(0.01, 0.1, C).astype(np.float32),
        c2=rng.uniform(1.0, 2.0, C).astype(np.float32),
        gas=np.zeros(M, np.int32), valid=np.arange(M) < M - 3)


def _port_kw(c):
    q = c["q"]
    return dict(J=J, x_mean=torch.as_tensor(np.array(q.x_mean)),
                x_scale=torch.as_tensor(np.array(q.x_scale)),
                x_xsum=torch.as_tensor(np.array(q.x_colsum)),
                fold_affine=True, row_valid=torch.arange(c["Npad"]) < N)


def _port_data(c):
    q = c["q"]
    return [torch.as_tensor(np.array(x)) for x in (q.XT, q.gram, q.xsq)]


@pytest.mark.parametrize("C", [3, 6])
def test_bayesr_mc_plain_matches_jax_kernel(C):
    c = _sweep_case(10 + C, C)
    t = torch.as_tensor
    q = c["q"]
    before = bayesr_jacobi_t_mc.launches
    args = (t(c["beta"]), t(c["labels"]), t(c["rho"]), t(c["inner"]),
            t(c["p"]), t(c["z"]), t(c["pi"]), t(c["cva"]), t(c["sigmaE"]),
            t(c["sigmaGG"]), t(c["gas"]), t(c["valid"]))
    out = bayesr_jacobi_t_mc(*_port_data(c), t(c["eps"]), *args,
                             **_port_kw(c))
    assert bayesr_jacobi_t_mc.launches == before    # CPU: the plain version
    assert (out.eps[:, N:] == 0).all()
    a = jnp.asarray
    ker = bayesr_jacobi_t_pallas_mc(
        q.XT, q.gram, q.xsq, a(c["eps_perm"]), a(c["beta"]), a(c["labels"]),
        a(c["rho"]), a(c["inner"]), a(c["p"]), a(c["z"]), a(c["pi"]),
        a(c["cva"]), a(c["sigmaE"]), a(c["sigmaGG"]), a(c["gas"]),
        a(c["valid"]), J=J, interpret=True, x_mean=q.x_mean,
        x_scale=q.x_scale, x_xsum=q.x_colsum, fold_affine=True,
        row_valid=q.row_valid)
    np.testing.assert_array_equal(np.asarray(ker.labels), out.labels.numpy())
    np.testing.assert_array_equal(np.asarray(ker.v), out.v.numpy())
    np.testing.assert_allclose(np.asarray(ker.beta), out.beta.numpy(),
                               rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(unpermute_eps(np.asarray(ker.eps), c["Npad"]),
                               out.eps.numpy(), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(np.asarray(ker.beta_acum),
                               out.beta_acum.numpy(), rtol=3e-4, atol=1e-6)
    # and chain by chain against the single-chain plain version
    for ch in range(C):
        one = bayesr_jacobi_t_reference(
            *_port_data(c), t(c["eps"][ch]),
            *[x[ch] if k in (0, 1, 4, 5, 6, 8, 9) else x
              for k, x in enumerate(args)], **_port_kw(c))
        assert torch.equal(one.labels, out.labels[ch])
        assert torch.equal(one.v, out.v[ch])
        torch.testing.assert_close(one.beta, out.beta[ch], rtol=1e-5,
                                   atol=1e-7)
        torch.testing.assert_close(one.eps, out.eps[ch], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("C", [3, 6])
def test_horseshoe_mc_plain_matches_jax_kernel(C):
    c = _sweep_case(20 + C, C)
    t = torch.as_tensor
    q = c["q"]
    before = horseshoe_jacobi_t_mc.launches
    args = (t(c["beta"]), t(c["rho"]), t(c["inner"]), t(c["z"]),
            t(c["lam"]), t(c["tau"]), t(c["c2"]), t(c["sigmaE"]),
            t(c["valid"]))
    eps, beta = horseshoe_jacobi_t_mc(*_port_data(c), t(c["eps"]), *args,
                                      **_port_kw(c))
    assert horseshoe_jacobi_t_mc.launches == before
    assert (eps[:, N:] == 0).all()
    a = jnp.asarray
    e_k, b_k = horseshoe_jacobi_t_pallas_mc(
        q.XT, q.gram, q.xsq, a(c["eps_perm"]), a(c["beta"]), a(c["rho"]),
        a(c["inner"]), a(c["z"]), a(c["lam"]), a(c["tau"]), a(c["c2"]),
        a(c["sigmaE"]), a(c["valid"]), J=J, interpret=True,
        x_mean=q.x_mean, x_scale=q.x_scale, x_xsum=q.x_colsum,
        fold_affine=True, row_valid=q.row_valid)
    np.testing.assert_allclose(np.asarray(b_k), beta.numpy(), rtol=3e-4,
                               atol=3e-6)
    np.testing.assert_allclose(unpermute_eps(np.asarray(e_k), c["Npad"]),
                               eps.numpy(), rtol=3e-4, atol=3e-5)
    for ch in range(C):
        e1, b1 = horseshoe_jacobi_t_reference(
            *_port_data(c), t(c["eps"][ch]),
            *[x[ch] if k in (0, 3, 4, 5, 6, 7) else x
              for k, x in enumerate(args)], **_port_kw(c))
        torch.testing.assert_close(b1, beta[ch], rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(e1, eps[ch], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["dense"])
def test_mc_modes_outside_the_slice_raise(bad):
    """Dense rows run fused (tests/test_torch_dense.py); int8 codes of the
    same dosages run fused too (sites #3/#4, ported) and equal the packed
    fused sweep: labels and v exact, floats to rtol 3e-4 / atol 3e-5 as
    the packed tests here (the packed sums run over the pad lanes too)."""
    from bayesrrcpp_tpu_torch.ops import genotypes

    c = _sweep_case(3, 2)
    t = torch.as_tensor
    words, gram, xsq = _port_data(c)
    kw = _port_kw(c)
    codes = genotypes.decode_codes(words)[:, :N].to(torch.int8)
    kw8 = {k: v for k, v in kw.items() if k != "row_valid"}
    eps, eps8 = t(c["eps"]), t(c["eps"])[:, :N].contiguous()
    bayesr = (t(c["beta"]), t(c["labels"]), t(c["rho"]), t(c["inner"]),
              t(c["p"]), t(c["z"]), t(c["pi"]), t(c["cva"]), t(c["sigmaE"]),
              t(c["sigmaGG"]), t(c["gas"]), t(c["valid"]))
    hs = (t(c["beta"]), t(c["rho"]), t(c["inner"]), t(c["z"]), t(c["lam"]),
          t(c["tau"]), t(c["c2"]), t(c["sigmaE"]), t(c["valid"]))
    for fn, args in ((bayesr_jacobi_t_mc, bayesr),
                     (horseshoe_jacobi_t_mc, hs)):
        ref = fn(words, gram, xsq, eps, *args, **kw)
        out = fn(codes, gram, xsq, eps8, *args, **kw8)
        for i, (a, b) in enumerate(zip(ref, out)):
            if i == 0:
                a = a[:, :N]
            if a.dtype == torch.int32 or i == 3 and fn is bayesr_jacobi_t_mc:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(b, a, rtol=3e-4, atol=3e-5)


# ------------------------------------------------------------ the samplers


def _samplers(kind, seed, packed=True):
    dosage, X, Y = _dosage(seed)
    kw = (dict(x_dtype="2bit", jacobi_blocks=J, jacobi_layout="t")
          if packed else {})
    data = dosage if packed else X
    if kind == "bayesr":
        js = jbr.SpikeSlabSampler(data, Y, CVA,
                                  jbr.BayesRConfig(block_size=B),
                                  dtype=jnp.float32, **kw)
        ts = SpikeSlabSampler(data, Y, CVA, BayesRConfig(block_size=B),
                              device="cpu", **kw)
        if packed:
            ts.data = data_from_jax(
                {k: np.array(v) for k, v in js.data._asdict().items()}, N=N,
                device="cpu")
        return js, ts, JaxBayesRReplayVariates, state_from_jax
    js = jbr.HorseshoeSampler(data, Y, jbr.HorseshoeConfig(block_size=B),
                              dtype=jnp.float32, **kw)
    ts = HorseshoeSampler(data, Y, HorseshoeConfig(block_size=B),
                          device="cpu", **kw)
    if packed:
        ts.data = horseshoe_data_from_jax(
            {k: np.array(v) for k, v in js.data._asdict().items()}, N=N,
            device="cpu")
    return js, ts, JaxHorseshoeReplayVariates, horseshoe_state_from_jax


def _assert_chains_close(jst, tst, ts):
    js_np = {k: np.asarray(v) for k, v in jst._asdict().items()}
    eps = js_np["eps"]
    if ts.x_packed:
        eps = unpermute_eps(eps, ts.Npad)
    np.testing.assert_allclose(eps, tst.eps.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(js_np["beta"], tst.beta.numpy(), rtol=2e-4,
                               atol=2e-6)
    if "labels" in js_np:
        np.testing.assert_array_equal(js_np["labels"], tst.labels.numpy())
    for name in ("mu", "sigmaE", "sigmaGG", "pi", "lam", "v", "tau", "eta",
                 "c2"):
        if name in js_np:
            np.testing.assert_allclose(js_np[name],
                                       getattr(tst, name).numpy(),
                                       rtol=2e-4, err_msg=name)
    assert np.all(js_np["iteration"] == tst.iteration)


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_step_chains_match_jax_with_replayed_variates(kind):
    C = 3
    js, ts, Replay, from_jax = _samplers(kind, 31, packed=True)
    assert ts.supports_fused_chains and js.supports_fused_chains
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    rv = JaxChainReplay([Replay(k) for k in keys])
    jst = jax.vmap(js.init)(keys)
    tst = ts.init(rv, chains=C)
    assert tst.beta.shape == (C, ts.Mpad) and tst.eps.shape == (C, ts.Npad)
    _assert_chains_close(jst, tst, ts)
    for _ in range(3):
        jst = js.step_chains(jst)
        tst = ts.step_chains(tst, rv)
        _assert_chains_close(jst, tst, ts)
    # the chains differ from each other
    assert not torch.equal(tst.beta[0], tst.beta[1])
    # the chain-batched JAX state carried across continues identically
    carried = from_jax({k: np.array(v) for k, v in jst._asdict().items()}, ts)
    assert carried.iteration == tst.iteration == 3
    torch.testing.assert_close(carried.eps, tst.eps, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(carried.beta, tst.beta, rtol=2e-4, atol=2e-6)
    ex = ts.refresh_eps(tst)
    rel = torch.linalg.norm(tst.eps - ex.eps, dim=1) / torch.linalg.norm(
        ex.eps, dim=1)
    assert float(rel.max()) < 1e-5


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_unfused_dense_chains_match_jax_vmapped_step(kind):
    """Dense X: no fused kernel, so ``run_chains`` steps each chain with
    its own variates (and orders), as JAX's vmapped fallback; two steps
    against ``jax.vmap(_step_impl)``."""
    C = 2
    js, ts, Replay, _ = _samplers(kind, 41, packed=False)
    assert not ts.supports_fused_chains and not js.supports_fused_chains
    with pytest.raises(ValueError, match="fused"):
        ts.run_chains(torch.Generator().manual_seed(0), C,
                      ChainConfig(4, 2), fused=True)
    with pytest.raises(ValueError, match="fused"):
        ts.step_chains(ts.init(torch.Generator(), chains=C),
                       torch.Generator())
    keys = jax.random.split(jax.random.PRNGKey(6), C)
    rv = JaxChainReplay([Replay(k) for k in keys])
    jst = jax.vmap(js.init)(keys)
    tst = ts.init(rv, chains=C)
    vstep = jax.vmap(js._step_impl, in_axes=(0, None))
    for _ in range(2):
        jst = vstep(jst, js.data)
        tst = ts._step_unfused(tst, rv)
        _assert_chains_close(jst, tst, ts)


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_run_chains_shapes_and_fanout_csv_match_jax(tmp_path, kind):
    C = 3
    _, ts, _, _ = _samplers(kind, 51, packed=True)
    schema = "bayesr" if kind == "bayesr" else "horseshoe"
    chain = ChainConfig(6, 2, 2)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    sink = tsink.ChainFanoutSink.csv(str(tmp_path / "port" / "run.csv"), C,
                                     schema, M=M, N=N)
    try:
        st, out = ts.run_chains(torch.Generator().manual_seed(3), C, chain,
                                sink=sink)
    finally:
        sink.close()
    n = len(list(chain.emit_iterations()))
    assert st.iteration == 6 and st.beta.shape == (C, ts.Mpad)
    assert out["iteration"].shape == (n, C)
    assert (out["iteration"] == np.array(list(chain.emit_iterations())
                                         )[:, None]).all()
    assert out["beta"].shape == (n, C, M)
    assert out["epsilon"].shape == (n, C, N)
    assert out["sigmaE"].shape == (n, C)
    block = "comp" if kind == "bayesr" else "lambda"
    assert out[block].shape == (n, C, M)
    assert all(np.isfinite(np.asarray(v, np.float64)).all()
               for v in out.values())
    assert not np.array_equal(out["beta"][:, 0], out["beta"][:, 1])
    jfan = jsink.ChainFanoutSink.csv(str(tmp_path / "jax" / "run.csv"), C,
                                     schema, M=M, N=N)
    jfan.write(out)
    jfan.close()
    names = [f"run.chain{c}.csv" for c in range(C)]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    assert [p.split("/")[-1] for p in sink.paths] == names
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


def test_fanout_path_without_extension(tmp_path):
    fan = tsink.ChainFanoutSink.csv(str(tmp_path / "chains"), 2, "bayesr",
                                    M=2, N=1)
    fan.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "chains.chain0.csv", "chains.chain1.csv"]


def test_chain_variates_shapes_and_shared_orders():
    C, n = 4, 64
    v = TorchVariates(torch.Generator().manual_seed(1), chains=C)
    assert v.mu_noise().shape == (C,)
    assert v.p(n).shape == v.z(n).shape == (C, n)
    for alpha in (0.5, 1.0, 1.5, 0.7):                 # every gamma branch
        assert v.local_gamma(alpha, n).shape == (C, n)
    assert v.sigmaE_gamma(3.0).shape == v.tau_gamma(2.0).shape == (C,)
    assert v.init_sigmaGG(2).shape == (C, 2)
    assert v.pi_gamma(torch.ones(C, 1, 4)).shape == (C, 1, 4)
    rho, inner = v.orders(12, 8, 3)
    assert rho.shape == (4,) and inner.shape == (12, 8)
    z = v.z(n)
    assert not torch.equal(z[0], z[1])                  # independent chains
    one = v.for_chain(2)
    assert one.generator is v.generator and one.mu_noise().shape == ()


# ------------------------------------------------------------ summary


def _draws(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("fn", ["split_rhat", "ess"])
@pytest.mark.parametrize("shape", [(40, 4), (41, 3, 5)])
def test_chain_diagnostics_match_jax(fn, shape):
    x = _draws(len(shape), shape)
    x[:, 0] += 0.3                  # one chain off: R-hat above 1
    np.testing.assert_array_equal(getattr(tsummary, fn)(x),
                                  getattr(jsummary, fn)(x))


@pytest.mark.parametrize("fn", ["posterior_means", "heritability_samples",
                                "inclusion_probabilities", "pve",
                                "predict"])
def test_summaries_match_jax(fn):
    rng = np.random.default_rng(9)
    samples = {"iteration": np.arange(5), "mu": rng.normal(size=5),
               "beta": rng.normal(size=(5, 7)),
               "sigmaE": rng.uniform(0.5, 1, 5),
               "sigmaG": rng.uniform(0.1, 0.3, 5),
               "comp": rng.integers(0, 4, (5, 7))}
    X, Y = rng.normal(size=(6, 7)), rng.normal(size=6)
    args = {"pve": (samples, X, Y), "predict": (samples, X)}.get(
        fn, (samples,))
    a, b = getattr(tsummary, fn)(*args), getattr(jsummary, fn)(*args)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)
