"""Warm restart, checkpoint and resume of the port (SURVEY C3:
``SpikeSlabSampler.init_from``, io/checkpoint.py, io/resume.py, the
driver's ``on_chunk``, ``api.BRV2Grstart`` and the CLI's ``resume`` and
``--checkpoint-*``) against the JAX package, on the CPU.

- tests/test_resume.py's cases on the port: the CSV parser's refusals, a
  groups CSV written without residuals resumed with its fixed effects
  (epsilon rebuilt as Y - mu - X beta - F alpha, to the f64 rebuild and to
  JAX's ``state_kwargs_from_csv`` of the same file), the horseshoe CSV
  resume, ``xbeta`` in every storage mode, ``on_chunk`` of ``run_chains``.
- ``init_from`` against JAX's with replayed draws: pi from Dirichlet of the
  per-group label counts + 1 (rtol 1e-6), everything else as given.
- Bitwise resume (tests/test_api.py:92, tests/test_bayesr.py:145): 6
  uninterrupted iterations against 3, ``save_checkpoint``,
  ``load_checkpoint`` into a new sampler object, 3 more: every state field
  and every CSV value equal, for BayesR, the groups variant with fixed
  effects and the horseshoe; a checkpoint taken in ``on_chunk`` (the
  newest state, one chunk ahead of the rows) resumes the chain bitwise;
  a JAX checkpoint is refused.
- tests/test_api.py:44's groups and restart round trip through ``api``,
  headers byte-equal to JAX's ``csv_header`` for every schema, and the
  residual refresh (``eps_refresh_every``) with the fixed-effect term.
- The CLI: ``groups --groups-file --fixed --checkpoint-out``, then
  ``resume --checkpoint`` (the same draws as the API's resume of that
  checkpoint) and ``resume --from-csv``, on dense X.
"""
import os

import jax
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu.io import checkpoint as jckpt
from bayesrrcpp_tpu.io import resume as jresume
from bayesrrcpp_tpu.io.sink import csv_header as j_csv_header
import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu_torch import (BayesRConfig, ChainConfig, GroupsConfig,
                                  HorseshoeConfig, HorseshoeSampler,
                                  SpikeSlabSampler, api, cli, simulate)
from bayesrrcpp_tpu_torch.io.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from bayesrrcpp_tpu_torch.io.resume import (csv_schema,
                                            horseshoe_kwargs_from_csv,
                                            parse_last_row,
                                            state_kwargs_from_csv)
from bayesrrcpp_tpu_torch.io.sink import CSVSink, csv_header
from bayesrrcpp_tpu_torch.models.state import SpikeSlabState
from tests.test_torch_bayesr import JaxReplayVariates

CVA = np.array([0.001, 0.01, 0.1])
CVA2 = np.tile(CVA, (2, 1))


@pytest.fixture(scope="module")
def sim():
    return simulate.simulate_bayesr(seed=11, N=120, M=48, n_causal=6,
                                    h2=0.5, n_groups=2, n_fixed=2)


def _groups_sampler(sim, **cfg):
    return SpikeSlabSampler(sim.X, sim.Y, CVA2, GroupsConfig(block_size=16,
                                                             **cfg),
                            g_assign=sim.g_assign, fixed=sim.fixed,
                            device="cpu")


def _run_csv(tmp_path, sampler, schema, name, chain=None, **sink_kw):
    chain = chain or ChainConfig(max_iterations=12, burn_in=4, thinning=2)
    path = str(tmp_path / name)
    sink = CSVSink(path, schema, M=sampler.M, N=sampler.N, **sink_kw)
    try:
        st, _ = sampler.run(torch.Generator().manual_seed(3), chain,
                            sink=sink, collect=False)
    finally:
        sink.close()
    return path, st


def test_parse_last_row_rejects_index_gaps(tmp_path):
    p = tmp_path / "gap.csv"
    p.write_text("iteration,mu,beta[1],beta[3],sigmaE\n0,0.1,1.0,2.0,0.5\n")
    with pytest.raises(ValueError, match="contiguous"):
        parse_last_row(str(p))
    (tmp_path / "empty.csv").write_text("iteration,mu\n")
    with pytest.raises(ValueError, match="no sample rows"):
        parse_last_row(str(tmp_path / "empty.csv"))


def test_mixture_resume_requires_fixed(tmp_path, sim):
    s = _groups_sampler(sim, emit_epsilon=False)
    path, _ = _run_csv(tmp_path, s, "groups", "g.csv", groups=2, F=s.F,
                       emit_epsilon=False)
    assert csv_schema(path) == "mixture"
    with pytest.raises(ValueError, match="alpha columns"):
        state_kwargs_from_csv(path, X=sim.X, Y=sim.Y)
    kw = state_kwargs_from_csv(path, X=sim.X, Y=sim.Y, fixed=sim.fixed)
    # the residuals include the fixed-effect term; JAX's parser agrees
    eps_direct = (sim.Y - float(kw["mu"]) - sim.X @ kw["beta"]
                  - sim.fixed @ kw["alpha"])
    np.testing.assert_allclose(kw["epsilon"], eps_direct, atol=1e-10)
    jkw = jresume.state_kwargs_from_csv(path, X=sim.X, Y=sim.Y,
                                        fixed=sim.fixed)
    assert sorted(jkw) == sorted(kw)
    for k in kw:
        np.testing.assert_array_equal(jkw[k], kw[k], err_msg=k)
    st = s.init_from(torch.Generator().manual_seed(0), **kw)
    st = s.step(st, torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(st.beta).all())


def test_mixture_resume_wrong_fixed_width(tmp_path, sim):
    s = _groups_sampler(sim, emit_epsilon=False)
    path, _ = _run_csv(tmp_path, s, "groups", "gw.csv", groups=2, F=s.F,
                       emit_epsilon=False)
    with pytest.raises(ValueError, match="columns"):
        state_kwargs_from_csv(path, X=sim.X, Y=sim.Y,
                              fixed=sim.fixed[:, :1])


def test_horseshoe_csv_resume(tmp_path, sim):
    s = HorseshoeSampler(sim.X, sim.Y, HorseshoeConfig(block_size=16),
                         device="cpu")
    path, _ = _run_csv(tmp_path, s, "horseshoe", "h.csv")
    assert csv_schema(path) == "horseshoe"
    row = parse_last_row(path)
    kw = horseshoe_kwargs_from_csv(path)
    st = s.init_from(torch.Generator().manual_seed(7), **kw)
    # the supplied state is taken as it is; eta, v, c2 drawn
    np.testing.assert_allclose(st.beta[:s.M].numpy(), row["beta"],
                               rtol=1e-6)
    np.testing.assert_allclose(st.lam[:s.M].numpy(), row["lambda"],
                               rtol=1e-6)
    np.testing.assert_allclose(float(st.tau), float(row["tau"]), rtol=1e-6)
    np.testing.assert_allclose(st.eps[:s.N].numpy(), row["epsilon"],
                               rtol=1e-6, atol=1e-7)
    assert float(st.eta) > 0 and float(st.c2) > 0
    assert bool((st.v > 0).all())
    st = s.step(st, torch.Generator().manual_seed(8))
    assert bool(torch.isfinite(st.beta).all())


def test_horseshoe_resume_reconstructs_epsilon(tmp_path, sim):
    s = HorseshoeSampler(sim.X, sim.Y, HorseshoeConfig(block_size=16,
                                                       emit_epsilon=False),
                         device="cpu")
    path, _ = _run_csv(tmp_path, s, "horseshoe", "hne.csv",
                       emit_epsilon=False)
    kw = horseshoe_kwargs_from_csv(path, X=sim.X, Y=sim.Y)
    eps_direct = sim.Y - float(kw["mu"]) - sim.X @ kw["beta"]
    np.testing.assert_allclose(kw["epsilon"], eps_direct, atol=1e-10)
    # the xbeta-callable form (what the quantized CLI path uses)
    kw2 = horseshoe_kwargs_from_csv(path, Y=sim.Y, xbeta=s.xbeta)
    np.testing.assert_allclose(kw2["epsilon"], eps_direct, atol=1e-4)


def test_xbeta_matches_dense_across_storage_modes():
    rng = np.random.default_rng(5)
    N, M = 96, 40
    dos = rng.integers(0, 3, size=(N, M)).astype(np.float64)
    beta = rng.normal(size=M)
    mean = dos.mean(axis=0)
    sd = dos.std(axis=0, ddof=1)
    sd[sd == 0] = 1.0
    Xstd = (dos - mean) / sd
    want = Xstd @ beta
    Y = rng.normal(size=N)
    cfg = BayesRConfig(block_size=8)
    for X, kw in ((Xstd, dict(backend="blocked")),
                  (dos, dict(x_dtype="int8")), (dos, dict(x_dtype="2bit"))):
        s = SpikeSlabSampler(X, Y, CVA, cfg, device="cpu", **kw)
        np.testing.assert_allclose(s.xbeta(beta).numpy(), want, rtol=1e-4,
                                   atol=1e-4)


def test_run_chains_on_chunk_called(sim):
    s = SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=16),
                         device="cpu")
    calls = []
    s.run_chains(torch.Generator().manual_seed(0), 2,
                 ChainConfig(max_iterations=8, burn_in=2, thinning=2),
                 fused=False, collect=False, emit_chunk=1,
                 on_chunk=lambda st, done: calls.append(
                     (done, tuple(st.sigmaE.shape), st.iteration)))
    # one call a delivered chunk, with the newest state: one chunk ahead
    assert [c[0] for c in calls] == [1, 2, 3]
    assert all(c[1] == (2,) for c in calls)
    assert [c[2] for c in calls] == [5, 7, 7]


def test_init_from_matches_jax(sim):
    """pi from Dirichlet(v + 1) of the per-group counts (JAX's draws
    replayed), the rest as given; eps in individual order."""
    s = _groups_sampler(sim)
    js = jbr.SpikeSlabSampler(sim.X, sim.Y, CVA2, jbr.GroupsConfig(
        block_size=16), g_assign=sim.g_assign, fixed=sim.fixed,
        dtype=np.float32)
    rng = np.random.default_rng(3)
    kw = dict(mu=0.1, beta=rng.normal(0, 0.1, s.M), sigmaE=0.7,
              sigmaGG=np.array([0.2, 0.3]), epsilon=rng.normal(size=s.N),
              components=rng.integers(0, 4, s.M),
              alpha=np.array([0.3, -0.2]), sigmaF=0.5)
    key = jax.random.PRNGKey(9)
    jst = js.init_from(key, **kw)
    tst = s.init_from(JaxReplayVariates(key), **kw)
    np.testing.assert_allclose(tst.pi.numpy(), np.asarray(jst.pi), rtol=1e-6)
    for k in ("mu", "beta", "labels", "eps", "sigmaE", "sigmaGG", "alpha",
              "sigmaF"):
        np.testing.assert_allclose(getattr(tst, k).numpy(),
                                   np.asarray(getattr(jst, k)), rtol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(tst.pi.sum(-1).numpy(), 1.0, rtol=1e-6)
    with pytest.raises(ValueError, match="length M"):
        s.init_from(torch.Generator(), **dict(kw, beta=kw["beta"][1:]))


def _case(kind, sim, device="cpu"):
    if kind == "bayesr":
        return SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(
            block_size=16), device=device), "bayesr", {}
    if kind == "groups":
        s = _groups_sampler(sim)
        return s, "groups", dict(groups=2, F=s.F)
    return HorseshoeSampler(sim.X, sim.Y, HorseshoeConfig(block_size=16),
                            device=device), "horseshoe", {}


def _rows(path):
    with open(path) as f:
        header = f.readline()
        return header, [r.split(", ") for r in f.read().split("\n") if r]


@pytest.mark.parametrize("kind", ["bayesr", "groups", "horseshoe"])
def test_checkpoint_resume_bitwise(kind, sim, tmp_path):
    """6 iterations straight against 3, a checkpoint, a new sampler object
    loaded from it and 3 more (the resumed chain counts from 0, as the
    CLI's resume): every state field equal, and the CSV rows' values
    (iteration aside) equal."""
    chain = ChainConfig(6, 1, 1)
    s, schema, sink_kw = _case(kind, sim)
    full, st6 = _run_csv(tmp_path, s, schema, "full.csv", chain, **sink_kw)
    half, st3 = _run_csv(tmp_path, s, schema, "a.csv", ChainConfig(3, 1, 1),
                         **sink_kw)
    g = torch.Generator().manual_seed(3)
    s._run_steps(s.init(s.variates(g)), s.variates(g), 3)
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, st3, g)
    s2, _, _ = _case(kind, sim)
    st, g2 = load_checkpoint(ck)
    assert st.iteration == 3 and g2.device.type == "cpu"
    path = str(tmp_path / "b.csv")
    sink = CSVSink(path, schema, M=s2.M, N=s2.N, **sink_kw)
    st, _ = s2.run(g2, ChainConfig(3, 1, 1), state=st.replace(iteration=0),
                   sink=sink, collect=False)
    sink.close()
    for f in st6.__dataclass_fields__:
        if f != "iteration":
            assert torch.equal(getattr(st6, f), getattr(st, f)), f
    hf, rf = _rows(full)
    ha, ra = _rows(half)
    hb, rb = _rows(path)
    assert hf == ha == hb and len(rf) == 5
    assert [r[1:] for r in ra + rb] == [r[1:] for r in rf[:2] + rf[3:]]


def test_checkpoint_in_on_chunk_resumes_bitwise(sim, tmp_path):
    """A checkpoint written in ``on_chunk`` (the newest enqueued state and
    the generator at the same point) continues the chain as the
    uninterrupted run, to the bit; the CLI's periodic saver writes it."""
    s = _groups_sampler(sim)
    chain = ChainConfig(12, 2, 2)
    g = torch.Generator().manual_seed(5)
    ck = str(tmp_path / "mid.npz")
    at = []

    def on_chunk(state, done):
        if done == 1:
            save_checkpoint(ck, state, g)
            at.append(state.iteration)

    full, _ = s.run(g, chain, emit_chunk=2, collect=False,
                    on_chunk=on_chunk)
    st, g2 = load_checkpoint(ck)
    assert st.iteration == at[0] == 7
    st = s._run_steps(st, s.variates(g2), chain.max_iterations - at[0])
    assert st.iteration == full.iteration
    for f in full.__dataclass_fields__:
        if f != "iteration":
            assert torch.equal(getattr(full, f), getattr(st, f)), f


def test_checkpoint_refusals(sim, tmp_path):
    """A JAX checkpoint (its PRNG key, no generator state) is refused and
    says why; so is a generator state of another device type."""
    js = jbr.SpikeSlabSampler(sim.X, sim.Y, CVA, jbr.BayesRConfig(
        block_size=16), dtype=np.float32)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, js.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="JAX checkpoint"):
        load_checkpoint(jpath)
    s = _groups_sampler(sim)
    g = torch.Generator().manual_seed(0)
    path = str(tmp_path / "t.npz")
    save_checkpoint(path, s.init(g), g)
    with pytest.raises(ValueError, match="cpu"):
        load_checkpoint(path, device="cuda")
    with pytest.raises(TypeError):
        save_checkpoint(path, object(), g)


@pytest.mark.parametrize("schema", ["bayesr", "groups", "grstart",
                                    "horseshoe"])
@pytest.mark.parametrize("emit_epsilon", [True, False])
def test_csv_headers_match_jax(schema, emit_epsilon):
    assert csv_header(schema, 9, 7, groups=3, F=2,
                      emit_epsilon=emit_epsilon) == \
        j_csv_header(schema, 9, 7, groups=3, F=2, emit_epsilon=emit_epsilon)


def test_groups_and_restart_roundtrip(tmp_path):
    """tests/test_api.py:44 on the port: ``BayesRSamplerV2Groups``, then
    ``BRV2Grstart`` from its final state (no fixed effects there)."""
    sim = simulate.simulate_bayesr(seed=41, N=200, M=80, n_causal=10,
                                   h2=0.5)
    g_assign = np.arange(80) % 2
    fixed = np.random.default_rng(0).normal(size=(200, 2))
    out = str(tmp_path / "c2.csv")
    state = api.BayesRSamplerV2Groups(out, 3, 30, 15, 3, sim.X, sim.Y,
                                      0.01, 0.001, 0.001, 0.001, 0.001,
                                      CVA2 * 100, 2, g_assign, fixed,
                                      block_size=32, device="cpu")
    header, rows = _rows(out)
    assert header == j_csv_header("groups", 80, 200, 2, 2)
    assert header.rstrip().split(",")[-1] == "sigmaF"
    assert all(len(r) == header.count(",") + 1 for r in rows)
    out2 = str(tmp_path / "c3.csv")
    st2 = api.BRV2Grstart(out2, 4, 20, 10, 2, float(state.mu),
                          state.beta[:80].numpy(), float(state.sigmaE),
                          state.sigmaGG.numpy(), sim.X, state.eps.numpy(),
                          state.labels[:80].numpy(), 0.01, 0.001, 0.001,
                          0.001, 0.001, CVA2 * 100, 2, g_assign,
                          block_size=32, device="cpu")
    header3, rows3 = _rows(out2)
    assert header3 == j_csv_header("grstart", 80, 200, 2)
    assert "alpha[1]" not in header3
    assert all(len(r) == header3.count(",") + 1 for r in rows3)
    assert st2.iteration == 20 and bool(torch.isfinite(st2.sigmaGG).all())


def test_refresh_keeps_the_fixed_effect_term(sim):
    """``eps_refresh_every``: the recompute takes alpha F off as JAX's
    (bayesr.py:491-492); the refreshed chain's eps stays Y - mu - X beta -
    F alpha."""
    s = _groups_sampler(sim)
    st, _ = s.run(torch.Generator().manual_seed(2),
                  ChainConfig(10, 2, 2, eps_refresh_every=3), collect=False)
    beta = st.beta[:s.M].double().numpy()
    want = (sim.Y - float(st.mu) - sim.X @ beta
            - sim.fixed @ st.alpha.double().numpy())
    np.testing.assert_allclose(st.eps.numpy(), want, rtol=1e-4, atol=2e-5)
    ref = s.refresh_eps(st)
    np.testing.assert_allclose(ref.eps.numpy(), want, rtol=1e-5, atol=2e-6)


def test_cli_groups_checkpoint_and_resume(tmp_path, sim):
    """``groups --groups-file --fixed --checkpoint-out``, then ``resume
    --checkpoint`` (the draws of ``run`` on the loaded checkpoint, bit for
    bit) and ``resume --from-csv``, on dense X: every CSV's width."""
    x, y, gf, fx = (str(tmp_path / n) for n in ("x.npy", "y.npy", "g.txt",
                                                "f.npy"))
    np.save(x, sim.X)
    np.save(y, sim.Y)
    np.savetxt(gf, sim.g_assign, fmt="%d")
    np.save(fx, sim.fixed)
    common = ["--x", x, "--y", y, "--iterations", "6", "--burn-in", "2",
              "--thinning", "2", "--device", "cpu", "--block-size", "16",
              "--backend", "blocked", "--cva", ",".join(map(str, CVA))]
    ck = str(tmp_path / "ck")
    assert cli.main(["groups", "--groups-file", gf, "--fixed", fx, "--out",
                     str(tmp_path / "g.csv"), "--checkpoint-out", ck,
                     "--checkpoint-every", "1e-9"] + common) == 0
    header, rows = _rows(str(tmp_path / "g.csv"))
    assert header == csv_header("groups", 48, 120, 2, 2)
    assert len(rows) == 2 and all(len(r) == header.count(",") + 1
                                  for r in rows)
    st, g = load_checkpoint(ck + ".npz")
    assert st.iteration == 6 and st.alpha.shape == (2,)
    # resume --checkpoint: the same draws as the API's run of it
    assert cli.main(["resume", "--checkpoint", ck + ".npz", "--groups-file",
                     gf, "--fixed", fx, "--out", str(tmp_path / "r.csv")]
                    + common) == 0
    # the CLI standardizes the .npy's columns again
    X = sim.X - sim.X.mean(axis=0)
    s = SpikeSlabSampler(X / X.std(axis=0, ddof=1), sim.Y, CVA2,
                         GroupsConfig(block_size=16), g_assign=sim.g_assign,
                         fixed=sim.fixed, backend="blocked", device="cpu")
    _, rr = _rows(str(tmp_path / "r.csv"))
    path = str(tmp_path / "api.csv")
    sink = CSVSink(path, "groups", M=s.M, N=s.N, groups=2, F=2)
    s.run(g, ChainConfig(6, 2, 2), state=st.replace(iteration=0), sink=sink,
          collect=False)
    sink.close()
    assert rr == _rows(path)[1]
    # resume --from-csv (pi redrawn, the generator from --seed)
    assert cli.main(["resume", "--from-csv", str(tmp_path / "g.csv"),
                     "--groups-file", gf, "--fixed", fx, "--out",
                     str(tmp_path / "c.csv")] + common) == 0
    header, rows = _rows(str(tmp_path / "c.csv"))
    assert header == csv_header("groups", 48, 120, 2, 2) and len(rows) == 2
    with pytest.raises(SystemExit):
        cli.main(["resume", "--out", str(tmp_path / "z.csv")] + common)
    assert os.path.exists(ck + ".npz")
    assert isinstance(st, SpikeSlabState)
