"""float64 in the port (``dtype=torch.float64``) against the JAX package's
``dtype=jnp.float64``, on the CPU.

- Replayed steps: three steps of the port's sampler with the JAX sampler's
  own float64 draws (tests/torch_replay.py) against JAX's, from the same
  key, on dense X (N=300, M=128, B=32): the plain Gram-blocked sweep, the
  literal scan in a full and in the blocked permutation, the groups variant
  with two groups and three fixed effects, and the horseshoe blocked and
  scanned.  Labels exact; floats to rtol 1e-8 / atol 1e-10, JAX's own
  blocked-vs-scan tolerance (tests/test_bayesr.py:31-45): both packages
  compute in float64 and part by reassociation only.
- The kernels under a float64 state: tests/test_torch_f64_pallas.py.
- Checkpoint and resume in float64: the state and generator round-trip
  bitwise, and 2 + 2 resumed steps equal 4 uninterrupted ones bitwise
  (the groups variant with fixed effects, blocked; the horseshoe, scan).
- The sharded samplers' ``backend="xla"`` in float64 against JAX's
  ``Sharded*Sampler(..., dtype=jnp.float64)``, two replayed steps at the
  tolerances above: BayesR on a (1, 1) mesh (here) and a (2, 1) mesh (two
  gloo processes, tests/torch_sharded_child.py), the horseshoe on (1, 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu.parallel.mesh import make_mesh as jmesh
from bayesrrcpp_tpu.parallel.sharded import \
    ShardedHorseshoeSampler as JShardedHorseshoe
from bayesrrcpp_tpu.parallel.sharded import \
    ShardedSpikeSlabSampler as JSharded
from bayesrrcpp_tpu_torch import (BayesRConfig, GroupsConfig,
                                  HorseshoeConfig, HorseshoeSampler,
                                  SpikeSlabSampler, simulate)
from bayesrrcpp_tpu_torch.convert import unpermute_eps
from bayesrrcpp_tpu_torch.io.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from bayesrrcpp_tpu_torch.parallel import make_mesh
from tests.torch_replay import JaxHorseshoeReplay, JaxReplay
from tests.torch_sharded_child import port_sampler, replay_steps, run_ranks

CVA = np.array([0.001, 0.01, 0.1])
F64 = dict(rtol=1e-8, atol=1e-10)
F64_FIELDS = {"bayesr": ("mu", "beta", "eps", "sigmaE", "sigmaGG", "pi",
                         "alpha", "sigmaF"),
              "horseshoe": ("mu", "beta", "eps", "sigmaE", "lam", "v", "tau",
                            "eta", "c2")}


def _sim(seed=5, N=300, M=128, **kw):
    return simulate.simulate_bayesr(seed=seed, N=N, M=M, n_causal=16,
                                    h2=0.5, **kw)


def _pair(kind, X, Y, *, cva=CVA, config=None, jkw=None, **kw):
    """(JAX sampler, port sampler) on the same data and options, float64."""
    jkw = dict(kw, **(jkw or {}))
    if kind == "horseshoe":
        cfg = config or HorseshoeConfig(block_size=32)
        jcfg = jbr.HorseshoeConfig(**dataclasses.asdict(cfg))
        return (jbr.HorseshoeSampler(X, Y, jcfg, dtype=jnp.float64, **jkw),
                HorseshoeSampler(X, Y, cfg, dtype=torch.float64,
                                 device="cpu", **kw))
    cfg = config or BayesRConfig(block_size=32)
    jcfg = (jbr.GroupsConfig if isinstance(cfg, GroupsConfig)
            else jbr.BayesRConfig)(**dataclasses.asdict(cfg))
    return (jbr.SpikeSlabSampler(X, Y, cva, jcfg, dtype=jnp.float64, **jkw),
            SpikeSlabSampler(X, Y, cva, cfg, dtype=torch.float64,
                             device="cpu", **kw))


def _replay(kind, key):
    return (JaxHorseshoeReplay if kind == "horseshoe" else JaxReplay)(key)


def _assert_close(kind, js, ts, sampler, **tol):
    if kind != "horseshoe":
        np.testing.assert_array_equal(np.asarray(js.labels),
                                      ts.labels.numpy())
    for name in F64_FIELDS[kind]:
        j = np.asarray(getattr(js, name))
        if name == "eps" and sampler.x_packed:
            j = unpermute_eps(j, sampler.Npad)
        t = getattr(ts, name)
        assert t.dtype == torch.float64, name
        np.testing.assert_allclose(t.numpy(), j, err_msg=name, **tol)
    assert int(js.iteration) == ts.iteration


STEP_CASES = {
    "blocked": ("bayesr", dict(backend="blocked"), {}),
    "scan-full": ("bayesr", dict(backend="scan"), {}),
    "scan-blocked": ("bayesr", dict(backend="scan", permutation="blocked"),
                     {}),
    "groups-fixed": ("bayesr", dict(backend="blocked"), dict(groups=True)),
    "horseshoe-blocked": ("horseshoe", dict(backend="blocked"), {}),
    "horseshoe-scan": ("horseshoe", dict(backend="scan"), {}),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_f64_steps_match_jax(case):
    kind, kw, extra = STEP_CASES[case]
    if extra.get("groups"):
        sim = _sim(n_groups=2, n_fixed=3)
        js, ts = _pair(kind, sim.X, sim.Y, cva=np.tile(CVA, (2, 1)),
                       config=GroupsConfig(block_size=32),
                       g_assign=sim.g_assign, fixed=sim.fixed, **kw)
        assert (ts.variant, ts.G, ts.F) == ("groups", 2, 3)
    else:
        sim = _sim()
        js, ts = _pair(kind, sim.X, sim.Y, **kw)
    assert ts.permutation == js.permutation
    key = jax.random.PRNGKey(4)
    rv = _replay(kind, key)
    jst, tst = js.init(key), ts.init(rv)
    _assert_close(kind, jst, tst, ts, **F64)
    for _ in range(3):
        jst, tst = js.step(jst), ts.step(tst, rv)
        _assert_close(kind, jst, tst, ts, **F64)


def _same(a, b):
    for k in a.__dataclass_fields__:
        x, y = getattr(a, k), getattr(b, k)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("kind", ["groups", "horseshoe"])
def test_f64_checkpoint_resume_bitwise(kind, tmp_path):
    sim = _sim(n_groups=2, n_fixed=3)
    if kind == "groups":
        s = SpikeSlabSampler(sim.X, sim.Y, np.tile(CVA, (2, 1)),
                             GroupsConfig(block_size=32),
                             g_assign=sim.g_assign, fixed=sim.fixed,
                             dtype=torch.float64, device="cpu")
    else:
        s = HorseshoeSampler(sim.X, sim.Y, HorseshoeConfig(block_size=32),
                             backend="scan", dtype=torch.float64,
                             device="cpu")
    g = torch.Generator().manual_seed(3)
    st = s.init(g)
    for _ in range(2):
        st = s.step(st, g)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, st, g)
    st_r, g_r = load_checkpoint(path)
    _same(st, st_r)
    assert torch.equal(g.get_state(), g_r.get_state())
    for _ in range(2):
        st, st_r = s.step(st, g), s.step(st_r, g_r)
    _same(st, st_r)
    assert st.eps.dtype == torch.float64 and st.iteration == 4


def _sharded_case(Dm, steps=2, M=160, N=240, kind="bayesr"):
    sim = simulate.simulate_bayesr(seed=31, N=N, M=M, n_causal=16, h2=0.5)
    if kind == "horseshoe":
        js = JShardedHorseshoe(sim.X, sim.Y,
                               jbr.HorseshoeConfig(block_size=32),
                               jmesh(Dm, 1), backend="xla",
                               dtype=jnp.float64)
    else:
        js = JSharded(sim.X, sim.Y, CVA, jbr.BayesRConfig(block_size=32),
                      jmesh(Dm, 1), backend="xla", dtype=jnp.float64)
    key = jax.random.PRNGKey(8)
    st = js.init(key)
    init = {k: np.array(v) for k, v in st._asdict().items()}
    states = []
    for _ in range(steps):
        st = js.step(st)
        states.append({k: np.array(v) for k, v in st._asdict().items()})
    case = dict(X=sim.X, Y=sim.Y, cva=CVA, block_size=32, backend="xla",
                x_dtype="dense", chunk_blocks=None, chains=None, steps=steps,
                key=np.asarray(key), dtype="float64",
                jax_data={k: np.array(v) for k, v in (
                    js.data if isinstance(js.data, dict)
                    else js.data._asdict()).items()},
                jax_init=init, mesh=(Dm, 1), kind=kind)
    return case, states, js


def _assert_slice(jstates, tstates, lo, hi, kind="bayesr"):
    """Rank states against JAX's: the slice [lo, hi) of the markers, eps
    whole (an (m, 1) mesh), the replicated scalars."""
    sliced, scalars = (("beta", "lam", "v"), ("mu", "sigmaE", "tau", "eta",
                                              "c2"))
    if kind == "bayesr":
        sliced, scalars = ("beta",), ("mu", "sigmaE", "sigmaGG", "pi")
    for j, t in zip(jstates, tstates):
        if kind == "bayesr":
            np.testing.assert_array_equal(j["labels"][lo:hi], t["labels"])
        for name in sliced:
            np.testing.assert_allclose(t[name], j[name][lo:hi], err_msg=name,
                                       **F64)
        np.testing.assert_allclose(t["eps"], j["eps"][:t["eps"].shape[0]],
                                   **F64)
        for name in scalars:
            assert t[name].dtype == np.float64
            np.testing.assert_allclose(t[name], j[name], err_msg=name, **F64)


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_sharded_xla_f64_one_rank(kind):
    case, jstates, js = _sharded_case(1, kind=kind)
    s, own = port_sampler(case, make_mesh(1, 1, device="cpu"))
    assert s.dtype == own.XT.dtype == torch.float64
    np.testing.assert_allclose(own.XT.numpy(), case["jax_data"]["XT"])
    tstates = replay_steps(case, s, case["steps"])
    _assert_slice(jstates, tstates, 0, s.Mpad, kind)


def test_sharded_xla_f64_two_ranks(tmp_path):
    case, jstates, _ = _sharded_case(2)
    ranks = run_ranks([case], tmp_path, world=2)
    assert sorted(res["at"] for (res,) in ranks) == [(0, 0), (1, 0)]
    for (res,) in ranks:
        m, Mloc = res["at"][0], res["layout"][3]
        _assert_slice(jstates, res["states"], m * Mloc, (m + 1) * Mloc)


@pytest.mark.parametrize("name", ["BayesRSamplerV2", "BayesRSamplerV2Groups",
                                  "BRV2Grstart", "HorseshoeR"])
def test_api_f64_as_jax(name, tmp_path):
    """The four reference entry points with ``dtype=float64``, the port's
    (``device="cpu"``) and JAX's on the same data and positional
    arguments: the same CSV header and row count, a float64 final state."""
    from bayesrrcpp_tpu import api as japi
    from bayesrrcpp_tpu_torch import api as tapi

    sim = _sim(N=60, M=24, n_groups=2, n_fixed=1)
    cva2 = np.tile(CVA, (2, 1))
    hyper = (0.01, 0.001, 0.001, 0.001, 0.001)
    args = {
        "BayesRSamplerV2": (sim.X, sim.Y, *hyper, CVA),
        "BayesRSamplerV2Groups": (sim.X, sim.Y, *hyper, cva2, 2,
                                  sim.g_assign, sim.fixed),
        "BRV2Grstart": (0.1, np.zeros(24), 1.0, np.ones(2), sim.X,
                        np.zeros(60), np.zeros(24), *hyper, cva2, 2,
                        sim.g_assign),
        "HorseshoeR": (sim.X, sim.Y, 0.05, 0.001, 0.001, 1.0, 1.0, 1.0,
                       10.0, 10.0),
    }[name]
    out = {}
    for tag, mod, kw in (("t", tapi, dict(dtype=torch.float64, device="cpu")),
                         ("j", japi, dict(dtype=jnp.float64))):
        path = str(tmp_path / f"{tag}.csv")
        st = getattr(mod, name)(path, 1, 8, 4, 2, *args, block_size=8, **kw)
        with open(path) as f:
            out[tag] = (f.readline(), len(f.read().strip().split("\n")))
        assert np.asarray(st.sigmaE).dtype == np.float64
    assert out["t"] == out["j"] and out["t"][1] == 2
