"""The sharded samplers' individual axis and split sweep
(``parallel/sharded.py``) against JAX's on the CPU.

Both samplers, ``ShardedSpikeSlabSampler`` and ``ShardedHorseshoeSampler``,
on dense standardized rows of N=1001 individuals (Dn = 2 pads them to
1002: a pad row in the second n-slice) and M=512 markers in blocks of 32,
``chunk_blocks=4`` (the split sweep's rounds of J=4 blocks):

- the split sweep on a (1, 1) mesh (``split_sweep=True``), here;
- (1, 2) and (2, 2) meshes, the kernels' backend (the split sweep: r
  all-reduced over "n", the round solves #13 / #14, eps's update over
  "m") and ``backend="xla"``, as four spawned gloo ranks
  (tests/torch_sharded_child.py, one spawn for every case; a (1, 2) case
  runs on each half of them), JAX on its virtual CPU devices.

JAX's data and init state carry across (``convert.sharded_*_from_jax``,
each rank its (m, n) slice), and each rank replays three JAX steps with
JAX's draws for its m-slice.  Each rank's beta / labels (lambda, v) slice
and eps n-slice, and the replicated scalars, are held to JAX's with
tests/test_torch_sharded.py's tolerances (labels exact, beta rtol 2e-4 /
atol 2e-6, eps rtol 2e-4 / atol 2e-5, scalars rtol 1e-4; the horseshoe's
auxiliaries rtol 2e-4); the replicated scalars are bitwise equal on every
rank, and the eps n-slices on the ranks of an "m" group.  Also what the
port refuses, as JAX does: quantized X on Dn > 1 and with the split
sweep, and ``step_chains`` on Dn > 1; groups now build and step
(tests/test_torch_groups_sharded.py holds them to JAX).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu import BayesRConfig as JBConfig
from bayesrrcpp_tpu import HorseshoeConfig as JHConfig
from bayesrrcpp_tpu.parallel.mesh import make_mesh as jmesh
from bayesrrcpp_tpu.parallel.sharded import (
    ShardedHorseshoeSampler as JHorseshoe,
    ShardedSpikeSlabSampler as JBayesR)
from bayesrrcpp_tpu_torch import BayesRConfig, ChainConfig
from bayesrrcpp_tpu_torch.parallel import ShardedSpikeSlabSampler, make_mesh
from bayesrrcpp_tpu_torch.parallel.mesh import Mesh
from tests.torch_sharded_child import (finish_ranks, in_threads, np_state,
                                       port_sampler, replay_steps,
                                       start_ranks)

CVA = np.array([0.001, 0.01, 0.1])
N, M, STEPS, CHUNK = 1001, 512, 3, 4
WORLD = 4


def _data(seed=61):
    rng = np.random.default_rng(seed)
    dosage = rng.binomial(2, rng.uniform(0.2, 0.8, M), size=(N, M))
    X = (dosage - dosage.mean(0)) / dosage.std(0, ddof=1)
    bt = np.zeros(M)
    bt[rng.choice(M, 30, replace=False)] = rng.normal(0, 0.25, 30)
    return X.astype(np.float32), X @ bt + rng.normal(0, 0.7, N)


def jax_case(kind, backend, mesh, split_sweep=None, seed=5):
    """JAX's sampler ("bayesr" or "horseshoe") on an (m, n) mesh: the case
    handed to the port, and a function stepping JAX's sampler."""
    X, Y = _data()
    kw = dict(backend=backend, chunk_blocks=CHUNK, dtype=jnp.float32,
              split_sweep=split_sweep)
    if kind == "bayesr":
        js = JBayesR(X, Y, CVA, JBConfig(block_size=32), jmesh(*mesh), **kw)
        data = js.data._asdict()
    else:
        js = JHorseshoe(X, Y, JHConfig(block_size=32), jmesh(*mesh), **kw)
        data = js.data
    key = jax.random.PRNGKey(seed)
    st = js.init(key)
    case = dict(kind=kind, X=X, Y=Y, cva=CVA, block_size=32, backend=backend,
                x_dtype="dense", chunk_blocks=CHUNK, split_sweep=split_sweep,
                chains=None, steps=STEPS, key=np.asarray(key), mesh=mesh,
                jax_data={k: np.array(v) for k, v in data.items()},
                jax_init=np_state(st))

    def states():
        out, s = [], st
        for _ in range(STEPS):
            s = js.step(s)
            out.append(np_state(s))
        return out

    return case, states, (js.B, js.Mpad, js.Mloc, js.Npad)


SCALARS = {"bayesr": ("mu", "sigmaE", "sigmaGG", "pi"),
           "horseshoe": ("mu", "sigmaE", "tau", "eta", "c2")}


def assert_slice_close(kind, js, ts, m_range, n_range):
    lo, hi = m_range
    if kind == "bayesr":
        np.testing.assert_array_equal(js["labels"][lo:hi], ts["labels"])
    else:
        for k in ("lam", "v"):
            np.testing.assert_allclose(js[k][lo:hi], ts[k], rtol=2e-4,
                                       err_msg=k)
    np.testing.assert_allclose(js["beta"][lo:hi], ts["beta"], rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_allclose(js["eps"][n_range[0]:n_range[1]], ts["eps"],
                               rtol=2e-4, atol=2e-5)
    for k in SCALARS[kind][1:]:
        np.testing.assert_allclose(js[k], ts[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(js["mu"], ts["mu"], rtol=1e-4, atol=1e-6)


CASES = {f"{kind}-{backend}-{m}x{n}": (kind, backend, (m, n))
         for (m, n) in ((1, 2), (2, 2)) for kind in ("bayesr", "horseshoe")
         for backend in ("pallas", "xla")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs of every mesh case (stepped while the four ranks replay
    them) and the ranks' replays."""
    cases = in_threads({n: (lambda c=c: jax_case(*c))
                        for n, c in CASES.items()})
    handle = start_ranks([cases[n][0] for n in CASES],
                         str(tmp_path_factory.mktemp("split")), world=WORLD)
    done = in_threads({n: states for n, (_, states, _) in cases.items()})
    cases = {n: (c, done[n], lay) for n, (c, _, lay) in cases.items()}
    ranks = finish_ranks(handle)
    return {n: (cases[n], [r[i] for r in ranks])
            for i, n in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_matches_jax(runs, name):
    (case, jstates, (B, Mpad, Mloc, Npad)), ranks = runs[name]
    kind = case["kind"]
    m, n = case["mesh"]
    Nloc = Npad // n
    for r, res in enumerate(ranks):
        mi, ni = res["at"]
        assert (mi, ni) == ((r % (m * n)) // n, r % n)
        assert res["layout"] == (1, B, Mpad, Mloc)
        for js, ts in zip(jstates, res["states"]):
            assert_slice_close(kind, js, ts, (mi * Mloc, (mi + 1) * Mloc),
                               (ni * Nloc, (ni + 1) * Nloc))
        # the replicated scalars: the same bits on every rank; eps: on the
        # ranks of one "m" group (those of one n index)
        for a, b in zip(ranks[0]["states"], res["states"]):
            for k in SCALARS[kind]:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        same_n = ranks[ni]["states"]
        for a, b in zip(same_n, res["states"]):
            np.testing.assert_array_equal(a["eps"], b["eps"])
    # the pad individual of the last n-slice stays 0
    if N % n:
        assert all(st["eps"][-1] == 0 for st in ranks[n - 1]["states"])


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_split_sweep_on_one_rank_matches_jax(kind):
    """``split_sweep=True`` on a (1, 1) mesh: the round solves on r of
    whole rows, as the card runs the split sweep at full width."""
    case, states, (B, Mpad, Mloc, Npad) = jax_case(kind, "pallas", (1, 1),
                                                  split_sweep=True)
    s, _ = port_sampler(case, make_mesh(1, 1, device="cpu"))
    assert s._split and s.split_blocks() == CHUNK
    assert (s.B, s.Mpad, s.Npad) == (B, Mpad, Npad)
    for js, ts in zip(states(), replay_steps(case, s, STEPS)):
        assert_slice_close(kind, js, ts, (0, Mpad), (0, Npad))
    last = s.init(torch.Generator().manual_seed(0)).replace(
        **{k: torch.as_tensor(v) for k, v in ts.items() if k != "iteration"})
    rel = torch.linalg.norm(last.eps - s.refresh_eps(last).eps) / \
        torch.linalg.norm(last.eps)
    assert float(rel) < 1e-5, float(rel)


@pytest.mark.parametrize("case", ["quantized_n", "quantized_split",
                                  "step_chains_n", "groups"])
def test_refusals(case):
    """What JAX refuses, the port refuses: quantized X on Dn > 1 or with
    the split sweep (sharded.py:242-245), fused chains on Dn > 1 (an
    (m, 1) mesh only, :1074-1080); groups (ported) build and step.  A mesh
    of Dn = 2 is described here without its ranks: the refusals come
    before any collective."""
    X, Y = _data()
    n2 = Mesh(1, 2, 0, 0, None, None, torch.device("cpu"))
    one = make_mesh(1, 1, device="cpu")
    cfg = BayesRConfig(block_size=32)
    if case == "quantized_n":
        for x_dtype in ("2bit", "int8"):
            with pytest.raises(ValueError, match="Dn > 1"):
                ShardedSpikeSlabSampler(np.rint(X + 1), Y, CVA, cfg, n2,
                                        backend="pallas", x_dtype=x_dtype)
    elif case == "quantized_split":
        with pytest.raises(ValueError, match="split sweep"):
            ShardedSpikeSlabSampler(np.rint(X + 1), Y, CVA, cfg, one,
                                    backend="pallas", x_dtype="2bit",
                                    split_sweep=True)
    elif case == "step_chains_n":
        s = ShardedSpikeSlabSampler(X, Y, CVA, cfg, one, backend="pallas",
                                    split_sweep=True)
        # the split sweep on Dn = 1 keeps JAX's fused serial chains
        st = s.step_chains(s.init(torch.Generator().manual_seed(1), 2),
                           torch.Generator().manual_seed(2))
        assert st.beta.shape == (2, s.Mloc)
        s.Dn = 2          # the same sampler as a Dn = 2 rank sees itself
        with pytest.raises(ValueError, match=r"\(m, 1\) mesh"):
            s.step_chains(st, torch.Generator())
        with pytest.raises(ValueError, match=r"\(m, 1\) mesh"):
            s.run_chains(torch.Generator(), 2, ChainConfig(4, 2, 1))
    else:
        # groups are ported (Queue 1 item 6; tests/test_torch_groups_sharded
        # .py holds the split sweep with groups to JAX's): per-group rows
        # and a fixed effect build and step through the split sweep
        from bayesrrcpp_tpu_torch import GroupsConfig

        s = ShardedSpikeSlabSampler(
            X, Y, np.tile(CVA, (2, 1)), GroupsConfig(block_size=32), one,
            g_assign=np.arange(M) % 2, fixed=np.ones((N, 1)),
            backend="pallas", split_sweep=True)
        g = torch.Generator().manual_seed(1)
        st = s.step(s.init(g), g)
        assert (s.variant, st.sigmaGG.shape, st.alpha.shape) == \
            ("groups", (2,), (1,))
        assert bool(torch.isfinite(st.eps).all())


def test_put_global_places_as_jax_specs():
    """``put_global`` on rank (1, 0) of a (2, 2) mesh (described without
    its ranks: placing moves no data between them): P("m") rows, P("m",
    "n") blocks of dense rows, P("n") individual vectors, as JAX's
    NamedSharding places them (sharded.py:382-389, :420)."""
    from bayesrrcpp_tpu_torch.parallel.distributed import put_global
    from bayesrrcpp_tpu_torch.parallel.mesh import AXIS_M, AXIS_N

    mesh = Mesh(2, 2, 1, 0, None, None, torch.device("cpu"))
    X = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    np.testing.assert_array_equal(put_global(mesh, X).numpy(), X[4:])
    np.testing.assert_array_equal(
        put_global(mesh, X, spec=(AXIS_M, AXIS_N)).numpy(), X[4:, :3])
    np.testing.assert_array_equal(
        put_global(mesh, torch.as_tensor(X[0]), spec=(AXIS_N,)).numpy(),
        X[0, :3])
    with pytest.raises(ValueError, match="split"):
        put_global(mesh, X[:, :5], spec=(None, AXIS_N))
