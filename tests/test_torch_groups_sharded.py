"""The sharded sampler's groups and fixed effects (``parallel/sharded.py``,
``variant="groups"`` with ``g_assign`` and ``fixed``) against JAX's
``ShardedSpikeSlabSampler`` on the CPU, after JAX's
``test_groups_fixed_effects_sharded`` (tests/test_sharded.py:78): G=2
groups (``g_assign = m % 2``) and F=3 fixed effects, three steps replayed
with JAX's draws for each rank's m-slice (tests/torch_sharded_child.py's
``JaxSliceReplay``, the fixed effects' order and normals, sigmaF's gamma
and init's sigmaF with it), each on a path that sums ``bacc`` its own way:

- a (1, 1) mesh in this process, 2-bit words (N=2000, M=4096, the "t"
  plan: the chunk of every round of 2 fused chains, #6);
- (2, 1) and (1, 2) meshes as two spawned gloo ranks: dense rows (N=1001,
  M=512, blocks of 32, ``chunk_blocks=4``) through the serial chunks of
  each m-slice (#9, bacc summed over 4 chunks and over "m") and through
  the split sweep (r and the fixed effects' dots all-reduced over "n",
  the round solves #13 and their ``acc``).

Tolerances are tests/test_torch_sharded.py's: labels exact, beta rtol
2e-4 / atol 2e-6, eps rtol 2e-4 / atol 2e-5, the replicated scalars
(sigmaE, sigmaGG per group, pi, sigmaF, alpha) rtol 1e-4 and mu atol
1e-6; the replicated scalars bitwise equal on both ranks.  On the words'
(1, 1) case eps is held as tests/test_torch_groups.py holds it, to 2e-4
|eps| + 2e-5 + 1e-5 of what the step added to each lane (the fixed
effects' first steps from 0 add terms of ~1 to every lane: with 2 fused
chains, 2 of 4,096 lanes lay 2.8e-5 apart, beyond 2e-4 |eps| + 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu import GroupsConfig as JGroups
from bayesrrcpp_tpu.parallel.mesh import make_mesh as jmesh
from bayesrrcpp_tpu.parallel.sharded import \
    ShardedSpikeSlabSampler as JSharded
from bayesrrcpp_tpu_torch.convert import unpermute_eps
from bayesrrcpp_tpu_torch.parallel import make_mesh
from tests.test_torch_groups import update_l1
from tests.torch_sharded_child import (finish_ranks, in_threads, np_state,
                                       port_sampler, replay_steps,
                                       start_ranks)

CVA = np.array([0.001, 0.01, 0.1])
G, F, STEPS = 2, 3, 3
SCALARS = ("sigmaE", "sigmaGG", "pi", "sigmaF", "alpha")


def _data(N, M, packed, seed=33):
    rng = np.random.default_rng(seed)
    dosage = rng.binomial(2, rng.uniform(0.2, 0.8, M), size=(N, M)).astype(
        float)
    X = (dosage - dosage.mean(0)) / dosage.std(0, ddof=1)
    bt = np.zeros(M)
    bt[rng.choice(M, 30, replace=False)] = rng.normal(0, 0.25, 30)
    fixed = rng.normal(size=(N, F))
    Y = X @ bt + fixed @ rng.normal(0, 0.5, F) + rng.normal(0, 0.7, N)
    return (dosage if packed else X.astype(np.float32)), Y, fixed


def jax_case(mesh, *, packed=False, chains=None, N=1001, M=512,
             chunk_blocks=4, seed=5):
    """JAX's grouped sampler on an (m, n) mesh: the case handed to the
    port and a function stepping JAX's sampler."""
    X, Y, fixed = _data(N, M, packed)
    g_assign = np.arange(M) % G
    cva = np.tile(CVA, (G, 1))
    x_dtype = "2bit" if packed else "dense"
    js = JSharded(X, Y, cva, JGroups(block_size=32), jmesh(*mesh),
                  g_assign=g_assign, fixed=fixed, backend="pallas",
                  x_dtype=x_dtype, chunk_blocks=chunk_blocks,
                  dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    st = js.init(key) if chains is None else js.init_chains(key, chains)
    step = js.step if chains is None else js.step_chains
    case = dict(X=X, Y=Y, cva=cva, g_assign=g_assign, fixed=fixed,
                block_size=32, backend="pallas", x_dtype=x_dtype,
                chunk_blocks=chunk_blocks, split_sweep=None, chains=chains,
                steps=STEPS, key=np.asarray(key), mesh=mesh,
                jax_data={k: np.array(v) for k, v in js.data._asdict().items()},
                jax_init=np_state(st))

    def states():
        out, s = [], st
        for _ in range(STEPS):
            s = step(s)
            out.append(np_state(s))
        return out

    return case, states, (js.Mloc, js.Npad)


def assert_slice_close(js, ts, m_range, n_range, packed, l1=None):
    """``l1``: hold eps as tests/test_torch_groups.py does, to 2e-4 |eps|
    + 2e-5 + 1e-5 of what the step added to each lane."""
    lo, hi = m_range
    np.testing.assert_array_equal(js["labels"][..., lo:hi], ts["labels"])
    np.testing.assert_allclose(js["beta"][..., lo:hi], ts["beta"],
                               rtol=2e-4, atol=2e-6)
    eps = (unpermute_eps(js["eps"], js["eps"].shape[-1]) if packed
           else js["eps"])[..., n_range[0]:n_range[1]]
    if l1 is None:
        np.testing.assert_allclose(eps, ts["eps"], rtol=2e-4, atol=2e-5)
    else:
        assert np.all(np.abs(eps - ts["eps"]) <= 2e-4 * np.abs(ts["eps"])
                      + 2e-5 + 1e-5 * l1)
    for k in SCALARS:
        np.testing.assert_allclose(js[k], ts[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(js["mu"], ts["mu"], rtol=1e-4, atol=1e-6)


MESHES = {"serial-2x1": (2, 1), "split-1x2": (1, 2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs of the two mesh cases (stepped while two gloo ranks
    replay them) and the ranks' replays."""
    cases = in_threads({n: (lambda mesh=mesh: jax_case(mesh))
                        for n, mesh in MESHES.items()})
    handle = start_ranks([cases[n][0] for n in MESHES],
                         str(tmp_path_factory.mktemp("groups")), world=2)
    done = in_threads({n: states for n, (_, states, _) in cases.items()})
    ranks = finish_ranks(handle)
    return {n: (cases[n][0], done[n], cases[n][2], [r[i] for r in ranks])
            for i, n in enumerate(MESHES)}


@pytest.mark.parametrize("name", list(MESHES))
def test_groups_on_two_ranks_match_jax(runs, name):
    case, jstates, (Mloc, Npad), ranks = runs[name]
    m, n = case["mesh"]
    Nloc = Npad // n
    for r, res in enumerate(ranks):
        mi, ni = res["at"]
        assert (mi, ni) == (r // n, r % n)
        for js, ts in zip(jstates, res["states"]):
            assert_slice_close(js, ts, (mi * Mloc, (mi + 1) * Mloc),
                               (ni * Nloc, (ni + 1) * Nloc), False)
        for a, b in zip(ranks[0]["states"], res["states"]):
            for k in SCALARS + ("mu",):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert bool((jstates[-1]["labels"] > 0).any())


@pytest.mark.parametrize("chains", [2])
def test_groups_on_one_slice_match_jax(chains):
    """Words on a (1, 1) mesh: the "t" plan's chunk of every round, 2 fused
    chains (#6), bacc per group from one chunk (the one-chain chunk #5 at
    G=4 is chip_smoke.py 26a's)."""
    case, states, (Mloc, Npad) = jax_case((1, 1), packed=True, chains=chains,
                                          N=2000, M=4096, chunk_blocks=None)
    s, _ = port_sampler(case, make_mesh(1, 1, device="cpu"))
    assert s.strided and (s.variant, s.G, s.F) == ("groups", G, F)
    tstates = replay_steps(case, s, STEPS)
    prev = case["jax_init"]
    for js, ts in zip(states(), tstates):
        l1 = update_l1(s, *(torch.as_tensor(x[k]) for k in ("beta", "alpha")
                            for x in (prev, ts)))
        assert_slice_close(js, ts, (0, Mloc), (0, Npad), True, l1)
        prev = ts
    st = s.init(torch.Generator().manual_seed(0), chains=chains)
    last = st.replace(**{k: torch.as_tensor(v) for k, v in tstates[-1].items()
                         if k != "iteration"})
    exact = s.refresh_eps(last).eps
    rel = torch.linalg.norm(last.eps - exact) / torch.linalg.norm(exact)
    assert float(rel) < 1e-5, float(rel)
