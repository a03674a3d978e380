"""The port's sharded horseshoe (``parallel.ShardedHorseshoeSampler``)
against JAX's ``ShardedHorseshoeSampler`` on the CPU.

Each case builds both samplers on the same numpy data (N=2000 individuals,
M=512 markers, blocks of 32): 2-bit words without missing calls (the
serial kernel's fold mode), with ~2 % missing calls (its in-kernel decode
``_q``), int8 codes, dense rows through the kernels, and dense rows
through ``backend="xla"``.  JAX's data and init
state carry across (``convert.sharded_horseshoe_*_from_jax``) and the port
replays three JAX steps with JAX's own draws for its slice
(``torch_sharded_child.JaxHorseshoeSliceReplay``): beta, lambda and v of
the slice, eps and the scalars as tests/test_torch_sharded.py holds
BayesR's (beta rtol 2e-4 / atol 2e-6, eps rtol 2e-4 / atol 2e-5, the
scalars rtol 1e-4, the auxiliaries as tests/test_torch_horseshoe.py,
rtol 2e-4), except in the fold modes (2-bit and int8 codes without
missing calls), whose absolute tolerances on beta and eps are five times
those (1e-5, 1e-4).  There r = s (C.eps) - m s sum(eps) cancels
terms up to ~1,000 into ~45 (C.eps up to 504 and m s sum(eps) up to 93 at
the first step), and every horseshoe marker moves, so a small beta carries
that rounding: JAX's own kernel, given the port's mu (1e-8 from its own:
the lane sums of eps round apart), moves beta by 2.1e-6, and each side
lies ~1e-6 from the same sweep in float64; the in-kernel decode and dense
modes agree to 1e-7.  The (1, 1) cases run here; the (2, 1) cases, with
``chunk_blocks=8`` (two chunks a slice, an all-reduce of eps after each),
in two spawned gloo ranks (tests/torch_sharded_child.py, one spawn for
all of them), whose replicated scalars and eps must be bitwise equal.
JAX runs each case once for the module, its compiles in threads beside
the ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu import HorseshoeConfig as JConfig
from bayesrrcpp_tpu.parallel.mesh import make_mesh as jmesh
from bayesrrcpp_tpu.parallel.sharded import \
    ShardedHorseshoeSampler as JSharded
from bayesrrcpp_tpu_torch import ChainConfig, HorseshoeConfig
from bayesrrcpp_tpu_torch.convert import unpermute_eps
from bayesrrcpp_tpu_torch.parallel import ShardedHorseshoeSampler, make_mesh
from tests.test_torch_sharded import _data
from tests.torch_sharded_child import (finish_ranks, in_threads, np_state,
                                       port_sampler, replay_steps,
                                       start_ranks)

N, M, STEPS = 2000, 512, 3
CASES = {"fold": "fold", "miss": "miss", "int8": "int8", "dense": "dense",
         "xla": "xla"}


def jax_case(kind, Dm, chunk_blocks=None, seed=4):
    """JAX's sharded horseshoe on a (Dm, 1) mesh: the case handed to the
    port, and a function that steps JAX's sampler and returns its states
    after each step."""
    X, Y, x_dtype, backend = _data(kind, M)
    js = JSharded(X, Y, JConfig(block_size=32), jmesh(Dm, 1),
                  backend=backend, x_dtype=x_dtype,
                  chunk_blocks=chunk_blocks, dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    st = js.init(key)
    case = dict(kind="horseshoe", X=X, Y=Y, block_size=32, backend=backend,
                x_dtype=x_dtype, chunk_blocks=chunk_blocks, steps=STEPS,
                key=np.asarray(key), mesh=(Dm, 1),
                jax_data={k: np.array(v) for k, v in js.data.items()},
                jax_init=np_state(st))

    def states():
        out, s = [], st
        for _ in range(STEPS):
            s = js.step(s)
            out.append(np_state(s))
        return out

    return case, states, (js.B, js.Mpad, js.Mloc)


def assert_hs_close(js, ts, lo, hi, packed, Npad, fold=False,
                    n_range=None):
    """A JAX sharded horseshoe state (global) and a port slice state;
    ``fold``: the fold modes' absolute tolerances (the module
    docstring)."""
    np.testing.assert_allclose(js["beta"][lo:hi], ts["beta"], rtol=2e-4,
                               atol=1e-5 if fold else 2e-6, err_msg="beta")
    for k in ("lam", "v"):
        np.testing.assert_allclose(js[k][lo:hi], ts[k], rtol=2e-4, err_msg=k)
    eps = unpermute_eps(js["eps"], Npad) if packed else js["eps"]
    if n_range is not None:
        eps = eps[n_range[0]:n_range[1]]
    np.testing.assert_allclose(eps, ts["eps"], rtol=2e-4,
                               atol=1e-4 if fold else 2e-5)
    for k in ("sigmaE", "tau", "eta", "c2"):
        np.testing.assert_allclose(js[k], ts[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(js["mu"], ts["mu"], rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs of every case on (1, 1) and (2, 1) meshes (built, then
    stepped, in threads while the two ranks replay the (2, 1) ones) and
    the ranks' replays."""
    meshes = {1: None, 2: 8}            # Dm: chunk_blocks
    built = in_threads({(n, dm): (lambda k=k, dm=dm, c=c: jax_case(k, dm, c))
                        for n, k in CASES.items()
                        for dm, c in meshes.items()})
    handle = start_ranks([built[n, 2][0] for n in CASES],
                         str(tmp_path_factory.mktemp("hs_dm2")), world=2)
    done = in_threads({k: states for k, (_, states, _) in built.items()})
    ranks = finish_ranks(handle)
    out = {k: (c, done[k], lay) for k, (c, _, lay) in built.items()}
    return out, {n: [r[i] for r in ranks] for i, n in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_one_slice_matches_jax(runs, name):
    case, jstates, (B, Mpad, Mloc) = runs[0][name, 1]
    s, own = port_sampler(case, make_mesh(1, 1, device="cpu"))
    assert (s.B, s.Mpad, s.Mloc, s.jacobi) == (B, Mpad, Mloc, 1)
    d = case["jax_data"]
    if case["x_dtype"] != "dense":
        np.testing.assert_array_equal(d["XT"], np.array(own.XT))
        assert s.data.has_missing == own.has_missing == name.endswith("miss")
    np.testing.assert_allclose(d["xsq"], np.array(own.xsq), rtol=1e-5)
    np.testing.assert_allclose(d["gram"], np.array(own.gram), rtol=1e-4,
                               atol=1e-3)
    for js, ts in zip(jstates, replay_steps(case, s, STEPS)):
        assert_hs_close(js, ts, 0, Mpad, s.x_packed, s.Npad,
                        fold=name in ("fold", "int8"))
    # the tracked eps against Y - mu - X beta
    last = s.init(torch.Generator().manual_seed(0)).replace(
        **{k: torch.as_tensor(v) for k, v in ts.items() if k != "iteration"})
    rel = torch.linalg.norm(last.eps - s.refresh_eps(last).eps) / \
        torch.linalg.norm(last.eps)
    assert float(rel) < 1e-5, float(rel)


@pytest.mark.parametrize("name", list(CASES))
def test_two_slices_match_jax(runs, name):
    (case, jstates, (B, Mpad, Mloc)), ranks = runs[0][name, 2], runs[1][name]
    packed = case["x_dtype"] == "2bit"
    Npad = -(-N // 2048) * 2048 if packed else N
    for m, res in enumerate(ranks):
        assert res["layout"] == (1, B, Mpad, Mloc)
        np.testing.assert_allclose(case["jax_data"]["gram"][
            m * Mloc // B:(m + 1) * Mloc // B], res["own"]["gram"],
            rtol=1e-4, atol=1e-3)
        for js, ts in zip(jstates, res["states"]):
            assert_hs_close(js, ts, m * Mloc, (m + 1) * Mloc, packed, Npad,
                            fold=name in ("fold", "int8"))
    for a, b in zip(ranks[0]["states"], ranks[1]["states"]):
        for k in ("mu", "sigmaE", "tau", "eta", "c2", "eps"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_run_writes_and_refuses_what_jax_lacks(tmp_path):
    """``run`` on the kernels' serial chunks (2-bit words) end to end: the
    emission shapes, finite draws, tau > 0; and what JAX's sharded
    horseshoe has not (fused chains, a warm restart) raises."""
    X, Y, _, _ = _data("fold", 256)
    s = ShardedHorseshoeSampler(X, Y, HorseshoeConfig(block_size=32),
                                make_mesh(1, 1, device="cpu"),
                                backend="pallas", x_dtype="2bit",
                                chunk_blocks=3)
    st, out = s.run(torch.Generator().manual_seed(2), ChainConfig(6, 2, 2))
    assert out["beta"].shape == (2, 256) and out["lambda"].shape == (2, 256)
    assert out["epsilon"].shape == (2, X.shape[0])
    assert np.isfinite(out["tau"]).all() and (out["tau"] > 0).all()
    for call in (lambda: s.run_chains(torch.Generator(), 2, ChainConfig(4, 2, 1)),
                 lambda: s.step_chains(st, torch.Generator()),
                 lambda: s.init(torch.Generator(), chains=2),
                 lambda: s.init_from(None)):
        with pytest.raises(ValueError):
            call()
