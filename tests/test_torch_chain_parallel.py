"""Chains over devices (``parallel/chains.py``: ``chain_mesh``,
``ChainParallelRunner``) against JAX's on the CPU; the counterpart of
tests/test_chain_parallel.py.

JAX's runner on its virtual 2-device chain mesh steps 4 chains (2 a
device) of the recipe of test_chain_parallel.py (``simulate_bayesr``,
N=160 x M=64, blocks of 32, the kernels: the fused serial sweep) twice.
The port's runner runs on two spawned gloo ranks (tests/
torch_sharded_child.py, one spawn for the file): each rank carries JAX's
data and its two chains' init state across and steps them with JAX's draws
for its slice of the root's chain keys (``split(key, 4)``, the shared
visit order from the rank's first chain, as JAX's shard takes it); labels
exact, beta rtol 2e-4 / atol 2e-6, eps rtol 2e-4 / atol 2e-5, the
scalars rtol 1e-4, as tests/test_torch_sharded.py holds them.  On the
same ranks, for BayesR and the horseshoe, ``runner.run`` from a root
generator gathers every chain to every rank ((emits, 4, M), rank 0
writing one CSV a chain), and rank g's chains are bitwise a one-rank
``run_chains`` over ``chain_streams(root, g)``: JAX's determinism contract
(chains.py:15-18) on torch streams.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu import BayesRConfig as JConfig
from bayesrrcpp_tpu import SpikeSlabSampler as JSampler
from bayesrrcpp_tpu import simulate as jsim
from bayesrrcpp_tpu.parallel.chains import ChainParallelRunner as JRunner
from bayesrrcpp_tpu.parallel.chains import chain_mesh as jchain_mesh
from bayesrrcpp_tpu_torch import (BayesRConfig, ChainConfig, HorseshoeConfig,
                                  HorseshoeSampler, SpikeSlabSampler)
from bayesrrcpp_tpu_torch.parallel import (ChainMesh, ChainParallelRunner,
                                           chain_mesh, chain_streams,
                                           make_mesh)
from tests.torch_sharded_child import np_state, run_ranks

CVA = np.array([0.001, 0.01, 0.1])
CHAINS, D, STEPS = 4, 2, 2
RUN = (6, 2, 2)                 # the ChainConfig of the runs


def _sim():
    sim = jsim.simulate_bayesr(seed=91, N=160, M=64, n_causal=8, h2=0.5)
    return np.asarray(sim.X, np.float32), np.asarray(sim.Y)


def _port_sampler(kind, X, Y):
    if kind == "bayesr":
        return SpikeSlabSampler(X, Y, CVA, BayesRConfig(block_size=32),
                                backend="pallas", device="cpu")
    return HorseshoeSampler(X, Y, HorseshoeConfig(block_size=32),
                            backend="pallas", device="cpu")


def chains_child(payload, rank, world):
    """One rank: its JAX-replayed chains, and the runs of both samplers
    from a root generator beside the one-rank runs of its streams."""
    from bayesrrcpp_tpu_torch.convert import data_from_jax, state_from_jax
    from bayesrrcpp_tpu_torch.io.sink import ChainFanoutSink
    from tests.test_torch_dense_samplers import ChainReplay
    from tests.test_torch_multichain import JaxBayesRReplayVariates

    X, Y = payload["X"], payload["Y"]
    mesh = chain_mesh(world, device="cpu")
    C = CHAINS // world
    s = _port_sampler("bayesr", X, Y)
    s.data = data_from_jax(payload["jax_data"], N=s.N, device="cpu")
    runner = ChainParallelRunner(s, mesh)
    keys = jax.random.split(jnp.asarray(payload["key"]), CHAINS)
    rv = ChainReplay([JaxBayesRReplayVariates(k)
                      for k in keys[rank * C:(rank + 1) * C]])
    _, v = runner.init(rv, CHAINS)      # advances the keys as JAX's init
    init = {k: np.asarray(x)[rank * C:(rank + 1) * C]
            for k, x in payload["jax_init"].items()}
    st = runner.steps(state_from_jax(init, s), v, STEPS)
    out = dict(state=np_state(st), runs={})
    for kind in ("bayesr", "horseshoe"):
        s = _port_sampler(kind, X, Y)
        runner = ChainParallelRunner(s, mesh)
        # the writer's sink (another rank's would be ignored)
        sink = (ChainFanoutSink.csv(
            os.path.join(payload["tmp"], f"{kind}.csv"), CHAINS, kind,
            M=s.M, N=s.N) if rank == 0 else None)
        _, gathered = runner.run(torch.Generator().manual_seed(9), CHAINS,
                                 ChainConfig(*RUN), sink=sink)
        if sink is not None:
            sink.close()
        _, local = s.run_chains(
            chain_streams(torch.Generator().manual_seed(9), rank), C,
            ChainConfig(*RUN))
        out["runs"][kind] = (gathered, local)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """JAX's chain-parallel state after two steps, and the two ranks'."""
    X, Y = _sim()
    js = JSampler(X, Y, CVA, JConfig(block_size=32), backend="pallas",
                  dtype=jnp.float32)
    runner = JRunner(js, jchain_mesh(D))
    key = jax.random.PRNGKey(5)
    st0 = runner.init(key, CHAINS)
    init = np_state(st0)                # the steps donate st0
    st = runner._steps(st0, js.data, STEPS)
    tmp = str(tmp_path_factory.mktemp("chains"))
    payload = dict(X=X, Y=Y, key=np.asarray(key), tmp=tmp,
                   jax_data={k: np.array(v)
                             for k, v in js.data._asdict().items()},
                   jax_init=init)
    res = run_ranks([dict(kind="chains",
                          run=functools.partial(chains_child, payload))],
                    tmp, world=D)
    return np_state(st), [r[0] for r in res], tmp


def test_ranks_match_jax_chain_runner(ranks):
    jst, res, _ = ranks
    C = CHAINS // D
    for g, r in enumerate(res):
        ts, sl = r["state"], slice(g * C, (g + 1) * C)
        np.testing.assert_array_equal(jst["labels"][sl], ts["labels"])
        np.testing.assert_allclose(jst["beta"][sl], ts["beta"], rtol=2e-4,
                                   atol=2e-6)
        np.testing.assert_allclose(jst["eps"][sl], ts["eps"], rtol=2e-4,
                                   atol=2e-5)
        for k in ("sigmaE", "sigmaGG", "pi"):
            np.testing.assert_allclose(jst[k][sl], ts[k], rtol=1e-4,
                                       err_msg=k)
        np.testing.assert_allclose(jst["mu"][sl], ts["mu"], rtol=1e-4,
                                   atol=1e-6)
    assert not np.array_equal(res[0]["state"]["beta"][0],
                              res[1]["state"]["beta"][0])


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_each_rank_is_a_fused_run_of_its_streams(ranks, kind):
    _, res, tmp = ranks
    C = CHAINS // D
    gathered = [r["runs"][kind][0] for r in res]
    for k in gathered[0]:
        np.testing.assert_array_equal(gathered[0][k], gathered[1][k])
    assert gathered[0]["beta"].shape == (2, CHAINS, 64)
    for g, r in enumerate(res):
        local = r["runs"][kind][1]
        for k in local:
            np.testing.assert_array_equal(
                gathered[0][k][:, g * C:(g + 1) * C], local[k], err_msg=k)
    assert np.isfinite(gathered[0]["sigmaE"]).all()
    for c in range(CHAINS):
        with open(os.path.join(tmp, f"{kind}.chain{c}.csv")) as f:
            assert len(f.read().splitlines()) == 3       # header, 2 rows


def test_one_rank_runner_and_refusals():
    """A one-rank chain mesh runs rank 0's streams; what the runner
    refuses: a chain count off the mesh, a sampler without the fused
    kernel (the plain backend), a mesh that is not a chain mesh."""
    X, Y = _sim()
    s = _port_sampler("bayesr", X, Y)
    runner = ChainParallelRunner(s, chain_mesh(device="cpu"))
    _, a = runner.run(torch.Generator().manual_seed(3), 2, ChainConfig(*RUN))
    _, b = s.run_chains(chain_streams(torch.Generator().manual_seed(3), 0),
                        2, ChainConfig(*RUN))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    two = ChainMesh(2, 0, None, torch.device("cpu"))   # no ranks needed
    with pytest.raises(ValueError, match="multiple"):
        ChainParallelRunner(s, two).init(torch.Generator(), 3)
    plain = SpikeSlabSampler(X, Y, CVA, BayesRConfig(block_size=32),
                             backend="blocked", device="cpu")
    with pytest.raises(ValueError, match="fused"):
        ChainParallelRunner(plain, chain_mesh(device="cpu"))
    with pytest.raises(ValueError, match="chain mesh"):
        ChainParallelRunner(s, make_mesh(1, 1, device="cpu"))
    with pytest.raises(ValueError, match="2 devices"):
        chain_mesh(2, device="cpu")
