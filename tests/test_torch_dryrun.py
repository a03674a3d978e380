"""The port's multi-device dry run (``tools/dryrun.py``) on the CPU.

- ``dryrun_multichip(4)``: four spawned gloo ranks on the (2, 2) mesh run
  the seven cases of ``__graft_entry__.dryrun_multichip`` (each asserting
  finite outputs), then the multi-host leg: tests/test_multihost.py's
  problem on a 2-rank mesh, launched by ``python -m torch.distributed.run
  --standalone --nproc_per_node=2`` (``initialize()`` reading torchrun's
  environment) and over ``tcp://``, full X and per-rank marker slabs;
  the tool raises unless both ranks of both launches agree bitwise.
- The same problem on the same (2, 1) mesh against JAX's
  ``ShardedSpikeSlabSampler`` (``backend="xla"``, 3 steps): two gloo ranks
  replay JAX's draws for their slices (tests/torch_sharded_child.py, as
  tests/test_torch_sharded.py runs it): labels equal, beta and eps within
  tests/test_multihost.py's tolerances (rtol 1e-5, atol 1e-6 and 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesrrcpp_tpu import GroupsConfig as JGroups
from bayesrrcpp_tpu.parallel.mesh import make_mesh as jmesh
from bayesrrcpp_tpu.parallel.sharded import \
    ShardedSpikeSlabSampler as JSharded
from bayesrrcpp_tpu_torch.tools import dryrun
from tests.test_multihost import make_problem as jax_make_problem
from tests.torch_sharded_child import (finish_ranks, in_threads, np_state,
                                       start_ranks)

STEPS = dryrun.MULTIHOST_STEPS
pytestmark = pytest.mark.multiprocess


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dry run of four ranks (in a thread: it waits on its spawned
    ranks), JAX's three steps on the multi-host problem, and two gloo
    ranks replaying them."""
    X, Y, cva, g_assign = dryrun.make_problem()
    js = JSharded(X, Y, cva, JGroups(block_size=16), jmesh(2, 1),
                  g_assign=g_assign, backend="xla", dtype=jnp.float32)
    key = jax.random.PRNGKey(7)
    st = js.init(key)
    case = dict(X=X, Y=Y, cva=cva, g_assign=g_assign, fixed=None,
                block_size=16, backend="xla", x_dtype="dense",
                chunk_blocks=None, chains=None, steps=STEPS,
                key=np.asarray(key), mesh=(2, 1),
                jax_data={k: np.array(v) for k, v in js.data._asdict().items()},
                jax_init=np_state(st))
    handle = start_ranks([case], str(tmp_path_factory.mktemp("replay")))

    def jax_states():
        out, s = [], st
        for _ in range(STEPS):
            s = js.step(s)
            out.append(np_state(s))
        return out

    res = in_threads({"dry": lambda: dryrun.dryrun_multichip(
        4, device="cpu", timeout=240, log=lambda msg: None),
        "jax": jax_states})
    ranks = finish_ranks(handle, timeout=240)
    return res["dry"], res["jax"], [r[0] for r in ranks], js.Mloc


def test_problem_is_the_multihost_tests(runs):
    for a, b in zip(dryrun.make_problem(), jax_make_problem()):
        np.testing.assert_array_equal(a, b)


def test_dryrun_multichip_cases(runs):
    dry = runs[0]
    assert dry["mesh"] == (2, 2)
    names = ["grouped", "packed", "chains", "fused", "strided", "split",
             "row"]
    assert len(dry["ranks"]) == 4
    for rank in dry["ranks"]:
        assert [c["case"] for c in rank] == names
        by = {c["case"]: c for c in rank}
        assert by["grouped"]["emits"] == 2
        assert by["chains"] == dict(by["chains"], chains=8, local=2)
        assert by["strided"]["plan"][0] > 1          # the "t" plan
        assert by["row"]["plan"] == (2, 8, "row")
        assert all(not c["launches"] for c in rank)  # plain versions here


@pytest.mark.parametrize("mode", dryrun.MULTIHOST_MODES)
def test_torchrun_leg(runs, mode):
    """Both launches' ranks were held bitwise to torchrun's rank 0 inside
    the tool; the state it returns is whole and finite, and the slab run
    reads the same data as the full-X run."""
    st = runs[0]["multihost"][mode]
    assert st["beta"].shape == (64,) and st["labels"].shape == (64,)
    assert st["eps"].shape == (96,)
    assert all(np.isfinite(v).all() for v in st.values())
    glob = runs[0]["multihost"]["global"]
    np.testing.assert_array_equal(st["labels"], glob["labels"])


def test_port_ranks_match_jax(runs):
    _, jstates, ranks, Mloc = runs
    for m, res in enumerate(ranks):
        lo, hi = m * Mloc, (m + 1) * Mloc
        assert res["at"] == (m, 0)
        for js, ts in zip(jstates, res["states"]):
            np.testing.assert_array_equal(js["labels"][lo:hi], ts["labels"])
            np.testing.assert_allclose(js["beta"][lo:hi], ts["beta"],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(js["eps"], ts["eps"], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(js["sigmaE"], ts["sigmaE"],
                                       rtol=1e-5)
    for a, b in zip(ranks[0]["states"], ranks[1]["states"]):
        for k in ("mu", "sigmaE", "sigmaGG", "pi", "eps"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
