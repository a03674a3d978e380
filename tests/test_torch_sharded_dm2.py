"""The port's marker-sharded BayesR sampler on a (2, 1) mesh of two gloo
processes against JAX's ``ShardedSpikeSlabSampler`` on ``make_mesh(2, 1)``
(the virtual CPU devices), on the CPU.

The cases of tests/test_torch_sharded.py at Dm = 2: JAX's sampler runs
here, its data, init state and key go to two spawned ranks
(tests/torch_sharded_child.py, one spawn for every case), and each rank
replays three steps with JAX's draws for its own slice (the m index
folded into the sweep key) and returns its states.  Each rank's slice of
beta and labels, and the replicated eps and scalars, are held to JAX's
with test_torch_sharded.py's tolerances; the replicated scalars of the
two ranks must be bitwise equal.  ``chunk_blocks=16`` cuts a slice's 8
rounds (J=8) into chunks of 2, one all-reduce of eps after each, and the
serial slices' 32 blocks into chunks of 16 (M=2048, 1,024 markers a
slice); the ``miss`` case keeps the default (one chunk of every round).
"""
import numpy as np
import pytest

from tests.test_torch_sharded import (N, assert_own_data, assert_state_close,
                                      jax_case)
from tests.torch_sharded_child import run_ranks

DM = 2
CASES = {
    # name: (kind, M, chains, chunk_blocks)
    "fold": ("fold", 4096, None, 16),
    "miss": ("miss", 4096, None, None),
    "dense": ("dense", 4096, None, 16),
    "fold-2chains": ("fold", 4096, 2, 16),
    "serial": ("fold", 2048, None, 16),
    "xla": ("xla", 512, None, None),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs of every case, and the two ranks' replays of them."""
    jax_runs = {name: jax_case(kind, M, DM, chains=chains,
                               chunk_blocks=chunk)
                for name, (kind, M, chains, chunk) in CASES.items()}
    ranks = run_ranks([jax_runs[n][0] for n in CASES],
                      str(tmp_path_factory.mktemp("dm2")), world=DM)
    return {name: (jax_runs[name], [r[i] for r in ranks])
            for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_jax(runs, name):
    (case, jstates, jlayout), ranks = runs[name]
    J, B, Mpad, Mloc = jlayout
    packed = case["x_dtype"] == "2bit"
    Npad = -(-N // 2048) * 2048 if packed else N
    for m, res in enumerate(ranks):
        assert res["layout"] == jlayout
        lo, hi = m * Mloc, (m + 1) * Mloc
        assert_own_data(case, res["own"], res["has_missing"], lo, hi)
        for js, ts in zip(jstates, res["states"]):
            assert_state_close(js, ts, lo, hi, packed, Npad)
    # the replicated scalars are the same bits on both ranks, every step
    for a, b in zip(ranks[0]["states"], ranks[1]["states"]):
        for k in ("mu", "sigmaE", "sigmaGG", "pi", "eps"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
