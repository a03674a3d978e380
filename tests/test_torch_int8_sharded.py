"""The port's marker-sharded BayesR sampler on int8 codes against JAX's
``ShardedSpikeSlabSampler(x_dtype="int8")``, on the CPU: a (1, 1) mesh in
this process and a (2, 1) mesh of two spawned gloo processes
(tests/torch_sharded_child.py), as tests/test_torch_sharded.py and
tests/test_torch_sharded_dm2.py hold the 2-bit and dense cases.

The same dosages (N=2000, M=4096, tests/test_torch_sharded.py:_data),
quantized to int8 codes by both packages, without and with 2 % missing
calls.  Missing-free codes take the slices' strided sweep through the
int8 mode of sites #5/#6 (one chain and 2 fused chains; chunks of 2 rounds
at Dm=2); codes with missing calls take the serial in-kernel decode (JAX's
``use_t`` is False there, sharded.py:552-555), so the port's plan is J=1
on the same marker layout.  Each rank's own slice data is checked against
JAX's, then JAX's data and init state are carried across and three JAX
steps replayed with JAX's draws: tolerances as test_torch_sharded.py (labels
exact, beta rtol 2e-4 / atol 2e-6, the scalars rtol 1e-4) but eps to rtol
2e-4 / atol 1e-4: JAX's int8 sharded run lands 1.6e-5 (relative norm; 7e-5
at most) from JAX's own 2-bit run of the same dosages after the first
step, while the port's int8 and 2-bit runs agree to 5e-7 and the port's
2-bit run is within 2.4e-6 of JAX's (measured on this case).  The two
ranks' replicated scalars and eps are bitwise equal.
"""
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu_torch.parallel import make_mesh
from tests.test_torch_sharded import STEPS, assert_own_data, jax_case
from tests.torch_sharded_child import port_sampler, replay_steps, run_ranks

CASES = {
    # name: (kind, M, chains, chunk_blocks)
    "int8": ("int8", 4096, None, 16),
    "int8-2chains": ("int8", 4096, 2, 16),
    "int8-miss": ("int8-miss", 4096, None, 16),
}


def assert_state_close(js, ts, lo, hi):
    """A JAX state (global, NumPy) and a port slice state (NumPy), with
    the eps tolerance of the module docstring."""
    np.testing.assert_array_equal(js["labels"][..., lo:hi], ts["labels"])
    np.testing.assert_allclose(js["beta"][..., lo:hi], ts["beta"], rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_allclose(js["eps"], ts["eps"], rtol=2e-4, atol=1e-4)
    for name in ("sigmaE", "sigmaGG", "pi"):
        np.testing.assert_allclose(js[name], ts[name], rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(js["mu"], ts["mu"], rtol=1e-4, atol=1e-6)


def _layout(jlayout, kind):
    """JAX's (J, B, Mpad, Mloc) as the port's plan: J=1 where the codes
    hold missing calls (the serial sweep on the same markers)."""
    J, B, Mpad, Mloc = jlayout
    return (1 if kind == "int8-miss" else J, B, Mpad, Mloc)


@pytest.mark.parametrize("name", list(CASES))
def test_int8_steps_match_jax_on_one_slice(name):
    kind, M, chains, _ = CASES[name]
    case, jstates, jlayout = jax_case(kind, M, 1, chains=chains)
    s, own = port_sampler(case, make_mesh(1, 1, device="cpu"))
    assert (s.jacobi, s.B, s.Mpad, s.Mloc) == _layout(jlayout, kind)
    assert s.x_int8 and s.strided == (kind == "int8")
    assert_own_data(case, {k: np.array(getattr(own, k)) for k in
                           ("XT", "xsq", "gram", "x_mean", "x_scale",
                            "x_colsum")}, own.has_missing, 0, s.Mpad)
    tstates = replay_steps(case, s, STEPS)
    for js, ts in zip(jstates, tstates):
        assert_state_close(js, ts, 0, s.Mpad)
    st = s.init(torch.Generator().manual_seed(0), chains=chains)
    last = st.replace(**{k: torch.as_tensor(v) for k, v in tstates[-1].items()
                         if k != "iteration"})
    exact = s.refresh_eps(last).eps
    rel = torch.linalg.norm(last.eps - exact) / torch.linalg.norm(exact)
    assert float(rel) < 1e-5, float(rel)


@pytest.fixture(scope="module")
def dm2_runs(tmp_path_factory):
    jax_runs = {name: jax_case(kind, M, 2, chains=chains,
                               chunk_blocks=chunk)
                for name, (kind, M, chains, chunk) in CASES.items()}
    ranks = run_ranks([jax_runs[n][0] for n in CASES],
                      str(tmp_path_factory.mktemp("int8dm2")), world=2)
    return {name: (jax_runs[name], [r[i] for r in ranks])
            for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_int8_ranks_match_jax(dm2_runs, name):
    (case, jstates, jlayout), ranks = dm2_runs[name]
    kind = CASES[name][0]
    Mloc = jlayout[3]
    for m, res in enumerate(ranks):
        assert res["layout"] == _layout(jlayout, kind)
        lo, hi = m * Mloc, (m + 1) * Mloc
        assert_own_data(case, res["own"], res["has_missing"], lo, hi)
        for js, ts in zip(jstates, res["states"]):
            assert_state_close(js, ts, lo, hi)
    for a, b in zip(ranks[0]["states"], ranks[1]["states"]):
        for k in ("mu", "sigmaE", "sigmaGG", "pi", "eps"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
