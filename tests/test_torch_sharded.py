"""The port's marker-sharded BayesR sampler (bayesrrcpp_tpu_torch/parallel/)
against JAX's ``ShardedSpikeSlabSampler``, on the CPU, on a (1, 1) mesh.

The (2, 1) mesh, two gloo processes, is tests/test_torch_sharded_dm2.py;
a chain run end to end is tests/test_torch_sharded_run.py; the helpers
are tests/torch_sharded_child.py.  Each case builds both samplers on the
same numpy data: M=4096, the "t" plan, as tests/test_sharded.py:433-456,
on 2-bit words without and with missing calls and on dense rows, with
N=2000 individuals as tests/test_torch_bayesr.py (at test_sharded.py's
N=320 the first block-Jacobi steps of this N << M chain grow the
residual fivefold, and the two packages' f32 sums part by more than the
tolerances below on its smallest entries).  It checks the port's own
slice data against JAX's, carries JAX's data and init state across
(``convert``), and replays three JAX steps (or fused ``step_chains`` of
C=2) with JAX's own draws (``JaxSliceReplay``): labels exact, floats as
tests/test_torch_bayesr.py:_assert_states_close (beta rtol 2e-4 / atol
2e-6, eps rtol 2e-4 / atol 2e-5, the scalars rtol 1e-4), and the tracked
eps against ``refresh_eps``.  Also a plan that is not "t" (M=1024, two
fused chains: the fused serial sweep), the ``backend="xla"`` body, and
the configurations outside the slice.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu import BayesRConfig as JConfig
from bayesrrcpp_tpu.parallel.mesh import make_mesh as jmesh
from bayesrrcpp_tpu.parallel.sharded import \
    ShardedSpikeSlabSampler as JSharded
from bayesrrcpp_tpu_torch import (BayesRConfig, ChainConfig, HorseshoeConfig,
                                  parallel)
from bayesrrcpp_tpu_torch.convert import unpermute_eps
from bayesrrcpp_tpu_torch.parallel import ShardedSpikeSlabSampler, make_mesh
from tests.torch_sharded_child import np_state, port_sampler, replay_steps

CVA = np.array([0.001, 0.01, 0.1])
N = 2000
STEPS = 3


def _data(kind, M, seed=93):
    """(X, Y, x_dtype, backend) of a case: dosages for the words and the
    int8 codes (NaN for a missing call), standardized rows for dense X."""
    rng = np.random.default_rng(seed)
    dosage = rng.binomial(2, rng.uniform(0.2, 0.8, M), size=(N, M)).astype(
        float)
    dense = (dosage - dosage.mean(0)) / dosage.std(0, ddof=1)
    bt = np.zeros(M)
    bt[rng.choice(M, 40, replace=False)] = rng.normal(0, 0.25, 40)
    Y = dense @ bt + rng.normal(0, 0.7, N)
    if kind in ("miss", "int8-miss"):
        dosage[rng.random(dosage.shape) < 0.02] = np.nan
    if kind in ("dense", "xla"):
        return dense.astype(np.float32), Y, "dense", (
            "xla" if kind == "xla" else "pallas")
    return dosage, Y, "int8" if kind.startswith("int8") else "2bit", "pallas"


def jax_case(kind, M, Dm, *, chains=None, chunk_blocks=None, steps=STEPS,
             block_size=32, seed=3):
    """JAX's sampler on a (Dm, 1) mesh and its states: the case handed to
    the port (``torch_sharded_child.port_sampler`` / ``replay_steps``) and
    JAX's states after each step, as NumPy dicts."""
    X, Y, x_dtype, backend = _data(kind, M)
    js = JSharded(X, Y, CVA, JConfig(block_size=block_size), jmesh(Dm, 1),
                  backend=backend, x_dtype=x_dtype,
                  chunk_blocks=chunk_blocks, dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    if chains is None:
        st = js.init(key)
        stepper = js.step
    else:
        st = js.init_chains(key, chains)
        stepper = js.step_chains
    case = dict(X=X, Y=Y, cva=CVA, block_size=block_size, backend=backend,
                x_dtype=x_dtype, chunk_blocks=chunk_blocks, chains=chains,
                steps=steps, key=np.asarray(key),
                jax_data={k: np.array(v) for k, v in js.data._asdict().items()},
                jax_init=np_state(st))
    states = []
    for _ in range(steps):
        st = stepper(st)
        states.append(np_state(st))
    layout = (js.jacobi_t, js.B, js.Mpad, js.Mloc)
    return case, states, layout


def assert_state_close(js, ts, lo, hi, packed, Npad):
    """A JAX state (global, NumPy) and a port slice state (NumPy)."""
    np.testing.assert_array_equal(js["labels"][..., lo:hi], ts["labels"])
    np.testing.assert_allclose(js["beta"][..., lo:hi], ts["beta"], rtol=2e-4,
                               atol=2e-6)
    eps = unpermute_eps(js["eps"], Npad) if packed else js["eps"]
    np.testing.assert_allclose(eps, ts["eps"], rtol=2e-4, atol=2e-5)
    for name in ("sigmaE", "sigmaGG", "pi"):
        np.testing.assert_allclose(js[name], ts[name], rtol=1e-4,
                                   err_msg=name)
    # mu may sit near 0, where rtol alone asks for more than f32 sums give:
    # atol 1e-6 is 5e-5 of its posterior sd sqrt(sigmaE / N) ~ 0.02
    np.testing.assert_allclose(js["mu"], ts["mu"], rtol=1e-4, atol=1e-6)


def assert_own_data(case, own, has_missing, lo, hi):
    """The port's own slice data against JAX's: the same words or int8
    codes (or rows), means and scales, xsq / Gram blocks / column sums to
    f32 sums."""
    d = case["jax_data"]
    nb = d["gram"].shape[0] * (hi - lo) // d["XT"].shape[0]
    blo = lo // (hi - lo) * nb
    if case["x_dtype"] == "int8":
        np.testing.assert_array_equal(d["XT"][lo:hi], own["XT"])
        for k in ("x_mean", "x_scale"):
            np.testing.assert_allclose(d[k][lo:hi], own[k], rtol=1e-6)
        np.testing.assert_allclose(d["x_colsum"][lo:hi], own["x_colsum"],
                                   rtol=1e-4, atol=1e-3)
        valid = np.asarray(d["valid"], bool)
        assert has_missing == bool((d["XT"][valid] == 3).any())
    elif case["x_dtype"] == "2bit":
        np.testing.assert_array_equal(d["XT"][lo:hi], own["XT"])
        np.testing.assert_allclose(d["x_mean"][lo:hi], own["x_mean"],
                                   rtol=1e-6)
        np.testing.assert_allclose(d["x_scale"][lo:hi], own["x_scale"],
                                   rtol=1e-6)
        np.testing.assert_allclose(d["x_colsum"][lo:hi], own["x_colsum"],
                                   rtol=1e-4, atol=1e-3)
        from bayesrrcpp_tpu_torch.convert import has_missing_calls

        assert has_missing == has_missing_calls(d["XT"], N, d["valid"])
    else:
        np.testing.assert_allclose(d["XT"][lo:hi], own["XT"], rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(d["xsq"][lo:hi], own["xsq"], rtol=1e-5)
    np.testing.assert_allclose(d["gram"][blo:blo + nb], own["gram"],
                               rtol=1e-4, atol=1e-3)


CASES = {
    # name: (kind, M, chains); the serial slice's single chain and the
    # chunked sweeps are test_torch_sharded_dm2.py's
    "fold": ("fold", 4096, None),
    "miss": ("miss", 4096, None),
    "dense": ("dense", 4096, None),
    "fold-2chains": ("fold", 4096, 2),
    "serial-2chains": ("fold", 1024, 2),
    "xla": ("xla", 512, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax_on_one_slice(name):
    kind, M, chains = CASES[name]
    case, jstates, jlayout = jax_case(kind, M, 1, chains=chains)
    s, own = port_sampler(case, make_mesh(1, 1, device="cpu"))
    assert (s.jacobi, s.B, s.Mpad, s.Mloc) == jlayout
    assert s.strided == (M >= 2048 and kind != "xla")
    assert_own_data(case, {k: np.array(getattr(own, k)) for k in
                           ("XT", "xsq", "gram", "x_mean", "x_scale",
                            "x_colsum")}, own.has_missing, 0, s.Mpad)
    tstates = replay_steps(case, s, STEPS)
    for js, ts in zip(jstates, tstates):
        assert_state_close(js, ts, 0, s.Mpad, s.x_packed, s.Npad)
    # the eps invariant: tracked eps against Y - mu - X beta
    st = s.init(torch.Generator().manual_seed(0), chains=chains)
    last = st.replace(**{k: torch.as_tensor(v) for k, v in tstates[-1].items()
                         if k != "iteration"})
    exact = s.refresh_eps(last).eps
    rel = torch.linalg.norm(last.eps - exact) / torch.linalg.norm(exact)
    assert float(rel) < 1e-5, float(rel)


@pytest.mark.parametrize("case", ["n_axis", "split", "int8", "groups",
                                  "fixed", "no_card", "packed_xla",
                                  "horseshoe", "chains"])
def test_configurations_outside_the_slice_raise(case):
    X, Y, _, _ = _data("fold", 256)
    kw = dict(backend="pallas", x_dtype="2bit")
    mesh = lambda: make_mesh(1, 1, device="cpu")            # noqa: E731
    cva = CVA
    err = NotImplementedError
    if case in ("n_axis", "horseshoe", "chains"):
        # ported since: what stays refused is what JAX refuses
        # (tests/test_torch_sharded_split.py, test_torch_sharded_horseshoe.py
        # and test_torch_chain_parallel.py hold the ported parts to JAX)
        if case == "n_axis":
            # words on an (m, n > 1) mesh (sharded.py:242-245); the mesh is
            # described without its ranks: the refusal comes first
            n2 = parallel.Mesh(1, 2, 0, 0, None, None, torch.device("cpu"))
            with pytest.raises(ValueError, match="Dn > 1"):
                ShardedSpikeSlabSampler(X, Y, cva, BayesRConfig(), n2, **kw)
        elif case == "horseshoe":
            h = parallel.ShardedHorseshoeSampler(
                X, Y, HorseshoeConfig(block_size=32), mesh(), **kw)
            with pytest.raises(ValueError, match="one chain"):
                h.run_chains(torch.Generator(), 2, ChainConfig(4, 2, 1))
        else:
            with pytest.raises(ValueError, match="chain mesh"):
                parallel.ChainParallelRunner(
                    parallel.ShardedSpikeSlabSampler(X, Y, cva,
                                                     BayesRConfig(), mesh(),
                                                     **kw), mesh())
        return
    if case == "no_card":
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device runs")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(1, 1)
        return
    if case == "int8":
        # int8 codes run (tests/test_torch_int8_sharded.py); what the JAX
        # sampler refuses on them, the port refuses: a rank's own slice of
        # codes (x_process_shard) and the xla backend
        s = ShardedSpikeSlabSampler(X, Y, cva, BayesRConfig(), mesh(),
                                    backend="pallas", x_dtype="int8")
        assert s.x_int8 and s.data.XT.dtype == torch.int8
        st = s.step(s.init(torch.Generator().manual_seed(0)),
                    torch.Generator().manual_seed(1))
        assert bool(torch.isfinite(st.eps).all())
        with pytest.raises(ValueError, match="x_process_shard"):
            ShardedSpikeSlabSampler(X.T, Y, cva, BayesRConfig(), mesh(),
                                    backend="pallas", x_dtype="int8",
                                    transposed=True, x_process_shard=True,
                                    n_markers=X.shape[1])
        with pytest.raises(ValueError, match="pallas"):
            ShardedSpikeSlabSampler(X, Y, cva, BayesRConfig(), mesh(),
                                    x_dtype="int8")
        return
    if case == "split":
        # the split sweep takes dense X only (sharded.py:242-245)
        kw["split_sweep"], err = True, ValueError
    elif case in ("groups", "fixed"):
        # ported (Queue 1 item 6; tests/test_torch_groups_sharded.py holds
        # them to JAX): the bayesr variant with per-group rows or a fixed
        # effect builds and steps on one slice
        if case == "groups":
            cva = np.tile(CVA, (2, 1))
        else:
            kw["fixed"] = np.random.default_rng(0).normal(size=(N, 1))
        s = ShardedSpikeSlabSampler(X, Y, cva, BayesRConfig(block_size=32),
                                    mesh(), **kw)
        g = torch.Generator().manual_seed(0)
        st = s.step(s.init(g), g)
        assert (st.sigmaGG.shape, st.alpha.shape) == ((s.G,), (s.F,))
        assert bool(torch.isfinite(st.eps).all())
        return
    elif case == "packed_xla":
        kw["backend"], err = "xla", ValueError
    with pytest.raises(err):
        ShardedSpikeSlabSampler(X, Y, cva, BayesRConfig(), mesh(), **kw)
