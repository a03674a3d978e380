"""The dense f32 mode of the port's eight sweep entry points against the
JAX package, on the CPU.

The same standardized rows X (M, N), Gram blocks, warm state and variates,
made with numpy from a seed, go through the JAX wrapper with
``x_mean=None`` run in interpret mode, as the JAX package's own tests run
it (tests/test_jacobi_t.py, tests/test_multichain.py, tests/test_pallas.py),
and through the port's entry point on CPU tensors (its plain version):

- the strided-rounds sweeps ``bayesr_jacobi_t`` / ``horseshoe_jacobi_t``
  and their fused ``_mc`` versions at C=3 (``bayesr_jacobi_t_pallas`` /
  ``horseshoe_jacobi_t_pallas`` / ``*_pallas_mc``);
- the serial sweeps ``bayesr_sweep`` / ``horseshoe_sweep`` (p/z by sweep
  position) and their fused versions ``bayesr_sweep_mc`` /
  ``horseshoe_sweep_mc`` at C=3 (p/z by marker), against
  ``bayesr_sweep_pallas`` / ``horseshoe_sweep_pallas`` / ``*_pallas_mc``.

N=150 individuals (JAX's dense-vs-packed cases, tests/test_jacobi_t.py:
153), not a multiple of any tile: eps has length N, with no padding and
no lane mask.  Tolerances: labels exact, eps, beta, v and beta_acum to
rtol 2e-5 / atol 2e-6 (f32 reassociation: JAX sums each dot over its
lane tile, the port in one matrix product).  Also the refusal that still
stands, ``missing=True`` on dense rows; and the int8 codes of the same
dosages, which now run (tests/test_torch_int8_kernels.py holds them
against JAX) and give the dense sweep's result.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu.ops import pallas_jacobi_t as jpt
from bayesrrcpp_tpu.ops import pallas_multichain as jpm
from bayesrrcpp_tpu.ops import pallas_sweep as jps
from bayesrrcpp_tpu_torch.ops import jacobi_t, multichain, serial

CVA = np.array([0.001, 0.01, 0.1])
N, C, NR = 150, 3, 2      # individuals, fused chains, rounds per sweep

# entry point -> (port function, JAX function, horseshoe, strided, fused)
ENTRIES = {
    "bayesr_jacobi_t": (jacobi_t.bayesr_jacobi_t, jpt.bayesr_jacobi_t_pallas,
                        False, True, False),
    "horseshoe_jacobi_t": (jacobi_t.horseshoe_jacobi_t,
                           jpt.horseshoe_jacobi_t_pallas, True, True, False),
    "bayesr_jacobi_t_mc": (jacobi_t.bayesr_jacobi_t_mc,
                           jpt.bayesr_jacobi_t_pallas_mc, False, True, True),
    "horseshoe_jacobi_t_mc": (jacobi_t.horseshoe_jacobi_t_mc,
                              jpt.horseshoe_jacobi_t_pallas_mc, True, True,
                              True),
    "bayesr_sweep": (serial.bayesr_sweep, jps.bayesr_sweep_pallas, False,
                     False, False),
    "horseshoe_sweep": (serial.horseshoe_sweep, jps.horseshoe_sweep_pallas,
                        True, False, False),
    "bayesr_sweep_mc": (multichain.bayesr_sweep_mc,
                        jpm.bayesr_sweep_pallas_mc, False, False, True),
    "horseshoe_sweep_mc": (multichain.horseshoe_sweep_mc,
                           jpm.horseshoe_sweep_pallas_mc, True, False, True),
}


def dense_case(seed, J, B, G):
    """Standardized dense rows and a warm state of C chains with
    variates, all numpy f32; nb = J*NR blocks of B markers."""
    rng = np.random.default_rng(seed)
    nb = J * NR
    M = nb * B
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M))
    X = ((dosage - dosage.mean(0)) / dosage.std(0, ddof=1)).T
    X = X.astype(np.float32)                                   # (M, N)
    codes = np.ascontiguousarray(dosage.T, np.int8)            # (M, N)
    Xb = X.reshape(nb, B, N).astype(np.float64)
    beta = np.zeros((C, M), np.float32)
    labels = np.zeros((C, M), np.int32)
    for c in range(C):
        hot = rng.choice(M, M // 8, replace=False)
        labels[c, hot] = rng.integers(1, 4, hot.size)
        beta[c, hot] = rng.normal(0, 0.05, hot.size)
    return dict(
        J=J, B=B, M=M, nb=nb, X=X, codes=codes,
        mean=dosage.mean(0).astype(np.float32),
        scale=(1.0 / dosage.std(0, ddof=1)).astype(np.float32),
        gram=(Xb @ Xb.transpose(0, 2, 1)).astype(np.float32),
        xsq=(X * X).sum(axis=1, dtype=np.float32),
        eps=rng.standard_normal((C, N)).astype(np.float32),
        beta=beta, labels=labels,
        rho=rng.permutation(NR).astype(np.int32),
        border=rng.permutation(nb).astype(np.int32),
        inner=np.argsort(rng.random((nb, B)), axis=1).astype(np.int32),
        p=rng.random((C, M)).astype(np.float32),
        z=rng.standard_normal((C, M)).astype(np.float32),
        pi=rng.dirichlet([5, 2, 2, 1], (C, G)).astype(np.float32),
        cva=np.tile(CVA.astype(np.float32), (G, 1)),
        sigmaE=rng.uniform(0.5, 1.0, C).astype(np.float32),
        sigmaGG=rng.uniform(0.02, 0.08, (C, G)).astype(np.float32),
        lam=rng.uniform(0.1, 2.0, (C, M)).astype(np.float32),
        tau=rng.uniform(0.01, 0.1, C).astype(np.float32),
        c2=rng.uniform(1.0, 2.0, C).astype(np.float32),
        gas=(np.arange(M) % G).astype(np.int32),
        valid=np.arange(M) < M - 3)


def sweep_args(c, hs, strided, fused):
    """The positional operands of an entry point, numpy: chain 0's for a
    single-chain sweep, all C chains' for a fused one."""
    one = (lambda x: x) if fused else (lambda x: x[0])
    order = c["rho"] if strided else c["border"]
    p, z = one(c["p"]), one(c["z"])
    if not (strided or fused):
        # the single-chain serial sweep reads p/z by sweep position
        p, z = p.reshape(-1), z.reshape(-1)
    head = (c["X"], c["gram"], c["xsq"], one(c["eps"]), one(c["beta"]))
    if hs:
        return head + (order, c["inner"], z, one(c["lam"]), one(c["tau"]),
                       one(c["c2"]), one(c["sigmaE"]), c["valid"])
    return head + (one(c["labels"]), order, c["inner"], p, z, one(c["pi"]),
                   c["cva"], one(c["sigmaE"]), one(c["sigmaGG"]), c["gas"],
                   c["valid"])


def assert_sweeps_close(ref, out):
    """JAX's outputs against the port's: labels (an integer dtype) and v
    exact, the floats to f32 reassociation."""
    for a, b in zip(ref, out):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        if not np.issubdtype(a.dtype, np.floating):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("J,B,G", [(4, 16, 1), (8, 8, 2)])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_dense_sweep_matches_jax(entry, J, B, G):
    port, jfn, hs, strided, fused = ENTRIES[entry]
    c = dense_case(10 * list(ENTRIES).index(entry) + J, J, B, G)
    args = sweep_args(c, hs, strided, fused)
    kw = dict(J=J) if strided else {}
    ref = jfn(*(jnp.asarray(a) for a in args), interpret=True, **kw)
    out = port(*(torch.as_tensor(np.asarray(a)) for a in args), **kw)
    assert out[0].shape == ((C, N) if fused else (N,))
    assert_sweeps_close(ref, out)
    if not hs:
        # v counts every hit: the valid markers the sweep drew into a slab
        # or the spike, each once
        assert float(out[3].sum()) <= c["M"] * (C if fused else 1)


@pytest.mark.parametrize("entry", ["bayesr_jacobi_t", "horseshoe_jacobi_t",
                                   "bayesr_jacobi_t_mc",
                                   "horseshoe_jacobi_t_mc"])
def test_dense_strided_refuses_missing(entry):
    """Missing calls reach the kernels only as 2-bit words (code 3): the
    strided sweeps refuse ``missing=True`` on dense rows, as the JAX
    wrapper does (pallas_jacobi_t.py:_validate)."""
    port, _, hs, strided, fused = ENTRIES[entry]
    c = dense_case(3, 4, 16, 1)
    args = [torch.as_tensor(np.asarray(a))
            for a in sweep_args(c, hs, strided, fused)]
    with pytest.raises(NotImplementedError, match="missing"):
        port(*args, J=4, missing=True)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_int8_codes_still_raise(entry):
    """int8 codes of the same dosages with their means and 1/sd (the int8
    fold mode, ported): the sweep equals the dense sweep of the
    standardized rows (labels and v exact, floats to the 2-bit fold mode's
    rtol 2e-4 / atol 2e-5: the codes decode to the rows up to f32
    rounding)."""
    port, _, hs, strided, fused = ENTRIES[entry]
    c = dense_case(4, 4, 16, 1)
    args = [torch.as_tensor(np.asarray(a))
            for a in sweep_args(c, hs, strided, fused)]
    kw = dict(J=4) if strided else {}
    ref = port(*args, **kw)
    args[0] = torch.as_tensor(c["codes"])
    out = port(*args, x_mean=torch.as_tensor(c["mean"]),
               x_scale=torch.as_tensor(c["scale"]),
               x_xsum=torch.as_tensor(c["X"].sum(axis=1)), fold_affine=True,
               **kw)
    for a, b in zip(ref, out):
        if not a.dtype.is_floating_point or a.shape[-1:] == (4,):
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-5)
