"""The int8 mode of the port's sweep entry points against the JAX package,
on the CPU.

int8 genotype codes {0, 1, 2, 3 = missing} (M, N), one byte per genotype,
with the statistics of JAX ``quantize_int8`` (pad-free: N individuals, no
lane mask), a warm state and variates, made with numpy from a seed, go
through the JAX wrapper run in interpret mode, as the JAX package's own
tests run it (tests/test_jacobi_t.py:149, tests/test_multichain.py:143,
tests/test_pallas.py:101, tests/test_jacobi.py:88), and through the port's
entry point on CPU tensors (its plain version):

- sites #1-#4, #7, #8: the strided sweeps ``bayesr_jacobi_t`` /
  ``horseshoe_jacobi_t`` and their fused ``_mc`` versions at C=3 and C=6
  (the JAX wrapper's ``_mc8`` kernels above 4 chains);
- sites #9-#12: the serial sweeps ``bayesr_sweep`` / ``horseshoe_sweep``
  (fold and, on codes with missing calls, the in-kernel decode ``_q``)
  and their fused versions at C=3;
- sites #15/#16: the row-layout sweeps ``bayesr_jacobi`` /
  ``horseshoe_jacobi`` at two (J, B).

Sites #5/#6 (the chunks of rounds) are held in tests/test_torch_rounds.py's
int8 cases.  N=512 and N=150 (N % 16 != 0).  Tolerances are the 2-bit fold
mode's (tests/test_torch_serial.py, tests/test_torch_multichain.py):
labels and v exact; beta to rtol 2e-4 / atol 2e-6, eps to rtol 2e-4 /
atol 2e-5, beta_acum to rtol 1e-4 / atol 1e-6 for one chain, rtol 3e-4
for fused chains (JAX dots the raw codes and folds the standardization
after, the plain versions dot the decoded rows: f32 reassociation).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu.ops import genotypes as jgen
from bayesrrcpp_tpu.ops import pallas_jacobi as jpj
from bayesrrcpp_tpu.ops import pallas_jacobi_t as jpt
from bayesrrcpp_tpu.ops import pallas_multichain as jpm
from bayesrrcpp_tpu.ops import pallas_sweep as jps
from bayesrrcpp_tpu_torch.ops import jacobi, jacobi_t, multichain, serial

CVA = np.array([0.001, 0.01, 0.1])
NR = 2      # rounds per strided sweep

# entry point -> (port function, JAX function, horseshoe, kind, fused);
# kind: "t" strided rounds, "serial" (J=1), "row" (J blocks a round)
ENTRIES = {
    "bayesr_jacobi_t": (jacobi_t.bayesr_jacobi_t, jpt.bayesr_jacobi_t_pallas,
                        False, "t", False),
    "horseshoe_jacobi_t": (jacobi_t.horseshoe_jacobi_t,
                           jpt.horseshoe_jacobi_t_pallas, True, "t", False),
    "bayesr_jacobi_t_mc": (jacobi_t.bayesr_jacobi_t_mc,
                           jpt.bayesr_jacobi_t_pallas_mc, False, "t", True),
    "horseshoe_jacobi_t_mc": (jacobi_t.horseshoe_jacobi_t_mc,
                              jpt.horseshoe_jacobi_t_pallas_mc, True, "t",
                              True),
    "bayesr_sweep": (serial.bayesr_sweep, jps.bayesr_sweep_pallas, False,
                     "serial", False),
    "horseshoe_sweep": (serial.horseshoe_sweep, jps.horseshoe_sweep_pallas,
                        True, "serial", False),
    "bayesr_sweep_mc": (multichain.bayesr_sweep_mc,
                        jpm.bayesr_sweep_pallas_mc, False, "serial", True),
    "horseshoe_sweep_mc": (multichain.horseshoe_sweep_mc,
                           jpm.horseshoe_sweep_pallas_mc, True, "serial",
                           True),
    "bayesr_jacobi": (jacobi.bayesr_jacobi, jpj.bayesr_jacobi_pallas, False,
                      "row", False),
    "horseshoe_jacobi": (jacobi.horseshoe_jacobi, jpj.horseshoe_jacobi_pallas,
                         True, "row", False),
}


def int8_case(seed, J, B, G, N, C, missing=False):
    """int8 codes (M, N) with JAX ``quantize_int8``'s statistics and a warm
    state of C chains with variates, all numpy; nb = J*NR blocks of B
    markers.  ``missing``: 5 % of the calls are missing (code 3)."""
    rng = np.random.default_rng(seed)
    nb = J * NR
    M = nb * B
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M),
                          size=(N, M)).astype(float)
    if missing:
        dosage[rng.random(dosage.shape) < 0.05] = np.nan
    q = jgen.quantize_int8(dosage, False, None, B, M)
    assert q.has_missing == missing
    beta = np.zeros((C, M), np.float32)
    labels = np.zeros((C, M), np.int32)
    for c in range(C):
        hot = rng.choice(M, M // 8, replace=False)
        labels[c, hot] = rng.integers(1, 4, hot.size)
        beta[c, hot] = rng.normal(0, 0.05, hot.size)
    return dict(
        M=M, N=N, C=C, missing=missing, codes=np.array(q.XT),
        gram=np.array(q.gram), xsq=np.array(q.xsq),
        mean=np.array(q.x_mean), scale=np.array(q.x_scale),
        colsum=np.array(q.x_colsum),
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


def sweep_args(c, hs, kind, fused):
    """The positional operands of an entry point, numpy: chain 0's for a
    single-chain sweep, all C chains' for a fused one."""
    one = (lambda x: x) if fused else (lambda x: x[0])
    order = c["rho"] if kind == "t" else c["border"]
    p, z = one(c["p"]), one(c["z"])
    if kind != "t" and not fused:
        # the single-chain serial and row sweeps read p/z by sweep position
        p, z = p.reshape(-1), z.reshape(-1)
    head = (c["codes"], c["gram"], c["xsq"], one(c["eps"]), one(c["beta"]))
    if hs:
        return head + (order, c["inner"], z, one(c["lam"]), one(c["tau"]),
                       one(c["c2"]), one(c["sigmaE"]), c["valid"])
    return head + (one(c["labels"]), order, c["inner"], p, z, one(c["pi"]),
                   c["cva"], one(c["sigmaE"]), one(c["sigmaGG"]), c["gas"],
                   c["valid"])


def storage_kw(c, lib):
    """The int8 storage keywords, as ``lib`` arrays (jnp or torch)."""
    a = jnp.asarray if lib is jnp else torch.as_tensor
    return dict(x_mean=a(c["mean"]), x_scale=a(c["scale"]),
                x_xsum=a(c["colsum"]), fold_affine=not c["missing"])


def assert_int8_close(ref, out, fused):
    """JAX's outputs against the port's: integer outputs (labels) and v
    exact, the floats to the 2-bit fold mode's tolerances."""
    r = 3e-4 if fused else 2e-4
    tol = [(r, 2e-5), (r, 2e-6), None, None, (3e-4 if fused else 1e-4, 1e-6)]
    for i, (a, b) in enumerate(zip(ref, out)):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        if i in (2, 3) or not np.issubdtype(a.dtype, np.floating):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=tol[i][0], atol=tol[i][1])


def run_both(entry, c, J):
    port, jfn, hs, kind, fused = ENTRIES[entry]
    args = sweep_args(c, hs, kind, fused)
    jkw = dict(J=J) if kind != "serial" else {}
    ref = jfn(*(jnp.asarray(a) for a in args), interpret=True,
              **storage_kw(c, jnp), **jkw)
    out = port(*(torch.as_tensor(np.asarray(a)) for a in args),
               **storage_kw(c, torch), **jkw)
    return ref, out


@pytest.mark.parametrize("N", [512, 150])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_int8_sweep_matches_jax(entry, N):
    _, _, hs, kind, fused = ENTRIES[entry]
    J, B = (4, 16) if kind != "row" or N == 512 else (2, 32)
    c = int8_case(10 * list(ENTRIES).index(entry) + N, J, B, 2, N, 3)
    ref, out = run_both(entry, c, J)
    assert out[0].shape == ((3, N) if fused else (N,))
    assert_int8_close(ref, out, fused)
    if not hs:
        assert float(out[3].sum()) <= c["M"] * (3 if fused else 1)


@pytest.mark.parametrize("entry", ["bayesr_jacobi_t_mc",
                                   "horseshoe_jacobi_t_mc"])
def test_int8_mc8_matches_jax(entry):
    """C=6: the JAX wrapper's ``_mc8`` kernels (sites #7/#8)."""
    c = int8_case(7, 4, 16, 1, 150, 6)
    ref, out = run_both(entry, c, 4)
    assert_int8_close(ref, out, True)


@pytest.mark.parametrize("N", [512, 150])
@pytest.mark.parametrize("entry", ["bayesr_sweep", "horseshoe_sweep"])
def test_int8_in_kernel_decode_matches_jax(entry, N):
    """Codes with missing calls: the serial ``_q`` mode (fold_affine=False),
    x = (c - mean)*scale and 0 for code 3."""
    c = int8_case(30 + N, 4, 16, 2, N, 1, missing=True)
    assert (c["codes"] == 3).any()
    ref, out = run_both(entry, c, 1)
    assert_int8_close(ref, out, False)


@pytest.mark.parametrize("entry", ["bayesr_sweep_mc", "bayesr_jacobi",
                                   "bayesr_jacobi_t"])
def test_int8_refusals(entry):
    """What the JAX wrappers refuse on int8 codes, the port refuses: the
    in-kernel decode in a fused or row sweep, and ``missing=True`` in the
    strided one (int8 with missing calls runs the serial ``_q`` sweep)."""
    port, _, hs, kind, fused = ENTRIES[entry]
    c = int8_case(3, 4, 16, 1, 150, 3, missing=True)
    args = [torch.as_tensor(np.asarray(a))
            for a in sweep_args(c, hs, kind, fused)]
    kw = storage_kw(c, torch)
    if kind != "serial":
        kw["J"] = 4
    if kind == "t":
        kw["missing"] = True
    with pytest.raises((ValueError, NotImplementedError)):
        port(*args, **kw)


def test_int8_fused_chain_is_the_single_chain():
    """Chain c of a fused plain sweep equals the single-chain plain sweep
    on chain c's operands (p/z remapped to position order)."""
    c = int8_case(5, 4, 16, 1, 150, 3)
    one = serial.bayesr_sweep
    fused = multichain.bayesr_sweep_mc(
        *(torch.as_tensor(np.asarray(a))
          for a in sweep_args(c, False, "serial", True)),
        **storage_kw(c, torch))
    at = serial.position_markers(torch.as_tensor(c["border"]),
                                 torch.as_tensor(c["inner"]), 16).numpy()
    chain_keys = ("eps", "beta", "labels", "p", "z", "pi", "sigmaE",
                  "sigmaGG")
    for ch in range(3):
        cc = dict(c, **{k: c[k][ch:ch + 1] for k in chain_keys})
        cc["p"], cc["z"] = cc["p"][:, at], cc["z"][:, at]
        res = one(*(torch.as_tensor(np.asarray(a))
                    for a in sweep_args(cc, False, "serial", False)),
                  **storage_kw(c, torch))
        torch.testing.assert_close(res.beta, fused.beta[ch], rtol=1e-5,
                                   atol=1e-7)
        torch.testing.assert_close(res.eps, fused.eps[ch], rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(res.labels, fused.labels[ch])
