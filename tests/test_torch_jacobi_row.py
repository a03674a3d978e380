"""The port's row-layout block-Jacobi sweeps and round solves
(bayesrrcpp_tpu_torch/ops/jacobi.py) against the JAX package, on the CPU.

The same X, Gram blocks, warm state and JAX-drawn variates (flat block
order and inner permutations from ``block_orders``, p and z) go through

- JAX ``bayesr_jacobi_pallas`` / ``horseshoe_jacobi_pallas`` and
  ``bayesr_round_solve_pallas`` / ``horseshoe_round_solve_pallas`` with
  ``interpret=True``, the TPU kernels run as the JAX tests run them;
- the port's entry points on CPU tensors (their plain versions).

Dense: N=96 x M=128, B=16, the shapes of tests/test_jacobi.py:46-59, with
its tolerances: labels and v exact, beta to rtol 2e-4 / atol 2e-6, eps to
rtol 2e-4 / atol 2e-5 (f32 reassociation: the two sum the dots in other
orders).  Packed: fold-affine 2-bit words of N=1500 individuals padded to
Npad=2048 lanes (JAX keeps eps in its lane order; ``unpermute_eps``).  The
round solves take one round's r and JAX's own ``build_pkg_jacobi``
operands (the port's ``build_pkg_jacobi`` and ``build_pkg_hs_jacobi``
are held to JAX's first, to one f32 rounding).  J=1 of
the row sweep is the serial sweep of ``ops/serial.py``: equal bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu.ops import block_sweep as jbs
from bayesrrcpp_tpu.ops import genotypes as jgen
from bayesrrcpp_tpu.ops import pallas_jacobi as jpj
from bayesrrcpp_tpu_torch.convert import unpermute_eps
from bayesrrcpp_tpu_torch.ops import jacobi, serial
from tests.torch_row_f64 import ROW_HS_F64_ATOL, row_hs_f64

CVA = np.array([0.001, 0.01, 0.1])
B = 16


def _case(seed, N, M, G=1, packed=False):
    """X (dense standardized f32 rows, or the JAX packer's words of a
    dosage), a warm state and JAX-drawn variates, all numpy."""
    rng = np.random.default_rng(seed)
    nb = M // B
    out = {}
    if packed:
        dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M))
        q = jgen.quantize_packed(dosage.astype(float), False, None, B, M, N,
                                 prepacked=False)
        out.update(XT=np.array(q.XT), gram=np.array(q.gram, np.float32),
                   xsq=np.array(q.xsq, np.float32),
                   mean=np.array(q.x_mean, np.float32),
                   scale=np.array(q.x_scale, np.float32),
                   xsum=np.array(q.x_colsum, np.float32),
                   perm=np.asarray(q.n_perm),
                   row_valid_perm=np.asarray(q.row_valid), Npad=q.Npad)
        eps = np.zeros(q.Npad, np.float32)
        eps[:N] = rng.standard_normal(N)
    else:
        XT = rng.standard_normal((M, N)).astype(np.float32)
        out.update(XT=XT, gram=np.array(jbs.gram_blocks(jnp.asarray(XT), B)),
                   xsq=np.sum(XT * XT, axis=1))
        eps = rng.standard_normal(N).astype(np.float32)
    beta = np.zeros(M, np.float32)
    labels = np.zeros(M, np.int32)
    hot = rng.choice(M, M // 8, replace=False)
    labels[hot] = rng.integers(1, 4, hot.size)
    beta[hot] = rng.normal(0, 0.05, hot.size)
    border, inner = jbs.block_orders(jax.random.PRNGKey(seed), nb, B)
    out.update(
        eps=eps, beta=beta, labels=labels, border=np.array(border),
        inner=np.array(inner),
        p=np.array(jax.random.uniform(jax.random.PRNGKey(seed + 1), (M,),
                                      jnp.float32)),
        z=np.array(jax.random.normal(jax.random.PRNGKey(seed + 2), (M,),
                                     jnp.float32)),
        pi=rng.dirichlet([5, 2, 2, 1], G).astype(np.float32),
        cva=np.tile(CVA.astype(np.float32), (G, 1)), sigmaE=np.float32(0.8),
        sigmaGG=np.linspace(0.03, 0.08, G).astype(np.float32),
        lam=rng.uniform(0.1, 2.0, M).astype(np.float32),
        tau=np.float32(0.05), c2=np.float32(1.5),
        gas=(np.arange(M) % G).astype(np.int32),
        valid=np.arange(M) < M - 3)          # a few invalid pad markers
    return out


BAYESR = ("beta", "labels", "border", "inner", "p", "z", "pi", "cva",
          "sigmaE", "sigmaGG", "gas", "valid")
HS = ("beta", "border", "inner", "z", "lam", "tau", "c2", "sigmaE", "valid")


def _args(c, names, mod):
    a = torch.as_tensor if mod is torch else jnp.asarray
    eps = c["eps"] if mod is torch or "perm" not in c else c["eps"][c["perm"]]
    return [a(c[k]) for k in ("XT", "gram", "xsq")] + [a(eps)] + [
        a(c[k]) for k in names]


def _kw(c, mod, J):
    """The storage keywords: none for dense rows, the fold mode for
    words (JAX's row mask in its lane order)."""
    if "mean" not in c:
        return dict(J=J)
    a = torch.as_tensor if mod is torch else jnp.asarray
    rv = (torch.arange(c["Npad"]) < c["N"] if mod is torch
          else jnp.asarray(c["row_valid_perm"]))
    return dict(J=J, x_mean=a(c["mean"]), x_scale=a(c["scale"]),
                x_xsum=a(c["xsum"]), fold_affine=True, row_valid=rv)


def _eps(c, eps):
    eps = np.asarray(eps)
    return unpermute_eps(eps, c["Npad"]) if "perm" in c else eps


def _assert_bayesr_equal(c, ker, out):
    np.testing.assert_array_equal(np.asarray(ker.labels), out.labels.numpy())
    np.testing.assert_array_equal(np.asarray(ker.v), out.v.numpy())
    assert (out.labels != torch.as_tensor(c["labels"])).any()
    np.testing.assert_allclose(np.asarray(ker.beta), out.beta.numpy(),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(_eps(c, ker.eps), out.eps.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(ker.beta_acum),
                               out.beta_acum.numpy(), rtol=1e-4, atol=1e-6)


def _packed_case(seed, G=1):
    c = _case(seed, 1500, 128, G, packed=True)
    c["N"] = 1500
    return c


@pytest.mark.parametrize("J,G,packed", [(2, 3, False), (4, 1, False),
                                        (8, 1, False), (4, 2, True)])
def test_bayesr_row_sweep_matches_jax_kernel(J, G, packed):
    c = _packed_case(21 + J, G) if packed else _case(21 + J, 96, 128, G)
    before = jacobi.bayesr_jacobi.launches
    out = jacobi.bayesr_jacobi(*_args(c, BAYESR, torch), **_kw(c, torch, J))
    assert jacobi.bayesr_jacobi.launches == before   # CPU: the plain version
    ref = jacobi.bayesr_jacobi_reference(*_args(c, BAYESR, torch),
                                         **_kw(c, torch, J))
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    ker = jpj.bayesr_jacobi_pallas(*_args(c, BAYESR, jnp), interpret=True,
                                   **_kw(c, jnp, J))
    _assert_bayesr_equal(c, ker, out)
    if packed:
        assert (out.eps[c["N"]:] == 0).all()


@pytest.mark.parametrize("J,packed", [(2, False), (4, False), (4, True)])
def test_horseshoe_row_sweep_matches_jax_kernel(J, packed):
    c = _packed_case(51 + J) if packed else _case(51 + J, 96, 128)
    before = jacobi.horseshoe_jacobi.launches
    eps, beta = jacobi.horseshoe_jacobi(*_args(c, HS, torch),
                                        **_kw(c, torch, J))
    assert jacobi.horseshoe_jacobi.launches == before
    e_k, b_k = jpj.horseshoe_jacobi_pallas(*_args(c, HS, jnp), interpret=True,
                                           **_kw(c, jnp, J))
    np.testing.assert_allclose(np.asarray(b_k), beta.numpy(), rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_allclose(_eps(c, e_k), eps.numpy(), rtol=2e-4,
                               atol=2e-5)


def _round(c, J, r_round):
    """Round ``r_round``'s solve operands from a sweep case: r against the
    case's eps (dense rows), the rounds' Gram blocks and state, and JAX's
    build_pkg_jacobi / build_pkg_hs_jacobi operands next to the port's."""
    bsel = c["border"].reshape(-1, J)[r_round]
    rows = (bsel[:, None] * B + np.arange(B)).reshape(-1)
    r = (c["XT"][rows] @ c["eps"]).astype(np.float32).reshape(J, B)
    j = {k: jnp.asarray(c[k]) for k in ("xsq", "gas", "valid", "p", "z",
                                        "pi", "cva", "sigmaGG", "border",
                                        "inner", "lam")}
    t = {k: torch.as_tensor(np.array(v)) for k, v in j.items()}
    pkg_j, inn_j = jpj.build_pkg_jacobi(
        j["xsq"], j["gas"], j["valid"], j["p"], j["z"], j["pi"], j["cva"],
        jnp.float32(c["sigmaE"]), j["sigmaGG"], j["border"], j["inner"], B=B,
        J=J)
    pkg_t, inn_t = jacobi.build_pkg_jacobi(
        t["xsq"], t["gas"], t["valid"], t["p"], t["z"], t["pi"], t["cva"],
        torch.tensor(c["sigmaE"]), t["sigmaGG"], t["border"], t["inner"],
        B=B, J=J)
    hs_j, _ = jpj.build_pkg_hs_jacobi(
        j["xsq"], j["valid"], j["z"], j["lam"], jnp.float32(c["tau"]),
        jnp.float32(c["c2"]), jnp.float32(c["sigmaE"]), j["border"],
        j["inner"], B=B, J=J)
    hs_t, _ = jacobi.build_pkg_hs_jacobi(
        t["xsq"], t["valid"], t["z"], t["lam"], torch.tensor(c["tau"]),
        torch.tensor(c["c2"]), torch.tensor(c["sigmaE"]), t["border"],
        t["inner"], B=B, J=J)
    assert torch.equal(torch.as_tensor(np.array(inn_j)), inn_t)
    for a, b in ((pkg_j, pkg_t), (hs_j, hs_t)):
        # to one f32 rounding: XLA's fused 1/denom may round an entry apart
        torch.testing.assert_close(torch.as_tensor(np.array(a)), b,
                                   rtol=1e-6, atol=0)
    return dict(r=r, gram=c["gram"][bsel], beta=c["beta"][rows].reshape(J, B),
                labels=c["labels"][rows].reshape(J, B),
                gas=c["gas"][rows].reshape(J, B),
                inner=np.asarray(inn_j)[r_round],
                pkg=np.asarray(pkg_j)[r_round], hs=np.asarray(hs_j)[r_round])


@pytest.mark.parametrize("J,G", [(2, 3), (8, 1)])
def test_round_solves_match_jax_kernels(J, G):
    c = _case(71 + J, 96, 128, G)
    rd = _round(c, J, 128 // B // J - 1)          # the last round
    a = {k: torch.as_tensor(np.array(v)) for k, v in rd.items()}
    before = jacobi.bayesr_round_solve.launches
    out = jacobi.bayesr_round_solve(
        a["r"], a["gram"], a["beta"], a["labels"], a["gas"], a["inner"],
        a["pkg"], torch.tensor(c["sigmaE"]), K=4, G=G)
    assert jacobi.bayesr_round_solve.launches == before
    ker = jpj.bayesr_round_solve_pallas(
        *(jnp.asarray(rd[k]) for k in ("r", "gram", "beta", "labels", "gas",
                                       "inner", "pkg")),
        jnp.float32(c["sigmaE"]), K=4, G=G, interpret=True)
    np.testing.assert_array_equal(np.asarray(ker[2]), out[2].numpy())
    np.testing.assert_array_equal(np.asarray(ker[3]), out[3].numpy())
    assert (out[2] != a["labels"]).any()
    for i in (0, 1):
        np.testing.assert_allclose(np.asarray(ker[i]), out[i].numpy(),
                                   rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(ker[4]), out[4].numpy(), rtol=1e-4,
                               atol=1e-6)
    d, beta = jacobi.horseshoe_round_solve(a["r"], a["gram"], a["beta"],
                                           a["inner"], a["hs"])
    dk, bk = jpj.horseshoe_round_solve_pallas(
        *(jnp.asarray(rd[k]) for k in ("r", "gram", "beta", "inner", "hs")),
        interpret=True)
    np.testing.assert_allclose(np.asarray(dk), d.numpy(), rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(bk), beta.numpy(), rtol=2e-4,
                               atol=2e-6)


@pytest.mark.parametrize("packed", [False, True])
def test_row_sweep_at_one_block_is_the_serial_sweep(packed):
    """J=1: one block a round against the eps its predecessor left, sum(eps)
    tracked from the start (one serial chunk): the serial plain sweep's
    operations on the same shapes, so the outputs are equal bitwise."""
    c = _packed_case(81) if packed else _case(81, 96, 128)
    kw = _kw(c, torch, 1)
    row = jacobi.bayesr_jacobi(*_args(c, BAYESR, torch), **kw)
    kw.pop("J")
    ser = serial.bayesr_sweep(*_args(c, BAYESR, torch), **kw)
    for x, y in zip(row, ser):
        assert torch.equal(x, y)
    eps_r, beta_r = jacobi.horseshoe_jacobi(*_args(c, HS, torch),
                                            **_kw(c, torch, 1))
    eps_s, beta_s = serial.horseshoe_sweep(*_args(c, HS, torch), **kw)
    assert torch.equal(eps_r, eps_s) and torch.equal(beta_r, beta_s)


def test_row_sweep_refusals():
    """What the TPU wrapper refuses; and the int8 mode (sites #15/#16,
    ported): int8 codes of the same dosages run and equal the packed row
    sweep (labels and v exact, beta to rtol 2e-4 / atol 2e-6, eps to rtol
    2e-4 / atol 2e-5: the packed dots also run over the pad lanes)."""
    c = _packed_case(91)
    kw = _kw(c, torch, 4)
    args = _args(c, BAYESR, torch)
    with pytest.raises(ValueError, match="J | nb"):
        jacobi.bayesr_jacobi(*args, **dict(kw, J=3))
    with pytest.raises(ValueError, match="fold-affine"):
        jacobi.bayesr_jacobi(*args, **dict(kw, fold_affine=False))
    from bayesrrcpp_tpu_torch.ops import genotypes

    N = c["N"]
    ref = jacobi.bayesr_jacobi(*args, **kw)
    codes = genotypes.decode_codes(args[0])[:, :N].to(torch.int8)
    out = jacobi.bayesr_jacobi(codes, *args[1:3], args[3][:N], *args[4:],
                               **{k: v for k, v in kw.items()
                                  if k != "row_valid"})
    assert torch.equal(ref.labels, out.labels) and torch.equal(ref.v, out.v)
    torch.testing.assert_close(out.beta, ref.beta, rtol=2e-4, atol=2e-6)
    torch.testing.assert_close(out.eps, ref.eps[:N], rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def n1500():
    """The words, state and variates of the (16, 512, 2), N=1,500 row
    horseshoe case (lam aside)."""
    J, Bw, nr, N = 16, 512, 2, 1500
    M = J * Bw * nr
    rng = np.random.default_rng(2028)
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M))
    q = jgen.quantize_packed(dosage.astype(float), False, None, Bw, M, N,
                             prepacked=False)
    eps = np.zeros(q.Npad, np.float32)
    eps[:N] = rng.standard_normal(N)
    beta = np.zeros(M, np.float32)
    hot = rng.choice(M, M // 8, replace=False)
    beta[hot] = rng.normal(0, 0.05, hot.size)
    border, inner = jbs.block_orders(jax.random.PRNGKey(5), J * nr, Bw)
    return dict(
        J=J, N=N, M=M, q=q, eps=eps, perm=np.asarray(q.n_perm),
        XT=np.array(q.XT), gram=np.array(q.gram, np.float32),
        xsq=np.array(q.xsq, np.float32), beta=beta, border=np.array(border),
        inner=np.array(inner),
        z=np.array(jax.random.normal(jax.random.PRNGKey(6), (M,),
                                     jnp.float32)),
        stats=[np.array(x, np.float32)
               for x in (q.x_mean, q.x_scale, q.x_colsum)])


@pytest.mark.parametrize("lam_seed", range(4))
def test_row_horseshoe_at_n1500_against_jax_and_float64(n1500, lam_seed):
    """The row-layout horseshoe at (J, B, nr) = (16, 512, 2) on fold-affine
    words of N=1,500 individuals (M=16,384; the case tests/test_torch_cuda
    .py runs on the card), four random lam: the plain version, JAX's
    ``horseshoe_jacobi_pallas`` in interpret mode and the same sweep in
    float64 (``tests/torch_row_f64.row_hs_f64``) on the same operands and
    variates.  With 8,192 markers a round all moving and N far under M,
    the first round overshoots (max |eps| ~ 70) and the fold's r = s
    (C.eps) - m s sum(eps) cancels large terms, so the two f32 sides part
    by more than this file's elementwise tolerances (up to 8.8e-6 in beta,
    7.5e-4 in eps) while each lies as close to the float64 step as the
    other.  So each f32 side is held elementwise to the float64 step
    (``ROW_HS_F64_ATOL``), and the two to each other within twice that."""
    c = n1500
    J, N, M, q, eps, perm = (c[k] for k in ("J", "N", "M", "q", "eps",
                                            "perm"))
    common = dict(c, lam=np.random.default_rng(100 + lam_seed).uniform(
        0.1, 2.0, M).astype(np.float32))
    names = ("XT", "gram", "xsq", "beta", "border", "inner", "z", "lam")
    scal = (np.float32(0.05), np.float32(1.5), np.float32(0.8))
    valid = np.arange(M) < M - 3
    stats = c["stats"]
    t = {k: torch.as_tensor(common[k]) for k in names}
    kw_t = dict(J=J, x_mean=torch.as_tensor(stats[0]),
                x_scale=torch.as_tensor(stats[1]),
                x_xsum=torch.as_tensor(stats[2]), fold_affine=True,
                row_valid=torch.arange(q.Npad) < N)
    args_t = (t["XT"], t["gram"], t["xsq"], torch.as_tensor(eps), t["beta"],
              t["border"], t["inner"], t["z"], t["lam"],
              *(torch.tensor(x) for x in scal), torch.as_tensor(valid))
    eps_p, beta_p = jacobi.horseshoe_jacobi_reference(*args_t, **kw_t)
    j = {k: jnp.asarray(common[k]) for k in names}
    eps_k, beta_k = jpj.horseshoe_jacobi_pallas(
        j["XT"], j["gram"], j["xsq"], jnp.asarray(eps[perm]), j["beta"],
        j["border"], j["inner"], j["z"], j["lam"], *scal,
        jnp.asarray(valid), J=J, interpret=True,
        x_mean=jnp.asarray(stats[0]), x_scale=jnp.asarray(stats[1]),
        x_xsum=jnp.asarray(stats[2]), fold_affine=True,
        row_valid=jnp.asarray(q.row_valid))
    eps_k = torch.as_tensor(unpermute_eps(np.asarray(eps_k), q.Npad))
    beta_k = torch.as_tensor(np.asarray(beta_k))
    eps_64, beta_64 = row_hs_f64(args_t, kw_t)

    tol = ROW_HS_F64_ATOL
    for side, (e, b) in (("plain", (eps_p, beta_p)),
                         ("jax", (eps_k, beta_k))):
        torch.testing.assert_close(e.double(), eps_64, rtol=0,
                                   atol=tol["eps"], msg=side)
        torch.testing.assert_close(b.double(), beta_64, rtol=0,
                                   atol=tol["beta"], msg=side)
    torch.testing.assert_close(eps_p, eps_k, rtol=0, atol=2 * tol["eps"])
    torch.testing.assert_close(beta_p, beta_k, rtol=0, atol=2 * tol["beta"])
    assert (eps_p[N:] == 0).all()
