"""The port's strided-rounds sweep (bayesrrcpp_tpu_torch/ops/jacobi_t.py)
against the JAX package, on the CPU.

The same packed words, Gram blocks, warm state and variates (rho, inner,
p, z), made with numpy from a seed, go through

- JAX ``bayesr_jacobi_t_pallas(..., interpret=True, fold_affine=True)``,
  the TPU kernel run as the JAX tests run it;
- JAX ``block_sweep.bayesr_jacobi_sweep``, the plain oracle, through
  ``strided_border`` and the visit-order re-indexing of p/z (``_visit``);
- the port's ``bayesr_jacobi_t`` on CPU tensors (its plain version).

Tolerances are those of tests/test_jacobi_t.py:49-58: labels and v exact,
floats to f32 reassociation (the three sum the dots in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu.ops import block_sweep as jbs
from bayesrrcpp_tpu.ops import genotypes as jgen
from bayesrrcpp_tpu.ops.pallas_jacobi_t import bayesr_jacobi_t_pallas
from bayesrrcpp_tpu_torch.convert import unpermute_eps
from bayesrrcpp_tpu_torch.ops import block_sweep as tbs
from bayesrrcpp_tpu_torch.ops.jacobi_t import (bayesr_jacobi_t,
                                               bayesr_jacobi_t_reference)

CVA = np.array([0.001, 0.01, 0.1])
N = 1500          # pads to Npad = 2048: the pad lanes are exercised


def _visit(arr, rho, J, B):
    """Canonical-slab-assigned position stream as seen in visit order."""
    nr = rho.shape[0]
    return arr.reshape(nr, J * B)[rho].reshape(-1)


def _case(seed, J, B, G, nr):
    """Packed data (via the JAX host packer) plus a warm state and
    variates, all numpy."""
    rng = np.random.default_rng(seed)
    nb = J * nr
    M = nb * B
    freqs = rng.uniform(0.1, 0.9, M)
    dosage = rng.binomial(2, freqs, size=(N, M)).astype(float)
    q = jgen.quantize_packed(dosage, False, None, B, M, N, prepacked=False)
    Npad = q.Npad
    perm = np.asarray(q.n_perm)
    eps_nat = np.zeros(Npad, np.float32)
    eps_nat[:N] = rng.standard_normal(N).astype(np.float32)
    beta = np.zeros(M, np.float32)
    labels = np.zeros(M, np.int32)
    hot = rng.choice(M, M // 10, replace=False)
    labels[hot] = rng.integers(1, 4, hot.size)
    beta[hot] = rng.normal(0, 0.05, hot.size).astype(np.float32)
    return dict(
        M=M, Npad=Npad,
        words=np.array(q.XT), gram=np.array(q.gram, np.float32),
        xsq=np.array(q.xsq, np.float32),
        mean=np.array(q.x_mean, np.float32),
        scale=np.array(q.x_scale, np.float32),
        colsum=np.array(q.x_colsum, np.float32),
        eps_nat=eps_nat, eps_perm=eps_nat[perm],
        row_valid_perm=np.asarray(q.row_valid),
        beta=beta, labels=labels,
        rho=rng.permutation(nr).astype(np.int32),
        inner=np.argsort(rng.random((nb, B)), axis=1).astype(np.int32),
        p=rng.random(M).astype(np.float32),
        z=rng.standard_normal(M).astype(np.float32),
        pi=rng.dirichlet([5, 2, 2, 1], G).astype(np.float32),
        cva=np.tile(CVA.astype(np.float32), (G, 1)),
        sigmaE=np.float32(0.8),
        sigmaGG=np.linspace(0.03, 0.08, G).astype(np.float32),
        gas=(np.arange(M) % G).astype(np.int32),
        valid=np.arange(M) < M - 3,         # a few invalid pad markers
        codes=jgen.pack_codes_host(dosage, False, None, M, N)[0])


def _jax_pallas(c, J):
    a = lambda x: jnp.asarray(x)                               # noqa: E731
    return bayesr_jacobi_t_pallas(
        a(c["words"]), a(c["gram"]), a(c["xsq"]), a(c["eps_perm"]),
        a(c["beta"]), a(c["labels"]), a(c["rho"]), a(c["inner"]), a(c["p"]),
        a(c["z"]), a(c["pi"]), a(c["cva"]), jnp.float32(c["sigmaE"]),
        a(c["sigmaGG"]), a(c["gas"]), a(c["valid"]), J=J, interpret=True,
        x_mean=a(c["mean"]), x_scale=a(c["scale"]), x_xsum=a(c["colsum"]),
        fold_affine=True, row_valid=a(c["row_valid_perm"]))


def _dense(c):
    """Standardized (M, N) X in individual order, from the codes."""
    x = (c["codes"][:, :N].astype(np.float32) - c["mean"][:, None]) \
        * c["scale"][:, None]
    return x.astype(np.float32)


def _torch_args(c):
    t = torch.as_tensor
    return (t(c["words"]), t(c["gram"]), t(c["xsq"]), t(c["eps_nat"]),
            t(c["beta"]), t(c["labels"]), t(c["rho"]), t(c["inner"]),
            t(c["p"]), t(c["z"]), t(c["pi"]), t(c["cva"]),
            t(c["sigmaE"]), t(c["sigmaGG"]), t(c["gas"]), t(c["valid"]))


def _torch_kw(c, J):
    return dict(J=J, x_mean=torch.as_tensor(c["mean"]),
                x_scale=torch.as_tensor(c["scale"]),
                x_xsum=torch.as_tensor(c["colsum"]), fold_affine=True,
                row_valid=torch.arange(c["Npad"]) < N)


def _assert_sweeps_equal(ref, out, *, eps_ref, eps_out):
    np.testing.assert_array_equal(np.asarray(ref.labels),
                                  np.asarray(out.labels))
    np.testing.assert_array_equal(np.asarray(ref.v), np.asarray(out.v))
    np.testing.assert_allclose(np.asarray(ref.beta), np.asarray(out.beta),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(eps_ref, eps_out, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ref.beta_acum),
                               np.asarray(out.beta_acum), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("J,B,G", [(4, 16, 1), (16, 32, 1), (16, 32, 3)])
def test_sweep_matches_jax_kernel_and_oracle(J, B, G):
    c = _case(100 + J + G, J, B, G, nr=4)
    before = bayesr_jacobi_t.launches
    out = bayesr_jacobi_t(*_torch_args(c), **_torch_kw(c, J))
    assert bayesr_jacobi_t.launches == before     # CPU: the plain version
    eps_out = out.eps.numpy()
    np.testing.assert_array_equal(eps_out[N:], 0.0)   # pad lanes stay 0

    ker = _jax_pallas(c, J)
    _assert_sweeps_equal(ker, out,
                         eps_ref=unpermute_eps(np.asarray(ker.eps), c["Npad"]),
                         eps_out=eps_out)

    a = lambda x: jnp.asarray(x)                               # noqa: E731
    orc = jbs.bayesr_jacobi_sweep(
        a(_dense(c)), a(c["gram"]), a(c["xsq"]), a(c["eps_nat"][:N]),
        a(c["beta"]), a(c["labels"]),
        jbs.strided_border(a(c["rho"]), J), a(c["inner"]),
        a(_visit(c["p"], c["rho"], J, B)), a(_visit(c["z"], c["rho"], J, B)),
        a(c["pi"]), a(c["cva"]), jnp.float32(c["sigmaE"]), a(c["sigmaGG"]),
        a(c["gas"]), a(c["valid"]), J=J)
    _assert_sweeps_equal(orc, out, eps_ref=np.asarray(orc.eps),
                         eps_out=eps_out[:N])


def test_reference_is_what_the_wrapper_runs_on_cpu():
    c = _case(7, 4, 16, 1, nr=4)
    a = bayesr_jacobi_t(*_torch_args(c), **_torch_kw(c, 4))
    b = bayesr_jacobi_t_reference(*_torch_args(c), **_torch_kw(c, 4))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_port_jacobi_oracle_matches_jax_oracle():
    """The port's plain block-Jacobi oracle (ops/block_sweep.py) on dense
    X against the JAX one, same visit order and variates."""
    J, B = 4, 16
    c = _case(11, J, B, 2, nr=2)
    border = np.array(jbs.strided_border(jnp.asarray(c["rho"]), J))
    pv = _visit(c["p"], c["rho"], J, B)
    zv = _visit(c["z"], c["rho"], J, B)
    X = _dense(c)
    common = (c["gram"], c["xsq"], c["eps_nat"][:N], c["beta"], c["labels"],
              border, c["inner"], pv, zv, c["pi"], c["cva"],
              np.float32(c["sigmaE"]), c["sigmaGG"], c["gas"], c["valid"])
    ref = jbs.bayesr_jacobi_sweep(jnp.asarray(X),
                                  *[jnp.asarray(x) for x in common], J=J)
    t = [torch.as_tensor(x) for x in (X,) + common]
    t[6], t[7] = t[6].long(), t[7].long()
    out = tbs.bayesr_jacobi_sweep(*t, J=J)
    _assert_sweeps_equal(ref, out, eps_ref=np.asarray(ref.eps),
                         eps_out=out.eps.numpy())


def test_strided_border_matches_jax():
    rho = np.random.default_rng(3).permutation(6).astype(np.int32)
    ref = np.asarray(jbs.strided_border(jnp.asarray(rho), 4))
    out = tbs.strided_border(torch.as_tensor(rho), 4).numpy()
    np.testing.assert_array_equal(ref, out)


@pytest.mark.parametrize("bad", ["dense", "no_fold"])
def test_modes_outside_the_slice_raise(bad):
    """Dense rows run (tests/test_torch_dense.py) but take no missing calls;
    int8 codes of the same dosages run (site #1's int8 mode, ported) and
    equal the packed sweep (tolerances of ``_assert_sweeps_equal``: the
    packed dots also run over the pad lanes); packed words need the fold or
    the miss mode."""
    c = _case(5, 4, 16, 1, nr=2)
    args = list(_torch_args(c))
    kw = _torch_kw(c, 4)
    if bad == "dense":
        dense = list(args)
        dense[0] = torch.as_tensor(_dense(c))
        dense[3] = dense[3][:N]
        with pytest.raises(NotImplementedError, match="missing"):
            bayesr_jacobi_t(*dense, J=4, missing=True)
        ref = bayesr_jacobi_t(*args, **kw)
        args[0] = torch.as_tensor(c["codes"][:, :N]).to(torch.int8)
        args[3] = args[3][:N]
        out = bayesr_jacobi_t(*args, **{k: v for k, v in kw.items()
                                        if k != "row_valid"})
        _assert_sweeps_equal(ref, out, eps_ref=ref.eps[:N].numpy(),
                             eps_out=out.eps.numpy())
    else:
        kw["fold_affine"] = False
        with pytest.raises(ValueError):
            bayesr_jacobi_t(*args, **kw)
