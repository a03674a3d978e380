"""The port's strided-rounds horseshoe sweep and plain horseshoe sweeps
(bayesrrcpp_tpu_torch/ops/jacobi_t.py, ops/block_sweep.py) against the JAX
package, on the CPU.

The same packed words, Gram blocks, warm state and variates (rho, inner,
z, lambda, tau, c2), made with numpy from a seed, go through

- JAX ``horseshoe_jacobi_t_pallas(..., interpret=True, fold_affine=True)``,
  the TPU kernel run as the JAX tests run it;
- JAX ``block_sweep.horseshoe_jacobi_sweep``, the plain oracle, through
  ``strided_border`` and the visit-order re-indexing of z;
- the port's ``horseshoe_jacobi_t`` on CPU tensors (its plain version).

Tolerances are those of tests/test_jacobi_t.py:61-74: beta rtol 2e-4 /
atol 2e-6, eps rtol 2e-4 / atol 2e-5 (the three sum the dots in different
orders, and the oracle divides where the kernel multiplies by 1/denom).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu.ops import block_sweep as jbs
from bayesrrcpp_tpu.ops.pallas_jacobi_t import horseshoe_jacobi_t_pallas
from bayesrrcpp_tpu_torch.convert import unpermute_eps
from bayesrrcpp_tpu_torch.ops import block_sweep as tbs
from bayesrrcpp_tpu_torch.ops.jacobi_t import (horseshoe_jacobi_t,
                                               horseshoe_jacobi_t_reference)
from test_torch_jacobi_t import N, _case, _dense, _visit


def _hs_case(seed, J, B, nr, tau=0.05):
    c = _case(seed, J, B, 1, nr)
    rng = np.random.default_rng(seed + 1000)
    c.update(lam=rng.uniform(0.1, 2.0, c["M"]).astype(np.float32),
             tau=np.float32(tau), c2=np.float32(1.5))
    return c


def _torch_args(c):
    t = torch.as_tensor
    return (t(c["words"]), t(c["gram"]), t(c["xsq"]), t(c["eps_nat"]),
            t(c["beta"]), t(c["rho"]), t(c["inner"]), t(c["z"]),
            t(c["lam"]), t(c["tau"]), t(c["c2"]), t(c["sigmaE"]),
            t(c["valid"]))


def _torch_kw(c, J):
    return dict(J=J, x_mean=torch.as_tensor(c["mean"]),
                x_scale=torch.as_tensor(c["scale"]),
                x_xsum=torch.as_tensor(c["colsum"]), fold_affine=True,
                row_valid=torch.arange(c["Npad"]) < N)


def _assert_close(beta_ref, beta_out, eps_ref, eps_out):
    np.testing.assert_allclose(np.asarray(beta_ref), np.asarray(beta_out),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(eps_ref), np.asarray(eps_out),
                               rtol=2e-4, atol=2e-5)


def _jax_common(c):
    a = jnp.asarray
    return (a(c["lam"]), jnp.float32(c["tau"]), jnp.float32(c["c2"]),
            jnp.float32(c["sigmaE"]), a(c["valid"]))


@pytest.mark.parametrize("J,B,nr,tau", [(4, 16, 4, 0.05), (16, 32, 2, 0.05),
                                        (4, 16, 4, 1e-30)],
                         ids=["J4-B16", "J16-B32", "J4-B16-tiny-tau"])
def test_sweep_matches_jax_kernel_and_oracle(J, B, nr, tau):
    c = _hs_case(200 + J + B, J, B, nr, tau)
    before = horseshoe_jacobi_t.launches
    eps_out, beta_out = horseshoe_jacobi_t(*_torch_args(c), **_torch_kw(c, J))
    assert horseshoe_jacobi_t.launches == before  # CPU: the plain version
    eps_out = eps_out.numpy()
    np.testing.assert_array_equal(eps_out[N:], 0.0)    # pad lanes stay 0
    assert np.isfinite(eps_out).all() and np.isfinite(beta_out.numpy()).all()
    if tau < 1e-20:
        # invd -> 0 and sd -> 0: every valid beta is pulled to ~0
        assert np.abs(beta_out.numpy()).max() < 1e-6

    a = jnp.asarray
    eps_k, beta_k = horseshoe_jacobi_t_pallas(
        a(c["words"]), a(c["gram"]), a(c["xsq"]), a(c["eps_perm"]),
        a(c["beta"]), a(c["rho"]), a(c["inner"]), a(c["z"]),
        *_jax_common(c), J=J, interpret=True, x_mean=a(c["mean"]),
        x_scale=a(c["scale"]), x_xsum=a(c["colsum"]), fold_affine=True,
        row_valid=a(c["row_valid_perm"]))
    _assert_close(beta_k, beta_out,
                  unpermute_eps(np.asarray(eps_k), c["Npad"]), eps_out)

    eps_o, beta_o = jbs.horseshoe_jacobi_sweep(
        a(_dense(c)), a(c["gram"]), a(c["xsq"]), a(c["eps_nat"][:N]),
        a(c["beta"]), jbs.strided_border(a(c["rho"]), J), a(c["inner"]),
        a(_visit(c["z"], c["rho"], J, B)), *_jax_common(c), J=J)
    _assert_close(beta_o, beta_out, eps_o, eps_out[:N])


def test_reference_is_what_the_wrapper_runs_on_cpu():
    c = _hs_case(9, 4, 16, 4)
    a = horseshoe_jacobi_t(*_torch_args(c), **_torch_kw(c, 4))
    b = horseshoe_jacobi_t_reference(*_torch_args(c), **_torch_kw(c, 4))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _oracle_args(c, J, B):
    """The dense oracles' operands, numpy, in visit order."""
    border = np.array(jbs.strided_border(jnp.asarray(c["rho"]), J))
    return (_dense(c), c["gram"], c["xsq"], c["eps_nat"][:N], c["beta"],
            border, c["inner"], _visit(c["z"], c["rho"], J, B), c["lam"],
            c["tau"], c["c2"], np.float32(c["sigmaE"]), c["valid"])


@pytest.mark.parametrize("sweep", ["jacobi", "blocked"])
def test_port_dense_sweeps_match_jax(sweep):
    """The port's plain horseshoe sweeps on dense X (the oracle and the
    sampler's dense path) against the JAX ones, same order and variates."""
    J, B = 4, 16
    c = _hs_case(13, J, B, 2)
    args = _oracle_args(c, J, B)
    t = [torch.as_tensor(x) for x in args]
    t[5], t[6] = t[5].long(), t[6].long()
    if sweep == "jacobi":
        ref = jbs.horseshoe_jacobi_sweep(*[jnp.asarray(x) for x in args],
                                         J=J)
        out = tbs.horseshoe_jacobi_sweep(*t, J=J)
    else:
        ref = jbs.horseshoe_block_sweep(*[jnp.asarray(x) for x in args])
        out = tbs.horseshoe_block_sweep(*t)
    _assert_close(ref[1], out[1].numpy(), ref[0], out[0].numpy())


def test_jacobi_oracle_with_one_block_per_round_is_the_blocked_sweep():
    c = _hs_case(17, 4, 16, 2)
    t = [torch.as_tensor(x) for x in _oracle_args(c, 4, 16)]
    t[5], t[6] = t[5].long(), t[6].long()
    for x, y in zip(tbs.horseshoe_jacobi_sweep(*t, J=1),
                    tbs.horseshoe_block_sweep(*t)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", ["dense", "no_fold"])
def test_modes_outside_the_slice_raise(bad):
    """Dense rows run (tests/test_torch_dense.py) but take no missing calls;
    int8 codes of the same dosages run (site #2's int8 mode, ported) and
    equal the packed sweep (``_assert_close``'s tolerances); packed words
    need the fold or the miss mode."""
    c = _hs_case(5, 4, 16, 2)
    args = list(_torch_args(c))
    kw = _torch_kw(c, 4)
    if bad == "dense":
        dense = list(args)
        dense[0] = torch.as_tensor(_dense(c))
        dense[3] = dense[3][:N]
        with pytest.raises(NotImplementedError, match="missing"):
            horseshoe_jacobi_t(*dense, J=4, missing=True)
        eps_r, beta_r = horseshoe_jacobi_t(*args, **kw)
        args[0] = torch.as_tensor(c["codes"][:, :N]).to(torch.int8)
        args[3] = args[3][:N]
        eps_o, beta_o = horseshoe_jacobi_t(
            *args, **{k: v for k, v in kw.items() if k != "row_valid"})
        _assert_close(beta_r, beta_o, eps_r[:N], eps_o)
    else:
        kw["fold_affine"] = False
        with pytest.raises(ValueError):
            horseshoe_jacobi_t(*args, **kw)
