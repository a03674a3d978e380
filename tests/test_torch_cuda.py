"""The CUDA kernels of bayesrrcpp_tpu_torch/csrc/jacobi_t.cu (the BayesR and
horseshoe sweeps) against their plain torch versions, on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip where
``torch.cuda.is_available()`` is false.  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

They cover what chip_smoke.py's shapes do not: blocks narrower than a warp
(B=16), several groups (G=3), K=2, and individuals that do not fill the
last word tile (pad lanes).  Tolerances: labels and v exact, floats to f32
reassociation (the kernel sums the dot in another order).
"""
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu_torch.ops import genotypes
from bayesrrcpp_tpu_torch.ops.jacobi_t import (
    bayesr_jacobi_t, bayesr_jacobi_t_reference, horseshoe_jacobi_t,
    horseshoe_jacobi_t_reference)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _case(seed, J, B, G, K, nr, N, dev):
    rng = np.random.default_rng(seed)
    nb = J * nr
    M = nb * B
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M))
    words, mean, scale, Npad, _ = genotypes.pack_codes_host(
        dosage.astype(float), False, None, M, N)
    t = lambda x, dt=None: torch.as_tensor(x, dtype=dt, device=dev)  # noqa
    row_valid = torch.arange(Npad, device=dev) < N
    q = genotypes.quantize_packed(dosage.astype(float), False, None, B, M,
                                  N, prepacked=False, device=dev)
    eps = torch.zeros(Npad, device=dev)
    eps[:N] = t(rng.standard_normal(N), torch.float32)
    beta = np.zeros(M, np.float32)
    labels = np.zeros(M, np.int32)
    hot = rng.choice(M, M // 8, replace=False)
    labels[hot] = rng.integers(1, K, hot.size)
    beta[hot] = rng.normal(0, 0.05, hot.size)
    cva = np.tile(np.geomspace(1e-3, 1e-1, K - 1), (G, 1))
    args = (t(words), q.gram, q.xsq, eps, t(beta), t(labels),
            t(rng.permutation(nr), torch.int32),
            t(np.argsort(rng.random((nb, B)), axis=1), torch.int32),
            t(rng.random(M), torch.float32),
            t(rng.standard_normal(M), torch.float32),
            t(rng.dirichlet(np.arange(K, 0, -1.0), G), torch.float32),
            t(cva, torch.float32), t(0.8, torch.float32),
            t(np.linspace(0.03, 0.08, G), torch.float32),
            t(np.arange(M) % G, torch.int32), t(np.arange(M) < M - 5))
    kw = dict(J=J, x_mean=t(mean), x_scale=t(scale), x_xsum=q.x_colsum,
              fold_affine=True, row_valid=row_valid)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("J,B,G,K,N", [(4, 16, 3, 4, 1500),
                                       (8, 32, 1, 2, 3000),
                                       (32, 32, 1, 4, 4096)])
def test_kernel_matches_plain(cuda, J, B, G, K, N):
    args, kw = _case(J + B + G, J, B, G, K, 4, N, cuda)
    before = bayesr_jacobi_t.launches
    ker = bayesr_jacobi_t(*args, **kw)
    ref = bayesr_jacobi_t_reference(*args, **kw)
    torch.cuda.synchronize()
    assert bayesr_jacobi_t.launches == before + 3 * 4
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.eps, ref.eps, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.beta_acum, ref.beta_acum, rtol=1e-4,
                               atol=1e-6)
    assert (ker.eps[N:] == 0).all()
    # fixed-order reductions: a second launch is bitwise identical
    again = bayesr_jacobi_t(*args, **kw)
    for a, b in zip(ker, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_rejects_tensors_on_other_devices(cuda):
    args, kw = _case(1, 4, 16, 1, 4, 2, 500, cuda)
    args = list(args)
    args[8] = args[8].cpu()
    with pytest.raises(ValueError, match="p is on cpu"):
        bayesr_jacobi_t(*args, **kw)


def _hs_case(seed, J, B, nr, N, dev, tau=0.05):
    """The horseshoe sweep's operands: _case's data and state with lambda,
    tau and c2 in place of the mixture's."""
    args, kw = _case(seed, J, B, 1, 4, nr, N, dev)
    rng = np.random.default_rng(seed + 1000)
    M = args[1].shape[0] * B
    lam = torch.as_tensor(rng.uniform(0.1, 2.0, M), dtype=torch.float32,
                          device=dev)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa
    # words, gram, xsq, eps, beta, rho, inner, z, lam, tau, c2, sigmaE, valid
    return (args[:5] + args[6:8] + (args[9], lam, t(tau), t(1.5), args[12],
                                    args[15])), kw


@pytest.mark.cuda
@pytest.mark.parametrize("J,B,N,tau", [(4, 16, 1500, 0.05),
                                       (32, 32, 4096, 0.05),
                                       (8, 32, 3000, 1e-30)])
def test_horseshoe_kernel_matches_plain(cuda, J, B, N, tau):
    args, kw = _hs_case(J + B, J, B, 4, N, cuda, tau)
    before = horseshoe_jacobi_t.launches
    eps_k, beta_k = horseshoe_jacobi_t(*args, **kw)
    eps_r, beta_r = horseshoe_jacobi_t_reference(*args, **kw)
    torch.cuda.synchronize()
    assert horseshoe_jacobi_t.launches == before + 3 * 4
    torch.testing.assert_close(beta_k, beta_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(eps_k, eps_r, rtol=1e-4, atol=1e-5)
    assert (eps_k[N:] == 0).all()
    # fixed-order reductions: a second launch is bitwise identical
    eps_2, beta_2 = horseshoe_jacobi_t(*args, **kw)
    assert torch.equal(eps_k, eps_2) and torch.equal(beta_k, beta_2)
