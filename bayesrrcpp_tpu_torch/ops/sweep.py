"""Sequential per-marker Gibbs sweeps (the literal scan), in plain torch.

Counterpart of ``bayesrrcpp_tpu/ops/sweep.py``: the reference's hot marker
loop (src/BayesRv2.cpp:186-245, src/BayesRv2Groups.cpp:232-298,
src/HorseshoeR.cpp:219-240), one O(N) dot and one O(N) residual update a
marker, sequential in the marker order because eps carries the dependency.
It takes any marker order (the full permutation, or a blocked one
flattened by ``block_sweep.flat_order``) with per-position variates, and
is the sweep the Gram-blocked one is held to (tests/test_torch_scan.py,
tests/test_torch_mirror.py).  JAX runs it as ``lax.scan`` with no Pallas
kernel; here it is plain torch on the sampler's device, in the state's
dtype, for parity runs and small problems.

The same algebra as JAX's: num = X_j . eps + beta_j * xsq_j and one update
eps -= X_j * (beta_new - beta_old).  The order and the valid mask are read
to the host once a sweep, so a step indexes X by a host int and issues no
host round trip; padding markers (valid False) change nothing and are
skipped.
"""
from __future__ import annotations

import torch

from .jacobi_t import SweepResult
from .selection import select_component


def _host(order, valid):
    """The visit order as host ints, each with its position, the padding
    markers left out."""
    ok = valid.tolist()
    return [(pos, j) for pos, j in enumerate(order.tolist()) if ok[j]]


def bayesr_sweep_scan(XT, xsq, eps, beta, labels, order, p_arr, z_arr, pi,
                      cva, sigmaE, sigmaGG, g_assign, valid) -> SweepResult:
    """One spike-and-slab marker sweep in ``order`` (bayesrrcpp_tpu/ops/
    sweep.py:40): the ungrouped sampler (G=1) and the grouped one (the pi
    row, cva row and sigmaG of each marker's group, src/BayesRv2Groups.cpp:
    235-240, 259).  XT (M, N); xsq, beta, labels, g_assign, valid (M,);
    order, p_arr, z_arr (n,) with the variates by sweep position; pi (G,
    K), cva (G, K-1), sigmaGG (G,).  Returns (eps, beta, labels, v (G, K)
    counts, bacc (G,) sums of the freshly drawn slab beta^2)."""
    G, K = pi.shape
    v = torch.zeros((G, K), dtype=eps.dtype, device=eps.device)
    bacc = torch.zeros((G,), dtype=eps.dtype, device=eps.device)
    beta, labels = beta.clone(), labels.clone()
    gas = g_assign.tolist()
    for pos, j in _host(order, valid):
        g = gas[j]
        xj = XT[j]
        num = torch.dot(xj, eps) + beta[j] * xsq[j]
        res = select_component(p_arr[pos], z_arr[pos], num, xsq[j], pi[g],
                               cva[g], sigmaE, sigmaGG[g], beta[j],
                               labels[j])
        eps = eps - xj * res.delta
        beta[j] = res.beta_new
        labels[j] = res.label_new
        v[g] += res.count_onehot
        # beta^2 of a freshly drawn slab effect only
        # (src/BayesRv2Groups.cpp:280)
        slab = torch.sum(res.count_onehot[1:])
        bacc[g] += slab * res.beta_new * res.beta_new
    return SweepResult(eps, beta, labels, v, bacc)


def horseshoe_sweep_scan(XT, xsq, eps, beta, order, z_arr, lam, tau, c2,
                         sigmaE, valid):
    """One regularized-horseshoe marker sweep in ``order``
    (bayesrrcpp_tpu/ops/sweep.py:84, src/HorseshoeR.cpp:219-240): the
    conjugate draw beta_j = num/denom + sqrt(sigmaE/denom) z with denom =
    xsq_j + sigmaE/s_j, s_j = tau c2 lambda_j / (tau lambda_j + c2),
    lambda held fixed.  Returns (eps, beta)."""
    beta = beta.clone()
    for pos, j in _host(order, valid):
        xj = XT[j]
        num = torch.dot(xj, eps) + beta[j] * xsq[j]
        s_j = tau * c2 * lam[j] / (tau * lam[j] + c2)
        denom = xsq[j] + sigmaE / s_j
        beta_new = num / denom + torch.sqrt(sigmaE / denom) * z_arr[pos]
        eps = eps - xj * (beta_new - beta[j])
        beta[j] = beta_new
    return eps, beta
