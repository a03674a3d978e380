"""Gram-blocked marker sweeps in plain torch.

Counterpart of ``bayesrrcpp_tpu/ops/block_sweep.py``.  For a block b of B
markers with X_b (B x N rows of the marker-major XT):

1. r = X_b eps;
2. B exact sequential Gibbs updates, each O(B + K): num_j = r_j +
   beta_j * xsq_j, and after a marker changes by delta,
   r <- r - G_b[j, :] * delta with the static block Gram G_b = X_b X_b';
3. eps <- eps - delta X_b.

The permutation is block-restricted (shuffled block order, shuffled order
inside each block), which keeps the reference's stationary distribution
(src/BayesRv2.cpp:180-184).  ``bayesr_block_sweep`` is the dense path of
the sampler; ``bayesr_jacobi_sweep`` is the block-Jacobi oracle that the
strided-rounds sweep (``ops/jacobi_t.py``) is held to in the tests.
"""
from __future__ import annotations

import torch

from .jacobi_t import SweepResult
from .selection import select_component


def pad_markers(XT, xsq, block_size, mpad=None):
    """Pad the marker axis of XT/xsq with zero rows to a block multiple
    (or to an explicit ``mpad``)."""
    M = XT.shape[0]
    Mpad = mpad if mpad is not None else -(-M // block_size) * block_size
    if Mpad != M:
        XT = torch.cat([XT, XT.new_zeros((Mpad - M, XT.shape[1]))])
        xsq = torch.cat([xsq, xsq.new_zeros((Mpad - M,))])
    return XT, xsq, Mpad


def gram_blocks(XT_pad, block_size):
    """(nb, B, B) stack of per-block Gram matrices G_b = X_b X_b'."""
    Mpad, N = XT_pad.shape
    blocks = XT_pad.reshape(Mpad // block_size, block_size, N)
    return torch.bmm(blocks, blocks.transpose(1, 2))


def block_orders(generator, nb, block_size):
    """The block-restricted permutation of one iteration: (block_order
    (nb,), inner_perm (nb, B)), drawn on the generator's device."""
    dev = generator.device
    border = torch.randperm(nb, generator=generator, device=dev)
    inner = torch.argsort(torch.rand((nb, block_size), generator=generator,
                                     device=dev), dim=1)
    return border.to(torch.int32), inner.to(torch.int32)


def strided_orders(generator, nb, block_size, J):
    """Permutations of the strided-rounds sweep (ops/jacobi_t.py): the
    round visit order rho (nr,) and the canonical within-block
    permutations (nb, B), the latter as argsort of iid uniforms."""
    dev = generator.device
    rho = torch.randperm(nb // J, generator=generator, device=dev)
    inner = torch.argsort(torch.rand((nb, block_size), generator=generator,
                                     device=dev), dim=1)
    return rho.to(torch.int32), inner.to(torch.int32)


def strided_border(rho, J):
    """The flat block order equivalent to a strided-rounds ``rho``: round
    rho[r] sweeps blocks {j*nr + rho[r] : j < J} (for oracles and tests)."""
    nr = rho.shape[0]
    j = torch.arange(J, dtype=rho.dtype, device=rho.device)
    return (j[None, :] * nr + rho[:, None]).reshape(-1)


def spike_slab_inner_solve(r, Gb, beta_b, labels_b, xsq_b, gas_b, valid_b,
                           inner, p_b, z_b, pi, cva, sigmaE, sigmaGG,
                           v, bacc):
    """Sequential within-block solve: B exact Gibbs updates against r =
    X_b eps kept current by rank-1 Gram updates.  Returns (r, beta_b,
    labels_b, delta, v, bacc); the inputs are not modified."""
    B = beta_b.shape[0]
    beta_b, labels_b = beta_b.clone(), labels_b.clone()
    v, bacc = v.clone(), bacc.clone()
    delta = torch.zeros_like(r)
    for t in range(B):
        jl = inner[t]
        g = gas_b[jl]
        ok = valid_b[jl]
        num = r[jl] + beta_b[jl] * xsq_b[jl]
        res = select_component(p_b[t], z_b[t], num, xsq_b[jl], pi[g], cva[g],
                               sigmaE, sigmaGG[g], beta_b[jl], labels_b[jl])
        d = torch.where(ok, res.delta, torch.zeros_like(res.delta))
        r = r - Gb[jl] * d
        beta_b[jl] = torch.where(ok, res.beta_new, beta_b[jl])
        labels_b[jl] = torch.where(ok, res.label_new, labels_b[jl])
        delta[jl] = d
        v[g] += torch.where(ok, res.count_onehot,
                            torch.zeros_like(res.count_onehot))
        slab = torch.sum(res.count_onehot[1:])
        bacc[g] += torch.where(ok, slab * res.beta_new * res.beta_new,
                               torch.zeros_like(res.beta_new))
    return r, beta_b, labels_b, delta, v, bacc


def bayesr_block_sweep(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                       block_order, inner_perm, p_arr, z_arr,
                       pi, cva, sigmaE, sigmaGG, g_assign_pad, valid_pad):
    """Blocked spike-and-slab sweep in block order ``block_order``.

    Shapes: XT_pad (Mpad, N), gram (nb, B, B), beta_pad/labels_pad/xsq_pad/
    g_assign_pad/valid_pad (Mpad,), p_arr/z_arr (Mpad,) indexed by sweep
    position, pi (G, K), cva (G, K-1), sigmaGG (G,).  Padding markers carry
    valid=False and never change the state.
    """
    nb, B, _ = gram.shape
    G, K = pi.shape
    v = torch.zeros((G, K), dtype=eps.dtype, device=eps.device)
    bacc = torch.zeros((G,), dtype=eps.dtype, device=eps.device)
    beta, labels = beta_pad.clone(), labels_pad.clone()
    p_blk, z_blk = p_arr.reshape(nb, B), z_arr.reshape(nb, B)
    for i in range(nb):
        b = block_order[i]
        rows = b * B + torch.arange(B, device=eps.device)
        Xb = XT_pad[rows]
        r = Xb @ eps
        _, beta_b, labels_b, delta, v, bacc = spike_slab_inner_solve(
            r, gram[b], beta[rows], labels[rows], xsq_pad[rows],
            g_assign_pad[rows], valid_pad[rows], inner_perm[b], p_blk[i],
            z_blk[i], pi, cva, sigmaE, sigmaGG, v, bacc)
        eps = eps - delta @ Xb
        beta[rows] = beta_b
        labels[rows] = labels_b
    return SweepResult(eps, beta, labels, v, bacc)


def bayesr_jacobi_sweep(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                        block_order, inner_perm, p_arr, z_arr,
                        pi, cva, sigmaE, sigmaGG, g_assign_pad, valid_pad,
                        *, J: int):
    """Block-Jacobi spike-and-slab sweep: J blocks per round, each swept
    against the ROUND-START residual, all J updates applied at once.
    J = 1 is exactly ``bayesr_block_sweep``."""
    nb, B, _ = gram.shape
    nr = nb // J
    G, K = pi.shape
    v = torch.zeros((G, K), dtype=eps.dtype, device=eps.device)
    bacc = torch.zeros((G,), dtype=eps.dtype, device=eps.device)
    beta, labels = beta_pad.clone(), labels_pad.clone()
    bsel = block_order.reshape(nr, J)
    p_blk, z_blk = p_arr.reshape(nr, J, B), z_arr.reshape(nr, J, B)
    lanes = torch.arange(B, device=eps.device)
    for i in range(nr):
        eps0 = eps
        upd = torch.zeros_like(eps)
        for j in range(J):
            b = bsel[i, j]
            rows = b * B + lanes
            Xb = XT_pad[rows]
            r = Xb @ eps0
            _, beta_b, labels_b, delta, v, bacc = spike_slab_inner_solve(
                r, gram[b], beta[rows], labels[rows], xsq_pad[rows],
                g_assign_pad[rows], valid_pad[rows], inner_perm[b],
                p_blk[i, j], z_blk[i, j], pi, cva, sigmaE, sigmaGG, v, bacc)
            upd = upd + delta @ Xb
            beta[rows] = beta_b
            labels[rows] = labels_b
        eps = eps0 - upd
    return SweepResult(eps, beta, labels, v, bacc)
