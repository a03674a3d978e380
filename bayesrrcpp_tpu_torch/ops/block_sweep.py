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
(src/BayesRv2.cpp:180-184).  ``bayesr_block_sweep`` and
``horseshoe_block_sweep`` are the dense paths of the two samplers, in the
state's dtype (float32 or float64); ``bayesr_jacobi_sweep`` and
``horseshoe_jacobi_sweep`` are the block-Jacobi oracles that the
strided-rounds sweeps (``ops/jacobi_t.py``) are held to in the tests.
"""
from __future__ import annotations

import torch

from .jacobi_t import SweepResult, categorical_draw
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


def flat_order(block_order, inner_perm, block_size):
    """A block-restricted permutation as one global marker order (for the
    scan sweep, ``ops/sweep.py``): block_order[i]'s markers in the order
    inner_perm[block_order[i]]."""
    return (block_order[:, None].long() * block_size
            + inner_perm[block_order.long()].long()).reshape(-1)


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


def windowed_inner_solve(r, Gb, beta_b, labels_b, xsq_b, gas_b, valid_b,
                         inner, p_b, z_b, pi, cva, sigmaE, sigmaGG, v, bacc,
                         *, W: int):
    """``spike_slab_inner_solve`` on the serial kernel's schedule
    (csrc/serial.cu:block_windows): draw the next W steps all on the current
    r, commit every step up to and including the first that moves (d != 0),
    apply that one rank-1 update, and start the next window after it.  A
    step that moves nothing leaves r as it was, so the committed draws are
    the one-step loop's.  Each draw is the loop's own per-step torch ops on
    the same shapes; only which r a draw reads, and when the update lands,
    differ.  For the tests: no sweep calls it."""
    B = beta_b.shape[0]
    beta_b, labels_b = beta_b.clone(), labels_b.clone()
    v, bacc = v.clone(), bacc.clone()
    delta = torch.zeros_like(r)
    s0 = 0
    while s0 < B:
        window = []
        for t in range(s0, min(s0 + W, B)):
            jl = inner[t]
            g = gas_b[jl]
            ok = valid_b[jl]
            num = r[jl] + beta_b[jl] * xsq_b[jl]
            res = select_component(p_b[t], z_b[t], num, xsq_b[jl], pi[g],
                                   cva[g], sigmaE, sigmaGG[g], beta_b[jl],
                                   labels_b[jl])
            d = torch.where(ok, res.delta, torch.zeros_like(res.delta))
            window.append((t, jl, g, ok, res, d))
        s0 += len(window)
        for t, jl, g, ok, res, d in window:
            beta_b[jl] = torch.where(ok, res.beta_new, beta_b[jl])
            labels_b[jl] = torch.where(ok, res.label_new, labels_b[jl])
            delta[jl] = d
            v[g] += torch.where(ok, res.count_onehot,
                                torch.zeros_like(res.count_onehot))
            slab = torch.sum(res.count_onehot[1:])
            bacc[g] += torch.where(ok, slab * res.beta_new * res.beta_new,
                                   torch.zeros_like(res.beta_new))
            if d != 0:
                r = r - Gb[jl] * d
                s0 = t + 1
                break
    return r, beta_b, labels_b, delta, v, bacc


def strided_pass_solve(rr, G_r, bold, inn, blk, p_r, z_r, lp, invd, sd,
                       xsq, okf, half_invsE):
    """``ops/jacobi_t.strided_steps`` (same arguments and outputs) on the
    strided kernel's schedule (csrc/jacobi_t_common.cuh:solve_block): from a
    cursor c = 0, each pass draws every position t >= c of a block at once
    on the block's current r, commits every position up to and including
    the first that moves (d != 0), applies that one rank-1 update, and
    starts the next pass after it; with no mover the rest is committed and
    the block is done.  A step that moves nothing leaves r as it was, so
    the committed draws are the one-step loop's.  Each draw is the loop's
    own call on the same shapes (position t of every block at once), so it
    rounds alike; only which r a draw reads, and when the update lands,
    differ.  For the tests: no sweep calls it."""
    J, B = inn.shape
    dev = rr.device
    jj = torch.arange(J, device=dev)
    t_all = torch.arange(B, device=dev)
    lead = rr.shape[:-2]
    dpos = torch.zeros_like(rr)                       # by visit position
    kpos = torch.full(rr.shape, -1, dtype=torch.int32, device=dev)
    c = torch.zeros(lead + (J,), dtype=torch.long, device=dev)
    while bool((c < B).any()):
        draws = []
        for t in range(B):
            m = inn[:, t]
            mg = blk * B + m
            b_old = bold[..., jj, m]
            num = rr[..., jj, m] + b_old * xsq[mg]
            draws.append(categorical_draw(
                lp[..., mg, :], invd[..., mg, :], sd[..., mg, :], num,
                half_invsE, p_r[..., t], z_r[..., t], b_old, okf[mg]))
        d = torch.stack([x for x, _ in draws], dim=-1)
        kr = torch.stack([k for _, k in draws], dim=-1)
        open_ = t_all >= c[..., None]
        moves = open_ & (d != 0)
        has = moves.any(dim=-1)
        f = torch.where(has, moves.to(torch.int8).argmax(dim=-1), B)
        commit = open_ & (t_all <= f[..., None])
        dpos = torch.where(commit, d, dpos)
        kpos = torch.where(commit, kr, kpos)
        fm = f.clamp_max(B - 1)
        mover = inn[jj, fm]                           # (..., J) markers
        dm = torch.gather(d, -1, fm[..., None])
        rr = torch.where(has[..., None], rr - G_r[jj, mover, :] * dm, rr)
        c = torch.where(has, f + 1, B)
    d = torch.zeros_like(rr)
    krec = torch.full(rr.shape, -1, dtype=torch.int32, device=dev)
    d[..., jj[:, None], inn] = dpos
    krec[..., jj[:, None], inn] = kpos
    return d, krec


def dependent_windows(d_in_visit_order, W: int) -> int:
    """Windows of at most W steps that the serial kernel's solve takes for
    blocks whose steps give ``d_in_visit_order`` ((B,) for one block, or
    (nb, B), each row a block in visit order; nonzero where a step moved):
    a window ends at its first mover, else after W still steps, and never
    spans two blocks.  Summed over the blocks."""
    moved = torch.as_tensor(d_in_visit_order) != 0
    if moved.dim() == 1:
        moved = moved[None]
    nb, B = moved.shape
    pos = torch.arange(B, device=moved.device)
    # the first mover at or after each position (B: none)
    first = torch.where(moved, pos, torch.full_like(pos, B))
    first = torch.flip(torch.cummin(torch.flip(first, [1]), dim=1).values,
                       [1])
    first = torch.cat([first, torch.full((nb, 1), B, dtype=first.dtype,
                                         device=first.device)], dim=1)
    s0 = torch.zeros(nb, dtype=torch.int64, device=moved.device)
    rows = torch.arange(nb, device=moved.device)
    windows = 0
    while True:
        live = s0 < B
        n_live = int(live.sum())
        if n_live == 0:
            return windows
        windows += n_live
        f = first[rows, s0.clamp(max=B)]
        s0 = torch.where(live, torch.where(f < s0 + W, f + 1, s0 + W), s0)


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


def horseshoe_inner_solve(r, Gb, beta_b, xsq_b, lam_b, valid_b, inner, z_b,
                          tau, c2, sigmaE):
    """Sequential within-block horseshoe solve (src/HorseshoeR.cpp:219-240):
    B conjugate normal draws against r kept current by rank-1 Gram updates.
    Returns (r, beta_b, delta); the inputs are not modified."""
    B = beta_b.shape[0]
    beta_b = beta_b.clone()
    delta = torch.zeros_like(r)
    for t in range(B):
        jl = inner[t]
        num = r[jl] + beta_b[jl] * xsq_b[jl]
        s_j = tau * c2 * lam_b[jl] / (tau * lam_b[jl] + c2)
        denom = xsq_b[jl] + sigmaE / s_j
        beta_new = num / denom + torch.sqrt(sigmaE / denom) * z_b[t]
        d = torch.where(valid_b[jl], beta_new - beta_b[jl],
                        torch.zeros_like(beta_new))
        r = r - Gb[jl] * d
        beta_b[jl] = torch.where(valid_b[jl], beta_new, beta_b[jl])
        delta[jl] = d
    return r, beta_b, delta


def horseshoe_block_sweep(XT_pad, gram, xsq_pad, eps, beta_pad, block_order,
                          inner_perm, z_arr, lam_pad, tau, c2, sigmaE,
                          valid_pad):
    """Blocked dense horseshoe sweep in block order ``block_order``;
    returns (eps, beta).  Shapes as ``bayesr_block_sweep``, with lam_pad
    (Mpad,) and scalar tau, c2, sigmaE."""
    nb, B, _ = gram.shape
    beta = beta_pad.clone()
    z_blk = z_arr.reshape(nb, B)
    for i in range(nb):
        b = block_order[i]
        rows = b * B + torch.arange(B, device=eps.device)
        Xb = XT_pad[rows]
        _, beta_b, delta = horseshoe_inner_solve(
            Xb @ eps, gram[b], beta[rows], xsq_pad[rows], lam_pad[rows],
            valid_pad[rows], inner_perm[b], z_blk[i], tau, c2, sigmaE)
        eps = eps - delta @ Xb
        beta[rows] = beta_b
    return eps, beta


def horseshoe_jacobi_sweep(XT_pad, gram, xsq_pad, eps, beta_pad, block_order,
                           inner_perm, z_arr, lam_pad, tau, c2, sigmaE,
                           valid_pad, *, J: int):
    """Block-Jacobi dense horseshoe sweep: J blocks per round against the
    ROUND-START residual, all J updates applied at once; returns (eps,
    beta).  The flat-order oracle of the strided horseshoe sweep; J = 1 is
    exactly ``horseshoe_block_sweep``."""
    nb, B, _ = gram.shape
    nr = nb // J
    beta = beta_pad.clone()
    bsel = block_order.reshape(nr, J)
    z_blk = z_arr.reshape(nr, J, B)
    lanes = torch.arange(B, device=eps.device)
    for i in range(nr):
        eps0 = eps
        upd = torch.zeros_like(eps)
        for j in range(J):
            b = bsel[i, j]
            rows = b * B + lanes
            Xb = XT_pad[rows]
            _, beta_b, delta = horseshoe_inner_solve(
                Xb @ eps0, gram[b], beta[rows], xsq_pad[rows], lam_pad[rows],
                valid_pad[rows], inner_perm[b], z_blk[i, j], tau, c2, sigmaE)
            upd = upd + delta @ Xb
            beta[rows] = beta_b
        eps = eps0 - upd
    return eps, beta
