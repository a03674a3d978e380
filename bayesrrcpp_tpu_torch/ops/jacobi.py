"""Jacobi plans, and the row-layout block-Jacobi sweeps with their round
solves.

The plan functions (``auto_jacobi``, ``auto_jacobi_plan``,
``planned_mpad``) are copied verbatim from
``bayesrrcpp_tpu/ops/pallas_jacobi.py:59-176``.  The plan fixes the Markov
kernel (which markers share a round), so the port must choose the same
(J, B, layout) as the reference for every M; tests/test_torch_bayesr.py
pins the two against each other.

The sweeps are the counterparts of ``pallas_jacobi.py:bayesr_jacobi_pallas``
and ``horseshoe_jacobi_pallas`` in their dense f32 mode (``x_mean=None``:
XT_pad (Mpad, N) standardized rows, eps (N,)) and their fold-affine
quantized modes: int8 codes with no missing call (XT_pad (Mpad, N) int8,
eps (N,); the int8 fold cast of pallas_jacobi.py:299-305) and 2-bit words
with no missing call (eps (Npad,) in natural individual order).  Semantics (the Markov kernel the port keeps):

- the blocks come in the flat shuffled order ``block_order`` (the serial
  sweep's, ``block_orders``), J at a time: round r holds the blocks at
  sweep positions r*J .. r*J + J-1, every one of them against the
  round-start eps, and its J*B updates go to eps at the end of the round
  in block order;
- position s of the block at sweep position i visits marker
  ``block_order[i]*B + inner_perm[block_order[i], s]`` and reads p/z[i*B +
  s], by sweep position (pallas_jacobi.py:build_pkg_jacobi, :218-265);
- within a block, exact sequential Gibbs with the serial sweep's per-step
  algebra, on the per-marker tables of ``serial.build_pkg`` /
  ``build_pkg_hs`` (the kernels) or the same values laid out by position
  (``build_pkg_jacobi``, ``build_pkg_hs_jacobi``: the plain versions);
- fold mode: sum(eps) is read once, at the sweep start, and tracked as
  sum(eps) - d.xsum over every round (:1273, :428-433); eps -= (d*s).C -
  sum_j d.(m*s) on the individuals n < N (every individual for int8
  codes); dense X: r = X_b.eps and eps -=
  d.X_b on the rows themselves;
- v and bacc accumulate block by block in sweep order (:440-468).

J=1 is the serial sweep of ``ops/serial.py`` with one chunk.  The round
solves (``bayesr_round_solve``, ``horseshoe_round_solve``;
``pallas_jacobi.py:bayesr_round_solve_pallas``,
``horseshoe_round_solve_pallas``) are one round's solve alone, on r given
in the standardized domain and the operands of ``build_pkg_jacobi`` /
``build_pkg_hs_jacobi``: the split sweep of the row-sharded sampler
(bayesrrcpp_tpu/parallel/sharded.py:741-800).

On CUDA tensors each entry point launches ``csrc/serial.cu`` (a sweep: dot,
round solve and apply per round, counted in ``<entry point>.launches``,
and its solves also in ``<round solve>.launches``; a round solve: one
launch) or raises; on CPU tensors each runs its plain version
(``*_reference``), which batches the J blocks of a round on each step.
"""
from __future__ import annotations

import torch

from . import genotypes, serial
from .jacobi_t import (SweepResult, _hs_tables, _operands, _ptr,
                       bayesr_tables, categorical_draw)

# launches per round of the CUDA sweeps: dot, round solve, apply
LAUNCHES_PER_ROUND = 3


def auto_jacobi(M: int, B: int):
    """Default (J, B) for the Jacobi-batched sweep when the caller did not
    pick one (VERDICT round-2 ask: the fast path without magic kwargs).

    Constraints:
    - VMEM: the kernel's two (J*B, B) f32 scratches (P one-hot + Gp) must
      fit the ~16 MiB VMEM alongside the X tile / Gram block / pkg operands;
      budget J*B^2 <= 2^20 elements (8 MiB for the pair).
    - staleness: the cross-block Jacobi window is J*B markers per round;
      cap it at M/8 so small problems stay (near-)sequential.  J=1 is the
      exact sequential kernel.

    B may shrink to 128 when that buys a larger J -- the serial-step count
    is Mpad/J, so maximizing J at the smallest full-lane block wins
    (measured on v5e: J=16/B=256 at 165.9 ms beat J=4-feasible B=512 in
    round 2; the interleaved-Gp kernel makes J=64/B=128 feasible).
    """
    import numpy as _np

    def no_pad(J, Bc):
        # the sampler pads Mpad to B*8*J/gcd(8,J) units AT SCALE (the
        # nb % 8 codegen rule only kicks in at >= 64 blocks; below that
        # the unit is just B*J); when X is a near-HBM-sized packed array,
        # jnp.pad's transient second copy OOMs the chip -- prefer the
        # largest J that divides M exactly
        unit8 = Bc * 8 * J // _np.gcd(8, J)
        if M < 64 * Bc:
            unit8 = Bc * J
        return M % unit8 == 0

    best = (1, B, no_pad(1, B))
    for Bc in dict.fromkeys((B, min(B, 256), 128)):
        jmax_vmem = max(1, (1 << 20) // (Bc * Bc))
        J = 1
        while J * 2 <= jmax_vmem and (J * 2) * Bc * 8 <= M:
            J *= 2
        while J > 1 and not no_pad(J, Bc) and no_pad(J // 2, Bc):
            J //= 2
        cand = (J, Bc, no_pad(J, Bc))
        # rank: padding-free first, then largest J
        if (cand[2], cand[0]) > (best[2], best[0]):
            best = cand
    return best[0], best[1]


def auto_jacobi_plan(M: int, B: int):
    """Default (J, B, layout) for the Jacobi sweep; layout is "row"
    (ops/pallas_jacobi.py, J on sublanes) or "t" (ops/pallas_jacobi_t.py,
    J on lanes).

    The transposed kernel caps J at 128 (the lane width) but cuts the
    per-step dependent chain ~2x and the streamed Gram bytes B/32-fold, so
    it prefers MANY SMALL blocks: the window W = J*B stays at the proven
    4096-marker staleness cap (or M/8 for small problems) while J rides to
    128.  The row kernel remains for explicit jacobi_blocks choices and
    J > 128 experiments.

    Ranking mirrors auto_jacobi: padding-free first (jnp.pad's transient
    copy of a near-HBM packed X OOMs the chip), then largest J, then
    largest B.  Falls back to the row-layout auto_jacobi when no transposed
    candidate with J >= 8 exists (tiny M).
    """
    import numpy as _np

    def unit8(J, Bc):
        # the sampler pads Mpad to this unit at scale (nb % 8 == 0 for
        # XLA codegen size); below 64 blocks it pads to B*J only
        u = Bc * J
        if M >= 64 * Bc:
            u = Bc * 8 * J // _np.gcd(8, J)
        return u

    wmax = 1
    while wmax * 2 <= max(1, M // 8) and wmax * 2 <= 4096:
        wmax *= 2
    best = None
    w = wmax
    while w >= 256:
        # B >= 32: Mosaic rejects the kernel's chunked one-hot permute
        # broadcasts at B = 8/16 on real TPUs ((1, JC*B) -> (B, JC*B)
        # "Invalid input layout"), so small blocks trade lanes (smaller
        # J) rather than sublanes
        J = min(128, w // 32)
        Bc = w // J
        cand = (M % unit8(J, Bc) == 0, J, Bc)
        if best is None or cand > best:
            best = cand
        w //= 2
    if best is not None and best[1] >= 8:
        if not best[0]:
            # no padding-free window: take the largest (padding was
            # already unavoidable; dense/host paths pad cheaply)
            J = min(128, wmax // 32)
            return J, wmax // J, "t"
        return best[1], best[2], "t"
    J, Bc = auto_jacobi(M, B)
    return J, Bc, "row"


def planned_mpad(M: int, block_size: int = 512) -> int:
    """The padded marker count the default (auto-plan) sampler will use
    for M markers -- so HOST loaders can pre-pad packed words and skip the
    on-device pad entirely (a near-HBM-sized device array cannot be
    padded in place: input + output both live during the copy, and at
    biobank scale that OOMs the chip -- see io.bed.read_bed_packed's
    ``mpad``).  Mirrors the samplers' blocking logic;
    tests/test_jacobi_t.py pins the two against each other."""
    import numpy as _np

    B = min(block_size, 1 << max(1, (M - 1).bit_length()))
    B = max(8, min(B, block_size))
    J, B, _layout = auto_jacobi_plan(M, B)
    unit = B * J
    Mpad = -(-M // unit) * unit
    if Mpad // B >= 64:
        unit8 = B * 8 * J // _np.gcd(8, J)
        Mpad = -(-M // unit8) * unit8
    return Mpad


# ------------------------------------------------------------ the sweeps


def _check_mode(XT_pad, gram, J, block_order, x_mean, x_xsum, fold_affine,
                row_valid, p, z):
    """Rejects what the TPU wrapper rejects (pallas_jacobi.py:1187-1195);
    dense f32 rows have ``x_mean`` None, int8 codes no ``row_valid``.  ``block_order`` may be a prefix of the
    sweep, whole rounds, with p/z (p None: the horseshoe) one per position
    of those rounds."""
    nb, B, _ = gram.shape
    n = block_order.shape[0]
    if J < 1 or nb % J or n % J or not 0 < n <= nb:
        raise ValueError(f"jacobi sweep needs J | nb and whole rounds (J={J},"
                         f" nb={nb}, {n} blocks)")
    if (p is not None and p.shape[-1] != n * B) or z.shape[-1] != n * B:
        raise ValueError("p/z streams must have one entry per sweep position")
    if x_mean is None:
        if not XT_pad.dtype.is_floating_point:
            raise ValueError(f"dense jacobi sweep needs float rows, not "
                             f"{XT_pad.dtype}")
        return
    if XT_pad.dtype not in (torch.int8, torch.int32):
        raise ValueError("quantized jacobi sweep needs int8 codes or int32 "
                         f"words, not {XT_pad.dtype}")
    if not fold_affine:
        raise ValueError("jacobi sweep supports dense or fold-affine "
                         "quantized X only (missing calls: use the "
                         "single-chain kernel)")
    if x_xsum is None or (XT_pad.dtype == torch.int32 and row_valid is None):
        raise ValueError("quantized fold_affine needs x_xsum (and row_valid "
                         "for packed words)")


def _row_plain(K, G, J, words, gram, eps, beta, labels, border, pkg,
               inner_sel, half_invsE, gas, mean, scale, xsum, row_valid):
    """The plain torch version of a row sweep of one chain, in f32, round
    by round as the kernels run it: r of the round's J*B rows against the
    round-start eps (dense rows, or the fold algebra on the codes with
    sum(eps) read at the sweep start and tracked), the round solve's plain
    version on r (``_solve_plain`` on the round's operands of
    ``build_pkg_jacobi`` / ``build_pkg_hs_jacobi``: the J blocks batched on
    each step), then the round's deltas applied to eps.  K == 0 is the
    horseshoe.  Returns (eps, beta, labels, v, bacc), the last three None
    for the horseshoe.  At J=1 every operation has the shape of
    ``serial``'s plain sweep in one chunk, so the two agree bitwise."""
    f32 = torch.float32
    dev = words.device
    B = gram.shape[1]
    dense = mean is None
    eps = eps.to(f32)[None].clone()                       # (1, lanes)
    beta = beta.to(f32).clone()
    if not dense:
        mean, scale, xsum = (t.to(f32) for t in (mean, scale, xsum))
        lane_ok = None if row_valid is None else row_valid.to(torch.bool)
        esum = eps.sum(dim=-1)                            # once, at the start
    if K:
        labels = labels.to(torch.int32).clone()
        v = torch.zeros((G, K), dtype=f32, device=dev)
        bacc = torch.zeros((G,), dtype=f32, device=dev)
        kcol = torch.arange(K, device=dev)
        gcol = torch.arange(G, device=dev)
    lanes = torch.arange(B, device=dev)
    for r in range(border.shape[0] // J):
        blk = border[r * J:(r + 1) * J].long()            # (J,)
        rows = (blk[:, None] * B + lanes).reshape(-1)     # (J*B,)
        if dense:
            x = words[rows].to(f32)
            rr = (eps @ x.T).view(J, B)
        else:
            codes = genotypes.decode_codes(words[rows]).to(f32)
            sc = scale[rows]
            ms = mean[rows] * sc
            rr = ((eps @ codes.T) * sc - ms * esum[:, None]).view(J, B)
        bo = beta[rows].view(J, B)
        d, krec = _solve_plain(K, rr, gram[blk], bo, inner_sel[r],
                               _by_block(pkg[r], J, B), half_invsE)
        bnew = bo + d
        beta[rows] = bnew.reshape(-1)
        if K:
            labels[rows] = torch.where(krec >= 0, krec,
                                       labels[rows].view(J, B)).reshape(-1)
            in_g = gas[rows].view(J, B, 1) == gcol            # (J, B, G)
            hits = krec[..., None] == kcol                    # (J, B, K)
            vb = (in_g[..., None] & hits[..., None, :]).sum(dim=1).to(f32)
            b2 = torch.where(krec > 0, bnew * bnew, 0.0)
            bb = torch.where(in_g, b2[..., None], 0.0).sum(dim=1)  # (J, G)
            for jb in range(J):                               # sweep order
                v = v + vb[jb]
                bacc = bacc + bb[jb]
        dflat = d.reshape(1, -1)
        if dense:
            eps = eps - dflat @ x
        else:
            esum = esum - (dflat * xsum[rows]).sum(dim=-1)
            dms = (dflat * ms).sum(dim=-1)
            eps = serial.on_lanes(
                lane_ok, eps - ((dflat * sc) @ codes - dms[:, None]), eps)
    if not K:
        return eps[0], beta, None, None, None
    return eps[0], beta, labels, v, bacc


def _row_cuda(K, G, J, XT_pad, gram, xsq_pad, eps, beta, labels,
              block_order, inner_perm, p, z, tbl, sigmaE, gas, valid, x_mean,
              x_scale, x_xsum, row_valid):
    """One row sweep of one chain through ``serial._sweep_cuda`` with J
    blocks a round and one chunk (tbl, sigmaE with a chain axis of 1)."""
    if XT_pad.device.type != "cuda":
        raise NotImplementedError(f"no row-layout kernel for device "
                                  f"{XT_pad.device}")
    lead = (lambda t: None if t is None else t[None])
    out = serial._sweep_cuda(
        False, K, G, block_order.shape[0] // J, XT_pad, gram, xsq_pad,
        eps[None], beta[None], lead(labels), block_order, inner_perm,
        lead(p), z[None], tbl, sigmaE, gas, valid, x_mean, x_scale, x_xsum,
        row_valid, fold=x_mean is not None, J=J)
    return [None if x is None else x[0] for x in out]


def _bayesr(plain, XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
            block_order, inner_perm, p_arr, z_arr, pi, cva, sigmaE, sigmaGG,
            g_assign_pad, valid_pad, J, x_mean, x_scale, x_xsum, fold_affine,
            row_valid):
    _check_mode(XT_pad, gram, J, block_order, x_mean, x_xsum, fold_affine,
                row_valid, p_arr, z_arr)
    dev = XT_pad.device
    B = gram.shape[1]
    G, K = pi.shape
    if plain:
        pkg, inner_sel = build_pkg_jacobi(
            xsq_pad, g_assign_pad, valid_pad, p_arr, z_arr, pi, cva, sigmaE,
            sigmaGG, block_order, inner_perm, B=B, J=J)
        half = 0.5 / torch.as_tensor(sigmaE, dtype=torch.float32, device=dev)
        return SweepResult(*_row_plain(
            K, G, J, XT_pad, gram, eps, beta_pad, labels_pad, block_order,
            pkg, inner_sel, half, g_assign_pad, x_mean, x_scale, x_xsum,
            row_valid))
    sigmaE = serial._lead(sigmaE, dev)
    tbl = serial.build_pkg(xsq_pad, g_assign_pad, serial._lead(pi, dev), cva,
                           sigmaE, serial._lead(sigmaGG, dev))
    return SweepResult(*_row_cuda(
        K, G, J, XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
        block_order, inner_perm, p_arr, z_arr, tbl, sigmaE, g_assign_pad,
        valid_pad, x_mean, x_scale, x_xsum, row_valid))


def bayesr_jacobi(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                  block_order, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                  sigmaGG, g_assign_pad, valid_pad, *, J: int = 8,
                  x_mean=None, x_scale=None, x_xsum=None,
                  fold_affine: bool = False, row_valid=None) -> SweepResult:
    """One row-layout BayesR sweep (see the module docstring), with the
    argument order and outputs of ``bayesr_jacobi_pallas``.

    XT_pad (Mpad, Npad/16) int32 words or (Mpad, N) int8 codes (eps (N,),
    no row_valid) with ``fold_affine=True``, or (Mpad, N) f32 standardized
    rows with ``x_mean`` None (eps (N,), no x_scale, x_xsum, row_valid); gram (nb, B, B) with J | nb (on the card B <= 512
    when J > 1); block_order (n,), n a
    multiple of J (nb for a whole sweep); p_arr, z_arr (n*B,) by sweep
    position; the rest as ``serial.bayesr_sweep``.  On CUDA tensors it
    launches ``csrc/serial.cu`` (3 launches per round, counted in
    ``bayesr_jacobi.launches``; the solves also in
    ``bayesr_round_solve.launches``) or raises; on CPU tensors it runs
    ``bayesr_jacobi_reference``."""
    plain = XT_pad.device.type == "cpu"
    res = _bayesr(plain, XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                  block_order, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                  sigmaGG, g_assign_pad, valid_pad, J, x_mean, x_scale,
                  x_xsum, fold_affine, row_valid)
    if not plain:
        nr = block_order.shape[0] // J
        bayesr_jacobi.launches += LAUNCHES_PER_ROUND * nr
        bayesr_round_solve.launches += nr
    return res


bayesr_jacobi.launches = 0


def bayesr_jacobi_reference(XT_pad, gram, xsq_pad, eps, beta_pad,
                            labels_pad, block_order, inner_perm, p_arr,
                            z_arr, pi, cva, sigmaE, sigmaGG, g_assign_pad,
                            valid_pad, *, J: int = 8, x_mean=None,
                            x_scale=None, x_xsum=None,
                            fold_affine: bool = False,
                            row_valid=None) -> SweepResult:
    """The plain torch version of ``bayesr_jacobi``."""
    return _bayesr(True, XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                   block_order, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                   sigmaGG, g_assign_pad, valid_pad, J, x_mean, x_scale,
                   x_xsum, fold_affine, row_valid)


def _horseshoe(plain, XT_pad, gram, xsq_pad, eps, beta_pad, block_order,
               inner_perm, z_arr, lam_pad, tau, c2, sigmaE, valid_pad, J,
               x_mean, x_scale, x_xsum, fold_affine, row_valid):
    _check_mode(XT_pad, gram, J, block_order, x_mean, x_xsum, fold_affine,
                row_valid, None, z_arr)
    dev = XT_pad.device
    if plain:
        pkg, inner_sel = build_pkg_hs_jacobi(
            xsq_pad, valid_pad, z_arr, lam_pad, tau, c2, sigmaE, block_order,
            inner_perm, B=gram.shape[1], J=J)
        out = _row_plain(0, 0, J, XT_pad, gram, eps, beta_pad, None,
                         block_order, pkg, inner_sel, None, None, x_mean,
                         x_scale, x_xsum, row_valid)
    else:
        lead = (lambda t: serial._lead(t, dev))
        tbl = serial.build_pkg_hs(xsq_pad, lead(lam_pad), lead(tau),
                                  lead(c2), lead(sigmaE))
        out = _row_cuda(0, 0, J, XT_pad, gram, xsq_pad, eps, beta_pad, None,
                        block_order, inner_perm, None, z_arr, tbl, None, None,
                        valid_pad, x_mean, x_scale, x_xsum, row_valid)
    return out[0], out[1]


def horseshoe_jacobi(XT_pad, gram, xsq_pad, eps, beta_pad, block_order,
                     inner_perm, z_arr, lam_pad, tau, c2, sigmaE, valid_pad,
                     *, J: int = 8, x_mean=None, x_scale=None, x_xsum=None,
                     fold_affine: bool = False, row_valid=None):
    """One row-layout horseshoe sweep, shaped like
    ``horseshoe_jacobi_pallas``: returns (eps, beta).  lam_pad (Mpad,);
    tau, c2 and sigmaE scalars; z_arr (n*B,) by sweep position; the rest
    as in ``bayesr_jacobi``.  On CUDA tensors it launches
    ``csrc/serial.cu`` (3 launches per round, counted in
    ``horseshoe_jacobi.launches``; the solves also in
    ``horseshoe_round_solve.launches``) or raises; on CPU tensors it runs
    ``horseshoe_jacobi_reference``."""
    plain = XT_pad.device.type == "cpu"
    res = _horseshoe(plain, XT_pad, gram, xsq_pad, eps, beta_pad,
                     block_order, inner_perm, z_arr, lam_pad, tau, c2,
                     sigmaE, valid_pad, J, x_mean, x_scale, x_xsum,
                     fold_affine, row_valid)
    if not plain:
        nr = block_order.shape[0] // J
        horseshoe_jacobi.launches += LAUNCHES_PER_ROUND * nr
        horseshoe_round_solve.launches += nr
    return res


horseshoe_jacobi.launches = 0


def horseshoe_jacobi_reference(XT_pad, gram, xsq_pad, eps, beta_pad,
                               block_order, inner_perm, z_arr, lam_pad, tau,
                               c2, sigmaE, valid_pad, *, J: int = 8,
                               x_mean=None, x_scale=None, x_xsum=None,
                               fold_affine: bool = False, row_valid=None):
    """The plain torch version of ``horseshoe_jacobi``."""
    return _horseshoe(True, XT_pad, gram, xsq_pad, eps, beta_pad,
                      block_order, inner_perm, z_arr, lam_pad, tau, c2,
                      sigmaE, valid_pad, J, x_mean, x_scale, x_xsum,
                      fold_affine, row_valid)


# ------------------------------------------------------- the round solves


def build_pkg_jacobi(xsq, gas, valid, p, z, pi, cva, sigmaE, sigmaGG,
                     border, inner, *, B, J):
    """The round solves' per-position operand (nr, B*J, 3K+4), row s*J + j
    position s of block j of the round, fields [lp(K), 1/denom(K), sd(K),
    p, z, xsq, valid], and the (nr, J, B) inner permutations of the
    rounds' blocks (pallas_jacobi.py:build_pkg_jacobi).  ``border`` may
    be a prefix of whole rounds; p/z by sweep position, one per position of
    those rounds."""
    f32 = torch.float32
    nr = border.shape[0] // J
    lp, invd, sd = bayesr_tables(xsq, gas, pi, cva, sigmaE, sigmaGG)
    tbl = torch.cat([lp, invd, sd, xsq.to(f32)[:, None],
                     valid.to(f32)[:, None]], dim=1)
    bsel = border.long().view(nr, J)
    inner_sel = inner.long()[bsel]                         # (nr, J, B)
    per = tbl[(bsel[..., None] * B + inner_sel).reshape(-1)].view(
        nr, J, B, -1)
    K = pi.shape[-1]
    pkg = torch.cat([per[..., :3 * K], p.to(f32).view(nr, J, B, 1),
                     z.to(f32).view(nr, J, B, 1), per[..., 3 * K:]], dim=3)
    return (pkg.transpose(1, 2).reshape(nr, B * J, 3 * K + 4),
            inner_sel.to(torch.int32))


def build_pkg_hs_jacobi(xsq, valid, z, lam, tau, c2, sigmaE, border, inner,
                        *, B, J):
    """The horseshoe's (nr, B*J, 5) operand, fields [1/denom, sd, z, xsq,
    valid] (pallas_jacobi.py:build_pkg_hs_jacobi), and the inner
    permutations as ``build_pkg_jacobi``."""
    f32 = torch.float32
    nr = border.shape[0] // J
    invd, sd = _hs_tables(xsq, lam, tau, c2, sigmaE)
    tbl = torch.stack([invd, sd, xsq.to(f32), valid.to(f32)], dim=1)
    bsel = border.long().view(nr, J)
    inner_sel = inner.long()[bsel]
    per = tbl[(bsel[..., None] * B + inner_sel).reshape(-1)].view(
        nr, J, B, 4)
    pkg = torch.cat([per[..., :2], z.to(f32).view(nr, J, B, 1),
                     per[..., 2:]], dim=3)
    return pkg.transpose(1, 2).reshape(nr, B * J, 5), inner_sel.to(torch.int32)


def _by_block(pkg, J, B):
    """pkg (B*J, F) as (J, B, F): block j's row s is position s."""
    return pkg.to(torch.float32).view(B, J, -1).transpose(0, 1)


def _solve_plain(K, r_rows, gram_rows, beta_rows, inner_rows, pk, half_invsE):
    """The batched steps of a round solve on pk (J, B, F) by position:
    (d, krec) by marker, (J, B) each; K == 0 is the horseshoe."""
    J, B = r_rows.shape
    dev = r_rows.device
    jj = torch.arange(J, device=dev)
    r = r_rows.to(torch.float32).clone()
    bo = beta_rows.to(torch.float32)
    gram = gram_rows.to(torch.float32)
    inn = inner_rows.long()
    d = torch.zeros((J, B), dtype=torch.float32, device=dev)
    krec = torch.full((J, B), -1, dtype=torch.int32, device=dev)
    for s in range(B):
        m = inn[:, s]
        q = pk[:, s]
        if K:
            num = r[jj, m] + bo[jj, m] * q[:, 3 * K + 2]
            dd, krec[jj, m] = categorical_draw(
                q[:, :K], q[:, K:2 * K], q[:, 2 * K:3 * K], num, half_invsE,
                q[:, 3 * K], q[:, 3 * K + 1], bo[jj, m], q[:, 3 * K + 3])
        else:
            num = r[jj, m] + bo[jj, m] * q[:, 3]
            dd = q[:, 4] * (num * q[:, 0] + q[:, 1] * q[:, 2] - bo[jj, m])
        r = r - gram[jj, m, :] * dd[:, None]
        d[jj, m] = dd
    return d, krec


def bayesr_round_solve(r_rows, gram_rows, beta_rows, labels_rows, gas_rows,
                       inner_rows, pkg, sigmaE, *, K: int, G: int):
    """One round's batched sequential solve, shaped like
    ``bayesr_round_solve_pallas``: r_rows (J, B) standardized-domain
    correlations by marker, gram_rows (J, B, B), beta/labels/gas/inner_rows
    (J, B), pkg (B*J, 3K+4) in ``build_pkg_jacobi`` row order, sigmaE
    scalar.  Returns (dlane (J, B), beta_new (J, B), labels_new (J, B),
    v (G, K), bacc (G,)).  On CUDA tensors it launches ``csrc/serial.cu``'s
    solve once (``bayesr_round_solve.launches``) or raises; on CPU tensors
    it runs ``bayesr_round_solve_reference``."""
    if r_rows.device.type == "cpu":
        return bayesr_round_solve_reference(
            r_rows, gram_rows, beta_rows, labels_rows, gas_rows, inner_rows,
            pkg, sigmaE, K=K, G=G)
    out = _round_solve_cuda(K, G, r_rows, gram_rows, beta_rows, labels_rows,
                            gas_rows, inner_rows, pkg, sigmaE)
    bayesr_round_solve.launches += 1
    return out


bayesr_round_solve.launches = 0


def bayesr_round_solve_reference(r_rows, gram_rows, beta_rows, labels_rows,
                                 gas_rows, inner_rows, pkg, sigmaE, *,
                                 K: int, G: int):
    """The plain torch version of ``bayesr_round_solve``."""
    J, B = r_rows.shape
    f32 = torch.float32
    sE = torch.as_tensor(sigmaE, dtype=f32, device=r_rows.device)
    d, krec = _solve_plain(K, r_rows, gram_rows, beta_rows, inner_rows,
                           _by_block(pkg, J, B), 0.5 / sE)
    beta_new = beta_rows.to(f32) + d
    labels_new = torch.where(krec >= 0, krec, labels_rows.to(torch.int32))
    in_g = gas_rows.long()[..., None] == torch.arange(G, device=d.device)
    hits = krec[..., None] == torch.arange(K, device=d.device)
    v = (in_g[..., None] & hits[..., None, :]).sum(dim=(0, 1)).to(f32)
    b2 = torch.where(krec > 0, beta_new * beta_new, 0.0)
    bacc = torch.where(in_g, b2[..., None], 0.0).sum(dim=(0, 1))
    return d, beta_new, labels_new, v, bacc


def horseshoe_round_solve(r_rows, gram_rows, beta_rows, inner_rows, pkg):
    """One round's batched horseshoe solve, shaped like
    ``horseshoe_round_solve_pallas``: pkg (B*J, 5) in
    ``build_pkg_hs_jacobi`` row order; returns (dlane (J, B), beta_new
    (J, B)).  On CUDA tensors it launches ``csrc/serial.cu``'s solve once
    (``horseshoe_round_solve.launches``) or raises; on CPU tensors it runs
    ``horseshoe_round_solve_reference``."""
    if r_rows.device.type == "cpu":
        return horseshoe_round_solve_reference(r_rows, gram_rows, beta_rows,
                                               inner_rows, pkg)
    d, beta_new, _, _, _ = _round_solve_cuda(
        0, 0, r_rows, gram_rows, beta_rows, None, None, inner_rows, pkg,
        None)
    horseshoe_round_solve.launches += 1
    return d, beta_new


horseshoe_round_solve.launches = 0


def horseshoe_round_solve_reference(r_rows, gram_rows, beta_rows, inner_rows,
                                    pkg):
    """The plain torch version of ``horseshoe_round_solve``."""
    J, B = r_rows.shape
    d, _ = _solve_plain(0, r_rows, gram_rows, beta_rows, inner_rows,
                        _by_block(pkg, J, B), None)
    return d, beta_rows.to(torch.float32) + d


def _round_solve_cuda(K, G, r_rows, gram_rows, beta_rows, labels_rows,
                      gas_rows, inner_rows, pkg, sigmaE):
    """A round solve through ``serial_round_solve``: the position-ordered
    pkg is laid out as the sweep's solve reads its operands (tables, xsq
    and valid by marker j*B + l, p/z by position j*B + s)."""
    from . import _cuda

    lib = _cuda.library("serial")
    dev = r_rows.device
    J, B = r_rows.shape
    F = 3 * K if K else 2
    max_b = (lib.lib.serial_max_block() if J == 1
             else lib.lib.serial_max_row_block())
    if not 1 <= B <= max_b:
        raise ValueError(f"round solve takes blocks of 1 to {max_b} "
                         f"markers (B={B}, J={J})")
    if K and not 2 <= K <= lib.lib.serial_max_components():
        raise ValueError(f"round solve takes 2 <= K <= "
                         f"{lib.lib.serial_max_components()} (K={K})")
    f32, i32 = torch.float32, torch.int32
    arg = _operands(dev)
    inner = arg(inner_rows, i32, (J, B), "inner_rows")
    # the fields after the table: [p,] z, xsq, valid (the horseshoe has no p)
    zc = F + 1 if K else F
    pk = _by_block(arg(pkg, f32, (B * J, zc + 3), "pkg"), J, B)  # (J, B, *)
    at = (torch.arange(J, device=dev)[:, None] * B + inner.long()).reshape(-1)

    def by_marker(x):
        out = torch.empty_like(x.reshape(J * B, *x.shape[2:]))
        out[at] = x.reshape(J * B, *x.shape[2:])
        return out.contiguous()

    tbl = by_marker(pk[..., :F])
    xsq = by_marker(pk[..., zc + 1])
    valid = by_marker(pk[..., zc + 2] > 0)
    p = pk[..., F].reshape(-1).contiguous() if K else None
    z = pk[..., zc].reshape(-1).contiguous()
    r1 = torch.zeros((J * B + 1,), dtype=f32, device=dev)
    r1[:J * B] = arg(r_rows, f32, (J, B), "r_rows").reshape(-1)
    beta = arg(beta_rows, f32, (J, B), "beta_rows").reshape(-1).clone()
    labels = (arg(labels_rows, i32, (J, B), "labels_rows").reshape(-1).clone()
              if K else None)
    gas = arg(gas_rows, i32, (J, B), "gas_rows").reshape(-1) if K else None
    sE = arg(sigmaE, f32, (), "sigmaE").reshape(1) if K else None
    gram = arg(gram_rows, f32, (J, B, B), "gram_rows")
    border = torch.arange(J, dtype=i32, device=dev)
    d = torch.empty((J * B,), dtype=f32, device=dev)
    vpart = torch.empty((J, G, K), dtype=f32, device=dev) if K else None
    bpart = torch.empty((J, G), dtype=f32, device=dev) if K else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.lib.serial_round_solve(
        J, B, K, G, *(_ptr(t) for t in (
            border, inner, gram, tbl, xsq, valid, gas, beta, labels, r1, p,
            z, sE, d, vpart, bpart)), stream)
    lib.check(rc, "serial_round_solve launch")
    if not K:
        return d.view(J, B), beta.view(J, B), None, None, None
    return (d.view(J, B), beta.view(J, B), labels.view(J, B),
            vpart.sum(dim=0), bpart.sum(dim=0))
