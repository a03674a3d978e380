"""Strided-rounds BayesR block-Jacobi sweep on 2-bit packed genotypes.

Counterpart of ``bayesrrcpp_tpu/ops/pallas_jacobi_t.py:bayesr_jacobi_t_pallas``
in its fold-affine packed mode.  Semantics (the Markov kernel the port keeps):

- a sweep is nr = nb / J rounds; round r sweeps slab rho[r], the J blocks
  {j*nr + rho[r] : j < J}, every block against the round-start eps, and the
  round's J*B updates are applied to eps at once;
- position t of block j visits marker (j*nr + s)*B + inner[j*nr + s, t]
  and reads p/z[(s*J + j)*B + t] -- the variates are indexed by canonical
  slab, not by visit order;
- within a block, exact sequential Gibbs with the kernel's per-step algebra
  (``_tables`` below, pallas_jacobi_t.py:103-125 and :534-585).

``bayesr_jacobi_t`` is the entry point: on CUDA tensors it launches the
hand-written kernel of ``csrc/jacobi_t.cu`` (3 launches per round, counted
in ``bayesr_jacobi_t.launches``) or raises; on CPU tensors it runs the plain
version ``bayesr_jacobi_t_reference``.  eps is in natural individual order,
padded with zeros to Npad = 16 * words.shape[1].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import genotypes

# launches per round of the CUDA sweep: dot, solve, apply
LAUNCHES_PER_ROUND = 3


class SweepResult(NamedTuple):
    eps: torch.Tensor        # (Npad,) or (N,) residuals after the sweep
    beta: torch.Tensor       # (Mpad,)
    labels: torch.Tensor     # (Mpad,) int32
    v: torch.Tensor          # (G, K) label counts of the hits
    beta_acum: torch.Tensor  # (G,) sum of beta^2 over slab hits


def _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing):
    nb = gram.shape[0]
    if nb % J:
        raise ValueError(f"jacobi sweep needs J | nb (J={J}, nb={nb})")
    if x_mean is None or XT_pad.dtype != torch.int32:
        raise NotImplementedError(
            "the strided Jacobi sweep is ported for 2-bit packed words only; "
            "its dense f32 and int8 modes are ROADMAP Queue 2 entry 1")
    if missing:
        raise NotImplementedError(
            "packed genotypes with missing calls (the kernel's `miss` mode) "
            "are ROADMAP Queue 2 entry 1 / Queue 1 item 7")
    if not fold_affine:
        raise ValueError("packed jacobi sweep needs fold_affine=True "
                         "(missing-free codes)")


def bayesr_jacobi_t(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                    rho, inner_perm, p_arr, z_arr,
                    pi, cva, sigmaE, sigmaGG, g_assign_pad, valid_pad,
                    *, J: int = 64, x_mean=None, x_scale=None, x_xsum=None,
                    fold_affine: bool = False, row_valid=None,
                    missing: bool = False) -> SweepResult:
    """One strided-rounds BayesR sweep (see the module docstring).

    XT_pad (Mpad, Npad/16) int32 words; gram (nb, B, B); xsq_pad, beta_pad,
    labels_pad, g_assign_pad, valid_pad, p_arr, z_arr, x_mean, x_scale
    (Mpad,); eps and row_valid (Npad,); rho (nr,); inner_perm (nb, B); pi
    (G, K); cva (G, K-1); sigmaE scalar; sigmaGG (G,).  ``x_xsum`` is
    accepted for signature parity with the JAX wrapper: the port sums eps
    afresh each round instead of tracking it.
    """
    _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing)
    if row_valid is None:
        raise ValueError("packed jacobi sweep needs row_valid")
    if XT_pad.device.type == "cpu":
        return bayesr_jacobi_t_reference(
            XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad, rho,
            inner_perm, p_arr, z_arr, pi, cva, sigmaE, sigmaGG,
            g_assign_pad, valid_pad, J=J, x_mean=x_mean, x_scale=x_scale,
            fold_affine=fold_affine, row_valid=row_valid)
    if XT_pad.device.type != "cuda":
        raise NotImplementedError(
            f"no jacobi_t kernel for device {XT_pad.device}")
    return _sweep_cuda(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                       rho, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                       sigmaGG, g_assign_pad, valid_pad, J, x_mean, x_scale,
                       row_valid)


bayesr_jacobi_t.launches = 0


def _sweep_cuda(words, gram, xsq, eps, beta, labels, rho, inner, p, z, pi,
                cva, sigmaE, sigmaGG, gas, valid, J, mean, scale, row_valid):
    from . import _cuda

    lib = _cuda.library("jacobi_t")
    dev = words.device
    Mpad, Nw = words.shape
    nb, B, _ = gram.shape
    G, K = pi.shape
    nr = nb // J
    Npad = Nw * genotypes.WORDS
    if nb * B != Mpad:
        raise ValueError(f"gram has {nb}x{B} markers, words {Mpad}")
    if not (2 <= B <= lib.lib.jacobi_t_max_block() and B % 2 == 0):
        raise ValueError(f"jacobi_t kernel takes blocks of an even number "
                         f"of markers <= 32 (B={B})")
    if not 2 <= K <= lib.lib.jacobi_t_max_components():
        raise ValueError(f"jacobi_t kernel takes 2 <= K <= 8 (K={K})")
    if J * B > lib.lib.jacobi_t_max_round():
        raise ValueError(f"jacobi_t kernel takes <= 4096 markers per round "
                         f"(J*B={J * B})")
    f32, i32 = torch.float32, torch.int32

    def arg(t, dtype, shape, name):
        if isinstance(t, torch.Tensor) and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, words on {dev}")
        t = torch.as_tensor(t, device=dev)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        return t.to(dtype).contiguous()

    words = arg(words, i32, (Mpad, Nw), "words")
    gram = arg(gram, f32, (nb, B, B), "gram")
    xsq = arg(xsq, f32, (Mpad,), "xsq")
    mean = arg(mean, f32, (Mpad,), "x_mean")
    scale = arg(scale, f32, (Mpad,), "x_scale")
    row_valid = arg(row_valid, torch.bool, (Npad,), "row_valid")
    beta_in = arg(beta, f32, (Mpad,), "beta")
    labels_in = arg(labels, i32, (Mpad,), "labels")
    rho = arg(rho, i32, (nr,), "rho")
    inner = arg(inner, i32, (nb, B), "inner_perm")
    p = arg(p, f32, (Mpad,), "p")
    z = arg(z, f32, (Mpad,), "z")
    pi = arg(pi, f32, (G, K), "pi")
    cva = arg(cva, f32, (G, K - 1), "cva")
    sigmaE = arg(sigmaE, f32, (), "sigmaE")
    sigmaGG = arg(sigmaGG, f32, (G,), "sigmaGG")
    gas = arg(gas, i32, (Mpad,), "g_assign")
    valid = arg(valid, torch.bool, (Mpad,), "valid")
    eps_out = torch.empty((Npad,), dtype=f32, device=dev)
    eps_out.copy_(arg(eps, f32, (Npad,), "eps"))

    nsplit = lib.lib.jacobi_t_dot_splits(Nw)
    beta_out = torch.empty((Mpad,), dtype=f32, device=dev)
    labels_out = torch.empty((Mpad,), dtype=i32, device=dev)
    partial = torch.empty(((J * B + 1) * nsplit,), dtype=f32, device=dev)
    dsc = torch.empty((J * B,), dtype=f32, device=dev)
    dms = torch.empty((J,), dtype=f32, device=dev)
    vpart = torch.empty((nb * G * K,), dtype=f32, device=dev)
    bpart = torch.empty((nb * G,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.lib.jacobi_t_sweep(
        words.data_ptr(), Nw, nr, J, B, K, G, gram.data_ptr(),
        xsq.data_ptr(), mean.data_ptr(), scale.data_ptr(), eps_out.data_ptr(),
        row_valid.data_ptr(), beta_in.data_ptr(), labels_in.data_ptr(),
        beta_out.data_ptr(), labels_out.data_ptr(), rho.data_ptr(),
        inner.data_ptr(), p.data_ptr(), z.data_ptr(), pi.data_ptr(),
        cva.data_ptr(), sigmaE.data_ptr(), sigmaGG.data_ptr(),
        gas.data_ptr(), valid.data_ptr(), partial.data_ptr(), nsplit,
        dsc.data_ptr(), dms.data_ptr(), vpart.data_ptr(), bpart.data_ptr(),
        stream)
    lib.check(rc, "jacobi_t_sweep launch")
    bayesr_jacobi_t.launches += LAUNCHES_PER_ROUND * nr
    return SweepResult(eps_out, beta_out, labels_out,
                       vpart.view(nb, G, K).sum(dim=0),
                       bpart.view(nb, G).sum(dim=0))


def _tables(xsq, gas, pi, cva, sigmaE, sigmaGG):
    """Per-marker step constants (Mpad, K) each: lp, 1/denom and the slab
    sd, with the spike in column 0 (pallas_jacobi_t.py:_bayesr_tbl)."""
    f32 = torch.float32
    xsq = xsq.to(f32)
    gas = gas.long()
    sG = sigmaGG.to(f32)[gas]
    cva_m = cva.to(f32)[gas]
    sE = sigmaE.to(f32)
    denom = xsq[:, None] + (sE / sG[:, None]) / cva_m
    zero = torch.zeros((xsq.shape[0], 1), dtype=f32, device=xsq.device)
    invd = torch.cat([zero, 1.0 / denom], dim=1)
    sd = torch.cat([zero, torch.sqrt(sE / denom)], dim=1)
    tiny = torch.finfo(f32).tiny
    logpi = torch.log(torch.clamp_min(pi.to(f32)[gas], tiny))
    lp = torch.cat([
        logpi[:, 0:1],
        logpi[:, 1:] - 0.5 * torch.log(
            (sG[:, None] / sE) * xsq[:, None] * cva_m + 1.0),
    ], dim=1)
    return lp, invd, sd


def bayesr_jacobi_t_reference(XT_pad, gram, xsq_pad, eps, beta_pad,
                              labels_pad, rho, inner_perm, p_arr, z_arr,
                              pi, cva, sigmaE, sigmaGG, g_assign_pad,
                              valid_pad, *, J: int, x_mean=None, x_scale=None,
                              x_xsum=None, fold_affine: bool = False,
                              row_valid=None, missing: bool = False
                              ) -> SweepResult:
    """The plain torch version of ``bayesr_jacobi_t``: each round decodes its
    J*B markers to standardized f32 rows and runs the J blocks' sequential
    solves batched over the blocks, with the kernel's algebra."""
    _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing)
    f32 = torch.float32
    dev = XT_pad.device
    nb, B, _ = gram.shape
    nr = nb // J
    G, K = pi.shape
    sigmaE = torch.as_tensor(sigmaE, dtype=f32, device=dev)
    lp, invd, sd = _tables(xsq_pad, g_assign_pad, pi, cva, sigmaE, sigmaGG)
    xsq = xsq_pad.to(f32)
    okf = valid_pad.to(f32)
    gas = g_assign_pad.long()
    mean, scale = x_mean.to(f32), x_scale.to(f32)
    lane_ok = row_valid.to(torch.bool)
    eps = eps.to(f32).clone()
    beta = beta_pad.to(f32).clone()
    labels = labels_pad.to(torch.int32).clone()
    v = torch.zeros((G, K), dtype=f32, device=dev)
    bacc = torch.zeros((G,), dtype=f32, device=dev)
    half_invsE = 0.5 / sigmaE
    jj = torch.arange(J, device=dev)
    lanes = torch.arange(B, device=dev)
    kcol = torch.arange(K, device=dev)
    gram = gram.to(f32)
    inner_perm = inner_perm.long()
    for r in range(nr):
        s = rho[r].long()
        blk = jj * nr + s                                     # (J,)
        rows = (blk[:, None] * B + lanes).reshape(-1)         # (J*B,)
        x = genotypes.decode_rows(XT_pad[rows], mean[rows], scale[rows],
                                  lane_ok)                    # (J*B, Npad)
        rr = (x @ eps).view(J, B)
        bold = beta[rows].view(J, B)
        inn = inner_perm[blk]                                 # (J, B)
        pos = (s * J + jj)[:, None] * B + lanes
        p_r, z_r = p_arr[pos].to(f32), z_arr[pos].to(f32)
        G_r = gram[blk]                                       # (J, B, B)
        d = torch.zeros((J, B), dtype=f32, device=dev)
        krec = torch.full((J, B), -1, dtype=torch.int32, device=dev)
        for t in range(B):
            m = inn[:, t]                                     # (J,)
            mg = blk * B + m                                  # markers
            num = rr[jj, m] + bold[jj, m] * xsq[mg]
            muk = num[:, None] * invd[mg]                     # (J, K)
            logL = lp[mg] + (half_invsE * num)[:, None] * muk
            ksel = torch.full((J,), K, dtype=torch.int64, device=dev)
            acum = torch.zeros((J,), dtype=f32, device=dev)
            for k in range(K):
                lk = logL[:, k]
                gmax = torch.abs(logL[:, 1] - lk)
                for kk in range(2, K):
                    gmax = torch.maximum(gmax, torch.abs(logL[:, kk] - lk))
                S = torch.exp(logL[:, 0] - lk)
                for kk in range(1, K):
                    S = S + torch.exp(logL[:, kk] - lk)
                w = torch.where(gmax > 700.0, torch.zeros_like(S), 1.0 / S)
                acum = acum + w
                hit = (p_r[:, t] <= acum) & (ksel == K)
                ksel = torch.where(hit, torch.full_like(ksel, k), ksel)
            hitm = ksel < K
            kc = torch.clamp_max(ksel, K - 1)[:, None]
            mu_sel = torch.where(hitm, muk.gather(1, kc)[:, 0], 0.0)
            sd_sel = torch.where(hitm, sd[mg].gather(1, kc)[:, 0], 0.0)
            b_old = bold[jj, m]
            beta_new = torch.where(hitm, mu_sel + sd_sel * z_r[:, t], b_old)
            dd = okf[mg] * (beta_new - b_old)
            rr = rr - G_r[jj, m, :] * dd[:, None]
            d[jj, m] = dd
            krec[jj, m] = torch.where((okf[mg] > 0) & hitm,
                                      ksel.to(torch.int32), -1)
        bnew = bold + d
        beta[rows] = bnew.reshape(-1)
        labels[rows] = torch.where(krec >= 0, krec,
                                   labels[rows].view(J, B)).reshape(-1)
        g_r = gas[rows].view(J, B)
        for g in range(G):
            in_g = g_r == g
            v[g] += ((krec[:, :, None] == kcol) & in_g[:, :, None]).sum(
                dim=(0, 1)).to(f32)
            bacc[g] += torch.where((krec > 0) & in_g, bnew * bnew,
                                   0.0).sum()
        eps = eps - d.reshape(-1) @ x
    return SweepResult(eps, beta, labels, v, bacc)
