"""The exact sequential (J=1) BayesR and horseshoe sweeps on dense f32 rows,
int8 genotype codes or 2-bit packed genotypes.

Counterpart of ``bayesrrcpp_tpu/ops/pallas_sweep.py:bayesr_sweep_pallas``
and ``horseshoe_sweep_pallas`` in their dense f32 mode and their two
quantized modes, on int8 codes and on 2-bit words, the semantics anchor of
the JAX package: no Jacobi rounds, every marker update sees every earlier
one.  ``x_mean=None`` is the dense mode (XT_pad (Mpad, N) standardized f32
rows, eps (N,)); on codes (XT_pad (Mpad, N) int8, eps (N,), no
``row_valid``) or words, ``fold_affine=True`` (no missing call) is the
``_qf`` mode and ``fold_affine=False`` the in-kernel decode ``_q`` (the
codes hold missing calls, code 3), one chain only.  Semantics (the Markov kernel the port
keeps):

- the blocks run in ``block_order`` (which may be shorter than nb, a
  prefix of the sweep); position s of the block at sweep position i
  visits marker ``block_order[i]*B + inner_perm[block_order[i], s]`` and
  reads p/z[i*B + s], by sweep position (pallas_sweep.py:495-550);
- per block: r = s*(C.eps) - (m*s)*sum(eps) from the raw codes C, B exact
  sequential Gibbs steps against r kept current by rank-1 Gram updates,
  then eps -= (d*s).C - d.(m*s) (pallas_sweep.py:177-301); in the ``_q``
  mode r = x.eps and eps -= d.x with x = (c - m)*s decoded in place, 0 for
  code 3 and for the individuals n >= N (pallas_sweep.py:_decode_tile);
  dense X has that algebra on its own rows: r = x.eps, eps -= d.x;
- fold mode: sum(eps) is recomputed from eps at each chunk start and
  tracked as sum(eps) - d.xsum inside a chunk; the chunks are the JAX
  wrapper's, ``max_call_blocks`` or 65536 // B blocks each, the remainder
  first (pallas_sweep.py:508, :573, :593-609), so the port's sums and
  labels follow JAX's at near ties (the ``_q`` mode carries nothing from
  one block to the next but eps, so its chunks change nothing);
- the per-marker step constants are tables built here in plain torch
  (``build_pkg``, ``build_pkg_hs``; pallas_multichain.py:74, :497) and
  read by the step; the horseshoe draws num*(1/denom) + sd*z, as the
  fused TPU kernel does (pallas_multichain.py:585).

``bayesr_sweep`` and ``horseshoe_sweep`` are the entry points: on CUDA
tensors each launches the hand-written kernels of ``csrc/serial.cu``
(dot, solve and apply per block, counted in ``<entry point>.launches``) or
raises; on CPU tensors each runs its plain version (``*_reference``).  eps
is in natural individual order: of length N for dense X and int8 codes,
padded with zeros to Npad = 16 * words.shape[1] for words.  The fused multi-chain
sweeps (``ops/multichain.py``) run the same kernels, through the same
entry point, with a chain axis.
"""
from __future__ import annotations

import torch

from . import genotypes
from .jacobi_t import (SweepResult, _hs_tables, _operands, _ptr,
                       bayesr_tables, categorical_draw)

# launches per block position of the CUDA sweeps: dot, solve, apply
LAUNCHES_PER_BLOCK = 3


def call_blocks(n_pos: int, B: int, max_call_blocks=None) -> int:
    """Blocks per chunk of a sweep of ``n_pos`` positions, as the JAX
    wrapper chunks it (pallas_sweep.py:508)."""
    return max(1, min(n_pos, max_call_blocks or (65536 // B)))


def build_pkg(xsq, gas, pi, cva, sigmaE, sigmaGG):
    """BayesR's per-(chain, marker) step table (C, Mpad, 3K): [log-prior,
    1/denom, slab sd], the spike in column 0 of each (pallas_multichain.py:
    build_pkg, less its p/z columns).  pi (C, G, K), sigmaE (C,), sigmaGG
    (C, G)."""
    return torch.cat(bayesr_tables(xsq, gas, pi, cva, sigmaE, sigmaGG),
                     dim=-1)


def build_pkg_hs(xsq, lam, tau, c2, sigmaE):
    """The horseshoe's per-(chain, marker) table (C, Mpad, 2): [1/denom,
    sd] (pallas_multichain.py:build_pkg_hs).  lam (C, Mpad); tau, c2,
    sigmaE (C,)."""
    return torch.stack(_hs_tables(xsq, lam, tau, c2, sigmaE), dim=-1)


def check_mode(XT_pad, x_mean, x_xsum, fold_affine, row_valid, fused=False):
    """Reject what the TPU wrappers reject.  Dense f32 rows (``x_mean``
    None) read no ``fold_affine``, ``x_xsum`` or ``row_valid``; int8 codes
    read no ``row_valid``.  The fused sweeps take no in-kernel decode, as
    ``bayesr_sweep_pallas_mc`` takes none (pallas_multichain.py:381-394)."""
    if x_mean is None:
        if not XT_pad.dtype.is_floating_point:
            raise ValueError(f"dense serial sweep needs float rows, not "
                             f"{XT_pad.dtype}")
        return
    if XT_pad.dtype not in (torch.int8, torch.int32):
        raise ValueError("quantized serial sweep needs int8 codes or int32 "
                         f"words, not {XT_pad.dtype}")
    if XT_pad.dtype == torch.int32 and row_valid is None:
        raise ValueError("packed serial sweep needs row_valid")
    if fold_affine:
        if x_xsum is None:
            raise ValueError("quantized fold_affine sweep needs x_xsum")
    elif fused:
        raise NotImplementedError(
            "the fused multi-chain sweep takes quantized X with fold_affine "
            "only (no missing calls); the in-kernel decode is single-chain "
            "only, as in the JAX package")


def on_lanes(lane_ok, new, old):
    """``new`` on the lanes where ``lane_ok``, ``old`` elsewhere; None (int8
    codes and dense rows have no pad lanes): ``new`` everywhere."""
    return new if lane_ok is None else torch.where(lane_ok, new, old)


def position_markers(block_order, inner_perm, B):
    """The marker each sweep position visits, (n*B,)."""
    border = block_order.long()
    return (border[:, None] * B + inner_perm.long()[border]).reshape(-1)


def run(plain, fused, K, G, chunk, words, gram, xsq, eps, beta, labels,
        border, inner, p, z, tbl, sigmaE, gas, valid, mean, scale, xsum,
        row_valid, fold=True):
    """One sweep of C chains (every per-chain operand with a leading chain
    axis; p/z (C, n*B) by position, or (C, Mpad) by marker when
    ``fused``): the plain version if ``plain``, else the CUDA kernels.
    K == 0 is the horseshoe; ``mean`` None is the dense mode, else
    ``fold=False`` the in-kernel decode mode (C == 1); ``words`` int8 are
    codes (no ``row_valid``).  Returns (eps, beta,
    labels, v, bacc), the last three None for the horseshoe."""
    fold = fold and mean is not None
    if plain:
        if fused:
            at = position_markers(border, inner, gram.shape[1])
            p = None if p is None else p[:, at]
            z = z[:, at]
        return _plain_sweep(K, G, chunk, words, gram, xsq, eps, beta, labels,
                            border, inner, p, z, tbl, sigmaE, gas, valid,
                            mean, scale, xsum, row_valid, fold)
    if words.device.type != "cuda":
        raise NotImplementedError(f"no serial kernel for device "
                                  f"{words.device}")
    return _sweep_cuda(fused, K, G, chunk, words, gram, xsq, eps, beta,
                       labels, border, inner, p, z, tbl, sigmaE, gas, valid,
                       mean, scale, xsum, row_valid, fold)


def _plain_sweep(K, G, chunk, words, gram, xsq, eps, beta, labels, border,
                 inner, p, z, tbl, sigmaE, gas, valid, mean, scale, xsum,
                 row_valid, fold):
    """The plain torch version of a sweep of C chains, block by block with
    the kernels' algebra (p/z by position), in f32, or in float64 when eps
    is float64 (a yardstick for the f32 rounding; the step tables stay
    f32).  Dense X (``mean`` None) takes its rows as they are."""
    ft = torch.float64 if eps.dtype == torch.float64 else torch.float32
    dev = words.device
    B = gram.shape[1]
    C = eps.shape[0]
    n = border.shape[0]
    dense = mean is None
    eps = eps.to(ft).clone()
    beta = beta.to(ft).clone()
    okf = valid.to(ft)
    xsq = xsq.to(ft)
    lane_ok = None if row_valid is None else row_valid.to(torch.bool)
    if not dense:
        mean, scale = mean.to(ft), scale.to(ft)
    xsum = xsum.to(ft) if fold else None
    if K:
        labels = labels.to(torch.int32).clone()
        v = torch.zeros((C, G, K), dtype=ft, device=dev)
        bacc = torch.zeros((C, G), dtype=ft, device=dev)
        half_invsE = 0.5 / sigmaE.to(ft)
        p = p.to(ft)
        kcol = torch.arange(K, device=dev)
    z = z.to(ft)
    rem = n % chunk
    for i, blk in enumerate(border.tolist()):
        rows = slice(blk * B, blk * B + B)
        if fold:
            if i == 0 or (i >= rem and (i - rem) % chunk == 0):
                esum = eps.sum(dim=-1)                     # chunk start
            codes = genotypes.decode_codes(words[rows]).to(ft)  # (B, lanes)
            sc = scale[rows]
            ms = mean[rows] * sc
            r = (eps @ codes.T) * sc - ms * esum[:, None]  # (C, B)
        else:
            x = (words[rows].to(ft) if dense
                 else genotypes.decode_rows(words[rows], mean[rows],
                                            scale[rows], lane_ok))  # (B, lanes)
            r = eps @ x.T
        bo, ok, xs = beta[:, rows], okf[rows], xsq[rows]
        tb = tbl[:, rows].to(ft)                          # (C, B, F)
        Gb = gram[blk].to(ft)
        d = torch.zeros((C, B), dtype=ft, device=dev)
        krec = torch.full((C, B), -1, dtype=torch.int32, device=dev)
        for t, m in enumerate(inner[blk].tolist()):
            num = r[:, m] + bo[:, m] * xs[m]
            if K:
                q = tb[:, m]
                dd, krec[:, m] = categorical_draw(
                    q[:, :K], q[:, K:2 * K], q[:, 2 * K:], num, half_invsE,
                    p[:, i * B + t], z[:, i * B + t], bo[:, m], ok[m])
            else:
                beta_new = num * tb[:, m, 0] + tb[:, m, 1] * z[:, i * B + t]
                dd = ok[m] * (beta_new - bo[:, m])
            r = r - Gb[m][None, :] * dd[:, None]
            d[:, m] = dd
        bnew = bo + d
        beta[:, rows] = bnew
        if K:
            labels[:, rows] = torch.where(krec >= 0, krec, labels[:, rows])
            g_r = gas[rows]
            for g in range(G):
                in_g = g_r == g
                v[:, g] += ((krec[..., None] == kcol) & in_g[:, None]).sum(
                    dim=1).to(ft)
                bacc[:, g] += torch.where((krec > 0) & in_g, bnew * bnew,
                                          0.0).sum(dim=-1)
        if fold:
            esum = esum - (d * xsum[rows]).sum(dim=-1)
            dms = (d * ms).sum(dim=-1)
            eps = on_lanes(lane_ok, eps - ((d * sc) @ codes - dms[:, None]),
                           eps)
        else:
            eps = on_lanes(lane_ok, eps - d @ x, eps)
    if not K:
        return eps, beta, None, None, None
    return eps, beta, labels, v, bacc


def _sweep_cuda(fused, K, G, chunk, words, gram, xsq, eps, beta, labels,
                border, inner, p, z, tbl, sigmaE, gas, valid, mean, scale,
                xsum, row_valid, fold, J=1):
    """The CUDA sweep of ``run``; ``J`` > 1 sweeps J blocks of the order a
    round, every block against the round-start eps (the row layout, one
    chain: ``ops/jacobi.py``), and ``chunk`` then counts rounds."""
    from . import _cuda

    lib = _cuda.library("serial")
    dev = words.device
    Mpad, Nw = words.shape
    nb, B, _ = gram.shape
    C = eps.shape[0]
    n = border.shape[0]
    dense = mean is None
    int8 = words.dtype == torch.int8
    Npad = Nw if dense or int8 else Nw * genotypes.WORDS
    if nb * B != Mpad:
        raise ValueError(f"gram has {nb}x{B} markers, words {Mpad}")
    max_b = (lib.lib.serial_max_block() if J == 1
             else lib.lib.serial_max_row_block())
    if not 1 <= B <= max_b:
        raise ValueError(f"{'serial' if J == 1 else 'row-layout'} kernel "
                         f"takes blocks of 1 to {max_b} markers (B={B})")
    if K and not 2 <= K <= lib.lib.serial_max_components():
        raise ValueError(f"serial kernel takes 2 <= K <= "
                         f"{lib.lib.serial_max_components()} (K={K})")
    if not 1 <= n <= nb:
        raise ValueError(f"block_order has {n} blocks, the data {nb}")
    if n % J or (J > 1 and (C != 1 or not (fold or dense))):
        raise ValueError(f"J={J} blocks a round need one chain, a block "
                         f"count divisible by J ({n}), and no in-kernel "
                         "decode")
    if C > lib.lib.serial_max_chains():
        raise ValueError(f"{C} chains in one fused launch")
    if not (fold or dense) and C != 1:
        raise ValueError("the in-kernel decode sweeps one chain")
    f32, i32 = torch.float32, torch.int32
    arg = _operands(dev)
    F = 3 * K if K else 2
    pz_shape = (C, Mpad) if fused else (C, n * B)

    words = arg(words, f32 if dense else torch.int8 if int8 else i32,
                (Mpad, Nw), "X" if dense else "codes" if int8 else "words")
    ops = dict(
        border=arg(border, i32, (n,), "block_order"),
        inner=arg(inner, i32, (nb, B), "inner_perm"),
        gram=arg(gram, f32, (nb, B, B), "gram"),
        tbl=arg(tbl, f32, (C, Mpad, F), "table"),
        xsq=arg(xsq, f32, (Mpad,), "xsq"),
        valid=arg(valid, torch.bool, (Mpad,), "valid"),
        gas=arg(gas, i32, (Mpad,), "g_assign") if K else None)
    # the dense mode reads no mean, scale, column sums or lane mask, int8
    # codes no lane mask
    if not dense:
        ops.update(
            mean=arg(mean, f32, (Mpad,), "x_mean"),
            scale=arg(scale, f32, (Mpad,), "x_scale"),
            xsum=(arg(xsum, f32, (Mpad,), "x_xsum") if fold
                  else torch.zeros((Mpad,), dtype=f32, device=dev)))
    row_valid = (None if dense or int8
                 else arg(row_valid, torch.bool, (Npad,), "row_valid"))
    eps_out = torch.empty((C, Npad), dtype=f32, device=dev)
    eps_out.copy_(arg(eps, f32, (C, Npad), "eps"))
    beta_out = arg(beta, f32, (C, Mpad), "beta").clone()
    labels_out = (arg(labels, i32, (C, Mpad), "labels").clone() if K
                  else None)
    p = arg(p, f32, pz_shape, "p") if K else None
    z = arg(z, f32, pz_shape, "z")
    sigmaE = arg(sigmaE, f32, (C,), "sigmaE") if K else None
    nsplit = (lib.lib.serial_dense_dot_splits(Nw) if dense
              else lib.lib.serial_int8_dot_splits(Nw) if int8
              else lib.lib.serial_dot_splits(Nw))
    partial = torch.empty((C * nsplit * (J * B + 1),), dtype=f32, device=dev)
    esum = torch.empty((C,), dtype=f32, device=dev)
    dsc = torch.empty((C * J * B,), dtype=f32, device=dev)
    dms = torch.empty((C * J,), dtype=f32, device=dev)
    espart = torch.empty((C * J,), dtype=f32, device=dev)
    vpart = (torch.empty((C, n, G, K), dtype=f32, device=dev) if K
             else None)
    bpart = torch.empty((C, n, G), dtype=f32, device=dev) if K else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the storage mode of csrc/serial.cu: 0 fold, 1 in-kernel decode, 2
    # dense, 3 int8 fold, 4 int8 in-kernel decode
    mode = 2 if dense else int(not fold) + (3 if int8 else 0)
    ints = (C, int(fused), Nw, n, chunk, B, K, G if K else 0, Mpad, nsplit,
            mode, J)
    ptrs = [_ptr(t) for t in (
        words, ops["border"], ops["inner"], ops["gram"], ops["tbl"],
        ops["xsq"], ops.get("mean"), ops.get("scale"), ops.get("xsum"),
        ops["valid"], ops["gas"], eps_out, row_valid,
        beta_out, labels_out, p, z, sigmaE,
        partial, esum, dsc, dms, espart, vpart, bpart)] + [stream]
    lib.check(lib.lib.serial_sweep(*ints, *ptrs), "serial_sweep launch")
    if not K:
        return eps_out, beta_out, None, None, None
    # bacc chain by chain: the same reduction for a fused chain as for a
    # single chain, so the two agree bitwise
    return (eps_out, beta_out, labels_out, vpart.sum(dim=1),
            torch.stack([b.sum(dim=0) for b in bpart]))


def _lead(x, dev):
    """A per-chain operand of one chain with a chain axis of 1."""
    return torch.as_tensor(x, dtype=torch.float32, device=dev)[None]


def _bayesr(plain, XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
            block_order, inner_perm, p_arr, z_arr, pi, cva, sigmaE, sigmaGG,
            g_assign_pad, valid_pad, x_mean, x_scale, x_xsum, fold_affine,
            row_valid, max_call_blocks):
    check_mode(XT_pad, x_mean, x_xsum, fold_affine, row_valid)
    dev = XT_pad.device
    B = gram.shape[1]
    n = block_order.shape[0]
    if p_arr.shape[-1] != n * B or z_arr.shape[-1] != n * B:
        raise ValueError("p/z streams must have one entry per sweep position")
    G, K = pi.shape
    sigmaE = _lead(sigmaE, dev)
    tbl = build_pkg(xsq_pad, g_assign_pad, _lead(pi, dev), cva, sigmaE,
                    _lead(sigmaGG, dev))
    out = run(plain, False, K, G, call_blocks(n, B, max_call_blocks), XT_pad,
              gram, xsq_pad, eps[None], beta_pad[None], labels_pad[None],
              block_order, inner_perm, p_arr[None], z_arr[None], tbl, sigmaE,
              g_assign_pad, valid_pad, x_mean, x_scale, x_xsum, row_valid,
              fold_affine)
    return SweepResult(*(x[0] for x in out))


def bayesr_sweep(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                 block_order, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                 sigmaGG, g_assign_pad, valid_pad, *, x_mean=None,
                 x_scale=None, x_xsum=None, fold_affine: bool = True,
                 row_valid=None, max_call_blocks=None) -> SweepResult:
    """One serial BayesR sweep (see the module docstring), with the argument
    order and outputs of ``bayesr_sweep_pallas``.

    XT_pad (Mpad, Npad/16) int32 words, (Mpad, N) int8 codes (eps (N,), no
    row_valid), or (Mpad, N) f32 standardized rows with ``x_mean`` None
    (the dense mode: eps (N,), no x_scale, x_xsum, row_valid); gram (nb, B,
    B); xsq_pad, beta_pad,
    labels_pad, g_assign_pad, valid_pad, x_mean, x_scale, x_xsum (Mpad,);
    eps and row_valid (Npad,); block_order (n,) with n <= nb, each block at
    most once; inner_perm (nb, B); p_arr, z_arr (n*B,) by sweep position;
    pi (G, K); cva (G, K-1); sigmaE scalar; sigmaGG (G,).
    ``fold_affine=False``: the in-kernel decode mode, for codes or words
    with missing calls (``x_xsum`` is then not read).  On CUDA tensors
    it launches ``csrc/serial.cu`` (3 launches per block, counted in
    ``bayesr_sweep.launches``) or raises; on CPU tensors it runs
    ``bayesr_sweep_reference``.
    """
    plain = XT_pad.device.type == "cpu"
    res = _bayesr(plain, XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                  block_order, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                  sigmaGG, g_assign_pad, valid_pad, x_mean, x_scale, x_xsum,
                  fold_affine, row_valid, max_call_blocks)
    if not plain:
        bayesr_sweep.launches += LAUNCHES_PER_BLOCK * block_order.shape[0]
    return res


bayesr_sweep.launches = 0


def bayesr_sweep_reference(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                           block_order, inner_perm, p_arr, z_arr, pi, cva,
                           sigmaE, sigmaGG, g_assign_pad, valid_pad, *,
                           x_mean=None, x_scale=None, x_xsum=None,
                           fold_affine: bool = True, row_valid=None,
                           max_call_blocks=None) -> SweepResult:
    """The plain torch version of ``bayesr_sweep``: each block decodes its
    B rows of codes and runs the kernels' algebra step by step."""
    return _bayesr(True, XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                   block_order, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                   sigmaGG, g_assign_pad, valid_pad, x_mean, x_scale, x_xsum,
                   fold_affine, row_valid, max_call_blocks)


# ---------------------------------------------------------------- horseshoe


def _horseshoe(plain, XT_pad, gram, xsq_pad, eps, beta_pad, block_order,
               inner_perm, z_arr, lam_pad, tau, c2, sigmaE, valid_pad, x_mean,
               x_scale, x_xsum, fold_affine, row_valid, max_call_blocks):
    check_mode(XT_pad, x_mean, x_xsum, fold_affine, row_valid)
    dev = XT_pad.device
    B = gram.shape[1]
    n = block_order.shape[0]
    if z_arr.shape[-1] != n * B:
        raise ValueError("z stream must have one entry per sweep position")
    tbl = build_pkg_hs(xsq_pad, _lead(lam_pad, dev), _lead(tau, dev),
                       _lead(c2, dev), _lead(sigmaE, dev))
    out = run(plain, False, 0, 0, call_blocks(n, B, max_call_blocks), XT_pad,
              gram, xsq_pad, eps[None], beta_pad[None], None, block_order,
              inner_perm, None, z_arr[None], tbl, None, None, valid_pad,
              x_mean, x_scale, x_xsum, row_valid, fold_affine)
    return out[0][0], out[1][0]


def horseshoe_sweep(XT_pad, gram, xsq_pad, eps, beta_pad, block_order,
                    inner_perm, z_arr, lam_pad, tau, c2, sigmaE, valid_pad, *,
                    x_mean=None, x_scale=None, x_xsum=None,
                    fold_affine: bool = True, row_valid=None,
                    max_call_blocks=None):
    """One serial horseshoe sweep, shaped like ``horseshoe_sweep_pallas``:
    returns (eps, beta).  lam_pad (Mpad,); tau, c2 and sigmaE scalars; z_arr
    (n*B,) by sweep position; the rest as in ``bayesr_sweep``.  On CUDA
    tensors it launches ``csrc/serial.cu`` (3 launches per block, counted
    in ``horseshoe_sweep.launches``) or raises; on CPU tensors it runs
    ``horseshoe_sweep_reference``."""
    plain = XT_pad.device.type == "cpu"
    res = _horseshoe(plain, XT_pad, gram, xsq_pad, eps, beta_pad, block_order,
                     inner_perm, z_arr, lam_pad, tau, c2, sigmaE, valid_pad,
                     x_mean, x_scale, x_xsum, fold_affine, row_valid,
                     max_call_blocks)
    if not plain:
        horseshoe_sweep.launches += LAUNCHES_PER_BLOCK * block_order.shape[0]
    return res


horseshoe_sweep.launches = 0


def horseshoe_sweep_reference(XT_pad, gram, xsq_pad, eps, beta_pad,
                              block_order, inner_perm, z_arr, lam_pad, tau,
                              c2, sigmaE, valid_pad, *, x_mean=None,
                              x_scale=None, x_xsum=None,
                              fold_affine: bool = True, row_valid=None,
                              max_call_blocks=None):
    """The plain torch version of ``horseshoe_sweep``."""
    return _horseshoe(True, XT_pad, gram, xsq_pad, eps, beta_pad, block_order,
                      inner_perm, z_arr, lam_pad, tau, c2, sigmaE, valid_pad,
                      x_mean, x_scale, x_xsum, fold_affine, row_valid,
                      max_call_blocks)
