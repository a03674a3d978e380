"""Fused multi-chain exact sequential (J=1) sweeps: C chains in one sweep.

Counterpart of ``bayesrrcpp_tpu/ops/pallas_multichain.py:
bayesr_sweep_pallas_mc`` and ``horseshoe_sweep_pallas_mc`` in their
dense f32 mode (``x_mean=None``: f32 rows, eps (C, N)) and their
fold-affine quantized modes, on int8 codes (eps (C, N), the int8 fold
operand of pallas_multichain.py:412-413, :647-648) and on 2-bit words.  The chains share X, the Gram blocks and
the visit order (``block_order``, ``inner_perm``); every per-chain operand
carries a leading chain axis, and p/z are indexed by MARKER, (C, Mpad),
not by sweep position as in the single-chain sweep
(pallas_multichain.py:38-41): chain c equals ``ops/serial.py``'s
single-chain sweep given chain c's operands and p/z remapped to position
order (``serial.position_markers``).  The per-(chain, marker) step tables
are built in plain torch (``serial.build_pkg``, ``serial.build_pkg_hs``).

On CUDA tensors each entry point launches ``csrc/serial.cu`` (dot, solve
and apply per block for each group of at most 16 chains,
``jacobi_t.MAX_FUSED_CHAINS``, counted in ``<entry point>.launches``) or
raises; on CPU tensors each runs its plain version (``*_reference``).
Chains never interact given the shared orders, so the grouping does not
change the result.
"""
from __future__ import annotations

import torch

from . import serial
from .jacobi_t import MCSweepResult, _chain_groups


def _bayesr_mc(plain, XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
               block_order, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
               sigmaGG, g_assign_pad, valid_pad, x_mean, x_scale, x_xsum,
               fold_affine, row_valid, max_call_blocks):
    serial.check_mode(XT_pad, x_mean, x_xsum, fold_affine, row_valid,
                      fused=True)
    C, G, K = pi.shape
    Mpad = xsq_pad.shape[0]
    if tuple(p_arr.shape) != (C, Mpad) or tuple(z_arr.shape) != (C, Mpad):
        raise ValueError("multi-chain p/z must be (C, Mpad), marker-indexed")
    sigmaE = torch.as_tensor(sigmaE, dtype=torch.float32,
                             device=XT_pad.device)
    n, B = block_order.shape[0], gram.shape[1]
    chunk = serial.call_blocks(n, B, max_call_blocks)
    groups = [slice(0, C)] if plain else _chain_groups(C)
    parts = [serial.run(
        plain, True, K, G, chunk, XT_pad, gram, xsq_pad, eps[g],
        beta_pad[g], labels_pad[g], block_order, inner_perm, p_arr[g],
        z_arr[g], serial.build_pkg(xsq_pad, g_assign_pad, pi[g], cva,
                                   sigmaE[g], sigmaGG[g]),
        sigmaE[g], g_assign_pad, valid_pad, x_mean, x_scale, x_xsum,
        row_valid) for g in groups]
    return len(groups), MCSweepResult(*(torch.cat(f) for f in zip(*parts)))


def bayesr_sweep_mc(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                    block_order, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                    sigmaGG, g_assign_pad, valid_pad, *, x_mean=None,
                    x_scale=None, x_xsum=None, fold_affine: bool = True,
                    row_valid=None, max_call_blocks=None) -> MCSweepResult:
    """One fused serial BayesR sweep of C chains, with the argument order
    of ``bayesr_sweep_pallas_mc``: eps (C, Npad), beta_pad, labels_pad,
    p_arr and z_arr (C, Mpad) (p/z by marker), pi (C, G, K), sigmaE (C,),
    sigmaGG (C, G); the rest shared as in ``serial.bayesr_sweep``."""
    plain = XT_pad.device.type == "cpu"
    n_groups, res = _bayesr_mc(
        plain, XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad, block_order,
        inner_perm, p_arr, z_arr, pi, cva, sigmaE, sigmaGG, g_assign_pad,
        valid_pad, x_mean, x_scale, x_xsum, fold_affine, row_valid,
        max_call_blocks)
    if not plain:
        bayesr_sweep_mc.launches += (serial.LAUNCHES_PER_BLOCK * n_groups
                                     * block_order.shape[0])
    return res


bayesr_sweep_mc.launches = 0


def bayesr_sweep_mc_reference(XT_pad, gram, xsq_pad, eps, beta_pad,
                              labels_pad, block_order, inner_perm, p_arr,
                              z_arr, pi, cva, sigmaE, sigmaGG, g_assign_pad,
                              valid_pad, *, x_mean=None, x_scale=None,
                              x_xsum=None, fold_affine: bool = True,
                              row_valid=None, max_call_blocks=None
                              ) -> MCSweepResult:
    """The plain torch version of ``bayesr_sweep_mc``: the single-chain
    plain sweep's algebra batched over the chains."""
    return _bayesr_mc(True, XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                      block_order, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                      sigmaGG, g_assign_pad, valid_pad, x_mean, x_scale,
                      x_xsum, fold_affine, row_valid, max_call_blocks)[1]


def _horseshoe_mc(plain, XT_pad, gram, xsq_pad, eps, beta_pad, block_order,
                  inner_perm, z_arr, lam, tau, c2, sigmaE, valid_pad, x_mean,
                  x_scale, x_xsum, fold_affine, row_valid, max_call_blocks):
    serial.check_mode(XT_pad, x_mean, x_xsum, fold_affine, row_valid,
                      fused=True)
    C, Mpad = lam.shape
    if tuple(z_arr.shape) != (C, Mpad):
        raise ValueError("multi-chain z must be (C, Mpad), marker-indexed")
    dev = XT_pad.device
    tau, c2, sigmaE = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                       for x in (tau, c2, sigmaE))
    n, B = block_order.shape[0], gram.shape[1]
    chunk = serial.call_blocks(n, B, max_call_blocks)
    groups = [slice(0, C)] if plain else _chain_groups(C)
    parts = [serial.run(
        plain, True, 0, 0, chunk, XT_pad, gram, xsq_pad, eps[g],
        beta_pad[g], None, block_order, inner_perm, None, z_arr[g],
        serial.build_pkg_hs(xsq_pad, lam[g], tau[g], c2[g], sigmaE[g]),
        None, None, valid_pad, x_mean, x_scale, x_xsum, row_valid)[:2]
        for g in groups]
    return len(groups), tuple(torch.cat(f) for f in zip(*parts))


def horseshoe_sweep_mc(XT_pad, gram, xsq_pad, eps, beta_pad, block_order,
                       inner_perm, z_arr, lam, tau, c2, sigmaE, valid_pad, *,
                       x_mean=None, x_scale=None, x_xsum=None,
                       fold_affine: bool = True, row_valid=None,
                       max_call_blocks=None):
    """One fused serial horseshoe sweep of C chains, shaped like
    ``horseshoe_sweep_pallas_mc``: eps (C, Npad), beta_pad, z_arr and lam
    (C, Mpad) (z by marker), tau, c2 and sigmaE (C,).  Returns (eps, beta),
    each (C, ...)."""
    plain = XT_pad.device.type == "cpu"
    n_groups, res = _horseshoe_mc(
        plain, XT_pad, gram, xsq_pad, eps, beta_pad, block_order, inner_perm,
        z_arr, lam, tau, c2, sigmaE, valid_pad, x_mean, x_scale, x_xsum,
        fold_affine, row_valid, max_call_blocks)
    if not plain:
        horseshoe_sweep_mc.launches += (serial.LAUNCHES_PER_BLOCK * n_groups
                                        * block_order.shape[0])
    return res


horseshoe_sweep_mc.launches = 0


def horseshoe_sweep_mc_reference(XT_pad, gram, xsq_pad, eps, beta_pad,
                                 block_order, inner_perm, z_arr, lam, tau,
                                 c2, sigmaE, valid_pad, *, x_mean=None,
                                 x_scale=None, x_xsum=None,
                                 fold_affine: bool = True, row_valid=None,
                                 max_call_blocks=None):
    """The plain torch version of ``horseshoe_sweep_mc``."""
    return _horseshoe_mc(True, XT_pad, gram, xsq_pad, eps, beta_pad,
                         block_order, inner_perm, z_arr, lam, tau, c2, sigmaE,
                         valid_pad, x_mean, x_scale, x_xsum, fold_affine,
                         row_valid, max_call_blocks)[1]

