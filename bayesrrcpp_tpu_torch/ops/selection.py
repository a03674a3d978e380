"""Spike-and-slab mixture component selection for one marker.

Counterpart of ``bayesrrcpp_tpu/ops/selection.py`` in plain torch: the
reference's per-marker categorical draw (src/BayesRv2.cpp:195-242) as
branch-free cumulative comparisons, with its quirks kept:

- overflow guard: the weight of candidate k is zeroed when
  ``any |logL[1:] - logL[k]| > 700`` -- only the *slab* log-likelihoods are
  compared against candidate k (src/BayesRv2.cpp:216, 235);
- no selection: if the uniform variate exceeds the last cumulative weight,
  beta and the label keep their previous values and nothing is counted
  (src/BayesRv2.cpp:222-242).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SelectionResult(NamedTuple):
    beta_new: torch.Tensor      # scalar new effect (old value if nothing selected)
    label_new: torch.Tensor     # scalar int32 label (old if nothing selected)
    count_onehot: torch.Tensor  # (K,) 0/1 count contribution for the v vector
    delta: torch.Tensor         # beta_new - beta_old


def component_logL(pi_j, cva_j, muk_slab, num, xsq_j, sigmaE, sigmaG):
    """Per-component log marginal likelihood (src/BayesRv2.cpp:207-211).

    pi_j: (K,) mixture probabilities of this marker's group; cva_j: (K-1,)
    slab variances; muk_slab: (K-1,) conditional means.
    """
    # clamp to the smallest normal so a Dirichlet underflow to exactly 0
    # never poisons the exp-difference sums with NaNs
    tiny = torch.finfo(pi_j.dtype).tiny
    logpi = torch.log(torch.clamp_min(pi_j, tiny))
    slab = (logpi[1:]
            - 0.5 * torch.log((sigmaG / sigmaE) * xsq_j * cva_j + 1.0)
            + 0.5 * muk_slab * num / sigmaE)
    return torch.cat([logpi[:1], slab])


def selection_weights(logL):
    """Cumulative selection weights A_k with the reference overflow guard.

    w_k = 0                                  if any |logL[1:] - logL[k]| > 700
        = 1 / sum_l exp(logL_l - logL_k)     otherwise
    A = cumsum(w); the sampler picks the first k with p <= A_k.
    """
    D = logL[1:][None, :] - logL[:, None]
    guard = torch.any(torch.abs(D) > 700.0, dim=1)
    S = torch.sum(torch.exp(logL[None, :] - logL[:, None]), dim=1)
    w = torch.where(guard, torch.zeros_like(S), 1.0 / S)
    return torch.cumsum(w, dim=0)


def select_component(p, z, num, xsq_j, pi_j, cva_j, sigmaE, sigmaG,
                     beta_old, label_old):
    """Draw the mixture label and effect for one marker.

    p: U(0, 1) variate; z: N(0, 1) variate used iff a slab is selected;
    num = X_j' eps + beta_old * xsq_j (src/BayesRv2.cpp:201).
    """
    K = pi_j.shape[0]
    denom = xsq_j + (sigmaE / sigmaG) / cva_j                 # (K-1,)
    muk_slab = num / denom
    logL = component_logL(pi_j, cva_j, muk_slab, num, xsq_j, sigmaE, sigmaG)
    A = selection_weights(logL)

    hit = p <= A
    any_hit = torch.any(hit)
    k_first = torch.argmax(hit.to(torch.int32))
    k_sel = torch.where(any_hit, k_first, torch.full_like(k_first, K))

    muk = torch.cat([torch.zeros_like(muk_slab[:1]), muk_slab])
    sd = torch.sqrt(sigmaE / denom)
    sd_full = torch.cat([torch.zeros_like(sd[:1]), sd])
    k_idx = torch.clamp_max(k_sel, K - 1)
    beta_drawn = muk[k_idx] + sd_full[k_idx] * z
    beta_new = torch.where(k_sel == 0, torch.zeros_like(beta_drawn),
                           torch.where(any_hit, beta_drawn, beta_old))
    label_new = torch.where(any_hit, k_sel.to(torch.int32), label_old)
    count_onehot = torch.where(
        any_hit,
        (torch.arange(K, device=logL.device) == k_sel).to(logL.dtype),
        torch.zeros((K,), dtype=logL.dtype, device=logL.device))
    return SelectionResult(beta_new, label_new, count_onehot,
                           beta_new - beta_old)
