"""Posterior summaries, genomic prediction and multi-chain diagnostics.

Counterpart of ``bayesrrcpp_tpu/utils/summary.py``, a NumPy-only copy (the
port imports nothing of the JAX package).  Replaces the reference's manual
R post-processing (the vignette computes posterior means, effect-recovery
plots and proportion of variance explained by hand, reference:
vignettes/BayesRR.Rmd:126-128, 188-194, 238-244).  ``split_rhat`` and
``ess`` read ``run_chains`` output, (draws, chains, ...).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def posterior_means(samples: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Mean over the emission axis for every collected field."""
    return {k: np.asarray(v).mean(axis=0) for k, v in samples.items()
            if k != "iteration"}


def pve(samples: Dict[str, np.ndarray], X, Y) -> float:
    """Proportion of variance explained by the posterior-mean genetic values.

    Mirrors the vignette's check ``var(X %*% colMeans(beta)) / var(Y)``
    (vignettes/BayesRR.Rmd:126-128).
    """
    beta_hat = np.asarray(samples["beta"]).mean(axis=0)
    g = np.asarray(X) @ beta_hat
    return float(np.var(g) / np.var(np.asarray(Y)))


def heritability_samples(samples: Dict[str, np.ndarray]) -> np.ndarray:
    """Per-sample h2 = sigmaG_total / (sigmaG_total + sigmaE).

    For grouped chains sigmaG is summed over groups.
    """
    sG = np.asarray(samples["sigmaG"])
    if sG.ndim > 1:
        sG = sG.sum(axis=1)
    sE = np.asarray(samples["sigmaE"]).reshape(-1)
    return sG / (sG + sE)


def predict(samples: Dict[str, np.ndarray], X_new) -> np.ndarray:
    """Genomic prediction for new individuals: X_new @ posterior-mean beta
    (+ posterior-mean mu and fixed effects when present)."""
    beta_hat = np.asarray(samples["beta"]).mean(axis=0)
    pred = np.asarray(X_new) @ beta_hat
    if "mu" in samples:
        pred = pred + np.asarray(samples["mu"]).mean()
    return pred


def inclusion_probabilities(samples: Dict[str, np.ndarray]) -> np.ndarray:
    """Posterior probability each marker is in a non-spike component."""
    comp = np.asarray(samples["comp"])
    return (comp > 0).mean(axis=0)


# ---------------------------------------------------------------- multi-chain
# Convergence diagnostics for run_chains output (draws, chains, ...).  The
# reference has no multi-chain support at all (one chain per R process,
# src/BayesRv2.cpp:171); these pair with the fused multi-chain sampler.

def split_rhat(x: np.ndarray) -> np.ndarray:
    """Split-R-hat (Gelman et al., BDA3): x is (draws, chains[, ...]);
    returns R-hat per trailing index.  Values near 1 indicate convergence."""
    x = np.asarray(x, np.float64)
    n = x.shape[0] // 2
    if n < 2 or x.shape[1] < 1:
        raise ValueError("need >= 4 draws and >= 1 chain")
    # split each chain in half -> 2*chains sequences of length n
    halves = np.concatenate([x[:n], x[n:2 * n]], axis=1)
    mean_c = halves.mean(axis=0)                    # (2m, ...)
    var_c = halves.var(axis=0, ddof=1)
    W = var_c.mean(axis=0)
    B = n * mean_c.var(axis=0, ddof=1)
    var_post = (n - 1) / n * W + B / n
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.sqrt(var_post / W)
    return np.where(W > 0, out, 1.0)


def ess(x: np.ndarray) -> np.ndarray:
    """Bulk effective sample size via autocorrelations with Geyer's initial
    monotone positive-pair truncation; x is (draws, chains[, ...])."""
    x = np.asarray(x, np.float64)
    n, m = x.shape[0], x.shape[1]
    trail = x.shape[2:]
    x2 = x.reshape(n, m, -1)
    out = np.empty(x2.shape[2])
    for j in range(x2.shape[2]):
        xc = x2[:, :, j] - x2[:, :, j].mean(axis=0)
        # per-chain FFT autocovariance
        f = np.fft.rfft(np.concatenate([xc, np.zeros_like(xc)], axis=0),
                        axis=0)
        acov = np.fft.irfft(f * np.conj(f), axis=0)[:n].real / n
        var0 = acov[0].mean()
        if var0 <= 0:
            out[j] = n * m
            continue
        rho = acov.mean(axis=1) / var0
        # pair sums rho[2k]+rho[2k+1]; truncate at first negative, enforce
        # monotone decrease
        tau = 1.0
        prev = np.inf
        for k in range(1, n // 2):
            pair = rho[2 * k - 1] + rho[2 * k]
            if pair < 0:
                break
            pair = min(pair, prev)
            prev = pair
            tau += 2.0 * pair
        out[j] = n * m / tau
    return out.reshape(trail) if trail else float(out[0])
