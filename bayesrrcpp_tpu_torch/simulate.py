"""Simulation recipes for tests and benchmarks.

Counterpart of ``bayesrrcpp_tpu/simulate.py``: ``simulate_bayesr`` is the
same NumPy recipe (the reference smoke script, src/BayesRv2.cpp:298-308);
the packed-genotype generator draws from a ``torch.Generator`` on the
device, in row chunks, so a biobank-sized word array never needs more
than one chunk of temporaries beside itself.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class SimData(NamedTuple):
    X: np.ndarray          # (N, M) standardized
    Y: np.ndarray          # (N,)
    beta_true: np.ndarray  # (M,)
    g_assign: Optional[np.ndarray]  # (M,) or None
    fixed: Optional[np.ndarray]     # (N, F) or None
    alpha_true: Optional[np.ndarray]
    h2: float              # realised proportion of variance explained


def _standardize(A):
    A = A - A.mean(axis=0)
    sd = A.std(axis=0, ddof=1)
    sd[sd == 0] = 1.0
    return A / sd


def simulate_bayesr(seed, N, M, n_causal, h2=0.5, n_groups=1, n_fixed=0,
                    dtype=np.float64) -> SimData:
    """Sparse-effects simulation (reference smoke recipe, src/BayesRv2.cpp:298-308)."""
    rng = np.random.default_rng(seed)
    beta = np.zeros(M)
    causal = rng.choice(M, size=n_causal, replace=False)
    beta[causal] = rng.normal(0.0, np.sqrt(h2 / n_causal), size=n_causal)
    X = _standardize(rng.normal(size=(N, M)))
    g = X @ beta
    var_g = g.var()
    noise = rng.normal(0.0, np.sqrt(max(var_g, 1e-12) * (1 - h2) / max(h2, 1e-12)),
                       size=N)
    Y = g + noise

    fixed = alpha_true = None
    if n_fixed > 0:
        fixed = _standardize(rng.normal(size=(N, n_fixed)))
        alpha_true = rng.normal(0.0, 0.3, size=n_fixed)
        Y = Y + fixed @ alpha_true
    g_assign = None
    if n_groups > 1:
        g_assign = rng.integers(0, n_groups, size=M).astype(np.int32)

    realised_h2 = var_g / Y.var()
    return SimData(X.astype(dtype), Y.astype(dtype), beta, g_assign,
                   None if fixed is None else fixed.astype(dtype),
                   alpha_true, float(realised_h2))


# hi and lo bits of the 16 two-bit fields of an int32 word
_HI_MASK = int(np.uint32(0xAAAAAAAA).astype(np.int32))
_LO_MASK = 0x55555555


def random_packed_words(generator, M, n_words, *, device,
                        chunk_bytes: int = 1 << 28):
    """(M, n_words) int32 of 2-bit genotype codes with NO missing calls.

    Each field takes its hi bit from one random word and its lo bit from
    the same word's neighbouring bit, forced to 0 when hi is set: codes
    land in {0, 1, 2} with P = 1/4, 1/4, 1/2, never the missing code 3
    (the JAX recipe, bayesrrcpp_tpu/simulate.py:62-84).  Stats for the
    decode: mean 1.25, sd sqrt(11/16) (``packed_word_stats``).

    Generated on ``device`` in chunks of about ``chunk_bytes`` of words.
    """
    out = torch.empty((M, n_words), dtype=torch.int32, device=device)
    rows = max(1, chunk_bytes // (4 * max(1, n_words)))
    for a in range(0, M, rows):
        b = min(M, a + rows)
        w = torch.randint(-(2 ** 31), 2 ** 31 - 1, (b - a, n_words),
                          generator=generator, dtype=torch.int32,
                          device=device)
        h = w & _HI_MASK
        w &= _LO_MASK
        w &= ~(h >> 1)
        out[a:b] = w.bitwise_or_(h)
    return out


def packed_word_stats(M):
    """x_stats matching random_packed_words' code distribution."""
    return np.full(M, 1.25), np.full(M, float(np.sqrt(11.0 / 16.0)))
