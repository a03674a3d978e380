"""2-bit packed genotype storage and the sweep's precomputed statistics.

Counterpart of the packed half of ``bayesrrcpp_tpu/ops/genotypes.py``.
Genotypes are stored as 16 two-bit codes per int32 word along the
individual axis (0.25 bytes per genotype): individual 16*w + k sits at
bits 2k of word w, exactly ``pack_codes_host``'s format.  Codes are
dosages {0, 1, 2}; 3 is a missing call.  The standardized value of code c
of marker j is (c - mean_j) * scale_j, with a missing call and any lane
n >= N decoding to exactly 0.

Unlike the JAX package, which stores eps/Y in a plane-major individual
permutation for its TPU tiles (``lane_perm``), the port keeps individuals
in their natural order, padded with zeros to Npad (a multiple of 2048).
``lane_perm`` is kept only to carry state across from JAX
(``convert.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MISSING_CODE = 3
LANE_TILE = 2048   # individuals pad to a multiple of this (the word format)
WORDS = 16         # codes per int32 word


class PackedGenotypes(NamedTuple):
    words: torch.Tensor      # (Mpad, Npad/16) int32 packed codes
    xsq: torch.Tensor        # (Mpad,) standardized column sum-of-squares
    gram: torch.Tensor       # (nb, B, B) standardized Gram blocks
    x_mean: torch.Tensor     # (Mpad,) per-marker dosage means
    x_scale: torch.Tensor    # (Mpad,) per-marker 1/sd (0 where sd == 0)
    row_valid: torch.Tensor  # (Npad,) bool, individual n < N
    Npad: int
    x_colsum: torch.Tensor   # (Mpad,) decoded column sums
    has_missing: bool


def padded_individuals(N: int) -> int:
    return -(-N // LANE_TILE) * LANE_TILE


def lane_perm(Npad: int) -> np.ndarray:
    """The JAX package's stored-position -> individual permutation of its
    packed eps/Y layout (bayesrrcpp_tpu/ops/genotypes.py:41-55): position
    k*Nw + w holds individual 16*w + k."""
    nw = Npad // WORDS
    p = np.arange(Npad)
    return WORDS * (p % nw) + p // nw


def pack_codes_host(X, transposed, x_stats, Mpad, N):
    """Host-side dosage -> packed-word conversion.

    Returns (words (Mpad, Npad/16) np.int32, mean (Mpad,) f32, scale
    (Mpad,) f32, Npad, has_missing).  Pad markers and pad lanes carry
    MISSING_CODE when the data has missing calls, else 0.
    """
    Npad = padded_individuals(N)
    Xh = np.asarray(X)
    XTh = Xh if transposed else Xh.T
    if x_stats is not None:
        means = np.asarray(x_stats[0], np.float64)
        sds = np.asarray(x_stats[1], np.float64)
        codes = np.asarray(XTh, np.int8)
    else:
        XTh = np.asarray(XTh, np.float64)
        means = np.nanmean(XTh, axis=1)
        sds = np.nanstd(XTh, axis=1, ddof=1)
        ch = np.where(np.isnan(XTh), float(MISSING_CODE), XTh)
        if not np.isin(np.unique(ch), [0.0, 1.0, 2.0, 3.0]).all():
            raise ValueError(
                "x_dtype='2bit' expects raw dosages in {0,1,2} (+NaN)")
        codes = ch.astype(np.int8)

    M = codes.shape[0]
    has_missing = bool(np.any(codes == MISSING_CODE))
    scales = np.where(sds > 0, 1.0 / np.where(sds > 0, sds, 1.0), 0.0)
    pad_code = MISSING_CODE if has_missing else 0
    codes = np.pad(codes, ((0, Mpad - M), (0, Npad - N)),
                   constant_values=pad_code)
    mean = np.pad(means, (0, Mpad - M)).astype(np.float32)
    scale = np.pad(scales, (0, Mpad - M)).astype(np.float32)

    cw = codes.reshape(Mpad, Npad // WORDS, WORDS).astype(np.uint64)
    shifts = (2 * np.arange(WORDS, dtype=np.uint64))[None, None, :]
    words = (cw << shifts).sum(axis=2).astype(np.uint32).view(np.int32)
    return words, mean, scale, Npad, has_missing


def decode_codes(words):
    """(R, Nw) int32 words -> (R, Nw*16) int32 codes in individual order."""
    shifts = 2 * torch.arange(WORDS, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> shifts) & 3).reshape(words.shape[0], -1)


def decode_rows(words, mean, scale, lane_ok):
    """(R, Nw) int32 words -> (R, Npad) standardized f32 rows; missing
    calls and lanes where ``lane_ok`` (Npad,) is False decode to 0."""
    c = decode_codes(words)
    x = (c.to(torch.float32) - mean[:, None]) * scale[:, None]
    keep = (c != MISSING_CODE) & lane_ok[None, :]
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _chunk_blocks(B, Npad, budget_elems=1 << 27):
    """Blocks per decode chunk: keeps each (rows, Npad) temporary near
    ``budget_elems`` elements (512 MB of f32)."""
    return max(1, budget_elems // (B * Npad))


def packed_stats(words, mean, scale, lane_ok, B, m_true):
    """xsq (Mpad,), Gram blocks (nb, B, B), decoded column sums (Mpad,) and
    whether any real marker (< m_true) has a missing call, built from the
    words in chunks of blocks -- X is never densified whole."""
    Mpad, Nw = words.shape
    nb = Mpad // B
    dev = words.device
    xsq = torch.empty((Mpad,), dtype=torch.float32, device=dev)
    xsum = torch.empty((Mpad,), dtype=torch.float32, device=dev)
    gram = torch.empty((nb, B, B), dtype=torch.float32, device=dev)
    missing = torch.zeros((), dtype=torch.bool, device=dev)
    step = _chunk_blocks(B, Nw * WORDS)
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        a, e = b0 * B, b1 * B
        x = decode_rows(words[a:e], mean[a:e], scale[a:e], lane_ok)
        xsq[a:e] = torch.sum(x * x, dim=1)
        xsum[a:e] = torch.sum(x, dim=1)
        xb = x.view(b1 - b0, B, -1)
        gram[b0:b1] = torch.bmm(xb, xb.transpose(1, 2))
        if a < m_true:
            c = decode_codes(words[a:min(e, m_true)])
            missing |= torch.any((c == MISSING_CODE) & lane_ok[None, :])
    return xsq, gram, xsum, bool(missing)


def quantize_packed(X, transposed, x_stats, B, Mpad, N, *, prepacked: bool,
                    device, m_true=None) -> PackedGenotypes:
    """2-bit packed genotypes on ``device`` with their sweep statistics.

    ``prepacked``: X is already (M or Mpad, Npad/16) int32 words, marker
    major (torch tensor or numpy array), with ``x_stats`` = (means, sds);
    otherwise X is a host dosage matrix packed by ``pack_codes_host``.
    """
    Npad = padded_individuals(N)
    if prepacked:
        words, mean, scale = _prepacked_words(X, x_stats, Mpad, N, Npad,
                                              device)
        m_real = X.shape[0] if m_true is None else min(int(m_true),
                                                       X.shape[0])
    else:
        w, mean_np, scale_np, Npad, _ = pack_codes_host(
            X, transposed, x_stats, Mpad, N)
        words = torch.as_tensor(w, device=device)
        mean = torch.as_tensor(mean_np, device=device)
        scale = torch.as_tensor(scale_np, device=device)
        m_real = np.asarray(X).shape[1 if not transposed else 0]
    row_valid = torch.arange(Npad, device=device) < N
    xsq, gram, xsum, has_missing = packed_stats(words, mean, scale,
                                                row_valid, B, m_real)
    return PackedGenotypes(words, xsq, gram, mean, scale, row_valid, Npad,
                           xsum, has_missing)


def _prepacked_words(words, x_stats, Mpad, N, Npad, device):
    if words.shape[1] * WORDS != Npad:
        raise ValueError(
            f"pre-packed 2-bit input needs lanes padded to a 2048 "
            f"multiple: got {words.shape[1]} words/marker for N={N} "
            f"(want {Npad // WORDS})")
    M = words.shape[0]
    means = np.asarray(x_stats[0], np.float64)
    sds = np.asarray(x_stats[1], np.float64)
    scales = np.where(sds > 0, 1.0 / np.where(sds > 0, sds, 1.0), 0.0)
    words = torch.as_tensor(words, device=device)
    if Mpad != M:
        # pad markers with all-missing words (every code 3 -> decodes to 0)
        words = torch.cat([words, torch.full((Mpad - M, words.shape[1]), -1,
                                             dtype=torch.int32,
                                             device=device)])
    mean = torch.as_tensor(np.pad(means, (0, Mpad - M)), dtype=torch.float32,
                           device=device)
    scale = torch.as_tensor(np.pad(scales, (0, Mpad - M)),
                            dtype=torch.float32, device=device)
    return words, mean, scale


def xbeta_packed(words, mean, scale, beta_pad, B, N):
    """X @ beta for 2-bit packed storage, (N,) in individual order,
    decoded in chunks of blocks."""
    Mpad, Nw = words.shape
    lane_ok = torch.arange(Nw * WORDS, device=words.device) < N
    acc = torch.zeros((Nw * WORDS,), dtype=torch.float32, device=words.device)
    step = _chunk_blocks(B, Nw * WORDS) * B
    for a in range(0, Mpad, step):
        e = min(Mpad, a + step)
        acc += beta_pad[a:e].to(torch.float32) @ decode_rows(
            words[a:e], mean[a:e], scale[a:e], lane_ok)
    return acc[:N]
