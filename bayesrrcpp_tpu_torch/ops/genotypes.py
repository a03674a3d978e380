"""Quantized genotype storage and the sweep's precomputed statistics.

Counterpart of the quantized half of ``bayesrrcpp_tpu/ops/genotypes.py``,
in its two storage modes:

- 2-bit packed: 16 two-bit codes per int32 word along the individual axis
  (0.25 bytes per genotype): individual 16*w + k sits at bits 2k of word
  w, exactly ``pack_codes_host``'s format;
- int8 codes (``quantize_int8``): one byte per genotype, (Mpad, N) marker
  major, individuals in their natural order with no lane padding; pad
  markers hold code 3 with mean = scale = 0 (genotypes.py:431-434).

Codes are dosages {0, 1, 2}; 3 is a missing call.  The standardized value
of code c of marker j is (c - mean_j) * scale_j, with a missing call and
any lane n >= N decoding to exactly 0.  ``decode_codes``, ``decode_rows``,
the statistics and ``xbeta_*`` take either storage: int8 codes are told
apart by their dtype.

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


def is_int8(X) -> bool:
    """Whether X holds int8 codes (one per genotype) rather than words."""
    return X.dtype in (torch.int8, np.int8)


def lanes(X) -> int:
    """Individuals a row of X spans: N for int8 codes, 16 a word."""
    return X.shape[1] if is_int8(X) else X.shape[1] * WORDS


def decode_codes(words):
    """(R, Nw) int32 words -> (R, Nw*16) int32 codes in individual order;
    (R, N) int8 codes -> the same codes as int32."""
    if is_int8(words):
        return words.to(torch.int32)
    shifts = 2 * torch.arange(WORDS, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> shifts) & 3).reshape(words.shape[0], -1)


def decode_rows(words, mean, scale, lane_ok=None):
    """(R, Nw) int32 words or (R, N) int8 codes -> (R, lanes) standardized
    f32 rows; missing calls and lanes where ``lane_ok`` (lanes,) is False
    (None: every lane) decode to 0."""
    c = decode_codes(words)
    x = (c.to(torch.float32) - mean[:, None]) * scale[:, None]
    keep = c != MISSING_CODE
    if lane_ok is not None:
        keep = keep & lane_ok[None, :]
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _chunk_blocks(B, Npad, budget_elems=1 << 27):
    """Blocks per decode chunk: keeps each (rows, Npad) temporary near
    ``budget_elems`` elements (512 MB of f32)."""
    return max(1, budget_elems // (B * Npad))


def packed_stats(words, mean, scale, lane_ok, B, m_true):
    """xsq (Mpad,), Gram blocks (nb, B, B), decoded column sums (Mpad,) and
    whether any real marker (< m_true) has a missing call, built from the
    words or int8 codes in chunks of blocks -- X is never densified whole.
    ``lane_ok`` None: every lane counts (int8 codes)."""
    Mpad = words.shape[0]
    nb = Mpad // B
    dev = words.device
    xsq = torch.empty((Mpad,), dtype=torch.float32, device=dev)
    xsum = torch.empty((Mpad,), dtype=torch.float32, device=dev)
    gram = torch.empty((nb, B, B), dtype=torch.float32, device=dev)
    missing = torch.zeros((), dtype=torch.bool, device=dev)
    step = _chunk_blocks(B, lanes(words))
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        a, e = b0 * B, b1 * B
        x = decode_rows(words[a:e], mean[a:e], scale[a:e], lane_ok)
        xsq[a:e] = torch.sum(x * x, dim=1)
        xsum[a:e] = torch.sum(x, dim=1)
        xb = x.view(b1 - b0, B, -1)
        gram[b0:b1] = torch.bmm(xb, xb.transpose(1, 2))
        if a < m_true:
            miss = decode_codes(words[a:min(e, m_true)]) == MISSING_CODE
            if lane_ok is not None:
                miss = miss & lane_ok[None, :]
            missing |= torch.any(miss)
    return xsq, gram, xsum, bool(missing)


def int8_stats_local(codes, mean, scale, *, B):
    """xsq (Mloc,), Gram blocks (nb_loc, B, B) and decoded column sums
    (Mloc,) of a slice of int8 codes (Mloc, N), one marker slice of the
    sharded driver (genotypes.py:int8_stats_local), in chunks of blocks."""
    return packed_stats(codes, mean, scale, None, B, 0)[:3]


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
    """X @ beta for 2-bit packed storage or int8 codes, (..., N) in
    individual order for a (..., Mpad) beta, decoded in chunks of blocks."""
    Mpad = words.shape[0]
    n_lanes = lanes(words)
    lane_ok = torch.arange(n_lanes, device=words.device) < N
    acc = torch.zeros(beta_pad.shape[:-1] + (n_lanes,),
                      dtype=torch.float32, device=words.device)
    step = _chunk_blocks(B, n_lanes) * B
    for a in range(0, Mpad, step):
        e = min(Mpad, a + step)
        acc += beta_pad[..., a:e].to(torch.float32) @ decode_rows(
            words[a:e], mean[a:e], scale[a:e], lane_ok)
    return acc[..., :N]


def xbeta_int8(codes, mean, scale, beta_pad, B):
    """X @ beta for int8 codes (Mpad, N) (genotypes.py:xbeta_int8), (..., N)
    for a (..., Mpad) beta, decoded in chunks of blocks."""
    return xbeta_packed(codes, mean, scale, beta_pad, B, codes.shape[1])


class Int8Genotypes(NamedTuple):
    codes: torch.Tensor      # (Mpad, N) int8 codes, pad markers code 3
    xsq: torch.Tensor        # (Mpad,) standardized column sum-of-squares
    gram: torch.Tensor       # (nb, B, B) standardized Gram blocks
    x_mean: torch.Tensor     # (Mpad,) per-marker dosage means (0 on pads)
    x_scale: torch.Tensor    # (Mpad,) per-marker 1/sd (0 on pads)
    x_colsum: torch.Tensor   # (Mpad,) decoded column sums
    has_missing: bool        # a real marker holds a missing call


def quantize_int8(X, transposed, x_stats, B, Mpad, *,
                  device) -> Int8Genotypes:
    """int8 codes {0, 1, 2, 3 = missing} on ``device`` with their sweep
    statistics (genotypes.py:quantize_int8).

    With ``x_stats`` = (means, sds), X holds the codes already: an int8
    tensor (used as it is, no copy, when it is marker major on ``device``
    with Mpad rows) or any array cast to int8.  Without, X is a dosage
    matrix in {0, 1, 2} with NaN for a missing call, standardized by its
    own column means and sds (ddof=1).  ``has_missing`` is read before the
    pad markers (code 3) are added; xsq, Gram and column sums are built in
    chunks of blocks.
    """
    if x_stats is not None:
        means = np.asarray(x_stats[0], np.float64)
        sds = np.asarray(x_stats[1], np.float64)
        if isinstance(X, torch.Tensor) and X.dtype == torch.int8:
            codes = (X if transposed else X.t()).to(device).contiguous()
        else:
            Xh = np.asarray(X)
            codes = torch.as_tensor(np.ascontiguousarray(
                Xh if transposed else Xh.T, np.int8), device=device)
    else:
        Xh = np.asarray(X, np.float64)
        XTh = Xh if transposed else Xh.T
        means = np.nanmean(XTh, axis=1)
        sds = np.nanstd(XTh, axis=1, ddof=1)
        ch = np.where(np.isnan(XTh), float(MISSING_CODE), XTh)
        if not np.isin(np.unique(ch), [0.0, 1.0, 2.0, 3.0]).all():
            raise ValueError(
                "x_dtype='int8' expects raw dosages in {0,1,2} (+NaN)")
        codes = torch.as_tensor(np.ascontiguousarray(ch, np.int8),
                                device=device)
    M = codes.shape[0]
    scales = np.where(sds > 0, 1.0 / np.where(sds > 0, sds, 1.0), 0.0)
    if Mpad != M:
        codes = torch.cat([codes, codes.new_full((Mpad - M, codes.shape[1]),
                                                 MISSING_CODE)])
    mean = torch.as_tensor(np.pad(means, (0, Mpad - M)), dtype=torch.float32,
                           device=device)
    scale = torch.as_tensor(np.pad(scales, (0, Mpad - M)),
                            dtype=torch.float32, device=device)
    xsq, gram, xsum, has_missing = packed_stats(codes, mean, scale, None, B,
                                                M)
    return Int8Genotypes(codes, xsq, gram, mean, scale, xsum, has_missing)
