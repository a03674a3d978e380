"""PLINK .bed/.bim/.fam genotype reader and writer.

Counterpart of ``bayesrrcpp_tpu/io/bed.py`` (host code, NumPy only).  Real
genotypes ship in PLINK's 2-bit packed SNP-major .bed format, with missing
calls.  ``read_bed_packed`` reads a .bed straight into the samplers' packed
word layout (0.25 bytes per genotype; no dense X on the host), with the
per-marker statistics the sweeps need; ``read_bed`` decodes to a dense
dosage matrix for small data.  The threaded C++ decoder of
``native/bedreader.cpp`` is used when it builds, a NumPy byte-LUT decoder
otherwise: both give the same words and statistics.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

_MAGIC = bytes([0x6C, 0x1B])
_SNP_MAJOR = 0x01

# 2-bit PLINK codes -> additive dosage of the A1 allele:
# 00 -> 2 (hom A1), 10 -> 1 (het), 11 -> 0 (hom A2), 01 -> missing
_DOSAGE = np.array([2.0, np.nan, 1.0, 0.0], np.float32)
# dosage 0, 1, 2 -> PLINK code; a missing call is 01
_PLINK = np.array([0b11, 0b10, 0b00], np.uint8)
_WRITE_CHUNK = 512   # markers per block of write_bed's temporaries


class BedData(NamedTuple):
    X: np.ndarray            # (N, M) float32 dosages (standardized if asked)
    snp_ids: np.ndarray      # (M,) from .bim
    sample_ids: np.ndarray   # (N,) from .fam
    means: np.ndarray        # (M,) pre-standardization dosage means
    sds: np.ndarray          # (M,) pre-standardization dosage sds


def _open_bed(prefix: str, M_total: int, bpm: int, m0: int, m1: int):
    """The genotype bytes of markers [m0, m1) of ``{prefix}.bed``."""
    with open(prefix + ".bed", "rb") as f:
        header = f.read(3)
        if header[:2] != _MAGIC:
            raise ValueError(f"{prefix}.bed: bad magic bytes")
        if header[2] != _SNP_MAJOR:
            raise ValueError(f"{prefix}.bed: only SNP-major layout supported")
        f.seek(0, os.SEEK_END)
        nbytes = f.tell() - 3
        if nbytes != M_total * bpm:
            raise ValueError(f"{prefix}.bed: expected {M_total * bpm} "
                             f"genotype bytes, got {nbytes}")
        f.seek(3 + m0 * bpm)
        return np.frombuffer(f.read((m1 - m0) * bpm), np.uint8)


def read_bed(prefix: str, *, standardize: bool = True,
             impute_missing: bool = True, dtype=np.float32) -> BedData:
    """Read `{prefix}.bed/.bim/.fam` into an (N, M) dosage matrix."""
    bim = _read_tsv_col(prefix + ".bim", 1)
    fam = _read_tsv_col(prefix + ".fam", 1)
    M, N = len(bim), len(fam)
    bpm = (N + 3) // 4  # bytes per marker
    raw = _open_bed(prefix, M, bpm, 0, M).reshape(M, bpm)
    # unpack 2-bit codes, little-endian within each byte
    codes = np.empty((M, bpm * 4), np.uint8)
    for shift in range(4):
        codes[:, shift::4] = (raw >> (2 * shift)) & 0b11
    X = _DOSAGE[codes[:, :N]]  # (M, N) float32 with NaN for missing

    means = np.nanmean(X, axis=1)
    if impute_missing:
        nan_mask = np.isnan(X)
        X[nan_mask] = np.take(means, np.nonzero(nan_mask)[0])
    sds = np.nanstd(X, axis=1, ddof=1)
    if standardize:
        safe = np.where(sds > 0, sds, 1.0)
        X = (X - means[:, None]) / safe[:, None]
    return BedData(np.ascontiguousarray(X.T, dtype), np.asarray(bim),
                   np.asarray(fam), means, sds)


class PackedBed(NamedTuple):
    words: np.ndarray      # (M or mpad, Npad//16) int32, the samplers' 2-bit
                           # word layout (16 codes/word, individual 16w+k at
                           # bits 2k); Npad = ceil(N/2048)*2048, pad lanes
                           # coded 0 (no missing call) or 3 (missing present)
    means: np.ndarray      # (M,) missing-aware dosage means
    sds: np.ndarray        # (M,) missing-aware ddof-1 dosage sds
    n: int                 # true individual count
    snp_ids: np.ndarray
    sample_ids: np.ndarray
    has_missing: bool


def read_bed_packed(prefix: str, *, n_threads: int = 0,
                    marker_range: Optional[tuple] = None,
                    mpad=None, block_size: int = 512) -> PackedBed:
    """Read `{prefix}.bed/.bim/.fam` straight into the samplers' packed 2-bit
    word layout, with no dense X on the host.  Feed the result to a sampler
    as::

        pb = read_bed_packed(prefix, mpad="auto")
        s = SpikeSlabSampler(torch.as_tensor(pb.words), Y, cva, cfg,
                             x_dtype="2bit", transposed=True,
                             x_stats=(pb.means, pb.sds),
                             n_individuals=pb.n, n_markers=len(pb.snp_ids))

    ``marker_range=(m0, m1)`` reads only markers [m0, m1): .bed is
    SNP-major, so this is one contiguous byte-range read.

    ``mpad`` pads the marker axis on the host with all-missing words (-1)
    and zero statistics: ``"auto"`` (the padded count of a sampler with the
    auto plan and ``block_size``, ``ops.jacobi.planned_mpad``) or an
    explicit count.  The sampler then takes the words as they are, with no
    second word array on the card.

    With missing calls present, the pad lanes (individuals N..Npad-1) are
    coded 3, as the in-kernel decode expects; without, 0.
    """
    bim = _read_tsv_col(prefix + ".bim", 1)
    fam = _read_tsv_col(prefix + ".fam", 1)
    M_total, N = len(bim), len(fam)
    bpm = (N + 3) // 4
    m0, m1 = (0, M_total) if marker_range is None else marker_range
    if not (0 <= m0 <= m1 <= M_total):
        raise ValueError(f"marker_range {marker_range} outside [0, {M_total}]")
    M = m1 - m0
    raw = _open_bed(prefix, M_total, bpm, m0, m1)
    bim = bim[m0:m1]
    npad = -(-N // 2048) * 2048
    wpad = npad // 16

    from .native import get_native_bed

    dec = get_native_bed()
    if dec is not None:
        words, means, sds, _, total = dec.decode(raw, M, N, wpad, n_threads)
        has_missing = total > 0
    else:
        words, means, sds, has_missing = _decode_packed_numpy(
            raw.reshape(M, bpm), N, wpad)

    if has_missing:
        # pad individuals carry the missing code, which the in-kernel
        # decode zeroes
        by = words.view(np.uint8).reshape(M, wpad * 4)
        vb, rem = divmod(N, 4)
        if rem:
            keep = np.uint8((1 << (2 * rem)) - 1)
            by[:, vb] = (by[:, vb] & keep) | np.uint8(0xFF & ~keep)
            vb += 1
        if vb < by.shape[1]:
            by[:, vb:] = 0xFF
    if mpad is not None:
        if mpad == "auto":
            from ..ops.jacobi import planned_mpad

            mpad = planned_mpad(M, block_size)
        if mpad < M:
            raise ValueError(f"mpad={mpad} < {M} markers read")
        if mpad > M:
            # pad markers are all-missing words (-1) with zero statistics,
            # masked out by the samplers' valid vector
            words = np.concatenate(
                [words, np.full((mpad - M, wpad), -1, np.int32)], axis=0)
            means = np.concatenate([means, np.zeros(mpad - M)])
            sds = np.concatenate([sds, np.zeros(mpad - M)])
    return PackedBed(words, means, sds, N, np.asarray(bim), np.asarray(fam),
                     bool(has_missing))


# per-byte LUTs over PLINK codes (00->2, 01->missing, 10->1, 11->0)
def _byte_luts():
    plink = np.arange(256, dtype=np.uint16)
    codes = np.stack([(plink >> (2 * j)) & 3 for j in range(4)], 1)  # (256,4)
    dose = np.array([2, 4, 1, 0], np.uint16)[codes]  # 4 == missing sentinel
    miss = (dose == 4)
    d = np.where(miss, 0, dose)
    lut_map = np.zeros(256, np.uint8)
    for j in range(4):
        lut_map |= (np.where(miss[:, j], 3, dose[:, j]).astype(np.uint8)
                    << np.uint8(2 * j))
    return (lut_map, d.sum(1).astype(np.int64), (d * d).sum(1).astype(np.int64),
            miss.sum(1).astype(np.int64))


def _decode_packed_numpy(raw, N, wpad):
    """The NumPy decoder of native/bedreader.cpp: byte-LUT remap + stats."""
    lut_map, lut_sum, lut_sq, lut_miss = _byte_luts()
    M, bpm = raw.shape
    vb, rem = divmod(N, 4)
    body = raw if rem == 0 else raw[:, :vb]
    s = lut_sum[body].sum(1)
    q = lut_sq[body].sum(1)
    mi = lut_miss[body].sum(1)
    out = np.zeros((M, wpad * 4), np.uint8)
    out[:, :bpm] = lut_map[raw]
    if rem:
        # PLINK pads the trailing byte's unused slots with 00 (dosage 2):
        # force them to missing for the stats, zero them in the words
        keep = np.uint8((1 << (2 * rem)) - 1)
        pad_missing = np.uint8(sum(1 << (2 * j) for j in range(rem, 4)))
        bb = (raw[:, vb] & keep) | pad_missing
        s += lut_sum[bb]
        q += lut_sq[bb]
        mi += lut_miss[bb] - (4 - rem)
        out[:, vb] = lut_map[raw[:, vb]] & keep
    cnt = N - mi
    safe = np.maximum(cnt, 1)
    means = s / safe
    var = np.where(cnt > 1, (q - cnt * means * means) / np.maximum(cnt - 1, 1),
                   0.0)
    sds = np.sqrt(np.maximum(var, 0.0))
    return (np.ascontiguousarray(out).view(np.int32).reshape(M, wpad),
            means, sds, bool(mi.sum() > 0))


def write_bed(prefix: str, X_dosage, snp_ids=None, sample_ids=None):
    """Write dosages (N, M) in {0, 1, 2, NaN} to .bed/.bim/.fam, the bytes
    of ``bayesrrcpp_tpu.io.bed.write_bed`` (testing / export utility), a
    block of markers at a time."""
    N, M = X_dosage.shape
    snp_ids = snp_ids if snp_ids is not None else [f"snp{i}" for i in range(M)]
    sample_ids = (sample_ids if sample_ids is not None
                  else [f"iid{i}" for i in range(N)])
    bpm = (N + 3) // 4
    with open(prefix + ".bed", "wb") as f:
        f.write(_MAGIC + bytes([_SNP_MAJOR]))
        for a in range(0, M, _WRITE_CHUNK):
            d = np.asarray(X_dosage[:, a:a + _WRITE_CHUNK]).T
            if not np.issubdtype(d.dtype, np.floating):
                d = d.astype(np.float64)
            miss = np.isnan(d)
            dose = np.where(miss, 0, d)
            if not ((dose == 0) | (dose == 1) | (dose == 2)).all():
                raise ValueError("write_bed takes dosages in {0, 1, 2, NaN}")
            codes = np.zeros((d.shape[0], 4 * bpm), np.uint8)   # pad: 00
            codes[:, :N] = np.where(miss, np.uint8(0b01),
                                    _PLINK[dose.astype(np.int64)])
            f.write((codes[:, 0::4] | codes[:, 1::4] << 2
                     | codes[:, 2::4] << 4 | codes[:, 3::4] << 6).tobytes())
    with open(prefix + ".bim", "w") as f:
        for s in snp_ids:
            f.write(f"1\t{s}\t0\t0\tA\tC\n")
    with open(prefix + ".fam", "w") as f:
        for s in sample_ids:
            f.write(f"{s}\t{s}\t0\t0\t0\t-9\n")


def read_phenotype(path: str, column: int = -1) -> np.ndarray:
    """Read a phenotype vector from a whitespace-delimited file (.fam-style:
    last column, or a single-column file)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                rows.append(float(parts[column]))
    return np.asarray(rows)


def _read_tsv_col(path: str, col: int):
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                out.append(parts[col])
    return out
