"""The serial and row sweeps' 2-bit dot (csrc/serial.cu:serial_dot_kernel,
sites #9-#12, #15, #16) against the dot it replaced, in a plain numpy
float32 mirror of both: the same bits in every (chain, split, row) partial
and in the sum(eps) column, in the fold mode (one chain or C fused) and the
in-kernel decode (one chain).

Both give a thread one word of a split of 128 and sum a (chain, row, word)
alone: the fold mode by dot_word (the word's 16 fields in order, s <-
fmaf(c_k * 4^k', e_k * 4^-k', s) from +0, test_torch_fold_dot_order.py),
the decode as the TPU's _decode_tile, x = 0 for code 3 else (c - mean) *
scale, s <- fmaf(x, e_k, s) in field order from +0 on row_valid-masked eps.
They differ in how the sums are grouped and added up:

- the old dot: a CTA the 32 rows of a row group, 4 chains a decode at
  most (CP = 1, 2 or 4), each thread's 32 row sums of a chain through
  warp_transpose_sum, the decode's code by code_f;
- the new one: R = 32 or 16 rows a CTA, CP = 1, 2, 4 or 8 chains a decode
  (two passes above 8), chunks of 32 / CP rows staged as (p * RC + i,
  lane), lane l's tree (staged_tree) summing pair l; the decode's code by
  code_exact (fields 11-15 from w >> 22).

Then both add the four warps' sums from 0 in warp order, and sum(eps) by
the warp butterfly, then warps 0..3.  fmaf is mirrored in float64 (an exact
product) rounded to float32, the same in both, so what the tests compare
is the order of the operations.
"""
import numpy as np
import pytest

from test_torch_fold_dot_order import (dot_word, scaled_eps, staged_tree,
                                       warp_transpose_sum)

F32 = np.float32
THREADS = 128          # words a split
WARPS = THREADS // 32


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(F32)


def code_f(w, k):
    return ((w >> np.uint32(2 * k)) & np.uint32(3)).astype(F32)


def code_exact(w, k):
    """jacobi_t_common.cuh:code_exact on uint32 words, field k <= 10."""
    ex = np.uint32((150 - 2 * k) << 23)
    bits = ex | (w & np.uint32(3 << (2 * k)))
    return (bits.view(F32) - ex.reshape(1).view(F32)[0]).astype(F32)


def _padded(words, eps):
    """Words (rows, nsplit*128) and eps (C, nsplit*128, 16) padded with
    zeros past Nw, as the kernels' zero words and eps give."""
    B, Nw = words.shape
    W = -(-Nw // THREADS) * THREADS
    wpad = np.zeros((B, W), np.uint32)
    wpad[:, :Nw] = words
    e16 = np.zeros((eps.shape[0], W, 16), F32)
    e16[:, :Nw] = eps.reshape(eps.shape[0], Nw, 16)
    return wpad, e16


def fold_lane_sums(words, eps):
    """(C, rows, W) dot_word sums and (C, W) plain sum(eps) of each word."""
    wpad, e16 = _padded(words, eps)
    out, esum = [], []
    for c in range(eps.shape[0]):
        es, s = scaled_eps(e16[c])
        out.append(dot_word(wpad, es[None]))
        esum.append(s)
    return np.stack(out), np.stack(esum)


def decode_lane_sums(words, mean, scale, eps, row_valid, exact):
    """(1, rows, W) in-kernel decode sums on row_valid-masked eps; the code
    by code_exact (``exact``: the new kernel) or code_f (the old)."""
    wpad, e16 = _padded(words, eps)
    rv = np.zeros(e16.shape[1:], bool)
    rv.reshape(-1)[:row_valid.shape[0]] = row_valid
    e = np.where(rv, e16[0], F32(0))
    hi = wpad >> np.uint32(22)
    s = np.zeros(wpad.shape, F32)
    for k in range(16):
        if exact:
            c = code_exact(wpad, k) if k <= 10 else code_exact(hi, k - 11)
        else:
            c = code_f(wpad, k)
        x = np.where(c == F32(3), F32(0),
                     ((c - mean[:, None]).astype(F32) *
                      scale[:, None]).astype(F32))
        s = _fma(x, e[None, :, k], s)
    return s[None], np.zeros((1, wpad.shape[1]), F32)


def _esum_col(esum, sp):
    """sum(eps) of split sp: each warp's butterfly, then warps from 0."""
    te = F32(0)
    for q in range(WARPS):
        v = esum[sp * THREADS + 32 * q:sp * THREADS + 32 * q + 32].copy()
        for lg in (16, 8, 4, 2, 1):
            v = (v + v[np.arange(32) ^ lg]).astype(F32)
        te = F32(te + v[0])
    return te


def old_partials(s, esum, B):
    """The old serial_dot_kernel: a CTA a 32-row group, per warp the
    transpose of each chain's 32 row sums, warps from 0 (the CP grouping
    changes no chain's arithmetic)."""
    C, _, W = s.shape
    nsplit = W // THREADS
    part = np.zeros((C, nsplit, B + 1), F32)
    for c in range(C):
        for sp in range(nsplit):
            for r0 in range(0, B, 32):
                rows = np.zeros((32, W), F32)
                n = min(32, B - r0)
                rows[:n] = s[c, r0:r0 + n]
                t = np.zeros(32, F32)
                for q in range(WARPS):
                    lo = sp * THREADS + 32 * q
                    t = (t + warp_transpose_sum(rows[:, lo:lo + 32].T)).astype(
                        F32)
                part[c, sp, r0:r0 + n] = t[:n]
            part[c, sp, B] = _esum_col(esum[c], sp)
    return part


def new_partials(s, esum, B, R, CP):
    """serial_dot_kernel<CP, R>: a CTA an R-row group, chains in groups of
    CP, chunks of RC = min(R, 32 / CP) rows staged as (p * RC + i, lane),
    pair l's staged tree, warps from 0."""
    C, _, W = s.shape
    nsplit = W // THREADS
    RC = min(R, 32 // CP)
    part = np.zeros((C, nsplit, B + 1), F32)
    for c0 in range(0, C, CP):
        for sp in range(nsplit):
            for g0 in range(0, B, R):
                n = min(R, B - g0)
                wsum = np.zeros((CP, WARPS, R), F32)
                for q in range(WARPS):
                    lo = sp * THREADS + 32 * q
                    for r0 in range(0, R, RC):
                        staged = np.zeros((32, 32), F32)     # (pair, lane)
                        for i in range(RC):
                            row = g0 + r0 + i
                            for p in range(CP):
                                if c0 + p < C and row < B:
                                    staged[p * RC + i] = s[c0 + p, row,
                                                           lo:lo + 32]
                        tree = staged_tree(staged)
                        for pair in range(CP * RC):
                            p, i = divmod(pair, RC)
                            wsum[p, q, r0 + i] = tree[pair]
                for p in range(CP):
                    if c0 + p >= C:
                        continue
                    t = np.zeros(R, F32)
                    for q in range(WARPS):
                        t = (t + wsum[p, q]).astype(F32)
                    part[c0 + p, sp, g0:g0 + n] = t[:n]
            for p in range(CP):
                if c0 + p < C:
                    part[c0 + p, sp, B] = _esum_col(esum[c0 + p], sp)
    return part


def _case(seed, C, Nw, B, q=False):
    """Random words (Q: code 3 at ~3 % and at every field of some rows),
    eps of both signs with +-0 and large values, means and scales."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (B, Nw), dtype=np.uint64).astype(
        np.uint32)
    if q:
        codes = rng.integers(0, 3, (B, Nw, 16)).astype(np.uint32)
        codes[rng.random(codes.shape) < 0.03] = 3
        for k in range(16):
            codes[k % B, :, k] = 3
        words = np.zeros((B, Nw), np.uint32)
        for k in range(16):
            words |= codes[..., k] << np.uint32(2 * k)
    eps = rng.standard_normal((C, 16 * Nw)).astype(F32)
    pick = rng.random(eps.shape)
    eps[pick < 0.05] = F32(0.0)
    eps[(pick >= 0.05) & (pick < 0.1)] = F32(-0.0)
    eps[pick > 0.97] *= F32(1e4)
    mean = rng.uniform(0.2, 1.8, B).astype(F32)
    scale = (1.0 / rng.uniform(0.3, 0.9, B)).astype(F32)
    row_valid = rng.random(16 * Nw) > 0.05
    return words, eps, mean, scale, row_valid


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _cp(C):
    return 1 if C == 1 else 2 if C == 2 else 4 if C <= 4 else 8


@pytest.mark.parametrize("C", [1, 3, 8, 16])
@pytest.mark.parametrize("R", [32, 16])
@pytest.mark.parametrize("Nw,B", [(200, 128), (100, 30)])
def test_new_fold_dot_gives_the_old_partials_bitwise(C, R, Nw, B):
    """16 and 32 rows a CTA against 32; 8 chains decoded once (and 16 in
    two passes) against 4 a decode; C=3 (a pad chain in its group); a
    Nw that is not a multiple of 128; B=30 (a row group past the block)."""
    words, eps, _, _, _ = _case(C * 1000 + R + Nw + B, C, Nw, B)
    s, esum = fold_lane_sums(words, eps)
    old = old_partials(s, esum, B)
    new = new_partials(s, esum, B, R, _cp(C))
    assert np.array_equal(_bits(old), _bits(new))
    assert np.isfinite(new).all()


@pytest.mark.parametrize("R", [32, 16])
@pytest.mark.parametrize("Nw,B", [(200, 64), (100, 30)])
def test_new_decode_dot_gives_the_old_partials_bitwise(R, Nw, B):
    """The in-kernel decode (one chain): code_exact (fields 11-15 from
    w >> 22) against code_f, code 3 at every field of some row, eps masked
    by row_valid, the staged tree against the transpose."""
    words, eps, mean, scale, rv = _case(R + Nw + B, 1, Nw, B, q=True)
    s_old, esum = decode_lane_sums(words, mean, scale, eps, rv, exact=False)
    s_new, _ = decode_lane_sums(words, mean, scale, eps, rv, exact=True)
    assert np.array_equal(_bits(s_old), _bits(s_new))
    old = old_partials(s_old, esum, B)
    new = new_partials(s_new, esum, B, R, 1)
    assert np.array_equal(_bits(old), _bits(new))


def test_code_exact_decodes_every_field():
    """code_exact on fields 0-10 in place and 11-15 from w >> 22 is the
    code of every field of every word."""
    w = np.arange(2 ** 16, dtype=np.uint32) * np.uint32(65537)
    hi = w >> np.uint32(22)
    for k in range(16):
        got = code_exact(w, k) if k <= 10 else code_exact(hi, k - 11)
        assert np.array_equal(got, code_f(w, k)), k


def test_staged_pairs_are_the_transpose_rows():
    """Each pair of a staged chunk holds one (chain, row) of one warp:
    16 chains' single rows put through new_partials at CP = 8, R = 16 give
    each chain's transpose (the layout (p * RC + i) places no value in
    another pair), and summing the rows in another order shows."""
    words, eps, _, _, _ = _case(5, 16, 128, 16)
    s, esum = fold_lane_sums(words, eps)
    new = new_partials(s, esum, 16, 16, 8)
    for c in range(16):
        t = np.zeros(32, F32)
        for q in range(WARPS):
            rows = np.zeros((32, 32), F32)
            rows[:16] = s[c, :, 32 * q:32 * q + 32]
            t = (t + warp_transpose_sum(rows.T)).astype(F32)
        assert np.array_equal(_bits(new[c, 0, :16]), _bits(t[:16]))
    seq = np.zeros(16, F32)
    for lane in range(128):
        seq = (seq + s[0, :, lane]).astype(F32)
    assert not np.array_equal(_bits(new[0, 0, :16]), _bits(seq))
