"""The fused 2-bit fold dot's schedule (csrc/jacobi_t_mc.cu:
fold_dot_mc_kernel) against the one it replaced (dot_mc_kernel's fold
pass) and the single-chain dot_kernel<false>, in a plain numpy float32
mirror of both: the same bits in every (chain, split, row) partial and in
the sum(eps) column.

Both schedules sum a chain's (row, word) product with dot_word: the word's
16 fields in order, s <- fmaf(c_k * 4^k', e_k * 4^-k', s) from +0
(jacobi_t_common.cuh).  They differ in who runs it and how the 32 words of
a warp are added up:

- the old schedule: a thread holds its word's B rows for CP chains at a
  time (CP = 1, 2 or 4) and runs warp_transpose_sum, 31 shuffles that
  halve the rows a lane holds (lanes L and L ^ 16 first, then 8, 4, 2, 1);
- the new one: CP = 1, 2, 4 or 8 chains, a chunk of 32 / CP rows at a time
  staged in shared memory, lane l of the warp loading (chain, row) pair
  l's 32 values and adding them in the tree y[a] = x[a] + x[a + 16], then
  + 8, + 4, + 2, + 1.

Then both add the four warps' sums from 0 in warp order.  The fmaf is
mirrored in float64 (the product of two floats is exact there) rounded to
float32; both schedules use that one mirror, so what the tests compare is
the order of the operations.
"""
import numpy as np
import pytest

F32 = np.float32
THREADS = 128          # words a split: a CTA of the dot
WARPS = THREADS // 32


def _scale_exp(k):
    return k if k <= 10 else k - 11


def _fma(a, b, c):
    """fmaf mirrored: the exact product in float64, one add, to float32."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(F32)


def dot_word(words, e):
    """dot_word: s[..] = the codes of each word . e (pre-scaled eps of its
    16 individuals, load_eps16), the fields in order from +0; words (...,)
    and e broadcast against (..., 16)."""
    s = np.zeros(np.broadcast(words, e[..., 0]).shape, F32)
    for k in range(16):
        kk = _scale_exp(k)
        src = words if k <= 10 else words >> np.uint32(22)
        c = ((src >> np.uint32(2 * kk)) & np.uint32(3)).astype(F32)
        s = _fma(c * F32(4.0 ** kk), e[..., k], s)
    return s


def scaled_eps(eps16):
    """load_eps16: each field's eps times 4^-k' (exact, one rounding) and
    the plain sum of the 16 from 0, in order."""
    pw = np.array([2.0 ** (-2 * _scale_exp(k)) for k in range(16)], F32)
    esum = np.zeros(eps16.shape[:-1], F32)
    for k in range(16):
        esum = (esum + eps16[..., k]).astype(F32)
    with np.errstate(under="ignore"):
        return (eps16 * pw).astype(F32), esum


def warp_transpose_sum(v):
    """jacobi_t_common.cuh:warp_transpose_sum, step by step: v (32 lanes,
    32 rows, ...) -> (32,): lane l's return, the warp's sum of row l."""
    v = v.copy()
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        upper = (lanes & off) != 0
        partner = lanes ^ off
        lo, hi = v[:, :off], v[:, off:2 * off]
        send = np.where(upper[:, None], lo, hi)
        keep = np.where(upper[:, None], hi, lo)
        v = (keep + send[partner]).astype(F32)
    return v[:, 0]


def staged_tree(x):
    """fold_dot_mc_kernel's sum of a staged pair: x (..., 32 words) added
    in the tree a + 16, + 8, + 4, + 2, + 1."""
    y = (x[..., :16] + x[..., 16:]).astype(F32)
    for h in (8, 4, 2, 1):
        y = (y[..., :h] + y[..., h:2 * h]).astype(F32)
    return y[..., 0]


def _case(seed, C, Nw, B):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (B, Nw), dtype=np.uint64).astype(
        np.uint32)
    eps = rng.standard_normal((C, 16 * Nw)).astype(F32)
    pick = rng.random(eps.shape)
    eps[pick < 0.05] = F32(0.0)
    eps[(pick >= 0.05) & (pick < 0.1)] = F32(-0.0)
    big = pick > 0.97
    eps[big] *= F32(1e4)
    return words, eps


def _lane_sums(words, eps, C, CP, B):
    """Per chain group of CP, each chain c < C and each (row, word) of the
    block: dot_word's sum (0 for words past Nw and rows past B, as the
    kernels' zero words give), (C, 32, nsplit * 128); and each chain's
    per-word sum(eps)."""
    Nw = words.shape[1]
    nsplit = -(-Nw // THREADS)
    W = nsplit * THREADS
    wpad = np.zeros((32, W), np.uint32)
    wpad[:B, :Nw] = words
    out = np.zeros((C, 32, W), F32)
    esum = np.zeros((C, W), F32)
    for c0 in range(0, C, CP):
        for p in range(CP):
            c = c0 + p
            if c >= C:
                continue   # a pad chain of the group: e = 0, not written
            e16 = np.zeros((W, 16), F32)
            e16[:Nw] = eps[c].reshape(Nw, 16)
            es, esum[c] = scaled_eps(e16)
            out[c] = dot_word(wpad, es[None])
    return out, esum


def old_schedule(words, eps, C, B):
    """dot_mc_kernel's fold pass (CP = 1, 2, 4) and dot_kernel<false>:
    per warp the transpose, then warps 0..3 from 0; sum(eps) by warp_sum's
    butterfly, then warps 0..3."""
    CP = 1 if C == 1 else 2 if C == 2 else 4
    s, esum = _lane_sums(words, eps, C, CP, B)
    nsplit = s.shape[2] // THREADS
    part = np.zeros((C, nsplit, B), F32)
    ecol = np.zeros((C, nsplit), F32)
    for c in range(C):
        for sp in range(nsplit):
            t = np.zeros(32, F32)
            te = F32(0)
            for q in range(WARPS):
                lo = sp * THREADS + 32 * q
                t = (t + warp_transpose_sum(s[c, :, lo:lo + 32].T)).astype(
                    F32)
                v = esum[c, lo:lo + 32].copy()
                for lg in (16, 8, 4, 2, 1):
                    v = (v + v[np.arange(32) ^ lg]).astype(F32)
                te = F32(te + v[0])
            part[c, sp] = t[:B]
            ecol[c, sp] = te
    return part, ecol


def new_schedule(words, eps, C, B):
    """fold_dot_mc_kernel: CP = 1, 2, 4 or 8 chains; chunks of R = 32 / CP
    rows staged as (p * R + i, lane), pair l = lane l's tree; the warps'
    sums from 0 in warp order; sum(eps) as the old schedule."""
    CP = 1 if C == 1 else 2 if C == 2 else 4 if C <= 4 else 8
    R = 32 // CP
    s, esum = _lane_sums(words, eps, C, CP, B)
    nsplit = s.shape[2] // THREADS
    part = np.zeros((C, nsplit, B), F32)
    ecol = np.zeros((C, nsplit), F32)
    for c0 in range(0, C, CP):
        for sp in range(nsplit):
            wsum = np.zeros((CP, WARPS, 32), F32)
            for q in range(WARPS):
                lo = sp * THREADS + 32 * q
                for r0 in range(0, B, R):
                    staged = np.zeros((32, 32), F32)   # (pair, lane)
                    for i in range(R):
                        for p in range(CP):
                            if c0 + p < C:
                                staged[p * R + i] = s[c0 + p, r0 + i,
                                                      lo:lo + 32]
                    tree = staged_tree(staged)
                    for pair in range(32):
                        p, i = divmod(pair, R)
                        wsum[p, q, r0 + i] = tree[pair]
            for p in range(CP):
                c = c0 + p
                if c >= C:
                    continue
                t = np.zeros(32, F32)
                te = F32(0)
                for q in range(WARPS):
                    t = (t + wsum[p, q]).astype(F32)
                    lo = sp * THREADS + 32 * q
                    v = esum[c, lo:lo + 32].copy()
                    for lg in (16, 8, 4, 2, 1):
                        v = (v + v[np.arange(32) ^ lg]).astype(F32)
                    te = F32(te + v[0])
                part[c, sp] = t[:B]
                ecol[c, sp] = te
    return part, ecol


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("C", [1, 3, 8, 16])
@pytest.mark.parametrize("Nw,B", [(200, 32), (100, 30)])
def test_new_schedule_gives_the_old_partials_bitwise(C, Nw, B):
    """C not a multiple of CP (3 at CP=4, 3 at CP=8 in the old-style
    count), a Nw that is not a multiple of 128 (words past it read as 0),
    B=30 (a last chunk with rows past B at CP=8 and 4)."""
    words, eps = _case(C * 100 + Nw + B, C, Nw, B)
    old_p, old_e = old_schedule(words, eps, C, B)
    new_p, new_e = new_schedule(words, eps, C, B)
    assert np.array_equal(_bits(old_p), _bits(new_p))
    assert np.array_equal(_bits(old_e), _bits(new_e))
    assert np.isfinite(new_p).all()


def test_staged_tree_is_warp_transpose_sum_and_order_shows():
    """The staged tree equals the literal transpose for every row, with
    mixed magnitudes, signs and zeros; a plain left-to-right sum of the
    same values does not (the comparison sees a change of order)."""
    rng = np.random.default_rng(11)
    v = (rng.standard_normal((32, 32)) *
         10.0 ** rng.integers(-6, 7, (32, 32))).astype(F32)
    v[rng.random((32, 32)) < 0.1] = F32(-0.0)
    ref = warp_transpose_sum(v)
    tree = staged_tree(v.T.copy())
    assert np.array_equal(_bits(ref), _bits(tree))
    seq = np.zeros(32, F32)
    for lane in range(32):
        seq = (seq + v[lane]).astype(F32)
    assert not np.array_equal(_bits(ref), _bits(seq))


def test_pad_chains_and_words_add_plus_zero():
    """Words past Nw and chains past C give +0 products (zero words, zero
    eps), so a row whose real sums are all -0 still gives +0, as in both
    kernels."""
    words = np.zeros((32, 1), np.uint32)
    eps = np.full((1, 16), -1.0, F32)
    old_p, _ = old_schedule(words, eps, 1, 32)
    new_p, _ = new_schedule(words, eps, 1, 32)
    assert not np.signbit(new_p).any()
    assert np.array_equal(_bits(old_p), _bits(new_p))
