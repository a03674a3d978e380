"""The fused miss-mode dot's indicator pass (csrc/jacobi_t_mc.cu:miss_rows)
against the dense form that the single-chain dot runs
(csrc/jacobi_t_common.cuh:dot_rows on miss_bits), in a plain numpy float32
mirror of both: the same bits for every (word, row) sum.

The dense form takes, for each of a word's 16 fields k in order, one FMA
s <- fl(c_k * e_k' + s) with c_k = 4^k' where field k holds a missing call
(code 3) and 0 elsewhere, and e_k' = fl(eps_k * 4^-k') (load_eps16;
k' = k for k <= 10, k - 11 above: those fields are read from w >> 22).  The
product c_k * e_k' is exact (a power of two times a float), so each step is
s <- fl(s + fl(c_k * e_k')); a zero product leaves s unchanged (s starts at
+0 and is never -0).  The sparse form adds fl(e_k' * 4^k') only at the
fields whose call is missing, in ascending bit position of miss_bits, which
is ascending k.  Equal for every finite eps, subnormal scaled values
included.  A sparse form that added eps_k itself would part from it where
eps_k * 4^-k' is subnormal, below 2^-106 (the last test shows where).
"""
import numpy as np
import pytest

F32 = np.float32


def _words(rng, n, rate):
    """n random 32-bit words of 16 2-bit codes, each field code 3 (a
    missing call) at ``rate``, else 0, 1 or 2."""
    codes = rng.integers(0, 3, (n, 16), dtype=np.uint32)
    codes[rng.random((n, 16)) < rate] = 3
    return (codes << (2 * np.arange(16, dtype=np.uint32))).sum(
        axis=1, dtype=np.uint32)


def _miss_bits(w):
    """csrc/jacobi_t_common.cuh:miss_bits: bit 2k set where field k is 3."""
    return w & (w >> np.uint32(1)) & np.uint32(0x55555555)


def _scale_exp(k):
    return k if k <= 10 else k - 11


def _scaled_eps(e):
    """load_eps16: field k's eps times 4^-k' (an exact power of two, one
    float32 rounding)."""
    pw = np.array([2.0 ** (-2 * _scale_exp(k)) for k in range(16)], F32)
    with np.errstate(under="ignore"):
        return (e.astype(F32) * pw).astype(F32)


def dense_form(words, e):
    """dot_rows on the indicator: 16 FMAs a word, every field."""
    es = _scaled_eps(e)
    mb = _miss_bits(words)
    s = np.zeros(words.shape, F32)
    with np.errstate(under="ignore"):
        for k in range(16):
            c = np.where((mb >> np.uint32(2 * k)) & np.uint32(1),
                         F32(4.0 ** _scale_exp(k)), F32(0))
            s = (s + (c * es[:, k]).astype(F32)).astype(F32)
    return s


def sparse_form(words, e, rescale=True):
    """miss_rows: only the set bits of miss_bits, lowest first (the
    kernel's __ffs loop), adding e' = fl(e_k' * 4^k'); with ``rescale``
    False, eps_k itself."""
    es = _scaled_eps(e)
    up = np.array([4.0 ** _scale_exp(k) for k in range(16)], F32)
    ep = (es * up).astype(F32) if rescale else e.astype(F32)
    m = _miss_bits(words).astype(np.int64)
    s = np.zeros(words.shape, F32)
    rows = np.arange(words.shape[0])
    while (m != 0).any():
        on = m != 0
        low = m & -m
        k = np.zeros_like(m)
        k[on] = np.log2(low[on]).astype(np.int64) >> 1
        add = np.where(on, ep[rows, k], F32(0))
        s = np.where(on, (s + add).astype(F32), s)
        m = m & (m - 1)
    return s


def _eps(rng, n):
    """eps with both signs, exact zeros, -0, and magnitudes from ~10 down
    to 2^-106, the smallest whose scaled value (times 4^-10) is normal."""
    e = rng.standard_normal((n, 16)).astype(F32)
    pick = rng.random((n, 16))
    e[pick < 0.05] = F32(0.0)
    e[(pick >= 0.05) & (pick < 0.1)] = F32(-0.0)
    tiny = (pick >= 0.1) & (pick < 0.3)
    mant = rng.uniform(1.0, 2.0, tiny.sum())
    expo = rng.integers(-106, -60, tiny.sum())
    e[tiny] = (np.sign(rng.standard_normal(tiny.sum())) * mant *
               2.0 ** expo.astype(float)).astype(F32)
    return e


@pytest.mark.parametrize("rate", [2.0 ** -6, 0.03, 0.5, 1.0])
def test_sparse_indicator_is_the_dense_form_bitwise(rate):
    rng = np.random.default_rng(int(rate * 1e4))
    n = 20_000
    words = _words(rng, n, rate)
    e = _eps(rng, n)
    d, s = dense_form(words, e), sparse_form(words, e)
    assert np.array_equal(d.view(np.uint32), s.view(np.uint32))
    # a sum is never -0: the dense form's zero products leave it alone
    assert not np.signbit(d[d == 0]).any()
    if rate <= 0.03:   # most words hold no missing call at all
        assert (d == 0).mean() > 0.5


def test_sparse_indicator_words_without_or_with_only_missing_calls():
    rng = np.random.default_rng(5)
    e = _eps(rng, 64)
    none = _words(rng, 64, 0.0)
    assert (sparse_form(none, e) == 0).all()
    assert not np.signbit(sparse_form(none, e)).any()
    full = np.full(64, 0xFFFFFFFF, np.uint32)
    assert np.array_equal(dense_form(full, e).view(np.uint32),
                          sparse_form(full, e).view(np.uint32))


def test_where_adding_eps_itself_parts_from_the_dense_form():
    """Below 2^-106, eps * 4^-k' is subnormal for k' = 10 and loses its
    low bits: the dense form adds the rounded product, so a sparse form
    that added eps itself would differ, while the kernel's e' (the scaled
    value scaled back, exact) keeps the equality."""
    e = np.zeros((1, 16), F32)
    e[0, 10] = F32(np.ldexp(1.0 + 2.0 ** -23, -110))   # field 10: k' = 10
    w = np.array([np.uint32(3) << np.uint32(20)], np.uint32)   # field 10 is 3
    d = dense_form(w, e)
    assert d[0] != e[0, 10]
    assert np.array_equal(d.view(np.uint32), sparse_form(w, e).view(np.uint32))
    assert sparse_form(w, e, rescale=False)[0] == e[0, 10]
    # at 2^-106 and above the scaled value is normal: both sparse forms agree
    e[0, 10] = F32(np.ldexp(1.0 + 2.0 ** -23, -106))
    assert dense_form(w, e)[0] == sparse_form(w, e, rescale=False)[0]
