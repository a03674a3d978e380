"""The single-chain 2-bit apply's schedule (csrc/jacobi_t.cu:apply_kernel)
against the one it replaced, in a plain numpy float32 mirror of both: the
same bits in every eps lane, in the fold and the miss modes.

The old apply compacted a round's moved entries (d*scale != 0) in index
order, then each lane added, row by row, fmaf(d, c, acc) from +0 with c
its code (code_f), and in the miss mode fmaf(d*(m - 3), i, acc) with i its
missing-call bit (apply_missing); eps <- eps - (acc - dms_tot).  The new
one:

- compacts with every thread: entry e = k * 320 + thread, a ballot a warp
  into mask word 10k + warp, one warp's exclusive prefix of the words'
  counts (4 words a lane), each moved entry written at prefix + the
  moved lanes below it;
- streams the listed rows in stages of 32, the last one partial;
- decodes a code with code_exact (the field under the exponent of
  2^(23 - 2k), less 2^(23 - 2k)), and in the miss mode adds d*(m - 3)
  only where the call is missing: fmaf(x, 0, acc) is acc, which never is
  -0, for finite x.

The fmaf is mirrored in float64 (an exact product) rounded to float32, the
same in both schedules.
"""
import numpy as np
import pytest

F32 = np.float32
THREADS = 320      # 6 consumer warps and 4 issuer warps
ROWS = 32          # rows a stage
MAX_ROUND = 4096


def _fma(a, b, c):
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def code_exact(w, k):
    """jacobi_t_common.cuh:code_exact on uint32 words, field k <= 10."""
    ex = np.uint32((150 - 2 * k) << 23)
    bits = ex | (w & np.uint32(3 << (2 * k)))
    return (bits.view(F32) - ex.reshape(1).view(F32)[0]).astype(F32)


def code_f(w, k):
    return ((w >> np.uint32(2 * k)) & np.uint32(3)).astype(F32)


def miss_bits(w):
    return w & (w >> np.uint32(1)) & np.uint32(0x55555555)


def compact_old(d):
    """The old apply's compaction: the moved entries in index order."""
    return np.flatnonzero(d != 0)


def compact_new(d):
    """apply_kernel's pre-pass and scatter, warp by warp: the list of the
    moved entries, each at the place the kernel writes it."""
    JB = d.shape[0]
    per = -(-MAX_ROUND // THREADS)
    nmw = -(-JB // 32)
    moved = np.zeros(MAX_ROUND // 32, np.uint32)
    for k in range(per):
        for warp in range(THREADS // 32):
            e0 = k * THREADS + 32 * warp
            if e0 >= JB:
                continue
            e = e0 + np.arange(32)
            bit = np.array([x < JB and d[x] != 0 for x in e])
            moved[k * (THREADS // 32) + warp] = np.uint32(
                (bit.astype(np.uint64) << np.arange(32, dtype=np.uint64))
                .sum())
    pop = np.array([bin(int(m)).count("1") for m in moved])
    lane_tot = np.array([pop[4 * l:4 * l + 4][:max(0, nmw - 4 * l)].sum()
                         for l in range(32)])
    incl = lane_tot.copy()
    for off in (1, 2, 4, 8, 16):            # the shfl_up scan
        incl = incl + np.where(np.arange(32) >= off,
                               np.roll(incl, off), 0)
    prefix = np.zeros(MAX_ROUND // 32, int)
    for l in range(32):
        run = incl[l] - lane_tot[l]
        for i in range(4):
            m = 4 * l + i
            if m < nmw:
                prefix[m] = run
                run += pop[m]
    nnz = int(incl[31])
    out = np.full(nnz, -1)
    for k in range(per):
        for warp in range(THREADS // 32):
            m = k * (THREADS // 32) + warp
            for lane in range(32):
                e = k * THREADS + 32 * warp + lane
                if e < JB and d[e] != 0:
                    below = int(moved[m]) & ((1 << lane) - 1)
                    out[prefix[m] + bin(below).count("1")] = e
    assert (out >= 0).all()
    return out


def apply_old(words, d, dm, eps, dms, miss):
    """Per lane: the compacted rows in order, code then indicator FMA."""
    acc = np.zeros(words.shape[1] * 16, F32)
    for e in compact_old(d):
        wd = words[e]
        c = np.stack([code_f(wd, k) for k in range(16)], 1).ravel()
        acc = _fma(d[e], c, acc)
        if miss:
            mi = miss_bits(wd)
            i = np.stack([code_f(mi, k) for k in range(16)], 1).ravel()
            acc = _fma(dm[e], i, acc)
    return _finish(eps, acc, dms)


def apply_new(words, d, dm, eps, dms, miss):
    """Per lane (4 a thread: byte `sub` of the word, shifted down): the
    listed rows stage by stage, code_exact, the predicated miss add."""
    acc = np.zeros((words.shape[1], 4, 4), F32)       # word, sub, lane
    lst = compact_new(d)
    for st in range(0, len(lst), ROWS):
        for e in lst[st:st + ROWS]:                    # a partial last stage
            for sub in range(4):
                wd = words[e] >> np.uint32(8 * sub)
                for k in range(4):
                    acc[:, sub, k] = _fma(d[e], code_exact(wd, k),
                                          acc[:, sub, k])
                if miss:
                    mi = miss_bits(wd)
                    for k in range(4):
                        on = ((mi >> np.uint32(2 * k)) & np.uint32(1)) != 0
                        acc[:, sub, k] = np.where(
                            on, (acc[:, sub, k] + dm[e]).astype(F32),
                            acc[:, sub, k])
    return _finish(eps, acc.reshape(-1), dms)


def _finish(eps, acc, dms):
    dt = F32(0)
    for x in dms:
        dt = F32(dt + x)
    assert not np.signbit(acc[acc == 0]).any()      # acc is never -0
    return (eps - (acc - dt).astype(F32)).astype(F32)


def _case(seed, JB, moving, Nw=5, miss=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 3, (JB, Nw * 16)).astype(np.uint32)
    if miss:
        codes[rng.random(codes.shape) < 0.1] = 3
    shifts = (2 * np.arange(16, dtype=np.uint32))
    words = (codes.reshape(JB, Nw, 16) << shifts).sum(
        axis=2, dtype=np.uint64).astype(np.uint32)
    d = np.zeros(JB, F32)
    at = rng.choice(JB, moving, replace=False)
    d[at] = (rng.standard_normal(moving) *
             10.0 ** rng.integers(-8, 2, moving)).astype(F32)
    d[rng.random(JB) < 0.05] = F32(-0.0)      # -0 is no move
    mean = rng.uniform(0.0, 2.0, JB).astype(F32)
    dm = (d * (mean - F32(3))).astype(F32)
    eps = rng.standard_normal(Nw * 16).astype(F32)
    dms = rng.standard_normal(max(1, JB // 32)).astype(F32)
    return words, d, dm, eps, dms


@pytest.mark.parametrize("miss", [False, True])
@pytest.mark.parametrize("JB,moving", [(4096, 0), (4096, 1), (4096, 5),
                                       (4096, 1000), (4096, 4096),
                                       (90, 37)])
def test_new_apply_gives_the_old_eps_bitwise(JB, moving, miss):
    """No, one, a few, 1,000 (a partial last stage of 8 rows) and all
    4,096 moved rows, and a round of 90 entries (J=3, B=30: a partial
    mask word)."""
    words, d, dm, eps, dms = _case(JB + moving + miss, JB, moving,
                                   Nw=2 if moving > 1000 else 5, miss=miss)
    old = apply_old(words, d, dm, eps, dms, miss)
    new = apply_new(words, d, dm, eps, dms, miss)
    assert np.array_equal(old.view(np.uint32), new.view(np.uint32))


@pytest.mark.parametrize("JB", [2, 90, 1000, 4096])
def test_compaction_lists_the_moved_entries_in_index_order(JB):
    rng = np.random.default_rng(JB)
    d = np.where(rng.random(JB) < 0.3, rng.standard_normal(JB), 0).astype(F32)
    assert np.array_equal(compact_new(d), compact_old(d))


def test_code_exact_is_the_code():
    w = np.arange(2 ** 16, dtype=np.uint32) * np.uint32(65537)
    for k in range(11):
        assert np.array_equal(code_exact(w, k), code_f(w, k))
