"""The serial and row sweeps' 2-bit apply (csrc/serial.cu:serial_apply_kernel,
sites #9-#12, #15, #16) against the schedule it replaced, in a plain numpy
float32 mirror of both: the same bits in every eps lane of every chain and
in the carried sum(eps), in the fold mode (one chain or C fused) and the
in-kernel decode (Q: one chain, J=1).

The old apply took the round's J*B entries in tiles of 512; in each tile
the entries where any chain's d != 0 were compacted in index order, and
each lane added, row by row, fmaf(d_c, x, acc_c) from +0 for every chain c,
x its code (code_f; Q: x = c == 3 ? 0 : (c - mean)*scale).  The new one:

- lists of up to 4,096 entries (one chain) or 1,024 (fused chains, J=1),
  one after the other; in a list, entry e = k * 320 + thread, a ballot a
  warp into mask word 10k + warp, one warp's exclusive prefix of the
  words' counts (4 words a lane for 4,096 entries, 1 for 1,024), each
  moved entry written at prefix + the moved lanes below it, with its row
  border[q0 + e / B] * B + e % B, every chain's d and, in Q, the row's
  mean and scale;
- a thread of the CTA's 192 consumers adds L lanes of a word (L = 4 for
  one chain, 2 for fused chains: field group `sub` of 16 / L, shifted
  down), each code decoded by code_exact (the field under the exponent of
  2^(23 - 2k), less 2^(23 - 2k)), so a CTA takes 12 * L words of every row
  (48 or 24; the last CTA fewer); the listed rows go in stages of 32 (the
  last partial) through a ring of 8 slots, stage g into slot g % 8 across
  the lists, a slot refilled only once its last stage was consumed.

Both take each lane's sum a block at a time (acc_j from +0 over block j's
moved entries) and end with eps <- eps - tot, tot = (+0 + (acc_0 -
dms[0])) + ... + (acc_{J-1} - dms[J-1]) in j order (Q, J = 1: eps -
acc_0) on the lanes of row_valid, and CTA 0's esum <- esum - (espart[0] +
... + espart[J-1]).  At J = 1 that is eps - (acc - dms[0]), the bits of
the kernel before it took its sums by block; a row round's J*B updates no
longer pile up in one f32 sum.  fmaf is mirrored in float64 (an exact
product) rounded to float32, the same in both schedules, so what the
tests compare is the order of the operations.
"""
import numpy as np
import pytest

F32 = np.float32
THREADS = 320      # 6 consumer warps and 4 issuer warps
CONSUMERS = 192
ROWS = 32          # rows a stage
STAGES = 8         # slots of the ring
OLD_TILE = 512


def _fma(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def code_f(w, k):
    return ((w >> np.uint32(2 * k)) & np.uint32(3)).astype(F32)


def code_exact(w, k):
    """jacobi_t_common.cuh:code_exact on uint32 words, field k <= 10."""
    ex = np.uint32((150 - 2 * k) << 23)
    bits = ex | (w & np.uint32(3 << (2 * k)))
    return (bits.view(F32) - ex.reshape(1).view(F32)[0]).astype(F32)


def decode_q(c, m, s):
    """The in-kernel decode of a code c (float32): 0 for code 3, else
    (c - mean) * scale, two roundings."""
    return np.where(c == F32(3), F32(0),
                    ((c - F32(m)).astype(F32) * F32(s)).astype(F32))


def list_tile(C, JB):
    """Entries a list of the new apply: 4,096 for one chain, 1,024 fused
    (serial.cu:sa_tile), at most the round's."""
    return min(JB, 4096 if C == 1 else 1024)


def compact_new(moved):
    """serial_apply_kernel's pre-pass and scatter over one list: the
    entries where ``moved``, each at the place the kernel writes it."""
    n = moved.shape[0]
    per = -(-n // THREADS)
    nmask = 128 if n > 1024 else 32
    pl = nmask // 32
    nmw = -(-n // 32)
    mask = np.zeros(max(nmask, per * THREADS // 32), np.uint64)
    for k in range(per):
        for warp in range(THREADS // 32):
            e0 = k * THREADS + 32 * warp
            if e0 >= n:
                continue
            e = e0 + np.arange(32)
            bit = np.array([x < n and bool(moved[x]) for x in e])
            mask[k * (THREADS // 32) + warp] = (
                bit.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum()
    pop = np.array([bin(int(m)).count("1") for m in mask[:nmask]])
    lane_tot = np.array([sum(pop[pl * l + i] for i in range(pl)
                             if pl * l + i < nmw) for l in range(32)])
    incl = lane_tot.copy()
    for off in (1, 2, 4, 8, 16):            # the shfl_up scan
        incl = incl + np.where(np.arange(32) >= off, np.roll(incl, off), 0)
    prefix = np.zeros(nmask, int)
    for l in range(32):
        run = incl[l] - lane_tot[l]
        for i in range(pl):
            m = pl * l + i
            if m < nmw:
                prefix[m] = run
                run += pop[m]
    out = np.full(int(incl[31]), -1)
    for k in range(per):
        for warp in range(THREADS // 32):
            m = k * (THREADS // 32) + warp
            for lane in range(32):
                e = k * THREADS + 32 * warp + lane
                if e < n and moved[e]:
                    below = int(mask[m]) & ((1 << lane) - 1)
                    out[prefix[m] + bin(below).count("1")] = e
    assert (out >= 0).all()
    return out


def round_rows(border, J, B):
    e = np.arange(J * B)
    return border[e // B] * B + e % B


def _finish(eps, acc, dms, row_valid, q):
    """acc (C, J, lanes): each block's sum.  eps - tot, tot the blocks'
    acc_j - dms[j] summed in j order from +0 (Q: eps - acc_0), on the
    valid lanes."""
    out = eps.copy()
    for c in range(eps.shape[0]):
        assert not np.signbit(acc[c][acc[c] == 0]).any()   # never -0
        if q:
            new = (eps[c] - acc[c, 0]).astype(F32)
        else:
            tot = np.zeros(eps.shape[1], F32)
            for j in range(acc.shape[1]):
                tot = (tot + (acc[c, j] - dms[c, j]).astype(F32)).astype(F32)
            new = (eps[c] - tot).astype(F32)
        out[c] = np.where(row_valid, new, eps[c])
    return out


def carry_esum(esum, espart):
    """CTA 0's carry: esum - (espart[0] + ... + espart[J-1])."""
    out = esum.copy()
    for c in range(esum.shape[0]):
        e = espart[c, 0]
        for x in espart[c, 1:]:
            e = F32(e + x)
        out[c] = F32(esum[c] - e)
    return out


def apply_old(case):
    """serial_apply_kernel as it was: tiles of 512 entries, the moved ones
    in index order, every lane's 16 codes by code_f, every chain."""
    words, d, eps, rv, dms, border, J, B = (
        case[k] for k in ("words", "d", "eps", "row_valid", "dms", "border",
                          "J", "B"))
    q = case["q"]
    C, JB = d.shape
    rows = round_rows(border, J, B)
    acc = np.zeros((C, J, eps.shape[1]), F32)
    for t0 in range(0, JB, OLD_TILE):
        tile = d[:, t0:t0 + OLD_TILE]
        for e in t0 + np.flatnonzero((tile != 0).any(0)):
            wd = words[rows[e]]
            x = np.stack([code_f(wd, k) for k in range(16)], 1).ravel()
            if q:
                x = decode_q(x, case["mean"][rows[e]], case["scale"][rows[e]])
            for c in range(C):
                acc[c, e // B] = _fma(d[c, e], x, acc[c, e // B])
    return _finish(eps, acc, dms, rv, q), carry_esum(case["esum"],
                                                     case["espart"])


def lanes(C):
    """Eps lanes a consumer thread (serial.cu:sa_lanes)."""
    return 4 if C == 1 else 2


def apply_new(case, order=None):
    """serial_apply_kernel: the lists' compaction, each CTA's segments of
    the listed rows through the ring, L lanes a thread by code_exact.
    ``order`` (tests only) permutes each list."""
    words, d, eps, rv, dms, border, J, B = (
        case[k] for k in ("words", "d", "eps", "row_valid", "dms", "border",
                          "J", "B"))
    q = case["q"]
    C, JB = d.shape
    Nw = words.shape[1]
    tile = list_tile(C, JB)
    rows = round_rows(border, J, B)
    L = lanes(C)
    parts = 16 // L
    W = CONSUMERS // parts                          # words a CTA
    acc = np.zeros((C, J, Nw, parts, L), F32)      # chain, block, word, ..
    for w0 in range(0, Nw, W):                      # a CTA
        nw = min(W, Nw - w0)
        ring = np.zeros((STAGES, ROWS, W), np.uint32)
        g = 0                                       # ring stage
        for t0 in range(0, JB, tile):
            n = min(tile, JB - t0)
            lst = compact_new((d[:, t0:t0 + n] != 0).any(0))
            if order is not None:
                lst = order(lst)
            e_list = t0 + lst
            nst = -(-len(e_list) // ROWS)
            filled = 0
            for st in range(nst):
                # the issuers run up to a ring ahead of the consumers
                while filled < nst and filled < st + STAGES:
                    part = e_list[filled * ROWS:(filled + 1) * ROWS]
                    slot = (g + filled) % STAGES
                    ring[slot, :len(part), :nw] = words[rows[part], w0:w0 + nw]
                    filled += 1
                slot = (g + st) % STAGES
                part = e_list[st * ROWS:(st + 1) * ROWS]   # partial at the end
                for qr, e in enumerate(part):
                    seg = ring[slot, qr, :nw]
                    for sub in range(parts):
                        wd = seg >> np.uint32(2 * L * sub)
                        x = np.stack([code_exact(wd, k) for k in range(L)], 1)
                        if q:
                            x = decode_q(x, case["mean"][rows[e]],
                                         case["scale"][rows[e]])
                        for c in range(C):
                            acc[c, e // B, w0:w0 + nw, sub] = _fma(
                                d[c, e], x, acc[c, e // B, w0:w0 + nw, sub])
            g += nst
    return (_finish(eps, acc.reshape(C, J, -1), dms, rv, q),
            carry_esum(case["esum"], case["espart"]))


def _case(seed, C, J, B, moving, Nw=52, q=False):
    """C chains' d over a round of J blocks of B (``moving``: the share of
    entries moved in some chain, each chain moving a random part of them,
    the others d = 0 or -0 there), words of codes 0-2 (Q: code 3 at ~10 %
    and at every field of some row), a lane mask with holes, dms and
    espart of mixed magnitudes."""
    rng = np.random.default_rng(seed)
    nb = 2 * J
    Mpad = nb * B
    codes = rng.integers(0, 3, (Mpad, Nw, 16)).astype(np.uint32)
    if q:
        codes[rng.random(codes.shape) < 0.1] = 3
        for k in range(16):
            codes[k % Mpad, :, k] = 3
    words = np.zeros((Mpad, Nw), np.uint32)
    for k in range(16):
        words |= codes[..., k] << np.uint32(2 * k)
    JB = J * B
    d = np.zeros((C, JB), F32)
    any_moved = rng.random(JB) < moving
    for c in range(C):
        mine = any_moved & (rng.random(JB) < (1.0 if C == 1 else 0.6))
        d[c, mine] = (rng.standard_normal(mine.sum()) *
                      10.0 ** rng.integers(-8, 2, mine.sum())).astype(F32)
        d[c, any_moved & ~mine & (rng.random(JB) < 0.5)] = F32(-0.0)
    d[:, rng.random(JB) < 0.02] = F32(-0.0)      # -0 in every chain: no move
    Npad = 16 * Nw
    eps = rng.standard_normal((C, Npad)).astype(F32)
    rv = rng.random(Npad) > 0.1
    eps[:, ~rv] = 0
    return dict(
        words=words, d=d, eps=eps, row_valid=rv, J=J, B=B, q=q,
        border=rng.permutation(nb)[:J],
        dms=(rng.standard_normal((C, J)) *
             10.0 ** rng.integers(-3, 3, (C, J))).astype(F32),
        espart=(rng.standard_normal((C, J)) *
                10.0 ** rng.integers(-3, 3, (C, J))).astype(F32),
        esum=rng.standard_normal(C).astype(F32),
        mean=rng.uniform(0.0, 2.0, Mpad).astype(F32),
        scale=(1.0 / rng.uniform(0.3, 0.9, Mpad)).astype(F32))


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("C,J,B,moving", [
    (1, 1, 30, 0.5),        # a partial mask word and stage
    (1, 1, 512, 0.05),      # few moved rows (BayesR): one stage
    (1, 1, 1024, 1.0),      # every row (the horseshoe): 32 stages, 4 laps
    (1, 32, 128, 1.0),      # the row horseshoe: 4,096 rows, 128 stages
    (1, 32, 512, 0.3),      # 16,384 entries: four lists through one ring
    (3, 1, 128, 0.5),       # C not a power of two (CB = 4)
    (8, 1, 128, 1.0),       # the row plans' 8 fused chains at B = 128
    (16, 1, 1024, 0.4),     # the largest list: 16 chains x 1,024 entries
])
def test_new_apply_gives_the_old_eps_bitwise(C, J, B, moving):
    """Fold mode, one chain and fused: every eps lane of every chain and
    the carried sum(eps) equal bit for bit, lanes off row_valid
    untouched; Nw = 52 words, so the last CTA covers 4 of its 48 (one
    chain) or of its 24 (fused)."""
    case = _case(C * 1000 + J * 10 + B, C, J, B, moving)
    old_eps, old_esum = apply_old(case)
    new_eps, new_esum = apply_new(case)
    assert np.array_equal(_bits(old_eps), _bits(new_eps))
    assert np.array_equal(_bits(old_esum), _bits(new_esum))
    assert np.array_equal(new_eps[:, ~case["row_valid"]],
                          case["eps"][:, ~case["row_valid"]])


@pytest.mark.parametrize("B,moving", [(30, 1.0), (512, 0.1), (1024, 1.0)])
def test_new_decode_apply_gives_the_old_eps_bitwise(B, moving):
    """The in-kernel decode (one chain, J=1, words with missing calls,
    code 3 at every field of some row): x = c == 3 ? 0 : (c - mean)*scale
    on the code_exact decode gives the old eps bit for bit; code 3 adds
    nothing."""
    case = _case(B + 7, 1, 1, B, moving, q=True)
    old_eps, _ = apply_old(case)
    new_eps, _ = apply_new(case)
    assert np.array_equal(_bits(old_eps), _bits(new_eps))
    # a row of code 3 only changes no lane
    only3 = dict(case, words=np.full_like(case["words"], 0xFFFFFFFF))
    assert np.array_equal(_bits(apply_new(only3)[0]), _bits(case["eps"]))


@pytest.mark.parametrize("C,JB", [(1, 2), (1, 90), (1, 4096), (3, 1000),
                                  (16, 1024)])
def test_compaction_lists_rows_moved_in_any_chain_in_index_order(C, JB):
    rng = np.random.default_rng(C + JB)
    d = np.where(rng.random((C, JB)) < 0.2, rng.standard_normal((C, JB)),
                 0).astype(F32)
    moved = (d != 0).any(0)
    assert np.array_equal(compact_new(moved), np.flatnonzero(moved))


def test_order_of_the_rows_shows():
    """The comparison sees the order: the new schedule with each list
    reversed gives other bits (16 chains, every row moving)."""
    case = _case(3, 16, 1, 1024, 1.0)
    old_eps, _ = apply_old(case)
    back = apply_new(case, order=lambda lst: lst[::-1])[0]
    assert not np.array_equal(_bits(old_eps), _bits(back))


def test_esum_carry_in_j_order():
    """CTA 0's carry adds the blocks' espart in j order from the first
    (J=32): summed backwards it differs."""
    case = _case(11, 1, 32, 16, 0.1)
    esum, espart = case["esum"], case["espart"]
    espart[:, 0] = F32(1e8)
    espart[:, 1:] = F32(3.0)
    got = carry_esum(esum, espart)
    back = esum.copy()
    for c in range(1):
        e = F32(0)
        for x in espart[c, ::-1]:
            e = F32(e + x)
        back[c] = F32(esum[c] - e)
    assert not np.array_equal(_bits(got), _bits(back))
    old_eps, old_esum = apply_old(case)
    new_eps, new_esum = apply_new(case)
    assert np.array_equal(_bits(old_esum), _bits(new_esum))


def _one_sum(case):
    """The apply before it took its sums by block: acc over the round's
    moved entries in index order, then eps - (acc - dms_tot), dms_tot
    summed in j order (fold mode)."""
    words, d, eps, rv, dms, border, J, B = (
        case[k] for k in ("words", "d", "eps", "row_valid", "dms", "border",
                          "J", "B"))
    rows = round_rows(border, J, B)
    acc = np.zeros(eps.shape, F32)
    for e in np.flatnonzero((d != 0).any(0)):
        x = np.stack([code_f(words[rows[e]], k) for k in range(16)],
                     1).ravel()
        for c in range(d.shape[0]):
            acc[c] = _fma(d[c, e], x, acc[c])
    out = eps.copy()
    for c in range(eps.shape[0]):
        dt = dms[c, 0]
        for x in dms[c, 1:]:
            dt = F32(dt + x)
        out[c] = np.where(rv, (eps[c] - (acc[c] - dt).astype(F32)), eps[c])
    return out


@pytest.mark.parametrize("C,B", [(1, 512), (8, 128)])
def test_block_sums_at_one_block_are_the_one_sum(C, B):
    """At J = 1 (the serial sweeps) the block sums give the bits of the
    single sum, eps - (acc - dms[0])."""
    case = _case(C + B, C, 1, B, 0.7)
    assert np.array_equal(_bits(apply_new(case)[0]), _bits(_one_sum(case)))


def test_block_sums_hold_a_row_round_closer_to_float64():
    """A row round of J = 16 blocks of 256 every row moving, d of one sign
    and dms the blocks' mean terms (the fold mode's cancellation, as at
    the row horseshoe's first rounds): the block sums lie closer to the
    same apply in float64 than one f32 sum over the 4,096 updates."""
    rng = np.random.default_rng(16)
    J, B, Nw = 16, 256, 4
    case = _case(5, 1, J, B, 1.0, Nw=Nw)
    case["d"] = rng.uniform(0.5, 1.5, (1, J * B)).astype(F32)
    rows = round_rows(case["border"], J, B)
    mean = rng.uniform(0.5, 1.5, J * B).astype(F32)
    case["dms"] = (case["d"] * mean).reshape(1, J, B).sum(
        -1, dtype=np.float64).astype(F32)
    codes = np.stack([code_f(case["words"][rows], k) for k in range(16)],
                     -1).reshape(J * B, -1).astype(np.float64)
    exact = case["eps"][0] - (case["d"][0].astype(np.float64) @ codes
                              - case["dms"][0].astype(np.float64).sum())
    rv = case["row_valid"]
    blocks = np.abs(apply_new(case)[0][0] - exact)[rv].max()
    one = np.abs(_one_sum(case)[0] - exact)[rv].max()
    assert blocks < one / 2, (blocks, one)
