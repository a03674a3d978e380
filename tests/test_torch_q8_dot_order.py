"""The int8 in-kernel decode's dot (csrc/serial.cu:serial_q8_dot_kernel,
the serial `_q` sweeps #9 / #10 on int8 codes with missing calls) against
the tile it replaced (int8_dot_tile's in-kernel decode: a CTA a split's
32 rows, each thread's 32 row sums added by warp_transpose_sum), in a plain
numpy float32 mirror of both: the same bits in every (split, row) partial.

Both schedules give a thread 16 columns of a row (16t .. 16t + 15 of the
split's 2,048 where N % 16 == 0, else t + 128 j: load_codes16), decode each
code c as the TPU's _decode_tile does, x = 0 for c == 3 else (c - mean) *
scale, and sum the row's 16 fmaf(x, eps, s) in column order from +0.  The
old tile then ran warp_transpose_sum over the 32 rows of its row group and
added warps 0..3 from 0; the new kernel takes 4 rows a CTA, stages each
row's 32 lane sums in shared memory and adds them in the same tree
(staged_tree: x[a] + x[a + 16], then + 8, + 4, + 2, + 1), then warps 0..3
from 0.  fmaf is mirrored in float64 (exact product) rounded to float32,
the same mirror for both, so the comparison is of the order of the
operations.
"""
import numpy as np
import pytest

from test_torch_fold_dot_order import staged_tree, warp_transpose_sum

F32 = np.float32
THREADS, COLS = 128, 16
TILE = THREADS * COLS       # columns of a split
WARPS = THREADS // 32
Q8_ROWS = 4                 # rows of a block a CTA (serial.cu:kQ8Rows)


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(F32)


def thread_columns(N):
    """(nsplit, 128, 16) column of each (split, thread, j), -1 past N."""
    nsplit = -(-N // TILE)
    sp = np.arange(nsplit)[:, None, None] * TILE
    t = np.arange(THREADS)[None, :, None]
    j = np.arange(COLS)[None, None, :]
    col = sp + (16 * t + j if N % 16 == 0 else t + THREADS * j)
    return np.where(col < N, col, -1)


def lane_sums(codes, mean, scale, eps, rows):
    """(rows, nsplit * 128) per-(row, thread) sums: each code decoded to
    x = 0 (code 3) or (c - mean) * scale in float32, the thread's 16
    products fmaf'd in column order from +0; a column past N reads code 0
    and eps 0, a row past the block code 0 with mean = scale = 0."""
    N = codes.shape[1]
    col = thread_columns(N).reshape(-1, COLS)       # (threads, 16)
    ok = col >= 0
    e = np.where(ok, eps[np.maximum(col, 0)], F32(0))
    out = np.zeros((rows, col.shape[0]), F32)
    for i in range(rows):
        if i < codes.shape[0]:
            c = np.where(ok, codes[i][np.maximum(col, 0)], 0).astype(F32)
            m, s = mean[i], scale[i]
        else:
            c = np.zeros(col.shape, F32)
            m, s = F32(0), F32(0)
        x = np.where(c == F32(3), F32(0), ((c - m).astype(F32) * s))
        acc = np.zeros(col.shape[0], F32)
        for j in range(COLS):
            acc = _fma(x[:, j].astype(F32), e[:, j], acc)
        out[i] = acc
    return out


def old_partials(codes, mean, scale, eps):
    """int8_dot_tile<V, true> and dense_dot_store: per 32-row group and
    split, warp_transpose_sum per warp, warps 0..3 from 0."""
    B = codes.shape[0]
    ngrp = -(-B // 32)
    nsplit = -(-codes.shape[1] // TILE)
    part = np.zeros((nsplit, B), F32)
    for g in range(ngrp):
        r0 = g * 32
        s = lane_sums(codes[r0:r0 + 32], mean[r0:r0 + 32],
                      scale[r0:r0 + 32], eps, 32)
        for sp in range(nsplit):
            t = np.zeros(32, F32)
            for q in range(WARPS):
                lo = sp * THREADS + 32 * q
                t = (t + warp_transpose_sum(s[:, lo:lo + 32].T)).astype(F32)
            n = min(32, B - r0)
            part[sp, r0:r0 + n] = t[:n]
    return part


def new_partials(codes, mean, scale, eps):
    """serial_q8_dot_kernel: per 4-row group and split, each row's 32 lane
    sums of a warp staged and added by staged_tree, warps 0..3 from 0."""
    B = codes.shape[0]
    nsplit = -(-codes.shape[1] // TILE)
    part = np.zeros((nsplit, B), F32)
    for r0 in range(0, B, Q8_ROWS):
        s = lane_sums(codes[r0:r0 + Q8_ROWS], mean[r0:r0 + Q8_ROWS],
                      scale[r0:r0 + Q8_ROWS], eps, Q8_ROWS)
        n = min(Q8_ROWS, B - r0)
        for sp in range(nsplit):
            t = np.zeros(n, F32)
            for q in range(WARPS):
                lo = sp * THREADS + 32 * q
                t = (t + staged_tree(s[:n, lo:lo + 32])).astype(F32)
            part[sp, r0:r0 + n] = t
    return part


def _case(seed, B, N):
    """Codes 0-2 with code 3 at ~3 % and in every column position of some
    row; per-row mean and scale as quantize_int8 makes them; eps of both
    signs with +-0 and large values."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 3, (B, N)).astype(np.int8)
    codes[rng.random((B, N)) < 0.03] = 3
    for i in range(min(B, 16)):
        codes[i, i::16] = 3          # every position j of a thread's 16
    codes[B - 1] = 3                 # a row with every call missing
    mean = rng.uniform(0.2, 1.8, B).astype(F32)
    scale = (1.0 / rng.uniform(0.3, 0.9, B)).astype(F32)
    eps = rng.standard_normal(N).astype(F32)
    pick = rng.random(N)
    eps[pick < 0.05] = F32(0.0)
    eps[(pick >= 0.05) & (pick < 0.1)] = F32(-0.0)
    eps[pick > 0.97] *= F32(1e4)
    return codes, mean, scale, eps


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("B", [32, 30, 512])
@pytest.mark.parametrize("N", [4096, 150])
def test_split_rows_give_the_old_partials_bitwise(B, N):
    """B=32 (the headline's), 30 (a last CTA of 2 rows) and 512 (16 row
    groups of the old tile, 128 CTAs of the new); N a multiple of 2,048 (16
    vector columns a thread, two splits) and N=150 (byte columns t + 128 j,
    one split mostly past N)."""
    codes, mean, scale, eps = _case(B + N, B, N)
    old = old_partials(codes, mean, scale, eps)
    new = new_partials(codes, mean, scale, eps)
    assert np.array_equal(_bits(old), _bits(new))
    assert np.isfinite(new).all()


def test_row_sums_read_no_other_row():
    """A row's partial is the same whatever the rows beside it: the last
    row of a block alone equals its partial among all the rows."""
    codes, mean, scale, eps = _case(3, 30, 4096)
    whole = new_partials(codes, mean, scale, eps)
    alone = new_partials(codes[-1:], mean[-1:], scale[-1:], eps)
    assert np.array_equal(_bits(whole[:, -1]), _bits(alone[:, 0]))
