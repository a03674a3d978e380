"""The least time an NVIDIA H100 could take for a sweep's work, computed
from its shapes alone (no card needed).  ``sweep`` is the one count of a
whole sweep's bytes and operations on 2-bit words, ``dense_sweep`` on
dense f32 rows, ``int8_sweep`` on int8 codes (the fold mode, or with
``decode`` the serial in-kernel decode), for any plan (strided, row layout
or serial: the Gram floats are the plan's), and ``round_solve`` the solve
launches alone: ``chip_smoke.py`` calls them with the shapes and data of
each sweep it runs, and this script with the headline constants for the
TPU kernels that the port has not run yet, as ``dense`` rows for the dense
cell (N=16,384 x M=49,152, J=128, B=32) and as ``int8`` rows for int8
codes at the headline, with no marker moving and with every marker moving
(the horseshoe):

    python3 bayesrrcpp_tpu_torch/tools/kernel_bounds.py

Each bound is the larger of the bytes the kernel must move (each input read
once, each output written once) over 3.35 TB/s and its FP32 operations over
67 TFLOP/s (NVIDIA H100 SXM data sheet, 700 W).  ``apply_round`` is one
apply launch of the strided 2-bit modes, ``row_apply_round`` one of the
dense and int8 row apply, ``dot_round`` one dot launch of any storage,
``strided_solve_round`` one strided solve launch.
The script's rows are one whole sweep of M=503,808 markers at N=100,352
on one card, plan J=128, B=32, K=4, G=1, with the least that depends on
the data: no marker moves.
Prints one JSON line per pallas_call site.
"""
import json

HBM_BYTES_PER_S, FP32_FLOPS = 3.35e12, 67e12
N, M, B, J, K = 100_352, 503_808, 32, 128, 4
NB = M // B
GRAM_FLOATS = NB * B * B


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def sweep(npad, mpad, gram_floats, chains, marker_arrays, moved=0,
          extra_fmas=0):
    """A whole sweep of ``chains`` chains over ``mpad`` markers of 2-bit
    words at ``npad`` lanes.  Bytes: the words, ``gram_floats`` Gram floats
    and the per-marker statistics (xsq, mean, scale, g_assign and a valid
    byte) read once, the lane mask, and per chain eps read and written and
    ``marker_arrays`` f32/int32 marker vectors.  FP32 FMAs (2 flops each):
    the dot's one per code and chain, the apply's one per lane of every
    row that moved (``moved``, summed over chains), and ``extra_fmas`` more
    (the missing-call mode's indicator terms, one per missing call that a
    dot or an apply touches)."""
    nbytes = (mpad * npad // 4 + 4 * gram_floats + 17 * mpad + npad
              + chains * (8 * npad + 4 * marker_arrays * mpad))
    return bound(nbytes, 2.0 * (npad * (chains * mpad + moved) + extra_fmas))


def dense_sweep(n, mpad, gram_floats, chains, marker_arrays, moved=0,
                moved_rows=0):
    """A whole sweep of ``chains`` chains over ``mpad`` dense f32 rows of
    ``n`` individuals.  Bytes: X read once by the dots (4 bytes a value), and
    again for each of the ``moved_rows`` rows that moved in any chain (a
    round's apply follows its dot and solve, and a round's rows, 4*J*B*n
    bytes, 268 MB at the dense cell, do not stay in the 50 MB L2), the Gram
    floats, xsq and a valid byte per marker, and per chain eps read and
    written and ``marker_arrays`` f32/int32 marker vectors.  FP32 FMAs (2
    flops each): the dot's one per value and chain, the apply's one per
    value of every row that moved (``moved``, summed over chains)."""
    nbytes = (4 * n * (mpad + moved_rows) + 4 * gram_floats + 5 * mpad
              + chains * (8 * n + 4 * marker_arrays * mpad))
    return bound(nbytes, 2.0 * n * (chains * mpad + moved))


def int8_sweep(n, mpad, gram_floats, chains, marker_arrays, moved=0,
               moved_rows=0, decode=False):
    """A whole sweep of ``chains`` chains over ``mpad`` markers of int8
    codes at ``n`` individuals (no pad lanes).  Bytes: the codes read once
    by the dots (1 byte a genotype) and again for each of the
    ``moved_rows`` rows that moved in any chain (a round's rows, J*B*n
    bytes, 411 MB at the headline, do not stay in the 50 MB L2), the Gram
    floats, the per-marker statistics (xsq, mean, scale, g_assign and a
    valid byte) and per chain eps read and written and ``marker_arrays``
    f32/int32 marker vectors.  FP32 operations: an FMA (2 flops) per code
    and chain in the dot and per code of every moved row and chain in the
    apply (``moved``, summed over chains); ``decode`` (the in-kernel decode,
    one chain) adds (c - mean)*scale, 2 flops, per code read."""
    nbytes = (n * (mpad + moved_rows) + 4 * gram_floats + 17 * mpad
              + chains * (8 * n + 4 * marker_arrays * mpad))
    flops = 2.0 * n * (chains * mpad + moved)
    if decode:
        flops += 2.0 * n * (mpad + moved_rows)
    return bound(nbytes, flops)


def apply_round(npad, rows, chains, miss=0, decode=False):
    """One apply launch of the 2-bit modes (fold, ``miss`` and the serial
    in-kernel decode): ``rows`` moved rows (in any chain) of ``npad``
    lanes.  Bytes: the moved rows' words read once (npad/4 bytes a row) and
    each chain's eps read and written once.  FP32 FMAs (2 flops each): one
    per lane of every moved row and chain, and in the ``miss`` mode one per
    chain for each of the ``miss`` missing calls in the moved rows (their
    indicator terms, as chip_smoke.py:missing_fmas counts them);
    ``decode`` (one chain) adds (c - mean)*scale, 2 flops, per code read."""
    nbytes = rows * npad // 4 + chains * 8 * npad
    flops = 2.0 * chains * (rows * npad + miss)
    if decode:
        flops += 2.0 * rows * npad
    return bound(nbytes, flops)


def dot_round(n, rows, chains, elem_bytes, extra_fmas=0, decode=False):
    """One dot launch: ``rows`` rows of ``n`` values (``elem_bytes`` bytes a
    value: 4 dense f32, 1 an int8 code, 0.25 a 2-bit code) read once and
    each chain's eps read once.  FP32 FMAs (2 flops each): one per value and
    chain, and ``extra_fmas`` more (the ``miss`` mode's indicator: one per
    missing call of the rows and chain); ``decode`` (the serial in-kernel
    decode, one chain) adds (c - mean)*scale, 2 flops, per value."""
    nbytes = int(rows * n * elem_bytes) + chains * 4 * n
    flops = 2.0 * (chains * rows * n + extra_fmas)
    if decode:
        flops += 2.0 * rows * n
    return bound(nbytes, flops)


def row_apply_round(n, rows, chains, elem_bytes):
    """One row apply launch (row_apply_kernel): ``rows`` moved rows (in any
    chain) of ``n`` values (``elem_bytes`` bytes a value: 4 dense f32, 1
    an int8 code) read once, each chain's eps read and written once.  FP32
    FMAs (2 flops each): one per value of every moved row and chain."""
    nbytes = int(rows * n * elem_bytes) + chains * 8 * n
    return bound(nbytes, 2.0 * chains * rows * n)


def round_solve(markers, b, table_fields, step_flops):
    """The solve alone (sites #13, #14) over ``markers`` markers in blocks
    of ``b`` (one round: J*B; a sweep's rounds: Mpad): the Gram blocks, r
    and a per-marker table of ``table_fields`` floats read, beta read and
    written, the deltas written; ``step_flops`` per marker (the draw, and
    the rank-1 update of the block's r, 2B)."""
    nbytes = 4 * markers * b + 4 * markers * (1 + table_fields + 2 + 1)
    return bound(nbytes, float(markers * step_flops))


def bayesr_round_solve(markers, b, k=K):
    """``round_solve`` of BayesR: the table [lp, invd, sd] x K, p, z, xsq,
    valid, labels read and written besides; per step 4K (mu, logL) + 2K^2
    (the guarded weights) + 2B flops."""
    return round_solve(markers, b, 3 * k + 4 + 2, 4 * k + 2 * k * k + 2 * b)


def horseshoe_round_solve(markers, b):
    """``round_solve`` of the horseshoe: [invd, sd, z, xsq, valid]; per
    step 4 + 2B flops."""
    return round_solve(markers, b, 5, 4 + 2 * b)


def strided_solve_round(J, B, nsplit, K, chains, miss, movers=None):
    """One strided solve launch (solve_kernel / hs_solve_kernel, fused:
    solve_mc_kernel / hs_solve_mc_kernel) over a round's J blocks of B
    markers for ``chains`` chains, K components (K = 0: the horseshoe).
    Bytes: per chain the dot's partials of the round's J*B markers
    (``nsplit`` floats each, the ``miss`` mode's indicator partials as many
    again) and its sum(eps) column, beta in and out, z, d*scale written and
    a block's d.(m*s) (BayesR: labels in and out, p, and the block's v and
    bacc partials at G=1; the horseshoe: lambda); the J
    Gram blocks and the per-marker xsq, mean, scale, visit order, a valid
    byte and (BayesR) the group, read once for all chains.  FP32 operations:
    each marker's draw once (BayesR: 4K + 2K^2, the horseshoe 6) and each
    mover's rank-1 update (2B), ``movers`` of them a block and chain
    (default: none for BayesR, every marker for the horseshoe)."""
    jb = J * B
    hs = K == 0
    if movers is None:
        movers = B if hs else 0
    per_chain = 4 * (jb * nsplit * (2 if miss else 1) + nsplit
                     + jb * (5 if hs else 7) + J * (1 if hs else K + 2))
    shared = 4 * J * B * B + jb * (4 * 3 + 4 + 1 + (0 if hs else 4))
    draw = 6 if hs else 4 * K + 2 * K * K
    flops = chains * J * (B * draw + movers * 2 * B)
    return bound(chains * per_chain + shared, float(flops))


SITES = [
    ("5", "pallas_jacobi_t.py:2229 bayesr_jacobi_t_rounds",
     sweep(N, M, GRAM_FLOATS, 1, 6)),
    ("6", "pallas_jacobi_t.py:2403 bayesr_jacobi_t_mc_rounds (C=8)",
     sweep(N, M, GRAM_FLOATS, 8, 6)),
    # the round solves at the headline row plan (J=32, B=128): one round,
    # and a sweep's 123 rounds
    ("13", "pallas_jacobi.py:704 bayesr_round_solve_pallas (a round)",
     bayesr_round_solve(32 * 128, 128)),
    ("13", "pallas_jacobi.py:704 bayesr_round_solve_pallas (a sweep)",
     bayesr_round_solve(M, 128)),
    ("14", "pallas_jacobi.py:833 horseshoe_round_solve_pallas (a round)",
     horseshoe_round_solve(32 * 128, 128)),
    ("14", "pallas_jacobi.py:833 horseshoe_round_solve_pallas (a sweep)",
     horseshoe_round_solve(M, 128)),
    # the strided solves of one headline round (49 partial rows), one
    # chain and 8 fused: BayesR with no mover, the horseshoe's all moving
    ("1", "pallas_jacobi_t.py:1032 bayesr_jacobi_t_pallas solve (a round)",
     strided_solve_round(J, B, 49, K, 1, False)),
    ("2", "pallas_jacobi_t.py:1151 horseshoe_jacobi_t_pallas solve "
     "(a round)", strided_solve_round(J, B, 49, 0, 1, False)),
    ("3", "pallas_jacobi_t.py:1635 bayesr_jacobi_t_pallas_mc solve "
     "(a round, C=8)", strided_solve_round(J, B, 49, K, 8, False)),
    ("4", "pallas_jacobi_t.py:2054 horseshoe_jacobi_t_pallas_mc solve "
     "(a round, C=8)", strided_solve_round(J, B, 49, 0, 8, False)),
    # the fused horseshoe's apply of one round at C=8 (fold): every row of
    # the round's J*B moves
    ("4", "pallas_jacobi_t.py:2054 horseshoe_jacobi_t_pallas_mc apply "
     "(a round, C=8)", apply_round(N, J * B, 8)),
]

# the dense cell dense-16kx49k (bench.py:375-376): the least a sweep could
# take with no marker moving (BayesR's floor) and with every one (the
# horseshoe's), one chain and 8 fused
DN, DM = 16_384, 49_152
DENSE = [
    (f"dense C={c} moved={moved}",
     dense_sweep(DN, DM, (DM // B) * B * B, c, 6 if moved == "none" else 4,
                 0 if moved == "none" else c * DM,
                 0 if moved == "none" else DM))
    for c in (1, 8) for moved in ("none", "all")]

# int8 codes at the headline (biobank-int8-*): the strided plan (J=128,
# B=32) with no marker moving and every one moving (the horseshoe), one
# chain and 8 fused, and the serial in-kernel decode (J=1, B=512) of one
# chain with no marker moving
INT8 = [
    (f"int8 C={c} moved={moved}",
     int8_sweep(N, M, GRAM_FLOATS, c, 6 if moved == "none" else 4,
                0 if moved == "none" else c * M,
                0 if moved == "none" else M))
    for c in (1, 8) for moved in ("none", "all")] + [
    ("int8_q C=1 moved=none J=1 B=512",
     int8_sweep(N, M, M * 512, 1, 6, decode=True))]

if __name__ == "__main__":
    for site, where, b in SITES:
        print(json.dumps({"site": site, "tpu_kernel": where, **b}))
    for what, b in DENSE:
        print(json.dumps({"dense": what, **b}))
    for what, b in INT8:
        print(json.dumps({"int8": what, **b}))
