"""Jacobi plan selection: how many blocks J sweep per round, and of what size.

The functions below are copied verbatim from
``bayesrrcpp_tpu/ops/pallas_jacobi.py:59-176``.  The plan fixes the Markov
kernel (which markers share a round), so the port must choose the same
(J, B, layout) as the reference for every M; tests/test_torch_bayesr.py
pins the two against each other.  The row-layout kernels of that file
(ROADMAP Queue 2 entries 9-10) are not ported yet.
"""
from __future__ import annotations


def auto_jacobi(M: int, B: int):
    """Default (J, B) for the Jacobi-batched sweep when the caller did not
    pick one (VERDICT round-2 ask: the fast path without magic kwargs).

    Constraints:
    - VMEM: the kernel's two (J*B, B) f32 scratches (P one-hot + Gp) must
      fit the ~16 MiB VMEM alongside the X tile / Gram block / pkg operands;
      budget J*B^2 <= 2^20 elements (8 MiB for the pair).
    - staleness: the cross-block Jacobi window is J*B markers per round;
      cap it at M/8 so small problems stay (near-)sequential.  J=1 is the
      exact sequential kernel.

    B may shrink to 128 when that buys a larger J -- the serial-step count
    is Mpad/J, so maximizing J at the smallest full-lane block wins
    (measured on v5e: J=16/B=256 at 165.9 ms beat J=4-feasible B=512 in
    round 2; the interleaved-Gp kernel makes J=64/B=128 feasible).
    """
    import numpy as _np

    def no_pad(J, Bc):
        # the sampler pads Mpad to B*8*J/gcd(8,J) units AT SCALE (the
        # nb % 8 codegen rule only kicks in at >= 64 blocks; below that
        # the unit is just B*J); when X is a near-HBM-sized packed array,
        # jnp.pad's transient second copy OOMs the chip -- prefer the
        # largest J that divides M exactly
        unit8 = Bc * 8 * J // _np.gcd(8, J)
        if M < 64 * Bc:
            unit8 = Bc * J
        return M % unit8 == 0

    best = (1, B, no_pad(1, B))
    for Bc in dict.fromkeys((B, min(B, 256), 128)):
        jmax_vmem = max(1, (1 << 20) // (Bc * Bc))
        J = 1
        while J * 2 <= jmax_vmem and (J * 2) * Bc * 8 <= M:
            J *= 2
        while J > 1 and not no_pad(J, Bc) and no_pad(J // 2, Bc):
            J //= 2
        cand = (J, Bc, no_pad(J, Bc))
        # rank: padding-free first, then largest J
        if (cand[2], cand[0]) > (best[2], best[0]):
            best = cand
    return best[0], best[1]


def auto_jacobi_plan(M: int, B: int):
    """Default (J, B, layout) for the Jacobi sweep; layout is "row"
    (ops/pallas_jacobi.py, J on sublanes) or "t" (ops/pallas_jacobi_t.py,
    J on lanes).

    The transposed kernel caps J at 128 (the lane width) but cuts the
    per-step dependent chain ~2x and the streamed Gram bytes B/32-fold, so
    it prefers MANY SMALL blocks: the window W = J*B stays at the proven
    4096-marker staleness cap (or M/8 for small problems) while J rides to
    128.  The row kernel remains for explicit jacobi_blocks choices and
    J > 128 experiments.

    Ranking mirrors auto_jacobi: padding-free first (jnp.pad's transient
    copy of a near-HBM packed X OOMs the chip), then largest J, then
    largest B.  Falls back to the row-layout auto_jacobi when no transposed
    candidate with J >= 8 exists (tiny M).
    """
    import numpy as _np

    def unit8(J, Bc):
        # the sampler pads Mpad to this unit at scale (nb % 8 == 0 for
        # XLA codegen size); below 64 blocks it pads to B*J only
        u = Bc * J
        if M >= 64 * Bc:
            u = Bc * 8 * J // _np.gcd(8, J)
        return u

    wmax = 1
    while wmax * 2 <= max(1, M // 8) and wmax * 2 <= 4096:
        wmax *= 2
    best = None
    w = wmax
    while w >= 256:
        # B >= 32: Mosaic rejects the kernel's chunked one-hot permute
        # broadcasts at B = 8/16 on real TPUs ((1, JC*B) -> (B, JC*B)
        # "Invalid input layout"), so small blocks trade lanes (smaller
        # J) rather than sublanes
        J = min(128, w // 32)
        Bc = w // J
        cand = (M % unit8(J, Bc) == 0, J, Bc)
        if best is None or cand > best:
            best = cand
        w //= 2
    if best is not None and best[1] >= 8:
        if not best[0]:
            # no padding-free window: take the largest (padding was
            # already unavoidable; dense/host paths pad cheaply)
            J = min(128, wmax // 32)
            return J, wmax // J, "t"
        return best[1], best[2], "t"
    J, Bc = auto_jacobi(M, B)
    return J, Bc, "row"


def planned_mpad(M: int, block_size: int = 512) -> int:
    """The padded marker count the default (auto-plan) sampler will use
    for M markers -- so HOST loaders can pre-pad packed words and skip the
    on-device pad entirely (a near-HBM-sized device array cannot be
    padded in place: input + output both live during the copy, and at
    biobank scale that OOMs the chip -- see io.bed.read_bed_packed's
    ``mpad``).  Mirrors the samplers' blocking logic;
    tests/test_jacobi_t.py pins the two against each other."""
    import numpy as _np

    B = min(block_size, 1 << max(1, (M - 1).bit_length()))
    B = max(8, min(B, block_size))
    J, B, _layout = auto_jacobi_plan(M, B)
    unit = B * J
    Mpad = -(-M // unit) * unit
    if Mpad // B >= 64:
        unit8 = B * 8 * J // _np.gcd(8, J)
        Mpad = -(-M // unit8) * unit8
    return Mpad
