"""The parts of chip_smoke.py's gates and bounds that need no card, on the
CPU: the missing-call count that the ``miss`` mode's bounds use, and the
replay that holds a BayesR chain whose labels differ from the plain
version's (each first flip of a round must be a near tie).

Data: dosages with ~3 % missing calls made with numpy from a seed, N=1500
(pad lanes exist), M=1024, plan J=4, B=32 in the "t" layout; and the same
dosages without the missing calls on the row-layout plan J=4, B=32 (the
replay's rounds by ``row_rounds``).  On the CPU the sweep wrappers run
their plain versions, so kernel and plain version agree and a flip is put
on by hand: on a marker whose u lies far from every cumulative weight
(refused), and on one whose u is set to a weight (accepted).
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from bayesrrcpp_tpu_torch import BayesRConfig, SpikeSlabSampler, TorchVariates
from bayesrrcpp_tpu_torch.ops import jacobi
from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
from bayesrrcpp_tpu_torch.ops.genotypes import MISSING_CODE, decode_codes
from bayesrrcpp_tpu_torch.tools import kernel_bounds

N, M, ROUND = 1500, 1024, 2


def _sampler(layout):
    rng = np.random.default_rng(0)
    dos = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(
        float)
    missing = rng.random(dos.shape) < 0.03
    if layout == "t":
        dos[missing] = np.nan
    s = SpikeSlabSampler(dos, rng.normal(size=N), [1e-4, 1e-3, 1e-2],
                         BayesRConfig(block_size=32), x_dtype="2bit",
                         jacobi_blocks=4, jacobi_layout=layout, device="cpu")
    assert s.data.has_missing == (layout == "t")
    assert (s.jacobi, s.B, s.Npad, s.jacobi_layout) == (4, 32, 2048, layout)
    v = TorchVariates(torch.Generator().manual_seed(3))
    return s, v, s._run_steps(s.init(v), v, 3)


@pytest.fixture(scope="module")
def sweep():
    s, v, st = _sampler("t")
    args, kw = cs.sweep_args(s, st, v)
    return (s, args, kw, jt.bayesr_jacobi_t_reference(*args, **kw),
            jt.bayesr_jacobi_t_reference, cs.strided_rounds)


@pytest.fixture(scope="module")
def row_sweep():
    s, v, st = _sampler("row")
    args, kw = cs.serial_args(s, st, v)
    kw["J"] = s.jacobi
    return (s, args, kw, jacobi.bayesr_jacobi_reference(*args, **kw),
            jacobi.bayesr_jacobi_reference, cs.row_rounds)


def _flip(s, args, kw, labels, rounds):
    """(marker, labels with it changed, the u position of its draw): the
    first marker drawn in round ROUND's first block."""
    blk, at0 = rounds(torch, s, args, kw)[2](ROUND)[0]
    m = blk * s.B + int(args[7][blk][0])
    out = labels.clone()
    out[m] = (out[m] + 1) % 4
    return m, out, at0


def test_missing_calls_count_real_lanes_and_bound_their_fmas(sweep):
    s = sweep[0]
    miss = cs.missing_calls(torch, s, rows=100)
    codes = decode_codes(s.data.XT[:s.M])
    want = ((codes == MISSING_CODE) & s.data.row_valid.bool()).sum(dim=1)
    assert torch.equal(miss[:s.M], want) and int(miss[s.M:].sum()) == 0
    moved = torch.zeros(s.Mpad, dtype=torch.bool)
    moved[:5] = True
    assert (cs.missing_fmas(miss, torch.stack([moved, ~moved]))
            == 3 * int(miss.sum()))
    fold = kernel_bounds.sweep(s.Npad, s.Mpad, s.data.gram.numel(), 2, 6,
                               s.Mpad)
    miss_mode = kernel_bounds.sweep(s.Npad, s.Mpad, s.data.gram.numel(), 2,
                                    6, s.Mpad, 1000)
    assert miss_mode["bytes"] == fold["bytes"]
    assert miss_mode["flops"] - fold["flops"] == 2000


@pytest.mark.parametrize("layout", ["sweep", "row_sweep"])
def test_flip_replay_refuses_a_flip_that_is_no_near_tie(layout, request):
    s, args, kw, ref, plain, rounds = request.getfixturevalue(layout)
    m, labels, _ = _flip(s, args, kw, ref.labels, rounds)
    rp = cs.flip_replay(torch, s, args, kw, labels, ref.labels, ref.beta,
                        (plain, plain), rounds)
    assert rp["r0"] == ROUND and rp["labels_equal"] and rp["rel_eps"] == 0
    (tie,) = rp["near"]
    assert tie["marker"] == m and tie["margin"] > 100 * tie["reach"]
    with pytest.raises(RuntimeError, match="beyond f32 rounding"):
        cs.held_per_chain(torch, s, "[test]", args, kw,
                          (ref.eps, ref.beta, labels), ref,
                          sweeps=(plain, plain), rounds=rounds)


@pytest.mark.parametrize("layout", ["sweep", "row_sweep"])
def test_flip_replay_accepts_a_near_tie(layout, request):
    s, args, kw, ref, plain, rounds = request.getfixturevalue(layout)
    m, labels, pos = _flip(s, args, kw, ref.labels, rounds)
    weight = cs.flip_replay(torch, s, args, kw, labels, ref.labels,
                            ref.beta, (plain, plain), rounds
                            )["near"][0]["weight"]
    tied = list(args)
    tied[8] = args[8].clone()
    tied[8][pos] = weight                       # u on a cumulative weight
    tied = tuple(tied)
    ref2 = plain(*tied, **kw)
    _, labels2, _ = _flip(s, tied, kw, ref2.labels, rounds)
    (tie,) = cs.flip_replay(torch, s, tied, kw, labels2, ref2.labels,
                            ref2.beta, (plain, plain), rounds)["near"]
    assert tie["marker"] == m and tie["margin"] <= tie["reach"]
    flipped = cs.held_per_chain(torch, s, "[test]", tied, kw,
                                (ref2.eps, ref2.beta, labels2), ref2,
                                sweeps=(plain, plain), rounds=rounds)
    assert [c for c, _ in flipped] == [0]


def test_apply_round_bound_at_the_headline():
    """The fused horseshoe's apply of one headline round at C=8 (fold),
    worked out by hand: 4,096 rows of 100,352 lanes are 102.8 MB of words,
    8 chains' eps read and written 6.4 MB, together 32.6 us at 3.35 TB/s;
    8 x 4,096 x 100,352 FMAs are 6.58 GFLOP, 98.2 us at 67 TFLOP/s, so FP32
    bounds it.  The miss mode adds one FMA per chain and missing call."""
    fold = kernel_bounds.apply_round(100_352, 4096, 8)
    assert fold["bytes"] == 4096 * 100_352 // 4 + 8 * 100_352 * 8
    assert abs(fold["bytes"] / 3.35e12 * 1e6 - 32.6) < 0.05
    assert abs(fold["flops"] - 6.58e9) < 0.005e9
    assert fold["bound_by"] == "operations"
    assert abs(fold["bound_ms"] * 1e3 - 98.2) < 0.05
    miss = kernel_bounds.apply_round(100_352, 4096, 8, miss=10_000)
    assert miss["bytes"] == fold["bytes"]
    assert miss["flops"] - fold["flops"] == 2 * 8 * 10_000


@pytest.mark.parametrize("K,per_marker,tables,draw,want_bytes", [
    (4, 7, 6, 48, 1_531_076), (0, 5, 1, 6, 1_479_364)])
def test_strided_solve_round_bound_at_the_headline(K, per_marker, tables,
                                                   draw, want_bytes):
    """One strided solve launch of a headline round (J=128 blocks of B=32,
    49 partial rows), worked out by hand: per chain the round's 4,096 x 49
    partials and their 49 sum(eps) entries, BayesR's beta, labels (in and
    out), p, z and d*scale (7 floats a marker) and a block's d.(m*s), v
    and bacc (K + 2), the horseshoe's beta (in and out), z, lambda and
    d*scale (5) and d.(m*s); shared, the 128 Gram blocks (524,288 bytes)
    and xsq, mean, scale, the visit order, a valid byte (and BayesR's
    group); 1.5 MB, 0.46 us at 3.35 TB/s, far above the draws' FP32
    time.  The miss mode adds the indicator partials, and every chain its
    own share."""
    J, B, ns = 128, 32, 49
    one = kernel_bounds.strided_solve_round(J, B, ns, K, 1, False)
    per_chain = 4 * (J * B * ns + ns + J * B * per_marker + J * tables)
    shared = 4 * J * B * B + J * B * (17 + (4 if K else 0))
    assert one["bytes"] == per_chain + shared == want_bytes
    assert one["bound_by"] == "bytes"
    assert abs(one["bound_ms"] * 1e3 - want_bytes / 3.35e12 * 1e6) < 1e-9
    assert 0.44 < one["bound_ms"] * 1e3 < 0.46
    # BayesR: no mover by default; the horseshoe: every marker moves
    assert one["flops"] == J * (B * draw + (B * 2 * B if K == 0 else 0))
    miss8 = kernel_bounds.strided_solve_round(J, B, ns, K, 8, True,
                                              movers=3)
    assert miss8["bytes"] == 8 * (per_chain + 4 * J * B * ns) + shared
    assert miss8["flops"] == 8 * J * (B * draw + 3 * 2 * B)


@pytest.mark.parametrize("counts, windows", [
    ([246], 1),                 # complete at once
    ([180, 246], 2),            # a stretch of records lost, then complete
    ([180, 200, 210], 3),       # short in every window: the last is held
])
def test_profile_split_profiles_a_short_window_again(monkeypatch, counts,
                                                     windows):
    """A window whose records fall below 95 % of ``want`` is profiled again,
    at most three windows in all, and ``profiled`` holds the last one."""
    seen = []

    def once(torch, fn, names):
        c = counts[len(seen)]
        seen.append(c)
        return {n: (1.0, c) for n in names}, 1.0, 1.0

    monkeypatch.setattr(cs, "profile_once", once)
    monkeypatch.setattr(cs, "log", lambda msg: None)
    split, _, _ = cs.profile_split(torch, None, ("a", "b"), want=246)
    assert len(seen) == windows
    assert cs.profiled(split, 246) == (counts[-1] >= 0.95 * 246)
