"""The parts of chip_smoke.py's gates and bounds that need no card, on the
CPU: the missing-call count that the ``miss`` mode's bounds use, and the
replay that holds a BayesR chain whose labels differ from the plain
version's (each first flip of a round must be a near tie).

Data: dosages with ~3 % missing calls made with numpy from a seed, N=1500
(pad lanes exist), M=1024, plan J=4, B=32 in the "t" layout.  On the CPU
the sweep wrappers run their plain versions, so kernel and plain version
agree and a flip is put on by hand: on a marker whose u lies far from every
cumulative weight (refused), and on one whose u is set to a weight
(accepted).
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from bayesrrcpp_tpu_torch import BayesRConfig, SpikeSlabSampler, TorchVariates
from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
from bayesrrcpp_tpu_torch.ops.genotypes import MISSING_CODE, decode_codes
from bayesrrcpp_tpu_torch.tools import kernel_bounds

N, M, ROUND = 1500, 1024, 2


@pytest.fixture(scope="module")
def sweep():
    rng = np.random.default_rng(0)
    dos = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(
        float)
    dos[rng.random(dos.shape) < 0.03] = np.nan
    s = SpikeSlabSampler(dos, rng.normal(size=N), [1e-4, 1e-3, 1e-2],
                         BayesRConfig(block_size=32), x_dtype="2bit",
                         jacobi_blocks=4, jacobi_layout="t", device="cpu")
    assert s.data.has_missing and (s.jacobi, s.B, s.Npad) == (4, 32, 2048)
    v = TorchVariates(torch.Generator().manual_seed(3))
    st = s._run_steps(s.init(v), v, 3)
    args, kw = cs.sweep_args(s, st, v)
    return s, args, kw, jt.bayesr_jacobi_t_reference(*args, **kw)


def _flip(s, args, labels):
    """(marker, labels with it changed): the first marker drawn in round
    ROUND's first block, and the u position of its draw."""
    blk = int(args[6][ROUND])
    m = blk * s.B + int(args[7][blk][0])
    out = labels.clone()
    out[m] = (out[m] + 1) % 4
    return m, out, blk * s.jacobi * s.B


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


def test_flip_replay_refuses_a_flip_that_is_no_near_tie(sweep):
    s, args, kw, ref = sweep
    m, labels, _ = _flip(s, args, ref.labels)
    rp = cs.flip_replay(torch, s, args, kw, labels, ref.labels, ref.beta)
    assert rp["r0"] == ROUND and rp["labels_equal"] and rp["rel_eps"] == 0
    (tie,) = rp["near"]
    assert tie["marker"] == m and tie["margin"] > 100 * tie["reach"]
    with pytest.raises(RuntimeError, match="beyond f32 rounding"):
        cs.held_per_chain(torch, s, "[test]", args, kw,
                          (ref.eps, ref.beta, labels), ref)


def test_flip_replay_accepts_a_near_tie(sweep):
    s, args, kw, ref = sweep
    m, labels, pos = _flip(s, args, ref.labels)
    weight = cs.flip_replay(torch, s, args, kw, labels, ref.labels,
                            ref.beta)["near"][0]["weight"]
    tied = list(args)
    tied[8] = args[8].clone()
    tied[8][pos] = weight                       # u on a cumulative weight
    tied = tuple(tied)
    ref2 = jt.bayesr_jacobi_t_reference(*tied, **kw)
    _, labels2, _ = _flip(s, tied, ref2.labels)
    (tie,) = cs.flip_replay(torch, s, tied, kw, labels2, ref2.labels,
                            ref2.beta)["near"]
    assert tie["marker"] == m and tie["margin"] <= tie["reach"]
    flipped = cs.held_per_chain(torch, s, "[test]", tied, kw,
                                (ref2.eps, ref2.beta, labels2), ref2)
    assert [c for c, _ in flipped] == [0]
