"""The serial kernel's windowed solve schedule, on the CPU.

csrc/serial.cu runs a block's B dependent BayesR steps as windows: the
lanes of one warp draw the next W steps at once on the current r, every
step up to and including the first that moves (d != 0) is committed, that
one rank-1 update is applied and the next window starts after it.  A step
that moves nothing leaves r as it was, so the committed draws are the
one-step loop's.  ``ops/block_sweep.windowed_inner_solve`` is that
schedule in plain torch, each draw made with the loop's own per-step ops.

- Against the port's one-step loop ``spike_slab_inner_solve`` it must be
  bitwise equal (``torch.equal`` on r, beta, labels, delta, v and bacc),
  for W in {1, 4, 32}, B in {8, 64, 200, 512}, K in {2, 3, 4, 8} and G in
  {1, 2}, with pad markers (valid = False), in three states: almost
  nothing moves (every marker in the spike, pi[0] = 0.999), about a tenth
  moves (a tenth in a slab), and a fresh init where every marker moves.
- Against JAX's ``bayesrrcpp_tpu/ops/block_sweep.py:spike_slab_inner_solve``
  on the same numpy inputs: labels and v exact; beta and delta to rtol
  2e-4 / atol 2e-6, r to rtol 2e-4 / atol 2e-5 and bacc to rtol 1e-4 /
  atol 1e-6 (tests/test_torch_serial.py's tolerances for beta, eps and
  bacc: the two frameworks round exp and the sums alike but not always to
  the last bit).
- ``dependent_windows`` (the count ``chip_smoke.py`` prints) against a
  one-window-at-a-time count on random move patterns (hypothesis), and
  against the windows the mirror itself takes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bayesrrcpp_tpu.ops import block_sweep as jbs
from bayesrrcpp_tpu_torch.ops import block_sweep as bs

NIND = 96            # individuals behind the block's Gram matrix
STATES = ("still", "tenth", "fresh")


def _case(seed, B, K, G, state):
    """One block's solve operands, all numpy f32 / int32 / bool: r = X eps
    and the Gram matrix of B standardized rows, the last B // 8 markers
    (at least one) pads; the state sets how many steps move."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, NIND)).astype(np.float32)
    x /= np.sqrt(NIND, dtype=np.float32)
    eps = rng.standard_normal(NIND).astype(np.float32)
    npad = max(1, B // 8)
    valid = np.arange(B) < B - npad
    x[~valid] = 0.0
    gram = (x @ x.T).astype(np.float32)
    xsq = np.diag(gram).copy()
    r = (x @ eps).astype(np.float32)
    cva = np.geomspace(1e-3, 1e-1, K - 1)[None].repeat(G, 0).astype(
        np.float32)
    labels = np.zeros(B, np.int32)
    beta = np.zeros(B, np.float32)
    if state == "fresh":
        pi = np.full((G, K), 1.0 / K, np.float32)
        labels = rng.integers(1, K, B).astype(np.int32)
        beta = (0.3 * rng.standard_normal(B)).astype(np.float32)
    else:
        pi = np.tile(np.r_[0.999, np.full(K - 1, 0.001 / (K - 1))],
                     (G, 1)).astype(np.float32)
        if state == "tenth":
            slab = rng.random(B) < 0.1
            labels[slab] = rng.integers(1, K, int(slab.sum()))
            beta[slab] = 0.05 * rng.standard_normal(int(slab.sum()))
    labels[~valid] = 0
    beta[~valid] = 0.0
    return dict(
        r=r, Gb=gram, beta_b=beta, labels_b=labels, xsq_b=xsq,
        gas_b=rng.integers(0, G, B).astype(np.int32), valid_b=valid,
        inner=rng.permutation(B).astype(np.int32),
        p_b=rng.random(B).astype(np.float32),
        z_b=rng.standard_normal(B).astype(np.float32), pi=pi, cva=cva,
        sigmaE=np.float32(0.8),
        sigmaGG=np.full(G, 0.05, np.float32) if state != "fresh"
        else np.full(G, 0.5, np.float32),
        v=np.zeros((G, K), np.float32), bacc=np.zeros(G, np.float32))


def _torch(case):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in case.items()}


def _one_window_at_a_time(moved, W):
    """Windows of a block by the schedule's definition, one at a time."""
    s0 = windows = 0
    B = len(moved)
    while s0 < B:
        windows += 1
        hit = [i for i in range(s0, min(s0 + W, B)) if moved[i]]
        s0 = hit[0] + 1 if hit else s0 + W
    return windows


# every W with every B, in each state; K and G cycle through their values
CASES = [(W, B, (2, 3, 4, 8)[(i + j) % 4], 1 + (i + j) % 2, state)
         for i, (W, B) in enumerate((W, B) for W in (1, 4, 32)
                                    for B in (8, 64, 200, 512))
         for j, state in enumerate(STATES)]


@pytest.mark.parametrize("W,B,K,G,state", CASES)
def test_window_is_the_one_step_loop_bitwise(W, B, K, G, state):
    case = _torch(_case(B * 31 + K * 7 + G, B, K, G, state))
    loop = bs.spike_slab_inner_solve(**case)
    win = bs.windowed_inner_solve(**case, W=W)
    for name, a, b in zip(("r", "beta", "labels", "delta", "v", "bacc"),
                          win, loop):
        assert torch.equal(a, b), name
    # the state moves as intended (pads never do)
    moved = loop[3][case["inner"].long()] != 0
    share = float(moved.float().mean())
    assert not bool(moved[~case["valid_b"][case["inner"].long()]].any())
    assert {"still": share < 0.05, "tenth": 0.02 < share < 0.3,
            "fresh": share > 0.8}[state], share
    assert bs.dependent_windows(moved, W) == _one_window_at_a_time(
        moved.tolist(), W)


@pytest.mark.parametrize("W,B,K,G,state", [(32, 64, 4, 2, "tenth"),
                                           (4, 200, 3, 1, "fresh"),
                                           (32, 200, 8, 2, "still"),
                                           (1, 64, 2, 1, "tenth")])
def test_window_matches_jax(W, B, K, G, state):
    case = _case(B * 13 + K, B, K, G, state)
    win = bs.windowed_inner_solve(**_torch(case), W=W)
    ref = [np.asarray(a) for a in jbs.spike_slab_inner_solve(
        **{k: jnp.asarray(v) for k, v in case.items()})]
    r, beta, labels, delta, v, bacc = (a.numpy() for a in win)
    np.testing.assert_array_equal(labels, ref[2])
    np.testing.assert_array_equal(v, ref[4])
    np.testing.assert_allclose(beta, ref[1], rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(delta, ref[3], rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(r, ref[0], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(bacc, ref[5], rtol=1e-4, atol=1e-6)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 40), st.integers(1, 70),
       st.lists(st.floats(0.0, 1.0), min_size=1, max_size=4),
       st.data())
def test_dependent_windows_count(W, B, shares, data):
    """Blocks of random move patterns: the vectorized count equals the
    one-at-a-time count, block by block and summed; no moves take
    ceil(B/W) windows, every step moving takes B."""
    blocks = [data.draw(st.lists(st.floats(0.0, 1.0), min_size=B,
                                 max_size=B))
              for _ in shares]
    moved = [[u < s for u in blk] for blk, s in zip(blocks, shares)]
    d = torch.tensor([[1.5 if m else 0.0 for m in row] for row in moved])
    want = [_one_window_at_a_time(row, W) for row in moved]
    assert bs.dependent_windows(d, W) == sum(want)
    for row, n in zip(d, want):
        assert bs.dependent_windows(row, W) == n
        assert int((row != 0).sum()) <= n <= B
    assert bs.dependent_windows(torch.zeros(B), W) == -(-B // W)
    assert bs.dependent_windows(torch.ones(B), W) == B
