"""The strided solve's pass schedule and staged partial sums, on the CPU.

csrc/jacobi_t_common.cuh:solve_block runs a block's B dependent BayesR
steps as passes: every lane draws its own marker's step at once on the
current r, the first position that moves (d != 0) is found, every step up
to it is committed, that one rank-1 update is applied and the next pass
starts after it.  A step that moves nothing leaves r as it was, so the
committed draws are the one-step loop's.  ``ops/block_sweep.
strided_pass_solve`` is that schedule in plain torch, with the arguments
and outputs of the one-step loop ``ops/jacobi_t.strided_steps`` that every
plain strided BayesR sweep runs.

- With the schedule in place of the loop, ``bayesr_jacobi_t_reference``
  (and the fused ``bayesr_jacobi_t_mc_reference``) must give bitwise the
  loop's sweep (``torch.equal`` on eps, beta, labels, v, bacc), for K in
  {2, 4, 8}, G in {1, 2}, B in {8, 30, 32} with invalid markers, at 0,
  ~3, ~50 and ~100 % moving steps, in the fold, ``miss``, dense and int8
  modes.
- The same swap against JAX's ``bayesr_jacobi_t_pallas`` (``_jacobi_t_kernel``
  in interpret mode) on three cases, at tests/test_torch_jacobi_t.py's
  tolerances (labels and v exact, floats to f32 reassociation).
- The solves' prologue (``staged_r``) sums the dot's partials in stages of
  ``kSolveStage`` rows copied to shared memory, the indicator partials'
  term after, and sum(eps) by lane then the warp: a numpy mirror of it is
  bitwise the parent's ``code_dot`` / ``fold_esum`` / ``marker_r`` order,
  one stage or several.
"""
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu_torch.convert import unpermute_eps
from bayesrrcpp_tpu_torch.ops import block_sweep as bs
from bayesrrcpp_tpu_torch.ops import genotypes
from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
from test_torch_jacobi_t import (_assert_sweeps_equal, _jax_pallas,
                                 _torch_args, _torch_kw)
from test_torch_jacobi_t import _case as _jax_case

NIND = 300        # individuals: pad lanes to 304 in the 2-bit modes
MODES = ("fold", "miss", "dense", "int8")
PI0 = {"none": 1.0, "few": 0.97, "half": 0.5, "all": 0.0}
SHARE = {"none": (0.0, 0.0), "few": (0.005, 0.1), "half": (0.3, 0.7),
         "all": (0.9, 1.0)}


def _sweep_case(seed, mode, J, B, K, G, nr, share, C=None):
    """A strided BayesR sweep's operands on the CPU in ``mode``, beta = 0
    and the spike's prior PI0[share], so about that share of the steps
    move; the last 3 markers invalid; ``C``: C chains' own variates."""
    rng = np.random.default_rng(seed)
    nb = J * nr
    M = nb * B
    dos = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(NIND, M))
    dos = dos.astype(float)
    if mode == "miss":
        dos[rng.random((NIND, M)) < 0.03] = np.nan
    t = torch.as_tensor
    if mode in ("fold", "miss"):
        words, mean, scale, Npad, _ = genotypes.pack_codes_host(
            dos, False, None, M, NIND)
        q = genotypes.quantize_packed(dos, False, None, B, M, NIND,
                                      prepacked=False, device="cpu")
        X, gram, xsq = t(words), q.gram, q.xsq
        kw = dict(x_mean=t(mean), x_scale=t(scale), x_xsum=q.x_colsum,
                  fold_affine=mode == "fold",
                  row_valid=torch.arange(Npad) < NIND)
        if mode == "miss":
            kw["missing"] = True
        lanes = Npad
    elif mode == "int8":
        q = genotypes.quantize_int8(dos.T, True, None, B, M, device="cpu")
        X, gram, xsq = q.codes, q.gram, q.xsq
        kw = dict(x_mean=q.x_mean, x_scale=q.x_scale, x_xsum=q.x_colsum,
                  fold_affine=True)
        lanes = NIND
    else:
        x = dos.T
        x = (x - x.mean(1, keepdims=True)) / x.std(1, ddof=1, keepdims=True)
        X = t(x, dtype=torch.float32)
        Xb = X.view(nb, B, NIND)
        gram, xsq = torch.bmm(Xb, Xb.transpose(1, 2)), (X * X).sum(1)
        kw = dict(x_mean=None)
        lanes = NIND
    lead = () if C is None else (C,)
    eps = np.zeros(lead + (lanes,), np.float32)
    eps[..., :NIND] = rng.standard_normal(lead + (NIND,))
    pi = np.full(lead + (G, K), (1.0 - PI0[share]) / (K - 1), np.float32)
    pi[..., 0] = PI0[share]
    f32 = lambda x: t(np.asarray(x, np.float32))               # noqa: E731
    args = (X, gram, xsq, f32(eps), f32(np.zeros(lead + (M,))),
            t(np.zeros(lead + (M,), np.int32)),
            t(rng.permutation(nr).astype(np.int32)),
            t(np.argsort(rng.random((nb, B)), axis=1).astype(np.int32)),
            f32(rng.random(lead + (M,))),
            f32(rng.standard_normal(lead + (M,))), f32(pi),
            f32(np.geomspace(1e-3, 1e-1, K - 1)[None].repeat(G, 0)),
            f32(0.8 if C is None else rng.uniform(0.5, 1.0, C)),
            f32(np.linspace(0.03, 0.08, G) if C is None
                else rng.uniform(0.03, 0.08, (C, G))),
            t((np.arange(M) % G).astype(np.int32)), t(np.arange(M) < M - 3))
    return args, dict(kw, J=J)


def _with_passes(monkeypatch, fn, args, kw):
    """``fn`` with the pass schedule in place of the one-step loop."""
    with monkeypatch.context() as mp:
        mp.setattr(jt, "strided_steps", bs.strided_pass_solve)
        return fn(*args, **kw)


# every mode with every B and move share; K and G cycle through theirs
CASES = [(mode, B, share, (2, 4, 8)[i % 3], 1 + (i // 3) % 2)
         for i, (mode, B, share) in enumerate(
             (m, b, s) for m in MODES for b in (8, 30, 32) for s in PI0)]


@pytest.mark.parametrize("mode,B,share,K,G", CASES)
def test_passes_are_the_one_step_loop_bitwise(monkeypatch, mode, B, share,
                                              K, G):
    args, kw = _sweep_case(B * 7 + K + G + len(share), mode, 4, B, K, G, 2,
                           share)
    calls = []
    with monkeypatch.context() as mp:
        mp.setattr(jt, "strided_steps",
                   lambda *a: calls.append(1) or bs.strided_pass_solve(*a))
        passes = jt.bayesr_jacobi_t_reference(*args, **kw)
    assert len(calls) == 2                       # one a round
    loop = jt.bayesr_jacobi_t_reference(*args, **kw)
    for name, a, b in zip(loop._fields, passes, loop):
        assert torch.equal(a, b), name
    moved = float((loop.beta != 0).float().mean())
    lo, hi = SHARE[share]
    assert lo <= moved <= hi, moved


@pytest.mark.parametrize("mode,share", [("fold", "few"), ("miss", "half"),
                                        ("int8", "all")])
def test_fused_passes_are_the_one_step_loop_bitwise(monkeypatch, mode,
                                                    share):
    """The fused plain sweep (a leading chain axis) with the schedule."""
    args, kw = _sweep_case(5 + len(mode), mode, 4, 32, 4, 2, 2, share, C=3)
    passes = _with_passes(monkeypatch, jt.bayesr_jacobi_t_mc_reference, args,
                          kw)
    loop = jt.bayesr_jacobi_t_mc_reference(*args, **kw)
    for name, a, b in zip(loop._fields, passes, loop):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("J,B,G,share", [(4, 16, 1, "few"),
                                         (16, 32, 1, "half"),
                                         (4, 32, 3, "all")])
def test_passes_match_jax_kernel(monkeypatch, J, B, G, share):
    """The sweep with the schedule against JAX's ``_jacobi_t_kernel`` in
    interpret mode (test_torch_jacobi_t.py's case: packed words of 1,500
    individuals, a warm state with a tenth of the markers in a slab),
    the spike's prior set to PI0[share]."""
    c = _jax_case(200 + J + G, J, B, G, nr=2)
    c["pi"] = np.full_like(c["pi"], (1.0 - PI0[share]) / 3)
    c["pi"][:, 0] = PI0[share]
    out = _with_passes(monkeypatch, jt.bayesr_jacobi_t_reference,
                       _torch_args(c), _torch_kw(c, J))
    ker = _jax_pallas(c, J)
    _assert_sweeps_equal(ker, out,
                         eps_ref=unpermute_eps(np.asarray(ker.eps), c["Npad"]),
                         eps_out=out.eps.numpy())


# ---------------------------------------------- the prologue's partial sums


def warp_sum(v):
    """csrc/jacobi_t_common.cuh:warp_sum on a warp's 32 f32 values: the
    xor butterfly, offsets 16 .. 1."""
    v = np.asarray(v, np.float32).copy()
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[lanes ^ off]).astype(np.float32)
    return v


def parent_r(partial, pind, mean, scale, j, B, fold):
    """r of block j's lanes in the parent's order: code_dot (q = 0, 1, ...
    in one register), the indicator dot after, fold_esum (q = lane mod 32,
    then the warp) and marker_r's fold."""
    nsplit = partial.shape[0]
    es = np.zeros(32, np.float32)
    for lane in range(32):
        for q in range(lane, nsplit, 32):
            es[lane] = np.float32(es[lane] + partial[q, -1])
    esum = warp_sum(es)
    r = np.zeros(B, np.float32)
    for lane in range(B):
        rc = np.float32(0)
        for q in range(nsplit):
            rc = np.float32(rc + partial[q, j * B + lane])
        if not fold:
            r[lane] = rc
            continue
        if pind is not None:
            ri = np.float32(0)
            for q in range(nsplit):
                ri = np.float32(ri + pind[q, j * B + lane])
            rc = np.float32(rc + np.float32(ri * np.float32(mean[lane] - 3)))
        ms = np.float32(mean[lane] * scale[lane])
        r[lane] = np.float32(np.float32(rc * scale[lane])
                             - np.float32(ms * esum[lane]))
    return r


def staged_r(partial, pind, mean, scale, j, B, fold, stage):
    """staged_r's schedule: stages of ``stage`` partial rows copied lane
    major into shared memory (pad lanes >= B copy zeros), each stage added
    to the running sums in q order, the stage's sum(eps) entries by lane q
    mod 32; then the warp sum and the fold."""
    nsplit = partial.shape[0]
    rc = np.zeros(32, np.float32)
    ri = np.zeros(32, np.float32)
    es = np.zeros(32, np.float32)
    lanes = np.arange(32)
    for q0 in range(0, nsplit, stage):
        n = min(stage, nsplit - q0)
        part = np.zeros((n, 32), np.float32)
        part[:, :B] = partial[q0:q0 + n, j * B:j * B + B]
        ind = np.zeros((n, 32), np.float32)
        if pind is not None:
            ind[:, :B] = pind[q0:q0 + n, j * B:j * B + B]
        col = partial[q0:q0 + n, -1]
        for q in range(n):
            rc = (rc + part[q]).astype(np.float32)
            if pind is not None:
                ri = (ri + ind[q]).astype(np.float32)
        if fold:
            for lane in lanes:
                for q in range(lane, n, 32):
                    es[lane] = np.float32(es[lane] + col[q])
    if not fold:
        return rc[:B]
    esum = warp_sum(es)
    mn, sc = np.zeros(32, np.float32), np.zeros(32, np.float32)
    mn[:B], sc[:B] = mean, scale
    if pind is not None:
        rc = (rc + (ri * (mn - np.float32(3))).astype(np.float32)).astype(
            np.float32)
    ms = (mn * sc).astype(np.float32)
    r = ((rc * sc).astype(np.float32) - (ms * esum).astype(np.float32))
    return r.astype(np.float32)[:B]


@pytest.mark.parametrize("nsplit,stage", [(49, 128), (49, 16), (130, 128),
                                          (300, 128), (7, 128)])
@pytest.mark.parametrize("B", [32, 30])
@pytest.mark.parametrize("kind", ["fold", "miss", "dense"])
def test_staged_partial_sums_are_the_parent_order(nsplit, stage, B, kind):
    rng = np.random.default_rng(nsplit + stage + B)
    J, j = 4, 2
    # partial sums of codes . eps over a split: large and of both signs,
    # so the order of the additions shows in the low bits
    partial = (rng.standard_normal((nsplit, J * B + 1)) * 37.0).astype(
        np.float32)
    pind = (rng.standard_normal((nsplit, J * B)).astype(np.float32)
            if kind == "miss" else None)
    mean = rng.uniform(0.2, 1.8, B).astype(np.float32)
    scale = rng.uniform(0.6, 2.5, B).astype(np.float32)
    fold = kind != "dense"
    want = parent_r(partial, pind, mean, scale, j, B, fold)
    got = staged_r(partial, pind, mean, scale, j, B, fold, stage)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the sums do depend on the order: a reversed one differs
    rev = parent_r(partial[::-1].copy(), None if pind is None
                   else pind[::-1].copy(), mean, scale, j, B, fold)
    assert not np.array_equal(rev, want)
