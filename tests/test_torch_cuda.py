"""The CUDA kernels of bayesrrcpp_tpu_torch/csrc/jacobi_t.cu (the BayesR and
horseshoe sweeps), csrc/jacobi_t_mc.cu (their fused multi-chain sweeps),
csrc/serial.cu (the serial J=1 sweeps, one chain and fused, the row-layout
sweeps at J > 1 and their round solves) against their
plain torch versions, on the card; and each fused
chain against the single-chain kernel on that chain's operands, bitwise
(the same arithmetic in the same order).

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip where
``torch.cuda.is_available()`` is false.  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

They cover what chip_smoke.py's shapes do not: blocks narrower than a warp
(B=16), several groups (G=3), K=2, and individuals that do not fill the
last word tile (pad lanes), each also on words with ~3 % missing calls
(the strided kernels' ``miss`` mode, the serial kernel's in-kernel decode),
and the dense mode of every kernel on f32 rows of an N that is or is not a
multiple of 4; the chunked forms of the strided BayesR sweeps (sites
#5 and #6); and the int8 modes of every sweep (families A-D: the strided
kernels one chain and fused, the serial and row sweeps' fold mode, the
serial in-kernel decode) on int8 codes at N=4096 and N=4001; and the
strided solves at 0 to ~100 % moving steps and with more partial rows a
block than one stage holds; and the grouped sampler's sweeps (G=4, F=3)
on each of its paths, the sweep a step passes them held against its
plain version, bacc per group to a relative 1e-5.
Tolerances: labels and v exact, floats to f32 reassociation (the kernel
sums the dot in another order).
"""
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu_torch.ops import genotypes
from bayesrrcpp_tpu_torch.ops.jacobi_t import (
    bayesr_jacobi_t, bayesr_jacobi_t_mc, bayesr_jacobi_t_mc_reference,
    bayesr_jacobi_t_mc_rounds, bayesr_jacobi_t_mc_rounds_reference,
    bayesr_jacobi_t_reference, bayesr_jacobi_t_rounds,
    bayesr_jacobi_t_rounds_reference, horseshoe_jacobi_t,
    horseshoe_jacobi_t_mc, horseshoe_jacobi_t_mc_reference,
    horseshoe_jacobi_t_reference)
# tests/ is on sys.path (pytest's prepend import mode); `tests.` may
# name another package where the card is
from torch_row_f64 import ROW_HS_F64_ATOL, row_hs_f64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _case(seed, J, B, G, K, nr, N, dev, missing=False):
    """A strided sweep's operands; ``missing``: ~3 % of the calls missing,
    swept in the kernel's miss mode."""
    rng = np.random.default_rng(seed)
    nb = J * nr
    M = nb * B
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M))
    if missing:
        dosage = np.where(rng.random((N, M)) < 0.03, np.nan, dosage)
    words, mean, scale, Npad, has_missing = genotypes.pack_codes_host(
        dosage.astype(float), False, None, M, N)
    assert has_missing == missing
    t = lambda x, dt=None: torch.as_tensor(x, dtype=dt, device=dev)  # noqa
    row_valid = torch.arange(Npad, device=dev) < N
    q = genotypes.quantize_packed(dosage.astype(float), False, None, B, M,
                                  N, prepacked=False, device=dev)
    eps = torch.zeros(Npad, device=dev)
    eps[:N] = t(rng.standard_normal(N), torch.float32)
    beta = np.zeros(M, np.float32)
    labels = np.zeros(M, np.int32)
    hot = rng.choice(M, M // 8, replace=False)
    labels[hot] = rng.integers(1, K, hot.size)
    beta[hot] = rng.normal(0, 0.05, hot.size)
    cva = np.tile(np.geomspace(1e-3, 1e-1, K - 1), (G, 1))
    args = (t(words), q.gram, q.xsq, eps, t(beta), t(labels),
            t(rng.permutation(nr), torch.int32),
            t(np.argsort(rng.random((nb, B)), axis=1), torch.int32),
            t(rng.random(M), torch.float32),
            t(rng.standard_normal(M), torch.float32),
            t(rng.dirichlet(np.arange(K, 0, -1.0), G), torch.float32),
            t(cva, torch.float32), t(0.8, torch.float32),
            t(np.linspace(0.03, 0.08, G), torch.float32),
            t(np.arange(M) % G, torch.int32), t(np.arange(M) < M - 5))
    kw = dict(J=J, x_mean=t(mean), x_scale=t(scale), x_xsum=q.x_colsum,
              fold_affine=not missing, row_valid=row_valid)
    if missing:
        kw["missing"] = True
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("J,B,G,K,N", [(4, 16, 3, 4, 1500),
                                       (8, 32, 1, 2, 3000),
                                       (32, 32, 1, 4, 4096)])
def test_kernel_matches_plain(cuda, J, B, G, K, N):
    args, kw = _case(J + B + G, J, B, G, K, 4, N, cuda)
    before = bayesr_jacobi_t.launches
    ker = bayesr_jacobi_t(*args, **kw)
    ref = bayesr_jacobi_t_reference(*args, **kw)
    torch.cuda.synchronize()
    assert bayesr_jacobi_t.launches == before + 3 * 4
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.eps, ref.eps, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.beta_acum, ref.beta_acum, rtol=1e-4,
                               atol=1e-6)
    assert (ker.eps[N:] == 0).all()
    # fixed-order reductions: a second launch is bitwise identical
    again = bayesr_jacobi_t(*args, **kw)
    for a, b in zip(ker, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_rejects_tensors_on_other_devices(cuda):
    args, kw = _case(1, 4, 16, 1, 4, 2, 500, cuda)
    args = list(args)
    args[8] = args[8].cpu()
    with pytest.raises(ValueError, match="p is on cpu"):
        bayesr_jacobi_t(*args, **kw)


def _hs_case(seed, J, B, nr, N, dev, tau=0.05, missing=False):
    """The horseshoe sweep's operands: _case's data and state with lambda,
    tau and c2 in place of the mixture's."""
    args, kw = _case(seed, J, B, 1, 4, nr, N, dev, missing)
    rng = np.random.default_rng(seed + 1000)
    M = args[1].shape[0] * B
    lam = torch.as_tensor(rng.uniform(0.1, 2.0, M), dtype=torch.float32,
                          device=dev)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa
    # words, gram, xsq, eps, beta, rho, inner, z, lam, tau, c2, sigmaE, valid
    return (args[:5] + args[6:8] + (args[9], lam, t(tau), t(1.5), args[12],
                                    args[15])), kw


@pytest.mark.cuda
@pytest.mark.parametrize("C", [None, 3, 17])
@pytest.mark.parametrize("missing", [False, True])
def test_rounds_kernels_match_plain(cuda, missing, C):
    """Sites #5 and #6: chunks of 1 and 3 of a sweep's 6 rounds against
    their plain versions (labels and v exact, floats to f32
    reassociation); the chunk of every round bitwise equal to the
    whole-sweep kernel; chunks run in turn bitwise equal to it in eps,
    beta and labels; C=17 runs as groups of 16 and 1."""
    J, B, nr = 4, 16, 6
    if C is None:
        args, kw = _case(5 + missing, J, B, 2, 4, nr, 1500, cuda, missing)
        fns = (bayesr_jacobi_t_rounds, bayesr_jacobi_t_rounds_reference,
               bayesr_jacobi_t)
    else:
        args, kw = _mc_case(5 + C, J, B, 2, 4, nr, 1500, C, cuda, missing)
        fns = (bayesr_jacobi_t_mc_rounds, bayesr_jacobi_t_mc_rounds_reference,
               bayesr_jacobi_t_mc)
    rounds, plain, whole = fns
    rkw = dict(kw, nr_total=nr)
    for nrc in (1, 3):
        a = list(args)
        a[6] = args[6][:nrc]
        before = rounds.launches
        ker, ref = rounds(*a, **rkw), plain(*a, **rkw)
        torch.cuda.synchronize()
        assert rounds.launches == before + 3 * nrc * -(-(C or 1) // 16)
        assert torch.equal(ker.labels, ref.labels)
        assert torch.equal(ker.v, ref.v)
        torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(ker.eps, ref.eps, rtol=1e-4, atol=1e-5)
    full = whole(*args, **kw)
    for a, b in zip(rounds(*args, **rkw), full):
        assert torch.equal(a, b)
    a = list(args)
    v = 0
    for c0 in range(0, nr, 4):
        a[6] = args[6][c0:c0 + 4]
        res = rounds(*a, **rkw)
        a[3], a[4], a[5] = res.eps, res.beta, res.labels
        v = v + res.v
    for name in ("eps", "beta", "labels"):
        assert torch.equal(getattr(res, name), getattr(full, name)), name
    assert torch.equal(v, full.v)


@pytest.mark.cuda
@pytest.mark.parametrize("J,B,N,tau", [(4, 16, 1500, 0.05),
                                       (32, 32, 4096, 0.05),
                                       (8, 32, 3000, 1e-30)])
def test_horseshoe_kernel_matches_plain(cuda, J, B, N, tau):
    args, kw = _hs_case(J + B, J, B, 4, N, cuda, tau)
    before = horseshoe_jacobi_t.launches
    eps_k, beta_k = horseshoe_jacobi_t(*args, **kw)
    eps_r, beta_r = horseshoe_jacobi_t_reference(*args, **kw)
    torch.cuda.synchronize()
    assert horseshoe_jacobi_t.launches == before + 3 * 4
    torch.testing.assert_close(beta_k, beta_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(eps_k, eps_r, rtol=1e-4, atol=1e-5)
    assert (eps_k[N:] == 0).all()
    # fixed-order reductions: a second launch is bitwise identical
    eps_2, beta_2 = horseshoe_jacobi_t(*args, **kw)
    assert torch.equal(eps_k, eps_2) and torch.equal(beta_k, beta_2)


def _mc_case(seed, J, B, G, K, nr, N, C, dev, missing=False):
    """_case's words, Gram blocks and orders with C chains' own warm states
    and variates, in the fused sweep's argument order."""
    args, kw = _case(seed, J, B, G, K, nr, N, dev, missing)
    words, gram, xsq, rho, inner, cva, gas, valid = (
        args[0], args[1], args[2], args[6], args[7], args[11], args[14],
        args[15])
    rng = np.random.default_rng(seed + 2000)
    M, Npad = xsq.shape[0], kw["row_valid"].shape[0]
    t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt,  # noqa
                                                    device=dev)
    eps = np.zeros((C, Npad))
    eps[:, :N] = rng.standard_normal((C, N))
    beta = np.zeros((C, M))
    labels = np.zeros((C, M), np.int32)
    for c in range(C):
        hot = rng.choice(M, M // 8, replace=False)
        labels[c, hot] = rng.integers(1, K, hot.size)
        beta[c, hot] = rng.normal(0, 0.05, hot.size)
    mc = (words, gram, xsq, t(eps), t(beta), t(labels, torch.int32), rho,
          inner, t(rng.random((C, M))), t(rng.standard_normal((C, M))),
          t(rng.dirichlet(np.arange(K, 0, -1.0), (C, G))), cva,
          t(rng.uniform(0.5, 1.0, C)), t(rng.uniform(0.03, 0.08, (C, G))),
          gas, valid)
    return mc, kw


def _chain(args, c, per_chain):
    return tuple(a[c] if k in per_chain else a for k, a in enumerate(args))


@pytest.mark.cuda
@pytest.mark.parametrize("C,J,B,G,K,N", [(3, 4, 16, 3, 4, 1500),
                                         (8, 32, 32, 1, 4, 4096),
                                         (17, 8, 32, 1, 2, 3000)])
def test_mc_kernel_matches_plain_and_single_chains(cuda, C, J, B, G, K, N):
    """The fused BayesR sweep against its plain version (labels and v
    exact, floats to f32 reassociation), and each chain bitwise against
    the single-chain kernel; C=17 runs as groups of 16 and 1."""
    args, kw = _mc_case(C + J + G, J, B, G, K, 4, N, C, cuda)
    before = bayesr_jacobi_t_mc.launches
    ker = bayesr_jacobi_t_mc(*args, **kw)
    ref = bayesr_jacobi_t_mc_reference(*args, **kw)
    torch.cuda.synchronize()
    assert bayesr_jacobi_t_mc.launches == before + 3 * 4 * -(-C // 16)
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.eps, ref.eps, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.beta_acum, ref.beta_acum, rtol=1e-4,
                               atol=1e-6)
    assert (ker.eps[:, N:] == 0).all()
    for c in range(C):
        one = bayesr_jacobi_t(*_chain(args, c, (3, 4, 5, 8, 9, 10, 12, 13)),
                              **kw)
        for name, a, b in zip(one._fields, one, ker):
            assert torch.equal(a, b[c]), (c, name)


@pytest.mark.cuda
@pytest.mark.parametrize("C,J,B,N", [(3, 4, 16, 1500), (8, 32, 32, 4096),
                                     (17, 8, 32, 3000)])
def test_hs_mc_kernel_matches_plain_and_single_chains(cuda, C, J, B, N):
    args, kw = _mc_case(C + J, J, B, 1, 4, 4, N, C, cuda)
    rng = np.random.default_rng(C)
    M = args[2].shape[0]
    t = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device=cuda)
    tau = rng.uniform(0.01, 0.1, C)
    tau[-1] = 1e-30                       # invd and sd near 0
    # words, gram, xsq, eps, beta, rho, inner, z, lam, tau, c2, sigmaE, valid
    hs = (args[:5] + args[6:8] + (args[9], t(rng.uniform(0.1, 2.0, (C, M))),
                                  t(tau), t(rng.uniform(1.0, 2.0, C)),
                                  args[12], args[15]))
    before = horseshoe_jacobi_t_mc.launches
    eps_k, beta_k = horseshoe_jacobi_t_mc(*hs, **kw)
    eps_r, beta_r = horseshoe_jacobi_t_mc_reference(*hs, **kw)
    torch.cuda.synchronize()
    assert horseshoe_jacobi_t_mc.launches == before + 3 * 4 * -(-C // 16)
    torch.testing.assert_close(beta_k, beta_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(eps_k, eps_r, rtol=1e-4, atol=1e-5)
    for c in range(C):
        e1, b1 = horseshoe_jacobi_t(*_chain(hs, c, (3, 4, 7, 8, 9, 10, 11)),
                                    **kw)
        assert torch.equal(e1, eps_k[c]) and torch.equal(b1, beta_k[c]), c


# ------------------------------------------------ the serial (J=1) sweeps


def _assert_eps_close(a, b):
    """eps of a serial sweep against its plain version: a lane sums one
    update per moved row of every block (every row, for the horseshoe) in
    another order than the plain matrix product, so its rounding grows with
    those sums, not with the lane's value: |d eps| / |eps| < 1e-4 and
    max |d eps| < 1e-4 max |eps| (chip_smoke.py phases 10-11)."""
    rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    assert rel < 1e-4, rel
    assert float((a - b).abs().max()) < 1e-4 * float(b.abs().max())


def _serial_case(seed, B, G, K, nb, N, dev, chunk, missing=False):
    """_case's data, state and variates as a serial sweep's operands: the
    block order is a permutation of the nb blocks (J=1), p/z by position;
    ``missing``: the in-kernel decode (fold_affine=False)."""
    args, kw = _case(seed, 1, B, G, K, nb, N, dev, missing)
    del kw["J"]
    kw.pop("missing", None)
    return args, dict(kw, max_call_blocks=chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,K,nb,N,chunk", [(64, 2, 4, 8, 1500, 3),
                                              (512, 1, 4, 4, 4096, None),
                                              (200, 1, 3, 5, 3000, 2),
                                              (1024, 1, 8, 2, 2048, None),
                                              (8, 1, 2, 6, 2048, None),
                                              (150, 1, 3, 3, 2048, None),
                                              (30, 1, 4, 5, 1500, 2)])
def test_serial_kernel_matches_plain(cuda, B, G, K, nb, N, chunk):
    """Blocks of every width the plans produce, powers of two or not, up to
    the kernel's 1024, across chunk boundaries (B=150: B % 4 != 0, the
    Gram ring filled by plain loads; B=30: a dot CTA's rows past the
    block); the apply's last CTA covers a partial segment of the words
    (Nw = 128 or 256 words, 48 a CTA)."""
    from bayesrrcpp_tpu_torch.ops import serial

    args, kw = _serial_case(B + K, B, G, K, nb, N, cuda, chunk)
    before = serial.bayesr_sweep.launches
    ker = serial.bayesr_sweep(*args, **kw)
    ref = serial.bayesr_sweep_reference(*args, **kw)
    torch.cuda.synchronize()
    assert serial.bayesr_sweep.launches == before + 3 * nb
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    _assert_eps_close(ker.eps, ref.eps)
    torch.testing.assert_close(ker.beta_acum, ref.beta_acum, rtol=1e-4,
                               atol=1e-6)
    assert (ker.eps[N:] == 0).all()
    again = serial.bayesr_sweep(*args, **kw)
    for a, b in zip(ker, again):
        assert torch.equal(a, b)


def _serial_hs(args, lam, tau):
    t = lambda x: torch.tensor(x, dtype=torch.float32,  # noqa: E731
                               device=args[0].device)
    # words, gram, xsq, eps, beta, border, inner, z, lam, tau, c2, sigmaE,
    # valid
    return args[:5] + args[6:8] + (args[9], lam, t(tau), t(1.5), args[12],
                                   args[15])


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,nb", [(512, 4, 4), (1024, 8, 2), (200, 3, 5)])
def test_serial_kernel_long_windows_match_plain(cuda, B, K, nb):
    """Few movers (1 % of the markers in a slab, pi[0] = 0.999): the
    windowed solve's windows run long over still steps, and the Gram ring's
    stages are let go far behind the movers."""
    from bayesrrcpp_tpu_torch.ops import serial

    args, kw = _serial_case(B + 7 * K, B, 1, K, nb, 2048, cuda, None)
    args = list(args)
    M = nb * B
    rng = np.random.default_rng(B)
    hot = torch.as_tensor(rng.choice(M, M // 100, replace=False),
                          device=cuda)
    args[4] = torch.zeros(M, device=cuda).index_fill_(0, hot, 0.05)
    args[5] = torch.zeros(M, dtype=torch.int32,
                          device=cuda).index_fill_(0, hot, 1)
    args[10] = torch.full((1, K), 0.001 / (K - 1), device=cuda)
    args[10][:, 0] = 0.999
    ker = serial.bayesr_sweep(*args, **kw)
    ref = serial.bayesr_sweep_reference(*args, **kw)
    torch.cuda.synchronize()
    assert float((ker.beta != args[4]).float().mean()) < 0.05
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    _assert_eps_close(ker.eps, ref.eps)


@pytest.mark.cuda
@pytest.mark.parametrize("B,nb,N,tau,chunk", [(64, 8, 1500, 0.05, 3),
                                              (512, 4, 4096, 0.05, None),
                                              (96, 4, 3000, 1e-30, None),
                                              (150, 3, 2048, 0.05, None)])
def test_serial_horseshoe_kernel_matches_plain(cuda, B, nb, N, tau, chunk):
    from bayesrrcpp_tpu_torch.ops import serial

    args, kw = _serial_case(B + nb, B, 1, 4, nb, N, cuda, chunk)
    lam = torch.rand(nb * B, device=cuda) * 1.9 + 0.1
    hs = _serial_hs(args, lam, tau)
    before = serial.horseshoe_sweep.launches
    eps_k, beta_k = serial.horseshoe_sweep(*hs, **kw)
    eps_r, beta_r = serial.horseshoe_sweep_reference(*hs, **kw)
    torch.cuda.synchronize()
    assert serial.horseshoe_sweep.launches == before + 3 * nb
    torch.testing.assert_close(beta_k, beta_r, rtol=1e-4, atol=1e-5)
    _assert_eps_close(eps_k, eps_r)
    assert (eps_k[N:] == 0).all()


def _serial_mc_case(seed, B, K, nb, N, C, dev, chunk):
    """_mc_case's C chains on a serial plan: marker-indexed p/z (C, M)."""
    args, kw = _mc_case(seed, 1, B, 1, K, nb, N, C, dev)
    del kw["J"]
    return args, dict(kw, max_call_blocks=chunk)


def _position_order(args, c, B):
    """Chain c's fused operands as a single-chain serial sweep's: p/z
    moved from marker to sweep-position order."""
    from bayesrrcpp_tpu_torch.ops.serial import position_markers

    at = position_markers(args[6], args[7], B)
    one = list(_chain(args, c, (3, 4, 5, 8, 9, 10, 12, 13)))
    one[8], one[9] = one[8][at], one[9][at]
    return one


@pytest.mark.cuda
@pytest.mark.parametrize("C,B,K,nb,N,chunk", [(3, 64, 4, 8, 1500, 3),
                                              (8, 512, 4, 4, 4096, None),
                                              (17, 96, 2, 4, 3000, None),
                                              (16, 1024, 4, 2, 4096, None)])
def test_serial_mc_kernel_matches_plain_and_single_chains(cuda, C, B, K, nb,
                                                          N, chunk):
    """The fused serial BayesR sweep against its plain version, and each
    chain bitwise against the single-chain serial kernel given its p/z in
    position order; C=17 runs as groups of 16 and 1; (B, C) = (1024, 16)
    is the apply's largest list (16 chains' d of 1,024 entries in shared
    memory) and the dot's two passes of 8 chains."""
    from bayesrrcpp_tpu_torch.ops import multichain, serial

    args, kw = _serial_mc_case(C + B, B, K, nb, N, C, cuda, chunk)
    before = multichain.bayesr_sweep_mc.launches
    ker = multichain.bayesr_sweep_mc(*args, **kw)
    ref = multichain.bayesr_sweep_mc_reference(*args, **kw)
    torch.cuda.synchronize()
    assert multichain.bayesr_sweep_mc.launches == before + 3 * nb * -(-C // 16)
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    _assert_eps_close(ker.eps, ref.eps)
    for c in range(C):
        one = serial.bayesr_sweep(*_position_order(args, c, B), **kw)
        for name, a, b in zip(one._fields, one, ker):
            assert torch.equal(a, b[c]), (c, name)


@pytest.mark.cuda
@pytest.mark.parametrize("C,B,nb,N", [(3, 64, 8, 1500), (8, 512, 4, 4096),
                                      (16, 1024, 2, 6144)])
def test_serial_hs_mc_kernel_matches_plain_and_single_chains(cuda, C, B, nb,
                                                             N):
    """The fused serial horseshoe sweep (every valid row moves) against its
    plain version and each chain bitwise against the single-chain kernel;
    at (B, C) = (1024, 16) the apply streams 32 stages of 32 rows through
    its ring of 8, over whole segments of the words (Nw = 384 = 8 x 48)."""
    from bayesrrcpp_tpu_torch.ops import multichain, serial

    args, kw = _serial_mc_case(C + B, B, 4, nb, N, C, cuda, 3)
    rng = np.random.default_rng(C)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device=cuda)
    tau = rng.uniform(0.01, 0.1, C)
    tau[-1] = 1e-30
    # words, gram, xsq, eps, beta, border, inner, z, lam, tau, c2, sigmaE,
    # valid
    hs = (args[:5] + args[6:8] + (args[9], t(rng.uniform(0.1, 2.0,
                                                          (C, nb * B))),
                                  t(tau), t(rng.uniform(1.0, 2.0, C)),
                                  args[12], args[15]))
    eps_k, beta_k = multichain.horseshoe_sweep_mc(*hs, **kw)
    eps_r, beta_r = multichain.horseshoe_sweep_mc_reference(*hs, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(beta_k, beta_r, rtol=1e-4, atol=1e-5)
    _assert_eps_close(eps_k, eps_r)
    at = serial.position_markers(args[6], args[7], B)
    for c in range(C):
        one = list(_chain(hs, c, (3, 4, 7, 8, 9, 10, 11)))
        one[7] = one[7][at]
        e1, b1 = serial.horseshoe_sweep(*one, **kw)
        assert torch.equal(e1, eps_k[c]) and torch.equal(b1, beta_k[c]), c


# ------------------------------------- words with missing calls (code 3)


@pytest.mark.cuda
@pytest.mark.parametrize("J,B,G,K,N", [(4, 16, 3, 4, 1500),
                                       (32, 32, 1, 4, 4096)])
def test_miss_kernels_match_plain(cuda, J, B, G, K, N):
    """The strided BayesR and horseshoe sweeps in the miss mode against
    their plain versions (the TPU kernel's two-dot algebra); pad lanes stay
    0 though they hold code 3."""
    args, kw = _case(J + B + G + 7, J, B, G, K, 4, N, cuda, missing=True)
    if N % 2048:                      # the last word holds pad lanes only
        assert (args[0][:, -1] == -1).all()   # code 3 in every field
    before = bayesr_jacobi_t.launches
    ker = bayesr_jacobi_t(*args, **kw)
    ref = bayesr_jacobi_t_reference(*args, **kw)
    torch.cuda.synchronize()
    assert bayesr_jacobi_t.launches == before + 3 * 4
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.eps, ref.eps, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.beta_acum, ref.beta_acum, rtol=1e-4,
                               atol=1e-6)
    assert (ker.eps[N:] == 0).all()
    again = bayesr_jacobi_t(*args, **kw)
    for a, b in zip(ker, again):
        assert torch.equal(a, b)

    hs, kw = _hs_case(J + B + 9, J, B, 4, N, cuda, missing=True)
    eps_k, beta_k = horseshoe_jacobi_t(*hs, **kw)
    eps_r, beta_r = horseshoe_jacobi_t_reference(*hs, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(beta_k, beta_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(eps_k, eps_r, rtol=1e-4, atol=1e-5)
    assert (eps_k[N:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("C,J,B,N", [(3, 4, 16, 1500), (17, 8, 32, 3000)])
def test_miss_mc_kernels_match_plain_and_single_chains(cuda, C, J, B, N):
    """The fused miss-mode sweeps against their plain versions, and each
    chain bitwise against the single-chain miss kernel."""
    args, kw = _mc_case(C + J + 5, J, B, 1, 4, 4, N, C, cuda, missing=True)
    ker = bayesr_jacobi_t_mc(*args, **kw)
    ref = bayesr_jacobi_t_mc_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.eps, ref.eps, rtol=1e-4, atol=1e-5)
    for c in range(C):
        one = bayesr_jacobi_t(*_chain(args, c, (3, 4, 5, 8, 9, 10, 12, 13)),
                              **kw)
        for name, a, b in zip(one._fields, one, ker):
            assert torch.equal(a, b[c]), (c, name)

    rng = np.random.default_rng(C + 1)
    M = args[2].shape[0]
    t = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device=cuda)
    hs = (args[:5] + args[6:8] + (args[9], t(rng.uniform(0.1, 2.0, (C, M))),
                                  t(rng.uniform(0.01, 0.1, C)),
                                  t(rng.uniform(1.0, 2.0, C)), args[12],
                                  args[15]))
    eps_k, beta_k = horseshoe_jacobi_t_mc(*hs, **kw)
    eps_r, beta_r = horseshoe_jacobi_t_mc_reference(*hs, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(beta_k, beta_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(eps_k, eps_r, rtol=1e-4, atol=1e-5)
    for c in range(C):
        e1, b1 = horseshoe_jacobi_t(*_chain(hs, c, (3, 4, 7, 8, 9, 10, 11)),
                                    **kw)
        assert torch.equal(e1, eps_k[c]) and torch.equal(b1, beta_k[c]), c


def _or_bits(words, bits):
    """words | bits as int32 (the bit pattern of the uint32 words)."""
    w = (words.to(torch.int64) & 0xFFFFFFFF) | bits
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 2.0 ** -6, 0.03, 1.0])
def test_miss_mc_dot_at_missing_rates(cuda, rate):
    """The fused miss sweeps (C=8; the dot's indicator pass adds only the
    missing calls' eps) on words with no, 2^-6, 3 % and only missing calls:
    each chain bitwise equal to the single-chain miss kernel (whose
    indicator takes all 16 FMAs a word) in every output; against the plain
    versions as the other miss tests where calls are not all missing (at
    100 % r is a rounding residue, so labels are not compared there)."""
    C, J, B, N = 8, 8, 32, 3000
    args, kw = _mc_case(int(rate * 1000) + 3, J, B, 1, 4, 4, N, C, cuda)
    args = (_or_bits(args[0], _miss_bits(args[0], rate, N, 7)),) + args[1:]
    kw = dict(kw, fold_affine=False, missing=True)
    ker = bayesr_jacobi_t_mc(*args, **kw)
    if rate < 1:
        ref = bayesr_jacobi_t_mc_reference(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(ker.labels, ref.labels)
        torch.testing.assert_close(ker.eps, ref.eps, rtol=1e-4, atol=1e-5)
    assert torch.isfinite(ker.eps).all() and torch.isfinite(ker.beta).all()
    for c in range(C):
        one = bayesr_jacobi_t(*_chain(args, c, (3, 4, 5, 8, 9, 10, 12, 13)),
                              **kw)
        for name, a, b in zip(one._fields, one, ker):
            assert torch.equal(a, b[c]), (c, name)
    M = args[2].shape[0]
    hs = (args[:5] + args[6:8] + (
        args[9], torch.rand((C, M), device=cuda) * 1.9 + 0.1,
        torch.rand(C, device=cuda) * 0.09 + 0.01,
        torch.rand(C, device=cuda) + 1.0, args[12], args[15]))
    eps_k, beta_k = horseshoe_jacobi_t_mc(*hs, **kw)
    for c in range(C):
        e1, b1 = horseshoe_jacobi_t(*_chain(hs, c, (3, 4, 7, 8, 9, 10, 11)),
                                    **kw)
        assert torch.equal(e1, eps_k[c]) and torch.equal(b1, beta_k[c]), c


def _miss_bits(words, rate, N, seed):
    """The bits that turn each call of the first N individuals of ``words``
    (M, Nw) into a missing call (code 3) at ``rate``, as int64."""
    g = torch.Generator(device=words.device).manual_seed(seed)
    M, Nw = words.shape
    lane = torch.arange(16 * Nw, device=words.device).view(Nw, 16)
    hit = torch.rand((M, Nw, 16), generator=g, device=words.device) < rate
    hit &= (lane < N)[None]
    shift = 3 << (2 * torch.arange(16, device=words.device,
                                   dtype=torch.int64))
    return (hit.to(torch.int64) * shift).sum(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,K,nb,N,chunk", [(64, 2, 4, 8, 1500, 3),
                                              (512, 1, 4, 4, 4096, None),
                                              (200, 1, 3, 5, 3000, 2),
                                              (1024, 1, 4, 2, 2048, None),
                                              (30, 1, 4, 5, 1500, None)])
def test_decode_serial_kernels_match_plain(cuda, B, G, K, nb, N, chunk):
    """The serial BayesR and horseshoe sweeps in the in-kernel decode mode
    (fold_affine=False, words with missing calls) against their plain
    versions, at blocks of 1,024 and 30 markers; a fused launch refuses
    that mode."""
    from bayesrrcpp_tpu_torch.ops import multichain, serial

    args, kw = _serial_case(B + K + 11, B, G, K, nb, N, cuda, chunk,
                            missing=True)
    assert not kw["fold_affine"]
    before = serial.bayesr_sweep.launches
    ker = serial.bayesr_sweep(*args, **kw)
    ref = serial.bayesr_sweep_reference(*args, **kw)
    torch.cuda.synchronize()
    assert serial.bayesr_sweep.launches == before + 3 * nb
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    _assert_eps_close(ker.eps, ref.eps)
    assert (ker.eps[N:] == 0).all()
    again = serial.bayesr_sweep(*args, **kw)
    for a, b in zip(ker, again):
        assert torch.equal(a, b)

    lam = torch.rand(nb * B, device=cuda) * 1.9 + 0.1
    hs = _serial_hs(args, lam, 0.05)
    eps_k, beta_k = serial.horseshoe_sweep(*hs, **kw)
    eps_r, beta_r = serial.horseshoe_sweep_reference(*hs, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(beta_k, beta_r, rtol=1e-4, atol=1e-5)
    _assert_eps_close(eps_k, eps_r)
    assert (eps_k[N:] == 0).all()

    mc, _ = _serial_mc_case(B + 1, B, K, nb, N, 2, cuda, chunk)
    with pytest.raises(NotImplementedError, match="single-chain"):
        multichain.bayesr_sweep_mc(*mc, **kw)


def _dense_case(seed, nb, B, N, C, G, dev):
    """Dense standardized rows (nb*B, N) f32 with their Gram blocks, and a
    warm state of C chains with variates."""
    rng = np.random.default_rng(seed)
    M = nb * B
    dos = rng.binomial(2, rng.uniform(0.1, 0.9, (M, 1)), size=(M, N))
    X = (dos - dos.mean(1, keepdims=True)) / dos.std(1, ddof=1, keepdims=True)
    t = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=dev)
    X = t(X)
    Xb = X.view(nb, B, N)
    beta = np.zeros((C, M))
    labels = np.zeros((C, M), np.int32)
    for c in range(C):
        hot = rng.choice(M, M // 8, replace=False)
        labels[c, hot] = rng.integers(1, 4, hot.size)
        beta[c, hot] = rng.normal(0, 0.05, hot.size)
    return dict(
        X=X, gram=torch.bmm(Xb, Xb.transpose(1, 2)), xsq=(X * X).sum(1),
        eps=t(rng.standard_normal((C, N))), beta=t(beta),
        labels=t(labels, torch.int32), p=t(rng.random((C, M))),
        z=t(rng.standard_normal((C, M))),
        pi=t(rng.dirichlet([5, 2, 2, 1], (C, G))),
        cva=t(np.tile([1e-3, 1e-2, 1e-1], (G, 1))),
        sigmaE=t(rng.uniform(0.5, 1.0, C)),
        sigmaGG=t(rng.uniform(0.02, 0.08, (C, G))),
        lam=t(rng.uniform(0.1, 2.0, (C, M))),
        tau=t(rng.uniform(0.01, 0.1, C)), c2=t(rng.uniform(1.0, 2.0, C)),
        gas=t(np.arange(M) % G, torch.int32), valid=t(np.arange(M) < M - 3,
                                                      torch.bool),
        inner=t(np.argsort(rng.random((nb, B)), axis=1), torch.int32),
        order=t(rng.permutation(nb), torch.int32), M=M)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [150, 4001, 4096])
@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("hs", [False, True])
def test_dense_kernels_match_plain_and_single_chains(cuda, hs, strided, N):
    """The dense mode of the strided (J=4, B=32, nr=2) and serial (B=64,
    8 blocks) kernels, one chain and C=3 fused, against their plain
    versions (labels and v exact, eps as ``_assert_eps_close``, the other
    floats to f32 reassociation), each fused chain bitwise equal to the
    single-chain kernel; N=150 and 4001 take the unaligned loads, 4096 the
    float4 ones."""
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
    from bayesrrcpp_tpu_torch.ops import multichain, serial

    C = 3
    nb, B = (8, 32) if strided else (8, 64)
    c = _dense_case(N + 7 * hs + strided, nb, B, N, C, 2, cuda)
    if strided:
        rho = torch.randperm(2, device=cuda).to(torch.int32)
        kw = dict(J=4)
        fns = ((jt.horseshoe_jacobi_t, jt.horseshoe_jacobi_t_reference,
                jt.horseshoe_jacobi_t_mc, jt.horseshoe_jacobi_t_mc_reference)
               if hs else
               (jt.bayesr_jacobi_t, jt.bayesr_jacobi_t_reference,
                jt.bayesr_jacobi_t_mc, jt.bayesr_jacobi_t_mc_reference))
    else:
        kw = {}
        fns = ((serial.horseshoe_sweep, serial.horseshoe_sweep_reference,
                multichain.horseshoe_sweep_mc,
                multichain.horseshoe_sweep_mc_reference)
               if hs else
               (serial.bayesr_sweep, serial.bayesr_sweep_reference,
                multichain.bayesr_sweep_mc,
                multichain.bayesr_sweep_mc_reference))
    single, plain, fused, fused_plain = fns
    order = rho if strided else c["order"]
    if not strided:
        at = serial.position_markers(order, c["inner"], B)

    def args(ch):
        """Chain ``ch``'s operands, or all chains' (ch None)."""
        one = (lambda x: x) if ch is None else (lambda x: x[ch])
        p, z = one(c["p"]), one(c["z"])
        if ch is not None and not strided:
            p, z = p[at], z[at]           # by sweep position
        head = (c["X"], c["gram"], c["xsq"], one(c["eps"]), one(c["beta"]))
        if hs:
            return head + (order, c["inner"], z, one(c["lam"]),
                           one(c["tau"]), one(c["c2"]), one(c["sigmaE"]),
                           c["valid"])
        return head + (one(c["labels"]), order, c["inner"], p, z,
                       one(c["pi"]), c["cva"], one(c["sigmaE"]),
                       one(c["sigmaGG"]), c["gas"], c["valid"])

    names = ("eps", "beta") + (() if hs else ("labels", "v", "beta_acum"))
    for ker, ref in ((single(*args(0), **kw), plain(*args(0), **kw)),
                     (fused(*args(None), **kw), fused_plain(*args(None),
                                                            **kw))):
        torch.cuda.synchronize()
        for name, a, b in zip(names, ker, ref):
            if name in ("labels", "v"):
                assert torch.equal(a, b), name
            elif name == "eps":
                _assert_eps_close(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    for ch in range(C):
        for a, b in zip(single(*args(ch), **kw), ker):
            assert torch.equal(a, b[ch]), ch


# ---------------------------------- the row-layout (J > 1) sweeps, solves


def _row_args(seed, J, B, nr, N, dev, dense, hs):
    """A row sweep's operands (one chain): packed words in the fold mode
    (``_serial_case``) or dense rows (``_dense_case``, chain 0), the block
    order a permutation of the nb = J*nr blocks, p/z by position."""
    nb = J * nr
    if dense:
        c = _dense_case(seed, nb, B, N, 1, 2, dev)
        one = {k: (v[0] if k in ("eps", "beta", "labels", "p", "z", "pi",
                                 "sigmaE", "sigmaGG", "lam", "tau", "c2")
                   else v) for k, v in c.items()}
        head = (one["X"], one["gram"], one["xsq"], one["eps"], one["beta"])
        kw = dict(J=J)
        if hs:
            return head + (one["order"], one["inner"], one["z"], one["lam"],
                           one["tau"], one["c2"], one["sigmaE"],
                           one["valid"]), kw
        return head + (one["labels"], one["order"], one["inner"], one["p"],
                       one["z"], one["pi"], one["cva"], one["sigmaE"],
                       one["sigmaGG"], one["gas"], one["valid"]), kw
    args, kw = _serial_case(seed, B, 2, 4, nb, N, dev, None)
    del kw["max_call_blocks"]
    kw["J"] = J
    if hs:
        lam = torch.as_tensor(np.random.default_rng(seed).uniform(
            0.1, 2.0, nb * B), dtype=torch.float32, device=dev)
        return _serial_hs(args, lam, 0.05), kw
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("J,B,nr,N", [(8, 64, 2, 1500), (2, 16, 4, 4001),
                                      (16, 32, 2, 3000), (4, 200, 2, 2048),
                                      (16, 512, 2, 1500), (16, 512, 2, 4096)])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("hs", [False, True])
def test_row_kernels_match_plain(cuda, hs, dense, J, B, nr, N):
    """The row-layout BayesR and horseshoe sweeps (csrc/serial.cu with J
    blocks a round) against their plain versions, packed (fold mode) and
    dense, blocks narrower than a warp, of 200 markers and several CTAs a
    block, rounds of 8,192 entries (the 2-bit apply's two lists of 4,096):
    labels and v exact, eps as ``_assert_eps_close``, beta to f32
    reassociation; 3 launches a round, one of them the round solve; a second
    sweep bitwise equal.  lam comes from the case's seed (more draws at
    N=1,500: ``test_row_horseshoe_at_n1500_against_float64``)."""
    from bayesrrcpp_tpu_torch.ops import jacobi

    args, kw = _row_args(J + B + N, J, B, nr, N, cuda, dense, hs)
    fn, ref_fn = ((jacobi.horseshoe_jacobi, jacobi.horseshoe_jacobi_reference)
                  if hs else (jacobi.bayesr_jacobi,
                              jacobi.bayesr_jacobi_reference))
    solve = jacobi.horseshoe_round_solve if hs else jacobi.bayesr_round_solve
    before, before_s = fn.launches, solve.launches
    ker = fn(*args, **kw)
    ref = ref_fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 3 * nr
    assert solve.launches == before_s + nr
    names = ("eps", "beta") + (() if hs else ("labels", "v", "beta_acum"))
    for name, a, b in zip(names, ker, ref):
        if name in ("labels", "v"):
            assert torch.equal(a, b), name
        elif name == "eps":
            _assert_eps_close(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    if not dense:
        assert (ker[0][N:] == 0).all()
    for a, b in zip(ker, fn(*args, **kw)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("draw", [("numpy", i) for i in range(8)]
                         + [("torch", i) for i in range(8)])
def test_row_horseshoe_at_n1500_against_float64(cuda, draw):
    """The row horseshoe at (J, B, nr) = (16, 512, 2) on fold-mode words of
    N=1,500 (8,192 markers a round, all moving, far more than N: the first
    round overshoots and the fold cancels large terms), 16 lam draws
    (numpy's of seeds 100-107, as tests/test_torch_jacobi_row.py draws
    them, and the card's generator of seeds 100-107): the kernel and the
    plain version each held elementwise to the same sweep in float64
    (``ROW_HS_F64_ATOL``), and to each other within twice that, as the CPU
    test holds the plain version and JAX's kernel (two f32 sides part by
    more than ``test_row_kernels_match_plain``'s atol at this shape)."""
    from bayesrrcpp_tpu_torch.ops import jacobi

    J, B, nr, N = 16, 512, 2, 1500
    args, kw = _row_args(J + B + N, J, B, nr, N, cuda, False, True)
    src, i = draw
    if src == "numpy":
        lam = torch.as_tensor(np.random.default_rng(100 + i).uniform(
            0.1, 2.0, J * B * nr), dtype=torch.float32, device=cuda)
    else:
        g = torch.Generator(device=cuda).manual_seed(100 + i)
        lam = torch.rand(J * B * nr, generator=g, device=cuda) * 1.9 + 0.1
    args = args[:8] + (lam,) + args[9:]
    ker = jacobi.horseshoe_jacobi(*args, **kw)
    ref = jacobi.horseshoe_jacobi_reference(*args, **kw)
    exact = row_hs_f64(args, kw)
    far = {side: {name: float((a.double() - b).abs().max())
                  for name, a, b in zip(("eps", "beta"), out, exact)}
           for side, out in (("kernel", ker), ("plain", ref))}
    print(f"lam draw {draw}: max |d| from float64 {far}, kernel vs plain "
          f"beta {float((ker[1] - ref[1]).abs().max()):.3g}")
    for side, d in far.items():
        for name, x in d.items():
            assert x <= ROW_HS_F64_ATOL[name], (side, name, x)
    for name, a, b in zip(("eps", "beta"), ker, ref):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=2 * ROW_HS_F64_ATOL[name])


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_row_kernel_at_one_block_is_the_serial_kernel(cuda, dense):
    """J=1 runs csrc/serial.cu as the serial sweep does (one chunk at this
    size): every output bitwise equal."""
    from bayesrrcpp_tpu_torch.ops import jacobi, serial

    args, kw = _row_args(5, 1, 64, 6, 1500, cuda, dense, False)
    kw.pop("J")
    for a, b in zip(jacobi.bayesr_jacobi(*args, J=1, **kw),
                    serial.bayesr_sweep(*args, **kw)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("J,B", [(8, 64), (3, 512), (16, 16)])
def test_round_solves_match_plain(cuda, J, B):
    """The round solves alone (one launch of the row sweep's solve on r
    given) against their plain versions on one round of a dense case:
    labels and v exact, dlane and beta to 1e-5."""
    from bayesrrcpp_tpu_torch.ops import jacobi

    c = _dense_case(J * B, 2 * J, B, 777, 1, 2, cuda)
    rows = (c["order"][:J].long()[:, None] * B
            + torch.arange(B, device=cuda)).reshape(-1)
    r = (c["X"][rows] @ c["eps"][0]).view(J, B)
    pkg, inner = jacobi.build_pkg_jacobi(
        c["xsq"], c["gas"], c["valid"], c["p"][0], c["z"][0], c["pi"][0],
        c["cva"], c["sigmaE"][0], c["sigmaGG"][0], c["order"], c["inner"],
        B=B, J=J)
    hpkg, _ = jacobi.build_pkg_hs_jacobi(
        c["xsq"], c["valid"], c["z"][0], c["lam"][0], c["tau"][0],
        c["c2"][0], c["sigmaE"][0], c["order"], c["inner"], B=B, J=J)
    blk = c["order"][:J].long()
    args = (r, c["gram"][blk], c["beta"][0][rows].view(J, B),
            c["labels"][0][rows].view(J, B), c["gas"][rows].view(J, B),
            inner[0], pkg[0], c["sigmaE"][0])
    before = jacobi.bayesr_round_solve.launches
    ker = jacobi.bayesr_round_solve(*args, K=4, G=2)
    ref = jacobi.bayesr_round_solve_reference(*args, K=4, G=2)
    torch.cuda.synchronize()
    assert jacobi.bayesr_round_solve.launches == before + 1
    assert torch.equal(ker[2], ref[2]) and torch.equal(ker[3], ref[3])
    for a, b in zip((ker[0], ker[1], ker[4]), (ref[0], ref[1], ref[4])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    hs = (r, args[1], args[2], inner[0], hpkg[0])
    for a, b in zip(jacobi.horseshoe_round_solve(*hs),
                    jacobi.horseshoe_round_solve_reference(*hs)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_row_kernel_refuses_blocks_over_512(cuda):
    """The row layout's solve is built for blocks of at most 512 markers
    (the plans' largest); a wider block is refused before any launch."""
    from bayesrrcpp_tpu_torch.ops import jacobi

    args, kw = _row_args(7, 2, 1024, 1, 2048, cuda, False, False)
    before = jacobi.bayesr_jacobi.launches
    with pytest.raises(ValueError, match="row-layout kernel takes blocks"):
        jacobi.bayesr_jacobi(*args, **kw)
    assert jacobi.bayesr_jacobi.launches == before


# ------------------------------------------------ int8 codes (families A-D)


def _int8_case(seed, nb, B, N, C, G, dev, missing=False):
    """int8 codes (nb*B, N) with ``genotypes.quantize_int8``'s statistics
    on the card and a warm state of C chains with variates (the dense
    case's, on these codes); ``missing``: ~3 % of the calls are code 3."""
    rng = np.random.default_rng(seed)
    M = nb * B
    dos = rng.binomial(2, rng.uniform(0.1, 0.9, (M, 1)), size=(M, N))
    dos = dos.astype(float)
    if missing:
        dos[rng.random((M, N)) < 0.03] = np.nan
    q = genotypes.quantize_int8(dos, True, None, B, M, device=dev)
    assert q.has_missing == missing
    c = _dense_case(seed, nb, B, N, C, G, dev)
    c.update(X=q.codes, gram=q.gram, xsq=q.xsq)
    kw = dict(x_mean=q.x_mean, x_scale=q.x_scale, x_xsum=q.x_colsum,
              fold_affine=not missing)
    return c, kw


def _int8_args(c, hs, kind, order, ch, B):
    """Chain ``ch``'s operands of an int8 sweep of ``kind`` ("t", "serial",
    "row"), or all chains' (ch None, p/z by marker)."""
    from bayesrrcpp_tpu_torch.ops import serial

    one = (lambda x: x) if ch is None else (lambda x: x[ch])
    p, z = one(c["p"]), one(c["z"])
    if ch is not None and kind != "t":
        at = serial.position_markers(order, c["inner"], B)
        p, z = p[at], z[at]               # by sweep position
    head = (c["X"], c["gram"], c["xsq"], one(c["eps"]), one(c["beta"]))
    if hs:
        return head + (order, c["inner"], z, one(c["lam"]), one(c["tau"]),
                       one(c["c2"]), one(c["sigmaE"]), c["valid"])
    return head + (one(c["labels"]), order, c["inner"], p, z, one(c["pi"]),
                   c["cva"], one(c["sigmaE"]), one(c["sigmaGG"]), c["gas"],
                   c["valid"])


def _int8_fns(kind, hs):
    """(single, its plain version, fused, its plain version) of a kind."""
    from bayesrrcpp_tpu_torch.ops import jacobi, multichain, serial
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt

    if kind == "t":
        return ((jt.horseshoe_jacobi_t, jt.horseshoe_jacobi_t_reference,
                 jt.horseshoe_jacobi_t_mc, jt.horseshoe_jacobi_t_mc_reference)
                if hs else
                (jt.bayesr_jacobi_t, jt.bayesr_jacobi_t_reference,
                 jt.bayesr_jacobi_t_mc, jt.bayesr_jacobi_t_mc_reference))
    if kind == "row":
        return ((jacobi.horseshoe_jacobi, jacobi.horseshoe_jacobi_reference,
                 None, None) if hs else
                (jacobi.bayesr_jacobi, jacobi.bayesr_jacobi_reference, None,
                 None))
    return ((serial.horseshoe_sweep, serial.horseshoe_sweep_reference,
             multichain.horseshoe_sweep_mc,
             multichain.horseshoe_sweep_mc_reference)
            if hs else
            (serial.bayesr_sweep, serial.bayesr_sweep_reference,
             multichain.bayesr_sweep_mc, multichain.bayesr_sweep_mc_reference))


def _assert_int8_close(names, ker, ref):
    torch.cuda.synchronize()
    for name, a, b in zip(names, ker, ref):
        if name in ("labels", "v"):
            assert torch.equal(a, b), name
        elif name == "eps":
            _assert_eps_close(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4001, 4096])
@pytest.mark.parametrize("kind", ["t", "serial", "row"])
@pytest.mark.parametrize("hs", [False, True])
def test_int8_kernels_match_plain_and_single_chains(cuda, hs, kind, N):
    """Families A-C, the int8 fold mode: the strided kernels (J=8, B=32,
    nr=2; A one chain, B fused), the serial ones (B=64, 8 blocks; C, one
    chain and fused) and the row sweep (J=4, B=64, 2 rounds; C) against
    their plain versions at N=4096 (vector loads) and 4001 (byte loads):
    labels and v exact, eps as ``_assert_eps_close``, the other floats to
    f32 reassociation; fused C=8 (C=17 on the strided kernels: groups of 16
    and 1) each chain bitwise equal to the single-chain kernel; a second
    launch bitwise equal (fixed-order sums); pad markers (code 3, scale 0)
    add exactly nothing."""
    single, plain, fused, fused_plain = _int8_fns(kind, hs)
    C = 17 if kind == "t" else 8
    J, nb, B = {"t": (8, 16, 32), "serial": (1, 8, 64), "row": (4, 8, 64)}[
        kind]
    c, skw = _int8_case(N + 7 * hs + len(kind), nb, B, N, C, 2, cuda)
    order = (torch.randperm(nb // J, device=cuda).to(torch.int32)
             if kind == "t" else c["order"])
    kw = dict(skw, **({} if kind == "serial" else dict(J=J)))
    names = ("eps", "beta") + (() if hs else ("labels", "v", "beta_acum"))
    before = single.launches
    ker = single(*_int8_args(c, hs, kind, order, 0, B), **kw)
    _assert_int8_close(names, ker,
                       plain(*_int8_args(c, hs, kind, order, 0, B), **kw))
    assert single.launches == before + 3 * (nb // J)
    for a, b in zip(ker, single(*_int8_args(c, hs, kind, order, 0, B),
                                **kw)):
        assert torch.equal(a, b)
    if fused is None:
        return
    fk = fused(*_int8_args(c, hs, kind, order, None, B), **kw)
    _assert_int8_close(names, fk, fused_plain(
        *_int8_args(c, hs, kind, order, None, B), **kw))
    for ch in (0, 5, C - 1):
        for a, b in zip(single(*_int8_args(c, hs, kind, order, ch, B), **kw),
                        fk):
            assert torch.equal(a, b[ch]), ch


@pytest.mark.cuda
@pytest.mark.parametrize("C", [None, 3])
def test_int8_rounds_kernels_match_plain(cuda, C):
    """Sites #5 and #6 on int8 codes: chunks of 1 and 3 of a sweep's 4
    rounds against their plain versions, the chunk of every round bitwise
    equal to the whole-sweep kernel, chunks of 2 in turn bitwise equal to
    it in eps, beta and labels."""
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt

    J, nb, B, N, nr = 8, 32, 32, 4096, 4
    c, skw = _int8_case(11 + (C or 0), nb, B, N, C or 1, 2, cuda)
    rho = torch.randperm(nr, device=cuda).to(torch.int32)
    args = _int8_args(c, False, "t", rho, 0 if C is None else None, B)
    if C is None:
        rounds, plain, whole = (jt.bayesr_jacobi_t_rounds,
                                jt.bayesr_jacobi_t_rounds_reference,
                                jt.bayesr_jacobi_t)
    else:
        rounds, plain, whole = (jt.bayesr_jacobi_t_mc_rounds,
                                jt.bayesr_jacobi_t_mc_rounds_reference,
                                jt.bayesr_jacobi_t_mc)
    kw = dict(skw, J=J)
    rkw = dict(kw, nr_total=nr)
    for nrc in (1, 3):
        a = list(args)
        a[6] = rho[:nrc]
        _assert_int8_close(("eps", "beta", "labels", "v"),
                           rounds(*a, **rkw), plain(*a, **rkw))
    full = whole(*args, **kw)
    for a, b in zip(rounds(*args, **rkw), full):
        assert torch.equal(a, b)
    a = list(args)
    for c0 in range(0, nr, 2):
        a[6] = rho[c0:c0 + 2]
        res = rounds(*a, **rkw)
        a[3], a[4], a[5] = res.eps, res.beta, res.labels
    for name in ("eps", "beta", "labels"):
        assert torch.equal(getattr(res, name), getattr(full, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4001, 4096])
@pytest.mark.parametrize("hs", [False, True])
def test_int8_decode_kernels_match_plain(cuda, hs, N):
    """Family D, the int8 in-kernel decode (codes with ~3 % missing calls,
    ``fold_affine=False``, one chain, J=1; B=64, 8 blocks): labels and v
    exact, eps as ``_assert_eps_close``, beta to f32 reassociation; the
    fused sweep refuses it, as in JAX."""
    from bayesrrcpp_tpu_torch.ops import multichain

    single, plain, _, _ = _int8_fns("serial", hs)
    c, kw = _int8_case(N + hs, 8, 64, N, 1, 2, cuda, missing=True)
    names = ("eps", "beta") + (() if hs else ("labels", "v", "beta_acum"))
    args = _int8_args(c, hs, "serial", c["order"], 0, 64)
    ker = single(*args, **kw)
    _assert_int8_close(names, ker, plain(*args, **kw))
    for a, b in zip(ker, single(*args, **kw)):
        assert torch.equal(a, b)
    if not hs:
        with pytest.raises(NotImplementedError, match="single-chain"):
            multichain.bayesr_sweep_mc(
                *_int8_args(c, hs, "serial", c["order"], None, 64), **kw)


# ------------------------------- the row apply: ring against direct path


def _ring_and_direct(fn, *args, **kw):
    """``fn``'s outputs with every row apply on its ring and on its direct
    path (by default rounds of 1,024 entries and more take the ring)."""
    from bayesrrcpp_tpu_torch.ops import _cuda

    old = _cuda.row_apply_ring_rows(0)
    try:
        ring = fn(*args, **kw)
        _cuda.row_apply_ring_rows(1 << 30)
        direct = fn(*args, **kw)
    finally:
        _cuda.row_apply_ring_rows(old)
    torch.cuda.synchronize()
    return ring, direct


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 8, 16])
@pytest.mark.parametrize("storage,N", [("dense", 4100), ("int8", 4112),
                                       ("int8", 4001)])
@pytest.mark.parametrize("hs", [False, True])
def test_row_apply_ring_matches_direct_and_plain(cuda, hs, storage, N, C):
    """The strided sweeps' dense and int8 row apply (J=8, B=32: 256 entries
    a round) on its ring against its direct path, bitwise in every output,
    at an N that does not fill the last CTA's columns (64 f32 or 256 codes)
    and at an int8 N with N % 4 != 0 (both runs take the direct path, one
    column a thread); C chains fused (C=1: the single-chain sweep), each
    fused chain bitwise the single-chain sweep; the horseshoe moves every
    row.  Against the plain versions as the other dense and int8 tests."""
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt

    J, nb, B = 8, 16, 32
    seed = N + C + 7 * hs
    if storage == "dense":
        c, skw = _dense_case(seed, nb, B, N, C, 2, cuda), {}
    else:
        c, skw = _int8_case(seed, nb, B, N, C, 2, cuda)
    rho = torch.randperm(nb // J, device=cuda).to(torch.int32)
    kw = dict(skw, J=J)
    single, plain, fused, fused_plain = _int8_fns("t", hs)
    names = ("eps", "beta") + (() if hs else ("labels", "v", "beta_acum"))
    ch = 0 if C == 1 else None
    args = _int8_args(c, hs, "t", rho, ch, B)
    fn, ref = (single, plain) if C == 1 else (fused, fused_plain)
    ring, direct = _ring_and_direct(fn, *args, **kw)
    for name, a, b in zip(names, ring, direct):
        assert torch.equal(a, b), name
    _assert_int8_close(names, ring, ref(*args, **kw))
    if C > 1:
        for k in (0, C - 1):
            one = single(*_int8_args(c, hs, "t", rho, k, B), **kw)
            for a, b in zip(one, ring):
                assert torch.equal(a, b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["serial", "row"])
def test_row_apply_ring_with_no_moves(cuda, kind):
    """The int8 fold apply of rounds in which no row moves (every marker
    invalid: eps comes back unchanged, bitwise) on its ring against its
    direct path, bitwise: the serial sweep (B=64) and the row sweep (J=4,
    B=64).  The in-kernel decode always takes the direct path
    (test_int8_decode_kernels_match_plain)."""
    single, _, _, _ = _int8_fns(kind, False)
    kw_j = {} if kind == "serial" else dict(J=4)
    names = ("eps", "beta", "labels", "v", "beta_acum")
    c, kw = _int8_case(22, 8, 64, 4096, 1, 2, cuda)
    c["valid"] = torch.zeros_like(c["valid"])
    kw = dict(kw, **kw_j)
    args = _int8_args(c, False, kind, c["order"], 0, 64)
    ring, direct = _ring_and_direct(single, *args, **kw)
    for name, a, b in zip(names, ring, direct):
        assert torch.equal(a, b), name
    assert torch.equal(ring.eps, c["eps"][0])


# ------------------- the fused fold dot and the single-chain 2-bit apply


def _narrow(args, kw, Nw):
    """A strided sweep's operands with the words cut to their first Nw
    words a row (16 * Nw lanes; eps, at position 3, cut alike)."""
    lanes = 16 * Nw
    a = list(args)
    a[0] = a[0][:, :Nw].contiguous()
    a[3] = a[3][..., :lanes].contiguous()
    return tuple(a), dict(kw, row_valid=kw["row_valid"][:lanes].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("C", [2, 3, 8, 16])
def test_fused_dot_on_words_not_a_multiple_of_128(cuda, C, missing):
    """The fused BayesR sweep on 100 words a row (1,600 lanes for N=1,500:
    the dot's one split holds 28 words past Nw), whose dot is
    fold_dot_mc_kernel (CP = 2, 4, 8 and two passes of 8) or, on words
    with missing calls, dot_mc_kernel: against the plain version and each
    chain bitwise against the single-chain kernel."""
    args, kw = _mc_case(C + 31 + missing, 8, 32, 1, 4, 4, 1500, C, cuda,
                        missing=missing)
    args, kw = _narrow(args, kw, 100)
    ker = bayesr_jacobi_t_mc(*args, **kw)
    ref = bayesr_jacobi_t_mc_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.eps, ref.eps, rtol=1e-4, atol=1e-5)
    assert (ker.eps[:, 1500:] == 0).all()
    for c in range(C):
        one = bayesr_jacobi_t(*_chain(args, c, (3, 4, 5, 8, 9, 10, 12, 13)),
                              **kw)
        for name, a, b in zip(one._fields, one, ker):
            assert torch.equal(a, b[c]), (c, name)


@pytest.mark.cuda
@pytest.mark.parametrize("Nw", [128, 100])
@pytest.mark.parametrize("moving", ["none", "few", "all"])
@pytest.mark.parametrize("missing", [False, True])
def test_packed_apply_with_none_few_or_all_rows_moving(cuda, missing, moving,
                                                       Nw):
    """The single-chain 2-bit apply (apply_kernel, fold and miss modes)
    with no row moving (every marker invalid), a few (BayesR at
    pi[0] = 0.98 from beta = 0) and every valid row (the horseshoe), at
    N=1,500 (row_valid lanes) and Nw = 128 or 100 (a last CTA of 4 words):
    against the plain version, and every output bitwise equal to the fused
    sweep of that one chain (the same dot_kernel, and
    apply_mc_kernel<1>)."""
    J, B, N = 8, 32, 1500
    seed = 61 + missing + 2 * Nw
    if moving == "all":
        args, kw = _hs_case(seed, J, B, 4, N, cuda, missing=missing)
        single, plain, fused = (horseshoe_jacobi_t,
                                horseshoe_jacobi_t_reference,
                                horseshoe_jacobi_t_mc)
        per_chain = (3, 4, 7, 8, 9, 10, 11)
    else:
        args, kw = _case(seed, J, B, 1, 4, 4, N, cuda, missing=missing)
        a = list(args)
        a[4] = torch.zeros_like(a[4])
        a[5] = torch.zeros_like(a[5])
        if moving == "none":
            a[15] = torch.zeros_like(a[15])
        else:
            a[10] = torch.tensor([[0.98, 0.01, 0.005, 0.005]], device=cuda)
        args = tuple(a)
        single, plain, fused = (bayesr_jacobi_t, bayesr_jacobi_t_reference,
                                bayesr_jacobi_t_mc)
        per_chain = (3, 4, 5, 8, 9, 10, 12, 13)
    args, kw = _narrow(args, kw, Nw)
    ker, ref = tuple(single(*args, **kw)), tuple(plain(*args, **kw))
    torch.cuda.synchronize()
    valid = int(args[-1].sum())
    moved = int((ker[1] != args[4]).sum())
    want = {"none": moved == 0, "few": 0 < moved < valid // 10,
            "all": moved >= 0.99 * valid}
    assert want[moving], (moving, moved, valid)
    if moving == "none":
        assert torch.equal(ker[0], args[3])
    if moving != "all":
        assert torch.equal(ker[2], ref[2])        # labels
    for a, b in zip(ker[:2], ref[:2]):            # eps, beta
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert (ker[0][N:] == 0).all()
    one = tuple(a[None] if k in per_chain else a for k, a in enumerate(args))
    out = tuple(fused(*one, **kw))
    for k, (a, b) in enumerate(zip(ker, out)):
        assert torch.equal(a, b[0]), k


# ------------- the one-chain strided dot and the int8 in-kernel decode dot


@pytest.mark.cuda
@pytest.mark.parametrize("Nw", [128, 100])
@pytest.mark.parametrize("B", [32, 30])
@pytest.mark.parametrize("missing", [False, True])
def test_single_chain_dot_matches_plain_and_the_fused_chain(cuda, missing,
                                                           B, Nw):
    """The single-chain strided sweep, whose dot is dot_kernel<MISS> (fold
    and miss modes), at N=1,500 (row_valid lanes) with Nw = 128
    or 100 words a row (a split with 28 words past Nw) and B = 32 or 30:
    against the plain version (labels and v exact, floats to f32
    reassociation); every output bitwise equal to the fused sweep of that
    one chain; and a chunk of 3 of the sweep's 4 rounds (#5, rho holding
    global round ids) against its plain version and, run with the last
    round's chunk, bitwise equal to the whole sweep."""
    J, nr, N = 8, 4, 1500
    args, kw = _case(71 + missing + B + Nw, J, B, 1, 4, nr, N, cuda,
                     missing=missing)
    args, kw = _narrow(args, kw, Nw)
    ker = bayesr_jacobi_t(*args, **kw)
    ref = bayesr_jacobi_t_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.eps, ref.eps, rtol=1e-4, atol=1e-5)
    assert (ker.eps[N:] == 0).all()
    per_chain = (3, 4, 5, 8, 9, 10, 12, 13)
    one = tuple(a[None] if k in per_chain else a for k, a in enumerate(args))
    for name, a, b in zip(ker._fields, ker, bayesr_jacobi_t_mc(*one, **kw)):
        assert torch.equal(a, b[0]), name
    rkw = dict(kw, nr_total=nr)
    a = list(args)
    a[6] = args[6][:3]
    part, part_ref = (bayesr_jacobi_t_rounds(*a, **rkw),
                      bayesr_jacobi_t_rounds_reference(*a, **rkw))
    torch.cuda.synchronize()
    assert torch.equal(part.labels, part_ref.labels)
    torch.testing.assert_close(part.eps, part_ref.eps, rtol=1e-4, atol=1e-5)
    a[3], a[4], a[5] = part.eps, part.beta, part.labels
    a[6] = args[6][3:]
    last = bayesr_jacobi_t_rounds(*a, **rkw)
    for name in ("eps", "beta", "labels"):
        assert torch.equal(getattr(last, name), getattr(ker, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("hs", [False, True])
def test_int8_decode_kernels_at_narrow_rows_and_wide_blocks(cuda, hs):
    """The serial `_q` sweeps #9 / #10 on int8 codes with ~3 % missing
    calls (serial_q8_dot_kernel: 4 rows of a block a CTA, 128 CTAs a split
    at B=512) at N=150 (byte loads, a split mostly past N): against the
    plain version (labels and v exact, eps as ``_assert_eps_close``, beta
    to f32 reassociation) and a second launch bitwise equal."""
    single, plain, _, _ = _int8_fns("serial", hs)
    c, kw = _int8_case(150 + hs, 4, 512, 150, 1, 2, cuda, missing=True)
    names = ("eps", "beta") + (() if hs else ("labels", "v", "beta_acum"))
    args = _int8_args(c, hs, "serial", c["order"], 0, 512)
    before = single.launches
    ker = single(*args, **kw)
    _assert_int8_close(names, ker, plain(*args, **kw))
    assert single.launches == before + 3 * 4
    for a, b in zip(ker, single(*args, **kw)):
        assert torch.equal(a, b)


# ------------------------------------ the strided solves at move shares

BAYESR_PI0 = {"none": 1.0, "few": 0.97, "half": 0.5, "all": 0.0}
BAYESR_SHARE = {"none": (0.0, 0.0), "few": (0.005, 0.08),
                "half": (0.3, 0.7), "all": (0.95, 1.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("share", ["none", "few", "half", "all"])
@pytest.mark.parametrize("C", [None, 8])
@pytest.mark.parametrize("B,K,G", [(32, 4, 1), (30, 8, 2)])
def test_strided_solve_at_move_shares(cuda, B, K, G, C, share):
    """The strided BayesR solve (every remaining step of a block drawn at
    once, committed up to the first mover) from beta = 0 at 0, ~3, ~50
    and ~100 % moving steps (the spike's prior 1, 0.97, 0.5, 0), B=30 with
    pad lanes and K=8, G=2 beside the headline's B=32, K=4: against the
    plain one-step loop (labels and v exact, floats to f32
    reassociation), one chain and 8 fused, each fused chain bitwise the
    single-chain kernel."""
    J, nr, N = 16, 3, 4096
    seed = B + K + (C or 1) + len(share)
    args, kw = (_case(seed, J, B, G, K, nr, N, cuda) if C is None else
                _mc_case(seed, J, B, G, K, nr, N, C, cuda))
    a = list(args)
    a[4], a[5] = torch.zeros_like(a[4]), torch.zeros_like(a[5])
    pi0 = BAYESR_PI0[share]
    pi = torch.full(((C,) if C else ()) + (G, K), (1.0 - pi0) / (K - 1),
                    device=cuda)
    pi[..., 0] = pi0
    a[10] = pi
    fn, plain = ((bayesr_jacobi_t, bayesr_jacobi_t_reference) if C is None
                 else (bayesr_jacobi_t_mc, bayesr_jacobi_t_mc_reference))
    ker = fn(*a, **kw)
    ref = plain(*a, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.eps, ref.eps, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ker.beta_acum, ref.beta_acum, rtol=1e-4,
                               atol=1e-6)
    moved = float((ker.beta != 0).float().mean())
    lo, hi = BAYESR_SHARE[share]
    assert lo <= moved <= hi, moved
    for c in range(C or 0):
        one = bayesr_jacobi_t(*_chain(a, c, (3, 4, 5, 8, 9, 10, 12, 13)),
                              **kw)
        for name, x, y in zip(one._fields, one, ker):
            assert torch.equal(x, y[c]), (c, name)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.0, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("C", [None, 8])
def test_strided_hs_solve_at_move_shares(cuda, C, share):
    """The strided horseshoe solve (one step at a time, every operand but r
    read ahead) with 0, 3, 50 and 100 % of the markers valid (only a valid
    marker moves), B=30 (pad lanes): against the plain version (floats to
    f32 reassociation), one chain and 8 fused, each fused chain bitwise
    the single-chain kernel."""
    J, B, nr, N = 16, 30, 3, 4096
    rng = np.random.default_rng(int(share * 100) + (C or 1))
    args, kw = _mc_case(7 + (C or 1), J, B, 1, 4, nr, N, C or 1, cuda)
    M = args[2].shape[0]
    t = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device=cuda)
    valid = torch.as_tensor(rng.random(M) < share, device=cuda)
    # words, gram, xsq, eps, beta, rho, inner, z, lam, tau, c2, sigmaE, valid
    hs = list(args[:5] + args[6:8] + (args[9],
                                      t(rng.uniform(0.1, 2.0, (C or 1, M))),
                                      t(rng.uniform(0.01, 0.1, C or 1)),
                                      t(rng.uniform(1.0, 2.0, C or 1)),
                                      args[12], valid))
    per_chain = (3, 4, 7, 8, 9, 10, 11)
    if C is None:
        hs = list(_chain(hs, 0, per_chain))
    fn, plain = ((horseshoe_jacobi_t, horseshoe_jacobi_t_reference)
                 if C is None else
                 (horseshoe_jacobi_t_mc, horseshoe_jacobi_t_mc_reference))
    eps_k, beta_k = fn(*hs, **kw)
    eps_r, beta_r = plain(*hs, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(beta_k, beta_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(eps_k, eps_r, rtol=1e-4, atol=1e-5)
    moved = float((beta_k != hs[4]).float().mean())
    assert abs(moved - float(valid.float().mean())) < 1e-3, moved
    for c in range(C or 0):
        e1, b1 = horseshoe_jacobi_t(*_chain(hs, c, per_chain), **kw)
        assert torch.equal(e1, eps_k[c]) and torch.equal(b1, beta_k[c]), c


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["dense", "fold", "miss"])
def test_strided_solves_with_partials_over_one_stage(cuda, storage):
    """More than kSolveStage = 128 partial rows a block (129 splits: dense
    rows of N=66,000, 2-bit words of N=263,000 individuals), so the solves
    stage and sum their partials in two steps: BayesR and the horseshoe
    against their plain versions (labels and v exact, floats to f32
    reassociation), and 3 fused BayesR chains each bitwise the
    single-chain kernel."""
    J, B, nr, C = 4, 32, 2, 3
    if storage == "dense":
        c = _dense_case(5, J * nr, B, 66_000, C, 1, cuda)
        rho = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
        mc = (c["X"], c["gram"], c["xsq"], c["eps"], c["beta"], c["labels"],
              rho, c["inner"], c["p"], c["z"], c["pi"], c["cva"],
              c["sigmaE"], c["sigmaGG"], c["gas"], c["valid"])
        kw = dict(J=J, x_mean=None)
        hs = (mc[:5] + (rho, c["inner"], c["z"], c["lam"], c["tau"],
                        c["c2"], c["sigmaE"], c["valid"]))
        args, hs = _chain(mc, 0, BAYESR_CHAIN), _chain(hs, 0, HS_CHAIN)
    else:
        args, kw = _case(9, J, B, 1, 4, nr, 263_000, cuda,
                         missing=storage == "miss")
        mc, _ = _mc_case(9, J, B, 1, 4, nr, 263_000, C, cuda,
                         missing=storage == "miss")
        hs, _ = _hs_case(9, J, B, nr, 263_000, cuda,
                         missing=storage == "miss")
    ker = bayesr_jacobi_t(*args, **kw)
    ref = bayesr_jacobi_t_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    for name in ("beta", "eps"):
        torch.testing.assert_close(getattr(ker, name), getattr(ref, name),
                                   rtol=1e-4, atol=1e-5)
    eps_k, beta_k = horseshoe_jacobi_t(*hs, **kw)
    eps_r, beta_r = horseshoe_jacobi_t_reference(*hs, **kw)
    torch.testing.assert_close(beta_k, beta_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(eps_k, eps_r, rtol=1e-4, atol=1e-5)
    fused = bayesr_jacobi_t_mc(*mc, **kw)
    for c in range(C):
        one = bayesr_jacobi_t(*_chain(mc, c, BAYESR_CHAIN), **kw)
        for name, x, y in zip(one._fields, one, fused):
            assert torch.equal(x, y[c]), (c, name)


BAYESR_CHAIN = (3, 4, 5, 8, 9, 10, 12, 13)     # per-chain operands
HS_CHAIN = (3, 4, 7, 8, 9, 10, 11)


# ------------------------------------ the sharded samplers' kernel callers


def _sharded_sampler(kind, x_dtype, dev, **kw):
    """A one-rank sharded sampler on the card (no process group: the
    all-reduces are the identity) at N=2048 x M=4096 of random words,
    their int8 codes or dense standardized rows, with a warm state."""
    import bayesrrcpp_tpu_torch as bt

    g = torch.Generator(device=dev).manual_seed(61)
    N, M = 2048, 4096
    make = (bt.simulate.random_packed_words_missing if x_dtype == "2bit-miss"
            else bt.simulate.random_packed_words)
    words = make(g, M, N // 16, device=dev)
    stats = bt.simulate.packed_word_stats(M)
    if x_dtype == "int8":
        X = genotypes.decode_codes(words)[:, :N].to(torch.int8)
    elif x_dtype == "dense":
        X = torch.randn((M, N), generator=g, device=dev)
        X = (X - X.mean(1, keepdim=True)) / X.std(1, keepdim=True)
    else:
        X = words
    kw = dict(kw, backend="pallas", transposed=True,
              x_dtype="2bit" if x_dtype.startswith("2bit") else x_dtype,
              x_stats=None if x_dtype == "dense" else stats)
    mesh = bt.make_mesh(1, 1, device=dev)
    Y = torch.randn(N, generator=g, device=dev)
    s = (bt.ShardedSpikeSlabSampler(X, Y, [1e-4, 1e-3, 1e-2],
                                    bt.BayesRConfig(block_size=256), mesh,
                                    **kw)
         if kind == "bayesr" else
         bt.ShardedHorseshoeSampler(X, Y, bt.HorseshoeConfig(block_size=256),
                                    mesh, **kw))
    v = s.variates(torch.Generator(device=dev).manual_seed(62))
    return s, v, s._run_steps(s.init(v), v, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", ["2bit", "2bit-miss", "int8", "dense"])
def test_sharded_horseshoe_chunks_match_plain(cuda, x_dtype):
    """Site #10 through the sharded horseshoe's chunked call (chunks of 3
    of the 16 blocks, an all-reduce of eps after each) in every storage
    mode: the kernel's chunks against the plain version's on the first 5
    blocks of a warm state's order (eps as ``_assert_eps_close``, beta to
    f32 reassociation), 3 launches a block."""
    from bayesrrcpp_tpu_torch.ops import serial

    s, v, st = _sharded_sampler("horseshoe", x_dtype, cuda, chunk_blocks=3)
    assert (s.jacobi, s.nb_loc, s._serial_chunk()) == (1, 16, 3)
    assert s.data.has_missing == (x_dtype == "2bit-miss")
    border, inner = v.loc.block_orders(s.nb_loc, s.B)
    z = v.loc.z(s.Mloc)
    d = s.data

    def chunks(fn, n):
        beta = st.beta

        def sweep(eps, blocks, by_block, z_c):
            return fn(d.XT, d.gram, d.xsq, eps, beta, blocks, by_block, z_c,
                      st.lam, st.tau, st.c2, st.sigmaE, d.valid,
                      **s._sweep_kw())

        for eps, beta in s._serial_chunks(sweep, st.eps, border[:n],
                                          inner[:n], z[:n * s.B]):
            pass
        return eps, beta

    before = serial.horseshoe_sweep.launches
    ker = chunks(serial.horseshoe_sweep, 5)
    assert serial.horseshoe_sweep.launches == before + 3 * 5
    ref = chunks(serial.horseshoe_sweep_reference, 5)
    torch.cuda.synchronize()
    _assert_eps_close(ker[0], ref[0])
    torch.testing.assert_close(ker[1], ref[1], rtol=1e-4, atol=1e-5)
    before = serial.horseshoe_sweep.launches
    eps, beta = s._sweep_serial(st, st.eps, border, inner, z)
    assert serial.horseshoe_sweep.launches == before + 3 * s.nb_loc
    assert bool(torch.isfinite(eps).all()) and bool(torch.isfinite(beta).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_split_sweep_round_solves_match_plain(cuda, kind):
    """Sites #13 / #14 through the split sweep (``split_sweep=True`` on a
    one-rank mesh, rounds of J=4 blocks): each of a warm state's rounds
    solved by the kernel and by the plain version on the same r and
    operands (labels and v exact, dlane / beta / bacc to 1e-5, as
    ``test_round_solves_match_plain``), the sweep carried on by the
    kernel's; a step launches one round solve a round."""
    from bayesrrcpp_tpu_torch.ops import jacobi

    s, v, st = _sharded_sampler(kind, "dense", cuda, split_sweep=True,
                                chunk_blocks=4)
    J = s.split_blocks()
    nr = s.nb_loc // J
    assert (s._split, J, nr) == (True, 4, 4)
    border, inner = v.loc.block_orders(s.nb_loc, s.B)
    z = v.loc.z(s.Mloc)
    d = s.data
    by_block = torch.zeros_like(inner)
    by_block[border.long()] = inner
    if kind == "bayesr":
        p = v.loc.p(s.Mloc)
        pkg, inner_sel = jacobi.build_pkg_jacobi(
            d.xsq, d.g_assign, d.valid, p, z, st.pi, d.cva, st.sigmaE,
            st.sigmaGG, border, by_block, B=s.B, J=J)
        fns = (jacobi.bayesr_round_solve,
               jacobi.bayesr_round_solve_reference)
    else:
        pkg, inner_sel = jacobi.build_pkg_hs_jacobi(
            d.xsq, d.valid, z, st.lam, st.tau, st.c2, st.sigmaE, border,
            by_block, B=s.B, J=J)
        fns = (jacobi.horseshoe_round_solve,
               jacobi.horseshoe_round_solve_reference)
    beta = st.beta.clone()
    labels = st.labels.clone() if kind == "bayesr" else None
    moved = []

    def solve(i, r, blk, idx):
        if kind == "bayesr":
            a = (r, d.gram[blk], beta[idx].view(J, s.B),
                 labels[idx].view(J, s.B), d.g_assign[idx].view(J, s.B),
                 inner_sel[i], pkg[i], st.sigmaE)
            kw = dict(K=s.K, G=s.G)
        else:
            a = (r, d.gram[blk], beta[idx].view(J, s.B), inner_sel[i],
                 pkg[i])
            kw = {}
        ker, ref = fns[0](*a, **kw), fns[1](*a, **kw)
        if kind == "bayesr":
            assert torch.equal(ker[2], ref[2]) and torch.equal(ker[3], ref[3])
            labels[idx] = ker[2].reshape(-1)
        for x, y in zip(ker[:2] + ker[4:], ref[:2] + ref[4:]):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
        beta[idx] = ker[1].reshape(-1)
        moved.append(int((ker[0] != 0).sum()))
        return ker[0]

    s._split_rounds(st.eps, border, solve)
    assert len(moved) == nr and sum(moved) > 0
    before = fns[0].launches
    s.step(st, v)
    torch.cuda.synchronize()
    assert fns[0].launches == before + nr


# ------------------------------------------------------------ groups

GROUP_PATHS = {
    # name: (storage, plan keywords, fused)
    "t-fold": ("2bit", dict(jacobi_blocks=8, jacobi_layout="t",
                            block_size=32), False),
    "t-miss": ("2bit-miss", dict(jacobi_blocks=8, jacobi_layout="t",
                                 block_size=32), False),
    "t-dense": ("dense", dict(jacobi_blocks=8, jacobi_layout="t",
                              block_size=32, backend="pallas"), False),
    "t-int8": ("int8", dict(jacobi_blocks=8, jacobi_layout="t",
                            block_size=32), False),
    "t-fused": ("2bit", dict(jacobi_blocks=8, jacobi_layout="t",
                             block_size=32), True),
    "serial-fold": ("2bit", dict(jacobi_blocks=1, block_size=64), False),
    "serial-q": ("int8-miss", dict(jacobi_blocks=1, block_size=64), False),
    "serial-fused": ("2bit", dict(jacobi_blocks=1, block_size=64), True),
    "row": ("2bit", dict(jacobi_blocks=4, block_size=64), False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(GROUP_PATHS))
def test_grouped_sampler_kernels_match_plain(cuda, path, monkeypatch):
    """The grouped sampler (G=4 groups, ``g_assign = m % 4``, F=3 fixed
    effects) at N=1500 x M=2048 on each of its paths: after 2 steps, the
    next step's sweep (its operands recorded as the step passes them,
    eps after the fixed-effect sweep) against the plain version on the
    same operands: labels and v equal, bacc per group to a relative 1e-5,
    beta to rtol 1e-4 / atol 1e-5, eps to 1e-4 of its norm; a fused
    sweep's chain 0 bitwise the single-chain kernel (strided)."""
    import sys

    from bayesrrcpp_tpu_torch import (GroupsConfig, SpikeSlabSampler,
                                      TorchVariates)
    from bayesrrcpp_tpu_torch.models import bayesr as tbayesr

    storage, plan, fused = GROUP_PATHS[path]
    N, M = 1500, 2048
    rng = np.random.default_rng(17)
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(
        float)
    X = (dosage - dosage.mean(0)) / dosage.std(0, ddof=1)
    Y = X @ np.where(rng.random(M) < 0.02, rng.normal(0, 0.3, M), 0.0) \
        + rng.normal(0, 0.8, N)
    if storage.endswith("miss"):
        dosage[rng.random(dosage.shape) < 0.02] = np.nan
    kw = dict(plan)
    bs = kw.pop("block_size")
    if storage != "dense":
        kw["x_dtype"] = "int8" if storage.startswith("int8") else "2bit"
    cva = np.array([[1e-4, 1e-3, 1e-2], [2e-4, 2e-3, 2e-2],
                    [1e-4, 1e-3, 1e-2], [5e-4, 5e-3, 5e-2]])
    s = SpikeSlabSampler(X if storage == "dense" else dosage, Y, cva,
                         GroupsConfig(block_size=bs),
                         g_assign=np.arange(M) % 4,
                         fixed=rng.normal(size=(N, 3)), device=cuda, **kw)
    g = torch.Generator(device=cuda).manual_seed(5)
    v = TorchVariates(g, chains=3 if fused else None)
    st = s.init(v, chains=3 if fused else None)
    step = s.step_chains if fused else s.step
    for _ in range(2):
        st = step(st, v)
    calls = []

    def wrap(fn):
        def recorded(*a, **k):
            calls.append((fn, a, k))
            return fn(*a, **k)
        return recorded

    for name in ("bayesr_jacobi_t", "bayesr_jacobi_t_mc", "bayesr_sweep",
                 "bayesr_sweep_mc", "bayesr_jacobi"):
        monkeypatch.setattr(tbayesr, name, wrap(getattr(tbayesr, name)))
    step(st, v)
    (fn, a, k), = calls
    ref_fn = getattr(sys.modules[fn.__module__], fn.__name__ + "_reference")
    ker, ref = fn(*a, **k), ref_fn(*a, **k)
    torch.cuda.synchronize()
    assert torch.equal(ker.labels, ref.labels)
    assert torch.equal(ker.v, ref.v)
    assert bool((ker.labels > 0).any())
    rel = (ker.beta_acum - ref.beta_acum).abs() / ref.beta_acum.abs()
    assert float(rel.max()) < 1e-5, (ker.beta_acum, ref.beta_acum)
    torch.testing.assert_close(ker.beta, ref.beta, rtol=1e-4, atol=1e-5)
    d = torch.linalg.norm(ker.eps - ref.eps) / torch.linalg.norm(ref.eps)
    assert float(d) < 1e-4
    if fused and s.strided:
        one = bayesr_jacobi_t(*[x[0] if i in (3, 4, 5, 8, 9, 10, 12, 13)
                                else x for i, x in enumerate(a)], **k)
        for name in ("eps", "beta", "labels", "v", "beta_acum"):
            assert torch.equal(getattr(one, name), getattr(ker, name)[0]), \
                name
