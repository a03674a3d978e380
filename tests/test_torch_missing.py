"""Genotypes with missing calls (code 3) in the port's sweeps, against the
JAX package, on the CPU.

The same packed words (the JAX host packer on dosages with ~3 % missing
calls, N=1500 so that pad lanes exist), Gram blocks, warm state and
variates, made with numpy from a seed, go through

- the strided sweeps' ``miss`` mode: JAX ``bayesr_jacobi_t_pallas`` /
  ``horseshoe_jacobi_t_pallas`` and the fused ``*_pallas_mc`` (C=3, the
  C <= 4 kernel; C=6, the wide mc8 kernel) with ``interpret=True,
  missing=True``, against the port's wrappers on CPU tensors (their plain
  versions, the TPU kernel's two-dot algebra);
- the serial sweeps' in-kernel decode (``_q``): JAX ``bayesr_sweep_pallas``
  / ``horseshoe_sweep_pallas`` with ``fold_affine=False``, across chunk
  boundaries, against the port's ``bayesr_sweep`` / ``horseshoe_sweep``.

Tolerances are tests/test_jacobi_t.py:49-58's: labels and v exact, floats
to f32 reassociation (beta rtol 2e-4 / atol 2e-6, eps rtol 2e-4 / atol
2e-5: the packages sum the dots in different orders), and each fused
chain against the single-chain plain version likewise (one matrix
product over C chains rounds unlike C products over one: the horseshoe's
miss mode, which moves every row, reads up to 1e-4 relative on a lane).
Also the storage side: pad lanes and pad markers, ``has_missing``, the
missing-call word generator, and ``convert`` carrying such data across.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu.ops import genotypes as jgen
from bayesrrcpp_tpu.ops.pallas_jacobi_t import (
    bayesr_jacobi_t_pallas, bayesr_jacobi_t_pallas_mc,
    horseshoe_jacobi_t_pallas, horseshoe_jacobi_t_pallas_mc)
from bayesrrcpp_tpu.ops.pallas_sweep import (bayesr_sweep_pallas,
                                             horseshoe_sweep_pallas)
from bayesrrcpp_tpu_torch import simulate
from bayesrrcpp_tpu_torch.convert import (data_from_jax, has_missing_calls,
                                          unpermute_eps)
from bayesrrcpp_tpu_torch.ops import genotypes as tgen
from bayesrrcpp_tpu_torch.ops import jacobi_t, serial

N = 1500
CVA = np.array([0.001, 0.01, 0.1], np.float32)


def _dosage(rng, M, share=0.03):
    d = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(float)
    d[rng.random(d.shape) < share] = np.nan
    return d


def _case(seed, B, nb, G=1, C=None):
    """Packed words with missing calls and a warm state, all numpy; with C
    every per-chain array has a leading chain axis."""
    rng = np.random.default_rng(seed)
    M = nb * B
    q = jgen.quantize_packed(_dosage(rng, M), False, None, B, M, N,
                             prepacked=False)
    assert q.has_missing
    lead = () if C is None else (C,)
    eps = np.zeros(lead + (q.Npad,), np.float32)
    eps[..., :N] = rng.standard_normal(lead + (N,))
    beta = np.zeros(lead + (M,), np.float32)
    labels = np.zeros(lead + (M,), np.int32)
    for c in np.ndindex(lead):
        hot = rng.choice(M, M // 8, replace=False)
        labels[c + (hot,)] = rng.integers(1, 4, hot.size)
        beta[c + (hot,)] = rng.normal(0, 0.05, hot.size)
    return dict(
        q=q, M=M, eps=eps, eps_perm=eps[..., np.asarray(q.n_perm)],
        beta=beta, labels=labels,
        inner=np.argsort(rng.random((nb, B)), axis=1).astype(np.int32),
        order=rng.permutation(nb).astype(np.int32),
        p=rng.random(lead + (M,)).astype(np.float32),
        z=rng.standard_normal(lead + (M,)).astype(np.float32),
        pi=rng.dirichlet([5, 2, 2, 1], lead + (G,)).astype(np.float32),
        cva=np.tile(CVA, (G, 1)),
        sigmaE=rng.uniform(0.5, 1.0, lead).astype(np.float32),
        sigmaGG=rng.uniform(0.02, 0.08, lead + (G,)).astype(np.float32),
        lam=rng.uniform(0.1, 2.0, lead + (M,)).astype(np.float32),
        tau=rng.uniform(0.01, 0.1, lead).astype(np.float32),
        c2=rng.uniform(1.0, 2.0, lead).astype(np.float32),
        gas=(np.arange(M) % G).astype(np.int32),
        valid=np.arange(M) < M - 3)


def _words(c):
    q = c["q"]
    return [torch.as_tensor(np.array(x)) for x in (q.XT, q.gram, q.xsq)]


def _bayesr_args(c, a):
    """The BayesR sweep's arguments after eps; ``a`` makes the arrays."""
    return [a(c[k]) for k in ("beta", "labels", "order", "inner", "p", "z",
                              "pi", "cva", "sigmaE", "sigmaGG", "gas",
                              "valid")]


def _hs_args(c, a):
    return [a(c[k]) for k in ("beta", "order", "inner", "z", "lam", "tau",
                              "c2", "sigmaE", "valid")]


def _rounds(c, J):
    """The strided sweep's round order (nr,) in place of the block order."""
    nr = c["order"].shape[0] // J
    return dict(c, order=np.random.default_rng(nr).permutation(nr).astype(
        np.int32))


def _port_kw(c, J=None):
    q = c["q"]
    kw = dict(x_mean=torch.as_tensor(np.array(q.x_mean)),
              x_scale=torch.as_tensor(np.array(q.x_scale)),
              x_xsum=torch.as_tensor(np.array(q.x_colsum)),
              fold_affine=False, row_valid=torch.arange(q.Npad) < N)
    if J is not None:
        kw.update(J=J, missing=True)
    return kw


def _jax_kw(c, J=None):
    q = c["q"]
    kw = dict(interpret=True, x_mean=q.x_mean, x_scale=q.x_scale,
              x_xsum=q.x_colsum, fold_affine=False, row_valid=q.row_valid)
    if J is not None:
        kw.update(J=J, missing=True)
    return kw


def _assert_close(ker, out, c, rtol=2e-4):
    """A sweep result of JAX (``ker``) and of the port (``out``), fields
    in the same order (eps first, in JAX's lane order)."""
    names = ("eps", "beta", "labels", "v", "beta_acum")
    for name, a, b in zip(names, ker, out):
        a, b = np.asarray(a), b.numpy()
        if name == "eps":
            np.testing.assert_allclose(unpermute_eps(a, c["q"].Npad), b,
                                       rtol=rtol, atol=2e-5)
        elif name in ("labels", "v"):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol,
                                       atol=2e-6 if name == "beta" else 1e-6)


# ------------------------------------------------ the strided miss mode


@pytest.mark.parametrize("kind,G", [("bayesr", 1), ("bayesr", 2),
                                    ("horseshoe", 1)])
def test_miss_sweep_matches_jax_kernel(kind, G):
    J, B = 4, 16
    c = _rounds(_case(10 + G, B, 4 * J, G), J)
    t = torch.as_tensor
    if kind == "bayesr":
        port, ref, jfn, args = (jacobi_t.bayesr_jacobi_t,
                                jacobi_t.bayesr_jacobi_t_reference,
                                bayesr_jacobi_t_pallas, _bayesr_args)
    else:
        port, ref, jfn, args = (jacobi_t.horseshoe_jacobi_t,
                                jacobi_t.horseshoe_jacobi_t_reference,
                                horseshoe_jacobi_t_pallas, _hs_args)
    before = port.launches
    out = tuple(port(*_words(c), t(c["eps"]), *args(c, t), **_port_kw(c, J)))
    assert port.launches == before                 # CPU: the plain version
    again = ref(*_words(c), t(c["eps"]), *args(c, t), **_port_kw(c, J))
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert (out[0][N:] == 0).all()                 # pad lanes hold code 3
    q = c["q"]
    ker = jfn(q.XT, q.gram, q.xsq, jnp.asarray(c["eps_perm"]),
              *args(c, jnp.asarray), **_jax_kw(c, J))
    _assert_close(tuple(ker), out, c)
    if kind == "bayesr":
        assert (out[2] != t(c["labels"])).any()


@pytest.mark.parametrize("kind,C", [("bayesr", 3), ("bayesr", 6),
                                    ("horseshoe", 3), ("horseshoe", 6)])
def test_miss_mc_sweep_matches_jax_kernel_and_single_chains(kind, C):
    """C=3 reaches JAX's C <= 4 kernel, C=6 its mc8 kernel; JAX rtol 3e-4
    for the fused sweeps (tests/test_jacobi_t.py:455-460)."""
    J, B = 4, 16
    c = _rounds(_case(20 + C, B, 2 * J, 1, C), J)
    t = torch.as_tensor
    if kind == "bayesr":
        fused, single, jfn, args, per = (
            jacobi_t.bayesr_jacobi_t_mc, jacobi_t.bayesr_jacobi_t_reference,
            bayesr_jacobi_t_pallas_mc, _bayesr_args, (0, 1, 4, 5, 6, 8, 9))
    else:
        fused, single, jfn, args, per = (
            jacobi_t.horseshoe_jacobi_t_mc,
            jacobi_t.horseshoe_jacobi_t_reference,
            horseshoe_jacobi_t_pallas_mc, _hs_args, (0, 3, 4, 5, 6, 7))
    before = fused.launches
    out = tuple(fused(*_words(c), t(c["eps"]), *args(c, t),
                      **_port_kw(c, J)))
    assert fused.launches == before
    assert (out[0][:, N:] == 0).all()
    q = c["q"]
    ker = jfn(q.XT, q.gram, q.xsq, jnp.asarray(c["eps_perm"]),
              *args(c, jnp.asarray), **_jax_kw(c, J))
    _assert_close(tuple(ker), out, c, rtol=3e-4)
    for ch in range(C):
        one = single(*_words(c), t(c["eps"][ch]),
                     *[x[ch] if k in per else x
                       for k, x in enumerate(args(c, t))], **_port_kw(c, J))
        for k, (a, b) in enumerate(zip(one, out)):
            if a.dtype.is_floating_point:
                torch.testing.assert_close(a, b[ch], rtol=2e-4, atol=2e-5)
            else:
                assert torch.equal(a, b[ch]), k


def test_miss_mode_raises_on_dense_x():
    """Dense rows carry no missing calls: the miss mode needs 2-bit words
    (the JAX wrapper refuses it too, pallas_jacobi_t.py:_validate)."""
    c = _rounds(_case(5, 16, 8), 4)
    t = torch.as_tensor
    with pytest.raises(NotImplementedError, match="missing"):
        jacobi_t.bayesr_jacobi_t(torch.zeros((c["M"], N)), *_words(c)[1:],
                                 t(c["eps"])[:N], *_bayesr_args(c, t),
                                 J=4, missing=True)


# ------------------------------------------- the serial in-kernel decode


@pytest.mark.parametrize("kind,G,chunk", [("bayesr", 1, None),
                                          ("bayesr", 2, 3),
                                          ("horseshoe", 1, 3)])
def test_decode_serial_sweep_matches_jax_kernel(kind, G, chunk):
    """B=64, 8 blocks; ``max_call_blocks=3`` splits the sweep into chunks
    of 2, 3 and 3 blocks (which carry nothing but eps in this mode)."""
    c = _case(30 + G, 64, 8, G)
    t = torch.as_tensor
    if kind == "bayesr":
        port, ref, jfn, args = (serial.bayesr_sweep,
                                serial.bayesr_sweep_reference,
                                bayesr_sweep_pallas, _bayesr_args)
    else:
        port, ref, jfn, args = (serial.horseshoe_sweep,
                                serial.horseshoe_sweep_reference,
                                horseshoe_sweep_pallas, _hs_args)
    kw = dict(_port_kw(c), max_call_blocks=chunk)
    before = port.launches
    out = tuple(port(*_words(c), t(c["eps"]), *args(c, t), **kw))
    assert port.launches == before
    again = ref(*_words(c), t(c["eps"]), *args(c, t), **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert (out[0][N:] == 0).all()
    q = c["q"]
    ker = jfn(q.XT, q.gram, q.xsq, jnp.asarray(c["eps_perm"]),
              *args(c, jnp.asarray), **_jax_kw(c), max_call_blocks=chunk)
    _assert_close(tuple(ker), out, c)
    # the mode is one chain only: the fused sweep refuses it, as JAX's
    with pytest.raises(NotImplementedError, match="single-chain only"):
        from bayesrrcpp_tpu_torch.ops import multichain

        fn = (multichain.bayesr_sweep_mc if kind == "bayesr"
              else multichain.horseshoe_sweep_mc)
        fn(*_words(c), t(c["eps"][None]), *args(c, t), **kw)


# --------------------------------------------------------- the storage


def test_quantize_packed_with_missing_calls_matches_jax():
    """Pad lanes hold code 3 when the data has missing calls, a pad marker
    is an all-missing word (-1), and the statistics follow JAX's, with
    missing calls standardizing to 0."""
    rng = np.random.default_rng(3)
    M, Mpad, B = 200, 256, 32
    d = _dosage(rng, M)
    jq = jgen.quantize_packed(d, False, None, B, Mpad, N, prepacked=False)
    tq = tgen.quantize_packed(d, False, None, B, Mpad, N, prepacked=False,
                              device="cpu")
    assert tq.has_missing and jq.has_missing
    np.testing.assert_array_equal(tq.words.numpy(), np.asarray(jq.XT))
    codes = tgen.decode_codes(tq.words)
    assert (codes[:, N:] == tgen.MISSING_CODE).all()
    assert (tq.words[M:] == -1).all()
    scale = float(np.abs(np.asarray(jq.gram)).max())
    for name, ref in (("xsq", jq.xsq), ("gram", jq.gram),
                      ("x_colsum", jq.x_colsum)):
        np.testing.assert_allclose(getattr(tq, name).numpy(),
                                   np.asarray(ref), rtol=1e-5,
                                   atol=1e-5 * max(scale, N))


def test_has_missing_counts_real_markers_and_individuals_only():
    """Code 3 on the pad lanes (n >= N) or on pad markers (>= m_true) is
    not a missing call (bayesrrcpp_tpu/ops/genotypes.py:259-262)."""
    rng = np.random.default_rng(4)
    M, Mpad, B = 100, 128, 32
    d = rng.binomial(2, 0.4, size=(N, M)).astype(float)
    stats = (d.mean(axis=0), d.std(axis=0, ddof=1))
    words = tgen.pack_codes_host(d, False, stats, M, N)[0]
    words[:, -1] = -1                     # pad lanes only: code 3
    pre = tgen.quantize_packed(torch.as_tensor(words), True, stats, B, Mpad,
                               N, prepacked=True, device="cpu", m_true=M)
    assert not pre.has_missing
    assert not has_missing_calls(pre.words.numpy(), N, np.arange(Mpad) < M)
    words[7, 3] = 0b11 << 10              # individual 53 of marker 7
    pre = tgen.quantize_packed(torch.as_tensor(words), True, stats, B, Mpad,
                               N, prepacked=True, device="cpu", m_true=M)
    assert pre.has_missing
    assert has_missing_calls(pre.words.numpy(), N, np.arange(Mpad) < M)


def test_convert_carries_missing_data_across():
    """Words (pad codes included), column sums and has_missing of JAX data
    with missing calls."""
    import bayesrrcpp_tpu as jbr

    rng = np.random.default_rng(6)
    M = 96
    d = _dosage(rng, M)
    Y = rng.normal(size=N)
    js = jbr.SpikeSlabSampler(d, Y, CVA, jbr.BayesRConfig(block_size=16),
                              x_dtype="2bit", dtype=jnp.float32)
    assert js._x_miss
    data = data_from_jax({k: np.array(v) for k, v in
                          js.data._asdict().items()}, N=N, device="cpu")
    assert data.has_missing
    np.testing.assert_array_equal(data.XT.numpy(), np.asarray(js.data.XT))
    np.testing.assert_array_equal(data.x_colsum.numpy(),
                                  np.asarray(js.data.x_colsum))
    assert (tgen.decode_codes(data.XT)[:, N:] == 3).all()


def test_random_packed_words_missing_codes():
    """About 2**-6 of the fields are missing calls, at random; the other
    codes keep ``random_packed_words``' distribution (mean 1.25)."""
    g = torch.Generator().manual_seed(0)
    w = simulate.random_packed_words_missing(g, 400, 128, device="cpu",
                                             chunk_bytes=8192)
    c = tgen.decode_codes(w)
    share = float((c == 3).float().mean())
    assert abs(share - 1 / 64) < 0.002, share
    assert abs(float(c[c != 3].float().mean()) - 1.25) < 0.02
    q = tgen.quantize_packed(w, True, simulate.packed_word_stats(400), 16,
                             400, 2048, prepacked=True, device="cpu")
    assert q.has_missing
