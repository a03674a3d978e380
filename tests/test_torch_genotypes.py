"""The port's packed genotype storage (bayesrrcpp_tpu_torch/ops/genotypes.py
and simulate.py) against the JAX package, on the CPU.

Inputs are dosage matrices made with numpy from a seed.  Words are compared
bit for bit; the statistics to f32 summation order: rtol 1e-5 of the size
of the terms summed.  Off-diagonal Gram entries and column sums are sums of
+-terms that cancel to near 0 (the column sums of standardized data are 0
up to rounding), where a bound relative to the result itself means
nothing, so the bound is taken relative to the largest Gram entry (a
diagonal, sum of squares) and to N (a sum of N terms of size ~1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu.ops import genotypes as jgen
from bayesrrcpp_tpu_torch import simulate
from bayesrrcpp_tpu_torch.ops import genotypes as tgen

RTOL = 1e-5


def _dosage(seed, N, M, missing=False):
    rng = np.random.default_rng(seed)
    d = rng.binomial(2, rng.uniform(0.05, 0.95, M), size=(N, M)).astype(float)
    if missing:
        d[rng.random(d.shape) < 0.02] = np.nan
    return d


def _close(ref, out, scale=None):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("missing,stats", [(False, False), (True, False),
                                           (False, True)])
def test_pack_codes_host_words_bit_equal(missing, stats):
    N, M = 2100, 70          # N pads to 4096 lanes
    d = _dosage(1, N, M, missing)
    x_stats = None
    if stats:
        x_stats = (np.nanmean(d, axis=0), np.nanstd(d, axis=0, ddof=1))
    Mpad = 96
    j_codes, j_words, j_mean, j_scale, j_npad, j_miss = \
        jgen.pack_codes_host(d, False, x_stats, Mpad, N)
    t_words, t_mean, t_scale, t_npad, t_miss = \
        tgen.pack_codes_host(d, False, x_stats, Mpad, N)
    assert t_words.dtype == np.int32
    np.testing.assert_array_equal(t_words, j_words)
    np.testing.assert_array_equal(t_mean, j_mean)
    np.testing.assert_array_equal(t_scale, j_scale)
    assert (t_npad, t_miss) == (j_npad, j_miss)


def test_quantize_packed_stats_match_jax():
    N, M, B = 2000, 4096, 32
    d = _dosage(2, N, M)
    jq = jgen.quantize_packed(d, False, None, B, M, N, prepacked=False)
    tq = tgen.quantize_packed(d, False, None, B, M, N, prepacked=False,
                              device="cpu")
    np.testing.assert_array_equal(tq.words.numpy(), np.asarray(jq.XT))
    assert tq.Npad == jq.Npad and not tq.has_missing
    _close(jq.xsq, tq.xsq.numpy())
    _close(jq.gram, tq.gram.numpy())
    _close(jq.x_colsum, tq.x_colsum.numpy(), scale=N)
    np.testing.assert_array_equal(tq.x_mean.numpy(), np.asarray(jq.x_mean))
    # row_valid in individual order == the JAX mask un-permuted
    perm = np.asarray(jq.n_perm)
    rv = np.zeros(jq.Npad, bool)
    rv[perm] = np.asarray(jq.row_valid)
    np.testing.assert_array_equal(tq.row_valid.numpy(), rv)


def test_prepacked_words_give_the_host_path_stats():
    """Pre-packed words on the device (with a marker pad) and host dosages
    build the same statistics."""
    N, M, B, Mpad = 2000, 500, 32, 512
    d = _dosage(3, N, M)
    stats = (d.mean(axis=0), d.std(axis=0, ddof=1))
    host = tgen.quantize_packed(d, False, stats, B, Mpad, N, prepacked=False,
                                device="cpu")
    words = torch.as_tensor(
        tgen.pack_codes_host(d, False, stats, M, N)[0])
    pre = tgen.quantize_packed(words, True, stats, B, Mpad, N,
                               prepacked=True, device="cpu", m_true=M)
    for name in ("xsq", "gram", "x_colsum", "x_mean", "x_scale"):
        np.testing.assert_allclose(getattr(pre, name).numpy(),
                                   getattr(host, name).numpy(), rtol=1e-6,
                                   atol=1e-4, err_msg=name)
    assert not pre.has_missing
    assert (pre.words[M:] == -1).all()


def test_missing_calls_are_detected():
    d = _dosage(4, 300, 64, missing=True)
    q = tgen.quantize_packed(d, False, None, 32, 64, 300, prepacked=False,
                             device="cpu")
    assert q.has_missing


def test_xbeta_packed_matches_jax():
    N, M, B = 2000, 4096, 32
    d = _dosage(5, N, M)
    jq = jgen.quantize_packed(d, False, None, B, M, N, prepacked=False)
    beta = np.random.default_rng(6).normal(0, 0.1, M).astype(np.float32)
    ref = jgen.xbeta_packed(jq.XT, jq.x_mean, jq.x_scale, jnp.asarray(beta),
                            B, N)
    out = tgen.xbeta_packed(torch.as_tensor(np.array(jq.XT)),
                            torch.as_tensor(np.array(jq.x_mean)),
                            torch.as_tensor(np.array(jq.x_scale)),
                            torch.as_tensor(beta), B, N)
    assert out.shape == (N,)
    _close(ref, out.numpy())


def test_lane_perm_matches_jax():
    for Npad in (2048, 4096, 100_352):
        np.testing.assert_array_equal(tgen.lane_perm(Npad),
                                      jgen._lane_perm(Npad))


def test_random_packed_words_codes():
    """Codes in {0, 1, 2} with P = 1/4, 1/4, 1/2 (mean 1.25, the stats of
    ``packed_word_stats``); never the missing code 3.  Chunking does not
    change the stream's semantics."""
    g = torch.Generator().manual_seed(0)
    w = simulate.random_packed_words(g, 300, 64, device="cpu",
                                     chunk_bytes=4096)
    c = tgen.decode_codes(w)
    assert not (c == 3).any()
    assert abs(float(c.float().mean()) - 1.25) < 0.02
    means, sds = simulate.packed_word_stats(300)
    assert abs(float(c.float().std()) - sds[0]) < 0.02 and means[0] == 1.25
