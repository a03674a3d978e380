"""The port's int8 genotype storage (bayesrrcpp_tpu_torch/ops/genotypes.py:
``quantize_int8``, ``xbeta_int8``, ``int8_stats_local``), ``convert`` of
JAX int8 data and the CLI's ``--x-dtype int8``, against the JAX package on
the CPU.

- ``quantize_int8`` from dosages (NaN a missing call, code 3) and from
  codes with ``x_stats``: codes, pad markers (code 3, mean = scale = 0),
  mean and scale bit for bit, ``has_missing`` read before the padding;
  xsq, Gram blocks and column sums to f32 summation order (rtol 1e-5 of
  the size of the terms summed, as tests/test_torch_genotypes.py); an int8
  tensor of Mpad rows is used without a copy.
- ``xbeta_int8`` and ``int8_stats_local`` against JAX's.
- ``data_from_jax`` / ``horseshoe_data_from_jax`` /
  ``sharded_data_from_jax`` carry JAX int8 data across unchanged, and a
  sweep of the carried data equals a sweep of the port's own layout.
- ``python -m bayesrrcpp_tpu_torch bayesr|horseshoe --x-dtype int8
  --device cpu`` on a .bed with missing calls (read with NaN, not
  standardized, as JAX's cli.py:93-97) and on a dosage .npy: the CSV's
  bytes equal those of the same run through the API.

Inputs are dosages made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu.io import bed as jbed
from bayesrrcpp_tpu.ops import genotypes as jgen
from bayesrrcpp_tpu_torch import (BayesRConfig, ChainConfig, HorseshoeConfig,
                                  HorseshoeSampler, SpikeSlabSampler, cli)
from bayesrrcpp_tpu_torch.convert import (data_from_jax,
                                          horseshoe_data_from_jax,
                                          sharded_data_from_jax)
from bayesrrcpp_tpu_torch.io import bed as tbed
from bayesrrcpp_tpu_torch.io.sink import CSVSink
from bayesrrcpp_tpu_torch.ops import genotypes as tgen

RTOL = 1e-5
CVA = np.array([0.0001, 0.001, 0.01])


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


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("stats", [False, True])
def test_quantize_int8_matches_jax(missing, stats):
    N, M, Mpad, B = 501, 100, 128, 32
    d = _dosage(1 + missing + 2 * stats, N, M, missing)
    x_stats = None
    X = d
    if stats:
        x_stats = (np.nanmean(d, axis=0), np.nanstd(d, axis=0, ddof=1))
        X = np.where(np.isnan(d), 3, d).astype(np.int8)
    jq = jgen.quantize_int8(X, False, x_stats, B, Mpad)
    tq = tgen.quantize_int8(X, False, x_stats, B, Mpad, device="cpu")
    assert tq.codes.dtype == torch.int8
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.XT))
    assert (tq.codes[M:] == tgen.MISSING_CODE).all()
    np.testing.assert_array_equal(tq.x_mean.numpy(), np.asarray(jq.x_mean))
    np.testing.assert_array_equal(tq.x_scale.numpy(), np.asarray(jq.x_scale))
    assert (tq.x_mean[M:] == 0).all() and (tq.x_scale[M:] == 0).all()
    assert tq.has_missing == jq.has_missing == missing
    _close(jq.xsq, tq.xsq)
    _close(jq.gram, tq.gram)
    _close(jq.x_colsum, tq.x_colsum, scale=N)


def test_quantize_int8_device_codes_are_not_copied():
    """Marker-major int8 codes of Mpad rows with their stats: used as
    they are (the headline's 47 GiB of codes must not be copied)."""
    d = _dosage(3, 300, 64)
    codes = torch.as_tensor(np.ascontiguousarray(d.T, np.int8))
    stats = (d.mean(axis=0), d.std(axis=0, ddof=1))
    q = tgen.quantize_int8(codes, True, stats, 32, 64, device="cpu")
    assert q.codes.data_ptr() == codes.data_ptr()
    s = SpikeSlabSampler(codes, np.zeros(300), CVA, BayesRConfig(),
                         x_dtype="int8", transposed=True, x_stats=stats,
                         device="cpu")
    assert s.Mpad == 64 and s.data.XT.data_ptr() == codes.data_ptr()


def test_xbeta_int8_and_stats_local_match_jax():
    N, M, B = 400, 96, 32
    d = _dosage(4, N, M, missing=True)
    jq = jgen.quantize_int8(d, False, None, B, M)
    codes = torch.as_tensor(np.asarray(jq.XT))
    mean = torch.as_tensor(np.asarray(jq.x_mean))
    scale = torch.as_tensor(np.asarray(jq.x_scale))
    beta = np.random.default_rng(5).normal(0, 0.1, M).astype(np.float32)
    ref = jgen.xbeta_int8(jq.XT, jq.x_mean, jq.x_scale, jnp.asarray(beta), B)
    out = tgen.xbeta_int8(codes, mean, scale, torch.as_tensor(beta), B)
    _close(ref, out)
    jx, jg, js = jgen.int8_stats_local(jq.XT, jq.x_mean, jq.x_scale, B=B)
    tx, tg, ts = tgen.int8_stats_local(codes, mean, scale, B=B)
    _close(jx, tx)
    _close(jg, tg)
    _close(js, ts, scale=N)


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_convert_carries_int8_data(kind):
    """JAX int8 data carried across equals the port's own layout of the
    same dosages (codes, mean, scale bitwise; statistics to f32 sums), and
    a sweep of each gives the same state."""
    N, M, B = 300, 96, 16
    d = _dosage(6, N, M, missing=True)
    Y = np.random.default_rng(7).standard_normal(N)
    if kind == "bayesr":
        js = jbr.SpikeSlabSampler(d, Y, CVA, jbr.BayesRConfig(block_size=B),
                                  x_dtype="int8", dtype=jnp.float32)
        own = SpikeSlabSampler(d, Y, CVA, BayesRConfig(block_size=B),
                               x_dtype="int8", device="cpu")
        carry = data_from_jax
    else:
        js = jbr.HorseshoeSampler(d, Y, jbr.HorseshoeConfig(block_size=B),
                                  x_dtype="int8", dtype=jnp.float32)
        own = HorseshoeSampler(d, Y, HorseshoeConfig(block_size=B),
                               x_dtype="int8", device="cpu")
        carry = horseshoe_data_from_jax
    jd = {k: np.array(v) for k, v in js.data._asdict().items()}
    carried = carry(jd, N=N, device="cpu")
    for k in ("XT", "x_mean", "x_scale", "valid"):
        assert torch.equal(getattr(carried, k), getattr(own.data, k)), k
    assert carried.XT.dtype == torch.int8 and carried.has_missing
    assert carried.row_valid.numel() == 0
    _close(jd["xsq"], own.data.xsq)
    _close(jd["gram"], own.data.gram)
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    st2 = own.step(own.init(g2), g2)
    own.data = carried
    st1 = own.step(own.init(g1), g1)
    torch.testing.assert_close(st1.beta, st2.beta, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(st1.eps, st2.eps, rtol=2e-5, atol=2e-6)
    half = sharded_data_from_jax(
        dict(jd, g_assign=np.zeros(own.Mpad, np.int32),
             cva=np.asarray([CVA]), prior_pi=np.ones((1, 4)) / 4),
        N=N, Dm=2, m_index=1, device="cpu")
    np.testing.assert_array_equal(half.XT.numpy(), jd["XT"][own.Mpad // 2:])
    assert half.has_missing


def _csv_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("source", ["bed", "npy"])
@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_cli_int8_writes_the_api_csv(tmp_path, kind, source):
    N, M, B = 333, 80, 16
    d = _dosage(8, N, M, missing=True)
    Y = np.random.default_rng(9).standard_normal(N)
    if source == "bed":
        prefix = str(tmp_path / "g")
        jbed.write_bed(prefix, d)
        np.savetxt(str(tmp_path / "y.txt"), Y)
        inputs = ["--bed", prefix, "--pheno", str(tmp_path / "y.txt")]
        X = tbed.read_bed(prefix, standardize=False,
                          impute_missing=False).X
        Yapi = tbed.read_phenotype(str(tmp_path / "y.txt"))
    else:
        np.save(tmp_path / "x.npy", d)
        np.save(tmp_path / "y.npy", Y)
        inputs = ["--x", str(tmp_path / "x.npy"), "--y",
                  str(tmp_path / "y.npy")]
        X, Yapi = d, Y
    out = str(tmp_path / "cli.csv")
    assert cli.main([kind, *inputs, "--x-dtype", "int8", "--device", "cpu",
                     "--iterations", "6", "--burn-in", "2", "--thinning",
                     "2", "--block-size", str(B), "--seed", "5",
                     "--out", out]) == 0
    if kind == "bayesr":
        s = SpikeSlabSampler(X, Yapi, CVA, BayesRConfig(block_size=B),
                             x_dtype="int8", device="cpu")
    else:
        s = HorseshoeSampler(X, Yapi, HorseshoeConfig(block_size=B),
                             x_dtype="int8", device="cpu")
    assert s.data.has_missing and s.jacobi == 1
    api = str(tmp_path / "api.csv")
    sink = CSVSink(api, kind, M=s.M, N=s.N)
    s.run(torch.Generator().manual_seed(5), ChainConfig(6, 2, 2), sink=sink,
          collect=False)
    sink.close()
    assert _csv_bytes(out) == _csv_bytes(api)
    assert len(_csv_bytes(out).splitlines()) == 3
