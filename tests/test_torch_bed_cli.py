"""The port's PLINK .bed ingestion (bayesrrcpp_tpu_torch/io/bed.py) against
the JAX package, and its command-line interface end to end, on the CPU.

- ``write_bed`` writes the JAX writer's bytes; ``read_bed_packed`` gives
  JAX's words, means, sds and ``has_missing`` bit for bit, with and without
  missing calls, over a ``marker_range``, with ``mpad="auto"``, and from
  its NumPy decoder as from the native one; ``read_bed`` gives JAX's dense
  matrix.
- ``python -m bayesrrcpp_tpu_torch bayesr|horseshoe --bed ... --x-dtype
  2bit --device cpu`` on a .bed with missing calls: the CSV header is the
  reference schema's and every row has its width; ``--chains 2`` writes
  one CSV per chain; ``groups``, ``resume``, the checkpoint flags and
  ``--npz-out`` run.

Inputs are dosages made with numpy from a seed, N=1501 (the trailing
.bed byte and the pad lanes are partly filled).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from bayesrrcpp_tpu.io import bed as jbed
from bayesrrcpp_tpu_torch import cli
from bayesrrcpp_tpu_torch.io import bed as tbed
from bayesrrcpp_tpu_torch.io import native
from bayesrrcpp_tpu_torch.io.sink import csv_header

N = 1501
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dosage(seed, M, missing):
    rng = np.random.default_rng(seed)
    d = rng.binomial(2, rng.uniform(0.1, 0.9, M), size=(N, M)).astype(float)
    if missing:
        d[rng.random(d.shape) < 0.03] = np.nan
    return d


@pytest.fixture
def cohort(tmp_path):
    """A .bed with missing calls written by the JAX writer, and a
    phenotype file."""
    prefix = str(tmp_path / "cohort")
    jbed.write_bed(prefix, _dosage(1, 300, True))
    np.savetxt(str(tmp_path / "y.txt"),
               np.random.default_rng(2).standard_normal(N))
    return prefix, str(tmp_path / "y.txt")


def test_write_bed_matches_jax(tmp_path, monkeypatch):
    d = _dosage(3, 37, True)
    jbed.write_bed(str(tmp_path / "j"), d)
    monkeypatch.setattr(tbed, "_WRITE_CHUNK", 5)        # 8 blocks
    tbed.write_bed(str(tmp_path / "t"), d)
    for ext in (".bed", ".bim", ".fam"):
        assert ((tmp_path / f"j{ext}").read_bytes()
                == (tmp_path / f"t{ext}").read_bytes()), ext
    with pytest.raises(ValueError, match="dosages"):
        tbed.write_bed(str(tmp_path / "bad"), d + 0.5)


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("part", ["whole", "range_auto"])
def test_read_bed_packed_matches_jax(tmp_path, missing, part):
    prefix = str(tmp_path / "g")
    jbed.write_bed(prefix, _dosage(4, 300, missing))
    kw = ({} if part == "whole"
          else dict(marker_range=(37, 251), mpad="auto"))
    ref = jbed.read_bed_packed(prefix, **kw)
    out = tbed.read_bed_packed(prefix, **kw)
    assert out.has_missing is ref.has_missing is missing
    for name in ("words", "means", "sds", "snp_ids", "sample_ids"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name),
                                      err_msg=name)
    assert out.n == ref.n == N
    if part == "range_auto":
        assert out.words.shape[0] == 256 and (out.words[214:] == -1).all()
    if missing:
        # the pad lanes hold the missing code: every field 3 in the words
        # past individual N
        assert (out.words[:, -1] == -1).all()


def test_numpy_decoder_matches_native(tmp_path, monkeypatch):
    """The NumPy decoder gives the native decoder's words and stats (and
    JAX's: both packages share native/bedreader.cpp)."""
    prefix = str(tmp_path / "g")
    jbed.write_bed(prefix, _dosage(5, 64, True))
    if native.get_native_bed() is None:
        pytest.skip("native/libbedreader.so does not build here")
    ref = tbed.read_bed_packed(prefix, mpad=96)
    monkeypatch.setattr(native, "get_native_bed", lambda: None)
    out = tbed.read_bed_packed(prefix, mpad=96)
    np.testing.assert_array_equal(out.words, ref.words)
    np.testing.assert_allclose(out.means, ref.means, rtol=1e-12)
    np.testing.assert_allclose(out.sds, ref.sds, rtol=1e-12)
    assert out.has_missing and ref.has_missing


def test_read_bed_dense_matches_jax(cohort):
    prefix, _ = cohort
    ref, out = jbed.read_bed(prefix), tbed.read_bed(prefix)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name),
                                      err_msg=name)


def _read_csv(path):
    with open(path) as f:
        header = f.readline()
        rows = [r for r in f.read().split("\n") if r]
    return header, rows


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_cli_runs_a_bed_with_missing_calls(cohort, tmp_path, kind):
    prefix, pheno = cohort
    out = str(tmp_path / f"{kind}.csv")
    rc = cli.main([kind, "--bed", prefix, "--pheno", pheno, "--x-dtype",
                   "2bit", "--out", out, "--iterations", "6", "--burn-in",
                   "2", "--thinning", "2", "--device", "cpu", "--seed", "5"])
    assert rc == 0
    header, rows = _read_csv(out)
    assert header == csv_header(kind, 300, N)
    width = 2 + 2 * 300 + 2 + N
    assert [len(r.split(", ")) for r in rows] == [width] * 2
    assert not any("nan" in r for r in rows)
    assert [float(r.split(", ")[0]) for r in rows] == [2, 4]


def test_cli_chains_write_one_csv_each(cohort, tmp_path):
    prefix, pheno = cohort
    out = str(tmp_path / "run.csv")
    rc = cli.main(["bayesr", "--bed", prefix, "--pheno", pheno, "--x-dtype",
                   "2bit", "--out", out, "--iterations", "4", "--burn-in",
                   "2", "--thinning", "2", "--device", "cpu", "--chains", "2",
                   "--no-epsilon"])
    assert rc == 0
    for c in range(2):
        header, rows = _read_csv(str(tmp_path / f"run.chain{c}.csv"))
        assert header == csv_header("bayesr", 300, N, emit_epsilon=False)
        assert len(rows) == 1


def test_cli_module_entry_point(cohort, tmp_path):
    """``python -m bayesrrcpp_tpu_torch`` reads the dense .bed path too."""
    prefix, pheno = cohort
    out = str(tmp_path / "dense.csv")
    res = subprocess.run(
        [sys.executable, "-m", "bayesrrcpp_tpu_torch", "bayesr", "--bed",
         prefix, "--pheno", pheno, "--out", out, "--iterations", "3",
         "--burn-in", "1", "--thinning", "2", "--device", "cpu",
         "--block-size", "64"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    header, rows = _read_csv(out)
    assert header == csv_header("bayesr", 300, N) and len(rows) == 1


@pytest.mark.parametrize("argv,entry", [
    (["groups", "--bed", "x"], "Queue 1 item 6"),
    (["resume", "--checkpoint", "ck.npz"], "Queue 1 item 7"),
    (["bayesr", "--out", "o.csv", "--checkpoint-out", "ck"],
     "Queue 1 item 7"),
    (["horseshoe", "--out", "o.csv", "--checkpoint-every", "60"],
     "Queue 1 item 7"),
    (["bayesr", "--out", "o.csv", "--npz-out", "o.npz"], "Queue 1 item 9"),
])
def test_cli_outside_the_port_raises(argv, entry, cohort, tmp_path):
    """Items 6, 7 and 9 of Queue 1 are ported: each of these calls runs on
    the .bed (2-bit words with missing calls) and writes its CSV
    (``resume`` from the checkpoint of a ``bayesr`` run; ``x`` the cohort),
    ``--npz-out`` (item 9) also the .npz of the CSV's rows;
    tests/test_torch_resume.py and test_torch_sinks_cli.py hold what they
    compute."""
    prefix, pheno = cohort
    at = {"x": prefix, "o.csv": str(tmp_path / "o.csv"),
          "ck.npz": str(tmp_path / "ck.npz"), "ck": str(tmp_path / "ck"),
          "o.npz": str(tmp_path / "o.npz")}
    argv = [at.get(a, a) for a in argv]
    run = ["--bed", prefix, "--pheno", pheno, "--x-dtype", "2bit",
           "--iterations", "4", "--burn-in", "2", "--thinning", "2",
           "--device", "cpu", "--no-epsilon"]
    if argv[0] == "groups":
        groups = str(tmp_path / "g.txt")
        np.savetxt(groups, np.arange(300) % 3, fmt="%d")
        argv += ["--pheno", pheno, "--x-dtype", "2bit", "--out", at["o.csv"],
                 "--groups-file", groups, "--iterations", "4", "--burn-in",
                 "2", "--thinning", "2", "--device", "cpu", "--no-epsilon"]
        schema = csv_header("groups", 300, N, groups=3, emit_epsilon=False)
    elif argv[0] == "resume":
        assert cli.main(["bayesr", "--out", str(tmp_path / "a.csv"),
                         "--checkpoint-out", at["ck.npz"]] + run) == 0
        argv += ["--out", at["o.csv"]] + run
        schema = csv_header("bayesr", 300, N, emit_epsilon=False)
    else:
        argv += run
        schema = csv_header(argv[0], 300, N, emit_epsilon=False)
    assert cli.main(argv) == 0
    header, rows = _read_csv(at["o.csv"])
    assert header == schema and len(rows) == 1
    assert len(rows[0].split(", ")) == len(header.split(","))
    if "--checkpoint-out" in argv:
        assert os.path.exists(at["ck"] + ".npz")
    if "--npz-out" in argv:
        with np.load(at["o.npz"]) as z:
            assert z["beta"].shape == (1, 300)
            assert z["iteration"].tolist() == [float(rows[0].split(", ")[0])]
