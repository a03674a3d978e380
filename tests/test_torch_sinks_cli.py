"""The port's columnar sinks and the CLI surface of ROADMAP Queue 1 item 9
against the JAX package, on the CPU.

- ``NpzSink``, ``TeeSink`` and ``MemorySink`` (io/sink.py) against JAX's
  (bayesrrcpp_tpu/io/sink.py:173-237) on the same emission chunks: the
  same .npz arrays (every field concatenated over the emissions, written
  by ``np.savez_compressed``), the tee's CSV the same values, the memory
  sink's result equal.
- ``bayesr`` and ``horseshoe --dtype f64 --no-standardize --npz-out`` of
  the port (``--device cpu``) and of JAX's CLI on the same .npy data
  (N=120, M=48, 6 iterations): the same CSV widths and rows, the same .npz
  keys and shapes, the .npz rows equal to the CSV's as parsed, float64
  throughout; the horseshoe's decile lines in JAX's format.
- ``summarize --npz a --npz b --x --y --top``: the port's JSON equals
  JAX's on the same files (the port's two chains of 5 draws, JAX's two,
  and one chain).
"""
import json
import re

import numpy as np
import pytest

from bayesrrcpp_tpu import cli as jcli
from bayesrrcpp_tpu.io import sink as jsink
from bayesrrcpp_tpu_torch import cli, simulate
from bayesrrcpp_tpu_torch.io import sink as tsink

N, M = 120, 48
BASE = ["--iterations", "6", "--burn-in", "2", "--thinning", "2",
        "--block-size", "16", "--dtype", "f64", "--no-standardize"]
DECILE = re.compile(r"^emitted (\d+)/(\d+): tau (\S+) eta (\S+) sigmaE (\S+)$")


def _chunks(seed=0):
    rng = np.random.default_rng(seed)
    return [{"iteration": np.arange(i, i + n) * 2,
             "mu": rng.normal(size=n), "beta": rng.normal(size=(n, M)),
             "sigmaE": rng.random(n), "sigmaG": rng.random(n),
             "comp": rng.integers(0, 4, (n, M)).astype(np.int8),
             "epsilon": rng.normal(size=(n, N))}
            for i, n in ((0, 3), (3, 2))]


def test_sinks_match_jax(tmp_path):
    chunks = _chunks()
    out = {}
    for name, mod in (("t", tsink), ("j", jsink)):
        npz = mod.NpzSink(str(tmp_path / f"{name}.npz"))
        tee = mod.TeeSink(mod.CSVSink(str(tmp_path / f"{name}.csv"), "bayesr",
                                      M=M, N=N),
                          mod.NpzSink(str(tmp_path / f"{name}_tee.npz")))
        mem = mod.MemorySink()
        for c in chunks:
            for s in (npz, tee, mem):
                s.write(c)
        tee.flush()
        out[name] = mem.result()
        for s in (npz, tee, mem):
            s.close()
    assert sorted(out["t"]) == sorted(out["j"]) == sorted(chunks[0])
    for k in chunks[0]:
        np.testing.assert_array_equal(out["t"][k], out["j"][k])
    for f in ("", "_tee"):
        with np.load(tmp_path / f"t{f}.npz") as t, \
                np.load(tmp_path / f"j{f}.npz") as j:
            assert sorted(t.files) == sorted(j.files)
            for k in t.files:
                assert t[k].dtype == j[k].dtype
                np.testing.assert_array_equal(t[k], j[k])
    ct = np.loadtxt(tmp_path / "t.csv", delimiter=",", skiprows=1)
    cj = np.loadtxt(tmp_path / "j.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(ct, cj)
    assert ct.shape == (5, 2 + 2 * M + 2 + N)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    sim = simulate.simulate_bayesr(seed=4, N=N, M=M, n_causal=6, h2=0.5)
    np.save(d / "x.npy", sim.X)
    np.save(d / "y.npy", sim.Y)
    return d


def _csv(path):
    with open(path) as f:
        header = f.readline().rstrip("\n").split(",")
        rows = np.array([[float(v) for v in r.split(", ")]
                         for r in f.read().split("\n") if r])
    return header, rows


def _run(main, kind, d, tag, seed, extra=()):
    argv = [kind, "--x", str(d / "x.npy"), "--y", str(d / "y.npy"),
            "--out", str(d / f"{tag}.csv"), "--npz-out",
            str(d / f"{tag}.npz"), "--seed", str(seed), *BASE, *extra]
    assert main(argv) == 0
    return _csv(d / f"{tag}.csv"), dict(np.load(d / f"{tag}.npz"))


@pytest.mark.parametrize("kind", ["bayesr", "horseshoe"])
def test_cli_f64_npz_out_matches_jax(kind, files, capsys):
    (th, trows), tz = _run(cli.main, kind, files, f"t_{kind}", 1,
                           ("--device", "cpu"))
    tout = capsys.readouterr().out
    (jh, jrows), jz = _run(jcli.main, kind, files, f"j_{kind}", 1)
    jout = capsys.readouterr().out
    assert th == jh and trows.shape == jrows.shape == (2, len(th))
    assert sorted(tz) == sorted(jz)
    for k in jz:
        assert tz[k].shape == jz[k].shape, k
        if np.issubdtype(jz[k].dtype, np.floating):
            assert tz[k].dtype == jz[k].dtype == np.float64, k
    # the .npz rows are the CSV's, as parsed
    np.testing.assert_array_equal(trows[:, 0], tz["iteration"])
    np.testing.assert_array_equal(trows[:, 2:2 + M], tz["beta"])
    np.testing.assert_array_equal(trows[:, -N:], tz["epsilon"])
    if kind == "horseshoe":
        lines = [[ln for ln in out.splitlines() if DECILE.match(ln)]
                 for out in (tout, jout)]
        assert len(lines[0]) == len(lines[1]) >= 1
        for a, b in zip(*lines):
            assert DECILE.match(a).groups()[:2] == DECILE.match(b).groups()[:2]


def test_summarize_matches_jax(files, capsys):
    more = ("--iterations", "12")          # 5 draws: split R-hat takes 4
    for seed in (1, 2):
        _run(cli.main, "bayesr", files, f"s{seed}", seed,
             ("--device", "cpu", *more))
        _run(jcli.main, "bayesr", files, f"js{seed}", seed, more)
    capsys.readouterr()
    for tags in (("s1", "s2"), ("js1", "js2"), ("s1",)):
        argv = ["summarize"]
        for t in tags:
            argv += ["--npz", str(files / f"{t}.npz")]
        argv += ["--x", str(files / "x.npy"), "--y", str(files / "y.npy"),
                 "--top", "5"]
        outs = []
        for main in (cli.main, jcli.main):
            assert main(argv) == 0
            outs.append(json.loads(capsys.readouterr().out))
        assert outs[0] == outs[1]
        assert len(outs[0]["top_markers"]) == 5 and "pve" in outs[0]
        assert ("rhat_sigmaE" in outs[0]) == (len(tags) > 1)
