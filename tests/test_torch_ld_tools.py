"""The port's validation tools on the CPU, where the sweeps run their plain
versions: ``tools/ld_validation.py``'s numpy helpers against the JAX
tool's (tools/ld_validation.py, bitwise: both are numpy), its ``run`` at a
small size (the JAX tool's keys, every value finite, the auto plan
strided), and ``tools/gpu_validation.py`` and ``tools/drift_probe.py`` at
N <= 1,024 with their gates (the same code the card runs at full size).

The LD run is cut to 12 iterations (4 samples a chain, the fewest that
split-R-hat takes): the plain fused serial sweep of the J=1 plan takes
~1.3 s an iteration at M=2,048 on the CPU."""
import ast
import importlib.util
import math
import pathlib

import numpy as np
import pytest

from bayesrrcpp_tpu_torch.tools import (drift_probe, gpu_validation,
                                        ld_validation)

JAX_TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
    "ld_validation.py"


@pytest.fixture(scope="module")
def jax_tool():
    """tools/ld_validation.py (its helpers are numpy; its ``run`` imports
    jax when called, which these tests do not)."""
    spec = importlib.util.spec_from_file_location("jax_ld_validation",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,N,M,rho", [(5, 300, 2048, 0.9),
                                          (0, 97, 130, 0.5),
                                          (11, 64, 33, 0.99)])
def test_ar1_dosages_bitwise(jax_tool, seed, N, M, rho):
    ours = ld_validation.ar1_dosages(seed, N, M, rho)
    theirs = jax_tool.ar1_dosages(seed, N, M, rho)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("S,C,M", [(40, 2, 17), (7, 3, 5), (200, 4, 64)])
def test_ess_and_split_rhat_bitwise(jax_tool, S, C, M):
    rng = np.random.default_rng(S * 31 + M)
    x = rng.normal(size=(S, C, M)).astype(np.float32)
    x[:, 0] += np.linspace(0, 1, S, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(ld_validation.split_rhat(x),
                                  jax_tool.split_rhat(x))
    for c in range(C):
        np.testing.assert_array_equal(ld_validation.ess_lag1(x[:, c]),
                                      jax_tool.ess_lag1(x[:, c]))


def _jax_keys():
    """The keys of the JAX tool's result, read from its source: the
    comparison dict ``cmp``, its ``config`` and each ``out[name]``."""
    tree = ast.parse(JAX_TOOL.read_text())
    run = next(n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "run")
    top = config = per = None
    for node in ast.walk(run):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Dict)):
            continue
        keys = [k.value for k in node.value.keys]
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == "cmp":
            top = keys
            cfg = node.value.values[keys.index("config")]
            config = [k.value for k in cfg.keys]
        elif isinstance(target, ast.Subscript):
            per = [k for k in keys if k != "posterior_mean"]
    return set(top) | {"per_config"}, set(config), set(per)


def _all_finite(x):
    if isinstance(x, dict):
        return all(_all_finite(v) for v in x.values())
    if isinstance(x, str):
        return True
    return math.isfinite(x)


def test_ld_run_small_returns_the_jax_keys():
    cmp = ld_validation.run(N=300, M=2048, rho=0.9, iters=12, seed=5,
                            block=32, device="cpu")
    top, config, per = _jax_keys()
    assert set(cmp) == top
    assert config <= set(cmp["config"])
    assert set(cmp["per_config"]) == {"J1", "auto_t"}
    for res in cmp["per_config"].values():
        assert per <= set(res)
    assert cmp["config"]["J_auto"] > 1          # the partition under test
    assert cmp["per_config"]["J1"]["jacobi"] == 1
    assert cmp["per_config"]["auto_t"]["layout"] == "t"
    assert _all_finite(cmp), cmp


def test_oracle_agreement_small():
    res = gpu_validation.oracle_agreement(device="cpu", N=256, M=512, J=16)
    assert res["labels_agree"] == 1.0 and res["eps_maxdiff"] < 1e-3


@pytest.mark.parametrize("N,M", [(1000, 4096), (600, 8192)])
def test_chain_stability_small(N, M):
    res = gpu_validation.chain_stability(4, device="cpu", N=N, M=M,
                                         n_causal=M // 500)
    assert res["plan"] == [16, 32, "t"]
    assert len(res["sigmaE"]) == 4 and res["rel_eps"] < 1e-4


@pytest.mark.parametrize("N,M,iters,every", [(1000, 4096, 8, 4),
                                             (300, 2048, 6, 3)])
def test_drift_probe_small(tmp_path, N, M, iters, every):
    path = tmp_path / "curve.json"
    out = drift_probe.probe(iters, every, N=N, M=M, device="cpu",
                            out_path=str(path), log=lambda msg: None)
    assert [c["iteration"] for c in out["curve"]] == list(
        range(every, iters + 1, every))
    assert all(math.isfinite(c["rel_drift"]) and c["rel_drift"] < 1e-3
               for c in out["curve"])
    assert out["plan"][2] == "t" and path.stat().st_size > 0


def test_gpu_validation_refuses_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        gpu_validation.main([])
