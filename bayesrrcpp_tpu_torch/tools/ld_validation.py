"""Fixed-strided-partition validation under LD (counterpart of
tools/ld_validation.py).

The strided-rounds sweep co-updates the same J*B markers every iteration
(a fixed strided block partition, randomized only by the round visit
order and the within-block permutations).  The argument that this is
statistically benign -- same-round blocks sit ~M/J markers apart, far
beyond any LD correlation length -- carries weight only under CORRELATED
genotypes, which the iid recipes never test.

This tool generates AR(1)-correlated dosages (correlation length
~1/(1-rho)), runs the exact-sequential J=1 anchor and the auto
transposed plan, each as ``run_chains`` of 2 fused chains (the fused
serial kernel at J=1, the fused strided kernel on the auto plan), and
compares posterior means, PVE, split-R-hat and the lag-1-autocorrelation
ESS per marker.  ``ar1_dosages``, ``ess_lag1`` and ``split_rhat`` are
NumPy, the JAX tool's own recipes, copied so that the port imports
nothing of the JAX package.

Run on the card:
    python -m bayesrrcpp_tpu_torch.tools.ld_validation [N] [M] [rho] \
        [iters] [--out ld.json]
(defaults N=8,192, M=32,768, rho=0.9, 1,500 iterations, the JAX tool's);
prints the comparison, and writes it as JSON where ``--out`` says.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def ar1_dosages(seed, N, M, rho):
    """AR(1)-latent correlated dosage matrix: z_j = rho z_{j-1} + e,
    thresholded at allele-frequency quantiles into {0, 1, 2}; (N, M)
    float32.  The JAX tool's recipe on the same draws, computed marker-major
    (each marker's N latents contiguous, where the JAX tool walks strided
    columns): the same float32 operations on the same values, so the same
    bits, in ~60 % of the time."""
    rng = np.random.default_rng(seed)
    zt = np.empty((M, N), np.float32)
    zt[0] = rng.standard_normal(N)
    et = np.ascontiguousarray(
        rng.standard_normal((N, M)).astype(np.float32).T)
    s = np.sqrt(1.0 - rho * rho)
    for j in range(1, M):
        zt[j] = rho * zt[j - 1] + s * et[j]
    del et
    freqs = rng.uniform(0.2, 0.8, M)
    # genotype = #(latent > per-marker quantile) under HWE-ish cutoffs
    zs = np.sort(zt, axis=1)
    rows = np.arange(M)
    i1 = np.clip(((1.0 - freqs) * (N - 1)).astype(int), 0, N - 1)
    i2 = np.clip(((1.0 - freqs * freqs) * (N - 1)).astype(int), 0, N - 1)
    q1 = zs[rows, i1]
    q2 = zs[rows, i2]
    del zs
    dos = (zt > q1[:, None]).astype(np.float32) + \
        (zt > q2[:, None]).astype(np.float32)
    return np.ascontiguousarray(dos.T)


def ess_lag1(samples):
    """Per-marker ESS from lag-1 autocorrelation: S*(1-r1)/(1+r1)."""
    x = samples - samples.mean(axis=0, keepdims=True)
    v = (x * x).mean(axis=0) + 1e-30
    r1 = (x[1:] * x[:-1]).mean(axis=0) / v
    r1 = np.clip(r1, -0.99, 0.99)
    S = samples.shape[0]
    return S * (1.0 - r1) / (1.0 + r1)


def split_rhat(chains):
    """(S, C, M) -> per-marker split-R-hat."""
    S, C, M = chains.shape
    half = S // 2
    seq = chains[:2 * half].reshape(2, half, C, M).transpose(1, 0, 2, 3)
    seq = seq.reshape(half, 2 * C, M)
    mean_c = seq.mean(axis=0)
    W = seq.var(axis=0, ddof=1).mean(axis=0) + 1e-30
    Bv = half * mean_c.var(axis=0, ddof=1)
    var_plus = (half - 1) / half * W + Bv / half
    return np.sqrt(var_plus / W)


def run(N=8192, M=32_768, rho=0.9, iters=1500, seed=5, block=512, *,
        device=None, log=None):
    """J=1 against the auto "t" plan on AR(1) dosages; the JAX tool's keys
    (tools/ld_validation.py:111-137), plus ``config["device"]`` and each
    plan's seconds under ``per_config``.  ``log(msg)``: progress."""
    import torch

    from ..config import BayesRConfig, ChainConfig
    from ..models.bayesr import SpikeSlabSampler
    from ..parallel.mesh import default_device

    dev = default_device(device)
    t0 = time.perf_counter()
    dos = ar1_dosages(seed, N, M, rho)
    means = dos.mean(0)
    sds = np.maximum(dos.std(0, ddof=1), 1e-6)
    Xs = ((dos - means) / sds).astype(np.float32)
    del dos
    rng = np.random.default_rng(seed + 1)
    n_causal = max(8, M // 200)
    # clustered causal markers so LD actually matters for the posterior
    starts = rng.choice(M - 8, n_causal // 4, replace=False)
    idx = np.unique(np.concatenate([starts + k for k in range(4)]))
    bt = np.zeros(M, np.float32)
    bt[idx] = rng.normal(0, np.sqrt(0.5 / idx.size), idx.size)
    g = Xs @ bt
    Y = g + rng.normal(0, np.sqrt(max(g.var(), 1e-6)), N).astype(np.float32)
    data_s = time.perf_counter() - t0
    if log:
        log(f"AR(1) dosages N={N} M={M} rho={rho}: {data_s:.1f} s")

    burn = iters // 3
    thin = 2
    chain = ChainConfig(iters, burn, thin)
    out = {}
    for name, kw in (("J1", dict(jacobi_blocks=1)),
                     ("auto_t", dict(jacobi_layout="t"))):
        t1 = time.perf_counter()
        s = SpikeSlabSampler(Xs, Y, np.array([0.0001, 0.001, 0.01]),
                             BayesRConfig(block_size=block),
                             backend="pallas", dtype=torch.float32,
                             device=dev, **kw)
        _, res = s.run_chains(torch.Generator(device=dev).manual_seed(11),
                              2, chain)
        beta = np.asarray(res["beta"])          # (S, 2, M)
        bh = beta.mean(axis=(0, 1))
        gh = Xs @ bh
        pve = float(gh.var() / Y.var())
        rh = split_rhat(beta)
        ess = np.concatenate([ess_lag1(beta[:, c]) for c in range(2)])
        out[name] = {
            "jacobi": int(s.jacobi), "layout": s.jacobi_layout,
            "posterior_mean": bh, "pve": pve,
            "rhat_q99": float(np.quantile(rh, 0.99)),
            "rhat_max": float(rh.max()),
            "ess_mean": float(ess.mean()),
            "ess_causal_mean": float(np.concatenate(
                [ess_lag1(beta[:, c])[idx] for c in range(2)]).mean()),
            "corr_true": float(np.corrcoef(bt, bh)[0, 1]),
            "seconds": time.perf_counter() - t1,
        }
        if log:
            log(f"{name} (J={s.jacobi}, B={s.B}, {s.jacobi_layout}): "
                f"{iters} iterations of 2 fused chains in "
                f"{out[name]['seconds']:.1f} s")
        del s
    a, b = out["J1"], out["auto_t"]
    cmp = {
        "pair_posterior_corr": float(np.corrcoef(
            a["posterior_mean"], b["posterior_mean"])[0, 1]),
        "pve_J1": a["pve"], "pve_auto": b["pve"],
        "pve_rel_diff": abs(a["pve"] - b["pve"]) / max(a["pve"], 1e-9),
        "ess_ratio_auto_vs_J1": b["ess_mean"] / max(a["ess_mean"], 1e-9),
        "ess_causal_ratio": b["ess_causal_mean"] / max(
            a["ess_causal_mean"], 1e-9),
        "rhat_q99_J1": a["rhat_q99"], "rhat_q99_auto": b["rhat_q99"],
        "corr_true_J1": a["corr_true"], "corr_true_auto": b["corr_true"],
        "config": {"N": N, "M": M, "rho": rho, "iters": iters,
                   "J_auto": b["jacobi"], "data_s": data_s,
                   "device": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu")},
    }
    for v in out.values():
        v.pop("posterior_mean")
    cmp["per_config"] = out
    return cmp


def main(argv=None):
    a = list(sys.argv[1:] if argv is None else argv)
    out_path = None
    if "--out" in a:
        i = a.index("--out")
        out_path = a[i + 1]
        del a[i:i + 2]
    N = int(a[0]) if len(a) > 0 else 8192
    M = int(a[1]) if len(a) > 1 else 32_768
    rho = float(a[2]) if len(a) > 2 else 0.9
    iters = int(a[3]) if len(a) > 3 else 1500
    cmp = run(N=N, M=M, rho=rho, iters=iters, log=print)
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(cmp, f, indent=1)
    print(json.dumps({k: v for k, v in cmp.items() if k != "per_config"},
                     indent=1))


if __name__ == "__main__":
    main()
