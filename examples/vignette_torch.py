"""End-to-end walkthrough of the PyTorch port, mirroring the reference
vignette as examples/vignette.py does for the JAX package.

The reference package's only integration artifact is its R vignette
(reference: vignettes/BayesRR.Rmd), which runs three pipelines and checks
effect recovery and the proportion of variance explained (PVE) by hand:

1. plain BayesR on simulated genotypes        (vignettes/BayesRR.Rmd:89-101)
2. two-group BayesRR (genotype + methylation) (vignettes/BayesRR.Rmd:150-167)
3. groups + Gaussian fixed effects            (vignettes/BayesRR.Rmd:199-215)

then, as the reference documents separately, a grouped chain resumed from
its final state (src/BRv2Grstart.cpp:77); here the checkpoint carries the
torch generator, so the resumed chain is the uninterrupted one bit for bit.

The samplers run on ``--device`` (the card by default; ``--device cpu`` on
a machine without one) in ``--dtype`` (f32 by default, or f64):

    python examples/vignette_torch.py [--fast] [--device cpu] [--dtype f64]
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="shrink sizes and iterations (a smoke run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    args = ap.parse_args()

    import torch

    from bayesrrcpp_tpu_torch import (BayesRConfig, ChainConfig,
                                      GroupsConfig, SpikeSlabSampler,
                                      simulate)
    from bayesrrcpp_tpu_torch.io.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from bayesrrcpp_tpu_torch.utils import summary

    dev = args.device
    dt = torch.float64 if args.dtype == "f64" else torch.float32

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # vignette scale: N=5000 individuals, MT=2000 markers, 2000 iterations /
    # 1500 burn-in / thin 5 (vignettes/BayesRR.Rmd:35-44, 100)
    N, M = (800, 400) if args.fast else (5000, 2000)
    chain = (ChainConfig(300, 150, 5) if args.fast
             else ChainConfig(2000, 1500, 5))
    cva = np.array([0.0001, 0.001, 0.01])
    kw = dict(device=dev, dtype=dt)

    # ---- 1. plain BayesR ---------------------------------------------------
    sim = simulate.simulate_bayesr(seed=1, N=N, M=M, n_causal=M // 10, h2=0.5)
    s = SpikeSlabSampler(sim.X, sim.Y, cva, BayesRConfig(block_size=128), **kw)
    _, out = s.run(generator(1), chain)
    pm = summary.posterior_means(out)
    pve = summary.pve(out, sim.X, sim.Y)
    slope = np.polyfit(sim.beta_true, pm["beta"], 1)[0]
    h2_hat = summary.heritability_samples(out).mean()
    print(f"[1 plain   ] PVE={pve:.3f} (true h2={sim.h2:.3f})  "
          f"recovery slope={slope:.3f}  h2_hat={h2_hat:.3f}")

    # ---- 2. two annotation groups (the vignette's genotype+methylation) ----
    sim2 = simulate.simulate_bayesr(seed=2, N=N, M=M, n_causal=M // 10,
                                    h2=0.5, n_groups=2)
    cva2 = np.tile(cva, (2, 1))
    s2 = SpikeSlabSampler(sim2.X, sim2.Y, cva2, GroupsConfig(block_size=128),
                          g_assign=sim2.g_assign, **kw)
    _, out2 = s2.run(generator(2), chain)
    pve2 = summary.pve(out2, sim2.X, sim2.Y)
    print(f"[2 groups  ] PVE={pve2:.3f} (true h2={sim2.h2:.3f})  "
          f"sigmaG per group={np.asarray(out2['sigmaG']).mean(axis=0)}")

    # ---- 3. groups + Gaussian fixed effects --------------------------------
    sim3 = simulate.simulate_bayesr(seed=3, N=N, M=M, n_causal=M // 10,
                                    h2=0.5, n_groups=2, n_fixed=3)
    s3 = SpikeSlabSampler(sim3.X, sim3.Y, cva2, GroupsConfig(block_size=128),
                          g_assign=sim3.g_assign, fixed=sim3.fixed, **kw)
    g3 = generator(3)
    state3, out3 = s3.run(g3, chain)
    alpha_hat = np.asarray(out3["alpha"]).mean(axis=0)
    err = np.abs(alpha_hat - sim3.alpha_true).max()
    print(f"[3 fixed   ] alpha_true={np.round(sim3.alpha_true, 3)} "
          f"alpha_hat={np.round(alpha_hat, 3)} (max err {err:.3f})")

    # ---- 4. checkpoint + resume: the state and its generator, so the
    # resumed chain is the uninterrupted one bit for bit ---------------------
    with tempfile.TemporaryDirectory() as td:
        ckpt = str(Path(td) / "state.npz")
        save_checkpoint(ckpt, state3, g3)
        restored, g_r = load_checkpoint(ckpt, device=dev)
        more = ChainConfig(50, 1, 5)
        state_a, _ = s3.run(g3, more, state=state3.replace(iteration=0))
        state_r, out_r = s3.run(g_r, more,
                                state=restored.replace(iteration=0))
        same = bool(torch.equal(state_a.beta, state_r.beta))
        print(f"[4 restart ] resumed at iteration {restored.iteration}, "
              f"{out_r['mu'].shape[0]} more emissions, bitwise equal to the "
              f"uninterrupted chain: {same}")

    ok = pve > 0.3 and pve2 > 0.3 and slope > 0.6 and err < 0.15 and same
    print("vignette OK" if ok else "vignette CHECK FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
