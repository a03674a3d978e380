"""Long-chain f32 residual drift at the biobank shape (counterpart of
tools/drift_probe.py): run ``iters`` Gibbs iterations of the packed
headline configuration (N=100,352 x M=503,808 2-bit words, M/500 causal
markers, ``BayesRConfig(block_size=512)``: the auto plan J=128, B=32) and
every ``check_every`` iterations compare the TRACKED eps (rank-1 updates
inside the kernel) with a fresh exact recompute eps = Y - mu - X beta
(``SpikeSlabSampler.refresh_eps``).  The chain keeps sweeping the tracked
eps, so the drift accumulates undisturbed.

The f64 reference accrues no meaningful drift (src/BayesRv2.cpp:60); the
f32 engine's measured curve is what ``ChainConfig.eps_refresh_every``
(off by default, as in the JAX package) would be set against.

Run on the card:
    python -m bayesrrcpp_tpu_torch.tools.drift_probe [iters] [check_every] \
        [--out curve.json]
prints the curve, and writes it as JSON where ``--out`` says.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from .gpu_validation import CVA, packed_signal


def probe(iters: int = 1000, check_every: int = 100, N: int = 100_352,
          M: int = 503_808, *, words=None, device=None, out_path=None,
          log=print):
    """The drift curve: one point per ``check_every`` iterations.
    ``words`` (M, Npad/16) int32 (Npad: N padded to the word tile of
    2,048 lanes), already on a device, are used there without a copy;
    otherwise they are drawn on ``device`` from seed 0.  Writes the result as
    JSON to ``out_path`` when given; returns it."""
    from ..config import BayesRConfig
    from ..distributions import TorchVariates
    from ..models.bayesr import SpikeSlabSampler
    from ..ops.genotypes import padded_individuals
    from ..parallel.mesh import default_device
    from ..simulate import packed_word_stats, random_packed_words

    dev = default_device(device) if words is None else words.device
    nw = padded_individuals(N) // 16
    g = torch.Generator(device=dev).manual_seed(0)
    if words is None:
        words = random_packed_words(g, M, nw, device=dev)
    if tuple(words.shape) != (M, nw):
        raise ValueError(f"words {tuple(words.shape)}, want ({M}, {nw})")
    Y = packed_signal(g, words, N, M, max(1, M // 500))
    smp = SpikeSlabSampler(words, Y, CVA, BayesRConfig(block_size=512),
                           transposed=True, x_dtype="2bit",
                           x_stats=packed_word_stats(M), n_individuals=N,
                           device=dev)
    v = TorchVariates(torch.Generator(device=dev).manual_seed(1))
    state = smp.init(v)
    curve = []
    t0 = time.perf_counter()
    for it in range(0, iters, check_every):
        state = smp._run_steps(state, v, check_every)
        exact = smp.refresh_eps(state)
        num = float(torch.linalg.norm(state.eps - exact.eps))
        den = float(torch.linalg.norm(exact.eps))
        rel = num / max(den, 1e-30)
        curve.append({"iteration": it + check_every, "rel_drift": rel,
                      "abs_drift": num})
        log(f"iter {it + check_every:5d}  rel drift {rel:.3e}  "
            f"({time.perf_counter() - t0:.1f}s)")
    out = {"config": f"biobank packed N={N} M={M} f32",
           "plan": [smp.jacobi, smp.B, smp.jacobi_layout],
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "iters": iters, "check_every": check_every, "curve": curve,
           "max_rel_drift": max(c["rel_drift"] for c in curve),
           "seconds": time.perf_counter() - t0}
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path = argv[i + 1]
        del argv[i:i + 2]
    out = probe(*[int(x) for x in argv], out_path=out_path)
    print(json.dumps(out["curve"][-1]), "->", out_path or "(not written)")


if __name__ == "__main__":
    main()
