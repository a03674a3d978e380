"""On-card validation of the sweep kernels (counterpart of
tools/tpu_validation.py, the same two checks at the same sizes).

The CPU tests run each kernel's plain torch version, so a fault that only
the compiled kernel has (a mispaired layout, a reduced-precision product)
is invisible to them by construction.  This script runs on the card:

1. ``oracle_agreement``: kernel #1 in its dense mode
   (``ops/jacobi_t.bayesr_jacobi_t`` on CUDA tensors) against its plain
   version ``bayesr_jacobi_t_reference`` on the same inputs, dense X of
   N=4,096 x M=4,096, B=32, J=16, from a warm state: labels must match
   exactly and max |d eps| < 1e-3;
2. ``chain_stability``: a packed 2-bit chain at N=49,152 x M=245,760 with
   491 causal markers, ``jacobi_blocks=16, jacobi_layout="t"``, B=32:
   sigmaE must stay finite and end below 2.0 (a layout fault made it
   explode within a few iterations on the TPU), and the tracked eps must
   agree with a fresh recompute (``refresh_eps``) to 1e-4 relative.

Both take ``device`` and their sizes, so the CPU tests run the same code
on the plain versions at a small size.

Run on the card:  python -m bayesrrcpp_tpu_torch.tools.gpu_validation [--quick]
(``--quick`` cuts the chain to 4 iterations); prints one JSON line.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

CVA = [0.0001, 0.001, 0.01]


def packed_signal(generator, words, N: int, M: int, n_causal: int):
    """The phenotype of the JAX tools' packed recipe on ``words`` (M,
    Npad/16) of N individuals:
    ``n_causal`` markers drawn from ``generator`` with effects
    N(0, 0.5 / n_causal), Y = X beta + noise of the genetic value's
    variance (floored at 1e-3).  Y needs real signal: a chain without it
    can reach m0 == 0 and draw sigmaG from an inv-scaled-chi^2 of ~0
    degrees of freedom.  Returns Y (N,) float32 on the words' device."""
    from ..ops.genotypes import xbeta_packed
    from ..simulate import packed_word_stats

    dev = words.device
    means, sds = packed_word_stats(M)
    beta = torch.zeros(M, device=dev)
    idx = torch.randperm(M, generator=generator, device=dev)[:n_causal]
    beta[idx] = torch.randn(n_causal, generator=generator, device=dev) \
        * float(np.sqrt(0.5 / n_causal))
    f32 = torch.float32
    g = xbeta_packed(words, torch.as_tensor(means, dtype=f32, device=dev),
                     torch.as_tensor(1.0 / sds, dtype=f32, device=dev),
                     beta, 512, N)
    noise = torch.randn(N, generator=generator, device=dev)
    return g + noise * torch.sqrt(torch.clamp(g.var(unbiased=False),
                                              min=1e-3))


def oracle_agreement(device=None, N: int = 4096, M: int = 4096, B: int = 32,
                     J: int = 16):
    """Kernel #1 in its dense mode against its plain version on the same
    warm inputs (tools/tpu_validation.py:32-75's recipe)."""
    from ..ops import block_sweep as bs
    from ..ops.jacobi_t import bayesr_jacobi_t, bayesr_jacobi_t_reference
    from ..parallel.mesh import default_device

    dev = default_device(device)
    rng = np.random.default_rng(33)
    f32 = torch.float32
    XT = torch.as_tensor(rng.standard_normal((M, N)).astype(np.float32),
                         device=dev)
    xsq = torch.sum(XT * XT, dim=1)
    gram = bs.gram_blocks(XT, B)
    eps = torch.as_tensor(rng.standard_normal(N).astype(np.float32),
                          device=dev)
    beta_np = (rng.normal(0, 0.05, M).astype(np.float32)
               * (rng.random(M) < 0.3))
    beta = torch.as_tensor(beta_np, device=dev)
    labels = torch.as_tensor((beta_np != 0).astype(np.int32)
                             * rng.integers(1, 4, M).astype(np.int32),
                             device=dev)
    g = torch.Generator(device=dev).manual_seed(34)
    p = torch.rand(M, generator=g, device=dev)
    z = torch.randn(M, generator=g, device=dev)
    pi = torch.tensor([[0.5, 0.2, 0.2, 0.1]], dtype=f32, device=dev)
    cva = torch.tensor([CVA], dtype=f32, device=dev)
    sigmaE = torch.tensor(0.8, dtype=f32, device=dev)
    sigmaGG = torch.tensor([0.05], dtype=f32, device=dev)
    gas = torch.zeros(M, dtype=torch.int32, device=dev)
    valid = torch.ones(M, dtype=torch.bool, device=dev)
    rho, inner = bs.strided_orders(torch.Generator(device=dev).manual_seed(11),
                                   M // B, B, J)
    args = (XT, gram, xsq, eps, beta, labels, rho, inner, p, z, pi, cva,
            sigmaE, sigmaGG, gas, valid)
    out = bayesr_jacobi_t(*args, J=J)
    ref = bayesr_jacobi_t_reference(*args, J=J)
    lab = float((out.labels == ref.labels).float().mean())
    emax = float((out.eps - ref.eps).abs().max())
    if lab != 1.0:
        raise AssertionError(f"label agreement {lab} != 1.0")
    if not emax < 1e-3:
        raise AssertionError(f"eps maxdiff {emax}")
    return {"labels_agree": lab, "eps_maxdiff": emax}


def chain_stability(iters: int = 8, device=None, N: int = 49152,
                    M: int = 245760, n_causal: int = 491, J: int = 16):
    """A packed chain through the strided kernel at J=16, B=32
    (tools/tpu_validation.py:77-110's recipe): sigmaE after each of
    ``iters`` iterations, and the tracked eps against ``refresh_eps``."""
    from ..config import BayesRConfig
    from ..distributions import TorchVariates
    from ..models.bayesr import SpikeSlabSampler
    from ..ops.genotypes import padded_individuals
    from ..parallel.mesh import default_device
    from ..simulate import packed_word_stats, random_packed_words

    dev = default_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    words = random_packed_words(g, M, padded_individuals(N) // 16,
                                device=dev)
    Y = packed_signal(g, words, N, M, n_causal)
    smp = SpikeSlabSampler(words, Y, CVA, BayesRConfig(block_size=32),
                           transposed=True, x_dtype="2bit",
                           x_stats=packed_word_stats(M), n_individuals=N,
                           jacobi_blocks=J, jacobi_layout="t", device=dev)
    v = TorchVariates(torch.Generator(device=dev).manual_seed(1))
    st = smp.init(v)
    tr = []
    for _ in range(iters):
        st = smp.step(st, v)
        tr.append(float(st.sigmaE))
    ex = smp.refresh_eps(st)
    rel = float(torch.linalg.norm(st.eps - ex.eps)
                / torch.linalg.norm(ex.eps))
    if not (all(np.isfinite(tr)) and tr[-1] < 2.0):
        raise AssertionError(f"chain diverged: sigmaE trajectory {tr}")
    if not rel < 1e-4:
        raise AssertionError(f"tracked eps inconsistent with recompute: "
                             f"{rel}")
    return {"sigmaE": [round(x, 4) for x in tr], "rel_eps": rel,
            "plan": [smp.jacobi, smp.B, smp.jacobi_layout]}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("gpu_validation needs the card (the CPU runs the "
                         "kernels' plain versions, which cannot show a "
                         "compiled kernel's faults)")
    quick = "--quick" in argv
    out = {
        "device": torch.cuda.get_device_name(0),
        "oracle_agreement_n4096": oracle_agreement(),
        "chain_stability_n49k": chain_stability(4 if quick else 8),
    }
    print(json.dumps(out))
    print("gpu_validation OK")


if __name__ == "__main__":
    main()
