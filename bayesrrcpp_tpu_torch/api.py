"""Reference-compatible functional API.

Counterpart of ``bayesrrcpp_tpu/api.py`` for ``BayesRSamplerV2``
(src/BayesRv2.cpp:60, R/RcppExports.R:49) and ``HorseshoeR``
(src/HorseshoeR.cpp:109, R/RcppExports.R:74), with the same positional
signatures and defaults plus ``device``, which defaults to the card
("cuda"; without one they raise: pass ``device="cpu"`` to run on the CPU).
``seed`` seeds a ``torch.Generator`` on ``device``.  The dense blocked sweeps are plain
torch, as the JAX package runs them in XLA with no kernel.  The grouped
and warm-restart entry points keep their names and raise
``NotImplementedError`` until ROADMAP Queue 1 items 6 and 7 port them.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import BayesRConfig, ChainConfig, HorseshoeConfig
from .io.sink import CSVSink
from .models.bayesr import SpikeSlabSampler
from .models.horseshoe import HorseshoeSampler


def BayesRSamplerV2(outputFile, seed, max_iterations, burn_in, thinning,
                    X, Y, sigma0, v0E, s02E, v0G, s02G, cva,
                    *, backend="blocked", dtype=None, block_size=512,
                    emit_epsilon=True, device="cuda"):
    """BayesR sampler.  Streams post-burn-in thinned samples to
    ``outputFile`` in the reference CSV schema: iteration, mu, beta[1..M],
    sigmaE, sigmaG, comp[1..M], epsilon[1..N] (src/BayesRv2.cpp:16-37).
    Returns the final sampler state."""
    _check_dtype(dtype)
    cfg = BayesRConfig(sigma0=sigma0, v0E=v0E, s02E=s02E, v0G=v0G, s02G=s02G,
                       block_size=block_size, emit_epsilon=emit_epsilon)
    sampler = SpikeSlabSampler(X, Y, np.atleast_1d(cva), cfg,
                               backend=backend, device=device)
    return _run(sampler, "bayesr", outputFile, seed, max_iterations, burn_in,
                thinning, emit_epsilon)


def HorseshoeR(outputFile, seed, max_iterations, burn_in, thinning,
               X, Y, A, v0E, s02E, vL, vT, c2, vC, sC,
               *, backend="blocked", dtype=None, block_size=512,
               emit_epsilon=True, device="cuda"):
    """Regularized-horseshoe sampler.  Streams post-burn-in thinned
    samples to ``outputFile`` in the horseshoe CSV schema: iteration, mu,
    beta[1..M], sigmaE, tau, lambda[1..M], epsilon[1..N]
    (src/HorseshoeR.cpp:279-291).  Returns the final sampler state."""
    _check_dtype(dtype)
    cfg = HorseshoeConfig(A=A, v0E=v0E, s02E=s02E, vL=vL, vT=vT, c2=c2,
                          vC=vC, sC=sC, block_size=block_size,
                          emit_epsilon=emit_epsilon)
    sampler = HorseshoeSampler(X, Y, cfg, backend=backend, device=device)
    return _run(sampler, "horseshoe", outputFile, seed, max_iterations,
                burn_in, thinning, emit_epsilon)


def _check_dtype(dtype):
    if dtype not in (None, torch.float32):
        raise NotImplementedError(
            "bayesrrcpp_tpu_torch samples in float32 only")


def _run(sampler, schema, outputFile, seed, max_iterations, burn_in,
         thinning, emit_epsilon):
    chain = ChainConfig(max_iterations, burn_in, thinning)
    generator = torch.Generator(device=sampler.device).manual_seed(int(seed))
    sink = CSVSink(outputFile, schema, M=sampler.M, N=sampler.N,
                   emit_epsilon=emit_epsilon)
    try:
        state, _ = sampler.run(generator, chain, sink=sink, collect=False)
    finally:
        sink.close()
    return state


def _not_ported(name: str, entry: str):
    def entry_point(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to bayesrrcpp_tpu_torch yet "
            f"(ROADMAP Queue 1 {entry})")

    entry_point.__name__ = name
    entry_point.__doc__ = f"Not ported yet: ROADMAP Queue 1 {entry}."
    return entry_point


BayesRSamplerV2Groups = _not_ported("BayesRSamplerV2Groups", "item 6")
BRV2Grstart = _not_ported("BRV2Grstart", "item 7")
