"""Reference-compatible functional API.

Counterpart of ``bayesrrcpp_tpu/api.py`` for ``BayesRSamplerV2``
(src/BayesRv2.cpp:60, R/RcppExports.R:49), with the same positional
signature and defaults.  ``seed`` seeds a ``torch.Generator`` on
``device``.  The dense blocked sweep is plain torch, as the JAX package
runs it in XLA with no kernel.  The grouped, warm-restart and horseshoe
entry points keep their names and raise ``NotImplementedError`` until
ROADMAP Queue 1 items 7, 6 and 8 port them.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import BayesRConfig, ChainConfig
from .io.sink import CSVSink
from .models.bayesr import SpikeSlabSampler


def BayesRSamplerV2(outputFile, seed, max_iterations, burn_in, thinning,
                    X, Y, sigma0, v0E, s02E, v0G, s02G, cva,
                    *, backend="blocked", dtype=None, block_size=512,
                    emit_epsilon=True, device="cpu"):
    """BayesR sampler.  Streams post-burn-in thinned samples to
    ``outputFile`` in the reference CSV schema: iteration, mu, beta[1..M],
    sigmaE, sigmaG, comp[1..M], epsilon[1..N] (src/BayesRv2.cpp:16-37).
    Returns the final sampler state."""
    if dtype not in (None, torch.float32):
        raise NotImplementedError(
            "bayesrrcpp_tpu_torch samples in float32 only")
    cfg = BayesRConfig(sigma0=sigma0, v0E=v0E, s02E=s02E, v0G=v0G, s02G=s02G,
                       block_size=block_size, emit_epsilon=emit_epsilon)
    sampler = SpikeSlabSampler(X, Y, np.atleast_1d(cva), cfg,
                               backend=backend, device=device)
    chain = ChainConfig(max_iterations, burn_in, thinning)
    generator = torch.Generator(device=sampler.device).manual_seed(int(seed))
    sink = CSVSink(outputFile, "bayesr", M=sampler.M, N=sampler.N,
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


BayesRSamplerV2Groups = _not_ported("BayesRSamplerV2Groups", "item 7")
BRV2Grstart = _not_ported("BRV2Grstart", "item 6")
HorseshoeR = _not_ported("HorseshoeR", "item 8")
