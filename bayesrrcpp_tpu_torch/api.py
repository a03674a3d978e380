"""Reference-compatible functional API.

Counterpart of ``bayesrrcpp_tpu/api.py``: ``BayesRSamplerV2``
(src/BayesRv2.cpp:60, R/RcppExports.R:49), ``BayesRSamplerV2Groups``
(src/BayesRv2Groups.cpp:75, R/RcppExports.R:70), ``BRV2Grstart``
(src/BRv2Grstart.cpp:77, R/RcppExports.R:25) and ``HorseshoeR``
(src/HorseshoeR.cpp:109, R/RcppExports.R:74), with the same positional
signatures and defaults plus ``device``, which defaults to the card
("cuda"; without one they raise: pass ``device="cpu"`` to run on the CPU).
``seed`` seeds a ``torch.Generator`` on ``device``.  ``dtype`` is the
state's, ``torch.float32`` (None) or ``torch.float64``.  The dense blocked
and scan sweeps are plain torch, as the JAX package runs them in XLA with
no kernel.  Each returns the final sampler state.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import BayesRConfig, ChainConfig, GroupsConfig, HorseshoeConfig
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
    dtype = _check_dtype(dtype)
    cfg = BayesRConfig(sigma0=sigma0, v0E=v0E, s02E=s02E, v0G=v0G, s02G=s02G,
                       block_size=block_size, emit_epsilon=emit_epsilon)
    sampler = SpikeSlabSampler(X, Y, np.atleast_1d(cva), cfg,
                               backend=backend, dtype=dtype,
                               device=device)
    return _run(sampler, "bayesr", outputFile, seed, max_iterations, burn_in,
                thinning, emit_epsilon)


def BayesRSamplerV2Groups(outputFile, seed, max_iterations, burn_in, thinning,
                          X, Y, sigma0, v0E, s02E, v0G, s02G, cva, groups,
                          gAssign, fixed,
                          *, backend="blocked", dtype=None, block_size=512,
                          emit_epsilon=True, device="cuda"):
    """Grouped BayesR sampler with fixed effects.  Streams post-burn-in
    thinned samples to ``outputFile`` in the groups CSV schema: iteration,
    mu, beta, sigmaE, comp, sigmaG[1..groups], epsilon, alpha[1..F], sigmaF
    (src/BayesRv2Groups.cpp:25-54).  Returns the final sampler state."""
    dtype = _check_dtype(dtype)
    cva = np.atleast_2d(cva)
    if cva.shape[0] != groups:
        raise ValueError("cva must have `groups` rows")
    cfg = GroupsConfig(sigma0=sigma0, v0E=v0E, s02E=s02E, v0G=v0G, s02G=s02G,
                       block_size=block_size, emit_epsilon=emit_epsilon)
    sampler = SpikeSlabSampler(X, Y, cva, cfg, g_assign=gAssign, fixed=fixed,
                               backend=backend, dtype=dtype,
                               device=device)
    return _run(sampler, "groups", outputFile, seed, max_iterations, burn_in,
                thinning, emit_epsilon, groups=groups)


def BRV2Grstart(outputFile, seed, max_iterations, burn_in, thinning,
                mu, beta, sigmaE, sigmaGG, X, epsilon, components,
                sigma0, v0E, s02E, v0G, s02G, cva, groups, gAssign,
                *, backend="blocked", dtype=None, block_size=512,
                emit_epsilon=True, device="cuda"):
    """Warm restart of a grouped chain from {mu, beta, sigmaE, sigmaGG,
    epsilon, components}; pi is drawn from the component counts
    (src/BRv2Grstart.cpp:157-165).  No fixed effects in this variant.
    CSV schema: iteration, mu, beta, sigmaE, comp, sigmaG, epsilon
    (src/BRv2Grstart.cpp:26-50).  Returns the final sampler state."""
    dtype = _check_dtype(dtype)
    cva = np.atleast_2d(cva)
    if cva.shape[0] != groups:
        raise ValueError("cva must have `groups` rows")
    # Y is no argument of the reference restart (epsilon carries the data);
    # the sampler needs Y at a fresh init only, so a zero placeholder
    Y_placeholder = np.zeros(np.shape(X)[0])
    cfg = GroupsConfig(sigma0=sigma0, v0E=v0E, s02E=s02E, v0G=v0G, s02G=s02G,
                       block_size=block_size, emit_epsilon=emit_epsilon)
    sampler = SpikeSlabSampler(X, Y_placeholder, cva, cfg, g_assign=gAssign,
                               backend=backend, dtype=dtype,
                               device=device)
    generator = _generator(sampler, seed)
    state = sampler.init_from(generator, mu=mu, beta=beta, sigmaE=sigmaE,
                              sigmaGG=sigmaGG, epsilon=epsilon,
                              components=components)
    return _run(sampler, "grstart", outputFile, generator, max_iterations,
                burn_in, thinning, emit_epsilon, groups=groups, state=state)


def HorseshoeR(outputFile, seed, max_iterations, burn_in, thinning,
               X, Y, A, v0E, s02E, vL, vT, c2, vC, sC,
               *, backend="blocked", dtype=None, block_size=512,
               emit_epsilon=True, device="cuda"):
    """Regularized-horseshoe sampler.  Streams post-burn-in thinned
    samples to ``outputFile`` in the horseshoe CSV schema: iteration, mu,
    beta[1..M], sigmaE, tau, lambda[1..M], epsilon[1..N]
    (src/HorseshoeR.cpp:279-291).  Returns the final sampler state."""
    dtype = _check_dtype(dtype)
    cfg = HorseshoeConfig(A=A, v0E=v0E, s02E=s02E, vL=vL, vT=vT, c2=c2,
                          vC=vC, sC=sC, block_size=block_size,
                          emit_epsilon=emit_epsilon)
    sampler = HorseshoeSampler(X, Y, cfg, backend=backend, dtype=dtype,
                               device=device)
    return _run(sampler, "horseshoe", outputFile, seed, max_iterations,
                burn_in, thinning, emit_epsilon)


def _check_dtype(dtype):
    """The state's dtype, float32 (None) or float64, as the JAX api's
    ``dtype=dtype or float32``."""
    if dtype not in (None, torch.float32, torch.float64):
        raise ValueError(f"dtype={dtype!r}: torch.float32 or torch.float64")
    return dtype or torch.float32


def _generator(sampler, seed):
    return torch.Generator(device=sampler.device).manual_seed(int(seed))


def _run(sampler, schema, outputFile, seed, max_iterations, burn_in,
         thinning, emit_epsilon, groups=0, state=None):
    """Run ``sampler`` from ``state`` (default: a fresh init) into the CSV
    of ``schema``; ``seed`` is an int or the generator to draw from."""
    chain = ChainConfig(max_iterations, burn_in, thinning)
    generator = (seed if isinstance(seed, torch.Generator)
                 else _generator(sampler, seed))
    sink = CSVSink(outputFile, schema, M=sampler.M, N=sampler.N,
                   groups=groups, F=getattr(sampler, "F", 0),
                   emit_epsilon=emit_epsilon)
    try:
        state, _ = sampler.run(generator, chain, state=state, sink=sink,
                               collect=False)
    finally:
        sink.close()
    return state
