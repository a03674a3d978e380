"""Sampler configuration dataclasses.

The reference passes 13-20 positional arguments per sampler
(reference: src/RcppExports.cpp:110-116 registers the arities); here the same
hyperparameters keep their reference names inside frozen dataclasses so
reference call sites map 1:1.  Configs are hashable and used as jit static
arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """MCMC schedule shared by every sampler (reference: src/BayesRv2.cpp:60 args)."""

    max_iterations: int
    burn_in: int
    thinning: int = 1
    # Recompute eps = Y - mu - X beta (- F alpha) with one fresh X pass
    # every ~K iterations (applied at the nearest emission-chunk
    # boundary).  The f32 engine accumulates the residual by rank-1
    # updates; a periodic fresh dot bounds the drift the f64 reference
    # never accrues (src/BayesRv2.cpp:60 runs f64 end to end).  None
    # disables (measured drift at the biobank shape stays ~1e-6
    # relative over 1000+ iterations; see BENCH.md round 5).
    eps_refresh_every: "int | None" = None

    def __post_init__(self):
        if self.max_iterations < self.burn_in or self.max_iterations < 1 or self.burn_in < 1:
            # The only validation the reference hard-fails on (src/BayesRv2.cpp:76-80).
            raise ValueError(
                "burn_in has to be a positive integer and smaller than the maximum "
                "number of iterations"
            )
        if self.thinning < 1:
            raise ValueError("thinning must be >= 1")
        if self.eps_refresh_every is not None and self.eps_refresh_every < 1:
            raise ValueError("eps_refresh_every must be >= 1 or None")

    def emit_iterations(self) -> range:
        """Iterations whose post-update state is emitted.

        Reproduces the reference emission predicate
        ``iteration >= burn_in and iteration % thinning == 0``
        (src/BayesRv2.cpp:257-259).
        """
        first = -(-self.burn_in // self.thinning) * self.thinning
        return range(first, self.max_iterations, self.thinning)


@dataclasses.dataclass(frozen=True)
class BayesRConfig:
    """Hyperparameters of the ungrouped BayesR sampler (src/BayesRv2.cpp:60).

    ``cva`` (the K-1 slab variances) is passed to the sampler as an array, not
    stored here, so the config stays hashable.
    """

    sigma0: float = 0.01  # accepted-but-unused in the reference (mu prior variance)
    v0E: float = 0.001
    s02E: float = 0.001
    v0G: float = 0.001
    s02G: float = 0.001
    # --- compat switches for reference quirks (SURVEY.md section 2.3) ---
    # sigmaG ~ InvScaledChi2(v0G+m0, (|beta|^2 * m0 + v0G*s02G)/(v0G+m0)): the
    # non-standard `*m0` factor on |beta|^2 (src/BayesRv2.cpp:248).  True keeps
    # the reference behaviour; False uses the textbook scale (|beta|^2 + v0G*s02G).
    reference_sigma_g_scaling: bool = True
    # --- engine knobs (no reference analog) ---
    block_size: int = 512  # markers per Gram block in the blocked sweep
    emit_epsilon: bool = True  # the reference always emits the full N-vector


@dataclasses.dataclass(frozen=True)
class GroupsConfig:
    """Hyperparameters of the grouped sampler (src/BayesRv2Groups.cpp:75)."""

    sigma0: float = 0.01
    v0E: float = 0.001
    s02E: float = 0.001
    v0G: float = 0.001
    s02G: float = 0.001
    reference_sigma_g_scaling: bool = True
    # Reference inits priorPi rows to (0.5, 0.5/K, ...) which does NOT sum to 1
    # (src/BayesRv2Groups.cpp:170-175).  True reproduces that; False normalises.
    reference_prior_pi: bool = True
    block_size: int = 512
    emit_epsilon: bool = True


@dataclasses.dataclass(frozen=True)
class HorseshoeConfig:
    """Hyperparameters of the regularized-horseshoe sampler (src/HorseshoeR.cpp:109)."""

    A: float = 1.0       # global-scale half-Cauchy scale
    v0E: float = 0.001
    s02E: float = 0.001
    vL: float = 1.0      # local (lambda) dof
    vT: float = 1.0      # global (tau) dof
    c2: float = 1.0      # initial slab width^2 (resampled each iteration)
    vC: float = 10.0     # slab prior dof
    sC: float = 10.0     # slab prior scale
    block_size: int = 512
    emit_epsilon: bool = True
