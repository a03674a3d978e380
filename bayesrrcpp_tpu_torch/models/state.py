"""Sampler state.

Counterpart of ``bayesrrcpp_tpu/models/state.py``: the tensors of one
BayesR or horseshoe chain.  The JAX state carries its PRNG key; here the
randomness lives in the variates object the caller passes to each step
(``distributions.TorchVariates``), and the iteration count is a host int,
so reading it never waits for the device.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SpikeSlabState:
    """State of the BayesR spike-and-slab sampler (C1).

    Marker-axis tensors are padded to Mpad; padding entries stay zero.
    In packed mode eps is (Npad,) in individual order with zero pad lanes.
    """

    iteration: int          # number of *completed* Gibbs iterations
    mu: torch.Tensor        # scalar intercept
    beta: torch.Tensor      # (Mpad,) marker effects
    labels: torch.Tensor    # (Mpad,) int32 mixture component labels
    eps: torch.Tensor       # (N,) or (Npad,) residuals Y - mu - X beta
    sigmaE: torch.Tensor    # scalar residual variance
    sigmaGG: torch.Tensor   # (G,) genetic variances (G=1 ungrouped)
    pi: torch.Tensor        # (G, K) mixture probabilities
    alpha: torch.Tensor     # (F,) fixed effects
    sigmaF: torch.Tensor    # scalar fixed-effect variance

    def replace(self, **changes) -> "SpikeSlabState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class HorseshoeState:
    """State of the regularized-horseshoe sampler (C4,
    src/HorseshoeR.cpp:137-157); layout as ``SpikeSlabState``."""

    iteration: int          # number of *completed* Gibbs iterations
    mu: torch.Tensor        # scalar intercept
    beta: torch.Tensor      # (Mpad,) marker effects
    eps: torch.Tensor       # (N,) or (Npad,) residuals Y - mu - X beta
    sigmaE: torch.Tensor    # scalar residual variance
    lam: torch.Tensor       # (Mpad,) local scales lambda_j (1 on padding)
    v: torch.Tensor         # (Mpad,) local auxiliaries
    tau: torch.Tensor       # scalar global scale
    eta: torch.Tensor       # scalar global auxiliary
    c2: torch.Tensor        # scalar slab width^2

    def replace(self, **changes) -> "HorseshoeState":
        return dataclasses.replace(self, **changes)
