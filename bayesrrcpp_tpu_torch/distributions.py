"""Random draws of the BayesR step, on an explicit ``torch.Generator``.

Counterpart of ``bayesrrcpp_tpu/distributions.py``, reduced to the draws the
BayesR slice uses and kept in the reference's parameterisations
(src/distributions.cpp:12-62):

- normal draws take a VARIANCE (``norm``);
- ``inv_scaled_chisq(dof, scale, g)`` = InvGamma(dof/2, dof*scale/2), i.e.
  (dof*scale/2) / g with g ~ Gamma(dof/2, 1);
- ``dirichlet(g)`` normalises independent Gamma(alpha_i, 1) draws.

torch's Philox streams are not jax's threefry streams, so the sampler never
draws from a bare generator: it asks a *variates* object for each draw by
its role in the step (``models/bayesr.py``).  :class:`TorchVariates` is the
production implementation; the tests pass an object with the same methods
that replays the JAX sampler's draws, which holds the port to the reference
variate for variate.

Role (method)          draw                                JAX source
---------------------  ----------------------------------  -----------------
``begin_step()``       start of one Gibbs step             bayesr.py:511
``mu_noise()``         N(0, 1), the intercept              bayesr.py:519
``orders(nb, B, J)``   strided rounds: rho (nr,), inner    bayesr.py:599
``block_orders(nb,B)`` blocked sweep: border (nb,), inner  bayesr.py:619
``p(Mpad)``            U(0, 1) per sweep position          bayesr.py:590
``z(Mpad)``            N(0, 1) per sweep position          bayesr.py:591
``sigmaE_gamma(a)``    Gamma(a, 1), scalar                 bayesr.py:560
``sigmaG_gamma(a)``    Gamma(a_g, 1), (G,)                 bayesr.py:576
``pi_gamma(alpha)``    Gamma(alpha_gk, 1), (G, K)          bayesr.py:578
``init_sigmaGG(G)``    Beta(1, 1), (G,)                    bayesr.py:393
"""
from __future__ import annotations

import torch

from .ops import block_sweep


def norm(mean, sigma2, noise):
    """Normal draw from its standard-normal ``noise``, parameterised by mean
    and VARIANCE (src/distributions.cpp:37-39)."""
    return mean + torch.sqrt(sigma2) * noise


def gamma_rng(generator, alpha):
    """Gamma(alpha, 1) draws of ``alpha``'s shape, dtype and device."""
    return torch._standard_gamma(alpha, generator=generator)


def beta_rng(generator, a, b, size, *, device, dtype=torch.float32):
    """Beta(a, b) draws as G_a / (G_a + G_b) (src/distributions.cpp:60-62)."""
    ga = gamma_rng(generator, torch.full(size, float(a), dtype=dtype,
                                         device=device))
    gb = gamma_rng(generator, torch.full(size, float(b), dtype=dtype,
                                         device=device))
    return ga / (ga + gb)


def inv_scaled_chisq(dof, scale, gamma_draw):
    """Scaled inverse chi-squared from its Gamma(dof/2, 1) draw:
    InvGamma(dof/2, dof*scale/2) (src/distributions.cpp:21-23, 34-36)."""
    return (0.5 * dof * scale) / gamma_draw


def dirichlet(gamma_draws):
    """Dirichlet rows from independent Gamma(alpha_i, 1) draws along the
    last axis (src/distributions.cpp:12-20)."""
    return gamma_draws / torch.sum(gamma_draws, dim=-1, keepdim=True)


class TorchVariates:
    """The step's draws from one ``torch.Generator`` (see the module table).

    The generator's device is where every draw lands, so a CUDA generator
    keeps the step free of host round trips.
    """

    def __init__(self, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        self.generator = generator
        self.device = generator.device
        self.dtype = dtype

    def begin_step(self):
        pass

    def _full(self, shape, value):
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def mu_noise(self):
        return torch.randn((), generator=self.generator, dtype=self.dtype,
                           device=self.device)

    def orders(self, nb: int, B: int, J: int):
        return block_sweep.strided_orders(self.generator, nb, B, J)

    def block_orders(self, nb: int, B: int):
        return block_sweep.block_orders(self.generator, nb, B)

    def p(self, n: int):
        return torch.rand((n,), generator=self.generator, dtype=self.dtype,
                          device=self.device)

    def z(self, n: int):
        return torch.randn((n,), generator=self.generator, dtype=self.dtype,
                           device=self.device)

    def sigmaE_gamma(self, shape: float):
        return gamma_rng(self.generator, self._full((), shape))

    def sigmaG_gamma(self, shapes):
        return gamma_rng(self.generator, shapes.to(self.dtype))

    def pi_gamma(self, alpha):
        return gamma_rng(self.generator, alpha.to(self.dtype))

    def init_sigmaGG(self, G: int):
        return beta_rng(self.generator, 1.0, 1.0, (G,), device=self.device,
                        dtype=self.dtype)
