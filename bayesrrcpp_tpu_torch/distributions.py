"""Random draws of the Gibbs steps, on an explicit ``torch.Generator``.

Counterpart of ``bayesrrcpp_tpu/distributions.py``, reduced to the draws the
BayesR and horseshoe samplers use and kept in the reference's
parameterisations (src/distributions.cpp:12-62):

- normal draws take a VARIANCE (``norm``);
- ``inv_gamma(scale, g)`` = InvGamma(shape, scale) as scale / g with
  g ~ Gamma(shape, 1) (the reference's scale and rate paths sample the same
  law, src/distributions.cpp:21-29);
- ``inv_scaled_chisq(dof, scale, g)`` = InvGamma(dof/2, dof*scale/2), i.e.
  (dof*scale/2) / g with g ~ Gamma(dof/2, 1);
- ``dirichlet(g)`` normalises independent Gamma(alpha_i, 1) draws;
- ``gamma_shape_rng`` draws a vector of Gamma(alpha, 1) without rejection
  for integer and half-integer alpha.

torch's Philox streams are not jax's threefry streams, so a sampler never
draws from a bare generator: it asks a *variates* object for each draw by
its role in the step (``models/bayesr.py``, ``models/horseshoe.py``).
:class:`TorchVariates` is the production implementation; the tests pass an
object with the same methods that replays the JAX sampler's draws, which
holds the port to the reference variate for variate.  Every float draw
is in the sampler's dtype (float32 or float64), as JAX draws in its
sampler's ``dtype``.

With ``chains=C`` a ``TorchVariates`` serves a fused multi-chain step
(``step_chains``, bayesrrcpp_tpu/models/bayesr.py:672-731): every per-chain
role draws a leading chain axis in one generator call (``mu_noise`` (C,),
``p``/``z`` (C, n), the gammas (C, ...)), while ``orders`` is drawn once
and shared by all chains, as JAX draws it from chain 0's key
(``korder[0]``, bayesr.py:708, horseshoe.py:539).  ``for_chain(c)`` is the
single-chain view a multi-chain run without the fused kernel steps chain c
with, each chain drawing its own orders (JAX's vmapped fallback).

BayesR (JAX source ``models/bayesr.py``):

Role (method)          draw                                JAX source
---------------------  ----------------------------------  -----------------
``begin_step()``       start of one Gibbs step             bayesr.py:511
``mu_noise()``         N(0, 1), the intercept              bayesr.py:519
``fixed_order(F)``     the fixed effects' visit order      bayesr.py:529
``fixed_z(F)``         N(0, 1) per fixed effect            bayesr.py:530
``orders(nb, B, J)``   strided rounds: rho (nr,), inner    bayesr.py:599
``block_orders(nb,B)`` blocked sweep: border (nb,), inner  bayesr.py:619
``full_order(Mpad)``   the scan's full permutation         bayesr.py:658
``p(Mpad)``            U(0, 1) per sweep position          bayesr.py:590
``z(Mpad)``            N(0, 1) per sweep position          bayesr.py:591
``sigmaF_gamma(a)``    Gamma(a, 1), scalar (F > 0)         bayesr.py:556
``sigmaE_gamma(a)``    Gamma(a, 1), scalar                 bayesr.py:560
``sigmaG_gamma(a)``    Gamma(a_g, 1), (G,)                 bayesr.py:576
``pi_gamma(alpha)``    Gamma(alpha_gk, 1), (G, K)          bayesr.py:578
``init_sigmaGG(G)``    Beta(1, 1), (G,)                    bayesr.py:393
``init_sigmaF()``      U(0, 1), scalar (F > 0)             bayesr.py:395
``init_from_pi_gamma`` init_from's Gamma(v_gk + 1, 1)      bayesr.py:434

Horseshoe (JAX source ``models/horseshoe.py``), one step in the order of
its keys (:388-389), then the two inits:

Role (method)                  draw                           JAX source
-----------------------------  -----------------------------  ----------
``begin_step()``               start of one Gibbs step        :388
``mu_noise()``                 N(0, 1), the intercept         :395
``eta_gamma(a)``               Gamma(0.5+0.5vT, 1), scalar    :403
``local_gamma(a, Mpad)``       Gamma(0.5+0.5vL, 1), v         :406
``orders`` / ``block_orders``  as BayesR                      :446, :464
``full_order(Mpad)``           the scan's full permutation    :502
``z(Mpad)``                    N(0, 1) per sweep position     :440
``local_gamma(a, Mpad)``       Gamma(0.5+0.5vL, 1), lambda    :417
``tau_gamma(a)``               Gamma(0.5(M+vT), 1), scalar    :421
``c2_gamma(a)``                Gamma(0.5vC+0.5M, 1), scalar   :424
``sigmaE_gamma(a)``            Gamma((v0E+N)/2, 1), scalar    :426
``init_gammas(a, b)``          init's eta and tau draws       :286-292
``init_from_gammas(a,b,n,c)``  init_from's eta, v, c2 draws   :320-345
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


def gamma_shape_rng(generator, alpha, size, *, dtype=torch.float32):
    """Gamma(alpha, 1) draws of shape ``size`` (an int or a tuple) on the
    generator's device, exact and rejection-free for integer and
    half-integer alpha (the horseshoe's local shape (1 + vL)/2 is one for
    every integer dof vL):

    - alpha == 1: Exponential(1);
    - alpha = n or n + 1/2: the sum of n Exponential(1) draws, plus
      Z^2/2 (Gamma(1/2, 1) = chi^2_1 / 2) for the half;
    - otherwise: ``torch._standard_gamma``.
    """
    dev = generator.device
    a = float(alpha)
    shape = (size,) if isinstance(size, int) else tuple(size)

    def expo(shape):
        return torch.empty(shape, dtype=dtype, device=dev).exponential_(
            generator=generator)

    if a == 1.0:
        return expo(shape)
    if a > 0 and 2.0 * a == int(2.0 * a):
        n = int(a)
        tot = (torch.sum(expo((n,) + shape), dim=0) if n > 0
               else torch.zeros(shape, dtype=dtype, device=dev))
        if a - n == 0.5:
            z = torch.randn(shape, generator=generator, dtype=dtype,
                            device=dev)
            tot = tot + 0.5 * z * z
        return tot
    return gamma_rng(generator, torch.full(shape, a, dtype=dtype, device=dev))


def inv_gamma(scale, gamma_draw):
    """InvGamma(shape, scale) from its Gamma(shape, 1) draw
    (src/distributions.cpp:21-29)."""
    return scale / gamma_draw


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
    keeps the step free of host round trips.  ``chains=C`` gives every
    per-chain draw a leading chain axis of C (see the module docstring).
    """

    def __init__(self, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, chains=None):
        self.generator = generator
        self.device = generator.device
        self.dtype = dtype
        self.lead = () if chains is None else (int(chains),)

    def for_chain(self, c: int) -> "TorchVariates":
        """Single-chain draws on the same generator, for chain ``c`` of an
        unfused multi-chain step."""
        return TorchVariates(self.generator, self.dtype)

    def begin_step(self):
        pass

    def _full(self, shape, value):
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def mu_noise(self):
        return torch.randn(self.lead, generator=self.generator,
                           dtype=self.dtype, device=self.device)

    def orders(self, nb: int, B: int, J: int):
        return block_sweep.strided_orders(self.generator, nb, B, J)

    def block_orders(self, nb: int, B: int):
        return block_sweep.block_orders(self.generator, nb, B)

    def full_order(self, n: int):
        """A permutation of all n markers (``permutation="full"``)."""
        return torch.randperm(n, generator=self.generator,
                              device=self.device)

    def p(self, n: int):
        return torch.rand(self.lead + (n,), generator=self.generator,
                          dtype=self.dtype, device=self.device)

    def z(self, n: int):
        return torch.randn(self.lead + (n,), generator=self.generator,
                           dtype=self.dtype, device=self.device)

    def fixed_order(self, F: int):
        """A permutation of the F fixed effects, one per chain."""
        u = torch.rand(self.lead + (F,), generator=self.generator,
                       device=self.device)
        return torch.argsort(u, dim=-1)

    def fixed_z(self, F: int):
        return self.z(F)

    def sigmaE_gamma(self, shape: float):
        return gamma_rng(self.generator, self._full(self.lead, shape))

    # the horseshoe's scalar gammas and sigmaF's: the same draw under their
    # roles
    eta_gamma = tau_gamma = c2_gamma = sigmaF_gamma = sigmaE_gamma

    def sigmaG_gamma(self, shapes):
        """shapes (..., G) -> Gamma draws of the same shape."""
        return gamma_rng(self.generator, shapes.to(self.dtype))

    def pi_gamma(self, alpha):
        return gamma_rng(self.generator, alpha.to(self.dtype))

    def init_sigmaGG(self, G: int):
        return beta_rng(self.generator, 1.0, 1.0, self.lead + (G,),
                        device=self.device, dtype=self.dtype)

    def init_sigmaF(self):
        return torch.rand(self.lead, generator=self.generator,
                          dtype=self.dtype, device=self.device)

    # init_from's per-group Dirichlet gammas: the pi draw's
    init_from_pi_gamma = pi_gamma

    def local_gamma(self, alpha: float, n: int):
        return gamma_shape_rng(self.generator, alpha, self.lead + (n,),
                               dtype=self.dtype)

    def init_gammas(self, eta_shape: float, tau_shape: float):
        return self.eta_gamma(eta_shape), self.tau_gamma(tau_shape)

    def init_from_gammas(self, eta_shape: float, local_alpha: float, n: int,
                         c2_shape: float):
        return (self.eta_gamma(eta_shape), self.local_gamma(local_alpha, n),
                self.c2_gamma(c2_shape))
