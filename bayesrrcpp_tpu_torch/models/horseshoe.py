"""Regularized-horseshoe Gibbs sampler (SURVEY C4).

Counterpart of ``bayesrrcpp_tpu/models/horseshoe.py:HorseshoeSampler``, one
chain or several (``run_chains``), on either

- 2-bit packed genotypes from host dosages, a PLINK .bed or pre-packed
  int32 words on the device, with or without missing calls,
- int8 genotype codes from host dosages or an int8 tensor on the device
  (``x_dtype="int8"``; with missing calls at J=1, the serial in-kernel
  decode), or
- dense standardized f32 X,

swept (as ``SpikeSlabSampler``'s) by the kernels: the strided-rounds
block-Jacobi kernel (``ops/jacobi_t.horseshoe_jacobi_t``; the main path),
the row-layout one on a "row" plan with J > 1
(``ops/jacobi.horseshoe_jacobi``) or, at J=1, the exact serial sweep
(``ops/serial.horseshoe_sweep``); dense X on the CPU defaults to the plain
Gram-blocked sweep (``backend="blocked"``,
``ops/block_sweep.horseshoe_block_sweep``); ``backend="scan"`` is the
literal per-marker sweep (``ops/sweep.horseshoe_sweep_scan``).  The state
runs in ``dtype``, float32 or float64 (``models/sampler.py``).

Per iteration, in the reference's order (src/HorseshoeR.cpp:210-253):

1. intercept mu;
2. global auxiliary eta ~ InvGamma(0.5+0.5*vT, 1/(sigmaE*A^2) + vT/tau);
3. local auxiliaries v_j ~ InvGamma(0.5+0.5*vL, vL/lambda_j + 1);
4. marker sweep with prior variance s_j = tau*c2*lambda_j/(tau*lambda_j+c2);
5. lambda_j ~ InvGamma(0.5+0.5*vL, vL/v_j + beta_j^2/(2*tau)), with the
   tau from before this step's draw;
6. tau ~ InvGamma(0.5*(M+vT), vT/eta + 0.5*sum(beta^2/lambda)), the sum
   over real markers;
7. c2 ~ InvGamma(0.5*vC+0.5*M, 0.5*vC*sC + 0.5*|beta|^2);
8. sigmaE ~ InvScaledChi2(v0E+N, (|eps|^2+v0E*s02E)/(v0E+N)).

Every draw comes from the variates object the caller passes
(``distributions.TorchVariates``), and the step enqueues device work only.
``step_chains`` is the fused multi-chain iteration (horseshoe.py:516-562):
the same per-chain draws around one ``horseshoe_jacobi_t_mc`` sweep of all
chains (``horseshoe_sweep_mc`` at J=1 and on a row plan, as JAX's
``_mc_step_impl``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import distributions as dist
from ..config import HorseshoeConfig
from ..ops import block_sweep as bs
from ..ops.jacobi import horseshoe_jacobi
from ..ops.jacobi_t import horseshoe_jacobi_t, horseshoe_jacobi_t_mc
from ..ops.multichain import horseshoe_sweep_mc
from ..ops.serial import horseshoe_sweep
from ..ops.sweep import horseshoe_sweep_scan
from .sampler import Genotypes, MarkerSampler
from .state import HorseshoeState

# the horseshoe's static device data is the genotype layout alone (the JAX
# HorseshoeData less n_perm: the port keeps individuals in natural order)
HorseshoeData = Genotypes


class HorseshoeSampler(MarkerSampler):
    """Regularized-horseshoe sampler over a fixed dataset (X, Y).

    Parameters as ``SpikeSlabSampler``'s, without cva, groups and fixed
    effects: X as dosages, standardized values, pre-packed int32 words or
    int8 codes; ``config`` a HorseshoeConfig; ``dtype`` float32 (None) or
    float64; ``backend`` None, "blocked" (dense X), "scan" (dense X, the
    literal sweep; ``permutation`` "full" by default, or "blocked") or
    "pallas" (the sweep kernels, strided or serial; None picks them for
    quantized X and for dense X on the card);
    ``device`` defaults to X's device for a tensor X, else the card
    ("cuda"; raises without one: pass ``device="cpu"`` to run on the CPU).
    """

    def __init__(self, X, Y, config: HorseshoeConfig, *, dtype=None,
                 backend: Optional[str] = None,
                 permutation: Optional[str] = None, transposed: bool = False,
                 x_dtype: str = "dense", x_stats=None,
                 n_individuals: Optional[int] = None,
                 n_markers: Optional[int] = None,
                 jacobi_blocks: Optional[int] = None,
                 jacobi_layout: str = "auto", device=None):
        self._storage(x_dtype, backend, permutation, jacobi_layout, dtype)
        self.config = config
        X, prepacked, M, N = self._read_x(X, Y, transposed, x_stats,
                                          n_individuals, n_markers, device)
        self.data = self._lay_out(
            X, Y, M, N, config.block_size, prepacked=prepacked,
            transposed=transposed, x_stats=x_stats,
            jacobi_blocks=jacobi_blocks, jacobi_layout=jacobi_layout)

    # ------------------------------------------------------------------ init

    def init(self, rng, chains: Optional[int] = None) -> HorseshoeState:
        """Fresh-chain init (src/HorseshoeR.cpp:168-195): beta=0, mu=0,
        lambda=v=1, sigmaE=|Y|^2/(2N), eta and tau from their priors; with
        ``chains=C``, C fresh chains stacked on a leading axis."""
        v = self.variates(rng, chains)
        cfg = self.config
        dev, dt = self.device, self.dtype
        lead = () if chains is None else (chains,)
        # packed: pad lanes of Y are exactly 0
        eps = self.Y.expand(lead + self.Y.shape).clone()
        sigmaE = torch.sum(eps * eps, dim=-1) / self.N * 0.5
        g_eta, g_tau = v.init_gammas(0.5, 0.5 * cfg.vT)
        eta = dist.inv_gamma(1.0 / (sigmaE * cfg.A ** 2), g_eta)
        tau = (1.0 / eta) * dist.inv_gamma(cfg.vT, g_tau)
        ones = torch.ones(lead + (self.Mpad,), dtype=dt, device=dev)
        return HorseshoeState(
            iteration=0,
            mu=torch.zeros(lead, dtype=dt, device=dev),
            beta=torch.zeros(lead + (self.Mpad,), dtype=dt, device=dev),
            eps=eps, sigmaE=sigmaE, lam=ones, v=ones.clone(),
            tau=tau.to(dt), eta=eta.to(dt),
            c2=torch.full(lead, cfg.c2, dtype=dt, device=dev))

    def init_from(self, rng, mu, beta, sigmaE, tau, lam,
                  epsilon) -> HorseshoeState:
        """Warm restart from a previous chain's last emitted sample
        (bayesrrcpp_tpu/models/horseshoe.py:307-360): the horseshoe CSV
        schema carries mu, beta, sigmaE, tau, lambda and epsilon but not
        eta, v or c2, which are drawn here from their full conditionals
        given the supplied state.  ``epsilon`` is (N,) in individual
        order."""
        v = self.variates(rng)
        cfg = self.config
        dev, dt = self.device, self.dtype
        beta = np.asarray(beta, np.float64).reshape(-1)
        lam = np.asarray(lam, np.float64).reshape(-1)
        if beta.shape[0] != self.M or lam.shape[0] != self.M:
            raise ValueError("beta/lambda must have length M")
        pad = self.Mpad - self.M
        beta_pad = torch.as_tensor(np.pad(beta, (0, pad)), dtype=dt,
                                   device=dev)
        # pad lambdas are 1 (an exact 0 would divide by zero in the v draw)
        lam_pad = torch.as_tensor(np.pad(lam, (0, pad), constant_values=1.0),
                                  dtype=dt, device=dev)
        tau = torch.as_tensor(tau, dtype=dt, device=dev)
        sigmaE = torch.as_tensor(sigmaE, dtype=dt, device=dev)
        eps = np.asarray(epsilon, np.float64).reshape(-1)
        if eps.shape[0] != self.N:
            raise ValueError("epsilon must have length N")
        g_eta, g_v, g_c2 = v.init_from_gammas(
            0.5 + 0.5 * cfg.vT, 0.5 + 0.5 * cfg.vL, self.Mpad,
            0.5 * cfg.vC + 0.5 * self.M)
        # eta | tau, sigmaE (src/HorseshoeR.cpp:217); v | lambda (:218);
        # c2 | beta (:248)
        eta = dist.inv_gamma(1.0 / (sigmaE * cfg.A * cfg.A) + cfg.vT / tau,
                             g_eta)
        v_aux = (cfg.vL / lam_pad + 1.0) / g_v
        c2 = dist.inv_gamma(
            0.5 * cfg.vC * cfg.sC + 0.5 * torch.sum(beta_pad * beta_pad),
            g_c2)
        return HorseshoeState(
            iteration=0,
            mu=torch.as_tensor(mu, dtype=dt, device=dev),
            beta=beta_pad,
            eps=torch.as_tensor(np.pad(eps, (0, self.Npad - self.N)),
                                dtype=dt, device=dev),
            sigmaE=sigmaE, lam=lam_pad, v=v_aux.to(dt), tau=tau,
            eta=eta.to(dt), c2=c2.to(dt))

    # ------------------------------------------------------------------ step

    def _pre_sweep(self, state: HorseshoeState, v):
        """Intercept, then the eta and v auxiliary draws
        (src/HorseshoeR.cpp:210-218), per chain; v of every marker
        ``state.lam`` holds (a sharded sampler's: its slice's)."""
        cfg = self.config
        mu, eps = self._intercept(state, v)
        eta = dist.inv_gamma(
            1.0 / (state.sigmaE * cfg.A * cfg.A) + cfg.vT / state.tau,
            v.eta_gamma(0.5 + 0.5 * cfg.vT))
        v_aux = (cfg.vL / state.lam + 1.0) / v.local_gamma(
            0.5 + 0.5 * cfg.vL, state.lam.shape[-1])
        return mu, eps, eta, v_aux

    def _hyper_block(self, v, eta, v_aux, beta, eps, tau_old):
        """Post-sweep lambda / tau / c2 / sigmaE draws
        (src/HorseshoeR.cpp:242-253).  lambda is drawn with the tau from
        before this step's draw; sum(beta^2/lambda) runs over the real
        markers, |beta|^2 over all (padding betas are 0); the shapes use
        the true M.  Per chain: beta, eps (..., n), eta, tau_old (...).
        The sums run over every slice of a sharded sampler (``_psum``)."""
        cfg = self.config
        N, M = self.N, self.M
        lam = (cfg.vL / v_aux + 0.5 * beta * beta / tau_old[..., None]
               ) / v.local_gamma(0.5 + 0.5 * cfg.vL, beta.shape[-1])
        bl = torch.where(self.data.valid, beta * beta / lam, 0.0)
        tau = dist.inv_gamma(
            cfg.vT / eta + 0.5 * self._psum(torch.sum(bl, dim=-1), "m"),
            v.tau_gamma(0.5 * (M + cfg.vT)))
        c2 = dist.inv_gamma(
            0.5 * cfg.vC * cfg.sC
            + 0.5 * self._psum(torch.sum(beta * beta, dim=-1), "m"),
            v.c2_gamma(0.5 * cfg.vC + 0.5 * M))
        dof_e = cfg.v0E + N
        sigmaE = dist.inv_scaled_chisq(
            dof_e,
            (self._psum(torch.sum(eps * eps, dim=-1), "n")
             + cfg.v0E * cfg.s02E) / dof_e,
            v.sigmaE_gamma(0.5 * dof_e))
        dt = self.dtype
        return lam, tau.to(dt), c2.to(dt), sigmaE.to(dt)

    def step(self, state: HorseshoeState, rng) -> HorseshoeState:
        """One Gibbs iteration; enqueues device work only."""
        v = self.variates(rng)
        v.begin_step()
        mu, eps, eta, v_aux = self._pre_sweep(state, v)
        d = self.data
        Mpad, B, nb = self.Mpad, self.B, self.nb
        kernels = self.backend == "pallas"
        if self.backend == "scan":
            # the literal sweep in a full permutation, or in the blocked one
            # flattened (horseshoe.py:496-505), z by sweep position
            if self.permutation == "full":
                order = v.full_order(Mpad)
            else:
                order = bs.flat_order(*v.block_orders(nb, B), B)
            eps, beta = horseshoe_sweep_scan(
                d.XT, d.xsq, eps, state.beta, order, v.z(Mpad), state.lam,
                state.tau, state.c2, state.sigmaE, d.valid)
        elif kernels and self.strided:
            rho, inner = v.orders(nb, B, self.jacobi)
            eps, beta = self._kernel(
                horseshoe_jacobi_t, d.XT, d.gram, d.xsq, eps, state.beta,
                rho, inner, v.z(Mpad), state.lam, state.tau, state.c2,
                state.sigmaE, d.valid, J=self.jacobi, **self._sweep_kw())
        else:
            # the shuffled block order, z by sweep position
            # (horseshoe.py:464-485): the row-layout sweep at J > 1, the
            # serial sweep, or the plain one
            border, inner = v.block_orders(nb, B)
            args = (d.XT, d.gram, d.xsq, eps, state.beta, border, inner,
                    v.z(Mpad), state.lam, state.tau, state.c2, state.sigmaE,
                    d.valid)
            if not kernels:
                eps, beta = bs.horseshoe_block_sweep(*args)
            elif self.jacobi > 1:
                self._f64_check("horseshoe_jacobi_pallas")
                eps, beta = self._kernel(horseshoe_jacobi, *args,
                                         J=self.jacobi, **self._sweep_kw())
            else:
                self._f64_check("horseshoe_sweep_pallas")
                eps, beta = self._kernel(horseshoe_sweep, *args,
                                         **self._sweep_kw())
        return self._next(state, v, mu, eta, v_aux, eps, beta)

    def step_chains(self, state: HorseshoeState, rng) -> HorseshoeState:
        """One fused multi-chain Gibbs iteration of a chain-batched state
        (bayesrrcpp_tpu/models/horseshoe.py:_mc_step_impl): the single
        step's per-chain draws, one visit order shared by all chains, one
        ``horseshoe_jacobi_t_mc`` sweep (``horseshoe_sweep_mc`` at J=1 and
        on a row plan, z by marker).  The kernel backend only
        (``supports_fused_chains``)."""
        if not self.supports_fused_chains:
            raise ValueError("fused multi-chain steps need the sweep kernels, "
                             "with no missing call at J=1")
        v = self.variates(rng, state.beta.shape[0])
        v.begin_step()
        mu, eps, eta, v_aux = self._pre_sweep(state, v)
        d = self.data
        if self.strided:
            orders = v.orders(self.nb, self.B, self.jacobi)
            sweep, kw = horseshoe_jacobi_t_mc, dict(J=self.jacobi)
        else:
            # J=1 and the row plan: the shared block order, z by marker
            # (horseshoe.py:545-552)
            self._f64_check("horseshoe_sweep_pallas_mc")
            orders = v.block_orders(self.nb, self.B)
            sweep, kw = horseshoe_sweep_mc, {}
        eps, beta = self._kernel(
            sweep, d.XT, d.gram, d.xsq, eps, state.beta, *orders,
            v.z(self.Mpad), state.lam, state.tau, state.c2, state.sigmaE,
            d.valid, **kw, **self._sweep_kw())
        return self._next(state, v, mu, eta, v_aux, eps, beta)

    def _next(self, state, v, mu, eta, v_aux, eps, beta) -> HorseshoeState:
        lam, tau, c2, sigmaE = self._hyper_block(v, eta, v_aux, beta, eps,
                                                 state.tau)
        return HorseshoeState(
            iteration=state.iteration + 1, mu=mu, beta=beta, eps=eps,
            sigmaE=sigmaE, lam=lam, v=v_aux, tau=tau, eta=eta, c2=c2)

    # ------------------------------------------------------------------ run

    def _emit_one(self, state: HorseshoeState):
        M = self.M
        return {
            "mu": state.mu,
            "beta": state.beta[..., :M],
            "sigmaE": state.sigmaE,
            "tau": state.tau,
            "lambda": state.lam[..., :M],
            "epsilon": self._emit_epsilon(state),
        }
