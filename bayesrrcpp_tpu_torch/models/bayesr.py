"""BayesR spike-and-slab Gibbs sampler (SURVEY C1), variant ``"bayesr"``.

Counterpart of ``bayesrrcpp_tpu/models/bayesr.py:SpikeSlabSampler`` for one
group (G=1) and no fixed effects (F=0), one chain or several
(``run_chains``), on either

- 2-bit packed genotypes from host dosages, a PLINK .bed
  (``io/bed.read_bed_packed``) or pre-packed int32 words on the device
  (words with missing calls take the kernels' missing-call modes,
  ``MarkerSampler._sweep_kw``),
- int8 genotype codes {0, 1, 2, 3 = missing} from host dosages or an int8
  tensor of codes on the device (``x_dtype="int8"``, one byte a genotype,
  individuals in their natural order; codes with missing calls sweep at
  J=1 through the serial kernels' in-kernel decode), or
- dense standardized f32 X,

swept by the kernels ("pallas", the default for packed X and for dense X
on the card): the strided-rounds block-Jacobi kernel (``ops/jacobi_t.py``;
the main path), the row-layout one on a "row" plan with J > 1
(``ops/jacobi.py``: ``jacobi_layout="row"``, an explicit
``jacobi_blocks``, or the auto plan at small ``block_size``) or, at J=1
(``jacobi_blocks=1``, or the auto plan for M < 2048), the exact serial
sweep (``ops/serial.py``).  Dense X on the CPU
defaults to the plain Gram-blocked sweep (``backend="blocked"``,
``ops/block_sweep.py``), as the JAX package runs it in XLA off its
accelerator.

Per iteration (src/BayesRv2.cpp:171-272): intercept -> marker sweep ->
sigmaE / sigmaG / pi draws.  Every draw comes from the variates object the
caller passes (``distributions.TorchVariates``), and the step enqueues
device work only: no host round trip, so a chain of steps runs ahead of
the host.  ``step_chains`` is the fused multi-chain iteration
(bayesr.py:672-731): per-chain intercept and hyperparameter draws around
one ``bayesr_jacobi_t_mc`` sweep of all chains (``bayesr_sweep_mc`` at
J=1 and on a row plan, as JAX's ``_mc_step_impl``).

What lies outside the slice raises ``NotImplementedError`` naming its
ROADMAP entry: the groups variant and fixed effects, the scan backend,
checkpoint and resume.  What it shares with the horseshoe
(storage, plan, intercept, residual recompute, chain driver) lives in
``models/sampler.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import distributions as dist
from ..config import BayesRConfig
from ..ops import block_sweep as bs
from ..ops.jacobi import bayesr_jacobi
from ..ops.jacobi_t import bayesr_jacobi_t, bayesr_jacobi_t_mc
from ..ops.multichain import bayesr_sweep_mc
from ..ops.serial import bayesr_sweep
from .sampler import MarkerSampler, not_ported
from .state import SpikeSlabState


class MarkerData(NamedTuple):
    """Static per-chain device data."""

    XT: torch.Tensor         # (Mpad, Npad/16) int32 words, (Mpad, N) int8
    #                          codes or (Mpad, N) f32 rows
    xsq: torch.Tensor        # (Mpad,) per-marker squared norms
    gram: torch.Tensor       # (nb, B, B) block Gram matrices
    g_assign: torch.Tensor   # (Mpad,) int32 marker -> group map (all 0)
    valid: torch.Tensor      # (Mpad,) bool, False on padding markers
    cva: torch.Tensor        # (G, K-1) slab variances
    prior_pi: torch.Tensor   # (G, K) initial mixture probabilities
    x_mean: torch.Tensor     # (Mpad,) dosage means ((0,) when dense)
    x_scale: torch.Tensor    # (Mpad,) 1/sd scales ((0,) when dense)
    row_valid: torch.Tensor  # (Npad,) bool, individual n < N ((0,) dense
    #                          or int8)
    x_colsum: torch.Tensor   # (Mpad,) decoded column sums ((0,) dense)
    has_missing: bool = False  # quantized X holds missing calls (code 3)


def _as_2d_cva(cva) -> np.ndarray:
    cva = np.asarray(cva, np.float64)
    if cva.ndim == 0:
        cva = cva[None]
    if cva.ndim == 1:
        cva = cva[None, :]
    return cva


def hyper_draws(cfg, N, v, ss_eps, ss_beta, counts):
    """sigmaE, sigmaGG and pi of a BayesR step (src/BayesRv2.cpp:247-255),
    per chain, from sum(eps^2) and sum(beta^2) (...,) and the label counts
    of the sweep's hits (..., G, K), with the draws of the variates ``v``.
    """
    dof_e = cfg.v0E + N
    sigmaE = dist.inv_scaled_chisq(
        dof_e, (ss_eps + cfg.v0E * cfg.s02E) / dof_e,
        v.sigmaE_gamma(0.5 * dof_e))
    m0 = torch.sum(counts, dim=-1) - counts[..., 0]        # (..., G)
    ss = ss_beta[..., None].expand(m0.shape)
    if cfg.reference_sigma_g_scaling:
        scale_g = (ss * m0 + cfg.v0G * cfg.s02G) / (cfg.v0G + m0)
    else:
        scale_g = (ss + cfg.v0G * cfg.s02G) / (cfg.v0G + m0)
    dof_g = cfg.v0G + m0
    sigmaGG = dist.inv_scaled_chisq(dof_g, scale_g,
                                    v.sigmaG_gamma(0.5 * dof_g))
    pi = dist.dirichlet(v.pi_gamma(counts + 1.0))
    return sigmaE.to(torch.float32), sigmaGG, pi


class SpikeSlabSampler(MarkerSampler):
    """BayesR sampler over a fixed dataset (X, Y).

    Parameters
    ----------
    X : (N, M) dosages or standardized values, (M, N) with
        ``transposed=True``, or (M or Mpad, Npad/16) int32 packed words as a
        torch tensor (``x_dtype="2bit"``, ``transposed=True``, ``x_stats``),
        or (M or Mpad, N) int8 codes as a torch tensor (``x_dtype="int8"``,
        ``transposed=True``, ``x_stats``: used as given, no copy, when on
        the device with Mpad rows).
    Y : (N,) response.
    cva : (K-1,) slab variances (spike prepended internally).
    config : BayesRConfig.
    backend : None, "blocked" (dense X, plain Gram-blocked sweep) or
        "pallas" (the sweep kernels: strided or row-layout Jacobi, or
        serial at J=1).
        None picks "pallas" for quantized X and for dense X on the card,
        "blocked" for dense X on the CPU.
    device : where the data and state live; defaults to X's device for a
        tensor X, else the card ("cuda"; raises without one: pass
        ``device="cpu"`` to run on the CPU).
    """

    def __init__(self, X, Y, cva, config, *, g_assign=None, fixed=None,
                 backend: Optional[str] = None,
                 permutation: Optional[str] = None,
                 variant: Optional[str] = None, transposed: bool = False,
                 x_dtype: str = "dense", x_stats=None,
                 n_individuals: Optional[int] = None,
                 n_markers: Optional[int] = None,
                 jacobi_blocks: Optional[int] = None,
                 jacobi_layout: str = "auto", device=None):
        self._storage(x_dtype, backend, permutation, jacobi_layout)
        if not isinstance(config, BayesRConfig) or variant not in (None,
                                                                   "bayesr"):
            raise not_ported("the groups variant", "Queue 1 item 6")
        if g_assign is not None or fixed is not None:
            raise not_ported("groups and fixed effects", "Queue 1 item 6")
        X, prepacked, M, N = self._read_x(X, Y, transposed, x_stats,
                                          n_individuals, n_markers, device)
        cva2 = _as_2d_cva(cva)
        G, Km1 = cva2.shape
        if G != 1:
            raise not_ported("per-group slab variances", "Queue 1 item 6")
        if np.any(cva2 <= 0):
            raise ValueError("slab variances must be strictly positive")
        K = Km1 + 1
        self.config, self.variant = config, "bayesr"
        self.K, self.G, self.F = K, G, 0
        geno = self._lay_out(X, Y, M, N, config.block_size,
                             prepacked=prepacked, transposed=transposed,
                             x_stats=x_stats, jacobi_blocks=jacobi_blocks,
                             jacobi_layout=jacobi_layout)

        dev, f32 = self.device, torch.float32
        prior_pi = np.empty((G, K))
        prior_pi[:, 0] = 0.5
        # intended semantics of src/BayesRv2.cpp:150 (SURVEY.md 2.3)
        prior_pi[:, 1:] = 0.5 * cva2 / cva2.sum(axis=1, keepdims=True)
        self.data = MarkerData(
            **geno._asdict(),
            g_assign=torch.zeros((self.Mpad,), dtype=torch.int32, device=dev),
            cva=torch.as_tensor(cva2, dtype=f32, device=dev),
            prior_pi=torch.as_tensor(prior_pi, dtype=f32, device=dev))

    # ------------------------------------------------------------------ init

    def init(self, rng, chains: Optional[int] = None) -> SpikeSlabState:
        """Fresh-chain init (src/BayesRv2.cpp:146-170); with ``chains=C``,
        C fresh chains stacked on a leading axis (JAX's ``vmap(init)``)."""
        v = self.variates(rng, chains)
        dev, f32 = self.device, torch.float32
        lead = () if chains is None else (chains,)
        # packed: pad lanes of Y are exactly 0
        eps = self.Y.expand(lead + self.Y.shape).clone()
        return SpikeSlabState(
            iteration=0,
            mu=torch.zeros(lead, dtype=f32, device=dev),
            beta=torch.zeros(lead + (self.Mpad,), dtype=f32, device=dev),
            labels=torch.zeros(lead + (self.Mpad,), dtype=torch.int32,
                               device=dev),
            eps=eps,
            sigmaE=torch.sum(eps * eps, dim=-1) / self.N * 0.5,
            sigmaGG=v.init_sigmaGG(self.G).to(f32),
            pi=self.data.prior_pi.expand(lead + self.data.prior_pi.shape
                                         ).clone(),
            alpha=torch.zeros(lead + (0,), dtype=f32, device=dev),
            sigmaF=torch.ones(lead, dtype=f32, device=dev))

    # ------------------------------------------------------------------ step

    def _hyper_block(self, v, eps, beta, counts, bacc):
        """Post-sweep hyperparameter draws (src/BayesRv2.cpp:247-255), per
        chain: eps (..., Npad), beta (..., Mpad), counts (..., G, K)."""
        # C1 uses the full |beta|^2, not the per-sweep accumulator
        # (src/BayesRv2.cpp:248); padding betas are identically 0
        return hyper_draws(self.config, self.N, v,
                           torch.sum(eps * eps, dim=-1),
                           torch.sum(beta * beta, dim=-1), counts)

    def step(self, state: SpikeSlabState, rng) -> SpikeSlabState:
        """One Gibbs iteration; enqueues device work only."""
        v = self.variates(rng)
        v.begin_step()
        mu, eps = self._intercept(state, v)
        d = self.data
        Mpad, B, nb = self.Mpad, self.B, self.nb
        kernels = self.backend == "pallas"
        if kernels and self.strided:
            rho, inner = v.orders(nb, B, self.jacobi)
            p, z = v.p(Mpad), v.z(Mpad)
            res = bayesr_jacobi_t(
                d.XT, d.gram, d.xsq, eps, state.beta, state.labels, rho,
                inner, p, z, state.pi, d.cva, state.sigmaE, state.sigmaGG,
                d.g_assign, d.valid, J=self.jacobi, **self._sweep_kw())
        else:
            # the shuffled block order, p/z by sweep position
            # (bayesr.py:619-645): the row-layout sweep at J > 1, the
            # serial sweep, or the plain one
            border, inner = v.block_orders(nb, B)
            p, z = v.p(Mpad), v.z(Mpad)
            args = (d.XT, d.gram, d.xsq, eps, state.beta, state.labels,
                    border, inner, p, z, state.pi, d.cva, state.sigmaE,
                    state.sigmaGG, d.g_assign, d.valid)
            if not kernels:
                res = bs.bayesr_block_sweep(*args)
            elif self.jacobi > 1:
                res = bayesr_jacobi(*args, J=self.jacobi, **self._sweep_kw())
            else:
                res = bayesr_sweep(*args, **self._sweep_kw())
        return self._next(state, v, mu, res)

    def step_chains(self, state: SpikeSlabState, rng) -> SpikeSlabState:
        """One fused multi-chain Gibbs iteration of a chain-batched state
        (bayesrrcpp_tpu/models/bayesr.py:_mc_step_impl): per-chain
        intercept and p/z, one visit order shared by all chains, one
        ``bayesr_jacobi_t_mc`` sweep (``bayesr_sweep_mc`` at J=1 and on a
        row plan, p/z by marker), per-chain hyperparameter draws.
        The kernel backend only (``supports_fused_chains``)."""
        if not self.supports_fused_chains:
            raise ValueError("fused multi-chain steps need the sweep kernels, "
                             "with no missing call at J=1")
        v = self.variates(rng, state.beta.shape[0])
        v.begin_step()
        mu, eps = self._intercept(state, v)
        d = self.data
        if self.strided:
            orders = v.orders(self.nb, self.B, self.jacobi)
            sweep, kw = bayesr_jacobi_t_mc, dict(J=self.jacobi)
        else:
            # J=1 and the row plan: the shared block order, p/z by marker
            # (bayesr.py:714-722)
            orders = v.block_orders(self.nb, self.B)
            sweep, kw = bayesr_sweep_mc, {}
        p, z = v.p(self.Mpad), v.z(self.Mpad)
        res = sweep(d.XT, d.gram, d.xsq, eps, state.beta, state.labels,
                    *orders, p, z, state.pi, d.cva, state.sigmaE,
                    state.sigmaGG, d.g_assign, d.valid, **kw,
                    **self._sweep_kw())
        return self._next(state, v, mu, res)

    def _next(self, state, v, mu, res) -> SpikeSlabState:
        sigmaE, sigmaGG, pi = self._hyper_block(v, res.eps, res.beta, res.v,
                                                res.beta_acum)
        return SpikeSlabState(
            iteration=state.iteration + 1, mu=mu, beta=res.beta,
            labels=res.labels, eps=res.eps, sigmaE=sigmaE, sigmaGG=sigmaGG,
            pi=pi, alpha=state.alpha, sigmaF=state.sigmaF)

    # ------------------------------------------------------------------ run

    def _emit_one(self, state: SpikeSlabState):
        M = self.M
        return {
            "mu": state.mu,
            "beta": state.beta[..., :M],
            "sigmaE": state.sigmaE,
            "sigmaG": state.sigmaGG,
            # int8: labels are < K <= 127; a 4x smaller copy to the host
            "comp": state.labels[..., :M].to(torch.int8),
            "epsilon": self._emit_epsilon(state),
            "alpha": state.alpha,
            "sigmaF": state.sigmaF,
        }
