"""BayesR spike-and-slab Gibbs samplers (SURVEY C1-C3).

Counterpart of ``bayesrrcpp_tpu/models/bayesr.py:SpikeSlabSampler``, one
engine for the reference's three mixture samplers:

- ``variant="bayesr"`` (BayesRSamplerV2, C1): the sigmaG scale takes the
  full |beta|^2 and the prior pi comes from cva;
- ``variant="groups"`` (BayesRSamplerV2Groups, C2; the default for a
  ``GroupsConfig``): per-group cva / pi / sigmaG rows gathered by
  ``g_assign``, the Gaussian fixed-effect sweep of ``fixed`` (N, F) before
  the marker sweep, sigmaF, and sigmaG per group from the sweep's
  per-group sum of slab beta^2 (``bacc``, which every sweep returns);
- warm restart (BRV2Grstart, C3): ``init_from`` takes a previous chain's
  last sample as given and redraws pi from the per-group label counts.

One chain or several (``run_chains``), on either

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
accelerator; ``backend="scan"`` is the literal per-marker sweep
(``ops/sweep.py``) in a full permutation (the default) or the blocked one.
The state runs in ``dtype``, float32 or float64 (``models/sampler.py``).

Per iteration (src/BayesRv2.cpp:171-272, src/BayesRv2Groups.cpp:207-312):
intercept -> fixed-effect sweep (F > 0; plain torch, as JAX runs it in
XLA outside any kernel) -> marker sweep -> sigmaF / sigmaE / sigmaG / pi
draws.  Every draw comes from the variates object the caller passes
(``distributions.TorchVariates``), and the step enqueues device work only:
no host round trip, so a chain of steps runs ahead of the host.
``step_chains`` is the fused multi-chain iteration (bayesr.py:672-731):
per-chain intercept, fixed effects and hyperparameter draws around one
``bayesr_jacobi_t_mc`` sweep of all chains (``bayesr_sweep_mc`` at J=1 and
on a row plan, as JAX's ``_mc_step_impl``).

Individuals stay in their natural order in every storage mode (the JAX
packed layout permutes them, ``n_perm``): Y, eps and the fixed-effect
columns ``fixedT`` (F, Npad) alike, pad lanes zero, so emission and
``init_from`` need no permutation.  What it shares with the
horseshoe (storage, plan, intercept, residual recompute, chain driver)
lives in ``models/sampler.py``; what it shares with the sharded sampler
(the fixed-effect sweep, the hyperparameter draws, init) in
``SpikeSlabSteps`` here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import distributions as dist
from ..config import BayesRConfig, GroupsConfig
from ..ops import block_sweep as bs
from ..ops.jacobi import bayesr_jacobi
from ..ops.jacobi_t import bayesr_jacobi_t, bayesr_jacobi_t_mc
from ..ops.multichain import bayesr_sweep_mc
from ..ops.serial import bayesr_sweep
from ..ops.sweep import bayesr_sweep_scan
from .sampler import MarkerSampler, numpy_dtype
from .state import SpikeSlabState


class MarkerData(NamedTuple):
    """Static per-chain device data."""

    XT: torch.Tensor         # (Mpad, Npad/16) int32 words, (Mpad, N) int8
    #                          codes or (Mpad, N) f32 rows
    xsq: torch.Tensor        # (Mpad,) per-marker squared norms
    gram: torch.Tensor       # (nb, B, B) block Gram matrices
    g_assign: torch.Tensor   # (Mpad,) int32 marker -> group map (0 on pads)
    valid: torch.Tensor      # (Mpad,) bool, False on padding markers
    cva: torch.Tensor        # (G, K-1) slab variances
    prior_pi: torch.Tensor   # (G, K) initial mixture probabilities
    x_mean: torch.Tensor     # (Mpad,) dosage means ((0,) when dense)
    x_scale: torch.Tensor    # (Mpad,) 1/sd scales ((0,) when dense)
    row_valid: torch.Tensor  # (Npad,) bool, individual n < N ((0,) dense
    #                          or int8)
    x_colsum: torch.Tensor   # (Mpad,) decoded column sums ((0,) dense)
    fixedT: torch.Tensor     # (F, Npad) fixed-effect columns, individuals
    #                          in natural order, pads 0
    fsq: torch.Tensor        # (F,) their squared norms
    has_missing: bool = False  # quantized X holds missing calls (code 3)


def _as_2d_cva(cva) -> np.ndarray:
    cva = np.asarray(cva, np.float64)
    if cva.ndim == 0:
        cva = cva[None]
    if cva.ndim == 1:
        cva = cva[None, :]
    return cva


class SpikeSlabSteps:
    """The mixture samplers' model algebra around the sweep, shared by
    ``SpikeSlabSampler`` and the sharded sampler: the prior, the groups and
    fixed effects, init, the fixed-effect sweep and the post-sweep draws.
    Sums over the mesh go through ``self._psum`` (the identity on one
    device)."""

    def _mixture_setup(self, config, variant, cva, g_assign, fixed, M, N):
        """Check the variant, cva, ``g_assign`` and ``fixed`` as JAX does
        (bayesr.py:137-192); sets ``config``, ``variant``, K, G, F.
        Returns (cva2, prior_pi, g_assign (M,) int32, fixed (N, F))."""
        if variant is None:
            variant = ("groups" if isinstance(config, GroupsConfig)
                       else "bayesr")
        if variant not in ("bayesr", "groups"):
            raise ValueError(f"unknown variant {variant!r}")
        if not isinstance(config, (BayesRConfig, GroupsConfig)):
            raise ValueError("config must be a BayesRConfig or GroupsConfig")
        cva2 = _as_2d_cva(cva)
        G, Km1 = cva2.shape
        if np.any(cva2 <= 0):
            # the reference only warns (src/BayesRv2.cpp:86-95)
            raise ValueError("slab variances must be strictly positive")
        K = Km1 + 1
        if g_assign is None:
            g_assign = np.zeros((M,), np.int32)
        else:
            g_assign = np.asarray(g_assign, np.int32).reshape(-1)
            if (g_assign.shape != (M,) or g_assign.min() < 0
                    or g_assign.max() >= G):
                raise ValueError("gAssign must be (M,) ints in [0, groups)")
        fixed = (np.zeros((N, 0), np.float64) if fixed is None
                 else np.asarray(fixed, np.float64))
        if fixed.ndim != 2 or fixed.shape[0] != N:
            raise ValueError(f"fixed must be (N, F) = ({N}, F), got "
                             f"{fixed.shape}")
        self.config, self.variant = config, variant
        self.K, self.G, self.F = K, G, fixed.shape[1]
        prior_pi = np.empty((G, K))
        prior_pi[:, 0] = 0.5
        if variant == "bayesr":
            # intended semantics of src/BayesRv2.cpp:150 (SURVEY.md 2.3)
            prior_pi[:, 1:] = 0.5 * cva2 / cva2.sum(axis=1, keepdims=True)
        else:
            # src/BayesRv2Groups.cpp:170-175: 0.5/K per slab component,
            # unnormalised unless reference_prior_pi=False
            prior_pi[:, 1:] = 0.5 / K
            if not getattr(config, "reference_prior_pi", True):
                prior_pi /= prior_pi.sum(axis=1, keepdims=True)
        return cva2, prior_pi, g_assign, fixed

    def _init_state(self, v, chains, n_markers) -> SpikeSlabState:
        """Fresh-chain init (src/BayesRv2.cpp:146-170,
        src/BayesRv2Groups.cpp:185-205) of ``n_markers`` (this slice's)
        markers; with ``chains=C`` a leading chain axis."""
        dev, dt = self.device, self.dtype
        lead = () if chains is None else (chains,)
        # packed: pad lanes of Y are exactly 0
        eps = self.Y.expand(lead + self.Y.shape).clone()
        sigmaGG = v.init_sigmaGG(self.G).to(dt)
        sigmaF = (v.init_sigmaF().to(dt) if self.F > 0
                  else torch.ones(lead, dtype=dt, device=dev))
        return SpikeSlabState(
            iteration=0,
            mu=torch.zeros(lead, dtype=dt, device=dev),
            beta=torch.zeros(lead + (n_markers,), dtype=dt, device=dev),
            labels=torch.zeros(lead + (n_markers,), dtype=torch.int32,
                               device=dev),
            eps=eps,
            sigmaE=self._psum(torch.sum(eps * eps, dim=-1), "n")
            / self.N * 0.5,
            sigmaGG=sigmaGG,
            pi=self.data.prior_pi.expand(lead + self.data.prior_pi.shape
                                         ).clone(),
            alpha=torch.zeros(lead + (self.F,), dtype=dt, device=dev),
            sigmaF=sigmaF)

    def _fixed_sweep(self, state, v, eps):
        """The Gaussian fixed-effect sweep (src/BayesRv2Groups.cpp:216-225,
        bayesrrcpp_tpu/models/bayesr.py:526-543) in a random order per
        chain: (alpha, eps).  Keeps the reference's denominator
        (N - 1) + sigmaE / sigmaF."""
        if self.F == 0:
            return state.alpha, eps
        d = self.data
        order = v.fixed_order(self.F)                       # (..., F)
        zf = v.fixed_z(self.F)                              # (..., F)
        alpha = state.alpha.clone()
        denom = (self.N - 1) + state.sigmaE / state.sigmaF  # (...)
        sd = torch.sqrt(state.sigmaE / denom)
        for i in range(self.F):
            c = order[..., i:i + 1].long()                  # (..., 1)
            fc = d.fixedT[c[..., 0]]                        # (..., Npad)
            a_old = torch.gather(alpha, -1, c)[..., 0]
            num = (self._psum(torch.sum(fc * eps, dim=-1), "n")
                   + a_old * d.fsq[c[..., 0]])
            a_new = num / denom + sd * zf[..., i]
            eps = eps - fc * (a_new - a_old)[..., None]
            alpha = alpha.scatter(-1, c, a_new[..., None])
        return alpha, eps

    def _next(self, state, v, mu, alpha, eps, beta, labels, counts, bacc
              ) -> SpikeSlabState:
        """The draws after the sweep (src/BayesRv2.cpp:247-255,
        src/BayesRv2Groups.cpp:301-312; bayesr.py:546-580,
        sharded.py:802-838), per chain: sigmaF from alpha (F > 0; from the
        residual prior v0E / s02E, a reference quirk), sigmaE, sigmaG per
        group from the counts (..., G, K) of the sweep's hits and ``bacc``
        (the groups variant) or sum(beta^2), and pi; the counts, bacc and
        sum(beta^2) summed over "m", sum(eps^2) over "n"."""
        cfg = self.config
        sigmaF = state.sigmaF
        if self.F > 0:
            dof_f = cfg.v0E + self.F
            sigmaF = dist.inv_scaled_chisq(
                dof_f, (torch.sum(alpha * alpha, dim=-1)
                        + cfg.v0E * cfg.s02E) / dof_f,
                v.sigmaF_gamma(0.5 * dof_f)).to(self.dtype)
        dof_e = cfg.v0E + self.N
        sigmaE = dist.inv_scaled_chisq(
            dof_e, (self._psum(torch.sum(eps * eps, dim=-1), "n")
                    + cfg.v0E * cfg.s02E) / dof_e,
            v.sigmaE_gamma(0.5 * dof_e)).to(self.dtype)
        counts = self._psum(counts, "m")                     # (..., G, K)
        m0 = torch.sum(counts, dim=-1) - counts[..., 0]      # (..., G)
        if self.variant == "groups":
            ss = self._psum(bacc, "m")
        else:
            # C1 uses the full |beta|^2, not the sweep's accumulator
            # (src/BayesRv2.cpp:248); padding betas are identically 0
            ss = self._psum(torch.sum(beta * beta, dim=-1),
                            "m")[..., None].expand(m0.shape)
        if cfg.reference_sigma_g_scaling:
            scale_g = (ss * m0 + cfg.v0G * cfg.s02G) / (cfg.v0G + m0)
        else:
            scale_g = (ss + cfg.v0G * cfg.s02G) / (cfg.v0G + m0)
        dof_g = cfg.v0G + m0
        sigmaGG = dist.inv_scaled_chisq(dof_g, scale_g,
                                        v.sigmaG_gamma(0.5 * dof_g))
        pi = dist.dirichlet(v.pi_gamma(counts + 1.0))
        return SpikeSlabState(
            iteration=state.iteration + 1, mu=mu, beta=beta, labels=labels,
            eps=eps, sigmaE=sigmaE, sigmaGG=sigmaGG, pi=pi, alpha=alpha,
            sigmaF=sigmaF)


class SpikeSlabSampler(SpikeSlabSteps, MarkerSampler):
    """BayesR sampler over a fixed dataset (X, Y[, groups, fixed]).

    Parameters
    ----------
    X : (N, M) dosages or standardized values, (M, N) with
        ``transposed=True``, or (M or Mpad, Npad/16) int32 packed words as a
        torch tensor (``x_dtype="2bit"``, ``transposed=True``, ``x_stats``),
        or (M or Mpad, N) int8 codes as a torch tensor (``x_dtype="int8"``,
        ``transposed=True``, ``x_stats``: used as given, no copy, when on
        the device with Mpad rows).
    Y : (N,) response.
    cva : (K-1,) or (G, K-1) slab variances (spike prepended internally).
    config : BayesRConfig or GroupsConfig (the latter: ``variant="groups"``
        by default).
    g_assign : (M,) int group of each marker, in [0, G).
    fixed : (N, F) fixed-effect covariates.
    dtype : the state's dtype, float32 (None) or float64.
    backend : None, "blocked" (dense X, plain Gram-blocked sweep), "scan"
        (dense X, the literal per-marker sweep) or "pallas" (the sweep
        kernels: strided or row-layout Jacobi, or serial at J=1).
        None picks "pallas" for quantized X and for dense X on the card,
        "blocked" for dense X on the CPU.
    permutation : "blocked" or "full" (the scan only); defaults to "full"
        for the scan, else "blocked".
    device : where the data and state live; defaults to X's device for a
        tensor X, else the card ("cuda"; raises without one: pass
        ``device="cpu"`` to run on the CPU).
    """

    def __init__(self, X, Y, cva, config, *, g_assign=None, fixed=None,
                 dtype=None, backend: Optional[str] = None,
                 permutation: Optional[str] = None,
                 variant: Optional[str] = None, transposed: bool = False,
                 x_dtype: str = "dense", x_stats=None,
                 n_individuals: Optional[int] = None,
                 n_markers: Optional[int] = None,
                 jacobi_blocks: Optional[int] = None,
                 jacobi_layout: str = "auto", device=None):
        self._storage(x_dtype, backend, permutation, jacobi_layout, dtype)
        X, prepacked, M, N = self._read_x(X, Y, transposed, x_stats,
                                          n_individuals, n_markers, device)
        cva2, prior_pi, g_assign, fixed = self._mixture_setup(
            config, variant, cva, g_assign, fixed, M, N)
        geno = self._lay_out(X, Y, M, N, config.block_size,
                             prepacked=prepacked, transposed=transposed,
                             x_stats=x_stats, jacobi_blocks=jacobi_blocks,
                             jacobi_layout=jacobi_layout)

        dev, dt = self.device, self.dtype
        # the fixed-effect columns in eps's layout: natural individual
        # order, zero on pad lanes (bayesr.py:316-319 without n_perm)
        fixedT = np.zeros((self.F, self.Npad), numpy_dtype(dt))
        fixedT[:, :N] = fixed.T
        self.data = MarkerData(
            **geno._asdict(),
            g_assign=torch.as_tensor(np.pad(g_assign, (0, self.Mpad - M)),
                                     device=dev),
            cva=torch.as_tensor(cva2, dtype=dt, device=dev),
            prior_pi=torch.as_tensor(prior_pi, dtype=dt, device=dev),
            fixedT=torch.as_tensor(fixedT, device=dev),
            fsq=torch.as_tensor(np.sum(fixed * fixed, axis=0), dtype=dt,
                                device=dev))

    # ------------------------------------------------------------------ init

    def init(self, rng, chains: Optional[int] = None) -> SpikeSlabState:
        """Fresh-chain init (src/BayesRv2.cpp:146-170,
        src/BayesRv2Groups.cpp:185-205); with ``chains=C``, C fresh chains
        stacked on a leading axis (JAX's ``vmap(init)``)."""
        return self._init_state(self.variates(rng, chains), chains,
                                self.Mpad)

    def init_from(self, rng, mu, beta, sigmaE, sigmaGG, epsilon, components,
                  alpha=None, sigmaF=None) -> SpikeSlabState:
        """Warm restart from a previous chain's last sample (BRV2Grstart,
        src/BRv2Grstart.cpp:77, 157-165; bayesrrcpp_tpu/models/bayesr.py:
        416-451): everything is taken as given except pi, which is drawn
        from Dirichlet(v + 1) with v the per-group label counts.
        ``epsilon`` is (N,) in individual order."""
        v = self.variates(rng)
        dev, dt = self.device, self.dtype
        beta = np.asarray(beta, np.float64).reshape(-1)
        components = np.asarray(components).reshape(-1).astype(np.int32)
        if beta.shape[0] != self.M or components.shape[0] != self.M:
            raise ValueError("beta/components must have length M")
        eps = np.asarray(epsilon, np.float64).reshape(-1)
        if eps.shape[0] != self.N:
            raise ValueError("epsilon must have length N")
        pad = self.Mpad - self.M
        g_assign = self.data.g_assign[:self.M].cpu().numpy()
        counts = np.zeros((self.G, self.K))
        np.add.at(counts, (g_assign, components), 1.0)
        pi = dist.dirichlet(v.init_from_pi_gamma(
            torch.as_tensor(counts + 1.0, dtype=dt, device=dev)))

        def t(x, dtype=dt):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        return SpikeSlabState(
            iteration=0, mu=t(mu), beta=t(np.pad(beta, (0, pad))),
            labels=t(np.pad(components, (0, pad)), torch.int32),
            eps=t(np.pad(eps, (0, self.Npad - self.N))), sigmaE=t(sigmaE),
            sigmaGG=t(sigmaGG).reshape(self.G), pi=pi.to(dt),
            alpha=(torch.zeros((self.F,), dtype=dt, device=dev)
                   if alpha is None else t(alpha).reshape(self.F)),
            sigmaF=(torch.ones((), dtype=dt, device=dev) if sigmaF is None
                    else t(sigmaF)))

    # ------------------------------------------------------------------ step

    def step(self, state: SpikeSlabState, rng) -> SpikeSlabState:
        """One Gibbs iteration; enqueues device work only."""
        v = self.variates(rng)
        v.begin_step()
        mu, eps = self._intercept(state, v)
        alpha, eps = self._fixed_sweep(state, v, eps)
        d = self.data
        Mpad, B, nb = self.Mpad, self.B, self.nb
        kernels = self.backend == "pallas"
        if self.backend == "scan":
            # the literal sweep in a full permutation, or in the blocked one
            # flattened (bayesr.py:652-660), p/z by sweep position
            if self.permutation == "full":
                order = v.full_order(Mpad)
            else:
                order = bs.flat_order(*v.block_orders(nb, B), B)
            p, z = v.p(Mpad), v.z(Mpad)
            res = bayesr_sweep_scan(
                d.XT, d.xsq, eps, state.beta, state.labels, order, p, z,
                state.pi, d.cva, state.sigmaE, state.sigmaGG, d.g_assign,
                d.valid)
        elif kernels and self.strided:
            rho, inner = v.orders(nb, B, self.jacobi)
            p, z = v.p(Mpad), v.z(Mpad)
            res = self._kernel(
                bayesr_jacobi_t, d.XT, d.gram, d.xsq, eps, state.beta,
                state.labels, rho, inner, p, z, state.pi, d.cva,
                state.sigmaE, state.sigmaGG, d.g_assign, d.valid,
                J=self.jacobi, **self._sweep_kw())
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
                res = self._kernel(bayesr_jacobi, *args, J=self.jacobi,
                                   **self._sweep_kw())
            else:
                self._f64_check("bayesr_sweep_pallas")
                res = self._kernel(bayesr_sweep, *args, **self._sweep_kw())
        return self._next(state, v, mu, alpha, *res)

    def step_chains(self, state: SpikeSlabState, rng) -> SpikeSlabState:
        """One fused multi-chain Gibbs iteration of a chain-batched state
        (bayesrrcpp_tpu/models/bayesr.py:_mc_step_impl): per-chain
        intercept, fixed effects and p/z, one visit order shared by all
        chains, one ``bayesr_jacobi_t_mc`` sweep (``bayesr_sweep_mc`` at J=1
        and on a row plan, p/z by marker), per-chain hyperparameter draws.
        The kernel backend only (``supports_fused_chains``)."""
        if not self.supports_fused_chains:
            raise ValueError("fused multi-chain steps need the sweep kernels, "
                             "with no missing call at J=1")
        v = self.variates(rng, state.beta.shape[0])
        v.begin_step()
        mu, eps = self._intercept(state, v)
        alpha, eps = self._fixed_sweep(state, v, eps)
        d = self.data
        if self.strided:
            orders = v.orders(self.nb, self.B, self.jacobi)
            sweep, kw = bayesr_jacobi_t_mc, dict(J=self.jacobi)
        else:
            # J=1 and the row plan: the shared block order, p/z by marker
            # (bayesr.py:714-722)
            self._f64_check("bayesr_sweep_pallas_mc")
            orders = v.block_orders(self.nb, self.B)
            sweep, kw = bayesr_sweep_mc, {}
        p, z = v.p(self.Mpad), v.z(self.Mpad)
        res = self._kernel(sweep, d.XT, d.gram, d.xsq, eps, state.beta,
                           state.labels, *orders, p, z, state.pi, d.cva,
                           state.sigmaE, state.sigmaGG, d.g_assign, d.valid,
                           **kw, **self._sweep_kw())
        return self._next(state, v, mu, alpha, *res)

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
