"""BayesR spike-and-slab Gibbs sampler (SURVEY C1), variant ``"bayesr"``.

Counterpart of ``bayesrrcpp_tpu/models/bayesr.py:SpikeSlabSampler`` for one
chain, one group (G=1) and no fixed effects (F=0), on either

- 2-bit packed genotypes with no missing calls, swept by the strided-rounds
  block-Jacobi kernel (``ops/jacobi_t.py``; the main path), from host
  dosages or from pre-packed int32 words on the device; or
- dense standardized X, swept by the plain Gram-blocked sweep
  (``backend="blocked"``, ``ops/block_sweep.py``), as the JAX package runs
  it in XLA.

Per iteration (src/BayesRv2.cpp:171-272): intercept -> marker sweep ->
sigmaE / sigmaG / pi draws.  Every draw comes from the variates object the
caller passes (``distributions.TorchVariates``), and the step enqueues
device work only: no host round trip, so a chain of steps runs ahead of
the host.

What lies outside the slice raises ``NotImplementedError`` naming its
ROADMAP entry: the groups variant and fixed effects, int8, missing calls,
row-layout and J=1 plans for packed X, the scan backend, multi-chain runs,
horseshoe, sharding, checkpoint and resume.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import distributions as dist
from ..config import BayesRConfig, ChainConfig
from ..ops import block_sweep as bs
from ..ops import genotypes
from ..ops.jacobi import auto_jacobi, auto_jacobi_plan
from ..ops.jacobi_t import bayesr_jacobi_t
from .state import SpikeSlabState


class MarkerData(NamedTuple):
    """Static per-chain device data."""

    XT: torch.Tensor         # (Mpad, Npad/16) int32 words, or (Mpad, N) f32
    xsq: torch.Tensor        # (Mpad,) per-marker squared norms
    gram: torch.Tensor       # (nb, B, B) block Gram matrices
    g_assign: torch.Tensor   # (Mpad,) int32 marker -> group map (all 0)
    valid: torch.Tensor      # (Mpad,) bool, False on padding markers
    cva: torch.Tensor        # (G, K-1) slab variances
    prior_pi: torch.Tensor   # (G, K) initial mixture probabilities
    x_mean: torch.Tensor     # (Mpad,) dosage means ((0,) when dense)
    x_scale: torch.Tensor    # (Mpad,) 1/sd scales ((0,) when dense)
    row_valid: torch.Tensor  # (Npad,) bool, individual n < N ((0,) dense)
    x_colsum: torch.Tensor   # (Mpad,) decoded column sums ((0,) dense)


def _not_ported(what: str, entry: str):
    return NotImplementedError(
        f"{what} is not ported to bayesrrcpp_tpu_torch yet (ROADMAP {entry})")


def _as_2d_cva(cva) -> np.ndarray:
    cva = np.asarray(cva, np.float64)
    if cva.ndim == 0:
        cva = cva[None]
    if cva.ndim == 1:
        cva = cva[None, :]
    return cva


class SpikeSlabSampler:
    """BayesR sampler over a fixed dataset (X, Y).

    Parameters
    ----------
    X : (N, M) dosages or standardized values, (M, N) with
        ``transposed=True``, or (M or Mpad, Npad/16) int32 packed words as a
        torch tensor (``x_dtype="2bit"``, ``transposed=True``, ``x_stats``).
    Y : (N,) response.
    cva : (K-1,) slab variances (spike prepended internally).
    config : BayesRConfig.
    backend : None, "blocked" (dense X, plain Gram-blocked sweep) or
        "pallas" (the strided Jacobi kernel; packed X only).  None picks by
        ``x_dtype``.
    device : where the data and state live; defaults to X's device for a
        tensor X, else the CPU.
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
        if x_dtype not in ("dense", "int8", "2bit"):
            raise ValueError(f"unknown x_dtype {x_dtype!r}")
        if x_dtype == "int8":
            raise _not_ported("int8 genotype storage", "Queue 1 item 7")
        if not isinstance(config, BayesRConfig) or variant not in (None,
                                                                   "bayesr"):
            raise _not_ported("the groups variant", "Queue 1 item 7")
        if g_assign is not None or fixed is not None:
            raise _not_ported("groups and fixed effects", "Queue 1 item 7")
        if backend == "scan" or permutation == "full":
            raise _not_ported("the sequential scan sweep", "Queue 1 item 3")
        if backend not in (None, "blocked", "pallas"):
            raise ValueError(f"unknown backend {backend!r}")
        if permutation not in (None, "blocked"):
            raise ValueError(f"unknown permutation {permutation!r}")
        if jacobi_layout not in ("auto", "row", "t"):
            raise ValueError(f"unknown jacobi_layout {jacobi_layout!r}")
        self.x_packed = x_dtype == "2bit"
        if backend is None:
            backend = "pallas" if self.x_packed else "blocked"
        if self.x_packed and backend != "pallas":
            raise ValueError("x_dtype='2bit' requires the pallas backend")
        if not self.x_packed and backend == "pallas":
            raise _not_ported("the dense mode of the strided Jacobi kernel",
                              "Queue 2 entry 1")
        if device is None:
            device = X.device if isinstance(X, torch.Tensor) else "cpu"
        self.device = torch.device(device)

        prepacked = (self.x_packed and isinstance(X, torch.Tensor)
                     and X.dtype == torch.int32)
        if prepacked:
            if not transposed or x_stats is None:
                raise ValueError("pre-packed 2-bit input requires "
                                 "transposed=True and x_stats=(means, sds)")
            M = X.shape[0] if n_markers is None else int(n_markers)
            if not 0 < M <= X.shape[0]:
                raise ValueError(f"n_markers={M} inconsistent with "
                                 f"{X.shape[0]} packed word rows")
            N = X.shape[1] * 16 if n_individuals is None else int(n_individuals)
            if not X.shape[1] * 16 - 2048 < N <= X.shape[1] * 16:
                raise ValueError(
                    f"n_individuals={N} inconsistent with "
                    f"{X.shape[1]} words/marker (lanes pad to 2048)")
        else:
            if not isinstance(X, torch.Tensor):
                X = np.asarray(X)
            M, N = X.shape if transposed else X.shape[::-1]
        if tuple(Y.shape) != (N,):
            raise ValueError("Y must have the same number of rows as X")
        cva2 = _as_2d_cva(cva)
        G, Km1 = cva2.shape
        if G != 1:
            raise _not_ported("per-group slab variances", "Queue 1 item 7")
        if np.any(cva2 <= 0):
            raise ValueError("slab variances must be strictly positive")
        K = Km1 + 1

        B = min(config.block_size, 1 << max(1, (M - 1).bit_length()))
        B = max(8, min(B, config.block_size))
        if self.x_packed:
            J, B, layout = self._plan(M, B, jacobi_blocks, jacobi_layout)
        else:
            if jacobi_blocks not in (None, 1):
                raise ValueError("jacobi_blocks > 1 requires the pallas "
                                 "backend")
            J, layout = 1, "row"
        unit = B * J
        Mpad = -(-M // unit) * unit
        if Mpad // B >= 64:
            unit8 = B * 8 * J // np.gcd(8, J)
            Mpad = -(-M // unit8) * unit8
        self.N, self.M, self.Mpad, self.K, self.G, self.B = N, M, Mpad, K, G, B
        self.F = 0
        self.nb = Mpad // B
        self.jacobi, self.jacobi_layout = J, layout
        self.config, self.variant, self.backend = config, "bayesr", backend
        self.dtype = torch.float32
        if prepacked and X.shape[0] not in (M, Mpad):
            raise ValueError(
                f"pre-packed words have {X.shape[0]} rows; expected the "
                f"true marker count ({M}) or the planned padded count "
                f"({Mpad}, = ops.jacobi.planned_mpad)")

        dev, f32 = self.device, torch.float32
        empty = torch.zeros((0,), dtype=f32, device=dev)
        if self.x_packed:
            q = genotypes.quantize_packed(X, transposed, x_stats, B, Mpad, N,
                                          prepacked=prepacked, device=dev,
                                          m_true=M)
            if q.has_missing:
                raise _not_ported("packed genotypes with missing calls",
                                  "Queue 1 item 7 / Queue 2 entry 1")
            self.Npad = q.Npad
            XT, xsq, gram = q.words, q.xsq, q.gram
            x_mean, x_scale, x_colsum = q.x_mean, q.x_scale, q.x_colsum
            row_valid = q.row_valid
        else:
            self.Npad = N
            XT = torch.as_tensor(X if transposed else X.T, dtype=f32,
                                 device=dev).contiguous()
            xsq = torch.sum(XT * XT, dim=1)
            XT, xsq, _ = bs.pad_markers(XT, xsq, B, mpad=Mpad)
            gram = bs.gram_blocks(XT, B)
            x_mean = x_scale = x_colsum = empty
            row_valid = torch.zeros((0,), dtype=torch.bool, device=dev)

        prior_pi = np.empty((G, K))
        prior_pi[:, 0] = 0.5
        # intended semantics of src/BayesRv2.cpp:150 (SURVEY.md 2.3)
        prior_pi[:, 1:] = 0.5 * cva2 / cva2.sum(axis=1, keepdims=True)
        self.data = MarkerData(
            XT=XT, xsq=xsq, gram=gram,
            g_assign=torch.zeros((Mpad,), dtype=torch.int32, device=dev),
            valid=torch.arange(Mpad, device=dev) < M,
            cva=torch.as_tensor(cva2, dtype=f32, device=dev),
            prior_pi=torch.as_tensor(prior_pi, dtype=f32, device=dev),
            x_mean=x_mean, x_scale=x_scale, row_valid=row_valid,
            x_colsum=x_colsum)
        # packed mode keeps Y (and eps) padded to Npad, pad lanes exactly 0
        Yt = torch.as_tensor(Y, dtype=f32, device=dev)
        if self.Npad != N:
            Yt = torch.cat([Yt, Yt.new_zeros((self.Npad - N,))])
        self.Y = Yt

    @staticmethod
    def _plan(M, B, jacobi_blocks, jacobi_layout):
        """(J, B, layout) of the packed sweep, chosen as the JAX sampler
        chooses it (bayesrrcpp_tpu/models/bayesr.py:194-220)."""
        if jacobi_blocks is None:
            if jacobi_layout == "row":
                J, B = auto_jacobi(M, B)
                layout = "row"
            else:
                J, B, layout = auto_jacobi_plan(M, B)
                if jacobi_layout == "t" and layout != "t":
                    raise ValueError("no transposed jacobi plan for this M; "
                                     "pass jacobi_blocks explicitly")
        else:
            J = int(jacobi_blocks)
            if J < 1:
                raise ValueError("jacobi_blocks must be >= 1")
            layout = "row" if jacobi_layout == "auto" else jacobi_layout
            if layout == "t" and J > 128:
                raise ValueError("jacobi_layout='t' needs jacobi_blocks <= 128")
        if layout != "t" or J == 1:
            raise _not_ported(
                f"the packed {layout}-layout J={J} sweep "
                f"(M={M} has no transposed plan)",
                "Queue 1 item 7 and Queue 2 entries 2, 10")
        return J, B, layout

    # ------------------------------------------------------------------ init

    def variates(self, rng):
        """``rng`` as a variates object: a ``torch.Generator`` on this
        sampler's device becomes a ``TorchVariates``; an object with the
        role methods passes through."""
        if isinstance(rng, torch.Generator):
            if rng.device.type != self.device.type:
                raise ValueError(f"generator on {rng.device}, sampler on "
                                 f"{self.device}")
            return dist.TorchVariates(rng)
        return rng

    def init(self, rng) -> SpikeSlabState:
        """Fresh-chain init (src/BayesRv2.cpp:146-170)."""
        v = self.variates(rng)
        dev, f32 = self.device, torch.float32
        eps = self.Y.clone()     # packed: pad lanes of Y are exactly 0
        return SpikeSlabState(
            iteration=0,
            mu=torch.zeros((), dtype=f32, device=dev),
            beta=torch.zeros((self.Mpad,), dtype=f32, device=dev),
            labels=torch.zeros((self.Mpad,), dtype=torch.int32, device=dev),
            eps=eps,
            sigmaE=torch.sum(eps * eps) / self.N * 0.5,
            sigmaGG=v.init_sigmaGG(self.G).to(f32),
            pi=self.data.prior_pi.clone(),
            alpha=torch.zeros((0,), dtype=f32, device=dev),
            sigmaF=torch.ones((), dtype=f32, device=dev))

    def xbeta(self, beta) -> torch.Tensor:
        """X @ beta, (N,) in individual order, for a (Mpad,) beta tensor."""
        beta = beta.to(torch.float32)
        if self.x_packed:
            d = self.data
            return genotypes.xbeta_packed(d.XT, d.x_mean, d.x_scale, beta,
                                          self.B, self.N)
        return beta @ self.data.XT

    def refresh_eps(self, state: SpikeSlabState) -> SpikeSlabState:
        """Recompute eps = Y - mu - X beta with one fresh pass over X
        (ChainConfig.eps_refresh_every; bounds the f32 drift of the rank-1
        residual updates)."""
        xb = self.xbeta(state.beta)
        if self.Npad != self.N:
            xb = torch.cat([xb, xb.new_zeros((self.Npad - self.N,))])
        eps = self.Y - xb - state.mu
        if self.x_packed:
            eps = torch.where(self.data.row_valid, eps, 0.0)
        return state.replace(eps=eps)

    # ------------------------------------------------------------------ step

    def _pre_sweep(self, state: SpikeSlabState, v):
        """Intercept update (src/BayesRv2.cpp:177-179); sigma0 is accepted
        but unused, exactly like the reference.  The mean runs over the N
        real individuals only."""
        N = self.N
        if self.x_packed:
            rv = self.data.row_valid
            eps = torch.where(rv, state.eps + state.mu, 0.0)
            mu = dist.norm(torch.sum(eps) / N, state.sigmaE / N, v.mu_noise())
            eps = torch.where(rv, eps - mu, 0.0)
        else:
            eps = state.eps + state.mu
            mu = dist.norm(torch.sum(eps) / N, state.sigmaE / N, v.mu_noise())
            eps = eps - mu
        return mu, eps

    def _hyper_block(self, v, eps, beta, counts, bacc):
        """Post-sweep hyperparameter draws (src/BayesRv2.cpp:247-255)."""
        cfg = self.config
        N, G = self.N, self.G
        dof_e = cfg.v0E + N
        sigmaE = dist.inv_scaled_chisq(
            dof_e, (torch.sum(eps * eps) + cfg.v0E * cfg.s02E) / dof_e,
            v.sigmaE_gamma(0.5 * dof_e))
        m0 = torch.sum(counts, dim=1) - counts[:, 0]             # (G,)
        # C1 uses the full |beta|^2, not the per-sweep accumulator
        # (src/BayesRv2.cpp:248); padding betas are identically 0
        ss = torch.sum(beta * beta).expand(G)
        if cfg.reference_sigma_g_scaling:
            scale_g = (ss * m0 + cfg.v0G * cfg.s02G) / (cfg.v0G + m0)
        else:
            scale_g = (ss + cfg.v0G * cfg.s02G) / (cfg.v0G + m0)
        dof_g = cfg.v0G + m0
        sigmaGG = dist.inv_scaled_chisq(dof_g, scale_g,
                                        v.sigmaG_gamma(0.5 * dof_g))
        pi = dist.dirichlet(v.pi_gamma(counts + 1.0))
        return sigmaE.to(torch.float32), sigmaGG, pi

    def step(self, state: SpikeSlabState, rng) -> SpikeSlabState:
        """One Gibbs iteration; enqueues device work only."""
        v = self.variates(rng)
        v.begin_step()
        mu, eps = self._pre_sweep(state, v)
        d = self.data
        Mpad, B, nb = self.Mpad, self.B, self.nb
        if self.x_packed:
            rho, inner = v.orders(nb, B, self.jacobi)
            p, z = v.p(Mpad), v.z(Mpad)
            res = bayesr_jacobi_t(
                d.XT, d.gram, d.xsq, eps, state.beta, state.labels, rho,
                inner, p, z, state.pi, d.cva, state.sigmaE, state.sigmaGG,
                d.g_assign, d.valid, J=self.jacobi, x_mean=d.x_mean,
                x_scale=d.x_scale, x_xsum=d.x_colsum, fold_affine=True,
                row_valid=d.row_valid)
        else:
            border, inner = v.block_orders(nb, B)
            p, z = v.p(Mpad), v.z(Mpad)
            res = bs.bayesr_block_sweep(
                d.XT, d.gram, d.xsq, eps, state.beta, state.labels, border,
                inner, p, z, state.pi, d.cva, state.sigmaE, state.sigmaGG,
                d.g_assign, d.valid)
        sigmaE, sigmaGG, pi = self._hyper_block(v, res.eps, res.beta, res.v,
                                                res.beta_acum)
        return SpikeSlabState(
            iteration=state.iteration + 1, mu=mu, beta=res.beta,
            labels=res.labels, eps=res.eps, sigmaE=sigmaE, sigmaGG=sigmaGG,
            pi=pi, alpha=state.alpha, sigmaF=state.sigmaF)

    # ------------------------------------------------------------------ run

    def _run_steps(self, state, v, n):
        for _ in range(n):
            state = self.step(state, v)
        return state

    def _emit_one(self, state: SpikeSlabState):
        M, N = self.M, self.N
        eps = (state.eps[:N] if self.config.emit_epsilon
               else state.eps.new_zeros((0,)))
        return {
            "mu": state.mu,
            "beta": state.beta[:M],
            "sigmaE": state.sigmaE,
            "sigmaG": state.sigmaGG,
            # int8: labels are < K <= 127; a 4x smaller copy to the host
            "comp": state.labels[:M].to(torch.int8),
            "epsilon": eps,
            "alpha": state.alpha,
            "sigmaF": state.sigmaF,
        }

    def _emit_chunk(self, state, v, n_emits, thinning):
        rows, iters = [], []
        for _ in range(n_emits):
            state = self._run_steps(state, v, thinning)
            rows.append(self._emit_one(state))
            iters.append(state.iteration - 1)
        out = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        out["iteration"] = np.asarray(iters, np.int64)
        return state, out

    def run(self, rng, chain: ChainConfig, *, state=None, sink=None,
            collect: bool = True, emit_chunk: int = 32, progress=None):
        """Run a chain from ``state`` (default: a fresh ``init``), emitting
        thinned post-burn-in samples to ``sink`` and, with ``collect``, as
        NumPy arrays stacked over emissions.  ``rng`` is a
        ``torch.Generator`` on the sampler's device or a variates object.
        Multi-chain runs are ROADMAP Queue 1 item 9.
        """
        from .driver import run_chain

        v = self.variates(rng)
        if state is None:
            state = self.init(v)
        return run_chain(
            state, chain,
            steps_fn=lambda st, n: self._run_steps(st, v, n),
            emit_fn=lambda st, n, t: self._emit_chunk(st, v, n, t),
            sink=sink, collect=collect, emit_chunk=emit_chunk,
            start_iteration=state.iteration, progress=progress,
            refresh_fn=self.refresh_eps)

    def run_chains(self, *args, **kwargs):
        raise _not_ported("running several chains", "Queue 1 item 9")
