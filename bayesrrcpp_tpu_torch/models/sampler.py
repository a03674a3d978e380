"""What the BayesR and horseshoe samplers share.

Both sweep the same genotype storage with the same plan, and around the
sweep both draw the intercept, recompute the residual and drive a chain
the same way (bayesrrcpp_tpu/models/bayesr.py and horseshoe.py repeat
this code; here it lives once).  ``MarkerSampler`` holds it;
``models/bayesr.py`` and ``models/horseshoe.py`` add their priors, state
and step (``init``, ``step``, ``_emit_one``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import distributions as dist
from ..config import ChainConfig
from ..ops import block_sweep as bs
from ..ops import genotypes
from ..ops.jacobi import auto_jacobi, auto_jacobi_plan


class Genotypes(NamedTuple):
    """X on the sampler's device with the statistics the sweeps read."""

    XT: torch.Tensor         # (Mpad, Npad/16) int32 words, or (Mpad, N) f32
    xsq: torch.Tensor        # (Mpad,) per-marker squared norms
    gram: torch.Tensor       # (nb, B, B) block Gram matrices
    valid: torch.Tensor      # (Mpad,) bool, False on padding markers
    x_mean: torch.Tensor     # (Mpad,) dosage means ((0,) when dense)
    x_scale: torch.Tensor    # (Mpad,) 1/sd scales ((0,) when dense)
    row_valid: torch.Tensor  # (Npad,) bool, individual n < N ((0,) dense)
    x_colsum: torch.Tensor   # (Mpad,) decoded column sums ((0,) dense)


def not_ported(what: str, entry: str):
    return NotImplementedError(
        f"{what} is not ported to bayesrrcpp_tpu_torch yet (ROADMAP {entry})")


class MarkerSampler:
    """Genotype layout, intercept, residual recompute and chain driver of
    a sampler over a fixed (X, Y).  A subclass calls ``_storage``,
    ``_read_x`` and ``_lay_out`` from its ``__init__`` and sets
    ``self.data`` (a NamedTuple with the fields of ``Genotypes``) and
    ``self.config``."""

    def _storage(self, x_dtype, backend, permutation, jacobi_layout,
                 dense_kernel_entry: str) -> str:
        """Check the storage and sweep options; sets ``x_packed`` and
        returns the backend: the strided Jacobi kernel ("pallas") for
        2-bit packed X, the plain Gram-blocked sweep ("blocked") for dense
        X."""
        if x_dtype not in ("dense", "int8", "2bit"):
            raise ValueError(f"unknown x_dtype {x_dtype!r}")
        if x_dtype == "int8":
            raise not_ported("int8 genotype storage", "Queue 1 item 7")
        if backend == "scan" or permutation == "full":
            raise not_ported("the sequential scan sweep", "Queue 1 item 3")
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
            raise not_ported("the dense mode of the strided Jacobi kernel",
                             dense_kernel_entry)
        return backend

    def _read_x(self, X, Y, transposed, x_stats, n_individuals, n_markers,
                device):
        """(X, prepacked, M, N) of the input; sets ``device``."""
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
        return X, prepacked, M, N

    def _lay_out(self, X, Y, M, N, block_size, *, prepacked, transposed,
                 x_stats, jacobi_blocks, jacobi_layout) -> Genotypes:
        """Plan the sweep, pad the markers and put X and Y on the device;
        sets the layout attributes (N, M, Mpad, B, nb, jacobi,
        jacobi_layout, Npad, Y)."""
        B = max(8, min(block_size, 1 << max(1, (M - 1).bit_length())))
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
        self.N, self.M, self.Mpad, self.B = N, M, Mpad, B
        self.nb = Mpad // B
        self.jacobi, self.jacobi_layout = J, layout
        self.dtype = torch.float32
        if prepacked and X.shape[0] not in (M, Mpad):
            raise ValueError(
                f"pre-packed words have {X.shape[0]} rows; expected the "
                f"true marker count ({M}) or the planned padded count "
                f"({Mpad}, = ops.jacobi.planned_mpad)")

        dev, f32 = self.device, torch.float32
        empty = torch.zeros((0,), dtype=f32, device=dev)
        valid = torch.arange(Mpad, device=dev) < M
        if self.x_packed:
            q = genotypes.quantize_packed(X, transposed, x_stats, B, Mpad, N,
                                          prepacked=prepacked, device=dev,
                                          m_true=M)
            if q.has_missing:
                raise not_ported("packed genotypes with missing calls",
                                 "Queue 1 item 7 / Queue 2 entry 1")
            self.Npad = q.Npad
            geno = Genotypes(
                XT=q.words, xsq=q.xsq, gram=q.gram, valid=valid,
                x_mean=q.x_mean, x_scale=q.x_scale, row_valid=q.row_valid,
                x_colsum=q.x_colsum)
        else:
            self.Npad = N
            XT = torch.as_tensor(X if transposed else X.T, dtype=f32,
                                 device=dev).contiguous()
            xsq = torch.sum(XT * XT, dim=1)
            XT, xsq, _ = bs.pad_markers(XT, xsq, B, mpad=Mpad)
            geno = Genotypes(
                XT=XT, xsq=xsq, gram=bs.gram_blocks(XT, B), valid=valid,
                x_mean=empty, x_scale=empty, x_colsum=empty,
                row_valid=torch.zeros((0,), dtype=torch.bool, device=dev))
        # packed mode keeps Y (and eps) padded to Npad, pad lanes exactly 0
        Yt = torch.as_tensor(Y, dtype=f32, device=dev)
        if self.Npad != N:
            Yt = torch.cat([Yt, Yt.new_zeros((self.Npad - N,))])
        self.Y = Yt
        return geno

    @staticmethod
    def _plan(M, B, jacobi_blocks, jacobi_layout):
        """(J, B, layout) of the packed sweep, chosen as the JAX samplers
        choose it (bayesrrcpp_tpu/models/bayesr.py:194-220)."""
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
            raise not_ported(
                f"the packed {layout}-layout J={J} sweep "
                f"(M={M} has no transposed plan)",
                "Queue 1 item 7 and Queue 2 entries 2, 4, 10")
        return J, B, layout

    # ------------------------------------------------------------ helpers

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

    def xbeta(self, beta) -> torch.Tensor:
        """X @ beta, (N,) in individual order, for a (Mpad,) beta tensor."""
        beta = beta.to(torch.float32)
        if self.x_packed:
            d = self.data
            return genotypes.xbeta_packed(d.XT, d.x_mean, d.x_scale, beta,
                                          self.B, self.N)
        return beta @ self.data.XT

    def refresh_eps(self, state):
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

    def _intercept(self, state, v):
        """Intercept update (src/BayesRv2.cpp:177-179,
        src/HorseshoeR.cpp:210-212): (mu, eps).  The mean runs over the N
        real individuals only; pad lanes of the packed layout stay 0."""
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

    # ------------------------------------------------------------------ run

    def _run_steps(self, state, v, n):
        for _ in range(n):
            state = self.step(state, v)
        return state

    def _emit_chunk(self, state, v, n_emits, thinning):
        rows, iters = [], []
        for _ in range(n_emits):
            state = self._run_steps(state, v, thinning)
            rows.append(self._emit_one(state))
            iters.append(state.iteration - 1)
        out = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        out["iteration"] = np.asarray(iters, np.int64)
        return state, out

    def _emit_epsilon(self, state) -> torch.Tensor:
        return (state.eps[:self.N] if self.config.emit_epsilon
                else state.eps.new_zeros((0,)))

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
        raise not_ported("running several chains", "Queue 1 item 9")
