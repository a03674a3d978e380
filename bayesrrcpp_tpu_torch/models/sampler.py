"""What the BayesR and horseshoe samplers share.

Both sweep the same genotype storage with the same plan, and around the
sweep both draw the intercept, recompute the residual and drive a chain
the same way (bayesrrcpp_tpu/models/bayesr.py and horseshoe.py repeat
this code; here it lives once).  ``MarkerSampler`` holds it;
``models/bayesr.py`` and ``models/horseshoe.py`` add their priors, state
and steps (``init``, ``step``, ``step_chains``, ``_emit_one``).

The sweep kernels ("pallas" backend) take 2-bit packed words, int8 codes
and dense f32 rows alike, with the JAX samplers' plan: the strided sweep in
the "t" layout, the row-layout sweep at J > 1 in the "row" layout, the
serial sweep at J=1.  Dense X on the CPU defaults to the plain Gram-blocked
sweep ("blocked"), as JAX's does off its accelerator
(bayesrrcpp_tpu/models/bayesr.py:121-128).  Quantized X with missing
calls (code 3) takes the sweeps' missing-call modes, routed as the JAX
samplers route them (bayesr.py:278-300): on words the strided kernels'
``miss`` mode at J > 1, on words and int8 codes the serial kernels'
in-kernel decode at J=1 (``_sweep_kw``); a row plan has none, and int8
codes have no strided one (``_row_plan``).  int8 codes keep eps and Y in
individual order with no pad lanes (Npad == N, no ``row_valid``), as
dense X does.

The state runs in ``dtype``, float32 (the default) or float64, as the JAX
samplers take it (bayesr.py:111): the plain sweeps ("blocked", and "scan",
the literal per-marker sweep of ``ops/sweep.py`` in any marker order,
``permutation="full"`` its default) compute in it; the kernels compute in
float32, and under a float64 state they take float32 casts of their operands
and give their outputs back in float64, as JAX's Pallas wrappers do
(pallas_jacobi_t.py:1048-1055), or raise ``ValueError`` where JAX's kernel
raises (``_F64_RAISES``).

Several chains (``run_chains``) are one state whose tensors carry a
leading chain axis C (``init(rng, chains=C)``).  On the kernel backend a
fused step (``step_chains``) sweeps all chains with one set of launches per
round (strided plan) or per block (the serial sweep, at J=1 and, as in
JAX, on a row plan; not on words with missing calls); otherwise each chain
takes the single-chain step in turn.
The intercept, residual recompute and emission below serve both shapes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import distributions as dist
from ..config import ChainConfig
from ..ops import block_sweep as bs
from ..ops import genotypes
from ..ops.jacobi import auto_jacobi, auto_jacobi_plan


class Genotypes(NamedTuple):
    """X on the sampler's device with the statistics the sweeps read."""

    XT: torch.Tensor         # (Mpad, Npad/16) int32 words, (Mpad, N) int8
    #                          codes or (Mpad, N) f32 rows
    xsq: torch.Tensor        # (Mpad,) per-marker squared norms
    gram: torch.Tensor       # (nb, B, B) block Gram matrices
    valid: torch.Tensor      # (Mpad,) bool, False on padding markers
    x_mean: torch.Tensor     # (Mpad,) dosage means ((0,) when dense)
    x_scale: torch.Tensor    # (Mpad,) 1/sd scales ((0,) when dense)
    row_valid: torch.Tensor  # (Npad,) bool, individual n < N ((0,) dense
    #                          or int8)
    x_colsum: torch.Tensor   # (Mpad,) decoded column sums ((0,) dense)
    has_missing: bool = False  # quantized X holds missing calls (code 3)


def resolve_dtype(dtype) -> torch.dtype:
    """The state's dtype: float32 (the default, ``None``) or float64, given
    as a torch or NumPy dtype or its name."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        try:
            out = {np.dtype(np.float32): torch.float32,
                   np.dtype(np.float64): torch.float64}.get(np.dtype(dtype))
        except TypeError:
            out = None
    if out not in (torch.float32, torch.float64):
        raise ValueError(f"dtype={dtype!r}: the samplers run in float32 or "
                         "float64")
    return out


def numpy_dtype(dtype: torch.dtype):
    """The NumPy dtype of a state's torch dtype (float32 or float64)."""
    return np.float64 if dtype == torch.float64 else np.float32


# JAX's Pallas kernels that raise ValueError under a float64 state (dtype=
# float64 in interpret mode on the CPU: "Invalid dtype for `swap`"), each
# with whether it raises for dense X only; the strided sweeps (#1-#8), the
# row-layout BayesR sweep (#16) and the round solves (#13, #14) run on
# float32 casts of their operands instead
_F64_RAISES = {
    "bayesr_sweep_pallas": True,
    "bayesr_sweep_pallas_mc": True,
    "horseshoe_sweep_pallas_mc": True,
    "horseshoe_sweep_pallas": False,
    "horseshoe_jacobi_pallas": False,
}


class MarkerSampler:
    """Genotype layout, intercept, residual recompute and chain driver of
    a sampler over a fixed (X, Y).  A subclass calls ``_storage``,
    ``_read_x`` and ``_lay_out`` from its ``__init__`` and sets
    ``self.data`` (a NamedTuple with the fields of ``Genotypes``) and
    ``self.config``."""

    def _storage(self, x_dtype, backend, permutation, jacobi_layout,
                 dtype=None):
        """Check the storage and sweep options; sets ``x_packed``,
        ``x_int8``, ``dtype``, ``permutation`` and ``backend``: the sweep
        kernels ("pallas": strided or row-layout Jacobi, or serial at J=1),
        which quantized X (2-bit words, int8 codes) needs, the plain
        Gram-blocked sweep ("blocked", dense X only) or the literal scan
        ("scan", dense X only).  None for dense X is resolved by the device
        in ``_read_x``, and the permutation with it (bayesr.py:129-136)."""
        if x_dtype not in ("dense", "int8", "2bit"):
            raise ValueError(f"unknown x_dtype {x_dtype!r}")
        if backend not in (None, "blocked", "pallas", "scan"):
            raise ValueError(f"unknown backend {backend!r}")
        if permutation not in (None, "blocked", "full"):
            raise ValueError(f"unknown permutation {permutation!r}")
        if jacobi_layout not in ("auto", "row", "t"):
            raise ValueError(f"unknown jacobi_layout {jacobi_layout!r}")
        self.x_packed = x_dtype == "2bit"
        self.x_int8 = x_dtype == "int8"
        self.dtype = resolve_dtype(dtype)
        if backend is None and x_dtype != "dense":
            backend = "pallas"
        if x_dtype != "dense" and backend != "pallas":
            raise ValueError(f"x_dtype={x_dtype!r} requires the pallas "
                             "backend")
        self.backend = backend
        self.permutation = permutation

    def _read_x(self, X, Y, transposed, x_stats, n_individuals, n_markers,
                device):
        """(X, prepacked, M, N) of the input; sets ``device``: the given
        one, else X's for a tensor X, else the card.  Without a card, only
        an explicit CPU device (or a CPU tensor X) runs."""
        if device is None:
            device = X.device if isinstance(X, torch.Tensor) else "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the samplers run on the card; pass "
                "device='cpu' to run on the CPU")
        if self.backend is None:
            # dense X: the kernels on the card, the plain sweep elsewhere
            self.backend = "pallas" if self.device.type == "cuda" else "blocked"
        if self.permutation is None:
            self.permutation = "full" if self.backend == "scan" else "blocked"
        if self.backend != "scan" and self.permutation != "blocked":
            raise ValueError(f"{self.backend} backend requires blocked "
                             "permutation")
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
        if self.backend == "pallas":
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
        if prepacked and X.shape[0] not in (M, Mpad):
            raise ValueError(
                f"pre-packed words have {X.shape[0]} rows; expected the "
                f"true marker count ({M}) or the planned padded count "
                f"({Mpad}, = ops.jacobi.planned_mpad)")

        dev, f32, dt = self.device, torch.float32, self.dtype
        empty = torch.zeros((0,), dtype=f32, device=dev)
        valid = torch.arange(Mpad, device=dev) < M
        if self.x_packed:
            q = genotypes.quantize_packed(X, transposed, x_stats, B, Mpad, N,
                                          prepacked=prepacked, device=dev,
                                          m_true=M)
            self._row_plan(q.has_missing, jacobi_blocks is None)
            self.Npad = q.Npad
            geno = Genotypes(
                XT=q.words, xsq=q.xsq, gram=q.gram, valid=valid,
                x_mean=q.x_mean, x_scale=q.x_scale, row_valid=q.row_valid,
                x_colsum=q.x_colsum, has_missing=q.has_missing)
        elif self.x_int8:
            # the codes as given when they are a marker-major int8 tensor
            # of Mpad rows on the device (no copy), else cast and padded
            q = genotypes.quantize_int8(X, transposed, x_stats, B, Mpad,
                                        device=dev)
            self._row_plan(q.has_missing, jacobi_blocks is None)
            self.Npad = N
            geno = Genotypes(
                XT=q.codes, xsq=q.xsq, gram=q.gram, valid=valid,
                x_mean=q.x_mean, x_scale=q.x_scale, x_colsum=q.x_colsum,
                row_valid=torch.zeros((0,), dtype=torch.bool, device=dev),
                has_missing=q.has_missing)
        else:
            self._row_plan(False, jacobi_blocks is None)
            self.Npad = N
            XT = X if transposed else X.T
            if not isinstance(XT, torch.Tensor):
                # marker-major in the state's dtype on the host, then one
                # transfer
                XT = np.ascontiguousarray(XT, dtype=numpy_dtype(dt))
            XT = torch.as_tensor(XT, dtype=dt, device=dev).contiguous()
            xsq = torch.sum(XT * XT, dim=1)
            XT, xsq, _ = bs.pad_markers(XT, xsq, B, mpad=Mpad)
            geno = Genotypes(
                XT=XT, xsq=xsq, gram=bs.gram_blocks(XT, B), valid=valid,
                x_mean=empty, x_scale=empty, x_colsum=empty,
                row_valid=torch.zeros((0,), dtype=torch.bool, device=dev))
        # packed mode keeps Y (and eps) padded to Npad, pad lanes exactly 0
        Yt = torch.as_tensor(Y, dtype=dt, device=dev)
        if self.Npad != N:
            Yt = torch.cat([Yt, Yt.new_zeros((self.Npad - N,))])
        self.Y = Yt
        return geno

    @staticmethod
    def _plan(M, B, jacobi_blocks, jacobi_layout):
        """(J, B, layout) of the kernels' sweep, chosen as the JAX samplers
        choose it (bayesrrcpp_tpu/models/bayesr.py:194-220).  J=1, in
        either layout and from the auto plan for M < 2048 too, runs the
        exact serial sweep (ops/serial.py), as any J=1 runs
        ``bayesr_sweep_pallas`` in JAX (bayesr.py:587-645); J > 1 runs the
        strided-rounds sweep (ops/jacobi_t.py) in the "t" layout and the
        row-layout sweep (ops/jacobi.py) in the "row" layout, which an
        explicit ``jacobi_blocks`` gets by default."""
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
        return J, B, layout

    def _row_plan(self, has_missing, auto):
        """A plan with J > 1 sweeps dense X or quantized X without missing
        calls, and words with missing calls in the "t" layout (the strided
        kernels' ``miss`` mode); otherwise, on quantized X with missing
        calls (int8 codes in either layout), the auto plan falls back to
        J=1 and an explicit one is refused, as in the JAX samplers
        (bayesr.py:290-300)."""
        if (self.jacobi == 1 or not has_missing
                or (self.jacobi_layout == "t" and self.x_packed)):
            return
        if auto:
            self.jacobi = 1
        else:
            raise ValueError("jacobi_blocks > 1 supports dense, missing-free "
                             "quantized, or packed-missing "
                             "(jacobi_layout='t') X only")

    @property
    def strided(self) -> bool:
        """Whether the plan sweeps strided rounds (the "t" layout, J > 1);
        the row layout at J > 1 and every J=1 plan sweep the flat block
        order."""
        return self.jacobi > 1 and self.jacobi_layout == "t"

    def _sweep_kw(self):
        """The kernel sweeps' storage keyword arguments for ``self.data``:
        ``x_mean=None`` for dense rows; for words and int8 codes the
        fold-affine mode, or with missing calls the strided kernels'
        ``miss`` mode (words only) or the serial kernels' in-kernel decode
        (J=1), as the JAX samplers pass them (bayesr.py:278-287,
        :590-607).  Words also take their lane mask."""
        d = self.data
        if not (self.x_packed or self.x_int8):
            return dict(x_mean=None)
        miss = bool(d.has_missing)
        kw = dict(x_mean=d.x_mean, x_scale=d.x_scale, x_xsum=d.x_colsum,
                  fold_affine=not miss)
        if self.x_packed:
            kw["row_valid"] = d.row_valid
            if self.strided:
                kw["missing"] = miss
        return kw

    # ------------------------------------------------------------ helpers

    def variates(self, rng, chains: Optional[int] = None):
        """``rng`` as a variates object: a ``torch.Generator`` on this
        sampler's device becomes a ``TorchVariates`` (drawing a leading
        chain axis of ``chains``); an object with the role methods passes
        through."""
        if isinstance(rng, torch.Generator):
            if rng.device.type != self.device.type:
                raise ValueError(f"generator on {rng.device}, sampler on "
                                 f"{self.device}")
            return dist.TorchVariates(rng, self.dtype, chains=chains)
        return rng

    def xbeta(self, beta) -> torch.Tensor:
        """X @ beta, (..., N) in individual order, for a (..., Mpad) beta
        tensor (one chain or a leading chain axis) or an (M,) array (e.g.
        a CSV row's, ``io/resume.py``), padded here."""
        if not isinstance(beta, torch.Tensor):
            beta = np.asarray(beta, np.float64).reshape(-1)
            if beta.shape[0] != self.M:
                raise ValueError("beta must have length M")
            beta = torch.as_tensor(np.pad(beta, (0, self.Mpad - self.M)),
                                   device=self.device)
        beta = beta.to(torch.float32)
        if self.x_packed or self.x_int8:
            d = self.data
            return genotypes.xbeta_packed(d.XT, d.x_mean, d.x_scale, beta,
                                          self.B, self.N)
        return beta @ self._f32(self.data.XT)

    def refresh_eps(self, state):
        """Recompute eps = Y - mu - X beta (- alpha F) with one fresh pass
        over X (ChainConfig.eps_refresh_every; bounds the f32 drift of the
        rank-1 residual updates); one chain or a leading chain axis.  In
        float32, then cast to the state's dtype, as JAX's _refresh_impl
        (bayesr.py:472-495)."""
        f32 = torch.float32
        xb = self.xbeta(state.beta)
        xb = torch.nn.functional.pad(xb, (0, self.Y.shape[-1] - xb.shape[-1]))
        eps = self.Y.to(f32) - xb - state.mu.to(f32)[..., None]
        if getattr(self, "F", 0) > 0:
            eps = eps - state.alpha.to(f32) @ self._f32(self.data.fixedT)
        mask = self._lane_mask()
        if mask is not None:
            eps = torch.where(mask, eps, 0.0)
        return state.replace(eps=eps.to(self.dtype))

    # ------------------------------------------------------------ kernels

    def _f32(self, t):
        """``t`` in float32, the kernels' dtype: itself in a float32 state;
        a cast, kept once for X and the Gram blocks (static data), under a
        float64 state."""
        if not (isinstance(t, torch.Tensor) and t.is_floating_point()) \
                or t.dtype == torch.float32:
            return t
        d = self.data
        if not any(t is getattr(d, f, None) for f in ("XT", "gram",
                                                     "fixedT")):
            return t.to(torch.float32)
        cache = self.__dict__.setdefault("_f32_static", {})
        hit = cache.get(id(t))
        if hit is None or hit[0] is not t:
            hit = cache[id(t)] = (t, t.to(torch.float32))
        return hit[1]

    def _kernel(self, sweep, *args, **kw):
        """``sweep(*args, **kw)``, a kernel wrapper.  Under a float64 state
        its float operands go in as float32 and its float outputs come back
        in float64, as JAX's Pallas wrappers cast them; a float32 state
        calls it as it is."""
        if self.dtype == torch.float32:
            return sweep(*args, **kw)
        res = sweep(*(self._f32(a) for a in args), **kw)
        out = [t.to(self.dtype) if t.is_floating_point() else t for t in res]
        return type(res)(*out) if hasattr(res, "_fields") else tuple(out)

    def _f64_check(self, kernel: str):
        """Under a float64 state, raise ``ValueError`` where JAX's Pallas
        ``kernel`` raises (``_F64_RAISES``): the port computes in no dtype
        other than JAX's."""
        if self.dtype == torch.float32 or kernel not in _F64_RAISES:
            return
        if _F64_RAISES[kernel] and (self.x_packed or self.x_int8):
            return
        raise ValueError(
            f"dtype=float64 on this plan sweeps through {kernel}, whose JAX "
            "Pallas kernel takes no float64 state (it raises ValueError); "
            "use backend='blocked' or 'scan', or a strided plan")

    def _lane_mask(self):
        """The lanes of eps that hold an individual (the packed layout's
        row_valid), or None where every lane does."""
        return self.data.row_valid if self.x_packed else None

    def _psum(self, t, axis: str):
        """``t`` summed over the mesh axis ``axis`` ("m": the markers, "n":
        the individuals) of a sharded sampler; here the whole of both."""
        return t

    def _intercept(self, state, v):
        """Intercept update (src/BayesRv2.cpp:177-179,
        src/HorseshoeR.cpp:210-212): (mu, eps), per chain.  The mean runs
        over the N real individuals only; pad lanes stay 0."""
        N = self.N
        mask = self._lane_mask()
        eps = state.eps + state.mu[..., None]
        if mask is not None:
            eps = torch.where(mask, eps, 0.0)
        mu = dist.norm(self._psum(torch.sum(eps, dim=-1), "n") / N,
                       state.sigmaE / N, v.mu_noise())
        eps = eps - mu[..., None]
        if mask is not None:
            eps = torch.where(mask, eps, 0.0)
        return mu, eps

    # ------------------------------------------------------------------ run

    @property
    def supports_fused_chains(self) -> bool:
        """Whether ``step_chains`` sweeps all chains with the fused kernel:
        on the kernel backend, dense or quantized X through the strided
        Jacobi kernel, or through the serial one (at J=1 and on a row plan,
        which holds no missing call) unless the codes or words hold missing
        calls (the fused serial sweep has no in-kernel decode, in JAX
        neither: bayesr.py:733-743; int8 codes with missing calls always
        run at J=1).  The plain backend runs its chains through the
        single-chain step."""
        return self.backend == "pallas" and (self.jacobi > 1
                                             or not self.data.has_missing)

    def _run_steps(self, state, v, n):
        for _ in range(n):
            state = self.step(state, v)
        return state

    def _step_unfused(self, state, v):
        """One iteration of every chain of ``state`` through the
        single-chain step, each chain with its own variates (and so its
        own orders), as the JAX package's vmapped fallback."""
        fields = [f.name for f in dataclasses.fields(state)
                  if f.name != "iteration"]
        steps = [self.step(state.replace(**{k: getattr(state, k)[c]
                                            for k in fields}),
                           v.for_chain(c))
                 for c in range(state.beta.shape[0])]
        return steps[0].replace(**{k: torch.stack([getattr(st, k)
                                                   for st in steps])
                                   for k in fields})

    def _emit_chunk(self, state, advance, n_emits, thinning):
        """n_emits emissions, each after ``advance(state, thinning)``;
        fields stacked over the emissions, with the chain axis (if any)
        after it, as the JAX package's vmapped ``_emit_one``."""
        rows, iters = [], []
        for _ in range(n_emits):
            state = advance(state, thinning)
            rows.append(self._emit_one(state))
            iters.append(np.full(state.beta.shape[:-1], state.iteration - 1,
                                 np.int64))
        out = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        out["iteration"] = np.stack(iters)
        return state, out

    def _emit_epsilon(self, state) -> torch.Tensor:
        eps = state.eps
        return (eps[..., :self.N] if self.config.emit_epsilon
                else eps.new_zeros(eps.shape[:-1] + (0,)))

    def run(self, rng, chain: ChainConfig, *, state=None, sink=None,
            collect: bool = True, emit_chunk: int = 32, progress=None,
            on_chunk=None):
        """Run a chain from ``state`` (default: a fresh ``init``), emitting
        thinned post-burn-in samples to ``sink`` and, with ``collect``, as
        NumPy arrays stacked over emissions.  ``rng`` is a
        ``torch.Generator`` on the sampler's device or a variates object.
        ``on_chunk(state, done)`` is called with the newest state after
        each delivered chunk (``models/driver.run_chain``): a checkpoint
        of that state with ``rng``'s state there resumes the chain bitwise
        (``io/checkpoint.py``).
        """
        from .driver import run_chain

        v = self.variates(rng)
        if state is None:
            state = self.init(v)

        def advance(st, n):
            return self._run_steps(st, v, n)

        return run_chain(
            state, chain, steps_fn=advance,
            emit_fn=lambda st, n, t: self._emit_chunk(st, advance, n, t),
            sink=sink, collect=collect, emit_chunk=emit_chunk,
            start_iteration=state.iteration, progress=progress,
            on_chunk=on_chunk, refresh_fn=self.refresh_eps)

    def run_chains(self, rng, n_chains: int, chain: ChainConfig, *,
                   fused: Optional[bool] = None, sink=None,
                   collect: bool = True, emit_chunk: int = 32,
                   progress=None, on_chunk=None):
        """Run ``n_chains`` independent chains from fresh inits, batched on
        the sampler's device (bayesrrcpp_tpu/models/bayesr.py:828-864);
        ``on_chunk`` as ``run``'s.

        ``fused=True`` (the default where ``supports_fused_chains``) sweeps
        all chains with one fused kernel per round (``step_chains``): the
        words are read once per round for all chains, which share the
        visit order and draw their own p/z.  ``fused=False`` steps each
        chain through the single-chain step with its own orders; it is the
        only option on the plain backend and on quantized X with missing
        calls at J=1, where ``fused=True`` raises ValueError.
        ``rng`` is a ``torch.Generator`` on the sampler's device or a
        chain-batched variates object.  Collected arrays are (n_emits,
        n_chains, ...); a ``ChainFanoutSink`` writes one file per chain.
        """
        from .driver import run_chain

        if fused is None:
            fused = self.supports_fused_chains
        if fused and not self.supports_fused_chains:
            raise ValueError("fused multi-chain runs need the sweep kernels "
                             "(backend 'pallas'), with no missing call at "
                             "J=1; run these with fused=False")
        v = self.variates(rng, n_chains)
        state = self.init(v, chains=n_chains)
        if fused:
            def advance(st, n):
                for _ in range(n):
                    st = self.step_chains(st, v)
                return st
        else:
            def advance(st, n):
                for _ in range(n):
                    st = self._step_unfused(st, v)
                return st
        return run_chain(
            state, chain, steps_fn=advance,
            emit_fn=lambda st, n, t: self._emit_chunk(st, advance, n, t),
            sink=sink, collect=collect, emit_chunk=emit_chunk,
            progress=progress, on_chunk=on_chunk,
            refresh_fn=self.refresh_eps)
