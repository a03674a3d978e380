"""Marker-sharded BayesR sampler on an (m, 1) mesh of processes.

Counterpart of ``bayesrrcpp_tpu/parallel/sharded.py:ShardedSpikeSlabSampler``
on an (m, 1) mesh, for one chain and fused chains.  One process drives
one card and holds one m-slice: Mloc = Mpad / Dm contiguous markers, their
words (or dense rows), Gram blocks and statistics, and their beta and
labels.  eps (all individuals, natural order) and the scalars are
replicated: every rank holds them whole.

- **The sweep.**  Each slice sweeps its own blocks.  With the kernels
  ("pallas") it runs the strided-rounds sweep of its own plan
  (``auto_jacobi_plan(ceil(M/Dm), B)``, "t" layouts only) in chunks of
  rounds, ``bayesr_jacobi_t_rounds`` (csrc/jacobi_t.cu), with one
  all-reduce of the chunk's eps update over "m" after each chunk
  (sharded.py:656-739): across slices the chunk is block-Jacobi, each
  slice seeing eps as of the chunk's start.  A slice whose plan is not
  "t" runs the serial kernel (``ops/serial.bayesr_sweep``) on chunks of
  ``chunk_blocks`` blocks (:615-654).  ``backend="xla"``, JAX's default,
  sweeps one block a round in plain torch with an all-reduce per block
  (:570-605).  At Dm = 1 the whole sweep is one chunk.
- **Fused chains** (``step_chains``, ``run_chains``) run the same chunks
  through ``bayesr_jacobi_t_mc_rounds`` (csrc/jacobi_t_mc.cu), all chains
  sharing the visit order (:840-1043), or the fused serial sweep.
- **Randomness.**  Every hyperparameter draw is the same on every rank,
  because every rank holds a generator in the same state, so no broadcast
  is needed (as in JAX, :23-24).  A slice's own variates (its visit order,
  p and z) come from a second generator seeded from that stream and the
  slice's m index (JAX folds the m index into the sweep key, :547-550):
  ``SliceVariates``.
- **Output.**  beta and labels are gathered over "m" for emission; only
  rank 0 writes to a sink.

- **int8 codes** (``x_dtype="int8"``, sharded.py:164-200): each rank takes
  its marker slice of the full code matrix (no ``x_process_shard``, as in
  JAX) and builds its own statistics (``genotypes.int8_stats_local``);
  missing-free codes sweep through the strided kernels' int8 mode, codes
  with missing calls through the serial in-kernel decode (:391-394,
  :552-555), and ``xbeta`` all-reduces the slices' products (:933).

Not ported, and raising ``NotImplementedError`` with their ROADMAP entry:
the "n" axis (Dn > 1, the split sweep, :741-800), groups and fixed
effects, the sharded horseshoe and ``parallel/chains.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import BayesRConfig, ChainConfig
from ..distributions import TorchVariates
from ..models.bayesr import MarkerData, _as_2d_cva, hyper_draws
from ..models.sampler import MarkerSampler, not_ported
from ..models.state import SpikeSlabState
from ..ops import block_sweep as bs
from ..ops import genotypes
from ..ops.jacobi import auto_jacobi_plan
from ..ops.jacobi_t import bayesr_jacobi_t_mc_rounds, bayesr_jacobi_t_rounds
from ..ops.multichain import bayesr_sweep_mc
from ..ops.serial import bayesr_sweep
from .distributed import process_marker_range, put_global
from .mesh import Mesh

_MASK64 = (1 << 64) - 1


def _mix(seed: int, index: int) -> int:
    """A 63-bit seed from (seed, index): splitmix64 of their sum."""
    x = (seed + 0x9E3779B97F4A7C15 * (index + 1)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


class SliceVariates:
    """The draws of a sharded step.  The replicated ones (intercept,
    hyperparameters, init) come from ``generator``, which every rank holds
    in the same state; the slice's own (visit orders, p, z) from a
    generator seeded from ``generator`` and the slice index ``m_index``.
    ``chains=C`` gives every per-chain draw a leading chain axis, the
    visit order being shared (``distributions.TorchVariates``).  Seeding
    the slice stream reads one number from ``generator`` on the host."""

    def __init__(self, generator: torch.Generator, m_index: int,
                 chains: Optional[int] = None):
        dev = generator.device
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=dev).item())
        local = torch.Generator(device=dev).manual_seed(_mix(seed, m_index))
        self.rep = TorchVariates(generator, chains=chains)
        self.loc = TorchVariates(local, chains=chains)

    def begin_step(self):
        pass

    def mu_noise(self):
        return self.rep.mu_noise()

    def orders(self, nb: int, B: int, J: int):
        return self.loc.orders(nb, B, J)

    def block_orders(self, nb: int, B: int):
        return self.loc.block_orders(nb, B)

    def p(self, n: int):
        return self.loc.p(n)

    def z(self, n: int):
        return self.loc.z(n)

    def sigmaE_gamma(self, shape):
        return self.rep.sigmaE_gamma(shape)

    def sigmaG_gamma(self, shapes):
        return self.rep.sigmaG_gamma(shapes)

    def pi_gamma(self, alpha):
        return self.rep.pi_gamma(alpha)

    def init_sigmaGG(self, G: int):
        return self.rep.init_sigmaGG(G)


class ShardedSpikeSlabSampler(MarkerSampler):
    """BayesR sampler with its markers split over the "m" axis of ``mesh``
    (``parallel.make_mesh(m, 1)``): every rank constructs it with the same
    arguments, except that with ``x_process_shard=True`` each passes only
    its own marker slice of X (rows ``process_marker_range(mesh, Mpad)``
    clipped to M, marker major) and of ``x_stats``, with the global marker
    count in ``n_markers``.

    Parameters as ``bayesrrcpp_tpu.parallel.ShardedSpikeSlabSampler``: X
    (N, M) dosages or standardized values, (M, N) with
    ``transposed=True``, int32 packed words as a torch tensor
    (``x_dtype="2bit"``, ``transposed=True``, ``x_stats``), or int8 codes
    (``x_dtype="int8"``: dosages with NaN for a missing call, or codes
    with ``x_stats``, e.g. an int8 tensor on the device); ``backend``
    "xla" (the default, dense X only) or "pallas" (the kernels);
    ``chunk_blocks``: blocks each slice sweeps between all-reduces of eps
    (default 128; Dm = 1 sweeps everything in one chunk); ``has_missing``:
    whether packed words or int8 codes hold missing calls, read off them
    (and agreed over the mesh) when None, checked against them when given.
    The device is the mesh's.
    """

    def __init__(self, X, Y, cva, config, mesh: Mesh, *, g_assign=None,
                 fixed=None, dtype=None, variant: Optional[str] = None,
                 backend: str = "xla", chunk_blocks: Optional[int] = None,
                 x_dtype: str = "dense", x_stats=None,
                 transposed: bool = False,
                 n_individuals: Optional[int] = None,
                 has_missing: Optional[bool] = None,
                 x_process_shard: bool = False,
                 n_markers: Optional[int] = None,
                 split_sweep: Optional[bool] = None):
        if mesh.Dn != 1 or split_sweep:
            raise not_ported("the sharded sampler's individual axis (Dn > 1, "
                             "the split sweep)", "Queue 1 item 5")
        if x_dtype not in ("dense", "int8", "2bit"):
            raise ValueError(f"unknown x_dtype {x_dtype!r}")
        if backend not in ("xla", "pallas"):
            raise ValueError(f"unknown backend {backend!r}")
        if x_dtype != "dense" and backend != "pallas":
            raise ValueError(f"x_dtype={x_dtype!r} requires "
                             "backend='pallas'")
        if x_process_shard and x_dtype == "int8":
            raise ValueError("x_process_shard supports dense and pre-packed "
                             "2-bit input (int8: pass the full code matrix)")
        if not isinstance(config, BayesRConfig) or variant not in (None,
                                                                   "bayesr"):
            raise not_ported("the groups variant", "Queue 1 item 6")
        if g_assign is not None or fixed is not None:
            raise not_ported("groups and fixed effects", "Queue 1 item 6")
        if dtype not in (None, torch.float32, np.float32, "float32"):
            raise ValueError("the port's samplers run in float32")
        self.mesh = mesh
        self.Dm = mesh.Dm
        self.device = mesh.device
        self.backend = backend
        self.chunk_blocks = chunk_blocks
        self.config, self.variant = config, "bayesr"
        self.x_packed = x_dtype == "2bit"
        self.x_int8 = x_dtype == "int8"
        self.x_process_shard = bool(x_process_shard)
        self.dtype = torch.float32

        prepacked = (self.x_packed and isinstance(X, torch.Tensor)
                     and X.dtype == torch.int32)
        if not isinstance(X, torch.Tensor):
            X = np.asarray(X)
        M, N = self._sizes(X, prepacked, transposed, x_stats, n_individuals,
                           n_markers)
        cva2 = _as_2d_cva(cva)
        G, Km1 = cva2.shape
        if G != 1:
            raise not_ported("per-group slab variances", "Queue 1 item 6")
        if np.any(cva2 <= 0):
            raise ValueError("slab variances must be strictly positive")
        self.K, self.G, self.F = Km1 + 1, G, 0
        self._plan(M, N, config.block_size)
        lo, hi = process_marker_range(mesh, self.Mpad)
        self.marker_range = (lo, hi)
        m_real = max(0, min(hi, M) - lo)        # real markers of the slice

        dev, f32 = self.device, torch.float32
        if self.x_packed:
            geno = self._packed_slice(X, prepacked, transposed, x_stats,
                                      has_missing, lo, hi, m_real)
        elif self.x_int8:
            geno = self._int8_slice(X, transposed, x_stats, has_missing, lo,
                                    m_real)
            if geno["has_missing"]:
                # int8 codes with missing calls: the serial in-kernel decode
                # (JAX's use_t is False there, sharded.py:552-555)
                self.jacobi, self.jacobi_layout = 1, "row"
        else:
            geno = self._dense_slice(X, transposed, lo, hi, m_real)
        prior_pi = np.empty((G, self.K))
        prior_pi[:, 0] = 0.5
        prior_pi[:, 1:] = 0.5 * cva2 / cva2.sum(axis=1, keepdims=True)
        self.data = MarkerData(
            **geno,
            valid=torch.arange(lo, hi, device=dev) < M,
            g_assign=torch.zeros((self.Mloc,), dtype=torch.int32,
                                 device=dev),
            cva=torch.as_tensor(cva2, dtype=f32, device=dev),
            prior_pi=torch.as_tensor(prior_pi, dtype=f32, device=dev))
        Yt = torch.as_tensor(np.asarray(Y) if not isinstance(Y, torch.Tensor)
                             else Y, dtype=f32, device=dev)
        if tuple(Yt.shape) != (N,):
            raise ValueError("Y must have the same number of rows as X")
        self.Y = torch.nn.functional.pad(Yt, (0, self.Npad - N))

    # ------------------------------------------------------------ layout

    def _sizes(self, X, prepacked, transposed, x_stats, n_individuals,
               n_markers):
        """(M, N): the global marker count and the individuals."""
        if self.x_process_shard:
            # X holds this rank's marker slice only (distributed.py)
            if n_markers is None:
                raise ValueError("x_process_shard requires n_markers= (the "
                                 "GLOBAL marker count)")
            if not transposed:
                raise ValueError("x_process_shard input must be marker-major "
                                 "(transposed=True)")
            if self.x_packed and not prepacked:
                raise ValueError("x_process_shard packed input must be "
                                 "pre-packed int32 words (read_bed_packed)")
            M = int(n_markers)
        elif prepacked:
            M = X.shape[0] if n_markers is None else int(n_markers)
        else:
            M = X.shape[0] if transposed else X.shape[1]
        if prepacked:
            if not transposed or x_stats is None:
                raise ValueError("pre-packed 2-bit input requires "
                                 "transposed=True and x_stats=(means, sds)")
            N = (X.shape[1] * genotypes.WORDS if n_individuals is None
                 else int(n_individuals))
            if not X.shape[1] * genotypes.WORDS - 2048 < N <= \
                    X.shape[1] * genotypes.WORDS:
                raise ValueError(f"n_individuals={N} inconsistent with "
                                 f"{X.shape[1]} words/marker")
        else:
            N = X.shape[1] if transposed else X.shape[0]
        return M, N

    def _plan(self, M, N, block_size):
        """The slices' plan, as JAX's (sharded.py:345-383): the kernels take
        the "t" plan of a slice's ceil(M/Dm) markers where there is one;
        the marker axis pads to a multiple of B*J*Dm (8-aligned block
        counts per slice at scale)."""
        Dm = self.Dm
        B = max(8, min(block_size, 1 << max(1, (M - 1).bit_length())))
        J = 1
        if self.backend == "pallas":
            jt, bt, lay = auto_jacobi_plan(-(-M // Dm), B)
            if lay == "t":
                B, J = bt, jt
        unit = B * J * Dm
        Mpad = -(-M // unit) * unit
        if Mpad // (B * Dm) >= 64:
            unit8 = (B * 8 * J // math.gcd(8, J)) * Dm
            Mpad = -(-M // unit8) * unit8
        self.N, self.M, self.Mpad, self.B = N, M, Mpad, B
        self.Mloc = Mpad // Dm
        self.nb_loc = self.nb = self.Mloc // B
        self.jacobi = J
        self.jacobi_layout = "t" if J > 1 else "row"
        self.Npad = (genotypes.padded_individuals(N) if self.x_packed
                     else N)

    def _packed_slice(self, X, prepacked, transposed, x_stats, has_missing,
                      lo, hi, m_real):
        """This slice's words and statistics (sharded.py:82-163): the words
        (prepacked, or packed from host dosages), their means and scales,
        xsq, the Gram blocks and the column sums; ``has_missing`` agreed
        over the mesh, so that every rank sweeps in the same mode."""
        dev, f32 = self.device, torch.float32
        Mloc, Npad = self.Mloc, self.Npad
        if prepacked:
            rows = (X if self.x_process_shard
                    else X[lo:min(hi, X.shape[0])])
            means = np.asarray(x_stats[0], np.float64)
            sds = np.asarray(x_stats[1], np.float64)
            if not self.x_process_shard:
                means, sds = means[lo:lo + m_real], sds[lo:lo + m_real]
            if rows.shape[0] < m_real or len(means) != m_real:
                raise ValueError(
                    f"this rank's marker slice [{lo}, {lo + m_real}) needs "
                    f"{m_real} rows of words and stats, got "
                    f"{rows.shape[0]} and {len(means)}")
            if rows.shape[1] * genotypes.WORDS != Npad:
                raise ValueError(f"pre-packed words must pad lanes to 2048: "
                                 f"got {rows.shape[1]} words/marker")
            rows = torch.as_tensor(rows[:m_real], device=dev)
            if m_real == Mloc:          # the words themselves, no copy
                words = rows.contiguous()
            else:                       # pad markers: all missing (-1)
                words = torch.full((Mloc, rows.shape[1]), -1,
                                   dtype=torch.int32, device=dev)
                words[:m_real] = rows
            scl = np.where(sds > 0, 1.0 / np.where(sds > 0, sds, 1.0), 0.0)
            mean, scale = (torch.as_tensor(np.pad(a, (0, Mloc - m_real)),
                                           dtype=f32, device=dev)
                           for a in (means, scl))
        else:
            w, mean, scale, _, _ = genotypes.pack_codes_host(
                X, transposed, x_stats, self.Mpad, self.N)
            words, mean, scale = (put_global(self.mesh, a)
                                  for a in (w, mean, scale))
        row_valid = torch.arange(Npad, device=dev) < self.N
        xsq, gram, xsum, miss = genotypes.packed_stats(
            words, mean, scale, row_valid, self.B, m_real)
        miss = self._agreed_missing(miss, has_missing)
        return dict(XT=words, xsq=xsq, gram=gram, x_mean=mean, x_scale=scale,
                    row_valid=row_valid, x_colsum=xsum, has_missing=miss)

    def _agreed_missing(self, miss, has_missing):
        """Whether any slice holds a missing call, agreed over the mesh so
        that every rank sweeps in the same mode; checked against
        ``has_missing`` when given."""
        flag = torch.tensor([int(miss)], dtype=torch.int32,
                            device=self.device)
        miss = bool(self.mesh.all_reduce(flag).item())
        if has_missing is not None and bool(has_missing) != miss:
            raise ValueError(f"has_missing={has_missing}, but the data "
                             f"{'holds' if miss else 'holds no'} missing "
                             "calls")
        return miss

    def _int8_slice(self, X, transposed, x_stats, has_missing, lo, m_real):
        """This slice's int8 codes (Mloc, N), pad markers code 3, with their
        means and scales (``x_stats``, or this slice's own dosages') and
        statistics (sharded.py:_int8_shard_setup): the slice's rows of a
        device tensor are used as they are when they fill it."""
        rows = (X[lo:lo + m_real] if transposed
                else X[:, lo:lo + m_real].T)
        stats = None
        if x_stats is not None:
            stats = tuple(np.asarray(a, np.float64)[lo:lo + m_real]
                          for a in x_stats[:2])
        q = genotypes.quantize_int8(rows, True, stats, self.B, self.Mloc,
                                    device=self.device)
        return dict(XT=q.codes, xsq=q.xsq, gram=q.gram, x_mean=q.x_mean,
                    x_scale=q.x_scale, x_colsum=q.x_colsum,
                    row_valid=torch.zeros((0,), dtype=torch.bool,
                                          device=self.device),
                    has_missing=self._agreed_missing(q.has_missing,
                                                     has_missing))

    def _dense_slice(self, X, transposed, lo, hi, m_real):
        """This slice's standardized f32 rows (Mloc, N), zero on padding
        markers, with xsq and the Gram blocks."""
        dev, f32 = self.device, torch.float32
        if self.x_process_shard:
            rows = X[:m_real]
        else:
            rows = (X[lo:lo + m_real] if transposed
                    else X[:, lo:lo + m_real].T)
        if not isinstance(rows, torch.Tensor):
            rows = np.ascontiguousarray(rows, dtype=np.float32)
        XT = torch.zeros((self.Mloc, self.N), dtype=f32, device=dev)
        XT[:m_real] = torch.as_tensor(rows, dtype=f32, device=dev)
        empty = torch.zeros((0,), dtype=f32, device=dev)
        return dict(XT=XT, xsq=torch.sum(XT * XT, dim=1),
                    gram=bs.gram_blocks(XT, self.B), x_mean=empty,
                    x_scale=empty, x_colsum=empty,
                    row_valid=torch.zeros((0,), dtype=torch.bool, device=dev))

    # ------------------------------------------------------------ helpers

    def variates(self, rng, chains: Optional[int] = None):
        """``rng`` as a variates object: a ``torch.Generator`` on the mesh's
        device type, in the same state on every rank, becomes a
        ``SliceVariates``; an object with the role methods passes
        through."""
        if isinstance(rng, torch.Generator):
            if rng.device.type != self.device.type:
                raise ValueError(f"generator on {rng.device}, sampler on "
                                 f"{self.device}")
            return SliceVariates(rng, self.mesh.m_index, chains)
        return rng

    def xbeta(self, beta) -> torch.Tensor:
        """X @ beta over every slice, (..., N), for this slice's (..., Mloc)
        beta: the slice's product all-reduced over "m"."""
        return self.mesh.all_reduce(super().xbeta(beta).contiguous())

    def _nrc(self, nr: int) -> int:
        """Rounds per chunk of a slice's strided sweep (sharded.py:696-702):
        all of them at Dm = 1, else about ``chunk_blocks`` blocks, a
        divisor of nr."""
        if self.Dm == 1:
            return nr
        nrc = max(1, min(nr, -(-min(self.chunk_blocks or 128, self.nb_loc)
                               // self.jacobi)))
        while nr % nrc:
            nrc -= 1
        return nrc

    def _serial_chunk(self) -> int:
        return min(self.chunk_blocks or 128, self.nb_loc)

    def _reduce_eps(self, eps, eps_new, mask):
        """eps + (the chunk's updates of every slice), the all-reduce of
        the slice's delta (sharded.py:716-719); ``mask``: zero the pad lanes
        after it (packed words, strided sweeps)."""
        eps = eps + self.mesh.all_reduce(eps_new - eps)
        if mask and self.x_packed:
            eps = eps * self.data.row_valid.to(eps.dtype)
        return eps

    # ------------------------------------------------------------ init

    def init(self, rng, chains: Optional[int] = None) -> SpikeSlabState:
        """Fresh-chain init (sharded.py:438-499): beta and labels of this
        slice zero, eps = Y; with ``chains=C`` a leading chain axis."""
        v = self.variates(rng, chains)
        dev, f32 = self.device, torch.float32
        lead = () if chains is None else (chains,)
        eps = self.Y.expand(lead + self.Y.shape).clone()
        return SpikeSlabState(
            iteration=0,
            mu=torch.zeros(lead, dtype=f32, device=dev),
            beta=torch.zeros(lead + (self.Mloc,), dtype=f32, device=dev),
            labels=torch.zeros(lead + (self.Mloc,), dtype=torch.int32,
                               device=dev),
            eps=eps,
            sigmaE=torch.sum(eps * eps, dim=-1) / self.N * 0.5,
            sigmaGG=v.init_sigmaGG(self.G).to(f32),
            pi=self.data.prior_pi.expand(lead + self.data.prior_pi.shape
                                         ).clone(),
            alpha=torch.zeros(lead + (0,), dtype=f32, device=dev),
            sigmaF=torch.ones(lead, dtype=f32, device=dev))

    # ------------------------------------------------------------ step

    def step(self, state: SpikeSlabState, rng) -> SpikeSlabState:
        """One Gibbs iteration of this slice (sharded.py:_step_local); every
        rank calls it with its own state, in step."""
        v = self.variates(rng)
        v.begin_step()
        mu, eps = self._intercept(state, v)
        Mloc, B, nb = self.Mloc, self.B, self.nb_loc
        if self.backend == "pallas" and self.strided:
            rho, inner = v.orders(nb, B, self.jacobi)
            p, z = v.p(Mloc), v.z(Mloc)
            res = self._sweep_t(bayesr_jacobi_t_rounds, state, eps, rho,
                                inner, p, z)
        else:
            border, inner = v.block_orders(nb, B)
            p, z = v.p(Mloc), v.z(Mloc)
            sweep = (self._sweep_serial if self.backend == "pallas"
                     else self._sweep_xla)
            res = sweep(state, eps, border, inner, p, z)
        return self._next(state, v, mu, *res)

    def step_chains(self, state: SpikeSlabState, rng) -> SpikeSlabState:
        """One fused iteration of every chain of a chain-batched state
        (sharded.py:_mc_step_local): per-chain intercept, p/z and
        hyperparameters, one visit order for all chains."""
        if not self.supports_fused_chains:
            raise ValueError("fused multi-chain steps need backend='pallas', "
                             "with no missing call at J=1")
        v = self.variates(rng, state.beta.shape[0])
        v.begin_step()
        mu, eps = self._intercept(state, v)
        Mloc, B, nb = self.Mloc, self.B, self.nb_loc
        if self.strided:
            rho, inner = v.orders(nb, B, self.jacobi)
            p, z = v.p(Mloc), v.z(Mloc)
            res = self._sweep_t(bayesr_jacobi_t_mc_rounds, state, eps, rho,
                                inner, p, z)
        else:
            border, inner = v.block_orders(nb, B)
            p, z = v.p(Mloc), v.z(Mloc)
            res = self._sweep_serial_mc(state, eps, border, inner, p, z)
        return self._next(state, v, mu, *res)

    def _sweep_t(self, rounds, state, eps, rho, inner, p, z):
        """The slice's strided sweep in chunks of rounds through
        ``rounds`` (``bayesr_jacobi_t_rounds`` or its fused form), one
        all-reduce of eps after each (sharded.py:656-739, :964-1043)."""
        d = self.data
        nr = self.nb_loc // self.jacobi
        nrc = self._nrc(nr)
        beta, labels = state.beta, state.labels
        v = bacc = 0.0
        for c0 in range(0, nr, nrc):
            res = rounds(d.XT, d.gram, d.xsq, eps, beta, labels,
                         rho[c0:c0 + nrc], inner, p, z, state.pi, d.cva,
                         state.sigmaE, state.sigmaGG, d.g_assign, d.valid,
                         J=self.jacobi, nr_total=nr, **self._sweep_kw())
            eps = self._reduce_eps(eps, res.eps, mask=True)
            beta, labels = res.beta, res.labels
            v, bacc = v + res.v, bacc + res.beta_acum
        return eps, beta, labels, v, bacc

    def _sweep_serial(self, state, eps, border, inner, p, z):
        """A slice whose plan is not "t" (sharded.py:615-654): the serial
        kernel on each chunk of ``chunk_blocks`` blocks of the flat order
        ``border``, its within-block orders ``inner`` by sweep position
        (the kernel takes them by block) and p/z cut from the slice's
        stream by position, one all-reduce of eps after each chunk."""
        d = self.data
        beta, labels = state.beta, state.labels
        v = bacc = 0.0
        B, nb, C = self.B, self.nb_loc, self._serial_chunk()
        for c0 in range(0, nb, C):
            cb = min(C, nb - c0)
            blocks = border[c0:c0 + cb]
            by_block = inner.new_zeros((nb, B))
            by_block[blocks.long()] = inner[c0:c0 + cb]
            res = bayesr_sweep(d.XT, d.gram, d.xsq, eps, beta, labels,
                               blocks, by_block, p[c0 * B:(c0 + cb) * B],
                               z[c0 * B:(c0 + cb) * B], state.pi, d.cva,
                               state.sigmaE, state.sigmaGG, d.g_assign,
                               d.valid, **self._sweep_kw())
            eps = self._reduce_eps(eps, res.eps, mask=False)
            beta, labels = res.beta, res.labels
            v, bacc = v + res.v, bacc + res.beta_acum
        return eps, beta, labels, v, bacc

    def _sweep_serial_mc(self, state, eps, border, inner, p, z):
        """The fused serial sweep of a slice whose plan is not "t"
        (sharded.py:884-906): chunks of blocks, p/z (C, Mloc) by marker.
        JAX indexes the chunk's positional within-block orders by block id
        (``inner_perm[block_order]``, pallas_multichain.py:408, clamped to
        the chunk's last row), so block b sweeps in the order of position
        min(b, chunk - 1) of the chunk; so does this."""
        d = self.data
        nb, C = self.nb_loc, self._serial_chunk()
        beta, labels = state.beta, state.labels
        v = bacc = 0.0
        for c0 in range(0, nb, C):
            cb = min(C, nb - c0)
            at = torch.clamp(torch.arange(nb, device=inner.device), max=cb - 1)
            res = bayesr_sweep_mc(d.XT, d.gram, d.xsq, eps, beta, labels,
                                  border[c0:c0 + cb], inner[c0:c0 + cb][at],
                                  p, z, state.pi, d.cva, state.sigmaE,
                                  state.sigmaGG, d.g_assign, d.valid,
                                  **self._sweep_kw())
            eps = self._reduce_eps(eps, res.eps, mask=False)
            beta, labels = res.beta, res.labels
            v, bacc = v + res.v, bacc + res.beta_acum
        return eps, beta, labels, v, bacc

    def _sweep_xla(self, state, eps, border, inner, p, z):
        """``backend="xla"`` (sharded.py:570-605): one block a round in
        plain torch, r = X_b.eps, the block's exact solve, and eps minus
        the all-reduced update of every slice's block."""
        d = self.data
        B, G, K = self.B, self.G, self.K
        beta, labels = state.beta.clone(), state.labels.clone()
        v = torch.zeros((G, K), dtype=eps.dtype, device=eps.device)
        bacc = torch.zeros((G,), dtype=eps.dtype, device=eps.device)
        p, z = p.view(-1, B), z.view(-1, B)
        lanes = torch.arange(B, device=eps.device)
        for i, b in enumerate(border.tolist()):
            rows = b * B + lanes
            Xb = d.XT[rows]
            _, beta_b, labels_b, delta, v, bacc = bs.spike_slab_inner_solve(
                Xb @ eps, d.gram[b], beta[rows], labels[rows], d.xsq[rows],
                d.g_assign[rows], d.valid[rows], inner[i].long(), p[i], z[i],
                state.pi, d.cva, state.sigmaE, state.sigmaGG, v, bacc)
            eps = eps - self.mesh.all_reduce(delta @ Xb)
            beta[rows] = beta_b
            labels[rows] = labels_b
        return eps, beta, labels, v, bacc

    def _next(self, state, v, mu, eps, beta, labels, counts, bacc):
        """The hyperparameter draws after the sweep (sharded.py:802-838):
        the counts and sum(beta^2) all-reduced over "m", the draws the same
        on every rank."""
        counts = self.mesh.all_reduce(counts.contiguous())
        ss_beta = self.mesh.all_reduce(torch.sum(beta * beta, dim=-1))
        sigmaE, sigmaGG, pi = hyper_draws(
            self.config, self.N, v, torch.sum(eps * eps, dim=-1), ss_beta,
            counts)
        return SpikeSlabState(
            iteration=state.iteration + 1, mu=mu, beta=beta, labels=labels,
            eps=eps, sigmaE=sigmaE, sigmaGG=sigmaGG, pi=pi,
            alpha=state.alpha, sigmaF=state.sigmaF)

    # ------------------------------------------------------------ run

    def _emit_one(self, state: SpikeSlabState):
        """One emission row, beta and labels gathered over "m"."""
        M = self.M
        return {
            "mu": state.mu,
            "beta": self.mesh.all_gather(state.beta)[..., :M],
            "sigmaE": state.sigmaE,
            "sigmaG": state.sigmaGG,
            "comp": self.mesh.all_gather(state.labels)[..., :M].to(
                torch.int8),
            "epsilon": self._emit_epsilon(state),
            "alpha": state.alpha,
            "sigmaF": state.sigmaF,
        }

    def run(self, rng, chain: ChainConfig, *, state=None, sink=None,
            collect: bool = True, emit_chunk: int = 32, progress=None):
        """``MarkerSampler.run`` on every rank together; only rank 0 writes
        to ``sink`` (the others' is ignored)."""
        return super().run(rng, chain, state=state,
                           sink=sink if self.mesh.m_index == 0 else None,
                           collect=collect, emit_chunk=emit_chunk,
                           progress=progress)

    def run_chains(self, rng, n_chains: int, chain: ChainConfig, *,
                   fused: Optional[bool] = None, sink=None,
                   collect: bool = True, emit_chunk: int = 32,
                   progress=None):
        """``n_chains`` fused chains (sharded.py:1126-1189), the kernels'
        backend only; only rank 0 writes to ``sink`` (a
        ``ChainFanoutSink``)."""
        if fused is False or not self.supports_fused_chains:
            raise ValueError("the sharded run_chains runs fused chains: "
                             "backend='pallas', no missing call at J=1")
        return super().run_chains(
            rng, n_chains, chain, fused=True,
            sink=sink if self.mesh.m_index == 0 else None, collect=collect,
            emit_chunk=emit_chunk, progress=progress)


class ShardedHorseshoeSampler:
    """The sharded horseshoe (bayesrrcpp_tpu/parallel/sharded.py:1255) is
    not ported: constructing one raises ``NotImplementedError``."""

    def __init__(self, *args, **kwargs):
        raise not_ported("the sharded horseshoe sampler", "Queue 1 item 5")
