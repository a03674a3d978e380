"""The sharded BayesR and horseshoe samplers on an (m, n) mesh of processes.

Counterpart of ``bayesrrcpp_tpu/parallel/sharded.py``
(``ShardedSpikeSlabSampler``, ``ShardedHorseshoeSampler``).  One process
drives one card and holds one (m, n) slice: Mloc = Mpad / Dm contiguous
markers (their words, codes or dense rows, Gram blocks and statistics,
and their beta and labels, or lambda and v) and, on the "n" axis, Nloc =
Npad / Dn contiguous individuals of dense X, eps and Y (individuals in
natural order; JAX's P("n") slices, sharded.py:343-349).  The scalars are
replicated: every rank holds them whole.

- **The sweep.**  Each m-slice sweeps its own blocks.
  - BayesR with the kernels ("pallas") on Dn = 1 runs the strided-rounds
    sweep of its own plan (``auto_jacobi_plan(ceil(M/Dm), B)``, "t"
    layouts only) in chunks of rounds, ``bayesr_jacobi_t_rounds``
    (csrc/jacobi_t.cu), with one all-reduce of the chunk's eps update over
    "m" after each chunk (sharded.py:656-739): across slices the chunk is
    block-Jacobi, each slice seeing eps as of the chunk's start.  A slice
    whose plan is not "t" runs the serial kernel (``ops/serial
    .bayesr_sweep``) on chunks of ``chunk_blocks`` blocks (:615-654).
  - The horseshoe with the kernels on Dn = 1 runs the serial kernel
    (``ops/serial.horseshoe_sweep``, site #10) on chunks of
    ``chunk_blocks`` (default 128) blocks, one all-reduce of eps over "m"
    after each (:1499-1519): the fold mode on missing-free codes, the
    in-kernel decode ``_q`` where there are missing calls (:1383).
  - **The split sweep** (the kernels on Dn > 1, or ``split_sweep=True``;
    :741-800, :1565-1605): rounds of J blocks (the largest divisor of the
    slice's block count up to ``chunk_blocks or 8``); per round r =
    all_reduce_n(X_c eps) by ``torch.mv`` on the round's rows in place,
    the round's batched solve alone (``ops/jacobi.bayesr_round_solve`` /
    ``horseshoe_round_solve``, csrc/serial.cu ``serial_round_solve``,
    sites #13 / #14), then eps -= all_reduce_m(d X_c): exact within a
    block, block-Jacobi across the Dm*J blocks of a round.
  - ``backend="xla"``, JAX's default, sweeps one block a round in plain
    torch on the sampler's device: r = all_reduce_n(X_b eps), the
    block's exact solve, eps minus the all-reduced update of every
    slice's block (:570-605, :1521-1541).
  At Dm = 1 the whole sweep of the (m, 1) kernels is one chunk.
- **Fused chains** (BayesR's ``step_chains``, ``run_chains``; (m, 1)
  meshes only, as in JAX, :1074-1080) run the same chunks through
  ``bayesr_jacobi_t_mc_rounds`` (csrc/jacobi_t_mc.cu), all chains sharing
  the visit order (:840-1043), or the fused serial sweep.  The sharded
  horseshoe has none, as JAX's has none.
- **Randomness.**  Every replicated draw is the same on every rank,
  because every rank holds a generator in the same state, so no broadcast
  is needed (as in JAX, :21-24).  A slice's own variates (its visit
  order, p and z; the horseshoe's v and lambda gammas) come from a second
  generator seeded from that stream and the slice's m index (JAX folds
  the m index into the keys, :547-550, :1482-1489, :1544):
  ``SliceVariates``.  The ranks of one m-slice draw alike.
- **Output.**  eps is gathered over "n", beta and labels (lambda) over
  "m" for emission; only rank (0, 0) writes to a sink.
- **Storage.**  2-bit words and int8 codes (``x_dtype="int8"``,
  sharded.py:164-200) on (m, 1) meshes: each rank takes its marker slice
  (int8: of the full code matrix, no ``x_process_shard``, as in JAX) and
  builds its own statistics; missing-free codes sweep through the
  strided kernels' int8 mode, codes with missing calls through the serial
  in-kernel decode (:391-394, :552-555), and ``xbeta`` all-reduces the
  slices' products (:933).  Dn > 1 takes dense X only, as JAX
  (:242-245); so does the split sweep.

- **Groups and fixed effects** (``variant="groups"``, ``g_assign``,
  ``fixed``; sharded.py:309-416, :502-535, :802-838): each slice holds its
  markers' groups, every rank the fixed-effect columns of its individuals
  (F, Nloc); the fixed-effect sweep's dots are summed over "n", and the
  per-group sum of slab beta^2 (``bacc``) over "m" beside the counts
  before sigmaG is drawn per group.

- **dtype** (float32, the default, or float64, as JAX's ``dtype=``,
  sharded.py:211): ``backend="xla"`` and the plain algebra run in it; the
  kernels under a float64 state take float32 casts of their operands and
  cast their outputs back where JAX's do (the strided chunks, the round
  solves of the split sweep), and raise ``ValueError`` where JAX's serial
  chunks raise (``models/sampler._F64_RAISES``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import distributions as dist
from ..config import ChainConfig, HorseshoeConfig
from ..distributions import TorchVariates
from ..models.bayesr import MarkerData, SpikeSlabSteps
from ..models.horseshoe import HorseshoeData, HorseshoeSampler
from ..models.sampler import MarkerSampler, numpy_dtype, resolve_dtype
from ..models.state import HorseshoeState, SpikeSlabState
from ..ops import block_sweep as bs
from ..ops import genotypes
from ..ops.jacobi import (auto_jacobi_plan, bayesr_round_solve,
                          build_pkg_hs_jacobi, build_pkg_jacobi,
                          horseshoe_round_solve)
from ..ops.jacobi_t import bayesr_jacobi_t_mc_rounds, bayesr_jacobi_t_rounds
from ..ops.multichain import bayesr_sweep_mc
from ..ops.serial import bayesr_sweep, horseshoe_sweep
from .distributed import process_marker_range, put_global
from .mesh import AXIS_M, AXIS_N, Mesh

_MASK64 = (1 << 64) - 1


def _mix(seed: int, index: int) -> int:
    """A 63-bit seed from (seed, index): splitmix64 of their sum."""
    x = (seed + 0x9E3779B97F4A7C15 * (index + 1)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def derived_generator(generator: torch.Generator,
                      index: int) -> torch.Generator:
    """A generator on ``generator``'s device seeded from one number read
    from ``generator`` (on the host) and ``index``: every rank that reads
    a generator in the same state derives the same stream for an index."""
    dev = generator.device
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=dev).item())
    return torch.Generator(device=dev).manual_seed(_mix(seed, index))


class SliceVariates:
    """The draws of a sharded step.  The replicated ones (intercept,
    hyperparameters, init) come from ``generator``, which every rank holds
    in the same state; the slice's own (visit orders, p, z, the
    horseshoe's local gammas) from ``derived_generator(generator,
    m_index)``.  ``chains=C`` gives every per-chain draw a leading chain
    axis, the visit order being shared (``distributions.TorchVariates``);
    float draws in ``dtype``."""

    def __init__(self, generator: torch.Generator, m_index: int,
                 chains: Optional[int] = None, dtype=torch.float32):
        local = derived_generator(generator, m_index)
        self.rep = TorchVariates(generator, dtype, chains=chains)
        self.loc = TorchVariates(local, dtype, chains=chains)

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

    def local_gamma(self, alpha: float, n: int):
        return self.loc.local_gamma(alpha, n)

    def fixed_order(self, F: int):
        return self.rep.fixed_order(F)

    def fixed_z(self, F: int):
        return self.rep.fixed_z(F)

    def sigmaE_gamma(self, shape):
        return self.rep.sigmaE_gamma(shape)

    # the horseshoe's replicated scalar gammas and sigmaF's
    eta_gamma = tau_gamma = c2_gamma = sigmaF_gamma = sigmaE_gamma

    def sigmaG_gamma(self, shapes):
        return self.rep.sigmaG_gamma(shapes)

    def pi_gamma(self, alpha):
        return self.rep.pi_gamma(alpha)

    def init_sigmaGG(self, G: int):
        return self.rep.init_sigmaGG(G)

    def init_sigmaF(self):
        return self.rep.init_sigmaF()

    def init_gammas(self, eta_shape: float, tau_shape: float):
        return self.rep.init_gammas(eta_shape, tau_shape)


class _ShardedMarkers(MarkerSampler):
    """What both sharded samplers share: the mesh, the slice's layout and
    storage, the collectives of the step, the chunks of the (m, 1) kernel
    sweeps, the split sweep's rounds, and emission."""

    def _setup(self, mesh: Mesh, backend, x_dtype, x_process_shard,
               chunk_blocks, split_sweep, dtype):
        if x_dtype not in ("dense", "int8", "2bit"):
            raise ValueError(f"unknown x_dtype {x_dtype!r}")
        if backend not in ("xla", "pallas"):
            raise ValueError(f"unknown backend {backend!r}")
        if x_dtype != "dense" and backend != "pallas":
            raise ValueError(f"x_dtype={x_dtype!r} requires "
                             "backend='pallas'")
        if x_dtype != "dense" and (mesh.Dn != 1 or split_sweep):
            # sharded.py:242-245: code rows do not split over individuals
            raise ValueError("Dn > 1 and the split sweep take dense X "
                             "only (quantized codes: use an (m, 1) mesh)")
        if x_process_shard and x_dtype == "int8":
            raise ValueError("x_process_shard supports dense and pre-packed "
                             "2-bit input (int8: pass the full code matrix)")
        self.dtype = resolve_dtype(dtype)
        self.mesh = mesh
        self.Dm, self.Dn = mesh.Dm, mesh.Dn
        self.device = mesh.device
        self.backend = backend
        self.chunk_blocks = chunk_blocks
        # sharded.py:239-241: the kernels on Dn > 1 run the split sweep
        self._split = backend == "pallas" and (
            mesh.Dn > 1 if split_sweep is None else bool(split_sweep))
        self.x_packed = x_dtype == "2bit"
        self.x_int8 = x_dtype == "int8"
        self.x_process_shard = bool(x_process_shard)

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

    def _plan(self, M, N, block_size, strided: bool):
        """The slices' plan, as JAX's (sharded.py:317-349, :1329-1341):
        with ``strided`` the kernels take the "t" plan of a slice's
        ceil(M/Dm) markers where there is one; the marker axis pads to a
        multiple of B*J*Dm (8-aligned block counts per slice at scale), the
        individuals to the word tile (2-bit) or to a multiple of Dn."""
        Dm = self.Dm
        B = max(8, min(block_size, 1 << max(1, (M - 1).bit_length())))
        J = 1
        if strided:
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
                     else -(-N // self.Dn) * self.Dn)
        self.Nloc = self.Npad // self.Dn
        n0 = self.mesh.n_index * self.Nloc
        self.n_range = (n0, n0 + self.Nloc)

    def _lay_out_slice(self, X, Y, transposed, x_stats, n_individuals,
                       n_markers, has_missing, block_size, strided):
        """Plan, then this rank's slice of X (a dict of ``Genotypes``
        fields) and of Y; sets ``marker_range`` and ``Y``."""
        prepacked = (self.x_packed and isinstance(X, torch.Tensor)
                     and X.dtype == torch.int32)
        if not isinstance(X, torch.Tensor):
            X = np.asarray(X)
        M, N = self._sizes(X, prepacked, transposed, x_stats, n_individuals,
                           n_markers)
        self._plan(M, N, block_size, strided)
        lo, hi = process_marker_range(self.mesh, self.Mpad)
        self.marker_range = (lo, hi)
        m_real = max(0, min(hi, M) - lo)        # real markers of the slice
        if self.x_packed:
            geno = self._packed_slice(X, prepacked, transposed, x_stats,
                                      has_missing, lo, hi, m_real)
        elif self.x_int8:
            geno = self._int8_slice(X, transposed, x_stats, has_missing, lo,
                                    m_real)
        else:
            geno = self._dense_slice(X, transposed, lo, m_real)
        Yt = torch.as_tensor(np.asarray(Y) if not isinstance(Y, torch.Tensor)
                             else Y, dtype=self.dtype, device=self.device)
        if tuple(Yt.shape) != (N,):
            raise ValueError("Y must have the same number of rows as X")
        n0, n1 = self.n_range
        self.Y = put_global(self.mesh,
                            torch.nn.functional.pad(Yt, (0, self.Npad - N)),
                            spec=(AXIS_N,))
        # the lanes of eps that hold an individual: the words' row_valid,
        # or this n-slice's individuals n < N where the slices pad N
        self._mask = (geno["row_valid"] if self.x_packed
                      else None if self.Npad == N
                      else torch.arange(n0, n1, device=self.device) < N)
        return geno

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

    def _dense_slice(self, X, transposed, lo, m_real):
        """This slice's standardized rows (Mloc, Nloc) in the state's dtype,
        zero on padding markers and individuals, with xsq and the Gram
        blocks summed over the n-slices (sharded.py:438-455)."""
        dev, f32, dt = self.device, torch.float32, self.dtype
        if self.x_process_shard:
            rows = X[:m_real]
        else:
            rows = (X[lo:lo + m_real] if transposed
                    else X[:, lo:lo + m_real].T)
        n0 = self.n_range[0]
        n_real = max(0, min(self.n_range[1], self.N) - n0)
        rows = rows[:, n0:n0 + n_real]
        if not isinstance(rows, torch.Tensor):
            rows = np.ascontiguousarray(rows, dtype=numpy_dtype(dt))
        XT = torch.zeros((self.Mloc, self.Nloc), dtype=dt, device=dev)
        XT[:m_real, :n_real] = torch.as_tensor(rows, dtype=dt, device=dev)
        empty = torch.zeros((0,), dtype=f32, device=dev)
        return dict(XT=XT, xsq=self._psum(torch.sum(XT * XT, dim=1), AXIS_N),
                    gram=self._psum(bs.gram_blocks(XT, self.B), AXIS_N),
                    x_mean=empty, x_scale=empty, x_colsum=empty,
                    row_valid=torch.zeros((0,), dtype=torch.bool, device=dev))

    def _valid(self):
        lo, hi = self.marker_range
        return torch.arange(lo, hi, device=self.device) < self.M

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
            return SliceVariates(rng, self.mesh.m_index, chains, self.dtype)
        return rng

    def _psum(self, t, axis: str):
        return self.mesh.all_reduce(t.contiguous(), axis)

    def _lane_mask(self):
        return self._mask

    def xbeta(self, beta) -> torch.Tensor:
        """X @ beta over every m-slice, (..., N) (dense X: this n-slice's
        Nloc), for this slice's (..., Mloc) beta: the slice's product
        all-reduced over "m"."""
        return self._psum(super().xbeta(beta), AXIS_M)

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

    def split_blocks(self) -> int:
        """J of the split sweep: the largest divisor of the slice's block
        count up to ``chunk_blocks or 8`` (sharded.py:756-759)."""
        J = min(self.chunk_blocks or 8, self.nb_loc)
        while self.nb_loc % J:
            J -= 1
        return J

    def _reduce_eps(self, eps, eps_new, mask):
        """eps + (the chunk's updates of every slice), the all-reduce of
        the slice's delta (sharded.py:716-719); ``mask``: zero the pad lanes
        after it (packed words, strided sweeps)."""
        eps = eps + self.mesh.all_reduce(eps_new - eps)
        if mask and self.x_packed:
            eps = eps * self.data.row_valid.to(eps.dtype)
        return eps

    def _serial_chunks(self, sweep, eps, border, inner, *streams):
        """The slice's serial sweep on chunks of ``chunk_blocks`` blocks of
        the flat order ``border``, its within-block orders ``inner`` by
        sweep position (the kernel takes them by block) and the per-position
        ``streams`` (p, z) cut from the slice's by position, one
        all-reduce of eps after each chunk (sharded.py:615-654,
        :1499-1519).  ``sweep(eps, blocks, by_block, *chunk_streams)``
        returns (eps, ...) of a chunk; yields each chunk's result with
        eps replaced by the reduced one.  ``border`` may be a prefix of the
        sweep."""
        B, C = self.B, self._serial_chunk()
        n = border.shape[0]
        for c0 in range(0, n, C):
            cb = min(C, n - c0)
            blocks = border[c0:c0 + cb]
            by_block = inner.new_zeros((self.nb_loc, B))
            by_block[blocks.long()] = inner[c0:c0 + cb]
            res = sweep(eps, blocks, by_block,
                        *(x[c0 * B:(c0 + cb) * B] for x in streams))
            eps = self._reduce_eps(eps, res[0], mask=False)
            yield (eps,) + tuple(res[1:])

    def _split_rounds(self, eps, border, solve):
        """The split sweep's rounds (sharded.py:775-800): for the J blocks
        of each round, r = all_reduce_n(X_c eps) (one ``torch.mv`` a block
        on its rows in place), ``solve(round, r, blocks, idx)`` -> the
        round's deltas (J, B), and eps -= all_reduce_m(d X_c).  ``border``
        may be a prefix of whole rounds."""
        B = self.B
        J = self.split_blocks()
        XTb = self.data.XT.view(self.nb_loc, B, -1)
        bsel = border.long().view(-1, J)
        lanes = torch.arange(B, device=eps.device)
        for i, blk in enumerate(bsel.tolist()):
            r = eps.new_empty((J, B))
            for j, b in enumerate(blk):
                torch.mv(XTb[b], eps, out=r[j])
            idx = (bsel[i][:, None] * B + lanes).reshape(-1)
            d = solve(i, self._psum(r, AXIS_N), bsel[i], idx)
            upd = torch.zeros_like(eps)
            for j, b in enumerate(blk):
                upd.addmv_(XTb[b].t(), d[j])
            eps = eps - self._psum(upd, AXIS_M)
        return eps

    def _xla_blocks(self, eps, border, solve):
        """The plain sweep of ``backend="xla"``: for each block b of
        ``border``, r = all_reduce_n(X_b eps) on the sampler's device,
        ``solve(i, b, r)`` -> the block's deltas (B,), and eps -=
        all_reduce_m(delta X_b), all on the sampler's device."""
        B = self.B
        for i, b in enumerate(border.tolist()):
            Xb = self.data.XT[b * B:(b + 1) * B]
            delta = solve(i, b, self._psum(Xb @ eps, AXIS_N))
            eps = eps - self._psum(delta @ Xb, AXIS_M)
        return eps

    def _emit_epsilon(self, state) -> torch.Tensor:
        eps = state.eps
        if not self.config.emit_epsilon:
            return eps.new_zeros(eps.shape[:-1] + (0,))
        return self.mesh.all_gather(eps, AXIS_N)[..., :self.N]

    def _gathered(self, t) -> torch.Tensor:
        """A marker-axis tensor of this slice gathered over "m", cut to M."""
        return self.mesh.all_gather(t, AXIS_M)[..., :self.M]

    @property
    def _writer(self) -> bool:
        return self.mesh.m_index == 0 and self.mesh.n_index == 0

    def run(self, rng, chain: ChainConfig, *, state=None, sink=None,
            collect: bool = True, emit_chunk: int = 32, progress=None,
            on_chunk=None):
        """``MarkerSampler.run`` on every rank together; only rank (0, 0)
        writes to ``sink`` (the others' is ignored)."""
        return super().run(rng, chain, state=state,
                           sink=sink if self._writer else None,
                           collect=collect, emit_chunk=emit_chunk,
                           progress=progress, on_chunk=on_chunk)


class ShardedSpikeSlabSampler(SpikeSlabSteps, _ShardedMarkers):
    """BayesR sampler with its markers split over the "m" axis and, for
    dense X, its individuals over the "n" axis of ``mesh``
    (``parallel.make_mesh(m, n)``): every rank constructs it with the same
    arguments, except that with ``x_process_shard=True`` each passes only
    its own marker slice of X (rows ``process_marker_range(mesh, Mpad)``
    clipped to M, marker major, every individual) and of ``x_stats``, with
    the global marker count in ``n_markers``.

    Parameters as ``bayesrrcpp_tpu.parallel.ShardedSpikeSlabSampler``: X
    (N, M) dosages or standardized values, (M, N) with
    ``transposed=True``, int32 packed words as a torch tensor
    (``x_dtype="2bit"``, ``transposed=True``, ``x_stats``), or int8 codes
    (``x_dtype="int8"``: dosages with NaN for a missing call, or codes
    with ``x_stats``, e.g. an int8 tensor on the device); ``backend``
    "xla" (the default, dense X only) or "pallas" (the kernels);
    ``chunk_blocks``: blocks each slice sweeps between all-reduces of eps
    (default 128; Dm = 1 sweeps everything in one chunk), or the split
    sweep's J bound (default 8); ``split_sweep``: None runs the split sweep
    on Dn > 1 with the kernels, True also on Dn = 1 (dense X);
    ``has_missing``: whether packed words or int8 codes hold missing
    calls, read off them (and agreed over the mesh) when None, checked
    against them when given.  The device is the mesh's.
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
        self._setup(mesh, backend, x_dtype, x_process_shard, chunk_blocks,
                    split_sweep, dtype)
        geno = self._lay_out_slice(
            X, Y, transposed, x_stats, n_individuals, n_markers, has_missing,
            config.block_size, backend == "pallas" and not self._split)
        cva2, prior_pi, g_assign, fixed = self._mixture_setup(
            config, variant, cva, g_assign, fixed, self.M, self.N)
        if self.x_int8 and geno["has_missing"]:
            # int8 codes with missing calls: the serial in-kernel decode
            # (JAX's use_t is False there, sharded.py:552-555)
            self.jacobi, self.jacobi_layout = 1, "row"
        dev, dt = self.device, self.dtype
        # the fixed-effect columns in the state's dtype, individuals in
        # natural order and pads 0, split over "n"; fsq of those values
        # (sharded.py:396-417)
        fixedT = np.zeros((self.F, self.Npad), numpy_dtype(dt))
        fixedT[:, :self.N] = fixed.T
        self.data = MarkerData(
            **geno, valid=self._valid(),
            g_assign=put_global(self.mesh, np.pad(g_assign,
                                                  (0, self.Mpad - self.M))),
            cva=torch.as_tensor(cva2, dtype=dt, device=dev),
            prior_pi=torch.as_tensor(prior_pi, dtype=dt, device=dev),
            fixedT=put_global(self.mesh, fixedT, spec=(None, AXIS_N)),
            fsq=torch.as_tensor((fixedT.astype(np.float64) ** 2).sum(axis=1),
                                dtype=dt, device=dev))

    @property
    def supports_fused_chains(self) -> bool:
        """Fused chains run on (m, 1) meshes only (sharded.py:1074-1080)."""
        return self.Dn == 1 and super().supports_fused_chains

    # ------------------------------------------------------------ init

    def init(self, rng, chains: Optional[int] = None) -> SpikeSlabState:
        """Fresh-chain init (sharded.py:480-497): beta and labels of this
        slice zero, eps = Y (this n-slice); with ``chains=C`` a leading
        chain axis."""
        return self._init_state(self.variates(rng, chains), chains,
                                self.Mloc)

    # ------------------------------------------------------------ step

    def step(self, state: SpikeSlabState, rng) -> SpikeSlabState:
        """One Gibbs iteration of this slice (sharded.py:_step_local); every
        rank calls it with its own state, in step."""
        v = self.variates(rng)
        v.begin_step()
        mu, eps = self._intercept(state, v)
        alpha, eps = self._fixed_sweep(state, v, eps)
        Mloc, B, nb = self.Mloc, self.B, self.nb_loc
        if self.backend == "pallas" and self.strided:
            rho, inner = v.orders(nb, B, self.jacobi)
            p, z = v.p(Mloc), v.z(Mloc)
            res = self._sweep_t(bayesr_jacobi_t_rounds, state, eps, rho,
                                inner, p, z)
        else:
            border, inner = v.block_orders(nb, B)
            p, z = v.p(Mloc), v.z(Mloc)
            sweep = (self._sweep_xla if self.backend != "pallas"
                     else self._sweep_split if self._split
                     else self._sweep_serial)
            res = sweep(state, eps, border, inner, p, z)
        return self._next(state, v, mu, alpha, *res)

    def step_chains(self, state: SpikeSlabState, rng) -> SpikeSlabState:
        """One fused iteration of every chain of a chain-batched state
        (sharded.py:_mc_step_local): per-chain intercept, p/z and
        hyperparameters, one visit order for all chains.  (m, 1) meshes
        and the kernels only."""
        if self.Dn != 1:
            raise ValueError("step_chains runs on an (m, 1) mesh only "
                             "(sharded.py:1074-1080)")
        if not self.supports_fused_chains:
            raise ValueError("fused multi-chain steps need backend='pallas', "
                             "with no missing call at J=1")
        v = self.variates(rng, state.beta.shape[0])
        v.begin_step()
        mu, eps = self._intercept(state, v)
        alpha, eps = self._fixed_sweep(state, v, eps)
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
        return self._next(state, v, mu, alpha, *res)

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
            res = self._kernel(
                rounds, d.XT, d.gram, d.xsq, eps, beta, labels,
                rho[c0:c0 + nrc], inner, p, z, state.pi, d.cva,
                state.sigmaE, state.sigmaGG, d.g_assign, d.valid,
                J=self.jacobi, nr_total=nr, **self._sweep_kw())
            eps = self._reduce_eps(eps, res.eps, mask=True)
            beta, labels = res.beta, res.labels
            v, bacc = v + res.v, bacc + res.beta_acum
        return eps, beta, labels, v, bacc

    def _sweep_serial(self, state, eps, border, inner, p, z):
        """A slice whose plan is not "t" (sharded.py:615-654): the serial
        kernel on each chunk of ``chunk_blocks`` blocks
        (``_serial_chunks``)."""
        self._f64_check("bayesr_sweep_pallas")
        d = self.data
        beta, labels = state.beta, state.labels
        v = bacc = 0.0

        def sweep(eps, blocks, by_block, p_c, z_c):
            return self._kernel(bayesr_sweep, d.XT, d.gram, d.xsq, eps, beta,
                                labels, blocks, by_block, p_c, z_c, state.pi,
                                d.cva, state.sigmaE, state.sigmaGG,
                                d.g_assign, d.valid, **self._sweep_kw())

        for eps, beta, labels, v_c, bacc_c in self._serial_chunks(
                sweep, eps, border, inner, p, z):
            v, bacc = v + v_c, bacc + bacc_c
        return eps, beta, labels, v, bacc

    def _sweep_serial_mc(self, state, eps, border, inner, p, z):
        """The fused serial sweep of a slice whose plan is not "t"
        (sharded.py:884-906): chunks of blocks, p/z (C, Mloc) by marker.
        JAX indexes the chunk's positional within-block orders by block id
        (``inner_perm[block_order]``, pallas_multichain.py:408, clamped to
        the chunk's last row), so block b sweeps in the order of position
        min(b, chunk - 1) of the chunk; so does this."""
        self._f64_check("bayesr_sweep_pallas_mc")
        d = self.data
        nb, C = self.nb_loc, self._serial_chunk()
        beta, labels = state.beta, state.labels
        v = bacc = 0.0
        for c0 in range(0, nb, C):
            cb = min(C, nb - c0)
            at = torch.clamp(torch.arange(nb, device=inner.device), max=cb - 1)
            res = self._kernel(bayesr_sweep_mc, d.XT, d.gram, d.xsq, eps,
                               beta, labels, border[c0:c0 + cb],
                               inner[c0:c0 + cb][at], p, z, state.pi, d.cva,
                               state.sigmaE, state.sigmaGG, d.g_assign,
                               d.valid, **self._sweep_kw())
            eps = self._reduce_eps(eps, res.eps, mask=False)
            beta, labels = res.beta, res.labels
            v, bacc = v + res.v, bacc + res.beta_acum
        return eps, beta, labels, v, bacc

    def _sweep_split(self, state, eps, border, inner, p, z):
        """The split sweep (sharded.py:741-800): the round solves #13 on
        ``build_pkg_jacobi``'s operands, the inner orders re-keyed by
        block (:760-762)."""
        d = self.data
        B, G, K = self.B, self.G, self.K
        J = self.split_blocks()
        by_block = torch.zeros_like(inner)
        by_block[border.long()] = inner
        pkg, inner_sel = build_pkg_jacobi(
            d.xsq, d.g_assign, d.valid, p, z, state.pi, d.cva, state.sigmaE,
            state.sigmaGG, border, by_block, B=B, J=J)
        beta, labels = state.beta.clone(), state.labels.clone()
        acc = [0.0, 0.0]

        def solve(i, r, blk, idx):
            dl, beta_new, labels_new, v_r, bacc_r = self._kernel(
                bayesr_round_solve, r, d.gram[blk], beta[idx].view(J, B),
                labels[idx].view(J, B), d.g_assign[idx].view(J, B),
                inner_sel[i], pkg[i], state.sigmaE, K=K, G=G)
            beta[idx] = beta_new.reshape(-1)
            labels[idx] = labels_new.reshape(-1)
            acc[0], acc[1] = acc[0] + v_r, acc[1] + bacc_r
            return dl

        eps = self._split_rounds(eps, border, solve)
        return eps, beta, labels, acc[0], acc[1]

    def _sweep_xla(self, state, eps, border, inner, p, z):
        """``backend="xla"`` (sharded.py:570-605): one block a round in
        plain torch (``_xla_blocks``), the block's exact solve
        ``spike_slab_inner_solve``."""
        d = self.data
        B, G, K = self.B, self.G, self.K
        beta, labels = state.beta.clone(), state.labels.clone()
        v = torch.zeros((G, K), dtype=eps.dtype, device=eps.device)
        bacc = torch.zeros((G,), dtype=eps.dtype, device=eps.device)
        p, z = p.view(-1, B), z.view(-1, B)

        def solve(i, b, r):
            nonlocal v, bacc
            rows = slice(b * B, (b + 1) * B)
            _, beta[rows], labels[rows], delta, v, bacc = \
                bs.spike_slab_inner_solve(
                    r, d.gram[b], beta[rows], labels[rows], d.xsq[rows],
                    d.g_assign[rows], d.valid[rows], inner[i].long(), p[i],
                    z[i], state.pi, d.cva, state.sigmaE, state.sigmaGG, v,
                    bacc)
            return delta

        eps = self._xla_blocks(eps, border, solve)
        return eps, beta, labels, v, bacc

    # ------------------------------------------------------------ run

    def _emit_one(self, state: SpikeSlabState):
        """One emission row, beta and labels gathered over "m", eps over
        "n"."""
        return {
            "mu": state.mu,
            "beta": self._gathered(state.beta),
            "sigmaE": state.sigmaE,
            "sigmaG": state.sigmaGG,
            "comp": self._gathered(state.labels).to(torch.int8),
            "epsilon": self._emit_epsilon(state),
            "alpha": state.alpha,
            "sigmaF": state.sigmaF,
        }

    def run_chains(self, rng, n_chains: int, chain: ChainConfig, *,
                   fused: Optional[bool] = None, sink=None,
                   collect: bool = True, emit_chunk: int = 32,
                   progress=None, on_chunk=None):
        """``n_chains`` fused chains (sharded.py:1082-1152), the kernels'
        backend on an (m, 1) mesh only; only rank 0 writes to ``sink`` (a
        ``ChainFanoutSink``)."""
        if fused is False or not self.supports_fused_chains:
            raise ValueError("the sharded run_chains runs fused chains: "
                             "backend='pallas' on an (m, 1) mesh, no "
                             "missing call at J=1")
        return super().run_chains(
            rng, n_chains, chain, fused=True,
            sink=sink if self._writer else None, collect=collect,
            emit_chunk=emit_chunk, progress=progress, on_chunk=on_chunk)


class ShardedHorseshoeSampler(_ShardedMarkers, HorseshoeSampler):
    """Regularized-horseshoe sampler with its markers (and their lambda
    and v) split over the "m" axis and, for dense X, its individuals over
    the "n" axis of ``mesh`` (bayesrrcpp_tpu/parallel/sharded.py:
    1254-1739).  Parameters as ``ShardedSpikeSlabSampler``'s without cva,
    groups and fixed effects; ``config`` a HorseshoeConfig.  The kernels
    ("pallas") sweep every storage mode on (m, 1) meshes through the
    serial kernel in chunks (site #10) and dense X on Dn > 1 (or with
    ``split_sweep=True``) through the split sweep (site #14); "xla" is the
    plain sweep on dense X.  One chain: as in JAX there is no
    ``step_chains``, ``run_chains`` or ``init_from``."""

    def __init__(self, X, Y, config: HorseshoeConfig, mesh: Mesh, *,
                 dtype=None, backend: str = "xla",
                 chunk_blocks: Optional[int] = None, x_dtype: str = "dense",
                 x_stats=None, transposed: bool = False,
                 n_individuals: Optional[int] = None,
                 has_missing: Optional[bool] = None,
                 x_process_shard: bool = False,
                 n_markers: Optional[int] = None,
                 split_sweep: Optional[bool] = None):
        if not isinstance(config, HorseshoeConfig):
            raise ValueError("config must be a HorseshoeConfig")
        self._setup(mesh, backend, x_dtype, x_process_shard, chunk_blocks,
                    split_sweep, dtype)
        self.config = config
        geno = self._lay_out_slice(
            X, Y, transposed, x_stats, n_individuals, n_markers, has_missing,
            config.block_size, False)
        self.data = HorseshoeData(**geno, valid=self._valid())

    supports_fused_chains = False

    def init(self, rng, chains: Optional[int] = None) -> HorseshoeState:
        """Fresh-chain init (sharded.py:1439-1456): beta = 0 and lambda = v
        = 1 on this slice, eps = Y (this n-slice), eta and tau from their
        priors (the same draws on every rank)."""
        if chains is not None:
            raise ValueError("the sharded horseshoe runs one chain "
                             "(sharded.py has no fused horseshoe)")
        v = self.variates(rng)
        cfg = self.config
        dev, dt = self.device, self.dtype
        eps = self.Y.clone()
        sigmaE = self._psum(torch.sum(eps * eps), AXIS_N) / self.N * 0.5
        g_eta, g_tau = v.init_gammas(0.5, 0.5 * cfg.vT)
        eta = dist.inv_gamma(1.0 / (sigmaE * cfg.A ** 2), g_eta)
        tau = (1.0 / eta) * dist.inv_gamma(cfg.vT, g_tau)
        ones = torch.ones((self.Mloc,), dtype=dt, device=dev)
        return HorseshoeState(
            iteration=0, mu=torch.zeros((), dtype=dt, device=dev),
            beta=torch.zeros((self.Mloc,), dtype=dt, device=dev),
            eps=eps, sigmaE=sigmaE, lam=ones, v=ones.clone(),
            tau=tau.to(dt), eta=eta.to(dt),
            c2=torch.full((), cfg.c2, dtype=dt, device=dev))

    def init_from(self, *args, **kwargs):
        raise ValueError("the sharded horseshoe has no warm restart "
                         "(bayesrrcpp_tpu/parallel/sharded.py has none)")

    def step(self, state: HorseshoeState, rng) -> HorseshoeState:
        """One Gibbs iteration of this slice (sharded.py:1460-1563): the
        intercept, eta and this slice's v, the sweep, then lambda, tau, c2
        and sigmaE with their sums all-reduced."""
        v = self.variates(rng)
        v.begin_step()
        mu, eps, eta, v_aux = self._pre_sweep(state, v)
        border, inner = v.block_orders(self.nb_loc, self.B)
        z = v.z(self.Mloc)
        sweep = (self._sweep_xla if self.backend != "pallas"
                 else self._sweep_split if self._split
                 else self._sweep_serial)
        eps, beta = sweep(state, eps, border, inner, z)
        return self._next(state, v, mu, eta, v_aux, eps, beta)

    def step_chains(self, state, rng):
        raise ValueError("the sharded horseshoe has no fused chains "
                         "(bayesrrcpp_tpu/parallel/sharded.py has none)")

    def _sweep_serial(self, state, eps, border, inner, z):
        """Site #10 (sharded.py:1498-1519): ``horseshoe_sweep`` on chunks
        of ``chunk_blocks`` (default 128) blocks, one all-reduce of eps
        over "m" after each."""
        self._f64_check("horseshoe_sweep_pallas")
        d = self.data
        beta = state.beta

        def sweep(eps, blocks, by_block, z_c):
            return self._kernel(horseshoe_sweep, d.XT, d.gram, d.xsq, eps,
                                beta, blocks, by_block, z_c, state.lam,
                                state.tau, state.c2, state.sigmaE, d.valid,
                                **self._sweep_kw())

        for eps, beta in self._serial_chunks(sweep, eps, border, inner, z):
            pass
        return eps, beta

    def _sweep_split(self, state, eps, border, inner, z):
        """The split sweep (sharded.py:1565-1605): the round solves #14 on
        ``build_pkg_hs_jacobi``'s operands."""
        d = self.data
        B = self.B
        J = self.split_blocks()
        by_block = torch.zeros_like(inner)
        by_block[border.long()] = inner
        pkg, inner_sel = build_pkg_hs_jacobi(
            d.xsq, d.valid, z, state.lam, state.tau, state.c2, state.sigmaE,
            border, by_block, B=B, J=J)
        beta = state.beta.clone()

        def solve(i, r, blk, idx):
            dl, beta_new = self._kernel(
                horseshoe_round_solve, r, d.gram[blk], beta[idx].view(J, B),
                inner_sel[i], pkg[i])
            beta[idx] = beta_new.reshape(-1)
            return dl

        return self._split_rounds(eps, border, solve), beta

    def _sweep_xla(self, state, eps, border, inner, z):
        """``backend="xla"`` (sharded.py:1521-1541): one block a round in
        plain torch (``_xla_blocks``), the block's exact solve
        ``horseshoe_inner_solve``."""
        d = self.data
        B = self.B
        beta = state.beta.clone()
        z = z.view(-1, B)

        def solve(i, b, r):
            rows = slice(b * B, (b + 1) * B)
            _, beta[rows], delta = bs.horseshoe_inner_solve(
                r, d.gram[b], beta[rows], d.xsq[rows], state.lam[rows],
                d.valid[rows], inner[i].long(), z[i], state.tau, state.c2,
                state.sigmaE)
            return delta

        return self._xla_blocks(eps, border, solve), beta

    def _emit_one(self, state: HorseshoeState):
        """One emission row, beta and lambda gathered over "m", eps over
        "n"."""
        return {
            "mu": state.mu,
            "beta": self._gathered(state.beta),
            "sigmaE": state.sigmaE,
            "tau": state.tau,
            "lambda": self._gathered(state.lam),
            "epsilon": self._emit_epsilon(state),
        }

    def run_chains(self, *args, **kwargs):
        raise ValueError("the sharded horseshoe runs one chain "
                         "(bayesrrcpp_tpu/parallel/sharded.py has no fused "
                         "horseshoe)")
