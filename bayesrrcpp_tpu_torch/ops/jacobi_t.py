"""Strided-rounds BayesR and horseshoe block-Jacobi sweeps on dense f32
rows, int8 genotype codes or 2-bit packed genotypes.

Counterpart of ``bayesrrcpp_tpu/ops/pallas_jacobi_t.py:bayesr_jacobi_t_pallas``
and ``horseshoe_jacobi_t_pallas`` in their dense f32 mode (``x_mean=None``:
XT_pad (Mpad, N) standardized rows), their int8 mode (XT_pad (Mpad, N)
int8 codes, fold-affine: no missing calls, pallas_jacobi_t.py:287-298) and
their two packed modes: fold-affine (no missing calls) and ``missing``
(code 3 marks a missing call, which standardizes to 0).  Semantics (the
Markov kernel the port keeps):

- a sweep is nr = nb / J rounds; round r sweeps slab rho[r], the J blocks
  {j*nr + rho[r] : j < J}, every block against the round-start eps, and the
  round's J*B updates are applied to eps at once;
- position t of block j visits marker (j*nr + s)*B + inner[j*nr + s, t]
  and reads p/z[(s*J + j)*B + t] -- the variates are indexed by canonical
  slab, not by visit order;
- within a block, exact sequential Gibbs with the kernel's per-step algebra
  (``bayesr_tables`` below, pallas_jacobi_t.py:103-125 and :534-585);
- dense: r = X_b.eps and eps -= d.X_b on the rows themselves, no fold
  (pallas_jacobi_t.py:_decoders' dense branch, _dot2(exact=False));
- int8 and fold-affine words: the kernels dot the raw codes C, r =
  s*(C.eps) - (m*s)*sum(eps), and apply eps -= (d*s).C - d.(m*s); the
  plain versions dot the decoded rows (the same r up to f32 rounding);
- with ``missing=True`` a round's dot and apply run the TPU kernel's
  two-dot algebra (pallas_jacobi_t.py:_make_dots, :371-402): the raw-code
  dot plus the (mean - 3)-scaled dot of the missing indicator 1[c == 3],
  r = s*(C.eps + (m - 3)*(I.eps)) - (m*s)*sum(eps), and eps -= (d*s).C +
  (d*s*(m - 3)).I - d.(m*s) on the individuals n < N (``_miss_round``).

``bayesr_jacobi_t`` and ``horseshoe_jacobi_t`` are the entry points: on
CUDA tensors each launches its hand-written kernel of ``csrc/jacobi_t.cu``
(3 launches per round, counted in ``<entry point>.launches``) or raises; on
CPU tensors each runs its plain version (``*_reference``).  eps is in
natural individual order: of length N for dense X and int8 codes, padded
with zeros to Npad = 16 * words.shape[1] for packed words.

``bayesr_jacobi_t_mc`` and ``horseshoe_jacobi_t_mc`` are the fused
multi-chain sweeps (``bayesr_jacobi_t_pallas_mc``/``_mc8`` and
``horseshoe_jacobi_t_pallas_mc``/``_mc8``): C chains share the words, Gram
blocks and visit order, and every per-chain operand carries a leading
chain axis.  On CUDA tensors each launches ``csrc/jacobi_t_mc.cu`` (the
same three launches per round for up to 16 chains); on CPU tensors each
runs its plain version.

``bayesr_jacobi_t_rounds`` and ``bayesr_jacobi_t_mc_rounds`` sweep one
chunk of a sweep's rounds (``pallas_jacobi_t.py:bayesr_jacobi_t_rounds``
and ``bayesr_jacobi_t_mc_rounds``), the unit of work of the marker-sharded
driver (``parallel/sharded.py``), which all-reduces eps between chunks:
``rho_chunk`` holds the chunk's global round ids of a sweep of
``nr_total`` rounds.  They launch the same round loop of ``csrc/`` with a
round count; a chunk changes only its own markers' beta and labels, and v
and bacc count its own blocks.  The TPU call takes sum(eps) once per
chunk and tracks it; the port's dot sums eps afresh every round, so it
needs none.  A chunk of every round is the whole sweep, launch for launch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import genotypes

# launches per round of the CUDA sweeps: dot, solve, apply
LAUNCHES_PER_ROUND = 3
# chains per fused multi-chain launch (csrc/jacobi_t_mc.cu); more chains
# run as several groups of at most this many
MAX_FUSED_CHAINS = 16


class SweepResult(NamedTuple):
    eps: torch.Tensor        # (Npad,) or (N,) residuals after the sweep
    beta: torch.Tensor       # (Mpad,)
    labels: torch.Tensor     # (Mpad,) int32
    v: torch.Tensor          # (G, K) label counts of the hits
    beta_acum: torch.Tensor  # (G,) sum of beta^2 over slab hits


class MCSweepResult(NamedTuple):
    """A fused multi-chain sweep's result (bayesrrcpp_tpu/ops/
    pallas_multichain.py:MCSweepResult): ``SweepResult`` with a leading
    chain axis."""

    eps: torch.Tensor        # (C, Npad)
    beta: torch.Tensor       # (C, Mpad)
    labels: torch.Tensor     # (C, Mpad) int32
    v: torch.Tensor          # (C, G, K)
    beta_acum: torch.Tensor  # (C, G)


def _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing,
                row_valid=None) -> str:
    """X's storage: "dense" (f32 rows, ``x_mean`` None), "int8" (codes) or
    "words" (2-bit packed, which need ``row_valid``).  As the TPU wrapper
    (pallas_jacobi_t.py:_validate), ``missing=True`` runs the fold algebra
    with its missing-call correction whatever ``fold_affine`` says, only
    words take it, and quantized X needs the fold or the miss mode."""
    nb = gram.shape[0]
    if nb % J:
        raise ValueError(f"jacobi sweep needs J | nb (J={J}, nb={nb})")
    if x_mean is None:
        if missing:
            raise NotImplementedError(
                "missing=True needs 2-bit packed words (code 3): dense X "
                "carries no missing calls, as in the JAX package")
        if not XT_pad.dtype.is_floating_point:
            raise ValueError(f"dense jacobi sweep needs float rows, not "
                             f"{XT_pad.dtype}")
        return "dense"
    if XT_pad.dtype == torch.int8:
        if missing:
            raise ValueError("the missing fast path needs 2-bit packed X "
                             "(int8 with missing calls: use the "
                             "single-chain kernel)")
        storage = "int8"
    elif XT_pad.dtype == torch.int32:
        storage = "words"
    else:
        raise ValueError(f"quantized jacobi sweep needs int8 codes or int32 "
                         f"words, not {XT_pad.dtype}")
    if not (fold_affine or missing):
        raise ValueError("quantized jacobi sweep needs fold_affine=True "
                         "(missing-free codes) or missing=True")
    if storage == "words" and row_valid is None:
        raise ValueError("packed jacobi sweep needs row_valid")
    return storage


def _round_x(XT_pad, rows, mean, scale, lane_ok):
    """A round's rows as standardized f32 (rows, lanes): dense X's own
    (``mean`` None), or the int8 codes or 2-bit words decoded."""
    if mean is None:
        return XT_pad[rows].to(torch.float32)
    return genotypes.decode_rows(XT_pad[rows], mean[rows], scale[rows],
                                 lane_ok)


def _plain_storage(storage, x_mean, x_scale, row_valid):
    """(mean, scale, lane mask) of a plain sweep: all None for dense X, no
    lane mask for int8 codes (no pad lanes)."""
    if storage == "dense":
        return None, None, None
    return (x_mean.to(torch.float32), x_scale.to(torch.float32),
            row_valid.to(torch.bool) if storage == "words" else None)


def _miss_round(words, mean, scale, lane_ok):
    """(dot, apply) of one round's rows in the ``missing`` mode, the TPU
    kernel's two-dot algebra (pallas_jacobi_t.py:_make_dots, :418-427,
    :631-647): ``dot(eps)`` is r for eps (Npad,) or (C, Npad), ``apply(d,
    eps)`` eps after the round's deltas d (rows,) or (C, rows), written on
    the lanes where ``lane_ok`` only."""
    f32 = torch.float32
    c = genotypes.decode_codes(words).to(f32)               # (rows, Npad)
    ind = (c == genotypes.MISSING_CODE).to(f32)
    sc = scale
    ms = mean * sc
    mc = mean - float(genotypes.MISSING_CODE)

    def dot(eps):
        rc = eps @ c.T + (eps @ ind.T) * mc
        return rc * sc - ms * eps.sum(dim=-1, keepdim=True)

    def apply(d, eps):
        v = d * sc
        upd = v @ c + (v * mc) @ ind - (d * ms).sum(dim=-1, keepdim=True)
        return torch.where(lane_ok, eps - upd, eps)

    return dot, apply


def bayesr_jacobi_t(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                    rho, inner_perm, p_arr, z_arr,
                    pi, cva, sigmaE, sigmaGG, g_assign_pad, valid_pad,
                    *, J: int = 64, x_mean=None, x_scale=None, x_xsum=None,
                    fold_affine: bool = False, row_valid=None,
                    missing: bool = False) -> SweepResult:
    """One strided-rounds BayesR sweep (see the module docstring).

    XT_pad (Mpad, Npad/16) int32 words, or (Mpad, N) f32 standardized rows
    with ``x_mean`` None (the dense mode: eps (N,), no x_scale, row_valid);
    gram (nb, B, B); xsq_pad, beta_pad,
    labels_pad, g_assign_pad, valid_pad, p_arr, z_arr, x_mean, x_scale
    (Mpad,); eps and row_valid (Npad,); rho (nr,); inner_perm (nb, B); pi
    (G, K); cva (G, K-1); sigmaE scalar; sigmaGG (G,).  ``x_xsum`` is
    accepted for signature parity with the JAX wrapper: the port sums eps
    afresh each round instead of tracking it.  ``missing``: the words hold
    missing calls (code 3), swept in the kernel's ``miss`` mode.
    """
    _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing, row_valid)
    if XT_pad.device.type == "cpu":
        return bayesr_jacobi_t_reference(
            XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad, rho,
            inner_perm, p_arr, z_arr, pi, cva, sigmaE, sigmaGG,
            g_assign_pad, valid_pad, J=J, x_mean=x_mean, x_scale=x_scale,
            fold_affine=fold_affine, row_valid=row_valid, missing=missing)
    _check_cuda(XT_pad, "jacobi_t")
    res = _sweep_cuda(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                      rho, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                      sigmaGG, g_assign_pad, valid_pad, J, x_mean, x_scale,
                      row_valid, missing, gram.shape[0] // J)
    bayesr_jacobi_t.launches += LAUNCHES_PER_ROUND * rho.shape[0]
    return res


bayesr_jacobi_t.launches = 0


def _check_cuda(XT_pad, kernel):
    if XT_pad.device.type != "cuda":
        raise NotImplementedError(
            f"no {kernel} kernel for device {XT_pad.device}")


def _check_chunk(gram, J, rho_chunk, nr_total):
    """A chunk of rounds: ``nr_total`` is the sweep's round count, nb / J,
    and ``rho_chunk`` holds 1 to nr_total of its round ids."""
    nb = gram.shape[0]
    if nb % J or nr_total != nb // J:
        raise ValueError(f"nr_total={nr_total}: the sweep has nb / J = "
                         f"{nb} / {J} rounds")
    if rho_chunk.dim() != 1 or not 1 <= rho_chunk.shape[0] <= nr_total:
        raise ValueError(f"rho_chunk must hold 1 to {nr_total} round ids, "
                         f"got shape {tuple(rho_chunk.shape)}")


def bayesr_jacobi_t_rounds(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                           rho_chunk, inner_perm, p_arr, z_arr, pi, cva,
                           sigmaE, sigmaGG, g_assign_pad, valid_pad, *,
                           J: int, nr_total: int, x_mean=None, x_scale=None,
                           x_xsum=None, fold_affine: bool = False,
                           row_valid=None, missing: bool = False
                           ) -> SweepResult:
    """One chunk of a strided-rounds BayesR sweep (pallas_jacobi_t.py:
    bayesr_jacobi_t_rounds): the rounds ``rho_chunk`` (nrc,) of a sweep of
    ``nr_total`` = nb / J rounds, in that order, every round as in
    ``bayesr_jacobi_t``, whose operands these are (inner_perm, p_arr and
    z_arr of the whole sweep, by canonical slab).  Returns the
    ``SweepResult`` of the chunk: eps after its rounds, beta and labels of
    every marker (the others' unchanged), v and bacc over its blocks.
    A chunk of all nr_total rounds is ``bayesr_jacobi_t`` launch for
    launch.  On CUDA tensors it launches ``csrc/jacobi_t.cu`` (3 launches
    per round, counted in ``bayesr_jacobi_t_rounds.launches``) or raises;
    on CPU tensors it runs ``bayesr_jacobi_t_rounds_reference``.
    """
    _check_chunk(gram, J, rho_chunk, nr_total)
    _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing, row_valid)
    if XT_pad.device.type == "cpu":
        return bayesr_jacobi_t_reference(
            XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad, rho_chunk,
            inner_perm, p_arr, z_arr, pi, cva, sigmaE, sigmaGG,
            g_assign_pad, valid_pad, J=J, x_mean=x_mean, x_scale=x_scale,
            fold_affine=fold_affine, row_valid=row_valid, missing=missing)
    _check_cuda(XT_pad, "jacobi_t")
    res = _sweep_cuda(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                      rho_chunk, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                      sigmaGG, g_assign_pad, valid_pad, J, x_mean, x_scale,
                      row_valid, missing, rho_chunk.shape[0])
    bayesr_jacobi_t_rounds.launches += LAUNCHES_PER_ROUND * rho_chunk.shape[0]
    return res


bayesr_jacobi_t_rounds.launches = 0


def bayesr_jacobi_t_rounds_reference(XT_pad, gram, xsq_pad, eps, beta_pad,
                                     labels_pad, rho_chunk, inner_perm,
                                     p_arr, z_arr, pi, cva, sigmaE, sigmaGG,
                                     g_assign_pad, valid_pad, *, J: int,
                                     nr_total: int, x_mean=None,
                                     x_scale=None, x_xsum=None,
                                     fold_affine: bool = False,
                                     row_valid=None, missing: bool = False
                                     ) -> SweepResult:
    """The plain torch version of ``bayesr_jacobi_t_rounds``:
    ``bayesr_jacobi_t_reference``'s rounds for the chunk's round ids."""
    _check_chunk(gram, J, rho_chunk, nr_total)
    return bayesr_jacobi_t_reference(
        XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad, rho_chunk,
        inner_perm, p_arr, z_arr, pi, cva, sigmaE, sigmaGG, g_assign_pad,
        valid_pad, J=J, x_mean=x_mean, x_scale=x_scale,
        fold_affine=fold_affine, row_valid=row_valid, missing=missing)


def _operands(dev):
    """The checker of the CUDA sweeps' operands: each must lie on ``dev``
    (nothing is moved) and have the kernel's shape; it comes back in the
    kernel's dtype, contiguous."""
    def arg(t, dtype, shape, name):
        if isinstance(t, torch.Tensor) and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, words on {dev}")
        t = torch.as_tensor(t, device=dev)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        return t.to(dtype).contiguous()

    return arg


def _round_plan(lib, words, gram, J):
    """(Mpad, Nw, nb, B, nr) of a CUDA sweep, checked against what the
    kernel takes."""
    Mpad, Nw = words.shape
    nb, B, _ = gram.shape
    if nb * B != Mpad:
        raise ValueError(f"gram has {nb}x{B} markers, words {Mpad}")
    if not (2 <= B <= lib.lib.jacobi_t_max_block() and B % 2 == 0):
        raise ValueError(f"jacobi_t kernel takes blocks of an even number "
                         f"of markers <= 32 (B={B})")
    if J * B > lib.lib.jacobi_t_max_round():
        raise ValueError(f"jacobi_t kernel takes <= 4096 markers per round "
                         f"(J*B={J * B})")
    return Mpad, Nw, nb, B, nb // J


def _storage_ops(lib, arg, X, mean, scale, row_valid):
    """A CUDA strided sweep's storage operands: (X, ncol, lanes, mean,
    scale, row_valid, nsplit, x_int8).  Dense X (``mean`` None) is (Mpad, N)
    f32 with ncol = lanes = N and null mean, scale and row_valid (the
    kernels' dense mode); int8 codes are (Mpad, N) int8 with ncol = lanes =
    N and a null row_valid (x_int8 = 1: the int8 mode); packed words are
    (Mpad, Nw) int32 with 16 lanes a word."""
    f32 = torch.float32
    Mpad, ncol = X.shape
    if mean is None:
        return (arg(X, f32, (Mpad, ncol), "X"), ncol, ncol, None, None, None,
                lib.lib.jacobi_t_dense_dot_splits(ncol), 0)
    mean = arg(mean, f32, (Mpad,), "x_mean")
    scale = arg(scale, f32, (Mpad,), "x_scale")
    if X.dtype == torch.int8:
        return (arg(X, torch.int8, (Mpad, ncol), "codes"), ncol, ncol, mean,
                scale, None, lib.lib.jacobi_t_int8_dot_splits(ncol), 1)
    lanes = ncol * genotypes.WORDS
    return (arg(X, torch.int32, (Mpad, ncol), "words"), ncol, lanes, mean,
            scale, arg(row_valid, torch.bool, (lanes,), "row_valid"),
            lib.lib.jacobi_t_dot_splits(ncol), 0)


def _miss_partials(missing, rows, dev):
    """The missing indicator's dot partials of a CUDA sweep in ``missing``
    mode, ``rows`` floats, else None (a null pointer: the fold mode)."""
    if not missing:
        return None
    return torch.empty((rows,), dtype=torch.float32, device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _chunk_outputs(beta_in, labels_in, nb, G, K, chunk, C=None):
    """(beta_out, labels_out, vpart, bpart) of a CUDA BayesR sweep, with a
    chain axis of C when given.  The solves write the blocks of the rounds
    they run: a chunk's outputs start from the inputs and zero partials,
    a whole sweep's from empty buffers that every block fills."""
    lead = () if C is None else (C,)
    if chunk:
        return (beta_in.clone(), labels_in.clone(),
                beta_in.new_zeros(lead + (nb, G, K)),
                beta_in.new_zeros(lead + (nb, G)))
    return (torch.empty_like(beta_in), torch.empty_like(labels_in),
            beta_in.new_empty(lead + (nb, G, K)),
            beta_in.new_empty(lead + (nb, G)))


def _sweep_cuda(words, gram, xsq, eps, beta, labels, rho, inner, p, z, pi,
                cva, sigmaE, sigmaGG, gas, valid, J, mean, scale, row_valid,
                missing, n_rounds):
    """The CUDA BayesR sweep of the n_rounds rounds ``rho`` (a whole sweep
    when n_rounds == nb / J)."""
    from . import _cuda

    lib = _cuda.library("jacobi_t")
    dev = words.device
    Mpad, Nw, nb, B, nr = _round_plan(lib, words, gram, J)
    G, K = pi.shape
    if not 2 <= K <= lib.lib.jacobi_t_max_components():
        raise ValueError(f"jacobi_t kernel takes 2 <= K <= 8 (K={K})")
    f32, i32 = torch.float32, torch.int32
    arg = _operands(dev)

    words, Nw, Npad, mean, scale, row_valid, nsplit, x_int8 = _storage_ops(
        lib, arg, words, mean, scale, row_valid)
    gram = arg(gram, f32, (nb, B, B), "gram")
    xsq = arg(xsq, f32, (Mpad,), "xsq")
    beta_in = arg(beta, f32, (Mpad,), "beta")
    labels_in = arg(labels, i32, (Mpad,), "labels")
    rho = arg(rho, i32, (n_rounds,), "rho")
    inner = arg(inner, i32, (nb, B), "inner_perm")
    p = arg(p, f32, (Mpad,), "p")
    z = arg(z, f32, (Mpad,), "z")
    pi = arg(pi, f32, (G, K), "pi")
    cva = arg(cva, f32, (G, K - 1), "cva")
    sigmaE = arg(sigmaE, f32, (), "sigmaE")
    sigmaGG = arg(sigmaGG, f32, (G,), "sigmaGG")
    gas = arg(gas, i32, (Mpad,), "g_assign")
    valid = arg(valid, torch.bool, (Mpad,), "valid")
    eps_out = torch.empty((Npad,), dtype=f32, device=dev)
    eps_out.copy_(arg(eps, f32, (Npad,), "eps"))

    beta_out, labels_out, vpart, bpart = _chunk_outputs(
        beta_in, labels_in, nb, G, K, n_rounds < nr)
    partial = torch.empty(((J * B + 1) * nsplit,), dtype=f32, device=dev)
    pind = _miss_partials(missing, J * B * nsplit, dev)
    dsc = torch.empty((J * B,), dtype=f32, device=dev)
    dms = torch.empty((J,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.lib.jacobi_t_sweep(
        words.data_ptr(), Nw, x_int8, nr, n_rounds, J, B, K, G,
        gram.data_ptr(), xsq.data_ptr(), _ptr(mean), _ptr(scale),
        eps_out.data_ptr(),
        _ptr(row_valid), beta_in.data_ptr(), labels_in.data_ptr(),
        beta_out.data_ptr(), labels_out.data_ptr(), rho.data_ptr(),
        inner.data_ptr(), p.data_ptr(), z.data_ptr(), pi.data_ptr(),
        cva.data_ptr(), sigmaE.data_ptr(), sigmaGG.data_ptr(),
        gas.data_ptr(), valid.data_ptr(), partial.data_ptr(), nsplit,
        dsc.data_ptr(), dms.data_ptr(), vpart.data_ptr(), bpart.data_ptr(),
        _ptr(pind), stream)
    lib.check(rc, "jacobi_t_sweep launch")
    return SweepResult(eps_out, beta_out, labels_out, vpart.sum(dim=0),
                       bpart.sum(dim=0))


def bayesr_tables(xsq, gas, pi, cva, sigmaE, sigmaGG):
    """Per-marker step constants (..., Mpad, K) each: lp, 1/denom and the
    slab sd, with the spike in column 0 (pallas_jacobi_t.py:_bayesr_tbl).
    A leading chain axis of pi (C, G, K), sigmaE (C,) and sigmaGG (C, G)
    carries through."""
    f32 = torch.float32
    xsq = xsq.to(f32)[:, None]                     # (Mpad, 1)
    gas = gas.long()
    sG = sigmaGG.to(f32)[..., gas, None]           # (..., Mpad, 1)
    cva_m = cva.to(f32)[gas]                       # (Mpad, K-1)
    sE = sigmaE.to(f32)[..., None, None]           # (..., 1, 1)
    denom = xsq + (sE / sG) / cva_m
    zero = torch.zeros(denom.shape[:-1] + (1,), dtype=f32, device=xsq.device)
    invd = torch.cat([zero, 1.0 / denom], dim=-1)
    sd = torch.cat([zero, torch.sqrt(sE / denom)], dim=-1)
    tiny = torch.finfo(f32).tiny
    logpi = torch.log(torch.clamp_min(pi.to(f32)[..., gas, :], tiny))
    lp = torch.cat([
        logpi[..., 0:1],
        logpi[..., 1:] - 0.5 * torch.log((sG / sE) * xsq * cva_m + 1.0),
    ], dim=-1)
    return lp, invd, sd


def cumulative_weights(lp, invd, num, half_invsE):
    """(muk, acum) of the BayesR draw (pallas_sweep.py:246-264): the slab
    means muk (..., K) and the running sums acum (..., K) of the
    components' weights, spike first, for numerators num (...).  The
    reference's overflow guard zeroes a component's weight when any slab
    logL is more than 700 from its own."""
    K = lp.shape[-1]
    muk = num[..., None] * invd
    logL = lp + (half_invsE * num)[..., None] * muk
    acum = []
    run = torch.zeros_like(num)
    for k in range(K):
        lk = logL[..., k]
        gmax = torch.abs(logL[..., 1] - lk)
        for kk in range(2, K):
            gmax = torch.maximum(gmax, torch.abs(logL[..., kk] - lk))
        S = torch.exp(logL[..., 0] - lk)
        for kk in range(1, K):
            S = S + torch.exp(logL[..., kk] - lk)
        run = run + torch.where(gmax > 700.0, torch.zeros_like(S), 1.0 / S)
        acum.append(run)
    return muk, torch.stack(acum, dim=-1)


def categorical_draw(lp, invd, sd, num, half_invsE, p, z, bold, okf):
    """The BayesR categorical draw of a batch of markers, the plain version
    of csrc/jacobi_t_common.cuh:categorical_draw (pallas_sweep.py:246-264),
    shared by every plain BayesR sweep.  lp, invd and sd (..., K) are the
    markers' component tables (spike first); num = r + beta_old*xsq, p, z,
    bold and okf (...); half_invsE broadcasts to them.  The first k with p
    <= the cumulative weight (``cumulative_weights``) wins, and no hit
    keeps beta_old.  Returns (d, krec): d = okf*(beta_new - beta_old) and
    the hit's component, or -1 (int32)."""
    K = lp.shape[-1]
    muk, acum = cumulative_weights(lp, invd, num, half_invsE)
    ksel = torch.full(num.shape, K, dtype=torch.int64, device=num.device)
    for k in range(K):
        hit = (p <= acum[..., k]) & (ksel == K)
        ksel = torch.where(hit, torch.full_like(ksel, k), ksel)
    hitm = ksel < K
    kc = torch.clamp_max(ksel, K - 1)[..., None]
    mu_sel = torch.where(hitm, muk.gather(-1, kc)[..., 0], 0.0)
    sd_sel = torch.where(hitm, sd.gather(-1, kc)[..., 0], 0.0)
    beta_new = torch.where(hitm, mu_sel + sd_sel * z, bold)
    krec = torch.where((okf > 0) & hitm, ksel.to(torch.int32), -1)
    return okf * (beta_new - bold), krec


def strided_steps(rr, G_r, bold, inn, blk, p_r, z_r, lp, invd, sd, xsq, okf,
                  half_invsE):
    """The B sequential BayesR steps of a round's J blocks, batched over the
    blocks and any leading chain axis: step t of block j visits marker
    inn[j, t] with p/z_r[..., j, t], draws on the current r (rr, (..., J,
    B) by marker) and updates r by the visited marker's Gram row.  bold
    (..., J, B); lp, invd, sd (..., Mpad, K); xsq and okf (Mpad,).
    Returns d and krec (..., J, B) by marker: the plain one-step loop of
    every strided BayesR sweep (csrc/jacobi_t_common.cuh:solve_block runs
    the same draws as passes)."""
    J, B = inn.shape
    jj = torch.arange(J, device=rr.device)
    d = torch.zeros_like(rr)
    krec = torch.full(rr.shape, -1, dtype=torch.int32, device=rr.device)
    for t in range(B):
        m = inn[:, t]                                         # (J,)
        mg = blk * B + m                                      # markers
        b_old = bold[..., jj, m]
        num = rr[..., jj, m] + b_old * xsq[mg]
        dd, krec[..., jj, m] = categorical_draw(
            lp[..., mg, :], invd[..., mg, :], sd[..., mg, :], num,
            half_invsE, p_r[..., t], z_r[..., t], b_old, okf[mg])
        rr = rr - G_r[jj, m, :] * dd[..., None]
        d[..., jj, m] = dd
    return d, krec


def bayesr_jacobi_t_reference(XT_pad, gram, xsq_pad, eps, beta_pad,
                              labels_pad, rho, inner_perm, p_arr, z_arr,
                              pi, cva, sigmaE, sigmaGG, g_assign_pad,
                              valid_pad, *, J: int, x_mean=None, x_scale=None,
                              x_xsum=None, fold_affine: bool = False,
                              row_valid=None, missing: bool = False
                              ) -> SweepResult:
    """The plain torch version of ``bayesr_jacobi_t``: each round of
    ``rho`` takes its J*B markers' standardized f32 rows (dense X's own, or
    decoded; with ``missing`` the codes and the missing indicator,
    ``_miss_round``) and runs the J blocks' sequential solves batched over
    the blocks, with the kernel's algebra."""
    storage = _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing,
                          row_valid)
    f32 = torch.float32
    dev = XT_pad.device
    nb, B, _ = gram.shape
    nr = nb // J
    G, K = pi.shape
    sigmaE = torch.as_tensor(sigmaE, dtype=f32, device=dev)
    lp, invd, sd = bayesr_tables(xsq_pad, g_assign_pad, pi, cva, sigmaE,
                                 sigmaGG)
    xsq = xsq_pad.to(f32)
    okf = valid_pad.to(f32)
    gas = g_assign_pad.long()
    mean, scale, lane_ok = _plain_storage(storage, x_mean, x_scale,
                                          row_valid)
    eps = eps.to(f32).clone()
    beta = beta_pad.to(f32).clone()
    labels = labels_pad.to(torch.int32).clone()
    v = torch.zeros((G, K), dtype=f32, device=dev)
    bacc = torch.zeros((G,), dtype=f32, device=dev)
    half_invsE = 0.5 / sigmaE
    jj = torch.arange(J, device=dev)
    lanes = torch.arange(B, device=dev)
    kcol = torch.arange(K, device=dev)
    gram = gram.to(f32)
    inner_perm = inner_perm.long()
    for r in range(rho.shape[0]):
        s = rho[r].long()
        blk = jj * nr + s                                     # (J,)
        rows = (blk[:, None] * B + lanes).reshape(-1)         # (J*B,)
        if missing:
            dot, apply = _miss_round(XT_pad[rows], mean[rows], scale[rows],
                                     lane_ok)
            rr = dot(eps).view(J, B)
        else:
            x = _round_x(XT_pad, rows, mean, scale, lane_ok)  # (J*B, lanes)
            rr = (x @ eps).view(J, B)
        bold = beta[rows].view(J, B)
        inn = inner_perm[blk]                                 # (J, B)
        pos = (s * J + jj)[:, None] * B + lanes
        p_r, z_r = p_arr[pos].to(f32), z_arr[pos].to(f32)
        d, krec = strided_steps(rr, gram[blk], bold, inn, blk, p_r, z_r,
                                lp, invd, sd, xsq, okf, half_invsE)
        bnew = bold + d
        beta[rows] = bnew.reshape(-1)
        labels[rows] = torch.where(krec >= 0, krec,
                                   labels[rows].view(J, B)).reshape(-1)
        g_r = gas[rows].view(J, B)
        for g in range(G):
            in_g = g_r == g
            v[g] += ((krec[:, :, None] == kcol) & in_g[:, :, None]).sum(
                dim=(0, 1)).to(f32)
            bacc[g] += torch.where((krec > 0) & in_g, bnew * bnew,
                                   0.0).sum()
        eps = (apply(d.reshape(-1), eps) if missing
               else eps - d.reshape(-1) @ x)
    return SweepResult(eps, beta, labels, v, bacc)


# ---------------------------------------------------------------- horseshoe


def horseshoe_jacobi_t(XT_pad, gram, xsq_pad, eps, beta_pad, rho, inner_perm,
                       z_arr, lam_pad, tau, c2, sigmaE, valid_pad, *,
                       J: int = 64, x_mean=None, x_scale=None, x_xsum=None,
                       fold_affine: bool = False, row_valid=None,
                       missing: bool = False):
    """One strided-rounds horseshoe sweep (pallas_jacobi_t.py:
    horseshoe_jacobi_t_pallas): the rounds, visit order and z indexing of
    ``bayesr_jacobi_t``, with the conjugate normal draw of ``_hs_tables``
    per step.  Returns (eps, beta).

    lam_pad (Mpad,); tau, c2 and sigmaE scalars; the other operands as in
    ``bayesr_jacobi_t``.  On CUDA tensors it launches ``csrc/jacobi_t.cu``'s
    horseshoe sweep (3 launches per round, counted in
    ``horseshoe_jacobi_t.launches``) or raises; on CPU tensors it runs
    ``horseshoe_jacobi_t_reference``.
    """
    _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing, row_valid)
    if XT_pad.device.type == "cpu":
        return horseshoe_jacobi_t_reference(
            XT_pad, gram, xsq_pad, eps, beta_pad, rho, inner_perm, z_arr,
            lam_pad, tau, c2, sigmaE, valid_pad, J=J, x_mean=x_mean,
            x_scale=x_scale, fold_affine=fold_affine, row_valid=row_valid,
            missing=missing)
    if XT_pad.device.type != "cuda":
        raise NotImplementedError(
            f"no jacobi_t kernel for device {XT_pad.device}")
    return _hs_sweep_cuda(XT_pad, gram, xsq_pad, eps, beta_pad, rho,
                          inner_perm, z_arr, lam_pad, tau, c2, sigmaE,
                          valid_pad, J, x_mean, x_scale, row_valid, missing)


horseshoe_jacobi_t.launches = 0


def _hs_sweep_cuda(words, gram, xsq, eps, beta, rho, inner, z, lam, tau, c2,
                   sigmaE, valid, J, mean, scale, row_valid, missing):
    from . import _cuda

    lib = _cuda.library("jacobi_t")
    dev = words.device
    Mpad, Nw, nb, B, nr = _round_plan(lib, words, gram, J)
    f32, i32 = torch.float32, torch.int32
    arg = _operands(dev)

    words, Nw, Npad, mean, scale, row_valid, nsplit, x_int8 = _storage_ops(
        lib, arg, words, mean, scale, row_valid)
    gram = arg(gram, f32, (nb, B, B), "gram")
    xsq = arg(xsq, f32, (Mpad,), "xsq")
    beta_in = arg(beta, f32, (Mpad,), "beta")
    rho = arg(rho, i32, (nr,), "rho")
    inner = arg(inner, i32, (nb, B), "inner_perm")
    z = arg(z, f32, (Mpad,), "z")
    lam = arg(lam, f32, (Mpad,), "lam")
    tau = arg(tau, f32, (), "tau")
    c2 = arg(c2, f32, (), "c2")
    sigmaE = arg(sigmaE, f32, (), "sigmaE")
    valid = arg(valid, torch.bool, (Mpad,), "valid")
    eps_out = torch.empty((Npad,), dtype=f32, device=dev)
    eps_out.copy_(arg(eps, f32, (Npad,), "eps"))

    beta_out = torch.empty((Mpad,), dtype=f32, device=dev)
    partial = torch.empty(((J * B + 1) * nsplit,), dtype=f32, device=dev)
    pind = _miss_partials(missing, J * B * nsplit, dev)
    dsc = torch.empty((J * B,), dtype=f32, device=dev)
    dms = torch.empty((J,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.lib.jacobi_t_hs_sweep(
        words.data_ptr(), Nw, x_int8, nr, J, B, gram.data_ptr(),
        xsq.data_ptr(),
        _ptr(mean), _ptr(scale), eps_out.data_ptr(),
        _ptr(row_valid), beta_in.data_ptr(), beta_out.data_ptr(),
        rho.data_ptr(), inner.data_ptr(), z.data_ptr(), lam.data_ptr(),
        tau.data_ptr(), c2.data_ptr(), sigmaE.data_ptr(), valid.data_ptr(),
        partial.data_ptr(), nsplit, dsc.data_ptr(), dms.data_ptr(),
        _ptr(pind), stream)
    lib.check(rc, "jacobi_t_hs_sweep launch")
    horseshoe_jacobi_t.launches += LAUNCHES_PER_ROUND * nr
    return eps_out, beta_out


def _hs_tables(xsq, lam, tau, c2, sigmaE):
    """Per-marker 1/denom and sd of the horseshoe step, in the op order of
    the TPU kernel's operand table (pallas_jacobi_t.py:
    build_pkgT_hs_strided, src/HorseshoeR.cpp:224, 234).  A leading chain
    axis of lam (C, Mpad) and tau, c2, sigmaE (C,) carries through."""
    f32 = torch.float32
    dev = xsq.device
    xsq, lam = xsq.to(f32), lam.to(f32)
    tau, c2, sE = (torch.as_tensor(x, dtype=f32, device=dev)[..., None]
                   for x in (tau, c2, sigmaE))
    s_j = tau * c2 * lam / (tau * lam + c2)
    denom = xsq + sE / s_j
    return 1.0 / denom, torch.sqrt(sE / denom)


def horseshoe_jacobi_t_reference(XT_pad, gram, xsq_pad, eps, beta_pad, rho,
                                 inner_perm, z_arr, lam_pad, tau, c2, sigmaE,
                                 valid_pad, *, J: int, x_mean=None,
                                 x_scale=None, x_xsum=None,
                                 fold_affine: bool = False, row_valid=None,
                                 missing: bool = False):
    """The plain torch version of ``horseshoe_jacobi_t``: each round takes
    its J*B markers' standardized f32 rows (dense X's own, or decoded; with
    ``missing`` the codes and the missing indicator, ``_miss_round``) and
    runs the J blocks' sequential
    solves batched over the blocks, with the kernel's algebra (beta_new =
    num*invd + sd*z, pallas_jacobi_t.py:748-750)."""
    storage = _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing,
                          row_valid)
    f32 = torch.float32
    dev = XT_pad.device
    nb, B, _ = gram.shape
    nr = nb // J
    invd, sd = _hs_tables(xsq_pad, lam_pad, tau, c2, sigmaE)
    xsq = xsq_pad.to(f32)
    okf = valid_pad.to(f32)
    mean, scale, lane_ok = _plain_storage(storage, x_mean, x_scale,
                                          row_valid)
    eps = eps.to(f32).clone()
    beta = beta_pad.to(f32).clone()
    jj = torch.arange(J, device=dev)
    lanes = torch.arange(B, device=dev)
    gram = gram.to(f32)
    inner_perm = inner_perm.long()
    for r in range(rho.shape[0]):
        s = rho[r].long()
        blk = jj * nr + s                                     # (J,)
        rows = (blk[:, None] * B + lanes).reshape(-1)         # (J*B,)
        if missing:
            dot, apply = _miss_round(XT_pad[rows], mean[rows], scale[rows],
                                     lane_ok)
            rr = dot(eps).view(J, B)
        else:
            x = _round_x(XT_pad, rows, mean, scale, lane_ok)  # (J*B, lanes)
            rr = (x @ eps).view(J, B)
        bold = beta[rows].view(J, B)
        inn = inner_perm[blk]                                 # (J, B)
        z_r = z_arr[(s * J + jj)[:, None] * B + lanes].to(f32)
        G_r = gram[blk]                                       # (J, B, B)
        d = torch.zeros((J, B), dtype=f32, device=dev)
        for t in range(B):
            m = inn[:, t]                                     # (J,)
            mg = blk * B + m                                  # markers
            b_old = bold[jj, m]
            num = rr[jj, m] + b_old * xsq[mg]
            beta_new = num * invd[mg] + sd[mg] * z_r[:, t]
            dd = okf[mg] * (beta_new - b_old)
            rr = rr - G_r[jj, m, :] * dd[:, None]
            d[jj, m] = dd
        beta[rows] = (bold + d).reshape(-1)
        eps = (apply(d.reshape(-1), eps) if missing
               else eps - d.reshape(-1) @ x)
    return eps, beta


# ---------------------------------------------------------------- multi-chain


def _chain_groups(C: int):
    return [slice(c0, min(c0 + MAX_FUSED_CHAINS, C))
            for c0 in range(0, C, MAX_FUSED_CHAINS)]


def bayesr_jacobi_t_mc(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                       rho, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                       sigmaGG, g_assign_pad, valid_pad, *, J: int = 64,
                       x_mean=None, x_scale=None, x_xsum=None,
                       fold_affine: bool = False, row_valid=None,
                       missing: bool = False) -> MCSweepResult:
    """One fused strided-rounds BayesR sweep of C chains (pallas_jacobi_t.py:
    bayesr_jacobi_t_pallas_mc and, for 4 < C <= 16, bayesr_jacobi_t_pallas_mc8).

    The chains share the words (or dense rows), Gram blocks, rho and inner;
    per-chain operands carry a leading chain axis: eps (C, Npad) (dense:
    (C, N)), beta_pad,
    labels_pad, p_arr and z_arr (C, Mpad), pi (C, G, K), sigmaE (C,),
    sigmaGG (C, G).  p/z are read by canonical slab position, as in
    ``bayesr_jacobi_t``.  On CUDA tensors it launches ``csrc/jacobi_t_mc.cu``
    (3 launches per round for each group of at most 16 chains, counted in
    ``bayesr_jacobi_t_mc.launches``) or raises; on CPU tensors it runs
    ``bayesr_jacobi_t_mc_reference``.  Chains never interact given the
    shared orders, so the grouping does not change the result.
    """
    _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing, row_valid)
    if XT_pad.device.type == "cpu":
        return bayesr_jacobi_t_mc_reference(
            XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad, rho,
            inner_perm, p_arr, z_arr, pi, cva, sigmaE, sigmaGG,
            g_assign_pad, valid_pad, J=J, x_mean=x_mean, x_scale=x_scale,
            fold_affine=fold_affine, row_valid=row_valid, missing=missing)
    _check_cuda(XT_pad, "jacobi_t_mc")
    groups = _chain_groups(eps.shape[0])
    res = _mc_groups(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad, rho,
                     inner_perm, p_arr, z_arr, pi, cva, sigmaE, sigmaGG,
                     g_assign_pad, valid_pad, J, x_mean, x_scale, row_valid,
                     missing, groups)
    bayesr_jacobi_t_mc.launches += (LAUNCHES_PER_ROUND * rho.shape[0]
                                    * len(groups))
    return res


bayesr_jacobi_t_mc.launches = 0


def _mc_groups(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad, rho,
               inner_perm, p_arr, z_arr, pi, cva, sigmaE, sigmaGG,
               g_assign_pad, valid_pad, J, x_mean, x_scale, row_valid,
               missing, groups):
    """The fused CUDA sweep of the rounds ``rho``, one launch sequence per
    group of at most 16 chains."""
    parts = [_mc_sweep_cuda(XT_pad, gram, xsq_pad, eps[g], beta_pad[g],
                            labels_pad[g], rho, inner_perm, p_arr[g],
                            z_arr[g], pi[g], cva, sigmaE[g], sigmaGG[g],
                            g_assign_pad, valid_pad, J, x_mean, x_scale,
                            row_valid, missing)
             for g in groups]
    if len(parts) == 1:
        return parts[0]
    return MCSweepResult(*(torch.cat(f) for f in zip(*parts)))


def bayesr_jacobi_t_mc_rounds(XT_pad, gram, xsq_pad, eps, beta_pad,
                              labels_pad, rho_chunk, inner_perm, p_arr,
                              z_arr, pi, cva, sigmaE, sigmaGG, g_assign_pad,
                              valid_pad, *, J: int, nr_total: int,
                              x_mean=None, x_scale=None, x_xsum=None,
                              fold_affine: bool = False, row_valid=None,
                              missing: bool = False) -> MCSweepResult:
    """One chunk of a fused strided-rounds BayesR sweep of C chains
    (pallas_jacobi_t.py:bayesr_jacobi_t_mc_rounds): the rounds
    ``rho_chunk`` of a sweep of ``nr_total`` rounds, on the operands of
    ``bayesr_jacobi_t_mc``, with the outputs of ``bayesr_jacobi_t_rounds``
    for every chain.  On CUDA tensors it launches ``csrc/jacobi_t_mc.cu``
    (3 launches per round for each group of at most 16 chains, counted in
    ``bayesr_jacobi_t_mc_rounds.launches``) or raises; on CPU tensors it
    runs ``bayesr_jacobi_t_mc_rounds_reference``."""
    _check_chunk(gram, J, rho_chunk, nr_total)
    _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing, row_valid)
    if XT_pad.device.type == "cpu":
        return bayesr_jacobi_t_mc_reference(
            XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad, rho_chunk,
            inner_perm, p_arr, z_arr, pi, cva, sigmaE, sigmaGG,
            g_assign_pad, valid_pad, J=J, x_mean=x_mean, x_scale=x_scale,
            fold_affine=fold_affine, row_valid=row_valid, missing=missing)
    _check_cuda(XT_pad, "jacobi_t_mc")
    groups = _chain_groups(eps.shape[0])
    res = _mc_groups(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                     rho_chunk, inner_perm, p_arr, z_arr, pi, cva, sigmaE,
                     sigmaGG, g_assign_pad, valid_pad, J, x_mean, x_scale,
                     row_valid, missing, groups)
    bayesr_jacobi_t_mc_rounds.launches += (LAUNCHES_PER_ROUND
                                           * rho_chunk.shape[0] * len(groups))
    return res


bayesr_jacobi_t_mc_rounds.launches = 0


def bayesr_jacobi_t_mc_rounds_reference(XT_pad, gram, xsq_pad, eps,
                                        beta_pad, labels_pad, rho_chunk,
                                        inner_perm, p_arr, z_arr, pi, cva,
                                        sigmaE, sigmaGG, g_assign_pad,
                                        valid_pad, *, J: int, nr_total: int,
                                        x_mean=None, x_scale=None,
                                        x_xsum=None,
                                        fold_affine: bool = False,
                                        row_valid=None, missing: bool = False
                                        ) -> MCSweepResult:
    """The plain torch version of ``bayesr_jacobi_t_mc_rounds``:
    ``bayesr_jacobi_t_mc_reference``'s rounds for the chunk's round ids."""
    _check_chunk(gram, J, rho_chunk, nr_total)
    return bayesr_jacobi_t_mc_reference(
        XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad, rho_chunk,
        inner_perm, p_arr, z_arr, pi, cva, sigmaE, sigmaGG, g_assign_pad,
        valid_pad, J=J, x_mean=x_mean, x_scale=x_scale,
        fold_affine=fold_affine, row_valid=row_valid, missing=missing)


def _mc_libs():
    from . import _cuda

    lib, mc = _cuda.libraries("jacobi_t", "jacobi_t_mc")
    if mc.lib.jacobi_t_mc_max_chains() != MAX_FUSED_CHAINS:
        raise RuntimeError("csrc/jacobi_t_mc.cu and MAX_FUSED_CHAINS differ")
    return lib, mc


def _mc_sweep_cuda(words, gram, xsq, eps, beta, labels, rho, inner, p, z, pi,
                   cva, sigmaE, sigmaGG, gas, valid, J, mean, scale,
                   row_valid, missing):
    lib, mc = _mc_libs()
    dev = words.device
    Mpad, Nw, nb, B, nr = _round_plan(lib, words, gram, J)
    n_rounds = rho.shape[0]
    C, G, K = pi.shape
    if not 2 <= K <= lib.lib.jacobi_t_max_components():
        raise ValueError(f"jacobi_t kernel takes 2 <= K <= 8 (K={K})")
    f32, i32 = torch.float32, torch.int32
    arg = _operands(dev)

    words, Nw, Npad, mean, scale, row_valid, nsplit, x_int8 = _storage_ops(
        lib, arg, words, mean, scale, row_valid)
    gram = arg(gram, f32, (nb, B, B), "gram")
    xsq = arg(xsq, f32, (Mpad,), "xsq")
    beta_in = arg(beta, f32, (C, Mpad), "beta")
    labels_in = arg(labels, i32, (C, Mpad), "labels")
    rho = arg(rho, i32, (n_rounds,), "rho")
    inner = arg(inner, i32, (nb, B), "inner_perm")
    p = arg(p, f32, (C, Mpad), "p")
    z = arg(z, f32, (C, Mpad), "z")
    pi = arg(pi, f32, (C, G, K), "pi")
    cva = arg(cva, f32, (G, K - 1), "cva")
    sigmaE = arg(sigmaE, f32, (C,), "sigmaE")
    sigmaGG = arg(sigmaGG, f32, (C, G), "sigmaGG")
    gas = arg(gas, i32, (Mpad,), "g_assign")
    valid = arg(valid, torch.bool, (Mpad,), "valid")
    eps_out = torch.empty((C, Npad), dtype=f32, device=dev)
    eps_out.copy_(arg(eps, f32, (C, Npad), "eps"))

    beta_out, labels_out, vpart, bpart = _chunk_outputs(
        beta_in, labels_in, nb, G, K, n_rounds < nr, C)
    partial = torch.empty((C * nsplit * (J * B + 1),), dtype=f32, device=dev)
    pind = _miss_partials(missing, C * nsplit * J * B, dev)
    dsc = torch.empty((C * J * B,), dtype=f32, device=dev)
    dms = torch.empty((C * J,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = mc.lib.jacobi_t_mc_sweep(
        C, words.data_ptr(), Nw, x_int8, nr, n_rounds, J, B, K, G,
        gram.data_ptr(), xsq.data_ptr(), _ptr(mean), _ptr(scale),
        eps_out.data_ptr(),
        _ptr(row_valid), beta_in.data_ptr(), labels_in.data_ptr(),
        beta_out.data_ptr(), labels_out.data_ptr(), rho.data_ptr(),
        inner.data_ptr(), p.data_ptr(), z.data_ptr(), pi.data_ptr(),
        cva.data_ptr(), sigmaE.data_ptr(), sigmaGG.data_ptr(),
        gas.data_ptr(), valid.data_ptr(), partial.data_ptr(), nsplit,
        dsc.data_ptr(), dms.data_ptr(), vpart.data_ptr(), bpart.data_ptr(),
        _ptr(pind), stream)
    mc.check(rc, "jacobi_t_mc_sweep launch")
    # bacc chain by chain: the single-chain wrapper's reduction of the same
    # (nb, G) partials, so a fused chain equals a single chain bitwise
    return MCSweepResult(eps_out, beta_out, labels_out, vpart.sum(dim=1),
                         torch.stack([b.sum(dim=0) for b in bpart]))


def bayesr_jacobi_t_mc_reference(XT_pad, gram, xsq_pad, eps, beta_pad,
                                 labels_pad, rho, inner_perm, p_arr, z_arr,
                                 pi, cva, sigmaE, sigmaGG, g_assign_pad,
                                 valid_pad, *, J: int, x_mean=None,
                                 x_scale=None, x_xsum=None,
                                 fold_affine: bool = False, row_valid=None,
                                 missing: bool = False) -> MCSweepResult:
    """The plain torch version of ``bayesr_jacobi_t_mc``: each round takes
    its J*B markers' rows once (``_round_x``), computes eps @ x.T for all
    chains (``missing``:
    ``_miss_round``'s dot) and runs the J x C blocks' sequential solves
    batched, with ``bayesr_jacobi_t_reference``'s algebra."""
    storage = _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing,
                          row_valid)
    f32 = torch.float32
    dev = XT_pad.device
    nb, B, _ = gram.shape
    nr = nb // J
    C, G, K = pi.shape
    sigmaE = torch.as_tensor(sigmaE, dtype=f32, device=dev)
    lp, invd, sd = bayesr_tables(xsq_pad, g_assign_pad, pi, cva, sigmaE,
                                 sigmaGG)
    xsq = xsq_pad.to(f32)
    okf = valid_pad.to(f32)
    gas = g_assign_pad.long()
    mean, scale, lane_ok = _plain_storage(storage, x_mean, x_scale,
                                          row_valid)
    eps = eps.to(f32).clone()
    beta = beta_pad.to(f32).clone()
    labels = labels_pad.to(torch.int32).clone()
    p_arr, z_arr = p_arr.to(f32), z_arr.to(f32)
    v = torch.zeros((C, G, K), dtype=f32, device=dev)
    bacc = torch.zeros((C, G), dtype=f32, device=dev)
    half_invsE = (0.5 / sigmaE)[:, None]                      # (C, 1)
    jj = torch.arange(J, device=dev)
    lanes = torch.arange(B, device=dev)
    kcol = torch.arange(K, device=dev)
    gram = gram.to(f32)
    inner_perm = inner_perm.long()
    for r in range(rho.shape[0]):
        s = rho[r].long()
        blk = jj * nr + s                                     # (J,)
        rows = (blk[:, None] * B + lanes).reshape(-1)         # (J*B,)
        if missing:
            dot, apply = _miss_round(XT_pad[rows], mean[rows], scale[rows],
                                     lane_ok)
            rr = dot(eps).view(C, J, B)
        else:
            x = _round_x(XT_pad, rows, mean, scale, lane_ok)  # (J*B, lanes)
            rr = (eps @ x.T).view(C, J, B)
        bold = beta[:, rows].view(C, J, B)
        inn = inner_perm[blk]                                 # (J, B)
        pos = ((s * J + jj)[:, None] * B + lanes).reshape(-1)
        p_r, z_r = p_arr[:, pos].view(C, J, B), z_arr[:, pos].view(C, J, B)
        d, krec = strided_steps(rr, gram[blk], bold, inn, blk, p_r, z_r,
                                lp, invd, sd, xsq, okf, half_invsE)
        bnew = bold + d
        beta[:, rows] = bnew.reshape(C, -1)
        labels[:, rows] = torch.where(krec >= 0, krec,
                                      labels[:, rows].view(C, J, B)
                                      ).reshape(C, -1)
        g_r = gas[rows].view(J, B)
        for g in range(G):
            in_g = g_r == g
            v[:, g] += ((krec[..., None] == kcol) & in_g[..., None]).sum(
                dim=(1, 2)).to(f32)
            bacc[:, g] += torch.where((krec > 0) & in_g, bnew * bnew,
                                      0.0).sum(dim=(1, 2))
        eps = (apply(d.reshape(C, -1), eps) if missing
               else eps - d.reshape(C, -1) @ x)
    return MCSweepResult(eps, beta, labels, v, bacc)


def horseshoe_jacobi_t_mc(XT_pad, gram, xsq_pad, eps, beta_pad, rho,
                          inner_perm, z_arr, lam, tau, c2, sigmaE, valid_pad,
                          *, J: int = 64, x_mean=None, x_scale=None,
                          x_xsum=None, fold_affine: bool = False,
                          row_valid=None, missing: bool = False):
    """One fused strided-rounds horseshoe sweep of C chains (pallas_jacobi_t
    .py:horseshoe_jacobi_t_pallas_mc and horseshoe_jacobi_t_pallas_mc8):
    eps (C, Npad), beta_pad, z_arr and lam (C, Mpad), tau, c2 and sigmaE
    (C,); the rest shared as in ``horseshoe_jacobi_t``.  Returns (eps,
    beta), each (C, ...).  On CUDA tensors it launches
    ``csrc/jacobi_t_mc.cu``'s horseshoe sweep (3 launches per round for each
    group of at most 16 chains, counted in ``horseshoe_jacobi_t_mc.launches``)
    or raises; on CPU tensors it runs ``horseshoe_jacobi_t_mc_reference``.
    """
    _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing, row_valid)
    if XT_pad.device.type == "cpu":
        return horseshoe_jacobi_t_mc_reference(
            XT_pad, gram, xsq_pad, eps, beta_pad, rho, inner_perm, z_arr,
            lam, tau, c2, sigmaE, valid_pad, J=J, x_mean=x_mean,
            x_scale=x_scale, fold_affine=fold_affine, row_valid=row_valid,
            missing=missing)
    if XT_pad.device.type != "cuda":
        raise NotImplementedError(
            f"no jacobi_t_mc kernel for device {XT_pad.device}")
    parts = [_hs_mc_sweep_cuda(XT_pad, gram, xsq_pad, eps[g], beta_pad[g],
                               rho, inner_perm, z_arr[g], lam[g], tau[g],
                               c2[g], sigmaE[g], valid_pad, J, x_mean,
                               x_scale, row_valid, missing)
             for g in _chain_groups(eps.shape[0])]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(f) for f in zip(*parts))


horseshoe_jacobi_t_mc.launches = 0


def _hs_mc_sweep_cuda(words, gram, xsq, eps, beta, rho, inner, z, lam, tau,
                      c2, sigmaE, valid, J, mean, scale, row_valid, missing):
    lib, mc = _mc_libs()
    dev = words.device
    Mpad, Nw, nb, B, nr = _round_plan(lib, words, gram, J)
    C = eps.shape[0]
    f32, i32 = torch.float32, torch.int32
    arg = _operands(dev)

    words, Nw, Npad, mean, scale, row_valid, nsplit, x_int8 = _storage_ops(
        lib, arg, words, mean, scale, row_valid)
    gram = arg(gram, f32, (nb, B, B), "gram")
    xsq = arg(xsq, f32, (Mpad,), "xsq")
    beta_in = arg(beta, f32, (C, Mpad), "beta")
    rho = arg(rho, i32, (nr,), "rho")
    inner = arg(inner, i32, (nb, B), "inner_perm")
    z = arg(z, f32, (C, Mpad), "z")
    lam = arg(lam, f32, (C, Mpad), "lam")
    tau = arg(tau, f32, (C,), "tau")
    c2 = arg(c2, f32, (C,), "c2")
    sigmaE = arg(sigmaE, f32, (C,), "sigmaE")
    valid = arg(valid, torch.bool, (Mpad,), "valid")
    eps_out = torch.empty((C, Npad), dtype=f32, device=dev)
    eps_out.copy_(arg(eps, f32, (C, Npad), "eps"))

    beta_out = torch.empty((C, Mpad), dtype=f32, device=dev)
    partial = torch.empty((C * nsplit * (J * B + 1),), dtype=f32, device=dev)
    pind = _miss_partials(missing, C * nsplit * J * B, dev)
    dsc = torch.empty((C * J * B,), dtype=f32, device=dev)
    dms = torch.empty((C * J,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = mc.lib.jacobi_t_hs_mc_sweep(
        C, words.data_ptr(), Nw, x_int8, nr, J, B, gram.data_ptr(),
        xsq.data_ptr(),
        _ptr(mean), _ptr(scale), eps_out.data_ptr(),
        _ptr(row_valid), beta_in.data_ptr(), beta_out.data_ptr(),
        rho.data_ptr(), inner.data_ptr(), z.data_ptr(), lam.data_ptr(),
        tau.data_ptr(), c2.data_ptr(), sigmaE.data_ptr(), valid.data_ptr(),
        partial.data_ptr(), nsplit, dsc.data_ptr(), dms.data_ptr(),
        _ptr(pind), stream)
    mc.check(rc, "jacobi_t_hs_mc_sweep launch")
    horseshoe_jacobi_t_mc.launches += LAUNCHES_PER_ROUND * nr
    return eps_out, beta_out


def horseshoe_jacobi_t_mc_reference(XT_pad, gram, xsq_pad, eps, beta_pad,
                                    rho, inner_perm, z_arr, lam, tau, c2,
                                    sigmaE, valid_pad, *, J: int,
                                    x_mean=None, x_scale=None, x_xsum=None,
                                    fold_affine: bool = False,
                                    row_valid=None, missing: bool = False):
    """The plain torch version of ``horseshoe_jacobi_t_mc``: each round
    takes its J*B markers' rows once (``_round_x``; ``missing``:
    ``_miss_round``) and runs the
    J x C blocks' sequential solves batched, with
    ``horseshoe_jacobi_t_reference``'s algebra."""
    storage = _check_mode(XT_pad, gram, J, x_mean, fold_affine, missing,
                          row_valid)
    f32 = torch.float32
    dev = XT_pad.device
    nb, B, _ = gram.shape
    nr = nb // J
    C = eps.shape[0]
    invd, sd = _hs_tables(xsq_pad, lam, tau, c2, sigmaE)     # (C, Mpad)
    xsq = xsq_pad.to(f32)
    okf = valid_pad.to(f32)
    mean, scale, lane_ok = _plain_storage(storage, x_mean, x_scale,
                                          row_valid)
    eps = eps.to(f32).clone()
    beta = beta_pad.to(f32).clone()
    z_arr = z_arr.to(f32)
    jj = torch.arange(J, device=dev)
    lanes = torch.arange(B, device=dev)
    gram = gram.to(f32)
    inner_perm = inner_perm.long()
    for r in range(nr):
        s = rho[r].long()
        blk = jj * nr + s                                     # (J,)
        rows = (blk[:, None] * B + lanes).reshape(-1)         # (J*B,)
        if missing:
            dot, apply = _miss_round(XT_pad[rows], mean[rows], scale[rows],
                                     lane_ok)
            rr = dot(eps).view(C, J, B)
        else:
            x = _round_x(XT_pad, rows, mean, scale, lane_ok)  # (J*B, lanes)
            rr = (eps @ x.T).view(C, J, B)
        bold = beta[:, rows].view(C, J, B)
        inn = inner_perm[blk]                                 # (J, B)
        pos = ((s * J + jj)[:, None] * B + lanes).reshape(-1)
        z_r = z_arr[:, pos].view(C, J, B)
        G_r = gram[blk]                                       # (J, B, B)
        d = torch.zeros((C, J, B), dtype=f32, device=dev)
        for t in range(B):
            m = inn[:, t]                                     # (J,)
            mg = blk * B + m                                  # markers
            b_old = bold[:, jj, m]                            # (C, J)
            num = rr[:, jj, m] + b_old * xsq[mg]
            beta_new = num * invd[:, mg] + sd[:, mg] * z_r[..., t]
            dd = okf[mg] * (beta_new - b_old)
            rr = rr - G_r[jj, m, :] * dd[..., None]
            d[:, jj, m] = dd
        beta[:, rows] = (bold + d).reshape(C, -1)
        eps = (apply(d.reshape(C, -1), eps) if missing
               else eps - d.reshape(C, -1) @ x)
    return eps, beta
