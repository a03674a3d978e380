"""Carry sampler state and data across from the JAX package.

Both take NumPy arrays (``np.asarray`` of the JAX leaves), so this module
needs no JAX.  Layout is free between the two packages, semantics are not:

- the JAX packed path stores eps/Y in a plane-major individual permutation
  (``genotypes.lane_perm``); the port keeps natural individual order, so
  eps is un-permuted here;
- dense f32 data (XT (Mpad, N), xsq, Gram blocks, valid) carries across as
  it is, individuals in natural order; its empty mean, scale, column sums,
  row_valid and n_perm are not carried;
- packed words keep ``pack_codes_host``'s format (individual 16w+k at bits
  2k of word w) in both packages and pass through unchanged, missing calls
  and the pad codes with them (code 3 on the pad lanes and -1 pad markers
  when the data has missing calls); whether it has is read off the words
  (``has_missing_calls``), since the JAX data does not carry it;
- int8 codes (XT (Mpad, N), pad markers code 3) carry across as they are,
  individuals in natural order, with their mean, scale and column sums;
  whether they hold a missing call is read off the real markers' codes;
- the fixed-effect columns ``fixedT`` (F, Npad) and their squared norms
  ``fsq`` carry across with ``g_assign``, un-permuted like eps for words
  (and cut to the rank's individuals on an "n" axis);
- beta, labels, lambda and v keep the JAX Mpad, since both packages
  choose the same plan; the PRNG key is dropped (the port's randomness
  lives in the variates object passed to each step);
- a chain-batched JAX state (``jax.vmap(init)``, ``step_chains``) carries
  across with its leading chain axis on every tensor and one host
  iteration count;
- a JAX ``ShardedSpikeSlabSampler``'s or ``ShardedHorseshoeSampler``'s
  global data and state carry into rank (m, n)'s port sampler as their
  marker slice m and, for dense X and eps, individual slice n
  (``sharded_data_from_jax``, ``sharded_state_from_jax`` and their
  ``sharded_horseshoe_*`` forms), through the same functions.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.bayesr import MarkerData
from .models.horseshoe import HorseshoeData
from .models.state import HorseshoeState, SpikeSlabState
from .ops import genotypes


def _t(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def unpermute_eps(eps_packed, Npad) -> np.ndarray:
    """JAX packed-order eps (..., Npad) -> individual order (..., Npad)."""
    eps_packed = np.asarray(eps_packed)
    out = np.zeros(eps_packed.shape[:-1] + (Npad,), eps_packed.dtype)
    out[..., genotypes.lane_perm(Npad)] = eps_packed
    return out


def _eps_from_jax(state: dict, sampler) -> np.ndarray:
    if np.shape(state["beta"])[-1:] != (sampler.Mpad,):
        raise ValueError(f"beta has shape {np.shape(state['beta'])}; the "
                         f"sampler plans Mpad={sampler.Mpad}")
    eps = np.asarray(state["eps"])
    if sampler.x_packed:
        eps = unpermute_eps(eps, sampler.Npad)
    return eps


def _iteration(state: dict) -> int:
    """The one iteration count of a (chain-batched) JAX state."""
    its = np.unique(np.asarray(state["iteration"]))
    if its.size != 1:
        raise ValueError(f"chains at different iterations: {its}")
    return int(its[0])


def state_from_jax(state: dict, sampler) -> SpikeSlabState:
    """The port's state from a JAX ``SpikeSlabState`` given as a dict of
    NumPy arrays (e.g. ``{k: np.asarray(v) for k, v in
    jax_state._asdict().items()}``), one chain or chain-batched."""
    dev, dt = sampler.device, sampler.dtype
    eps = _eps_from_jax(state, sampler)
    return SpikeSlabState(
        iteration=_iteration(state),
        mu=_t(state["mu"], dev, dt),
        beta=_t(state["beta"], dev, dt),
        labels=_t(state["labels"], dev, torch.int32),
        eps=_t(eps, dev, dt),
        sigmaE=_t(state["sigmaE"], dev, dt),
        sigmaGG=_t(state["sigmaGG"], dev, dt),
        pi=_t(state["pi"], dev, dt),
        alpha=_t(state["alpha"], dev, dt),
        sigmaF=_t(state["sigmaF"], dev, dt))


def horseshoe_state_from_jax(state: dict, sampler) -> HorseshoeState:
    """The port's state from a JAX ``HorseshoeState`` given as a dict of
    NumPy arrays (as ``state_from_jax``), one chain or chain-batched."""
    dev, dt = sampler.device, sampler.dtype
    eps = _eps_from_jax(state, sampler)
    return HorseshoeState(
        iteration=_iteration(state),
        eps=_t(eps, dev, dt),
        **{k: _t(state[k], dev, dt)
           for k in ("mu", "beta", "sigmaE", "lam", "v", "tau", "eta",
                     "c2")})


def has_missing_calls(words, N: int, valid) -> bool:
    """Whether packed ``words`` (Mpad, Npad/16) hold a missing call (code
    3) of a real individual (n < N) at a real marker (``valid``), as the
    JAX package's ``has_missing`` counts them (bayesrrcpp_tpu/ops/
    genotypes.py:259-262)."""
    words = np.asarray(words)[np.asarray(valid, bool)]
    miss = words & (words >> 1) & 0x55555555       # bit 2k: field k is 3
    nw = words.shape[1]
    lanes = (genotypes.WORDS * np.arange(nw)[:, None]
             + np.arange(genotypes.WORDS)[None, :])              # (nw, 16)
    real = np.where(lanes < N, 1 << (2 * np.arange(genotypes.WORDS)),
                    0).sum(axis=1).astype(np.int64)              # (nw,)
    return bool(np.any(miss.astype(np.int64) & real[None, :]))


def horseshoe_data_from_jax(data: dict, *, N: int, device,
                            dtype=torch.float32) -> HorseshoeData:
    """The port's ``HorseshoeData`` from a JAX dense, int8 or packed
    ``HorseshoeData`` given as a dict of NumPy arrays (as
    ``data_from_jax``; the JAX lane permutation n_perm is dropped); dense
    rows, xsq and Gram blocks in ``dtype``, the sampler's."""
    words = np.asarray(data["XT"])
    if np.issubdtype(words.dtype, np.floating):
        empty = torch.zeros((0,), dtype=torch.float32, device=device)
        return HorseshoeData(
            XT=_t(words, device, dtype), xsq=_t(data["xsq"], device, dtype),
            gram=_t(data["gram"], device, dtype),
            valid=_t(data["valid"], device, torch.bool),
            x_mean=empty, x_scale=empty, x_colsum=empty,
            row_valid=torch.zeros((0,), dtype=torch.bool, device=device))
    if words.dtype == np.int8:
        # int8 codes: individuals in their own order, no lane mask
        return HorseshoeData(
            XT=torch.as_tensor(words, device=device),
            xsq=_t(data["xsq"], device), gram=_t(data["gram"], device),
            valid=_t(data["valid"], device, torch.bool),
            x_mean=_t(data["x_mean"], device),
            x_scale=_t(data["x_scale"], device),
            row_valid=torch.zeros((0,), dtype=torch.bool, device=device),
            x_colsum=_t(data["x_colsum"], device),
            has_missing=bool(np.any(
                words[np.asarray(data["valid"], bool)]
                == genotypes.MISSING_CODE)))
    if words.dtype != np.int32:
        raise ValueError(f"unknown genotype storage {words.dtype}")
    Npad = words.shape[1] * genotypes.WORDS
    return HorseshoeData(
        XT=torch.as_tensor(words, device=device),
        xsq=_t(data["xsq"], device),
        gram=_t(data["gram"], device),
        valid=_t(data["valid"], device, torch.bool),
        x_mean=_t(data["x_mean"], device),
        x_scale=_t(data["x_scale"], device),
        row_valid=torch.arange(Npad, device=device) < N,
        x_colsum=_t(data["x_colsum"], device),
        has_missing=has_missing_calls(words, N, data["valid"]))


def data_from_jax(data: dict, *, N: int, device,
                  dtype=torch.float32) -> MarkerData:
    """The port's ``MarkerData`` from a JAX dense, int8 or packed
    ``MarkerData`` given as a dict of NumPy arrays (dense rows, or int8
    codes or words with their mean, scale and column sums, pass through
    with xsq and the Gram blocks; has_missing is read off the real markers'
    codes or words, and for words row_valid is rebuilt in individual
    order); dense rows and the prior and fixed-effect fields in ``dtype``,
    the sampler's."""
    geno = horseshoe_data_from_jax(data, N=N, device=device, dtype=dtype)
    packed = np.asarray(data["XT"]).dtype == np.int32
    lanes = geno.row_valid.numel() if packed else geno.XT.shape[1]
    # (a data dict without fixed effects: F=0)
    fixedT = np.asarray(data.get("fixedT", np.zeros((0, lanes))))
    if packed:
        # the packed layout's individuals back in natural order
        fixedT = unpermute_eps(fixedT, fixedT.shape[-1])
    return MarkerData(
        **geno._asdict(),
        g_assign=_t(data["g_assign"], device, torch.int32),
        cva=_t(data["cva"], device, dtype),
        prior_pi=_t(data["prior_pi"], device, dtype),
        fixedT=_t(fixedT, device, dtype),
        fsq=_t(data.get("fsq", np.zeros((0,))), device, dtype))


_MARKER_FIELDS = ("XT", "xsq", "g_assign", "valid", "x_mean", "x_scale",
                  "x_colsum")


def _slice_data(data: dict, *, Dm: int, m_index: int, Dn: int,
                n_index: int) -> dict:
    """Slice (m_index, n_index) of a JAX sharded sampler's global data: the
    marker fields' rows and the Gram blocks of m-slice m_index, and dense
    X's columns of n-slice n_index."""
    mpad = np.shape(data["XT"])[0]
    lo, hi = m_index * mpad // Dm, (m_index + 1) * mpad // Dm
    nb = np.shape(data["gram"])[0]
    part = dict(data)
    for k in _MARKER_FIELDS:
        if k in data and np.size(data[k]):
            part[k] = np.asarray(data[k])[lo:hi]
    part["gram"] = np.asarray(data["gram"])[m_index * nb // Dm:
                                            (m_index + 1) * nb // Dm]
    if Dn > 1:
        nloc = np.shape(data["XT"])[1] // Dn
        part["XT"] = part["XT"][:, n_index * nloc:(n_index + 1) * nloc]
        if "fixedT" in data:
            part["fixedT"] = np.asarray(data["fixedT"])[
                :, n_index * nloc:(n_index + 1) * nloc]
    return part


def _any_missing(data: dict, N: int) -> bool:
    """Whether the real markers of a JAX sampler's words or int8 codes hold
    a missing call, as every rank of the port agrees on it."""
    words = np.asarray(data["XT"])
    if words.dtype == np.int32:
        return has_missing_calls(words, N, data["valid"])
    return bool(np.any(words[np.asarray(data["valid"], bool)]
                       == genotypes.MISSING_CODE))


def sharded_data_from_jax(data: dict, *, N: int, Dm: int, m_index: int,
                          device, Dn: int = 1, n_index: int = 0,
                          dtype=torch.float32) -> MarkerData:
    """Slice (m_index, n_index) of a (Dm, Dn) JAX ``ShardedMarkerData``
    given as a dict of NumPy arrays of its global arrays, as the port's
    ``MarkerData`` of that rank (``data_from_jax`` on the slice's rows,
    Gram blocks and, for dense X, columns).  Whether the words hold
    missing calls is read off all of them, as every rank of the port
    agrees on it."""
    out = data_from_jax(_slice_data(data, Dm=Dm, m_index=m_index, Dn=Dn,
                                    n_index=n_index), N=N, device=device,
                        dtype=dtype)
    return out._replace(has_missing=_any_missing(data, N))


def sharded_horseshoe_data_from_jax(data: dict, *, N: int, Dm: int,
                                    m_index: int, device, Dn: int = 1,
                                    n_index: int = 0,
                                    dtype=torch.float32) -> HorseshoeData:
    """``sharded_data_from_jax`` for a JAX ``ShardedHorseshoeSampler``'s
    data dict."""
    out = horseshoe_data_from_jax(
        _slice_data(data, Dm=Dm, m_index=m_index, Dn=Dn, n_index=n_index),
        N=N, device=device, dtype=dtype)
    return out._replace(has_missing=_any_missing(data, N))


def _slice_state(full, sampler, marker_fields):
    lo, hi = sampler.marker_range
    n0, n1 = sampler.n_range
    return full.replace(
        eps=full.eps[..., n0:n1].contiguous(),
        **{k: getattr(full, k)[..., lo:hi].contiguous()
           for k in marker_fields})


def sharded_state_from_jax(state: dict, sampler) -> SpikeSlabState:
    """Rank (m, n)'s port state from a JAX sharded sampler's global state
    (``state_from_jax``, then the slice's beta and labels and eps),
    one chain or chain-batched."""
    return _slice_state(state_from_jax(state, sampler), sampler,
                        ("beta", "labels"))


def sharded_horseshoe_state_from_jax(state: dict, sampler) -> HorseshoeState:
    """Rank (m, n)'s port state from a JAX ``ShardedHorseshoeSampler``'s
    global state: the slice's beta, lambda, v and eps."""
    return _slice_state(horseshoe_state_from_jax(state, sampler), sampler,
                        ("beta", "lam", "v"))
