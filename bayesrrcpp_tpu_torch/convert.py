"""Carry sampler state and data across from the JAX package.

Both take NumPy arrays (``np.asarray`` of the JAX leaves), so this module
needs no JAX.  Layout is free between the two packages, semantics are not:

- the JAX packed path stores eps/Y in a plane-major individual permutation
  (``genotypes.lane_perm``); the port keeps natural individual order, so
  eps is un-permuted here;
- packed words keep ``pack_codes_host``'s format (individual 16w+k at bits
  2k of word w) in both packages and pass through unchanged;
- beta and labels keep the JAX Mpad, since both packages choose the same
  plan; the PRNG key is dropped (the port's randomness lives in the
  variates object passed to each step).
"""
from __future__ import annotations

import numpy as np
import torch

from .models.bayesr import MarkerData
from .models.state import SpikeSlabState
from .ops import genotypes


def _t(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def unpermute_eps(eps_packed, Npad) -> np.ndarray:
    """JAX packed-order eps (Npad,) -> individual order (Npad,)."""
    out = np.zeros(Npad, np.asarray(eps_packed).dtype)
    out[genotypes.lane_perm(Npad)] = np.asarray(eps_packed)
    return out


def state_from_jax(state: dict, sampler) -> SpikeSlabState:
    """The port's state from a JAX ``SpikeSlabState`` given as a dict of
    NumPy arrays (e.g. ``{k: np.asarray(v) for k, v in
    jax_state._asdict().items()}``)."""
    dev = sampler.device
    if tuple(np.shape(state["beta"])) != (sampler.Mpad,):
        raise ValueError(f"beta has shape {np.shape(state['beta'])}; the "
                         f"sampler plans Mpad={sampler.Mpad}")
    eps = np.asarray(state["eps"])
    if sampler.x_packed:
        eps = unpermute_eps(eps, sampler.Npad)
    return SpikeSlabState(
        iteration=int(state["iteration"]),
        mu=_t(state["mu"], dev),
        beta=_t(state["beta"], dev),
        labels=_t(state["labels"], dev, torch.int32),
        eps=_t(eps, dev),
        sigmaE=_t(state["sigmaE"], dev),
        sigmaGG=_t(state["sigmaGG"], dev),
        pi=_t(state["pi"], dev),
        alpha=_t(state["alpha"], dev),
        sigmaF=_t(state["sigmaF"], dev))


def data_from_jax(data: dict, *, N: int, device) -> MarkerData:
    """The port's packed ``MarkerData`` from a JAX packed ``MarkerData``
    given as a dict of NumPy arrays (words, xsq, Gram, mean, scale and
    column sums pass through; row_valid is rebuilt in individual order)."""
    words = np.asarray(data["XT"])
    if words.dtype != np.int32:
        raise NotImplementedError(
            "only 2-bit packed data carries across (dense and int8 storage: "
            "ROADMAP Queue 1 item 7)")
    Npad = words.shape[1] * genotypes.WORDS
    return MarkerData(
        XT=torch.as_tensor(words, device=device),
        xsq=_t(data["xsq"], device),
        gram=_t(data["gram"], device),
        g_assign=_t(data["g_assign"], device, torch.int32),
        valid=_t(data["valid"], device, torch.bool),
        cva=_t(data["cva"], device),
        prior_pi=_t(data["prior_pi"], device),
        x_mean=_t(data["x_mean"], device),
        x_scale=_t(data["x_scale"], device),
        row_valid=torch.arange(Npad, device=device) < N,
        x_colsum=_t(data["x_colsum"], device))
