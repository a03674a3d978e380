"""Resume a chain from a sample CSV's last row.

Counterpart of ``bayesrrcpp_tpu/io/resume.py`` (a copy: the port imports
nothing of the JAX package).  The reference's resume workflow is this:
the user takes the final CSV row of a previous run and passes
mu/beta/sigmaE/sigmaGG/epsilon/components back to BRV2Grstart (reference:
src/BRv2Grstart.cpp:55-77).  This module parses any of the four reference
schemas (written by ``io.sink.CSVSink``) and returns the state fields for
``SpikeSlabSampler.init_from`` or ``HorseshoeSampler.init_from``.

Prefer checkpoints (``io/checkpoint.py``) for an exact resume: a CSV row
has no generator state and, written with ``emit_epsilon=False``, no
residuals; ``epsilon`` is then rebuilt from (X, Y), or for quantized
storage through the sampler's ``xbeta``.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np

_VEC = re.compile(r"^([a-zA-Z]+)\[(\d+)\]$")


def parse_last_row(path: str) -> Dict[str, np.ndarray]:
    """Parse the header + last data row of a sample CSV into named arrays.

    Vector fields (``beta[1..M]``, ``comp``, ``sigmaG``, ``epsilon``,
    ``alpha``, ``lambda``) come back as 1-D arrays in index order; scalar
    fields (``iteration``, ``mu``, ``sigmaE``, ``sigmaF``, ``tau``) as 0-D.
    """
    with open(path, "rb") as f:
        header = f.readline().decode().strip()
        # stream to the last non-empty line without loading the whole file
        last = b""
        for line in f:
            if line.strip():
                last = line
    if not last:
        raise ValueError(f"{path}: no sample rows to resume from")
    names = [c.strip() for c in header.split(",") if c.strip()]
    values = [float(v) for v in last.decode().strip().split(",")]
    if len(values) != len(names):
        raise ValueError(f"{path}: row has {len(values)} fields, header "
                         f"names {len(names)} columns")
    scalars: Dict[str, float] = {}
    vectors: Dict[str, Dict[int, float]] = {}
    for name, v in zip(names, values):
        m = _VEC.match(name)
        if m:
            vectors.setdefault(m.group(1), {})[int(m.group(2))] = v
        else:
            scalars[name] = v
    out: Dict[str, np.ndarray] = {k: np.asarray(v) for k, v in scalars.items()}
    for k, d in vectors.items():
        n = max(d) if d else 0
        if len(d) != n:
            # a foreign/hand-edited CSV with a gap in the vector indices
            # would otherwise leak uninitialised entries into the state
            raise ValueError(
                f"{path}: column group {k!r} has {len(d)} entries but max "
                f"index {n}; vector indices must be contiguous 1..{n}")
        arr = np.full(n, np.nan)
        for i, v in d.items():
            arr[i - 1] = v  # reference headers are 1-indexed
        out[k] = arr
    return out


def csv_schema(path: str) -> str:
    """Classify a sample CSV by its header: 'mixture' (C1/C2/C3 schemas) or
    'horseshoe' (C4 schema, src/HorseshoeR.cpp:279-291)."""
    with open(path, "rb") as f:
        header = f.readline().decode()
    names = {c.strip().split("[")[0] for c in header.split(",") if c.strip()}
    if "comp" in names:
        return "mixture"
    if "lambda" in names and "tau" in names:
        return "horseshoe"
    raise ValueError(f"{path}: unrecognized sample-CSV header")


def _reconstruct_epsilon(path, row, kwargs, X, Y, fixed, xbeta,
                         has_alpha: bool):
    """Shared residual reconstruction for CSVs written with
    emit_epsilon=False: epsilon = Y - mu - X beta [- fixed alpha]."""
    if Y is None or (X is None and xbeta is None):
        raise ValueError(
            f"{path} has no epsilon columns; pass X and Y (or a "
            "quantized-storage sampler's xbeta) so the residuals can be "
            "reconstructed")
    if has_alpha and fixed is None:
        # silently dropping the fixed-effect term would corrupt the
        # residuals (the sampler would then converge to a wrong posterior)
        raise ValueError(
            f"{path} carries fixed-effect alpha columns but no fixed-effect "
            "matrix was supplied; pass fixed= (CLI: --fixed) or resume from "
            "a CSV that includes epsilon columns")
    if X is None:
        xb = xbeta(row["beta"])
        if hasattr(xb, "cpu"):              # a sampler's xbeta: a tensor
            xb = xb.cpu().numpy()
        xb = np.asarray(xb, np.float64)
    else:
        xb = np.asarray(X, np.float64) @ row["beta"]
    eps = np.asarray(Y, np.float64) - float(kwargs["mu"]) - xb
    if has_alpha:
        eps = eps - np.asarray(fixed, np.float64) @ row["alpha"]
    return eps


def state_kwargs_from_csv(path: str, *, X=None, Y=None,
                          fixed=None, xbeta=None) -> Dict[str, np.ndarray]:
    """Turn a CSV last row into ``SpikeSlabSampler.init_from`` kwargs.

    If the CSV was written without residuals (emit_epsilon=False), epsilon
    is reconstructed as ``Y - mu - X beta [- fixed alpha]`` from the
    provided standardized X and Y; for quantized genotype storage pass
    ``xbeta`` (e.g. ``SpikeSlabSampler.xbeta``, which takes the (M,) beta), a callable computing
    ``X @ beta`` from the on-device container, instead of a dense X.
    A CSV carrying alpha columns can only be resumed with the matching
    ``fixed`` matrix (otherwise the restored state would silently omit
    the fixed-effect term from the residuals).
    """
    row = parse_last_row(path)
    if "comp" not in row or "beta" not in row:
        raise ValueError(f"{path}: not a mixture-sampler CSV (no comp/beta "
                         "columns); use horseshoe_kwargs_from_csv")
    sigmaGG = row.get("sigmaG", np.asarray([np.nan]))
    kwargs = dict(
        mu=row["mu"],
        beta=row["beta"],
        sigmaE=row["sigmaE"],
        sigmaGG=np.atleast_1d(sigmaGG),
        components=row["comp"].astype(np.int32),
    )
    has_alpha = bool("alpha" in row and row["alpha"].size)
    if has_alpha:
        if fixed is None:
            raise ValueError(
                f"{path} carries fixed-effect alpha columns; pass the fixed "
                "covariate matrix (CLI: --fixed) so the resumed sampler has "
                "a matching F > 0")
        if np.asarray(fixed).shape[1] != row["alpha"].size:
            raise ValueError(
                f"{path}: {row['alpha'].size} alpha columns but fixed has "
                f"{np.asarray(fixed).shape[1]} columns")
        kwargs["alpha"] = row["alpha"]
    if "sigmaF" in row:
        kwargs["sigmaF"] = row["sigmaF"]
    eps: Optional[np.ndarray] = row.get("epsilon")
    if eps is None or eps.size == 0:
        eps = _reconstruct_epsilon(path, row, kwargs, X, Y, fixed, xbeta,
                                   has_alpha)
    kwargs["epsilon"] = eps
    return kwargs


def horseshoe_kwargs_from_csv(path: str, *, X=None, Y=None,
                              xbeta=None) -> Dict[str, np.ndarray]:
    """Turn a horseshoe sample CSV's last row into
    ``HorseshoeSampler.init_from`` kwargs.

    The C4 schema (iteration, mu, beta, sigmaE, tau, lambda, epsilon --
    src/HorseshoeR.cpp:258) carries everything except the auxiliaries
    (eta, v) and the slab width c2, which init_from re-draws from their
    full conditionals given (tau, lambda, beta) -- a same-spirit warm
    restart mirroring BRV2Grstart's pi re-draw (src/BRv2Grstart.cpp:157-165).
    The reference itself has NO horseshoe restart path at all.
    """
    row = parse_last_row(path)
    if "lambda" not in row or "tau" not in row:
        raise ValueError(f"{path}: not a horseshoe CSV (no lambda/tau "
                         "columns); use state_kwargs_from_csv")
    kwargs = dict(
        mu=row["mu"],
        beta=row["beta"],
        sigmaE=row["sigmaE"],
        tau=row["tau"],
        lam=row["lambda"],
    )
    eps: Optional[np.ndarray] = row.get("epsilon")
    if eps is None or eps.size == 0:
        eps = _reconstruct_epsilon(path, row, kwargs, X, Y, None, xbeta,
                                   has_alpha=False)
    kwargs["epsilon"] = eps
    return kwargs
