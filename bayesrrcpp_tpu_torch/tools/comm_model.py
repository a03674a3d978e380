"""Collectives of the sharded samplers: how many ``torch.distributed``
all-reduces one Gibbs iteration makes on each mesh axis, and their
payload bytes (counterpart of tools/comm_model.py, without its TPU
interconnect projection).

``analytic_model`` derives the counts from the shapes and the mesh alone,
for the port's own code paths (``parallel/sharded.py``):

- the (m, 1) kernels: the strided-rounds sweep in chunks of rounds, or
  the serial sweep in chunks of ``chunk_blocks`` blocks, one all-reduce
  of eps over "m" after each chunk (a whole sweep is one chunk at Dm = 1);
  fused chains all-reduce their (C, Npad) eps in one call;
- the split sweep (the kernels on Dn > 1): per round of J blocks one
  all-reduce of r (J*B floats) over "n" and one of eps's update (Nloc
  floats) over "m";
- ``backend="xla"``: the same two per block (B floats over "n");
- the hyperparameters: the counts (G, K) and the slab sum of squares
  (sum(beta^2), or ``bacc`` per group in the groups variant) over "m";
  the intercept's and sigmaE's sums of eps and each fixed effect's dot
  over "n".

An axis of one rank has no group and makes no call (``parallel/mesh.py``):
"m" has one unless Dm = 1 < Dn (the one-rank mesh of an initialized group
keeps the world group there, so its calls are made), "n" where Dn > 1.

Payload bytes are those of a float32 state.

``count_step`` counts the calls that one step really makes, by wrapping
``torch.distributed.all_reduce`` in the calling process for the length of
the step; ``validate`` runs each of ``CASES`` on four spawned gloo ranks
on the CPU and holds every rank's count to the model: tools/comm_model.py's
three ((Dm, Dn) = (4, 1) through the (m, 1) serial chunks, (2, 2) through
``backend="xla"``, 4 fused chains at Dm = 4 on the strided rounds), then
the split sweep on (2, 2) in two rounds of blocks, and the groups variant
with fixed effects on (2, 2) (the split sweep in one round).

Where the JAX model (tools/comm_model.py:30) reads otherwise for the same
arguments:
- eps bytes: JAX pads N to a multiple of 2,048 on its Pallas path (:41);
  the port's dense eps is N (Nloc on Dn > 1) long, its 2-bit eps Npad;
- the xla body's r bytes: JAX counts chunk_blocks * B floats; the body
  all-reduces one block's B (JAX's own sharded.py:596 too);
- the hyperparameters: JAX counts 6 all-reduce sites in its compiled
  step, over trivial axes too; the port calls only over axes with a group
  and sums ``bacc`` (not v and bacc both) only in the groups variant.

Run on the CPU (four gloo ranks):
    python -m bayesrrcpp_tpu_torch.tools.comm_model
prints each case's model, its count and whether they match.
"""
from __future__ import annotations

import contextlib
import json
import pickle
import sys
from typing import NamedTuple, Optional

AXES = ("m", "n")


def _largest_divisor(n, at_most):
    d = max(1, min(at_most, n))
    while n % d:
        d -= 1
    return d


def analytic_model(*, N, M, B, Dm, Dn, chunk_blocks=None, backend="pallas",
                   x_dtype="dense", chains=None, G=1, K=4, F=0,
                   variant="bayesr"):
    """All-reduces of one iteration of ``ShardedSpikeSlabSampler.step`` (or
    ``step_chains`` of ``chains``) on a (Dm, Dn) mesh, for G groups of K
    mixture components and F fixed effects: calls and payload bytes on
    each axis, the sweep's and the hyperparameters' apart."""
    from ..parallel.sharded import slice_plan

    split = backend == "pallas" and Dn > 1
    J, B, Mpad, Npad = slice_plan(M, N, B, Dm, Dn,
                                  strided=backend == "pallas" and not split,
                                  packed=x_dtype == "2bit")
    nb_loc, Nloc = Mpad // Dm // B, Npad // Dn
    path = ("xla" if backend != "pallas" else "split" if split
            else "strided" if J > 1 else "serial")
    C = chains or 1
    if path == "strided":
        nr = nb_loc // J
        nrc = nr if Dm == 1 else _largest_divisor(
            nr, -(-min(chunk_blocks or 128, nb_loc) // J))
        rounds = nr // nrc
        sweep = {"m": (rounds, C * Npad), "n": (0, 0)}
    elif path == "serial":
        rounds = -(-nb_loc // min(chunk_blocks or 128, nb_loc))
        sweep = {"m": (rounds, C * Npad), "n": (0, 0)}
    elif path == "split":
        Js = _largest_divisor(nb_loc, chunk_blocks or 8)
        rounds = nb_loc // Js
        sweep = {"m": (rounds, Nloc), "n": (rounds, Js * B)}
    else:
        rounds = nb_loc
        sweep = {"m": (rounds, Nloc), "n": (rounds, B)}
    ss = G if variant == "groups" else 1
    hyper = {"m": [C * G * K, C * ss],         # counts, slab sum of squares
             "n": [C, C] + [C] * F}            # mu, sigmaE, fixed effects
    live = {"m": Dn == 1 or Dm > 1, "n": Dn > 1}
    calls, nbytes = {}, {}
    for ax in AXES:
        n_sweep, floats = sweep[ax] if live[ax] else (0, 0)
        h = hyper[ax] if live[ax] else []
        calls[ax] = n_sweep + len(h)
        nbytes[ax] = (n_sweep * floats + sum(h)) * 4
    return {"mesh": [Dm, Dn], "path": path,
            "plan": {"J": J, "B": B, "Mpad": Mpad, "nb_loc": nb_loc,
                     "Npad": Npad, "Nloc": Nloc},
            "rounds_per_iter": int(rounds),
            "sweep_calls": {ax: sweep[ax][0] if live[ax] else 0
                            for ax in AXES},
            "hyper_calls": {ax: len(hyper[ax]) if live[ax] else 0
                            for ax in AXES},
            "calls": calls, "bytes": nbytes}


@contextlib.contextmanager
def counted_all_reduces(mesh):
    """Count the ``torch.distributed.all_reduce`` calls of this process
    while the context is open, by axis of ``mesh`` ("m", "n", or "other"
    for a group of neither): {axis: {"calls": n, "bytes": b}}."""
    import torch.distributed as dist

    counts = {ax: {"calls": 0, "bytes": 0} for ax in AXES + ("other",)}
    real = dist.all_reduce

    def counting(tensor, *args, **kwargs):
        group = kwargs.get("group", args[1] if len(args) > 1 else None)
        ax = ("m" if group is mesh.group and group is not None
              else "n" if group is mesh.n_group and group is not None
              else "other")
        counts[ax]["calls"] += 1
        counts[ax]["bytes"] += tensor.numel() * tensor.element_size()
        return real(tensor, *args, **kwargs)

    dist.all_reduce = counting
    try:
        yield counts
    finally:
        dist.all_reduce = real


def count_step(sampler, state, rng):
    """(counts, next state) of one step of ``sampler`` (fused when the
    state has a chain axis) from ``state``."""
    fused = state.beta.dim() > 1
    with counted_all_reduces(sampler.mesh) as counts:
        state = (sampler.step_chains(state, rng) if fused
                 else sampler.step(state, rng))
    return counts, state


class Case(NamedTuple):
    name: str
    mesh: tuple
    backend: str
    N: int
    M: int
    B: int
    chunk_blocks: Optional[int]
    chains: Optional[int]
    groups: Optional[tuple] = None      # (G, F, K): groups variant


# tools/comm_model.py's cases (hlo_collective_count(4, 1), (2, 2);
# hlo_collective_count_mc(4)), then the split sweep and the groups variant
JAX_CASES = (Case("m4", (4, 1), "pallas", 512, 512, 32, 4, None),
             Case("m2n2", (2, 2), "xla", 512, 512, 32, 4, None),
             Case("m4_mc4", (4, 1), "pallas", 512, 8192, 32, None, 4))
CASES = JAX_CASES + (
    Case("m2n2_split", (2, 2), "pallas", 512, 512, 32, 4, None),
    Case("m2n2_groups", (2, 2), "pallas", 512, 512, 32, None, None,
         (2, 2, 5)))
CVA = (0.001, 0.01, 0.1)


def case_model(case: Case) -> dict:
    """``analytic_model`` at ``case``'s arguments."""
    G, F, K = case.groups or (1, 0, len(CVA) + 1)
    return analytic_model(
        N=case.N, M=case.M, B=case.B, Dm=case.mesh[0], Dn=case.mesh[1],
        chunk_blocks=case.chunk_blocks, backend=case.backend,
        chains=case.chains, G=G, K=K, F=F,
        variant="groups" if case.groups else "bayesr")


def _case_counts(case: Case, device):
    """One step of ``case`` on this rank: (counts, sampler layout)."""
    import numpy as np
    import torch

    from ..config import BayesRConfig, GroupsConfig
    from ..parallel import ShardedSpikeSlabSampler, make_mesh

    rng = np.random.default_rng(0)
    X = rng.standard_normal((case.N, case.M)).astype(np.float32)
    Y = rng.standard_normal(case.N).astype(np.float32)
    kw = {}
    if case.groups:
        G, F, K = case.groups
        cva = np.tile(np.geomspace(1e-4, 1e-1, K - 1), (G, 1))
        config = GroupsConfig(block_size=case.B)
        kw = {"g_assign": (np.arange(case.M) % G).astype(np.int32),
              "fixed": rng.standard_normal((case.N, F)).astype(np.float32)}
    else:
        cva, config = np.array(CVA), BayesRConfig(block_size=case.B)
    s = ShardedSpikeSlabSampler(
        X, Y, cva, config, make_mesh(*case.mesh, device=device),
        backend=case.backend, chunk_blocks=case.chunk_blocks, **kw)
    if case.chains is not None and s.jacobi <= 1:
        raise AssertionError("the fused case must run the strided kernel")
    g = torch.Generator(device=s.device).manual_seed(0)
    counts, _ = count_step(s, s.init(g, chains=case.chains), g)
    return counts, {"jacobi": s.jacobi, "B": s.B, "nb_loc": s.nb_loc,
                    "split": s._split,
                    "split_blocks": s.split_blocks() if s._split else None}


def _validation_rank(rank, world, port, out_path):
    """One gloo rank of ``validate``: every case's counts, pickled to
    ``out_path``."""
    import torch
    import torch.distributed as dist

    from ..parallel.distributed import initialize

    torch.set_num_threads(1)
    initialize(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        res = [_case_counts(case, "cpu") for case in CASES]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def validate(timeout: float = 300):
    """Each case's model against its counted step on four gloo ranks (every
    rank's count must equal the model).  Returns one record a case."""
    import tempfile

    from .dryrun import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(_validation_rank, 4, tmp, timeout)
    out = []
    for i, case in enumerate(CASES):
        model = case_model(case)
        counted = [r[i][0] for r in ranks]
        match = all(c[ax]["calls"] == model["calls"][ax]
                    and c[ax]["bytes"] == model["bytes"][ax]
                    for c in counted for ax in AXES) \
            and all(c["other"]["calls"] == 0 for c in counted)
        out.append({"case": case.name, "backend": case.backend,
                    "chains": case.chains, "groups": case.groups,
                    "model": model, "counted": counted[0],
                    "layout": ranks[0][i][1], "match": match})
    return out


def main():
    out = validate()
    print(json.dumps(out, indent=1))
    if not all(r["match"] for r in out):
        raise SystemExit("comm_model: a counted step differs from the model")
    print("comm_model OK")


if __name__ == "__main__":
    sys.exit(main())
