"""Chain parallelism over devices: fused multi-chain kernels on every card.

Counterpart of ``bayesrrcpp_tpu/parallel/chains.py``: the chain axis is
split over the ranks of a 1-D ("c",) mesh, one process per card, and the
data are replicated (every rank builds the same sampler on its card).
Chains never interact, so the step needs no collective: each rank runs
its C / D chains fused, through the sampler's ``step_chains`` (the
kernels of ``run_chains``).  Emission gathers every chain to every rank,
as JAX's ``P(None, "c")`` rows (:78), and rank 0 writes the sink.

Determinism (JAX's contract, :15-18): rank g's chains equal an unsharded
fused run over rank g's slice of the root's chain streams.  JAX slices
``split(key, n_chains)``; here rank g's streams are one generator,
``chain_streams(root, g)``, drawn from the root generator (every rank
holds it in the same state) and the rank index.  So rank g of
``ChainParallelRunner(s, mesh).run(root, n_chains, chain)`` equals
``s.run_chains(chain_streams(root', g), n_chains // D, chain)`` for a
root' in the root's state; with a chain-batched variates object in place
of the generator (each rank passing its own slice) the runner takes it
as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..distributions import TorchVariates
from .mesh import default_device, gather
from .sharded import derived_generator

AXIS_C = "c"


@dataclasses.dataclass(frozen=True)
class ChainMesh:
    """A 1-D chain mesh as this process sees it: ``size`` ranks, this
    rank's ``index``, their process ``group`` (None: one rank) and the
    ``device``."""

    size: int
    index: int
    group: Optional[object]
    device: torch.device


def chain_mesh(n_devices: Optional[int] = None, group=None,
               device=None) -> ChainMesh:
    """The ("c",) mesh over the ranks of ``group`` (default: the default
    process group once ``torch.distributed`` is initialized, else this
    rank alone); ``n_devices``, when given, must be its size.  ``device``
    as ``mesh.default_device``."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    size = 1 if group is None else dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"chain mesh of {n_devices} devices needs as many "
                         f"ranks, have {size}")
    index = 0 if group is None else dist.get_rank(group)
    return ChainMesh(size, index, group, default_device(device))


def chain_streams(generator: torch.Generator, index: int) -> torch.Generator:
    """Rank ``index``'s chain streams of a root ``generator`` (the module
    docstring)."""
    return derived_generator(generator, index)


class ChainParallelRunner:
    """Run a sampler's fused multi-chain step sharded over a chain mesh.

    ``sampler`` is a SpikeSlabSampler or HorseshoeSampler on this rank's
    card whose ``supports_fused_chains`` is True; ``n_chains`` must be a
    multiple of the mesh size.
    """

    def __init__(self, sampler, mesh: ChainMesh):
        if not isinstance(mesh, ChainMesh):
            raise ValueError("mesh must be a chain mesh (chain_mesh())")
        if not sampler.supports_fused_chains:
            raise ValueError("sampler does not support the fused "
                             "multi-chain kernel")
        self.sampler = sampler
        self.mesh = mesh
        self.n_devices = mesh.size

    def _local(self, n_chains: int) -> int:
        if n_chains % self.n_devices:
            raise ValueError(f"n_chains={n_chains} must be a multiple of "
                             f"the {self.n_devices}-device chain mesh")
        return n_chains // self.n_devices

    def variates(self, rng, n_chains: int):
        """This rank's chain-batched variates: a root ``torch.Generator``
        (in the same state on every rank) gives ``chain_streams``; a
        variates object (this rank's slice of the chains) passes
        through."""
        C = self._local(n_chains)
        if isinstance(rng, torch.Generator):
            return TorchVariates(chain_streams(rng, self.mesh.index),
                                 chains=C)
        return rng

    def init(self, rng, n_chains: int):
        """Fresh inits of this rank's n_chains / D chains (their leading
        chain axis); returns (state, variates)."""
        v = self.variates(rng, n_chains)
        return self.sampler.init(v, chains=self._local(n_chains)), v

    def steps(self, state, v, n: int):
        """``n`` fused steps of this rank's chains: no collective."""
        for _ in range(n):
            state = self.sampler.step_chains(state, v)
        return state

    def _gather_chains(self, x):
        """An emitted field (emits, C_local, ...) of every rank, the chain
        axis in rank order: (emits, n_chains, ...)."""
        if self.mesh.group is None:
            return x
        host = isinstance(x, np.ndarray)
        t = torch.as_tensor(x, device=self.mesh.device) if host else x
        t = gather(t.movedim(1, -1), self.mesh.size,
                   self.mesh.group).movedim(-1, 1)
        return t.cpu().numpy() if host else t

    def run(self, rng, n_chains: int, chain, *, sink=None,
            collect: bool = True, emit_chunk: int = 32, progress=None):
        """A full sharded multi-chain run on every rank together; collected
        arrays are (emits, n_chains, ...) as ``run_chains``'.  Rank 0
        writes to ``sink`` (a ``ChainFanoutSink`` of n_chains)."""
        from ..models.driver import run_chain

        s = self.sampler
        state, v = self.init(rng, n_chains)

        def advance(st, n):
            return self.steps(st, v, n)

        def emit(st, n, t):
            st, rows = s._emit_chunk(st, advance, n, t)
            return st, {k: self._gather_chains(x) for k, x in rows.items()}

        return run_chain(
            state, chain, steps_fn=advance, emit_fn=emit,
            sink=sink if self.mesh.index == 0 else None, collect=collect,
            emit_chunk=emit_chunk, progress=progress,
            refresh_fn=s.refresh_eps)
