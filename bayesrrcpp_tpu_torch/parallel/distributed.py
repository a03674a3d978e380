"""Multi-process execution: ``torch.distributed`` and the marker slices.

Counterpart of ``bayesrrcpp_tpu/parallel/distributed.py``.  One process
drives one card; ``initialize`` joins it to the run, and the sharded
samplers' mesh lays the processes out over its "m" and "n" axes
(``mesh.make_mesh``).
Nothing on the machine tells a process of its peers: the caller gives the
address, the world size and the rank, or ``torchrun`` sets them in the
environment, where ``initialize()`` reads them.

Where the JAX package places global arrays on a mesh, a process here
holds only its own slice of the markers (and of the individuals):

- ``put_global``: this rank's slice of an array every process holds
  whole, split over "m" and / or "n" as a JAX ``PartitionSpec`` splits it;
- ``put_process_shard`` has no counterpart: with ``x_process_shard=True``
  the sampler takes the slice the rank already holds (each host reads
  only its markers of a .bed, ``process_marker_range`` and
  ``io.bed.read_bed_packed(marker_range=...)``);
- ``replicate`` is ``Mesh.all_gather``, every slice gathered over "m".
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import AXIS_M, Mesh


def initialize(init_method: str = "env://",
               world_size: Optional[int] = None, rank: Optional[int] = None,
               *, backend: Optional[str] = None, timeout=None) -> None:
    """Join this process to a run of ``world_size`` processes (the JAX
    package's ``jax.distributed.initialize``): ``init_method`` is
    ``"tcp://host:port"`` of rank 0, or ``"env://"``.  With no arguments it
    joins a ``torchrun`` launch, as ``jax.distributed.initialize()`` joins
    a pod: ``env://`` reads the address from MASTER_ADDR and MASTER_PORT,
    and the world size and the rank come from WORLD_SIZE and RANK.  The
    backend defaults to NCCL where the card is, else gloo."""
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise ValueError(f"{name} is not set: launch with torchrun, or pass "
                         "init_method, world_size and rank")
    return int(os.environ[name])


def process_marker_range(mesh: Mesh, mpad: int) -> tuple:
    """The [lo, hi) rows of an (mpad, ...) marker array that this rank
    holds: the m-slices are contiguous, mpad / Dm rows each."""
    if mpad % mesh.Dm:
        raise ValueError(f"{mpad} markers do not split into {mesh.Dm} "
                         "slices")
    loc = mpad // mesh.Dm
    return mesh.m_index * loc, (mesh.m_index + 1) * loc


def put_global(mesh: Mesh, host_array, dtype=None,
               spec=(AXIS_M,)) -> torch.Tensor:
    """This rank's slice of an array every process holds whole (NumPy or a
    tensor), on the mesh's device: axis k split over the mesh axis
    ``spec[k]`` ("m": the rows of ``process_marker_range``, "n": this
    rank's n-slice, None: whole), as JAX's ``P(...)`` places it -- P("m")
    marker vectors, P("m", "n") dense rows, P("n") the individual vectors
    Y and eps (sharded.py:382-389, :420)."""
    arr = (host_array if isinstance(host_array, torch.Tensor)
           else np.asarray(host_array))
    idx = []
    for axis, name in enumerate(spec):
        if name is None:
            idx.append(slice(None))
            continue
        size, at = ((mesh.Dm, mesh.m_index) if name == AXIS_M
                    else (mesh.Dn, mesh.n_index))
        n = arr.shape[axis]
        if n % size:
            raise ValueError(f"axis {axis} of {n} does not split into "
                             f"{size} slices")
        loc = n // size
        idx.append(slice(at * loc, (at + 1) * loc))
    part = arr[tuple(idx)]
    if isinstance(part, torch.Tensor):
        return part.to(device=mesh.device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(part), dtype=dtype,
                           device=mesh.device)
