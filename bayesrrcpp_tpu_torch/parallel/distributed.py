"""Multi-process execution: ``torch.distributed`` and the marker slices.

Counterpart of ``bayesrrcpp_tpu/parallel/distributed.py``.  One process
drives one card; ``initialize`` joins it to the run, and the sharded
sampler's "m" axis is the group of all processes (``mesh.make_mesh``).
Nothing on the machine tells a process of its peers: the caller gives the
address, the world size and the rank (``torchrun`` sets them in the
environment, where ``init_method="env://"`` reads them).

Where the JAX package places global arrays on a mesh, a process here
holds only its own slice of the markers:

- ``put_global``: this rank's marker slice of a host array every process
  holds whole;
- ``put_process_shard`` has no counterpart: with ``x_process_shard=True``
  the sampler takes the slice the rank already holds (each host reads
  only its markers of a .bed, ``process_marker_range`` and
  ``io.bed.read_bed_packed(marker_range=...)``);
- ``replicate`` is ``Mesh.all_gather``, every slice gathered over "m".
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


def initialize(init_method: str, world_size: int, rank: int, *,
               backend: Optional[str] = None, timeout=None) -> None:
    """Join this process to a run of ``world_size`` processes (the JAX
    package's ``jax.distributed.initialize``): ``init_method`` is
    ``"tcp://host:port"`` of rank 0, or ``"env://"``.  The backend defaults
    to NCCL where the card is, else gloo."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)


def process_marker_range(mesh: Mesh, mpad: int) -> tuple:
    """The [lo, hi) rows of an (mpad, ...) marker array that this rank
    holds: the m-slices are contiguous, mpad / Dm rows each."""
    if mpad % mesh.Dm:
        raise ValueError(f"{mpad} markers do not split into {mesh.Dm} "
                         "slices")
    loc = mpad // mesh.Dm
    return mesh.m_index * loc, (mesh.m_index + 1) * loc


def put_global(mesh: Mesh, host_array, dtype=None) -> torch.Tensor:
    """This rank's marker slice (rows ``process_marker_range``) of a host
    array that every process holds whole, on the mesh's device."""
    arr = np.asarray(host_array)
    lo, hi = process_marker_range(mesh, arr.shape[0])
    return torch.as_tensor(np.ascontiguousarray(arr[lo:hi]), dtype=dtype,
                           device=mesh.device)
