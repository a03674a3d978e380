"""The device mesh of the sharded samplers.

Counterpart of ``bayesrrcpp_tpu/parallel/mesh.py``.  The JAX package lays
its devices out as a 2-D ``jax.sharding.Mesh`` with axes "m" (markers,
model parallel: each m-slice sweeps its own Gram blocks) and "n"
(individuals, data parallel).  Here one process drives one card, and the
"m" axis is a ``torch.distributed`` process group: every ``lax.psum(...,
"m")`` of the JAX code is ``mesh.all_reduce(t)``, a sum over the group of
the card's own tensor.  The backend is the group's: NCCL on the card,
gloo across CPU processes (the tests), and gloo over CUDA tensors for two
ranks that share one card, which NCCL refuses.

A mesh of one rank needs no process group; its all-reduce is then the
identity.  Only the (m, 1) layout is ported: the "n" axis (the row-split
sweep) raises.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

AXIS_M = "m"
AXIS_N = "n"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (m, 1) mesh as this process sees it: ``Dm`` slices of the
    markers, this process's slice ``m_index``, the process group ``group``
    of the "m" axis (None: one rank, no group) and the ``device`` its
    tensors live on."""

    Dm: int
    Dn: int
    m_index: int
    group: Optional[object]
    device: torch.device

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the "m" axis (``lax.psum(t, "m")``), in
        place; returns ``t``."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every slice's ``t`` concatenated along the last axis, in slice
        order: the whole marker axis on every rank (an all-gather over "m",
        the JAX package's ``distributed.replicate``)."""
        if self.group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.Dm)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=-1)


def default_device(device=None) -> torch.device:
    """``device`` as given, else this process's card: ``cuda:{LOCAL_RANK}``
    (the launcher's local rank, 0 without one).  Without a card only an
    explicit CPU device runs."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the sharded samplers run on the "
                           "card; pass device='cpu' to run on the CPU")
    return device


def make_mesh(m: int = 1, n: int = 1, group=None, device=None) -> Mesh:
    """An (m, n) mesh over the ranks of ``group`` (default: the default
    process group, once ``torch.distributed`` is initialized), one rank per
    m-slice; ``m == 1`` without an initialized group is the one-rank mesh
    whose all-reduce is the identity.  ``device`` as ``default_device``.
    """
    if n != 1:
        raise NotImplementedError(
            "the individual axis (n > 1: the row-split sweep) is not ported "
            "to bayesrrcpp_tpu_torch yet (ROADMAP Queue 1 item 5)")
    if m < 1:
        raise ValueError(f"mesh {m}x{n}")
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        if m != 1:
            raise ValueError(f"an {m}x1 mesh needs a process group of {m} "
                             "ranks (torch.distributed.init_process_group)")
        return Mesh(1, 1, 0, None, default_device(device))
    size = dist.get_world_size(group)
    if size != m:
        raise ValueError(f"mesh {m}x{n} needs {m} ranks, the group has "
                         f"{size}")
    return Mesh(m, 1, dist.get_rank(group), group, default_device(device))
