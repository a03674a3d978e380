"""The device mesh of the sharded samplers.

Counterpart of ``bayesrrcpp_tpu/parallel/mesh.py``.  The JAX package lays
its devices out as a 2-D ``jax.sharding.Mesh`` with axes "m" (markers,
model parallel: each m-slice sweeps its own Gram blocks) and "n"
(individuals, data parallel: rows of X and eps are split, and every
correlation ``X_b' eps`` is summed over "n").  Here one process drives
one card, and the ranks are laid out as JAX lays out its devices
(mesh.py:25-32): ``rank = m_index * Dn + n_index``.  Each axis is a
``torch.distributed`` process group: the "m" group holds the ranks that
share this rank's n index, the "n" group those that share its m index,
and every ``lax.psum(..., "m")`` / ``lax.psum(..., "n")`` of the JAX
code is ``mesh.all_reduce(t, "m")`` / ``mesh.all_reduce(t, "n")``, a sum
over the group of the card's own tensor.  The backend is the group's:
NCCL on the card, gloo across CPU processes (the tests), and gloo over
CUDA tensors for ranks that share one card, which NCCL refuses.

An axis of one rank needs no group (on a mesh of several ranks it has
none): its all-reduce is the identity.  A mesh of one rank with
``torch.distributed`` initialized keeps the world group on its "m" axis,
so that its all-reduces are launched.
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
    """An (m, n) mesh as this process sees it: ``Dm`` slices of the
    markers and ``Dn`` of the individuals, this process's slices
    ``m_index`` and ``n_index``, the process groups of the "m" axis
    (``group``) and of the "n" axis (``n_group``; None: the axis is this
    rank alone) and the ``device`` its tensors live on."""

    Dm: int
    Dn: int
    m_index: int
    n_index: int
    group: Optional[object]
    n_group: Optional[object]
    device: torch.device

    def _group(self, axis: str):
        if axis not in (AXIS_M, AXIS_N):
            raise ValueError(f"unknown mesh axis {axis!r}")
        return self.group if axis == AXIS_M else self.n_group

    def all_reduce(self, t: torch.Tensor, axis: str = AXIS_M) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` (``lax.psum(t, axis)``), in place;
        returns ``t``."""
        group = self._group(axis)
        if group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis: str = AXIS_M) -> torch.Tensor:
        """Every slice's ``t`` of ``axis`` concatenated along the last
        axis, in slice order: the whole marker (or individual) axis on
        every rank of the group (the JAX package's
        ``distributed.replicate``)."""
        group = self._group(axis)
        if group is None:
            return t
        return gather(t, self.Dm if axis == AXIS_M else self.Dn, group)


def gather(t: torch.Tensor, size: int, group) -> torch.Tensor:
    """The ``size`` ranks' ``t`` of ``group`` concatenated along the last
    axis, in rank order.  gloo gathers host tensors only, so a CUDA tensor
    goes through the host there (ranks that share a card)."""
    dev = t.device
    host = dev.type == "cuda" and dist.get_backend(group) == "gloo"
    t = (t.cpu() if host else t).contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=-1).to(dev)


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


def _axis_groups(m: int, n: int, rank: int, ranks: list):
    """The "m" and "n" groups of ``rank`` on an (m, n) layout of ``ranks``
    (the group's global ranks, in group order).  Every rank creates every
    group of more than one rank, in one fixed order (``dist.new_group``
    must be called alike everywhere), and keeps its own two; m, n > 1."""
    m_group = n_group = None
    for j in range(n):                  # an "m" group per n index
        g = dist.new_group([ranks[i * n + j] for i in range(m)])
        if rank % n == j:
            m_group = g
    for i in range(m):                  # an "n" group per m index
        g = dist.new_group([ranks[i * n + j] for j in range(n)])
        if rank // n == i:
            n_group = g
    return m_group, n_group


def make_mesh(m: int = 1, n: int = 1, group=None, device=None) -> Mesh:
    """An (m, n) mesh over the ranks of ``group`` (default: the default
    process group, once ``torch.distributed`` is initialized), rank r at
    (r // n, r % n); ``m == n == 1`` without an initialized group is the
    one-rank mesh whose all-reduces are the identity.  A group of one
    axis only (n == 1 or m == 1) is that axis's group; on an (m, n) mesh
    with both above 1 the axes' groups are made here, on every rank.
    ``device`` as ``default_device``."""
    if m < 1 or n < 1:
        raise ValueError(f"mesh {m}x{n}")
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    dev = default_device(device)
    if group is None:
        if m * n != 1:
            raise ValueError(f"an {m}x{n} mesh needs a process group of "
                             f"{m * n} ranks (torch.distributed."
                             "init_process_group)")
        return Mesh(1, 1, 0, 0, None, None, dev)
    size = dist.get_world_size(group)
    if size != m * n:
        raise ValueError(f"mesh {m}x{n} needs {m * n} ranks, the group has "
                         f"{size}")
    rank = dist.get_rank(group)
    if n == 1:
        m_group, n_group = group, None
    elif m == 1:
        m_group, n_group = None, group
    else:
        ranks = dist.get_process_group_ranks(group)
        m_group, n_group = _axis_groups(m, n, rank, ranks)
    return Mesh(m, n, rank // n, rank % n, m_group, n_group, dev)
