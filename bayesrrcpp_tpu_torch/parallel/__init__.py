"""The marker-sharded driver on ``torch.distributed`` (counterpart of
``bayesrrcpp_tpu/parallel/``): one process per card, the markers split
over the "m" axis of a mesh.  Chains over devices
(``bayesrrcpp_tpu/parallel/chains.py``) and the sharded horseshoe are not
ported: they raise ``NotImplementedError``."""
from ..models.sampler import not_ported
from .mesh import AXIS_M, AXIS_N, Mesh, make_mesh
from .sharded import (ShardedHorseshoeSampler, ShardedSpikeSlabSampler,
                      SliceVariates)


def chain_mesh(*args, **kwargs):
    """``bayesrrcpp_tpu/parallel/chains.py:chain_mesh``: not ported."""
    raise not_ported("chains over devices (parallel/chains.py)",
                     "Queue 1 item 5")


class ChainParallelRunner:
    """``bayesrrcpp_tpu/parallel/chains.py:ChainParallelRunner``: not
    ported."""

    def __init__(self, *args, **kwargs):
        chain_mesh()


__all__ = ["AXIS_M", "AXIS_N", "ChainParallelRunner", "Mesh",
           "ShardedHorseshoeSampler", "ShardedSpikeSlabSampler",
           "SliceVariates", "chain_mesh", "make_mesh"]
