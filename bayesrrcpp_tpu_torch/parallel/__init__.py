"""The sharded drivers on ``torch.distributed`` (counterpart of
``bayesrrcpp_tpu/parallel/``): one process per card, the markers split
over the "m" axis and the individuals over the "n" axis of a mesh
(``ShardedSpikeSlabSampler``, ``ShardedHorseshoeSampler``), or the chains
over a chain mesh (``ChainParallelRunner``)."""
from .chains import (AXIS_C, ChainMesh, ChainParallelRunner, chain_mesh,
                     chain_streams)
from .mesh import AXIS_M, AXIS_N, Mesh, make_mesh
from .sharded import (ShardedHorseshoeSampler, ShardedSpikeSlabSampler,
                      SliceVariates)

__all__ = ["AXIS_C", "AXIS_M", "AXIS_N", "ChainMesh", "ChainParallelRunner",
           "Mesh", "ShardedHorseshoeSampler", "ShardedSpikeSlabSampler",
           "SliceVariates", "chain_mesh", "chain_streams", "make_mesh"]
