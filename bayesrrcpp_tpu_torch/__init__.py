"""bayesrrcpp_tpu_torch -- the BayesR engine in PyTorch, for NVIDIA Hopper.

A port of :mod:`bayesrrcpp_tpu` (JAX on a TPU, kept beside it as the
reference).  It covers the reference's four samplers on 2-bit packed
genotypes, with or without missing calls (a PLINK .bed read straight into
packed words, ``io/bed.py``), on int8 codes and on dense f32 rows, one
chain or several fused (``run_chains``), each swept by its strided-rounds
block-Jacobi kernels in ``csrc/`` (or, on a row-layout plan with J > 1,
by the row-layout ones of ``csrc/serial.cu``; at J=1, by the exact serial
kernels):

- BayesR, the ``"bayesr"`` variant (SURVEY C1), the counterpart of
  ``bayesrrcpp_tpu/ops/pallas_jacobi_t.py:_jacobi_t_kernel`` and, for
  several chains, ``_jacobi_t_mc_kernel`` / ``_jacobi_t_mc8_kernel``;
- BayesR with groups and fixed effects, the ``"groups"`` variant of a
  ``GroupsConfig`` (C2), and its warm restart ``init_from`` (C3), on the
  same kernels;
- the regularized horseshoe (SURVEY C4), the counterpart of
  ``_hs_jacobi_t_kernel`` and ``_hs_jacobi_t_mc_kernel`` /
  ``_hs_jacobi_t_mc8_kernel``;

plus the plain Gram-blocked sweeps on dense X behind the functions of
``api`` (``BayesRSamplerV2``, ``BayesRSamplerV2Groups``, ``BRV2Grstart``,
``HorseshoeR``), checkpoints that resume a chain bitwise
(``io.checkpoint.save_checkpoint`` / ``load_checkpoint``), and the command
line ``python -m bayesrrcpp_tpu_torch bayesr|groups|horseshoe|resume``
(``cli.py``).  The sharded samplers (``ShardedSpikeSlabSampler``,
``ShardedHorseshoeSampler`` on a ``make_mesh(m, n)`` of
``torch.distributed`` processes, one card each, ``parallel/``) split the
markers and, for dense X, the individuals over cards, and
``ChainParallelRunner`` on a ``chain_mesh()`` splits fused chains.  The
samplers, the API and the CLI run on the card unless ``device="cpu"`` is
given.  Whatever lies outside the port raises ``NotImplementedError``
naming its ROADMAP entry.

The package imports torch and numpy only, never jax.
"""
import torch as _torch

# The Gibbs residual algebra runs through matrix products (the Gram build,
# the residual dots), and the sigmaE/sigmaG feedback amplifies any
# reduced-precision pass into chain divergence (BENCH.md:23-40).  TF32
# keeps ~3 decimal digits, so every float32 product here runs in full f32:
# the counterpart of the JAX package's matmul-precision pin.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import (BayesRConfig, ChainConfig, GroupsConfig,  # noqa: E402
                     HorseshoeConfig)
from .distributions import TorchVariates  # noqa: E402
from .models.bayesr import SpikeSlabSampler  # noqa: E402
from .models.horseshoe import HorseshoeSampler  # noqa: E402
from .models.state import HorseshoeState, SpikeSlabState  # noqa: E402
from .parallel import (ChainParallelRunner, ShardedHorseshoeSampler,  # noqa: E402
                       ShardedSpikeSlabSampler, chain_mesh, make_mesh)
from . import distributions, simulate  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "BayesRConfig", "ChainConfig", "ChainParallelRunner", "GroupsConfig",
    "HorseshoeConfig",
    "HorseshoeSampler", "HorseshoeState", "ShardedHorseshoeSampler",
    "ShardedSpikeSlabSampler", "SpikeSlabSampler", "SpikeSlabState",
    "TorchVariates", "chain_mesh", "distributions", "make_mesh",
    "simulate",
]
