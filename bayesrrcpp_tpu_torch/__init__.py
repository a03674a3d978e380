"""bayesrrcpp_tpu_torch -- the BayesR engine in PyTorch, for NVIDIA Hopper.

A port of :mod:`bayesrrcpp_tpu` (JAX on a TPU, kept beside it as the
reference).  This package covers the BayesR main path: one chain of the
``"bayesr"`` sampler (SURVEY C1) on 2-bit packed genotypes with no missing
calls, swept by the strided-rounds block-Jacobi kernel
(``csrc/jacobi_t.cu``, the counterpart of
``bayesrrcpp_tpu/ops/pallas_jacobi_t.py:_jacobi_t_kernel``), plus the plain
Gram-blocked sweep on dense X behind :func:`api.BayesRSamplerV2`.  Whatever
lies outside that slice raises ``NotImplementedError`` naming its ROADMAP
entry.

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

from .config import BayesRConfig, ChainConfig  # noqa: E402
from .distributions import TorchVariates  # noqa: E402
from .models.bayesr import SpikeSlabSampler  # noqa: E402
from . import distributions, simulate  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "BayesRConfig", "ChainConfig", "SpikeSlabSampler", "TorchVariates",
    "distributions", "simulate",
]
