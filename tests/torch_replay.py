"""The JAX samplers' draws at their ``dtype``, for the port's float64 tests
(tests/test_torch_scan.py, test_torch_mirror.py, test_torch_f64.py).

``JaxReplay`` re-derives from a key every draw that
``bayesrrcpp_tpu/models/bayesr.py`` makes (init :386-396, init_from
:424-435, ``_pre_sweep`` :511-530, the sweep's orders and p / z :587-660,
``_hyper_block`` :546-580) under the roles of the port's
``distributions.TorchVariates``, in the JAX sampler's dtype: float32 or
float64.  The blocked, strided and full orders come from the same key, as
JAX draws whichever its backend takes.  ``JaxHorseshoeReplay`` does the
same for ``bayesrrcpp_tpu/models/horseshoe.py`` (init :280-298, init_from
:318-345, the step's 10 keys :388-502).  Not collected by pytest (no
``test_`` prefix).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from bayesrrcpp_tpu import distributions as jdist
from bayesrrcpp_tpu.ops import block_sweep as jbs


def _gamma(k, shape):
    # a python-float shape: f64 under the tests' x64, as JAX's draw
    return jax.random.gamma(k, jnp.asarray(shape, jnp.float64))


class _Replay:
    def __init__(self, key, dtype=np.float64):
        self.key = key
        self.dt = np.dtype(dtype)

    def _t(self, x):
        return torch.as_tensor(np.array(x, self.dt))

    @staticmethod
    def _i(x):
        return torch.as_tensor(np.array(x))

    def mu_noise(self):
        return self._t(jax.random.normal(self.keys[1], (), self.dt))

    def orders(self, nb, B, J):
        return tuple(map(self._i, jbs.strided_orders(self.keys[4], nb, B,
                                                     J)))

    def block_orders(self, nb, B):
        return tuple(map(self._i, jbs.block_orders(self.keys[4], nb, B)))

    def full_order(self, n):
        return self._i(jax.random.permutation(self.keys[4], n))


class JaxReplay(_Replay):
    """``SpikeSlabSampler``'s draws (both variants, fixed effects
    included)."""

    def init_sigmaGG(self, G):
        self.key, kG, self.kF = jax.random.split(self.key, 3)
        return self._t(jax.vmap(
            lambda k: jdist.beta_rng(k, 1.0, 1.0, dtype=self.dt))(
                jax.random.split(kG, G)))

    def init_sigmaF(self):
        return self._t(jax.random.uniform(self.kF, (), self.dt))

    def init_from_pi_gamma(self, alpha):
        self.key, kpi = jax.random.split(self.key)
        return self._per_group(kpi, alpha)

    def begin_step(self):
        self.keys = jax.random.split(self.key, 11)
        self.key = self.keys[0]

    def fixed_order(self, F):
        return self._i(jax.random.permutation(self.keys[2], F))

    def fixed_z(self, F):
        return self._t(jax.random.normal(self.keys[3], (F,), self.dt))

    def p(self, n):
        return self._t(jax.random.uniform(self.keys[5], (n,), self.dt))

    def z(self, n):
        return self._t(jax.random.normal(self.keys[6], (n,), self.dt))

    def sigmaE_gamma(self, shape):
        return self._t(_gamma(self.keys[7], shape))

    def sigmaF_gamma(self, shape):
        return self._t(_gamma(self.keys[8], shape))

    def _per_group(self, key, shapes):
        ks = jax.random.split(key, shapes.shape[0])
        return self._t(jax.vmap(jax.random.gamma)(
            ks, jnp.asarray(shapes.numpy(), self.dt)))

    def sigmaG_gamma(self, shapes):
        return self._per_group(self.keys[9], shapes)

    def pi_gamma(self, alpha):
        return self._per_group(self.keys[10], alpha)


class JaxHorseshoeReplay(_Replay):
    """``HorseshoeSampler``'s draws."""

    def init_gammas(self, eta_shape, tau_shape):
        self.key, keta, ktau = jax.random.split(self.key, 3)
        return (self._t(_gamma(keta, eta_shape)),
                self._t(_gamma(ktau, tau_shape)))

    def init_from_gammas(self, eta_shape, local_alpha, n, c2_shape):
        self.key, keta, kv, kc2 = jax.random.split(self.key, 4)
        return (self._t(_gamma(keta, eta_shape)),
                self._t(jdist.gamma_shape_rng(kv, local_alpha, n,
                                              dtype=self.dt)),
                self._t(_gamma(kc2, c2_shape)))

    def begin_step(self):
        self.keys = jax.random.split(self.key, 10)
        self.key = self.keys[0]
        self.local_keys = [self.keys[3], self.keys[6]]   # v, then lambda

    def eta_gamma(self, shape):
        return self._t(_gamma(self.keys[2], shape))

    def local_gamma(self, alpha, n):
        return self._t(jdist.gamma_shape_rng(self.local_keys.pop(0), alpha,
                                             n, dtype=self.dt))

    def z(self, n):
        return self._t(jax.random.normal(self.keys[5], (n,), self.dt))

    def tau_gamma(self, shape):
        return self._t(_gamma(self.keys[7], shape))

    def c2_gamma(self, shape):
        return self._t(_gamma(self.keys[8], shape))

    def sigmaE_gamma(self, shape):
        return self._t(_gamma(self.keys[9], shape))
