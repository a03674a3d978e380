"""The strided ``miss`` mode at N << M against a float64 sweep, on the CPU.

The case where the port's plain ``ops/jacobi_t.bayesr_jacobi_t(missing=
True)`` and JAX's ``bayesr_jacobi_t_pallas`` in interpret mode part beyond
the replay tolerances: N=300 individuals, M=1,024 markers with 2 % missing
calls, J=8, B=32 (tests/test_torch_groups.py's data at numpy seed 7, one
group), the first sweep of the chain from JAX's init at ``PRNGKey(11)``.
Both f32 sides are held elementwise to the same sweep in float64: the
words decoded to standardized values (a missing call 0, as the ``miss``
mode's correction makes it), the block-Jacobi oracle
``ops/block_sweep.bayesr_jacobi_sweep`` on the strided rounds' flat order,
p and z by canonical slab.  Labels equal on all three.  The port's side
lies within 1e-6 (beta) / 2e-5 (eps) of float64 (measured 1.5e-7 /
2.3e-6); JAX's lies ~100x farther (2.6e-5 / 3.7e-4): the reading is the
reference's f32 side, not a fault of the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu.ops import block_sweep as jbs
from bayesrrcpp_tpu.ops.pallas_jacobi_t import bayesr_jacobi_t_pallas
from bayesrrcpp_tpu_torch.convert import data_from_jax, unpermute_eps
from bayesrrcpp_tpu_torch.ops import block_sweep as bs
from bayesrrcpp_tpu_torch.ops import genotypes
from bayesrrcpp_tpu_torch.ops.jacobi_t import bayesr_jacobi_t
from tests.test_torch_groups import data

N, M = 300, 1024
PORT_F64_ATOL = {"beta": 1e-6, "eps": 2e-5}


def _t(a):
    return torch.as_tensor(np.array(a))


def test_strided_miss_at_n300_against_float64():
    X, Y, _, _, kw = data("2bit-miss", 1, 0, N=N, M=M)
    js = jbr.SpikeSlabSampler(X, Y, np.array([0.001, 0.01, 0.1]),
                              jbr.BayesRConfig(block_size=32),
                              dtype=jnp.float32, jacobi_blocks=8,
                              jacobi_layout="t", **kw)
    assert (js.jacobi, js.B, js._x_miss) == (8, 32, True)
    J, B, nb = js.jacobi, js.B, js.Mpad // js.B
    d = data_from_jax({k: np.array(v) for k, v in js.data._asdict().items()},
                      N=N, device="cpu")
    st = js.init(jax.random.PRNGKey(11))
    keys, _, eps, _, _ = js._pre_sweep(st, js.data)
    rho, inner = jbs.strided_orders(keys[4], nb, B, J)
    p = jax.random.uniform(keys[5], (js.Mpad,), dtype=jnp.float32)
    z = jax.random.normal(keys[6], (js.Mpad,), dtype=jnp.float32)
    state = (st.beta, st.labels, rho, inner, p, z, st.pi)
    jres = bayesr_jacobi_t_pallas(
        js.data.XT, js.data.gram, js.data.xsq, eps, *state, js.data.cva,
        st.sigmaE, st.sigmaGG, js.data.g_assign, js.data.valid, J=J,
        interpret=True, x_mean=js.data.x_mean, x_scale=js.data.x_scale,
        fold_affine=False, x_xsum=js.data.x_colsum,
        row_valid=js.data.row_valid, missing=True)
    eps_n = _t(unpermute_eps(np.array(eps), js.Npad))
    beta, labels, rho, inner, p, z, pi = map(_t, state)
    tres = bayesr_jacobi_t(
        d.XT, d.gram, d.xsq, eps_n, beta, labels, rho, inner, p, z, pi,
        d.cva, _t(st.sigmaE), _t(st.sigmaGG), d.g_assign, d.valid, J=J,
        x_mean=d.x_mean, x_scale=d.x_scale, x_xsum=d.x_colsum,
        fold_affine=False, row_valid=d.row_valid, missing=True)

    # the same sweep in float64
    f64 = torch.float64
    codes = genotypes.decode_codes(d.XT)
    Xf = ((codes.to(f64) - d.x_mean.to(f64)[:, None])
          * d.x_scale.to(f64)[:, None])
    Xf = torch.where(codes == genotypes.MISSING_CODE, 0.0, Xf) \
        * d.row_valid.to(f64)
    nr = nb // J
    by_slab = rho.long()

    def slabbed(a):
        return a.double().view(nr, J, B)[by_slab].reshape(-1)

    fres = bs.bayesr_jacobi_sweep(
        Xf, bs.gram_blocks(Xf, B), (Xf * Xf).sum(1), eps_n.double(),
        beta.double(), labels, bs.strided_border(by_slab, J), inner.long(),
        slabbed(p), slabbed(z), pi.double(), d.cva.double(),
        _t(st.sigmaE).double(), _t(st.sigmaGG).double(), d.g_assign.long(),
        d.valid, J=J)

    f = {"beta": fres.beta.numpy(), "eps": fres.eps.numpy()}
    port = {"beta": tres.beta.numpy(), "eps": tres.eps.numpy()}
    ref = {"beta": np.array(jres.beta),
           "eps": unpermute_eps(np.array(jres.eps), js.Npad)}
    np.testing.assert_array_equal(tres.labels.numpy(), fres.labels.numpy())
    np.testing.assert_array_equal(np.array(jres.labels), fres.labels.numpy())
    for name, atol in PORT_F64_ATOL.items():
        far_port = np.abs(port[name] - f[name]).max()
        far_jax = np.abs(ref[name] - f[name]).max()
        print(f"{name}: max |d| from float64: port {far_port:.3g}, "
              f"JAX {far_jax:.3g}")
        assert far_port <= atol, (name, far_port)
        assert far_jax > 10 * far_port, (name, far_jax, far_port)
