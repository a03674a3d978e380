"""The port's kernels under a float64 state against JAX's Pallas kernels
under ``dtype=jnp.float64`` in interpret mode, on the CPU.

Where JAX's raise ``ValueError`` (the serial sweeps on dense X, the
horseshoe's serial and row-layout sweeps, the fused serial sweep on dense
X), the port's raise ``ValueError``; where JAX's run on float32 casts of
their operands (the strided sweeps, the row-layout BayesR sweep, the
serial BayesR sweep on words, the fused serial sweeps on words), the
port's run on the same casts: the state stays float64 and a replayed
step lands within the f32 replay tolerances of tests/test_torch_bayesr.py
(rtol 2e-4 / atol 2e-6 beta, 2e-5 eps), labels exact.  Dense X or its
2-bit words, N=200, M=256, B=32.
"""
import jax
import numpy as np
import pytest
import torch

import bayesrrcpp_tpu as jbr
from bayesrrcpp_tpu_torch import ChainConfig
from bayesrrcpp_tpu_torch.convert import unpermute_eps
from tests.test_torch_f64 import _pair, _replay


# (sampler, plan keywords, x_dtype, fused): JAX's Pallas kernels under a
# float64 state raise ValueError for the serial sweeps on dense X, the
# horseshoe's serial (single-chain) and row-layout sweeps, and the fused
# serial sweep on dense X; the others run on float32 casts
PALLAS_CASES = {
    "bayesr-t": ("bayesr", dict(jacobi_blocks=4, jacobi_layout="t"),
                 "dense", False),
    "bayesr-row": ("bayesr", dict(jacobi_blocks=4), "dense", False),
    "bayesr-serial": ("bayesr", dict(jacobi_blocks=1), "dense", False),
    "bayesr-serial-words": ("bayesr", dict(jacobi_blocks=1), "2bit", False),
    "bayesr-row-fused": ("bayesr", dict(jacobi_blocks=4), "dense", True),
    "bayesr-t-fused": ("bayesr", dict(jacobi_blocks=4, jacobi_layout="t"),
                       "dense", True),
    "horseshoe-t": ("horseshoe", dict(jacobi_blocks=4, jacobi_layout="t"),
                    "dense", False),
    "horseshoe-row": ("horseshoe", dict(jacobi_blocks=4), "dense", False),
    "horseshoe-serial-words": ("horseshoe", dict(jacobi_blocks=1), "2bit",
                               False),
    "horseshoe-serial-words-fused": ("horseshoe", dict(jacobi_blocks=1),
                                     "2bit", True),
}


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_pallas_f64_as_jax(case):
    kind, plan, x_dtype, fused = PALLAS_CASES[case]
    rng = np.random.default_rng(9)
    dosage = rng.binomial(2, rng.uniform(0.1, 0.9, 256),
                          size=(200, 256)).astype(float)
    X = (dosage - dosage.mean(0)) / dosage.std(0, ddof=1)
    Y = X[:, :8] @ rng.normal(0, 0.3, 8) + rng.normal(0, 0.8, 200)
    xkw = ({} if x_dtype == "dense" else dict(x_dtype=x_dtype))
    js, ts = _pair(kind, X if x_dtype == "dense" else dosage, Y,
                   backend="pallas", **plan, **xkw)
    assert (ts.jacobi, ts.jacobi_layout) == (js.jacobi, js.jacobi_layout)
    key = jax.random.PRNGKey(2)
    if fused:
        j_raises = _raises(lambda: js.run_chains(key, 2, jbr.ChainConfig(
            2, 1, 1), fused=True))
        g = torch.Generator().manual_seed(0)
        t_raises = _raises(lambda: ts.run_chains(g, 2, ChainConfig(2, 1, 1),
                                                 fused=True))
        assert t_raises == j_raises
        if not t_raises:
            st, out = ts.run_chains(g, 2, ChainConfig(2, 1, 1), fused=True)
            assert st.eps.dtype == st.beta.dtype == torch.float64
            assert np.isfinite(out["beta"]).all()
        return
    out = {}
    rv = _replay(kind, key)
    tst = ts.init(rv)
    j_raises = _raises(lambda: out.update(j=js.step(js.init(key))))
    t_raises = _raises(lambda: out.update(t=ts.step(tst, rv)))
    assert t_raises == j_raises, (t_raises, j_raises)
    if t_raises:
        return
    jst, tst = out["j"], out["t"]
    if kind != "horseshoe":
        np.testing.assert_array_equal(np.asarray(jst.labels),
                                      tst.labels.numpy())
    for name, tol in (("beta", dict(rtol=2e-4, atol=2e-6)),
                      ("eps", dict(rtol=2e-4, atol=2e-5)),
                      ("sigmaE", dict(rtol=1e-4))):
        t, j = getattr(tst, name), np.asarray(getattr(jst, name))
        assert t.dtype == torch.float64 and j.dtype == np.float64, name
        if name == "eps" and ts.x_packed:
            j = unpermute_eps(j, ts.Npad)
        np.testing.assert_allclose(t.numpy(), j, err_msg=name, **tol)
