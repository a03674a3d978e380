"""Sites #5 and #6, the chunked strided sweeps of the marker-sharded driver
(bayesrrcpp_tpu_torch/ops/jacobi_t.py: ``bayesr_jacobi_t_rounds``,
``bayesr_jacobi_t_mc_rounds``), against the JAX package on the CPU.

The same data (2-bit words without and with missing calls, int8 codes
without missing calls, or dense f32 rows), warm state and variates, made with numpy from a seed at
tests/test_sharded.py:458-511's size (N=96, M=256, B=8, J=4, G=2, C=3;
words take N=2000, since their lanes pad to 2048 whatever N is, and at
N=96 JAX's ``miss`` mode adds f32 noise of its 1,952 pad lanes, whose
codes decode to 0 only up to rounding, to sums of 96 real ones), go
through JAX ``bayesr_jacobi_t_rounds`` / ``bayesr_jacobi_t_mc_rounds``
in interpret mode (operands from ``build_strided_operands(_mc)``) and the
port's entry points on CPU tensors (their plain versions), for a chunk of
3 of the 8 rounds (JAX's slabs in visit order, ``visit_out=True``) and
for all 8 (canonical order).  Tolerances as test_sharded.py:498-511:
labels and v exact, beta to rtol 3e-4 / atol 3e-6, eps to rtol 3e-4 /
atol 3e-5, bacc to rtol 1e-4.  JAX's fold modes take sum(eps) once per
chunk and track it; the port sums it afresh every round, inside those
tolerances.

The port's own identities are held exactly: a chunk of every round is
``bayesr_jacobi_t_reference`` (``_mc_``), and the chunks of a sweep run in
turn, eps handed on, give its eps, beta and labels bitwise (v exact, bacc
to f32 reassociation, since each chunk sums its own blocks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesrrcpp_tpu.ops import genotypes as jgen
from bayesrrcpp_tpu.ops.pallas_jacobi_t import (bayesr_jacobi_t_mc_rounds,
                                                bayesr_jacobi_t_rounds,
                                                build_strided_operands,
                                                build_strided_operands_mc)
from bayesrrcpp_tpu_torch.convert import unpermute_eps
from bayesrrcpp_tpu_torch.ops import jacobi_t as tj

M, B, J, G, C, K = 256, 8, 4, 2, 3, 4
NB = M // B
NR = NB // J
CHUNK = np.array([5, 2, 7], np.int32)        # 3 of the 8 round ids
CVA = np.array([0.001, 0.01, 0.1], np.float32)
MODES = ("fold", "miss", "dense", "int8")


def _case(mode, chains=None, seed=91):
    """Data of ``mode`` and a warm state, all numpy; with ``chains`` every
    per-chain array has a leading chain axis."""
    rng = np.random.default_rng(seed + MODES.index(mode))
    lead = () if chains is None else (chains,)
    N = 96 if mode == "dense" else 2000
    c = dict(mode=mode)
    if mode == "int8":
        dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M),
                              size=(N, M)).astype(float)
        q = jgen.quantize_int8(dosage, False, None, B, M)
        c.update(XT=np.array(q.XT), Npad=N, xsq=np.array(q.xsq),
                 gram=np.array(q.gram), mean=np.array(q.x_mean),
                 scale=np.array(q.x_scale), colsum=np.array(q.x_colsum),
                 row_valid=np.ones(N, bool), perm=np.arange(N))
    elif mode == "dense":
        XT = rng.standard_normal((M, N)).astype(np.float32)
        blocks = XT.reshape(NB, B, N)
        c.update(XT=XT, Npad=N, xsq=(XT * XT).sum(axis=1),
                 gram=np.einsum("bin,bjn->bij", blocks, blocks),
                 row_valid=np.ones(N, bool), perm=np.arange(N))
    else:
        dosage = rng.binomial(2, rng.uniform(0.1, 0.9, M),
                              size=(N, M)).astype(float)
        if mode == "miss":
            dosage[rng.random(dosage.shape) < 0.05] = np.nan
        q = jgen.quantize_packed(dosage, False, None, B, M, N,
                                 prepacked=False)
        assert q.has_missing == (mode == "miss")
        c.update(XT=np.array(q.XT), Npad=q.Npad, xsq=np.array(q.xsq),
                 gram=np.array(q.gram), mean=np.array(q.x_mean),
                 scale=np.array(q.x_scale), colsum=np.array(q.x_colsum),
                 row_valid=np.arange(q.Npad) < N, perm=np.asarray(q.n_perm))
    eps = np.zeros(lead + (c["Npad"],), np.float32)
    eps[..., :N] = rng.standard_normal(lead + (N,))
    beta = np.zeros(lead + (M,), np.float32)
    labels = np.zeros(lead + (M,), np.int32)
    for i in np.ndindex(lead):
        hot = rng.choice(M, M // 8, replace=False)
        labels[i + (hot,)] = rng.integers(1, 4, hot.size)
        beta[i + (hot,)] = rng.normal(0, 0.05, hot.size)
    c.update(
        eps=eps, beta=beta, labels=labels,
        rho=rng.permutation(NR).astype(np.int32),
        inner=np.argsort(rng.random((NB, B)), axis=1).astype(np.int32),
        p=rng.random(lead + (M,)).astype(np.float32),
        z=rng.standard_normal(lead + (M,)).astype(np.float32),
        pi=rng.dirichlet([5, 2, 2, 1], lead + (G,)).astype(np.float32),
        cva=np.tile(CVA, (G, 1)),
        sigmaE=rng.uniform(0.5, 1.0, lead).astype(np.float32),
        sigmaGG=rng.uniform(0.02, 0.1, lead + (G,)).astype(np.float32),
        gas=(np.arange(M) % G).astype(np.int32),
        valid=np.arange(M) < M - 3)
    return c


def _port_args(c, rho):
    t = torch.as_tensor
    return (t(c["XT"]), t(c["gram"]), t(c["xsq"]), t(c["eps"]),
            t(c["beta"]), t(c["labels"]), t(rho), t(c["inner"]), t(c["p"]),
            t(c["z"]), t(c["pi"]), t(c["cva"]), t(c["sigmaE"]),
            t(c["sigmaGG"]), t(c["gas"]), t(c["valid"]))


def _port_kw(c):
    if c["mode"] == "dense":
        return dict(J=J, x_mean=None)
    t = torch.as_tensor
    miss = c["mode"] == "miss"
    kw = dict(J=J, x_mean=t(c["mean"]), x_scale=t(c["scale"]),
              x_xsum=t(c["colsum"]), fold_affine=not miss, missing=miss)
    if c["mode"] != "int8":
        kw["row_valid"] = t(c["row_valid"])
    return kw


def _jax(c, rho, mc):
    """JAX's rounds kernel on ``c`` for the rounds ``rho``: (eps (..., Npad)
    in individual order, beta (..., M), labels (..., M), v (..., G, K),
    bacc (..., G)), the chunk's slabs scattered to their markers."""
    a = jnp.asarray
    dense = c["mode"] == "dense"
    fold, miss = not dense, c["mode"] == "miss"
    packed = c["mode"] in ("fold", "miss")
    kw = {} if dense else dict(x_mean=a(c["mean"]), x_scale=a(c["scale"]),
                               x_xsum=a(c["colsum"]))
    common = (a(c["gram"]), a(c["xsq"]), a(c["gas"]), a(c["valid"]),
              a(c["p"]), a(c["z"]), a(c["pi"]), a(c["cva"]),
              a(c["sigmaE"]), a(c["sigmaGG"]), a(c["beta"]))
    eps = c["eps"][..., c["perm"]]
    whole = rho.shape[0] == NR
    if mc:
        ops = build_strided_operands_mc(*common, a(c["inner"]), B=B, J=J,
                                        fold=fold, missing=miss, **kw)
        out = bayesr_jacobi_t_mc_rounds(
            a(c["XT"]), ops, a(rho), a(eps), J=J, B=B, K=K, G=G, C=C,
            nr_total=NR, packed=packed, fold=fold, missing=miss,
            interpret=True)
        # (nrc, C*J, B) chain bands -> (C, nrc, J, B)
        sl = [np.asarray(x).reshape(rho.shape[0], C, J, B).transpose(
            1, 0, 2, 3) for x in out[1:3]]
    else:
        ops = build_strided_operands(*common, a(c["labels"]), a(c["inner"]),
                                     B=B, J=J, fold=fold, missing=miss, **kw)
        out = bayesr_jacobi_t_rounds(
            a(c["XT"]), ops, a(rho), a(eps[None]), jnp.float32(c["sigmaE"]),
            J=J, B=B, K=K, G=G, nr_total=NR, packed=packed, fold=fold,
            missing=miss, interpret=True, visit_out=not whole)
        sl = [np.asarray(x) for x in out[1:3]]
    beta, labels = c["beta"].copy(), c["labels"].copy()
    # canonical order (the single-chain call over every round), else visit
    # order (a chunk, and every fused call)
    slabs = np.arange(NR) if whole and not mc else rho
    rows = ((np.arange(J)[None, :, None] * NR + slabs[:, None, None]) * B
            + np.arange(B)[None, None, :])        # (nrc, J, B) markers
    beta[..., rows] = sl[0]
    kv = sl[1]
    labels[..., rows] = np.where(kv >= 0, kv.astype(np.int32),
                                 labels[..., rows])
    eps_out = np.asarray(out[0]) * c["row_valid"][c["perm"]]
    if packed:
        eps_out = unpermute_eps(eps_out, c["Npad"])
    lead = (C,) if mc else ()
    return (eps_out.reshape(lead + (-1,)), beta, labels,
            np.asarray(out[3]).reshape(lead + (G, K)),
            np.asarray(out[4]).reshape(lead + (G,)))


def _assert_matches_jax(ref, out):
    eps, beta, labels, v, bacc = ref
    np.testing.assert_array_equal(labels, out.labels.numpy())
    np.testing.assert_array_equal(v, out.v.numpy())
    np.testing.assert_allclose(beta, out.beta.numpy(), rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(eps, out.eps.numpy(), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(bacc, out.beta_acum.numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("span", ["chunk", "whole"])
@pytest.mark.parametrize("mode", MODES)
def test_rounds_match_jax(mode, span):
    """Site #5: one chain, a chunk of 3 rounds and all 8."""
    c = _case(mode)
    rho = CHUNK if span == "chunk" else c["rho"]
    before = tj.bayesr_jacobi_t_rounds.launches
    out = tj.bayesr_jacobi_t_rounds(*_port_args(c, rho), nr_total=NR,
                                    **_port_kw(c))
    assert tj.bayesr_jacobi_t_rounds.launches == before  # CPU: plain
    _assert_matches_jax(_jax(c, rho, mc=False), out)
    if span == "whole":
        ref = tj.bayesr_jacobi_t_reference(*_port_args(c, rho),
                                           **_port_kw(c))
        for x, y in zip(ref, out):
            assert torch.equal(x, y)


def _chain(c, i):
    """Chain i's single-chain case of a chain-batched one."""
    per_chain = ("eps", "beta", "labels", "p", "z", "pi", "sigmaE",
                 "sigmaGG")
    return {k: (x[i] if k in per_chain else x) for k, x in c.items()}


@pytest.mark.parametrize("span", ["chunk", "whole"])
@pytest.mark.parametrize("mode", MODES)
def test_mc_rounds_match_jax(mode, span):
    """Site #6: C=3 fused chains, a chunk of 3 rounds and all 8."""
    c = _case(mode, chains=C)
    rho = CHUNK if span == "chunk" else c["rho"]
    out = tj.bayesr_jacobi_t_mc_rounds(*_port_args(c, rho), nr_total=NR,
                                       **_port_kw(c))
    _assert_matches_jax(_jax(c, rho, mc=True), out)
    if span == "whole":
        ref = tj.bayesr_jacobi_t_mc_reference(*_port_args(c, rho),
                                              **_port_kw(c))
        for x, y in zip(ref, out):
            assert torch.equal(x, y)


def _in_turn(fn, c, chunks):
    """The chunks of a sweep run one after the other through ``fn``, eps,
    beta and labels handed on; v and bacc summed."""
    args = list(_port_args(c, c["rho"]))
    v = bacc = 0
    for rho in chunks:
        args[6] = torch.as_tensor(rho)
        res = fn(*args, nr_total=NR, **_port_kw(c))
        args[3], args[4], args[5] = res.eps, res.beta, res.labels
        v, bacc = v + res.v, bacc + res.beta_acum
    return res, v, bacc


@pytest.mark.parametrize("mode", MODES)
def test_chunks_in_turn_are_the_sweep(mode):
    """The plain versions: a sweep cut into chunks of 3, 3 and 2 rounds,
    one chain and fused, equals the whole sweep (eps, beta, labels bitwise;
    v exact); each fused chain equals its single-chain chunk."""
    for fn, whole, chains in (
            (tj.bayesr_jacobi_t_rounds, tj.bayesr_jacobi_t_reference, None),
            (tj.bayesr_jacobi_t_mc_rounds, tj.bayesr_jacobi_t_mc_reference,
             C)):
        c = _case(mode, chains=chains)
        ref = whole(*_port_args(c, c["rho"]), **_port_kw(c))
        res, v, bacc = _in_turn(fn, c, np.split(c["rho"], [3, 6]))
        for name in ("eps", "beta", "labels"):
            assert torch.equal(getattr(ref, name), getattr(res, name)), name
        assert torch.equal(ref.v, v)
        torch.testing.assert_close(ref.beta_acum, bacc, rtol=1e-5,
                                   atol=1e-7)
    mc = tj.bayesr_jacobi_t_mc_rounds(*_port_args(c, CHUNK), nr_total=NR,
                                      **_port_kw(c))
    for i in range(C):
        one = _chain(c, i)
        single = tj.bayesr_jacobi_t_rounds(*_port_args(one, CHUNK),
                                           nr_total=NR, **_port_kw(one))
        assert torch.equal(single.labels, mc.labels[i])
        torch.testing.assert_close(single.eps, mc.eps[i], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(single.beta, mc.beta[i], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("bad", ["nr_total", "empty", "long"])
def test_chunk_arguments_are_checked(bad):
    c = _case("fold")
    rho = {"nr_total": CHUNK, "empty": CHUNK[:0],
           "long": np.arange(NR + 1, dtype=np.int32)}[bad]
    nr = NR + 1 if bad == "nr_total" else NR
    for fn in (tj.bayesr_jacobi_t_rounds,
               tj.bayesr_jacobi_t_rounds_reference):
        with pytest.raises(ValueError):
            fn(*_port_args(c, rho), nr_total=nr, **_port_kw(c))
