#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (bayesrrcpp_tpu_torch) on one
NVIDIA GPU.

Run from the root of a checkout, with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card (nvidia-smi name and power limit) and the nvcc build of
   bayesrrcpp_tpu_torch/csrc/jacobi_t.cu for sm_90a;
2. the kernel against its plain torch version, one sweep on the same inputs
   and variates from a warm state: at N=4096 x M=8192 (plan J=32, B=32)
   labels and v equal, beta and eps to rtol 1e-4 / atol 1e-5; at the
   headline N=100,352 x M=503,808 (plan J=128, B=32) labels agreeing on
   >= 99.9% of markers and |d eps| / |eps| < 1e-3 (a near-tie label flip
   from another summation order changes later steps of its block);
3. recovery: the tests/test_layout.py:134-152 recipe (N=4096, M=2048,
   block_size 256) through the kernel, posterior-mean corr > 0.8;
4. the main path, biobank-packed-auto: ``SpikeSlabSampler(words, Y, cva,
   BayesRConfig(emit_epsilon=False), x_dtype="2bit", transposed=True,
   x_stats=...)`` then ``.run(generator, ChainConfig(30, 10, 10),
   sink=CSVSink(...))`` with the launch counter reset just before; checks
   CSV widths, finiteness, tracked vs recomputed eps, and the launch count.

The last two lines of standard output are the kernels' JSON record and the
device JSON.  Nothing of JAX is imported.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

CVA = [0.0001, 0.001, 0.01]
HEADLINE_N, HEADLINE_M = 100_352, 503_808


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def sweep_args(s, st, v):
    """The main path's sweep operands for state ``st`` with fresh
    variates from ``v`` (models/bayesr.py:SpikeSlabSampler.step)."""
    d = s.data
    rho, inner = v.orders(s.nb, s.B, s.jacobi)
    args = (d.XT, d.gram, d.xsq, st.eps, st.beta, st.labels, rho, inner,
            v.p(s.Mpad), v.z(s.Mpad), st.pi, d.cva, st.sigmaE, st.sigmaGG,
            d.g_assign, d.valid)
    kw = dict(J=s.jacobi, x_mean=d.x_mean, x_scale=d.x_scale,
              x_xsum=d.x_colsum, fold_affine=True, row_valid=d.row_valid)
    return args, kw


def timed(torch, fn, reps):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def packed_sampler(torch, bt, g, N, M, cfg, signal=None):
    words = bt.simulate.random_packed_words(g, M, N // 16, device="cuda")
    means, sds = bt.simulate.packed_word_stats(M)
    Y = torch.randn(N, generator=g, device="cuda")
    if signal is not None:
        from bayesrrcpp_tpu_torch.ops.genotypes import xbeta_packed

        f32 = torch.float32
        Y = 0.7 * Y + xbeta_packed(
            words, torch.as_tensor(means, dtype=f32, device="cuda"),
            torch.as_tensor(1.0 / sds, dtype=f32, device="cuda"), signal,
            256, N)
    return bt.SpikeSlabSampler(words, Y, CVA, cfg, transposed=True,
                               x_dtype="2bit", x_stats=(means, sds),
                               device="cuda")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bayesrrcpp_tpu_torch as bt
    from bayesrrcpp_tpu_torch.io.sink import CSVSink
    from bayesrrcpp_tpu_torch.ops import _cuda
    from bayesrrcpp_tpu_torch.ops.jacobi_t import (
        LAUNCHES_PER_ROUND, bayesr_jacobi_t, bayesr_jacobi_t_reference)

    # ---- 1. the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    lib = _cuda.library("jacobi_t")
    log(f"[1] built {os.path.basename(lib.path)} in "
        f"{lib.build_seconds:.1f} s")
    log(lib.build_log.strip())
    dev = torch.device("cuda")

    # ---- 2a. kernel vs plain, N=4096 x M=8192
    g = torch.Generator(device=dev).manual_seed(1)
    v = bt.TorchVariates(g)
    s = packed_sampler(torch, bt, g, 4096, 8192, bt.BayesRConfig())
    check((s.jacobi, s.B, s.jacobi_layout) == (32, 32, "t"),
          f"plan {(s.jacobi, s.B, s.jacobi_layout)} at M=8192")
    st = s._run_steps(s.init(v), v, 3)
    args, kw = sweep_args(s, st, v)
    ker = bayesr_jacobi_t(*args, **kw)
    ref = bayesr_jacobi_t_reference(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(ker.labels, ref.labels), "labels differ at M=8192")
    check(torch.equal(ker.v, ref.v), f"v differ: {ker.v} vs {ref.v}")
    for name in ("beta", "eps", "beta_acum"):
        a, b = getattr(ker, name), getattr(ref, name)
        check(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
              f"{name} differs at M=8192: max |d| "
              f"{float((a - b).abs().max())}")
    log(f"[2a] N=4096 M=8192: labels/v equal, max|d beta| "
        f"{float((ker.beta - ref.beta).abs().max()):.3g} max|d eps| "
        f"{float((ker.eps - ref.eps).abs().max()):.3g}")
    del s, st, args, ker, ref

    # ---- 2b. the headline shape: setup, then kernel vs plain
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(0)
    v = bt.TorchVariates(g)
    t0 = time.perf_counter()
    s = packed_sampler(torch, bt, g, HEADLINE_N, HEADLINE_M,
                       bt.BayesRConfig(emit_epsilon=False))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check((s.jacobi, s.B, s.jacobi_layout, s.Mpad) ==
          (128, 32, "t", HEADLINE_M), "headline plan")
    nr = s.nb // s.jacobi
    log(f"[2b] headline setup (words + stats) {setup_s:.2f} s, nb={s.nb} "
        f"nr={nr}")
    st = s._run_steps(s.init(v), v, 2)
    args, kw = sweep_args(s, st, v)
    ker, ker_ms = timed(torch, lambda: bayesr_jacobi_t(*args, **kw), 3)
    ref, plain_ms = timed(torch,
                          lambda: bayesr_jacobi_t_reference(*args, **kw), 1)
    agree = float((ker.labels == ref.labels).float().mean())
    rel_eps = float(torch.linalg.norm(ker.eps - ref.eps)
                    / torch.linalg.norm(ref.eps))
    max_err = max(float((ker.eps - ref.eps).abs().max()),
                  float((ker.beta - ref.beta).abs().max()))
    log(f"[2b] headline sweep: kernel {ker_ms:.3f} ms, plain {plain_ms:.1f} "
        f"ms; label agreement {agree:.6f}, |d eps|/|eps| {rel_eps:.3g}, "
        f"max abs err {max_err:.3g}")
    check(agree >= 0.999, f"headline label agreement {agree}")
    check(rel_eps < 1e-3, f"headline eps rel diff {rel_eps}")
    del args, ker, ref

    # ---- 3. recovery through the kernel
    gr = torch.Generator(device=dev).manual_seed(13)
    beta_true = torch.zeros(2048, device=dev)
    beta_true[torch.randperm(2048, generator=gr, device=dev)[:32]] = 0.25
    sr = packed_sampler(torch, bt, gr, 4096, 2048,
                        bt.BayesRConfig(block_size=256), signal=beta_true)
    check((sr.jacobi, sr.B) == (8, 32), "recovery plan")
    _, out = sr.run(gr, bt.ChainConfig(100, 60, 1))
    corr = float(torch.corrcoef(torch.stack([
        torch.as_tensor(out["beta"].mean(axis=0), device=dev),
        beta_true]))[0, 1])
    log(f"[3] recovery corr {corr:.4f}")
    check(corr > 0.8, f"recovery corr {corr}")
    del sr, out

    # ---- 4. the main path
    chain = bt.ChainConfig(30, 10, 10)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chain.csv")
        sink = CSVSink(path, "bayesr", M=s.M, N=s.N, emit_epsilon=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bayesr_jacobi_t.launches = 0
        t0 = time.perf_counter()
        try:
            st, out = s.run(g, chain, sink=sink)
            torch.cuda.synchronize()
        finally:
            sink.close()
        wall = time.perf_counter() - t0
        launches = bayesr_jacobi_t.launches
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(path) as f:
            header = f.readline().rstrip("\n").split(",")
            widths = [len(r.split(", ")) for r in f.read().split("\n") if r]
    check(len(header) == 2 + 2 * s.M + 2, f"header width {len(header)}")
    check(widths == [len(header)] * 2, f"row widths {widths}")
    check(list(out["iteration"]) == [10, 20], f"{out['iteration']}")
    check(np_finite(out["sigmaE"]) and np_finite(out["beta"]),
          "non-finite sigmaE or beta")
    ex = s.refresh_eps(st)
    rel = float(torch.linalg.norm(st.eps - ex.eps)
                / torch.linalg.norm(ex.eps))
    want = LAUNCHES_PER_ROUND * nr * chain.max_iterations
    log(f"[4] main path: {wall / chain.max_iterations * 1e3:.2f} ms/iter "
        f"({wall:.2f} s for {chain.max_iterations} iterations incl. CSV), "
        f"setup {setup_s:.2f} s, peak {peak_gb:.2f} GiB, launches "
        f"{launches} (want {want}), tracked-vs-exact eps {rel:.3g}, "
        f"sigmaE {float(st.sigmaE):.5f}")
    check(rel < 1e-4, f"tracked eps vs recompute {rel}")
    check(launches == want, f"launches {launches} != {want}")

    print(json.dumps({"kernels": [{
        "name": "jacobi_t_sweep", "route": "cuda",
        "source": "bayesrrcpp_tpu_torch/csrc/jacobi_t.cu",
        "replaces": "bayesrrcpp_tpu/ops/pallas_jacobi_t.py:405",
        "launches": launches, "max_abs_err": max_err, "ms": ker_ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def np_finite(a):
    import numpy as np

    return bool(np.isfinite(np.asarray(a)).all())


if __name__ == "__main__":
    sys.exit(main())
