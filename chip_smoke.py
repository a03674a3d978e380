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
   CSV widths, finiteness, tracked vs recomputed eps, and the launch count;
5. the horseshoe kernel against its plain version, one sweep on the same
   inputs and variates from a warm state: at N=4096 x M=8192 (plan J=32,
   B=32) beta and eps to rtol 1e-4 / atol 1e-5; at the headline, on the
   words of phase 2, |d eps| / |eps| and |d beta| / |beta| < 1e-4 (no label
   can flip here, so the bound is tighter than BayesR's);
6. horseshoe recovery: N=4096, M=2048, block_size 256, the
   tests/test_horseshoe.py:15-19 hyperparameters, through the kernel,
   posterior-mean corr > 0.8;
7. the horseshoe main path, biobank-horseshoe: ``HorseshoeSampler(words,
   Y, HorseshoeConfig(emit_epsilon=False), ...)`` then ``.run(generator,
   ChainConfig(30, 10, 10), sink=CSVSink(..., "horseshoe", ...))`` with the
   launch counter reset just before; checks CSV widths, finiteness, tau > 0,
   tracked vs recomputed eps and the launch count, then profiles two more
   steps for the dot / solve / apply split.

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
# (iterations, burn-in, thinning) of the horseshoe recovery chain: from its
# prior init, tau starts near 1e-7 at this size and some chains take a few
# hundred iterations to leave the collapsed mode (all signal in sigmaE)
HS_RECOVERY_CHAIN = (600, 300, 1)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def hs_sweep_args(s, st, v):
    """The horseshoe main path's sweep operands for state ``st`` with fresh
    variates from ``v`` (models/horseshoe.py:HorseshoeSampler.step)."""
    d = s.data
    rho, inner = v.orders(s.nb, s.B, s.jacobi)
    args = (d.XT, d.gram, d.xsq, st.eps, st.beta, rho, inner, v.z(s.Mpad),
            st.lam, st.tau, st.c2, st.sigmaE, d.valid)
    kw = dict(J=s.jacobi, x_mean=d.x_mean, x_scale=d.x_scale,
              x_xsum=d.x_colsum, fold_affine=True, row_valid=d.row_valid)
    return args, kw


def rel_err(a, b):
    import torch

    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


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
    kw = dict(transposed=True, x_dtype="2bit", x_stats=(means, sds),
              device="cuda")
    if isinstance(cfg, bt.HorseshoeConfig):
        return bt.HorseshoeSampler(words, Y, cfg, **kw)
    return bt.SpikeSlabSampler(words, Y, CVA, cfg, **kw)


def recovery_signal(torch, g, M, n_causal=32):
    beta_true = torch.zeros(M, device="cuda")
    beta_true[torch.randperm(M, generator=g, device="cuda")[:n_causal]] = 0.25
    return beta_true


def posterior_corr(torch, out, beta_true):
    return float(torch.corrcoef(torch.stack([
        torch.as_tensor(out["beta"].mean(axis=0), device="cuda"),
        beta_true]))[0, 1])


def main_path(torch, sampler, g, chain, schema, counter):
    """``sampler.run`` into a CSV sink with ``counter``'s launch count set
    to 0 just before; returns (state, rows, seconds, launches, peak GiB,
    CSV header, CSV row widths)."""
    from bayesrrcpp_tpu_torch.io.sink import CSVSink

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chain.csv")
        sink = CSVSink(path, schema, M=sampler.M, N=sampler.N,
                       emit_epsilon=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counter.launches = 0
        t0 = time.perf_counter()
        try:
            st, out = sampler.run(g, chain, sink=sink)
            torch.cuda.synchronize()
        finally:
            sink.close()
        wall = time.perf_counter() - t0
        launches = counter.launches
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(path) as f:
            header = f.readline().rstrip("\n").split(",")
            widths = [len(r.split(", ")) for r in f.read().split("\n") if r]
    return st, out, wall, launches, peak_gb, header, widths


def profile_split(torch, fn, names):
    """Device time per launch (us) and launch count of the kernels whose
    names contain each of ``names``, over one call of ``fn``, plus the
    total device time and the wall time (ms) of the call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    time_us = dict.fromkeys(names, 0.0)
    count = dict.fromkeys(names, 0)
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                      # host ops: their kernels count
        total_us += e.self_device_time_total
        for n in names:
            if n in e.key:
                time_us[n] += e.self_device_time_total
                count[n] += e.count
    split = {n: (time_us[n] / max(count[n], 1), count[n]) for n in names}
    return split, total_us / 1e3, wall_ms


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bayesrrcpp_tpu_torch as bt
    from bayesrrcpp_tpu_torch.ops import _cuda
    from bayesrrcpp_tpu_torch.ops.jacobi_t import (
        LAUNCHES_PER_ROUND, bayesr_jacobi_t, bayesr_jacobi_t_reference,
        horseshoe_jacobi_t, horseshoe_jacobi_t_reference)

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
    beta_true = recovery_signal(torch, gr, 2048)
    sr = packed_sampler(torch, bt, gr, 4096, 2048,
                        bt.BayesRConfig(block_size=256), signal=beta_true)
    check((sr.jacobi, sr.B) == (8, 32), "recovery plan")
    _, out = sr.run(gr, bt.ChainConfig(100, 60, 1))
    corr = posterior_corr(torch, out, beta_true)
    log(f"[3] recovery corr {corr:.4f}")
    check(corr > 0.8, f"recovery corr {corr}")
    del sr, out

    # ---- 4. the main path
    chain = bt.ChainConfig(30, 10, 10)
    st, out, wall, launches, peak_gb, header, widths = main_path(
        torch, s, g, chain, "bayesr", bayesr_jacobi_t)
    check(len(header) == 2 + 2 * s.M + 2, f"header width {len(header)}")
    check(widths == [len(header)] * 2, f"row widths {widths}")
    check(list(out["iteration"]) == [10, 20], f"{out['iteration']}")
    check(np_finite(out["sigmaE"]) and np_finite(out["beta"]),
          "non-finite sigmaE or beta")
    rel = rel_err(st.eps, s.refresh_eps(st).eps)
    want = LAUNCHES_PER_ROUND * nr * chain.max_iterations
    log(f"[4] main path: {wall / chain.max_iterations * 1e3:.2f} ms/iter "
        f"({wall:.2f} s for {chain.max_iterations} iterations incl. CSV), "
        f"setup {setup_s:.2f} s, peak {peak_gb:.2f} GiB, launches "
        f"{launches} (want {want}), tracked-vs-exact eps {rel:.3g}, "
        f"sigmaE {float(st.sigmaE):.5f}")
    check(rel < 1e-4, f"tracked eps vs recompute {rel}")
    check(launches == want, f"launches {launches} != {want}")
    bayesr_launches = launches
    del st, out

    # ---- 5a. horseshoe kernel vs plain, N=4096 x M=8192
    g = torch.Generator(device=dev).manual_seed(2)
    v = bt.TorchVariates(g)
    h = packed_sampler(torch, bt, g, 4096, 8192, bt.HorseshoeConfig())
    check((h.jacobi, h.B, h.jacobi_layout) == (32, 32, "t"),
          f"horseshoe plan {(h.jacobi, h.B, h.jacobi_layout)} at M=8192")
    st = h._run_steps(h.init(v), v, 3)
    args, kw = hs_sweep_args(h, st, v)
    (eps_k, beta_k), (eps_r, beta_r) = (horseshoe_jacobi_t(*args, **kw),
                                        horseshoe_jacobi_t_reference(*args,
                                                                     **kw))
    torch.cuda.synchronize()
    for name, a, b in (("beta", beta_k, beta_r), ("eps", eps_k, eps_r)):
        check(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
              f"horseshoe {name} differs at M=8192: max |d| "
              f"{float((a - b).abs().max())}")
    log(f"[5a] horseshoe N=4096 M=8192: max|d beta| "
        f"{float((beta_k - beta_r).abs().max()):.3g} max|d eps| "
        f"{float((eps_k - eps_r).abs().max()):.3g}")
    del h, st, args

    # ---- 5b. the horseshoe at the headline, on phase 2's words
    t0 = time.perf_counter()
    hs = bt.HorseshoeSampler(
        s.data.XT, s.Y[:s.N], bt.HorseshoeConfig(emit_epsilon=False),
        transposed=True, x_dtype="2bit",
        x_stats=bt.simulate.packed_word_stats(HEADLINE_M), device="cuda")
    torch.cuda.synchronize()
    hs_setup_s = time.perf_counter() - t0
    check(hs.data.XT.data_ptr() == s.data.XT.data_ptr(), "words copied")
    del s
    check((hs.jacobi, hs.B, hs.jacobi_layout, hs.Mpad) ==
          (128, 32, "t", HEADLINE_M), "horseshoe headline plan")
    g = torch.Generator(device=dev).manual_seed(3)
    v = bt.TorchVariates(g)
    st = hs._run_steps(hs.init(v), v, 2)
    args, kw = hs_sweep_args(hs, st, v)
    (eps_k, beta_k), hs_ms = timed(
        torch, lambda: horseshoe_jacobi_t(*args, **kw), 3)
    (eps_r, beta_r), hs_plain_ms = timed(
        torch, lambda: horseshoe_jacobi_t_reference(*args, **kw), 1)
    rel_eps, rel_beta = rel_err(eps_k, eps_r), rel_err(beta_k, beta_r)
    hs_err = max(float((eps_k - eps_r).abs().max()),
                 float((beta_k - beta_r).abs().max()))
    log(f"[5b] horseshoe headline: sampler on phase 2's words {hs_setup_s:.2f}"
        f" s; sweep kernel {hs_ms:.3f} ms, plain {hs_plain_ms:.1f} ms; "
        f"|d eps|/|eps| {rel_eps:.3g}, |d beta|/|beta| {rel_beta:.3g}, "
        f"max abs err {hs_err:.3g}")
    check(rel_eps < 1e-4, f"horseshoe headline eps rel diff {rel_eps}")
    check(rel_beta < 1e-4, f"horseshoe headline beta rel diff {rel_beta}")
    del st, args, eps_k, beta_k, eps_r, beta_r

    # ---- 6. horseshoe recovery through the kernel
    N6, M6, nc = 4096, 2048, 32
    gr = torch.Generator(device=dev).manual_seed(13)
    beta_true = recovery_signal(torch, gr, M6, nc)
    A = (1.0 / N6 ** 0.5) * nc / (M6 - nc)
    hr = packed_sampler(torch, bt, gr, N6, M6,
                        bt.HorseshoeConfig(A=A, block_size=256),
                        signal=beta_true)
    check((hr.jacobi, hr.B) == (8, 32), "horseshoe recovery plan")
    rchain = bt.ChainConfig(*HS_RECOVERY_CHAIN)
    t0 = time.perf_counter()
    _, out = hr.run(gr, rchain)
    corr = posterior_corr(torch, out, beta_true)
    log(f"[6] horseshoe recovery corr {corr:.4f} over {rchain} "
        f"({(time.perf_counter() - t0) / rchain.max_iterations * 1e3:.2f} "
        f"ms/iter), last tau {float(out['tau'][-1]):.3g}")
    check(corr > 0.8, f"horseshoe recovery corr {corr}")
    del hr, out

    # ---- 7. the horseshoe main path
    st, out, wall, hs_launches, hs_peak, header, widths = main_path(
        torch, hs, g, chain, "horseshoe", horseshoe_jacobi_t)
    check(len(header) == 2 + 2 * hs.M + 2, f"header width {len(header)}")
    check(widths == [len(header)] * 2, f"row widths {widths}")
    check(list(out["iteration"]) == [10, 20], f"{out['iteration']}")
    check(all(np_finite(out[k]) for k in ("mu", "beta", "sigmaE", "tau",
                                          "lambda")), "non-finite output")
    check(bool((out["tau"] > 0).all()), f"tau {out['tau']}")
    rel = rel_err(st.eps, hs.refresh_eps(st).eps)
    want = LAUNCHES_PER_ROUND * nr * chain.max_iterations
    log(f"[7] horseshoe main path: "
        f"{wall / chain.max_iterations * 1e3:.2f} ms/iter ({wall:.2f} s for "
        f"{chain.max_iterations} iterations incl. CSV), peak {hs_peak:.2f} "
        f"GiB, launches {hs_launches} (want {want}), tracked-vs-exact eps "
        f"{rel:.3g}, sigmaE {float(st.sigmaE):.5f}, tau {float(st.tau):.4g}")
    check(rel < 1e-4, f"horseshoe tracked eps vs recompute {rel}")
    check(hs_launches == want, f"horseshoe launches {hs_launches} != {want}")
    names = ("dot_kernel", "hs_solve_kernel", "apply_kernel")
    split, dev_ms, wall_ms = profile_split(
        torch, lambda: hs._run_steps(st, bt.TorchVariates(g), 2), names)
    check(all(c == 2 * nr and us > 0 for us, c in split.values()),
          f"profiled launches {split}")
    log("[7] profile of 2 steps: " + ", ".join(
        f"{n} {us:.2f} us x {c}" for n, (us, c) in split.items())
        + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall")

    src = "bayesrrcpp_tpu_torch/csrc/jacobi_t.cu"
    print(json.dumps({"kernels": [
        {"name": "jacobi_t_sweep", "route": "cuda", "source": src,
         "replaces": "bayesrrcpp_tpu/ops/pallas_jacobi_t.py:405",
         "launches": bayesr_launches, "max_abs_err": max_err, "ms": ker_ms,
         "plain_ms": plain_ms},
        {"name": "jacobi_t_hs_sweep", "route": "cuda", "source": src,
         "replaces": "bayesrrcpp_tpu/ops/pallas_jacobi_t.py:650",
         "launches": hs_launches, "max_abs_err": hs_err, "ms": hs_ms,
         "plain_ms": hs_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def np_finite(a):
    import numpy as np

    return bool(np.isfinite(np.asarray(a)).all())


if __name__ == "__main__":
    sys.exit(main())
