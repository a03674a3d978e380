#!/usr/bin/env python3
"""Time the strided-rounds and serial sweep kernels of one or more
checkouts on one NVIDIA GPU, to compare two versions of the kernels in one
call.

    python3 bayesrrcpp_tpu_torch/tools/time_sweeps.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository.  Each runs in a
process of its own, in the order given (name each twice to interleave:
``parent change change parent``), builds the kernels from its own csrc/
and times, with CUDA events, the four strided sweeps at the headline shape
N=100,352 x M=503,808 (plan J=128, B=32) from a state 2 steps warm:
BayesR and the horseshoe, one chain (csrc/jacobi_t.cu) and 8 fused chains
(csrc/jacobi_t_mc.cu); then the two serial sweeps (csrc/serial.cu,
``jacobi_blocks=1``: B=512, 984 blocks) on the same words, one chain,
from a state 2 steps warm.  Every process makes the same words and variates
from the same seeds.  Each prints one JSON line with the milliseconds of
each sweep (``reps`` calls after one warm call, each call timed on its
own), preceded by the card's nvidia-smi name and power limit; the script
exits non-zero if any process fails.  Imports torch only.
"""
import json
import os
import subprocess
import sys

N, M, CHAINS, REPS = 100_352, 503_808, 8, 5
CVA = [0.0001, 0.001, 0.01]


def sweep_times(torch, fn, reps):
    """ms of each of ``reps`` calls of ``fn`` after one warm call."""
    fn()
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def run_one(root):
    """Time the four sweeps with the package of checkout ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import bayesrrcpp_tpu_torch as bt
    from bayesrrcpp_tpu_torch.ops import _cuda
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    check = os.path.dirname(os.path.abspath(bt.__file__))
    if check != os.path.join(os.path.abspath(root), "bayesrrcpp_tpu_torch"):
        raise RuntimeError(f"imported {check}, not {root}'s package")
    from bayesrrcpp_tpu_torch.ops import serial

    _cuda.libraries("jacobi_t", "jacobi_t_mc", "serial")
    g = torch.Generator(device="cuda").manual_seed(0)
    words = bt.simulate.random_packed_words(g, M, N // 16, device="cuda")
    stats = bt.simulate.packed_word_stats(M)
    Y = torch.randn(N, generator=g, device="cuda")
    kw = dict(transposed=True, x_dtype="2bit", x_stats=stats, device="cuda")
    samplers = {
        "bayesr": bt.SpikeSlabSampler(words, Y, CVA, bt.BayesRConfig(), **kw),
        "horseshoe": bt.HorseshoeSampler(words, Y, bt.HorseshoeConfig(),
                                         **kw)}
    out = {"root": root}
    for kind, s in samplers.items():
        if (s.jacobi, s.B) != (128, 32):
            raise RuntimeError(f"{kind} plan {(s.jacobi, s.B)}")
        d = s.data
        fold = dict(J=s.jacobi, x_mean=d.x_mean, x_scale=d.x_scale,
                    x_xsum=d.x_colsum, fold_affine=True,
                    row_valid=d.row_valid)
        for chains in (None, CHAINS):
            g = torch.Generator(device="cuda").manual_seed(1)
            v = bt.TorchVariates(g, chains=chains)
            st = s.init(v, chains=chains)
            for _ in range(2):
                st = s.step(st, v) if chains is None else s.step_chains(st, v)
            rho, inner = v.orders(s.nb, s.B, s.jacobi)
            z = v.z(s.Mpad)
            if kind == "bayesr":
                fn = jt.bayesr_jacobi_t if chains is None else \
                    jt.bayesr_jacobi_t_mc
                args = (d.XT, d.gram, d.xsq, st.eps, st.beta, st.labels, rho,
                        inner, v.p(s.Mpad), z, st.pi, d.cva, st.sigmaE,
                        st.sigmaGG, d.g_assign, d.valid)
            else:
                fn = jt.horseshoe_jacobi_t if chains is None else \
                    jt.horseshoe_jacobi_t_mc
                args = (d.XT, d.gram, d.xsq, st.eps, st.beta, rho, inner, z,
                        st.lam, st.tau, st.c2, st.sigmaE, d.valid)
            key = kind + ("" if chains is None else f"_mc{chains}")
            out[key + "_ms"] = sweep_times(torch, lambda: fn(*args, **fold),
                                           REPS)
        del s
    samplers.clear()
    kw["jacobi_blocks"] = 1
    for kind in ("bayesr", "horseshoe"):
        s = (bt.SpikeSlabSampler(words, Y, CVA, bt.BayesRConfig(), **kw)
             if kind == "bayesr" else
             bt.HorseshoeSampler(words, Y, bt.HorseshoeConfig(), **kw))
        if (s.jacobi, s.B, s.nb) != (1, 512, 984):
            raise RuntimeError(f"{kind} serial plan {(s.jacobi, s.B)}")
        d = s.data
        v = bt.TorchVariates(torch.Generator(device="cuda").manual_seed(2))
        st = s._run_steps(s.init(v), v, 2)
        border, inner = v.block_orders(s.nb, s.B)
        z = v.z(s.Mpad)
        if kind == "bayesr":
            fn = serial.bayesr_sweep
            args = (d.XT, d.gram, d.xsq, st.eps, st.beta, st.labels, border,
                    inner, v.p(s.Mpad), z, st.pi, d.cva, st.sigmaE,
                    st.sigmaGG, d.g_assign, d.valid)
        else:
            fn = serial.horseshoe_sweep
            args = (d.XT, d.gram, d.xsq, st.eps, st.beta, border, inner, z,
                    st.lam, st.tau, st.c2, st.sigmaE, d.valid)
        out[kind + "_serial_ms"] = sweep_times(
            torch, lambda: fn(*args, **s._sweep_kw()), REPS)
        del s
    print(json.dumps(out), flush=True)


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for root in roots:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root]).returncode
        if rc != 0:
            print(f"time_sweeps: {root} failed ({rc})", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        run_one(sys.argv[2])
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
