#!/usr/bin/env python3
"""Time the sweep kernels of one or more checkouts on one NVIDIA GPU, to
compare two versions of the kernels in one call.

    python3 bayesrrcpp_tpu_torch/tools/time_sweeps.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository.  Each runs in a
process of its own, in the order given (name each twice to interleave:
``parent change change parent``), builds the kernels from its own csrc/
and runs, at the headline shape N=100,352 x M=503,808 from states 2
steps warm, every sweep below.  Every process makes the same words, states
and variates from the same seeds, so two versions that keep the bits give
the same outputs: each case prints a hash of its outputs.

- ``t1_*``: the strided sweeps, one chain (csrc/jacobi_t.cu, sites #1/#2,
  plan J=128, B=32);
- ``t8_*``: 8 fused chains (csrc/jacobi_t_mc.cu, #3/#4);
- ``s1_*``: the serial sweeps (csrc/serial.cu, ``jacobi_blocks=1``: B=512,
  984 blocks, #9/#10), one chain; ``s8_*`` 8 fused chains (#11/#12);
- ``row_*``: the row layout (``jacobi_layout="row"``: J=32, B=128, #16/#15);
- ``t8miss_*``: the fused strided sweeps on words with missing calls at
  2^-6 (their ``miss`` mode);
- ``q_bayesr``: int8 codes of those words through the serial in-kernel
  decode (``_q``: the auto plan J=1, B=32), one chain.

Each case gives the milliseconds of ``REPS`` calls after one warm call (each
timed with CUDA events), then, from torch.profiler over one more call, the
device microseconds a launch and the launches of its dot, solve and apply
kernels (names containing "dot", "solve", "apply"), and, for the serial
and row sweeps, the share of steps that moved (beta changed) and the
dependent windows of the serial kernel's solve for those moves
(``ops/block_sweep.dependent_windows``, where the root has it: at most
W=32 steps a window for BayesR, one step a window for the horseshoe; a
root that keeps the bits moves the same steps).  ``--only P,Q`` runs only
the cases whose keys start with P or Q.  Each root prints one JSON line,
preceded by the card's nvidia-smi name and power limit; the script exits
non-zero if any process fails.  Imports torch only.
"""
import hashlib
import json
import os
import subprocess
import sys

N, M, CHAINS, REPS, W = 100_352, 503_808, 8, 3, 32
CVA = [0.0001, 0.001, 0.01]


def sweep_times(torch, fn, reps):
    """ms of each of ``reps`` calls of ``fn`` after one warm call, and the
    last call's outputs."""
    out = fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


def split(torch, fn):
    """{dot, solve, apply}: (device us a launch, launches) over one call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    us = {"dot": [0.0, 0], "solve": [0.0, 0], "apply": [0.0, 0]}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in us:
            if n in e.key:
                us[n][0] += e.self_device_time_total
                us[n][1] += e.count
    return {n: [t / max(c, 1), c] for n, (t, c) in us.items()}


def digest(out):
    h = hashlib.sha256()
    for t in out:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def visit_moves(torch, beta_out, beta_in, border, inner, B):
    """(nb, B) moved flags of a serial sweep in visit order (one chain)."""
    moved = (beta_out != beta_in).reshape(-1, B)
    return torch.gather(moved[border.long()], 1, inner[border.long()].long())


ONLY = ()   # key prefixes to run (--only); empty: every case


def wanted(*keys):
    return not ONLY or any(k.startswith(ONLY) for k in keys)


def run_case(torch, out, key, fn, serial=None):
    if not wanted(key):
        return
    times, res = sweep_times(torch, fn, REPS)
    rec = {"ms": times, "split": split(torch, fn), "hash": digest(res)}
    if serial is not None:
        beta_in, border, inner, B = serial
        beta_out = res[1]
        lead = beta_out if beta_out.dim() == 2 else beta_out[None]
        lin = beta_in if beta_in.dim() == 2 else beta_in[None]
        moved = [visit_moves(torch, o, i, border, inner, B)
                 for o, i in zip(lead, lin)]
        rec["moved_share"] = sum(float(m.float().mean())
                                 for m in moved) / len(moved)
        try:   # a checkout from before the windowed solve has no count
            from bayesrrcpp_tpu_torch.ops.block_sweep import \
                dependent_windows
        except ImportError:
            dependent_windows = None
        if dependent_windows is not None:   # the horseshoe: a step each
            w = 1 if key.endswith("horseshoe") else W
            rec["windows"] = sum(dependent_windows(m, w)
                                 for m in moved) / len(moved)
    out[key] = rec
    print(json.dumps({key: rec}), file=sys.stderr, flush=True)


def run_one(root):
    """Time every case with the package of checkout ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import bayesrrcpp_tpu_torch as bt
    from bayesrrcpp_tpu_torch.ops import _cuda
    from bayesrrcpp_tpu_torch.ops import jacobi as jr
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
    from bayesrrcpp_tpu_torch.ops import multichain as mcs
    from bayesrrcpp_tpu_torch.ops import serial as ser
    from bayesrrcpp_tpu_torch.ops.genotypes import decode_codes

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    check = os.path.dirname(os.path.abspath(bt.__file__))
    if check != os.path.join(os.path.abspath(root), "bayesrrcpp_tpu_torch"):
        raise RuntimeError(f"imported {check}, not {root}'s package")
    _cuda.libraries("jacobi_t", "jacobi_t_mc", "serial")
    out = {"root": root}
    g = torch.Generator(device="cuda").manual_seed(0)
    words = bt.simulate.random_packed_words(g, M, N // 16, device="cuda")
    stats = bt.simulate.packed_word_stats(M)
    Y = torch.randn(N, generator=g, device="cuda")
    kw = dict(transposed=True, x_dtype="2bit", x_stats=stats, device="cuda")

    def make(kind, X, **plan):
        if kind == "bayesr":
            return bt.SpikeSlabSampler(X, Y, CVA, bt.BayesRConfig(), **kw,
                                       **plan)
        return bt.HorseshoeSampler(X, Y, bt.HorseshoeConfig(), **kw, **plan)

    def strided(kind, s, chains, tag):
        d = s.data
        gs = torch.Generator(device="cuda").manual_seed(1)
        v = bt.TorchVariates(gs, chains=chains)
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
        skw = dict(s._sweep_kw(), J=s.jacobi)
        run_case(torch, out, f"{tag}_{kind}",
                 lambda: tuple(fn(*args, **skw)))

    def serial(kind, s, chains, tag, fns, J=None):
        d = s.data
        gs = torch.Generator(device="cuda").manual_seed(2)
        v = bt.TorchVariates(gs, chains=chains)
        st = s.init(v, chains=chains)
        for _ in range(2):
            st = s.step(st, v) if chains is None else s.step_chains(st, v)
        border, inner = v.block_orders(s.nb, s.B)
        z = v.z(s.Mpad)
        fn = fns[kind]
        if kind == "bayesr":
            args = (d.XT, d.gram, d.xsq, st.eps, st.beta, st.labels, border,
                    inner, v.p(s.Mpad), z, st.pi, d.cva, st.sigmaE,
                    st.sigmaGG, d.g_assign, d.valid)
        else:
            args = (d.XT, d.gram, d.xsq, st.eps, st.beta, border, inner, z,
                    st.lam, st.tau, st.c2, st.sigmaE, d.valid)
        skw = s._sweep_kw() if J is None else dict(s._sweep_kw(), J=J)
        run_case(torch, out, f"{tag}_{kind}",
                 lambda: tuple(fn(*args, **skw)),
                 serial=(st.beta, border, inner, s.B))

    for kind in ("bayesr", "horseshoe"):
        if wanted(f"t1_{kind}", f"t8_{kind}"):
            s = make(kind, words)
            assert (s.jacobi, s.B) == (128, 32), (s.jacobi, s.B)
            strided(kind, s, None, "t1")
            strided(kind, s, CHAINS, "t8")
            del s
        if wanted(f"s1_{kind}", f"s8_{kind}"):
            s = make(kind, words, jacobi_blocks=1)
            assert (s.jacobi, s.B, s.nb) == (1, 512, 984)
            serial(kind, s, None, "s1", {"bayesr": ser.bayesr_sweep,
                                         "horseshoe": ser.horseshoe_sweep})
            serial(kind, s, CHAINS, "s8",
                   {"bayesr": mcs.bayesr_sweep_mc,
                    "horseshoe": mcs.horseshoe_sweep_mc})
            del s
        if wanted(f"row_{kind}"):
            s = make(kind, words, jacobi_layout="row")
            assert (s.jacobi, s.B) == (32, 128), (s.jacobi, s.B)
            serial(kind, s, None, "row", {"bayesr": jr.bayesr_jacobi,
                                          "horseshoe": jr.horseshoe_jacobi},
                   J=s.jacobi)
            del s
    del words
    torch.cuda.empty_cache()
    if not wanted("t8miss_bayesr", "t8miss_horseshoe", "q_bayesr"):
        print(json.dumps(out), flush=True)
        return

    g = torch.Generator(device="cuda").manual_seed(3)
    words = bt.simulate.random_packed_words_missing(g, M, N // 16,
                                                    device="cuda")
    for kind in ("bayesr", "horseshoe"):
        if wanted(f"t8miss_{kind}"):
            s = make(kind, words)
            assert (s.jacobi, s.B, s.data.has_missing) == (128, 32, True)
            strided(kind, s, CHAINS, "t8miss")
            del s
    if not wanted("q_bayesr"):
        print(json.dumps(out), flush=True)
        return
    codes = torch.empty((M, N), dtype=torch.int8, device="cuda")
    for a in range(0, M, 2048):
        codes[a:a + 2048] = decode_codes(words[a:a + 2048])[:, :N]
    del words
    torch.cuda.empty_cache()
    kw["x_dtype"] = "int8"
    s = make("bayesr", codes)
    assert (s.jacobi, s.B, s.data.has_missing) == (1, 32, True)
    serial("bayesr", s, None, "q", {"bayesr": ser.bayesr_sweep})
    print(json.dumps(out), flush=True)


def main(roots):
    only = []
    if roots[:1] == ["--only"]:
        only, roots = ["--only", roots[1]], roots[2:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for root in roots:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root, *only]).returncode
        if rc != 0:
            print(f"time_sweeps: {root} failed ({rc})", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        if sys.argv[3:4] == ["--only"]:
            ONLY = tuple(sys.argv[4].split(","))
        run_one(sys.argv[2])
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
