#!/usr/bin/env python3
"""Time the sweep kernels of one or more checkouts on one NVIDIA GPU, to
compare two versions of the kernels in one call.

    python3 bayesrrcpp_tpu_torch/tools/time_sweeps.py [--only P,Q] \
        [--clocks] ROOT [ROOT ...]

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
  ``srow8_*``: 8 fused chains of that row plan, the path of its
  ``run_chains``: the serial fused sweep (#11/#12) at B=128, 3,936 blocks;
- ``d1_*``, ``d8_*``, ``ds1_*``, ``drow_*``: the same sweeps on dense f32
  rows at the dense cell's shape N=16,384 x M=49,152 (X built on the card
  from a seed, as chip_smoke.py's ``dense_sampler``): strided one chain
  (J=128, B=32) and 8 fused, serial (``jacobi_blocks=1``) and row;
- ``i1_*``, ``i8_*``, ``irow_*``: int8 codes of the headline words (no
  missing calls; 47 GiB on the card, no copy) through the strided sweeps,
  one chain and 8 fused, and the row layout;
- ``t1miss_*`` / ``t8miss_*``: the strided sweeps, one chain and 8 fused,
  on words with missing calls at 2^-6 (their ``miss`` mode);
- ``c1_bayesr`` / ``c1miss_bayesr``: one chain through the fused BayesR
  sweep (csrc/jacobi_t_mc.cu at C=1), on the words without and with
  missing calls: whatever dot the fused sweep runs for one chain, beside
  ``t1_*``'s;
- ``q_bayesr`` / ``q_horseshoe``: int8 codes of those words through the
  serial in-kernel decode (``_q``: the auto plan J=1, B=32, #9 / #10), one
  chain;
- ``s1q_*``: those words through the serial 2-bit in-kernel decode
  (``jacobi_blocks=1``: B=512, 984 blocks, #9 / #10 ``_q``), one chain.

Each case gives the milliseconds of ``REPS`` calls after one warm call (each
timed with CUDA events), then, from torch.profiler over one more call, the
device microseconds a launch and the launches of its dot, solve and apply
kernels (names containing "dot", "solve", "apply"), and, for the serial
and row sweeps, the share of steps that moved (beta changed) and the
dependent windows of the serial kernel's solve for those moves
(``ops/block_sweep.dependent_windows``, where the root has it: at most
W=32 steps a window for BayesR, one step a window for the horseshoe; a
root that keeps the bits moves the same steps).  Every case gives
``bound_us``, the dot's and the apply's bound a launch (a round; a block
at J=1; ``tools/kernel_bounds``, the apply over the rows that moved in the
case's call).  The dense cases and ``t1_horseshoe`` also give
``library_us``, one PyTorch call computing a round's apply on the same
rows and d (``torch.addmv``, ``torch.addmm`` for 8 chains: eps - d.X over
the round's rows gathered once, 2-bit codes decoded to f32 first, never
called by the port), and the ``miss`` cases ``miss_div``: the iterations a row a warp of the fused
dot's indicator pass (the most set fields among the warp's 32 words of
the row), mean and worst over the warps of 512 blocks, against the mean
set fields, at the words' 2^-6 and at 2^-5 (~3 %, the tests').
The strided cases also give ``bound_us["solve"]`` (the solve's bound a
round at the case's movers, ``kernel_bounds.strided_solve_round``),
``moved_share`` and ``passes_per_block``: the strided BayesR solve's
passes (a pass a mover, and one more where steps follow the last mover),
per chain, and ``passes_max``: the most passes of a round's J blocks (a
launch waits for its slowest block), mean over the rounds.  ``--clocks``
builds every root's kernels with ``-DJT_SOLVE_CLOCKS`` (a root whose
csrc/ has the stamps) and adds to each strided case ``solve_clocks``: the
mean cycles a warp of the solves' loads, table build, steps and epilogue
over the profiled call (times of such a build carry the stamps' cost).
``--only P,Q`` runs only
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
DENSE_N, DENSE_M = 16_384, 49_152   # the dense cell, dense-16kx49k
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


def call_us(torch, fn, reps=20):
    """Device us of one call of ``fn``, over ``reps`` calls after a warm
    one, by CUDA events."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def apply_yardstick(torch, X, rows, d, eps):
    """us of one PyTorch call computing a round's apply, eps - d.X[rows]
    (``torch.addmv``; ``torch.addmm`` for a chain axis), on the round's f32
    rows gathered once beforehand."""
    R = X[rows].contiguous()
    if d.dim() == 1:
        return call_us(torch, lambda: torch.addmv(eps, R.t(), d, alpha=-1))
    return call_us(torch, lambda: torch.addmm(eps, d, R, alpha=-1))


def popcount16(torch, m):
    """Set fields of each word's miss bits (bit 2k for field k)."""
    m = m.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(m)
    for k in range(16):
        n += (m >> (2 * k)) & 1
    return n


def miss_divergence(torch, words, B, nblocks=512):
    """The fused miss dot's indicator pass on the first ``nblocks`` blocks
    of B rows of ``words``: per (warp of 32 words, row) the iterations of
    the slowest lane (its set fields), per warp their mean over the rows;
    returns the mean and the worst warp's, and the mean set fields of a
    (word, row) (what a warp would take with no divergence)."""
    it, ideal = [], []
    for b0 in range(0, nblocks, 64):
        w = words[b0 * B:(b0 + 64) * B]
        w = w[:, :w.shape[1] // 32 * 32]
        cnt = popcount16(torch, w & (w >> 1) & 0x55555555)
        cnt = cnt.view(-1, B, w.shape[1] // 32, 32)     # block, row, warp, lane
        it.append(cnt.amax(-1).float().mean(1).flatten())
        ideal.append(cnt.float().mean())
    it = torch.cat(it)
    return {"iter_row_mean": float(it.mean()), "iter_row_worst":
            float(it.max()), "set_fields_mean": float(torch.stack(
                ideal).mean())}


def dense_words(torch, g, N, M):
    """Dense X (M, N) f32 on the card from generator ``g``, as chip_smoke.py's
    ``dense_sampler``: per marker p ~ U(0.1, 0.9), dosages Binomial(2, p),
    each row standardized (ddof 1); and Y ~ N(0, 1)."""
    X = torch.empty((M, N), device="cuda")
    for a in range(0, M, 4096):
        b = min(a + 4096, M)
        p = 0.1 + 0.8 * torch.rand((b - a, 1), generator=g, device="cuda")
        x = ((torch.rand((b - a, N), generator=g, device="cuda") < p).float()
             + (torch.rand((b - a, N), generator=g, device="cuda") < p))
        x -= x.mean(dim=1, keepdim=True)
        x /= x.std(dim=1, keepdim=True).clamp_min(1e-12)
        X[a:b] = x
    return X, torch.randn(N, generator=g, device="cuda")


def digest(out):
    h = hashlib.sha256()
    for t in out:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def visit_moves(torch, beta_out, beta_in, border, inner, B):
    """(nb, B) moved flags of a serial sweep in visit order (one chain)."""
    moved = (beta_out != beta_in).reshape(-1, B)
    return torch.gather(moved[border.long()], 1, inner[border.long()].long())


def block_passes(torch, moved):
    """The strided BayesR solve's passes of each block, from its (nb, B)
    moved flags in visit order: one a mover, and one more where steps
    follow the last mover (or none moves)."""
    B = moved.shape[1]
    at = torch.arange(B, device=moved.device)
    last = torch.where(moved, at, -1).amax(1)
    return moved.sum(1) + (last < B - 1)


def own_bounds():
    """tools/kernel_bounds.py beside this script (every root's cases get
    the same bounds, whatever its own copy holds)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "kernel_bounds", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "kernel_bounds.py"))
    kb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kb)
    return kb


ONLY = ()   # key prefixes to run (--only); empty: every case
CLOCKS = False   # --clocks: the strided solves' clock64 stamps


def solve_clocks(torch):
    """The strided solves' phase cycles since the last call, from a build
    with -DJT_SOLVE_CLOCKS (csrc/jacobi_t_common.cuh:clock_report), both
    libraries summed: per solve that ran, the mean cycles a warp of its
    loads, table build, steps, epilogue and total, and the warps; None for
    a root whose kernels have no stamps."""
    import ctypes

    from bayesrrcpp_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    tot = [0] * 12
    for name in ("jacobi_t", "jacobi_t_mc"):
        lib = _cuda.library(name)
        fn = getattr(lib.lib, f"{name}_solve_clocks", None)
        if fn is None:
            return None
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        buf = (ctypes.c_uint64 * 12)()
        lib.check(fn(ctypes.addressof(buf)), "solve clocks")
        tot = [a + b for a, b in zip(tot, buf)]
    res = {}
    for kind, c in (("bayesr", tot[:6]), ("horseshoe", tot[6:])):
        if c[5]:
            res[kind] = {**{p: c[i] / c[5] for i, p in enumerate(
                ("loads", "table", "steps", "epilogue", "total"))},
                "warps": c[5]}
    return res


def wanted(*keys):
    return not ONLY or any(k.startswith(ONLY) for k in keys)


def run_case(torch, out, key, fn, serial=None, extra=None):
    """Time case ``key``; ``extra(res)`` adds entries from its outputs."""
    if not wanted(key):
        return
    times, res = sweep_times(torch, fn, REPS)
    if CLOCKS:
        solve_clocks(torch)
    rec = {"ms": times, "split": split(torch, fn), "hash": digest(res)}
    if CLOCKS:
        rec["solve_clocks"] = solve_clocks(torch)
    if extra is not None:
        rec.update(extra(res))
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
    if CLOCKS:
        _cuda.NVCC_FLAGS = [*_cuda.NVCC_FLAGS, "-DJT_SOLVE_CLOCKS"]
    _cuda.libraries("jacobi_t", "jacobi_t_mc", "serial")
    out = {"root": root}
    g = torch.Generator(device="cuda").manual_seed(0)
    words = bt.simulate.random_packed_words(g, M, N // 16, device="cuda")
    stats = bt.simulate.packed_word_stats(M)
    Y = torch.randn(N, generator=g, device="cuda")
    kw = dict(transposed=True, x_dtype="2bit", x_stats=stats, device="cuda")

    def make(kind, X, y=Y, skw=kw, **plan):
        if kind == "bayesr":
            return bt.SpikeSlabSampler(X, y, CVA, bt.BayesRConfig(), **skw,
                                       **plan)
        return bt.HorseshoeSampler(X, y, bt.HorseshoeConfig(), **skw,
                                   **plan)

    def yard(kind, s, rows, beta_in, miss_per_row=0.0, J=None):
        """``extra`` of a case: the dot's and the apply's bounds a round of
        J blocks (s.jacobi; a block at J=1; ``tools/kernel_bounds``: the
        apply over the rows moved a round in any chain and, in the miss
        mode, their missing calls, ``miss_per_row`` a row; the in-kernel
        decode's (c - mean)*scale on every code read) and, for dense rows
        and the single-chain 2-bit horseshoe, the apply's library call on
        the ``rows`` of its first round, d from the case's own beta (2-bit
        codes decoded to f32 first)."""
        kb = own_bounds()
        J = s.jacobi if J is None else J
        nr, jb = s.nb // J, J * s.B
        decode = s._sweep_kw().get("fold_affine") is False and s.jacobi == 1

        def extra(res):
            moved = res[1] != beta_in
            chains = 1 if moved.dim() == 1 else moved.shape[0]
            moved_rows = float((moved if chains == 1 else moved.any(0)).sum())
            per_round = moved_rows / nr
            if s.x_packed:
                dot = kb.dot_round(s.Npad, jb, chains, 0.25,
                                   chains * miss_per_row * jb, decode=decode)
                apply = kb.apply_round(s.Npad, per_round, chains,
                                       per_round * miss_per_row,
                                       decode=decode)
            else:
                eb = 1 if s.x_int8 else 4
                dot = kb.dot_round(s.N, jb, chains, eb)
                apply = kb.row_apply_round(s.N, per_round, chains, eb)
            rec = {"bound_us": {"dot": dot["bound_ms"] * 1e3,
                                "apply": apply["bound_ms"] * 1e3}}
            d = (res[1] - beta_in)[..., rows]
            if not (s.x_packed or s.x_int8):
                rec["library_us"] = apply_yardstick(
                    torch, s.data.XT, rows, d, res[0].clone())
            elif s.x_packed and chains == 1 and kind == "horseshoe":
                rec["library_us"] = apply_yardstick(
                    torch, decode_codes(s.data.XT[rows]).float(),
                    slice(None), d, res[0].clone())
            return rec

        return extra

    def strided(kind, s, chains, tag, miss_per_row=0.0):
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
        nr = s.nb // s.jacobi
        rows = (((torch.arange(s.jacobi, device="cuda") * nr + rho[0]) *
                 s.B)[:, None] + torch.arange(s.B, device="cuda")).flatten()
        lib = _cuda.library("jacobi_t").lib
        nsplit = (lib.jacobi_t_dot_splits(d.XT.shape[1]) if s.x_packed else
                  lib.jacobi_t_int8_dot_splits(s.N) if s.x_int8 else
                  lib.jacobi_t_dense_dot_splits(s.N))
        base = yard(kind, s, rows, st.beta, miss_per_row)

        def extra(res):
            """yard's, the solve's bound a round at the case's movers
            (``kernel_bounds.strided_solve_round``), the share of steps
            that moved and the solve's passes a block (``block_passes``),
            mean and a round's most, over the chains."""
            rec = base(res)
            kb = own_bounds()
            moved = res[1] != st.beta
            lead = moved if moved.dim() == 2 else moved[None]
            vis = [torch.gather(m.reshape(-1, s.B), 1, inner.long())
                   for m in lead]
            share = sum(float(v.float().mean()) for v in vis) / len(vis)
            rec["bound_us"]["solve"] = kb.strided_solve_round(
                s.jacobi, s.B, nsplit, len(CVA) + 1 if kind == "bayesr"
                else 0, len(vis), skw.get("missing", False),
                share * s.B)["bound_ms"] * 1e3
            rec["moved_share"] = share
            passes = [block_passes(torch, v).view(s.jacobi, -1) for v in vis]
            rec["passes_per_block"] = sum(
                float(p.float().mean()) for p in passes) / len(vis)
            rec["passes_max"] = sum(
                float(p.amax(0).float().mean()) for p in passes) / len(vis)
            return rec

        run_case(torch, out, f"{tag}_{kind}",
                 lambda: tuple(fn(*args, **skw)), extra=extra)

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
        rows = ((border[:J or 1].long() * s.B)[:, None] +
                torch.arange(s.B, device="cuda")).flatten()
        run_case(torch, out, f"{tag}_{kind}",
                 lambda: tuple(fn(*args, **skw)),
                 serial=(st.beta, border, inner, s.B),
                 extra=yard(kind, s, rows, st.beta, J=J or 1))

    def plans(kind, X, pre, **mk):
        """The strided cases of X (one chain, 8 fused), its serial one
        (dense only) and its row one, keys prefixed ``pre``."""
        if wanted(f"{pre}1_{kind}", f"{pre}8_{kind}"):
            s = make(kind, X, **mk)
            assert (s.jacobi, s.B) == (128, 32), (s.jacobi, s.B)
            strided(kind, s, None, f"{pre}1")
            strided(kind, s, CHAINS, f"{pre}8")
            del s
        if pre == "d" and wanted(f"ds1_{kind}"):
            s = make(kind, X, jacobi_blocks=1, **mk)
            assert s.jacobi == 1
            serial(kind, s, None, f"{pre}s1", {
                "bayesr": ser.bayesr_sweep, "horseshoe": ser.horseshoe_sweep})
            del s
        if wanted(f"{pre}row_{kind}"):
            s = make(kind, X, jacobi_layout="row", **mk)
            assert (s.jacobi, s.B) == (32, 128), (s.jacobi, s.B)
            serial(kind, s, None, f"{pre}row",
                   {"bayesr": jr.bayesr_jacobi,
                    "horseshoe": jr.horseshoe_jacobi}, J=s.jacobi)
            del s

    # the 2-bit words
    for kind in ("bayesr", "horseshoe"):
        if wanted(f"t1_{kind}", f"t8_{kind}", f"c1_{kind}"):
            s = make(kind, words)
            assert (s.jacobi, s.B) == (128, 32), (s.jacobi, s.B)
            strided(kind, s, None, "t1")
            strided(kind, s, CHAINS, "t8")
            if kind == "bayesr":
                strided(kind, s, 1, "c1")
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
        if wanted(f"row_{kind}", f"srow8_{kind}"):
            s = make(kind, words, jacobi_layout="row")
            assert (s.jacobi, s.B) == (32, 128), (s.jacobi, s.B)
            serial(kind, s, None, "row", {"bayesr": jr.bayesr_jacobi,
                                          "horseshoe": jr.horseshoe_jacobi},
                   J=s.jacobi)
            serial(kind, s, CHAINS, "srow8",
                   {"bayesr": mcs.bayesr_sweep_mc,
                    "horseshoe": mcs.horseshoe_sweep_mc})
            del s

    # dense f32 rows at the dense cell's shape
    dkeys = [f"{p}_{k}" for p in ("d1", "d8", "ds1", "drow")
             for k in ("bayesr", "horseshoe")]
    if wanted(*dkeys):
        X, Yd = dense_words(torch, torch.Generator(
            device="cuda").manual_seed(4), DENSE_N, DENSE_M)
        for kind in ("bayesr", "horseshoe"):
            plans(kind, X, "d", y=Yd, skw=dict(transposed=True,
                                                device="cuda"))
        del X
        torch.cuda.empty_cache()

    # int8 codes of the same words, without missing calls
    ikeys = [f"{p}_{k}" for p in ("i1", "i8", "irow")
             for k in ("bayesr", "horseshoe")]
    if wanted(*ikeys):
        codes = torch.empty((M, N), dtype=torch.int8, device="cuda")
        for a in range(0, M, 2048):
            codes[a:a + 2048] = decode_codes(words[a:a + 2048])[:, :N]
        del words
        torch.cuda.empty_cache()
        ikw = dict(kw, x_dtype="int8")
        for kind in ("bayesr", "horseshoe"):
            plans(kind, codes, "i", skw=ikw)
        del codes
    else:
        del words
    torch.cuda.empty_cache()
    if not wanted("t1miss_bayesr", "t1miss_horseshoe", "t8miss_bayesr",
                  "t8miss_horseshoe", "c1miss_bayesr", "s1q_bayesr",
                  "s1q_horseshoe", "q_bayesr", "q_horseshoe"):
        print(json.dumps(out), flush=True)
        return

    g = torch.Generator(device="cuda").manual_seed(3)
    words = bt.simulate.random_packed_words_missing(g, M, N // 16,
                                                    device="cuda")
    if wanted("t8miss"):
        g5 = torch.Generator(device="cuda").manual_seed(5)
        words5 = bt.simulate.random_packed_words_missing(
            g5, 512 * 32, N // 16, levels=5, device="cuda")
        out["miss_div"] = {"2^-6": miss_divergence(torch, words, 32),
                           "2^-5": miss_divergence(torch, words5, 32)}
        del words5
        print(json.dumps({"miss_div": out["miss_div"]}), file=sys.stderr,
              flush=True)
    # missing calls a row, from the first 512 blocks' words
    per_row = float(popcount16(torch, words[:512 * 32] & (
        words[:512 * 32] >> 1) & 0x55555555).sum()) / (512 * 32)
    for kind in ("bayesr", "horseshoe"):
        if wanted(f"t1miss_{kind}", f"t8miss_{kind}", f"c1miss_{kind}"):
            s = make(kind, words)
            assert (s.jacobi, s.B, s.data.has_missing) == (128, 32, True)
            strided(kind, s, None, "t1miss", per_row)
            strided(kind, s, CHAINS, "t8miss", per_row)
            if kind == "bayesr":
                strided(kind, s, 1, "c1miss", per_row)
            del s
        if wanted(f"s1q_{kind}"):
            s = make(kind, words, jacobi_blocks=1)
            assert (s.jacobi, s.B, s.nb, s.data.has_missing) == (1, 512, 984,
                                                                 True)
            assert s._sweep_kw()["fold_affine"] is False
            serial(kind, s, None, "s1q", {"bayesr": ser.bayesr_sweep,
                                          "horseshoe": ser.horseshoe_sweep})
            del s
    if not wanted("q_bayesr", "q_horseshoe"):
        print(json.dumps(out), flush=True)
        return
    codes = torch.empty((M, N), dtype=torch.int8, device="cuda")
    for a in range(0, M, 2048):
        codes[a:a + 2048] = decode_codes(words[a:a + 2048])[:, :N]
    del words
    torch.cuda.empty_cache()
    for kind in ("bayesr", "horseshoe"):
        if not wanted(f"q_{kind}"):
            continue
        s = make(kind, codes, skw=dict(kw, x_dtype="int8"))
        assert (s.jacobi, s.B, s.data.has_missing) == (1, 32, True)
        assert s._sweep_kw()["fold_affine"] is False
        serial(kind, s, None, "q", {"bayesr": ser.bayesr_sweep,
                                    "horseshoe": ser.horseshoe_sweep})
        del s
    print(json.dumps(out), flush=True)


def main(roots):
    only = []
    while roots[:1] in (["--only"], ["--clocks"]):
        if roots[0] == "--clocks":
            only, roots = [*only, "--clocks"], roots[1:]
        else:
            only, roots = [*only, "--only", roots[1]], roots[2:]
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
        flags = sys.argv[3:]
        CLOCKS = "--clocks" in flags
        if "--only" in flags:
            ONLY = tuple(flags[flags.index("--only") + 1].split(","))
        run_one(sys.argv[2])
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
