"""Command-line interface of the port.

Counterpart of ``bayesrrcpp_tpu/cli.py``'s ``bayesr``, ``groups``,
``horseshoe``, ``resume`` and ``summarize`` subcommands, reading PLINK .bed
or NumPy inputs and writing the reference CSV schemas (and, with
``--npz-out``, a columnar .npz beside the CSV):

    python -m bayesrrcpp_tpu_torch bayesr    --bed data --pheno y.txt \\
                                             --x-dtype 2bit --out chain.csv
    python -m bayesrrcpp_tpu_torch groups    --x X.npy --y y.npy \\
                                             --groups-file g.txt \\
                                             --fixed F.npy --out chain.csv
    python -m bayesrrcpp_tpu_torch horseshoe --x X.npy --y y.npy --out hs.csv
    python -m bayesrrcpp_tpu_torch resume    --checkpoint ck.npz --x X.npy \\
                                             --y y.npy --out more.csv
    python -m bayesrrcpp_tpu_torch bayesr    --x X.npy --y y.npy --dtype f64 \\
                                             --out c.csv --npz-out c.npz
    python -m bayesrrcpp_tpu_torch summarize --npz c.npz --npz d.npz \\
                                             --x X.npy --y y.npy --top 10

With ``--x-dtype 2bit`` a .bed goes straight into packed words on the host
(``io/bed.read_bed_packed``, padded to the planned marker count), missing
calls included, and never into a dense matrix; with ``--x-dtype int8`` a
.bed is read with NaN for a missing call and not standardized, and a
dosage .npy is taken as it is, both quantized to int8 codes; a dense .npy
or .bed is standardized unless ``--no-standardize``.  The run is on
``--device``, the card by default; ``--backend auto`` sweeps with the
kernels there, the default dense storage included, and with the plain sweep
for dense X on the CPU (``--backend pallas|blocked|scan`` chooses; ``scan``
is the literal per-marker sweep in a full permutation).  ``--dtype f64``
runs the state in float64 (the kernels then as JAX's under float64,
``models/sampler.py``).
``--checkpoint-out`` writes the final state and the generator
(``io/checkpoint.py``), and with ``--checkpoint-every SECONDS`` also
during the run; ``resume --checkpoint`` continues such a chain bitwise,
``resume --from-csv`` from a CSV's last row as BRV2Grstart does (pi, or
the horseshoe's eta / v / c2, redrawn; the generator seeded by
``--seed``).  Hyperparameter flags carry the reference names.  The
horseshoe prints tau, eta and sigmaE at each tenth of its emissions.
``summarize`` reads ``--npz-out`` files (one a chain) and prints JAX's
JSON summary: means, h2, the top markers by inclusion probability, PVE
with ``--x``/``--y``, and split R-hat / ESS over several chains.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _add_common(p):
    p.add_argument("--bed", help="PLINK .bed/.bim/.fam prefix")
    p.add_argument("--pheno", help="phenotype file (.fam-style or 1 column)")
    p.add_argument("--x", help=".npy/.npz matrix of shape (N, M)")
    p.add_argument("--y", help=".npy phenotype vector")
    p.add_argument("--out", required=True, help="output CSV path")
    p.add_argument("--npz-out", help="also write a columnar .npz (one "
                                     "chain)")
    p.add_argument("--checkpoint-out",
                   help="write the final state and generator (.npz)")
    p.add_argument("--checkpoint-every", type=float, default=0.0,
                   metavar="SECONDS",
                   help="also checkpoint to --checkpoint-out during the run, "
                        "at most every SECONDS (crash recovery; the "
                        "reference has no mid-chain recovery at all)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--burn-in", type=int, default=1000)
    p.add_argument("--thinning", type=int, default=5)
    p.add_argument("--block-size", type=int, default=512)
    p.add_argument("--backend", choices=["auto", "pallas", "blocked", "scan"],
                   default="auto",
                   help="sweep: the kernels (pallas; auto on the card and "
                        "for packed X), the plain Gram-blocked sweep "
                        "(blocked; dense X only), or the literal per-marker "
                        "scan (dense X only)")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32",
                   help="the state's float type")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    p.add_argument("--no-epsilon", action="store_true",
                   help="omit the per-sample residual vector from the output")
    p.add_argument("--no-standardize", action="store_true",
                   help="take a dense .npy or .bed as it is (not centred "
                        "and scaled)")
    p.add_argument("--x-dtype", choices=["dense", "int8", "2bit"],
                   default="dense",
                   help="genotype storage: dense f32, int8 codes (1 "
                        "B/genotype, missing calls as code 3), or 2-bit "
                        "packed words (0.25 B/genotype). With --bed, 2bit "
                        "decodes straight to the packed layout: no dense X "
                        "on the host")
    p.add_argument("--decode-threads", type=int, default=0,
                   help="threads for the native .bed decoder (0 = all)")
    p.add_argument("--chains", type=int, default=1,
                   help="run N chains, fused where the kernels allow (one "
                        "CSV per chain, '.chainK' inserted before the "
                        "extension)")


def _add_mixture(p):
    p.add_argument("--cva", default="0.0001,0.001,0.01",
                   help="slab variances, comma separated (reference cva)")
    p.add_argument("--v0E", type=float, default=0.001)
    p.add_argument("--s02E", type=float, default=0.001)
    p.add_argument("--v0G", type=float, default=0.001)
    p.add_argument("--s02G", type=float, default=0.001)
    p.add_argument("--sigma0", type=float, default=0.01)


def _load_xy(args):
    """(X, Y, sampler keyword arguments).  Quantized x-dtypes standardize
    inside the sweep, so X stays raw dosages or packed words; the packed
    .bed path never densifies on the host."""
    import torch

    from .io import bed as bedio

    x_dtype = args.x_dtype
    kw = {"x_dtype": x_dtype}
    if args.bed:
        if not args.pheno:
            raise SystemExit("--pheno is required with --bed")
        Y = bedio.read_phenotype(args.pheno)
        if x_dtype == "2bit":
            pb = bedio.read_bed_packed(
                args.bed, n_threads=args.decode_threads, mpad="auto",
                block_size=args.block_size)
            if Y.shape[0] != pb.n:
                raise SystemExit(f"phenotype length {Y.shape[0]} != N {pb.n}")
            kw.update(transposed=True, x_stats=(pb.means, pb.sds),
                      n_individuals=pb.n, n_markers=len(pb.snp_ids))
            return torch.as_tensor(pb.words), Y, kw
        data = bedio.read_bed(
            args.bed,
            standardize=x_dtype == "dense" and not args.no_standardize,
            impute_missing=x_dtype == "dense")
        X = data.X
    elif args.x and args.y:
        X = np.load(args.x)
        if hasattr(X, "files"):
            X = X[X.files[0]]
        Y = np.load(args.y)
        if x_dtype == "dense" and not args.no_standardize:
            sd = X.std(axis=0, ddof=1)
            sd[sd == 0] = 1.0
            X = (X - X.mean(axis=0)) / sd
    else:
        raise SystemExit("provide either --bed/--pheno or --x/--y")
    if Y.shape[0] != X.shape[0]:
        raise SystemExit(f"phenotype length {Y.shape[0]} != N {X.shape[0]}")
    return X, Y, kw


def _progress(done, total):
    # decile progress prints, like the reference (src/BayesRv2.cpp:173-175)
    if total and done % max(1, total // 10) == 0:
        print(f"emitted {done}/{total} samples", flush=True)


def _backend(args):
    return None if args.backend == "auto" else args.backend


def _dtype(args):
    import torch

    return torch.float64 if args.dtype == "f64" else torch.float32


def _compose_chunks(*fns):
    """One ``on_chunk`` calling each of ``fns`` that is not None."""
    fns = [f for f in fns if f is not None]
    if len(fns) < 2:
        return fns[0] if fns else None

    def on_chunk(state, done):
        for f in fns:
            f(state, done)

    return on_chunk


def _hs_decile_printer(total):
    """tau, eta and sigmaE at each tenth of the emissions, as the
    reference's horseshoe prints them (src/HorseshoeR.cpp:200-207;
    bayesrrcpp_tpu/cli.py:153-168); a chain axis prints every chain's."""
    last = [0]

    def fmt(t):
        a = t.detach().cpu().numpy().reshape(-1)
        return (f"{a[0]:.6g}" if a.size == 1 else
                "[" + ",".join(f"{x:.4g}" for x in a) + "]")

    def on_chunk(state, done):
        decile = done * 10 // max(1, total)
        if decile > last[0]:
            last[0] = decile
            print(f"emitted {done}/{total}: tau {fmt(state.tau)} eta "
                  f"{fmt(state.eta)} sigmaE {fmt(state.sigmaE)}", flush=True)

    return on_chunk


def _npz(path):
    # np.savez appends .npz when it is missing
    return path if path.endswith(".npz") else path + ".npz"


def _periodic_saver(args, generator):
    """Time-throttled mid-chain checkpoints through ``on_chunk``, each
    written beside the target and renamed over it
    (bayesrrcpp_tpu/cli.py:175-201)."""
    if not (args.checkpoint_out and args.checkpoint_every > 0):
        return None
    import os
    import time

    from .io.checkpoint import save_checkpoint

    target = _npz(args.checkpoint_out)
    last = [time.monotonic()]

    def on_chunk(state, done):
        now = time.monotonic()
        if now - last[0] >= args.checkpoint_every:
            tmp = target[:-4] + ".tmp.npz"
            save_checkpoint(tmp, state, generator)
            os.replace(tmp, target)
            last[0] = now

    return on_chunk


def _run(sampler, args, schema, state=None, generator=None, **sink_kw):
    """Run the chain(s) of ``args`` on ``sampler`` into the CSV(s) of
    ``schema`` (and ``--npz-out``), from ``state`` (default: fresh) with
    ``generator`` (default: seeded by ``--seed``); ``--chains`` > 1 runs
    fresh chains.  The horseshoe prints its deciles.  Writes
    ``--checkpoint-out``; returns the final state."""
    import torch

    from .config import ChainConfig
    from .io.sink import ChainFanoutSink, CSVSink, NpzSink, TeeSink

    chain = ChainConfig(args.iterations, args.burn_in, args.thinning)
    g = (generator if generator is not None else
         torch.Generator(device=sampler.device).manual_seed(args.seed))
    kw = dict(M=sampler.M, N=sampler.N, emit_epsilon=not args.no_epsilon,
              **sink_kw)
    on_chunk = _compose_chunks(
        _periodic_saver(args, g),
        _hs_decile_printer(len(chain.emit_iterations()))
        if schema == "horseshoe" else None)
    fanout = args.chains > 1 and state is None
    if fanout and args.npz_out:
        raise SystemExit("--npz-out writes one chain: run it with "
                         "--chains 1")
    if fanout:
        sink = ChainFanoutSink.csv(args.out, args.chains, schema, **kw)
        run = lambda: sampler.run_chains(  # noqa: E731
            g, args.chains, chain, sink=sink, collect=False,
            progress=_progress, on_chunk=on_chunk)
    else:
        sink = CSVSink(args.out, schema, **kw)
        if args.npz_out:
            sink = TeeSink(sink, NpzSink(args.npz_out))
        run = lambda: sampler.run(g, chain, state=state,  # noqa: E731
                                  sink=sink, collect=False,
                                  progress=_progress, on_chunk=on_chunk)
    try:
        state, _ = run()
    finally:
        sink.close()
    if args.checkpoint_out:
        from .io.checkpoint import save_checkpoint

        save_checkpoint(_npz(args.checkpoint_out), state, g)
    return state


def _mixture_config(args, groups: bool):
    from .config import BayesRConfig, GroupsConfig

    cls = GroupsConfig if groups else BayesRConfig
    return cls(sigma0=args.sigma0, v0E=args.v0E, s02E=args.s02E,
               v0G=args.v0G, s02G=args.s02G, block_size=args.block_size,
               emit_epsilon=not args.no_epsilon)


def _horseshoe_config(args):
    from .config import HorseshoeConfig

    return HorseshoeConfig(A=args.A, v0E=args.v0E, s02E=args.s02E,
                           vL=args.vL, vT=args.vT, c2=args.c2, vC=args.vC,
                           sC=args.sC, block_size=args.block_size,
                           emit_epsilon=not args.no_epsilon)


def _cva(args, G: int = 1):
    """The --cva row, tiled over G groups (bayesrrcpp_tpu/cli.py:339-341)."""
    row = np.array([float(v) for v in args.cva.split(",")])
    return np.tile(row, (G, 1)) if G > 1 else row


def _groups(args):
    return (np.loadtxt(args.groups_file, dtype=np.int32).reshape(-1)
            if args.groups_file else None)


def _resume(args, X, Y, xkw):
    """The ``resume`` subcommand (bayesrrcpp_tpu/cli.py:369-456): from a
    checkpoint, bitwise, or from a CSV's last row (``io/resume.py``), a
    mixture chain (schema groups / grstart / bayesr) or a horseshoe one;
    the resumed chain counts its iterations from 0."""
    import torch

    from .models.bayesr import SpikeSlabSampler
    from .models.horseshoe import HorseshoeSampler
    from .models.state import HorseshoeState

    if bool(args.checkpoint) == bool(args.from_csv):
        raise SystemExit("resume needs exactly one of --checkpoint / "
                         "--from-csv")
    quantized = xkw["x_dtype"] != "dense"
    state = generator = None
    if args.checkpoint:
        from .io.checkpoint import load_checkpoint

        state, generator = load_checkpoint(args.checkpoint,
                                           device=args.device)
        if state.mu.dim() != 0:
            raise SystemExit("resume takes a one-chain checkpoint; this one "
                             f"holds {state.mu.shape[0]} chains")
        if state.mu.dtype != _dtype(args):
            want = "f64" if state.mu.dtype == torch.float64 else "f32"
            raise SystemExit(f"the checkpoint holds a {state.mu.dtype} "
                             f"state: resume it with --dtype {want}")
        family = ("horseshoe" if isinstance(state, HorseshoeState)
                  else "mixture")
    else:
        from .io.resume import csv_schema

        family = csv_schema(args.from_csv)
        generator = torch.Generator(device=args.device).manual_seed(
            args.seed)
    kw = dict(backend=_backend(args), dtype=_dtype(args), device=args.device,
              **xkw)

    if family == "horseshoe":
        s = HorseshoeSampler(X, Y, _horseshoe_config(args), **kw)
        if args.from_csv:
            from .io.resume import horseshoe_kwargs_from_csv

            state = s.init_from(generator, **horseshoe_kwargs_from_csv(
                args.from_csv, X=None if quantized else X, Y=Y,
                xbeta=s.xbeta))
        _run(s, args, "horseshoe", state=state.replace(iteration=0),
             generator=generator)
        return

    fixed = np.load(args.fixed) if args.fixed else None
    if args.checkpoint:
        G = state.sigmaGG.shape[-1]
    else:
        from .io.resume import parse_last_row

        G = np.atleast_1d(parse_last_row(args.from_csv).get(
            "sigmaG", np.array([np.nan]))).size
    s = SpikeSlabSampler(X, Y, _cva(args, G), _mixture_config(args, True),
                         g_assign=_groups(args), fixed=fixed,
                         variant="groups" if G > 1 else "bayesr", **kw)
    if args.from_csv:
        from .io.resume import state_kwargs_from_csv

        state = s.init_from(generator, **state_kwargs_from_csv(
            args.from_csv, X=None if quantized else X, Y=Y, fixed=fixed,
            xbeta=s.xbeta))
    if state.alpha.shape[-1] != s.F:
        raise SystemExit(
            f"resumed state has {state.alpha.shape[-1]} fixed-effect "
            f"coefficients but the sampler was built with F={s.F}; "
            "pass the matching --fixed matrix")
    schema = "groups" if s.F > 0 else ("grstart" if G > 1 else "bayesr")
    _run(s, args, schema, state=state.replace(iteration=0),
         generator=generator, groups=G, F=s.F)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bayesrrcpp_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("bayesr", help="ungrouped BayesR spike-and-slab chain")
    _add_common(p1)
    _add_mixture(p1)

    p2 = sub.add_parser("groups", help="grouped BayesRR chain + fixed effects")
    _add_common(p2)
    _add_mixture(p2)
    p2.add_argument("--groups-file", required=True,
                    help="one int group id per marker (gAssign)")
    p2.add_argument("--fixed", help=".npy (N, F) fixed-effect covariates")

    p3 = sub.add_parser("horseshoe", help="regularized-horseshoe chain")
    _add_common(p3)
    _add_horseshoe(p3, v0=True)

    p4 = sub.add_parser("resume", help="resume a chain from a checkpoint or "
                                       "a sample CSV")
    _add_common(p4)
    _add_mixture(p4)
    p4.add_argument("--checkpoint",
                    help="checkpoint (.npz, --checkpoint-out): the exact "
                         "resume, generator included")
    p4.add_argument("--from-csv",
                    help="resume from the last row of a sample CSV, as the "
                         "reference's BRV2Grstart workflow (pi re-drawn "
                         "from the component counts; the generator seeded "
                         "by --seed).  Horseshoe CSVs are known by their "
                         "tau / lambda columns (eta, v, c2 re-drawn from "
                         "their conditionals).  Quantized --x-dtype runs "
                         "rebuild missing epsilon columns from the "
                         "genotypes on the device")
    p4.add_argument("--groups-file")
    p4.add_argument("--fixed",
                    help=".npy (N, F) fixed-effect covariates; REQUIRED "
                         "when the CSV or checkpoint carries alpha columns")
    # the horseshoe's hyperparameters (used when the chain is a horseshoe)
    _add_horseshoe(p4, v0=False)

    p5 = sub.add_parser("summarize",
                        help="posterior summaries of saved chains (the "
                             "vignette's manual R post-processing)")
    p5.add_argument("--npz", action="append", required=True,
                    help="columnar chain output (--npz-out); repeat for "
                         "multi-chain R-hat/ESS")
    p5.add_argument("--x", help=".npy (N, M) standardized X for PVE")
    p5.add_argument("--y", help=".npy phenotype for PVE")
    p5.add_argument("--top", type=int, default=10,
                    help="print the top-K markers by inclusion probability")

    args = ap.parse_args(argv)
    if args.cmd == "summarize":
        return _summarize(args)

    from .models.bayesr import SpikeSlabSampler
    from .models.horseshoe import HorseshoeSampler

    X, Y, xkw = _load_xy(args)
    kw = dict(backend=_backend(args), dtype=_dtype(args), device=args.device,
              **xkw)
    if args.cmd == "bayesr":
        s = SpikeSlabSampler(X, Y, _cva(args), _mixture_config(args, False),
                             **kw)
        _run(s, args, "bayesr")
    elif args.cmd == "groups":
        g_assign = _groups(args)
        G = int(g_assign.max()) + 1
        fixed = np.load(args.fixed) if args.fixed else None
        s = SpikeSlabSampler(X, Y, _cva(args, G),
                             _mixture_config(args, True), g_assign=g_assign,
                             fixed=fixed, **kw)
        _run(s, args, "groups", groups=G, F=s.F)
    elif args.cmd == "horseshoe":
        s = HorseshoeSampler(X, Y, _horseshoe_config(args), **kw)
        _run(s, args, "horseshoe")
    else:
        _resume(args, X, Y, xkw)
    return 0


def _summarize(args):
    """The ``summarize`` subcommand (bayesrrcpp_tpu/cli.py:458-490): JAX's
    JSON of the chains in ``--npz`` (``utils/summary.py``)."""
    import json

    from .utils import summary

    chains = [dict(np.load(p)) for p in args.npz]
    s0 = chains[0]
    out = {"n_samples": int(s0["mu"].shape[0]), "n_chains": len(chains)}
    for k in ("mu", "sigmaE", "sigmaF", "tau"):
        if k in s0:
            out[k + "_mean"] = float(np.mean([c[k].mean() for c in chains]))
    if "sigmaG" in s0:
        h2 = np.concatenate([summary.heritability_samples(c) for c in chains])
        out["h2_mean"] = float(h2.mean())
        out["h2_sd"] = float(h2.std(ddof=1)) if h2.size > 1 else 0.0
    if "comp" in s0:
        pip = np.mean([summary.inclusion_probabilities(c) for c in chains],
                      axis=0)
        top = np.argsort(-pip)[:args.top]
        out["top_markers"] = [{"index": int(i), "pip": round(float(pip[i]), 4)}
                              for i in top]
    if args.x and args.y:
        merged = {"beta": np.concatenate([c["beta"] for c in chains], axis=0)}
        out["pve"] = round(summary.pve(merged, np.load(args.x),
                                       np.load(args.y)), 4)
    if len(chains) > 1:
        for k in ("sigmaE", "mu", "tau"):
            if k in s0:
                stacked = np.stack([c[k].reshape(-1) for c in chains], axis=1)
                out[f"rhat_{k}"] = round(float(summary.split_rhat(stacked)), 4)
                out[f"ess_{k}"] = round(float(summary.ess(stacked)), 1)
    print(json.dumps(out, indent=2))
    return 0


def _add_horseshoe(p, v0: bool):
    p.add_argument("--A", type=float, default=1.0)
    if v0:
        p.add_argument("--v0E", type=float, default=0.001)
        p.add_argument("--s02E", type=float, default=0.001)
    p.add_argument("--vL", type=float, default=1.0)
    p.add_argument("--vT", type=float, default=1.0)
    p.add_argument("--c2", type=float, default=1.0)
    p.add_argument("--vC", type=float, default=10.0)
    p.add_argument("--sC", type=float, default=10.0)


if __name__ == "__main__":
    sys.exit(main())
