"""Command-line interface of the port.

Counterpart of the ``bayesr`` and ``horseshoe`` subcommands of
``bayesrrcpp_tpu/cli.py``, reading PLINK .bed or NumPy inputs and writing
the reference CSV schemas:

    python -m bayesrrcpp_tpu_torch bayesr    --bed data --pheno y.txt \\
                                             --x-dtype 2bit --out chain.csv
    python -m bayesrrcpp_tpu_torch horseshoe --x X.npy --y y.npy --out hs.csv

With ``--x-dtype 2bit`` a .bed goes straight into packed words on the host
(``io/bed.read_bed_packed``, padded to the planned marker count), missing
calls included, and never into a dense matrix; with ``--x-dtype int8`` a
.bed is read with NaN for a missing call and not standardized, and a
dosage .npy is taken as it is, both quantized to int8 codes.  The run is on ``--device``,
the card by default; ``--backend auto`` sweeps with the kernels there, the
default dense storage included, and with the plain sweep for dense X on the
CPU (``--backend pallas|blocked`` chooses; ``scan`` is not ported).  Hyperparameter flags carry the reference names.  The
``groups`` and ``resume`` subcommands and the checkpoint and .npz outputs
are not ported yet: they raise ``NotImplementedError`` naming their ROADMAP
entries.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

# the flags and subcommands outside the port, by ROADMAP entry
_NOT_PORTED = {
    "groups": "the groups subcommand (ROADMAP Queue 1 item 6)",
    "resume": "the resume subcommand (ROADMAP Queue 1 item 7)",
    "checkpoint_out": "--checkpoint-out (ROADMAP Queue 1 item 7)",
    "checkpoint_every": "--checkpoint-every (ROADMAP Queue 1 item 7)",
    "npz_out": "--npz-out (the NpzSink, ROADMAP Queue 1 item 9)",
}


def _add_common(p):
    p.add_argument("--bed", help="PLINK .bed/.bim/.fam prefix")
    p.add_argument("--pheno", help="phenotype file (.fam-style or 1 column)")
    p.add_argument("--x", help=".npy/.npz matrix of shape (N, M)")
    p.add_argument("--y", help=".npy phenotype vector")
    p.add_argument("--out", required=True, help="output CSV path")
    p.add_argument("--npz-out", help="not ported: a columnar .npz")
    p.add_argument("--checkpoint-out", help="not ported: a final checkpoint")
    p.add_argument("--checkpoint-every", type=float, default=0.0,
                   metavar="SECONDS", help="not ported: periodic checkpoints")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--burn-in", type=int, default=1000)
    p.add_argument("--thinning", type=int, default=5)
    p.add_argument("--block-size", type=int, default=512)
    p.add_argument("--backend", choices=["auto", "pallas", "blocked", "scan"],
                   default="auto",
                   help="sweep: the kernels (pallas; auto on the card and "
                        "for packed X), the plain Gram-blocked sweep "
                        "(blocked; dense X only), or the literal scan (not "
                        "ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    p.add_argument("--no-epsilon", action="store_true",
                   help="omit the per-sample residual vector from the output")
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
        data = bedio.read_bed(args.bed, standardize=x_dtype == "dense",
                              impute_missing=x_dtype == "dense")
        X = data.X
    elif args.x and args.y:
        X = np.load(args.x)
        if hasattr(X, "files"):
            X = X[X.files[0]]
        Y = np.load(args.y)
        if x_dtype == "dense":
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


def _check_ported(args):
    if args.cmd in _NOT_PORTED:
        raise NotImplementedError(f"{_NOT_PORTED[args.cmd]} is not ported "
                                  f"to bayesrrcpp_tpu_torch yet")
    for flag in ("checkpoint_out", "checkpoint_every", "npz_out"):
        if getattr(args, flag):
            raise NotImplementedError(f"{_NOT_PORTED[flag]} is not ported "
                                      f"to bayesrrcpp_tpu_torch yet")


def _run(sampler, args, schema):
    """Run the chain(s) of ``args`` on ``sampler`` into the CSV(s) of
    ``schema``; returns the final state."""
    import torch

    from .config import ChainConfig
    from .io.sink import ChainFanoutSink, CSVSink

    chain = ChainConfig(args.iterations, args.burn_in, args.thinning)
    g = torch.Generator(device=sampler.device).manual_seed(args.seed)
    emit = not args.no_epsilon
    if args.chains > 1:
        sink = ChainFanoutSink.csv(args.out, args.chains, schema, M=sampler.M,
                                   N=sampler.N, emit_epsilon=emit)
        run = lambda: sampler.run_chains(  # noqa: E731
            g, args.chains, chain, sink=sink, collect=False,
            progress=_progress)
    else:
        sink = CSVSink(args.out, schema, M=sampler.M, N=sampler.N,
                       emit_epsilon=emit)
        run = lambda: sampler.run(g, chain, sink=sink,  # noqa: E731
                                  collect=False, progress=_progress)
    try:
        state, _ = run()
    finally:
        sink.close()
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bayesrrcpp_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("bayesr", help="ungrouped BayesR spike-and-slab chain")
    _add_common(p1)
    _add_mixture(p1)

    p3 = sub.add_parser("horseshoe", help="regularized-horseshoe chain")
    _add_common(p3)
    p3.add_argument("--A", type=float, default=1.0)
    p3.add_argument("--v0E", type=float, default=0.001)
    p3.add_argument("--s02E", type=float, default=0.001)
    p3.add_argument("--vL", type=float, default=1.0)
    p3.add_argument("--vT", type=float, default=1.0)
    p3.add_argument("--c2", type=float, default=1.0)
    p3.add_argument("--vC", type=float, default=10.0)
    p3.add_argument("--sC", type=float, default=10.0)

    for name in ("groups", "resume"):
        sub.add_parser(name, help=f"not ported: {_NOT_PORTED[name]}")

    args, extra = ap.parse_known_args(argv)
    _check_ported(args)
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")

    from .config import BayesRConfig, HorseshoeConfig
    from .models.bayesr import SpikeSlabSampler
    from .models.horseshoe import HorseshoeSampler

    X, Y, xkw = _load_xy(args)
    emit = not args.no_epsilon
    if args.cmd == "bayesr":
        cva = np.array([float(v) for v in args.cva.split(",")])
        cfg = BayesRConfig(sigma0=args.sigma0, v0E=args.v0E, s02E=args.s02E,
                           v0G=args.v0G, s02G=args.s02G,
                           block_size=args.block_size, emit_epsilon=emit)
        s = SpikeSlabSampler(X, Y, cva, cfg, backend=_backend(args),
                             device=args.device, **xkw)
    else:
        cfg = HorseshoeConfig(A=args.A, v0E=args.v0E, s02E=args.s02E,
                              vL=args.vL, vT=args.vT, c2=args.c2, vC=args.vC,
                              sC=args.sC, block_size=args.block_size,
                              emit_epsilon=emit)
        s = HorseshoeSampler(X, Y, cfg, backend=_backend(args),
                             device=args.device, **xkw)
    _run(s, args, args.cmd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
