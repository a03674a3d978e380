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
   headline N=100,352 x M=503,808 (plan J=128, B=32), over its first 16
   rounds through #5 (the sweep's kernel with a round count), labels
   agreeing on >= 99.9% of markers and |d eps| / |eps| < 1e-3 (a
   near-tie label flip from another summation order changes later steps
   of its block), and the timed whole sweep bitwise equal to its rounds
   run through #5 in chunks of 16 (so too 8b and 13b);
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
   steps for the dot / solve / apply split;
8. the fused multi-chain BayesR kernel (csrc/jacobi_t_mc.cu), C=8 chains
   from a warm 8-chain state: (a) at N=4096 x M=8192 against its plain
   version (labels and v equal, floats to rtol 1e-4 / atol 1e-5) and, chain
   by chain, against the single-chain kernel (every output bitwise
   equal); (b) at the headline, on phase 2's words, its first 16 rounds
   through #6 against the plain version (labels agreeing on >= 99.9 %,
   |d eps| / |eps| < 1e-3) and the whole sweep beside the
   8 single-chain sweeps, all timed, plus ``torch.matmul`` of one round's
   decoded rows against the 8 eps vectors as the dot's yardstick; (c) the
   main path of biobank-packed-8chain: ``SpikeSlabSampler(...).run_chains(
   generator, 8, ChainConfig(30, 10, 10), sink=ChainFanoutSink.csv(...))``
   with the fused launch counter reset just before; checks the 8 CSVs'
   widths, finite values, tracked vs recomputed eps per chain and the
   launch count, then times 8 fused steps against 8 single-chain steps per
   chain (printing split-R-hat of sigmaE over the 8 fused steps, for
   information) and profiles 2 fused steps;
9. the same three phases for the fused horseshoe kernel and
   biobank-horseshoe-8chain, with phase 5b's bound at the headline
   (|d eps| / |eps| and |d beta| / |beta| < 1e-4);
10. the serial (J=1) kernels of csrc/serial.cu, BayesR and horseshoe,
   against their plain versions, one sweep from a warm state: at N=4096 x
   M=8192 with B=512, B=64, B=1024 and B=100 on the first ~1,024 steps of
   the order (2 of 16, 16 of 128, 1 of 8 and 10 of 88 blocks, the markers
   padded at B=100; labels and v equal, beta to rtol 1e-4 / atol 1e-5, eps
   to 1e-4 of its norm and of its largest value); at the headline with
   B=512 on a 2-block order (BayesR labels agreeing on >= 99.9 %, |d eps|
   / |eps| < 1e-3 for BayesR and < 1e-4 for the horseshoe); the full
   headline sweep timed (mean of 3), with the dot launch's torch.matmul
   yardstick;
11. the same kernels fused at C=8 (C=16 at B=1024) against their plain
   versions at both sizes and, chain by chain, bitwise against the
   single-chain serial kernel (on 2 blocks and on the full sweep); the
   full fused sweep timed against 8 single-chain sweeps;
12. the serial main paths with the launch counters reset just before:
   biobank-packed-serial (``jacobi_blocks=1``, ``ChainConfig(10, 5, 5)``),
   the horseshoe at J=1 and both samplers' ``run_chains`` of 8 chains
   (CSV widths, finite values, tracked vs recomputed eps, launch counts,
   one profiled step); recovery at J=1 for both samplers (N=4096, M=2048,
   block_size 256, corr > 0.8); and the auto plan at M=1500 < 2048 markers
   (no ``jacobi_blocks``: J=1), one chain and 8 fused chains of both
   samplers, each with its launch count checked;
13. the strided kernels' miss mode (words with ~1.6 % missing calls at
   random, ``simulate.random_packed_words_missing``), BayesR and horseshoe,
   one chain and fused at C=8, against their plain versions from a warm
   state: at N=4096 x M=8192 labels and v equal, floats to rtol 1e-4 /
   atol 1e-5, each fused chain bitwise equal to the single-chain kernel; at
   the headline (BayesR: its first 16 rounds through #5 / #6, the sweep's
   kernel with a round count, against their plain versions; the horseshoe
   the whole sweep) labels >= 99.9 % equal and, chain by chain, |d eps| / |eps|
   < 1e-3 where all labels agree; a chain with a flipped label is replayed
   up to the first round R0 with a flip (labels equal and |d eps| / |eps|
   < 1e-3 after R0 rounds), the first flip of each block of round R0 must
   be a near tie (its u within f32 rounding of a cumulative weight,
   recomputed in f64; ``flip_replay`` prints each margin), and its eps is
   held to its own eps_in - X dbeta to 1e-5 (the horseshoe: eps and beta <
   1e-4); every sweep timed, with the dot's torch.matmul yardstick and a
   bound that counts the indicator's FMAs on the missing calls only;
14. the main path of biobank-packed-missing: ``SpikeSlabSampler`` on those
   words ``.run(generator, ChainConfig(30, 10, 10), sink=CSVSink(...))``,
   then the horseshoe, then 8 fused chains of each (``run_chains``), with
   CSV widths, finite values, tracked vs recomputed eps and the launch
   counts, and a profile of dot / solve / apply for each;
15. the serial kernels' in-kernel decode (``fold_affine=False``) against
   their plain versions: at N=4096 x M=8192 with B=512 and B=64 as phase
   10 on the first 1,024 steps of the order (2 and 16 blocks), on 2
   headline blocks (BayesR labels >= 99.9 %, |d eps| / |eps| <
   1e-3, the horseshoe < 1e-4), the full headline sweep timed; then an
   M=1500 auto-plan fit with missing calls (J=1) of both samplers, one
   chain and 8 chains (unfused: each chain through the single-chain
   kernel; ``fused=True`` raises), with their launch counts;
16. the CLI in-process, ``python -m bayesrrcpp_tpu_torch bayesr|horseshoe
   --bed ... --x-dtype 2bit`` on a .bed with missing calls at N=100,352 x
   M=2,048 written by ``io/bed.write_bed`` into a temporary directory, on
   the card: the CSV's widths and values and the launch counts;
17. dense X (``x_dtype="dense"``, standardized f32 rows built on the card
   from a seed), the kernels' dense mode: (a) each of the eight dense
   sweeps against its plain version at N=4001 (no multiple of 4 or 32) x
   M=8192, strided J=128, B=32 and serial B=512 (its first 2 blocks), one
   chain and C=8 fused
   from warm states (labels and v equal, beta and bacc to rtol 1e-4 / atol
   1e-5, eps to 1e-4 of its norm and of its largest value as phase 10:
   each lane sums up to 4096 moved rows a round), each fused chain bitwise
   equal to the single-chain kernel; (b) the dense kernels against the fold kernels on
   the same dosages, phase 2's first 8,192 markers and their standardized
   rows (BayesR chain by chain as phase 13b: a flip replayed and judged a
   near tie; the horseshoe to 1e-4); (c) at the dense cell dense-16kx49k
   (N=16,384 x M=49,152, 3.22 GB of X; plan J=128, B=32, nr=12) one sweep
   of each strided kernel, one chain and C=8 fused, against its plain
   version (phase 13b's gates), timed, with its bound and the
   ``torch.matmul`` of each round's strided view of X by eps;
18. the dense cell's main paths with the launch counters reset just
   before: BayesR and the horseshoe through ``.run(..., ChainConfig(10, 5,
   5))`` into a ``CSVSink`` and 8 fused chains of each through
   ``run_chains`` (5 iterations) into a ``ChainFanoutSink`` (CSV widths,
   finite values, tracked vs recomputed eps < 1e-4, launch counts), each
   with a profile of 2 steps (dot / solve / apply per launch);
19. the serial dense kernels at the cell (``jacobi_blocks=1``, B=512, 96
   blocks): 2 blocks against the plain versions (as phase 10b), full
   sweeps timed with their bounds, C=8 fused bitwise against the single
   chain, and the main paths (BayesR ``ChainConfig(10, 5, 5)``, the
   horseshoe and 8 fused chains of each 5 iterations); recovery through
   the dense kernels (phase 3's and 6's recipes, corr > 0.8);
20. the CLI in-process on a dense .npy of N=4096 x M=8192 with ``--x-dtype
   dense`` on the card: the CSV and the launch counts;
21. the row-layout sweeps (csrc/serial.cu with J blocks a round) and their
   round solves: (a) BayesR and the horseshoe against their plain versions
   at N=4096 x M=8192 words and N=4001 x M=8192 dense rows from warm
   states over their first 16 rounds (all of them at J=8 and J=32),
   plans (J, B) = (8, 512), (32, 128), (2, 64) and (16, 16) (labels
   and v equal, beta and bacc to rtol 1e-4 / atol 1e-5, eps to 1e-4 of its
   norm and of its largest value), and the round solves alone on one
   round's r (labels and v equal, dlane and beta to 1e-5); (b) at the
   headline with ``jacobi_layout="row"`` (J=32, B=128, nr=123, on phase
   2's words) the first 4 rounds against the plain version under phase
   13b's gates (``row_rounds`` for the replay), full sweeps timed (mean of
   3) with their bounds and the ``torch.matmul`` of a round's decoded rows
   by eps, the round solve alone timed, and one sweep at
   ``jacobi_blocks=8`` (B=512); the same at dense-16kx49k-row (nr=12);
22. the row plans' main paths with the launch counters reset just before:
   biobank-packed-row and the horseshoe (``.run``, ``ChainConfig(10, 5,
   5)``, 3 launches and one round solve a round), ``run_chains`` of 8 on
   the same plans (5 iterations: the serial fused sweep, as JAX's fused
   step on a row plan; the row sweep launched no time), the same on
   dense-16kx49k-row and at the auto plan of M=1500 with ``block_size=64``
   ((2, 64, "row")); CSV widths, finite values, tracked vs recomputed eps
   < 1e-4, a profile of 2 steps of each; recovery through the row sweep
   (phase 3's and 6's recipes at ``jacobi_blocks=4``, corr > 0.8);
23. the marker-sharded BayesR driver (``parallel/``) and its chunked
   strided sweeps, #5 ``bayesr_jacobi_t_rounds`` and #6
   ``bayesr_jacobi_t_mc_rounds``: (a) each against its plain version at
   N=4096 x M=8192 (2-bit fold and ``miss``) and N=4001 x M=8192 (dense),
   one chain and C=8, for chunks of 1, 3 and all 8 rounds (labels and v
   equal, eps and beta to 1e-4 of their norms), the chunk of every round
   bitwise equal to #1 / #3, chunks of 3 run in turn bitwise equal to the
   whole sweep, the fused chains bitwise equal to #5; at the headline (on
   phase 2's words) all 123 rounds timed and bitwise equal to #1 / #3, and
   the first 8 rounds as chunks of 2 against the plain version under
   phase 13b's gates; (b) ``biobank-sharded-m1``: ``ShardedSpikeSlabSampler``
   on phase 2's words on a (1, 1) mesh of a real one-rank NCCL group,
   ``.run(generator, ChainConfig(30, 10, 10), sink=CSVSink(...))`` with the
   counts reset just before, against phase 4's ms/iter, a profile of 2
   steps (dot / solve / apply / NCCL, idle); (c) its ``run_chains`` of 8
   into a ChainFanoutSink against phase 8c's; (d) Dm = 2 on the one card:
   two spawned ranks of a gloo group (NCCL takes no two ranks on one
   device) on N=4096 x M=16,384 words, ``chunk_blocks`` 128 and 32 (2 and
   8 chunks a sweep), one chain and C=4, 3 steps: the replicated scalars
   and eps bitwise equal on both ranks after every step, tracked vs
   recomputed eps, each rank's first chunk against its plain version.

24. int8 codes (``x_dtype="int8"``, one byte a genotype), decoded from
   phase 2's words (individual order already: the port's words carry no
   lane permutation), through the int8 mode of every sweep kernel: (a)
   each int8 entry point against its plain version at N=4096 and N=4001 x
   M=8192 (M=2048 for the serial, row and ``_q`` sweeps, the serial and
   ``_q`` ones over 2 of their 4 blocks), one sweep from
   a warm state (the strided kernels J=32, B=32 one
   chain and C=8 fused, their chunks of rounds #5/#6, the serial fold
   B=512 one chain and C=8, the row sweep J=8, B=128, the serial in-kernel
   decode on codes with missing calls): labels and v equal, floats as phase
   10, fused chains bitwise equal to the single-chain kernel, #5/#6 over
   every round bitwise #1/#3; (b) int8 against the 2-bit fold kernels on
   phase 2's first 8,192 markers (BayesR by ``flip_replay`` as 17b, the
   horseshoe to 1e-4); (c) biobank-int8-auto, N=100,352 x M=503,808 (47.09
   GiB of codes, used without a copy), auto plan J=128, B=32:
   ``SpikeSlabSampler(codes, Y, cva, BayesRConfig(emit_epsilon=False),
   x_dtype="int8", transposed=True, x_stats=...).run(generator,
   ChainConfig(30, 10, 10), sink=CSVSink(...))`` with the launch counter
   reset just before (CSV widths, finite values, tracked vs recomputed
   eps, launches, peak memory < 75 GiB), a profile of 2 steps, the sweep
   timed (mean of 3) with its bound and ``torch.matmul`` yardstick, 8
   rounds against the plain version (labels >= 99.9 %, |d eps| / |eps| <
   1e-3); (d) biobank-int8-horseshoe (``ChainConfig(10, 5, 5)``, the sweep
   against plain under phase 5b's 1e-4 bounds), biobank-int8-8chain and its
   horseshoe (``run_chains`` of 8, fused, 5 iterations), the row plan J=32,
   B=128 of both samplers (2 iterations, 8 fused chains through the serial
   fused sweep, 8 rounds against plain), the serial int8 fold at the
   headline (J=1, B=512: one sweep of each kernel timed, 1 block against
   plain) with its main paths at the auto plan of M=1500; (e)
   biobank-int8-missing: code 3 written in place at probability 2^-6, the
   auto plan falling to J=1 (B=32) through the in-kernel decode, BayesR
   ``ChainConfig(10, 5, 5)`` and the horseshoe 3 iterations, one sweep
   timed and ``HEADLINE_PLAIN_BLOCKS`` blocks against plain; (f) the
   sharded driver on int8 codes on a (1, 1) NCCL mesh at N=4096 x
   M=16,384: the same device codes, #5/#6 over every round bitwise #1/#3,
   5 iterations of one chain and of 8 fused chains with their launch
   counts; (g) the CLI with ``--x-dtype int8`` on a .bed with missing
   calls (N=8,192 x M=4,096).  It logs its seconds.

25. the sharded horseshoe and the split sweep (``parallel/``), the last
   callers of #10, #13 and #14: (a) #10 through
   ``ShardedHorseshoeSampler``'s chunked call on a one-rank NCCL mesh at
   N=4096 x M=8192 (B=512) in each storage mode (2-bit fold, 2-bit with
   missing calls through ``_q``, int8, dense), ``chunk_blocks`` 3 and the
   default: the first 4 blocks against the plain versions under phase
   10a's gates, a sweep's launches; (b) biobank-horseshoe-sharded-m1, the
   sampler on phase 2's words (not copied), ``.run(generator,
   ChainConfig(5, 2, 2), sink=CSVSink(...))`` with #10's count reset just
   before (3 x 984 launches a step), beside biobank-horseshoe-serial's
   ms/iter (phase 12), a profile of one step; (c) dense-16kx49k (X built
   on the card) through the split sweep (``split_sweep=True``, J=8, B=512,
   nr=12) on the one-rank mesh, both samplers: the first two rounds'
   solves against their plain versions, ``.run(..., ChainConfig(4, 2,
   2))`` with one #13 / #14 launch a round, beside phase 18's ms/iter,
   and a round's split into mv's, solve, all-reduces and the rest; (d)
   four spawned gloo ranks on the card: dense N=4096 x M=8192 on (1, 2)
   (each half of them) and (2, 2) meshes, both samplers, the split sweep
   and ``backend="xla"`` (on the first 512 markers), 3 steps: the
   replicated scalars bitwise equal on every rank, eps on each "m"
   group, tracked vs recomputed eps, the round solves' launches; (e)
   chains over devices on each half: 4 fused chains a rank (2-bit words
   at N=4096 x M=8192, both samplers), every rank's chains bitwise a
   one-rank ``run_chains`` of its streams.

26. the grouped sampler with fixed effects (``GroupsConfig``, bench.py's
   four groups and slab variances, ``g_assign = m % 4``) and its warm
   restart, checkpoint and resume: (a) at N=4096 x M=8192 with F=3
   covariates, from states warmed by 2 grouped steps, each kernel of the
   grouped paths against its plain version at G=4: #1 (2-bit fold,
   ``miss``, dense, int8), #3 at C=8, #5 through the sharded sampler's
   chunk on a one-rank mesh, #9 (2-bit fold at B=512 and the int8 ``_q``
   decode, over 2 blocks), #11 at C=8, #13 through the split sweep (its
   first 2 rounds) and #16 (J=8, B=512): labels and v equal, bacc to a
   relative 1e-5 per group, beta and eps as phases 2a / 10a / 21a, fused
   chain 0 bitwise the single-chain kernel; each path's 2-step run with
   its launch count; (b) biobank-groups on phase 2's words (not copied):
   ``SpikeSlabSampler(words, Y, cva (4, 3), GroupsConfig(), g_assign=...,
   x_dtype="2bit", ...).run(generator, ChainConfig(10, 5, 5),
   sink=CSVSink(..., "groups", ...))`` with #1's count reset just before
   (the auto cell's launches a step), its ms/iter beside
   biobank-packed-auto's (phase 4) and a profile of 2 steps, then its twin
   with F=12 seeded covariates; the header byte-equal to the schema, every row its width,
   finite values, tracked vs recomputed eps (the fixed term included) <
   1e-4; (c) 8 fused grouped chains there (F=12), 3 iterations, launches
   counted, chain 0 of a fused sweep bitwise the single-chain kernel; (d)
   at N=4096 x M=8192 the groups variant (F=3) and the horseshoe: 6
   iterations against 3, ``save_checkpoint``, ``load_checkpoint`` into a
   new sampler object and 3 more, every state field and CSV value equal;
   (e) BRV2Grstart's restart from (b)'s CSV: ``state_kwargs_from_csv``
   (``parse_last_row``) of the full-width row, ``init_from`` on the words
   (the API function takes dense X), eps equal to the CSV's values (the
   sink prints each f32 as a decimal that reads back to it), each group's
   pi summing to 1, 5 iterations into a ``grstart`` CSV, tracked vs
   recomputed eps < 1e-4; (f) the CLI on a dense .npy of N=4096 x M=8192
   on the card: ``groups --groups-file --fixed --checkpoint-out``, then
   ``resume --checkpoint`` and ``resume --from-csv``, each CSV's header
   and widths and #1's launches.

27. the slice of the CLI, the sinks and float64 (no new kernel): (a) at
   the dense cell dense-16kx49k, its X (built on the card from a seed)
   saved once as a Fortran-order .npy, ``python -m bayesrrcpp_tpu_torch
   bayesr --x --y --no-standardize --npz-out`` in f32 through the auto
   plan twice (seeds 1, 2; 10 iterations, 4 rows; #1's launches counted),
   every .npz column equal to the CSV rows as parsed, then ``summarize
   --npz a --npz b --x --y --top 10`` (its JSON keys JAX's), then the
   horseshoe's ``run`` there (#2's launches, its decile lines); (b)
   float64 on the card at N=4096 x M=1024 (B=64) for BayesR, the
   horseshoe and the groups variant with F=3: the blocked sweep against
   the scan in the blocked permutation over 2 steps from one generator
   (labels equal, floats to rtol 1e-8 / atol 1e-10), one step of the
   scan in the full permutation, tracked vs exact float64 eps < 1e-10
   relative, the scan resumed from a checkpoint after its first step
   bitwise the uninterrupted run (the horseshoe and the groups variant),
   each path's ms/iter; (c)
   ``ShardedSpikeSlabSampler(backend="xla", dtype=float64)`` on a
   one-rank NCCL mesh replaying the init and first step of (b)'s BayesR
   blocked run (the block orders re-keyed by sweep position): every state
   field bitwise that run's.  It logs its seconds.

Phases 8b, 9b and 13b also profile one more fused strided sweep and log
the apply's device us a round against ``tools/kernel_bounds.apply_round``
(the round's moved rows and, in the miss mode, their missing calls);
phases 10b, 11b and 24e profile one more serial sweep and log the share
of steps that moved, the windowed solve's dependent windows
(``ops/block_sweep.dependent_windows`` at the kernel's W) and its us a
window.  Phases 7, 8c, 9c, 14 and 23b-23c (the strided 2-bit cells, one
chain and fused, fold and ``miss``), 18, 19, 22 (the dense and int8 row
plans) and 24c-24d log each profiled dot and apply launch
beside its bound (``tools/kernel_bounds.dot_round``, ``apply_round``,
``row_apply_round`` over the window's moved rows and, in the miss mode,
missing calls), the dense phases also one ``torch.addmv`` (``addmm`` for
8 chains) computing the apply on a launch's rows, its PyTorch yardstick.
Each such line ends with the card's nvidia-smi name and power limit.

Phases 17-26 run after phase 12, on phase 2's words for 17b, 21b, 23,
24, 25b and 26b-26c; 13-16 after 26, and 27 last.
Each group of phases logs the seconds since the start.  The
three kernel libraries build at once (one nvcc per source).  The script
prints its total time before the last two lines.  The last
two lines of standard output are the kernels' JSON record (with each
sweep's bound: the larger of its bytes over 3.35 TB/s and its FP32 FMAs
over 67 TFLOP/s) and the device JSON.  Nothing of JAX is imported.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

START = time.perf_counter()
CVA = [0.0001, 0.001, 0.01]
HEADLINE_N, HEADLINE_M = 100_352, 503_808
# (iterations, burn-in, thinning) of the horseshoe recovery chain: from its
# prior init, tau starts near 1e-7 at this size and some chains take a few
# hundred iterations to leave the collapsed mode (all signal in sigmaE)
HS_RECOVERY_CHAIN = (600, 300, 1)
CHAINS = 8                          # the 8-chain cells
# blocks of a serial headline sweep held against the plain version, whose
# host loop takes ~1-1.6 s a block there
HEADLINE_PLAIN_BLOCKS = 2
# rounds of a BayesR strided sweep at the headline held against the plain
# version (2b, 8b, 13b: #5 / #6 over them; the plain step takes ~0.6 ms)
HEADLINE_PLAIN_ROUNDS = 16
# blocks of a serial sweep of 512 markers at N=4096 / 4001 held against the
# plain version (17a, 24a: ~1,024 steps; the plain BayesR step takes ~3 ms)
SMALL_SERIAL_BLOCKS = 2
# rounds of a row-layout sweep at N=4096 / 4001 held against the plain
# version (21a)
SMALL_ROW_ROUNDS = 16
# per-chain operands of the sweeps, by position (ops/jacobi_t.py)
BAYESR_CHAIN_ARGS = (3, 4, 5, 8, 9, 10, 12, 13)
HS_CHAIN_ARGS = (3, 4, 7, 8, 9, 10, 11)


CARD = "not read"                   # nvidia-smi name, power limit (phase 1)
CELL_MS = {}                        # ms/iter of main paths, by cell name


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def elapsed(phases):
    log(f"[t] phases {phases} done {time.perf_counter() - START:.1f} s "
        f"after the start")


def hs_sweep_args(s, st, v):
    """The horseshoe main path's sweep operands for state ``st`` with fresh
    variates from ``v`` (models/horseshoe.py:HorseshoeSampler.step)."""
    d = s.data
    rho, inner = v.orders(s.nb, s.B, s.jacobi)
    args = (d.XT, d.gram, d.xsq, st.eps, st.beta, rho, inner, v.z(s.Mpad),
            st.lam, st.tau, st.c2, st.sigmaE, d.valid)
    return args, dict(J=s.jacobi, **s._sweep_kw())


def chain_args(args, c, per_chain):
    """Chain c's single-chain sweep operands from a fused sweep's."""
    return tuple(a[c] if k in per_chain else a for k, a in enumerate(args))


def sweep_bound(s, chains, moved, marker_arrays, gram_rows=None,
                extra_fmas=0):
    """(bound_ms, bound_by) of one sweep of ``chains`` chains on sampler
    ``s``'s data, by ``tools/kernel_bounds.sweep``: ``moved`` rows applied
    (summed over chains), ``marker_arrays`` per-chain marker vectors, and
    the Gram bytes of every block, or of ``gram_rows`` rows of B floats
    when given (a serial sweep needs the Gram row of a marker only where it
    moved, in any chain).  ``extra_fmas``: the missing-call mode's
    indicator terms (``missing_fmas``)."""
    from bayesrrcpp_tpu_torch.tools import kernel_bounds

    d = s.data
    gram_floats = d.gram.numel() if gram_rows is None else gram_rows * s.B
    b = kernel_bounds.sweep(s.Npad, s.Mpad, gram_floats, chains,
                            marker_arrays, moved, extra_fmas)
    return b["bound_ms"], b["bound_by"]


def missing_calls(torch, s, rows=4096):
    """Missing calls (code 3) per marker (Mpad,) int64 in sampler ``s``'s
    words, on real markers (< M) and lanes (< N) only, counted from the
    words' indicator bits ``w & (w >> 1) & 0x55555555`` in chunks."""
    d = s.data
    dev = d.XT.device
    lane_bits = (d.row_valid.view(-1, 16).to(torch.int64)
                 << (2 * torch.arange(16, device=dev))).sum(dim=1)
    lane_bits = lane_bits.to(torch.int32)       # bits 2k of the real lanes
    count = torch.zeros(s.Mpad, dtype=torch.int64, device=dev)
    for a in range(0, s.M, rows):
        w = d.XT[a:min(a + rows, s.M)]
        x = w & (w >> 1) & lane_bits            # one bit per missing call
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        x = (x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF) + (x >> 24)
        count[a:a + w.shape[0]] = x.sum(dim=1)
    return count


def missing_fmas(miss, moved):
    """The indicator terms of a ``miss`` sweep: each chain's dot adds one
    per missing call, each moved row's apply one per missing call of the
    row.  ``miss`` (Mpad,) from ``missing_calls``; ``moved`` (Mpad,) or
    (C, Mpad) bool, the markers each chain moved."""
    lead = moved if moved.dim() == 2 else moved[None]
    return (lead.shape[0] * int(miss.sum())
            + int((lead * miss).sum()))


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
    return args, dict(J=s.jacobi, **s._sweep_kw())


def timed(torch, fn, reps):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def dot_yardstick(torch, s, rows, eps):
    """ms of one ``torch.matmul`` of sampler ``s``'s decoded ``rows`` (2-bit
    words or int8 codes) by ``eps`` ((Npad,) or (C, Npad)): the PyTorch
    yardstick of one dot launch (the decode is not timed).  Never called by
    the port."""
    from bayesrrcpp_tpu_torch.ops.genotypes import decode_rows

    d = s.data
    x = decode_rows(d.XT[rows], d.x_mean[rows], d.x_scale[rows],
                    d.row_valid if s.x_packed else None)
    rhs = eps.T.contiguous() if eps.dim() == 2 else eps
    return timed(torch, lambda: torch.matmul(x, rhs), 5)[1]


def round_rows(torch, s, rho):
    """The markers of the strided plan's round ``rho``."""
    j = torch.arange(s.jacobi, device=rho.device)
    return ((j * (s.nb // s.jacobi) + rho)[:, None] * s.B
            + torch.arange(s.B, device=rho.device)).reshape(-1)


def packed_sampler(torch, bt, g, N, M, cfg, signal=None, missing=False,
                   **plan):
    make = (bt.simulate.random_packed_words_missing if missing
            else bt.simulate.random_packed_words)
    words = make(g, M, N // 16, device="cuda")
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
              device="cuda", **plan)
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


def main_path(torch, run, sink, counter):
    """``run(sink)`` (a sampler's ``run`` or ``run_chains`` into ``sink``)
    with ``counter``'s launch count set to 0 just before; returns (state,
    rows, seconds, launches, peak GiB).  The sink is closed, so its files
    are complete, before the clock stops; the seconds of the run itself
    and of the close are logged apart."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter.launches = 0
    t0 = time.perf_counter()
    try:
        st, out = run(sink)
        torch.cuda.synchronize()
    finally:
        t1 = time.perf_counter()
        sink.close()
    wall = time.perf_counter() - t0
    log(f"    run {t1 - t0:.3f} s, sink close {wall - (t1 - t0):.3f} s")
    return (st, out, wall, counter.launches,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def read_csv(path):
    """(header, row widths, whether any value is nan or inf) of a CSV."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split(",")
        rows = [r for r in f.read().split("\n") if r]
    return (header, [r.count(", ") + 1 for r in rows],
            any("nan" in r or "inf" in r for r in rows))


def profile_split(torch, fn, names, want=None, counted=None):
    """Device time per launch (us) and launch count of the kernels whose
    names contain each of ``names``, over one call of ``fn``, plus the
    total device time and the wall time (ms) of the call.

    With ``want``, a window in which the tracer recorded fewer than 95 % of
    ``want`` launches of a kernel in ``counted`` (default: all of ``names``)
    is logged and profiled again, up to three windows: under load on the
    host the tracer can lose a stretch of a window's kernel records (every
    kernel short by the same count), while the launch counters show that
    the launches were made. The last window is returned; ``profiled``
    still holds it."""
    counted = names if counted is None else counted
    for _ in range(3):
        split, dev_ms, wall_ms = profile_once(torch, fn, names)
        short = {n: split[n][1] for n in counted
                 if split[n][1] < 0.95 * want} if want else {}
        if not short:
            break
        log(f"profiler recorded {short} of {want} launches; profiling the "
            f"window again")
    return split, dev_ms, wall_ms


def profile_once(torch, fn, names):
    """One profiled call of ``fn``: ``profile_split`` without the retry."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the tracer can drop the first kernel records of a window (the
        # first 4 of 24, every window, behind one small op and 0.1 s): give
        # it 64 small launches and a moment before the profiled call
        x = torch.ones(1, device="cuda")
        for _ in range(64):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.3)
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


def apply_report(torch, tag, s, fn, args, kw, moved_any, miss=None):
    """One more call of the fused strided sweep ``fn(*args, **kw)`` under
    the profiler: apply_mc_kernel's device us a round against
    ``tools/kernel_bounds.apply_round`` over the round's mean moved rows
    (``moved_any`` (Mpad,) bool: moved in any chain) and, in the miss mode,
    their missing calls (``miss`` (Mpad,), ``missing_calls``); logged with
    the card."""
    from bayesrrcpp_tpu_torch.tools import kernel_bounds

    split, _, _ = profile_split(torch, lambda: fn(*args, **kw),
                                ("apply_mc_kernel",))
    us, n = split["apply_mc_kernel"]
    nr = s.nb // s.jacobi
    rows = int(moved_any.sum()) / nr
    nmiss = 0 if miss is None else int((miss * moved_any).sum()) / nr
    b = kernel_bounds.apply_round(s.Npad, rows, args[3].shape[0], nmiss)
    bound_us = b["bound_ms"] * 1e3
    log(f"{tag} apply_mc_kernel {us:.2f} us a round (x {n}); apply_round "
        f"{bound_us:.2f} us ({b['bound_by']}) for {rows:.1f} moved rows"
        + (f" and {nmiss:.1f} missing calls" if miss is not None else "")
        + f" a round: {us / bound_us:.2f}x the bound; {CARD}")
    return us


class Steps:
    """``steps`` steps of sampler ``s`` from ``st`` (one chain, or fused
    chains: ``st.eps`` (C, N)), a window for ``profile_split``; each step's
    state is kept, so that the markers moved in the last window (beta
    changed, in any chain) are counted after it, outside the window."""

    def __init__(self, s, st, v, steps=2):
        self.s, self.st, self.v, self.steps = s, st, v, steps
        self.states = []

    def __call__(self):
        st = self.st
        self.states = [st]
        for _ in range(self.steps):
            st = (self.s.step(st, self.v) if st.eps.dim() == 1
                  else self.s.step_chains(st, self.v))
            self.states.append(st)

    def moved(self):
        """Markers moved a step, in any chain (mean over the window)."""
        n = 0
        for a, b in zip(self.states, self.states[1:]):
            m = a.beta != b.beta
            n += int((m.any(dim=0) if m.dim() == 2 else m).sum())
        return n / self.steps


def round_report(torch, tag, split, dot, apply, dot_b, apply_b, x=None,
                 chains=None):
    """Log the dot's and the apply's device us a launch in ``split`` (a
    round, or a serial block) beside their bounds ``dot_b`` and ``apply_b``
    (``tools/kernel_bounds`` dicts of one launch); with ``x``, one launch's
    dense f32 rows (rows, N), also one ``torch.addmv`` (``torch.addmm`` for
    ``chains`` chains) computing the apply on them, eps - d.x: the apply's
    PyTorch yardstick, never called by the port.  Returns the yardstick's
    us (None without ``x``)."""
    lib = None
    if x is not None:
        g = torch.Generator(device="cuda").manual_seed(7)
        if chains is None:
            d = torch.randn(x.shape[0], generator=g, device="cuda")
            e = torch.zeros(x.shape[1], device="cuda")
            fn = lambda: torch.addmv(e, x.t(), d, alpha=-1)  # noqa: E731
        else:
            d = torch.randn((chains, x.shape[0]), generator=g, device="cuda")
            e = torch.zeros((chains, x.shape[1]), device="cuda")
            fn = lambda: torch.addmm(e, d, x, alpha=-1)  # noqa: E731
        fn()
        lib = timed(torch, fn, 10)[1] * 1e3
    dus, aus = split[dot][0], split[apply][0]
    dbu, abu = dot_b["bound_ms"] * 1e3, apply_b["bound_ms"] * 1e3
    log(f"{tag} a launch: {dot} {dus:.2f} us, bound {dbu:.2f} us "
        f"({dot_b['bound_by']}, {dus / dbu:.2f}x); {apply} {aus:.2f} us, "
        f"bound {abu:.2f} us ({apply_b['bound_by']}, {aus / abu:.2f}x)"
        + ("" if lib is None else
           f"; torch.{'addmv' if chains is None else 'addmm'} of the "
           f"launch's {x.shape[0]} rows {lib:.2f} us")
        + f"; {CARD}")
    return lib


def packed_report(torch, tag, split, names, s, chains, window,
                  miss_per_row=None):
    """``round_report`` of a strided 2-bit sweep's dot and apply (``names``:
    dot, solve, apply) in ``split``, against the bounds of one launch
    (``tools/kernel_bounds``): the dot over the round's J*B rows for
    ``chains`` chains, the apply over the rows moved a round in the
    profiled ``window`` (a ``Steps``) and, in the miss mode, their missing
    calls (``miss_per_row`` a row, mean over the markers)."""
    from bayesrrcpp_tpu_torch.tools import kernel_bounds

    rows = window.moved() / (s.nb // s.jacobi)
    jb, per = s.jacobi * s.B, miss_per_row or 0.0
    round_report(
        torch, tag, split, names[0], names[2],
        kernel_bounds.dot_round(s.Npad, jb, chains, 0.25, chains * per * jb),
        kernel_bounds.apply_round(s.Npad, rows, chains, rows * per))


def window_report(torch, tag, s, fn, args, kw, K):
    """One more call of the serial sweep ``fn(*args, **kw)`` (one chain or
    fused, J=1; over the blocks of its order, which may be a cut of the
    sweep's) under the profiler: the solve's device us a block, the share
    of steps that moved (beta changed), the dependent windows of the
    windowed solve at the kernel's W for (B, K) (per chain, by
    ``ops/block_sweep.dependent_windows``) and the us a window; logged
    with the card.  K == 0: the horseshoe."""
    from bayesrrcpp_tpu_torch.ops import _cuda
    from bayesrrcpp_tpu_torch.ops.block_sweep import dependent_windows

    W = _cuda.library("serial").lib.serial_window(s.B, K)
    res = []
    split, _, _ = profile_split(
        torch, lambda: res.append(tuple(fn(*args, **kw))),
        ("serial_solve_kernel",))
    us, n = split["serial_solve_kernel"]
    beta_in = args[4] if args[4].dim() == 2 else args[4][None]
    beta_out = res[0][1] if res[0][1].dim() == 2 else res[0][1][None]
    border, inner = (args[5], args[6]) if K == 0 else (args[6], args[7])
    b, inn = border.long(), inner[border.long()].long()
    share = windows = 0.0
    for bo, bi in zip(beta_out, beta_in):
        moved = torch.gather((bo != bi).reshape(-1, s.B)[b], 1, inn)
        share += float(moved.float().mean()) / len(beta_in)
        windows += dependent_windows(moved, W) / len(beta_in)
    log(f"{tag} windowed solve (W={W}): moving share {share:.4f}, "
        f"{windows:.0f} dependent windows a chain for {b.numel() * s.B} "
        f"steps, solve {us:.2f} us a block (x {n}), "
        f"{us * n / windows:.4f} us a window; {CARD}")
    return share, windows, us


def strided_solve_report(torch, tag, s, fn, args, kw, kernel):
    """One more strided BayesR sweep ``fn(*args, **kw)`` (one chain or
    fused) under the profiler: the solve's device us a launch (``kernel``),
    the share of steps that moved (beta changed), the solve's passes a
    block (one a mover and one more where steps follow the last mover:
    ``ops/block_sweep.dependent_windows`` at W = B, mean over the blocks
    and chains) and the us a pass (a launch's us over the passes a block);
    logged with the card."""
    from bayesrrcpp_tpu_torch.ops.block_sweep import dependent_windows

    res = []
    split, _, _ = profile_split(
        torch, lambda: res.append(fn(*args, **kw)), (kernel,))
    us, n = split[kernel]
    lead = (lambda x: x if x.dim() == 2 else x[None])
    beta_in, beta_out = lead(args[4]), lead(res[0].beta)
    inner = args[7].long()
    share = passes = 0.0
    for bo, bi in zip(beta_out, beta_in):
        moved = torch.gather((bo != bi).reshape(-1, s.B), 1, inner)
        share += float(moved.float().mean()) / len(beta_in)
        passes += dependent_windows(moved, s.B) / (s.nb * len(beta_in))
    log(f"{tag} strided solve by passes: moving share {share:.4f}, "
        f"{passes:.3f} passes a block of {s.B} steps, solve {us:.2f} us a "
        f"launch (x {n}), {us / passes:.3f} us a pass; {CARD}")
    return share, passes, us


def profiled(split, want):
    """Every profiled kernel ran, with at least 95 % of its ``want``
    launches recorded (the launch counters check the exact counts)."""
    return all(0.95 * want <= c <= want and us > 0
               for us, c in split.values())


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return smoke(torch, tmp)


def smoke(torch, tmp):
    """Phases 1-27 (module docstring; 17-26 run after 12, 13-16 after 26,
    27 last), their CSVs under ``tmp``; returns 0 or raises."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bayesrrcpp_tpu_torch as bt
    from bayesrrcpp_tpu_torch.io.sink import CSVSink
    from bayesrrcpp_tpu_torch.ops import _cuda
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
    from bayesrrcpp_tpu_torch.ops.jacobi_t import (
        LAUNCHES_PER_ROUND, bayesr_jacobi_t, bayesr_jacobi_t_reference,
        horseshoe_jacobi_t, horseshoe_jacobi_t_reference)

    # ---- 1. the card and the build
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    CARD = smi.stdout.strip().splitlines()[0]
    log(CARD)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _cuda.libraries("jacobi_t", "jacobi_t_mc", "serial")
    log(f"[1] built {', '.join(os.path.basename(b.path) for b in libs)} in "
        f"{time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{b.build_seconds:.1f}" for b in libs) + " s each)")
    for b in libs:
        log(b.build_log.strip())
    from bayesrrcpp_tpu_torch.io.native import get_native_writer

    log(f"[1] native CSV row formatter: "
        f"{'loaded' if get_native_writer() is not None else 'absent'}")
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
    pa, pkw, pfns = headline_plain_rounds(jt, args, kw, nr, "bayesr", None,
                                          None)
    pk = pfns[0](*pa, **pkw)
    ref, plain_ms = timed(torch, lambda: pfns[1](*pa, **pkw), 1)
    agree = float((pk.labels == ref.labels).float().mean())
    rel_eps = float(torch.linalg.norm(pk.eps - ref.eps)
                    / torch.linalg.norm(ref.eps))
    max_err = max(float((pk.eps - ref.eps).abs().max()),
                  float((pk.beta - ref.beta).abs().max()))
    log(f"[2b] headline sweep: kernel {ker_ms:.3f} ms, plain {plain_ms:.1f} "
        f"ms ({HEADLINE_PLAIN_ROUNDS} rounds through #5); label agreement "
        f"{agree:.6f}, |d eps|/|eps| {rel_eps:.3g}, max abs err "
        f"{max_err:.3g}")
    check(agree >= 0.999, f"headline label agreement {agree}")
    check(rel_eps < 1e-3, f"headline eps rel diff {rel_eps}")
    whole_in_chunks(torch, "[2b]", pfns, args, pkw, ker)
    bound_ms, bound_by = sweep_bound(s, 1, int((ker.beta != args[4]).sum()),
                                     6)
    lib_ms = dot_yardstick(torch, s, round_rows(torch, s, args[6][0]),
                           args[3]) * nr
    log(f"[2b] bound {bound_ms:.3f} ms ({bound_by}); dot yardstick "
        f"torch.matmul ({s.jacobi * s.B} x {s.Npad}) @ ({s.Npad},) x {nr} "
        f"rounds {lib_ms:.3f} ms")
    del args, ker, ref, pa, pk

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
    path = os.path.join(tmp, "chain.csv")
    st, out, wall, launches, peak_gb = main_path(
        torch, lambda sink: s.run(g, chain, sink=sink),
        CSVSink(path, "bayesr", M=s.M, N=s.N, emit_epsilon=False),
        bayesr_jacobi_t)
    header, widths, _ = read_csv(path)
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
    ms_iter_4 = wall / chain.max_iterations * 1e3
    strided_solve_report(torch, "[4]", s, bayesr_jacobi_t,
                         *sweep_args(s, st, bt.TorchVariates(g)),
                         "solve_kernel")
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
    hs_bound = sweep_bound(hs, 1, int((beta_k != args[4]).sum()), 4)
    hs_lib_ms = dot_yardstick(torch, hs, round_rows(torch, hs, args[5][0]),
                              args[3]) * nr
    log(f"[5b] bound {hs_bound[0]:.3f} ms ({hs_bound[1]}); dot yardstick "
        f"{hs_lib_ms:.3f} ms per sweep")
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
    path = os.path.join(tmp, "hs_chain.csv")
    st, out, wall, hs_launches, hs_peak = main_path(
        torch, lambda sink: hs.run(g, chain, sink=sink),
        CSVSink(path, "horseshoe", M=hs.M, N=hs.N, emit_epsilon=False),
        horseshoe_jacobi_t)
    header, widths, _ = read_csv(path)
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
    window = Steps(hs, st, bt.TorchVariates(g))
    split, dev_ms, wall_ms = profile_split(torch, window, names, want=2 * nr)
    check(profiled(split, 2 * nr), f"profiled launches {split}")
    log("[7] profile of 2 steps: " + ", ".join(
        f"{n} {us:.2f} us x {c}" for n, (us, c) in split.items())
        + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall")
    packed_report(torch, "[7] biobank-horseshoe", split, names, hs, 1, window)

    del st, out

    elapsed("1-7")

    # ---- 8-9. the fused multi-chain kernels and the 8-chain cells
    mc = {kind: fused_phases(torch, bt, kind, hs, tmp)
          for kind in ("bayesr", "horseshoe")}
    elapsed("8-9")

    # ---- 10-12. the serial (J=1) kernels and main paths
    serial_kernels = serial_phases(torch, bt, hs, tmp)
    elapsed("10-12")

    # ---- 17-20. dense X through the kernels' dense mode
    dense_kernels = dense_phases(torch, bt, hs, tmp)
    elapsed("17-20")

    # ---- 21-22. the row-layout sweeps, their round solves and main paths
    row_kernels = row_phases(torch, bt, hs, tmp)
    elapsed("21-22")

    # ---- 23. the marker-sharded driver and its chunked sweeps (#5, #6)
    sharded_kernels = sharded_phases(torch, bt, hs, tmp, ms_iter_4,
                                     mc["bayesr"]["ms_iter"])
    elapsed("23")

    # ---- 24. int8 codes, decoded from phase 2's words
    int8_kernels = int8_phases(torch, bt, hs, tmp)
    elapsed("24")

    # ---- 25. the sharded horseshoe (#10), the split sweep (#13, #14), the
    # (1, 2) / (2, 2) meshes and chains over devices
    sharded_callers = split_phases(torch, bt, hs, tmp)
    elapsed("25")

    # ---- 26. the grouped sampler with fixed effects, its warm restart,
    # checkpoint and resume
    grouped_callers = groups_phases(torch, bt, hs, tmp, ms_iter_4)
    elapsed("26")
    del hs

    # ---- 13-16. words with missing calls
    missing_kernels = missing_phases(torch, bt, tmp)
    elapsed("13-16")

    # ---- 27. the CLI's sinks and summarize at the dense cell, float64
    # through the blocked and scan sweeps, the sharded xla sampler
    scan_phases(torch, bt, tmp)
    elapsed("27")

    src = "bayesrrcpp_tpu_torch/csrc/jacobi_t.cu"
    src_mc = "bayesrrcpp_tpu_torch/csrc/jacobi_t_mc.cu"
    tpu = "bayesrrcpp_tpu/ops/pallas_jacobi_t.py"
    kernels = [
        {"name": "jacobi_t_sweep", "route": "cuda", "source": src,
         "replaces": f"{tpu}:405", "launches": bayesr_launches,
         "max_abs_err": max_err, "ms": ker_ms, "plain_ms": plain_ms,
         "plain_rounds": HEADLINE_PLAIN_ROUNDS,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms},
        {"name": "jacobi_t_hs_sweep", "route": "cuda", "source": src,
         "replaces": f"{tpu}:650", "launches": hs_launches,
         "max_abs_err": hs_err, "ms": hs_ms, "plain_ms": hs_plain_ms,
         "bound_ms": hs_bound[0], "bound_by": hs_bound[1],
         "library_ms": hs_lib_ms}]
    for kind, name, where in (("bayesr", "jacobi_t_mc_sweep", "1199/:2416"),
                              ("horseshoe", "jacobi_t_hs_mc_sweep",
                               "1742/:2922")):
        m = mc[kind]
        kernels.append({
            "name": name, "route": "cuda", "source": src_mc,
            "replaces": f"{tpu}:{where}", "launches": m["launches"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    kernels += (serial_kernels + missing_kernels + dense_kernels
                + row_kernels + sharded_kernels + int8_kernels)
    # the sites whose last callers are the sharded samplers (phase 25)
    callers = {"horseshoe_serial_sweep":
               "ShardedHorseshoeSampler (m, 1) chunked sweep",
               "bayesr_round_solve": "ShardedSpikeSlabSampler split sweep",
               "horseshoe_round_solve": "ShardedHorseshoeSampler split sweep"}
    for k in kernels:
        if k["name"] in callers:
            k["sharded_caller"] = callers[k["name"]]
            k["sharded_launches"] = sharded_callers[k["name"]]
        # the sites the grouped sampler (phase 26) runs at G=4
        if k["name"] in grouped_callers:
            k["grouped_caller"], k["grouped_launches"] = \
                grouped_callers[k["name"]]
    log(f"[total] {time.perf_counter() - START:.1f} s since the script "
        f"started")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def fused_phases(torch, bt, kind, hs, tmp):
    """Phases 8 (kind "bayesr") and 9 ("horseshoe"): the fused kernel of
    ``kind`` against its plain version and the single-chain kernel at
    N=4096 x M=8192 and at the headline (on the words of ``hs``), then the
    8-chain main path, its CSVs under ``tmp``.  Returns the kernel's JSON
    numbers."""
    from bayesrrcpp_tpu_torch.io.sink import ChainFanoutSink
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
    from bayesrrcpp_tpu_torch.utils.summary import split_rhat

    hsk = kind == "horseshoe"
    ph = "9" if hsk else "8"
    C, dev = CHAINS, torch.device("cuda")
    if hsk:
        fused, plain, single = (jt.horseshoe_jacobi_t_mc,
                                jt.horseshoe_jacobi_t_mc_reference,
                                jt.horseshoe_jacobi_t)
    else:
        fused, plain, single = (jt.bayesr_jacobi_t_mc,
                                jt.bayesr_jacobi_t_mc_reference,
                                jt.bayesr_jacobi_t)
    per_chain = HS_CHAIN_ARGS if hsk else BAYESR_CHAIN_ARGS
    make_args = hs_sweep_args if hsk else sweep_args
    cfg = bt.HorseshoeConfig if hsk else bt.BayesRConfig

    def outputs(res):
        # (eps, beta[, labels, v, beta_acum]): a sweep's result as a tuple
        return tuple(res)

    # ---- a. N=4096 x M=8192 from a warm 8-chain state
    g = torch.Generator(device=dev).manual_seed(4)
    v = bt.TorchVariates(g, chains=C)
    s = packed_sampler(torch, bt, g, 4096, 8192, cfg())
    st = s.init(v, chains=C)
    for _ in range(3):
        st = s.step_chains(st, v)
    args, kw = make_args(s, st, v)
    ker, ref = outputs(fused(*args, **kw)), outputs(plain(*args, **kw))
    ones = [outputs(single(*chain_args(args, c, per_chain), **kw))
            for c in range(C)]
    torch.cuda.synchronize()
    names = ("eps", "beta") + (() if hsk else ("labels", "v", "beta_acum"))
    for name, a, b in zip(names, ker, ref):
        if name in ("labels", "v"):
            check(torch.equal(a, b), f"[{ph}a] {name} differ from plain")
        else:
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
                  f"[{ph}a] {name} differs from plain: max |d| "
                  f"{float((a - b).abs().max())}")
    for c, one in enumerate(ones):
        for name, a, b in zip(names, one, ker):
            check(torch.equal(a, b[c]),
                  f"[{ph}a] chain {c} {name} differs from the single-chain "
                  f"kernel: max |d| {float((a - b[c]).abs().max())}")
    log(f"[{ph}a] {kind} fused C={C} N=4096 M=8192: plain max|d beta| "
        f"{float((ker[1] - ref[1]).abs().max()):.3g} max|d eps| "
        f"{float((ker[0] - ref[0]).abs().max()):.3g}; every chain bitwise "
        f"equal to the single-chain kernel")
    del s, st, args, ker, ref, ones

    # ---- b. the headline, on the words of phase 2
    t0 = time.perf_counter()
    common = dict(transposed=True, x_dtype="2bit", device="cuda",
                  x_stats=bt.simulate.packed_word_stats(HEADLINE_M))
    if hsk:
        s = hs
    else:
        s = bt.SpikeSlabSampler(hs.data.XT, hs.Y[:hs.N], CVA,
                                bt.BayesRConfig(emit_epsilon=False), **common)
        torch.cuda.synchronize()
        check(s.data.XT.data_ptr() == hs.data.XT.data_ptr(), "words copied")
    setup_s = time.perf_counter() - t0
    nr = s.nb // s.jacobi
    g = torch.Generator(device=dev).manual_seed(5)
    v = bt.TorchVariates(g, chains=C)
    st = s.init(v, chains=C)
    for _ in range(2):
        st = s.step_chains(st, v)
    args, kw = make_args(s, st, v)
    ker, ms = timed(torch, lambda: outputs(fused(*args, **kw)), 3)
    ones, singles_ms = timed(torch, lambda: [
        outputs(single(*chain_args(args, c, per_chain), **kw))
        for c in range(C)], 1)
    pa, pkw, pfns = headline_plain_rounds(jt, args, kw, nr, kind, C,
                                          (fused, plain))
    pk = outputs(pfns[0](*pa, **pkw))
    ref, plain_ms = timed(torch, lambda: outputs(pfns[1](*pa, **pkw)), 1)
    bitwise = all(torch.equal(a, b[c]) for c, one in enumerate(ones)
                  for a, b in zip(one, ker))
    rel_eps, rel_beta = rel_err(pk[0], ref[0]), rel_err(pk[1], ref[1])
    max_err = max(float((pk[0] - ref[0]).abs().max()),
                  float((pk[1] - ref[1]).abs().max()))
    moved = int((ker[1] != args[4]).sum())
    bound_ms, bound_by = sweep_bound(s, C, moved, 4 if hsk else 6)
    # the dot's yardstick: one round's rows decoded, times the C eps
    lib_ms = dot_yardstick(torch, s, round_rows(
        torch, s, args[5 if hsk else 6][0]), args[3])
    log(f"[{ph}b] {kind} fused C={C} headline (sampler {setup_s:.2f} s): "
        f"sweep {ms:.3f} ms, {C} single-chain sweeps {singles_ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms ({len(pa[6])} rounds), bound "
        f"{bound_ms:.3f} ms ({bound_by}, "
        f"{moved} markers moved); |d eps|/|eps| {rel_eps:.3g}, |d beta|/"
        f"|beta| {rel_beta:.3g}, max abs err {max_err:.3g}; chains bitwise "
        f"equal to the single-chain kernel: {bitwise}; dot yardstick "
        f"torch.matmul ({s.jacobi * s.B} x {s.Npad}) @ ({s.Npad} x {C}) "
        f"{lib_ms:.4f} ms per round, x {nr} rounds {lib_ms * nr:.3f} ms")
    apply_report(torch, f"[{ph}b] {kind} fused C={C}", s,
                 lambda *a, **k: outputs(fused(*a, **k)), args, kw,
                 (ker[1] != args[4]).any(dim=0))
    if not hsk:
        strided_solve_report(torch, f"[{ph}b] {kind} fused C={C}", s, fused,
                             args, kw, "solve_mc_kernel")
    if hsk:
        check(rel_eps < 1e-4, f"[9b] headline eps rel diff {rel_eps}")
        check(rel_beta < 1e-4, f"[9b] headline beta rel diff {rel_beta}")
    else:
        agree = float((pk[2] == ref[2]).float().mean())
        log(f"[8b] label agreement {agree:.6f}")
        check(agree >= 0.999, f"[8b] headline label agreement {agree}")
        check(rel_eps < 1e-3, f"[8b] headline eps rel diff {rel_eps}")
        whole_in_chunks(torch, "[8b]", pfns, args, pkw, ker)
    del st, args, ker, ref, ones, pa, pk

    # ---- c. the 8-chain main path
    chain = bt.ChainConfig(30, 10, 10)
    schema = "horseshoe" if hsk else "bayesr"
    stem = os.path.join(tmp, f"{schema}_8chain.csv")
    sink = ChainFanoutSink.csv(stem, C, schema, M=s.M, N=s.N,
                               emit_epsilon=False)
    g = torch.Generator(device=dev).manual_seed(6)
    marks = []
    st, out, wall, launches, peak_gb = main_path(
        torch, lambda sk: s.run_chains(
            g, C, chain, sink=sk,
            progress=lambda done, total: marks.append(time.perf_counter())),
        sink, fused)
    log(f"    chunks delivered at +" + ", +".join(
        f"{m - marks[0]:.3f}" for m in marks) + " s after the first")
    want = jt.LAUNCHES_PER_ROUND * nr * chain.max_iterations
    check(launches == want, f"[{ph}c] launches {launches} != {want}")
    for path in sink.paths:
        header, widths, bad = read_csv(path)
        check(len(header) == 2 + 2 * s.M + 2,
              f"[{ph}c] {path} header width {len(header)}")
        check(widths == [len(header)] * 2, f"[{ph}c] {path} rows {widths}")
        check(not bad, f"[{ph}c] {path} has non-finite values")
    check(out["iteration"].shape == (2, C)
          and (out["iteration"] == [[10], [20]]).all(),
          f"[{ph}c] iterations {out['iteration']}")
    check(all(np_finite(v) for v in out.values()),
          f"[{ph}c] non-finite output")
    ex = s.refresh_eps(st).eps
    rel = (torch.linalg.norm(st.eps - ex, dim=1)
           / torch.linalg.norm(ex, dim=1))
    check(float(rel.max()) < 1e-4, f"[{ph}c] tracked eps vs recompute {rel}")
    log(f"[{ph}c] {schema}-8chain main path: "
        f"{wall / chain.max_iterations * 1e3:.2f} ms/iter ({wall:.2f} s for "
        f"{chain.max_iterations} iterations of {C} chains incl. {C} CSVs), "
        f"peak {peak_gb:.2f} GiB, launches {launches} (want {want}), "
        f"tracked-vs-exact eps max {float(rel.max()):.3g}, sigmaE "
        + " ".join(f"{x:.5f}" for x in st.sigmaE.tolist()))

    # 8 fused steps against 8 single-chain steps per chain, same state
    vc = bt.TorchVariates(g, chains=C)
    trace = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sf = st
    for _ in range(8):
        sf = s.step_chains(sf, vc)
        trace.append(sf.sigmaE)
    torch.cuda.synchronize()
    fused_step_ms = (time.perf_counter() - t0) / 8 * 1e3
    t0 = time.perf_counter()
    su = st
    for _ in range(2):
        su = s._step_unfused(su, vc)
    torch.cuda.synchronize()
    unfused_step_ms = (time.perf_counter() - t0) / 2 * 1e3
    rhat = float(split_rhat(torch.stack(trace).cpu().numpy()))
    log(f"[{ph}c] one fused step of {C} chains {fused_step_ms:.2f} ms; "
        f"{C} single-chain steps {unfused_step_ms:.2f} ms; split-R-hat of "
        f"sigmaE over the 8 fused steps {rhat:.4f} (information only)")
    names = (("dot_mc_kernel", "hs_solve_mc_kernel", "apply_mc_kernel")
             if hsk else ("dot_mc_kernel", "solve_mc_kernel",
                          "apply_mc_kernel"))

    window = Steps(s, sf, vc)
    split, dev_ms, wall_ms = profile_split(torch, window, names, want=2 * nr)
    check(profiled(split, 2 * nr), f"[{ph}c] profiled launches {split}")
    log(f"[{ph}c] profile of 2 fused steps: " + ", ".join(
        f"{n} {us:.2f} us x {c}" for n, (us, c) in split.items())
        + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall")
    packed_report(torch, f"[{ph}c] {schema}-8chain", split, names, s, C,
                  window)
    return dict(launches=launches, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms * nr,
                ms_iter=wall / chain.max_iterations * 1e3)


def serial_args(s, st, v, n=None):
    """The serial sweep's operands for state ``st`` with fresh variates
    from ``v`` (models/bayesr.py:SpikeSlabSampler.step at J=1): the block
    order, and p/z by position (by marker for a chain-batched ``v``), cut
    to the first ``n`` blocks when given."""
    d = s.data
    border, inner = v.block_orders(s.nb, s.B)
    p, z = v.p(s.Mpad), v.z(s.Mpad)
    if n is not None:
        border = border[:n]
        if p.dim() == 1:
            p, z = p[:n * s.B], z[:n * s.B]
    return (d.XT, d.gram, d.xsq, st.eps, st.beta, st.labels, border, inner,
            p, z, st.pi, d.cva, st.sigmaE, st.sigmaGG, d.g_assign,
            d.valid), s._sweep_kw()


def hs_serial_args(s, st, v, n=None):
    """The horseshoe's serial sweep operands, as ``serial_args``."""
    d = s.data
    border, inner = v.block_orders(s.nb, s.B)
    z = v.z(s.Mpad)
    if n is not None:
        border = border[:n]
        if z.dim() == 1:
            z = z[:n * s.B]
    return (d.XT, d.gram, d.xsq, st.eps, st.beta, border, inner, z, st.lam,
            st.tau, st.c2, st.sigmaE, d.valid), s._sweep_kw()


def check_sweeps(torch, tag, names, ker, ref):
    """labels and v equal; beta and bacc to rtol 1e-4 / atol 1e-5; eps to
    |d eps| / |eps| < 1e-4 and max |d eps| < 1e-4 max |eps|: a lane of eps
    sums the updates of up to 512 moved rows per block (every row, for the
    horseshoe) in another order than the plain matrix product, so its
    rounding grows with those sums, not with the lane's value (the
    horseshoe reads ~1e-5 relative at N=4096 x M=8192, B=512).  Returns
    the largest |d| of the floats."""
    worst = 0.0
    for name, a, b in zip(names, ker, ref):
        if name in ("labels", "v"):
            check(torch.equal(a, b), f"{tag} {name} differ from plain")
            continue
        d = float((a - b).abs().max())
        worst = max(worst, d)
        if name == "eps":
            rel = rel_err(a, b)
            check(rel < 1e-4 and d < 1e-4 * float(b.abs().max()),
                  f"{tag} eps differs from plain: |d|/|eps| {rel:.3g}, "
                  f"max |d| {d:.3g}")
        else:
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
                  f"{tag} {name} differs from plain: max |d| {d:.3g}")
    return worst


def single_chains(torch, args, kind, c):
    """Chain c of a fused serial sweep's operands as a single-chain
    sweep's: its p/z moved from marker to sweep-position order."""
    from bayesrrcpp_tpu_torch.ops.serial import position_markers

    hsk = kind == "horseshoe"
    one = list(chain_args(args, c, HS_CHAIN_ARGS if hsk
                          else BAYESR_CHAIN_ARGS))
    border, inner = (args[5], args[6]) if hsk else (args[6], args[7])
    at = position_markers(border, inner, args[1].shape[1])
    for k in ((7,) if hsk else (8, 9)):
        one[k] = one[k][at]
    return one


def serial_phases(torch, bt, hs, tmp):
    """Phases 10-12 (module docstring): the serial kernels and their fused
    versions against their plain versions at N=4096 x M=8192 and at the
    headline (on the words of ``hs``), the serial main paths and recovery;
    returns the four kernels' JSON records."""
    from bayesrrcpp_tpu_torch.io.sink import ChainFanoutSink, CSVSink
    from bayesrrcpp_tpu_torch.ops import multichain as mcs
    from bayesrrcpp_tpu_torch.ops import serial as ser

    dev = torch.device("cuda")
    kinds = {
        "bayesr": (ser.bayesr_sweep, ser.bayesr_sweep_reference,
                   mcs.bayesr_sweep_mc, mcs.bayesr_sweep_mc_reference,
                   bt.BayesRConfig, serial_args,
                   ("eps", "beta", "labels", "v", "beta_acum"), 6),
        "horseshoe": (ser.horseshoe_sweep, ser.horseshoe_sweep_reference,
                      mcs.horseshoe_sweep_mc,
                      mcs.horseshoe_sweep_mc_reference, bt.HorseshoeConfig,
                      hs_serial_args, ("eps", "beta"), 4)}
    records = {}

    # ---- 10a / 11a. N=4096 x M=8192 at B=512 (16 blocks), B=64 (128),
    # B=1024 (8; 16 fused chains: the 2-bit apply's largest list) and B=100
    # (88: padded markers, a dot CTA's rows past the block), each swept over
    # the first ~1,024 steps of the order (the plain BayesR sweep takes the
    # host 2.6-3.6 ms a step); (B, fused chains, blocks, blocks swept)
    for kind, (single, plain, fused, fused_plain, cfg, make_args, names,
               _) in kinds.items():
        for B, C, nb, n in ((512, CHAINS, 16, 2), (64, CHAINS, 128, 16),
                            (1024, 16, 8, 1), (100, CHAINS, 88, 10)):
            g = torch.Generator(device=dev).manual_seed(10 + B)
            v = bt.TorchVariates(g)
            s = packed_sampler(torch, bt, g, 4096, 8192, cfg(block_size=B),
                               jacobi_blocks=1)
            check((s.jacobi, s.B, s.nb) == (1, B, nb),
                  f"serial plan {(s.jacobi, s.B, s.nb)}")
            st = s._run_steps(s.init(v), v, 3)
            args, kw = make_args(s, st, v, n)
            ker = tuple(single(*args, **kw))
            err = check_sweeps(torch, f"[10a] {kind} B={B}", names, ker,
                               tuple(plain(*args, **kw)))
            v8 = bt.TorchVariates(g, chains=C)
            st8 = s.init(v8, chains=C)
            for _ in range(3):
                st8 = s.step_chains(st8, v8)
            args, kw = make_args(s, st8, v8, n)
            ker = tuple(fused(*args, **kw))
            ferr = check_sweeps(torch, f"[11a] {kind} B={B}", names, ker,
                                tuple(fused_plain(*args, **kw)))
            for c in range(C):
                one = single(*single_chains(torch, args, kind, c), **kw)
                for name, a, b in zip(names, one, ker):
                    check(torch.equal(a, b[c]),
                          f"[11a] {kind} B={B} chain {c} {name} differs "
                          f"from the single-chain serial kernel")
            log(f"[10a/11a] {kind} serial N=4096 M=8192 B={B} ({n} of {nb} "
                f"blocks): kernel vs "
                f"plain labels/v equal, max |d| {err:.3g}; fused C={C} "
                f"vs plain likewise, max |d| {ferr:.3g}; every chain bitwise "
                f"equal to the single-chain serial kernel")
            del s, st, st8, args, ker

    # ---- 10b / 11b. the headline, on the words of phase 2
    common = dict(transposed=True, x_dtype="2bit", device="cuda",
                  x_stats=bt.simulate.packed_word_stats(HEADLINE_M),
                  jacobi_blocks=1)
    samplers = {}
    for kind, (single, plain, fused, fused_plain, cfg, make_args, names,
               arrays) in kinds.items():
        t0 = time.perf_counter()
        if kind == "bayesr":
            s = bt.SpikeSlabSampler(hs.data.XT, hs.Y[:hs.N], CVA,
                                    cfg(emit_epsilon=False), **common)
        else:
            s = bt.HorseshoeSampler(hs.data.XT, hs.Y[:hs.N],
                                    cfg(emit_epsilon=False), **common)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        samplers[kind] = s
        check(s.data.XT.data_ptr() == hs.data.XT.data_ptr(), "words copied")
        check((s.jacobi, s.B, s.nb) == (1, 512, 984), "serial headline plan")
        g = torch.Generator(device=dev).manual_seed(20)
        v = bt.TorchVariates(g)
        st = s._run_steps(s.init(v), v, 2)
        args, kw = make_args(s, st, v, HEADLINE_PLAIN_BLOCKS)
        ker = tuple(single(*args, **kw))
        ref, plain_ms = timed(torch, lambda: tuple(plain(*args, **kw)), 1)
        rel_eps, rel_beta = rel_err(ker[0], ref[0]), rel_err(ker[1], ref[1])
        max_err = max(float((a - b).abs().max())
                      for a, b in zip(ker[:2], ref[:2]))
        agree = (float((ker[2] == ref[2]).float().mean())
                 if kind == "bayesr" else 1.0)
        args, kw = make_args(s, st, v)
        full, ms = timed(torch, lambda: tuple(single(*args, **kw)), 3)
        moved = int((full[1] != args[4]).sum())
        bound_ms, bound_by = sweep_bound(s, 1, moved, arrays, moved)
        border = args[5 if kind == "horseshoe" else 6]
        blk_rows = border[0] * s.B + torch.arange(s.B, device=dev)
        lib_ms = dot_yardstick(torch, s, blk_rows, args[3]) * s.nb
        log(f"[10b] {kind} serial headline (sampler on phase 2's words "
            f"{setup_s:.2f} s): {HEADLINE_PLAIN_BLOCKS} blocks vs plain: "
            f"label agreement "
            f"{agree:.6f}, |d eps|/|eps| {rel_eps:.3g}, |d beta|/|beta| "
            f"{rel_beta:.3g}, max abs err {max_err:.3g}, plain {plain_ms:.1f}"
            f" ms; full sweep ({s.nb} blocks, {s.nb * s.B} dependent steps) "
            f"{ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, {moved} "
            f"markers moved), dot yardstick torch.matmul ({s.B} x {s.Npad}) "
            f"@ ({s.Npad},) x {s.nb} blocks {lib_ms:.3f} ms")
        window_report(torch, f"[10b] {kind} serial headline", s, single,
                      args, kw, 0 if kind == "horseshoe" else
                      args[10].shape[-1])
        check(agree >= 0.999, f"[10b] label agreement {agree}")
        check(rel_eps < (1e-3 if kind == "bayesr" else 1e-4),
              f"[10b] {kind} eps rel diff {rel_eps}")
        records[kind] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                             plain_blocks=HEADLINE_PLAIN_BLOCKS,
                             sweep_blocks=int(s.nb),
                             dependent_steps=int(s.nb * s.B),
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=lib_ms)
        del args, full, ker, ref

        # 11b: C=8 fused chains from a warm 8-chain state
        v8 = bt.TorchVariates(g, chains=CHAINS)
        st8 = s.init(v8, chains=CHAINS)
        for _ in range(2):
            st8 = s.step_chains(st8, v8)
        args, kw = make_args(s, st8, v8, HEADLINE_PLAIN_BLOCKS)
        ker = tuple(fused(*args, **kw))
        ref, fplain_ms = timed(torch, lambda: tuple(fused_plain(*args, **kw)),
                               1)
        bitwise = all(torch.equal(a, b[c]) for c in range(CHAINS)
                      for a, b in zip(single(*single_chains(
                          torch, args, kind, c), **kw), ker))
        frel = rel_err(ker[0], ref[0])
        ferr = max(float((a - b).abs().max())
                   for a, b in zip(ker[:2], ref[:2]))
        fagree = (float((ker[2] == ref[2]).float().mean())
                  if kind == "bayesr" else 1.0)
        args, kw = make_args(s, st8, v8)
        full, fms = timed(torch, lambda: tuple(fused(*args, **kw)), 3)
        ones, singles_ms = timed(torch, lambda: [
            tuple(single(*single_chains(torch, args, kind, c), **kw))
            for c in range(CHAINS)], 1)
        bitwise_full = all(torch.equal(a, b[c]) for c, one in enumerate(ones)
                           for a, b in zip(one, full))
        fmoved = int((full[1] != args[4]).sum())
        fbound = sweep_bound(s, CHAINS, fmoved, arrays,
                             int((full[1] != args[4]).any(dim=0).sum()))
        flib_ms = dot_yardstick(torch, s, blk_rows, args[3]) * s.nb
        log(f"[11b] {kind} fused C={CHAINS} serial headline: "
            f"{HEADLINE_PLAIN_BLOCKS} blocks vs plain: label agreement "
            f"{fagree:.6f}, |d eps|/|eps| {frel:.3g}, max abs err "
            f"{ferr:.3g}, plain {fplain_ms:.1f} ms; chains bitwise equal to "
            f"the single-chain serial kernel: {bitwise} "
            f"({HEADLINE_PLAIN_BLOCKS} blocks), {bitwise_full} (full sweep); "
            f"full sweep {fms:.3f} ms"
            f", {CHAINS} single-chain sweeps {singles_ms:.3f} ms, bound "
            f"{fbound[0]:.3f} ms ({fbound[1]}, {fmoved} moved), dot "
            f"yardstick {flib_ms:.3f} ms")
        window_report(torch, f"[11b] {kind} fused C={CHAINS} serial "
                      "headline", s, fused, args, kw,
                      0 if kind == "horseshoe" else args[10].shape[-1])
        check(bitwise and bitwise_full, f"[11b] {kind} chains not bitwise")
        check(fagree >= 0.999, f"[11b] label agreement {fagree}")
        check(frel < (1e-3 if kind == "bayesr" else 1e-4),
              f"[11b] {kind} eps rel diff {frel}")
        records[kind + "_mc"] = dict(
            max_abs_err=ferr, ms=fms, plain_ms=fplain_ms,
            plain_blocks=HEADLINE_PLAIN_BLOCKS,
            sweep_blocks=int(s.nb), dependent_steps=int(s.nb * s.B),
            bound_ms=fbound[0], bound_by=fbound[1], library_ms=flib_ms)
        del args, full, ker, ref, ones, st8

    # ---- 12. the serial main paths, one chain and 8 fused chains
    for kind, s in samplers.items():
        single, fused = kinds[kind][0], kinds[kind][2]
        schema = kind
        for chains, counter in ((None, single), (CHAINS, fused)):
            g = torch.Generator(device=dev).manual_seed(30)
            if chains is None:
                chain = (bt.ChainConfig(10, 5, 5) if kind == "bayesr"
                         else bt.ChainConfig(5, 2, 2))
                path = os.path.join(tmp, f"{schema}_serial.csv")
                sink = CSVSink(path, schema, M=s.M, N=s.N, emit_epsilon=False)
                st, out, wall, launches, peak = main_path(
                    torch, lambda sk: s.run(g, chain, sink=sk), sink,
                    counter)
                paths = [path]
                rel = rel_err(st.eps, s.refresh_eps(st).eps)
                names = ("serial_dot_kernel", "serial_solve_kernel",
                         "serial_apply_kernel")
                split, dev_ms, wall_ms = profile_split(
                    torch, lambda: s._run_steps(st, bt.TorchVariates(g), 1),
                    names, want=s.nb)
                check(profiled(split, s.nb), f"[12] profiled launches {split}")
                log(f"[12] {kind} serial profile of 1 step: " + ", ".join(
                    f"{n} {us:.2f} us x {c}" for n, (us, c) in split.items())
                    + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall")
            else:
                chain = bt.ChainConfig(5, 2, 2)
                sink = ChainFanoutSink.csv(
                    os.path.join(tmp, f"{schema}_serial_8chain.csv"), chains,
                    schema, M=s.M, N=s.N, emit_epsilon=False)
                st, out, wall, launches, peak = main_path(
                    torch, lambda sk: s.run_chains(g, chains, chain, sink=sk),
                    sink, counter)
                paths = sink.paths
                ex = s.refresh_eps(st).eps
                rel = float((torch.linalg.norm(st.eps - ex, dim=1)
                             / torch.linalg.norm(ex, dim=1)).max())
            n_rows = len(list(chain.emit_iterations()))
            for path in paths:
                header, widths, bad = read_csv(path)
                check(len(header) == 2 + 2 * s.M + 2,
                      f"[12] {path} header width {len(header)}")
                check(widths == [len(header)] * n_rows,
                      f"[12] {path} rows {widths}")
                check(not bad, f"[12] {path} has non-finite values")
            check(all(np_finite(x) for x in out.values()),
                  f"[12] {kind} non-finite output")
            want = 3 * s.nb * chain.max_iterations
            cell = (f"biobank-{'packed' if kind == 'bayesr' else kind}-serial"
                    + ("" if chains is None else f"-{chains}chain"))
            CELL_MS[cell] = wall / chain.max_iterations * 1e3
            log(f"[12] {cell} main path: "
                f"{wall / chain.max_iterations * 1e3:.2f} ms/iter ({wall:.2f}"
                f" s for {chain.max_iterations} iterations incl. CSV), peak "
                f"{peak:.2f} GiB, launches {launches} (want {want}), "
                f"tracked-vs-exact eps {rel:.3g}")
            check(rel < 1e-4, f"[12] {cell} tracked eps vs recompute {rel}")
            check(launches == want, f"[12] {cell} launches {launches}")
            records[kind + ("" if chains is None else "_mc")][
                "launches"] = launches
        del st, out
    del samplers, s

    # ---- 12. recovery at J=1 (N=4096, M=2048, block_size 256)
    for kind in kinds:
        gr = torch.Generator(device=dev).manual_seed(13)
        beta_true = recovery_signal(torch, gr, 2048)
        if kind == "bayesr":
            cfg, rchain = bt.BayesRConfig(block_size=256), (100, 60, 1)
        else:
            A = (1.0 / 4096 ** 0.5) * 32 / (2048 - 32)
            cfg = bt.HorseshoeConfig(A=A, block_size=256)
            rchain = HS_RECOVERY_CHAIN
        sr = packed_sampler(torch, bt, gr, 4096, 2048, cfg, signal=beta_true,
                            jacobi_blocks=1)
        check((sr.jacobi, sr.B) == (1, 256), "serial recovery plan")
        t0 = time.perf_counter()
        _, out = sr.run(gr, bt.ChainConfig(*rchain))
        corr = posterior_corr(torch, out, beta_true)
        log(f"[12] {kind} serial recovery corr {corr:.4f} over "
            f"{rchain} ({(time.perf_counter() - t0) / rchain[0] * 1e3:.2f} "
            f"ms/iter)")
        check(corr > 0.8, f"[12] {kind} serial recovery corr {corr}")

    # ---- 12. the auto plan below 2048 markers (J=1, no jacobi_blocks):
    # one chain and 8 fused chains through the serial kernels
    for kind, (single, _, fused, _, cfg, _, _, _) in kinds.items():
        gs = torch.Generator(device=dev).manual_seed(40)
        s = packed_sampler(torch, bt, gs, 4096, 1500, cfg())
        check((s.jacobi, s.jacobi_layout) == (1, "row"),
              f"[12] M=1500 auto plan {(s.jacobi, s.B, s.jacobi_layout)}")
        chain = bt.ChainConfig(10, 5, 5)
        for chains, counter in ((None, single), (CHAINS, fused)):
            path = os.path.join(tmp, f"{kind}_m1500.csv")
            if chains is None:
                sink = CSVSink(path, kind, M=s.M, N=s.N, emit_epsilon=False)
                run = lambda sk: s.run(gs, chain, sink=sk)  # noqa: E731
            else:
                sink = ChainFanoutSink.csv(path, chains, kind, M=s.M, N=s.N,
                                           emit_epsilon=False)
                run = lambda sk: s.run_chains(  # noqa: E731
                    gs, chains, chain, sink=sk)
            st, out, wall, launches, _ = main_path(torch, run, sink, counter)
            want = 3 * s.nb * chain.max_iterations
            check(all(np_finite(x) for x in out.values()),
                  f"[12] {kind} M=1500 non-finite output")
            check(launches == want,
                  f"[12] {kind} M=1500 launches {launches} != {want}")
            log(f"[12] {kind} M=1500 auto plan (J={s.jacobi}, B={s.B}, "
                f"nb={s.nb}), {chains or 1} chain(s): "
                f"{wall / chain.max_iterations * 1e3:.2f} ms/iter, launches "
                f"{launches} (want {want})")
        del s, st, out

    replaces = {"bayesr": "bayesrrcpp_tpu/ops/pallas_sweep.py:97",
                "horseshoe": "bayesrrcpp_tpu/ops/pallas_sweep.py:622",
                "bayesr_mc": "bayesrrcpp_tpu/ops/pallas_multichain.py:115",
                "horseshoe_mc": "bayesrrcpp_tpu/ops/pallas_multichain.py:516"}
    return [dict({"name": f"{key}_serial_sweep", "route": "cuda",
                  "source": "bayesrrcpp_tpu_torch/csrc/serial.cu",
                  "replaces": replaces[key]}, **records[key])
            for key in ("bayesr", "horseshoe", "bayesr_mc", "horseshoe_mc")]


def strided_rounds(torch, s, args, kw):
    """The rounds of a strided sweep (operands ``args``): (the round of
    each marker (Mpad,), the round count, and ``blocks(r)``: round r's
    (block, sweep position of its first variate) for j < J)."""
    rho = args[6].long()
    nr, B, J = rho.numel(), s.B, kw["J"]
    round_of_slab = torch.empty_like(rho)
    round_of_slab[rho] = torch.arange(nr, device=rho.device)
    marker = torch.arange(s.Mpad, device=rho.device)

    def blocks(r):
        slab = int(rho[r])
        return [(j * nr + slab, (slab * J + j) * B) for j in range(J)]

    return round_of_slab[marker // B % nr], nr, blocks


def row_rounds(torch, s, args, kw):
    """``strided_rounds`` of a row-layout sweep: round r holds the blocks
    at sweep positions r*J .. of ``args[6]`` (a prefix of whole rounds may
    leave markers unvisited: their round is past the last)."""
    border = args[6].long()
    n, B, J = border.numel(), s.B, kw["J"]
    pos = torch.full((s.nb,), n, dtype=torch.long, device=border.device)
    pos[border] = torch.arange(n, device=border.device)
    marker = torch.arange(s.Mpad, device=border.device)

    def blocks(r):
        return [(int(border[r * J + j]), (r * J + j) * B) for j in range(J)]

    return pos[marker // B] // J, n // J, blocks


def check_against_plain(torch, tag, names, ker, ref):
    """labels and v equal, the floats to rtol 1e-4 / atol 1e-5; returns the
    largest |d| of the floats."""
    worst = 0.0
    for name, a, b in zip(names, ker, ref):
        if name in ("labels", "v"):
            check(torch.equal(a, b), f"{tag} {name} differ from plain")
            continue
        d = float((a - b).abs().max())
        worst = max(worst, d)
        check(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
              f"{tag} {name} differs from plain: max |d| {d:.3g}")
    return worst


def held_per_chain(torch, s, tag, args, kw, ker, ref, per_chain=None,
                   sweeps=None, rounds=strided_rounds):
    """BayesR at the headline against the plain version, chain by chain
    (``args`` a sweep's operands, fused when ``per_chain`` names the
    per-chain ones): a chain whose labels all equal the plain version's
    holds eps to |d eps| / |eps| < 1e-3.  A chain with a flipped label is
    replayed by ``flip_replay``: after R0 rounds, R0 the first round with a
    flip, its labels must equal the plain version's and its eps be within
    1e-3; each flip ``flip_replay`` recomputes must be a near tie (|u -
    weight| within the reach of f32 rounding); and its eps must hold to its
    own algebra, eps_in - X (beta_out - beta_in), to 1e-5.  ``sweeps``
    (kernel, reference) and ``rounds`` as ``flip_replay``'s.  Returns [(chain,
    flip_replay's result)] of the flipped chains."""
    lead = (lambda x: x[None]) if ker[0].dim() == 1 else (lambda x: x)
    k_eps, k_beta, k_lab = (lead(x) for x in ker[:3])
    r_eps, r_beta, r_lab = (lead(x) for x in ref[:3])
    eps_in, beta_in = lead(args[3]), lead(args[4])
    flipped = []
    for c in range(k_eps.shape[0]):
        if torch.equal(k_lab[c], r_lab[c]):
            rel = rel_err(k_eps[c], r_eps[c])
            check(rel < 1e-3, f"{tag} chain {c} eps rel diff {rel}")
            continue
        one = args if per_chain is None else chain_args(args, c, per_chain)
        rp = flip_replay(torch, s, one, kw, k_lab[c], r_lab[c], r_beta[c],
                         sweeps, rounds)
        flipped.append((c, rp))
        log(f"{tag} chain {c}: first label flip in round {rp['r0']} of "
            f"{rp['rounds']}; after {rp['r0']} rounds labels equal: "
            f"{rp['labels_equal']}, |d eps|/|eps| {rp['rel_eps']:.3g}; the "
            f"round's first flips (marker, |u - cumulative weight|, reach "
            f"of f32 rounding; num, its reach): " + ", ".join(
                f"({t['marker']}, {t['margin']:.3g}, {t['reach']:.3g}; "
                f"{t['num']:.6g}, {t['reach_num']:.3g})" for t in rp["near"]))
        check(rp["labels_equal"] and rp["rel_eps"] < 1e-3,
              f"{tag} chain {c}: state after {rp['r0']} rounds differs")
        for t in rp["near"]:
            check(t["margin"] <= t["reach"],
                  f"{tag} chain {c}: marker {t['marker']} flipped with u "
                  f"{t['margin']:.3g} from a cumulative weight, beyond f32 "
                  f"rounding ({t['reach']:.3g})")
        exact = eps_in[c][:s.N] - s.xbeta(k_beta[c] - beta_in[c])
        rel = rel_err(k_eps[c][:s.N], exact)
        check(rel < 1e-5, f"{tag} chain {c} (a label flip) eps against "
              f"eps_in - X dbeta: {rel}")
    return flipped


def flip_replay(torch, s, args, kw, k_lab, r_lab, r_beta, sweeps=None,
                rounds=strided_rounds):
    """A BayesR sweep (single-chain operands ``args``) whose labels
    ``k_lab`` differ from the plain version's ``r_lab``, replayed.
    ``sweeps`` (kernel, reference): the two sweeps, each called as
    ``fn(*args, **kw)``, by default the strided kernel and its plain
    version; ``rounds`` the plan's rounds (``strided_rounds``,
    ``row_rounds``); the f64 redraw takes the rows of ``s``'s data (decoded
    words, or dense X's own).  R0 is
    the first round in which a label differs: each marker is drawn once a
    sweep, in the round of its block.  Kernel and plain version run again
    with every marker of round R0 or later invalid, so that each returns
    its state after R0 rounds.  Then the first flipped marker of each
    block of round R0 (a later one follows a different draw) is drawn
    again in f64 from the plain version's state after R0 rounds and its
    deltas ``r_beta`` earlier in the block: its margin is |u - the nearest
    cumulative weight|, and its reach how far that weight moves when num
    moves by the f32 rounding of the sums that form it (2^-24 times the sum
    of their terms' magnitudes) plus what the two states' difference gives
    on the marker's row, with 2^-20 for the weights' own rounding.  Returns
    a dict: r0, rounds, labels_equal and rel_eps (the states after R0
    rounds), near (one dict per block: marker, u, k, margin, reach, num,
    reach_num).  ``s`` holds 2-bit words, int8 codes or dense rows."""
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
    from bayesrrcpp_tpu_torch.ops.genotypes import MISSING_CODE, decode_codes

    d = s.data
    dev = d.XT.device
    f64 = torch.float64
    B = s.B
    marker_round, nr, round_blocks = rounds(torch, s, args, kw)
    flipped = k_lab != r_lab
    r0 = int(marker_round[flipped].min())
    pre = list(args)
    pre[15] = args[15] & (marker_round < r0)
    ker, ref = sweeps or (jt.bayesr_jacobi_t, jt.bayesr_jacobi_t_reference)
    kp = ker(*pre, **kw)
    rp = ref(*pre, **kw)

    eps, deps = rp.eps.to(f64), (kp.eps - rp.eps).to(f64)
    lp, invd, _ = jt.bayesr_tables(args[2], args[14], args[10], args[11],
                                   args[12], args[13])
    half = 0.5 / torch.as_tensor(args[12], device=dev).to(f64)
    codes = s.x_packed or s.x_int8       # words or int8 codes, else dense
    lanes_ok = d.row_valid.to(torch.bool) if s.x_packed else None
    near = []
    for blk, at0 in round_blocks(r0):
        rows = blk * B + torch.arange(B, device=dev)
        inn = args[7][blk].tolist()
        hit = flipped[rows].tolist()
        steps = [t for t, lane in enumerate(inn) if hit[lane]]
        if not steps:
            continue
        t = steps[0]
        lane = inn[t]
        m = blk * B + lane
        if codes:
            c = decode_codes(d.XT[rows]).to(f64)
            keep = c != MISSING_CODE
            if lanes_ok is not None:
                c, keep = c * lanes_ok, keep & lanes_ok
            mean = d.x_mean[rows].to(f64)[:, None]
            sc = d.x_scale[rows].to(f64)[:, None]
            x = torch.where(keep, (c - mean) * sc, 0.0)
        else:
            x = d.XT[rows].to(f64)
        rr = x @ eps
        bold = args[4][rows].to(f64)
        dd = r_beta[rows].to(f64) - bold
        gram = args[1][blk].to(f64)
        moved_terms = 0.0
        for mt in inn[:t]:
            rr = rr - gram[mt] * dd[mt]
            moved_terms += abs(float(gram[mt, lane] * dd[mt]))
        xsq = float(args[2][m])
        num = rr[lane] + bold[lane] * xsq
        # the magnitudes the f32 sums add up: the codes' dot, the
        # indicator's (m - 3)-scaled dot, the fold's m * sum(eps); dense
        # rows' own dot
        e = eps.abs()
        if codes:
            mi = float(mean[lane, 0])
            ind = float((e * (c[lane] == MISSING_CODE)).sum())
            sums = float(sc[lane, 0]) * (float((c[lane] * e).sum())
                                         + abs(mi - MISSING_CODE) * ind
                                         + abs(mi) * float(e.sum()))
        else:
            sums = float((x[lane].abs() * e).sum())
        reach_num = (2.0 ** -24 * (sums + moved_terms + abs(float(
            bold[lane]) * xsq)) + abs(float(x[lane] @ deps)))
        u = float(args[8][at0 + t])

        def weights(n):
            return jt.cumulative_weights(lp[m].to(f64), invd[m].to(f64), n,
                                         half)[1]

        acum = weights(num)
        gap = (u - acum).abs()
        k = int(gap.argmin())
        reach = max(abs(float(weights(num + reach_num)[k] - acum[k])),
                    abs(float(weights(num - reach_num)[k] - acum[k])))
        near.append(dict(marker=m, u=u, k=k, weight=float(acum[k]),
                         margin=float(gap[k]), reach=reach + 2.0 ** -20,
                         num=float(num), reach_num=reach_num))
    return dict(r0=r0, rounds=nr, labels_equal=torch.equal(kp.labels,
                                                           rp.labels),
                rel_eps=rel_err(kp.eps, rp.eps), near=near)


def missing_phases(torch, bt, tmp):
    """Phases 13-16 (module docstring): words with ~1.6 % missing calls,
    CSVs under ``tmp``.  Returns the six kernel records of the miss mode
    (kernels A and B) and the in-kernel decode (kernel C)."""
    import numpy as np

    from bayesrrcpp_tpu_torch import cli
    from bayesrrcpp_tpu_torch.io import bed
    from bayesrrcpp_tpu_torch.io.native import get_native_bed
    from bayesrrcpp_tpu_torch.io.sink import ChainFanoutSink, CSVSink
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
    from bayesrrcpp_tpu_torch.ops import serial as ser
    from bayesrrcpp_tpu_torch.ops.jacobi import auto_jacobi_plan

    dev = torch.device("cuda")
    bnames = ("eps", "beta", "labels", "v", "beta_acum")
    strided = {
        "bayesr": (jt.bayesr_jacobi_t, jt.bayesr_jacobi_t_reference,
                   jt.bayesr_jacobi_t_mc, jt.bayesr_jacobi_t_mc_reference,
                   bt.BayesRConfig, sweep_args, BAYESR_CHAIN_ARGS, bnames, 6,
                   6),
        "horseshoe": (jt.horseshoe_jacobi_t, jt.horseshoe_jacobi_t_reference,
                      jt.horseshoe_jacobi_t_mc,
                      jt.horseshoe_jacobi_t_mc_reference, bt.HorseshoeConfig,
                      hs_sweep_args, HS_CHAIN_ARGS, ("eps", "beta"), 4, 5)}
    records = {}

    # ---- 13a. kernels A and B against their plain versions, N=4096 x
    # M=8192, one chain and C=8 fused from warm states
    for kind, (single, plain, fused, fused_plain, cfg, make_args, per_chain,
               names, _, _) in strided.items():
        g = torch.Generator(device=dev).manual_seed(50)
        v = bt.TorchVariates(g)
        s = packed_sampler(torch, bt, g, 4096, 8192, cfg(), missing=True)
        check(s.data.has_missing and (s.jacobi, s.B) == (32, 32),
              f"[13a] plan {(s.jacobi, s.B)}, missing {s.data.has_missing}")
        st = s._run_steps(s.init(v), v, 3)
        args, kw = make_args(s, st, v)
        check(kw["missing"] and not kw["fold_affine"], f"[13a] mode {kw}")
        err = check_against_plain(torch, f"[13a] {kind}", names,
                                  tuple(single(*args, **kw)),
                                  tuple(plain(*args, **kw)))
        v8 = bt.TorchVariates(g, chains=CHAINS)
        st8 = s.init(v8, chains=CHAINS)
        for _ in range(3):
            st8 = s.step_chains(st8, v8)
        args, kw = make_args(s, st8, v8)
        ker = tuple(fused(*args, **kw))
        ferr = check_against_plain(torch, f"[13a] {kind} fused", names, ker,
                                   tuple(fused_plain(*args, **kw)))
        for c in range(CHAINS):
            one = tuple(single(*chain_args(args, c, per_chain), **kw))
            for name, a, b in zip(names, one, ker):
                check(torch.equal(a, b[c]),
                      f"[13a] {kind} chain {c} {name} differs from the "
                      f"single-chain miss kernel")
        frac = float(missing_calls(torch, s).sum()) / (s.M * s.N)
        log(f"[13a] {kind} miss mode N=4096 M=8192 ({frac:.4f} missing): "
            f"kernel vs plain max |d| {err:.3g}; fused C={CHAINS} vs plain "
            f"max |d| {ferr:.3g}; every chain bitwise equal to the "
            f"single-chain kernel")
        del s, st, st8, args, ker

    # ---- 13b. the headline
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(51)
    s = packed_sampler(torch, bt, g, HEADLINE_N, HEADLINE_M,
                       bt.BayesRConfig(emit_epsilon=False), missing=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check((s.jacobi, s.B, s.jacobi_layout, s.Mpad) ==
          (128, 32, "t", HEADLINE_M) and s.data.has_missing,
          "[13b] headline plan")
    t0 = time.perf_counter()
    hs = bt.HorseshoeSampler(
        s.data.XT, s.Y[:s.N], bt.HorseshoeConfig(emit_epsilon=False),
        transposed=True, x_dtype="2bit",
        x_stats=bt.simulate.packed_word_stats(HEADLINE_M), device="cuda")
    torch.cuda.synchronize()
    hs_setup_s = time.perf_counter() - t0
    check(hs.data.XT.data_ptr() == s.data.XT.data_ptr(), "words copied")
    nr = s.nb // s.jacobi
    miss = missing_calls(torch, s)
    log(f"[13b] headline words with missing calls: setup {setup_s:.2f} s "
        f"(BayesR), {hs_setup_s:.2f} s (horseshoe on the same words); "
        f"{int(miss.sum())} missing calls, a share of "
        f"{float(miss.sum()) / (s.M * s.N):.6f}")
    samplers = {"bayesr": s, "horseshoe": hs}
    for kind, (single, plain, fused, fused_plain, _, make_args, per_chain,
               names, arrays, rho_at) in strided.items():
        ss = samplers[kind]
        v = bt.TorchVariates(g)
        st = ss._run_steps(ss.init(v), v, 2)
        args, kw = make_args(ss, st, v)
        ker, ms = timed(torch, lambda: tuple(single(*args, **kw)), 3)
        moved_at = ker[1] != args[4]
        # BayesR's plain version over the first rounds (#5, the whole-sweep
        # kernel with a round count: 23a holds the two bitwise)
        pa, pkw, pfns = headline_plain_rounds(jt, args, kw, nr, kind, None,
                                          (single, plain))
        pk = tuple(pfns[0](*pa, **pkw))
        ref, plain_ms = timed(torch, lambda: tuple(pfns[1](*pa, **pkw)), 1)
        rel_eps, rel_beta = rel_err(pk[0], ref[0]), rel_err(pk[1], ref[1])
        max_err = max(float((a - b).abs().max())
                      for a, b in zip(pk[:2], ref[:2]))
        agree = (float((pk[2] == ref[2]).float().mean())
                 if kind == "bayesr" else 1.0)
        moved = int(moved_at.sum())
        bound = sweep_bound(ss, 1, moved, arrays,
                            extra_fmas=missing_fmas(miss, moved_at))
        lib_ms = dot_yardstick(torch, ss, round_rows(torch, ss,
                                                     args[rho_at][0]),
                               args[3]) * nr
        flips = (held_per_chain(torch, ss, "[13b]", pa, pkw, pk, ref, None,
                                pfns, chunk_rounds)
                 if kind == "bayesr" else [])
        log(f"[13b] {kind} miss sweep at the headline: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms ({len(pa[6])} rounds), bound "
            f"{bound[0]:.3f} ms ({bound[1]}, "
            f"{moved} markers moved), dot yardstick {lib_ms:.3f} ms; label "
            f"agreement {agree:.6f}, |d eps|/|eps| {rel_eps:.3g}, |d beta|/"
            f"|beta| {rel_beta:.3g}, max abs err {max_err:.3g}; chains with "
            f"a near-tie label flip {[c for c, _ in flips]}")
        check(agree >= 0.999, f"[13b] {kind} label agreement {agree}")
        if kind == "bayesr":
            whole_in_chunks(torch, "[13b] bayesr", pfns, args, pkw, ker)
        if kind != "bayesr":
            check(rel_eps < 1e-4 and rel_beta < 1e-4,
                  f"[13b] horseshoe rel diffs {rel_eps} {rel_beta}")
        records[kind] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                             plain_rounds=len(pa[6]), bound_ms=bound[0],
                             bound_by=bound[1], library_ms=lib_ms)
        del args, ker, ref, pa, pk

        v8 = bt.TorchVariates(g, chains=CHAINS)
        st8 = ss.init(v8, chains=CHAINS)
        for _ in range(2):
            st8 = ss.step_chains(st8, v8)
        args, kw = make_args(ss, st8, v8)
        ker, fms = timed(torch, lambda: tuple(fused(*args, **kw)), 3)
        ones, singles_ms = timed(torch, lambda: [
            tuple(single(*chain_args(args, c, per_chain), **kw))
            for c in range(CHAINS)], 1)
        bitwise = all(torch.equal(a, b[c]) for c, one in enumerate(ones)
                      for a, b in zip(one, ker))
        pa, pkw, pfns = headline_plain_rounds(jt, args, kw, nr, kind, CHAINS,
                                          (fused, fused_plain))
        pk = tuple(pfns[0](*pa, **pkw))
        ref, fplain_ms = timed(torch, lambda: tuple(pfns[1](*pa, **pkw)), 1)
        frel = rel_err(pk[0], ref[0])
        frel_beta = rel_err(pk[1], ref[1])
        ferr = max(float((a - b).abs().max())
                   for a, b in zip(pk[:2], ref[:2]))
        fagree = (float((pk[2] == ref[2]).float().mean())
                  if kind == "bayesr" else 1.0)
        fmoved_at = ker[1] != args[4]
        fmoved = int(fmoved_at.sum())
        fbound = sweep_bound(ss, CHAINS, fmoved, arrays,
                             extra_fmas=missing_fmas(miss, fmoved_at))
        flib_ms = dot_yardstick(torch, ss, round_rows(torch, ss,
                                                      args[rho_at][0]),
                                args[3]) * nr
        apply_report(torch, f"[13b] {kind} fused C={CHAINS} miss", ss,
                     lambda *a, **k: tuple(fused(*a, **k)), args, kw,
                     fmoved_at.any(dim=0), miss)
        fflips = (held_per_chain(
            torch, ss, "[13b] fused", pa, pkw, pk, ref, per_chain,
            headline_plain_rounds(jt, args, kw, nr, kind, None,
                              (single, plain))[2], chunk_rounds)
                  if kind == "bayesr" else [])
        log(f"[13b] {kind} fused C={CHAINS} miss sweep at the headline: "
            f"{fms:.3f} ms, {CHAINS} single-chain sweeps {singles_ms:.3f} "
            f"ms, plain {fplain_ms:.1f} ms ({len(pa[6])} rounds), bound "
            f"{fbound[0]:.3f} ms "
            f"({fbound[1]}), dot yardstick {flib_ms:.3f} ms; chains bitwise "
            f"equal to the single-chain kernel: {bitwise}; label agreement "
            f"{fagree:.6f}, |d eps|/|eps| {frel:.3g}, |d beta|/|beta| "
            f"{frel_beta:.3g}, max abs err {ferr:.3g}; chains with a "
            f"near-tie label flip {[c for c, _ in fflips]}")
        check(bitwise, f"[13b] {kind} fused chains not bitwise")
        check(fagree >= 0.999, f"[13b] {kind} fused label agreement")
        if kind == "bayesr":
            whole_in_chunks(torch, "[13b] bayesr fused", pfns, args, pkw,
                            ker)
        if kind != "bayesr":
            check(frel < 1e-4, f"[13b] {kind} fused eps rel diff {frel}")
        records[kind + "_mc"] = dict(
            max_abs_err=ferr, ms=fms, plain_ms=fplain_ms,
            plain_rounds=len(pa[6]), bound_ms=fbound[0], bound_by=fbound[1],
            library_ms=flib_ms)
        del args, ker, ref, ones, st8, pa, pk

    # ---- 14. the main path of biobank-packed-missing, the horseshoe and
    # 8 fused chains of each, on the same words
    chain = bt.ChainConfig(30, 10, 10)
    for kind, (single, _, fused, _, _, _, _, _, _, _) in strided.items():
        ss = samplers[kind]
        g = torch.Generator(device=dev).manual_seed(52)
        path = os.path.join(tmp, f"{kind}_missing.csv")
        st, out, wall, launches, peak = main_path(
            torch, lambda sk: ss.run(g, chain, sink=sk),
            CSVSink(path, kind, M=ss.M, N=ss.N, emit_epsilon=False), single)
        header, widths, bad = read_csv(path)
        check(len(header) == 2 + 2 * ss.M + 2 and widths == [len(header)] * 2
              and not bad, f"[14] {path}: {len(header)} {widths} {bad}")
        check(all(np_finite(x) for x in out.values()), f"[14] {kind} output")
        rel = rel_err(st.eps, ss.refresh_eps(st).eps)
        want = jt.LAUNCHES_PER_ROUND * nr * chain.max_iterations
        cell = ("biobank-packed-missing" if kind == "bayesr"
                else "biobank-horseshoe-missing")
        log(f"[14] {cell} main path: "
            f"{wall / chain.max_iterations * 1e3:.2f} ms/iter ({wall:.2f} s "
            f"for {chain.max_iterations} iterations incl. CSV), peak "
            f"{peak:.2f} GiB, launches {launches} (want {want}), "
            f"tracked-vs-exact eps {rel:.3g}, sigmaE {float(st.sigmaE):.5f}")
        check(rel < 1e-4, f"[14] {cell} tracked eps vs recompute {rel}")
        check(launches == want, f"[14] {cell} launches {launches}")
        records[kind]["launches"] = launches
        names = ("dot_kernel", "hs_solve_kernel" if kind == "horseshoe"
                 else "solve_kernel", "apply_kernel")
        window = Steps(ss, st, bt.TorchVariates(g))
        split, dev_ms, wall_ms = profile_split(torch, window, names,
                                               want=2 * nr)
        check(profiled(split, 2 * nr), f"[14] profiled launches {split}")
        log(f"[14] {cell} profile of 2 steps: " + ", ".join(
            f"{n} {us:.2f} us x {c}" for n, (us, c) in split.items())
            + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall")
        # the dots' indicator pass adds one FMA per missing call and chain
        per_row = float(miss.sum()) / ss.M
        packed_report(torch, f"[14] {cell}", split, names, ss, 1, window,
                      per_row)
        del st, out

        sink = ChainFanoutSink.csv(
            os.path.join(tmp, f"{kind}_missing_8chain.csv"), CHAINS, kind,
            M=ss.M, N=ss.N, emit_epsilon=False)
        check(ss.supports_fused_chains, f"[14] {kind} fused at J={ss.jacobi}")
        st, out, wall, launches, peak = main_path(
            torch, lambda sk: ss.run_chains(g, CHAINS, chain, sink=sk), sink,
            fused)
        for path in sink.paths:
            header, widths, bad = read_csv(path)
            check(widths == [len(header)] * 2 and not bad,
                  f"[14] {path} rows {widths}")
        ex = ss.refresh_eps(st).eps
        rel = float((torch.linalg.norm(st.eps - ex, dim=1)
                     / torch.linalg.norm(ex, dim=1)).max())
        log(f"[14] {cell}-8chain main path: "
            f"{wall / chain.max_iterations * 1e3:.2f} ms/iter, peak "
            f"{peak:.2f} GiB, launches {launches} (want {want}), "
            f"tracked-vs-exact eps max {rel:.3g}")
        check(rel < 1e-4, f"[14] {cell}-8chain tracked eps {rel}")
        check(launches == want, f"[14] {cell}-8chain launches {launches}")
        records[kind + "_mc"]["launches"] = launches
        two_steps = Steps(ss, st, bt.TorchVariates(g, chains=CHAINS))
        names = ("dot_mc_kernel", "hs_solve_mc_kernel" if kind == "horseshoe"
                 else "solve_mc_kernel", "apply_mc_kernel")
        split, dev_ms, wall_ms = profile_split(torch, two_steps, names,
                                               want=2 * nr)
        check(profiled(split, 2 * nr), f"[14] profiled launches {split}")
        log(f"[14] {cell}-8chain profile of 2 fused steps: " + ", ".join(
            f"{n} {us:.2f} us x {c}" for n, (us, c) in split.items())
            + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall")
        packed_report(torch, f"[14] {cell}-8chain", split, names, ss, CHAINS,
                      two_steps, per_row)
        del st, out, two_steps

    # ---- 15. kernel C: the serial in-kernel decode
    serial = {"bayesr": (ser.bayesr_sweep, ser.bayesr_sweep_reference,
                         bt.BayesRConfig, serial_args, bnames, 6),
              "horseshoe": (ser.horseshoe_sweep,
                            ser.horseshoe_sweep_reference, bt.HorseshoeConfig,
                            hs_serial_args, ("eps", "beta"), 4)}
    for kind, (single, plain, cfg, make_args, names, _) in serial.items():
        # the first 1,024 steps of the order, as phase 10a
        for B, n in ((512, 2), (64, 16)):
            g = torch.Generator(device=dev).manual_seed(60 + B)
            v = bt.TorchVariates(g)
            sb = packed_sampler(torch, bt, g, 4096, 8192, cfg(block_size=B),
                                missing=True, jacobi_blocks=1)
            check((sb.jacobi, sb.B) == (1, B) and sb.data.has_missing
                  and not sb.supports_fused_chains, "[15a] serial plan")
            st = sb._run_steps(sb.init(v), v, 3)
            args, kw = make_args(sb, st, v, n)
            check(not kw["fold_affine"], f"[15a] mode {kw}")
            err = check_sweeps(torch, f"[15a] {kind} B={B}", names,
                               tuple(single(*args, **kw)),
                               tuple(plain(*args, **kw)))
            log(f"[15a] {kind} in-kernel decode N=4096 M=8192 B={B} ({n} of "
                f"{sb.nb} blocks): kernel vs plain labels/v equal, max |d| "
                f"{err:.3g}")
            del sb, st, args

    common = dict(transposed=True, x_dtype="2bit", device="cuda",
                  x_stats=bt.simulate.packed_word_stats(HEADLINE_M),
                  jacobi_blocks=1)
    for kind, (single, plain, cfg, make_args, names, arrays) in \
            serial.items():
        t0 = time.perf_counter()
        if kind == "bayesr":
            sj = bt.SpikeSlabSampler(s.data.XT, s.Y[:s.N], CVA,
                                     cfg(emit_epsilon=False), **common)
        else:
            sj = bt.HorseshoeSampler(s.data.XT, s.Y[:s.N],
                                     cfg(emit_epsilon=False), **common)
        torch.cuda.synchronize()
        sj_setup = time.perf_counter() - t0
        check((sj.jacobi, sj.B, sj.nb) == (1, 512, 984)
              and sj.data.has_missing, "[15b] serial headline plan")
        g = torch.Generator(device=dev).manual_seed(61)
        v = bt.TorchVariates(g)
        st = sj._run_steps(sj.init(v), v, 2)
        args, kw = make_args(sj, st, v, HEADLINE_PLAIN_BLOCKS)
        ker = tuple(single(*args, **kw))
        ref, plain_ms = timed(torch, lambda: tuple(plain(*args, **kw)), 1)
        rel_eps = rel_err(ker[0], ref[0])
        max_err = max(float((a - b).abs().max())
                      for a, b in zip(ker[:2], ref[:2]))
        agree = (float((ker[2] == ref[2]).float().mean())
                 if kind == "bayesr" else 1.0)
        args, kw = make_args(sj, st, v)
        full, ms = timed(torch, lambda: tuple(single(*args, **kw)), 3)
        moved = int((full[1] != args[4]).sum())
        bound = sweep_bound(sj, 1, moved, arrays, moved)
        border = args[5 if kind == "horseshoe" else 6]
        blk_rows = border[0] * sj.B + torch.arange(sj.B, device=dev)
        lib_ms = dot_yardstick(torch, sj, blk_rows, args[3]) * sj.nb
        log(f"[15b] {kind} in-kernel decode at the headline (sampler "
            f"{sj_setup:.2f} s): {HEADLINE_PLAIN_BLOCKS} blocks vs plain: "
            f"label agreement "
            f"{agree:.6f}, |d eps|/|eps| {rel_eps:.3g}, max abs err "
            f"{max_err:.3g}, plain {plain_ms:.1f} ms; full sweep {ms:.3f} "
            f"ms, bound {bound[0]:.3f} ms ({bound[1]}, {moved} moved), dot "
            f"yardstick {lib_ms:.3f} ms")
        check(agree >= 0.999, f"[15b] {kind} label agreement {agree}")
        check(rel_eps < (1e-3 if kind == "bayesr" else 1e-4),
              f"[15b] {kind} eps rel diff {rel_eps}")
        records[kind + "_q"] = dict(
            max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
            plain_blocks=HEADLINE_PLAIN_BLOCKS,
            sweep_blocks=int(sj.nb), dependent_steps=int(sj.nb * sj.B),
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)
        del sj, st, args, full, ker, ref
    del samplers, s, hs

    # the auto plan below 2048 markers with missing calls: J=1, one chain,
    # and 8 chains each through the single-chain kernel
    for kind, (single, _, cfg, _, _, _) in serial.items():
        gs = torch.Generator(device=dev).manual_seed(62)
        sm = packed_sampler(torch, bt, gs, 4096, 1500, cfg(), missing=True)
        check(sm.jacobi == 1 and sm.data.has_missing
              and not sm.supports_fused_chains, "[15c] M=1500 plan")
        chain = bt.ChainConfig(10, 5, 5)
        want = 3 * sm.nb * chain.max_iterations
        path = os.path.join(tmp, f"{kind}_m1500_missing.csv")
        st, out, wall, launches, _ = main_path(
            torch, lambda sk: sm.run(gs, chain, sink=sk),
            CSVSink(path, kind, M=sm.M, N=sm.N, emit_epsilon=False), single)
        check(all(np_finite(x) for x in out.values()), f"[15c] {kind} output")
        check(launches == want, f"[15c] {kind} launches {launches} != {want}")
        records[kind + "_q"]["launches"] = launches
        sink = ChainFanoutSink.csv(path, CHAINS, kind, M=sm.M, N=sm.N,
                                   emit_epsilon=False)
        _, out8, wall8, launches8, _ = main_path(
            torch, lambda sk: sm.run_chains(gs, CHAINS, chain, sink=sk), sink,
            single)
        check(all(np_finite(x) for x in out8.values()),
              f"[15c] {kind} 8-chain output")
        check(launches8 == CHAINS * want,
              f"[15c] {kind} 8 chains launches {launches8}")
        try:
            sm.run_chains(gs, CHAINS, chain, fused=True)
            refused = False
        except ValueError:
            refused = True
        check(refused, f"[15c] {kind} fused=True ran on missing data at J=1")
        log(f"[15c] {kind} M=1500 auto plan with missing calls (J=1, "
            f"B={sm.B}, nb={sm.nb}): one chain "
            f"{wall / chain.max_iterations * 1e3:.2f} ms/iter, launches "
            f"{launches} (want {want}); 8 chains unfused "
            f"{wall8 / chain.max_iterations * 1e3:.2f} ms/iter, launches "
            f"{launches8}; fused=True refused")
        del sm, st, out, out8

    # ---- 16. the CLI on a .bed with missing calls (2,048 markers: making
    # and writing the .bed takes the host 5-6.5 s a 1,024)
    N16, M16 = HEADLINE_N, 2048
    rng = np.random.default_rng(16)
    t0 = time.perf_counter()
    dos = rng.integers(0, 3, size=(N16, M16), dtype=np.int8).astype(
        np.float32)
    dos[rng.random((N16, M16), dtype=np.float32) < 1 / 64] = np.nan
    gen_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=tmp) as d16:
        prefix = os.path.join(d16, "cohort")
        t0 = time.perf_counter()
        bed.write_bed(prefix, dos)
        write_s = time.perf_counter() - t0
        del dos
        pheno = os.path.join(d16, "y.txt")
        np.savetxt(pheno, rng.standard_normal(N16))
        t0 = time.perf_counter()
        pb = bed.read_bed_packed(prefix, mpad="auto")
        read_s = time.perf_counter() - t0
        check(pb.has_missing and pb.n == N16
              and pb.words.shape == (M16, N16 // 16), "[16] packed .bed")
        del pb
        log(f"[16] .bed of N={N16} x M={M16}: "
            f"{os.path.getsize(prefix + '.bed') / 1e6:.1f} MB, dosages "
            f"{gen_s:.1f} s, write_bed {write_s:.1f} s, read_bed_packed "
            f"{read_s:.2f} s (native decoder: "
            f"{'loaded' if get_native_bed() is not None else 'absent'})")
        J16, B16, _ = auto_jacobi_plan(M16, bt.BayesRConfig().block_size)
        nr16 = M16 // B16 // J16
        for kind, counter in (("bayesr", jt.bayesr_jacobi_t),
                              ("horseshoe", jt.horseshoe_jacobi_t)):
            out = os.path.join(d16, f"{kind}.csv")
            torch.cuda.synchronize()
            counter.launches = 0
            t0 = time.perf_counter()
            rc = cli.main([kind, "--bed", prefix, "--pheno", pheno,
                           "--x-dtype", "2bit", "--out", out,
                           "--iterations", "10", "--burn-in", "2",
                           "--thinning", "4", "--seed", "3"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            header, widths, bad = read_csv(out)
            want = 3 * nr16 * 10
            log(f"[16] python -m bayesrrcpp_tpu_torch {kind} --bed ... "
                f"--x-dtype 2bit: rc {rc}, {wall:.2f} s, CSV {len(widths)} "
                f"rows of {len(header)} columns, launches "
                f"{counter.launches} (want {want})")
            n_rows = len(list(bt.ChainConfig(10, 2, 4).emit_iterations()))
            check(rc == 0 and len(header) == 2 + 2 * M16 + 2 + N16
                  and widths == [len(header)] * n_rows and n_rows == 2
                  and not bad,
                  f"[16] {kind} CSV {len(header)} {widths} {bad}")
            check(counter.launches == want,
                  f"[16] {kind} launches {counter.launches}")

    src = "bayesrrcpp_tpu_torch/csrc/"
    tpu = "bayesrrcpp_tpu/ops/"
    meta = {
        "bayesr": ("jacobi_t_sweep_miss", "jacobi_t.cu",
                   "pallas_jacobi_t.py:405"),
        "horseshoe": ("jacobi_t_hs_sweep_miss", "jacobi_t.cu",
                      "pallas_jacobi_t.py:650"),
        "bayesr_mc": ("jacobi_t_mc_sweep_miss", "jacobi_t_mc.cu",
                      "pallas_jacobi_t.py:1199/:2416"),
        "horseshoe_mc": ("jacobi_t_hs_mc_sweep_miss", "jacobi_t_mc.cu",
                         "pallas_jacobi_t.py:1742/:2922"),
        "bayesr_q": ("bayesr_serial_sweep_q", "serial.cu",
                     "pallas_sweep.py:304"),
        "horseshoe_q": ("horseshoe_serial_sweep_q", "serial.cu",
                        "pallas_sweep.py:732")}
    return [dict({"name": name, "route": "cuda", "source": src + f,
                  "replaces": tpu + where}, **records[key])
            for key, (name, f, where) in meta.items()]


DENSE_N, DENSE_M = 16_384, 49_152     # the dense cell, dense-16kx49k
SERIAL_PLAIN_BLOCKS = 2   # blocks of a serial plain sweep at the dense cell


def dense_x(torch, g, N, M):
    """Dense X (M, N) f32 built on the card from generator ``g`` (markers x
    individuals): per marker a frequency p ~ U(0.1, 0.9) and dosages
    Binomial(2, p), each row standardized to mean 0 and sd 1 (ddof 1),
    built in chunks of rows."""
    X = torch.empty((M, N), device="cuda")
    for a in range(0, M, 4096):
        b = min(a + 4096, M)
        p = 0.1 + 0.8 * torch.rand((b - a, 1), generator=g, device="cuda")
        x = ((torch.rand((b - a, N), generator=g, device="cuda") < p).float()
             + (torch.rand((b - a, N), generator=g, device="cuda") < p))
        x -= x.mean(dim=1, keepdim=True)
        x /= x.std(dim=1, keepdim=True).clamp_min(1e-12)
        X[a:b] = x
    return X


def dense_sampler(torch, bt, g, N, M, cfg, signal=None, **plan):
    """A sampler on dense X (M, N) f32 built on the card from generator
    ``g`` (``dense_x``, ``transposed=True``); Y is N(0, 1), times 0.7 plus
    X^T ``signal`` when given.  Dense X takes
    the kernels on the card by default."""
    X = dense_x(torch, g, N, M)
    Y = torch.randn(N, generator=g, device="cuda")
    if signal is not None:
        Y = 0.7 * Y + signal @ X
    kw = dict(transposed=True, device="cuda", **plan)
    if isinstance(cfg, bt.HorseshoeConfig):
        return bt.HorseshoeSampler(X, Y, cfg, **kw)
    return bt.SpikeSlabSampler(X, Y, CVA, cfg, **kw)


def dense_bound(s, chains, moved, marker_arrays, moved_rows, gram_rows=None):
    """(bound_ms, bound_by) of one dense sweep of ``chains`` chains on
    sampler ``s``'s data, by ``tools/kernel_bounds.dense_sweep``: ``moved``
    rows applied (summed over chains), ``moved_rows`` rows moved in any
    chain (read again by the apply), the Gram blocks or ``gram_rows`` rows
    of them (the serial sweep's moved markers)."""
    from bayesrrcpp_tpu_torch.tools import kernel_bounds

    gram = s.data.gram.numel() if gram_rows is None else gram_rows * s.B
    b = kernel_bounds.dense_sweep(s.N, s.Mpad, gram, chains, marker_arrays,
                                  moved, moved_rows)
    return b["bound_ms"], b["bound_by"]


def dense_yardstick(torch, s, slab, eps, strided=True):
    """ms of one ``torch.matmul`` of the dense rows of one dot launch by
    ``eps`` ((N,) or (C, N)): a strided round's (J, B, N) strided view of
    X (slab ``slab``, no copy) or a serial block's (B, N) rows, a batched
    GEMV on cuBLAS.  The PyTorch yardstick of the dense dot; never called
    by the port."""
    d = s.data
    if strided:
        x = d.XT.view(s.jacobi, s.nb // s.jacobi, s.B, s.N)[:, slab]
    else:
        x = d.XT.view(s.nb, s.B, s.N)[slab]
    rhs = eps.T if eps.dim() == 2 else eps
    return timed(torch, lambda: torch.matmul(x, rhs), 5)[1]


def dense_gates(torch, s, tag, args, kw, ker, ref, hsk, per_chain=None,
                sweeps=None, rounds=strided_rounds):
    """The kernel-vs-plain gates of a dense sweep at the cell: labels
    agreeing on >= 99.9 %; the horseshoe's eps and beta to 1e-4 of their
    norms; BayesR chain by chain by ``held_per_chain`` (eps to 1e-3 where
    no label flipped, a flip replayed and judged a near tie).  Returns
    (label agreement, the flipped chains)."""
    agree = (1.0 if hsk else float((ker[2] == ref[2]).float().mean()))
    check(agree >= 0.999, f"{tag} label agreement {agree}")
    if hsk:
        rel_eps, rel_beta = rel_err(ker[0], ref[0]), rel_err(ker[1], ref[1])
        check(rel_eps < 1e-4 and rel_beta < 1e-4,
              f"{tag} rel diffs eps {rel_eps}, beta {rel_beta}")
        return agree, []
    flips = held_per_chain(torch, s, tag, args, kw, ker, ref, per_chain,
                           sweeps, rounds)
    return agree, [c for c, _ in flips]


def serial_gates(torch, tag, ker, ref, hsk):
    """A serial sweep of a few blocks at the dense cell against its plain
    version, as phase 10b holds the headline's: labels agreeing on >= 99.9
    %, |d eps| / |eps| < 1e-3 (BayesR: a near-tie flip changes the later
    steps of its block) or 1e-4 (the horseshoe).  Returns (max |d| of eps
    and beta, the agreement, |d eps| / |eps|)."""
    agree = 1.0 if hsk else float((ker[2] == ref[2]).float().mean())
    rel = rel_err(ker[0], ref[0])
    check(agree >= 0.999, f"{tag} label agreement {agree}")
    check(rel < (1e-4 if hsk else 1e-3), f"{tag} eps rel diff {rel}")
    return (max(float((a - b).abs().max()) for a, b in zip(ker[:2], ref[:2])),
            agree, rel)


def dense_phases(torch, bt, hs, tmp):
    """Phases 17-20 (module docstring): the dense mode of every kernel
    against its plain version, against the fold kernel on phase 2's
    dosages (the words of ``hs``), the dense cell's main paths and the CLI
    on a dense .npy, CSVs under ``tmp``.  Returns the eight dense kernel
    records."""
    import numpy as np

    from bayesrrcpp_tpu_torch import cli
    from bayesrrcpp_tpu_torch.io.sink import ChainFanoutSink, CSVSink
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
    from bayesrrcpp_tpu_torch.ops import multichain as mcs
    from bayesrrcpp_tpu_torch.ops import serial as ser
    from bayesrrcpp_tpu_torch.ops.genotypes import decode_rows
    from bayesrrcpp_tpu_torch.tools import kernel_bounds

    dev = torch.device("cuda")
    bnames = ("eps", "beta", "labels", "v", "beta_acum")
    hnames = ("eps", "beta")
    # kind -> (single, plain, fused, fused plain, config, operands, chain
    # operands, outputs, marker arrays, the order's position in the args)
    strided = {
        "bayesr": (jt.bayesr_jacobi_t, jt.bayesr_jacobi_t_reference,
                   jt.bayesr_jacobi_t_mc, jt.bayesr_jacobi_t_mc_reference,
                   bt.BayesRConfig, sweep_args, BAYESR_CHAIN_ARGS, bnames, 6,
                   6),
        "horseshoe": (jt.horseshoe_jacobi_t, jt.horseshoe_jacobi_t_reference,
                      jt.horseshoe_jacobi_t_mc,
                      jt.horseshoe_jacobi_t_mc_reference, bt.HorseshoeConfig,
                      hs_sweep_args, HS_CHAIN_ARGS, hnames, 4, 5)}
    serial = {
        "bayesr": (ser.bayesr_sweep, ser.bayesr_sweep_reference,
                   mcs.bayesr_sweep_mc, mcs.bayesr_sweep_mc_reference,
                   bt.BayesRConfig, serial_args, BAYESR_CHAIN_ARGS, bnames, 6,
                   6),
        "horseshoe": (ser.horseshoe_sweep, ser.horseshoe_sweep_reference,
                      mcs.horseshoe_sweep_mc,
                      mcs.horseshoe_sweep_mc_reference, bt.HorseshoeConfig,
                      hs_serial_args, HS_CHAIN_ARGS, hnames, 4, 5)}
    records = {}

    # ---- 17a. every dense kernel against its plain version at N=4001 (no
    # multiple of 4 or 32) x M=8192: strided J=128, B=32 and serial B=512,
    # one chain and C=8 fused from warm states
    for layout, kinds, plan in (
            ("strided", strided, dict(jacobi_blocks=128, jacobi_layout="t")),
            ("serial", serial, dict(jacobi_blocks=1))):
        B = 32 if layout == "strided" else 512
        for kind, (single, plain, fused, fused_plain, cfg, make_args,
                   per_chain, names, _, _) in kinds.items():
            g = torch.Generator(device=dev).manual_seed(70 + B)
            v = bt.TorchVariates(g)
            s = dense_sampler(torch, bt, g, 4001, 8192, cfg(block_size=B),
                              **plan)
            check((s.jacobi, s.B, s.Npad, s.backend) == (
                plan["jacobi_blocks"], B, 4001, "pallas")
                and not s.x_packed and s.supports_fused_chains,
                f"[17a] plan {(s.jacobi, s.B, s.Npad, s.backend)}")
            st = s._run_steps(s.init(v), v, 3)
            cut = () if layout == "strided" else (SMALL_SERIAL_BLOCKS,)
            args, kw = make_args(s, st, v, *cut)
            # eps by its norm and largest value (check_sweeps): in the
            # horseshoe a lane sums all J*B = 4096 rows of a round, in
            # another order than the plain matrix product
            gate = check_sweeps
            err = gate(torch, f"[17a] {kind} {layout}", names,
                       tuple(single(*args, **kw)), tuple(plain(*args, **kw)))
            v8 = bt.TorchVariates(g, chains=CHAINS)
            st8 = s.init(v8, chains=CHAINS)
            for _ in range(3):
                st8 = s.step_chains(st8, v8)
            args, kw = make_args(s, st8, v8, *cut)
            ker = tuple(fused(*args, **kw))
            ferr = gate(torch, f"[17a] {kind} {layout} fused", names, ker,
                        tuple(fused_plain(*args, **kw)))
            for c in range(CHAINS):
                one = (chain_args(args, c, per_chain) if layout == "strided"
                       else single_chains(torch, args, kind, c))
                for name, a, b in zip(names, single(*one, **kw), ker):
                    check(torch.equal(a, b[c]),
                          f"[17a] {kind} {layout} chain {c} {name} differs "
                          f"from the single-chain dense kernel")
            log(f"[17a] {kind} dense {layout} N=4001 M=8192 (J={s.jacobi}, "
                f"B={s.B}): kernel vs plain labels/v equal, max |d| "
                f"{err:.3g}; fused C={CHAINS} vs plain max |d| {ferr:.3g}; "
                f"every chain bitwise equal to the single-chain kernel")
            del s, st, st8, args, ker

    # ---- 17b. dense against packed on the same dosages: phase 2's first
    # 8192 markers, their words and their standardized rows
    Mb = 8192
    xs = bt.simulate.packed_word_stats(HEADLINE_M)
    s_q = bt.SpikeSlabSampler(
        hs.data.XT[:Mb], hs.Y[:hs.N], CVA, bt.BayesRConfig(), transposed=True,
        x_dtype="2bit", x_stats=(xs[0][:Mb], xs[1][:Mb]), device="cuda")
    check(s_q.Npad == s_q.N and s_q._sweep_kw()["fold_affine"],
          "[17b] packed plan")
    Xd = decode_rows(s_q.data.XT, s_q.data.x_mean, s_q.data.x_scale,
                     s_q.data.row_valid)
    s_d = bt.SpikeSlabSampler(Xd, s_q.Y, CVA, bt.BayesRConfig(),
                              transposed=True, device="cuda")
    h_q = bt.HorseshoeSampler(
        s_q.data.XT, s_q.Y, bt.HorseshoeConfig(), transposed=True,
        x_dtype="2bit", x_stats=(xs[0][:Mb], xs[1][:Mb]), device="cuda")
    h_d = bt.HorseshoeSampler(Xd, s_q.Y, bt.HorseshoeConfig(),
                              transposed=True, device="cuda")
    del Xd
    check((s_d.jacobi, s_d.B, s_d.nb) == (s_q.jacobi, s_q.B, s_q.nb)
          and s_d.data.XT.dtype == torch.float32, "[17b] dense plan")
    for kind, sq, sd in (("bayesr", s_q, s_d), ("horseshoe", h_q, h_d)):
        hsk = kind == "horseshoe"
        single, _, _, _, _, make_args = strided[kind][:6]
        g = torch.Generator(device=dev).manual_seed(75)
        v = bt.TorchVariates(g)
        st = sq._run_steps(sq.init(v), v, 2)
        args_q, kw_q = make_args(sq, st, v)
        d = sd.data
        kw_d = dict(J=sd.jacobi, **sd._sweep_kw())

        def dense_sweep(*a, **k):
            return single(d.XT, d.gram, d.xsq, *a[3:], **kw_d)

        ker = tuple(dense_sweep(*args_q, **kw_q))
        ref = tuple(single(*args_q, **kw_q))
        agree, flips = dense_gates(torch, sq, f"[17b] {kind}", args_q, kw_q,
                                   ker, ref, hsk,
                                   sweeps=(dense_sweep, single))
        log(f"[17b] {kind} dense vs packed fold on phase 2's dosages (N="
            f"{sq.N}, M={Mb}, J={sq.jacobi}): label agreement {agree:.6f}, "
            f"|d eps|/|eps| {rel_err(ker[0], ref[0]):.3g}, |d beta|/|beta| "
            f"{rel_err(ker[1], ref[1]):.3g}, max |d beta| "
            f"{float((ker[1] - ref[1]).abs().max()):.3g}; chains with a "
            f"near-tie label flip {flips}")
        del st, args_q, ker, ref
    del s_q, s_d, h_q, h_d

    # ---- 17c / 18 / 19. the dense cell dense-16kx49k at full width
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(80)
    s = dense_sampler(torch, bt, g, DENSE_N, DENSE_M,
                      bt.BayesRConfig(emit_epsilon=False))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check((s.jacobi, s.B, s.jacobi_layout, s.nb, s.Mpad, s.Npad) ==
          (128, 32, "t", 1536, DENSE_M, DENSE_N), "[17c] dense cell plan")
    nr = s.nb // s.jacobi
    t0 = time.perf_counter()
    h = bt.HorseshoeSampler(s.data.XT, s.Y, bt.HorseshoeConfig(
        emit_epsilon=False), transposed=True, device="cuda")
    torch.cuda.synchronize()
    h_setup_s = time.perf_counter() - t0
    check(h.data.XT.data_ptr() == s.data.XT.data_ptr(), "[17c] X copied")
    log(f"[17c] dense-16kx49k: X {s.data.XT.numel() * 4 / 1e9:.2f} GB on "
        f"the card, sampler setup {setup_s:.2f} s (X built from the seed, "
        f"xsq, Gram blocks), horseshoe {h_setup_s:.2f} s; plan J={s.jacobi} "
        f"B={s.B} nb={s.nb} nr={nr}")
    samplers = {"bayesr": s, "horseshoe": h}
    for kind, (single, plain, fused, fused_plain, _, make_args, per_chain,
               names, arrays, rho_at) in strided.items():
        hsk = kind == "horseshoe"
        ss = samplers[kind]
        v = bt.TorchVariates(g)
        st = ss._run_steps(ss.init(v), v, 2)
        args, kw = make_args(ss, st, v)
        ker, ms = timed(torch, lambda: tuple(single(*args, **kw)), 3)
        ref, plain_ms = timed(torch, lambda: tuple(plain(*args, **kw)), 1)
        agree, flips = dense_gates(torch, ss, f"[17c] {kind}", args, kw, ker,
                                   ref, hsk)
        max_err = max(float((a - b).abs().max())
                      for a, b in zip(ker[:2], ref[:2]))
        moved = int((ker[1] != args[4]).sum())
        bound = dense_bound(ss, 1, moved, arrays, moved)
        lib_ms = dense_yardstick(torch, ss, args[rho_at][0], args[3]) * nr
        log(f"[17c] {kind} dense sweep: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {bound[0]:.3f} ms ({bound[1]}, "
            f"{moved} markers moved), torch.matmul of each round's strided "
            f"view by eps {lib_ms:.3f} ms per sweep; label agreement "
            f"{agree:.6f}, |d eps|/|eps| {rel_err(ker[0], ref[0]):.3g}, "
            f"max abs err {max_err:.3g}; chains with a near-tie flip {flips}")
        records[kind] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound[0], bound_by=bound[1],
                             library_ms=lib_ms)
        del args, ker, ref

        v8 = bt.TorchVariates(g, chains=CHAINS)
        st8 = ss.init(v8, chains=CHAINS)
        for _ in range(2):
            st8 = ss.step_chains(st8, v8)
        args, kw = make_args(ss, st8, v8)
        ker, fms = timed(torch, lambda: tuple(fused(*args, **kw)), 3)
        ones, singles_ms = timed(torch, lambda: [
            tuple(single(*chain_args(args, c, per_chain), **kw))
            for c in range(CHAINS)], 1)
        ref, fplain_ms = timed(torch, lambda: tuple(fused_plain(*args, **kw)),
                               1)
        bitwise = all(torch.equal(a, b[c]) for c, one in enumerate(ones)
                      for a, b in zip(one, ker))
        check(bitwise, f"[17c] {kind} fused chains not bitwise")
        agree, flips = dense_gates(torch, ss, f"[17c] {kind} fused", args,
                                   kw, ker, ref, hsk, per_chain)
        ferr = max(float((a - b).abs().max())
                   for a, b in zip(ker[:2], ref[:2]))
        moved_at = ker[1] != args[4]
        fbound = dense_bound(ss, CHAINS, int(moved_at.sum()), arrays,
                             int(moved_at.any(dim=0).sum()))
        flib_ms = dense_yardstick(torch, ss, args[rho_at][0], args[3]) * nr
        log(f"[17c] {kind} dense fused C={CHAINS}: {fms:.3f} ms, {CHAINS} "
            f"single-chain sweeps {singles_ms:.3f} ms, plain {fplain_ms:.1f}"
            f" ms, bound {fbound[0]:.3f} ms ({fbound[1]}), torch.matmul "
            f"yardstick {flib_ms:.3f} ms; chains bitwise equal to the "
            f"single-chain kernel; label agreement {agree:.6f}, max abs err "
            f"{ferr:.3g}; chains with a near-tie flip {flips}")
        records[kind + "_mc"] = dict(
            max_abs_err=ferr, ms=fms, plain_ms=fplain_ms, bound_ms=fbound[0],
            bound_by=fbound[1], library_ms=flib_ms)
        del args, ker, ref, ones, st8

        # 18. the main paths: one chain into a CSVSink, 8 fused chains
        # through run_chains into a ChainFanoutSink
        for chains, counter in ((None, single), (CHAINS, fused)):
            gm = torch.Generator(device=dev).manual_seed(81)
            if chains is None:
                chain = bt.ChainConfig(10, 5, 5)
                path = os.path.join(tmp, f"dense_{kind}.csv")
                sink = CSVSink(path, kind, M=ss.M, N=ss.N, emit_epsilon=False)
                paths = [path]
                run = lambda sk: ss.run(gm, chain, sink=sk)  # noqa: E731
            else:
                chain = bt.ChainConfig(5, 2, 2)
                sink = ChainFanoutSink.csv(
                    os.path.join(tmp, f"dense_{kind}_8chain.csv"), chains,
                    kind, M=ss.M, N=ss.N, emit_epsilon=False)
                paths = sink.paths
                run = lambda sk: ss.run_chains(  # noqa: E731
                    gm, chains, chain, sink=sk)
            st, out, wall, launches, peak = main_path(torch, run, sink,
                                                      counter)
            n_rows = len(list(chain.emit_iterations()))
            for path in paths:
                header, widths, bad = read_csv(path)
                check(len(header) == 2 + 2 * ss.M + 2
                      and widths == [len(header)] * n_rows and not bad,
                      f"[18] {path}: {len(header)} {widths} {bad}")
            check(all(np_finite(x) for x in out.values()),
                  f"[18] {kind} non-finite output")
            ex = ss.refresh_eps(st).eps
            rel = float((torch.linalg.norm(st.eps - ex, dim=-1)
                         / torch.linalg.norm(ex, dim=-1)).max())
            want = jt.LAUNCHES_PER_ROUND * nr * chain.max_iterations
            cell = ("dense-16kx49k" if kind == "bayesr"
                    else "dense-16kx49k-horseshoe") + (
                "" if chains is None else f"-{chains}chain")
            CELL_MS[cell] = wall / chain.max_iterations * 1e3
            check(rel < 1e-4, f"[18] {cell} tracked eps vs recompute {rel}")
            check(launches == want, f"[18] {cell} launches {launches}")
            records[kind + ("" if chains is None else "_mc")][
                "launches"] = launches
            two_steps = Steps(ss, st, bt.TorchVariates(gm, chains=chains))
            pnames = ("dense_dot_kernel",
                      ("hs_solve" if hsk else "solve")
                      + ("_kernel" if chains is None else "_mc_kernel"),
                      "row_apply_kernel")
            split, dev_ms, wall_ms = profile_split(torch, two_steps, pnames,
                                                   want=2 * nr)
            check(profiled(split, 2 * nr), f"[18] profiled launches {split}")
            log(f"[18] {cell} main path: "
                f"{wall / chain.max_iterations * 1e3:.2f} ms/iter ({wall:.2f}"
                f" s for {chain.max_iterations} iterations incl. CSV), peak "
                f"{peak:.2f} GiB, launches {launches} (want {want}), "
                f"tracked-vs-exact eps {rel:.3g}; profile of 2 steps: "
                + ", ".join(f"{n} {us:.2f} us x {c}"
                            for n, (us, c) in split.items())
                + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall, "
                f"{dev_ms / 2:.3f} ms per step")
            c = chains or 1
            x = ss.data.XT[round_rows(torch, ss, torch.zeros(
                (), dtype=torch.long, device=dev))]
            round_report(
                torch, f"[18] {cell}", split, "dense_dot_kernel",
                "row_apply_kernel", kernel_bounds.dot_round(
                    ss.N, x.shape[0], c, 4),
                kernel_bounds.row_apply_round(ss.N, two_steps.moved() / nr,
                                              c, 4), x, chains)
            del st, out, two_steps, x
    del samplers

    # ---- 19. the serial dense kernels at the cell (jacobi_blocks=1, B=512)
    for kind, (single, plain, fused, fused_plain, cfg, make_args, _, names,
               arrays, _) in serial.items():
        hsk = kind == "horseshoe"
        kw1 = dict(transposed=True, device="cuda", jacobi_blocks=1)
        ss = (bt.HorseshoeSampler(s.data.XT, s.Y, cfg(emit_epsilon=False),
                                  **kw1) if hsk else
              bt.SpikeSlabSampler(s.data.XT, s.Y, CVA, cfg(emit_epsilon=False),
                                  **kw1))
        check((ss.jacobi, ss.B, ss.nb) == (1, 512, 96)
              and ss.data.XT.data_ptr() == s.data.XT.data_ptr(),
              "[19] serial plan")
        g1 = torch.Generator(device=dev).manual_seed(90)
        v = bt.TorchVariates(g1)
        st = ss._run_steps(ss.init(v), v, 2)
        args, kw = make_args(ss, st, v, SERIAL_PLAIN_BLOCKS)
        ker = tuple(single(*args, **kw))
        ref, plain_ms = timed(torch, lambda: tuple(plain(*args, **kw)), 1)
        err, agree, rel = serial_gates(torch, f"[19] {kind}", ker, ref, hsk)
        args, kw = make_args(ss, st, v)
        full, ms = timed(torch, lambda: tuple(single(*args, **kw)), 3)
        moved = int((full[1] != args[4]).sum())
        bound = dense_bound(ss, 1, moved, arrays, moved, moved)
        border = args[5 if hsk else 6]
        lib_ms = dense_yardstick(torch, ss, border[0], args[3],
                                 strided=False) * ss.nb
        log(f"[19] {kind} dense serial: {SERIAL_PLAIN_BLOCKS} blocks vs "
            f"plain max |d| "
            f"{err:.3g}, |d eps|/|eps| {rel:.3g}, label agreement "
            f"{agree:.6f}, plain {plain_ms:.1f} "
            f"ms; full sweep ({ss.nb} blocks, {ss.nb * ss.B} dependent "
            f"steps) {ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}, "
            f"{moved} moved), torch.matmul yardstick {lib_ms:.3f} ms")
        records[kind + "_serial"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            plain_blocks=SERIAL_PLAIN_BLOCKS,
            sweep_blocks=int(ss.nb), dependent_steps=int(ss.nb * ss.B),
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)
        del args, full, ker, ref

        v8 = bt.TorchVariates(g1, chains=CHAINS)
        st8 = ss.init(v8, chains=CHAINS)
        for _ in range(2):
            st8 = ss.step_chains(st8, v8)
        args, kw = make_args(ss, st8, v8, SERIAL_PLAIN_BLOCKS)
        ker = tuple(fused(*args, **kw))
        ref, fplain_ms = timed(torch, lambda: tuple(fused_plain(*args, **kw)),
                               1)
        ferr, fagree, frel = serial_gates(torch, f"[19] {kind} fused", ker,
                                          ref, hsk)
        args, kw = make_args(ss, st8, v8)
        full, fms = timed(torch, lambda: tuple(fused(*args, **kw)), 3)
        ones, singles_ms = timed(torch, lambda: [
            tuple(single(*single_chains(torch, args, kind, c), **kw))
            for c in range(CHAINS)], 1)
        check(all(torch.equal(a, b[c]) for c, one in enumerate(ones)
                  for a, b in zip(one, full)),
              f"[19] {kind} fused serial chains not bitwise")
        moved_at = full[1] != args[4]
        fbound = dense_bound(ss, CHAINS, int(moved_at.sum()), arrays,
                             int(moved_at.any(dim=0).sum()),
                             int(moved_at.any(dim=0).sum()))
        flib_ms = dense_yardstick(torch, ss, border[0], args[3],
                                  strided=False) * ss.nb
        log(f"[19] {kind} dense serial fused C={CHAINS}: "
            f"{SERIAL_PLAIN_BLOCKS} blocks vs plain max |d| {ferr:.3g}, |d eps|/|eps| {frel:.3g}, label agreement "
            f"{fagree:.6f}, plain {fplain_ms:.1f} ms; full sweep "
            f"{fms:.3f} ms, {CHAINS} single-chain sweeps {singles_ms:.3f} "
            f"ms, bound {fbound[0]:.3f} ms ({fbound[1]}), torch.matmul "
            f"yardstick {flib_ms:.3f} ms; chains bitwise equal to the "
            f"single-chain serial kernel")
        records[kind + "_serial_mc"] = dict(
            max_abs_err=ferr, ms=fms, plain_ms=fplain_ms,
            plain_blocks=SERIAL_PLAIN_BLOCKS, sweep_blocks=int(ss.nb),
            dependent_steps=int(ss.nb * ss.B), bound_ms=fbound[0],
            bound_by=fbound[1], library_ms=flib_ms)
        del args, full, ker, ref, ones, st8

        # the serial main paths: one chain, then 8 fused chains
        for chains, counter in ((None, single), (CHAINS, fused)):
            gm = torch.Generator(device=dev).manual_seed(91)
            if chains is None:
                chain = (bt.ChainConfig(10, 5, 5) if not hsk
                         else bt.ChainConfig(5, 2, 2))
                path = os.path.join(tmp, f"dense_{kind}_serial.csv")
                sink = CSVSink(path, kind, M=ss.M, N=ss.N, emit_epsilon=False)
                paths = [path]
                run = lambda sk: ss.run(gm, chain, sink=sk)  # noqa: E731
            else:
                chain = bt.ChainConfig(5, 2, 2)
                sink = ChainFanoutSink.csv(
                    os.path.join(tmp, f"dense_{kind}_serial_8chain.csv"),
                    chains, kind, M=ss.M, N=ss.N, emit_epsilon=False)
                paths = sink.paths
                run = lambda sk: ss.run_chains(  # noqa: E731
                    gm, chains, chain, sink=sk)
            st, out, wall, launches, peak = main_path(torch, run, sink,
                                                      counter)
            n_rows = len(list(chain.emit_iterations()))
            for path in paths:
                header, widths, bad = read_csv(path)
                check(widths == [len(header)] * n_rows and not bad,
                      f"[19] {path}: {widths} {bad}")
            ex = ss.refresh_eps(st).eps
            rel = float((torch.linalg.norm(st.eps - ex, dim=-1)
                         / torch.linalg.norm(ex, dim=-1)).max())
            want = ser.LAUNCHES_PER_BLOCK * ss.nb * chain.max_iterations
            cell = ("dense-16kx49k" + ("-horseshoe" if hsk else "")
                    + "-serial" + ("" if chains is None else f"-{chains}chain"))
            check(rel < 1e-4, f"[19] {cell} tracked eps vs recompute {rel}")
            check(launches == want, f"[19] {cell} launches {launches}")
            records[kind + "_serial" + ("" if chains is None else "_mc")][
                "launches"] = launches
            msg = ""
            if chains is None:
                one_step = Steps(ss, st, bt.TorchVariates(gm), 1)
                split, dev_ms, wall_ms = profile_split(
                    torch, one_step,
                    ("serial_dense_dot_kernel", "serial_solve_kernel",
                     "row_apply_kernel"), want=ss.nb)
                check(profiled(split, ss.nb), f"[19] profiled {split}")
                msg = "; profile of 1 step: " + ", ".join(
                    f"{n} {us:.2f} us x {c}" for n, (us, c) in split.items()
                ) + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall"
            log(f"[19] {cell} main path: "
                f"{wall / chain.max_iterations * 1e3:.2f} ms/iter ({wall:.2f}"
                f" s for {chain.max_iterations} iterations incl. CSV), peak "
                f"{peak:.2f} GiB, launches {launches} (want {want}), "
                f"tracked-vs-exact eps {rel:.3g}" + msg)
            if chains is None:
                # a block's rows (33.5 MB) fit the 50 MB L2: the addmv
                # yardstick reads them from it after its first call
                x = ss.data.XT[:ss.B]
                round_report(
                    torch, f"[19] {cell}", split, "serial_dense_dot_kernel",
                    "row_apply_kernel", kernel_bounds.dot_round(
                        ss.N, ss.B, 1, 4),
                    kernel_bounds.row_apply_round(
                        ss.N, one_step.moved() / ss.nb, 1, 4), x)
                del one_step, x
            del st, out
        del ss
    del s, h

    # ---- 19. recovery through the dense kernels (the phase 3 and 6
    # recipes: N=4096, M=2048, block_size 256, J=8)
    for kind in ("bayesr", "horseshoe"):
        gr = torch.Generator(device=dev).manual_seed(13)
        beta_true = recovery_signal(torch, gr, 2048)
        if kind == "bayesr":
            cfg, rchain = bt.BayesRConfig(block_size=256), (100, 60, 1)
        else:
            A = (1.0 / 4096 ** 0.5) * 32 / (2048 - 32)
            cfg, rchain = (bt.HorseshoeConfig(A=A, block_size=256),
                           HS_RECOVERY_CHAIN)
        sr = dense_sampler(torch, bt, gr, 4096, 2048, cfg, signal=beta_true)
        check((sr.jacobi, sr.B, sr.backend) == (8, 32, "pallas"),
              "[19] dense recovery plan")
        t0 = time.perf_counter()
        _, out = sr.run(gr, bt.ChainConfig(*rchain))
        corr = posterior_corr(torch, out, beta_true)
        log(f"[19] {kind} dense recovery corr {corr:.4f} over {rchain} "
            f"({(time.perf_counter() - t0) / rchain[0] * 1e3:.2f} ms/iter)")
        check(corr > 0.8, f"[19] {kind} dense recovery corr {corr}")
        del sr, out

    # ---- 20. the CLI on a dense .npy (--x-dtype dense, the default), on
    # the card: N=4096 x M=8192, plan J=32, B=32
    N20, M20 = 4096, 8192
    rng = np.random.default_rng(20)
    with tempfile.TemporaryDirectory(dir=tmp) as d20:
        xp, yp = os.path.join(d20, "x.npy"), os.path.join(d20, "y.npy")
        np.save(xp, rng.binomial(2, rng.uniform(0.1, 0.9, M20),
                                 size=(N20, M20)).astype(np.float32))
        np.save(yp, rng.standard_normal(N20))
        nr20 = M20 // 32 // 32
        for kind, counter in (("bayesr", jt.bayesr_jacobi_t),
                              ("horseshoe", jt.horseshoe_jacobi_t)):
            out = os.path.join(d20, f"{kind}.csv")
            torch.cuda.synchronize()
            counter.launches = 0
            t0 = time.perf_counter()
            rc = cli.main([kind, "--x", xp, "--y", yp, "--x-dtype", "dense",
                           "--out", out, "--iterations", "6", "--burn-in",
                           "2", "--thinning", "2", "--seed", "5"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            header, widths, bad = read_csv(out)
            want = 3 * nr20 * 6
            n_rows = len(list(bt.ChainConfig(6, 2, 2).emit_iterations()))
            log(f"[20] python -m bayesrrcpp_tpu_torch {kind} --x x.npy "
                f"--x-dtype dense (N={N20}, M={M20}): rc {rc}, {wall:.2f} s, "
                f"CSV {len(widths)} rows of {len(header)} columns, launches "
                f"{counter.launches} (want {want})")
            check(rc == 0 and len(header) == 2 + 2 * M20 + 2 + N20
                  and widths == [len(header)] * n_rows and not bad,
                  f"[20] {kind} CSV {len(header)} {widths} {bad}")
            check(counter.launches == want,
                  f"[20] {kind} launches {counter.launches}")

    src = "bayesrrcpp_tpu_torch/csrc/"
    tpu = "bayesrrcpp_tpu/ops/"
    meta = {
        "bayesr": ("jacobi_t_sweep_dense", "jacobi_t.cu",
                   "pallas_jacobi_t.py:405"),
        "horseshoe": ("jacobi_t_hs_sweep_dense", "jacobi_t.cu",
                      "pallas_jacobi_t.py:650"),
        "bayesr_mc": ("jacobi_t_mc_sweep_dense", "jacobi_t_mc.cu",
                      "pallas_jacobi_t.py:1199/:2416"),
        "horseshoe_mc": ("jacobi_t_hs_mc_sweep_dense", "jacobi_t_mc.cu",
                         "pallas_jacobi_t.py:1742/:2922"),
        "bayesr_serial": ("bayesr_serial_sweep_dense", "serial.cu",
                          "pallas_sweep.py:97"),
        "horseshoe_serial": ("horseshoe_serial_sweep_dense", "serial.cu",
                             "pallas_sweep.py:622"),
        "bayesr_serial_mc": ("bayesr_serial_sweep_mc_dense", "serial.cu",
                             "pallas_multichain.py:115"),
        "horseshoe_serial_mc": ("horseshoe_serial_sweep_mc_dense",
                                "serial.cu", "pallas_multichain.py:516")}
    return [dict({"name": name, "route": "cuda", "source": src + f,
                  "replaces": tpu + where}, **records[key])
            for key, (name, f, where) in meta.items()]


# (J, B) of the row-layout plans held exactly against their plain
# versions at N=4096 x M=8192 (phase 21a), and the rounds of a row plain
# sweep at the headline and the dense cell (21b)
ROW_PLANS = ((8, 512), (32, 128), (2, 64), (16, 16))
ROW_PLAIN_ROUNDS = 4


def row_args(s, st, v, rounds=None):
    """The row-layout sweep's operands for state ``st`` with fresh variates
    from ``v`` (models/bayesr.py:SpikeSlabSampler.step on a row plan): the
    serial sweep's, with J, cut to the first ``rounds`` rounds."""
    args, kw = serial_args(s, st, v, rounds and rounds * s.jacobi)
    return args, dict(kw, J=s.jacobi)


def hs_row_args(s, st, v, rounds=None):
    """The horseshoe's row-layout sweep operands, as ``row_args``."""
    args, kw = hs_serial_args(s, st, v, rounds and rounds * s.jacobi)
    return args, dict(kw, J=s.jacobi)


def round_solve_case(torch, s, args, kind):
    """The round solve's operands for round 0 of a row sweep's operands
    ``args`` on sampler ``s``: r from the round's rows (dense, or decoded
    words) against eps, the rounds' Gram blocks and state, and the
    ``build_pkg_jacobi`` / ``build_pkg_hs_jacobi`` operand."""
    from bayesrrcpp_tpu_torch.ops import jacobi as jr
    from bayesrrcpp_tpu_torch.ops.genotypes import decode_rows

    d = s.data
    J, B = s.jacobi, s.B
    order = args[6 if kind == "bayesr" else 5][:J]
    inner_all = args[7 if kind == "bayesr" else 6]
    blk = order.long()
    rows = (blk[:, None] * B + torch.arange(B, device=blk.device)).reshape(-1)
    x = (decode_rows(d.XT[rows], d.x_mean[rows], d.x_scale[rows],
                     d.row_valid) if s.x_packed else d.XT[rows])
    r = (x @ args[3]).view(J, B)
    if kind == "bayesr":
        pkg, inner = jr.build_pkg_jacobi(
            d.xsq, d.g_assign, d.valid, args[8][:J * B], args[9][:J * B],
            args[10], d.cva, args[12], args[13], order, inner_all, B=B, J=J)
        return (r, d.gram[blk], args[4][rows].view(J, B),
                args[5][rows].view(J, B), d.g_assign[rows].view(J, B),
                inner[0], pkg[0], args[12])
    pkg, inner = jr.build_pkg_hs_jacobi(
        d.xsq, d.valid, args[7][:J * B], args[8], args[9], args[10],
        args[11], order, inner_all, B=B, J=J)
    return r, d.gram[blk], args[4][rows].view(J, B), inner[0], pkg[0]


def check_round_solve(torch, tag, kind, ker, ref):
    """A round solve against its plain version: labels and v equal, dlane,
    beta and bacc to 1e-5 (relative and absolute).  Returns the largest
    |d| of the floats."""
    floats = (0, 1, 4) if kind == "bayesr" else (0, 1)
    if kind == "bayesr":
        check(torch.equal(ker[2], ref[2]) and torch.equal(ker[3], ref[3]),
              f"{tag} labels or v differ from plain")
    worst = 0.0
    for i in floats:
        d = float((ker[i] - ref[i]).abs().max())
        worst = max(worst, d)
        check(torch.allclose(ker[i], ref[i], rtol=1e-5, atol=1e-5),
              f"{tag} output {i} differs from plain: max |d| {d:.3g}")
    return worst


def reset_counts(*fns):
    for fn in fns:
        fn.launches = 0


def row_main_paths(torch, bt, s, tag, cell, tmp, counters, gen_seed,
                   chain=None):
    """Phase 22's main paths of a row-plan sampler ``s``: ``.run`` into a
    CSVSink with the row sweep's and its round solve's counts reset just
    before (3 launches and one solve a round), then 8 fused chains through
    ``run_chains`` (the serial fused sweep, 3 launches a block; the row
    sweep launched no time); CSV widths, finite values, tracked vs
    recomputed eps < 1e-4, and a profile of 2 steps of each.  Returns the
    one-chain run's (launches, solve launches, ms/iter)."""
    from bayesrrcpp_tpu_torch.io.sink import ChainFanoutSink, CSVSink
    from bayesrrcpp_tpu_torch.tools import kernel_bounds

    single, solve, fused = counters
    kind = "bayesr" if isinstance(s, bt.SpikeSlabSampler) else "horseshoe"
    nr = s.nb // s.jacobi
    dense = not s.x_packed
    dot = "serial_dense_dot_kernel" if dense else "serial_dot_kernel"
    apply = "row_apply_kernel" if dense else "serial_apply_kernel"
    out_rec = None
    for chains in (None, CHAINS):
        g = torch.Generator(device="cuda").manual_seed(gen_seed)
        if chains is None:
            ch = chain or bt.ChainConfig(10, 5, 5)
            path = os.path.join(tmp, f"{cell}.csv")
            sink = CSVSink(path, kind, M=s.M, N=s.N, emit_epsilon=False)
            paths = [path]
            reset_counts(single, solve, fused)
            st, out, wall, launches, peak = main_path(
                torch, lambda sk: s.run(g, ch, sink=sk), sink, single)
            want, want_solve = 3 * nr * ch.max_iterations, nr * ch.max_iterations
            solves, others = solve.launches, fused.launches
            per = 2 * nr
        else:
            ch = bt.ChainConfig(5, 2, 2)
            sink = ChainFanoutSink.csv(os.path.join(tmp, f"{cell}_8chain.csv"),
                                       chains, kind, M=s.M, N=s.N,
                                       emit_epsilon=False)
            paths = sink.paths
            reset_counts(single, solve, fused)
            st, out, wall, launches, peak = main_path(
                torch, lambda sk: s.run_chains(g, chains, ch, sink=sk), sink,
                fused)
            want, want_solve = 3 * s.nb * ch.max_iterations, 0
            solves, others = solve.launches, single.launches
            per = 2 * s.nb
        n_rows = len(list(ch.emit_iterations()))
        for p in paths:
            header, widths, bad = read_csv(p)
            check(len(header) == 2 + 2 * s.M + 2
                  and widths == [len(header)] * n_rows and not bad,
                  f"{tag} {p}: {len(header)} {widths} {bad}")
        check(all(np_finite(x) for x in out.values()),
              f"{tag} {cell} non-finite output")
        ex = s.refresh_eps(st).eps
        rel = float((torch.linalg.norm(st.eps - ex, dim=-1)
                     / torch.linalg.norm(ex, dim=-1)).max())
        name = cell + ("" if chains is None else f"-{chains}chain")
        check(rel < 1e-4, f"{tag} {name} tracked eps vs recompute {rel}")
        check(launches == want and solves == want_solve and others == 0,
              f"{tag} {name} launches {launches} (want {want}), round "
              f"solves {solves} (want {want_solve}), other sweep {others}")
        two_steps = Steps(s, st, bt.TorchVariates(g, chains=chains))
        split, dev_ms, wall_ms = profile_split(
            torch, two_steps, (dot, "serial_solve_kernel", apply), want=per)
        check(profiled(split, per), f"{tag} {name} profiled {split}")
        ms_iter = wall / ch.max_iterations * 1e3
        log(f"{tag} {name} main path: {ms_iter:.2f} ms/iter ({wall:.2f} s "
            f"for {ch.max_iterations} iterations incl. CSV), peak "
            f"{peak:.2f} GiB, launches {launches} (want {want}), round "
            f"solves {solves}, tracked-vs-exact eps {rel:.3g}; profile of 2 "
            f"steps: " + ", ".join(f"{n} {us:.2f} us x {c}"
                                   for n, (us, c) in split.items())
            + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall")
        if dense:
            # a launch: a round of J blocks (one chain), a block (fused)
            c, nblk = chains or 1, s.jacobi if chains is None else 1
            eb = 1 if s.x_int8 else 4
            x = None if s.x_int8 else s.data.XT[:nblk * s.B]
            round_report(
                torch, f"{tag} {name}", split, dot, apply,
                kernel_bounds.dot_round(s.N, nblk * s.B, c, eb),
                kernel_bounds.row_apply_round(
                    s.N, two_steps.moved() * nblk / s.nb, c, eb), x, chains)
            del x
        if chains is None:
            out_rec = (launches, solves, ms_iter)
        del st, out, two_steps
    return out_rec


def row_phases(torch, bt, hs, tmp):
    """Phases 21-22 (module docstring): the row-layout sweeps and round
    solves against their plain versions at N=4096 x M=8192 (words) and
    N=4001 x M=8192 (dense), at the headline (the words of ``hs``) and at
    the dense cell, the main paths of the row plans and recovery through
    the row sweep; CSVs under ``tmp``.  Returns the kernels' records."""
    from bayesrrcpp_tpu_torch.ops import jacobi as jr
    from bayesrrcpp_tpu_torch.ops import multichain as mcs
    from bayesrrcpp_tpu_torch.tools import kernel_bounds

    dev = torch.device("cuda")
    bnames = ("eps", "beta", "labels", "v", "beta_acum")
    kinds = {
        "bayesr": (jr.bayesr_jacobi, jr.bayesr_jacobi_reference,
                   jr.bayesr_round_solve, jr.bayesr_round_solve_reference,
                   mcs.bayesr_sweep_mc, bt.BayesRConfig, row_args, bnames,
                   6, kernel_bounds.bayesr_round_solve),
        "horseshoe": (jr.horseshoe_jacobi, jr.horseshoe_jacobi_reference,
                      jr.horseshoe_round_solve,
                      jr.horseshoe_round_solve_reference,
                      mcs.horseshoe_sweep_mc, bt.HorseshoeConfig,
                      hs_row_args, ("eps", "beta"), 4,
                      kernel_bounds.horseshoe_round_solve)}
    solve_kw = {"bayesr": dict(K=4, G=1), "horseshoe": {}}
    records = {}

    # ---- 21a. every plan of ROW_PLANS, both samplers, words and dense rows
    for storage in ("packed", "dense"):
        for kind, (single, plain, solve, solve_plain, _, cfg, make_args,
                   names, _, _) in kinds.items():
            worst = 0.0
            for J, B in ROW_PLANS:
                g = torch.Generator(device=dev).manual_seed(100 + J + B)
                v = bt.TorchVariates(g)
                if storage == "packed":
                    s = packed_sampler(torch, bt, g, 4096, 8192,
                                       cfg(block_size=B), jacobi_blocks=J)
                else:
                    s = dense_sampler(torch, bt, g, 4001, 8192,
                                      cfg(block_size=B), jacobi_blocks=J)
                check((s.jacobi, s.B, s.jacobi_layout, s.Mpad) ==
                      (J, B, "row", 8192), f"[21a] plan {(s.jacobi, s.B)}")
                st = s._run_steps(s.init(v), v, 3)
                args, kw = make_args(s, st, v, SMALL_ROW_ROUNDS)
                tag = f"[21a] {kind} {storage} J={J} B={B}"
                worst = max(worst, check_sweeps(
                    torch, tag, names, tuple(single(*args, **kw)),
                    tuple(plain(*args, **kw))))
                if (J, B) == (32, 128):
                    rs = round_solve_case(torch, s, args, kind)
                    serr = check_round_solve(
                        torch, f"{tag} round solve", kind,
                        solve(*rs, **solve_kw[kind]),
                        solve_plain(*rs, **solve_kw[kind]))
                    log(f"{tag} round solve vs plain: max |d| {serr:.3g}")
                del s, st, args
            log(f"[21a] {kind} {storage} row sweeps at plans {ROW_PLANS} "
                f"(N={4096 if storage == 'packed' else 4001}, M=8192): "
                f"labels/v equal, max |d| {worst:.3g}")

    # ---- 21b. the headline (the words of phase 2) with jacobi_layout="row"
    common = dict(transposed=True, x_dtype="2bit", device="cuda",
                  x_stats=bt.simulate.packed_word_stats(HEADLINE_M))
    samplers = {}
    for kind, (single, plain, solve, solve_plain, fused, cfg, make_args,
               names, arrays, solve_bound) in kinds.items():
        hsk = kind == "horseshoe"
        t0 = time.perf_counter()
        if hsk:
            s = bt.HorseshoeSampler(hs.data.XT, hs.Y[:hs.N],
                                    cfg(emit_epsilon=False),
                                    jacobi_layout="row", **common)
        else:
            s = bt.SpikeSlabSampler(hs.data.XT, hs.Y[:hs.N], CVA,
                                    cfg(emit_epsilon=False),
                                    jacobi_layout="row", **common)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        nr = s.nb // s.jacobi
        check((s.jacobi, s.B, s.nb, nr, s.Mpad) ==
              (32, 128, 3936, 123, HEADLINE_M)
              and s.data.XT.data_ptr() == hs.data.XT.data_ptr(),
              f"[21b] headline row plan {(s.jacobi, s.B, s.nb)}")
        samplers[kind] = s
        g = torch.Generator(device=dev).manual_seed(110)
        v = bt.TorchVariates(g)
        st = s._run_steps(s.init(v), v, 2)
        args, kw = make_args(s, st, v, ROW_PLAIN_ROUNDS)
        ker = tuple(single(*args, **kw))
        ref, plain_ms = timed(torch, lambda: tuple(plain(*args, **kw)), 1)
        agree, flips = dense_gates(torch, s, f"[21b] {kind}", args, kw, ker,
                                   ref, hsk, sweeps=(single, plain),
                                   rounds=row_rounds)
        max_err = max(float((a - b).abs().max())
                      for a, b in zip(ker[:2], ref[:2]))
        rel = rel_err(ker[0], ref[0])
        rs = round_solve_case(torch, s, args, kind)
        sk, solve_ms = timed(torch, lambda: solve(*rs, **solve_kw[kind]), 20)
        sr, solve_plain_ms = timed(
            torch, lambda: solve_plain(*rs, **solve_kw[kind]), 1)
        serr = check_round_solve(torch, f"[21b] {kind} round solve", kind,
                                 sk, sr)
        sbound = solve_bound(s.jacobi * s.B, s.B)
        args, kw = make_args(s, st, v)
        full, ms = timed(torch, lambda: tuple(single(*args, **kw)), 3)
        moved = int((full[1] != args[4]).sum())
        bound = sweep_bound(s, 1, moved, arrays)
        blk = args[6 if not hsk else 5][:s.jacobi].long()
        rows = (blk[:, None] * s.B
                + torch.arange(s.B, device=dev)).reshape(-1)
        lib_ms = dot_yardstick(torch, s, rows, args[3]) * nr
        log(f"[21b] {kind} headline row plan J={s.jacobi} B={s.B} nr={nr} "
            f"(sampler on phase 2's words {setup_s:.2f} s): "
            f"{ROW_PLAIN_ROUNDS} rounds vs plain: label agreement "
            f"{agree:.6f}, |d eps|/|eps| {rel:.3g}, max abs err "
            f"{max_err:.3g}, plain {plain_ms:.1f} ms, chains with a near-tie"
            f" flip {flips}; full sweep {ms:.3f} ms, bound {bound[0]:.3f} ms "
            f"({bound[1]}, {moved} markers moved), dot yardstick "
            f"torch.matmul ({s.jacobi * s.B} x {s.Npad}) @ ({s.Npad},) x "
            f"{nr} rounds {lib_ms:.3f} ms; round solve alone {solve_ms:.4f}"
            f" ms a round (plain {solve_plain_ms:.1f} ms, bound "
            f"{sbound['bound_ms']:.4f} ms, {sbound['bound_by']}), max |d| "
            f"{serr:.3g}")
        records[kind] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                             plain_rounds=ROW_PLAIN_ROUNDS, rounds=int(nr),
                             bound_ms=bound[0], bound_by=bound[1],
                             library_ms=lib_ms)
        records[kind + "_solve"] = dict(
            max_abs_err=serr, ms=solve_ms, plain_ms=solve_plain_ms,
            per="round", bound_ms=sbound["bound_ms"],
            bound_by=sbound["bound_by"], library_ms=None)
        del args, full, ker, ref, st

        # one sweep at an explicit jacobi_blocks=8 (the default layout is
        # "row"): B=512, nr=123
        kw8 = dict(common, jacobi_blocks=8)
        s8 = (bt.HorseshoeSampler(hs.data.XT, hs.Y[:hs.N],
                                  cfg(emit_epsilon=False), **kw8) if hsk
              else bt.SpikeSlabSampler(hs.data.XT, hs.Y[:hs.N], CVA,
                                       cfg(emit_epsilon=False), **kw8))
        check((s8.jacobi, s8.B, s8.jacobi_layout, s8.nb // s8.jacobi) ==
              (8, 512, "row", 123), "[21b] jacobi_blocks=8 plan")
        v8 = bt.TorchVariates(torch.Generator(device=dev).manual_seed(111))
        st8 = s8._run_steps(s8.init(v8), v8, 2)
        args, kw = make_args(s8, st8, v8)
        full, ms8 = timed(torch, lambda: tuple(single(*args, **kw)), 3)
        moved8 = int((full[1] != args[4]).sum())
        bound8 = sweep_bound(s8, 1, moved8, arrays)
        rel8 = rel_err(full[0][:s8.N],
                       args[3][:s8.N] - s8.xbeta(full[1] - args[4]))
        log(f"[21b] {kind} headline jacobi_blocks=8 (B=512, nr=123): sweep "
            f"{ms8:.3f} ms, bound {bound8[0]:.3f} ms ({bound8[1]}, "
            f"{moved8} moved), eps against eps_in - X dbeta {rel8:.3g}")
        check(rel8 < 1e-4, f"[21b] {kind} jacobi_blocks=8 eps {rel8}")
        del s8, st8, args, full

    # ---- 22. the headline row plan's main paths
    for kind, s in samplers.items():
        single, solve, fused = (kinds[kind][0], kinds[kind][2],
                                kinds[kind][4])
        cell = "biobank-packed-row" if kind == "bayesr" else (
            "biobank-horseshoe-row")
        launches, solves, ms_iter = row_main_paths(
            torch, bt, s, "[22]", cell, tmp, (single, solve, fused), 120)
        records[kind]["launches"] = launches
        records[kind + "_solve"]["launches"] = solves
        records[kind]["ms_per_iter"] = ms_iter
    del samplers, s

    # ---- 21b / 22 at the dense cell dense-16kx49k with jacobi_layout="row"
    g = torch.Generator(device=dev).manual_seed(130)
    sd = dense_sampler(torch, bt, g, 16_384, 49_152,
                       bt.BayesRConfig(emit_epsilon=False),
                       jacobi_layout="row")
    hd = bt.HorseshoeSampler(sd.data.XT, sd.Y,
                             bt.HorseshoeConfig(emit_epsilon=False),
                             transposed=True, device="cuda",
                             jacobi_layout="row")
    check((sd.jacobi, sd.B, sd.nb // sd.jacobi, hd.jacobi, hd.B) ==
          (32, 128, 12, 32, 128) and not sd.x_packed
          and hd.data.XT.data_ptr() == sd.data.XT.data_ptr(),
          f"[21b] dense row plan {(sd.jacobi, sd.B, sd.nb)}")
    for kind, s in (("bayesr", sd), ("horseshoe", hd)):
        (single, plain, solve, _, fused, _, make_args, _, arrays,
         _) = kinds[kind]
        hsk = kind == "horseshoe"
        nr = s.nb // s.jacobi
        v = bt.TorchVariates(torch.Generator(device=dev).manual_seed(131))
        st = s._run_steps(s.init(v), v, 2)
        args, kw = make_args(s, st, v, ROW_PLAIN_ROUNDS)
        ker = tuple(single(*args, **kw))
        ref, plain_ms = timed(torch, lambda: tuple(plain(*args, **kw)), 1)
        agree, flips = dense_gates(torch, s, f"[21b] dense {kind}", args, kw,
                                   ker, ref, hsk, sweeps=(single, plain),
                                   rounds=row_rounds)
        max_err = max(float((a - b).abs().max())
                      for a, b in zip(ker[:2], ref[:2]))
        args, kw = make_args(s, st, v)
        full, ms = timed(torch, lambda: tuple(single(*args, **kw)), 3)
        moved = int((full[1] != args[4]).sum())
        bound = dense_bound(s, 1, moved, arrays, moved)
        blk = args[6 if not hsk else 5][:s.jacobi].long()
        rows = (blk[:, None] * s.B
                + torch.arange(s.B, device=dev)).reshape(-1)
        x = s.data.XT[rows]
        lib_ms = timed(torch, lambda: torch.matmul(x, args[3]), 5)[1] * nr
        del x
        log(f"[21b] dense-16kx49k-row {kind} (J={s.jacobi}, B={s.B}, "
            f"nr={nr}): {ROW_PLAIN_ROUNDS} rounds vs plain: label agreement"
            f" {agree:.6f}, |d eps|/|eps| {rel_err(ker[0], ref[0]):.3g}, "
            f"max abs err {max_err:.3g}, plain {plain_ms:.1f} ms, chains "
            f"with a near-tie flip {flips}; full sweep {ms:.3f} ms, bound "
            f"{bound[0]:.3f} ms ({bound[1]}, {moved} moved), torch.matmul "
            f"of each round's rows by eps {lib_ms:.3f} ms per sweep")
        cell = "dense-16kx49k-row" + ("-horseshoe" if hsk else "")
        launches, solves, ms_iter = row_main_paths(
            torch, bt, s, "[22]", cell, tmp, (single, solve, fused), 132)
        records[kind + "_dense"] = dict(
            max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
            plain_rounds=ROW_PLAIN_ROUNDS, rounds=int(nr), bound_ms=bound[0],
            bound_by=bound[1], library_ms=lib_ms, launches=launches,
            ms_per_iter=ms_iter)
        del args, full, ker, ref, st
    del sd, hd

    # ---- 22. the auto plan at M=1500, block_size=64: (2, 64, "row")
    for kind, (single, _, solve, _, fused, cfg, _, _, _, _) in kinds.items():
        g = torch.Generator(device=dev).manual_seed(140)
        s = packed_sampler(torch, bt, g, 4096, 1500,
                           cfg(block_size=64, emit_epsilon=False))
        check((s.jacobi, s.B, s.jacobi_layout) == (2, 64, "row"),
              f"[22] M=1500 auto plan {(s.jacobi, s.B, s.jacobi_layout)}")
        row_main_paths(torch, bt, s, "[22]", f"{kind}-m1500-row", tmp,
                       (single, solve, fused), 141)
        del s

    # ---- 22. recovery through the row sweep: the phase 3 and 6 recipes
    # (N=4096, M=2048, block_size 256) at jacobi_blocks=4
    for kind in kinds:
        gr = torch.Generator(device=dev).manual_seed(13)
        beta_true = recovery_signal(torch, gr, 2048)
        if kind == "bayesr":
            cfg, rchain = bt.BayesRConfig(block_size=256), (100, 60, 1)
        else:
            A = (1.0 / 4096 ** 0.5) * 32 / (2048 - 32)
            cfg = bt.HorseshoeConfig(A=A, block_size=256)
            rchain = HS_RECOVERY_CHAIN
        sr = packed_sampler(torch, bt, gr, 4096, 2048, cfg, signal=beta_true,
                            jacobi_blocks=4)
        check((sr.jacobi, sr.B, sr.jacobi_layout) == (4, 256, "row"),
              "[22] row recovery plan")
        t0 = time.perf_counter()
        _, out = sr.run(gr, bt.ChainConfig(*rchain))
        corr = posterior_corr(torch, out, beta_true)
        log(f"[22] {kind} row-layout recovery corr {corr:.4f} over {rchain}"
            f" ({(time.perf_counter() - t0) / rchain[0] * 1e3:.2f} ms/iter)")
        check(corr > 0.8, f"[22] {kind} row recovery corr {corr}")

    tpu = "bayesrrcpp_tpu/ops/pallas_jacobi.py"
    src = "bayesrrcpp_tpu_torch/csrc/serial.cu"
    names = {"bayesr": ("bayesr_row_sweep", f"{tpu}:1299"),
             "horseshoe": ("horseshoe_row_sweep", f"{tpu}:1153"),
             "bayesr_solve": ("bayesr_round_solve", f"{tpu}:704"),
             "horseshoe_solve": ("horseshoe_round_solve", f"{tpu}:833"),
             "bayesr_dense": ("bayesr_row_sweep_dense", f"{tpu}:1299"),
             "horseshoe_dense": ("horseshoe_row_sweep_dense", f"{tpu}:1153")}
    return [dict({"name": name, "route": "cuda", "source": src,
                  "replaces": where}, **records[key])
            for key, (name, where) in names.items()]


# ---------------------------------------------------------------- phase 23

# the Dm = 2 check on one card (23d): N x M words, each of the two slices
# 8,192 markers (the "t" plan J=32, B=32, nr=8), 3 steps
DM2_N, DM2_M, DM2_STEPS = 4096, 16_384, 3


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def in_turn(fn, args, kw, size):
    """The rounds ``args[6]`` of a sweep through ``fn`` (a rounds entry
    point) in chunks of ``size``, one after the other, eps, beta and labels
    handed on: the last chunk's result with v and bacc summed."""
    a, rho = list(args), args[6]
    v = bacc = 0
    for c0 in range(0, rho.numel(), size):
        a[6] = rho[c0:c0 + size]
        res = fn(*a, **kw)
        a[3], a[4], a[5] = res.eps, res.beta, res.labels
        v, bacc = v + res.v, bacc + res.beta_acum
    return res._replace(v=v, beta_acum=bacc)


def chunk_rounds(torch, s, args, kw):
    """``strided_rounds`` of a chunk of rounds: ``args[6]`` holds the chunk's
    global round ids of a sweep of ``kw["nr_total"]``; markers outside the
    chunk fall past its last round."""
    rho = args[6].long()
    nrc, B, J, nr = rho.numel(), s.B, kw["J"], kw["nr_total"]
    round_of_slab = torch.full((nr,), nrc, dtype=torch.long,
                               device=rho.device)
    round_of_slab[rho] = torch.arange(nrc, device=rho.device)
    marker = torch.arange(args[4].shape[-1], device=rho.device)

    def blocks(r):
        slab = int(rho[r])
        return [(j * nr + slab, (slab * J + j) * B) for j in range(J)]

    return round_of_slab[marker // B % nr], nrc, blocks


def headline_plain_rounds(jt, args, kw, nr, kind, C, whole):
    """The plain comparison of a strided sweep at the headline (2b, 8b,
    13b): BayesR's first ``HEADLINE_PLAIN_ROUNDS`` rounds through #5 / #6
    (the sweep's kernel with a round count; one chain, or ``C`` fused) and
    their plain versions, as (operands, keywords, (kernel, plain)); the
    horseshoe's whole sweep through ``whole`` (its plain step is cheap)."""
    if kind != "bayesr":
        return args, kw, whole
    a = list(args)
    a[6] = args[6][:HEADLINE_PLAIN_ROUNDS]
    return a, dict(kw, nr_total=nr), rounds_fns(jt, C)[:2]


def whole_in_chunks(torch, tag, pfns, args, pkw, ker):
    """The headline's timed whole sweep ``ker`` (eps, beta and labels first)
    bitwise equal to all of its rounds run in turn through ``pfns[0]`` (#5
    / #6) in chunks of ``HEADLINE_PLAIN_ROUNDS``, the first of which is the
    chunk held against the plain version: so ``ms`` and ``plain_ms`` /
    ``max_abs_err`` speak of the same kernel (23a holds the two at every
    chunk size on a smaller shape)."""
    turn = in_turn(pfns[0], args, pkw, HEADLINE_PLAIN_ROUNDS)
    for i, name in enumerate(("eps", "beta", "labels")):
        a, b = getattr(turn, name), ker[i]
        check(torch.equal(a, b), f"{tag} {name}: the whole sweep differs "
              f"from its chunks of {HEADLINE_PLAIN_ROUNDS} rounds: max |d| "
              f"{float((a.float() - b.float()).abs().max())}")
    del turn


def rounds_fns(jt, C):
    """(the rounds kernel, its plain version, the whole-sweep kernel) of
    one chain (``C`` None) or of fused chains."""
    if C is None:
        return (jt.bayesr_jacobi_t_rounds, jt.bayesr_jacobi_t_rounds_reference,
                jt.bayesr_jacobi_t)
    return (jt.bayesr_jacobi_t_mc_rounds,
            jt.bayesr_jacobi_t_mc_rounds_reference, jt.bayesr_jacobi_t_mc)


def rounds_gates(torch, tag, ker, ref):
    """A chunk's kernel against its plain version: labels and v equal, eps
    and beta to 1e-4 of their norms (phases 2a and 17a).  Returns the
    largest |d| of eps and beta."""
    check(torch.equal(ker.labels, ref.labels), f"{tag} labels differ")
    check(torch.equal(ker.v, ref.v), f"{tag} v differ")
    for name in ("eps", "beta"):
        rel = rel_err(getattr(ker, name), getattr(ref, name))
        check(rel < 1e-4, f"{tag} {name} rel diff {rel}")
    return max(float((ker.eps - ref.eps).abs().max()),
               float((ker.beta - ref.beta).abs().max()))


def same_bits(torch, tag, a, b, names=("eps", "beta", "labels", "v",
                                         "beta_acum")):
    for name in names:
        check(torch.equal(getattr(a, name), getattr(b, name)),
              f"{tag} {name} not bitwise equal: max |d| "
              f"{float((getattr(a, name) - getattr(b, name)).abs().max())}")


def rounds_small(torch, bt, jt):
    """23a at N=4096 x M=8192 (2-bit fold and ``miss``) and N=4001 x M=8192
    (dense rows), plan J=32, B=32, nr=8: #5 and #6 (C=8) against their
    plain versions for chunks of 1, 3 and 8 rounds; the chunk of every
    round bitwise equal to ``bayesr_jacobi_t`` / ``_mc``; chunks of 3, 3
    and 2 run in turn bitwise equal to the whole sweep in eps, beta and
    labels (v equal, bacc to 1e-6 of itself: each chunk sums its own
    blocks); each fused chain of a chunk bitwise equal to #5 on its
    operands."""
    dev = torch.device("cuda")
    worst = 0.0
    for i, mode in enumerate(("fold", "miss", "dense")):
        g = torch.Generator(device=dev).manual_seed(230 + i)
        if mode == "dense":
            s = dense_sampler(torch, bt, g, 4001, 8192, bt.BayesRConfig())
        else:
            s = packed_sampler(torch, bt, g, 4096, 8192, bt.BayesRConfig(),
                               missing=mode == "miss")
        check((s.jacobi, s.B, s.jacobi_layout) == (32, 32, "t")
              and s.data.has_missing == (mode == "miss"),
              f"[23a] {mode} plan {(s.jacobi, s.B, s.jacobi_layout)}")
        nr = s.nb // s.jacobi
        for C in (None, CHAINS):
            v = bt.TorchVariates(g, chains=C)
            st = s.init(v, chains=C)
            for _ in range(3):
                st = s.step(st, v) if C is None else s.step_chains(st, v)
            args, kw = sweep_args(s, st, v)
            rkw = dict(kw, nr_total=nr)
            rounds, plain, whole = rounds_fns(jt, C)
            tag = f"[23a] {mode} C={C or 1}"
            for nrc in (1, 3, nr):
                a = list(args)
                a[6] = args[6][:nrc]
                worst = max(worst, rounds_gates(
                    torch, f"{tag} nrc={nrc}", rounds(*a, **rkw),
                    plain(*a, **rkw)))
            full = whole(*args, **kw)
            same_bits(torch, f"{tag} nrc=nr vs the whole-sweep kernel",
                      rounds(*args, **rkw), full)
            turn = in_turn(rounds, args, rkw, 3)
            same_bits(torch, f"{tag} chunks in turn vs the whole sweep", turn,
                      full, ("eps", "beta", "labels", "v"))
            check(torch.allclose(turn.beta_acum, full.beta_acum, rtol=1e-6,
                                 atol=0.0), f"{tag} chunks in turn: bacc")
            if C is not None:
                a = list(args)
                a[6] = args[6][:3]
                fused = rounds(*a, **rkw)
                for c in range(C):
                    one = jt.bayesr_jacobi_t_rounds(
                        *chain_args(a, c, BAYESR_CHAIN_ARGS), **rkw)
                    same_bits(torch, f"{tag} chain {c} vs #5",
                              one, type(one)(*(x[c] for x in fused)))
        log(f"[23a] {mode} N={s.N} M={s.M} (nr={nr}): #5 and #6 (C={CHAINS}) "
            f"vs plain for 1, 3, {nr} rounds: labels and v equal; nrc=nr and "
            f"chunks of 3 in turn bitwise equal to the whole sweep; fused "
            f"chains bitwise equal to #5")
        del s, st, args
    return worst


def sharded_sampler(torch, bt, hs, mesh):
    """``biobank-sharded-m1``'s sampler: the headline words of ``hs`` (phase
    2's) on the (1, 1) mesh ``mesh``, ``transposed=True, has_missing=False``
    as bench.py:224-227; returns (sampler, setup seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh = bt.ShardedSpikeSlabSampler(
        hs.data.XT, hs.Y[:hs.N], CVA, bt.BayesRConfig(emit_epsilon=False),
        mesh, backend="pallas", x_dtype="2bit", transposed=True,
        x_stats=bt.simulate.packed_word_stats(HEADLINE_M), has_missing=False)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check((sh.jacobi, sh.B, sh.Mpad, sh.Mloc, sh.strided) ==
          (128, 32, HEADLINE_M, HEADLINE_M, True),
          f"[23b] plan {(sh.jacobi, sh.B, sh.Mpad, sh.Mloc)}")
    check(sh._nrc(sh.nb // sh.jacobi) == sh.nb // sh.jacobi,
          "[23b] Dm = 1 sweeps in one chunk")
    return sh, setup_s


def rounds_headline(torch, bt, jt, sh):
    """23a at the headline on the sharded sampler's data (phase 2's words):
    #5 and #6 (C=8) over all 123 rounds timed (mean of 3) and bitwise equal
    to #1 / #3, timed on the same inputs; their first 8 rounds as chunks of
    2 in turn against the
    plain version of those rounds, chain by chain under phase 13b's gates
    (``held_per_chain``: a flip replayed by ``flip_replay`` and judged a
    near tie).  Returns the two kernels' JSON numbers but launches."""
    dev = torch.device("cuda")
    d = sh.data
    nr = sh.nb // sh.jacobi
    records = {}
    for C in (None, CHAINS):
        g = torch.Generator(device=dev).manual_seed(233)
        v = bt.TorchVariates(g, chains=C)
        st = sh.init(v, chains=C)
        for _ in range(2):
            st = sh.step(st, v) if C is None else sh.step_chains(st, v)
        rho, inner = v.orders(sh.nb, sh.B, sh.jacobi)
        args = (d.XT, d.gram, d.xsq, st.eps, st.beta, st.labels, rho, inner,
                v.p(sh.Mloc), v.z(sh.Mloc), st.pi, d.cva, st.sigmaE,
                st.sigmaGG, d.g_assign, d.valid)
        kw = dict(J=sh.jacobi, **sh._sweep_kw())
        rkw = dict(kw, nr_total=nr)
        rounds, plain, whole = rounds_fns(jt, C)
        tag = f"[23a] headline C={C or 1}"
        full, ms = timed(torch, lambda: rounds(*args, **rkw), 3)
        ones, whole_ms = timed(torch, lambda: whole(*args, **kw), 3)
        same_bits(torch, f"{tag} nrc=nr vs the whole-sweep kernel", full,
                  ones)
        a8 = list(args)
        a8[6] = rho[:8]
        ker = in_turn(rounds, a8, rkw, 2)
        ref, plain_ms = timed(torch, lambda: plain(*a8, **rkw), 1)
        agree = float((ker.labels == ref.labels).float().mean())
        check(agree >= 0.999, f"{tag} label agreement {agree}")
        single = (lambda *a, **k: in_turn(jt.bayesr_jacobi_t_rounds, a, k,
                                          2),
                  jt.bayesr_jacobi_t_rounds_reference)
        flips = held_per_chain(torch, sh, tag, a8, rkw, ker, ref,
                               None if C is None else BAYESR_CHAIN_ARGS,
                               single, chunk_rounds)
        max_err = max(float((ker.eps - ref.eps).abs().max()),
                      float((ker.beta - ref.beta).abs().max()))
        moved = int((full.beta != st.beta).sum())
        bound_ms, bound_by = sweep_bound(sh, C or 1, moved, 6)
        lib_ms = dot_yardstick(torch, sh, round_rows(torch, sh, rho[0]),
                               st.eps) * nr
        log(f"{tag}: all {nr} rounds {ms:.3f} ms, bitwise equal to the "
            f"whole-sweep kernel on the same inputs, {whole_ms:.3f} ms "
            f"({ms / whole_ms:.4f}x); bound {bound_ms:.3f} ms ({bound_by}, "
            f"{moved} markers moved), dot yardstick {lib_ms:.3f} ms; 8 "
            f"rounds as chunks of 2 vs plain ({plain_ms:.1f} ms): label "
            f"agreement {agree:.6f}, |d eps|/|eps| "
            f"{rel_err(ker.eps, ref.eps):.3g}, max abs err {max_err:.3g}, "
            f"chains with a flip {[c for c, _ in flips]}")
        records[C] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                          plain_rounds=8, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib_ms)
        del st, args, a8, full, ker, ref
    return records


def sharded_main_paths(torch, bt, jt, sh, setup_s, tmp, ms_iter_4,
                       ms_iter_8c):
    """23b / 23c: ``biobank-sharded-m1`` through ``run`` (ChainConfig(30, 10,
    10)) into a CSVSink and ``run_chains`` of 8 into a ChainFanoutSink,
    the rounds kernels' counts set to 0 just before each; CSV widths,
    finite values, tracked vs recomputed eps, launch counts; ms/iter
    against phase 4's and 8c's from this run; a profile of 2 steps (dot /
    solve / apply / the NCCL all-reduce, idle).  Returns the launches of
    #5 and #6."""
    from bayesrrcpp_tpu_torch.io.sink import ChainFanoutSink, CSVSink

    nr = sh.nb // sh.jacobi
    chain = bt.ChainConfig(30, 10, 10)
    launches = {}
    for C, counter in ((None, jt.bayesr_jacobi_t_rounds),
                       (CHAINS, jt.bayesr_jacobi_t_mc_rounds)):
        g = torch.Generator(device="cuda").manual_seed(234)
        ph = "23b" if C is None else "23c"
        other = jt.bayesr_jacobi_t if C is None else jt.bayesr_jacobi_t_mc
        other.launches = 0
        if C is None:
            path = os.path.join(tmp, "sharded_m1.csv")
            sink = CSVSink(path, "bayesr", M=sh.M, N=sh.N, emit_epsilon=False)
            run = lambda sk: sh.run(g, chain, sink=sk)  # noqa: E731
            paths = [path]
        else:
            sink = ChainFanoutSink.csv(os.path.join(tmp, "sharded_m1_8.csv"),
                                       C, "bayesr", M=sh.M, N=sh.N,
                                       emit_epsilon=False)
            run = lambda sk: sh.run_chains(g, C, chain,  # noqa: E731
                                           sink=sk)
            paths = sink.paths
        st, out, wall, n_launch, peak = main_path(torch, run, sink, counter)
        want = jt.LAUNCHES_PER_ROUND * nr * chain.max_iterations
        check(n_launch == want, f"[{ph}] launches {n_launch} != {want}")
        check(other.launches == 0, f"[{ph}] the whole-sweep kernel ran")
        for p in paths:
            header, widths, bad = read_csv(p)
            check(len(header) == 2 + 2 * sh.M + 2,
                  f"[{ph}] header width {len(header)}")
            check(widths == [len(header)] * 2 and not bad,
                  f"[{ph}] rows {widths}, non-finite {bad}")
        check(all(np_finite(x) for x in out.values()),
              f"[{ph}] non-finite output")
        ex = sh.refresh_eps(st).eps
        rel = float((torch.linalg.norm(st.eps - ex, dim=-1)
                     / torch.linalg.norm(ex, dim=-1)).max())
        check(rel < 1e-4, f"[{ph}] tracked eps vs recompute {rel}")
        ms_iter = wall / chain.max_iterations * 1e3
        ref = ms_iter_4 if C is None else ms_iter_8c
        cell = "biobank-sharded-m1" + ("" if C is None else f"-{C}chain")
        log(f"[{ph}] {cell} main path: {ms_iter:.2f} ms/iter ({wall:.2f} s "
            f"for {chain.max_iterations} iterations incl. CSV), setup "
            f"{setup_s:.2f} s, peak {peak:.2f} GiB, launches {n_launch} "
            f"(want {want}, {n_launch // chain.max_iterations} a step), "
            f"tracked-vs-exact eps {rel:.3g}; against phase "
            f"{'4' if C is None else '8c'}'s {ref:.2f} ms/iter: "
            f"{ms_iter / ref:.4f}x")
        names = (("dot_kernel", "solve_kernel", "apply_kernel")
                 if C is None else ("dot_mc_kernel", "solve_mc_kernel",
                                    "apply_mc_kernel"))
        vv = sh.variates(g, C)

        window = Steps(sh, st, vv)
        split, dev_ms, wall_ms = profile_split(torch, window,
                                               names + ("nccl",),
                                               want=2 * nr, counted=names)
        check(profiled({n: split[n] for n in names}, 2 * nr),
              f"[{ph}] profiled launches {split}")
        log(f"[{ph}] profile of 2 steps: " + ", ".join(
            f"{n} {us:.2f} us x {c}" for n, (us, c) in split.items())
            + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall, idle "
            f"{1 - dev_ms / wall_ms:.3f}")
        packed_report(torch, f"[{ph}] {cell}", split, names, sh, C or 1,
                      window)
        launches[C] = n_launch
        del st, out
    return launches


def dm2_child(rank, port, out_path):
    """One rank of 23d: a gloo group of two processes on the one card (NCCL
    takes no two ranks on one device); every result or the error pickled
    to ``out_path``."""
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bayesrrcpp_tpu_torch as bt
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
    from bayesrrcpp_tpu_torch.parallel.distributed import initialize

    res = {}
    try:
        initialize(f"tcp://127.0.0.1:{port}", 2, rank, backend="gloo")
        mesh = bt.make_mesh(2, 1, device="cuda:0")
        g = torch.Generator(device="cuda").manual_seed(23)
        words = bt.simulate.random_packed_words(g, DM2_M, DM2_N // 16,
                                                device="cuda")
        Y = torch.randn(DM2_N, generator=g, device="cuda")
        stats = bt.simulate.packed_word_stats(DM2_M)
        for chunk in (None, 32):
            s = bt.ShardedSpikeSlabSampler(
                words, Y, CVA, bt.BayesRConfig(), mesh, backend="pallas",
                x_dtype="2bit", transposed=True, x_stats=stats,
                chunk_blocks=chunk)
            nr = s.nb // s.jacobi
            nrc = s._nrc(nr)
            res[chunk, "plan"] = (s.jacobi, s.B, s.Mloc, nr, nrc)
            for C in (None, 4):
                gen = torch.Generator(device="cuda").manual_seed(7)
                v = s.variates(gen, C)
                st = s.init(v, chains=C)
                # the first chunk call against its plain version
                lv = v.loc
                rho, inner = lv.orders(s.nb, s.B, s.jacobi)
                d = s.data
                args = (d.XT, d.gram, d.xsq, st.eps, st.beta, st.labels,
                        rho[:nrc], inner, lv.p(s.Mloc), lv.z(s.Mloc), st.pi,
                        d.cva, st.sigmaE, st.sigmaGG, d.g_assign, d.valid)
                rounds, plain, _ = rounds_fns(jt, C)
                rkw = dict(J=s.jacobi, nr_total=nr, **s._sweep_kw())
                res[chunk, C, "max_err"] = rounds_gates(
                    torch, f"[23d] rank {rank} chunk {chunk} C={C or 1}",
                    rounds(*args, **rkw), plain(*args, **rkw))
                rounds.launches = 0
                steps = []
                for _ in range(DM2_STEPS):
                    st = s.step(st, v) if C is None else s.step_chains(st, v)
                    steps.append({k: getattr(st, k).cpu().numpy() for k in
                                  ("mu", "sigmaE", "sigmaGG", "pi", "eps")})
                ex = s.refresh_eps(st).eps
                res[chunk, C, "rel_eps"] = rel_err(st.eps, ex)
                res[chunk, C, "steps"] = steps
                res[chunk, C, "launches"] = rounds.launches
        dist.barrier()
    except Exception as e:  # noqa: BLE001 -- handed to the parent, which fails
        res = {"error": f"rank {rank}: {e!r}\n{traceback.format_exc()}"}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def dm2_phase(torch, tmp):
    """23d: Dm = 2 on the one card, two spawned ranks of a gloo group over
    CUDA tensors, N=4096 x M=16,384 words, chunk_blocks
    128 (2 chunks of 4 rounds) and 32 (8 chunks of 1), one chain and C=4,
    3 steps: the replicated scalars and eps bitwise equal on both ranks
    after every step, tracked eps against ``refresh_eps`` < 1e-4, each
    rank's first chunk call against its plain version, the launch counts.
    A failure in a child fails the run."""
    import multiprocessing as mp
    import pickle

    import numpy as np

    from bayesrrcpp_tpu_torch.ops.jacobi_t import LAUNCHES_PER_ROUND

    port = free_port()
    outs = [os.path.join(tmp, f"dm2_rank{r}.pkl") for r in range(2)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dm2_child, args=(r, port, outs[r]))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    ranks = []
    for r, path in enumerate(outs):
        check(os.path.exists(path), f"[23d] rank {r} wrote no result (exit "
              f"code {procs[r].exitcode})")
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
        check("error" not in ranks[r], ranks[r].get("error", ""))
    a, b = ranks
    log(f"[23d] two ranks on one card, gloo all-reducing their CUDA "
        f"tensors ({wall:.1f} s with start-up)")
    for chunk in (None, 32):
        J, B, Mloc, nr, nrc = a[chunk, "plan"]
        check(a[chunk, "plan"] == b[chunk, "plan"] and (J, B, Mloc) ==
              (32, 32, DM2_M // 2) and nrc < nr,
              f"[23d] plan {a[chunk, 'plan']} / {b[chunk, 'plan']}")
        for C in (None, 4):
            for i, (x, y) in enumerate(zip(a[chunk, C, "steps"],
                                           b[chunk, C, "steps"])):
                for k in x:
                    check(np.array_equal(x[k], y[k]),
                          f"[23d] chunk_blocks {chunk} C={C or 1} step {i}: "
                          f"{k} differs between the ranks")
            rels = [r[chunk, C, "rel_eps"] for r in ranks]
            check(max(rels) < 1e-4, f"[23d] tracked eps vs recompute {rels}")
            want = LAUNCHES_PER_ROUND * nr * DM2_STEPS
            got = [r[chunk, C, "launches"] for r in ranks]
            check(got == [want, want], f"[23d] launches {got} != {want}")
            log(f"[23d] chunk_blocks {chunk or 128} ({nr // nrc} chunks of "
                f"{nrc} rounds), C={C or 1}: scalars and eps bitwise equal "
                f"on both ranks after each of {DM2_STEPS} steps, tracked vs "
                f"recomputed eps {max(rels):.3g}, launches {got}; first "
                f"chunk vs plain max |d| "
                + ", ".join(f"{r[chunk, C, 'max_err']:.3g}" for r in ranks))


def sharded_phases(torch, bt, hs, tmp, ms_iter_4, ms_iter_8c):
    """Phase 23 (module docstring): the chunked sweeps #5 and #6 and the
    marker-sharded driver, on a real one-rank NCCL group for Dm = 1 (the
    collectives are launched) and on two gloo ranks for Dm = 2.  Returns
    the two kernels' JSON records."""
    import torch.distributed as dist

    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
    from bayesrrcpp_tpu_torch.parallel.distributed import initialize

    worst_small = rounds_small(torch, bt, jt)
    log(f"[23a] N=4096/4001 x M=8192: max |d| vs plain {worst_small:.3g}")
    initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = bt.make_mesh(1, 1, device="cuda:0")
        check(mesh.group is not None, "[23b] no process group")
        sh, setup_s = sharded_sampler(torch, bt, hs, mesh)
        check(sh.data.XT.data_ptr() == hs.data.XT.data_ptr(),
              "[23b] words copied")
        launches = sharded_main_paths(torch, bt, jt, sh, setup_s, tmp,
                                      ms_iter_4, ms_iter_8c)
        records = rounds_headline(torch, bt, jt, sh)
        del sh
    finally:
        dist.destroy_process_group()
    dm2_phase(torch, tmp)
    tpu = "bayesrrcpp_tpu/ops/pallas_jacobi_t.py"
    out = []
    for C, name, src, where in (
            (None, "jacobi_t_rounds", "jacobi_t.cu", 2229),
            (CHAINS, "jacobi_t_mc_rounds", "jacobi_t_mc.cu", 2403)):
        out.append(dict({"name": name, "route": "cuda",
                         "source": f"bayesrrcpp_tpu_torch/csrc/{src}",
                         "replaces": f"{tpu}:{where}",
                         "launches": launches[C]}, **records[C]))
    return out


# ---------------------------------------------------------------- phase 24

INT8_PLAIN_ROUNDS = 8     # rounds of an int8 strided plain sweep held at
#                           the headline (24c)


def int8_codes(torch, words, N, rows=2048):
    """(M, N) int8 codes of the 2-bit ``words`` (M, Npad/16), decoded in
    chunks of rows.  The port's words hold individual 16w + k at bits 2k
    of word w (no lane permutation), so the codes come out in individual
    order: int8 and 2-bit storage hold the same dosages."""
    from bayesrrcpp_tpu_torch.ops.genotypes import decode_codes

    M = words.shape[0]
    out = torch.empty((M, N), dtype=torch.int8, device=words.device)
    for a in range(0, M, rows):
        b = min(M, a + rows)
        out[a:b] = decode_codes(words[a:b])[:, :N]
    return out


def int8_sampler(torch, bt, g, N, M, cfg, missing=False, codes=None, Y=None,
                 **plan):
    """A sampler on int8 codes (M, N) on the card (``x_dtype="int8"``,
    ``transposed=True``, ``x_stats`` those of the codes' distribution):
    ``codes`` as given, or the decoded codes of random words from ``g``
    (P = 1/4, 1/4, 1/2 and, with ``missing``, code 3 at 2^-6); Y from
    ``g`` unless given."""
    if codes is None:
        make = (bt.simulate.random_packed_words_missing if missing
                else bt.simulate.random_packed_words)
        codes = int8_codes(torch, make(g, M, -(-N // 16), device="cuda"), N)
    if Y is None:
        Y = torch.randn(N, generator=g, device="cuda")
    kw = dict(transposed=True, x_dtype="int8",
              x_stats=bt.simulate.packed_word_stats(M), device="cuda",
              **plan)
    if isinstance(cfg, bt.HorseshoeConfig):
        return bt.HorseshoeSampler(codes, Y, cfg, **kw)
    return bt.SpikeSlabSampler(codes, Y, CVA, cfg, **kw)


def int8_bound(s, chains, moved, marker_arrays, moved_rows, gram_rows=None,
               decode=False):
    """(bound_ms, bound_by) of one int8 sweep of ``chains`` chains on
    sampler ``s``'s codes, by ``tools/kernel_bounds.int8_sweep``: ``moved``
    rows applied (summed over chains), ``moved_rows`` rows moved in any
    chain (read again by the apply), the Gram blocks or ``gram_rows`` rows
    of them; ``decode`` the in-kernel decode."""
    from bayesrrcpp_tpu_torch.tools import kernel_bounds

    gram = s.data.gram.numel() if gram_rows is None else gram_rows * s.B
    b = kernel_bounds.int8_sweep(s.N, s.Mpad, gram, chains, marker_arrays,
                                 moved, moved_rows, decode)
    return b["bound_ms"], b["bound_by"]


def moved_of(beta_out, beta_in):
    """(rows moved summed over chains, rows moved in any chain)."""
    moved = beta_out != beta_in
    any_chain = moved if moved.dim() == 1 else moved.any(dim=0)
    return int(moved.sum()), int(any_chain.sum())


def int8_layouts(jt, jr, ser, mcs):
    """layout -> (plan keywords, missing calls, kind -> (single, plain,
    fused, fused plain, operands, outputs)) of phase 24a."""
    bn = ("eps", "beta", "labels", "v", "beta_acum")
    hn = ("eps", "beta")
    return {
        "strided": (dict(), False, {
            "bayesr": (jt.bayesr_jacobi_t, jt.bayesr_jacobi_t_reference,
                       jt.bayesr_jacobi_t_mc, jt.bayesr_jacobi_t_mc_reference,
                       sweep_args, bn),
            "horseshoe": (jt.horseshoe_jacobi_t,
                          jt.horseshoe_jacobi_t_reference,
                          jt.horseshoe_jacobi_t_mc,
                          jt.horseshoe_jacobi_t_mc_reference, hs_sweep_args,
                          hn)}),
        "serial": (dict(jacobi_blocks=1), False, {
            "bayesr": (ser.bayesr_sweep, ser.bayesr_sweep_reference,
                       mcs.bayesr_sweep_mc, mcs.bayesr_sweep_mc_reference,
                       serial_args, bn),
            "horseshoe": (ser.horseshoe_sweep, ser.horseshoe_sweep_reference,
                          mcs.horseshoe_sweep_mc,
                          mcs.horseshoe_sweep_mc_reference, hs_serial_args,
                          hn)}),
        "row": (dict(jacobi_blocks=8, jacobi_layout="row"), False, {
            "bayesr": (jr.bayesr_jacobi, jr.bayesr_jacobi_reference, None,
                       None, row_args, bn),
            "horseshoe": (jr.horseshoe_jacobi, jr.horseshoe_jacobi_reference,
                          None, None, hs_row_args, hn)}),
        "q": (dict(jacobi_blocks=1), True, {
            "bayesr": (ser.bayesr_sweep, ser.bayesr_sweep_reference, None,
                       None, serial_args, bn),
            "horseshoe": (ser.horseshoe_sweep, ser.horseshoe_sweep_reference,
                          None, None, hs_serial_args, hn)})}


def int8_small(torch, bt, jt, layouts):
    """24a: every int8 entry point against its plain version at N=4096 x
    M=8192 (vector loads) and N=4001 (byte loads), M=2048 for the serial,
    row and ``_q`` sweeps (their plain versions step marker by marker),
    one sweep from a
    warm state: the strided kernels (plan J=32, B=32; #1-#4, #7, #8) one chain
    and C=8 fused, their chunks of rounds (#5, #6: 3 rounds against the
    plain version, every round bitwise the whole sweep), the serial fold
    (B=512; #9-#12) one chain and C=8 fused, the row sweep (J=8, B=128;
    #15, #16) and the serial in-kernel decode on codes with missing calls
    (B=512; #9, #10 ``_q``): labels and v equal, the floats as phase 10
    (``check_sweeps``), each fused chain bitwise equal to the single-chain
    kernel.  Returns the largest |d| against plain."""
    dev = torch.device("cuda")
    worst = 0.0
    for N in (4096, 4001):
        for layout, (plan, missing, kinds) in layouts.items():
            B = {"strided": 512, "serial": 512, "row": 128, "q": 512}[layout]
            for kind, (single, plain, fused, fused_plain, make_args,
                       names) in kinds.items():
                cfg = (bt.HorseshoeConfig if kind == "horseshoe"
                       else bt.BayesRConfig)(block_size=B)
                g = torch.Generator(device=dev).manual_seed(240 + N % 7)
                v = bt.TorchVariates(g)
                # the plain serial, row and _q sweeps' host loop takes a step
                # a marker: they run 4 blocks of 512 (16 of 128), not 16
                M = 8192 if layout == "strided" else 2048
                s = int8_sampler(torch, bt, g, N, M, cfg, missing, **plan)
                want = {"strided": (32, 32, "t"), "serial": (1, 512, "row"),
                        "row": (8, 128, "row"), "q": (1, 512, "row")}[layout]
                check((s.jacobi, s.B, s.jacobi_layout) == want
                      and s.data.has_missing == missing
                      and s.data.XT.dtype == torch.int8,
                      f"[24a] {layout} plan "
                      f"{(s.jacobi, s.B, s.jacobi_layout)}")
                st = s._run_steps(s.init(v), v, 3)
                cut = ((SMALL_SERIAL_BLOCKS,) if layout in ("serial", "q")
                       else ())
                args, kw = make_args(s, st, v, *cut)
                check(kw["fold_affine"] is not missing
                      and "row_valid" not in kw,
                      f"[24a] {layout} mode {kw.keys()}")
                tag = f"[24a] N={N} {kind} {layout}"
                ker = tuple(single(*args, **kw))
                worst = max(worst, check_sweeps(torch, tag, names, ker,
                                                tuple(plain(*args, **kw))))
                if layout == "strided" and kind == "bayesr":
                    nr = s.nb // s.jacobi
                    rkw = dict(kw, nr_total=nr)
                    a3 = list(args)
                    a3[6] = args[6][:3]
                    worst = max(worst, rounds_gates(
                        torch, f"{tag} #5 3 rounds",
                        jt.bayesr_jacobi_t_rounds(*a3, **rkw),
                        jt.bayesr_jacobi_t_rounds_reference(*a3, **rkw)))
                    same_bits(torch, f"{tag} #5 every round vs #1",
                              jt.bayesr_jacobi_t_rounds(*args, **rkw),
                              jt.SweepResult(*ker))
                if fused is None:
                    del s, st, args, ker
                    continue
                v8 = bt.TorchVariates(g, chains=CHAINS)
                st8 = s.init(v8, chains=CHAINS)
                for _ in range(3):
                    st8 = s.step_chains(st8, v8)
                args, kw = make_args(s, st8, v8, *cut)
                fk = tuple(fused(*args, **kw))
                worst = max(worst, check_sweeps(
                    torch, f"{tag} fused", names, fk,
                    tuple(fused_plain(*args, **kw))))
                for c in range(CHAINS):
                    one = (chain_args(args, c, BAYESR_CHAIN_ARGS
                                      if kind == "bayesr" else HS_CHAIN_ARGS)
                           if layout == "strided"
                           else single_chains(torch, args, kind, c))
                    for name, a, b in zip(names, single(*one, **kw), fk):
                        check(torch.equal(a, b[c]),
                              f"{tag} chain {c} {name} differs from the "
                              f"single-chain int8 kernel")
                if layout == "strided" and kind == "bayesr":
                    rkw = dict(kw, nr_total=s.nb // s.jacobi)
                    a3 = list(args)
                    a3[6] = args[6][:3]
                    worst = max(worst, rounds_gates(
                        torch, f"{tag} #6 3 rounds",
                        jt.bayesr_jacobi_t_mc_rounds(*a3, **rkw),
                        jt.bayesr_jacobi_t_mc_rounds_reference(*a3, **rkw)))
                    same_bits(torch, f"{tag} #6 every round vs #3",
                              jt.bayesr_jacobi_t_mc_rounds(*args, **rkw),
                              jt.MCSweepResult(*fk))
                del s, st, st8, args, ker, fk
        log(f"[24a] N={N} x M=8192 (serial, row and _q: M=2048): every "
            f"int8 kernel against its plain "
            f"version (labels and v equal), fused chains bitwise equal to "
            f"the single-chain kernel, #5/#6 over every round bitwise #1/#3")
    return worst


def int8_vs_packed(torch, bt, hs, strided):
    """24b: the int8 strided kernels against the 2-bit fold kernels on the
    same dosages, phase 2's first 8,192 markers (the words of ``hs`` and
    their decoded codes), BayesR and the horseshoe, one sweep from a warm
    state: the horseshoe's eps and beta to 1e-4 of their norms, BayesR
    chain by chain as phase 17b (a flip replayed and judged a near tie)."""
    dev = torch.device("cuda")
    Mb = 8192
    xs = bt.simulate.packed_word_stats(HEADLINE_M)
    stats = (xs[0][:Mb], xs[1][:Mb])
    codes = int8_codes(torch, hs.data.XT[:Mb], hs.N)
    for kind in ("bayesr", "horseshoe"):
        hsk = kind == "horseshoe"
        cfg = bt.HorseshoeConfig() if hsk else bt.BayesRConfig()
        make = bt.HorseshoeSampler if hsk else bt.SpikeSlabSampler
        pre = () if hsk else (CVA,)
        sq = make(hs.data.XT[:Mb], hs.Y[:hs.N], *pre, cfg, transposed=True,
                  x_dtype="2bit", x_stats=stats, device="cuda")
        s8 = make(codes, hs.Y[:hs.N], *pre, cfg, transposed=True,
                  x_dtype="int8", x_stats=stats, device="cuda")
        check((s8.jacobi, s8.B, s8.nb, s8.Npad) ==
              (sq.jacobi, sq.B, sq.nb, sq.Npad) and sq.Npad == sq.N,
              "[24b] plans")
        single, make_args = strided[kind][0], strided[kind][4]
        g = torch.Generator(device=dev).manual_seed(245)
        v = bt.TorchVariates(g)
        st = sq._run_steps(sq.init(v), v, 2)
        args_q, kw_q = make_args(sq, st, v)
        d = s8.data
        kw_8 = dict(J=s8.jacobi, **s8._sweep_kw())

        def int8_sweep(*a, **k):
            return single(d.XT, d.gram, d.xsq, *a[3:], **kw_8)

        ker = tuple(int8_sweep(*args_q, **kw_q))
        ref = tuple(single(*args_q, **kw_q))
        agree, flips = dense_gates(torch, sq, f"[24b] {kind}", args_q, kw_q,
                                   ker, ref, hsk,
                                   sweeps=(int8_sweep, single))
        log(f"[24b] {kind} int8 vs 2-bit fold on phase 2's dosages (N="
            f"{sq.N}, M={Mb}, J={sq.jacobi}): label agreement {agree:.6f}, "
            f"|d eps|/|eps| {rel_err(ker[0], ref[0]):.3g}, |d beta|/|beta| "
            f"{rel_err(ker[1], ref[1]):.3g}; chains with a near-tie label "
            f"flip {flips}")
        del sq, s8, st, args_q, ker, ref
    del codes


def int8_strided_headline(torch, bt, jt, s, kind, make_args, fused, tag):
    """One strided int8 sweep at the headline on sampler ``s`` from a warm
    state (``fused``: C=8 fused chains), timed (mean of 3), and its first
    ``INT8_PLAIN_ROUNDS`` rounds held against the plain version (labels on
    >= 99.9 % of markers; eps to 1e-3 of its norm for BayesR, eps and beta
    to 1e-4 for the horseshoe, phase 5b's bounds), with its bound and the
    ``torch.matmul`` yardstick.  Returns the kernel's JSON numbers."""
    hsk = kind == "horseshoe"
    fns = {("bayesr", False): (jt.bayesr_jacobi_t, jt.bayesr_jacobi_t_rounds,
                               jt.bayesr_jacobi_t_rounds_reference),
           ("bayesr", True): (jt.bayesr_jacobi_t_mc,
                              jt.bayesr_jacobi_t_mc_rounds,
                              jt.bayesr_jacobi_t_mc_rounds_reference),
           ("horseshoe", False): (jt.horseshoe_jacobi_t, None,
                                  jt.horseshoe_jacobi_t_reference),
           ("horseshoe", True): (jt.horseshoe_jacobi_t_mc, None,
                                 jt.horseshoe_jacobi_t_mc_reference)}
    sweep, rounds, plain = fns[(kind, fused)]
    g = torch.Generator(device="cuda").manual_seed(246)
    C = CHAINS if fused else None
    v = bt.TorchVariates(g, chains=C)
    st = s.init(v, chains=C)
    for _ in range(2):
        st = s.step(st, v) if C is None else s.step_chains(st, v)
    args, kw = make_args(s, st, v)
    nr = s.nb // s.jacobi
    rho_at = 5 if hsk else 6
    ker, ms = timed(torch, lambda: tuple(sweep(*args, **kw)), 3)
    moved, moved_rows = moved_of(ker[1], args[4])
    bound = int8_bound(s, C or 1, moved, 4 if hsk else 6, moved_rows)
    lib_ms = dot_yardstick(torch, s, round_rows(torch, s, args[rho_at][0]),
                           args[3]) * nr
    # the first rounds: BayesR through the rounds entry point, the
    # horseshoe (no rounds entry) by leaving the markers of later rounds
    # invalid in both the kernel and the plain version
    a = list(args)
    if hsk:
        marker_round = strided_rounds(torch, s, (None,) * 6 + (args[5],),
                                      kw)[0]
        a[12] = args[12] & (marker_round < INT8_PLAIN_ROUNDS)
        k8 = tuple(sweep(*a, **kw))
        r8, plain_ms = timed(torch, lambda: tuple(plain(*a, **kw)), 1)
    else:
        a[6] = args[6][:INT8_PLAIN_ROUNDS]
        rkw = dict(kw, nr_total=nr)
        k8 = tuple(rounds(*a, **rkw))
        r8, plain_ms = timed(torch, lambda: tuple(plain(*a, **rkw)), 1)
    rel_eps, rel_beta = rel_err(k8[0], r8[0]), rel_err(k8[1], r8[1])
    max_err = max(float((x - y).abs().max()) for x, y in zip(k8[:2], r8[:2]))
    agree = 1.0 if hsk else float((k8[2] == r8[2]).float().mean())
    log(f"{tag} sweep at the headline: {ms:.3f} ms (mean of 3), bound "
        f"{bound[0]:.3f} ms ({bound[1]}; {moved} rows applied, {moved_rows} "
        f"moved), dot yardstick {lib_ms:.3f} ms; {INT8_PLAIN_ROUNDS} rounds "
        f"vs plain ({plain_ms:.1f} ms): label agreement {agree:.6f}, "
        f"|d eps|/|eps| {rel_eps:.3g}, |d beta|/|beta| {rel_beta:.3g}, max "
        f"abs err {max_err:.3g}")
    check(agree >= 0.999, f"{tag} label agreement {agree}")
    check(rel_eps < (1e-4 if hsk else 1e-3), f"{tag} eps rel diff {rel_eps}")
    if hsk:
        check(rel_beta < 1e-4, f"{tag} beta rel diff {rel_beta}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)


def int8_main_path(torch, bt, s, tag, cell, tmp, counter, chain, chains=None,
                   want=None):
    """A main path on int8 codes: ``run`` (or ``run_chains`` of ``chains``)
    into a CSV sink with ``counter``'s launches set to 0 just before; CSV
    widths, finite values, tracked vs recomputed eps < 1e-4 and the launch
    count (``want``, by default 3 a round).  Returns (state, launches,
    ms/iter, peak GiB)."""
    from bayesrrcpp_tpu_torch.io.sink import ChainFanoutSink, CSVSink

    kind = "horseshoe" if isinstance(s, bt.HorseshoeSampler) else "bayesr"
    g = torch.Generator(device="cuda").manual_seed(247)
    if chains is None:
        path = os.path.join(tmp, f"{cell}.csv")
        sink = CSVSink(path, kind, M=s.M, N=s.N, emit_epsilon=False)
        run = lambda sk: s.run(g, chain, sink=sk)  # noqa: E731
        paths = [path]
    else:
        sink = ChainFanoutSink.csv(os.path.join(tmp, f"{cell}.csv"), chains,
                                   kind, M=s.M, N=s.N, emit_epsilon=False)
        run = lambda sk: s.run_chains(g, chains, chain,  # noqa: E731
                                      sink=sk)
        paths = sink.paths
    st, out, wall, launches, peak = main_path(torch, run, sink, counter)
    n_rows = len(list(chain.emit_iterations()))
    for p in paths:
        header, widths, bad = read_csv(p)
        check(len(header) == 2 + 2 * s.M + 2
              and widths == [len(header)] * n_rows and not bad,
              f"{tag} {p}: {len(header)} {widths} {bad}")
    check(all(np_finite(x) for x in out.values()), f"{tag} non-finite output")
    ex = s.refresh_eps(st).eps
    rel = float((torch.linalg.norm(st.eps - ex, dim=-1)
                 / torch.linalg.norm(ex, dim=-1)).max())
    if want is None:
        want = 3 * (s.nb // s.jacobi) * chain.max_iterations
    ms_iter = wall / chain.max_iterations * 1e3
    log(f"{tag} {cell} main path: {ms_iter:.2f} ms/iter ({wall:.2f} s for "
        f"{chain.max_iterations} iterations incl. CSV), peak {peak:.2f} GiB, "
        f"launches {launches} (want {want}), tracked-vs-exact eps {rel:.3g}")
    check(rel < 1e-4, f"{tag} {cell} tracked eps vs recompute {rel}")
    check(launches == want, f"{tag} {cell} launches {launches} != {want}")
    return st, launches, ms_iter, peak


def int8_profile(torch, bt, s, st, tag, names, per, steps=2):
    """A profile of ``steps`` steps from ``st``: device time per launch of
    ``names``, device and wall ms, idle; with the strided plan's launches
    (a round), the dot and the apply a round beside their bounds
    (``round_report``)."""
    from bayesrrcpp_tpu_torch.tools import kernel_bounds

    g = torch.Generator(device="cuda").manual_seed(248)
    chains = None if st.eps.dim() == 1 else st.eps.shape[0]
    run = Steps(s, st, bt.TorchVariates(g, chains=chains), steps)
    split, dev_ms, wall_ms = profile_split(torch, run, names, want=per)
    check(profiled(split, per), f"{tag} profiled launches {split}")
    log(f"{tag} profile of {steps} steps: " + ", ".join(
        f"{n} {us:.2f} us x {c}" for n, (us, c) in split.items())
        + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall, idle "
        f"{1 - dev_ms / wall_ms:.3f}")
    if s.jacobi > 1 and s.jacobi_layout == "t":
        nr, c = s.nb // s.jacobi, chains or 1
        round_report(
            torch, tag, split, names[0], names[2],
            kernel_bounds.dot_round(s.N, s.jacobi * s.B, c, 1),
            kernel_bounds.row_apply_round(s.N, run.moved() / nr, c, 1))


def int8_serial_headline(torch, bt, s, kind, fns, tag, blocks, fused, q):
    """One serial int8 sweep at the headline (the fold at J=1 B=512, or the
    ``_q`` mode), timed once, and its first ``blocks`` blocks against the
    plain version under phase 10b's gates (``serial_gates``); ``fused``:
    C=8 fused chains, each also bitwise equal to the single-chain kernel
    on those blocks.  Returns the kernel's JSON numbers."""
    single, plain, fsweep, fplain, make_args, _ = fns
    hsk = kind == "horseshoe"
    g = torch.Generator(device="cuda").manual_seed(249)
    C = CHAINS if fused else None
    v = bt.TorchVariates(g, chains=C)
    st = s.init(v, chains=C)
    sweep = fsweep if fused else single
    ref_fn = fplain if fused else plain
    args, kw = make_args(s, st, v)
    ker, ms = timed(torch, lambda: tuple(sweep(*args, **kw)), 1)
    if q:   # (profiling all 47,232 launches of a sweep takes too long)
        wargs, wkw = make_args(s, st, v, 1024)
        window_report(torch, f"{tag} (1,024 blocks)", s, sweep, wargs, wkw,
                      0 if hsk else args[10].shape[-1])
        del wargs
    moved, moved_rows = moved_of(ker[1], args[4])
    bound = int8_bound(s, C or 1, moved, 4 if hsk else 6, moved_rows,
                       gram_rows=moved_rows, decode=q)
    order = args[5] if hsk else args[6]
    lib_ms = dot_yardstick(torch, s, order[0] * s.B + torch.arange(
        s.B, device="cuda"), args[3]) * s.nb
    args, kw = make_args(s, st, v, blocks)
    kb = tuple(sweep(*args, **kw))
    rb, plain_ms = timed(torch, lambda: tuple(ref_fn(*args, **kw)), 1)
    max_err, agree, rel = serial_gates(torch, tag, kb, rb, hsk)
    if fused:
        for c in range(CHAINS):
            one = single_chains(torch, args, kind, c)
            for a, b in zip(single(*one, **kw), kb):
                check(torch.equal(a, b[c]),
                      f"{tag} chain {c} differs from the single-chain kernel")
    log(f"{tag} sweep at the headline: {ms:.3f} ms, bound {bound[0]:.3f} ms "
        f"({bound[1]}), dot yardstick {lib_ms:.3f} ms; {blocks} blocks vs "
        f"plain ({plain_ms:.1f} ms): label agreement {agree:.6f}, |d eps|/"
        f"|eps| {rel:.3g}, max abs err {max_err:.3g}"
        + ("; fused chains bitwise equal to the single-chain kernel"
           if fused else ""))
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)


def int8_sharded(torch, bt, jt):
    """24f: the marker-sharded driver on int8 codes on a (1, 1) mesh of a
    one-rank NCCL group, N=4096 x M=16,384 (the "t" plan J=64, B=32): the
    sharded sampler takes the same device codes as the unsharded one (no
    copy); #5 / #6 over every round bitwise equal to #1 / #3 on the same
    inputs; ``run`` (ChainConfig(5, 2, 2)) and ``run_chains`` of 8 with the
    rounds kernels' counts set to 0 just before, their launch counts, CSV
    and tracked eps.  Returns the launches of #5 and #6."""
    import tempfile as tf

    import torch.distributed as dist

    from bayesrrcpp_tpu_torch.parallel.distributed import initialize

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(250)
    s = int8_sampler(torch, bt, g, 4096, 16384, bt.BayesRConfig())
    launches = {}
    initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = bt.make_mesh(1, 1, device="cuda:0")
        sh = bt.ShardedSpikeSlabSampler(
            s.data.XT, s.Y, CVA, bt.BayesRConfig(emit_epsilon=False), mesh,
            backend="pallas", x_dtype="int8", transposed=True,
            x_stats=bt.simulate.packed_word_stats(s.M))
        check((sh.jacobi, sh.B, sh.Mpad, sh.strided) ==
              (s.jacobi, s.B, s.Mpad, True)
              and sh.data.XT.data_ptr() == s.data.XT.data_ptr(),
              f"[24f] sharded plan {(sh.jacobi, sh.B, sh.Mpad)}")
        nr = sh.nb // sh.jacobi
        for C in (None, CHAINS):
            v = bt.TorchVariates(g, chains=C)
            st = s.init(v, chains=C)
            for _ in range(2):
                st = s.step(st, v) if C is None else s.step_chains(st, v)
            args, kw = sweep_args(s, st, v)
            rounds, _, whole = rounds_fns(jt, C)
            d = sh.data
            same_bits(torch, f"[24f] C={C or 1} #5/#6 on the sharded "
                      f"sampler's data vs #1/#3 on the unsharded one's",
                      rounds(d.XT, d.gram, d.xsq, *args[3:], nr_total=nr,
                             **kw),
                      whole(*args, **kw))
        with tf.TemporaryDirectory() as d:
            for C, counter in ((None, jt.bayesr_jacobi_t_rounds),
                               (CHAINS, jt.bayesr_jacobi_t_mc_rounds)):
                _, n, ms_iter, _ = int8_main_path(
                    torch, bt, sh, "[24f]", "int8-sharded-m1"
                    + ("" if C is None else "-8chain"), d, counter,
                    bt.ChainConfig(5, 2, 2), C)
                launches[C] = n
        del sh
    finally:
        dist.destroy_process_group()
    return launches


def int8_cli(torch, bt, ser, tmp):
    """24g: ``python -m bayesrrcpp_tpu_torch bayesr|horseshoe --bed ...
    --x-dtype int8`` in-process on the card, on a .bed with missing calls
    (N=8,192 x M=4,096, written by ``io/bed.write_bed``): the .bed read with
    NaN for a missing call, quantized to int8 codes, the auto plan's J=1
    in-kernel decode; the CSV's widths and values and the launch counts."""
    import numpy as np

    from bayesrrcpp_tpu_torch import cli
    from bayesrrcpp_tpu_torch.io import bed

    N, M = 8192, 4096
    rng = np.random.default_rng(24)
    dos = rng.integers(0, 3, size=(N, M), dtype=np.int8).astype(np.float32)
    dos[rng.random((N, M), dtype=np.float32) < 1 / 64] = np.nan
    with tempfile.TemporaryDirectory(dir=tmp) as d:
        prefix = os.path.join(d, "cohort")
        bed.write_bed(prefix, dos)
        pheno = os.path.join(d, "y.txt")
        np.savetxt(pheno, rng.standard_normal(N))
        for kind, counter in (("bayesr", ser.bayesr_sweep),
                              ("horseshoe", ser.horseshoe_sweep)):
            out = os.path.join(d, f"{kind}.csv")
            torch.cuda.synchronize()
            counter.launches = 0
            t0 = time.perf_counter()
            rc = cli.main([kind, "--bed", prefix, "--pheno", pheno,
                           "--x-dtype", "int8", "--out", out,
                           "--iterations", "6", "--burn-in", "2",
                           "--thinning", "2", "--seed", "3"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            header, widths, bad = read_csv(out)
            want = 3 * (M // 32) * 6
            log(f"[24g] python -m bayesrrcpp_tpu_torch {kind} --bed ... "
                f"--x-dtype int8: rc {rc}, {wall:.2f} s, CSV {len(widths)} "
                f"rows of {len(header)} columns, launches {counter.launches} "
                f"(want {want}: the serial in-kernel decode at J=1, B=32)")
            check(rc == 0 and len(header) == 2 + 2 * M + 2 + N
                  and widths == [len(header)] * 2 and not bad,
                  f"[24g] {kind} CSV {len(header)} {widths} {bad}")
            check(counter.launches == want,
                  f"[24g] {kind} launches {counter.launches}")


def int8_phases(torch, bt, hs, tmp):
    """Phase 24 (module docstring): int8 codes through every sweep kernel's
    int8 mode, the codes decoded from phase 2's words (those of ``hs``),
    CSVs under ``tmp``.  Returns the int8 kernels' JSON records."""
    from bayesrrcpp_tpu_torch.ops import jacobi as jr
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
    from bayesrrcpp_tpu_torch.ops import multichain as mcs
    from bayesrrcpp_tpu_torch.ops import serial as ser

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    layouts = int8_layouts(jt, jr, ser, mcs)
    rec = {}

    # ---- 24a / 24b
    worst = int8_small(torch, bt, jt, layouts)
    log(f"[24a] max |d| vs plain {worst:.3g}")
    int8_vs_packed(torch, bt, hs, layouts["strided"][2])

    # ---- 24c. biobank-int8-auto: the headline codes from phase 2's words
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    codes = int8_codes(torch, hs.data.XT, hs.N)
    torch.cuda.synchronize()
    codes_s = time.perf_counter() - t0
    Y = hs.Y[:hs.N]
    t0 = time.perf_counter()
    s = int8_sampler(torch, bt, None, HEADLINE_N, HEADLINE_M,
                     bt.BayesRConfig(emit_epsilon=False), codes=codes, Y=Y)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check((s.jacobi, s.B, s.jacobi_layout, s.Mpad) ==
          (128, 32, "t", HEADLINE_M) and not s.data.has_missing
          and s.data.XT.data_ptr() == codes.data_ptr(),
          f"[24c] headline plan {(s.jacobi, s.B, s.Mpad)} or codes copied")
    nr = s.nb // s.jacobi
    log(f"[24c] headline int8 codes ({codes.numel()} B, "
        f"{codes.numel() / 2 ** 30:.2f} GiB) decoded from phase 2's words in "
        f"{codes_s:.2f} s; sampler setup (xsq, Gram, column sums; no copy of "
        f"the codes) {setup_s:.2f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    names = ("dense_dot_kernel", "solve_kernel", "row_apply_kernel")
    st, n, ms_iter, peak = int8_main_path(
        torch, bt, s, "[24c]", "biobank-int8-auto", tmp, jt.bayesr_jacobi_t,
        bt.ChainConfig(30, 10, 10))
    rec["bayesr"] = dict(launches=n, ms_iter=ms_iter)
    check(peak < 75, f"[24c] peak {peak:.2f} GiB")
    int8_profile(torch, bt, s, st, "[24c] biobank-int8-auto", names, 2 * nr)
    del st
    rec["bayesr"].update(int8_strided_headline(
        torch, bt, jt, s, "bayesr", sweep_args, False, "[24c] BayesR int8"))
    # #5 over every round: #1's launches, bitwise (phase 23a's check)
    g = torch.Generator(device=dev).manual_seed(251)
    v = bt.TorchVariates(g)
    st = s._run_steps(s.init(v), v, 1)
    args, kw = sweep_args(s, st, v)
    full, rounds_ms = timed(torch, lambda: jt.bayesr_jacobi_t_rounds(
        *args, nr_total=nr, **kw), 1)
    same_bits(torch, "[24c] #5 over every round vs #1", full,
              jt.bayesr_jacobi_t(*args, **kw))
    rec["rounds"] = dict(rec["bayesr"], ms=rounds_ms)
    del st, args, full
    elapsed("24a-24c")

    # ---- 24d. biobank-int8-horseshoe, biobank-int8-8chain, a row plan
    h = int8_sampler(torch, bt, None, HEADLINE_N, HEADLINE_M,
                     bt.HorseshoeConfig(emit_epsilon=False), codes=codes, Y=Y)
    check(h.data.XT.data_ptr() == codes.data_ptr(), "[24d] codes copied")
    st, n, ms_iter, _ = int8_main_path(
        torch, bt, h, "[24d]", "biobank-int8-horseshoe", tmp,
        jt.horseshoe_jacobi_t, bt.ChainConfig(10, 5, 5))
    int8_profile(torch, bt, h, st, "[24d] biobank-int8-horseshoe",
                 ("dense_dot_kernel", "hs_solve_kernel", "row_apply_kernel"),
                 2 * nr)
    del st
    rec["horseshoe"] = dict(launches=n, ms_iter=ms_iter,
                            **int8_strided_headline(
                                torch, bt, jt, h, "horseshoe", hs_sweep_args,
                                False, "[24d] horseshoe int8"))
    for kind, sm, counter in (("bayesr", s, jt.bayesr_jacobi_t_mc),
                              ("horseshoe", h, jt.horseshoe_jacobi_t_mc)):
        cell = ("biobank-int8-8chain" if kind == "bayesr"
                else "biobank-int8-horseshoe-8chain")
        st, n, ms_iter, _ = int8_main_path(
            torch, bt, sm, "[24d]", cell, tmp, counter,
            bt.ChainConfig(5, 2, 2), CHAINS)
        int8_profile(torch, bt, sm, st, f"[24d] {cell}",
                     ("dense_dot_kernel", "solve_mc_kernel" if kind ==
                      "bayesr" else "hs_solve_mc_kernel",
                      "row_apply_kernel"), 2 * nr)
        del st
        rec[kind + "_mc"] = dict(launches=n, ms_iter=ms_iter,
                                 **int8_strided_headline(
                                     torch, bt, jt, sm, kind,
                                     sweep_args if kind == "bayesr"
                                     else hs_sweep_args, True,
                                     f"[24d] {kind} int8 C={CHAINS}"))
        if kind == "bayesr":
            g = torch.Generator(device=dev).manual_seed(252)
            v8 = bt.TorchVariates(g, chains=CHAINS)
            st = sm.init(v8, chains=CHAINS)
            args, kw = sweep_args(sm, st, v8)
            full, rounds_ms = timed(
                torch, lambda: jt.bayesr_jacobi_t_mc_rounds(
                    *args, nr_total=nr, **kw), 1)
            same_bits(torch, "[24d] #6 over every round vs #3", full,
                      jt.bayesr_jacobi_t_mc(*args, **kw))
            rec["rounds_mc"] = dict(rec["bayesr_mc"], ms=rounds_ms)
            del st, args, full
    del s, h
    # the row plan (J=32, B=128): 2 iterations of each sampler, 8 fused
    # chains through the serial fused sweep (#11, #12)
    for kind in ("bayesr", "horseshoe"):
        cfg = (bt.HorseshoeConfig if kind == "horseshoe" else bt.BayesRConfig)(
            emit_epsilon=False, block_size=128)
        sr = int8_sampler(torch, bt, None, HEADLINE_N, HEADLINE_M, cfg,
                          codes=codes, Y=Y, jacobi_blocks=32,
                          jacobi_layout="row")
        check((sr.jacobi, sr.B, sr.jacobi_layout) == (32, 128, "row")
              and sr.data.XT.data_ptr() == codes.data_ptr(), "[24d] row plan")
        single, plain, _, _, make_args, bn = layouts["row"][2][kind]
        fsweep = (mcs.bayesr_sweep_mc if kind == "bayesr"
                  else mcs.horseshoe_sweep_mc)
        solve = (jr.bayesr_round_solve if kind == "bayesr"
                 else jr.horseshoe_round_solve)
        n, solves, ms_iter = row_main_paths(
            torch, bt, sr, "[24d]", f"biobank-int8-{kind}-row", tmp,
            (single, solve, fsweep), 253, bt.ChainConfig(2, 1, 1))
        g = torch.Generator(device=dev).manual_seed(254)
        v = bt.TorchVariates(g)
        st = sr.init(v)
        args, kw = make_args(sr, st, v)
        ker, ms = timed(torch, lambda: tuple(single(*args, **kw)), 1)
        moved, moved_rows = moved_of(ker[1], args[4])
        bound = int8_bound(sr, 1, moved, 4 if kind == "horseshoe" else 6,
                           moved_rows)
        order = args[5] if kind == "horseshoe" else args[6]
        rows = (order[:sr.jacobi].long()[:, None] * sr.B
                + torch.arange(sr.B, device=dev)).reshape(-1)
        lib_ms = dot_yardstick(torch, sr, rows, args[3]) * (sr.nb // sr.jacobi)
        args, kw = make_args(sr, st, v, ROW_PLAIN_ROUNDS)
        kr = tuple(single(*args, **kw))
        rr, plain_ms = timed(torch, lambda: tuple(plain(*args, **kw)), 1)
        hsk = kind == "horseshoe"
        agree, flips = dense_gates(torch, sr, f"[24d] {kind} row", args, kw,
                                   kr, rr, hsk, sweeps=(single, plain),
                                   rounds=row_rounds)
        max_err = max(float((a - b).abs().max())
                      for a, b in zip(kr[:2], rr[:2]))
        log(f"[24d] {kind} int8 row sweep (J=32, B=128) at the headline: "
            f"{ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}), dot "
            f"yardstick {lib_ms:.3f} ms; {ROW_PLAIN_ROUNDS} rounds vs plain "
            f"({plain_ms:.1f} ms): label agreement {agree:.6f}, |d eps|/|eps| "
            f"{rel_err(kr[0], rr[0]):.3g}, chains with a flip {flips}")
        rec[kind + "_row"] = dict(launches=n, max_abs_err=max_err, ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound[0],
                                  bound_by=bound[1], library_ms=lib_ms)
        del sr, st, args, ker, kr, rr
    elapsed("24d")

    # ---- the serial int8 fold at the headline (J=1, B=512; #9-#12): one
    # sweep of each timed, 1 block against the plain version; their main
    # paths at the auto plan of M=1500 (J=1)
    for kind in ("bayesr", "horseshoe"):
        cfg = (bt.HorseshoeConfig if kind == "horseshoe" else bt.BayesRConfig)(
            emit_epsilon=False, block_size=512)
        ss = int8_sampler(torch, bt, None, HEADLINE_N, HEADLINE_M, cfg,
                          codes=codes, Y=Y, jacobi_blocks=1)
        check((ss.jacobi, ss.B) == (1, 512) and ss.supports_fused_chains,
              "[24] serial plan")
        fns = layouts["serial"][2][kind]
        for fused in (False, True):
            key = kind + ("_serial_mc" if fused else "_serial")
            rec[key] = int8_serial_headline(
                torch, bt, ss, kind, fns, f"[24] {kind} serial int8"
                + (f" C={CHAINS}" if fused else ""), 1, fused, False)
        del ss
        gs = torch.Generator(device=dev).manual_seed(255)
        sm = int8_sampler(torch, bt, gs, 4096, 1500, cfg)
        check((sm.jacobi, sm.jacobi_layout) == (1, "row"), "[24] M=1500 plan")
        for fused, counter in ((False, fns[0]), (True, fns[2])):
            key = kind + ("_serial_mc" if fused else "_serial")
            _, n, _, _ = int8_main_path(
                torch, bt, sm, "[24]", f"int8-m1500-{kind}"
                + ("-8chain" if fused else ""), tmp, counter,
                bt.ChainConfig(10, 5, 5), CHAINS if fused else None,
                want=3 * sm.nb * 10)
            rec[key]["launches"] = n
        del sm

    # ---- 24e. biobank-int8-missing: code 3 written in place at 2^-6
    g = torch.Generator(device=dev).manual_seed(256)
    for a in range(0, HEADLINE_M, 4096):
        b = min(HEADLINE_M, a + 4096)
        hit = torch.randint(0, 64, (b - a, HEADLINE_N), generator=g,
                            device=dev, dtype=torch.uint8) == 0
        codes[a:b].masked_fill_(hit, 3)
    del hit
    share = 0.0
    for a in range(0, HEADLINE_M, 4096):
        share += float((codes[a:a + 4096] == 3).sum())
    share /= codes.numel()
    for kind in ("bayesr", "horseshoe"):
        cfg = (bt.HorseshoeConfig if kind == "horseshoe" else bt.BayesRConfig)(
            emit_epsilon=False)
        sq = int8_sampler(torch, bt, None, HEADLINE_N, HEADLINE_M, cfg,
                          codes=codes, Y=Y)
        check((sq.jacobi, sq.B) == (1, 32) and sq.data.has_missing
              and not sq.supports_fused_chains
              and sq._sweep_kw()["fold_affine"] is False,
              f"[24e] auto plan with missing calls {(sq.jacobi, sq.B)}")
        fns = layouts["q"][2][kind]
        cell = ("biobank-int8-missing" if kind == "bayesr"
                else "biobank-int8-horseshoe-missing")
        chain = bt.ChainConfig(10, 5, 5) if kind == "bayesr" else \
            bt.ChainConfig(3, 1, 1)
        st, n, ms_iter, _ = int8_main_path(
            torch, bt, sq, "[24e]", cell, tmp, fns[0], chain,
            want=3 * sq.nb * chain.max_iterations)
        if kind == "bayesr":
            int8_profile(torch, bt, sq, st, f"[24e] {cell}",
                         ("serial_q8_dot_kernel", "serial_solve_kernel",
                          "row_apply_kernel"), sq.nb, steps=1)
        del st
        rec[kind + "_q"] = dict(launches=n, ms_iter=ms_iter,
                                **int8_serial_headline(
                                    torch, bt, sq, kind, fns,
                                    f"[24e] {kind} int8 _q",
                                    HEADLINE_PLAIN_BLOCKS, False, True))
        log(f"[24e] {cell}: {share:.6f} of the calls missing")
        del sq
    del codes
    elapsed("24e")

    # ---- 24f, 24g
    launches = int8_sharded(torch, bt, jt)
    rec["rounds"]["launches"] = launches[None]
    rec["rounds_mc"]["launches"] = launches[CHAINS]
    int8_cli(torch, bt, ser, tmp)
    log(f"[24] phase 24 took {time.perf_counter() - t_start:.1f} s")

    src = "bayesrrcpp_tpu_torch/csrc/"
    tpu = "bayesrrcpp_tpu/ops/"
    meta = (
        ("bayesr", "jacobi_t_sweep_int8", "jacobi_t.cu",
         "pallas_jacobi_t.py:1032", "int8"),
        ("horseshoe", "jacobi_t_hs_sweep_int8", "jacobi_t.cu",
         "pallas_jacobi_t.py:1151", "int8"),
        ("bayesr_mc", "jacobi_t_mc_sweep_int8", "jacobi_t_mc.cu",
         "pallas_jacobi_t.py:1635/:2894", "int8"),
        ("horseshoe_mc", "jacobi_t_hs_mc_sweep_int8", "jacobi_t_mc.cu",
         "pallas_jacobi_t.py:2054/:3263", "int8"),
        ("rounds", "jacobi_t_rounds_int8", "jacobi_t.cu",
         "pallas_jacobi_t.py:2229", "int8"),
        ("rounds_mc", "jacobi_t_mc_rounds_int8", "jacobi_t_mc.cu",
         "pallas_jacobi_t.py:2403", "int8"),
        ("bayesr_serial", "bayesr_serial_sweep_int8", "serial.cu",
         "pallas_sweep.py:431", "int8"),
        ("horseshoe_serial", "horseshoe_serial_sweep_int8", "serial.cu",
         "pallas_sweep.py:824", "int8"),
        ("bayesr_serial_mc", "bayesr_serial_mc_sweep_int8", "serial.cu",
         "pallas_multichain.py:359", "int8"),
        ("horseshoe_serial_mc", "horseshoe_serial_mc_sweep_int8",
         "serial.cu", "pallas_multichain.py:736", "int8"),
        ("bayesr_q", "bayesr_serial_sweep_int8_q", "serial.cu",
         "pallas_sweep.py:431", "int8_q"),
        ("horseshoe_q", "horseshoe_serial_sweep_int8_q", "serial.cu",
         "pallas_sweep.py:824", "int8_q"),
        ("horseshoe_row", "horseshoe_row_sweep_int8", "serial.cu",
         "pallas_jacobi.py:1153", "int8"),
        ("bayesr_row", "bayesr_row_sweep_int8", "serial.cu",
         "pallas_jacobi.py:1299", "int8"))
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    return [dict({"name": name, "route": "cuda", "source": src + f,
                  "replaces": tpu + where, "mode": mode},
                 **{k: rec[key][k] for k in keys})
            for key, name, f, where, mode in meta]


# ---------------------------------------------------------------- phase 25

# 25a's shape (N x M, B=512: 16 blocks) and the blocks of its sweeps held
# against the plain versions (the plain serial step takes the host ~3 ms)
SH25_N, SH25_M, SH25_BLOCKS = 4096, 8192, 4
# 25d / 25e: dense N x M on (1, 2) and (2, 2) meshes of gloo ranks on the
# one card, and chains over two of them (4 fused chains a rank); the xla
# cases on the first MESH25_XLA_M markers (their per-marker solve is tens
# of tiny launches a marker, from four processes time-sharing the card)
MESH25_N, MESH25_M, MESH25_STEPS, CHAINS25 = 4096, 8192, 3, 4
MESH25_XLA_M = 512


def hs25_sweep(s, st, eps, border, inner, z, fn):
    """The sharded horseshoe's chunked sweep of ``s`` (``_serial_chunks``:
    chunks of ``chunk_blocks`` blocks, one all-reduce of eps after each)
    through ``fn``: ``ops/serial.horseshoe_sweep`` or its plain version."""
    d = s.data
    beta = st.beta

    def sweep(eps, blocks, by_block, z_c):
        return fn(d.XT, d.gram, d.xsq, eps, beta, blocks, by_block, z_c,
                  st.lam, st.tau, st.c2, st.sigmaE, d.valid,
                  **s._sweep_kw())

    for eps, beta in s._serial_chunks(sweep, eps, border, inner, z):
        pass
    return eps, beta


def sharded_hs_small(torch, bt, mesh):
    """25a: site #10 through the sharded horseshoe's chunked call at
    N=4096 x M=8192 (B=512, 16 blocks) in each storage mode, chunks of 3
    blocks and the default (one chunk): the first ``SH25_BLOCKS`` blocks
    of a warm state's sweep against the plain versions under phase 10a's
    gates (``check_sweeps``), the whole sweep's launches counted."""
    from bayesrrcpp_tpu_torch.ops import serial as ser

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(25)
    words = bt.simulate.random_packed_words(g, SH25_M, SH25_N // 16,
                                            device="cuda")
    missing = bt.simulate.random_packed_words_missing(
        g, SH25_M, SH25_N // 16, device="cuda")
    stats = bt.simulate.packed_word_stats(SH25_M)
    Y = torch.randn(SH25_N, generator=g, device="cuda")
    X = dense_x(torch, g, SH25_N, SH25_M)
    modes = {"2-bit fold": dict(X=words, x_dtype="2bit", x_stats=stats),
             "2-bit _q": dict(X=missing, x_dtype="2bit", x_stats=stats),
             "int8": dict(X=int8_codes(torch, words, SH25_N), x_dtype="int8",
                          x_stats=stats),
             "dense": dict(X=X, x_dtype="dense")}
    worst = 0.0
    for mode, kw in modes.items():
        for chunk in (3, None):
            s = bt.ShardedHorseshoeSampler(
                kw["X"], Y, bt.HorseshoeConfig(), mesh, backend="pallas",
                x_dtype=kw["x_dtype"], x_stats=kw.get("x_stats"),
                transposed=True, chunk_blocks=chunk)
            check((s.jacobi, s.B, s.nb_loc) == (1, 512, 16)
                  and s.data.has_missing == (mode == "2-bit _q"),
                  f"[25a] {mode} plan {(s.jacobi, s.B, s.nb_loc)}")
            gs = torch.Generator(device=dev).manual_seed(7)
            v = s.variates(gs)
            st = s.init(v)
            for _ in range(2):
                st = s.step(st, v)
            border, inner = v.loc.block_orders(s.nb_loc, s.B)
            z = v.loc.z(s.Mloc)
            n = SH25_BLOCKS
            part = (st.eps, border[:n], inner[:n], z[:n * s.B])
            ker = hs25_sweep(s, st, *part, ser.horseshoe_sweep)
            ref = hs25_sweep(s, st, *part, ser.horseshoe_sweep_reference)
            worst = max(worst, check_sweeps(
                torch, f"[25a] {mode} chunk_blocks {chunk}", ("eps", "beta"),
                ker, ref))
            ser.horseshoe_sweep.launches = 0
            full = s._sweep_serial(st, st.eps, border, inner, z)
            torch.cuda.synchronize()
            want = 3 * s.nb_loc
            check(ser.horseshoe_sweep.launches == want,
                  f"[25a] {mode} launches {ser.horseshoe_sweep.launches}")
            check(np_finite(full[1].cpu()), f"[25a] {mode} non-finite beta")
            log(f"[25a] sharded horseshoe {mode}, chunk_blocks "
                f"{chunk or 128} ({-(-s.nb_loc // s._serial_chunk())} "
                f"chunks): first {n} blocks vs plain under 10a's gates; a "
                f"sweep {want} launches")
            del s, st, ker, ref, full
    return worst


def sharded_hs_headline(torch, bt, hs, mesh, tmp):
    """25b: biobank-horseshoe-sharded-m1, ``ShardedHorseshoeSampler`` on
    the headline words of ``hs`` (phase 2's, not copied) on the one-rank
    NCCL mesh: ``.run`` into a CSVSink with #10's count reset just before,
    beside biobank-horseshoe-serial's ms/iter (phase 12); a profile of one
    step."""
    from bayesrrcpp_tpu_torch.io.sink import CSVSink
    from bayesrrcpp_tpu_torch.ops import serial as ser

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh = bt.ShardedHorseshoeSampler(
        hs.data.XT, hs.Y[:hs.N], bt.HorseshoeConfig(emit_epsilon=False),
        mesh, backend="pallas", x_dtype="2bit", transposed=True,
        x_stats=bt.simulate.packed_word_stats(HEADLINE_M), has_missing=False)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(sh.data.XT.data_ptr() == hs.data.XT.data_ptr(), "[25b] words "
          "copied")
    check((sh.jacobi, sh.B, sh.Mpad, sh.nb_loc, sh._serial_chunk()) ==
          (1, 512, HEADLINE_M, 984, 128), f"[25b] plan {(sh.B, sh.nb_loc)}")
    g = torch.Generator(device="cuda").manual_seed(26)
    chain = bt.ChainConfig(5, 2, 2)
    path = os.path.join(tmp, "hs_sharded.csv")
    st, out, wall, launches, peak = main_path(
        torch, lambda sk: sh.run(g, chain, sink=sk),
        CSVSink(path, "horseshoe", M=sh.M, N=sh.N, emit_epsilon=False),
        ser.horseshoe_sweep)
    header, widths, bad = read_csv(path)
    n_rows = len(list(chain.emit_iterations()))
    check(len(header) == 2 + 2 * sh.M + 2 and widths == [len(header)] *
          n_rows and not bad, f"[25b] {path}: {len(header)} {widths} {bad}")
    check(all(np_finite(x) for x in out.values()), "[25b] non-finite output")
    rel = rel_err(st.eps, sh.refresh_eps(st).eps)
    want = 3 * sh.nb_loc * chain.max_iterations
    check(rel < 1e-4, f"[25b] tracked eps vs recompute {rel}")
    check(launches == want, f"[25b] launches {launches} != {want}")
    names = ("serial_dot_kernel", "serial_solve_kernel",
             "serial_apply_kernel")
    one = Steps(sh, st, sh.variates(g), 1)
    split, dev_ms, wall_ms = profile_split(torch, one, names, want=sh.nb_loc)
    check(profiled(split, sh.nb_loc), f"[25b] profiled launches {split}")
    ms_iter = wall / chain.max_iterations * 1e3
    log(f"[25b] biobank-horseshoe-sharded-m1 main path (setup {setup_s:.2f} "
        f"s): {ms_iter:.2f} ms/iter ({wall:.2f} s for "
        f"{chain.max_iterations} iterations incl. CSV), peak {peak:.2f} GiB, "
        f"launches {launches} (want {want}), tracked-vs-exact eps {rel:.3g}; "
        + beside("biobank-horseshoe-serial", ms_iter)
        + "; profile of 1 step: " + ", ".join(
            f"{n} {us:.2f} us x {c}" for n, (us, c) in split.items())
        + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall "
        f"({1 - dev_ms / wall_ms:.1%} idle); {CARD}")
    return launches


def beside(cell, ms_iter):
    """``cell``'s ms/iter from this run (``CELL_MS``) beside ``ms_iter``."""
    twin = CELL_MS.get(cell)
    if twin is None:
        return f"{cell} not run in this run"
    return f"{cell} in this run {twin:.2f} ms/iter, {ms_iter / twin:.4f}x"


def split_round_profile(torch, s, st, v, kind):
    """The split of one split-sweep step of ``s`` into its rounds' parts:
    device us of the mv's (cuBLAS gemv), the round solves, the all-reduces
    (NCCL) and every other kernel (the wrapper's and the step's small
    ops), per round, and the step's wall ms."""
    nr = s.nb_loc // s.split_blocks()
    names = ("gemv", "serial_solve_kernel", "nccl")
    split, dev_ms, wall_ms = profile_split(
        torch, Steps(s, st, v, 1), names, want=nr,
        counted=("serial_solve_kernel",))
    check(profiled({"solve": split["serial_solve_kernel"]}, nr),
          f"[25c] {kind} profiled round solves {split}")
    parts = {n: us * c / nr for n, (us, c) in split.items()}
    parts["other"] = dev_ms * 1e3 / nr - sum(parts.values())
    return parts, split, dev_ms, wall_ms


def split_cell(torch, bt, mesh, tmp):
    """25c: dense-16kx49k through the split sweep (``split_sweep=True``) on
    the one-rank NCCL mesh, X built on the card, both samplers: the first
    two rounds' solves of a warm state against their plain versions
    (``check_round_solve``), ``.run`` with the round solves' counts reset
    just before (one launch a round), ms/iter beside the unsplit cell's
    (phase 18), and a step's per-round split."""
    from bayesrrcpp_tpu_torch.io.sink import CSVSink
    from bayesrrcpp_tpu_torch.ops import jacobi as jr

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(27)
    X = dense_x(torch, g, DENSE_N, DENSE_M)
    Y = torch.randn(DENSE_N, generator=g, device=dev)
    out_launches = {}
    for kind in ("bayesr", "horseshoe"):
        kw = dict(backend="pallas", transposed=True, split_sweep=True)
        if kind == "bayesr":
            s = bt.ShardedSpikeSlabSampler(
                X, Y, CVA, bt.BayesRConfig(emit_epsilon=False), mesh, **kw)
            solve, ref_solve = jr.bayesr_round_solve, \
                jr.bayesr_round_solve_reference
        else:
            s = bt.ShardedHorseshoeSampler(
                X, Y, bt.HorseshoeConfig(emit_epsilon=False), mesh, **kw)
            solve, ref_solve = jr.horseshoe_round_solve, \
                jr.horseshoe_round_solve_reference
        J = s.split_blocks()
        nr = s.nb_loc // J
        check((s._split, s.B, J, nr) == (True, 512, 8, 12),
              f"[25c] {kind} plan {(s._split, s.B, J, nr)}")
        gs = torch.Generator(device=dev).manual_seed(8)
        v = s.variates(gs)
        st = s._run_steps(s.init(v), v, 2)
        # the round solves of the first two rounds of a sweep, each round's
        # inputs handed to the kernel and to the plain version alike
        v.begin_step()
        border, inner = v.loc.block_orders(s.nb_loc, s.B)
        calls = []
        p = v.loc.p(s.Mloc) if kind == "bayesr" else None
        z = v.loc.z(s.Mloc)
        by_block = torch.zeros_like(inner)
        by_block[border.long()] = inner
        d = s.data
        if kind == "bayesr":
            pkg, inner_sel = jr.build_pkg_jacobi(
                d.xsq, d.g_assign, d.valid, p, z, st.pi, d.cva, st.sigmaE,
                st.sigmaGG, border, by_block, B=s.B, J=J)
        else:
            pkg, inner_sel = jr.build_pkg_hs_jacobi(
                d.xsq, d.valid, z, st.lam, st.tau, st.c2, st.sigmaE, border,
                by_block, B=s.B, J=J)
        beta = st.beta.clone()
        labels = st.labels.clone() if kind == "bayesr" else None

        def round_solve(i, r, blk, idx):
            if kind == "bayesr":
                a = (r, d.gram[blk], beta[idx].view(J, s.B),
                     labels[idx].view(J, s.B), d.g_assign[idx].view(J, s.B),
                     inner_sel[i], pkg[i], st.sigmaE)
                kk = dict(K=s.K, G=s.G)
            else:
                a = (r, d.gram[blk], beta[idx].view(J, s.B), inner_sel[i],
                     pkg[i])
                kk = {}
            ker, ref = solve(*a, **kk), ref_solve(*a, **kk)
            calls.append(check_round_solve(torch, f"[25c] {kind} round {i}",
                                           kind, ker, ref))
            beta[idx] = ker[1].reshape(-1)
            if kind == "bayesr":
                labels[idx] = ker[2].reshape(-1)
            return ker[0]

        s._split_rounds(st.eps, border[:2 * J], round_solve)
        worst = max(calls)
        path = os.path.join(tmp, f"split_{kind}.csv")
        chain = bt.ChainConfig(4, 2, 2)
        reset_counts(jr.bayesr_round_solve, jr.horseshoe_round_solve)
        st2, out, wall, launches, peak = main_path(
            torch, lambda sk: s.run(gs, chain, sink=sk),
            CSVSink(path, kind, M=s.M, N=s.N, emit_epsilon=False), solve)
        header, widths, bad = read_csv(path)
        check(widths == [len(header)] * len(list(chain.emit_iterations()))
              and not bad, f"[25c] {path}: {widths} {bad}")
        check(all(np_finite(x) for x in out.values()),
              f"[25c] {kind} non-finite output")
        rel = rel_err(st2.eps, s.refresh_eps(st2).eps)
        want = nr * chain.max_iterations
        check(rel < 1e-4, f"[25c] {kind} tracked eps vs recompute {rel}")
        check(launches == want, f"[25c] {kind} round solves {launches} != "
              f"{want}")
        out_launches[kind] = launches
        parts, split, dev_ms, wall_ms = split_round_profile(
            torch, s, st2, s.variates(gs), kind)
        ms_iter = wall / chain.max_iterations * 1e3
        cell = "dense-16kx49k" + ("" if kind == "bayesr" else "-horseshoe")
        log(f"[25c] {cell}-split ({kind}, J={J}, B={s.B}, nr={nr}): first 2 "
            f"round solves vs plain max |d| {worst:.3g}; main path "
            f"{ms_iter:.2f} ms/iter ({wall:.2f} s for {chain.max_iterations}"
            f" iterations incl. CSV), peak {peak:.2f} GiB, round solves "
            f"{launches} (want {want}), tracked-vs-exact eps {rel:.3g}; the "
            f"unsplit " + beside(cell, ms_iter) + "; a round: "
            + ", ".join(f"{k} {us:.2f} us" for k, us in parts.items())
            + f" (device; profile " + ", ".join(
                f"{n} {us:.2f} us x {c}" for n, (us, c) in split.items())
            + f"), step device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall, "
            f"{wall_ms / nr:.3f} ms wall a round; {CARD}")
        del s, st, st2, out, pkg
    del X
    return out_launches


def mesh25_child(rank, port, out_path):
    """One of the four ranks of 25d / 25e (a gloo group over CUDA tensors
    on the one card): the (1, 2) cases on each half of the ranks, the
    (2, 2) cases on all four, both samplers, the kernels (the split sweep)
    and ``backend="xla"``, ``MESH25_STEPS`` steps each; then chains over
    devices on each half: ``ChainParallelRunner`` with 4 fused chains a
    rank beside a one-rank ``run_chains`` of the rank's streams.  Every
    result or the error pickled to ``out_path``."""
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bayesrrcpp_tpu_torch as bt
    from bayesrrcpp_tpu_torch.ops import jacobi as jr
    from bayesrrcpp_tpu_torch.parallel.distributed import initialize

    res = {}
    try:
        initialize(f"tcp://127.0.0.1:{port}", 4, rank, backend="gloo")
        halves = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        half = halves[rank // 2]
        g = torch.Generator(device="cuda").manual_seed(28)
        X = dense_x(torch, g, MESH25_N, MESH25_M)
        Y = torch.randn(MESH25_N, generator=g, device="cuda")
        for shape, group in (((1, 2), half), ((2, 2), None)):
            mesh = bt.make_mesh(*shape, group=group, device="cuda:0")
            for kind in ("bayesr", "horseshoe"):
                for backend in ("pallas", "xla"):
                    Xc = X if backend == "pallas" else X[:MESH25_XLA_M]
                    if kind == "bayesr":
                        s = bt.ShardedSpikeSlabSampler(
                            Xc, Y, CVA, bt.BayesRConfig(), mesh,
                            backend=backend, transposed=True)
                        solve = jr.bayesr_round_solve
                    else:
                        s = bt.ShardedHorseshoeSampler(
                            Xc, Y, bt.HorseshoeConfig(), mesh,
                            backend=backend, transposed=True)
                        solve = jr.horseshoe_round_solve
                    t0 = time.perf_counter()
                    gen = torch.Generator(device="cuda").manual_seed(9)
                    v = s.variates(gen)
                    st = s.init(v)
                    solve.launches = 0
                    steps = []
                    for _ in range(MESH25_STEPS):
                        st = s.step(st, v)
                        steps.append({k: getattr(st, k).cpu().numpy()
                                      for k in ("mu", "sigmaE", "eps")})
                    key = (shape, kind, backend)
                    res[key, "steps"] = steps
                    res[key, "at"] = (mesh.m_index, mesh.n_index)
                    res[key, "rel_eps"] = rel_err(st.eps,
                                                  s.refresh_eps(st).eps)
                    res[key, "launches"] = solve.launches
                    res[key, "nr"] = s.nb_loc // s.split_blocks()
                    res[key, "s"] = time.perf_counter() - t0
                    res[key, "M"] = s.M
                    del s, st
        # 25e: chains over devices, each half a chain mesh of 2
        cmesh = bt.chain_mesh(2, group=half, device="cuda:0")
        gw = torch.Generator(device="cuda").manual_seed(29)
        words = bt.simulate.random_packed_words(gw, MESH25_M,
                                                MESH25_N // 16, device="cuda")
        stats = bt.simulate.packed_word_stats(MESH25_M)
        Yw = torch.randn(MESH25_N, generator=gw, device="cuda")
        for kind in ("bayesr", "horseshoe"):
            kw = dict(transposed=True, x_dtype="2bit", x_stats=stats,
                      device="cuda:0")
            s = (bt.SpikeSlabSampler(words, Yw, CVA, bt.BayesRConfig(), **kw)
                 if kind == "bayesr" else
                 bt.HorseshoeSampler(words, Yw, bt.HorseshoeConfig(), **kw))
            runner = bt.ChainParallelRunner(s, cmesh)
            chain = bt.ChainConfig(4, 2, 1)
            _, gathered = runner.run(
                torch.Generator(device="cuda").manual_seed(30),
                2 * CHAINS25, chain)
            from bayesrrcpp_tpu_torch.parallel import chain_streams

            _, local = s.run_chains(chain_streams(
                torch.Generator(device="cuda").manual_seed(30), rank % 2),
                CHAINS25, chain)
            res["chains", kind] = (gathered, local, s.jacobi)
            del s, runner
        dist.barrier()
    except Exception as e:  # noqa: BLE001 -- handed to the parent, which fails
        res = {"error": f"rank {rank}: {e!r}\n{traceback.format_exc()}"}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def mesh_phase(torch, tmp):
    """25d / 25e: four spawned gloo ranks on the one card (NCCL takes no two
    ranks on one device).  25d: dense N=4096 x M=8192 on (1, 2) (each half
    of the ranks) and (2, 2) meshes, both samplers, the split sweep and
    ``backend="xla"`` (its solve on the card, so on ``MESH25_XLA_M``
    markers), 3 steps: the replicated scalars bitwise equal on
    every rank of a mesh after every step, the eps n-slices on the ranks
    of an "m" group, tracked vs recomputed eps < 1e-4, the round solves
    one launch a round.  25e: chains over devices on each half, 4 fused
    chains a rank: every rank's chains bitwise equal to a one-rank
    ``run_chains`` of its streams.  A failure in a child fails the run."""
    import multiprocessing as mp
    import pickle

    import numpy as np

    port = free_port()
    outs = [os.path.join(tmp, f"mesh25_rank{r}.pkl") for r in range(4)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=mesh25_child, args=(r, port, outs[r]))
             for r in range(4)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    ranks = []
    for r, path in enumerate(outs):
        check(os.path.exists(path), f"[25d] rank {r} wrote no result (exit "
              f"code {procs[r].exitcode})")
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
        check("error" not in ranks[r], ranks[r].get("error", ""))
    log(f"[25d/25e] four ranks on one card, gloo all-reducing their CUDA "
        f"tensors ({wall:.1f} s with start-up)")
    for shape in ((1, 2), (2, 2)):
        m, n = shape
        for kind in ("bayesr", "horseshoe"):
            for backend in ("pallas", "xla"):
                key = (shape, kind, backend)
                at = [r[key, "at"] for r in ranks]
                check(at == [((i % (m * n)) // n, i % n) for i in range(4)],
                      f"[25d] {key} ranks at {at}")
                for i, r in enumerate(ranks):
                    for a, b in zip(ranks[0][key, "steps"], r[key, "steps"]):
                        for k in ("mu", "sigmaE"):
                            check(np.array_equal(a[k], b[k]),
                                  f"[25d] {key} rank {i}: {k} differs")
                    # the rank of the same n index in the first "m" group
                    for a, b in zip(ranks[i % n][key, "steps"],
                                    r[key, "steps"]):
                        check(np.array_equal(a["eps"], b["eps"]),
                              f"[25d] {key} rank {i}: eps differs across "
                              f"the m group")
                rels = [r[key, "rel_eps"] for r in ranks]
                check(max(rels) < 1e-4, f"[25d] {key} tracked eps {rels}")
                nr = ranks[0][key, "nr"]
                want = nr * MESH25_STEPS if backend == "pallas" else 0
                got = [r[key, "launches"] for r in ranks]
                check(got == [want] * 4, f"[25d] {key} round solves {got}")
                log(f"[25d] {m}x{n} {kind} {backend} M={ranks[0][key, 'M']}: "
                    f"scalars bitwise equal "
                    f"on every rank and eps on each m group after each of "
                    f"{MESH25_STEPS} steps, tracked vs recomputed eps "
                    f"{max(rels):.3g}, round solves {got}; "
                    f"{max(r[key, 's'] for r in ranks):.1f} s")
    for kind in ("bayesr", "horseshoe"):
        for h in (0, 2):
            g0 = ranks[h]["chains", kind][0]
            g1 = ranks[h + 1]["chains", kind][0]
            for k in g0:
                check(np.array_equal(g0[k], g1[k]),
                      f"[25e] {kind} gathered {k} differs between ranks")
            for i in (h, h + 1):
                local = ranks[i]["chains", kind][1]
                sl = slice((i % 2) * CHAINS25, (i % 2 + 1) * CHAINS25)
                for k in local:
                    check(np.array_equal(g0[k][:, sl], local[k]),
                          f"[25e] {kind} rank {i} {k}: not a one-rank "
                          f"run_chains of its streams")
        J = ranks[0]["chains", kind][2]
        log(f"[25e] {kind} chains over devices (J={J}): 2 x {CHAINS25} "
            f"fused chains, every rank's bitwise a one-rank run_chains of "
            f"its streams, the gathered (emits, {2 * CHAINS25}, M) rows "
            f"equal on both ranks of a chain mesh")


def split_phases(torch, bt, hs, tmp):
    """Phase 25 (module docstring): the sharded horseshoe's chunked #10 and
    its headline cell, the split sweep's #13 / #14 at the dense cell on a
    real one-rank NCCL group, then the (1, 2) / (2, 2) meshes and chains
    over devices as four gloo ranks.  Returns each site's launches from
    its sharded main path."""
    import torch.distributed as dist

    from bayesrrcpp_tpu_torch.parallel.distributed import initialize

    initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = bt.make_mesh(1, 1, device="cuda:0")
        check(mesh.group is not None, "[25] no process group")
        worst = sharded_hs_small(torch, bt, mesh)
        log(f"[25a] max |d| vs plain {worst:.3g}")
        hs_launches = sharded_hs_headline(torch, bt, hs, mesh, tmp)
        elapsed("25a-25b")
        solves = split_cell(torch, bt, mesh, tmp)
        elapsed("25c")
    finally:
        dist.destroy_process_group()
    # the ranks share the card: hand them what this process's allocator
    # holds cached
    torch.cuda.empty_cache()
    mesh_phase(torch, tmp)
    return {"horseshoe_serial_sweep": hs_launches,
            "bayesr_round_solve": solves["bayesr"],
            "horseshoe_round_solve": solves["horseshoe"]}


# ---------------------------------------------------------------- phase 26

# biobank-groups (bench.py:262-272): 4 annotation groups with their slab
# variances, marker m in group m % 4
GROUPS_CVA = ((0.0001, 0.001, 0.01), (0.0002, 0.002, 0.02),
              (0.0001, 0.001, 0.01), (0.0005, 0.005, 0.05))
GROUPS_F = 12        # the seeded covariates of biobank-groups' F=12 twin
SMALL_GROUPS_F = 3   # 26a / 26d / 26f's fixed effects


def covariates(N, F, seed):
    """(N, F) f32 fixed-effect covariates, standard normal from ``seed``."""
    import numpy as np

    return np.random.default_rng(seed).standard_normal((N, F)).astype(
        np.float32)


def grouped_sampler(bt, X, Y, M, N, F, cfg=None, seed=26, mesh=None, **kw):
    """The grouped sampler (variant "groups") on X with bench.py's four
    groups and ``F`` seeded covariates; the sharded one on ``mesh``."""
    import numpy as np

    common = dict(g_assign=np.arange(M) % 4,
                  fixed=covariates(N, F, seed) if F else None, **kw)
    cfg = cfg or bt.GroupsConfig()
    if mesh is not None:
        return bt.ShardedSpikeSlabSampler(X, Y, np.asarray(GROUPS_CVA), cfg,
                                          mesh, **common)
    return bt.SpikeSlabSampler(X, Y, np.asarray(GROUPS_CVA), cfg,
                               device="cuda", **common)


def check_bacc(torch, tag, a, b):
    """The sweep's per-group sum of slab beta^2 against the plain
    version's, to a relative 1e-5 in every group; returns the largest
    relative difference."""
    rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
    check(rel < 1e-5, f"{tag} bacc differs from plain: {rel:.3g} relative "
          f"({a.tolist()} vs {b.tolist()})")
    return rel


def groups_small(torch, bt, jt):
    """26a: every kernel of the grouped sampler's paths at G=4 against its
    plain version at N=4096 x M=8192, F=3, from a state warmed by 2 grouped
    steps: #1 (2-bit fold, ``miss``, dense, int8), #3 at C=8 (chain 0 also
    bitwise the single-chain kernel), #5 through the sharded sampler's
    chunk, #9 (2-bit fold, B=512, and the int8 ``_q`` decode, over the
    first ``SMALL_SERIAL_BLOCKS`` blocks), #11 at C=8, #13 through the
    split sweep (its first two rounds) and #16 (J=8, B=512); labels and v
    equal, bacc to a relative 1e-5, beta and eps as phases 2a / 10a / 21a.
    Each path's short run (``ChainConfig(2, 1, 1)``) with the launch counts
    reset just before gives its grouped launches.  Returns ({JSON kernel
    name: (caller, launches)}, worst |d| of the floats, worst bacc)."""
    import numpy as np

    from bayesrrcpp_tpu_torch.ops import jacobi as jr
    from bayesrrcpp_tpu_torch.ops import multichain as mcs
    from bayesrrcpp_tpu_torch.ops import serial as ser

    N, M, F = 4096, 8192, SMALL_GROUPS_F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    words = bt.simulate.random_packed_words(g, M, N // 16, device="cuda")
    mwords = bt.simulate.random_packed_words_missing(g, M, N // 16,
                                                     device="cuda")
    stats = bt.simulate.packed_word_stats(M)
    Y = torch.randn(N, generator=g, device=dev)
    codes = int8_codes(torch, words, N)
    qcodes = codes.clone()
    qcodes[torch.rand(codes.shape, generator=g, device=dev) < 2.0 ** -6] = 3
    X = dense_x(torch, g, N, M)
    packed = dict(transposed=True, x_dtype="2bit", x_stats=stats)
    int8 = dict(transposed=True, x_dtype="int8", x_stats=stats)
    big = bt.GroupsConfig(block_size=512)
    worst, worst_bacc, callers = 0.0, 0.0, {}
    cases = (
        ("#1 fold", words, packed, None, "t"),
        ("#1 miss", mwords, packed, None, "t"),
        ("#1 dense", X, dict(transposed=True, backend="pallas"), None, "t"),
        ("#1 int8", codes, int8, None, "t"),
        ("#9 fold", words, dict(packed, jacobi_blocks=1), big, "serial"),
        ("#9 int8 _q", qcodes, dict(int8, jacobi_blocks=1), big, "serial"),
        ("#16 row", words, dict(packed, jacobi_blocks=8), big, "row"))
    for tag, x, kw, cfg, path in cases:
        s = grouped_sampler(bt, x, Y, M, N, F, cfg, **kw)
        v = bt.TorchVariates(g)
        st = s._run_steps(s.init(v), v, 2)
        if path == "t":
            check((s.jacobi, s.B, s.jacobi_layout) == (32, 32, "t"),
                  f"[26a] {tag} plan {(s.jacobi, s.B, s.jacobi_layout)}")
            args, akw = sweep_args(s, st, v)
            fn, ref_fn = jt.bayesr_jacobi_t, jt.bayesr_jacobi_t_reference
        elif path == "serial":
            check((s.jacobi, s.B) == (1, 512), f"[26a] {tag} plan")
            args, akw = serial_args(s, st, v, SMALL_SERIAL_BLOCKS)
            fn, ref_fn = ser.bayesr_sweep, ser.bayesr_sweep_reference
        else:
            check((s.jacobi, s.B, s.jacobi_layout) == (8, 512, "row"),
                  f"[26a] {tag} plan")
            args, akw = row_args(s, st, v)
            fn, ref_fn = jr.bayesr_jacobi, jr.bayesr_jacobi_reference
        if tag == "#9 int8 _q":
            check(s.data.has_missing and not akw["fold_affine"],
                  "[26a] int8 _q mode")
        ker, ref = tuple(fn(*args, **akw)), tuple(ref_fn(*args, **akw))
        names = ("eps", "beta", "labels", "v", "beta_acum")
        worst = max(worst, check_sweeps(torch, f"[26a] {tag}", names, ker,
                                        ref))
        worst_bacc = max(worst_bacc, check_bacc(torch, f"[26a] {tag}",
                                                ker[4], ref[4]))
        fn.launches = 0
        s.run(g, bt.ChainConfig(2, 1, 1), collect=False)
        torch.cuda.synchronize()
        check(fn.launches > 0, f"[26a] {tag}: no launch")
        key = {"t": "jacobi_t_sweep", "serial": "bayesr_serial_sweep",
               "row": "bayesr_row_sweep"}[path]
        callers.setdefault(key, ("SpikeSlabSampler, variant groups", 0))
        callers[key] = (callers[key][0], callers[key][1] + fn.launches)
        log(f"[26a] {tag} G=4 F={F} (J={s.jacobi}, B={s.B}): labels, v "
            f"equal, bacc {ker[4].tolist()} (plain {ref[4].tolist()}), "
            f"launches of 2 steps {fn.launches}")
        # the fused chains on the strided and serial plans
        if tag in ("#1 fold", "#9 fold"):
            C = CHAINS
            vc = bt.TorchVariates(g, chains=C)
            stc = s.init(vc, chains=C)
            for _ in range(2):
                stc = s.step_chains(stc, vc)
            if path == "t":
                cargs, ckw = sweep_args(s, stc, vc)
                mfn, mref = jt.bayesr_jacobi_t_mc, \
                    jt.bayesr_jacobi_t_mc_reference
                one = chain_args(cargs, 0, BAYESR_CHAIN_ARGS)
                key, num = "jacobi_t_mc_sweep", "#3"
            else:
                cargs, ckw = serial_args(s, stc, vc, SMALL_SERIAL_BLOCKS)
                mfn, mref = mcs.bayesr_sweep_mc, mcs.bayesr_sweep_mc_reference
                one = single_chains(torch, cargs, "bayesr", 0)
                key, num = "bayesr_mc_serial_sweep", "#11"
            ker, ref = tuple(mfn(*cargs, **ckw)), tuple(mref(*cargs, **ckw))
            single = tuple(fn(*one, **ckw))
            worst = max(worst, check_sweeps(torch, f"[26a] {num} C={C}",
                                            names, ker, ref))
            for c in range(C):
                worst_bacc = max(worst_bacc, check_bacc(
                    torch, f"[26a] {num} chain {c}", ker[4][c], ref[4][c]))
            for name, a, b in zip(names, single, ker):
                check(torch.equal(a, b[0]), f"[26a] {num} chain 0 {name} "
                      f"differs from the single-chain kernel")
            mfn.launches = 0
            s.run_chains(g, C, bt.ChainConfig(2, 1, 1), collect=False)
            torch.cuda.synchronize()
            check(mfn.launches > 0, f"[26a] {num}: no launch")
            callers[key] = ("SpikeSlabSampler.run_chains, variant groups",
                            mfn.launches)
            log(f"[26a] {num} C={C} G=4 F={F}: labels, v equal, bacc within "
                f"1e-5 chain by chain, chain 0 bitwise the single-chain "
                f"kernel; launches of 2 fused steps {mfn.launches}")
        del s, st, args, ker, ref
    del codes, qcodes

    # #5 through the sharded sampler's chunk (a one-rank mesh), #13 through
    # the split sweep
    mesh = bt.make_mesh(1, 1, device="cuda")
    sh = grouped_sampler(bt, words, Y, M, N, F, mesh=mesh, backend="pallas",
                         **packed)
    check(sh.strided and sh._nrc(sh.nb // sh.jacobi) == sh.nb // sh.jacobi,
          "[26a] #5 plan")
    v = sh.variates(g)
    st = sh._run_steps(sh.init(v), v, 2)
    args, akw = sweep_args(sh, st, v)
    akw["nr_total"] = sh.nb // sh.jacobi
    ker = jt.bayesr_jacobi_t_rounds(*args, **akw)
    ref = jt.bayesr_jacobi_t_rounds_reference(*args, **akw)
    worst = max(worst, rounds_gates(torch, "[26a] #5", ker, ref))
    worst_bacc = max(worst_bacc, check_bacc(torch, "[26a] #5",
                                            ker.beta_acum, ref.beta_acum))
    jt.bayesr_jacobi_t_rounds.launches = 0
    sh.run(g, bt.ChainConfig(2, 1, 1), collect=False)
    torch.cuda.synchronize()
    callers["jacobi_t_rounds"] = ("ShardedSpikeSlabSampler, variant groups",
                                  jt.bayesr_jacobi_t_rounds.launches)
    log(f"[26a] #5 sharded groups: labels, v equal, bacc "
        f"{ker.beta_acum.tolist()}; launches of 2 steps "
        f"{jt.bayesr_jacobi_t_rounds.launches}")
    del sh, st, args, ker, ref

    sp = grouped_sampler(bt, X, Y, M, N, F, big, mesh=mesh,
                         backend="pallas", transposed=True, split_sweep=True)
    J = sp.split_blocks()
    v = sp.variates(g)
    st = sp._run_steps(sp.init(v), v, 2)
    v.begin_step()
    border, inner = v.loc.block_orders(sp.nb_loc, sp.B)
    p, z = v.loc.p(sp.Mloc), v.loc.z(sp.Mloc)
    by_block = torch.zeros_like(inner)
    by_block[border.long()] = inner
    d = sp.data
    pkg, inner_sel = jr.build_pkg_jacobi(
        d.xsq, d.g_assign, d.valid, p, z, st.pi, d.cva, st.sigmaE,
        st.sigmaGG, border, by_block, B=sp.B, J=J)
    beta, labels = st.beta.clone(), st.labels.clone()
    baccs = []

    def round_solve(i, r, blk, idx):
        nonlocal worst
        a = (r, d.gram[blk], beta[idx].view(J, sp.B),
             labels[idx].view(J, sp.B), d.g_assign[idx].view(J, sp.B),
             inner_sel[i], pkg[i], st.sigmaE)
        k, rf = (jr.bayesr_round_solve(*a, K=sp.K, G=sp.G),
                 jr.bayesr_round_solve_reference(*a, K=sp.K, G=sp.G))
        worst = max(worst, check_round_solve(torch, f"[26a] #13 round {i}",
                                             "bayesr", k, rf))
        if float(rf[4].abs().max()) > 0:
            baccs.append(check_bacc(torch, f"[26a] #13 round {i}",
                                    k[4], rf[4]))
        beta[idx] = k[1].reshape(-1)
        labels[idx] = k[2].reshape(-1)
        return k[0]

    sp._split_rounds(st.eps, border[:2 * J], round_solve)
    worst_bacc = max([worst_bacc] + baccs)
    jr.bayesr_round_solve.launches = 0
    sp.run(g, bt.ChainConfig(2, 1, 1), collect=False)
    torch.cuda.synchronize()
    callers["bayesr_round_solve"] = (
        "ShardedSpikeSlabSampler split sweep, variant groups",
        jr.bayesr_round_solve.launches)
    check(jr.bayesr_round_solve.launches == 2 * sp.nb_loc // J,
          f"[26a] #13 launches {jr.bayesr_round_solve.launches}")
    log(f"[26a] #13 split sweep G=4 F={F} (J={J}, B={sp.B}): 2 rounds' "
        f"solves vs plain, launches of 2 steps "
        f"{jr.bayesr_round_solve.launches}")
    del sp, st, X, words, mwords
    return callers, worst, worst_bacc


def groups_phases(torch, bt, hs, tmp, ms_iter_4):
    """Phase 26 (module docstring): the grouped sampler with fixed effects
    and its warm restart.  26a ``groups_small``; 26b biobank-groups and its
    F=12 twin on the headline words of ``hs`` (phase 2's); 26c 8 fused
    grouped chains there; 26d bitwise resume from a checkpoint; 26e the
    restart from 26b's CSV; 26f the CLI.  Returns {JSON kernel name:
    (grouped caller, launches)}."""
    import numpy as np

    from bayesrrcpp_tpu_torch import cli
    from bayesrrcpp_tpu_torch.io.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from bayesrrcpp_tpu_torch.io.resume import (parse_last_row,
                                                state_kwargs_from_csv)
    from bayesrrcpp_tpu_torch.io.sink import ChainFanoutSink, CSVSink, \
        csv_header
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
    from bayesrrcpp_tpu_torch.ops.jacobi_t import LAUNCHES_PER_ROUND

    t26 = time.perf_counter()
    callers, worst, worst_bacc = groups_small(torch, bt, jt)
    log(f"[26a] max |d| vs plain {worst:.3g}, largest bacc relative "
        f"difference {worst_bacc:.3g} ({time.perf_counter() - t26:.1f} s)")
    elapsed("26a")

    # ---- 26b. biobank-groups and its F=12 twin, on phase 2's words
    dev = torch.device("cuda")
    N, M = HEADLINE_N, HEADLINE_M
    words, Y = hs.data.XT, hs.Y[:N]
    packed = dict(transposed=True, x_dtype="2bit",
                  x_stats=bt.simulate.packed_word_stats(M))
    chain = bt.ChainConfig(10, 5, 5)
    ms, paths = {}, {}
    for F in (0, GROUPS_F):
        t0 = time.perf_counter()
        s = grouped_sampler(bt, words, Y, M, N, F, **packed)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check(s.data.XT.data_ptr() == words.data_ptr(), "[26b] words copied")
        check((s.variant, s.G, s.F, s.jacobi, s.B, s.jacobi_layout) ==
              ("groups", 4, F, 128, 32, "t"), "[26b] plan")
        nr = s.nb // s.jacobi
        g = torch.Generator(device=dev).manual_seed(260 + F)
        path = os.path.join(tmp, f"groups_f{F}.csv")
        st, out, wall, launches, peak = main_path(
            torch, lambda sk: s.run(g, chain, sink=sk),
            CSVSink(path, "groups", M=M, N=N, groups=4, F=F),
            jt.bayesr_jacobi_t)
        with open(path) as f:
            head = f.readline()
        check(head == csv_header("groups", M, N, 4, F),
              f"[26b] F={F} header is not the groups schema's")
        header, widths, bad = read_csv(path)
        check(widths == [len(header)] and not bad,
              f"[26b] F={F} row widths {widths} of {len(header)}, bad {bad}")
        check(all(np_finite(out[k]) for k in ("mu", "beta", "sigmaE",
                                              "sigmaG", "alpha", "sigmaF")),
              f"[26b] F={F} non-finite output")
        rel = rel_err(st.eps, s.refresh_eps(st).eps)
        want = LAUNCHES_PER_ROUND * nr * chain.max_iterations
        check(rel < 1e-4, f"[26b] F={F} tracked eps vs recompute {rel}")
        check(launches == want, f"[26b] F={F} launches {launches} != {want}")
        cell = "biobank-groups" + (f"-f{F}" if F else "")
        ms[cell] = CELL_MS[cell] = wall / chain.max_iterations * 1e3
        paths[F] = path
        log(f"[26b] {cell} (G=4, F={F}, sampler {setup_s:.2f} s): "
            f"{ms[cell]:.2f} ms/iter ({wall:.2f} s for "
            f"{chain.max_iterations} iterations incl. a {len(header)}-value "
            f"CSV row), biobank-packed-auto {ms_iter_4:.2f} ms/iter in this "
            f"run; peak {peak:.2f} GiB, launches {launches} (want {want}), "
            f"tracked-vs-exact eps (fixed term included) {rel:.3g}, "
            f"sigmaG {st.sigmaGG.tolist()}, sigmaF {float(st.sigmaF):.4g}; "
            f"{CARD}")
        callers["jacobi_t_sweep"] = (
            "SpikeSlabSampler, variant groups (biobank-groups)", launches)
        names = ("dot_kernel", "solve_kernel", "apply_kernel")
        split, dev_ms, wall_ms = profile_split(
            torch, Steps(s, st, bt.TorchVariates(g)), names, want=2 * nr)
        check(profiled(split, 2 * nr), f"[26b] profiled launches {split}")
        log(f"[26b] {cell} profile of 2 steps: " + ", ".join(
            f"{n} {us:.2f} us x {c}" for n, (us, c) in split.items())
            + f"; device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall (idle "
            f"{1 - dev_ms / wall_ms:.1%})")
        if F:
            break
        # ---- 26e. BRV2Grstart's restart from 26b's CSV (init_from on the
        # words: the API entry point takes dense X)
        t0 = time.perf_counter()
        kw = state_kwargs_from_csv(path)
        parse_s = time.perf_counter() - t0
        g2 = torch.Generator(device=dev).manual_seed(265)
        st2 = s.init_from(g2, **kw)
        eps_csv = torch.as_tensor(kw["epsilon"], dtype=torch.float32,
                                  device=dev)
        check(torch.equal(st2.eps[:N], eps_csv),
              "[26e] restart eps differs from the CSV's")
        check(float(out["epsilon"][-1][0]) == float(kw["epsilon"][0]),
              "[26e] the CSV's eps is not the emitted row's")
        check(bool(torch.allclose(st2.pi.sum(-1), torch.ones(4, device=dev),
                                  rtol=1e-6)), f"[26e] pi rows {st2.pi}")
        rpath = os.path.join(tmp, "grstart.csv")
        st3, out, wall, launches, _ = main_path(
            torch, lambda sk: s.run(g2, bt.ChainConfig(5, 1, 1), state=st2,
                                    sink=sk),
            CSVSink(rpath, "grstart", M=M, N=N, groups=4),
            jt.bayesr_jacobi_t)
        header, widths, bad = read_csv(rpath)
        check(widths == [len(header)] * 4 and not bad,
              f"[26e] grstart widths {widths}")
        rel = rel_err(st3.eps, s.refresh_eps(st3).eps)
        check(rel < 1e-4, f"[26e] tracked eps vs recompute {rel}")
        log(f"[26e] restart from the {len(header)}-value grstart-width row "
            f"(parsed in {parse_s:.2f} s): eps equal to the CSV's printed "
            f"values (the sink prints each f32 as its shortest "
            f"round-trip decimal), pi rows sum to 1, 5 iterations "
            f"{wall / 5 * 1e3:.2f} ms/iter, launches {launches}, "
            f"tracked-vs-exact eps {rel:.3g}")
        del s, st, st2, st3, out
    elapsed("26b, 26e")

    # ---- 26c. 8 fused grouped chains, F=12, 3 iterations
    C = CHAINS
    g = torch.Generator(device=dev).manual_seed(266)
    v = bt.TorchVariates(g, chains=C)
    stc = s.init(v, chains=C)
    jt.bayesr_jacobi_t_mc.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        stc = s.step_chains(stc, v)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = jt.bayesr_jacobi_t_mc.launches
    want = LAUNCHES_PER_ROUND * nr * 3
    check(launches == want, f"[26c] launches {launches} != {want}")
    check(all(bool(torch.isfinite(x).all()) for x in
              (stc.beta, stc.eps, stc.alpha, stc.sigmaGG)),
          "[26c] non-finite state")
    args, akw = sweep_args(s, stc, v)
    ker = tuple(jt.bayesr_jacobi_t_mc(*args, **akw))
    one = tuple(jt.bayesr_jacobi_t(*chain_args(args, 0, BAYESR_CHAIN_ARGS),
                                   **akw))
    for name, a, b in zip(("eps", "beta", "labels", "v", "beta_acum"), one,
                          ker):
        check(torch.equal(a, b[0]), f"[26c] chain 0 {name} differs from the "
              f"single-chain kernel")
    ms["biobank-groups-8chain-f12"] = wall / 3 * 1e3
    callers["jacobi_t_mc_sweep"] = (
        "SpikeSlabSampler.step_chains, variant groups (8 chains, F=12)",
        launches)
    log(f"[26c] 8 fused grouped chains (F={GROUPS_F}): {wall / 3 * 1e3:.2f} "
        f"ms/iter, launches {launches} (want {want}); chain 0 bitwise the "
        f"single-chain kernel; {CARD}")
    del s, stc, args, ker, one
    elapsed("26c")

    # ---- 26d. bitwise resume on the card
    Ns, Ms = 4096, 8192
    gw = torch.Generator(device=dev).manual_seed(267)
    swords = bt.simulate.random_packed_words(gw, Ms, Ns // 16, device="cuda")
    sY = torch.randn(Ns, generator=gw, device=dev)
    small = dict(transposed=True, x_dtype="2bit",
                 x_stats=bt.simulate.packed_word_stats(Ms))
    for kind in ("groups", "horseshoe"):
        def make():
            if kind == "groups":
                return grouped_sampler(bt, swords, sY, Ms, Ns,
                                       SMALL_GROUPS_F, **small)
            return bt.HorseshoeSampler(swords, sY, bt.HorseshoeConfig(),
                                       device="cuda", **small)

        s = make()
        kw = dict(groups=4, F=SMALL_GROUPS_F) if kind == "groups" else {}
        rows = {}
        for part, n in (("full", 6), ("a", 3)):
            g = torch.Generator(device=dev).manual_seed(268)
            path = os.path.join(tmp, f"resume_{kind}_{part}.csv")
            sink = CSVSink(path, kind, M=Ms, N=Ns, **kw)
            st, _ = s.run(g, bt.ChainConfig(n, 1, 1), sink=sink,
                          collect=False)
            sink.close()
            rows[part] = open(path).read().split("\n")[1:]
            if part == "full":
                full = st
            else:
                ck = os.path.join(tmp, f"resume_{kind}.npz")
                save_checkpoint(ck, st, g)
        s2 = make()
        st, g2 = load_checkpoint(ck)
        check(st.iteration == 3 and g2.device.type == "cuda",
              "[26d] checkpoint")
        path = os.path.join(tmp, f"resume_{kind}_b.csv")
        sink = CSVSink(path, kind, M=Ms, N=Ns, **kw)
        st, _ = s2.run(g2, bt.ChainConfig(3, 1, 1),
                       state=st.replace(iteration=0), sink=sink,
                       collect=False)
        sink.close()
        rows["b"] = open(path).read().split("\n")[1:]
        for f in full.__dataclass_fields__:
            if f != "iteration":
                check(torch.equal(getattr(full, f), getattr(st, f)),
                      f"[26d] {kind}: resumed {f} differs")

        def values(rs):
            return [r.split(", ")[1:] for r in rs if r]

        check(values(rows["a"] + rows["b"])
              == values(rows["full"][:2] + rows["full"][3:]),
              f"[26d] {kind}: resumed CSV rows differ")
        log(f"[26d] {kind} N={Ns} M={Ms}: 3 + checkpoint + 3 iterations "
            f"bitwise the uninterrupted 6 (every state field, every CSV "
            f"value)")
        del s, s2, st, full
    elapsed("26d")

    # ---- 26f. the CLI: groups, resume --checkpoint, resume --from-csv
    t0 = time.perf_counter()
    X = dense_x(torch, gw, Ns, Ms).T.contiguous().cpu().numpy()
    files = {k: os.path.join(tmp, f"cli26_{k}") for k in
             ("x.npy", "y.npy", "g.txt", "f.npy", "ck", "g.csv", "r.csv",
              "c.csv")}
    np.save(files["x.npy"], X)
    np.save(files["y.npy"], sY.cpu().numpy())
    np.savetxt(files["g.txt"], np.arange(Ms) % 4, fmt="%d")
    np.save(files["f.npy"], covariates(Ns, SMALL_GROUPS_F, 269))
    common = ["--x", files["x.npy"], "--y", files["y.npy"], "--iterations",
              "4", "--burn-in", "2", "--thinning", "2", "--groups-file",
              files["g.txt"], "--fixed", files["f.npy"], "--x-dtype",
              "dense"]
    widths = {}
    for argv, out in ((["groups", "--checkpoint-out", files["ck"]], "g.csv"),
                      (["resume", "--checkpoint", files["ck"] + ".npz"],
                       "r.csv"),
                      (["resume", "--from-csv", files["g.csv"]], "c.csv")):
        jt.bayesr_jacobi_t.launches = 0
        check(cli.main(argv + ["--out", files[out]] + common) == 0,
              f"[26f] {argv[0]} failed")
        torch.cuda.synchronize()
        header, w, bad = read_csv(files[out])
        check(header == csv_header("groups", Ms, Ns, 4,
                                   SMALL_GROUPS_F).rstrip("\n").split(",")
              and w == [len(header)] and not bad,
              f"[26f] {' '.join(argv[:2])}: widths {w} of {len(header)}")
        check(jt.bayesr_jacobi_t.launches > 0, f"[26f] {argv[0]}: no launch")
        widths[" ".join(argv[:2])] = (len(header),
                                      jt.bayesr_jacobi_t.launches)
    row = parse_last_row(files["c.csv"])
    check(row["alpha"].size == SMALL_GROUPS_F and row["sigmaG"].size == 4,
          "[26f] the resumed CSV's alpha / sigmaG")
    log(f"[26f] CLI groups / resume --checkpoint / resume --from-csv on "
        f"dense N={Ns} x M={Ms} (G=4, F={SMALL_GROUPS_F}) on the card: "
        + ", ".join(f"{k}: width {w}, #1 launches {n}"
                    for k, (w, n) in widths.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    log("[26] ms/iter: " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
        + f"; biobank-packed-auto {ms_iter_4:.2f}; {CARD}")
    return callers


# ---------------------------------------------------------------- phase 27

SCAN_N, SCAN_M = 4096, 1024   # 27b / 27c: the plain float64 paths' size
SCAN_STEPS = 2                # blocked vs scan (27b)
# 27b's samplers resumed from a checkpoint: the groups variant's state holds
# every field of BayesR's (alpha and sigmaF too), so BayesR's own resume
# would add a scan step (~1.7 s) and no field
RESUMED = ("horseshoe", "groups")
# the keys of JAX's ``summarize`` JSON for two BayesR chains with --x / --y
# (bayesrrcpp_tpu/cli.py:458-490; tests/test_torch_sinks_cli.py holds the
# port's JSON equal to JAX's on the CPU)
SUMMARY_KEYS = ["n_samples", "n_chains", "mu_mean", "sigmaE_mean",
                "sigmaF_mean", "h2_mean", "h2_sd", "top_markers", "pve",
                "rhat_sigmaE", "ess_sigmaE", "rhat_mu", "ess_mu"]
DECILE_LINE = r"^emitted \d+/\d+: tau \S+ eta \S+ sigmaE \S+$"


class TapeVariates:
    """A variates object recording the draws of ``inner`` (a
    ``TorchVariates``) role by role, or, with ``inner`` None, replaying the
    recording ``tape``: two samplers that ask for the same roles take the
    same draws (27c)."""

    def __init__(self, inner=None, tape=None):
        self.inner, self.tape = inner, [] if tape is None else list(tape)

    def __getattr__(self, role):
        if self.inner is None:
            def replay(*args, **kw):
                r, out = self.tape.pop(0)
                check(r == role, f"[27c] replay asked for {role}, tape {r}")
                return out
            return replay
        draw = getattr(self.inner, role)

        def record(*args, **kw):
            out = draw(*args, **kw)
            self.tape.append((role, out))
            return out
        return record


def exact_eps(torch, s, st):
    """eps = Y - mu - X beta (- alpha F) in float64 on the card, for a
    dense float64 sampler (``refresh_eps`` runs in float32, as JAX's)."""
    d = s.data
    eps = s.Y - st.mu - st.beta @ d.XT
    if getattr(s, "F", 0):
        eps = eps - st.alpha @ d.fixedT
    return eps


def same_state(torch, a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in a.__dataclass_fields__ if f != "iteration")


def timed_steps(torch, s, st, g, n):
    """``n`` steps of ``s`` from ``st`` with generator ``g``: (state, ms a
    step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        st = s.step(st, g)
    torch.cuda.synchronize()
    return st, (time.perf_counter() - t0) / n * 1e3


def scan_phases(torch, bt, tmp):
    """Phase 27 (module docstring): (a) the CLI's --no-standardize,
    --npz-out and summarize at dense-16kx49k, and the horseshoe's deciles;
    (b) float64 through the blocked and scan sweeps on the card; (c) the
    sharded ``backend="xla"`` sampler in float64 on a one-rank NCCL mesh.
    Returns the phase's seconds."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch.distributed as dist

    from bayesrrcpp_tpu_torch import cli
    from bayesrrcpp_tpu_torch.io.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from bayesrrcpp_tpu_torch.io.sink import assemble_rows
    from bayesrrcpp_tpu_torch.ops import jacobi_t as jt
    from bayesrrcpp_tpu_torch.parallel.distributed import initialize

    t27 = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 27a. the CLI at the dense cell: run --no-standardize --npz-out
    # (f32, the auto plan) twice, summarize the two, then the horseshoe
    g = torch.Generator(device=dev).manual_seed(27)
    X = dense_x(torch, g, DENSE_N, DENSE_M)
    Y = torch.randn(DENSE_N, generator=g, device=dev) + X[:64].sum(0) * 0.1
    d27 = tempfile.mkdtemp(dir=tmp)
    xp, yp = os.path.join(d27, "x.npy"), os.path.join(d27, "y.npy")
    t0 = time.perf_counter()
    # (N, M) in Fortran order: the CLI's X.T is then C-contiguous, so the
    # sampler lays it out with no transposed host copy
    np.save(xp, X.cpu().numpy().T)
    np.save(yp, Y.cpu().numpy())
    save_s = time.perf_counter() - t0
    del X
    torch.cuda.empty_cache()
    nr = DENSE_M // 32 // 128
    chain = ["--iterations", "10", "--burn-in", "2", "--thinning", "2",
             "--no-standardize"]
    n_rows = len(list(bt.ChainConfig(10, 2, 2).emit_iterations()))
    runs = {}
    for kind, seed, counter in (("bayesr", 1, jt.bayesr_jacobi_t),
                                ("bayesr", 2, jt.bayesr_jacobi_t),
                                ("horseshoe", 3, jt.horseshoe_jacobi_t)):
        out = os.path.join(d27, f"{kind}{seed}.csv")
        npz = os.path.join(d27, f"{kind}{seed}.npz")
        buf = io.StringIO()
        torch.cuda.synchronize()
        counter.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([kind, "--x", xp, "--y", yp, "--out", out,
                           "--npz-out", npz, "--seed", str(seed), *chain])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counter.launches
        check(rc == 0 and launches == 3 * nr * 10,
              f"[27a] {kind} seed {seed}: rc {rc}, launches {launches}")
        with open(out) as f:
            header = f.readline().rstrip("\n").split(",")
            rows = np.array([[float(v) for v in r.split(", ")]
                             for r in f.read().split("\n") if r])
        with np.load(npz) as z:
            cols = {k: z[k] for k in z.files}
        check(rows.shape == (n_rows, len(header))
              and len(header) == 4 + 2 * DENSE_M + DENSE_N,
              f"[27a] {kind} CSV {rows.shape}")
        check(np.array_equal(rows.astype(np.float32),
                             assemble_rows(kind, cols).astype(np.float32)),
              f"[27a] {kind} seed {seed}: the .npz columns differ from the "
              f"CSV rows")
        check(np.isfinite(rows).all(), f"[27a] {kind} non-finite values")
        runs[kind, seed] = (npz, wall, launches, buf.getvalue())
        log(f"[27a] {kind} --x x.npy (dense-16kx49k, N={DENSE_N}, "
            f"M={DENSE_M}) --no-standardize --npz-out, seed {seed}: "
            f"{wall:.2f} s for 10 iterations, CSV and .npz {rows.shape}, "
            f"columns equal, #{1 if kind == 'bayesr' else 2} launches "
            f"{launches}; {CARD}")
    deciles = [ln for ln in runs["horseshoe", 3][3].splitlines()
               if re.match(DECILE_LINE, ln)]
    check(len(deciles) >= 1, "[27a] horseshoe decile lines")
    for ln in deciles:
        log(f"[27a]   {ln}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["summarize", "--npz", runs["bayesr", 1][0], "--npz",
                       runs["bayesr", 2][0], "--x", xp, "--y", yp, "--top",
                       "10"])
    summ = json.loads(buf.getvalue())
    check(rc == 0 and list(summ) == SUMMARY_KEYS
          and len(summ["top_markers"]) == 10,
          f"[27a] summarize keys {list(summ)}")
    log(f"[27a] summarize --npz a --npz b --x --y --top 10 "
        f"({time.perf_counter() - t0:.2f} s): keys JAX's, pve "
        f"{summ['pve']}, h2 {summ['h2_mean']:.4f}, rhat_sigmaE "
        f"{summ['rhat_sigmaE']}; .npy written in {save_s:.2f} s")
    elapsed("27a")

    # ---- 27b. float64 on the card: blocked vs scan, the full permutation,
    # exact eps, checkpoint and resume; BayesR, the horseshoe, groups F=3
    f64 = torch.float64
    g = torch.Generator(device=dev).manual_seed(271)
    Xs = dense_x(torch, g, SCAN_N, SCAN_M).to(f64)
    Ys = (torch.randn(SCAN_N, generator=g, device=dev, dtype=f64)
          + Xs[:32].sum(0) * 0.2)
    common = dict(transposed=True, dtype=f64)

    def sampler(kind, **kw):
        if kind == "horseshoe":
            return bt.HorseshoeSampler(Xs, Ys, bt.HorseshoeConfig(
                block_size=64), device="cuda", **common, **kw)
        if kind == "groups":
            return grouped_sampler(bt, Xs, Ys, SCAN_M, SCAN_N, SMALL_GROUPS_F,
                                   cfg=bt.GroupsConfig(block_size=64),
                                   seed=272, **common, **kw)
        return bt.SpikeSlabSampler(Xs, Ys, CVA, bt.BayesRConfig(
            block_size=64), device="cuda", **common, **kw)

    ms, tape, unsharded = {}, None, None
    for kind in ("bayesr", "horseshoe", "groups"):
        states = {}
        for backend, perm in (("blocked", None), ("scan", "blocked")):
            s = sampler(kind, backend=backend, permutation=perm)
            gk = torch.Generator(device=dev).manual_seed(273)
            v = bt.TorchVariates(gk, f64)
            if kind == "bayesr" and backend == "blocked":
                v = TapeVariates(v)
            st1, ms1 = timed_steps(torch, s, s.init(v), v, 1)
            if isinstance(v, TapeVariates):
                # 27c replays the init and the first step
                tape, unsharded = list(v.tape), (s, st1)
            if backend == "scan" and kind in RESUMED:
                # the checkpoint after the first step (27b's resume)
                ck = os.path.join(d27, f"{kind}.npz")
                save_checkpoint(ck, st1, gk)
            st, ms2 = timed_steps(torch, s, st1, v, SCAN_STEPS - 1)
            ms[kind, backend, perm] = (ms1 + ms2 * (SCAN_STEPS - 1)) \
                / SCAN_STEPS
            check(st.eps.dtype == st.beta.dtype == f64 and st.eps.is_cuda,
                  f"[27b] {kind} {backend}: state {st.eps.dtype}")
            rel = float(torch.linalg.norm(st.eps - exact_eps(torch, s, st))
                        / torch.linalg.norm(st.eps))
            check(rel < 1e-10, f"[27b] {kind} {backend}: tracked vs exact "
                  f"eps {rel}")
            states[backend] = (s, st, st1, rel)
        (_, b, _, rel_b), (ss, sc, sc1, rel_s) = (states["blocked"],
                                                  states["scan"])
        if kind != "horseshoe":
            check(torch.equal(b.labels, sc.labels), f"[27b] {kind} labels")
        worst = 0.0
        for f in b.__dataclass_fields__:
            x, y = getattr(b, f), getattr(sc, f)
            if isinstance(x, torch.Tensor) and x.is_floating_point() \
                    and x.numel():
                check(torch.allclose(x, y, rtol=1e-8, atol=1e-10),
                      f"[27b] {kind} blocked vs scan {f}")
                worst = max(worst, float((x - y).abs().max()))
        # resume on the scan: the checkpoint after the first step, loaded,
        # then the other steps, against the uninterrupted run
        resumed = "no resume"
        if kind in RESUMED:
            st_r, g_r = load_checkpoint(ck)
            check(same_state(torch, sc1, st_r) and st_r.beta.dtype == f64,
                  f"[27b] {kind} checkpoint round trip")
            st_r, _ = timed_steps(torch, ss, st_r, g_r, SCAN_STEPS - 1)
            check(same_state(torch, sc, st_r), f"[27b] {kind} resume")
            resumed = "checkpoint and resume bitwise"
        # the full permutation
        sf = sampler(kind, backend="scan")
        check(sf.permutation == "full", "[27b] scan default permutation")
        gf = torch.Generator(device=dev).manual_seed(274)
        stf = sf.init(gf)
        stf, ms[kind, "scan", "full"] = timed_steps(torch, sf, stf, gf, 1)
        rel_f = float(torch.linalg.norm(stf.eps - exact_eps(torch, sf, stf))
                      / torch.linalg.norm(stf.eps))
        check(rel_f < 1e-10 and bool(torch.isfinite(stf.beta).all()),
              f"[27b] {kind} full permutation eps {rel_f}")
        log(f"[27b] {kind} float64 N={SCAN_N} M={SCAN_M} (B=64): blocked "
            f"{ms[kind, 'blocked', None]:.1f} ms/iter, scan (blocked "
            f"permutation) {ms[kind, 'scan', 'blocked']:.1f}, scan (full) "
            f"{ms[kind, 'scan', 'full']:.1f}; blocked vs scan after "
            f"{SCAN_STEPS} steps max |d| {worst:.3g}; tracked vs exact eps "
            f"{rel_b:.3g} / {rel_s:.3g} / {rel_f:.3g}; {resumed}; {CARD}")
        del states, ss, sc, sc1, sf, b
    elapsed("27b")

    # ---- 27c. the sharded backend="xla" sampler in float64 on a one-rank
    # NCCL mesh, replaying the init and first step of 27b's BayesR blocked
    # run: bitwise that run.  The sharded sweep takes its within-block orders by
    # sweep position (JAX's sharded.py), the unsharded one by block id
    # (bayesr.py:619), so the replayed orders are re-keyed by position
    tape = [(r, (o[0], o[1][o[0].long()]) if r == "block_orders" else o)
            for r, o in tape]
    initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = bt.make_mesh(1, 1, device="cuda:0")
        check(mesh.group is not None, "[27c] no process group")
        sh = bt.ShardedSpikeSlabSampler(
            Xs, Ys, CVA, bt.BayesRConfig(block_size=64), mesh,
            backend="xla", dtype=f64, transposed=True)
        ref, st0 = unsharded
        check((sh.Mpad, sh.B, sh.dtype) == (ref.Mpad, ref.B, f64),
              "[27c] plan")
        v = TapeVariates(tape=tape)
        st = sh.init(v)
        st, ms_sh = timed_steps(torch, sh, st, v, 1)
        check(not v.tape, "[27c] draws left on the tape")
        for f in ("mu", "sigmaE", "sigmaGG", "pi", "beta", "labels", "eps"):
            check(torch.equal(getattr(st, f), getattr(st0, f)),
                  f"[27c] sharded {f} differs from the unsharded run")
        log(f"[27c] ShardedSpikeSlabSampler(backend='xla', dtype=float64) "
            f"on a one-rank NCCL mesh, N={SCAN_N} M={SCAN_M}: "
            f"{ms_sh:.1f} ms for a step, every state field bitwise the "
            f"unsharded blocked run's "
            f"({ms['bayesr', 'blocked', None]:.1f} ms/iter); {CARD}")
        del sh, ref, st, st0
    finally:
        dist.destroy_process_group()
    secs = time.perf_counter() - t27
    log(f"[27] {secs:.1f} s")
    return secs


def np_finite(a):
    import numpy as np

    return bool(np.isfinite(np.asarray(a)).all())


if __name__ == "__main__":
    sys.exit(main())
