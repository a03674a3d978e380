"""Multi-device dry run of the port (counterpart of
``__graft_entry__.dryrun_multichip`` and its multi-host leg).

``dryrun_multichip(n_devices)`` spawns ``n_devices`` ranks, factors the
count into an (m, n) mesh as the JAX dry run does ((n/2, 2) when even,
else (n, 1)), and every rank runs the same seven cases at the same tiny
shapes, each asserting that its outputs are finite:

1. the grouped sharded sampler with fixed effects on the (m, n) mesh
   (``backend="xla"``): ``step``, then ``run(ChainConfig(4, 2, 1))``;
2. 2-bit words from host dosages on an (n_devices, 1) mesh through the
   kernels (the serial chunks, #9);
3. chains over devices: ``ChainParallelRunner`` on a chain mesh of all
   ranks, 2 chains a rank (the fused serial sweep, #11);
4. the sharded fused multi-chain sampler (groups, fixed effects) on an
   (n_devices, 1) mesh, ``step_chains`` of 2;
5. the same on the strided rounds: M = 2,048 * n_devices markers, so that
   each slice's plan is "t" (``jacobi > 1`` asserted; #6);
6. the split sweep on an (n/2, 2) mesh (``_split`` asserted; #13);
7. the one-device ``jacobi_blocks=2`` sampler (the row layout, #16).

Beside them, the multi-host leg (``multihost_leg``): the problem of
tests/test_multihost.py (``make_problem``, its own copy of the numpy
recipe) on a 2-rank mesh, 3 steps of the sharded groups sampler with full
X and with each rank's own marker slab (``x_process_shard=True``),
launched once by ``python -m torch.distributed.run --standalone
--nproc_per_node=2`` (the ranks join with ``initialize()``, which reads
torchrun's environment) and once over ``tcp://``: each rank's gathered
state must equal the other's, and the torchrun launch the tcp one,
bitwise.  A failure in any rank raises; nothing is skipped.

Ranks run gloo on the CPU.  On the card, ranks that share one card use
gloo over CUDA tensors (NCCL takes no two ranks on one device); with a
card for every rank they use NCCL, rank r on card r.

    python -m bayesrrcpp_tpu_torch.tools.dryrun [n_devices] [--device cpu]
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CVA = (0.001, 0.01, 0.1)
MULTIHOST_MODES = ("global", "shard")
MULTIHOST_STEPS = 3


def mesh_shape(n_devices: int):
    """The (m, n) mesh of the dry run: markers x individuals."""
    return (n_devices // 2, 2) if n_devices % 2 == 0 else (n_devices, 1)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(target, world, out_dir, timeout, args=()):
    """Run ``target(rank, world, port, out_path, *args)`` in ``world``
    spawned processes (a free localhost port for their group); each rank
    pickles its result to its ``out_path``.  Returns the ranks' results in
    rank order.  Raises when a rank fails (its traceback is on its
    standard error), writes no result or still runs after ``timeout``
    seconds; the ranks left running are killed."""
    import multiprocessing as mp

    port = _free_port()
    ctx = mp.get_context("spawn")
    outs = [os.path.join(out_dir, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, world, port, outs[r]) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline \
            and not any(p.exitcode for p in procs):
        time.sleep(0.05)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    for p in procs:
        p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode and p not in alive]
    if failed:
        raise RuntimeError(f"rank(s) {failed} failed (exit codes "
                           f"{[procs[r].exitcode for r in failed]})")
    if alive:
        raise RuntimeError(f"{len(alive)} rank(s) still running after "
                           f"{timeout} s")
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def _rank_device(device_type: str, rank: int) -> str:
    import torch

    if device_type == "cpu":
        return "cpu"
    return f"cuda:{rank % torch.cuda.device_count()}"


def _group_backend(device_type: str, world: int) -> str:
    import torch

    if device_type == "cpu" or world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def _finite(*ts) -> bool:
    import torch

    return all(bool(torch.isfinite(torch.as_tensor(t)).all()) for t in ts)


def _check(cond, msg):
    if not cond:
        raise AssertionError(f"dryrun: {msg}")


def _counters():
    """The kernel wrappers the cases reach, by name: their launch counts
    (a wrapper counts its CUDA launches only)."""
    from ..ops import jacobi as jr
    from ..ops import jacobi_t as jt
    from ..ops import multichain as mc
    from ..ops import serial as ser

    return {f.__name__: f for f in (
        jt.bayesr_jacobi_t, jt.bayesr_jacobi_t_mc, jt.bayesr_jacobi_t_rounds,
        jt.bayesr_jacobi_t_mc_rounds, ser.bayesr_sweep, mc.bayesr_sweep_mc,
        jr.bayesr_round_solve, jr.bayesr_jacobi)}


def run_cases(n_devices: int, device) -> list:
    """The seven cases on this rank (every rank of a group of
    ``n_devices`` calls it); returns one record a case: its name, what it
    ran and the kernels' launches."""
    import torch

    from .. import simulate
    from ..config import BayesRConfig, ChainConfig, GroupsConfig
    from ..models.bayesr import SpikeSlabSampler
    from ..parallel import (ChainParallelRunner, ShardedSpikeSlabSampler,
                            chain_mesh, make_mesh)

    f32 = torch.float32
    counters = _counters()
    m, n = mesh_shape(n_devices)
    B = 8
    cva = np.array(CVA)
    cva2 = np.tile(cva, (2, 1))
    sim = simulate.simulate_bayesr(seed=1, N=16 * n, M=2 * B * m, n_causal=8,
                                   h2=0.5, n_groups=2, n_fixed=2)
    out = []

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def case(name, fn):
        for f in counters.values():
            f.launches = 0
        rec = fn()
        rec["case"] = name
        rec["launches"] = {k: f.launches for k, f in counters.items()
                           if f.launches}
        out.append(rec)

    def grouped():
        # the full sharded step, then an emission run, on the (m, n) mesh
        s = ShardedSpikeSlabSampler(
            sim.X, sim.Y, cva2, GroupsConfig(block_size=B),
            make_mesh(m, n, device=device), g_assign=sim.g_assign,
            fixed=sim.fixed, dtype=f32)
        g = gen(0)
        state = s.step(s.init(g), g)
        state, res = s.run(g, ChainConfig(4, 2, 1), state=state)
        _check(_finite(res["beta"], state.sigmaE), "case 1 not finite")
        return {"mesh": (m, n), "emits": int(res["mu"].shape[0])}

    def packed():
        # 2-bit words, column-sharded over an (n_devices, 1) mesh
        rng = np.random.default_rng(3)
        dos = rng.integers(0, 3, size=(16, 2 * B * n_devices)).astype(float)
        Yp = (dos[:, 0] - dos[:, 0].mean()) + rng.normal(0, 1, 16)
        s = ShardedSpikeSlabSampler(
            dos, Yp, cva, GroupsConfig(block_size=B),
            make_mesh(n_devices, 1, device=device), backend="pallas",
            x_dtype="2bit")
        g = gen(5)
        st = s.step(s.init(g), g)
        _check(_finite(st.beta), "case 2 not finite")
        return {"plan": (s.jacobi, s.B, s.Mloc)}

    def chains():
        # the fused kernel on every rank of a chain mesh, 2 chains a rank
        s1 = SpikeSlabSampler(sim.X, sim.Y, cva, BayesRConfig(block_size=B),
                              backend="pallas", dtype=f32, device=device)
        runner = ChainParallelRunner(s1, chain_mesh(n_devices, device=device))
        st, v = runner.init(gen(2), 2 * n_devices)
        st = runner.steps(st, v, 1)
        _check(_finite(st.beta), "case 3 not finite")
        return {"chains": 2 * n_devices, "local": int(st.beta.shape[0])}

    def fused():
        # the sharded fused multi-chain step, 2 chains, (n_devices, 1)
        s = ShardedSpikeSlabSampler(
            sim.X, sim.Y, cva2, GroupsConfig(block_size=B),
            make_mesh(n_devices, 1, device=device), g_assign=sim.g_assign,
            fixed=sim.fixed, backend="pallas", dtype=f32)
        g = gen(6)
        st = s.step_chains(s.init(g, chains=2), g)
        _check(_finite(st.beta), "case 4 not finite")
        return {"plan": (s.jacobi, s.B, s.Mloc)}

    def strided():
        # per-slice M large enough for the "t" plan: the fused rounds
        simt = simulate.simulate_bayesr(seed=9, N=32, M=2048 * n_devices,
                                        n_causal=16, h2=0.5)
        s = ShardedSpikeSlabSampler(
            simt.X, simt.Y, cva, BayesRConfig(block_size=32),
            make_mesh(n_devices, 1, device=device), backend="pallas",
            dtype=f32)
        _check(s.jacobi > 1, f"case 5 plan J={s.jacobi}")
        g = gen(9)
        st = s.step_chains(s.init(g, chains=2), g)
        _check(_finite(st.beta), "case 5 not finite")
        return {"plan": (s.jacobi, s.B, s.Mloc)}

    def split():
        # the split sweep on an (n/2, 2) mesh: r summed over "n", the round
        # solves, eps's update summed over "m"
        s = ShardedSpikeSlabSampler(
            sim.X, sim.Y, cva, GroupsConfig(block_size=B),
            make_mesh(n_devices // 2, 2, device=device), backend="pallas",
            dtype=f32)
        _check(s._split, "case 6 does not run the split sweep")
        g = gen(7)
        st = s.step(s.init(g), g)
        _check(_finite(st.beta), "case 6 not finite")
        return {"mesh": (n_devices // 2, 2), "J": s.split_blocks()}

    def row():
        # the one-device row-layout sweep, J=2 blocks a round
        s = SpikeSlabSampler(sim.X, sim.Y, cva, BayesRConfig(block_size=B),
                             backend="pallas", dtype=f32, jacobi_blocks=2,
                             device=device)
        g = gen(8)
        st = s.step(s.init(g), g)
        _check(_finite(st.beta), "case 7 not finite")
        return {"plan": (s.jacobi, s.B, s.jacobi_layout)}

    case("grouped", grouped)
    case("packed", packed)
    case("chains", chains)
    case("fused", fused)
    case("strided", strided)
    if n_devices % 2 == 0:
        case("split", split)
    case("row", row)
    return out


def _rank_main(rank, world, port, out_path, device_type):
    """One rank of ``dryrun_multichip``: the cases, pickled to
    ``out_path``."""
    import torch
    import torch.distributed as dist

    from ..parallel.distributed import initialize

    torch.set_num_threads(1)
    device = _rank_device(device_type, rank)
    if device_type != "cpu":
        torch.cuda.set_device(device)
    initialize(f"tcp://127.0.0.1:{port}", world, rank,
               backend=_group_backend(device_type, world))
    try:
        res = run_cases(world, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


# ------------------------------------------------------- the multi-host leg

def make_problem():
    """tests/test_multihost.py's problem, from the same seed: (X (N, M)
    float32 standardized, Y, cva (2, 3), g_assign)."""
    rng = np.random.default_rng(1234)
    N, M = 96, 64
    X = rng.standard_normal((N, M)).astype(np.float32)
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    beta_t = np.zeros(M)
    beta_t[rng.choice(M, 8, replace=False)] = rng.normal(0, 0.4, 8)
    Y = (X @ beta_t + rng.normal(0, 0.8, N)).astype(np.float32)
    g_assign = (np.arange(M) % 2).astype(np.int32)
    cva = np.array([[0.001, 0.01, 0.1], [0.002, 0.02, 0.2]])
    return X, Y, cva, g_assign


def multihost_child(out_dir, device_type, port=None, rank=None):
    """One rank of the multi-host leg: launched by torchrun (``port`` None:
    ``initialize()`` reads its environment) or as rank ``rank`` of 2 over
    ``tcp://127.0.0.1:port``.  Runs ``MULTIHOST_STEPS`` steps of the
    sharded groups sampler on a (2, 1) mesh in each of
    ``MULTIHOST_MODES`` and saves the gathered state of each to
    ``out_dir/rank{r}_{mode}.npz``."""
    import torch
    import torch.distributed as dist

    from ..config import GroupsConfig
    from ..parallel import ShardedSpikeSlabSampler, make_mesh
    from ..parallel.distributed import initialize, process_marker_range

    torch.set_num_threads(1)
    world = 2
    if port is None:
        initialize(backend=_group_backend(device_type, world))
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    else:
        initialize(f"tcp://127.0.0.1:{port}", world, rank,
                   backend=_group_backend(device_type, world))
        local = rank
    rank = dist.get_rank()
    device = _rank_device(device_type, local)
    try:
        mesh = make_mesh(2, 1, device=device)
        X, Y, cva, g_assign = make_problem()
        M, B = X.shape[1], 16
        for mode in MULTIHOST_MODES:
            Xr, kw = X, {}
            if mode == "shard":
                # this rank's marker slab only, as a host reads its .bed
                Mpad = -(-M // (B * 2)) * (B * 2)
                lo, hi = process_marker_range(mesh, Mpad)
                Xr = np.ascontiguousarray(X.T)[lo:max(lo, min(hi, M))]
                kw = dict(x_process_shard=True, n_markers=M, transposed=True)
            s = ShardedSpikeSlabSampler(Xr, Y, cva, GroupsConfig(block_size=B),
                                        mesh, g_assign=g_assign,
                                        backend="xla", dtype=torch.float32,
                                        **kw)
            g = torch.Generator(device=device).manual_seed(7)
            st = s.init(g)
            for _ in range(MULTIHOST_STEPS):
                st = s.step(st, g)
            np.savez(os.path.join(out_dir, f"rank{rank}_{mode}.npz"),
                     beta=s._gathered(st.beta).cpu().numpy(),
                     labels=s._gathered(st.labels).cpu().numpy(),
                     eps=st.eps.cpu().numpy(), mu=st.mu.cpu().numpy(),
                     sigmaE=st.sigmaE.cpu().numpy(),
                     sigmaGG=st.sigmaGG.cpu().numpy(),
                     pi=st.pi.cpu().numpy())
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _launch(argv, log_path, env):
    """``argv`` started from the repository's root, its output to
    ``log_path``; returns (process, log path)."""
    with open(log_path, "w") as log:
        return subprocess.Popen(argv, env=env, cwd=ROOT, stdout=log,
                                stderr=subprocess.STDOUT), log_path


def multihost_leg(device_type: str = "cpu", timeout: float = 300) -> dict:
    """The 2-rank problem launched by torchrun and over tcp:// (module
    docstring); returns {mode: {field: array}} of torchrun's rank 0, after
    holding both ranks of both launches to it bitwise."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    child = ["-m", "bayesrrcpp_tpu_torch.tools.dryrun", "--multihost-child"]
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("torchrun", "tcp")}
        for d in dirs.values():
            os.makedirs(d)
        port = _free_port()
        procs = [_launch([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc_per_node=2"] + child
                         + [dirs["torchrun"], device_type],
                         os.path.join(tmp, "torchrun.log"), env)]
        procs += [_launch([sys.executable] + child
                          + [dirs["tcp"], device_type, "--tcp", str(port),
                             str(r)], os.path.join(tmp, f"tcp{r}.log"), env)
                  for r in range(2)]
        deadline = time.monotonic() + timeout
        for p, _ in procs:
            try:
                p.wait(max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for p, path in procs:
            if p.returncode != 0:
                with open(path) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(f"multi-host leg: {' '.join(p.args[1:])} "
                                   f"exited with {p.returncode}:\n{tail}")
        states = {}
        for mode in MULTIHOST_MODES:
            runs = {(k, r): dict(np.load(os.path.join(d,
                                                      f"rank{r}_{mode}.npz")))
                    for k, d in dirs.items() for r in range(2)}
            ref = runs["torchrun", 0]
            for key, st in runs.items():
                for field, a in ref.items():
                    if not np.array_equal(a, st[field]):
                        raise AssertionError(
                            f"multi-host leg, {mode}: {key} {field} differs "
                            "from torchrun's rank 0")
            states[mode] = ref
    return states


def dryrun_multichip(n_devices: int, *, device=None, timeout: float = 600,
                     log=print) -> dict:
    """The seven cases on ``n_devices`` spawned ranks and, beside them, the
    multi-host leg.  ``device``: "cpu" runs gloo ranks on the CPU; None or "cuda" the
    card(s).  Returns {"mesh", "ranks": each rank's case records,
    "multihost": the leg's states}; raises on any failure."""
    import torch

    from ..parallel.mesh import default_device

    from concurrent.futures import ThreadPoolExecutor

    device_type = default_device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    t0 = time.perf_counter()
    # the two launches only wait on their processes: the leg runs in a
    # thread beside the cases' ranks
    with ThreadPoolExecutor(1) as ex, \
            tempfile.TemporaryDirectory() as tmp:
        leg = ex.submit(multihost_leg, device_type, timeout)
        ranks = spawn_ranks(_rank_main, n_devices, tmp, timeout,
                            args=(device_type,))
        cases_s = time.perf_counter() - t0
        multihost = leg.result()
    m, n = mesh_shape(n_devices)
    emits = ranks[0][0]["emits"]
    log(f"dryrun_multichip OK: mesh=({m},{n}) devices={n_devices} "
        f"({device_type}, {_group_backend(device_type, n_devices)}) "
        f"emits={emits} chains={2 * n_devices} cases={len(ranks[0])} "
        f"in {cases_s:.1f} s; multihost=ok(2 ranks, torchrun == tcp); "
        f"{time.perf_counter() - t0:.1f} s in all")
    return {"mesh": (m, n), "ranks": ranks, "multihost": multihost}


def main(argv=None):
    a = list(sys.argv[1:] if argv is None else argv)
    if a and a[0] == "--multihost-child":
        out_dir, device_type = a[1], a[2]
        if "--tcp" in a:
            i = a.index("--tcp")
            multihost_child(out_dir, device_type, int(a[i + 1]),
                            int(a[i + 2]))
        else:
            multihost_child(out_dir, device_type)
        return
    device = None
    if "--device" in a:
        i = a.index("--device")
        device = a[i + 1]
        del a[i:i + 2]
    dryrun_multichip(int(a[0]) if a else 4, device=device)


if __name__ == "__main__":
    main()
