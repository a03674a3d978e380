"""Helpers of tests/test_torch_sharded*.py and test_torch_chain_parallel.py:
the JAX sharded samplers' draws for one m-slice, and the child process of
the runs on meshes of several gloo ranks.

``JaxSliceReplay`` re-derives, from the JAX sampler's key, every draw that
``bayesrrcpp_tpu/parallel/sharded.py`` makes for slice ``m`` (init :480-484,
``_pre_marker`` :506-530 with the fixed effects', the single-chain sweep keys :546-559, the fused
ones :860-871, ``_hypers`` :816-836), under the roles of the port's
``SliceVariates``, so that the port's sharded sampler steps with JAX's own
variates.  ``JaxHorseshoeSliceReplay`` does the same for
``ShardedHorseshoeSampler`` (init :1443, the step's 9 keys :1469-1558).
``child_main`` is one rank of a gloo group: for each case it builds the
port sampler on the case's (m, n) mesh (the world split into groups of
m * n consecutive ranks when it is larger), carries JAX's data and init
state across (``convert.sharded_*_from_jax``), steps with the replay and
writes its states to a file the parent compares with JAX's; a case of
kind "chains" runs ``case["run"]`` instead.  Not collected by pytest (no
``test_`` prefix).
"""
from __future__ import annotations

import os
import pickle

import numpy as np


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


class JaxSliceReplay:
    """JAX's draws for m-slice ``m`` from ``key``; ``chains=C``: the fused
    sampler's, chain c from ``jax.random.split(key, C)[c]`` (JAX's
    ``init_chains``), the visit order from chain 0; float draws in
    ``dtype`` (the JAX sampler's, "float32" or "float64")."""

    def __init__(self, key, m: int, chains=None, dtype="float32"):
        jax = _jax()
        self.m = m
        self.chains = chains
        self.dt = np.dtype(dtype)
        self.keys = ([key] if chains is None
                     else list(jax.random.split(key, chains)))

    def _t(self, x):
        import torch

        return torch.as_tensor(np.array(x, self.dt))

    def _stack(self, xs):
        import torch

        return xs[0] if self.chains is None else torch.stack(xs)

    def init_sigmaGG(self, G):
        jax = _jax()

        from bayesrrcpp_tpu import distributions as jdist

        out, self.kF = [], []
        for c, key in enumerate(self.keys):
            self.keys[c], kG, kF = jax.random.split(key, 3)
            self.kF.append(kF)
            out.append(self._t(jax.vmap(
                lambda k: jdist.beta_rng(k, 1.0, 1.0, dtype=self.dt))(
                    jax.random.split(kG, G))))
        return self._stack(out)

    def init_sigmaF(self):
        jax = _jax()

        return self._stack([self._t(jax.random.uniform(k, (), self.dt))
                            for k in self.kF])

    def fixed_order(self, F):
        import torch

        jax = _jax()
        return self._stack([torch.as_tensor(np.array(
            jax.random.permutation(ks[2], F))) for ks in self.step_keys])

    def fixed_z(self, F):
        jax = _jax()

        return self._stack([self._t(jax.random.normal(ks[3], (F,),
                                                      self.dt))
                            for ks in self.step_keys])

    def sigmaF_gamma(self, shape):
        jax = _jax()
        import jax.numpy as jnp

        return self._stack([self._t(jax.random.gamma(
            ks[6], jnp.asarray(shape, jnp.float64)))
            for ks in self.step_keys])

    def begin_step(self):
        jax = _jax()
        self.step_keys = []
        for c, key in enumerate(self.keys):
            ks = jax.random.split(key, 9)
            self.keys[c] = ks[0]
            self.step_keys.append(ks)
        ksweep = [jax.random.fold_in(ks[4], self.m)
                  for ks in self.step_keys]
        if self.chains is None:
            self.kb, self.ki, kp, kz = jax.random.split(ksweep[0], 4)
            self.kp, self.kz = [kp], [kz]
        else:
            self.kb, self.ki = jax.random.split(ksweep[0], 2)
            pz = [jax.random.split(k, 2) for k in ksweep]
            self.kp, self.kz = [k[0] for k in pz], [k[1] for k in pz]

    def mu_noise(self):
        jax = _jax()

        return self._stack([self._t(jax.random.normal(ks[1], (), self.dt))
                            for ks in self.step_keys])

    def orders(self, nb, B, J):
        import torch

        jax = _jax()
        import jax.numpy as jnp

        rho = jax.random.permutation(self.kb, nb // J)
        inner = jnp.argsort(jax.random.uniform(self.ki, (nb, B)), axis=1)
        return (torch.as_tensor(np.array(rho, np.int32)),
                torch.as_tensor(np.array(inner, np.int32)))

    def block_orders(self, nb, B):
        import torch

        jax = _jax()
        border = jax.random.permutation(self.kb, nb)
        inner = jax.vmap(lambda k: jax.random.permutation(k, B))(
            jax.random.split(self.ki, nb))
        return (torch.as_tensor(np.array(border, np.int32)),
                torch.as_tensor(np.array(inner, np.int32)))

    def p(self, n):
        jax = _jax()

        return self._stack([self._t(jax.random.uniform(k, (n,), self.dt))
                            for k in self.kp])

    def z(self, n):
        jax = _jax()

        return self._stack([self._t(jax.random.normal(k, (n,), self.dt))
                            for k in self.kz])

    def sigmaE_gamma(self, shape):
        jax = _jax()
        import jax.numpy as jnp

        # f64 under x64: the JAX draw's dof is a python float
        return self._stack([self._t(jax.random.gamma(
            ks[5], jnp.asarray(shape, jnp.float64)))
            for ks in self.step_keys])

    def _per_group(self, idx, arr):
        jax = _jax()
        import jax.numpy as jnp

        arr = arr.numpy()
        out = []
        for c, ks in enumerate(self.step_keys):
            a = arr if self.chains is None else arr[c]
            out.append(self._t(jax.vmap(jax.random.gamma)(
                jax.random.split(ks[idx], a.shape[0]),
                jnp.asarray(a, self.dt))))
        return self._stack(out)

    def sigmaG_gamma(self, shapes):
        return self._per_group(7, shapes)

    def pi_gamma(self, alpha):
        return self._per_group(8, alpha)


class JaxHorseshoeSliceReplay:
    """The JAX sharded horseshoe's draws for m-slice ``m`` from ``key``
    (bayesrrcpp_tpu/parallel/sharded.py:1443, :1469-1558): the replicated
    ones from the step's keys, the slice's v / lambda gammas, block orders
    and z from keys with ``m`` folded in; float draws in ``dtype``."""

    def __init__(self, key, m: int, dtype="float32"):
        _jax()
        self.key = key
        self.m = m
        self.dt = np.dtype(dtype)

    def _t(self, x):
        import torch

        return torch.as_tensor(np.array(x, self.dt))

    @staticmethod
    def _gamma(k, shape):
        import jax
        import jax.numpy as jnp

        # a python-float shape: f64 under x64, as the JAX draw's
        return jax.random.gamma(k, jnp.asarray(shape, jnp.float64))

    def init_gammas(self, eta_shape, tau_shape):
        jax = _jax()
        self.key, keta, ktau = jax.random.split(self.key, 3)
        return (self._t(self._gamma(keta, eta_shape)),
                self._t(self._gamma(ktau, tau_shape)))

    def begin_step(self):
        jax = _jax()
        self.ks = jax.random.split(self.key, 9)
        self.key = self.ks[0]
        self.kb, self.ki, self.kz = jax.random.split(
            jax.random.fold_in(self.ks[4], self.m), 3)
        # v, then lambda
        self.local = [jax.random.fold_in(self.ks[i], self.m) for i in (3, 5)]

    def mu_noise(self):
        jax = _jax()

        return self._t(jax.random.normal(self.ks[1], (), self.dt))

    def eta_gamma(self, shape):
        return self._t(self._gamma(self.ks[2], shape))

    def local_gamma(self, alpha, n):
        from bayesrrcpp_tpu import distributions as jdist

        return self._t(jdist.gamma_shape_rng(self.local.pop(0), alpha, n,
                                             dtype=self.dt))

    def block_orders(self, nb, B):
        import torch

        jax = _jax()
        border = jax.random.permutation(self.kb, nb)
        inner = jax.vmap(lambda k: jax.random.permutation(k, B))(
            jax.random.split(self.ki, nb))
        return (torch.as_tensor(np.array(border, np.int32)),
                torch.as_tensor(np.array(inner, np.int32)))

    def z(self, n):
        jax = _jax()

        return self._t(jax.random.normal(self.kz, (n,), self.dt))

    def tau_gamma(self, shape):
        return self._t(self._gamma(self.ks[6], shape))

    def c2_gamma(self, shape):
        return self._t(self._gamma(self.ks[7], shape))

    def sigmaE_gamma(self, shape):
        return self._t(self._gamma(self.ks[8], shape))


def np_state(st) -> dict:
    """A port or JAX state as a dict of NumPy arrays."""
    d = st._asdict() if hasattr(st, "_asdict") else vars(st)
    return {k: np.array(v) for k, v in d.items()}


def port_sampler(case: dict, mesh, device="cpu"):
    """The port's sampler (``case["kind"]``: "bayesr", the default, or
    "horseshoe") on the case's data, then JAX's slice data carried across
    (the sweep inputs exactly; the port's own are checked by the caller
    against them)."""
    from bayesrrcpp_tpu_torch import BayesRConfig, HorseshoeConfig
    from bayesrrcpp_tpu_torch import convert
    from bayesrrcpp_tpu_torch.parallel import (ShardedHorseshoeSampler,
                                               ShardedSpikeSlabSampler)

    kw = dict(backend=case["backend"], x_dtype=case["x_dtype"],
              chunk_blocks=case["chunk_blocks"],
              split_sweep=case.get("split_sweep"), dtype=case.get("dtype"))
    at = dict(Dm=mesh.Dm, m_index=mesh.m_index, Dn=mesh.Dn,
              n_index=mesh.n_index, device=device)
    if case.get("kind", "bayesr") == "horseshoe":
        s = ShardedHorseshoeSampler(
            case["X"], case["Y"],
            HorseshoeConfig(block_size=case["block_size"]), mesh, **kw)
        own = s.data
        s.data = convert.sharded_horseshoe_data_from_jax(
            case["jax_data"], N=s.N, dtype=s.dtype, **at)
        return s, own
    if case.get("g_assign") is not None:
        # the groups variant (tests/test_torch_groups_sharded.py)
        from bayesrrcpp_tpu_torch import GroupsConfig

        cfg = GroupsConfig(block_size=case["block_size"])
        kw.update(g_assign=case["g_assign"], fixed=case["fixed"])
    else:
        cfg = BayesRConfig(block_size=case["block_size"])
    s = ShardedSpikeSlabSampler(case["X"], case["Y"], case["cva"], cfg, mesh,
                                **kw)
    own = s.data
    s.data = convert.sharded_data_from_jax(case["jax_data"], N=s.N,
                                           dtype=s.dtype, **at)
    return s, own


def replay_steps(case: dict, s, steps: int):
    """``steps`` steps of the port sampler ``s`` from JAX's init state with
    JAX's draws for this slice (single chain or ``case["chains"]`` fused);
    returns the states as NumPy dicts."""
    import jax.numpy as jnp

    from bayesrrcpp_tpu_torch import convert

    chains = case.get("chains")
    key = jnp.asarray(case["key"])
    if case.get("kind", "bayesr") == "horseshoe":
        rv = JaxHorseshoeSliceReplay(key, s.mesh.m_index,
                                     case.get("dtype") or "float32")
        s.init(rv)                         # advances the key as JAX's init
        st = convert.sharded_horseshoe_state_from_jax(case["jax_init"], s)
    else:
        rv = JaxSliceReplay(key, s.mesh.m_index, chains,
                            case.get("dtype") or "float32")
        s.init(rv, chains=chains)          # advances the keys as JAX's init
        st = convert.sharded_state_from_jax(case["jax_init"], s)
    out = []
    for _ in range(steps):
        st = s.step(st, rv) if chains is None else s.step_chains(st, rv)
        out.append(np_state(st))
    return out


def _case_mesh(case, world, rank):
    """The case's (m, n) mesh on this rank: the world itself, or one of its
    groups of m * n consecutive ranks (every rank makes every group)."""
    import torch.distributed as dist

    from bayesrrcpp_tpu_torch.parallel import make_mesh

    m, n = case.get("mesh", (world, 1))
    size = m * n
    if size == world:
        return make_mesh(m, n, device="cpu")
    mine = None
    for g0 in range(0, world, size):
        g = dist.new_group(list(range(g0, g0 + size)))
        if g0 <= rank < g0 + size:
            mine = g
    return make_mesh(m, n, group=mine, device="cpu")


def child_main(rank: int, world: int, port: int, case_file: str,
               out_file: str):
    """Rank ``rank`` of a gloo group of ``world``: every case of the pickled
    list in ``case_file`` on its mesh (``case["mesh"]``, default (world,
    1)), the results pickled to ``out_file`` (an exception's text in their
    place when one is raised)."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    _jax()
    from bayesrrcpp_tpu_torch.parallel.distributed import initialize

    results = []
    try:
        initialize(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
        with open(case_file, "rb") as f:
            cases = pickle.load(f)
        for case in cases:
            if case.get("kind") == "chains":
                results.append(case["run"](rank, world))
                continue
            mesh = _case_mesh(case, world, rank)
            s, own = port_sampler(case, mesh)
            results.append(dict(
                states=replay_steps(case, s, case["steps"]),
                own={k: np.array(getattr(own, k)) for k in
                     ("XT", "xsq", "gram", "x_mean", "x_scale", "x_colsum")},
                has_missing=own.has_missing,
                layout=(s.jacobi, s.B, s.Mpad, s.Mloc),
                at=(mesh.m_index, mesh.n_index)))
        dist.barrier()
    except Exception as e:  # noqa: BLE001 -- reported to the parent
        import traceback

        results = f"rank {rank}: {e!r}\n{traceback.format_exc()}"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_file + ".tmp", "wb") as f:
        pickle.dump(results, f)
    os.replace(out_file + ".tmp", out_file)


def in_threads(fns: dict, workers: int = 4) -> dict:
    """{name: fn()} with the calls in a pool of threads: JAX's compiles of
    several samplers overlap (XLA compiles without the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as ex:
        futures = {k: ex.submit(fn) for k, fn in fns.items()}
        return {k: f.result() for k, f in futures.items()}


def start_ranks(cases: list, tmp_path, world: int = 2):
    """Spawn ``world`` gloo processes on every case (see ``child_main``);
    returns the handle ``finish_ranks`` waits on, so that the caller can
    work meanwhile."""
    import multiprocessing as mp
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    case_file = os.path.join(tmp_path, "cases.pkl")
    with open(case_file, "wb") as f:
        pickle.dump(cases, f)
    ctx = mp.get_context("spawn")
    outs = [os.path.join(tmp_path, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=child_main,
                         args=(r, world, port, case_file, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def finish_ranks(handle, timeout: float = 300):
    """Each rank's results of ``start_ranks`` (a list per rank, cases in
    order); raises on a rank's error or a rank still running after
    ``timeout`` seconds."""
    procs, outs = handle
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive:
        raise RuntimeError(f"{len(alive)} rank(s) still running after "
                           f"{timeout} s")
    results = []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} wrote no result (exit code "
                               f"{procs[r].exitcode})")
        with open(path, "rb") as f:
            res = pickle.load(f)
        if isinstance(res, str):
            raise RuntimeError(res)
        results.append(res)
    return results


def run_ranks(cases: list, tmp_path, world: int = 2, timeout: float = 300):
    """Every case on its mesh of ``world`` spawned gloo processes (see
    ``child_main``); returns each rank's results (a list per rank, cases in
    order)."""
    return finish_ranks(start_ranks(cases, tmp_path, world), timeout)
