"""The port's collective-count model (``tools/comm_model.py``) on the CPU:
the analytic counts against the ``torch.distributed.all_reduce`` calls
and bytes counted over one step on four gloo ranks, in the three cases of
tools/comm_model.py ((Dm, Dn) = (4, 1) with the kernels, (2, 2) with
``backend="xla"``, 4 fused chains at Dm = 4 on the strided rounds), then
the split sweep and the groups variant with fixed effects on (2, 2); the
three of tools/comm_model.py each against the JAX model (tools/comm_model.py:30, ``analytic_model``)
for the same arguments: the same number of sweep all-reduces a step, and
the differences in bytes and in hyperparameter calls that the port's
module states, each asserted here."""
import ast
import pathlib

import pytest

from bayesrrcpp_tpu_torch.tools import comm_model

JAX_TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
    "comm_model.py"


@pytest.fixture(scope="module")
def jax_analytic():
    """The JAX tool's ``analytic_model`` alone (pure Python), without
    importing the tool, whose import configures jax for its own run."""
    tree = ast.parse(JAX_TOOL.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "analytic_model")
    ns = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(JAX_TOOL),
                 "exec"), ns)
    return ns["analytic_model"]


@pytest.fixture(scope="module")
def validated():
    return {r["case"]: r for r in comm_model.validate(timeout=240)}


CASE_NAMES = [c.name for c in comm_model.CASES]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_counted_step_equals_the_model(validated, name):
    rec = validated[name]
    assert rec["match"], rec
    for ax in comm_model.AXES:
        assert rec["counted"][ax]["calls"] == rec["model"]["calls"][ax]
        assert rec["counted"][ax]["bytes"] == rec["model"]["bytes"][ax]
    assert rec["counted"]["other"]["calls"] == 0
    # the model's path is the sampler's own
    model, layout = rec["model"], rec["layout"]
    assert (model["plan"]["J"], model["plan"]["B"], model["plan"]["nb_loc"]) \
        == (layout["jacobi"], layout["B"], layout["nb_loc"])
    assert (model["path"] == "split") == layout["split"]
    if layout["split"]:
        # one round of J blocks an r all-reduce over "n"
        assert model["rounds_per_iter"] * layout["split_blocks"] == \
            layout["nb_loc"]


def test_new_cases_cover_the_split_and_groups_branches():
    """The split sweep in several rounds and in one, and the groups
    variant's per-group counts, slab sums and fixed-effect dots."""
    split = comm_model.case_model(comm_model.CASES[3])
    groups = comm_model.case_model(comm_model.CASES[4])
    assert (split["path"], split["rounds_per_iter"]) == ("split", 2)
    assert (groups["path"], groups["rounds_per_iter"]) == ("split", 1)
    assert groups["hyper_calls"] == {"m": 2, "n": 2 + 2}
    # counts (C, G, K) = (1, 2, 5) and bacc (G,) over "m"
    assert groups["bytes"]["m"] == (groups["plan"]["Nloc"] + 2 * 5 + 2) * 4


@pytest.mark.parametrize("name", [c.name for c in comm_model.JAX_CASES])
def test_model_against_jax(jax_analytic, name):
    case = next(c for c in comm_model.JAX_CASES if c.name == name)
    (Dm, Dn), backend, N, M, B, chunk, C = (
        case.mesh, case.backend, case.N, case.M, case.B, case.chunk_blocks,
        case.chains)
    ours = comm_model.case_model(case)
    theirs = jax_analytic(N=N, M=M, B=B, Dm=Dm, Dn=Dn, chunk_blocks=chunk,
                          backend=backend)
    # the same all-reduces of the sweep a step, over "m" and over "n"
    assert ours["rounds_per_iter"] == theirs["rounds_per_iter"]
    assert ours["sweep_calls"]["m"] == theirs["eps_psums_per_iter"]
    assert ours["sweep_calls"]["n"] == theirs["r_psums_per_iter"]
    # eps bytes: JAX pads N to 2,048 on its Pallas path, the port's dense
    # eps is N (Nloc on Dn > 1) long, one (C, N) all-reduce for C chains
    nloc = ours["plan"]["Nloc"]
    assert theirs["eps_psum_payload_bytes"] == (
        -(-N // 2048) * 2048 * 4 if backend == "pallas" else N * 4)
    m_hyper = 4 * (C or 1) * (4 + 1)          # counts (G=1, K=4), sum b^2
    n_hyper = 4 * 2 if Dn > 1 else 0          # mu, sigmaE sums of eps
    assert ours["bytes"]["m"] == (ours["sweep_calls"]["m"] * (C or 1) * nloc
                                  * 4 + m_hyper)
    # r bytes (xla): JAX counts chunk_blocks * B floats, the body sums one
    # block's B
    if theirs["r_psums_per_iter"]:
        assert theirs["comm_bytes_per_iter"] - theirs["eps_psums_per_iter"] \
            * theirs["eps_psum_payload_bytes"] == \
            theirs["r_psums_per_iter"] * min(chunk, M // B // Dm) * B * 4
        assert ours["bytes"]["n"] == ours["sweep_calls"]["n"] * B * 4 \
            + n_hyper
    # hyperparameters: JAX's 6 sites (trivial axes too); the port's calls
    # are over axes with a group only: 2 over "m", 2 more over "n" at Dn > 1
    assert theirs["hyper_psums_per_iter"] == 6
    assert ours["hyper_calls"] == {"m": 2, "n": 2 if Dn > 1 else 0}


def test_one_rank_mesh_counts_its_calls():
    """The (1, 1) mesh of a one-rank group (biobank-sharded-m1's) keeps
    the world group on "m": one eps all-reduce a sweep and two
    hyperparameter sums, none over "n"."""
    res = comm_model.analytic_model(N=100_352, M=503_808, B=32, Dm=1, Dn=1,
                                    x_dtype="2bit")
    assert res["path"] == "strided" and res["plan"]["J"] == 128
    assert res["calls"] == {"m": 3, "n": 0}
    assert res["bytes"]["m"] == (100_352 + 4 + 1) * 4
