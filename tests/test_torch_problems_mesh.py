"""MaxCut, MIS and MDS on the port's 2-D (data, graph) mesh against the JAX
package on the CPU, on gloo ranks started by ``spawn_mesh``: the env's
rules on a rank's tile (``repro_torch.core.env`` with ``state.axis``, the
closed keep and factors of ``core.s2v_sparse``, ``spatial.tile_from_tuples``
in the closed mode and with MDS's candidate rule), the solve, the sync
service and the train step.

Bars: every tile rule bit for bit the matching rows of the single-device
port's, on fresh and partial states with padding nodes; solves on dense
and sparse at every mesh shape (CSR at (2, 1)) with the solutions,
evaluation counts and committed counts of JAX's single-device device
engine on tests/test_mesh.py's graphs, and checker-feasible; the (2, 2)
service's answers JAX's service's; with JAX's draws injected, the mesh
train step takes JAX's single-device actions, with losses and parameters
within atol 1e-6 / rtol 1e-5 (tests/test_torch_mesh_train.py's bar) and
every rank's parameters equal bit for bit; the launcher serves MDS under
``torchrun`` with the single-device answers.  Each mesh shape spawns
once, on first use, with a time limit that kills its ranks."""
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import PolicyConfig as JaxPolicyConfig
from repro.core import init_policy as jax_init_policy
from repro.core import random_graph_batch
from repro.core import solve as jax_solve
from repro.serving import GraphSolverService as JaxService
from repro_torch.core import env, mesh
from repro_torch.launch import solve_serve
from test_torch_mesh import MESHES, jax_to_numpy
from test_torch_mesh_train import GI, KEYS, N, STEP_TOL, _jax_run, _shape_id
from torch_mesh_ranks import PROBLEMS, problems_shape, train_agent_run

SPAWN_TIMEOUT_S = 120.0
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
# (rep, target mode, epsilon) of the lockstep cases at each mesh shape
TRAIN_MODES = (("stored", 0.0), ("fresh", 0.5))


def _train_cases(spec):
    modes = TRAIN_MODES if spec == (2, 2) else TRAIN_MODES[1:]
    cases = [(rep, *m) for rep in ("dense", "sparse") for m in modes]
    if spec == (2, 1):
        cases += [("csr", *m) for m in TRAIN_MODES]
    return [(problem, *c) for problem in PROBLEMS for c in cases]


def _name(case):
    return " ".join(map(str, case[:3]))


def _solve_reps(spec):
    return ("dense", "sparse") + (("csr",) if spec[1] == 1 else ())


def _agent_runs(spec):
    """(problem, rep) of the ``train_agent`` runs at ``spec``."""
    reps = {(2, 2): ("dense", "sparse"), (2, 1): ("csr",)}.get(spec, ())
    return [(problem, rep) for problem in PROBLEMS for rep in reps]


@pytest.fixture(scope="module")
def case():
    """tests/test_mesh.py:261-281's solve case (ER N=16, B=4, seed 0,
    ρ=0.3, embed_dim=8), a service stream, and the tile rules' graphs: 4
    ER(14, 0.3) graphs padded with 2 isolated nodes."""
    params = jax_init_policy(jax.random.key(0), JaxPolicyConfig(embed_dim=8))
    rng = np.random.default_rng(0)
    return {"params": params, "weights": jax_to_numpy(params),
            "adj": random_graph_batch("er", 16, 4, seed=0, rho=0.3),
            "stream": [random_graph_batch("er", int(n), 1, seed=i,
                                          rho=0.3)[0]
                       for i, n in enumerate(rng.integers(5, 14, size=6))],
            "rules_adj": np.pad(random_graph_batch("er", 14, 4, seed=3,
                                                   rho=0.3),
                                ((0, 0), (0, 2), (0, 2)))}


@pytest.fixture(scope="module")
def jax_solves(case):
    return {(problem, rep): jax_solve(
        case["params"], case["adj"], num_layers=2, multi_node=True, rep=rep,
        problem=problem, engine="device")
        for problem in PROBLEMS for rep in ("dense", "sparse", "csr")}


@pytest.fixture(scope="module")
def train_adj():
    """tests/test_torch_mesh_train.py's train graphs: 4 ER(14, 0.3)."""
    return random_graph_batch("er", N, 4, seed=0, rho=0.3)


@pytest.fixture(scope="module")
def train_refs(train_adj):
    """JAX's single-device runs of every lockstep case, with their
    draws."""
    cases = {c for spec in MESHES for c in _train_cases(spec)}
    return {_name(c): _jax_run(train_adj, c[1], c[2], c[3], "fused", c[0])
            for c in sorted(cases)}


@pytest.fixture(scope="module")
def spawns(case, train_adj, train_refs):
    """One spawn per mesh shape, on first use, running
    torch_mesh_ranks.problems_shape; the results of every rank, by
    rank."""
    done = {}

    def run(spec):
        if spec not in done:
            cases = {}
            for c in _train_cases(spec):
                problem, rep, mode, eps = c
                cases[_name(c)] = dict(
                    draws=train_refs[_name(c)]["draws"], rep=rep,
                    target_mode=mode, eps=eps, problem=problem, tau=2,
                    embed_dim=8, num_layers=2, minibatch=8,
                    replay_capacity=64, learning_rate=1e-3)
            first = train_refs[_name(_train_cases(spec)[0])]
            train = {"weights": first["weights"], "adj": train_adj,
                     "gi": GI, "cases": cases, "agent": _agent_runs(spec)}
            done[spec] = mesh.spawn_mesh(
                problems_shape, *spec, device="cpu", backend="gloo",
                timeout_s=SPAWN_TIMEOUT_S,
                args=(case["weights"], case["adj"], case["stream"],
                      case["rules_adj"], train))
        return spec, done[spec]
    return run


@pytest.fixture
def mesh_run(request, spawns):
    return spawns(request.param)


# ---------------------------------------------------------------------------
# The tile rules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_run", MESHES, ids=_shape_id, indirect=True)
def test_tile_rules_equal_the_single_device_rows(mesh_run):
    """Step, commit, prune, candidates, closed keep, closed factors and
    the train tile (closed mode, MDS's candidates) on every rank's tile
    equal the rows of the single-device rules, bit for bit."""
    _, ranks = mesh_run
    for rk in ranks:
        assert rk["rules"] == [], rk["rules"]


# ---------------------------------------------------------------------------
# The solve and the service.
# ---------------------------------------------------------------------------

SOLVES = [(spec, problem, rep) for spec in MESHES for problem in PROBLEMS
          for rep in _solve_reps(spec)]


@pytest.mark.parametrize(
    "mesh_run,problem,rep", SOLVES, indirect=["mesh_run"],
    ids=[f"{_shape_id(s)}-{p}-{r}" for s, p, r in SOLVES])
def test_mesh_solve_identical_to_jax(case, jax_solves, mesh_run, problem,
                                     rep):
    """tests/test_mesh.py:261-281's bar, held to JAX's single-device
    device engine: solutions, evaluation counts and committed counts
    identical on every rank, and every solution feasible."""
    _, ranks = mesh_run
    want = jax_solves[problem, rep]
    adj0 = torch.from_numpy(np.asarray(case["adj"], np.float32))
    for rk in ranks:
        sol, evals, committed = rk["solve", problem, rep]
        np.testing.assert_array_equal(sol, want.solution)
        assert evals == want.policy_evals
        np.testing.assert_array_equal(committed, want.nodes_committed)
        assert env.checker(problem)(adj0, torch.from_numpy(sol)).all()


@pytest.mark.parametrize("mesh_run", [(2, 2)], ids=_shape_id, indirect=True)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_mesh_service_matches_jax_service(case, mesh_run, problem):
    """The (2, 2) sync service (2 rows per data rank) answers every
    request as JAX's single-device service with as many rows per
    dispatch does."""
    _, ranks = mesh_run
    want = JaxService(case["params"], JaxPolicyConfig(embed_dim=8),
                      multi_node=True, max_batch=4).serve(
                          case["stream"], problem=problem)
    for rk in ranks:
        got = rk["service", problem]
        assert len(got) == len(want)
        for (rid, sol, size, evals), w in zip(got, want):
            assert rid == w.id and size == w.size
            assert evals == w.policy_evals
            np.testing.assert_array_equal(sol, w.solution)


# ---------------------------------------------------------------------------
# The train step in lockstep with JAX's single-device step.
# ---------------------------------------------------------------------------

TRAINS = [(spec, _name(c)) for spec in MESHES for c in _train_cases(spec)]


@pytest.mark.parametrize("mesh_run,name", TRAINS, indirect=["mesh_run"],
                         ids=[f"{_shape_id(s)}-{n}" for s, n in TRAINS])
def test_mesh_step_matches_jax_single_device_step(mesh_run, train_refs,
                                                  name):
    """JAX's actions, losses and parameters within atol 1e-6 / rtol 1e-5
    on every rank, the ranks' parameters equal bit for bit, and the step
    count the warm steps'."""
    _, ranks = mesh_run
    want = train_refs[name]
    for rk in ranks:
        got = rk["train", name]
        np.testing.assert_array_equal(got["actions"], want["actions"])
        warm = np.isfinite(want["losses"])
        np.testing.assert_array_equal(np.isfinite(got["losses"]), warm)
        assert warm.sum() >= 4
        np.testing.assert_allclose(got["losses"][warm],
                                   want["losses"][warm], **STEP_TOL)
        for k in KEYS:
            np.testing.assert_allclose(got["params"][k], want["params"][k],
                                       **STEP_TOL, err_msg=k)
            np.testing.assert_array_equal(
                got["params"][k], ranks[0]["train", name]["params"][k])
        assert got["step_count"] == int(warm.sum())
    if "fresh" in name:
        assert (want["draws"][0][0] < 0.5).any()     # some rows explored


AGENTS = [(spec, *run) for spec in MESHES for run in _agent_runs(spec)]


@pytest.mark.parametrize("mesh_run,problem,rep", AGENTS,
                         indirect=["mesh_run"],
                         ids=[f"{_shape_id(s)}-{p}-{r}" for s, p, r in AGENTS])
def test_train_agent_on_a_mesh_matches_one_device(train_adj, mesh_run,
                                                  problem, rep):
    """``train_agent`` of each problem on a mesh (its episode tiles built
    with the problem's mode and candidate rule) takes the single-device
    run's draws from the same seed: the same episode lengths, losses and
    parameters within atol 1e-6 / rtol 1e-5, every rank's parameters equal
    bit for bit."""
    _, ranks = mesh_run
    want = train_agent_run(None, "cpu", train_adj, problem, rep)
    assert np.isfinite(want["losses"]).sum() >= 4
    for rk in ranks:
        got = rk["agent", problem, rep]
        assert got["lengths"] == want["lengths"]
        assert got["step_count"] == want["step_count"]
        np.testing.assert_allclose(got["losses"], want["losses"], **STEP_TOL)
        for k in KEYS:
            np.testing.assert_allclose(got["params"][k], want["params"][k],
                                       **STEP_TOL, err_msg=k)
            np.testing.assert_array_equal(
                got["params"][k],
                ranks[0]["agent", problem, rep]["params"][k])


# ---------------------------------------------------------------------------
# The launcher under torchrun.
# ---------------------------------------------------------------------------

LAUNCH = ["--device", "cpu", "--problem", "mds", "--rep", "sparse",
          "--requests", "4", "--sizes", "12,20", "--embed-dim", "8",
          "--warmup"]


def _answers(text):
    return re.findall(r"req\s*(\d+)\s+n=\s*(\d+) -> bucket\s+(\d+)\s+"
                      r"\|S\|=\s*(\d+)\s+evals=(\d+)", text)


def test_launcher_serves_mds_on_a_mesh_under_torchrun(capsys):
    """``--problem mds --spatial 1,2`` on two gloo CPU ranks under
    torchrun serves the single-device launcher's answers (request, size,
    bucket, |S|, evaluations); only rank 0 prints."""
    solve_serve.main(LAUNCH)
    want = _answers(capsys.readouterr().out)
    assert len(want) == 4
    env_vars = dict(os.environ, PYTHONPATH=SRC)
    for var in solve_serve.TORCHRUN_VARS:
        env_vars.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.solve_serve",
         "--spatial", "1,2", "--dist-backend", "gloo", *LAUNCH],
        env=env_vars, capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert _answers(proc.stdout) == want
    assert "mesh (1, 2)" in proc.stdout and "problem mds" in proc.stdout
