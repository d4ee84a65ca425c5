"""The host training loop on the port's 2-D (data, graph) mesh
(``train_agent(engine="host")``, ``Agent.train`` with
``core.spatial.spatial_train_minibatch_fn``) against the JAX package's
single-device host loop on the CPU, on gloo ranks started by
``spawn_mesh``.

Every rank runs JAX's host loop SPMD: the same numpy streams (episode
graphs, explore rolls and picks, replay indices), ``act``, ``remember``
and the fresh targets on the whole states, and only the GD step on the
rank's tile.  JAX's weights and Adam state are carried across.  The
reference is JAX's single-device loop, not its staged GSPMD path (ROADMAP
queue C).

Bars: replay rings bit for bit JAX's (actions, masks, rewards, done, the
stored targets), the same episode lengths and step counts, losses and
parameters within rtol 1e-5 / atol 1e-6 (tests/test_engine.py's bar),
every rank's parameters bit for bit rank 0's; the refusals with JAX's
text.  Each mesh shape spawns once, on first use, with a time limit that
kills its ranks."""
import numpy as np
import pytest

from repro.core import Agent as JaxAgent
from repro.core import random_graph_batch
from repro.core import train_agent as jax_train_agent
from repro_torch.core import mesh
from repro_torch.core.replay import _FIELDS
from test_torch_train import (KEYS, STEP_TOL, _cfgs, jax_adam_to_numpy,
                              jax_to_numpy)
from torch_mesh_ranks import host_shape

MESHES = [(2, 1), (1, 2), (2, 2)]
SPAWN_TIMEOUT_S = 120.0
N, G, B, MB, TAU, STEPS, EPISODES = 14, 4, 2, 8, 2, 10, 2
MODES = ("fresh", "stored")


def _cases(spec):
    """(problem, rep, target mode) of the lockstep runs at ``spec``."""
    cases = [("mvc", rep, mode) for rep in ("dense", "sparse")
             for mode in MODES]
    if spec == (2, 1):
        cases += [("mvc", "csr", mode) for mode in MODES]
    if spec == (2, 2):
        cases += [("mis", "dense", "stored"), ("mds", "sparse", "stored")]
    return cases


def _name(case):
    return " ".join(case)


def _shape_id(spec):
    return f"{spec[0]}x{spec[1]}"


@pytest.fixture(scope="module")
def adj():
    """tests/test_torch_host_engine.py's dataset: 4 ER(14, 0.3)."""
    return random_graph_batch("er", N, G, seed=0, rho=0.3)


@pytest.fixture(scope="module")
def jax_runs(adj):
    """JAX's single-device host loop of every case, run once: its agent,
    log and the weights and Adam state it started from."""
    out = {}
    for case in sorted({c for spec in MESHES for c in _cases(spec)}):
        problem, rep, mode = case
        jcfg, _ = _cfgs(embed_dim=8, num_layers=2, minibatch=MB,
                        replay_capacity=64, learning_rate=1e-3,
                        graph_rep=rep)
        jagent = JaxAgent(jcfg, num_nodes=N, target_mode=mode)
        start = (jax_to_numpy(jagent.params), jax_adam_to_numpy(jagent.opt))
        log = jax_train_agent(jagent, adj, problem=problem,
                              episodes=EPISODES, tau=TAU, batch_graphs=B,
                              max_steps=STEPS, eval_every=10 ** 9, seed=0,
                              engine="host")
        out[_name(case)] = (start, jagent, log)
    return out


@pytest.fixture(scope="module")
def spawns(adj, jax_runs):
    """One spawn per mesh shape, on first use, running
    torch_mesh_ranks.host_shape."""
    done = {}

    def run(spec):
        if spec not in done:
            cases = {}
            for problem, rep, mode in _cases(spec):
                name = _name((problem, rep, mode))
                weights, adam = jax_runs[name][0]
                cases[name] = dict(
                    weights=weights, adam=adam, rep=rep, mode=mode,
                    problem=problem, n=N, b=B, mb=MB, tau=TAU, steps=STEPS,
                    episodes=EPISODES)
            done[spec] = mesh.spawn_mesh(
                host_shape, *spec, device="cpu", backend="gloo",
                timeout_s=SPAWN_TIMEOUT_S, args=(adj, cases))
        return spec, done[spec]
    return run


@pytest.fixture
def mesh_run(request, spawns):
    return spawns(request.param)


CASES = [(spec, _name(c)) for spec in MESHES for c in _cases(spec)]


@pytest.mark.parametrize("mesh_run,name", CASES, indirect=["mesh_run"],
                         ids=[f"{_shape_id(s)}-{n}" for s, n in CASES])
def test_mesh_host_loop_in_lockstep_with_jax(mesh_run, jax_runs, name):
    """Every rank's host loop takes JAX's single-device steps: the same
    replay ring, episode lengths and step counts, losses and parameters
    within the bar, the ranks' parameters equal bit for bit."""
    _, ranks = mesh_run
    _, jagent, jlog = jax_runs[name]
    jl = np.asarray(jlog.losses)
    warm = np.isfinite(jl)
    assert warm.sum() >= 4
    theirs = jax_to_numpy(jagent.params)
    for rk in ranks:
        got = rk[name]
        assert got["lengths"] == jlog.episode_lengths
        assert got["step_count"] == jagent.step_count
        assert got["opt_step"] == int(jagent.opt.step)
        assert (got["size"], got["ptr"]) == (jagent.replay.size,
                                             jagent.replay._ptr)
        for f in _FIELDS:
            want = getattr(jagent.replay, f)
            assert got["ring"][f].dtype == want.dtype, f
            np.testing.assert_array_equal(got["ring"][f], want, err_msg=f)
        np.testing.assert_array_equal(np.isfinite(got["losses"]), warm)
        np.testing.assert_allclose(got["losses"][warm], jl[warm],
                                   **STEP_TOL)
        for k in KEYS:
            np.testing.assert_allclose(got["params"][k], theirs[k],
                                       **STEP_TOL, err_msg=k)
            np.testing.assert_array_equal(got["params"][k],
                                          ranks[0][name]["params"][k])


@pytest.mark.parametrize("mesh_run", MESHES, ids=_shape_id, indirect=True)
def test_mesh_host_loop_refusals(mesh_run):
    """A minibatch that does not divide by dp and nodes that do not divide
    by sp raise JAX's ``spatial GD`` ValueError; CSR asks for sp = 1."""
    spec, ranks = mesh_run
    dp, sp = spec
    for rk in ranks:
        got = rk["refusals"]
        if dp > 1:
            assert got["minibatch"] == (
                f"spatial GD: batch 7 not divisible by data-axis size {dp} "
                f"of mesh {spec}")
        else:
            assert "minibatch" not in got
        if sp > 1:
            assert got["nodes"] == (
                f"spatial GD: 13 node rows not divisible by graph-axis size "
                f"{sp} of mesh {spec}")
            assert got["csr"].startswith(
                f"rep='csr' does not support spatial (graph-axis) sharding "
                f"sp={sp}")
        else:
            assert "nodes" not in got and "csr" not in got
