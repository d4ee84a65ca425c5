"""MaxCut, MIS and MDS in the port (repro_torch.core.{env,graphs,graphrep,
inference,solvers}, the service) against the JAX package on the CPU, on
the dense, sparse and CSR representations.

Bars: every env step, commit, prune, candidate rule and checker bit for
bit equal to ``repro.core.env``'s on the same numpy inputs (their masks
are ``> 0`` tests of sums of 0/1 products, and their counts exact sums of
0/1 values); solutions, evaluation counts and committed counts of
``solve(engine="device")`` identical to JAX's device engine; the
baselines equal to JAX's; bf16 solves within 10% of f32's objective
(``tests/test_fused_kernel.py::test_bf16_quality_gate``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PolicyConfig as JaxPolicyConfig
from repro.core import env as jax_env
from repro.core import get_rep as jax_get_rep
from repro.core import init_policy as jax_init_policy
from repro.core import solve as jax_solve
from repro.core import solvers as jax_solvers
from repro.core.graphs import erdos_renyi as jax_erdos_renyi
from repro.core.inference import best_trajectory_cut as jax_best_cut
from repro.core.inference import init_solve_state as jax_init_solve_state
from repro_torch.convert import policy_from_numpy
from repro_torch.core import (PolicyConfig, env, get_rep, get_train_step,
                              random_graph_batch, solve, solvers)
from repro_torch.core.inference import best_trajectory_cut, init_solve_state
from repro_torch.serving import GraphSolverService, bucket_nodes, pad_adjacency
from test_torch_solve import jax_to_numpy

PROBLEMS = ("maxcut", "mis", "mds")
SUITE = ("mvc",) + PROBLEMS
REPS = ("dense", "sparse", "csr")
FIELDS = {"dense": ("adj", "candidate", "solution"),
          "sparse": ("neighbors", "valid", "candidate", "solution"),
          "csr": ("indptr", "indices", "edge_mask", "candidate", "solution")}


@pytest.fixture(scope="module")
def setup():
    """tests/test_problem_suite.py's ``setup``: the graphs, JAX's policy
    and the port's copy of it."""
    adj = random_graph_batch("er", 24, 4, seed=0, rho=0.25)
    params = jax_init_policy(jax.random.key(0), JaxPolicyConfig(embed_dim=8))
    return adj, params, policy_from_numpy(jax_to_numpy(params), device="cpu")


def _assert_state(got, want, rep, msg=""):
    for f in FIELDS[rep]:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{msg} {f}")
    if rep != "dense":
        assert got.residual == want.residual, msg


def _states(rep, adj, sol, problem, gi=None):
    """The same replay tuples re-materialized by both packages with the
    problem's residual mode and candidate rule: (JAX's state, the port's
    state, the port's dataset source)."""
    gi = np.arange(len(sol)) % len(adj) if gi is None else gi
    jrep, prep = jax_get_rep(rep), get_rep(rep)
    jst = jrep.state_from_tuples(
        jrep.prepare_dataset(adj), gi, sol,
        residual=jax_env.residual_mode(problem),
        candidate_fn=jax_env.candidate_rule(problem))
    source = prep.prepare_dataset(adj, device="cpu")
    pst = prep.state_from_tuples(
        source, torch.from_numpy(gi), torch.from_numpy(sol),
        residual=env.residual_mode(problem),
        candidate_fn=env.candidate_rule(problem))
    return jst, pst, source


def _random_solutions(b, n, seed, p=0.2):
    rng = np.random.default_rng(seed)
    return (rng.random((b, n)) < p).astype(np.float32)


# -- the registry -------------------------------------------------------------------

def test_registry_declares_the_suite_as_jax_does():
    assert set(SUITE) <= set(env.names())
    for problem in SUITE:
        assert env.residual_mode(problem) == jax_env.residual_mode(problem)
        assert env.sense(problem) == jax_env.sense(problem)
        assert env.sparse_residual_flag(problem) == \
            jax_env.sparse_residual_flag(problem)
        assert (env.prune_rule(problem) is None) == \
            (jax_env.prune_rule(problem) is None)
        assert (env.candidate_rule(problem) is None) == \
            (jax_env.candidate_rule(problem) is None)
    assert env.candidate_rule("mds") is env.mds_candidates
    assert env.commit_rule("maxcut") is env.assignment_commit
    assert env.commit_rule("mis") is env.mis_commit
    assert env.commit_rule("mds") is env.cover_commit
    assert env.checker("maxcut") is env.always_feasible
    for problem in SUITE:
        env.ensure_padding_safe(problem)             # must not raise


def test_residual_false_defaults_to_the_assignment_commit():
    env.register("pt_assign", residual=False)(env.maxcut_step)
    try:
        assert env.commit_rule("pt_assign") is env.assignment_commit
        env.ensure_padding_safe("pt_assign")
    finally:
        env.unregister("pt_assign")


# -- tests/test_problem_suite.py's hand-built cases, on every rep ----------------------

def _path_and_isolated():
    a = np.zeros((4, 4), np.float32)
    a[0, 1] = a[1, 0] = a[1, 2] = a[2, 1] = 1
    return a


def _step(rep, a, problem, actions):
    """Both packages' states for graph ``a`` stepped through ``actions``
    (one node id a step); returns the per-step (state, reward, done) of
    each, the port's compared with JAX's field by field."""
    jst = jax_init_solve_state(jax_get_rep(rep), a[None], problem)
    pst = init_solve_state(get_rep(rep), a[None], problem, device="cpu")
    out = []
    for act in actions:
        jst, jr, jd = jax_env.make(problem)(jst, jnp.asarray([act]))
        pst, pr, pd = env.make(problem)(pst, torch.tensor([act]))
        _assert_state(pst, jst, rep, f"{problem} {rep} action {act}")
        assert float(pr[0]) == float(jr[0]) and bool(pd[0]) == bool(jd[0])
        out.append((pst, float(pr[0]), bool(pd[0])))
    return out


@pytest.mark.parametrize("rep", REPS)
def test_mis_step_removes_closed_neighborhood(rep):
    # path 0-1-2 plus isolated node 3: picking node 1 removes 0, 1, 2
    ((s2, r, done),) = _step(rep, _path_and_isolated(), "mis", [1])
    assert r == 1.0 and done
    assert s2.solution[0].tolist() == [0, 1, 0, 0]
    assert s2.candidate[0].sum() == 0               # 3 is padding, never in
    if rep == "dense":
        assert s2.adj.sum() == 0                    # closed nbhd removed


@pytest.mark.parametrize("rep", REPS)
def test_mis_residual_isolated_nodes_stay_candidates(rep):
    # star: center 0, leaves 1-3.  Picking leaf 1 removes {0, 1}; leaves
    # 2 and 3 become residual-isolated but stay eligible (free +1 each)
    a = np.zeros((4, 4), np.float32)
    a[0, 1:] = a[1:, 0] = 1
    (s2, _, d2), (_, r3, d3), (s4, _, d4) = _step(rep, a, "mis", [1, 2, 3])
    assert not d2 and s2.candidate[0].tolist() == [0, 0, 1, 1]
    assert r3 == 1.0 and not d3
    assert d4 and s4.solution[0].tolist() == [0, 1, 1, 1]


@pytest.mark.parametrize("rep", REPS)
def test_mds_step_covers_closed_neighborhood(rep):
    a = _path_and_isolated()
    s = init_solve_state(get_rep(rep), a[None], "mds", device="cpu")
    assert s.candidate[0].tolist() == [1, 1, 1, 0]
    ((s2, r, done),) = _step(rep, a, "mds", [1])
    assert r == -1.0 and done
    assert bool(env.is_dominating_set(torch.from_numpy(a)[None],
                                      s2.solution)[0])
    # a leaf pick does not finish (node 2 uncovered), padding stays out
    ((s3, _, done),) = _step(rep, a, "mds", [0])
    assert not done and s3.candidate[0, 3] == 0


@pytest.mark.parametrize("rep", REPS)
def test_maxcut_step_gains_and_assigns(rep):
    # path 0-1-2 plus isolated 3: node 1 cuts both edges, then node 0
    # joins S and uncuts one
    (_, r1, d1), (s2, r2, _), (_, r3, d3) = _step(
        rep, _path_and_isolated(), "maxcut", [1, 0, 2])
    assert (r1, r2, r3) == (2.0, -1.0, -1.0)
    assert not d1 and d3
    assert s2.candidate[0].tolist() == [0, 0, 1, 0]


def test_checkers_reject_infeasible():
    a = np.zeros((1, 3, 3), np.float32)
    a[0, 0, 1] = a[0, 1, 0] = 1
    both = np.asarray([[1.0, 1.0, 0.0]], np.float32)
    none = np.zeros((1, 3), np.float32)
    ta = torch.from_numpy(a)
    assert not bool(env.is_independent_set(ta, torch.from_numpy(both))[0])
    assert not bool(env.is_dominating_set(ta, torch.from_numpy(none))[0])
    assert float(env.cut_value(ta, torch.tensor([[1.0, 0.0, 0.0]]))[0]) == 1.0


@pytest.mark.parametrize("rep", REPS)
def test_mis_prune_drops_adjacent_picks_by_score(rep):
    """The raw top-d mask holds adjacent nodes; the prune keeps the higher
    scored of each adjacent pair and every independent pick."""
    # triangle 0-1-2 plus the pair 3-4
    a = np.zeros((5, 5), np.float32)
    a[0, 1] = a[1, 0] = a[1, 2] = a[2, 1] = a[0, 2] = a[2, 0] = 1
    a[3, 4] = a[4, 3] = 1
    sel = np.asarray([[1.0, 1.0, 0.0, 1.0, 1.0]], np.float32)
    scores = np.asarray([[0.9, 0.5, 0.1, 0.8, 0.2]], np.float32)
    st = init_solve_state(get_rep(rep), a[None], "mis", device="cpu")
    kept = env.mis_prune(st, torch.from_numpy(sel), torch.from_numpy(scores))
    assert kept[0].tolist() == [1.0, 0.0, 0.0, 1.0, 0.0]


# -- the rules on random states, bit for bit --------------------------------------------

@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_step_commit_prune_and_candidates_match_jax(rep, problem):
    """From the same re-materialized states (random partial solutions on
    ER(0.3) graphs with isolated padding nodes): the states bit for bit,
    one env step with actions candidate and not, the commit of a random
    selection, the prune of a random top-d mask with tied scores, and
    the candidate rule."""
    n, b = 20, 6
    adj = random_graph_batch("er", 16, 3, seed=3, rho=0.3)
    adj = np.stack([pad_adjacency(a, n) for a in adj])
    sol = _random_solutions(b, n, seed=4)
    jst, pst, _ = _states(rep, adj, sol, problem)
    _assert_state(pst, jst, rep, "state_from_tuples")
    rng = np.random.default_rng(5)
    action = rng.integers(0, n, b)
    j2, jr, jd = jax_env.make(problem)(jst, jnp.asarray(action))
    p2, pr, pd = env.make(problem)(pst, torch.from_numpy(action))
    _assert_state(p2, j2, rep, "step")
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))

    sel = (rng.random((b, n)) < 0.3).astype(np.float32) * np.asarray(
        jst.candidate)
    scores = np.round(rng.standard_normal((b, n)), 1).astype(np.float32)
    jprune, pprune = jax_env.prune_rule(problem), env.prune_rule(problem)
    if jprune is not None:
        jsel = jprune(jst, jnp.asarray(sel), jnp.asarray(scores))
        psel = pprune(pst, torch.from_numpy(sel), torch.from_numpy(scores))
        np.testing.assert_array_equal(psel.numpy(), np.asarray(jsel))
        sel = np.array(jsel)
    jc, jdone = jax_env.commit_rule(problem)(jst, jnp.asarray(sel))
    pc, pdone = env.commit_rule(problem)(pst, torch.from_numpy(sel))
    _assert_state(pc, jc, rep, "commit")
    np.testing.assert_array_equal(pdone.numpy(), np.asarray(jdone))
    if problem == "mds":
        np.testing.assert_array_equal(env.mds_candidates(pc).numpy(),
                                      np.asarray(jax_env.mds_candidates(jc)))


@pytest.mark.parametrize("rep", REPS)
def test_closed_helpers_match_jax(rep):
    from repro.core import graphs as jg
    from repro_torch.core import graphs as pg
    adj = random_graph_batch("er", 18, 3, seed=6, rho=0.3)
    sol = _random_solutions(3, 18, seed=7)
    if rep == "dense":
        want = jg.closed_neighborhood_keep_dense(jnp.asarray(adj),
                                                 jnp.asarray(sol))
        got = pg.closed_neighborhood_keep_dense(torch.from_numpy(adj),
                                                torch.from_numpy(sol))
    elif rep == "sparse":
        jb = jg.sparse_batch_from_dense(adj)
        pb = pg.sparse_batch_from_dense(adj, device="cpu")
        want = jg.closed_neighborhood_keep(jb.neighbors, jb.valid,
                                           jnp.asarray(sol))
        got = pg.closed_neighborhood_keep(pb.neighbors, pb.valid,
                                          torch.from_numpy(sol))
    else:
        jb = jg.csr_batch_from_dense(adj, max_edges=200)   # padded slots
        pb = pg.csr_batch_from_dense(adj, max_edges=200, device="cpu")
        jrid = jg.csr_row_ids(jb.indptr, 200)
        rid = pg.csr_row_ids(pb.indptr, 200)
        vals = np.abs(np.random.default_rng(8).standard_normal(
            (3, 200))).astype(np.float32)
        np.testing.assert_array_equal(
            pg.csr_segment_max(torch.from_numpy(vals), rid, 18).numpy(),
            np.asarray(jg.csr_segment_max(jnp.asarray(vals), jrid, 18)))
        want = jg.csr_closed_neighborhood_keep(jb.indices, jb.edge_mask,
                                               jrid, jnp.asarray(sol))
        got = pg.csr_closed_neighborhood_keep(pb.indices, pb.edge_mask, rid,
                                              torch.from_numpy(sol))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_checkers_and_cut_value_match_jax():
    adj = random_graph_batch("er", 20, 4, seed=9, rho=0.3)
    adj[1, 15:, :] = adj[1, :, 15:] = 0            # isolated nodes
    sols = [_random_solutions(4, 20, seed=s, p=p)
            for s, p in ((10, 0.1), (11, 0.5), (12, 0.9))]
    sols.append(jax_solvers.greedy_mis_batch(adj).astype(np.float32))
    sols.append(jax_solvers.greedy_mds_batch(adj).astype(np.float32))
    ta, ja = torch.from_numpy(adj), jnp.asarray(adj)
    for sol in sols:
        for fn in ("is_independent_set", "is_dominating_set", "cut_value",
                   "always_feasible", "is_cover"):
            np.testing.assert_array_equal(
                getattr(env, fn)(ta, torch.from_numpy(sol)).numpy(),
                np.asarray(getattr(jax_env, fn)(ja, jnp.asarray(sol))),
                err_msg=fn)
        for problem in SUITE:
            np.testing.assert_array_equal(
                env.checker(problem)(ta, torch.from_numpy(sol)).numpy(),
                np.asarray(jax_env.checker(problem)(ja, jnp.asarray(sol))))


# -- solve ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_solves(setup):
    """JAX's device-engine solves, computed once: the setup graphs
    (adaptive d) for every problem and rep, and the dense MIS graphs of
    tests/test_problem_suite.py's multi-node check."""
    adj, params, _ = setup
    out = {(p, r): jax_solve(params, adj, num_layers=2, multi_node=True,
                             rep=r, problem=p, engine="device")
           for p in PROBLEMS for r in REPS}
    dense_mis = random_graph_batch("er", 30, 3, seed=7, rho=0.4)
    for r in REPS:
        out["dense_mis", r] = jax_solve(params, dense_mis, num_layers=2,
                                        multi_node=True, rep=r, problem="mis",
                                        engine="device")
    return out, dense_mis


def _assert_same(j, t):
    np.testing.assert_array_equal(t.solution, j.solution)
    assert t.policy_evals == j.policy_evals
    np.testing.assert_array_equal(t.nodes_committed, j.nodes_committed)
    np.testing.assert_array_equal(t.sizes, j.sizes)


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_solve_identical_to_jax_and_feasible(setup, jax_solves, problem,
                                             rep):
    adj, _, policy = setup
    t = solve(policy, adj, num_layers=2, multi_node=True, rep=rep,
              problem=problem, device="cpu")
    _assert_same(jax_solves[0][problem, rep], t)
    assert env.checker(problem)(torch.from_numpy(adj),
                                torch.from_numpy(t.solution)).all()


@pytest.mark.parametrize("rep", REPS)
def test_multi_node_mis_stays_independent_as_jax(setup, jax_solves, rep):
    """Adaptive multi-node MIS on dense ER(0.4) graphs: JAX's solutions,
    independent, every committed node in S (the prune at work)."""
    _, _, policy = setup
    want, adj = jax_solves[0]["dense_mis", rep], jax_solves[1]
    t = solve(policy, adj, num_layers=2, multi_node=True, rep=rep,
              problem="mis", device="cpu")
    _assert_same(want, t)
    assert env.is_independent_set(torch.from_numpy(adj),
                                  torch.from_numpy(t.solution)).all()
    np.testing.assert_array_equal(t.nodes_committed, t.sizes)


@pytest.mark.parametrize("multi_node", [True, False])
def test_best_trajectory_cut_equals_jax(setup, multi_node):
    adj, params, policy = setup
    want = jax_best_cut(params, adj, num_layers=2, multi_node=multi_node)
    got = best_trajectory_cut(policy, adj, num_layers=2,
                              multi_node=multi_node, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert (got > 0).all()


# -- the mesh takes the three problems as it takes mvc -------------------------------

@pytest.mark.parametrize("problem", PROBLEMS)
def test_three_problems_refused_on_a_mesh(setup, problem):
    """The three problems are no longer refused on a mesh: without a
    process group, solve and the train step ask for the ranks' one
    (``spawn_mesh``) as mvc does; a mesh service queues their requests,
    and its ranks other than 0 refuse async submissions of them as of
    mvc's; an unknown problem is still a ValueError.  The mesh runs are
    tests/test_torch_problems_mesh.py's."""
    adj, _, policy = setup
    for spatial in ((1, 2), (2, 1), 2):
        for p in (problem, "mvc"):
            with pytest.raises(RuntimeError, match="spawn_mesh"):
                solve(policy, adj, problem=p, spatial=spatial, device="cpu")
            with pytest.raises(RuntimeError, match="spawn_mesh"):
                get_train_step(PolicyConfig(embed_dim=8, spatial=spatial),
                               problem=p)
    svc = GraphSolverService(policy, PolicyConfig(embed_dim=8), device="cpu")
    svc.mesh_shape = (2, 1)                        # as a mesh service holds
    assert svc.submit(adj[0], problem=problem) == 0
    assert svc.pending() == 1
    svc.mesh, svc.rank = object(), 1    # a follower of a mesh service
    with pytest.raises(ValueError, match="rank 0 is the service's one "
                                         "front end"):
        svc.submit_async(adj[0], problem=problem)
    with pytest.raises(ValueError, match="unknown environment"):
        solve(policy, adj, problem="nope", spatial=(1, 2), device="cpu")


# -- serving ----------------------------------------------------------------------

@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_serving_round_trip_padded_buckets(setup, problem, rep):
    """A mixed-size stream through the bucketing service equals the
    direct padded solve per request; padding never enters a solution;
    every answer is feasible on its original graph."""
    _, _, policy = setup
    cfg = PolicyConfig(embed_dim=8, num_layers=2)
    svc = GraphSolverService(policy, cfg, rep=rep, max_batch=3,
                             device="cpu")
    sizes = [6, 11, 6, 19, 11]
    svc.warmup(sizes, problems=[problem])
    adjs = [jax_erdos_renyi(n, 0.3, seed=20 + i) for i, n in
            enumerate(sizes)]
    responses = svc.serve(adjs, problem=problem)
    assert svc.stats.compiles == 0
    for r, a, n in zip(responses, adjs, sizes):
        nb = bucket_nodes(n)
        assert r.bucket == nb and r.problem == problem
        direct = solve(policy, pad_adjacency(a, nb)[None], num_layers=2,
                       multi_node=True, rep=rep, problem=problem,
                       device="cpu")
        assert (r.solution == direct.solution[0, :n]).all()
        assert direct.solution[0, n:].sum() == 0   # padding never selected
        assert bool(env.checker(problem)(
            torch.from_numpy(a)[None],
            torch.from_numpy(r.solution.astype(np.float32))[None])[0])


# -- the baselines ------------------------------------------------------------------

def test_solvers_equal_jax_on_padded_and_unpadded_batches():
    adj = random_graph_batch("er", 24, 4, seed=5, rho=0.25)
    pad = np.zeros((3, 32, 32), np.float32)
    for i, n in enumerate((10, 24, 17)):
        pad[i, :n, :n] = random_graph_batch("er", n, 1, seed=30 + i,
                                            rho=0.3)[0]
    for batch in (adj, pad):
        for problem in SUITE:
            np.testing.assert_array_equal(
                solvers.heuristic_batch(problem, batch),
                jax_solvers.heuristic_batch(problem, batch))
        np.testing.assert_array_equal(solvers.matching_2approx_batch(batch),
                                      jax_solvers.matching_2approx_batch(
                                          batch))
        np.testing.assert_array_equal(solvers.mvc_lower_bounds(batch),
                                      jax_solvers.mvc_lower_bounds(batch))
        np.testing.assert_array_equal(solvers.reference_sizes(batch),
                                      jax_solvers.reference_sizes(batch))
        np.testing.assert_array_equal(solvers.reference_sizes(
            batch, exact_limit=0), jax_solvers.reference_sizes(
            batch, exact_limit=0))
    for a in adj[:2]:
        assert solvers.exact_mvc_size(a) == jax_solvers.exact_mvc_size(a)
        assert solvers.mvc_lower_bound(a) == jax_solvers.mvc_lower_bound(a)
        np.testing.assert_array_equal(solvers.greedy_mvc(a),
                                      jax_solvers.greedy_mvc(a))
        np.testing.assert_array_equal(solvers.matching_2approx(a, seed=3),
                                      jax_solvers.matching_2approx(a, seed=3))
    for fn in (solvers.greedy_mis_batch, solvers.greedy_mds_batch,
               solvers.greedy_maxcut_batch):
        assert fn(pad)[:, 24:].sum() == 0 and fn(pad)[0, 10:].sum() == 0
    with pytest.raises(ValueError, match="no heuristic baseline"):
        solvers.heuristic_batch("nope", adj)


# -- bf16 -------------------------------------------------------------------------

def _objective(problem, adj, solution):
    if problem == "maxcut":
        return env.cut_value(torch.from_numpy(adj),
                             torch.from_numpy(solution)).numpy()
    return solution.sum(-1)


@pytest.mark.parametrize("problem", SUITE)
def test_bf16_quality_gate(problem):
    """tests/test_fused_kernel.py's gate on the port: bf16 solves stay
    feasible and within 10% of the f32 mean objective."""
    adj = random_graph_batch("er", 32, 8, seed=11, rho=0.25)
    params = jax_init_policy(jax.random.key(2), JaxPolicyConfig(embed_dim=16))
    policy = policy_from_numpy(jax_to_numpy(params), device="cpu")
    f32, b16 = (solve(policy, adj, num_layers=2, multi_node=True,
                      problem=problem, compute=c, device="cpu")
                for c in ("f32", "bf16"))
    assert env.checker(problem)(torch.from_numpy(adj),
                                torch.from_numpy(b16.solution)).all()
    obj_f32 = _objective(problem, adj, f32.solution).mean()
    obj_b16 = _objective(problem, adj, b16.solution).mean()
    assert abs(obj_b16 - obj_f32) <= 0.10 * abs(obj_f32) + 1e-9, (
        f"{problem}: bf16 mean objective {obj_b16} vs f32 {obj_f32}")


def test_evaluate_quality_refuses_maxcut():
    from repro_torch.core import Agent, evaluate_quality
    adj = random_graph_batch("er", 12, 2, seed=1, rho=0.3)
    agent = Agent(PolicyConfig(embed_dim=8), num_nodes=12, device="cpu")
    with pytest.raises(ValueError, match="best_trajectory_cut"):
        evaluate_quality(agent, adj, np.ones(2), problem="maxcut")
    ratio = evaluate_quality(agent, adj, solvers.heuristic_batch(
        "mis", adj).sum(-1), problem="mis")
    assert 0 < ratio



def test_chip_smoke_checkers_agree_with_the_port():
    """``chip_smoke.py`` holds the card's answers to numpy checkers of its
    own; on padded graphs and many solutions they agree with the port's
    (MaxCut's: the solve's complete assignment of the positive-degree
    nodes), and the phase's served graphs are two of each size."""
    from test_torch_walk import _chip_smoke
    cs = _chip_smoke()
    adj = random_graph_batch("er", 16, 3, seed=13, rho=0.3)
    adj[2, 12:, :] = adj[2, :, 12:] = 0
    sols = [_random_solutions(3, 16, seed=s, p=p)
            for s, p in ((14, 0.1), (15, 0.4), (16, 0.8))]
    sols += [solvers.heuristic_batch(p, adj).astype(np.float32)
             for p in SUITE]
    sols.append((adj.sum(-1) > 0).astype(np.float32))
    for sol in sols:
        for problem in SUITE:
            want = env.checker(problem)(torch.from_numpy(adj),
                                        torch.from_numpy(sol)).numpy()
            if problem == "maxcut":
                want = [np.array_equal(s > 0.5, a.sum(-1) > 0)
                        for a, s in zip(adj, sol)]
            got = [cs.CHECKS[problem](a, s) for a, s in zip(adj, sol)]
            assert got == list(want), problem
        np.testing.assert_array_equal(
            [cs.cut_size(a, s) for a, s in zip(adj, sol)],
            env.cut_value(torch.from_numpy(adj), torch.from_numpy(sol)))
    stream = [np.zeros((n, n), np.float32) for n in
              (500, 4000, 500, 1000, 500, 2000, 4000, 4000, 1000, 2000, 1000)]
    picked = cs.problem_graphs(stream)
    assert [a.shape[0] for a in picked] == [500, 4000, 500, 1000, 2000,
                                            4000, 1000, 2000]
