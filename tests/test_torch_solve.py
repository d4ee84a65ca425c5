"""The port's solve (repro_torch.core.{inference,engine,env,graphrep})
against JAX's fused solve on the CPU: solutions, eval counts and commit
counts identical, the bar tests/test_fused_solve.py holds between JAX's
own engines."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import PolicyConfig as JaxPolicyConfig
from repro.core import env as jax_env
from repro.core import init_policy as jax_init_policy
from repro.core import random_graph_batch
from repro.core import solve as jax_solve
from repro.core.inference import adaptive_d as jax_adaptive_d
from repro.core.inference import select_top_d as jax_select_top_d
from repro_torch.convert import policy_from_numpy
from repro_torch.core import (PolicyConfig, adaptive_d, env, init_state,
                              select_top_d, solve, solve_with_config)
from repro_torch.core.graphs import GraphState


def jax_to_numpy(params):
    return {f"{part}.{f.name}": np.asarray(getattr(getattr(params, part),
                                                   f.name))
            for part in ("em", "q")
            for f in dataclasses.fields(getattr(params, part))}


@pytest.fixture(scope="module")
def pair():
    params = jax_init_policy(jax.random.key(0), JaxPolicyConfig(embed_dim=8))
    return params, policy_from_numpy(jax_to_numpy(params), device="cpu")


def _assert_same(j, t):
    assert (j.solution == t.solution).all()
    assert j.policy_evals == t.policy_evals
    assert (j.nodes_committed == t.nodes_committed).all()
    assert (j.sizes == t.sizes).all()


@pytest.mark.parametrize("kind", ["er", "ba"])
@pytest.mark.parametrize("multi_node", [False, True])
@pytest.mark.parametrize("max_d", [8, 16])
def test_solve_identical_to_jax(pair, kind, multi_node, max_d):
    params, policy = pair
    kw = dict(rho=0.2) if kind == "er" else {}
    adj = random_graph_batch(kind, 30, 4, seed=0, **kw)
    j = jax_solve(params, adj, num_layers=2, multi_node=multi_node,
                  max_d=max_d, engine="device")
    t = solve(policy, adj, num_layers=2, multi_node=multi_node, max_d=max_d,
              device="cpu")
    _assert_same(j, t)
    assert env.is_cover(torch.from_numpy(adj),
                        torch.from_numpy(t.solution)).all()


def test_padded_batch_identical_and_padding_never_selected(pair):
    params, policy = pair
    adj = np.zeros((3, 32, 32), np.float32)
    for g, n in enumerate((11, 20, 32)):
        adj[g, :n, :n] = random_graph_batch("er", n, 1, seed=g, rho=0.3)[0]
    j = jax_solve(params, adj, num_layers=2, multi_node=True)
    t = solve(policy, adj, num_layers=2, multi_node=True, device="cpu")
    _assert_same(j, t)
    assert t.solution[0, 11:].sum() == 0 and t.solution[1, 20:].sum() == 0


def test_xla_lowering_and_config_route(pair):
    params, policy = pair
    adj = random_graph_batch("er", 24, 2, seed=3, rho=0.25)
    j = jax_solve(params, adj, num_layers=3, multi_node=True, kernel="xla")
    t = solve_with_config(policy, adj,
                          PolicyConfig(embed_dim=8, num_layers=3,
                                       kernel="xla"),
                          multi_node=True, device="cpu")
    _assert_same(j, t)


def test_edge_free_batch_takes_one_eval(pair):
    _, policy = pair
    res = solve(policy, np.zeros((2, 16, 16), np.float32), device="cpu")
    assert res.policy_evals == 1 and res.sizes.tolist() == [0, 0]


def test_max_evals_caps_the_loop(pair):
    params, policy = pair
    adj = random_graph_batch("er", 30, 2, seed=5, rho=0.3)
    j = jax_solve(params, adj, num_layers=2, max_evals=3)
    t = solve(policy, adj, num_layers=2, max_evals=3, device="cpu")
    _assert_same(j, t)
    assert t.policy_evals == 3


def test_caller_input_is_not_mutated(pair):
    _, policy = pair
    adj = random_graph_batch("er", 20, 2, seed=6, rho=0.3)
    before = adj.copy()
    solve(policy, adj, multi_node=True, device="cpu")
    assert (adj == before).all()
    t_adj = torch.from_numpy(adj.copy())
    solve(policy, t_adj, multi_node=True, device="cpu")
    assert (t_adj.numpy() == before).all()


@pytest.mark.parametrize("use_adaptive", [False, True])
def test_select_top_d_breaks_ties_like_lax_top_k(use_adaptive):
    scores = np.array([[1, 3, 3, 0, 3, -1e9, 3],
                       [-1e9] * 7,
                       [2, 2, 2, 2, 2, 2, 2]], np.float32)
    cand = (scores > -1e8).astype(np.float32)
    for max_d in (4, 8):
        js, jn = jax_select_top_d(jnp.asarray(scores), jnp.asarray(cand),
                                  use_adaptive, max_d)
        ts, tn = select_top_d(torch.from_numpy(scores),
                              torch.from_numpy(cand), use_adaptive, max_d)
        assert (np.asarray(js) == ts.numpy()).all()
        assert (np.asarray(jn) == tn.numpy()).all()
    # the issue's example: top-4 of the first row is nodes 1, 2, 4, 6
    ts, _ = select_top_d(torch.from_numpy(scores[:1]),
                         torch.ones((1, 7)), True, 4)
    assert ts[0].nonzero().flatten().tolist() == [1, 2, 4, 6]


def test_adaptive_d_schedule_matches_jax():
    n = 40
    c = np.arange(0, n + 1, dtype=np.float32)
    for max_d in (1, 8, 16, 256):
        j = np.asarray(jax_adaptive_d(jnp.asarray(c), n, max_d))
        t = adaptive_d(torch.from_numpy(c), n, max_d).numpy()
        assert (j == t).all()


def test_mvc_step_matches_jax():
    adj = random_graph_batch("er", 12, 3, seed=7, rho=0.4)
    action = np.array([0, 5, 11])
    js, jr, jd = jax_env.mvc_step(jax_env.reset(adj), jnp.asarray(action))
    ts, tr, td = env.mvc_step(init_state(adj, device="cpu"),
                              torch.from_numpy(action))
    for f in ("adj", "candidate", "solution"):
        assert (np.asarray(getattr(js, f)) == getattr(ts, f).numpy()).all()
    assert (np.asarray(jr) == tr.numpy()).all()
    assert (np.asarray(jd) == td.numpy()).all()


def test_padding_safety_probe_rejects_unsafe_env():
    assert env.ensure_padding_safe("mvc") is None

    def every_node(state):
        return torch.ones_like(state.candidate)

    env.register("pt_unsafe", candidates=every_node)(env.mvc_step)
    try:
        with pytest.raises(ValueError, match="padding-safety"):
            env.ensure_padding_safe("pt_unsafe")
    finally:
        env.unregister("pt_unsafe")


def test_unported_options_raise_not_implemented(pair):
    _, policy = pair
    adj = random_graph_batch("er", 10, 1, seed=0, rho=0.3)
    # the other problems solve on one device (tests/test_torch_problems.py)
    # and on a mesh, whose ranks they ask for as mvc does
    # (tests/test_torch_problems_mesh.py)
    for kw in (dict(problem="maxcut", spatial=2),
               dict(rep="sparse", problem="mis", spatial=(1, 2))):
        with pytest.raises(RuntimeError, match="spawn_mesh"):
            solve(policy, adj, device="cpu", **kw)
    # the per-evaluation loop runs on one device and gives the fused
    # solve's answer (tests/test_torch_host_engine.py holds it to JAX's)
    host = solve(policy, adj, device="cpu", engine="host")
    fused = solve(policy, adj, device="cpu")
    np.testing.assert_array_equal(host.solution, fused.solution)
    assert host.policy_evals == fused.policy_evals
    for kw in (dict(problem="maxcut"), dict(rep="sparse", problem="mis")):
        res = solve(policy, adj, device="cpu", **kw)
        assert env.checker(kw["problem"])(
            torch.from_numpy(adj), torch.from_numpy(res.solution)).all()
    # a mesh solve (tests/test_torch_mesh.py) refuses CSR at sp > 1 and
    # the host engine, and needs its ranks' process group
    for kw, err, msg in ((dict(rep="csr", spatial=2), ValueError,
                          "does not support spatial"),
                         (dict(engine="host", spatial=2), ValueError,
                          "fused path only"),
                         (dict(spatial=2), RuntimeError, "spawn_mesh")):
        with pytest.raises(err, match=msg):
            solve(policy, adj, device="cpu", **kw)
    with pytest.raises(ValueError):
        solve(policy, adj, device="cpu", problem="bogus")
    with pytest.raises(ValueError, match="graph representation"):
        solve(policy, adj, device="cpu", rep="coo")


def test_entry_points_default_to_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    _, policy = pair
    adj = random_graph_batch("er", 10, 1, seed=0, rho=0.3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(policy, adj)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(adj)


def test_graph_state_is_a_copy_on_the_requested_device():
    adj = random_graph_batch("er", 9, 1, seed=0, rho=0.3)[0]
    st = init_state(adj, device="cpu")
    assert isinstance(st, GraphState) and st.adj.shape == (1, 9, 9)
    st.adj.zero_()
    assert adj.sum() > 0


def test_solve_from_a_graph_state_leaves_it_unchanged(pair):
    """The dense commit zeroes the solve's adjacency in place; a state the
    caller passes in is copied first, as an array is."""
    _, policy = pair
    adj = random_graph_batch("er", 20, 2, seed=3, rho=0.3)
    st = init_state(adj, device="cpu")
    before = [t.clone() for t in (st.adj, st.candidate, st.solution)]
    from_state = solve(policy, st, num_layers=2, multi_node=True,
                       device="cpu")
    for t, b in zip((st.adj, st.candidate, st.solution), before):
        assert torch.equal(t, b)
    from_array = solve(policy, adj, num_layers=2, multi_node=True,
                       device="cpu")
    assert (from_state.solution == from_array.solution).all()
    assert from_state.policy_evals == from_array.policy_evals
