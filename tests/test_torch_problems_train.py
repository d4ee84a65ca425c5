"""Training MaxCut, MIS and MDS in the port on one device against the JAX
package on the CPU: the fused train step in lockstep with JAX's, with
JAX's weights and draws, on the dense, sparse and CSR reps in both target
modes; the closed-mode (MIS) factors and the sparse and CSR layers'
closed-form backwards over them; ``train_agent`` on the new problems.

Bars: the same actions, losses and parameters within rtol 1e-5 / atol
1e-6 of JAX's step (``tests/test_torch_train.py``'s bar); the closed
factors bit for bit JAX's and symmetric; the backwards within 1e-5 (f32)
and 2e-2 (bf16) of autograd through the plain compositions and of
``jax.vjp`` through JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import s2v_csr as jax_csr
from repro.core import s2v_sparse as jax_sparse
from repro.core.graphs import csr_batch_from_dense as jax_csr_batch
from repro.core.graphs import csr_row_ids as jax_csr_row_ids
from repro.core.graphs import sparse_batch_from_dense as jax_sparse_batch
from repro.core.s2v_csr import _csr_layer_jnp
from repro.core.s2v_sparse import _sparse_layer_jnp
from repro_torch.convert import policy_to_numpy
from repro_torch.core import Agent, PolicyConfig, train_agent
from repro_torch.core import s2v_csr as core_csr
from repro_torch.core import s2v_sparse as core_sparse
from repro_torch.core.graphs import (csr_batch_from_dense, csr_row_ids,
                                     random_graph_batch,
                                     sparse_batch_from_dense)
from repro_torch.kernels.s2v_csr import fused_s2v_layer_csr_plain
from repro_torch.kernels.s2v_fused import fused_s2v_layer_sparse_plain
from test_torch_train import _assert_lockstep, _lockstep

PROBLEMS = ("maxcut", "mis", "mds")
REPS = ("dense", "sparse", "csr")
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
CD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
# tests/test_problem_suite.py's train smoke: 4 episode graphs of n = 14,
# minibatch 8, tau 2, 6 steps (warm from the second)
SMOKE = dict(n=14, b=4, gi=(0, 1, 2, 3), mb=8, tau=2, steps=6)


# -- the fused train step against JAX's ------------------------------------------------

@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_stored_mode_greedy_step_matches_jax(problem, rep):
    out, want, got = _lockstep("stored", eps=0.0, rep=rep, problem=problem,
                               **SMOKE)
    _assert_lockstep(out, want, got)


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_fresh_mode_exploring_step_matches_jax_with_its_draws(problem, rep):
    out, want, got = _lockstep("fresh", eps=0.5, rep=rep, problem=problem,
                               **SMOKE)
    assert out["explored"] >= 4              # rows that took JAX's picks
    _assert_lockstep(out, want, got)


# -- the closed factors and the layers' backwards over them ----------------------------

def _closed_layer(rep, b=3, k=8, n=30, seed=0):
    """One layer's inputs with MIS's closed factors on env-built graphs
    and a random partial solution: the fused layer, its plain
    composition, JAX's composition over numpy arrays, (theta4, x, base,
    grad), and the factors with JAX's."""
    rng = np.random.default_rng(seed)
    adj = random_graph_batch("er", n, b, seed=seed + 1, rho=0.3)
    sol = (rng.random((b, n)) < 0.15).astype(np.float32)
    dense = [(rng.standard_normal((k, k)) * 0.3).astype(np.float32),
             np.abs(rng.standard_normal((b, k, n))).astype(np.float32),
             rng.standard_normal((b, k, n)).astype(np.float32),
             rng.standard_normal((b, k, n)).astype(np.float32)]
    if rep == "sparse":
        g = sparse_batch_from_dense(adj, device="cpu")
        edge = core_sparse.edge_factors(g.neighbors, g.valid,
                                        torch.from_numpy(sol), "closed")
        jg = jax_sparse_batch(adj)
        want = jax_sparse.edge_factors(jg.neighbors, jg.valid,
                                       jnp.asarray(sol), "closed")
        topo = (g.neighbors, edge)
        fused = core_sparse._FusedSparseLayer.apply
        plain = fused_s2v_layer_sparse_plain

        def jax_fn(t4, x, base, cd):
            return _sparse_layer_jnp(t4, x, g.neighbors.numpy(),
                                     edge.numpy(), base, cd)
    else:
        g = csr_batch_from_dense(adj, device="cpu")
        rid = csr_row_ids(g.indptr, g.num_edges)
        edge = core_csr.csr_edge_factors(g.indices, g.edge_mask, rid,
                                         torch.from_numpy(sol), "closed")
        jg = jax_csr_batch(adj)
        want = jax_csr.csr_edge_factors(
            jg.indices, jg.edge_mask, jax_csr_row_ids(jg.indptr,
                                                      jg.indices.shape[1]),
            jnp.asarray(sol), "closed")
        topo = (g.indices, g.indptr, edge)
        fused = core_csr._FusedCsrLayer.apply
        plain = fused_s2v_layer_csr_plain

        def jax_fn(t4, x, base, cd):
            return _csr_layer_jnp(t4, x, g.indices.numpy(), rid.numpy(),
                                  edge.numpy(), base, cd)
    return (lambda t4, x, base, c: fused(t4, x, *topo, base, c),
            lambda t4, x, base, c: plain(t4, x, *topo, base, c),
            jax_fn, dense, (adj, sol, edge, want))


def _grads(fn, dense, compute):
    t4, x, base, g = dense
    ins = [torch.tensor(a, requires_grad=True) for a in (t4, x, base)]
    return torch.autograd.grad(fn(*ins, compute), ins, torch.from_numpy(g))


@pytest.mark.parametrize("rep", ("sparse", "csr"))
def test_closed_factors_equal_jax_and_are_symmetric(rep):
    """MIS's factors valid · keep[u] · keep[v] bit for bit JAX's; laid out
    on the dense grid they are symmetric, which the self-adjoint
    backwards need, and they remove exactly S ∪ N(S)."""
    _, _, _, _, (adj, sol, edge, want) = _closed_layer(rep)
    np.testing.assert_array_equal(edge.numpy(), np.asarray(want))
    b, n = sol.shape
    grid = np.zeros((b, n, n), np.float32)
    if rep == "sparse":
        g = sparse_batch_from_dense(adj, device="cpu")
        bi, u, s = np.nonzero(g.valid.numpy())
        grid[bi, u, g.neighbors.numpy()[bi, u, s]] = edge.numpy()[bi, u, s]
    else:
        g = csr_batch_from_dense(adj, device="cpu")
        rid = csr_row_ids(g.indptr, g.num_edges).numpy()
        bi, j = np.nonzero(g.edge_mask.numpy())
        grid[bi, rid[bi, j], g.indices.numpy()[bi, j]] = edge.numpy()[bi, j]
    np.testing.assert_array_equal(grid, grid.transpose(0, 2, 1))
    gone = (sol + np.einsum("bnm,bm->bn", adj, sol)) > 0
    keep = (~gone).astype(np.float32)
    np.testing.assert_array_equal(grid, adj * keep[:, :, None]
                                  * keep[:, None, :])


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("rep", ("sparse", "csr"))
def test_closed_mode_backward_is_autograd_of_the_plain_composition(
        rep, compute):
    fused, plain, _, dense, _ = _closed_layer(rep)
    for got, want in zip(_grads(fused, dense, compute),
                         _grads(plain, dense, compute)):
        torch.testing.assert_close(got, want, **TOL[compute])


@pytest.mark.parametrize("rep", ("sparse", "csr"))
def test_closed_mode_backward_matches_jax_vjp(rep):
    fused, _, jax_fn, dense, _ = _closed_layer(rep, b=2, k=16, n=40, seed=3)
    t4, x, base, g = dense
    _, vjp = jax.vjp(lambda a, e, b_: jax_fn(a, e, b_, CD["f32"]),
                     t4, x, base)
    for got, want in zip(_grads(fused, dense, "f32"), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["f32"])


# -- train_agent -------------------------------------------------------------------

@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_train_agent_trains_the_new_problems(problem, rep):
    """tests/test_problem_suite.py's ``train_agent`` smoke (n=12, 4
    graphs, 3 episodes, tau 1, at most 20 steps) for each problem and
    rep: the env's candidate rule threads through re-materialization,
    the warm losses are finite and the policy moves."""
    n = 12
    train = random_graph_batch("er", n, 4, seed=0, rho=0.3)
    cfg = PolicyConfig(embed_dim=8, num_layers=2, minibatch=8,
                       replay_capacity=256, learning_rate=1e-3,
                       graph_rep=rep)
    agent = Agent(cfg, num_nodes=n, device="cpu")
    before = {k: v.copy() for k, v in policy_to_numpy(agent.params).items()}
    log = train_agent(agent, train, problem=problem, episodes=3, tau=1,
                      max_steps=20, seed=0)
    assert len(log.losses) > 0 and np.isfinite(log.losses[-1])
    assert agent.step_count == int(np.isfinite(log.losses).sum()) > 0
    assert any(not np.array_equal(v, before[k])
               for k, v in policy_to_numpy(agent.params).items())
