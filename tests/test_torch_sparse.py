"""The port's padded-sparse representation against the JAX package's on
the CPU: the builders give the same arrays, the residual factors agree
bit for bit, the plain versions of the sparse fused layer and the sparse
aggregation match the Pallas kernels (interpret mode) and the
``kernels/ref.py`` oracles, the embeddings match, and sparse solves equal
JAX's sparse solves and the port's dense solves."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import PolicyConfig as JaxPolicyConfig
from repro.core import env as jax_env
from repro.core import graphs as jg
from repro.core import init_policy as jax_init_policy
from repro.core import random_graph_batch
from repro.core import solve as jax_solve
from repro.core.s2v_sparse import embed_sparse as jax_embed_sparse
from repro.core.s2v_sparse import sparse_state_bytes as jax_state_bytes
from repro.kernels import ops, ref
from repro_torch.convert import policy_from_numpy
from repro_torch.core import (SPARSE, SparseRep, env, init_solve_state,
                              rep_for_state, solve, sparse_batch_from_dense,
                              sparse_init_state)
from repro_torch.core.graphs import SparseGraphState, residual_edge_mask
from repro_torch.core.mesh import single_axis
from repro_torch.core.s2v_sparse import (edge_factors, embed_sparse,
                                         embed_sparse_local,
                                         sparse_state_bytes)
from repro_torch.kernels import s2v_fused as ks
from repro_torch.kernels import s2v_gather as kg

# f32: the frameworks sum in different orders; bf16: one bf16 rounding
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JAX_CD = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def jax_to_numpy(params):
    return {f"{part}.{f.name}": np.asarray(getattr(getattr(params, part),
                                                   f.name))
            for part in ("em", "q")
            for f in dataclasses.fields(getattr(params, part))}


@pytest.fixture(scope="module")
def pair():
    params = jax_init_policy(jax.random.key(0), JaxPolicyConfig(embed_dim=8))
    return params, policy_from_numpy(jax_to_numpy(params), device="cpu")


def _graphs(b=3, n=20, rho=0.25, seed=1, isolate=0):
    adj = random_graph_batch("er", n, b, seed=seed, rho=rho)
    if isolate:
        adj[:, -isolate:, :] = 0.0
        adj[:, :, -isolate:] = 0.0
    return adj


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("max_degree", [None, 0, 19, 40])
def test_builder_gives_jax_arrays(max_degree):
    adj = _graphs(isolate=3)
    want = jg.sparse_batch_from_dense(adj, max_degree)
    got = sparse_batch_from_dense(adj, max_degree, device="cpu")
    assert got.neighbors.dtype == torch.int32 and got.valid.dtype == torch.bool
    np.testing.assert_array_equal(got.neighbors.numpy(),
                                  np.asarray(want.neighbors))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    st = sparse_init_state(got)
    jst = jg.sparse_init_state(want)
    np.testing.assert_array_equal(st.candidate.numpy(),
                                  np.asarray(jst.candidate))
    assert st.candidate.dtype == st.solution.dtype == torch.float32
    assert sparse_state_bytes(st) == jax_state_bytes(jst)


def test_builder_refuses_to_drop_edges():
    adj = _graphs()
    true_md = int(adj.sum(-1).max())
    with pytest.raises(ValueError, match="refusing to silently drop"):
        sparse_batch_from_dense(adj, true_md - 1, device="cpu")
    two_d = sparse_batch_from_dense(adj[0], device="cpu")
    assert two_d.neighbors.shape[0] == 1


@pytest.mark.parametrize("frac", [0.0, 0.3, 0.7])
def test_residual_edge_mask_matches_jax(frac):
    adj = _graphs(isolate=2)
    g = jg.sparse_batch_from_dense(adj, 24)
    sol = (np.random.default_rng(5).random(adj.shape[:2]) < frac
           ).astype(np.float32)
    want = np.asarray(jg.residual_edge_mask(g.neighbors, g.valid,
                                            jnp.asarray(sol)))
    got = residual_edge_mask(*_torch(np.asarray(g.neighbors),
                                     np.asarray(g.valid), sol))
    np.testing.assert_array_equal(got.numpy(), want)
    assert env.is_cover_sparse(*_torch(np.asarray(g.neighbors),
                                       np.asarray(g.valid),
                                       np.ones_like(sol))).all()


def _layer_case(b=2, k=16, n=37, rho=0.3, width=24, isolate=5, seed=3):
    rng = np.random.default_rng(seed)
    adj = (rng.random((b, n, n)) < rho).astype(np.float32)
    adj = np.maximum(adj, adj.transpose(0, 2, 1))
    np.einsum("bii->bi", adj)[:] = 0
    adj[:, -isolate:, :] = 0.0
    adj[:, :, -isolate:] = 0.0
    g = jg.sparse_batch_from_dense(adj, width)
    nbr, valid = np.asarray(g.neighbors), np.asarray(g.valid)
    edge = (valid * rng.random(valid.shape)).astype(np.float32)
    rand = lambda s: (rng.random(s, np.float32) - 0.5).astype(np.float32)  # noqa: E731
    return (rand((k, k)) * 0.2, rand((b, k, n)), nbr, edge,
            rand((b, k, n)))


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("k,tile", [(8, 8), (32, 16)])
def test_sparse_layer_plain_matches_pallas_and_oracle(compute, k, tile):
    t4, x, nbr, edge, base = _layer_case(k=k)
    got = ks.fused_s2v_layer_sparse_plain(*_torch(t4, x, nbr, edge, base),
                                          compute).numpy()
    pallas = np.asarray(ops.fused_s2v_layer_sparse(
        t4, x, nbr, edge, base, tile_n=tile, compute_dtype=JAX_CD[compute],
        interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL[compute])
    oracle = np.asarray(ref.s2v_layer_sparse(t4, x, nbr, edge, base))
    np.testing.assert_allclose(got, oracle, **TOL[compute])


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_sparse_layer_sentinels_are_inert(compute):
    """Sentinel slots add nothing even with a poisoned factor, and the
    isolated nodes (all-sentinel rows) give exactly relu(base)."""
    t4, x, nbr, edge, base = _layer_case()
    hot = edge.copy()
    hot[nbr == x.shape[-1]] = 5.0
    out = ks.fused_s2v_layer_sparse(*_torch(t4, x, nbr, hot, base), compute)
    want = ks.fused_s2v_layer_sparse(*_torch(t4, x, nbr, edge, base), compute)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    np.testing.assert_array_equal(out.numpy()[:, :, -5:],
                                  np.maximum(base[:, :, -5:], 0.0))


@pytest.mark.parametrize("tile", [8, 32])
def test_sparse_aggregate_plain_matches_pallas_and_oracle(tile):
    _, x, nbr, edge, _ = _layer_case(k=16)
    xp = np.pad(x, ((0, 0), (0, 0), (0, 1)))
    got = kg.sparse_mp_aggregate_plain(*_torch(xp, nbr, edge)).numpy()
    pallas = np.asarray(ops.sparse_mp_aggregate(xp, nbr, edge, tile_n=tile,
                                                interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL["f32"])
    oracle = np.asarray(ref.sparse_mp_aggregate(xp, nbr, edge))
    np.testing.assert_allclose(got, oracle, **TOL["f32"])
    assert not got[:, :, -5:].any()


@pytest.mark.parametrize("k,tile", [(16, 8), (7, 32)])
def test_sparse_aggregate_on_shuffled_slots_matches_pallas_and_oracle(k,
                                                                      tile):
    """Each node's slots in a random order: ids do not ascend and the
    sentinel slots lie among the real ones.  The kernel walks any list in
    slot order, so the plain version must agree with the Pallas kernel and
    the oracle on such lists as well."""
    _, x, nbr, edge, _ = _layer_case(k=k, seed=4)
    perm = np.argsort(np.random.default_rng(9).random(nbr.shape), axis=-1)
    nbr, edge = (np.take_along_axis(a, perm, -1) for a in (nbr, edge))
    n = x.shape[-1]
    real = nbr < n
    # some row has a sentinel slot before a real one, some ids descend
    assert (real[..., 1:] & ~real[..., :-1]).any()
    assert (np.diff(np.where(real, nbr, -1), axis=-1) < 0).any()
    xp = np.pad(x, ((0, 0), (0, 0), (0, 1)))
    got = kg.sparse_mp_aggregate_plain(*_torch(xp, nbr, edge)).numpy()
    pallas = np.asarray(ops.sparse_mp_aggregate(xp, nbr, edge, tile_n=tile,
                                                interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL["f32"])
    oracle = np.asarray(ref.sparse_mp_aggregate(xp, nbr, edge))
    np.testing.assert_allclose(got, oracle, **TOL["f32"])
    assert not got[:, :, -5:].any()


@pytest.mark.parametrize("k", [1, 7, 8, 30, 32])
def test_padded_node_major_pads_rows_to_whole_vectors(k):
    """The kernel's copy of x: node-major, each row padded with zeros to a
    multiple of 4 floats."""
    x = torch.from_numpy(np.random.default_rng(k).random((2, k, 9),
                                                         np.float32))
    xt = kg.padded_node_major(x)
    kp = -(-k // 4) * 4
    assert xt.shape == (2, 9, kp) and xt.is_contiguous()
    assert torch.equal(xt[:, :, :k], x.transpose(1, 2))
    assert not xt[:, :, k:].any()


def test_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing():
    t4, x, nbr, edge, base = _torch(*_layer_case())
    xp = torch.nn.functional.pad(x, (0, 1))
    before = (ks.fused_s2v_layer_sparse.launches,
              kg.sparse_mp_aggregate.launches)
    for compute in ("f32", "bf16"):
        torch.testing.assert_close(
            ks.fused_s2v_layer_sparse(t4, x, nbr, edge, base, compute),
            ks.fused_s2v_layer_sparse_plain(t4, x, nbr, edge, base, compute),
            rtol=0, atol=0)
    torch.testing.assert_close(kg.sparse_mp_aggregate(xp, nbr, edge),
                               kg.sparse_mp_aggregate_plain(xp, nbr, edge),
                               rtol=0, atol=0)
    assert (ks.fused_s2v_layer_sparse.launches,
            kg.sparse_mp_aggregate.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    t4, x, nbr, edge, base = _torch(*_layer_case())
    with pytest.raises(TypeError, match="int32"):
        ks.fused_s2v_layer_sparse(t4, x, nbr.long(), edge, base)
    with pytest.raises(ValueError, match="shape"):
        ks.fused_s2v_layer_sparse(t4, x, nbr, edge[:, :-1].contiguous(),
                                  base)
    with pytest.raises(ValueError, match="compute"):
        ks.fused_s2v_layer_sparse(t4, x, nbr, edge, base, "fp8")
    with pytest.raises(ValueError, match="shape"):
        kg.sparse_mp_aggregate(x, nbr, edge)        # no sentinel column
    with pytest.raises(ValueError, match="contiguous"):
        kg.sparse_mp_aggregate(
            torch.nn.functional.pad(x, (0, 1)).transpose(1, 2)
            .contiguous().transpose(1, 2), nbr, edge)


@pytest.mark.parametrize("kernel", ["fused", "xla"])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("residual", [True, False])
def test_embed_sparse_matches_jax(pair, kernel, compute, residual):
    params, policy = pair
    adj = _graphs(isolate=2)
    sol = (np.random.default_rng(2).random(adj.shape[:2]) < 0.3
           ).astype(np.float32)
    g = jg.sparse_batch_from_dense(adj)
    want = np.asarray(jax_embed_sparse(params.em, g, jnp.asarray(sol),
                                       num_layers=3, residual=residual,
                                       kernel=kernel, compute=compute))
    got = embed_sparse(policy.em, sparse_batch_from_dense(adj, device="cpu"),
                       torch.from_numpy(sol), num_layers=3,
                       residual=residual, kernel=kernel, compute=compute)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL[compute])


def test_unported_sparse_modes_raise(pair):
    """The closed mode (MIS) runs on one device, equal to JAX's factors
    and re-materialization, and on a mesh's graph axis (the mesh runs
    are tests/test_torch_problems_mesh.py's)."""
    _, policy = pair
    adj = _graphs()
    g = sparse_batch_from_dense(adj, device="cpu")
    sol = (torch.arange(adj.shape[1]) % 5 == 0).float().expand(
        adj.shape[0], -1).contiguous()
    jb = jg.sparse_batch_from_dense(adj)
    from repro.core.s2v_sparse import edge_factors as jax_edge_factors
    np.testing.assert_array_equal(
        edge_factors(g.neighbors, g.valid, sol, "closed").numpy(),
        np.asarray(jax_edge_factors(jb.neighbors, jb.valid,
                                    jnp.asarray(sol.numpy()), "closed")))
    # on a mesh's graph axis (here of size 1, which communicates nothing)
    # the closed factors are the single-device ones
    assert torch.equal(edge_factors(g.neighbors, g.valid, sol, "closed",
                                    axis=single_axis("graph")),
                       edge_factors(g.neighbors, g.valid, sol, "closed"))
    with pytest.raises(TypeError, match="mesh axis"):
        embed_sparse_local(policy.em, g.neighbors, g.valid.float(), sol,
                           num_layers=2, axis="graph")
    from repro.core import SPARSE as JAX_SPARSE
    got = SPARSE.state_from_tuples(g, [0], sol[:1], residual="closed")
    want = JAX_SPARSE.state_from_tuples(jb, np.array([0]),
                                        sol[:1].numpy(), residual="closed")
    for f in ("neighbors", "valid", "candidate", "solution"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.residual == want.residual == "closed"


def _assert_same(a, b):
    assert (a.solution == b.solution).all()
    assert a.policy_evals == b.policy_evals
    assert (a.nodes_committed == b.nodes_committed).all()


@pytest.mark.parametrize("kind", ["er", "ba"])
@pytest.mark.parametrize("multi_node", [False, True])
@pytest.mark.parametrize("kernel", ["fused", "xla"])
def test_sparse_solve_identical_to_jax_and_dense(pair, kind, multi_node,
                                                 kernel):
    params, policy = pair
    kw = dict(rho=0.2) if kind == "er" else {}
    adj = random_graph_batch(kind, 30, 4, seed=0, **kw)
    j = jax_solve(params, adj, num_layers=2, multi_node=multi_node,
                  rep="sparse", kernel=kernel)
    t = solve(policy, adj, num_layers=2, multi_node=multi_node, rep="sparse",
              kernel=kernel, device="cpu")
    _assert_same(j, t)
    _assert_same(t, solve(policy, adj, num_layers=2, multi_node=multi_node,
                          device="cpu"))
    g = sparse_batch_from_dense(adj, device="cpu")
    assert env.is_cover_sparse(g.neighbors, g.valid,
                               torch.from_numpy(t.solution)).all()


def test_prebuilt_batch_and_state_are_never_written(pair):
    """A solve from a caller's batch or state shares its topology and
    leaves every tensor of it as it was."""
    _, policy = pair
    adj = _graphs(b=2, n=24)
    g = sparse_batch_from_dense(adj, device="cpu")
    st = sparse_init_state(g)
    before = [t.clone() for t in (g.neighbors, g.valid, st.candidate,
                                  st.solution)]
    from_batch = solve(policy, g, rep="sparse", multi_node=True,
                       device="cpu")
    from_state = solve(policy, st, rep=SparseRep(), multi_node=True,
                       device="cpu")
    for t, b in zip((g.neighbors, g.valid, st.candidate, st.solution),
                    before):
        assert torch.equal(t, b)
    _assert_same(from_batch, from_state)
    s0 = init_solve_state(SPARSE, g, device="cpu")
    assert s0.neighbors is g.neighbors and rep_for_state(s0) is SPARSE


def test_mvc_step_on_sparse_states_matches_jax():
    adj = _graphs(b=3, n=14, rho=0.35)
    action = np.array([0, 5, 13])
    js, jr, jd = jax_env.mvc_step(jg.sparse_init_state(
        jg.sparse_batch_from_dense(adj)), jnp.asarray(action))
    ts, tr, td = env.mvc_step(sparse_init_state(
        sparse_batch_from_dense(adj, device="cpu")), torch.from_numpy(action))
    assert isinstance(ts, SparseGraphState)
    for f in ("candidate", "solution"):
        assert (np.asarray(getattr(js, f)) == getattr(ts, f).numpy()).all()
    assert (np.asarray(jr) == tr.numpy()).all()
    assert (np.asarray(jd) == td.numpy()).all()
