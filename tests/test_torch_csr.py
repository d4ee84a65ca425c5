"""The port's CSR representation against the JAX package's on the CPU:
builders and streaming BA generation give the same arrays, row ids and the
segment sum agree, the CSR fused layer's plain version matches the Pallas
kernel (interpret mode) and the JAX composition with padded edges inert,
embeddings match, and dense, sparse and CSR solves are identical."""
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
from repro.core.s2v_csr import _csr_layer_jnp
from repro.core.s2v_csr import csr_state_bytes as jax_state_bytes
from repro.core.s2v_csr import embed_csr as jax_embed_csr
from repro.kernels import ops
from repro_torch.convert import policy_from_numpy
from repro_torch.core import (CSR, SPARSE, CsrRep, barabasi_albert_edges,
                              cached_ba_csr, csr_batch_from_arrays,
                              csr_batch_from_dense, csr_batch_to_dense,
                              csr_from_edges, csr_init_state, csr_row_ids,
                              csr_segment_sum, env, init_solve_state,
                              rep_for_state, solve)
from repro_torch.core.graphs import CsrGraphState, csr_residual_edge_mask
from repro_torch.core.s2v_csr import (csr_edge_factors, csr_state_bytes,
                                      embed_csr)
from repro_torch.kernels import s2v_csr as kc

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


def _graphs(b=3, n=20, rho=0.25, seed=2, empty_rows=()):
    adj = random_graph_batch("er", n, b, seed=seed, rho=rho)
    for r in empty_rows:
        adj[:, r, :] = 0.0
        adj[:, :, r] = 0.0
    return adj


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _same_batch(got, want):
    for f in ("indptr", "indices", "edge_mask"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == (torch.bool if f == "edge_mask" else torch.int32)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


@pytest.mark.parametrize("max_edges", [None, 0, 200])
def test_builders_give_jax_arrays_and_round_trip(max_edges):
    adj = _graphs(empty_rows=(0, 7, 8, 19))
    want = jg.csr_batch_from_dense(adj, max_edges)
    got = csr_batch_from_dense(adj, max_edges, device="cpu")
    _same_batch(got, want)
    np.testing.assert_array_equal(csr_batch_to_dense(got), adj)
    st, jst = csr_init_state(got), jg.csr_init_state(want)
    np.testing.assert_array_equal(st.candidate.numpy(),
                                  np.asarray(jst.candidate))
    assert csr_state_bytes(st) == jax_state_bytes(jst)


def test_builders_refuse_to_drop_edges():
    adj = _graphs()
    true_e = int(adj.sum(axis=(1, 2)).max())
    with pytest.raises(ValueError, match="refusing to silently drop"):
        csr_batch_from_dense(adj, true_e - 1, device="cpu")
    ip, ix = jg.csr_from_edges(30, *jg.barabasi_albert_edges(30, 3, seed=1))
    with pytest.raises(ValueError, match="refusing to silently drop"):
        csr_batch_from_arrays(ip, ix, len(ix) - 1, device="cpu")
    _same_batch(csr_batch_from_arrays(ip, ix, len(ix) + 9, device="cpu"),
                jg.csr_batch_from_arrays(ip, ix, len(ix) + 9))


def test_row_ids_with_empty_rows_and_padding_and_segment_sum():
    adj = _graphs(b=2, n=16, empty_rows=(0, 5, 6, 15))
    g = jg.csr_batch_from_dense(adj, max_edges=200)
    want = np.asarray(jg.csr_row_ids(g.indptr, 200))
    got = csr_row_ids(torch.from_numpy(np.array(g.indptr)), 200)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    vals = (np.random.default_rng(1).standard_normal((2, 200))
            * np.asarray(g.edge_mask)).astype(np.float32)
    np.testing.assert_allclose(
        csr_segment_sum(torch.from_numpy(vals), got, 16).numpy(),
        np.asarray(jg.csr_segment_sum(jnp.asarray(vals), jnp.asarray(want),
                                      16)), rtol=1e-6, atol=1e-6)
    sol = (np.random.default_rng(2).random((2, 16)) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        csr_residual_edge_mask(*_torch(np.asarray(g.indices),
                                       np.asarray(g.edge_mask)), got,
                               torch.from_numpy(sol)).numpy(),
        np.asarray(jg.csr_residual_edge_mask(g.indices, g.edge_mask, want,
                                             jnp.asarray(sol))))


@pytest.mark.parametrize("n,d,seed", [(300, 5, 3), (1000, 10, 0)])
def test_streaming_ba_matches_jax(n, d, seed):
    src, dst = barabasi_albert_edges(n, d, seed=seed)
    jsrc, jdst = jg.barabasi_albert_edges(n, d, seed=seed)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    ip, ix = csr_from_edges(n, src, dst)
    jip, jix = jg.csr_from_edges(n, jsrc, jdst)
    assert ip.dtype == ix.dtype == np.int32
    np.testing.assert_array_equal(ip, jip)
    np.testing.assert_array_equal(ix, jix)
    ip2, ix2 = csr_from_edges(n, src, dst, dedupe=False)
    jip2, jix2 = jg.csr_from_edges(n, jsrc, jdst, dedupe=False)
    np.testing.assert_array_equal(ip2, jip2)
    np.testing.assert_array_equal(ix2, jix2)


def test_cached_ba_csr_round_trip(tmp_path):
    ip1, ix1 = cached_ba_csr(400, d=4, seed=7, cache_dir=tmp_path)
    assert (tmp_path / "ba_n400_d4_s7.npz").exists()
    ip2, ix2 = cached_ba_csr(400, d=4, seed=7, cache_dir=tmp_path)
    np.testing.assert_array_equal(ip1, ip2)
    np.testing.assert_array_equal(ix1, ix2)
    jip, jix = jg.csr_from_edges(400, *jg.barabasi_albert_edges(400, 4,
                                                                seed=7))
    np.testing.assert_array_equal(ip1, jip)
    np.testing.assert_array_equal(ix1, jix)


def _layer_case(b=2, k=16, n=24, rho=0.3, max_edges=400, isolate=6, seed=4):
    rng = np.random.default_rng(seed)
    adj = (rng.random((b, n, n)) < rho).astype(np.float32)
    adj = np.maximum(adj, adj.transpose(0, 2, 1))
    np.einsum("bii->bi", adj)[:] = 0
    adj[:, -isolate:, :] = 0.0
    adj[:, :, -isolate:] = 0.0
    g = jg.csr_batch_from_dense(adj, max_edges=max_edges)
    e = g.indices.shape[1]
    rid = jg.csr_row_ids(g.indptr, e)
    rand = lambda s: (rng.random(s, np.float32) - 0.5).astype(np.float32)  # noqa: E731
    edge_w = (np.asarray(g.edge_mask) * rng.random((b, e))).astype(np.float32)
    return (g, rid, rand((k, k)) * 0.2, rand((b, k, n)), edge_w,
            rand((b, k, n)))


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("tile_e", [16, 128])
def test_csr_layer_plain_matches_pallas_and_jnp(compute, tile_e):
    g, rid, t4, x, edge_w, base = _layer_case()
    got = kc.fused_s2v_layer_csr_plain(
        *_torch(t4, x, np.asarray(g.indices), np.asarray(g.indptr), edge_w,
                base), compute).numpy()
    pallas = np.asarray(ops.fused_s2v_layer_csr(
        t4, x, g.indices, rid, edge_w, base, tile_e=tile_e,
        compute_dtype=JAX_CD[compute], interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL[compute])
    jn = np.asarray(_csr_layer_jnp(t4, jnp.asarray(x), g.indices, rid,
                                   jnp.asarray(edge_w), jnp.asarray(base),
                                   JAX_CD[compute]))
    np.testing.assert_allclose(got, jn, **TOL[compute])


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_csr_layer_padding_inert_and_isolated_nodes(compute):
    """Padded edge slots (sentinel id) add nothing even with a poisoned
    factor; isolated nodes give exactly relu(base); the wrapper on CPU
    tensors is the plain version and launches nothing."""
    g, _, t4, x, edge_w, base = _layer_case()
    hot = edge_w.copy()
    hot[~np.asarray(g.edge_mask)] = 5.0
    idx, iptr = np.asarray(g.indices), np.asarray(g.indptr)
    before = kc.fused_s2v_layer_csr.launches
    out = kc.fused_s2v_layer_csr(*_torch(t4, x, idx, iptr, hot, base),
                                 compute)
    want = kc.fused_s2v_layer_csr_plain(
        *_torch(t4, x, idx, iptr, edge_w, base), compute)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert kc.fused_s2v_layer_csr.launches == before
    np.testing.assert_array_equal(out.numpy()[:, :, -6:],
                                  np.maximum(base[:, :, -6:], 0.0))


def test_csr_wrapper_rejects_what_the_kernel_does_not_take():
    g, _, t4, x, edge_w, base = _layer_case()
    t4, x, idx, iptr, edge_w, base = _torch(
        t4, x, np.asarray(g.indices), np.asarray(g.indptr), edge_w, base)
    with pytest.raises(TypeError, match="int32"):
        kc.fused_s2v_layer_csr(t4, x, idx, iptr.long(), edge_w, base)
    with pytest.raises(ValueError, match="shape"):
        kc.fused_s2v_layer_csr(t4, x, idx, iptr[:, :-1].contiguous(),
                               edge_w, base)
    with pytest.raises(ValueError, match="K <= 32"):
        kc.fused_s2v_layer_csr(torch.zeros(40, 40), torch.zeros(2, 40, 24),
                               idx, iptr, edge_w, torch.zeros(2, 40, 24))


@pytest.mark.parametrize("kernel", ["fused", "xla"])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("residual", [True, False])
def test_embed_csr_matches_jax(pair, kernel, compute, residual):
    params, policy = pair
    adj = _graphs(empty_rows=(3, 4))
    sol = (np.random.default_rng(3).random(adj.shape[:2]) < 0.3
           ).astype(np.float32)
    g = jg.csr_batch_from_dense(adj, max_edges=150)
    want = np.asarray(jax_embed_csr(params.em, g, jnp.asarray(sol),
                                    num_layers=3, residual=residual,
                                    kernel=kernel, compute=compute))
    got = embed_csr(policy.em, csr_batch_from_dense(adj, 150, device="cpu"),
                    torch.from_numpy(sol), num_layers=3, residual=residual,
                    kernel=kernel, compute=compute)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL[compute])


def test_unported_csr_modes_raise():
    """The closed mode (MIS) runs on one device, equal to JAX's factors
    and re-materialization (CSR has no graph-axis mesh path at all)."""
    from repro.core import CSR as JAX_CSR
    from repro.core.s2v_csr import csr_edge_factors as jax_edge_factors
    adj = _graphs()
    g = csr_batch_from_dense(adj, device="cpu")
    rid = csr_row_ids(g.indptr, g.num_edges)
    sol = (torch.arange(20) % 4 == 1).float().expand(3, -1).contiguous()
    jb = jg.csr_batch_from_dense(adj)
    np.testing.assert_array_equal(
        csr_edge_factors(g.indices, g.edge_mask, rid, sol, "closed").numpy(),
        np.asarray(jax_edge_factors(
            jb.indices, jb.edge_mask, jg.csr_row_ids(jb.indptr,
                                                     jb.indices.shape[1]),
            jnp.asarray(sol.numpy()), "closed")))
    got = CSR.state_from_tuples(CSR.prepare_dataset(adj, device="cpu"),
                                [0], sol[:1], residual="closed")
    want = JAX_CSR.state_from_tuples(JAX_CSR.prepare_dataset(adj),
                                     np.array([0]), sol[:1].numpy(),
                                     residual="closed")
    for f in ("indptr", "indices", "edge_mask", "candidate", "solution"):
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
def test_three_rep_solve_parity_and_jax(pair, kind, multi_node, kernel):
    params, policy = pair
    kw = dict(rho=0.15) if kind == "er" else {}
    adj = random_graph_batch(kind, 32, 3, seed=4, **kw)
    outs = {rep: solve(policy, adj, num_layers=2, multi_node=multi_node,
                       rep=rep, kernel=kernel, device="cpu")
            for rep in ("dense", "sparse", "csr")}
    _assert_same(outs["dense"], outs["sparse"])
    _assert_same(outs["dense"], outs["csr"])
    _assert_same(jax_solve(params, adj, num_layers=2, multi_node=multi_node,
                           rep="csr", kernel=kernel), outs["csr"])
    assert env.is_cover(torch.from_numpy(adj),
                        torch.from_numpy(outs["csr"].solution)).all()


def test_csr_batch_solves_directly_and_is_never_written(pair):
    _, policy = pair
    adj = _graphs(b=2, n=24)
    g = csr_batch_from_dense(adj, device="cpu")
    before = [t.clone() for t in (g.indptr, g.indices, g.edge_mask)]
    via_csr = solve(policy, g, rep="csr", multi_node=True, device="cpu")
    _assert_same(via_csr, solve(policy, adj, multi_node=True, device="cpu"))
    for t, b in zip((g.indptr, g.indices, g.edge_mask), before):
        assert torch.equal(t, b)
    st = init_solve_state(CsrRep(max_edges=500), g, device="cpu")
    assert st.indices is g.indices and rep_for_state(st) is CSR
    assert isinstance(st, CsrGraphState)


def test_mvc_step_on_csr_states_matches_jax():
    adj = _graphs(b=3, n=14, rho=0.35)
    action = np.array([0, 5, 13])
    js, jr, jd = jax_env.mvc_step(jg.csr_init_state(
        jg.csr_batch_from_dense(adj)), jnp.asarray(action))
    ts, tr, td = env.mvc_step(csr_init_state(
        csr_batch_from_dense(adj, device="cpu")), torch.from_numpy(action))
    assert isinstance(ts, CsrGraphState)
    for f in ("candidate", "solution"):
        assert (np.asarray(getattr(js, f)) == getattr(ts, f).numpy()).all()
    assert (np.asarray(jr) == tr.numpy()).all()
    assert (np.asarray(jd) == td.numpy()).all()


def test_state_bytes_csr_below_sparse_on_sparse_er():
    """The edge-proportional layout undercuts the max-degree-padded one
    (ER degree skew pads most rows), as in the JAX package."""
    adj = random_graph_batch("er", 256, 2, seed=6, rho=0.0156)
    sb = SPARSE.state_bytes(SPARSE.init_state(adj, device="cpu"))
    cb = CSR.state_bytes(CSR.init_state(adj, device="cpu"))
    assert cb < sb
