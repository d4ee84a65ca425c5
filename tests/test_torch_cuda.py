"""The port on an NVIDIA GPU: each CUDA kernel (the dense, padded-sparse
and CSR fused S2V layers, the dense aggregate of the mesh path, the
sparse aggregation, and the LM kernels wkv6, sliding-window attention and
the grouped GLU FFN) against its plain version, and the solve and service
paths through them, on one device and on a two-rank mesh sharing the
card.  Every test here needs a card and skips, saying so, without one.
The file imports neither jax nor the JAX package, so it also runs where
only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import policy_from_numpy, policy_to_numpy
from repro_torch.core import (CSR, DENSE, SPARSE, PolicyConfig,
                              csr_batch_from_dense, init_policy,
                              init_solve_state, solve,
                              sparse_batch_from_dense)
from repro_torch.core.graphs import (csr_row_ids, erdos_renyi,
                                     random_graph_batch)
from repro_torch.core.mesh import spawn_mesh
from repro_torch.kernels import build, ops
from repro_torch.kernels import s2v_csr as kc
from repro_torch.kernels import s2v_fused as ks
from repro_torch.kernels import s2v_gather as kg
from repro_torch.kernels.moe_gemm import grouped_glu_ffn_plain
from repro_torch.kernels.swa import swa_attention_plain
from repro_torch.kernels.wkv6 import wkv6_chunked_plain
from repro_torch.serving import GraphSolverService
from torch_mesh_ranks import solve_on_card

pytestmark = pytest.mark.cuda

# f32: the kernel and torch's matmul may sum in different orders;
# bf16: one bf16 rounding (2^-8 relative) of each matmul operand
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _layer_inputs(b, k, nl, n, seed=0):
    rng = np.random.default_rng(seed)
    rand = lambda s: (rng.random(s, np.float32) - 0.5).astype(np.float32)  # noqa: E731
    return [torch.from_numpy(x) for x in (
        rand((k, k)) * 0.2, rand((b, k, nl)),
        (rng.random((b, nl, n)) < 0.3).astype(np.float32), rand((b, k, n)))]


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_kernel_matches_plain_on_the_card(cuda, compute):
    """K of 5/8/16/32, ragged N (N % 4 != 0 takes the 4-byte copy path),
    Nl != N as on a row block."""
    for b, k, nl, n in ((2, 5, 33, 33), (2, 8, 37, 37), (1, 16, 130, 130),
                        (3, 32, 301, 301), (2, 32, 50, 72)):
        args = [t.to(cuda) for t in _layer_inputs(b, k, nl, n)]
        before = ks.fused_s2v_layer.launches
        out = ks.fused_s2v_layer(*args, compute)
        torch.cuda.synchronize()
        assert ks.fused_s2v_layer.launches == before + 1
        torch.testing.assert_close(
            out, ks.fused_s2v_layer_plain(*args, compute), **TOL[compute])


def test_wrapper_rejects_mixed_devices(cuda):
    t4, embed, adj, base = _layer_inputs(1, 8, 16, 16)
    with pytest.raises(ValueError, match="is on"):
        ks.fused_s2v_layer(t4.to(cuda), embed.to(cuda), adj.to(cuda), base)


def test_solve_on_the_card(cuda):
    """Valid covers, one kernel launch per evaluation, and first-evaluation
    scores within 1e-5 of the port on the CPU."""
    cfg = PolicyConfig(embed_dim=32)
    policy = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cuda")
    adj = random_graph_batch("er", 64, 4, seed=1, rho=0.2)
    before = ks.fused_s2v_layer.launches
    res = solve(policy, adj, multi_node=True, device="cuda")
    assert ks.fused_s2v_layer.launches - before == res.policy_evals
    for g in range(adj.shape[0]):
        keep = res.solution[g] < 0.5
        assert adj[g][np.ix_(keep, keep)].sum() == 0
    cpu = policy_from_numpy(policy_to_numpy(policy), device="cpu")
    with torch.no_grad():
        got = DENSE.scores(policy, init_solve_state(DENSE, adj, device="cuda"),
                           num_layers=2).cpu()
        want = DENSE.scores(cpu, init_solve_state(DENSE, adj, device="cpu"),
                            num_layers=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_service_on_the_card(cuda):
    cfg = PolicyConfig(embed_dim=16)
    policy = init_policy(cfg, generator=torch.Generator().manual_seed(1),
                         device="cuda")
    svc = GraphSolverService(policy, cfg, max_batch=2)
    svc.warmup([20, 40])
    adjs = [erdos_renyi(n, 0.3, seed=i) for i, n in enumerate((20, 40, 33))]
    sync = svc.serve(adjs)
    with svc:
        futures = [svc.submit_async(a) for a in adjs]
        responses = [f.result(timeout=120) for f in futures]
    assert svc.stats.compiles == 0
    for r, s, a in zip(responses, sync, adjs):
        assert (r.solution == s.solution).all()
        keep = r.solution < 0.5
        assert a[np.ix_(keep, keep)].sum() == 0


def _graph_inputs(b, k, n, rho, seed, isolate=0, width=None):
    """A symmetric random graph batch with ``isolate`` isolated nodes at
    the end, as sparse and CSR topology with random edge factors (zero on
    padding), and random x, base and θ4."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((b, n, n)) < rho).astype(np.float32)
    adj = np.maximum(adj, adj.transpose(0, 2, 1))
    np.einsum("bii->bi", adj)[:] = 0
    if isolate:
        adj[:, -isolate:, :] = 0.0
        adj[:, :, -isolate:] = 0.0
    sp = sparse_batch_from_dense(adj, width, device="cpu")
    cs = csr_batch_from_dense(adj, width and width * n, device="cpu")
    rand = lambda s: torch.from_numpy(  # noqa: E731
        (rng.random(s, np.float32) - 0.5).astype(np.float32))
    edge = sp.valid.float() * torch.from_numpy(
        rng.random(sp.valid.shape).astype(np.float32))
    edge_w = cs.edge_mask.float() * torch.from_numpy(
        rng.random(cs.edge_mask.shape).astype(np.float32))
    return sp, cs, edge, edge_w, rand((b, k, n)), rand((b, k, n)), \
        rand((k, k)) * 0.2


CASES = ((2, 5, 33, 0.3, 0, None), (1, 8, 40, 0.2, 7, 48),
         (3, 16, 70, 0.15, 0, None), (2, 32, 301, 0.1, 20, 96))


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_sparse_layer_matches_plain_on_the_card(cuda, compute):
    """K of 5..32, ragged N, isolated nodes, list widths above the true
    max degree (sentinel slots) and below 32; poisoned factors on the
    sentinel slots must add nothing."""
    for b, k, n, rho, iso, width in CASES:
        sp, _, edge, _, x, base, t4 = _graph_inputs(b, k, n, rho, k, iso,
                                                    width)
        edge[sp.neighbors == n] = 5.0
        args = [t.to(cuda) for t in (t4, x, sp.neighbors, edge, base)]
        before = ks.fused_s2v_layer_sparse.launches
        out = ks.fused_s2v_layer_sparse(*args, compute)
        torch.cuda.synchronize()
        assert ks.fused_s2v_layer_sparse.launches == before + 1
        torch.testing.assert_close(
            out, ks.fused_s2v_layer_sparse_plain(*args, compute),
            **TOL[compute])
        if iso:
            assert torch.equal(out[:, :, -iso:],
                               torch.relu(args[4][:, :, -iso:]))


def test_sparse_aggregate_matches_plain_on_the_card(cuda):
    for b, k, n, rho, iso, width in CASES:
        sp, _, edge, _, x, _, _ = _graph_inputs(b, k, n, rho, k + 1, iso,
                                                width)
        xp = torch.nn.functional.pad(x, (0, 1))
        args = [t.to(cuda) for t in (xp, sp.neighbors, edge)]
        before = kg.sparse_mp_aggregate.launches
        out = kg.sparse_mp_aggregate(*args)
        torch.cuda.synchronize()
        assert kg.sparse_mp_aggregate.launches == before + 1
        torch.testing.assert_close(out, kg.sparse_mp_aggregate_plain(*args),
                                   **TOL["f32"])
        if iso:
            assert not out[:, :, -iso:].any()


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_csr_layer_matches_plain_on_the_card(cuda, compute):
    """As the sparse case; padded edge slots past indptr[N] carry the
    sentinel id and a poisoned factor."""
    for b, k, n, rho, iso, width in CASES:
        _, cs, _, edge_w, x, base, t4 = _graph_inputs(b, k, n, rho, k + 2,
                                                      iso, width)
        want = kc.fused_s2v_layer_csr_plain(
            *[t.to(cuda) for t in (t4, x, cs.indices, cs.indptr, edge_w,
                                   base)], compute)
        edge_w[~cs.edge_mask] = 5.0
        args = [t.to(cuda) for t in (t4, x, cs.indices, cs.indptr, edge_w,
                                     base)]
        before = kc.fused_s2v_layer_csr.launches
        out = kc.fused_s2v_layer_csr(*args, compute)
        torch.cuda.synchronize()
        assert kc.fused_s2v_layer_csr.launches == before + 1
        torch.testing.assert_close(out, want, **TOL[compute])
        if iso:
            assert torch.equal(out[:, :, -iso:],
                               torch.relu(args[5][:, :, -iso:]))


@pytest.mark.parametrize("rep", ["sparse", "csr"])
def test_sparse_and_csr_solves_on_the_card(cuda, rep):
    """Valid covers, one kernel launch per evaluation (two aggregation
    launches per evaluation on the sparse xla chain), first-evaluation
    scores within 1e-5 of the port on the CPU and of the dense rep."""
    cfg = PolicyConfig(embed_dim=32)
    policy = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cuda")
    adj = random_graph_batch("er", 64, 4, seed=2, rho=0.2)
    counter = {"sparse": ks.fused_s2v_layer_sparse,
               "csr": kc.fused_s2v_layer_csr}[rep]
    before = counter.launches
    res = solve(policy, adj, multi_node=True, rep=rep, device="cuda")
    assert counter.launches - before == res.policy_evals
    for g in range(adj.shape[0]):
        keep = res.solution[g] < 0.5
        assert adj[g][np.ix_(keep, keep)].sum() == 0
    if rep == "sparse":
        before = kg.sparse_mp_aggregate.launches
        xla = solve(policy, adj, multi_node=True, rep=rep, kernel="xla",
                    device="cuda")
        assert kg.sparse_mp_aggregate.launches - before \
            == 2 * xla.policy_evals
    cpu = policy_from_numpy(policy_to_numpy(policy), device="cpu")
    r = {"sparse": SPARSE, "csr": CSR}[rep]
    with torch.no_grad():
        got = r.scores(policy, init_solve_state(r, adj, device="cuda"),
                       num_layers=2).cpu()
        want = r.scores(cpu, init_solve_state(r, adj, device="cpu"),
                        num_layers=2)
        dense = DENSE.scores(policy, init_solve_state(DENSE, adj,
                                                      device="cuda"),
                             num_layers=2).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rep", ["sparse", "csr"])
def test_sparse_and_csr_service_on_the_card(cuda, rep):
    cfg = PolicyConfig(embed_dim=16)
    policy = init_policy(cfg, generator=torch.Generator().manual_seed(1),
                         device="cuda")
    svc = GraphSolverService(policy, cfg, rep=rep, max_batch=2)
    svc.warmup([20, 40])
    adjs = [erdos_renyi(n, 0.3, seed=i) for i, n in enumerate((20, 40, 33))]
    sync = svc.serve(adjs)
    with svc:
        futures = [svc.submit_async(a) for a in adjs]
        responses = [f.result(timeout=120) for f in futures]
    assert svc.stats.compiles == 0
    for r, s, a in zip(responses, sync, adjs):
        assert (r.solution == s.solution).all()
        keep = r.solution < 0.5
        assert a[np.ix_(keep, keep)].sum() == 0


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_mp_aggregate_matches_plain_on_the_card(cuda, compute):
    """K of 5..32, Nl = N and Nl < N (a row block), ragged sizes (N % 4
    != 0 takes the 4-byte copy path); columns with no adjacency give
    exact zeros."""
    for b, k, nl, n in ((2, 5, 33, 33), (2, 32, 50, 72), (1, 16, 1000, 2003),
                        (3, 32, 128, 512)):
        _, embed, adj, _ = (t.to(cuda) for t in _layer_inputs(b, k, nl, n))
        adj[:, :, -7:] = 0.0
        before = ks.mp_aggregate.launches
        out = ks.mp_aggregate(embed, adj, compute)
        torch.cuda.synchronize()
        assert ks.mp_aggregate.launches == before + 1
        assert out.shape == (b, k, n)
        torch.testing.assert_close(out, ks.mp_aggregate_plain(embed, adj,
                                                              compute),
                                   **TOL[compute])
        assert not out[:, :, -7:].any()


def test_sparse_aggregate_at_row_blocks_on_the_card(cuda):
    """B4 on the lists of a row block (Nl < N, global ids) equals its
    plain version and the whole-graph call's rows."""
    for b, k, n, rho, iso, width in CASES:
        sp, _, edge, _, x, _, _ = _graph_inputs(b, k, n, rho, k + 3, iso,
                                                width)
        xp = torch.nn.functional.pad(x, (0, 1)).to(cuda)
        whole = kg.sparse_mp_aggregate(xp, sp.neighbors.to(cuda),
                                       edge.to(cuda))
        lo, hi = n // 3, 2 * n // 3
        args = (xp, sp.neighbors[:, lo:hi].contiguous().to(cuda),
                edge[:, lo:hi].contiguous().to(cuda))
        out = kg.sparse_mp_aggregate(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, kg.sparse_mp_aggregate_plain(*args),
                                   **TOL["f32"])
        assert torch.equal(out, whole[:, :, lo:hi])


def _long_lists(b, n, width, seed):
    """Neighbour lists of random length (up to ``width``) over ids drawn
    from [0, n), ascending, the sentinel n after the real slots and the
    last 30 nodes empty; random factors on the real slots and a poisoned
    5.0 on the sentinel slots, which must add nothing."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(width // 3, width + 1, (b, n, 1))
    deg[:, -30:] = 0
    real = np.arange(width) < deg
    nbr = np.sort(np.where(real, rng.integers(0, n, (b, n, width)), n), -1)
    edge = np.where(nbr < n, rng.random((b, n, width)), 5.0)
    return (torch.from_numpy(nbr.astype(np.int32)),
            torch.from_numpy(edge.astype(np.float32)))


@pytest.mark.parametrize("k", [30, 16, 7])
def test_sparse_aggregate_on_shuffled_long_lists_on_the_card(cuda, k):
    """D = 2048 slots over N = 2500 * 32 / KP ids (KP = K rounded up to 4):
    the kernel's x windows of 96 KB hold 768 ids at K = 30, 1536 at K = 16
    and 3072 at K = 7, so every list crosses 3.3 of them.  The lists in
    ascending order and with each node's slots shuffled (ids not
    ascending, sentinel slots among the real ones, so slots wait for later
    windows and read x below the window from global memory).  Against the
    plain version, whole and on row blocks, and each row block equals the
    whole call's slice."""
    b, width = 2, 2048
    n = 2500 * 32 // (k + -k % 4)
    nbr, edge = _long_lists(b, n, width, k)
    perm = torch.argsort(torch.from_numpy(
        np.random.default_rng(k).random(nbr.shape)), dim=-1)
    shuffled = (torch.gather(nbr, -1, perm), torch.gather(edge, -1, perm))
    real = shuffled[0] < n
    assert bool((real[..., 1:] & ~real[..., :-1]).any())
    g = torch.Generator().manual_seed(k)
    x = torch.rand((b, k, n), generator=g)
    xp = torch.nn.functional.pad(x, (0, 1)).to(cuda)
    for nbr, edge in ((nbr, edge), shuffled):
        nbr, edge = nbr.to(cuda), edge.to(cuda)
        before = kg.sparse_mp_aggregate.launches
        whole = kg.sparse_mp_aggregate(xp, nbr, edge)
        torch.cuda.synchronize()
        assert kg.sparse_mp_aggregate.launches == before + 1
        torch.testing.assert_close(
            whole, kg.sparse_mp_aggregate_plain(xp, nbr, edge), **TOL["f32"])
        assert not whole[:, :, -30:].any()
        for lo, hi in ((0, n // 2), (n // 3, n), (1000, 1001)):
            args = (xp, nbr[:, lo:hi].contiguous(),
                    edge[:, lo:hi].contiguous())
            out = kg.sparse_mp_aggregate(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                out, kg.sparse_mp_aggregate_plain(*args), **TOL["f32"])
            assert torch.equal(out, whole[:, :, lo:hi])


def test_sparse_aggregate_reads_the_sentinel_unless_it_adds_zero(cuda):
    """The kernel passes over a sentinel slot only where the slot adds
    exactly zero: the sentinel column of x all zero and the factor
    finite.  An infinite factor on a sentinel slot must give NaN, and a
    sentinel column that is not zero must be summed, as in the plain
    version."""
    b, k, n, width = 2, 16, 300, 200
    sp, _, edge, _, x, _, _ = _graph_inputs(b, k, n, 0.3, 77, 20, width)
    xp = torch.nn.functional.pad(torch.relu(x), (0, 1)).to(cuda)
    nbr, edge = sp.neighbors.to(cuda), edge.to(cuda)
    hot = edge.clone()
    hot[0, 5, -1] = float("inf")                # a sentinel slot of node 5
    assert int(nbr[0, 5, -1]) == n
    out = kg.sparse_mp_aggregate(xp, nbr, hot)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, kg.sparse_mp_aggregate_plain(xp, nbr, hot),
                               equal_nan=True, **TOL["f32"])
    assert bool(out[0, :, 5].isnan().all())
    xs = xp.clone()
    xs[:, :, n] = 0.25                          # a sentinel column not zero
    out = kg.sparse_mp_aggregate(xs, nbr, edge)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, kg.sparse_mp_aggregate_plain(xs, nbr, edge),
                               **TOL["f32"])


@pytest.mark.parametrize("b,k,n,iso", [(2, 32, 301, 20), (1, 32, 256, 0),
                                       (2, 8, 40, 7)])
def test_dense_layer_is_identical_to_sparse_and_csr_on_the_card(cuda, b, k,
                                                                n, iso):
    """At f32 the three representations sum each node's neighbours in
    ascending id with one fmaf each, so on a symmetric weighted adjacency
    W kernel 1 equals kernels 3 and 5 bit for bit, and kernel 2 on W's
    columns of a node block (the transposed row block) equals kernel 4 on
    that block's lists.  N=301 takes kernel 1's 4-byte copy path, 256 and
    40 its TMA path; isolated nodes give relu(base) on every rep."""
    rng = np.random.default_rng(n + k)
    adj = np.triu(rng.random((b, n, n)) < 0.2, 1)
    if iso:
        adj[:, -iso:, :] = False
        adj[:, :, -iso:] = False
    adj = adj | adj.transpose(0, 2, 1)
    wt = np.triu(rng.random((b, n, n)).astype(np.float32), 1)
    w = np.where(adj, wt + wt.transpose(0, 2, 1), 0.0).astype(np.float32)
    sp = sparse_batch_from_dense(adj.astype(np.float32), device="cpu")
    cs = csr_batch_from_dense(adj.astype(np.float32), device="cpu")
    wp = torch.nn.functional.pad(torch.from_numpy(w), (0, 1))
    nbr = sp.neighbors.long()
    edge = torch.gather(wp, 2, nbr)            # the sentinel column is 0
    rid = csr_row_ids(cs.indptr, cs.num_edges).long()
    edge_w = wp[torch.arange(b)[:, None], rid, cs.indices.long()]
    x = torch.relu(torch.from_numpy(rng.random((b, k, n), np.float32) - 0.5))
    base = torch.from_numpy(rng.random((b, k, n), np.float32) - 0.5)
    t4 = torch.from_numpy((rng.random((k, k), np.float32) - 0.5) * 0.2)
    x, base, t4, w_c = (a.to(cuda) for a in (x, base, t4, torch.from_numpy(w)))
    dense = ks.fused_s2v_layer(t4, x, w_c, base)
    sparse = ks.fused_s2v_layer_sparse(t4, x, sp.neighbors.to(cuda),
                                       edge.to(cuda), base)
    csr = kc.fused_s2v_layer_csr(t4, x, cs.indices.to(cuda),
                                 cs.indptr.to(cuda), edge_w.to(cuda), base)
    torch.cuda.synchronize()
    assert torch.equal(dense, sparse) and torch.equal(dense, csr)
    lo = n // 2
    agg = ks.mp_aggregate(x, w_c[:, :, lo:].contiguous())
    rows = kg.sparse_mp_aggregate(
        torch.nn.functional.pad(x, (0, 1)),
        sp.neighbors[:, lo:].contiguous().to(cuda),
        edge[:, lo:].contiguous().to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(agg, rows)


def test_lm_kernels_refuse_sizes_beyond_their_limits(cuda):
    """The CPU plain versions take these sizes (tests/test_torch_lm_kernels
    .py); the CUDA kernels refuse them, naming their limit."""
    r, k, v, u = _randn(1, (1, 64, 80), (1, 64, 80), (1, 64, 16), (1, 80))
    w = torch.full((1, 64, 80), 0.9)
    with pytest.raises(ValueError, match="dk <= 64"):
        ops.wkv6(*(a.to(cuda) for a in (r, k, v, w, u)), chunk=16)
    r, k, v, u = _randn(2, (1, 256, 8), (1, 256, 8), (1, 256, 8), (1, 8))
    w = torch.full((1, 256, 8), 0.9)
    with pytest.raises(ValueError, match="chunk <= 64"):
        ops.wkv6(*(a.to(cuda) for a in (r, k, v, w, u)), chunk=128)
    for d in (6, 260):
        q, kk, vv = (a.to(cuda) for a in _randn(d, *[(1, 16, d)] * 3))
        with pytest.raises(ValueError, match="d % 4 == 0 and d <= 256"):
            ops.swa(q, kk, vv, window=4)


def test_two_rank_gloo_mesh_solve_on_one_card(cuda):
    """A (1, 2) mesh of two ranks sharing the card over gloo: valid covers,
    the mesh kernels launched once per evaluation on each rank."""
    policy = init_policy(PolicyConfig(embed_dim=32),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    adj = random_graph_batch("er", 64, 4, seed=1, rho=0.2)
    for name in ("s2v_fused", "s2v_gather"):    # built here, not by the ranks
        build.load(name)
    ranks = spawn_mesh(solve_on_card, 1, 2, device="cuda", backend="gloo",
                       timeout_s=300, args=(policy_to_numpy(policy), adj))
    for out in ranks:
        for rep in ("dense", "sparse"):
            sol, evals, launches = out[rep]
            assert launches == evals
            assert (sol == ranks[0][rep][0]).all()
            for g in range(adj.shape[0]):
                keep = sol[g] < 0.5
                assert adj[g][np.ix_(keep, keep)].sum() == 0


def _randn(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * scale).astype(
        np.float32)) for s in shapes]


def test_wkv6_kernel_matches_plain_on_the_card(cuda):
    """Ragged dv (not a multiple of the 32-column tile), dk < 64, chunks
    of 16, 32, 48 and 64, decays of the TPU kernel's domain at chunk 64
    and of the model's range at chunk 16; the JAX suite's 3e-4 bar (the
    chunked form against the scan)."""
    for bh, t, dk, dv, chunk, w_min in ((3, 128, 16, 24, 32, 0.55),
                                        (2, 256, 64, 64, 64, 0.55),
                                        (2, 64, 64, 40, 16, 0.066),
                                        (1, 48, 8, 8, 48, 0.55)):
        r, k, v, u = _randn(bh + t, (bh, t, dk), (bh, t, dk), (bh, t, dv),
                            (bh, dk), scale=0.5)
        w = torch.from_numpy((w_min + (1 - w_min) * np.random.default_rng(
            t).random((bh, t, dk))).astype(np.float32))
        args = [a.to(cuda) for a in (r, k, v, w, u)]
        before = ops.wkv6.launches
        out, state = ops.wkv6(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert ops.wkv6.launches == before + 1
        want, want_state = wkv6_chunked_plain(*args, chunk=chunk)
        torch.testing.assert_close(out, want, rtol=3e-4, atol=3e-4)
        torch.testing.assert_close(state, want_state, rtol=3e-4, atol=3e-4)


def test_swa_kernel_matches_plain_on_the_card(cuda):
    """head_dim 256 (over 48 KB of shared memory), a window that is not
    tile-aligned, a window beyond T, T not a multiple of the 64-query
    tile, d of 16 (one column group, partly idle); the JAX suite's 1e-4."""
    for bh, t, d, window in ((2, 256, 32, 200), (1, 300, 256, 100),
                             (2, 130, 64, 1000), (1, 128, 16, 32)):
        q, k, v = (a.to(cuda) for a in _randn(t + d, *[(bh, t, d)] * 3))
        before = ops.swa.launches
        out = ops.swa(q, k, v, window=window)
        torch.cuda.synchronize()
        assert ops.swa.launches == before + 1
        torch.testing.assert_close(
            out, swa_attention_plain(q, k, v, window=window), rtol=1e-4,
            atol=1e-4)


def test_grouped_glu_kernel_at_full_width_holds_f64_on_the_card(cuda):
    """qwen2-moe-a2.7b's expert width (C=320, d=2048, f=1408) at E=2, x in
    N(0,1) and weights N(0,1)/sqrt(fan-in): against the plain version at
    the JAX suite's 1e-4, and against the GLU in f64 by chip_smoke.py's
    componentwise rule (1e-5 + 1e-5 * the sum of |terms| behind each
    output, the terms of h = silu(g)·u carrying g's and u's sums)."""
    e, c, d, f = 2, 320, 2048, 1408
    x, wg, wu, wo = (a.to(cuda) for a in _randn(
        5, (e, c, d), (e, d, f), (e, d, f), (e, f, d)))
    wg, wu, wo = wg * d ** -0.5, wu * d ** -0.5, wo * f ** -0.5
    out = ops.grouped_glu_ffn(x, wg, wu, wo)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, grouped_glu_ffn_plain(x, wg, wu, wo),
                               rtol=1e-4, atol=1e-4)
    x, wg, wu, wo = (a.double() for a in (x, wg, wu, wo))
    g, u = torch.bmm(x, wg), torch.bmm(x, wu)
    sig = torch.sigmoid(g)
    h = g * sig * u
    dsilu = sig * (1 + g * (1 - sig))
    terms_h = (h.abs() + (dsilu * u).abs() * torch.bmm(x.abs(), wg.abs())
               + (g * sig).abs() * torch.bmm(x.abs(), wu.abs()))
    err = (out.double() - torch.bmm(h, wo)).abs()
    assert bool((err <= 1e-5 + 1e-5 * torch.bmm(terms_h, wo.abs())).all())


def test_grouped_glu_kernel_matches_plain_on_the_card(cuda):
    """Ragged C, d and f, none a multiple of the MMA tiles (zero-filled in
    the tile copies, masked in the stores; 4-byte copies where a row is
    not whole 16-byte vectors), two launches per call; the JAX suite's
    1e-4."""
    for e, c, d, f in ((3, 100, 72, 90), (2, 128, 128, 256), (1, 5, 3, 7)):
        x, wg, wu, wo = (a.to(cuda) for a in _randn(
            e + c, (e, c, d), (e, d, f), (e, d, f), (e, f, d)))
        wg, wu, wo = wg * 0.1, wu * 0.1, wo * 0.1
        before = ops.grouped_glu_ffn.launches
        out = ops.grouped_glu_ffn(x, wg, wu, wo)
        torch.cuda.synchronize()
        assert ops.grouped_glu_ffn.launches == before + 2
        torch.testing.assert_close(
            out, grouped_glu_ffn_plain(x, wg, wu, wo), rtol=1e-4, atol=1e-4)
