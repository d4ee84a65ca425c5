"""The port on an NVIDIA GPU: each CUDA kernel (the dense, padded-sparse
and CSR fused S2V layers, the dense aggregate of the mesh path, the
sparse aggregation and the CSR aggregate at f32 and bf16, and the LM
kernels wkv6, sliding-window attention and the grouped GLU FFN) against
its plain version, the sparse and CSR layers' closed-form backwards
against autograd, and the solve and service paths through them, on
one device and on a two-rank mesh sharing the card.  Every test here
needs a card and skips, saying so, without one.  The file imports
neither jax nor the JAX package, so it also runs where only torch is
installed:

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
def test_aggregate_entries_match_plain_on_the_card(cuda, compute):
    """B4's aggregate at both compute modes and B5's aggregate entry
    (the windowed walk) against their plain versions; padded CSR slots
    past indptr[N] carry a poisoned factor and are never read."""
    for b, k, n, rho, iso, width in CASES:
        sp, cs, edge, edge_w, x, _, _ = _graph_inputs(b, k, n, rho, k + 3,
                                                      iso, width)
        xp = torch.nn.functional.pad(x, (0, 1))
        args = [t.to(cuda) for t in (xp, sp.neighbors, edge)]
        before = kg.sparse_mp_aggregate.launches
        out = kg.sparse_mp_aggregate(*args, compute)
        torch.testing.assert_close(
            out, kg.sparse_mp_aggregate_plain(*args, compute),
            **TOL[compute])
        rid = csr_row_ids(cs.indptr, cs.num_edges).to(cuda)
        want = kc.csr_aggregate_plain(x.to(cuda), cs.indices.to(cuda), rid,
                                      edge_w.to(cuda), compute)
        edge_w[~cs.edge_mask] = 5.0
        args = [t.to(cuda) for t in (x, cs.indices, cs.indptr, edge_w)]
        c_before = kc.csr_aggregate.launches
        got = kc.csr_aggregate(*args, compute)
        torch.cuda.synchronize()
        assert kg.sparse_mp_aggregate.launches == before + 1
        assert kc.csr_aggregate.launches == c_before + 1
        torch.testing.assert_close(got, want, **TOL[compute])
        if iso:
            assert not out[:, :, -iso:].any() and not got[:, :, -iso:].any()


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("rep", ["sparse", "csr"])
def test_layer_backwards_match_autograd_on_the_card(cuda, rep, compute):
    """The sparse and CSR layers' closed-form gradients (two aggregate
    launches) against autograd through the plain composition, both on
    the card, on env-built graphs with residual factors (symmetric, as
    the backward requires)."""
    from repro_torch.core import s2v_csr as core_csr
    from repro_torch.core import s2v_sparse as core_sparse
    from repro_torch.core.graphs import (csr_residual_edge_mask,
                                         residual_edge_mask)
    b, k, n = 3, 32, 300
    adj = random_graph_batch("er", n, b, seed=11, rho=0.1)
    rng = np.random.default_rng(11)
    sol = torch.from_numpy((rng.random((b, n)) < 0.3).astype(np.float32))
    if rep == "sparse":
        g = sparse_batch_from_dense(adj, device="cpu")
        topo = (g.neighbors, residual_edge_mask(g.neighbors, g.valid, sol))
        fused, plain = core_sparse._FusedSparseLayer.apply, \
            ks.fused_s2v_layer_sparse_plain
        agg = kg.sparse_mp_aggregate
    else:
        g = csr_batch_from_dense(adj, device="cpu")
        rid = csr_row_ids(g.indptr, g.num_edges)
        topo = (g.indices, g.indptr,
                csr_residual_edge_mask(g.indices, g.edge_mask, rid, sol))
        fused, plain = core_csr._FusedCsrLayer.apply, \
            kc.fused_s2v_layer_csr_plain
        agg = kc.csr_aggregate
    topo = [t.to(cuda) for t in topo]
    t4, x, base = (t.to(cuda) for t in _layer_args(b, k, n, n, 12))
    grad = torch.randn((b, k, n), generator=torch.Generator().manual_seed(
        13)).to(cuda)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (t4, x, base)]
        out = fn(ins[0], ins[1], *topo, ins[2], compute)
        return torch.autograd.grad(out, ins, grad)
    before = agg.launches
    got = grads(fused)
    torch.cuda.synchronize()
    assert agg.launches == before + 2
    for a, w in zip(got, grads(plain)):
        torch.testing.assert_close(a, w, **TOL[compute])


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
    r, k, v, w, u = (torch.full(s, 0.5, device=cuda) for s in (
        (65536, 1, 1), (65536, 1, 1), (65536, 1, 1), (65536, 1, 1),
        (65536, 1)))
    with pytest.raises(ValueError, match="BH <= 65535"):
        ops.wkv6(r, k, v, w, u, chunk=1)
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
    """Ragged dv (not a multiple of 4 x 8-column MMA tiles), dk < 64,
    chunks of 16, 32, 48 and 64, decays of the TPU kernel's domain at
    chunk 64 and of the model's range at chunk 16, two launches a call
    (the state pass, the outputs); the JAX suite's 3e-4 bar (the chunked
    form against the scan)."""
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
        assert ops.wkv6.launches == before + 2
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


def _wkv6_scan64(r, k, v, w, u):
    """The sequential recurrence in f64 (ref.wkv6's scan)."""
    r, k, v, w, u = (a.double() for a in (r, k, v, w, u))
    s = torch.zeros((r.shape[0], r.shape[2], v.shape[2]),
                    dtype=torch.float64, device=r.device)
    out = torch.empty(v.shape, dtype=torch.float64, device=r.device)
    for i in range(r.shape[1]):
        kv = k[:, i, :, None] * v[:, i, None, :]
        out[:, i] = torch.bmm(r[:, i, None, :], s + u[:, :, None] * kv)[:, 0]
        s = w[:, i, :, None] * s + kv
    return out, s


@pytest.mark.parametrize("bh,t,dk,dv,chunk", [
    (2, 64, 64, 64, 64),       # one chunk: the state pass walks one step
    (2, 4096, 64, 64, 64),     # 64 chunks in order
    (2, 256, 32, 100, 32),     # dv past one 64-column block, ragged
    (3, 128, 8, 24, 16),       # dk 8: one k-step of the MMAs
    (1, 5, 3, 7, 1),           # chunks of one token; dk, dv not % 4
])
def test_wkv6_kernel_holds_the_scan_on_the_card(cuda, bh, t, dk, dv, chunk):
    """Against its plain version and the f64 scan at the JAX suite's 3e-4
    (rtol = atol), decays in the TPU kernel's domain [0.55, 1)."""
    r, k, v, u = _randn(t + dv, (bh, t, dk), (bh, t, dk), (bh, t, dv),
                        (bh, dk), scale=0.5)
    w = torch.from_numpy((0.55 + 0.45 * np.random.default_rng(dk).random(
        (bh, t, dk))).astype(np.float32))
    args = [a.to(cuda) for a in (r, k, v, w, u)]
    out, state = ops.wkv6(*args, chunk=chunk)
    torch.cuda.synchronize()
    want, want_state = wkv6_chunked_plain(*args, chunk=chunk)
    torch.testing.assert_close(out, want, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(state, want_state, rtol=3e-4, atol=3e-4)
    exact, exact_state = _wkv6_scan64(*args)
    for got, ref in ((out, exact), (state, exact_state)):
        assert bool(((got.double() - ref).abs()
                     <= 3e-4 + 3e-4 * ref.abs()).all())


def _swa64(q, k, v, window):
    """The masked softmax in f64."""
    q, k, v = (a.double() for a in (q, k, v))
    t = q.shape[1]
    i = torch.arange(t, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    logits = (q @ k.transpose(1, 2)) * q.shape[2] ** -0.5
    logits = logits.masked_fill(~((j <= i) & (j > i - window)),
                                float("-inf"))
    return torch.softmax(logits, -1) @ v


@pytest.mark.parametrize("bh,t,d,window", [
    (2, 300, 12, 77),          # d % 8 = 4: the last k-step half zeros
    (2, 300, 100, 77),         # d = 100: 13 k-steps, ragged
    (2, 2048, 256, 1024),      # gemma3-4b's head_dim and window
    (3, 1, 4, 1),              # one token, the smallest head
])
def test_swa_kernel_holds_f64_on_the_card(cuda, bh, t, d, window):
    """The split-TF32 tensor-core attention against its plain version and
    the attention in f64 at the JAX suite's 1e-4 (rtol = atol)."""
    q, k, v = (a.to(cuda) for a in _randn(t + d, *[(bh, t, d)] * 3))
    out = ops.swa(q, k, v, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, swa_attention_plain(q, k, v, window=window), rtol=1e-4,
        atol=1e-4)
    exact = _swa64(q, k, v, window)
    assert bool(((out.double() - exact).abs()
                 <= 1e-4 + 1e-4 * exact.abs()).all())


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


def _csr_from_lists(nbr, edge, n):
    """The real slots (ids < n) of padded lists as CSR rows, in list order:
    indptr (B, Nl+1), indices and factors (B, E) with E the largest total,
    other batches padded with the sentinel n and a poisoned 5.0."""
    b = nbr.shape[0]
    real = nbr < n
    counts = real.sum(-1)
    indptr = torch.zeros((b, nbr.shape[1] + 1), dtype=torch.int32)
    indptr[:, 1:] = torch.cumsum(counts, 1)
    e = max(int(indptr[:, -1].max()), 1)
    indices = torch.full((b, e), n, dtype=torch.int32)
    edge_w = torch.full((b, e), 5.0)
    for g in range(b):
        m = int(indptr[g, -1])
        indices[g, :m] = nbr[g][real[g]]
        edge_w[g, :m] = edge[g][real[g]]
    return indptr, indices, edge_w


def _both_walks(fn, args, compute):
    """The layer by each route, forced; the two must agree bit for bit."""
    rows = fn(*args, compute, walk="rows")
    windows = fn(*args, compute, walk="windows")
    torch.cuda.synchronize()
    assert torch.equal(rows, windows)
    return windows


def _assert_close_by_terms(out, plain, args, compute):
    """The layer within chip_smoke.py's ``graph_tol`` of its plain version
    (1e-5 at f32, 2e-2 at bf16) componentwise against the sum of |terms|
    behind each output, |base| + |θ4| @ (|x|·|w| over the node's slots):
    the bound rounding error analysis gives a sum in any order.  The θ4
    product cancels aggregates of thousands of slots, so |want| is no
    measure of their rounding."""
    tol = 2e-2 if compute == "bf16" else 1e-5
    scale = plain(*[a.abs() if a.is_floating_point() else a for a in args],
                  "f32")
    err = (out - plain(*args, compute)).abs()
    assert bool((err <= tol + tol * scale).all()), float(
        (err / (tol + tol * scale)).max())


def _layer_args(b, k, n, nl, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.rand((b, k, n), generator=g) - 0.5)
    base = torch.rand((b, k, nl), generator=g) - 0.5
    t4 = (torch.rand((k, k), generator=g) - 0.5) * 0.2
    return t4, x, base


@pytest.mark.parametrize("k", [30, 16, 7])
def test_layer_walks_agree_on_long_lists_on_the_card(cuda, k):
    """Kernels 3 and 5 by the row walk and the windowed walk, bit for bit,
    at f32 and bf16, and each within ``_assert_close_by_terms`` of its
    plain version: lists
    of up to D slots over N = 2500 * 32 / KP ids, so each crosses 3.3 x
    windows of 96 KB; D = 2048 - K % 4 (not a multiple of 4 at K = 30 and
    7, so padded lists start inside 16-byte groups), ascending and with
    each node's slots shuffled (ids not ascending, sentinel slots among
    the real ones).  The CSR batch holds each list's real slots as a row."""
    b, width = 2, 2048 - k % 4
    n = 2500 * 32 // (k + -k % 4)
    nbr, edge = _long_lists(b, n, width, k)
    perm = torch.argsort(torch.from_numpy(
        np.random.default_rng(k).random(nbr.shape)), dim=-1)
    shuffled = (torch.gather(nbr, -1, perm), torch.gather(edge, -1, perm))
    t4, x, base = _layer_args(b, k, n, n, k)
    t4, x, base = t4.to(cuda), x.to(cuda), base.to(cuda)
    for lists in ((nbr, edge), shuffled):
        indptr, indices, edge_w = _csr_from_lists(*lists, n)
        for fn, plain, args in (
                (ks.fused_s2v_layer_sparse, ks.fused_s2v_layer_sparse_plain,
                 (t4, x, lists[0].to(cuda), lists[1].to(cuda), base)),
                (kc.fused_s2v_layer_csr, kc.fused_s2v_layer_csr_plain,
                 (t4, x, indices.to(cuda), indptr.to(cuda), edge_w.to(cuda),
                  base))):
            for compute in ("f32", "bf16"):
                out = _both_walks(fn, args, compute)
                _assert_close_by_terms(out, plain, args, compute)
                assert torch.equal(out[:, :, -30:],
                                   torch.relu(base[:, :, -30:]))


def test_csr_walks_agree_on_unaligned_and_empty_rows_on_the_card(cuda):
    """Rows of 0 to 9 edges in a cycle, so row starts fall at every offset
    in a 16-byte group and empty rows lie first, last and between; E not a
    multiple of 4 (the arrays' last group is cut short); and the same
    arrays as a view that does not start on 16 bytes (the wrapper copies
    it).  Both walks agree bit for bit; empty rows give relu(base)."""
    b, k, n = 2, 32, 403
    rng = np.random.default_rng(3)
    deg = np.arange(n) % 10
    deg[0] = deg[-1] = 0
    indptr = np.zeros((b, n + 1), np.int32)
    indptr[:, 1:] = np.cumsum(deg)
    e = int(indptr[0, -1])
    assert e % 4 != 0
    indices = rng.integers(0, n, (b, e)).astype(np.int32)
    edge_w = rng.random((b, e)).astype(np.float32)
    t4, x, base = (a.to(cuda) for a in _layer_args(b, k, n, n, 4))
    idx, ew = torch.from_numpy(indices).to(cuda), torch.from_numpy(
        edge_w).to(cuda)
    ip = torch.from_numpy(indptr).to(cuda)
    args = (t4, x, idx, ip, ew, base)
    empty = torch.from_numpy(deg == 0).to(cuda)
    for compute in ("f32", "bf16"):
        out = _both_walks(kc.fused_s2v_layer_csr, args, compute)
        _assert_close_by_terms(out, kc.fused_s2v_layer_csr_plain, args,
                               compute)
        assert torch.equal(out[:, :, empty], torch.relu(base[:, :, empty]))
    flat_i = torch.zeros(b * e + 1, dtype=torch.int32, device=cuda)
    flat_w = torch.zeros(b * e + 1, device=cuda)
    flat_i[1:] = idx.reshape(-1)
    flat_w[1:] = ew.reshape(-1)
    shifted = (flat_i[1:].view(b, e), flat_w[1:].view(b, e))
    assert shifted[0].data_ptr() % 16 != 0
    args = (t4, x, shifted[0], ip, shifted[1], base)
    assert torch.equal(_both_walks(kc.fused_s2v_layer_csr, args, "f32"),
                       kc.fused_s2v_layer_csr(t4, x, idx, ip, ew, base,
                                              walk="rows"))


def test_csr_walks_agree_on_one_row_across_windows_on_the_card(cuda):
    """One hub row whose edges reach every id of a graph of N = 5000
    nodes, 6.5 x windows at K = 32, in random order (its slots wait for
    later windows and read earlier ids from global memory), beside rows
    of a few edges."""
    b, k, n = 1, 32, 5000
    rng = np.random.default_rng(5)
    deg = rng.integers(0, 6, n)
    deg[17] = n
    indptr = np.zeros((b, n + 1), np.int32)
    indptr[0, 1:] = np.cumsum(deg)
    e = int(indptr[0, -1])
    indices = rng.integers(0, n, (b, e)).astype(np.int32)
    indices[0, indptr[0, 17]:indptr[0, 18]] = rng.permutation(n)
    edge_w = rng.random((b, e)).astype(np.float32)
    t4, x, base = (a.to(cuda) for a in _layer_args(b, k, n, n, 6))
    args = (t4, x, torch.from_numpy(indices).to(cuda),
            torch.from_numpy(indptr).to(cuda),
            torch.from_numpy(edge_w).to(cuda), base)
    for compute in ("f32", "bf16"):
        out = _both_walks(kc.fused_s2v_layer_csr, args, compute)
        _assert_close_by_terms(out, kc.fused_s2v_layer_csr_plain, args,
                               compute)


def test_sparse_walks_agree_on_a_row_block_on_the_card(cuda):
    """Kernel 3 on the lists of a row block (Nl < N, global ids against
    the whole x, as a mesh's graph rank calls it): both walks agree bit
    for bit and equal the whole call's slice, at f32 and bf16."""
    b, k, n, width = 2, 32, 2000, 301
    nbr, edge = _long_lists(b, n, width, 8)
    t4, x, base = (a.to(cuda) for a in _layer_args(b, k, n, n, 8))
    nbr, edge = nbr.to(cuda), edge.to(cuda)
    for compute in ("f32", "bf16"):
        whole = _both_walks(ks.fused_s2v_layer_sparse,
                            (t4, x, nbr, edge, base), compute)
        for lo, hi in ((0, 700), (700, n), (1000, 1001)):
            args = (t4, x, nbr[:, lo:hi].contiguous(),
                    edge[:, lo:hi].contiguous(),
                    base[:, :, lo:hi].contiguous())
            out = _both_walks(ks.fused_s2v_layer_sparse, args, compute)
            assert torch.equal(out, whole[:, :, lo:hi])
            _assert_close_by_terms(out, ks.fused_s2v_layer_sparse_plain,
                                   args, compute)


def test_walks_give_relu_base_on_isolated_padding_nodes_on_the_card(cuda):
    """A bucket whose last nodes are padding (no edges; all-sentinel
    lists with poisoned factors, empty CSR rows): exactly relu(base)
    there on both walks of kernels 3 and 5, at f32 and bf16."""
    b, k, n, iso = 2, 16, 900, 133
    sp, cs, edge, edge_w, x, base, t4 = _graph_inputs(b, k, n, 0.05, 9, iso)
    edge[sp.neighbors == n] = 5.0
    edge_w[~cs.edge_mask] = 5.0
    x = torch.relu(x)
    for fn, args in (
            (ks.fused_s2v_layer_sparse,
             [a.to(cuda) for a in (t4, x, sp.neighbors, edge, base)]),
            (kc.fused_s2v_layer_csr,
             [a.to(cuda) for a in (t4, x, cs.indices, cs.indptr, edge_w,
                                   base)])):
        for compute in ("f32", "bf16"):
            out = _both_walks(fn, args, compute)
            assert torch.equal(out[:, :, -iso:],
                               torch.relu(args[-1][:, :, -iso:]))


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_csr_aggregate_walks_agree_on_a_sampled_batch_on_the_card(cuda,
                                                                   compute):
    """B5's aggregate entry by the row walk and the windowed walk, bit for
    bit, on 8 subgraphs that ``NeighborSampler`` draws from BA(20000,
    d=10) with 64 seeds and fanouts (8, 4) (node budget 2624, edge budget
    5120; padding nodes and slots with poisoned factors), with the residual
    factors of a random 10% partial solution; each route within
    ``_assert_close_by_terms`` of the plain version, and 0 on the padding
    nodes.  The rule picks the row walk there, and counts it."""
    from repro_torch.core import NeighborSampler
    from repro_torch.core.graphs import (barabasi_albert_edges,
                                         csr_from_edges,
                                         csr_residual_edge_mask)
    n = 20_000
    indptr, indices = csr_from_edges(n, *barabasi_albert_edges(n, 10,
                                                               seed=3))
    s = NeighborSampler(indptr, indices, batch_size=64, fanouts=(8, 4),
                        seed=1)
    cs, maps = s.training_batch(8, device=cuda)
    b, nb = cs.batch, cs.num_nodes
    g = torch.Generator(device=cuda).manual_seed(5)
    sol = (torch.rand((b, nb), generator=g, device=cuda) < 0.1).float()
    edge_w = csr_residual_edge_mask(cs.indices, cs.edge_mask,
                                    csr_row_ids(cs.indptr, cs.num_edges),
                                    sol)
    edge_w[~cs.edge_mask] = 5.0
    x = torch.relu(torch.rand((b, 32, nb), generator=g, device=cuda) - 0.5)
    args = (x, cs.indices, cs.indptr, edge_w)

    def plain(x, indices, indptr, edge_w, compute):
        return kc.csr_aggregate_plain(x, indices, csr_row_ids(
            indptr, indices.shape[1]), edge_w, compute)
    routes = dict(kc.csr_aggregate.routes)
    out = kc.csr_aggregate(*args, compute)
    assert kc.csr_aggregate.routes["rows"] == routes["rows"] + 1
    assert torch.equal(_both_walks(kc.csr_aggregate, args, compute), out)
    _assert_close_by_terms(out, plain, args, compute)
    padding = torch.from_numpy(maps < 0).to(cuda)
    assert padding.any() and not out.transpose(1, 2)[padding].any()
