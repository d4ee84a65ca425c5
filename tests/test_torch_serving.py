"""The port's serving layer (repro_torch.serving) against the JAX
package's on the CPU: bucketing and batch plans match, a mixed-size
stream's answers equal the port's own direct padded solves and the JAX
service's answers, async equals sync, drain requeues on failure, and
warmup keeps first dispatches off the request path."""
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from repro.core import PolicyConfig as JaxPolicyConfig
from repro.core import init_policy as jax_init_policy
from repro.serving import GraphSolverService as JaxService
from repro.serving import SolveRequest as JaxRequest
from repro.serving import plan_batches as jax_plan_batches
from repro_torch.convert import policy_from_numpy
from repro_torch.core import PolicyConfig, solve
from repro_torch.core.graphs import erdos_renyi
from repro_torch.serving import (DeadlineScheduler, GraphSolverService,
                                 PendingRequest, SolveRequest, bucket_nodes,
                                 pad_adjacency, plan_batches)

SIZES = [6, 11, 6, 19, 11, 6, 19]


def jax_to_numpy(params):
    return {f"{part}.{f.name}": np.asarray(getattr(getattr(params, part),
                                                   f.name))
            for part in ("em", "q")
            for f in dataclasses.fields(getattr(params, part))}


@pytest.fixture(scope="module")
def pair():
    params = jax_init_policy(jax.random.key(3), JaxPolicyConfig(embed_dim=8))
    policy = policy_from_numpy(jax_to_numpy(params), device="cpu")
    return params, policy, PolicyConfig(embed_dim=8, num_layers=2)


@pytest.fixture(scope="module")
def stream():
    return [erdos_renyi(n, 0.3, seed=10 + i) for i, n in enumerate(SIZES)]


def test_bucketing_matches_jax():
    from repro.serving import bucket_nodes as jax_bucket_nodes
    for n in (1, 7, 8, 9, 16, 17, 100, 4000):
        assert bucket_nodes(n) == jax_bucket_nodes(n)
    a = erdos_renyi(10, 0.3, seed=0)
    p = pad_adjacency(a, 16)
    assert p.shape == (16, 16) and (p[:10, :10] == a).all()
    assert p[10:].sum() == 0 and p[:, 10:].sum() == 0
    with pytest.raises(ValueError):
        pad_adjacency(a, 8)
    with pytest.raises(ValueError):
        bucket_nodes(0)


def test_plan_batches_match_jax():
    sizes = [5, 9, 20, 9, 5, 33]
    adjs = [erdos_renyi(n, 0.4, seed=i) for i, n in enumerate(sizes)]
    ours = plan_batches([SolveRequest(id=i, adj=a, n=a.shape[0])
                         for i, a in enumerate(adjs)], max_batch=2)
    theirs = jax_plan_batches([JaxRequest(id=i, adj=a, n=a.shape[0])
                               for i, a in enumerate(adjs)], max_batch=2)
    assert [(p.nb, p.request_ids, p.sizes) for p in ours] \
        == [(p.nb, p.request_ids, p.sizes) for p in theirs]
    for a, b in zip(ours, theirs):
        assert (a.adj == b.adj).all() and a.adj.shape == (2, a.nb, a.nb)


def test_service_stream_equals_direct_solves_and_jax_service(pair, stream):
    params, policy, cfg = pair
    svc = GraphSolverService(policy, cfg, device="cpu", max_batch=3)
    responses = svc.serve(stream)
    jax_resp = JaxService(params, JaxPolicyConfig(embed_dim=8),
                          max_batch=3).serve(stream)
    assert [len(r.solution) for r in responses] == SIZES
    for r, jr, adj, n in zip(responses, jax_resp, stream, SIZES):
        nb = bucket_nodes(n)
        assert r.bucket == nb == jr.bucket
        direct = solve(policy, pad_adjacency(adj, nb)[None], num_layers=2,
                       multi_node=True, device="cpu")
        assert (r.solution == direct.solution[0, :n]).all()
        assert direct.solution[0, n:].sum() == 0
        assert (r.solution == jr.solution).all()
        assert r.policy_evals == jr.policy_evals and r.size == jr.size
        keep = r.solution < 0.5
        assert adj[np.ix_(keep, keep)].sum() == 0
    s = svc.stats
    assert s.requests == len(SIZES) and s.batches == 3
    assert s.compiles == 3                 # buckets 8, 16, 32
    assert s.cache_hits == s.batches - s.compiles
    assert s.padded_rows == 2 and s.partial_batches == 2


def test_async_equals_sync_and_warmup_means_no_first_dispatch(pair, stream):
    _, policy, cfg = pair
    sync = GraphSolverService(policy, cfg, device="cpu",
                              max_batch=3).serve(stream)
    svc = GraphSolverService(policy, cfg, device="cpu", max_batch=3,
                             max_wait_ms=1.0)
    info = svc.warmup(SIZES)
    assert sorted(nb for nb, _ in info["compiled"]) == [8, 16, 32]
    assert svc.warmup(SIZES)["compiled"] == []          # idempotent
    with svc:
        futures = [svc.submit_async(a) for a in stream]
        responses = [f.result(timeout=120) for f in futures]
    for a, s in zip(responses, sync):
        assert (a.solution == s.solution).all()
        assert a.complete_t >= a.dispatch_t >= a.enqueue_t > 0
    assert svc.stats.compiles == 0 and svc.stats.warmup_compiles == 3
    assert not svc.running


def test_drain_requeues_on_failure(pair):
    _, policy, cfg = pair
    svc = GraphSolverService(policy, cfg, device="cpu", max_batch=1)
    i0 = svc.submit(erdos_renyi(9, 0.3, seed=0))
    i1 = svc.submit(erdos_renyi(9, 0.3, seed=1))
    orig, calls = svc._dispatch, []

    def flaky(plan):
        if calls:
            raise RuntimeError("boom")
        calls.append(1)
        return orig(plan)

    svc._dispatch = flaky
    with pytest.raises(RuntimeError):
        svc.drain()
    assert svc.pending() == 1
    svc._dispatch = orig
    assert set(svc.drain()) == {i0, i1}


def test_service_rejects_bad_input_and_unported_options(pair):
    _, policy, cfg = pair
    svc = GraphSolverService(policy, cfg, device="cpu")
    with pytest.raises(ValueError):
        svc.submit(np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError, match="unknown environment"):
        svc.submit(np.zeros((4, 4), np.float32), problem="bogus")
    # the other problems serve on one device (a mesh refuses them at
    # submit: tests/test_torch_problems.py)
    mis = np.zeros((4, 4), np.float32)
    mis[0, 1] = mis[1, 0] = 1.0
    rid = svc.submit(mis, problem="mis")
    assert svc.drain()[rid].solution.tolist() in ([1, 0, 0, 0],
                                                  [0, 1, 0, 0])
    with pytest.raises(ValueError, match="graph representation"):
        GraphSolverService(policy, dataclasses.replace(cfg, graph_rep="coo"),
                           device="cpu")
    # a mesh service (tests/test_torch_mesh.py) needs its ranks' process
    # group, and refuses CSR at sp > 1
    with pytest.raises(RuntimeError, match="spawn_mesh"):
        GraphSolverService(policy, dataclasses.replace(cfg, spatial=(2, 1)),
                           device="cpu")
    with pytest.raises(ValueError, match="does not support spatial"):
        GraphSolverService(policy, dataclasses.replace(cfg, spatial=(1, 2)),
                           rep="csr", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GraphSolverService(policy, cfg)


@pytest.mark.parametrize("rep", ["sparse", "csr"])
def test_sparse_and_csr_services_equal_jax_and_dense(pair, stream, rep):
    """One stream served on each rep: the answers equal the JAX service's
    on that rep and the port's dense service's; async equals sync."""
    params, policy, cfg = pair
    dense = GraphSolverService(policy, cfg, device="cpu",
                               max_batch=3).serve(stream)
    svc = GraphSolverService(policy, cfg, device="cpu", rep=rep, max_batch=3)
    assert svc.rep.name == rep
    responses = svc.serve(stream)
    jax_resp = JaxService(params, JaxPolicyConfig(embed_dim=8), rep=rep,
                          max_batch=3).serve(stream)
    for r, jr, d, adj in zip(responses, jax_resp, dense, stream):
        assert (r.solution == jr.solution).all()
        assert r.policy_evals == jr.policy_evals and r.bucket == jr.bucket
        assert (r.solution == d.solution).all()
        keep = r.solution < 0.5
        assert adj[np.ix_(keep, keep)].sum() == 0
    assert svc.stats.compiles == 3
    assert {nb: r.name for nb, r in svc._bucket_reps.items()} \
        == {8: rep, 16: rep, 32: rep}
    with svc:
        futures = [svc.submit_async(a) for a in stream]
        async_resp = [f.result(timeout=120) for f in futures]
    for a, s in zip(async_resp, responses):
        assert (a.solution == s.solution).all()


def test_caps_reject_rather_than_truncate(pair, stream):
    """A graph above sparse_max_degree or csr_max_edges is refused at
    submission; graphs under the caps are served as without them."""
    _, policy, cfg = pair
    big = stream[3]                                   # 19 nodes
    deg = int(big.sum(-1).max())
    edges = int(big.sum())
    sp = GraphSolverService(policy, cfg, device="cpu", rep="sparse",
                            sparse_max_degree=deg - 1)
    with pytest.raises(ValueError, match="sparse_max_degree"):
        sp.submit(big)
    with pytest.raises(ValueError, match="sparse_max_degree"):
        sp.submit_async(big)
    cs = GraphSolverService(policy, cfg, device="cpu", rep="csr",
                            csr_max_edges=edges - 1)
    with pytest.raises(ValueError, match="csr_max_edges"):
        cs.submit(big)
    assert sp.pending() == cs.pending() == 0 and not sp.running
    capped = GraphSolverService(policy, cfg, device="cpu", rep="csr",
                                csr_max_edges=edges, max_batch=3)
    free = GraphSolverService(policy, cfg, device="cpu", rep="csr",
                              max_batch=3)
    for a, b in zip(capped.serve([big, stream[0]]),
                    free.serve([big, stream[0]])):
        assert (a.solution == b.solution).all()
    assert capped._bucket_rep(32).max_edges == edges
    assert free._bucket_rep(32).max_edges == 32 * 32


@pytest.mark.parametrize("rep", ["sparse", "csr"])
def test_padding_probe_runs_on_every_rep(rep):
    """A candidate rule that admits isolated nodes only on one
    representation is still caught."""
    from repro_torch.core import rep_for_state

    def leaky(state):
        if rep_for_state(state).name == rep:
            return torch.ones_like(state.candidate)
        return state.candidate

    from repro_torch.core import env
    env.register("pt_leaky", candidates=leaky)(env.mvc_step)
    try:
        with pytest.raises(ValueError, match="padding-safety"):
            env.ensure_padding_safe("pt_leaky")
    finally:
        env.unregister("pt_leaky")


def _req(rid, n, enqueue_t):
    return SimpleNamespace(id=rid, n=n, problem="mvc", enqueue_t=enqueue_t)


def test_scheduler_edf_partial_dispatch_and_admission():
    s = DeadlineScheduler(2, max_wait_ms=100.0, max_queue_depth=3)
    assert s.offer(PendingRequest(_req(0, 10, 0.0), deadline_t=5.0))
    assert s.next_batch(0.05) is None               # waiting for a companion
    assert s.offer(PendingRequest(_req(1, 40, 0.01), deadline_t=1.0))
    assert s.offer(PendingRequest(_req(2, 40, 0.02), deadline_t=math.inf))
    assert not s.offer(PendingRequest(_req(3, 10, 0.03)))   # depth bound
    (nb, _), batch = s.next_batch(0.05)             # full 64-bucket first
    assert nb == 64 and [p.req.id for p in batch] == [1, 2]
    assert s.next_batch(0.05) is None
    (nb, _), batch = s.next_batch(0.2)              # head waited 200ms
    assert nb == 16 and [p.req.id for p in batch] == [0]


@pytest.mark.parametrize("rep", ["dense", "sparse", "csr"])
def test_launcher_serves_each_rep_on_the_cpu(rep, capsys):
    from repro_torch.launch import solve_serve
    solve_serve.main(["--device", "cpu", "--requests", "3", "--sizes",
                      "12,20", "--embed-dim", "8", "--warmup", "--rep", rep])
    out = capsys.readouterr().out
    assert f"served 3 requests on cpu ({rep} rep)" in out
    assert "0 request-path first dispatches" in out
    assert "problem mvc" in out
    # a problem besides MVC through the same buckets, async too
    for mode in ("sync", "async"):
        solve_serve.main(["--device", "cpu", "--requests", "3", "--sizes",
                          "12,20", "--embed-dim", "8", "--warmup", "--rep",
                          rep, "--problem", "mds", "--mode", mode])
        out = capsys.readouterr().out
        assert f"served 3 requests on cpu ({rep} rep)" in out
        assert "0 request-path first dispatches" in out
        assert "problem mds" in out
