"""Rank functions of tests/test_torch_mesh.py and tests/test_torch_cuda.py,
run by ``repro_torch.core.mesh.spawn_mesh`` in spawned processes.  A
spawned rank imports this module by name, so it lives apart from the test
files and imports neither jax nor the JAX package: each rank only loads
torch."""
import time

import numpy as np
import torch

from repro_torch.convert import policy_from_numpy
from repro_torch.core import (DENSE, SPARSE, PolicyConfig, init_solve_state,
                              shard_graph_arrays,
                              shard_sparse_arrays, solve,
                              sparse_batch_from_dense,
                              sparse_spatial_scores_fn, spatial_scores_fn)
from repro_torch.core.graphs import residual_adjacency
from repro_torch.serving import GraphSolverService

REPS = ("dense", "sparse")
KERNELS = ("fused", "xla")


def partial_state(adj: np.ndarray, sol: np.ndarray):
    """The dense residual state of ``adj`` under the partial solution
    ``sol``: (adjacency, solution, candidate) as CPU tensors."""
    a = residual_adjacency(torch.from_numpy(adj), torch.from_numpy(sol))
    cand = ((a.sum(-1) > 0) & (torch.from_numpy(sol) < 0.5)).float()
    return a, torch.from_numpy(sol), cand


def run_shape(mesh, dev, weights, adj, partial_sol, stream):
    """Everything tests/test_torch_mesh.py checks on one mesh shape, in one
    spawn: full solves on every rep and lowering, the sharded scorers on
    two states, each rank's state tiles, divisibility errors and the sync
    service.  Returns this rank's results."""
    policy = policy_from_numpy(weights, device=dev)
    spec = mesh.shape
    out = {"rank": mesh.rank, "data": mesh.data.index,
           "graph": mesh.graph.index}
    for rep in REPS:
        for kernel in KERNELS:
            r = solve(policy, adj, num_layers=2, multi_node=True, rep=rep,
                      kernel=kernel, spatial=spec, device=dev)
            out["solve", rep, kernel] = (r.solution, r.policy_evals,
                                         r.nodes_committed)
    try:
        r = solve(policy, adj, num_layers=2, multi_node=True, rep="csr",
                  spatial=spec, device=dev)
        out["solve", "csr", "fused"] = (r.solution, r.policy_evals,
                                        r.nodes_committed)
    except ValueError as e:
        out["csr_error"] = str(e)

    # the sharded scorers on the fresh state and on a partial solution
    sp = sparse_batch_from_dense(adj, device="cpu")
    with torch.no_grad():
        for name, sol in (("fresh", np.zeros(adj.shape[:2], np.float32)),
                          ("partial", partial_sol)):
            a, s, c = partial_state(adj, sol)
            tiles = shard_graph_arrays(mesh, a, s, c, device=dev)
            out["scores", "dense", name] = spatial_scores_fn(
                mesh, 2)(policy, *tiles).numpy()
            tiles = shard_sparse_arrays(mesh, sp.neighbors, sp.valid, s, c,
                                        device=dev)
            out["scores", "sparse", name] = sparse_spatial_scores_fn(
                mesh, 2)(policy, *tiles).numpy()

    out["state_shape", "dense"] = tuple(
        init_solve_state(DENSE, adj, device=dev, mesh=mesh).adj.shape)
    st = init_solve_state(SPARSE, adj, device=dev, mesh=mesh)
    out["state_shape", "sparse"] = (tuple(st.neighbors.shape),
                                    tuple(st.solution.shape))
    try:
        solve(policy, adj[:, :15, :15], spatial=spec, device=dev)
    except ValueError as e:
        out["node_error"] = str(e)

    if spec in ((2, 1), (2, 2)):
        for rep in (("dense", "sparse") if spec == (2, 2) else ("dense",)):
            svc = GraphSolverService(
                policy, PolicyConfig(embed_dim=8, spatial=spec), rep=rep,
                device=dev, multi_node=True, max_batch=2)
            responses = svc.serve(stream)
            out["service", rep] = {
                "rows_per_dispatch": svc.rows_per_dispatch,
                "batches": svc.stats.batches,
                "responses": [(r.id, r.solution, r.size, r.policy_evals)
                              for r in responses]}
        try:
            svc.submit_async(stream[0])
        except NotImplementedError as e:
            out["async_error"] = str(e)
    return out


def fail_on_rank_one(mesh, dev):
    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    return mesh.rank


def hang_on_rank_one(mesh, dev):
    if mesh.rank == 1:
        time.sleep(3600)
    return mesh.rank


def solve_on_card(mesh, dev, weights, adj):
    """A dense and a sparse solve of ``adj`` on this rank's card, with the
    launches of the mesh kernels during each."""
    from repro_torch.kernels import s2v_fused as ks
    policy = policy_from_numpy(weights, device=dev)
    out = {}
    for rep, counter in (("dense", ks.mp_aggregate),
                         ("sparse", ks.fused_s2v_layer_sparse)):
        before = counter.launches
        r = solve(policy, adj, num_layers=2, multi_node=True, rep=rep,
                  spatial=mesh.shape, device=dev)
        out[rep] = (r.solution, r.policy_evals, counter.launches - before)
    return out
