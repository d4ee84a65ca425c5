"""Spatially partitioned policy evaluation on the 2-D ``(data, graph)``
mesh (paper §4.1; DESIGN.md §3/§10): the inference half of
``repro/core/spatial.py``.

Where the JAX package runs these scorers under ``shard_map``, here every
rank of a mesh (:mod:`repro_torch.core.mesh`) calls them on its own tiles:

- ``spatial_scores_fn`` (dense): each rank holds (B/dp, N/sp, N) adjacency
  rows and (B/dp, N/sp) mask slices, computes local scores with per-layer
  all-reduces over ``graph`` (Alg. 2-3), and the all-gather returns the
  (B/dp, N) score block on every graph rank (Alg. 4 line 6);
- ``sparse_spatial_scores_fn``: the same on the paper's distributed sparse
  graph storage (§4.1, §5.2), (B/dp, N/sp, D) neighbour-list rows per
  rank, with the (B/dp, K, N) embeddings all-gathered over ``graph`` per
  layer;
- ``spatial_solve_scores_fn``: state in, scores out, for the solve loop.

The mesh train step (``spatial_train_minibatch_fn``,
``manual_train_minibatch_fn``) comes with ROADMAP item "the mesh's train
half".
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .mesh import Mesh, all_gather_tiled, local_rows, make_mesh, mesh_shape
from .policy import policy_scores
from .qmodel import scores_local
from .s2v_sparse import edge_factors, embed_sparse_local


def make_graph_mesh(p: Optional[int] = None) -> Mesh:
    """Legacy 1-D entry point: P-way node sharding == the (1, P) mesh."""
    return make_mesh(1, p)


def _check_divisible(mesh: Mesh, b: int, n: int, what: str) -> None:
    dp, sp = mesh_shape(mesh)
    if b % dp:
        raise ValueError(f"{what}: batch {b} not divisible by data-axis "
                         f"size {dp} of mesh {mesh_shape(mesh)}")
    if n % sp:
        raise ValueError(f"{what}: {n} node rows not divisible by "
                         f"graph-axis size {sp} of mesh {mesh_shape(mesh)}")


def spatial_scores_fn(mesh: Mesh, num_layers: int, *, kernel: str = "fused",
                      compute: str = "f32"):
    """The mesh-partitioned scorer (dense representation), run by every
    rank on its tiles (:func:`shard_graph_arrays`).

    in:  adj_l (B/dp, N/sp, N), sol_l (B/dp, N/sp), cand_l (B/dp, N/sp)
    out: scores (B/dp, N), the same on every rank of the graph axis."""
    def fn(params, adj_l, sol_l, cand_l):
        local = policy_scores(params, adj_l, sol_l, cand_l,
                              num_layers=num_layers, axis=mesh.graph,
                              kernel=kernel, compute=compute)
        # Alg. 4 line 6: MPI_All_gather of the (B/dp, N/sp) local scores
        return all_gather_tiled(local, mesh.graph, 1)

    return fn


def sparse_spatial_scores_fn(mesh: Mesh, num_layers: int, *, residual=True,
                             kernel: str = "fused", compute: str = "f32"):
    """The mesh-partitioned scorer on distributed sparse storage, run by
    every rank on its tiles (:func:`shard_sparse_arrays`).

    in:  nbr_l (B/dp, N/sp, D) int32 global ids, valid_l (B/dp, N/sp, D)
         bool, sol_l (B/dp, N/sp), cand_l (B/dp, N/sp)
    out: scores (B/dp, N), the same on every rank of the graph axis.

    ``residual`` is the env's topology mode: True/"solution" all-gathers
    the solution slices for the residual-edge factors of remote endpoints;
    False/"none" scores the original topology; "closed" (MIS) raises (the
    other three problems)."""
    def fn(params, nbr_l, valid_l, sol_l, cand_l):
        edge_l = edge_factors(nbr_l, valid_l, sol_l, residual,
                              axis=mesh.graph)
        emb_l = embed_sparse_local(params.em, nbr_l, edge_l, sol_l,
                                   num_layers=num_layers, axis=mesh.graph,
                                   kernel=kernel, compute=compute)
        local = scores_local(params.q, emb_l, cand_l, axis=mesh.graph,
                             masked=True)
        return all_gather_tiled(local, mesh.graph, 1)

    return fn


def spatial_solve_scores_fn(mesh: Mesh, *, num_layers: int, rep,
                            residual=True, kernel: str = "fused",
                            compute: str = "f32"):
    """State-in, scores-out scorer for the solve loop: takes this rank's
    solve state (``mesh.shard_state`` layout: its topology rows, the masks
    whole), runs one spatially partitioned evaluation on its slices, and
    returns the (B/dp, N) scores, so the top-d commit runs in the paper's
    Fig. 4 lockstep on every graph rank."""
    g = mesh.graph
    if rep.name == "sparse":
        scorer = sparse_spatial_scores_fn(mesh, num_layers,
                                          residual=residual, kernel=kernel,
                                          compute=compute)
        return lambda params, state: scorer(
            params, state.neighbors, state.valid,
            local_rows(state.solution, g), local_rows(state.candidate, g))
    scorer = spatial_scores_fn(mesh, num_layers, kernel=kernel,
                               compute=compute)
    return lambda params, state: scorer(
        params, state.adj, local_rows(state.solution, g),
        local_rows(state.candidate, g))


def _tile(mesh: Mesh, x, dev: torch.device, dtype) -> torch.Tensor:
    """This rank's (B/dp, N/sp, ...) tile of a whole (B, N, ...) array."""
    b, n = x.shape[0], x.shape[1]
    t = x[mesh.data.rows(b), mesh.graph.rows(n)]
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    return t.to(device=dev, dtype=dtype).contiguous()


def shard_graph_arrays(mesh: Mesh, adj, sol, cand, *,
                       device: DeviceLike = "cuda"):
    """This rank's tiles of whole (B, N, N) / (B, N) / (B, N) arrays (numpy
    or torch): batch rows over ``data``, node rows over ``graph`` (the
    paper's row layout), on ``device``."""
    _check_divisible(mesh, adj.shape[0], adj.shape[1], "dense scores")
    dev = resolve_device(device)
    return tuple(_tile(mesh, x, dev, torch.float32) for x in (adj, sol, cand))


def shard_sparse_arrays(mesh: Mesh, neighbors, valid, sol, cand, *,
                        device: DeviceLike = "cuda"):
    """This rank's tiles of the sparse state: the (B/dp, N/sp, D)
    neighbour-list block of its resident nodes and their mask slices, on
    ``device``."""
    _check_divisible(mesh, neighbors.shape[0], neighbors.shape[1],
                     "sparse scores")
    dev = resolve_device(device)
    return (_tile(mesh, neighbors, dev, torch.int32),
            _tile(mesh, valid, dev, torch.bool),
            _tile(mesh, sol, dev, torch.float32),
            _tile(mesh, cand, dev, torch.float32))
