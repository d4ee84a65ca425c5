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

The GD half is :func:`manual_train_minibatch_fn`, the counterpart of
JAX's manual-collective step (Alg. 5's per-GPU gradient descent and
MPI_All_reduce on the 2-D mesh), which the port runs at every mesh shape
(it has no GSPMD): the replay rows of the minibatch exchanged over
``data`` (``core.replay.sharded_replay_rows``), the topology
re-materialized on the rank's tile (:func:`tile_from_tuples`), the fresh
target's max and "has a candidate" reduced over ``graph`` outside the
differentiated function, the squared TD errors of the (row, action node)
pairs the tile owns (:func:`ownership_loss`), and one world all-reduce of
the gradients and the loss before Adam.  Every collective the loss passes
is one autograd sees (``mesh.pooled_sum``, ``mesh.partial_sum_columns``,
the gathered sparse layers).  At sp = 1 (and for CSR, which takes sp = 1
only) the graph axis is dropped: each data rank runs the single-device
loss on its minibatch rows (the dense layer is B1, as on one device).

The host training loop's step on a mesh is :func:`spatial_train_minibatch_fn`
(JAX's name, whose staged-GSPMD lowering the port does not copy): it
takes the rank's tile of a minibatch the host loop re-materialized
(:func:`tile_state_from_tuples`) and the whole minibatch's actions and
targets, and shares the fused step's loss, all-reduce and Adam update.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..device import DeviceLike, resolve_device
from .agent import adam_step, loss_and_grads, max_q_from_scores
from .graphrep import candidate_mask, tuples_mode
from .graphs import (GraphState, SparseGraphState,
                     closed_neighborhood_keep_dense)
from .mesh import (Axis, Mesh, all_gather_tiled, all_reduce_max,
                   all_reduce_sum, all_reduce_world, local_rows, make_mesh,
                   mesh_shape, shard_nodes)
from .policy import policy_scores
from .qmodel import scores_local
from .replay import sharded_replay_rows
from .s2v_sparse import (closed_keep_local, edge_factors,
                         embed_sparse_local, keep_edge_factors)


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
    False/"none" scores the original topology; "closed" (MIS) all-gathers
    the solution, then the rows' keep mask
    (``s2v_sparse.closed_edge_factors``)."""
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


# ---------------------------------------------------------------------------
# The GD half: re-materialization on the tile, the ownership loss and the
# mesh GD step.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MinibatchTile:
    """One rank's tile of a re-materialized minibatch: the topology rows
    of its Nl = N/sp nodes for its M/dp tuples (dense ``(adj,)``, (M/dp,
    Nl, N); sparse ``(neighbors, valid, edge factors)``, (M/dp, Nl, D)),
    and the solution and candidate masks of those Nl nodes."""
    topology: Tuple[torch.Tensor, ...]
    solution: torch.Tensor
    candidate: torch.Tensor


def tile_from_tuples(mesh: Mesh, rep, source, graph_idx: torch.Tensor,
                     solution: torch.Tensor, residual=True,
                     candidate_fn=None) -> MinibatchTile:
    """``rep.state_from_tuples`` on a rank's tile (JAX's ``_dense_remat``
    and ``_sparse_remat``, in the "solution", "none" and "closed" modes):
    ``source`` is the rank's dataset tile (``mesh.shard_dataset``),
    ``graph_idx`` its M/dp tuples' graph ids and ``solution`` their
    (M/dp, Nl) mask slices.  The residual topology of remote endpoints
    needs their solution, so the keep mask (dense "solution"), the
    solution (sparse "solution" factors) or the solution and then the
    closed keep mask ("closed") is all-gathered over ``graph``.  The
    closed mode's candidates are the original positive-degree rows that
    survive.  ``candidate_fn`` (the env's candidate rule, MDS's) runs on
    the tile as a state with the whole solution, all-gathered, and gives
    the rank's rows (``rows=True``).  Equal bit for bit to the matching
    rows (and columns) of the single-device state."""
    mode = tuples_mode(residual)
    g = mesh.graph
    gi = graph_idx.long()
    if rep.name == "dense":
        adj = source[gi]
        if mode == "closed":
            keep = closed_neighborhood_keep_dense(
                adj, all_gather_tiled(solution, g, 1), solution)
            cand = ((adj.sum(-1) > 0) & (keep > 0.5)).to(torch.float32)
        elif mode == "solution":
            keep = 1.0 - solution
        if mode != "none":
            adj.mul_(keep[:, :, None])
            adj.mul_(all_gather_tiled(keep, g, 1)[:, None, :])
        if mode != "closed":
            cand = candidate_mask(adj, solution)
        tile = MinibatchTile((adj,), solution, cand)
    elif rep.name == "sparse":
        nbr, valid = source.neighbors[gi], source.valid[gi]
        if mode == "closed":
            keep = closed_keep_local(nbr, valid, solution, axis=g)
            edge = keep_edge_factors(nbr, valid, keep, axis=g)
            cand = (valid.sum(-1) > 0) & (keep > 0.5)
        else:
            edge = edge_factors(nbr, valid, solution, mode, axis=g)
            cand = (edge.sum(-1) > 0) & (solution < 0.5)
        tile = MinibatchTile((nbr, valid, edge), solution,
                             cand.to(torch.float32))
    else:
        raise ValueError(f"the tile re-materialization takes the dense and "
                         f"sparse reps, got {rep.name!r}")
    if candidate_fn is not None:
        tile.candidate = candidate_fn(_tile_state(tile, g), rows=True)
    return tile


def _tile_state(tile: MinibatchTile, axis: Axis):
    """A minibatch tile as the env's rules take a tile (``state.axis``):
    its topology rows and the solution all-gathered over ``axis``; the
    candidates stay the tile's rows, which a rule called with
    ``rows=True`` does not read."""
    sol = all_gather_tiled(tile.solution, axis, 1)
    if len(tile.topology) == 1:
        return GraphState(adj=tile.topology[0], candidate=tile.candidate,
                          solution=sol, axis=axis)
    nbr, valid, _ = tile.topology
    return SparseGraphState(neighbors=nbr, valid=valid,
                            candidate=tile.candidate, solution=sol,
                            residual=False, axis=axis)


def tile_scores(mesh: Mesh, params, tile: MinibatchTile, *, num_layers: int,
                masked: bool = True, kernel: str = "fused",
                compute: str = "f32") -> torch.Tensor:
    """The (M/dp, Nl) scores of a tile's own nodes, the per-layer
    collectives over ``graph`` (Alg. 2-3), differentiable."""
    g = mesh.graph
    if len(tile.topology) == 1:                      # dense: (adj,)
        return policy_scores(params, tile.topology[0], tile.solution,
                             tile.candidate, num_layers=num_layers, axis=g,
                             masked=masked, kernel=kernel, compute=compute)
    nbr, _valid, edge = tile.topology
    emb = embed_sparse_local(params.em, nbr, edge, tile.solution,
                             num_layers=num_layers, axis=g, kernel=kernel,
                             compute=compute)
    return scores_local(params.q, emb, tile.candidate, axis=g, masked=masked)


def ownership_loss(scores: torch.Tensor, action: torch.Tensor,
                   target: torch.Tensor, axis: Optional[Axis],
                   minibatch: int) -> torch.Tensor:
    """The squared TD errors of the (row, action node) pairs whose node is
    among this rank's ``scores`` columns (all of them when ``axis`` is
    None), summed and divided by the global ``minibatch``, so the sum over
    the mesh is the single-device mean (JAX's ``_ownership_loss``)."""
    nl = scores.shape[1]
    loc = action.long() - (axis.index * nl if axis is not None else 0)
    owned = (loc >= 0) & (loc < nl)
    qsa = torch.gather(scores, 1, loc.clamp(0, nl - 1)[:, None])[:, 0]
    sq = torch.where(owned, torch.square(qsa - target),
                     torch.zeros_like(target))
    return sq.sum() / minibatch


def _tile_scorer(mesh: Mesh, rep, **kw):
    """``scores(params, tile, masked)``: a minibatch tile's (M/dp, Nl)
    scores (:func:`tile_scores`), or at sp = 1 the rep's scores of the
    data rank's state."""
    if mesh.sp == 1:
        return lambda params, st, masked: rep.scores(params, st,
                                                     masked=masked, **kw)
    return lambda params, st, masked: tile_scores(mesh, params, st,
                                                  masked=masked, **kw)


def _tile_loss_and_grads(mesh: Mesh, params, st, action: torch.Tensor,
                         target: torch.Tensor, scores, minibatch: int):
    """The GD iteration on a rank's minibatch tile, both mesh steps' inner
    part: the ownership loss of the tile's (row, action node) pairs
    (``action``, ``target``: the data rank's M/dp tuples), its gradients,
    then one world all-reduce of the loss and the flattened gradients.
    Returns (loss, grads) summed over the mesh."""
    g = mesh.graph if mesh.sp > 1 else None
    loss, grads = loss_and_grads(params, lambda p: ownership_loss(
        scores(p, st, False), action, target, g, minibatch))
    with record_function("train_step.allreduce"):
        names = list(grads)
        flat = torch.cat([loss.reshape(1)]
                         + [grads[k].reshape(-1) for k in names])
        all_reduce_world(mesh, flat)
        parts = flat[1:].split([grads[k].numel() for k in names])
        grads = {k: v.view_as(grads[k]) for k, v in zip(names, parts)}
    return flat[0], grads


def manual_train_minibatch_fn(mesh: Mesh, *, rep, num_layers: int,
                              lr: float, gamma: float, minibatch: int,
                              residual=True, candidate_fn=None,
                              target_mode: str = "fresh",
                              kernel: str = "fused", compute: str = "f32"):
    """The mesh GD step, run by every rank: ``fn(params, opt, replay,
    source, idx) -> (params, opt, loss)``.  ``replay`` is the rank's tile
    of the ring (``device_replay_init(mesh=)``), ``source`` its dataset
    tile (``mesh.shard_dataset``), ``idx`` the (M,) replay indices of the
    iteration, the same on every rank.  ``fn.loss_and_grads(params,
    replay, source, idx)`` is the step without its Adam update: the loss
    and the gradients, all-reduced over the mesh.

    ``residual`` is the env's topology mode and ``candidate_fn`` its
    candidate rule (MDS's), which every re-materialization applies, on a
    tile through :func:`tile_from_tuples`.

    Collectives per iteration (dense at sp > 1; the sparse rep all-gathers
    the (M/dp, K, Nl) embedding per layer instead, and its factors gather
    the solution):

    | collective | axis | operand |
    | --- | --- | --- |
    | all-gather | data | the replay rows of the minibatch (per field) |
    | all-gather | graph | the keep mask, per re-materialization ("solution") |
    | all-gather | graph | the (M/dp, N) solution, then the keep mask, per re-materialization ("closed", MIS) |
    | all-gather | graph | the (M/dp, N) solution, then the undominated mask, per re-materialization (MDS's candidates) |
    | all-reduce (+ all-gather back) | graph | the (M/dp, K, N) partial aggregate, per layer |
    | all-reduce (+ back) | graph | the (M/dp, K) pooled embedding |
    | all-reduce max, sum | graph | the fresh target's max and candidates |
    | all-reduce | world | the loss and the (4K²+4K) gradient |
    """
    mode = tuples_mode(residual)
    stored = target_mode == "stored"
    g = mesh.graph if mesh.sp > 1 else None
    scores = _tile_scorer(mesh, rep, num_layers=num_layers, kernel=kernel,
                          compute=compute)
    fields = (("graph_idx", "solution", "action", "target") if stored else
              ("graph_idx", "solution", "action", "reward", "next_solution",
               "done"))

    def remat(source, gi, sol):
        with record_function("train_step.rematerialize"):
            if g is None:
                return rep.state_from_tuples(source, gi, sol, residual=mode,
                                             candidate_fn=candidate_fn)
            return tile_from_tuples(mesh, rep, source, gi, sol, mode,
                                    candidate_fn)

    def loss_and_grads_fn(params, replay, source, idx):
        rows = sharded_replay_rows(replay, idx, fields)
        if stored:
            gi, sol, act, tgt = rows
        else:
            gi, sol, act, rew, sol2, dn = rows
            st2 = remat(source, gi, sol2)
            with record_function("train_step.target"), torch.no_grad():
                s2 = scores(params, st2, True)
                if g is None:
                    nxt = max_q_from_scores(s2, st2.candidate)
                else:
                    # the max and "has a candidate" over the tile's nodes,
                    # then over the graph axis: JAX's pmax and psum
                    best = all_reduce_max(s2.amax(-1), g)
                    has = all_reduce_sum(st2.candidate.sum(-1), g) > 0
                    nxt = torch.where(has, best, torch.zeros_like(best))
                tgt = rew + gamma * nxt * (1.0 - dn)
            del st2
        st = remat(source, gi, sol)
        return _tile_loss_and_grads(mesh, params, st, act, tgt, scores,
                                    minibatch)

    def fn(params, opt, replay, source, idx):
        loss, grads = loss_and_grads_fn(params, replay, source, idx)
        adam_step(params, opt, grads, lr=lr)
        return params, opt, loss

    fn.loss_and_grads = loss_and_grads_fn
    return fn


def tile_state_from_tuples(mesh: Mesh, rep, source, graph_idx, solutions, *,
                           device: DeviceLike = "cuda", residual=True,
                           candidate_fn=None):
    """This rank's tile (``mesh.shard_state``'s layout: its data rank's
    B/dp graphs, its graph rank's N/sp topology rows, the masks whole) of
    ``rep.state_from_tuples(source, graph_idx, solutions)`` for the whole
    batch, on ``device``: the episode state of a mesh train step.  The
    data rank's rows are built where ``source`` (the whole dataset) lives,
    then the topology rows move."""
    dev = resolve_device(device)
    gi = torch.as_tensor(graph_idx)
    sol = torch.as_tensor(solutions)
    rows = mesh.data.rows(gi.shape[0])
    state = shard_nodes(mesh, rep.state_from_tuples(
        source, gi[rows], sol[rows], residual=residual,
        candidate_fn=candidate_fn))
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(dev).contiguous()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def _minibatch_tile(mesh: Mesh, state) -> MinibatchTile:
    """A rank's tile of a whole-row state (:func:`tile_state_from_tuples`'s
    layout: topology rows, masks whole) as the loss takes it: the
    topology rows (sparse: with the edge factors of the state's residual
    mode, whose remote endpoints' solution is all-gathered over
    ``graph``) and the masks of the rank's Nl nodes."""
    g = mesh.graph
    sol = local_rows(state.solution, g).contiguous()
    cand = local_rows(state.candidate, g).contiguous()
    if isinstance(state, GraphState):
        return MinibatchTile((state.adj,), sol, cand)
    edge = edge_factors(state.neighbors, state.valid, sol, state.residual,
                        axis=g)
    return MinibatchTile((state.neighbors, state.valid, edge), sol, cand)


def spatial_train_minibatch_fn(mesh: Mesh, *, rep, num_layers: int,
                               lr: float, kernel: str = "fused",
                               compute: str = "f32"):
    """The host training loop's GD step on the mesh, run by every rank
    (JAX's ``spatial_train_minibatch_fn``, the drop-in for the
    single-device ``train_minibatch_raw``): ``fn(params, opt, state,
    action, target) -> (params, opt, loss)``, ``params`` and ``opt``
    updated in place.  ``state`` is this rank's tile of the minibatch the
    host loop re-materialized (:func:`tile_state_from_tuples`: its data
    rank's M/dp tuples, its graph rank's N/sp topology rows, the masks
    whole); ``action`` and ``target`` are the whole minibatch's (M,), the
    same on every rank.  The loss, its all-reduce and Adam are
    :func:`manual_train_minibatch_fn`'s (:func:`_tile_loss_and_grads`);
    ``loss`` is the mesh's, the single-device mean.  CSR takes sp = 1."""
    scores = _tile_scorer(mesh, rep, num_layers=num_layers, kernel=kernel,
                          compute=compute)

    def fn(params, opt, state, action, target):
        m = action.shape[0]
        rows = mesh.data.rows(m)
        st = state if mesh.sp == 1 else _minibatch_tile(mesh, state)
        loss, grads = _tile_loss_and_grads(mesh, params, st, action[rows],
                                           target[rows], scores, m)
        adam_step(params, opt, grads, lr=lr)
        return params, opt, loss

    return fn
