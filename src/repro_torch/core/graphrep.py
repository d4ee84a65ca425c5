"""Graph-representation backends (DESIGN.md §1).  Counterpart of
``repro/core/graphrep.py`` for solving:

- ``DenseRep``  — (B, N, N) residual adjacency, rewritten per commit (in
  place: the solve owns a copy);
- ``SparseRep`` — (B, N, D) padded neighbour lists + masks; the topology
  is immutable and residual edges derive from the solution mask;
- ``CsrRep``    — flat (indptr, indices, edge_mask) CSR arrays, storage
  proportional to the edges (DESIGN.md §13).

The sparse and CSR commits write only new C/S masks, never into the
topology, so a state built from a caller's batch shares its topology
tensors safely.  On a mesh (``mesh.shard_state``) a dense or sparse state
holds one rank's topology rows and the whole masks; its commit updates
its own rows and all-gathers the residual degrees over the graph axis,
so every rank derives the same candidates and ``done``, bit for bit the
single-device values.  ``prepare_dataset`` and ``state_from_tuples`` (replay
re-materialization, Alg. 5 line 21) are ported for the three reps, in the
"solution", "none" and "closed" residual modes (MVC, MaxCut and MDS, MIS).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from ..device import DeviceLike, resolve_device
from .graphs import (CsrGraphBatch, CsrGraphState, GraphState,
                     SparseGraphBatch, SparseGraphState,
                     closed_neighborhood_keep, closed_neighborhood_keep_dense,
                     csr_batch_from_dense, csr_closed_neighborhood_keep,
                     csr_init_state, csr_residual_edge_mask, csr_row_ids,
                     csr_segment_sum, init_state, residual_edge_mask,
                     sparse_batch_from_dense, sparse_init_state,
                     symmetric_topology)
from .mesh import gather_rows, local_rows
from .policy import Policy, policy_scores
from .s2v_csr import csr_policy_scores, csr_state_bytes
from .s2v_sparse import sparse_policy_scores, sparse_state_bytes


def candidate_mask(adj: torch.Tensor, solution: torch.Tensor) -> torch.Tensor:
    """Nodes of positive residual degree outside S, as float32."""
    return ((adj.sum(-1) > 0) & (solution < 0.5)).to(torch.float32)


class GraphRep:
    """Backend interface: state construction, policy scores, commit."""

    name: str = "?"

    def init_state(self, adj, *, device: DeviceLike = "cuda"):
        raise NotImplementedError

    def scores(self, params: Policy, state, *, num_layers: int,
               masked: bool = True, kernel: str = "fused",
               compute: str = "f32") -> torch.Tensor:
        raise NotImplementedError

    def commit(self, state, sel: torch.Tensor):
        raise NotImplementedError

    def state_bytes(self, state) -> int:
        raise NotImplementedError

    def prepare_dataset(self, adj_stack, *, device: DeviceLike = "cuda"):
        """(G, N, N) training graphs → the dataset source on ``device``."""
        raise NotImplementedError

    def dataset_shape(self, source):
        """(G, N): the dataset's graph count and node count."""
        return source.batch, source.num_nodes

    def state_from_tuples(self, source, graph_idx, solutions, residual=True,
                          candidate_fn=None):
        """Tuples2Graphs (Alg. 5 line 21): the states of B replay tuples
        from the dataset source, (B,) graph ids and (B, N) solution masks.
        ``residual`` is the env's topology mode, ``candidate_fn`` its
        candidate rule (``env.register``)."""
        raise NotImplementedError

    def __repr__(self):
        return f"GraphRep({self.name})"


class DenseRep(GraphRep):
    """(B, N, N) residual adjacency."""

    name = "dense"

    def init_state(self, adj, *, device: DeviceLike = "cuda") -> GraphState:
        """The solve's own state.  A given ``GraphState`` is copied too:
        ``commit`` zeroes ``adj`` in place, which must never reach the
        caller's buffers."""
        if isinstance(adj, GraphState):
            dev = resolve_device(device)
            return dataclasses.replace(adj, **{
                name: getattr(adj, name).to(device=dev, copy=True)
                for name in ("adj", "candidate", "solution")})
        return init_state(adj, device=device)

    def prepare_dataset(self, adj_stack, *,
                        device: DeviceLike = "cuda") -> torch.Tensor:
        """The (G, N, N) float32 adjacency stack on ``device``."""
        return torch.as_tensor(adj_stack).to(device=resolve_device(device),
                                             dtype=torch.float32)

    def dataset_shape(self, source: torch.Tensor):
        return source.shape[0], source.shape[-1]

    def state_from_tuples(self, source: torch.Tensor, graph_idx, solutions,
                          residual=True, candidate_fn=None) -> GraphState:
        """The residual graphs of the tuples, gathered from ``source``
        (graph ids and masks as tensors on its device, or numpy).  The gathered
        (B, N, N) copy is the state's own, so the "solution" and "closed"
        modes mask it in place (two in-place multiplies, the values of
        ``residual_adjacency`` and of JAX's closed mask): at B = 64,
        N = 4096 one copy is 4.3 GB.  In the "closed" mode (MIS) the
        candidates are the original positive-degree nodes that survive,
        so their degrees are taken before the mask."""
        mode = tuples_mode(residual)
        sol = torch.as_tensor(solutions, device=source.device).to(
            torch.float32)
        adj = source[torch.as_tensor(graph_idx, device=source.device)]
        if mode == "closed":
            keep = closed_neighborhood_keep_dense(adj, sol)
            cand = ((adj.sum(-1) > 0) & (keep > 0.5)).to(torch.float32)
        elif mode == "solution":
            keep = 1.0 - sol
        if mode != "none":
            adj.mul_(keep[:, :, None])
            adj.mul_(keep[:, None, :])
        if mode != "closed":
            cand = candidate_mask(adj, sol)
        return with_candidate_rule(
            GraphState(adj=adj, candidate=cand, solution=sol), candidate_fn)

    def scores(self, params, state: GraphState, *, num_layers,
               masked=True, kernel="fused", compute="f32") -> torch.Tensor:
        return policy_scores(params, state.adj, state.solution,
                             state.candidate, num_layers=num_layers,
                             masked=masked, kernel=kernel, compute=compute)

    def commit(self, state: GraphState, sel: torch.Tensor):
        """Covering commit (Alg. 4 lines 7-9): S gains ``sel`` and its
        nodes' rows and columns leave the residual adjacency.

        Unlike the JAX backend this updates ``state.adj`` IN PLACE, which
        halves the resident state of a solve (one (B, N, N) buffer, not
        two); the state is the solve's own copy (``init_state`` copies the
        caller's adjacency or state).  On a mesh the rank zeroes the
        selected nodes' rows among its own and their columns, and the
        degrees are all-gathered over the graph axis.  Returns (state,
        done)."""
        solution = torch.maximum(state.solution, sel)
        keep = 1.0 - sel
        adj = state.adj
        adj.mul_(local_rows(keep, state.axis)[:, :, None])
        adj.mul_(keep[:, None, :])
        deg = gather_rows(adj.sum(-1), state.axis)
        candidate = ((deg > 0) & (solution < 0.5)).to(torch.float32)
        # adjacency weights are non-negative, so the residual edge set is
        # empty exactly when every degree is zero (JAX sums all of adj)
        done = (deg == 0).all(-1)
        return dataclasses.replace(state, adj=adj, candidate=candidate,
                                   solution=solution), done

    def state_bytes(self, state: GraphState) -> int:
        return int(state.adj.numel() * state.adj.element_size()
                   + state.candidate.numel() * 4 + state.solution.numel() * 4)


def tuples_mode(residual) -> str:
    """The env's residual mode for re-materialization: "solution",
    "none" or "closed"."""
    from .env import normalize_residual_mode
    return normalize_residual_mode(residual)


def with_candidate_rule(state, candidate_fn):
    """``state`` with the env's candidate rule applied, if it has one."""
    if candidate_fn is None:
        return state
    return dataclasses.replace(state, candidate=candidate_fn(state))


def _topology_to(g, dev: torch.device):
    """``g`` (a batch or state) with its tensors on ``dev``; tensors
    already there are shared, not copied."""
    return dataclasses.replace(g, **{
        f.name: getattr(g, f.name).to(dev) for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), torch.Tensor)})


def symmetric_dataset(source):
    """``source``, a training dataset of padded lists or CSR arrays, once
    its graphs are checked symmetric (``graphs.symmetric_topology``): the
    sparse and CSR layers' backwards take each aggregate as its own
    transpose, so on a one-sided edge list they would train on wrong
    gradients."""
    if not symmetric_topology(source):
        raise ValueError(
            "the sparse and CSR reps train only on symmetric graphs (u "
            "lists v as often as v lists u, as the env builds them): their "
            "layers' backwards take each aggregate as its own transpose")
    return source


class SparseRep(GraphRep):
    """(B, N, D) padded neighbour lists: O(N·D) state, immutable topology,
    residual edges derived from the solution mask (paper §5.2).
    ``max_degree`` pins the list width (serving buckets); None derives it
    per batch."""

    name = "sparse"

    def __init__(self, max_degree: Optional[int] = None):
        self.max_degree = max_degree

    def init_state(self, adj, *, device: DeviceLike = "cuda"
                   ) -> SparseGraphState:
        """A fresh state from a dense adjacency or a SparseGraphBatch, or a
        given SparseGraphState, on ``device``."""
        dev = resolve_device(device)
        if isinstance(adj, SparseGraphState):
            return _topology_to(adj, dev)
        if isinstance(adj, SparseGraphBatch):
            return sparse_init_state(_topology_to(adj, dev))
        return sparse_init_state(sparse_batch_from_dense(
            adj, self.max_degree, device=dev))

    def prepare_dataset(self, adj_stack, *,
                        device: DeviceLike = "cuda") -> SparseGraphBatch:
        """The (G, N, N) training graphs as padded lists on ``device``
        (width ``max_degree``, or the stack's largest degree); a given
        SparseGraphBatch is moved there.  Its graphs must be symmetric
        (``symmetric_dataset``; ValueError otherwise)."""
        if isinstance(adj_stack, SparseGraphBatch):
            return symmetric_dataset(_topology_to(adj_stack,
                                                  resolve_device(device)))
        return symmetric_dataset(sparse_batch_from_dense(
            adj_stack, self.max_degree, device=device))

    def state_from_tuples(self, source: SparseGraphBatch, graph_idx,
                          solutions, residual=True,
                          candidate_fn=None) -> SparseGraphState:
        """The tuples' states: their graphs' lists gathered from
        ``source`` (the state's own copy, never rewritten) and the masks;
        the residual factors derive from the solution mask wherever they
        are needed."""
        from .env import residual_flag
        mode = tuples_mode(residual)
        dev = source.device
        sol = torch.as_tensor(solutions, device=dev).to(torch.float32)
        gi = torch.as_tensor(graph_idx, device=dev).long()
        nbrs, valid = source.neighbors[gi], source.valid[gi]
        if mode == "closed":
            keep = closed_neighborhood_keep(nbrs, valid, sol)
            cand = (valid.sum(-1) > 0) & (keep > 0.5)
        else:
            deg = (residual_edge_mask(nbrs, valid, sol).sum(-1)
                   if mode == "solution" else valid.sum(-1))
            cand = (deg > 0) & (sol < 0.5)
        return with_candidate_rule(SparseGraphState(
            neighbors=nbrs, valid=valid, candidate=cand.to(torch.float32),
            solution=sol, residual=residual_flag(mode)), candidate_fn)

    def scores(self, params, state: SparseGraphState, *, num_layers,
               masked=True, kernel="fused", compute="f32") -> torch.Tensor:
        return sparse_policy_scores(params, state, state.solution,
                                    state.candidate, num_layers=num_layers,
                                    masked=masked, residual=state.residual,
                                    kernel=kernel, compute=compute)

    def commit(self, state: SparseGraphState, sel: torch.Tensor):
        """Covering commit: S gains ``sel``; residual edges, candidates and
        done derive from the immutable topology (on a mesh, from the rank's
        list rows, with the degrees all-gathered over the graph axis).
        Returns (state, done)."""
        solution = torch.maximum(state.solution, sel)
        edge = residual_edge_mask(state.neighbors, state.valid, solution,
                                  local_rows(solution, state.axis))
        deg = gather_rows(edge.sum(-1), state.axis)
        candidate = ((deg > 0) & (solution < 0.5)).to(torch.float32)
        done = (deg == 0).all(-1)
        return dataclasses.replace(state, candidate=candidate,
                                   solution=solution), done

    def state_bytes(self, state: SparseGraphState) -> int:
        return sparse_state_bytes(state)


class CsrRep(GraphRep):
    """Flat (indptr, indices, edge_mask) CSR arrays: O(E) state, immutable
    topology, residual edges derived from the solution mask (DESIGN.md
    §13).  ``max_edges`` pins the padded edge capacity (serving buckets);
    None derives it per batch."""

    name = "csr"

    def __init__(self, max_edges: Optional[int] = None):
        self.max_edges = max_edges

    def init_state(self, adj, *, device: DeviceLike = "cuda"
                   ) -> CsrGraphState:
        """A fresh state from a dense adjacency or a CsrGraphBatch, or a
        given CsrGraphState, on ``device``."""
        dev = resolve_device(device)
        if isinstance(adj, CsrGraphState):
            return _topology_to(adj, dev)
        if isinstance(adj, CsrGraphBatch):
            return csr_init_state(_topology_to(adj, dev))
        return csr_init_state(csr_batch_from_dense(adj, self.max_edges,
                                                   device=dev))

    def prepare_dataset(self, adj_stack, *,
                        device: DeviceLike = "cuda") -> CsrGraphBatch:
        """The (G, N, N) training graphs as CSR arrays on ``device`` (edge
        capacity ``max_edges``, or the stack's largest edge count); a given
        CsrGraphBatch (``graphs.csr_batch_from_arrays`` builds one with no
        dense array) is moved there.  Its graphs must be symmetric
        (``symmetric_dataset``; ValueError otherwise)."""
        if isinstance(adj_stack, CsrGraphBatch):
            return symmetric_dataset(_topology_to(adj_stack,
                                                  resolve_device(device)))
        return symmetric_dataset(csr_batch_from_dense(
            adj_stack, self.max_edges, device=device))

    def state_from_tuples(self, source: CsrGraphBatch, graph_idx, solutions,
                          residual=True, candidate_fn=None) -> CsrGraphState:
        """The tuples' states: their graphs' CSR arrays gathered from
        ``source`` (the state's own copy, never rewritten) and the masks.
        At B = 64 graphs of ER(20480, 0.15) the copy holds 16.1 GB of
        indices and 4.0 GB of mask; the degrees' row ids and factors are
        transients (``graphs.CHUNK_SLOTS``)."""
        from .env import residual_flag
        mode = tuples_mode(residual)
        dev = source.device
        sol = torch.as_tensor(solutions, device=dev).to(torch.float32)
        gi = torch.as_tensor(graph_idx, device=dev).long()
        indptr, indices = source.indptr[gi], source.indices[gi]
        mask = source.edge_mask[gi]
        rid = csr_row_ids(indptr, indices.shape[1])
        edge = (csr_residual_edge_mask(indices, mask, rid, sol)
                if mode == "solution" else mask.to(torch.float32))
        deg = csr_segment_sum(edge, rid, sol.shape[1])
        if mode == "closed":
            keep = csr_closed_neighborhood_keep(indices, mask, rid, sol)
            cand = (deg > 0) & (keep > 0.5)
        else:
            cand = (deg > 0) & (sol < 0.5)
        del rid, edge
        return with_candidate_rule(CsrGraphState(
            indptr=indptr, indices=indices, edge_mask=mask,
            candidate=cand.to(torch.float32), solution=sol,
            residual=residual_flag(mode)), candidate_fn)

    def scores(self, params, state: CsrGraphState, *, num_layers,
               masked=True, kernel="fused", compute="f32") -> torch.Tensor:
        return csr_policy_scores(params, state, state.solution,
                                 state.candidate, num_layers=num_layers,
                                 masked=masked, residual=state.residual,
                                 kernel=kernel, compute=compute)

    def commit(self, state: CsrGraphState, sel: torch.Tensor):
        """Covering commit on CSR arrays, as ``SparseRep.commit``."""
        solution = torch.maximum(state.solution, sel)
        rid = csr_row_ids(state.indptr, state.num_edges)
        edge = csr_residual_edge_mask(state.indices, state.edge_mask, rid,
                                      solution)
        deg = csr_segment_sum(edge, rid, state.num_nodes)
        candidate = ((deg > 0) & (solution < 0.5)).to(torch.float32)
        done = (deg == 0).all(-1)
        return dataclasses.replace(state, candidate=candidate,
                                   solution=solution), done

    def state_bytes(self, state: CsrGraphState) -> int:
        return csr_state_bytes(state)


DENSE = DenseRep()
SPARSE = SparseRep()
CSR = CsrRep()

_REPS: Dict[str, GraphRep] = {"dense": DENSE, "sparse": SPARSE, "csr": CSR}


def get_rep(rep: Union[str, GraphRep, None]) -> GraphRep:
    """Resolve a representation name/instance to a backend."""
    if rep is None:
        return DENSE
    if isinstance(rep, GraphRep):
        return rep
    try:
        return _REPS[rep]
    except KeyError:
        raise ValueError(f"unknown graph representation {rep!r}; "
                         f"available: {rep_names()}") from None


def rep_names():
    return sorted(_REPS)


def rep_for_state(state) -> GraphRep:
    """The backend of a state, by its type."""
    if isinstance(state, CsrGraphState):
        return CSR
    return SPARSE if isinstance(state, SparseGraphState) else DENSE
