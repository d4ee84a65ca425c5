"""Graph learning environments (paper §3): the registry, the problem suite
and the padding-safety contract.  Counterpart of ``repro/core/env.py``:
MVC, MaxCut, MIS (maximum independent set) and MDS (minimum dominating
set), each on the dense, sparse and CSR representations.

Each registration declares (DESIGN.md §11):

- ``residual``: what topology the policy sees, "solution" (MVC:
  committing a node deletes its edges), "none" (MaxCut, MDS: the topology
  is untouched) or "closed" (MIS: committing a node removes it and its
  neighbours);
- ``commit``: the Alg. 4 top-d commit and termination rule;
- ``candidates``: the candidate rule, where the default "positive residual
  degree, not in S" is wrong (MDS: a candidate must still cover an
  undominated node);
- ``prune``: a filter of the raw top-d selection (MIS: adjacent picks
  would break independence);
- ``checker``: the batched feasibility predicate on (original dense
  adjacency, solution);
- ``sense``: "min" or "max", for quality ratios against the baselines
  (``core.solvers``).

The serving layer pads graphs with isolated nodes, so an environment is
only servable if its candidate derivation can never admit a degree-0 node:
``ensure_padding_safe`` probes that on all three representations, through
``state_from_tuples`` and one env step.  For MDS this forces the
convention that isolated nodes count as already dominated, which
``is_dominating_set`` checks.

Every problem runs on one device and on a rank's tile of a ``(data,
graph)`` mesh (``state.axis``, ``mesh.shard_nodes``): the tile holds N/sp
topology rows and the whole masks, so each rule tests its own rows
(``mesh.local_rows``) against the whole masks and all-gathers its (B, N/sp)
result over the graph axis (``mesh.gather_rows``); MaxCut's reward sums
the action's edges on every rank's rows over the axis.  Each such value
is a ``> 0`` test or an integer-valued sum, so the tile gives the
single-device bits in any order.  With ``axis`` None the rules are the
single-device ones.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike
from .graphs import (CsrGraphState, GraphState, SparseGraphState,
                     _gather_nodes, closed_neighborhood_keep,
                     closed_neighborhood_keep_dense,
                     csr_closed_neighborhood_keep, csr_row_ids,
                     csr_segment_max, csr_segment_sum, init_state,
                     residual_edge_mask)
from .mesh import all_reduce_sum, gather_rows, local_rows
from .qmodel import NEG_INF

EnvStep = Callable[[GraphState, torch.Tensor],
                   Tuple[GraphState, torch.Tensor, torch.Tensor]]
CommitFn = Callable[[GraphState, torch.Tensor], Tuple[GraphState, torch.Tensor]]
CandidateFn = Callable[[GraphState], torch.Tensor]
PruneFn = Callable[[GraphState, torch.Tensor, torch.Tensor], torch.Tensor]

RESIDUAL_MODES = ("solution", "none", "closed")
_MAX_COMMIT = 8               # == inference.MAX_D (top-d selection width)

_REGISTRY: Dict[str, EnvStep] = {}
_MODE: Dict[str, str] = {}
_COMMIT: Dict[str, CommitFn] = {}
_CANDIDATES: Dict[str, Optional[CandidateFn]] = {}
_PRUNE: Dict[str, Optional[PruneFn]] = {}
_CHECKER: Dict[str, Callable] = {}
_SENSE: Dict[str, str] = {}
_PADDING_SAFE: Dict[str, bool] = {}


def normalize_residual_mode(residual: Union[bool, str]) -> str:
    """``register``'s ``residual`` argument → canonical mode string
    (``True`` is ``"solution"``, ``False`` is ``"none"``)."""
    if residual is True:
        return "solution"
    if residual is False:
        return "none"
    if residual in RESIDUAL_MODES:
        return residual
    raise ValueError(f"unknown residual mode {residual!r}; expected a bool "
                     f"or one of {RESIDUAL_MODES}")


def residual_flag(mode: str) -> Union[bool, str]:
    """The ``residual`` value a sparse or CSR state carries for a mode:
    True ("solution"), False ("none"), or the mode string ("closed")."""
    return {"solution": True, "none": False}.get(mode, mode)


def always_feasible(adj0: torch.Tensor, solution: torch.Tensor) -> torch.Tensor:
    """Default checker: every 0/1 assignment is feasible (MaxCut)."""
    return torch.ones(solution.shape[:-1], dtype=torch.bool,
                      device=solution.device)


def residual_commit(state, sel: torch.Tensor):
    """Covering-problem commit (Alg. 4 lines 7-9, "solution" mode):
    committing a node removes its incident edges; done when no edge
    survives.  Delegates to the state's backend (dense updates ``adj`` in
    place, see ``DenseRep.commit``; sparse and CSR derive new masks)."""
    from .graphrep import rep_for_state
    return rep_for_state(state).commit(state, sel)


def assignment_commit(state, sel: torch.Tensor):
    """Assignment-problem commit (MaxCut): S gains ``sel`` and the
    topology is untouched; done when no candidate remains.  Only the C/S
    masks change, the same on every representation."""
    solution = torch.maximum(state.solution, sel)
    candidate = torch.clamp(state.candidate - sel, 0.0, 1.0)
    return (dataclasses.replace(state, candidate=candidate,
                                solution=solution),
            candidate.sum(-1) == 0)


def register(name: str, residual: Union[bool, str] = True,
             commit: Optional[CommitFn] = None,
             candidates: Optional[CandidateFn] = None,
             prune: Optional[PruneFn] = None,
             checker: Optional[Callable] = None,
             sense: str = "min"):
    """Register an environment step (the DESIGN.md §11 extension point).
    ``commit`` defaults to :func:`assignment_commit` in the "none" mode
    and to :func:`residual_commit` otherwise."""
    mode = normalize_residual_mode(residual)
    if sense not in ("min", "max"):
        raise ValueError(f"sense must be 'min' or 'max', got {sense!r}")

    def deco(fn):
        _REGISTRY[name] = fn
        _MODE[name] = mode
        _COMMIT[name] = commit or (assignment_commit if mode == "none"
                                   else residual_commit)
        _CANDIDATES[name] = candidates
        _PRUNE[name] = prune
        _CHECKER[name] = checker or always_feasible
        _SENSE[name] = sense
        _PADDING_SAFE.pop(name, None)       # re-probe on re-registration
        return fn
    return deco


def unregister(name: str) -> None:
    """Remove an environment (test scaffolding for throwaway envs)."""
    for table in (_REGISTRY, _MODE, _COMMIT, _CANDIDATES, _PRUNE,
                  _CHECKER, _SENSE, _PADDING_SAFE):
        table.pop(name, None)


def _lookup(table: Dict, name: str):
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unknown environment {name!r}; registered: "
                         f"{names()}") from None


def make(name: str) -> EnvStep:
    return _lookup(_REGISTRY, name)


def residual_mode(name: str) -> str:
    return _lookup(_MODE, name)


def residual_semantics(name: str) -> bool:
    """True for any residual-rewriting mode (the boolean view of
    :func:`residual_mode`)."""
    return residual_mode(name) != "none"


def sparse_residual_flag(name: str) -> Union[bool, str]:
    """The ``residual`` value a sparse or CSR state carries for this env:
    True ("solution"), False ("none"), or the mode string."""
    return residual_flag(residual_mode(name))


def commit_rule(name: str) -> CommitFn:
    return _lookup(_COMMIT, name)


def candidate_rule(name: str) -> Optional[CandidateFn]:
    return _lookup(_CANDIDATES, name)


def prune_rule(name: str) -> Optional[PruneFn]:
    return _lookup(_PRUNE, name)


def checker(name: str) -> Callable:
    return _lookup(_CHECKER, name)


def sense(name: str) -> str:
    return _lookup(_SENSE, name)


def names():
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Padding-safety contract (DESIGN.md §9/§11).
# ---------------------------------------------------------------------------

def _probe_padding_safety(name: str) -> bool:
    """Drive the env's candidate derivation (``state_from_tuples`` with its
    residual mode and candidate rule, then one env step) on a graph with
    isolated padding-style nodes (0-1 share the only edge; 2 and 3 are
    isolated), on the dense, sparse and CSR representations, and report
    whether a degree-0 node ever becomes a candidate."""
    from .graphrep import CSR, DENSE, SPARSE
    adj = np.zeros((1, 4, 4), np.float32)
    adj[0, 0, 1] = adj[0, 1, 0] = 1.0
    mode, cand_fn = _MODE[name], _CANDIDATES[name]
    gi = torch.zeros((1,), dtype=torch.long)
    for rep in (DENSE, SPARSE, CSR):
        source = rep.prepare_dataset(adj, device="cpu")
        for sol in ([0, 0, 0, 0], [1, 0, 0, 0], [1, 1, 0, 0]):
            st = rep.state_from_tuples(
                source, gi, torch.tensor([sol], dtype=torch.float32),
                residual=mode, candidate_fn=cand_fn)
            if st.candidate[0, 2:].any():
                return False
        # one real transition from the fresh state must keep padding out
        st = rep.state_from_tuples(source, gi, torch.zeros((1, 4)),
                                   residual=mode, candidate_fn=cand_fn)
        st, _, _ = _REGISTRY[name](st, torch.tensor([0]))
        if st.candidate[0, 2:].any():
            return False
    return True


def ensure_padding_safe(name: str) -> None:
    """Raise unless ``name``'s candidate derivation excludes degree-0
    (isolated) nodes, the serving layer's padding.  Probed once per env."""
    _lookup(_REGISTRY, name)
    safe = _PADDING_SAFE.get(name)
    if safe is None:
        safe = _probe_padding_safety(name)
        _PADDING_SAFE[name] = safe
    if not safe:
        raise ValueError(
            f"environment {name!r} violates the padding-safety contract: "
            f"its candidate derivation admits degree-0 (isolated) nodes. "
            f"The solver service pads every graph with isolated nodes and "
            f"empty batch rows (repro_torch.serving.bucketing), so such an "
            f"env would score/commit padding. Derive candidates so deg==0 "
            f"nodes are excluded (treat isolated nodes as already "
            f"satisfied, as the 'mds' env does), or register a custom "
            f"`candidates` rule that masks them (DESIGN.md §11).")


def _onehot(v: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(v.long(), n).to(torch.float32)


def _axis(state):
    """The graph axis a tile's topology rows are split over (None: all
    rows; a CSR state is never split)."""
    return getattr(state, "axis", None)


def _rows(state) -> torch.Tensor:
    return torch.arange(state.candidate.shape[0],
                        device=state.candidate.device)


# ---------------------------------------------------------------------------
# MVC.
# ---------------------------------------------------------------------------

def _mvc_step_dense(state: GraphState, oh: torch.Tensor):
    """A new dense state: the step is functional, unlike the solve's
    in-place commit.  On a mesh tile (``state.axis``) the rank's rows are
    masked and the degrees all-gathered over the graph axis, as
    ``DenseRep.commit`` does."""
    solution = torch.maximum(state.solution, oh)
    keep = 1.0 - oh
    adj = (state.adj * local_rows(keep, state.axis)[:, :, None]
           * keep[:, None, :])
    deg = gather_rows(adj.sum(-1), state.axis)
    candidate = ((deg > 0) & (solution < 0.5)).to(torch.float32)
    # edge weights are non-negative: no edge survives iff every degree is 0
    return (dataclasses.replace(state, adj=adj, candidate=candidate,
                                solution=solution), (deg == 0).all(-1))


@register("mvc", checker=lambda adj0, sol: is_cover(adj0, sol))
def mvc_step(state, action: torch.Tensor):
    """Minimum Vertex Cover step (paper §4, Fig 3/4) on any representation.

    action: (B,) node ids.  Adds the node to the partial solution and
    removes its edges from the residual graph: dense zeroes its row and
    column in a new adjacency; sparse and CSR take their rep's commit,
    whose residual factors drop them.  Reward is -1 per selected node;
    done when no edges remain."""
    from .graphrep import rep_for_state
    b, n = state.candidate.shape
    oh = _onehot(action, n)
    if isinstance(state, GraphState):
        state, done = _mvc_step_dense(state, oh)
    else:
        state, done = rep_for_state(state).commit(state, oh)
    reward = -torch.ones((b,), dtype=torch.float32, device=oh.device)
    return state, reward, done


# ---------------------------------------------------------------------------
# MaxCut: residual "none", the assignment commit.
# ---------------------------------------------------------------------------

def _action_side_counts(state, action: torch.Tensor):
    """(edges from the action to S, edges from it to V∖S), each (B,): the
    dense rep reads the action's adjacency column over the state's rows
    (the row, by symmetry), the sparse rep the action's list on the rank
    that holds it (the others count nothing), the CSR rep a row-match mask
    over the E slots (its rows are ragged).  On a tile (``state.axis``)
    the counts are summed over the graph axis: integers, so exact."""
    in_s, axis = state.solution, _axis(state)
    if isinstance(state, CsrGraphState):
        rid = csr_row_ids(state.indptr, state.num_edges)
        w = ((rid == action.to(rid.dtype)[:, None]) & state.edge_mask
             ).to(torch.float32)
        side = _gather_nodes(torch.nn.functional.pad(in_s, (0, 1)),
                             state.indices)
    elif isinstance(state, SparseGraphState):
        nl = state.neighbors.shape[1]
        at = action - (axis.index * nl if axis is not None else 0)
        mine = (at >= 0) & (at < nl)
        at = at.clamp(0, nl - 1)
        w = state.valid[_rows(state), at].to(torch.float32) * mine[:, None]
        side = _gather_nodes(torch.nn.functional.pad(in_s, (0, 1)),
                             state.neighbors[_rows(state), at])
    else:
        w = state.adj[_rows(state), :, action]
        side = local_rows(in_s, axis)
    counts = torch.stack([(w * side).sum(-1), (w * (1.0 - side)).sum(-1)])
    if axis is not None:
        all_reduce_sum(counts, axis)
    return counts[0], counts[1]


@register("maxcut", residual=False, sense="max")
def maxcut_step(state, action: torch.Tensor):
    """Maximum Cut step: moving node v into S gains (edges to V∖S) minus
    (edges already cut to S).  The topology stays the original adjacency;
    candidates are the positive-degree nodes not yet in S; done when
    every one is assigned (a fixed horizon; the reward carries quality)."""
    to_s, to_out = _action_side_counts(state, action)
    state, done = assignment_commit(
        state, _onehot(action, state.candidate.shape[1]))
    if not isinstance(state, GraphState):
        state = dataclasses.replace(state, residual=False)
    return state, to_out - to_s, done


# ---------------------------------------------------------------------------
# MIS: residual "closed".  Committing v removes v and its neighbours (none
# of them can join S again), so the policy sees the graph induced on the
# eligible nodes.  Candidates are the surviving originally-positive-degree
# nodes: those isolated by removals stay (free +1 picks), padding never.
# ---------------------------------------------------------------------------

def _closed_keep(state, sel: torch.Tensor) -> torch.Tensor:
    """(B, N) keep factors of removing ``sel`` and its neighbours; on a
    tile, the rank's rows tested against the whole ``sel``, gathered."""
    if isinstance(state, CsrGraphState):
        rid = csr_row_ids(state.indptr, state.num_edges)
        return csr_closed_neighborhood_keep(state.indices, state.edge_mask,
                                            rid, sel)
    rows = local_rows(sel, state.axis)
    if isinstance(state, SparseGraphState):
        keep = closed_neighborhood_keep(state.neighbors, state.valid, sel,
                                        rows)
    else:
        keep = closed_neighborhood_keep_dense(state.adj, sel, rows)
    return gather_rows(keep, state.axis)


def mis_commit(state, sel: torch.Tensor, *, in_place: bool = True):
    """Closed-neighbourhood commit (MIS): S gains ``sel``; ``sel`` and its
    neighbours leave the candidates (and the dense adjacency: in place,
    as ``DenseRep.commit``, unless ``in_place`` is False; on a tile its
    rows by the rank's rows of the keep, its columns by the whole keep);
    done when no eligible node remains."""
    solution = torch.maximum(state.solution, sel)
    keep = _closed_keep(state, sel)
    candidate = state.candidate * keep
    new = dataclasses.replace(state, candidate=candidate, solution=solution)
    if isinstance(state, GraphState):
        rows = local_rows(keep, state.axis)
        if in_place:
            state.adj.mul_(rows[:, :, None])
            state.adj.mul_(keep[:, None, :])
        else:
            new.adj = state.adj * rows[:, :, None] * keep[:, None, :]
    return new, candidate.sum(-1) == 0


def _pick_keep(state, idx: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
    """Keep factors of removing the one-hot pick ``idx`` (where ``has``)
    and its neighbours.  Dense reads the pick's adjacency column, which
    is the matvec of ``closed_neighborhood_keep_dense`` with a one-hot
    vector, bit for bit, without its (B, N, N) pass; on a tile, the
    column's rows the rank holds, gathered over the graph axis."""
    pick = _onehot(idx, state.candidate.shape[1]) * has[:, None]
    if not isinstance(state, GraphState):
        return _closed_keep(state, pick)
    col = gather_rows(state.adj[_rows(state), :, idx] * has[:, None],
                      state.axis)
    return (1.0 - pick) * (1.0 - (col > 0).to(torch.float32))


def mis_prune(state, sel: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Thin a raw top-d selection to an independent subset: keep selected
    nodes in descending score order (argmax ties at the lowest index),
    dropping any selected node adjacent to one already kept.  A fixed
    ``_MAX_COMMIT`` masked argmaxes, on the device, with no host read."""
    kept, active = torch.zeros_like(sel), sel
    for _ in range(_MAX_COMMIT):
        idx = torch.argmax(torch.where(active > 0.5, scores,
                                       torch.full_like(scores, NEG_INF)),
                           dim=-1)
        has = (active.sum(-1) > 0).to(torch.float32)
        kept = torch.maximum(kept, _onehot(idx, sel.shape[1])
                             * has[:, None])
        active = active * _pick_keep(state, idx, has)
    return kept


@register("mis", residual="closed", commit=mis_commit, prune=mis_prune,
          checker=lambda adj0, sol: is_independent_set(adj0, sol),
          sense="max")
def mis_step(state, action: torch.Tensor):
    """Maximum Independent Set step: adding v to S earns +1 and removes v
    and its neighbours from play; done when no eligible node remains.  A
    non-candidate action (a done row of a training batch) commits nothing
    and earns 0.  Functional: the dense adjacency is a new tensor."""
    sel = _onehot(action, state.candidate.shape[1]) * state.candidate
    new_state, done = mis_commit(state, sel, in_place=False)
    return new_state, sel.sum(-1), done


# ---------------------------------------------------------------------------
# MDS: residual "none"; the closed-neighbourhood cover derives from
# (topology, S).  Isolated nodes count as dominated: they are padding.
# ---------------------------------------------------------------------------

def _neighbour_sums(state, x: torch.Tensor, how: str = "sum"):
    """(B, Nl) per node of the state's topology rows (all N, or a tile's
    Nl), the ``how`` ("sum" or "max") of the whole 0/1 mask ``x`` over
    its original neighbours."""
    n = x.shape[1]
    x_pad = torch.nn.functional.pad(x, (0, 1))              # sentinel slot
    if isinstance(state, CsrGraphState):
        rid = csr_row_ids(state.indptr, state.num_edges)
        em = state.edge_mask.to(torch.float32)
        fn = csr_segment_sum if how == "sum" else csr_segment_max
        return fn(em * _gather_nodes(x_pad, state.indices), rid, n)
    if isinstance(state, SparseGraphState):
        v = state.valid.to(torch.float32) * _gather_nodes(x_pad,
                                                          state.neighbors)
        return v.sum(-1) if how == "sum" else v.amax(-1)
    s = torch.einsum("bnm,bm->bn", state.adj, x)
    return s if how == "sum" else (s > 0).to(torch.float32)


def _degrees(state) -> torch.Tensor:
    """(B, Nl) original degrees of the state's topology rows."""
    if isinstance(state, CsrGraphState):
        rid = csr_row_ids(state.indptr, state.num_edges)
        return csr_segment_sum(state.edge_mask.to(torch.float32), rid,
                               state.candidate.shape[1])
    if isinstance(state, SparseGraphState):
        return state.valid.to(torch.float32).sum(-1)
    return state.adj.sum(-1)


def mds_candidates(state, *, rows: bool = False) -> torch.Tensor:
    """MDS candidate rule: a node is actionable iff it is not in S and its
    closed neighbourhood still holds an undominated positive-degree node.
    A degree-0 node has no gain, so padding never enters.

    On a tile (``state.axis``: the topology's rows are the rank's, the
    solution whole) each rank tests its own rows: the undominated mask
    is all-gathered for the gains, and the candidates too, unless
    ``rows`` asks for the rank's (B, Nl) rows only (the train tile's)."""
    axis = _axis(state)
    sol = state.solution
    sol_l = local_rows(sol, axis)
    covered = torch.maximum(sol_l, _neighbour_sums(state, sol, "max"))
    uncov_l = ((_degrees(state) > 0) & (covered < 0.5)).to(torch.float32)
    gain = uncov_l + _neighbour_sums(state, gather_rows(uncov_l, axis))
    cand = ((sol_l < 0.5) & (gain > 0)).to(torch.float32)
    return cand if rows else gather_rows(cand, axis)


def cover_commit(state, sel: torch.Tensor):
    """Closed-neighbourhood-cover commit (MDS): S gains ``sel``; the
    candidates re-derive from the coverage; done when every
    positive-degree node is dominated (no candidate has a gain)."""
    new = dataclasses.replace(state,
                              solution=torch.maximum(state.solution, sel))
    candidate = mds_candidates(new)
    return (dataclasses.replace(new, candidate=candidate),
            candidate.sum(-1) == 0)


@register("mds", residual=False, commit=cover_commit,
          candidates=mds_candidates,
          checker=lambda adj0, sol: is_dominating_set(adj0, sol),
          sense="min")
def mds_step(state, action: torch.Tensor):
    """Minimum Dominating Set step: adding v to S dominates v's closed
    neighbourhood; reward -1 per selected node; done when every
    positive-degree node is dominated.  A non-candidate action commits
    nothing and earns 0."""
    sel = _onehot(action, state.candidate.shape[1]) * state.candidate
    new_state, done = cover_commit(state, sel)
    return new_state, -sel.sum(-1), done


# ---------------------------------------------------------------------------
# Checkers and objectives on the original dense adjacency (B, N, N).  Each
# sum is of 0/1 products, exact in f32 below 2^24 terms.
# ---------------------------------------------------------------------------

def reset(adj, *, device: DeviceLike = "cuda") -> GraphState:
    """A fresh dense episode state of ``adj`` on ``device``."""
    return init_state(adj, device=device)


def solution_size(state) -> torch.Tensor:
    """(B,) |S| of a state."""
    return state.solution.sum(-1)


def is_cover(adj0: torch.Tensor, solution: torch.Tensor) -> torch.Tensor:
    """The MVC invariant: every original edge touches a solution node."""
    keep = 1.0 - solution
    uncovered = adj0 * keep[..., :, None] * keep[..., None, :]
    return uncovered.sum((-1, -2)) == 0


def is_cover_sparse(neighbors: torch.Tensor, valid: torch.Tensor,
                    solution: torch.Tensor) -> torch.Tensor:
    """The MVC invariant on the sparse representation: no residual edge
    survives S."""
    return residual_edge_mask(neighbors, valid, solution).sum((-1, -2)) == 0


def _matvec(adj0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...nm,...m->...n", adj0, x)


def is_independent_set(adj0: torch.Tensor,
                       solution: torch.Tensor) -> torch.Tensor:
    """The MIS invariant: no original edge has both endpoints in S."""
    return (solution * _matvec(adj0, solution)).sum(-1) == 0


def is_dominating_set(adj0: torch.Tensor,
                      solution: torch.Tensor) -> torch.Tensor:
    """The MDS invariant under the padding convention: every
    positive-degree node is in S or adjacent to a node of S."""
    covered = torch.maximum(
        solution, (_matvec(adj0, solution) > 0).to(solution.dtype))
    return ((adj0.sum(-1) > 0) & (covered < 0.5)).sum(-1) == 0


def cut_value(adj0: torch.Tensor, solution: torch.Tensor) -> torch.Tensor:
    """MaxCut objective: the original edges with exactly one endpoint in
    S (each counted once, from its S side)."""
    return (solution * _matvec(adj0, 1.0 - solution)).sum(-1)
