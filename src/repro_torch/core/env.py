"""Graph learning environments (paper §3): the registry, the MVC step and
the padding-safety contract.  Counterpart of ``repro/core/env.py``; this
slice registers ``mvc`` on the dense, sparse and CSR representations.

Each registration declares its residual mode (what topology the policy
sees), its Alg. 4 commit/termination rule, an optional candidate rule and
selection prune, a feasibility checker and its sense (DESIGN.md §11).  The
serving layer pads graphs with isolated nodes, so an environment is only
servable if its candidate derivation can never admit a degree-0 node:
``ensure_padding_safe`` probes that on all three representations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .graphs import (GraphState, csr_batch_from_dense, csr_init_state,
                     csr_residual_edge_mask, csr_row_ids, csr_segment_sum,
                     residual_adjacency, residual_edge_mask,
                     sparse_batch_from_dense, sparse_init_state)
from .mesh import gather_rows, local_rows

EnvStep = Callable[[GraphState, torch.Tensor],
                   Tuple[GraphState, torch.Tensor, torch.Tensor]]
CommitFn = Callable[[GraphState, torch.Tensor], Tuple[GraphState, torch.Tensor]]
CandidateFn = Callable[[GraphState], torch.Tensor]
PruneFn = Callable[[GraphState, torch.Tensor, torch.Tensor], torch.Tensor]

RESIDUAL_MODES = ("solution", "none", "closed")
# The JAX package's other problems, ported by a later slice.
_LATER_PROBLEMS = ("maxcut", "mis", "mds")

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


def always_feasible(adj0: torch.Tensor, solution: torch.Tensor) -> torch.Tensor:
    return torch.ones(solution.shape[:-1], dtype=torch.bool,
                      device=solution.device)


def residual_commit(state, sel: torch.Tensor):
    """Covering-problem commit (Alg. 4 lines 7-9, "solution" mode):
    committing a node removes its incident edges; done when no edge
    survives.  Delegates to the state's backend (dense updates ``adj`` in
    place, see ``DenseRep.commit``; sparse and CSR derive new masks)."""
    from .graphrep import rep_for_state
    return rep_for_state(state).commit(state, sel)


def register(name: str, residual: Union[bool, str] = True,
             commit: Optional[CommitFn] = None,
             candidates: Optional[CandidateFn] = None,
             prune: Optional[PruneFn] = None,
             checker: Optional[Callable] = None,
             sense: str = "min"):
    """Register an environment step (the DESIGN.md §11 extension point).
    ``commit`` defaults to :func:`residual_commit`; the assignment commit
    of ``residual=False`` problems comes with the MaxCut slice."""
    mode = normalize_residual_mode(residual)
    if sense not in ("min", "max"):
        raise ValueError(f"sense must be 'min' or 'max', got {sense!r}")
    if commit is None and mode == "none":
        raise NotImplementedError(
            "the assignment commit of residual=False problems is not ported "
            "yet: ROADMAP item \"the other three problems\"; pass commit= "
            "explicitly")

    def deco(fn):
        _REGISTRY[name] = fn
        _MODE[name] = mode
        _COMMIT[name] = commit or residual_commit
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
        if name in _LATER_PROBLEMS:
            raise NotImplementedError(
                f"problem {name!r} is not ported yet: ROADMAP item \"the "
                f"other three problems\"") from None
        raise ValueError(f"unknown environment {name!r}; registered: "
                         f"{names()}") from None


def make(name: str) -> EnvStep:
    return _lookup(_REGISTRY, name)


def residual_mode(name: str) -> str:
    return _lookup(_MODE, name)


def sparse_residual_flag(name: str) -> Union[bool, str]:
    """The ``residual`` value a sparse or CSR state carries for this env:
    True ("solution"), False ("none"), or the mode string."""
    mode = residual_mode(name)
    return {"solution": True, "none": False}.get(mode, mode)


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

def _probe_states(adj: np.ndarray, sol: torch.Tensor, mode: str,
                  cand_fn: Optional[CandidateFn]):
    """The dense, sparse and CSR states a partial solution re-materializes
    to under ``mode`` (Tuples2Graphs), with the env's candidate rule
    applied: the path a replay tuple takes, built directly until the
    training slice ports ``state_from_tuples``."""
    if mode == "closed":
        raise NotImplementedError(
            "closed-neighbourhood residuals (MIS) are not ported yet: "
            "ROADMAP item \"the other three problems\"")
    residual = mode == "solution"
    adj0 = torch.from_numpy(adj)
    dense = residual_adjacency(adj0, sol) if residual else adj0
    sp = sparse_init_state(sparse_batch_from_dense(adj, device="cpu"))
    sp_edge = (residual_edge_mask(sp.neighbors, sp.valid, sol) if residual
               else sp.valid.to(torch.float32))
    cs = csr_init_state(csr_batch_from_dense(adj, device="cpu"))
    rid = csr_row_ids(cs.indptr, cs.num_edges)
    cs_edge = (csr_residual_edge_mask(cs.indices, cs.edge_mask, rid, sol)
               if residual else cs.edge_mask.to(torch.float32))
    states = []
    for st, deg in ((GraphState(adj=dense, candidate=sol, solution=sol),
                     dense.sum(-1)),
                    (dataclasses.replace(sp, solution=sol, residual=residual),
                     sp_edge.sum(-1)),
                    (dataclasses.replace(cs, solution=sol, residual=residual),
                     csr_segment_sum(cs_edge, rid, cs.num_nodes))):
        st = dataclasses.replace(
            st, candidate=((deg > 0) & (sol < 0.5)).to(torch.float32))
        if cand_fn is not None:
            st = dataclasses.replace(st, candidate=cand_fn(st))
        states.append(st)
    return states


def _probe_padding_safety(name: str) -> bool:
    """Drive the env's candidate derivation and one env step on a graph
    with isolated padding-style nodes (0-1 share the only edge; 2 and 3
    are isolated), on the dense, sparse and CSR representations, and
    report whether a degree-0 node ever becomes a candidate."""
    adj = np.zeros((1, 4, 4), np.float32)
    adj[0, 0, 1] = adj[0, 1, 0] = 1.0
    mode, cand_fn = _MODE[name], _CANDIDATES[name]
    for sol in ([0, 0, 0, 0], [1, 0, 0, 0], [1, 1, 0, 0]):
        for st in _probe_states(adj, torch.tensor([sol], dtype=torch.float32),
                                mode, cand_fn):
            if st.candidate[0, 2:].any():
                return False
    for st in _probe_states(adj, torch.zeros((1, 4)), mode, cand_fn):
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
            f"nodes are excluded, or register a custom `candidates` rule "
            f"that masks them (DESIGN.md §11).")


# ---------------------------------------------------------------------------
# MVC.
# ---------------------------------------------------------------------------

def _onehot(v: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(v.long(), n).to(torch.float32)


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
