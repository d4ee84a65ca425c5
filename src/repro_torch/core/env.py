"""Graph learning environments (paper §3): the registry, the MVC step and
the padding-safety contract.  Counterpart of ``repro/core/env.py``; this
slice registers ``mvc`` on the dense representation.

Each registration declares its residual mode (what topology the policy
sees), its Alg. 4 commit/termination rule, an optional candidate rule and
selection prune, a feasibility checker and its sense (DESIGN.md §11).  The
serving layer pads graphs with isolated nodes, so an environment is only
servable if its candidate derivation can never admit a degree-0 node:
``ensure_padding_safe`` probes that on the dense representation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .graphs import GraphState, residual_adjacency

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
    place, see ``DenseRep.commit``)."""
    from .graphrep import DENSE
    return DENSE.commit(state, sel)


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
            "yet: ROADMAP item A5; pass commit= explicitly")

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
                f"problem {name!r} is not ported yet: ROADMAP item A5 "
                f"(the other three problems)") from None
        raise ValueError(f"unknown environment {name!r}; registered: "
                         f"{names()}") from None


def make(name: str) -> EnvStep:
    return _lookup(_REGISTRY, name)


def residual_mode(name: str) -> str:
    return _lookup(_MODE, name)


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

def _probe_state(adj0: torch.Tensor, sol: torch.Tensor, mode: str,
                 cand_fn: Optional[CandidateFn]) -> GraphState:
    """The dense state a partial solution re-materializes to under
    ``mode`` (Tuples2Graphs), with the env's candidate rule applied."""
    if mode == "solution":
        adj = residual_adjacency(adj0, sol)
    elif mode == "none":
        adj = adj0
    else:
        raise NotImplementedError(
            "closed-neighbourhood residuals (MIS) are not ported yet: "
            "ROADMAP item A5")
    cand = ((adj.sum(-1) > 0) & (sol < 0.5)).to(torch.float32)
    state = GraphState(adj=adj, candidate=cand, solution=sol)
    if cand_fn is not None:
        state = dataclasses.replace(state, candidate=cand_fn(state))
    return state


def _probe_padding_safety(name: str) -> bool:
    """Drive the env's candidate derivation and one env step on a graph
    with isolated padding-style nodes (0-1 share the only edge; 2 and 3
    are isolated) and report whether a degree-0 node ever becomes a
    candidate.  Dense representation only in this slice."""
    adj = np.zeros((1, 4, 4), np.float32)
    adj[0, 0, 1] = adj[0, 1, 0] = 1.0
    adj0 = torch.from_numpy(adj)
    mode, cand_fn = _MODE[name], _CANDIDATES[name]
    for sol in ([0, 0, 0, 0], [1, 0, 0, 0], [1, 1, 0, 0]):
        st = _probe_state(adj0, torch.tensor([sol], dtype=torch.float32),
                          mode, cand_fn)
        if st.candidate[0, 2:].any():
            return False
    st = _probe_state(adj0, torch.zeros((1, 4)), mode, cand_fn)
    st, _, _ = _REGISTRY[name](st, torch.tensor([0]))
    return not bool(st.candidate[0, 2:].any())


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


@register("mvc", checker=lambda adj0, sol: is_cover(adj0, sol))
def mvc_step(state: GraphState, action: torch.Tensor):
    """Minimum Vertex Cover step (paper §4, Fig 3/4) on the dense state.

    action: (B,) node ids.  Adds the node to the partial solution and
    zeroes its row and column of the residual adjacency (a new tensor: the
    step is functional, unlike the solve's in-place commit).  Reward is -1
    per selected node; done when no edges remain."""
    b, n = state.candidate.shape
    oh = _onehot(action, n)
    solution = torch.maximum(state.solution, oh)
    keep = 1.0 - oh
    adj = state.adj * keep[:, :, None] * keep[:, None, :]
    deg = adj.sum(-1)
    candidate = ((deg > 0) & (solution < 0.5)).to(torch.float32)
    reward = -torch.ones((b,), dtype=torch.float32, device=adj.device)
    done = adj.sum((-1, -2)) == 0
    return GraphState(adj=adj, candidate=candidate,
                      solution=solution), reward, done


def is_cover(adj0: torch.Tensor, solution: torch.Tensor) -> torch.Tensor:
    """The MVC invariant: every original edge touches a solution node."""
    keep = 1.0 - solution
    uncovered = adj0 * keep[..., :, None] * keep[..., None, :]
    return uncovered.sum((-1, -2)) == 0
