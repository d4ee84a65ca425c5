"""Graph-representation backends (DESIGN.md §1).  Counterpart of
``repro/core/graphrep.py``; this slice ports the dense backend only."""
from __future__ import annotations

from typing import Union

import torch

from ..device import DeviceLike, resolve_device
from .graphs import GraphState, init_state
from .policy import Policy, policy_scores


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
            return GraphState(*(t.to(device=dev, copy=True) for t in
                                (adj.adj, adj.candidate, adj.solution)))
        return init_state(adj, device=device)

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
        caller's adjacency or state).  Returns (state, done)."""
        solution = torch.maximum(state.solution, sel)
        keep = 1.0 - sel
        adj = state.adj
        adj.mul_(keep[:, :, None])
        adj.mul_(keep[:, None, :])
        deg = adj.sum(-1)
        candidate = ((deg > 0) & (solution < 0.5)).to(torch.float32)
        # adjacency weights are non-negative, so the residual edge set is
        # empty exactly when every degree is zero (JAX sums all of adj)
        done = (deg == 0).all(-1)
        return GraphState(adj=adj, candidate=candidate,
                          solution=solution), done

    def state_bytes(self, state: GraphState) -> int:
        return int(state.adj.numel() * state.adj.element_size()
                   + state.candidate.numel() * 4 + state.solution.numel() * 4)


DENSE = DenseRep()

_LATER = {"sparse": "ROADMAP item A7 (sparse rep)",
          "csr": "ROADMAP item A8 (CSR rep)"}


def get_rep(rep: Union[str, GraphRep, None]) -> GraphRep:
    """Resolve a representation name/instance to a backend."""
    if rep is None:
        return DENSE
    if isinstance(rep, GraphRep):
        return rep
    if rep == "dense":
        return DENSE
    if rep in _LATER:
        raise NotImplementedError(
            f"graph_rep={rep!r} is not ported yet: {_LATER[rep]}")
    raise ValueError(f"unknown graph representation {rep!r}; "
                     f"available: ['csr', 'dense', 'sparse']")
