"""The fused solve loop (paper Alg. 4).  Counterpart of
``repro/core/engine.py::get_solve_step``, whose body is one jitted
``lax.while_loop``; here it is a Python loop with the same stop rule."""
from __future__ import annotations

from typing import Union

import torch

from .graphrep import GraphRep, get_rep
from .inference import apply_selection, check_solve_options


def get_solve_step(*, rep: Union[str, GraphRep, None] = None,
                   problem: str = "mvc", num_layers: int = 2,
                   use_adaptive: bool = False, spatial=0,
                   kernel: str = "fused", compute: str = "f32",
                   max_d: int = 8):
    """Returns ``solve_fn(params, state, max_evals) -> (final_state,
    evals, committed)``: score → top-d commit → done check, repeated.

    The stop rule is the ``lax.while_loop``'s: evaluate while some graph
    is not done and ``evals < max_evals``; ``done`` starts all False, so
    the first evaluation always runs (for ``max_evals >= 1``).

    ``solve_fn`` consumes ``state``: the dense commit updates its
    adjacency in place (the counterpart of the JAX solve donating its
    state).  Every caller builds the state fresh for the solve."""
    check_solve_options("device", spatial)
    rep = get_rep(rep)

    @torch.no_grad()
    def solve_fn(params, state, max_evals: int):
        b = state.candidate.shape[0]
        evals = 0
        committed = torch.zeros((b,), dtype=torch.int32,
                                device=state.candidate.device)
        while evals < max_evals:
            scores = rep.scores(params, state, num_layers=num_layers,
                                kernel=kernel, compute=compute)
            state, done, ncommit = apply_selection(
                state, scores, state.candidate, use_adaptive, problem, max_d)
            evals += 1
            committed += ncommit
            # One host read of `done` per evaluation: it waits for the
            # device.  A CUDA graph, or checking every k evaluations, would
            # remove this round trip; that is later work.
            if bool(done.all()):
                break
        return state, evals, committed

    return solve_fn
