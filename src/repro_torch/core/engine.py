"""The fused solve loop (paper Alg. 4).  Counterpart of
``repro/core/engine.py::get_solve_step``, whose body is one jitted
``lax.while_loop``; here it is a Python loop with the same stop rule, on
one device or on every rank of a ``(data, graph)`` mesh."""
from __future__ import annotations

import functools
from typing import Union

import torch

from . import env as env_lib
from .graphrep import GraphRep, get_rep
from .inference import apply_selection, check_solve_options
from .mesh import MeshSpec, all_reduce_max, make_mesh, normalize_spatial
from .spatial import spatial_solve_scores_fn


def _check_csr_spatial(rep: GraphRep, sp: int) -> None:
    """CSR has no spatial (graph-axis) sharding path: its flat edge arrays
    are row-ragged, so an N/sp node split gives unequal per-rank edge
    counts, unlike the dense row blocks and padded neighbour-list rows."""
    if rep.name == "csr" and sp > 1:
        raise ValueError(
            f"rep='csr' does not support spatial (graph-axis) sharding "
            f"sp={sp}: CSR rows are ragged, so node-partitioned blocks would "
            f"carry unequal edge counts. Use spatial=(dp, 1) for data "
            f"parallelism with csr, or rep='sparse'/'dense' for sp>1 graph "
            f"partitioning.")


def get_solve_step(*, rep: Union[str, GraphRep, None] = None,
                   problem: str = "mvc", num_layers: int = 2,
                   use_adaptive: bool = False, spatial: MeshSpec = 0,
                   kernel: str = "fused", compute: str = "f32",
                   max_d: int = 8):
    """Returns ``solve_fn(params, state, max_evals) -> (final_state,
    evals, committed)``: score → top-d commit → done check, repeated.

    The stop rule is the ``lax.while_loop``'s: evaluate while some graph
    is not done and ``evals < max_evals``; ``done`` starts all False, so
    the first evaluation always runs (for ``max_evals >= 1``).

    ``spatial`` selects the 2-D ``(data, graph)`` mesh (an int P means
    ``(1, P)``): every rank runs the loop on its state tile
    (``mesh.shard_state``), each evaluation partitioned sp ways over
    ``graph`` (``spatial.spatial_solve_scores_fn``; CSR, at sp = 1 only,
    scores its data rank's graphs on one device), and the stop rule's
    ``done`` read is reduced over the mesh, so every rank runs the same
    number of evaluations.  ``final_state`` and ``committed`` are the
    rank's own B/dp rows.

    ``solve_fn`` consumes ``state``: the dense commit updates its
    adjacency in place (the counterpart of the JAX solve donating its
    state).  Every caller builds the state fresh for the solve."""
    check_solve_options("device", spatial)
    rep = get_rep(rep)
    dp, sp = normalize_spatial(spatial)
    mesh = None
    if (dp, sp) != (1, 1):
        _check_csr_spatial(rep, sp)
        mesh = make_mesh(dp, sp)
    if mesh is not None and rep.name != "csr":
        score_fn = spatial_solve_scores_fn(
            mesh, num_layers=num_layers, rep=rep,
            residual=env_lib.sparse_residual_flag(problem), kernel=kernel,
            compute=compute)
    else:
        score_fn = functools.partial(rep.scores, num_layers=num_layers,
                                     kernel=kernel, compute=compute)

    @torch.no_grad()
    def solve_fn(params, state, max_evals: int):
        b = state.candidate.shape[0]
        evals = 0
        committed = torch.zeros((b,), dtype=torch.int32,
                                device=state.candidate.device)
        while evals < max_evals:
            scores = score_fn(params, state)
            state, done, ncommit = apply_selection(
                state, scores, state.candidate, use_adaptive, problem, max_d)
            evals += 1
            committed += ncommit
            # One host read of `done` per evaluation: it waits for the
            # device.  A CUDA graph, or checking every k evaluations, would
            # remove this round trip; that is later work.
            pending = (~done).any().to(torch.int32).reshape(1)
            if mesh is not None:
                # done is the same on every rank of a graph axis: the max
                # over `data` is the whole batch's, as JAX's ~done.all()
                all_reduce_max(pending, mesh.data)
            if not bool(pending):
                break
        return state, evals, committed

    return solve_fn
