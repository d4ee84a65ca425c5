"""Parallel RL inference (paper Alg. 4) with adaptive multiple-node
selection (paper §4.5.1).  Counterpart of ``repro/core/inference.py``.

``solve`` drives a batch of B graphs to complete solutions with a trained
policy.  Each iteration is one policy evaluation; with the adaptive
schedule, up to d ∈ {max_d, max_d/2, max_d/4, max_d/8} top-scoring
candidates are committed per evaluation, d shrinking with the candidate
set (``max_d`` defaults to the paper's 8; paper-scale solves raise it so a
solve stays tens of evaluations):

    |C| >  N/2        -> d = max_d
    |C| in (N/4, N/2] -> d = max_d/2
    |C| in (N/8, N/4] -> d = max_d/4
    |C| <= N/8        -> d = max_d/8  (each tier floored at 1)

Both engines run it on the dense, sparse and CSR representations
(``rep=``), for every registered problem, through one loop
(``core.engine.get_solve_step``): one policy evaluation, then a blocking
read of ``done``.  ``engine="device"`` (default) runs it on one device or
on a ``spatial=(dp, sp)`` mesh of ``torch.distributed`` ranks
(``core.mesh``; CSR at sp = 1).  ``engine="host"``, JAX's per-evaluation
reference loop, is that loop on one device: the JAX package's fused
engine reads nothing until the end, the port's already reads once an
evaluation.  A ``step_fn(params, state) -> (state, done, ncommit)`` given
to ``solve`` replaces the loop's step (default :func:`solve_step`),
whatever the engine, as in the JAX package.

MaxCut's quality lives in its trajectory, not its final assignment:
:func:`best_trajectory_cut`, a ``step_fn`` over that loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import env as env_lib
from .graphrep import GraphRep, get_rep
from .graphs import CsrGraphState, SparseGraphState
from .mesh import (Mesh, all_gather_tiled, is_multi, make_mesh,
                   normalize_spatial, shard_batch, shard_nodes)
from .policy import Policy, PolicyConfig
from .qmodel import NEG_INF
from .spatial import _check_divisible

MAX_D = 8


def adaptive_d(num_candidates: torch.Tensor, n: int,
               max_d: int = MAX_D) -> torch.Tensor:
    """Per-graph d from the paper's schedule (exactly 8/4/2/1 at the
    default ``max_d=8``).  num_candidates: (B,) float."""
    c = num_candidates
    tier = lambda v: torch.full_like(c, v, dtype=torch.int32)  # noqa: E731
    return torch.where(c > n / 2, tier(max_d),
           torch.where(c > n / 4, tier(max(max_d // 2, 1)),
           torch.where(c > n / 8, tier(max(max_d // 4, 1)),
                       tier(max(max_d // 8, 1)))))


def select_top_d(scores: torch.Tensor, candidate: torch.Tensor,
                 use_adaptive: bool,
                 max_d: int = MAX_D) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 4 lines 5-7: top-d selection mask from masked scores.

    Returns ``(sel, ncommit)``: the (B, N) commit mask and the (B,)
    per-graph commit count.  Finished graphs (all scores NEG_INF) select
    nothing.  Ties go to the lowest index, as ``lax.top_k`` breaks them:
    ``torch.topk`` does not promise that order, a stable descending sort
    does.  Ties are common here (symmetric graphs, isolated padding
    nodes, the whole NEG_INF block of masked scores)."""
    b, n = candidate.shape
    k = min(max_d, n)
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    ncand = candidate.sum(-1)
    d = (adaptive_d(ncand, n, max_d) if use_adaptive
         else torch.ones((b,), dtype=torch.int32, device=scores.device))
    rank = torch.arange(k, device=scores.device)[None, :]
    valid = (rank < d[:, None]) & (top_scores > NEG_INF / 2)
    sel = torch.zeros((b, n), dtype=torch.float32, device=scores.device)
    sel.scatter_(1, top_idx, valid.to(torch.float32))
    return sel, valid.sum(-1, dtype=torch.int32)


def apply_selection(state, scores, candidate, use_adaptive: bool,
                    problem: str, max_d: int = MAX_D):
    """Alg. 4 lines 5-9: top-d selection, the env's optional prune and
    its commit/termination rule.  Returns (state, done, ncommit)."""
    sel, ncommit = select_top_d(scores, candidate, use_adaptive, max_d)
    prune = env_lib.prune_rule(problem)
    if prune is not None:
        sel = prune(state, sel, scores)
        ncommit = sel.sum(-1).to(torch.int32)
    new_state, done = env_lib.commit_rule(problem)(state, sel)
    return new_state, done, ncommit


def init_solve_state(rep: GraphRep, adj, problem: str = "mvc", *,
                     device: DeviceLike = "cuda", mesh: Optional[Mesh] = None):
    """Fresh solve state in ``rep``'s layout on ``device``, carrying the
    env's residual mode (sparse and CSR states) and its candidate rule.
    Enforces the padding-safety contract first
    (``env.ensure_padding_safe``).

    With ``mesh``, ``adj`` is the whole batch and the state is this rank's
    tile (``mesh.shard_state``): its data rank's B/dp graphs are built on
    the host, and only the graph rank's N/sp topology rows reach
    ``device``, so no rank holds a whole dense adjacency there."""
    env_lib.ensure_padding_safe(problem)
    if mesh is not None:
        state = rep.init_state(_batch_rows(mesh, adj), device="cpu")
    else:
        state = rep.init_state(adj, device=device)
    if isinstance(state, (SparseGraphState, CsrGraphState)):
        flag = env_lib.sparse_residual_flag(problem)
        if state.residual != flag:
            state = dataclasses.replace(state, residual=flag)
    cand_fn = env_lib.candidate_rule(problem)
    if cand_fn is not None:
        state = dataclasses.replace(state, candidate=cand_fn(state))
    if mesh is not None:
        state = shard_nodes(mesh, state)
        dev = resolve_device(device)
        state = dataclasses.replace(state, **{
            f.name: getattr(state, f.name).to(dev).contiguous()
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)})
    return state


def _batch_rows(mesh: Mesh, adj):
    """This data rank's graphs of a whole batch: a batch or state
    dataclass, or an (N, N) / (B, N, N) array (numpy, memory-mapped or
    torch; sliced without a copy)."""
    if dataclasses.is_dataclass(adj):
        return shard_batch(mesh, adj)
    if adj.ndim == 2:
        adj = adj[None]
    return adj[mesh.data.rows(adj.shape[0])]


def _batch_size(adj) -> int:
    if dataclasses.is_dataclass(adj):
        return adj.batch
    return 1 if np.ndim(adj) == 2 else int(adj.shape[0])


def _num_nodes(adj) -> int:
    return adj.num_nodes if dataclasses.is_dataclass(adj) else adj.shape[-1]


@dataclasses.dataclass
class InferenceResult:
    solution: np.ndarray       # (B, N) masks
    sizes: np.ndarray          # (B,) |S|
    policy_evals: int          # number of policy-model evaluations
    nodes_committed: np.ndarray


def check_solve_options(engine: str, spatial, step_fn=None) -> None:
    """Raise on solve options the port refuses: an unknown engine or mesh
    spec, and a mesh with ``engine="host"`` or a ``step_fn``."""
    if engine not in ("host", "device"):
        raise ValueError(f"unknown inference engine {engine!r}")
    if is_multi(spatial) and (engine == "host" or step_fn is not None):
        raise ValueError("spatial solve runs on the fused path only; it is "
                         "incompatible with engine='host' and with step_fn "
                         "overrides")
    normalize_spatial(spatial)


def solve_step(*, rep: GraphRep, problem: str = "mvc", num_layers: int = 2,
               use_adaptive: bool = False, kernel: str = "fused",
               compute: str = "f32", max_d: int = MAX_D,
               score_fn: Optional[Callable] = None):
    """One evaluation of the solve loop, ``step(params, state) -> (state,
    done, ncommit)``: ``score_fn(params, state)`` (default ``rep.scores``,
    the rep's layer kernel once at L = 2) and :func:`apply_selection`.
    The loop runs it under ``torch.no_grad()``."""
    rep = get_rep(rep)
    score_fn = score_fn or (lambda params, state: rep.scores(
        params, state, num_layers=num_layers, kernel=kernel,
        compute=compute))

    def step(params, state):
        return apply_selection(state, score_fn(params, state),
                               state.candidate, use_adaptive, problem, max_d)

    return step


def solve(params: Policy, adj0, *, num_layers: int = 2,
          multi_node: bool = False, max_evals: Optional[int] = None,
          step_fn: Optional[Callable] = None,
          rep: Union[str, GraphRep] = "dense", problem: str = "mvc",
          engine: str = "device", spatial=0, kernel: str = "fused",
          compute: str = "f32", max_d: int = MAX_D,
          device: DeviceLike = "cuda") -> InferenceResult:
    """Run Alg. 4 on ``device`` until every graph in the batch has a
    complete solution.  ``adj0`` is an (N, N) or (B, N, N) adjacency
    (numpy or torch), or a batch or state of ``rep``'s layout (a
    ``CsrGraphBatch`` from ``csr_batch_from_arrays`` reaches graphs no
    dense array could hold); it is never modified.  ``params`` must live
    on ``device``.  ``max_evals`` defaults to N + max_d.  ``engine="host"``
    and ``step_fn`` (which replaces the loop's step) run on one device.

    ``spatial=(dp, sp)`` solves on the 2-D ``(data, graph)`` mesh (an int
    P means ``(1, P)``): every rank of a default process group of dp·sp
    ranks calls ``solve`` with the same whole batch, places its own tile
    (B/dp graphs, N/sp topology rows), and receives the whole result, as
    the JAX package's single controller does.  The env's candidate rule
    runs on the whole host state before the tiles are placed, and its
    rules on the tiles after (``core.env``)."""
    check_solve_options(engine, spatial, step_fn)
    env_lib.make(problem)
    dev = resolve_device(device)
    if params.device != dev:
        raise ValueError(f"the policy is on {params.device}, the solve on "
                         f"{dev}; move it with policy.to(...)")
    rep = get_rep(rep)
    dp, sp = normalize_spatial(spatial)
    if _batch_size(adj0) % dp:
        raise ValueError(f"batch {_batch_size(adj0)} not divisible by the "
                         f"data-axis size {dp} of mesh spec {spatial!r}")
    from .engine import get_solve_step
    fused = get_solve_step(rep=rep, problem=problem, num_layers=num_layers,
                           use_adaptive=multi_node, spatial=spatial,
                           kernel=kernel, compute=compute, max_d=max_d,
                           step=step_fn)
    mesh = None
    if (dp, sp) != (1, 1):
        mesh = make_mesh(dp, sp)
        _check_divisible(mesh, _batch_size(adj0), _num_nodes(adj0),
                         f"{rep.name} scores")
    state = init_solve_state(rep, adj0, problem, device=dev, mesh=mesh)
    n = state.num_nodes
    max_evals = max_evals or (n + max_d)
    out, evals, committed = fused(params, state, max_evals)
    sol, committed = gather_batch(mesh, out.solution, committed)
    return InferenceResult(solution=sol, sizes=sol.sum(-1).astype(np.int64),
                           policy_evals=int(evals),
                           nodes_committed=committed.astype(np.int64))


def gather_batch(mesh: Optional[Mesh], *tensors) -> Tuple[np.ndarray, ...]:
    """Host copies of per-graph tensors, on a mesh all-gathered over
    ``data`` first so that every rank holds the whole batch's rows."""
    if mesh is not None:
        tensors = [all_gather_tiled(t, mesh.data, 0) for t in tensors]
    return tuple(t.cpu().numpy() for t in tensors)


def best_trajectory_cut(params: Policy, adj0, *, num_layers: int = 2,
                        multi_node: bool = True,
                        device: DeviceLike = "cuda") -> np.ndarray:
    """(B,) best MaxCut value along the solve's commit trajectory.

    The maxcut env stops when no candidate remains: every positive-degree
    node ends in S, so the final cut is 0 and the quality lives in the
    trajectory.  A ``step_fn`` over the solve loop (the default step
    returns only the final state) keeps a running maximum of
    ``env.cut_value`` after every commit on the device, and the host reads
    it once, at the end."""
    dev = resolve_device(device)
    best = torch.zeros(_batch_size(adj0), dtype=torch.float32, device=dev)
    step = solve_step(rep=get_rep("dense"), problem="maxcut",
                      num_layers=num_layers, use_adaptive=multi_node)
    adj = None

    def recording_step(p, s):
        nonlocal adj
        if adj is None:     # the original topology: the commit masks s.adj
            adj = s.adj.clone()
        out = step(p, s)
        torch.maximum(best, env_lib.cut_value(adj, out[0].solution),
                      out=best)
        return out

    solve(params, adj0, num_layers=num_layers, problem="maxcut",
          step_fn=recording_step, device=dev)
    return best.cpu().numpy().astype(np.float64)


def solve_with_config(params: Policy, adj0, cfg: PolicyConfig, *,
                      multi_node: bool = False, problem: str = "mvc",
                      **kw) -> InferenceResult:
    """``solve`` with rep/engine/spatial/num_layers/kernel/compute taken
    from a :class:`PolicyConfig`."""
    return solve(params, adj0, num_layers=cfg.num_layers,
                 rep=cfg.graph_rep, engine=cfg.engine, spatial=cfg.spatial,
                 kernel=cfg.kernel, compute=cfg.compute,
                 multi_node=multi_node, problem=problem, **kw)
