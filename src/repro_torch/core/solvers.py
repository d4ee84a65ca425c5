"""Classical baselines the paper compares against, for the whole problem
suite (MVC, MaxCut, MIS, MDS): a numpy copy of ``repro/core/solvers.py``,
so the port's quality ratios use the same references.

The paper uses IBM-CPLEX (0.5 h cutoff) for MVC reference optima; offline
we provide: exact branch-and-bound (small N), greedy max-degree heuristic,
the maximal-matching 2-approximation, and a matching lower bound used when
exact search is infeasible (DESIGN.md §7 notes the deviation).  For the
extension environments, the matching batched greedy heuristics: min-degree
greedy MIS, greedy set-cover MDS, and positive-gain greedy MaxCut — all
following the padding convention (isolated nodes are not problem nodes:
never picked, never requiring domination; DESIGN.md §11).
"""
from __future__ import annotations

import numpy as np


def greedy_mvc(adj: np.ndarray) -> np.ndarray:
    """Max-degree greedy heuristic. adj: (N, N). Returns solution mask."""
    return greedy_mvc_batch(adj[None])[0]


def greedy_mvc_batch(adj_batch: np.ndarray) -> np.ndarray:
    """Batched max-degree greedy heuristic: (B, N, N) → (B, N) masks.

    One vectorized argmax/row-zeroing step per round serves the WHOLE
    batch; rounds run until every graph is edge-free (max cover size over
    B rounds instead of a Python loop per graph).  Per graph this picks the
    exact same node sequence as the sequential heuristic (np.argmax
    first-max tie-breaking on each row), so results are bit-identical to
    mapping :func:`greedy_mvc` over the batch.
    """
    a = np.asarray(adj_batch, np.float32).copy()
    b, n, _ = a.shape
    sol = np.zeros((b, n), bool)
    active = a.reshape(b, -1).sum(-1) > 0
    while active.any():
        deg = a.sum(-1)                       # (B, N)
        v = deg.argmax(-1)                    # (B,) first max per graph
        act = np.flatnonzero(active)
        sol[act, v[act]] = True
        a[act, v[act], :] = 0
        a[act, :, v[act]] = 0
        active = a.reshape(b, -1).sum(-1) > 0
    return sol


def matching_2approx(adj: np.ndarray, seed: int = 0) -> np.ndarray:
    """Maximal-matching 2-approximation: add both endpoints of a maximal
    matching."""
    return matching_2approx_batch(adj[None], seed)[0]


def matching_2approx_batch(adj_batch: np.ndarray,
                           seed: int = 0) -> np.ndarray:
    """Batched maximal-matching 2-approximation: (B, N, N) → (B, N) masks.

    Each graph greedily scans its own shuffled edge list; processing a
    fixed order greedily is the same as repeatedly taking the first
    available edge, so the scan becomes rounds of one vectorized
    min-priority reduction over a padded (B, E) edge table — bit-identical
    per graph to the sequential version (same per-graph rng stream).
    Rounds run until every matching is maximal (≤ N/2 of them).
    """
    adj_batch = np.asarray(adj_batch)
    b, n, _ = adj_batch.shape
    # per-graph shuffled edge lists, padded to the batch's max edge count
    edges = []
    for a in adj_batch:
        e = np.argwhere(np.triu(a.astype(bool), 1))
        np.random.default_rng(seed).shuffle(e)
        edges.append(e)
    emax = max((len(e) for e in edges), default=0)
    sol = np.zeros((b, n), bool)
    if emax == 0:
        return sol
    eu = np.zeros((b, emax), np.int64)
    ev = np.zeros((b, emax), np.int64)
    alive = np.zeros((b, emax), bool)         # edge not yet blocked
    for i, e in enumerate(edges):
        eu[i, :len(e)], ev[i, :len(e)] = e[:, 0], e[:, 1]
        alive[i, :len(e)] = True
    prio = np.broadcast_to(np.arange(emax), (b, emax))
    while True:
        used = sol                             # endpoints already matched
        free = alive & ~np.take_along_axis(used, eu, 1) \
                     & ~np.take_along_axis(used, ev, 1)
        any_free = free.any(-1)
        if not any_free.any():
            return sol
        first = np.where(free, prio, emax).argmin(-1)   # (B,)
        act = np.flatnonzero(any_free)
        sol[act, eu[act, first[act]]] = True
        sol[act, ev[act, first[act]]] = True
        alive[act, first[act]] = False


def greedy_mis(adj: np.ndarray) -> np.ndarray:
    """Min-degree greedy maximum independent set. adj: (N, N) → (N,) mask."""
    return greedy_mis_batch(adj[None])[0]


def greedy_mis_batch(adj_batch: np.ndarray) -> np.ndarray:
    """Batched min-degree greedy MIS: (B, N, N) → (B, N) masks.

    Each round picks, per graph, the eligible node of minimum residual
    degree (first-min tie-breaking), adds it to S and removes it plus its
    neighbors.  Eligible nodes are the surviving ORIGINALLY-positive-degree
    nodes — nodes isolated by earlier removals are free picks, but
    originally-isolated padding nodes never enter (the serving
    convention)."""
    a = np.asarray(adj_batch, np.float32).copy()
    b, n, _ = a.shape
    sol = np.zeros((b, n), bool)
    alive = a.sum(-1) > 0                     # (B, N) eligible pool
    while alive.any():
        deg = a.sum(-1)
        key = np.where(alive, deg, np.inf)
        v = key.argmin(-1)                    # (B,) first min per graph
        act = np.flatnonzero(alive.any(-1))
        sol[act, v[act]] = True
        # drop the pick and its current neighbors from play
        removed = a[act, v[act], :] > 0
        removed[np.arange(len(act)), v[act]] = True
        alive[act] &= ~removed
        keep = (~removed).astype(np.float32)
        a[act] *= keep[:, None, :] * keep[:, :, None]
    return sol


def greedy_mds(adj: np.ndarray) -> np.ndarray:
    """Greedy set-cover minimum dominating set. adj: (N, N) → (N,) mask."""
    return greedy_mds_batch(adj[None])[0]


def greedy_mds_batch(adj_batch: np.ndarray) -> np.ndarray:
    """Batched greedy set-cover MDS: (B, N, N) → (B, N) masks.

    Each round picks, per graph, the node whose closed neighborhood covers
    the most still-undominated positive-degree nodes (first-max
    tie-breaking).  Isolated nodes count as already dominated (padding
    convention), so they are neither picked nor waited on."""
    a = np.asarray(adj_batch, np.float32)
    b, n, _ = a.shape
    sol = np.zeros((b, n), bool)
    need = a.sum(-1) > 0
    covered = ~need                           # isolated: born satisfied
    while True:
        uncov = (need & ~covered).astype(np.float32)
        active = uncov.any(-1)
        if not active.any():
            return sol
        gain = uncov + np.einsum("bnm,bm->bn", a, uncov)
        gain[sol] = -1.0                      # never re-pick
        v = gain.argmax(-1)
        act = np.flatnonzero(active)
        sol[act, v[act]] = True
        newly = a[act, v[act], :] > 0
        newly[np.arange(len(act)), v[act]] = True
        covered[act] |= newly


def greedy_maxcut(adj: np.ndarray) -> np.ndarray:
    """Positive-gain greedy cut. adj: (N, N) → (N,) side-assignment mask."""
    return greedy_maxcut_batch(adj[None])[0]


def greedy_maxcut_batch(adj_batch: np.ndarray) -> np.ndarray:
    """Batched greedy MaxCut: (B, N, N) → (B, N) side masks.

    Starting from S = ∅, each round moves the node with the largest
    positive gain (edges to V\\S minus edges to S = deg − 2·deg_to_S) into
    S; stops when no move improves the cut.  Evaluate with
    ``repro_torch.core.env.cut_value``."""
    a = np.asarray(adj_batch, np.float32)
    b, n, _ = a.shape
    side = np.zeros((b, n), bool)
    deg = a.sum(-1)
    while True:
        to_s = np.einsum("bnm,bm->bn", a, side.astype(np.float32))
        gain = np.where(side, -np.inf, deg - 2.0 * to_s)
        active = (gain > 0).any(-1)
        if not active.any():
            return side
        v = gain.argmax(-1)
        act = np.flatnonzero(active)
        side[act, v[act]] = True


def heuristic_batch(problem: str, adj_batch: np.ndarray) -> np.ndarray:
    """The matching per-env greedy baseline (problem_suite quality evals):
    max-degree greedy cover (mvc), min-degree greedy independent set
    (mis), greedy set-cover domination (mds), positive-gain greedy cut
    (maxcut).  (B, N, N) → (B, N) masks."""
    table = {"mvc": greedy_mvc_batch, "mis": greedy_mis_batch,
             "mds": greedy_mds_batch, "maxcut": greedy_maxcut_batch}
    try:
        fn = table[problem]
    except KeyError:
        raise ValueError(f"no heuristic baseline registered for "
                         f"{problem!r}; available: {sorted(table)}") from None
    return fn(adj_batch)


def mvc_lower_bound(adj: np.ndarray, seed: int = 0) -> int:
    """|maximal matching| is a lower bound on |MVC|."""
    sol = matching_2approx(adj, seed)
    return int(sol.sum()) // 2


def mvc_lower_bounds(adj_batch: np.ndarray, seed: int = 0) -> np.ndarray:
    """Batched matching lower bounds: (B, N, N) → (B,) |matching| values."""
    return matching_2approx_batch(adj_batch, seed).sum(-1) // 2


def exact_mvc_size(adj: np.ndarray, node_budget: int = 2_000_000) -> int:
    """Exact MVC via branch-and-bound on an uncovered edge (u, v): any cover
    contains u or v.  Practical for N ≲ 60 on sparse/small graphs.
    Raises RuntimeError if the search exceeds ``node_budget`` B&B nodes.
    """
    n = adj.shape[0]
    nbr = [frozenset(np.nonzero(adj[v])[0].tolist()) for v in range(n)]
    best = [int(greedy_mvc(adj).sum())]
    budget = [node_budget]

    def edges_exist(removed: frozenset) -> tuple:
        for u in range(n):
            if u in removed:
                continue
            for v in nbr[u]:
                if v not in removed and v > u:
                    return (u, v)
        return None

    def bb(removed: frozenset, count: int):
        if budget[0] <= 0:
            raise RuntimeError("exact_mvc_size: node budget exceeded")
        budget[0] -= 1
        if count >= best[0]:
            return
        e = edges_exist(removed)
        if e is None:
            best[0] = count
            return
        u, v = e
        # branch: u in cover, or (u not in cover => all nbrs of u in cover)
        bb(removed | {u}, count + 1)
        u_nbrs = {w for w in nbr[u] if w not in removed}
        if count + len(u_nbrs) < best[0]:
            bb(removed | u_nbrs, count + len(u_nbrs))

    bb(frozenset(), 0)
    return best[0]


def reference_sizes(adj_batch: np.ndarray, exact_limit: int = 40
                    ) -> np.ndarray:
    """Reference |MVC| per graph: exact B&B when N ≤ exact_limit, else the
    matching lower bound (ratios vs LB upper-bound the true ratio).

    The B&B is inherently per-graph; every graph that falls through to the
    heuristic bound is served by ONE batched matching pass
    (:func:`mvc_lower_bounds`) instead of a per-graph Python loop.
    Heterogeneous node counts are fine: the LB batch zero-pads to the
    largest graph, which adds no edges and so changes no matching."""
    graphs = [np.asarray(a) for a in adj_batch]
    out = np.zeros(len(graphs), np.int64)
    need_lb = []
    for i, a in enumerate(graphs):
        if a.shape[0] <= exact_limit:
            try:
                out[i] = exact_mvc_size(a)
                continue
            except RuntimeError:
                pass
        need_lb.append(i)
    if need_lb:
        nmax = max(graphs[i].shape[0] for i in need_lb)
        stack = np.zeros((len(need_lb), nmax, nmax), np.float32)
        for row, i in enumerate(need_lb):
            n = graphs[i].shape[0]
            stack[row, :n, :n] = graphs[i]
        out[need_lb] = np.maximum(mvc_lower_bounds(stack), 1)
    return out
