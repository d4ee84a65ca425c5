"""Graph generators and the three on-device graph representations
(paper §4.1, §5.2; DESIGN.md §1, §13).

The generators are numpy copies of ``repro/core/graphs.py``'s, so the same
seed gives the same graph in both packages.  Each state holds one batch of
B graphs with N nodes as torch tensors on one device:

- ``GraphState``: the (B, N, N) residual adjacency with the paper's C and S
  masks, rewritten by every commit;
- ``SparseGraphState``: padded neighbour lists (B, N, D) with the sentinel
  id N and a validity mask.  The topology is never rewritten: residual
  edges derive from S (:func:`residual_edge_mask`);
- ``CsrGraphState``: flat CSR arrays (indptr, indices, edge_mask), storage
  proportional to the edges; residual edges derive from S as for the
  sparse state (:func:`csr_residual_edge_mask`).  Row ids are derived
  (:func:`csr_row_ids`), never stored.

The builders (``sparse_batch_from_dense``, ``csr_batch_from_dense``,
``csr_batch_from_arrays``, ``barabasi_albert_edges``, ``csr_from_edges``)
are numpy-identical to the JAX package's, so both packages hold the same
arrays for the same graph.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# Generators (paper §6.1: ER(n, rho=0.15), BA(n, d=4), Facebook-like SBM).
# ---------------------------------------------------------------------------

def erdos_renyi(n: int, rho: float = 0.15, *, seed: int) -> np.ndarray:
    """ER(n, rho): each unordered pair connected with probability rho."""
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < rho
    upper = np.triu(upper, k=1)
    a = (upper | upper.T).astype(np.float32)
    return a


def barabasi_albert(n: int, d: int = 4, *, seed: int) -> np.ndarray:
    """BA(n, d): preferential attachment, d edges per new node (paper d=4).
    Sampling a uniform entry of the edge-endpoint list is degree-
    proportional sampling, so each new node costs O(d)."""
    rng = np.random.default_rng(seed)
    m0 = min(d + 1, n)
    si, sj = np.triu_indices(m0, k=1)
    n_new = max(n - m0, 0)
    cap = 2 * (len(si) + n_new * d)
    endpoints = np.empty((cap,), np.int64)
    cnt = 2 * len(si)
    endpoints[0:cnt:2] = si
    endpoints[1:cnt:2] = sj
    src = np.empty((n_new * d,), np.int64)
    dst = np.empty((n_new * d,), np.int64)
    ecnt = 0
    for v in range(m0, n):
        k = min(d, v)
        chosen: list = []
        seen: set = set()
        while len(chosen) < k:
            draw = endpoints[rng.integers(0, cnt, size=2 * k)]
            for t in draw:
                t = int(t)
                if t not in seen:
                    seen.add(t)
                    chosen.append(t)
                    if len(chosen) == k:
                        break
        targets = np.asarray(chosen, np.int64)
        src[ecnt:ecnt + k] = v
        dst[ecnt:ecnt + k] = targets
        endpoints[cnt:cnt + k] = v
        endpoints[cnt + k:cnt + 2 * k] = targets
        cnt += 2 * k
        ecnt += k
    a = np.zeros((n, n), dtype=np.float32)
    a[si, sj] = a[sj, si] = 1.0
    a[src[:ecnt], dst[:ecnt]] = a[dst[:ecnt], src[:ecnt]] = 1.0
    return a


def social_like(n: int, communities: int = 8, p_in: float = 0.08,
                p_out: float = 0.002, *, seed: int) -> np.ndarray:
    """Stochastic-block-model stand-in for the paper's Facebook graphs."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, communities, size=n)
    same = labels[:, None] == labels[None, :]
    p = np.where(same, p_in, p_out)
    upper = np.triu(rng.random((n, n)) < p, k=1)
    return (upper | upper.T).astype(np.float32)


def random_graph_batch(kind: str, n: int, batch: int, *, seed: int,
                       **kw) -> np.ndarray:
    gen = {"er": erdos_renyi, "ba": barabasi_albert, "social": social_like}[kind]
    return np.stack([gen(n, seed=seed + i, **kw) for i in range(batch)])


def edge_count(a: np.ndarray) -> int:
    return int(a.sum() / 2)


# ---------------------------------------------------------------------------
# Dense graph state (B graphs stacked; paper Fig 2).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GraphState:
    """State of a batch of B graphs with N nodes each.

    adj:       (B, N, N) float32 — residual adjacency (edges covered by the
               partial solution are zeroed, paper Fig 4 right panel).
    candidate: (B, N) float32 mask — the paper's C vector.
    solution:  (B, N) float32 mask — the paper's S vector.
    axis:      on a mesh, the graph axis (``core.mesh.Axis``) whose rank
               holds only its (B, N/sp, N) block of ``adj`` rows; the masks
               stay whole.  None: all N rows.
    """
    adj: torch.Tensor
    candidate: torch.Tensor
    solution: torch.Tensor
    axis: Any = None

    @property
    def batch(self) -> int:
        return self.adj.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.candidate.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.adj.device


def init_state(adj, *, device: DeviceLike = "cuda") -> GraphState:
    """Fresh state on ``device``: empty solution; candidates = nodes with
    degree > 0.  ``adj`` (numpy or torch, (N, N) or (B, N, N)) is always
    copied, so a solve that updates the state in place never touches the
    caller's array."""
    dev = resolve_device(device)
    if isinstance(adj, np.ndarray) and not adj.flags.writeable:
        adj = np.array(adj)       # torch will not wrap read-only memory
    adj = torch.as_tensor(adj).to(device=dev, dtype=torch.float32, copy=True)
    if adj.dim() == 2:
        adj = adj[None]
    deg = adj.sum(-1)
    return GraphState(
        adj=adj,
        candidate=(deg > 0).to(torch.float32),
        solution=torch.zeros(adj.shape[:2], dtype=torch.float32, device=dev),
    )


def residual_adjacency(adj0: torch.Tensor,
                       solution: torch.Tensor) -> torch.Tensor:
    """Tuples2Graphs (paper Alg 5 line 21): the residual subgraph of the
    original adjacency under a partial solution, A ⊙ (1-S)(1-S)ᵀ."""
    keep = 1.0 - solution
    return adj0 * keep[..., :, None] * keep[..., None, :]


def _as_numpy(adj) -> np.ndarray:
    """A host copy of an adjacency given as numpy or torch, (B, N, N)."""
    if isinstance(adj, torch.Tensor):
        adj = adj.detach().cpu().numpy()
    adj = np.asarray(adj)
    return adj[None] if adj.ndim == 2 else adj


# ---------------------------------------------------------------------------
# Sparse graph state: padded neighbour lists + masks (paper §4.1/§5.2).
# The topology (neighbors, valid) is immutable; (candidate, solution) evolve.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SparseGraphBatch:
    """Static topology of B graphs: neighbors (B, N, D) int32 padded with
    the sentinel id N, valid (B, N, D) bool."""
    neighbors: torch.Tensor
    valid: torch.Tensor

    @property
    def batch(self) -> int:
        return self.neighbors.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.neighbors.shape[1]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[2]

    @property
    def device(self) -> torch.device:
        return self.neighbors.device


@dataclasses.dataclass
class SparseGraphState:
    """Sparse counterpart of :class:`GraphState`.

    neighbors: (B, N, D) int32 padded neighbour ids, sentinel N for padding.
    valid:     (B, N, D) bool static topology mask (never rewritten).
    candidate: (B, N) float32 mask, the paper's C vector.
    solution:  (B, N) float32 mask, the paper's S vector.
    residual:  the env's topology mode: True ("solution": the residual
               subgraph implied by S, MVC), False ("none": the original
               topology) or "closed" (MIS: S and its neighbours removed).
    axis:      on a mesh, the graph axis (``core.mesh.Axis``) whose rank
               holds only its (B, N/sp, D) block of list rows (global ids);
               the masks stay whole.  None: all N rows.

    A residual edge (u, v) exists iff the original edge exists and neither
    endpoint is in S: O(N·D) state instead of O(N²)."""
    neighbors: torch.Tensor
    valid: torch.Tensor
    candidate: torch.Tensor
    solution: torch.Tensor
    residual: Union[bool, str] = True
    axis: Any = None

    @property
    def batch(self) -> int:
        return self.neighbors.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.candidate.shape[1]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[2]

    @property
    def device(self) -> torch.device:
        return self.neighbors.device


def _gather_nodes(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """values (B, M), ids (B, ...) int → values[b, ids[b, ...]]."""
    b = values.shape[0]
    flat = ids.reshape(b, -1).long()
    return torch.gather(values, 1, flat).reshape(ids.shape)


def residual_edge_mask(neighbors: torch.Tensor, valid: torch.Tensor,
                       solution: torch.Tensor,
                       sol_rows: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(B, Nl, D) float32 residual-edge factors: valid ∧ keep[u] ∧ keep[v],
    the sparse analogue of :func:`residual_adjacency`, derived from the
    immutable topology and the (B, N) partial solution.  ``sol_rows`` is
    the solution of the lists' own Nl rows when they are one rank's block
    of the graph; None means the lists hold all N rows."""
    keep = 1.0 - solution
    keep_rows = keep if sol_rows is None else 1.0 - sol_rows
    keep_pad = torch.nn.functional.pad(keep, (0, 1))        # sentinel slot
    keep_nbr = _gather_nodes(keep_pad, neighbors)
    return valid.to(torch.float32) * keep_nbr * keep_rows[:, :, None]


def closed_neighborhood_keep(neighbors: torch.Tensor, valid: torch.Tensor,
                             solution: torch.Tensor,
                             sol_rows: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """(B, Nl) keep factors of closed-neighbourhood removal (MIS): a node
    survives iff it is neither in ``solution`` nor lists a node of it,
    the sparse analogue of zeroing the rows and columns of S ∪ N(S).
    ``solution`` is the whole (B, N) mask; ``sol_rows`` its slice of the
    lists' own Nl rows when they are one rank's block of the graph (None:
    the lists hold all N rows)."""
    sol_pad = torch.nn.functional.pad(solution, (0, 1))     # sentinel slot
    s_nbr = _gather_nodes(sol_pad, neighbors)
    any_nbr = (valid.to(torch.float32) * s_nbr).amax(-1)
    rows = solution if sol_rows is None else sol_rows
    return (1.0 - rows) * (1.0 - any_nbr)


def closed_neighborhood_keep_dense(adj: torch.Tensor, solution: torch.Tensor,
                                   sol_rows: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Dense counterpart of :func:`closed_neighborhood_keep` over a
    (B, Nl, N) adjacency, original (re-materialization) or residual (a
    neighbour already removed has no edge left to lose), of all N rows
    or of one rank's Nl (``sol_rows`` as above).  The mask is a ``> 0``
    test of sums of 0/1 products, so any summation order gives the same
    bits."""
    nbr_s = torch.einsum("bnm,bm->bn", adj, solution)
    rows = solution if sol_rows is None else sol_rows
    return (1.0 - rows) * (1.0 - (nbr_s > 0).to(torch.float32))


def sparse_batch_from_dense(adj, max_degree: Optional[int] = None, *,
                            device: DeviceLike = "cuda") -> SparseGraphBatch:
    """adj (B, N, N) or (N, N) → padded neighbour lists with a common max
    degree, on ``device``; each row's neighbours in ascending id order.

    ``max_degree`` of None or 0 derives the width from the batch; an
    explicit value below the true max degree raises rather than silently
    dropping edges."""
    dev = resolve_device(device)
    adj = _as_numpy(adj)
    b, n, _ = adj.shape
    deg = (adj > 0).sum(-1)
    true_md = int(deg.max()) if deg.size else 0
    if not max_degree:                       # None or 0 → derive
        md = max(true_md, 1)
    elif max_degree < true_md:
        raise ValueError(
            f"max_degree={max_degree} is below the batch's true max degree "
            f"{true_md}; refusing to silently drop edges")
    else:
        md = max_degree
    nbrs = np.full((b, n, md), n, np.int32)
    val = np.zeros((b, n, md), bool)
    bi, rows, cols = np.nonzero(adj > 0)
    flat = bi * n + rows
    counts = np.bincount(flat, minlength=b * n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    offs = np.arange(len(flat)) - starts[flat]
    keep = offs < md
    nbrs[bi[keep], rows[keep], offs[keep]] = cols[keep]
    val[bi[keep], rows[keep], offs[keep]] = True
    return SparseGraphBatch(neighbors=torch.from_numpy(nbrs).to(dev),
                            valid=torch.from_numpy(val).to(dev))


def sparse_init_state(g: SparseGraphBatch) -> SparseGraphState:
    """Fresh sparse state on ``g``'s device: empty solution; candidates =
    degree > 0.  The state shares ``g``'s topology tensors."""
    deg = g.valid.sum(-1)
    return SparseGraphState(
        neighbors=g.neighbors, valid=g.valid,
        candidate=(deg > 0).to(torch.float32),
        solution=torch.zeros(g.neighbors.shape[:2], dtype=torch.float32,
                             device=g.device))


# ---------------------------------------------------------------------------
# CSR graph state: flat compressed-sparse-row arrays (DESIGN.md §13), storage
# proportional to the edges.  Topology (indptr, indices, edge_mask) is
# immutable; residual edges derive from the solution mask.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CsrGraphBatch:
    """Static CSR topology for B graphs with a common (N, E) shape.

    indptr:    (B, N+1) int32: row j's directed edges are
               ``indices[indptr[j]:indptr[j+1]]``; ``indptr[N]`` is the
               graph's true directed edge count (≤ E).
    indices:   (B, E) int32 column ids, padded with the sentinel N.
    edge_mask: (B, E) bool, True on real edges.

    Every undirected edge appears twice (u→v and v→u)."""
    indptr: torch.Tensor
    indices: torch.Tensor
    edge_mask: torch.Tensor

    @property
    def batch(self) -> int:
        return self.indptr.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[1] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.indptr.device


@dataclasses.dataclass
class CsrGraphState:
    """CSR counterpart of :class:`GraphState`: the topology fields of
    :class:`CsrGraphBatch`, the C/S masks, and the env's ``residual`` mode
    as on :class:`SparseGraphState`.  Row ids are not stored
    (:func:`csr_row_ids`), keeping state bytes at 5·E + ~12·N per graph."""
    indptr: torch.Tensor
    indices: torch.Tensor
    edge_mask: torch.Tensor
    candidate: torch.Tensor
    solution: torch.Tensor
    residual: Union[bool, str] = True

    @property
    def batch(self) -> int:
        return self.indptr.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[1] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.indptr.device


# A CSR batch of more than CHUNK_SLOTS edge slots in all is taken a few
# graphs at a time by the helpers below, so that their transients (int64
# ids, f64 prefix sums, products) stay near CHUNK_SLOTS elements: a
# paper-scale minibatch (64 graphs of 62.9M directed edges) would need
# 32 GB for each int64 or f64 copy.  Every graph is computed alone either
# way, so the values are the same.
CHUNK_SLOTS = 1 << 28


def _by_graphs(fn, shape, dtype: torch.dtype, num_edges: int,
               *tensors) -> Optional[torch.Tensor]:
    """``fn`` over a few graphs of ``tensors`` at a time, into a new tensor
    of ``shape``, when the batch exceeds CHUNK_SLOTS slots; None otherwise
    (the caller then computes the batch in one pass)."""
    b = shape[0]
    step = max(1, CHUNK_SLOTS // max(num_edges, 1))
    if b <= step:
        return None
    out = torch.empty(shape, dtype=dtype, device=tensors[0].device)
    for i in range(0, b, step):
        out[i:i + step] = fn(*(t[i:i + step] for t in tensors))
    return out


def csr_row_ids(indptr: torch.Tensor, num_edges: int) -> torch.Tensor:
    """(B, N+1) indptr → (B, E) int32 source row of each edge slot:
    ``row_ids[j] = #{i ∈ 1..N-1 : indptr[i] ≤ j}``, the inclusive cumsum
    of +1 increments scattered at the interior row boundaries, as the JAX
    package derives it.  Empty rows stack their increments on one slot;
    boundaries at E (empty tail rows) are dropped; padded slots past
    ``indptr[N]`` land on row N-1, where their zero factor makes them
    inert.  The cumsum runs over the flattened batch (a scan along a long
    inner dimension of few rows is slow on the card) and each graph then
    subtracts the count of the graphs before it."""
    b = indptr.shape[0]
    out = _by_graphs(lambda ip: csr_row_ids(ip, num_edges), (b, num_edges),
                     torch.int32, num_edges, indptr)
    if out is not None:
        return out
    inc = torch.zeros((b, num_edges + 1), dtype=torch.int32,
                      device=indptr.device)
    bounds = indptr[:, 1:-1].long()
    inc.scatter_add_(1, bounds, torch.ones_like(bounds, dtype=torch.int32))
    total = inc[:, :num_edges].reshape(-1).cumsum(0, dtype=torch.int32)
    total = total.reshape(b, num_edges)
    before = torch.nn.functional.pad(total[:-1, -1], (1, 0))
    return total - before[:, None]


def csr_segment_sum(values: torch.Tensor, row_ids: torch.Tensor,
                    num_nodes: int) -> torch.Tensor:
    """Per-row sums: (B, E) edge values → (B, N) node sums.

    CSR row ids are non-decreasing by construction, so each row's sum is
    the difference of two prefix sums at its first slot and the next
    row's: no atomics (whose contention on the padded slots, all on row
    N-1, serialises a scatter-add on the card), the same result on every
    run.  One f64 prefix sum runs over the flattened batch (differences
    within a graph do not see the graphs before it), so sums of 0/1 edge
    factors are exact at any edge count."""
    b, e = values.shape
    out = _by_graphs(lambda v, r: csr_segment_sum(v, r, num_nodes),
                     (b, num_nodes), values.dtype, e, values, row_ids)
    if out is not None:
        return out
    prefix = torch.nn.functional.pad(values.double().reshape(-1).cumsum(0),
                                     (1, 0))
    rows = torch.arange(num_nodes + 1, dtype=row_ids.dtype,
                        device=values.device).expand(b, -1).contiguous()
    first = torch.searchsorted(row_ids.contiguous(), rows).long()
    first = first + e * torch.arange(b, device=values.device)[:, None]
    return (prefix[first[:, 1:]] - prefix[first[:, :-1]]).to(values.dtype)


def csr_segment_max(values: torch.Tensor, row_ids: torch.Tensor,
                    num_nodes: int) -> torch.Tensor:
    """Per-row maxima of NON-NEGATIVE edge values: (B, E) → (B, N).  The
    init is zero, so empty rows read 0; a maximum is the same in any
    order, so the scatter's atomics give the same result on every run.
    A zero value changes no maximum, so zero slots scatter to node
    ``slot % N`` instead of their row: the padded slots, which all sit on
    row N-1, and the zero products of sparse masks would otherwise queue
    their atomics on a few addresses."""
    b, e = values.shape
    out = _by_graphs(lambda v, r: csr_segment_max(v, r, num_nodes),
                     (b, num_nodes), values.dtype, e, values, row_ids)
    if out is not None:
        return out
    spread = torch.arange(e, device=values.device) % num_nodes
    index = torch.where(values > 0, row_ids.long(), spread)
    out = torch.zeros((b, num_nodes), dtype=values.dtype,
                      device=values.device)
    return out.scatter_reduce_(1, index, values, "amax", include_self=True)


def csr_closed_neighborhood_keep(indices: torch.Tensor,
                                 edge_mask: torch.Tensor,
                                 row_ids: torch.Tensor,
                                 solution: torch.Tensor) -> torch.Tensor:
    """(B, N) keep factors of closed-neighbourhood removal (MIS) on CSR
    arrays: the segment maximum of sol[col] over each row plays the part
    of the sparse rep's masked ``amax``."""
    out = _by_graphs(csr_closed_neighborhood_keep, solution.shape,
                     torch.float32, indices.shape[1], indices, edge_mask,
                     row_ids, solution)
    if out is not None:
        return out
    sol_pad = torch.nn.functional.pad(solution, (0, 1))     # sentinel slot
    s_col = _gather_nodes(sol_pad, indices)
    any_nbr = csr_segment_max(edge_mask.to(torch.float32) * s_col, row_ids,
                              solution.shape[1])
    return (1.0 - solution) * (1.0 - any_nbr)


def csr_closed_edge_mask(indices: torch.Tensor, edge_mask: torch.Tensor,
                         row_ids: torch.Tensor,
                         solution: torch.Tensor) -> torch.Tensor:
    """(B, E) float32 closed-neighbourhood factors (MIS): mask ∧ keep[row]
    ∧ keep[col] with the keep factors of
    :func:`csr_closed_neighborhood_keep`; symmetric on symmetric arrays."""
    out = _by_graphs(csr_closed_edge_mask, indices.shape, torch.float32,
                     indices.shape[1], indices, edge_mask, row_ids, solution)
    if out is not None:
        return out
    keep = csr_closed_neighborhood_keep(indices, edge_mask, row_ids,
                                        solution)
    keep_pad = torch.nn.functional.pad(keep, (0, 1))        # sentinel slot
    return (edge_mask.to(torch.float32) * _gather_nodes(keep_pad, indices)
            * _gather_nodes(keep, row_ids))


def csr_residual_edge_mask(indices: torch.Tensor, edge_mask: torch.Tensor,
                           row_ids: torch.Tensor,
                           solution: torch.Tensor) -> torch.Tensor:
    """(B, E) float32 residual-edge factors: mask ∧ keep[row] ∧ keep[col],
    the CSR analogue of :func:`residual_edge_mask`."""
    out = _by_graphs(csr_residual_edge_mask, indices.shape, torch.float32,
                     indices.shape[1], indices, edge_mask, row_ids, solution)
    if out is not None:
        return out
    keep = 1.0 - solution
    keep_pad = torch.nn.functional.pad(keep, (0, 1))        # sentinel slot
    return (edge_mask.to(torch.float32) * _gather_nodes(keep_pad, indices)
            * _gather_nodes(keep, row_ids))


def symmetric_topology(g) -> bool:
    """Whether every graph of a padded-list or CSR batch is symmetric: its
    live (u, v) slots, counted with multiplicity, are its (v, u) slots.
    The env builds only such graphs, and the sparse and CSR layers'
    backwards need them (``core.s2v.self_adjoint_layer_grads``).  One
    graph at a time: two sorts of its live slots' int64 keys."""
    n = g.num_nodes
    if isinstance(g, CsrGraphBatch):
        cols, live = g.indices, g.edge_mask
        rows = csr_row_ids(g.indptr, g.num_edges)
    else:
        cols, live = g.neighbors, g.valid
        rows = torch.arange(n, device=cols.device)[:, None].expand(
            cols.shape[1:])
    for i in range(g.batch):
        r = (rows[i] if rows.dim() == cols.dim() else rows)[live[i]].long()
        c = cols[i][live[i]].long()
        if bool(((c < 0) | (c >= n)).any()) or not torch.equal(
                torch.sort(r * n + c).values, torch.sort(c * n + r).values):
            return False
    return True


def csr_batch_from_dense(adj, max_edges: Optional[int] = None, *,
                         device: DeviceLike = "cuda") -> CsrGraphBatch:
    """adj (B, N, N) or (N, N) → flat CSR arrays with a common edge
    capacity, on ``device``; each row's columns ascending.

    ``max_edges`` of None or 0 derives the capacity from the batch; an
    explicit value below the true max directed-edge count raises rather
    than silently dropping edges."""
    dev = resolve_device(device)
    adj = _as_numpy(adj)
    b, n, _ = adj.shape
    bi, rows, cols = np.nonzero(adj > 0)        # C-order: sorted by (bi, row)
    per_graph = np.bincount(bi, minlength=b)
    true_e = int(per_graph.max(initial=0))
    if not max_edges:                           # None or 0 → derive
        me = max(true_e, 1)
    elif max_edges < true_e:
        raise ValueError(
            f"max_edges={max_edges} is below the batch's true directed edge "
            f"count {true_e}; refusing to silently drop edges")
    else:
        me = max_edges
    indices = np.full((b, me), n, np.int32)
    mask = np.zeros((b, me), bool)
    starts = np.concatenate([[0], np.cumsum(per_graph)[:-1]])
    pos = np.arange(len(bi)) - starts[bi]
    indices[bi, pos] = cols
    mask[bi, pos] = True
    rowcounts = np.bincount(bi * n + rows, minlength=b * n).reshape(b, n)
    indptr = np.zeros((b, n + 1), np.int32)
    np.cumsum(rowcounts, axis=1, out=indptr[:, 1:])
    return CsrGraphBatch(indptr=torch.from_numpy(indptr).to(dev),
                         indices=torch.from_numpy(indices).to(dev),
                         edge_mask=torch.from_numpy(mask).to(dev))


def csr_batch_from_arrays(indptr: np.ndarray, indices: np.ndarray,
                          max_edges: Optional[int] = None, *,
                          device: DeviceLike = "cuda") -> CsrGraphBatch:
    """One graph's CSR arrays (indptr (N+1,), indices (E,)) → a B=1
    :class:`CsrGraphBatch` on ``device``, optionally padded to
    ``max_edges`` slots.  No dense adjacency is ever built."""
    dev = resolve_device(device)
    indptr = np.asarray(indptr, np.int32)
    indices = np.asarray(indices, np.int32)
    n = len(indptr) - 1
    e = len(indices)
    me = max_edges if max_edges else max(e, 1)
    if me < e:
        raise ValueError(
            f"max_edges={me} is below the graph's directed edge count {e}; "
            f"refusing to silently drop edges")
    idx = np.full((me,), n, np.int32)
    idx[:e] = indices
    mask = np.zeros((me,), bool)
    mask[:e] = True
    return CsrGraphBatch(indptr=torch.from_numpy(indptr)[None].to(dev),
                         indices=torch.from_numpy(idx)[None].to(dev),
                         edge_mask=torch.from_numpy(mask)[None].to(dev))


def csr_batch_to_dense(g) -> np.ndarray:
    """(B, N, N) dense adjacency of a CSR batch or state (a test helper)."""
    indptr = g.indptr.cpu().numpy()
    indices = g.indices.cpu().numpy()
    mask = g.edge_mask.cpu().numpy()
    b, n = indptr.shape[0], indptr.shape[1] - 1
    a = np.zeros((b, n, n), np.float32)
    for i in range(b):
        rows = np.repeat(np.arange(n), np.diff(indptr[i]))
        a[i, rows, indices[i][mask[i]]] = 1.0
    return a


def csr_init_state(g: CsrGraphBatch) -> CsrGraphState:
    """Fresh CSR state on ``g``'s device: empty solution; candidates =
    degree > 0.  The state shares ``g``'s topology tensors."""
    deg = g.indptr[:, 1:] - g.indptr[:, :-1]
    return CsrGraphState(
        indptr=g.indptr, indices=g.indices, edge_mask=g.edge_mask,
        candidate=(deg > 0).to(torch.float32),
        solution=torch.zeros((g.batch, g.num_nodes), dtype=torch.float32,
                             device=g.device))


# ---------------------------------------------------------------------------
# Streaming edge lists and CSR assembly for paper-scale graphs (§6.4:
# N ≥ 1M, 10M+ edges): vectorized numpy, no (N, N) array, no per-node loop.
# ---------------------------------------------------------------------------

def barabasi_albert_edges(n: int, d: int = 4, *,
                          seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """BA(n, d) as a directed edge list (src, dst) in O(E) memory and time:
    the Batagelj–Brandes copy model.  Edge t's target is a uniform draw
    r[t] from the 2t endpoints of earlier edges; even draws resolve to a
    source (``src[r/2]``), odd draws chase ``rr ← r[(rr-1)/2]`` down to one.
    Repeated draws collapse at dedupe, so a degree can fall below d."""
    rng = np.random.default_rng(seed)
    m = np.minimum(np.arange(n, dtype=np.int64), d)
    src = np.repeat(np.arange(n, dtype=np.int64), m)
    t = np.arange(len(src), dtype=np.int64)
    if len(t) == 0:
        return src, src.copy()
    r = rng.integers(0, np.maximum(2 * t, 1))
    rr = r.copy()
    odd = (rr & 1) == 1
    while odd.any():
        rr[odd] = r[(rr[odd] - 1) >> 1]
        odd = (rr & 1) == 1
    dst = src[rr >> 1]
    dst[0] = 0                         # edge 0 has no predecessors: 1 → 0
    return src, dst


def csr_from_edges(n: int, src: np.ndarray, dst: np.ndarray, *,
                   symmetrize: bool = True,
                   dedupe: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Directed edge list → (indptr (N+1,) int32, indices (E,) int32).
    Self-loops are dropped; ``symmetrize`` mirrors every edge; ``dedupe``
    removes repeats by sorting the int64 key ``src·n + dst``, which also
    gives row-major order with ascending columns."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if symmetrize:
        src, dst = (np.concatenate([src, dst]), np.concatenate([dst, src]))
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src * np.int64(n) + dst
    if dedupe:
        key = np.unique(key)
        src, dst = key // n, key % n
    else:
        order = np.argsort(key, kind="stable")
        src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=n)
    indptr = np.zeros((n + 1,), np.int64)
    np.cumsum(deg, out=indptr[1:])
    return indptr.astype(np.int32), dst.astype(np.int32)


DATA_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
            / "repro_torch" / "data")


def cached_ba_csr(n: int, d: int = 4, *, seed: int,
                  cache_dir=None) -> Tuple[np.ndarray, np.ndarray]:
    """BA(n, d) as CSR arrays, cached as ``.npz`` under ``cache_dir``
    (default ``build/repro_torch/data`` at the repository root, which
    ``.gitignore`` lists)."""
    cache = pathlib.Path(cache_dir) if cache_dir else DATA_DIR
    cache.mkdir(parents=True, exist_ok=True)
    path = cache / f"ba_n{n}_d{d}_s{seed}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["indptr"], z["indices"]
    src, dst = barabasi_albert_edges(n, d, seed=seed)
    indptr, indices = csr_from_edges(n, src, dst)
    np.savez_compressed(path, indptr=indptr, indices=indices)
    return indptr, indices
