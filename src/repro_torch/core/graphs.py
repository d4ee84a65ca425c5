"""Graph generators and the dense graph state (paper §4.1, §6.1).

The generators are numpy copies of ``repro/core/graphs.py``'s, so the same
seed gives the same graph in both packages.  ``GraphState`` holds one batch
of B graphs with N nodes as torch tensors on one device: the paper's
(A, C, S) triple.
"""
from __future__ import annotations

import dataclasses

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
    """
    adj: torch.Tensor
    candidate: torch.Tensor
    solution: torch.Tensor

    @property
    def batch(self) -> int:
        return self.adj.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[-1]

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
