"""Neighbour-sampled training on one resident graph (DESIGN.md §13).
Counterpart of ``repro/core/sampling.py``.

One huge graph stays resident as host CSR arrays; training runs on small
fixed-shape subgraphs sampled from it, and the trained policy solves the
resident graph itself (S2V policies transfer from small training graphs
to much larger ones: Dai et al. 1704.01665, Drori et al. 2006.03750).

:class:`NeighborSampler` follows torch_geometric's ``NeighborSampler``:
seed-node batches (a shuffled epoch partition of the node set), k-hop
expansion with a per-hop fanout cap (each frontier node contributes at
most ``fanouts[h]`` neighbours, drawn uniformly from its CSR slice), and
extraction of the touched nodes into a local id space with the seeds
first.  The sampling is host numpy on the resident ``(indptr, indices)``
arrays, vectorized per hop, and draws exactly the JAX package's numbers:
the same ``np.random.default_rng`` seed lists give the same subgraphs, bit
for bit.

Every subgraph is padded to (``node_budget`` nodes, ``edge_budget``
directed edge slots), so a stack of them is one
:class:`~repro_torch.core.graphs.CsrGraphBatch` that the fused train step
takes as its dataset.  Padding nodes are isolated and so inert under every
env's rules.  The subgraphs are symmetric (``csr_from_edges`` mirrors every
sampled edge), as the CSR layer's closed-form backward needs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .graphs import CsrGraphBatch, csr_batch_from_arrays, csr_from_edges

__all__ = ["NeighborSampler", "SampledSubgraph"]


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    """One fixed-shape training subgraph of the resident graph.

    graph:     B=1 :class:`CsrGraphBatch` over the LOCAL id space
               (node_budget nodes, edge_budget edge slots).
    node_map:  (node_budget,) int64: local id → resident id, -1 on
               padding.  The seeds hold the first ``len(seeds)`` local ids,
               in seed order.
    seeds:     the resident seed ids the subgraph was grown from.
    num_nodes: the count of real (non-padding) local nodes."""
    graph: CsrGraphBatch
    node_map: np.ndarray
    seeds: np.ndarray
    num_nodes: int


class NeighborSampler:
    """k-hop fanout-capped neighbour sampling over one resident CSR graph.

    indptr/indices: the resident graph's CSR arrays ((N+1,), (E,)).
    batch_size:     seed nodes per subgraph.
    fanouts:        per-hop neighbour caps, outermost hop first.  Each
                    frontier node draws fanouts[h] uniform offsets into its
                    slice, with replacement; repeats collapse, so the cap is
                    "at most fanouts[h] distinct neighbours".
    node_budget /   the fixed output shape; the defaults are the exact
    edge_budget:    expansion bound B·(1 + f₁ + f₁f₂ + …) nodes and its
                    2·B·(f₁ + f₁f₂ + …) symmetrized directed edges, so they
                    never truncate.  A smaller node budget keeps nodes in
                    first-seen order (the seeds always) and drops the edges
                    of the nodes cut; a subgraph with more edges than the
                    edge budget raises.
    seed:           base seed: a subgraph is a function of ``(seed, seed
                    nodes)``."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, *,
                 batch_size: int, fanouts: Sequence[int] = (8, 4),
                 seed: int = 0, node_budget: Optional[int] = None,
                 edge_budget: Optional[int] = None):
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.num_nodes = len(self.indptr) - 1
        self.batch_size = int(batch_size)
        self.fanouts = tuple(int(f) for f in fanouts)
        if not self.fanouts or min(self.fanouts) < 1:
            raise ValueError(f"fanouts must be positive, got {fanouts!r}")
        self.seed = int(seed)
        # worst case: hop h adds at most B·∏_{i≤h} f_i new nodes
        paths, total_draws = 1, 0
        for f in self.fanouts:
            paths *= f
            total_draws += self.batch_size * paths
        self.node_budget = int(node_budget or
                               (self.batch_size + total_draws))
        self.edge_budget = int(edge_budget or max(2 * total_draws, 1))
        if self.node_budget < self.batch_size:
            raise ValueError(
                f"node_budget={self.node_budget} cannot hold the "
                f"{self.batch_size} seed nodes")

    def seed_batches(self, epoch: int = 0) -> Iterator[np.ndarray]:
        """A shuffled partition of the node set into seed batches: one
        epoch covers every node once (the last batch may be short).  A
        function of (sampler seed, epoch)."""
        rng = np.random.default_rng([self.seed, int(epoch)])
        perm = rng.permutation(self.num_nodes)
        for i in range(0, self.num_nodes, self.batch_size):
            yield perm[i:i + self.batch_size]

    def sample(self, seeds, *, device: DeviceLike = "cuda"
               ) -> SampledSubgraph:
        """Grow one fixed-shape subgraph from ``seeds`` (resident ids) on
        the host; its CSR batch is placed on ``device``."""
        seeds = np.asarray(seeds, np.int64)
        rng = np.random.default_rng([self.seed, 1 + len(seeds)]
                                    + [int(s) for s in seeds])
        seen = np.zeros((self.num_nodes,), bool)
        seen[seeds] = True
        order: List[np.ndarray] = [seeds]
        src_parts: List[np.ndarray] = []
        dst_parts: List[np.ndarray] = []
        frontier = seeds
        for f in self.fanouts:
            deg = self.indptr[frontier + 1] - self.indptr[frontier]
            has = deg > 0
            fr, dg = frontier[has], deg[has]
            if fr.size == 0:
                break
            offs = (rng.random((fr.size, f)) * dg[:, None]).astype(np.int64)
            nb = self.indices[self.indptr[fr][:, None] + offs]   # (m, f)
            src_parts.append(np.repeat(fr, f))
            dst_parts.append(nb.reshape(-1))
            fresh = np.unique(nb.reshape(-1))
            fresh = fresh[~seen[fresh]]
            seen[fresh] = True
            order.append(fresh)
            frontier = fresh
        nodes = np.concatenate(order)[:self.node_budget]

        glob2loc = np.full((self.num_nodes,), -1, np.int64)
        glob2loc[nodes] = np.arange(len(nodes))
        if src_parts:
            src = glob2loc[np.concatenate(src_parts)]
            dst = glob2loc[np.concatenate(dst_parts)]
            keep = (src >= 0) & (dst >= 0)       # cut endpoints drop
            src, dst = src[keep], dst[keep]
        else:
            src = dst = np.zeros((0,), np.int64)
        indptr_l, indices_l = csr_from_edges(self.node_budget, src, dst)
        if len(indices_l) > self.edge_budget:
            raise ValueError(
                f"sampled subgraph has {len(indices_l)} directed edges, "
                f"above edge_budget={self.edge_budget}; raise the budget")
        graph = csr_batch_from_arrays(indptr_l, indices_l,
                                      max_edges=self.edge_budget,
                                      device=device)
        node_map = np.full((self.node_budget,), -1, np.int64)
        node_map[:len(nodes)] = nodes
        return SampledSubgraph(graph=graph, node_map=node_map, seeds=seeds,
                               num_nodes=len(nodes))

    def subgraphs(self, epoch: int = 0, *, device: DeviceLike = "cuda"
                  ) -> Iterator[SampledSubgraph]:
        """One epoch of sampled subgraphs, one per seed batch."""
        for seeds in self.seed_batches(epoch):
            yield self.sample(seeds, device=device)

    def training_batch(self, num_graphs: int, epoch: int = 0, *,
                       device: DeviceLike = "cuda"
                       ) -> Tuple[CsrGraphBatch, np.ndarray]:
        """``num_graphs`` subgraphs stacked into one CsrGraphBatch on
        ``device`` (going on into later epochs where one has fewer seed
        batches), and their node maps (G, node_budget).  The batch is a
        dataset for the fused train step (``CSR.prepare_dataset`` takes it
        as it is); the node maps carry local solutions back to resident
        ids."""
        dev = resolve_device(device)
        subs: List[SampledSubgraph] = []
        e = epoch
        while len(subs) < num_graphs:
            for sg in self.subgraphs(e, device=dev):
                subs.append(sg)
                if len(subs) == num_graphs:
                    break
            e += 1
        batch = CsrGraphBatch(
            indptr=torch.cat([s.graph.indptr for s in subs]),
            indices=torch.cat([s.graph.indices for s in subs]),
            edge_mask=torch.cat([s.graph.edge_mask for s in subs]))
        node_maps = np.stack([s.node_map for s in subs])
        return batch, node_maps
