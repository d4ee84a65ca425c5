"""Action-evaluation model (paper Eq. 2, Alg. 3): scores every candidate
node from the embeddings.  Counterpart of ``repro/core/qmodel.py``, on one
device or on one rank of a mesh's graph axis."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .mesh import Axis, check_axis, pooled_sum

NEG_INF = -1e9


class QModel(nn.Module):
    """θ5, θ6 (K, K) and θ7 (2K,)."""

    def __init__(self, k: int, *, device=None):
        super().__init__()
        self.theta5 = nn.Parameter(torch.empty(k, k, device=device))
        self.theta6 = nn.Parameter(torch.empty(k, k, device=device))
        self.theta7 = nn.Parameter(torch.empty(2 * k, device=device))

    @property
    def dim(self) -> int:
        return self.theta5.shape[0]


def init_q(k: int, *, generator: torch.Generator, device=None,
           scale: float = 0.1) -> QModel:
    """Random Q-model weights with the JAX package's scales, drawn on the
    CPU from ``generator`` and placed on ``device``."""
    m = QModel(k)
    s = scale / math.sqrt(k)
    with torch.no_grad():
        for p in (m.theta5, m.theta6, m.theta7):
            p.normal_(generator=generator).mul_(s)
    return m.to(device)


def scores_local(
    params: QModel,
    embed_local: torch.Tensor,     # (B, K, Nl)
    cand_local: torch.Tensor,      # (B, Nl) candidate mask
    *,
    axis: Optional[Axis] = None,
    masked: bool = True,
) -> torch.Tensor:
    """Alg. 3: (B, Nl) scores; non-candidates get NEG_INF if masked.
    ``axis``: the mesh's graph axis when ``embed_local`` holds one rank's
    Nl nodes, over which the graph embedding sum is all-reduced (with its
    gradient: every rank's scores read the sum, ``mesh.pooled_sum``)."""
    check_axis(axis)
    sum_embed = pooled_sum(embed_local.sum(-1), axis)      # (B, K), l. 4-5
    w1 = torch.einsum("kj,bj->bk", params.theta5, sum_embed)     # Line 6
    cand_embed = embed_local * cand_local[:, None, :]            # Lines 8-9
    w2 = torch.einsum("kj,bjn->bkn", params.theta6, cand_embed)
    w1b = w1[:, :, None].expand_as(w2)                           # Line 10
    w3 = torch.relu(torch.cat([w1b, w2], dim=1))
    # Line 11: θ7ᵀ @ w3, as a sum over the innermost axis of a node-major
    # copy.  On the CPU, torch's einsum here and its sum over dim 1 both
    # round a node's score differently depending on the node's position
    # (vectorized body vs tail), so two nodes with identical embeddings
    # could score differently and break the lowest-index tie rule; a
    # reduction along each node's own contiguous row rounds all alike.
    scores = (w3.transpose(1, 2).contiguous() * params.theta7).sum(-1)
    if masked:
        scores = torch.where(cand_local > 0.5, scores,
                             torch.full_like(scores, NEG_INF))
    return scores
