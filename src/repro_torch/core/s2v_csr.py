"""CSR (segment-sum) structure2vec path: flat edge arrays, no per-node
padding (DESIGN.md §13).  Counterpart of ``repro/core/s2v_csr.py``.

The topology is stored as CSR arrays (indptr, indices, edge_mask); each
layer gathers the embedding columns of every edge, weights them by the
edge's residual factor and sums them into rows.  Storage and work are
proportional to the edges, which is what reaches the paper's N ≥ 1M,
10M+-edge graphs (§6.4).  The topology is immutable; per-edge factors
derive from the partial solution (:func:`csr_edge_factors`).

``kernel="fused"`` (default) runs each layer as one launch of
``kernels.s2v_csr.fused_s2v_layer_csr`` (the hand-written CUDA kernel on
the card), with layer 0 elided as on the other representations.
``kernel="xla"`` is the reference per-op chain in plain PyTorch (the JAX
CSR chain calls no Pallas kernel either).

Training differentiates the fused layer in closed form: with symmetric
CSR arrays (u lists v iff v lists u, with equal factors: true of every
graph the env builds), the input's gradient is one more aggregate
(``kernels.s2v_csr.csr_aggregate``, B5's aggregate entry on the card),
so no gathered (B, K, E) tensor and no scatter-add is formed.
"""
from __future__ import annotations

import torch

from ..kernels.s2v_csr import (csr_aggregate, csr_aggregate_plain,
                               fused_s2v_layer_csr)
from .graphs import (CsrGraphState, csr_closed_edge_mask,
                     csr_residual_edge_mask, csr_row_ids, csr_segment_sum)
from .qmodel import scores_local
from .s2v import (check_kernel, compute_dtype, s2v_base,
                  self_adjoint_layer_grads)
from .s2v_sparse import check_no_factor_grad


def csr_edge_factors(indices: torch.Tensor, edge_mask: torch.Tensor,
                     row_ids: torch.Tensor, sol: torch.Tensor,
                     residual) -> torch.Tensor:
    """(B, E) per-edge factors for the env's residual mode: True/"solution"
    removes S's edges; "closed" removes S's and its neighbours' edges
    (MIS: mask ∧ keep[row] ∧ keep[col], symmetric on symmetric arrays);
    False/"none" keeps the original topology."""
    if residual is False or residual == "none":
        return edge_mask.to(torch.float32)
    if residual == "closed":
        return csr_closed_edge_mask(indices, edge_mask, row_ids, sol)
    return csr_residual_edge_mask(indices, edge_mask, row_ids, sol)


class _FusedCsrLayer(torch.autograd.Function):
    """Autograd hook around the fused CSR layer: the kernel forward, and
    the closed-form gradient of JAX's composition
    (``repro/core/s2v_csr.py:_csr_layer_hw_bwd``) through two launches of
    the CSR aggregate at the layer's compute mode: one recomputes agg, one
    forms the input's gradient, which equals the aggregate of the
    pre-activation's gradient only because the CSR arrays are symmetric
    (``core.s2v.self_adjoint_layer_grads``).  The topology and the factors
    get no gradient."""

    @staticmethod
    def forward(ctx, theta4, x, indices, indptr, edge_w, base, compute):
        ctx.save_for_backward(theta4, x, indices, indptr, edge_w, base)
        ctx.compute = compute
        return fused_s2v_layer_csr(theta4, x, indices, indptr, edge_w, base,
                                   compute)

    @staticmethod
    def backward(ctx, grad):
        theta4, x, indices, indptr, edge_w, base = ctx.saved_tensors
        check_no_factor_grad(ctx, 4)

        def aggregate(y):
            return csr_aggregate(y, indices, indptr, edge_w, ctx.compute)
        need = ctx.needs_input_grad
        dt4, dx, dbase = self_adjoint_layer_grads(
            theta4, x, base, grad.contiguous(), aggregate, ctx.compute,
            (need[0], need[1], need[5]))
        return dt4, dx, None, None, None, dbase, None


def embed_csr_local(params, indptr: torch.Tensor, indices: torch.Tensor,
                    row_ids: torch.Tensor, edge_w: torch.Tensor,
                    sol: torch.Tensor, *, num_layers: int,
                    kernel: str = "fused",
                    compute: str = "f32") -> torch.Tensor:
    """structure2vec over the residual graph implied by (topology, S) on
    flat CSR arrays.  indptr (B, N+1) int32; indices (B, E) int32 column
    ids (sentinel N on padding); row_ids (B, E) int32 source rows; edge_w
    (B, E) residual-edge factors; sol (B, N).  Returns (B, K, N)."""
    check_kernel(kernel)
    compute_dtype(compute)
    n = sol.shape[1]
    base = s2v_base(params, csr_segment_sum(edge_w, row_ids, n), sol)

    embed = torch.zeros_like(base)
    for layer in range(num_layers):
        if kernel == "fused":
            if layer == 0:
                # embed⁰ = 0 ⇒ the first aggregation is exactly zero
                embed = torch.relu(base)
            else:
                embed = _FusedCsrLayer.apply(params.theta4, embed, indices,
                                             indptr, edge_w, base, compute)
            continue
        # Reference per-op chain: gather, weight, sum into rows, θ4, ReLU.
        nbr = csr_aggregate_plain(embed, indices, row_ids, edge_w)
        embed3 = torch.einsum("kj,bjn->bkn", params.theta4, nbr)
        embed = torch.relu(base + embed3)
    return embed


def embed_csr(params, g, sol: torch.Tensor, *, num_layers: int,
              residual=True, kernel: str = "fused",
              compute: str = "f32") -> torch.Tensor:
    """Derive row ids and the edge factors for the env's ``residual`` mode
    from (topology, S) and embed all N nodes.  ``g`` carries ``indptr``,
    ``indices`` and ``edge_mask`` (a CsrGraphBatch or CsrGraphState)."""
    row_ids = csr_row_ids(g.indptr, g.indices.shape[1])
    edge_w = csr_edge_factors(g.indices, g.edge_mask, row_ids, sol, residual)
    return embed_csr_local(params, g.indptr, g.indices, row_ids, edge_w, sol,
                           num_layers=num_layers, kernel=kernel,
                           compute=compute)


def csr_policy_scores(params, g, sol: torch.Tensor, cand: torch.Tensor, *,
                      num_layers: int, masked: bool = True, residual=True,
                      kernel: str = "fused",
                      compute: str = "f32") -> torch.Tensor:
    emb = embed_csr(params.em, g, sol, num_layers=num_layers,
                    residual=residual, kernel=kernel, compute=compute)
    return scores_local(params.q, emb, cand, masked=masked)


def csr_state_bytes(g) -> int:
    """Per-step state bytes of the CSR representation: 5·E + 4·(N+1) for
    the topology, plus the 8·N C/S masks if ``g`` is a state."""
    total = g.indices.numel() * 4 + g.edge_mask.numel() + g.indptr.numel() * 4
    if isinstance(g, CsrGraphState):
        total += g.candidate.numel() * 4 + g.solution.numel() * 4
    return int(total)
