"""Sparse (gather-based) structure2vec path: the paper's sparse graph
storage (§4.1, §5.2).  Counterpart of ``repro/core/s2v_sparse.py``, on one
device (``axis=None``) or on one rank of a mesh's graph axis, which holds
the (B, Nl, D) neighbour lists (global ids) of its Nl = N/sp resident nodes:
each layer then all-gathers the (B, K, N) embeddings over the axis, so the
rank's gathers reach remote-resident neighbours (DESIGN.md §3).

The topology is stored once as padded neighbour lists (B, N, D) plus the
partial-solution mask S; a residual edge exists iff the original edge
exists and neither endpoint is in S, so each layer is a gather over static
ids with per-slot factors: O(N·D) memory, no adjacency rewrite.

``kernel="fused"`` (default) runs each layer as one launch of
``kernels.s2v_fused.fused_s2v_layer_sparse`` (the hand-written CUDA kernel
on the card) and elides layer 0 (zero embeddings make the first
aggregation exactly zero, so layer 1 is relu(embed1 + embed2)).
``kernel="xla"`` is the reference per-op chain; its aggregation is
``kernels.s2v_gather.sparse_mp_aggregate``, the CUDA kernel on the card,
as the JAX chain runs its Pallas gather on the TPU.

Training differentiates both lowerings on one device.  The backwards take
the lists' symmetry (u lists v iff v lists u, with equal factors: true of
every graph the env builds) to form each input gradient as one more
aggregate (``core.s2v.self_adjoint_layer_grads``), so they form no
gathered (B, K, N, D) tensor.  A row block of the lists (a mesh's graph
axis) breaks that symmetry, so its backward is refused: it belongs to
ROADMAP item "the mesh's train half".
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.s2v_fused import fused_s2v_layer_sparse
from ..kernels.s2v_gather import sparse_mp_aggregate
from .graphs import SparseGraphState, residual_edge_mask
from .mesh import Axis, all_gather_tiled, check_axis
from .qmodel import scores_local
from .s2v import (check_kernel, compute_dtype, s2v_base,
                  self_adjoint_layer_grads)


def residual_edge_factors(nbr_local: torch.Tensor, valid_local: torch.Tensor,
                          sol_local: torch.Tensor, *,
                          axis: Optional[Axis] = None) -> torch.Tensor:
    """(B, Nl, D) residual-edge factors valid ∧ keep[u] ∧ keep[v].  With
    ``axis`` naming the mesh's graph axis, the (B, Nl) local solution slice
    is all-gathered first (the paper §5.1 C/S broadcast), so the factors of
    remote neighbour endpoints are visible to the local lists."""
    check_axis(axis)
    if axis is None:
        return residual_edge_mask(nbr_local, valid_local, sol_local)
    sol = all_gather_tiled(sol_local, axis, 1)
    return residual_edge_mask(nbr_local, valid_local, sol, sol_local)


def check_residual(residual) -> None:
    if residual == "closed":
        raise NotImplementedError(
            "closed-neighbourhood residuals (MIS) on the sparse and CSR "
            "representations are not ported yet: ROADMAP item \"the other "
            "three problems\"")


def edge_factors(nbr_local: torch.Tensor, valid_local: torch.Tensor,
                 sol_local: torch.Tensor, residual, *,
                 axis: Optional[Axis] = None) -> torch.Tensor:
    """Edge factors for the env's residual mode: True/"solution" removes
    S's edges; False/"none" keeps the original topology."""
    check_residual(residual)
    if residual is False or residual == "none":
        check_axis(axis)
        return valid_local.to(torch.float32)
    return residual_edge_factors(nbr_local, valid_local, sol_local,
                                 axis=axis)


def transposed_aggregate(nbr: torch.Tensor, edge: torch.Tensor, n: int,
                         compute: str = "f32"):
    """The transpose of the lists' aggregate, as a map of one (B, K, N)
    tensor: the aggregate itself (B4 on the card, x's sentinel column
    padded on), because the whole graph's symmetric lists are their own
    transpose.  A row block's are not (Nl != N): refused."""
    nl = nbr.shape[1]
    if nl != n:
        raise NotImplementedError(
            f"the sparse layer's backward on a row block of the lists "
            f"(Nl={nl} of N={n}) is not ported yet: ROADMAP item \"the "
            f"mesh's train half\"")
    return lambda y: sparse_mp_aggregate(torch.nn.functional.pad(y, (0, 1)),
                                         nbr, edge, compute)


def check_no_factor_grad(ctx, i: int) -> None:
    if ctx.needs_input_grad[i]:
        raise NotImplementedError(
            "the sparse and CSR layers take no gradient with respect to "
            "the edge factors")


class _FusedSparseLayer(torch.autograd.Function):
    """Autograd hook around the fused sparse layer: the kernel forward,
    and the closed-form gradient of JAX's composition
    (``repro/core/s2v_sparse.py:_sparse_layer_hw_bwd``) through two
    launches of the sparse aggregate (B4, at the layer's compute mode):
    one recomputes agg, one forms the input's gradient, which equals the
    aggregate of the pre-activation's gradient only because the lists are
    symmetric (``core.s2v.self_adjoint_layer_grads``).  The lists and the
    factors get no gradient; a row block of the lists is refused."""

    @staticmethod
    def forward(ctx, theta4, x, nbr, edge, base, compute):
        ctx.save_for_backward(theta4, x, nbr, edge, base)
        ctx.compute = compute
        return fused_s2v_layer_sparse(theta4, x, nbr, edge, base, compute)

    @staticmethod
    def backward(ctx, grad):
        theta4, x, nbr, edge, base = ctx.saved_tensors
        check_no_factor_grad(ctx, 3)
        need = ctx.needs_input_grad
        dt4, dx, dbase = self_adjoint_layer_grads(
            theta4, x, base, grad.contiguous(),
            transposed_aggregate(nbr, edge, x.shape[2], ctx.compute),
            ctx.compute, (need[0], need[1], need[4]))
        return dt4, dx, None, None, dbase, None


class _SparseAggregate(torch.autograd.Function):
    """The "xla" chain's aggregation (B4 on the card) under autograd: the
    gradient of x (B, K, N+1) is the aggregate of the output's gradient,
    its sentinel column zero, by the lists' symmetry as above."""

    @staticmethod
    def forward(ctx, xp, nbr, edge):
        ctx.save_for_backward(nbr, edge)
        ctx.n = xp.shape[2] - 1
        return sparse_mp_aggregate(xp, nbr, edge)

    @staticmethod
    def backward(ctx, grad):
        nbr, edge = ctx.saved_tensors
        check_no_factor_grad(ctx, 2)
        dx = transposed_aggregate(nbr, edge, ctx.n)(grad.contiguous())
        return torch.nn.functional.pad(dx, (0, 1)), None, None


def embed_sparse_local(params, nbr_local: torch.Tensor,
                       edge_local: torch.Tensor, sol_local: torch.Tensor, *,
                       num_layers: int, axis: Optional[Axis] = None,
                       kernel: str = "fused",
                       compute: str = "f32") -> torch.Tensor:
    """structure2vec over the residual graph implied by (topology, S)
    (Alg. 2 on sparse storage).  nbr_local (B, Nl, D) int32 global
    neighbour ids; edge_local (B, Nl, D) residual-edge factors; sol_local
    (B, Nl).  With ``axis`` naming the mesh's graph axis, each layer
    all-gathers the (B, K, N) embedding buffer first; ``axis=None`` is one
    device (Nl == N).  Returns (B, K, Nl)."""
    check_kernel(kernel)
    compute_dtype(compute)
    check_axis(axis)
    base = s2v_base(params, edge_local.sum(-1), sol_local)

    embed = torch.zeros_like(base)
    for layer in range(num_layers):
        if kernel == "fused":
            if layer == 0:
                # embed⁰ = 0 ⇒ the first aggregation (and its all-gather)
                # is exactly zero
                embed = torch.relu(base)
            else:
                full = embed if axis is None else all_gather_tiled(embed,
                                                                   axis, 2)
                embed = _FusedSparseLayer.apply(params.theta4, full,
                                                nbr_local, edge_local, base,
                                                compute)
            continue
        # Reference per-op chain; the sentinel column makes padding inert.
        full = embed if axis is None else all_gather_tiled(embed, axis, 2)
        xp = torch.nn.functional.pad(full, (0, 1))
        nbr = _SparseAggregate.apply(xp, nbr_local, edge_local)
        embed3 = torch.einsum("kj,bjn->bkn", params.theta4, nbr)
        embed = torch.relu(base + embed3)
    return embed


def embed_sparse(params, g, sol: torch.Tensor, *, num_layers: int,
                 residual=True, kernel: str = "fused",
                 compute: str = "f32") -> torch.Tensor:
    """Derive the edge factors for the env's ``residual`` mode from
    (topology, S) and embed all N nodes.  ``g`` carries ``neighbors`` and
    ``valid`` (a SparseGraphBatch or SparseGraphState)."""
    edge = edge_factors(g.neighbors, g.valid, sol, residual)
    return embed_sparse_local(params, g.neighbors, edge, sol,
                              num_layers=num_layers, kernel=kernel,
                              compute=compute)


def sparse_policy_scores(params, g, sol: torch.Tensor, cand: torch.Tensor, *,
                         num_layers: int, masked: bool = True, residual=True,
                         kernel: str = "fused",
                         compute: str = "f32") -> torch.Tensor:
    emb = embed_sparse(params.em, g, sol, num_layers=num_layers,
                       residual=residual, kernel=kernel, compute=compute)
    return scores_local(params.q, emb, cand, masked=masked)


def sparse_state_bytes(g) -> int:
    """Per-step state bytes of the sparse representation: the topology,
    plus the C/S masks if ``g`` is a state."""
    total = g.neighbors.numel() * 4 + g.valid.numel()
    if isinstance(g, SparseGraphState):
        total += g.candidate.numel() * 4 + g.solution.numel() * 4
    return int(total)
