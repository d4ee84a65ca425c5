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

Training differentiates both lowerings, on one device and on a row block
of the lists.  The backwards take the lists' symmetry (u lists v iff v
lists u, with equal factors: true of every graph the env builds) to form
each input gradient as one more aggregate
(``core.s2v.self_adjoint_layer_grads``), so they form no gathered
(B, K, N, D) tensor.  On a mesh the whole graph's aggregate A is still its
own transpose, so the ranks' row blocks A_r satisfy Σ_r A_rᵀ(y_r) =
A(y): the gradient of a rank's (B, K, Nl) embedding is its row block's
aggregate of the all-gathered (B, K, N) gradient.  One Function per
lowering therefore takes the all-gather and the row-block layer
(:class:`_FusedSparseLayer`) or aggregate (:class:`_SparseAggregate`)
together, given the graph axis, and is the single-device Function
without one (two row-block aggregates and one all-gather a layer
backward, the forward's traffic).  The factors on a row block
come from the all-gathered solution, so they stay symmetric.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.s2v_fused import fused_s2v_layer_sparse
from ..kernels.s2v_gather import sparse_mp_aggregate
from .graphs import (SparseGraphState, _gather_nodes,
                     closed_neighborhood_keep, residual_edge_mask)
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


def closed_keep_local(nbr_local: torch.Tensor, valid_local: torch.Tensor,
                      sol_local: torch.Tensor, *,
                      axis: Optional[Axis] = None) -> torch.Tensor:
    """(B, Nl) closed-neighbourhood keep factors (MIS) of the lists' own
    rows: a node survives iff neither in S nor adjacent to it.  With
    ``axis`` naming the mesh's graph axis, the (B, Nl) solution slice is
    all-gathered first, so that each rank tests its rows against remote
    solution nodes; ``axis=None`` is one device (Nl == N)."""
    check_axis(axis)
    if axis is None:
        return closed_neighborhood_keep(nbr_local, valid_local, sol_local)
    return closed_neighborhood_keep(
        nbr_local, valid_local, all_gather_tiled(sol_local, axis, 1),
        sol_local)


def keep_edge_factors(nbr_local: torch.Tensor, valid_local: torch.Tensor,
                      keep_local: torch.Tensor, *,
                      axis: Optional[Axis] = None) -> torch.Tensor:
    """(B, Nl, D) factors valid ∧ keep[u] ∧ keep[v] of a (B, Nl) per-node
    keep mask of the lists' own rows, all-gathered over ``axis`` first
    (when given) so that the gather sees remote endpoints' keeps."""
    keep = keep_local if axis is None else all_gather_tiled(keep_local,
                                                            axis, 1)
    keep_nbr = _gather_nodes(torch.nn.functional.pad(keep, (0, 1)),
                             nbr_local)
    return valid_local.to(torch.float32) * keep_nbr * keep_local[:, :, None]


def closed_edge_factors(nbr_local: torch.Tensor, valid_local: torch.Tensor,
                        sol_local: torch.Tensor, *,
                        axis: Optional[Axis] = None) -> torch.Tensor:
    """(B, Nl, D) closed-neighbourhood factors (MIS): valid ∧ keep[u] ∧
    keep[v], where a node is kept iff neither in S nor adjacent to it.
    On a mesh (``axis``) the solution is all-gathered over the graph axis
    to form the rows' keep (:func:`closed_keep_local`), then the keep is
    all-gathered for the remote endpoints (:func:`keep_edge_factors`): two
    (B, N) gathers, as JAX's.  Symmetric lists give symmetric factors, so
    the layers' self-adjoint backwards stay exact."""
    keep = closed_keep_local(nbr_local, valid_local, sol_local, axis=axis)
    return keep_edge_factors(nbr_local, valid_local, keep, axis=axis)


def edge_factors(nbr_local: torch.Tensor, valid_local: torch.Tensor,
                 sol_local: torch.Tensor, residual, *,
                 axis: Optional[Axis] = None) -> torch.Tensor:
    """Edge factors for the env's residual mode: True/"solution" removes
    S's edges; "closed" removes S's and its neighbours' edges
    (:func:`closed_edge_factors`); False/"none" keeps the original
    topology.  With ``axis``, the lists are a rank's row block and
    ``sol_local`` its rows' slice."""
    if residual is False or residual == "none":
        check_axis(axis)
        return valid_local.to(torch.float32)
    if residual == "closed":
        return closed_edge_factors(nbr_local, valid_local, sol_local,
                                   axis=axis)
    return residual_edge_factors(nbr_local, valid_local, sol_local,
                                 axis=axis)


def _gather(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    return x if axis is None else all_gather_tiled(x, axis, 2)


def _aggregate_fn(nbr: torch.Tensor, edge: torch.Tensor, compute: str):
    """A_r, the lists' (row block's) aggregate, as a map of one (B, K, N)
    tensor: B4 on the card, with x's sentinel column padded on."""
    return lambda y: sparse_mp_aggregate(torch.nn.functional.pad(y, (0, 1)),
                                         nbr, edge, compute)


def input_grad_fn(nbr: torch.Tensor, edge: torch.Tensor, n: int,
                  axis: Optional[Axis], compute: str = "f32"):
    """The transpose of the lists' aggregate, as the map from the (B, K,
    Nl) gradient of its output to the gradient of the rank's (B, K, Nl)
    input: the row block's aggregate of the gradient all-gathered over
    ``axis`` (of the gradient itself on one device, Nl = N), because the
    whole graph's symmetric lists are their own transpose.  A row block
    whose input was not gathered by the same Function (``axis`` None,
    Nl != N) has no such form: refused."""
    if axis is None and nbr.shape[1] != n:
        raise NotImplementedError(
            f"the sparse layer's backward on a row block of the lists "
            f"(Nl={nbr.shape[1]} of N={n}) needs its input all-gathered in "
            f"the same Function: pass the mesh's graph axis "
            f"(embed_sparse_local with axis=mesh.graph)")
    agg = _aggregate_fn(nbr, edge, compute)
    return lambda y: agg(_gather(y.contiguous(), axis))


def check_no_factor_grad(ctx, i: int) -> None:
    if ctx.needs_input_grad[i]:
        raise NotImplementedError(
            "the sparse and CSR layers take no gradient with respect to "
            "the edge factors")


class _FusedSparseLayer(torch.autograd.Function):
    """Autograd hook around the fused sparse layer (B3 on the card), on
    one device (``axis`` None) or on a rank's row block of the lists,
    whose (B, K, Nl) input is first all-gathered over the graph ``axis``.
    The backward is the closed-form gradient of JAX's composition
    (``repro/core/s2v_sparse.py:_sparse_layer_hw_bwd``) through two
    launches of the sparse aggregate (B4, at the layer's compute mode):
    one recomputes agg, one forms the input's gradient, which equals the
    aggregate (of the all-gathered dagg, on a row block) only because the
    lists are symmetric (``core.s2v.self_adjoint_layer_grads``,
    ``input_grad_fn``).  The lists and the factors get no gradient; a row
    block without an axis is refused."""

    @staticmethod
    def forward(ctx, theta4, x, nbr, edge, base, compute, axis=None):
        x = _gather(x, axis)
        ctx.save_for_backward(theta4, x, nbr, edge, base)
        ctx.compute, ctx.axis = compute, axis
        return fused_s2v_layer_sparse(theta4, x, nbr, edge, base, compute)

    @staticmethod
    def backward(ctx, grad):
        theta4, x, nbr, edge, base = ctx.saved_tensors
        check_no_factor_grad(ctx, 3)
        need = ctx.needs_input_grad
        dt4, dx, dbase = self_adjoint_layer_grads(
            theta4, x, base, grad.contiguous(),
            _aggregate_fn(nbr, edge, ctx.compute), ctx.compute,
            (need[0], need[1], need[4]),
            input_grad_fn(nbr, edge, x.shape[2], ctx.axis, ctx.compute))
        return dt4, dx, None, None, dbase, None, None


class _SparseAggregate(torch.autograd.Function):
    """The "xla" chain's aggregation (B4 on the card) under autograd, of a
    whole (B, K, N) x or of a rank's (B, K, Nl) x all-gathered over the
    graph ``axis`` first: x's gradient is the aggregate of the output's
    (all-gathered) gradient, by the lists' symmetry as above; a row block
    without an axis is refused."""

    @staticmethod
    def forward(ctx, x, nbr, edge, axis=None):
        x = _gather(x, axis)
        ctx.save_for_backward(nbr, edge)
        ctx.n, ctx.axis = x.shape[2], axis
        return _aggregate_fn(nbr, edge, "f32")(x)

    @staticmethod
    def backward(ctx, grad):
        nbr, edge = ctx.saved_tensors
        check_no_factor_grad(ctx, 2)
        return input_grad_fn(nbr, edge, ctx.n, ctx.axis)(grad), None, None, \
            None


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
                embed = _FusedSparseLayer.apply(params.theta4, embed,
                                                nbr_local, edge_local, base,
                                                compute, axis)
            continue
        # Reference per-op chain; the sentinel column makes padding inert.
        nbr = _SparseAggregate.apply(embed, nbr_local, edge_local, axis)
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
