"""structure2vec graph embedding model (paper Eq. 1, Alg. 2).

Counterpart of ``repro/core/s2v.py``: on one device (``axis=None``) or on
one rank of a mesh's graph axis (``axis=mesh.graph``), which holds the
(B, Nl, N) adjacency rows of its Nl = N/sp resident nodes.
``kernel=`` selects the lowering (DESIGN.md §12):

- ``"fused"`` (default): one fused launch per layer, the hand-written CUDA
  kernel on the card (``kernels.s2v_fused.fused_s2v_layer``), with layer 0
  elided: the embeddings start at zero (Alg. 2 line 3), so the first
  aggregation is exactly zero and layer 1 is relu(embed1 + embed2).  On a
  mesh the fusion splits at the collective: the aggregate kernel
  (``kernels.s2v_fused.mp_aggregate``) forms this rank's f32 partial, an
  all-reduce over the graph axis sums the partials, and the θ4 epilogue
  runs on the rank's own Nl columns.
- ``"xla"``: the reference per-op chain, kept as the semantics of record
  (named after the JAX lowering it mirrors).

Both lowerings train on one device and on a mesh: the aggregate's
backward is the einsum's vjp, and the all-reduce of the partials is
``mesh.partial_sum_columns``, whose gradient autograd sees.

``compute=`` selects the matmul operand precision of the fused layer:
``"f32"`` or ``"bf16"`` (operands rounded at use, f32 accumulation, the
aggregate rounded once, f32 base/ReLU and Q-model).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..kernels.s2v_fused import (COMPUTE_MODES, fused_s2v_layer,
                                 fused_s2v_layer_plain, mp_aggregate,
                                 round_cd)
from .mesh import Axis, check_axis, partial_sum_columns

KERNELS = ("fused", "xla")


def compute_dtype(compute: str) -> torch.dtype:
    """Resolve a ``PolicyConfig.compute`` mode name to the operand dtype."""
    if compute not in COMPUTE_MODES:
        raise ValueError(f"unknown compute mode {compute!r}; "
                         f"available: {sorted(COMPUTE_MODES)}")
    return torch.bfloat16 if compute == "bf16" else torch.float32


def check_kernel(kernel: str) -> str:
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; available: {KERNELS}")
    return kernel


class S2V(nn.Module):
    """θ1..θ4 of Eq. 1 (embedding); θ5..θ7 live in the Q-model."""

    def __init__(self, k: int, *, device=None):
        super().__init__()
        self.theta1 = nn.Parameter(torch.empty(k, device=device))
        self.theta2 = nn.Parameter(torch.empty(k, device=device))
        self.theta3 = nn.Parameter(torch.empty(k, k, device=device))
        self.theta4 = nn.Parameter(torch.empty(k, k, device=device))

    @property
    def dim(self) -> int:
        return self.theta1.shape[0]


def init_s2v(k: int, *, generator: torch.Generator, device=None,
             scale: float = 0.1) -> S2V:
    """Random S2V weights with the JAX package's scales, drawn from
    ``generator`` on the CPU (so a seed gives the same weights on every
    device), then placed on ``device``."""
    m = S2V(k)
    with torch.no_grad():
        m.theta1.normal_(generator=generator).mul_(scale)
        m.theta2.normal_(generator=generator).mul_(scale)
        m.theta3.normal_(generator=generator).mul_(scale / math.sqrt(k))
        m.theta4.normal_(generator=generator).mul_(scale / math.sqrt(k))
    return m.to(device)


class _FusedDenseLayer(torch.autograd.Function):
    """Autograd hook around the fused layer.  The forward is the kernel on
    the card; the backward differentiates the plain composition, as the
    JAX ``custom_vjp`` does (``repro/core/s2v.py:_dense_layer_hw_bwd``):
    it recomputes ``pre = base + cd(θ4) @ cd(cd(embed) @ cd(adj))``, so the
    ReLU mask comes from ``pre``, not from the kernel's output, and takes
    autograd's gradients of that composition, ``round_cd`` included (so
    bf16 rounds the cotangents as ``astype`` does in JAX).  ``adj`` never
    gets a gradient: its (B, N, N) gradient is never formed."""

    @staticmethod
    def forward(ctx, theta4, embed, adj, base, compute):
        ctx.save_for_backward(theta4, embed, adj, base)
        ctx.compute = compute
        return fused_s2v_layer(theta4, embed, adj, base, compute)

    @staticmethod
    def backward(ctx, grad):
        theta4, embed, adj, base = ctx.saved_tensors
        if ctx.needs_input_grad[2]:
            raise NotImplementedError(
                "the fused S2V layer takes no gradient with respect to the "
                "adjacency")
        wanted = [i for i in (0, 1, 3) if ctx.needs_input_grad[i]]
        if not wanted:
            return None, None, None, None, None
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(i in wanted) for i, t in
                      ((0, theta4), (1, embed), (3, base))]
            out = fused_s2v_layer_plain(inputs[0], inputs[1], adj, inputs[2],
                                        ctx.compute)
            got = torch.autograd.grad(
                out, [t for t in inputs if t.requires_grad], grad)
        grads = dict(zip(wanted, got))
        return grads.get(0), grads.get(1), None, grads.get(3), None


def self_adjoint_layer_grads(theta4: torch.Tensor, x: torch.Tensor,
                             base: torch.Tensor, grad: torch.Tensor,
                             aggregate, compute: str, needs,
                             transpose=None):
    """The gradients of one sparse or CSR layer, ``relu(base + cd(θ4) @
    cd(agg))`` with ``agg = A(x)`` an f32 sum of ``cd(x)·cd(w)``, in closed
    form: the vjp of JAX's compositions (``repro/core/s2v_sparse.py::
    _sparse_layer_jnp``, ``repro/core/s2v_csr.py::_csr_layer_jnp``), cd
    being the compute-dtype rounding (``round_cd``).

    ``aggregate`` is A on one (B, K, N) tensor.  It must be linear, and
    ``transpose`` (``aggregate`` when None) must be its transpose.  For the
    whole graph A is its own transpose: the input's gradient is then one
    more aggregate, of the pre-activation's gradient through θ4, so no
    gathered (B, K, N, D) or (B, K, E) tensor and no scatter-add is formed.
    That holds for every graph the env builds: its neighbour lists and CSR
    arrays are symmetric (u lists v iff v lists u), and so are the factors
    ``valid ∧ keep[u] ∧ keep[v]`` and ``edge_mask``.  (A row block's
    transpose is the row block's aggregate of the all-gathered gradient,
    ``core.s2v_sparse``.)  ``pre`` is recomputed
    from a second A(x), as JAX's ``custom_vjp`` recomputes the composition,
    so the ReLU mask comes from ``pre``, not from the kernel's output.
    ``needs`` says which of (θ4, x, base) want a gradient; the others are
    None.  Two launches of A at most."""
    need_t4, need_x, need_base = needs
    if not any(needs):
        return None, None, None
    t4 = round_cd(theta4, compute)
    agg = round_cd(aggregate(x), compute)
    pre = base + torch.matmul(t4, agg)
    dpre = torch.where(pre > 0, grad, torch.zeros_like(grad))
    dt4 = dx = None
    if need_t4:
        dt4 = round_cd(torch.einsum("bkn,bjn->kj", dpre, agg), compute)
    if need_x:
        dagg = round_cd(torch.matmul(t4.t(), dpre), compute)
        dx = round_cd((transpose or aggregate)(dagg.contiguous()), compute)
    return dt4, dx, dpre if need_base else None


class _AggregateFused(torch.autograd.Function):
    """Autograd hook around the aggregate of the sharded dense path (B2 on
    the card), ``cd(embed) @ cd(adj_rows)`` in f32.  Its backward is the
    vjp of that einsum, as JAX's ``custom_vjp`` differentiates it
    (``repro/core/s2v.py:_agg_hw_bwd``): ``cd(grad @ cd(adj_rows)ᵀ)``, one
    batched product that reads the rank's (B, Nl, N) rows once (JAX forms
    it outside any Pallas kernel too).  Like the single-device layer it
    gives the adjacency no gradient."""

    @staticmethod
    def forward(ctx, embed, adj, compute):
        ctx.save_for_backward(adj)
        ctx.compute = compute
        return mp_aggregate(embed, adj, compute)

    @staticmethod
    def backward(ctx, grad):
        (adj,) = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise NotImplementedError(
                "the sharded dense aggregate takes no gradient with respect "
                "to the adjacency")
        if not ctx.needs_input_grad[0]:
            return None, None, None
        rows = round_cd(adj, ctx.compute).transpose(1, 2)
        return round_cd(torch.matmul(grad, rows), ctx.compute), None, None


def s2v_base(params: S2V, deg: torch.Tensor,
             sol: torch.Tensor) -> torch.Tensor:
    """embed1 + embed2 (Alg. 2 lines 5-8), the f32 residual term of every
    layer, from the (B, Nl) residual degrees and partial solution."""
    # Line 5: embed1 = θ1 · Sᵀ  →  (B, K, Nl)
    embed1 = params.theta1[None, :, None] * sol[:, None, :]
    # Lines 7-8: w = ReLU(θ2 · deg);  embed2 = θ3 @ w
    w = torch.relu(params.theta2[None, :, None] * deg[:, None, :])
    embed2 = torch.einsum("kj,bjn->bkn", params.theta3, w)
    return (embed1 + embed2).contiguous()


def embed_local(
    params: S2V,
    adj_local: torch.Tensor,      # (B, Nl, N) local rows of residual adjacency
    sol_local: torch.Tensor,      # (B, Nl)    local slice of partial solution S
    *,
    num_layers: int,
    axis: Optional[Axis] = None,
    kernel: str = "fused",
    compute: str = "f32",
) -> torch.Tensor:
    """Returns (B, K, Nl) embeddings of the local resident nodes (Alg. 2).
    ``axis`` names the mesh's graph axis when ``adj_local`` holds one
    rank's rows (each layer then sums partials over it), None on one
    device (Nl == N)."""
    check_kernel(kernel)
    compute_dtype(compute)
    check_axis(axis)
    base = s2v_base(params, adj_local.sum(-1), sol_local)

    embed = torch.zeros_like(base)                           # Line 3
    for layer in range(num_layers):                          # Lines 9-15
        if kernel == "fused":
            if layer == 0:
                # embed⁰ = 0 ⇒ the first aggregation (and its all-reduce)
                # is exactly zero
                embed = torch.relu(base)
            elif axis is None:
                embed = _FusedDenseLayer.apply(params.theta4, embed,
                                               adj_local, base, compute)
            else:
                # fused up to the collective, all-reduced in f32, then the
                # Nl-local epilogue: the collective placement of the chain
                nbr = partial_sum_columns(
                    _AggregateFused.apply(embed, adj_local, compute), axis)
                e3 = torch.matmul(round_cd(params.theta4, compute),
                                  round_cd(nbr, compute))
                embed = torch.relu(base + e3)                   # Line 14
        else:
            nbr = torch.einsum("bkl,bln->bkn", embed, adj_local)   # Line 11
            nbr = partial_sum_columns(nbr, axis)                    # Line 12
            embed3 = torch.einsum("kj,bjn->bkn", params.theta4, nbr)
            embed = torch.relu(base + embed3)                       # Line 14
    return embed


def embed_full(params: S2V, adj: torch.Tensor, sol: torch.Tensor, *,
               num_layers: int, kernel: str = "fused",
               compute: str = "f32") -> torch.Tensor:
    """The single-device embedding (Nl == N): ``embed_local`` with no
    axis."""
    return embed_local(params, adj, sol, num_layers=num_layers, axis=None,
                       kernel=kernel, compute=compute)
