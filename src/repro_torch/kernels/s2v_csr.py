"""Fused CSR structure2vec layer:

    relu(base + θ4 @ segment_sum(x[:, indices] · edge_w, rows))

Counterpart of ``repro/kernels/s2v_csr.py::fused_s2v_layer_csr`` (the
Pallas ``_fused_csr_kernel``).  That function takes the per-edge source
rows ``row_ids``; this one takes ``indptr`` (B, N+1) instead, from which
the CSR state derives its row ids (``core.graphs.csr_row_ids``).  The
function is the same: edge slots past ``indptr[b, N]`` are padding, with
the sentinel id N and a zero factor, and add nothing either way.

:func:`fused_s2v_layer_csr_plain` is the PyTorch composition;
:func:`fused_s2v_layer_csr` computes it on CPU tensors and launches a
hand-written kernel (``csrc/s2v_csr.cu``: a row walk or a windowed walk,
the same bits, one chosen per launch from the shapes, ``walk.py``) on CUDA
tensors, counting launches in ``fused_s2v_layer_csr.launches``.
:func:`csr_aggregate` is the same kernel's aggregate entry (either walk,
routed as the layer is, no θ4 epilogue) beside :func:`csr_aggregate_plain`,
counting in ``csr_aggregate.launches`` and ``.routes``: the CSR layer's
backward (``core/s2v_csr.py``) runs it twice.
``compute="bf16"`` rounds x, the factors and θ4 to bf16, rounds each
product x·w to bf16 before the f32 segment-sum, and rounds the f32
aggregate once before θ4, as the JAX composition does
(``repro/core/s2v_csr.py::_csr_layer_jnp``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import launch
from .checks import check_tensors, on_cpu
from .s2v_fused import check_compute, check_k, node_major, round_cd
from .walk import WALKS, aligned, check_walk, padded_node_major, walk_route


def segment_rows(values: torch.Tensor, row_ids: torch.Tensor, n: int,
                 keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, K, E) edge values → (B, K, N) per-row sums (``index_add_`` in
    edge order; row ids need not be sorted).  ``keep`` (B, E) limits the
    sum to the slots that can contribute."""
    b, k, e = values.shape
    idx = row_ids.long() + n * torch.arange(b, device=values.device)[:, None]
    src = values.transpose(1, 2)
    if keep is None:
        idx, src = idx.reshape(-1), src.reshape(b * e, k)
    else:
        idx, src = idx[keep], src[keep]
    out = torch.zeros((b * n, k), dtype=values.dtype, device=values.device)
    out.index_add_(0, idx, src)
    return out.reshape(b, n, k).transpose(1, 2)


def csr_aggregate_plain(x: torch.Tensor, indices: torch.Tensor,
                        row_ids: torch.Tensor, edge_w: torch.Tensor,
                        compute: str = "f32") -> torch.Tensor:
    """Gather the edge columns of x (B, K, N), weight, round the products
    to the compute dtype and sum them into rows in f32: (B, K, N).  Slots
    whose id is not a column (the padding sentinel N) add nothing, so
    they are left out of the sum."""
    b, k, n = x.shape
    e = indices.shape[1]
    keep = (indices >= 0) & (indices < n)
    ids = torch.where(keep, indices, 0).long()
    gathered = torch.gather(round_cd(x.float(), compute), 2,
                            ids[:, None, :].expand(b, k, e))
    weighted = round_cd(gathered * round_cd(edge_w.float(), compute)[:, None],
                        compute)
    return segment_rows(weighted, row_ids, n, keep)


def fused_s2v_layer_csr_plain(theta4: torch.Tensor, x: torch.Tensor,
                              indices: torch.Tensor, indptr: torch.Tensor,
                              edge_w: torch.Tensor, base: torch.Tensor,
                              compute: str = "f32") -> torch.Tensor:
    """The CSR layer as a PyTorch composition (the kernel's plain
    version)."""
    from ..core.graphs import csr_row_ids
    check_compute(compute)
    row_ids = csr_row_ids(indptr, indices.shape[1])
    nbr = csr_aggregate_plain(x, indices, row_ids, edge_w, compute)
    e3 = torch.matmul(round_cd(theta4.float(), compute),
                      round_cd(nbr, compute))
    return torch.relu(base.float() + e3)


def _check_inputs(theta4, x, indices, indptr, edge_w, base) -> None:
    """The layer's inputs; ``theta4`` and ``base`` None for the
    aggregate's."""
    layer = {} if theta4 is None else {"theta4": theta4, "base": base}
    check_tensors("indices", {"x": x, "indices": indices, "indptr": indptr,
                              "edge_w": edge_w, **layer},
                  int32=("indices", "indptr"))
    if x.dim() != 3 or indices.dim() != 2:
        raise ValueError("x must be 3-D and indices 2-D")
    b, k, n = x.shape
    e = indices.shape[1]
    if tuple(indices.shape) != (b, e) or tuple(indptr.shape) != (b, n + 1) \
            or tuple(edge_w.shape) != (b, e) or (layer and (
                base.shape != x.shape or tuple(theta4.shape) != (k, k))):
        raise ValueError(
            f"shape mismatch: theta4 "
            f"{None if theta4 is None else tuple(theta4.shape)}, x "
            f"{tuple(x.shape)}, indices {tuple(indices.shape)}, indptr "
            f"{tuple(indptr.shape)}, edge_w {tuple(edge_w.shape)}, base "
            f"{None if base is None else tuple(base.shape)}; expected "
            f"(K,K), (B,K,N), (B,E), (B,N+1), (B,E), (B,K,N)")
    check_k(b, k)
    if n < 1 or e < 1:
        raise ValueError(f"unsupported sizes N={n}, E={e}")


def csr_aggregate(x: torch.Tensor, indices: torch.Tensor,
                  indptr: torch.Tensor, edge_w: torch.Tensor,
                  compute: str = "f32", *,
                  walk: Optional[str] = None) -> torch.Tensor:
    """The CSR aggregate in one launch: (B, K, N) float32 row sums of the
    weighted edge columns of x, with the inputs of
    :func:`fused_s2v_layer_csr`.  CPU tensors take
    :func:`csr_aggregate_plain` (over the row ids of ``indptr``), whatever
    ``walk`` says; CUDA tensors launch the kernel on the current stream,
    reading a node-major copy of x, by the route the layer would take at
    these shapes (:func:`walk.walk_route`; the same bits either way), or by
    ``walk`` where given.  The launch is counted in
    ``csr_aggregate.launches`` and in ``.routes`` by route."""
    check_compute(compute)
    check_walk(walk)
    _check_inputs(None, x, indices, indptr, edge_w, None)
    if on_cpu(indices, "csr_aggregate"):
        from ..core.graphs import csr_row_ids
        return csr_aggregate_plain(x, indices,
                                   csr_row_ids(indptr, indices.shape[1]),
                                   edge_w, compute)
    b, k, n = x.shape
    e = indices.shape[1]
    route = walk or walk_route(b, k, n, n, b * e)
    out = torch.empty((b, k, n), dtype=torch.float32, device=x.device)
    if route == "rows":
        xt = node_major(x)
        launch("s2v_csr", "s2v_csr_aggregate_rows",
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5, x.device,
               xt.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
               edge_w.data_ptr(), out.data_ptr(), b, k, n, e,
               int(compute == "bf16"))
    else:
        xt = padded_node_major(x)
        indices, edge_w = aligned(indices), aligned(edge_w)
        launch("s2v_csr", "s2v_csr_aggregate",
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6, x.device,
               xt.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
               edge_w.data_ptr(), out.data_ptr(), b, k, xt.shape[2], n, e,
               int(compute == "bf16"))
    csr_aggregate.launches += 1
    csr_aggregate.routes[route] += 1
    return out


csr_aggregate.launches = 0
csr_aggregate.routes = dict.fromkeys(WALKS, 0)


def fused_s2v_layer_csr(theta4: torch.Tensor, x: torch.Tensor,
                        indices: torch.Tensor, indptr: torch.Tensor,
                        edge_w: torch.Tensor, base: torch.Tensor,
                        compute: str = "f32", *,
                        walk: Optional[str] = None) -> torch.Tensor:
    """One CSR S2V layer in one launch.

    x (B, K, N) float32 embeddings with NO sentinel column; indices (B, E)
    int32 column ids (ids outside [0, N), the sentinel N included, add
    nothing and are never read); indptr (B, N+1) int32; edge_w (B, E)
    float32 per-edge factors; base (B, K, N).  Returns (B, K, N) float32.
    CPU tensors take the plain version, whatever ``walk`` says; CUDA
    tensors launch the kernel on the current stream, reading a node-major
    copy of x, by the route :func:`walk.walk_route` picks from the shapes
    (the row walk or the windowed walk, the same bits), or by ``walk``
    ("rows" or "windows") where given.  The launch is counted in
    ``fused_s2v_layer_csr.launches`` and in ``.routes`` by route."""
    check_compute(compute)
    check_walk(walk)
    _check_inputs(theta4, x, indices, indptr, edge_w, base)
    if on_cpu(indices, "fused_s2v_layer_csr"):
        return fused_s2v_layer_csr_plain(theta4, x, indices, indptr, edge_w,
                                         base, compute)
    b, k, n = x.shape
    e = indices.shape[1]
    route = walk or walk_route(b, k, n, n, b * e)
    out = torch.empty((b, k, n), dtype=torch.float32, device=x.device)
    if route == "rows":
        xt = node_major(x)
        launch("s2v_csr", "s2v_csr_layer",
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5, x.device,
               theta4.data_ptr(), xt.data_ptr(), indptr.data_ptr(),
               indices.data_ptr(), edge_w.data_ptr(), base.data_ptr(),
               out.data_ptr(), b, k, n, e, int(compute == "bf16"))
    else:
        xt = padded_node_major(x)
        indices, edge_w = aligned(indices), aligned(edge_w)
        launch("s2v_csr", "s2v_csr_layer_windowed",
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6, x.device,
               theta4.data_ptr(), xt.data_ptr(), indptr.data_ptr(),
               indices.data_ptr(), edge_w.data_ptr(), base.data_ptr(),
               out.data_ptr(), b, k, xt.shape[2], n, e,
               int(compute == "bf16"))
    fused_s2v_layer_csr.launches += 1
    fused_s2v_layer_csr.routes[route] += 1
    return out


fused_s2v_layer_csr.launches = 0
fused_s2v_layer_csr.routes = dict.fromkeys(WALKS, 0)
