"""Padded-sparse structure2vec neighbour aggregation:

    out[b, k, i] = Σ_d x[b, k, neighbors[b, i, d]] · edge[b, i, d]

Counterpart of ``repro/kernels/s2v_gather.py::sparse_mp_aggregate`` (the
Pallas ``_sparse_agg_kernel``), the aggregation of the sparse
representation's ``"xla"`` reference chain.  ``x`` is (B, K, N+1) with a
zero sentinel column at N; neighbors (B, Nl, D) int32 hold the global ids
of Nl nodes' neighbours, padded with N, and edge (B, Nl, D) float32 their
factors; the output is (B, K, Nl) float32.  Nl is N on one device and a
row block of the graph on a mesh's graph axis.  ``compute="bf16"`` rounds x
and the factors to bf16 at use and sums in f32, as the sparse layer's
aggregate does; the sparse layer's backward (``core/s2v_sparse.py``) runs
it at either compute mode.

:func:`sparse_mp_aggregate_plain` is the PyTorch composition;
:func:`sparse_mp_aggregate` computes it on CPU tensors and launches the
hand-written kernel (``csrc/s2v_gather.cu``) on CUDA tensors, counting
launches in ``sparse_mp_aggregate.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .build import launch
from .checks import check_tensors, on_cpu
from .s2v_fused import check_compute, check_k, round_cd
from .walk import aligned, padded_node_major


def sparse_mp_aggregate_plain(x: torch.Tensor, neighbors: torch.Tensor,
                              edge: torch.Tensor,
                              compute: str = "f32") -> torch.Tensor:
    """Gather with int64 ids, then contract over the D slots in f32, x and
    the factors rounded to the compute dtype."""
    b, k, _ = x.shape
    nl, d = neighbors.shape[1:]
    ids = neighbors.reshape(b, 1, nl * d).long().expand(b, k, nl * d)
    gathered = torch.gather(round_cd(x.float(), compute), 2,
                            ids).reshape(b, k, nl, d)
    return torch.einsum("bknd,bnd->bkn", gathered,
                        round_cd(edge.float(), compute))


def _check_inputs(x, neighbors, edge) -> None:
    check_tensors("neighbors", {"x": x, "neighbors": neighbors,
                                "edge": edge}, int32=("neighbors",))
    if x.dim() != 3 or neighbors.dim() != 3:
        raise ValueError("x and neighbors must be 3-D")
    b, k, np1 = x.shape
    # a row block holds at most the graph's N nodes: lists of N rows
    # against an x of N columns lack x's sentinel column
    if neighbors.shape[0] != b or edge.shape != neighbors.shape \
            or neighbors.shape[1] > np1 - 1:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, neighbors "
            f"{tuple(neighbors.shape)}, edge {tuple(edge.shape)}; expected "
            f"(B,K,N+1), (B,Nl,D), (B,Nl,D) with Nl <= N")
    check_k(b, k)
    nl, d = neighbors.shape[1:]
    if np1 < 2 or nl < 1 or d < 1:
        raise ValueError(f"unsupported sizes N={np1 - 1}, Nl={nl}, D={d}")


def sparse_mp_aggregate(x: torch.Tensor, neighbors: torch.Tensor,
                        edge: torch.Tensor,
                        compute: str = "f32") -> torch.Tensor:
    """The aggregation in one launch.  CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream, reading a
    node-major copy of x whose rows are padded with zeros to a multiple of
    4 floats (:func:`padded_node_major`), and the lists as they are, of any
    width, read in 16-byte groups (copied only if they do not start on 16
    bytes, :func:`walk.aligned`)."""
    check_compute(compute)
    _check_inputs(x, neighbors, edge)
    if on_cpu(neighbors, "sparse_mp_aggregate"):
        return sparse_mp_aggregate_plain(x, neighbors, edge, compute)
    b, k, np1 = x.shape
    nl = neighbors.shape[1]
    xt = padded_node_major(x)
    neighbors, edge = aligned(neighbors), aligned(edge)
    out = torch.empty((b, k, nl), dtype=torch.float32, device=x.device)
    launch("s2v_gather", "s2v_sparse_aggregate",
           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7, x.device,
           xt.data_ptr(), neighbors.data_ptr(), edge.data_ptr(),
           out.data_ptr(), b, k, xt.shape[2], np1 - 1, nl,
           neighbors.shape[2], int(compute == "bf16"))
    sparse_mp_aggregate.launches += 1
    return out


sparse_mp_aggregate.launches = 0
