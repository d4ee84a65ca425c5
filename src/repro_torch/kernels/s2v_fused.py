"""Fused structure2vec layers, dense and padded-sparse, and the dense
aggregate of the mesh path:

- dense:  relu(base + θ4 @ (embed @ adj)), counterpart of
  ``repro/kernels/s2v_fused.py::fused_s2v_layer`` (``_fused_dense_kernel``),
  the kernel in ``csrc/s2v_fused.cu``;
- dense aggregate: the f32 partial embed @ adj of one row block, counterpart
  of ``mp_aggregate`` (``_agg_kernel``), the same kernel without its
  epilogue;
- sparse: relu(base + θ4 @ Σ_d x[:, nbr[i, d]]·edge[i, d]), counterpart of
  ``fused_s2v_layer_sparse`` (``_fused_sparse_kernel``), the kernels in
  ``csrc/s2v_gather.cu``: a row walk and a windowed walk that give the
  same bits, one chosen per launch from the shapes (``walk.py``).

For each: ``<name>_plain``, the PyTorch composition of the same function,
used by the CPU tests and as the card-side reference; ``<name>``, the
wrapper, which computes the plain version on CPU tensors and launches the
hand-written kernel on CUDA tensors, never anything else; and
``<name>.launches``, the count of kernel launches, so a run can show that
its path went through the kernel.

Layouts are JAX's: θ4 (K, K), embed (B, K, Nl), adj (B, Nl, N), base
(B, K, N); the output is (B, K, N) float32.  The dense kernel's tile
width is chosen per launch from B, N and the card's SM count
(:func:`dense_tile_columns`).  ``compute`` is ``"f32"`` or
``"bf16"``: bf16 rounds every matmul operand at use and the f32 aggregate
once before the θ4 product, with f32 accumulation and an f32 base/ReLU
(DESIGN.md §12).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import launch
from .checks import check_tensors, on_cpu
from .walk import WALKS, aligned, check_walk, padded_node_major, walk_route

MAX_K = 32
COMPUTE_MODES = ("f32", "bf16")
# the dense kernel's tile widths (output columns per block), widest first
TILE_COLUMNS = (128, 64, 32)


def round_cd(x: torch.Tensor, compute: str) -> torch.Tensor:
    """Round to the compute dtype's values, kept in float32 so products and
    sums stay f32 (bf16 × bf16 products are exact in f32)."""
    if compute == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def fused_s2v_layer_plain(theta4: torch.Tensor, embed: torch.Tensor,
                          adj: torch.Tensor, base: torch.Tensor,
                          compute: str = "f32") -> torch.Tensor:
    """The layer as a PyTorch composition (the kernel's plain version)."""
    check_compute(compute)
    nbr = torch.matmul(round_cd(embed.float(), compute),
                       round_cd(adj.float(), compute))
    e3 = torch.matmul(round_cd(theta4.float(), compute),
                      round_cd(nbr, compute))
    return torch.relu(base.float() + e3)


def check_compute(compute: str) -> None:
    if compute not in COMPUTE_MODES:
        raise ValueError(f"unknown compute mode {compute!r}; "
                         f"available: {list(COMPUTE_MODES)}")


def check_k(b: int, k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the fused kernel takes 1 <= K <= {MAX_K}, got {k}")
    if not 1 <= b <= 65535:
        raise ValueError(f"the kernels take 1 <= B <= 65535, got {b}")


def node_major(x: torch.Tensor) -> torch.Tensor:
    """(B, K, M) → a (B, M, K) copy, so a kernel's gather of one node reads
    one contiguous K-vector (a 128-byte line at K = 32)."""
    return x.transpose(1, 2).contiguous()


def dense_tile_columns(b: int, n: int, sms: int) -> int:
    """The dense kernel's tile width for B graphs of N output columns on a
    card of ``sms`` SMs: the width whose busiest SM gets the fewest columns
    (⌈blocks / sms⌉ · width, with B·⌈N / width⌉ blocks), the widest among
    equals, since a narrower tile re-reads embed from L2 (K / width of
    adj's traffic).  It does not depend on K."""
    def busiest(tn):
        blocks = b * -(-n // tn)
        return -(-blocks // sms) * tn
    return min(TILE_COLUMNS, key=busiest)    # the first (widest) of equals


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tile(b: int, n: int, device: torch.device) -> int:
    return dense_tile_columns(b, n, sm_count(device))


def _check_inputs(theta4, embed, adj, base) -> None:
    check_tensors("adj", {"theta4": theta4, "embed": embed, "adj": adj,
                          "base": base})
    if embed.dim() != 3 or adj.dim() != 3 or base.dim() != 3:
        raise ValueError("embed, adj and base must be 3-D")
    b, k, nl = embed.shape
    n = adj.shape[2]
    if tuple(adj.shape) != (b, nl, n) or tuple(base.shape) != (b, k, n) \
            or tuple(theta4.shape) != (k, k):
        raise ValueError(
            f"shape mismatch: theta4 {tuple(theta4.shape)}, embed "
            f"{tuple(embed.shape)}, adj {tuple(adj.shape)}, base "
            f"{tuple(base.shape)}; expected (K,K), (B,K,Nl), (B,Nl,N), (B,K,N)")
    check_k(b, k)
    if nl < 1 or n < 1:
        raise ValueError(f"unsupported sizes B={b}, Nl={nl}, N={n}")


def fused_s2v_layer(theta4: torch.Tensor, embed: torch.Tensor,
                    adj: torch.Tensor, base: torch.Tensor,
                    compute: str = "f32") -> torch.Tensor:
    """One dense S2V layer in one launch.  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream."""
    check_compute(compute)
    _check_inputs(theta4, embed, adj, base)
    if on_cpu(adj, "fused_s2v_layer"):
        return fused_s2v_layer_plain(theta4, embed, adj, base, compute)
    b, k, nl = embed.shape
    n = adj.shape[2]
    out = torch.empty((b, k, n), dtype=torch.float32, device=adj.device)
    launch("s2v_fused", "s2v_fused_layer",
           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6, adj.device,
           theta4.data_ptr(), embed.data_ptr(), adj.data_ptr(),
           base.data_ptr(), out.data_ptr(), b, k, nl, n,
           int(compute == "bf16"), _tile(b, n, adj.device))
    fused_s2v_layer.launches += 1
    return out


fused_s2v_layer.launches = 0


# ---------------------------------------------------------------------------
# Dense aggregate (the sharded dense path).
# ---------------------------------------------------------------------------

def mp_aggregate_plain(embed: torch.Tensor, adj: torch.Tensor,
                       compute: str = "f32") -> torch.Tensor:
    """The aggregate as a PyTorch composition (the kernel's plain version):
    operands rounded to the compute dtype, f32 product, f32 result."""
    check_compute(compute)
    return torch.matmul(round_cd(embed.float(), compute),
                        round_cd(adj.float(), compute))


def _check_agg_inputs(embed, adj) -> None:
    check_tensors("adj", {"embed": embed, "adj": adj})
    if embed.dim() != 3 or adj.dim() != 3:
        raise ValueError("embed and adj must be 3-D")
    b, k, nl = embed.shape
    n = adj.shape[2]
    if tuple(adj.shape) != (b, nl, n):
        raise ValueError(f"shape mismatch: embed {tuple(embed.shape)}, adj "
                         f"{tuple(adj.shape)}; expected (B,K,Nl), (B,Nl,N)")
    check_k(b, k)
    if nl < 1 or n < 1:
        raise ValueError(f"unsupported sizes B={b}, Nl={nl}, N={n}")


def mp_aggregate(embed: torch.Tensor, adj: torch.Tensor,
                 compute: str = "f32") -> torch.Tensor:
    """out[b, k, n] = Σ_l cd(embed[b, k, l]) · cd(adj[b, l, n]) in f32:
    embed (B, K, Nl), adj (B, Nl, N) → (B, K, N) float32, the partial
    aggregate of one row block.  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream."""
    check_compute(compute)
    _check_agg_inputs(embed, adj)
    if on_cpu(adj, "mp_aggregate"):
        return mp_aggregate_plain(embed, adj, compute)
    b, k, nl = embed.shape
    n = adj.shape[2]
    out = torch.empty((b, k, n), dtype=torch.float32, device=adj.device)
    launch("s2v_fused", "s2v_mp_aggregate",
           [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6, adj.device,
           embed.data_ptr(), adj.data_ptr(), out.data_ptr(), b, k, nl, n,
           int(compute == "bf16"), _tile(b, n, adj.device))
    mp_aggregate.launches += 1
    return out


mp_aggregate.launches = 0


# ---------------------------------------------------------------------------
# Padded-sparse layer.
# ---------------------------------------------------------------------------

def fused_s2v_layer_sparse_plain(theta4: torch.Tensor, x: torch.Tensor,
                                 neighbors: torch.Tensor, edge: torch.Tensor,
                                 base: torch.Tensor,
                                 compute: str = "f32") -> torch.Tensor:
    """The sparse layer as a PyTorch composition (the kernel's plain
    version): pad x with a zero column for the sentinel id N, gather,
    contract over the slots in f32, then θ4, base and ReLU, with operands
    rounded to the compute dtype and the f32 aggregate rounded once."""
    from .s2v_gather import sparse_mp_aggregate_plain
    check_compute(compute)
    xp = torch.nn.functional.pad(round_cd(x.float(), compute), (0, 1))
    nbr = sparse_mp_aggregate_plain(xp, neighbors,
                                    round_cd(edge.float(), compute))
    e3 = torch.matmul(round_cd(theta4.float(), compute),
                      round_cd(nbr, compute))
    return torch.relu(base.float() + e3)


def _check_sparse_inputs(theta4, x, neighbors, edge, base) -> None:
    check_tensors("neighbors", {"theta4": theta4, "x": x,
                                "neighbors": neighbors, "edge": edge,
                                "base": base}, int32=("neighbors",))
    if x.dim() != 3 or neighbors.dim() != 3:
        raise ValueError("x and neighbors must be 3-D")
    b, k, n = x.shape
    nl, d = neighbors.shape[1:]
    if neighbors.shape[0] != b or tuple(edge.shape) != (b, nl, d) \
            or tuple(base.shape) != (b, k, nl) or tuple(theta4.shape) != (k, k):
        raise ValueError(
            f"shape mismatch: theta4 {tuple(theta4.shape)}, x "
            f"{tuple(x.shape)}, neighbors {tuple(neighbors.shape)}, edge "
            f"{tuple(edge.shape)}, base {tuple(base.shape)}; expected (K,K), "
            f"(B,K,N), (B,Nl,D), (B,Nl,D), (B,K,Nl)")
    check_k(b, k)
    if n < 1 or nl < 1 or d < 1:
        raise ValueError(f"unsupported sizes N={n}, Nl={nl}, D={d}")


def fused_s2v_layer_sparse(theta4: torch.Tensor, x: torch.Tensor,
                           neighbors: torch.Tensor, edge: torch.Tensor,
                           base: torch.Tensor, compute: str = "f32", *,
                           walk: Optional[str] = None) -> torch.Tensor:
    """One padded-sparse S2V layer in one launch.

    x (B, K, N) float32 embeddings with NO sentinel column; neighbors
    (B, Nl, D) int32 with the sentinel id N on padding (ids outside
    [0, N) add nothing and are never read); edge (B, Nl, D) float32
    residual-edge factors; base (B, K, Nl).  Returns (B, K, Nl) float32.
    CPU tensors take the plain version, whatever ``walk`` says; CUDA
    tensors launch the kernel on the current stream, reading a node-major
    copy of x, by the route :func:`walk.walk_route` picks from the shapes
    (the row walk or the windowed walk, the same bits), or by ``walk``
    ("rows" or "windows") where given.  The launch is counted in
    ``fused_s2v_layer_sparse.launches`` and in ``.routes`` by route."""
    check_compute(compute)
    check_walk(walk)
    _check_sparse_inputs(theta4, x, neighbors, edge, base)
    if on_cpu(neighbors, "fused_s2v_layer_sparse"):
        return fused_s2v_layer_sparse_plain(theta4, x, neighbors, edge, base,
                                            compute)
    b, k, n = x.shape
    nl, d = neighbors.shape[1:]
    route = walk or walk_route(b, k, n, nl, b * nl * d)
    out = torch.empty((b, k, nl), dtype=torch.float32, device=x.device)
    if route == "rows":
        xt = node_major(x)
        launch("s2v_gather", "s2v_sparse_layer",
               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6, x.device,
               theta4.data_ptr(), xt.data_ptr(), neighbors.data_ptr(),
               edge.data_ptr(), base.data_ptr(), out.data_ptr(), b, k, n, nl,
               d, int(compute == "bf16"))
    else:
        xt = padded_node_major(x)
        neighbors, edge = aligned(neighbors), aligned(edge)
        launch("s2v_gather", "s2v_sparse_layer_windowed",
               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7, x.device,
               theta4.data_ptr(), xt.data_ptr(), neighbors.data_ptr(),
               edge.data_ptr(), base.data_ptr(), out.data_ptr(), b, k,
               xt.shape[2], n, nl, d, int(compute == "bf16"))
    fused_s2v_layer_sparse.launches += 1
    fused_s2v_layer_sparse.routes[route] += 1
    return out


fused_s2v_layer_sparse.launches = 0
fused_s2v_layer_sparse.routes = dict.fromkeys(WALKS, 0)
