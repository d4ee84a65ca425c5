"""Fused dense structure2vec layer: relu(base + θ4 @ (embed @ adj)).

Counterpart of ``repro/kernels/s2v_fused.py::fused_s2v_layer`` (the Pallas
``_fused_dense_kernel``).  Three things live here:

- :func:`fused_s2v_layer_plain`, the PyTorch composition of the same
  function, used by the CPU tests and as the card-side reference;
- :func:`fused_s2v_layer`, the wrapper: on CPU tensors it computes the
  plain version, on CUDA tensors it launches the hand-written kernel
  (``csrc/s2v_fused.cu``) and never anything else;
- ``fused_s2v_layer.launches``, the count of kernel launches, so a run can
  show that its path went through the kernel.

Layouts are JAX's: θ4 (K, K), embed (B, K, Nl), adj (B, Nl, N), base
(B, K, N); the output is (B, K, N) float32.  ``compute`` is ``"f32"`` or
``"bf16"``: bf16 rounds every matmul operand at use and the f32 aggregate
once before the θ4 product, with f32 accumulation and an f32 base/ReLU
(DESIGN.md §12).
"""
from __future__ import annotations

import ctypes

import torch

MAX_K = 32
COMPUTE_MODES = ("f32", "bf16")


def _round_cd(x: torch.Tensor, compute: str) -> torch.Tensor:
    """Round to the compute dtype's values, kept in float32 so products and
    sums stay f32 (bf16 × bf16 products are exact in f32)."""
    if compute == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def fused_s2v_layer_plain(theta4: torch.Tensor, embed: torch.Tensor,
                          adj: torch.Tensor, base: torch.Tensor,
                          compute: str = "f32") -> torch.Tensor:
    """The layer as a PyTorch composition (the kernel's plain version)."""
    _check_compute(compute)
    nbr = torch.matmul(_round_cd(embed.float(), compute),
                       _round_cd(adj.float(), compute))
    e3 = torch.matmul(_round_cd(theta4.float(), compute),
                      _round_cd(nbr, compute))
    return torch.relu(base.float() + e3)


def _check_compute(compute: str) -> None:
    if compute not in COMPUTE_MODES:
        raise ValueError(f"unknown compute mode {compute!r}; "
                         f"available: {list(COMPUTE_MODES)}")


def _check_inputs(theta4, embed, adj, base) -> None:
    tensors = {"theta4": theta4, "embed": embed, "adj": adj, "base": base}
    for name, t in tensors.items():
        if t.device != adj.device:
            raise ValueError(f"{name} is on {t.device}, adj on {adj.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the fused kernel takes 1 <= K <= {MAX_K}, got {k}")
    if not (1 <= b <= 65535 and nl >= 1 and n >= 1):
        raise ValueError(f"unsupported sizes B={b}, Nl={nl}, N={n}")


def _library():
    from .build import load
    lib = load("s2v_fused")
    fn = lib.s2v_fused_layer
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
    return fn


def fused_s2v_layer(theta4: torch.Tensor, embed: torch.Tensor,
                    adj: torch.Tensor, base: torch.Tensor,
                    compute: str = "f32") -> torch.Tensor:
    """One dense S2V layer in one launch.  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream."""
    _check_compute(compute)
    _check_inputs(theta4, embed, adj, base)
    if adj.device.type == "cpu":
        return fused_s2v_layer_plain(theta4, embed, adj, base, compute)
    if adj.device.type != "cuda":
        raise ValueError(f"fused_s2v_layer runs on cpu or cuda, "
                         f"not {adj.device}")
    b, k, nl = embed.shape
    n = adj.shape[2]
    out = torch.empty((b, k, n), dtype=torch.float32, device=adj.device)
    launch = _library()
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream(adj.device).cuda_stream
        err = launch(theta4.data_ptr(), embed.data_ptr(), adj.data_ptr(),
                     base.data_ptr(), out.data_ptr(), b, k, nl, n,
                     int(compute == "bf16"), stream)
    if err != 0:
        raise RuntimeError(f"s2v_fused_layer launch failed: CUDA error {err}")
    fused_s2v_layer.launches += 1
    return out


fused_s2v_layer.launches = 0
