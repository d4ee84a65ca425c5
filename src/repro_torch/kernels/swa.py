"""Sliding-window causal self-attention (gemma3's local layers):

    out[i] = Σ_j softmax_j(scale · q_i·k_j) v_j   over   i - window < j <= i

Counterpart of ``repro/kernels/swa.py::swa_attention`` (the Pallas
``_swa_kernel``).  q, k, v (BH, T, d), float32 or bfloat16 (upcast
exactly); ``scale`` defaults to d**-0.5; the output is (BH, T, d) float32.

:func:`swa_attention_plain` is the PyTorch composition: the masked softmax
of ``ref.swa``, taken over blocks of queries as
``models/attention.py::_sdpa_chunked`` does, each block against only the
keys its window can reach, so no (T, T) score matrix is ever formed;
:func:`swa_attention` computes it on CPU tensors, at any size the JAX op
takes, and launches the hand-written flash kernel (``csrc/swa.cu``; d % 4
== 0, d <= 256) on CUDA tensors, counting launches in
``swa_attention.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .build import launch
from .checks import f32_inputs, on_cpu

MAX_D = 256
Q_BLOCK = 512                # queries per block of the plain version


def swa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int,
                        scale: float | None = None) -> torch.Tensor:
    bh, t, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    q, k, v = (a.float() for a in (q, k, v))
    out = torch.empty((bh, t, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, t, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, t)
        k0 = max(0, q0 - window + 1)
        logits = (q[:, q0:q1] @ k[:, k0:q1].transpose(1, 2)) * scale
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = torch.arange(k0, q1, device=q.device)[None, :]
        seen = (kj <= qi) & (kj > qi - window)
        p = torch.softmax(logits.masked_fill(~seen, float("-inf")), dim=-1)
        out[:, q0:q1] = p @ v[:, k0:q1]
    return out


def _check_shapes(q, k, v, window) -> None:
    if q.dim() != 3:
        raise ValueError("q, k and v must be 3-D")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         f"three (BH,T,d) (self-attention)")
    bh, t, d = q.shape
    if not (bh >= 1 and t >= 1 and d >= 1):
        raise ValueError(f"unsupported sizes BH={bh}, T={t}, d={d}")
    if int(window) != window or window < 1:
        raise ValueError(f"window must be a positive integer, got {window}")


def _check_kernel_limits(bh: int, d: int) -> None:
    """The CUDA kernel's own limits; the plain version has none."""
    if bh > 65535 or d % 4 or d > MAX_D:
        raise ValueError(f"the swa kernel takes BH <= 65535, d % 4 == 0 and "
                         f"d <= {MAX_D}, got BH={bh}, d={d}")


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, scale: float | None = None) -> torch.Tensor:
    """(BH, T, d) float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream."""
    q, k, v = f32_inputs("q", {"q": q, "k": k, "v": v})
    _check_shapes(q, k, v, window)
    window = int(window)
    if on_cpu(q, "swa_attention"):
        return swa_attention_plain(q, k, v, window=window, scale=scale)
    bh, t, d = q.shape
    _check_kernel_limits(bh, d)
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((bh, t, d), dtype=torch.float32, device=q.device)
    launch("swa", "swa_forward", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
           + [ctypes.c_float], q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), bh, t, d, min(window, t), scale)
    swa_attention.launches += 1
    return out


swa_attention.launches = 0
