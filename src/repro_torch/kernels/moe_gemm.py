"""Grouped expert GLU FFN over per-expert capacity buffers:

    y[e] = (silu(x[e] @ wg[e]) * (x[e] @ wu[e])) @ wo[e]

Counterpart of ``repro/kernels/moe_gemm.py::grouped_glu_ffn`` (the Pallas
``_glu_kernel`` and ``_proj_kernel``), the MoE layer's expert FFN
(``models/ffn.py::_expert_ffn``).  x (E, C, d), wg and wu (E, d, f), wo
(E, f, d), float32 or bfloat16 (upcast exactly, as the JAX wrapper does);
the output is (E, C, d) float32.

:func:`grouped_glu_ffn_plain` is the PyTorch composition (three einsums and
SiLU, as ``ref.grouped_glu_ffn``); :func:`grouped_glu_ffn` computes it on
CPU tensors and on CUDA tensors launches the two hand-written kernels of
``csrc/moe_gemm.cu`` (the GLU product into an f32 scratch h (E, C, f), then
h @ wo), counting two launches per call in ``grouped_glu_ffn.launches``,
inside an autograd Function whose backward differentiates the plain
version (``checks.plain_grads``).
The kernels multiply on the tensor cores in TF32, each f32 operand split
into two TF32 values as :func:`tf32_split` does, and sum three of the four
split products: ``hi·hi + hi·lo + lo·hi``.
"""
from __future__ import annotations

import ctypes

import torch

from .build import launch
from .checks import f32_inputs, on_cpu, plain_grads


def grouped_glu_ffn_plain(x: torch.Tensor, wg: torch.Tensor,
                          wu: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    x, wg, wu, wo = (t.float() for t in (x, wg, wu, wo))
    g = torch.einsum("ecd,edf->ecf", x, wg)
    u = torch.einsum("ecd,edf->ecf", x, wu)
    return torch.einsum("ecf,efd->ecd", torch.nn.functional.silu(g) * u, wo)


def tf32_split(t: torch.Tensor) -> tuple:
    """(hi, lo) of a float32 tensor as the kernels split each operand:
    hi = tf32(t) and lo = tf32(t - hi), where tf32 rounds to 10 mantissa
    bits, to nearest with ties away from zero (PTX ``cvt.rna.tf32.f32``),
    by adding half of the dropped 13 bits' range to the magnitude and
    clearing them.  For normal values hi + lo is within 2^-22 of t,
    relative."""
    def tf32(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = tf32(t.float())
    return hi, tf32(t.float() - hi)


def _check_shapes(x, wg, wu, wo) -> None:
    if x.dim() != 3 or wg.dim() != 3:
        raise ValueError("x and the weights must be 3-D")
    e, c, d = x.shape
    f = wg.shape[2]
    if tuple(wg.shape) != (e, d, f) or tuple(wu.shape) != (e, d, f) \
            or tuple(wo.shape) != (e, f, d):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, wg {tuple(wg.shape)}, wu "
            f"{tuple(wu.shape)}, wo {tuple(wo.shape)}; expected (E,C,d), "
            f"(E,d,f), (E,d,f), (E,f,d)")
    if not (1 <= e <= 65535 and c >= 1 and d >= 1 and f >= 1):
        raise ValueError(f"unsupported sizes E={e}, C={c}, d={d}, f={f}")


def _launch(x, wg, wu, wo):
    """The two kernels on the current stream."""
    e, c, d = x.shape
    f = wg.shape[2]
    h = torch.empty((e, c, f), dtype=torch.float32, device=x.device)
    y = torch.empty((e, c, d), dtype=torch.float32, device=x.device)
    launch("moe_gemm", "moe_glu", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4,
           x.device, x.data_ptr(), wg.data_ptr(), wu.data_ptr(), h.data_ptr(),
           e, c, d, f)
    grouped_glu_ffn.launches += 1
    launch("moe_gemm", "moe_proj", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4,
           x.device, h.data_ptr(), wo.data_ptr(), y.data_ptr(), e, c, f, d)
    grouped_glu_ffn.launches += 1
    return y


class _GroupedGlu(torch.autograd.Function):
    """The kernels forward; the backward differentiates the plain version
    on the saved inputs, as JAX differentiates ``moe_dense_apply``'s
    einsums (no backward kernel there)."""

    @staticmethod
    def forward(ctx, x, wg, wu, wo):
        ctx.save_for_backward(x, wg, wu, wo)
        return _launch(x, wg, wu, wo)

    @staticmethod
    def backward(ctx, grad):
        return plain_grads(grouped_glu_ffn_plain, ctx, (grad,))


def grouped_glu_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wo: torch.Tensor) -> torch.Tensor:
    """x (E, C, d); wg/wu (E, d, f); wo (E, f, d) → (E, C, d) float32.
    CPU tensors take the plain version; CUDA tensors launch the two
    kernels on the current stream, through an autograd Function whose
    backward is the plain version's."""
    x, wg, wu, wo = f32_inputs("x", {"x": x, "wg": wg, "wu": wu, "wo": wo})
    _check_shapes(x, wg, wu, wo)
    if on_cpu(x, "grouped_glu_ffn"):
        return grouped_glu_ffn_plain(x, wg, wu, wo)
    return _GroupedGlu.apply(x, wg, wu, wo)


grouped_glu_ffn.launches = 0
