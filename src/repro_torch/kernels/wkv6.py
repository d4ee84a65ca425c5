"""Chunked RWKV-6 ("Finch") recurrence with data-dependent decay:

    o_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t),   S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

Counterpart of ``repro/kernels/wkv6.py::wkv6_chunked`` (the Pallas
``_wkv6_kernel``).  r, k, w (BH, T, dk), v (BH, T, dv), u (BH, dk), float32
or bfloat16 (upcast exactly); w is the decay multiplier in (0, 1].  The
sequence is taken in chunks of ``c = min(chunk, T)`` tokens (T % c == 0)
with the TPU kernel's chunk formula (its module docstring, and
``csrc/wkv6.cu``); the state starts at zero.  Returns (out (BH, T, dv),
final state (BH, dk, dv)), float32.

The formula's exponents reach c·|log w| inside a chunk, and f32 ``exp``
overflows past 88: it holds for w ≥ 0.55 at c = 64 (the TPU kernel's
documented domain) and for the model's whole range w ≥ exp(-e) ≈ 0.066 at
c = 16.  Outside that the output is NaN, as in the JAX kernel.

:func:`wkv6_chunked_plain` is the PyTorch composition, a loop over chunks
as ``models/rwkv.py::wkv6_chunked_jnp`` writes it; :func:`wkv6_chunked`
computes it on CPU tensors, at any size the JAX op takes, and on CUDA
tensors launches the two hand-written kernels of ``csrc/wkv6.cu``
(chunk ≤ 64 and dk ≤ 64): one pass over the chunks in order that keeps
the state S_n = exp(cum_c) S_{n-1} + kdᵀ v entering every chunk, then
every chunk's output a v + qp S_{n-1} in parallel, counting two launches
per call in ``wkv6_chunked.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .build import launch
from .checks import f32_inputs, on_cpu

MAX_CHUNK = 64
MAX_DK = 64
V_TILE = 64                  # value columns per block (csrc/wkv6.cu DVT)


def wkv6_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor,
                       chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    bh, t, dk = r.shape
    dv = v.shape[-1]
    c = min(chunk, t)
    r, k, v, w, u = (a.float() for a in (r, k, v, w, u))
    lw = torch.log(torch.clamp(w, 1e-6, 1.0))
    idx = torch.arange(c, device=r.device)
    lower = idx[None, :] < idx[:, None]                  # s < t
    eye = torch.eye(c, dtype=torch.float32, device=r.device)
    s = torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device)
    outs = []
    for t0 in range(0, t, c):
        rc, kc, vc, lwc = (a[:, t0:t0 + c] for a in (r, k, v, lw))
        cum = torch.cumsum(lwc, dim=1)
        qp = rc * torch.exp(cum - lwc)
        kp = kc * torch.exp(-cum)
        a = torch.where(lower, qp @ kp.transpose(1, 2), 0.0)
        diag = (rc * u[:, None, :] * kc).sum(-1)          # (bh, c)
        a = a + eye * diag[:, :, None]
        outs.append(a @ vc + qp @ s)
        cl = cum[:, -1]                                  # (bh, dk)
        kd = kc * torch.exp(cl[:, None, :] - cum)
        s = torch.exp(cl)[:, :, None] * s + kd.transpose(1, 2) @ vc
    return torch.cat(outs, dim=1), s


def _check_shapes(r, k, v, w, u, chunk) -> int:
    """The chunk length c; raises on shapes the op does not take."""
    if r.dim() != 3 or v.dim() != 3 or u.dim() != 2:
        raise ValueError("r, k, v, w must be 3-D and u 2-D")
    bh, t, dk = r.shape
    dv = v.shape[2]
    if tuple(k.shape) != (bh, t, dk) or tuple(w.shape) != (bh, t, dk) \
            or tuple(v.shape[:2]) != (bh, t) or tuple(u.shape) != (bh, dk):
        raise ValueError(
            f"shape mismatch: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}; "
            f"expected (BH,T,dk) x3 but v (BH,T,dv), u (BH,dk)")
    if not (bh >= 1 and t >= 1 and dk >= 1 and dv >= 1):
        raise ValueError(f"unsupported sizes BH={bh}, T={t}, dk={dk}, dv={dv}")
    c = min(chunk, t)
    if c < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if t % c:
        raise ValueError(f"T={t} must be divisible by chunk={c}")
    return c


def _check_kernel_limits(bh: int, dk: int, c: int) -> None:
    """The CUDA kernels' own limits; the plain version has none."""
    if bh > 65535:
        raise ValueError(f"the wkv6 kernel takes BH <= 65535, got {bh}")
    if dk > MAX_DK:
        raise ValueError(f"the wkv6 kernel takes dk <= {MAX_DK}, got {dk}")
    if c > MAX_CHUNK:
        raise ValueError(f"the wkv6 kernel takes chunk <= {MAX_CHUNK}, "
                         f"got {c}")


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, *,
                 chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (BH, T, dv), final state (BH, dk, dv)) in float32.  CPU tensors
    take the plain version; CUDA tensors launch the two kernels on the
    current stream."""
    r, k, v, w, u = f32_inputs("r", {"r": r, "k": k, "v": v, "w": w, "u": u})
    c = _check_shapes(r, k, v, w, u, chunk)
    if on_cpu(r, "wkv6_chunked"):
        return wkv6_chunked_plain(r, k, v, w, u, chunk=c)
    bh, t, dk = r.shape
    _check_kernel_limits(bh, dk, c)
    dv = v.shape[2]
    dev = r.device
    out = torch.empty((bh, t, dv), dtype=torch.float32, device=dev)
    sfin = torch.empty((bh, dk, dv), dtype=torch.float32, device=dev)
    # the state entering each chunk
    states = torch.empty((bh, t // c, dk, -(-dv // V_TILE) * V_TILE),
                         dtype=torch.float32, device=dev)
    sizes = (bh, t, dk, dv, c)
    launch("wkv6", "wkv6_state", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5,
           dev, k.data_ptr(), v.data_ptr(), w.data_ptr(), states.data_ptr(),
           sfin.data_ptr(), *sizes)
    wkv6_chunked.launches += 1
    launch("wkv6", "wkv6_out", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5,
           dev, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
           u.data_ptr(), states.data_ptr(), out.data_ptr(), *sizes)
    wkv6_chunked.launches += 1
    return out, sfin


wkv6_chunked.launches = 0
