"""Shared model components: norms, rotary embeddings, initializers, and
the small tree helpers the parameter and cache trees use.  Counterpart of
``repro/models/common.py``.

The initializers draw from an explicit ``torch.Generator`` on the device
the weights live on: the values differ from ``jax.random``'s, the
distributions and shapes are JAX's.  On the ``meta`` device they make
shapes only (``lm.param_shapes``)."""
from __future__ import annotations

from typing import Callable, Optional

import torch

F32 = torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, D): rotate the pairs (x[..0::2], x[..1::2]).
    positions: (..., T) integers."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                # (D/2,)
    ang = positions[..., None].float() * freqs            # (..., T, D/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., T, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    out = torch.stack([r1, r2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def randn(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` from ``gen`` on
    ``device`` (``gen`` None on the meta device)."""
    return torch.randn(tuple(shape), generator=gen, dtype=F32, device=device)


def dense_init(gen: Optional[torch.Generator], shape, dtype, device,
               fan_in: Optional[int] = None) -> torch.Tensor:
    fan_in = shape[0] if fan_in is None else fan_in
    return (randn(gen, shape, device) * fan_in ** -0.5).to(dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    return (randn(gen, (vocab, d), device) * d ** -0.5).to(dtype)


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts and lists of the same
    structure (None stays None; a tuple is a leaf)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [tree_map(fn, *parts) for parts in zip(*trees)]
    if first is None:
        return None
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]
