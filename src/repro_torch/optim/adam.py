"""Adam (Kingma & Ba; paper §4.4), as ``repro/optim/adam.py`` computes it.

``torch.optim.Adam`` is not this function: it folds the second bias
correction into the denominator and forms both corrections in doubles.
Here the step count is an f32 tensor, ``bc1 = 1 - b1**t`` and
``bc2 = 1 - b2**t`` are f32, and the update is ``mhat / (sqrt(vhat) +
eps)`` with eps after the square root, so the port's parameters follow
JAX's within a few ulp.

Parameters are a :class:`torch.nn.Module` (its ``named_parameters``), a
mapping of names to tensors, or a tree of nested dicts and lists of
tensors (the LM's parameter tree, ``models/common.py``'s ``tree_map``);
gradients and the moments have the parameters' structure (a module's by
parameter name).  The moments are stored in ``moment_dtype`` (f32 by
default, as in JAX) and updated in f32.  :func:`adam_update` updates the
parameters and the state in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..models.common import tree_leaves, tree_map

F32 = torch.float32
Params = Union[nn.Module, Any]


@dataclasses.dataclass
class AdamState:
    step: torch.Tensor      # () int32
    mu: Any                 # first moments, the parameters' structure
    nu: Any                 # second moments


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's: on the CPU
    ``torch.sqrt``'s vectorized f32 path is not (an ulp off in about one
    element in 150), so it takes the f64 root, whose rounding to f32 is
    exact; CUDA's f32 ``sqrt`` is correctly rounded.  A meta tensor takes
    CUDA's route, so a step counted on meta is the card's."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def named(params: Params) -> Dict[str, torch.Tensor]:
    """A module as a dict of name → parameter, in its own order; any other
    tree as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def adam_init(params: Params, *, moment_dtype: torch.dtype = F32
              ) -> AdamState:
    """Zero moments of ``moment_dtype`` and step 0, on the parameters'
    device."""
    ps = named(params)
    dev = tree_leaves(ps)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=tree_map(zeros, ps), nu=tree_map(zeros, ps))


def global_norm(grads) -> torch.Tensor:
    """The f32 norm over every gradient of the tree."""
    sq = 0
    for g in tree_leaves(grads):
        sq = sq + torch.sum(torch.square(g.float()))
    return sqrt_f32(sq)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / (‖g‖ + 1e-9)), ‖g‖ the f32
    norm over all of them, the product taken in f32 and rounded to the
    gradient's dtype.  Returns (clipped gradients, norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float,
                         norm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """:func:`clip_by_global_norm` in place (the same values, no second
    set of gradients), by ``norm`` where it is given (a mesh's global
    norm of gradients that a rank holds only blocks of).  Returns the
    norm."""
    if norm is None:
        norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    for g in tree_leaves(grads):
        if g.dtype == F32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return norm


@torch.no_grad()
def adam_update(params: Params, grads, state: AdamState, *,
                lr: Union[float, torch.Tensor],
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0) -> AdamState:
    """One Adam step over every parameter, in place: the parameters, the
    moments and the step.  The arithmetic is JAX's ``upd`` in f32; the
    moments are rounded to their dtype and the parameters to theirs.
    Returns ``state``."""
    state.step += 1
    t = state.step.to(F32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    ps = named(params)

    def upd(p, g, m, v):
        # JAX's expression, each step a new tensor or in place on one that
        # is not read again (the same values; fewer leaf-sized temporaries)
        g32 = g.to(F32)
        m32 = m.to(F32) * b1
        m32.add_(g32 * (1 - b1))
        v32 = v.to(F32) * b2
        v32.add_(torch.square(g32).mul_(1 - b2))
        del g32
        m.copy_(m32)
        v.copy_(v32)
        den = sqrt_f32(v32.div_(bc2)).add_(eps)
        del v32
        delta = m32.div_(bc1).div_(den)
        del den
        if weight_decay:
            delta.add_(p.to(F32) * weight_decay)
        p32 = p.to(F32)
        if p32 is p:                       # an f32 leaf: in place
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(p32.sub_(delta.mul_(lr)))
    # grads and moments indexed by the parameters' keys (a module's
    # gradients are a dict by name, in any order)
    tree_map(upd, ps, grads, state.mu, state.nu)
    return state


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """``lr_at(step)``: linear warmup to ``base_lr`` over ``warmup`` steps,
    then a half cosine down to 0 at ``total``, in f32 as JAX computes it
    (an f32 0-d tensor).  The cosine of the f32 angle is rounded
    correctly (from f64); XLA's own f32 cosine is within an ulp of it."""
    def lr_at(step):
        step = torch.as_tensor(step, dtype=F32)
        warm = base_lr * step / max(1.0, warmup)
        frac = torch.clamp((step - warmup) / max(1.0, total - warmup), 0, 1)
        angle = math.pi * frac
        cos = base_lr * 0.5 * (1.0 + torch.cos(angle.double()).float())
        return torch.where(step < warmup, warm, cos)
    return lr_at
