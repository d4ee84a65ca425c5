"""Adam (Kingma & Ba; paper §4.4), as ``repro/optim/adam.py`` computes it.

``torch.optim.Adam`` is not this function: it folds the second bias
correction into the denominator and forms both corrections in doubles.
Here the step count is an f32 tensor, ``bc1 = 1 - b1**t`` and
``bc2 = 1 - b2**t`` are f32, and the update is ``mhat / (sqrt(vhat) +
eps)`` with eps after the square root, so the port's parameters follow
JAX's within a few ulp.

Parameters are a :class:`torch.nn.Module` (its ``named_parameters``) or a
mapping of names to tensors; gradients and the moments are mappings with
the same names.  :func:`adam_update` updates the parameters and the state
in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass
class AdamState:
    step: torch.Tensor                 # () int32
    mu: Dict[str, torch.Tensor]        # first moments, by parameter name
    nu: Dict[str, torch.Tensor]        # second moments


def named(params: Params) -> Dict[str, torch.Tensor]:
    """``params`` as a dict of name → tensor, in its own order."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adam_init(params: Params) -> AdamState:
    """Zero f32 moments and step 0, on the parameters' device."""
    ps = named(params)
    dev = next(iter(ps.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in ps.items()}
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=zeros,
                     nu={k: torch.zeros_like(z) for k, z in zeros.items()})


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by min(1, max_norm / (‖g‖ + 1e-9)), ‖g‖ the f32
    norm over all of them.  Returns (clipped gradients, norm)."""
    sq = 0
    for g in grads.values():
        sq = sq + torch.sum(torch.square(g.float()))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def adam_update(params: Params, grads: Mapping[str, torch.Tensor],
                state: AdamState, *, lr: float,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> AdamState:
    """One Adam step over every parameter, in place: the parameters, the
    moments and the step.  Returns ``state``."""
    state.step += 1
    t = state.step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for name, p in named(params).items():
        g32 = grads[name].to(torch.float32)
        m, v = state.mu[name], state.nu[name]
        m32 = b1 * m + (1 - b1) * g32
        v32 = b2 * v + (1 - b2) * torch.square(g32)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        p.copy_(p.to(torch.float32) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return state
