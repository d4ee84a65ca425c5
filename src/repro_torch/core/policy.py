"""The RL agent's combined policy model: EM (structure2vec) followed by Q
(action evaluation), paper §4.2.  Counterpart of ``repro/core/policy.py``.

``Policy`` is an ``nn.Module`` holding ``em`` (θ1..θ4) and ``q``
(θ5..θ7), so its ``state_dict`` keys are ``em.theta1`` … ``q.theta7``: the
JAX checkpoint keys without their leading dot.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .mesh import Axis
from .qmodel import QModel, init_q, scores_local
from .s2v import S2V, check_kernel, compute_dtype, embed_local, init_s2v

COLLECTIVES_MODES = ("auto", "manual", "gspmd")


def check_collectives(mode: str) -> str:
    if mode not in COLLECTIVES_MODES:
        raise ValueError(f"collectives must be one of {COLLECTIVES_MODES}, "
                         f"got {mode!r}")
    return mode


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Paper §6.1 hyper-parameter settings; the same fields, defaults and
    validation as the JAX ``PolicyConfig``.  Both engines run on the
    three reps: ``engine="device"`` (the fused solve and train step) on
    one device or on a ``spatial=(dp, sp)`` mesh (CSR at sp = 1),
    ``engine="host"`` (the per-evaluation solve, the host training loop)
    on one device."""
    embed_dim: int = 32          # K
    num_layers: int = 2          # L
    gamma: float = 0.9           # discount
    learning_rate: float = 1e-5
    replay_capacity: int = 50_000
    eps_start: float = 0.9
    eps_end: float = 0.1
    eps_decay_steps: int = 500
    minibatch: int = 64          # B tuples per GD iteration
    grad_iters: int = 1          # τ (paper §4.5.2)
    graph_rep: str = "dense"     # "dense" | "sparse" | "csr"
    engine: str = "device"       # "device" | "host"
    spatial: Union[int, Tuple[int, int]] = 0
    kernel: str = "fused"        # "fused" | "xla"
    compute: str = "f32"         # "f32" | "bf16"
    collectives: str = "auto"    # "auto" | "manual" | "gspmd"

    def __post_init__(self):
        check_kernel(self.kernel)
        compute_dtype(self.compute)
        check_collectives(self.collectives)


class Policy(nn.Module):
    """Q(EM(·)): ``em`` is the S2V embedding, ``q`` the action scorer."""

    def __init__(self, em: S2V, q: QModel):
        super().__init__()
        self.em = em
        self.q = q

    @property
    def dim(self) -> int:
        return self.em.dim

    @property
    def device(self) -> torch.device:
        return self.em.theta1.device


def init_policy(cfg: PolicyConfig, *, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Policy:
    """Random policy for ``cfg`` drawn from ``generator`` (on the CPU, so a
    seed gives the same weights on every device), placed on ``device``.
    A torch generator does not reproduce ``jax.random``: to compare with
    the JAX package, carry JAX's weights over with ``convert``."""
    dev = resolve_device(device)
    return Policy(init_s2v(cfg.embed_dim, generator=generator, device=dev),
                  init_q(cfg.embed_dim, generator=generator, device=dev))


def num_params(cfg: PolicyConfig) -> int:
    """4K² + 4K: the gradient all-reduce payload (paper §5.1(3))."""
    k = cfg.embed_dim
    return 4 * k * k + 4 * k


def policy_scores(
    params: Policy,
    adj_local: torch.Tensor,      # (B, Nl, N)
    sol_local: torch.Tensor,      # (B, Nl)
    cand_local: torch.Tensor,     # (B, Nl)
    *,
    num_layers: int,
    axis: Optional[Axis] = None,
    masked: bool = True,
    kernel: str = "fused",
    compute: str = "f32",
) -> torch.Tensor:
    """Q(EM(Aᶦ, Sᶦ), Cᶦ): (B, Nl) masked scores of local candidates;
    ``axis`` is the mesh's graph axis on a rank of a mesh, None on one
    device."""
    emb = embed_local(params.em, adj_local, sol_local,
                      num_layers=num_layers, axis=axis, kernel=kernel,
                      compute=compute)
    return scores_local(params.q, emb, cand_local, axis=axis, masked=masked)
