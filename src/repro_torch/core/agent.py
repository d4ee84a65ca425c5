"""Graph learning agent (paper Fig. 1, Alg. 1): the epsilon-greedy deep-Q
agent over the structure2vec + action-evaluation policy.  Counterpart of
``repro/core/agent.py``.

Training follows Alg. 5: each env step runs τ gradient-descent iterations
(§4.5.2) over minibatches that ``GraphRep.state_from_tuples`` (Tuples2Graphs)
re-materializes from compressed replay tuples.  The port trains through
the fused step (``core.engine.get_train_step``, ``core.training``); the
host loop's ``Agent.act``, ``remember`` and ``train`` (``engine="host"``)
are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.profiler import record_function

from ..device import DeviceLike, resolve_device
from ..optim import AdamState, adam_init, adam_update
# candidate_mask lives beside its caller, DenseRep.state_from_tuples; it is
# importable from here as from the JAX package's agent
from .graphrep import GraphRep, candidate_mask  # noqa: F401
from .policy import Policy, PolicyConfig, init_policy
from .replay import ReplayBuffer

HOST_ENGINE = ('engine="host" (the host training loop) is not ported yet: '
               'ROADMAP item "the rest of solve and serving"; train with '
               'engine="device" (core.training.train_agent)')


def max_q_from_scores(scores: torch.Tensor,
                      candidate: torch.Tensor) -> torch.Tensor:
    """max_v Q(s', v) from masked scores, 0 where no candidate is left."""
    has_cand = candidate.sum(-1) > 0
    return torch.where(has_cand, scores.amax(-1),
                       torch.zeros_like(scores[:, 0]))


@torch.no_grad()
def max_q_raw(params: Policy, state, *, rep: GraphRep, num_layers: int,
              kernel: str = "fused", compute: str = "f32") -> torch.Tensor:
    """max_v Q(s', v), 0 where no candidate is left."""
    return max_q_from_scores(rep.scores(params, state, num_layers=num_layers,
                                        kernel=kernel, compute=compute),
                             state.candidate)


def loss_and_grads(params: Policy, loss_fn):
    """``loss_fn(params)`` and its gradients with respect to every
    parameter, by name: the forward and backward of one GD iteration, in
    the ``torch.profiler`` ranges ``train_step.forward`` and
    ``train_step.backward``.  Returns (detached loss, {name: grad})."""
    names, tensors = zip(*params.named_parameters())
    with torch.enable_grad():
        with record_function("train_step.forward"):
            loss = loss_fn(params)
        with record_function("train_step.backward"):
            grads = torch.autograd.grad(loss, tensors)
    return loss.detach(), dict(zip(names, grads))


def adam_step(params: Policy, opt: AdamState, grads, *, lr: float) -> None:
    """One Adam update of ``params`` and ``opt`` in place, in the
    ``train_step.adam`` range."""
    with record_function("train_step.adam"):
        adam_update(params, grads, opt, lr=lr)


def td_loss(scores: torch.Tensor, action: torch.Tensor,
            target: torch.Tensor) -> torch.Tensor:
    """The mean squared TD error of the unmasked scores at the taken
    actions (Alg. 5 line 22)."""
    qsa = torch.gather(scores, 1, action.long()[:, None])[:, 0]
    return torch.mean(torch.square(qsa - target))


def train_minibatch_raw(params: Policy, opt: AdamState, state,
                        action: torch.Tensor, target: torch.Tensor, *,
                        rep: GraphRep, num_layers: int, lr: float,
                        kernel: str = "fused", compute: str = "f32"):
    """One GD iteration on a re-materialized minibatch (Alg. 5 lines
    19-23): the mean squared TD error of the unmasked scores at the taken
    actions, its gradients (:func:`loss_and_grads`), and one Adam step on
    ``params`` and ``opt`` in place (:func:`adam_step`).  Returns (params,
    opt, loss)."""
    loss, grads = loss_and_grads(params, lambda p: td_loss(
        rep.scores(p, state, num_layers=num_layers, masked=False,
                   kernel=kernel, compute=compute), action, target))
    adam_step(params, opt, grads, lr=lr)
    return params, opt, loss


@dataclasses.dataclass
class Agent:
    """The agent's learned state: the policy, its Adam state, the step
    count that drives the epsilon schedule and the host replay of
    ``engine="host"``, which is not ported: ``replay`` stays None unless
    given, and the fused engine, whose replay lives on the device, leaves
    it untouched.  The policy is ``init_policy``'s from a generator seeded
    with 0, or ``params``, which must live on ``device``."""
    cfg: PolicyConfig
    num_nodes: int
    params: Optional[Policy] = None
    opt: Optional[AdamState] = None
    replay: Optional[ReplayBuffer] = None
    step_count: int = 0
    target_mode: str = "fresh"          # "fresh" | "stored" (paper Alg. 5)
    device: DeviceLike = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.target_mode not in ("fresh", "stored"):
            raise ValueError(f"unknown target_mode {self.target_mode!r}")
        if self.params is None:
            self.params = init_policy(
                self.cfg, generator=torch.Generator().manual_seed(0),
                device=self.device)
        elif self.params.device != self.device:
            raise ValueError(f"the policy is on {self.params.device}, the "
                             f"agent on {self.device}")
        if self.opt is None:
            self.opt = adam_init(self.params)

    def epsilon(self) -> float:
        c = self.cfg
        frac = min(1.0, self.step_count / max(1, c.eps_decay_steps))
        return c.eps_start + (c.eps_end - c.eps_start) * frac

    def act(self, state, explore: bool = True):
        raise NotImplementedError(HOST_ENGINE)

    def remember(self, graph_idx, prev_state, action, reward, next_state,
                 done) -> None:
        raise NotImplementedError(HOST_ENGINE)

    def train(self, source, tau: Optional[int] = None, residual=True,
              candidate_fn=None) -> float:
        raise NotImplementedError(HOST_ENGINE)
