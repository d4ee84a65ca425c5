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


@torch.no_grad()
def greedy_action_state(params: Policy, state, *, rep: GraphRep,
                        num_layers: int, kernel: str = "fused",
                        compute: str = "f32"):
    """argmax_v Q(s, v) over candidates (Alg. 1 line 10), and the scores."""
    s = rep.scores(params, state, num_layers=num_layers, kernel=kernel,
                   compute=compute)
    return torch.argmax(s, dim=-1), s


@torch.no_grad()
def max_q_raw(params: Policy, state, *, rep: GraphRep, num_layers: int,
              kernel: str = "fused", compute: str = "f32") -> torch.Tensor:
    """max_v Q(s', v), 0 where no candidate is left."""
    s = rep.scores(params, state, num_layers=num_layers, kernel=kernel,
                   compute=compute)
    has_cand = state.candidate.sum(-1) > 0
    return torch.where(has_cand, s.amax(-1), torch.zeros_like(s[:, 0]))


def train_minibatch_raw(params: Policy, opt: AdamState, state,
                        action: torch.Tensor, target: torch.Tensor, *,
                        rep: GraphRep, num_layers: int, lr: float,
                        kernel: str = "fused", compute: str = "f32"):
    """One GD iteration on a re-materialized minibatch (Alg. 5 lines
    19-23): the mean squared TD error of the unmasked scores at the taken
    actions, its gradients, and one Adam step on ``params`` and ``opt`` in
    place.  Returns (params, opt, loss).  Its three parts run in
    ``torch.profiler`` ranges: ``train_step.forward``, ``.backward`` and
    ``.adam``."""
    names, tensors = zip(*params.named_parameters())
    with torch.enable_grad():
        with record_function("train_step.forward"):
            s = rep.scores(params, state, num_layers=num_layers,
                           masked=False, kernel=kernel, compute=compute)
            qsa = torch.gather(s, 1, action.long()[:, None])[:, 0]
            loss = torch.mean(torch.square(qsa - target))
        with record_function("train_step.backward"):
            grads = torch.autograd.grad(loss, tensors)
    with record_function("train_step.adam"):
        adam_update(params, dict(zip(names, grads)), opt, lr=lr)
    return params, opt, loss.detach()


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
