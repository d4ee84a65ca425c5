"""Graph learning agent (paper Fig. 1, Alg. 1): the epsilon-greedy deep-Q
agent over the structure2vec + action-evaluation policy.  Counterpart of
``repro/core/agent.py``.

Training follows Alg. 5: each env step runs τ gradient-descent iterations
(§4.5.2) over minibatches that ``GraphRep.state_from_tuples`` (Tuples2Graphs)
re-materializes from compressed replay tuples.  Two engines drive it
(``core.training.train_agent``): the fused step (``core.engine``), whose
replay lives on the device, and the host loop here, ``Agent.act``,
``remember`` and ``train`` over the host ``ReplayBuffer``.  Every random
choice of the host loop is a numpy draw from ``Agent._rng`` (the explore
rolls and picks, the replay indices), as in the JAX package, so with
JAX's weights carried across the two host loops take the same steps.

On a mesh (``cfg.spatial``) every rank runs the host loop SPMD, as JAX's
host loop runs on its mesh: the ranks hold the same numpy streams, so
they draw the same episodes, actions and replay rows; ``act``,
``remember`` and the fresh targets run on the whole states, replicated,
and only the GD step goes through the mesh
(``spatial.spatial_train_minibatch_fn`` on the rank's tile).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..device import DeviceLike, resolve_device
from ..optim import AdamState, adam_init, adam_update
# candidate_mask lives beside its caller, DenseRep.state_from_tuples; it is
# importable from here as from the JAX package's agent
from .graphrep import (CSR, DENSE, SPARSE, GraphRep,  # noqa: F401
                       candidate_mask, rep_for_state)
from .graphs import CsrGraphBatch, SparseGraphBatch
from .mesh import is_multi, make_mesh, normalize_spatial
from .policy import Policy, PolicyConfig, init_policy, policy_scores
from .replay import ReplayBuffer

def host(x) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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


max_q_state = max_q_raw


@torch.no_grad()
def greedy_action_state(params: Policy, state, *, rep: GraphRep,
                        num_layers: int, kernel: str = "fused",
                        compute: str = "f32"):
    """argmax_v Q(s, v) over the candidates (Alg. 1 line 10; the first
    maximum, node 0 where none is left) and the masked scores."""
    s = rep.scores(params, state, num_layers=num_layers, kernel=kernel,
                   compute=compute)
    return torch.argmax(s, dim=-1), s


def _dense_scores(params: Policy, adj, sol, cand, num_layers: int):
    dev = params.device
    return policy_scores(params, *(torch.as_tensor(x, device=dev).to(
        torch.float32) for x in (adj, sol, cand)), num_layers=num_layers)


@torch.no_grad()
def greedy_action(params: Policy, adj, sol, cand, *, num_layers: int):
    """``greedy_action_state`` on dense (B, N, N) arrays."""
    s = _dense_scores(params, adj, sol, cand, num_layers)
    return torch.argmax(s, dim=-1), s


@torch.no_grad()
def max_q(params: Policy, adj, sol, cand, *, num_layers: int):
    """``max_q_state`` on dense (B, N, N) arrays."""
    cand = torch.as_tensor(cand, device=params.device).to(torch.float32)
    return max_q_from_scores(_dense_scores(params, adj, sol, cand,
                                           num_layers), cand)


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


def _rep_for_source(source) -> GraphRep:
    """The backend of a training dataset, by its type: a CSR batch (a
    ``NeighborSampler.training_batch`` among them), padded lists, else a
    dense adjacency stack."""
    if isinstance(source, CsrGraphBatch):
        return CSR
    return SPARSE if isinstance(source, SparseGraphBatch) else DENSE


@dataclasses.dataclass
class Agent:
    """The agent's learned state: the policy, its Adam state, the host
    replay of the host loop and the step count that drives the epsilon
    schedule.  The policy is ``init_policy``'s from a generator seeded
    with 0, or ``params``, which must live on ``device``; the replay is an
    empty ``ReplayBuffer(cfg.replay_capacity, num_nodes)`` unless given
    (numpy's zeros are calloc-backed, so an untouched ring takes no
    resident memory).  The fused engine, whose replay lives on the
    device, leaves ``replay`` untouched."""
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
        if self.replay is None:
            self.replay = ReplayBuffer(self.cfg.replay_capacity,
                                       self.num_nodes)
        self._rng = np.random.default_rng(0)
        self._mesh_steps = {}

    def check_mesh(self, rep: GraphRep, n: int):
        """The mesh of ``cfg.spatial`` for the host loop's GD step on ``rep``
        with ``n`` nodes, or None on one device.  Raises as the fused
        path does without a process group (``spawn_mesh``), for CSR at
        sp > 1, and with JAX's text when the minibatch does not divide by
        dp or the nodes by sp."""
        if not is_multi(self.cfg.spatial):
            return None
        from .engine import _check_csr_spatial
        from .spatial import _check_divisible
        dp, sp = normalize_spatial(self.cfg.spatial)
        _check_csr_spatial(rep, sp)
        mesh = make_mesh(dp, sp)
        _check_divisible(mesh, self.cfg.minibatch, n, "spatial GD")
        return mesh

    def _mesh_step(self, mesh, rep: GraphRep):
        """The cached mesh GD step of ``rep``."""
        fn = self._mesh_steps.get(rep.name)
        if fn is None:
            from .spatial import spatial_train_minibatch_fn
            fn = spatial_train_minibatch_fn(
                mesh, rep=rep, num_layers=self.cfg.num_layers,
                lr=self.cfg.learning_rate, kernel=self.cfg.kernel,
                compute=self.cfg.compute)
            self._mesh_steps[rep.name] = fn
        return fn

    def _policy_kw(self, rep: GraphRep) -> dict:
        return dict(rep=rep, num_layers=self.cfg.num_layers,
                    kernel=self.cfg.kernel, compute=self.cfg.compute)

    # -- acting ------------------------------------------------------------
    def epsilon(self) -> float:
        c = self.cfg
        frac = min(1.0, self.step_count / max(1, c.eps_decay_steps))
        return c.eps_start + (c.eps_end - c.eps_start) * frac

    def act(self, state, explore: bool = True) -> np.ndarray:
        """Batched epsilon-greedy actions (Alg. 1 lines 9-10) on the host,
        on any rep's state.  Exploring, a row rolls ``_rng.random(b)``
        against epsilon, and an exploring row with candidates takes the
        argmax of ``_rng.random((b, n))`` over them, a uniform pick."""
        b, n = state.candidate.shape
        greedy, _ = greedy_action_state(self.params, state,
                                        **self._policy_kw(
                                            rep_for_state(state)))
        greedy = host(greedy)
        if not explore:
            return greedy
        eps = self.epsilon()
        cand = host(state.candidate) > 0.5
        explore_row = (self._rng.random(b) < eps) & cand.any(-1)
        u = self._rng.random((b, n)) * cand
        return np.where(explore_row, np.argmax(u, axis=-1), greedy)

    # -- remembering ---------------------------------------------------------
    def remember(self, graph_idx, prev_state, action, reward, next_state,
                 done) -> None:
        """Store the step's compressed tuples.  ``"stored"`` computes the TD
        target now (Alg. 5 line 12), from ``max_q_state`` on
        ``next_state``; ``"fresh"`` stores (r, S', done) and bootstraps at
        training time with the current policy.  The target is JAX's numpy
        expression on host arrays, so it rounds as JAX's does."""
        reward = host(reward)
        if self.target_mode == "stored":
            nxt = max_q_state(self.params, next_state,
                              **self._policy_kw(rep_for_state(next_state)))
            target = reward + self.cfg.gamma * host(nxt) * (
                1.0 - np.asarray(host(done), np.float32))
        else:
            target = np.zeros_like(reward)
        self.replay.push_batch(host(graph_idx), host(prev_state.solution),
                               host(action), target, reward=reward,
                               next_solution=host(next_state.solution),
                               done=host(done))

    # -- training -----------------------------------------------------------
    def train(self, source, tau: Optional[int] = None, residual=True,
              candidate_fn=None) -> float:
        """τ GD iterations on minibatches sampled from the host replay
        (§4.5.2).  ``source`` is the dataset in any rep (a dense (G, N, N)
        stack, a ``SparseGraphBatch``, or a ``CsrGraphBatch``, e.g.
        ``NeighborSampler.training_batch``'s), on the policy's device;
        ``residual`` and ``candidate_fn`` are the env's (``env.register``).
        Returns the last iteration's loss, or NaN (no draw, no step
        counted) while the replay holds fewer than a minibatch.

        On a mesh every rank calls it with the whole ``source`` on its
        device; each GD iteration's step runs on the rank's tile
        (:meth:`check_mesh` for the refusals)."""
        rep = _rep_for_source(source)
        mesh = self.check_mesh(rep, rep.dataset_shape(source)[1])
        tau = self.cfg.grad_iters if tau is None else tau
        if self.replay.size < self.cfg.minibatch:
            return float("nan")
        kw = self._policy_kw(rep)
        dev = self.params.device
        loss = float("nan")
        for _ in range(tau):
            gi, sol, act, tgt, rew, sol2, done = self.replay.sample(
                self.cfg.minibatch, self._rng)
            if self.target_mode == "fresh":
                st2 = rep.state_from_tuples(source, gi, sol2,
                                            residual=residual,
                                            candidate_fn=candidate_fn)
                nxt = max_q_state(self.params, st2, **kw)
                del st2
                # float64 on the host (1.0 - a bool array), as JAX's
                tgt = rew + self.cfg.gamma * host(nxt) * (1.0 - done)
            act_t = torch.as_tensor(act, device=dev)
            tgt_t = torch.as_tensor(tgt, dtype=torch.float32, device=dev)
            if mesh is None:
                st = rep.state_from_tuples(source, gi, sol,
                                           residual=residual,
                                           candidate_fn=candidate_fn)
                _, _, l = train_minibatch_raw(
                    self.params, self.opt, st, act_t, tgt_t,
                    lr=self.cfg.learning_rate, **kw)
            else:
                from .spatial import tile_state_from_tuples
                st = tile_state_from_tuples(
                    mesh, rep, source, gi, sol, device=dev,
                    residual=residual, candidate_fn=candidate_fn)
                _, _, l = self._mesh_step(mesh, rep)(
                    self.params, self.opt, st, act_t, tgt_t)
            del st
            loss = float(l)
        self.step_count += 1
        return loss
