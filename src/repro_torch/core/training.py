"""The RL training loop (paper Alg. 5).  Counterpart of
``repro/core/training.py``.

``train_agent`` is the episode driver: it picks training graphs, rolls the
env one step per transition and evaluates quality when asked (paper §6.2
learning curves), through either engine.  ``engine="device"`` takes the
fused train step (``core.engine.get_train_step``), whose only read from
the device is its (loss, done) fetch; with ``cfg.spatial`` it trains on
the ``(data, graph)`` mesh, every rank of the process group calling it
with the same arguments.  ``engine="host"`` is the reference loop over
``Agent.act``, the env step, ``Agent.remember`` and ``Agent.train`` on the
host replay, on one device or, SPMD, on every rank of a mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from . import env as env_lib
from .agent import Agent, host
from .engine import (draw_train_step, engine_init, get_train_step,
                     sync_to_agent)
from .graphrep import GraphRep, get_rep
from .inference import solve
from .mesh import (all_reduce_sum, make_mesh, normalize_spatial,
                   shard_dataset)
from .spatial import tile_state_from_tuples


@dataclasses.dataclass
class TrainLog:
    steps: List[int] = dataclasses.field(default_factory=list)
    losses: List[float] = dataclasses.field(default_factory=list)
    approx_ratios: List[float] = dataclasses.field(default_factory=list)
    eval_steps: List[int] = dataclasses.field(default_factory=list)
    episode_lengths: List[int] = dataclasses.field(default_factory=list)
    wall_time: float = 0.0


def evaluate_quality(agent: Agent, test_adj: np.ndarray,
                     reference_sizes: np.ndarray, *,
                     multi_node: bool = False,
                     rep: Union[str, GraphRep, None] = None,
                     problem: str = "mvc") -> float:
    """Mean approximation ratio |RL solution| / |reference| (paper §6.2),
    solved with the agent's policy on its device.  ``reference_sizes``
    come from the caller (``core.solvers``: ``reference_sizes`` for MVC,
    ``heuristic_batch`` for every problem).  For a "max" problem (MIS) a
    ratio below 1 means a smaller set than the reference.  MaxCut assigns
    every positive-degree node, so its |S| says nothing of the policy:
    refused, use ``inference.best_trajectory_cut``."""
    if problem == "maxcut":
        raise ValueError(
            "maxcut quality is not a solution-size ratio (the env assigns "
            "every positive-degree node, so |S| is policy-independent): use "
            "repro_torch.core.inference.best_trajectory_cut instead")
    res = solve(agent.params, test_adj, num_layers=agent.cfg.num_layers,
                multi_node=multi_node,
                rep=rep if rep is not None else agent.cfg.graph_rep,
                problem=problem, engine=agent.cfg.engine,
                kernel=agent.cfg.kernel,
                compute=agent.cfg.compute, device=agent.device)
    return float(np.mean(res.sizes / np.maximum(reference_sizes, 1)))


def train_agent(
    agent: Agent,
    train_adj: np.ndarray,            # (G, N, N) training graph dataset
    *,
    problem: str = "mvc",
    rep: Union[str, GraphRep, None] = None,   # None → agent.cfg.graph_rep
    episodes: int = 50,
    tau: Optional[int] = None,        # GD iterations per env step (§4.5.2)
    batch_graphs: int = 1,            # graphs stepped together per episode
    eval_every: int = 10,             # paper: test every 10 training steps
    eval_fn: Optional[Callable[[Agent], float]] = None,
    max_steps: Optional[int] = None,  # global RL-training-step budget
    seed: int = 0,
    engine: Optional[str] = None,     # None → agent.cfg.engine
) -> TrainLog:
    """Train ``agent`` on its device.  Episode graphs are drawn by numpy's
    ``default_rng(seed)``, as in the JAX package.  The agent's policy and
    Adam state are updated in place.

    ``engine="device"`` (``agent.cfg.engine`` by default) takes the fused
    step: its draws (``engine.draw_train_step``) come from a generator
    seeded with ``seed``, and its replay lives on the device, so
    ``agent.replay`` stays untouched.  ``engine="host"`` is the reference
    loop: ``Agent.act``, the env step, ``Agent.remember`` with host copies
    of the reward and done, then ``Agent.train``; its draws are the
    agent's numpy ``_rng``, as JAX's host loop's, and it reads from the
    device each step's actions, candidates, masks, reward and done, and
    per GD iteration the fresh targets and the loss.

    On a mesh (``agent.cfg.spatial``) every rank of the default process
    group calls ``train_agent`` with the same arguments, as ``solve`` on a
    mesh.  The device engine's ``batch_graphs`` must divide by dp: the
    dataset is checked whole on the host, then each rank keeps its tile on
    its device (``mesh.shard_dataset``), and each episode's state is the
    rank's tile (``spatial.tile_state_from_tuples``); the step's fetch
    reads the whole batch's ``done``, reduced over ``data``.  The host
    engine runs JAX's host loop on every rank: the whole dataset and
    episode states on each, and each GD iteration's step on the rank's
    tile (``Agent.train``)."""
    engine = engine if engine is not None else agent.cfg.engine
    if engine not in ("host", "device"):
        raise ValueError(f"unknown training engine {engine!r}")
    rng = np.random.default_rng(seed)
    rep = get_rep(rep if rep is not None else agent.cfg.graph_rep)
    fused = (get_train_step(agent.cfg, rep=rep, problem=problem, tau=tau,
                            target_mode=agent.target_mode)
             if engine == "device" else None)
    step_fn = env_lib.make(problem)
    residual = env_lib.residual_mode(problem)
    cand_fn = env_lib.candidate_rule(problem)
    dp, sp = normalize_spatial(agent.cfg.spatial)
    # the fused step's mesh; the host loop's GD step takes its own
    mesh = (make_mesh(dp, sp) if (dp, sp) != (1, 1) and fused is not None
            else None)
    if mesh is not None and batch_graphs % dp:
        raise ValueError(f"batch_graphs {batch_graphs} not divisible by the "
                         f"data-axis size {dp} of mesh spec "
                         f"{agent.cfg.spatial!r}")
    source = rep.prepare_dataset(
        train_adj, device="cpu" if mesh is not None else agent.device)
    g_count, n = rep.dataset_shape(source)
    if fused is None:
        agent.check_mesh(rep, n)
    whole = source
    if mesh is not None:
        source = shard_dataset(mesh, whole, device=agent.device)
    es = (engine_init(agent.cfg, agent.params, agent.opt, n, seed=seed,
                      step_count=agent.step_count, mesh=mesh)
          if fused is not None else None)
    log = TrainLog()
    t0 = time.time()
    total_steps = 0
    for _ep in range(episodes):
        # Alg. 5 line 4: random training graph(s)
        gi_host = rng.integers(0, g_count, size=batch_graphs)
        gi = torch.as_tensor(gi_host, device=agent.device)
        if mesh is None:
            state = rep.state_from_tuples(
                source, gi, torch.zeros((batch_graphs, n),
                                        device=agent.device),
                residual=residual, candidate_fn=cand_fn)
        else:
            state = tile_state_from_tuples(
                mesh, rep, whole, gi_host, np.zeros((batch_graphs, n),
                                                    np.float32),
                device=agent.device, residual=residual,
                candidate_fn=cand_fn)
        ep_len = 0
        for _t in range(n):
            if max_steps is not None and total_steps >= max_steps:
                break
            if fused is None:
                loss, state, all_done = _host_step(
                    agent, state, source, gi_host, step_fn, tau, residual,
                    cand_fn)
            else:
                loss, state, all_done = _fused_step(
                    agent, fused, es, state, source, gi, tau, mesh)
            ep_len += 1
            total_steps += 1
            log.steps.append(total_steps)
            log.losses.append(loss)
            if eval_fn is not None and total_steps % eval_every == 0:
                if es is not None:
                    sync_to_agent(agent, es)
                log.eval_steps.append(total_steps)
                log.approx_ratios.append(eval_fn(agent))
            if all_done:
                break
        log.episode_lengths.append(ep_len)
        if max_steps is not None and total_steps >= max_steps:
            break
    if es is not None:
        sync_to_agent(agent, es)
    log.wall_time = time.time() - t0
    return log


def _fused_step(agent, fused, es, state, source, gi, tau, mesh):
    """One fused step; its one read from the device is the loss and how
    many of the batch's graphs are not done.  Returns (loss, state', all
    done)."""
    draws = draw_train_step(agent.cfg, es, state, tau=tau)
    es, state, _act, _rew, done, loss_d = fused(es, state, source, gi, draws)
    left = (~done).sum().to(torch.float32).reshape(1)
    if mesh is not None:
        all_reduce_sum(left, mesh.data)
    fetched = torch.cat([loss_d.reshape(1), left]).cpu()
    return float(fetched[0]), state, bool(fetched[1] == 0)


def _host_step(agent, state, source, gi, step_fn, tau, residual, cand_fn):
    """One step of the host loop (JAX's ``engine="host"`` branch): act,
    the env transition, remember, then τ GD iterations.  Returns (loss,
    state', all done), the stop test on the host copy of ``done``."""
    action = agent.act(state, explore=True)
    new_state, reward, done = step_fn(
        state, torch.as_tensor(action, device=agent.device))
    done = host(done)
    agent.remember(gi, state, action, host(reward), new_state, done)
    loss = agent.train(source, tau=tau, residual=residual,
                       candidate_fn=cand_fn)
    return loss, new_state, bool(done.all())
