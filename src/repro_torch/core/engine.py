"""Device engines: the fused train step (paper Alg. 5) and the fused solve
loop (Alg. 4).  Counterpart of ``repro/core/engine.py``.

``get_train_step`` mirrors ``train_step``: epsilon-greedy acting, the env
transition, the TD target at insertion time (``stored``, Alg. 5 line 12)
or deferred (``fresh``), the replay push into the on-device ring
(``core.replay.DeviceReplay``) and τ GD iterations over re-materialized
minibatches once the replay is warm.  The JAX step is one jitted call;
here it is a Python function that queues device work and reads nothing
back from the device: the replay's size and the step count are host ints,
and the caller makes the step's one fetch (``training.train_agent``).  It
runs on the dense, sparse and CSR reps, for every problem, on one device
and on every rank of a ``(data, graph)`` mesh (``cfg.spatial``; CSR at
sp = 1): each
rank acts on its state tile with the spatial scorer, pushes into its tile
of the one global replay, and takes the mesh GD step
(``spatial.manual_train_minibatch_fn``).

``torch.Generator`` cannot replay JAX's threefry key schedule, so each step
takes its random draws (:class:`TrainDraws`) as an argument:
:func:`draw_train_step` makes them from the engine's generator (what
``train_agent`` does), and a parity test injects JAX's.

``get_solve_step``'s body is one jitted ``lax.while_loop`` in JAX; here it
is a Python loop with the same stop rule, on one device or on every rank
of a ``(data, graph)`` mesh.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..optim import AdamState
from . import env as env_lib
from .agent import max_q_from_scores, max_q_raw, train_minibatch_raw
from .graphrep import GraphRep, get_rep
from .inference import check_solve_options, solve_step
from .mesh import (Mesh, MeshSpec, all_reduce_max, make_mesh,
                   normalize_spatial)
from .policy import Policy, PolicyConfig
from .replay import (DeviceReplay, device_replay_at, device_replay_init,
                     device_replay_push)
from .spatial import manual_train_minibatch_fn, spatial_solve_scores_fn


@dataclasses.dataclass
class EngineState:
    """What Alg. 5 mutates per step: the policy and its Adam state (updated
    in place), the device replay, the generator of the step's draws (on
    the policy's device) and the step count that drives epsilon."""
    params: Policy
    opt: AdamState
    replay: DeviceReplay
    generator: torch.Generator
    step_count: int = 0


@dataclasses.dataclass
class TrainDraws:
    """One step's random draws: the epsilon-roll uniforms (B,), the
    exploratory picks (B,) (node ids; only rows that explore use theirs)
    and the replay indices of the τ GD iterations (τ, minibatch; no rows
    on a step that is not warm).  All on the step's device.  On a mesh
    every rank holds the whole batch's draws and takes its B/dp rows."""
    eps_uniform: torch.Tensor
    pick: torch.Tensor
    sample_idx: torch.Tensor


def engine_init(cfg: PolicyConfig, params: Policy, opt: AdamState,
                num_nodes: int, *, seed: int = 0, step_count: int = 0,
                mesh: Optional[Mesh] = None) -> EngineState:
    """A fresh training carry on the policy's device.  It shares ``params``
    and ``opt`` (the step updates them in place).  With ``mesh`` (the
    cfg's mesh, on every rank) the replay is this rank's tile of the ring:
    tuple rows over ``data``, the masks also over ``graph``; the generator
    has the same seed on every rank."""
    dev = params.device
    return EngineState(
        params=params, opt=opt,
        replay=device_replay_init(cfg.replay_capacity, num_nodes,
                                  device=dev, mesh=mesh),
        generator=torch.Generator(device=dev).manual_seed(seed),
        step_count=step_count)


def draw_train_step(cfg: PolicyConfig, es: EngineState, state, *,
                    tau: Optional[int] = None) -> TrainDraws:
    """The draws of the step ``es`` takes next from ``state``, from the
    engine's generator, with no read from the device.  A row's pick is the
    argmax of uniforms over its candidates (a uniform candidate; a row
    with none picks node 0, which the step never takes).  The indices are
    uniform below the replay's size after the step's push, drawn only if
    that size makes the step warm.  On a mesh (``es``'s replay is a tile)
    every rank draws the whole batch's stream, one device's draws from the
    same seed, and picks for its own B/dp rows from its tile's candidates
    (the other rows' picks are 0, unused there)."""
    tau = cfg.grad_iters if tau is None else tau
    b, n = state.candidate.shape
    mesh = es.replay.mesh
    rows = slice(None)
    if mesh is not None:
        rows = mesh.data.rows(b * mesh.dp)
        b *= mesh.dp
    gen, dev = es.generator, state.candidate.device
    with record_function("train_step.draw"):
        eps_uniform = torch.rand((b,), generator=gen, device=dev)
        u = torch.rand((b, n), generator=gen, device=dev)
        pick = torch.argmax(torch.where(state.candidate > 0.5, u[rows],
                                        -1.0), dim=-1)
        if mesh is not None:
            whole = torch.zeros((b,), dtype=pick.dtype, device=dev)
            whole[rows] = pick
            pick = whole
        size = min(es.replay.size + b, es.replay.capacity)
        iters = tau if size >= cfg.minibatch else 0
        sample_idx = torch.randint(0, max(size, 1), (iters, cfg.minibatch),
                                   generator=gen, device=dev)
    return TrainDraws(eps_uniform, pick, sample_idx)


def sync_to_agent(agent, es: EngineState) -> None:
    """The carry's learned state onto an ``Agent`` (for eval, resuming)."""
    agent.params, agent.opt = es.params, es.opt
    agent.step_count = es.step_count


def epsilon_f32(cfg: PolicyConfig, step_count: int) -> float:
    """The epsilon schedule in f32, as the JAX step computes it, so that
    injected JAX uniforms compare against the same threshold."""
    frac = np.minimum(np.float32(1.0), np.float32(step_count)
                      / np.float32(max(1, cfg.eps_decay_steps)))
    return float(np.float32(cfg.eps_start)
                 + np.float32(cfg.eps_end - cfg.eps_start) * frac)


def check_train_options(cfg: PolicyConfig, problem: str,
                        rep: GraphRep) -> None:
    """Refuse what the port does not train: an unknown problem, then on a
    mesh JAX's refusals: a minibatch the data axis does not divide, CSR at
    sp > 1, ``collectives="manual"`` with CSR.  The port has one explicit
    mesh GD path, which "auto" and "manual" select; "gspmd" (JAX's staged
    reference path) is refused."""
    env_lib.make(problem)
    dp, sp = normalize_spatial(cfg.spatial)
    if (dp, sp) == (1, 1):
        return
    if cfg.minibatch % dp:
        raise ValueError(f"minibatch {cfg.minibatch} not divisible by the "
                         f"data-axis size {dp} of mesh spec {cfg.spatial!r}")
    _check_csr_spatial(rep, sp)
    if rep.name == "csr" and cfg.collectives == "manual":
        raise ValueError(
            "collectives='manual' does not apply to rep='csr': csr shards "
            "the batch only (sp == 1) and trains on the plain data-parallel "
            "step, which never replicates an operand; leave "
            "collectives='auto'")
    if cfg.collectives == "gspmd":
        raise ValueError(
            "collectives='gspmd' selects the JAX package's staged GSPMD "
            "reference path, which the port has no counterpart of: it "
            "trains every mesh shape on its explicit collectives; leave "
            "collectives='auto' (or 'manual')")


def get_train_step(cfg: PolicyConfig, *,
                   rep: Union[str, GraphRep, None] = None,
                   problem: str = "mvc", tau: Optional[int] = None,
                   target_mode: str = "fresh", explore: bool = True):
    """The fused train step for a configuration.

    Returns ``step(es, state, source, graph_idx, draws) -> (es, state',
    action, reward, done, loss)``: ``source`` is the dataset
    (``rep.prepare_dataset``), ``graph_idx`` the (B,) episode graph ids on
    its device, ``draws`` the step's :class:`TrainDraws`
    (:func:`draw_train_step`); ``es`` is updated in place and returned.
    With ``explore=False`` every action is greedy and the draws' rolls and
    picks go unused.  ``loss`` is the
    last GD iteration's, NaN on a step whose replay is not yet warm (fewer
    than ``cfg.minibatch`` tuples); ``es.step_count`` advances only on warm
    steps.  Every policy evaluation runs the fused layer (on the card, its
    kernel): one to act, one for the stored target, and per GD iteration
    one for the fresh target and one for the loss.  Its parts run in
    ``torch.profiler`` ranges named ``train_step.<part>``: act (with the
    env transition), target, rematerialize, and the minibatch step's
    forward, backward and adam (and draw, in :func:`draw_train_step`).

    On a mesh (``cfg.spatial``) every rank of the process group calls the
    step with its own tiles: ``es`` from ``engine_init(mesh=)``, ``state``
    its episode tile (``spatial.tile_state_from_tuples``: its B/dp graphs,
    its N/sp topology rows, the masks whole), ``source`` its dataset tile
    (``mesh.shard_dataset``), and the whole batch's ``graph_idx`` and
    ``draws``, of which it takes its rows.  It acts with the spatial
    scorer (sp > 1; the single-device one on its rows at sp = 1), pushes
    into the sharded ring and runs each GD iteration as
    ``spatial.manual_train_minibatch_fn``, whose world all-reduce (range
    ``train_step.allreduce``) keeps the ranks' parameters equal bit for
    bit.  ``action``, ``reward`` and ``done`` are the rank's rows;
    ``loss`` is the whole minibatch's, on every rank."""
    rep = get_rep(rep if rep is not None else cfg.graph_rep)
    check_train_options(cfg, problem, rep)
    if target_mode not in ("fresh", "stored"):
        raise ValueError(f"unknown target_mode {target_mode!r}")
    tau = cfg.grad_iters if tau is None else tau
    step_fn = env_lib.make(problem)
    residual = env_lib.residual_mode(problem)
    cand_fn = env_lib.candidate_rule(problem)
    gamma, mb = cfg.gamma, cfg.minibatch
    policy_kw = dict(rep=rep, num_layers=cfg.num_layers, kernel=cfg.kernel,
                     compute=cfg.compute)
    stored = target_mode == "stored"
    dp, sp = normalize_spatial(cfg.spatial)
    mesh = manual_gd = None
    score_fn = functools.partial(rep.scores, num_layers=cfg.num_layers,
                                 kernel=cfg.kernel, compute=cfg.compute)
    if (dp, sp) != (1, 1):
        mesh = make_mesh(dp, sp)
        manual_gd = manual_train_minibatch_fn(
            mesh, rep=rep, num_layers=cfg.num_layers, lr=cfg.learning_rate,
            gamma=gamma, minibatch=mb, residual=residual,
            candidate_fn=cand_fn, target_mode=target_mode,
            kernel=cfg.kernel, compute=cfg.compute)
        if sp > 1:
            score_fn = spatial_solve_scores_fn(
                mesh, num_layers=cfg.num_layers, rep=rep,
                residual=env_lib.sparse_residual_flag(problem),
                kernel=cfg.kernel, compute=cfg.compute)

    def train_step(es: EngineState, state, source, graph_idx: torch.Tensor,
                   draws: TrainDraws):
        if (es.replay.mesh is None) != (mesh is None):
            raise ValueError(f"the engine's replay and the step's spatial="
                             f"{cfg.spatial!r} disagree: engine_init(mesh="
                             f"...) takes the config's mesh")
        # warm once the push below leaves ``mb`` tuples in the replay
        b = state.candidate.shape[0] * dp
        rows = mesh.data.rows(b) if mesh is not None else slice(None)
        warm = min(es.replay.size + b, es.replay.capacity) >= mb
        if warm and tuple(draws.sample_idx.shape) != (tau, mb):
            raise ValueError(f"a warm step needs ({tau}, {mb}) replay "
                             f"indices, got {tuple(draws.sample_idx.shape)}")

        # -- act (Alg. 1 lines 9-10) --------------------------------------
        with record_function("train_step.act"):
            with torch.no_grad():
                action = torch.argmax(score_fn(es.params, state), dim=-1)
            if explore:
                roll = draws.eps_uniform[rows] < epsilon_f32(cfg,
                                                             es.step_count)
                has_cand = (state.candidate > 0.5).any(-1)
                action = torch.where(roll & has_cand,
                                     draws.pick[rows].long(), action)

            # -- env transition -------------------------------------------
            new_state, reward, done = step_fn(state, action)

        # -- remember (Alg. 5 lines 11-13) --------------------------------
        if stored:
            with record_function("train_step.target"), torch.no_grad():
                nxt = max_q_from_scores(score_fn(es.params, new_state),
                                        new_state.candidate)
                target = reward + gamma * nxt * (1.0 - done.to(torch.float32))
        else:
            target = torch.zeros_like(reward)
        device_replay_push(es.replay, graph_idx[rows], state.solution,
                           action, target, reward, new_state.solution, done)

        # -- τ GD iterations (Alg. 5 lines 15-23, §4.5.2) ------------------
        loss = torch.full((), float("nan"), device=reward.device)
        for t in range(tau if warm else 0):
            if manual_gd is not None:
                _, _, loss = manual_gd(es.params, es.opt, es.replay, source,
                                       draws.sample_idx[t])
                continue
            gi, sol, act, tgt, rew, sol2, dn = device_replay_at(
                es.replay, draws.sample_idx[t])
            if not stored:
                with record_function("train_step.rematerialize"):
                    st2 = rep.state_from_tuples(source, gi, sol2,
                                                residual=residual,
                                                candidate_fn=cand_fn)
                with record_function("train_step.target"):
                    nxt = max_q_raw(es.params, st2, **policy_kw)
                    tgt = rew + gamma * nxt * (1.0 - dn)
                # one minibatch state alive at a time: the dense rep's
                # (B, N, N) copy is 4.3 GB at B = 64, N = 4096, the CSR
                # rep's arrays 20.1 GB at B = 64 of ER(20480, 0.15)
                del st2
            with record_function("train_step.rematerialize"):
                st = rep.state_from_tuples(source, gi, sol,
                                           residual=residual,
                                           candidate_fn=cand_fn)
            _, _, loss = train_minibatch_raw(es.params, es.opt, st, act, tgt,
                                             lr=cfg.learning_rate,
                                             **policy_kw)
            del st
        es.step_count += int(warm)
        return es, new_state, action, reward, done, loss

    return train_step


def _check_csr_spatial(rep: GraphRep, sp: int) -> None:
    """CSR has no spatial (graph-axis) sharding path: its flat edge arrays
    are row-ragged, so an N/sp node split gives unequal per-rank edge
    counts, unlike the dense row blocks and padded neighbour-list rows."""
    if rep.name == "csr" and sp > 1:
        raise ValueError(
            f"rep='csr' does not support spatial (graph-axis) sharding "
            f"sp={sp}: CSR rows are ragged, so node-partitioned blocks would "
            f"carry unequal edge counts. Use spatial=(dp, 1) for data "
            f"parallelism with csr, or rep='sparse'/'dense' for sp>1 graph "
            f"partitioning.")


def get_solve_step(*, rep: Union[str, GraphRep, None] = None,
                   problem: str = "mvc", num_layers: int = 2,
                   use_adaptive: bool = False, spatial: MeshSpec = 0,
                   kernel: str = "fused", compute: str = "f32",
                   max_d: int = 8, step: Optional[Callable] = None):
    """Returns ``solve_fn(params, state, max_evals) -> (final_state,
    evals, committed)``: score → top-d commit → done check, repeated.

    ``step(params, state) -> (state, done, ncommit)`` replaces the score
    and commit of one evaluation (default :func:`inference.solve_step`);
    it is what ``solve``'s ``step_fn`` drives, on one device only.

    The stop rule is the ``lax.while_loop``'s: evaluate while some graph
    is not done and ``evals < max_evals``; ``done`` starts all False, so
    the first evaluation always runs (for ``max_evals >= 1``).

    ``spatial`` selects the 2-D ``(data, graph)`` mesh (an int P means
    ``(1, P)``): every rank runs the loop on its state tile
    (``mesh.shard_state``), each evaluation partitioned sp ways over
    ``graph`` (``spatial.spatial_solve_scores_fn``; CSR, at sp = 1 only,
    scores its data rank's graphs on one device), and the stop rule's
    ``done`` read is reduced over the mesh, so every rank runs the same
    number of evaluations.  ``final_state`` and ``committed`` are the
    rank's own B/dp rows.

    ``solve_fn`` consumes ``state``: the dense commit updates its
    adjacency in place (the counterpart of the JAX solve donating its
    state).  Every caller builds the state fresh for the solve."""
    check_solve_options("device", spatial, step)
    env_lib.make(problem)
    rep = get_rep(rep)
    dp, sp = normalize_spatial(spatial)
    mesh = None
    if (dp, sp) != (1, 1):
        _check_csr_spatial(rep, sp)
        mesh = make_mesh(dp, sp)
    if step is None:
        score_fn = None
        if mesh is not None and rep.name != "csr":
            score_fn = spatial_solve_scores_fn(
                mesh, num_layers=num_layers, rep=rep,
                residual=env_lib.sparse_residual_flag(problem),
                kernel=kernel, compute=compute)
        step = solve_step(rep=rep, problem=problem, num_layers=num_layers,
                          use_adaptive=use_adaptive, kernel=kernel,
                          compute=compute, max_d=max_d, score_fn=score_fn)

    @torch.no_grad()
    def solve_fn(params, state, max_evals: int):
        b = state.candidate.shape[0]
        evals = 0
        committed = torch.zeros((b,), dtype=torch.int32,
                                device=state.candidate.device)
        while evals < max_evals:
            state, done, ncommit = step(params, state)
            evals += 1
            committed += ncommit.to(torch.int32)
            # One host read of `done` per evaluation: it waits for the
            # device.  A CUDA graph, or checking every k evaluations, would
            # remove this round trip; that is later work.
            pending = (~done).any().to(torch.int32).reshape(1)
            if mesh is not None:
                # done is the same on every rank of a graph axis: the max
                # over `data` is the whole batch's, as JAX's ~done.all()
                all_reduce_max(pending, mesh.data)
            if not bool(pending):
                break
        return state, evals, committed

    return solve_fn
