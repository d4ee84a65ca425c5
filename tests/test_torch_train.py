"""The port's training slice (repro_torch.optim, core.{replay,agent,engine,
training}, the fused layer's backward) against the JAX package on the
CPU: the same numpy inputs and JAX weights through both.

Bars: Adam within 2 ulp per element over 10 steps; replay and
re-materialized states bit for bit; the fused layer's gradients exactly
autograd's through the plain composition, and within 1e-5 of JAX's vjp;
train steps within rtol 1e-5 / atol 1e-6 of JAX's fused step (the bar
``tests/test_engine.py`` sets between JAX's host loop and fused step)."""
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import DENSE as JAX_DENSE
from repro.core import PolicyConfig as JaxPolicyConfig
from repro.core import ReplayBuffer as JaxReplayBuffer
from repro.core import device_replay_at as jax_replay_at
from repro.core import device_replay_init as jax_replay_init
from repro.core import device_replay_push as jax_replay_push
from repro.core import engine_init as jax_engine_init
from repro.core import get_rep as jax_get_rep
from repro.core import get_train_step as jax_get_train_step
from repro.core import init_policy as jax_init_policy
from repro.core import random_graph_batch
from repro.core import tuples_to_graphs as jax_tuples_to_graphs
from repro.core.agent import candidate_mask as jax_candidate_mask
from repro.core.agent import train_minibatch_raw as jax_train_minibatch
from repro.core.qmodel import NEG_INF
from repro.core.s2v import _dense_layer_jnp
from repro.optim import adam_init as jax_adam_init
from repro.optim import adam_update as jax_adam_update
from repro.optim import clip_by_global_norm as jax_clip
from repro_torch.convert import (adam_from_numpy, adam_to_numpy,
                                 policy_from_numpy, policy_to_numpy)
from repro_torch.core import (DENSE, Agent, PolicyConfig, ReplayBuffer,
                              TrainDraws, candidate_mask, device_replay_at,
                              device_replay_init, device_replay_push,
                              device_replay_sample, draw_train_step,
                              engine_init, env, get_rep, get_train_step,
                              train_agent, tuples_to_graphs)
from repro_torch.core.replay import device_replay_sample_idx
from repro_torch.core.agent import train_minibatch_raw
from repro_torch.core.s2v import _FusedDenseLayer
from repro_torch.kernels.s2v_fused import fused_s2v_layer_plain
from repro_torch.optim import adam_init, adam_update, clip_by_global_norm

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
KEYS = ("em.theta1", "em.theta2", "em.theta3", "em.theta4", "q.theta5",
        "q.theta6", "q.theta7")


def jax_to_numpy(params):
    return {f"{part}.{f.name}": np.asarray(getattr(getattr(params, part),
                                                   f.name))
            for part in ("em", "q")
            for f in dataclasses.fields(getattr(params, part))}


def jax_adam_to_numpy(state):
    return {"step": np.asarray(state.step),
            **{f"mu.{k}": v for k, v in jax_to_numpy(state.mu).items()},
            **{f"nu.{k}": v for k, v in jax_to_numpy(state.nu).items()}}


def ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _cfgs(**kw):
    return JaxPolicyConfig(**kw), PolicyConfig(**kw)


def _pair(cfg, seed=0):
    params = jax_init_policy(jax.random.key(seed), cfg)
    return params, policy_from_numpy(jax_to_numpy(params), device="cpu")


# -- Adam ---------------------------------------------------------------------

def test_adam_matches_jax_within_2_ulp_over_10_steps():
    rng = np.random.default_rng(0)
    params, policy = _pair(JaxPolicyConfig(embed_dim=8))
    jst, st = jax_adam_init(params), adam_init(policy)
    for _ in range(10):
        # gradients over seven decades, as a policy's are
        g = {k: (rng.standard_normal(v.shape) * 10 ** rng.uniform(-6, 1))
             .astype(np.float32) for k, v in jax_to_numpy(params).items()}
        jg = jax.tree.unflatten(jax.tree.structure(params),
                                [jnp.asarray(g[k]) for k in KEYS])
        params, jst = jax_adam_update(params, jg, jst, lr=1e-3)
        adam_update(policy, {k: torch.from_numpy(v) for k, v in g.items()},
                    st, lr=1e-3)
    assert int(st.step) == int(jst.step) == 10
    got, want = policy_to_numpy(policy), jax_to_numpy(params)
    mine, theirs = adam_to_numpy(st), jax_adam_to_numpy(jst)
    for k in KEYS:
        assert ulps(got[k], want[k]) <= 2, k
        assert ulps(mine[f"mu.{k}"], theirs[f"mu.{k}"]) <= 2, k
        assert ulps(mine[f"nu.{k}"], theirs[f"nu.{k}"]) <= 2, k


@pytest.mark.parametrize("max_norm", [1e-3, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(1)
    g = {k: rng.standard_normal((4, 5)).astype(np.float32) for k in "abc"}
    want, wnorm = jax_clip({k: jnp.asarray(v) for k, v in g.items()},
                           max_norm)
    got, norm = clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    assert ulps(norm.numpy(), wnorm) <= 2
    for k in g:
        assert ulps(got[k].numpy(), want[k]) <= 2


# -- replay and re-materialization -----------------------------------------------

def _tuples(b, n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        graph_idx=rng.integers(0, 5, size=b).astype(np.int32),
        solution=(rng.random((b, n)) < 0.3).astype(np.float32),
        action=rng.integers(0, n, size=b).astype(np.int32),
        target=rng.standard_normal(b).astype(np.float32) + seed,
        reward=-np.ones(b, np.float32),
        next_solution=(rng.random((b, n)) < 0.5).astype(np.float32),
        done=rng.random(b) < 0.2)


def test_device_replay_push_wraparound_and_sample_at_match_jax():
    cap, n, b = 10, 6, 3
    jrb = jax_replay_init(cap, n)
    rb = device_replay_init(cap, n, device="cpu")
    for i in range(5):                     # 15 tuples through a 10-ring
        t = _tuples(b, n, seed=i)
        jrb = jax_replay_push(jrb, *t.values())
        device_replay_push(rb, *(torch.from_numpy(np.asarray(v))
                                 for v in t.values()))
    assert (rb.size, rb.ptr) == (int(jrb.size), int(jrb.ptr)) == (10, 5)
    for f in ("graph_idx", "solution", "action", "target", "reward",
              "next_solution", "done"):
        np.testing.assert_array_equal(getattr(rb, f).numpy(),
                                      np.asarray(getattr(jrb, f)), err_msg=f)
    assert rb.nbytes() == jrb.nbytes()
    idx = np.array([0, 3, 3, 9, 7])
    for a, w in zip(device_replay_at(rb, torch.from_numpy(idx)),
                    jax_replay_at(jrb, jnp.asarray(idx))):
        assert a.dtype == getattr(torch, str(np.asarray(w).dtype))
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="exceeds replay capacity"):
        t = _tuples(cap + 1, n, seed=9)
        device_replay_push(rb, *(torch.from_numpy(np.asarray(v))
                                 for v in t.values()))


def test_host_replay_sampling_and_tuples_to_graphs_match_jax():
    cap, n = 16, 5
    jhost, host = JaxReplayBuffer(cap, n), ReplayBuffer(cap, n)
    for i in range(3):                     # 21 tuples through a 16-ring
        t = _tuples(7, n, seed=20 + i)
        jhost.push_batch(**t)
        host.push_batch(**t)
    assert (host.size, host._ptr) == (jhost.size, jhost._ptr)
    assert host.nbytes() == jhost.nbytes()
    idx = np.array([0, 3, 3, 15, 7])
    for a, w in zip(host.sample_at(idx), jhost.sample_at(idx)):
        np.testing.assert_array_equal(a, w)
    dev = device_replay_init(cap, n, device="cpu")
    for i in range(3):
        device_replay_push(dev, *(torch.from_numpy(np.asarray(v)) for v in
                                  _tuples(7, n, seed=20 + i).values()))
    for a, w in zip(device_replay_at(dev, torch.from_numpy(idx)),
                    host.sample_at(idx)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w, a.numpy()
                                                            .dtype))
    gi, sol, *_ = device_replay_sample(dev, torch.Generator().manual_seed(0),
                                       64)
    assert gi.shape == (64,) and sol.shape == (64, n)
    drawn = device_replay_sample_idx(dev, torch.Generator().manual_seed(0),
                                     64)
    assert 0 <= int(drawn.min()) and int(drawn.max()) < dev.size == cap
    adj = random_graph_batch("er", n, 5, seed=1, rho=0.5)
    want = jax_tuples_to_graphs(jnp.asarray(adj), host.graph_idx[idx],
                                host.solution[idx].astype(np.float32))
    got = tuples_to_graphs(torch.from_numpy(adj),
                           torch.from_numpy(host.graph_idx[idx]),
                           torch.from_numpy(host.solution[idx]).float())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("residual", ["solution", "none", "closed"])
def test_state_from_tuples_matches_jax_bit_for_bit(residual):
    adj = random_graph_batch("er", 30, 5, seed=3, rho=0.25)
    t = _tuples(7, 30, seed=4)
    want = JAX_DENSE.state_from_tuples(JAX_DENSE.prepare_dataset(adj),
                                       t["graph_idx"], t["solution"],
                                       residual=residual)
    source = DENSE.prepare_dataset(adj, device="cpu")
    got = DENSE.state_from_tuples(source, torch.from_numpy(t["graph_idx"]),
                                  torch.from_numpy(t["solution"]),
                                  residual=residual)
    for f in ("adj", "candidate", "solution"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(
        candidate_mask(got.adj, got.solution).numpy(),
        np.asarray(jax_candidate_mask(want.adj, want.solution)))
    assert torch.equal(source, torch.from_numpy(adj))    # masked a copy
    # a mesh's train tile takes every mode: on a mesh of one rank (axes of
    # size 1, no communication) it is the state, bit for bit
    from repro_torch.core.mesh import Mesh, single_axis
    from repro_torch.core.spatial import tile_from_tuples
    one = Mesh(1, 1, 0, single_axis("data"), single_axis("graph"))
    tile = tile_from_tuples(one, DENSE, source,
                            torch.from_numpy(t["graph_idx"]),
                            torch.from_numpy(t["solution"]), residual)
    for a, w in ((tile.topology[0], got.adj), (tile.candidate, got.candidate),
                 (tile.solution, got.solution)):
        assert torch.equal(a, w)


# -- the fused layer's backward ----------------------------------------------------

def _layer_inputs(b=2, k=8, n=24, seed=0):
    rng = np.random.default_rng(seed)
    t4 = (rng.standard_normal((k, k)) * 0.3).astype(np.float32)
    embed = np.abs(rng.standard_normal((b, k, n))).astype(np.float32)
    adj = (rng.random((b, n, n)) < 0.3).astype(np.float32)
    base = rng.standard_normal((b, k, n)).astype(np.float32)
    g = rng.standard_normal((b, k, n)).astype(np.float32)
    return t4, embed, adj, base, g


def _grads(fn, t4, embed, adj, base, g):
    ins = [torch.tensor(x, requires_grad=True) for x in (t4, embed, base)]
    out = fn(ins[0], ins[1], torch.from_numpy(adj), ins[2])
    return torch.autograd.grad(out, ins, torch.from_numpy(g))


class _BigAllocations(TorchDispatchMode):
    """Records every non-view op whose output has ``numel`` elements."""

    def __init__(self, numel):
        super().__init__()
        self.numel, self.seen = numel, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and isinstance(out, torch.Tensor) \
                and out.numel() == self.numel:
            self.seen.append(str(func))
        return out


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_fused_layer_backward_is_autograd_of_the_plain_composition(compute):
    t4, embed, adj, base, g = _layer_inputs()
    got = _grads(lambda *a: _FusedDenseLayer.apply(*a, compute),
                 t4, embed, adj, base, g)
    want = _grads(lambda *a: fused_s2v_layer_plain(*a, compute),
                  t4, embed, adj, base, g)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    if compute == "f32":
        # the backward reads adj, and forms no (B, N, N) tensor of its own
        ins = [torch.tensor(x, requires_grad=True) for x in (t4, embed, base)]
        out = _FusedDenseLayer.apply(ins[0], ins[1], torch.from_numpy(adj),
                                     ins[2], compute)
        with _BigAllocations(adj.size) as mode:
            torch.autograd.grad(out, ins, torch.from_numpy(g))
        assert mode.seen == []


def test_fused_layer_backward_matches_jax_vjp():
    t4, embed, adj, base, g = _layer_inputs(b=3, k=16, n=40, seed=1)
    _, vjp = jax.vjp(lambda a, e, b_: _dense_layer_jnp(a, e, adj, b_,
                                                       jnp.float32),
                     t4, embed, base)
    want = vjp(jnp.asarray(g))
    got = _grads(lambda *a: _FusedDenseLayer.apply(*a, "f32"),
                 t4, embed, adj, base, g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_fused_layer_backward_only_what_is_asked():
    t4, embed, adj, base, g = _layer_inputs()
    e = torch.tensor(embed, requires_grad=True)
    out = _FusedDenseLayer.apply(torch.from_numpy(t4), e,
                                 torch.from_numpy(adj),
                                 torch.from_numpy(base), "f32")
    (ge,) = torch.autograd.grad(out, [e], torch.from_numpy(g))
    assert torch.equal(ge, _grads(lambda *a: fused_s2v_layer_plain(*a),
                                  t4, embed, adj, base, g)[1])
    a = torch.tensor(adj, requires_grad=True)
    with pytest.raises(NotImplementedError, match="adjacency"):
        _FusedDenseLayer.apply(torch.from_numpy(t4), e, a,
                               torch.from_numpy(base), "f32").sum().backward()


# -- one GD iteration ---------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["fused", "xla"])
def test_train_minibatch_matches_jax(kernel):
    jcfg, cfg = _cfgs(embed_dim=8)
    params, policy = _pair(jcfg, seed=1)
    adj = random_graph_batch("er", 20, 4, seed=2, rho=0.3)
    t = _tuples(6, 20, seed=5)
    t["graph_idx"] %= 4
    jst = JAX_DENSE.state_from_tuples(JAX_DENSE.prepare_dataset(adj),
                                      t["graph_idx"], t["solution"])
    st = DENSE.state_from_tuples(DENSE.prepare_dataset(adj, device="cpu"),
                                 t["graph_idx"], t["solution"])
    jopt, opt = jax_adam_init(params), adam_init(policy)
    for _ in range(3):
        params, jopt, jl = jax_train_minibatch(
            params, jopt, jst, jnp.asarray(t["action"]),
            jnp.asarray(t["target"]), rep=JAX_DENSE, num_layers=2, lr=1e-3,
            kernel=kernel)
        _, _, loss = train_minibatch_raw(
            policy, opt, st, torch.from_numpy(t["action"]),
            torch.from_numpy(t["target"]), rep=DENSE, num_layers=2, lr=1e-3,
            kernel=kernel)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    got, want = policy_to_numpy(policy), jax_to_numpy(params)
    mine, theirs = adam_to_numpy(opt), jax_adam_to_numpy(jopt)
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], **STEP_TOL, err_msg=k)
    for k in theirs:
        np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-4, atol=1e-9,
                                   err_msg=k)


# -- the fused train step against JAX's ----------------------------------------------

def _lockstep(target_mode, eps, steps=8, n=14, b=2, mb=8, tau=2,
              explore=True, rep="dense", problem="mvc", gi=(0, 2),
              compute="f32", source=None):
    """JAX's fused step and the port's, stepped together on
    tests/test_engine.py's graphs and sizes with JAX's weights, on the
    representation ``rep`` and ``problem`` (its residual mode and
    candidate rule re-materialize the episode's states); each port step
    gets JAX's draws of that step (JAX's key schedule,
    repro/core/engine.py).  ``source``, where given, is the dataset in
    place of those graphs: a pair of CSR batches (JAX's, the port's on the
    CPU) of the same graphs, whose node count replaces ``n``.  Returns the
    two loss traces, the action traces and the count of rows whose roll
    explored, then both policies."""
    kw = dict(embed_dim=8, num_layers=2, minibatch=mb, replay_capacity=64,
              learning_rate=1e-3, eps_start=eps, eps_end=eps,
              compute=compute)
    jcfg, cfg = _cfgs(**kw)
    params, policy = _pair(jcfg)
    jrep, prep = jax_get_rep(rep), get_rep(rep)
    if source is None:
        adj = random_graph_batch("er", n, 4, seed=0, rho=0.3)
        jsource = jrep.prepare_dataset(adj)
        source = prep.prepare_dataset(adj, device="cpu")
    else:
        jsource, source = source[0], prep.prepare_dataset(source[1],
                                                          device="cpu")
        n = source.num_nodes
    gi = np.array(gi)
    zero = np.zeros((b, n), np.float32)
    from repro.core import env as jax_env
    from repro_torch.core import env as port_env
    jkw = dict(residual=jax_env.residual_mode(problem),
               candidate_fn=jax_env.candidate_rule(problem))
    pkw = dict(residual=port_env.residual_mode(problem),
               candidate_fn=port_env.candidate_rule(problem))

    jstep = jax_get_train_step(jcfg, rep=jrep, problem=problem, tau=tau,
                               target_mode=target_mode, explore=explore)
    jes = jax_engine_init(jcfg, params, jax_adam_init(params), n, seed=0)
    jstate = jrep.state_from_tuples(jsource, gi, zero, **jkw)

    step = get_train_step(cfg, rep=prep, problem=problem, tau=tau,
                          target_mode=target_mode, explore=explore)
    es = engine_init(cfg, policy, adam_init(policy), n)
    gi_t = torch.from_numpy(gi)
    state = prep.state_from_tuples(source, gi_t, zero, **pkw)

    key, size = jax.random.key(0), 0
    out = {"jax": ([], []), "port": ([], []), "explored": 0}
    for _ in range(steps):
        key, k_eps, k_pick, k_train = jax.random.split(key, 4)
        logits = jnp.where(jstate.candidate > 0.5, 0.0, NEG_INF)
        size = min(size + b, 64)
        draws = TrainDraws(
            eps_uniform=torch.from_numpy(np.array(
                jax.random.uniform(k_eps, (b,)))),
            pick=torch.from_numpy(np.array(
                jax.random.categorical(k_pick, logits, axis=-1))),
            sample_idx=torch.from_numpy(np.stack([np.asarray(
                jax.random.randint(k, (mb,), 0, max(size, 1)))
                for k in jax.random.split(k_train, tau)])))
        out["explored"] += int((draws.eps_uniform < eps).sum()) * explore
        jes, jstate, ja, _, _, jl = jstep(jes, jstate, jsource,
                                          jnp.asarray(gi, jnp.int32))
        es, state, a, _, _, l = step(es, state, source, gi_t, draws)
        out["jax"][0].append(float(jl))
        out["jax"][1].append(np.asarray(ja))
        out["port"][0].append(float(l))
        out["port"][1].append(a.numpy())
    assert es.step_count == int(jes.step_count)
    return out, jax_to_numpy(jes.params), policy_to_numpy(policy)


def _assert_lockstep(out, want, got):
    np.testing.assert_array_equal(np.stack(out["port"][1]),
                                  np.stack(out["jax"][1]))
    jl, pl = np.asarray(out["jax"][0]), np.asarray(out["port"][0])
    warm = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(pl), warm)
    assert warm.sum() >= 4
    np.testing.assert_allclose(pl[warm], jl[warm], **STEP_TOL)
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], **STEP_TOL, err_msg=k)


def test_stored_mode_greedy_step_matches_jax():
    out, want, got = _lockstep("stored", eps=0.0)
    _assert_lockstep(out, want, got)


def test_fresh_mode_exploring_step_matches_jax_with_its_draws():
    out, want, got = _lockstep("fresh", eps=0.5)
    assert out["explored"] >= 4              # rows that took JAX's picks
    _assert_lockstep(out, want, got)


def test_step_without_exploration_matches_jax():
    # epsilon 1: every row would take its pick, were exploring on
    out, want, got = _lockstep("fresh", eps=1.0, explore=False)
    assert out["explored"] == 0
    _assert_lockstep(out, want, got)


def test_draw_train_step_draws_candidates_and_warm_indices():
    n, b, mb, tau = 12, 4, 8, 3
    cfg = PolicyConfig(embed_dim=8, minibatch=mb, replay_capacity=10)
    adj = random_graph_batch("er", n, 2, seed=4, rho=0.3)
    source = DENSE.prepare_dataset(adj, device="cpu")
    agent = Agent(cfg, num_nodes=n, device="cpu")
    es = engine_init(cfg, agent.params, agent.opt, n, seed=3)
    sol = np.zeros((b, n), np.float32)
    sol[0] = 1.0                             # row 0 has no candidate
    sol[1, ::2] = 1.0
    state = DENSE.state_from_tuples(source, torch.tensor([0, 1, 0, 1]), sol)
    sizes = []
    for _ in range(4):                       # replay sizes 4, 8, 10, 10
        d = draw_train_step(cfg, es, state, tau=tau)
        size = min(es.replay.size + b, 10)
        sizes.append(size)
        assert d.eps_uniform.shape == d.pick.shape == (b,)
        assert ((0 <= d.eps_uniform) & (d.eps_uniform < 1)).all()
        assert int(d.pick[0]) == 0
        assert (state.candidate[torch.arange(1, b), d.pick[1:]] == 1).all()
        assert d.sample_idx.shape == ((tau if size >= mb else 0), mb)
        assert d.sample_idx.numel() == 0 or int(d.sample_idx.max()) < size
        device_replay_push(es.replay, torch.zeros(b, dtype=torch.int32),
                           state.solution, d.pick, torch.zeros(b),
                           torch.zeros(b), state.solution, torch.zeros(b))
    assert sizes == [4, 8, 10, 10]
    twins = [draw_train_step(cfg, engine_init(cfg, agent.params, agent.opt,
                                              n, seed=3), state, tau=tau)
             for _ in range(2)]
    for f in ("eps_uniform", "pick", "sample_idx"):
        assert torch.equal(getattr(twins[0], f), getattr(twins[1], f))
    step = get_train_step(cfg, tau=tau)
    with pytest.raises(ValueError, match="replay indices"):
        step(es, state, source, torch.tensor([0, 1, 0, 1]),
             dataclasses.replace(d, sample_idx=d.sample_idx[:1]))
    assert es.replay.size == 10 and es.replay.ptr == 6   # nothing pushed


# -- the driver and what is refused ------------------------------------------------

def test_train_agent_trains_on_the_cpu():
    n = 12
    adj = random_graph_batch("er", n, 4, seed=5, rho=0.3)
    cfg = PolicyConfig(embed_dim=8, num_layers=2, minibatch=8,
                       replay_capacity=128, learning_rate=1e-3)
    host = ReplayBuffer(cfg.replay_capacity, n)
    agent = Agent(cfg, num_nodes=n, device="cpu", replay=host)
    assert Agent(cfg, num_nodes=n, device="cpu").replay.size == 0
    before = {k: v.copy() for k, v in policy_to_numpy(agent.params).items()}
    log = train_agent(agent, adj, episodes=4, tau=2, eval_every=10 ** 9,
                      seed=0)
    losses = np.asarray(log.losses)
    assert np.isfinite(losses[-1])
    assert agent.step_count == int(np.isfinite(losses).sum()) > 0
    assert int(agent.opt.step) == 2 * agent.step_count
    assert any(not np.array_equal(v, before[k])
               for k, v in policy_to_numpy(agent.params).items())
    # the replay lives on the device
    assert agent.replay is host and host.size == 0
    assert sum(log.episode_lengths) == len(log.losses)


def test_train_agent_evaluates_through_the_ports_solve():
    from repro_torch.core import evaluate_quality
    n = 12
    adj = random_graph_batch("er", n, 3, seed=6, rho=0.3)
    agent = Agent(PolicyConfig(embed_dim=8, minibatch=4), num_nodes=n,
                  target_mode="stored", device="cpu")
    log = train_agent(agent, adj, episodes=2, eval_every=3, seed=1,
                      eval_fn=lambda a: evaluate_quality(
                          a, adj, np.full(3, n)))
    assert log.eval_steps == list(range(3, len(log.losses) + 1, 3))
    assert all(0 < r <= 1 for r in log.approx_ratios)


def test_unported_training_is_refused():
    n = 10
    adj = random_graph_batch("er", n, 2, seed=0, rho=0.3)
    cfg = PolicyConfig(embed_dim=8)
    agent = Agent(cfg, num_nodes=n, device="cpu")
    # the host loop runs on one device (tests/test_torch_host_engine.py)
    log = train_agent(agent, adj, episodes=1, engine="host")
    assert len(log.losses) > 0 and agent.replay.size == len(log.losses)
    # and so do its parts: act, remember and train on the host replay
    state = DENSE.init_state(adj, device="cpu")
    action = agent.act(state)
    assert state.candidate[torch.arange(2), action].all()
    new, reward, done = env.mvc_step(state, torch.as_tensor(action))
    size = agent.replay.size
    agent.remember([0, 1], state, action, reward, new, done)
    assert agent.replay.size == size + 2
    assert math.isnan(agent.train(torch.from_numpy(adj))) == (
        agent.replay.size < cfg.minibatch)
    # the other problems train on one device
    # (tests/test_torch_problems_train.py) and on a mesh, whose ranks they
    # ask for as mvc does (tests/test_torch_problems_mesh.py)
    for problem in ("mis", "maxcut"):
        with pytest.raises(RuntimeError, match="spawn_mesh"):
            get_train_step(dataclasses.replace(cfg, spatial=(1, 2)),
                           problem=problem)
        log = train_agent(agent, adj, episodes=1, problem=problem)
        assert len(log.losses) > 0
    # a mesh config builds its step on the ranks of a process group
    # (tests/test_torch_mesh_train.py); here there is none
    with pytest.raises(RuntimeError, match="spawn_mesh"):
        get_train_step(dataclasses.replace(cfg, spatial=(1, 2)))
    with pytest.raises(ValueError, match="unknown environment"):
        get_train_step(cfg, problem="tsp")
    with pytest.raises(ValueError, match="target_mode"):
        Agent(cfg, num_nodes=n, device="cpu", target_mode="late")


# -- the optimizer carried across ----------------------------------------------------

def test_adam_state_round_trips_and_resumes_jax_training():
    jcfg, cfg = _cfgs(embed_dim=8)
    params, _ = _pair(jcfg, seed=3)
    adj = random_graph_batch("er", 16, 3, seed=7, rho=0.3)
    t = _tuples(5, 16, seed=8)
    t["graph_idx"] %= 3
    jst = JAX_DENSE.state_from_tuples(JAX_DENSE.prepare_dataset(adj),
                                      t["graph_idx"], t["solution"])
    act, tgt = jnp.asarray(t["action"]), jnp.asarray(t["target"])
    jopt = jax_adam_init(params)
    for _ in range(4):                       # JAX mid-training
        params, jopt, _ = jax_train_minibatch(
            params, jopt, jst, act, tgt, rep=JAX_DENSE, num_layers=2,
            lr=1e-3)
    arrays = jax_adam_to_numpy(jopt)
    opt = adam_from_numpy(arrays, device="cpu")
    back = adam_to_numpy(opt)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    policy = policy_from_numpy(jax_to_numpy(params), device="cpu")
    params, jopt, jl = jax_train_minibatch(
        params, jopt, jst, act, tgt, rep=JAX_DENSE, num_layers=2, lr=1e-3)
    _, opt, loss = train_minibatch_raw(
        policy, opt, DENSE.state_from_tuples(
            DENSE.prepare_dataset(adj, device="cpu"), t["graph_idx"],
            t["solution"]),
        torch.from_numpy(t["action"]), torch.from_numpy(t["target"]),
        rep=DENSE, num_layers=2, lr=1e-3)
    assert int(opt.step) == int(jopt.step) == 5
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    got, want = policy_to_numpy(policy), jax_to_numpy(params)
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], **STEP_TOL, err_msg=k)
    with pytest.raises(KeyError, match="missing"):
        adam_from_numpy({"step": 1}, device="cpu")
