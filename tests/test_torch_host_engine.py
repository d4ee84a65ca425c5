"""The port's host engines (``Agent.act``/``remember``/``train``,
``train_agent(engine="host")``, ``solve(engine="host")`` and ``step_fn``)
and the small public helpers against the JAX package's on the CPU: the
same numpy inputs, JAX's weights and Adam state carried across.

Every random choice of the host loop is a numpy draw (the episode graphs
from ``default_rng(seed)``, the explore rolls and picks and the replay
indices from ``Agent._rng``), so the two host loops consume the same
streams in the same order and need no injected draws.

Bars: replay rings bit for bit JAX's; actions and replay contents
identical; losses and parameters within rtol 1e-5 / atol 1e-6
(``tests/test_engine.py``'s bar between JAX's own engines); solves
identical (solutions, evaluations, commits); embeddings within 1e-5."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import Agent as JaxAgent
from repro.core import ReplayBuffer as JaxReplayBuffer
from repro.core import device_replay_from_host as jax_replay_from_host
from repro.core import env as jax_env
from repro.core import evaluate_quality as jax_evaluate_quality
from repro.core import get_rep as jax_get_rep
from repro.core import random_graph_batch
from repro.core import solve as jax_solve
from repro.core import train_agent as jax_train_agent
from repro.core.inference import best_trajectory_cut as jax_best_cut
from repro.core.policy import num_params as jax_num_params
from repro.core.s2v import embed_full as jax_embed_full
from repro_torch.convert import adam_from_numpy, policy_from_numpy
from repro_torch.convert import policy_to_numpy
from repro_torch.core import (Agent, PolicyConfig, ReplayBuffer,
                              best_trajectory_cut, device_replay_from_host,
                              device_replay_init, device_replay_push,
                              draw_train_step, embed_full, engine_init, env,
                              evaluate_quality, get_rep, get_train_step,
                              greedy_action, greedy_action_state,
                              init_policy, init_state, max_q, max_q_state,
                              num_params, solve, solve_step, train_agent)
from repro_torch.core.replay import _FIELDS
from test_torch_sampling import _sampled_source, resident  # noqa: F401
from test_torch_train import (KEYS, STEP_TOL, _cfgs, _pair, _tuples,
                              jax_adam_to_numpy, jax_to_numpy)

REPS = ("dense", "sparse", "csr")
PROBLEMS = ("mvc", "maxcut", "mis", "mds")


def _carried(jcfg, cfg, n, mode="fresh"):
    """A JAX agent and the port's on the CPU with its weights and Adam
    state."""
    jagent = JaxAgent(jcfg, num_nodes=n, target_mode=mode)
    agent = Agent(cfg, num_nodes=n, target_mode=mode, device="cpu",
                  params=policy_from_numpy(jax_to_numpy(jagent.params),
                                           device="cpu"),
                  opt=adam_from_numpy(jax_adam_to_numpy(jagent.opt),
                                      device="cpu"))
    return jagent, agent


def _assert_same_ring(got, want):
    assert (got.size, got._ptr) == (want.size, want._ptr)
    for f in _FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# -- replay -------------------------------------------------------------------

def test_push_sample_and_push_batch_match_jax_with_wraparound():
    cap, n = 10, 6
    rb, jrb = ReplayBuffer(cap, n), JaxReplayBuffer(cap, n)
    for i in range(15):                    # single pushes wrap the ring
        for buf in (rb, jrb):
            buf.push(i % 3, (np.arange(n) + i) % 4 == 0, i % n, float(i),
                     -1.0, (np.arange(n) + i) % 3 == 0, i % 5 == 0)
    for i in range(3):                     # batches cross it twice more
        t = _tuples(4, n, seed=20 + i)
        rb.push_batch(**t)
        jrb.push_batch(**t)
    _assert_same_ring(rb, jrb)
    rb.push(1, np.ones(n), 2, 0.5)         # no S', done: left as zeros
    jrb.push(1, np.ones(n), 2, 0.5)
    _assert_same_ring(rb, jrb)
    for seed in (0, 1):
        got = rb.sample(7, np.random.default_rng(seed))
        want = jrb.sample(7, np.random.default_rng(seed))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert rb.nbytes() == jrb.nbytes()


def test_device_replay_from_host_equals_the_device_ring():
    cap, n, b = 10, 6, 3
    rb = ReplayBuffer(cap, n)
    dev = device_replay_init(cap, n, device="cpu")
    for i in range(5):                     # 15 tuples through a 10-ring
        t = _tuples(b, n, seed=i)
        rb.push_batch(**t)
        device_replay_push(dev, *(torch.from_numpy(np.asarray(t[k])) for k
                                  in ("graph_idx", "solution", "action",
                                      "target", "reward", "next_solution",
                                      "done")))
    up = device_replay_from_host(rb, device="cpu")
    assert (up.size, up.ptr) == (dev.size, dev.ptr) == (rb.size, rb._ptr)
    jup = jax_replay_from_host(rb)
    assert (int(jup.size), int(jup.ptr)) == (up.size, up.ptr)
    for f in _FIELDS:
        assert getattr(up, f).dtype == getattr(dev, f).dtype, f
        assert torch.equal(getattr(up, f), getattr(dev, f)), f
        np.testing.assert_array_equal(getattr(up, f).numpy(),
                                      np.asarray(getattr(jup, f)))
    assert up.nbytes() == dev.nbytes() == rb.nbytes()


def test_replay_compression_memory():
    """§4.4: a tuple stores O(N), never the adjacency."""
    n = 128
    rb = ReplayBuffer(capacity=100, num_nodes=n)
    per_tuple = rb.nbytes() / 100
    assert per_tuple < 16 * n
    assert per_tuple < 4 * n * n / 10
    assert rb.nbytes() == JaxReplayBuffer(100, n).nbytes()


def _mini_agent(n=14, **kw):
    cfg = PolicyConfig(embed_dim=8, num_layers=2, minibatch=4,
                       replay_capacity=64, learning_rate=1e-3, **kw)
    return Agent(cfg, num_nodes=n, device="cpu")


def test_agent_builds_its_host_replay():
    agent = _mini_agent()
    assert isinstance(agent.replay, ReplayBuffer)
    assert (agent.replay.capacity, agent.replay.num_nodes,
            agent.replay.size) == (64, 14, 0)


@pytest.mark.parametrize("rep", REPS)
def test_agent_act_returns_candidates(rep):
    adj = random_graph_batch("er", 14, 3, seed=1, rho=0.3)
    agent = _mini_agent()
    state = get_rep(rep).init_state(adj, device="cpu")
    cand = state.candidate.numpy()
    for _ in range(5):
        acts = agent.act(state)
        assert all(cand[i, a] > 0.5 for i, a in enumerate(acts))


def test_agent_epsilon_decays():
    agent = _mini_agent()
    e0 = agent.epsilon()
    agent.step_count = agent.cfg.eps_decay_steps
    assert agent.epsilon() == pytest.approx(agent.cfg.eps_end)
    assert e0 == pytest.approx(agent.cfg.eps_start)


def test_agent_training_does_not_blow_up():
    adj = random_graph_batch("er", 14, 2, seed=2, rho=0.3)
    agent = _mini_agent()
    state = init_state(adj[:1], device="cpu")
    for _ in range(8):                     # fill the replay with a rollout
        a = agent.act(state)
        ns, r, d = env.mvc_step(state, torch.as_tensor(a))
        agent.remember([0], state, a, r, ns, d)
        state = ns
        if bool(d.all()):
            break
    source = torch.from_numpy(adj)
    l0 = agent.train(source, tau=1)
    for _ in range(30):
        l1 = agent.train(source, tau=1)
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0 * 1.5
    assert agent.step_count == 31


def test_agent_params_change_only_when_trained():
    agent = _mini_agent()
    before = policy_to_numpy(agent.params)
    state0 = agent._rng.bit_generator.state
    assert np.isnan(agent.train(torch.zeros((1, 14, 14))))
    for k, v in policy_to_numpy(agent.params).items():
        np.testing.assert_array_equal(v, before[k])
    assert agent.step_count == 0
    assert agent._rng.bit_generator.state == state0     # nothing drawn


# -- acting and remembering against JAX ---------------------------------------

def _episode_states(rep, n=14, b=3, seed=1):
    adj = random_graph_batch("er", n, b, seed=seed, rho=0.3)
    return adj, jax_get_rep(rep).init_state(jnp.asarray(adj)), \
        get_rep(rep).init_state(adj, device="cpu")


@pytest.mark.parametrize("rep", REPS)
def test_act_explores_as_jax(rep):
    """epsilon 0.5: both agents roll and pick from their ``_rng`` in the
    same order, so every call, explored or greedy, gives JAX's actions."""
    n = 14
    jcfg, cfg = _cfgs(embed_dim=8, eps_start=0.5, eps_end=0.5)
    jagent, agent = _carried(jcfg, cfg, n)
    _, jstate, state = _episode_states(rep, n)
    explored = 0
    greedy = agent.act(state, explore=False)
    for _ in range(6):
        want = jagent.act(jstate, explore=True)
        got = agent.act(state, explore=True)
        np.testing.assert_array_equal(got, want)
        explored += int((got != greedy).sum())
        # the env moves both on, so the later calls act on new states
        jstate, _, _ = jax_env.mvc_step(jstate, jnp.asarray(want))
        state, _, _ = env.mvc_step(state, torch.as_tensor(got))
        greedy = agent.act(state, explore=False)
        np.testing.assert_array_equal(greedy,
                                      jagent.act(jstate, explore=False))
    assert explored >= 3
    assert agent._rng.bit_generator.state == jagent._rng.bit_generator.state


@pytest.mark.parametrize("rep", REPS)
def test_greedy_is_the_first_maximum_of_the_masked_scores(rep):
    n = 14
    _, _, state = _episode_states(rep, n, seed=4)
    agent = _mini_agent()
    r = get_rep(rep)
    act, scores = greedy_action_state(agent.params, state, rep=r,
                                      num_layers=2)
    np.testing.assert_array_equal(agent.act(state, explore=False),
                                  act.numpy())
    np.testing.assert_array_equal(act.numpy(),
                                  np.argmax(scores.numpy(), axis=-1))
    nxt = max_q_state(agent.params, state, rep=r, num_layers=2)
    np.testing.assert_array_equal(nxt.numpy(), scores.numpy().max(-1))


def test_dense_conveniences_match_jax():
    from repro.core.agent import greedy_action as jax_greedy
    from repro.core.agent import max_q as jax_max_q
    n = 14
    jcfg, _ = _cfgs(embed_dim=8)
    params, policy = _pair(jcfg, seed=2)
    adj = random_graph_batch("er", n, 3, seed=5, rho=0.3)
    sol = np.zeros((3, n), np.float32)
    sol[1, :4] = 1.0
    cand = ((adj.sum(-1) > 0) & (sol < 0.5)).astype(np.float32)
    cand[2] = 0.0                          # a row with no candidate
    ja, js = jax_greedy(params, jnp.asarray(adj), jnp.asarray(sol),
                        jnp.asarray(cand), num_layers=2)
    a, s = greedy_action(policy, adj, sol, cand, num_layers=2)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    jq = jax_max_q(params, jnp.asarray(adj), jnp.asarray(sol),
                   jnp.asarray(cand), num_layers=2)
    q = max_q(policy, adj, sol, cand, num_layers=2)
    assert q[2] == 0.0 == float(jq[2])     # no candidate: 0
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["fresh", "stored"])
@pytest.mark.parametrize("rep", REPS)
def test_remember_fills_the_replay_as_jax(rep, mode):
    n = 14
    jcfg, cfg = _cfgs(embed_dim=8, replay_capacity=10)
    jagent, agent = _carried(jcfg, cfg, n, mode)
    _, jstate, state = _episode_states(rep, n)
    gi = np.array([0, 2, 1])
    for _ in range(5):                     # 15 tuples through a 10-ring
        a = jagent.act(jstate)
        np.testing.assert_array_equal(agent.act(state), a)
        jnew, jr, jd = jax_env.mvc_step(jstate, jnp.asarray(a))
        new, r, d = env.mvc_step(state, torch.as_tensor(a))
        jagent.remember(gi, jstate, a, np.asarray(jr), jnew, np.asarray(jd))
        agent.remember(gi, state, a, r, new, d)
        jstate, state = jnew, new
    # the stored target is JAX's numpy expression on host arrays, so it
    # rounds to JAX's f32 values (max Q agrees bit for bit on these graphs)
    assert (jagent.replay.target != 0).any() == (mode == "stored")
    _assert_same_ring(agent.replay, jagent.replay)


def test_stored_target_is_jaxs_f32_expression():
    """The stored target keeps JAX's f32 arithmetic and the fresh target
    its float64 one (``1.0 - done`` on a bool array), rounded once."""
    n = 14
    agent = _mini_agent()
    agent.target_mode = "stored"
    _, _, state = _episode_states("dense", n)
    a = agent.act(state)
    new, r, d = env.mvc_step(state, torch.as_tensor(a))
    d[1] = True
    agent.remember([0, 1, 2], state, a, r, new, d)
    nxt = max_q_state(agent.params, new, rep=get_rep("dense"),
                      num_layers=2).numpy()
    want = r.numpy() + agent.cfg.gamma * nxt * (
        1.0 - np.asarray(d.numpy(), np.float32))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(agent.replay.target[:3], want)
    fresh = r.numpy() + agent.cfg.gamma * nxt * (1.0 - d.numpy())
    assert fresh.dtype == np.float64


# -- the host loop in lockstep with JAX's -------------------------------------

def _host_runs(rep, mode, problem="mvc", n=14, g=4, b=2, mb=8, tau=2,
               steps=8, episodes=2, eps=None):
    """JAX's ``train_agent(engine="host")`` and the port's on the same
    graphs, JAX's weights and Adam state carried across (tests/
    test_engine.py's shapes)."""
    kw = dict(embed_dim=8, num_layers=2, minibatch=mb, replay_capacity=64,
              learning_rate=1e-3, graph_rep=rep)
    if eps is not None:
        kw.update(eps_start=eps, eps_end=eps)
    jcfg, cfg = _cfgs(**kw)
    jagent, agent = _carried(jcfg, cfg, n, mode)
    adj = random_graph_batch("er", n, g, seed=0, rho=0.3)
    run = dict(problem=problem, episodes=episodes, tau=tau, batch_graphs=b,
               max_steps=steps, eval_every=10 ** 9, seed=0, engine="host")
    jlog = jax_train_agent(jagent, adj, **run)
    log = train_agent(agent, adj, **run)
    return (jagent, jlog), (agent, log)


def _assert_host_lockstep(jax_run, port_run, min_warm=4):
    (jagent, jlog), (agent, log) = jax_run, port_run
    assert log.episode_lengths == jlog.episode_lengths
    assert agent.step_count == jagent.step_count
    # actions, masks, rewards, done and the stored targets
    _assert_same_ring(agent.replay, jagent.replay)
    jl, pl = np.asarray(jlog.losses), np.asarray(log.losses)
    warm = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(pl), warm)
    assert warm.sum() >= min_warm
    np.testing.assert_allclose(pl[warm], jl[warm], **STEP_TOL)
    mine, theirs = policy_to_numpy(agent.params), jax_to_numpy(jagent.params)
    for k in KEYS:
        np.testing.assert_allclose(mine[k], theirs[k], **STEP_TOL, err_msg=k)
    assert int(agent.opt.step) == int(jagent.opt.step)


@pytest.mark.parametrize("mode", ["fresh", "stored"])
@pytest.mark.parametrize("rep", REPS)
def test_host_loop_matches_jax(rep, mode):
    jax_run, port_run = _host_runs(rep, mode, steps=10)
    assert port_run[0].replay.size == 20
    _assert_host_lockstep(jax_run, port_run)


@pytest.mark.parametrize("problem,rep,mode", [
    ("maxcut", "sparse", "fresh"), ("mis", "dense", "stored"),
    ("mds", "csr", "fresh")])
def test_host_loop_matches_jax_on_the_other_problems(problem, rep, mode):
    _assert_host_lockstep(*_host_runs(rep, mode, problem, steps=8), 3)


def _drive(agent, state, source, gi, step, steps, tau, kw, jax_side):
    """act → env step → remember → train, ``steps`` times (the body of
    ``train_agent``'s host branch, for a dataset it cannot take)."""
    losses = []
    for _ in range(steps):
        a = agent.act(state)
        if jax_side:
            new, r, d = step(state, jnp.asarray(a))
            r, d = np.asarray(r), np.asarray(d)
        else:
            new, r, d = step(state, torch.as_tensor(a))
        agent.remember(gi, state, a, r, new, d)
        losses.append(agent.train(source, tau=tau, **kw))
        state = new
    return np.asarray(losses)


@pytest.mark.parametrize("mode", ["fresh", "stored"])
def test_agent_train_on_a_sampled_source_matches_jax(
        resident, mode):  # noqa: F811
    """``Agent.train`` on a ``NeighborSampler.training_batch`` (a CSR
    dataset, dispatched by type) against JAX's on JAX's batch."""
    jsource, psource = _sampled_source(resident)
    source = get_rep("csr").prepare_dataset(psource, device="cpu")
    n = source.num_nodes
    jcfg, cfg = _cfgs(embed_dim=8, num_layers=2, minibatch=8,
                      replay_capacity=64, learning_rate=1e-3,
                      graph_rep="csr")
    jagent, agent = _carried(jcfg, cfg, n, mode)
    gi = np.array([0, 3])
    zero = np.zeros((2, n), np.float32)
    jkw = dict(residual=jax_env.residual_mode("mvc"),
               candidate_fn=jax_env.candidate_rule("mvc"))
    kw = dict(residual=env.residual_mode("mvc"),
              candidate_fn=env.candidate_rule("mvc"))
    jl = _drive(jagent, jax_get_rep("csr").state_from_tuples(
        jsource, gi, zero, **jkw), jsource, gi, jax_env.make("mvc"), 8, 2,
        jkw, True)
    pl = _drive(agent, get_rep("csr").state_from_tuples(
        source, gi, zero, **kw), source, gi, env.make("mvc"), 8, 2, kw,
        False)
    _assert_host_lockstep((jagent, _Log(list(jl))), (agent, _Log(list(pl))))


@dataclasses.dataclass
class _Log:
    losses: list = dataclasses.field(default_factory=list)
    episode_lengths: list = dataclasses.field(default_factory=list)


# -- the host loop against the port's fused step ------------------------------

class _Indices:
    """A stand-in for ``Agent._rng`` whose ``integers`` hands out given
    replay indices, in order."""

    def __init__(self, batches):
        self.batches = list(batches)

    def integers(self, low, high, size):
        idx = self.batches.pop(0)
        assert idx.shape == (size,) and int(idx.max()) < high
        return idx


@pytest.mark.parametrize("rep", REPS)
def test_fused_step_matches_host_loop_stored_mode(rep):
    """tests/test_engine.py:129 for the port: the fused step and the host
    loop fed the fused step's replay indices (stored targets, epsilon 0)
    give the same losses and parameters."""
    n, b, mb, tau, steps = 14, 2, 8, 2, 8
    r = get_rep(rep)
    adj = random_graph_batch("er", n, 4, seed=0, rho=0.3)
    cfg = PolicyConfig(embed_dim=8, num_layers=2, minibatch=mb,
                       replay_capacity=64, learning_rate=1e-3,
                       eps_start=0.0, eps_end=0.0, graph_rep=rep)
    source = r.prepare_dataset(adj, device="cpu")
    gi = np.array([0, 2])
    zero = np.zeros((b, n), np.float32)
    residual = env.residual_mode("mvc")

    agent_d = Agent(cfg, num_nodes=n, target_mode="stored", device="cpu")
    fused = get_train_step(cfg, rep=r, tau=tau, target_mode="stored")
    es = engine_init(cfg, agent_d.params, agent_d.opt, n, seed=0)
    state = r.state_from_tuples(source, gi, zero, residual=residual)
    fused_losses, indices = [], []
    for _ in range(steps):
        draws = draw_train_step(cfg, es, state, tau=tau)
        indices += list(draws.sample_idx.numpy())
        es, state, _a, _r, _d, l = fused(es, state, source,
                                         torch.from_numpy(gi), draws)
        fused_losses.append(float(l))

    agent_h = Agent(cfg, num_nodes=n, target_mode="stored", device="cpu")
    agent_h._rng = _Indices(indices)
    state = r.state_from_tuples(source, gi, zero, residual=residual)
    host_losses = []
    for _ in range(steps):
        a = agent_h.act(state, explore=False)
        new, rew, done = env.mvc_step(state, torch.as_tensor(a))
        agent_h.remember(gi, state, a, rew, new, done)
        host_losses.append(agent_h.train(source, tau=tau,
                                         residual=residual))
        state = new
    assert agent_h._rng.batches == []      # every fused index was used
    fl, hl = np.asarray(fused_losses), np.asarray(host_losses)
    warm = np.isfinite(hl)
    np.testing.assert_array_equal(np.isfinite(fl), warm)
    assert warm.sum() >= 4
    np.testing.assert_allclose(fl[warm], hl[warm], **STEP_TOL)
    assert es.step_count == agent_h.step_count
    mine, theirs = policy_to_numpy(es.params), policy_to_numpy(
        agent_h.params)
    for k in KEYS:
        np.testing.assert_allclose(mine[k], theirs[k], **STEP_TOL, err_msg=k)


def test_train_agent_host_and_device_engines_both_learn():
    """tests/test_engine.py:213 for the port."""
    n = 12
    adj = random_graph_batch("er", n, 4, seed=6, rho=0.3)
    for engine in ("host", "device"):
        cfg = PolicyConfig(embed_dim=8, num_layers=2, minibatch=8,
                           replay_capacity=128, learning_rate=1e-3)
        agent = Agent(cfg, num_nodes=n, device="cpu")
        log = train_agent(agent, adj, episodes=3, tau=1, eval_every=10 ** 9,
                          seed=0, engine=engine)
        assert np.isfinite(log.losses[-1]), engine
        assert agent.step_count == int(np.isfinite(log.losses).sum())
        # only the host loop fills the host replay
        assert (agent.replay.size > 0) == (engine == "host")


def test_evaluate_quality_on_the_host_engine_matches_jax():
    n = 12
    jcfg, cfg = _cfgs(embed_dim=8, engine="host")
    jagent, agent = _carried(jcfg, cfg, n)
    adj = random_graph_batch("er", n, 3, seed=8, rho=0.3)
    ref = np.full(3, n // 2)
    want = jax_evaluate_quality(jagent, adj, ref, multi_node=True)
    got = evaluate_quality(agent, adj, ref, multi_node=True)
    assert got == want
    agent.cfg = dataclasses.replace(cfg, engine="device")
    assert evaluate_quality(agent, adj, ref, multi_node=True) == got


# -- the per-evaluation solve -------------------------------------------------

SOLVE_GRAPHS = dict(n=14, b=4, seed=3, rho=0.3)


@pytest.fixture(scope="module")
def solve_pair():
    jcfg, _ = _cfgs(embed_dim=8)
    params, policy = _pair(jcfg, seed=1)
    adj = random_graph_batch("er", SOLVE_GRAPHS["n"], SOLVE_GRAPHS["b"],
                             seed=SOLVE_GRAPHS["seed"],
                             rho=SOLVE_GRAPHS["rho"])
    return params, policy, adj


@pytest.fixture(scope="module")
def jax_host_solves(solve_pair):
    params, _, adj = solve_pair
    return {(rep, problem, multi): jax_solve(
        params, adj, num_layers=2, multi_node=multi, rep=rep,
        problem=problem, engine="host")
        for rep in REPS for problem in PROBLEMS for multi in (False, True)}


def _assert_same_solve(got, want):
    np.testing.assert_array_equal(got.solution, np.asarray(want.solution))
    np.testing.assert_array_equal(got.sizes, np.asarray(want.sizes))
    np.testing.assert_array_equal(got.nodes_committed,
                                  np.asarray(want.nodes_committed))
    assert got.policy_evals == want.policy_evals


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("rep", REPS)
def test_host_solve_matches_jax_and_the_device_engine(solve_pair,
                                                      jax_host_solves, rep,
                                                      problem, multi):
    _, policy, adj = solve_pair
    kw = dict(num_layers=2, multi_node=multi, rep=rep, problem=problem,
              device="cpu")
    got = solve(policy, adj, engine="host", **kw)
    _assert_same_solve(got, jax_host_solves[rep, problem, multi])
    _assert_same_solve(got, solve(policy, adj, engine="device", **kw))
    assert env.checker(problem)(torch.from_numpy(adj),
                                torch.from_numpy(got.solution)).all()


@pytest.mark.parametrize("rep", REPS)
def test_a_step_fn_takes_the_host_loop(solve_pair, rep):
    """As in JAX: a ``step_fn`` with the default engine runs the
    per-evaluation loop, one call an evaluation, and ``max_evals`` caps
    the calls."""
    _, policy, adj = solve_pair
    calls = []
    default = solve_step(rep=get_rep(rep), num_layers=2, use_adaptive=True)

    def counting(p, s):
        calls.append(s.solution.sum().item())
        return default(p, s)
    got = solve(policy, adj, rep=rep, multi_node=True, step_fn=counting,
                device="cpu")
    assert len(calls) == got.policy_evals > 1
    assert calls == sorted(calls)          # one commit after another
    _assert_same_solve(got, solve(policy, adj, rep=rep, multi_node=True,
                                  device="cpu"))
    capped = solve(policy, adj, rep=rep, multi_node=True, max_evals=2,
                   engine="host", device="cpu")
    assert capped.policy_evals == 2
    assert capped.sizes.sum() < got.sizes.sum()


def test_best_trajectory_cut_still_equals_jax(solve_pair):
    params, policy, adj = solve_pair
    for multi in (False, True):
        np.testing.assert_array_equal(
            best_trajectory_cut(policy, adj, multi_node=multi, device="cpu"),
            jax_best_cut(params, adj, multi_node=multi))
    # one graph, as an (N, N) array
    np.testing.assert_array_equal(
        best_trajectory_cut(policy, adj[0], device="cpu"),
        best_trajectory_cut(policy, adj[:1], device="cpu"))


def test_the_mesh_refuses_the_host_engines(solve_pair):
    _, policy, adj = solve_pair
    for kw in (dict(engine="host"), dict(step_fn=lambda p, s: None)):
        with pytest.raises(ValueError, match="fused path only"):
            solve(policy, adj, spatial=(2, 1), device="cpu", **kw)
    cfg = PolicyConfig(embed_dim=8, spatial=(1, 2))
    agent = Agent(cfg, num_nodes=14, device="cpu")
    # the host loop runs on a mesh (tests/test_torch_mesh_host.py); with
    # no process group it asks for the ranks' one, as the fused path does
    for call in (lambda: train_agent(agent, adj, episodes=1,
                                     engine="host"),
                 lambda: agent.train(torch.from_numpy(adj))):
        with pytest.raises(RuntimeError, match="spawn_mesh"):
            call()
    assert agent.step_count == 0 and agent.replay.size == 0
    with pytest.raises(ValueError, match="unknown inference engine"):
        solve(policy, adj, engine="remote", device="cpu")
    with pytest.raises(ValueError, match="unknown training engine"):
        train_agent(agent, adj, engine="remote")


# -- the small public helpers -------------------------------------------------

@pytest.mark.parametrize("k", [8, 32])
def test_num_params_formula(k):
    cfg = PolicyConfig(embed_dim=k)
    policy = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    total = sum(p.numel() for p in policy.parameters())
    jcfg, _ = _cfgs(embed_dim=k)
    assert total == num_params(cfg) == jax_num_params(jcfg) \
        == 4 * k * k + 4 * k


@pytest.mark.parametrize("kernel", ["fused", "xla"])
def test_embed_full_matches_jax(kernel):
    jcfg, _ = _cfgs(embed_dim=8)
    params, policy = _pair(jcfg, seed=4)
    adj = random_graph_batch("er", 16, 2, seed=9, rho=0.3)
    sol = np.zeros((2, 16), np.float32)
    sol[0, ::3] = 1.0
    want = jax_embed_full(params.em, jnp.asarray(adj), jnp.asarray(sol),
                          num_layers=3, kernel=kernel)
    got = embed_full(policy.em, torch.from_numpy(adj), torch.from_numpy(sol),
                     num_layers=3, kernel=kernel)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("problem", PROBLEMS)
def test_env_helpers_match_jax(problem):
    adj = random_graph_batch("er", 12, 2, seed=7, rho=0.3)
    assert env.residual_semantics(problem) \
        == jax_env.residual_semantics(problem)
    st, jst = env.reset(adj, device="cpu"), jax_env.reset(jnp.asarray(adj))
    for f in ("adj", "candidate", "solution"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)))
    a = np.array([3, 5])
    st, _, _ = env.make(problem)(st, torch.as_tensor(a))
    jst, _, _ = jax_env.make(problem)(jst, jnp.asarray(a))
    np.testing.assert_array_equal(env.solution_size(st).numpy(),
                                  np.asarray(jax_env.solution_size(jst)))
