"""Training on the padded-sparse and CSR representations against the JAX
package on the CPU: the layers' closed-form backwards, re-materialized
states and the fused train step, from the same numpy inputs and JAX
weights.

Bars: the backwards within 1e-5 (f32) and 2e-2 (bf16) of autograd
through the plain compositions and of ``jax.vjp`` through JAX's;
re-materialized states bit for bit; train steps within rtol 1e-5 /
atol 1e-6 of JAX's fused step with identical actions (the bar
``tests/test_engine.py`` sets between JAX's host loop and fused step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import get_rep as jax_get_rep
from repro.core.agent import train_minibatch_raw as jax_train_minibatch
from repro.core.s2v_csr import _csr_layer_jnp
from repro.core.s2v_sparse import _sparse_layer_jnp
from repro.optim import adam_init as jax_adam_init
from repro_torch.convert import adam_to_numpy, policy_to_numpy
from repro_torch.core import (Agent, PolicyConfig, TrainDraws, engine_init,
                              get_rep, get_train_step, train_agent)
from repro_torch.core import s2v_csr as core_csr
from repro_torch.core import s2v_sparse as core_sparse
from repro_torch.core.mesh import single_axis
from repro_torch.core.agent import train_minibatch_raw
from repro_torch.core.graphs import (barabasi_albert_edges,
                                     csr_batch_from_arrays,
                                     csr_batch_from_dense, csr_from_edges,
                                     csr_residual_edge_mask, csr_row_ids,
                                     random_graph_batch, residual_edge_mask,
                                     sparse_batch_from_dense,
                                     symmetric_topology)
from repro_torch.kernels.s2v_csr import (csr_aggregate, csr_aggregate_plain,
                                         fused_s2v_layer_csr_plain)
from repro_torch.kernels.s2v_fused import fused_s2v_layer_sparse_plain
from repro_torch.kernels.s2v_gather import (sparse_mp_aggregate,
                                            sparse_mp_aggregate_plain)
from repro_torch.optim import adam_init
from test_torch_train import (KEYS, STEP_TOL, _assert_lockstep, _cfgs,
                              _lockstep, _pair, _tuples, jax_adam_to_numpy,
                              jax_to_numpy)

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
CD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
REPS = ("sparse", "csr")


# -- the layers' backwards -----------------------------------------------------------

def _graph_layer(rep, b=3, k=8, n=30, seed=0):
    """One layer's inputs on env-built graphs (ER(0.3), a random partial
    solution, the "solution" residual factors): the fused layer's
    arguments as (topology args, factors), the plain composition, JAX's
    composition over numpy arrays, and (theta4, x, base, grad)."""
    rng = np.random.default_rng(seed)
    adj = random_graph_batch("er", n, b, seed=seed + 1, rho=0.3)
    sol = torch.from_numpy((rng.random((b, n)) < 0.3).astype(np.float32))
    dense = [(rng.standard_normal((k, k)) * 0.3).astype(np.float32),
             np.abs(rng.standard_normal((b, k, n))).astype(np.float32),
             rng.standard_normal((b, k, n)).astype(np.float32),
             rng.standard_normal((b, k, n)).astype(np.float32)]
    if rep == "sparse":
        g = sparse_batch_from_dense(adj, device="cpu")
        edge = residual_edge_mask(g.neighbors, g.valid, sol)
        topo = (g.neighbors, edge)

        def fused(t4, x, base, compute):
            return core_sparse._FusedSparseLayer.apply(t4, x, *topo, base,
                                                       compute)

        def plain(t4, x, base, compute):
            return fused_s2v_layer_sparse_plain(t4, x, *topo, base, compute)

        def jax_fn(t4, x, base, cd):
            return _sparse_layer_jnp(t4, x, topo[0].numpy(), topo[1].numpy(),
                                     base, cd)
        gathered = b * k * n * g.max_degree
    else:
        g = csr_batch_from_dense(adj, device="cpu")
        rid = csr_row_ids(g.indptr, g.num_edges)
        edge = csr_residual_edge_mask(g.indices, g.edge_mask, rid, sol)
        topo = (g.indices, g.indptr, edge)

        def fused(t4, x, base, compute):
            return core_csr._FusedCsrLayer.apply(t4, x, *topo, base, compute)

        def plain(t4, x, base, compute):
            return fused_s2v_layer_csr_plain(t4, x, *topo, base, compute)

        def jax_fn(t4, x, base, cd):
            return _csr_layer_jnp(t4, x, g.indices.numpy(), rid.numpy(),
                                  edge.numpy(), base, cd)
        gathered = b * k * g.num_edges
    return fused, plain, jax_fn, dense, gathered


def _grads(fn, dense, compute):
    t4, x, base, g = dense
    ins = [torch.tensor(a, requires_grad=True) for a in (t4, x, base)]
    return torch.autograd.grad(fn(*ins, compute), ins, torch.from_numpy(g))


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("rep", REPS)
def test_closed_form_backward_is_autograd_of_the_plain_composition(rep,
                                                                    compute):
    fused, plain, _, dense, _ = _graph_layer(rep)
    for got, want in zip(_grads(fused, dense, compute),
                         _grads(plain, dense, compute)):
        torch.testing.assert_close(got, want, **TOL[compute])


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("rep", REPS)
def test_closed_form_backward_matches_jax_vjp(rep, compute):
    fused, _, jax_fn, dense, _ = _graph_layer(rep, b=2, k=16, n=40, seed=3)
    t4, x, base, g = dense
    _, vjp = jax.vjp(lambda a, e, b_: jax_fn(a, e, b_, CD[compute]),
                     t4, x, base)
    for got, want in zip(_grads(fused, dense, compute),
                         vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want, np.float32),
                                   **TOL[compute])


class _LargeTensors(TorchDispatchMode):
    """Records every non-view op whose output has at least ``numel``
    elements, and every scatter or index-add, except inside the aggregate
    calls (``paused``), which are kernels on the card and the plain
    versions here."""

    def __init__(self, numel):
        super().__init__()
        self.numel, self.seen, self.paused = numel, [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused and not func.is_view and (
                "scatter" in str(func) or "index_add" in str(func)
                or isinstance(out, torch.Tensor)
                and out.numel() >= self.numel):
            self.seen.append(str(func))
        return out


@pytest.mark.parametrize("rep", REPS)
def test_backward_forms_no_gathered_tensor(rep, monkeypatch):
    """Outside its two aggregate launches the backward forms nothing of
    the gathered (B, K, N, D) or (B, K, E) size, and it calls no
    scatter-add."""
    fused, _, _, dense, gathered = _graph_layer(rep)
    module, name = ((core_sparse, "sparse_mp_aggregate") if rep == "sparse"
                    else (core_csr, "csr_aggregate"))
    real, calls = getattr(module, name), []

    def paused(*args):
        mode.paused = True
        try:
            calls.append(args[0].shape)
            return real(*args)
        finally:
            mode.paused = False
    monkeypatch.setattr(module, name, paused)
    t4, x, base, g = dense
    ins = [torch.tensor(a, requires_grad=True) for a in (t4, x, base)]
    out = fused(*ins, "f32")
    with _LargeTensors(gathered) as mode:
        torch.autograd.grad(out, ins, torch.from_numpy(g))
    assert mode.seen == []
    assert len(calls) == 2


def _adjoint_gap(aggregate, b, k, n, seed):
    """|<A x, y> - <x, A y>| / |<A x, y>|: zero but for the f32 rounding of
    the plain aggregates iff A is its own transpose on these graphs (a
    transpose error is of the order of one term, 1e-2 here)."""
    rng = np.random.default_rng(seed)
    x, y = (torch.from_numpy(rng.standard_normal((b, k, n))) for _ in "xy")
    lhs = float((aggregate(x) * y).sum())
    rhs = float((x * aggregate(y)).sum())
    return abs(lhs - rhs) / max(abs(lhs), 1e-30)


@pytest.mark.parametrize("kind", ["er", "ba", "social"])
def test_env_graphs_satisfy_the_symmetry_the_backwards_need(kind):
    """The lists, the CSR arrays and their residual factors of
    ``random_graph_batch``'s graphs are symmetric, so each aggregate is
    its own transpose."""
    b, k, n = 3, 4, 40
    adj = random_graph_batch(kind, n, b, seed=7)
    sol = torch.from_numpy((np.random.default_rng(7).random((b, n)) < 0.3)
                           .astype(np.float64))
    g = sparse_batch_from_dense(adj, device="cpu")
    edge = residual_edge_mask(g.neighbors, g.valid, sol.float()).double()
    w = torch.zeros((b, n + 1, n + 1), dtype=torch.float64)
    w.scatter_(2, g.neighbors.long(), edge)      # padding lands on column N
    w = w[:, :n, :n]
    assert torch.equal(w, w.transpose(1, 2))
    assert _adjoint_gap(lambda v: sparse_mp_aggregate_plain(
        torch.nn.functional.pad(v, (0, 1)), g.neighbors, edge), b, k, n,
        1) < 1e-5
    c = csr_batch_from_dense(adj, device="cpu")
    rid = csr_row_ids(c.indptr, c.num_edges)
    ew = csr_residual_edge_mask(c.indices, c.edge_mask, rid,
                                sol.float()).double()
    assert _adjoint_gap(lambda v: csr_aggregate_plain(v, c.indices, rid, ew),
                        b, k, n, 2) < 1e-5
    wc = torch.zeros((b, n, n + 1), dtype=torch.float64)
    wc[torch.arange(b)[:, None], rid.long(), c.indices.long()] = ew
    assert torch.equal(wc[:, :, :n], w)


def test_csr_from_edges_is_symmetric():
    n = 300
    src, dst = barabasi_albert_edges(n, 3, seed=5)
    indptr, indices = csr_from_edges(n, src, dst)
    g = csr_batch_from_arrays(indptr, indices, device="cpu")
    rid = csr_row_ids(g.indptr, g.num_edges)
    ew = g.edge_mask.double()
    assert _adjoint_gap(lambda v: csr_aggregate_plain(v, g.indices, rid, ew),
                        1, 4, n, 3) < 1e-5
    a = np.zeros((n, n), bool)
    a[np.repeat(np.arange(n), np.diff(indptr)), indices] = True
    assert (a == a.T).all() and a.any()
    assert symmetric_topology(g)


def _csr_of(n, rows, cols):
    """One graph's CSR batch from its (row, col) slots, in any order."""
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return csr_batch_from_arrays(indptr, cols[order], device="cpu")


@pytest.mark.parametrize("rep", REPS)
def test_asymmetric_dataset_is_refused(rep):
    """``prepare_dataset`` holds its graphs to the symmetry the backwards
    need: a one-sided edge list is refused, as a batch the caller built
    (CSR from the caller's arrays, padded lists) or as a dense stack,
    and so is a CSR graph that lists one edge twice one way and once the
    other way; the env's graphs pass."""
    n = 30
    adj = random_graph_batch("er", n, 2, seed=3, rho=0.3)
    one_sided = np.triu(adj, 1)
    r = get_rep(rep)
    assert symmetric_topology(r.prepare_dataset(adj, device="cpu"))
    if rep == "csr":
        rows, cols = np.nonzero(adj[0])
        cases = (_csr_of(n, *np.nonzero(one_sided[0])),
                 _csr_of(n, np.append(rows, rows[0]),
                         np.append(cols, cols[0])))
    else:
        cases = (sparse_batch_from_dense(one_sided, device="cpu"),)
    for given in cases + (one_sided,):
        with pytest.raises(ValueError, match="symmetric graphs"):
            r.prepare_dataset(given, device="cpu")


def test_row_block_backward_is_refused():
    """The layer and aggregate on a row block of the lists without an
    axis cannot form the gradient of an input they did not gather, and say
    that the graph axis does; given an axis of size 1 (the whole lists)
    they equal the whole-graph backward.  No Function takes a gradient of
    the factors."""
    b, k, n, nl = 2, 8, 30, 15
    adj = random_graph_batch("er", n, b, seed=2, rho=0.3)
    g = sparse_batch_from_dense(adj, device="cpu")
    nbr, edge = g.neighbors[:, :nl].contiguous(), g.valid[:, :nl].float()
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.random((b, k, n), np.float32), requires_grad=True)
    t4 = torch.from_numpy(rng.random((k, k), np.float32))
    base = torch.from_numpy(rng.random((b, k, nl), np.float32))
    out = core_sparse._FusedSparseLayer.apply(t4, x, nbr, edge, base, "f32")
    with pytest.raises(NotImplementedError, match="graph axis"):
        out.sum().backward()
    out = core_sparse._SparseAggregate.apply(x, nbr, edge)
    with pytest.raises(NotImplementedError, match="graph axis"):
        out.sum().backward()
    whole_edge = g.valid.float()
    one = single_axis("graph")
    w = torch.from_numpy(rng.standard_normal((b, k, n)).astype(np.float32))
    for bare, gathered in (
            (lambda xx: core_sparse._FusedSparseLayer.apply(
                t4, xx, g.neighbors, whole_edge, torch.ones((b, k, n)),
                "f32"),
             lambda xx: core_sparse._FusedSparseLayer.apply(
                 t4, xx, g.neighbors, whole_edge, torch.ones((b, k, n)),
                 "f32", one)),
            (lambda xx: core_sparse._SparseAggregate.apply(
                xx, g.neighbors, whole_edge),
             lambda xx: core_sparse._SparseAggregate.apply(
                 xx, g.neighbors, whole_edge, one))):
        want, got = (torch.autograd.grad((w * fn(x)).sum(), [x])[0]
                     for fn in (bare, gathered))
        assert torch.equal(got, want)
    ew = g.valid.float().requires_grad_(True)
    out = core_sparse._FusedSparseLayer.apply(
        t4, x, g.neighbors, ew, torch.zeros((b, k, n)), "f32")
    with pytest.raises(NotImplementedError, match="edge factors"):
        out.sum().backward()


def test_aggregate_wrappers_take_their_plain_versions_on_the_cpu():
    adj = random_graph_batch("er", 24, 2, seed=4, rho=0.3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, 24)).astype(np.float32))
    g = sparse_batch_from_dense(adj, device="cpu")
    xp = torch.nn.functional.pad(x, (0, 1))
    w = g.valid.float() * 0.7
    for compute in ("f32", "bf16"):
        assert torch.equal(sparse_mp_aggregate(xp, g.neighbors, w, compute),
                           sparse_mp_aggregate_plain(xp, g.neighbors, w,
                                                     compute))
    c = csr_batch_from_dense(adj, device="cpu")
    rid = csr_row_ids(c.indptr, c.num_edges)
    cw = c.edge_mask.float() * 0.7
    for compute in ("f32", "bf16"):
        got = csr_aggregate(x, c.indices, c.indptr, cw, compute)
        assert torch.equal(got, csr_aggregate_plain(x, c.indices, rid, cw,
                                                    compute))
        torch.testing.assert_close(
            got, sparse_mp_aggregate(xp, g.neighbors, w, compute),
            **TOL[compute])
    with pytest.raises(ValueError, match="compute"):
        csr_aggregate(x, c.indices, c.indptr, cw, "f16")


# -- re-materialization --------------------------------------------------------------

STATE_FIELDS = {"sparse": ("neighbors", "valid", "candidate", "solution"),
                "csr": ("indptr", "indices", "edge_mask", "candidate",
                        "solution")}


@pytest.mark.parametrize("residual", ["solution", "none", "closed"])
@pytest.mark.parametrize("rep", REPS)
def test_state_from_tuples_matches_jax_bit_for_bit(rep, residual):
    adj = random_graph_batch("er", 30, 5, seed=3, rho=0.25)
    t = _tuples(7, 30, seed=4)
    jrep, prep = jax_get_rep(rep), get_rep(rep)
    want = jrep.state_from_tuples(jrep.prepare_dataset(adj), t["graph_idx"],
                                  t["solution"], residual=residual)
    source = prep.prepare_dataset(adj, device="cpu")
    got = prep.state_from_tuples(source, torch.from_numpy(t["graph_idx"]),
                                 torch.from_numpy(t["solution"]),
                                 residual=residual)
    for f in STATE_FIELDS[rep]:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.residual == want.residual
    assert prep.dataset_shape(source) == (5, 30)


def test_csr_helpers_by_graph_chunks_equal_one_pass(monkeypatch):
    """Above ``CHUNK_SLOTS`` the CSR helpers take a few graphs at a time
    (a paper-scale minibatch); the values are the one pass's."""
    from repro_torch.core import graphs
    adj = random_graph_batch("er", 40, 5, seed=6, rho=0.3)
    c = csr_batch_from_dense(adj, device="cpu")
    sol = torch.from_numpy((np.random.default_rng(6).random((5, 40)) < 0.3)
                           .astype(np.float32))

    def run():
        rid = csr_row_ids(c.indptr, c.num_edges)
        ew = csr_residual_edge_mask(c.indices, c.edge_mask, rid, sol)
        return rid, ew, graphs.csr_segment_sum(ew, rid, 40)
    whole = run()
    monkeypatch.setattr(graphs, "CHUNK_SLOTS", 2 * c.num_edges)
    for a, b in zip(whole, run()):
        assert torch.equal(a, b)


# -- one GD iteration and the fused step against JAX's --------------------------------

@pytest.mark.parametrize("kernel", ["fused", "xla"])
@pytest.mark.parametrize("rep", REPS)
def test_train_minibatch_matches_jax(rep, kernel):
    jcfg, _ = _cfgs(embed_dim=8)
    params, policy = _pair(jcfg, seed=1)
    adj = random_graph_batch("er", 20, 4, seed=2, rho=0.3)
    t = _tuples(6, 20, seed=5)
    t["graph_idx"] %= 4
    jrep, prep = jax_get_rep(rep), get_rep(rep)
    jst = jrep.state_from_tuples(jrep.prepare_dataset(adj), t["graph_idx"],
                                 t["solution"])
    st = prep.state_from_tuples(prep.prepare_dataset(adj, device="cpu"),
                                t["graph_idx"], t["solution"])
    jopt, opt = jax_adam_init(params), adam_init(policy)
    for _ in range(3):
        params, jopt, jl = jax_train_minibatch(
            params, jopt, jst, jnp.asarray(t["action"]),
            jnp.asarray(t["target"]), rep=jrep, num_layers=2, lr=1e-3,
            kernel=kernel)
        _, _, loss = train_minibatch_raw(
            policy, opt, st, torch.from_numpy(t["action"]),
            torch.from_numpy(t["target"]), rep=prep, num_layers=2, lr=1e-3,
            kernel=kernel)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    got, want = policy_to_numpy(policy), jax_to_numpy(params)
    mine, theirs = adam_to_numpy(opt), jax_adam_to_numpy(jopt)
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], **STEP_TOL, err_msg=k)
    for k in theirs:
        np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-4, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("rep", REPS)
def test_stored_mode_greedy_step_matches_jax(rep):
    out, want, got = _lockstep("stored", eps=0.0, rep=rep)
    _assert_lockstep(out, want, got)


@pytest.mark.parametrize("rep", REPS)
def test_fresh_mode_exploring_step_matches_jax_with_its_draws(rep):
    out, want, got = _lockstep("fresh", eps=0.5, rep=rep)
    assert out["explored"] >= 4
    _assert_lockstep(out, want, got)


@pytest.mark.parametrize("rep", REPS)
def test_step_without_exploration_matches_jax(rep):
    out, want, got = _lockstep("fresh", eps=1.0, explore=False, rep=rep)
    assert out["explored"] == 0
    _assert_lockstep(out, want, got)


@pytest.mark.parametrize("target_mode", ["stored", "fresh"])
def test_three_reps_take_the_same_steps(target_mode):
    """The port's step on dense, sparse and CSR from the same weights,
    graphs and draws: the same actions, losses within 1e-5."""
    n, b, mb, tau, steps = 14, 2, 8, 2, 8
    _, cfg = _cfgs(embed_dim=8, num_layers=2, minibatch=mb,
                   replay_capacity=64, learning_rate=1e-3, eps_start=0.5,
                   eps_end=0.5)
    adj = random_graph_batch("er", n, 4, seed=0, rho=0.3)
    rng = np.random.default_rng(9)
    draws = [(rng.random(b).astype(np.float32), rng.integers(0, n, b),
              rng.integers(0, min(b * (i + 1), 64), (tau, mb)))
             for i in range(steps)]
    gi = torch.tensor([0, 2])
    runs = {}
    for rep in ("dense", "sparse", "csr"):
        prep = get_rep(rep)
        _, policy = _pair(_cfgs(embed_dim=8)[0])
        step = get_train_step(cfg, rep=prep, tau=tau,
                              target_mode=target_mode)
        es = engine_init(cfg, policy, adam_init(policy), n)
        source = prep.prepare_dataset(adj, device="cpu")
        state = prep.state_from_tuples(source, gi, np.zeros((b, n),
                                                            np.float32))
        losses, actions = [], []
        for d in draws:
            es, state, a, _, _, loss = step(
                es, state, source, gi,
                TrainDraws(*(torch.as_tensor(x) for x in d)))
            losses.append(float(loss))
            actions.append(a.numpy())
        runs[rep] = np.array(losses), np.stack(actions)
    warm = np.isfinite(runs["dense"][0])
    assert warm.sum() >= 4
    for rep in ("sparse", "csr"):
        np.testing.assert_array_equal(runs[rep][1], runs["dense"][1])
        np.testing.assert_array_equal(np.isfinite(runs[rep][0]), warm)
        np.testing.assert_allclose(runs[rep][0][warm], runs["dense"][0][warm],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rep", REPS)
def test_train_agent_trains_on_the_cpu(rep):
    n = 12
    adj = random_graph_batch("er", n, 4, seed=5, rho=0.3)
    cfg = PolicyConfig(embed_dim=8, num_layers=2, minibatch=8,
                       replay_capacity=128, learning_rate=1e-3,
                       graph_rep=rep)
    agent = Agent(cfg, num_nodes=n, device="cpu")
    before = {k: v.copy() for k, v in policy_to_numpy(agent.params).items()}
    log = train_agent(agent, adj, episodes=4, tau=2, eval_every=10 ** 9,
                      seed=0)
    losses = np.asarray(log.losses)
    assert np.isfinite(losses[-1])
    assert agent.step_count == int(np.isfinite(losses).sum()) > 0
    assert int(agent.opt.step) == 2 * agent.step_count
    assert any(not np.array_equal(v, before[k])
               for k, v in policy_to_numpy(agent.params).items())
    # rep= overrides the configuration's
    other = Agent(PolicyConfig(embed_dim=8, minibatch=4), num_nodes=n,
                  device="cpu")
    log = train_agent(other, adj, rep=rep, episodes=1, tau=1, seed=1)
    assert np.isfinite(log.losses[-1])
