"""Rank functions of tests/test_torch_mesh.py, tests/test_torch_mesh_train.py,
tests/test_torch_problems_mesh.py, tests/test_torch_mesh_async.py,
tests/test_torch_mesh_host.py and tests/test_torch_cuda.py, run by
``repro_torch.core.mesh.spawn_mesh``
in spawned processes.  A spawned rank imports this module by name, so it
lives apart from the test files and imports neither jax nor the JAX
package: each rank only loads torch."""
import time

import numpy as np
import torch

from repro_torch.convert import policy_from_numpy
from repro_torch.core import (DENSE, SPARSE, PolicyConfig, init_solve_state,
                              shard_graph_arrays,
                              shard_sparse_arrays, solve,
                              sparse_batch_from_dense,
                              sparse_spatial_scores_fn, spatial_scores_fn)
from repro_torch.core.graphs import residual_adjacency
from repro_torch.serving import GraphSolverService

REPS = ("dense", "sparse")
KERNELS = ("fused", "xla")


def partial_state(adj: np.ndarray, sol: np.ndarray):
    """The dense residual state of ``adj`` under the partial solution
    ``sol``: (adjacency, solution, candidate) as CPU tensors."""
    a = residual_adjacency(torch.from_numpy(adj), torch.from_numpy(sol))
    cand = ((a.sum(-1) > 0) & (torch.from_numpy(sol) < 0.5)).float()
    return a, torch.from_numpy(sol), cand


def run_shape(mesh, dev, weights, adj, partial_sol, stream):
    """Everything tests/test_torch_mesh.py checks on one mesh shape, in one
    spawn: full solves on every rep and lowering, the sharded scorers on
    two states, each rank's state tiles, divisibility errors and the sync
    service.  Returns this rank's results."""
    policy = policy_from_numpy(weights, device=dev)
    spec = mesh.shape
    out = {"rank": mesh.rank, "data": mesh.data.index,
           "graph": mesh.graph.index}
    for rep in REPS:
        for kernel in KERNELS:
            r = solve(policy, adj, num_layers=2, multi_node=True, rep=rep,
                      kernel=kernel, spatial=spec, device=dev)
            out["solve", rep, kernel] = (r.solution, r.policy_evals,
                                         r.nodes_committed)
    try:
        r = solve(policy, adj, num_layers=2, multi_node=True, rep="csr",
                  spatial=spec, device=dev)
        out["solve", "csr", "fused"] = (r.solution, r.policy_evals,
                                        r.nodes_committed)
    except ValueError as e:
        out["csr_error"] = str(e)

    # the sharded scorers on the fresh state and on a partial solution
    sp = sparse_batch_from_dense(adj, device="cpu")
    with torch.no_grad():
        for name, sol in (("fresh", np.zeros(adj.shape[:2], np.float32)),
                          ("partial", partial_sol)):
            a, s, c = partial_state(adj, sol)
            tiles = shard_graph_arrays(mesh, a, s, c, device=dev)
            out["scores", "dense", name] = spatial_scores_fn(
                mesh, 2)(policy, *tiles).numpy()
            tiles = shard_sparse_arrays(mesh, sp.neighbors, sp.valid, s, c,
                                        device=dev)
            out["scores", "sparse", name] = sparse_spatial_scores_fn(
                mesh, 2)(policy, *tiles).numpy()

    out["state_shape", "dense"] = tuple(
        init_solve_state(DENSE, adj, device=dev, mesh=mesh).adj.shape)
    st = init_solve_state(SPARSE, adj, device=dev, mesh=mesh)
    out["state_shape", "sparse"] = (tuple(st.neighbors.shape),
                                    tuple(st.solution.shape))
    try:
        solve(policy, adj[:, :15, :15], spatial=spec, device=dev)
    except ValueError as e:
        out["node_error"] = str(e)

    if spec in ((2, 1), (2, 2)):
        for rep in (("dense", "sparse") if spec == (2, 2) else ("dense",)):
            svc = GraphSolverService(
                policy, PolicyConfig(embed_dim=8, spatial=spec), rep=rep,
                device=dev, multi_node=True, max_batch=2)
            responses = svc.serve(stream)
            out["service", rep] = {
                "rows_per_dispatch": svc.rows_per_dispatch,
                "batches": svc.stats.batches,
                "responses": [(r.id, r.solution, r.size, r.policy_evals)
                              for r in responses]}
        if mesh.rank != 0:                  # rank 0 alone takes them
            try:
                svc.submit_async(stream[0])
            except ValueError as e:
                out["async_error"] = str(e)
    return out


def fail_on_rank_one(mesh, dev):
    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    return mesh.rank


def hang_on_rank_one(mesh, dev):
    if mesh.rank == 1:
        time.sleep(3600)
    return mesh.rank


def solve_on_card(mesh, dev, weights, adj):
    """A dense and a sparse solve of ``adj`` on this rank's card, with the
    launches of the mesh kernels during each."""
    from repro_torch.kernels import s2v_fused as ks
    policy = policy_from_numpy(weights, device=dev)
    out = {}
    for rep, counter in (("dense", ks.mp_aggregate),
                         ("sparse", ks.fused_s2v_layer_sparse)):
        before = counter.launches
        r = solve(policy, adj, num_layers=2, multi_node=True, rep=rep,
                  spatial=mesh.shape, device=dev)
        out[rep] = (r.solution, r.policy_evals, counter.launches - before)
    return out


# ---------------------------------------------------------------------------
# Training on the mesh (tests/test_torch_mesh_train.py).
# ---------------------------------------------------------------------------

def mesh_train_run(mesh, dev, weights, adj, gi, draws, *, rep, target_mode,
                   eps, explore=True, tau=2, kernel="fused", compute="f32",
                   problem="mvc", **cfg_kw):
    """The fused train step of ``problem`` on this rank's tiles, each step
    given its whole-batch draws (numpy ``(eps_uniform, pick,
    sample_idx)``).  Returns the losses, the whole batch's actions
    (gathered over ``data``), the trained weights and the step count."""
    from repro_torch.convert import policy_to_numpy
    from repro_torch.core import (TrainDraws, engine_init, env, get_rep,
                                  get_train_step)
    from repro_torch.core.mesh import all_gather_tiled, shard_dataset
    from repro_torch.core.spatial import tile_state_from_tuples
    from repro_torch.optim import adam_init
    n = adj.shape[-1]
    cfg = PolicyConfig(eps_start=eps, eps_end=eps, graph_rep=rep,
                       spatial=mesh.shape, kernel=kernel, compute=compute,
                       **cfg_kw)
    policy = policy_from_numpy(weights, device=dev)
    r = get_rep(rep)
    whole = r.prepare_dataset(adj, device="cpu")
    source = shard_dataset(mesh, whole, device=dev)
    es = engine_init(cfg, policy, adam_init(policy), n, mesh=mesh)
    step = get_train_step(cfg, rep=r, problem=problem, tau=tau,
                          target_mode=target_mode, explore=explore)
    state = tile_state_from_tuples(
        mesh, r, whole, gi, np.zeros((len(gi), n), np.float32), device=dev,
        residual=env.residual_mode(problem),
        candidate_fn=env.candidate_rule(problem))
    gi_t = torch.as_tensor(gi, device=dev)
    losses, actions = [], []
    for d in draws:
        es, state, a, _, _, loss = step(es, state, source, gi_t, TrainDraws(
            *(torch.as_tensor(x, device=dev) for x in d)))
        losses.append(float(loss))
        actions.append(all_gather_tiled(a, mesh.data, 0).cpu().numpy())
    return {"losses": np.array(losses), "actions": np.stack(actions),
            "params": policy_to_numpy(policy), "step_count": es.step_count}


def rank_weights(shape, seed, index):
    """The loss weights of graph rank ``index`` in ``collective_grads``."""
    return np.random.default_rng(seed * 100 + index).standard_normal(
        shape).astype(np.float32)


def collective_grads(mesh, seed=7, b=2, k=4, n=12):
    """Each differentiable collective on this rank's slice of a whole
    input (the same x on every rank, from ``seed``), with a loss of its
    own rank-seeded weights: the gradients of the rank's operands, which
    the test holds to autograd of the whole, ungathered computation in
    one process.  ``naive`` is the pooled sum as an in-place all-reduce
    would give it (each rank's own loss terms only)."""
    from repro_torch.core.graphs import (random_graph_batch,
                                         residual_edge_mask,
                                         sparse_batch_from_dense)
    from repro_torch.core.mesh import (all_reduce_sum, partial_sum_columns,
                                       pooled_sum)
    from repro_torch.core.s2v_sparse import (_FusedSparseLayer,
                                             _SparseAggregate)
    rng = np.random.default_rng(seed)
    g = mesh.graph
    cols = g.rows(n)
    x = torch.from_numpy(rng.standard_normal((b, k, n)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    adj = random_graph_batch("er", n, b, seed=seed, rho=0.4)
    sol = torch.from_numpy((rng.random((b, n)) < 0.3).astype(np.float32))
    t4 = torch.from_numpy(rng.standard_normal((k, k)).astype(np.float32))
    base = torch.from_numpy(rng.standard_normal((b, k, n)).astype(
        np.float32))
    lists = sparse_batch_from_dense(adj, device="cpu")
    edge = residual_edge_mask(lists.neighbors, lists.valid, sol)
    out = {}

    def grad_of(fn, *leaves):
        leaves = [t.clone().requires_grad_(True) for t in leaves]
        fn(*leaves).backward()
        return [t.grad.numpy() for t in leaves]

    w = torch.from_numpy(rank_weights((b, k), seed, g.index))
    out["pooled"] = grad_of(
        lambda xr: (w * pooled_sum(xr.sum(-1), g)).sum(), x[:, :, cols])[0]

    def naive(xr):
        s = xr.sum(-1)
        total = all_reduce_sum(s.detach().clone(), g)
        return (w * (s + (total - s.detach()))).sum()
    out["naive"] = grad_of(naive, x[:, :, cols])[0]

    wl = torch.from_numpy(rank_weights((b, k, n // g.size), seed + 1,
                                        g.index))
    out["columns"] = grad_of(
        lambda xr: (wl * partial_sum_columns(
            torch.einsum("bkl,ln->bkn", xr, a[cols]), g)).sum(),
        x[:, :, cols])[0]
    nbr = lists.neighbors[:, cols].contiguous()
    edge_r = edge[:, cols].contiguous()
    out["layer"] = grad_of(
        lambda t, xr, br: (wl * _FusedSparseLayer.apply(
            t, xr, nbr, edge_r, br, "f32", g)).sum(),
        t4, x[:, :, cols], base[:, :, cols])
    out["aggregate"] = grad_of(
        lambda xr: (wl * _SparseAggregate.apply(
            xr, nbr, edge_r, g)).sum(), x[:, :, cols])[0]
    return out


def tile_checks(mesh, dev, adj, seed=3, m=4):
    """The tile re-materialization and the sharded replay against their
    single-device counterparts built on this rank from the whole data:
    the matching rows and columns, bit for bit.  Returns the names that
    differ (empty when all agree)."""
    from repro_torch.core import (get_rep, device_replay_at,
                                  device_replay_init, device_replay_push,
                                  residual_edge_mask)
    from repro_torch.core.mesh import shard_dataset
    from repro_torch.core.replay import sharded_replay_rows
    from repro_torch.core.spatial import tile_from_tuples
    rng = np.random.default_rng(seed)
    g_count, n = adj.shape[0], adj.shape[-1]
    rows, cols = mesh.data.rows(m), mesh.graph.rows(n)
    gi = torch.from_numpy(rng.integers(0, g_count, m).astype(np.int32))
    sol = torch.from_numpy((rng.random((m, n)) < 0.3).astype(np.float32))
    bad = []
    for rep in ("dense", "sparse"):
        r = get_rep(rep)
        whole = r.prepare_dataset(adj, device="cpu")
        source = shard_dataset(mesh, whole, device=dev)
        for mode in ("solution", "none"):
            want = r.state_from_tuples(whole, gi, sol, residual=mode)
            tile = tile_from_tuples(mesh, r, source, gi[rows].to(dev),
                                    sol[rows][:, cols].to(dev), mode)
            if rep == "dense":
                got_topo = [tile.topology[0]]
                want_topo = [want.adj[rows][:, cols]]
            else:
                edge = (residual_edge_mask(want.neighbors, want.valid,
                                           want.solution)
                        if mode == "solution" else want.valid.float())
                got_topo = list(tile.topology)
                want_topo = [want.neighbors[rows][:, cols],
                             want.valid[rows][:, cols], edge[rows][:, cols]]
            pairs = list(zip(got_topo, want_topo)) + [
                (tile.candidate, want.candidate[rows][:, cols]),
                (tile.solution, want.solution[rows][:, cols])]
            if not all(torch.equal(a.cpu(), b) for a, b in pairs):
                bad.append(f"remat {rep} {mode}")

    # the ring: five pushes of 4 tuples (3 on one data rank) wrap a
    # 10-ring; each rank pushes its data rank's rows of the batch
    cap, b = 10, 4 if mesh.dp > 1 else 3
    single = device_replay_init(cap, n, device="cpu")
    tiled = device_replay_init(cap, n, device=dev, mesh=mesh)
    fields = ("graph_idx", "solution", "action", "target", "reward",
              "next_solution", "done")
    for i in range(5):
        t = [torch.from_numpy(x) for x in (
            rng.integers(0, 5, b).astype(np.int32),
            (rng.random((b, n)) < 0.3).astype(np.float32),
            rng.integers(0, n, b).astype(np.int32),
            rng.standard_normal(b).astype(np.float32),
            -np.ones(b, np.float32),
            (rng.random((b, n)) < 0.5).astype(np.float32),
            rng.random(b) < 0.2)]
        device_replay_push(single, *t)
        mine = mesh.data.rows(b)
        device_replay_push(tiled, *(x[mine].to(dev) for x in t))
    if (tiled.size, tiled.ptr) != (single.size, single.ptr):
        bad.append("replay size/ptr")
    ring = mesh.data.rows(cap)
    for f in fields:
        want = getattr(single, f)[ring]
        if f in ("solution", "next_solution"):
            want = want[:, cols]
        if not torch.equal(getattr(tiled, f).cpu(), want):
            bad.append(f"replay {f}")
    idx = torch.from_numpy(rng.integers(0, cap, 8))
    got = sharded_replay_rows(tiled, idx.to(dev), fields)
    want = device_replay_at(single, idx)
    for f, a, w in zip(fields, got, want):
        w = w[mesh.data.rows(8)]
        if f in ("solution", "next_solution"):
            w = w[:, cols]
        if not torch.equal(a.cpu(), w):
            bad.append(f"sample {f}")
    try:
        device_replay_init(cap - 1, n, device=dev, mesh=mesh)
        if mesh.dp > 1:
            bad.append("odd capacity accepted")
    except ValueError as e:
        if mesh.dp == 1 or "not divisible" not in str(e):
            raise
    return bad


def train_shape(mesh, dev, weights, adj, gi, cases):
    """Everything tests/test_torch_mesh_train.py checks on one mesh shape,
    in one spawn: each train case of ``cases`` (name → keyword arguments
    of :func:`mesh_train_run`, draws included), the collectives'
    gradients, the tile re-materialization and the sharded replay."""
    out = {"rank": mesh.rank, "data": mesh.data.index,
           "graph": mesh.graph.index,
           "grads": collective_grads(mesh),
           "tiles": tile_checks(mesh, dev, adj)}
    for name, kw in cases.items():
        out["train", name] = mesh_train_run(mesh, dev, weights, adj, gi,
                                            **kw)
    return out


# ---------------------------------------------------------------------------
# MaxCut, MIS and MDS on the mesh (tests/test_torch_problems_mesh.py).
# ---------------------------------------------------------------------------

PROBLEMS = ("maxcut", "mis", "mds")


def _copy(state):
    """``state`` with every tensor cloned: the dense commit writes its
    adjacency in place, and a tile of ``shard_state`` is a view."""
    import dataclasses
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def _pick(rng, cand):
    """(B,) a random candidate of each row (node 0 where none is left)."""
    u = torch.from_numpy(rng.random(cand.shape).astype(np.float32))
    return torch.argmax(torch.where(cand > 0.5, u, -1.0), dim=-1)


def tile_rule_checks(mesh, dev, adj, seed=5):
    """Each env rule of MaxCut, MIS and MDS on this rank's tile of a state
    (``shard_state``: its graphs, its topology rows, the masks whole)
    against the rule on the whole single-device state built here from
    the same data, on a fresh and a partial state of the dense and sparse
    reps: the solve's first state (``init_solve_state``), the step, the
    commit, MIS's prune and closed keep, MDS's
    candidates (whole and the rank's rows); then the closed keep and
    factors of the sparse lists' rows, and the train tile
    (``tile_from_tuples``) in each problem's mode with its candidate rule.
    Bit for bit the matching rows (and columns).  Returns the names of the
    checks that differ (empty when all agree)."""
    from repro_torch.core import env, get_rep
    from repro_torch.core.mesh import local_rows, shard_dataset, shard_state
    from repro_torch.core.s2v_sparse import (closed_edge_factors,
                                             closed_keep_local, edge_factors)
    from repro_torch.core.spatial import tile_from_tuples
    rng = np.random.default_rng(seed)
    b, n = adj.shape[0], adj.shape[-1]
    rows, cols = mesh.data.rows(b), mesh.graph.rows(n)
    g = mesh.graph
    bad = []

    def same(name, got, want):
        if not torch.equal(got.cpu(), want):
            bad.append(name)

    def topo(st):
        return ((st.adj,) if hasattr(st, "adj")
                else (st.neighbors, st.valid))

    def same_state(name, got, want):
        same(f"{name} candidate", got.candidate, want.candidate[rows])
        same(f"{name} solution", got.solution, want.solution[rows])
        for i, (a, w) in enumerate(zip(topo(got), topo(want))):
            same(f"{name} topology {i}", a, w[rows][:, cols])

    gi = torch.arange(b)
    for rep in ("dense", "sparse"):
        r = get_rep(rep)
        source = r.prepare_dataset(adj, device="cpu")
        tiles = shard_dataset(mesh, source, device=dev)
        for problem in PROBLEMS:
            mode, cand_fn = env.residual_mode(problem), \
                env.candidate_rule(problem)
            # the solve's first masks: candidates derived on the host
            # before the tiles are placed (the sparse lists' width is the
            # data rank's graphs' own, so only the masks are compared)
            got = init_solve_state(r, adj, problem, device=dev, mesh=mesh)
            want = init_solve_state(r, adj, problem, device="cpu")
            same(f"{rep} {problem} solve candidates", got.candidate,
                 want.candidate[rows])
            same(f"{rep} {problem} solve solution", got.solution,
                 want.solution[rows])
            for kind, p in (("fresh", 0.0), ("partial", 0.25)):
                tag = f"{rep} {problem} {kind}"
                sol = torch.from_numpy((rng.random((b, n)) < p).astype(
                    np.float32))
                whole = r.state_from_tuples(source, gi, sol, residual=mode,
                                            candidate_fn=cand_fn)

                def tile():
                    return _copy(shard_state(mesh, _copy(whole)))
                # the step, with a candidate action of each row
                action = _pick(rng, whole.candidate)
                want = env.make(problem)(_copy(whole), action)
                got = env.make(problem)(tile(), action[rows])
                same_state(f"{tag} step", got[0], want[0])
                same(f"{tag} step reward", got[1], want[1][rows])
                same(f"{tag} step done", got[2], want[2][rows])
                # the commit of a few candidates
                sel = whole.candidate * torch.from_numpy(
                    (rng.random((b, n)) < 0.3).astype(np.float32))
                want = env.commit_rule(problem)(_copy(whole), sel)
                got = env.commit_rule(problem)(tile(), sel[rows])
                same_state(f"{tag} commit", got[0], want[0])
                same(f"{tag} commit done", got[1], want[1][rows])
                if problem == "mis":
                    scores = torch.from_numpy(rng.standard_normal(
                        (b, n)).astype(np.float32))
                    same(f"{tag} prune",
                         env.mis_prune(tile(), sel[rows], scores[rows]),
                         env.mis_prune(whole, sel, scores)[rows])
                    same(f"{tag} closed keep",
                         env._closed_keep(tile(), sel[rows]),
                         env._closed_keep(whole, sel)[rows])
                if problem == "mds":
                    want = env.mds_candidates(whole)
                    same(f"{tag} candidates",
                         env.mds_candidates(tile()), want[rows])
                    same(f"{tag} candidate rows",
                         env.mds_candidates(tile(), rows=True),
                         want[rows][:, cols])
                # the train tile of the same tuples
                t = tile_from_tuples(mesh, r, tiles, gi[rows],
                                     local_rows(sol[rows], g).to(dev), mode,
                                     cand_fn)
                want_topo = topo(whole)
                if rep == "sparse":
                    want_topo += (edge_factors(
                        whole.neighbors, whole.valid, whole.solution,
                        env.residual_flag(mode)),)
                for i, (a, w) in enumerate(zip(t.topology, want_topo)):
                    same(f"{tag} remat topology {i}", a, w[rows][:, cols])
                same(f"{tag} remat candidate", t.candidate,
                     whole.candidate[rows][:, cols])
                same(f"{tag} remat solution", t.solution,
                     whole.solution[rows][:, cols])
                if rep == "sparse" and problem == "mis":
                    nbr = whole.neighbors[rows][:, cols].contiguous()
                    valid = whole.valid[rows][:, cols].contiguous()
                    sl = sol[rows][:, cols].contiguous()
                    same(f"{tag} closed keep rows",
                         closed_keep_local(nbr, valid, sl, axis=g),
                         closed_keep_local(whole.neighbors, whole.valid,
                                           sol)[rows][:, cols])
                    same(f"{tag} closed factors",
                         closed_edge_factors(nbr, valid, sl, axis=g),
                         closed_edge_factors(whole.neighbors, whole.valid,
                                             sol)[rows][:, cols])
    return bad


def train_agent_run(mesh, dev, adj, problem, rep):
    """``train_agent`` of ``problem`` on ``rep`` (two episodes of 2 graphs,
    tau 1, at most 8 steps, seed 0) from the agent's seeded policy, on
    this rank of ``mesh`` (None: one device).  Returns the losses, the
    episode lengths, the trained weights and the step count."""
    from repro_torch.convert import policy_to_numpy
    from repro_torch.core import Agent, train_agent
    cfg = PolicyConfig(embed_dim=8, num_layers=2, minibatch=8,
                       replay_capacity=64, learning_rate=1e-3,
                       graph_rep=rep,
                       spatial=mesh.shape if mesh is not None else 0)
    agent = Agent(cfg, num_nodes=adj.shape[-1], device=dev)
    log = train_agent(agent, adj, problem=problem, episodes=2, tau=1,
                      batch_graphs=2, max_steps=8, seed=0)
    return {"losses": np.array(log.losses), "lengths": log.episode_lengths,
            "params": policy_to_numpy(agent.params),
            "step_count": agent.step_count}


def problems_shape(mesh, dev, weights, adj, stream, rules_adj, train):
    """Everything tests/test_torch_problems_mesh.py checks on one mesh
    shape, in one spawn: solves of MaxCut, MIS and MDS on dense and
    sparse (CSR at sp = 1), the sync service per problem at (2, 2), the
    tile rules on ``rules_adj`` (:func:`tile_rule_checks`), the train
    cases of ``train["cases"]`` (name → keyword arguments of
    :func:`mesh_train_run`) from ``train["weights"]`` on ``train["adj"]``'s
    episode graphs ``train["gi"]``, and ``train_agent`` of each (problem,
    rep) of ``train["agent"]`` (:func:`train_agent_run`)."""
    policy = policy_from_numpy(weights, device=dev)
    spec = mesh.shape
    out = {"rank": mesh.rank, "data": mesh.data.index,
           "rules": tile_rule_checks(mesh, dev, rules_adj)}
    reps = REPS + (("csr",) if spec[1] == 1 else ())
    for problem in PROBLEMS:
        for rep in reps:
            r = solve(policy, adj, num_layers=2, multi_node=True, rep=rep,
                      problem=problem, spatial=spec, device=dev)
            out["solve", problem, rep] = (r.solution, r.policy_evals,
                                          r.nodes_committed)
        if spec == (2, 2):
            svc = GraphSolverService(
                policy, PolicyConfig(embed_dim=8, spatial=spec),
                device=dev, multi_node=True, max_batch=2)
            out["service", problem] = [
                (r.id, r.solution, r.size, r.policy_evals)
                for r in svc.serve(stream, problem=problem)]
    for name, kw in train["cases"].items():
        out["train", name] = mesh_train_run(
            mesh, dev, train["weights"], train["adj"], train["gi"], **kw)
    for problem, rep in train["agent"]:
        out["agent", problem, rep] = train_agent_run(mesh, dev, train["adj"],
                                                     problem, rep)
    return out


# ---------------------------------------------------------------------------
# Async serving and open-loop load on the mesh, rank 0 the one planner
# (tests/test_torch_mesh_async.py).
# ---------------------------------------------------------------------------

STATS = ("requests", "batches", "partial_batches", "padded_rows",
         "compiles", "warmup_compiles", "cache_hits")


def _stats(svc):
    return {k: getattr(svc.stats, k) for k in STATS} | {
        "padded_rows_by_bucket": dict(svc.stats.padded_rows_by_bucket)}


def _answers(responses):
    return [(r.id, r.solution, r.size, r.policy_evals, r.bucket)
            for r in responses]


def _lead_or_follow(mesh, svc, lead):
    """Rank 0 runs ``lead(svc)`` and closes the service; the others
    follow it.  Returns rank 0's result, or the number of dispatches a
    follower ran, and every rank's stats."""
    if mesh.rank == 0:
        try:
            out = lead(svc)
        finally:
            svc.close()
    else:
        out = svc.follow()
    return {"out": out, "stats": _stats(svc)}


def _recording(svc):
    """Rank 0's responses of every dispatch, by request id (the load
    generator returns its report only)."""
    seen = {}
    dispatch = svc._dispatch

    def record(plan):
        responses = dispatch(plan)
        seen.update((r.id, (r.solution, r.size)) for r in responses)
        return responses
    svc._dispatch = record
    return seen


def async_shape(mesh, dev, weights, stream, buckets, workload_kw):
    """Everything tests/test_torch_mesh_async.py checks on one mesh
    shape, in one spawn: the SPMD sync service, then services whose rank
    0 leads and whose other ranks follow: async answers after a warmup
    on every rank, the fast reject at the depth bound, ``drain`` refused
    while async runs, ``close`` flushing an underfilled batch, a
    follower refusing ``submit_async``, and at (2, 2) open-loop load in
    both modes.  Returns this rank's results."""
    import threading
    from repro_torch.serving import (ServiceOverloaded, make_workload,
                                     run_open_loop)
    policy = policy_from_numpy(weights, device=dev)
    cfg = PolicyConfig(embed_dim=8, spatial=mesh.shape)

    def service(**kw):
        return GraphSolverService(policy, cfg, device=dev, multi_node=True,
                                  **kw)
    out = {"rank": mesh.rank}
    svc = service(max_batch=2)
    out["sync"] = _answers(svc.serve(stream))
    out["sync_stats"] = _stats(svc)

    # async after a warmup on every rank
    svc = service(max_batch=2, max_wait_ms=10.0)
    out["warmup"] = svc.warmup(buckets)["compiled"]

    def run_async(s):
        futures = [s.submit_async(a, deadline_ms=5_000.0) for a in stream]
        return _answers(f.result(timeout=60) for f in futures)
    out["async"] = _lead_or_follow(mesh, svc, run_async)
    out["channel"] = dict(svc._channel.stats)
    if mesh.rank != 0:
        try:
            svc.submit_async(stream[0])
        except ValueError as e:
            out["follower_error"] = str(e)

    # the fast reject at the depth bound, the dispatch thread pinned on
    # rank 0 by its device lock
    def reject(s):
        futures, rejected = [], 0
        with s._device_lock:
            futures.append(s.submit_async(stream[0]))
            deadline = time.time() + 10
            while len(s._sched) and time.time() < deadline:
                time.sleep(0.001)
            futures += [s.submit_async(stream[0]) for _ in range(2)]
            try:
                s.submit_async(stream[0])
            except ServiceOverloaded:
                rejected = s.stats.rejected
        return {"rejected": rejected,
                "sizes": [f.result(timeout=60).size for f in futures]}
    out["reject"] = _lead_or_follow(
        mesh, service(max_batch=1, max_wait_ms=0.0, max_queue_depth=2),
        reject)

    # drain() refused while async runs; close() flushes the batch
    def drain_refused(s):
        fut = s.submit_async(stream[0])
        try:
            s.drain()
            error = None
        except RuntimeError as e:
            error = str(e)
        s.close()
        return {"error": error, "bucket": fut.result(timeout=60).bucket}
    out["drain"] = _lead_or_follow(
        mesh, service(max_batch=2, max_wait_ms=1000.0), drain_refused)

    def flush(s):
        fut = s.submit_async(np.asarray(stream[1]))
        s.close()
        r = fut.result(timeout=60)
        return {"bucket": r.bucket, "n": len(r.solution)}
    out["flush"] = _lead_or_follow(
        mesh, service(max_batch=4, max_wait_ms=60_000.0), flush)

    if workload_kw is not None:
        for mode in ("async", "sync"):
            svc = service(max_batch=2, max_wait_ms=5.0)
            svc.warmup(buckets)

            def load(s, mode=mode):
                seen = _recording(s)
                rep = run_open_loop(s, make_workload(**workload_kw),
                                    mode=mode)
                return {"report": rep.as_dict(), "seen": seen}
            out["open_loop", mode] = _lead_or_follow(mesh, svc, load)
    out["threads"] = threading.active_count()
    return out


def idle_and_fail(mesh, dev, weights, stream, idle_s):
    """A service that idles ``idle_s`` (longer than the group's timeout)
    before rank 0 submits, then serves; then a service whose dispatch
    fails on rank 0 (an injected error): rank 0's future fails, the
    service refuses new work and its ``close()`` returns, and the other
    ranks raise from ``follow()`` within the group's timeout.  Rank 0
    stays in the group until they have, so theirs is the collective's
    timeout, not a peer gone.  Returns what each rank saw and how long
    the failure took it."""
    from torch.distributed import distributed_c10d
    store = distributed_c10d._get_default_store()
    policy = policy_from_numpy(weights, device=dev)
    cfg = PolicyConfig(embed_dim=8, spatial=mesh.shape)
    svc = GraphSolverService(policy, cfg, device=dev, multi_node=True,
                             max_batch=2, max_wait_ms=5.0)
    svc.warmup([a.shape[0] for a in stream])

    def idle_then_serve(s):
        time.sleep(idle_s)
        return _answers(f.result(timeout=60) for f in
                        [s.submit_async(a) for a in stream])
    t0 = time.perf_counter()
    out = {"idle": _lead_or_follow(mesh, svc, idle_then_serve),
           "idle_s": time.perf_counter() - t0}

    svc = GraphSolverService(policy, cfg, device=dev, multi_node=True,
                             max_batch=2, max_wait_ms=5.0)
    svc.warmup([a.shape[0] for a in stream])
    t0 = time.perf_counter()
    if mesh.rank == 0:
        def fail(*a, **k):
            raise RuntimeError("injected dispatch failure")
        svc._solve_fn = lambda nb, problem: fail
        fut = svc.submit_async(stream[0])
        seen = {}
        try:
            fut.result(timeout=60)
        except RuntimeError as e:
            seen["future"] = str(e)
        try:
            svc.submit_async(stream[0])
        except RuntimeError as e:
            seen["submit"] = str(e)
        svc.close()
        seen["closed_s"] = time.perf_counter() - t0
        store.wait([f"test/raised/{r}" for r in range(1, mesh.dp * mesh.sp)])
    else:
        seen = {}
        try:
            svc.follow()
        except RuntimeError as e:
            seen["follow"] = str(e)
        store.set(f"test/raised/{mesh.rank}", "1")
    out["fail"] = seen
    out["fail_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# The host training loop on the mesh (tests/test_torch_mesh_host.py).
# ---------------------------------------------------------------------------

def host_loop_run(mesh, dev, adj, weights, adam, *, rep, mode, problem,
                  n, b, mb, tau, steps, episodes):
    """``train_agent(engine="host")`` on this rank of ``mesh`` from JAX's
    weights and Adam state (numpy), tests/test_torch_host_engine.py's
    run.  Returns the replay ring, losses, episode lengths, weights, the
    step counts."""
    from repro_torch.convert import adam_from_numpy, policy_to_numpy
    from repro_torch.core import Agent, train_agent
    from repro_torch.core.replay import _FIELDS
    cfg = PolicyConfig(embed_dim=8, num_layers=2, minibatch=mb,
                       replay_capacity=64, learning_rate=1e-3,
                       graph_rep=rep, spatial=mesh.shape)
    agent = Agent(cfg, num_nodes=n, target_mode=mode, device=dev,
                  params=policy_from_numpy(weights, device=dev),
                  opt=adam_from_numpy(adam, device=dev))
    log = train_agent(agent, adj, problem=problem, episodes=episodes,
                      tau=tau, batch_graphs=b, max_steps=steps,
                      eval_every=10 ** 9, seed=0, engine="host")
    ring = agent.replay
    return {"ring": {f: getattr(ring, f).copy() for f in _FIELDS},
            "size": ring.size, "ptr": ring._ptr,
            "losses": np.array(log.losses), "lengths": log.episode_lengths,
            "params": policy_to_numpy(agent.params),
            "step_count": agent.step_count, "opt_step": int(agent.opt.step)}


def host_refusals(mesh, dev, adj):
    """The mesh host loop's refusals on this rank: a minibatch that does
    not divide by dp, nodes that do not divide by sp, CSR at sp > 1."""
    from repro_torch.core import Agent, train_agent
    out = {}
    for name, kw, graphs in (
            ("minibatch", dict(minibatch=7), adj),
            ("nodes", dict(minibatch=8), adj[:, :13, :13]),
            ("csr", dict(minibatch=8, graph_rep="csr"), adj)):
        cfg = PolicyConfig(embed_dim=8, replay_capacity=64,
                           spatial=mesh.shape, **kw)
        agent = Agent(cfg, num_nodes=graphs.shape[-1], device=dev)
        try:
            train_agent(agent, graphs, episodes=1, batch_graphs=2,
                        max_steps=2, engine="host")
        except ValueError as e:
            out[name] = str(e)
    return out


def host_shape(mesh, dev, adj, cases):
    """Everything tests/test_torch_mesh_host.py checks on one mesh
    shape, in one spawn: each case of ``cases`` (name → keyword arguments
    of :func:`host_loop_run`) and the refusals."""
    out = {"rank": mesh.rank, "refusals": host_refusals(mesh, dev, adj)}
    for name, kw in cases.items():
        out[name] = host_loop_run(mesh, dev, adj, **kw)
    return out
