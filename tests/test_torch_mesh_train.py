"""Training on the port's 2-D (data, graph) mesh (repro_torch.core.spatial's
GD step, the sharded replay, the tile re-materialization and the
collectives autograd sees) against the JAX package's single-device step on
the CPU, on gloo ranks started by ``spawn_mesh``.

Bars: with JAX's draws injected, the mesh step at (2,1), (1,2) and (2,2)
(dense and sparse, fused, stored at epsilon 0 and fresh at 0.5) and at
(2,1) (CSR) takes JAX's actions, and its losses and parameters are within
atol 1e-6 (rtol 1e-5) of JAX's single-device step, the bar
tests/test_mesh.py holds JAX's own mesh to; every rank ends with the same
parameters, bit for bit.  The "xla" chain and bf16 at (1,2): the xla
chain by the same bar, bf16 within 2e-2 of the single-device port at
bf16 (one bf16 rounding of each operand, whose partial sums meet in
another order on the mesh).  The collectives' gradients within 1e-5 of
autograd of the whole computation in one process; re-materialized tiles,
the sharded ring and its samples bit for bit.  Each mesh shape spawns
once (a module fixture) with a time limit that kills its ranks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine_init as jax_engine_init
from repro.core import get_rep as jax_get_rep
from repro.core import get_train_step as jax_get_train_step
from repro.core import mesh as jax_mesh
from repro.core import random_graph_batch
from repro.core.qmodel import NEG_INF
from repro.optim import adam_init as jax_adam_init
from repro_torch.convert import policy_from_numpy, policy_to_numpy
from repro_torch.core import (PolicyConfig, TrainDraws, engine_init, get_rep,
                              get_train_step, mesh)
from repro_torch.core.s2v import _AggregateFused
from repro_torch.core.spatial import ownership_loss
from repro_torch.kernels.s2v_fused import (fused_s2v_layer_sparse_plain,
                                           mp_aggregate_plain)
from repro_torch.kernels.s2v_gather import sparse_mp_aggregate_plain
from repro_torch.optim import adam_init
from test_torch_train import KEYS, STEP_TOL, _cfgs, _pair, jax_to_numpy
from torch_mesh_ranks import rank_weights, train_shape

MESHES = [(2, 1), (1, 2), (2, 2)]
SPAWN_TIMEOUT_S = 120.0
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# tests/test_engine.py's train configuration, as tests/test_torch_train.py's
# lockstep runs it: 4 ER(0.3) graphs of 14 nodes, 2 episode graphs
N, STEPS, TAU = 14, 8, 2
GI = np.array([0, 2])
CFG = dict(embed_dim=8, num_layers=2, minibatch=8, replay_capacity=64,
           learning_rate=1e-3)
# (rep, target mode, epsilon, kernel) of the cases held to JAX's
# single-device step, by name
JAX_CASES = {f"{rep} {mode}": (rep, mode, eps, "fused")
             for rep in ("dense", "sparse")
             for mode, eps in (("stored", 0.0), ("fresh", 0.5))}
JAX_CASES.update({f"csr {mode}": ("csr", mode, eps, "fused")
                  for mode, eps in (("stored", 0.0), ("fresh", 0.5))})
JAX_CASES.update({f"{rep} xla": (rep, "fresh", 0.5, "xla")
                  for rep in ("dense", "sparse")})
# bf16, against the port's single-device step: epsilon 1, so that every
# action is the draws' pick (or, with no candidate left, node 0) whatever
# the bf16 scores' rounding, and the runs stay comparable
BF16_CASES = {f"{rep} bf16": (rep, "fresh", 1.0) for rep in ("dense",
                                                             "sparse")}


def _cases_at(spec):
    names = [n for n in JAX_CASES if not n.endswith("xla")
             and not n.startswith("csr")]
    if spec == (2, 1):
        names += ["csr stored", "csr fresh"]
    if spec == (1, 2):
        names += ["dense xla", "sparse xla", *BF16_CASES]
    return names


@pytest.fixture(scope="module")
def adj():
    return random_graph_batch("er", N, 4, seed=0, rho=0.3)


def _jax_run(adj, rep, target_mode, eps, kernel, problem="mvc"):
    """JAX's fused step of ``problem`` on one device, as
    tests/test_torch_train.py's ``_lockstep`` drives it; each step's draws
    (JAX's key schedule) as numpy, the losses, actions and trained
    weights."""
    from repro.core import env as jax_env
    jcfg, _ = _cfgs(**CFG, eps_start=eps, eps_end=eps, kernel=kernel)
    params, _ = _pair(jcfg)
    weights = jax_to_numpy(params)          # the step donates its carry
    jrep = jax_get_rep(rep)
    step = jax_get_train_step(jcfg, rep=jrep, problem=problem, tau=TAU,
                              target_mode=target_mode)
    es = jax_engine_init(jcfg, params, jax_adam_init(params), N, seed=0)
    source = jrep.prepare_dataset(adj)
    state = jrep.state_from_tuples(
        source, GI, np.zeros((len(GI), N), np.float32),
        residual=jax_env.residual_mode(problem),
        candidate_fn=jax_env.candidate_rule(problem))
    key, size, b, mb = jax.random.key(0), 0, len(GI), CFG["minibatch"]
    draws, losses, actions = [], [], []
    for _ in range(STEPS):
        key, k_eps, k_pick, k_train = jax.random.split(key, 4)
        logits = jnp.where(state.candidate > 0.5, 0.0, NEG_INF)
        size = min(size + b, CFG["replay_capacity"])
        draws.append((
            np.array(jax.random.uniform(k_eps, (b,))),
            np.array(jax.random.categorical(k_pick, logits, axis=-1)),
            np.stack([np.asarray(jax.random.randint(k, (mb,), 0,
                                                    max(size, 1)))
                      for k in jax.random.split(k_train, TAU)])))
        es, state, a, _, _, loss = step(es, state, source,
                                        jnp.asarray(GI, jnp.int32))
        losses.append(float(loss))
        actions.append(np.asarray(a))
    return {"draws": draws, "losses": np.array(losses),
            "actions": np.stack(actions), "params": jax_to_numpy(es.params),
            "weights": weights}


def _port_run(adj, weights, draws, rep, target_mode, eps, compute):
    """The port's single-device step with the same weights and draws."""
    cfg = PolicyConfig(**CFG, eps_start=eps, eps_end=eps, compute=compute)
    policy = policy_from_numpy(weights, device="cpu")
    r = get_rep(rep)
    source = r.prepare_dataset(adj, device="cpu")
    es = engine_init(cfg, policy, adam_init(policy), N)
    step = get_train_step(cfg, rep=r, tau=TAU, target_mode=target_mode)
    state = r.state_from_tuples(source, torch.from_numpy(GI),
                                np.zeros((len(GI), N), np.float32))
    losses, actions = [], []
    for d in draws:
        es, state, a, _, _, loss = step(es, state, source,
                                        torch.from_numpy(GI), TrainDraws(
                                            *map(torch.as_tensor, d)))
        losses.append(float(loss))
        actions.append(a.numpy())
    return {"losses": np.array(losses), "actions": np.stack(actions),
            "params": policy_to_numpy(policy)}


@pytest.fixture(scope="module")
def refs(adj):
    """JAX's single-device runs of every JAX case, and the port's
    single-device bf16 runs on the draws of JAX's fresh runs."""
    out = {name: _jax_run(adj, *case) for name, case in JAX_CASES.items()}
    for name, (rep, mode, eps) in BF16_CASES.items():
        jax_ref = out[f"{rep} fresh"]
        out[name] = dict(_port_run(adj, jax_ref["weights"], jax_ref["draws"],
                                   rep, mode, eps, "bf16"),
                         draws=jax_ref["draws"], weights=jax_ref["weights"])
    return out


def _shape_id(spec):
    return f"{spec[0]}x{spec[1]}"


@pytest.fixture(scope="module")
def spawns(adj, refs):
    """One spawn per mesh shape, on first use, running
    torch_mesh_ranks.train_shape on every case of that shape; the results
    of every rank, by rank."""
    done = {}

    def run(spec):
        if spec not in done:
            cases = {}
            for name in _cases_at(spec):
                if name in BF16_CASES:
                    rep, mode, eps = BF16_CASES[name]
                    kernel, compute = "fused", "bf16"
                else:
                    rep, mode, eps, kernel = JAX_CASES[name]
                    compute = "f32"
                cases[name] = dict(draws=refs[name]["draws"], rep=rep,
                                   target_mode=mode, eps=eps, kernel=kernel,
                                   compute=compute, tau=TAU, **CFG)
            weights = refs["dense stored"]["weights"]
            done[spec] = mesh.spawn_mesh(
                train_shape, *spec, device="cpu", backend="gloo",
                timeout_s=SPAWN_TIMEOUT_S, args=(weights, adj, GI, cases))
        return spec, done[spec]
    return run


@pytest.fixture
def mesh_run(request, spawns):
    """The spawn of the mesh shape ``request.param``."""
    return spawns(request.param)


# ---------------------------------------------------------------------------
# The mesh step against JAX's single-device step.
# ---------------------------------------------------------------------------

def _assert_steps(got, want, tol):
    np.testing.assert_array_equal(got["actions"], want["actions"])
    warm = np.isfinite(want["losses"])
    np.testing.assert_array_equal(np.isfinite(got["losses"]), warm)
    assert warm.sum() >= 4
    np.testing.assert_allclose(got["losses"][warm], want["losses"][warm],
                               **tol)
    for k in KEYS:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   **tol, err_msg=k)


@pytest.mark.parametrize(
    "mesh_run,name", [(spec, name) for spec in MESHES
                      for name in _cases_at(spec)],
    ids=[f"{_shape_id(spec)}-{name}" for spec in MESHES
         for name in _cases_at(spec)], indirect=["mesh_run"])
def test_mesh_step_matches_the_single_device_step(mesh_run, refs, name):
    """Identical actions, losses and parameters within the module's bar
    on every rank, and the ranks' parameters equal bit for bit."""
    spec, ranks = mesh_run
    bf16 = name in BF16_CASES
    for rk in ranks:
        got = rk["train", name]
        _assert_steps(got, refs[name], BF16_TOL if bf16 else STEP_TOL)
        for k in KEYS:
            np.testing.assert_array_equal(got["params"][k],
                                          ranks[0]["train", name]["params"][k])
        assert got["step_count"] == int(np.isfinite(got["losses"]).sum())
    if name.endswith("fresh") and not bf16:
        assert (refs[name]["draws"][0][0] < 0.5).any()   # some rows explored


# ---------------------------------------------------------------------------
# The collectives autograd sees, the tiles and the ring.
# ---------------------------------------------------------------------------

def _whole_grads(sp, seed=7, b=2, k=4, n=12):
    """The collectives' cases of torch_mesh_ranks.collective_grads as one
    process's whole, ungathered computation: autograd's gradients."""
    from repro_torch.core.graphs import (random_graph_batch as rgb,
                                         residual_edge_mask,
                                         sparse_batch_from_dense)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, k, n)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    adj = rgb("er", n, b, seed=seed, rho=0.4)
    sol = torch.from_numpy((rng.random((b, n)) < 0.3).astype(np.float32))
    t4 = torch.from_numpy(rng.standard_normal((k, k)).astype(np.float32))
    base = torch.from_numpy(rng.standard_normal((b, k, n)).astype(
        np.float32))
    lists = sparse_batch_from_dense(adj, device="cpu")
    edge = residual_edge_mask(lists.neighbors, lists.valid, sol)
    w = torch.from_numpy(sum(rank_weights((b, k), seed, r)
                             for r in range(sp)))
    wl = torch.from_numpy(np.concatenate(
        [rank_weights((b, k, n // sp), seed + 1, r) for r in range(sp)], 2))

    def grad_of(fn, *leaves):
        leaves = [t.clone().requires_grad_(True) for t in leaves]
        fn(*leaves).backward()
        return [t.grad.numpy() for t in leaves]
    return {
        "pooled": grad_of(lambda xx: (w * xx.sum(-1)).sum(), x)[0],
        "columns": grad_of(lambda xx: (wl * torch.einsum(
            "bkl,ln->bkn", xx, a)).sum(), x)[0],
        "layer": grad_of(lambda t, xx, bb: (wl * fused_s2v_layer_sparse_plain(
            t, xx, lists.neighbors, edge, bb)).sum(), t4, x, base),
        "aggregate": grad_of(lambda xx: (wl * sparse_mp_aggregate_plain(
            torch.nn.functional.pad(xx, (0, 1)), lists.neighbors,
            edge)).sum(), x)[0]}


@pytest.mark.parametrize("mesh_run", MESHES, ids=_shape_id, indirect=True)
@pytest.mark.parametrize("case", ["pooled", "columns", "layer", "aggregate"])
def test_collective_gradients_equal_autograd_of_the_whole(mesh_run, case):
    """Each rank's gradients of its own slice (and θ4's, summed over a
    graph row of ranks) equal autograd of the whole computation; the
    pooled sum as an in-place all-reduce would leave it (each rank's own
    loss terms) does not."""
    spec, ranks = mesh_run
    want = _whole_grads(spec[1])
    n = want["pooled"].shape[-1]
    for rk in ranks:
        cols = slice(rk["graph"] * n // spec[1], (rk["graph"] + 1) * n
                     // spec[1])
        got = rk["grads"][case]
        if case == "pooled":
            np.testing.assert_allclose(got, want[case][:, :, cols],
                                       **GRAD_TOL)
            if spec[1] > 1:
                assert not np.allclose(rk["grads"]["naive"],
                                       want[case][:, :, cols], **GRAD_TOL)
        elif case == "layer":
            t4 = sum(r["grads"]["layer"][0] for r in ranks
                     if r["data"] == rk["data"])
            np.testing.assert_allclose(t4, want[case][0], **GRAD_TOL)
            for got_i, want_i in zip(got[1:], want[case][1:]):
                np.testing.assert_allclose(got_i, want_i[:, :, cols],
                                           **GRAD_TOL)
        else:
            np.testing.assert_allclose(got, want[case][:, :, cols],
                                       **GRAD_TOL)


@pytest.mark.parametrize("mesh_run", MESHES, ids=_shape_id, indirect=True)
def test_tiles_and_ring_equal_the_single_device_ones(mesh_run):
    """tile_from_tuples in both modes, the sharded ring after wrapping
    pushes, and its minibatch samples equal the matching rows and columns
    of the single-device ones bit for bit; a capacity the data axis does
    not divide is refused."""
    _, ranks = mesh_run
    for rk in ranks:
        assert rk["tiles"] == [], rk["tiles"]


# ---------------------------------------------------------------------------
# In one process: what needs no ranks.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_sharded_dense_aggregate_backward_is_the_einsum_vjp(compute):
    """B2's backward (``cd(grad @ cd(adj_rows)ᵀ)``) against autograd of its
    plain composition and ``jax.vjp`` of JAX's aggregate einsum; the
    adjacency takes no gradient."""
    from repro.core.s2v import _agg_jnp
    rng = np.random.default_rng(5)
    embed = rng.standard_normal((2, 4, 6)).astype(np.float32)
    adj = (rng.random((2, 6, 10)) < 0.4).astype(np.float32)
    g = rng.standard_normal((2, 4, 10)).astype(np.float32)
    e = torch.tensor(embed, requires_grad=True)
    (got,) = torch.autograd.grad(_AggregateFused.apply(
        e, torch.from_numpy(adj), compute), [e], torch.from_numpy(g))
    e2 = torch.tensor(embed, requires_grad=True)
    (want,) = torch.autograd.grad(mp_aggregate_plain(
        e2, torch.from_numpy(adj), compute), [e2], torch.from_numpy(g))
    assert torch.equal(got, want)
    cd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[compute]
    _, vjp = jax.vjp(lambda x: _agg_jnp(x, adj, cd), embed)
    tol = BF16_TOL if compute == "bf16" else GRAD_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(g)[0],
                                                       np.float32), **tol)
    a = torch.tensor(adj, requires_grad=True)
    with pytest.raises(NotImplementedError, match="adjacency"):
        _AggregateFused.apply(e, a, compute).sum().backward()


def test_ownership_loss_splits_the_single_device_mean():
    """The ranks' ownership losses over their column blocks sum to the
    single-device mean squared TD error, and each one's gradient is zero
    outside the actions it owns."""
    rng = np.random.default_rng(2)
    s = torch.from_numpy(rng.standard_normal((6, 12)).astype(np.float32))
    act = torch.from_numpy(rng.integers(0, 12, 6))
    tgt = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    want = torch.mean(torch.square(s[torch.arange(6), act] - tgt))
    parts = []
    for i in range(3):
        axis = mesh.Axis("graph", 3, i)
        sl = s[:, axis.rows(12)].clone().requires_grad_(True)
        part = ownership_loss(sl, act, tgt, axis, 6)
        part.backward()
        owned = (act // 4 == i).numpy()
        assert not sl.grad.numpy()[~owned].any()
        parts.append(float(part.detach()))
    np.testing.assert_allclose(sum(parts), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(ownership_loss(s, act, tgt, None, 6)),
                               float(want), rtol=1e-6)


@pytest.mark.parametrize("rep", ["dense", "sparse"])
@pytest.mark.parametrize("collectives", ["auto", "manual", "gspmd"])
@pytest.mark.parametrize("dp,sp", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)])
def test_minibatch_operand_bytes_match_jax(rep, collectives, dp, sp):
    kw = dict(n=4096, minibatch=64, dp=dp, sp=sp, collectives=collectives,
              rep=rep, max_deg=718 if rep == "sparse" else None)
    assert mesh.minibatch_operand_bytes(**kw) == \
        jax_mesh.minibatch_operand_bytes(**kw)


def test_mesh_train_refusals():
    """JAX's refusals before any rank is needed: a minibatch the data axis
    does not divide, CSR at sp > 1, collectives="manual" with CSR; the
    port's own: "gspmd" (it has no GSPMD path); a mesh config without a
    process group names spawn_mesh, for MIS as for MVC."""
    base = PolicyConfig(embed_dim=8, minibatch=8)
    cases = [
        (dict(spatial=(3, 1)), {}, ValueError, "minibatch 8 not divisible"),
        (dict(spatial=(1, 2), graph_rep="csr"), {}, ValueError,
         "does not support spatial"),
        (dict(spatial=(2, 1), graph_rep="csr", collectives="manual"), {},
         ValueError, "does not apply to rep='csr'"),
        (dict(spatial=(2, 2), collectives="gspmd"), {}, ValueError,
         "no counterpart"),
        (dict(spatial=(2, 1)), dict(problem="mis"), RuntimeError,
         "spawn_mesh"),
        (dict(spatial=(2, 2)), {}, RuntimeError, "spawn_mesh")]
    for cfg_kw, kw, err, match in cases:
        with pytest.raises(err, match=match):
            get_train_step(dataclasses.replace(base, **cfg_kw), **kw)
    # collectives is JAX's option: "gspmd" at (1, 1) trains on one device
    get_train_step(dataclasses.replace(base, collectives="gspmd"))
    one = mesh.Mesh(2, 1, 0, mesh.Axis("data", 2, 0), mesh.single_axis(
        "graph"))
    from repro_torch.core import device_replay_init
    with pytest.raises(ValueError, match="capacity 63 not divisible"):
        device_replay_init(63, 8, device="cpu", mesh=one)
