"""The port's 2-D (data, graph) mesh (repro_torch.core.{mesh,spatial} and
the mesh branches of s2v, qmodel, s2v_sparse, graphrep, engine, inference
and serving) against the JAX package on the CPU, on gloo ranks started by
``spawn_mesh``.  Mirrors tests/test_mesh.py: solutions, evaluation counts
and commit counts identical across mesh shapes and to JAX's single-device
solve; sharded scores within 1e-5; the service through the data axis equal
to the single-device service.  Each mesh shape spawns once (a module
fixture), with a time limit that kills its ranks."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import PolicyConfig as JaxPolicyConfig
from repro.core import init_policy as jax_init_policy
from repro.core import policy_scores as jax_policy_scores
from repro.core import random_graph_batch
from repro.core import solve as jax_solve
from repro.core import mesh as jax_mesh
from repro.kernels import ref
from repro.kernels.s2v_fused import mp_aggregate as jax_mp_aggregate
from repro.kernels.s2v_gather import sparse_mp_aggregate as jax_sparse_agg
from repro.serving import GraphSolverService as JaxService
from repro_torch.convert import policy_from_numpy
from repro_torch.core import (PolicyConfig, get_solve_step, init_state,
                              mesh, policy_scores, solve)
from repro_torch.core.s2v import embed_local
from repro_torch.kernels import s2v_fused as ks
from repro_torch.kernels import s2v_gather as kg
from repro_torch.launch import solve_serve
from repro_torch.serving import GraphSolverService
from torch_mesh_ranks import (KERNELS, REPS, fail_on_rank_one,
                              hang_on_rank_one, partial_state, run_shape)

MESHES = [(2, 1), (1, 2), (2, 2)]
SPAWN_TIMEOUT_S = 60.0
# f32: the mesh sums each aggregate and the graph embedding sum in row
# blocks, then across ranks (another rounding order than one product);
# bf16: one bf16 rounding (2^-8 relative) of each matmul operand.
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def jax_to_numpy(params):
    return {f"{part}.{f.name}": np.asarray(getattr(getattr(params, part),
                                                   f.name))
            for part in ("em", "q")
            for f in dataclasses.fields(getattr(params, part))}


@pytest.fixture(scope="module")
def case():
    """tests/test_mesh.py's solve case: ER N=16, B=4, seed 0, ρ=0.3,
    embed_dim=8; a partial solution for the scorers; a service stream."""
    params = jax_init_policy(jax.random.key(0), JaxPolicyConfig(embed_dim=8))
    weights = jax_to_numpy(params)
    adj = random_graph_batch("er", 16, 4, seed=0, rho=0.3)
    partial = (np.random.default_rng(1).random((4, 16)) < 0.25).astype(
        np.float32)
    rng = np.random.default_rng(0)
    stream = [random_graph_batch("er", int(n), 1, seed=i, rho=0.3)[0]
              for i, n in enumerate(rng.integers(5, 14, size=6))]
    return {"params": params, "weights": weights, "adj": adj,
            "partial": partial, "stream": stream,
            "policy": policy_from_numpy(weights, device="cpu")}


@pytest.fixture(scope="module")
def jax_solves(case):
    return {(rep, kernel): jax_solve(case["params"], case["adj"],
                                     num_layers=2, multi_node=True, rep=rep,
                                     kernel=kernel, engine="device")
            for rep in REPS for kernel in KERNELS}


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def mesh_run(request, case):
    """One spawn of a mesh shape running tests/torch_mesh_ranks.run_shape;
    the results of every rank, by rank."""
    dp, sp = request.param
    return request.param, mesh.spawn_mesh(
        run_shape, dp, sp, device="cpu", backend="gloo",
        timeout_s=SPAWN_TIMEOUT_S,
        args=(case["weights"], case["adj"], case["partial"], case["stream"]))


def _assert_result(got, want):
    sol, evals, committed = got
    assert (sol == want.solution).all()
    assert evals == want.policy_evals
    assert (committed == want.nodes_committed).all()


# ---------------------------------------------------------------------------
# Mesh specs and memory models (pure functions).
# ---------------------------------------------------------------------------

SPECS = [0, None, 1, 4, (2, 2), [2, 1], (1, 3), (1, 2, 3), (0, 2), -1]


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_spatial_specs_match_jax(spec):
    """The same (dp, sp), or the same error message, as JAX."""
    try:
        want = jax_mesh.normalize_spatial(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.normalize_spatial(spec)
        assert str(got.value) == str(e)
        return
    assert mesh.normalize_spatial(spec) == want
    assert mesh.is_multi(spec) == jax_mesh.is_multi(spec)


@pytest.mark.parametrize("text", ["0", "4", "2,2", " 1,4 "])
def test_parse_spatial_matches_jax(text):
    assert mesh.parse_spatial(text) == jax_mesh.parse_spatial(text)


@pytest.mark.parametrize("dp,p", [(1, 1), (2, 2), (1, 4)])
def test_per_device_byte_models_match_jax(dp, p):
    assert mesh.per_device_bytes(20480, 8, 0.15, p, 1000, dp) \
        == jax_mesh.per_device_bytes(20480, 8, 0.15, p, 1000, dp)
    assert mesh.sparse_per_device_bytes(4096, 768, 8, p, 10, dp) \
        == jax_mesh.sparse_per_device_bytes(4096, 768, 8, p, 10, dp)
    assert mesh.csr_per_device_bytes(10 ** 6, 2 * 10 ** 7, 1, 10, dp) \
        == jax_mesh.csr_per_device_bytes(10 ** 6, 2 * 10 ** 7, 1, 10, dp)


# ---------------------------------------------------------------------------
# Kernels B2 and B4 (plain versions) against the Pallas kernels and ref.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("b,k,nl,n", [(2, 8, 40, 40), (2, 16, 24, 48),
                                      (1, 32, 37, 130), (3, 5, 130, 131)],
                         ids=["Nl=N", "Nl<N", "ragged", "ragged-K5"])
def test_mp_aggregate_plain_matches_pallas_and_ref(compute, b, k, nl, n):
    rng = np.random.default_rng(b * n + nl)
    embed = (rng.random((b, k, nl), np.float32) - 0.5).astype(np.float32)
    adj = (rng.random((b, nl, n)) < 0.3).astype(np.float32)
    got = ks.mp_aggregate_plain(torch.from_numpy(embed),
                                torch.from_numpy(adj), compute).numpy()
    cd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[compute]
    pallas = np.asarray(jax_mp_aggregate(embed, adj, tile_n=16, tile_l=16,
                                         compute_dtype=cd, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL[compute])
    np.testing.assert_allclose(got, np.asarray(ref.mp_aggregate(embed, adj)),
                               **TOL[compute])
    before = ks.mp_aggregate.launches
    wrapped = ks.mp_aggregate(torch.from_numpy(embed), torch.from_numpy(adj),
                              compute)
    assert ks.mp_aggregate.launches == before      # CPU: the plain version
    np.testing.assert_array_equal(wrapped.numpy(), got)


def test_mp_aggregate_wrapper_rejects_bad_input():
    e, a = torch.zeros(1, 8, 4), torch.zeros(1, 5, 6)
    with pytest.raises(ValueError, match="shape mismatch"):
        ks.mp_aggregate(e, a)
    with pytest.raises(ValueError, match="compute"):
        ks.mp_aggregate(e, torch.zeros(1, 4, 6), "f16")
    with pytest.raises(TypeError, match="float32"):
        ks.mp_aggregate(e.double(), torch.zeros(1, 4, 6))


@pytest.mark.parametrize("nl,n,d", [(24, 48, 9), (40, 40, 12), (13, 50, 7)])
def test_sparse_aggregate_plain_at_row_blocks_matches_pallas_and_ref(nl, n,
                                                                     d):
    """B4 on the lists of Nl of the graph's N nodes (a graph rank's rows),
    with global ids and sentinel slots; the Nl = N case as before."""
    rng = np.random.default_rng(nl + n)
    x = (rng.random((2, 16, n + 1), np.float32) - 0.5).astype(np.float32)
    x[:, :, n] = 0.0
    nbr = rng.integers(0, n + 1, (2, nl, d)).astype(np.int32)
    edge = (rng.random((2, nl, d)) * (nbr < n)).astype(np.float32)
    got = kg.sparse_mp_aggregate(*(torch.from_numpy(t) for t in
                                   (x, nbr, edge))).numpy()
    assert got.shape == (2, 16, nl)
    np.testing.assert_allclose(
        got, np.asarray(jax_sparse_agg(x, nbr, edge, tile_n=8,
                                       interpret=True)), **TOL["f32"])
    np.testing.assert_allclose(
        got, np.asarray(ref.sparse_mp_aggregate(x, nbr, edge)), **TOL["f32"])


# ---------------------------------------------------------------------------
# In-process: what needs no ranks.
# ---------------------------------------------------------------------------

def test_single_rank_axis_runs_the_sharded_branches(case):
    """An axis of size 1 communicates nothing, so the sharded code runs in
    this process: its embeddings equal the single-device ones, and so do
    their gradients (the sharded aggregate's backward, B2's, is the
    einsum's vjp)."""
    st = init_state(case["adj"], device="cpu")
    em = case["policy"].em
    g = mesh.single_axis(mesh.GRAPH)
    for kernel in KERNELS:
        want = embed_local(em, st.adj, st.solution, num_layers=3,
                           kernel=kernel)
        got = embed_local(em, st.adj, st.solution, num_layers=3, axis=g,
                          kernel=kernel)
        torch.testing.assert_close(got, want, **TOL["f32"])
        grads = [torch.autograd.grad(
            embed_local(em, st.adj, st.solution, num_layers=3, axis=axis,
                        kernel=kernel).square().sum(), list(em.parameters()))
            for axis in (None, g)]
        for a, b in zip(*grads):
            torch.testing.assert_close(b, a, **TOL["f32"])


def test_mesh_needs_a_process_group_and_a_fitting_backend(case):
    with pytest.raises(RuntimeError, match="spawn_mesh"):
        mesh.make_mesh(1, 2)
    with pytest.raises(RuntimeError, match="spawn_mesh"):
        solve(case["policy"], case["adj"], spatial=(1, 2), device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        mesh.spawn_mesh(run_shape, 1, 2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        mesh.rank_device("mpi", "cpu", 0, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh.rank_device("nccl", "cuda", 0, 2)


def test_solve_refusals_match_jax(case):
    """Batch divisibility (before any rank is needed), CSR at sp > 1 (as
    engine._check_csr_spatial), and a mesh off the fused engine."""
    policy, adj = case["policy"], case["adj"]
    with pytest.raises(ValueError, match="batch 3 not divisible by the "
                                         "data-axis size 2"):
        solve(policy, adj[:3], spatial=(2, 1), device="cpu")
    for spec in ((1, 2), 2):
        with pytest.raises(ValueError, match="does not support spatial"):
            get_solve_step(rep="csr", spatial=spec)
    with pytest.raises(ValueError, match="fused path only"):
        solve(policy, adj, engine="host", spatial=(2, 1), device="cpu")


@pytest.mark.parametrize("rep", REPS)
def test_solve_at_1x1_is_the_single_device_solve(case, jax_solves, rep):
    res = solve(case["policy"], case["adj"], num_layers=2, multi_node=True,
                rep=rep, spatial=(1, 1), device="cpu")
    _assert_result((res.solution, res.policy_evals, res.nodes_committed),
                   jax_solves[rep, "fused"])


def test_launcher_parses_spatial_and_needs_torchrun(monkeypatch):
    for var in solve_serve.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        solve_serve.main(["--device", "cpu", "--spatial", "2,2",
                          "--dist-backend", "gloo"])
    with pytest.raises(RuntimeError, match="--nproc-per-node 2"):
        solve_serve.main(["--device", "cpu", "--spatial", "2"])
    for extra in (["--mode", "async"], ["--rate", "5"]):
        with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
            solve_serve.main(["--device", "cpu", "--spatial", "1,2"]
                             + extra)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="--dist-backend"):
        solve_serve.main(["--device", "cpu", "--spatial", "1,2"])


def test_spawn_mesh_raises_a_rank_error():
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of mesh \(1, 2\).*rank one fails"):
        mesh.spawn_mesh(fail_on_rank_one, 1, 2, device="cpu",
                        backend="gloo", timeout_s=SPAWN_TIMEOUT_S)


def test_spawn_mesh_kills_a_hung_rank():
    with pytest.raises(TimeoutError, match="did not finish within 5.0 s"):
        mesh.spawn_mesh(hang_on_rank_one, 1, 2, device="cpu",
                        backend="gloo", timeout_s=5.0)


# ---------------------------------------------------------------------------
# On gloo ranks, one spawn per mesh shape.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_mesh_solve_identical_to_jax_and_single_device(case, jax_solves,
                                                       mesh_run, rep,
                                                       kernel):
    """tests/test_mesh.py's bar: one full adaptive solve identical
    (solutions, eval counts, commit counts) on every rank to JAX's
    single-device solve and to the port's."""
    _spec, ranks = mesh_run
    single = solve(case["policy"], case["adj"], num_layers=2,
                   multi_node=True, rep=rep, kernel=kernel, device="cpu")
    for out in ranks:
        _assert_result(out["solve", rep, kernel], jax_solves[rep, kernel])
        _assert_result(out["solve", rep, kernel], single)


def test_mesh_csr_at_sp1_equals_dense_and_refuses_sp2(jax_solves, mesh_run):
    spec, ranks = mesh_run
    for out in ranks:
        if spec[1] == 1:
            _assert_result(out["solve", "csr", "fused"],
                           jax_solves["dense", "fused"])
        else:
            assert "does not support spatial" in out["csr_error"]


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("state", ["fresh", "partial"])
def test_sharded_scores_match_single_device_and_jax(case, mesh_run, rep,
                                                    state):
    """Each data rank's (B/dp, N) all-gathered scores within 1e-5 of the
    port's and JAX's single-device scores, on the fresh state and on a
    partial solution (which exercises the solution all-gather of the
    sparse residual factors)."""
    spec, ranks = mesh_run
    sol = case["partial"] if state == "partial" else np.zeros((4, 16),
                                                              np.float32)
    a, s, c = partial_state(case["adj"], sol)
    want = jax_policy_scores(case["params"], jnp.asarray(a.numpy()),
                             jnp.asarray(s.numpy()), jnp.asarray(c.numpy()),
                             num_layers=2)
    with torch.no_grad():
        single = policy_scores(case["policy"], a, s, c, num_layers=2).numpy()
    rows = 4 // spec[0]
    for out in ranks:
        got = out["scores", rep, state]
        block = slice(out["data"] * rows, (out["data"] + 1) * rows)
        np.testing.assert_allclose(got, np.asarray(want)[block],
                                   **TOL["f32"])
        np.testing.assert_allclose(got, single[block], **TOL["f32"])


def test_each_rank_holds_only_its_rows(mesh_run):
    spec, ranks = mesh_run
    dp, sp = spec
    d = int(np.asarray(random_graph_batch("er", 16, 4, seed=0, rho=0.3)
                       > 0).sum(-1).max())
    for out in ranks:
        assert out["state_shape", "dense"] == (4 // dp, 16 // sp, 16)
        assert out["state_shape", "sparse"] == ((4 // dp, 16 // sp, d),
                                                (4 // dp, 16))


def test_mesh_node_divisibility_error_matches_jax(mesh_run):
    spec, ranks = mesh_run
    for out in ranks:
        if spec[1] == 1:
            assert "node_error" not in out
        else:
            assert out["node_error"] == (
                f"dense scores: 15 node rows not divisible by graph-axis "
                f"size {spec[1]} of mesh {spec}")


def test_mesh_service_matches_single_device_service(case, mesh_run):
    """tests/test_mesh.py:210-260: a dp>1 service (max_batch per data
    rank) gives every request the single-device service's answer (the
    port's and JAX's) with as many rows per dispatch; a rank other than 0
    refuses async submissions (rank 0 is the one planner)."""
    spec, ranks = mesh_run
    if spec[0] == 1:
        assert all(("service", "dense") not in out for out in ranks)
        return
    stream = case["stream"]
    for rep in (("dense", "sparse") if spec == (2, 2) else ("dense",)):
        ref_svc = GraphSolverService(case["policy"], PolicyConfig(
            embed_dim=8), rep=rep, device="cpu", multi_node=True,
            max_batch=4)
        want = ref_svc.serve(stream)
        jax_want = JaxService(case["params"], JaxPolicyConfig(embed_dim=8),
                              rep=rep, multi_node=True,
                              max_batch=4).serve(stream)
        for out in ranks:
            svc = out["service", rep]
            assert svc["rows_per_dispatch"] == ref_svc.rows_per_dispatch
            assert svc["batches"] == ref_svc.stats.batches
            for (rid, sol, size, evals), r, j in zip(svc["responses"], want,
                                                     jax_want):
                assert rid == r.id == j.id and size == r.size == j.size
                np.testing.assert_array_equal(sol, r.solution)
                np.testing.assert_array_equal(sol, j.solution)
                assert evals == r.policy_evals
        for out in ranks:
            if out["rank"] == 0:
                assert "async_error" not in out
            else:
                assert "rank 0 is the service's one front end" \
                    in out["async_error"]
