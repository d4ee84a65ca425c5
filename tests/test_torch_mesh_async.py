"""Async serving and open-loop load on the port's 2-D (data, graph) mesh,
with rank 0 as the service's one planner (``repro_torch.serving.service``,
``core.mesh.PlanChannel``), against the JAX package's single-device
service on the CPU, on gloo ranks started by ``spawn_mesh``; the
launcher's ``--rate --mode async`` under ``torchrun``; a plan's wire form;
``enable_compile_cache``.

Bars: rank 0's async answers bit for bit the same ranks' sync ``serve()``
and JAX's service with as many rows per dispatch (solutions, sizes,
evaluations, buckets); after a warmup on every rank no request-path first
dispatch; the fast reject at the depth bound on rank 0; ``drain`` refused
while async runs; ``close`` flushing an underfilled batch; every
follower's stats rank 0's; a follower refusing ``submit_async``;
``run_open_loop`` in both modes accounting for every request with JAX's
answers; a (2, 1) service idling past its group's timeout, then serving;
an injected failure on rank 0 failing its future and every follower
raising within the group's timeout; the launcher's report line printed
once, by rank 0.  Each mesh shape spawns once, on first use, with a time
limit that kills its ranks."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core import PolicyConfig as JaxPolicyConfig
from repro.core import init_policy as jax_init_policy
from repro.core import random_graph_batch
from repro.serving import GraphSolverService as JaxService
from repro_torch.convert import policy_from_numpy
from repro_torch.core import PolicyConfig, mesh
from repro_torch.kernels import build
from repro_torch.launch import solve_serve
from repro_torch.serving import (GraphSolverService, bucket_nodes,
                                 build_plan, enable_compile_cache,
                                 make_workload, plan_from_payload,
                                 plan_payload)
from test_torch_mesh import jax_to_numpy
from torch_mesh_ranks import STATS, async_shape, idle_and_fail

MESHES = [(2, 2), (2, 1)]
SPAWN_TIMEOUT_S = 120.0
BUCKETS = [8, 16]
# the idle service: a short group timeout, and a longer idle before rank 0
# submits anything
GROUP_TIMEOUT_S, IDLE_S = 5.0, 6.0
# tests/test_serving_async.py:225's open-loop stream
WORKLOAD = dict(rate_rps=200.0, num_requests=12, sizes=[6, 11],
                deadline_ms=10_000.0, seed=3)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _shape_id(spec):
    return f"{spec[0]}x{spec[1]}"


@pytest.fixture(scope="module")
def case():
    """tests/test_torch_mesh.py's policy (embed_dim=8) and service stream:
    6 ER(0.3) graphs of 5 to 13 nodes."""
    params = jax_init_policy(jax.random.key(0), JaxPolicyConfig(embed_dim=8))
    rng = np.random.default_rng(0)
    return {"params": params, "weights": jax_to_numpy(params),
            "stream": [random_graph_batch("er", int(n), 1, seed=i,
                                          rho=0.3)[0]
                       for i, n in enumerate(rng.integers(5, 14, size=6))]}


@pytest.fixture(scope="module")
def spawns(case):
    """One spawn per mesh shape, on first use, running
    torch_mesh_ranks.async_shape (open-loop load at (2, 2))."""
    done = {}

    def run(spec):
        if spec not in done:
            done[spec] = mesh.spawn_mesh(
                async_shape, *spec, device="cpu", backend="gloo",
                timeout_s=SPAWN_TIMEOUT_S,
                args=(case["weights"], case["stream"], BUCKETS,
                      WORKLOAD if spec == (2, 2) else None))
        return spec, done[spec]
    return run


@pytest.fixture
def mesh_run(request, spawns):
    return spawns(request.param)


@pytest.fixture(scope="module")
def idle_run(case):
    """A (2, 1) mesh whose group times out after GROUP_TIMEOUT_S: its
    service idles IDLE_S, then serves; then a dispatch fails on rank 0."""
    return mesh.spawn_mesh(idle_and_fail, 2, 1, device="cpu",
                           backend="gloo", timeout_s=SPAWN_TIMEOUT_S,
                           group_timeout_s=GROUP_TIMEOUT_S,
                           args=(case["weights"], case["stream"][:3],
                                 IDLE_S))


def _jax_answers(case, adjs, rows):
    svc = JaxService(case["params"], JaxPolicyConfig(embed_dim=8),
                     multi_node=True, max_batch=rows)
    return svc.serve(list(adjs))


def _assert_answers(got, want):
    assert len(got) == len(want)
    for (rid, sol, size, evals, bucket), w in zip(got, want):
        assert rid == w.id and size == w.size and bucket == w.bucket
        assert evals == w.policy_evals
        np.testing.assert_array_equal(sol, w.solution)


# ---------------------------------------------------------------------------
# One process: the plan's wire form and the compile cache.
# ---------------------------------------------------------------------------

def test_plan_payload_round_trip_is_lossless(case):
    """A plan sent and rebuilt is the plan: the real requests' float32
    adjacencies travel whole (weighted values included, which the dense
    rep multiplies by) and the receiver pads them as the sender did."""
    rng = np.random.default_rng(4)
    reqs = []
    for i, a in enumerate(case["stream"][:3]):
        w = (a * rng.uniform(0.1, 3.0, a.shape)).astype(np.float32)
        reqs.append(type("R", (), dict(id=10 + i, n=a.shape[0], adj=w)))
    plan = build_plan(reqs, 16, "mvc", 4)
    payload = plan_payload(plan)
    assert payload.dtype == np.float32
    assert payload.size == sum(r.n ** 2 for r in reqs)
    got = plan_from_payload(16, "mvc", plan.request_ids, plan.sizes,
                            payload, 4)
    np.testing.assert_array_equal(got.adj, plan.adj)
    assert (got.request_ids, got.sizes) == (plan.request_ids, plan.sizes)
    with pytest.raises(ValueError, match="payload"):
        plan_from_payload(16, "mvc", plan.request_ids, plan.sizes,
                          payload[:-1], 4)


def test_enable_compile_cache_moves_the_kernel_build_root(case, tmp_path,
                                                          monkeypatch):
    """tests/test_serving_async.py:152-161: the port's restart cache is the
    kernel build root, moved to ``cache_dir``; serving is undisturbed."""
    monkeypatch.setattr(build, "BUILD_ROOT", build.BUILD_ROOT)
    assert enable_compile_cache(tmp_path / "kernels") is True
    assert build.build_dir().parent == (tmp_path / "kernels").resolve()
    svc = GraphSolverService(policy_from_numpy(case["weights"],
                                               device="cpu"),
                             PolicyConfig(embed_dim=8), device="cpu",
                             max_batch=1)
    svc.warmup([16])
    (resp,) = svc.serve([case["stream"][1]])
    assert resp.bucket == 16 and svc.stats.compiles == 0


# ---------------------------------------------------------------------------
# On gloo ranks, one spawn per mesh shape.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_run", MESHES, ids=_shape_id, indirect=True)
def test_async_answers_equal_sync_and_jax(case, mesh_run):
    """Rank 0's futures resolve to the same ranks' sync ``serve()`` answers
    bit for bit, and to JAX's single-device service's with max_batch · dp
    rows a dispatch; every rank's sync answers are rank 0's."""
    spec, ranks = mesh_run
    want = _jax_answers(case, case["stream"], 2 * spec[0])
    _assert_answers(ranks[0]["async"]["out"], want)
    for rk in ranks:
        _assert_answers(rk["sync"], want)


@pytest.mark.parametrize("mesh_run", MESHES, ids=_shape_id, indirect=True)
def test_warmup_on_every_rank_leaves_no_request_path_first_dispatch(
        mesh_run):
    _, ranks = mesh_run
    for rk in ranks:
        assert [tuple(c) for c in rk["warmup"]] == [(8, "mvc"), (16, "mvc")]
        st = rk["async"]["stats"]
        assert st["compiles"] == 0 and st["warmup_compiles"] == 2
        assert st["cache_hits"] == st["batches"] > 0


@pytest.mark.parametrize("mesh_run", MESHES, ids=_shape_id, indirect=True)
def test_followers_count_as_rank_zero(mesh_run):
    """Each follower runs rank 0's dispatches: its batches, partial
    batches, padded rows (by bucket), first dispatches and requests
    equal rank 0's, service by service, and ``follow()`` returns the
    number of dispatches; the plans (dispatches and the stop) are the
    same count on every rank."""
    _, ranks = mesh_run
    runs = [k for k in ranks[0] if k in ("async", "reject", "drain", "flush")
            or (isinstance(k, tuple) and k[0] == "open_loop")]
    assert len(runs) >= 4
    for rk in ranks[1:]:
        for k in runs:
            assert rk[k]["stats"] == ranks[0][k]["stats"], k
            assert rk[k]["out"] == rk[k]["stats"]["batches"], k
        assert rk["channel"]["plans"] == ranks[0]["channel"]["plans"] \
            == ranks[0]["async"]["stats"]["batches"] + 1
        # the stream's float32 adjacencies, unpadded, once each
        assert rk["channel"]["payload_bytes"] \
            == ranks[0]["channel"]["payload_bytes"] \
            == 4 * sum(r[1].size ** 2 for r in ranks[0]["async"]["out"])
    assert set(STATS) <= set(ranks[0]["async"]["stats"])


@pytest.mark.parametrize("mesh_run", MESHES, ids=_shape_id, indirect=True)
def test_fast_reject_at_the_depth_bound_on_rank_zero(mesh_run):
    _, ranks = mesh_run
    got = ranks[0]["reject"]
    assert got["out"]["rejected"] == 1
    assert len(got["out"]["sizes"]) == 3         # admitted ones all resolve
    assert got["stats"]["requests"] == 3


@pytest.mark.parametrize("mesh_run", MESHES, ids=_shape_id, indirect=True)
def test_drain_refused_while_async_runs_and_close_flushes(case, mesh_run):
    spec, ranks = mesh_run
    got = ranks[0]["drain"]["out"]
    assert "async scheduler is running" in got["error"]
    assert got["bucket"] == bucket_nodes(case["stream"][0].shape[0])
    # one request in a batch of 4 · dp rows: flushed by close()
    n = case["stream"][1].shape[0]
    nb, rows = bucket_nodes(n), 4 * spec[0]
    for rk in ranks:
        st = rk["flush"]["stats"]
        assert st["partial_batches"] == st["batches"] == 1
        assert st["padded_rows_by_bucket"] == {nb: rows - 1}
    assert ranks[0]["flush"]["out"] == {"bucket": nb, "n": n}


@pytest.mark.parametrize("mesh_run", MESHES, ids=_shape_id, indirect=True)
def test_a_follower_refuses_submit_async(mesh_run):
    spec, ranks = mesh_run
    assert "follower_error" not in ranks[0]
    for rk in ranks[1:]:
        assert rk["follower_error"].startswith(
            f"rank {rk['rank']} of the mesh {spec} takes no submissions: "
            f"rank 0 is the service's one front end")


@pytest.mark.parametrize("mesh_run", [(2, 2)], ids=_shape_id, indirect=True)
@pytest.mark.parametrize("mode", ["async", "sync"])
def test_open_loop_on_the_mesh_answers_as_jax(case, mesh_run, mode):
    """``run_open_loop`` on rank 0 of a (2, 2) service, the others
    following: every request accounted for and on time, each answered as
    JAX's single-device service answers that graph."""
    _, ranks = mesh_run
    got = ranks[0]["open_loop", mode]["out"]
    rep, seen = got["report"], got["seen"]
    assert rep["mode"] == mode
    assert rep["submitted"] == rep["completed"] == rep["on_time"] == 12
    assert rep["rejected"] == 0 and 0.0 < rep["p50_ms"] <= rep["p99_ms"]
    assert sorted(seen) == list(range(12))
    want = _jax_answers(case, make_workload(**WORKLOAD).adjs, 4)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(seen[i][0], w.solution)
        assert seen[i][1] == w.size
    for rk in ranks:
        assert rk["open_loop", mode]["stats"]["compiles"] == 0


# ---------------------------------------------------------------------------
# An idle service and a failed dispatch, on a short group timeout.
# ---------------------------------------------------------------------------

def test_an_idle_service_outlives_the_group_timeout(case, idle_run):
    """The followers wait for rank 0's next plan in the store, not in a
    collective, so a service idle for longer than the group's timeout
    still serves, with JAX's answers."""
    want = _jax_answers(case, case["stream"][:3], 4)
    assert IDLE_S > GROUP_TIMEOUT_S
    for rk in idle_run:
        assert rk["idle_s"] >= IDLE_S
    _assert_answers(idle_run[0]["idle"]["out"], want)
    assert idle_run[1]["idle"]["stats"] == idle_run[0]["idle"]["stats"]


def test_a_failed_dispatch_leaves_no_rank_hanging(idle_run):
    """A dispatch that fails on rank 0 after its plan went out: rank 0's
    future raises the error, the service refuses new work and its
    ``close()`` returns at once; the follower, left in a collective of
    that dispatch, raises when the group's timeout runs out (rank 0 is
    still in the group)."""
    lead, follower = idle_run
    assert lead["fail"]["future"] == "injected dispatch failure"
    assert lead["fail"]["submit"].startswith(
        "this mesh service failed in a dispatch and serves no more")
    assert lead["fail"]["closed_s"] < GROUP_TIMEOUT_S
    assert "Timed out" in follower["fail"]["follow"]
    assert GROUP_TIMEOUT_S <= follower["fail_s"] < 4 * GROUP_TIMEOUT_S


# ---------------------------------------------------------------------------
# The launcher under torchrun.
# ---------------------------------------------------------------------------

LAUNCH = ["--device", "cpu", "--rate", "50", "--requests", "6",
          "--embed-dim", "8", "--warmup", "--mode", "async",
          "--deadline-ms", "10000", "--max-wait-ms", "5", "--queue-depth",
          "64"]


def test_launcher_rate_async_on_a_mesh_under_torchrun():
    """``--spatial 2,1 --rate 50 --mode async`` on two gloo CPU ranks
    under torchrun: rank 0 makes the stream, submits it and prints the
    report line, once; rank 1 follows."""
    env_vars = dict(os.environ, PYTHONPATH=SRC)
    for var in solve_serve.TORCHRUN_VARS:
        env_vars.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.solve_serve",
         "--spatial", "2,1", "--dist-backend", "gloo", *LAUNCH],
        env=env_vars, capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("async @ 50.0 rps offered: p50 ") == 1
    assert "(6/6 on time, 0 shed)" in proc.stdout
