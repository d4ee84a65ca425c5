"""The port's open-loop load generator (``repro_torch.serving.loadgen``)
against the JAX package's on the CPU: the same seeds and responses through
both, and the port's service driven open-loop in both modes.

Bars: workloads bit for bit JAX's (arrivals, sizes, adjacency bits);
``_report`` JAX's dict exactly on the same responses; every open-loop
request accounted for and answered as the JAX service answers that graph;
a mesh service's follower refused before anything is submitted; the
launcher's ``--rate`` line."""
import dataclasses

import numpy as np
import jax
import pytest

from repro.core import PolicyConfig as JaxPolicyConfig
from repro.core import init_policy as jax_init_policy
from repro.serving import GraphSolverService as JaxService
from repro.serving import SolveResponse as JaxResponse
from repro.serving import loadgen as jax_loadgen
from repro_torch.convert import policy_from_numpy
from repro_torch.core import PolicyConfig
from repro_torch.launch import solve_serve
from repro_torch.serving import (GraphSolverService, LoadReport,
                                 SolveResponse, Workload, make_workload,
                                 run_open_loop)
from repro_torch.serving import loadgen
from test_torch_serving import jax_to_numpy

SIZES = [6, 11]


@pytest.fixture(scope="module")
def pair():
    params = jax_init_policy(jax.random.key(3), JaxPolicyConfig(embed_dim=8))
    policy = policy_from_numpy(jax_to_numpy(params), device="cpu")
    return params, policy, PolicyConfig(embed_dim=8, num_layers=2)


def _assert_same_workload(want, got):
    assert isinstance(got, Workload)
    assert got.arrivals.dtype == want.arrivals.dtype
    np.testing.assert_array_equal(got.arrivals, want.arrivals)
    assert len(got) == len(want)
    for a, b in zip(got.adjs, want.adjs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.problem, got.deadline_ms, got.rate_rps, got.seed) == (
        want.problem, want.deadline_ms, want.rate_rps, want.seed)


@pytest.mark.parametrize("kind", ["er", "ba", "social"])
@pytest.mark.parametrize("deadline_ms", [None, 100.0])
def test_make_workload_equals_jax_bit_for_bit(kind, deadline_ms):
    kw = dict(problem="mis", kind=kind, rho=0.25, deadline_ms=deadline_ms,
              seed=11)
    _assert_same_workload(jax_loadgen.make_workload(40.0, 9, [12, 20], **kw),
                          make_workload(40.0, 9, [12, 20], **kw))


@pytest.mark.parametrize("rate", [0.0, -3.0])
def test_a_rate_that_is_not_positive_raises_as_jax(rate):
    with pytest.raises(ValueError, match="must be positive") as want:
        jax_loadgen.make_workload(rate, 4, SIZES)
    with pytest.raises(ValueError, match="must be positive") as got:
        make_workload(rate, 4, SIZES)
    assert str(got.value) == str(want.value)


def test_loadgen_deterministic_by_seed():
    """tests/test_serving_async.py's load generator properties."""
    w1 = make_workload(50.0, 30, SIZES, deadline_ms=100.0, seed=5)
    w2 = make_workload(50.0, 30, SIZES, deadline_ms=100.0, seed=5)
    assert (w1.arrivals == w2.arrivals).all()
    assert all((a == b).all() for a, b in zip(w1.adjs, w2.adjs))
    w3 = make_workload(50.0, 30, SIZES, deadline_ms=100.0, seed=6)
    assert (w1.arrivals != w3.arrivals).any()
    assert np.all(np.diff(w1.arrivals) > 0)     # arrivals strictly ordered
    assert {a.shape[0] for a in w1.adjs} <= set(SIZES)
    # one seed at another rate: the same graphs, the arrivals scaled
    w4 = make_workload(100.0, 30, SIZES, deadline_ms=100.0, seed=5)
    assert all((a == b).all() for a, b in zip(w1.adjs, w4.adjs))
    np.testing.assert_allclose(w4.arrivals, w1.arrivals / 2, rtol=1e-12)


@pytest.mark.parametrize("deadline_ms", [None, 2.5])
@pytest.mark.parametrize("count", [0, 5])
def test_report_equals_jax_on_the_same_responses(deadline_ms, count):
    rng = np.random.default_rng(7)
    wl = make_workload(30.0, 5, SIZES, deadline_ms=deadline_ms, seed=2)
    jwl = jax_loadgen.make_workload(30.0, 5, SIZES, deadline_ms=deadline_ms,
                                    seed=2)
    t0 = 100.0
    fields = [dict(id=i, solution=np.zeros(3, np.int32), size=0,
                   policy_evals=2, bucket=8, problem="mvc",
                   enqueue_t=t0 + rng.random() * 1e-2,
                   dispatch_t=t0 + 0.02,
                   complete_t=t0 + 0.02 + rng.random() * 1e-2)
              for i in range(count)]
    got = loadgen._report("async", wl, [SolveResponse(**f) for f in fields],
                          1, t0)
    want = jax_loadgen._report("async", jwl,
                               [JaxResponse(**f) for f in fields], 1, t0)
    assert isinstance(got, LoadReport)
    assert got.as_dict() == want.as_dict()


def _recording(svc):
    """``svc`` with every dispatched response kept, by request id (the
    load generator returns only its report)."""
    seen = {}
    dispatch = svc._dispatch

    def record(plan):
        responses = dispatch(plan)
        seen.update((r.id, r) for r in responses)
        return responses
    svc._dispatch = record
    return seen


@pytest.fixture(scope="module")
def workload():
    """tests/test_serving_async.py:225's stream: 200 rps, 12 requests, a
    10 s deadline."""
    return make_workload(200.0, 12, SIZES, deadline_ms=10_000.0, seed=3)


@pytest.fixture(scope="module")
def jax_answers(pair, workload):
    params, _, _ = pair
    svc = JaxService(params, JaxPolicyConfig(embed_dim=8, num_layers=2),
                     max_batch=3)
    return [r.solution for r in svc.serve(list(workload.adjs))]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_open_loop_reports_and_answers_as_jax(pair, workload, jax_answers,
                                              mode):
    _, policy, cfg = pair
    svc = GraphSolverService(policy, cfg, device="cpu", max_batch=3,
                             max_wait_ms=5.0)
    svc.warmup([8, 16])
    seen = _recording(svc)
    rep = run_open_loop(svc, workload, mode=mode)
    svc.close()
    assert svc.stats.compiles == 0
    assert rep.mode == mode and rep.offered_rps == 200.0
    assert rep.completed + rep.rejected == rep.submitted == 12
    assert rep.rejected == 0 and rep.on_time == rep.completed == 12
    assert 0.0 < rep.p50_ms <= rep.p99_ms
    assert rep.goodput_rps > 0.0
    assert sorted(seen) == list(range(12))   # ids follow submission order
    for i, want in enumerate(jax_answers):
        np.testing.assert_array_equal(seen[i].solution, want)


def test_unknown_mode_and_a_mesh_service_are_refused(pair, workload):
    _, policy, cfg = pair
    svc = GraphSolverService(policy, cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown drive mode"):
        run_open_loop(svc, workload, mode="burst")
    svc.mesh, svc.rank = object(), 1    # a follower of a mesh service
    for mode in ("sync", "async"):
        with pytest.raises(ValueError, match="rank 0 is the service's one "
                                             "front end and planner"):
            run_open_loop(svc, workload, mode=mode)
    assert svc.stats.requests == 0 and svc.pending() == 0


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_launcher_rate_prints_the_report_line(capsys, mode):
    solve_serve.main(["--device", "cpu", "--rate", "50", "--requests", "6",
                      "--embed-dim", "8", "--warmup", "--mode", mode,
                      "--deadline-ms", "10000", "--max-wait-ms", "5",
                      "--queue-depth", "64"])
    out = capsys.readouterr().out
    assert f"{mode} @ 50.0 rps offered: p50 " in out
    assert "(6/6 on time, 0 shed)" in out


def test_launcher_refuses_rate_on_a_mesh(monkeypatch):
    """``--rate`` on a mesh runs one process per rank: without torchrun
    the launcher asks for it (tests/test_torch_mesh_async.py runs it
    under torchrun)."""
    for var in solve_serve.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        solve_serve.main(["--device", "cpu", "--spatial", "1,2", "--rate",
                          "5"])


def test_report_is_a_dataclass_with_jax_fields():
    assert [f.name for f in dataclasses.fields(LoadReport)] == [
        f.name for f in dataclasses.fields(jax_loadgen.LoadReport)]
    assert [f.name for f in dataclasses.fields(Workload)] == [
        f.name for f in dataclasses.fields(jax_loadgen.Workload)]
