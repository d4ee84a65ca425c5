"""Open-loop Poisson load generator and latency measurement harness
(DESIGN.md §14).  Counterpart of ``repro/serving/loadgen.py``.

Closed-loop load (submit a batch, wait, submit the next) measures the
server at whatever rate the server itself sets, so it never observes
overload, which is exactly the regime the ROADMAP's "millions of users"
goal cares about.  This module drives the service *open-loop*: arrivals
follow a seeded Poisson process at a configured offered rate, independent
of completions, so queueing delay and load shedding show up in the
numbers instead of being hidden by the load generator.

Everything is deterministic given the seed: exponential inter-arrival
gaps, request sizes, and the request graphs all derive from one
``np.random.default_rng(seed)`` stream (tested in
``tests/test_serving_async.py``), so a latency benchmark re-run replays
the identical workload.

Two drive modes share one workload:

- ``mode="async"`` — ``submit_async`` at each arrival; futures resolve as
  the background scheduler dispatches; ``ServiceOverloaded`` rejects are
  counted, not retried (open loop: the "user" walked away).
- ``mode="sync"`` — a feeder thread ``submit()``s at each arrival while
  the measuring thread repeatedly ``drain()``s — the strongest batch-mode
  baseline that still honours arrival times.

The report's **goodput** is completed-within-deadline requests per second
of wall time from first arrival to last completion — late completions and
rejects both subtract from it, which is what makes the sync path's
unbounded queueing visible at overload.

On a mesh service (``svc.mesh``) the load runs on rank 0, the service's
one planner, in both modes (``GraphSolverService.lead``): the sync
mode's drains plan for every rank as the async scheduler does.  The
other ranks call ``svc.follow()`` until rank 0's ``svc.close()``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .service import GraphSolverService, ServiceOverloaded, SolveResponse


@dataclasses.dataclass(frozen=True)
class Workload:
    """One reproducible open-loop request stream."""
    arrivals: np.ndarray           # (R,) seconds from t0, strictly increasing
    adjs: Tuple[np.ndarray, ...]   # (R,) request graphs
    problem: str
    deadline_ms: Optional[float]   # per-request SLO (None: no deadline)
    rate_rps: float                # offered load the arrivals realize
    seed: int

    def __len__(self) -> int:
        return len(self.adjs)


def make_workload(rate_rps: float, num_requests: int,
                  sizes: Sequence[int], *, problem: str = "mvc",
                  kind: str = "er", rho: float = 0.3,
                  deadline_ms: Optional[float] = None,
                  seed: int = 0) -> Workload:
    """Seeded Poisson arrival stream over a mix of graph sizes.

    Inter-arrival gaps are exponential with mean ``1/rate_rps`` (the
    memoryless open-loop arrival model); sizes are drawn uniformly from
    ``sizes``; graphs come from the named generator.  Identical seeds
    yield identical workloads — arrivals, sizes, and adjacency bits."""
    from ..core.graphs import barabasi_albert, erdos_renyi, social_like
    if rate_rps <= 0:
        raise ValueError(f"offered rate must be positive, got {rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=num_requests)
    arrivals = np.cumsum(gaps)
    ns = rng.choice(np.asarray(sizes, np.int64), size=num_requests)
    gen = {"er": lambda n, s: erdos_renyi(int(n), rho, seed=s),
           "ba": lambda n, s: barabasi_albert(int(n), 4, seed=s),
           "social": lambda n, s: social_like(int(n), seed=s)}[kind]
    adjs = tuple(gen(n, int(rng.integers(0, 2 ** 31))) for n in ns)
    return Workload(arrivals=arrivals, adjs=adjs, problem=problem,
                    deadline_ms=deadline_ms, rate_rps=float(rate_rps),
                    seed=seed)


@dataclasses.dataclass
class LoadReport:
    """Latency distribution + goodput of one open-loop run."""
    mode: str
    offered_rps: float
    submitted: int
    completed: int
    rejected: int                  # admission-control sheds (async only)
    on_time: int                   # completed within the deadline
    deadline_ms: Optional[float]
    wall_s: float                  # first arrival → last completion
    p50_ms: float
    p99_ms: float
    mean_ms: float
    goodput_rps: float             # on_time / wall_s

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _percentile(lat_ms: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(lat_ms), q)) if lat_ms else 0.0


def _report(mode: str, workload: Workload, responses: List[SolveResponse],
            rejected: int, t0: float) -> LoadReport:
    lat_ms = [r.latency_s * 1e3 for r in responses]
    deadline = workload.deadline_ms
    on_time = (len(lat_ms) if deadline is None
               else sum(1 for l in lat_ms if l <= deadline))
    end = max((r.complete_t for r in responses), default=t0)
    wall = max(end - t0, 1e-9)
    return LoadReport(
        mode=mode, offered_rps=workload.rate_rps,
        submitted=len(workload), completed=len(responses),
        rejected=rejected, on_time=on_time, deadline_ms=deadline,
        wall_s=wall, p50_ms=_percentile(lat_ms, 50),
        p99_ms=_percentile(lat_ms, 99),
        mean_ms=float(np.mean(lat_ms)) if lat_ms else 0.0,
        goodput_rps=on_time / wall)


def _pace(t0: float, arrival: float) -> None:
    delay = t0 + arrival - time.perf_counter()
    if delay > 0:
        time.sleep(delay)


def run_open_loop(svc: GraphSolverService, workload: Workload,
                  mode: str = "async") -> LoadReport:
    """Drive one workload through the service open-loop and measure it.

    The generator never waits for a result before submitting the next
    request — submission timing is set by the workload's arrival clock
    alone.  Returns the :class:`LoadReport`; per-request latencies come
    from the timestamps the service stamps on every response.  On a mesh
    it runs on rank 0, which leads the service from here on (the caller
    closes it); any other rank raises ``ValueError`` before submitting."""
    if mode not in ("async", "sync"):
        raise ValueError(f"unknown drive mode {mode!r} "
                         "(expected 'async' or 'sync')")
    svc.lead()
    if mode == "async":
        return _run_async(svc, workload)
    return _run_sync(svc, workload)


def _run_async(svc: GraphSolverService, workload: Workload) -> LoadReport:
    futures, rejected = [], 0
    t0 = time.perf_counter()
    for arrival, adj in zip(workload.arrivals, workload.adjs):
        _pace(t0, arrival)
        try:
            futures.append(svc.submit_async(adj, workload.problem,
                                            deadline_ms=workload.deadline_ms))
        except ServiceOverloaded:
            rejected += 1
    responses = [f.result() for f in futures]
    return _report("async", workload, responses, rejected, t0)


def _run_sync(svc: GraphSolverService, workload: Workload) -> LoadReport:
    """Sync baseline: arrivals feed ``submit()`` on a side thread while
    this thread drains continuously — each drain serves everything that
    arrived during the previous one (batch mode at its best)."""
    results: Dict[int, SolveResponse] = {}
    t0 = time.perf_counter()

    def feed():
        for arrival, adj in zip(workload.arrivals, workload.adjs):
            _pace(t0, arrival)
            svc.submit(adj, workload.problem)

    feeder = threading.Thread(target=feed, name="loadgen-feeder")
    feeder.start()
    while feeder.is_alive() or svc.pending():
        got = svc.drain()
        results.update(got)
        if not got:
            time.sleep(1e-3)
    feeder.join()
    return _report("sync", workload, list(results.values()), 0, t0)
