"""Graph-solver service: continuous-batching request layer over the fused
solve loop (DESIGN.md §9, §14).  Counterpart of ``repro/serving/service.py``.

Requests are bucketed to power-of-two sizes with isolated-node padding
(``bucketing``), batched, solved on the card by ``core.engine``'s solve
loop and unpadded per request.  Two modes share every layer below
submission:

- **Sync** — ``submit()`` queues, ``drain()`` serves everything queued in
  bucket order; ``serve()`` does both.
- **Async** — ``submit_async()`` returns a :class:`SolveFuture`; a
  background thread asks the :class:`DeadlineScheduler` which batch to
  dispatch next (EDF, anti-starvation, partial dispatch after
  ``max_wait_ms``, depth-bounded admission).

``cfg.spatial = (dp, sp)`` serves on the 2-D ``(data, graph)`` mesh
(``core.mesh``): every dispatch carries ``max_batch · dp`` rows, B/dp per
data rank, each evaluation partitioned sp ways.  Every rank builds the
service, in the same order as its other services.  Then the mesh is
driven one of two ways:

- **SPMD, sync only** — every rank ``serve()``s (or ``submit()``s and
  ``drain()``s) the same requests in the same order, so the ranks plan
  the same dispatches and each returns every response.
- **One planner** — rank 0 is the service's one front end, as the JAX
  service's single controller is: ``submit_async``, the scheduler,
  admission, deadlines and futures exist on rank 0 alone, and its
  ``drain()`` too plans for every rank once it leads (:meth:`lead`, which
  ``submit_async`` and ``loadgen.run_open_loop`` call).  The other ranks
  call :meth:`follow`, which runs rank 0's dispatches until rank 0's
  ``close()``.  Before each dispatch's first collective, rank 0 sends its
  plan (bucket, problem, request ids and sizes, whether it is the
  bucket's first dispatch, and the requests' adjacencies) through a
  ``core.mesh.PlanChannel``; each follower pads the graphs itself
  (``bucketing.plan_from_payload``) and runs the same ``_dispatch``.  The
  followers never read the clock to plan, and refuse ``submit_async``.
  A failed dispatch leaves the ranks' collectives out of step, so on a
  mesh it fails the service: rank 0 fails every queued future and
  refuses new ones, and each rank left waiting in a collective of that
  dispatch raises when the group's timeout runs out.

Every registered problem serves on one device and on a mesh.

Where the JAX service caches one compiled step per (bucket, problem), the
port has nothing to compile per shape; it keeps a per-(bucket, problem)
*first dispatch* record instead.  The first dispatch of a bucket pays the
kernel build and load and the allocator's first allocations at that size,
so ``compiles``, ``warmup_compiles`` and ``compile_seconds`` count that
first run (on a born-done dummy batch), and ``warmup()`` keeps it off the
request path as before.

    svc = GraphSolverService(policy, cfg)           # device="cuda"
    svc.warmup([512, 1024])
    fut = svc.submit_async(adj, deadline_ms=100.0)
    resp = fut.result()
    svc.close()
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Set, Union

import numpy as np

from ..core.graphrep import CsrRep, GraphRep, SparseRep, get_rep
from ..core.inference import (MAX_D, check_solve_options, gather_batch,
                              init_solve_state)
from ..core.mesh import PlanChannel, make_mesh, normalize_spatial
from ..core.policy import Policy, PolicyConfig
from ..device import DeviceLike, resolve_device, synchronize
from .bucketing import (MIN_BUCKET, BatchPlan, bucket_nodes, build_plan,
                        plan_batches, plan_from_payload, plan_payload,
                        unpad_solution)
from .scheduler import DeadlineScheduler, PendingRequest

# names the plan channel of each mesh service; every rank builds its mesh
# services in one order, so the n-th is the same service on every rank
_MESH_SERVICES = itertools.count()


def enable_compile_cache(cache_dir) -> bool:
    """The restarted server's warm path (JAX's persistent compilation
    cache): the port compiles nothing per shape, and its only restart
    cost is the ``nvcc`` build of its kernels.  This points the kernel
    build root (``kernels.build``) at ``cache_dir``, so a restarted
    process's ``warmup()`` loads the libraries built there and runs no
    ``nvcc``.  Returns True.  A library this process has already loaded
    stays in use: call it before the first dispatch, or it has no
    effect."""
    from ..kernels import build
    build.set_build_root(cache_dir)
    return True


class ServiceOverloaded(RuntimeError):
    """Admission-control fast-reject: the async queue is at its bound."""


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    id: int
    adj: np.ndarray            # (n, n) dense adjacency
    n: int
    problem: str = "mvc"
    enqueue_t: float = 0.0     # perf_counter at submission


@dataclasses.dataclass(frozen=True)
class SolveResponse:
    id: int
    solution: np.ndarray       # (n,) mask over the REQUEST's nodes
    size: int                  # |S|
    policy_evals: int          # evals of the batch this request rode in
    bucket: int                # padded node count it was served at
    problem: str
    enqueue_t: float = 0.0     # submission
    dispatch_t: float = 0.0    # its batch started on the device
    complete_t: float = 0.0    # its batch's results were fetched

    @property
    def latency_s(self) -> float:
        """Submission-to-completion wall time (queue wait + solve)."""
        return self.complete_t - self.enqueue_t

    @property
    def wait_s(self) -> float:
        """Queue wait: submission to batch dispatch."""
        return self.dispatch_t - self.enqueue_t


@dataclasses.dataclass
class ServiceStats:
    requests: int = 0
    batches: int = 0
    partial_batches: int = 0   # dispatches with unused (padded) rows
    compiles: int = 0          # first dispatches of a bucket on the request path
    warmup_compiles: int = 0   # first dispatches done by warmup()
    cache_hits: int = 0
    rejected: int = 0          # admission-control fast-rejects
    padded_rows: int = 0       # unused batch rows dispatched (all buckets)
    compile_seconds: float = 0.0   # first-dispatch cost, kernel build included
    solve_seconds: float = 0.0
    padded_rows_by_bucket: Dict[int, int] = dataclasses.field(
        default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class SolveFuture:
    """Completion handle for one async submission; ``result()`` blocks
    until its batch was dispatched and re-raises a dispatch failure."""

    def __init__(self, request_id: int):
        self.id = request_id
        self._event = threading.Event()
        self._response: Optional[SolveResponse] = None
        self._exception: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> SolveResponse:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} not served "
                               f"within {timeout}s")
        if self._exception is not None:
            raise self._exception
        return self._response

    def _set_result(self, response: SolveResponse) -> None:
        self._response = response
        self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exception = exc
        self._event.set()


class GraphSolverService:
    """Batched graph-solver frontend over the fused solve loop.

    Parameters
    ----------
    params : the policy, on ``device``.
    cfg : PolicyConfig — supplies num_layers, kernel, compute, the mesh
        (``spatial``: (dp, sp) on a mesh of dp·sp ranks, see above) and,
        unless ``rep`` is given, the representation.
    device : where batches are solved; ``"cuda"`` unless the caller asks
        for the CPU.
    rep : "dense", "sparse" or "csr" (default: ``cfg.graph_rep``).
    sparse_max_degree : sparse only — the neighbour-list width of every
        bucket; default the bucket's node count, the bound that holds for
        any traffic.  A graph whose max degree exceeds it is rejected at
        submission, never truncated.
    csr_max_edges : csr only — directed edge slots per graph of every
        bucket; default nb², the bound that holds for any traffic.  A
        graph with more directed edges is rejected at submission, never
        truncated.
    multi_node : adaptive top-d commit schedule (§4.5.1) per evaluation.
    max_batch : rows per dispatch and data rank; every batch is padded to
        exactly ``max_batch · dp`` rows.
    max_wait_ms, max_queue_depth, default_deadline_ms, starvation_factor :
        the async scheduler's knobs (see ``scheduler``).

    On a mesh, the dispatches' collectives run on the mesh's cached axis
    groups (``core.mesh.make_mesh``, one mesh per shape) and on the world
    group: on rank 0 from the thread that dispatches (the scheduler
    thread while async traffic runs), on the others from the thread in
    :meth:`follow`.  No other thread of any rank may call a collective
    while a service leads or follows: close the service (and let every
    ``follow()`` return) before the next collective.
    """

    def __init__(self, params: Policy, cfg: PolicyConfig, *,
                 device: DeviceLike = "cuda",
                 rep: Union[str, GraphRep, None] = None,
                 multi_node: bool = True, max_batch: int = 8,
                 min_bucket: int = MIN_BUCKET,
                 sparse_max_degree: Optional[int] = None,
                 csr_max_edges: Optional[int] = None,
                 max_wait_ms: float = 50.0,
                 max_queue_depth: int = 512,
                 default_deadline_ms: Optional[float] = None,
                 starvation_factor: float = 2.0):
        from ..core.engine import _check_csr_spatial, get_solve_step
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"the policy is on {params.device}, the "
                             f"service on {self.device}")
        check_solve_options("device", cfg.spatial)
        self.params = params
        self.cfg = cfg
        self.rep = get_rep(rep if rep is not None else cfg.graph_rep)
        self.mesh_shape = normalize_spatial(cfg.spatial)      # (dp, sp)
        self.mesh = None
        self._channel: Optional[PlanChannel] = None
        if self.mesh_shape != (1, 1):
            _check_csr_spatial(self.rep, self.mesh_shape[1])
            self.mesh = make_mesh(*self.mesh_shape)
            self._channel = PlanChannel(
                self.mesh, f"service{next(_MESH_SERVICES)}", self.device)
        self.rank = self.mesh.rank if self.mesh is not None else 0
        self.sparse_max_degree = sparse_max_degree
        self.csr_max_edges = csr_max_edges
        self._bucket_reps: Dict[int, GraphRep] = {}
        self.multi_node = multi_node
        self.max_batch = max_batch
        # max_batch rows on each data rank
        self.rows_per_dispatch = max_batch * self.mesh_shape[0]
        self.min_bucket = min_bucket
        self.default_deadline_ms = default_deadline_ms
        self.stats = ServiceStats()
        self._queue: Deque[SolveRequest] = deque()
        self._next_id = 0
        self._dispatched: Set[tuple] = set()   # first-dispatch record
        self._results: Dict[int, SolveResponse] = {}
        self._solve: Dict[tuple, object] = {}
        self._get_solve_step = get_solve_step
        # _cond guards queue/scheduler/id/running state; _device_lock
        # serializes device work (first dispatches and dispatches)
        self._cond = threading.Condition()
        self._device_lock = threading.Lock()
        self._sched = DeadlineScheduler(
            self.rows_per_dispatch, max_wait_ms=max_wait_ms,
            max_queue_depth=max_queue_depth,
            starvation_factor=starvation_factor, min_bucket=min_bucket)
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._leading = False     # rank 0 plans for every rank (lead())
        self._failed: Optional[BaseException] = None   # a mesh dispatch

    @classmethod
    def from_checkpoint(cls, ckpt_dir, cfg: PolicyConfig,
                        step: Optional[int] = None, *,
                        device: DeviceLike = "cuda",
                        **kw) -> "GraphSolverService":
        """Serve a policy saved in the JAX checkpoint format."""
        from ..checkpoint import load_policy
        params, _step = load_policy(ckpt_dir, cfg, step, device=device)
        return cls(params, cfg, device=device, **kw)

    # -- request intake -----------------------------------------------------
    def _validate(self, adj: np.ndarray, problem: str) -> np.ndarray:
        """Reject malformed adjacencies, unknown / padding-unsafe problems
        and graphs above the bucket's sparse or CSR cap before they are
        queued."""
        from ..core import env as env_lib
        env_lib.ensure_padding_safe(problem)
        adj = np.asarray(adj, np.float32)
        if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
            raise ValueError(f"expected a square (n, n) adjacency, "
                             f"got {adj.shape}")
        rep = self._bucket_rep(bucket_nodes(adj.shape[0], self.min_bucket))
        if rep.name == "sparse":
            deg = int((adj > 0).sum(-1).max(initial=0))
            if deg > rep.max_degree:
                raise ValueError(
                    f"graph of max degree {deg} exceeds the service's "
                    f"sparse_max_degree={rep.max_degree}; rejected rather "
                    f"than truncated")
        elif rep.name == "csr":
            edges = int((adj > 0).sum())
            if edges > rep.max_edges:
                raise ValueError(
                    f"graph of {edges} directed edges exceeds the "
                    f"service's csr_max_edges={rep.max_edges}; rejected "
                    f"rather than truncated")
        return adj

    def _make_request(self, adj: np.ndarray, problem: str) -> SolveRequest:
        # caller holds self._cond
        rid = self._next_id
        self._next_id += 1
        return SolveRequest(id=rid, adj=adj, n=adj.shape[0],
                            problem=problem,
                            enqueue_t=time.perf_counter())

    def submit(self, adj: np.ndarray, problem: str = "mvc") -> int:
        """Sync mode: enqueue one graph for the next ``drain()``."""
        adj = self._validate(adj, problem)
        with self._cond:
            req = self._make_request(adj, problem)
            self._queue.append(req)
            self.stats.requests += 1
        return req.id

    def submit_async(self, adj: np.ndarray, problem: str = "mvc",
                     deadline_ms: Optional[float] = None) -> SolveFuture:
        """Async mode: admit one graph into the deadline scheduler and
        return a :class:`SolveFuture`.  Raises :class:`ServiceOverloaded`
        at the admission bound.  On a mesh, rank 0 alone takes
        submissions (it leads, :meth:`lead`); the other ranks raise
        ``ValueError`` and :meth:`follow`."""
        self.lead()
        adj = self._validate(adj, problem)
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        with self._cond:
            self._check_alive()
            req = self._make_request(adj, problem)
            deadline_t = (req.enqueue_t + deadline_ms / 1e3
                          if deadline_ms is not None else math.inf)
            future = SolveFuture(req.id)
            if not self._sched.offer(PendingRequest(req, deadline_t,
                                                    future)):
                self.stats.rejected += 1
                raise ServiceOverloaded(
                    f"request rejected: {len(self._sched)} queued at the "
                    f"admission bound ({self._sched.max_queue_depth})")
            self.stats.requests += 1
            self._start_locked()
            self._cond.notify_all()
        return future

    def pending(self) -> int:
        return len(self._queue) + len(self._sched)

    # -- the mesh's one planner ----------------------------------------------
    def _check_alive(self) -> None:
        if self._failed is not None:
            raise RuntimeError(
                f"this mesh service failed in a dispatch and serves no "
                f"more: {self._failed!r}") from self._failed

    def lead(self) -> None:
        """Make rank 0 the mesh's one planner, until :meth:`close`: from
        now on each of its dispatches (async, ``drain()`` and the flush
        of ``close()``) and warmups is sent to the other ranks, which run
        it in :meth:`follow`.  A no-op on one device and while leading;
        ``ValueError`` on any rank but 0."""
        if self.mesh is None:
            return
        if self.rank != 0:
            raise ValueError(
                f"rank {self.rank} of the mesh {self.mesh_shape} takes no "
                f"submissions: rank 0 is the service's one front end and "
                f"planner; submit on rank 0 and call follow() here")
        self._check_alive()
        self._leading = True

    def follow(self) -> int:
        """The other ranks' side of a service whose rank 0 leads: run
        each of rank 0's warmups and dispatches, in rank 0's order, until
        rank 0 closes the service.  Returns the number of dispatches run.
        The stats count them as rank 0's do (``requests`` the rows
        served); the responses are rank 0's to hand out.  ``ValueError``
        on one device and on rank 0."""
        if self.mesh is None or self.rank == 0:
            raise ValueError("follow() runs on the ranks other than 0 of a "
                             "mesh service, whose rank 0 leads")
        served = 0
        while True:
            header, payload = self._channel.recv()
            if header["kind"] == "stop":
                return served
            nb, problem = header["nb"], header["problem"]
            with self._device_lock:
                # rank 0's first-dispatch record decides, so that every
                # rank runs the collectives of the same first dispatches
                if header["first"]:
                    self._dispatched.discard(self._key(nb, problem))
                else:
                    self._dispatched.add(self._key(nb, problem))
                if header["kind"] == "warm":
                    self._ensure_dispatched(nb, problem, warm=True)
                    continue
                plan = plan_from_payload(nb, problem, header["ids"],
                                         header["sizes"], payload,
                                         self.rows_per_dispatch)
                self._dispatch(plan)
            self.stats.requests += len(plan.request_ids)
            served += 1

    def _send(self, kind: str, nb: int, problem: str,
              plan: Optional[BatchPlan] = None) -> None:
        """While leading, send the next plan (the caller holds the device
        lock, so plans go out in the order they run)."""
        if self._leading:
            self._channel.send(
                {"kind": kind, "nb": nb, "problem": problem,
                 "first": self._key(nb, problem) not in self._dispatched,
                 "ids": list(plan.request_ids) if plan else [],
                 "sizes": list(plan.sizes) if plan else []},
                plan_payload(plan) if plan else None)

    def _run(self, plan: BatchPlan) -> List[SolveResponse]:
        """One dispatch, its plan sent first while leading.  On a mesh a
        failure fails the service (the ranks' collectives are out of
        step)."""
        with self._device_lock:
            self._check_alive()
            try:
                self._send("dispatch", plan.nb, plan.problem, plan)
                return self._dispatch(plan)
            except BaseException as exc:
                if self.mesh is not None:
                    self._failed = exc
                raise

    # -- first dispatch / warmup ---------------------------------------------
    def _bucket_rep(self, nb: int) -> GraphRep:
        """The backend a bucket dispatches through: sparse pins its
        neighbour-list width per bucket and csr its edge slots, so every
        dispatch of a bucket has one shape."""
        if self.rep.name not in ("sparse", "csr"):
            return self.rep
        rep = self._bucket_reps.get(nb)
        if rep is None:
            if self.rep.name == "csr":
                rep = CsrRep(max_edges=self.csr_max_edges or nb * nb)
            else:
                rep = SparseRep(max_degree=self.sparse_max_degree or nb)
            # submitters call this outside the lock: one rep per bucket wins
            rep = self._bucket_reps.setdefault(nb, rep)
        return rep

    def _key(self, nb: int, problem: str) -> tuple:
        return (nb, problem, self.rep.name, self.multi_node,
                self.cfg.num_layers, self.mesh_shape, self.cfg.kernel,
                self.cfg.compute)

    def _solve_fn(self, nb: int, problem: str):
        rep = self._bucket_rep(nb)
        fn = self._solve.get((rep, problem))
        if fn is None:
            fn = self._get_solve_step(
                rep=rep, problem=problem,
                num_layers=self.cfg.num_layers,
                use_adaptive=self.multi_node, spatial=self.mesh_shape,
                kernel=self.cfg.kernel, compute=self.cfg.compute)
            self._solve[(rep, problem)] = fn
        return fn

    def _ensure_dispatched(self, nb: int, problem: str, *,
                           warm: bool = False) -> None:
        """First run of one (bucket, problem) on a batch of empty graphs:
        the shapes of a real dispatch, but every row is born done, so the
        loop stops after one evaluation and the measured cost is the
        first-use cost (kernel build and load on the first bucket)."""
        key = self._key(nb, problem)
        if key in self._dispatched:
            if not warm:
                self.stats.cache_hits += 1
            return
        dummy = np.zeros((self.rows_per_dispatch, nb, nb), np.float32)
        t0 = time.perf_counter()
        state = init_solve_state(self._bucket_rep(nb), dummy, problem,
                                 device=self.device, mesh=self.mesh)
        self._solve_fn(nb, problem)(self.params, state, nb + MAX_D)
        synchronize(self.device)
        self.stats.compile_seconds += time.perf_counter() - t0
        if warm:
            self.stats.warmup_compiles += 1
        else:
            self.stats.compiles += 1
        self._dispatched.add(key)

    def warmup(self, buckets: Sequence[int],
               problems: Sequence[str] = ("mvc",)) -> dict:
        """Run the first dispatch of every (bucket, problem) the traffic
        will touch, off the request path.  ``buckets`` entries are rounded
        up to their power-of-two bucket.  After a warmup covering the
        traffic's buckets, ``stats.compiles == 0`` holds.  On a mesh every
        rank calls it with the same arguments, or rank 0 alone while it
        leads (the others run it in :meth:`follow`)."""
        t0 = time.perf_counter()
        done = []
        with self._device_lock:
            for problem in problems:
                for b in buckets:
                    nb = bucket_nodes(int(b), self.min_bucket)
                    if self._key(nb, problem) not in self._dispatched:
                        self._send("warm", nb, problem)
                        self._ensure_dispatched(nb, problem, warm=True)
                        done.append([nb, problem])
        return {"compiled": done,
                "seconds": time.perf_counter() - t0,
                "warmup_compiles": self.stats.warmup_compiles}

    # -- dispatch -----------------------------------------------------------
    def _dispatch(self, plan: BatchPlan) -> List[SolveResponse]:
        self._ensure_dispatched(plan.nb, plan.problem)
        t0 = time.perf_counter()
        state = init_solve_state(self._bucket_rep(plan.nb), plan.adj,
                                 plan.problem, device=self.device,
                                 mesh=self.mesh)
        out, evals, _committed = self._solve_fn(plan.nb, plan.problem)(
            self.params, state, plan.nb + MAX_D)
        sol, = gather_batch(self.mesh, out.solution)  # waits for the device
        t1 = time.perf_counter()
        self.stats.solve_seconds += t1 - t0
        self.stats.batches += 1
        unused = self.rows_per_dispatch - len(plan.request_ids)
        self.stats.padded_rows += unused
        self.stats.padded_rows_by_bucket[plan.nb] = (
            self.stats.padded_rows_by_bucket.get(plan.nb, 0) + unused)
        if unused:
            self.stats.partial_batches += 1
        enqueue_ts = plan.enqueue_ts or (0.0,) * len(plan.request_ids)
        responses = []
        for row, (rid, n, et) in enumerate(zip(plan.request_ids,
                                               plan.sizes, enqueue_ts)):
            mask = unpad_solution(sol[row], n)
            responses.append(SolveResponse(
                id=rid, solution=mask, size=int(mask.sum()),
                policy_evals=int(evals), bucket=plan.nb,
                problem=plan.problem, enqueue_t=et, dispatch_t=t0,
                complete_t=t1))
        return responses

    # -- async scheduler thread ---------------------------------------------
    def _start_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._running = True
            self._thread = threading.Thread(
                target=self._scheduler_loop,
                name="graph-solver-scheduler", daemon=True)
            self._thread.start()

    def _fail_queued(self, exc: BaseException) -> None:
        """A failed mesh service: every queued future fails with ``exc``
        and the scheduler thread stops."""
        with self._cond:
            self._running = False
            while True:
                batch = self._sched.next_batch(time.perf_counter(),
                                               force=True)
                if batch is None:
                    return
                for p in batch[1]:
                    p.future._set_exception(exc)

    def _scheduler_loop(self) -> None:
        """Continuous batching: sleep until the scheduler has a ready
        batch (or a head's max_wait expires), dispatch it outside the
        lock, resolve its futures; on shutdown, flush what is queued."""
        if self.device.type == "cuda":      # the current card is per thread
            import torch
            torch.cuda.set_device(self.device)
        while True:
            with self._cond:
                batch = None
                while self._running:
                    batch = self._sched.next_batch(time.perf_counter())
                    if batch is not None:
                        break
                    wake = self._sched.next_wake(time.perf_counter())
                    timeout = (None if wake is None
                               else max(wake - time.perf_counter(), 1e-4))
                    self._cond.wait(timeout)
                if batch is None:
                    batch = self._sched.next_batch(time.perf_counter(),
                                                   force=True)
                    if batch is None:
                        return              # stopped and fully flushed
            (nb, problem), pendings = batch
            plan = build_plan([p.req for p in pendings], nb, problem,
                              self.rows_per_dispatch)
            try:
                responses = self._run(plan)
            except Exception as exc:    # device OOM etc.: fail the batch
                for p in pendings:
                    p.future._set_exception(exc)
                if self._failed is not None:
                    self._fail_queued(exc)
                    return
                continue
            by_id = {r.id: r for r in responses}
            for p in pendings:
                p.future._set_result(by_id[p.req.id])

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def close(self) -> None:
        """Stop the async scheduler thread after flushing what is queued,
        so every issued future resolves; while leading a mesh, then send
        the stop plan, on which every :meth:`follow` returns."""
        with self._cond:
            thread = self._thread
            self._running = False
            self._cond.notify_all()
        if thread is not None:
            thread.join()
        self._thread = None
        if self._leading:
            with self._device_lock:
                self._channel.send({"kind": "stop"})
            self._leading = False

    def __enter__(self) -> "GraphSolverService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- sync drain ---------------------------------------------------------
    def drain(self) -> Dict[int, SolveResponse]:
        """Serve every pending sync request: bucket, pad, batch, solve,
        unpad.  If a dispatch raises, unserved requests go back on the
        queue and computed responses are held for the next drain.  On a
        mesh, every rank drains the same queue (SPMD), or rank 0 alone
        while it leads."""
        with self._cond:
            if self._running:
                raise RuntimeError(
                    "drain() is the sync path; the async scheduler is "
                    "running — resolve futures or close() first")
            requests = list(self._queue)
            self._queue.clear()
        pending = {r.id: r for r in requests}
        try:
            for plan in plan_batches(requests, self.rows_per_dispatch,
                                     self.min_bucket):
                responses = self._run(plan)
                for resp in responses:
                    self._results[resp.id] = resp
                    pending.pop(resp.id, None)
        except BaseException:
            with self._cond:
                self._queue.extend(pending.values())
            raise
        results, self._results = self._results, {}
        return results

    def serve(self, adjs: Sequence[np.ndarray],
              problem: str = "mvc") -> List[SolveResponse]:
        """Submit a request stream and drain it, in submission order."""
        ids = [self.submit(a, problem) for a in adjs]
        results = self.drain()
        return [results[i] for i in ids]
