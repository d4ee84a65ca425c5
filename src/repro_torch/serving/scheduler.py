"""Deadline-aware batch scheduler for the async solver service
(DESIGN.md §14).  A copy of ``repro/serving/scheduler.py``, which is pure
Python; the port keeps its own so that it imports nothing of ``repro``.

The sync ``drain()`` path serves whatever is queued in bucket order — fine
for demos, hopeless for tail latency: a rare-size request can sit behind an
arbitrarily long run of hot-bucket batches, and nothing bounds how long an
underfilled bucket waits for companions.  This module is the policy half of
the async service: a pure, clock-injected data structure the background
dispatch thread consults for *which (bucket, problem) queue to cut a batch
from next*.  Keeping it free of threads and real time makes the scheduling
guarantees unit-testable (``tests/test_serving_async.py`` drives it with a
fake clock).

Policy (each rule motivated by an SLO failure mode it removes):

- **Readiness.**  A queue is dispatchable when it holds a full batch
  (``rows_per_dispatch`` requests) OR its head has waited at least
  ``max_wait_ms`` — the partial-dispatch rule.  Without it, the last
  requests of a trickle for some bucket wait forever for companions;
  with it, padding waste is only paid once the head's latency budget is
  actually being spent.
- **EDF among ready.**  Among ready queues, dispatch the one whose head
  has the earliest absolute deadline (ties: oldest enqueue).  Requests
  with no deadline sort last (+inf).
- **Anti-starvation override.**  EDF alone still starves: a hot bucket
  whose requests carry tight deadlines beats a rare bucket's looser
  deadline on every decision.  Any ready head that has waited
  ``starvation_factor × max_wait_ms`` is *starving*; when starving heads
  exist, the oldest one is dispatched regardless of deadlines.  Since
  every decision removes one queue's head, a starving head is dispatched
  after at most (#queues with older starving heads) further batches —
  wait is bounded by ``starvation_ms`` plus a small number of batch
  times, never by traffic mix.
- **Admission control.**  ``offer`` fast-rejects once the total queued
  depth reaches ``max_queue_depth``.  An overloaded open-loop system has
  unbounded queues and therefore unbounded latency for *everyone*;
  shedding the excess keeps admitted requests inside their deadlines
  (the goodput-vs-offered-load knee in
  ``benchmarks/serving_latency.py``).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from .bucketing import MIN_BUCKET, bucket_nodes

QueueKey = Tuple[int, str]          # (bucket node count, problem)


@dataclasses.dataclass
class PendingRequest:
    """One queued submission: the request plus its scheduling metadata.
    ``deadline_t`` is an ABSOLUTE clock value (same clock as ``now``);
    ``math.inf`` means no deadline.  ``future`` is opaque to the
    scheduler — the service attaches the completion handle it will
    resolve after dispatch."""
    req: object                     # SolveRequest (duck-typed: .n/.problem/.enqueue_t)
    deadline_t: float = math.inf
    future: object = None


class DeadlineScheduler:
    """Clock-injected queue-selection policy; see the module docstring.

    Not thread-safe by itself — the service serializes access under its
    condition lock.  All times are absolute floats from the caller's
    clock (``time.perf_counter`` in production, a counter in tests).
    """

    def __init__(self, rows_per_dispatch: int, *,
                 max_wait_ms: float = 50.0,
                 max_queue_depth: int = 512,
                 starvation_factor: float = 2.0,
                 min_bucket: int = MIN_BUCKET):
        if rows_per_dispatch < 1:
            raise ValueError("rows_per_dispatch must be >= 1")
        if max_wait_ms < 0 or starvation_factor < 1.0:
            raise ValueError("need max_wait_ms >= 0 and "
                             "starvation_factor >= 1")
        self.rows_per_dispatch = rows_per_dispatch
        self.max_wait_s = max_wait_ms / 1e3
        self.starvation_s = starvation_factor * self.max_wait_s
        self.max_queue_depth = max_queue_depth
        self.min_bucket = min_bucket
        self._queues: Dict[QueueKey, Deque[PendingRequest]] = {}
        self._depth = 0

    def __len__(self) -> int:
        return self._depth

    def key_for(self, req) -> QueueKey:
        return (bucket_nodes(req.n, self.min_bucket), req.problem)

    # -- admission ----------------------------------------------------------
    def offer(self, pending: PendingRequest) -> bool:
        """Admit one request, or fast-reject (False) at the depth bound —
        the caller sheds the load instead of queueing unbounded work."""
        if self._depth >= self.max_queue_depth:
            return False
        self._queues.setdefault(self.key_for(pending.req),
                                deque()).append(pending)
        self._depth += 1
        return True

    # -- selection ----------------------------------------------------------
    def _head_wait(self, key: QueueKey, now: float) -> float:
        return now - self._queues[key][0].req.enqueue_t

    def _ready(self, key: QueueKey, now: float) -> bool:
        q = self._queues[key]
        return (len(q) >= self.rows_per_dispatch
                or self._head_wait(key, now) >= self.max_wait_s)

    def next_batch(self, now: float, *, force: bool = False
                   ) -> Optional[Tuple[QueueKey, List[PendingRequest]]]:
        """Pop the next batch to dispatch (≤ rows_per_dispatch requests
        from ONE queue), or None when nothing is ready.  ``force`` ignores
        readiness — the service's shutdown flush."""
        ready = [k for k in self._queues
                 if force or self._ready(k, now)]
        if not ready:
            return None
        starving = [k for k in ready
                    if self._head_wait(k, now) >= self.starvation_s]
        if starving:
            key = min(starving,
                      key=lambda k: self._queues[k][0].req.enqueue_t)
        else:
            key = min(ready,
                      key=lambda k: (self._queues[k][0].deadline_t,
                                     self._queues[k][0].req.enqueue_t))
        q = self._queues[key]
        batch = [q.popleft()
                 for _ in range(min(len(q), self.rows_per_dispatch))]
        if not q:
            del self._queues[key]
        self._depth -= len(batch)
        return key, batch

    def next_wake(self, now: float) -> Optional[float]:
        """Earliest absolute time a currently-queued request becomes ready
        (None when the scheduler is empty; ``now`` when something already
        is).  The dispatch thread sleeps until this instead of polling."""
        if not self._queues:
            return None
        wake = math.inf
        for key, q in self._queues.items():
            if self._ready(key, now):
                return now
            wake = min(wake, q[0].req.enqueue_t + self.max_wait_s)
        return wake
