"""Size bucketing and padding for the graph-solver service (DESIGN.md §9).
A copy of ``repro/serving/bucketing.py`` (pure numpy).

Requests are rounded up to power-of-two node buckets and batched into
fixed-size (max_batch, Nb, Nb) batches, so each bucket has one shape.
Padding is by isolated nodes: a zero row/column gives the padding node
degree 0, so it is never a candidate, never scores, never commits and
never changes ``done``.  Unused batch rows are empty graphs, born done.
That property is an enforced registry contract
(``repro_torch.core.env.ensure_padding_safe``), checked by
``plan_batches`` for every problem a plan targets.

On a mesh, rank 0 plans every dispatch and sends each plan to the other
ranks (``serving.service``): :func:`plan_payload` is its wire form, the
occupied rows' adjacencies without their padding, and
:func:`plan_from_payload` rebuilds the padded plan on the receiver.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

MIN_BUCKET = 8


def bucket_nodes(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Power-of-two node bucket: the smallest 2^k ≥ max(n, min_bucket)."""
    if n < 1:
        raise ValueError(f"graph must have ≥1 node, got {n}")
    b = min_bucket
    while b < n:
        b *= 2
    return b


def pad_adjacency(adj: np.ndarray, nb: int) -> np.ndarray:
    """Zero-pad an (n, n) adjacency to (nb, nb) — isolated padding nodes."""
    n = adj.shape[-1]
    if n > nb:
        raise ValueError(f"graph with {n} nodes does not fit bucket {nb}")
    return np.pad(np.asarray(adj, np.float32),
                  ((0, nb - n), (0, nb - n)))


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """One dispatch: a (batch, nb, nb) padded stack plus the request ids,
    true sizes and submission timestamps of the occupied rows."""
    nb: int                    # bucket node count (power of two)
    problem: str
    adj: np.ndarray            # (batch, nb, nb) float32, zero rows unused
    request_ids: Tuple[int, ...]
    sizes: Tuple[int, ...]     # true node counts per occupied row
    enqueue_ts: Tuple[float, ...] = ()   # submit timestamps per occupied row


def build_plan(requests: Sequence, nb: int, problem: str,
               rows: int) -> BatchPlan:
    """One BatchPlan from an explicit request chunk (the async path); it
    may underfill the batch, unused rows are empty born-done graphs."""
    if len(requests) > rows:
        raise ValueError(f"{len(requests)} requests exceed the "
                         f"{rows}-row batch")
    adj = np.zeros((rows, nb, nb), np.float32)
    for row, req in enumerate(requests):
        adj[row] = pad_adjacency(req.adj, nb)
    return BatchPlan(
        nb=nb, problem=problem, adj=adj,
        request_ids=tuple(r.id for r in requests),
        sizes=tuple(r.n for r in requests),
        enqueue_ts=tuple(getattr(r, "enqueue_t", 0.0) for r in requests))


def plan_batches(requests: Sequence, max_batch: int,
                 min_bucket: int = MIN_BUCKET) -> List[BatchPlan]:
    """Group pending requests by (bucket, problem) and cut fixed-size
    batches of exactly ``max_batch`` rows, after enforcing the
    padding-safety contract for every target problem."""
    from ..core import env as env_lib
    for problem in {req.problem for req in requests}:
        env_lib.ensure_padding_safe(problem)
    groups: Dict[Tuple[int, str], List] = {}
    for req in requests:
        key = (bucket_nodes(req.n, min_bucket), req.problem)
        groups.setdefault(key, []).append(req)
    plans = []
    for (nb, problem), reqs in sorted(groups.items(),
                                      key=lambda kv: kv[0]):
        for i in range(0, len(reqs), max_batch):
            plans.append(build_plan(reqs[i:i + max_batch], nb, problem,
                                    max_batch))
    return plans


class _WireRequest(NamedTuple):
    """A request as a received plan carries it (no submission time)."""
    id: int
    n: int
    adj: np.ndarray


def plan_payload(plan: BatchPlan) -> np.ndarray:
    """The wire form of a plan's graphs: each occupied row's real (n, n)
    block, float32 and flat, in row order.  The dense rep multiplies by
    the adjacency's values, so they travel lossless; the padding does not
    travel, :func:`plan_from_payload` rebuilds it."""
    blocks = [plan.adj[row, :n, :n].ravel()
              for row, n in enumerate(plan.sizes)]
    return np.concatenate(blocks) if blocks else np.zeros(0, np.float32)


def plan_from_payload(nb: int, problem: str, request_ids: Sequence[int],
                      sizes: Sequence[int], payload: np.ndarray,
                      rows: int) -> BatchPlan:
    """The plan :func:`plan_payload` was taken from, padded to ``rows``
    rows of the ``nb`` bucket by :func:`build_plan` (its submission times
    stay the sender's)."""
    entries = sum(int(n) ** 2 for n in sizes)
    if entries != payload.size:
        raise ValueError(f"a payload of {payload.size} values for graphs "
                         f"of {entries} adjacency entries")
    reqs, off = [], 0
    for rid, n in zip(request_ids, sizes):
        reqs.append(_WireRequest(int(rid), int(n),
                                 payload[off:off + n * n].reshape(n, n)))
        off += n * n
    return build_plan(reqs, nb, problem, rows)


def unpad_solution(solution_row: np.ndarray, n: int) -> np.ndarray:
    """Strip padding nodes from one (nb,) solution mask back to (n,)."""
    return np.asarray(solution_row[:n])
