"""Graph-solver serving layer (DESIGN.md §9, §14): request queue,
power-of-two size bucketing with padding, first-dispatch warmup, sync
batched dispatch and the async deadline-aware path."""
from .bucketing import (MIN_BUCKET, BatchPlan, bucket_nodes, build_plan,
                        pad_adjacency, plan_batches, unpad_solution)
from .scheduler import DeadlineScheduler, PendingRequest
from .service import (GraphSolverService, ServiceOverloaded, ServiceStats,
                      SolveFuture, SolveRequest, SolveResponse)
