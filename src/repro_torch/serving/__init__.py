"""Graph-solver serving layer (DESIGN.md §9, §14): request queue,
power-of-two size bucketing with padding, first-dispatch warmup, sync
batched dispatch, the async deadline-aware path (on a mesh, with rank 0
as the one planner), and the open-loop Poisson load generator that
measures it."""
from .bucketing import (MIN_BUCKET, BatchPlan, bucket_nodes, build_plan,
                        pad_adjacency, plan_batches, plan_from_payload,
                        plan_payload, unpad_solution)
from .loadgen import LoadReport, Workload, make_workload, run_open_loop
from .scheduler import DeadlineScheduler, PendingRequest
from .service import (GraphSolverService, ServiceOverloaded, ServiceStats,
                      SolveFuture, SolveRequest, SolveResponse,
                      enable_compile_cache)
