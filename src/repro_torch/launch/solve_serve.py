"""Graph-solver service launcher: drive a mixed-size request stream through
the port's serving layer and fused solve loop on the card, in the sync
drain path or the async path.

    PYTHONPATH=src python -m repro_torch.launch.solve_serve --warmup
    PYTHONPATH=src python -m repro_torch.launch.solve_serve \
        --mode async --sizes 500,1000,2000 --requests 24 --warmup
    PYTHONPATH=src python -m repro_torch.launch.solve_serve --rep csr \
        --sizes 500,1000 --csr-max-edges 200000 --warmup
    PYTHONPATH=src python -m repro_torch.launch.solve_serve --problem mis \
        --rep sparse --warmup
    # open-loop Poisson load at a fixed offered rate (requests/s)
    PYTHONPATH=src python -m repro_torch.launch.solve_serve \
        --mode async --rate 50 --requests 200 --warmup
    # on a machine without a GPU, ask for the CPU explicitly:
    PYTHONPATH=src python -m repro_torch.launch.solve_serve --device cpu
    # on the 2-D (data, graph) mesh, one process per rank (dp·sp cards):
    PYTHONPATH=src torchrun --nproc-per-node 4 -m \
        repro_torch.launch.solve_serve --spatial 2,2 --dist-backend nccl
    PYTHONPATH=src torchrun --nproc-per-node 2 -m \
        repro_torch.launch.solve_serve --spatial 1,2 --dist-backend gloo \
        --device cpu --problem mds --rep sparse
    # open-loop load on the mesh: rank 0 plans, the other ranks follow
    PYTHONPATH=src torchrun --nproc-per-node 2 -m \
        repro_torch.launch.solve_serve --spatial 2,1 --dist-backend gloo \
        --device cpu --mode async --rate 50 --requests 24 --warmup

On a mesh only rank 0 prints.  A sync burst runs SPMD: every rank serves
the same stream.  With ``--mode async`` or ``--rate``, rank 0 alone
makes the stream and submits it, as the service's one planner, and the
other ranks follow its dispatches (``GraphSolverService.follow``).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..core.mesh import TORCHRUN_VARS, join_torchrun, normalize_spatial


def init_mesh_ranks(spatial, backend, device):
    """Join the process group ``torchrun`` describes in the environment and
    return this rank's (rank, device).  Raises without ``torchrun``."""
    dp, sp = normalize_spatial(spatial)
    if any(v not in os.environ for v in TORCHRUN_VARS):
        raise RuntimeError(
            f"--spatial {dp},{sp} runs one process per mesh rank: start it "
            f"with torchrun --nproc-per-node {dp * sp} -m "
            f"repro_torch.launch.solve_serve --spatial {dp},{sp} "
            f"--dist-backend nccl (one card per rank) or gloo (CPU ranks, "
            f"or ranks sharing a card)")
    if backend is None:
        raise ValueError("--spatial needs --dist-backend: nccl (one card per "
                         "rank) or gloo (CPU ranks, or ranks sharing a card)")
    return join_torchrun(backend, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None,
                    help="load policy weights from a checkpoint in the JAX "
                         "package's format (default: fresh random policy)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--sizes", default="12,20,28",
                    help="comma-separated node counts the stream mixes")
    ap.add_argument("--kind", choices=["er", "ba", "social"], default="er")
    ap.add_argument("--problem", default="mvc",
                    choices=["mvc", "maxcut", "mis", "mds"],
                    help="registered environment to solve: mvc (min vertex "
                         "cover), maxcut (max cut), mis (max independent "
                         "set), mds (min dominating set); all four serve "
                         "through the same padded buckets, on one device "
                         "or on a mesh (--spatial)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--embed-dim", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--rep", choices=["dense", "sparse", "csr"],
                    default="dense", help="graph representation")
    ap.add_argument("--spatial", default="0",
                    help="2-D (data, graph) mesh spec: 'dp,sp' splits each "
                         "dispatch dp ways over the batch (--max-batch is "
                         "per data rank) and every policy evaluation sp "
                         "ways over node rows; a bare int P means (1, P); "
                         "0: one device.  A mesh runs under torchrun")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="process-group backend of a mesh: nccl (one card "
                         "per rank) or gloo (CPU ranks, or ranks sharing a "
                         "card)")
    ap.add_argument("--sparse-max-degree", type=int, default=None,
                    help="sparse: neighbour-list width of every bucket "
                         "(default: the bucket's node count)")
    ap.add_argument("--csr-max-edges", type=int, default=None,
                    help="csr: directed edge slots of every bucket "
                         "(default: nb^2)")
    ap.add_argument("--mode", choices=["sync", "async"], default="sync",
                    help="sync: queue everything and drain() once; async: "
                         "submit futures against the scheduler thread")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="offered load in requests/s; > 0 drives an "
                         "open-loop Poisson arrival stream "
                         "(serving/loadgen.py) in --mode instead of a "
                         "burst")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request latency SLO: the async scheduler's "
                         "EDF order and the goodput's on-time count")
    ap.add_argument("--max-wait-ms", type=float, default=50.0,
                    help="longest head-of-queue wait before an underfilled "
                         "bucket dispatches partial")
    ap.add_argument("--queue-depth", type=int, default=512,
                    help="admission bound: async submissions beyond this "
                         "depth are rejected (ServiceOverloaded)")
    ap.add_argument("--warmup", action="store_true",
                    help="run each bucket's first dispatch before the "
                         "first request")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from ..core import is_multi, parse_spatial
    from ..core.mesh import destroy_meshes

    spatial = parse_spatial(args.spatial)
    rank, device = 0, args.device
    if is_multi(spatial):
        rank, device = init_mesh_ranks(spatial, args.dist_backend,
                                       args.device)
    try:
        _serve(args, spatial, rank, device)
    finally:
        if dist.is_initialized():
            destroy_meshes()


def _serve(args, spatial, rank: int, device) -> None:
    import torch
    from ..core import PolicyConfig, init_policy
    from ..core.graphs import barabasi_albert, erdos_renyi, social_like
    from ..serving import GraphSolverService, make_workload, run_open_loop

    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = PolicyConfig(embed_dim=args.embed_dim, num_layers=2,
                       graph_rep=args.rep, spatial=spatial)
    svc_kw = dict(device=device, max_batch=args.max_batch,
                  sparse_max_degree=args.sparse_max_degree,
                  csr_max_edges=args.csr_max_edges,
                  max_wait_ms=args.max_wait_ms,
                  max_queue_depth=args.queue_depth,
                  default_deadline_ms=args.deadline_ms)
    if args.ckpt_dir:
        svc = GraphSolverService.from_checkpoint(args.ckpt_dir, cfg, **svc_kw)
        say(f"policy loaded from {args.ckpt_dir}")
    else:
        gen = torch.Generator().manual_seed(args.seed)
        params = init_policy(cfg, generator=gen, device=device)
        svc = GraphSolverService(params, cfg, **svc_kw)
        say("fresh random policy (pass --ckpt-dir for a trained one)")

    sizes = [int(s) for s in args.sizes.split(",")]
    if args.warmup:
        info = svc.warmup(sizes, problems=[args.problem])
        say(f"warmup: {len(info['compiled'])} buckets in "
            f"{info['seconds']:.2f}s -> request-path first dispatches == 0")
    if rank != 0 and (args.mode == "async" or args.rate > 0):
        svc.follow()                # rank 0 plans and submits
        return

    if args.rate > 0:
        wl = make_workload(args.rate, args.requests, sizes,
                           problem=args.problem, kind=args.kind,
                           deadline_ms=args.deadline_ms, seed=args.seed)
        rep = run_open_loop(svc, wl, mode=args.mode)
        svc.close()
        say(f"{rep.mode} @ {args.rate:.1f} rps offered: "
            f"p50 {rep.p50_ms:.1f}ms p99 {rep.p99_ms:.1f}ms, "
            f"goodput {rep.goodput_rps:.1f} rps "
            f"({rep.on_time}/{rep.submitted} on time, "
            f"{rep.rejected} shed)")
        return
    make = {"er": lambda n, s: erdos_renyi(n, 0.2, seed=s),
            "ba": lambda n, s: barabasi_albert(n, 4, seed=s),
            "social": lambda n, s: social_like(n, seed=s)}[args.kind]
    rng = np.random.default_rng(args.seed)
    adjs = [make(int(rng.choice(sizes)), args.seed + i)
            for i in range(args.requests)]
    t0 = time.time()
    if args.mode == "async":
        futures = [svc.submit_async(a, args.problem) for a in adjs]
        responses = [f.result() for f in futures]
        svc.close()
    else:
        responses = svc.serve(adjs, problem=args.problem)
    dt = time.time() - t0
    for r in responses:
        say(f"  req{r.id:3d}  n={len(r.solution):4d} -> bucket "
            f"{r.bucket:4d}  |S|={r.size:4d}  evals={r.policy_evals}  "
            f"lat={r.latency_s * 1e3:7.1f}ms")
    s = svc.stats
    mesh = f", mesh {svc.mesh_shape}" if svc.mesh is not None else ""
    say(f"served {s.requests} requests on {svc.device} "
        f"({svc.rep.name} rep{mesh}) in {dt:.2f}s: "
        f"{s.batches} batches ({s.partial_batches} partial), "
        f"{s.compiles} request-path first dispatches "
        f"(+{s.warmup_compiles} warmup, {s.compile_seconds:.2f}s), "
        f"{s.padded_rows} padded rows, {s.solve_seconds:.2f}s solving; "
        f"problem {args.problem}")


if __name__ == "__main__":
    main()
