#!/usr/bin/env python3
"""Where a MaxCut, MIS or MDS solve evaluation's time goes on an NVIDIA
GPU, per representation, at the served full bucket.

    python3 benchmarks/pt_problem_evals.py

One dispatch's batch of chip_smoke.py's full bucket (its two ER(4000,
0.15) graphs padded to 4096 nodes, in 8 rows) is solved for each problem
on the dense, sparse and CSR reps as the solve loop runs it: score, top-d
selection, the problem's prune and commit, one read of ``done``.  After
two warm evaluations, three are timed by the host clock (wall) and three
run under torch.profiler: their device time, the share the device is
busy, and the kernels that take the most, per evaluation.

Then ``graphs.csr_segment_max`` (MIS's closed keep and MDS's coverage on
CSR) on that batch's edge slots with 1% of them set, against the plain
row scatter it replaced (every slot to its own row, so the padded slots
all land on row N-1) with chip_smoke.py's ``cuda_ms``.  Prints one JSON
line per case and the card's name and power limit.
"""
from __future__ import annotations

import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

EVALS = 3                          # evaluations timed, and profiled


def evaluate(torch, policy, rep, state, problem):
    from repro_torch.core.inference import apply_selection
    scores = rep.scores(policy, state, num_layers=2)
    state, done, _ = apply_selection(state, scores, state.candidate, True,
                                     problem)
    bool(done.all())
    return state


def profile_evals(torch, cs, policy, rep, batch, problem) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.inference import init_solve_state
    with torch.no_grad():
        state = init_solve_state(rep, batch, problem, device="cuda")
        for _ in range(2):
            state = evaluate(torch, policy, rep, state, problem)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EVALS):
            state = evaluate(torch, policy, rep, state, problem)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / EVALS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(EVALS):
                state = evaluate(torch, policy, rep, state, problem)
            torch.cuda.synchronize()
            profiled = (time.perf_counter() - t0) / EVALS
    rows, device_us = cs.kernel_rows(torch, prof)
    device = device_us / 1e3 / EVALS
    return {"wall_ms": wall * 1e3, "profiled_wall_ms": profiled * 1e3,
            "device_ms": device, "busy_share": device / (profiled * 1e3),
            "top_kernels": [[us / 1e3 / EVALS, calls / EVALS, name[:80]]
                            for us, calls, name in rows[:6]]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pt_problem_evals: this benchmark needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import PolicyConfig, init_policy
    from repro_torch.core.graphs import (csr_row_ids, csr_segment_max,
                                         erdos_renyi)
    from repro_torch.core.inference import init_solve_state
    from repro_torch.kernels import build
    for name in build.sources():
        build.load(name)
    policy = init_policy(PolicyConfig(embed_dim=32, num_layers=2),
                         generator=torch.Generator().manual_seed(cs.SEED),
                         device="cuda")
    real = cs.BUCKET[2]
    batch = cs.full_bucket_batch([erdos_renyi(real, 0.15, seed=1000 + i)
                                  for i in range(2)])
    for name in ("dense", "sparse", "csr"):
        for problem in cs.PROBLEMS:
            cs.emit({"rep": name, "problem": problem, **profile_evals(
                torch, cs, policy, cs.bucket_rep(name), batch, problem)})

    st = init_solve_state(cs.bucket_rep("csr"), batch, "mis", device="cuda")
    rid = csr_row_ids(st.indptr, st.num_edges)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    vals = (torch.rand(st.indices.shape, generator=g, device="cuda")
            < 0.01).float() * st.edge_mask
    n = st.num_nodes

    def row_scatter():
        out = torch.zeros((vals.shape[0], n), device="cuda")
        return out.scatter_reduce_(1, rid.long(), vals, "amax",
                                   include_self=True)

    if not torch.equal(row_scatter(), csr_segment_max(vals, rid, n)):
        raise AssertionError("csr_segment_max differs from the row scatter")
    cs.emit({"case": "csr_segment_max", "slots": list(vals.shape),
             "row_scatter_ms": cs.cuda_ms(torch, row_scatter),
             "spread_ms": cs.cuda_ms(
                 torch, lambda: csr_segment_max(vals, rid, n))})
    cs.print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
