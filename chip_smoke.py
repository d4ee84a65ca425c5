#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):

1. The fused S2V layer kernel against its plain PyTorch version on the
   card, at f32 and bf16, at the shapes the main path gives it (served
   buckets 512, 2048 and 4096 with B=8, K=32, and the paper-scale B=1,
   N=20480), a ragged case and a padded case whose isolated nodes must
   give relu(base).
2. Served requests: GraphSolverService at K=32, L=2, multi-node selection,
   max_batch=8, warmed up, answers 24 ER(0.15) graphs of 500..4000 nodes;
   every answer is a vertex cover, no first dispatch lands on the request
   path, and the kernel ran once per policy evaluation.  The async path
   must give the same answers.
3. The card against the port on the CPU on one (B=8, N=256) batch:
   first-evaluation scores within 1e-5, both solutions valid covers.
4. A paper-scale solve: one ER(N=20480, 0.15) graph (~31.5M edges, a
   1.68 GB adjacency on the card) with max_d=256; the answer is a cover.
5. Where an evaluation's time goes (torch.profiler over 20 evaluations
   of a full 4096-node bucket), then timings: kernel, plain version and
   library yardstick (CUDA events around 10 back-to-back calls, median
   of 30 such samples after warm-up) beside the kernel's bound.

It prints diagnostic JSON lines, the nvidia-smi name and power limit, one
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
It exits non-zero without a CUDA device, and outside a checkout.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA H100 SXM data sheet
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores, same sheet


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def is_cover(adj: np.ndarray, solution: np.ndarray) -> bool:
    keep = solution < 0.5
    return float(adj[np.ix_(keep, keep)].sum()) == 0.0


def cuda_ms(torch, fn, reps: int = 30, inner: int = 10, warm: int = 5) -> float:
    """Median device time of one ``fn()`` in ms: each sample puts one event
    pair around ``inner`` back-to-back calls, so the host work of a call
    overlaps the device work of the one before it."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def layer_inputs(torch, b, k, n, rho, seed, dev):
    """Random layer inputs made on ``dev`` from ``seed``: adjacency of
    density ``rho``, embeddings and base in [-0.5, 0.5), theta4 in
    [-0.1, 0.1)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)
    t4 = (rand(k, k) - 0.5) * 0.2
    embed = rand(b, k, n) - 0.5
    adj = (rand(b, n, n) < rho).to(torch.float32)
    base = rand(b, k, n) - 0.5
    return t4, embed, adj, base


def layer_bound(b, k, nl, n):
    """(ms, what bounds it): the least time for one f32 layer on an H100
    SXM, each input read once and the output written once, against the
    f32 FMAs of both products."""
    nbytes = 4 * (k * k + b * k * nl + b * nl * n + 2 * b * k * n)
    flops = 2 * b * k * nl * n + 2 * b * k * k * n
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_tol(compute: str, nl: int) -> float:
    """rtol = atol of the kernel against its plain version.

    bf16: 2e-2, one rounding of the aggregate to bf16 (as
    tests/test_fused_kernel.py).  f32: the kernel sums each aggregate in l
    order, cuBLAS in its own; 1e-5 (as tests/test_fused_kernel.py) up to
    Nl = 4096, then growing in proportion to Nl, as the bound on the
    rounding error of a length-Nl f32 sum does.  At Nl = 20480 the plain
    version alone is ~1.1e-5 from the layer computed in f64, so a fixed
    1e-5 cannot be asked of any other summation order there."""
    return 2e-2 if compute == "bf16" else 1e-5 * max(1.0, nl / 4096)


def phase_kernel(torch, ks, dev):
    """Phase 1: the kernel against its plain version on the card, at every
    shape the main path gives it: buckets 512, 2048 and 4096 of the served
    stream (B=8), the paper-scale graph (B=1, N=20480), a ragged case and
    a padded case.  Every case is measured and printed before any is
    checked.  At f32 both are also held against the layer computed in f64,
    which says how far each is from the exact result."""
    cases = [("ragged", 2, 16, 40, 0.3), ("padded", 2, 32, 300, 0.3),
             ("bucket512", 8, 32, 512, 0.15),
             ("bucket2048", 8, 32, 2048, 0.15),
             ("serving", 8, 32, 4096, 0.15), ("paper", 1, 32, 20480, 0.15)]
    rows, failures = [], []
    for name, b, k, n, rho in cases:
        t4, embed, adj, base = layer_inputs(torch, b, k, n, rho, SEED + n, dev)
        if name == "padded":
            adj[:, :, 256:] = 0.0
            adj[:, 256:, :] = 0.0
        exact = None
        for compute in ("f32", "bf16"):
            out = ks.fused_s2v_layer(t4, embed, adj, base, compute)
            want = ks.fused_s2v_layer_plain(t4, embed, adj, base, compute)
            tol = kernel_tol(compute, n)
            diff = (out - want).abs()
            row = {"phase": "kernel_vs_plain", "case": name, "B": b, "K": k,
                   "N": n, "compute": compute,
                   "max_abs_err": float(diff.max()),
                   "max_abs_want": float(want.abs().max()),
                   # >1 fails: |out - want| against atol + rtol * |want|
                   "worst_ratio_to_tol": float(
                       (diff / (tol + tol * want.abs())).max()), "tol": tol}
            if compute == "f32":
                if exact is None:
                    exact = torch.relu(base.double() + t4.double() @ (
                        embed.double() @ adj.double()))
                row["kernel_err_vs_f64"] = float((out - exact).abs().max())
                row["plain_err_vs_f64"] = float((want - exact).abs().max())
            emit(row)
            rows.append(row)
            # torch.testing.assert_close's rule; a NaN ratio fails too
            if out.shape != want.shape or not row["worst_ratio_to_tol"] <= 1:
                failures.append(f"{name} {compute}: max abs err "
                                f"{row['max_abs_err']}, rtol=atol={tol}")
            if name == "padded" and not torch.equal(
                    out[:, :, 256:], torch.relu(base[:, :, 256:])):
                failures.append(f"padded {compute}: isolated nodes must give "
                                f"relu(base)")
        del t4, embed, adj, base, exact, out, want, diff
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("kernel disagrees with its plain version:\n"
                             + "\n".join(failures))
    return max(r["max_abs_err"] for r in rows if r["compute"] == "f32")


def phase_serve(torch, ks, policy, cfg):
    """Phase 2: served requests through GraphSolverService on the card."""
    from repro_torch.core.graphs import erdos_renyi
    from repro_torch.serving import GraphSolverService
    svc = GraphSolverService(policy, cfg, device="cuda", multi_node=True,
                             max_batch=8)
    warm = svc.warmup([512, 1024, 2048, 4096])
    rng = np.random.default_rng(SEED)
    sizes = rng.permutation(np.tile([500, 1000, 2000, 4000], 6))
    adjs = [erdos_renyi(int(n), 0.15, seed=1000 + i)
            for i, n in enumerate(sizes)]
    ks.fused_s2v_layer.launches = 0
    t0 = time.perf_counter()
    responses = svc.serve(adjs)
    wall = time.perf_counter() - t0
    launches = ks.fused_s2v_layer.launches
    for r, a in zip(responses, adjs):
        if not is_cover(a, r.solution):
            raise AssertionError(f"request {r.id} is not a vertex cover")
    if svc.stats.compiles != 0:
        raise AssertionError(f"{svc.stats.compiles} first dispatches on the "
                             f"request path after warmup")
    batch_evals = {(r.bucket, r.dispatch_t): r.policy_evals
                   for r in responses}
    evals = sum(batch_evals.values())
    if launches != evals:
        raise AssertionError(f"kernel launches {launches} != policy evals "
                             f"{evals} on the served path")
    stats = svc.stats.as_dict()
    futures = [svc.submit_async(a) for a in adjs]
    async_resp = [f.result(timeout=600) for f in futures]
    svc.close()
    for r, s in zip(async_resp, responses):
        if not np.array_equal(r.solution, s.solution):
            raise AssertionError(f"async answer {r.id} differs from sync")
    lat = np.array([r.latency_s for r in responses]) * 1e3
    emit({"phase": "serve", "requests": len(adjs), "wall_s": wall,
          "requests_per_s": len(adjs) / wall,
          "p50_ms": float(np.percentile(lat, 50)),
          "p99_ms": float(np.percentile(lat, 99)),
          "batches": stats["batches"], "policy_evals": evals,
          "kernel_launches": launches, "warmup_s": warm["seconds"],
          "first_dispatch_s": stats["compile_seconds"],
          "solve_s": stats["solve_seconds"],
          "cover_sizes": [r.size for r in responses]})
    return launches


def phase_card_vs_cpu(torch, policy):
    """Phase 3: first-eval scores and solves, card against CPU."""
    from repro_torch.convert import policy_from_numpy, policy_to_numpy
    from repro_torch.core import (DENSE, init_solve_state,
                                  random_graph_batch, solve)
    adj = random_graph_batch("er", 256, 8, seed=SEED + 7, rho=0.15)
    cpu_policy = policy_from_numpy(policy_to_numpy(policy), device="cpu")
    with torch.no_grad():
        scores = {}
        for dev, pol in (("cuda", policy), ("cpu", cpu_policy)):
            st = init_solve_state(DENSE, adj, device=dev)
            scores[dev] = DENSE.scores(pol, st, num_layers=2).cpu()
    err = float((scores["cuda"] - scores["cpu"]).abs().max())
    torch.testing.assert_close(scores["cuda"], scores["cpu"], rtol=1e-5,
                               atol=1e-5)
    res = {dev: solve(pol, adj, num_layers=2, multi_node=True, device=dev)
           for dev, pol in (("cuda", policy), ("cpu", cpu_policy))}
    for dev, r in res.items():
        for g in range(adj.shape[0]):
            if not is_cover(adj[g], r.solution[g]):
                raise AssertionError(f"{dev} solve of graph {g} is no cover")
    emit({"phase": "card_vs_cpu", "first_eval_max_abs_err": err,
          "sizes_cuda": res["cuda"].sizes.tolist(),
          "sizes_cpu": res["cpu"].sizes.tolist(),
          "evals": [res["cuda"].policy_evals, res["cpu"].policy_evals],
          "identical": bool(np.array_equal(res["cuda"].solution,
                                           res["cpu"].solution))})


def phase_paper_scale(torch, ks, policy):
    """Phase 4: one ER(20480, 0.15) graph solved on the card."""
    from repro_torch.core import solve
    from repro_torch.core.graphs import edge_count, erdos_renyi
    n = 20480
    t0 = time.perf_counter()
    adj = erdos_renyi(n, 0.15, seed=SEED + 20480)
    gen_s = time.perf_counter() - t0
    edges = edge_count(adj)
    torch.cuda.reset_peak_memory_stats()
    ks.fused_s2v_layer.launches = 0
    t0 = time.perf_counter()
    res = solve(policy, adj, num_layers=2, multi_node=True, max_d=256,
                device="cuda")
    solve_s = time.perf_counter() - t0
    if not is_cover(adj, res.solution[0]):
        raise AssertionError("paper-scale solve is not a vertex cover")
    if ks.fused_s2v_layer.launches != res.policy_evals:
        raise AssertionError("paper-scale launches != policy evals")
    emit({"phase": "paper_scale", "N": n, "edges": edges,
          "generate_s": gen_s, "solve_s": solve_s,
          "policy_evals": res.policy_evals, "cover_size": int(res.sizes[0]),
          "kernel_launches": ks.fused_s2v_layer.launches,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})


def phase_profile(torch, policy):
    """Where one evaluation's time goes: 20 evaluations of the solve loop
    on a full (8, 4096) bucket under torch.profiler, device time by kernel
    and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import DENSE, get_solve_step, init_solve_state
    from repro_torch.core.graphs import random_graph_batch
    from repro_torch.serving import pad_adjacency
    batch = np.stack([pad_adjacency(a, 4096) for a in random_graph_batch(
        "er", 4000, 8, seed=SEED + 4096, rho=0.15)])
    step = get_solve_step(use_adaptive=True, num_layers=2)
    step(policy, init_solve_state(DENSE, batch, device="cuda"), 3)   # warm
    state = init_solve_state(DENSE, batch, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, evals, _ = step(policy, state, 20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # kernels only: an operator's row repeats its kernels' device time
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and dev_us(e) > 0), reverse=True)
    busy_us = sum(r[0] for r in rows)
    emit({"phase": "profile", "B": 8, "N": 4096, "evals": evals,
          "wall_ms_per_eval": 1e3 * wall / evals,
          "device_ms_per_eval": busy_us / 1e3 / evals,
          "device_busy_share": busy_us / 1e6 / wall,
          "top": [{"name": k[:60], "calls": c, "ms_per_eval": us / 1e3 / evals}
                  for us, c, k in rows[:10]]})


def phase_timing(torch, ks, dev, launches, max_abs_err):
    """Phase 5: device times beside the bound, at the serving shape (the
    kernels line) and at paper scale (a diagnostic line)."""
    entries = {}
    for label, b, k, n in (("serving", 8, 32, 4096), ("paper", 1, 32, 20480)):
        t4, embed, adj, base = layer_inputs(torch, b, k, n, 0.15, SEED, dev)
        bound_ms, bound_by = layer_bound(b, k, n, n)
        row = {"B": b, "K": k, "N": n, "bound_ms": bound_ms,
               "bound_by": bound_by}
        for compute in ("f32", "bf16"):
            row[f"ms_{compute}"] = cuda_ms(torch, lambda: ks.fused_s2v_layer(
                t4, embed, adj, base, compute))
        row["plain_ms"] = cuda_ms(torch, lambda: ks.fused_s2v_layer_plain(
            t4, embed, adj, base, "f32"))
        row["library_ms"] = cuda_ms(torch, lambda: torch.relu(
            base + torch.einsum("kj,bjn->bkn", t4, torch.bmm(embed, adj))))
        entries[label] = row
        emit({"phase": "timing", "shape": label, **row})
        del t4, embed, adj, base
    s = entries["serving"]
    return {"kernels": [{
        "name": "fused_s2v_layer", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/s2v_fused.cu",
        "replaces": "src/repro/kernels/s2v_fused.py:66",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": s["ms_f32"], "plain_ms": s["plain_ms"],
        "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
        "library_ms": s["library_ms"]}]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    src = os.path.join(REPO, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch next to {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.core import PolicyConfig, init_policy
    from repro_torch.kernels import build
    from repro_torch.kernels import s2v_fused as ks

    dev = torch.device("cuda")
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    build.load("s2v_fused")
    ptxas = [ln.strip() for ln in build.build_log("s2v_fused").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    max_abs_err = phase_kernel(torch, ks, dev)
    cfg = PolicyConfig(embed_dim=32, num_layers=2)
    policy = init_policy(cfg, generator=torch.Generator().manual_seed(
        SEED), device="cuda")
    launches = phase_serve(torch, ks, policy, cfg)
    phase_card_vs_cpu(torch, policy)
    phase_paper_scale(torch, ks, policy)
    phase_profile(torch, policy)
    kernels = phase_timing(torch, ks, dev, launches, max_abs_err)
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
