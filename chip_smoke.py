#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --only <kernel>,...   # those kernels' checks, times

Phases (any failed check raises, so the script exits non-zero):

1. Every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, each case also held against the layer
   computed in f64.  The dense fused layer at f32 and bf16 (served buckets
   512, 2048 and 4096 with B=8, K=32, the train minibatch B=64, N=4096,
   the paper-scale B=1, N=20480, a ragged and a padded case); the dense
   aggregate of the mesh path (f32,
   bf16) at a ragged case (Nl=1000, N=2003), a padding case whose empty
   columns must give exact zeros, and the row blocks of the serving
   bucket and the paper-scale graph at sp = 2 and 4; the padded-sparse
   fused layer (f32, bf16), the sparse aggregation (f32, also on a row
   block of the lists, Nl=2048 of N=4096) and the CSR fused layer (f32,
   bf16) on symmetric ER(0.15) graphs: a ragged case, a padding case whose
   isolated nodes must give exactly relu(base) (0 for the aggregation),
   the serving bucket (B=8, N=4096, D=768, 2.5M edge slots per graph) and
   the paper-scale graph (B=1, N=20480, ~62.9M directed edges), and the
   aggregation also on the serving bucket's lists with each node's slots
   shuffled (sentinels among the real slots), there also at K = 16 and 7,
   where the kernel's x windows hold more ids; the CSR
   layer also on BA(N=1M, d=10) (~20.0M directed edges).  The aggregates
   the sparse and CSR backwards run: the sparse aggregation also at bf16,
   and B5's aggregate entry (csr_aggregate, f32 and bf16) on every graph
   case, which at f32 must equal the sparse aggregation bit for bit.
   The sparse and CSR layers and B5's aggregate entry run by the route
   their rule picks (the row walk or the windowed walk), and the other
   route, forced, must give the same bits at f32 and bf16 on every case
   (the sparse layer also on the serving lists with shuffled slots).  On
   every graph case the representations must agree bit for bit at f32:
   the dense
   layer on the residual adjacency equals the sparse and CSR layers, and
   on the serving bucket the dense aggregate of one half of the nodes
   equals the sparse aggregation's row block, which equals the whole
   call's slice.
1b. The LM kernel entry point, ``repro_torch.kernels.ops`` (phase
   lm_kernels): with the counts at 0, one call each of ``wkv6`` (rwkv6-7b:
   BH=128, T=4096, 64x64 heads, chunk 64), ``swa`` (gemma3-4b's local
   layers: BH=16, T=8192, d=256, window 1024) and ``grouped_glu_ffn``
   (qwen2-moe-a2.7b: E=60, C=320, d=2048, f=1408), which must launch
   2, 1 and 2 kernels and give finite outputs; then each kernel against its
   plain version and the f64 oracle (the sequential scan for wkv6) at
   those widths and at ragged, bf16, other-chunk and other-window cases
   (``phase_lm_kernels``), and their times beside the bounds.
2. Served requests: GraphSolverService at K=32, L=2, multi-node
   selection, max_batch=8, warmed up, answers 16 ER(0.15) graphs of
   500..4000 nodes, on the dense, the sparse (sparse_max_degree=768) and
   the CSR (csr_max_edges=2.5M) representations; every answer is a vertex
   cover, no first dispatch lands on the request path, the rep's kernel
   ran once per policy evaluation (its launches by route printed), and
   the async path gives the same answers.
3. The card against the port on the CPU on one (B=8, N=256) batch:
   first-evaluation scores within 1e-5 on each rep, and bit for bit
   across reps on the card; solutions valid covers.
3b. Training on the dense, sparse and CSR reps (phase train): (a) the
   policy gradients of a (B=8, N=256) minibatch loss: on dense through
   B1 and the composition's backward, against the "xla" chain on the
   card and the port on the CPU (rtol = atol = 1e-5); on sparse and CSR
   through B3/B5 and the closed-form backwards (two aggregate launches
   each), against autograd through the plain compositions on the card
   and against the dense rep's gradients (1e-5 at f32, 2e-2 at bf16);
   (b) on each rep, tests/test_engine.py's train configuration (n=14,
   mb=8, tau=2, 8 steps, stored targets, epsilon 0) on the card and the
   CPU from the same weights and draws: the same actions, losses within
   1e-6 relative, parameters within rtol 1e-5 / atol 1e-6; (c) on sparse
   and CSR, the layer at the train minibatch's shape (B=64, N=4096) by
   both routes, bit for bit; on each rep, the paper's policy width (K=32,
   L=2, replay 50,000, minibatch 64, tau=4) on 8 ER(0.15) graphs of
   N=4096, 8 episode graphs a step, 20 fused steps in fresh mode then 20
   in stored mode, each given its draws by ``draw_train_step``: the
   rep's layer kernel (B1, B3, B5) launched 1 + 2 tau = 9 times per warm
   fresh step and 2 + tau = 6 per warm stored step, the sparse and CSR
   aggregates 2 tau = 8 per warm step,
   every warm loss finite, the parameters moved, one warm step under
   ``torch.cuda.set_sync_debug_mode("error")`` and one under
   torch.profiler (device time of act, target, re-materialization,
   forward, backward and Adam), the median, least and most seconds of
   the 10 clean warm steps after them, and the peak device memory; then
   ``train_agent`` for one 9-step episode (bf16 on sparse and CSR); (d)
   the dense trained policy saved, loaded and serving the stream's 16
   graphs, every answer a cover.
3b'. The host engines (phase host_engines, ROADMAP A6a): (a) on a full
   bucket (8 graphs of 4000 nodes at 4096) on each rep,
   ``solve(engine="host")``, the per-evaluation loop, equal to the fused
   solve bit for bit (solutions, evaluations, commits), the rep's layer
   kernel once an evaluation, and on dense a counting ``step_fn`` with
   the default engine taking the same loop, one call an evaluation;
   seconds an evaluation of each; (b) ``train_agent(engine="host")`` at
   phase 3b's cell on its dataset, 13 steps, fresh on each rep and stored
   on dense, each agent building its host replay of 50,000 tuples (the
   resident growth printed and held under a twentieth of the ring's
   bytes): the layer and aggregate launches of each warm step equal to
   the fused step's (9 and 8 fresh, 6 and 8 stored), NaN losses before
   warm and finite after, ``step_count`` the warm steps; seconds a warm
   step beside the fused step's and the synchronizing calls on the main
   thread a warm step, by line (``main_thread_syncs`` in "warn" mode,
   with a control read counted once); (c) at tests/test_engine.py's shape
   on each rep, the host loop on the card against the port's on the CPU
   (fresh, epsilon 0.5: the same replay, losses within 1e-6 relative)
   and the host loop fed the fused step's replay indices against the
   fused step (stored, epsilon 0: losses and parameters within rtol 1e-5
   / atol 1e-6); (d) open-loop load (``serving.loadgen``) on the dense
   service: 32 graphs of the served sizes, a deadline of twice phase 2's
   dense p99, at half and twice its requests/s, sync and async, each on
   a fresh warmed service: every request accounted for, no first
   dispatch on the request path, the layer once an evaluation, every
   answer a cover and equal to ``serve()``'s; each ``LoadReport``
   printed; (e) ``python -m repro_torch.launch.solve_serve --mode async
   --rate 50 --requests 24 --warmup`` in its own process prints its
   report line.
3c. MaxCut, MIS and MDS on one device (phase problems), on each rep:
   (a) a warmed service at phase 2's settings serves two graphs of each
   served size (a full 4000-node bucket among them): every answer passes
   a numpy checker of this script's own (MaxCut's: every positive-degree
   node assigned), the rep's layer kernel once per evaluation, the three
   reps' answers equal bit for bit, one evaluation's selection, prune and
   commit at the full bucket under ``set_sync_debug_mode("error")``,
   phase 3 for the problem (first-evaluation scores within 1e-5 of the
   port on the CPU and bit equal across reps, solves checked); it prints
   the seconds per evaluation at the full bucket (three evaluations after
   the checked one, as the solve loop runs them) and the mean objective
   (MIS and MDS |S|, MaxCut the best cut along the dense solve's
   trajectory) beside ``solvers.heuristic_batch``'s, not gated (the
   baselines run on a host thread from the start); (b) tests/test_problem_suite.py's train smoke
   (n=14, 4 graphs a step, minibatch 8, tau=2, stored, epsilon 0, 6 steps)
   on the card against the CPU, phase 3b's bar; (c) phase 3b's training
   cell, fresh, 13 steps with draws from ``draw_train_step``: the layer
   kernel 9 and the aggregate 8 launches a warm step, every warm loss
   finite, the second warm step under the sync debug mode, the median,
   least and most seconds of the last 4 and the peak device bytes.
4. Large solves: the paper-scale ER(N=20480, 0.15) graph (~31.5M edges)
   on all three reps with max_d=256; the dense solve also traced.
4b. The paper-scale CSR train step (phase paper_train): that graph as
   the dataset, 8 episode copies of it a step, minibatch 64, tau=4,
   fresh targets, the replay cut to 1024 tuples; stepped until warm,
   then the first warm step and one more: their seconds, peak device
   bytes and the part of the step that set it (a third warm step runs
   under torch.profiler), B5 launches 9 and aggregate launches 8 per
   warm step, beside the paper's 316.4 s (its
   own hardware).  If minibatch 64 does not fit on the card, the
   largest of 48, 32 and 16 that does runs and the cut is printed.
5. The (data, graph) mesh: gloo ranks that share the one card (cuda:0),
   spawned once per shape (1,2), (2,1), (2,2) and (1,4) after the kernels
   are built.  On one (B=8, N=256) ER(0.15) batch, dense and sparse (CSR
   at (2,1), the sparse "xla" chain at (1,2)) against the single-device
   port on the card: the rep's kernel (the dense aggregate on the dense
   mesh) once per evaluation on every rank (twice on the xla chain),
   every answer a cover, first-evaluation scores within 1e-5, answers
   identical except where a trajectory parts at a near-tie (both solves
   traced; every parting printed).  At (2,2) the sync service on the 8
   smallest served graphs, held the same way.  The paper-scale graph at
   (1,2) and (1,4) dense and (1,4) sparse: evaluations and cover against
   phase 4, each rank's peak device memory beside the §5.2 model; no
   dense rank at sp = 4 may hold the whole adjacency; the (1,2) dense
   solve traced and held to phase 4's traced solve: where they part, it
   must be at a near-tie (every parting printed).  The mesh's train
   half, inside the same spawns: at (1,2), (2,1) and (2,2) a small
   lockstep on that (8, 256) batch as the dataset (4 episode graphs,
   minibatch 8, tau 2, 6 steps with numpy draws; dense and sparse, stored
   at epsilon 0 and fresh at 0.5, CSR too at (2,1)) against the
   single-device port on the card: the ranks' parameters equal bit for
   bit after every step, the same actions except from a traced near-tie
   on, losses and parameters within rtol 1e-5 / atol 1e-6; and the
   full-width runs (phase 3b's training cell, fresh, epsilon 1, draws
   from draw_train_step) of dense and sparse at (2,2) and CSR at (2,1):
   12 steps, the first warm one's first GD iteration held to the single
   device's on the same draws (the loss by the sum-of-|terms| rule at
   1e-5, the gradients by phase 1's long-sum rule relative to the rows'
   |terms|; ``check_mesh_train_full``), the layer kernel (B2, B3, B5) 9 and the aggregate (B4, B5's)
   8 launches a warm step on every rank, per rank the seconds of 4 timed
   warm steps, the peak device bytes and the collectives a step by kind
   and bytes.  MaxCut, MIS and MDS in the same spawns: solves of that
   batch at every shape, dense and sparse (CSR at (2,1)), held like
   MVC's with the problem's numpy checker and evaluation counts; at
   (2,2) the sync service of MIS and MDS beside MVC's; the small
   lockstep of each problem fresh at epsilon 0.5 at (2,2) dense and
   sparse and (2,1) CSR; the full-width runs of MIS dense and MDS sparse
   at (2,2) and MaxCut CSR at (2,1), held like MVC's.  Every full-width
   run takes one step after its first warm one with its host reads
   counted on the ranks' own threads (``main_thread_syncs``): there must
   be none, while one host read made in the same block, the control,
   must be counted once.  Mesh times are of ranks that share one card: not scaling
   figures.
6. BA(N=1M, d=10) on the CSR rep with max_d=62500, built from streamed
   edges with no dense array; the answer is a cover.
6b. Neighbour-sampled training on that resident graph (phase
   sampled_train, ROADMAP A5): ``NeighborSampler`` (512 seeds, fanouts
   (8, 4)) draws 64 subgraphs of 20,992 nodes and 40,960 edge slots,
   stacked on the card as the CSR dataset (their real nodes, edges and
   maximum degrees and the host seconds a subgraph printed); phase 3b's
   full width (replay 50,000), tau=4, fresh, 8 episode graphs a step, 13
   steps: B5 9 and its aggregate 8 launches a warm step, every one by the
   row walk, one warm step under the sync debug mode, one profiled, the
   rest timed, the peak bytes; on the first warm minibatch's state B5's
   aggregate by the row walk against the windowed walk forced, bit for
   bit, and against its plain version (f32 and bf16); ``train_agent`` for
   one 9-step episode, every launch by the row walk; then the resident
   BA(1M) solved with the trained policy (max_d=62500), a cover; then
   ``train_agent(engine="host")`` for one 9-step episode on that dataset
   (phase sampled_host_train, its agent's host replay at N = 20,992): B5
   9 and its aggregate 8 launches a warm step, every one by the row
   walk, finite warm losses.  Then
   the sparse "xla" chain on a full 4096-node bucket, whose aggregation
   kernel must run twice per evaluation.
7. Where an evaluation's time goes (torch.profiler over 20 evaluations of
   a full 4096-node bucket, per rep), then timings: each kernel (B1 also
   at the train minibatch, B=64, N=4096), its plain version and a library
   yardstick (CUDA events around 10 back-to-back
   calls, median of 30 such samples after warm-up) beside its bound,
   the sparse and CSR layers and the CSR aggregate by each route, the
   aggregate also at the sampled minibatch (the LM kernels' times are
   taken in phase 1b).

It prints diagnostic JSON lines (each phase's seconds among them), the
nvidia-smi name and power limit, one ``{"kernels": [...]}`` line (the eight
kernels, B5's aggregate entry, and the two aggregates at bf16; the
launches of B2–B5 include the full-width mesh train runs' and the mesh
solves of every problem, those of B1 and B3–B5 the problems phase's
served and full-width runs and the host engines' solves, host training
runs and open-loop load, those of B5 and its aggregate the sampled
training's steps, episode, host episode and resident solve), and last
``{"ok": true, "device": {...}}``.  It exits non-zero without a CUDA
device, and outside a checkout.  With ``--only <kernel>,...`` (names of
the kernels line) it runs only the build, phase 1's checks of those
kernels with their gates and their times (for the sparse and CSR layers
and the CSR aggregate both routes, the aggregate also at the sampled
minibatch, and the route sweep behind the rule's constant), the loop
for work on them: it prints no kernels line and no result line.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA H100 SXM data sheet
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores, same sheet
H100_TF32_FLOPS = 495e12         # TF32 on the tensor cores, dense, same sheet
DEVICE = "cuda"
SERVE_SIZES = (500, 1000, 2000, 4000)
SPARSE_MAX_DEGREE = 768          # ~7 sigma above ER(4000, 0.15)'s mean degree
CSR_MAX_EDGES = 2_500_000        # above ER(4000, 0.15)'s 2.40M directed edges
BUCKET = (8, 4096, 4000)         # rows, nodes, real nodes of a full bucket
PAPER_N, PAPER_MAX_D = 20480, 256
BA_N, BA_D, BA_MAX_D = 1_000_000, 10, 62500
CPU_CHECK = (8, 256)             # the card-vs-CPU batch: graphs, nodes
# (name, B, K, N, density) of the dense layer checks
DENSE_CASES = (("ragged", 2, 16, 40, 0.3), ("padded", 2, 32, 300, 0.3),
               ("bucket512", 8, 32, 512, 0.15),
               ("bucket2048", 8, 32, 2048, 0.15),
               ("serving", 8, 32, 4096, 0.15),
               ("minibatch", 64, 32, 4096, 0.15),
               ("paper", 1, 32, PAPER_N, 0.15))
# (name, B, K, Nl, N, density) of the dense aggregate (kernel 2) checks: a
# ragged case, a padding case, and the row blocks of a serving bucket and
# of the paper-scale graph at sp = 2 and 4
AGG_CASES = (("ragged", 2, 32, 1000, 2003, 0.15),
             ("padding", 2, 32, 300, 512, 0.3),
             ("serving_sp2", 8, 32, 2048, 4096, 0.15),
             ("serving_sp4", 8, 32, 1024, 4096, 0.15),
             ("paper_sp2", 1, 32, PAPER_N // 2, PAPER_N, 0.15),
             ("paper_sp4", 1, 32, PAPER_N // 4, PAPER_N, 0.15))
MESH_SHAPES = ((1, 2), (2, 1), (2, 2), (1, 4))
MESH_CHECK = (8, 256)            # the mesh phase's batch: graphs, nodes
MESH_SERVE_SIZES = (500, 1000)   # its served graphs: the stream's smallest
# (rep, mesh) of the paper-scale mesh solves
PAPER_MESH = (("dense", (1, 2)), ("dense", (1, 4)), ("sparse", (1, 4)))
# the paper-scale mesh solves traced beside the traced single-device solve
PAPER_TRACE = (("dense", (1, 2)),)
# The train phase.  Full width: the paper's policy (K=32, L=2, gamma 0.9,
# replay 50,000, minibatch 64) with tau=4 GD iterations a step, on a
# dataset of 8 ER(0.15) graphs at the serving bucket's N=4096, 8 episode
# graphs a step, 20 steps a target mode (warm from index 7: 8 x 8 = 64).
# Index 8 runs under the sync debug mode and 9 under the profiler; the
# steps timed are the clean ones after them, not the first warm step
# (the allocator's first minibatch).
TRAIN_CFG = dict(embed_dim=32, num_layers=2, gamma=0.9,
                 replay_capacity=50_000, minibatch=64)
TRAIN_TAU, TRAIN_STEPS = 4, 20
TRAIN_DATA = (8, 4096, 8)        # dataset graphs, nodes, episode graphs
TRAIN_SYNC_STEP, TRAIN_PROFILE_STEP, TRAIN_TIMED_FROM = 8, 9, 10
TRAIN_REPS = ("dense", "sparse", "csr")
GRAD_CHECK = (8, 256)            # the backward check: tuples, nodes
# The paper-scale CSR train step (phase 4b): phase 4's ER(20480, 0.15)
# graph, 8 episode copies a step, minibatch 64 (or the largest of these
# that fits), tau 4, fresh targets; the replay cut from 50,000 tuples,
# whose two (capacity, N) f32 masks would take 8.2 GB at N = 20480
PAPER_EPISODE, PAPER_MINIBATCHES = 8, (64, 48, 32, 16)
PAPER_REPLAY, PAPER_WARM_STEPS = 1024, 2
PAPER_STEP_S = 316.4             # the paper's one-GPU training step
PLAIN_CHUNK = 16                 # graphs per plain-version call at B = 64
# Neighbour-sampled training on the resident BA(1M, d=10) (phase
# sampled_train, ROADMAP A5): 512 seeds a subgraph and JAX's default
# fanouts (8, 4), so the node budget is 512·(1 + 8 + 32) = 20,992 (the
# paper's N = 20,480 of §6.4) and the edge budget 2·512·40 = 40,960; 64
# subgraphs stacked as the dataset; TRAIN_CFG (the replay of 50,000 not
# cut: its two bool masks take 2.1 GB), tau 4, fresh targets, 8 episode
# graphs a step, 13 steps (index 7 the first warm one, 8 under the sync
# debug mode, 9 profiled, 10-12 timed), then ``train_agent`` for one
# 9-step episode and a solve of the resident graph with that policy
SAMPLED_SEEDS, SAMPLED_FANOUTS, SAMPLED_GRAPHS = 512, (8, 4), 64
SAMPLED_STEPS = 13
# tests/test_engine.py's train configuration: nodes, dataset graphs,
# episode graphs, minibatch, tau, steps; stored targets, epsilon 0
SMALL_TRAIN = (14, 4, 2, 8, 2, 8)
# The host engines (phase host_engines, ROADMAP A6a).  The per-evaluation
# solve on a full bucket per rep; the host training loop at phase 3b's
# cell (TRAIN_CFG, TRAIN_TAU, TRAIN_DATA), fresh on each rep and stored
# on dense, 13 steps (index 7 the first warm one, 9-12 timed), and on the
# sampled dataset one 9-step episode; open-loop load on the dense service:
# 32 requests of the served sizes at half and twice phase 2's dense
# requests/s, a deadline of twice its p99, both drive modes; the
# launcher's --rate
HOST_STEPS, HOST_TIMED_FROM = 13, 9
HOST_EPS = 0.5                   # the small card-vs-CPU host run's epsilon
OPEN_LOOP_REQUESTS, OPEN_LOOP_RATES = 32, (0.5, 2.0)
LAUNCHER_RATE = ("--mode", "async", "--rate", "50", "--requests", "24",
                 "--warmup")
# The problems phase (3c): MaxCut, MIS and MDS.  Served: two graphs of each
# served size, the first of the stream (a full 4000-node bucket among
# them).  Small lockstep: tests/test_problem_suite.py's train smoke (n=14,
# 4 dataset graphs, all 4 a step, minibatch 8, tau 2, 6 steps, stored,
# epsilon 0).  Full width: phase 3b's training cell (TRAIN_CFG, TRAIN_TAU,
# TRAIN_DATA), fresh targets; 7 steps warm the replay, index 7 is the first
# warm step, index 8 (TRAIN_SYNC_STEP) runs under the sync debug mode and
# the rest are timed.
PROBLEMS = ("maxcut", "mis", "mds")
PROBLEM_GRAPHS = 2               # served graphs of each size
PROBLEM_SMALL = (14, 4, 4, 8, 2, 6)
PROBLEM_SMALL_IDS = (0, 1, 2, 3)
PROBLEM_STEPS, PROBLEM_TIMED_FROM = 13, 9
POLICY_KEYS = ("em.theta1", "em.theta2", "em.theta3", "em.theta4",
               "q.theta5", "q.theta6", "q.theta7")
# The mesh's train half (phase 5).  A small lockstep on MESH_CHECK's graphs
# as the dataset: the mesh policy (K=32, L=2), 4 episode graphs, minibatch
# 8, replay 64, tau 2, lr 1e-3, 6 steps (warm from index 1) with numpy
# draws, at each shape of MESH_TRAIN_SMALL: dense and sparse, both target
# modes (stored at epsilon 0, fresh at 0.5), CSR at sp = 1.
MESH_TRAIN_SMALL = ((1, 2), (2, 1), (2, 2))
MESH_SMALL_CFG = dict(embed_dim=32, num_layers=2, gamma=0.9, minibatch=8,
                      replay_capacity=64, learning_rate=1e-3)
MESH_SMALL_RUN = (4, 2, 6)       # episode graphs, tau, steps
# The full-width runs: phase 3b's training cell (TRAIN_CFG, TRAIN_TAU,
# TRAIN_DATA), fresh targets, epsilon 1 (every action the draws' pick, so
# the mesh and the single device push the same tuples), draws from
# draw_train_step; 8 steps warm the replay (8 x 8 = 64), the 8th (index
# 7) is held to the single device, then MESH_FULL_TIMED warm steps timed.
# The other problems' runs are one each: MIS dense and MDS sparse at
# (2, 2), MaxCut CSR at (2, 1).  After the first warm step, one
# step under the sync debug mode, then the timed ones.
MESH_TRAIN_FULL = (("mvc", "dense", (2, 2)), ("mvc", "sparse", (2, 2)),
                   ("mvc", "csr", (2, 1)), ("mis", "dense", (2, 2)),
                   ("mds", "sparse", (2, 2)), ("maxcut", "csr", (2, 1)))
MESH_FULL_WARM, MESH_FULL_TIMED = 7, 4
# MaxCut, MIS and MDS on the mesh: solves of MESH_CHECK's batch at
# every shape of MESH_SHAPES (dense and sparse, CSR at sp = 1); the (2, 2)
# sync service for MESH_SERVICE_PROBLEMS beside MVC; the small lockstep of
# each problem fresh at epsilon 0.5 on the (rep, shape) pairs below.
MESH_SERVICE_PROBLEMS = ("mis", "mds")
MESH_PROBLEM_SMALL = (("dense", (2, 2)), ("sparse", (2, 2)), ("csr", (2, 1)))
# Async serving, open-loop load and the host training loop on the mesh
# (ROADMAP A6b), in the (2, 2) spawn after its sync service: the MVC async
# service on the same graphs, rank 0 its one planner and the other ranks
# following; open-loop load of MESH_OPEN_LOOP_REQUESTS graphs of
# MESH_SERVE_SIZES at MESH_OPEN_LOOP_FACTOR times the sync service's burst
# requests/s, in both modes; the host loop's small lockstep
# (MESH_SMALL_CFG, MESH_SMALL_RUN, fresh, epsilon 1 so that every action is
# the agents' numpy pick) on MESH_HOST_SMALL's (rep, shape) pairs, and
# MESH_HOST_STEPS host-loop steps at MESH_TRAIN_FULL's MVC dense (2, 2)
# cell (the replay warm from index 7: 8 x 8 = 64 tuples; the warm steps
# after the first timed); the launcher's --rate on a (2, 1) mesh under
# torchrun.
MESH_OPEN_LOOP_REQUESTS, MESH_OPEN_LOOP_FACTOR = 16, 2.0
MESH_HOST_SMALL = (("dense", (2, 2)), ("csr", (2, 1)))
MESH_HOST_FULL = ("mvc", "dense", (2, 2))
MESH_HOST_STEPS, MESH_HOST_WARM_FROM = 11, 7
MESH_LAUNCHER_RATE = ("--spatial", "2,1", "--dist-backend", "gloo",
                      *LAUNCHER_RATE)
MESH_TIMEOUT_S = 420.0           # one spawn, its paper-scale solves included
TIMING_BUDGET_S = 1.0            # per timed function (see cuda_ms)
WALKS = ("rows", "windows")      # the sparse and CSR layers' two routes
# The LM kernels at the full width of the models the repo ships for them:
# rwkv6-7b's time mix, B=2 x 64 heads of 64 channels, T=4096, chunk 64
WKV_FULL = (2 * 64, 4096, 64, 64, 64)        # BH, T, dk, dv, chunk
# gemma3-4b's local layers: B=2 x 8 query heads (4 KV heads repeated),
# T=8192, head_dim 256, window 1024
SWA_FULL = (2 * 8, 8192, 256, 1024)          # BH, T, d, window
# qwen2-moe-a2.7b's 60 experts (d=2048, f=1408) at C=320, the all-reduce
# capacity int(T*k/ep*1.25) of models/ffn.py for T=4096, k=4, ep=64
GLU_FULL = (60, 320, 2048, 1408)             # E, C, d, f
W_TPU_MIN = 0.55                 # wkv6 decays at chunk 64 (wkv6.py:17-18)
W_MODEL_MIN = math.exp(-math.e)  # the model's decays (models/rwkv.py:128)
# (name, B, K, N, density, real nodes, list width, edge slots) of the
# sparse and CSR checks; None derives the width and slots from the graph
GRAPH_CASES = (("ragged", 2, 16, 40, 0.3, None, None, None),
               ("padding", 2, 32, 300, 0.3, 256, 160, None),
               ("serving", 8, 32, 4096, 0.15, 4000, SPARSE_MAX_DEGREE,
                CSR_MAX_EDGES),
               ("paper", 1, 32, PAPER_N, 0.15, None, None, None))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def timed_phase(name: str):
    t0 = time.perf_counter()
    yield
    emit({"phase": "seconds", "name": name,
          "seconds": time.perf_counter() - t0})


def is_cover(adj: np.ndarray, solution: np.ndarray) -> bool:
    keep = solution < 0.5
    return float(adj[np.ix_(keep, keep)].sum()) == 0.0


def is_independent(adj: np.ndarray, solution: np.ndarray) -> bool:
    s = solution > 0.5
    return float(adj[np.ix_(s, s)].sum()) == 0.0


def is_dominating(adj: np.ndarray, solution: np.ndarray) -> bool:
    """Every positive-degree node is in S or adjacent to it (isolated
    nodes are padding: they need no domination)."""
    s = solution > 0.5
    covered = s | (adj[:, s].sum(-1) > 0)
    return not bool(((adj.sum(-1) > 0) & ~covered).any())


def is_full_assignment(adj: np.ndarray, solution: np.ndarray) -> bool:
    """MaxCut's solve ends with every positive-degree node in S and no
    isolated one: every assignment is feasible, this one is complete."""
    return bool(np.array_equal(solution > 0.5, adj.sum(-1) > 0))


def cut_size(adj: np.ndarray, solution: np.ndarray) -> float:
    s = solution > 0.5
    return float(adj[np.ix_(s, ~s)].sum())


CHECKS = {"mvc": is_cover, "maxcut": is_full_assignment,
          "mis": is_independent, "mds": is_dominating}


def cuda_ms(torch, fn, reps: int = 30, inner: int = 10, warm: int = 5) -> float:
    """Median device time of one ``fn()`` in ms: each sample puts one event
    pair around ``inner`` back-to-back calls, so the host work of a call
    overlaps the device work of the one before it.  A call slower than
    TIMING_BUDGET_S / (reps · inner) gets fewer samples (at least 5 of one
    call each), so no measurement takes much more than TIMING_BUDGET_S."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once_s = start.elapsed_time(end) / 1e3
    if once_s * reps * inner > TIMING_BUDGET_S:
        inner = 1
        reps = max(5, min(reps, int(TIMING_BUDGET_S / max(once_s, 1e-9))))
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


def kernel_modules():
    from repro_torch.kernels import s2v_csr, s2v_fused, s2v_gather
    return s2v_fused, s2v_gather, s2v_csr


def kernel_fns():
    """The kernel wrappers, by name: the eight kernels and B5's aggregate
    entry."""
    from repro_torch.kernels import ops
    ks, kg, kc = kernel_modules()
    return {"fused_s2v_layer": ks.fused_s2v_layer,
            "mp_aggregate": ks.mp_aggregate,
            "fused_s2v_layer_sparse": ks.fused_s2v_layer_sparse,
            "sparse_mp_aggregate": kg.sparse_mp_aggregate,
            "fused_s2v_layer_csr": kc.fused_s2v_layer_csr,
            "csr_aggregate": kc.csr_aggregate,
            "wkv6_chunked": ops.wkv6, "swa_attention": ops.swa,
            "grouped_glu_ffn": ops.grouped_glu_ffn}


def reset_counts() -> None:
    for fn in kernel_fns().values():
        fn.launches = 0
        for route in getattr(fn, "routes", ()):
            fn.routes[route] = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_fns().items()}


def read_routes() -> dict:
    """The launches of the sparse and CSR layers and of the CSR aggregate
    by route."""
    return {name: dict(fn.routes) for name, fn in kernel_fns().items()
            if hasattr(fn, "routes")}


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


def bound(nbytes: float, flops: float, rate: float = H100_F32_FLOPS):
    """(ms, what bounds it) on an H100 SXM: the bytes a call must move
    (each input read once, the output written once) over the memory rate,
    against its operations over their peak ``rate`` (f32 on the CUDA cores
    unless stated)."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def layer_bound(b, k, nl, n):
    """Bound of one f32 dense layer: theta4, embed, adj, base in, out."""
    return bound(4 * (k * k + b * k * nl + b * nl * n + 2 * b * k * n),
                 2 * b * k * nl * n + 2 * b * k * k * n)


def agg_bound(b, k, nl, n):
    """Bound of one dense aggregate: embed and adj in, the f32 partial
    out; 2·B·K·Nl·N operations."""
    return bound(4 * b * (nl * n + k * nl + k * n), 2 * b * k * nl * n)


def kernel_tol(compute: str, terms: int) -> float:
    """rtol = atol of a kernel against its plain version.

    bf16: 2e-2, one rounding of the aggregate to bf16 (as
    tests/test_fused_kernel.py).  f32: each kernel sums an aggregate as one
    FMA chain in order, the plain versions in their libraries' orders;
    1e-5 (as tests/test_fused_kernel.py) up to 4096 summed terms, then
    growing in proportion to the longest sum, as the bound on the rounding
    error of a length-``terms`` f32 sum does.  At 20480 terms the plain
    dense version alone is ~1.1e-5 from the layer computed in f64, so a
    fixed 1e-5 cannot be asked of any other summation order there."""
    return 2e-2 if compute == "bf16" else 1e-5 * max(1.0, terms / 4096)


def graph_tol(compute: str) -> float:
    """rtol of the sparse and CSR kernels against their plain versions,
    relative to the sum of the absolute values of the summed terms (see
    ``compare``): 1e-5 at f32 (as tests/test_fused_kernel.py) and 2e-2 at
    bf16 (one rounding of the aggregate, as there)."""
    return 2e-2 if compute == "bf16" else 1e-5


def compare(torch, rows, failures, kernel, case, compute, out, want, exact,
            terms, shape, scale=None, tol=None, gate_f64=False):
    """Record one kernel-vs-plain comparison (and, at f32, both against
    the f64 result ``exact``); a failure is collected, not raised, so that
    every case is printed first.

    Without ``scale``: |out - want| <= tol + tol * |want| with
    ``kernel_tol(compute, terms)``.  With ``scale``, the sum of the absolute
    values of the terms behind each output (|base| + |θ4| @ (|x| @ |W|) for
    a layer, |x| @ |W| for an aggregate): |out - want| <= tol + tol * scale
    with ``graph_tol(compute)``, the componentwise bound that rounding
    error analysis gives a sum in any order.  It is needed where the θ4
    product cancels large aggregates, as it does for the non-negative
    (ReLU) embeddings these kernels are given.  ``tol`` overrides either
    default; with ``gate_f64`` the kernel is held to ``exact`` by the same
    rule as well (|exact| in place of |want|)."""
    diff = (out - want).abs()
    if tol is None:
        tol = kernel_tol(compute, terms) if scale is None else graph_tol(
            compute)
    s = want.abs() if scale is None else scale
    row = {"phase": "kernel_vs_plain", "kernel": kernel, "case": case,
           **shape, "compute": compute, "max_abs_err": float(diff.max()),
           "max_abs_want": float(want.abs().max()),
           "rule": "|want|" if scale is None else "sum of |terms|",
           # >1 fails
           "worst_ratio_to_tol": float((diff / (tol + tol * s)).max()),
           "tol": tol}
    if scale is not None:
        # the same difference under the |want| rule, for reference
        row["worst_ratio_to_1e-5_of_want"] = float(
            (diff / (1e-5 + 1e-5 * want.abs())).max())
    if exact is not None:
        diff64 = (out.double() - exact).abs()
        row["kernel_err_vs_f64"] = float(diff64.max())
        row["plain_err_vs_f64"] = float((want.double() - exact).abs().max())
        if gate_f64:
            s = exact.abs() if scale is None else scale
            row["worst_ratio_vs_f64"] = float(
                (diff64 / (tol + tol * s)).max())     # >1 fails
    emit(row)
    rows.append(row)
    # torch.testing.assert_close's rule; a NaN ratio fails too
    if out.shape != want.shape or not row["worst_ratio_to_tol"] <= 1:
        failures.append(f"{kernel} {case} {compute}: max abs err "
                        f"{row['max_abs_err']}, rtol=atol={tol}")
    if gate_f64 and (out.shape != exact.shape
                     or not row["worst_ratio_vs_f64"] <= 1):
        failures.append(f"{kernel} {case} {compute} vs f64: max abs err "
                        f"{row['kernel_err_vs_f64']}, rtol=atol={tol}")


def phase_kernel(torch, ks, dev, rows, failures):
    """Phase 1, dense: the fused dense layer against its plain version at
    every shape the dense path gives it: buckets 512, 2048 and 4096 of the
    served stream (B=8), the paper-scale graph (B=1, N=20480), a ragged
    case and a padded case."""
    for name, b, k, n, rho in DENSE_CASES:
        t4, embed, adj, base = layer_inputs(torch, b, k, n, rho, SEED + n, dev)
        if name == "padded":
            adj[:, :, 256:] = 0.0
            adj[:, 256:, :] = 0.0
        exact = torch.relu(base.double() + t4.double() @ (
            embed.double() @ adj.double()))
        for compute in ("f32", "bf16"):
            out = ks.fused_s2v_layer(t4, embed, adj, base, compute)
            want = ks.fused_s2v_layer_plain(t4, embed, adj, base, compute)
            compare(torch, rows, failures, "fused_s2v_layer", name, compute,
                    out, want, exact if compute == "f32" else None, n,
                    {"B": b, "K": k, "N": n})
            if name == "padded" and not torch.equal(
                    out[:, :, 256:], torch.relu(base[:, :, 256:])):
                failures.append(f"padded {compute}: isolated nodes must give "
                                f"relu(base)")
        del t4, embed, adj, base, exact, out, want
        torch.cuda.empty_cache()


def agg_inputs(torch, b, k, nl, n, rho, seed, dev):
    """Aggregate inputs made on ``dev``: embed = relu of a random tensor
    (the main path aggregates ReLU outputs), adjacency rows of density
    ``rho``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    embed = torch.relu(torch.rand((b, k, nl), generator=g, device=dev) - 0.5)
    adj = (torch.rand((b, nl, n), generator=g, device=dev) < rho).to(
        torch.float32)
    return embed, adj


def check_agg_case(torch, ks, rows, failures, name, embed, adj):
    """The dense aggregate against its plain version on one case's inputs,
    at f32 and bf16, componentwise to the sum of |terms| (|embed| @ |adj|,
    the f64 result itself, as both are non-negative)."""
    b, k, nl = embed.shape
    n = adj.shape[2]
    exact = embed.double() @ adj.double()
    for compute in ("f32", "bf16"):
        out = ks.mp_aggregate(embed, adj, compute)
        compare(torch, rows, failures, "mp_aggregate", name, compute,
                out, ks.mp_aggregate_plain(embed, adj, compute),
                exact if compute == "f32" else None, nl,
                {"B": b, "K": k, "Nl": nl, "N": n}, exact.float())
        if name == "padding" and out[:, :, 256:].any():
            failures.append(f"mp_aggregate padding {compute}: empty "
                            f"columns must give 0")


def phase_agg_kernel(torch, ks, dev, rows, failures):
    """Phase 1, kernel 2: the dense aggregate against its plain version
    (``check_agg_case``) at a ragged case, a padding case whose empty
    columns must give exact zeros, and the row blocks of the serving
    bucket and the paper-scale graph at sp = 2 and 4."""
    for name, b, k, nl, n, rho in AGG_CASES:
        embed, adj = agg_inputs(torch, b, k, nl, n, rho, SEED + nl + n, dev)
        if name == "padding":
            adj[:, :, 256:] = 0.0
            adj[:, 256:, :] = 0.0
        check_agg_case(torch, ks, rows, failures, name, embed, adj)
        del embed, adj
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 1b: the LM kernel entry point (repro_torch.kernels.ops).
# ---------------------------------------------------------------------------

def lm_tol(kernel: str) -> float:
    """rtol = atol of an LM kernel against its plain version and against
    the function computed in f64.

    wkv6_chunked: 3e-4, the JAX suite's bar for the chunked form against
    the sequential scan (tests/test_kernels.py): the chunk formula's
    exponents reach c·|log w| (~40), so each exp is ~40 ulp from exact.
    swa_attention: 1e-4, the JAX suite's bar (a softmax-weighted mean of
    values of size ~1).  grouped_glu_ffn: componentwise against the sum of
    |terms| (``glu_exact``), at ``graph_tol("f32")`` = 1e-5, the rule of
    the sparse and CSR kernels for long sums: at d=2048 and f=1408 the
    outputs are sums of thousands of terms that cancel, so |want| is no
    measure of their rounding."""
    return {"wkv6_chunked": 3e-4, "swa_attention": 1e-4,
            "grouped_glu_ffn": graph_tol("f32")}[kernel]


def wkv6_inputs(torch, dev, bh, t, dk, dv, w_min, seed):
    """r, k in 0.5·N(0,1), v in N(0,1), u in 0.3·N(0,1) (as
    tests/test_kernels.py) and decays w uniform in [w_min, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    w = w_min + (1 - w_min) * torch.rand((bh, t, dk), generator=g,
                                         device=dev)
    return (randn(bh, t, dk) * 0.5, randn(bh, t, dk) * 0.5, randn(bh, t, dv),
            w, randn(bh, dk) * 0.3)


def wkv6_scan64(torch, r, k, v, w, u):
    """The sequential scan of ref.wkv6, in f64: the independent oracle."""
    r, k, v, w, u = (a.double() for a in (r, k, v, w, u))
    bh, t, dk = r.shape
    s = torch.zeros((bh, dk, v.shape[2]), dtype=torch.float64,
                    device=r.device)
    out = torch.empty(v.shape, dtype=torch.float64, device=r.device)
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]
        out[:, i] = torch.bmm(r[:, i, None, :], s + u[:, :, None] * kv)[:, 0]
        s = w[:, i, :, None] * s + kv
    return out, s


def swa_exact(torch, q, k, v, window):
    """The masked softmax of ref.swa in f64, over blocks of 512 queries,
    each against the keys its window reaches."""
    bh, t, d = q.shape
    q, k, v = (a.double() for a in (q, k, v))
    out = torch.empty_like(q)
    for q0 in range(0, t, 512):
        q1 = min(q0 + 512, t)
        k0 = max(0, q0 - window + 1)
        logits = (q[:, q0:q1] @ k[:, k0:q1].transpose(1, 2)) * d ** -0.5
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = torch.arange(k0, q1, device=q.device)[None, :]
        seen = (kj <= qi) & (kj > qi - window)
        out[:, q0:q1] = torch.softmax(logits.masked_fill(~seen, -math.inf),
                                      dim=-1) @ v[:, k0:q1]
    return out


def glu_exact(torch, x, wg, wu, wo):
    """(the GLU FFN in f64, the sum of |terms| behind each output): the
    terms of h = silu(g)·u carry g's and u's sums (|silu'(g)·u|·|x|@|wg|
    + |silu(g)|·|x|@|wu|) beside |h|, and each output sums those through
    |wo|."""
    x, wg, wu, wo = (a.double() for a in (x, wg, wu, wo))
    g, u = torch.bmm(x, wg), torch.bmm(x, wu)
    sig = torch.sigmoid(g)
    silu = g * sig
    h = silu * u
    y = torch.bmm(h, wo)
    dsilu = sig * (1 + g * (1 - sig))
    terms_h = (h.abs() + (dsilu * u).abs() * torch.bmm(x.abs(), wg.abs())
               + silu.abs() * torch.bmm(x.abs(), wu.abs()))
    return y, torch.bmm(terms_h, wo.abs())


def glu_inputs(torch, dev, e, c, d, f, seed):
    """x in N(0,1), weights in N(0,1)/sqrt(fan-in), as a model holds them."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    return (randn(e, c, d), randn(e, d, f) * d ** -0.5,
            randn(e, d, f) * d ** -0.5, randn(e, f, d) * f ** -0.5)


def wkv6_bound(bh, t, dk, dv, c):
    """r, k, w, v, u in, out and the final state out; per chunk and head
    the multiply-adds the chunk formula needs: the strict lower triangle of
    a = qp kpᵀ (c(c-1)/2·dk) and its diagonal bonus (c·dk), a v over the
    lower triangle with the diagonal (c(c+1)/2·dv), qp S and kdᵀ v
    (c·dk·dv each); two FLOPs per multiply-add."""
    macs = (c * (c - 1) // 2 * dk + c * dk + c * (c + 1) // 2 * dv
            + 2 * c * dk * dv)
    return bound(4 * (bh * t * (3 * dk + 2 * dv) + bh * dk + bh * dk * dv),
                 2 * bh * (t // c) * macs)


def wkv6_split_ops_ms(bh, t, dk, dv, c, passes=3):
    """The operations time of csrc/wkv6.cu's split at the card's peaks, in
    ms: a (its strict lower triangle and diagonal), a v and qp S as
    ``passes`` TF32 products on the tensor cores, kdᵀ v in f32 on the CUDA
    cores, one after the other.  Beside ``wkv6_bound``'s byte time, which
    it does not exceed at rwkv6-7b's width."""
    chunks = bh * (t // c)
    tf32 = (c * (c - 1) // 2 * dk + c * dk + c * (c + 1) // 2 * dv
            + c * dk * dv)
    return 1e3 * 2 * chunks * (passes * tf32 / H100_TF32_FLOPS
                               + c * dk * dv / H100_F32_FLOPS)


def swa_bound(bh, t, d, window, rate=H100_TF32_FLOPS, passes=3):
    """q, k, v in, out out; 4·d FLOPs for each visible (query, key) pair,
    of which query i has min(i + 1, window), each done as ``passes`` TF32
    products on the tensor cores (the split hi·hi + hi·lo + lo·hi that
    holds f32 accuracy).  ``rate=H100_F32_FLOPS, passes=1`` gives the
    bound of the same products on the CUDA cores."""
    w = min(window, t)
    pairs = bh * (w * (w + 1) // 2 + (t - w) * w)
    return bound(4 * 4 * bh * t * d, passes * 4 * d * pairs, rate)


def glu_bound(e, c, d, f, rate=H100_TF32_FLOPS, passes=3):
    """x and the three weights in, y out (the f32 scratch h is the
    kernel's, not the function's); three (C, d, f) products per expert,
    each done as ``passes`` TF32 products on the tensor cores (the split
    hi·hi + hi·lo + lo·hi that holds f32 accuracy).  ``rate=H100_F32_FLOPS,
    passes=1`` gives the bound of the same products on the CUDA cores."""
    return bound(4 * (2 * e * c * d + 3 * e * d * f),
                 passes * 6 * e * c * d * f, rate)


LM_KERNELS = ("wkv6_chunked", "swa_attention", "grouped_glu_ffn")


def lm_inputs(torch, dev, names=LM_KERNELS):
    """The full-width inputs of the named LM kernels: rwkv6-7b's time mix
    (``WKV_FULL``), gemma3-4b's local layers (``SWA_FULL``) and
    qwen2-moe-a2.7b's experts (``GLU_FULL``)."""
    inputs = {}
    if "wkv6_chunked" in names:
        bh, t, dk, dv, _ = WKV_FULL
        inputs["wkv6_chunked"] = wkv6_inputs(torch, dev, bh, t, dk, dv,
                                             W_TPU_MIN, SEED + 61)
    if "swa_attention" in names:
        g = torch.Generator(device=dev).manual_seed(SEED + 62)
        inputs["swa_attention"] = [torch.randn(SWA_FULL[:3], generator=g,
                                               device=dev) for _ in range(3)]
    if "grouped_glu_ffn" in names:
        inputs["grouped_glu_ffn"] = glu_inputs(torch, dev, *GLU_FULL,
                                               SEED + 63)
    return inputs


def phase_lm_kernels(torch, dev, rows, failures):
    """Phase 1b: the three LM kernels through ``repro_torch.kernels.ops``.

    The main path: with every launch count at 0, one call of each at full
    width (rwkv6-7b, gemma3-4b's local layers, qwen2-moe-a2.7b), outputs
    finite and of the expected shape.  Then each kernel against its plain
    version and the f64 oracle (``lm_checks``), and last, times beside
    the bounds (``lm_timing``).
    Returns ({name: launches}, {name: timing row})."""
    from repro_torch.kernels import ops
    inputs = lm_inputs(torch, dev)
    chunk, window = WKV_FULL[4], SWA_FULL[3]
    torch.cuda.synchronize()
    reset_counts()
    outs = {"wkv6_chunked": ops.wkv6(*inputs["wkv6_chunked"], chunk=chunk),
            "swa_attention": ops.swa(*inputs["swa_attention"],
                                     window=window),
            "grouped_glu_ffn": ops.grouped_glu_ffn(*inputs["grouped_glu_ffn"])}
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {n: counts[n] for n in LM_KERNELS}
    emit({"phase": "lm_main_path", "launches": launches})
    bh, t, dk, dv, _ = WKV_FULL
    for name, o, shape in (("wkv6 out", outs["wkv6_chunked"][0], (bh, t, dv)),
                           ("wkv6 state", outs["wkv6_chunked"][1],
                            (bh, dk, dv)),
                           ("swa", outs["swa_attention"], SWA_FULL[:3]),
                           ("grouped_glu_ffn", outs["grouped_glu_ffn"],
                            GLU_FULL[:2] + GLU_FULL[2:3])):
        if tuple(o.shape) != shape or not bool(torch.isfinite(o).all()):
            failures.append(f"{name}: shape {tuple(o.shape)} (want {shape}) "
                            f"or non-finite values on the main path")
    if launches != {"wkv6_chunked": 2, "swa_attention": 1,
                    "grouped_glu_ffn": 2}:
        failures.append(f"LM main path launched {launches}, want 2, 1, 2")
    lm_checks(torch, dev, rows, failures, LM_KERNELS, inputs, outs)
    del outs
    torch.cuda.empty_cache()
    return launches, lm_timing(torch, dev, LM_KERNELS, inputs)


def lm_checks(torch, dev, rows, failures, names, inputs, outs=None):
    """The named LM kernels against their plain versions and the f64
    oracle (the sequential scan for wkv6): wkv6 at full width (chunk 64,
    w >= 0.55, the TPU kernel's domain; and chunk 16 over the model's decay
    range [exp(-e), 1), as launch/serve.py runs it), a ragged small case
    (BH=3, dv=24) at chunks 16, 32 and 64, bf16 inputs; swa at full width,
    a window that is not tile-aligned (200), a window >= T (causal) and a T
    that is not a multiple of the 64-query tile; the GLU at full width and
    at the ragged (3, 100, 72, 90) and (1, 5, 3, 7) (``glu_checks``).  At
    full width ``outs`` (the main path's outputs) are checked where
    given."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.swa import swa_attention_plain
    from repro_torch.kernels.wkv6 import wkv6_chunked_plain
    outs = outs or {}

    def wkv_case(case, args, c, compute="f32", got=None):
        got = got or ops.wkv6(*args, chunk=c)
        want = wkv6_chunked_plain(*args, chunk=c)
        exact = wkv6_scan64(torch, *args)
        shape = {"BH": args[0].shape[0], "T": args[0].shape[1],
                 "dk": args[0].shape[2], "dv": args[2].shape[2], "chunk": c,
                 "w_min": float(args[3].min())}
        for part, i in (("out", 0), ("state", 1)):
            compare(torch, rows, failures, "wkv6_chunked", f"{case}/{part}",
                    compute, got[i], want[i], exact[i], None, shape,
                    tol=lm_tol("wkv6_chunked"), gate_f64=True)

    if "wkv6_chunked" in names:
        bh, t, dk, dv, chunk = WKV_FULL
        wkv_case("full", inputs["wkv6_chunked"], chunk,
                 got=outs.get("wkv6_chunked"))
        wkv_case("full_model_decays", wkv6_inputs(
            torch, dev, bh, t, dk, dv, W_MODEL_MIN, SEED + 64), 16)
        small = wkv6_inputs(torch, dev, 3, 128, 16, 24, W_TPU_MIN, SEED + 65)
        for c in (16, 32, 64):
            wkv_case(f"ragged_c{c}", small, c)
        half = [a.bfloat16() for a in wkv6_inputs(torch, dev, 8, 256, 64, 64,
                                                  W_TPU_MIN, SEED + 66)]
        wkv_case("bf16", half, 64, "bf16")

    def swa_case(case, args, win, got=None):
        got = got if got is not None else ops.swa(*args, window=win)
        b_, t_, d_ = args[0].shape
        compare(torch, rows, failures, "swa_attention", case, "f32", got,
                swa_attention_plain(*args, window=win),
                swa_exact(torch, *args, win), None,
                {"BH": b_, "T": t_, "d": d_, "window": win},
                tol=lm_tol("swa_attention"), gate_f64=True)

    if "swa_attention" in names:
        swa_case("full", inputs["swa_attention"], SWA_FULL[3],
                 outs.get("swa_attention"))
        for case, b_, t_, d_, win, seed in (
                ("window200", 2, 1024, 256, 200, 67),
                ("causal", 2, 512, 128, 4096, 68),
                ("ragged_T", 3, 1000, 64, 300, 69)):
            g = torch.Generator(device=dev).manual_seed(SEED + seed)
            swa_case(case, [torch.randn((b_, t_, d_), generator=g, device=dev)
                            for _ in range(3)], win)
    if "grouped_glu_ffn" in names:
        glu_checks(torch, dev, rows, failures, inputs["grouped_glu_ffn"],
                   outs.get("grouped_glu_ffn"))
    torch.cuda.empty_cache()


def lm_timing(torch, dev, names, inputs):
    """Times of the named LM kernels at full width beside their bounds,
    their plain versions and a library yardstick.  Returns {name: row}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.swa import swa_attention_plain
    from repro_torch.kernels.wkv6 import wkv6_chunked_plain
    timing = {}
    if "wkv6_chunked" in names:
        wkv = inputs["wkv6_chunked"]
        bh, t, dk, dv, chunk = WKV_FULL
        row = {"BH": bh, "T": t, "dk": dk, "dv": dv, "chunk": chunk}
        row["bound_ms"], row["bound_by"] = wkv6_bound(bh, t, dk, dv, chunk)
        row["ops_ms_split_tf32"] = wkv6_split_ops_ms(bh, t, dk, dv, chunk)
        row["ms_f32"] = cuda_ms(torch, lambda: ops.wkv6(*wkv, chunk=chunk))
        row["plain_ms"] = cuda_ms(torch, lambda: wkv6_chunked_plain(
            *wkv, chunk=chunk))
        row["library_ms"] = None     # no single PyTorch call computes it
        timing["wkv6_chunked"] = row
    if "swa_attention" in names:
        qkv = inputs["swa_attention"]
        sbh, st, sd, window = SWA_FULL
        row = {"BH": sbh, "T": st, "d": sd, "window": window}
        row["bound_ms"], row["bound_by"] = swa_bound(sbh, st, sd, window)
        row["bound_ms_f32_cores"] = swa_bound(sbh, st, sd, window,
                                              H100_F32_FLOPS, 1)[0]
        row["ms_f32"] = cuda_ms(torch, lambda: ops.swa(*qkv, window=window))
        row["plain_ms"] = cuda_ms(torch, lambda: swa_attention_plain(
            *qkv, window=window))
        idx = torch.arange(st, device=dev)
        mask = (idx[None, :] <= idx[:, None]) & (idx[None, :]
                                                 > idx[:, None] - window)
        heads = [a[None] for a in qkv]          # (1, BH, T, d)
        row["library_ms"] = cuda_ms(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                *heads, attn_mask=mask))
        timing["swa_attention"] = row
        del mask, heads
        torch.cuda.empty_cache()
    for name, r in timing.items():
        emit({"phase": "timing", "kernel": name, "shape": "full", **r})
    if "grouped_glu_ffn" in names:
        timing["grouped_glu_ffn"] = glu_timing(torch,
                                               inputs["grouped_glu_ffn"])
    torch.cuda.empty_cache()
    return timing


# (E, C, d, f) of the GLU checks beside the full width: ragged C, d and f,
# and a case smaller than every tile
GLU_RAGGED = ((3, 100, 72, 90), (1, 5, 3, 7))


def glu_checks(torch, dev, rows, failures, glu, y=None):
    """Kernel 8 against its plain version and against f64 by the
    componentwise rule of ``lm_tol`` at full width (``y``: the main path's
    output on ``glu``, when given) and at the ragged ``GLU_RAGGED``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gemm import grouped_glu_ffn_plain

    def glu_case(case, args, got=None):
        got = got if got is not None else ops.grouped_glu_ffn(*args)
        exact, scale = glu_exact(torch, *args)
        e_, c_, d_ = args[0].shape
        compare(torch, rows, failures, "grouped_glu_ffn", case, "f32", got,
                grouped_glu_ffn_plain(*args), exact, None,
                {"E": e_, "C": c_, "d": d_, "f": args[1].shape[2]}, scale,
                tol=lm_tol("grouped_glu_ffn"), gate_f64=True)

    glu_case("full", glu, y)
    for i, shape in enumerate(GLU_RAGGED):
        glu_case("ragged" if i == 0 else "tiny",
                 glu_inputs(torch, dev, *shape, SEED + 70 + i))


def glu_timing(torch, glu):
    """Kernel 8's time at full width beside its bounds (three TF32 passes
    on the tensor cores; the same products in f32 on the CUDA cores under
    ``bound_ms_f32_cores``), its plain version and the cuBLAS yardstick."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gemm import grouped_glu_ffn_plain
    e, c, d, f = (*glu[0].shape, glu[1].shape[2])
    row = {"E": e, "C": c, "d": d, "f": f}
    row["bound_ms"], row["bound_by"] = glu_bound(e, c, d, f)
    row["bound_ms_f32_cores"] = glu_bound(e, c, d, f, H100_F32_FLOPS, 1)[0]
    row["ms_f32"] = cuda_ms(torch, lambda: ops.grouped_glu_ffn(*glu))
    # the plain version and the yardstick in true f32: cuBLAS would take
    # TF32 if allowed (repro_torch.device turns it off; stated here too)
    torch.backends.cuda.matmul.allow_tf32 = False
    row["allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
    row["plain_ms"] = cuda_ms(torch, lambda: grouped_glu_ffn_plain(*glu))
    x, wg, wu, wo = glu
    row["library_ms"] = cuda_ms(torch, lambda: torch.bmm(
        torch.nn.functional.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wo))
    emit({"phase": "timing", "kernel": "grouped_glu_ffn", "shape": "full",
          **row})
    return row


# ---------------------------------------------------------------------------
# Sparse and CSR inputs, made on the card.
# ---------------------------------------------------------------------------

def sym_graph(torch, b, n, rho, seed, dev, real=None):
    """(B, N, N) float32 symmetric ER(rho) adjacency on ``dev``; the nodes
    from ``real`` on are isolated, as a serving bucket pads."""
    g = torch.Generator(device=dev).manual_seed(seed)
    upper = torch.triu(torch.rand((b, n, n), generator=g, device=dev) < rho,
                       diagonal=1)
    adj = (upper | upper.transpose(1, 2)).to(torch.float32)
    del upper
    if real is not None:
        adj[:, real:, :] = 0.0
        adj[:, :, real:] = 0.0
    return adj


def device_topology(torch, adj, width=None, edges=None):
    """The padded-sparse and CSR batches of a (B, N, N) adjacency, built on
    its device with the host builders' layout: neighbours ascending,
    sentinel N on padding, ``width`` list slots and ``edges`` edge slots
    (the batch's own maxima when None)."""
    from repro_torch.core.graphs import CsrGraphBatch, SparseGraphBatch
    b, n, _ = adj.shape
    dev = adj.device
    valid = adj > 0
    true_md = int(valid.sum(-1).max())
    width = width or max(true_md, 1)
    if true_md > width:
        raise AssertionError(f"max degree {true_md} exceeds the width {width}")
    cols = torch.arange(n, device=dev, dtype=torch.int32)
    key = torch.where(valid, cols, torch.full_like(cols, n))
    nbr = torch.sort(key, dim=-1).values
    del key
    nbr = (nbr[..., :width] if width <= n else
           torch.nn.functional.pad(nbr, (0, width - n), value=n)).contiguous()
    sparse = SparseGraphBatch(neighbors=nbr, valid=nbr < n)
    bi, ri, ci = valid.nonzero().unbind(1)
    del valid
    per = torch.bincount(bi, minlength=b)
    true_e = int(per.max())
    edges = edges or max(true_e, 1)
    if true_e > edges:
        raise AssertionError(f"{true_e} edges exceed the {edges} slots")
    pos = torch.arange(len(bi), device=dev) - (torch.cumsum(per, 0) - per)[bi]
    indices = torch.full((b, edges), n, dtype=torch.int32, device=dev)
    indices[bi, pos] = ci.to(torch.int32)
    rowc = torch.bincount(bi * n + ri, minlength=b * n).reshape(b, n)
    indptr = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)
    indptr[:, 1:] = torch.cumsum(rowc, 1)
    return sparse, CsrGraphBatch(indptr=indptr, indices=indices,
                                 edge_mask=indices < n)


def graph_case(torch, dev, b, k, n, rho, seed, real=None, width=None,
               edges=None):
    """One symmetric ER graph batch as sparse and CSR topology, with the
    residual factors of a random 10% partial solution, random base and
    theta4, x = relu of a random tensor (the main path gives these
    kernels ReLU outputs), the residual adjacency W as a dense f32 batch
    (for the dense kernels' bit-identity gate) and the f64 aggregate
    x @ W."""
    from repro_torch.core.graphs import (csr_residual_edge_mask, csr_row_ids,
                                         residual_edge_mask)
    adj = sym_graph(torch, b, n, rho, seed, dev, real)
    sp, cs = device_topology(torch, adj, width, edges)
    g = torch.Generator(device=dev).manual_seed(seed + 1)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)
    sol = (rand(b, n) < 0.1).to(torch.float32)
    x, base, t4 = torch.relu(rand(b, k, n) - 0.5), rand(b, k, n) - 0.5, \
        (rand(k, k) - 0.5) * 0.2
    keep = 1.0 - sol
    w = adj.mul_(keep[:, :, None]).mul_(keep[:, None, :])   # 0/1: exact
    w64 = w.double()
    agg64 = x.double() @ w64          # W is symmetric: column i = row i
    abs64 = x.abs().double() @ w64    # W >= 0
    del w64
    torch.cuda.empty_cache()
    rid = csr_row_ids(cs.indptr, cs.num_edges)
    return {"sp": sp, "cs": cs, "x": x, "base": base, "t4": t4, "w": w,
            "edge": residual_edge_mask(sp.neighbors, sp.valid, sol),
            "edge_w": csr_residual_edge_mask(cs.indices, cs.edge_mask, rid,
                                             sol),
            "agg64": agg64, "abs64": abs64, "real": real}


def csr_exact(torch, x, cs, edge_w):
    """The f64 aggregate of a CSR batch, for graphs too large for a dense
    W (a gather and a row sum in f64)."""
    from repro_torch.core.graphs import csr_row_ids
    from repro_torch.kernels.s2v_csr import segment_rows
    b, k, n = x.shape
    e = cs.num_edges
    gathered = torch.gather(torch.nn.functional.pad(x.double(), (0, 1)), 2,
                            cs.indices.long()[:, None, :].expand(b, k, e))
    gathered.mul_(edge_w.double()[:, None, :])
    return segment_rows(gathered, csr_row_ids(cs.indptr, e), n)


def ba_arrays():
    """BA(N=1M, d=10) streamed to CSR arrays on the host (no dense array),
    and the seconds it took.  Runs on a thread beside the first phases."""
    from repro_torch.core.graphs import barabasi_albert_edges, csr_from_edges
    t0 = time.perf_counter()
    src, dst = barabasi_albert_edges(BA_N, BA_D, seed=SEED)
    indptr, indices = csr_from_edges(BA_N, src, dst)
    return indptr, indices, time.perf_counter() - t0


def bit_identity(torch, failures, case, kernel, out, vs, got):
    """Record, and require, that a dense kernel's output equals another
    representation's kernel output bit for bit on the same graph."""
    same = bool(torch.equal(out, got))
    emit({"phase": "bit_identity", "case": case, "kernel": kernel,
          "vs": vs, "identical": same,
          "max_abs_diff": float((out - got).abs().max())})
    if not same:
        failures.append(f"{kernel} {case} f32 differs from {vs}: the three "
                        f"representations must sum in one order")


def walks(fn):
    """The routes a layer's wrapper can be forced to take (its ``walk``
    keyword), or () for a wrapper without one (a checkout from before the
    windowed layers, timed beside this one)."""
    import inspect
    return WALKS if "walk" in inspect.signature(fn).parameters else ()


def call_routed(fn, *args):
    """``fn(*args)`` and the route its launch took (None for a wrapper
    that counts no routes)."""
    routes = getattr(fn, "routes", None)
    before = dict(routes or {})
    out = fn(*args)
    route = next((r for r, c in (routes or {}).items() if c != before[r]),
                 None)
    return out, route


def route_identity(torch, failures, kernel, case, compute, fn, args, out,
                   route):
    """The gate that a layer's two routes give the same bits: ``out`` came
    by ``route``, the rule's choice; the other route is forced on the
    same inputs and must equal it bit for bit."""
    if route is None or not walks(fn):
        return
    other = next(w for w in walks(fn) if w != route)
    got = fn(*args, compute, walk=other)
    same = bool(torch.equal(out, got))
    emit({"phase": "route_identity", "kernel": kernel, "case": case,
          "compute": compute, "route": route, "vs": other, "identical": same,
          "max_abs_diff": float((out - got).abs().max())})
    if not same:
        failures.append(f"{kernel} {case} {compute}: the {route} and {other} "
                        f"walks differ: both must sum in slot order")


ROUTED = ("fused_s2v_layer_sparse", "fused_s2v_layer_csr")   # two walks
GRAPH_LAYERS = ("fused_s2v_layer",) + ROUTED
GRAPH_AGGREGATES = ("mp_aggregate", "sparse_mp_aggregate", "csr_aggregate")


def run_graph_kernels(torch, case, name, rows, failures, names=GRAPH_LAYERS
                      + GRAPH_AGGREGATES):
    """Phase 1's checks on one graph case of the kernels ``names`` asks
    for: the layers' (``check_graph_layers``) when it names any of kernels
    1, 3 and 5 (their gate needs all three), kernel 4's
    (``check_sparse_aggregate``, with kernel 2's gate) when it names
    kernel 2 or 4, and B5's aggregate entry's (``check_csr_aggregate``,
    with B4's gate) when it names it or kernel 4."""
    if set(names) & set(GRAPH_LAYERS):
        check_graph_layers(torch, case, name, rows, failures)
    if set(names) & {"mp_aggregate", "sparse_mp_aggregate"}:
        check_sparse_aggregate(torch, case, name, rows, failures)
    if set(names) & {"sparse_mp_aggregate", "csr_aggregate"}:
        check_csr_aggregate(torch, case, name, rows, failures)


def check_graph_layers(torch, case, name, rows, failures):
    """Kernels 3 and 5 on one graph case against their plain versions
    (and the f64 layer), by the route the rule picks, and that route
    against the other bit for bit (f32 and bf16); the padding case's
    isolated nodes must give exactly relu(base).  At the serving case also
    kernel 3 on the lists with shuffled slots, both routes.  Then the gate
    that the three representations sum in one order: at f32, kernel 1 on
    the dense residual adjacency W with embed = x must equal kernels 3 and
    5 bit for bit."""
    ks, _, kc = kernel_modules()
    sp, cs, x, base, t4 = (case[f] for f in ("sp", "cs", "x", "base", "t4"))
    b, k, n = x.shape
    d = sp.max_degree
    row_max = int((cs.indptr[:, 1:] - cs.indptr[:, :-1]).max())
    agg64 = case["agg64"]
    layer64 = torch.relu(base.double() + t4.double() @ agg64)
    scale = (base.double().abs() + t4.double().abs() @ case["abs64"]).float()
    real = case["real"]
    shape = {"B": b, "K": k, "N": n}
    f32_out = {}
    layers = (("fused_s2v_layer_sparse", ks.fused_s2v_layer_sparse,
               ks.fused_s2v_layer_sparse_plain,
               (t4, x, sp.neighbors, case["edge"], base), d, {"D": d}),
              ("fused_s2v_layer_csr", kc.fused_s2v_layer_csr,
               kc.fused_s2v_layer_csr_plain,
               (t4, x, cs.indices, cs.indptr, case["edge_w"], base), row_max,
               {"E": cs.num_edges}))
    for compute in ("f32", "bf16"):
        for kernel, fn, plain, args, terms, extra in layers:
            out, route = call_routed(fn, *args, compute)
            if compute == "f32":
                f32_out[kernel] = out
            compare(torch, rows, failures, kernel, name, compute, out,
                    plain(*args, compute),
                    layer64 if compute == "f32" else None, terms,
                    {**shape, **extra, "route": route}, scale)
            if real is not None and not torch.equal(
                    out[:, :, real:], torch.relu(base[:, :, real:])):
                failures.append(f"{kernel} {name} {compute}: isolated nodes")
            route_identity(torch, failures, kernel, name, compute, fn, args,
                           out, route)
            del out
        torch.cuda.empty_cache()
    if name == "serving":
        nbr, edge = shuffle_slots(torch, sp.neighbors, case["edge"],
                                  SEED + 17)
        args = (t4, x, nbr, edge, base)
        for compute in ("f32", "bf16"):
            out, route = call_routed(ks.fused_s2v_layer_sparse, *args,
                                     compute)
            compare(torch, rows, failures, "fused_s2v_layer_sparse",
                    "serving_shuffled", compute, out,
                    ks.fused_s2v_layer_sparse_plain(*args, compute),
                    layer64 if compute == "f32" else None, d,
                    {**shape, "D": d, "route": route}, scale)
            route_identity(torch, failures, "fused_s2v_layer_sparse",
                           "serving_shuffled", compute,
                           ks.fused_s2v_layer_sparse, args, out, route)
        del nbr, edge, out, args
    dense = ks.fused_s2v_layer(t4, x, case["w"], base, "f32")
    for vs, got in f32_out.items():
        bit_identity(torch, failures, name, "fused_s2v_layer", dense, vs, got)
    del dense, f32_out, layer64, scale
    torch.cuda.empty_cache()


def shuffle_slots(torch, nbr, edge, seed):
    """The same neighbour lists with each node's slots in a random order,
    so the sentinel slots lie among the real ones and ids do not ascend."""
    g = torch.Generator(device=nbr.device).manual_seed(seed)
    perm = torch.argsort(torch.rand(nbr.shape, generator=g,
                                    device=nbr.device), dim=-1)
    return (torch.gather(nbr, -1, perm).contiguous(),
            torch.gather(edge, -1, perm).contiguous())


def check_sparse_aggregate(torch, case, name, rows, failures):
    """Kernel 4 on one graph case against its plain version and the f64
    aggregate, componentwise to the sum of |terms|; the padding case's
    isolated nodes must give 0.  At the serving case also: a graph rank's
    row block at sp = 2, which must equal the whole call's slice bit for
    bit, and kernel 2 on W's columns of those nodes (by symmetry, the
    transposed row block) bit for bit; and the lists with shuffled slots,
    whole, as that row block, and on x's first 16 and 7 rows (KP = 16 and
    8: 2.7 and 1.3 of the kernel's x windows over the 4097 ids)."""
    ks, kg, _ = kernel_modules()
    sp, x = case["sp"], case["x"]
    b, k, n = x.shape
    d = sp.max_degree
    agg64, abs64 = case["agg64"], case["abs64"]
    shape = {"B": b, "K": k, "N": n, "D": d}
    xp = torch.nn.functional.pad(x, (0, 1))

    def run(label, nbr, edge, rows_b=slice(None), whole=None,
            k_b=slice(None), compute="f32"):
        args = (xp[:, k_b].contiguous(), nbr[:, rows_b].contiguous(),
                edge[:, rows_b].contiguous())
        out = kg.sparse_mp_aggregate(*args, compute)
        nl = args[1].shape[1]
        compare(torch, rows, failures, "sparse_mp_aggregate", label, compute,
                out, kg.sparse_mp_aggregate_plain(*args, compute),
                agg64[:, k_b, rows_b] if compute == "f32" else None, d,
                {**shape, "K": args[0].shape[1], "Nl": nl},
                abs64[:, k_b, rows_b].float())
        if whole is not None:
            bit_identity(torch, failures, label, "sparse_mp_aggregate", out,
                         "sparse_mp_aggregate on all rows", whole[:, :, rows_b])
        return out

    run(name, sp.neighbors, case["edge"], compute="bf16")
    out = run(name, sp.neighbors, case["edge"])
    real = case["real"]
    if real is not None and out[:, :, real:].any():
        failures.append(f"aggregate {name}: isolated nodes must give 0")
    if name == "serving":
        # a graph rank's lists at sp = 2: the upper half of the rows, its
        # isolated padding rows included, against the whole x
        rows_b = slice(n // 2, n)
        part = run("serving_rows_sp2", sp.neighbors, case["edge"], rows_b,
                   out)
        cols = case["w"][:, :, rows_b].contiguous()
        bit_identity(torch, failures, "serving_rows_sp2", "mp_aggregate",
                     ks.mp_aggregate(x, cols, "f32"), "sparse_mp_aggregate",
                     part)
        del cols, part
        nbr, edge = shuffle_slots(torch, sp.neighbors, case["edge"],
                                  SEED + 13)
        out = run("serving_shuffled", nbr, edge)
        run("serving_shuffled_rows_sp2", nbr, edge, rows_b, out)
        for kk in (16, 7):
            run(f"serving_shuffled_k{kk}", nbr, edge, k_b=slice(0, kk))
        del nbr, edge
    del out, xp
    torch.cuda.empty_cache()


def check_csr_aggregate(torch, case, name, rows, failures):
    """B5's aggregate entry on one graph case against its plain version,
    at f32 (and the f64 aggregate) and bf16, componentwise to the sum of
    |terms|, by the route the rule picks and against the other route,
    forced, bit for bit; the padding case's isolated nodes must give 0.
    At f32 it must equal B4's aggregate on the same graph's lists bit for
    bit: both walk each node's slots in ascending id order, as the three
    reps' layers do."""
    from repro_torch.core.graphs import csr_row_ids
    _, kg, kc = kernel_modules()
    cs, x, edge_w = case["cs"], case["x"], case["edge_w"]
    b, k, n = x.shape
    rid = csr_row_ids(cs.indptr, cs.num_edges)
    row_max = int((cs.indptr[:, 1:] - cs.indptr[:, :-1]).max())
    args = (x, cs.indices, cs.indptr, edge_w)
    for compute in ("f32", "bf16"):
        out, route = call_routed(kc.csr_aggregate, *args, compute)
        compare(torch, rows, failures, "csr_aggregate", name, compute, out,
                kc.csr_aggregate_plain(x, cs.indices, rid, edge_w, compute),
                case["agg64"] if compute == "f32" else None, row_max,
                {"B": b, "K": k, "N": n, "E": cs.num_edges, "route": route},
                case["abs64"].float())
        route_identity(torch, failures, "csr_aggregate", name, compute,
                       kc.csr_aggregate, args, out, route)
        real = case["real"]
        if real is not None and out[:, :, real:].any():
            failures.append(f"csr_aggregate {name} {compute}: isolated "
                            f"nodes must give 0")
        if compute == "f32" and case["sp"] is not None:
            bit_identity(torch, failures, name, "csr_aggregate", out,
                         "sparse_mp_aggregate", kg.sparse_mp_aggregate(
                             torch.nn.functional.pad(x, (0, 1)),
                             case["sp"].neighbors, case["edge"]))
        del out
    del rid
    torch.cuda.empty_cache()


def phase_graph_kernels(torch, dev, rows, failures,
                        names=GRAPH_LAYERS + GRAPH_AGGREGATES):
    """Phase 1, sparse and CSR: kernels 3, 4 and 5 (those ``names`` asks
    for, see ``run_graph_kernels``) at a ragged case, a padding case, the
    serving bucket and the paper-scale graph."""
    if not set(names) & set(GRAPH_LAYERS + GRAPH_AGGREGATES):
        return
    for name, b, k, n, rho, real, width, edges in GRAPH_CASES:
        case = graph_case(torch, dev, b, k, n, rho, SEED + 7 * n, real,
                          width, edges)
        run_graph_kernels(torch, case, name, rows, failures, names)
        del case
        torch.cuda.empty_cache()


def ba_case(torch, dev, cs, seed):
    """Layer inputs on a CSR batch (the BA graph, or the subgraphs sampled
    from it): residual factors of a random 10% partial solution, x = relu
    of a random tensor, random base, theta4."""
    from repro_torch.core.graphs import csr_residual_edge_mask, csr_row_ids
    g = torch.Generator(device=dev).manual_seed(seed)
    b, n = cs.batch, cs.num_nodes
    sol = (torch.rand((b, n), generator=g, device=dev) < 0.1).float()
    return {"sp": None, "cs": cs, "edge": None,
            "x": torch.relu(torch.rand((b, 32, n), generator=g, device=dev)
                            - 0.5),
            "base": torch.rand((b, 32, n), generator=g, device=dev) - 0.5,
            "t4": (torch.rand((32, 32), generator=g, device=dev) - 0.5) * 0.2,
            "edge_w": csr_residual_edge_mask(
                cs.indices, cs.edge_mask,
                csr_row_ids(cs.indptr, cs.num_edges), sol)}


def ba_kernel_check(torch, dev, cs, rows, failures):
    """Phase 1 on BA(1M, d=10): the CSR layer against its plain version
    (and the f64 layer), where one row has degree 8975, by the route the
    rule picks and against the other route bit for bit."""
    _, _, kc = kernel_modules()
    case = ba_case(torch, dev, cs, SEED + 1)
    x, base, t4, edge_w = case["x"], case["base"], case["t4"], case["edge_w"]
    n = cs.num_nodes
    layer64 = torch.relu(base.double() + t4.double()
                         @ csr_exact(torch, x, cs, edge_w))
    scale = (base.double().abs() + t4.double().abs()
             @ csr_exact(torch, x.abs(), cs, edge_w.abs())).float()
    row_max = int((cs.indptr[:, 1:] - cs.indptr[:, :-1]).max())
    args = (t4, x, cs.indices, cs.indptr, edge_w, base)
    for compute in ("f32", "bf16"):
        out, route = call_routed(kc.fused_s2v_layer_csr, *args, compute)
        compare(torch, rows, failures, "fused_s2v_layer_csr", "ba1m", compute,
                out, kc.fused_s2v_layer_csr_plain(*args, compute),
                layer64 if compute == "f32" else None, row_max,
                {"B": 1, "K": 32, "N": n, "E": cs.num_edges,
                 "max_row": row_max, "route": route}, scale)
        route_identity(torch, failures, "fused_s2v_layer_csr", "ba1m",
                       compute, kc.fused_s2v_layer_csr, args, out, route)
        del out
    del layer64, scale, case, x, base, edge_w, args
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The main paths.
# ---------------------------------------------------------------------------

def make_service(policy, cfg, rep):
    from repro_torch.serving import GraphSolverService
    return GraphSolverService(policy, cfg, rep=rep, device=DEVICE,
                              multi_node=True, max_batch=8,
                              sparse_max_degree=SPARSE_MAX_DEGREE,
                              csr_max_edges=CSR_MAX_EDGES)


REP_KERNEL = {"dense": "fused_s2v_layer", "sparse": "fused_s2v_layer_sparse",
              "csr": "fused_s2v_layer_csr"}


def phase_serve(torch, policy, cfg, adjs, rep, dense=None):
    """Phase 2: served requests through GraphSolverService on the card, on
    one representation.  Returns (kernel launches, responses, the row it
    prints)."""
    svc = make_service(policy, cfg, rep)
    warm = svc.warmup(list(SERVE_SIZES))
    reset_counts()
    t0 = time.perf_counter()
    responses = svc.serve(adjs)
    wall = time.perf_counter() - t0
    counts, routes = read_counts(), read_routes()
    launches = counts[REP_KERNEL[rep]]
    for r, a in zip(responses, adjs):
        if not is_cover(a, r.solution):
            raise AssertionError(f"{rep}: request {r.id} is not a cover")
    if svc.stats.compiles != 0:
        raise AssertionError(f"{rep}: {svc.stats.compiles} first dispatches "
                             f"on the request path after warmup")
    batch_evals = {(r.bucket, r.dispatch_t): r.policy_evals
                   for r in responses}
    evals = sum(batch_evals.values())
    if launches != evals:
        raise AssertionError(f"{rep}: kernel launches {launches} != policy "
                             f"evals {evals} on the served path")
    stats = svc.stats.as_dict()
    futures = [svc.submit_async(a) for a in adjs]
    async_resp = [f.result(timeout=600) for f in futures]
    svc.close()
    for r, s in zip(async_resp, responses):
        if not np.array_equal(r.solution, s.solution):
            raise AssertionError(f"{rep}: async answer {r.id} differs from "
                                 f"sync")
    lat = np.array([r.latency_s for r in responses]) * 1e3
    row = {"phase": "serve", "rep": rep, "requests": len(adjs),
           "wall_s": wall, "requests_per_s": len(adjs) / wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "batches": stats["batches"], "policy_evals": evals,
           "kernel_launches": counts, "kernel_routes": routes,
           "warmup_s": warm["seconds"],
           "first_dispatch_s": stats["compile_seconds"],
           "solve_s": stats["solve_seconds"],
           "cover_sizes": [r.size for r in responses]}
    if dense is not None:
        row["answers_equal_to_dense"] = sum(
            bool(np.array_equal(r.solution, d.solution))
            for r, d in zip(responses, dense))
    emit(row)
    return launches, responses, row


def phase_card_vs_cpu(torch, policy, problem="mvc"):
    """Phase 3: first-eval scores and solves of ``problem``, card against
    CPU, on each rep (every answer passing its checker); first-eval scores
    across reps on the card, which must agree bit for bit (the three
    reps' kernels sum in one order)."""
    from repro_torch.convert import policy_from_numpy, policy_to_numpy
    from repro_torch.core import (CSR, DENSE, SPARSE, init_solve_state,
                                  random_graph_batch, solve)
    adj = random_graph_batch("er", CPU_CHECK[1], CPU_CHECK[0], seed=SEED + 7,
                             rho=0.15)
    cpu_policy = policy_from_numpy(policy_to_numpy(policy), device="cpu")
    scores = {}
    for rep in (DENSE, SPARSE, CSR):
        with torch.no_grad():
            for dev, pol in (("cuda", policy), ("cpu", cpu_policy)):
                st = init_solve_state(rep, adj, problem,
                                      device=policy.device
                                      if dev == "cuda" else dev)
                scores[rep.name, dev] = rep.scores(pol, st, num_layers=2).cpu()
        err = float((scores[rep.name, "cuda"]
                     - scores[rep.name, "cpu"]).abs().max())
        torch.testing.assert_close(scores[rep.name, "cuda"],
                                   scores[rep.name, "cpu"], rtol=1e-5,
                                   atol=1e-5)
        res = {dev: solve(pol, adj, num_layers=2, multi_node=True,
                          rep=rep.name, problem=problem, device=pol.device)
               for dev, pol in (("cuda", policy), ("cpu", cpu_policy))}
        for dev, r in res.items():
            for g in range(adj.shape[0]):
                if not CHECKS[problem](adj[g], r.solution[g]):
                    raise AssertionError(f"{rep.name} {dev} {problem} solve "
                                         f"of graph {g} fails its checker")
        emit({"phase": "card_vs_cpu", "problem": problem, "rep": rep.name,
              "first_eval_max_abs_err": err,
              "sizes_cuda": res["cuda"].sizes.tolist(),
              "sizes_cpu": res["cpu"].sizes.tolist(),
              "evals": [res["cuda"].policy_evals, res["cpu"].policy_evals],
              "identical": bool(np.array_equal(res["cuda"].solution,
                                               res["cpu"].solution))})
    for rep in ("sparse", "csr"):
        a, d = scores[rep, "cuda"], scores["dense", "cuda"]
        torch.testing.assert_close(a, d, rtol=1e-5, atol=1e-5)
        same = bool(torch.equal(a, d))
        emit({"phase": "cross_rep_on_card", "problem": problem, "rep": rep,
              "vs": "dense",
              "first_eval_max_abs_err": float((a - d).abs().max()),
              "bit_identical": same})
        if not same:
            raise AssertionError(f"first-evaluation scores on {rep} differ "
                                 f"from dense on the card: the three "
                                 f"representations must sum in one order")


# ---------------------------------------------------------------------------
# The train phase.
# ---------------------------------------------------------------------------

REP_AGGREGATE = {"sparse": "sparse_mp_aggregate", "csr": "csr_aggregate"}


@contextlib.contextmanager
def plain_layers():
    """The sparse and CSR layers as their plain compositions under
    autograd (no kernel): the reference of their closed-form backwards."""
    from repro_torch.core import s2v_csr, s2v_sparse
    ks, _, kc = kernel_modules()

    class Sparse:
        @staticmethod
        def apply(theta4, x, nbr, edge, base, compute, axis=None):
            assert axis is None, "the plain sparse layer runs on one device"
            return ks.fused_s2v_layer_sparse_plain(theta4, x, nbr, edge,
                                                   base, compute)

    class Csr:
        apply = staticmethod(kc.fused_s2v_layer_csr_plain)
    saved = s2v_sparse._FusedSparseLayer, s2v_csr._FusedCsrLayer
    s2v_sparse._FusedSparseLayer, s2v_csr._FusedCsrLayer = Sparse, Csr
    try:
        yield
    finally:
        s2v_sparse._FusedSparseLayer, s2v_csr._FusedCsrLayer = saved


def minibatch_loss_grads(torch, policy, state, action, target, kernel,
                         rep="dense", compute="f32"):
    """The minibatch loss of ``train_minibatch_raw`` (unmasked scores at
    the actions against the targets) and its gradients, by policy key."""
    from repro_torch.core import get_rep
    s = get_rep(rep).scores(policy, state, num_layers=2, masked=False,
                            kernel=kernel, compute=compute)
    qsa = torch.gather(s, 1, action[:, None])[:, 0]
    loss = torch.mean(torch.square(qsa - target))
    grads = torch.autograd.grad(loss, list(policy.parameters()))
    return {"loss": loss.detach(), **dict(zip(POLICY_KEYS, grads))}


def grad_errors(torch, got, want, tol):
    """Each key's max |got - want|, held to rtol = atol = ``tol``."""
    errs = {}
    for key, w in want.items():
        torch.testing.assert_close(got[key], w, rtol=tol, atol=tol)
        errs[key] = float((got[key] - w).abs().max())
    return errs


def check_train_grads(torch, policy):
    """(a) The layers' backwards on the card: the policy gradients of a
    (B=8, N=256) minibatch loss.  Dense: kernel="fused" (B1 forward, the
    composition's backward) against kernel="xla" on the card and the port
    on the CPU, within 1e-5.  Sparse and CSR: the closed-form backwards
    (B3/B5 forward, two aggregate launches a layer backward) against
    autograd through the plain compositions on the card, within 1e-5 at
    f32 and 2e-2 at bf16 (``kernel_tol``), and against the dense rep's
    gradients on the card at each compute mode."""
    from repro_torch.convert import policy_from_numpy, policy_to_numpy
    from repro_torch.core import get_rep, random_graph_batch
    b, n = GRAD_CHECK
    adj = random_graph_batch("er", n, b, seed=SEED + 13, rho=0.15)
    rng = np.random.default_rng(SEED + 13)
    sol = (rng.random((b, n)) < 0.3).astype(np.float32)
    action = rng.integers(0, n, size=b)
    target = rng.standard_normal(b).astype(np.float32)
    cpu_policy = policy_from_numpy(policy_to_numpy(policy), device="cpu")
    fns = kernel_fns()

    def run(rep, pol, kernel, compute="f32"):
        dev = pol.device
        r = get_rep(rep)
        st = r.state_from_tuples(r.prepare_dataset(adj, device=dev),
                                 np.arange(b), sol)
        a, t = (torch.as_tensor(x, device=dev) for x in (action, target))
        reset_counts()
        got = minibatch_loss_grads(torch, pol, st, a, t, kernel, rep,
                                   compute)
        return {k: v.cpu() for k, v in got.items()}, read_counts()

    out = {}
    for where, pol in (("card", policy), ("cpu", cpu_policy)):
        for kernel in ("fused", "xla"):
            out[where, kernel], counts = run("dense", pol, kernel)
            if where == "card" and counts["fused_s2v_layer"] != (
                    kernel == "fused"):
                raise AssertionError(f"the {kernel} loss launched B1 "
                                     f"{counts['fused_s2v_layer']} times")
    row = {"phase": "train_grads", "rep": "dense", "B": b, "N": n}
    for ref in (("card", "xla"), ("cpu", "fused")):
        row["vs_" + "_".join(ref)] = grad_errors(torch, out["card", "fused"],
                                                 out[ref], 1e-5)
    emit(row)
    for compute in ("f32", "bf16"):
        dense, _ = run("dense", policy, "fused", compute)
        for rep in ("sparse", "csr"):
            got, counts = run(rep, policy, "fused", compute)
            with plain_layers():
                want, plain_counts = run(rep, policy, "fused", compute)
            layer, agg = REP_KERNEL[rep], REP_AGGREGATE[rep]
            if (counts[layer], counts[agg]) != (1, 2) or any(
                    plain_counts.values()):
                raise AssertionError(
                    f"the {rep} {compute} loss launched {layer} "
                    f"{counts[layer]} and {agg} {counts[agg]} times (1 and "
                    f"2 wanted), its plain version {plain_counts}")
            tol = kernel_tol(compute, 1)
            emit({"phase": "train_grads", "rep": rep, "compute": compute,
                  "B": b, "N": n, "tol": tol, "launches": {
                      layer: counts[layer], agg: counts[agg]},
                  "vs_autograd_of_plain": grad_errors(torch, got, want, tol),
                  "vs_dense": grad_errors(torch, got, dense, tol)})


def small_train_run(torch, arrays, adj, draws, device, rep, problem="mvc",
                    shape=SMALL_TRAIN, graph_ids=(0, 2)):
    """(b)'s run on ``device``, ``rep`` and ``problem``: the train
    configuration ``shape`` (stored targets, epsilon 0) from the weights
    ``arrays``, each step given its draws.  Returns (losses, actions,
    trained weights)."""
    from repro_torch.convert import policy_from_numpy, policy_to_numpy
    from repro_torch.core import (Agent, PolicyConfig, TrainDraws,
                                  engine_init, env, get_rep, get_train_step)
    n, _, b, mb, tau, _ = shape
    cfg = PolicyConfig(embed_dim=8, num_layers=2, minibatch=mb,
                       replay_capacity=64, learning_rate=1e-3,
                       eps_start=0.0, eps_end=0.0)
    agent = Agent(cfg, num_nodes=n, target_mode="stored", device=device,
                  params=policy_from_numpy(arrays, device=device))
    r = get_rep(rep)
    step = get_train_step(cfg, rep=r, problem=problem, tau=tau,
                          target_mode="stored")
    es = engine_init(cfg, agent.params, agent.opt, n)
    source = r.prepare_dataset(adj, device=device)
    gi = torch.as_tensor(graph_ids, device=device)
    state = r.state_from_tuples(source, gi, np.zeros((b, n), np.float32),
                                residual=env.residual_mode(problem),
                                candidate_fn=env.candidate_rule(problem))
    losses, actions = [], []
    for d in draws:
        es, state, action, _, _, loss = step(
            es, state, source, gi,
            TrainDraws(*(torch.as_tensor(x, device=device) for x in d)))
        losses.append(float(loss))
        actions.append(action.cpu().numpy())
    return np.array(losses), np.stack(actions), policy_to_numpy(agent.params)


def check_small_train(torch, rep, problem="mvc", shape=SMALL_TRAIN,
                      graph_ids=(0, 2)):
    """(b) The card against the port on the CPU on ``rep`` and
    ``problem``: the same weights, graphs and draws; actions identical,
    losses within 1e-6 relative and every parameter within rtol 1e-5 /
    atol 1e-6 (tests/test_engine.py's bar)."""
    from repro_torch.convert import policy_to_numpy
    from repro_torch.core import PolicyConfig, init_policy, random_graph_batch
    n, g, b, mb, tau, steps = shape
    adj = random_graph_batch("er", n, g, seed=SEED, rho=0.3)
    arrays = policy_to_numpy(init_policy(
        PolicyConfig(embed_dim=8), generator=torch.Generator().manual_seed(
            SEED + 14), device="cpu"))
    rng = np.random.default_rng(SEED + 14)
    draws = [(rng.random(b).astype(np.float32), rng.integers(0, n, b),
              rng.integers(0, min(b * (i + 1), 64), (tau, mb)))
             for i in range(steps)]
    run = (arrays, adj, draws)
    card = small_train_run(torch, *run, DEVICE, rep, problem, shape,
                           graph_ids)
    cpu = small_train_run(torch, *run, "cpu", rep, problem, shape, graph_ids)
    what = f"small {problem} train run on {rep}"
    parted = np.flatnonzero((card[1] != cpu[1]).any(-1))
    if len(parted):
        raise AssertionError(f"{what}: the card's actions part from the "
                             f"CPU's at step {parted[0]}: "
                             f"{card[1][parted[0]]} vs {cpu[1][parted[0]]}")
    warm = np.isfinite(cpu[0])
    if not np.array_equal(np.isfinite(card[0]), warm) or warm.sum() < 4:
        raise AssertionError(f"{what}: warm steps differ: {card[0]} vs "
                             f"{cpu[0]}")
    np.testing.assert_allclose(card[0][warm], cpu[0][warm], rtol=1e-6,
                               atol=1e-6)
    for key in POLICY_KEYS:
        np.testing.assert_allclose(card[2][key], cpu[2][key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    emit({"phase": "train_card_vs_cpu", "problem": problem, "rep": rep,
          "n": n, "steps": steps,
          "warm_steps": int(warm.sum()),
          "loss_max_rel_err": float(np.max(np.abs(card[0][warm]
                                                  - cpu[0][warm])
                                           / np.abs(cpu[0][warm]))),
          "param_max_abs_err": max(float(np.abs(card[2][k] - cpu[2][k])
                                         .max()) for k in POLICY_KEYS)})


def dev_us(e, attr="self_"):
    """A profiler event's device microseconds, ``attr`` "self_" or "" (the
    name torch gives it has changed: device_time or cuda_time)."""
    for name in (f"{attr}device_time_total", f"{attr}cuda_time_total"):
        if hasattr(e, name):
            return getattr(e, name)
    return 0.0


def profile_call(torch, fn):
    """``fn()`` under torch.profiler, host and device, with the card
    synchronized on both sides.  Returns (its result, the profiler, wall
    seconds)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, prof, wall


def kernel_rows(torch, prof):
    """The profile's kernels, (device us, calls, name), most time first,
    and their device us in all.  Kernels only: an operator's row repeats
    its kernels' device time, and a ``train_step.`` range's device-side
    span carries its name."""
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith("train_step.")
                   and dev_us(e) > 0), reverse=True)
    return rows, sum(r[0] for r in rows)


def profile_train_step(torch, fn):
    """One train step under torch.profiler: wall and device ms, the device
    ms of each ``train_step.<part>`` range (the kernels of the ops inside
    it; the backward's run on autograd's device thread, so its part sums
    the outermost ``autograd::engine::evaluate_function`` events) and the
    ten kernels with the most device time."""
    out, prof, wall = profile_call(torch, fn)
    engine = "autograd::engine::evaluate_function"

    def outermost(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith(engine):
            p = p.cpu_parent
        return p is None
    parts = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if e.name.startswith("train_step."):
            part = parts.setdefault(e.name[11:], {"device_ms": 0.0,
                                                  "host_ms": 0.0,
                                                  "ranges": 0})
            part["host_ms"] += e.cpu_time_total / 1e3
            part["ranges"] += 1
        elif e.name.startswith(engine) and outermost(e):
            part = parts.setdefault("backward", {"device_ms": 0.0,
                                                 "host_ms": 0.0,
                                                 "ranges": 0})
        else:
            continue
        part["device_ms"] += dev_us(e, "") / 1e3
    kernels, busy_us = kernel_rows(torch, prof)
    return out, {"wall_ms": 1e3 * wall, "device_ms": busy_us / 1e3,
                 "device_busy_share": busy_us / 1e6 / wall, "parts": parts,
                 "other_device_ms": busy_us / 1e3 - sum(
                     p["device_ms"] for p in parts.values()),
                 "top": [{"name": k[:60], "calls": c, "ms": us / 1e3}
                         for us, c, k in kernels[:10]]}


def by_graphs(torch, fn, b, chunk=PLAIN_CHUNK):
    """``fn(graphs)`` over slices of ``chunk`` of the ``b`` graphs,
    concatenated: a plain version at the train minibatch, whose whole
    gathers would hold 40-60 GB at once."""
    return torch.cat([fn(slice(i, i + chunk)) for i in range(0, b, chunk)])


def check_train_kernels(torch, source, rep, rows, failures):
    """Phase 1's checks at the train shapes, on the train data's
    re-materialized minibatch (64 of the dataset's graphs with a random
    10% partial solution; the lists 718 slots wide, B4's and B3's
    any-width layout), at f32 and bf16, against the plain versions
    (``compare``, componentwise to the sum of |terms|; the plain versions
    taken ``PLAIN_CHUNK`` graphs at a time).  Sparse and CSR: the rep's
    layer (B3 or B5) and aggregate (B4 or B5's entry) on the whole
    minibatch, and the layer by the route the rule picks against the
    other, forced, bit for bit.  The (2, 2) mesh train step's tile (its
    M/dp = 32 rows, the second graph rank's rows N/2:): dense, B2 on the
    tile's embedding columns and adjacency rows (``check_agg_case``);
    sparse, B3 and B4 on the tile's rows of the lists and factors over the
    tuples' whole (B, K, N) embedding, as the all-gather gives it."""
    from repro_torch.core import get_rep
    from repro_torch.core.graphs import (csr_residual_edge_mask, csr_row_ids,
                                         residual_edge_mask)
    ks, kg, kc = kernel_modules()
    g, n, _ = TRAIN_DATA
    b, k = TRAIN_CFG["minibatch"], TRAIN_CFG["embed_dim"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=DEVICE)
    gi = torch.randint(0, g, (b,), generator=gen, device=DEVICE)
    sol = (rand(b, n) < 0.1).to(torch.float32)
    st = get_rep(rep).state_from_tuples(source, gi, sol)
    x, base, t4 = torch.relu(rand(b, k, n) - 0.5), rand(b, k, n) - 0.5, \
        (rand(k, k) - 0.5) * 0.2
    tile = slice(0, b // 2), slice(n // 2, None)     # (M/dp, rows N/2:)
    if rep == "dense":
        check_agg_case(torch, ks, rows, failures, "train_tile_sp2",
                       x[tile[0], :, tile[1]].contiguous(),
                       st.adj[tile].contiguous())
    elif rep == "sparse":
        edge = residual_edge_mask(st.neighbors, st.valid, sol)
        for case, gs, rs in (("train_minibatch", slice(None), slice(None)),
                             ("train_tile_sp2",) + tile):
            nbr, ed = st.neighbors[gs, rs].contiguous(), \
                edge[gs, rs].contiguous()
            xs, bs = x[gs], base[gs, :, rs].contiguous()
            xp = torch.nn.functional.pad(xs, (0, 1))
            check_graph_train_case(
                torch, rows, failures, case, ks.fused_s2v_layer_sparse,
                (t4, xs, nbr, ed, bs),
                lambda s, c: ks.fused_s2v_layer_sparse_plain(
                    t4, xs[s], nbr[s], ed[s], bs[s], c),
                lambda c: kg.sparse_mp_aggregate(xp, nbr, ed, c),
                lambda s, c: kg.sparse_mp_aggregate_plain(xp[s], nbr[s],
                                                          ed[s], c),
                nbr.shape[2], {"B": xs.shape[0], "K": k, "N": n,
                               "Nl": nbr.shape[1], "D": nbr.shape[2]},
                t4, bs, "sparse")
    else:
        rid = csr_row_ids(st.indptr, st.num_edges)
        edge = csr_residual_edge_mask(st.indices, st.edge_mask, rid, sol)
        topo = (st.indices, st.indptr, edge)
        check_graph_train_case(
            torch, rows, failures, "train_minibatch", kc.fused_s2v_layer_csr,
            (t4, x, *topo, base),
            lambda s, c: kc.fused_s2v_layer_csr_plain(
                t4, x[s], *(a[s] for a in topo), base[s], c),
            lambda c: kc.csr_aggregate(x, *topo, c),
            lambda s, c: kc.csr_aggregate_plain(x[s], st.indices[s], rid[s],
                                                edge[s], c),
            int((st.indptr[:, 1:] - st.indptr[:, :-1]).max()),
            {"B": b, "K": k, "N": n, "E": st.num_edges}, t4, base, "csr")
    if failures:
        raise AssertionError("a kernel disagrees at the train shapes:\n"
                             + "\n".join(failures))


def check_graph_train_case(torch, rows, failures, case, fn, args,
                           layer_plain, agg, agg_plain, terms, shape, t4,
                           base, rep):
    """One case of ``check_train_kernels`` on the sparse or CSR rep: the
    layer ``fn(*args, compute)`` by its route against ``layer_plain(graphs,
    compute)`` and against the other route, the aggregate ``agg(compute)``
    against ``agg_plain(graphs, compute)``, at f32 and bf16.  The input
    embedding is >= 0 and the factors 0 or 1, so the f32 aggregate is the
    sum of its terms' absolute values."""
    b = base.shape[0]
    agg_abs = by_graphs(torch, lambda s: agg_plain(s, "f32"), b)
    layer_abs = base.abs() + t4.abs() @ agg_abs
    for compute in ("f32", "bf16"):
        out, route = call_routed(fn, *args, compute)
        compare(torch, rows, failures, REP_KERNEL[rep], case, compute, out,
                by_graphs(torch, lambda s: layer_plain(s, compute), b), None,
                terms, {**shape, "route": route}, layer_abs)
        route_identity(torch, failures, REP_KERNEL[rep], case, compute, fn,
                       args, out, route)
        del out
        compare(torch, rows, failures, REP_AGGREGATE[rep], case, compute,
                agg(compute), agg_abs if compute == "f32" else
                by_graphs(torch, lambda s: agg_plain(s, compute), b), None,
                terms, shape, agg_abs)
        torch.cuda.empty_cache()


def train_mode_run(torch, agent, step, source, mode, seed, rep="dense",
                   problem="mvc", steps=TRAIN_STEPS,
                   profile_step=TRAIN_PROFILE_STEP,
                   timed_from=TRAIN_TIMED_FROM, data=TRAIN_DATA,
                   warm_hook=None):
    """(c) ``steps`` fused steps of one target mode on ``rep`` and
    ``problem`` at full width on a fresh engine (empty replay), each with
    its draws from ``draw_train_step``: the rep's layer kernel (B1, B3,
    B5) launched 1 + 2 tau times per warm fresh step and 2 + tau per warm
    stored step, on sparse and CSR the aggregate 2 tau times per warm step
    (two per backward), every warm loss finite, one warm step (and its
    draws) under ``set_sync_debug_mode("error")`` and, unless
    ``profile_step`` is None, one under torch.profiler, and the seconds of
    the steps from ``timed_from``.  ``data`` is (dataset graphs, nodes,
    episode graphs); ``warm_hook(es)``, where given, is called once after
    the first warm step, outside its counts and times.  Returns the row it
    prints, with the layer's and the aggregate's launches by route over
    the run."""
    from repro_torch.core import draw_train_step, engine_init, env, get_rep
    g, n, b = data
    r = get_rep(rep)
    es = engine_init(agent.cfg, agent.params, agent.opt, n, seed=seed,
                     step_count=agent.step_count)
    gi = torch.as_tensor(np.random.default_rng(seed).integers(0, g, b),
                         device=DEVICE)
    state = r.state_from_tuples(source, gi,
                                torch.zeros((b, n), device=DEVICE),
                                residual=env.residual_mode(problem),
                                candidate_fn=env.candidate_rule(problem))
    layer, agg = REP_KERNEL[rep], REP_AGGREGATE.get(rep)
    want = {"fresh": (1, 1 + 2 * TRAIN_TAU),
            "stored": (2, 2 + TRAIN_TAU)}[mode]
    want_agg = (0, 2 * TRAIN_TAU) if agg else (0, 0)
    losses, launches, agg_launches, seconds = [], [], [], []
    routed = read_routes()
    routes = {k: dict.fromkeys(WALKS, 0) for k in (layer, agg) if k in routed}
    profile = None
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        reset_counts()
        warm = es.replay.size + b >= agent.cfg.minibatch

        def run():
            return step(es, state, source, gi, draw_train_step(
                agent.cfg, es, state, tau=TRAIN_TAU))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == TRAIN_SYNC_STEP:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        elif i == profile_step:
            out, profile = profile_train_step(torch, run)
        else:
            out = run()
        torch.cuda.synchronize()
        if i >= timed_from:
            seconds.append(time.perf_counter() - t0)
        es, state, _, _, _, loss = out
        losses.append(loss)
        counts = read_counts()
        launches.append(counts[layer])
        agg_launches.append(counts[agg] if agg else 0)
        by_route = read_routes()
        for kernel, total in routes.items():
            for route, count in by_route[kernel].items():
                total[route] += count
        if (launches[-1], agg_launches[-1]) != (want[warm], want_agg[warm]):
            raise AssertionError(
                f"train {problem} {rep} {mode} step {i}: {layer} launched "
                f"{launches[-1]} times, not {want[warm]}; the aggregate "
                f"{agg_launches[-1]}, not {want_agg[warm]}")
        if not warm and i >= TRAIN_SYNC_STEP:
            raise AssertionError(f"train {problem} {rep} {mode} step {i} is "
                                 f"not warm")
        if warm_hook is not None and warm:
            warm_hook(es)
            warm_hook = None
    losses = [float(x) for x in losses]
    warm_losses = losses[agent.cfg.minibatch // b - 1:]
    if not all(math.isfinite(x) for x in warm_losses) or any(
            math.isfinite(x) for x in losses[:len(losses)
                                             - len(warm_losses)]):
        raise AssertionError(f"train {problem} {rep} {mode}: losses "
                             f"{losses}")
    return {"phase": "train", "problem": problem, "rep": rep, "mode": mode,
            "steps": steps,
            "warm_steps": len(warm_losses), "layer_kernel": layer,
            "layer_launches": launches, "aggregate_kernel": agg,
            "aggregate_launches": agg_launches,
            "layer_routes": routes.get(layer),
            "aggregate_routes": routes.get(agg),
            "median_warm_step_s": float(np.median(seconds)),
            "min_warm_step_s": min(seconds), "max_warm_step_s": max(seconds),
            "timed_steps": len(seconds), "warm_step_s": seconds,
            "losses": losses, "step_count": es.step_count,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "profile": profile}


def agent_episode(agent, data, rep, b, seed):
    """The user's entry point: ``train_agent`` for one episode of 9 steps
    of ``b`` graphs on ``rep``, the last two warm (minibatch 64).  Returns
    the log and the episode's launches, in all and by route."""
    from repro_torch.core import train_agent
    count0 = agent.step_count
    reset_counts()
    log = train_agent(agent, data, rep=rep, episodes=1, max_steps=9,
                      tau=TRAIN_TAU, batch_graphs=b, seed=seed)
    counts, routes = read_counts(), read_routes()
    warm = 9 - (agent.cfg.minibatch // b - 1)
    if agent.step_count != count0 + warm \
            or not math.isfinite(log.losses[-1]):
        raise AssertionError(f"train_agent on {rep} ({agent.cfg.compute}): "
                             f"step_count {agent.step_count} from {count0}, "
                             f"losses {log.losses}")
    return log, counts, routes


def phase_train(torch, policy, adjs, rows, failures):
    """The train phase: (a) the backwards on the card, (b) a small train
    run on the card against the CPU on each rep, (c) the kernels at the
    train minibatch and at the mesh train step's tile against their plain
    versions (``check_train_kernels``, into ``rows``), and the full-width
    train steps of both target modes on each rep, then ``train_agent`` for
    one short episode (f32 on dense, bf16 on sparse and CSR), (d) the dense
    trained policy saved, loaded and serving the served stream's graphs,
    every answer a cover.  Returns each kernel's launches in (c) (the
    aggregates' at f32), the aggregates' in the bf16 episodes, the median
    warm step seconds by (rep, mode) and the train dataset."""
    import dataclasses
    import tempfile
    from repro_torch.checkpoint import load_policy, save_policy
    from repro_torch.convert import policy_to_numpy
    from repro_torch.core import Agent, PolicyConfig, get_rep, get_train_step
    from repro_torch.core.graphs import random_graph_batch
    check_train_grads(torch, policy)
    for rep in TRAIN_REPS:
        check_small_train(torch, rep)

    g, n, b = TRAIN_DATA
    t0 = time.perf_counter()
    data = random_graph_batch("er", n, g, seed=SEED + 15, rho=0.15)
    gen_s = time.perf_counter() - t0
    tcfg = PolicyConfig(**TRAIN_CFG)
    main, bf16, dense_agent = dict.fromkeys(REPLACES, 0), {}, None
    fused_s = {}
    for rep in TRAIN_REPS:
        torch.cuda.empty_cache()
        agent = Agent(tcfg, num_nodes=n, device=DEVICE)
        before = {k: v.copy()
                  for k, v in policy_to_numpy(agent.params).items()}
        t0 = time.perf_counter()
        source = get_rep(rep).prepare_dataset(data, device=DEVICE)
        build_s = time.perf_counter() - t0
        check_train_kernels(torch, source, rep, rows, failures)
        for i, mode in enumerate(("fresh", "stored")):
            agent.target_mode = mode
            step = get_train_step(tcfg, rep=rep, tau=TRAIN_TAU,
                                  target_mode=mode)
            row = train_mode_run(torch, agent, step, source, mode, SEED + i,
                                 rep)
            if rep == "csr" and row["aggregate_routes"]["rows"]:
                raise AssertionError(f"train csr {mode}: the aggregate took "
                                     f"the row walk at the train cell: "
                                     f"{row['aggregate_routes']}")
            main[row["layer_kernel"]] += sum(row["layer_launches"])
            if row["aggregate_kernel"]:
                main[row["aggregate_kernel"]] += sum(
                    row["aggregate_launches"])
            agent.step_count = row["step_count"]     # the epsilon schedule
            fused_s[rep, mode] = row["median_warm_step_s"]
            emit({**row, "dataset": [g, n], "episode_graphs": b,
                  "tau": TRAIN_TAU, **TRAIN_CFG, "generate_s": gen_s,
                  "dataset_build_s": build_s})
        del source
        moved = [k for k, v in policy_to_numpy(agent.params).items()
                 if not np.array_equal(v, before[k])]
        if not moved:
            raise AssertionError(f"full-width training on {rep} moved no "
                                 f"parameter")
        # the user's entry point: one episode of 9 steps, the last two
        # warm; f32 on dense, bf16 on sparse and CSR
        compute = "f32" if rep == "dense" else "bf16"
        agent.cfg = dataclasses.replace(tcfg, compute=compute)
        log, counts, _ = agent_episode(agent, data, rep, b, SEED + 2)
        if rep != "dense":
            bf16[REP_AGGREGATE[rep]] = counts[REP_AGGREGATE[rep]]
        emit({"phase": "train_agent", "rep": rep, "compute": compute,
              "steps": len(log.losses), "losses": log.losses,
              "wall_s": log.wall_time,
              "launches": {k: v for k, v in counts.items() if v},
              "moved": moved})
        if rep == "dense":
            agent.cfg = tcfg
            dense_agent = agent

    with tempfile.TemporaryDirectory() as d:
        save_policy(d, dense_agent.step_count, dense_agent.params)
        loaded, _ = load_policy(d, tcfg, device=DEVICE)
    for key, v in loaded.state_dict().items():
        if not torch.equal(v, dense_agent.params.state_dict()[key]):
            raise AssertionError(f"the loaded policy differs at {key}")
    svc = make_service(loaded, tcfg, "dense")
    t0 = time.perf_counter()
    responses = svc.serve(adjs)
    svc.close()
    for r, a in zip(responses, adjs):
        if not is_cover(a, r.solution):
            raise AssertionError(f"trained policy: request {r.id} is not a "
                                 f"cover")
    emit({"phase": "train_then_solve", "requests": len(adjs),
          "wall_s": time.perf_counter() - t0,
          "cover_sizes": [r.size for r in responses]})
    return main, bf16, fused_s, data


# ---------------------------------------------------------------------------
# The host engines (ROADMAP A6a): the per-evaluation solve, the host
# training loop, open-loop load.
# ---------------------------------------------------------------------------

def add_counts(total: dict, counts: dict) -> None:
    for name, count in counts.items():
        total[name] = total.get(name, 0) + count


def rss_bytes() -> int:
    """This process's resident bytes (Linux ``/proc``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def host_replay_agent(cfg, n, **kw):
    """An ``Agent`` on the card whose ``__post_init__`` builds its host
    replay, and what that costs: the ring's bytes and the process's
    resident growth, which must stay under a twentieth of them (numpy's
    zeros are calloc-backed, so an untouched ring takes no pages)."""
    from repro_torch.core import Agent
    before = rss_bytes()
    agent = Agent(cfg, num_nodes=n, device=DEVICE, **kw)
    grown = rss_bytes() - before
    ring = agent.replay.nbytes()
    if grown > ring // 20:
        raise AssertionError(f"an Agent's host replay of {ring} bytes grew "
                             f"the resident set by {grown} bytes")
    return agent, {"replay_bytes": ring, "resident_growth_bytes": grown}


def phase_host_solve(torch, policy):
    """(a) The per-evaluation solve on a full bucket (8 graphs of 4000
    nodes at 4096) on each rep: ``solve(engine="host")`` equal to the
    fused solve bit for bit (solutions, evaluations, commits), every
    answer a cover, the rep's layer kernel once an evaluation; on dense a
    counting ``step_fn`` with the default engine takes the same loop, one
    call an evaluation.  Prints seconds an evaluation of both engines.
    Returns the launches."""
    from repro_torch.core import solve, solve_step
    batch = bucket_batch()
    launches = {}
    for rep in ("dense", "sparse", "csr"):
        r = bucket_rep(rep)
        layer = REP_KERNEL[rep]
        kw = dict(num_layers=2, multi_node=True, rep=r, device=DEVICE)
        calls = []
        step = solve_step(rep=r, num_layers=2, use_adaptive=True)

        def counting(p, st):
            calls.append(1)
            return step(p, st)
        runs = {}
        for name, extra in (("device", {}), ("host", {"engine": "host"}),
                            ("step_fn", {"step_fn": counting})):
            if name == "step_fn" and rep != "dense":
                continue
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve(policy, batch, **kw, **extra)
            runs[name] = (res, time.perf_counter() - t0)
            counts = read_counts()
            add_counts(launches, counts)
            if counts[layer] != res.policy_evals:
                raise AssertionError(f"{name} solve on {rep}: {layer} "
                                     f"launched {counts[layer]} times for "
                                     f"{res.policy_evals} evaluations")
        fused = runs["device"][0]
        for name, (res, _) in runs.items():
            if not (np.array_equal(res.solution, fused.solution)
                    and res.policy_evals == fused.policy_evals
                    and np.array_equal(res.nodes_committed,
                                       fused.nodes_committed)):
                raise AssertionError(f"{name} solve on {rep} differs from "
                                     f"the fused solve: {res.policy_evals} "
                                     f"vs {fused.policy_evals} evaluations")
        if calls and len(calls) != fused.policy_evals:
            raise AssertionError(f"step_fn called {len(calls)} times for "
                                 f"{fused.policy_evals} evaluations")
        for g in range(batch.shape[0]):
            if not is_cover(batch[g], fused.solution[g]):
                raise AssertionError(f"{rep} solve of graph {g}: no cover")
        emit({"phase": "host_solve", "rep": rep, "B": batch.shape[0],
              "N": batch.shape[1], "policy_evals": fused.policy_evals,
              "step_fn_calls": len(calls) or None,
              **{f"{name}_s_per_eval": t / res.policy_evals
                 for name, (res, t) in runs.items()},
              "cover_sizes": fused.sizes.tolist()})
    return launches


def host_train_run(torch, agent, data, rep, mode, seed, fused_s=None,
                   steps=HOST_STEPS, timed_from=HOST_TIMED_FROM, b=None):
    """(b) ``train_agent(engine="host")`` on ``data`` at full width for
    ``steps`` steps of one episode, the rep's layer kernel (and on sparse
    and CSR the aggregate) counted each step through ``eval_fn`` at every
    step: 1 + 2 tau and 2 tau a warm fresh step, 2 + tau and 2 tau a warm
    stored one, as the fused step; NaN losses before the replay is warm,
    finite after; ``step_count`` advanced by the warm steps; the seconds
    of the steps from ``timed_from`` and the synchronizing calls on this
    thread a warm step (``main_thread_syncs``, with their lines), beside
    the fused step's seconds ``fused_s``.  Returns the launches, and those
    of the layer and the aggregate by route."""
    from repro_torch.core import train_agent
    b = TRAIN_DATA[2] if b is None else b
    layer, agg = REP_KERNEL[rep], REP_AGGREGATE.get(rep)
    routes = {k: dict.fromkeys(WALKS, 0) for k in (layer, agg)
              if k in read_routes()}
    agent.target_mode = mode
    count0, marks = agent.step_count, []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with main_thread_syncs(torch) as syncs:
        torch.cuda.synchronize()
        counted = len(syncs())       # whether synchronize() itself counts

        def mark(_agent):
            where = syncs(where=True)
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), read_counts(), where))
            for kernel, by_route in read_routes().items():
                if kernel in routes:
                    for route, count in by_route.items():
                        routes[kernel][route] += count
            reset_counts()
            return 0.0
        reset_counts()
        log = train_agent(agent, data, rep=rep, episodes=1, max_steps=steps,
                          tau=TRAIN_TAU, batch_graphs=b, seed=seed,
                          engine="host", eval_every=1, eval_fn=mark)
        before = len(syncs())
        float(torch.ones(1, device=DEVICE).sum())      # the control read
        control = len(syncs()) - before
    if control != 1:
        raise AssertionError(f"the control read was counted {control} times")
    warm_from = agent.cfg.minibatch // b - 1
    want = {"fresh": (1, 1 + 2 * TRAIN_TAU),
            "stored": (2, 2 + TRAIN_TAU)}[mode]
    want_agg = (0, 2 * TRAIN_TAU) if agg else (0, 0)
    launches = {layer: 0}
    if agg:
        launches[agg] = 0
    for i, (_, counts, _) in enumerate(marks):
        warm = i >= warm_from
        add_counts(launches, {k: counts[k] for k in launches})
        got = (counts[layer], counts[agg] if agg else 0)
        if got != (want[warm], want_agg[warm]):
            raise AssertionError(
                f"host loop {rep} {mode} step {i}: {layer} and the "
                f"aggregate launched {got}, not {(want[warm], want_agg[warm])}")
    losses = log.losses
    if len(losses) != steps or not all(
            math.isfinite(x) == (i >= warm_from) for i, x in
            enumerate(losses)):
        raise AssertionError(f"host loop {rep} {mode}: losses {losses}")
    if agent.step_count - count0 != steps - warm_from:
        raise AssertionError(f"host loop {rep} {mode}: step_count "
                             f"{agent.step_count} from {count0}")
    seconds = [marks[i][0] - marks[i - 1][0]
               for i in range(max(timed_from, 1), steps)]
    reads = [len(marks[i][2]) - len(marks[i - 1][2]) - counted
             for i in range(warm_from + 1, steps)]
    last = marks[-1][2][len(marks[-2][2]):]
    emit({"phase": "host_train", "rep": rep, "mode": mode, "steps": steps,
          "warm_steps": steps - warm_from, "episode_graphs": b,
          "tau": TRAIN_TAU, "layer_kernel": layer,
          "aggregate_kernel": agg, "launches": launches, "routes": routes,
          "median_warm_step_s": float(np.median(seconds)) if seconds
          else None, "warm_step_s": seconds,
          "fused_median_warm_step_s": fused_s,
          "syncs_per_warm_step": reads,
          "syncs_by_line_last_step": {k: last.count(k) for k in
                                      sorted(set(last))},
          "synchronize_counted": counted, "losses": losses,
          "step_count": agent.step_count,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    return launches, routes


class ReplayedIndices:
    """Stands in for ``Agent._rng`` where the host loop must draw the
    fused step's replay indices: ``integers`` hands them out in order."""

    def __init__(self, batches):
        self.batches = list(batches)

    def integers(self, low, high, size):
        idx = self.batches.pop(0)
        if idx.shape != (size,) or int(idx.max()) >= high:
            raise AssertionError(f"replayed indices {idx} for {size} "
                                 f"below {high}")
        return idx


def host_small_run(torch, arrays, adj, device, rep):
    """``train_agent(engine="host")`` at SMALL_TRAIN's shape on
    ``device`` from the weights ``arrays``, fresh targets at epsilon
    ``HOST_EPS`` (the agent's numpy draws explore).  Returns (losses,
    replay, trained weights)."""
    from repro_torch.convert import policy_from_numpy, policy_to_numpy
    from repro_torch.core import Agent, PolicyConfig, train_agent
    n, _, b, mb, tau, steps = SMALL_TRAIN
    cfg = PolicyConfig(embed_dim=8, num_layers=2, minibatch=mb,
                       replay_capacity=64, learning_rate=1e-3,
                       eps_start=HOST_EPS, eps_end=HOST_EPS)
    agent = Agent(cfg, num_nodes=n, device=device,
                  params=policy_from_numpy(arrays, device=device))
    log = train_agent(agent, adj, rep=rep, episodes=2, max_steps=steps,
                      tau=tau, batch_graphs=b, seed=SEED, engine="host")
    return np.array(log.losses), agent.replay, policy_to_numpy(agent.params)


def host_fed_fused(torch, arrays, adj, rep):
    """tests/test_engine.py:129's check on the card: the fused step
    (stored targets, epsilon 0, draws from ``draw_train_step``) and the
    host loop fed its replay indices (``ReplayedIndices``) from the same
    weights.  Returns both loss traces and both policies' weights."""
    from repro_torch.convert import policy_from_numpy, policy_to_numpy
    from repro_torch.core import (Agent, PolicyConfig, draw_train_step,
                                  engine_init, env, get_rep, get_train_step)
    n, _, b, mb, tau, steps = SMALL_TRAIN
    cfg = PolicyConfig(embed_dim=8, num_layers=2, minibatch=mb,
                       replay_capacity=64, learning_rate=1e-3,
                       eps_start=0.0, eps_end=0.0)
    r = get_rep(rep)
    source = r.prepare_dataset(adj, device=DEVICE)
    gi = np.array([0, 2])
    zero = np.zeros((b, n), np.float32)
    residual = env.residual_mode("mvc")
    agents = [Agent(cfg, num_nodes=n, target_mode="stored", device=DEVICE,
                    params=policy_from_numpy(arrays, device=DEVICE))
              for _ in range(2)]
    fused = get_train_step(cfg, rep=r, tau=tau, target_mode="stored")
    es = engine_init(cfg, agents[0].params, agents[0].opt, n, seed=SEED)
    state = r.state_from_tuples(source, gi, zero, residual=residual)
    fused_losses, indices = [], []
    for _ in range(steps):
        draws = draw_train_step(cfg, es, state, tau=tau)
        indices += list(draws.sample_idx.cpu().numpy())
        es, state, _, _, _, loss = fused(es, state, source,
                                         torch.as_tensor(gi, device=DEVICE),
                                         draws)
        fused_losses.append(float(loss))
    agent = agents[1]
    agent._rng = ReplayedIndices(indices)
    state = r.state_from_tuples(source, gi, zero, residual=residual)
    host_losses = []
    for _ in range(steps):
        a = agent.act(state, explore=False)
        new, rew, done = env.make("mvc")(state,
                                         torch.as_tensor(a, device=DEVICE))
        agent.remember(gi, state, a, rew, new, done)
        host_losses.append(agent.train(source, tau=tau, residual=residual))
        state = new
    if agent._rng.batches or es.step_count != agent.step_count:
        raise AssertionError(f"host loop fed the fused indices on {rep}: "
                             f"{len(agent._rng.batches)} batches unused, "
                             f"step counts {es.step_count}, "
                             f"{agent.step_count}")
    return (np.array(fused_losses), np.array(host_losses),
            policy_to_numpy(es.params), policy_to_numpy(agent.params))


def check_host_small(torch, rep):
    """(c) At SMALL_TRAIN's shape on ``rep``: the host loop on the card
    against the port's on the CPU (the same replay, so the same actions;
    losses within 1e-6 relative, parameters within rtol 1e-5 / atol
    1e-6), and the host loop fed the fused step's indices against the
    fused step on the card (losses and parameters within rtol 1e-5 /
    atol 1e-6)."""
    from repro_torch.convert import policy_to_numpy
    from repro_torch.core import PolicyConfig, init_policy, random_graph_batch
    n, g = SMALL_TRAIN[:2]
    adj = random_graph_batch("er", n, g, seed=SEED, rho=0.3)
    arrays = policy_to_numpy(init_policy(
        PolicyConfig(embed_dim=8), generator=torch.Generator().manual_seed(
            SEED + 14), device="cpu"))
    card = host_small_run(torch, arrays, adj, DEVICE, rep)
    cpu = host_small_run(torch, arrays, adj, "cpu", rep)
    what = f"small host run on {rep}"
    if (card[1].size, card[1]._ptr) != (cpu[1].size, cpu[1]._ptr):
        raise AssertionError(f"{what}: replay sizes differ")
    for f in ("graph_idx", "solution", "action", "reward", "next_solution",
              "done"):
        if not np.array_equal(getattr(card[1], f), getattr(cpu[1], f)):
            raise AssertionError(f"{what}: the replay's {f} parts from the "
                                 f"CPU's")
    warm = np.isfinite(cpu[0])
    if not np.array_equal(np.isfinite(card[0]), warm) or warm.sum() < 4:
        raise AssertionError(f"{what}: warm steps differ: {card[0]} vs "
                             f"{cpu[0]}")
    np.testing.assert_allclose(card[0][warm], cpu[0][warm], rtol=1e-6,
                               atol=1e-6)
    for key in POLICY_KEYS:
        np.testing.assert_allclose(card[2][key], cpu[2][key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    fl, hl, fw, hw = host_fed_fused(torch, arrays, adj, rep)
    fwarm = np.isfinite(fl)
    if not np.array_equal(np.isfinite(hl), fwarm) or fwarm.sum() < 4:
        raise AssertionError(f"host fed the fused indices on {rep}: warm "
                             f"steps differ: {hl} vs {fl}")
    np.testing.assert_allclose(hl[fwarm], fl[fwarm], rtol=1e-5, atol=1e-6)
    for key in POLICY_KEYS:
        np.testing.assert_allclose(hw[key], fw[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    emit({"phase": "host_train_small", "rep": rep, "n": n,
          "replay_tuples": int(card[1].size), "warm_steps": int(warm.sum()),
          "card_vs_cpu_loss_max_rel_err": float(np.max(
              np.abs(card[0][warm] - cpu[0][warm]) / np.abs(cpu[0][warm]))),
          "card_vs_cpu_param_max_abs_err": max(
              float(np.abs(card[2][k] - cpu[2][k]).max())
              for k in POLICY_KEYS),
          "host_vs_fused_loss_max_rel_err": float(np.max(
              np.abs(hl[fwarm] - fl[fwarm]) / np.abs(fl[fwarm]))),
          "host_vs_fused_param_max_abs_err": max(
              float(np.abs(hw[k] - fw[k]).max()) for k in POLICY_KEYS)})


def recording(svc) -> dict:
    """``svc``'s dispatched responses by request id, as they are made (the
    load generator returns only its report)."""
    seen = {}
    dispatch = svc._dispatch

    def record(plan):
        responses = dispatch(plan)
        seen.update((r.id, r) for r in responses)
        return responses
    svc._dispatch = record
    return seen


def phase_open_loop(torch, policy, cfg, dense_row):
    """(d) Open-loop load on one warmed dense service: ``make_workload`` of
    ``OPEN_LOOP_REQUESTS`` graphs of the served sizes (ER 0.15), a
    deadline twice phase 2's dense p99, at ``OPEN_LOOP_RATES`` times its
    requests/s (one seed: the same graphs at both rates), through
    ``run_open_loop`` in sync and async mode.  The service answers
    ``serve()`` first, then every run: each run starts on an empty queue
    with the async scheduler closed, and no run may add a first dispatch
    on the request path.  Every request accounted for, the layer kernel
    once an evaluation, every answer a cover and equal to ``serve()``'s
    for that graph.  Prints each ``LoadReport``.  Returns the launches."""
    from repro_torch.serving import make_workload, run_open_loop
    rate, deadline = dense_row["requests_per_s"], 2 * dense_row["p99_ms"]
    launches, want, base = {}, None, None
    svc = make_service(policy, cfg, "dense")
    svc.warmup(list(SERVE_SIZES))
    seen = recording(svc)
    for factor in OPEN_LOOP_RATES:
        t0 = time.perf_counter()
        wl = make_workload(factor * rate, OPEN_LOOP_REQUESTS, SERVE_SIZES,
                           rho=0.15, deadline_ms=deadline, seed=SEED)
        gen_s = time.perf_counter() - t0
        if base is None:
            base = wl
            want = svc.serve(list(wl.adjs))
            for r, a in zip(want, wl.adjs):
                if not is_cover(a, r.solution):
                    raise AssertionError(f"open loop: serve() answer {r.id} "
                                         f"is not a cover")
        elif not all(np.array_equal(a, b)
                     for a, b in zip(wl.adjs, base.adjs)):
            raise AssertionError("open loop: one seed gave other graphs at "
                                 "another rate")
        for mode in ("sync", "async"):
            what = f"open loop {mode} at {factor} x {rate:.2f} rps"
            if svc.pending() or svc.running:
                raise AssertionError(f"{what}: the service is not idle")
            first, before = svc._next_id, svc.stats.as_dict()
            seen.clear()
            reset_counts()
            report = run_open_loop(svc, wl, mode=mode)
            svc.close()
            counts = read_counts()
            add_counts(launches, counts)
            if report.completed + report.rejected != report.submitted \
                    or report.submitted != len(wl):
                raise AssertionError(f"{what}: {report}")
            if svc.stats.compiles:
                raise AssertionError(f"{what}: {svc.stats.compiles} first "
                                     f"dispatches on the request path")
            if sorted(seen) != list(range(first, first + report.completed)) \
                    or report.rejected:
                raise AssertionError(f"{what}: answered ids {sorted(seen)} "
                                     f"from {first}, {report.rejected} "
                                     f"rejected")
            for i, r in seen.items():
                if not (np.array_equal(r.solution, want[i - first].solution)
                        and is_cover(wl.adjs[i - first], r.solution)):
                    raise AssertionError(f"{what}: answer {i - first} "
                                         f"differs from serve()'s")
            evals = sum({(r.bucket, r.dispatch_t): r.policy_evals
                         for r in seen.values()}.values())
            if counts["fused_s2v_layer"] != evals:
                raise AssertionError(f"{what}: {counts['fused_s2v_layer']} "
                                     f"layer launches for {evals} "
                                     f"evaluations")
            emit({"phase": "open_loop", "rate_factor": factor,
                  "phase2_dense_requests_per_s": rate,
                  **{k: svc.stats.as_dict()[k] - before[k]
                     for k in ("batches", "partial_batches")},
                  "policy_evals": evals, "generate_s": gen_s,
                  **report.as_dict()})
    return launches


def launcher_rate():
    """(e) The launcher's ``--rate`` in a process of its own on the card:
    it must exit 0 and print the load report line."""
    cmd = [sys.executable, "-m", "repro_torch.launch.solve_serve",
           *LAUNCHER_RATE]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    lines = [ln for ln in out.stdout.splitlines() if "rps offered" in ln]
    if out.returncode != 0 or not lines \
            or not lines[0].startswith("async @ 50.0 rps offered: "):
        raise AssertionError(f"the launcher's --rate: rc {out.returncode}, "
                             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    emit({"phase": "launcher_rate", "args": list(LAUNCHER_RATE),
          "line": lines[0], "seconds": time.perf_counter() - t0})


def phase_host_engines(torch, policy, cfg, data, fused_s, dense_row):
    """The host engines (ROADMAP A6a): (a) ``phase_host_solve``; (b) the
    host training loop at phase 3b's cell (``host_train_run``): fresh on
    each rep and stored on dense, on the train phase's dataset, each agent
    with its host replay (``host_replay_agent``); (c) the small checks
    (``check_host_small``); (d) ``phase_open_loop``; (e)
    ``launcher_rate``.  Returns the launches of (a), (b) and (d)."""
    from repro_torch.core import PolicyConfig
    launches = phase_host_solve(torch, policy)
    tcfg = PolicyConfig(**TRAIN_CFG)
    for rep, mode, seed in (("dense", "fresh", SEED + 6),
                            ("dense", "stored", SEED + 7),
                            ("sparse", "fresh", SEED + 6),
                            ("csr", "fresh", SEED + 6)):
        agent, memory = host_replay_agent(tcfg, data.shape[-1])
        emit({"phase": "host_replay", "rep": rep, "mode": mode,
              "capacity": tcfg.replay_capacity, "N": data.shape[-1],
              **memory})
        run, routes = host_train_run(torch, agent, data, rep, mode, seed,
                                     fused_s.get((rep, mode)))
        add_counts(launches, run)
        if rep == "csr" and routes["csr_aggregate"]["rows"]:
            raise AssertionError(f"host loop csr {mode}: the aggregate took "
                                 f"the row walk at the train cell: {routes}")
        del agent
    for rep in TRAIN_REPS:
        check_host_small(torch, rep)
    add_counts(launches, phase_open_loop(torch, policy, cfg, dense_row))
    launcher_rate()
    return launches


def sampled_host_run(torch, source):
    """The host loop on the sampled dataset (phase sampled_host_train):
    ``train_agent(engine="host")`` for one 9-step episode of 8 of the 64
    BA(1M) subgraphs at TRAIN_CFG (its host replay of 50,000 tuples at
    N = 20,992 built by the agent, ``host_replay_agent``), ``tau`` 4,
    fresh: B5 9 and its aggregate 8 launches a warm step, every one by the
    row walk, finite warm losses.  Returns the launches."""
    from repro_torch.core import PolicyConfig
    cfg = PolicyConfig(**TRAIN_CFG)
    torch.cuda.empty_cache()
    agent, memory = host_replay_agent(cfg, source.num_nodes)
    emit({"phase": "host_replay", "rep": "csr", "mode": "fresh",
          "capacity": cfg.replay_capacity, "N": source.num_nodes, **memory})
    launches, routes = host_train_run(torch, agent, source, "csr", "fresh",
                                      SEED + 8, steps=9, timed_from=8)
    for k in launches:
        if routes[k]["windows"] or not routes[k]["rows"]:
            raise AssertionError(f"sampled host loop: {k} took the windowed "
                                 f"walk: {routes[k]}")
    return launches


# ---------------------------------------------------------------------------
# The problems phase: MaxCut, MIS and MDS on one device.
# ---------------------------------------------------------------------------

def problem_graphs(adjs):
    """The phase's served graphs: the first ``PROBLEM_GRAPHS`` of each
    served size, in stream order."""
    picked, seen = [], {}
    for a in adjs:
        seen[a.shape[0]] = seen.get(a.shape[0], 0) + 1
        if seen[a.shape[0]] <= PROBLEM_GRAPHS:
            picked.append(a)
    return picked


def baseline_objectives(adjs) -> dict:
    """Per problem, the mean objective of ``solvers.heuristic_batch`` over
    ``adjs`` (|S| for MIS and MDS, the cut for MaxCut); host numpy, run on
    a thread beside the card's phases."""
    from repro_torch.core import solvers
    out = {}
    for problem in PROBLEMS:
        values = []
        for a in adjs:
            sol = solvers.heuristic_batch(problem, a[None])[0]
            if not CHECKS[problem](a, sol) and problem != "maxcut":
                raise AssertionError(f"the {problem} baseline is infeasible")
            values.append(cut_size(a, sol) if problem == "maxcut"
                          else float(sol.sum()))
        out[problem] = float(np.mean(values))
    return out


def full_bucket_batch(adjs):
    """One dispatch's batch of the full bucket, as the service builds it:
    the phase's 4000-node graphs padded to 4096, in rows of ``BUCKET[0]``."""
    from repro_torch.serving import pad_adjacency
    rows, nb, real = BUCKET
    batch = np.zeros((rows, nb, nb), np.float32)
    for i, a in enumerate([a for a in adjs if a.shape[0] == real]):
        batch[i] = pad_adjacency(a, nb)
    return batch


def problem_serve(torch, policy, cfg, adjs, problem, rep):
    """(a) The served graphs through a warmed service on ``rep``: every
    answer passes the numpy checker, the rep's layer kernel ran once per
    evaluation, no first dispatch on the request path.  Returns (the
    responses, the kernel launches, the row it prints)."""
    svc = make_service(policy, cfg, rep)
    warm = svc.warmup(list(SERVE_SIZES), problems=[problem])
    reset_counts()
    t0 = time.perf_counter()
    responses = svc.serve(adjs, problem=problem)
    wall = time.perf_counter() - t0
    counts = read_counts()
    svc.close()
    what = f"{problem} on {rep}"
    for r, a in zip(responses, adjs):
        if not CHECKS[problem](a, r.solution):
            raise AssertionError(f"{what}: request {r.id} fails the "
                                 f"{problem} checker")
    if svc.stats.compiles != 0:
        raise AssertionError(f"{what}: {svc.stats.compiles} first "
                             f"dispatches on the request path after warmup")
    batches = {(r.bucket, r.dispatch_t): (r.policy_evals,
                                          r.complete_t - r.dispatch_t)
               for r in responses}
    evals = sum(e for e, _ in batches.values())
    launches = counts[REP_KERNEL[rep]]
    if launches != evals:
        raise AssertionError(f"{what}: kernel launches {launches} != policy "
                             f"evals {evals} on the served path")
    full = [(e, sec) for (nb, _), (e, sec) in batches.items()
            if nb == BUCKET[1]]
    row = {"phase": "problems_serve", "problem": problem, "rep": rep,
           "requests": len(adjs), "wall_s": wall, "policy_evals": evals,
           "kernel_launches": launches, "batches": len(batches),
           "solve_s": svc.stats.solve_seconds,
           "s_per_eval": svc.stats.solve_seconds / evals,
           "full_bucket_evals": [e for e, _ in full],
           "full_bucket_dispatch_s": [sec for _, sec in full],
           "warmup_s": warm["seconds"],
           "sizes": [r.size for r in responses]}
    return responses, counts, row


def full_bucket_evals(torch, policy, problem, rep, batch, timed=3):
    """The solve's evaluations on one dispatch's batch of the full bucket:
    the first one's selection, prune and commit under
    ``set_sync_debug_mode("error")`` (the MIS prune's argmaxes and the MDS
    candidates read nothing back), then ``timed`` more as the solve loop
    runs them (each with its one read of ``done``).  Returns the seconds
    of the state build (host conversion and copy, as a dispatch does) and
    of one timed evaluation."""
    from repro_torch.core.inference import apply_selection, init_solve_state
    r = bucket_rep(rep)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_solve_state(r, batch, problem, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with torch.no_grad():
        scores = r.scores(policy, state, num_layers=2)
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, _, _ = apply_selection(state, scores, state.candidate,
                                          True, problem)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            scores = r.scores(policy, state, num_layers=2)
            state, done, _ = apply_selection(state, scores, state.candidate,
                                             True, problem)
            bool(done.all())
    return build_s, (time.perf_counter() - t0) / timed


def phase_problems(torch, policy, cfg, adjs, baselines):
    """Phase 3c: MaxCut, MIS and MDS on one device, on each rep.  (a) the
    served graphs (``problem_serve``), the three reps' answers equal bit
    for bit, one evaluation's selection, prune and commit at the full
    bucket with no host read and the next three timed
    (``full_bucket_evals``), phase 3 for the
    problem (``phase_card_vs_cpu``: first-evaluation scores within 1e-5 of
    the CPU and bit equal across reps, checked solves), seconds per
    evaluation, and the mean objective beside the baselines' (MaxCut:
    ``best_trajectory_cut`` on the dense rep); (b) the small train run on
    the card against the CPU; (c) the full-width train runs
    (``train_mode_run``, fresh, no profiled step).  Returns the kernel
    launches of the served and full-width runs."""
    from repro_torch.core import Agent, PolicyConfig, get_rep, get_train_step
    from repro_torch.core.graphs import random_graph_batch
    from repro_torch.core.inference import best_trajectory_cut
    launches = dict.fromkeys(REPLACES, 0)
    batch = full_bucket_batch(adjs)
    for problem in PROBLEMS:
        answers = {}
        for rep in TRAIN_REPS:
            responses, counts, row = problem_serve(torch, policy, cfg, adjs,
                                                   problem, rep)
            answers[rep] = responses
            launches[REP_KERNEL[rep]] += counts[REP_KERNEL[rep]]
            row["full_bucket_state_build_s"], row[
                "full_bucket_s_per_eval"] = full_bucket_evals(
                    torch, policy, problem, rep, batch)
            emit(row)
        for rep in ("sparse", "csr"):
            for r, d in zip(answers[rep], answers["dense"]):
                if not np.array_equal(r.solution, d.solution):
                    raise AssertionError(f"{problem}: the {rep} answer to "
                                         f"request {r.id} differs from the "
                                         f"dense one")
        phase_card_vs_cpu(torch, policy, problem)
        t0 = time.perf_counter()
        if problem == "maxcut":
            padded = np.zeros((len(adjs), BUCKET[1], BUCKET[1]), np.float32)
            for i, a in enumerate(adjs):
                padded[i, :a.shape[0], :a.shape[0]] = a
            objective = float(best_trajectory_cut(
                policy, padded, num_layers=2, device=DEVICE).mean())
        else:
            objective = float(np.mean([r.size for r in answers["dense"]]))
        emit({"phase": "problems_quality", "problem": problem,
              "answers_equal_across_reps": True,
              "mean_objective": objective,
              "objective": ("best trajectory cut" if problem == "maxcut"
                            else "|S|"),
              "baseline_mean_objective": baselines[problem],
              "seconds": time.perf_counter() - t0})
    for problem in PROBLEMS:
        for rep in TRAIN_REPS:
            check_small_train(torch, rep, problem, PROBLEM_SMALL,
                              PROBLEM_SMALL_IDS)
    g, n, b = TRAIN_DATA
    data = random_graph_batch("er", n, g, seed=SEED + 15, rho=0.15)
    tcfg = PolicyConfig(**TRAIN_CFG)
    for rep in TRAIN_REPS:
        torch.cuda.empty_cache()
        source = get_rep(rep).prepare_dataset(data, device=DEVICE)
        for i, problem in enumerate(PROBLEMS):
            step = get_train_step(tcfg, rep=rep, problem=problem,
                                  tau=TRAIN_TAU, target_mode="fresh")
            row = train_mode_run(
                torch, Agent(tcfg, num_nodes=n, device=DEVICE), step, source,
                "fresh", SEED + 30 + i, rep, problem, steps=PROBLEM_STEPS,
                profile_step=None, timed_from=PROBLEM_TIMED_FROM)
            launches[row["layer_kernel"]] += sum(row["layer_launches"])
            if row["aggregate_kernel"]:
                launches[row["aggregate_kernel"]] += sum(
                    row["aggregate_launches"])
            del row["profile"]
            emit({**row, "phase": "problems_train", "dataset": [g, n],
                  "episode_graphs": b, "tau": TRAIN_TAU, **TRAIN_CFG})
        del source
    return launches


def alloc_site(frames, depth=3):
    """Where an allocation was made: the innermost ``depth`` frames of its
    Python stack that lie in ``repro_torch``, innermost first."""
    out = []
    for f in frames:
        path = f["filename"].replace(os.sep, "/")
        if "/repro_torch/" in path:
            out.append(f"{path.split('/repro_torch/')[-1]}:{f['line']} "
                       f"{f['name']}")
            if len(out) == depth:
                break
    return " < ".join(out) or "outside repro_torch"


def trace_peak(trace, base, top=8):
    """The peak of the allocated bytes over an allocator trace that began
    with ``base`` bytes allocated (each ``alloc`` adds its size, each
    ``free_requested`` takes it away, as ``memory_allocated`` counts), the
    site of the allocation that reached it, and the bytes alive at the
    peak: the ``top`` sites by bytes, and those allocated before the
    trace began."""
    def replay(stop):
        live, now, best = {}, base, (base, -1)
        for i, e in enumerate(trace[:stop]):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                now += e["size"]
                if now > best[0]:
                    best = (now, i)
            elif e["action"] == "free_requested":
                now -= e["size"]
                live.pop(e["addr"], None)
        return live, best
    _, (peak, at) = replay(len(trace))
    live, _ = replay(at + 1)
    sites = {}
    for e in live.values():
        site = sites.setdefault(alloc_site(e.get("frames", [])),
                                {"bytes": 0, "blocks": 0})
        site["bytes"] += e["size"]
        site["blocks"] += 1
    return {"allocated_before": base, "peak_bytes": peak,
            "reached_by": (alloc_site(trace[at].get("frames", []))
                           if at >= 0 else "before the trace"),
            "alive_from_before": peak - sum(e["size"] for e in live.values()),
            "alive_at_peak": [{"site": k, **v} for k, v in sorted(
                sites.items(), key=lambda kv: -kv[1]["bytes"])[:top]]}


def memory_peak(torch, fn):
    """``fn()`` under the CUDA allocator's history, with each allocation's
    Python stack: where its peak of allocated bytes comes from
    (``trace_peak``)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(context="alloc", stacks="python",
                                             max_entries=1 << 20)
    try:
        fn()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][
            torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    return trace_peak(trace, base)


def paper_train_run(torch, source, mb):
    """One paper-scale CSR training run at minibatch ``mb``: the fused
    fresh-mode step on ``PAPER_EPISODE`` episode copies of the dataset's
    one graph, stepped until the replay is warm, then
    ``PAPER_WARM_STEPS`` warm steps, one more under torch.profiler and one
    more under the allocator's history (``memory_peak``).  Returns every
    step's seconds, peak device bytes and launches, the profile and where
    the peak comes from."""
    from repro_torch.core import (CSR, Agent, PolicyConfig, draw_train_step,
                                  engine_init, get_train_step)
    n = source.num_nodes
    b = PAPER_EPISODE
    cfg = PolicyConfig(**{**TRAIN_CFG, "minibatch": mb,
                          "replay_capacity": PAPER_REPLAY})
    agent = Agent(cfg, num_nodes=n, device=DEVICE)
    step = get_train_step(cfg, rep=CSR, tau=TRAIN_TAU, target_mode="fresh")
    es = engine_init(cfg, agent.params, agent.opt, n, seed=SEED)
    gi = torch.zeros((b,), dtype=torch.long, device=DEVICE)
    state = CSR.state_from_tuples(source, gi, torch.zeros((b, n),
                                                          device=DEVICE))
    steps = []
    cold = -(-mb // b) - 1
    for i in range(cold + PAPER_WARM_STEPS):
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        es, state, _, _, _, loss = step(es, state, source, gi,
                                        draw_train_step(cfg, es, state,
                                                        tau=TRAIN_TAU))
        torch.cuda.synchronize()
        counts = read_counts()
        steps.append({"warm": i >= cold,
                      "seconds": time.perf_counter() - t0,
                      "loss": float(loss),
                      "peak_device_bytes": torch.cuda.max_memory_allocated(),
                      "fused_s2v_layer_csr": counts["fused_s2v_layer_csr"],
                      "csr_aggregate": counts["csr_aggregate"],
                      "csr_aggregate_routes": read_routes()["csr_aggregate"]})

    def one_more():
        return step(es, state, source, gi, draw_train_step(cfg, es, state,
                                                           tau=TRAIN_TAU))
    _, profile = profile_train_step(torch, one_more)
    return steps, profile, memory_peak(torch, one_more)


def check_paper_minibatch(torch, source, mb, rows, failures):
    """B5 and its aggregate entry at the paper-scale step's minibatch: one
    launch each on ``mb`` copies of the graph with the residual factors
    of a random 10% partial solution per copy (slot offsets past 2^31 in
    the last ones), the last graph's output against the plain version of
    that graph alone, at f32 (``compare``, componentwise to the sum of
    |terms|)."""
    from repro_torch.core import CSR
    from repro_torch.core.graphs import csr_residual_edge_mask, csr_row_ids
    _, _, kc = kernel_modules()
    n, k = source.num_nodes, TRAIN_CFG["embed_dim"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=DEVICE)
    sol = (rand(mb, n) < 0.1).to(torch.float32)
    st = CSR.state_from_tuples(source, torch.zeros((mb,), dtype=torch.long,
                                                   device=DEVICE), sol)
    rid = csr_row_ids(st.indptr, st.num_edges)
    edge = csr_residual_edge_mask(st.indices, st.edge_mask, rid, sol)
    del rid
    x, base, t4 = torch.relu(rand(mb, k, n) - 0.5), rand(mb, k, n) - 0.5, \
        (rand(k, k) - 0.5) * 0.2
    topo = (st.indices, st.indptr, edge)
    out = kc.fused_s2v_layer_csr(t4, x, *topo, base)[-1:].clone()
    agg = kc.csr_aggregate(x, *topo)[-1:].clone()
    last = [a[-1:].clone() for a in (x, st.indices, st.indptr, edge, base)]
    del st, edge, topo
    torch.cuda.empty_cache()
    x1, indices, indptr, edge, base1 = last
    want = kc.csr_aggregate_plain(x1, indices, csr_row_ids(
        indptr, indices.shape[1]), edge)
    shape = {"B": mb, "K": k, "N": n, "E": indices.shape[1],
             "graph": mb - 1}
    terms = int((indptr[:, 1:] - indptr[:, :-1]).max())
    compare(torch, rows, failures, "csr_aggregate", "paper_minibatch",
            "f32", agg, want, None, terms, shape, want)
    compare(torch, rows, failures, "fused_s2v_layer_csr", "paper_minibatch",
            "f32", out, kc.fused_s2v_layer_csr_plain(t4, x1, indices,
                                                     indptr, edge, base1),
            None, terms, shape, base1.abs() + t4.abs() @ want)
    if failures:
        raise AssertionError("a kernel disagrees at the paper-scale "
                             "minibatch:\n" + "\n".join(failures))


def phase_paper_train(torch, graph, rows, failures):
    """Phase 4b: the paper-scale CSR train step.  The dataset is phase
    4's ER(20480, 0.15) graph (~62.9M directed edges, its CSR batch on the
    card), 8 episode copies of it a step, minibatch 64, tau 4, fresh
    targets, the replay cut to ``PAPER_REPLAY`` tuples; the first warm
    step and one more are timed, a third runs under torch.profiler and a
    fourth under the allocator's history (where the peak comes from).
    If minibatch 64 does not fit on the card, the largest of
    ``PAPER_MINIBATCHES`` that does is run, and the cut is printed.  Then
    B5 and its aggregate at that minibatch against their plain versions
    (``check_paper_minibatch``, into ``rows``)."""
    from repro_torch.core import CSR
    t0 = time.perf_counter()
    source = CSR.prepare_dataset(graph, device=DEVICE)
    build_s = time.perf_counter() - t0
    n, e = source.num_nodes, source.num_edges
    for mb in PAPER_MINIBATCHES:
        torch.cuda.empty_cache()
        try:
            steps, profile, peak = paper_train_run(torch, source, mb)
            break
        except torch.cuda.OutOfMemoryError as err:
            emit({"phase": "paper_train_cut", "minibatch": mb,
                  "out_of_memory": str(err).splitlines()[0][:300]})
    else:
        raise AssertionError(f"no minibatch of {PAPER_MINIBATCHES} fits")
    warm = [s for s in steps if s["warm"]]
    want = (1 + 2 * TRAIN_TAU, 2 * TRAIN_TAU)
    if profile is not None:
        emit({"phase": "paper_train_profile", "minibatch": mb, **profile})
    for s in warm:
        if (s["fused_s2v_layer_csr"], s["csr_aggregate"]) != want \
                or s["csr_aggregate_routes"]["rows"] \
                or not math.isfinite(s["loss"]):
            raise AssertionError(f"paper-scale train step: {s}")
    emit({"phase": "paper_train", "rep": "csr", "N": n, "directed_edges":
          int(source.indptr[0, -1]), "edge_slots": e,
          "episode_graphs": PAPER_EPISODE, "minibatch": mb,
          "minibatch_cut": mb != PAPER_MINIBATCHES[0], "tau": TRAIN_TAU,
          "target_mode": "fresh", "replay_capacity": PAPER_REPLAY,
          "replay_capacity_cut_from": TRAIN_CFG["replay_capacity"],
          "dataset_build_s": build_s,
          "first_warm_step_s": warm[0]["seconds"],
          "next_warm_step_s": [s["seconds"] for s in warm[1:]],
          "cold_steps": len(steps) - len(warm),
          "cold_step_s": [s["seconds"] for s in steps if not s["warm"]],
          "peak_device_bytes": max(s["peak_device_bytes"] for s in warm),
          "peak": peak,
          # the minibatch state's arrays and the scores' transients, from
          # the shapes
          "reckoned_bytes": {"indices": 4 * mb * e, "edge_mask": mb * e,
                             "row_ids": 4 * mb * e, "factors": 4 * mb * e},
          "launches_per_warm_step": {
              "fused_s2v_layer_csr": warm[0]["fused_s2v_layer_csr"],
              "csr_aggregate": warm[0]["csr_aggregate"]},
          "csr_aggregate_routes_per_warm_step": warm[0][
              "csr_aggregate_routes"],
          "losses": [s["loss"] for s in warm],
          "paper_s": PAPER_STEP_S,
          "note": "the paper's figure: one RL training step on one GPU of "
                  "Summit, >30M edges (its abstract); not a comparison"})
    torch.cuda.empty_cache()
    check_paper_minibatch(torch, source, mb, rows, failures)
    del source
    torch.cuda.empty_cache()


def phase_paper_scale(torch, policy):
    """Phase 4: one ER(20480, 0.15) graph solved on the card on all three
    reps (sparse and CSR from batches built on the host first); the reps
    of ``PAPER_TRACE`` also traced (``traced_solve``).  Returns the graph,
    its sparse batch on the host, its CSR batch on the card (phase 4b's
    dataset) and each rep's answer (and trace), for the paper-scale mesh
    solves."""
    from repro_torch.core import (SparseGraphBatch, csr_batch_from_dense,
                                  solve, sparse_batch_from_dense)
    from repro_torch.core.graphs import edge_count, erdos_renyi
    n = PAPER_N
    t0 = time.perf_counter()
    adj = erdos_renyi(n, 0.15, seed=SEED + 20480)
    gen_s = time.perf_counter() - t0
    edges = edge_count(adj)
    single, sparse_host = {}, None
    for rep in ("dense", "sparse", "csr"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if rep == "dense":
            graph = adj
        elif rep == "sparse":
            sparse_host = sparse_batch_from_dense(adj, device="cpu")
            graph = SparseGraphBatch(sparse_host.neighbors.to(DEVICE),
                                     sparse_host.valid.to(DEVICE))
        else:
            graph = csr_graph = csr_batch_from_dense(adj, device=DEVICE)
        build_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        res = solve(policy, graph, num_layers=2, multi_node=True,
                    max_d=PAPER_MAX_D, rep=rep, device=DEVICE)
        solve_s = time.perf_counter() - t0
        launches = read_counts()[REP_KERNEL[rep]]
        routes = read_routes().get(REP_KERNEL[rep])
        if not is_cover(adj, res.solution[0]):
            raise AssertionError(f"paper-scale {rep} solve is not a cover")
        if launches != res.policy_evals:
            raise AssertionError(f"paper-scale {rep}: launches != evals")
        single[rep] = {"solution": res.solution[0],
                       "evals": res.policy_evals,
                       "peak_device_bytes": torch.cuda.max_memory_allocated()}
        emit({"phase": "paper_scale", "rep": rep, "N": n, "edges": edges,
              "generate_s": gen_s, "build_s": build_s, "solve_s": solve_s,
              "policy_evals": res.policy_evals,
              "cover_size": int(res.sizes[0]), "kernel_launches": launches,
              "kernel_routes": routes,
              "equal_to_dense": bool(np.array_equal(
                  res.solution[0], single["dense"]["solution"])),
              "peak_device_bytes": single[rep]["peak_device_bytes"]})
        del res
        if rep != "csr":
            del graph
        if any(r == rep for r, _ in PAPER_TRACE):
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            trace = traced_solve(torch, policy, adj, rep, 0,
                                 torch.device(DEVICE), max_d=PAPER_MAX_D)
            if not np.array_equal(trace[1][-1, 0], single[rep]["solution"]):
                raise AssertionError(f"traced paper-scale {rep} run differs "
                                     f"from its solve")
            single[rep]["trace"] = trace
            emit({"phase": "paper_trace", "rep": rep, "N": n,
                  "evals": len(trace[0]),
                  "seconds": time.perf_counter() - t0})
    return {"adj": adj, "sparse_host": sparse_host, "csr": csr_graph,
            "single": single}


MESH_KERNEL = {("dense", "fused"): "mp_aggregate",
               ("sparse", "fused"): "fused_s2v_layer_sparse",
               ("csr", "fused"): "fused_s2v_layer_csr",
               ("sparse", "xla"): "sparse_mp_aggregate"}


def check_mesh_run(spec, ranks, i, ref, adj, failures, launches):
    """The holds of one mesh solve against the single-device solve of its
    problem on the card: the ranks agree; each rank launched the rep's
    kernel once per evaluation (twice on the xla chain; B1 never on the
    dense mesh); every answer passes the problem's numpy checker
    (``CHECKS``); first-evaluation scores within rtol = atol = 1e-5 (the
    card-vs-CPU rule of phase 3); answers and evaluation counts identical
    except where a trajectory parts at a near-tie (``parting``)."""
    run = ranks[0]["runs"][i]
    problem, rep, kernel = run["problem"], run["rep"], run["kernel"]
    ref_res, ref_trace = ref[problem, rep, kernel]
    name = MESH_KERNEL[rep, kernel]
    per_eval = 2 if kernel == "xla" else 1
    tag = f"mesh {spec} {problem} {rep} {kernel}"
    for rk in ranks:
        other = rk["runs"][i]
        if not np.array_equal(other["solution"], run["solution"]) \
                or other["evals"] != run["evals"]:
            failures.append(f"{tag}: rank {rk['rank']} differs from rank 0")
        if other["counts"][name] != per_eval * other["evals"] \
                or other["counts"]["fused_s2v_layer"] != 0:
            failures.append(f"{tag}: rank {rk['rank']} launches "
                            f"{other['counts']} for {other['evals']} evals")
        launches[name] = launches.get(name, 0) + other["counts"][name]
    identical = (np.array_equal(run["solution"], ref_res.solution)
                 and run["evals"] == ref_res.policy_evals)
    if not identical and not np.array_equal(run["trace"][1][-1],
                                            run["solution"]):
        failures.append(f"{tag}: the traced run differs from the solve")
    for g in range(adj.shape[0]):
        if not CHECKS[problem](adj[g], run["solution"][g]):
            failures.append(f"{tag}: graph {g} fails the {problem} checker")
    first_ref, first = ref_trace[0][0], run["trace"][0][0]
    err = float(np.abs(first - first_ref).max())
    if not np.allclose(first, first_ref, rtol=1e-5, atol=1e-5):
        failures.append(f"{tag}: first-evaluation scores differ by {err}")
    cases, near = ([], True) if identical else parting(ref_trace,
                                                       run["trace"])
    if not near:
        failures.append(f"{tag}: a trajectory parts at no near-tie: {cases}")
    emit({"phase": "mesh", "backend": "gloo", "ranks_share_card": True,
          "shape": list(spec), "problem": problem, "rep": rep,
          "kernel": kernel, "B": adj.shape[0], "N": adj.shape[1],
          "evals": run["evals"], "evals_single": ref_res.policy_evals,
          "sizes": run["solution"].sum(-1).astype(int).tolist(),
          "sizes_single": ref_res.sizes.tolist(),
          "identical_to_single": identical, "partings": cases,
          "first_eval_max_abs_err": err,
          "launches_per_rank": [rk["runs"][i]["counts"][name]
                                for rk in ranks], "kernel": name,
          "solve_s_per_rank": [rk["runs"][i]["solve_s"] for rk in ranks],
          "s_per_eval_per_rank": [rk["runs"][i]["solve_s"] / run["evals"]
                                  for rk in ranks],
          "note": "ranks share one card; not a scaling figure"})


def check_mesh_service(torch, policy, spec, ranks, ref_answers, serve_adjs,
                       failures, launches, problem):
    """The (2, 2) sync service of ``problem`` against the single-device
    service with as many rows per dispatch: answers that pass the
    problem's numpy checker, the ranks agree, B2 once per batch
    evaluation, answers identical to the single-device ones except where
    a dispatch, traced on both sides, parts at near-ties."""
    svc = ranks[0]["service"][problem]
    for rk in ranks:
        other = rk["service"][problem]
        if any(not np.array_equal(a, b) for a, b in zip(other["answers"],
                                                        svc["answers"])):
            failures.append(f"mesh service {problem}: rank {rk['rank']} "
                            f"differs")
        if other["counts"]["mp_aggregate"] != sum(other["batch_evals"]):
            failures.append(f"mesh service {problem}: rank {rk['rank']} "
                            f"launches "
                            f"{other['counts']} for batch evals "
                            f"{other['batch_evals']}")
        launches["mp_aggregate"] += other["counts"]["mp_aggregate"]
    cases_all, near_all = [], True
    plans = serve_plans(serve_adjs, spec[0] * 8)
    for (ids, sizes, trace), plan in zip(svc["plans"], plans):
        if ids != plan.request_ids:
            failures.append(f"mesh service plans {ids} != "
                            f"{plan.request_ids}")
        if trace is None:                   # every answer identical
            continue
        for row, (rid, n) in enumerate(zip(ids, sizes)):
            if not np.array_equal(trace[1][-1, row, :n], svc["answers"][rid]):
                failures.append(f"mesh service: request {rid} differs from "
                                f"its traced plan")
        ref_trace = traced_solve(torch, policy, plan.adj, "dense", 0,
                                 torch.device(DEVICE), problem=problem)
        cases, near = parting(ref_trace, trace)
        cases_all += [dict(c, requests=list(ids)) for c in cases]
        near_all &= near
    for a, ans in zip(serve_adjs, svc["answers"]):
        if not CHECKS[problem](a, ans):
            failures.append(f"mesh service: a {problem} answer fails its "
                            f"checker")
    if not near_all:
        failures.append(f"mesh service {problem} parts at no near-tie: "
                        f"{cases_all}")
    emit({"phase": "mesh_service", "backend": "gloo",
          "ranks_share_card": True, "shape": list(spec), "problem": problem,
          "requests": len(serve_adjs),
          "sizes": [int(a.shape[0]) for a in serve_adjs],
          "batches": svc["stats"]["batches"],
          "batch_evals": svc["batch_evals"],
          "identical_to_single": sum(
              bool(np.array_equal(a, r))
              for a, r in zip(svc["answers"], ref_answers)),
          "partings": cases_all,
          "launches_per_rank": [
              rk["service"][problem]["counts"]["mp_aggregate"]
              for rk in ranks],
          "solve_s": svc["stats"]["solve_seconds"],
          "note": "ranks share one card; not a scaling figure"})


def check_mesh_async(torch, policy, spec, ranks, serve_adjs, failures,
                     launches):
    """The (2, 2) service's async half (``mesh_async_rank``): for the async
    burst and each open-loop mode, every request answered once with a
    cover, no first dispatch on the request path, every rank's
    dispatches and answers rank 0's, each rank's B2 launches its batch
    evaluations; the burst's answers the sync service's except where a
    dispatch, traced on both sides, parts at near-ties
    (``check_mesh_service``'s rule); the open-loop answers the mesh's own
    ``serve()``'s of the same graphs.  Prints the plans' bytes and
    milliseconds a dispatch (rank 0 sending, the others receiving) and
    rank 0's reports."""
    from repro_torch.serving import make_workload
    halves = ranks[0]["async"]
    wl = make_workload(halves["rate"], MESH_OPEN_LOOP_REQUESTS,
                       MESH_SERVE_SIZES, rho=0.15, seed=SEED)
    for key in ("burst", ("open_loop", "async"), ("open_loop", "sync")):
        burst = key == "burst"
        tag = "mesh async burst" if burst else f"mesh open loop {key[1]}"
        runs = [rk["async"][key] for rk in ranks]
        lead = runs[0]
        graphs = serve_adjs if burst else list(wl.adjs)
        first = 0 if burst else lead["first"]
        ids = sorted(i for d in lead["dispatches"] for i in d["ids"])
        if ids != list(range(first, first + len(graphs))):
            failures.append(f"{tag}: answered ids {ids}")
        for rk, r in zip(ranks, runs):
            same = [d["ids"] for d in r["dispatches"]] == [
                d["ids"] for d in lead["dispatches"]] and all(
                np.array_equal(a, b)
                for d, e in zip(r["dispatches"], lead["dispatches"])
                for a, b in zip(d["answers"], e["answers"]))
            if not same:
                failures.append(f"{tag}: rank {rk['rank']}'s dispatches "
                                f"differ from rank 0's")
            evals = sum(d["evals"] for d in r["dispatches"])
            if r["counts"]["mp_aggregate"] != evals:
                failures.append(f"{tag}: rank {rk['rank']} launched "
                                f"{r['counts']['mp_aggregate']} B2 for "
                                f"{evals} batch evaluations")
            if r["compiles"]:
                failures.append(f"{tag}: rank {rk['rank']}: {r['compiles']} "
                                f"first dispatches on the request path")
            launches["mp_aggregate"] += r["counts"]["mp_aggregate"]
        cases_all, near_all, differing = [], True, 0
        for d in lead["dispatches"]:
            for rid, ans in zip(d["ids"], d["answers"]):
                if not is_cover(graphs[rid - first], ans):
                    failures.append(f"{tag}: answer {rid} is not a cover")
            if d["trace"] is None:
                continue
            differing += 1
            ref_trace = traced_solve(torch, policy, d["adj"], "dense", 0,
                                     torch.device(DEVICE))
            cases, near = parting(ref_trace, d["trace"])
            cases_all += [dict(c, requests=list(d["ids"])) for c in cases]
            near_all &= near
        if not burst and differing:
            failures.append(f"{tag}: {differing} dispatches answer other "
                            f"than the mesh's serve() of the same graphs")
        if not near_all:
            failures.append(f"{tag}: parts at no near-tie: {cases_all}")
        dispatches = len(lead["dispatches"])
        if lead["channel"]["plans"] != dispatches + 1:   # and the stop
            failures.append(f"{tag}: {lead['channel']['plans']} plans for "
                            f"{dispatches} dispatches")
        row = {"phase": "mesh_async" if burst else "mesh_open_loop",
               "backend": "gloo", "ranks_share_card": True,
               "shape": list(spec), "problem": "mvc",
               "requests": len(graphs), "dispatches": dispatches,
               "batch_evals": [d["evals"] for d in lead["dispatches"]],
               "differing_dispatches": differing, "partings": cases_all,
               "plan_bytes_per_dispatch":
                   lead["channel"]["payload_bytes"] / dispatches,
               "plan_ms_per_dispatch_per_rank": [
                   1e3 * r["channel"]["seconds"] / dispatches
                   for r in runs],
               "launches_per_rank": [r["counts"]["mp_aggregate"]
                                     for r in runs],
               "seconds": lead["seconds"],
               "note": "ranks share one card; not a scaling figure"}
        if burst:
            row["identical_to_sync"] = len(graphs) - sum(
                len(d["ids"]) for d in lead["dispatches"]
                if d["trace"] is not None)
        else:
            rep = lead["report"]
            if not (rep["submitted"] == rep["completed"] == len(graphs)
                    and rep["rejected"] == 0):
                failures.append(f"{tag}: {rep}")
            row.update(mode=key[1], rate_rps=halves["rate"],
                       rate_factor=MESH_OPEN_LOOP_FACTOR,
                       **{k: rep[k] for k in (
                           "p50_ms", "p99_ms", "mean_ms", "goodput_rps",
                           "wall_s", "completed", "rejected")})
        emit(row)


def check_mesh_host(spec, ranks, refs, failures, launches):
    """The host loop on the mesh (``mesh_host_small``, ``mesh_host_full``):
    each small run of ``spec`` against the single-device host loop on the
    card (``refs``): the ranks' weights bit for bit, the replay's tuples
    identical (epsilon 1: every action the agents' numpy pick), losses
    and weights within rtol 1e-5 / atol 1e-6 (the mesh sums the loss and
    the gradients in other orders); at MESH_HOST_FULL's shape the
    full-width run: B1 once a cold step (the act) and 1 + tau a warm one
    (the act and the whole-state fresh targets), B2 tau a warm step (the
    GD forward on the tile), finite losses from the first warm step, the
    control read counted once; its seconds a warm step beside the fused
    mesh step's in the same spawn, the syncs of its step after the first
    warm one and peak bytes per rank."""
    for rep, shape in MESH_HOST_SMALL:
        if shape != spec:
            continue
        runs = [rk["host_small"][rep] for rk in ranks]
        ref, got = refs[rep], runs[0]
        tag = f"mesh host loop {spec} {rep}"
        if any(not np.array_equal(r["params"], got["params"]) for r in runs):
            failures.append(f"{tag}: the ranks' weights differ")
        ring = all(np.array_equal(got["ring"][f], ref["ring"][f])
                   for f in ref["ring"])
        if not ring:
            failures.append(f"{tag}: the replay's tuples differ from one "
                            f"device's")
        warm = np.isfinite(ref["losses"])
        loss_err = float(np.max(np.abs(got["losses"][warm]
                                       - ref["losses"][warm]), initial=0.0))
        if not (np.array_equal(np.isfinite(got["losses"]), warm)
                and warm.sum() >= 3
                and np.allclose(got["losses"][warm], ref["losses"][warm],
                                rtol=1e-5, atol=1e-6)):
            failures.append(f"{tag}: losses {got['losses']} vs "
                            f"{ref['losses']}")
        param_err = float(np.abs(got["params"] - ref["params"]).max())
        if not np.allclose(got["params"], ref["params"], rtol=1e-5,
                           atol=1e-6):
            failures.append(f"{tag}: weights {param_err} apart")
        emit({"phase": "mesh_host_small", "backend": "gloo",
              "ranks_share_card": True, "shape": list(spec), "rep": rep,
              "steps": len(ref["losses"]), "warm_steps": int(warm.sum()),
              "replay_tuples": int(len(ref["ring"]["action"])),
              "identical_replay": ring, "loss_max_abs_err": loss_err,
              "param_max_abs_err": param_err})
    if spec != MESH_HOST_FULL[2]:
        return
    runs = [rk["host_full"] for rk in ranks]
    timed = slice(MESH_HOST_WARM_FROM + 1, None)
    for rk, r in zip(ranks, runs):
        tag = f"mesh host loop {spec} dense, rank {rk['rank']}"
        for i, c in enumerate(r["counts"]):
            warm = i >= MESH_HOST_WARM_FROM
            want = (1 + TRAIN_TAU, TRAIN_TAU) if warm else (1, 0)
            got = (c["fused_s2v_layer"], c["mp_aggregate"])
            if got != want:
                failures.append(f"{tag}: step {i} launched B1, B2 {got}, "
                                f"not {want}")
            if math.isfinite(r["losses"][i]) != warm:
                failures.append(f"{tag}: losses {r['losses']}")
        if r["control_syncs"] != 1:
            failures.append(f"{tag}: the control read was counted "
                            f"{r['control_syncs']} times")
        for name in ("fused_s2v_layer", "mp_aggregate"):
            launches[name] = launches.get(name, 0) + sum(
                c[name] for c in r["counts"])
    fused = [rk["train_full"][MESH_HOST_FULL[:2]]["seconds"][
        MESH_FULL_WARM + 2:] for rk in ranks]
    emit({"phase": "mesh_host_train", "backend": "gloo",
          "ranks_share_card": True, "shape": list(spec), "rep": "dense",
          "problem": "mvc", "steps": MESH_HOST_STEPS,
          "warm_steps": MESH_HOST_STEPS - MESH_HOST_WARM_FROM,
          "tau": TRAIN_TAU, "minibatch": TRAIN_CFG["minibatch"],
          "N": TRAIN_DATA[1],
          "launches_per_warm_step": {
              "fused_s2v_layer": 1 + TRAIN_TAU, "mp_aggregate": TRAIN_TAU},
          "median_warm_step_s_per_rank": [float(np.median(r["seconds"][
              timed])) for r in runs],
          "warm_step_s_rank0": runs[0]["seconds"][timed],
          "fused_median_warm_step_s_per_rank": [float(np.median(f))
                                                for f in fused],
          "syncs_one_warm_step_per_rank": [r["syncs"] for r in runs],
          "syncs_by_line_rank0": runs[0]["syncs_by_line"],
          "peak_gb_per_rank": [r["peak_device_bytes"] / 1e9 for r in runs],
          "losses_rank0": runs[0]["losses"],
          "note": "ranks share one card; not a scaling figure"})


def launcher_mesh_rate():
    """The launcher's ``--rate --mode async`` on a (2, 1) mesh of two gloo
    ranks sharing the card, under torchrun: it must exit 0 with the load
    report line printed once, by rank 0.  Its processes are a session of
    their own, killed whole if it outlives its limit."""
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.solve_serve",
           *MESH_LAUNCHER_RATE]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(var, None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("the launcher's --rate on a mesh did not end "
                             "within 300 s; killed")
    lines = [ln for ln in stdout.splitlines() if "rps offered" in ln]
    if proc.returncode != 0 or len(lines) != 1 \
            or not lines[0].startswith("async @ 50.0 rps offered: "):
        raise AssertionError(f"the launcher's --rate on a mesh: rc "
                             f"{proc.returncode}, {stdout[-2000:]} "
                             f"{stderr[-2000:]}")
    emit({"phase": "launcher_mesh_rate", "args": list(MESH_LAUNCHER_RATE),
          "line": lines[0], "seconds": time.perf_counter() - t0})


def check_paper_mesh(spec, ranks, paper, failures, launches):
    """The paper-scale mesh solves of one spawn: covers, the ranks agree,
    the rep's kernel once per evaluation, and each rank's peak device
    memory beside the §5.2 model and the single-device peak; no dense
    rank at sp = 4 may hold the whole adjacency.  A solve of
    ``PAPER_TRACE`` is held to the traced single-device solve: its trace
    ends in its answer, and where the two part, they part at a near-tie
    (``parting``)."""
    from repro_torch.core import per_device_bytes, sparse_per_device_bytes
    adj = paper["adj"]
    n = adj.shape[0]
    whole = 4.0 * n * n
    for rep, shape in PAPER_MESH:
        if shape != spec:
            continue
        runs = [rk["paper", rep] for rk in ranks]
        name = MESH_KERNEL[rep, "fused"]
        sol = runs[0]["solution"]
        for r in runs:
            if not np.array_equal(r["solution"], sol) \
                    or r["counts"][name] != r["evals"]:
                failures.append(f"paper mesh {spec} {rep}: ranks differ or "
                                f"launches {r['counts']} != evals")
            launches[name] = launches.get(name, 0) + r["counts"][name]
        if not is_cover(adj, sol):
            failures.append(f"paper mesh {spec} {rep}: no cover")
        peaks = [r["peak_device_bytes"] for r in runs]
        if rep == "dense" and spec[1] == 4 and max(peaks) >= whole:
            failures.append(f"paper mesh {spec} dense: a rank's peak "
                            f"{max(peaks)} B holds the whole adjacency")
        single = paper["single"][rep]
        cases, traced = [], "trace" in runs[0]
        if traced:
            trace = runs[0]["trace"]
            if not np.array_equal(trace[1][-1, 0], sol):
                failures.append(f"paper mesh {spec} {rep}: the traced run "
                                f"differs from the solve")
            cases, near = parting(single["trace"], trace)
            if not near:
                failures.append(f"paper mesh {spec} {rep}: the trajectory "
                                f"parts at no near-tie: {cases}")
        model = (per_device_bytes(n, 1, 0.15, spec[1], dp=spec[0])
                 if rep == "dense" else sparse_per_device_bytes(
                     n, paper["sparse_host"].max_degree, 1, spec[1],
                     dp=spec[0]))
        emit({"phase": "paper_mesh", "backend": "gloo",
              "ranks_share_card": True, "shape": list(spec), "rep": rep,
              "N": n, "evals": runs[0]["evals"],
              "evals_single": single["evals"], "cover_size": int(sol.sum()),
              "cover_size_single": int(single["solution"].sum()),
              "identical_to_single": bool(np.array_equal(
                  sol, single["solution"])),
              "traced": traced, "partings": cases,
              "peak_device_bytes_per_rank": peaks,
              "peak_device_bytes_single": single["peak_device_bytes"],
              "whole_adjacency_bytes": whole,
              "model_bytes_per_device": model,
              "kernel_launches_per_rank": [r["counts"][name] for r in runs],
              "solve_s_per_rank": [r["solve_s"] for r in runs],
              "note": "ranks share one card; not a scaling figure"})


def phase_mesh(torch, policy, cfg, stream, paper):
    """The mesh phase: gloo ranks sharing cuda:0, one spawn per shape in
    MESH_SHAPES, each held to the single-device port on the card: the
    solves of MVC and of MaxCut, MIS and MDS; at (2, 2) the sync service
    of MVC and of MESH_SERVICE_PROBLEMS, then the async service and
    open-loop load with rank 0 as the one planner (``check_mesh_async``);
    the mesh's train half (the small lockstep of ``mesh_small_cases``, the
    full-width runs of MESH_TRAIN_FULL, against their references on one
    device, ``mesh_train_refs``) and the host loop on the mesh
    (``check_mesh_host``); the paper-scale solves of PAPER_MESH; then the
    launcher's --rate on a mesh under torchrun.  Returns the mesh kernels'
    launches in the solves, the services and in the full-width train
    runs, summed over ranks."""
    import tempfile
    from repro_torch.convert import policy_to_numpy
    from repro_torch.core import random_graph_batch, solve, spawn_mesh
    from repro_torch.serving import GraphSolverService
    b, n = MESH_CHECK
    adj = random_graph_batch("er", n, b, seed=SEED + 13, rho=0.15)
    dev = torch.device(DEVICE)
    ref = {}
    keys = [("mvc",) + k for k in MESH_KERNEL] + [
        (p, rep, "fused") for p in PROBLEMS for rep in TRAIN_REPS]
    for problem, rep, kernel in keys:
        res = solve(policy, adj, num_layers=2, multi_node=True, rep=rep,
                    kernel=kernel, problem=problem, device=DEVICE)
        trace = traced_solve(torch, policy, adj, rep, 0, dev, kernel,
                             problem=problem)
        if not np.array_equal(trace[1][-1], res.solution):
            raise AssertionError(f"traced single-device {problem} {rep} "
                                 f"{kernel} run differs from its solve")
        ref[problem, rep, kernel] = (res, trace)
    serve_adjs = [a for a in stream if a.shape[0] in MESH_SERVE_SIZES][:8]
    # the single-device service with the (2, 2) service's rows per dispatch
    ref_svc = GraphSolverService(policy, cfg, device=DEVICE, multi_node=True,
                                 max_batch=2 * 8)
    ref_answers = {p: [r.solution for r in ref_svc.serve(serve_adjs,
                                                         problem=p)]
                   for p in ("mvc",) + MESH_SERVICE_PROBLEMS}
    refs = {key: (res.solution, res.policy_evals)
            for key, (res, _) in ref.items()}
    weights = policy_to_numpy(policy)
    t0 = time.perf_counter()
    host_refs = {rep: mesh_host_small(torch, weights, adj, dev, rep)
                 for rep, _ in MESH_HOST_SMALL}
    a6b_s = {"host_refs": time.perf_counter() - t0}
    launches, train_launches, failures = {"mp_aggregate": 0}, {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        train_args, train_refs = mesh_train_refs(torch, policy, adj, tmp)
        emit({"phase": "mesh_train_refs",
              "seconds": time.perf_counter() - t0})
        files = {"dense": os.path.join(tmp, "adj.npy"),
                 "neighbors": os.path.join(tmp, "neighbors.npy"),
                 "valid": os.path.join(tmp, "valid.npy")}
        np.save(files["dense"], paper["adj"][None])
        np.save(files["neighbors"], paper["sparse_host"].neighbors.numpy())
        np.save(files["valid"], paper["sparse_host"].valid.numpy())
        torch.cuda.empty_cache()
        for spec in MESH_SHAPES:
            reps = [rep for rep, shape in PAPER_MESH if shape == spec]
            t0 = time.perf_counter()
            ranks = spawn_mesh(
                mesh_rank, *spec, device=DEVICE, backend="gloo",
                timeout_s=MESH_TIMEOUT_S,
                args=(weights, adj, refs,
                      (serve_adjs, ref_answers) if spec == (2, 2) else None,
                      dict(train_args, small=mesh_small_cases(spec),
                           full=[(p, rep) for p, rep, shape in MESH_TRAIN_FULL
                                 if shape == spec],
                           host_small=[rep for rep, shape in MESH_HOST_SMALL
                                       if shape == spec],
                           host_full=spec == MESH_HOST_FULL[2]),
                      dict(files, reps=reps, max_d=PAPER_MAX_D,
                           trace=[rep for rep, shape in PAPER_TRACE
                                  if shape == spec])))
            emit({"phase": "mesh_spawn", "shape": list(spec),
                  "seconds": time.perf_counter() - t0})
            for i in range(len(ranks[0]["runs"])):
                check_mesh_run(spec, ranks, i, ref, adj, failures, launches)
            if spec == (2, 2):
                for p in ref_answers:
                    check_mesh_service(torch, policy, spec, ranks,
                                       ref_answers[p], serve_adjs, failures,
                                       launches, p)
                check_mesh_async(torch, policy, spec, ranks, serve_adjs,
                                 failures, launches)
            check_mesh_train_small(spec, ranks, train_refs, failures)
            check_mesh_train_full(spec, ranks, train_refs, failures,
                                  train_launches)
            check_mesh_host(spec, ranks, host_refs, failures,
                            train_launches)
            for part, sec in ranks[0].get("a6b_s", {}).items():
                a6b_s[f"{part} {spec[0]}x{spec[1]}"] = sec
            check_paper_mesh(spec, ranks, paper, failures, launches)
            for rk in ranks:
                if "profile" in rk:
                    emit({"phase": "mesh_profile", "backend": "gloo",
                          "ranks_share_card": True, "shape": list(spec),
                          "rank": rk["rank"], "rep": "dense", "N": PAPER_N,
                          **rk["profile"],
                          "note": "ranks share one card; not a scaling "
                                  "figure"})
    t0 = time.perf_counter()
    launcher_mesh_rate()
    a6b_s["launcher"] = time.perf_counter() - t0
    # what the async half, the host loop and the launcher add to the phase
    emit({"phase": "mesh_a6b_seconds", **a6b_s,
          "total": sum(a6b_s.values())})
    if failures:
        raise AssertionError("the mesh phase failed:\n" + "\n".join(
            str(f) for f in failures))
    return {"solve": launches, "train": train_launches}


# ---------------------------------------------------------------------------
# The mesh's train half: run by the ranks and, as the reference, by the
# parent on one device.
# ---------------------------------------------------------------------------

def flat_params(torch, policy) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in policy.parameters()
                      ]).cpu().numpy()


def mesh_lockstep_run(torch, weights, adj, draws, dev, problem, rep, mode,
                      eps, mesh=None):
    """The small lockstep's run of one case (``MESH_SMALL_CFG``,
    ``MESH_SMALL_RUN``) of ``problem``: on one device (``mesh`` None) or
    on this rank's tiles, each step given its numpy draws.  Per step: the
    whole batch's act scores (the step's own scorer, evaluated just before
    it, gathered over ``data``), actions, loss and parameters.  Never
    counted: only the full-width runs are the main path."""
    import functools
    from repro_torch.core import TrainDraws, env
    from repro_torch.core.inference import gather_batch
    from repro_torch.core.spatial import spatial_solve_scores_fn
    b, tau, _ = MESH_SMALL_RUN
    run = train_setup(torch, weights, rep, adj, dev, mesh,
                      cfg=MESH_SMALL_CFG, eps=eps, tau=tau, mode=mode,
                      gi=np.arange(0, 2 * b, 2), problem=problem)
    r, policy, es, state = run["rep"], run["policy"], run["es"], run["state"]
    score = functools.partial(r.scores, num_layers=2)
    if mesh is not None and mesh.sp > 1:
        score = spatial_solve_scores_fn(
            mesh, num_layers=2, rep=r,
            residual=env.sparse_residual_flag(problem))
    out = {"scores": [], "actions": [], "losses": [], "params": []}
    for d in draws:
        with torch.no_grad():
            scores = score(policy, state)
        es, state, action, _, _, loss = run["step"](
            es, state, run["source"], run["gi"],
            TrainDraws(*(torch.as_tensor(x, device=dev) for x in d)))
        scores, action = gather_batch(mesh, scores, action)
        out["scores"].append(scores)
        out["actions"].append(action)
        out["losses"].append(float(loss))
        out["params"].append(flat_params(torch, policy))
    return {k: np.stack(v) for k, v in out.items()}


def mesh_small_cases(spec):
    """(problem, rep, target mode, epsilon) of the small lockstep at
    ``spec``: MVC's at MESH_TRAIN_SMALL's shapes (dense and sparse, CSR
    at sp = 1, both modes), each other problem's fresh at epsilon 0.5 on
    MESH_PROBLEM_SMALL's (rep, shape) pairs."""
    cases = []
    if spec in MESH_TRAIN_SMALL:
        reps = ("dense", "sparse") + (("csr",) if spec[1] == 1 else ())
        cases += [("mvc", rep, mode, eps) for rep in reps
                  for mode, eps in (("stored", 0.0), ("fresh", 0.5))]
    return cases + [(p, rep, "fresh", 0.5) for p in PROBLEMS
                    for rep, shape in MESH_PROBLEM_SMALL if shape == spec]


def train_setup(torch, weights, rep, data, dev, mesh=None, *, problem,
                cfg=TRAIN_CFG, eps=1.0, tau=TRAIN_TAU, mode="fresh",
                gi=None):
    """A mesh-phase train run's policy, a second copy of its weights,
    engine, step, dataset (tile) and episode state (tile) of ``problem``,
    on one device (``mesh`` None) or on this rank: ``cfg`` at epsilon
    ``eps``, ``tau`` GD iterations a step with ``mode`` targets, episode
    graphs ``gi`` (when None, ``TRAIN_DATA``'s count drawn from seed
    SEED + 21); ``data`` the whole dataset on the host, as graphs or in
    ``rep``'s layout."""
    from repro_torch.convert import policy_from_numpy
    from repro_torch.core import (PolicyConfig, engine_init, env, get_rep,
                                  get_train_step)
    from repro_torch.core.mesh import shard_dataset
    from repro_torch.core.spatial import tile_state_from_tuples
    from repro_torch.optim import adam_init
    cfg = PolicyConfig(**cfg, eps_start=eps, eps_end=eps,
                       spatial=mesh.shape if mesh is not None else 0)
    r = get_rep(rep)
    policy = policy_from_numpy(weights, device=dev)
    whole = r.prepare_dataset(data, device="cpu")
    g, n = r.dataset_shape(whole)
    if gi is None:
        gi = np.random.default_rng(SEED + 21).integers(0, g, TRAIN_DATA[2])
    zero = np.zeros((len(gi), n), np.float32)
    kw = dict(residual=env.residual_mode(problem),
              candidate_fn=env.candidate_rule(problem))
    if mesh is None:
        source = r.prepare_dataset(whole, device=dev)
        state = r.state_from_tuples(source, torch.as_tensor(gi, device=dev),
                                    zero, **kw)
    else:
        source = shard_dataset(mesh, whole, device=dev)
        state = tile_state_from_tuples(mesh, r, whole, gi, zero, device=dev,
                                       **kw)
    del whole
    es = engine_init(cfg, policy, adam_init(policy), n, seed=SEED + 21,
                     mesh=mesh)
    step = get_train_step(cfg, rep=r, problem=problem, tau=tau,
                          target_mode=mode)
    return dict(cfg=cfg, rep=r, policy=policy,
                policy0=policy_from_numpy(weights, device=dev), es=es,
                step=step, source=source, state=state,
                gi=torch.as_tensor(gi, device=dev))


@contextlib.contextmanager
def main_thread_syncs(torch):
    """Yields a function that lists the synchronizing CUDA calls made on
    this thread inside the block so far (with ``where=True`` the file and
    line of each).  ``set_sync_debug_mode("error")``
    cannot hold a mesh step: gloo's worker threads synchronize their own
    copy streams for every collective on CUDA tensors, and the mode is
    process-wide, so it raises inside the collectives.  In "warn" mode a
    warning raised on this thread reaches Python's ``warnings`` here,
    while the workers' go to the C++ log (stderr): what is recorded is
    this thread's, the step's own reads back.  The caller makes one host
    read of its own in the block, the control that such a read is seen."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield lambda where=False: [
                f"{os.path.basename(w.filename)}:{w.lineno}" if where
                else str(w.message) for w in caught
                if "synchronizing CUDA operation" in str(w.message)]
        finally:
            torch.cuda.set_sync_debug_mode(0)


@contextlib.contextmanager
def left_out_terms(mesh):
    """The mesh GD step with loss terms of other ranks left out of each
    rank's gradient, the control of ``check_mesh_train_full``'s rule: at
    sp > 1 the pooled sum as an in-place all-reduce gives it (each rank
    differentiates only its own loss terms through the sum), at sp = 1
    the world all-reduce of the gradients skipped."""
    from repro_torch.core import qmodel, spatial
    from repro_torch.core.mesh import all_reduce_sum

    def in_place(s, axis):
        return s + (all_reduce_sum(s.detach().clone(), axis) - s.detach())
    module, name, fn = ((qmodel, "pooled_sum", in_place) if mesh.sp > 1 else
                        (spatial, "all_reduce_world", lambda m, t: t))
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def mesh_full_run(torch, mesh, dev, weights, rep, data, problem):
    """One rank's full-width run of ``problem``: ``MESH_FULL_WARM + 2 +
    MESH_FULL_TIMED`` fused steps with draws from ``draw_train_step``;
    after the first warm step the loss and all-reduced gradients of its
    first GD iteration, recomputed from the initial weights
    (``.loss_and_grads`` of the mesh GD step), and the same at bf16 and
    with other ranks' loss terms left out (``left_out_terms``), the rule's
    controls; the next step with its host reads counted
    (``main_thread_syncs``: the env's tile rules and the rest of the step
    run on this thread), then one deliberate host read, the control; per
    step its seconds, kernel launches and collectives by kind; the peak
    device bytes over the steps after the first warm one."""
    from repro_torch.core import draw_train_step, env
    from repro_torch.core.mesh import reset_traffic
    from repro_torch.core.spatial import manual_train_minibatch_fn
    from repro_torch.device import synchronize
    run = train_setup(torch, weights, rep, data, dev, mesh, problem=problem)
    cfg, es, state = run["cfg"], run["es"], run["state"]
    gd, gd_bf16 = (manual_train_minibatch_fn(
        mesh, rep=run["rep"], num_layers=cfg.num_layers,
        lr=cfg.learning_rate, gamma=cfg.gamma, minibatch=cfg.minibatch,
        residual=env.residual_mode(problem),
        candidate_fn=env.candidate_rule(problem), target_mode="fresh",
        compute=c) for c in ("f32", "bf16"))
    out = {"rank": mesh.rank, "seconds": [], "counts": [], "traffic": [],
           "losses": [], "picks": [], "warm_idx": None, "host_syncs": None,
           "control_syncs": None}
    on_card = dev.type == "cuda"
    for i in range(MESH_FULL_WARM + 2 + MESH_FULL_TIMED):
        draws = draw_train_step(cfg, es, state, tau=TRAIN_TAU)
        if i == MESH_FULL_WARM + 1 and on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        synchronize(dev)
        reset_counts()
        reset_traffic(mesh)
        checked = i == MESH_FULL_WARM + 1 and on_card
        t0 = time.perf_counter()
        with (main_thread_syncs(torch) if checked
              else contextlib.nullcontext()) as syncs:
            es, state, _, _, _, loss = run["step"](es, state, run["source"],
                                                   run["gi"], draws)
            if checked:
                out["host_syncs"] = syncs()
                torch.zeros((), device=dev).item()
                out["control_syncs"] = len(syncs()) - len(out["host_syncs"])
        synchronize(dev)
        out["seconds"].append(time.perf_counter() - t0)
        out["counts"].append(read_counts())
        out["traffic"].append(reset_traffic(mesh))
        out["losses"].append(float(loss))
        out["picks"].append(draws.pick[mesh.data.rows(
            draws.pick.shape[0])].cpu().numpy())
        if i == MESH_FULL_WARM:
            idx = draws.sample_idx[0]
            out["warm_idx"] = idx.cpu().numpy()
            for name, fn, patch in (
                    ("first_gd", gd, contextlib.nullcontext()),
                    ("bf16", gd_bf16, contextlib.nullcontext()),
                    ("left_out", gd, left_out_terms(mesh))):
                with patch:
                    loss0, grads = fn.loss_and_grads(
                        run["policy0"], es.replay, run["source"], idx)
                out[name] = {"loss": float(loss0), **{
                    k: v.cpu().numpy() for k, v in grads.items()}}
            reset_traffic(mesh)
    out["peak_device_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if on_card else 0)
    out["params"] = flat_params(torch, run["policy"])
    return out


def f64_grads_and_scale(torch, policy, st, action, target, num_layers):
    """A GD iteration's loss gradients in f64, by a plain composition of
    the policy (Alg. 2-3, the ``xla`` chain) on the dense residual
    adjacency ``st.adj`` under autograd, and the sum of the absolute
    values of the terms behind each gradient: the gradient of the same
    composition with every weight and input by its absolute value, the
    ReLUs' masks held at the f64 forward's and each row's loss derivative
    2(q - target)/M by its absolute value, which sums |product| over every
    path of the chain rule's expansion, every (row, node) pair's included.
    Returns (f64 gradients, scales, the f64 scores at the actions)."""
    f64 = torch.float64
    adj = st.adj.to(f64)
    sol, cand = st.solution.to(f64), st.candidate.to(f64)
    deg = adj.sum(-1)
    rows, act = torch.arange(adj.shape[0], device=adj.device), action.long()

    def q_at_actions(w, relu):
        pre = w["em.theta2"][None, :, None] * deg[:, None, :]
        base = (w["em.theta1"][None, :, None] * sol[:, None, :]
                + torch.einsum("kj,bjn->bkn", w["em.theta3"], relu(pre)))
        mu = relu(base)                          # layer 0: zero embeddings
        for _ in range(1, num_layers):
            mu = relu(base + torch.einsum("kj,bjn->bkn", w["em.theta4"],
                                          mu @ adj))
        w1 = mu.sum(-1) @ w["q.theta5"].t()
        w2 = (mu[rows, :, act] * cand[rows, act][:, None]) @ \
            w["q.theta6"].t()
        return relu(torch.cat([w1, w2], 1)) @ w["q.theta7"]
    masks = []

    def relu_true(z):
        masks.append(z > 0)
        return torch.relu(z)
    names = [k for k, _ in policy.named_parameters()]
    w = {k: v.detach().to(f64).requires_grad_(True)
         for k, v in policy.named_parameters()}
    wa = {k: v.detach().abs().requires_grad_(True) for k, v in w.items()}
    with torch.enable_grad():
        q = q_at_actions(w, relu_true)
        err = q - target.to(f64)
        exact = torch.autograd.grad(torch.mean(torch.square(err)),
                                    [w[k] for k in names])
        it = iter(masks)
        qa = q_at_actions(wa, lambda z: z * next(it))
        scale = torch.autograd.grad(
            ((2 * err / err.shape[0]).abs().detach() * qa).sum(),
            [wa[k] for k in names])
    return dict(zip(names, exact)), dict(zip(names, scale)), q.detach()


def single_full_ref(torch, weights, rep, data, dense, dev, problem):
    """The full-width run's reference on one device, for ``problem``: the
    same steps up to the first warm one, with the same draws, then the
    loss and gradients of its first GD iteration from the initial weights
    (as the engine forms them), and in f64 with each gradient's sum of
    |terms| (``f64_grads_and_scale``, on the minibatch's dense residual
    adjacency and candidates in the problem's mode, built from ``dense``,
    the dataset's graphs)."""
    from repro_torch.core import DENSE, device_replay_at, draw_train_step, env
    from repro_torch.core.agent import loss_and_grads, max_q_raw, td_loss
    run = train_setup(torch, weights, rep, data, dev, problem=problem)
    cfg, es, state, r = run["cfg"], run["es"], run["state"], run["rep"]
    p0 = run["policy0"]
    picks = []
    for _ in range(MESH_FULL_WARM + 1):
        draws = draw_train_step(cfg, es, state, tau=TRAIN_TAU)
        es, state, _, _, _, loss = run["step"](es, state, run["source"],
                                               run["gi"], draws)
        picks.append(draws.pick.cpu().numpy())
    del state
    idx = draws.sample_idx[0]
    gi, sol, act, _, rew, sol2, dn = device_replay_at(es.replay, idx)
    kw = dict(rep=r, num_layers=cfg.num_layers)
    mode = dict(residual=env.residual_mode(problem),
                candidate_fn=env.candidate_rule(problem))
    st = r.state_from_tuples(run["source"], gi, sol2, **mode)
    tgt = rew + cfg.gamma * max_q_raw(p0, st, **kw) * (1.0 - dn)
    st = r.state_from_tuples(run["source"], gi, sol, **mode)
    loss0, grads = loss_and_grads(p0, lambda p: td_loss(
        r.scores(p, st, num_layers=cfg.num_layers, masked=False), act, tgt))
    with torch.no_grad():
        qsa = torch.gather(r.scores(p0, st, num_layers=cfg.num_layers,
                                    masked=False), 1, act.long()[:, None])[:, 0]
    if rep != "dense":
        del st, run
        st = DENSE.state_from_tuples(
            DENSE.prepare_dataset(dense, device=dev), gi, sol, **mode)
    exact, scale, q64 = f64_grads_and_scale(torch, p0, st, act, tgt,
                                            cfg.num_layers)
    q_err = float((q64 - qsa.double()).abs().max())
    if not q_err <= 1e-5 * (1 + float(q64.abs().max())):
        raise AssertionError(f"the f64 composition's scores at the actions "
                             f"are {q_err} from the port's on {problem} "
                             f"{rep}")

    def host(d):
        return {k: v.cpu().numpy() for k, v in d.items()}
    return {"loss": float(loss0), "step_loss": float(loss),
            "idx": idx.cpu().numpy(), "picks": picks, "q_err_f64": q_err,
            "grads": host(grads), "exact": host(exact),
            "scale": host(scale)}


def save_dataset(tmp, rep, source) -> dict:
    """A whole dataset's host arrays as .npy files the ranks map: the
    dense stack, or the fields of a SparseGraphBatch / CsrGraphBatch."""
    import dataclasses
    if rep == "dense":
        arrays = {"adj": np.asarray(source)}
    else:
        arrays = {f.name: getattr(source, f.name).cpu().numpy()
                  for f in dataclasses.fields(source)}
    files = {}
    for name, a in arrays.items():
        files[name] = os.path.join(tmp, f"train_{rep}_{name}.npy")
        np.save(files[name], a)
    return {"rep": rep, "files": files}


def load_dataset(torch, saved):
    """The host dataset of ``save_dataset``'s files."""
    from repro_torch.core import CsrGraphBatch, SparseGraphBatch
    arrays = {k: np.load(f, mmap_mode="c") for k, f in
              saved["files"].items()}
    if saved["rep"] == "dense":
        return arrays["adj"]
    cls = SparseGraphBatch if saved["rep"] == "sparse" else CsrGraphBatch
    return cls(**{k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in arrays.items()})


def mesh_train_refs(torch, policy, adj, tmp):
    """The mesh train checks' references, on the card, one device: the
    small lockstep of every case of every shape (``mesh_small_cases``)
    with its numpy draws, and each full-width (problem, rep)'s first warm
    GD iteration (``single_full_ref``) on phase 3b's training data, saved
    for the ranks.  Returns (the arguments the ranks take, the
    references)."""
    from repro_torch.convert import policy_to_numpy
    from repro_torch.core import get_rep, random_graph_batch
    b, tau, steps = MESH_SMALL_RUN
    n = adj.shape[-1]
    mb, cap = MESH_SMALL_CFG["minibatch"], MESH_SMALL_CFG["replay_capacity"]
    rng = np.random.default_rng(SEED + 22)
    draws = [(rng.random(b).astype(np.float32), rng.integers(0, n, b),
              rng.integers(0, min(b * (i + 1), cap), (tau, mb)))
             for i in range(steps)]
    weights = policy_to_numpy(policy)
    dev = torch.device(DEVICE)
    small = {case: mesh_lockstep_run(torch, weights, adj, draws, dev, *case)
             for case in sorted({c for spec in MESH_SHAPES
                                 for c in mesh_small_cases(spec)})}
    g, nf, _ = TRAIN_DATA
    data = random_graph_batch("er", nf, g, seed=SEED + 15, rho=0.15)
    full, saved = {}, {}
    for problem, rep, _ in MESH_TRAIN_FULL:
        host = data if rep == "dense" else get_rep(rep).prepare_dataset(
            data, device="cpu")
        if rep not in saved:
            saved[rep] = save_dataset(tmp, rep, host)
        t0 = time.perf_counter()
        full[problem, rep] = single_full_ref(torch, weights, rep, host, data,
                                             dev, problem)
        full[problem, rep]["seconds"] = time.perf_counter() - t0
        del host
        torch.cuda.empty_cache()
    del data
    return ({"weights": weights, "draws": draws, "data": saved},
            {"small": small, "full": full})


def train_parting(ref, got, tol=1e-5):
    """The first step at which two small lockstep runs take different
    actions, and whether every row that differs there parts at a near-tie
    of its act scores (``parting``'s rule: the two nodes' scores within
    2·tol·(1 + |score|) of each other on both sides).  (None, [], True)
    when the actions agree throughout."""
    differ = np.flatnonzero((ref["actions"] != got["actions"]).any(-1))
    if not len(differ):
        return None, [], True
    t = int(differ[0])
    cases, all_near = [], True
    for row in np.flatnonzero(ref["actions"][t] != got["actions"][t]):
        u, v = int(ref["actions"][t, row]), int(got["actions"][t, row])
        sc = [x["scores"][t, row] for x in (ref, got)]
        gap = max(abs(float(x[u] - x[v])) for x in sc)
        scale = 1 + max(abs(float(x[w])) for x in sc for w in (u, v))
        near = gap <= 2 * tol * scale
        all_near &= near
        cases.append({"step": t, "row": int(row), "ref": u, "mesh": v,
                      "gap": gap, "near_tie": bool(near)})
    return t, cases, all_near


def check_mesh_train_small(spec, ranks, refs, failures):
    """The small lockstep at ``spec`` against the single device on the
    card: the ranks' parameters equal bit for bit after every step; the
    same actions except from a traced near-tie on; before any parting the
    losses within 1e-6 relative (MVC's: rtol 1e-5 / atol 1e-6), and with
    none the parameters within rtol 1e-5 / atol 1e-6 (the CPU lockstep's
    bar: the all-reduced partials, the pooled sum and the ownership
    loss's sums meet in other orders than one device's fused chain,
    about 1e-7 apart)."""
    for case in mesh_small_cases(spec):
        runs = [rk["train_small"][case] for rk in ranks]
        ref, got = refs["small"][case], runs[0]
        tag = f"mesh train {spec} {' '.join(map(str, case))}"
        if any(not np.array_equal(r["params"], got["params"]) for r in runs):
            failures.append(f"{tag}: the ranks' parameters differ")
        t, cases, near = train_parting(ref, got)
        if not near:
            failures.append(f"{tag}: actions part at no near-tie: {cases}")
        upto = len(ref["losses"]) if t is None else t
        warm = np.isfinite(ref["losses"][:upto])
        diff = np.abs(got["losses"][:upto][warm] - ref["losses"][:upto][warm])
        loss_err = float(np.max(diff, initial=0.0))
        loss_rel = float(np.max(diff / np.abs(ref["losses"][:upto][warm]),
                                initial=0.0))
        rtol, atol = (1e-5, 1e-6) if case[0] == "mvc" else (1e-6, 0.0)
        if not np.array_equal(np.isfinite(got["losses"][:upto]), warm) \
                or not np.allclose(got["losses"][:upto][warm],
                                   ref["losses"][:upto][warm], rtol=rtol,
                                   atol=atol):
            failures.append(f"{tag}: losses {got['losses']} vs "
                            f"{ref['losses']}")
        param_err = None
        if t is None:
            param_err = float(np.abs(got["params"][-1]
                                     - ref["params"][-1]).max())
            if not np.allclose(got["params"][-1], ref["params"][-1],
                               rtol=1e-5, atol=1e-6):
                failures.append(f"{tag}: parameters {param_err} apart")
        emit({"phase": "mesh_train_small", "backend": "gloo",
              "ranks_share_card": True, "shape": list(spec),
              "problem": case[0], "rep": case[1], "mode": case[2],
              "epsilon": case[3],
              "steps": len(ref["losses"]), "warm_steps": int(warm.sum()),
              "identical_actions": t is None, "partings": cases,
              "loss_max_abs_err": loss_err, "loss_max_rel_err": loss_rel,
              "loss_rtol": rtol, "loss_atol": atol,
              "param_max_abs_err": param_err,
              "ranks_bit_equal": all(np.array_equal(r["params"],
                                                    got["params"])
                                     for r in runs)})


MESH_TRAIN_KERNELS = {"dense": ("mp_aggregate", None),
                      "sparse": ("fused_s2v_layer_sparse",
                                 "sparse_mp_aggregate"),
                      "csr": ("fused_s2v_layer_csr", "csr_aggregate")}


def check_mesh_train_full(spec, ranks, refs, failures, launches):
    """A full-width run of a (problem, rep) at ``spec``: the ranks drew
    the single device's picks and indices and end with the same
    parameters bit for bit; the checked step read nothing back on the
    ranks' own threads (``main_thread_syncs``), while the control read
    after it was counted once; the
    first warm GD iteration's loss within 1e-5 of the single device's by
    the sum-of-|terms| rule (its terms are the rows' non-negative squared
    errors), and its gradients within 1e-5 of the single device's and of
    the f64 composition's by the same rule (``graph_tol``), the scale
    being each gradient's sum of |terms| over every path, every (row,
    node) pair included (``f64_grads_and_scale``); the same rule must
    fail the step with other ranks' loss terms left out (``left_out_terms``)
    and is read for the bf16 step; the layer kernel 1 + 2τ and the
    aggregate 2τ launches a warm step on every rank (B1 none); its
    launches added to the kernels line's."""
    for problem, rep, shape in MESH_TRAIN_FULL:
        if shape != spec:
            continue
        runs = [rk["train_full"][problem, rep] for rk in ranks]
        ref = refs["full"][problem, rep]
        tag = f"mesh train full {spec} {problem} {rep}"
        layer, agg = MESH_TRAIN_KERNELS[rep]
        want = {layer: 1 + 2 * TRAIN_TAU, "fused_s2v_layer": 0}
        if agg:
            want[agg] = 2 * TRAIN_TAU
        n_steps = MESH_FULL_WARM + 2 + MESH_FULL_TIMED
        for r in runs:
            if not np.array_equal(r["params"], runs[0]["params"]):
                failures.append(f"{tag}: rank {r['rank']}'s parameters "
                                f"differ from rank 0's")
            if r["host_syncs"] or (r["host_syncs"] is None
                                   and DEVICE == "cuda"):
                failures.append(f"{tag}: rank {r['rank']}'s checked step "
                                f"read back from the device (or was not "
                                f"checked): {r['host_syncs']}")
            if DEVICE == "cuda" and r["control_syncs"] != 1:
                failures.append(f"{tag}: rank {r['rank']}'s control host "
                                f"read recorded {r['control_syncs']} syncs, "
                                f"not 1: the check sees no read back")
            if not np.array_equal(r["warm_idx"], ref["idx"]):
                failures.append(f"{tag}: rank {r['rank']} drew other "
                                f"replay indices")
            rows = slice(r["rank"] // spec[1] * TRAIN_DATA[2] // spec[0],
                         (r["rank"] // spec[1] + 1) * TRAIN_DATA[2]
                         // spec[0])
            if any(not np.array_equal(p, q[rows]) for p, q in
                   zip(r["picks"], ref["picks"])):
                failures.append(f"{tag}: rank {r['rank']} drew other picks")
            for i in range(MESH_FULL_WARM, n_steps):
                got = {k: r["counts"][i][k] for k in want}
                if got != want:
                    failures.append(f"{tag}: rank {r['rank']} step {i} "
                                    f"launched {got}, not {want}")
            for name in (layer, agg):
                if name:
                    launches[name] = launches.get(name, 0) + sum(
                        c[name] for c in r["counts"])
        got, tol = runs[0]["first_gd"], graph_tol("f32")

        def ratio(grads, want):
            """The worst |grads - want| over tol·(1 + sum of |terms|)."""
            return max(float((np.abs(grads[k] - w) / (
                tol + tol * ref["scale"][k])).max()) for k, w in want.items())
        loss_ratio = abs(got["loss"] - ref["loss"]) / (tol + tol * ref["loss"])
        ratios = {"mesh_vs_single": ratio(got, ref["grads"]),
                  "mesh_vs_f64": ratio(got, ref["exact"]),
                  "single_vs_f64": ratio(ref["grads"], ref["exact"]),
                  "bf16_mesh_vs_single": ratio(runs[0]["bf16"], ref["grads"]),
                  "left_out_vs_single": ratio(runs[0]["left_out"],
                                              ref["grads"])}
        if not (loss_ratio <= 1 and ratios["mesh_vs_single"] <= 1
                and ratios["mesh_vs_f64"] <= 1):
            failures.append(f"{tag}: the first warm GD iteration's loss "
                            f"(ratio {loss_ratio} to its tolerance) or "
                            f"gradients ({ratios}) differ")
        if not ratios["left_out_vs_single"] > 1:
            failures.append(f"{tag}: the gradient rule passes a step with "
                            f"other ranks' loss terms left out ({ratios})")
        timed = slice(MESH_FULL_WARM + 2, n_steps)
        emit({"phase": "mesh_train", "backend": "gloo",
              "ranks_share_card": True, "shape": list(spec),
              "problem": problem, "rep": rep,
              "mode": "fresh", "epsilon": 1.0, **TRAIN_CFG,
              "tau": TRAIN_TAU, "dataset": list(TRAIN_DATA[:2]),
              "episode_graphs": TRAIN_DATA[2], "steps": n_steps,
              "first_warm_loss": got["loss"],
              "first_warm_loss_single": ref["loss"],
              "loss_ratio_to_tol": loss_ratio, "grad_max_abs_err": {
                  k: float(np.abs(got[k] - w).max())
                  for k, w in ref["grads"].items()},
              "grad_tol": tol, "grad_rule": "sum of |terms| over all paths",
              "grad_worst_ratio_to_tol": ratios,
              "f64_scores_max_abs_err": ref["q_err_f64"],
              "single_device_ref_s": ref["seconds"],
              "per_rank": [{
                  "rank": r["rank"],
                  "warm_step_s": r["seconds"][timed],
                  "median_warm_step_s": float(np.median(r["seconds"][timed])),
                  "least_warm_step_s": min(r["seconds"][timed]),
                  "most_warm_step_s": max(r["seconds"][timed]),
                  "checked_step_host_syncs": (None if r["host_syncs"] is None
                                              else len(r["host_syncs"])),
                  "control_read_syncs": r["control_syncs"],
                  "first_warm_step_s": r["seconds"][MESH_FULL_WARM],
                  "peak_device_bytes": r["peak_device_bytes"],
                  "launches_per_warm_step": {
                      k: r["counts"][-1][k] for k in want},
                  "collectives_per_warm_step": r["traffic"][-1]}
                  for r in runs],
              "losses": runs[0]["losses"],
              "note": "ranks share one card; not a scaling figure"})


def phase_ba(torch, policy, indptr, indices, cs, gen_s, label="ba_1m_csr"):
    """Phase 4, CSR: BA(1M, d=10) with max_d=62500 from streamed edges;
    the cover is checked on the CSR arrays.  Prints the row as ``label``
    and returns B5's launches."""
    from repro_torch.core import solve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = solve(policy, cs, num_layers=2, multi_node=True, max_d=BA_MAX_D,
                rep="csr", device=DEVICE)
    solve_s = time.perf_counter() - t0
    launches = read_counts()["fused_s2v_layer_csr"]
    routes = read_routes().get("fused_s2v_layer_csr")
    sol = res.solution[0] > 0.5
    rows = np.repeat(np.arange(BA_N), np.diff(indptr))
    if not (sol[rows] | sol[indices]).all():
        raise AssertionError("BA(1M) CSR solve leaves an edge uncovered")
    if launches != res.policy_evals:
        raise AssertionError("BA(1M): launches != evals")
    emit({"phase": label, "N": BA_N, "d": BA_D,
          "directed_edges": int(len(indices)),
          "max_degree": int(np.diff(indptr).max()), "generate_s": gen_s,
          "solve_s": solve_s, "policy_evals": res.policy_evals,
          "cover_size": int(res.sizes[0]), "kernel_launches": launches,
          "kernel_routes": routes,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    return launches


def sampled_batch(torch, indptr, indices):
    """``SAMPLED_GRAPHS`` subgraphs of the resident graph stacked on the
    card (``NeighborSampler.training_batch``), their shapes and the host
    seconds a subgraph (the sampling and each subgraph's copy to the
    card)."""
    from repro_torch.core import NeighborSampler
    sampler = NeighborSampler(indptr, indices, batch_size=SAMPLED_SEEDS,
                              fanouts=SAMPLED_FANOUTS, seed=SEED)
    t0 = time.perf_counter()
    batch, maps = sampler.training_batch(SAMPLED_GRAPHS, device=DEVICE)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    ip = batch.indptr.cpu().numpy()

    def spread(v):
        return {"least": int(v.min()), "mean": float(v.mean()),
                "most": int(v.max())}
    shape = {"seeds": SAMPLED_SEEDS, "fanouts": list(SAMPLED_FANOUTS),
             "subgraphs": SAMPLED_GRAPHS, "node_budget": sampler.node_budget,
             "edge_budget": sampler.edge_budget,
             "real_nodes": spread((maps >= 0).sum(1)),
             "directed_edges": spread(ip[:, -1]),
             "max_degree": spread(np.diff(ip, axis=1).max(1)),
             "host_s_per_subgraph": host_s / SAMPLED_GRAPHS}
    return batch, shape


def check_sampled_aggregate(torch, source, tuples, rows, failures):
    """B5's aggregate entry on the first warm minibatch's state: the replay's
    64 tuples when it first holds a minibatch (``tuples``: graph ids and
    solutions), re-materialized on the sampled dataset with their residual
    factors, x random in [-0.5, 0.5) (the backward aggregates signed
    gradients).  At f32 and bf16, by the route the rule picks, which must be
    the row walk, against the windowed walk forced, bit for bit, and
    against the plain version (and at f32 the f64 aggregate)
    componentwise to the sum of |terms| (``compare``)."""
    from repro_torch.core import CSR, env
    from repro_torch.core.graphs import csr_row_ids
    from repro_torch.core.s2v_csr import csr_edge_factors
    _, _, kc = kernel_modules()
    gi, sol = tuples
    st = CSR.state_from_tuples(source, gi, sol.float(),
                               residual=env.residual_mode("mvc"),
                               candidate_fn=env.candidate_rule("mvc"))
    rid = csr_row_ids(st.indptr, st.num_edges)
    edge_w = csr_edge_factors(st.indices, st.edge_mask, rid, st.solution,
                              st.residual)
    b, n = st.solution.shape
    k = TRAIN_CFG["embed_dim"]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 25)
    x = torch.rand((b, k, n), generator=g, device=DEVICE) - 0.5
    args = (x, st.indices, st.indptr, edge_w)
    scale = kc.csr_aggregate_plain(x.abs(), st.indices, rid, edge_w.abs())
    exact = csr_exact(torch, x, st, edge_w)
    terms = int((st.indptr[:, 1:] - st.indptr[:, :-1]).max())
    shape = {"B": b, "K": k, "N": n, "E": st.num_edges,
             "edges": int(st.indptr[:, -1].sum())}
    for compute in ("f32", "bf16"):
        out, route = call_routed(kc.csr_aggregate, *args, compute)
        compare(torch, rows, failures, "csr_aggregate", "sampled_minibatch",
                compute, out, kc.csr_aggregate_plain(x, st.indices, rid,
                                                     edge_w, compute),
                exact if compute == "f32" else None, terms,
                {**shape, "route": route}, scale)
        route_identity(torch, failures, "csr_aggregate", "sampled_minibatch",
                       compute, kc.csr_aggregate, args, out, route)
        if route != "rows":
            failures.append(f"csr_aggregate sampled_minibatch {compute}: "
                            f"the rule took the {route} walk, not rows")
        del out
    del st, rid, edge_w, x, scale, exact
    torch.cuda.empty_cache()


def phase_sampled_train(torch, indptr, indices, cs, gen_s, rows, failures):
    """Neighbour-sampled training on the resident BA(1M, d=10) (ROADMAP
    A5): ``SAMPLED_GRAPHS`` subgraphs drawn by ``NeighborSampler`` stacked
    on the card as the CSR dataset; at TRAIN_CFG's full width, fresh
    targets, ``SAMPLED_STEPS`` fused steps (``train_mode_run``: B5 9 and
    its aggregate 8 launches a warm step, every one by the row walk, one
    warm step under the sync debug mode, one profiled, the rest timed);
    B5's aggregate on the first warm minibatch's state by both routes
    (``check_sampled_aggregate``); ``train_agent`` for one 9-step episode;
    then the resident graph solved with the trained policy (``phase_ba``,
    ``cs`` its CSR batch on the card).  Returns the dataset and the
    launches of B5 and its aggregate."""
    from repro_torch.core import CSR, Agent, PolicyConfig, get_train_step
    batch, shape = sampled_batch(torch, indptr, indices)
    t0 = time.perf_counter()
    source = CSR.prepare_dataset(batch, device=DEVICE)
    build_s = time.perf_counter() - t0
    nb, b = source.num_nodes, TRAIN_DATA[2]
    cfg = PolicyConfig(**TRAIN_CFG)
    agent = Agent(cfg, num_nodes=nb, device=DEVICE)
    agent.target_mode = "fresh"
    step = get_train_step(cfg, rep=CSR, tau=TRAIN_TAU, target_mode="fresh")
    first = {}

    def keep_first_warm(es):
        mb = cfg.minibatch
        first["tuples"] = (es.replay.graph_idx[:mb].clone(),
                           es.replay.solution[:mb].clone())
    torch.cuda.empty_cache()
    row = train_mode_run(torch, agent, step, source, "fresh", SEED + 5,
                         "csr", steps=SAMPLED_STEPS,
                         data=(SAMPLED_GRAPHS, nb, b),
                         warm_hook=keep_first_warm)
    agent.step_count = row["step_count"]
    launches = {"fused_s2v_layer_csr": sum(row["layer_launches"]),
                "csr_aggregate": sum(row["aggregate_launches"])}
    for kernel in ("layer_routes", "aggregate_routes"):
        if row[kernel]["windows"]:
            raise AssertionError(f"sampled_train: {kernel} {row[kernel]}: "
                                 f"every launch must take the row walk")
    profile = row.pop("profile")
    emit({**row, "phase": "sampled_train", **shape,
          "dataset_build_s": build_s, "episode_graphs": b, "tau": TRAIN_TAU,
          **TRAIN_CFG,
          "device_busy_share": profile["device_busy_share"],
          "profile": profile})
    check_sampled_aggregate(torch, source, first.pop("tuples"), rows,
                            failures)
    if failures:
        raise AssertionError("a kernel disagrees at the sampled minibatch:\n"
                             + "\n".join(failures))

    torch.cuda.empty_cache()
    log, counts, routes = agent_episode(agent, source, "csr", b, SEED + 3)
    if any(routes[k]["windows"] for k in launches):
        raise AssertionError(f"train_agent on the sampled dataset: routes "
                             f"{routes}: every launch must take the row walk")
    for k in launches:
        launches[k] += counts[k]
    emit({"phase": "sampled_train_agent", "steps": len(log.losses),
          "losses": log.losses, "wall_s": log.wall_time,
          "routes": {k: routes[k] for k in launches}})
    torch.cuda.empty_cache()
    launches["fused_s2v_layer_csr"] += phase_ba(
        torch, agent.params, indptr, indices, cs, gen_s,
        label="sampled_train_solve")
    return source, launches


# ---------------------------------------------------------------------------
# The mesh: gloo ranks sharing the one card.
# ---------------------------------------------------------------------------

def traced_solve(torch, policy, adj, rep, spec, dev, kernel="fused",
                 max_evals=None, max_d=None, problem="mvc"):
    """Alg. 4 as ``engine.get_solve_step`` runs it for ``problem`` (adaptive
    d up to ``max_d``, the solve's default unless given; the same scorer,
    selection, prune, commit and stop rule), recording after every
    evaluation (up to ``max_evals``) the whole batch's scores and solution
    (gathered over ``data`` on a mesh), to find where two trajectories
    part.  Never counted: only ``solve`` is the main path."""
    import functools
    from repro_torch.core import env, get_rep, init_solve_state, make_mesh
    from repro_torch.core.inference import (MAX_D, apply_selection,
                                            gather_batch)
    from repro_torch.core.mesh import all_reduce_max, normalize_spatial
    from repro_torch.core.spatial import spatial_solve_scores_fn
    r = get_rep(rep)
    max_d = max_d or MAX_D
    dp, sp = normalize_spatial(spec)
    mesh = make_mesh(dp, sp) if (dp, sp) != (1, 1) else None
    state = init_solve_state(r, adj, problem, device=dev, mesh=mesh)
    if mesh is not None and rep != "csr":
        score = spatial_solve_scores_fn(
            mesh, num_layers=2, rep=r, kernel=kernel,
            residual=env.sparse_residual_flag(problem))
    else:
        score = functools.partial(r.scores, num_layers=2, kernel=kernel)
    scores, sols = [], []
    with torch.no_grad():
        for _ in range(max_evals or state.num_nodes + max_d):
            s = score(policy, state)
            state, done, _ = apply_selection(state, s, state.candidate, True,
                                             problem, max_d)
            sc, so = gather_batch(mesh, s, state.solution)
            scores.append(sc)
            sols.append(so)
            pending = (~done).any().to(torch.int32).reshape(1)
            if mesh is not None:
                all_reduce_max(pending, mesh.data)
            if not bool(pending):
                break
    return np.stack(scores), np.stack(sols)


def serve_plans(adjs, rows):
    """The dispatch plans a sync service of ``rows`` rows per dispatch
    makes of ``adjs``, in its order."""
    from repro_torch.serving import SolveRequest, plan_batches
    return plan_batches([SolveRequest(id=i, adj=a, n=a.shape[0])
                         for i, a in enumerate(adjs)], rows)


# ---------------------------------------------------------------------------
# Async serving, open-loop load and the host loop on the mesh (ROADMAP A6b):
# run by the ranks of a mesh-phase spawn.
# ---------------------------------------------------------------------------

def record_dispatches(svc) -> list:
    """Every rank's record of the dispatches it runs, as (plan,
    responses): rank 0 plans them and the others receive the same plans;
    the solutions are all-gathered, so every rank holds rank 0's."""
    runs = []
    dispatch = svc._dispatch

    def record(plan):
        responses = dispatch(plan)
        runs.append((plan, responses))
        return responses
    svc._dispatch = record
    return runs


def lead_or_follow(mesh, svc, lead):
    """Rank 0 runs ``lead(svc)``, then closes the service; the other ranks
    follow it until it does.  Returns rank 0's result (None elsewhere)."""
    if mesh.rank != 0:
        svc.follow()
        return None
    try:
        return lead(svc)
    finally:
        svc.close()


def dispatch_summary(torch, policy, runs, want, spec, dev) -> list:
    """The recorded dispatches as the parent checks them: ids, sizes,
    answers and evaluations; where an answer differs from ``want`` (by
    request id) the dispatch's padded batch and its mesh solve traced
    (every rank holds the same plans and answers, so every rank traces
    the same dispatches, as the traced solve's collectives need)."""
    out = []
    for plan, responses in runs:
        same = all(np.array_equal(r.solution, want[r.id]) for r in responses)
        out.append({"ids": plan.request_ids, "sizes": plan.sizes,
                    "answers": [r.solution for r in responses],
                    "evals": responses[0].policy_evals,
                    "adj": None if same else plan.adj,
                    "trace": None if same else traced_solve(
                        torch, policy, plan.adj, "dense", spec, dev)})
    return out


def mesh_async_rank(torch, mesh, dev, policy, cfg, serve_adjs, sync_answers,
                    rate):
    """One rank's async half of the (2, 2) service: a warmed MVC service
    (every rank warms it) answering ``serve_adjs`` through
    ``submit_async`` on rank 0 while the others follow; then
    ``make_workload(rate, MESH_OPEN_LOOP_REQUESTS, MESH_SERVE_SIZES)``
    served by every rank (``serve()``, SPMD) and driven open-loop in both
    modes by rank 0 (``run_open_loop``), the others following.  Per run:
    the rank's launches, its plan channel's traffic, the dispatches
    (``dispatch_summary``: against the sync answers and ``serve()``'s),
    seconds, and rank 0's report."""
    from repro_torch.device import synchronize
    from repro_torch.serving import (GraphSolverService, make_workload,
                                     run_open_loop)
    spec = mesh.shape
    svc = GraphSolverService(policy, cfg, device=dev, multi_node=True,
                             max_batch=8)
    svc.warmup([a.shape[0] for a in serve_adjs])
    runs = record_dispatches(svc)
    wl = make_workload(rate, MESH_OPEN_LOOP_REQUESTS, MESH_SERVE_SIZES,
                       rho=0.15, seed=SEED)

    def drive(lead):
        runs.clear()
        synchronize(dev)
        reset_counts()
        before = dict(svc._channel.stats)
        t0 = time.perf_counter()
        result = lead_or_follow(mesh, svc, lead)
        synchronize(dev)
        return {"seconds": time.perf_counter() - t0, "counts": read_counts(),
                "channel": {k: svc._channel.stats[k] - v
                            for k, v in before.items()},
                "result": result, "compiles": svc.stats.compiles}

    out = {"rate": rate, "requests": len(wl)}
    burst = drive(lambda s: [f.result() for f in
                             [s.submit_async(a) for a in serve_adjs]])
    burst.pop("result")
    burst["dispatches"] = dispatch_summary(torch, policy, runs,
                                           dict(enumerate(sync_answers)),
                                           spec, dev)
    out["burst"] = burst
    runs.clear()
    base = [r.solution for r in svc.serve(list(wl.adjs))]
    for mode in ("async", "sync"):
        got = drive(lambda s: run_open_loop(s, wl, mode=mode).as_dict())
        got["report"] = got.pop("result")
        got["first"] = min(i for plan, _ in runs for i in plan.request_ids)
        got["dispatches"] = dispatch_summary(
            torch, policy, runs,
            {got["first"] + i: a for i, a in enumerate(base)}, spec, dev)
        out["open_loop", mode] = got
    return out


def mesh_host_run(torch, weights, data, dev, rep, spatial, *, cfg, tau, b,
                  steps, eval_fn=None):
    """``train_agent(engine="host")`` of MVC on ``data`` (host graphs) at
    epsilon 1, fresh targets, for ``steps`` steps of one episode of ``b``
    graphs from seed SEED + 23, on one device (``spatial`` 0) or on this
    rank of the ``spatial`` mesh.  Returns the agent and its log."""
    from repro_torch.convert import policy_from_numpy
    from repro_torch.core import Agent, PolicyConfig, train_agent
    cfg = PolicyConfig(**cfg, eps_start=1.0, eps_end=1.0, spatial=spatial)
    agent = Agent(cfg, num_nodes=data.shape[-1], device=dev,
                  params=policy_from_numpy(weights, device=dev))
    log = train_agent(agent, data, rep=rep, episodes=1, max_steps=steps,
                      tau=tau, batch_graphs=b, seed=SEED + 23,
                      engine="host", eval_every=1, eval_fn=eval_fn)
    return agent, log


def mesh_host_small(torch, weights, adj, dev, rep, spatial=0) -> dict:
    """The host loop's small lockstep run (MESH_SMALL_CFG, MESH_SMALL_RUN)
    on ``adj``: losses, the replay's tuples and the trained weights.
    Never counted: the full-width run is the main path."""
    b, tau, steps = MESH_SMALL_RUN
    agent, log = mesh_host_run(torch, weights, adj, dev, rep, spatial,
                               cfg=MESH_SMALL_CFG, tau=tau, b=b, steps=steps)
    ring = agent.replay
    return {"losses": np.array(log.losses),
            "ring": {f: getattr(ring, f)[:ring.size].copy() for f in
                     ("graph_idx", "solution", "action", "reward",
                      "next_solution", "done")},
            "params": flat_params(torch, agent.params)}


def mesh_host_full(torch, mesh, dev, weights, data) -> dict:
    """One rank's host loop at MESH_HOST_FULL's cell: MESH_HOST_STEPS steps
    (TRAIN_CFG, TRAIN_TAU, TRAIN_DATA's episode graphs), each step's
    seconds and kernel launches, the losses and the peak device bytes;
    the step after the first warm one with the synchronizing calls made
    on this thread counted (``main_thread_syncs`` in "warn" mode, as
    ``mesh_full_run``), then one deliberate host read, the control."""
    from repro_torch.device import synchronize
    marks, counted = [], {}
    checked = MESH_HOST_WARM_FROM + 1
    window = main_thread_syncs(torch)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    def mark(_agent):
        if len(marks) == checked:          # the counted step ends here
            syncs = counted["syncs"]
            counted["where"] = syncs(where=True)
            torch.zeros((), device=dev).item()
            counted["control"] = len(syncs()) - len(counted["where"])
            window.__exit__(None, None, None)
        synchronize(dev)
        marks.append((time.perf_counter(), read_counts()))
        reset_counts()
        if len(marks) == checked:          # the counted step starts
            counted["syncs"] = window.__enter__()
        return 0.0
    synchronize(dev)
    reset_counts()
    t0 = time.perf_counter()
    _, log = mesh_host_run(torch, weights, data, dev, "dense", mesh.shape,
                           cfg=TRAIN_CFG, tau=TRAIN_TAU, b=TRAIN_DATA[2],
                           steps=MESH_HOST_STEPS, eval_fn=mark)
    times = [t0] + [m[0] for m in marks]
    where = counted.get("where") or []
    return {"seconds": [b - a for a, b in zip(times, times[1:])],
            "counts": [m[1] for m in marks],
            "syncs": len(where),
            "syncs_by_line": {k: where.count(k) for k in sorted(set(where))},
            "control_syncs": counted.get("control"),
            "losses": list(log.losses),
            "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if on_card else 0)}


def mesh_rank(mesh, dev, weights, adj, refs, serve, train, paper):
    """One rank of a mesh-phase spawn: full solves of the (8, 256) batch
    on dense and sparse (CSR too at sp = 1; the sparse "xla" chain at
    (1, 2)), of MVC and then of MaxCut, MIS and MDS, each counted, then
    traced: in full where its answers or evaluation count differ from
    the single-device ones (``refs``), else for the first evaluation's
    scores; at (2, 2) the sync service of MVC and of
    MESH_SERVICE_PROBLEMS on ``serve`` (the graphs and the single-device
    answers by problem), then its async half (``mesh_async_rank``); the
    train runs of ``train`` (the small lockstep's cases with their draws,
    the full-width (problem, rep) runs on their saved data, the host
    loop's small runs on ``train["host_small"]``'s reps and, where
    ``train["host_full"]``, its full-width run); then the paper-scale
    solves of ``paper``, those it names under ``trace`` traced too.  Each
    service is closed before the next collective: no collective runs
    beside a service that leads or follows."""
    import torch
    from repro_torch.convert import policy_from_numpy
    from repro_torch.core import PolicyConfig, SparseGraphBatch, solve
    from repro_torch.device import synchronize
    from repro_torch.serving import GraphSolverService
    policy = policy_from_numpy(weights, device=dev)
    on_card = dev.type == "cuda"
    spec = mesh.shape
    out = {"rank": mesh.rank, "runs": []}
    reps = ("dense", "sparse") + (("csr",) if spec[1] == 1 else ())
    runs = [("mvc", rep, "fused") for rep in reps]
    if spec == (1, 2):
        runs.append(("mvc", "sparse", "xla"))
    runs += [(p, rep, "fused") for p in PROBLEMS for rep in reps]
    for problem, rep, kernel in runs:
        synchronize(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = solve(policy, adj, num_layers=2, multi_node=True, rep=rep,
                    kernel=kernel, problem=problem, spatial=spec, device=dev)
        solve_s = time.perf_counter() - t0
        counts = read_counts()
        want, want_evals = refs[problem, rep, kernel]
        same = (np.array_equal(res.solution, want)
                and res.policy_evals == want_evals)
        trace = traced_solve(torch, policy, adj, rep, spec, dev, kernel,
                             max_evals=1 if same else None, problem=problem)
        out["runs"].append({"problem": problem, "rep": rep, "kernel": kernel,
                            "solution": res.solution,
                            "evals": res.policy_evals,
                            "committed": res.nodes_committed,
                            "counts": counts, "solve_s": solve_s,
                            "trace": trace})
    if serve is not None:
        serve_adjs, ref_answers = serve
        out["service"] = {}
        for problem, answers in ref_answers.items():
            svc = GraphSolverService(
                policy, PolicyConfig(embed_dim=32, num_layers=2,
                                     spatial=spec),
                device=dev, multi_node=True, max_batch=8)
            svc.warmup([a.shape[0] for a in serve_adjs], problems=[problem])
            synchronize(dev)
            reset_counts()
            t0 = time.perf_counter()
            responses = svc.serve(serve_adjs, problem=problem)
            synchronize(dev)
            serve_s = time.perf_counter() - t0
            counts = read_counts()
            plans = []
            for p in serve_plans(serve_adjs, svc.rows_per_dispatch):
                same = all(np.array_equal(responses[i].solution, answers[i])
                           for i in p.request_ids)
                plans.append((p.request_ids, p.sizes, None if same else
                              traced_solve(torch, policy, p.adj, "dense",
                                           spec, dev, problem=problem)))
            out["service"][problem] = {
                "counts": counts, "stats": svc.stats.as_dict(),
                "serve_s": serve_s,
                "answers": [r.solution for r in responses],
                "batch_evals": sorted({
                    (r.bucket, r.dispatch_t): r.policy_evals
                    for r in responses}.values()),
                "plans": plans}
        # the async half: rank 0 plans, at twice the sync burst's rate
        # (rank 0's clock sets it; the other ranks follow its plans)
        sync = out["service"]["mvc"]
        t0 = time.perf_counter()
        out["async"] = mesh_async_rank(
            torch, mesh, dev, policy,
            PolicyConfig(embed_dim=32, num_layers=2, spatial=spec),
            serve_adjs, sync["answers"],
            MESH_OPEN_LOOP_FACTOR * len(serve_adjs) / sync["serve_s"])
        out["a6b_s"] = {"async": time.perf_counter() - t0}
    if train is not None:
        out["train_small"] = {
            case: mesh_lockstep_run(torch, train["weights"], adj,
                                    train["draws"], dev, *case, mesh=mesh)
            for case in train["small"]}
        out["train_full"] = {}
        for problem, rep in train["full"]:
            if on_card:
                torch.cuda.empty_cache()
            out["train_full"][problem, rep] = mesh_full_run(
                torch, mesh, dev, train["weights"], rep,
                load_dataset(torch, train["data"][rep]), problem)
        t0 = time.perf_counter()
        out["host_small"] = {
            rep: mesh_host_small(torch, train["weights"], adj, dev, rep,
                                 spec) for rep in train["host_small"]}
        if train["host_full"]:
            if on_card:
                torch.cuda.empty_cache()
            out["host_full"] = mesh_host_full(
                torch, mesh, dev, train["weights"],
                load_dataset(torch, train["data"]["dense"]))
        out.setdefault("a6b_s", {})["host"] = time.perf_counter() - t0
    for rep in (paper or {}).get("reps", ()):
        if rep == "dense":
            graph = np.load(paper["dense"], mmap_mode="c")
        else:
            graph = SparseGraphBatch(*(torch.from_numpy(np.load(
                paper[f], mmap_mode="c")) for f in ("neighbors", "valid")))
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        synchronize(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = solve(policy, graph, num_layers=2, multi_node=True,
                    max_d=paper["max_d"], rep=rep, spatial=spec, device=dev)
        out["paper", rep] = {
            "solve_s": time.perf_counter() - t0,
            "solution": res.solution[0], "evals": res.policy_evals,
            "counts": read_counts(),
            "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if on_card else 0)}
        if rep in paper.get("trace", ()):
            del res
            out["paper", rep]["trace"] = traced_solve(
                torch, policy, graph, rep, spec, dev, max_d=paper["max_d"])
        if on_card and rep == "dense" and spec == (1, 2):
            # where a mesh evaluation's time goes, on each rank
            from repro_torch.core import (DENSE, get_solve_step,
                                          init_solve_state, make_mesh)
            step = get_solve_step(rep=DENSE, use_adaptive=True,
                                  num_layers=2, spatial=spec,
                                  max_d=paper["max_d"])
            state = init_solve_state(DENSE, graph, device=dev,
                                     mesh=make_mesh(*spec))
            out["profile"] = profile_solve(torch, step, policy, state, 20)
        del graph
    return out


def parting(ref, got, tol=1e-5):
    """Where two traced trajectories (scores, solutions) of one batch
    part, graph by graph.  Each graph's first evaluation whose commit
    differs gives the nodes only one side selected; the trajectories part
    at a near-tie when every such pair's scores lie within 2·tol·(1 +
    |score|) of each other on both sides.  Returns the cases (none when
    every graph's trajectory is identical) and whether all are
    near-ties."""
    (s0, x0), (s1, x1) = ref, got
    cases, all_near = [], True
    for g in range(x0.shape[1]):
        prev = np.zeros_like(x0[0, g])
        t_end = min(len(x0), len(x1))
        for t in range(t_end + 1):
            a = x0[min(t, len(x0) - 1), g]
            b = x1[min(t, len(x1) - 1), g]
            if np.array_equal(a, b):
                if t == t_end:
                    break
                prev = a
                continue
            only0 = np.flatnonzero((a - prev) > (b - prev))
            only1 = np.flatnonzero((b - prev) > (a - prev))
            tt = min(t, t_end - 1)
            gap, scale = np.inf, 1.0
            if len(only0) and len(only1):
                gap = max(abs(float(sc[tt, g, u] - sc[tt, g, v]))
                          for sc in (s0, s1) for u in only0 for v in only1)
                scale = 1 + max(abs(float(sc[tt, g, w])) for sc in (s0, s1)
                                for w in np.concatenate([only0, only1]))
            near = gap <= 2 * tol * scale
            all_near &= near
            cases.append({"graph": g, "eval": t, "only_ref": only0.tolist(),
                          "only_mesh": only1.tolist(), "boundary_gap": gap,
                          "scores_ref": [float(s0[tt, g, w]) for w in
                                         np.concatenate([only0, only1])],
                          "scores_mesh": [float(s1[tt, g, w]) for w in
                                          np.concatenate([only0, only1])],
                          "near_tie": bool(near)})
            break
    return cases, all_near


def bucket_batch():
    """A full bucket: 8 ER(4000, 0.15) graphs padded to 4096 nodes."""
    from repro_torch.core.graphs import random_graph_batch
    from repro_torch.serving import pad_adjacency
    b, nb, n = BUCKET
    return np.stack([pad_adjacency(a, nb) for a in random_graph_batch(
        "er", n, b, seed=SEED + nb, rho=0.15)])


def bucket_rep(name):
    from repro_torch.core import DENSE, CsrRep, SparseRep
    return {"dense": DENSE, "sparse": SparseRep(SPARSE_MAX_DEGREE),
            "csr": CsrRep(CSR_MAX_EDGES)}[name]


def phase_xla_chain(torch, policy, batch):
    """Phase 4, sparse "xla" chain on a full 4096-node bucket: no layer-0
    elision, so the aggregation kernel runs twice per evaluation."""
    from repro_torch.core import solve
    reset_counts()
    t0 = time.perf_counter()
    res = solve(policy, batch, num_layers=2, multi_node=True,
                rep=bucket_rep("sparse"), kernel="xla", device=DEVICE)
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["sparse_mp_aggregate"]
    for g in range(batch.shape[0]):
        if not is_cover(batch[g], res.solution[g]):
            raise AssertionError(f"xla-chain solve of graph {g} is no cover")
    if launches != 2 * res.policy_evals:
        raise AssertionError(f"sparse xla chain: {launches} aggregation "
                             f"launches for {res.policy_evals} evaluations")
    emit({"phase": "sparse_xla_chain", "B": batch.shape[0],
          "N": batch.shape[1],
          "policy_evals": res.policy_evals, "kernel_launches": counts,
          "solve_s": solve_s, "cover_sizes": res.sizes.tolist()})
    return launches


def profile_solve(torch, step, policy, state, evals):
    """``evals`` evaluations of a solve step under torch.profiler: wall ms
    and device ms per evaluation, the device's busy share, and the ten
    kernels with the most device time."""
    (_, ran, _), prof, wall = profile_call(
        torch, lambda: step(policy, state, evals))
    rows, busy_us = kernel_rows(torch, prof)
    return {"evals": ran, "wall_ms_per_eval": 1e3 * wall / ran,
            "device_ms_per_eval": busy_us / 1e3 / ran,
            "device_busy_share": busy_us / 1e6 / wall,
            "top": [{"name": k[:60], "calls": c,
                     "ms_per_eval": us / 1e3 / ran}
                    for us, c, k in rows[:10]]}


def phase_profile(torch, policy, batch, rep):
    """Where one evaluation's time goes: 20 evaluations of the solve loop
    on a full (8, 4096) bucket under torch.profiler, device time by kernel
    and the device's busy share of the wall time."""
    from repro_torch.core import get_solve_step, init_solve_state
    r = bucket_rep(rep)
    step = get_solve_step(rep=r, use_adaptive=True, num_layers=2)
    step(policy, init_solve_state(r, batch, device=DEVICE), 3)   # warm
    state = init_solve_state(r, batch, device=DEVICE)
    emit({"phase": "profile", "rep": rep, "B": batch.shape[0],
          "N": batch.shape[1],
          **profile_solve(torch, step, policy, state, 20)})


# ---------------------------------------------------------------------------
# Timing.
# ---------------------------------------------------------------------------

def timing_dense(torch, ks, dev):
    """Dense layer times at the serving, train-minibatch and paper
    shapes."""
    entries = {}
    for label, b, k, n in (("serving", BUCKET[0], 32, BUCKET[1]),
                           ("minibatch", TRAIN_CFG["minibatch"], 32,
                            TRAIN_DATA[1]),
                           ("paper", 1, 32, PAPER_N)):
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
        emit({"phase": "timing", "kernel": "fused_s2v_layer", "shape": label,
              **row})
        del t4, embed, adj, base
        torch.cuda.empty_cache()
    return entries["serving"]


def timing_agg(torch, ks, dev):
    """Kernel 2's times at the row blocks of the bound table: a serving
    bucket and the paper-scale graph at sp = 2 and 4; the kernels line
    takes the serving bucket at sp = 2.  Library: torch.bmm (cuBLAS)."""
    entries = {}
    for name, b, k, nl, n, rho in AGG_CASES[2:]:
        embed, adj = agg_inputs(torch, b, k, nl, n, rho, SEED, dev)
        row = {"B": b, "K": k, "Nl": nl, "N": n}
        row["bound_ms"], row["bound_by"] = agg_bound(b, k, nl, n)
        for compute in ("f32", "bf16"):
            row[f"ms_{compute}"] = cuda_ms(
                torch, lambda: ks.mp_aggregate(embed, adj, compute))
        row["plain_ms"] = cuda_ms(
            torch, lambda: ks.mp_aggregate_plain(embed, adj, "f32"))
        row["library_ms"] = cuda_ms(torch, lambda: torch.bmm(embed, adj))
        entries[name] = row
        emit({"phase": "timing", "kernel": "mp_aggregate", "shape": name,
              **row})
        del embed, adj
        torch.cuda.empty_cache()
    return entries["serving_sp2"]


def library_rows(torch, nbr, edge, np1):
    """Neighbour lists (B, Nl, D) with their factors as one (B·Nl, B·np1)
    torch.sparse_csr_tensor, every slot stored (built outside the
    timing): the library form of kernel 4 on a row block."""
    b, nl, d = nbr.shape
    dev = nbr.device
    crow = torch.arange(0, b * nl * d + 1, d, device=dev)
    cols = (nbr.long() + np1 * torch.arange(b, device=dev)[:, None, None])
    return torch.sparse_csr_tensor(crow, cols.reshape(-1), edge.reshape(-1),
                                   size=(b * nl, b * np1))


def library_csr(torch, cs, edge_w):
    """The batch as one block-diagonal (B·N, B·N) torch.sparse_csr_tensor
    of its real edges, weighted by ``edge_w`` (built outside the timing)."""
    b, n = cs.batch, cs.num_nodes
    counts = (cs.indptr[:, -1]).long()
    keep = cs.edge_mask
    cols = (cs.indices.long() + n * torch.arange(b, device=cs.device)[:, None])
    crow = torch.cat([torch.zeros(1, dtype=torch.long, device=cs.device),
                      (cs.indptr[:, 1:].long()
                       + torch.cumsum(counts, 0)[:, None] - counts[:, None]
                       ).reshape(-1)])
    return torch.sparse_csr_tensor(crow, cols[keep], edge_w[keep],
                                   size=(b * n, b * n))


def layer_times(torch, fn, args, row):
    """A routed kernel's times on one case into ``row``: ``ms_f32`` and
    ``ms_bf16`` by the route the rule picks (``route``) and, where the
    wrapper can be forced, each route's (``ms_<compute>_<route>``)."""
    _, route = call_routed(fn, *args, "f32")
    row["route"] = route
    forced = walks(fn) if route is not None else ()
    for compute in ("f32", "bf16"):
        for w in forced:
            row[f"ms_{compute}_{w}"] = cuda_ms(
                torch, lambda: fn(*args, compute, walk=w))
        row[f"ms_{compute}"] = (row[f"ms_{compute}_{route}"] if forced else
                                cuda_ms(torch, lambda: fn(*args, compute)))


def graph_timing(torch, case, label, extra=None,
                 names=GRAPH_LAYERS + GRAPH_AGGREGATES):
    """Kernels 3, 4 and 5 (those in ``names``) on one graph case: kernel
    (the wrapper, its node-major copy of x included; both routes of the
    layers), plain version and library yardstick (cuSPARSE SpMM through
    torch.sparse.mm, then theta4, base and ReLU)."""
    ks, _, kc = kernel_modules()
    sp, cs, x, base, t4 = (case[f] for f in ("sp", "cs", "x", "base", "t4"))
    edge, edge_w = case["edge"], case["edge_w"]
    b, k, n = x.shape
    out = {}
    spmm = library_spmm(torch, case)

    def library_layer():
        return torch.relu(base + torch.einsum("kj,bjn->bkn", t4, spmm()))

    nnz_csr = int(cs.indptr[:, -1].sum())
    if sp is not None and "fused_s2v_layer_sparse" in names:
        d = sp.max_degree
        nnz = int(sp.valid.sum())
        slots = 8 * b * n * d
        row = {"B": b, "K": k, "N": n, "D": d}
        row["bound_ms"], row["bound_by"] = bound(
            4 * (k * k + 3 * b * k * n) + slots, 2 * k * nnz + 2 * b * k * k * n)
        args = (t4, x, sp.neighbors, edge, base)
        layer_times(torch, ks.fused_s2v_layer_sparse, args, row)
        row["plain_ms"] = cuda_ms(
            torch, lambda: ks.fused_s2v_layer_sparse_plain(*args, "f32"))
        row["library_ms"] = cuda_ms(torch, library_layer)
        out["fused_s2v_layer_sparse"] = row
        emit({"phase": "timing", "kernel": "fused_s2v_layer_sparse",
              "shape": label, **row})
    if sp is not None and "sparse_mp_aggregate" in names:
        out["sparse_mp_aggregate"] = timing_sparse_aggregate(
            torch, case, label, spmm)
    if "csr_aggregate" in names:
        out["csr_aggregate"] = timing_csr_aggregate(torch, case, label, spmm)
    if "fused_s2v_layer_csr" in names:
        row = {"B": b, "K": k, "N": n, "E": cs.num_edges, "edges": nnz_csr,
               **(extra or {})}
        # indptr, the real edges' (id, factor), x, base, theta4 in; out
        row["bound_ms"], row["bound_by"] = bound(
            4 * (k * k + b * (n + 1) + 3 * b * k * n) + 8 * nnz_csr,
            2 * k * nnz_csr + 2 * b * k * k * n)
        args = (t4, x, cs.indices, cs.indptr, edge_w, base)
        layer_times(torch, kc.fused_s2v_layer_csr, args, row)
        row["plain_ms"] = cuda_ms(
            torch, lambda: kc.fused_s2v_layer_csr_plain(*args, "f32"))
        row["library_ms"] = cuda_ms(torch, library_layer)
        out["fused_s2v_layer_csr"] = row
        emit({"phase": "timing", "kernel": "fused_s2v_layer_csr",
              "shape": label, **row})
    del spmm
    torch.cuda.empty_cache()
    return out


# (B, N, list widths) of the route sweep: the serving bucket's B and N,
# and the paper-scale graph's, each at list widths from well below to
# above the windows' bytes
ROUTE_SWEEP = ((8, 4096, (64, 128, 256, 512, 768)),
               (1, PAPER_N, (256, 512, 1024, 2048, 3274)))


def route_sweep(torch, dev):
    """Both routes of kernels 3 and 5 (f32) on random lists of one width
    D for every node (ids ascending, drawn from [0, N); the CSR batch is
    the same lists as rows of D edges), at the ``ROUTE_SWEEP`` shapes,
    beside the rule's choice and the two byte counts it compares: the
    measurement behind ``walk.WINDOW_RATIO``."""
    from repro_torch.kernels import walk
    ks, _, kc = kernel_modules()
    k = 32
    for b, n, widths in ROUTE_SWEEP:
        g = torch.Generator(device=dev).manual_seed(SEED + 23 + n)
        x = torch.relu(torch.rand((b, k, n), generator=g, device=dev) - 0.5)
        base = torch.rand((b, k, n), generator=g, device=dev) - 0.5
        t4 = (torch.rand((k, k), generator=g, device=dev) - 0.5) * 0.2
        indptr = (torch.arange(n + 1, device=dev, dtype=torch.int32)
                  [None].expand(b, n + 1))
        for d in widths:
            nbr = torch.sort(torch.randint(0, n, (b, n, d), generator=g,
                                           device=dev, dtype=torch.int32),
                             dim=-1).values
            edge = torch.rand((b, n, d), generator=g, device=dev)
            row = {"B": b, "K": k, "N": n, "D": d,
                   "window_bytes": walk.window_bytes(b, k, n, n),
                   "list_bytes": 8 * b * n * d,
                   "rule": walk.walk_route(b, k, n, n, b * n * d)}
            row["ratio"] = row["window_bytes"] / row["list_bytes"]
            csr = (t4, x, nbr.reshape(b, n * d), (indptr * d).contiguous(),
                   edge.reshape(b, n * d), base)
            for kernel, fn, args in (
                    ("fused_s2v_layer_sparse", ks.fused_s2v_layer_sparse,
                     (t4, x, nbr, edge, base)),
                    ("fused_s2v_layer_csr", kc.fused_s2v_layer_csr, csr)):
                for w in WALKS:
                    row[f"{kernel}_ms_{w}"] = cuda_ms(
                        torch, lambda: fn(*args, "f32", walk=w))
            emit({"phase": "route_sweep", **row})
            del nbr, edge, csr
            torch.cuda.empty_cache()


def library_spmm(torch, case):
    """The library form of kernel 4 on a graph case: cuSPARSE SpMM
    through torch.sparse.mm over the batch's block-diagonal CSR matrix
    (built here, outside the timing), giving (B, K, N)."""
    x = case["x"]
    b, k, n = x.shape
    a = library_csr(torch, case["cs"], case["edge_w"])

    def spmm():
        xt = x.transpose(1, 2).reshape(b * n, k)
        return torch.sparse.mm(a, xt).reshape(b, n, k).transpose(1, 2)
    return spmm


def timing_sparse_aggregate(torch, case, label, spmm):
    """Kernel 4 on a graph case (the wrapper, its node-major copy of x
    included), its plain version and the library ``spmm``; at the serving
    case also a graph rank's row block at sp = 2 against the whole x."""
    _, kg, _ = kernel_modules()
    sp, x, edge = case["sp"], case["x"], case["edge"]
    b, k, n = x.shape
    d = sp.max_degree
    xp = torch.nn.functional.pad(x, (0, 1))
    row = {"B": b, "K": k, "N": n, "D": d}
    # x and the (id, factor) lists in, out; 2·K FLOPs per valid slot
    row["bound_ms"], row["bound_by"] = bound(
        4 * (b * k * (n + 1) + b * k * n) + 8 * b * n * d,
        2 * k * int(sp.valid.sum()))
    args = (xp, sp.neighbors, edge)
    for compute, plain in (("f32", "plain_ms"), ("bf16", "plain_ms_bf16")):
        row[f"ms_{compute}"] = cuda_ms(
            torch, lambda: kg.sparse_mp_aggregate(*args, compute))
        row[plain] = cuda_ms(
            torch, lambda: kg.sparse_mp_aggregate_plain(*args, compute))
    row["library_ms"] = cuda_ms(torch, spmm)
    emit({"phase": "timing", "kernel": "sparse_mp_aggregate",
          "shape": label, **row})
    if label == "serving":
        nl = n // 2
        args = (xp, sp.neighbors[:, nl:].contiguous(),
                edge[:, nl:].contiguous())
        part = {"B": b, "K": k, "N": n, "Nl": nl, "D": d}
        part["bound_ms"], part["bound_by"] = bound(
            4 * (b * k * (n + 1) + b * k * nl) + 8 * b * nl * d,
            2 * k * int(sp.valid[:, nl:].sum()))
        part["ms_f32"] = cuda_ms(torch,
                                 lambda: kg.sparse_mp_aggregate(*args))
        part["plain_ms"] = cuda_ms(
            torch, lambda: kg.sparse_mp_aggregate_plain(*args))
        a_rows = library_rows(torch, args[1], args[2], n + 1)
        xt = xp.transpose(1, 2).reshape(b * (n + 1), k)
        part["library_ms"] = cuda_ms(torch, lambda: torch.sparse.mm(
            a_rows, xt).reshape(b, nl, k).transpose(1, 2))
        emit({"phase": "timing", "kernel": "sparse_mp_aggregate",
              "shape": "serving_rows_sp2", **part})
    return row


def timing_csr_aggregate(torch, case, label, spmm):
    """B5's aggregate entry on a graph case (the wrapper, its node-major
    copy of x included) at f32 and bf16, by the route the rule picks and
    by each route forced (``layer_times``), its plain version (row ids made
    outside the timing) and the library ``spmm``, which computes the f32
    function."""
    from repro_torch.core.graphs import csr_row_ids
    _, _, kc = kernel_modules()
    cs, x, edge_w = case["cs"], case["x"], case["edge_w"]
    b, k, n = x.shape
    nnz = int(cs.indptr[:, -1].sum())
    row = {"B": b, "K": k, "N": n, "E": cs.num_edges, "edges": nnz}
    # indptr, the real edges' (id, factor) and x in, out; 2·K FLOPs an edge
    row["bound_ms"], row["bound_by"] = bound(
        4 * (b * (n + 1) + 2 * b * k * n) + 8 * nnz, 2 * k * nnz)
    args = (x, cs.indices, cs.indptr, edge_w)
    rid = csr_row_ids(cs.indptr, cs.num_edges)
    layer_times(torch, kc.csr_aggregate, args, row)
    for compute, plain in (("f32", "plain_ms"), ("bf16", "plain_ms_bf16")):
        row[plain] = cuda_ms(torch, lambda: kc.csr_aggregate_plain(
            x, cs.indices, rid, edge_w, compute))
    row["library_ms"] = cuda_ms(torch, spmm)
    emit({"phase": "timing", "kernel": "csr_aggregate", "shape": label,
          **row})
    return row


def phase_timing(torch, ks, dev, ba_cs,
                 names=GRAPH_LAYERS + GRAPH_AGGREGATES, sampled=None):
    """Phase 5: device times beside the bound for the graph kernels among
    ``names``, at the serving shape (the kernels line) and at paper scale
    (diagnostic lines), BA(1M) for the CSR layer (``ba_cs``, when given)
    and the sampled minibatch for the CSR aggregate (``sampled``, the 64
    subgraphs of BA(1M), when given)."""
    rows = {}
    if "fused_s2v_layer" in names:
        rows["fused_s2v_layer"] = timing_dense(torch, ks, dev)
    if "mp_aggregate" in names:
        rows["mp_aggregate"] = timing_agg(torch, ks, dev)
    graph = [n for n in names
             if n in ROUTED + ("sparse_mp_aggregate", "csr_aggregate")]
    if graph:
        for label, b, n, real, width, edges in (
                ("serving", *BUCKET, SPARSE_MAX_DEGREE, CSR_MAX_EDGES),
                ("paper", 1, PAPER_N, None, None, None)):
            case = graph_case(torch, dev, b, 32, n, 0.15, SEED + 11 * n, real,
                              width, edges)
            del case["agg64"], case["w"]
            timed = graph_timing(torch, case, label, names=graph)
            if label == "serving":
                rows.update(timed)
            del case
            torch.cuda.empty_cache()
    if ba_cs is not None and "fused_s2v_layer_csr" in names:
        graph_timing(torch, ba_case(torch, dev, ba_cs, SEED + 2), "ba1m",
                     {"max_row": int((ba_cs.indptr[:, 1:]
                                      - ba_cs.indptr[:, :-1]).max())},
                     names=("fused_s2v_layer_csr",))
    if sampled is not None and "csr_aggregate" in names:
        graph_timing(torch, ba_case(torch, dev, sampled, SEED + 3),
                     "sampled_minibatch", names=("csr_aggregate",))
    return rows


REPLACES = {
    "fused_s2v_layer": ("src/repro_torch/kernels/csrc/s2v_fused.cu",
                        "src/repro/kernels/s2v_fused.py:66"),
    "mp_aggregate": ("src/repro_torch/kernels/csrc/s2v_fused.cu",
                     "src/repro/kernels/s2v_fused.py:126"),
    "fused_s2v_layer_sparse": ("src/repro_torch/kernels/csrc/s2v_gather.cu",
                               "src/repro/kernels/s2v_fused.py:193"),
    "sparse_mp_aggregate": ("src/repro_torch/kernels/csrc/s2v_gather.cu",
                            "src/repro/kernels/s2v_gather.py:53"),
    "fused_s2v_layer_csr": ("src/repro_torch/kernels/csrc/s2v_csr.cu",
                            "src/repro/kernels/s2v_csr.py:83"),
    "csr_aggregate": ("src/repro_torch/kernels/csrc/s2v_csr.cu",
                      "src/repro/kernels/s2v_csr.py:83"),
    "wkv6_chunked": ("src/repro_torch/kernels/csrc/wkv6.cu",
                     "src/repro/kernels/wkv6.py:75"),
    "swa_attention": ("src/repro_torch/kernels/csrc/swa.cu",
                      "src/repro/kernels/swa.py:69"),
    "grouped_glu_ffn": ("src/repro_torch/kernels/csrc/moe_gemm.cu",
                        "src/repro/kernels/moe_gemm.py:67"),
}


def print_card() -> None:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


USAGE = ("usage: python3 chip_smoke.py [--only <kernel>,...]\n"
         "  kernels: " + ", ".join(REPLACES))


def parse_args(args):
    """None for the full run (no arguments); for ``--only <kernel>,...``
    the named kernels (``REPLACES``' keys) in ``REPLACES``' order.  Raises
    ValueError on anything else: an unknown or empty name, or another
    flag."""
    if not args:
        return None
    if len(args) != 2 or args[0] != "--only":
        raise ValueError(f"unknown arguments {args}")
    parts = args[1].split(",")
    if not all(parts):
        raise ValueError(f"an empty kernel name in {args[1]!r}")
    unknown = [p for p in parts if p not in REPLACES]
    if unknown:
        raise ValueError(f"unknown kernels {unknown}")
    return [name for name in REPLACES if name in parts]


def run_only(torch, ks, dev, names) -> None:
    """``--only``: the loop for work on the named kernels.  Phase 1's
    checks of those kernels with their gates (the graph kernels' on every
    graph case, the CSR layer's also on BA(1M), whose host generation runs
    on a thread beside the checks), then their times (the CSR aggregate's
    also at the sampled minibatch, 64 subgraphs of BA(1M), both routes),
    and for the sparse and CSR layers the route sweep.  No served path,
    so it prints no kernels line and no result line.  It calls only
    wrapper APIs that checkouts before the windowed layers have, besides
    ``walk=`` where a wrapper takes it (and the sampler where the
    checkout has one), so it also times a parent checkout's kernels."""
    import repro_torch.core
    from repro_torch.core.graphs import csr_batch_from_arrays
    ba_pool = ba_cs = sampled = None
    # the sampled minibatch needs the sampler, which older checkouts lack
    sample = ("csr_aggregate" in names
              and hasattr(repro_torch.core, "NeighborSampler"))
    if "fused_s2v_layer_csr" in names or sample:
        ba_pool = concurrent.futures.ThreadPoolExecutor(1)
        ba_future = ba_pool.submit(ba_arrays)
    rows, failures = [], []
    lm = [n for n in names if n in LM_KERNELS]
    with timed_phase("kernel_vs_plain"):
        if "fused_s2v_layer" in names:
            phase_kernel(torch, ks, dev, rows, failures)
        if "mp_aggregate" in names:
            phase_agg_kernel(torch, ks, dev, rows, failures)
        phase_graph_kernels(torch, dev, rows, failures, names)
        inputs = lm_inputs(torch, dev, lm)
        lm_checks(torch, dev, rows, failures, lm, inputs)
        if ba_pool is not None:
            indptr, indices, _ = ba_future.result()
            ba_pool.shutdown()
            if sample:
                sampled, shape = sampled_batch(torch, indptr, indices)
                emit({"phase": "sampled_minibatch", **shape})
            if "fused_s2v_layer_csr" in names:
                ba_cs = csr_batch_from_arrays(indptr, indices, device=DEVICE)
                ba_kernel_check(torch, dev, ba_cs, rows, failures)
            del indptr, indices
    if failures:
        raise AssertionError("a kernel disagrees with its plain version, "
                             "f64 or another kernel:\n" + "\n".join(failures))
    with timed_phase("timing"):
        phase_timing(torch, ks, dev, ba_cs, names, sampled)
        del ba_cs, sampled
        torch.cuda.empty_cache()
        if set(names) & set(ROUTED) and walks(ks.fused_s2v_layer_sparse):
            route_sweep(torch, dev)
        lm_timing(torch, dev, lm, inputs)


def main(argv=None) -> int:
    try:
        only = parse_args(sys.argv[1:] if argv is None else argv)
    except ValueError as e:
        print(f"chip_smoke: {e}\n{USAGE}", file=sys.stderr)
        return 2
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
    from repro_torch.core.graphs import erdos_renyi
    from repro_torch.kernels import build

    dev = torch.device(DEVICE)
    ks, _, _ = kernel_modules()
    t_all = time.perf_counter()
    with timed_phase("build"):
        t0 = time.perf_counter()
        sources = build.sources()
        for name in sources:       # the first load builds all, one nvcc each
            build.load(name)
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "ptxas": {name: [ln.strip() for ln in
                               build.build_log(name).splitlines()
                               if "registers" in ln or "spill" in ln]
                        for name in sources}})

    if only is not None:
        run_only(torch, ks, dev, only)
        print_card()
        return 0

    from repro_torch.core.graphs import csr_batch_from_arrays
    ba_pool = concurrent.futures.ThreadPoolExecutor(1)
    ba_future = ba_pool.submit(ba_arrays)    # host work beside phases 1-3
    rows, failures = [], []
    with timed_phase("kernel_vs_plain"):
        phase_kernel(torch, ks, dev, rows, failures)
        phase_agg_kernel(torch, ks, dev, rows, failures)
        phase_graph_kernels(torch, dev, rows, failures)
    if failures:
        raise AssertionError("a kernel disagrees with its plain version:\n"
                             + "\n".join(failures))
    with timed_phase("lm_kernels"):
        lm_launches, lm_timing = phase_lm_kernels(torch, dev, rows, failures)
    if failures:
        raise AssertionError("an LM kernel disagrees with its plain version "
                             "or with f64:\n" + "\n".join(failures))

    cfg = PolicyConfig(embed_dim=32, num_layers=2)
    policy = init_policy(cfg, generator=torch.Generator().manual_seed(
        SEED), device=DEVICE)
    rng = np.random.default_rng(SEED)
    sizes = rng.permutation(np.tile(SERVE_SIZES, 4))    # 16 requests
    adjs = [erdos_renyi(int(n), 0.15, seed=1000 + i)
            for i, n in enumerate(sizes)]
    problem_adjs = problem_graphs(adjs)
    heur_pool = concurrent.futures.ThreadPoolExecutor(1)
    heur_future = heur_pool.submit(baseline_objectives, problem_adjs)
    launches = dict(lm_launches)
    with timed_phase("serve"):
        launches["fused_s2v_layer"], dense, dense_row = phase_serve(
            torch, policy, cfg, adjs, "dense")
        launches["fused_s2v_layer_sparse"], _, _ = phase_serve(
            torch, policy, cfg, adjs, "sparse", dense)
        launches["fused_s2v_layer_csr"], _, _ = phase_serve(
            torch, policy, cfg, adjs, "csr", dense)
    del dense
    with timed_phase("card_vs_cpu"):
        phase_card_vs_cpu(torch, policy)
    with timed_phase("train"):
        train_main, train_bf16, fused_s, train_data = phase_train(
            torch, policy, adjs, rows, failures)
    launches["csr_aggregate"] = train_main["csr_aggregate"]
    with timed_phase("host_engines"):
        host_launches = phase_host_engines(torch, policy, cfg, train_data,
                                           fused_s, dense_row)
    del train_data
    with timed_phase("problems"):
        baselines = heur_future.result()
        heur_pool.shutdown()
        problem_launches = phase_problems(torch, policy, cfg, problem_adjs,
                                          baselines)
    del problem_adjs
    with timed_phase("paper_scale"):
        paper = phase_paper_scale(torch, policy)
    with timed_phase("paper_train"):
        phase_paper_train(torch, paper.pop("csr"), rows, failures)
    with timed_phase("mesh"):
        mesh_launches = phase_mesh(torch, policy, cfg, adjs, paper)
    launches["mp_aggregate"] = mesh_launches["solve"]["mp_aggregate"]
    launches["sparse_mp_aggregate"] = 0
    for name, count in mesh_launches["train"].items():
        launches[name] += count             # the mesh's train half
    for name, count in problem_launches.items():
        launches[name] += count             # MaxCut, MIS and MDS
    del adjs, paper
    with timed_phase("ba_1m_csr"):
        indptr, indices, gen_s = ba_future.result()
        ba_pool.shutdown()
        ba_cs = csr_batch_from_arrays(indptr, indices, device=DEVICE)
        ba_kernel_check(torch, dev, ba_cs, rows, failures)
        if failures:
            raise AssertionError("a kernel disagrees with its plain "
                                 "version:\n" + "\n".join(failures))
        phase_ba(torch, policy, indptr, indices, ba_cs, gen_s)
        with timed_phase("sampled_train"):
            sampled, sampled_launches = phase_sampled_train(
                torch, indptr, indices, ba_cs, gen_s, rows, failures)
        with timed_phase("sampled_host_train"):
            for name, count in sampled_host_run(torch, sampled).items():
                host_launches[name] += count
        del indptr, indices
    for name, count in sampled_launches.items():
        launches[name] += count             # the sampled training
    for name, count in host_launches.items():
        launches[name] += count             # the host engines
    max_err = {(name, compute): max(r["max_abs_err"] for r in rows
                                    if r["kernel"] == name
                                    and r["compute"] == compute)
               for name in REPLACES for compute in ("f32", "bf16")
               if any(r["kernel"] == name and r["compute"] == compute
                      for r in rows)}
    batch = bucket_batch()
    with timed_phase("sparse_xla_chain"):
        launches["sparse_mp_aggregate"] += phase_xla_chain(torch, policy,
                                                           batch)
    with timed_phase("profile"):
        for rep in ("dense", "sparse", "csr"):
            phase_profile(torch, policy, batch, rep)
    del batch
    with timed_phase("timing"):
        timing = phase_timing(torch, ks, dev, ba_cs, sampled=sampled)
    del sampled
    timing.update(lm_timing)
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})

    kernels = {"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": max_err[name, "f32"],
        "ms": timing[name]["ms_f32"], "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"]}
        for name, (source, replaces) in REPLACES.items()] + [{
        # the aggregates at bf16, as the bf16 train_agent episodes ran
        # them; no one PyTorch call rounds the operands at use
        "name": f"{name}_bf16", "route": "cuda",
        "source": REPLACES[name][0], "replaces": REPLACES[name][1],
        "launches": train_bf16[name], "max_abs_err": max_err[name, "bf16"],
        "ms": timing[name]["ms_bf16"],
        "plain_ms": timing[name]["plain_ms_bf16"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"], "library_ms": None}
        for name in ("sparse_mp_aggregate", "csr_aggregate")]}
    print_card()
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
