"""Dry-run of the PAPER'S OWN workload on the production mesh, counted on
the meta device: one policy evaluation (Alg. 2 + Alg. 3 + score
all-gather, Alg. 4 line 4-6) for a large ER graph spatially partitioned
over 256 chips.  Counterpart of ``repro/launch/dryrun_graph.py``.

The paper's largest graph is N=21,000 (33M edges) on 6 V100s; here we
count N=21,000 AND a pod-scale N=131,072 (dense rows sharded 256-way) and
report the same roofline terms as the LM dry-runs.  JAX lays the rows of A
over every mesh axis; the port lays them over the ``graph`` axis of a
shape-only graph mesh of (1, chips) (``core.mesh.shape_mesh``) and runs
rank 0's tiles through ``core.spatial.spatial_scores_fn`` and the argmax
on meta (``launch.dryrun`` says what is counted).  The policy is f32 on
the CUDA cores, so the terms take ``roofline.HW_F32``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_graph [--nodes 21000]
"""
from __future__ import annotations

import argparse
import json

import torch

from ..core.analysis import collective_bytes_per_step
from ..core.mesh import DATA, GRAPH, shape_mesh
from ..core.policy import Policy, PolicyConfig, init_policy
from ..core.qmodel import QModel
from ..core.s2v import S2V
from ..core.spatial import spatial_scores_fn
from ..models.shard import tree_bytes
from ..roofline import HW_F32, roofline_terms, traffic_bytes
from ..roofline.count import count
from .dryrun import COUNTED_BY, OUT_DIR, _leaves, _storage_bytes


def graph_policy_eval(mesh, l: int):
    """``policy_eval(params, adj, sol, cand) -> (argmax, scores)`` of one
    rank's tiles (B, N/sp, N), (B, N/sp), (B, N/sp) on the graph mesh
    ``mesh``: the scorer's (B, N) scores, all-gathered over ``graph``, and
    their argmax, with no autograd graph (an inference step)."""
    scorer = spatial_scores_fn(mesh, l)

    @torch.no_grad()
    def policy_eval(params, adj, sol, cand):
        scores = scorer(params, adj, sol, cand)
        return torch.argmax(scores, dim=-1), scores
    return policy_eval


def graph_policy_inputs(n: int, batch: int, k: int, mesh, device="meta"):
    """A seeded policy of width ``k`` and rank ``mesh.rank``'s tiles of a
    (batch, n, n) adjacency and its (batch, n) solution and candidates, on
    ``device``: empty on meta (shapes only); elsewhere the caller fills the
    tiles.  Returns (params, adj, sol, cand)."""
    nl = n // mesh.sp
    if torch.device(device).type == "meta":
        params = Policy(S2V(k, device="meta"), QModel(k, device="meta"))
    else:
        params = init_policy(PolicyConfig(embed_dim=k), device=device,
                             generator=torch.Generator().manual_seed(0))
    adj, sol, cand = (torch.zeros(s, device=device) for s in (
        (batch, nl, n), (batch, nl), (batch, nl)))
    return params, adj, sol, cand


def lower_graph_policy(n: int, batch: int = 1, k: int = 32, l: int = 2,
                       multi_pod: bool = False, mesh=None):
    """The record of one policy evaluation of (batch, n) graphs on rank 0
    of the production mesh's chips (``mesh``, a graph mesh of (1, sp), in
    its place where given), counted on meta."""
    name = "2x16x16" if multi_pod else "16x16"
    if mesh is None:
        mesh = shape_mesh((1, 512 if multi_pod else 256), (DATA, GRAPH))
    else:
        name = "x".join(str(s) for s in mesh.shape)
    chips = mesh.size
    n = -(-n // chips) * chips        # pad rows to the device count
    params, adj, sol, cand = graph_policy_inputs(n, batch, k, mesh)
    mesh.traffic.clear()
    out, c = count(graph_policy_eval(mesh, l), params, adj, sol, cand)
    coll = traffic_bytes(mesh.traffic, mesh)
    rho = 0.15
    # analytic flops: Eq. 4 of the paper (scalar-op count ≈ flops)
    afl = batch * (n * n * (k * (rho + l) + k * (2 + k + 4 * l) / n)
                   + k * n * (6 + k))
    terms = roofline_terms({"flops": c.flops, "bytes accessed": c.bytes},
                           coll, chips, afl, analytic_fl=afl, hw=HW_F32)
    args = tree_bytes(list(params.parameters()) + [adj, sol, cand])
    return {
        "workload": "papergraph_policy_eval", "nodes": n, "batch": batch,
        "mesh": name, "chips": chips,
        "counted_by": COUNTED_BY, "flops": c.flops, "bytes_accessed": c.bytes,
        "memory": {"argument_bytes": args,
                   "output_bytes": _storage_bytes(_leaves(out)),
                   "temp_bytes": c.peak, "peak_bytes": args + c.peak},
        "peak_top": [list(t) for t in c.top],
        "traffic": {key: list(v) for key, v in mesh.traffic.items()},
        "collectives": coll,
        "paper_model_bytes": collective_bytes_per_step(batch, n, k, l,
                                                       chips),
        "roofline": terms,
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, nargs="+",
                    default=[21_000, 131_072])
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    recs = []
    for n in args.nodes:
        rec = lower_graph_policy(n, multi_pod=args.multi_pod)
        tag = "mp" if args.multi_pod else "sp"
        out = OUT_DIR / f"papergraph__n{n}__{tag}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
        r = rec["roofline"]
        m = rec["memory"]
        print(f"OK papergraph N={n:>7} {rec['mesh']} "
              f"args/dev={m['argument_bytes']/2**30:.2f}GiB "
              f"compute={r['compute_s']*1e3:.2f}ms "
              f"mem={r['memory_s']*1e3:.2f}ms "
              f"coll={r['collective_s']*1e3:.2f}ms dom={r['dominant']} "
              f"[{rec['counted_by']}]", flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
