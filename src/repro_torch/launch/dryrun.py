"""Multi-pod dry-run, counted on the meta device.  Counterpart of
``repro/launch/dryrun.py``.

JAX's dry-run lowers and compiles every supported (architecture × input
shape) on 512 forced host devices and reads XLA's ``memory_analysis()``,
``cost_analysis()`` and the HLO's collectives.  torch has no such
lowering, and this module compiles nothing.  It runs one rank's program,
rank 0 of the production mesh (16×16, or 2×16×16 with ``--multi-pod``,
``launch.mesh.production_layout``), on the meta device: a shape-only mesh
(``core.mesh.shape_mesh``) with no process group, the rank's parameters,
batch, cache and Adam state placed on meta by the ``Sharder``'s rules,
and the step (``make_train_step``, ``make_prefill`` or
``make_decode_step``) run under ``roofline.count.CountMode``, which counts
its matmul FLOPs, its bytes accessed and its peak live bytes, while the
mesh records the collectives the rank calls.  Nothing is allocated.

Every number of a record is the port's own count of its rank, except
``plan_argument_bytes``, the bytes a device holds under JAX's plan
(``models.shard.plan_bytes``), and the analytic terms, which are JAX's
arithmetic on the config.  A rank holds the blocks of
``models.shard.block_leaves`` at every shape: the experts, and the
attention heads, d_ff and vocabulary where JAX's plan splits them over
``model``, with their all-reduces and gathers in the traffic (at a train
shape also the backward's f all-reduces, ``all_reduce model backward``,
and the loss's max and sum over ``model`` a chunk, forward and
recomputed).  Every other leaf stays whole (MLA, RWKV-6, Mamba, the frontends,
JAX's data-axis splits), so a rank's ``argument_bytes`` are not JAX's
plan.
The roofline terms take ``roofline.HW``, the H100's data-sheet rates.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Callable, Optional

import torch

from ..configs import ARCHS, SHAPES, get_arch, shape_supported
from ..core.mesh import shape_mesh
from ..data.pipeline import batch_spec
from ..models import (ModelCtx, Sharder, cache_shapes, init_cache,
                      make_decode_step, make_prefill, make_train_step,
                      param_count, param_shapes)
from ..models.common import tree_map
from ..models.shard import block_leaves, plan_bytes, tree_bytes
from ..optim import adam_init
from ..roofline import model_flops, roofline_terms, traffic_bytes
from ..roofline.analysis import active_param_count
from ..roofline.analytic import analytic_flops, analytic_hbm_bytes
from ..roofline.count import count
from ..sharding import (activation_rules, batch_specs, cache_specs,
                        param_specs)
from ..sharding.rules import spec_shards
from .mesh import production_layout

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"
COUNTED_BY = "torch meta, one rank"
WKV_CHUNK = 16               # the port's LM launchers' chunk (launch/train.py)
_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def input_specs(arch_name: str, shape_name: str):
    """``TensorSpec`` stand-ins for every model input of (arch, shape)."""
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    return batch_spec(cfg, shape.seq_len, shape.global_batch, shape.mode)


def meta_tree(tree):
    """A meta tensor for each (shape, dtype) leaf of ``tree``."""
    return tree_map(lambda leaf: torch.empty(tuple(leaf[0]), dtype=leaf[1],
                                             device="meta"), tree)


def _dtype_tree(tree, dtype):
    return tree_map(lambda leaf: (leaf[0], dtype), tree)


@dataclasses.dataclass
class RankStep:
    """One rank's step: ``step(*args)`` runs it.  ``args`` are the rank's
    inputs (the parameters, then Adam's state or the cache, then the
    batch's tensors), ``plan_bytes`` what a device holds of them under
    JAX's plan, ``data_shards`` the blocks the batch is cut into (1 where
    every rank holds it whole)."""
    step: Callable
    args: tuple
    ctx: ModelCtx
    plan_bytes: int
    data_shards: int


def rank_step(cfg, shape, mesh, *, moe_mode: str = "allreduce",
              zero3: bool = False, remat: bool = True, layout: str = "tp",
              moment_dtype: str = "float32",
              clip_norm: Optional[float] = 1.0, q_chunk: int = 512,
              params=None, batch=None) -> RankStep:
    """Rank ``mesh.rank``'s step of ``cfg`` at ``shape`` on ``mesh``: its
    parameters (its blocks over ``model`` of ``shard.block_leaves``: the
    MoE experts where the layer is expert-parallel, the heads, d_ff and
    vocabulary; every other leaf whole), its rows of the batch,
    Adam's state or its cache, placed by the ``Sharder``'s rules, and the
    step built on a ``ModelCtx`` of the mesh.  ``params`` (a whole tree)
    and ``batch`` (a whole batch of ``batch_spec``'s structure) are meta
    tensors from the shapes where None, else placed from the given ones,
    so one step runs counted on meta and timed on a card."""
    if layout != "tp":
        raise ValueError(
            f"layout {layout!r} is a plan of JAX's that the port's rank "
            f"code does not run (ROADMAP A9e): a rank holds its batch rows "
            f"and its blocks over model of the 'tp' layout; take "
            f"layout='tp'")
    moe_mode = moe_mode if cfg.is_moe else "dense"
    sharder = Sharder(mesh, activation_rules(mesh, shape, layout=layout))
    ctx = ModelCtx(mesh=mesh, moe_mode=moe_mode, sharder=sharder,
                   remat=remat, q_chunk=q_chunk, wkv_chunk=WKV_CHUNK)
    shapes = param_shapes(cfg)
    pspecs = param_specs(shapes, mesh, zero3=zero3, layout=layout)
    params = sharder.place_params(meta_tree(shapes) if params is None
                                  else params, pspecs,
                                  block_leaves(mesh, moe_mode))
    bshape = batch_spec(cfg, shape.seq_len, shape.global_batch, shape.mode)
    bspecs = batch_specs(bshape, mesh, shape, layout=layout)
    batch = sharder.place_batch(meta_tree(bshape) if batch is None
                                else batch, bspecs)
    plan = plan_bytes(shapes, pspecs, mesh) + plan_bytes(bshape, bspecs,
                                                         mesh)
    data_shards = spec_shards(next(iter(bspecs.values())), mesh)
    if shape.mode == "train":
        mdt = _MOMENT_DTYPES[moment_dtype]
        opt = adam_init(params, moment_dtype=mdt)
        plan += 2 * plan_bytes(_dtype_tree(shapes, mdt), pspecs, mesh) + 4
        step = make_train_step(cfg, ctx, clip_norm=clip_norm)
        args = (params, opt, batch)
    elif shape.mode == "prefill":
        step = make_prefill(cfg, ctx)
        args = (params, batch)
    else:
        b = shape.global_batch
        cshape = cache_shapes(cfg, b, shape.seq_len)
        plan += plan_bytes(cshape, cache_specs(cshape, mesh, shape, b), mesh)
        tok = batch["token"]
        cache = (meta_tree(cache_shapes(cfg, tok.shape[0], shape.seq_len,
                                        mesh=mesh))
                 if tok.device.type == "meta" else
                 init_cache(cfg, tok.shape[0], shape.seq_len,
                            device=tok.device, mesh=mesh))
        step = make_decode_step(cfg, ctx)
        args = (params, cache, batch["token"], batch["pos"])
    return RankStep(step, args, ctx, plan, data_shards)


def _leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages of ``tensors``."""
    return sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in tensors}.values())


def count_rank_step(rs: RankStep) -> dict:
    """``rs`` run once under ``roofline.count``: its counts, memory and
    collectives (the mesh's record of this run).  ``argument_bytes`` is
    ``models.shard.tree_bytes`` of the inputs; ``temp_bytes`` the peak
    live bytes of the storages the step made, ``peak_bytes`` both."""
    mesh = rs.ctx.mesh
    mesh.traffic.clear()
    t0 = time.time()
    out, c = count(rs.step, *rs.args)
    count_s = time.time() - t0
    args = tree_bytes(_leaves(rs.args))
    return {
        "count_s": count_s, "flops": c.flops, "bytes_accessed": c.bytes,
        "ops": c.ops,
        "memory": {"argument_bytes": args,
                   "output_bytes": _storage_bytes(_leaves(out)),
                   "temp_bytes": c.peak, "peak_bytes": args + c.peak,
                   "generated_code_bytes": None},
        "peak_top": [list(t) for t in c.top],
        "traffic": {k: list(v) for k, v in mesh.traffic.items()},
        "collectives": traffic_bytes(mesh.traffic, mesh),
    }


def production_mesh(multi_pod: bool = False, rank: int = 0):
    """Rank ``rank`` of the production mesh, shape-only."""
    return shape_mesh(*production_layout(multi_pod), rank=rank)


def dry_run(cfg, shape, mesh, *, remat: bool = True, **kw) -> dict:
    """The record of one rank's step of ``cfg`` at ``shape`` on ``mesh``
    (:func:`rank_step`'s keywords in ``kw``), counted on meta, with the
    roofline terms on ``HW``."""
    t0 = time.time()
    rs = rank_step(cfg, shape, mesh, remat=remat, **kw)
    lower_s = time.time() - t0
    counted = count_rank_step(rs)
    shapes = param_shapes(cfg)
    n_total = param_count(meta_tree(shapes))
    n_active = active_param_count(cfg, shapes)
    afl = analytic_flops(cfg, shape, remat=remat)
    aby = analytic_hbm_bytes(cfg, shape, n_total, n_active, remat=remat)
    terms = roofline_terms({"flops": counted["flops"],
                            "bytes accessed": counted["bytes_accessed"]},
                           counted["collectives"], mesh.size,
                           model_flops(cfg, shape, n_active),
                           analytic_fl=afl, analytic_bytes=aby)
    return dict(
        counted_by=COUNTED_BY, rank=mesh.rank,
        chips=mesh.size, moe_mode=rs.ctx.moe_mode,
        params_total=int(n_total), params_active=int(n_active),
        lower_s=lower_s, compile_s=None,
        plan_argument_bytes=rs.plan_bytes, data_shards=rs.data_shards,
        flops_ratio=counted["flops"] * rs.data_shards / afl,
        roofline=terms, **counted)


def _mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def lower_and_compile(arch_name: str, shape_name: str, *,
                      multi_pod: bool = False, moe_mode: str = "allreduce",
                      zero3: bool = False, remat: bool = True,
                      layout: str = "tp", moment_dtype: str = "float32",
                      clip_norm: float | None = 1.0, q_chunk: int = 512,
                      seq_override: int | None = None,
                      extra_tag: str = ""):
    """JAX's name and keywords: the record of (arch, shape) on rank 0 of
    the production mesh, counted on meta (no lowering, no compile)."""
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    if seq_override:
        shape = dataclasses.replace(shape, seq_len=seq_override)
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "skipped": why}
    mesh = production_mesh(multi_pod)
    rec = dry_run(cfg, shape, mesh, moe_mode=moe_mode, zero3=zero3,
                  remat=remat, layout=layout, moment_dtype=moment_dtype,
                  clip_norm=clip_norm, q_chunk=q_chunk)
    return {"arch": arch_name, "shape": shape_name,
            "mesh": _mesh_name(mesh), "zero3": zero3, "layout": layout,
            "moment_dtype": moment_dtype, **rec}


def summarize(rec) -> str:
    if "skipped" in rec:
        return f"SKIP {rec['arch']:<18} {rec['shape']:<12} — {rec['skipped']}"
    r = rec["roofline"]
    m = rec["memory"]
    gib = 1 << 30
    return (f"OK   {rec['arch']:<18} {rec['shape']:<12} {rec['mesh']:<7} "
            f"args/dev={m['argument_bytes']/gib:7.2f}GiB "
            f"(plan {rec['plan_argument_bytes']/gib:.2f}) "
            f"temp/dev={m['temp_bytes']/gib:7.2f}GiB "
            f"compute={r['compute_s']*1e3:9.2f}ms "
            f"mem={r['memory_s']*1e3:9.2f}ms "
            f"coll={r['collective_s']*1e3:9.2f}ms "
            f"dom={r['dominant'].replace('_s',''):<10} "
            f"useful={r['useful_flops_ratio']:.2f} "
            f"flops×shards/analytic={rec['flops_ratio']:.3f} "
            f"[{rec['counted_by']}, {rec['count_s']:.1f}s]")


def run_one(arch, shape, args):
    tag = "mp" if args.multi_pod else "sp"
    extra = (f"__{args.tag}" if args.tag else "")
    out = OUT_DIR / f"{arch}__{shape}__{tag}{extra}.json"
    try:
        rec = lower_and_compile(arch, shape, multi_pod=args.multi_pod,
                                moe_mode=args.moe_mode, zero3=args.zero3,
                                remat=not args.no_remat, layout=args.layout,
                                moment_dtype=args.moment_dtype,
                                clip_norm=None if args.no_clip else 1.0,
                                q_chunk=args.q_chunk)
    except Exception as e:  # a failure here is a bug in the system
        rec = {"arch": arch, "shape": shape, "error": repr(e),
               "traceback": traceback.format_exc()}
        print(f"FAIL {arch:<18} {shape:<12} — {e!r}")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
        return rec
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(summarize(rec), flush=True)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--moe-mode", default="allreduce",
                    choices=["allreduce", "alltoall", "alltoall_rep"])
    ap.add_argument("--zero3", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="JAX's plan shards params over data axes too "
                         "(ZeRO-3): its plan_argument_bytes; the port's "
                         "rank holds the same either way")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp", "sp"])
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--no-clip", action="store_true",
                    help="drop global-norm clipping (grad-AR probe)")
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--tag", default="")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Run the dry-runs the flags ask for; returns their records."""
    args = parse_args(argv)
    t0 = time.time()
    if args.all:
        recs = [run_one(arch, shape, args) for arch in sorted(ARCHS)
                for shape in ("train_4k", "prefill_32k", "decode_32k",
                              "long_500k")]
        n = {k: sum(k in r for r in recs) for k in ("skipped", "error")}
        print(f"{len(recs)} records in {time.time() - t0:.1f}s: "
              f"{len(recs) - n['skipped'] - n['error']} OK, "
              f"{n['skipped']} SKIP, {n['error']} FAIL", flush=True)
        return recs
    if not (args.arch and args.shape):
        raise SystemExit("give --arch and --shape, or --all")
    rec = run_one(args.arch, args.shape, args)
    if "error" in rec:
        raise SystemExit(1)
    return [rec]


if __name__ == "__main__":
    main()
