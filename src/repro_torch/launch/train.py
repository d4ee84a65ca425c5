"""LM training launcher: seeded random weights, Adam, the synthetic
next-token stream, checkpoints of ``(params, opt)`` in the JAX package's
format.  Counterpart of ``repro/launch/train.py``, with ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \
        --steps 5 --batch 1 --seq 2048
    # on a machine without a GPU, ask for the CPU explicitly:
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \
        --reduced --steps 10 --batch 2 --seq 128 --device cpu
    # JAX's (data, model) = (16, 16) mesh: 256 ranks, a card each
    PYTHONPATH=src torchrun --nnodes 32 --nproc-per-node 8 \
        --rdzv-endpoint HOST:PORT -m \
        repro_torch.launch.train --arch qwen2-moe-a2.7b --production-mesh

``--production-mesh`` trains on JAX's (data, model) = (16, 16) mesh over
the 256 ranks of a ``torchrun`` launch, each of which joins the process
group on its own card (nccl; gloo with ``--device cpu``) before the mesh
is built (``launch/mesh.py``, which raises without 256 ranks), with
JAX's activation rules: every rank places the
parameters and Adam's moments in JAX's layout "tp" (``models.shard.
block_leaves``: the GQA heads, the MLP's and shared experts' d_ff and
the vocabulary as blocks over ``model`` where JAX's plan splits them, and
the MoE experts in the expert-parallel modes, ``--moe-mode allreduce`` or
``alltoall``; the experts whole with ``dense``), takes its rows of each
batch and runs the step; rank 0 prints and writes the checkpoints, whose
blocks of every kind are gathered whole first, so a checkpoint is JAX's
global tree, and a checkpoint (of a mesh or of one device) is restored
whole and placed into the blocks.  Without the
mesh ``--moe-mode allreduce`` and ``alltoall`` run the dense MoE layer, as
JAX's launcher does.

The RWKV layers take the sequence in chunks of 16 tokens, where JAX's
launcher takes 32: the same function, and the chunk formula stays finite
over the model's whole decay range only at 16 (``kernels/wkv6.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..configs import ARCHS, get_arch
from ..configs.base import ShapeConfig
from ..core.mesh import TORCHRUN_VARS, destroy_meshes, join_torchrun
from ..data import batch_spec, token_stream
from ..device import resolve_device
from ..models import (ModelCtx, Sharder, init_params, make_train_step,
                      param_count, param_shapes)
from ..models.shard import block_leaves, gather_blocks
from ..optim import adam_init
from ..sharding import activation_rules, batch_specs, param_specs
from .mesh import make_production_mesh


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized variant of the arch family")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--moe-mode", default="dense",
                    choices=["dense", "allreduce", "alltoall"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--production-mesh", action="store_true",
                    help="train on the 16x16 mesh (needs 256 ranks)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None, params=None, mesh=None) -> dict:
    """Run the launcher.  ``params`` (a parameter tree of the config on
    the device, whole) replaces the seeded random weights, so the loop can
    be held to another framework's on the same weights; ``mesh`` (this
    rank's ``NamedMesh``) replaces the production mesh of
    ``--production-mesh``, so the mesh path runs on a small mesh.  Every
    rank of a mesh calls it.  Returns {"cfg", "losses", "grad_norms",
    "params", "opt", "seconds"}, the rank's own trees."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    if args.production_mesh:
        if mesh is None:
            if all(v in os.environ for v in TORCHRUN_VARS):
                _, dev = join_torchrun("nccl" if dev.type == "cuda"
                                       else "gloo", dev)
            mesh = make_production_mesh()
        shp = ShapeConfig("cli", args.seq, args.batch, "train")
        sharder = Sharder(mesh, activation_rules(mesh, shp))
        ctx = ModelCtx(mesh=mesh, moe_mode=args.moe_mode, wkv_chunk=16,
                       sharder=sharder)
    else:
        # without the mesh "allreduce" is the dense layer, and moe_apply
        # runs "alltoall" dense too, as in JAX
        mesh = None
        ctx = ModelCtx(remat=False, moe_mode=args.moe_mode
                       if args.moe_mode != "allreduce" else "dense",
                       wkv_chunk=16)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *_: None)
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    opt = adam_init(params)
    say(f"{cfg.name}: {param_count(params)/1e6:.1f}M params on "
        f"{1 if mesh is None else mesh.size} device(s)")

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        (params, opt), start = restore_checkpoint(args.ckpt_dir,
                                                  (params, opt))
        say(f"restored step {start}")

    blocks = block_leaves(mesh, args.moe_mode)
    if mesh is not None:
        specs = param_specs(param_shapes(cfg), mesh)
        params, opt.mu, opt.nu = (sharder.place_params(t, specs, blocks)
                                  for t in (params, opt.mu, opt.nu))
        bspecs = batch_specs(batch_spec(cfg, args.seq, args.batch, "train"),
                             mesh, shp)

    def save(step):
        tree = (params, opt)
        if blocks:
            mu, nu = (gather_blocks(t, specs, mesh, blocks)
                      for t in (opt.mu, opt.nu))
            tree = (gather_blocks(params, specs, mesh, blocks),
                    dataclasses.replace(opt, mu=mu, nu=nu))
        if lead:
            save_checkpoint(args.ckpt_dir, step, tree)

    step_fn = make_train_step(cfg, ctx, lr=args.lr)
    losses, gnorms = [], []
    t0 = time.time()
    for i, batch in enumerate(token_stream(cfg, args.seq, args.batch,
                                           steps=args.steps, seed=start,
                                           device=dev)):
        if mesh is not None:
            batch = sharder.place_batch(batch, bspecs)
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        say(f"step {start+i:5d} loss {losses[-1]:.4f} "
            f"gnorm {gnorms[-1]:.3f}")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save(start + i + 1)
    if args.ckpt_dir:
        save(start + args.steps)
    dt = time.time() - t0
    say(f"{args.steps} steps in {dt:.1f}s")
    return {"cfg": cfg, "losses": losses, "grad_norms": gnorms,
            "params": params, "opt": opt, "seconds": dt}


if __name__ == "__main__":
    try:
        main()
    finally:
        destroy_meshes()
