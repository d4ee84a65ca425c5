"""LM training launcher on one device: seeded random weights, Adam, the
synthetic next-token stream, checkpoints of ``(params, opt)`` in the JAX
package's format.  Counterpart of ``repro/launch/train.py``, with
``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \
        --steps 5 --batch 1 --seq 2048
    # on a machine without a GPU, ask for the CPU explicitly:
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \
        --reduced --steps 10 --batch 2 --seq 128 --device cpu

``--production-mesh`` builds JAX's (data, model) = (16, 16) mesh over
the 256 ranks of a ``torchrun`` launch (``launch/mesh.py``, which raises
without them) with JAX's activation rules; its train step then refuses,
because LM training on the mesh is ROADMAP A8e.  Without the mesh
``--moe-mode allreduce`` and ``alltoall`` run the dense MoE layer, as
JAX's launcher does.

The RWKV layers take the sequence in chunks of 16 tokens, where JAX's
launcher takes 32: the same function, and the chunk formula stays finite
over the model's whole decay range only at 16 (``kernels/wkv6.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..configs import ARCHS, get_arch
from ..configs.base import ShapeConfig
from ..data import token_stream
from ..device import resolve_device
from ..models import (ModelCtx, Sharder, init_params, make_train_step,
                      param_count)
from ..optim import adam_init
from ..sharding import activation_rules
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
                    help="build the 16x16 mesh (needs 256 ranks)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None, params=None) -> dict:
    """Run the launcher.  ``params`` (a parameter tree of the config on
    the device) replaces the seeded random weights, so the loop can be
    held to another framework's on the same weights.  Returns {"cfg",
    "losses", "grad_norms", "params", "opt", "seconds"}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    if args.production_mesh:
        mesh = make_production_mesh()
        shp = ShapeConfig("cli", args.seq, args.batch, "train")
        ctx = ModelCtx(mesh=mesh, moe_mode=args.moe_mode, wkv_chunk=16,
                       sharder=Sharder(mesh, activation_rules(mesh, shp)))
    else:
        # without the mesh "allreduce" is the dense layer, and moe_apply
        # runs "alltoall" dense too, as in JAX
        ctx = ModelCtx(remat=False, moe_mode=args.moe_mode
                       if args.moe_mode != "allreduce" else "dense",
                       wkv_chunk=16)
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    opt = adam_init(params)
    print(f"{cfg.name}: {param_count(params)/1e6:.1f}M params on "
          f"1 device(s)")

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        (params, opt), start = restore_checkpoint(args.ckpt_dir,
                                                  (params, opt))
        print(f"restored step {start}")

    step_fn = make_train_step(cfg, ctx, lr=args.lr)
    losses, gnorms = [], []
    t0 = time.time()
    for i, batch in enumerate(token_stream(cfg, args.seq, args.batch,
                                           steps=args.steps, seed=start,
                                           device=dev)):
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        print(f"step {start+i:5d} loss {losses[-1]:.4f} "
              f"gnorm {gnorms[-1]:.3f}")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, start + i + 1, (params, opt))
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, start + args.steps, (params, opt))
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s")
    return {"cfg": cfg, "losses": losses, "grad_norms": gnorms,
            "params": params, "opt": opt, "seconds": dt}


if __name__ == "__main__":
    main()
