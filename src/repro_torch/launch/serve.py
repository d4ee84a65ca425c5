"""LM serving launcher: a batched greedy decode loop with a KV cache, from
token 0, on random weights made from seed 0.  Counterpart of
``repro/launch/serve.py``, with ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --batch 4 --gen 16
    # on a machine without a GPU, ask for the CPU explicitly:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-20b \
        --reduced --batch 4 --gen 16 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCHS, get_arch
from ..device import resolve_device, synchronize
from ..models import (ModelCtx, init_cache, init_params, make_decode_step,
                      param_count)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None, params=None):
    """Run the launcher.  ``params`` (a parameter tree of the config on
    the device) replaces the seeded random weights, so the loop can be
    held to another framework's on the same weights.  Returns {"cfg",
    "tokens" (gen, batch) int array, "seconds"}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    print(f"{cfg.name}: {param_count(params)/1e6:.1f}M params")

    ctx = ModelCtx(remat=False, wkv_chunk=16)
    dec = make_decode_step(cfg, ctx)
    caches = init_cache(cfg, args.batch, args.max_seq, device=dev)
    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    toks = []
    for i in range(args.gen):
        pos = torch.full((args.batch,), i, dtype=torch.int32, device=dev)
        _, nxt, caches = dec(params, caches, tok, pos)
        tok = nxt[:, None]
        toks.append(nxt)
    tokens = torch.stack(toks).cpu().numpy() if toks else np.zeros(
        (0, args.batch), np.int32)
    dt = time.perf_counter() - t0
    print(f"decoded {args.gen} steps x batch {args.batch} in {dt:.1f}s "
          f"({args.gen*args.batch/dt:.1f} tok/s)")
    print("sample row:", [int(t[0]) for t in tokens][:12])
    return {"cfg": cfg, "tokens": tokens, "seconds": dt}


if __name__ == "__main__":
    main()
