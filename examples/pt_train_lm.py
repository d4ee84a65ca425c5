"""Train a small LM on synthetic structured data with the PyTorch port.
The counterpart of ``examples/train_lm.py`` on ``repro_torch``.

The whole substrate stack (configs → model → optimizer → data pipeline →
train loop) on one device.  Defaults are small (the arch's reduced config
with a 2048-token vocabulary); ``--full-100m`` takes the ~100M-parameter
member of the arch's family.  The loss falls on the stream's bigram
structure, and the last line says whether it did.

    PYTHONPATH=src python examples/pt_train_lm.py --arch gemma3-4b --steps 20
    PYTHONPATH=src python examples/pt_train_lm.py --device cpu
"""
import argparse
import dataclasses
import time

from repro_torch.configs import get_arch
from repro_torch.data import token_stream
from repro_torch.device import resolve_device
from repro_torch.models import (ModelCtx, init_params, make_train_step,
                                param_count)
from repro_torch.optim import adam_init


def hundred_m_variant(cfg):
    """~100M-param member of the arch's family."""
    return dataclasses.replace(
        cfg.reduced(), name=cfg.name + "-100m",
        n_layers=max(len(cfg.pattern), 8 if len(cfg.pattern) == 1 else
                     len(cfg.pattern)),
        d_model=512, n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 8),
        head_dim=64, d_ff=2048,
        d_ff_expert=512 if cfg.n_experts else 0,
        vocab_size=32_768, dtype="float32")


def main(argv=None, params=None) -> dict:
    """Run the example.  ``params`` (a parameter tree of the config on the
    device) replaces the seeded random weights.  Returns {"cfg",
    "losses"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-100m", action="store_true",
                    help="use the ~100M variant (slow on a CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    base = get_arch(args.arch)
    cfg = hundred_m_variant(base) if args.full_100m else dataclasses.replace(
        base.reduced(), vocab_size=2048, dtype="float32")
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    print(f"{cfg.name}: {param_count(params)/1e6:.1f}M params, "
          f"{cfg.n_layers} layers")

    ctx = ModelCtx(remat=False, wkv_chunk=16)
    step = make_train_step(cfg, ctx, lr=args.lr)
    opt = adam_init(params)
    losses = []
    t0 = time.time()
    for i, batch in enumerate(token_stream(cfg, args.seq, args.batch,
                                           steps=args.steps, seed=0,
                                           device=dev)):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}")
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({dt/args.steps:.2f} s/step)")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'DECREASED' if losses[-1] < losses[0] else 'no decrease'})")
    return {"cfg": cfg, "losses": losses}


if __name__ == "__main__":
    main()
