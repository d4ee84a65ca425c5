"""Serve a model with batched requests on the PyTorch port: prefill and
decode loop.  The counterpart of ``examples/serve_batched.py`` on
``repro_torch``.

A minimal continuous-batching server core: requests arrive with different
prompt lengths, share one batch, and are fed token by token through the
decode step with one KV cache, then decoded greedily.  The greedy
next-token choice is the paper's all-gather + argmax (Alg. 4) applied to
vocab logits.  The model is the arch's reduced config in float32, on
random weights made from seed 0.

    PYTHONPATH=src python examples/pt_serve_batched.py --arch llama3-405b
    PYTHONPATH=src python examples/pt_serve_batched.py --device cpu
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import (ModelCtx, init_cache, init_params,
                                make_decode_step, param_count)


def main(argv=None, params=None) -> dict:
    """Run the example.  ``params`` (a parameter tree of the reduced
    config) replaces the seeded random weights.  Returns {"prompts",
    "outputs"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-405b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_arch(args.arch).reduced(), dtype="float32")
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode step")
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    print(f"{cfg.name}: {param_count(params)/1e6:.1f}M params")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=rng.integers(4, 12)).tolist()
               for _ in range(args.requests)]
    b = len(prompts)

    ctx = ModelCtx(remat=False, wkv_chunk=16)
    dec = make_decode_step(cfg, ctx)
    caches = init_cache(cfg, b, args.max_seq, device=dev)

    # "prefill" by batched decode over the prompt tokens (fed one position
    # at a time; a row shorter than the longest prompt starts generating
    # when its prompt ends)
    maxlen = max(len(p) for p in prompts)
    pos = np.zeros((b,), np.int32)
    tok = np.zeros((b, 1), np.int32)
    outputs = [list(p) for p in prompts]
    synchronize(dev)
    t0 = time.perf_counter()
    for i in range(maxlen + args.gen_tokens):
        for r in range(b):
            tok[r, 0] = outputs[r][i] if i < len(outputs[r]) else outputs[r][-1]
        _, nxt, caches = dec(params, caches, torch.from_numpy(tok).to(dev),
                             torch.from_numpy(pos).to(dev))
        nxt = nxt.cpu().numpy()
        for r in range(b):
            if i + 1 >= len(outputs[r]):       # past the prompt: generate
                outputs[r].append(int(nxt[r]))
        pos += 1
    dt = time.perf_counter() - t0
    total_new = sum(len(o) - len(p) for o, p in zip(outputs, prompts))
    print(f"served {b} requests, {total_new} new tokens "
          f"in {dt:.1f}s ({total_new/dt:.1f} tok/s on {dev})")
    for r, (p, o) in enumerate(zip(prompts, outputs)):
        print(f"  req{r}: prompt[{len(p)}] -> generated "
              f"{o[len(p):len(p)+8]}...")
    return {"prompts": prompts, "outputs": outputs}


if __name__ == "__main__":
    main()
