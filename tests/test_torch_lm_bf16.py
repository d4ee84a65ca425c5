"""bf16 models of the port against the JAX package's on the same bf16
weights, one case each for the paths of B6 (rwkv), B7 (a window that
bites: gemma3 at window 8 over 32 tokens) and B8 (the MoE layer), the
kernels' wrappers taking their plain versions on the CPU.

Bars: prefill logits within 2e-2 of the largest |logit| of JAX's (both
frameworks round the same bf16 weights, but in other orders).  Twelve
teacher-forced decode steps: the recurrent state carries each side's
rounding from step to step (on the rwkv case JAX's own bf16 logits drift
to 3.7e-2 of the largest |logit| from the f32 model's), so the bar is the
f32 model on the same weights: the port's bf16 logits no further from it
than twice JAX's bf16 logits are, plus 2e-3 of its largest |logit|."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import ModelCtx as JaxModelCtx
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import make_decode_step as jax_make_decode_step
from repro.models import make_prefill as jax_make_prefill
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import (ModelCtx, init_cache, make_decode_step,
                                make_prefill)


@pytest.mark.parametrize("name,extra", [
    ("rwkv6-7b", {}), ("gemma3-4b", {"sliding_window": 8}),
    ("qwen2-moe-a2.7b", {})], ids=["rwkv", "swa", "moe"])
def test_bf16_model_matches_jax(name, extra):
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), dtype="bfloat16",
                               **extra)
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="bfloat16",
                              **extra)
    jparams = jax_init_params(jax.random.key(31), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32),
                                             dtype=np.int32)
    jctx, ctx = JaxModelCtx(remat=False, wkv_chunk=16), ModelCtx(
        remat=False, wkv_chunk=16)
    want, _ = jax.jit(jax_make_prefill(jcfg, jctx))(
        jparams, {"tokens": jnp.asarray(toks)})
    got, _ = make_prefill(cfg, ctx)(params, {"tokens": torch.from_numpy(
        toks)})
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 2e-2 * scale
    # decode, fed the same tokens on both sides (teacher forcing), held
    # to the f32 model on the same weights
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jparams32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    jdec = jax.jit(jax_make_decode_step(jcfg, jctx))
    jdec32 = jax.jit(jax_make_decode_step(jcfg32, jctx))
    dec = make_decode_step(cfg, ctx)
    jcache, jcache32 = jax_init_cache(jcfg, 2, 12), jax_init_cache(jcfg32, 2,
                                                                   12)
    cache = init_cache(cfg, 2, 12, device="cpu")
    drift = []
    for i in range(12):
        jtok, pos = jnp.asarray(toks[:, i:i + 1]), jnp.full((2,), i,
                                                            jnp.int32)
        jl, _, jcache = jdec(jparams, jcache, jtok, pos)
        jl32, _, jcache32 = jdec32(jparams32, jcache32, jtok, pos)
        pl, _, cache = dec(params, cache, torch.from_numpy(toks[:, i:i + 1]),
                           torch.full((2,), i, dtype=torch.int32))
        jl, jl32 = np.asarray(jl), np.asarray(jl32)
        jax_err = np.abs(jl - jl32).max()
        port_err = np.abs(pl.numpy() - jl32).max()
        scale32 = np.abs(jl32).max()
        drift.append((jax_err / scale32, port_err / scale32,
                      np.abs(pl.numpy() - jl).max() / scale32))
        assert port_err <= 2 * jax_err + 2e-3 * scale32, (
            f"step {i}: the port's bf16 logits {port_err:.4f} from f32, "
            f"JAX's {jax_err:.4f}")
    # the largest drifts over the steps, relative to the f32 logits: JAX's
    # bf16 from f32, the port's bf16 from f32, and the port's from JAX's
    print(name, "bf16 decode drift", np.max(drift, axis=0))
