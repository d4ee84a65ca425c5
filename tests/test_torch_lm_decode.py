"""The port's LM decode step (``repro_torch.models.make_decode_step``)
against the JAX package's on every reduced decoder architecture, in f32,
with JAX's weights carried across.

Bar: 8 greedy decode steps from ``init_cache`` (batch 2, 16 cache slots,
first tokens from a numpy draw) give the same next tokens as JAX's at
every step and logits within rtol 1e-4 / atol 1e-4, then the caches
within the same bar.  No step here splits a near-tie: the smallest gap
between a row's two best logits is printed (3.2e-3 or more on these
inputs), and a token that parts says at which step and beside which gaps,
so that a split shows as a trace, never as a tolerance to widen."""

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
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import ModelCtx, init_cache, make_decode_step

TOL = dict(rtol=1e-4, atol=1e-4)
DECODERS = sorted(n for n, c in JAX_ARCHS.items() if not c.is_encoder)
STEPS, BATCH, SLOTS = 8, 2, 16


def _top2_gap(logits: np.ndarray) -> float:
    top = np.sort(logits, axis=-1)[:, -2:]
    return float((top[:, 1] - top[:, 0]).min())


@pytest.mark.parametrize("name", DECODERS)
def test_decode_steps_match_jax(name):
    jcfg, cfg = JAX_ARCHS[name].reduced(), get_arch(name).reduced()
    jparams = jax_init_params(jax.random.key(21), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    ctx = dict(remat=False, wkv_chunk=16)
    jdec = jax.jit(jax_make_decode_step(jcfg, JaxModelCtx(**ctx)))
    dec = make_decode_step(cfg, ModelCtx(**ctx))
    jcache = jax_init_cache(jcfg, BATCH, SLOTS)
    cache = init_cache(cfg, BATCH, SLOTS, device="cpu")
    first = np.random.default_rng(5).integers(0, cfg.vocab_size, (BATCH, 1),
                                              dtype=np.int32)
    jtok, tok = jnp.asarray(first), torch.from_numpy(first)
    gaps = []
    for i in range(STEPS):
        jlogits, jnext, jcache = jdec(jparams, jcache, jtok,
                                      jnp.full((BATCH,), i, jnp.int32))
        logits, nxt, cache = dec(params, cache, tok,
                                 torch.full((BATCH,), i, dtype=torch.int32))
        gaps.append(_top2_gap(np.asarray(jlogits)))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        assert np.array_equal(nxt.numpy(), np.asarray(jnext)), (
            f"step {i}: tokens {nxt.tolist()} against JAX's "
            f"{np.asarray(jnext).tolist()}, top-2 gaps {gaps}")
        jtok, tok = jnext[:, None].astype(jnp.int32), nxt[:, None]
    print(f"{name}: smallest top-2 logit gap {min(gaps):.3e}")
    want = jax.tree.leaves(jax.tree.map(np.asarray, jcache))
    got = jax.tree.leaves(lm_params_to_numpy(cache))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **TOL)
