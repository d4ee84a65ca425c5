"""The port's LM prefill (``repro_torch.models.make_prefill``) against the
JAX package's on every reduced architecture, in f32, with JAX's weights
carried across (``convert.lm_params_from_numpy``) and JAX's
``synthetic_batch``.

Bar: the logits and every leaf of the caches prefill returns within
rtol 1e-4 / atol 1e-4 of JAX's.  The window-attention layers run B7's
wrapper (its plain version on the CPU), the rwkv layers B6's and the MoE
layers B8's; extra cases make the window bite (gemma3 at window 8 over 32
tokens) and take the queries in chunks (``q_chunk`` 8)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.models import ModelCtx as JaxModelCtx
from repro.models import init_params as jax_init_params
from repro.models import make_prefill as jax_make_prefill
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import ModelCtx, make_prefill

TOL = dict(rtol=1e-4, atol=1e-4)
CASES = [(name, {}) for name in sorted(JAX_ARCHS)] + [
    ("gemma3-4b", {"sliding_window": 8}),
    ("llama3-405b", {"q_chunk": 8}),
    ("deepseek-v3-671b", {"q_chunk": 8})]


def _id(case):
    name, extra = case
    return name + "".join(f"-{k}{v}" for k, v in extra.items())


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_prefill_matches_jax(case):
    name, extra = case
    q_chunk = extra.get("q_chunk", 512)
    cfg_kw = {k: v for k, v in extra.items() if k != "q_chunk"}
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), **cfg_kw)
    cfg = dataclasses.replace(get_arch(name).reduced(), **cfg_kw)
    seq = 64 if cfg.vlm_patches else 32
    jparams = jax_init_params(jax.random.key(11), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    jbatch = jax_synthetic_batch(jcfg, seq, 2, "prefill", seed=1)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    want, want_cache = jax.jit(jax_make_prefill(jcfg, JaxModelCtx(
        remat=False, wkv_chunk=16, q_chunk=q_chunk)))(jparams, jbatch)
    got, got_cache = make_prefill(cfg, ModelCtx(
        remat=False, wkv_chunk=16, q_chunk=q_chunk))(params, batch)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if cfg.is_encoder:
        assert got_cache is None and want_cache is None
        return
    want_leaves = jax.tree.leaves(jax.tree.map(np.asarray, want_cache))
    got_leaves = jax.tree.leaves(lm_params_to_numpy(got_cache))
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **TOL)
