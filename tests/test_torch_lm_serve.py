"""The port's LM serving path beyond one step against one step: decode
against prefill on the port itself (JAX's tests/test_models.py checks,
rerun on the port), the mixers with a carried state, the one-device MoE layer, and the serving launcher
(``repro_torch.launch.serve``) against JAX's on the same weights.

Bars: decode against prefill 2e-3 (``wkv_chunk`` 4, JAX's bar and
settings); ``rwkv_apply`` with a state over T > 1
and ``moe_dense_apply`` within rtol 1e-4 / atol 1e-4 of JAX's;
``mamba_apply`` chained over two halves within 1e-3 of the whole (JAX's
bar) and each half within 1e-4 of JAX's; the launcher prints JAX's sample
row."""
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.launch import serve as jax_serve
from repro.models import init_params as jax_init_params
from repro.models.ffn import init_moe as jax_init_moe
from repro.models.ffn import moe_dense_apply as jax_moe_dense_apply
from repro.models.mamba import init_mamba as jax_init_mamba
from repro.models.mamba import mamba_apply as jax_mamba_apply
from repro.models.rwkv import init_rwkv as jax_init_rwkv
from repro.models.rwkv import rwkv_apply as jax_rwkv_apply
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import (ModelCtx, init_cache, init_params,
                                make_decode_step, make_prefill)
from repro_torch.models.common import tree_map
from repro_torch.models.ffn import moe_dense_apply
from repro_torch.models.mamba import mamba_apply
from repro_torch.models.rwkv import rwkv_apply

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(tree):
    """A JAX tree of f32 arrays as CPU tensors."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, tree))


# ------------------------------------------- decode against prefill --------

def _decode_all(cfg, params, toks, ctx):
    dec = make_decode_step(cfg, ctx)
    cache = init_cache(cfg, 1, toks.shape[1], device="cpu")
    logits = None
    for i in range(toks.shape[1]):
        logits, _, cache = dec(params, cache, toks[:, i:i + 1],
                               torch.tensor([i], dtype=torch.int32))
    return logits


@pytest.mark.parametrize("name", ["llama3-405b", "gemma3-4b",
                                  "deepseek-v3-671b", "rwkv6-7b",
                                  "jamba-v0.1-52b"])
def test_decode_matches_prefill(name):
    """Token-by-token decode with the cache reproduces the prefill logits
    of the last position (tests/test_models.py's check on the port)."""
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
    t = 12
    params = init_params(cfg, seed=3, device="cpu")
    ctx = ModelCtx(remat=False, wkv_chunk=4)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, t)).astype(
        np.int32))
    want, _ = make_prefill(cfg, ctx)(params, {"tokens": toks})
    got = _decode_all(cfg, params, toks, ctx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_swa_rolling_cache_matches_full():
    """Decode past the window: the ring-buffer cache of window slots gives
    the prefill's window-masked logits (tests/test_models.py's check)."""
    cfg = dataclasses.replace(get_arch("gemma3-4b").reduced(),
                              dtype="float32", sliding_window=8)
    t = 20
    params = init_params(cfg, seed=4, device="cpu")
    ctx = ModelCtx(remat=False)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, t)).astype(
        np.int32))
    want, _ = make_prefill(cfg, ctx)(params, {"tokens": toks})
    caches = init_cache(cfg, 1, t, device="cpu")
    assert caches[0][0]["k"].shape[1] == 8        # swa layers: window slots
    got = _decode_all(cfg, params, toks, ctx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


# ------------------------------------------------------- per module --------

def test_rwkv_apply_with_a_state_over_a_sequence_matches_jax():
    """T > 1 from a carried state: B6's wrapper from ``s0`` against JAX's
    ``wkv6_chunked_jnp(s0=...)``, chained over two calls."""
    cfg = get_arch("rwkv6-7b").reduced()
    p = jax_init_rwkv(jax.random.key(7), cfg, jnp.float32)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    h, n = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    state = {"shift": rng.standard_normal((2, 1, cfg.d_model)).astype(
        np.float32), "wkv": (rng.standard_normal((2, h, n, n)) * 0.5).astype(
        np.float32)}
    jy1, js1 = jax_rwkv_apply(p, jnp.asarray(x[:, :16]), cfg=cfg,
                              state=jax.tree.map(jnp.asarray, state),
                              chunk=8)
    jy2, js2 = jax_rwkv_apply(p, jnp.asarray(x[:, 16:]), cfg=cfg, state=js1,
                              chunk=8)
    pp = _t(p)
    y1, s1 = rwkv_apply(pp, torch.from_numpy(x[:, :16]), cfg=cfg,
                        state=_t(state), chunk=8)
    y2, s2 = rwkv_apply(pp, torch.from_numpy(x[:, 16:]), cfg=cfg, state=s1,
                        chunk=8)
    for got, want in ((y1, jy1), (y2, jy2), (s2["wkv"], js2["wkv"]),
                      (s2["shift"], js2["shift"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mamba_chained_over_halves():
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b").reduced(),
                              dtype="float32")
    p = jax_init_mamba(jax.random.key(0), cfg, jnp.float32)
    x = np.random.default_rng(4).standard_normal(
        (1, 12, cfg.d_model)).astype(np.float32)
    pp = _t(p)
    full, _ = mamba_apply(pp, torch.from_numpy(x), cfg=cfg)
    o1, s1 = mamba_apply(pp, torch.from_numpy(x[:, :6]), cfg=cfg)
    o2, s2 = mamba_apply(pp, torch.from_numpy(x[:, 6:]), cfg=cfg, state=s1)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), full.numpy(),
                               rtol=1e-3, atol=1e-3)
    jo1, js1 = jax_mamba_apply(p, jnp.asarray(x[:, :6]), cfg=cfg)
    jo2, js2 = jax_mamba_apply(p, jnp.asarray(x[:, 6:]), cfg=cfg, state=js1)
    for got, want in ((o1, jo1), (o2, jo2), (s2["ssm"], js2["ssm"]),
                      (s2["conv"], js2["conv"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moe_dense_apply_matches_jax():
    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b").reduced(),
                              dtype="float32")
    p = jax_init_moe(jax.random.key(5), cfg, jnp.float32)
    x = np.random.default_rng(2).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    want, aux_want = jax_moe_dense_apply(p, jnp.asarray(x), cfg=cfg)
    got, aux = moe_dense_apply(_t(p), torch.from_numpy(x), cfg=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == pytest.approx(float(aux_want), rel=1e-5)
    assert float(aux) >= 1.0 - 1e-3     # E·Σ f·p ≥ 1 by Cauchy-Schwarz


# ----------------------------------------------------------- launcher ------

@pytest.mark.parametrize("arch", ["rwkv6-7b", "qwen2-moe-a2.7b"])
def test_launcher_prints_jax_sample_row(arch, monkeypatch):
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--gen", "8"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_serve.main()
    want = buf.getvalue().splitlines()
    jcfg = dataclasses.replace(JAX_ARCHS[arch].reduced(), dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    params = lm_params_from_numpy(jax.tree.map(
        np.asarray, jax_init_params(jax.random.key(0), jcfg)), cfg,
        device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve.main(argv + ["--device", "cpu"], params=params)
    got = buf.getvalue().splitlines()
    assert got[0] == want[0]                      # name and params
    row = [ln for ln in got if ln.startswith("sample row:")]
    assert row == [ln for ln in want if ln.startswith("sample row:")]
    assert out["tokens"].shape == (8, 2)
    assert any(ln.startswith("decoded 8 steps x batch 2 in") for ln in got)


def test_launcher_on_its_own_weights_and_without_cuda(capsys):
    out = serve.main(["--arch", "granite-20b", "--reduced", "--batch", "2",
                      "--gen", "3", "--device", "cpu"])
    assert out["tokens"].shape == (3, 2)
    assert "granite-20b-reduced: 1.2M params" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                    "cpu"])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "granite-20b", "--reduced"])
