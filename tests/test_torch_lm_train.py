"""The port's LM loss (``repro_torch.models.loss_fn``, ``chunked_xent``)
and its gradients against the JAX package's on the CPU, in f32, with
JAX's weights carried across (``convert.lm_params_from_numpy``) and
JAX's ``synthetic_batch``; and ``ModelCtx.remat`` against no remat.

Bars: the loss and the metrics ``xent``, ``aux``, ``mtp`` within rtol
1e-5; the gradient of every parameter leaf within ``1e-4·|g| + A·max|g|``
of ``jax.grad(loss_fn)``'s, max over the leaf, with A = 1e-5.  rwkv6-7b's
gradient is ill-conditioned: a relative perturbation of its weights by
6e-8 (half an f32 ulp) moves JAX's own gradient by more than 2e-5 of a
leaf's largest |g| (``test_rwkv_gradient_conditioning``), so there A =
1e-4.  ``chunked_xent`` within rtol 1e-5 and its input gradients within
1e-5 of the largest |g| of ``jax.grad``'s.  Remat gives the same loss and
gradients as no remat, bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.models import ModelCtx as JaxModelCtx
from repro.models import init_params as jax_init_params
from repro.models.lm import chunked_xent as jax_chunked_xent
from repro.models.lm import loss_fn as jax_loss_fn
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import (ModelCtx, chunked_xent, loss_and_grads,
                                loss_fn, make_eval_step)
from repro_torch.models import lm

ALL = sorted(JAX_ARCHS)
GRAD_RTOL = 1e-4


def grad_atol(name: str) -> float:
    """A of the gradient bar: 1e-5 of the leaf's largest |g|, 1e-4 for
    rwkv6-7b (see ``test_rwkv_gradient_conditioning``)."""
    return 1e-4 if name.startswith("rwkv") else 1e-5


def grad_ratio(got, want, atol) -> float:
    """max |got - want| / (GRAD_RTOL·|want| + atol·max|want|); > 1
    fails."""
    scale = max(float(np.abs(want).max()), 1e-30)
    return float((np.abs(got - want) / (GRAD_RTOL * np.abs(want)
                                        + atol * scale)).max())


def _cfgs(name, **kw):
    return (dataclasses.replace(JAX_ARCHS[name].reduced(), **kw),
            dataclasses.replace(get_arch(name).reduced(), **kw))


def _setup(name, seed=3, batch_seed=1, **kw):
    """(jax cfg, port cfg, JAX params, port params, JAX batch, port
    batch) on the same weights and inputs."""
    jcfg, cfg = _cfgs(name, **kw)
    seq = 64 if cfg.vlm_patches else 32
    jparams = jax_init_params(jax.random.key(seed), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    jbatch = jax_synthetic_batch(jcfg, seq, 2, "train", seed=batch_seed)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    return jcfg, cfg, jparams, params, jbatch, batch


def _jax_loss_and_grads(jcfg, jparams, jbatch):
    ctx = JaxModelCtx(remat=False, wkv_chunk=16)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, jcfg, b, ctx), has_aux=True))(
        jparams, jbatch)
    return loss, metrics, grads


def assert_loss_and_grads_match(name, jcfg, cfg, jparams, params, jbatch,
                                batch):
    want, wmetrics, wgrads = _jax_loss_and_grads(jcfg, jparams, jbatch)
    loss, metrics, grads = loss_and_grads(
        params, cfg, batch, ModelCtx(remat=False, wkv_chunk=16))
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    assert set(metrics) == set(wmetrics)
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(wmetrics[k]),
                                                  rel=1e-5, abs=1e-7), k
    paths = [jtu.keystr(p) for p, _ in
             jtu.tree_flatten_with_path(wgrads)[0]]
    got = jax.tree.leaves(lm_params_to_numpy(grads))
    want_g = jax.tree.leaves(jax.tree.map(np.asarray, wgrads))
    assert len(got) == len(want_g)
    for path, g, w in zip(paths, got, want_g):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert np.isfinite(g).all(), path
        ratio = grad_ratio(g, w, grad_atol(name))
        assert ratio <= 1, f"{name} {path}: {ratio} of the bar"


# ----------------------------------------------------------- chunked_xent --

@pytest.mark.parametrize("masked", [False, True])
def test_chunked_xent_matches_jax(masked):
    """Four chunks of 16 tokens (JAX's tests/test_models.py shape), with and
    without a mask; the value and the gradients of h and the head."""
    rng = np.random.default_rng(4)
    b, t, d, v = 2, 16, 8, 32
    h = rng.standard_normal((b, t, d)).astype(np.float32)
    w = rng.standard_normal((v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, t)).astype(np.int32)
    mask = (rng.random((b, t)) < 0.7).astype(np.float32) if masked else None

    def jf(h, w):
        return jax_chunked_xent(h, w, jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask),
                                chunk=4)
    want = jf(jnp.asarray(h), jnp.asarray(w))
    jgh, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = chunked_xent(th, tw, torch.from_numpy(labels),
                       None if mask is None else torch.from_numpy(mask),
                       chunk=4)
    gh, gw = torch.autograd.grad(got, (th, tw))
    got = got.detach()
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    for g, jg in ((gh, jgh), (gw, jgw)):
        jg = np.asarray(jg)
        assert np.abs(g.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()
    # the dense definition
    logits = np.einsum("btd,vd->btv", h.astype(np.float64), w)
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    gold = np.take_along_axis(logits, labels[..., None].astype(np.int64),
                              -1)[..., 0]
    m = np.ones((b, t)) if mask is None else mask
    assert float(got) == pytest.approx(float(((lse - gold) * m).sum()
                                             / m.sum()), rel=1e-5)


def test_chunked_xent_recomputes_each_chunk_and_drops_jax_remainder(
        monkeypatch):
    """Each chunk goes through ``checkpoint`` (recomputed in the backward);
    T = 10 at chunk 4 takes JAX's 2 chunks of 5 tokens."""
    calls = []
    real = lm.checkpoint

    def counting(fn, *args, **kw):
        calls.append(args[0].shape[1])
        return real(fn, *args, **kw)
    monkeypatch.setattr(lm, "checkpoint", counting)
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.standard_normal((1, 10, 4)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((7, 4)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 7, (1, 10)).astype(np.int32))
    got = chunked_xent(h, w, labels, chunk=4)
    assert calls == [5, 5]
    want = jax_chunked_xent(jnp.asarray(h.detach().numpy()), jnp.asarray(
        w.numpy()), jnp.asarray(labels.numpy()), chunk=4)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    with torch.no_grad():
        chunked_xent(h, w, labels, chunk=4)
    assert len(calls) == 2                 # no checkpoint without autograd


# ----------------------------------------------------------- loss_fn ------

@pytest.mark.parametrize("name", ALL)
def test_loss_and_every_gradient_match_jax(name):
    assert_loss_and_grads_match(name, *_setup(name))


def test_llava_text_only_mask():
    """The patches carry no loss: JAX's and the port's loss over the text
    region alone, and changing a patch leaves the xent's labels alone."""
    jcfg, cfg, jparams, params, jbatch, batch = _setup("llava-next-34b",
                                                       seed=7)
    assert_loss_and_grads_match("llava-next-34b", jcfg, cfg, jparams,
                                params, jbatch, batch)
    x, labels, mask = lm._embed_inputs(params, cfg, batch, ModelCtx())
    p = cfg.vlm_patches
    assert mask[:, :p].sum() == 0 and bool((mask[:, p:] == 1).all())
    assert bool((labels[:, :p] == 0).all())
    assert torch.equal(labels[:, p:], batch["labels"].long().to(
        labels.dtype))


def test_deepseek_mtp_head():
    """mtp_weight 0.3 (tests/test_models.py's case): the MTP metric and
    every gradient, mtp_proj included, match JAX's; the head changes the
    loss."""
    jcfg, cfg, jparams, params, jbatch, batch = _setup(
        "deepseek-v3-671b", seed=0, mtp_weight=0.3)
    assert "mtp_proj" in params
    assert_loss_and_grads_match("deepseek-v3-671b", jcfg, cfg, jparams,
                                params, jbatch, batch)
    loss, metrics = loss_fn(params, cfg, batch, ModelCtx(remat=False))
    assert "mtp" in metrics and np.isfinite(float(metrics["mtp"]))
    cfg0 = dataclasses.replace(cfg, mtp_weight=0.0)
    params0 = {k: v for k, v in params.items() if k != "mtp_proj"}
    loss0, m0 = loss_fn(params0, cfg0, batch, ModelCtx(remat=False))
    assert "mtp" not in m0 and float(loss) != float(loss0)
    assert float(loss) == pytest.approx(
        float(loss0) + 0.3 * float(metrics["mtp"]), rel=1e-6)


def test_rwkv_gradient_conditioning():
    """Why rwkv6-7b's bar is A = 1e-4: JAX's own f32 gradient moves by more
    than 2e-5 of a leaf's largest |g| when its weights are perturbed by
    6e-8 relative (half an ulp), where granite-20b's moves by less than
    5e-6.  No f32 evaluation in another order can be held closer than
    that."""
    def moved(name):
        jcfg, _, jparams, _, jbatch, _ = _setup(name)
        _, _, g = _jax_loss_and_grads(jcfg, jparams, jbatch)
        rng = np.random.default_rng(0)
        shaken = jax.tree.map(lambda a: jnp.asarray(
            np.asarray(a) * (1 + 6e-8 * rng.standard_normal(a.shape)).astype(
                np.float32)), jparams)
        _, _, g2 = _jax_loss_and_grads(jcfg, shaken, jbatch)
        return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()
                         / np.abs(np.asarray(b)).max())
                   for a, b in zip(jax.tree.leaves(g2), jax.tree.leaves(g)))
    assert moved("rwkv6-7b") > 2e-5
    assert moved("granite-20b") < 5e-6


def test_eval_step_is_loss_fn():
    jcfg, cfg, jparams, params, jbatch, batch = _setup("qwen2-moe-a2.7b")
    ctx = ModelCtx(remat=False, wkv_chunk=16)
    got = make_eval_step(cfg, ctx)(params, batch)
    _, want = loss_fn(params, cfg, batch, ctx)
    assert set(got) == set(want) == {"xent", "aux"}
    for k in got:
        assert torch.equal(got[k], want[k].detach())
        assert not got[k].requires_grad


# ----------------------------------------------------------- remat --------

@pytest.mark.parametrize("name,layers,reps", [("granite-20b", None, 2),
                                              ("gemma3-4b", 14, 2)])
def test_remat_is_bit_for_bit(name, layers, reps, monkeypatch):
    """remat=True recomputes each repeat of a stacked segment in the
    backward (one ``checkpoint`` a repeat) and gives the loss and every
    gradient of remat=False bit for bit: granite's one stacked segment
    (2 repeats), and gemma3 at 14 layers (2 repeats of its 6-layer unit,
    then 2 single-layer segments that are not rematerialized)."""
    kw = {} if layers is None else {"n_layers": layers}
    _, cfg, _, params, _, batch = _setup(name, **kw)
    calls = []
    real = lm.checkpoint

    def counting(fn, *args, **k):
        calls.append(fn)
        return real(fn, *args, **k)
    monkeypatch.setattr(lm, "checkpoint", counting)
    l0, m0, g0 = loss_and_grads(params, cfg, batch,
                                ModelCtx(remat=False, wkv_chunk=16))
    chunks = len(calls)                    # the loss chunks alone
    l1, m1, g1 = loss_and_grads(params, cfg, batch,
                                ModelCtx(remat=True, wkv_chunk=16))
    assert len(calls) - 2 * chunks == reps
    assert torch.equal(l0, l1)
    for k in m0:
        assert torch.equal(m0[k], m1[k])
    for a, b in zip(jax.tree.leaves(lm_params_to_numpy(g0)),
                    jax.tree.leaves(lm_params_to_numpy(g1))):
        np.testing.assert_array_equal(a, b)
