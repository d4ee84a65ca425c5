"""The port's LM train step (``repro_torch.models.make_train_step``) in
lockstep with JAX's jitted ``make_train_step`` on every reduced
architecture, f32, lr 1e-3 with clipping at 1.0, from JAX's
``(params, AdamState)`` at step 0 on JAX's weights.

Each of the three steps starts from JAX's state before it (carried over
by ``convert.lm_params_from_numpy``/``lm_adam_from_numpy``), so each step
is held as a function and the bars do not compound.  Bars, per step:

- ``loss`` and ``grad_norm`` within rtol 1e-5 (rwkv6-7b's ``grad_norm``
  1e-4: its gradient is ill-conditioned, tests/test_torch_lm_train.py);
- the clipped gradients Adam takes within ``1e-4·|g| + A·max|g|``
  (``test_torch_lm_train.grad_atol``: A = 1e-5, rwkv6-7b 1e-4), so
  δg = that bound is what the gradient may be off by;
- the moments within what δg moves them: |Δm| <= (1 - b1)·δg and
  |Δv| <= (1 - b2)·(2|g| + δg)·δg, plus 1e-6 relative;
- the parameters by Adam's sign rule: the update u = m̂/(√v̂ + eps) moves
  by at most |∂u/∂g|·δg to first order, |∂u/∂g| <= (1 - b1)/(bc1·(√v̂ +
  eps)) + |m̂|·(1 - b2)·|g|/(bc2·√v̂·(√v̂ + eps)²) at JAX's new moments, and
  by no more than 2 (a flipped sign) in any case, so |Δp| <= 1e-6·|p| +
  lr·min(2, 2·|∂u/∂g|·δg).  An element whose gradient sits within δg of
  zero may part by up to 2·lr: that is Adam at a sign it cannot know,
  not a fault.  Such partings are printed with their gradient's trace;
  everything else is held to first order.

Then three free-running steps give JAX's losses within rtol 1e-5.  The
lockstep of jamba, llava, qwen2-moe and rwkv6 and the launcher are in
``test_torch_lm_train_launch.py``."""
import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.models import ModelCtx as JaxModelCtx
from repro.models import init_params as jax_init_params
from repro.models import make_train_step as jax_make_train_step
from repro.models.lm import loss_fn as jax_loss_fn
from repro.optim import adam_init as jax_adam_init
from repro.optim import clip_by_global_norm as jax_clip
from repro_torch.configs import get_arch
from repro_torch.convert import (lm_adam_from_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.models import ModelCtx, make_train_step
from test_torch_lm_train import GRAD_RTOL, grad_atol

LR, CLIP, B1, B2, EPS = 1e-3, 1.0, 0.9, 0.999, 1e-8
# the other four archs' lockstep runs in test_torch_lm_train_launch.py
HERE = ("deepseek-v3-671b", "gemma3-12b", "gemma3-4b", "granite-20b",
        "hubert-xlarge", "llama3-405b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def adam_rule(p, g, m, v, t, atol):
    """(bound on |Δp|, bound on |Δm|, bound on |Δv|, δg) of one Adam step
    ``t`` (1-based) whose gradient ``g`` is known to within δg; ``p``,
    ``m``, ``v`` JAX's values after the step (module docstring)."""
    dg = GRAD_RTOL * np.abs(g) + atol * np.abs(g).max()
    bc1, bc2 = 1 - B1 ** t, 1 - B2 ** t
    mhat, vhat = np.abs(m) / bc1, v / bc2
    root = np.sqrt(vhat)
    with np.errstate(divide="ignore", invalid="ignore"):
        sens = ((1 - B1) / (bc1 * (root + EPS))
                + mhat * (1 - B2) * np.abs(g) / (bc2 * root * (root + EPS)
                                                 ** 2))
    sens = np.where(np.isfinite(sens), sens, np.inf)
    dp = 1e-6 * np.abs(p) + LR * np.minimum(2.0, 2 * sens * dg)
    dm = (1 - B1) * dg + 1e-6 * np.abs(m)
    dv = (1 - B2) * (2 * np.abs(g) + dg) * dg + 1e-6 * np.abs(v)
    return dp, dm, dv, dg


def _setup(name):
    jcfg = JAX_ARCHS[name].reduced()
    cfg = get_arch(name).reduced()
    jparams = jax_init_params(jax.random.key(3), jcfg)
    seq = 64 if cfg.vlm_patches else 32
    batches = [jax_synthetic_batch(jcfg, seq, 2, "train", seed=10 + i)
               for i in range(3)]
    return jcfg, cfg, jparams, batches


@pytest.mark.parametrize("name", HERE)
def test_train_step_lockstep_with_jax(name):
    check_lockstep(name)


def check_lockstep(name):
    """Three steps of the port, each from JAX's state before it, against
    JAX's jitted step (the module docstring's bars)."""
    jcfg, cfg, jparams, batches = _setup(name)
    jctx = JaxModelCtx(remat=False, wkv_chunk=16)
    jstep = jax.jit(jax_make_train_step(jcfg, jctx, lr=LR, clip_norm=CLIP))
    jgrads = jax.jit(lambda p, b: jax_clip(jax.grad(
        lambda q: jax_loss_fn(q, jcfg, b, jctx)[0])(p), CLIP)[0])
    step = make_train_step(cfg, ModelCtx(remat=False, wkv_chunk=16), lr=LR,
                           clip_norm=CLIP)
    atol = grad_atol(name)
    jopt = jax_adam_init(jparams)
    paths = [jtu.keystr(p) for p, _ in
             jtu.tree_flatten_with_path(jparams)[0]]
    partings = []
    for i, jbatch in enumerate(batches):
        params = lm_params_from_numpy(_np(jparams), cfg, device="cpu")
        opt = lm_adam_from_numpy(_np(jopt), cfg, device="cpu")
        batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
        jg = jax.tree.leaves(_np(jgrads(jparams, jbatch)))
        jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        params, opt, m = step(params, opt, batch, with_grads=True)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=atol)
        assert int(opt.step) == int(jopt.step) == i + 1
        got = [jax.tree.leaves(lm_params_to_numpy(t))
               for t in (m["grads"], params, opt.mu, opt.nu)]
        want = [jax.tree.leaves(_np(t)) for t in (jparams, jopt.mu,
                                                  jopt.nu)]
        for path, g, gp, pp, mp, vp, p, mu, nu in zip(paths, jg, *got,
                                                      *want):
            dp, dm, dv, dg = adam_rule(p, g, mu, nu, i + 1, atol)
            assert (np.abs(gp - g) <= dg).all(), f"step {i} {path} grad"
            assert (np.abs(mp - mu) <= dm).all(), f"step {i} {path} mu"
            assert (np.abs(vp - nu) <= dv).all(), f"step {i} {path} nu"
            diff = np.abs(pp - p)
            assert (diff <= dp).all(), f"step {i} {path} params"
            for e in np.flatnonzero(diff.ravel() > 1e-2 * LR):
                partings.append((i, path, int(e), float(diff.ravel()[e]),
                                 float(g.ravel()[e]), float(gp.ravel()[e]),
                                 float(dg.ravel()[e])))
    for i, path, e, d, g, gp, dg in partings:
        print(f"{name} step {i} {path}[{e}]: |Δp| {d:.3g} at JAX's g {g:.3g}"
              f", the port's {gp:.3g}, δg {dg:.3g}")


@pytest.mark.parametrize("name", ["gemma3-4b", "rwkv6-7b",
                                  "qwen2-moe-a2.7b"])
def test_free_running_losses_follow_jax(name):
    """Three steps on each side from the same start, the states left to
    drift: the losses stay within rtol 1e-5 of JAX's."""
    jcfg, cfg, jparams, batches = _setup(name)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxModelCtx(
        remat=False, wkv_chunk=16), lr=LR, clip_norm=CLIP))
    step = make_train_step(cfg, ModelCtx(remat=False, wkv_chunk=16), lr=LR,
                           clip_norm=CLIP)
    params = lm_params_from_numpy(_np(jparams), cfg, device="cpu")
    jopt = jax_adam_init(jparams)
    opt = lm_adam_from_numpy(_np(jopt), cfg, device="cpu")
    for jbatch in batches:
        jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        params, opt, m = step(params, opt, {k: torch.from_numpy(np.array(v))
                                            for k, v in jbatch.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-5)


def test_train_step_without_clipping():
    """clip_norm=None: grad_norm 0, the gradients unscaled."""
    jcfg, cfg, jparams, batches = _setup("granite-20b")
    jstep = jax.jit(jax_make_train_step(jcfg, JaxModelCtx(
        remat=False), lr=LR, clip_norm=None))
    step = make_train_step(cfg, ModelCtx(remat=False), lr=LR,
                           clip_norm=None)
    params = lm_params_from_numpy(_np(jparams), cfg, device="cpu")
    opt = lm_adam_from_numpy(_np(jax_adam_init(jparams)), cfg, device="cpu")
    _, _, jm = jstep(jparams, jax_adam_init(jparams), batches[0])
    _, _, m = step(params, opt, {k: torch.from_numpy(np.array(v))
                                 for k, v in batches[0].items()})
    assert float(m["grad_norm"]) == float(jm["grad_norm"]) == 0.0
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
