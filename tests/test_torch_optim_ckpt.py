"""The port's Adam on trees (``repro_torch.optim``: ``moment_dtype``,
``weight_decay``, ``cosine_schedule``, clipping) and its generic
checkpoints (``repro_torch.checkpoint.save_checkpoint`` /
``restore_checkpoint`` / ``latest_step``) against the JAX package's, and
``convert.lm_adam_from_numpy``/``lm_adam_to_numpy``.

Bars: Adam with bf16 moments, with weight decay, and on an LM's
parameter tree fed JAX's gradients, bit for bit JAX's over 10 steps;
``cosine_schedule`` at every step from 0 to total bit for bit in the
warmup and within base_lr·2^-23 after it (XLA's f32 cosine is not
correctly rounded, the port's is); the global-norm clip within 2 ulp of
JAX's norm and the gradients within 2 ulp (in place: the same bits as
not); checkpoints round-trip
exactly and keep the newest ``keep``; a ``(params, AdamState)``
checkpoint written by JAX restores in the port exactly, f32 and bf16,
and the port's restores in JAX exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as jax_latest_step
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import init_params as jax_init_params
from repro.optim import adam_init as jax_adam_init
from repro.optim import adam_update as jax_adam_update
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import cosine_schedule as jax_cosine
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.convert import (lm_adam_from_numpy, lm_adam_to_numpy,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import (AdamState, adam_init, adam_update,
                               clip_by_global_norm, clip_by_global_norm_,
                               cosine_schedule)

BF16 = ml_dtypes.bfloat16


def bits(a) -> np.ndarray:
    """An array's bits, so bf16 and NaNs compare exactly."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == BF16 else a.view(np.uint32)


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def assert_trees_equal(port_tree, jax_tree):
    # both in JAX's flattening order (dict keys sorted)
    got = jax.tree.leaves(tree_map(to_np, port_tree))
    want = [np.asarray(a) for a in jax.tree.leaves(jax_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(bits(g), bits(w))


def _grads(rng, like):
    """Gradients over seven decades, the parameters' dtypes."""
    return {k: (rng.standard_normal(v.shape) * 10 ** rng.uniform(-6, 1))
            .astype(np.float32).astype(v.dtype) for k, v in like.items()}


@pytest.mark.parametrize("moment_dtype,weight_decay",
                         [("bfloat16", 0.0), ("float32", 0.01),
                          ("bfloat16", 0.01)])
def test_adam_knobs_bit_for_bit_over_10_steps(moment_dtype, weight_decay):
    """bf16 and f32 parameters, moments in ``moment_dtype`` (kept in it),
    decoupled weight decay; a schedule's lr from step 1."""
    rng = np.random.default_rng(0)
    start = {"w": rng.standard_normal((5, 7)).astype(np.float32),
             "b": rng.standard_normal((7,)).astype(BF16)}
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[moment_dtype]
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        moment_dtype]
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    jst = jax_adam_init(jp, moment_dtype=jdt)
    tp = {k: to_torch(v) for k, v in start.items()}
    st = adam_init(tp, moment_dtype=tdt)
    assert all(m.dtype == tdt for m in tree_leaves(st.mu))
    jlr, lr = jax_cosine(1e-2, 3, 10), cosine_schedule(1e-2, 3, 10)
    for i in range(10):
        g = _grads(rng, start)
        jp, jst = jax_adam_update(jp, {k: jnp.asarray(v) for k, v in
                                       g.items()}, jst, lr=jlr(i + 1),
                                  weight_decay=weight_decay)
        adam_update(tp, {k: to_torch(v) for k, v in g.items()}, st,
                    lr=lr(i + 1), weight_decay=weight_decay)
    assert int(st.step) == int(jst.step) == 10
    assert st.mu["b"].dtype == tdt and tp["b"].dtype == torch.bfloat16
    assert_trees_equal(tp, jp)
    assert_trees_equal(st.mu, jst.mu)
    assert_trees_equal(st.nu, jst.nu)


def test_cosine_schedule_matches_jax():
    """Every step from 0 to total: bit for bit in the warmup; in the cosine
    part within base_lr·2^-23, since XLA's f32 cosine is an ulp from the
    correctly rounded one (the port's) at about 1% of arguments, and 1 +
    cos then carries that ulp of 1 (bit for bit at the rest)."""
    for base, warmup, total in ((3e-4, 10, 100), (1e-3, 0, 37),
                                (1.0, 5, 5), (3e-4, 100, 2000)):
        jf, f = jax_cosine(base, warmup, total), cosine_schedule(
            base, warmup, total)
        parted = 0
        for step in range(total + 1):
            got, want = f(step), np.asarray(jf(step))
            assert got.dtype == torch.float32
            if step < warmup:
                np.testing.assert_array_equal(bits(got.numpy()), bits(want))
            assert abs(float(got) - float(want)) <= base * 2.0 ** -23, step
            parted += bool(bits(got.numpy()) != bits(want))
        assert parted <= 0.05 * (total + 1)
    assert float(cosine_schedule(1e-3, 10, 100)(0)) == 0.0


def ulps(a, b) -> int:
    """The largest distance in units in the last place of their dtype."""
    a, b = np.asarray(a), np.asarray(b)
    kind = np.int16 if a.dtype == BF16 else np.int32
    return int(np.abs(a.view(kind).astype(np.int64)
                      - b.view(kind).astype(np.int64)).max())


@pytest.mark.parametrize("max_norm", [1e-3, 1e3])
def test_clip_on_a_tree(max_norm):
    """Nested dicts and lists with f32 and bf16 leaves: the norm within 2
    ulp of JAX's (each leaf's f32 sum of squares is a reduction whose
    order is the library's; ``tests/test_torch_train.py``'s bar) and every
    clipped gradient within 2 ulp of its dtype; the in-place clip gives
    the same bits and the same norm."""
    rng = np.random.default_rng(1)
    tree = {"a": [rng.standard_normal((3, 4)).astype(np.float32),
                  {"c": rng.standard_normal((5,)).astype(BF16)}],
            "b": rng.standard_normal((2, 2)).astype(np.float32)}
    want, wnorm = jax_clip(jax.tree.map(jnp.asarray, tree), max_norm)
    tt = tree_map(to_torch, tree)
    got, norm = clip_by_global_norm(tt, max_norm)
    assert ulps(norm.numpy(), wnorm) <= 2
    for g, w in zip(jax.tree.leaves(tree_map(to_np, got)),
                    jax.tree.leaves(want)):
        assert g.dtype == np.asarray(w).dtype and ulps(g, w) <= 2
    norm2 = clip_by_global_norm_(tt, max_norm)
    assert torch.equal(norm, norm2)
    for a, b in zip(tree_leaves(tt), tree_leaves(got)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_on_an_lm_tree_fed_jax_grads(dtype):
    """JAX's LM tree (nested dicts and lists, stacked segments): three
    steps of ``adam_update`` on JAX's gradients equal JAX's update."""
    jcfg = dataclasses.replace(JAX_ARCHS["qwen2-moe-a2.7b"].reduced(),
                               dtype=dtype)
    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b").reduced(),
                              dtype=dtype)
    jp = jax_init_params(jax.random.key(0), jcfg)
    jst = jax_adam_init(jp)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")
    st = adam_init(params)
    rng = np.random.default_rng(2)
    for _ in range(3):
        jg = jax.tree.map(lambda a: jnp.asarray(
            (rng.standard_normal(a.shape) * 1e-2).astype(np.float32)).astype(
            a.dtype), jp)
        g = lm_params_from_numpy(jax.tree.map(np.asarray, jg), cfg,
                                 device="cpu")
        jp, jst = jax_adam_update(jp, jg, jst, lr=1e-3)
        adam_update(params, g, st, lr=1e-3)
    assert_trees_equal(params, jp)
    assert_trees_equal(st.mu, jst.mu)
    assert_trees_equal(st.nu, jst.nu)
    back = lm_adam_to_numpy(st)
    again = lm_adam_from_numpy(back, cfg, device="cpu")
    assert int(again.step) == 3
    assert_trees_equal(again.mu, jst.mu)


# ------------------------------------------------------------- ckpt --------

def test_checkpoint_roundtrip(tmp_path):
    """tests/test_optim_ckpt_data.py's tree, as tensors."""
    tree = {"a": torch.arange(6).reshape(2, 3).to(torch.bfloat16),
            "b": [torch.ones(4), {"c": torch.zeros((2,), dtype=torch.int32)}]}
    save_checkpoint(tmp_path, 7, tree)
    assert latest_step(tmp_path) == 7
    restored, step = restore_checkpoint(tmp_path, tree)
    assert step == 7
    for x, y in zip(tree_leaves(tree), tree_leaves(restored)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # the same file restores in JAX
    jtree = {"a": jnp.zeros((2, 3), jnp.bfloat16),
             "b": [jnp.zeros(4), {"c": jnp.zeros((2,), jnp.int32)}]}
    back, step = jax_restore(tmp_path, jtree)
    assert step == 7
    assert_trees_equal(tree, back)


def test_checkpoint_retention(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in range(6):
        save_checkpoint(tmp_path, s, tree, keep=3)
    steps = sorted(int(p.name[5:13]) for p in tmp_path.glob("ckpt_*.npz"))
    assert steps == [3, 4, 5]
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", tree)


def _lm_state(dtype, seed):
    jcfg = dataclasses.replace(JAX_ARCHS["gemma3-4b"].reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_arch("gemma3-4b").reduced(), dtype=dtype)
    jp = jax_init_params(jax.random.key(seed), jcfg)
    jst = jax_adam_init(jp)
    jg = jax.tree.map(lambda a: jnp.full(a.shape, 0.5, a.dtype), jp)
    jp, jst = jax_adam_update(jp, jg, jst, lr=1e-3)   # moments non-zero
    return jcfg, cfg, jp, jst


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_lm_checkpoint_restores_in_the_port(tmp_path, dtype):
    jcfg, cfg, jp, jst = _lm_state(dtype, 4)
    jax_save(tmp_path, 5, (jp, jst))
    keys = set(np.load(tmp_path / "ckpt_00000005.npz").files)
    assert "[0]['embed']" in keys and "[1].step" in keys
    assert "[1].nu['segments'][0][5]['norm1']" in keys
    params = lm_params_from_numpy(jax.tree.map(
        np.asarray, jax_init_params(jax.random.key(9), jcfg)), cfg,
        device="cpu")
    (params, opt), step = restore_checkpoint(tmp_path, (params,
                                                        adam_init(params)))
    assert step == 5 and isinstance(opt, AdamState) and int(opt.step) == 1
    assert params["embed"].dtype == (torch.bfloat16 if dtype == "bfloat16"
                                     else torch.float32)
    assert_trees_equal(params, jp)
    assert_trees_equal(opt.mu, jst.mu)
    assert_trees_equal(opt.nu, jst.nu)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_lm_checkpoint_restores_in_jax(tmp_path, dtype):
    jcfg, cfg, jp, jst = _lm_state(dtype, 6)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")
    opt = lm_adam_from_numpy(jax.tree.map(np.asarray, jst), cfg,
                             device="cpu")
    save_checkpoint(tmp_path, 11, (params, opt))
    assert jax_latest_step(tmp_path) == 11
    template = (jax_init_params(jax.random.key(1), jcfg),
                jax_adam_init(jax_init_params(jax.random.key(1), jcfg)))
    (rp, rst), step = jax_restore(tmp_path, template)
    assert step == 11 and int(rst.step) == 1
    assert_trees_equal(params, rp)
    assert_trees_equal(opt.mu, rst.mu)
    assert_trees_equal(opt.nu, rst.nu)
    assert_trees_equal(lm_params_from_numpy(
        lm_params_to_numpy(params), cfg, device="cpu"), rp)


def test_lm_adam_from_numpy_refuses_a_bad_tree():
    jcfg, cfg, jp, jst = _lm_state("float32", 0)
    state = lm_adam_to_numpy(lm_adam_from_numpy(jax.tree.map(np.asarray,
                                                             jst), cfg,
                                                device="cpu"))
    state["mu"]["embed"] = state["mu"]["embed"][:-1]
    with pytest.raises(ValueError, match="mu.embed"):
        lm_adam_from_numpy(state, cfg, device="cpu")
    del state["nu"]["final_norm"]
    state["mu"] = lm_adam_to_numpy(lm_adam_from_numpy(jax.tree.map(
        np.asarray, jst), cfg, device="cpu"))["mu"]
    with pytest.raises(KeyError, match="final_norm"):
        lm_adam_from_numpy(state, cfg, device="cpu")
