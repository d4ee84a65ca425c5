"""The port's LM substrate against the JAX package, the parts with no
forward pass: the LM configs (``repro_torch.configs``), the layer
programs, the parameter trees, the weight converter
(``convert.lm_params_from_numpy``/``lm_params_to_numpy``) and the data
pipeline (``repro_torch.data``).

Bars: every config and its ``reduced()`` ``dataclasses.asdict``-equal to
JAX's; ``build_program`` and ``layer_sigs`` equal for the ten full
configs; ``param_count`` and every parameter's path, shape and dtype equal
for the ten reduced configs (and the full ones, without allocating);
the converter's round trip exact, bf16 crossing as bf16 bit for bit, a
bad tree refused; ``synthetic_batch`` and ``token_stream`` JAX's arrays
bit for bit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import base as jax_base
from repro.configs import shape_supported as jax_shape_supported
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.data import token_stream as jax_token_stream
from repro.models import build_program as jax_build_program
from repro.models import init_params as jax_init_params
from repro.models import layer_sigs as jax_layer_sigs
from repro.models import param_count as jax_param_count
from repro_torch.configs import (ARCHS, SHAPES, ArchConfig, ShapeConfig,
                                 get_arch, shape_supported)
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.data import batch_spec, synthetic_batch, token_stream
from repro_torch.models import (ModelCtx, build_program, init_cache,
                                init_params, layer_sigs, param_count,
                                param_shapes)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.ffn import padded_experts

ALL = sorted(JAX_ARCHS)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jax_init_params(jax.random.key(seed),
                                                     cfg))


def _paths(tree, prefix=""):
    """{path: leaf} of nested dicts and lists (a tuple is a leaf)."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in
                _paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree) for p, v in
                _paths(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


# ----------------------------------------------------------- configs -------

@pytest.mark.parametrize("name", ALL)
def test_arch_configs_equal_jax(name):
    assert set(ARCHS) == set(JAX_ARCHS)
    got, want = get_arch(name), JAX_ARCHS[name]
    assert isinstance(got, ArchConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(
        want.reduced())
    for prop in ("is_moe", "has_decode", "subquadratic"):
        assert getattr(got, prop) == getattr(want, prop)
    for shape in JAX_SHAPES.values():
        assert shape_supported(got, SHAPES[shape.name]) == \
            jax_shape_supported(want, shape)


def test_config_fields_defaults_and_shapes_equal_jax():
    for ours, theirs in ((ArchConfig, jax_base.ArchConfig),
                         (ShapeConfig, jax_base.ShapeConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)]
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-2")


# ------------------------------------------------- programs, params --------

@pytest.mark.parametrize("name", ALL)
def test_programs_and_layer_sigs_equal_jax(name):
    cfg = get_arch(name)
    assert layer_sigs(cfg) == jax_layer_sigs(JAX_ARCHS[name])
    assert build_program(cfg) == jax_build_program(JAX_ARCHS[name])
    assert layer_sigs(cfg.reduced()) == jax_layer_sigs(
        JAX_ARCHS[name].reduced())


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("name", ALL)
def test_parameter_shapes_and_count_equal_jax(name, reduced):
    cfg = get_arch(name).reduced() if reduced else get_arch(name)
    jcfg = JAX_ARCHS[name].reduced() if reduced else JAX_ARCHS[name]
    want = _paths(jax.eval_shape(lambda: jax_init_params(
        jax.random.key(0), jcfg)))
    got = _paths(param_shapes(cfg))
    assert sorted(got) == sorted(want)
    for path, (shape, dtype) in got.items():
        assert shape == want[path].shape, path
        assert str(dtype)[6:] == str(want[path].dtype), path
    if reduced:
        params = init_params(cfg, device="cpu")
        assert param_count(params) == jax_param_count(
            jax_init_params(jax.random.key(0), jcfg))
        assert {p: (tuple(t.shape), t.dtype) for p, t in
                _paths(params).items()} == got


def test_init_is_seeded_and_follows_the_distributions():
    cfg = get_arch("qwen2-moe-a2.7b").reduced()
    a = init_params(cfg, seed=1, device="cpu")
    b = init_params(cfg, seed=1, device="cpu")
    c = init_params(cfg, seed=2, device="cpu")
    pa, pb, pc = _paths(a), _paths(b), _paths(c)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["/embed"], pc["/embed"])
    # dense_init: N(0, 1/fan_in); the experts' fan-in is d
    ewg = pa["/segments/0/0/ffn/ewg"]
    assert abs(float(ewg.std()) * cfg.d_model ** 0.5 - 1.0) < 0.02
    assert torch.equal(pa["/segments/0/0/norm1"],
                       torch.zeros_like(pa["/segments/0/0/norm1"]))
    assert ewg.shape[1] == padded_experts(cfg.n_experts)


# --------------------------------------------------------- converter -------

@pytest.mark.parametrize("name", ["rwkv6-7b", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b", "deepseek-v3-671b"])
def test_converter_round_trip_is_exact(name):
    cfg = JAX_ARCHS[name].reduced()
    tree = _jax_params(cfg)
    params = lm_params_from_numpy(tree, get_arch(name).reduced(),
                                  device="cpu")
    back = _paths(lm_params_to_numpy(params))
    want = _paths(tree)
    assert sorted(back) == sorted(want)
    for path, arr in want.items():
        assert back[path].dtype == arr.dtype, path
        assert np.array_equal(back[path], arr), path


@pytest.mark.parametrize("name", ["rwkv6-7b", "gemma3-4b", "qwen2-moe-a2.7b"])
def test_bf16_weights_cross_as_bf16_bit_for_bit(name):
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="bfloat16")
    tree = _jax_params(jcfg)
    params = lm_params_from_numpy(tree, cfg, device="cpu")
    got, want = _paths(params), _paths(tree)
    n_bf16 = 0
    for path, arr in want.items():
        t = got[path]
        if str(arr.dtype) == "bfloat16":
            n_bf16 += 1
            assert t.dtype == torch.bfloat16, path
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  arr.view(np.int16)), path
        else:
            assert t.dtype == torch.float32 and np.array_equal(
                t.numpy(), arr), path
    assert n_bf16 > 10
    back = _paths(lm_params_to_numpy(params))
    assert all(np.array_equal(back[p].view(np.uint16) if
                              str(a.dtype) == "bfloat16" else back[p],
                              a.view(np.uint16) if str(a.dtype) == "bfloat16"
                              else a) for p, a in want.items())
    # the uint16 bit pattern of a bf16 leaf is taken as that leaf
    bits = jax.tree.map(lambda a: a.view(np.uint16)
                        if str(a.dtype) == "bfloat16" else a, tree)
    again = _paths(lm_params_from_numpy(bits, cfg, device="cpu"))
    assert all(torch.equal(again[p], got[p]) for p in got)


def test_converter_refuses_a_bad_tree():
    cfg = get_arch("llama3-405b").reduced()
    tree = _jax_params(JAX_ARCHS["llama3-405b"].reduced())
    bad = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed: shape"):
        lm_params_from_numpy(bad, cfg, device="cpu")
    bad = dict(tree, final_norm=tree["final_norm"].astype(np.float64))
    with pytest.raises(TypeError, match="final_norm: dtype"):
        lm_params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        lm_params_from_numpy({k: v for k, v in tree.items() if k != "embed"},
                             cfg, device="cpu")
    with pytest.raises(ValueError, match="segments"):
        lm_params_from_numpy(dict(tree, segments=tree["segments"][:1] * 2),
                             cfg, device="cpu")
    # a bf16 config refuses f32 weights rather than rounding them
    with pytest.raises(TypeError, match="expected bfloat16"):
        lm_params_from_numpy(tree, dataclasses.replace(cfg, dtype="bfloat16"),
                             device="cpu")


# -------------------------------------------------------------- data -------

@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ALL)
def test_synthetic_batch_is_jax_bit_for_bit(name, mode):
    for cfg, jcfg in ((get_arch(name), JAX_ARCHS[name]),
                      (get_arch(name).reduced(), JAX_ARCHS[name].reduced())):
        seq = (cfg.vlm_patches + 64) if cfg.vlm_patches else 48
        got = synthetic_batch(cfg, seq, 2, mode, seed=5, device="cpu")
        want = jax_synthetic_batch(jcfg, seq, 2, mode, seed=5)
        spec = batch_spec(cfg, seq, 2, mode)
        assert list(got) == list(want) == list(spec)
        for key, arr in want.items():
            arr = np.asarray(arr)
            t = got[key]
            assert tuple(t.shape) == arr.shape == spec[key].shape
            assert t.dtype == spec[key].dtype
            if t.dtype == torch.bfloat16:
                assert np.array_equal(t.view(torch.int16).numpy(),
                                      arr.view(np.int16)), key
            else:
                assert str(t.numpy().dtype) == str(arr.dtype)
                assert np.array_equal(t.numpy(), arr), key


def test_token_stream_is_jax_bit_for_bit():
    cfg = get_arch("granite-20b").reduced()
    got = list(token_stream(cfg, 24, 3, steps=3, seed=7, device="cpu"))
    want = list(jax_token_stream(JAX_ARCHS["granite-20b"].reduced(), 24, 3,
                                 steps=3, seed=7))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["tokens"].dtype == torch.int32
        assert np.array_equal(g["tokens"].numpy(), np.asarray(w["tokens"]))


# ---------------------------------------------------- refusals, device -----

def test_moe_gradient_on_a_mesh_is_the_dense_layers_without_drops():
    """A gradient passes the expert-parallel layer on a mesh
    (tests/test_torch_lm_mesh_train.py holds it to JAX's on 2 and 4
    ranks): on a one-rank mesh at a factor that drops no token, every
    mode's gradient of x and of every leaf is the dense layer's."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.ffn import moe_dense_apply, moe_sharded_apply
    cfg = get_arch("qwen2-moe-a2.7b").reduced()
    p = tree_map(lambda a: a[0].clone(),
                 init_params(cfg, device="cpu")["segments"][0][0]["ffn"])
    x = torch.randn((2, 4, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    no_drop = padded_experts(cfg.n_experts) / cfg.experts_per_token

    def grads(fn):
        leaves = [x] + tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        y, aux = fn(p, x)
        got = torch.autograd.grad(y.square().sum() + aux, leaves)
        for t in leaves:
            t.requires_grad_(False)
        return got
    want = grads(lambda q, xx: moe_dense_apply(q, xx, cfg=cfg))
    for mode in ("allreduce", "alltoall", "alltoall_rep"):
        got = grads(lambda q, xx: moe_sharded_apply(
            q, xx, cfg=cfg, mesh=make_host_mesh(1), mode=mode,
            capacity_factor=no_drop))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-5 * float(w.abs().max()))
            assert float(w.abs().max()) > 0


def test_lm_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    cfg = get_arch("llama3-405b").reduced()
    for call in (lambda: init_params(cfg),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: synthetic_batch(cfg, 8, 1),
                 lambda: next(token_stream(cfg, 8, 1, steps=1)),
                 lambda: lm_params_from_numpy(
                     _jax_params(JAX_ARCHS["llama3-405b"].reduced()), cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_model_ctx_fields_and_defaults_equal_jax():
    from repro.models import ModelCtx as JaxModelCtx
    ours = [(f.name, f.default) for f in dataclasses.fields(ModelCtx)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxModelCtx)]
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    assert [d for n, d in ours if n != "sharder"] == \
        [d for n, d in theirs if n != "sharder"]
