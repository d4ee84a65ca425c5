"""The port's sharding rules (``repro_torch.sharding``), its ``Sharder``
and its mesh builders (``repro_torch.launch.mesh``) against the JAX
package, on shape-only meshes (no devices, no process group).

Bars: every spec equal to JAX's as a tuple, leaf by leaf on the same
paths: ``param_specs`` of every arch's full parameter tree (layouts tp
and fsdp, ``zero3`` on and off), ``activation_rules`` of every shape and
layout, ``batch_specs`` of every arch's inputs at every shape and layout,
``cache_specs`` of every decoder's cache at the decode shapes, each on
the meshes (16,16), (2,16,16), (1,2), (2,2) and (1,4); tests/test_sharding.py's
five tests restated on the port's rules; ``Sharder.constraint`` the spec
JAX's ``Sharder.act`` constrains to (or skips); a rank's blocks
(``Sharder.place``) tile the global tensor; the mesh builders' axes and
refusals JAX's."""
import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JaxP

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import shape_supported as jax_shape_supported
from repro.data.pipeline import batch_spec as jax_batch_spec
from repro.launch import mesh as jax_launch_mesh
from repro.models import Sharder as JaxSharder
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import shard as jax_shard
from repro.sharding import activation_rules as jax_activation_rules
from repro.sharding import batch_specs as jax_batch_specs
from repro.sharding import cache_specs as jax_cache_specs
from repro.sharding import param_specs as jax_param_specs
from repro_torch import sharding
from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_supported
from repro_torch.core.mesh import Axis, NamedMesh, make_named_mesh
from repro_torch.data import batch_spec
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import Sharder, cache_shapes, param_shapes
from repro_torch.models.shard import plan_bytes
from repro_torch.sharding import (P, activation_rules, batch_specs,
                                  cache_specs, param_specs)
from repro_torch.sharding.rules import spec_shards


class FakeMesh:
    """Shape-only stand-in (the rules read only .shape/.axis_names)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = math.prod(shape.values())


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
          "1x2": FakeMesh({"data": 1, "model": 2}),
          "2x2": FakeMesh({"data": 2, "model": 2}),
          "1x4": FakeMesh({"data": 1, "model": 4})}
MESH = MESHES["16x16"]
MESH_MP = MESHES["2x16x16"]
ALL = sorted(ARCHS)
LAYOUTS = ("tp", "sp", "fsdp")


def _key(entry) -> str:
    return f"[{entry!r}]" if isinstance(entry, str) else f"[{entry}]"


def _port_flat(tree, prefix=""):
    """{JAX keystr: leaf} of a port tree (dicts, lists; a tuple a leaf)."""
    if isinstance(tree, dict):
        return {k: v for name in tree for k, v in
                _port_flat(tree[name], prefix + _key(name)).items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in
                _port_flat(t, prefix + _key(i)).items()}
    return {prefix: tree}


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxP))
    return {jax.tree_util.keystr(path): leaf for path, leaf in flat}


def _assert_same_specs(got, want):
    g, w = _port_flat(got), _jax_flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert isinstance(g[k], P)
        assert tuple(g[k]) == tuple(w[k]), (k, g[k], w[k])


@functools.lru_cache(maxsize=None)
def _jax_shapes(name):
    return jax.eval_shape(lambda k: jax_init_params(k, JAX_ARCHS[name]),
                          jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _shapes(name):
    return param_shapes(get_arch(name))


# ------------------------------------------------------- JAX's rules ------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ALL)
def test_param_specs_equal_jax(name, mesh):
    m = MESHES[mesh]
    for layout in ("tp", "fsdp"):
        for zero3 in (False, True):
            _assert_same_specs(
                param_specs(_shapes(name), m, zero3=zero3, layout=layout),
                jax_param_specs(_jax_shapes(name), m, zero3=zero3,
                                layout=layout))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_activation_rules_equal_jax(shape, mesh):
    m = MESHES[mesh]
    for layout in LAYOUTS:
        got = activation_rules(m, SHAPES[shape], layout=layout)
        want = jax_activation_rules(m, JAX_SHAPES[shape], layout=layout)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
        assert all(isinstance(v, P) for v in got.values())


@pytest.mark.parametrize("name", ALL)
def test_batch_specs_equal_jax(name):
    cfg, jcfg = get_arch(name), JAX_ARCHS[name]
    for shape in sorted(SHAPES):
        if not shape_supported(cfg, SHAPES[shape])[0]:
            continue
        s, js = SHAPES[shape], JAX_SHAPES[shape]
        port_tree = batch_spec(cfg, s.seq_len, s.global_batch, s.mode)
        jax_tree = jax_batch_spec(jcfg, js.seq_len, js.global_batch, js.mode)
        for m in MESHES.values():
            for layout in LAYOUTS:
                _assert_same_specs(
                    batch_specs(port_tree, m, s, layout=layout),
                    jax_batch_specs(jax_tree, m, js, layout=layout))


@pytest.mark.parametrize("name", sorted(n for n, c in ARCHS.items()
                                        if not c.is_encoder))
def test_cache_specs_equal_jax(name):
    cfg, jcfg = get_arch(name), JAX_ARCHS[name]
    decode = [s for s in sorted(SHAPES) if SHAPES[s].mode == "decode"
              and shape_supported(cfg, SHAPES[s])[0]]
    assert decode
    for shape in decode:
        s = SHAPES[shape]
        assert jax_shape_supported(jcfg, JAX_SHAPES[shape])[0]
        got_tree = cache_shapes(cfg, s.global_batch, s.seq_len)
        want_tree = jax.eval_shape(lambda: jax_init_cache(
            jcfg, s.global_batch, s.seq_len))
        for m in MESHES.values():
            _assert_same_specs(
                cache_specs(got_tree, m, s, s.global_batch),
                jax_cache_specs(want_tree, m, JAX_SHAPES[shape],
                                s.global_batch))


def test_cache_shapes_are_init_caches():
    cfg = get_arch("jamba-v0.1-52b").reduced()
    from repro_torch.models import init_cache
    got = _port_flat(cache_shapes(cfg, 2, 16))
    want = _port_flat(init_cache(cfg, 2, 16, device="cpu"))
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert got[k] == (tuple(t.shape), t.dtype)


# ------------------------------------ tests/test_sharding.py, restated ------

@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("layout", ["tp", "fsdp"])
def test_specs_valid_for_all_archs(name, layout):
    ps = _shapes(name)
    specs = param_specs(ps, MESH, zero3=True, layout=layout)
    flat_p, flat_s = _port_flat(ps), _port_flat(specs)
    assert sorted(flat_p) == sorted(flat_s)
    for k, (shape, _) in flat_p.items():
        spec = flat_s[k]
        assert len(spec) <= len(shape)
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            n = math.prod(MESH.shape[a]
                          for a in (ax if isinstance(ax, tuple) else (ax,)))
            assert shape[dim] % n == 0, (name, shape, spec)
        used = [a for ax in spec if ax is not None
                for a in (ax if isinstance(ax, tuple) else (ax,))]
        assert len(used) == len(set(used))


@pytest.mark.parametrize("name,budget_gib", [("llama3-405b", 4.0),
                                             ("deepseek-v3-671b", 6.0)])
def test_big_models_fit_param_budget(name, budget_gib):
    """With ZeRO-3, the plan's bf16 bytes per device stay within budget,
    and equal JAX's count."""
    ps = _shapes(name)
    per_dev = plan_bytes(ps, param_specs(ps, MESH, zero3=True), MESH)
    assert per_dev < budget_gib * 2 ** 30, per_dev / 2 ** 30
    jps = _jax_shapes(name)
    jspecs = jax_param_specs(jps, MESH, zero3=True)
    leaves = zip(jax.tree.leaves(jps), jax.tree.leaves(
        jspecs, is_leaf=lambda x: isinstance(x, JaxP)))
    want = sum(leaf.size * leaf.dtype.itemsize // spec_shards(spec, MESH)
               for leaf, spec in leaves)
    assert per_dev == want


def test_fsdp_layout_more_sharded_than_tp():
    ps = _shapes("rwkv6-7b")
    tp = plan_bytes(ps, param_specs(ps, MESH, layout="tp"), MESH)
    fs = plan_bytes(ps, param_specs(ps, MESH, layout="fsdp"), MESH)
    assert fs < tp * 0.25


def test_activation_rules_modes():
    tr = activation_rules(MESH, SHAPES["train_4k"])
    assert tr["act_resid"] == P("data", None, None)
    dec = activation_rules(MESH, SHAPES["decode_32k"])
    assert "cache_kv" in dec
    long = activation_rules(MESH, SHAPES["long_500k"])
    # batch=1: cache sharded over data+model on the sequence dim
    assert long["cache_kv"][1] == ("data", "model")
    sp = activation_rules(MESH, SHAPES["train_4k"], layout="sp")
    assert sp["act_resid"] == P("data", "model", None)


def test_batch_specs_divisibility():
    cfg = get_arch("granite-20b")
    specs = batch_specs(batch_spec(cfg, 4096, 256, "train"), MESH,
                        SHAPES["train_4k"])
    assert specs["tokens"][0] == "data"
    specs1 = batch_specs(batch_spec(cfg, 524288, 1, "decode"), MESH,
                         SHAPES["long_500k"])
    assert specs1["token"] == P(None, None)  # batch 1 unshardable


def test_multipod_batch_over_pod_and_data():
    cfg = get_arch("granite-20b")
    specs = batch_specs(batch_spec(cfg, 4096, 256, "train"), MESH_MP,
                        SHAPES["train_4k"])
    assert specs["tokens"][0] == ("pod", "data")


def test_specs_compare_as_jax_partition_specs():
    assert P("data", None) == JaxP("data", None)
    assert tuple(P(("pod", "data"), None)) == tuple(JaxP(("pod", "data"),
                                                         None))
    assert repr(P("model")) == "P('model',)"
    for name in ("param_specs", "activation_rules", "batch_specs",
                 "cache_specs", "data_axes_of"):
        assert callable(getattr(sharding, name))
    assert sharding.data_axes_of(MESH_MP) == ("pod", "data")


# ---------------------------------------------------------- Sharder -------

SHAPE_CASES = [("act_resid", (256, 4096, 2048)), ("act_resid", (3, 4096, 8)),
               ("act_qkv", (256, 4096, 32, 128)), ("act_qkv", (256, 4096, 6,
                                                               128)),
               ("act_ffn", (256, 4096, 8192)), ("act_ffn", (256, 4096)),
               ("cache_kv", (128, 32768, 8, 128)), ("nope", (2, 2, 2))]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "2x2"])
def test_sharder_constraint_is_jax_act(mesh, monkeypatch):
    """JAX's ``Sharder.act`` applies ``with_sharding_constraint`` with the
    rule's spec unless it skips; recorded on an abstract array, the port's
    ``constraint`` names the same spec (or None), and its ``act`` returns
    the rank's tensor itself."""
    m = MESHES[mesh]
    seen = []
    monkeypatch.setattr(jax_shard, "NamedSharding", lambda _m, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    for shape_name in ("train_4k", "decode_32k"):
        rules = activation_rules(m, SHAPES[shape_name])
        jrules = jax_activation_rules(m, JAX_SHAPES[shape_name])
        port, ref = Sharder(m, rules), JaxSharder(m, jrules)
        for name, shape in SHAPE_CASES:
            seen.clear()
            ref.act(jax.ShapeDtypeStruct(shape, np.float32), name)
            got = port.constraint(shape, name)
            assert (None if not seen else seen[0]) == (
                None if got is None else tuple(got)), (name, shape)
            x = torch.zeros(1)
            assert port.act(x, name) is x


def _rank_mesh(shape, names, rank):
    coords = np.unravel_index(rank, shape)
    return NamedMesh(axis_names=names, shape=dict(zip(names, shape)),
                     rank=rank, axes={n: Axis(n, s, int(c)) for n, s, c in
                                      zip(names, shape, coords)})


@pytest.mark.parametrize("spec", [P("data", None), P(None, "model"),
                                  P(("data", "model"), None),
                                  P(("model", "data"), None),
                                  P("model", "data"), P(None, None)])
def test_place_blocks_tile_the_global_tensor(spec):
    """Each rank's block under ``spec``; laid out by the block's index
    over each dim's axes (the first the major one, as a
    ``NamedSharding`` of a tuple entry), the blocks rebuild the tensor,
    and a rank's block equals its slice."""
    shape, names = (2, 2), ("data", "model")
    x = torch.arange(8 * 12).reshape(8, 12)
    rebuilt = torch.full_like(x, -1)
    for rank in range(4):
        lm = _rank_mesh(shape, names, rank)
        block = Sharder(lm, {}).place(x, spec)
        sl = []
        for dim, ax in enumerate(spec):
            axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
            index, count = lm.block(axes)
            n = x.shape[dim] // count
            sl.append(slice(index * n, (index + 1) * n))
        assert torch.equal(block, x[tuple(sl)])
        rebuilt[tuple(sl)] = block
    assert torch.equal(rebuilt, x)


def test_place_params_blocks_only_the_experts():
    cfg = get_arch("qwen2-moe-a2.7b").reduced()
    from repro_torch.models import init_params
    params = init_params(cfg, device="cpu")
    lm = _rank_mesh((2, 2), ("data", "model"), 3)
    sh = Sharder(lm, {})
    specs = param_specs(param_shapes(cfg), lm, zero3=True)
    placed = _port_flat(sh.place_params(params, specs))
    whole = _port_flat(params)
    for k, t in whole.items():
        if k.endswith(("['ewg']", "['ewu']", "['ewo']")):
            e = t.shape[-3] // 2
            assert torch.equal(placed[k], t.narrow(t.dim() - 3, e, e)), k
        else:
            assert placed[k] is t, k
    batch = sh.place_batch({"tokens": np.arange(8).reshape(4, 2)},
                           batch_specs(batch_spec(cfg, 2, 4, "prefill"), lm,
                                       SHAPES["prefill_32k"]))
    assert batch["tokens"].tolist() == [[4, 5], [6, 7]]


# ------------------------------------------------------- the builders -----

def test_production_mesh_needs_its_ranks():
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} ranks.*torchrun"):
            launch_mesh.make_production_mesh(multi_pod=multi_pod)
        with pytest.raises(RuntimeError, match=f"need {n} devices"):
            jax_launch_mesh.make_production_mesh(multi_pod=multi_pod)


def test_host_mesh_is_jax_host_mesh():
    got = launch_mesh.make_host_mesh(1)
    want = jax_launch_mesh.make_host_mesh(1)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.size == 1 and all(a.group is None for a in got.axes.values())
    assert got.block(("data", "model")) == (0, 1)


def test_named_mesh_refusals():
    with pytest.raises(ValueError, match="distinct name"):
        make_named_mesh((1, 1), ("data", "data"))
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_named_mesh((2, 2), ("data", "model"))
    assert make_named_mesh((1, 1, 1), ("pod", "data", "model")).shape == {
        "pod": 1, "data": 1, "model": 1}
