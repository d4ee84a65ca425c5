"""Tensor parallelism on the LM mesh's serving path against the JAX
package on the CPU: a rank holds the attention heads, the MLP's and the
MoE shared experts' d_ff and the vocabulary as its blocks over ``model``
(``repro_torch.models.shard.block_leaves``, by JAX's ``param_specs``, the
same blocks as training's), beside the expert blocks, and computes its
heads, its d_ff columns and its vocabulary block of the logits.

The reference is one JAX child on 4 forced host devices
(``--xla_force_host_platform_device_count=4``, as
tests/test_torch_lm_mesh.py's), run once for the module: JAX's jitted
prefill and decode steps under ``ModelCtx(mesh, moe_mode, Sharder(mesh,
activation_rules(...)))``, whose ``act_qkv``/``act_ffn`` put the heads and
d_ff over ``model``.  The weights are the port's seeded ``init_params``
handed to both sides, so the child and the port's one spawn of 4 gloo
CPU ranks (``torch_mesh_ranks.lm_tp_runs``: (2,2), (1,4) and two
side-by-side (1,2) meshes) run at the same time.

Bars: reduced qwen2-moe with its own 60 experts (the ``OVER`` of
tests/test_torch_lm_mesh.py; allreduce at (1,2) and (2,2), where the
shared experts' partial joins the routed one's all-reduce, alltoall at
(1,4), where it takes its own) and reduced gemma3-4b (all 6 layers: its
window layers through B7's wrapper and its global layer) at (1,2), (2,2)
and (1,4), reduced granite-20b (one kv head) at (1,2), and reduced
granite-20b with 6 heads over 3 kv heads at (1,2), whose query heads
read kv heads across a rank's block: the prefill logits and 2 greedy
decode steps within 1e-4 of JAX's, the tokens equal; each rank's bytes of
its blocks equal to JAX's plan (``param_specs(zero3=False)``).  With no
collectives (``core.mesh.shape_mesh``, meta tensors): every arch's full
config at (1,4) and 16×16 holds its blocks at JAX's plan to the byte,
RWKV's channel mix stays whole, a dense layer's forward sums twice over
``model``, a train step's backward takes Megatron's f as many times as
chip_smoke.py's ``lm_f_backward`` predicts, the decode cache holds the
rank's kv heads, and the train step, ``loss_and_grads`` and the eval step
refuse a tree placed in another layout, naming its first such leaf."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import mesh as core_mesh
from repro_torch.launch import dryrun
from repro_torch.models import (ModelCtx, cache_shapes, init_params,
                                loss_and_grads, make_eval_step,
                                make_train_step, param_shapes)
from repro_torch.models.attention import rank_kv_heads
from repro_torch.models.common import tree_map
from repro_torch.models.shard import (ATTENTION, EMBED, EXPERTS, FFN,
                                      TENSOR_PARALLEL, Sharder, block_bytes,
                                      block_dims, block_leaves, leaf_kinds)
from repro_torch.optim import adam_init
from repro_torch.sharding import param_specs
from test_torch_walk import _chip_smoke
from torch_mesh_ranks import lm_tp_runs

QWEN = ("qwen2-moe-a2.7b", dict(dtype="float32", n_experts=60,
                                experts_per_token=4))
GEMMA = ("gemma3-4b", dict(dtype="float32"))
GRANITE = ("granite-20b", dict(dtype="float32"))
MIXED = ("granite-20b", dict(dtype="float32", n_heads=6, n_kv_heads=3))
CONFIGS = {"qwen": QWEN, "gemma": GEMMA, "granite": GRANITE,
           "granite_mixed": MIXED}
# (config, mesh shape, MoE mode)
RUNS = (("qwen", (1, 2), "allreduce"), ("qwen", (2, 2), "allreduce"),
        ("qwen", (1, 4), "alltoall"), ("gemma", (1, 2), "dense"),
        ("gemma", (2, 2), "dense"), ("gemma", (1, 4), "dense"),
        ("granite", (1, 2), "dense"), ("granite_mixed", (1, 2), "dense"))
B, T, STEPS, SLOTS = 4, 16, 2, 24
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
SPAWN_TIMEOUT_S = 240.0

_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses, numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.models import (ModelCtx, Sharder, init_cache, init_params,
                              make_decode_step, make_prefill)
    from repro.sharding import activation_rules
    from repro.sharding.compat import auto_axis_types_kw

    weights, out_path, b, t, steps, slots = (sys.argv[1], sys.argv[2],
                                             *map(int, sys.argv[3:7]))
    z = np.load(weights)
    out = {}

    def mesh_of(shape):
        devs = np.asarray(jax.devices()[:shape[0] * shape[1]])
        return jax.sharding.Mesh(devs.reshape(shape), ("data", "model"),
                                 **auto_axis_types_kw(2))

    tokens, first = jnp.asarray(z["tokens"]), jnp.asarray(z["first"])
    for key, (arch, over) in %(configs)r.items():
        cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
        like = jax.eval_shape(lambda k: init_params(k, cfg),
                              jax.random.key(0))
        flat, tree = jax.tree_util.tree_flatten_with_path(like)
        params = jax.tree_util.tree_unflatten(tree, [
            jnp.asarray(z[key + jax.tree_util.keystr(p)]) for p, _ in flat])
        for name, shape, mode in %(runs)r:
            if name != key:
                continue
            mesh = mesh_of(shape)
            run = f"{name}/{shape}"
            shp = ShapeConfig("prefill", t, b, "prefill")
            ctx = ModelCtx(mesh=mesh, moe_mode=mode, remat=False,
                           sharder=Sharder(mesh, activation_rules(mesh,
                                                                  shp)))
            logits, _ = jax.jit(make_prefill(cfg, ctx))(params,
                                                         {"tokens": tokens})
            out[run + "/prefill"] = np.asarray(logits)
            dshp = ShapeConfig("decode", slots, b, "decode")
            dctx = ModelCtx(mesh=mesh, moe_mode=mode, remat=False,
                            sharder=Sharder(mesh, activation_rules(mesh,
                                                                   dshp)))
            dec = jax.jit(make_decode_step(cfg, dctx))
            cache, cur = init_cache(cfg, b, slots), first
            for i in range(steps):
                logits, nxt, cache = dec(params, cache, cur,
                                         jnp.full((b,), i, jnp.int32))
                out[f"{run}/decode{i}"] = np.asarray(logits)
                out[f"{run}/next{i}"] = np.asarray(nxt)
                cur = nxt[:, None].astype(jnp.int32)
    np.savez(out_path, **out)
""") % dict(configs=CONFIGS, runs=RUNS)


def _cfg(key):
    arch, over = CONFIGS[key]
    return dataclasses.replace(get_arch(arch).reduced(), **over)


def _keyed(tree, path=""):
    """{JAX keystr path: numpy leaf} of a parameter tree."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _keyed(v, f"{path}[{k!r}]").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _keyed(v, f"{path}[{i}]").items()}
    return {path: tree}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX's outputs, each rank's): the JAX child started first, the
    ranks spawned while it compiles, on the same seeded weights."""
    tmp = tmp_path_factory.mktemp("lm_tp")
    weights = {key: tree_map(lambda a: a.numpy(),
                             init_params(_cfg(key), seed=7, device="cpu"))
               for key in CONFIGS}
    rng = np.random.default_rng(11)
    vocab = {_cfg(key).vocab_size for key in CONFIGS}.pop()
    tokens = rng.integers(0, vocab, (B, T), dtype=np.int32)
    first = rng.integers(0, vocab, (B, 1), dtype=np.int32)
    flat = {key + k: v for key in CONFIGS
            for k, v in _keyed(weights[key]).items()}
    wpath, opath = str(tmp / "weights.npz"), str(tmp / "ref.npz")
    np.savez(wpath, tokens=tokens, first=first, **flat)
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD, wpath, opath, str(B), str(T),
         str(STEPS), str(SLOTS)], env=dict(os.environ, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        runs = tuple((name, CONFIGS[name], shape, mode)
                     for name, shape, mode in RUNS)
        ranks = core_mesh.spawn_mesh(
            lm_tp_runs, 1, 4, device="cpu", backend="gloo",
            timeout_s=SPAWN_TIMEOUT_S,
            args=(runs, weights, tokens, first, STEPS, SLOTS))
        _, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
    assert child.returncode == 0, err[-4000:]
    with np.load(opath) as z:
        return dict(z), ranks


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0]}-{r[1][0]}x"
                         f"{r[1][1]}-{r[2]}")
def test_serving_blocks_match_jax(run, results):
    """Each rank's prefill logits and decode steps on its blocks within
    1e-4 of JAX's, the greedy tokens equal, and its bytes of the blocks
    JAX's plan to the byte."""
    ref, ranks = results
    name, shape, _ = run
    key = f"{name}/{shape}"
    per = [r[key] for r in ranks]
    assert len(per) == 4        # at (1,2) two meshes side by side
    for i, got in enumerate(per):
        rows = slice(*got["rows"])
        np.testing.assert_allclose(got["prefill"],
                                   ref[key + "/prefill"][rows],
                                   **MODEL_TOL, err_msg=f"rank {i}")
        assert len(got["decode"]) == STEPS
        for s, (logits, nxt) in enumerate(got["decode"]):
            np.testing.assert_allclose(logits, ref[f"{key}/decode{s}"][rows],
                                       **MODEL_TOL,
                                       err_msg=f"rank {i} step {s}")
            assert np.array_equal(nxt, ref[f"{key}/next{s}"][rows]), (i, s)
        held, plan = got["block_bytes"]
        assert held == plan > 0, (i, held, plan)


def test_a_dense_layer_sums_twice_over_model_on_gloo_ranks(results):
    """On gloo ranks: reduced gemma3-4b's prefill at (1,4) sums the
    embedding's rows once and each of its 6 layers twice over ``model``
    (the attention's and the MLP's partials), and gathers the head's
    logits once."""
    _, ranks = results
    traffic = ranks[0]["gemma/(1, 4)"]["traffic"]
    assert traffic["all_reduce model"][0] == 1 + 2 * 6
    assert traffic["all_gather model"][0] == 1


def test_greedy_pick_keeps_the_first_index_on_ties(results):
    """Alg. 4's pick over 4 ranks: the largest logit's first index over
    the whole vocabulary, also where ranks tie (``torch.argmax``'s rule),
    on vocabulary blocks of 5."""
    _, ranks = results
    for r in ranks:
        got, want = r["ties"]
        assert got == want, (got, want)


def test_rank_kv_heads_maps_query_heads_to_their_kv_heads():
    cfg = _cfg("granite_mixed")                  # H 6, KV 3: g = 2
    assert rank_kv_heads(cfg, 3, 0) == (0, 2, [0, 0, 1])
    assert rank_kv_heads(cfg, 3, 1) == (1, 2, [0, 1, 1])
    assert rank_kv_heads(_cfg("granite"), 2, 1) == (0, 1, None)
    assert rank_kv_heads(_cfg("gemma"), 1, 3) == (3, 1, None)
    full = get_arch("gemma3-4b")                 # H 8, KV 4
    assert rank_kv_heads(full, 2, 3) == (3, 1, None)


# ----------------------------------------------- shapes, no collectives ----

def _rank_of(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    return core_mesh.shape_mesh(shape, names)


def _meta(shapes):
    return dryrun.meta_tree(shapes)


@pytest.mark.parametrize("shape", [(1, 4), (16, 16)], ids=lambda s:
                         f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_block_bytes_are_jax_plan_for_every_arch(arch, shape):
    """Every arch's full config: a serving rank's bytes of the leaves it
    holds as blocks equal JAX's ``param_specs(zero3=False)`` plan of them,
    to the byte, and each block is 1/m of its leaf on the dim of JAX's
    ``model`` entry."""
    cfg, lm = get_arch(arch), _rank_of(shape)
    shapes = param_shapes(cfg)
    specs = param_specs(shapes, lm)
    names = block_leaves(lm, "allreduce" if cfg.is_moe else "dense")
    placed = Sharder(lm, {}).place_params(_meta(shapes), specs, names)
    held, plan = block_bytes(placed, shapes, specs, lm, names)
    assert held == plan > 0
    m = shape[1]

    def check(path, x, dim, whole):
        want = list(whole[0])
        if dim is not None:
            want[dim] //= m
        assert list(x.shape) == want, path
    from repro_torch.sharding.rules import map_with_path
    map_with_path(check, placed, block_dims(specs, names), shapes)


def test_path_matching_keeps_rwkv_and_mla_whole():
    """RWKV's channel mix has ``wk``/``wv`` (and its mixer ``wk``, ``wv``,
    ``wo``), MLA's mixer a ``wo``: JAX's rules put ``model`` on them, the
    serving set holds them whole; a GQA mixer's and an MLP's split."""
    lm = _rank_of((1, 4))
    for arch in ("rwkv6-7b", "deepseek-v3-671b"):
        cfg = get_arch(arch)
        specs = param_specs(param_shapes(cfg), lm)
        dims = block_dims(specs, block_leaves(lm, "allreduce"))
        kinds = leaf_kinds(specs)
        blk, kblk, sblk = (dims["segments"][0][0], kinds["segments"][0][0],
                           specs["segments"][0][0])
        for part, name in (("ffn", "wk"), ("ffn", "wv"), ("mixer", "wk"),
                           ("mixer", "wv"), ("mixer", "wo")):
            if name in blk[part]:
                assert "model" in sblk[part][name], (arch, part, name)
                assert blk[part][name] is None and \
                    kblk[part][name] is None, (arch, part, name)
        assert dims["embed"] == 0 and kinds["embed"] == EMBED
    qwen = param_specs(param_shapes(get_arch("qwen2-moe-a2.7b")), lm)
    kinds = leaf_kinds(qwen)["segments"][0][0]
    assert kinds["mixer"] == dict.fromkeys(("wq", "wk", "wv", "wo"),
                                           ATTENTION)
    assert kinds["ffn"]["shared"] == dict.fromkeys(("wu", "wo", "wg"), FFN)
    assert {kinds["ffn"][k] for k in ("ewg", "ewu", "ewo")} == {EXPERTS}
    assert kinds["ffn"]["router"] is None
    assert block_leaves(lm, "allreduce") == (EXPERTS, ATTENTION, FFN, EMBED)
    assert block_leaves(lm, "dense") == TENSOR_PARALLEL == (ATTENTION, FFN,
                                                            EMBED)
    assert block_leaves(None, "allreduce") == ()


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_traffic_is_two_all_reduces_a_dense_layer(mode):
    """A serving rank of reduced gemma3-4b (6 layers) at (1,4) on a
    shape-only mesh: the embedding's one all-reduce over ``model``, two a
    layer, of (B/dp, T, d), and the head's gathers (the logits; at decode
    also Alg. 4's (value, index) pairs)."""
    cfg = _cfg("gemma")
    lm = _rank_of((1, 4))
    t = 1 if mode == "decode" else 16
    shape = ShapeConfig(mode, 16 if mode == "decode" else t, 4, mode)
    rs = dryrun.rank_step(cfg, shape, lm, moe_mode="dense")
    core_mesh.reset_traffic(lm)
    rs.step(*rs.args)
    traffic = core_mesh.reset_traffic(lm)
    row = 4 * t * cfg.d_model * 4
    assert traffic["all_reduce model"] == [1 + 2 * 6, (1 + 2 * 6) * row]
    gathers = 2 if mode == "decode" else 1
    assert traffic["all_gather model"][0] == gathers
    assert set(traffic) == {"all_reduce model", "all_gather model"}


def test_decode_cache_holds_the_rank_kv_heads():
    """``cache_shapes(mesh=)``: the kv heads a rank's query heads read."""
    for arch, shape, want in (("gemma3-4b", (1, 4), 1),
                              ("granite-20b", (1, 4), 1),
                              ("qwen2-moe-a2.7b", (16, 16), 1),
                              ("llama3-405b", (16, 16), 1),
                              ("gemma3-4b", (16, 16), 4)):
        cfg = get_arch(arch)
        cs = cache_shapes(cfg, 8, 32, mesh=_rank_of(shape))
        k = cs[0][0]["k"][0]
        assert k[-2] == want, (arch, shape, k)
        assert cache_shapes(cfg, 8, 32)[0][0]["k"][0][-2] == cfg.n_kv_heads


# (config key, MoE mode, "all_reduce model backward" of a train step at
# (1,4)): a layer's attention 1 (granite-20b's whole wk/wv 2 more, MLA
# none), its MLP 1, its MoE layer 2 in allreduce, 3 in alltoall (the
# shared experts' own), 1 in dense; the head 1 a loss (deepseek's MTP 2)
F_CASES = (("qwen", "allreduce", 7), ("qwen", "alltoall", 9),
           ("qwen", "dense", 5), ("gemma", "dense", 13),
           ("granite", "dense", 9), ("deepseek", "allreduce", 5))


@pytest.mark.parametrize("case", F_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_train_step_takes_megatrons_f_as_predicted(case):
    """A train rank of a reduced config at (1,4) on a shape-only mesh: the
    backward's all-reduces over ``model`` (Megatron's f: the split heads'
    input, whole wk/wv at KV % m != 0, the split d_ff's input, the MoE
    layer's tokens and router, the head's hidden) are the count that
    chip_smoke.py's ``lm_f_backward`` gives from the layer program, and
    the loss takes each chunk's max over ``model``."""
    key, mode, want = case
    arch, over = CONFIGS.get(key, ("deepseek-v3-671b", {}))
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over,
                              **({"mtp_weight": 0.3} if key == "deepseek"
                                 else {}))
    lm = _rank_of((1, 4))
    rs = dryrun.rank_step(cfg, ShapeConfig("train", 16, 4, "train"), lm,
                          moe_mode=mode)
    core_mesh.reset_traffic(lm)
    rs.step(*rs.args)
    traffic = core_mesh.reset_traffic(lm)
    assert traffic["all_reduce model backward"][0] == want
    assert _chip_smoke().lm_f_backward(cfg, 4, rs.ctx.moe_mode) == want
    # one chunk a loss (two with the MTP head), in the forward and again
    # in the backward's recomputation
    losses = 1 + (key == "deepseek")
    assert traffic["all_reduce_max model"][0] == 2 * losses


def test_steps_refuse_a_tree_in_another_layout():
    """The train step, ``loss_and_grads`` and the eval step take a tree
    placed as ``block_leaves(mesh, moe_mode)`` says, and raise naming the
    first leaf that is not: the expert-only layout (the embedding whole),
    and a tree placed for the dense MoE layer stepped in allreduce mode
    (the experts whole)."""
    lm = _rank_of((1, 4))
    cases = (("qwen", "allreduce", (EXPERTS,), "['embed']"),
             ("qwen", "allreduce", block_leaves(lm, "dense"),
              "['segments'][0][0]['ffn']['ewg']"),
             ("gemma", "dense", (), "['embed']"))
    for key, mode, names, leaf in cases:
        cfg = _cfg(key)
        shapes = param_shapes(cfg)
        params = Sharder(lm, {}).place_params(
            _meta(shapes), param_specs(shapes, lm), names)
        ctx = ModelCtx(mesh=lm, moe_mode=mode)
        batch = {"tokens": torch.zeros((4, 16), dtype=torch.int32,
                                       device="meta")}
        for call in (lambda: make_train_step(cfg, ctx)(
                         params, adam_init(params), batch),
                     lambda: loss_and_grads(params, cfg, batch, ctx),
                     lambda: make_eval_step(cfg, ctx)(params, batch)):
            with pytest.raises(ValueError) as err:
                call()
            assert f"the leaf {leaf} is" in str(err.value), (key, names)
