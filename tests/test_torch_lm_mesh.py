"""The port's LM mesh against the JAX package on the CPU: the
expert-parallel MoE layer (``repro_torch.models.ffn.moe_sharded_apply``)
in its three modes and the reduced qwen2-moe model on the mesh, on gloo
ranks started by ``spawn_mesh``, held to JAX's ``shard_map`` on forced
host devices.

The config is reduced qwen2-moe-a2.7b with its own 60 routed experts
(top-4) in place of the reduced 4: padded to 64, they put routed experts
on every ``model`` rank at m ≤ 4 and padded ones on the last, so the
ranks' partials must combine.  The reference is one JAX child process
under ``--xla_force_host_platform_device_count=4`` (as
tests/test_engine.py's spatial child), run once for the module: it
writes JAX's weights, outputs and aux losses to an npz.

Bars: the layer at (1,1) in process and at (1,2), (2,2) and (1,4) on
gloo ranks, every mode, capacity factors 1.25 and 64, each rank's rows
within rtol 1e-5 / atol 1e-5 of JAX's and the aux loss too (JAX's is data
shard 0's at dp > 1); at 64 (no drops) also within 1e-4 of the port's
``moe_dense_apply`` (JAX's own bar, tests/test_models.py).  The reduced
model in f32 at (2,2) allreduce and (1,4) alltoall, on the serving
blocks (tensor-parallel heads, shared d_ff and vocabulary beside the
experts): the prefill logits and 2 greedy decode steps (logits and
tokens) within 1e-4 of JAX's jitted steps under ``ModelCtx(mesh,
moe_mode, Sharder(...))``.  ``all_to_all``
exchanges rank-stamped blocks and is counted in ``Mesh.traffic``; whole
experts on a split ``model`` axis are refused; ``moe_apply(mode="dense")``
on a mesh is the dense layer; a gradient passes the layer and the train
and eval steps run on a one-rank mesh (their bars on 2 and 4 ranks are
tests/test_torch_lm_mesh_train.py's)."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import mesh as core_mesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ModelCtx
from repro_torch.models.ffn import (moe_apply, moe_dense_apply,
                                    moe_sharded_apply)
from torch_mesh_ranks import LM_MODES, lm_mesh_shapes

ARCH = "qwen2-moe-a2.7b"
OVER = dict(dtype="float32", n_experts=60, experts_per_token=4)
SHAPES = ((1, 1), (1, 2), (2, 2), (1, 4))
FACTORS = (1.25, 64.0)
RUNS = (((2, 2), "allreduce"), ((1, 4), "alltoall"))
B, T, STEPS, SLOTS = 4, 8, 2, 8
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
SPAWN_TIMEOUT_S = 180.0

_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses, numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.models import (ModelCtx, Sharder, init_cache, init_params,
                              make_decode_step, make_prefill)
    from repro.models.ffn import init_moe, moe_dense_apply, moe_sharded_apply
    from repro.sharding import activation_rules
    from repro.sharding.compat import auto_axis_types_kw

    out_path, b, t, steps, slots = sys.argv[1], *map(int, sys.argv[2:6])
    cfg = dataclasses.replace(get_arch("%(arch)s").reduced(), **%(over)r)
    out = {}

    def mesh_of(shape):
        devs = np.asarray(jax.devices()[:shape[0] * shape[1]])
        return jax.sharding.Mesh(devs.reshape(shape), ("data", "model"),
                                 **auto_axis_types_kw(2))

    def save_tree(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

    moe = init_moe(jax.random.key(5), cfg, jnp.float32)
    save_tree("moe", moe)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (b, t, cfg.d_model)), jnp.float32)
    y, aux = moe_dense_apply(moe, x, cfg=cfg)
    out["dense"], out["dense_aux"] = np.asarray(y), np.asarray(aux)
    for shape in %(shapes)r:
        mesh = mesh_of(shape)
        for mode in %(modes)r:
            for cf in %(factors)r:
                fn = jax.jit(lambda p, x: moe_sharded_apply(
                    p, x, cfg=cfg, mesh=mesh, mode=mode, capacity_factor=cf))
                y, aux = fn(moe, x)
                key = f"layer/{shape}/{mode}/{cf}"
                out[key], out[key + "/aux"] = np.asarray(y), np.asarray(aux)

    params = init_params(jax.random.key(0), cfg)
    save_tree("params", params)
    rng = np.random.default_rng(3)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (b, t)), jnp.int32)
    tok = jnp.asarray(rng.integers(0, cfg.vocab_size, (b, 1)), jnp.int32)
    out["tokens"], out["first"] = np.asarray(tokens), np.asarray(tok)
    for shape, mode in %(runs)r:
        mesh = mesh_of(shape)
        key = f"model/{shape}/{mode}"
        shp = ShapeConfig("prefill", t, b, "prefill")
        ctx = ModelCtx(mesh=mesh, moe_mode=mode, remat=False,
                       sharder=Sharder(mesh, activation_rules(mesh, shp)))
        logits, _ = jax.jit(make_prefill(cfg, ctx))(params,
                                                     {"tokens": tokens})
        out[key + "/prefill"] = np.asarray(logits)
        dshp = ShapeConfig("decode", slots, b, "decode")
        dctx = ModelCtx(mesh=mesh, moe_mode=mode, remat=False,
                        sharder=Sharder(mesh, activation_rules(mesh, dshp)))
        dec = jax.jit(make_decode_step(cfg, dctx))
        cache, cur = init_cache(cfg, b, slots), tok
        for i in range(steps):
            logits, nxt, cache = dec(params, cache, cur,
                                     jnp.full((b,), i, jnp.int32))
            out[f"{key}/decode{i}"] = np.asarray(logits)
            out[f"{key}/next{i}"] = np.asarray(nxt)
            cur = nxt[:, None].astype(jnp.int32)
    np.savez(out_path, **out)
""") % dict(arch=ARCH, over=OVER, shapes=SHAPES, modes=LM_MODES,
            factors=FACTORS, runs=RUNS)


def _cfg():
    return dataclasses.replace(get_arch(ARCH).reduced(), **OVER)


def _tree(ref, prefix, like):
    """The tree of ``like``'s structure from the child's leaves."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(treedef, [
        ref[prefix + jax.tree_util.keystr(path)] for path, _ in flat])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's weights and results, from one child on 4 forced devices."""
    path = str(tmp_path_factory.mktemp("lm_mesh") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _CHILD, path, str(B),
                           str(T), str(STEPS), str(SLOTS)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        out = dict(z)
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), **OVER)
    shapes = jax.eval_shape(lambda k: jax_init_params(k, jcfg),
                            jax.random.key(0))
    out["params_tree"] = _tree(out, "params", shapes)
    out["moe_tree"] = {k: (_tree(out, f"moe['{k}']", {"wu": 0, "wo": 0,
                                                      "wg": 0})
                           if k == "shared" else out[f"moe['{k}']"])
                       for k in ("router", "ewg", "ewu", "ewo", "shared")}
    out["x"] = np.random.default_rng(2).standard_normal(
        (B, T, _cfg().d_model)).astype(np.float32)
    return out


def _torch_moe(moe, device="cpu"):
    return {k: ({n: torch.as_tensor(a, device=device) for n, a in v.items()}
                if isinstance(v, dict) else torch.as_tensor(v, device=device))
            for k, v in moe.items()}


@pytest.fixture(scope="module")
def ranks(ref):
    """Each rank's results: (1,2) in a spawn of 2 ranks, (2,2) and (1,4)
    (the layer and the model runs) in one spawn of 4."""
    cfg = _cfg()
    model = (ref["params_tree"], RUNS, ref["tokens"], ref["first"], STEPS,
             SLOTS)
    out = {}
    for world, shapes, extra in ((2, ((1, 2),), None),
                                 (4, ((2, 2), (1, 4)), model)):
        got = core_mesh.spawn_mesh(
            lm_mesh_shapes, 1, world, device="cpu", backend="gloo",
            timeout_s=SPAWN_TIMEOUT_S,
            args=(cfg, ref["moe_tree"], ref["x"], FACTORS, shapes, extra))
        for shape in shapes:
            out[shape] = got
    return out



@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("mode", LM_MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_layer_matches_jax(shape, mode, cf, ref, ranks):
    key = f"layer/{shape}/{mode}/{cf}"
    want, want_aux = ref[key], float(ref[key + "/aux"])
    if shape == (1, 1):
        with torch.no_grad():
            y, aux = moe_sharded_apply(_torch_moe(ref["moe_tree"]),
                                       torch.from_numpy(ref["x"]),
                                       cfg=_cfg(), mesh=make_host_mesh(1),
                                       mode=mode, capacity_factor=cf)
        per_rank = [((0, B), y.numpy(), float(aux))]
    else:
        per_rank = [(r["layer", shape]["rows"],) + r["layer", shape][
            mode, cf][:2] for r in ranks[shape]]
    m = shape[1]
    for i, ((lo, hi), y, aux) in enumerate(per_rank):
        np.testing.assert_allclose(y, want[lo:hi], **TOL,
                                   err_msg=f"rank {i}")
        assert aux == pytest.approx(want_aux, rel=1e-5, abs=1e-5), (
            i, aux, want_aux)
        if cf == 64.0:
            dense, dense_aux = moe_dense_apply(
                _torch_moe(ref["moe_tree"]), torch.from_numpy(ref["x"]),
                cfg=_cfg())
            np.testing.assert_allclose(y, dense.numpy()[lo:hi], rtol=1e-4,
                                       atol=1e-4)
            if shape[0] == 1 and mode == "allreduce":
                # the whole batch on every rank: the global aux
                assert aux == pytest.approx(float(dense_aux), rel=1e-4)
    if shape != (1, 1):
        experts = {r["layer", shape]["expert_rows"][0] for r in ranks[shape]}
        assert experts == {64 // m}


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0][0]}x{r[0][1]}-"
                         f"{r[1]}")
def test_model_on_the_mesh_matches_jax(run, ref, ranks):
    shape, mode = run
    key = f"model/{shape}/{mode}"
    for i, r in enumerate(ranks[shape]):
        got = r["model", shape, mode]
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
        # the serving blocks (experts, heads, shared d_ff, vocabulary) are
        # JAX's plan to the byte, and at this size so is every leaf
        held, plan = got["block_bytes"]
        assert held == plan and got["bytes"] == got["plan_bytes"]


def test_all_to_all_exchanges_blocks_and_is_counted(ranks):
    for r in ranks[(1, 4)]:
        index, got, traffic = r["all_to_all"]
        want = np.stack([np.arange(3 * index, 3 * index + 3) + 100 * j
                         for j in range(4)]).astype(np.float32)
        np.testing.assert_array_equal(got, want)
        assert traffic == {"all_to_all model": [1, 4 * 3 * 4]}
    one = core_mesh.single_axis("model")
    t = torch.ones(1, 3)
    assert core_mesh.all_to_all(t, one) is t


def test_moe_layer_collectives_by_mode(ranks):
    """allreduce sums the partial outputs over ``model``; alltoall moves
    the capacity buffers there and back, then gathers the tokens; at dp >
    1 every mode takes data shard 0's aux over ``data``."""
    for shape in ((2, 2), (1, 4)):
        traffic = ranks[shape][0]["layer", shape]
        kinds = {mode: sorted(traffic[mode, 1.25][2]) for mode in LM_MODES}
        data = ["all_reduce data"] if shape[0] > 1 else []
        assert kinds["allreduce"] == sorted(data + ["all_reduce model"])
        for mode in ("alltoall", "alltoall_rep"):
            assert kinds[mode] == sorted(data + [
                "all_gather model", "all_reduce model", "all_to_all model"])
            assert traffic[mode, 1.25][2]["all_to_all model"][0] == 2
        assert "whole_error" in traffic and "place them" in \
            traffic["whole_error"]


def test_moe_gradient_on_a_one_rank_mesh_is_the_dense_layers(ref):
    """A gradient passes the expert-parallel layer (held to JAX's on 2 and
    4 ranks in tests/test_torch_lm_mesh_train.py): on a (1,1) mesh at
    factor 64, where no token drops, x's gradient is the dense layer's;
    ``moe_apply`` passes one in alltoall mode too."""
    p = _torch_moe(ref["moe_tree"])
    x = torch.from_numpy(ref["x"]).requires_grad_(True)

    def grad_x(y):
        return torch.autograd.grad(y.square().sum(), x)[0]
    want = grad_x(moe_dense_apply(p, x, cfg=_cfg())[0])
    got = grad_x(moe_sharded_apply(p, x, cfg=_cfg(), mesh=make_host_mesh(1),
                                   capacity_factor=64.0)[0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    got = grad_x(moe_apply(p, x, cfg=_cfg(), mesh=make_host_mesh(1),
                           mode="alltoall")[0])
    assert got.shape == x.shape and bool(torch.isfinite(got).all())


def test_moe_apply_dense_on_a_mesh_is_the_dense_layer(ref):
    p = _torch_moe(ref["moe_tree"])
    x = torch.from_numpy(ref["x"])
    want, want_aux = moe_dense_apply(p, x, cfg=_cfg())
    got, aux = moe_apply(p, x, cfg=_cfg(), mesh=make_host_mesh(1),
                         mode="dense")
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    np.testing.assert_allclose(want.numpy(), ref["dense"], **TOL)


def test_train_and_eval_steps_on_a_one_rank_mesh(ref):
    """The train and eval steps run on a mesh (held to JAX's on 2 and 4
    ranks in tests/test_torch_lm_mesh_train.py): on a (1,1) mesh the
    allreduce and alltoall layers route the same tokens with the same
    capacity, so their steps agree, and the eval step's metrics are the
    train step's."""
    from repro_torch.models import make_eval_step, make_train_step
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adam_init
    cfg = _cfg()
    batch = {"tokens": torch.from_numpy(ref["tokens"])}
    got = {}
    for mode in ("allreduce", "alltoall"):
        params = lm_params_from_numpy(ref["params_tree"], cfg, device="cpu")
        ctx = ModelCtx(mesh=make_host_mesh(1), moe_mode=mode)
        metrics = make_eval_step(cfg, ctx)(params, batch)
        _, _, m = make_train_step(cfg, ctx)(params, adam_init(params), batch,
                                            with_grads=True)
        for k in ("xent", "aux"):
            assert float(m[k]) == pytest.approx(float(metrics[k]), rel=1e-6)
        got[mode] = m
    a, b = got["allreduce"], got["alltoall"]
    assert float(a["loss"]) == pytest.approx(float(b["loss"]), rel=1e-6)
    assert float(a["grad_norm"]) == pytest.approx(float(b["grad_norm"]),
                                                  rel=1e-5)
    for ga, gb in zip(tree_leaves(a["grads"]), tree_leaves(b["grads"])):
        np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(gb.abs().max()))
