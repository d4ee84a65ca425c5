"""LM training on the port's LM mesh against the JAX package on the CPU:
the expert-parallel MoE layer's gradient in its three modes, the
vocabulary-parallel loss, the train step in lockstep on the mesh in JAX's
layout "tp" (a rank holds the experts, the GQA heads, the MLP's and
shared experts' d_ff and the vocabulary as its blocks over ``model``,
``models.shard.block_leaves``), the eval step and the launcher's
``--production-mesh``, on gloo ranks started by ``spawn_mesh``, held to
JAX's jitted steps on forced host devices.

The reference is JAX on forced host devices
(``--xla_force_host_platform_device_count=4``, as tests/test_torch_lm_mesh
.py's), in two child processes side by side that share the cases, run
once for the module; they write JAX's weights, states, gradients and
metrics to one npz a case.  The port runs in one spawn of 4 gloo CPU
ranks (``torch_mesh_ranks.lm_mesh_train``), started while the children
compile, which builds (2,2) and (1,4) meshes and two side-by-side (1,2)
ones, runs the launcher (which needs no file of theirs), then reads
JAX's trees from each file as it lands, converts them
(``lm_params_from_numpy``, ``lm_adam_from_numpy``) and places them.

The layer is reduced qwen2-moe with its own 60 experts (``OVER`` of
tests/test_torch_lm_mesh.py); the train cases cut its experts to 16 wide
(``TRAIN_OVER``), so that three states of every tree cross as files.

Bars:

- the layer's vjp of (output, aux) at (1,2), (2,2), (1,4) in every mode
  at factor 1.25, and at 64 at (2,2), with the gradients of ``x``, the
  router, the shared expert and the rank's expert blocks (summed over the
  data axes, as the train step sums them) within 1e-4·|g| + 1e-5·max|g|
  of ``jax.vjp``'s on the same cotangents; the router's gradient of the
  aux alone is JAX's mean over the devices of their own aux gradients
  (``test_router_gradient_is_the_mean_over_devices_aux_gradients``);
- the vocabulary-parallel ``xent_parts`` at (1,2) and (1,4), with a mask
  and a sequence remainder: the sum, count and the gradients of ``h`` and
  of the rank's rows of the head against the one-device function's by the
  rule above, and no tensor of a rank with the whole vocabulary as its
  last dim;
- the train step (lr 1e-3, clip 1.0, remat on) at (1,2) allreduce, (2,2)
  allreduce and alltoall and (1,4) alltoall, the reduced
  deepseek-v3-671b (MTP 0.3) and gemma3-4b at (2,2), gemma3-4b at (1,4)
  and granite-20b (one kv head, wk/wv whole) at (1,2): three steps, each
  from JAX's state before it, with loss, ``xent``, ``aux``, ``mtp`` and
  ``grad_norm`` within 1e-5, every gradient within the rule above (each
  block against its block of JAX's) and the parameters and moments by
  ``test_torch_lm_train_step.adam_rule``; every whole leaf equal bit for
  bit on every rank after each step (also at (1,4) where the ranks' own
  gradients of them differ,
  ``test_whole_leaves_take_model_rank_0s_gradients``); gemma3-4b's mesh
  steps equal to the port's one-device step on every rank's blocks;
- the eval step's metrics at (2,2) within 1e-5;
- the launcher on the (2,2) mesh: three losses and grad norms within
  1e-5 of JAX's jitted step in allreduce mode and in dense mode (whole
  experts), the heads, d_ff and vocabulary as blocks in both; its (1,2)
  checkpoint, gathered from every block kind, read by JAX's
  ``restore_checkpoint`` with every leaf whole and equal to the rank's
  gathered tree; a (1,2) run resumed from a one-device checkpoint, placed
  into the blocks."""
import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import init_params as jax_init_params
from repro.optim import adam_init as jax_adam_init
from repro_torch.checkpoint import keyed_leaves
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import mesh as core_mesh
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ModelCtx, make_train_step
from repro_torch.models.lm import xent_parts
from test_torch_lm_train import GRAD_RTOL
from test_torch_lm_train_step import adam_rule
from torch_mesh_ranks import LM_MODES, lm_mesh_train, npz_tree, xent_inputs

ARCH = "qwen2-moe-a2.7b"
OVER = dict(dtype="float32", n_experts=60, experts_per_token=4)
TRAIN_OVER = dict(OVER, d_ff_expert=16)
LAYER_CASES = tuple((shape, mode, 1.25) for shape in ((1, 2), (2, 2), (1, 4))
                    for mode in LM_MODES) + tuple(
    ((2, 2), mode, 64.0) for mode in LM_MODES)
AUX_CASE = ((2, 2), "allreduce", 64.0)
# (name, arch, overrides, shape, mode)
RUNS = (("qwen-1x2-allreduce", ARCH, TRAIN_OVER, (1, 2), "allreduce"),
        ("qwen-2x2-allreduce", ARCH, TRAIN_OVER, (2, 2), "allreduce"),
        ("qwen-2x2-alltoall", ARCH, TRAIN_OVER, (2, 2), "alltoall"),
        ("qwen-1x4-alltoall", ARCH, TRAIN_OVER, (1, 4), "alltoall"),
        ("deepseek-2x2-allreduce", "deepseek-v3-671b", dict(mtp_weight=0.3),
         (2, 2), "allreduce"),
        ("gemma3-2x2", "gemma3-4b", {}, (2, 2), "allreduce"),
        ("gemma3-1x4", "gemma3-4b", {}, (1, 4), "allreduce"),
        # one kv head: wk/wv whole, their gradient summed over ``model``
        ("granite-1x2", "granite-20b", {}, (1, 2), "allreduce"))
EVAL_RUN = "qwen-2x2-allreduce"
B, T, STEPS, LR, CLIP = 4, 16, 3, 1e-3, 1.0
LAUNCH = ["--arch", ARCH, "--reduced", "--batch", "4", "--seq", "16",
          "--device", "cpu"]
LAUNCH_STEPS = 3
# (B, T, CPU threads a rank) of chip_smoke.py's reduced (f) step and seeds
# at (1,4).  While a rank held the embedding whole its ranks computed its
# gradient a few 1e-9 apart on the CPU in alltoall mode; in JAX's layout
# the embedding is a block and every whole leaf's gradient is computed
# from the same all-reduced bytes, so the step's broadcast from model rank
# 0 guards bits that agree here
WHOLE_BITS = (4, 32, 2)
GRAD_ATOL = 1e-5
SPAWN_TIMEOUT_S = 600.0
# the vocabulary-parallel loss's unit case (B, T, V, d, seed, chunk): 3
# chunks of 4 tokens and a remainder of 1 left out, as JAX cuts T = 13
XENT = (2, 13, 24, 8, 41, 4)

_CHILD = textwrap.dedent("""
    import os, sys
    # two children share the cases: part 0 the layer and every other run,
    # part 1 the rest and the launcher; each file is renamed into place
    # whole, and a failure leaves a mark the ranks stop at
    out_dir, part = sys.argv[1], int(sys.argv[2])

    def failed(*exc):
        open(os.path.join(out_dir, "failed"), "w").close()
        sys.__excepthook__(*exc)
    sys.excepthook = failed
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses, numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.data import synthetic_batch, token_stream
    from repro.models import (ModelCtx, Sharder, init_params, make_eval_step,
                              make_train_step)
    from repro.models.ffn import init_moe, moe_sharded_apply
    from repro.models.lm import loss_fn
    from repro.optim import adam_init, adam_update, clip_by_global_norm
    from repro.sharding import activation_rules
    from repro.sharding.compat import auto_axis_types_kw

    arch, over, layer_cases, runs = %(arch)r, %(over)r, %(layer)r, %(runs)r
    b, t, steps, lr, clip = %(bt)r
    eval_run, launch_steps = %(eval_run)r, %(launch_steps)r

    def mesh_of(shape):
        devs = np.asarray(jax.devices()[:shape[0] * shape[1]])
        return jax.sharding.Mesh(devs.reshape(shape), ("data", "model"),
                                 **auto_axis_types_kw(2))

    def flat(out, prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

    def save(name, out):
        np.savez(os.path.join(out_dir, "tmp" + name), **out)
        os.replace(os.path.join(out_dir, "tmp" + name),
                   os.path.join(out_dir, name))

    def ctx_of(mesh, mode):
        shp = ShapeConfig("train", t, b, "train")
        return ModelCtx(mesh=mesh, moe_mode=mode,
                        sharder=Sharder(mesh, activation_rules(mesh, shp)))

    # the layer's vjp
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    out = {}
    moe = init_moe(jax.random.key(5), cfg, jnp.float32)
    flat(out, "moe", moe)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((b, t, cfg.d_model)), jnp.float32)
    dy = jnp.asarray(rng.standard_normal((b, t, cfg.d_model)), jnp.float32)
    daux = jnp.float32(rng.standard_normal())
    out["x"], out["dy"], out["daux"] = map(np.asarray, (x, dy, daux))
    for shape, mode, cf in layer_cases if part == 0 else ():
        mesh = mesh_of(shape)
        for name, cot in (("", (dy, daux)),
                          ("aux_only/", (jnp.zeros_like(dy),
                                         jnp.float32(1.0)))):
            if name and (shape, mode, cf) != %(aux_case)r:
                continue
            fn = jax.jit(lambda p, x: jax.vjp(
                lambda p, x: moe_sharded_apply(
                    p, x, cfg=cfg, mesh=mesh, mode=mode,
                    capacity_factor=cf), p, x)[1](cot))
            dp, dx = fn(moe, x)
            key = f"{name}{shape}/{mode}/{cf}"
            flat(out, key + "/dp", dp)
            out[key + "/dx"] = np.asarray(dx)
    if part == 0:
        save("layer.npz", out)

    # the train steps: JAX's make_train_step body, its clipped gradients
    # returned beside it
    for run, run_arch, run_over, shape, mode in runs[part::2]:
        cfg = dataclasses.replace(get_arch(run_arch).reduced(), **run_over)
        ctx = ctx_of(mesh_of(shape), mode)

        def step(params, opt, batch):
            (loss, metrics), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, cfg, batch, ctx)
            grads, gnorm = clip_by_global_norm(grads, clip)
            params, opt = adam_update(params, grads, opt, lr=lr)
            return params, opt, dict(metrics, grad_norm=gnorm,
                                     loss=loss), grads
        step = jax.jit(step)
        out = {}
        params = init_params(jax.random.key(3), cfg)
        opt = adam_init(params)
        flat(out, "s0/params", params)
        for i in range(steps):
            batch = synthetic_batch(cfg, t, b, "train", seed=10 + i)
            out.update({f"batch{i}/{k}": np.asarray(v)
                        for k, v in batch.items()})
            if run == eval_run and i == 0:
                out.update({f"eval/{k}": np.asarray(v) for k, v in
                            jax.jit(make_eval_step(cfg, ctx))(
                                params, batch).items()})
            params, opt, metrics, grads = step(params, opt, batch)
            out.update({f"m{i + 1}/{k}": np.asarray(v)
                        for k, v in metrics.items()})
            flat(out, f"g{i + 1}", grads)
            for name, tree in (("params", params), ("mu", opt.mu),
                               ("nu", opt.nu)):
                flat(out, f"s{i + 1}/{name}", tree)
        save(run + ".npz", out)

    # the launcher's loop on the (2,2) mesh, from init_params(key(0))
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    out = {}
    for mode in ("allreduce", "dense") if part == 1 else ():
        step = jax.jit(make_train_step(cfg, ctx_of(mesh_of((2, 2)), mode),
                                       lr=3e-4))
        params = init_params(jax.random.key(0), cfg)
        opt = adam_init(params)
        got = []
        for batch in token_stream(cfg, t, b, steps=launch_steps, seed=0):
            params, opt, m = step(params, opt, batch)
            got.append((float(m["loss"]), float(m["grad_norm"])))
        out[mode] = np.asarray(got)
    if part == 1:
        save("launch.npz", out)
""") % dict(arch=ARCH, over=OVER, layer=LAYER_CASES, aux_case=AUX_CASE,
            runs=RUNS, bt=(B, T, STEPS, LR, CLIP), eval_run=EVAL_RUN,
            launch_steps=LAUNCH_STEPS)


def _cfg(arch=ARCH, over=OVER):
    return dataclasses.replace(get_arch(arch).reduced(), **over)


def _launch_cfg():
    return dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")


def _jax_launch_params():
    jcfg = dataclasses.replace(JAX_ARCHS[ARCH].reduced(), dtype="float32")
    return jcfg, jax.tree.map(np.asarray,
                              jax_init_params(jax.random.key(0), jcfg))


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Two JAX children on 4 forced devices each, side by side (each case
    compiles its own program), writing one npz a case as it is done; and
    a one-device launcher checkpoint of 2 steps for the resume, made while
    they compile.  Yields (the directory, [(process, its log)])."""
    out = tmp_path_factory.mktemp("lm_mesh_train")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    logs = [out / f"child{part}.err" for part in (0, 1)]
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(out),
                               str(part)], env=env, stdout=subprocess.DEVNULL,
                              stderr=log.open("w"))
             for part, log in enumerate(logs)]
    train.main(LAUNCH + ["--steps", "2", "--ckpt-dir",
                         str(out / "one_device")],
               params=lm_params_from_numpy(_jax_launch_params()[1],
                                           _launch_cfg(), device="cpu"))
    yield out, list(zip(procs, logs))
    for proc in procs:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ranks(children):
    """Each rank's results: one spawn of 4 gloo CPU ranks, started while
    the children compile; each rank takes JAX's files as they land
    (``torch_mesh_ranks.lm_mesh_train``)."""
    out, procs = children
    jcfg, jparams = _jax_launch_params()
    plan = dict(layer=(ARCH, OVER, LAYER_CASES, AUX_CASE), runs=RUNS,
                steps=STEPS, lr=LR, clip=CLIP, eval_run=EVAL_RUN,
                launch=(LAUNCH, LAUNCH_STEPS, jparams),
                whole_bits=(ARCH, OVER) + WHOLE_BITS, xent=XENT)
    try:
        return core_mesh.spawn_mesh(lm_mesh_train, 1, 4, device="cpu",
                                    backend="gloo",
                                    timeout_s=SPAWN_TIMEOUT_S,
                                    args=(str(out), plan))
    except Exception as err:
        tails = "\n".join(log.read_text()[-2000:] for _, log in procs)
        raise AssertionError(f"the ranks failed; JAX's children:\n"
                             f"{tails}") from err


@pytest.fixture(scope="module")
def ref(children, ranks):
    """JAX's results, one npz a case, once both children are done."""
    out, procs = children
    for proc, log in procs:
        assert proc.wait(timeout=900) == 0, log.read_text()[-4000:]
    return out


def _load(ref, name):
    with np.load(ref / f"{name}.npz") as z:
        return dict(z)


def _grad_ok(got, want, what, block=None):
    """The gradient rule on ``want``, JAX's whole leaf (its max |g|), or
    on its ``block`` where ``got`` is a rank's block of it."""
    bound = GRAD_RTOL * np.abs(want) + GRAD_ATOL * np.abs(want).max()
    if block is not None:
        want, bound = _block_of(want, block), _block_of(bound, block)
    bad = np.abs(got - want) > bound
    assert not bad.any(), (what, float(np.abs(got - want).max()),
                           float(np.abs(want).max()))


def _block_of(want, block):
    """JAX's whole leaf cut to a rank's block: (dim, index, count)."""
    dim, index, count = block
    n = want.shape[dim] // count
    return np.take(want, range(index * n, (index + 1) * n), axis=dim)


@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}-{c[2]}")
def test_moe_layer_gradient_matches_jax_vjp(case, ref, ranks):
    shape, mode, cf = case
    want = _load(ref, "layer")
    key = f"{shape}/{mode}/{cf}"
    for i, r in enumerate(ranks):
        got = r["layer"][key]
        lo, hi = got["rows"]
        _grad_ok(got["dx"], want[key + "/dx"][lo:hi], (i, "dx"))
        for path, g in got["whole"].items():
            _grad_ok(g, want[key + "/dp" + path], (i, path))
        for path, (g, block) in got["blocks"].items():
            _grad_ok(g, want[key + "/dp" + path], (i, path), block)
        assert set(got["whole"]) | set(got["blocks"]) == {
            k[len(key) + 3:] for k in want if k.startswith(key + "/dp")}


def test_router_gradient_is_the_mean_over_devices_aux_gradients(ref, ranks):
    """At (2,2) allreduce with the output's cotangent 0 and the aux's 1,
    JAX's router gradient is the mean over the 4 devices of each device's
    own aux gradient (its data shard's, the same on both model ranks),
    not the gradient of the value it returns (data shard 0's aux) nor of
    the global batch's aux: the port's equals it."""
    from repro_torch.models.ffn import _route
    shape, mode, cf = AUX_CASE
    key = f"aux_only/{shape}/{mode}/{cf}"
    want = _load(ref, "layer")
    jax_g = want[key + "/dp['router']"]
    for r in ranks:
        _grad_ok(r["layer"][key]["whole"]["['router']"], jax_g, "port")
    cfg = _cfg()
    x = torch.from_numpy(want["x"])

    def aux_grad(rows):
        router = torch.from_numpy(want["moe['router']"]).requires_grad_(True)
        aux = _route(router, x[rows].reshape(-1, cfg.d_model),
                     cfg.experts_per_token)[2]
        return torch.autograd.grad(aux, router)[0].numpy()
    half = B // shape[0]
    shards = [aux_grad(slice(j * half, (j + 1) * half))
              for j in range(shape[0])]
    _grad_ok(np.mean(shards, axis=0), jax_g, "mean over devices")
    scale = np.abs(jax_g).max()
    for other in (shards[0], aux_grad(slice(0, B))):
        assert np.abs(other - jax_g).max() > 0.1 * scale


@pytest.mark.parametrize("run", RUNS, ids=lambda r: r[0])
def test_train_step_lockstep_on_the_mesh(run, ref, ranks):
    name, arch, over, shape, mode = run
    want = _load(ref, name)
    for i in range(STEPS):
        jm = {k.split("/", 1)[1]: float(v) for k, v in want.items()
              if k.startswith(f"m{i + 1}/")}
        for rk, r in enumerate(ranks):
            got = r["runs"][name][i]
            for k, v in jm.items():
                assert got["metrics"][k] == pytest.approx(v, rel=1e-5,
                                                          abs=1e-6), (
                    name, i, rk, k)
            if rk == 0:
                whole = got["whole"]
            else:
                assert got["digest"] == ranks[0]["runs"][name][i][
                    "digest"], (name, i, rk, "whole leaves differ")
            leaves = {path: (vals, None) for path, vals in whole.items()}
            leaves.update(got["blocks"])
            for path, (vals, block) in leaves.items():
                # the bars of JAX's whole leaf (its max |g|), then cut
                g = want[f"g{i + 1}{path}"]
                p, mu, nu = (want[f"s{i + 1}/{part}{path}"]
                             for part in ("params", "mu", "nu"))
                bars = adam_rule(p, g, mu, nu, i + 1, GRAD_ATOL)
                if block is not None:
                    g, p, mu, nu, *bars = (_block_of(a, block) for a in
                                           (g, p, mu, nu, *bars))
                dp, dm, dv, dg = bars
                gp, pp, mp, vp = vals
                assert (np.abs(gp - g) <= dg).all(), (name, i, rk, path,
                                                      "grad")
                assert (np.abs(mp - mu) <= dm).all(), (name, i, rk, path)
                assert (np.abs(vp - nu) <= dv).all(), (name, i, rk, path)
                assert (np.abs(pp - p) <= dp).all(), (name, i, rk, path)
    if arch == "gemma3-4b":
        _gemma_equals_one_device(ref, want, ranks, name)


def test_whole_leaves_take_model_rank_0s_gradients(ranks):
    """At (1,4) every rank computes the whole leaves' gradients itself
    (the norms and the router), by kernels whose bits can differ between
    processes; after the step's broadcast from model rank 0 the
    gradients, parameters and moments of the whole leaves are the same
    bytes on every rank, in both modes."""
    for mode in ("allreduce", "alltoall"):
        got = [r["whole_bits"][mode] for r in ranks]
        assert len(set(got)) == 1, (mode, got)


def _gemma_equals_one_device(ref, want, ranks, name):
    """The dense architecture's mesh step is the global one (no capacity
    depends on the mesh): the port's one-device step from JAX's state on
    the whole batch gives the mesh's loss and gradients, each rank's
    blocks those of the one-device gradient."""
    cfg = _cfg("gemma3-4b", {})
    tree = npz_tree(want, "s0/params", cfg)
    params = lm_params_from_numpy(tree, cfg, device="cpu")
    batch = {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in want.items()
             if k.startswith("batch0/")}
    from repro_torch.optim import adam_init
    step = make_train_step(cfg, ModelCtx(), lr=LR, clip_norm=CLIP)
    _, _, m = step(params, adam_init(params), batch, with_grads=True)
    for rk, r in enumerate(ranks):
        got = r["runs"][name][0]
        assert got["metrics"]["loss"] == pytest.approx(float(m["loss"]),
                                                       rel=1e-6)
        for path, g in keyed_leaves(m["grads"]):
            g = g.numpy()
            if path in got["blocks"]:
                vals, block = got["blocks"][path]
                _grad_ok(vals[0], g, ("one device", rk, path), block)
            elif rk == 0:
                _grad_ok(got["whole"][path][0], g, ("one device", path))


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_vocabulary_parallel_loss_matches_one_device(shape, ranks):
    """``xent_parts`` with the vocabulary split over ``model`` (a rank's
    rows of the head, its logsumexp combined over the axis, its gold
    logit where the label lies in its block), with a mask and a sequence
    remainder: each rank's sum and count, its gradient of ``h`` and of its
    rows of the head match the one-device function's, and no rank made a
    tensor with the whole vocabulary as its last dim (its chunks' logits
    are (B, cs, V/m))."""
    b, t, v, d, seed, chunk = XENT
    h, head, labels, mask = (torch.from_numpy(a) for a in
                             xent_inputs(b, t, v, d, seed))
    h.requires_grad_(True)
    head.requires_grad_(True)
    tot, cnt = xent_parts(h, head, labels, mask, chunk)
    dh, dhead = (g.numpy() for g in torch.autograd.grad(tot, (h, head)))
    m = shape[1]
    for rk, r in enumerate(ranks):
        got = r["xent"][shape]
        lo, hi = got["rows"]
        assert (lo, hi) == (rk % m * v // m, (rk % m + 1) * v // m)
        assert got["sum"] == pytest.approx(float(tot.detach()), rel=1e-6)
        assert got["count"] == float(cnt) < b * t
        _grad_ok(got["dh"], dh, (shape, rk, "h"))
        _grad_ok(got["dblock"], dhead[lo:hi], (shape, rk, "head"))
        assert (b, chunk, v // m) in got["shapes"]
        assert not [s for s in got["shapes"] if s and s[-1] == v], rk


def test_eval_step_on_the_mesh_matches_jax(ref, ranks):
    want = _load(ref, EVAL_RUN)
    jm = {k.split("/", 1)[1]: float(v) for k, v in want.items()
          if k.startswith("eval/")}
    assert set(jm) == {"xent", "aux"}
    for r in ranks:
        for k, v in jm.items():
            assert r["eval"][k] == pytest.approx(v, rel=1e-5), k


@pytest.mark.parametrize("mode", ["allreduce", "dense"])
def test_launcher_on_the_mesh_gives_jax_losses(mode, ref, ranks):
    want = _load(ref, "launch")[mode]
    for r in ranks:
        got = r["launch"][mode]
        np.testing.assert_allclose(got["losses"], want[:, 0], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], want[:, 1], rtol=1e-5)
        assert got["experts_held"] == (16 // 2 if mode == "allreduce"
                                       else 16)
    lines = ranks[0]["launch"][mode]["lines"]
    assert lines[0].endswith("params on 4 device(s)")
    assert sum(ln.startswith("step ") for ln in lines) == LAUNCH_STEPS
    assert all(not r["launch"][mode]["lines"] for r in ranks[1:])


def test_launcher_checkpoint_on_the_mesh_is_jax_format(ref, ranks):
    """The (1,2) run's checkpoint, written by its rank 0 after the expert
    blocks are gathered, read by JAX's restore_checkpoint: every leaf
    whole and equal to the ranks' gathered trees."""
    jcfg, jparams = _jax_launch_params()
    for copy in range(2):
        template = (jparams, jax_adam_init(jparams))
        (p, opt), step = jax_restore_checkpoint(ref / f"mesh_ckpt{copy}",
                                                template)
        assert step == 2 and int(opt.step) == 2
        got = _flat((p, opt))
        shapes = {k: v.shape for k, v in _flat(template).items()}
        assert {k: v.shape for k, v in got.items()} == shapes
        for r in ranks[2 * copy:2 * copy + 2]:
            gathered = r["ckpt"]["gathered"]
            assert set(gathered) == set(got)
            for k, v in gathered.items():
                assert np.array_equal(v, got[k]), k


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_launcher_on_the_mesh_resumes_from_a_one_device_checkpoint(
        ref, ranks, tmp_path):
    """A (1,2) run from the one-device launcher's checkpoint of step 2
    restores it whole and places its blocks: its step 2 equals the same
    run on a (1,1) mesh in this process (the same capacity: allreduce
    routes a data rank's tokens on every model rank)."""
    shutil.copytree(ref / "one_device", tmp_path / "ckpt")
    want = train.main(LAUNCH + ["--steps", "1", "--ckpt-dir",
                                str(tmp_path / "ckpt"), "--production-mesh",
                                "--moe-mode", "allreduce"],
                      mesh=make_host_mesh(1))
    for i, r in enumerate(ranks):
        got = r["resume"]
        # rank 0 of each (1,2) copy prints
        assert ("restored step 2" in got["lines"]) == (i % 2 == 0), i
        assert got["losses"][0] == pytest.approx(want["losses"][0],
                                                 rel=1e-5)
        assert got["experts_held"] == 8
