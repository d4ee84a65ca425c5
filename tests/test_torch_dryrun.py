"""The port's dry-run (``repro_torch.launch.dryrun``,
``launch.dryrun_graph``): one rank's step counted on the meta device on a
shape-only mesh (``core.mesh.shape_mesh``).

Bars: the counts of a reduced arch's prefill, train and decode steps the
same on meta and on CPU tensors (the counting mode does not see the
device); a dry-run makes no tensor on a real device; ``argument_bytes``
``models.shard.tree_bytes`` of the rank's placed inputs and
``plan_argument_bytes`` ``plan_bytes`` of JAX's plan; qwen2-moe-a2.7b at
16×16 in allreduce and alltoall recording exactly the MoE layer's sums,
exchanges and gathers; ``lower_graph_policy``'s paper model bytes and
analytic FLOPs JAX's; ``main`` writing a record with JAX's keys; three
ratios of the rank's matmul FLOPs × data shards to ``analytic_flops``
pinned to the recorded ones (PERF.md §6); the shape-only mesh refusing a
real tensor and a real mesh's collectives unchanged, with the same
traffic as their shape-only twins."""
import json

import numpy as np
import pytest
import torch

import torch_mesh_ranks
from repro.core.analysis import collective_bytes_per_step as jax_cbps
from repro.roofline import analysis as jax_analysis
from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import mesh as mesh_lib
from repro_torch.data import synthetic_batch
from repro_torch.launch import dryrun, dryrun_graph
from repro_torch.launch.mesh import production_layout
from repro_torch.models import init_params, param_shapes
from repro_torch.models.ffn import _capacity, padded_experts
from repro_torch.models.shard import plan_bytes, tree_bytes
from repro_torch import optim
from repro_torch.optim import adam
from repro_torch.roofline.count import count
from repro_torch.sharding import batch_specs, param_specs

MODES = ("prefill", "train", "decode")
REDUCED = ("gemma3-4b", "rwkv6-7b", "qwen2-moe-a2.7b")
# the ratios PERF.md §6 records from CPU runs of python -m
# repro_torch.launch.dryrun: a dense, an MoE and a recurrent arch, their
# serving ranks on the tensor-parallel blocks (a rank computes 1/16 of the
# split heads, d_ff and vocabulary: gemma3-4b's 8 heads stay whole at 16)
RATIOS = {("gemma3-4b", "prefill_32k"): 0.358,
          ("qwen2-moe-a2.7b", "prefill_32k"): 0.0868,
          ("rwkv6-7b", "decode_32k"): 0.962}
# JAX's record keys (repro/launch/dryrun.py's ``rec``)
JAX_KEYS = {"arch", "shape", "mesh", "chips", "moe_mode", "zero3", "layout",
            "moment_dtype", "params_total", "params_active", "lower_s",
            "compile_s", "memory", "collectives", "roofline"}
JAX_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
              "generated_code_bytes"}


def _counts(rs):
    c = count(rs.step, *rs.args)[1]
    return c.flops, c.bytes, c.peak, c.ops


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", REDUCED)
def test_counts_are_the_same_on_meta_and_on_cpu(arch, mode, monkeypatch):
    cfg = get_arch(arch).reduced()
    shape = ShapeConfig("tiny", 16, 2, mode)
    mesh = mesh_lib.shape_mesh((1, 1), ("data", "model"))
    meta = dryrun.rank_step(cfg, shape, mesh)
    before = _counts(meta)
    # the CPU's Adam takes the f64 root for JAX's bits (optim.adam); meta
    # and CUDA take torch.sqrt, the one device branch of the step, which
    # both runs here take so that the count alone is compared
    for module in (optim, adam):
        monkeypatch.setattr(module, "sqrt_f32", torch.sqrt)
    assert _counts(meta) == before
    cpu = dryrun.rank_step(
        cfg, shape, mesh, params=init_params(cfg, seed=0, device="cpu"),
        batch=synthetic_batch(cfg, 16, 2, mode, seed=1, device="cpu"))
    got = _counts(cpu)
    assert got == before
    assert got[0] > 0 and got[1] > 0 and got[2] > 0


class _Devices(torch.utils._python_dispatch.TorchDispatchMode):
    """The device types of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.add(t.device.type)
        return out


def test_a_dry_run_makes_nothing_on_a_real_device():
    with _Devices() as lm:
        dryrun.lower_and_compile("qwen2-moe-a2.7b", "train_4k",
                                 seq_override=64)
    with _Devices() as graph:
        dryrun_graph.lower_graph_policy(4096)
    assert lm.seen == {"meta"} and graph.seen == {"meta"}


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_argument_bytes_are_the_placed_inputs(shape_name):
    """qwen2-moe-a2.7b at 16×16: the experts a block over ``model`` and,
    at both shapes, the tensor-parallel blocks too (the attention heads,
    the shared experts' d_ff and the vocabulary, all of which split 16
    ways there), every other leaf whole; the batch rows over ``data``."""
    cfg, shape = get_arch("qwen2-moe-a2.7b"), SHAPES[shape_name]
    mesh = dryrun.production_mesh()
    rs = dryrun.rank_step(cfg, shape, mesh, zero3=True)
    params = rs.args[0]
    full = tree_bytes(dryrun.meta_tree(param_shapes(cfg)))
    e_loc = padded_experts(cfg.n_experts) // 16
    assert params["segments"][0][0]["ffn"]["ewg"].shape[1] == e_loc
    blk = params["segments"][0][0]
    blocks = [blk["ffn"][k] for k in ("ewg", "ewu", "ewo")]
    assert params["embed"].shape[0] == cfg.vocab_size // 16
    assert blk["mixer"]["wq"].shape[2] == cfg.n_heads // 16
    assert blk["ffn"]["shared"]["wo"].shape[1] == 4 * 1408 // 16
    blocks += [params["embed"]] + list(blk["mixer"].values()) + list(
        blk["ffn"]["shared"].values())
    ex = sum(p.numel() * p.element_size() for p in blocks)
    assert tree_bytes(params) == full - 15 * ex
    rec = dryrun.count_rank_step(rs)
    assert rec["memory"]["argument_bytes"] == \
        tree_bytes(dryrun._leaves(rs.args))
    shapes = param_shapes(cfg)
    pspecs = param_specs(shapes, mesh, zero3=True)
    bshape = dryrun.input_specs("qwen2-moe-a2.7b", shape_name)
    plan = plan_bytes(shapes, pspecs, mesh) + plan_bytes(
        bshape, batch_specs(bshape, mesh, shape), mesh)
    if shape_name == "train_4k":
        opt = rs.args[1]
        assert rec["memory"]["argument_bytes"] == tree_bytes(
            [params, opt.step, opt.mu, opt.nu, list(rs.args[2].values())])
        assert {m.dtype for m in dryrun._leaves(opt.mu)} == {torch.float32}
        plan += 2 * plan_bytes(dryrun._dtype_tree(shapes, torch.float32),
                               pspecs, mesh) + 4
        assert rs.args[2]["tokens"].shape == (256 // 16, 4096)
    else:
        from repro_torch.models import cache_shapes
        from repro_torch.sharding import cache_specs
        cs = cache_shapes(cfg, 128, shape.seq_len)
        plan += plan_bytes(cs, cache_specs(cs, mesh, shape, 128), mesh)
        assert rs.args[2].shape == (128 // 16, 1)
        # the rank's cache holds its kv heads
        assert rs.args[1][0][0]["k"].shape == (24, 8, shape.seq_len, 1, 128)
    assert rs.plan_bytes == plan
    assert rs.data_shards == 16


def _moe_layers(cfg):
    return sum(1 for l in range(cfg.n_layers) if cfg.ffn_of_layer(l) ==
               "moe")


@pytest.mark.parametrize("mode", ["allreduce", "alltoall"])
def test_moe_collectives_are_the_layers_shape_arithmetic(mode):
    """qwen2-moe-a2.7b's prefill at 16×16 (T cut to 512), the serving
    blocks: the embedding's rows summed over ``model`` once, then each
    layer sums its attention's (B_loc, T, d) partial over ``model``; its
    MoE sums the routed and shared experts' partials in one all-reduce
    (allreduce) or exchanges its (m, E/m, C, d) capacity buffers twice,
    gathers its (B_loc, T/m, d) rows and sums the shared experts' partial
    (alltoall), and sums the aux over ``model`` and takes data shard 0's
    over ``data``; the head gathers the last token's f32 logits over the
    vocabulary once."""
    cfg, t = get_arch("qwen2-moe-a2.7b"), 512
    rec = dryrun.lower_and_compile("qwen2-moe-a2.7b", "prefill_32k",
                                   moe_mode=mode, seq_override=t)
    nl, b_loc, d, m = _moe_layers(cfg), 32 // 16, cfg.d_model, 16
    ep = padded_experts(cfg.n_experts)
    rows = b_loc * t * d * 2
    head = b_loc * cfg.vocab_size // m * 4
    want = {"all_reduce model": [1 + 3 * nl, rows + nl * (2 * rows + 4)],
            "all_reduce data": [nl, 4 * nl],
            "all_gather model": [1, head]}
    coll_ar = (rows + nl * (2 * rows + 4)) * 2 * 15 / 16 + \
        nl * 2 * 4 * 15 / 16
    if mode == "allreduce":
        assert rec["collectives"]["all-gather"] == head * 15
    else:
        cap = _capacity(b_loc * t // m, cfg, ep, 1.25)
        buf = ep * cap * d * 2
        gathered = nl * b_loc * (t // m) * d * 2
        want.update({"all_to_all model": [2 * nl, 2 * nl * buf],
                     "all_gather model": [nl + 1, gathered + head]})
        assert rec["collectives"]["all-to-all"] == \
            pytest.approx(2 * nl * buf * 15 / 16, rel=1e-12)
        assert rec["collectives"]["all-gather"] == (gathered + head) * 15
    assert rec["traffic"] == want
    assert rec["collectives"]["all-reduce"] == pytest.approx(coll_ar,
                                                             rel=1e-12)
    assert rec["collectives"]["count"] == sum(v[0] for v in want.values())


def test_graph_policy_record_keeps_jax_models():
    rec = dryrun_graph.lower_graph_policy(21_000)
    n, chips = 21_248, 256                  # JAX pads the rows to the chips
    assert (rec["nodes"], rec["chips"], rec["mesh"]) == (n, chips, "16x16")
    assert rec["paper_model_bytes"] == jax_cbps(1, n, 32, 2, chips)
    # JAX's Eq. 4 (repro/launch/dryrun_graph.py:60-63)
    rho, k, l = 0.15, 32, 2
    afl = 1 * (n * n * (k * (rho + l) + k * (2 + k + 4 * l) / n)
               + k * n * (6 + k))
    assert rec["roofline"]["model_flops"] == afl
    assert rec["roofline"]["analytic_flops_global"] == afl
    # the rank's tiles: one all-reduce of the (1, K, N) partial, one of the
    # (1, K) pooled sum, the all-gather of its (1, N/256) scores
    assert rec["traffic"] == {"all_reduce graph": [2, 4 * (32 * n + 32)],
                              "all_gather graph": [1, 4 * n // chips]}
    assert rec["memory"]["argument_bytes"] == 4 * (
        n // chips * n + 2 * n // chips + 4 * 32 * 32 + 4 * 32)


def test_graph_policy_multi_pod():
    rec = dryrun_graph.lower_graph_policy(131_072, multi_pod=True)
    assert (rec["chips"], rec["mesh"], rec["nodes"]) == (512, "2x16x16",
                                                        131_072)


def test_main_writes_a_record_with_jax_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    dryrun.main(["--arch", "gemma3-4b", "--shape", "decode_32k"])
    rec = json.loads((tmp_path / "gemma3-4b__decode_32k__sp.json")
                     .read_text())
    assert JAX_KEYS <= set(rec) and set(rec["memory"]) == JAX_MEMORY
    assert set(rec["collectives"]) == set(jax_analysis.collective_bytes(""))
    jax_terms = jax_analysis.roofline_terms({}, {"total": 0.0, "count": 0},
                                            1, 1.0)
    assert set(rec["roofline"]) == set(jax_terms)
    assert rec["counted_by"] == "torch meta, one rank"
    assert rec["memory"]["generated_code_bytes"] is None
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert "OK   gemma3-4b" in capsys.readouterr().out
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k"])
    assert "skipped" in json.loads(
        (tmp_path / "hubert-xlarge__decode_32k__sp.json").read_text())


def test_multi_pod_mesh_and_refused_layout():
    assert production_layout(True) == ((2, 16, 16), ("pod", "data", "model"))
    mesh = dryrun.production_mesh(multi_pod=True)
    assert mesh.size == 512 and mesh.shape_only
    with pytest.raises(ValueError, match="layout 'fsdp'"):
        dryrun.lower_and_compile("gemma3-4b", "decode_32k", layout="fsdp")


@pytest.mark.parametrize("case", sorted(RATIOS), ids="/".join)
def test_recorded_flops_ratios(case):
    rec = dryrun.lower_and_compile(*case)
    assert rec["flops_ratio"] == pytest.approx(RATIOS[case], rel=0.01)


# --------------------------------------------- the shape-only mesh ---------

def test_shape_mesh_lays_ranks_out_as_a_real_mesh():
    mesh = mesh_lib.shape_mesh((2, 16, 16), ("pod", "data", "model"),
                               rank=300)
    assert isinstance(mesh, mesh_lib.NamedMesh) and mesh.shape_only
    assert [mesh.axis(a).index for a in mesh.axis_names] == [1, 2, 12]
    assert mesh.axis("model").group is mesh_lib.SHAPE_ONLY
    single = mesh_lib.shape_mesh((1, 4), ("data", "graph"), rank=3)
    assert isinstance(single, mesh_lib.Mesh) and single.graph.index == 3
    assert single.data.group is None
    with pytest.raises(ValueError, match="no rank 4"):
        mesh_lib.shape_mesh((1, 4), ("data", "graph"), rank=4)


def test_a_real_tensor_on_a_shape_only_mesh_raises():
    lm = mesh_lib.shape_mesh((2, 2), ("data", "model"))
    graph = mesh_lib.shape_mesh((1, 2), ("data", "graph"))
    with pytest.raises(ValueError, match="shape-only mesh moves no data"):
        torch_mesh_ranks.mesh_collectives(
            lm, graph, lambda shape, v: torch.full(shape, float(v)))
    ax = lm.axis("model")
    calls = [lambda t: mesh_lib.all_reduce_sum(t, ax),
             lambda t: mesh_lib.all_reduce_max(t, ax),
             lambda t: mesh_lib.all_gather_tiled(t, ax, 0),
             lambda t: mesh_lib.all_to_all(t, ax),
             lambda t: mesh_lib.all_reduce_grads([t], [ax]),
             lambda t: mesh_lib.broadcast_first([t], ax),
             lambda t: mesh_lib.all_reduce_world(graph, t)]
    for call in calls:
        with pytest.raises(ValueError, match="meta tensors"):
            call(torch.zeros(2, 3))
        call(torch.zeros(2, 3, device="meta"))
    # a mesh of one rank communicates nothing: real tensors pass
    one = mesh_lib.shape_mesh((1, 1), ("data", "model"))
    t = torch.ones(3)
    assert mesh_lib.all_reduce_sum(t, one.axis("model")) is t


@pytest.fixture(scope="module")
def real_ranks():
    return mesh_lib.spawn_mesh(torch_mesh_ranks.real_mesh_collectives, 1, 2,
                               device="cpu", backend="gloo", timeout_s=120.0)


def test_real_mesh_collectives_are_unchanged(real_ranks):
    for r, (out, _, _) in enumerate(real_ranks):
        np.testing.assert_array_equal(out["sum"], np.full(3, 3.0))
        np.testing.assert_array_equal(out["max"], np.full(2, 2.0))
        np.testing.assert_array_equal(out["gather"], np.repeat(
            np.repeat([[0.0, 1.0]], 3, axis=1), 2, axis=0))
        np.testing.assert_array_equal(out["a2a"], np.full((2, 4), 0.0) +
                                      np.array([[0.0], [1.0]]))
        np.testing.assert_array_equal(out["grads"], np.full(5, 3.0))
        np.testing.assert_array_equal(out["bcast"], np.full(4, 3.0))
        np.testing.assert_array_equal(out["reduce"], np.full(3, 6.0))
        np.testing.assert_array_equal(out["copy_grad"], np.full(3, 4.0))
        np.testing.assert_array_equal(out["world"], np.full(2, 3.0))


def test_shape_only_twins_record_the_real_traffic(real_ranks):
    for r, (out, lm_traffic, graph_traffic) in enumerate(real_ranks):
        lm = mesh_lib.shape_mesh((1, 2), ("data", "model"), rank=r)
        graph = mesh_lib.shape_mesh((1, 2), ("data", "graph"), rank=r)
        twin, lt, gt = torch_mesh_ranks.mesh_collectives(
            lm, graph, lambda shape, v: torch.empty(shape, device="meta"))
        assert (lt, gt) == (lm_traffic, graph_traffic)
        assert {k: tuple(v.shape) for k, v in twin.items()} == \
            {k: v.shape for k, v in out.items()}
        assert {v.device.type for v in twin.values()} == {"meta"}
