"""The port's roofline tools (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``).

Bars: tests/test_roofline.py's cases on the port's functions, with JAX's
TPU ``HW`` passed in where the case reads the rates; ``collective_bytes``
and its helpers ``==`` JAX's on that HLO and on variants (async pairs,
nested ``calls=``, a ``while`` in a ``while``, groups given as a list);
``traffic_bytes`` on each kind of the port's collectives, recorded by a
shape-only mesh; ``analytic_flops``, ``analytic_hbm_bytes``,
``cache_bytes`` and ``model_flops`` ``==`` JAX's for every arch × supported
shape; ``active_param_count`` ``==`` JAX's on ``jax.eval_shape`` of its
``init_params`` for every arch; ``report.table`` JAX's string from the
same records; ``roofline.count``'s FLOPs, bytes and peak on small
programs."""
import dataclasses

import jax
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.models import init_params as jax_init_params
from repro.roofline import analysis as jax_analysis
from repro.roofline import analytic as jax_analytic
from repro.roofline import report as jax_report
from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_supported
from repro_torch.core import mesh as mesh_lib
from repro_torch.models import param_shapes
from repro_torch.roofline import HW, HW_F32, Hardware, report
from repro_torch.roofline.analysis import (_group_size, _line_bytes,
                                           _shape_bytes, _split_computations,
                                           active_param_count,
                                           collective_bytes, model_flops,
                                           roofline_terms, traffic_bytes)
from repro_torch.roofline.analytic import (analytic_flops,
                                           analytic_hbm_bytes, cache_bytes)
from repro_torch.roofline.count import CountMode, count

JAX_HW = jax_analysis.HW          # the TPU's rates, only from JAX's package
ALL = sorted(JAX_ARCHS)
CASES = [(a, s) for a in ALL for s in sorted(SHAPES)
         if shape_supported(get_arch(a), SHAPES[s])[0]]

HLO = """
HloModule jit_f

%body (p: (s32[], f32[8,32])) -> (s32[], f32[8,32]) {
  %p = parameter(0)
  %ar = f32[8,32]{1,0} all-reduce(%x), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%sum
}

%cond (p: (s32[], f32[8,32])) -> pred[] {
  %c = s32[] constant(7)
  ROOT %lt = pred[] compare(%i, %c), direction=LT
}

ENTRY %main.1 (a: f32[8,32]) -> f32[8,32] {
  %ag = f32[64,32]{1,0} all-gather(%a), replica_groups=[1,8]<=[8], dimensions={0}
  %w = (s32[], f32[8,32]) while(%t), condition=%cond, body=%body
  ROOT %r = f32[8,32]{1,0} get-tuple-element(%w), index=1
}
"""

# async pairs (only -start counts), a reduce-scatter, an all-to-all and a
# permute, a computation reached by calls=, a while inside a while
HLO_VARIANTS = """
HloModule jit_g

%inner_body (p: (s32[], bf16[4,16])) -> (s32[], bf16[4,16]) {
  %rs = bf16[4,16]{1,0} reduce-scatter(%y), replica_groups=[2,4]<=[8], dimensions={0}, to_apply=%sum
  %cp = bf16[4,16]{1,0} collective-permute(%y), source_target_pairs={{0,1},{1,0}}, replica_groups={{0,1}}
}

%inner_cond (p: (s32[], bf16[4,16])) -> pred[] {
  %c = s32[] constant(3)
  ROOT %lt = pred[] compare(%i, %c), direction=LT
}

%outer_body (p: (s32[], bf16[4,16])) -> (s32[], bf16[4,16]) {
  %a2a = bf16[8,16]{1,0} all-to-all(%z), replica_groups={{0,1,2,3}}, dimensions={0}
  %iw = (s32[], bf16[4,16]) while(%t), condition=%inner_cond, body=%inner_body
}

%outer_cond (p: (s32[], bf16[4,16])) -> pred[] {
  %c = s32[] constant(5)
  ROOT %lt = pred[] compare(%i, %c), direction=LT
}

%helper (x: f32[16]) -> f32[16] {
  %ar2 = f32[16]{0} all-reduce(%x), replica_groups=[4,2]<=[8], to_apply=%sum
}

ENTRY %main.7 (a: f32[16]) -> f32[16] {
  %ags = (f32[16], f32[128]) all-gather-start(%a), replica_groups=[1,8]<=[8], dimensions={0}
  %agd = f32[128]{0} all-gather-done(%ags)
  %ars = f32[16]{0} all-reduce-start(%a), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%sum
  %ard = f32[16]{0} all-reduce-done(%ars)
  %f = f32[16]{0} fusion(%a), kind=kLoop, calls=%helper
  %one = f32[16]{0} all-reduce(%a), replica_groups={{0}}, to_apply=%sum
  %w = (s32[], bf16[4,16]) while(%t), condition=%outer_cond, body=%outer_body
  ROOT %r = f32[16]{0} get-tuple-element(%w), index=1
}
"""


# --------------------------------------------- tests/test_roofline.py ------

def test_shape_bytes():
    assert _shape_bytes("f32[8,32]{1,0}") == 8 * 32 * 4
    assert _shape_bytes("(f32[4], bf16[2,2])") == 16 + 8
    assert _shape_bytes("pred[]") == 1


def test_split_computations():
    comps = _split_computations(HLO)
    assert set(comps) == {"body", "cond", "main.1"}


def test_collective_bytes_with_loop_multiplication():
    out = collective_bytes(HLO)
    # all-gather: result 64*32*4 = 8192 B, g=8 → 8192*7/8 = 7168
    # all-reduce in while body ×7 trips: 2*1024*7/8*7 = 12544
    assert out["all-gather"] == pytest.approx(7168)
    assert out["all-reduce"] == pytest.approx(12544)
    assert out["count"] == 8
    assert out["total"] == pytest.approx(7168 + 12544)


def test_roofline_terms_dominant():
    cost = {"flops": 197e12 * 0.5, "bytes accessed": 819e9 * 0.1}
    coll = {"total": 50e9 * 2.0, "count": 3}
    t = roofline_terms(cost, coll, chips=256, model_fl=1e15, hw=JAX_HW)
    assert t["dominant"] == "collective_s"
    assert t["compute_s"] == pytest.approx(0.5)
    assert t["memory_s"] == pytest.approx(0.1)
    assert t["collective_s"] == pytest.approx(2.0)
    assert t["step_time_bound_s"] == pytest.approx(2.0)


def test_roofline_terms_analytic_floor():
    """Analytic FLOPs override an undercount (scan bodies, matmuls only)."""
    cost = {"flops": 1.0, "bytes accessed": 1.0}
    coll = {"total": 0.0, "count": 0}
    t = roofline_terms(cost, coll, chips=2, model_fl=1.0,
                       analytic_fl=197e12 * 4, hw=JAX_HW)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["hlo_flops_per_dev"] == 1.0


def test_model_flops_modes():
    cfg = get_arch("granite-20b")
    n = 20e9
    tr = model_flops(cfg, SHAPES["train_4k"], n)
    pf = model_flops(cfg, SHAPES["prefill_32k"], n)
    dc = model_flops(cfg, SHAPES["decode_32k"], n)
    assert tr == pytest.approx(6 * n * 256 * 4096)
    assert pf == pytest.approx(2 * n * 32 * 32768)
    assert dc == pytest.approx(2 * n * 128)


def test_analytic_flops_scales_with_train_multiplier():
    cfg = get_arch("granite-20b")
    f_remat = analytic_flops(cfg, SHAPES["train_4k"], remat=True)
    f_norm = analytic_flops(cfg, SHAPES["train_4k"], remat=False)
    assert f_remat / f_norm == pytest.approx(4 / 3)


def test_cache_bytes_swa_windowed():
    g = get_arch("gemma3-4b")
    full = cache_bytes(g, SHAPES["long_500k"])
    g_glob = dataclasses.replace(g, pattern=("attn",), sliding_window=0)
    assert cache_bytes(g_glob, SHAPES["long_500k"]) > 3 * full


def test_analytic_flops_positive_all_archs():
    for name, cfg in ARCHS.items():
        for s in SHAPES.values():
            if shape_supported(cfg, s)[0]:
                assert analytic_flops(cfg, s) > 0, (name, s.name)


# --------------------------------------------- equal to JAX's --------------

def test_the_hardware_is_the_h100_data_sheet():
    """The port's rates are the H100 SXM data sheet's, none of JAX's."""
    assert (HW.peak_flops, HW.hbm_bw, HW.link_bw) == (989.4e12, 3.35e12,
                                                      450e9)
    assert HW_F32 == Hardware(peak_flops=66.9e12)
    assert HW.peak_flops != JAX_HW.peak_flops


@pytest.mark.parametrize("hlo", [HLO, HLO_VARIANTS], ids=["test", "variants"])
def test_hlo_text_functions_equal_jax(hlo):
    assert collective_bytes(hlo) == jax_analysis.collective_bytes(hlo)
    assert _split_computations(hlo) == jax_analysis._split_computations(hlo)
    for line in hlo.splitlines():
        assert _line_bytes(line) == jax_analysis._line_bytes(line), line
        assert _group_size(line) == jax_analysis._group_size(line), line
        assert _shape_bytes(line) == jax_analysis._shape_bytes(line), line


def test_hlo_variants_count_what_they_should():
    """Async pairs once, a group of one not at all, nested loops by the
    product of their trips, a ``calls=`` computation once."""
    out = collective_bytes(HLO_VARIANTS)
    ag = 128 * 4 * 7 / 8 + 16 * 4 * 7 / 8    # the -start's tuple shape
    assert out["all-gather"] == ag
    assert out["all-reduce"] == 2 * 64 * 7 / 8 + 2 * 64 * 1 / 2
    assert out["all-to-all"] == 5 * 256 * 3 / 4
    assert out["reduce-scatter"] == 5 * 3 * 128 * 3
    assert out["collective-permute"] == 5 * 3 * 128
    assert out["count"] == 1 + 1 + 1 + 5 * (1 + 3 * 2)


@pytest.mark.parametrize("arch,shape", CASES)
def test_analytic_models_equal_jax(arch, shape):
    cfg, jcfg = get_arch(arch), JAX_ARCHS[arch]
    s, js = SHAPES[shape], JAX_SHAPES[shape]
    for remat in (True, False):
        assert analytic_flops(cfg, s, remat=remat) == \
            jax_analytic.analytic_flops(jcfg, js, remat=remat)
        assert analytic_hbm_bytes(cfg, s, 123_456_789, 45_678_901,
                                  remat=remat) == \
            jax_analytic.analytic_hbm_bytes(jcfg, js, 123_456_789,
                                            45_678_901, remat=remat)
    assert cache_bytes(cfg, s) == jax_analytic.cache_bytes(jcfg, js)
    assert model_flops(cfg, s, 987_654_321) == \
        jax_analysis.model_flops(jcfg, js, 987_654_321)


@pytest.mark.parametrize("arch", ALL)
def test_active_param_count_equals_jax(arch):
    jcfg = JAX_ARCHS[arch]
    shapes = jax.eval_shape(lambda k: jax_init_params(k, jcfg),
                            jax.random.key(0))
    want = jax_analysis.active_param_count(jcfg, shapes)
    assert active_param_count(get_arch(arch), param_shapes(get_arch(arch))) \
        == want


def test_roofline_terms_equal_jax():
    cost = {"flops": 3.5e14, "bytes accessed": 2.25e11}
    coll = {"total": 7.5e9, "count": 11.0}
    for kw in ({}, {"analytic_fl": 1e17, "analytic_bytes": 1e14}):
        assert roofline_terms(cost, coll, 256, 4e16, hw=JAX_HW, **kw) == \
            jax_analysis.roofline_terms(cost, coll, 256, 4e16, **kw)


# --------------------------------------------- traffic_bytes ---------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _one(traffic, key, mesh):
    """traffic_bytes of the record's ``key`` alone."""
    return traffic_bytes({key: traffic[key]}, mesh)


def test_traffic_bytes_all_reduce_kinds():
    """all_reduce, all_reduce_max and grad_all_reduce (and the backward's
    all_reduce) are all-reduces of S = s: 2·s·(g-1)/g."""
    mesh = mesh_lib.shape_mesh((2, 4), ("data", "model"))
    mesh_lib.all_reduce_sum(_meta(8), mesh.axis("model"))
    mesh_lib.all_reduce_max(_meta(3, dtype=torch.bfloat16),
                            mesh.axis("data"))
    mesh_lib.all_reduce_grads([_meta(5), _meta(2, 2)], [mesh.axis("data")])
    x = _meta(6).requires_grad_()
    with torch.enable_grad():
        y = mesh_lib.copy_to_axis(x, mesh.axis("model"))
        torch.autograd.grad(y.sum(), x)
    t = mesh.traffic
    assert t == {"all_reduce model": [1, 32],
                 "all_reduce_max data": [1, 6],
                 "grad_all_reduce data": [2, 36],
                 "all_reduce model backward": [1, 24]}
    assert _one(t, "all_reduce model", mesh)["all-reduce"] == 2 * 32 * 3 / 4
    assert _one(t, "all_reduce_max data", mesh)["all-reduce"] == 2 * 6 / 2
    got = _one(t, "grad_all_reduce data", mesh)
    assert (got["all-reduce"], got["count"]) == (2 * 36 / 2, 2)
    assert _one(t, "all_reduce model backward", mesh)["all-reduce"] == \
        2 * 24 * 3 / 4
    assert traffic_bytes(t, mesh)["total"] == 48 + 6 + 36 + 36


def test_traffic_bytes_all_gather():
    """The mesh records the operand s; JAX's S is the gathered s·g, so an
    all-gather moves s·(g-1)."""
    mesh = mesh_lib.shape_mesh((2, 4), ("data", "model"))
    out = mesh_lib.all_gather_tiled(_meta(3, 5), mesh.axis("model"), 1)
    assert tuple(out.shape) == (3, 20) and out.device.type == "meta"
    assert mesh.traffic == {"all_gather model": [1, 60]}
    got = traffic_bytes(mesh.traffic, mesh)
    assert got["all-gather"] == 60 * 3 and got["total"] == 180


def test_traffic_bytes_all_to_all_and_its_backward():
    mesh = mesh_lib.shape_mesh((4,), ("model",))
    x = _meta(4, 2, 3).requires_grad_()
    with torch.enable_grad():
        y = mesh_lib.all_to_all(x, mesh.axis("model"))
        torch.autograd.grad(y.sum(), x)
    assert tuple(y.shape) == (4, 2, 3)
    assert mesh.traffic == {"all_to_all model": [1, 96],
                            "all_to_all model backward": [1, 96]}
    got = traffic_bytes(mesh.traffic, mesh)
    assert got["all-to-all"] == 2 * 96 * 3 / 4 and got["count"] == 2


def test_traffic_bytes_broadcasts():
    """grad_broadcast and the plan channel's broadcast: each device takes
    s (counted as collective-permute bytes)."""
    mesh = mesh_lib.shape_mesh((2, 4), ("data", "model"))
    mesh_lib.broadcast_first([_meta(7), _meta(1)], mesh.axis("model"))
    assert mesh.traffic == {"grad_broadcast model": [2, 32]}
    got = traffic_bytes(dict(mesh.traffic, **{"broadcast world": [3, 40]}),
                        mesh)
    assert got["collective-permute"] == 32 + 40 and got["count"] == 5


def test_traffic_bytes_on_the_graph_mesh():
    """The graph mesh's axes and its world all-reduce (g = dp·sp); an axis
    of size 1 moves nothing."""
    mesh = mesh_lib.shape_mesh((2, 3), ("data", "graph"))
    assert isinstance(mesh, mesh_lib.Mesh) and mesh.size == 6
    mesh_lib.all_reduce_world(mesh, _meta(10))
    mesh_lib.all_reduce_sum(_meta(4), mesh.graph)
    got = traffic_bytes(mesh.traffic, mesh)
    assert got["all-reduce"] == 2 * 40 * 5 / 6 + 2 * 16 * 2 / 3
    assert traffic_bytes({"all_reduce graph": [1, 16]},
                         mesh_lib.shape_mesh((2, 1), ("data", "graph"))
                         )["total"] == 0


# --------------------------------------------- report.table ----------------

def _record(arch, shape, scale):
    kinds = {k: scale * i * 1e9 for i, k in enumerate(
        ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute"))}
    terms = roofline_terms({"flops": scale * 1e15, "bytes accessed": 1e12},
                           dict(kinds, total=sum(kinds.values()), count=3),
                           256, 2e17)
    return {"arch": arch, "shape": shape, "roofline": terms,
            "collectives": kinds,
            "memory": {"argument_bytes": scale * 2 ** 33,
                       "temp_bytes": 2 ** 31}}


def test_report_table_is_jax_table():
    recs = {("gemma3-4b", "train_4k"): _record("gemma3-4b", "train_4k", 1.5),
            ("rwkv6-7b", "decode_32k"): _record("rwkv6-7b", "decode_32k", 0.3),
            ("hubert-xlarge", "decode_32k"): {
                "arch": "hubert-xlarge", "shape": "decode_32k",
                "skipped": "encoder-only architecture has no decode step"},
            ("llama3-405b", "train_4k"): {"arch": "llama3-405b",
                                          "shape": "train_4k",
                                          "error": "RuntimeError()"}}
    got = report.table(recs)
    assert got == jax_report.table(recs)
    assert got.count("\n") == 6


def test_report_load_reads_the_ports_records(tmp_path, monkeypatch):
    import json
    monkeypatch.setattr(report, "DRY", tmp_path)
    rec = _record("gemma3-4b", "train_4k", 1.0)
    (tmp_path / "gemma3-4b__train_4k__sp.json").write_text(json.dumps(rec))
    (tmp_path / "gemma3-4b__train_4k__mp.json").write_text("{}")
    assert report.load("sp") == {("gemma3-4b", "train_4k"): rec}


# --------------------------------------------- roofline.count --------------

@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_count_matmul_flops_bytes_and_peak(device):
    a = torch.zeros(3, 4, 5, device=device)
    b = torch.zeros(3, 5, 6, device=device)

    def step(a, b):
        c = torch.bmm(a, b)                 # 2·3·4·5·6 FLOPs, new (3,4,6)
        d = c.view(3, 24)                   # a view: nothing moves
        e = d * 2.0                         # reads d, writes e
        del c, d
        e.add_(1.0)                         # written once
        f = torch.empty(100, device=a.device)   # writes nothing
        return e, f
    (e, f), c = count(step, a, b)
    assert c.flops == 2 * 3 * 4 * 5 * 6
    assert c.bytes == (240 + 360 + 288) + (288 + 288) + 288 + 0
    # c and e live together, then f joins e after c dies
    assert c.peak == 288 + 288 + 400 - 288
    assert c.ops == 5
    assert c.top[0][0] == 400 and c.top[0][1] == "aten.empty"


def test_count_reads_a_broadcast_storage_once():
    x = torch.empty(1, 8, device="meta")
    _, c = count(lambda x: x.expand(1000, 8).contiguous(), x)
    assert c.bytes == 32 + 1000 * 8 * 4


def test_count_sees_the_backward():
    """A backward's matmuls are counted (2 forward, 4 backward of the
    same size) and its saved tensors kept alive until it runs."""
    w = torch.empty(16, 32, device="meta", requires_grad=True)
    x = torch.empty(8, 16, device="meta")

    def step(x, w):
        y = x @ w
        (g,) = torch.autograd.grad(y.sum(), w)
        return g
    with CountMode() as mode:
        step(x, w)
    # forward mm, then the backward's mm for dw (x is not a leaf needing
    # a gradient, so dx is not formed)
    assert mode.counts.flops == 2 * (2 * 8 * 16 * 32)
