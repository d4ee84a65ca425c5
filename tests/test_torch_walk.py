"""The route of the sparse and CSR layers and of the CSR aggregate on the
card (the row walk or the windowed walk), chosen from the shapes alone by
``repro_torch.kernels.walk.walk_route``; the wrappers' ``walk=`` keyword
on CPU tensors; and ``chip_smoke.py``'s argument parsing and its reading
of an allocator trace (its top level imports only the standard library
and numpy, so it imports here)."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import s2v_csr as kc
from repro_torch.kernels import s2v_fused as ks
from repro_torch.kernels.walk import (WINDOW_RATIO, aligned, padded_node_major,
                                      walk_route, window_bytes)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (case, B, K, N, Nl, list slots, expected route): the serving bucket's
# sparse (D = 768) and CSR (E = 2.5M) batches, the paper-scale graph's
# (D = 3274, E = 62.9M directed edges) and its sparse mesh row blocks at
# sp = 2 and 4, BA(1M, d=10) on CSR (20.0M edges), and tiny graphs
ROUTES = [
    ("serving_sparse", 8, 32, 4096, 4096, 8 * 4096 * 768, "windows"),
    ("serving_csr", 8, 32, 4096, 4096, 8 * 2_500_000, "windows"),
    ("paper_sparse", 1, 32, 20480, 20480, 20480 * 3274, "windows"),
    ("paper_csr", 1, 32, 20480, 20480, 62_914_560, "windows"),
    ("paper_rows_sp2", 1, 32, 20480, 10240, 10240 * 3274, "windows"),
    ("paper_rows_sp4", 1, 32, 20480, 5120, 5120 * 3274, "windows"),
    ("ba1m_csr", 1, 32, 1_000_000, 1_000_000, 19_999_900, "rows"),
    ("tiny_dense_lists", 2, 16, 40, 40, 2 * 40 * 12, "windows"),
    ("tiny_sparse_lists", 1, 32, 1000, 1000, 1000 * 2, "rows"),
]


@pytest.mark.parametrize("case,b,k,n,nl,slots,want", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_walk_route_at_the_main_path_shapes(case, b, k, n, nl, slots, want):
    assert walk_route(b, k, n, nl, slots) == want


# (case, B, K, N, E, expected route) of B5's aggregate entry in the CSR
# backward: a minibatch of 64 subgraphs sampled from BA(1M, d=10) by 512
# seeds and fanouts (8, 4) (node budget 20,992, edge budget 40,960), the
# training cell (64 ER(4096, 0.15) states of ~2.52M slots) and the
# paper-scale step (64 copies of ER(20480, 0.15), 62.9M slots)
AGGREGATE_ROUTES = [
    ("sampled_minibatch", 64, 32, 20_992, 40_960, "rows"),
    ("train_minibatch", 64, 32, 4096, 2_520_000, "windows"),
    ("paper_minibatch", 64, 32, 20480, 62_914_560, "windows"),
]


@pytest.mark.parametrize("case,b,k,n,e,want", AGGREGATE_ROUTES,
                         ids=[r[0] for r in AGGREGATE_ROUTES])
def test_aggregate_route_at_the_train_shapes(case, b, k, n, e, want):
    """csr_aggregate routes as the layer does: walk_route(B, K, N, N,
    B·E).  At the sampled minibatch the windows would stream 28.2 GB
    against 21 MB of slots."""
    assert walk_route(b, k, n, n, b * e) == want
    if case == "sampled_minibatch":
        assert window_bytes(b, k, n, n) == 64 * 164 * 20_992 * 128


def test_window_bytes_count_every_block_reading_its_graph():
    # the serving bucket: 256 blocks of 128 nodes, each 4096 x 32 floats
    assert window_bytes(8, 32, 4096, 4096) == 256 * 4096 * 32 * 4
    # K = 7 pads to KP = 8; a row block of 129 nodes takes two blocks
    assert window_bytes(1, 7, 1000, 129) == 2 * 1000 * 8 * 4
    # BA(1M): 7813 blocks of the whole 1M-node x, about 1.0 TB
    assert window_bytes(1, 32, 1_000_000, 1_000_000) == 7813 * 128_000_000


@pytest.mark.parametrize("slack", [-1, 0, 1])
def test_walk_route_turns_at_the_ratio(slack):
    """Windows up to WINDOW_RATIO times the lists' bytes, rows above."""
    b, k, n, nl = 2, 32, 512, 256
    slots = int(window_bytes(b, k, n, nl) / (8 * WINDOW_RATIO)) + slack
    want = "rows" if slack < 0 else "windows"
    assert walk_route(b, k, n, nl, slots) == want


def _sparse_args(seed=0, b=2, k=5, n=9, d=6):
    rng = np.random.default_rng(seed)
    nbr = np.sort(rng.integers(0, n + 1, (b, n, d)), -1).astype(np.int32)
    edge = np.where(nbr < n, rng.random((b, n, d)), 0).astype(np.float32)
    t = [torch.from_numpy(a) for a in (
        (rng.random((k, k)) - 0.5).astype(np.float32) * 0.2,
        rng.random((b, k, n)).astype(np.float32), nbr, edge,
        (rng.random((b, k, n)) - 0.5).astype(np.float32))]
    return t


def _csr_args(seed=0, b=2, k=5, n=9):
    from repro_torch.core import csr_batch_from_dense
    rng = np.random.default_rng(seed)
    adj = (rng.random((b, n, n)) < 0.4).astype(np.float32)
    adj = np.maximum(adj, adj.transpose(0, 2, 1))
    np.einsum("bii->bi", adj)[:] = 0
    cs = csr_batch_from_dense(adj, device="cpu")
    edge_w = cs.edge_mask.float() * torch.from_numpy(
        rng.random(cs.edge_mask.shape).astype(np.float32))
    return [torch.from_numpy((rng.random((k, k)) - 0.5).astype(np.float32)),
            torch.from_numpy(rng.random((b, k, n)).astype(np.float32)),
            cs.indices, cs.indptr, edge_w,
            torch.from_numpy((rng.random((b, k, n)) - 0.5).astype(
                np.float32))]


def _csr_aggregate_args(seed=0):
    """The CSR aggregate's inputs: x, indices, indptr, edge_w."""
    return _csr_args(seed)[1:5]


def _csr_aggregate_plain(x, indices, indptr, edge_w, compute):
    from repro_torch.core.graphs import csr_row_ids
    return kc.csr_aggregate_plain(x, indices,
                                  csr_row_ids(indptr, indices.shape[1]),
                                  edge_w, compute)


# the wrappers that take ``walk=``: the sparse and CSR layers and B5's
# aggregate entry
ROUTED = [("sparse", ks.fused_s2v_layer_sparse,
           ks.fused_s2v_layer_sparse_plain, _sparse_args),
          ("csr", kc.fused_s2v_layer_csr, kc.fused_s2v_layer_csr_plain,
           _csr_args),
          ("csr_aggregate", kc.csr_aggregate, _csr_aggregate_plain,
           _csr_aggregate_args)]


@pytest.mark.parametrize("name,fn,plain,make", ROUTED,
                         ids=[r[0] for r in ROUTED])
@pytest.mark.parametrize("walk", [None, "rows", "windows"])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_cpu_tensors_take_the_plain_version_whatever_the_walk(
        name, fn, plain, make, walk, compute):
    """On CPU tensors the wrapper is its plain version for every walk,
    and counts no launch and no route."""
    args = make()
    launches, routes = fn.launches, dict(fn.routes)
    assert torch.equal(fn(*args, compute, walk=walk), plain(*args, compute))
    assert fn.launches == launches and fn.routes == routes


@pytest.mark.parametrize("name,fn,plain,make", ROUTED,
                         ids=[r[0] for r in ROUTED])
@pytest.mark.parametrize("walk", ["diagonal", "Rows", "", 1])
def test_unknown_walks_are_refused_on_any_device(name, fn, plain, make, walk):
    with pytest.raises(ValueError, match="unknown walk"):
        fn(*make(), "f32", walk=walk)


@pytest.mark.parametrize("name,fn,plain,make", ROUTED,
                         ids=[r[0] for r in ROUTED])
def test_walk_is_keyword_only(name, fn, plain, make):
    with pytest.raises(TypeError):
        fn(*make(), "f32", "rows")


def test_windowed_walk_inputs_are_whole_vectors_on_16_bytes():
    x = torch.rand(2, 7, 11)
    xt = padded_node_major(x)
    assert xt.shape == (2, 11, 8) and xt.is_contiguous()
    assert torch.equal(xt[:, :, :7], x.transpose(1, 2))
    assert not xt[:, :, 7:].any()
    t = torch.arange(20, dtype=torch.int32)
    assert aligned(t) is t
    view = t[1:]
    assert view.data_ptr() % 16 != 0
    copy = aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)


def test_chip_smoke_only_takes_every_kernel_of_the_kernels_line():
    cs = _chip_smoke()
    names = list(cs.REPLACES)
    # the eight kernels and B5's aggregate entry
    assert len(names) == 9 and "csr_aggregate" in names
    for name in names:
        assert cs.parse_args(["--only", name]) == [name]
    assert cs.parse_args(["--only", ",".join(reversed(names))]) == names
    assert cs.parse_args([]) is None
    assert cs.parse_args(["--only", "fused_s2v_layer,mp_aggregate"]) == [
        "fused_s2v_layer", "mp_aggregate"]
    assert cs.parse_args(["--only", "sparse_mp_aggregate,grouped_glu_ffn"]) \
        == ["sparse_mp_aggregate", "grouped_glu_ffn"]


@pytest.mark.parametrize("argv", [
    ["--only", "fused_s2v_layer,ssm_scan"], ["--only", "B3"],
    ["--only", ""], ["--only", ","], ["--only", "mp_aggregate,"],
    ["--only"], ["--dense-kernels"], ["--kernel-loop"],
    ["--only", "mp_aggregate", "--kernel-loop"], ["mp_aggregate"]])
def test_chip_smoke_refuses_other_arguments_as_a_usage_error(argv, capsys):
    cs = _chip_smoke()
    with pytest.raises(ValueError):
        cs.parse_args(argv)
    assert cs.main(argv) == 2
    assert "usage: python3 chip_smoke.py [--only" in capsys.readouterr().err


def _frame(path, line, name):
    return {"filename": path, "line": line, "name": name}


def test_chip_smoke_finds_the_peak_of_an_allocator_trace():
    """``trace_peak`` replays alloc / free_requested from the bytes
    allocated before the trace, names the allocation that reached the
    peak and the sites of the blocks alive there, innermost
    ``repro_torch`` frames first; blocks from before the trace count
    apart, and a free that only completes changes nothing."""
    cs = _chip_smoke()
    rows = [_frame("/x/src/repro_torch/core/graphs.py", 10, "csr_row_ids"),
            _frame("/x/src/repro_torch/core/graphrep.py", 5,
                   "state_from_tuples"),
            _frame("/x/chip_smoke.py", 1, "run")]
    embed = [_frame("/t/torch/nn/functional.py", 3, "pad"),
             _frame("/x/src/repro_torch/core/s2v_csr.py", 20, "embed")]
    trace = [{"action": "alloc", "addr": 1, "size": 50, "frames": rows},
             {"action": "alloc", "addr": 2, "size": 30, "frames": embed},
             {"action": "free_requested", "addr": 1, "size": 50},
             {"action": "free_completed", "addr": 1, "size": 50},
             {"action": "alloc", "addr": 3, "size": 60, "frames": []},
             {"action": "free_requested", "addr": 9, "size": 40},
             {"action": "alloc", "addr": 4, "size": 20, "frames": rows}]
    assert cs.alloc_site(rows) == ("core/graphs.py:10 csr_row_ids < "
                                   "core/graphrep.py:5 state_from_tuples")
    assert cs.alloc_site(rows, depth=1) == "core/graphs.py:10 csr_row_ids"
    got = cs.trace_peak(trace, 100)
    assert got == {"allocated_before": 100, "peak_bytes": 190,
                   "reached_by": "outside repro_torch",
                   "alive_from_before": 100, "alive_at_peak": [
                       {"site": "outside repro_torch", "bytes": 60,
                        "blocks": 1},
                       {"site": "core/s2v_csr.py:20 embed", "bytes": 30,
                        "blocks": 1}]}
    assert cs.trace_peak(trace[:1], 100)["reached_by"] == cs.alloc_site(rows)
    assert cs.trace_peak([], 7)["peak_bytes"] == 7
