"""The port's fused S2V layer (repro_torch.kernels.s2v_fused) against the
JAX package's Pallas kernel (interpret mode) and its ``ref.s2v_layer``
oracle, on the CPU, and the dense kernel's tile-width choice.  The CUDA
kernel itself is tested on the card by tests/test_torch_cuda.py."""
import importlib.util
import inspect
import pathlib
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import build
from repro_torch.kernels import s2v_fused as ks

# f32: the two frameworks sum in different orders; bf16: one bf16 rounding
# (2^-8 relative) of each matmul operand, as tests/test_fused_kernel.py.
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JAX_CD = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _case(b=2, k=16, n=40, rho=0.3, seed=7):
    rng = np.random.default_rng(seed)
    rand = lambda s: (rng.random(s, np.float32) - 0.5).astype(np.float32)  # noqa: E731
    embed = rand((b, k, n))
    adj = (rng.random((b, n, n)) < rho).astype(np.float32)
    base = rand((b, k, n))
    t4 = rand((k, k)) * 0.2
    return t4, embed, adj, base


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("tile", [8, 16, 128])
@pytest.mark.parametrize("k,n", [(8, 37), (32, 40)])
def test_plain_matches_pallas_kernel_and_oracle(compute, tile, k, n):
    """Ragged N (not a multiple of the tile) at K=8 and K=32."""
    t4, embed, adj, base = _case(k=k, n=n)
    got = ks.fused_s2v_layer_plain(*_torch(t4, embed, adj, base),
                                   compute).numpy()
    pallas = np.asarray(ops.fused_s2v_layer(
        t4, embed, adj, base, tile_n=tile, tile_l=tile,
        compute_dtype=JAX_CD[compute], interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL[compute])
    oracle = np.asarray(ref.s2v_layer(t4, embed, adj, base))
    np.testing.assert_allclose(got, oracle, **TOL[compute])


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_isolated_rows_give_relu_base_exactly(compute):
    t4, embed, adj, base = _case(n=24)
    adj[:, :, 16:] = 0.0
    adj[:, 16:, :] = 0.0
    out = ks.fused_s2v_layer_plain(*_torch(t4, embed, adj, base),
                                   compute).numpy()
    np.testing.assert_array_equal(out[:, :, 16:],
                                  np.maximum(base[:, :, 16:], 0.0))


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    args = _torch(*_case(k=16, n=21))
    before = ks.fused_s2v_layer.launches
    for compute in ("f32", "bf16"):
        torch.testing.assert_close(ks.fused_s2v_layer(*args, compute),
                                   ks.fused_s2v_layer_plain(*args, compute),
                                   rtol=0, atol=0)
    assert ks.fused_s2v_layer.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    t4, embed, adj, base = _torch(*_case(k=16, n=12))
    with pytest.raises(ValueError, match="shape"):
        ks.fused_s2v_layer(t4, embed, adj[:, :, :10].contiguous(), base)
    with pytest.raises(TypeError, match="float32"):
        ks.fused_s2v_layer(t4, embed.double(), adj, base)
    with pytest.raises(ValueError, match="contiguous"):
        ks.fused_s2v_layer(t4.t(), embed, adj, base)
    with pytest.raises(ValueError, match="compute"):
        ks.fused_s2v_layer(t4, embed, adj, base, "fp8")
    big = _torch(*_case(k=40, n=12))
    with pytest.raises(ValueError, match="K <= 32"):
        ks.fused_s2v_layer(*big)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


def test_build_dir_is_keyed_by_the_sources():
    d = build.build_dir()
    assert d.parent == build.BUILD_ROOT and len(d.name) == 16
    assert d == build.build_dir()
    assert (build.CSRC / "s2v_fused.cu").exists()


# ------------------------------------------------- dense tile width ------

ROOT = pathlib.Path(__file__).resolve().parents[1]
H100_SMS = 132


def _smoke_shapes():
    """(name, B, N) of every dense layer (B1) and dense aggregate (B2)
    shape chip_smoke.py runs."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return ([(f"B1-{c[0]}", c[1], c[3]) for c in smoke.DENSE_CASES]
            + [(f"B2-{c[0]}", c[1], c[4]) for c in smoke.AGG_CASES])


SMOKE_SHAPES = _smoke_shapes()


@pytest.mark.parametrize("name,b,n", SMOKE_SHAPES,
                         ids=[s[0] for s in SMOKE_SHAPES])
def test_dense_tile_columns_spread_the_blocks_over_the_sms(name, b, n):
    """The busiest SM runs at most 1.1x the mean block count, unless even
    the widest tile gives one block per SM or fewer."""
    tn = ks.dense_tile_columns(b, n, H100_SMS)
    blocks = b * -(-n // tn)
    busiest = -(-blocks // H100_SMS)
    widest = max(ks.TILE_COLUMNS)
    assert (busiest <= 1.1 * blocks / H100_SMS
            or b * -(-n // widest) <= H100_SMS)


def test_dense_tile_columns_are_the_kernel_templates_widths():
    src = (build.CSRC / "s2v_fused.cu").read_text()
    widths = {int(w) for w in re.findall(r"case (\d+):", src)}
    assert set(ks.TILE_COLUMNS) == widths
    for sms in (1, 7, 114, 132):
        for b in (1, 2, 3, 8, 1000):
            for n in (1, 31, 32, 33, 100, 4096, 20480, 100001):
                assert ks.dense_tile_columns(b, n, sms) in widths


def test_dense_tile_columns_do_not_depend_on_k():
    """The width is a function of the grid alone; ties go to the widest
    (embed is re-read from L2 once per tile)."""
    assert list(inspect.signature(ks.dense_tile_columns).parameters) == [
        "b", "n", "sms"]
    assert ks.dense_tile_columns(8, 4096, H100_SMS) == 128   # all tie
    assert ks.dense_tile_columns(1, 20480, H100_SMS) == 32
