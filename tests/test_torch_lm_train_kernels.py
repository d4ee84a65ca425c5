"""The autograd Functions that give B6, B7 and B8 a gradient on CUDA
tensors (``kernels/wkv6.py::_Wkv6``, ``swa.py::_Swa``,
``moe_gemm.py::_GroupedGlu``), held on the CPU with each kernel module's
``_launch`` replaced by the kernel's plain version: the Function's
plumbing (saved inputs, the ``None`` cotangents, the non-tensor
arguments), not the kernel, which ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold on the card.

Bars: every input gradient equal to ``torch.autograd.grad`` of the plain
version exactly, and within 1e-5 of the largest |g| of ``jax.vjp`` of
JAX's composition (``models/rwkv.py::wkv6_chunked_jnp`` with and without
``s0``, ``models/attention.py::_sdpa_chunked`` at a window,
``models/ffn.py::_expert_ffn``, the einsums of ``moe_dense_apply``); B6
with a cotangent on ``out`` only, on the state only and on both."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _sdpa_chunked
from repro.models.ffn import _expert_ffn
from repro.models.rwkv import wkv6_chunked_jnp
from repro.models.shard import NO_SHARD

# the modules (``repro_torch.kernels.wkv6`` etc. are the wrappers' names)
wkv6, swa, moe_gemm = (importlib.import_module(f"repro_torch.kernels.{m}")
                       for m in ("wkv6", "swa", "moe_gemm"))


@pytest.fixture
def plain_launches(monkeypatch):
    """Each module's ``_launch`` computes the plain version."""
    monkeypatch.setattr(wkv6, "_launch", lambda r, k, v, w, u, s0, c:
                        wkv6.wkv6_chunked_plain(r, k, v, w, u, s0, chunk=c))
    monkeypatch.setattr(swa, "_launch", lambda q, k, v, window, scale:
                        swa.swa_attention_plain(q, k, v, window=window,
                                                scale=scale))
    monkeypatch.setattr(moe_gemm, "_launch", moe_gemm.grouped_glu_ffn_plain)


def leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def assert_vjp_close(got, want):
    """Within 1e-5 of the largest |g| of JAX's; an input the outputs do
    not reach has no gradient here and zeros there."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g is None:
            assert not w.any()
            continue
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def wkv6_inputs(rng, bh=3, t=32, n=8, with_s0=False):
    r, k = (0.5 * rng.standard_normal((bh, t, n)) for _ in range(2))
    v = rng.standard_normal((bh, t, n))
    w = np.exp(-np.exp(rng.uniform(-3, 1, (bh, t, n))))    # the model's range
    u = 0.3 * rng.standard_normal((bh, n))
    args = [r, k, v, w, u]
    if with_s0:
        args.append(0.5 * rng.standard_normal((bh, n, n)))
    return [a.astype(np.float32) for a in args]


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("wanted", ["out", "state", "both"])
def test_wkv6_function(plain_launches, with_s0, wanted):
    rng = np.random.default_rng(0)
    arrays = wkv6_inputs(rng, with_s0=with_s0)
    c_out = rng.standard_normal(arrays[2].shape).astype(np.float32)
    c_st = rng.standard_normal((3, 8, 8)).astype(np.float32)

    def loss(out, state):
        total = 0
        if wanted in ("out", "both"):
            total = total + (out * torch.from_numpy(c_out)).sum()
        if wanted in ("state", "both"):
            total = total + (state * torch.from_numpy(c_st)).sum()
        return total
    ins = leaves(*arrays)
    s0 = ins[5] if with_s0 else None
    got = torch.autograd.grad(loss(*wkv6._Wkv6.apply(*ins[:5], s0, 16)),
                              ins, allow_unused=True)
    ins2 = leaves(*arrays)
    want = torch.autograd.grad(loss(*wkv6.wkv6_chunked_plain(
        *ins2[:5], ins2[5] if with_s0 else None, chunk=16)), ins2,
        allow_unused=True)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    if wanted == "state":                  # r and u do not reach the state
        assert got[0] is None and got[4] is None

    def jf(*a):
        out, state = wkv6_chunked_jnp(*a[:5], s0=a[5] if with_s0 else None,
                                      chunk=16)
        return out, state
    (jo, js), vjp = jax.vjp(jf, *map(jnp.asarray, arrays))
    zo, zs = jnp.zeros_like(jo), jnp.zeros_like(js)
    cot = {"out": (jnp.asarray(c_out), zs), "state": (zo, jnp.asarray(c_st)),
           "both": (jnp.asarray(c_out), jnp.asarray(c_st))}[wanted]
    assert_vjp_close(got, vjp(cot))


def test_wkv6_function_takes_no_gradient_it_was_not_asked_for(
        plain_launches):
    """Gradients only for the inputs that need one; a bf16 input gets its
    gradient through the upcast outside the Function (the wrapper's)."""
    rng = np.random.default_rng(1)
    arrays = wkv6_inputs(rng)
    r, k, v, w, u = leaves(*arrays)
    w.requires_grad_(False)
    out, _ = wkv6._Wkv6.apply(r, k, v, w, u, None, 8)
    gr, gu = torch.autograd.grad(out.sum(), (r, u))
    assert gr.shape == r.shape and gu.shape == u.shape
    rb = r.detach().bfloat16().requires_grad_(True)
    out, _ = wkv6._Wkv6.apply(rb.float(), k, v, w, u, None, 8)
    (g,) = torch.autograd.grad(out.sum(), (rb,))
    assert g.dtype == torch.bfloat16


@pytest.mark.parametrize("t,window", [(40, 8), (24, 64)])
def test_swa_function(plain_launches, t, window):
    rng = np.random.default_rng(2)
    bh, d = 3, 12
    arrays = [rng.standard_normal((bh, t, d)).astype(np.float32)
              for _ in range(3)]
    ct = rng.standard_normal((bh, t, d)).astype(np.float32)
    scale = d ** -0.5
    ins = leaves(*arrays)
    got = torch.autograd.grad(swa._Swa.apply(*ins, window, scale),
                              ins, torch.from_numpy(ct))
    ins2 = leaves(*arrays)
    want = torch.autograd.grad(swa.swa_attention_plain(
        *ins2, window=window, scale=scale), ins2, torch.from_numpy(ct))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    pos = jnp.arange(t)

    def jf(q, k, v):
        return _sdpa_chunked(q[:, :, None, None], k[:, :, None],
                             v[:, :, None], pos, pos, "window", window,
                             scale, NO_SHARD, q_chunk=8)[:, :, 0, 0]
    _, vjp = jax.vjp(jf, *map(jnp.asarray, arrays))
    assert_vjp_close(got, vjp(jnp.asarray(ct)))


def test_grouped_glu_function(plain_launches):
    rng = np.random.default_rng(3)
    e, c, d, f = 4, 6, 16, 24
    arrays = [rng.standard_normal((e, c, d)),
              rng.standard_normal((e, d, f)) * d ** -0.5,
              rng.standard_normal((e, d, f)) * d ** -0.5,
              rng.standard_normal((e, f, d)) * f ** -0.5]
    arrays = [a.astype(np.float32) for a in arrays]
    ct = rng.standard_normal((e, c, d)).astype(np.float32)
    ins = leaves(*arrays)
    got = torch.autograd.grad(moe_gemm._GroupedGlu.apply(*ins), ins,
                              torch.from_numpy(ct))
    ins2 = leaves(*arrays)
    want = torch.autograd.grad(moe_gemm.grouped_glu_ffn_plain(*ins2), ins2,
                               torch.from_numpy(ct))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, vjp = jax.vjp(lambda x, wg, wu, wo: _expert_ffn(wg, wu, wo, x),
                     *map(jnp.asarray, arrays))
    assert_vjp_close(got, vjp(jnp.asarray(ct)))
    # moe_dense_apply's einsums over the broadcast tokens: the same vjp
    xf = jnp.asarray(arrays[0][0])

    def dense(xf, wg, wu, wo):
        g = jnp.einsum("td,edf->etf", xf, wg)
        u = jnp.einsum("td,edf->etf", xf, wu)
        return jnp.einsum("etf,efd->etd", jax.nn.silu(g) * u, wo)
    _, vjp = jax.vjp(dense, xf, *map(jnp.asarray, arrays[1:]))
    jgx, *jgw = vjp(jnp.asarray(ct))
    xb = torch.from_numpy(arrays[0][0]).requires_grad_(True)
    ws = leaves(*arrays[1:])
    gx, *gw = torch.autograd.grad(moe_gemm._GroupedGlu.apply(
        xb[None].expand(e, c, d), *ws), [xb, *ws], torch.from_numpy(ct))
    assert_vjp_close([gx, *gw], [jgx, *jgw])


def test_cpu_tensors_take_the_plain_version_without_the_function():
    """On CPU tensors the wrappers return the plain version's result, whose
    autograd graph is the composition's (no Function node)."""
    rng = np.random.default_rng(4)
    q, k, v = leaves(*(rng.standard_normal((2, 8, 4)).astype(np.float32)
                       for _ in range(3)))
    out = swa.swa_attention(q, k, v, window=4)
    assert "SwaBackward" not in type(out.grad_fn).__name__
    x, wg, wu, wo = leaves(rng.standard_normal((2, 3, 4)).astype(np.float32),
                           *(rng.standard_normal(s).astype(np.float32)
                             for s in ((2, 4, 5), (2, 4, 5), (2, 5, 4))))
    y = moe_gemm.grouped_glu_ffn(x, wg, wu, wo)
    assert "GroupedGlu" not in type(y.grad_fn).__name__
