"""The port's LM kernel entry points (``repro_torch.kernels.ops.wkv6``,
``swa`` and ``grouped_glu_ffn``) on CPU tensors, where each runs its plain
PyTorch version, against the JAX package on the same numpy inputs: the
Pallas kernels in interpret mode (through ``repro.kernels.ops``, as
tests/test_kernels.py runs them), the ``ref.py`` oracles, and the model
functions with the same math (``models/rwkv.py::wkv6_chunked_jnp``,
``models/ffn.py::_expert_ffn``).  The CUDA kernels themselves are tested
on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances are the JAX suite's (tests/test_kernels.py): 3e-4 for chunked
wkv6 against the scan, 1e-4 for swa and the grouped GLU.  bf16 inputs are
upcast exactly by both packages, so they are held at the same bars.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models.ffn import _expert_ffn
from repro.models.rwkv import wkv6_chunked_jnp
import repro_torch.kernels as pt_kernels
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gemm import grouped_glu_ffn_plain, tf32_split
from repro_torch.kernels.swa import swa_attention_plain
from repro_torch.kernels.wkv6 import wkv6_chunked_plain

WKV_TOL = dict(rtol=3e-4, atol=3e-4)
TOL = dict(rtol=1e-4, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _bf16(*arrays):
    """bf16-rounded copies: JAX bf16 arrays, and the same values as torch
    bf16 tensors."""
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    pt = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in jx]
    return jx, pt


def _wkv_inputs(bh, t, dk, dv, seed, w_lo=0.7, w_span=0.29):
    rng = _rng(seed)
    r = (rng.standard_normal((bh, t, dk)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((bh, t, dk)) * 0.5).astype(np.float32)
    v = rng.standard_normal((bh, t, dv)).astype(np.float32)
    w = (w_lo + w_span * rng.random((bh, t, dk))).astype(np.float32)
    u = (rng.standard_normal((bh, dk)) * 0.3).astype(np.float32)
    return r, k, v, w, u


def _qkv(bh, t, d, seed):
    rng = _rng(seed)
    return [rng.standard_normal((bh, t, d)).astype(np.float32)
            for _ in range(3)]


def _glu_inputs(e, c, d, f, seed):
    rng = _rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    wg, wu = ((rng.standard_normal((e, d, f)) * 0.1).astype(np.float32)
              for _ in range(2))
    wo = (rng.standard_normal((e, f, d)) * 0.1).astype(np.float32)
    return x, wg, wu, wo


# ---------------------------------------------------------------- wkv6 -----

@pytest.mark.parametrize("bh,t,dk,dv,chunk", [
    (1, 64, 8, 8, 16), (3, 128, 16, 24, 32), (2, 256, 32, 32, 64),
    (1, 64, 16, 16, 64),   # single chunk
])
def test_wkv6_matches_scan_oracle(bh, t, dk, dv, chunk):
    args = _wkv_inputs(bh, t, dk, dv, seed=bh * t + dk)
    o, s = ops.wkv6(*_t(*args), chunk=chunk)
    oref, sref = ref.wkv6(*args)
    np.testing.assert_allclose(o.numpy(), np.asarray(oref), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sref), **WKV_TOL)


@pytest.mark.parametrize("bh,t,dk,dv,chunk", [
    (3, 128, 16, 24, 32), (1, 64, 64, 64, 64)])
def test_wkv6_matches_pallas_kernel(bh, t, dk, dv, chunk):
    """Same formula, so the chunked forms agree far inside the scan bar."""
    args = _wkv_inputs(bh, t, dk, dv, seed=5)
    o, s = ops.wkv6(*_t(*args), chunk=chunk)
    jo, js = jops.wkv6(*args, chunk=chunk, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv6_matches_model_chunked_jnp_over_the_model_decay_range(chunk):
    """models/rwkv.py draws w in [exp(-e), 1) = [0.066, 1); the serve
    launcher uses chunk 16."""
    args = _wkv_inputs(2, 128, 16, 16, seed=chunk, w_lo=np.exp(-np.e),
                       w_span=1 - np.exp(-np.e))
    o, s = ops.wkv6(*_t(*args), chunk=chunk)
    jo, js = wkv6_chunked_jnp(*args, chunk=chunk)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    oref, sref = ref.wkv6(*args)
    np.testing.assert_allclose(o.numpy(), np.asarray(oref), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sref), **WKV_TOL)


@pytest.mark.parametrize("bh,t,dk,dv,chunk", [(2, 64, 16, 16, 16),
                                               (3, 128, 24, 24, 32)])
def test_wkv6_from_a_state_matches_the_model_and_the_scan(bh, t, dk, dv,
                                                          chunk):
    """``s0``: the state entering the first chunk, as the model's
    ``wkv6_chunked_jnp(s0=...)`` and ``ref.wkv6(s0=...)`` take it, over
    the model's decay range."""
    args = _wkv_inputs(bh, t, dk, dv, seed=40 + chunk, w_lo=np.exp(-np.e),
                       w_span=1 - np.exp(-np.e))
    s0 = (_rng(41).standard_normal((bh, dk, dv)) * 0.5).astype(np.float32)
    o, s = ops.wkv6(*_t(*args), s0=torch.from_numpy(s0), chunk=chunk)
    po, ps = wkv6_chunked_plain(*_t(*args), s0=torch.from_numpy(s0),
                                chunk=chunk)
    assert torch.equal(o, po) and torch.equal(s, ps)
    for jo, js in (wkv6_chunked_jnp(*args, s0=jnp.asarray(s0), chunk=chunk),
                   ref.wkv6(*args, s0=jnp.asarray(s0))):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **WKV_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **WKV_TOL)
    # two calls chained through the state are the whole call
    h = t // 2
    o1, s1 = ops.wkv6(*(a[:, :h].contiguous() if a.dim() == 3 and
                        a.shape[1] == t else a for a in _t(*args)),
                      s0=torch.from_numpy(s0), chunk=chunk)
    o2, s2 = ops.wkv6(*(a[:, h:].contiguous() if a.dim() == 3 and
                        a.shape[1] == t else a for a in _t(*args)),
                      s0=s1, chunk=chunk)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), o.numpy(),
                               **WKV_TOL)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), **WKV_TOL)
    # a zero state is no state, bit for bit
    z, zs = ops.wkv6(*_t(*args), s0=torch.zeros((bh, dk, dv)), chunk=chunk)
    n, ns = ops.wkv6(*_t(*args), chunk=chunk)
    assert torch.equal(z, n) and torch.equal(zs, ns)
    with pytest.raises(ValueError, match="s0 has shape"):
        ops.wkv6(*_t(*args), s0=torch.zeros((bh, dk, dv + 1)), chunk=chunk)


def test_wkv6_bf16_inputs_are_upcast_exactly():
    args = _wkv_inputs(2, 64, 16, 16, seed=3, w_lo=0.8, w_span=0.19)
    jx, pt = _bf16(*args)
    o, s = ops.wkv6(*pt, chunk=32)
    oref, sref = ref.wkv6(*jx)
    np.testing.assert_allclose(o.numpy(), np.asarray(oref), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sref), **WKV_TOL)
    o32, s32 = ops.wkv6(*(a.float() for a in pt), chunk=32)
    assert torch.equal(o, o32) and torch.equal(s, s32)


def test_wkv6_chunk_longer_than_t_is_one_chunk():
    args = _t(*_wkv_inputs(1, 32, 8, 8, seed=9))
    o, s = ops.wkv6(*args, chunk=64)
    o1, s1 = wkv6_chunked_plain(*args, chunk=32)
    assert torch.equal(o, o1) and torch.equal(s, s1)


def test_wkv6_refuses_what_the_kernel_does_not_take():
    r, k, v, w, u = _t(*_wkv_inputs(2, 48, 8, 8, seed=1))
    with pytest.raises(ValueError, match="divisible"):
        ops.wkv6(r, k, v, w, u, chunk=32)
    with pytest.raises(ValueError, match="shape"):
        ops.wkv6(r, k[:, :, :4].contiguous(), v, w, u, chunk=16)
    with pytest.raises(ValueError, match="shape"):
        ops.wkv6(r, k, v, w, u[:1], chunk=16)
    with pytest.raises(ValueError, match="is on"):
        ops.wkv6(r, k, v.to("meta"), w, u, chunk=16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.wkv6(r.double(), k, v, w, u, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv6(r, k, v.transpose(0, 1), w, u, chunk=16)
    with pytest.raises(ValueError, match="chunk must be positive"):
        ops.wkv6(r, k, v, w, u, chunk=0)


@pytest.mark.parametrize("bh,t,dk,dv,chunk", [
    (1, 64, 80, 16, 16),     # dk above the CUDA kernel's 64
    (1, 256, 8, 8, 128),     # chunk above the CUDA kernel's 64
])
def test_wkv6_takes_sizes_beyond_the_kernel_limits_on_the_cpu(bh, t, dk, dv,
                                                              chunk):
    """On CPU tensors the op takes every size the JAX op takes (the limits
    are the CUDA kernel's, tests/test_torch_cuda.py); decays w >= 0.7, so
    at chunk 128 the exponents stay near 128·|log 0.7| = 46, under f32
    exp's 88."""
    args = _wkv_inputs(bh, t, dk, dv, seed=dk + chunk)
    o, s = ops.wkv6(*_t(*args), chunk=chunk)
    jo, js = jops.wkv6(*args, chunk=chunk, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    oref, sref = ref.wkv6(*args)
    np.testing.assert_allclose(o.numpy(), np.asarray(oref), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sref), **WKV_TOL)


# ---------------------------------------------------------------- swa ------

@pytest.mark.parametrize("bh,t,d,window", [
    (2, 256, 32, 64), (1, 128, 16, 32),
    (2, 256, 32, 200),     # window not tile-aligned
    (1, 512, 64, 128),
    (1, 256, 32, 1024),    # window > T: causal attention
    (2, 700, 32, 200),     # T not a multiple of the plain version's block
])
def test_swa_matches_ref(bh, t, d, window):
    q, k, v = _qkv(bh, t, d, seed=t + window)
    got = ops.swa(*_t(q, k, v), window=window)
    want = ref.swa(q, k, v, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bh,t,d,window,tile", [
    (2, 256, 32, 200, 64), (1, 128, 16, 32, 32)])
def test_swa_matches_pallas_kernel(bh, t, d, window, tile):
    q, k, v = _qkv(bh, t, d, seed=11)
    got = ops.swa(*_t(q, k, v), window=window)
    want = jops.swa(q, k, v, window=window, tile_q=tile, tile_k=tile,
                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_swa_window_covering_all_is_causal_attention():
    q, k, v = _t(*_qkv(1, 128, 16, seed=2))
    got = ops.swa(q, k, v, window=128)
    mask = torch.ones(128, 128, dtype=torch.bool).tril()
    want = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, ops.swa(q, k, v, window=10 ** 6))


def test_swa_scale_and_bf16_inputs():
    q, k, v = _qkv(1, 128, 32, seed=4)
    jx, pt = _bf16(q, k, v)
    got = ops.swa(*pt, window=64)
    want = ref.swa(*jx, window=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = ops.swa(*_t(q, k, v), window=64, scale=0.3)
    want = ref.swa(q, k, v, window=64, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_swa_refuses_what_the_kernel_does_not_take():
    q, k, v = _t(*_qkv(2, 64, 16, seed=1))
    with pytest.raises(ValueError, match="shape"):
        ops.swa(q, k[:, :32].contiguous(), v, window=8)
    with pytest.raises(ValueError, match="is on"):
        ops.swa(q, k.to("meta"), v, window=8)
    with pytest.raises(ValueError, match="window"):
        ops.swa(q, k, v, window=0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.swa(q.half(), k, v, window=8)


@pytest.mark.parametrize("d", [6, 260])   # d % 4 != 0; d above 256
def test_swa_takes_sizes_beyond_the_kernel_limits_on_the_cpu(d):
    """On CPU tensors the op takes every head size the JAX op takes (the
    limits are the CUDA kernel's, tests/test_torch_cuda.py)."""
    q, k, v = _qkv(1, 128, d, seed=d)
    got = ops.swa(*_t(q, k, v), window=48)
    want = jops.swa(q, k, v, window=48, tile_q=64, tile_k=64,
                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref.swa(q, k, v, window=48)), **TOL)


# ------------------------------------------------------- grouped GLU -------

@pytest.mark.parametrize("e,c,d,f", [
    (4, 32, 48, 64), (2, 128, 128, 256), (3, 100, 72, 90), (1, 16, 16, 16)])
def test_grouped_glu_ffn_matches_ref(e, c, d, f):
    args = _glu_inputs(e, c, d, f, seed=e * c + f)
    got = ops.grouped_glu_ffn(*_t(*args))
    want = ref.grouped_glu_ffn(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grouped_glu_ffn_matches_pallas_kernel_on_ragged_tiles():
    """(3, 100, 72, 90) with 32-wide tiles: the TPU kernel pads C, d and f;
    the port masks them."""
    args = _glu_inputs(3, 100, 72, 90, seed=8)
    got = ops.grouped_glu_ffn(*_t(*args))
    want = jops.grouped_glu_ffn(*args, tile_c=32, tile_d=32, tile_f=32,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grouped_glu_ffn_matches_model_expert_ffn():
    x, wg, wu, wo = _glu_inputs(3, 24, 40, 56, seed=6)
    got = ops.grouped_glu_ffn(*_t(x, wg, wu, wo))
    want = _expert_ffn(jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wo),
                       jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grouped_glu_ffn_bf16_inputs_are_upcast_exactly():
    args = _glu_inputs(2, 32, 32, 64, seed=7)
    jx, pt = _bf16(*args)
    got = ops.grouped_glu_ffn(*pt)
    want = ref.grouped_glu_ffn(*jx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.dtype == torch.float32


def test_grouped_glu_ffn_refuses_what_the_kernel_does_not_take():
    x, wg, wu, wo = _t(*_glu_inputs(2, 8, 16, 24, seed=1))
    with pytest.raises(ValueError, match="shape"):
        ops.grouped_glu_ffn(x, wg, wu, wo[:, :20].contiguous())
    with pytest.raises(ValueError, match="shape"):
        ops.grouped_glu_ffn(x, wg, wu[:1].contiguous(), wo)
    with pytest.raises(ValueError, match="is on"):
        ops.grouped_glu_ffn(x, wg.to("meta"), wu, wo)
    with pytest.raises(ValueError, match="contiguous"):
        ops.grouped_glu_ffn(x.transpose(1, 2), wg, wu, wo)


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_tf32_split_rounds_to_ten_mantissa_bits_and_sums_back():
    """hi and lo keep 10 mantissa bits (the low 13 bits clear), hi + lo
    is within 2^-22 of the value, relative, over normal values of both
    signs and many scales; zero splits into zeros with its sign; a tie
    rounds away from zero, as cvt.rna.tf32.f32 does."""
    rng = _rng(11)
    t = torch.from_numpy((rng.standard_normal(200_000)
                          * 10.0 ** rng.integers(-30, 30, 200_000))
                         .astype(np.float32))
    hi, lo = tf32_split(t)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    err = (hi.double() + lo.double() - t.double()).abs()
    assert bool((err <= 2.0 ** -22 * t.double().abs()).all())
    assert bool((hi.sign() == t.sign()).all())
    zeros = torch.tensor([0.0, -0.0])
    hz, lz = tf32_split(zeros)
    assert torch.equal(_bits(hz), _bits(zeros)) and not lz.any()
    tie = torch.tensor([0x3F801000, 0x3F803000], dtype=torch.int32).view(
        torch.float32)                  # 1 + 2^-11 and 1 + 3 * 2^-11
    want = torch.tensor([0x3F802000, 0x3F804000], dtype=torch.int32)
    assert torch.equal(_bits(tf32_split(tie)[0]), want)
    assert torch.equal(_bits(tf32_split(-tie)[0]),
                       want | torch.tensor(-2 ** 31, dtype=torch.int32))


def _toward_zero(s):
    """f64 → f32, rounded toward zero."""
    r = s.float()
    over = r.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _split_bmm(a, b, acc=None):
    """acc + a @ b (acc zero unless given) as the kernels compute it: the
    three products of the TF32
    parts, small terms first, one m16n8k8 step of 8 of the contraction at
    a time, each step adding its eight exact products to the f32
    accumulator and truncating the sum toward zero, a model of the tensor
    cores' truncating accumulation.  How an MMA aligns the eight products
    inside a step is not modelled.  At C=320, d=2048, f=1408 (one expert)
    the model's GLU is 1.42e-4 from f64, near the kernels' 1.34e-4 on an
    H100 at 60 experts; at the test's shape an exact f32 sum of the three
    products is 10x closer to f64 than the model, so it would not bound
    the kernels' error."""
    ahi, alo = tf32_split(a)
    bhi, blo = tf32_split(b)
    if acc is None:
        acc = torch.zeros(a.shape[0], a.shape[1], b.shape[2])
    for k0 in range(0, a.shape[2], 8):
        for x, y in ((alo, bhi), (ahi, blo), (ahi, bhi)):
            acc = _toward_zero(acc.double() + torch.bmm(
                x[:, :, k0:k0 + 8].double(), y[:, k0:k0 + 8].double()))
    return acc


def test_split_tf32_glu_holds_the_f32_bar_against_f64():
    """The GLU from the three split products, in f32, against the GLU in
    f64 by the kernel's rule on the card (chip_smoke.py::lm_tol): within
    1e-5 + 1e-5 * (the sum of |terms| behind each output), the terms of
    h = silu(g)·u carrying g's and u's sums."""
    e, c, d, f = 2, 64, 512, 384
    rng = _rng(12)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    wg, wu = ((rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
              for _ in range(2))
    wo = (rng.standard_normal((e, f, d)) * f ** -0.5).astype(np.float32)
    x, wg, wu, wo = _t(x, wg, wu, wo)
    g, u = _split_bmm(x, wg), _split_bmm(x, wu)
    y = _split_bmm(torch.nn.functional.silu(g) * u, wo)
    x, wg, wu, wo = (a.double() for a in (x, wg, wu, wo))
    g, u = torch.bmm(x, wg), torch.bmm(x, wu)
    sig = torch.sigmoid(g)
    h = g * sig * u
    dsilu = sig * (1 + g * (1 - sig))
    terms_h = (h.abs() + (dsilu * u).abs() * torch.bmm(x.abs(), wg.abs())
               + (g * sig).abs() * torch.bmm(x.abs(), wu.abs()))
    scale = torch.bmm(terms_h, wo.abs())
    err = (y.double() - torch.bmm(h, wo)).abs()
    assert bool((err <= 1e-5 + 1e-5 * scale).all())


def _swa_split_model(q, k, v, window, bkv=32):
    """csrc/swa.cu's arithmetic on the CPU: 32-key tiles, each tile's
    scores as two partial sums over the halves of d's 8-wide k-steps
    (each through ``_split_bmm``) added in f32 and scaled, the online
    softmax in f32 (p = 0 and alpha = 0 on a row that has seen nothing),
    p split as it is stored, the accumulator rescaled by alpha and then
    given p v through ``_split_bmm``.  Every query row walks every key
    tile: a tile a row cannot see adds p = 0 and rescales by 1."""
    bh, t, d = q.shape
    scale = d ** -0.5
    nks = -(-d // 8)
    cut = 8 * (-(-nks // 2))
    i = torch.arange(t)[:, None]
    m = torch.full((bh, t, 1), -np.inf)
    l = torch.zeros((bh, t, 1))
    o = torch.zeros((bh, t, d))
    for k0 in range(0, t, bkv):
        kt, vt = k[:, k0:k0 + bkv], v[:, k0:k0 + bkv]
        s = (_split_bmm(q[..., :cut], kt[..., :cut].transpose(1, 2))
             + _split_bmm(q[..., cut:], kt[..., cut:].transpose(1, 2)))
        j = torch.arange(k0, k0 + kt.shape[1])[None, :]
        seen = (j <= i) & (j > i - window)
        s = torch.where(seen, s * scale, -np.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -np.inf, 0.0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        o = _split_bmm(p, vt, o * alpha)
    return o / torch.clamp(l, min=1e-20)


def _swa_f64(q, k, v, window):
    q, k, v = (a.double() for a in (q, k, v))
    t = q.shape[1]
    i, j = torch.arange(t)[:, None], torch.arange(t)[None, :]
    logits = (q @ k.transpose(1, 2)) * q.shape[2] ** -0.5
    logits = logits.masked_fill(~((j <= i) & (j > i - window)), -np.inf)
    return torch.softmax(logits, -1) @ v


@pytest.mark.parametrize("t,d,window", [
    (256, 256, 200),     # head_dim 256, a window not aligned to the tiles
    (200, 100, 70),      # a ragged last k-step (d % 8 = 4), ragged T
])
def test_split_tf32_swa_holds_the_f32_bar_against_f64(t, d, window):
    """The tensor-core attention's arithmetic (``_swa_split_model``)
    within the JAX suite's 1e-4 (rtol = atol) of the attention in f64, and
    of the plain version."""
    q, k, v = _t(*_qkv(2, t, d, seed=d + window))
    got = _swa_split_model(q, k, v, window)
    exact = _swa_f64(q, k, v, window)
    assert bool(((got.double() - exact).abs()
                 <= 1e-4 + 1e-4 * exact.abs()).all())
    torch.testing.assert_close(got, swa_attention_plain(q, k, v,
                                                        window=window), **TOL)


def _wkv6_chunk_parallel(r, k, v, w, u, chunk):
    """csrc/wkv6.cu's decomposition on the CPU, exp(cum) taken as the
    running product P of the clipped decays: the state pass S_n = P_c
    S_{n-1} + (k * P_c / P)^T v over the chunks in order, keeping the
    state that enters each chunk, then every chunk's output a v + qp
    S_{n-1} at once (qp = r * P_{t-1}, kp = k / P),
    its three products in split TF32 (``_split_bmm``), a v first into the
    accumulator that qp S continues."""
    bh, t, dk = r.shape
    dv = v.shape[2]
    c = min(chunk, t)
    n = t // c
    rc, kc, wc = (a.reshape(bh, n, c, dk) for a in (r, k, w))
    vc = v.reshape(bh, n, c, dv)
    wcl = torch.clamp(wc, 1e-6, 1.0)
    prod = torch.cumprod(wcl, dim=2)                      # exp(cum)
    pc = prod[:, :, -1:]                                  # (bh, n, 1, dk)
    upd = (kc * (pc / prod)).transpose(2, 3) @ vc
    decay = pc.transpose(2, 3)                            # (bh, n, dk, 1)
    s = torch.zeros((bh, dk, dv))
    entering = []
    for i in range(n):
        entering.append(s)
        s = decay[:, i] * s + upd[:, i]
    before = torch.cat([torch.ones_like(prod[:, :, :1]), prod[:, :, :-1]],
                       dim=2)
    qp = (rc * before).reshape(bh * n, c, dk)
    kp = (kc / prod).reshape(bh * n, c, dk)
    lower = torch.ones(c, c, dtype=torch.bool).tril(-1)
    a = torch.where(lower, _split_bmm(qp, kp.transpose(1, 2)), 0.0)
    a = a + torch.diag_embed((rc * u[:, None, None, :] * kc).sum(-1)
                             .reshape(bh * n, c))
    out = _split_bmm(qp, torch.stack(entering, 1).reshape(bh * n, dk, dv),
                     _split_bmm(a, vc.reshape(bh * n, c, dv)))
    return out.reshape(bh, t, dv), s


@pytest.mark.parametrize("bh,t,dk,dv,chunk,w_lo", [
    (2, 256, 64, 64, 64, 0.55),     # the TPU kernel's domain at chunk 64
    (2, 128, 16, 16, 16, np.exp(-np.e)),   # the model's decays, chunk 16
    (3, 192, 8, 100, 48, 0.55),     # dk 8, dv past one 64-column tile
    (1, 64, 32, 24, 64, 0.55),      # one chunk
])
def test_chunk_parallel_wkv6_holds_the_scan(bh, t, dk, dv, chunk, w_lo):
    """The two-kernel decomposition (``_wkv6_chunk_parallel``) within the
    JAX suite's 3e-4 of the sequential scan in f64 (``ref.wkv6``'s
    recurrence) and of the plain chunk loop."""
    args = _wkv_inputs(bh, t, dk, dv, seed=t + dv, w_lo=w_lo,
                       w_span=1 - w_lo)
    o, s = _wkv6_chunk_parallel(*_t(*args), chunk)
    po, ps = wkv6_chunked_plain(*_t(*args), chunk=chunk)
    torch.testing.assert_close(o, po, **WKV_TOL)
    torch.testing.assert_close(s, ps, **WKV_TOL)
    r, k, v, w, u = (a.astype(np.float64) for a in args)
    state = np.zeros((bh, dk, dv))
    want = np.empty((bh, t, dv))
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]
        want[:, i] = np.einsum("bk,bkv->bv", r[:, i], state + u[..., None]
                               * kv)
        state = w[:, i, :, None] * state + kv
    np.testing.assert_allclose(o.numpy(), want, **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), state, **WKV_TOL)


# ------------------------------------------------------- the entry point ---

def test_ops_carries_the_jax_names_and_the_wrappers_counts():
    names = ["fused_s2v_layer", "fused_s2v_layer_sparse",
             "fused_s2v_layer_csr", "mp_aggregate", "sparse_mp_aggregate",
             "wkv6", "swa", "grouped_glu_ffn"]
    for name in names:
        assert hasattr(jops, name), name
        fn = getattr(ops, name)
        assert getattr(pt_kernels, name) is fn
        assert isinstance(fn.launches, int)
    assert sorted(ops.__all__) == sorted(names)


def test_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing():
    before = {n: getattr(ops, n).launches
              for n in ("wkv6", "swa", "grouped_glu_ffn")}
    wargs = _t(*_wkv_inputs(2, 64, 8, 8, seed=2))
    o, s = ops.wkv6(*wargs, chunk=16)
    po, ps = wkv6_chunked_plain(*wargs, chunk=16)
    assert torch.equal(o, po) and torch.equal(s, ps)
    qkv = _t(*_qkv(2, 64, 16, seed=2))
    assert torch.equal(ops.swa(*qkv, window=20),
                       swa_attention_plain(*qkv, window=20))
    gargs = _t(*_glu_inputs(2, 8, 16, 24, seed=2))
    assert torch.equal(ops.grouped_glu_ffn(*gargs),
                       grouped_glu_ffn_plain(*gargs))
    assert before == {n: getattr(ops, n).launches for n in before}
