"""RWKV-6 ("Finch") time-mix block with data-dependent decay
[arXiv:2404.05892].  Counterpart of ``repro/models/rwkv.py``.

The recurrence over a sequence goes through kernel B6
(``kernels/wkv6.py::wkv6_chunked``, from the state ``s0`` the block
carries): the two hand-written kernels on CUDA tensors, its plain version
(the loop over chunks of JAX's ``wkv6_chunked_jnp``) on CPU tensors.  A
one-token decode with a state is the single recurrence step.

The chunk formula is finite for decays w >= 0.55 at chunk 64 and over the
model's whole range w >= exp(-e) at chunk 16 (``kernels/wkv6.py``), so
serving runs ``ModelCtx(wkv_chunk=16)`` as JAX's launcher does.

State for decode: {"shift": (B,1,D) last token, "wkv": (B,H,N,N) f32}.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.wkv6 import wkv6_chunked
from .common import F32, dense_init, randn
from .shard import NO_SHARD

LORA_MIX = 5  # w, k, v, r, g


def init_rwkv(gen, cfg, dtype, device):
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    h = d // n
    lo = cfg.rwkv_lora_dim
    return {
        "mu_x": torch.full((d,), 0.5, dtype=dtype, device=device),
        "maa": torch.zeros((LORA_MIX, d), dtype=dtype, device=device),
        "mix_w1": dense_init(gen, (d, LORA_MIX * lo), dtype, device),
        "mix_w2": dense_init(gen, (LORA_MIX, lo, d), dtype, device,
                             fan_in=lo),
        "w0": torch.full((d,), -0.6, dtype=F32, device=device),
        "td_w1": dense_init(gen, (d, 2 * lo), dtype, device),
        "td_w2": dense_init(gen, (2 * lo, d), dtype, device, fan_in=2 * lo),
        "u": randn(gen, (h, n), device) * 0.1,
        "wr": dense_init(gen, (d, d), dtype, device),
        "wk": dense_init(gen, (d, d), dtype, device),
        "wv": dense_init(gen, (d, d), dtype, device),
        "wg": dense_init(gen, (d, d), dtype, device),
        "wo": dense_init(gen, (d, d), dtype, device),
        "ln_scale": torch.ones((d,), dtype=F32, device=device),
        "ln_bias": torch.zeros((d,), dtype=F32, device=device),
    }


def _group_norm(x, scale, bias, h, n, eps=1e-5):
    """Per-head LayerNorm over the head channel dim. x (B,T,D) → f32."""
    b, t, d = x.shape
    xh = x.reshape(b, t, h, n).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return xh.reshape(b, t, d) * scale + bias


def rwkv_apply(p, x, *, cfg, state: Optional[dict] = None, sharder=NO_SHARD,
               chunk: int = 64):
    """Time-mix block. Returns (out, new_state)."""
    b, t, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    dtype = x.dtype

    x_prev = state["shift"] if state is not None else torch.zeros(
        (b, 1, d), dtype=dtype, device=x.device)
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1) if t > 1 else x_prev
    xx = shifted - x

    # data-dependent token shift (ddlerp)
    xxx = x + xx * p["mu_x"]
    mix = torch.tanh(torch.einsum("btd,dl->btl", xxx, p["mix_w1"]))
    mix = mix.reshape(b, t, LORA_MIX, -1)
    mix = torch.einsum("btml,mld->btmd", mix, p["mix_w2"])  # (B,T,5,D)
    xw, xk, xv, xr, xg = [x + xx * (p["maa"][i] + mix[:, :, i])
                          for i in range(LORA_MIX)]

    # data-dependent decay, w in (0, 1)
    dd = torch.einsum("btd,dl->btl", xw, p["td_w1"])
    dd = torch.einsum("btl,ld->btd", torch.tanh(dd), p["td_w2"])
    logw = -torch.exp(torch.clamp(p["w0"] + dd.float(), -8.0, 1.0))
    w = torch.exp(logw)                                     # decay multiplier

    r = torch.einsum("btd,de->bte", xr, p["wr"])
    k = torch.einsum("btd,de->bte", xk, p["wk"])
    v = torch.einsum("btd,de->bte", xv, p["wv"])
    g = torch.einsum("btd,de->bte", xg, p["wg"])
    r = sharder.act(r, "act_qkv")

    def heads(a):
        return a.reshape(b, t, h, n).transpose(1, 2).reshape(
            b * h, t, n).contiguous()

    s0 = state["wkv"].reshape(b * h, n, n) if state is not None else None
    u = p["u"][None].expand(b, h, n).reshape(b * h, n).contiguous()
    if t == 1 and state is not None:
        # decode: one recurrence step
        rt, kt, vt, wt = (heads(a)[:, 0] for a in (r, k, v, w))
        kv = kt[:, :, None] * vt[:, None, :]
        o = torch.einsum("bi,bij->bj", rt.float(), s0 + u[:, :, None] * kv)
        s_new = wt.float()[:, :, None] * s0 + kv
        out_h = o[:, None, :]
    else:
        out_h, s_new = wkv6_chunked(
            heads(r), heads(k), heads(v), heads(w), u,
            s0=None if s0 is None else s0.contiguous(), chunk=chunk)
    out = out_h.reshape(b, h, t, n).transpose(1, 2).reshape(b, t, d)
    out = _group_norm(out, p["ln_scale"], p["ln_bias"], h, n)
    out = out.to(dtype) * F.silu(g)
    y = torch.einsum("bte,ed->btd", out, p["wo"])
    new_state = {"shift": x[:, -1:], "wkv": s_new.reshape(b, h, n, n)}
    return sharder.act(y, "act_resid"), new_state
