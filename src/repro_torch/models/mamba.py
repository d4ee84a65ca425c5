"""Mamba selective-SSM mixer (Jamba's recurrent layer, [arXiv:2403.19887]).
Counterpart of ``repro/models/mamba.py``.

Diagonal selective scan: h_t = exp(Δ_t A) ⊙ h_{t-1} + Δ_t B_t x_t,
y_t = C_t·h_t + D x_t, a loop over time (JAX's ``lax.scan``; the JAX
package has no kernel here).

State for decode: {"conv": (B, d_conv-1, d_inner), "ssm": (B, d_inner,
d_state) f32}.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .common import F32, dense_init
from .shard import NO_SHARD


def d_inner_of(cfg) -> int:
    return cfg.mamba_expand * cfg.d_model


def dt_rank_of(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def init_mamba(gen, cfg, dtype, device):
    d = cfg.d_model
    di = d_inner_of(cfg)
    ds = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    dtr = dt_rank_of(cfg)
    a = torch.arange(1, ds + 1, dtype=F32, device=device)[None, :].repeat(
        di, 1)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dtype, device),
        "conv_w": dense_init(gen, (dc, di), dtype, device, fan_in=dc),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": dense_init(gen, (di, dtr + 2 * ds), dtype, device),
        "dt_proj": dense_init(gen, (dtr, di), dtype, device),
        "dt_bias": torch.full((di,), -4.6, dtype=F32, device=device),
        "A_log": torch.log(a),
        "D": torch.ones((di,), dtype=F32, device=device),
        "out_proj": dense_init(gen, (di, d), dtype, device),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv along T. x (B,T,di), w (dc,di).  conv_state
    (B, dc-1, di) holds the trailing context for decode.  Returns
    (y, new_conv_state)."""
    bsz, t, di = x.shape
    dc = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((bsz, dc - 1, di), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state, x], dim=1)                  # (B, T+dc-1, di)
    y = sum(xp[:, i:i + t] * w[i][None, None, :] for i in range(dc))
    new_state = xp[:, xp.shape[1] - (dc - 1):]
    return y + b[None, None, :], new_state


def mamba_apply(p, x, *, cfg, state: Optional[dict] = None,
                sharder=NO_SHARD):
    """Returns (out (B,T,d), new_state)."""
    bsz, t, d = x.shape
    di = d_inner_of(cfg)
    ds = cfg.mamba_d_state
    dtr = dt_rank_of(cfg)

    xz = torch.einsum("btd,de->bte", x, p["in_proj"])
    xin, z = xz[..., :di], xz[..., di:]
    xin = sharder.act(xin, "act_ffn")
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)

    proj = torch.einsum("bte,ef->btf", xc, p["x_proj"])
    dt = F.softplus(torch.einsum("btr,re->bte", proj[..., :dtr],
                                 p["dt_proj"]).float() + p["dt_bias"])
    bmat = proj[..., dtr:dtr + ds].float()                  # (B,T,ds)
    cmat = proj[..., dtr + ds:].float()                     # (B,T,ds)
    a = -torch.exp(p["A_log"])                              # (di, ds)

    h = state["ssm"].float() if state is not None else torch.zeros(
        (bsz, di, ds), dtype=F32, device=x.device)
    xc32 = xc.float()
    ys = []
    for i in range(t):
        dt_t, b_t, c_t, x_t = dt[:, i], bmat[:, i], cmat[:, i], xc32[:, i]
        da = torch.exp(dt_t[:, :, None] * a[None])          # (B,di,ds)
        h = da * h + (dt_t * x_t)[:, :, None] * b_t[:, None, :]
        ys.append(torch.einsum("bis,bs->bi", h, c_t))
    y = torch.stack(ys, dim=1) + p["D"][None, None, :] * xc32  # (B,T,di)
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bte,ed->btd", y, p["out_proj"])
    new_state = {"conv": new_conv, "ssm": h}
    return sharder.act(out, "act_resid"), new_state
