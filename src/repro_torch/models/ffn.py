"""Feed-forward blocks: dense MLP/GLU, RWKV channel mix, and
Mixture-of-Experts.  Counterpart of ``repro/models/ffn.py``.

On one device the MoE layer computes every expert for every token and
combines them by the router's sparse weights (JAX's ``moe_dense_apply``).
Its all-experts product goes through kernel B8
(``kernels/moe_gemm.py::grouped_glu_ffn``) on the (E, T·B, d) broadcast
of the tokens: the hand-written kernels on CUDA tensors, the plain
version on CPU tensors.  JAX's expert-parallel ``moe_sharded_apply``
comes with the LM mesh (ROADMAP A8c).

The expert count is padded to a multiple of 16 so expert weights shard on
any production mesh (the padded experts are unroutable).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.moe_gemm import grouped_glu_ffn
from .common import F32, dense_init
from .shard import NO_SHARD

EXPERT_PAD = 16
MESH_ITEM = "ROADMAP A8c, 'The LM mesh'"


def padded_experts(n: int) -> int:
    return -(-n // EXPERT_PAD) * EXPERT_PAD


# ------------------------------------------------------------- dense -------

def init_mlp(gen, d: int, d_ff: int, dtype, device, gated: bool):
    p = {"wu": dense_init(gen, (d, d_ff), dtype, device),
         "wo": dense_init(gen, (d_ff, d), dtype, device)}
    if gated:
        p["wg"] = dense_init(gen, (d, d_ff), dtype, device)
    return p


def mlp_apply(p, x, *, gated: bool, sharder=NO_SHARD):
    up = torch.einsum("btd,df->btf", x, p["wu"])
    if gated:
        gate = torch.einsum("btd,df->btf", x, p["wg"])
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")    # jax.nn.gelu's default
    h = sharder.act(h, "act_ffn")
    y = torch.einsum("btf,fd->btd", h, p["wo"])
    return sharder.act(y, "act_resid")


# ------------------------------------------------------------- RWKV CM -----

def init_rwkv_cm(gen, d: int, d_ff: int, dtype, device):
    return {"wr": dense_init(gen, (d, d), dtype, device),
            "wk": dense_init(gen, (d, d_ff), dtype, device),
            "wv": dense_init(gen, (d_ff, d), dtype, device),
            "mu_r": torch.full((d,), 0.5, dtype=dtype, device=device),
            "mu_k": torch.full((d,), 0.5, dtype=dtype, device=device)}


def rwkv_cm_apply(p, x, *, x_prev, sharder=NO_SHARD):
    """RWKV channel mix with token shift. x (B,T,d); x_prev (B,1,d) is the
    last token of the previous segment (the decode state).  Returns (out,
    new_x_prev)."""
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    xr = x + (shifted - x) * p["mu_r"]
    xk = x + (shifted - x) * p["mu_k"]
    r = torch.sigmoid(torch.einsum("btd,de->bte", xr, p["wr"]))
    k = torch.square(torch.relu(torch.einsum("btd,df->btf", xk, p["wk"])))
    k = sharder.act(k, "act_ffn")
    y = r * torch.einsum("btf,fd->btd", k, p["wv"])
    return sharder.act(y, "act_resid"), x[:, -1:]


# --------------------------------------------------------------- MoE -------

def init_moe(gen, cfg, dtype, device):
    d, e = cfg.d_model, cfg.n_experts
    ep = padded_experts(e)
    ffe = cfg.d_ff_expert or cfg.d_ff
    p = {
        "router": dense_init(gen, (d, e), F32, device),
        "ewg": dense_init(gen, (ep, d, ffe), dtype, device, fan_in=d),
        "ewu": dense_init(gen, (ep, d, ffe), dtype, device, fan_in=d),
        "ewo": dense_init(gen, (ep, ffe, d), dtype, device, fan_in=ffe),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, ffe * cfg.n_shared_experts, dtype,
                               device, gated=True)
    return p


def _route(router_w, x_flat, k: int):
    """Returns (ids (T,k), weights (T,k) renormalized, aux_loss scalar)."""
    logits = torch.einsum("td,de->te", x_flat.float(), router_w)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux (Switch-style): E * Σ_e f_e · P_e
    e = router_w.shape[1]
    f = F.one_hot(ids, e).to(F32).sum(1).mean(0)
    aux = e * torch.sum(f * probs.mean(0))
    return ids, w.to(x_flat.dtype), aux


def moe_dense_apply(p, x, *, cfg, sharder=NO_SHARD):
    """Every expert for every token, combined by the router's weights; the
    experts' GLU through B8."""
    b, t, d = x.shape
    e = cfg.n_experts
    xf = x.reshape(b * t, d)
    ids, w, aux = _route(p["router"], xf, cfg.experts_per_token)
    gates = torch.zeros((b * t, e), dtype=x.dtype, device=x.device)
    gates.scatter_add_(1, ids, w)
    xe = xf[None].expand(e, b * t, d).contiguous()
    yo = grouped_glu_ffn(xe, p["ewg"][:e], p["ewu"][:e],
                         p["ewo"][:e]).to(x.dtype)
    y = torch.einsum("te,etd->td", gates, yo)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, gated=True,
                          sharder=sharder).reshape(b * t, d)
    return y.reshape(b, t, d), aux


def moe_apply(p, x, *, cfg, mesh=None, mode: str = "dense",
              sharder=NO_SHARD):
    """The MoE layer on one device (``mesh`` None): ``moe_dense_apply``.
    The expert-parallel modes run on the LM mesh, not ported yet."""
    if mesh is not None:
        raise ValueError(f"moe_apply on a mesh (mode {mode!r}) is "
                         f"{MESH_ITEM}, not ported yet; pass mesh=None")
    return moe_dense_apply(p, x, cfg=cfg, sharder=sharder)
