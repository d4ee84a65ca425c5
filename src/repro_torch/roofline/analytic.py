"""Analytic FLOPs / HBM-traffic model per (arch × shape).  Counterpart of
``repro/roofline/analytic.py``, the same arithmetic on the same configs.

Why this exists: XLA's ``cost_analysis()`` counts ``while`` bodies once,
and the port's count (``roofline.count``) takes the matmuls' FLOPs only,
so a counted step can fall short of its work.  The roofline compute and
memory terms therefore use ``max(counted, analytic)``, and both values
are recorded.

FLOP conventions: 2 FLOPs per MAC; train = 3× forward (fwd + 2× bwd) + 1×
forward recompute when remat is on.
"""
from __future__ import annotations

from ..models.blocks import layer_sigs
from ..models.mamba import d_inner_of, dt_rank_of


def _attn_ctx(kind: str, cfg, shape) -> float:
    """Average attended context length per query token."""
    t = shape.seq_len
    if shape.mode == "decode":
        full = t                        # one token attending the whole cache
        return min(cfg.sliding_window, full) if (
            kind == "swa" and cfg.sliding_window) else full
    if kind == "swa" and cfg.sliding_window:
        return min(cfg.sliding_window, t)
    return (t + 1) / 2.0                # causal average (an encoder takes t)


def _layer_flops_per_token(cfg, shape, kind: str, ffn_kind: str) -> float:
    d = cfg.d_model
    fl = 0.0
    # mixer linear parts
    if kind in ("attn", "swa"):
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        fl += 2.0 * d * hd * (2 * h + 2 * kv)            # wq,wo,wk,wv
        ctx = _attn_ctx(kind, cfg, shape)
        if cfg.is_encoder:
            ctx = shape.seq_len
        fl += 4.0 * ctx * h * hd                         # qk + pv
    elif kind == "mla":
        ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        h = cfg.n_heads
        fl += 2.0 * (d * ql + ql * h * (dn + dr) + d * (kvl + dr)
                     + kvl * h * dn + kvl * h * dv + h * dv * d)
        ctx = _attn_ctx("attn", cfg, shape)
        fl += 2.0 * ctx * h * (2 * kvl + dr)             # latent qk+pv + rope
    elif kind == "mamba":
        di, ds = d_inner_of(cfg), cfg.mamba_d_state
        dtr = dt_rank_of(cfg)
        fl += 2.0 * (d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * d)
        fl += 2.0 * cfg.mamba_d_conv * di                # depthwise conv
        fl += 8.0 * di * ds                              # scan step (exp,mul,add,Cdot)
    elif kind == "rwkv":
        n = cfg.rwkv_head_dim
        lo = cfg.rwkv_lora_dim
        fl += 2.0 * (5 * d * d + d * 5 * lo * 2 + d * 2 * lo * 2)
        fl += 4.0 * d * (64 + n)                         # chunked wkv core
    # ffn
    if ffn_kind == "moe":
        ffe = cfg.d_ff_expert or cfg.d_ff
        fl += 2.0 * 3 * d * ffe * cfg.experts_per_token
        if cfg.n_shared_experts:
            fl += 2.0 * 3 * d * ffe * cfg.n_shared_experts
        fl += 2.0 * d * cfg.n_experts                    # router
    elif ffn_kind == "rwkv_cm":
        fl += 2.0 * (d * d + 2 * d * cfg.d_ff)
    elif ffn_kind == "mlp":
        fl += 2.0 * 2 * d * cfg.d_ff
    else:  # glu
        fl += 2.0 * 3 * d * cfg.d_ff
    return fl


def analytic_flops(cfg, shape, *, remat: bool = True) -> float:
    """Global FLOPs for one step of this (arch, shape)."""
    d = cfg.d_model
    per_tok = sum(_layer_flops_per_token(cfg, shape, k, f)
                  for k, f in layer_sigs(cfg))
    if shape.mode == "decode":
        tokens = shape.global_batch
        per_tok += 2.0 * d * cfg.vocab_size             # final logits
        return per_tok * tokens
    tokens = shape.global_batch * shape.seq_len
    per_tok += 2.0 * d * cfg.vocab_size                 # logits (train loss /
    fwd = per_tok * tokens                              # encoder head)
    if shape.mode == "prefill":
        return fwd
    mult = 4.0 if remat else 3.0
    return fwd * mult


def cache_bytes(cfg, shape) -> float:
    """Global KV/state cache bytes for decode shapes."""
    b, s = shape.global_batch, shape.seq_len
    bp = 2  # bf16
    total = 0.0
    for kind, ffn_kind in layer_sigs(cfg):
        if kind in ("attn", "swa"):
            sl = min(s, cfg.sliding_window) if (
                kind == "swa" and cfg.sliding_window) else s
            total += 2.0 * b * sl * cfg.n_kv_heads * cfg.head_dim * bp
        elif kind == "mla":
            total += b * s * (cfg.kv_lora_rank + cfg.qk_rope_dim) * bp
        elif kind == "mamba":
            di = d_inner_of(cfg)
            total += b * di * cfg.mamba_d_state * 4 + \
                b * (cfg.mamba_d_conv - 1) * di * bp
        elif kind == "rwkv":
            n = cfg.rwkv_head_dim
            total += b * (cfg.d_model // n) * n * n * 4 + b * cfg.d_model * bp
        if ffn_kind == "rwkv_cm":
            total += b * cfg.d_model * bp
    return total


def analytic_hbm_bytes(cfg, shape, params_total: int, params_active: int,
                       *, remat: bool = True) -> float:
    """Global HBM traffic estimate for one step (coarse, documented):

    train   : params 2B×(fwd read + recompute read + grad write)
              + Adam 8B×2×(read+write) + fp-act traffic ≈ 14·L·B·T·d·2B
    prefill : params read + act ≈ 8·L·B·T·d·2B + cache write
    decode  : active params read + full cache read + small vectors
    """
    d = cfg.d_model
    l = cfg.n_layers
    bp = 2
    if shape.mode == "decode":
        return params_active * bp + cache_bytes(cfg, shape) + \
            shape.global_batch * d * l * bp * 8
    bt = shape.global_batch * shape.seq_len
    act = 14.0 * l * bt * d * bp
    if shape.mode == "prefill":
        return params_total * bp + 8.0 * l * bt * d * bp + \
            cache_bytes(cfg, shape)
    reads = (3.0 if remat else 2.0) * params_total * bp
    grads = params_total * bp
    adam = params_total * 4.0 * 2 * 2          # m, v fp32 read+write
    pwrite = params_total * bp
    return reads + grads + adam + pwrite + act
