"""Layer blocks: (mixer, ffn) pairs with pre-norms and residuals, and the
segment "program" that groups a config's layers into repeated runs.
Counterpart of ``repro/models/blocks.py``.

A segment is ``(repeats, unit)`` where ``unit`` is a tuple of per-layer
(mixer_kind, ffn_kind) signatures; a segment's parameters are stacked
over ``repeats`` (JAX scans over them; the port loops).  Heterogeneous
tails (e.g. gemma3-4b's 34 = 5×6 + 4 layers) fall back to single-layer
segments.

On the LM mesh ``block_apply`` hands the mesh to the GQA mixer and the
FFNs: each reads from its weights whether the rank holds tensor-parallel
blocks (``models.shard``) and sums its partial output over ``model``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .attention import cache_kv_heads, gqa_apply, init_gqa, init_mla, \
    mla_apply
from .common import F32, rms_norm
from .ffn import (init_mlp, init_moe, init_rwkv_cm, mlp_apply, moe_apply,
                  rwkv_cm_apply)
from .mamba import d_inner_of, init_mamba, mamba_apply
from .rwkv import init_rwkv, rwkv_apply
from .shard import NO_SHARD, split_axis

Sig = Tuple[str, str]  # (mixer kind, ffn kind)


@dataclasses.dataclass
class ModelCtx:
    """Execution context threaded through the apply functions (JAX's
    fields and defaults; ``remat`` only matters to training)."""
    mesh: Any = None
    moe_mode: str = "dense"           # dense | allreduce | alltoall
    sharder: Any = NO_SHARD
    remat: bool = True
    wkv_chunk: int = 64
    q_chunk: int = 512


def layer_sigs(cfg) -> List[Sig]:
    return [(cfg.kind_of_layer(l), cfg.ffn_of_layer(l))
            for l in range(cfg.n_layers)]


def build_program(cfg) -> List[Tuple[int, Tuple[Sig, ...]]]:
    """Greedy segmentation of the layer signature list."""
    sigs = layer_sigs(cfg)
    sp = len(cfg.pattern)
    if cfg.is_moe and cfg.moe_every > 1:
        sp = sp * cfg.moe_every // math.gcd(sp, cfg.moe_every)
    segments: List[Tuple[int, Tuple[Sig, ...]]] = []
    i, n = 0, len(sigs)
    while i < n:
        unit = tuple(sigs[i:i + sp])
        reps = 0
        j = i
        while j + sp <= n and tuple(sigs[j:j + sp]) == unit:
            reps += 1
            j += sp
        if reps >= 1 and len(unit) == sp:
            segments.append((reps, unit))
            i = j
        else:
            segments.append((1, (sigs[i],)))
            i += 1
    return segments


# ------------------------------------------------------------- blocks ------

_MIXER_INIT = {"attn": init_gqa, "swa": init_gqa, "mla": init_mla,
               "mamba": init_mamba, "rwkv": init_rwkv}


def init_block(gen, cfg, sig: Sig, dtype, device) -> Dict:
    kind, ffn_kind = sig
    d = cfg.d_model
    p = {
        "norm1": torch.zeros((d,), dtype=dtype, device=device),
        "mixer": _MIXER_INIT[kind](gen, cfg, dtype, device),
        "norm2": torch.zeros((d,), dtype=dtype, device=device),
    }
    if ffn_kind == "moe":
        p["ffn"] = init_moe(gen, cfg, dtype, device)
    elif ffn_kind == "rwkv_cm":
        p["ffn"] = init_rwkv_cm(gen, d, cfg.d_ff, dtype, device)
    elif ffn_kind == "mlp":
        p["ffn"] = init_mlp(gen, d, cfg.d_ff, dtype, device, gated=False)
    else:  # glu
        p["ffn"] = init_mlp(gen, d, cfg.d_ff, dtype, device, gated=True)
    return p


def init_block_cache(cfg, sig: Sig, batch: int, seq: int, dtype, device,
                     mesh=None):
    """Decode-time cache for one layer (a GQA layer's kv heads a rank's of
    ``mesh`` under its blocks, ``attention.cache_kv_heads``)."""
    kind, ffn_kind = sig
    d, kv, hd = cfg.d_model, cache_kv_heads(cfg, mesh), cfg.head_dim

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    c: Dict[str, Any] = {}
    if kind in ("attn", "swa"):
        s = min(seq, cfg.sliding_window) if (
            kind == "swa" and cfg.sliding_window) else seq
        c["k"] = zeros((batch, s, kv, hd))
        c["v"] = zeros((batch, s, kv, hd))
        c["k_pos"] = torch.full((batch, s), -1, dtype=torch.int32,
                                device=device)
    elif kind == "mla":
        c["ckv"] = zeros((batch, seq, cfg.kv_lora_rank))
        c["krope"] = zeros((batch, seq, cfg.qk_rope_dim))
    elif kind == "mamba":
        c["conv"] = zeros((batch, cfg.mamba_d_conv - 1, d_inner_of(cfg)))
        c["ssm"] = zeros((batch, d_inner_of(cfg), cfg.mamba_d_state), F32)
    elif kind == "rwkv":
        n = cfg.rwkv_head_dim
        c["shift"] = zeros((batch, 1, d))
        c["wkv"] = zeros((batch, d // n, n, n), F32)
    if ffn_kind == "rwkv_cm":
        c["cm_shift"] = zeros((batch, 1, d))
    return c


def block_apply(p, x, *, cfg, sig: Sig, ctx: ModelCtx,
                cache: Optional[dict] = None,
                pos: Optional[torch.Tensor] = None):
    """Returns (x, new_cache, aux_loss)."""
    kind, ffn_kind = sig
    sharder = ctx.sharder
    aux = torch.zeros((), dtype=F32, device=x.device)

    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    new_cache: Dict[str, Any] = {}
    if kind in ("attn", "swa"):
        attn_kind = ("bidir" if cfg.is_encoder else
                     ("window" if kind == "swa" and cfg.sliding_window
                      else "causal"))
        mixer_cache = ({k: cache[k] for k in ("k", "v", "k_pos")}
                       if cache is not None else None)
        out, mc = gqa_apply(p["mixer"], h, cfg=cfg, kind=attn_kind,
                            cache=mixer_cache, pos=pos, sharder=sharder,
                            q_chunk=ctx.q_chunk, mesh=ctx.mesh)
    elif kind == "mla":
        mixer_cache = ({k: cache[k] for k in ("ckv", "krope")}
                       if cache is not None else None)
        out, mc = mla_apply(p["mixer"], h, cfg=cfg, cache=mixer_cache,
                            pos=pos, sharder=sharder, q_chunk=ctx.q_chunk)
    elif kind == "mamba":
        mixer_cache = ({k: cache[k] for k in ("conv", "ssm")}
                       if cache is not None else None)
        out, mc = mamba_apply(p["mixer"], h, cfg=cfg, state=mixer_cache,
                              sharder=sharder)
    elif kind == "rwkv":
        mixer_cache = ({"shift": cache["shift"], "wkv": cache["wkv"]}
                       if cache is not None else None)
        out, mc = rwkv_apply(p["mixer"], h, cfg=cfg, state=mixer_cache,
                             sharder=sharder, chunk=ctx.wkv_chunk)
    else:
        raise ValueError(kind)
    new_cache.update(mc)
    x = x + out

    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    if ffn_kind == "moe":
        y, aux = moe_apply(p["ffn"], h2, cfg=cfg, mesh=ctx.mesh,
                           mode=ctx.moe_mode, sharder=sharder)
    elif ffn_kind == "rwkv_cm":
        prev = (cache["cm_shift"] if cache is not None else
                torch.zeros_like(h2[:, :1]))
        y, new_cache["cm_shift"] = rwkv_cm_apply(p["ffn"], h2, x_prev=prev,
                                                 sharder=sharder)
    else:
        axis = split_axis(ctx.mesh, p["ffn"]["wu"].shape[-1], cfg.d_ff)
        y = mlp_apply(p["ffn"], h2, gated=ffn_kind != "mlp",
                      sharder=sharder, axis=axis)
    x = x + y
    return x, new_cache, aux
