"""Model assembly and the serving steps for every architecture of the
configs.  Counterpart of the serving half of ``repro/models/lm.py``.

One generic implementation covers the ten architectures through the
config's layer program: decoder LMs (dense, MoE, SSM, hybrid), the
hubert-style encoder (bidirectional, a per-frame head) and the
llava-style VLM (patch embeddings before the token stream).

The parameter tree is JAX's: ``embed``, ``final_norm``, optional
``frontend_proj`` and ``mtp_proj``, and ``segments``, a list (one per
segment of ``build_program``) of per-unit-position block dicts whose
leaves are stacked over the segment's repeats (unstacked at one repeat).
Caches follow the same layout.  So weights cross from JAX by a structural
map (``convert.lm_params_from_numpy``).

Steps:
  prefill(params, batch)                -> (last_logits, caches)
  decode_step(params, caches, tok, pos) -> (logits, next_tok, caches)
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..device import DeviceLike, resolve_device
from .blocks import (ModelCtx, block_apply, build_program, init_block,
                     init_block_cache)
from .common import (F32, dense_init, embed_init, rms_norm, tree_leaves,
                     tree_map)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _stack_reps(make, reps: int):
    """``make(r)`` for r < reps, stacked leaf by leaf over a new leading
    axis (one repeat stays unstacked), filled in place so that no more
    than one repeat's tree is held beside the stack."""
    first = make(0)
    if reps == 1:
        return first
    stacked = tree_map(lambda a: torch.empty((reps, *a.shape), dtype=a.dtype,
                                             device=a.device), first)

    def fill(r, tree):
        tree_map(lambda dst, src: dst[r].copy_(src), stacked, tree)
    fill(0, first)
    del first
    for r in range(1, reps):
        fill(r, make(r))
    return stacked


# ------------------------------------------------------------- init --------

def _init_params(cfg, gen: Optional[torch.Generator],
                 device: torch.device) -> Dict[str, Any]:
    dtype = _dtype_of(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }
    if cfg.frontend_dim:
        params["frontend_proj"] = dense_init(
            gen, (cfg.frontend_dim, cfg.d_model), dtype, device)
    if cfg.mtp_weight > 0:
        params["mtp_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model),
                                        dtype, device)
    params["segments"] = [
        [_stack_reps(lambda r, sig=sig: init_block(gen, cfg, sig, dtype,
                                                   device), reps)
         for sig in unit]
        for reps, unit in build_program(cfg)]
    return params


def init_params(cfg, *, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Random weights of ``cfg`` made on ``device`` from ``generator`` (a
    generator on that device seeded with ``seed`` when None): JAX's
    distributions and shapes, not its values."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(
        device=dev).manual_seed(seed)
    with torch.no_grad():
        return _init_params(cfg, gen, dev)


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree of ``cfg`` as (shape, dtype) leaves, made on the
    meta device (no memory)."""
    return tree_map(lambda a: (tuple(a.shape), a.dtype),
                    _init_params(cfg, None, torch.device("meta")))


def init_cache(cfg, batch: int, seq: int, *,
               device: DeviceLike = "cuda") -> list:
    dev = resolve_device(device)
    dtype = _dtype_of(cfg)
    return [[_stack_reps(lambda r, sig=sig: init_block_cache(
        cfg, sig, batch, seq, dtype, dev), reps) for sig in unit]
        for reps, unit in build_program(cfg)]


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


# ------------------------------------------------------------- trunk -------

def _embed_inputs(params, cfg, batch: Dict[str, Any], ctx: ModelCtx):
    """Returns (x (B,T,d), labels or None, loss_mask or None)."""
    dtype = _dtype_of(cfg)
    dev = params["embed"].device

    def take(name):
        return torch.as_tensor(batch[name], device=dev)
    labels = take("labels") if "labels" in batch else None
    if cfg.is_encoder:
        x = torch.einsum("btf,fd->btd", take("frames").to(dtype),
                         params["frontend_proj"])
        return x, labels, None
    tok_emb = params["embed"][take("tokens").long()]
    if cfg.vlm_patches:
        patches = torch.einsum("bpf,fd->bpd", take("patches").to(dtype),
                               params["frontend_proj"])
        x = torch.cat([patches, tok_emb], dim=1)
        mask = None
        if labels is not None:
            # the loss covers the text region only
            mask = torch.cat([torch.zeros(patches.shape[:2], dtype=F32,
                                          device=dev),
                              torch.ones(tok_emb.shape[:2], dtype=F32,
                                         device=dev)], dim=1)
            labels = torch.cat([torch.zeros(patches.shape[:2],
                                            dtype=labels.dtype, device=dev),
                                labels], dim=1)
        return x, labels, mask
    return tok_emb, labels, None


def _at(tree, r: int):
    return tree_map(lambda a: a[r], tree)


def _apply_segments(params, cfg, x, ctx: ModelCtx,
                    caches: Optional[list] = None,
                    pos: Optional[torch.Tensor] = None,
                    collect_cache: bool = False):
    """Runs the layer program, a segment's repeats in a loop.

    caches=None, collect_cache=False → forward with no cache I/O.
    caches=None, collect_cache=True  → prefill (fresh caches returned).
    caches=list                      → decode (caches read and updated).
    Returns (x, new_caches | None, aux_sum)."""
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    want_cache = collect_cache or caches is not None
    new_caches = [] if want_cache else None

    for si, (reps, unit) in enumerate(build_program(cfg)):
        seg_params = params["segments"][si]
        seg_cache = caches[si] if caches is not None else None
        per_rep = []
        for r in range(reps):
            layer_new = []
            for j, sig in enumerate(unit):
                pj = seg_params[j] if reps == 1 else _at(seg_params[j], r)
                cj = None
                if seg_cache is not None:
                    cj = seg_cache[j] if reps == 1 else _at(seg_cache[j], r)
                x, nc, aux = block_apply(pj, x, cfg=cfg, sig=sig, ctx=ctx,
                                         cache=cj, pos=pos)
                aux_total = aux_total + aux
                layer_new.append(nc)
            per_rep.append(layer_new)
        if want_cache:
            new_caches.append(per_rep[0] if reps == 1 else [
                tree_map(lambda *xs: torch.stack(xs),
                         *(layer[j] for layer in per_rep))
                for j in range(len(unit))])
    return x, new_caches, aux_total


def _final_hidden(params, cfg, x):
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


# ------------------------------------------------------------- steps -------

def make_prefill(cfg, ctx: ModelCtx):
    @torch.no_grad()
    def prefill(params, batch):
        x, _, _ = _embed_inputs(params, cfg, batch, ctx)
        x = ctx.sharder.act(x, "act_resid_in")
        x, caches, _ = _apply_segments(params, cfg, x, ctx,
                                       collect_cache=not cfg.is_encoder)
        h = _final_hidden(params, cfg, x)
        if cfg.is_encoder:
            # per-frame classification logits (hubert pretext targets)
            logits = torch.einsum("btd,vd->btv", h.float(),
                                  params["embed"].float())
            return logits, None
        logits = torch.einsum("bd,vd->bv", h[:, -1].float(),
                              params["embed"].float())
        return logits, caches
    return prefill


def make_decode_step(cfg, ctx: ModelCtx):
    @torch.no_grad()
    def decode_step(params, caches, token, pos):
        """token (B, 1) int; pos (B,) int32.  Returns (logits, next_tok,
        caches), next_tok the greedy argmax (B,) int32."""
        if cfg.is_encoder:
            raise ValueError("encoder has no decode step")
        dev = params["embed"].device
        x = params["embed"][torch.as_tensor(token, device=dev).long()]
        x = ctx.sharder.act(x, "act_resid_in")
        x, new_caches, _ = _apply_segments(
            params, cfg, x, ctx, caches=caches,
            pos=torch.as_tensor(pos, device=dev))
        h = _final_hidden(params, cfg, x)
        logits = torch.einsum("bd,vd->bv", h[:, 0].float(),
                              params["embed"].float())
        # the paper's all-gather + argmax (Alg. 4) applied to vocab logits
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, next_tok, new_caches
    return decode_step
