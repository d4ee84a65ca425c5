"""Model assembly, the loss and the train, eval and serving steps for
every architecture of the configs.  Counterpart of ``repro/models/lm.py``.

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
  train_step(params, opt, batch)        -> (params, opt, metrics)
  eval_step(params, batch)              -> metrics
  prefill(params, batch)                -> (last_logits, caches)
  decode_step(params, caches, tok, pos) -> (logits, next_tok, caches)

On the LM mesh (``ctx.mesh``) every step runs as rank code: each rank on
its rows of the batch (and its caches) and on the blocks it holds over
``model``, the same on every path (``shard.block_leaves``: the experts,
the GQA heads, the MLP's and shared experts' d_ff and the vocabulary,
where JAX's ``param_specs`` splits them).  The embedding lookup reads the
rank's vocabulary rows (zeros for tokens outside its block) and sums them
over ``model``; the tied head computes the rank's vocabulary block of the
logits, in f32 from the block alone, and serving gathers the blocks whole
over ``model``; the greedy token is the paper's Alg. 4 pick (each rank's
max and first argmax with its block's offset, gathered, the first largest
taken); a rank's decode cache holds its kv heads (``init_cache(mesh=)``).
The loss is JAX's global one on every rank: over a split vocabulary each
chunk's logsumexp is combined over ``model`` (the max, then the sum of
exponentials) and the gold logit is the rank's where the label lies in
its block, summed (``xent_parts(axis=)``), so no rank forms a chunk's
whole logits; the cross-entropies' sums and counts are summed over the
data axes before their ratio.  The gradient is JAX's too: each rank
differentiates that replicated loss, the replicated activations entering
split work through Megatron's f (``core.mesh.copy_to_axis``: the heads,
d_ff, the experts, the head's vocabulary block), whose gradient sums the
ranks' partials over ``model``; then every leaf is summed over the data
axes, and the clip takes the global norm, the blocks' squares summed over
``model`` and each whole leaf's counted once.  A step refuses a tree
placed in another layout, naming the first leaf that differs
(:func:`check_layout`).  After a step every whole leaf is equal on every
rank, bit for bit: the ranks of a data group receive the same reduced
bytes, and the ranks of a ``model`` group take model rank 0's gradients
of the whole leaves (the norms, the router and the leaves JAX's plan
keeps whole), which each computed completely but by its own process's
kernels, whose bits can differ.

The train step updates the parameters and the Adam state in place (and
returns them).  The vocabulary loss is taken in sequence chunks, each
recomputed in the backward (``chunked_xent``), so no (B, T, V) logits
buffer is formed: the 262k-vocabulary gemma3 configs need it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .. import optim
from ..core.mesh import (all_gather_tiled, all_reduce_grads, all_reduce_max,
                         all_reduce_sum, broadcast_first, copy_to_axis,
                         reduce_from_axis)
from ..device import DeviceLike, resolve_device
from ..sharding.rules import data_axes_of, map_with_path, param_specs
from .blocks import (ModelCtx, block_apply, build_program, init_block,
                     init_block_cache)
from .common import (F32, dense_init, embed_init, rms_norm, tree_leaves,
                     tree_map)
from .shard import BLOCK_AXIS, block_dims, block_leaves, split_axis

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LOSS_CHUNK = 512


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


def _init_cache(cfg, batch: int, seq: int, dev: torch.device,
                mesh=None) -> list:
    dtype = _dtype_of(cfg)
    return [[_stack_reps(lambda r, sig=sig: init_block_cache(
        cfg, sig, batch, seq, dtype, dev, mesh), reps) for sig in unit]
        for reps, unit in build_program(cfg)]


def init_cache(cfg, batch: int, seq: int, *,
               device: DeviceLike = "cuda", mesh=None) -> list:
    """The decode cache of ``batch`` rows and ``seq`` slots; on a rank of
    ``mesh`` (holding the blocks of ``shard.block_leaves``), a GQA layer's
    cache holds the rank's kv heads."""
    return _init_cache(cfg, batch, seq, resolve_device(device), mesh)


def cache_shapes(cfg, batch: int, seq: int, mesh=None) -> list:
    """The cache tree of ``init_cache`` as (shape, dtype) leaves, made on
    the meta device (no memory)."""
    return tree_map(lambda a: (tuple(a.shape), a.dtype),
                    _init_cache(cfg, batch, seq, torch.device("meta"),
                                mesh))


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
    tok_emb = _embed_lookup(params["embed"], take("tokens"), cfg, ctx.mesh)
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


def _embed_lookup(embed, tokens, cfg, mesh):
    """The embedding rows of ``tokens``.  On a rank holding the vocabulary
    as its block over ``model``: its rows for the tokens in its block,
    zeros for the rest, summed over ``model`` (each token's one row and
    zeros, so the sum is exact)."""
    tokens = tokens.long()
    ax = split_axis(mesh, embed.shape[0], cfg.vocab_size)
    if ax is None:
        return embed[tokens]
    n = embed.shape[0]
    local = tokens - ax.index * n
    mine = (local >= 0) & (local < n)
    rows = embed[local.clamp(0, n - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device))
    return reduce_from_axis(rows, ax)


def _head_logits(h, embed, cfg, mesh, spec: str):
    """The tied head's f32 logits of ``h`` (``spec``: the einsum), whole:
    on a rank holding the vocabulary as its block over ``model`` its
    block's logits from its block alone (1/m of the f32 copy), gathered
    whole along the vocabulary.  Returns (logits, the rank's block of
    them, the ``model`` axis or None)."""
    block = torch.einsum(spec, h.float(), embed.float())
    ax = split_axis(mesh, embed.shape[0], cfg.vocab_size)
    if ax is None:
        return block, block, None
    return all_gather_tiled(block, ax, block.dim() - 1), block, ax


def _greedy(block, ax):
    """The greedy token (B,) int32 of the (B, V) logits whose rank's block
    is ``block``: on a mesh the paper's Alg. 4 pick over ``model``, each
    rank's largest logit and its first index (with the block's offset),
    gathered, then the first largest, which keeps ``torch.argmax``'s
    first-index rule on ties (the blocks lie in rank order)."""
    local = torch.argmax(block, dim=-1)
    if ax is None:
        return local.to(torch.int32)
    best = torch.gather(block, -1, local[:, None])
    index = (local[:, None] + ax.index * block.shape[-1]).double()
    # one gather of (value, index) pairs, both exact in f64
    pairs = all_gather_tiled(torch.stack([best.double(), index], -1), ax, 1)
    pick = torch.argmax(pairs[..., 0], dim=-1)
    return pairs[..., 1].gather(1, pick[:, None])[:, 0].to(torch.int32)


def _at(tree, r: int):
    return tree_map(lambda a: a[r], tree)


def _remat_unit(seg_params, unit, r, reps, x, cfg, ctx, pos):
    """(x, aux) of one repeat under ``checkpoint``, in the
    ``lm_step.unit`` range: run in the forward, and again in the backward
    (the rematerialization)."""
    with record_function("lm_step.unit"):
        x, _, aux = _unit_apply(seg_params, unit, r, reps, x, cfg, ctx,
                                None, pos)
    return x, aux


def _unit_apply(seg_params, unit, r, reps, x, cfg, ctx, seg_cache, pos):
    """One repeat ``r`` of a segment's unit: (x, [new caches], aux)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    layer_new = []
    for j, sig in enumerate(unit):
        pj = seg_params[j] if reps == 1 else _at(seg_params[j], r)
        cj = None
        if seg_cache is not None:
            cj = seg_cache[j] if reps == 1 else _at(seg_cache[j], r)
        x, nc, a = block_apply(pj, x, cfg=cfg, sig=sig, ctx=ctx, cache=cj,
                               pos=pos)
        aux = aux + a
        layer_new.append(nc)
    return x, layer_new, aux


def _apply_segments(params, cfg, x, ctx: ModelCtx,
                    caches: Optional[list] = None,
                    pos: Optional[torch.Tensor] = None,
                    collect_cache: bool = False):
    """Runs the layer program, a segment's repeats in a loop.

    caches=None, collect_cache=False → forward with no cache I/O.
    caches=None, collect_cache=True  → prefill (fresh caches returned).
    caches=list                      → decode (caches read and updated).
    With ``ctx.remat``, a forward with no caches recomputes each repeat of
    a segment of more than one repeat in the backward (JAX's
    ``jax.checkpoint`` of its scan body, ``nothing_saveable``): only the
    unit's input is kept.
    Returns (x, new_caches | None, aux_sum)."""
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    want_cache = collect_cache or caches is not None
    new_caches = [] if want_cache else None

    for si, (reps, unit) in enumerate(build_program(cfg)):
        seg_params = params["segments"][si]
        seg_cache = caches[si] if caches is not None else None
        remat = (ctx.remat and reps > 1 and not want_cache
                 and torch.is_grad_enabled())
        per_rep = []
        for r in range(reps):
            if remat:
                # the segment's values are arguments: the backward
                # recomputes the repeat after this loop has moved on
                x, aux = checkpoint(_remat_unit, seg_params, unit, r, reps,
                                    x, cfg, ctx, pos, use_reentrant=False)
                layer_new = None
            else:
                x, layer_new, aux = _unit_apply(seg_params, unit, r, reps, x,
                                                cfg, ctx, seg_cache, pos)
            aux_total = aux_total + aux
            per_rep.append(layer_new)
        if want_cache:
            new_caches.append(per_rep[0] if reps == 1 else [
                tree_map(lambda *xs: torch.stack(xs),
                         *(layer[j] for layer in per_rep))
                for j in range(len(unit))])
    return x, new_caches, aux_total


def _final_hidden(params, cfg, x):
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


# ------------------------------------------------------------- loss --------

def _xent_chunk(hc, embed_w, lc, mc, axis):
    """(Σ masked (lse - gold), Σ mask) of one chunk, its logits in f32, in
    the ``lm_step.loss_chunk`` range (again in the backward, with its
    collectives in the same order on every rank).  With ``axis`` (the
    vocabulary split over it, ``embed_w`` the rank's rows) the rank's
    block of the logits alone: the logsumexp from the largest logit over
    the axis (held constant: the function does not depend on it) and the
    exponentials' sum over it, the gold logit the rank's where the label
    lies in its block, else 0, summed over it."""
    with record_function("lm_step.loss_chunk"):
        logits = torch.einsum("btd,vd->btv", hc.float(), embed_w.float())
        if axis is None:
            lse = torch.logsumexp(logits, dim=-1)
            # the gold logit by a gather: the same value as JAX's masked
            # sum over the vocabulary's iota (one term and zeros)
            gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
        else:
            top = all_reduce_max(logits.detach().amax(dim=-1), axis)
            lse = torch.log(reduce_from_axis(torch.sum(
                torch.exp(logits - top[..., None]), dim=-1), axis)) + top
            n = embed_w.shape[0]
            local = lc.long() - axis.index * n
            mine = (local >= 0) & (local < n)
            gold = torch.gather(logits, -1,
                                local.clamp(0, n - 1)[..., None])[..., 0]
            gold = reduce_from_axis(torch.where(mine, gold, 0.0), axis)
        return torch.sum((lse - gold) * mc), torch.sum(mc)


def xent_parts(h, embed_w, labels, mask=None, chunk: int = LOSS_CHUNK,
               axis=None):
    """(Σ masked cross-entropy, Σ mask) over the vocabulary without a full
    (B, T, V) logits buffer.  h (B, T, d) the final hidden; embed_w (V, d)
    the tied output head, or with ``axis`` (``shard.split_axis``) the
    rank's block of its rows, the vocabulary split over that axis; labels
    (B, T).  The sequence is cut as JAX cuts it (``nc = max(T // chunk,
    1)`` chunks of ``T // nc`` tokens; a remainder is left out), and each
    chunk is recomputed in the backward (JAX's ``jax.checkpoint``), so one
    chunk's f32 logits live at a time: on a split vocabulary the rank's
    (B, cs, V/m) block of them, ``h`` entering through f
    (``core.mesh.copy_to_axis``), so its gradient sums the blocks'."""
    b, t, _ = h.shape
    nc = max(t // chunk, 1)
    cs = t // nc
    if mask is None:
        mask = torch.ones((b, t), dtype=F32, device=h.device)
    if axis is not None:
        h = copy_to_axis(h, axis)
    tot = torch.zeros((), dtype=F32, device=h.device)
    cnt = torch.zeros((), dtype=F32, device=h.device)
    for i in range(nc):
        part = slice(i * cs, (i + 1) * cs)
        args = (h[:, part], embed_w, labels[:, part], mask[:, part], axis)
        if torch.is_grad_enabled():
            s, c = checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            s, c = _xent_chunk(*args)
        tot = tot + s
        cnt = cnt + c
    return tot, cnt


def chunked_xent(h, embed_w, labels, mask=None, chunk: int = LOSS_CHUNK,
                 mesh=None, axis=None):
    """The mean cross-entropy of :func:`xent_parts` (``axis``: the
    vocabulary's, where ``embed_w`` is the rank's block); on a mesh the
    global batch's, its sum and count summed over the data axes first
    (JAX's over the global arrays), the same on every rank."""
    tot, cnt = xent_parts(h, embed_w, labels, mask, chunk, axis)
    if mesh is not None:
        both = torch.stack([tot, cnt])
        for name in data_axes_of(mesh):
            both = reduce_from_axis(both, mesh.axis(name))
        tot, cnt = both[0], both[1]
    return tot / torch.clamp(cnt, min=1.0)


def _next_token(tokens, dev):
    """JAX's next-token labels and mask: the inputs shifted left by one,
    the last position padded with 0 and masked out (shifted tensors, no
    scalar assignment, whose ops differ by device)."""
    tokens = torch.as_tensor(tokens, device=dev)
    return _shift_left(tokens), _shift_left(torch.ones(tokens.shape,
                                                       dtype=F32, device=dev))


def _shift_left(a):
    """``jnp.pad(a[:, 1:], ((0, 0), (0, 1)))``."""
    return torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)


def loss_fn(params, cfg, batch, ctx: ModelCtx):
    """(loss, metrics) of one batch, as JAX's ``loss_fn``: the chunked
    cross-entropy of the next token (of ``labels`` where the batch has
    them: hubert's frame labels, llava's text with its patches masked
    out), plus ``mtp_weight`` × the MTP head's loss of the token after
    (``mtp``), plus ``router_aux_weight`` × the MoE layers' load-balance
    loss (``aux``).  metrics: ``xent``, ``aux`` and, with the MTP head,
    ``mtp``.  On a mesh each rank passes its rows of the batch, and the
    loss and metrics are the global batch's (``aux`` data shard 0's, as
    JAX's), the same on every rank."""
    x, labels, mask = _embed_inputs(params, cfg, batch, ctx)
    x = ctx.sharder.act(x, "act_resid_in")
    x, _, aux = _apply_segments(params, cfg, x, ctx)
    h = _final_hidden(params, cfg, x)
    if labels is None:
        labels, mask = _next_token(batch["tokens"], h.device)
    vocab = split_axis(ctx.mesh, params["embed"].shape[0], cfg.vocab_size)
    loss = chunked_xent(h, params["embed"], labels, mask, mesh=ctx.mesh,
                        axis=vocab)
    metrics = {"xent": loss, "aux": aux}
    if cfg.mtp_weight > 0 and not cfg.is_encoder:
        h2 = torch.einsum("btd,de->bte", h, params["mtp_proj"])
        mask2 = mask if mask is not None else torch.ones(
            labels.shape, dtype=F32, device=h.device)
        mtp = chunked_xent(h2, params["embed"], _shift_left(labels),
                           _shift_left(mask2), mesh=ctx.mesh, axis=vocab)
        metrics["mtp"] = mtp
        loss = loss + cfg.mtp_weight * mtp
    if cfg.is_moe:
        loss = loss + cfg.router_aux_weight * aux
    return loss, metrics


def loss_and_grads(params, cfg, batch, ctx: ModelCtx):
    """(loss, metrics, grads): the loss and its gradient with respect to
    every leaf of ``params`` (a tree of the parameters' structure and
    dtypes; a leaf the loss does not reach gets zeros, as in JAX).  On a
    mesh (``params`` placed as :func:`check_layout` holds) each leaf is
    then summed over the data axes, one all-reduce a leaf
    (``core.mesh.all_reduce_grads``), in the ``lm_step.grad_reduce``
    range, and the whole leaves take model rank 0's bits
    (``core.mesh.broadcast_first``, ``lm_step.grad_broadcast``)."""
    check_layout(params, cfg, ctx)
    leaves = tree_leaves(params)
    flags = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            with record_function("lm_step.forward"):
                loss, metrics = loss_fn(params, cfg, batch, ctx)
            with record_function("lm_step.backward"):
                got = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p, f in zip(leaves, flags):
            p.requires_grad_(f)
    got = [torch.zeros_like(p) if g is None else g
           for p, g in zip(leaves, got)]
    if ctx.mesh is not None:
        with record_function("lm_step.grad_reduce"):
            got = all_reduce_grads(got, [ctx.mesh.axis(a) for a in
                                         data_axes_of(ctx.mesh)])
    got = iter(got)
    grads = tree_map(lambda _: next(got), params)
    if ctx.mesh is not None:
        # the model ranks' gradients of a whole leaf are complete, but each
        # comes from its own process's kernels, whose bits can differ (the
        # CPU's GEMMs by the operands' alignment): model rank 0's become
        # every rank's, so the whole leaves stay equal bit for bit
        with record_function("lm_step.grad_broadcast"):
            broadcast_first(_split_blocks(grads, cfg, ctx)[0],
                            ctx.mesh.axis(BLOCK_AXIS))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


# (config, mesh shape, MoE mode) -> (block dims, the rank's leaf shapes)
_LAYOUTS: Dict[tuple, tuple] = {}


def _layout(cfg, ctx: ModelCtx):
    """(the tree of each leaf's block dim or None, ``shard.block_dims`` of
    ``shard.block_leaves(ctx.mesh, ctx.moe_mode)``, and the tree of the
    leaves' shapes as a rank of ``ctx.mesh`` holds them) of ``cfg``'s
    parameters, made once a (config, mesh shape, mode)."""
    mesh = ctx.mesh
    key = (cfg, tuple(mesh.shape.items()), ctx.moe_mode)
    if key not in _LAYOUTS:
        shapes = param_shapes(cfg)
        dims = block_dims(param_specs(shapes, mesh),
                          block_leaves(mesh, ctx.moe_mode))
        m = mesh.shape[BLOCK_AXIS]
        _LAYOUTS[key] = dims, map_with_path(
            lambda _, leaf, dim: tuple(n // m if i == dim else n
                                       for i, n in enumerate(leaf[0])),
            shapes, dims)
    return _LAYOUTS[key]


def _prepare_layout(cfg, ctx: ModelCtx) -> None:
    """Makes the layout of a step's mesh when the step is made: its
    meta-device shapes are then no part of a counted step
    (``roofline.count``), which sees the same ops on every call."""
    if ctx.mesh is not None:
        _layout(cfg, ctx)


def check_layout(params, cfg, ctx: ModelCtx) -> None:
    """On a mesh, raises ``ValueError`` naming the first leaf of
    ``params`` (by its JAX key path) whose shape is not the one a rank
    holds in the layout of ``shard.block_leaves(ctx.mesh, ctx.moe_mode)``:
    a tree in another layout would give a wrong norm and wrong whole-leaf
    broadcasts."""
    if ctx.mesh is None:
        return
    bad = _misplaced(params, _layout(cfg, ctx)[1])
    if bad is not None:
        path, got, want = bad
        raise ValueError(
            f"the leaf {path} is {got} on this rank, {want} in the layout "
            f"of shard.block_leaves(mesh, {ctx.moe_mode!r}) = "
            f"{block_leaves(ctx.mesh, ctx.moe_mode)}: place the parameters "
            f"with Sharder.place_params(..., block_leaves(mesh, moe_mode))")


def _misplaced(tree, want, path=""):
    """(key path, shape, wanted shape) of the first leaf of ``tree`` whose
    shape is not ``want``'s, or None."""
    if isinstance(tree, (dict, list)):
        keys = tree if isinstance(tree, dict) else range(len(tree))
        for k in keys:
            bad = _misplaced(tree[k], want[k], f"{path}[{k!r}]")
            if bad is not None:
                return bad
        return None
    got = tuple(tree.shape)
    return None if got == want else (path, got, want)


def _split_blocks(tree, cfg, ctx: ModelCtx):
    """([whole leaves], [the leaves a rank holds as blocks over ``model``,
    ``shard.block_dims``]) of a tree of the parameters' structure."""
    whole, blocks = [], []
    map_with_path(lambda path, g, dim: (whole if dim is None
                                        else blocks).append(g),
                  tree, _layout(cfg, ctx)[0])
    return whole, blocks


# ------------------------------------------------------------- steps -------

def grad_norm(grads, cfg, ctx: ModelCtx) -> torch.Tensor:
    """The f32 global norm of the gradients: on a mesh whose ranks hold
    blocks (``shard.block_leaves``), the blocks' squares summed over
    ``model`` and the whole leaves' added once, the same on every rank."""
    if not block_leaves(ctx.mesh, ctx.moe_mode):
        return optim.global_norm(grads)
    whole, blocks = _split_blocks(grads, cfg, ctx)
    sq = torch.zeros((1,), dtype=F32, device=whole[0].device)
    for g in blocks:
        sq += torch.sum(torch.square(g.float()))
    sq = all_reduce_sum(sq, ctx.mesh.axis(BLOCK_AXIS))[0]
    for g in whole:
        sq = sq + torch.sum(torch.square(g.float()))
    return optim.sqrt_f32(sq)


def make_train_step(cfg, ctx: ModelCtx, *, lr: float = 3e-4,
                    clip_norm: Optional[float] = 1.0):
    """``train_step(params, opt, batch, *, with_grads=False) -> (params,
    opt, metrics)``: the gradient of ``loss_fn``, clipped to a global norm
    of ``clip_norm`` (scaled in place), then one Adam step of rate ``lr``,
    both in place.  metrics: ``loss_fn``'s, ``loss`` and ``grad_norm`` (0
    without clipping); with ``with_grads`` also ``grads``, the gradients
    Adam took.  On a mesh every rank calls it on its rows of the batch
    and its parameters (its blocks of ``shard.block_leaves``, which
    :func:`check_layout` holds), and the norm is the global one
    (:func:`grad_norm`)."""
    _prepare_layout(cfg, ctx)

    def train_step(params, opt, batch, *, with_grads: bool = False):
        loss, metrics, grads = loss_and_grads(params, cfg, batch, ctx)
        with record_function("lm_step.clip"):
            if clip_norm is not None:
                gnorm = optim.clip_by_global_norm_(
                    grads, clip_norm, grad_norm(grads, cfg, ctx))
            else:
                gnorm = torch.zeros((), dtype=F32, device=loss.device)
        with record_function("lm_step.adam"):
            optim.adam_update(params, grads, opt, lr=lr)
        metrics = dict(metrics, grad_norm=gnorm, loss=loss)
        if with_grads:
            metrics["grads"] = grads
        return params, opt, metrics
    return train_step


def make_eval_step(cfg, ctx: ModelCtx):
    """``eval_step(params, batch) -> metrics``: ``loss_fn``'s metrics
    under ``no_grad``, on a mesh from the rank's blocks
    (:func:`check_layout`)."""
    _prepare_layout(cfg, ctx)

    @torch.no_grad()
    def eval_step(params, batch):
        check_layout(params, cfg, ctx)
        _, metrics = loss_fn(params, cfg, batch, ctx)
        return metrics
    return eval_step


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
            return _head_logits(h, params["embed"], cfg, ctx.mesh,
                                "btd,vd->btv")[0], None
        return _head_logits(h[:, -1], params["embed"], cfg, ctx.mesh,
                            "bd,vd->bv")[0], caches
    return prefill


def make_decode_step(cfg, ctx: ModelCtx):
    @torch.no_grad()
    def decode_step(params, caches, token, pos):
        """token (B, 1) int; pos (B,) int32.  Returns (logits, next_tok,
        caches), next_tok the greedy argmax (B,) int32."""
        if cfg.is_encoder:
            raise ValueError("encoder has no decode step")
        dev = params["embed"].device
        x = _embed_lookup(params["embed"], torch.as_tensor(token, device=dev),
                          cfg, ctx.mesh)
        x = ctx.sharder.act(x, "act_resid_in")
        x, new_caches, _ = _apply_segments(
            params, cfg, x, ctx, caches=caches,
            pos=torch.as_tensor(pos, device=dev))
        h = _final_hidden(params, cfg, x)
        logits, block, ax = _head_logits(h[:, 0], params["embed"], cfg,
                                         ctx.mesh, "bd,vd->bv")
        # the paper's all-gather + argmax (Alg. 4) applied to vocab logits
        return logits, _greedy(block, ax), new_caches
    return decode_step
