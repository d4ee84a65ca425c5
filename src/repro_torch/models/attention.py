"""Attention mixers: GQA (global, sliding-window, bidirectional) and MLA
(DeepSeek-V3 multi-head latent attention, absorbed form).  Counterpart of
``repro/models/attention.py``.

Prefill takes the queries in chunks (exact softmax over the whole key
axis per chunk, f32 logits), so the (T, S) score tensor is never formed
at once.  A sliding-window prefill goes through kernel B7
(``kernels/swa.py::swa_attention``): the hand-written flash kernel on
CUDA tensors, its plain version on CPU tensors.  Causal and bidirectional
prefill and every decode are plain compositions, as JAX computes them
outside Pallas.

Decode takes a KV cache and one query token.  Caches:
  GQA: {"k": (B, S, KV, hd), "v": (B, S, KV, hd), "k_pos": (B, S) int32}
  MLA: {"ckv": (B, S, kv_lora), "krope": (B, S, rope_dim)}

On the LM mesh a GQA layer is tensor-parallel over ``model``
(``models.shard``): a rank holds wq's and wo's blocks of H/m query heads,
and of wk/wv its KV/m kv heads where they split, else the whole
(KV % m != 0, e.g. granite-20b's one kv head), of which it keeps the kv
heads its query heads read (query head j reads kv head j // g).  Its
cache holds those kv heads (:func:`rank_kv_heads`), its window prefill
runs B7 on its (B·H/m, T, hd) operands, and the row-parallel wo's partial
output is summed over ``model`` (Megatron's g,
``core.mesh.reduce_from_axis``).  The replicated input enters the split
heads through Megatron's f (``core.mesh.copy_to_axis``), so its gradient
is the sum of the ranks' partials; so do whole wk/wv, whose rank's
gradient is only its query heads' share.  The head counts come from the
rank's weights; a layer whose query heads do not split (and an MLA
layer) computes whole, with no f: its gradients are complete on every
rank.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.mesh import copy_to_axis, reduce_from_axis
from ..kernels.swa import swa_attention
from .common import apply_rope, dense_init, rms_norm
from .shard import BLOCK_AXIS, NO_SHARD, split_axis

NEG_INF = -1e30
Q_CHUNK = 512


# --------------------------------------------------------------- GQA -------

def init_gqa(gen, cfg, dtype, device):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (d, h * hd), dtype, device).reshape(d, h, hd),
        "wk": dense_init(gen, (d, kv * hd), dtype, device).reshape(d, kv, hd),
        "wv": dense_init(gen, (d, kv * hd), dtype, device).reshape(d, kv, hd),
        "wo": dense_init(gen, (h * hd, d), dtype, device).reshape(h, hd, d),
    }


def _mask(q_pos, k_pos, kind: str, window: int):
    """(..., Tq, Tk) boolean attend-mask."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    if kind == "bidir":
        return torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                          dtype=torch.bool, device=q_pos.device)
    m = dk <= dq
    if kind == "window":
        m = m & (dk > dq - window)
    return m


def _sdpa_chunked(q, k, v, q_pos, k_pos, kind, window, scale,
                  q_chunk: int = Q_CHUNK):
    """q (B,T,KV,G,hd); k/v (B,S,KV,hd) → (B,T,KV,G,hd), over query chunks
    with an exact softmax over the whole key axis."""
    b, t, kvh, g, hd = q.shape
    nq = max(t // q_chunk, 1)
    cq = t // nq
    k32, v32 = k.float(), v.float()
    chunks = []
    for i in range(nq):
        qc = q[:, i * cq:(i + 1) * cq]
        pc = q_pos[i * cq:(i + 1) * cq]
        logits = torch.einsum("btkgh,bskh->bkgts", qc.float(), k32) * scale
        m = _mask(pc, k_pos, kind, window)                  # (cq, S)
        logits = torch.where(m, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        chunks.append(torch.einsum("bkgts,bskh->btkgh", p, v32).to(q.dtype))
    return torch.cat(chunks, dim=1).reshape(b, t, kvh, g, hd)


def _swa_prefill(q, k, v, window, scale):
    """The window prefill through B7: q (B,T,KV,G,hd), k/v (B,T,KV,hd) →
    (B,T,KV,G,hd).  k and v are expanded over each kv head's g query
    heads, in the head order of ``reshape(b, t, kvh, g, hd)``, and every
    operand is laid out (B·H, T, hd) for the kernel."""
    b, t, kvh, g, hd = q.shape

    def heads(a):                                 # (B,T,KV,G,hd) → (BH,T,hd)
        return a.permute(0, 2, 3, 1, 4).reshape(b * kvh * g, t, hd)
    kx = k[:, :, :, None, :].expand(b, t, kvh, g, hd)
    vx = v[:, :, :, None, :].expand(b, t, kvh, g, hd)
    out = swa_attention(heads(q).contiguous(), heads(kx).contiguous(),
                        heads(vx).contiguous(), window=window, scale=scale)
    return out.reshape(b, kvh, g, t, hd).permute(0, 3, 1, 2, 4).to(q.dtype)


def rank_kv_heads(cfg, h_loc: int, index: int
                  ) -> Tuple[int, int, Optional[list]]:
    """(first, count, read) of the kv heads a rank's ``h_loc`` query
    heads, block ``index`` of the layer's H, read (query head j reads kv
    head j // g, g = H / KV): the heads [first, first + count), and
    ``read``, each local query head's local kv head, None where they form
    whole groups (local query head i reads i // (h_loc / count))."""
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    g = h // kvh
    a = index * h_loc
    first, last = a // g, (a + h_loc - 1) // g
    count = last - first + 1
    read = [(a + i) // g - first for i in range(h_loc)]
    if h_loc % count == 0 and read == [i // (h_loc // count)
                                       for i in range(h_loc)]:
        read = None
    return first, count, read


def cache_kv_heads(cfg, mesh=None) -> int:
    """The kv heads a GQA layer's decode cache holds on a rank of
    ``mesh`` whose attention is tensor-parallel (``shard.block_leaves``):
    its block's where the query heads split over ``model``
    (JAX's ``param_specs`` rule, H % m == 0), else all KV."""
    m = 1 if mesh is None else mesh.shape[BLOCK_AXIS]
    if m == 1 or cfg.n_heads % m:
        return cfg.n_kv_heads
    index = mesh.axis(BLOCK_AXIS).index
    return rank_kv_heads(cfg, cfg.n_heads // m, index)[1]


def _read_heads(a, read):
    """(B, S, count, hd) kv heads → (B, S, h_loc, hd), each local query
    head's own (``rank_kv_heads``' ``read``)."""
    return a.index_select(2, torch.tensor(read, device=a.device))


def gqa_apply(p, x, *, cfg, kind: str = "causal",
              cache: Optional[dict] = None,
              pos: Optional[torch.Tensor] = None,
              sharder=NO_SHARD, q_chunk: int = Q_CHUNK, mesh=None):
    """x (B, T, d).  Prefill when cache is None; else a one-token decode
    at position ``pos`` (B,) int32.  Returns (out, new_cache).  On a
    ``mesh`` whose rank holds wq's block of the heads (``shard``), the
    rank's heads: ``x`` enters through f, the output is summed over
    ``model``."""
    b, t, d = x.shape
    h, hd = p["wq"].shape[-2], cfg.head_dim
    ax = split_axis(mesh, h, cfg.n_heads)
    wk, wv = p["wk"], p["wv"]
    kvh, read = wk.shape[-2], None
    if ax is not None:
        x = copy_to_axis(x, ax)
        first, kvh, read = rank_kv_heads(cfg, h, ax.index)
        if wk.shape[-2] == cfg.n_kv_heads:
            # wk/wv whole (KV % m != 0): the kv heads this rank's query
            # heads read; a rank's gradient of them is its heads' share,
            # summed by f
            wk, wv = (copy_to_axis(w, ax).narrow(-2, first, kvh)
                      for w in (wk, wv))
    window = cfg.sliding_window
    scale = hd ** -0.5

    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, wk)
    v = torch.einsum("btd,dhk->bthk", x, wv)
    q = sharder.act(q, "act_qkv")
    k = sharder.act(k, "act_kv")
    v = sharder.act(v, "act_kv")

    def grouped(k, v):
        """k, v as the (B, S, KV', hd) operands of q's (KV', G) groups."""
        if read is None:
            return k, v, kvh, h // kvh
        return _read_heads(k, read), _read_heads(v, read), h, 1

    if cache is None:
        positions = torch.arange(t, device=x.device)
        q = apply_rope(q, positions[None, :], cfg.rope_theta)
        k = apply_rope(k, positions[None, :], cfg.rope_theta)
        kg, vg, kvg, g = grouped(k, v)
        qg = q.reshape(b, t, kvg, g, hd)
        if kind == "window":
            out = _swa_prefill(qg, kg, vg, window, scale)
        else:
            out = _sdpa_chunked(qg, kg, vg, positions, positions, kind,
                                window, scale, q_chunk=q_chunk)
        new_cache = {"k": k, "v": v,
                     "k_pos": positions[None].expand(b, t).to(torch.int32)}
    else:
        # decode: t == 1; the cache ring-buffers S slots (S == window for
        # sliding-window layers), slot = pos % S, with each slot's absolute
        # position in cache["k_pos"] for masking
        s = cache["k"].shape[1]
        slot = pos % s
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
        ck = _scatter_time(cache["k"], k, slot)
        cv = _scatter_time(cache["v"], v, slot)
        cpos = _scatter_time(cache["k_pos"], pos[:, None], slot)
        ck = sharder.act(ck, "cache_kv")
        cv = sharder.act(cv, "cache_kv")
        kg, vg, kvg, g = grouped(ck, cv)
        logits = torch.einsum("btkgh,bskh->bkgts",
                              q.reshape(b, 1, kvg, g, hd).float(),
                              kg.float()) * scale
        valid = (cpos >= 0) & (cpos <= pos[:, None])         # (B, S)
        if kind == "window":
            valid = valid & (cpos > (pos[:, None] - window))
        logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
        pattn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgts,bskh->btkgh", pattn, vg.float())
        out = out.to(x.dtype)
        new_cache = {"k": ck, "v": cv, "k_pos": cpos}

    out = out.reshape(b, t, h, hd)
    y = torch.einsum("bthk,hkd->btd", out, p["wo"])
    if ax is not None:
        y = reduce_from_axis(y, ax)
    return sharder.act(y, "act_resid"), new_cache


def _scatter_time(cache, new, slot):
    """cache (B,S,...) with new (B,1,...) written at each row's slot (B,)."""
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device), slot] = \
        new[:, 0].to(cache.dtype)
    return out


# --------------------------------------------------------------- MLA -------

def init_mla(gen, cfg, dtype, device):
    d, h = cfg.d_model, cfg.n_heads
    ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wdq": dense_init(gen, (d, ql), dtype, device),
        "q_norm": torch.zeros((ql,), dtype=dtype, device=device),
        "wuq": dense_init(gen, (ql, h * (dn + dr)), dtype, device
                          ).reshape(ql, h, dn + dr),
        "wdkv": dense_init(gen, (d, kvl + dr), dtype, device),
        "kv_norm": torch.zeros((kvl,), dtype=dtype, device=device),
        "wuk": dense_init(gen, (kvl, h * dn), dtype, device
                          ).reshape(kvl, h, dn),
        "wuv": dense_init(gen, (kvl, h * dv), dtype, device
                          ).reshape(kvl, h, dv),
        "wo": dense_init(gen, (h * dv, d), dtype, device).reshape(h, dv, d),
    }


def _mla_attend(q_lat, q_rope, ckv, krope_r, q_pos, k_pos, scale):
    """q_lat (B,Tq,H,kvl), q_rope (B,Tq,H,dr), ckv (B,S,kvl), krope_r
    (B,S,dr); q_pos (B,Tq) or (Tq,); k_pos (S,).  Returns o_lat
    (B,Tq,H,kvl) f32."""
    logits = (torch.einsum("bthr,bsr->bhts", q_lat.float(), ckv.float())
              + torch.einsum("bthk,bsk->bhts", q_rope.float(),
                             krope_r.float())) * scale
    if q_pos.dim() == 1:
        valid = (k_pos[None, :] <= q_pos[:, None])[None, None]  # (1,1,Tq,S)
    else:
        valid = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    logits = torch.where(valid, logits, NEG_INF)
    pattn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bsr->bthr", pattn, ckv.float())


def mla_apply(p, x, *, cfg, kind: str = "causal",
              cache: Optional[dict] = None,
              pos: Optional[torch.Tensor] = None,
              sharder=NO_SHARD, q_chunk: int = Q_CHUNK):
    """DeepSeek-V3 MLA, absorbed form: attention runs in the kv_lora latent
    space, and the cache holds only (c_kv, k_rope).  Prefill goes over
    query chunks."""
    b, t, d = x.shape
    h = cfg.n_heads
    kvl, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim
    scale = (dn + dr) ** -0.5

    cq = rms_norm(torch.einsum("btd,dr->btr", x, p["wdq"]), p["q_norm"],
                  cfg.norm_eps)
    q = torch.einsum("btr,rhk->bthk", cq, p["wuq"])          # (B,T,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    dkv = torch.einsum("btd,dr->btr", x, p["wdkv"])          # (B,T,kvl+dr)
    ckv_new = rms_norm(dkv[..., :kvl], p["kv_norm"], cfg.norm_eps)
    krope_new = dkv[..., kvl:]                               # (B,T,dr)

    # absorb W_uk into the query: q_lat (B,T,H,kvl)
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope, p["wuk"])
    q_lat = sharder.act(q_lat, "act_qkv")

    if cache is None:
        ckv, krope = ckv_new, krope_new
        k_pos = torch.arange(t, device=x.device)
        q_rope = apply_rope(q_rope, k_pos[None, :], cfg.rope_theta)
        krope_r = apply_rope(krope[:, :, None, :], k_pos[None, :],
                             cfg.rope_theta)[:, :, 0]
        nq = max(t // q_chunk, 1)
        cqn = t // nq
        o_lat = torch.cat([
            _mla_attend(q_lat[:, i * cqn:(i + 1) * cqn],
                        q_rope[:, i * cqn:(i + 1) * cqn], ckv, krope_r,
                        k_pos[i * cqn:(i + 1) * cqn], k_pos, scale)
            for i in range(nq)], dim=1).reshape(b, t, h, kvl)
    else:
        ckv = _scatter_time(cache["ckv"], ckv_new, pos)
        krope = _scatter_time(cache["krope"], krope_new, pos)
        ckv = sharder.act(ckv, "cache_mla")
        k_pos = torch.arange(ckv.shape[1], device=x.device)
        q_rope = apply_rope(q_rope, pos[:, None], cfg.rope_theta)
        krope_r = apply_rope(krope[:, :, None, :], k_pos[None, :],
                             cfg.rope_theta)[:, :, 0]
        o_lat = _mla_attend(q_lat, q_rope, ckv, krope_r, pos[:, None], k_pos,
                            scale)

    out = torch.einsum("bthr,rhv->bthv", o_lat.to(x.dtype), p["wuv"])
    y = torch.einsum("bthv,hvd->btd", out, p["wo"])
    return sharder.act(y, "act_resid"), {"ckv": ckv, "krope": krope}
