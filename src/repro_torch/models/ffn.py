"""Feed-forward blocks: dense MLP/GLU, RWKV channel mix, and
Mixture-of-Experts.  Counterpart of ``repro/models/ffn.py``.

The MoE layer runs in one of three modes (JAX's):

- ``dense``     — every expert computed for every token, combined by the
                  router's sparse weights (``moe_dense_apply``): the
                  one-device layer and the correctness oracle.
- ``allreduce`` — the paper's spatial style: the tokens are replicated
                  over the ``model`` axis, the experts split over it; each
                  rank computes its experts' capacity buffers and a sum
                  over ``model`` combines the partial token outputs.
- ``alltoall``  — expert parallelism: the tokens are also split over
                  ``model`` for dispatch, and two all-to-alls move only the
                  routed tokens (``alltoall_rep``: the flat token list
                  split, where ``alltoall`` splits each sequence).

Every mode's expert GLU goes through kernel B8
(``kernels/moe_gemm.py::grouped_glu_ffn``): on one device on the (E, T·B,
d) broadcast of the tokens, on a mesh on each rank's (E_loc, C, d)
capacity buffer; the hand-written kernels on CUDA tensors, the plain
version on CPU tensors.  JAX runs the expert-parallel modes inside
``shard_map``; the port writes them as rank code over the LM mesh's
``model`` and data axes (``moe_sharded_apply``), differentiable by
``shard_map``'s transpose: the tokens and the router enter the split work
through ``copy_to_axis`` (their gradients summed over ``model``), the
partial outputs leave through ``reduce_from_axis``, the exchanges pass
their gradients back, and the aux loss keeps JAX's value and gradient
(``_AuxOfMesh``).

On the LM mesh the MLP and the MoE shared experts are tensor-parallel
over ``model`` (``models.shard``): a rank holds wu's and wg's d_ff columns
and wo's d_ff rows, the replicated input enters through Megatron's f
(``copy_to_axis``) and the partial output is summed over ``model``
(``mlp_apply(axis=)``); in ``allreduce`` mode the shared experts' partial
reads the layer's one f'd input and joins the routed experts' partial in
its one all-reduce, in ``alltoall`` mode and the dense layer it takes its
own f and all-reduce.  RWKV's channel mix computes whole.

The expert count is padded to a multiple of 16 so expert weights shard on
any production mesh (the padded experts are unroutable).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.mesh import (all_gather_tiled, all_reduce_sum, all_to_all,
                         copy_to_axis, reduce_from_axis)
from ..kernels.moe_gemm import grouped_glu_ffn
from .common import F32, dense_init
from ..sharding.rules import data_axes_of
from .shard import NO_SHARD, split_axis

EXPERT_PAD = 16


def padded_experts(n: int) -> int:
    return -(-n // EXPERT_PAD) * EXPERT_PAD


# ------------------------------------------------------------- dense -------

def init_mlp(gen, d: int, d_ff: int, dtype, device, gated: bool):
    p = {"wu": dense_init(gen, (d, d_ff), dtype, device),
         "wo": dense_init(gen, (d_ff, d), dtype, device)}
    if gated:
        p["wg"] = dense_init(gen, (d, d_ff), dtype, device)
    return p


def mlp_apply(p, x, *, gated: bool, sharder=NO_SHARD, axis=None):
    """The MLP (gated: GLU) on x (B, T, d).  With ``axis`` (the ``model``
    axis of a rank holding the d_ff blocks, ``shard.split_axis``) the
    rank's columns: x enters through f, the partial output is summed
    over the axis."""
    if axis is not None:
        x = copy_to_axis(x, axis)
    y = mlp_partial(p, x, gated=gated, sharder=sharder)
    if axis is not None:
        y = reduce_from_axis(y, axis)
    return sharder.act(y, "act_resid")


def mlp_partial(p, x, *, gated: bool, sharder=NO_SHARD):
    """The MLP's output from the d_ff columns ``p`` holds: the whole
    output, or on a rank holding d_ff blocks its partial sum."""
    up = torch.einsum("btd,df->btf", x, p["wu"])
    if gated:
        gate = torch.einsum("btd,df->btf", x, p["wg"])
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")    # jax.nn.gelu's default
    h = sharder.act(h, "act_ffn")
    return torch.einsum("btf,fd->btd", h, p["wo"])


def shared_axis(p, cfg, mesh):
    """The ``model`` axis where a rank holds the MoE shared experts' d_ff
    blocks, else None."""
    ffe = cfg.d_ff_expert or cfg.d_ff
    return split_axis(mesh, p["shared"]["wu"].shape[-1],
                      ffe * cfg.n_shared_experts)


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


def _route(router_w, x_flat, k: int, batch_axes=()):
    """Returns (ids (T,k), weights (T,k) renormalized, aux_loss scalar).
    ``batch_axes`` are the mesh axes the batch's rows are split over where
    the layer is JAX's global one (the dense layer on a mesh): the
    load-balance means are then the global batch's, their blocks' means
    averaged over those axes."""
    logits = torch.einsum("td,de->te", x_flat.float(), router_w)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux (Switch-style): E * Σ_e f_e · P_e
    e = router_w.shape[1]
    # the one-hot by a comparison: F.one_hot reads the ids' min back to
    # the host on the CPU and takes other ops on each device
    experts = torch.arange(e, device=ids.device)
    f = (ids[:, :, None] == experts).to(F32).sum(1).mean(0)
    pm = probs.mean(0)
    for ax in batch_axes:
        f = reduce_from_axis(f, ax) / ax.size
        pm = reduce_from_axis(pm, ax) / ax.size
    aux = e * torch.sum(f * pm)
    return ids, w.to(x_flat.dtype), aux


def moe_dense_apply(p, x, *, cfg, sharder=NO_SHARD, mesh=None):
    """Every expert for every token, combined by the router's weights; the
    experts' GLU through B8.  On a ``mesh`` (``x`` the rank's rows) the
    aux loss is the global batch's, as JAX's layer over global arrays
    computes it."""
    b, t, d = x.shape
    e = cfg.n_experts
    if p["ewg"].shape[0] < e:
        raise ValueError(f"the dense MoE layer needs all {e} experts on "
                         f"the rank, which holds {p['ewg'].shape[0]}: a "
                         f"rank's expert block takes moe_sharded_apply")
    xf = x.reshape(b * t, d)
    axes = () if mesh is None else [mesh.axis(a)
                                    for a in data_axes_of(mesh)]
    ids, w, aux = _route(p["router"], xf, cfg.experts_per_token, axes)
    gates = torch.zeros((b * t, e), dtype=x.dtype, device=x.device)
    gates.scatter_add_(1, ids, w)
    xe = xf[None].expand(e, b * t, d).contiguous()
    yo = grouped_glu_ffn(xe, p["ewg"][:e], p["ewu"][:e],
                         p["ewo"][:e]).to(x.dtype)
    y = torch.einsum("te,etd->td", gates, yo)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, gated=True, sharder=sharder,
                          axis=shared_axis(p, cfg, mesh)).reshape(b * t, d)
    return y.reshape(b, t, d), aux




def _gather_capacity(w_te, c: int):
    """w_te (T, E_loc) combine weights (0 where unrouted).  Per expert, the
    top-C tokens.  Returns (idx (E_loc, C) token ids, wsel (E_loc, C)).
    Among tokens of weight 0 the pick may differ from ``lax.top_k``'s;
    their rows are multiplied by 0."""
    wsel, idx = torch.topk(w_te.T.float(), c, dim=-1)
    return idx, wsel.to(w_te.dtype)


def _combine_weights(ids, w, e_first: int, e_local: int):
    """(T, E_loc) weights of experts [e_first, e_first + e_local) from the
    router's (T, k) picks: at most one pick per expert, so the sum is
    exact."""
    experts = e_first + torch.arange(e_local, device=ids.device)
    le = ids[:, :, None] - experts[None, None, :]
    return torch.sum(torch.where(le == 0, w[:, :, None],
                                 torch.zeros((), dtype=w.dtype,
                                             device=w.device)), dim=1)


def _scatter_rows(t: int, idx, yb):
    """(t, d) sum of the buffer rows ``yb`` (E·C, d) into their tokens."""
    out = torch.zeros((t, yb.shape[-1]), dtype=yb.dtype, device=yb.device)
    return out.index_add_(0, idx.reshape(-1), yb.reshape(-1, yb.shape[-1]))


def _moe_local(p, xf, cfg, e_first: int, e_local: int, capacity: int):
    """The rank's experts [e_first, e_first + e_local) on the tokens it
    sees, xf (T, d), through B8 on their (E_loc, C, d) capacity buffer.
    Returns the partial output (T, d) and the aux loss."""
    t, d = xf.shape
    ids, w, aux = _route(p["router"], xf, cfg.experts_per_token)
    idx, wsel = _gather_capacity(_combine_weights(ids, w, e_first, e_local),
                                 capacity)
    xb = xf[idx.reshape(-1)].reshape(e_local, capacity, d)
    yb = grouped_glu_ffn(xb, p["ewg"], p["ewu"], p["ewo"]).to(xf.dtype)
    return _scatter_rows(t, idx, yb * wsel[..., None]), aux


def _capacity(tokens: int, cfg, ep: int, capacity_factor: float) -> int:
    return min(max(int(tokens * cfg.experts_per_token / ep *
                       capacity_factor), 1), tokens)


def _pmean(v: torch.Tensor, axis) -> torch.Tensor:
    """``lax.pmean`` of a scalar over ``axis``."""
    return all_reduce_sum(v.reshape(1).clone(), axis)[0] / axis.size


def _shard0(v: torch.Tensor, mesh, data_axes) -> torch.Tensor:
    """Data shard 0's value of a scalar on every rank: JAX's ``aux`` leaves
    ``shard_map`` with ``out_specs=P()`` unchecked, so the global value is
    the first device's, whose data index is 0 on every data axis."""
    for name in data_axes:
        ax = mesh.axis(name)
        if ax.size > 1:
            v = all_reduce_sum((v * (ax.index == 0)).reshape(1), ax)[0]
    return v


class _AuxOfMesh(torch.autograd.Function):
    """JAX's aux on the mesh: the value is data shard 0's mean over
    ``model`` (``_pmean`` then ``_shard0``); the gradient hands each
    rank's own aux c/n, n the devices of the layer's axes, and moves
    nothing.  ``shard_map``'s transpose divides the P() output's
    cotangent by the axes it leaves out and ``pmean``'s psum transposes
    to a psum, so JAX's router gradient is the mean over the devices of
    their aux gradients, while its value is one shard's."""

    @staticmethod
    def forward(ctx, aux, mesh, model, data_axes):
        ctx.n = model.size * math.prod(mesh.axis(a).size for a in data_axes)
        return _shard0(_pmean(aux.detach(), model), mesh, data_axes)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None, None, None


def moe_sharded_apply(p, x, *, cfg, mesh, mode: str = "allreduce",
                      capacity_factor: float = 1.25, sharder=NO_SHARD,
                      data_axes=("data",), model_axis="model"):
    """The expert-parallel MoE layer as one rank's code (JAX's
    ``shard_map`` body, see the module docstring).

    ``x`` (B_loc, T, d) is the rank's rows: the batch's block of its data
    rank when the batch splits over the data axes, the whole batch on
    every rank when it does not (a decode of one sequence), as JAX's
    ``bspec``.  ``p`` holds the router whole, the shared experts as the
    rank's d_ff blocks (or whole, placed by the default ``place_params``
    kinds or where d_ff does not split) and the rank's
    block of the experts, (E_p/m, d, f) on a ``model`` axis of size m
    (``Sharder.place_params``).  Returns the rank's (B_loc, T, d)
    rows and the aux loss, which is JAX's value: the mean over ``model``
    of data shard 0's, on every rank (at dp > 1 not the global batch's).

    The capacity is JAX's: per expert ``int(tokens·k/E_p·factor)`` of the
    tokens a rank routes (its B_loc·T in allreduce mode; in alltoall mode
    its T/m of each sequence, or its 1/m of the flat tokens with
    ``alltoall_rep`` or where T does not split), so a result depends on
    the mesh's shape unless nothing drops.

    The gradient is JAX's for a loss replicated on every rank: the rank's
    gradient of ``x``, the router and a whole shared expert is whole, and
    of its expert blocks (and shared d_ff blocks) its data rank's share,
    which the train step sums over the data axes
    (``lm.loss_and_grads``).  The aux loss passes c/n
    of its cotangent c to each of the n ranks' own aux (``_AuxOfMesh``)."""
    if mode not in ("allreduce", "alltoall", "alltoall_rep"):
        raise ValueError(f"unknown MoE mode {mode!r}")
    ep = padded_experts(cfg.n_experts)
    model = mesh.axis(model_axis)
    m, my = model.size, model.index
    if ep % m:
        raise ValueError(f"{ep} experts do not split over the {model_axis} "
                         f"axis of size {m}")
    e_local = ep // m
    if p["ewg"].shape[0] != e_local:
        raise ValueError(f"the rank holds {p['ewg'].shape[0]} experts, its "
                         f"block of {ep} over {model_axis} is {e_local}: "
                         f"place them with Sharder.place_params")
    b_loc, t, d = x.shape
    seq_sharded = mode == "alltoall" and t % m == 0 and t >= m
    mode = "alltoall" if mode == "alltoall_rep" else mode
    # the shared experts: the rank's d_ff blocks, whose partial is summed
    # over ``model`` (whole where JAX's plan keeps d_ff whole)
    sh_ax = shared_axis(p, cfg, mesh) if "shared" in p else None
    joined = mode == "allreduce" and sh_ax is not None
    xs = copy_to_axis(x, model)
    local = dict(p, router=copy_to_axis(p["router"], model))
    xf = xs.reshape(-1, d)
    if mode == "allreduce":
        cap = _capacity(b_loc * t, cfg, ep, capacity_factor)
        out, aux = _moe_local(local, xf, cfg, my * e_local, e_local, cap)
        if joined:
            # the shared partial joins the routed one: one all-reduce
            out = out + mlp_partial(p["shared"], xs, gated=True,
                                    sharder=sharder).reshape(-1, d)
        out = reduce_from_axis(out, model)
    else:
        if seq_sharded:
            tcs = t // m
            xc = xs[:, my * tcs:(my + 1) * tcs].reshape(-1, d)
        else:
            if xf.shape[0] % m or xf.shape[0] < m:
                raise ValueError(f"{xf.shape[0]} tokens do not split over "
                                 f"the {model_axis} axis of size {m}")
            tc0 = xf.shape[0] // m
            xc = xf[my * tc0:(my + 1) * tc0]
        tc = xc.shape[0]
        ids, w, aux = _route(local["router"], xc, cfg.experts_per_token)
        cap = _capacity(tc, cfg, ep, capacity_factor)
        # a capacity buffer for every (global) expert from the local chunk
        idx, wsel = _gather_capacity(_combine_weights(ids, w, 0, ep), cap)
        xb = xc[idx.reshape(-1)].reshape(m, e_local, cap, d)
        # rank j receives every peer's buffers of ITS experts
        xb = all_to_all(xb, model)
        xb = xb.transpose(0, 1).reshape(e_local, m * cap, d).contiguous()
        yb = grouped_glu_ffn(xb, p["ewg"], p["ewu"], p["ewo"]).to(x.dtype)
        yb = yb.reshape(e_local, m, cap, d).transpose(0, 1).contiguous()
        yb = all_to_all(yb, model)                 # back to the source rank
        outc = _scatter_rows(tc, idx, yb.reshape(ep, cap, d)
                             * wsel[..., None])
        if seq_sharded:
            out = all_gather_tiled(outc.reshape(b_loc, t // m, d), model, 1)
        else:
            out = all_gather_tiled(outc, model, 0)
    aux = _AuxOfMesh.apply(aux, mesh, model, tuple(data_axes))
    y = out.reshape(b_loc, t, d)
    if "shared" in p and not joined:
        y = y + mlp_apply(p["shared"], x, gated=True, sharder=sharder,
                          axis=sh_ax)
    return sharder.act(y, "act_resid"), aux


def moe_apply(p, x, *, cfg, mesh=None, mode: str = "dense",
              sharder=NO_SHARD):
    """JAX's dispatch: the dense layer with mode ``dense`` or no mesh,
    else the expert-parallel layer with the mesh's non-``model`` axes as
    its data axes."""
    if mode == "dense" or mesh is None:
        return moe_dense_apply(p, x, cfg=cfg, sharder=sharder, mesh=mesh)
    return moe_sharded_apply(p, x, cfg=cfg, mesh=mesh, mode=mode,
                             sharder=sharder, data_axes=data_axes_of(mesh))
