"""Sharding rule tables: parameter specs, activation constraints, batch
and cache specs per (arch × shape × mesh).  Counterpart of
``repro/sharding/rules.py``, as the shape arithmetic it is.

Baseline layout: tensor parallelism over ``model`` (heads / d_ff /
experts / vocab), batch over ``data`` (and ``pod``), params replicated over
data.  Options:

- ``zero3=True``: layer params additionally sharded over ``data`` on their
  largest replicated dim (ZeRO-3 / FSDP style).
- decode shapes shard the KV cache/state *spatially* (sequence or state dim
  over ``model``): the paper's spatial parallelism applied to serving.

A spec is a :class:`P`, a tuple with one entry per leading dim of the
leaf: None (replicated), an axis name, or a tuple of axis names (the dim
split over them together, the first the major one).  It equals JAX's
``PartitionSpec`` of the same rule as a tuple.  The trees are the port's
(nested dicts and lists, as ``models.param_shapes`` and
``models.cache_shapes`` build them) with JAX's path names: a dict key by
its name, a list entry by None (JAX's ``SequenceKey`` has no name).  A
leaf is a tensor or a ``(shape, dtype)`` pair (``TensorSpec`` included).
The mesh is anything with ``axis_names`` and a ``shape`` mapping, as in
JAX.

The port has no GSPMD path: these specs place the blocks its rank code
computes on (``models.shard.Sharder``) and give the per-device bytes of
JAX's plan (``models.shard.plan_bytes``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch


class P(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: ``P("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def data_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def _divisible(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def leaf_shape(leaf) -> Tuple[Tuple[int, ...], int]:
    """(shape, bytes per element) of a tensor or a ``(shape, dtype)``
    leaf."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.element_size()
    shape, dtype = leaf
    return tuple(shape), dtype.itemsize


def map_with_path(fn: Callable, *trees, path: Tuple = ()):
    """``fn(path, *leaves)`` over trees of one structure of nested dicts
    and lists (JAX's ``tree_map_with_path``; ``path`` the names from the
    root, None for a list entry; a tuple, such as a spec, is a leaf).
    None stays None."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: map_with_path(fn, *(t[k] for t in trees), path=path + (k,))
                for k in first}
    if isinstance(first, list):
        return [map_with_path(fn, *parts, path=path + (None,))
                for parts in zip(*trees)]
    if first is None:
        return None
    return fn(path, *trees)


# Per-leaf rules: name -> (dims-from-the-right, axis proposal per dim).
# "M" = model axis, "D" = data axes (zero3), None = replicated.
_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "embed": ("M", "D"),
    "frontend_proj": (None, "M"),
    # attention
    "wq": ("D", "M", None),
    "wk": ("D", "M", None),
    "wv": ("D", "M", None),
    "wo": ("M", None, "D"),
    # mla: the down-projections replicate their small output dim
    "wdq": ("D", None),
    "wuq": ("D", "M", None),
    "wdkv": ("D", None),
    "wuk": (None, "M", "D"),
    "wuv": (None, "M", "D"),
    # mlp (wu/wg (d, f); mlp wo is (f, d))
    "wu": ("D", "M"),
    "wg": ("D", "M"),
    # moe experts (E, d, f) / (E, f, d)
    "router": (None, None),
    "ewg": ("M", "D", None),
    "ewu": ("M", "D", None),
    "ewo": ("M", None, "D"),
    # rwkv
    "wr": ("D", "M"),
    "mix_w1": (None, None),
    "mix_w2": (None, None, None),
    "td_w1": (None, None),
    "td_w2": (None, None),
    # mamba
    "in_proj": ("D", "M"),
    "conv_w": (None, "M"),
    "conv_b": ("M",),
    "x_proj": ("M", "D"),
    "dt_proj": ("D", "M"),
    "A_log": ("M", None),
    "D": ("M",),
    "out_proj": ("M", "D"),
}

# mlp wo (f, d) vs attention wo (h, hd, d) disambiguated by the ffn subtree
_MLP_WO = ("M", "D")


def _leaf_rule(names) -> Tuple[Optional[str], ...]:
    last = names[-1]
    in_ffn = "ffn" in names or "shared" in names
    if last == "wo":
        return _MLP_WO if in_ffn else _PARAM_RULES["wo"]
    if last in _PARAM_RULES:
        return _PARAM_RULES[last]
    return ()  # replicate (norms, biases, scalars)


def param_specs(params_shape, mesh, *, zero3: bool = False,
                layout: str = "tp"):
    """The spec tree of a parameter tree (shapes or tensors).

    layout="tp"   — tensor parallelism over `model` (+ optional ZeRO-3).
    layout="fsdp" — pure fully-sharded data parallelism: every leaf sharded
                    over ALL mesh axes on its largest divisible dim; no
                    tensor parallelism.
    """
    msize = mesh.shape["model"]
    daxes = data_axes_of(mesh)
    dsize = math.prod(mesh.shape[a] for a in daxes)

    if layout == "fsdp":
        all_axes = tuple(mesh.axis_names)
        asize = math.prod(mesh.shape[a] for a in all_axes)

        def spec_fsdp(path, leaf):
            shape, _ = leaf_shape(leaf)
            ndim = len(shape)
            if path and path[-1] == "embed" and _divisible(shape[0], msize):
                # the vocab stays TP-sharded over `model` only
                return P("model", None)
            axes = [None] * ndim
            order = sorted(range(ndim), key=lambda d: -shape[d])
            for d in order:
                if _divisible(shape[d], asize):
                    axes[d] = all_axes
                    return P(*axes)
            # fall back: split axis groups over two dims
            for d in order:
                if _divisible(shape[d], msize):
                    axes[d] = "model"
                    for d2 in order:
                        if d2 != d and _divisible(shape[d2], dsize):
                            axes[d2] = daxes if len(daxes) > 1 else daxes[0]
                            break
                    return P(*axes)
            for d in order:
                if _divisible(shape[d], dsize):
                    axes[d] = daxes if len(daxes) > 1 else daxes[0]
                    return P(*axes)
            return P(*axes)

        return map_with_path(spec_fsdp, params_shape)

    def spec_of(path, leaf):
        shape, itemsize = leaf_shape(leaf)
        rule = _leaf_rule(path)
        rank = len(shape)
        axes = [None] * rank
        # the rule applies to the trailing len(rule) dims
        off = rank - len(rule)
        for i, r in enumerate(rule):
            dim = off + i
            size = shape[dim]
            if r == "M" and _divisible(size, msize):
                axes[dim] = "model"
            elif r == "D" and zero3 and _divisible(size, dsize):
                axes[dim] = daxes if len(daxes) > 1 else daxes[0]
        if all(a is None for a in axes) and \
                math.prod(shape) * itemsize > 2 ** 21:
            # a big leaf whose tensor-parallel dim is unshardable: shard it
            # over DATA instead (FSDP style)
            dspec = daxes if len(daxes) > 1 else daxes[0]
            cands = [d for d in range(rank)
                     if axes[d] is None and _divisible(shape[d], dsize)]
            if cands:
                axes[max(cands, key=lambda d: shape[d])] = dspec
        return P(*axes)

    return map_with_path(spec_of, params_shape)


def activation_rules(mesh, shape_cfg, *, layout: str = "tp") -> Dict[str, P]:
    """Logical-name → spec table for the Sharder."""
    daxes = data_axes_of(mesh)
    if layout == "fsdp" and shape_cfg.mode == "train":
        all_axes = tuple(mesh.axis_names)
        asize = math.prod(mesh.shape[a] for a in all_axes)
        bd = all_axes if _divisible(shape_cfg.global_batch, asize) else None
        return {
            "act_resid_in": P(bd, None, None),
            "act_resid": P(bd, None, None),
        }
    d = daxes if len(daxes) > 1 else daxes[0]
    batch_shardable = _divisible(shape_cfg.global_batch,
                                 math.prod(mesh.shape[a] for a in daxes))
    bd = d if batch_shardable else None
    # layout="sp": Megatron-style sequence parallelism of the residual
    # stream over `model` on the sequence dim
    seq_ax = "model" if (layout == "sp" and shape_cfg.mode == "train") \
        else None
    rules = {
        "act_resid_in": P(bd, seq_ax, None),
        "act_resid": P(bd, seq_ax, None),
        "act_qkv": P(bd, None, "model", None),
        "act_ffn": P(bd, None, "model"),
    }
    if shape_cfg.mode == "decode":
        # spatial sharding of the cache: the sequence dim over model (and
        # the data axes when the batch does not split)
        seq_axes = ("model",) if batch_shardable else tuple(daxes) + ("model",)
        sa = seq_axes if len(seq_axes) > 1 else seq_axes[0]
        rules.update({
            "cache_kv": P(bd, sa, None, None),
            "cache_mla": P(bd, sa, None),
        })
    return rules


def batch_specs(batch_spec_tree, mesh, shape_cfg, *, layout: str = "tp"):
    """Input specs for the data batch: the leading batch dim over the data
    axes (when divisible), the rest replicated.  The fsdp layout shards
    the batch over every mesh axis."""
    if layout == "fsdp" and shape_cfg.mode == "train":
        daxes = tuple(mesh.axis_names)
    else:
        daxes = data_axes_of(mesh)
    dsize = math.prod(mesh.shape[a] for a in daxes)
    d = daxes if len(daxes) > 1 else daxes[0]

    def spec_of(_path, leaf):
        shape, _ = leaf_shape(leaf)
        if len(shape) >= 1 and _divisible(shape[0], dsize):
            return P(*([d] + [None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return map_with_path(spec_of, batch_spec_tree)


def cache_specs(cache_shape_tree, mesh, shape_cfg, batch: int):
    """Decode-cache specs (paper-spatial: long dims over model)."""
    daxes = data_axes_of(mesh)
    dsize = math.prod(mesh.shape[a] for a in daxes)
    msize = mesh.shape["model"]
    d = daxes if len(daxes) > 1 else daxes[0]
    b_ok = _divisible(batch, dsize)

    def spec_of(path, leaf):
        shape, _ = leaf_shape(leaf)
        ndim = len(shape)
        last = [n for n in path if isinstance(n, str)][-1]
        axes = [None] * ndim
        # stacked segment caches have extra leading dims; the batch dim is
        # the first dim equal to `batch`
        bdim = shape.index(batch) if batch in shape else None
        if bdim is not None and b_ok and batch > 1:
            axes[bdim] = d
        if last in ("k", "v", "k_pos", "ckv", "krope"):
            # the sequence dim follows the batch dim
            sdim = (bdim + 1) if bdim is not None else ndim - 2
            want = ("model",) if (b_ok and batch > 1) else \
                tuple(daxes) + ("model",)
            if _divisible(shape[sdim], math.prod(mesh.shape[a]
                                                 for a in want)):
                axes[sdim] = want if len(want) > 1 else want[0]
        elif last in ("ssm", "conv"):
            # the d_inner dim over model
            ddim = ndim - 2 if last == "ssm" else ndim - 1
            if _divisible(shape[ddim], msize):
                axes[ddim] = "model"
        elif last == "wkv":
            hdim = ndim - 3
            if _divisible(shape[hdim], msize):
                axes[hdim] = "model"
        return P(*axes)

    return map_with_path(spec_of, cache_shape_tree)


def spec_shards(spec, mesh) -> int:
    """How many blocks ``spec`` cuts a leaf into on ``mesh``."""
    n = 1
    for ax in spec:
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            n *= mesh.shape[a]
    return n

