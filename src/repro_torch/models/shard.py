"""Activation-sharding plumbing and the placement of a rank's blocks.
Counterpart of ``repro/models/shard.py``.

Models call ``sharder.act(x, "<logical name>")`` at the layout-critical
points.  In JAX that is a ``with_sharding_constraint``, a layout hint that
leaves the values as they are, and the model runs once over the global
arrays.  The port has no GSPMD path (ROADMAP C): on a mesh each rank runs
the model as rank code on its blocks, so the port's ``act`` returns the
rank's tensor unchanged; :meth:`Sharder.constraint` is JAX's decision
(the spec it would apply to a global shape, or None where it skips).

What stands in for a ``device_put`` with a ``NamedSharding`` is
:meth:`Sharder.place`: the rank's block of a global tensor under a spec.
A rank holds its rows of the batch (``place_batch``, by
``sharding.batch_specs``) and, by ``place_params``, the leaves of its
block set (:func:`block_leaves`) as blocks over ``model``, each on the dim
of its ``sharding.param_specs`` entry (layout "tp", ``zero3=False``):

- ``experts``: the MoE leaves ``ewg``/``ewu``/``ewo`` on their expert dim,
  where the layer is expert-parallel (``models.ffn.moe_sharded_apply``);
- ``attn``: a GQA mixer's ``wq``/``wk``/``wv`` on their heads and ``wo``
  on its head rows; ``ffn``: an MLP's or the MoE shared experts'
  ``wu``/``wg`` on d_ff and ``wo`` on its d_ff rows; ``embed``: the
  vocabulary rows.  This is JAX's tensor parallelism (``act_qkv``,
  ``act_ffn``): a rank computes its heads, its d_ff columns and its
  vocabulary block, the replicated input enters that split work through
  Megatron's f (``core.mesh.copy_to_axis``, its gradient summed over
  ``model``) and the partial outputs leave through g (``reduce_from_axis``;
  the serving head gathers its logits, the loss combines its
  logsumexp over ``model``).

The same blocks on every path: serving, training and the eval step.
A leaf is matched by its path and its siblings, never by its last name
alone (RWKV's channel mix also has ``wk``/``wv``; MLA's mixer a ``wo``),
and only where JAX's spec puts ``model`` on one of its dims; a GQA layer
whose query heads do not split keeps its four leaves whole, where its
kv heads do not split (KV % m != 0) a rank holds ``wk``/``wv`` whole and
keeps the kv heads its query heads read.  Every other leaf (RWKV-6's
mixers, Mamba, MLA, ``frontend_proj``, norms, the router) stays whole on
every rank, a deliberate divergence from JAX's plan, whose bytes per
device :func:`plan_bytes` gives beside the rank's own.  Training sums
every gradient leaf over the data axes (``sharding.data_axes_of``); a
whole leaf's gradient is complete on every rank of ``model`` (a split
weight read whole, as ``wk`` at KV % m != 0, enters through f), and the
norm sums the blocks' squares over ``model`` (``models.lm``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import torch

from ..core.mesh import all_gather_tiled
from ..sharding.rules import P, leaf_shape, map_with_path, spec_shards
from .common import tree_leaves

EXPERT_LEAVES = ("ewg", "ewu", "ewo")
BLOCK_AXIS = "model"
# the kinds of leaves a rank may hold as blocks over ``model``
EXPERTS, ATTENTION, FFN, EMBED = "experts", "attn", "ffn", "embed"
TENSOR_PARALLEL = (ATTENTION, FFN, EMBED)
GQA_LEAVES = ("wq", "wk", "wv", "wo")
FFN_LEAVES = ("wu", "wg", "wo")


def block_leaves(mesh, moe_mode: str) -> tuple:
    """The kinds of leaves a rank holds as blocks over ``model``
    (``BLOCK_AXIS``), JAX's layout on every path: the MoE experts where
    the layer is expert-parallel on a mesh (not with
    ``moe_mode="dense"``, whose layer needs every expert) and the
    tensor-parallel kinds (``TENSOR_PARALLEL``); none on one device."""
    if mesh is None:
        return ()
    kinds = (EXPERTS,) if moe_mode != "dense" else ()
    return kinds + TENSOR_PARALLEL


def leaf_kinds(tree, path=()):
    """The tree of ``tree``'s structure (parameters, their shapes or their
    specs) with each leaf's kind (``EXPERTS``, ``ATTENTION``, ``FFN``,
    ``EMBED``) or None, by its path and its siblings: the expert leaves by
    name, ``embed`` at the root, a mixer's four leaves where it holds
    ``wq`` (GQA; MLA has none), ``wu``/``wg``/``wo`` of an ``ffn`` or
    ``shared`` subtree that holds ``wu`` (not RWKV's channel mix)."""
    if isinstance(tree, list):
        return [leaf_kinds(v, path + (None,)) for v in tree]
    gqa = path[-1:] == ("mixer",) and "wq" in tree
    mlp = path[-1:] in (("ffn",), ("shared",)) and "wu" in tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = leaf_kinds(v, path + (k,))
        elif k in EXPERT_LEAVES:
            out[k] = EXPERTS
        elif k == "embed" and not path:
            out[k] = EMBED
        elif gqa and k in GQA_LEAVES:
            out[k] = ATTENTION
        elif mlp and k in FFN_LEAVES:
            out[k] = FFN
        else:
            out[k] = None
    return out


def _model_dim(spec) -> Optional[int]:
    return list(spec).index(BLOCK_AXIS) if BLOCK_AXIS in spec else None


def block_dims(specs, names):
    """The tree of ``specs``'s structure with, for each leaf a rank holds
    as its block over ``model``, the dim of its spec's ``model`` entry,
    and None for a leaf it holds whole: a leaf of a kind in ``names``
    whose spec puts ``model`` on a dim.  A GQA mixer whose ``wq`` keeps
    its heads whole keeps its four leaves whole, an MLP whose ``wu``
    keeps d_ff whole its three."""
    lead = {ATTENTION: "wq", FFN: "wu"}

    def dims(spec, kind):
        if isinstance(spec, list):
            return [dims(s, k) for s, k in zip(spec, kind)]
        out = {}
        for key, sub in spec.items():
            k = kind[key]
            if isinstance(sub, (dict, list)):
                out[key] = dims(sub, k)
            elif k not in names or (
                    k in lead and _model_dim(spec[lead[k]]) is None):
                out[key] = None
            else:
                out[key] = _model_dim(sub)
        return out
    return dims(specs, leaf_kinds(specs))


def gather_blocks(tree, specs, mesh, names):
    """``tree`` with each leaf a rank holds as a block (``block_dims`` of
    the kinds ``names``) all-gathered whole over ``model`` along its
    block's dim (every rank must call it): the inverse of
    :meth:`Sharder.place_params` with those kinds."""
    ax = mesh.axis(BLOCK_AXIS)

    def leaf(path, x, dim):
        return x if dim is None else all_gather_tiled(x, ax, dim)
    return map_with_path(leaf, tree, block_dims(specs, names))


def split_axis(mesh, local: int, whole: int):
    """The ``model`` axis where a rank holds ``local`` of a dim of
    ``whole`` as its block over it, None where it holds the dim whole (no
    mesh, or ``local == whole``): how the rank code reads from its weights
    whether a layer is tensor-parallel."""
    if mesh is None or local == whole:
        return None
    ax = mesh.axis(BLOCK_AXIS)
    if local * ax.size != whole:
        raise ValueError(f"a block of {local} of {whole} is not 1/{ax.size} "
                         f"of it: place the leaves with "
                         f"Sharder.place_params")
    return ax


class NoSharder:
    mesh = None

    def act(self, x, name: str):
        return x


def _names(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) \
        else (entry,)


@dataclasses.dataclass
class Sharder:
    mesh: Any
    rules: Dict[str, P]

    def constraint(self, shape: Sequence[int], name: str) -> Optional[P]:
        """The spec JAX's ``act`` constrains a global array of ``shape``
        to, or None where it leaves the array alone: no rule for ``name``,
        a rule of another rank, or a sharded dim that does not divide."""
        spec = self.rules.get(name)
        if spec is None or len(spec) != len(shape):
            return None
        for dim, ax in enumerate(spec):
            size = math.prod(self.mesh.shape[a] for a in _names(ax))
            if shape[dim] % size != 0:
                return None
        return spec

    def act(self, x, name: str):
        """The rank's ``x``, unchanged (a layout hint in JAX)."""
        return x

    def place(self, x: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of the global ``x`` under ``spec``: each dim
        with an entry split over its axes (the first the major one), as
        ``jax.device_put(x, NamedSharding(mesh, spec))`` lays it out."""
        whole = x
        for dim, ax in enumerate(spec):
            names = _names(ax)
            if not names:
                continue
            index, count = self.mesh.block(names)
            if x.shape[dim] % count:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split over {names} ({count} blocks)")
            n = x.shape[dim] // count
            x = x.narrow(dim, index * n, n)
        # a block is the rank's own memory, not a view that keeps the
        # whole tensor alive
        return x.contiguous() if x is whole else x.clone(
            memory_format=torch.contiguous_format)

    def place_batch(self, batch: dict, specs: dict) -> dict:
        """The rank's rows of every input of ``batch``, by ``specs``
        (``sharding.batch_specs``)."""
        return {k: self.place(torch.as_tensor(v), specs[k])
                for k, v in batch.items()}

    def place_params(self, params, specs, names=(EXPERTS,)):
        """The parameter tree a rank holds (or a tree of the parameters'
        structure, such as Adam's moments): the leaves of the kinds in
        ``names`` (:func:`block_leaves`; by default the MoE experts) as
        the rank's blocks on the dim of their spec's ``model`` entry
        (``specs``, ``sharding.param_specs``'s tree; :func:`block_dims`),
        every other leaf whole."""
        def leaf(path, x, dim):
            if dim is None:
                return x
            return self.place(x, P(*(BLOCK_AXIS if i == dim else None
                                     for i in range(x.dim()))))
        return map_with_path(leaf, params, block_dims(specs, names))


def plan_bytes(shapes, specs, mesh) -> int:
    """Bytes a device holds of a tree of shapes (or tensors) under JAX's
    plan ``specs``: each leaf's bytes over the blocks its spec cuts it
    into."""
    def leaf(_path, spec, x):
        shape, itemsize = leaf_shape(x)
        return math.prod(shape) * itemsize // spec_shards(spec, mesh)
    return int(sum(tree_leaves(map_with_path(leaf, specs, shapes))))


def block_bytes(params, shapes, specs, mesh, names):
    """(bytes a rank holds of the leaves it holds as blocks, the bytes a
    device holds of those leaves under JAX's plan ``specs``): ``params``
    the rank's tree (placed with the kinds ``names``), ``shapes`` the
    whole tree of shapes (or tensors).  Equal where ``specs`` is JAX's
    ``param_specs(zero3=False)``, whose split leaves carry ``model``
    alone."""
    held, plan = [], []

    def leaf(_path, x, dim, spec, whole):
        if dim is not None:
            held.append(x.numel() * x.element_size())
            shape, itemsize = leaf_shape(whole)
            plan.append(math.prod(shape) * itemsize
                        // spec_shards(spec, mesh))
    map_with_path(leaf, params, block_dims(specs, names), specs, shapes)
    return sum(held), sum(plan)


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree (what a rank holds)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


NO_SHARD = NoSharder()
