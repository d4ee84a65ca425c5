"""Activation-sharding plumbing and the placement of a rank's blocks.
Counterpart of ``repro/models/shard.py``.

Models call ``sharder.act(x, "<logical name>")`` at the layout-critical
points.  In JAX that is a ``with_sharding_constraint``, a layout hint that
leaves the values as they are, and the model runs once over the global
arrays.  The port has no GSPMD path (ROADMAP C): on a mesh each rank runs
the model on its own block of the batch, and the MoE layer's expert
parallelism is rank code over the mesh's ``model`` axis
(``models.ffn.moe_sharded_apply``).  So the port's ``act`` returns the
rank's tensor unchanged; :meth:`Sharder.constraint` is JAX's decision
(the spec it would apply to a global shape, or None where it skips).

What stands in for a ``device_put`` with a ``NamedSharding`` is
:meth:`Sharder.place`: the rank's block of a global tensor under a spec.
A rank places only what its rank code computes on a block: the batch rows
(``place_batch``, by ``sharding.batch_specs``) and the MoE expert leaves
``ewg``/``ewu``/``ewo`` on their expert dim (``place_params``, by the
``model`` entry of ``sharding.param_specs``), where the MoE layer is
expert-parallel (:func:`block_leaves`, which the train step's gradient
norm and the launcher's checkpoints read too).  Every other leaf stays
whole on every rank, a deliberate divergence from JAX's plan, whose bytes
per device :func:`plan_bytes` gives beside the rank's own.  Training
sums every gradient leaf over the data axes (``sharding.data_axes_of``)
and none over ``model``.
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


def block_leaves(mesh, moe_mode: str) -> tuple:
    """The names of the leaves a rank holds as blocks over ``model``
    (``BLOCK_AXIS``, on their expert dim): the MoE expert leaves where the
    layer is expert-parallel on a mesh; none on one device or with
    ``moe_mode="dense"``, whose layer needs every expert."""
    return EXPERT_LEAVES if mesh is not None and moe_mode != "dense" \
        else ()


def gather_blocks(tree, specs, mesh, names):
    """``tree`` with each leaf named in ``names`` all-gathered whole over
    ``model`` along the dim of its spec's ``model`` entry (every rank must
    call it): the inverse of :meth:`Sharder.place_params` on those
    leaves."""
    ax = mesh.axis(BLOCK_AXIS)

    def leaf(path, spec, x):
        if path[-1] not in names:
            return x
        return all_gather_tiled(x, ax, list(spec).index(BLOCK_AXIS))
    return map_with_path(leaf, specs, tree)


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

    def place_params(self, params, specs, names=EXPERT_LEAVES):
        """The parameter tree a rank holds (or a tree of the parameters'
        structure, such as Adam's moments): the blocks of the leaves in
        ``names`` (the MoE experts) on their expert dim (the ``model``
        entry of their spec in ``specs``, ``sharding.param_specs``'s
        tree), every other leaf whole."""
        def leaf(path, spec, x):
            if path[-1] not in names:
                return x
            return self.place(x, P(*(a if a == "model" else None
                                     for a in spec)))
        return map_with_path(leaf, specs, params)


def plan_bytes(shapes, specs, mesh) -> int:
    """Bytes a device holds of a tree of shapes (or tensors) under JAX's
    plan ``specs``: each leaf's bytes over the blocks its spec cuts it
    into."""
    def leaf(_path, spec, x):
        shape, itemsize = leaf_shape(x)
        return math.prod(shape) * itemsize // spec_shards(spec, mesh)
    return int(sum(tree_leaves(map_with_path(leaf, specs, shapes))))


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree (what a rank holds)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


NO_SHARD = NoSharder()
