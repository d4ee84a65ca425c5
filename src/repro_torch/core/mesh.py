"""2-D ``(data, graph)`` mesh over ``torch.distributed`` ranks (DESIGN.md
§10).  Counterpart of ``repro/core/mesh.py``.

The paper's scaling story composes two axes:

- **graph-level batch parallelism** (``data``): B graphs split dp ways,
  B/dp graphs per rank;
- **node-level spatial parallelism** (``graph``, paper §4.1): one graph's
  N node rows split sp ways, N/sp resident rows per rank, with the
  per-layer collectives of Alg. 2-4.

``make_mesh(dp, sp)`` lays dp·sp ranks of an initialized default process
group out data-major (rank = d·sp + g), as the JAX package lays out its
devices.  Each rank of a mesh holds:

| array | dense | sparse | csr (sp = 1) |
|---|---|---|---|
| topology | ``adj`` (B/dp, N/sp, N) | ``neighbors``/``valid`` (B/dp, N/sp, D) | (B/dp, ·) |
| solution / candidate | (B/dp, N), whole on every graph rank | same | same |
| scores of an evaluation | (B/dp, N), all-gathered over ``graph`` | same | (B/dp, N) |

which is the layout of the JAX package's fused solve (``constrain_batch``
for the masks, the shard_map tiles for the topology).  The collectives
below take an :class:`Axis` of a mesh, as the JAX modules name a mesh axis
inside ``shard_map``; on an axis of size 1 they are the identity and
communicate nothing.  Each mesh counts its collectives' calls and bytes by
kind (``Mesh.traffic``).

Training differentiates through the collectives, which ``shard_map``
transposes for JAX and which torch's in-place ``torch.distributed`` calls
hide from autograd.  So the graph mesh's train path, where every rank's
loss differs, takes :func:`pooled_sum` (``psum`` whose gradient is
all-reduced too) and :func:`partial_sum_columns` (the dense layer's
all-reduce of row-block partials, then the rank's own columns, whose
gradient is the all-gather of the columns' gradients), and the in-place
forms refuse a tensor that requires a gradient.  On the LM mesh the loss
is the same on every rank, and the pairs are Megatron's:
:func:`copy_to_axis` (a value replicated over an axis enters work split
over it: the identity, all-reduced on the way back) and
:func:`reduce_from_axis` (partials summed into a replicated value: an
all-reduce whose gradient is the identity); :func:`all_to_all` and
:func:`all_gather_tiled` pass a gradient too (the reverse exchange, the
rank's block of the replicated cotangent), :func:`all_reduce_grads`
sums the gradient leaves over the data axes, and :func:`broadcast_first`
hands every rank the first rank's bits of the leaves that all hold
whole.  The graph train
step's one world all-reduce (:func:`all_reduce_world`) sums the flattened
gradients and the loss, Alg. 5's MPI_All_reduce.  The dataset of a mesh
run keeps every graph on every data rank and splits its node rows over
``graph`` (:func:`shard_dataset`); the replay's tile is
``core.replay.device_replay_init(mesh=)``'s.

The backend is the caller's choice and is never switched quietly:
``nccl`` when each rank has its own card, ``gloo`` for CPU ranks and for
ranks that share one card (NCCL refuses two ranks on one card).
:func:`spawn_mesh` starts a mesh of local processes for tests and smoke
runs; the launcher takes its ranks from ``torchrun``.

A service on a mesh has one planner, rank 0 (``serving.service``): it
sends each dispatch's plan through a :class:`PlanChannel` before any
collective of that dispatch, and the other ranks run the same dispatch.

``PolicyConfig.spatial`` keeps the JAX contract: an int P means ``(1,
P)``, ``0``/``None`` mean ``(1, 1)`` (no mesh), ``(dp, sp)`` the 2-D mesh.

The LM substrate names its axes as JAX's LM mesh does (``data``,
``model``, and ``pod`` across pods): :func:`make_named_mesh` builds such
a :class:`NamedMesh` over the same ranks and groups
(``repro_torch.launch.mesh`` builds the production and host meshes), and
the expert-parallel MoE exchanges its capacity buffers with
:func:`all_to_all`.

:func:`shape_mesh` builds either kind of mesh as one rank of it sees it,
with no process group: its collectives take meta tensors, record their
calls and bytes into ``traffic`` as a real mesh's do, and return meta
results of the right shape (``launch/dryrun.py`` counts one rank's
program at the production mesh's shard shapes on it).
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import gc
import json
import os
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d

from ..device import DeviceLike, resolve_device

DATA = "data"     # graph-level batch parallelism (B → B/dp per rank)
GRAPH = "graph"   # node-level spatial parallelism (N → N/sp per rank)
BACKENDS = ("nccl", "gloo")

MeshSpec = Union[None, int, Tuple[int, int]]

# state fields whose second dimension is the node rows of the topology
_TOPOLOGY_ROWS = ("adj", "neighbors", "valid")


def normalize_spatial(spec: MeshSpec) -> Tuple[int, int]:
    """``PolicyConfig.spatial`` value → ``(dp, sp)`` mesh shape.

    Back-compat: an int P means the legacy 1-D node sharding ``(1, P)``;
    ``0``/``None`` mean ``(1, 1)`` (single device, no mesh)."""
    if spec is None:
        return (1, 1)
    if isinstance(spec, (tuple, list)):
        if len(spec) != 2:
            raise ValueError(f"mesh spec must be (dp, sp), got {spec!r}")
        dp, sp = int(spec[0]), int(spec[1])
        if dp < 1 or sp < 1:
            raise ValueError(f"mesh spec components must be >= 1, "
                             f"got {spec!r}")
        return (dp, sp)
    p = int(spec)
    if p < 0:
        raise ValueError(f"legacy spatial spec must be >= 0, got {spec!r}")
    return (1, 1) if p == 0 else (1, p)


def is_multi(spec: MeshSpec) -> bool:
    """True when the spec selects any multi-rank partitioning."""
    return normalize_spatial(spec) != (1, 1)


def parse_spatial(text: str) -> MeshSpec:
    """CLI form → spec: ``"4"`` (legacy node sharding) or ``"dp,sp"``."""
    text = text.strip()
    if "," in text:
        dp, sp = (int(t) for t in text.split(","))
        return (dp, sp)
    return int(text)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it: ``size`` ranks, this rank
    at ``index``, ``group`` the process group of the ranks along it (None
    on an axis of size 1, where collectives are the identity).
    ``traffic`` is its mesh's count of collectives (``Mesh.traffic``)."""
    name: str
    size: int
    index: int
    group: Any = None
    traffic: Optional[dict] = dataclasses.field(default=None, compare=False,
                                                hash=False, repr=False)

    def rows(self, total: int) -> slice:
        """This rank's block of ``total`` rows split ``size`` ways."""
        if total % self.size:
            raise ValueError(f"{total} rows do not split over the "
                             f"{self.name} axis of size {self.size}")
        n = total // self.size
        return slice(self.index * n, (self.index + 1) * n)


class _ShapeOnly:
    """The process group of a shape-only mesh's axes: there is none."""

    def __repr__(self) -> str:
        return "SHAPE_ONLY"


SHAPE_ONLY = _ShapeOnly()


def _moves(group, *ts: torch.Tensor) -> bool:
    """Whether a collective over ``group`` moves data: False on a
    shape-only mesh's axis (:data:`SHAPE_ONLY`), whose collectives take
    meta tensors and move nothing; a real tensor there raises."""
    if group is not SHAPE_ONLY:
        return True
    for t in ts:
        if t.device.type != "meta":
            raise ValueError(f"a shape-only mesh moves no data: its "
                             f"collectives take meta tensors, got one on "
                             f"{t.device}")
    return False


def check_axis(axis: Optional[Axis]) -> None:
    """``axis`` is None (one device) or an :class:`Axis` of a mesh: a bare
    axis name carries no process group."""
    if axis is not None and not isinstance(axis, Axis):
        raise TypeError(f"axis must be a mesh axis (make_mesh(...).graph) "
                        f"or None, got {axis!r}")


def single_axis(name: str) -> Axis:
    """An axis of size 1: the whole rows on this rank, no communication."""
    return Axis(name, 1, 0, None)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (dp, sp) mesh of this rank: ``rank = data.index · sp +
    graph.index``.  ``traffic`` counts the collectives this rank has
    called on it, ``{"<kind> <axis>": [calls, bytes sent]}`` (the bytes
    of the rank's own operand), until :func:`reset_traffic`.
    ``shape_only``: built by :func:`shape_mesh`, with no process group."""
    dp: int
    sp: int
    rank: int
    data: Axis
    graph: Axis
    traffic: dict = dataclasses.field(default_factory=dict, compare=False,
                                      hash=False, repr=False)
    shape_only: bool = False

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.dp, self.sp)

    @property
    def size(self) -> int:
        return self.dp * self.sp

    def axis(self, name: str) -> Axis:
        return {DATA: self.data, GRAPH: self.graph}[name]


def make_mesh(dp: int = 1, sp: Optional[int] = None) -> Mesh:
    """The ``(data, graph)`` mesh over the default process group, which
    must be initialized with world size dp·sp.  ``sp=None`` spreads the
    ranks over ``graph``.  Every rank must call it, in the same order (its
    process groups are created collectively); a mesh is built once per
    shape and process group, as the JAX package caches its meshes."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"the mesh {(dp, sp)} needs torch.distributed initialized on "
            f"every rank: start the ranks with repro_torch.core.mesh."
            f"spawn_mesh, or under torchrun (see "
            f"repro_torch.launch.solve_serve)")
    world = dist.get_world_size()
    if sp is None:
        sp = max(world // max(dp, 1), 1)
    if dp * sp != world:
        raise ValueError(f"mesh ({dp}, {sp}) needs {dp * sp} ranks, the "
                         f"process group has {world}")
    return _build_mesh(dp, sp, dist.group.WORLD)


def _world_timeout() -> Optional[datetime.timedelta]:
    """The default group's timeout, which ``new_group`` does not inherit
    (it takes the backend's default, 30 minutes for gloo); None where the
    backend does not tell it."""
    world = dist.group.WORLD
    for dev in ("cpu", "cuda"):
        try:
            return world._get_backend(torch.device(dev)).options._timeout
        except (RuntimeError, AttributeError):
            continue
    return None


@functools.lru_cache(maxsize=16)
def _build_mesh(dp: int, sp: int, world_group) -> Mesh:
    rank = dist.get_rank()
    d, g = divmod(rank, sp)
    groups = {}
    # the axis groups time out with the default group, so a rank stuck in
    # an axis collective raises when a world collective would
    timeout = _world_timeout()
    # every rank creates every group, in one order (new_group is collective)
    for i in range(dp):
        grp = dist.new_group([i * sp + j for j in range(sp)],
                             timeout=timeout) if sp > 1 else None
        if i == d:
            groups[GRAPH] = grp
    for j in range(sp):
        grp = dist.new_group([i * sp + j for i in range(dp)],
                             timeout=timeout) if dp > 1 else None
        if j == g:
            groups[DATA] = grp
    traffic = {}
    return Mesh(dp=dp, sp=sp, rank=rank,
                data=Axis(DATA, dp, d, groups[DATA], traffic),
                graph=Axis(GRAPH, sp, g, groups[GRAPH], traffic),
                traffic=traffic)


@dataclasses.dataclass(frozen=True)
class NamedMesh:
    """A mesh of named axes over ``torch.distributed`` ranks, as the LM
    substrate names them (``("data", "model")``, ``("pod", "data",
    "model")``): the port's counterpart of a ``jax.sharding.Mesh``.  The
    ranks lie row-major over the axes, as JAX reshapes its device list, so
    the last axis varies fastest.  ``axis_names`` and ``shape`` (name →
    size) are what the sharding rules read; ``axes`` holds this rank's
    :class:`Axis` of each name, with its process group, and ``traffic``
    counts the collectives called on them (``Mesh.traffic``'s form);
    ``shape_only``: built by :func:`shape_mesh`, with no process group."""
    axis_names: Tuple[str, ...]
    shape: dict
    rank: int
    axes: dict
    traffic: dict = dataclasses.field(default_factory=dict, compare=False,
                                      hash=False, repr=False)
    shape_only: bool = False

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in self.axis_names]))

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    def block(self, names: Sequence[str]) -> Tuple[int, int]:
        """(index, count) of this rank's block of a dim split over the
        axes ``names`` together, the first the major one (JAX's order for
        a tuple entry of a ``PartitionSpec``)."""
        index, count = 0, 1
        for name in names:
            ax = self.axes[name]
            index, count = index * ax.size + ax.index, count * ax.size
        return index, count


def make_named_mesh(shape: Sequence[int], axis_names: Sequence[str]
                    ) -> NamedMesh:
    """The mesh of ``shape`` over the axes ``axis_names``: the ranks of the
    default process group, whose world size must be the product of
    ``shape``.  A mesh whose axes are all of size 1 needs no process group
    and builds in a single process.  Every rank must call it, in the same
    order (the axis groups are created collectively); a mesh is built once
    per shape, names and process group."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         f"must pair one distinct name with each size")
    if min(shape) < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {shape}")
    need = int(np.prod(shape))
    if need == 1:
        return _build_named_mesh(shape, axis_names, None)
    if not dist.is_initialized():
        raise RuntimeError(
            f"the mesh {dict(zip(axis_names, shape))} needs "
            f"torch.distributed initialized on each of its {need} ranks: "
            f"start them with repro_torch.core.mesh.spawn_mesh or torchrun")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs {need} "
                         f"ranks, the process group has {world}")
    return _build_named_mesh(shape, axis_names, dist.group.WORLD)


@functools.lru_cache(maxsize=16)
def _build_named_mesh(shape, axis_names, world_group) -> NamedMesh:
    rank = 0 if world_group is None else dist.get_rank()
    coords = np.unravel_index(rank, shape)
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    timeout = _world_timeout() if world_group is not None else None
    traffic = {}
    axes = {}
    for i, name in enumerate(axis_names):
        group = None
        if shape[i] > 1:
            # every line of ranks along axis i, in one order on every rank
            lines = np.moveaxis(ranks, i, -1).reshape(-1, shape[i])
            for line in lines:
                grp = dist.new_group([int(r) for r in line], timeout=timeout)
                if rank in line:
                    group = grp
        axes[name] = Axis(name, shape[i], int(coords[i]), group, traffic)
    return NamedMesh(axis_names=axis_names, shape=dict(zip(axis_names,
                                                           shape)),
                     rank=rank, axes=axes, traffic=traffic)


def shape_mesh(shape: Sequence[int], axis_names: Sequence[str],
               rank: int = 0) -> Union[Mesh, NamedMesh]:
    """The mesh of ``shape`` over ``axis_names`` as rank ``rank`` of it
    sees it (the ranks row-major over the axes, as on a real mesh), with no
    process group: each axis of size > 1 has the group
    :data:`SHAPE_ONLY`.  Its collectives take meta tensors, record their
    calls and bytes into ``traffic`` as a real mesh's do, and return meta
    results of the right shape without communicating; a real tensor
    raises at a collective that would communicate.  On axes of size 1
    nothing communicates, so a mesh of one rank runs real tensors as one
    device does.  The axis names ``("data", "graph")`` give the graph
    :class:`Mesh`, any others a :class:`NamedMesh`."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         f"must pair one distinct name with each size")
    if min(shape) < 1 or not 0 <= rank < int(np.prod(shape)):
        raise ValueError(f"no rank {rank} on a mesh of shape {shape}")
    coords = np.unravel_index(rank, shape)
    traffic = {}
    axes = {name: Axis(name, size, int(i), SHAPE_ONLY if size > 1 else None,
                       traffic)
            for name, size, i in zip(axis_names, shape, coords)}
    if axis_names == (DATA, GRAPH):
        return Mesh(dp=shape[0], sp=shape[1], rank=rank, data=axes[DATA],
                    graph=axes[GRAPH], traffic=traffic, shape_only=True)
    return NamedMesh(axis_names=axis_names, shape=dict(zip(axis_names,
                                                           shape)),
                     rank=rank, axes=axes, traffic=traffic, shape_only=True)


def destroy_meshes() -> None:
    """Forget every cached mesh, then destroy the process groups.  A
    cached mesh holds its axis groups, which ``dist.destroy_process_group``
    shuts down but cannot free; left to the interpreter's exit, a gloo
    group's teardown can abort the process ("terminate called without an
    active exception", exit code -6).  So the meshes go first, and every
    group is freed while the interpreter is whole."""
    _build_mesh.cache_clear()
    _build_named_mesh.cache_clear()
    gc.collect()
    if dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


def mesh_from_spec(spec: MeshSpec) -> Optional[Mesh]:
    """Spec → mesh, or None when the spec is single-device ``(1, 1)``."""
    dp, sp = normalize_spatial(spec)
    return None if (dp, sp) == (1, 1) else make_mesh(dp, sp)


def mesh_shape(mesh: Mesh) -> Tuple[int, int]:
    """(dp, sp) of a mesh built by :func:`make_mesh`."""
    return mesh.shape


# ---------------------------------------------------------------------------
# Axis collectives (lax.psum / pmax / all_gather(tiled=True)).
# ---------------------------------------------------------------------------

def _record(traffic: Optional[dict], key: str, t: torch.Tensor) -> None:
    if traffic is not None:
        calls = traffic.setdefault(key, [0, 0])
        calls[0] += 1
        calls[1] += t.numel() * t.element_size()


def reset_traffic(mesh: Mesh) -> dict:
    """The mesh's collective counts so far, which start again from none."""
    out = {k: list(v) for k, v in mesh.traffic.items()}
    mesh.traffic.clear()
    return out


def _no_grad_operand(t: torch.Tensor, what: str) -> None:
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{what} is invisible to autograd: a tensor that requires a "
            f"gradient takes mesh.pooled_sum or mesh.partial_sum_columns, "
            f"a gathered layer of core.s2v_sparse, or on the LM mesh "
            f"mesh.reduce_from_axis")


def _sum(t: torch.Tensor, axis: Axis, key: str) -> torch.Tensor:
    _record(axis.traffic, key, t)
    if _moves(axis.group, t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
    return t


def all_reduce_sum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Σ of ``t`` over the ranks of ``axis``, in place (``t`` must be
    contiguous); every rank receives the same values.  No gradient passes
    it (:func:`pooled_sum` and :func:`reduce_from_axis` are the
    differentiable forms)."""
    if axis.size > 1:
        _no_grad_operand(t, "all_reduce_sum")
        _sum(t, axis, f"all_reduce {axis.name}")
    return t


def all_reduce_max(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Elementwise max of ``t`` over the ranks of ``axis``, in place."""
    if axis.size > 1:
        _no_grad_operand(t, "all_reduce_max")
        _record(axis.traffic, f"all_reduce_max {axis.name}", t)
        if _moves(axis.group, t):
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=axis.group)
    return t


def _gather(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    _record(axis.traffic, f"all_gather {axis.name}", t)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    if _moves(axis.group, t):
        dist.all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim=dim)


def _exchange(t: torch.Tensor, axis: Axis, key: str) -> torch.Tensor:
    _record(axis.traffic, key, t)
    t = t.contiguous()
    out = torch.empty_like(t)
    if _moves(axis.group, t):
        dist.all_to_all_single(out, t, group=axis.group)
    return out


class _GatherReplicated(torch.autograd.Function):
    """The tiled all-gather whose result's cotangent is the same on every
    rank of the axis (a loss replicated over it): each tile's gradient is
    this rank's block of that cotangent, with no communication."""

    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, t.shape[dim]
        return _gather(t.detach(), axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.axis.index * ctx.n,
                           ctx.n).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    """The block exchange, whose transpose is the same exchange of the
    cotangent (block j went to rank j's block ``index``)."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return _exchange(t.detach(), axis, f"all_to_all {axis.name}")

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.axis,
                         f"all_to_all {ctx.axis.name} backward"), None


def _needs_grad(t: torch.Tensor) -> bool:
    return t.requires_grad and torch.is_grad_enabled()


def all_gather_tiled(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' tiles of ``axis`` concatenated along ``dim`` in rank
    order (``lax.all_gather(..., tiled=True)``).  Its gradient is this
    rank's block of the result's: right where that cotangent is the same
    on every rank of ``axis``, as on the LM mesh, whose loss is replicated
    (not a reduce-scatter, which a rank's own loss would need)."""
    if axis.size == 1:
        return t
    if _needs_grad(t):
        return _GatherReplicated.apply(t, axis, dim)
    return _gather(t, axis, dim)


def all_to_all(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The exchange of ``t``'s leading blocks over the ranks of ``axis``
    (``lax.all_to_all(..., split_axis=0, concat_axis=0, tiled=False)``):
    ``t`` is (size, ...), and block j of the result is block ``index`` of
    rank j's ``t``.  Its gradient is the same exchange of the result's
    (counted as ``all_to_all <axis> backward``).  gloo takes CUDA operands
    too (ranks that share a card), and moves them through the host
    itself."""
    if axis.size == 1:
        return t
    if t.shape[0] != axis.size:
        raise ValueError(f"all_to_all over the {axis.name} axis of size "
                         f"{axis.size} needs a leading dim of that size, got "
                         f"{tuple(t.shape)}")
    if _needs_grad(t):
        return _AllToAll.apply(t, axis)
    return _exchange(t, axis, f"all_to_all {axis.name}")


def all_reduce_world(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Σ of ``t`` over every rank of the mesh, in place: the train step's
    one all-reduce of the flattened gradients and the loss (Alg. 5's
    MPI_All_reduce).  gloo and NCCL hand every rank the same reduced
    bytes, so the ranks' Adam updates stay equal bit for bit."""
    if mesh.dp * mesh.sp > 1:
        _no_grad_operand(t, "all_reduce_world")
        _record(mesh.traffic, "all_reduce world", t)
        if _moves(SHAPE_ONLY if mesh.shape_only else None, t):
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


class _PooledSum(torch.autograd.Function):
    """Σ over the axis (``lax.psum``) with its transpose: each rank's
    loss reads the sum, so the gradient of every rank's operand is the
    sum of the ranks' gradients of the sum, all-reduced again."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_sum(x.detach().clone(
            memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.clone(
            memory_format=torch.contiguous_format), ctx.axis), None


class _PartialSumColumns(torch.autograd.Function):
    """The (B, K, N) row-block partials summed over the axis, then this
    rank's Nl columns (Alg. 2 line 12).  Its transpose: every rank's
    partial fed every rank's columns, so a partial's gradient is the
    ranks' column gradients all-gathered along the columns."""

    @staticmethod
    def forward(ctx, partial, axis):
        ctx.axis = axis
        full = all_reduce_sum(partial.detach().clone(
            memory_format=torch.contiguous_format), axis)
        return full[:, :, axis.rows(full.shape[2])]

    @staticmethod
    def backward(ctx, grad):
        return all_gather_tiled(grad, ctx.axis, 2), None


def pooled_sum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Σ of ``x`` over the ranks of ``axis``, as a new tensor whose
    gradient autograd sees (all-reduced again on the way back); ``x``
    itself when ``axis`` is None or of size 1."""
    if axis is None or axis.size == 1:
        return x
    return _PooledSum.apply(x, axis)


def partial_sum_columns(partial: torch.Tensor,
                        axis: Optional[Axis]) -> torch.Tensor:
    """Σ over ``axis`` of the (B, K, N) partials, then this rank's Nl
    columns, differentiable; ``partial`` itself when ``axis`` is None or
    of size 1 (the partial is then the whole sum)."""
    if axis is None or axis.size == 1:
        return partial
    return _PartialSumColumns.apply(partial, axis)


class _CopyToAxis(torch.autograd.Function):
    """Megatron's f: the identity, whose gradient is summed over the
    axis."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad.clone(memory_format=torch.contiguous_format),
                    ctx.axis, f"all_reduce {ctx.axis.name} backward"), None


class _ReduceFromAxis(torch.autograd.Function):
    """Megatron's g: Σ over the axis, whose gradient is the identity."""

    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x.detach().clone(memory_format=torch.contiguous_format),
                    axis, f"all_reduce {axis.name}")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_axis(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x``, replicated over ``axis``, entering work split over it (on
    the LM mesh the tokens and the router before the experts of
    ``model``, a layer's input before its heads or d_ff columns, the
    final hidden before the head's vocabulary block, a whole weight a
    rank reads only in part): the identity, whose gradient is the sum of
    the ranks' partial gradients (``shard_map``'s transpose of an input
    its spec leaves unsplit)."""
    if axis.size == 1 or not _needs_grad(x):
        return x
    return _CopyToAxis.apply(x, axis)


def reduce_from_axis(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Σ over ``axis`` of the ranks' partials into a value replicated over
    it, whose gradient passes to each partial unchanged (the loss is
    replicated, so its cotangent already is).  Without a gradient the sum
    is taken in place in a contiguous ``x``."""
    if axis.size == 1:
        return x
    if not _needs_grad(x):
        return all_reduce_sum(x.contiguous(), axis)
    return _ReduceFromAxis.apply(x, axis)


def broadcast_first(ts: Sequence[torch.Tensor], axis: Axis) -> None:
    """Each tensor of ``ts`` (contiguous) overwritten in place by the first
    rank's of ``axis``, one broadcast a tensor, counted as
    ``grad_broadcast <axis>``: the ranks then hold the same bits, where
    each computed its own from the same inputs by kernels whose bits may
    differ between processes."""
    if axis.size == 1:
        return
    src = None if axis.group is SHAPE_ONLY else \
        dist.get_global_rank(axis.group, 0)
    for t in ts:
        _record(axis.traffic, f"grad_broadcast {axis.name}", t)
        if _moves(axis.group, t):
            dist.broadcast(t, src, group=axis.group)


def all_reduce_grads(grads: Sequence[torch.Tensor],
                     axes: Sequence[Axis]) -> List[torch.Tensor]:
    """Each gradient summed over the ranks of every axis of ``axes`` (the
    LM mesh's data axes), one all-reduce a leaf and an axis, counted as
    ``grad_all_reduce <axis>``: no flattened copy of the gradients, which
    at full width would be a second set of them.  Returns the summed
    leaves (each ``grads`` leaf itself where it is contiguous)."""
    out = [g.contiguous() for g in grads]
    for ax in axes:
        if ax.size > 1:
            for g in out:
                _sum(g, ax, f"grad_all_reduce {ax.name}")
    return out


# ---------------------------------------------------------------------------
# The plan channel: rank 0's plans to the other ranks of a mesh service.
# ---------------------------------------------------------------------------

PLAN_POLL_S = (1e-4, 5e-3)    # a follower's first and longest store poll


class PlanChannel:
    """Rank 0's plans to the other ranks of a mesh, in order: a service's
    one planner (``serving.service``) sends each dispatch's plan before
    any collective of that dispatch runs.

    A plan is a small JSON header and an optional flat float32 payload.
    The header goes to the key ``<name>/<number>`` of the default group's
    rendezvous store; the payload follows as one broadcast from rank 0
    over the world group.  A follower polls the store for the next key
    and joins the broadcast only once the key is there.  So an idle
    follower waits in no collective and outlives the group's timeout
    however long rank 0 plans nothing; a blocking gloo collective would
    raise once that timeout ran out.

    Every rank of the mesh builds its channel with the same ``name``, and
    the planner and the followers number their plans alike.  gloo
    broadcasts host tensors; under nccl the payload moves through
    ``device``.  ``stats`` counts this rank's plans, payload bytes and
    the seconds spent sending (rank 0) or receiving once the key was
    there (the others)."""

    def __init__(self, mesh: Mesh, name: str, device: DeviceLike):
        self.mesh = mesh
        self.prefix = f"repro_torch/plan/{name}/"
        self.store = distributed_c10d._get_default_store()
        self.device = (resolve_device(device) if dist.get_backend() == "nccl"
                       else torch.device("cpu"))
        self.number = 0
        self.stats = {"plans": 0, "payload_bytes": 0, "seconds": 0.0}

    def _next_key(self) -> str:
        key = f"{self.prefix}{self.number}"
        self.number += 1
        return key

    def _count(self, nbytes: int, t0: float) -> None:
        self.stats["plans"] += 1
        self.stats["payload_bytes"] += nbytes
        self.stats["seconds"] += time.perf_counter() - t0

    def send(self, header: dict, payload: Optional[np.ndarray] = None) -> None:
        """Rank 0: publish the next plan, then broadcast its payload."""
        t0 = time.perf_counter()
        size = 0 if payload is None else int(payload.size)
        self.store.set(self._next_key(), json.dumps(dict(header,
                                                         payload=size)))
        if size:
            buf = torch.from_numpy(np.ascontiguousarray(
                payload, np.float32)).to(self.device)
            _record(self.mesh.traffic, "broadcast world", buf)
            dist.broadcast(buf, src=0)
        self._count(4 * size, t0)

    def recv(self) -> Tuple[dict, Optional[np.ndarray]]:
        """A follower: wait for rank 0's next plan, then receive its
        payload.  Returns (header, payload or None)."""
        key = self._next_key()
        delay, longest = PLAN_POLL_S
        while not self.store.check([key]):
            time.sleep(delay)
            delay = min(2 * delay, longest)
        t0 = time.perf_counter()
        header = json.loads(self.store.get(key))
        payload = None
        if header["payload"]:
            buf = torch.empty(header["payload"], dtype=torch.float32,
                              device=self.device)
            _record(self.mesh.traffic, "broadcast world", buf)
            dist.broadcast(buf, src=0)
            payload = buf.cpu().numpy()
        self._count(4 * header["payload"], t0)
        return header, payload


# ---------------------------------------------------------------------------
# Placement (shard_batch / shard_state).
# ---------------------------------------------------------------------------

def _tensor_fields(state) -> List[str]:
    return [f.name for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)]


def shard_batch(mesh: Mesh, state):
    """This rank's B/dp batch rows of every tensor of ``state`` (a batch or
    state dataclass), node rows whole: the layout of the CSR solve and of
    the masks of every rep."""
    b = getattr(state, _tensor_fields(state)[0]).shape[0]
    rows = mesh.data.rows(b)
    return dataclasses.replace(state, **{
        name: getattr(state, name)[rows] for name in _tensor_fields(state)})


def shard_nodes(mesh: Mesh, state):
    """This graph rank's N/sp node rows of the topology of ``state`` (dense
    ``adj``, sparse ``neighbors``/``valid``); ``solution``/``candidate``
    stay whole over the nodes.  The tile records the graph axis its rows
    are split over (``state.axis``).  CSR arrays have no equal node-row
    split (``engine._check_csr_spatial``)."""
    topo = [name for name in _tensor_fields(state) if name in _TOPOLOGY_ROWS]
    if not topo:
        if mesh.sp > 1:
            raise ValueError(f"{type(state).__name__} has no node rows to "
                             f"split over the graph axis (sp={mesh.sp})")
        return state
    rows = mesh.graph.rows(getattr(state, topo[0]).shape[1])
    return dataclasses.replace(state, axis=mesh.graph, **{
        name: getattr(state, name)[:, rows] for name in topo})


def shard_state(mesh: Mesh, state):
    """This rank's tile of a whole-batch ``state``: its B/dp batch rows
    (:func:`shard_batch`) and N/sp topology rows (:func:`shard_nodes`)."""
    return shard_nodes(mesh, shard_batch(mesh, state))


def shard_dataset(mesh: Mesh, source, *, device: DeviceLike = "cuda"):
    """This rank's tile of a training dataset (``rep.prepare_dataset``'s
    source) on ``device``: every graph, on every data rank, and the graph
    rank's N/sp node rows of a dense (G, N, N) stack or of a
    ``SparseGraphBatch``'s lists (JAX's ``DATASET_SPEC = P(None, graph,
    None)``).  CSR arrays have no equal row split and stay whole (sp = 1
    only, ``engine._check_csr_spatial``)."""
    dev = resolve_device(device)
    if isinstance(source, torch.Tensor):
        return source[:, mesh.graph.rows(source.shape[1])].to(dev) \
            .contiguous()
    fields = _tensor_fields(source)
    topo = [f for f in fields if f in _TOPOLOGY_ROWS]
    rows = (mesh.graph.rows(getattr(source, topo[0]).shape[1]) if topo
            else slice(None))
    if not topo and mesh.sp > 1:
        raise ValueError(f"{type(source).__name__} has no node rows to "
                         f"split over the graph axis (sp={mesh.sp})")
    return dataclasses.replace(source, **{
        f: (getattr(source, f)[:, rows] if f in topo else getattr(source, f))
        .to(dev).contiguous() for f in fields})


def local_rows(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """This rank's block of the node dimension (dim 1) of a whole
    ``x``; ``x`` itself when ``axis`` is None."""
    return x if axis is None else x[:, axis.rows(x.shape[1])]


def gather_rows(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The whole node dimension (dim 1) from each rank's block of it; ``x``
    itself when ``axis`` is None."""
    return x if axis is None else all_gather_tiled(x, axis, 1)


# ---------------------------------------------------------------------------
# §5.2 memory model on the 2-D mesh: batch divided by dp, node rows by sp.
# ---------------------------------------------------------------------------

def per_device_bytes(n: int, b: int, rho: float, p: int,
                     replay_tuples: int = 0, dp: int = 1) -> dict:
    """Paper §5.2 memory model, per device, on the (dp, sp=p) mesh:
    sparse-COO adjacency 20·N²·ρ·B/(dp·sp) bytes, masks 4·N·B/(dp·sp)
    each, replay 8·R·(N/sp + 1)/dp."""
    return {
        "adjacency": 20.0 * n * n * rho * b / (p * dp),
        "solution": 4.0 * n * b / (p * dp),
        "candidates": 4.0 * n * b / (p * dp),
        "replay": 8.0 * replay_tuples * (n / p + 1) / dp,
    }


def sparse_per_device_bytes(n: int, max_deg: int, b: int, p: int,
                            replay_tuples: int = 0, dp: int = 1) -> dict:
    """Padded edge-list storage per device on the (dp, sp=p) mesh: 4-byte
    neighbour ids + 1-byte validity per slot, masks as above."""
    return {
        "adjacency": 5.0 * n * max_deg * b / (p * dp),
        "solution": 4.0 * n * b / (p * dp),
        "candidates": 4.0 * n * b / (p * dp),
        "replay": 8.0 * replay_tuples * (n / p + 1) / dp,
    }


def minibatch_operand_bytes(n: int, minibatch: int, dp: int, sp: int,
                            collectives: str, rep: str = "dense",
                            max_deg: Optional[int] = None) -> dict:
    """Per-device live bytes of the GD loss operands inside one mesh GD
    iteration, JAX's numbers (``repro/core/mesh.py``) for every argument.
    The port's explicit path ("auto" and "manual") keeps every operand a
    tile: topology (M/dp, N/sp, ·), solution/candidate (M/dp, N/sp),
    action/target (M/dp,).  "gspmd" gives the JAX staged reference path's
    figure (its live operands replicated on a full 2-D mesh), which the
    port does not run."""
    staged = collectives == "gspmd" and dp > 1 and sp > 1
    ddp, dsp = (1, 1) if staged else (dp, sp)
    if rep == "dense":
        topo = 4.0 * minibatch * n * n / (ddp * dsp)
    else:
        d = max_deg if max_deg else n
        topo = 5.0 * minibatch * n * d / (ddp * dsp)
    out = {
        "topology": topo,
        "solution": 4.0 * minibatch * n / (ddp * dsp),
        # candidate is dead in the GD loss and never staged: tiled always
        "candidate": 4.0 * minibatch * n / (dp * sp),
        "tuples": 2 * 4.0 * minibatch / ddp,        # action + target
    }
    out["total"] = sum(out.values())
    return out


def csr_per_device_bytes(n: int, edges: int, b: int,
                         replay_tuples: int = 0, dp: int = 1) -> dict:
    """Flat CSR storage per device (DESIGN.md §13): 4-byte column ids +
    1-byte mask per directed edge slot plus the 4·(N+1) row pointers.  CSR
    shards the batch only (sp ≡ 1), so everything divides by dp alone."""
    return {
        "adjacency": (5.0 * edges + 4.0 * (n + 1)) * b / dp,
        "solution": 4.0 * n * b / dp,
        "candidates": 4.0 * n * b / dp,
        "replay": 8.0 * replay_tuples * (n + 1) / dp,
    }


# ---------------------------------------------------------------------------
# Starting ranks.
# ---------------------------------------------------------------------------

def rank_device(backend: str, device: DeviceLike, local_rank: int,
                local_world: int) -> torch.device:
    """The device of local rank ``local_rank`` of ``local_world`` ranks on
    this host: its own card under ``nccl`` (which refuses two ranks on one
    card), a card shared round-robin under ``gloo``, or the CPU (gloo
    only)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("backend='nccl' needs CUDA tensors; CPU ranks "
                             "take backend='gloo'")
        return dev
    count = torch.cuda.device_count()
    if backend == "nccl":
        if local_world > count:
            raise ValueError(
                f"backend='nccl' needs one card per rank: {local_world} "
                f"ranks on this host, {count} card(s). Ranks that share a "
                f"card take backend='gloo'")
        return torch.device("cuda", local_rank)
    return torch.device("cuda", local_rank % count)


def _rank_main(fn, rank: int, dp: int, sp: int, device, backend: str,
               store_path: str, timeout_s: float, group_timeout_s: float,
               results, args) -> None:
    """Body of one spawned rank: meet the others in the store (within
    ``timeout_s``, so a short group timeout does not also bound how much
    later than the first rank the last one starts), join the group, build
    the mesh, run ``fn(mesh, device, *args)`` and report its result or
    traceback."""
    torch.set_num_threads(1)
    try:
        world = dp * sp
        dev = rank_device(backend, device, rank, world)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        store.set_timeout(datetime.timedelta(seconds=timeout_s))
        store.add("repro_torch/started", 1)
        while store.add("repro_torch/started", 0) < world:
            time.sleep(0.01)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=group_timeout_s))
        try:
            out = fn(make_mesh(dp, sp), dev, *args)
        finally:
            destroy_meshes()
        results.put((rank, True, out))
    except BaseException:                 # reported to the parent, who raises
        results.put((rank, False, traceback.format_exc()))


TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def join_torchrun(backend: str, device: DeviceLike
                  ) -> Tuple[int, torch.device]:
    """Join the process group that ``torchrun`` describes in the
    environment (``TORCHRUN_VARS`` and its rendezvous) on this rank's
    device (:func:`rank_device`), which becomes the current card.  Returns
    (rank, device)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(backend, device, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return rank, dev


def spawn_mesh(fn: Callable, dp: int, sp: int, *, device: DeviceLike,
               backend: str, timeout_s: float = 60.0,
               group_timeout_s: Optional[float] = None,
               args: Sequence = ()) -> list:
    """Run ``fn(mesh, device, *args)`` on a (dp, sp) mesh of dp·sp local
    processes and return each rank's result, by rank.

    The ranks start with the ``spawn`` method (a parent that has touched
    CUDA cannot fork) and meet through a ``FileStore`` in a temporary
    directory, so no TCP port is chosen.  ``fn`` and ``args`` are pickled:
    ``fn`` must be importable at module level.  Any rank's exception is
    raised here with its traceback; if the ranks have not all reported
    within ``timeout_s`` seconds (a hung collective), every rank is killed
    and ``TimeoutError`` raised.  ``group_timeout_s`` (default
    ``timeout_s``) is the process group's own timeout, after which a rank
    waiting in a collective raises."""
    world = dp * sp
    rank_device(backend, device, 0, world)          # refuse before spawning
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, dp, sp, str(device), backend, os.path.join(tmp, "store"),
            timeout_s, group_timeout_s or timeout_s, results, tuple(args)))
            for r in range(world)]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    late = sorted(set(range(world)) - set(out))
                    raise TimeoutError(f"mesh ({dp}, {sp}): rank(s) {late} "
                                       f"did not finish within {timeout_s} "
                                       f"s; killed")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_lib.Empty:
                    # a rank reports before it exits 0: these died
                    dead = [r for r, p in enumerate(procs) if r not in out
                            and p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        raise RuntimeError(
                            f"mesh ({dp}, {sp}): rank(s) {dead} exited "
                            f"(codes {[procs[r].exitcode for r in dead]}) "
                            f"without a result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of mesh ({dp}, {sp}) "
                                       f"failed:\n{payload}")
                out[rank] = payload
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 5.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return [out[r] for r in range(world)]
