"""Compressed experience replay (paper §4.4).  Counterpart of
``repro/core/replay.py``.

Each tuple stores only ``(graph index, partial-solution mask S, action,
target, reward, S', done)``, never an adjacency; ``tuples_to_graphs``
(Tuples2Graphs, Alg. 5 line 21) re-materializes the residual graphs from
the dataset at training time.  Two buffers hold the same layout:

- :class:`ReplayBuffer`: a numpy ring on the host, the port's own copy of
  the JAX package's (the host training loop's buffer);
- :class:`DeviceReplay`: the same ring as torch tensors on the device,
  mutated in place by the fused train step (``core.engine``).  Its
  ``size`` and ``ptr`` follow from the push sizes alone, so they are host
  ints: the warm test and the sampler's bound read no device memory.

Both gather by explicit indices (``sample_at``, :func:`device_replay_at`),
so a caller that controls the index stream sees identical tuples.

On a ``(data, graph)`` mesh (``device_replay_init(mesh=)``) each rank
holds its (R/dp, N/sp) tile of the one global ring, JAX's replay
placement (``repro/core/mesh.py:_REPLAY_FIELD_SPECS``): tuple rows over
``data``, the two solution masks also over ``graph``.  Global row i holds
what one device's ring holds at i: a push all-gathers the episode's
tuples over ``data`` and each rank writes the rows it owns, and a sample
(:func:`sharded_replay_rows`) gives every rank its B/dp rows of the
minibatch whichever rank owns them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .graphs import residual_adjacency
from .mesh import Mesh, all_gather_tiled


@dataclasses.dataclass
class ReplayBuffer:
    capacity: int
    num_nodes: int
    size: int = 0
    _ptr: int = 0

    def __post_init__(self):
        n, r = self.num_nodes, self.capacity
        self.graph_idx = np.zeros((r,), np.int32)
        self.solution = np.zeros((r, n), bool)
        self.action = np.zeros((r,), np.int32)
        self.target = np.zeros((r,), np.float32)     # stored mode (Alg. 5 l.12)
        self.reward = np.zeros((r,), np.float32)     # fresh mode
        self.next_solution = np.zeros((r, n), bool)
        self.done = np.zeros((r,), bool)

    def push(self, graph_idx: int, solution, action: int, target: float,
             reward: float = 0.0, next_solution=None,
             done: bool = False) -> None:
        """Insert one tuple at the ring pointer."""
        i = self._ptr
        self.graph_idx[i] = graph_idx
        self.solution[i] = np.asarray(solution) > 0.5
        self.action[i] = action
        self.target[i] = target
        self.reward[i] = reward
        if next_solution is not None:
            self.next_solution[i] = np.asarray(next_solution) > 0.5
        self.done[i] = done
        self._ptr = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def push_batch(self, graph_idx, solution, action, target,
                   reward=None, next_solution=None, done=None) -> None:
        """Insert B tuples at the ring pointer, wrapping modulo the
        capacity (the last writer wins where B exceeds it)."""
        gi = np.atleast_1d(np.asarray(graph_idx, np.int32))
        b = len(gi)
        idx = (self._ptr + np.arange(b)) % self.capacity
        self.graph_idx[idx] = gi
        self.solution[idx] = np.atleast_2d(np.asarray(solution)) > 0.5
        self.action[idx] = np.atleast_1d(np.asarray(action, np.int32))
        self.target[idx] = np.atleast_1d(np.asarray(target, np.float32))
        self.reward[idx] = (0.0 if reward is None else
                            np.atleast_1d(np.asarray(reward, np.float32)))
        self.next_solution[idx] = (
            False if next_solution is None
            else np.atleast_2d(np.asarray(next_solution)) > 0.5)
        self.done[idx] = (False if done is None
                          else np.atleast_1d(np.asarray(done)) > 0)
        self._ptr = int((self._ptr + b) % self.capacity)
        self.size = min(self.size + b, self.capacity)

    def sample(self, batch: int, rng: np.random.Generator):
        """``batch`` tuples drawn uniformly, with replacement, over the
        warm region [0, size) by ``rng.integers``: the host loop's
        minibatch, in ``sample_at``'s layout."""
        return self.sample_at(rng.integers(0, self.size, size=batch))

    def sample_at(self, idx):
        """The tuples at ``idx``: (graph_idx, S, action, stored target,
        reward, S', done), masks as float32."""
        idx = np.asarray(idx)
        return (self.graph_idx[idx], self.solution[idx].astype(np.float32),
                self.action[idx], self.target[idx], self.reward[idx],
                self.next_solution[idx].astype(np.float32), self.done[idx])

    def nbytes(self) -> int:
        """Storage of the tuple arrays (§5.2's 8R(N/P + 1) estimate)."""
        return sum(getattr(self, f).nbytes for f in _FIELDS)


_FIELDS = ("graph_idx", "solution", "action", "target", "reward",
           "next_solution", "done")


@dataclasses.dataclass
class DeviceReplay:
    """The ring buffer of compressed tuples on the device; on a mesh this
    rank's (R/dp, N/sp) tile of it, ``size`` and ``ptr`` the global
    ring's."""
    graph_idx: torch.Tensor        # (R,)   int32
    solution: torch.Tensor         # (R, N) bool
    action: torch.Tensor           # (R,)   int32
    target: torch.Tensor           # (R,)   float32
    reward: torch.Tensor           # (R,)   float32
    next_solution: torch.Tensor    # (R, N) bool
    done: torch.Tensor             # (R,)   bool
    size: int = 0
    ptr: int = 0
    mesh: Optional[Any] = None     # core.mesh.Mesh of a sharded ring

    @property
    def capacity(self) -> int:
        return self.graph_idx.shape[0] * (self.mesh.dp if self.mesh else 1)

    @property
    def num_nodes(self) -> int:
        return self.solution.shape[1] * (self.mesh.sp if self.mesh else 1)

    @property
    def device(self) -> torch.device:
        return self.graph_idx.device

    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in _FIELDS)


def device_replay_from_host(rb: ReplayBuffer, *,
                            device: DeviceLike = "cuda") -> DeviceReplay:
    """A host ring's contents, ``size`` and pointer as a device ring on
    ``device`` (warm starts, parity tests)."""
    dev = resolve_device(device)
    return DeviceReplay(size=rb.size, ptr=rb._ptr, **{
        f: torch.from_numpy(getattr(rb, f)).to(dev) for f in _FIELDS})


_DTYPES = dict(graph_idx=torch.int32, solution=torch.bool,
               action=torch.int32, target=torch.float32,
               reward=torch.float32, next_solution=torch.bool,
               done=torch.bool)


def device_replay_init(capacity: int, num_nodes: int, *,
                       device: DeviceLike = "cuda",
                       mesh: Optional[Mesh] = None) -> DeviceReplay:
    """An empty ring of ``capacity`` tuples over ``num_nodes`` nodes; with
    ``mesh``, this rank's (capacity/dp, num_nodes/sp) tile of it."""
    dev = resolve_device(device)
    rows, cols = capacity, num_nodes
    if mesh is not None:
        if capacity % mesh.dp:
            raise ValueError(f"replay capacity {capacity} not divisible by "
                             f"the data-axis size {mesh.dp} of the mesh")
        rows, cols = capacity // mesh.dp, num_nodes // mesh.sp
        mesh.graph.rows(num_nodes)                  # refuses a ragged split
    return DeviceReplay(mesh=mesh, **{
        f: torch.zeros((rows, cols) if f in _MASKS else (rows,),
                       dtype=_DTYPES[f], device=dev)
        for f in _FIELDS})


_MASKS = ("solution", "next_solution")


def device_replay_push(rb: DeviceReplay, graph_idx, solution, action,
                       target, reward, next_solution, done) -> DeviceReplay:
    """Insert B tuples at slots ``(ptr + arange(B)) % R``, in place.
    Requires B ≤ R, so no slot is written twice.  Returns ``rb``.  On a
    mesh the arguments are this rank's B/dp episode rows, the masks whole
    over the nodes: :func:`_push_sharded`."""
    if rb.mesh is not None:
        return _push_sharded(rb, graph_idx, solution, action, target,
                             reward, next_solution, done)
    b = graph_idx.shape[0]
    cap = rb.capacity
    if b > cap:
        raise ValueError(f"batch {b} exceeds replay capacity {cap}")
    idx = (torch.arange(b, device=rb.device) + rb.ptr) % cap
    for name, value in (("graph_idx", graph_idx), ("action", action),
                        ("target", target), ("reward", reward)):
        getattr(rb, name).index_copy_(0, idx, value.to(_DTYPES[name]))
    for name, value in (("solution", solution),
                        ("next_solution", next_solution)):
        getattr(rb, name).index_copy_(0, idx, value > 0.5)
    rb.done.index_copy_(0, idx, done > 0)
    rb.ptr = (rb.ptr + b) % cap
    rb.size = min(rb.size + b, cap)
    return rb


def _pack(fields) -> torch.Tensor:
    """(rows, F) float32 holding each (rows,) or (rows, cols) field in
    turn; int32 fields travel as their bits (``view``), bool as 0/1, so a
    copy of the packed rows (all-gather, index) restores them exactly."""
    cols = []
    for t in fields:
        if t.dtype == torch.int32:
            t = t.view(torch.float32)
        t = t.to(torch.float32)
        cols.append(t if t.dim() == 2 else t[:, None])
    return torch.cat(cols, 1)


def _unpack(packed: torch.Tensor, like):
    """The fields of :func:`_pack`'s rows, one per (dtype, width) of
    ``like`` (width 0 for a (rows,) field)."""
    out, at = [], 0
    for dtype, width in like:
        t = packed[:, at:at + max(width, 1)]
        at += max(width, 1)
        t = t if width else t[:, 0]
        if dtype == torch.int32:
            t = t.contiguous().view(torch.int32)
        elif dtype == torch.bool:
            t = t > 0.5
        out.append(t)
    return out


def _owned_runs(ptr: int, b: int, cap: int, lo: int, per: int):
    """(tile row, pushed row, count) of the contiguous runs of global ring
    rows ``(ptr + j) % cap``, j < b, that fall in the tile [lo, lo +
    per): host arithmetic, at most two runs."""
    runs = [(ptr, 0, min(b, cap - ptr))]
    if ptr + b > cap:
        runs.append((0, cap - ptr, ptr + b - cap))
    out = []
    for start, j0, count in runs:
        a, e = max(start, lo), min(start + count, lo + per)
        if a < e:
            out.append((a - lo, j0 + a - start, e - a))
    return out


def _push_sharded(rb: DeviceReplay, graph_idx, solution, action, target,
                  reward, next_solution, done) -> DeviceReplay:
    """The push on a mesh: this rank's episode rows, with its graph rank's
    mask columns, are all-gathered over ``data`` (B·(2N/sp + 5) values),
    and each rank writes the global rows ``(ptr + j) % R`` that fall in
    its tile, so global row i holds what one device's ring holds."""
    mesh = rb.mesh
    cols = mesh.graph.rows(solution.shape[1])
    rows = all_gather_tiled(_pack([
        graph_idx.to(torch.int32), solution[:, cols] > 0.5,
        action.to(torch.int32), target.to(torch.float32),
        reward.to(torch.float32), next_solution[:, cols] > 0.5, done > 0]),
        mesh.data, 0)
    b, cap = rows.shape[0], rb.capacity
    if b > cap:
        raise ValueError(f"batch {b} exceeds replay capacity {cap}")
    per = rb.graph_idx.shape[0]
    values = _unpack(rows, [(_DTYPES[f], rb.solution.shape[1]
                             if f in _MASKS else 0) for f in _FIELDS])
    for at, j, count in _owned_runs(rb.ptr, b, cap, mesh.data.index * per,
                                    per):
        for f, v in zip(_FIELDS, values):
            getattr(rb, f)[at:at + count] = v[j:j + count]
    rb.ptr = (rb.ptr + b) % cap
    rb.size = min(rb.size + b, cap)
    return rb


def sharded_replay_rows(rb: DeviceReplay, idx: torch.Tensor,
                        fields: Sequence[str]):
    """The minibatch tile of a sharded ring: for the (M,) global indices
    ``idx`` (the same on every rank), this rank's M/dp rows of the named
    fields, masks as float32 over its graph rank's N/sp columns, ``done``
    as float32 (``device_replay_at``'s dtypes).  Each rank packs the rows
    it owns at every index (clamped where another rank owns it), one
    all-gather over ``data`` brings every owner's rows, and each index
    takes its owner's: JAX's masked-contribution exchange
    (``repro/core/spatial.py:_exchange``, a ``psum_scatter``) as copies,
    so every value arrives exactly."""
    mesh = rb.mesh
    per = rb.graph_idx.shape[0]
    mine = mesh.data.rows(idx.shape[0])
    safe = (idx.long() - mesh.data.index * per).clamp(0, per - 1)
    gathered = all_gather_tiled(_pack([getattr(rb, f)[safe]
                                       for f in fields]), mesh.data, 0)
    owner = idx.long()[mine] // per
    pos = torch.arange(mine.start, mine.stop, device=idx.device)
    rows = gathered.view(mesh.dp, idx.shape[0], -1)[owner, pos]
    out = _unpack(rows, [(_DTYPES[f], rb.solution.shape[1]
                          if f in _MASKS else 0) for f in fields])
    return [t.to(torch.float32) if t.dtype == torch.bool else t for t in out]


def device_replay_at(rb: DeviceReplay, idx: torch.Tensor):
    """The tuples at ``idx`` (a device tensor), as ``ReplayBuffer.sample_at``
    gives them but with ``done`` as float32 too."""
    return (rb.graph_idx[idx], rb.solution[idx].to(torch.float32),
            rb.action[idx], rb.target[idx], rb.reward[idx],
            rb.next_solution[idx].to(torch.float32),
            rb.done[idx].to(torch.float32))


def device_replay_sample_idx(rb: DeviceReplay, generator: torch.Generator,
                             batch: int) -> torch.Tensor:
    """``batch`` uniform indices over the warm region [0, size), drawn on
    the device from ``generator`` (with replacement)."""
    return torch.randint(0, max(rb.size, 1), (batch,), generator=generator,
                         device=rb.device)


def device_replay_sample(rb: DeviceReplay, generator: torch.Generator,
                         batch: int):
    return device_replay_at(rb, device_replay_sample_idx(rb, generator,
                                                         batch))


def tuples_to_graphs(adj_stack: torch.Tensor, graph_idx: torch.Tensor,
                     solutions: torch.Tensor) -> torch.Tensor:
    """Tuples2Graphs: the (B, N, N) residual adjacencies of B tuples from
    the (G, N, N) dataset."""
    return residual_adjacency(adj_stack[graph_idx.long()], solutions)
