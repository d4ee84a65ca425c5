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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .graphs import residual_adjacency


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
    """The ring buffer of compressed tuples on the device."""
    graph_idx: torch.Tensor        # (R,)   int32
    solution: torch.Tensor         # (R, N) bool
    action: torch.Tensor           # (R,)   int32
    target: torch.Tensor           # (R,)   float32
    reward: torch.Tensor           # (R,)   float32
    next_solution: torch.Tensor    # (R, N) bool
    done: torch.Tensor             # (R,)   bool
    size: int = 0
    ptr: int = 0

    @property
    def capacity(self) -> int:
        return self.graph_idx.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.solution.shape[1]

    @property
    def device(self) -> torch.device:
        return self.graph_idx.device

    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in _FIELDS)


_DTYPES = dict(graph_idx=torch.int32, solution=torch.bool,
               action=torch.int32, target=torch.float32,
               reward=torch.float32, next_solution=torch.bool,
               done=torch.bool)


def device_replay_init(capacity: int, num_nodes: int, *,
                       device: DeviceLike = "cuda") -> DeviceReplay:
    dev = resolve_device(device)
    return DeviceReplay(**{
        f: torch.zeros((capacity, num_nodes) if f in ("solution",
                                                      "next_solution")
                       else (capacity,), dtype=_DTYPES[f], device=dev)
        for f in _FIELDS})


def device_replay_push(rb: DeviceReplay, graph_idx, solution, action,
                       target, reward, next_solution, done) -> DeviceReplay:
    """Insert B tuples at slots ``(ptr + arange(B)) % R``, in place.
    Requires B ≤ R, so no slot is written twice.  Returns ``rb``."""
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
