"""What one step of the port does, counted from the ops it dispatches:
the port's stand-in for XLA's ``cost_analysis()`` and
``memory_analysis()``, which ``launch.dryrun`` reads on the meta device.

:class:`CountMode` is one ``TorchDispatchMode``.  Run a step under it (on
meta tensors, which propagate shapes and compute nothing, or on real
ones: the counts read only shapes, dtypes and storage lifetimes, never
the device) and it gives:

- ``flops``: the FLOPs of the matmuls, by ``torch.utils.flop_counter``'s
  registry (mm, addmm, bmm, baddbmm, convolutions, fused attention; 2 a
  multiply-add).  Elementwise work, reductions, softmax, scans and
  gathers are not counted, so this is a floor on the step's operations.
- ``bytes``: every dispatched op's input and output bytes, unfused, as
  XLA counts bytes accessed.  A view moves nothing; an ``empty`` writes
  nothing; an output written into an input (an in-place or ``out=`` op)
  is counted once, as written; an input is counted at most at its
  storage's bytes, so a broadcast reads its storage once.  Caches and
  fusion are not modelled: a fused kernel moves fewer bytes.
- ``peak``: the high-water mark of the bytes of the storages the step
  made that are alive at once, tracked by weak references to the
  storages.  Storages alive before the mode started (the step's
  arguments) are not in it: add their bytes for the step's peak.  Memory
  a backend takes outside the dispatched ops (a GEMM library's
  workspace, a sort's scratch) is not seen.

Under the count every kernel wrapper of the port takes its plain version
(a meta or CPU tensor), so ``flops``, ``bytes`` and ``peak`` are the
plain versions' where the card would launch a kernel.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_ATEN = torch.ops.aten
# allocations that write nothing
_NO_WRITE = (_ATEN.empty, _ATEN.empty_like, _ATEN.empty_strided,
             _ATEN.new_empty, _ATEN.new_empty_strided)
TOP = 8                       # live storages kept of the peak


@dataclasses.dataclass
class Counts:
    """A counted run: matmul ``flops``, ``bytes`` accessed, the ``peak``
    bytes of the storages it made alive at once, the dispatched ``ops``,
    and ``top``, the largest storages alive at (within 1/64 of) the peak
    as (bytes, op that made it, shape, dtype)."""
    flops: int = 0
    bytes: int = 0
    peak: int = 0
    ops: int = 0
    top: List[Tuple[int, str, tuple, str]] = dataclasses.field(
        default_factory=list)


def _tensors(xs, out: list) -> list:
    """The tensors among ``xs`` and in its nested lists and tuples (an
    op's arguments and results hold no other containers)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _read_bytes(t: torch.Tensor) -> int:
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


_WRITES: Dict[Any, bool] = {}


def _writes(func) -> bool:
    """Whether ``func`` writes into one of its arguments (``Tensor(a!)``)."""
    w = _WRITES.get(func)
    if w is None:
        w = _WRITES[func] = any(a.alias_info is not None
                                and a.alias_info.is_write
                                for a in func._schema.arguments)
    return w


class CountMode(TorchDispatchMode):
    """Counts the ops dispatched while it is on (module docstring).
    ``counts`` holds the totals so far.  A storage's death is queued by its
    finalizer and taken off the live bytes at the next op, before that
    op's own storages are added, so the peak follows program order."""

    def __init__(self):
        super().__init__()
        self.counts = Counts()
        self._live: Dict[int, Tuple[int, str, tuple, str]] = {}
        self._live_bytes = 0
        self._snap_at = 0
        self._freed = collections.deque()

    def _drain(self) -> None:
        while self._freed:
            self._live_bytes -= self._live.pop(self._freed.popleft())[0]

    def _made(self, t: torch.Tensor, name: str) -> None:
        st = t.untyped_storage()
        key, nbytes = st._cdata, st.nbytes()
        self._live[key] = (nbytes, name, tuple(t.shape), str(t.dtype)[6:])
        self._live_bytes += nbytes
        c = self.counts
        if self._live_bytes > c.peak:
            c.peak = self._live_bytes
            if c.peak > self._snap_at + self._snap_at // 64:
                self._snap_at = c.peak
                c.top = sorted(self._live.values(), reverse=True)[:TOP]
        weakref.finalize(st, self._freed.append, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._drain()
        ins = list({id(t): t for t in _tensors(
            (args, tuple(kwargs.values())), [])}.values())
        outs = _tensors((out,), [])
        packet = func.overloadpacket
        c = self.counts
        c.ops += 1
        fl = flop_registry.get(packet)
        if fl is not None:
            c.flops += int(fl(*args, **kwargs, out_val=out))
        in_keys = {_key(t) for t in ins}
        written = set()
        nbytes = 0
        for t in outs:
            k = _key(t)
            if k in in_keys:
                if _writes(func):
                    written.add(k)
                    nbytes += t.numel() * t.element_size()
                continue                  # a view or alias of an input
            if k not in self._live:
                self._made(t, str(packet))
            if packet not in _NO_WRITE:
                nbytes += t.numel() * t.element_size()
        if not func.is_view:
            nbytes += sum(_read_bytes(t) for t in ins
                          if _key(t) not in written)
            c.bytes += nbytes
        return out

    def __exit__(self, *exc):
        self._drain()
        return super().__exit__(*exc)


def count(fn: Callable, *args, **kwargs) -> Tuple[Any, Counts]:
    """``fn(*args, **kwargs)`` under a :class:`CountMode`: (its result,
    the counts)."""
    with CountMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode.counts
