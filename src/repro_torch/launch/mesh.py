"""Production and host meshes of the LM substrate.  Counterpart of
``repro/launch/mesh.py``.

Single pod: 16×16 = 256 ranks, axes (data, model).
Multi-pod:  2×16×16 = 512 ranks, axes (pod, data, model); the pod axis is
pure data parallelism.

The ranks are those of the default ``torch.distributed`` process group,
laid out row-major over the axes as JAX reshapes its device list
(``core.mesh.make_named_mesh``).  Functions, not module constants:
importing this module creates no process group.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from ..core.mesh import NamedMesh, make_named_mesh


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def production_layout(multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> NamedMesh:
    shape, axes = production_layout(multi_pod)
    nranks = 512 if multi_pod else 256
    have = _world()
    if have < nranks:
        raise RuntimeError(
            f"need {nranks} ranks for {'multi' if multi_pod else 'single'}"
            f"-pod mesh, have {have}; run under torchrun "
            f"(--nnodes ... --nproc-per-node ..., {nranks} ranks in all) on "
            f"real hardware")
    return make_named_mesh(shape, axes)


def make_host_mesh(p: Optional[int] = None) -> NamedMesh:
    """Small mesh for tests: (1, P) data×model over P ranks (the world's
    size when None; P = 1 needs no process group)."""
    p = _world() if p is None else p
    return make_named_mesh((1, p), ("data", "model"))
