"""Device resolution for every entry point of the port.

Entry points default to ``device="cuda"`` and raise when CUDA is absent:
nothing falls back to the CPU quietly.  Callers that want the CPU (the
CPU tests, the card-vs-CPU comparison) pass ``device="cpu"``.

Importing this module turns TF32 off for matmuls and cuDNN: the f32
products around the fused kernel (the θ3 base term, the Q-model einsums)
must stay true f32 to agree with the JAX reference.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU by default, and torch sees "
            "no CUDA device here. Pass device='cpu' to run on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # the index tensors report, so devices compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
