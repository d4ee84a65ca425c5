"""Input checks shared by the kernel wrappers: every tensor on one device,
of an accepted dtype and contiguous, and the dispatch on that device (the
plain version on the CPU, the kernel on CUDA)."""
from __future__ import annotations

import torch


def check_tensors(ref: str, tensors: dict, int32=(),
                  floats=(torch.float32,)) -> None:
    """Every tensor on ``tensors[ref]``'s device, contiguous, int32 if its
    name is in ``int32`` and of a dtype in ``floats`` otherwise."""
    dev = tensors[ref].device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {ref} on {dev}")
        want = (torch.int32,) if name in int32 else floats
        if t.dtype not in want:
            raise TypeError(f"{name} must be "
                            f"{' or '.join(str(w)[6:] for w in want)}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def f32_inputs(ref: str, tensors: dict) -> list:
    """The tensors as float32, in order, after :func:`check_tensors` with
    float32 or bfloat16 accepted (bfloat16 is upcast exactly, as the JAX
    wrappers do)."""
    check_tensors(ref, tensors, floats=(torch.float32, torch.bfloat16))
    return [t.float() for t in tensors.values()]


def on_cpu(t: torch.Tensor, fn: str) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel runs); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on cpu or cuda, not {t.device}")
    return t.device.type == "cpu"
