"""Input checks shared by the kernel wrappers: every tensor on one device,
of an accepted dtype and contiguous, and the dispatch on that device (the
plain version on the CPU and on meta, the kernel on CUDA); and the
backward that the LM kernels' autograd Functions share
(``plain_grads``)."""
from __future__ import annotations

import torch
from torch.profiler import record_function


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
    """True for a CPU tensor (the plain version runs) and for a meta
    tensor (the plain version propagates shapes and computes nothing:
    ``launch.dryrun`` counts a step so), False for a CUDA tensor (the
    kernel runs); any other device raises."""
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{fn} runs on cpu, cuda or meta, not {t.device}")
    return t.device.type != "cuda"


def plain_grads(plain, ctx, cotangents) -> tuple:
    """The backward of an autograd Function whose forward is a kernel: the
    gradients of ``plain`` (its plain version, a function of the saved
    tensors in order) at ``ctx.saved_tensors``, recomputed under
    ``enable_grad``, by ``torch.autograd.grad`` of the outputs that have a
    cotangent (an output whose cotangent is None is left out), in the
    ``plain_backward`` profiler range.  One entry per saved tensor: None
    where no gradient is needed, or for a saved None."""
    saved = ctx.saved_tensors
    n = len(saved)
    pairs = [(o, g) for o, g in enumerate(cotangents) if g is not None]
    wanted = [i for i in range(n) if ctx.needs_input_grad[i]
              and saved[i] is not None]
    if not pairs or not wanted:
        return (None,) * n
    with torch.enable_grad(), record_function("plain_backward"):
        inputs = [None if t is None else t.detach().requires_grad_(
            i in wanted) for i, t in enumerate(saved)]
        outs = plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        got = torch.autograd.grad([outs[o] for o, _ in pairs],
                                  [inputs[i] for i in wanted],
                                  [g for _, g in pairs], allow_unused=True)
    grads = dict(zip(wanted, got))
    return tuple(grads.get(i) for i in range(n))
