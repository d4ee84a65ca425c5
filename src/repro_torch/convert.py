"""Carry policy weights between the JAX package and the port.

The JAX ``PolicyParams`` flattens to ``em.theta1..4`` and ``q.theta5..7``;
these are exactly the ``state_dict`` keys of :class:`Policy`.  Arrays cross
as numpy, so neither side imports the other.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .core.policy import Policy
from .core.qmodel import QModel
from .core.s2v import S2V
from .device import DeviceLike, resolve_device

POLICY_KEYS = ("em.theta1", "em.theta2", "em.theta3", "em.theta4",
               "q.theta5", "q.theta6", "q.theta7")


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 stored as its uint16 bit pattern → the same values as f32."""
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32)


def _as_f32(arr) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" or "bfloat16" in str(arr.dtype):
        return bf16_bits_to_f32(arr.view(np.uint16))
    return arr.astype(np.float32)


def _expected_shapes(k: int) -> Dict[str, tuple]:
    return {"em.theta1": (k,), "em.theta2": (k,), "em.theta3": (k, k),
            "em.theta4": (k, k), "q.theta5": (k, k), "q.theta6": (k, k),
            "q.theta7": (2 * k,)}


def policy_from_numpy(arrays: Mapping[str, np.ndarray], *,
                      device: DeviceLike = "cuda") -> Policy:
    """A :class:`Policy` on ``device`` holding ``arrays`` (keys
    ``em.theta1`` … ``q.theta7``) as float32."""
    missing = set(POLICY_KEYS) - set(arrays)
    extra = set(arrays) - set(POLICY_KEYS)
    if missing or extra:
        raise KeyError(f"policy arrays: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    k = int(np.asarray(arrays["em.theta1"]).shape[0])
    want = _expected_shapes(k)
    state = {}
    for key in POLICY_KEYS:
        arr = _as_f32(arrays[key])
        if arr.shape != want[key]:
            raise ValueError(f"{key}: shape {arr.shape}, expected "
                             f"{want[key]} for K={k}")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    dev = resolve_device(device)
    policy = Policy(S2V(k), QModel(k))
    policy.load_state_dict(state)
    return policy.to(dev)


def policy_to_numpy(policy: Policy) -> Dict[str, np.ndarray]:
    """The policy's weights as float32 numpy arrays under the JAX keys."""
    return {key: t.detach().cpu().numpy()
            for key, t in policy.state_dict().items()}
