"""Carry policy weights and Adam states between the JAX package and the
port.

The JAX ``PolicyParams`` flattens to ``em.theta1..4`` and ``q.theta5..7``;
these are exactly the ``state_dict`` keys of :class:`Policy`.  An Adam
state crosses as ``step`` and its moments under ``mu.<key>`` and
``nu.<key>``.  Arrays cross as numpy, so neither side imports the other.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .core.policy import Policy
from .core.qmodel import QModel
from .core.s2v import S2V
from .device import DeviceLike, resolve_device
from .optim import AdamState

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


def _check_keys(what: str, arrays: Mapping, keys) -> None:
    missing = set(keys) - set(arrays)
    extra = set(arrays) - set(keys)
    if missing or extra:
        raise KeyError(f"{what} arrays: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")


def _policy_tensors(arrays: Mapping[str, np.ndarray], prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    """``arrays[prefix + key]`` for every policy key as float32 CPU
    tensors, their shapes checked against K."""
    k = int(np.asarray(arrays[prefix + "em.theta1"]).shape[0])
    want = _expected_shapes(k)
    out = {}
    for key in POLICY_KEYS:
        arr = _as_f32(arrays[prefix + key])
        if arr.shape != want[key]:
            raise ValueError(f"{prefix}{key}: shape {arr.shape}, expected "
                             f"{want[key]} for K={k}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def policy_from_numpy(arrays: Mapping[str, np.ndarray], *,
                      device: DeviceLike = "cuda") -> Policy:
    """A :class:`Policy` on ``device`` holding ``arrays`` (keys
    ``em.theta1`` … ``q.theta7``) as float32."""
    _check_keys("policy", arrays, POLICY_KEYS)
    state = _policy_tensors(arrays)
    k = state["em.theta1"].shape[0]
    dev = resolve_device(device)
    policy = Policy(S2V(k), QModel(k))
    policy.load_state_dict(state)
    return policy.to(dev)


def policy_to_numpy(policy: Policy) -> Dict[str, np.ndarray]:
    """The policy's weights as float32 numpy arrays under the JAX keys."""
    return {key: t.detach().cpu().numpy()
            for key, t in policy.state_dict().items()}


ADAM_KEYS = ("step",) + tuple(f"{m}.{key}" for m in ("mu", "nu")
                              for key in POLICY_KEYS)


def adam_from_numpy(arrays: Mapping[str, np.ndarray], *,
                    device: DeviceLike = "cuda") -> AdamState:
    """An :class:`AdamState` on ``device`` from ``step`` and the float32
    moments ``mu.<key>``, ``nu.<key>`` of a policy's Adam state."""
    _check_keys("Adam state", arrays, ADAM_KEYS)
    dev = resolve_device(device)
    step = torch.full((), int(np.asarray(arrays["step"])), dtype=torch.int32,
                      device=dev)
    mu, nu = (_policy_tensors(arrays, f"{m}.") for m in ("mu", "nu"))
    return AdamState(step=step, mu={k: t.to(dev) for k, t in mu.items()},
                     nu={k: t.to(dev) for k, t in nu.items()})


def adam_to_numpy(state: AdamState) -> Dict[str, np.ndarray]:
    """The Adam state as numpy arrays under :data:`ADAM_KEYS`."""
    out = {"step": np.asarray(int(state.step), np.int32)}
    for m, moments in (("mu", state.mu), ("nu", state.nu)):
        out.update({f"{m}.{key}": moments[key].detach().cpu().numpy()
                    for key in POLICY_KEYS})
    return out
