"""Carry policy weights and Adam states between the JAX package and the
port.

The JAX ``PolicyParams`` flattens to ``em.theta1..4`` and ``q.theta5..7``;
these are exactly the ``state_dict`` keys of :class:`Policy`.  An Adam
state crosses as ``step`` and its moments under ``mu.<key>`` and
``nu.<key>``.  An LM's parameter tree crosses as the same nested dicts and
lists of arrays on both sides (``models/lm.py``), bfloat16 leaves bit for
bit, and its Adam state as ``step`` and two such trees of moments.
Arrays cross as numpy, so neither side imports the other.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

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


def _is_bf16(arr: np.ndarray) -> bool:
    return "bfloat16" in str(arr.dtype)


def _lm_leaf(path: str, arr, want, device) -> torch.Tensor:
    """One parameter as a tensor on ``device``; ``want`` is its (shape,
    dtype) in the port's tree.  A bfloat16 leaf crosses as its bits."""
    shape, dtype = want
    arr = np.asarray(arr)
    if tuple(arr.shape) != shape:
        raise ValueError(f"{path}: shape {tuple(arr.shape)}, expected "
                         f"{shape} for this config")
    if dtype == torch.bfloat16:
        if not (_is_bf16(arr) or arr.dtype == np.uint16):
            raise TypeError(f"{path}: dtype {arr.dtype}, expected bfloat16 "
                            f"(or its uint16 bit pattern)")
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    if arr.dtype != np.float32:
        raise TypeError(f"{path}: dtype {arr.dtype}, expected float32")
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def _lm_tree(path: str, tree, want, device):
    if isinstance(want, dict):
        if not isinstance(tree, Mapping):
            raise TypeError(f"{path or 'params'}: expected a dict")
        _check_keys(path or "params", tree, want)
        return {k: _lm_tree(f"{path}.{k}" if path else k, tree[k], want[k],
                            device) for k in want}
    if isinstance(want, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(want):
            raise ValueError(f"{path}: expected a list of {len(want)}")
        return [_lm_tree(f"{path}[{i}]", t, w, device)
                for i, (t, w) in enumerate(zip(tree, want))]
    return _lm_leaf(path, tree, want, device)


def lm_params_from_numpy(tree, cfg, *, device: DeviceLike = "cuda"
                         ) -> Dict[str, Any]:
    """The port's LM parameter tree on ``device`` from the same tree of
    numpy arrays (JAX's ``init_params`` output through ``np.asarray``):
    every key, list length, shape and dtype checked against ``cfg``."""
    from .models.lm import param_shapes
    return _lm_tree("", tree, param_shapes(cfg), resolve_device(device))


def lm_params_to_numpy(params) -> Dict[str, Any]:
    """The LM parameter tree as numpy arrays: float32 leaves as float32,
    bfloat16 leaves bit for bit as ``ml_dtypes.bfloat16`` where that
    package is installed, else as their uint16 bit pattern (which
    :func:`lm_params_from_numpy` takes back)."""
    from .models.common import tree_map
    try:
        import ml_dtypes
        bf16 = ml_dtypes.bfloat16
    except ImportError:
        bf16 = np.uint16

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(bf16)
        return t.numpy().copy()
    return tree_map(leaf, params)


def _moment_dtype(arr) -> torch.dtype:
    """A moment leaf's dtype: float32, or bfloat16 (or its uint16 bits)."""
    arr = np.asarray(arr)
    if _is_bf16(arr) or arr.dtype == np.uint16:
        return torch.bfloat16
    return torch.float32


def lm_adam_from_numpy(state, cfg, *, device: DeviceLike = "cuda"):
    """The port's Adam state of an LM on ``device`` from JAX's (its
    ``AdamState`` through ``jax.tree.map(np.asarray, ...)``, or a mapping
    with ``step``, ``mu`` and ``nu``): every moment's path and shape
    checked against ``cfg``, each kept in its own dtype (f32 or bf16)."""
    from .models.common import tree_map
    from .models.lm import param_shapes
    get = state.get if isinstance(state, Mapping) else (
        lambda k: getattr(state, k))
    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def moments(tree, name):
        dtype = _moment_dtype(_first_leaf(tree))
        return _lm_tree(name, tree, tree_map(lambda w: (w[0], dtype),
                                             shapes), dev)
    step = torch.full((), int(np.asarray(get("step"))), dtype=torch.int32,
                      device=dev)
    return AdamState(step=step, mu=moments(get("mu"), "mu"),
                     nu=moments(get("nu"), "nu"))


def _first_leaf(tree):
    while isinstance(tree, (Mapping, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, Mapping) \
            else tree[0]
    return tree


def lm_adam_to_numpy(state: AdamState) -> Dict[str, Any]:
    """An LM's Adam state as {"step": int32, "mu": tree, "nu": tree} of
    numpy arrays, the moments as :func:`lm_params_to_numpy` gives them."""
    return {"step": np.asarray(int(state.step), np.int32),
            "mu": lm_params_to_numpy(state.mu),
            "nu": lm_params_to_numpy(state.nu)}
