"""Checkpoints in the JAX package's format (``repro/checkpoint``).

One ``ckpt_%08d.npz`` per step, each leaf under its ``jax.tree_util.keystr``
path (``.em.theta1`` … for a policy; ``[0]['embed']``, ``[1].nu['segments']
[0][5]['norm1']`` … for an LM's ``(params, AdamState)``), plus a
``__dtypes__`` JSON manifest stored as a uint8 array; bfloat16 leaves are
stored as their uint16 bit pattern.  A policy or an LM trained by the JAX
package can therefore be restored by the port, and a checkpoint the port
writes loads in the JAX package.

The generic half (:func:`save_checkpoint`, :func:`restore_checkpoint`)
takes a tree of tensors: nested dicts (``['key']``), lists and tuples
(``[i]``) and dataclasses (``.field``, as an ``AdamState``); the policy
helpers name the policy's parameters as JAX's ``PolicyParams`` does.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..convert import POLICY_KEYS, bf16_bits_to_f32, policy_from_numpy, \
    policy_to_numpy
from ..core.policy import Policy, PolicyConfig
from ..device import DeviceLike


def latest_step(directory) -> Optional[int]:
    ckpts = sorted(pathlib.Path(directory).glob("ckpt_*.npz"))
    if not ckpts:
        return None
    return int(re.search(r"ckpt_(\d+)", ckpts[-1].name).group(1))


def keyed_leaves(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a tree of tensors, each path as
    ``jax.tree_util.keystr`` names it, in JAX's flattening order (dict
    keys sorted)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                keyed_leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in
                keyed_leaves(t, f"{prefix}[{i}]")]
    if dataclasses.is_dataclass(tree):
        return [kv for f in dataclasses.fields(tree) for kv in
                keyed_leaves(getattr(tree, f.name), f"{prefix}.{f.name}")]
    return [] if tree is None else [(prefix, tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: built[k] for k in tree}      # the template's key order
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    return None if tree is None else next(leaves)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array to store, its true dtype): bfloat16 as its bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(directory, step: int, tree: Any, *,
                    keep: int = 3) -> pathlib.Path:
    """Snapshot ``tree`` (tensors) as step ``step``, keeping the newest
    ``keep``."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat, dtypes = {}, {}
    for key, leaf in keyed_leaves(tree):
        flat[key], dtypes[key] = _to_numpy(torch.as_tensor(leaf))
    flat["__dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(),
                                       dtype=np.uint8)
    path = directory / f"ckpt_{step:08d}.npz"
    np.savez(path, **flat)
    for old in sorted(directory.glob("ckpt_*.npz"))[:-keep]:
        old.unlink()
    return path


def restore_checkpoint(directory, template: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (a tree of tensors):
    each leaf takes the template leaf's dtype and device.  Returns (tree,
    step)."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    out = []
    with np.load(directory / f"ckpt_{step:08d}.npz") as data:
        dtypes = (json.loads(bytes(data["__dtypes__"]).decode())
                  if "__dtypes__" in data else {})
        for key, leaf in keyed_leaves(template):
            arr = data[key]
            if dtypes.get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} in the "
                                 f"checkpoint, {tuple(leaf.shape)} in the "
                                 f"template")
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return _rebuild(template, iter(out)), step


def save_policy(directory, step: int, policy: Policy, *,
                keep: int = 3) -> pathlib.Path:
    """Snapshot ``policy`` as step ``step``, keeping the newest ``keep``."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat, dtypes = {}, {}
    for key, arr in policy_to_numpy(policy).items():
        flat["." + key] = arr
        dtypes["." + key] = str(arr.dtype)
    flat["__dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(),
                                       dtype=np.uint8)
    path = directory / f"ckpt_{step:08d}.npz"
    np.savez(path, **flat)
    for old in sorted(directory.glob("ckpt_*.npz"))[:-keep]:
        old.unlink()
    return path


def load_policy(directory, cfg: PolicyConfig, step: Optional[int] = None,
                *, device: DeviceLike = "cuda") -> Tuple[Policy, int]:
    """Restore the policy for ``cfg`` from the newest (or an explicit)
    checkpoint onto ``device``.  Returns (policy, step)."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with np.load(directory / f"ckpt_{step:08d}.npz") as data:
        dtypes = (json.loads(bytes(data["__dtypes__"]).decode())
                  if "__dtypes__" in data else {})
        arrays = {}
        for key in POLICY_KEYS:
            arr = data["." + key]
            if dtypes.get("." + key) == "bfloat16":
                arr = bf16_bits_to_f32(arr)
            arrays[key] = arr
    if arrays["em.theta1"].shape[0] != cfg.embed_dim:
        raise ValueError(f"checkpoint has K={arrays['em.theta1'].shape[0]}, "
                         f"config embed_dim={cfg.embed_dim}")
    return policy_from_numpy(arrays, device=device), step
