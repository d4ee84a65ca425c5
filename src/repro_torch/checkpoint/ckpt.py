"""Policy checkpoints in the JAX package's format (``repro/checkpoint``).

One ``ckpt_%08d.npz`` per step, each leaf under its ``jax.tree_util.keystr``
path (``.em.theta1`` …), plus a ``__dtypes__`` JSON manifest stored as a
uint8 array; bfloat16 leaves are stored as their uint16 bit pattern.  A
policy trained by the JAX package can therefore be served by the port, and
a checkpoint the port writes loads in the JAX package.
"""
from __future__ import annotations

import json
import pathlib
import re
from typing import Optional, Tuple

import numpy as np

from ..convert import POLICY_KEYS, bf16_bits_to_f32, policy_from_numpy, \
    policy_to_numpy
from ..core.policy import Policy, PolicyConfig
from ..device import DeviceLike


def latest_step(directory) -> Optional[int]:
    ckpts = sorted(pathlib.Path(directory).glob("ckpt_*.npz"))
    if not ckpts:
        return None
    return int(re.search(r"ckpt_(\d+)", ckpts[-1].name).group(1))


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
