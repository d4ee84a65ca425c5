"""Data pipeline: per-arch batch construction.  Counterpart of
``repro/data/pipeline.py``.

``batch_spec`` gives the shape and torch dtype of every model input
(JAX's ``ShapeDtypeStruct``s); ``synthetic_batch`` makes a seeded random
batch of the same structure from the same numpy draws as JAX's, so the
arrays are JAX's bit for bit (bfloat16 inputs rounded from the same f32
draws); ``token_stream`` is the seeded next-token stream with a learnable
bigram structure.  Audio and VLM frontends are stubs: the inputs are
frame and patch *embeddings* of the configured width.
"""
from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _text_len(cfg, seq_len: int) -> int:
    if cfg.vlm_patches:
        assert seq_len > cfg.vlm_patches, (
            f"seq_len {seq_len} must exceed patch budget {cfg.vlm_patches}")
        return seq_len - cfg.vlm_patches
    return seq_len


def _float_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def batch_spec(cfg, seq_len: int, batch: int, mode: str = "train"
               ) -> Dict[str, TensorSpec]:
    """Model-input specs for (arch, shape)."""
    if mode == "decode":
        return {"token": TensorSpec((batch, 1), torch.int32),
                "pos": TensorSpec((batch,), torch.int32)}
    if cfg.is_encoder:
        return {"frames": TensorSpec((batch, seq_len, cfg.frontend_dim),
                                     _float_dtype(cfg)),
                "labels": TensorSpec((batch, seq_len), torch.int32)}
    out = {"tokens": TensorSpec((batch, _text_len(cfg, seq_len)),
                                torch.int32)}
    if cfg.vlm_patches:
        out["patches"] = TensorSpec((batch, cfg.vlm_patches, cfg.frontend_dim),
                                    _float_dtype(cfg))
        if mode == "train":
            out["labels"] = TensorSpec((batch, _text_len(cfg, seq_len)),
                                       torch.int32)
    return out


def synthetic_batch(cfg, seq_len: int, batch: int, mode: str = "train",
                    seed: int = 0, *, device: DeviceLike = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """A seeded batch of ``batch_spec``'s structure on ``device``: JAX's
    arrays, from the same numpy draws in the same order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in batch_spec(cfg, seq_len, batch, mode).items():
        if s.dtype == torch.int32:
            hi = cfg.vocab_size if name in ("tokens", "labels", "token") \
                else seq_len
            arr = rng.integers(0, hi, size=s.shape, dtype=np.int32)
            out[name] = torch.from_numpy(arr).to(dev)
        else:
            arr = rng.standard_normal(s.shape).astype(np.float32)
            out[name] = torch.from_numpy(arr).to(dev).to(s.dtype)
    return out


def token_stream(cfg, seq_len: int, batch: int, *, steps: int, seed: int = 0,
                 device: DeviceLike = "cuda"
                 ) -> Iterator[Dict[str, torch.Tensor]]:
    """Deterministic synthetic next-token stream with a learnable bigram
    structure (so a trained model's loss measurably decreases)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    # fixed sparse bigram table: t+1 ≡ (a·t + b) mod v, with noise
    a, b = 31, 17
    for _ in range(steps):
        first = rng.integers(0, v, size=(batch, 1), dtype=np.int64)
        toks = [first]
        for _ in range(seq_len - 1):
            nxt = (a * toks[-1] + b) % v
            noise = rng.random((batch, 1)) < 0.1
            rand = rng.integers(0, v, size=(batch, 1), dtype=np.int64)
            toks.append(np.where(noise, rand, nxt))
        yield {"tokens": torch.from_numpy(
            np.concatenate(toks, 1).astype(np.int32)).to(dev)}
