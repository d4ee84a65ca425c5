"""Optimizers of the port: Adam as the JAX package computes it."""
from .adam import (AdamState, adam_init, adam_update, clip_by_global_norm,
                   clip_by_global_norm_, cosine_schedule, global_norm,
                   sqrt_f32)
