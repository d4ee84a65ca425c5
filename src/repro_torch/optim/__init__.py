"""Optimizers of the port: Adam as the JAX package computes it."""
from .adam import AdamState, adam_init, adam_update, clip_by_global_norm
