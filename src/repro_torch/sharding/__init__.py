"""Sharding rules of the LM substrate (counterpart of ``repro/sharding``;
its ``compat.py`` is a jax-version shim and has no counterpart)."""
from .rules import (P, activation_rules, batch_specs, cache_specs,
                    data_axes_of, param_specs)
