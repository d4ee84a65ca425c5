"""Activation-sharding plumbing, on one device.  Counterpart of
``repro/models/shard.py``'s ``NoSharder``: models call
``sharder.act(x, "<logical name>")`` at the layout-critical points, and on
one device that is the identity.  JAX's GSPMD ``Sharder`` comes with the
LM mesh (ROADMAP A8c)."""
from __future__ import annotations


class NoSharder:
    mesh = None

    def act(self, x, name: str):
        return x


NO_SHARD = NoSharder()
