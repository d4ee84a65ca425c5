"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE 16e top-2 every
other layer [arXiv:2403.19887]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid", source="arXiv:2403.19887",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba"),
    n_experts=16, experts_per_token=2, d_ff_expert=14336,
    moe_every=2, moe_offset=1,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)
