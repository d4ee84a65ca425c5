"""rwkv6-7b — Finch, data-dependent decay [arXiv:2404.05892]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm", source="arXiv:2404.05892",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab_size=65536, head_dim=64,
    pattern=("rwkv",), ffn_kind="rwkv_cm", rwkv_head_dim=64,
)
