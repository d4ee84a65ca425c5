"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=5632, vocab_size=151936, head_dim=128,
    n_experts=60, experts_per_token=4, n_shared_experts=4,
    d_ff_expert=1408,
)
