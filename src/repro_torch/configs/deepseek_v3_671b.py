"""deepseek-v3-671b — MLA, 1 shared + 256 routed experts top-8, first 3
layers dense [arXiv:2412.19437].  MTP auxiliary objective is noted in
DESIGN.md (off by default)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe", source="arXiv:2412.19437",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab_size=129280,
    pattern=("mla",),
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, head_dim=128,
    n_experts=256, experts_per_token=8, n_shared_experts=1,
    d_ff_expert=2048, first_dense_layers=3,
)
