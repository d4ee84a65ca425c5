"""llava-next-34b — anyres patch tiling over a Yi-34B-style decoder
[hf:llava-hf/llava-v1.6 family].  The SigLIP/ViT frontend is a stub:
input_specs provides precomputed patch embeddings (the licensed carve-out);
anyres tiling fixes the patch budget at 2880 tokens (4 tiles + base view of
576 patches each)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm", source="hf:llava-hf/llava-v1.6",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    vlm_patches=2880, frontend_dim=1152,
)
