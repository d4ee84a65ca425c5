"""hubert-xlarge — encoder-only, wav2vec2-style transformer over conv-frame
embeddings [arXiv:2106.07447].  The conv/mel frontend is a stub: input_specs
provides precomputed frame embeddings (the licensed carve-out)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio", source="arXiv:2106.07447",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504, head_dim=80,
    is_encoder=True, frontend_dim=512, ffn_kind="mlp",
)
