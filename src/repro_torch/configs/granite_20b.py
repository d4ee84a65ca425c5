"""granite-20b — llama-arch code model, MQA (kv=1) [arXiv:2405.04324]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense", source="arXiv:2405.04324",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
)
