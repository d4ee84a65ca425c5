"""gemma3-12b — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense", source="hf:google/gemma-3-1b-pt",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab_size=262144, head_dim=256,
    pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
    sliding_window=1024, rope_theta=1_000_000.0,
)
