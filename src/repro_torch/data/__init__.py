"""Data pipeline of the port (``pipeline``): per-arch model inputs."""
from .pipeline import TensorSpec, batch_spec, synthetic_batch, token_stream
