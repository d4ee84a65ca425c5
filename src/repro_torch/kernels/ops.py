"""The port's kernel entry points, under the public names of the JAX
package's ``repro/kernels/ops.py``.

Each name is the kernel wrapper itself (so ``ops.wkv6.launches`` is the
wrapper's launch count): it computes the plain PyTorch version on CPU
tensors and launches the hand-written CUDA kernel on CUDA tensors.  The
JAX wrappers' ``tile_*`` and ``interpret`` arguments choose the TPU's
tiling and are not part of the function computed, so they are dropped;
the s2v wrappers take ``compute="f32"|"bf16"`` for JAX's
``compute_dtype``, and ``fused_s2v_layer_csr`` takes CSR ``indptr``
where JAX takes ``row_ids``.
"""
from __future__ import annotations

from .. import device as _device  # noqa: F401  (TF32 off for the plain versions)
from .moe_gemm import grouped_glu_ffn
from .s2v_csr import fused_s2v_layer_csr
from .s2v_fused import fused_s2v_layer, fused_s2v_layer_sparse, mp_aggregate
from .s2v_gather import sparse_mp_aggregate
from .swa import swa_attention as swa
from .wkv6 import wkv6_chunked as wkv6

__all__ = ["fused_s2v_layer", "fused_s2v_layer_sparse", "fused_s2v_layer_csr",
           "mp_aggregate", "sparse_mp_aggregate", "wkv6", "swa",
           "grouped_glu_ffn"]
