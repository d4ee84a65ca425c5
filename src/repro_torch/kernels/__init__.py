"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``,
built by ``build.py``), each beside its plain PyTorch version; ``ops``
holds the public entry points under the JAX package's names, re-exported
here as the JAX package does (so ``kernels.wkv6`` and ``kernels.swa`` name
the wrappers; import the modules as ``from repro_torch.kernels.wkv6 import
...``)."""
from . import ops
from .ops import (fused_s2v_layer, fused_s2v_layer_csr, fused_s2v_layer_sparse,
                  grouped_glu_ffn, mp_aggregate, sparse_mp_aggregate, swa,
                  wkv6)
