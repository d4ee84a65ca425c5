"""Model substrate of the port, the serving half: attention (GQA, SWA,
MLA), FFN (GLU, MoE), RWKV-6, Mamba, block programs, and the generic
LM/encoder/VLM assembly with prefill and greedy decode.  Counterpart of
``repro/models``; training (``loss_fn``, ``chunked_xent``, the train and
eval steps) is ROADMAP A8b and the GSPMD ``Sharder`` A8c."""
from .blocks import ModelCtx, build_program, layer_sigs
from .lm import (init_cache, init_params, make_decode_step, make_prefill,
                 param_count, param_shapes)
from .shard import NO_SHARD, NoSharder
