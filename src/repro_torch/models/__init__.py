"""Model substrate of the port: attention (GQA, SWA, MLA), FFN (GLU,
MoE), RWKV-6, Mamba, block programs, and the generic LM/encoder/VLM
assembly with its loss, train and eval steps, prefill and greedy decode.
Counterpart of ``repro/models``, on one device; the GSPMD ``Sharder`` is
ROADMAP A8c."""
from .blocks import ModelCtx, build_program, layer_sigs
from .lm import (chunked_xent, init_cache, init_params, loss_and_grads,
                 loss_fn, make_decode_step, make_eval_step, make_prefill,
                 make_train_step, param_count, param_shapes)
from .shard import NO_SHARD, NoSharder
