"""Model substrate of the port: attention (GQA, SWA, MLA), FFN (GLU,
MoE), RWKV-6, Mamba, block programs, and the generic LM/encoder/VLM
assembly with its loss, train and eval steps, prefill and greedy decode.
Counterpart of ``repro/models``; on the LM mesh each rank runs the
model on its block of the batch, with the MoE layer's experts split over
``model`` (``Sharder``, ``ffn.moe_sharded_apply``)."""
from .blocks import ModelCtx, build_program, layer_sigs
from .lm import (cache_shapes, chunked_xent, init_cache, init_params,
                 loss_and_grads, loss_fn, make_decode_step, make_eval_step,
                 make_prefill, make_train_step, param_count, param_shapes)
from .shard import NO_SHARD, NoSharder, Sharder
