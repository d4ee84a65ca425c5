"""Run configurations: the LM architectures and run shapes, and the
graph-representation selection for the paper's RL workload.
Counterpart of ``repro/configs/base.py``: ``ArchConfig``, ``ShapeConfig``,
``SHAPES`` and ``shape_supported`` are plain data, kept as the JAX
package writes them (``dataclasses.asdict`` of each equals JAX's), and
``GraphRepConfig``/``GRAPH_REPS`` take the same fields, defaults and
checks, building the port's ``GraphRep`` backends.

Every architecture gets one module in this package exporting ``CONFIG``
(the published numbers, with the source cited); ``reduced()`` derives the
CPU smoke-test variant (<= 2 layers or one pattern period, d_model <= 256,
<= 4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    source: str                      # citation from the assignment table
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // n_heads

    # layer pattern: period of mixer kinds, repeated over n_layers.
    # kinds: "attn" (global), "swa" (sliding window), "mamba", "rwkv"
    pattern: Tuple[str, ...] = ("attn",)
    sliding_window: int = 0

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1               # MoE FFN on layers where l % moe_every == moe_offset
    moe_offset: int = 0
    first_dense_layers: int = 0      # deepseek-v3: first k layers use dense FFN
    router_aux_weight: float = 0.01

    # multi-token prediction (deepseek-v3 §MTP): auxiliary head predicting
    # token t+2 from a projected hidden state; 0 disables (default)
    mtp_weight: float = 0.0

    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM / RWKV
    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 32
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # roles
    is_encoder: bool = False         # hubert: bidirectional, per-frame head
    vlm_patches: int = 0             # llava: # of vision-patch embeddings
    frontend_dim: int = 0            # audio/vlm stub frontend embedding dim

    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    ffn_kind: str = "glu"            # glu | mlp (encoder) | rwkv_cm
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % 1 == 0
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_decode(self) -> bool:
        return not self.is_encoder

    @property
    def subquadratic(self) -> bool:
        """May run long_500k: SSM/hybrid/linear-attention or sliding-window."""
        return any(k in ("mamba", "rwkv", "swa") for k in self.pattern)

    def kind_of_layer(self, l: int) -> str:
        return self.pattern[l % len(self.pattern)]

    def ffn_of_layer(self, l: int) -> str:
        if self.is_moe and l >= self.first_dense_layers and \
                l % self.moe_every == self.moe_offset:
            return "moe"
        return self.ffn_kind

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant of the same family."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, len(self.pattern) if
                         len(self.pattern) > 1 else 2),
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=max(d // heads, 8),
            d_ff=min(self.d_ff, 512),
            d_ff_expert=min(self.d_ff_expert, 128) if self.d_ff_expert else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            n_shared_experts=min(self.n_shared_experts, 1)
            if self.n_shared_experts else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            qk_nope_dim=min(self.qk_nope_dim, 16) if self.qk_nope_dim else 0,
            qk_rope_dim=min(self.qk_rope_dim, 16) if self.qk_rope_dim else 0,
            v_head_dim=min(self.v_head_dim, 16) if self.v_head_dim else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            rwkv_head_dim=min(self.rwkv_head_dim, 32),
            rwkv_lora_dim=min(self.rwkv_lora_dim, 8),
            vlm_patches=min(self.vlm_patches, 16) if self.vlm_patches else 0,
            frontend_dim=d if self.frontend_dim else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class GraphRepConfig:
    """Graph-representation backend selection (DESIGN.md §1).  ``rep``
    picks the GraphRep the env, inference, training and mesh layers
    dispatch through: a config flag, not a code-path fork.
    ``engine``/``spatial`` select the training engine the same way: the
    fused step or the host loop, on one device or on the ``(data, graph)``
    mesh."""
    rep: str = "dense"               # "dense" (B,N,N) | "sparse" (B,N,D)
                                     # | "csr" flat edge arrays
    max_degree: int = 0              # sparse: 0 → derive from the graph batch
    max_edges: int = 0               # csr: 0 → derive from the graph batch
    # 2-D (data, graph) mesh spec: (dp, sp) shards batches over `data` and
    # node rows over `graph`; an int P ⇒ (1, P); 0 ⇒ one device.
    spatial: Union[int, Tuple[int, int]] = 0
    engine: str = "device"           # training engine: "device" | "host"
    # S2V layer lowering: "fused" (the hand-written kernels) | "xla" (the
    # plain chain); and the products' operand precision "f32" | "bf16".
    kernel: str = "fused"
    compute: str = "f32"

    def __post_init__(self):
        assert self.rep in ("dense", "sparse", "csr"), self.rep
        assert self.engine in ("device", "host"), self.engine
        assert self.kernel in ("fused", "xla"), self.kernel
        assert self.compute in ("f32", "bf16"), self.compute

    def make(self):
        """Construct the GraphRep backend this config describes."""
        from ..core.graphrep import DENSE, CsrRep, SparseRep
        if self.rep == "dense":
            return DENSE
        if self.rep == "csr":
            return CsrRep(max_edges=self.max_edges or None)
        return SparseRep(max_degree=self.max_degree or None)

    def apply(self, cfg):
        """Stamp this selection onto a ``PolicyConfig`` (engine, spatial,
        rep, kernel, compute) so agent and training construction read one
        source of truth."""
        return dataclasses.replace(cfg, graph_rep=self.rep,
                                   engine=self.engine, spatial=self.spatial,
                                   kernel=self.kernel, compute=self.compute)


GRAPH_REPS = {
    "dense": GraphRepConfig(rep="dense"),
    "sparse": GraphRepConfig(rep="sparse"),
    "csr": GraphRepConfig(rep="csr"),
}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_supported(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Implements the skip policy recorded in DESIGN.md §4."""
    if shape.mode == "decode" and arch.is_encoder:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, ("pure full-attention decoder; long_500k reserved for "
                       "sub-quadratic families (DESIGN.md §4)")
    return True, ""
