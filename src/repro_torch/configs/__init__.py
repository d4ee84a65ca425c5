"""Run configurations of the port.  Counterpart of ``repro/configs``: the
LM architectures (``ArchConfig``, one module a model, the ``ARCHS``
registry that ``--arch <id>`` resolves through), the run shapes
(``ShapeConfig``, ``SHAPES``), the graph-representation selection
(``base.GraphRepConfig``, ``GRAPH_REPS``) and the paper's own workload
(``papergraph``)."""
from . import base
from .base import (GRAPH_REPS, SHAPES, ArchConfig, GraphRepConfig,
                   ShapeConfig, shape_supported)

from .rwkv6_7b import CONFIG as rwkv6_7b
from .gemma3_12b import CONFIG as gemma3_12b
from .gemma3_4b import CONFIG as gemma3_4b
from .qwen2_moe_a2_7b import CONFIG as qwen2_moe_a2_7b
from .hubert_xlarge import CONFIG as hubert_xlarge
from .llama3_405b import CONFIG as llama3_405b
from .deepseek_v3_671b import CONFIG as deepseek_v3_671b
from .granite_20b import CONFIG as granite_20b
from .llava_next_34b import CONFIG as llava_next_34b
from .jamba_v0_1_52b import CONFIG as jamba_v0_1_52b

ARCHS = {c.name: c for c in (
    rwkv6_7b, gemma3_12b, gemma3_4b, qwen2_moe_a2_7b, hubert_xlarge,
    llama3_405b, deepseek_v3_671b, granite_20b, llava_next_34b,
    jamba_v0_1_52b)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
