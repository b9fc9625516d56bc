"""Architecture registry of the port (counterpart of ``repro.configs``):
``--arch <id>`` resolves here."""
from .base import ModelConfig, ShapeSpec, SHAPES, cells_for, reduced_config  # noqa: F401

from . import (
    command_r_35b,
    deepseek_v2_lite_16b,
    llama3_2_vision_11b,
    llama3_8b,
    llama4_maverick_400b_a17b,
    qwen3_0_6b,
    recurrentgemma_9b,
    rwkv6_1_6b,
    seamless_m4t_medium,
    stablelm_12b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        stablelm_12b,
        qwen3_0_6b,
        llama3_8b,
        command_r_35b,
        seamless_m4t_medium,
        recurrentgemma_9b,
        llama4_maverick_400b_a17b,
        deepseek_v2_lite_16b,
        rwkv6_1_6b,
        llama3_2_vision_11b,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
