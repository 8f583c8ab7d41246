"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS``.

One module per assigned architecture; each cites its source paper or
model card and reproduces the exact assigned hyper-parameters.
"""

from .base import (INPUT_SHAPES, InputShape, ModelConfig, MoEConfig,
                   SSMConfig, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
from .whisper_tiny import CONFIG as WHISPER_TINY
from .qwen2_vl_2b import CONFIG as QWEN2_VL_2B
from .jamba_v0_1_52b import CONFIG as JAMBA_V0_1_52B
from .qwen2_72b import CONFIG as QWEN2_72B
from .yi_34b import CONFIG as YI_34B
from .stablelm_3b import CONFIG as STABLELM_3B
from .dbrx_132b import CONFIG as DBRX_132B
from .kimi_k2_1t_a32b import CONFIG as KIMI_K2_1T_A32B
from .mamba2_370m import CONFIG as MAMBA2_370M
from .h2o_danube_3_4b import CONFIG as H2O_DANUBE_3_4B

ARCHS = {c.name: c for c in (
    WHISPER_TINY, QWEN2_VL_2B, JAMBA_V0_1_52B, QWEN2_72B, YI_34B,
    STABLELM_3B, DBRX_132B, KIMI_K2_1T_A32B, MAMBA2_370M, H2O_DANUBE_3_4B)}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "get_config", "ModelConfig", "MoEConfig", "SSMConfig",
           "InputShape", "INPUT_SHAPES", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K"]
