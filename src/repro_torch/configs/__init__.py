"""Architecture registry of the port: ``get_config("<arch-id>")``.

Every architecture of the reference's registry, in its six families:
dense, MoE, SSM, hybrid, encoder-decoder (whisper-tiny) and VLM
(internvl2-26b).
"""
from __future__ import annotations

from typing import Dict, Tuple

from .base import FULL_WINDOW, ModelConfig, RunConfig  # noqa: F401
from . import (dbrx_132b, falcon_mamba_7b, gemma2_2b, granite_moe_1b,
               h2o_danube3_4b, internlm2_20b, internvl2_26b, llama3_8b,
               whisper_tiny, zamba2_1p2b)

_REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (internvl2_26b, h2o_danube3_4b, internlm2_20b, gemma2_2b,
              llama3_8b, granite_moe_1b, dbrx_132b, zamba2_1p2b,
              falcon_mamba_7b, whisper_tiny)
}

ARCH_IDS: Tuple[str, ...] = tuple(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch]
