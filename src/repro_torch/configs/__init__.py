"""Architecture registry of the port: ``get_config("<arch-id>")``.

The dense, MoE, SSM and hybrid families are ported; the reference's
other architectures raise ``NotImplementedError`` naming the roadmap item
that ports them.
"""
from __future__ import annotations

from typing import Dict, Tuple

from .base import FULL_WINDOW, ModelConfig, RunConfig  # noqa: F401
from . import (dbrx_132b, falcon_mamba_7b, gemma2_2b, granite_moe_1b,
               h2o_danube3_4b, internlm2_20b, llama3_8b, zamba2_1p2b)

_REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (h2o_danube3_4b, internlm2_20b, gemma2_2b, llama3_8b,
              granite_moe_1b, dbrx_132b, zamba2_1p2b, falcon_mamba_7b)
}

# the reference's architectures of other families, not ported yet
_NOT_PORTED = {"internvl2-26b": "vlm", "whisper-tiny": "encdec"}

ARCH_IDS: Tuple[str, ...] = tuple(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is of the {_NOT_PORTED[arch]} family, which the port "
            f"does not have yet (ROADMAP.md Queue 1, item 11: the LM "
            f"substrate); ported: {sorted(_REGISTRY)}")
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch]
