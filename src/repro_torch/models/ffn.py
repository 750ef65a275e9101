"""The dense gated FFN (SwiGLU / GeGLU) of the reference's
``models/ffn.py``.  MoE waits for the LM-substrate slice.

``jax.nn.gelu`` defaults to the tanh approximation, while
``torch.nn.functional.gelu`` defaults to the exact erf form: the port
asks for ``approximate="tanh"``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import dense_init, matmul

ACTIVATIONS = {"silu": F.silu,
               "gelu": lambda x: F.gelu(x, approximate="tanh")}


class FFNParams(NamedTuple):
    w_gate: torch.Tensor   # (d, f)
    w_up: torch.Tensor     # (d, f)
    w_down: torch.Tensor   # (f, d)


def ffn_init(gen, d: int, f: int, dtype, device,
             layers: int = 0) -> FFNParams:
    kw = dict(dtype=dtype, device=device, layers=layers)
    return FFNParams(
        w_gate=dense_init(gen, d, f, **kw),
        w_up=dense_init(gen, d, f, **kw),
        w_down=dense_init(gen, f, d, scale=1.0 / math.sqrt(f), **kw),
    )


def ffn(params: FFNParams, x: torch.Tensor,
        activation: str = "silu") -> torch.Tensor:
    g = matmul(x, params.w_gate)
    u = matmul(x, params.w_up)
    return matmul(ACTIVATIONS[activation](g) * u, params.w_down)
