"""Uniform model API of the port (the reference's ``models/api.py``), for
the dense, MoE, SSM (falcon-mamba) and hybrid (zamba2) families, the
parameter leaf order of the reference, and the useful FLOPs of a step
(``model_flops``, ``count_params_split``, ``count_active_params``).

Every family exposes:
  init(seed, cfg, device) -> params
  loss(params, cfg, batch, remat=) -> scalar
  init_cache(cfg, batch, max_len, dtype=None, device=None) -> caches
  decode_step(params, cfg, token, caches, pos) -> (logits, caches)
and the dense and MoE families also
  prefill(params, cfg, tokens, remat=, kv_chunk=, max_len=)
      -> (last-position logits, caches)
(``prefill=None`` for the SSM and hybrid families, as in the reference:
``serve.engine.serve_prefill`` gives their last logits and no cache).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from . import mamba_lm, transformer, zamba


@dataclass(frozen=True)
class ModelAPI:
    init: Callable
    loss: Callable
    init_cache: Callable
    decode_step: Callable
    prefill: Optional[Callable] = None


_LM = ModelAPI(transformer.lm_init, transformer.lm_loss,
               transformer.init_cache, transformer.decode_step,
               transformer.prefill)
_FAMILIES = {
    "dense": _LM, "moe": _LM,
    "ssm": ModelAPI(mamba_lm.mamba_lm_init, mamba_lm.mamba_lm_loss,
                    mamba_lm.mamba_lm_init_cache,
                    mamba_lm.mamba_lm_decode_step),
    "hybrid": ModelAPI(zamba.hybrid_init, zamba.hybrid_loss,
                       zamba.hybrid_init_cache, zamba.hybrid_decode_step),
}


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md Queue 1, "
            f"item 11d: the LM substrate's remainder)")
    return _FAMILIES[cfg.family]


def param_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(name, leaf)`` of a nested dict in JAX's ``tree_flatten`` order:
    dict keys sorted at every level, names joined by dots.

    The order is part of the exchange's contract: a leaf's position enters
    its Philox key (``parallel.grad_compress.leaf_seed``), so another order
    gives every leaf another Omega.  ``nn.Module.named_parameters()`` gives
    insertion order, which is not this one.
    """
    out = []
    for k in sorted(tree):
        name = f"{prefix}.{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            out.extend(param_leaves(v, name))
        else:
            out.append((name, v))
    return out


def unflatten_like(tree, leaves):
    """A nested dict of ``tree``'s structure holding ``leaves`` (in
    :func:`param_leaves` order)."""
    it = iter(leaves)

    def build(t):
        return {k: (build(t[k]) if isinstance(t[k], dict) else next(it))
                for k in sorted(t)}
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def model_flops(cfg: ModelConfig, shape, n_params: Optional[int] = None,
                n_active_params: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for train;
    2·N·D for inference-type shapes (forward only).  ``shape`` is anything
    with ``global_batch``, ``seq_len`` and ``kind`` (train, prefill or
    decode)."""
    N = n_active_params or n_params or 0
    D = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * N * D


def count_params_split(cfg: ModelConfig, params_shapes=None):
    """(total, expert) parameter counts from shapes alone: ``params_shapes``
    a nested dict of tensors (any device), by default the model's own
    leaves made on the ``meta`` device, which allocates nothing."""
    if params_shapes is None:
        params_shapes = get_api(cfg).init(0, cfg, "meta")
    total = 0
    expert = 0
    for name, leaf in param_leaves(params_shapes):
        sz = math.prod(int(s) for s in leaf.shape)
        if cfg.n_experts and "moe" in name and any(
                w in name for w in ("w_gate", "w_up", "w_down")):
            expert += sz
        else:
            total += sz
    return total + expert, expert


def count_active_params(cfg: ModelConfig, params_shapes=None) -> int:
    """Active params per token: MoE experts count at top_k/E weight."""
    total, expert = count_params_split(cfg, params_shapes)
    if cfg.n_experts:
        return int(total - expert + expert * cfg.top_k / cfg.n_experts)
    return int(total)
