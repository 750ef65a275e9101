"""Uniform model API of the port (the reference's ``models/api.py``), for
the dense family, and the parameter leaf order of the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from . import transformer


@dataclass(frozen=True)
class ModelAPI:
    init: Callable        # (seed, cfg, device) -> params
    loss: Callable        # (params, cfg, batch, remat=) -> scalar


_FAMILIES = {"dense": ModelAPI(transformer.lm_init, transformer.lm_loss)}


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md Queue 1, "
            f"item 11: the LM substrate)")
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
