"""Attention-free Mamba-1 LM, the falcon-mamba family (the reference's
``models/mamba_lm.py``): training, and serving by an O(1) decode state.

Per-layer weights stay stacked along a leading L axis, as the reference
stacks them (the gradient exchange folds each leaf whole); each layer runs
under ``torch.utils.checkpoint`` when ``remat`` is set and autograd
records.  The decode state is stacked too, ``conv`` (L, B, K-1, dI) in the
model dtype and ``ssm`` (L, B, dI, N) in f32, and ``decode_step`` writes
each layer's slice in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.rng import resolve_device
from .common import (cross_entropy_chunked, embed_init, generator,
                     layer_slice, matmul, rmsnorm, rmsnorm_init,
                     unbind_layers)
from .ssm import Mamba1Params, mamba1, mamba1_init


def mamba_lm_init(seed: int, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Fresh params from a seeded ``torch.Generator`` (``device=None``: the
    card; ``"meta"`` allocates nothing), each matrix drawn alone into its
    bf16 stack.  Not the reference's threefry bits:
    ``convert.params_from_jax`` carries the reference's params across."""
    device = resolve_device(device)
    gen = generator(seed, device)
    dtype, L = cfg.torch_dtype, cfg.n_layers
    # the vocabulary matrices first, while their f32 draws add to little
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    lm_head = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    return {
        "embed": embed,
        "blocks": {
            "mamba": mamba1_init(gen, cfg.d_model, cfg.d_inner,
                                 cfg.ssm_state, cfg.dt_rank, cfg.d_conv,
                                 dtype, device, layers=L)._asdict(),
            "ln": rmsnorm_init(cfg.d_model, dtype, device, L),
        },
        "ln_final": rmsnorm_init(cfg.d_model, dtype, device),
        "lm_head": lm_head,
    }


def _layer(cfg: ModelConfig, blk, h: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(blk["ln"], h, cfg.norm_eps)
    return h + mamba1(Mamba1Params(**blk["mamba"]), x, d_state=cfg.ssm_state,
                      dt_rank=cfg.dt_rank, chunk=cfg.ssm_chunk)


def mamba_lm_hidden(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                    remat: bool = True) -> torch.Tensor:
    """Token ids (B, S) -> the final normed hidden (B, S, d)."""
    h = params["embed"][tokens]
    layers = unbind_layers(params["blocks"])
    for i in range(cfg.n_layers):
        blk = layer_slice(layers, i)
        if remat and torch.is_grad_enabled():
            h = checkpoint(_layer, cfg, blk, h, use_reentrant=False)
        else:
            h = _layer(cfg, blk, h)
    return rmsnorm(params["ln_final"], h, cfg.norm_eps)


def mamba_lm_loss(params, cfg: ModelConfig, batch, *,
                  remat: bool = True) -> torch.Tensor:
    """batch: {"tokens": (B, S), "labels": (B, S)} integer tensors."""
    h = mamba_lm_hidden(params, cfg, batch["tokens"], remat=remat)
    W = params["lm_head"]
    return cross_entropy_chunked(lambda hc: matmul(hc, W.T), h,
                                 batch["labels"], cfg.vocab,
                                 chunk=cfg.loss_chunk)


def mamba_lm_init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
                        dtype=None, device=None) -> Dict[str, torch.Tensor]:
    """The decode state, zeros: O(1) in the sequence length, so
    ``max_len`` is ignored.  ``dtype=None``: the model's; ``device=None``:
    the card."""
    dtype = dtype or cfg.torch_dtype
    device = resolve_device(device)
    L, dI = cfg.n_layers, cfg.d_inner
    return {
        "conv": torch.zeros((L, batch, cfg.d_conv - 1, dI), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((L, batch, dI, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


@torch.inference_mode()
def mamba_lm_decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                         cache, pos=None):
    """One decode step, independent of the position (``pos`` kept for the
    API's sake).  token: (B, 1).  Returns ``(logits (B, 1, vocab),
    cache)``; each layer's conv and SSM state is written in place."""
    del pos
    h = params["embed"][token]
    layers = unbind_layers(params["blocks"])
    for l in range(cfg.n_layers):
        blk = layer_slice(layers, l)
        x = rmsnorm(blk["ln"], h, cfg.norm_eps)
        y, cs, ss = mamba1(Mamba1Params(**blk["mamba"]), x,
                           d_state=cfg.ssm_state, dt_rank=cfg.dt_rank,
                           chunk=1, conv_state=cache["conv"][l],
                           ssm_state=cache["ssm"][l], return_state=True)
        cache["conv"][l].copy_(cs)
        cache["ssm"][l].copy_(ss)
        h = h + y
    h = rmsnorm(params["ln_final"], h, cfg.norm_eps)
    return matmul(h, params["lm_head"].T), cache
