"""Decoder-only LM of the dense family (llama3, internlm2, h2o-danube3,
gemma2): the training half of the reference's ``models/transformer.py``.

Per-layer weights stay stacked along a leading L axis, exactly as the
reference's ``lm_init`` stacks them: the gradient exchange folds a leaf to
``(prod(shape[:-1]), shape[-1])``, so per-layer tensors would give other
matrices, other decisions and other Omega keys.  The layer loop indexes
the stacks, and each block runs under ``torch.utils.checkpoint`` when
``remat`` is set (the reference's ``jax.checkpoint``).

Prefill and decode are not on the training path and are not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.rng import resolve_device
from .attention import AttnParams, attn_init, attention
from .common import (cross_entropy_chunked, embed_init, layernorm,
                     layernorm_init, matmul, rmsnorm, rmsnorm_init)
from .ffn import FFNParams, ffn, ffn_init


def _norm_init(cfg: ModelConfig, dtype, device, layers: int = 0):
    init = rmsnorm_init if cfg.norm == "rmsnorm" else layernorm_init
    return init(cfg.d_model, dtype, device, layers)


def _norm_apply(cfg: ModelConfig, p, x):
    return (rmsnorm(p, x, cfg.norm_eps) if cfg.norm == "rmsnorm"
            else layernorm(p, x, cfg.norm_eps))


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the port has only the dense family yet (ROADMAP.md "
            f"Queue 1, item 11)")


def lm_init(seed: int, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Fresh params from a seeded ``torch.Generator`` (``device=None``: the
    card; ``"meta"`` allocates nothing).  The draws are not the reference's
    threefry bits; ``convert.params_from_jax`` carries the reference's
    params across instead."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(int(seed)))
    dtype, L = cfg.torch_dtype, cfg.n_layers
    blocks = {
        "attn": attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, dtype, device, layers=L)._asdict(),
        "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, dtype, device,
                        layers=L)._asdict(),
        "ln_attn": _norm_init(cfg, dtype, device, L),
        "ln_ffn": _norm_init(cfg, dtype, device, L),
    }
    if cfg.use_post_norms:
        blocks["ln_attn_post"] = _norm_init(cfg, dtype, device, L)
        blocks["ln_ffn_post"] = _norm_init(cfg, dtype, device, L)
    params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype, device),
              "blocks": blocks,
              "ln_final": _norm_init(cfg, dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab, cfg.d_model, dtype,
                                       device)
    return params


def _layer(tree, i: int):
    """Layer i's params: the i-th slice of every stacked leaf."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree):
    """Every stacked leaf split into per-layer views (one autograd node per
    leaf, so its gradient is stacked once, not summed from L full-size
    zero-padded slices)."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0)


def _block_apply(cfg: ModelConfig, blk, h, window: int,
                 positions: torch.Tensor, kv_chunk: int):
    a_in = _norm_apply(cfg, blk["ln_attn"], h)
    a = attention(AttnParams(**blk["attn"]), a_in, n_heads=cfg.n_heads,
                  n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                  positions=positions, causal=True, window=window,
                  attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
                  kv_chunk=kv_chunk)
    if cfg.use_post_norms:
        a = _norm_apply(cfg, blk["ln_attn_post"], a)
    h = h + a
    f = ffn(FFNParams(**blk["ffn"]), _norm_apply(cfg, blk["ln_ffn"], h),
            activation=cfg.activation)
    if cfg.use_post_norms:
        f = _norm_apply(cfg, blk["ln_ffn_post"], f)
    return h + f


def lm_hidden(params, cfg: ModelConfig, tokens: torch.Tensor, *,
              remat: bool = True, kv_chunk: int = 1024):
    """Token ids (B, S) -> (final hidden (B, S, d), aux loss 0)."""
    _check_family(cfg)
    S = tokens.shape[1]
    h = params["embed"][tokens]
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    positions = torch.arange(S, dtype=torch.int64, device=h.device)
    layers = _unbind(params["blocks"])
    for i, window in enumerate(cfg.layer_windows(S)):
        blk = _layer(layers, i)
        if remat and torch.is_grad_enabled():
            h = checkpoint(_block_apply, cfg, blk, h, window, positions,
                           kv_chunk, use_reentrant=False)
        else:
            h = _block_apply(cfg, blk, h, window, positions, kv_chunk)
    h = _norm_apply(cfg, params["ln_final"], h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def lm_loss(params, cfg: ModelConfig, batch, *,
            remat: bool = True) -> torch.Tensor:
    """batch: {"tokens": (B, S), "labels": (B, S)} integer tensors."""
    h, aux = lm_hidden(params, cfg, batch["tokens"], remat=remat)
    W = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    nll = cross_entropy_chunked(lambda hc: matmul(hc, W.T), h,
                                batch["labels"], cfg.vocab,
                                chunk=cfg.loss_chunk,
                                final_softcap=cfg.final_softcap)
    return nll + cfg.router_aux_weight * aux

