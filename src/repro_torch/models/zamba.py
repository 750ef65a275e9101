"""Zamba2-style hybrid (the reference's ``models/zamba.py``): a Mamba-2
backbone with ONE shared attention+FFN block applied after every
``shared_attn_every`` layers, its weights shared across the applications.

Long prompts: from ``cfg.nystrom_attn_above`` tokens on, the shared block
attends through ``nystrom_attention``, the paper's two-product sketch
structure, which keeps the hybrid sub-quadratic.

The Mamba-2 weights stay stacked along a leading L axis; each layer runs
under ``torch.utils.checkpoint`` when ``remat`` is set and autograd
records (the shared block does not, as in the reference).  The decode
state stacks the layers' conv (model dtype) and SSM (f32) states, written
in place a layer at a time; the shared block's KV caches are a list, one
``{"k", "v"}`` entry per application.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.rng import resolve_device
from .attention import (AttnParams, attn_init, attention, attention_decode,
                        nystrom_attention)
from .common import (cross_entropy_chunked, embed_init, generator,
                     layer_slice, matmul, rmsnorm, rmsnorm_init,
                     unbind_layers)
from .ffn import FFNParams, ffn, ffn_init
from .ssm import Mamba2Params, mamba2, mamba2_init


def _shared_block_init(gen, cfg: ModelConfig, dtype, device):
    return {
        "attn": attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, dtype, device)._asdict(),
        "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, dtype, device)._asdict(),
        "ln_attn": rmsnorm_init(cfg.d_model, dtype, device),
        "ln_ffn": rmsnorm_init(cfg.d_model, dtype, device),
    }


def hybrid_init(seed: int, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Fresh params from a seeded ``torch.Generator`` (``device=None``: the
    card; ``"meta"`` allocates nothing).  Not the reference's threefry
    bits: ``convert.params_from_jax`` carries the reference's across."""
    device = resolve_device(device)
    gen = generator(seed, device)
    dtype, L = cfg.torch_dtype, cfg.n_layers
    # the vocabulary matrices first, while their f32 draws add to little
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    lm_head = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    return {
        "embed": embed,
        "blocks": {
            "mamba": mamba2_init(gen, cfg.d_model, cfg.d_inner,
                                 cfg.ssm_state, cfg.ssm_heads, cfg.d_conv,
                                 dtype, device, layers=L)._asdict(),
            "ln": rmsnorm_init(cfg.d_model, dtype, device, L),
        },
        "shared": _shared_block_init(gen, cfg, dtype, device),
        "ln_final": rmsnorm_init(cfg.d_model, dtype, device),
        "lm_head": lm_head,
    }


def _segments(cfg: ModelConfig):
    """``(lo, hi, shared)``: the Mamba layers [lo, hi), then the shared
    block when ``shared`` (after every full segment, and after the last
    only when ``n_layers % every == 0``)."""
    every, lo = cfg.shared_attn_every or (cfg.n_layers + 1), 0
    while lo < cfg.n_layers:
        hi = min(lo + every, cfg.n_layers)
        yield lo, hi, hi < cfg.n_layers or cfg.n_layers % every == 0
        lo = hi


def _n_shared_applications(cfg: ModelConfig) -> int:
    return sum(shared for _, _, shared in _segments(cfg))


def _apply_shared(params, cfg: ModelConfig, h: torch.Tensor, *,
                  use_nystrom: bool, kv_chunk: int = 1024) -> torch.Tensor:
    sb = params["shared"]
    attn_p = AttnParams(**sb["attn"])
    a_in = rmsnorm(sb["ln_attn"], h, cfg.norm_eps)
    if use_nystrom:
        a = nystrom_attention(attn_p, a_in, n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_kv_heads,
                              head_dim=cfg.head_dim,
                              n_landmarks=cfg.nystrom_landmarks,
                              rope_theta=cfg.rope_theta)
    else:
        a = attention(attn_p, a_in, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                      causal=True, rope_theta=cfg.rope_theta,
                      kv_chunk=kv_chunk)
    h = h + a
    f = ffn(FFNParams(**sb["ffn"]), rmsnorm(sb["ln_ffn"], h, cfg.norm_eps))
    return h + f


def _mamba_layer(cfg: ModelConfig, blk, h: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(blk["ln"], h, cfg.norm_eps)
    return h + mamba2(Mamba2Params(**blk["mamba"]), x, d_state=cfg.ssm_state,
                      n_heads=cfg.ssm_heads, chunk=cfg.ssm_chunk)


def _mamba_segment(layers, cfg: ModelConfig, h: torch.Tensor, lo: int,
                   hi: int, remat: bool) -> torch.Tensor:
    """The Mamba layers [lo, hi) of the unbound stack ``layers``."""
    for i in range(lo, hi):
        blk = layer_slice(layers, i)
        if remat and torch.is_grad_enabled():
            h = checkpoint(_mamba_layer, cfg, blk, h, use_reentrant=False)
        else:
            h = _mamba_layer(cfg, blk, h)
    return h


def hybrid_hidden(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                  remat: bool = True) -> torch.Tensor:
    """Token ids (B, S) -> the final normed hidden (B, S, d)."""
    h = params["embed"][tokens]
    S = h.shape[1]
    use_ny = bool(cfg.nystrom_attn_above) and S >= cfg.nystrom_attn_above
    layers = unbind_layers(params["blocks"])
    for lo, hi, shared in _segments(cfg):
        h = _mamba_segment(layers, cfg, h, lo, hi, remat)
        if shared:
            h = _apply_shared(params, cfg, h, use_nystrom=use_ny)
    return rmsnorm(params["ln_final"], h, cfg.norm_eps)


def hybrid_loss(params, cfg: ModelConfig, batch, *,
                remat: bool = True) -> torch.Tensor:
    """batch: {"tokens": (B, S), "labels": (B, S)} integer tensors."""
    h = hybrid_hidden(params, cfg, batch["tokens"], remat=remat)
    W = params["lm_head"]
    return cross_entropy_chunked(lambda hc: matmul(hc, W.T), h,
                                 batch["labels"], cfg.vocab,
                                 chunk=cfg.loss_chunk)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=None, device=None) -> Dict[str, Any]:
    """Zeros: the stacked SSM states and one ``{"k", "v"}`` cache of
    (batch, max_len, Hk, D) per application of the shared block (a list,
    so a step writes one entry's slot in place).  ``dtype=None``: the
    model's; ``device=None``: the card."""
    dtype = dtype or cfg.torch_dtype
    device = resolve_device(device)
    L, H, N = cfg.n_layers, cfg.ssm_heads, cfg.ssm_state
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "conv": torch.zeros((L, batch, cfg.d_conv - 1, cfg.d_inner + 2 * N),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((L, batch, H, cfg.d_inner // H, N),
                           dtype=torch.float32, device=device),
        "shared": [{"k": torch.zeros(kv, dtype=dtype, device=device),
                    "v": torch.zeros(kv, dtype=dtype, device=device)}
                   for _ in range(_n_shared_applications(cfg))],
    }


@torch.inference_mode()
def hybrid_decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                       cache, pos):
    """One decode step.  token: (B, 1); ``pos``: the new token's position
    (an int or a 0-d tensor).  The SSM layers advance their O(1) states,
    each application of the shared block writes its KV cache at ``pos``;
    all in place.  Returns ``(logits (B, 1, vocab), cache)``."""
    h = params["embed"][token]
    layers = unbind_layers(params["blocks"])
    sb = params["shared"]
    attn_p = AttnParams(**sb["attn"])
    s_idx = 0
    for lo, hi, shared in _segments(cfg):
        for l in range(lo, hi):
            blk = layer_slice(layers, l)
            x = rmsnorm(blk["ln"], h, cfg.norm_eps)
            y, cs, ss = mamba2(Mamba2Params(**blk["mamba"]), x,
                               d_state=cfg.ssm_state, n_heads=cfg.ssm_heads,
                               chunk=1, conv_state=cache["conv"][l],
                               ssm_state=cache["ssm"][l], return_state=True)
            cache["conv"][l].copy_(cs)
            cache["ssm"][l].copy_(ss)
            h = h + y
        if shared:
            entry = cache["shared"][s_idx]
            a, entry["k"], entry["v"] = attention_decode(
                attn_p, rmsnorm(sb["ln_attn"], h, cfg.norm_eps), entry["k"],
                entry["v"], pos, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta)
            h = h + a
            h = h + ffn(FFNParams(**sb["ffn"]),
                        rmsnorm(sb["ln_ffn"], h, cfg.norm_eps))
            s_idx += 1
    h = rmsnorm(params["ln_final"], h, cfg.norm_eps)
    return matmul(h, params["lm_head"].T), cache
