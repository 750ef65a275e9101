"""Whisper-style encoder-decoder (the reference's ``models/whisper.py``):
the audio backbone only.  The conv/mel frontend is a stub, as in the
reference: the batch supplies precomputed frame embeddings
``frames`` (B, enc_seq, d_model).

The encoder adds learned positions and runs non-causal self-attention
and the biased GELU MLP; the decoder adds learned positions to the token
embeddings and runs causal self-attention, cross-attention to the
encoder's output and the MLP; layernorm before each, no rotary
embedding anywhere; the head is the token embedding, transposed.

Per-layer weights stay stacked along a leading L axis under the
reference's names, so ``models.api.param_leaves`` gives JAX's
``tree_flatten`` order (``dec_blocks, dec_ln, dec_pos, embed,
enc_blocks, enc_ln, enc_pos``), which enters each leaf's Omega key in
the gradient exchange.  Each block runs under ``torch.utils.checkpoint``
when ``remat`` is set and autograd records (the reference's
``jax.checkpoint``).

Serving keeps the reference's cache: a dict of stacked tensors
``self_k``, ``self_v`` (L, B, max_len, Hk, D) and ``cross_k``,
``cross_v`` (L, B, enc_seq, Hk, D), the cross pair computed once from
the encoder's output by ``encdec_prepare_cross``.  A decode step writes
``self_k[l]`` / ``self_v[l]`` in place.  Like the reference's, the
chunked attention of the encoder and of training-time cross-attention
pads the keys to a multiple of ``kv_chunk`` and leaves the pad unmasked
(non-causal, no window; ``models/attention.py`` ``chunked_attention``),
while the decode step's cross-attention is a plain softmax over the
``enc_seq`` real keys: the two agree only when ``enc_seq`` is a
multiple of 1024.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.rng import resolve_device
from .attention import AttnParams, attn_init, attention, attention_decode
from .common import (cross_entropy_chunked, embed_init, generator,
                     layer_slice, layernorm, layernorm_init, matmul,
                     unbind_layers)
from .ffn import MLPParams, mlp, mlp_init


def _attn_init(gen, cfg: ModelConfig, dtype, device, L: int):
    return attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.head_dim, dtype, device, layers=L)._asdict()


def encdec_init(seed: int, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Fresh params from a seeded ``torch.Generator`` (``device=None``: the
    card; ``"meta"`` allocates nothing).  Not the reference's threefry
    bits: ``convert.params_from_jax`` carries the reference's across.
    ``dec_pos`` has ``max(max_pos, 4096)`` rows, as in the reference."""
    device = resolve_device(device)
    gen = generator(seed, device)
    dtype, d = cfg.torch_dtype, cfg.d_model
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    embed = embed_init(gen, cfg.vocab, d, dtype, device)
    dec_pos = embed_init(gen, max(cfg.max_pos, 4096), d, dtype, device)
    enc_pos = embed_init(gen, cfg.enc_seq, d, dtype, device)
    enc_blocks = {
        "attn": _attn_init(gen, cfg, dtype, device, Le),
        "mlp": mlp_init(gen, d, cfg.d_ff, dtype, device,
                        layers=Le)._asdict(),
        "ln1": layernorm_init(d, dtype, device, Le),
        "ln2": layernorm_init(d, dtype, device, Le),
    }
    dec_blocks = {
        "self_attn": _attn_init(gen, cfg, dtype, device, Ld),
        "cross_attn": _attn_init(gen, cfg, dtype, device, Ld),
        "mlp": mlp_init(gen, d, cfg.d_ff, dtype, device,
                        layers=Ld)._asdict(),
        "ln1": layernorm_init(d, dtype, device, Ld),
        "ln2": layernorm_init(d, dtype, device, Ld),
        "ln3": layernorm_init(d, dtype, device, Ld),
    }
    return {"enc_pos": enc_pos, "enc_blocks": enc_blocks,
            "enc_ln": layernorm_init(d, dtype, device),
            "embed": embed, "dec_pos": dec_pos, "dec_blocks": dec_blocks,
            "dec_ln": layernorm_init(d, dtype, device)}


def _heads(cfg: ModelConfig) -> Dict[str, int]:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim)


def _enc_block(cfg: ModelConfig, blk, h: torch.Tensor) -> torch.Tensor:
    eps = cfg.norm_eps
    h = h + attention(AttnParams(**blk["attn"]),
                      layernorm(blk["ln1"], h, eps), causal=False,
                      use_rope=False, **_heads(cfg))
    return h + mlp(MLPParams(**blk["mlp"]), layernorm(blk["ln2"], h, eps))


def _dec_block(cfg: ModelConfig, blk, h: torch.Tensor,
               enc_out: torch.Tensor) -> torch.Tensor:
    eps = cfg.norm_eps
    h = h + attention(AttnParams(**blk["self_attn"]),
                      layernorm(blk["ln1"], h, eps), causal=True,
                      use_rope=False, **_heads(cfg))
    h = h + attention(AttnParams(**blk["cross_attn"]),
                      layernorm(blk["ln2"], h, eps), causal=False,
                      use_rope=False, xkv=enc_out, **_heads(cfg))
    return h + mlp(MLPParams(**blk["mlp"]), layernorm(blk["ln3"], h, eps))


def _run_blocks(block, cfg: ModelConfig, stack, n: int, h, *extra,
                remat: bool):
    """``block`` over the n layers of the stacked ``stack``."""
    layers = unbind_layers(stack)
    for i in range(n):
        blk = layer_slice(layers, i)
        if remat and torch.is_grad_enabled():
            h = checkpoint(block, cfg, blk, h, *extra, use_reentrant=False)
        else:
            h = block(cfg, blk, h, *extra)
    return h


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """frames: (B, T, d_model), the stub frontend's output (any float
    dtype; cast to the model's) -> the encoder's normed output (B, T, d)."""
    T = frames.shape[1]
    h = frames.to(cfg.torch_dtype) + params["enc_pos"][None, :T]
    h = _run_blocks(_enc_block, cfg, params["enc_blocks"], cfg.n_enc_layers,
                    h, remat=remat)
    return layernorm(params["enc_ln"], h, cfg.norm_eps)


def decode_hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
                  enc_out: torch.Tensor, *,
                  remat: bool = True) -> torch.Tensor:
    """Token ids (B, S) and the encoder's output -> the decoder's final
    normed hidden (B, S, d), teacher-forced."""
    S = tokens.shape[1]
    h = params["embed"][tokens] + params["dec_pos"][None, :S]
    h = _run_blocks(_dec_block, cfg, params["dec_blocks"], cfg.n_layers, h,
                    enc_out, remat=remat)
    return layernorm(params["dec_ln"], h, cfg.norm_eps)


def encdec_loss(params, cfg: ModelConfig, batch, *,
                remat: bool = True) -> torch.Tensor:
    """batch: {"frames": (B, T, d), "tokens": (B, S), "labels": (B, S)}."""
    enc_out = encode(params, cfg, batch["frames"], remat=remat)
    h = decode_hidden(params, cfg, batch["tokens"], enc_out, remat=remat)
    W = params["embed"]
    return cross_entropy_chunked(lambda hc: matmul(hc, W.T), h,
                                 batch["labels"], cfg.vocab,
                                 chunk=cfg.loss_chunk)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=None, device=None) -> Dict[str, torch.Tensor]:
    """Zeros: ``self_k``, ``self_v`` (L, batch, max_len, Hk, D) and
    ``cross_k``, ``cross_v`` (L, batch, enc_seq, Hk, D).  ``dtype=None``:
    the model's; ``device=None``: the card."""
    dtype = dtype or cfg.torch_dtype
    device = resolve_device(device)
    L, Hk, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def zeros(T):
        return torch.zeros((L, batch, T, Hk, D), dtype=dtype, device=device)
    return {"self_k": zeros(max_len), "self_v": zeros(max_len),
            "cross_k": zeros(cfg.enc_seq), "cross_v": zeros(cfg.enc_seq)}


def encdec_prepare_cross(params, cfg: ModelConfig, enc_out: torch.Tensor):
    """Every decoder layer's cross-attention K and V of the encoder's
    output, stacked: two (L, B, T, Hk, D) tensors."""
    B, T, _ = enc_out.shape
    shape = (B, T, cfg.n_kv_heads, cfg.head_dim)
    ca = params["dec_blocks"]["cross_attn"]
    ks = [matmul(enc_out, ca["wk"][l]).reshape(shape)
          for l in range(cfg.n_layers)]
    vs = [matmul(enc_out, ca["wv"][l]).reshape(shape)
          for l in range(cfg.n_layers)]
    return torch.stack(ks), torch.stack(vs)


@torch.inference_mode()
def encdec_decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                       cache, pos):
    """One decoder step.  token: (B, 1); ``pos``: the new token's position
    (an int or a 0-d tensor), which also picks its ``dec_pos`` row.  The
    self-attention caches are written in place at ``pos``; the
    cross-attention attends over every ``enc_seq`` slot of
    ``cross_k`` / ``cross_v`` as the reference's does: q through ``wq``
    in the model dtype, upcast and divided by sqrt(D), scores, softmax
    and ``p·v`` in f32, the result cast to h's dtype before ``wo``.
    Returns ``(logits (B, 1, vocab), cache)``."""
    B = token.shape[0]
    pos = int(pos)
    eps = cfg.norm_eps
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = params["embed"][token] + params["dec_pos"][pos][None, None]
    layers = unbind_layers(params["dec_blocks"])
    for l in range(cfg.n_layers):
        blk = layer_slice(layers, l)
        a, _, _ = attention_decode(
            AttnParams(**blk["self_attn"]), layernorm(blk["ln1"], h, eps),
            cache["self_k"][l], cache["self_v"][l], pos, use_rope=False,
            **_heads(cfg))
        h = h + a
        ap = AttnParams(**blk["cross_attn"])
        q = matmul(layernorm(blk["ln2"], h, eps), ap.wq).reshape(
            B, 1, Hk, Hq // Hk, D)
        s = torch.einsum("bshgd,bchd->bshgc", q.float() / math.sqrt(D),
                         cache["cross_k"][l].float())
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bshgc,bchd->bshgd", p,
                         cache["cross_v"][l].float())
        h = h + matmul(o.reshape(B, 1, Hq * D).to(h.dtype), ap.wo)
        h = h + mlp(MLPParams(**blk["mlp"]), layernorm(blk["ln3"], h, eps))
    h = layernorm(params["dec_ln"], h, eps)
    return matmul(h, params["embed"].T), cache
