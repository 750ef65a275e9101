"""Decoder-only LM of the dense, MoE and VLM families (llama3,
internlm2, h2o-danube3, gemma2, granite-moe, dbrx, internvl2): the
reference's ``models/transformer.py``, training and serving.  A config
with ``n_experts`` takes the MoE feed-forward (``models/ffn.py`` ``moe``)
in every block; its load-balancing loss is summed over the layers and
weighted into the training loss, and serving routes without it.  A
config with a ``frontend`` (the VLM) has a projector: ``lm_hidden``
projects and norms the stub frontend's features (``frontend_feats``, B,
num_frontend_tokens, frontend_dim) and prepends them to the token
embeddings; the loss takes no label there.  Serving (``prefill``,
``decode_step``) covers the text tokens alone, as in the reference.

Per-layer weights stay stacked along a leading L axis, exactly as the
reference's ``lm_init`` stacks them: the gradient exchange folds a leaf to
``(prod(shape[:-1]), shape[-1])``, so per-layer tensors would give other
matrices, other decisions and other Omega keys.  The layer loop indexes
the stacks, and each block runs under ``torch.utils.checkpoint`` when
``remat`` is set (the reference's ``jax.checkpoint``).

Serving (``init_cache``, ``prefill``, ``decode_step``) keeps per-layer
caches: a full layer's is ``max_len`` long (slot == position), a windowed
layer's is a ring of ``min(window, max_len)`` slots (slot == position mod
its length).  ``decode_step`` unrolls the layers in Python, as the
reference does, so ring and full caches coexist; it writes the caches in
place.  Both run under ``torch.inference_mode``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import FULL_WINDOW, ModelConfig
from repro_torch.core.rng import resolve_device
from .attention import (AttnParams, attn_init, attention, attention_decode,
                        nystrom_attention)
from .common import (cross_entropy_chunked, embed_init, generator,
                     layer_slice, layernorm, layernorm_init, matmul, rmsnorm,
                     rmsnorm_init, softcap, unbind_layers)
from .ffn import FFNParams, MoEParams, ffn, ffn_init, moe, moe_init


def _norm_init(cfg: ModelConfig, dtype, device, layers: int = 0):
    init = rmsnorm_init if cfg.norm == "rmsnorm" else layernorm_init
    return init(cfg.d_model, dtype, device, layers)


def _norm_apply(cfg: ModelConfig, p, x):
    return (rmsnorm(p, x, cfg.norm_eps) if cfg.norm == "rmsnorm"
            else layernorm(p, x, cfg.norm_eps))


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"{cfg.name}: this module is the dense, MoE and VLM families' "
            f"LM; the {cfg.family} family is elsewhere (models/api.py "
            f"get_api)")


def lm_init(seed: int, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Fresh params from a seeded ``torch.Generator`` (``device=None``: the
    card; ``"meta"`` allocates nothing).  The draws are not the reference's
    threefry bits; ``convert.params_from_jax`` carries the reference's
    params across instead."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = generator(seed, device)
    dtype, L = cfg.torch_dtype, cfg.n_layers
    blocks = {
        "attn": attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, dtype, device, layers=L)._asdict(),
        "ln_attn": _norm_init(cfg, dtype, device, L),
        "ln_ffn": _norm_init(cfg, dtype, device, L),
    }
    if cfg.n_experts:
        blocks["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                 dtype, device, layers=L)._asdict()
    else:
        blocks["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, dtype, device,
                                 layers=L)._asdict()
    if cfg.use_post_norms:
        blocks["ln_attn_post"] = _norm_init(cfg, dtype, device, L)
        blocks["ln_ffn_post"] = _norm_init(cfg, dtype, device, L)
    params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype, device),
              "blocks": blocks,
              "ln_final": _norm_init(cfg, dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab, cfg.d_model, dtype,
                                       device)
    if cfg.frontend != "none":
        # the modality projector (the frontend itself is a stub)
        params["projector"] = {
            "w": embed_init(gen, cfg.frontend_dim, cfg.d_model, dtype,
                            device),
            "ln": _norm_init(cfg, dtype, device)}
    return params


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor):
    h = params["embed"][tokens]
    if cfg.embed_scale:
        # sqrt(d) rounded to the activation dtype first, as the reference's
        # jnp.asarray(sqrt(d), h.dtype); a Python scalar needs no copy to
        # the card
        h = h * float(torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype))
    return h


def _project_frontend(params, cfg: ModelConfig,
                      feats: torch.Tensor) -> torch.Tensor:
    """The stub frontend's features (B, nf, frontend_dim), cast to the
    model dtype, projected to d_model and normed."""
    p = params["projector"]
    return _norm_apply(cfg, p["ln"], matmul(feats.to(cfg.torch_dtype),
                                            p["w"]))


def _ffn_residual(cfg: ModelConfig, blk, h, with_aux: bool = True):
    """``(h + the block's FFN or MoE of its normed h, the MoE's aux loss)``;
    the aux is None for a dense block or without ``with_aux``."""
    f_in = _norm_apply(cfg, blk["ln_ffn"], h)
    aux = None
    if cfg.n_experts:
        f = moe(MoEParams(**blk["moe"]), f_in, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor, return_aux=with_aux,
                dispatch=cfg.moe_dispatch)
        if with_aux:
            f, aux = f
    else:
        f = ffn(FFNParams(**blk["ffn"]), f_in, activation=cfg.activation)
    if cfg.use_post_norms:
        f = _norm_apply(cfg, blk["ln_ffn_post"], f)
    return h + f, aux


def _block_apply(cfg: ModelConfig, blk, h, window: int,
                 positions: torch.Tensor, kv_chunk: int,
                 return_kv: bool = False, use_nystrom: bool = False):
    """``(h, aux)``; with ``return_kv`` (serving, which needs no aux)
    ``(h, k, v)``, the layer's rotated K and its V.  ``use_nystrom``
    takes Nyström landmark attention (non-causal, no window) instead."""
    a_in = _norm_apply(cfg, blk["ln_attn"], h)
    if use_nystrom:
        a = nystrom_attention(AttnParams(**blk["attn"]), a_in,
                              n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                              head_dim=cfg.head_dim,
                              n_landmarks=cfg.nystrom_landmarks,
                              rope_theta=cfg.rope_theta)
    else:
        a = attention(AttnParams(**blk["attn"]), a_in, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                      positions=positions, causal=True, window=window,
                      attn_softcap=cfg.attn_softcap,
                      rope_theta=cfg.rope_theta, kv_chunk=kv_chunk,
                      return_kv=return_kv)
    if return_kv:
        a, k, v = a
    if cfg.use_post_norms:
        a = _norm_apply(cfg, blk["ln_attn_post"], a)
    h, aux = _ffn_residual(cfg, blk, h + a, with_aux=not return_kv)
    return (h, k, v) if return_kv else (h, aux)


def lm_hidden(params, cfg: ModelConfig, tokens: torch.Tensor, *,
              frontend_feats: Optional[torch.Tensor] = None,
              remat: bool = True, kv_chunk: int = 1024):
    """Token ids (B, S_tok), with the frontend's features prepended when
    ``frontend_feats`` is given -> (final hidden (B, S, d), aux loss): S
    counts the prepended tokens, and so do the positions and the layers'
    windows.  The aux loss is the MoE layers' load-balancing losses summed
    in layer order (0 without MoE).  From ``cfg.nystrom_attn_above``
    tokens on (when set) every block attends through
    ``nystrom_attention``, as the reference's."""
    _check_family(cfg)
    h = _embed_tokens(params, cfg, tokens)
    if frontend_feats is not None:
        h = torch.cat([_project_frontend(params, cfg, frontend_feats), h],
                      dim=1)
    S = h.shape[1]
    use_nystrom = bool(cfg.nystrom_attn_above) and \
        S >= cfg.nystrom_attn_above
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    positions = torch.arange(S, dtype=torch.int64, device=h.device)
    layers = unbind_layers(params["blocks"])
    for i, window in enumerate(cfg.layer_windows(S)):
        blk = layer_slice(layers, i)
        if remat and torch.is_grad_enabled():
            h, a = checkpoint(_block_apply, cfg, blk, h, window, positions,
                              kv_chunk, False, use_nystrom,
                              use_reentrant=False)
        else:
            h, a = _block_apply(cfg, blk, h, window, positions, kv_chunk,
                                use_nystrom=use_nystrom)
        if a is not None:
            aux = aux + a
    h = _norm_apply(cfg, params["ln_final"], h)
    return h, aux


def lm_loss(params, cfg: ModelConfig, batch, *,
            remat: bool = True) -> torch.Tensor:
    """batch: {"tokens": (B, S), "labels": (B, S)} integer tensors, and
    ``frontend_feats`` (B, nf, frontend_dim) for the VLM, whose nf
    prepended positions get the pad label -100."""
    h, aux = lm_hidden(params, cfg, batch["tokens"],
                       frontend_feats=batch.get("frontend_feats"),
                       remat=remat)
    labels = batch["labels"]
    pad = h.shape[1] - labels.shape[1]
    if pad:
        labels = torch.cat([labels.new_full((labels.shape[0], pad), -100),
                            labels], dim=1)
    W = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    nll = cross_entropy_chunked(lambda hc: matmul(hc, W.T), h, labels,
                                cfg.vocab,
                                chunk=cfg.loss_chunk,
                                final_softcap=cfg.final_softcap)
    return nll + cfg.router_aux_weight * aux


# ---------------------------------------------------------------------------
# serving: prefill + decode with per-layer caches
# ---------------------------------------------------------------------------

def _logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    W = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return softcap(matmul(h, W.T), cfg.final_softcap)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> List[Dict[str, torch.Tensor]]:
    """Per-layer ``{"k", "v"}`` caches of (batch, L, Hk, D), zeros, with
    ``L = min(window, max_len)``: windowed layers get ring buffers.
    ``dtype=None``: the model's; ``device=None``: the card."""
    _check_family(cfg)
    dtype = dtype or cfg.torch_dtype
    device = resolve_device(device)
    caches = []
    for w in cfg.layer_windows(max_len):
        shape = (batch, min(w, max_len), cfg.n_kv_heads, cfg.head_dim)
        caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)})
    return caches


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, dtype=None):
    """``init_cache``'s pytree on the ``meta`` device (shapes and dtypes,
    nothing allocated)."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token: torch.Tensor, caches, pos):
    """One decode step.  token: (B, 1) integer ids; ``pos``: the absolute
    position of the new token (an int or a 0-d tensor).  Returns
    ``(logits (B, 1, vocab), caches)``; the caches are written in place
    and returned.  An MoE block routes the step's B tokens together, at
    the capacity of N = B (the reference's), so at small batches it
    drops assignments (cap 1 for granite at batch 4)."""
    _check_family(cfg)
    h = _embed_tokens(params, cfg, token)
    layers = unbind_layers(params["blocks"])
    for l, w in enumerate(cfg.layer_windows(FULL_WINDOW)):
        blk = layer_slice(layers, l)
        a, ck, cv = attention_decode(
            AttnParams(**blk["attn"]), _norm_apply(cfg, blk["ln_attn"], h),
            caches[l]["k"], caches[l]["v"], pos, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            window=(w if w < FULL_WINDOW else None),
            attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta)
        caches[l] = {"k": ck, "v": cv}
        if cfg.use_post_norms:
            a = _norm_apply(cfg, blk["ln_attn_post"], a)
        h, _ = _ffn_residual(cfg, blk, h + a, with_aux=False)
    h = _norm_apply(cfg, params["ln_final"], h)
    return _logits(params, cfg, h), caches


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            remat: bool = True, kv_chunk: int = 1024,
            max_len: Optional[int] = None):
    """Process a whole prompt (B, S); returns ``(last-position logits
    (B, 1, vocab), caches)``.

    The caches hold each layer's rotated K and its V, as the block's own
    attention computed them (the reference projects them a second time:
    the same ops on the same inputs, so the same bits).  A full layer's
    cache is padded to ``max_len`` (slot == position); a windowed layer
    whose ring of ``L = min(window, max_len)`` slots is shorter than S
    keeps the last L positions rolled by S (slot == position mod L).
    ``remat`` changes nothing without autograd; it is kept for the
    reference's signature.  An MoE block routes all B·S prompt tokens
    together, at their capacity."""
    _check_family(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    h = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, dtype=torch.int64, device=h.device)
    layers = unbind_layers(params["blocks"])
    caches = []
    for l, w in enumerate(cfg.layer_windows(S)):
        h, k, v = _block_apply(cfg, layer_slice(layers, l), h, w, positions,
                               kv_chunk, return_kv=True)
        L = min(w, max_len)
        if L >= S:
            pad = (0, 0, 0, 0, 0, L - S)
            caches.append({"k": torch.nn.functional.pad(k, pad),
                           "v": torch.nn.functional.pad(v, pad)})
        else:
            caches.append({"k": torch.roll(k[:, -L:], S, dims=1),
                           "v": torch.roll(v[:, -L:], S, dims=1)})
    h = _norm_apply(cfg, params["ln_final"], h[:, -1:])
    return _logits(params, cfg, h), caches

