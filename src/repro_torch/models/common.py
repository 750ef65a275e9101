"""Shared model building blocks (the reference's ``models/common.py``).

Conventions, as in the reference:
  * params are nested dicts of tensors; per-layer params are stacked along
    a leading L axis (``blocks.attn.wq`` is (L, d, Hq·D)), and the layer
    loop indexes them;
  * compute dtype is the param dtype (bf16 at the published sizes); every
    matmul accumulates in f32 and casts back to the activation's dtype.

Sharding constraints (the reference's ``ShardCtx``) have no counterpart:
the port trains on one card per process.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint


# ---------------------------------------------------------------------------
# Initializers (seeded torch draws: not the reference's threefry bits)
# ---------------------------------------------------------------------------

def _normal(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def generator(seed: int, device: torch.device):
    """A seeded ``torch.Generator`` on ``device`` (None on ``meta``, which
    draws nothing)."""
    return (None if device.type == "meta"
            else torch.Generator(device=device).manual_seed(int(seed)))


def dense_init(gen, d_in: int, d_out: int, dtype, device,
               scale: Optional[float] = None, layers: int = 0):
    """(d_in, d_out) normal · scale (default 1/sqrt(d_in)); with
    ``layers`` a stack of that many, (layers, d_in, d_out)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    shape = (layers, d_in, d_out) if layers else (d_in, d_out)
    return _normal(gen, shape, device).mul_(scale).to(dtype)


def normal_stack(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    """normal · scale of ``shape`` in ``dtype``, drawn one matrix (the last
    two axes) at a time into a preallocated tensor: the f32 temporary is
    one matrix's, never the stack's (dbrx's 8-layer expert leaf alone
    would be 33.8 GB in f32, falcon-mamba-7b's ``in_proj`` 17.2 GB)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type != "meta":
        for m in out.view(-1, *shape[-2:]):
            m.copy_(_normal(gen, shape[-2:], device).mul_(scale))
    return out


def embed_init(gen, vocab: int, d: int, dtype, device):
    return _normal(gen, (vocab, d), device).mul_(0.02).to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` summed in f32, in x's dtype (the reference's
    ``preferred_element_type=f32`` then ``astype``).  The model's operands
    share one dtype; for bf16 the card's GEMM accumulates in f32 and
    rounds its output once, the same function without an f32 copy of
    either operand."""
    return torch.matmul(x, w.to(x.dtype))


def layer_slice(tree, i: int):
    """Layer i's params: the i-th slice of every stacked leaf."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def unbind_layers(tree):
    """Every stacked leaf split into per-layer views (one autograd node per
    leaf, so its gradient is stacked once, not summed from L full-size
    zero-padded slices)."""
    if isinstance(tree, dict):
        return {k: unbind_layers(v) for k, v in tree.items()}
    return tree.unbind(0)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device, layers: int = 0):
    shape = (layers, d) if layers else (d,)
    return {"scale": torch.zeros(shape, dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm with the ``(1 + scale)`` convention."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def layernorm_init(d: int, dtype, device, layers: int = 0):
    shape = (layers, d) if layers else (d,)
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  The
    split-halves form (first half with the second), not interleaved."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    ang = positions[..., :, None].float() * freqs        # (..., s, hd/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., s, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Softcap (gemma-2)
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return (torch.tanh(x.float() / cap) * cap).to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _chunk_nll(logits_fn: Callable, final_softcap: float, h_c, y_c):
    logits = softcap(logits_fn(h_c), final_softcap)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    valid = y_c >= 0
    y_safe = torch.where(valid, y_c, torch.zeros_like(y_c))
    picked = torch.gather(lf, -1, y_safe[..., None])[..., 0]
    nll = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return nll.sum()


def cross_entropy_chunked(logits_fn: Callable, h: torch.Tensor,
                          labels: torch.Tensor, vocab: int,
                          chunk: int = 1024,
                          final_softcap: float = 0.0) -> torch.Tensor:
    """Memory-bounded LM loss: logits per sequence chunk, so the
    (B, S, vocab) tensor never exists.  Each chunk runs under
    ``torch.utils.checkpoint`` when autograd records: otherwise it would
    keep every chunk's (B, chunk, vocab) f32 logits for the backward pass.

    ``logits_fn(h_chunk) -> (B, c, vocab)``; labels: (B, S) integers, -100
    pads.  Returns the mean NLL over non-pad tokens.
    """
    S = h.shape[1]
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, chunk):
        h_c, y_c = h[:, s0:s0 + chunk], labels[:, s0:s0 + chunk]
        if torch.is_grad_enabled() and h.requires_grad:
            tot = tot + checkpoint(_chunk_nll, logits_fn, final_softcap, h_c,
                                   y_c, use_reentrant=False)
        else:
            tot = tot + _chunk_nll(logits_fn, final_softcap, h_c, y_c)
    cnt = (labels >= 0).sum()
    return tot / torch.clamp(cnt, min=1)


# ---------------------------------------------------------------------------
# Param counting
# ---------------------------------------------------------------------------

def count_params(tree) -> int:
    """Elements over every leaf of a nested dict (or list) of tensors;
    shapes alone, so a tree on ``meta`` counts too."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return math.prod(int(s) for s in tree.shape)
