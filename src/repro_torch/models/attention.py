"""Attention (the reference's ``models/attention.py``): GQA with a
chunked online softmax over KV chunks, sliding windows and the gemma-2
score softcap for training and prefill, one-token decode against a KV
cache (``attention_decode``), and Nyström landmark attention for long
sequences (``nystrom_attention``).  No kernel here: the reference computes
attention outside any Pallas kernel, and so does the port, with plain
torch ops that compute the same function (masks and softcap included).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .common import apply_rope, dense_init, matmul

NEG = -3e9          # additive mask bias
M_FLOOR = -1e9      # clamp of the running max


class AttnParams(NamedTuple):
    wq: torch.Tensor   # (d, Hq*D)
    wk: torch.Tensor   # (d, Hk*D)
    wv: torch.Tensor   # (d, Hk*D)
    wo: torch.Tensor   # (Hq*D, d)


def attn_init(gen, d_model: int, n_heads: int, n_kv_heads: int,
              head_dim: int, dtype, device, layers: int = 0) -> AttnParams:
    kw = dict(dtype=dtype, device=device, layers=layers)
    return AttnParams(
        wq=dense_init(gen, d_model, n_heads * head_dim, **kw),
        wk=dense_init(gen, d_model, n_kv_heads * head_dim, **kw),
        wv=dense_init(gen, d_model, n_kv_heads * head_dim, **kw),
        wo=dense_init(gen, n_heads * head_dim, d_model,
                      scale=1.0 / math.sqrt(n_heads * head_dim), **kw),
    )


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                      window: Optional[int] = None,
                      attn_softcap: float = 0.0, kv_chunk: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention.

    q: (B, S, Hk, G, D) grouped query heads; k, v: (B, T, Hk, D);
    q_pos (S,), k_pos (T,) absolute positions.  Key j is visible to query
    i iff causal (pos_i >= pos_j) and, with ``window``,
    ``0 <= pos_i - pos_j < window``.  Masking is an additive -3e9 bias
    with the running max clamped at -1e9, so a masked score's exp
    underflows to exactly 0.  For bf16 q the scores and probabilities are
    stored in bf16 (their sums stay f32), as in the reference.  Returns
    (B, S, Hk, G, D).
    """
    B, S, Hk, G, D = q.shape
    T = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kv_chunk = min(kv_chunk, T)
    n_chunks = (T + kv_chunk - 1) // kv_chunk
    Tp = n_chunks * kv_chunk
    if Tp != T:
        pad = (0, 0, 0, 0, 0, Tp - T)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
        k_pos = torch.nn.functional.pad(k_pos, (0, Tp - T),
                                        value=(2 ** 31 - 1) // 2)
    store_dt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    qf = (q.float() * scale).to(store_dt)

    m = torch.full((B, S, Hk, G), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, S, Hk, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, Hk, G, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, Tp, kv_chunk):
        k_c = k[:, c0:c0 + kv_chunk].to(store_dt)
        v_c = v[:, c0:c0 + kv_chunk].to(store_dt)
        p_c = k_pos[c0:c0 + kv_chunk]
        sf = torch.einsum("bshgd,bchd->bshgc", qf, k_c).float()
        if attn_softcap:
            sf = torch.tanh(sf / attn_softcap) * attn_softcap
        mask = torch.ones((S, kv_chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= p_c[None, :]
        if window is not None:
            dist = q_pos[:, None] - p_c[None, :]
            mask &= dist < window
            if not causal:
                mask &= dist >= 0
        bias = torch.where(mask, 0.0, NEG).to(torch.float32)
        sf = sf + bias[None, :, None, None, :]
        m_new = torch.maximum(m, sf.amax(dim=-1))
        m_safe = torch.clamp(m_new, min=M_FLOOR)
        p = torch.exp(sf - m_safe[..., None])
        corr = torch.exp(m - m_safe)               # m0 = -inf -> corr = 0
        l = l * corr + p.sum(dim=-1)
        # bf16 operands summed in f32, as preferred_element_type=f32
        pv = torch.einsum("bshgc,bchd->bshgd", p.to(store_dt).float(),
                          v_c.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.to(q.dtype)


def attention(params: AttnParams, x: torch.Tensor, *, n_heads: int,
              n_kv_heads: int, head_dim: int,
              positions: Optional[torch.Tensor] = None, causal: bool = True,
              window: Optional[int] = None, attn_softcap: float = 0.0,
              rope_theta: float = 1e4, kv_chunk: int = 1024,
              return_kv: bool = False):
    """Self-attention layer over (B, S, d).  With ``return_kv`` it returns
    ``(y, k, v)``: the rotated keys and the values (B, S, Hk, D) it
    attended over, which prefill lays into the decode cache."""
    B, S, _ = x.shape
    Hq, Hk, D = n_heads, n_kv_heads, head_dim
    G = Hq // Hk
    if positions is None:
        positions = torch.arange(S, dtype=torch.int64, device=x.device)
    q = matmul(x, params.wq).reshape(B, S, Hq, D)
    k = matmul(x, params.wk).reshape(B, S, Hk, D)
    v = matmul(x, params.wv).reshape(B, S, Hk, D)
    q = apply_rope(q, positions[None, :], rope_theta).reshape(B, S, Hk, G, D)
    k = apply_rope(k, positions[None, :], rope_theta)
    out = chunked_attention(q, k, v, positions, positions, causal=causal,
                            window=window, attn_softcap=attn_softcap,
                            kv_chunk=kv_chunk)
    y = matmul(out.reshape(B, S, Hq * D), params.wo)
    return (y, k, v) if return_kv else y


def attention_decode(params: AttnParams, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     window: Optional[int] = None, attn_softcap: float = 0.0,
                     rope_theta: float = 1e4):
    """One-token decode.  x: (B, 1, d); cache_k / cache_v: (B, T, Hk, D),
    a ring when ``window`` is set (slot ``pos % T``), else slot ``pos``
    clamped to ``T - 1`` as the reference's ``dynamic_update_slice``
    clamps a start past the end.  ``pos``: the new token's absolute
    position (an int or a 0-d tensor).

    The new K/V are written into the caches in place; returns
    ``(y, cache_k, cache_v)``.  Scores and probabilities are float32 (q
    upcast and divided by sqrt(D), the cache upcast; softcap, then -inf
    where invalid, then softmax), unlike ``chunked_attention``'s bf16
    score storage: the reference's decode does the same.
    """
    B = x.shape[0]
    Hq, Hk, D = n_heads, n_kv_heads, head_dim
    G = Hq // Hk
    T = cache_k.shape[1]
    pos = int(pos)
    posv = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(matmul(x, params.wq).reshape(B, 1, Hq, D), posv,
                   rope_theta).reshape(B, 1, Hk, G, D)
    k = apply_rope(matmul(x, params.wk).reshape(B, 1, Hk, D), posv,
                   rope_theta)
    v = matmul(x, params.wv).reshape(B, 1, Hk, D)

    slot = pos % T if window is not None else min(max(pos, 0), T - 1)
    cache_k[:, slot].copy_(k[:, 0])
    cache_v[:, slot].copy_(v[:, 0])

    # the absolute position each slot holds: for a ring, the largest
    # value <= pos congruent to the slot mod T
    idx = torch.arange(T, dtype=torch.int64, device=x.device)
    k_pos = pos - torch.remainder(pos - idx, T) if window is not None else idx
    valid = (k_pos <= pos) & (k_pos >= 0)
    if window is not None:
        valid &= (pos - k_pos) < window

    qf = q.float() / math.sqrt(D)
    s = torch.einsum("bshgd,bchd->bshgc", qf, cache_k.float())
    if attn_softcap:
        s = torch.tanh(s / attn_softcap) * attn_softcap
    s = s.masked_fill(~valid, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bshgc,bchd->bshgd", p, cache_v.float())
    y = matmul(out.reshape(B, 1, Hq * D).to(x.dtype), params.wo)
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# Nyström landmark attention (the paper's two-product structure)
# ---------------------------------------------------------------------------

def nystrom_attention(params: AttnParams, x: torch.Tensor, *, n_heads: int,
                      n_kv_heads: int, head_dim: int, n_landmarks: int = 64,
                      rope_theta: float = 1e4, use_rope: bool = True,
                      pinv_iters: int = 6) -> torch.Tensor:
    """Nyströmformer-style attention: softmax(QKᵀ) approximated as
    ``F · A⁺ · Bm``, two sketched products and the pseudo-inverse of a
    small core, with segment-mean landmarks as the sketch.  O(S·m) time
    and memory.  Non-causal, as the reference's (the hybrid's shared block
    on long prompts).  A⁺ is ``pinv_iters`` Newton–Schulz steps of the
    m × m core."""
    B, S, _ = x.shape
    Hq, Hk, D = n_heads, n_kv_heads, head_dim
    G = Hq // Hk
    m = min(n_landmarks, S)
    assert S % m == 0, (S, m)

    q = matmul(x, params.wq).reshape(B, S, Hq, D)
    k = matmul(x, params.wk).reshape(B, S, Hk, D)
    v = matmul(x, params.wv).reshape(B, S, Hk, D)
    if use_rope:
        pos = torch.arange(S, dtype=torch.int64, device=x.device)[None, :]
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    # kv heads expanded to the query heads
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)

    qf = q.float() / math.sqrt(D)
    kf = k.float()
    # landmarks: segment means (Q and K sketched by a fixed averaging matrix)
    q_l = qf.reshape(B, m, S // m, Hq, D).mean(dim=2)
    k_l = kf.reshape(B, m, S // m, Hq, D).mean(dim=2)

    Fm = torch.softmax(torch.einsum("bshd,bmhd->bhsm", qf, k_l), dim=-1)
    A = torch.softmax(torch.einsum("bmhd,bnhd->bhmn", q_l, k_l), dim=-1)
    Bm = torch.softmax(torch.einsum("bmhd,bshd->bhms", q_l, kf), dim=-1)

    # iterative Moore-Penrose pseudo-inverse of the (m x m) core
    eye = torch.eye(m, dtype=torch.float32, device=x.device)
    a1 = A.sum(-1).amax(-1)[..., None, None]
    a2 = A.sum(-2).amax(-1)[..., None, None]
    Z = A.transpose(-1, -2) / (a1 * a2)
    for _ in range(pinv_iters):
        AZ = A @ Z
        Z = 0.25 * Z @ (13 * eye - AZ @ (15 * eye - AZ @ (7 * eye - AZ)))

    out = Fm @ Z @ torch.einsum("bhms,bshd->bhmd", Bm, v.float())
    out = out.transpose(1, 2).reshape(B, S, Hq * D).to(x.dtype)
    return matmul(out, params.wo)
