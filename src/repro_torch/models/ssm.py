"""State-space sequence layers (the reference's ``models/ssm.py``):
Mamba-1, the diagonal selective scan, and Mamba-2 (SSD) in its chunked
scalar-decay form.

Both run the sequence in chunks with an O(1)-size carried state, so the
(B, S, d_inner, N) tensor of a whole-sequence scan never exists.  Inside a
Mamba-1 chunk the recurrence ``h_t = a_t·h_{t-1} + bx_t`` runs as the
odd/even recursion of ``jax.lax.associative_scan`` (:func:`associative_scan`),
about 2·log2(c) levels of elementwise launches, never a loop over the c
positions.  Decode is ``chunk=1`` through the same code, with the
convolution and SSM states carried in and returned.

Every cast of the reference is kept where it stands: ``matmul`` rounds its
f32 sum to the activation dtype, so in bf16 the projections (``dbc``, the
dt projection, Mamba-2's ``zxbcdt``) are bf16-rounded before their f32
upcast; the convolution multiplies and sums in the input dtype; the gate
``y · silu(z)`` is in the activation dtype.

One departure, in Mamba-2's intra-chunk decay: the reference computes
``where(mask, exp(cum_t - cum_s), 0)``, whose masked exponents (t < s) are
positive and past 88.7 overflow f32; its forward is still right, but its
backward gives 0 · inf = NaN there.  The port takes
``exp(where(mask, cum_t - cum_s, -inf))`` (:func:`masked_decay`): the same
forward values, entry for entry, and a finite gradient.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import matmul, normal_stack, rmsnorm


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's ``softplus``
    returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# causal depthwise conv1d
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state=None):
    """x: (B, S, C); w: (K, C) depthwise; left-causal.  ``state`` (B, K-1,
    C), when given, is prepended (the decode and chunk carry).  Products
    and sums are in x's dtype, in the order i = 0..K-1.  Returns
    ``(y, new_state)``."""
    K = w.shape[0]
    S = x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return out + b, new_state


# ---------------------------------------------------------------------------
# the scan inside a chunk
# ---------------------------------------------------------------------------

def _combine(a1, b1, a2, b2):
    """(a1, b1) then (a2, b2): the affine maps h -> a·h + b composed."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even[0], odd[0], even[1], ...`` along dim 1; ``even`` may hold one
    more."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    if even.shape[1] > n:
        out = torch.cat([out, even[:, n:]], dim=1)
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """The inclusive scan of the pairs (a_t, b_t) along dim 1 under
    :func:`_combine`: ``jax.lax.associative_scan``'s recursion (combine
    neighbours, scan the half, fill in the evens), so the products are
    taken in its order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    del ra, rb
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _scan_chunk_diag(h0: torch.Tensor, a: torch.Tensor, bx: torch.Tensor):
    """h_t = a_t · h_{t-1} + bx_t within one chunk.  a, bx: (B, c, C, N)
    f32; h0: (B, C, N).  Returns (h_all, h_last)."""
    A_, Bv = associative_scan(a, bx)
    h = Bv + A_ * h0[:, None]
    return h, h[:, -1]


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------

class Mamba1Params(NamedTuple):
    in_proj: torch.Tensor    # (d, 2*dI)
    conv_w: torch.Tensor     # (K, dI)
    conv_b: torch.Tensor     # (dI,)
    x_proj: torch.Tensor     # (dI, dt_rank + 2N)
    dt_proj: torch.Tensor    # (dt_rank, dI)
    dt_bias: torch.Tensor    # (dI,) f32
    A_log: torch.Tensor      # (dI, N) f32
    D: torch.Tensor          # (dI,) f32
    out_proj: torch.Tensor   # (dI, d)


def mamba1_init(gen, d: int, d_inner: int, d_state: int, dt_rank: int,
                d_conv: int, dtype, device, layers: int = 0) -> Mamba1Params:
    """The reference's scales and constants; with ``layers`` every leaf
    gets a leading stack axis of that many, each matrix drawn alone into
    the stack (``normal_stack``)."""
    lead = (layers,) if layers else ()
    f32 = torch.float32
    A = torch.arange(1, d_state + 1, dtype=f32, device=device)
    return Mamba1Params(
        in_proj=normal_stack(gen, lead + (d, 2 * d_inner),
                             1.0 / math.sqrt(d), dtype, device),
        conv_w=normal_stack(gen, lead + (d_conv, d_inner),
                            1.0 / math.sqrt(d_conv), dtype, device),
        conv_b=torch.zeros(lead + (d_inner,), dtype=dtype, device=device),
        x_proj=normal_stack(gen, lead + (d_inner, dt_rank + 2 * d_state),
                            1.0 / math.sqrt(d_inner), dtype, device),
        dt_proj=normal_stack(gen, lead + (dt_rank, d_inner),
                             1.0 / math.sqrt(dt_rank), dtype, device),
        dt_bias=torch.full(lead + (d_inner,), -4.6, dtype=f32,
                           device=device),          # softplus^-1(0.01)
        A_log=torch.log(A).expand(lead + (d_inner, d_state)).contiguous(),
        D=torch.ones(lead + (d_inner,), dtype=f32, device=device),
        out_proj=normal_stack(gen, lead + (d_inner, d),
                              1.0 / math.sqrt(d_inner), dtype, device),
    )


def mamba1(params: Mamba1Params, x: torch.Tensor, *, d_state: int,
           dt_rank: int, chunk: int = 256, conv_state=None, ssm_state=None,
           return_state: bool = False):
    """Mamba-1 block.  x: (B, S, d) -> (B, S, d).  For decode, pass S = 1
    with ``conv_state`` (B, K-1, dI) and ``ssm_state`` (B, dI, N) f32 and
    ``return_state=True``: returns ``(y, conv_state, ssm_state)``."""
    B, S, d = x.shape
    dI = params.conv_w.shape[1]
    N = d_state

    xs, z = matmul(x, params.in_proj).chunk(2, dim=-1)
    xs, new_conv_state = causal_conv1d(xs, params.conv_w, params.conv_b,
                                       conv_state)
    xs = F.silu(xs)

    dbc = matmul(xs, params.x_proj)
    dt_r = dbc[..., :dt_rank]
    Bm = dbc[..., dt_rank:dt_rank + N].float()                     # (B,S,N)
    Cm = dbc[..., dt_rank + N:].float()                            # (B,S,N)
    dt = softplus(matmul(dt_r, params.dt_proj).float()
                  + params.dt_bias)                                # (B,S,dI)
    A = -torch.exp(params.A_log)                                   # (dI,N)
    xf = xs.float()

    nc = max(1, S // chunk)
    c = S // nc
    assert nc * c == S, (S, chunk)

    h = (ssm_state if ssm_state is not None
         else torch.zeros((B, dI, N), dtype=torch.float32, device=x.device))
    ys = []
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        dt_c, B_c, C_c, x_c = dt[:, sl], Bm[:, sl], Cm[:, sl], xf[:, sl]
        a = torch.exp(dt_c[..., None] * A)                         # (B,c,dI,N)
        bx = (dt_c * x_c)[..., None] * B_c[:, :, None, :]          # (B,c,dI,N)
        h_all, h = _scan_chunk_diag(h, a, bx)
        del a, bx
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, C_c))
        del h_all
    y = torch.cat(ys, dim=1) if nc > 1 else ys[0]
    y = y + params.D * xf
    y = y.to(x.dtype) * F.silu(z)
    out = matmul(y, params.out_proj)
    if return_state:
        return out, new_conv_state, h
    return out


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

class Mamba2Params(NamedTuple):
    in_proj: torch.Tensor    # (d, 2*dI + 2N + H)
    conv_w: torch.Tensor     # (K, dI + 2N)
    conv_b: torch.Tensor     # (dI + 2N,)
    A_log: torch.Tensor      # (H,) f32
    D: torch.Tensor          # (H,) f32
    dt_bias: torch.Tensor    # (H,) f32
    norm_scale: torch.Tensor # (dI,)
    out_proj: torch.Tensor   # (dI, d)


def mamba2_init(gen, d: int, d_inner: int, d_state: int, n_heads: int,
                d_conv: int, dtype, device, layers: int = 0) -> Mamba2Params:
    lead = (layers,) if layers else ()
    f32 = torch.float32
    conv_dim = d_inner + 2 * d_state
    A = torch.linspace(1.0, 16.0, n_heads, dtype=f32, device=device)
    return Mamba2Params(
        in_proj=normal_stack(gen, lead + (d, 2 * d_inner + 2 * d_state
                                          + n_heads),
                             1.0 / math.sqrt(d), dtype, device),
        conv_w=normal_stack(gen, lead + (d_conv, conv_dim),
                            1.0 / math.sqrt(d_conv), dtype, device),
        conv_b=torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        A_log=torch.log(A).expand(lead + (n_heads,)).contiguous(),
        D=torch.ones(lead + (n_heads,), dtype=f32, device=device),
        dt_bias=torch.full(lead + (n_heads,), -4.6, dtype=f32,
                           device=device),
        norm_scale=torch.zeros(lead + (d_inner,), dtype=dtype, device=device),
        out_proj=normal_stack(gen, lead + (d_inner, d),
                              1.0 / math.sqrt(d_inner), dtype, device),
    )


def masked_decay(cum: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``exp(cum_t - cum_s)`` where ``mask[t, s]`` (s <= t), else 0:
    (B, t, s, H) from cum (B, c, H).  The exponent is masked to -inf
    before the exp, so no entry overflows and the gradient stays finite
    (the reference masks after the exp)."""
    diff = cum[:, :, None, :] - cum[:, None, :, :]
    return torch.exp(diff.masked_fill(~mask[None, :, :, None], -math.inf))


def mamba2(params: Mamba2Params, x: torch.Tensor, *, d_state: int,
           n_heads: int, chunk: int = 256, conv_state=None, ssm_state=None,
           return_state: bool = False):
    """Mamba-2 / SSD block (scalar per-head decay, n_groups = 1).
    x: (B, S, d) -> (B, S, d).  Intra-chunk: an attention-like (c × c)
    masked product per head; inter-chunk: the carried (Pd × N) state,
    (B, H, Pd, N) f32 for decode."""
    B, S, d = x.shape
    H, N = n_heads, d_state
    dI = params.out_proj.shape[0]
    Pd = dI // H                                        # head dim

    zxbcdt = matmul(x, params.in_proj)
    z = zxbcdt[..., :dI]
    xbc = zxbcdt[..., dI:dI + dI + 2 * N]
    dt_in = zxbcdt[..., -H:].float()
    xbc, new_conv_state = causal_conv1d(xbc, params.conv_w, params.conv_b,
                                        conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :dI]
    Bm = xbc[..., dI:dI + N].float()                    # (B,S,N)
    Cm = xbc[..., dI + N:].float()                      # (B,S,N)

    dt = softplus(dt_in + params.dt_bias)               # (B,S,H)
    A = -torch.exp(params.A_log)                        # (H,)
    xh = xs.float().reshape(B, S, H, Pd)

    nc = max(1, S // chunk)
    c = S // nc
    assert nc * c == S, (S, chunk)
    mask = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()

    h = (ssm_state if ssm_state is not None
         else torch.zeros((B, H, Pd, N), dtype=torch.float32,
                          device=x.device))
    ys = []
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        dt_c, B_c, C_c, x_c = dt[:, sl], Bm[:, sl], Cm[:, sl], xh[:, sl]
        cum = torch.cumsum(dt_c * A, dim=1)             # (B,c,H) log-decay
        # intra-chunk: y_t += sum_{s<=t} exp(cum_t - cum_s) dt_s
        #              (C_t . B_s) x_s
        cb = torch.einsum("btn,bsn->bts", C_c, B_c)
        w = cb[..., None] * masked_decay(cum, mask) * dt_c[:, None]
        y_c = torch.einsum("btsh,bshp->bthp", w, x_c)
        del w
        # inter-chunk: the carried state's contribution, contracted over N
        # first, so no (B, c, H, Pd, N) tensor exists
        y_c = y_c + (torch.einsum("btn,bhpn->bthp", C_c, h)
                     * torch.exp(cum)[..., None])
        ys.append(y_c)
        # state: h' = exp(cum_c) h + sum_s exp(cum_c - cum_s) dt_s B_s x_s
        tail = torch.exp(cum[:, -1:] - cum) * dt_c      # (B,c,H)
        dh = torch.einsum("bshp,bsn->bhpn", x_c * tail[..., None], B_c)
        h = torch.exp(cum[:, -1])[:, :, None, None] * h + dh
    y = torch.cat(ys, dim=1) if nc > 1 else ys[0]
    y = y + params.D[:, None] * xh
    y = y.reshape(B, S, dI).to(x.dtype)
    # gated RMSNorm, then the out-projection
    y = rmsnorm({"scale": params.norm_scale}, y * F.silu(z))
    out = matmul(y, params.out_proj)
    if return_state:
        return out, new_conv_state, h
    return out
